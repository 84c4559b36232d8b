"""The port's ResNet + FPN and RPN inference held against the JAX package on
the CPU: same numpy image, same weights carried across with
``variables_to_state_dict``.

Tolerances: feature maps agree to 1e-4 of their largest magnitude (a deep
float32 conv stack, summed in other orders by XLA and by PyTorch's CPU
convolutions); proposals must come out in the same rank order, with boxes
within 1e-4 of the image size and logits within 1e-4 of their scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jtsm_tpu.config import get_cfg as jax_get_cfg
from jtsm_tpu.modeling import build_model as jax_build_model
from jtsm_tpu_torch.checkpoint import variables_to_state_dict
from jtsm_tpu_torch.config import get_cfg, mask_rcnn_gate_cfg
from jtsm_tpu_torch.modeling import build_model
from tests.modeling.test_meta_archs import _fpn_tiny


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this file runs, as the other port test
    files have: at one a core, PyTorch's pools spin under the parallel
    tier-1 run and slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(a, b, rel):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(1.0, float(np.abs(a[np.isfinite(a)]).max(initial=0.0)))
    np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
    fin = np.isfinite(a)
    np.testing.assert_allclose(b[fin], a[fin], rtol=0, atol=rel * scale)


def _tiny_cfg():
    cfg = _fpn_tiny(jax_get_cfg())
    cfg.MODEL.MASK_ON = True
    return cfg


def _gate_cfg():
    cfg = jax_get_cfg()
    cfg.merge_from_other_cfg(mask_rcnn_gate_cfg())
    return cfg


def _image(b=2, h=64, w=96, seed=0):
    rng = np.random.RandomState(seed)
    return {
        "image": (rng.rand(b, h, w, 3) * 255).astype(np.float32),
        "image_sizes": np.array([[h - 8, w - 20]] + [[h, w]] * (b - 1), np.int32),
        "orig_sizes": np.array([[2 * h, 2 * w]] * b, np.int32),
    }


_CACHE = {}


def _pair(name):
    """(JAX model, its variables as numpy, the port's model with them)."""
    if name not in _CACHE:
        cfg = {"tiny": _tiny_cfg, "gate": _gate_cfg}[name]()
        jm = jax_build_model(cfg)
        batch = {k: jnp.asarray(v) for k, v in _image().items()}
        variables = jax.jit(lambda k, b: jm.init({"params": k}, b, train=False))(
            jax.random.key(1), batch
        )
        variables = jax.tree_util.tree_map(np.asarray, variables)
        tcfg = get_cfg()
        tcfg.merge_from_other_cfg(cfg)
        tm = build_model(tcfg, device="cpu")
        tm.load_state_dict(variables_to_state_dict(variables), strict=True)
        _CACHE[name] = (jm, variables, tm)
    return _CACHE[name]


def _jax_backbone(jm, variables, images):
    mean = jnp.asarray(jm.pixel_mean, jnp.float32)
    std = jnp.asarray(jm.pixel_std, jnp.float32)
    x = (jnp.asarray(images) - mean) / std
    with jax.default_matmul_precision("highest"):
        return jax.jit(lambda v, x: jm.apply(v, x, method=lambda m, x: m.backbone(x)))(variables, x)


def _torch_backbone(tm, images):
    x = (torch.from_numpy(images) - tm.pixel_mean) / tm.pixel_std
    with torch.no_grad():
        return tm.backbone(x.permute(0, 3, 1, 2))


@pytest.mark.parametrize("name", ["tiny", "gate"])
def test_backbone_fpn_features_match_jax(name):
    jm, variables, tm = _pair(name)
    images = _image()["image"]
    want = _jax_backbone(jm, variables, images)
    got = _torch_backbone(tm, images)
    assert sorted(got) == ["p2", "p3", "p4", "p5", "p6"]
    assert sorted(want) == sorted(got)
    for k in want:
        _close(want[k], got[k].permute(0, 2, 3, 1).numpy(), 1e-4)


@pytest.mark.parametrize("name", ["tiny", "gate"])
def test_rpn_proposals_match_jax_rank_for_rank(name):
    jm, variables, tm = _pair(name)
    batch = _image()
    sizes = batch["image_sizes"]
    feats = _jax_backbone(jm, variables, batch["image"])
    with jax.default_matmul_precision("highest"):
        jp, js, _ = jax.jit(
            lambda v, s, f: jm.apply(
                v, s, f, method=lambda m, s, f: m.proposal_generator(s, f, train=False)
            )
        )(variables, jnp.asarray(sizes), feats)
    tfeats = {k: torch.from_numpy(np.array(v)).permute(0, 3, 1, 2) for k, v in feats.items()}
    with torch.no_grad():
        tp, ts, losses = tm.proposal_generator(torch.from_numpy(sizes), tfeats)
    jp, js = np.asarray(jp), np.asarray(js)
    assert losses == {}  # eval mode
    post_k = tm.proposal_generator.post_nms_topk
    assert tp.shape == (2, post_k, 4) and ts.shape == (2, post_k)
    assert np.isfinite(js).sum() > post_k // 2
    _close(js, ts.numpy(), 1e-4)
    valid = np.isfinite(js)
    np.testing.assert_allclose(tp.numpy()[valid], jp[valid], rtol=0, atol=1e-4 * 96)


def test_anchors_match_jax():
    from jtsm_tpu.modeling.anchor_generator import DefaultAnchorGenerator as JaxAnchors
    from jtsm_tpu_torch.modeling.anchor_generator import DefaultAnchorGenerator

    args = dict(sizes=[[32], [64]], aspect_ratios=[[0.5, 1.0, 2.0]], strides=[4, 8], offset=0.5)
    want = JaxAnchors(**args)([(5, 7), (3, 4)])
    got = DefaultAnchorGenerator(**args)([(5, 7), (3, 4)], "cpu")
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
