"""The port's box head, box predictor, Fast R-CNN inference, mask head and
StandardROIHeads inference held against the JAX package on the CPU, with
the same weights (carried across with ``variables_to_state_dict``) and the
same numpy inputs.

Tolerances: head outputs agree to 1e-4 of their largest magnitude (float32
matmuls and convs summed in different orders); detections must agree in
validity and class exactly, boxes to 1e-4 of the image size, scores and
mask probabilities to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jtsm_tpu.config import get_cfg as jax_get_cfg
from jtsm_tpu.modeling import build_model as jax_build_model
from jtsm_tpu.modeling.roi_heads.fast_rcnn import fast_rcnn_inference_single
from jtsm_tpu.ops.box_regression import Box2BoxTransform as JaxBox2BoxTransform
from jtsm_tpu_torch.checkpoint import variables_to_state_dict
from jtsm_tpu_torch.config import get_cfg
from jtsm_tpu_torch.modeling import build_model
from jtsm_tpu_torch.modeling.roi_heads.fast_rcnn import fast_rcnn_inference
from jtsm_tpu_torch.modeling.roi_heads.mask_head import mask_rcnn_inference
from jtsm_tpu_torch.ops.box_regression import Box2BoxTransform
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


def _close(a, b, rel=1e-4):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(1.0, float(np.abs(a).max(initial=0.0)))
    np.testing.assert_allclose(b, a, rtol=0, atol=rel * scale)


_CACHE = {}


def _models():
    if not _CACHE:
        cfg = _fpn_tiny(jax_get_cfg())
        cfg.MODEL.MASK_ON = True
        cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0  # keep detections with random weights
        jm = jax_build_model(cfg)
        rng = np.random.RandomState(0)
        batch = {
            "image": jnp.asarray(rng.rand(1, 64, 64, 3).astype(np.float32) * 255),
            "image_sizes": jnp.asarray([[64, 64]], jnp.int32),
        }
        variables = jax.jit(lambda k, b: jm.init({"params": k}, b, train=False))(
            jax.random.key(2), batch
        )
        variables = jax.tree_util.tree_map(np.asarray, variables)
        tcfg = get_cfg()
        tcfg.merge_from_other_cfg(cfg)
        tm = build_model(tcfg, device="cpu")
        tm.load_state_dict(variables_to_state_dict(variables), strict=True)
        _CACHE.update(jm=jm, variables=variables, tm=tm)
    return _CACHE["jm"], _CACHE["variables"], _CACHE["tm"]


def _apply(jm, variables, fn, *args):
    with jax.default_matmul_precision("highest"):
        return jax.jit(lambda v, *a: jm.apply(v, *a, method=fn))(variables, *args)


def test_box_head_and_predictor_match_jax():
    jm, variables, tm = _models()
    x = np.random.RandomState(1).randn(30, 7, 7, 64).astype(np.float32)
    js, jd = _apply(
        jm, variables, lambda m, x: m.roi_heads.box_predictor(m.roi_heads.box_head(x)), x
    )
    with torch.no_grad():
        ts, td = tm.roi_heads.box_predictor(tm.roi_heads.box_head(torch.from_numpy(x)))
    _close(js, ts.numpy())
    _close(jd, td.numpy())


def test_mask_head_matches_jax():
    jm, variables, tm = _models()
    x = np.random.RandomState(2).randn(12, 14, 14, 64).astype(np.float32)
    want = _apply(jm, variables, lambda m, x: m.roi_heads.mask_head(x), x)  # (N, 28, 28, K)
    with torch.no_grad():
        got = tm.roi_heads.mask_head(torch.from_numpy(x))  # (N, K, 28, 28)
    _close(want, got.permute(0, 2, 3, 1).numpy())
    classes = np.arange(12) % 5
    from jtsm_tpu.modeling.roi_heads.mask_head import mask_rcnn_inference as jax_mask_inference

    _close(jax_mask_inference(want, jnp.asarray(classes)),
           mask_rcnn_inference(got, torch.from_numpy(classes)).numpy())


def test_fast_rcnn_inference_matches_jax():
    rng = np.random.RandomState(3)
    b, r, k = 2, 50, 5
    scores = (rng.randn(b, r, k + 1) * 2).astype(np.float32)
    scores[:, 10:14] = scores[:, 9:10]  # tied candidates keep index order
    deltas = (rng.randn(b, r, 4 * k) * 0.5).astype(np.float32)
    xy = rng.rand(b, r, 2) * 50
    props = np.concatenate([xy, xy + rng.rand(b, r, 2) * 30 + 2], -1).astype(np.float32)
    valid = rng.rand(b, r) > 0.2
    sizes = np.array([[60, 70], [64, 64]], np.int32)
    w = (10.0, 10.0, 5.0, 5.0)
    args = dict(num_classes=k, score_thresh=0.05, nms_thresh=0.5, topk_per_image=20)
    want = jax.vmap(
        lambda s, d, p, v, z: fast_rcnn_inference_single(
            s, d, p, v, z, JaxBox2BoxTransform(w), nms_candidates=64, **args
        )
    )(*(jnp.asarray(a) for a in (scores, deltas, props, valid, sizes)))
    got = fast_rcnn_inference(
        *(torch.from_numpy(a) for a in (scores, deltas, props, valid, sizes)),
        Box2BoxTransform(w), nms_candidates=64, **args,
    )
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    assert got["valid"].sum() > 10
    np.testing.assert_array_equal(got["classes"].numpy(), np.asarray(want["classes"]))
    _close(want["boxes"], got["boxes"].numpy())
    _close(want["scores"], got["scores"].numpy())


def test_standard_roi_heads_inference_matches_jax():
    jm, variables, tm = _models()
    rng = np.random.RandomState(4)
    b, k = 2, 32
    feats = {
        f"p{i}": rng.randn(b, 64 // 2**i, 64 // 2**i, 64).astype(np.float32)
        for i in range(2, 7)
    }
    xy = rng.rand(b, k, 2) * 48
    props = np.concatenate([xy, xy + rng.rand(b, k, 2) * 40 + 1], -1).astype(np.float32)
    pscores = rng.randn(b, k).astype(np.float32)
    pscores[:, -3:] = -np.inf
    sizes = np.array([[64, 60], [56, 64]], np.int32)
    want, _ = _apply(
        jm, variables,
        lambda m, f, p, s, z: m.roi_heads(f, p, s, z, None, train=False),
        {n: jnp.asarray(v) for n, v in feats.items()}, props, pscores, sizes,
    )
    with torch.no_grad():
        got = tm.roi_heads(
            {n: torch.from_numpy(v).permute(0, 3, 1, 2) for n, v in feats.items()},
            torch.from_numpy(props), torch.from_numpy(pscores), torch.from_numpy(sizes),
        )
    assert sorted(got) == sorted(want) == ["boxes", "classes", "masks", "scores", "valid"]
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    assert got["valid"].sum() > 0
    np.testing.assert_array_equal(got["classes"].numpy(), np.asarray(want["classes"]))
    _close(want["boxes"], got["boxes"].numpy())
    _close(want["scores"], got["scores"].numpy())
    _close(want["masks"], got["masks"].numpy())
