"""The port's Mask R-CNN R50-FPN inference slice, end to end, held against
the JAX package on the CPU: the tiny FPN config with random weights, and the
narrow R50 of the committed ``mask_rcnn.ckpt.gz`` gate checkpoint on a
synthetic scene. Also the weight carry-over, the Python configs and the
predictor.

Tolerances: validity and classes must be equal; boxes agree to 1e-4 of the
image size, scores and mask probabilities to 1e-4 (float32 on both sides,
JAX matmul precision "highest", different summation orders). With random
weights the features reach ~1e3 and the class logits ~1e2, where the two
frameworks' float32 relative difference of ~2e-6 (measured on the FPN maps)
becomes ~1e-4 in a logit and moves a probability near 1 by up to that
much; there scores are held to 5e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jtsm_tpu.checkpoint.c2_model_loading import convert_d2_state_dict_to_variables
from jtsm_tpu.config import get_cfg as jax_get_cfg
from jtsm_tpu.modeling import build_model as jax_build_model
from jtsm_tpu_torch.checkpoint import load_gate_ckpt, random_state_dict, variables_to_state_dict
from jtsm_tpu_torch.config import get_cfg, mask_rcnn_gate_cfg, mask_rcnn_R_50_FPN_cfg
from jtsm_tpu_torch.engine import Predictor
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE_CKPT = os.path.join(ROOT, "tests", "fixtures", "gate_ckpts", "mask_rcnn.ckpt.gz")


def _close(a, b, rel=1e-4):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(1.0, float(np.abs(a).max(initial=0.0)))
    np.testing.assert_allclose(b, a, rtol=0, atol=rel * scale)


def _scene(h, w, seed):
    """Gray canvas with two stuff bands and a few saturated rectangles, in
    the style of the synthetic COCO scenes the gate checkpoint learned."""
    rng = np.random.RandomState(seed)
    img = np.full((h, w, 3), 128.0, np.float32)
    img[: h // 2] = [205, 115, 95]
    img[h // 2 :] = [95, 175, 95]
    for _ in range(4):
        y0, x0 = rng.randint(0, h - 40), rng.randint(0, w - 40)
        bh, bw = rng.randint(20, 60), rng.randint(20, 60)
        img[y0 : y0 + bh, x0 : x0 + bw] = rng.randint(55, 255, 3)
    return img + rng.randn(h, w, 3).astype(np.float32) * 3


def _compare(want, got, score_tol=1e-4):
    assert sorted(got) == sorted(want) == ["boxes", "classes", "masks", "scores", "valid"]
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["classes"], want["classes"])
    _close(want["boxes"], got["boxes"])
    _close(want["scores"], got["scores"], score_tol)
    _close(want["masks"], got["masks"])
    return got


def _run_both(cfg, variables, batch):
    jm = jax_build_model(cfg)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda v, b: jm.apply(v, b, train=False))(
            variables, {k: jnp.asarray(v) for k, v in batch.items()}
        )
    tcfg = get_cfg()
    tcfg.merge_from_other_cfg(cfg)
    tm = build_model(tcfg, device="cpu")
    tm.load_state_dict(variables_to_state_dict(variables), strict=True)
    return want, tm.inference(batch)


def test_tiny_slice_random_weights_matches_jax():
    cfg = _fpn_tiny(jax_get_cfg())
    cfg.MODEL.MASK_ON = True
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0  # random weights score below 0.05
    rng = np.random.RandomState(0)
    b, h, w = 2, 64, 96
    batch = {
        "image": (rng.rand(b, h, w, 3) * 255).astype(np.float32),
        "image_sizes": np.array([[h - 8, w - 20], [h, w]], np.int32),
        "orig_sizes": np.array([[2 * h, 2 * w], [h, w]], np.int32),
    }
    jm = jax_build_model(cfg)
    variables = jax.jit(lambda k, x: jm.init({"params": k}, x, train=False))(
        jax.random.key(0), {k: jnp.asarray(v) for k, v in batch.items()}
    )
    variables = jax.tree_util.tree_map(np.asarray, variables)
    want, got = _run_both(cfg, variables, batch)
    out = _compare(want, got, score_tol=5e-4)
    assert out["valid"].all()
    assert out["masks"].shape == (b, 100, 28, 28)


def test_gate_checkpoint_slice_matches_jax():
    cfg = jax_get_cfg()
    cfg.merge_from_other_cfg(mask_rcnn_gate_cfg())
    variables = load_gate_ckpt(GATE_CKPT)
    h, w = 128, 176
    batch = {
        "image": np.stack([_scene(h, w, 1), _scene(h, w, 2)]),
        "image_sizes": np.array([[h, w], [h - 16, w - 32]], np.int32),
        "orig_sizes": np.array([[2 * h, 2 * w], [h - 16, w - 32]], np.int32),
    }
    want, got = _run_both(cfg, variables, batch)
    out = _compare(want, got)
    assert out["valid"].sum(axis=1).min() > 0  # trained weights find objects


@pytest.mark.parametrize("source", ["tiny", "gate"])
def test_variables_to_state_dict_round_trips_every_key(source):
    if source == "gate":
        variables = load_gate_ckpt(GATE_CKPT)
        cfg = mask_rcnn_gate_cfg()
    else:
        jcfg = _fpn_tiny(jax_get_cfg())
        jcfg.MODEL.MASK_ON = True
        jm = jax_build_model(jcfg)
        batch = {"image": jnp.zeros((1, 64, 64, 3)), "image_sizes": jnp.asarray([[64, 64]])}
        variables = jax.tree_util.tree_map(
            np.asarray,
            jax.jit(lambda k: jm.init({"params": k}, batch, train=False))(jax.random.key(3)),
        )
        cfg = get_cfg()
        cfg.merge_from_other_cfg(jcfg)
    state = variables_to_state_dict(variables)
    # every key is one the port's modules hold, and every module key is fed
    assert set(state) == set(build_model(cfg, device="cpu").state_dict())
    back, matched, unmatched = convert_d2_state_dict_to_variables(
        {k: v.numpy() for k, v in state.items()}, variables
    )
    assert unmatched == [] and len(matched) == len(state)
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b) == len(state)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf)


def test_python_configs_equal_merged_yamls():
    for fn, path in (
        (mask_rcnn_R_50_FPN_cfg, "configs/COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_1x.yaml"),
        (mask_rcnn_gate_cfg,
         "configs/quick_schedules/mask_rcnn_R_18_FPN_synthetic_inference_acc_test.yaml"),
    ):
        cfg = get_cfg()
        cfg.merge_from_file(os.path.join(ROOT, path))
        assert fn().to_dict() == cfg.to_dict(), path
        # and the port's defaults are the JAX package's, but for the device
        jcfg = jax_get_cfg()
        jcfg.merge_from_file(os.path.join(ROOT, path))
        jcfg.MODEL.DEVICE = "cuda"
        assert jcfg.to_dict() == cfg.to_dict(), path


def test_predictor_serves_requests_at_fixed_capacity():
    cfg = mask_rcnn_gate_cfg()
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0
    model = build_model(cfg, device="cpu")
    predictor = Predictor(cfg, random_state_dict(model, seed=0), device="cpu")
    for h, w in ((128, 176), (96, 128)):
        req = {
            "image": _scene(128, 176, h)[None],
            "image_sizes": np.array([[h, w]], np.int32),
            "orig_sizes": np.array([[h, w]], np.int32),
        }
        out = predictor(req)
        assert out["boxes"].shape == (1, 100, 4)
        assert out["masks"].shape == (1, 100, 28, 28)
        assert out["valid"].dtype == torch.bool and out["valid"].any()
        for v in out.values():
            assert torch.isfinite(v.float()).all()
        assert (out["boxes"][..., 2] <= w).all() and (out["boxes"][..., 3] <= h).all()


def test_build_model_on_missing_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(mask_rcnn_gate_cfg())
