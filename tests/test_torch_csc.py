"""CSC, CSC-OICR and WSJDS held against the JAX package on the CPU, as
``tests/test_torch_wsod.py`` holds the baselines (its tolerances, its
``_request``, the DAN's dropout off on both sides): CSC on the narrow
WSR-18 DC5 (``csc_WSR_18_DC5_1x.yaml``, every stage training), CSC-OICR on
the narrow VGG16 DC5 (``csc_oicr_V_16_DC5_1x.yaml``) and WSJDS with its ASPP
head and the CRF constraint (``wsjds_V_16_DC5_cfg(crf=True)``); then the
class-peak-gradient pass against the JAX package's
``make_cpg_batch_transform``.

The heads' cases: the detections of both packages' inference, then one
train step's losses and the parameters' gradients, given CPG maps (a few seeded
Gaussian peaks each) under which some CSC weights are
negative. A weight can be negative only where its class's image score
passes 0.5 (W = p * n + 1 - p, n >= -1), and a map survives the CPG gate
only where it passes CPG_TAU 0.7. At the seed's weights the class logits
saturate, so that which class takes an image's mass is the draw's
(WSR-18's image 0 gives its class 3 0.012). So the seeded MIL and
refinement layers' kernels are scaled by 0.1 (as
``tests/test_torch_wsod_zoo.py`` scales them) and the MIL layer's class
bias is raised by 6 at class 3 and by 4 at class 12: class 3 then takes
about 0.98 of each image's mass (image 0's class, past the gate) and class
12 about 0.02 (image 1's, shut out). ``loss_cls_neg`` is then above its 1e-20 clip, which it never leaves
at random weights (ROADMAP §3).

Tolerances (PR 15's; measured on the CPU in brackets): detections equal
in class, validity and source proposal, boxes within 1e-3 px, scores
within 1e-4 of the largest; losses within 1e-4 relative; the gradients
within 1e-4 of each parameter's norm on WSR-18 and 3e-3 through VGG16
(measured at most 4.2e-5 and 2.3e-3). The CPG maps through VGG16: within
2e-2 of their maximum, 1 (measured 6.6e-3; float32 alone moves them by
7.6e-3: the port's float32 maps against its float64 ones on the same
weights, a pixel's gradient summing the thirteen ReLUs' paths at random
weights), exactly zero where the gate shuts or FREEZE_AT 5 detaches the
pooled map.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jtsm_tpu.wsl  # noqa: F401  (registers the WSL modules)
from jtsm_tpu.modeling import build_model as jax_build_model
from jtsm_tpu.wsl.modeling import wsjds as jax_wsjds
from jtsm_tpu_torch.checkpoint import variables_to_state_dict
from jtsm_tpu_torch.config import csc_oicr_V_16_DC5_cfg, csc_V_16_DC5_cfg, csc_WSR_18_DC5_cfg, wsjds_V_16_DC5_cfg
from jtsm_tpu_torch.modeling import build_model
from jtsm_tpu_torch.wsl.modeling.wsjds import class_peak_gradients, make_cpg_batch_transform
from tests.test_torch_jtsm import _jax_cfg
from tests.test_torch_meta_archs import _random_variables
from tests.test_torch_wsod import (  # noqa: F401  (the fixtures)
    TOL_PX,
    TOL_REL,
    _close,
    _jax_dan_without_dropout,
    _np,
    _request,
    _two_torch_threads,
)

# case -> (builder, the gradients' tolerance)
CASES = {
    "csc": (lambda: csc_WSR_18_DC5_cfg(narrow=True), TOL_REL),
    "csc_oicr": (lambda: csc_oicr_V_16_DC5_cfg(narrow=True), 3e-3),
    "wsjds_crf": (lambda: wsjds_V_16_DC5_cfg(narrow=True, crf=True), 3e-3),
}
BIAS = {3: 6.0, 12: 4.0}


@pytest.fixture(scope="module", autouse=True)
def _jax_wsjds_dan_without_dropout(_jax_dan_without_dropout):
    """WSJDS builds its DAN in its own module: at dropout 0 there too."""
    import functools

    from jtsm_tpu.wsl.modeling import roi_heads_wsl as jax_rhw

    dan = jax_wsjds.DiscriminativeAdaptionNeck
    jax_wsjds.DiscriminativeAdaptionNeck = jax_rhw.DiscriminativeAdaptionNeck
    assert isinstance(jax_rhw.DiscriminativeAdaptionNeck, functools.partial)
    yield
    jax_wsjds.DiscriminativeAdaptionNeck = dan


def seeded_variables(jm, jb, seed=0, bias=True):
    """``_random_variables`` of the JAX model, the regression outputs scaled
    by 0.01 (as ``tests/test_torch_wsod_zoo.py`` does) and, with ``bias``,
    the MIL and refinement kernels by 0.1 and the MIL layer's class bias
    raised at BIAS's classes."""
    variables = _random_variables(jm, jb, seed=seed, train=False)

    def adjust(path, a):
        p = str(path)
        if "refine_reg" in p:
            return a * 0.01
        if bias and ("'mil'" in p or "'refine" in p) and "kernel" in p:
            return a * 0.1
        if bias and "'mil'" in p and "'cls'" in p and "bias" in p:
            a = a.copy()
            for c, v in BIAS.items():
                a[c] += v
        return a

    return jax.tree_util.tree_map_with_path(adjust, variables)


def case_models(cfg, bias=True):
    jm = jax_build_model(_jax_cfg(cfg))
    batch = _request()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = seeded_variables(jm, jb, bias=bias)
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(variables_to_state_dict(variables), strict=True)
    return jm, variables, tm, batch, jb


def seeded_cpg(batch, seed=1, blobs=4):
    """Maps of a few seeded Gaussian peaks each (sigma 6 to 20 px),
    normalised to a maximum of 1: ROIs that frame a peak score above their
    context, the rest below (a map without such structure scores every ROI
    below its context, and a column without a positive score is all 1)."""
    rng = np.random.RandomState(seed)
    b, h, w = batch["image"].shape[:3]
    yy, xx = np.mgrid[:h, :w]
    cpg = np.zeros((b, 20, h, w), np.float32)
    for i in range(b):
        for c in range(20):
            for _ in range(blobs):
                cy, cx, sd = rng.rand() * h, rng.rand() * w, 6 + rng.rand() * 14
                cpg[i, c] += rng.rand() * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sd * sd))
    return cpg / cpg.max(axis=(2, 3), keepdims=True)


@pytest.mark.parametrize("case", sorted(CASES))
def test_heads_detections_losses_and_gradients_match_jax(case):
    builder, tol = CASES[case]
    cfg = builder()
    jm, variables, tm, batch, jb = case_models(cfg)
    batch["cpg"] = seeded_cpg(batch)
    jb["cpg"] = jnp.asarray(batch["cpg"])

    def run(params):
        def loss(p):
            out = jm.apply({**variables, "params": p}, jb, train=True,
                           rngs={"dropout": jax.random.key(0), "sampling": jax.random.key(0)})
            return sum(out.values()), out

        (_, losses), grads = jax.value_and_grad(loss, has_aux=True)(params)
        return jm.apply({**variables, "params": params}, jb, train=False), losses, grads

    with jax.default_matmul_precision("highest"):
        want, want_losses, grads = jax.jit(run)(variables["params"])
    got = tm.inference(batch)
    assert sorted(got) == sorted(want)
    for k in ("valid", "classes", "prop_idx"):
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]), err_msg=k)
    assert np.abs(_np(got["boxes"]) - np.asarray(want["boxes"])).max() <= TOL_PX
    for k in ("scores", "proposal_class_scores") + (("masks_full",) if case.startswith("wsjds") else ()):
        print(case, k, _close(np.asarray(want[k]), _np(got[k])))
    if case.startswith("wsjds"):
        np.testing.assert_array_equal(_np(got["no_paste"]), np.asarray(want["no_paste"]))
        assert got["masks_full"].shape[-2:] == batch["image"].shape[1:3]

    tm.train()
    tm.roi_heads.dan.dropout = 0.0
    losses = tm(batch)
    assert sorted(losses) == sorted(want_losses)
    print(case, "losses", {k: float(v) for k, v in want_losses.items()},
          max(_close(float(want_losses[k]), losses[k].item()) for k in want_losses))
    assert float(want_losses["loss_cls_neg"]) > 1e-6  # negative CSC weights
    sum(losses.values()).backward()
    want_grads = variables_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, grads)})
    scale = max(float(np.linalg.norm(g.numpy())) for g in want_grads.values())
    worst = 0.0
    for name, p in tm.named_parameters():
        w = want_grads[name].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        err = np.linalg.norm(w - g) / max(np.linalg.norm(w), 1e-2 * scale)
        worst = max(worst, err)
        assert err <= tol, (name, err)
    print(case, "gradients", worst)
    expected = {"csc": {"loss_cls_pos", "loss_cls_neg"},
                "csc_oicr": {"loss_cls_pos", "loss_cls_neg", "loss_refine_cls0", "loss_refine_cls1"},
                "wsjds_crf": {"loss_cls_pos", "loss_cls_neg", "loss_sem_seg", "loss_mask_cls_pos",
                              "loss_mask_cls_neg"}}[case]
    assert set(want_losses) == expected


def _jax_cpg(jm, variables, jb, csc_max_iter, iteration):
    state = types.SimpleNamespace(params=variables["params"], frozen=variables.get("frozen", {}),
                                  batch_stats=variables.get("batch_stats", {}))
    with jax.default_matmul_precision("highest"):
        out = jax_wsjds.make_cpg_batch_transform(jm, csc_max_iter, 20)(state, jb, iteration)
    return None if "cpg" not in out else np.asarray(out["cpg"])


def test_cpg_maps_match_the_jax_transform_with_the_gate_open_and_shut():
    """CSC on the narrow VGG16 (FREEZE_AT 2: the maps train), the MIL bias
    of BIAS: image 0's class 3 passes the gate (its map peaks at 1),
    image 0's class 7 and image 1's class 12 do not (all zero), every other
    class is absent (zero). Two occupied slots, two backward passes. Past
    WSL.CSC_MAX_ITER both transforms return the batch as it is, and both
    heads fall back to the MIL loss."""
    cfg = csc_V_16_DC5_cfg(narrow=True)
    jm, variables, tm, batch, jb = case_models(cfg)
    want = _jax_cpg(jm, variables, jb, 10, 3)
    tm.train()
    got, passes = class_peak_gradients(tm, batch, 20)
    got = got.numpy()
    assert passes == 2 and got.shape == want.shape == (2, 20, 128, 176)
    peaks = want.max(axis=(2, 3))
    assert peaks[0, 3] == 1.0 and np.count_nonzero(peaks) == 1
    err = float(np.abs(want - got).max())
    print("cpg maps max_abs_err", err, "nonzero", np.count_nonzero(got.max(axis=(2, 3))))
    assert err <= 2e-2
    np.testing.assert_array_equal(got.max(axis=(2, 3)) > 0, peaks > 0)
    assert tm.training and tm.roi_heads.dan.training  # the pass gives the modes back

    # past CSC_MAX_ITER: the batch as it is, and the plain MIL loss on both sides
    transform = make_cpg_batch_transform(tm, 10, 20)
    assert transform(None, batch, 11) is batch and _jax_cpg(jm, variables, jb, 10, 11) is None
    assert "cpg" in transform(None, batch, 10)
    want_losses = jax.jit(lambda v: jm.apply(v, jb, train=True, rngs={"dropout": jax.random.key(0)}))(variables)
    tm.roi_heads.dan.dropout = 0.0
    with torch.no_grad():
        losses = tm(batch)
    assert sorted(losses) == sorted(want_losses) == ["loss_mil"]
    _close(float(want_losses["loss_mil"]), losses["loss_mil"].item())


def test_cpg_maps_are_zero_where_freeze_at_detaches_the_pooled_map():
    """CSC on WSR-18 at the yaml's FREEZE_AT 5: res5 carries no gradient to
    the image, the JAX maps are all zero, and the port's pass runs no
    backward."""
    cfg = csc_WSR_18_DC5_cfg(narrow=True)
    cfg.MODEL.BACKBONE.FREEZE_AT = 5
    jm, variables, tm, batch, jb = case_models(cfg)
    want = _jax_cpg(jm, variables, jb, 10, 0)
    got, passes = class_peak_gradients(tm, batch, 20)
    assert passes == 0 and not want.any() and not got.numpy().any() and got.shape == want.shape
