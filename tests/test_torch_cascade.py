"""Cascade R-CNN in the port (``modeling/roi_heads/cascade_rcnn.py``) held
against the JAX package on the CPU, and the core yamls of the slice.

The models come from the same seeded weights on both sides
(``_random_variables``, carried across by ``variables_to_state_dict``; each
stage's box classifier kernel scaled by 0.05, as in
``tests/test_torch_c4.py``, so that ties at a saturated softmax do not rank
either way, and its box regressor's too, so that the ground truth rows
appended at stage 0 stay foreground at stage 2's IoU 0.7 (unscaled, the
random features move every box off its match by then and stage 2's box and
mask losses are 0); the deformable blocks' offset kernels scaled as in
``tests/test_torch_deform.py``). Sampling is deterministic on both sides: an
RPN slot for every anchor and an ROI slot for every proposal and ground
truth row, at positive fraction 1.0. At stages 1 and 2 the candidates are
then exactly the slots, so every valid box is taken; the slots' order
differs between the packages (their own slot-order draws), which the losses,
means over the slots, do not see. No image has more than 128 foreground
slots, so the mask branch reads every one.

Tolerances (float32 on both sides, JAX matmul precision "highest"; the
largest gap measured on the CPU in brackets):

* detections: classes and validity equal, boxes within 1e-3 px of the
  network's input (at most 9.2e-5), scores and mask probabilities within 1e-4
  of the JAX side's largest (at most 3.2e-6 and 2.0e-6);
* losses within 1e-5 relative (at most 8.3e-7), each parameter's gradient
  within 1e-4 of its L2 norm (at most 1.8e-6; a norm below 1e-2 of the
  largest is held relative to that 1e-2). In the stand-in for the combined
  yamls (GN throughout, a 4-conv GN box head, deformable res3-res5)
  float32 alone moves single gradients of the backbone and the stage-0 box
  head by up to 2.8e-2 from the port's own float64 step, and the JAX
  float32 step sits as far from it, so float32 does not determine them to
  1e-4: there all gradients together are held normwise within the larger
  of 1e-4 and 3x the port's own float32-to-float64 gap (the rule of
  ``chip_smoke.py``'s narrow checks; measured 1.8e-2 against 9.6e-3);
* bfloat16 (``tests/test_torch_compute_dtype.py``'s bound for a train
  step's losses): each loss within 3e-2 relative (at most 2.0e-3).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jtsm_tpu.modeling.roi_heads.cascade_rcnn  # noqa: F401  (registers CascadeROIHeads)
from jtsm_tpu.config import get_cfg as jax_get_cfg
from jtsm_tpu.modeling import build_model as jax_build_model
from jtsm_tpu_torch.checkpoint import variables_to_state_dict
from jtsm_tpu_torch.config import (
    cascade_mask_rcnn_R_50_FPN_cfg,
    cascade_mask_rcnn_X_152_32x8d_FPN_IN5k_gn_dconv_cfg,
    fast_rcnn_R_50_FPN_cfg,
    get_cfg,
    mask_rcnn_R_50_FPN_dconv_cfg,
    panoptic_fpn_R_101_dconv_cascade_gn_cfg,
)
from jtsm_tpu_torch.modeling import build_model
from tests.modeling.test_cascade_dcn_tta import _batch as jax_test_batch
from tests.modeling.test_cascade_dcn_tta import _cascade_cfg
from tests.test_torch_c4 import _np, _rel, _scaled, train_batch
from tests.test_torch_deform import offsets_scaled
from tests.test_torch_jtsm import _jax_cfg
from tests.test_torch_meta_archs import _random_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_REL = 1e-4
TOL_PX = 1e-3
TOL_LOSS = 1e-5
TOL_BF16_LOSS = 3e-2
F64_NOISE = 3.0


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def deterministic(cfg, g=4):
    """Every anchor an RPN slot, every proposal and ground truth row an ROI
    slot (``g`` rows), at positive fraction 1.0; detections scored from
    0."""
    cfg.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 8192
    cfg.MODEL.RPN.POSITIVE_FRACTION = 1.0
    k = cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN if cfg.MODEL.LOAD_PROPOSALS else cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = k + g
    cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION = 1.0
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0
    return cfg


def batch_of(cfg, seed=0, g=4):
    """``train_batch`` (two images of the narrow bucket) with classes within
    NUM_CLASSES and, without MASK_ON, no crops."""
    batch = train_batch(seed=seed, g=g, masks=cfg.MODEL.MASK_ON)
    batch["gt_classes"] %= cfg.MODEL.ROI_HEADS.NUM_CLASSES
    return batch


def jax_variables(jm, batch, seed, deform=False):
    variables = _scaled(_random_variables(jm, batch, seed=seed, train=False), ("cls_score", "bbox_pred"), 0.05)
    return offsets_scaled(variables) if deform else variables


def run_jax(jm, variables, batch):
    """JAX's serving output, train losses and gradients (sampling key 1)."""

    def run(params):
        def loss(p):
            out = jm.apply({**variables, "params": p}, batch, train=True, rngs={"sampling": jax.random.key(1)})
            return sum(out.values()), out

        (_, losses), grads = jax.value_and_grad(loss, has_aux=True)(params)
        return jm.apply({**variables, "params": params}, batch, train=False), losses, grads

    with jax.default_matmul_precision("highest"):
        return jax.jit(run)(variables["params"])


def float64_gradients(cfg, state, batch):
    """The port's gradients of one train step in float64, by name."""
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(state, strict=True)
    tm.double().train()
    b64 = {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in batch.items()}
    sum(tm(b64, generator=torch.Generator().manual_seed(0)).values()).backward()
    return {n: p.grad.numpy() for n, p in tm.named_parameters()}


def check_model(cfg, batch, seed=0, deform=False, f64_noise=False, tol_px=TOL_PX, tol_rel=TOL_REL):
    """``cfg``'s model in both packages from the same seeded weights: the
    serving detections (and masks) of ``batch``'s images, one train step's
    losses and every parameter's gradient. With ``f64_noise`` the gradients
    are held together, within the larger of TOL_REL and F64_NOISE times the
    port's own float32-to-float64 gap. ``tol_px`` and ``tol_rel`` hold the
    boxes and the scores and masks. Returns the JAX losses and the port's
    model."""
    jm = jax_build_model(_jax_cfg(cfg))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax_variables(jm, jb, seed, deform)
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(variables_to_state_dict(variables), strict=True)
    want, want_losses, want_grads = run_jax(jm, variables, jb)
    got = tm.inference({k: v for k, v in batch.items() if not k.startswith("gt_")})
    assert sorted(got) == sorted(want)
    for k in ("valid", "classes"):
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]), err_msg=k)
    assert np.asarray(want["valid"]).sum() > 10
    per_px = (batch["orig_sizes"] / batch["image_sizes"]).astype(np.float64)[:, None, [1, 0, 1, 0]]
    px = float((np.abs(_np(got["boxes"]) - np.asarray(want["boxes"])) / per_px).max())
    print("boxes px", px)
    assert px <= tol_px
    for k in ("scores", "masks"):
        if k in want:
            err = _rel(np.asarray(want[k]), _np(got[k]))
            print(k, err)
            assert err <= tol_rel, k

    tm.train()
    losses = tm(batch, generator=torch.Generator().manual_seed(0))
    assert sorted(losses) == sorted(want_losses)
    worst = max(_rel(float(want_losses[k]), losses[k].item()) for k in want_losses)
    print("losses", worst, {k: round(float(v), 6) for k, v in want_losses.items()})
    assert worst <= TOL_LOSS and all(float(v) > 0 for v in want_losses.values())
    sum(losses.values()).backward()
    state = variables_to_state_dict(variables)
    exact = float64_gradients(cfg, state, batch) if f64_noise else None
    want_grads = variables_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, want_grads)})
    scale = max(float(np.linalg.norm(g.numpy())) for g in want_grads.values())
    worst, total = 0.0, np.zeros(3)
    for name, p in tm.named_parameters():
        w = want_grads[name].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        denom = max(np.linalg.norm(w), 1e-2 * scale)
        err = np.linalg.norm(w - g) / denom
        if exact is not None:  # held in the total below
            total += [np.sum((w - g) ** 2), np.sum((exact[name] - g) ** 2), np.sum(w ** 2)]
            continue
        worst = max(worst, err)
        assert err <= TOL_REL, (name, err)
    print("gradients", worst)
    if exact is not None:
        err, gap = np.sqrt(total[:2] / total[2])
        print("all gradients", err, "the port's float32 against float64", gap)
        assert err <= max(TOL_REL, F64_NOISE * gap)
    return want_losses, tm


def check_bf16_losses(cfg, batch, seed=0):
    """The train step's losses of ``cfg`` in bfloat16 on both sides, each
    within TOL_BF16_LOSS relative."""
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    jm = jax_build_model(_jax_cfg(cfg))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax_variables(jm, jb, seed)
    want = jax.jit(lambda v: jm.apply(v, jb, train=True, rngs={"sampling": jax.random.key(1)}))(variables)
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(variables_to_state_dict(variables), strict=True)
    tm.train()
    got = tm(batch, generator=torch.Generator().manual_seed(0))
    assert sorted(got) == sorted(want)
    worst = max(_rel(float(want[k]), got[k].item()) for k in want)
    print("bf16 losses", worst)
    assert worst <= TOL_BF16_LOSS
    return want


# -- the cascade -----------------------------------------------------------------------

STAGE_LOSSES = [f"{k}_stage{s}" for s in range(3) for k in ("loss_box_reg", "loss_cls")]


def test_narrow_cascade_serves_and_trains_as_jax():
    """The narrow Cascade Mask R-CNN (``cascade_mask_rcnn_R_50_FPN_cfg(narrow=True)``):
    detections and masks, the per-stage losses, every gradient."""
    cfg = deterministic(cascade_mask_rcnn_R_50_FPN_cfg(narrow=True))
    losses, tm = check_model(cfg, batch_of(cfg))
    assert sorted(losses) == sorted(STAGE_LOSSES + ["loss_mask", "loss_rpn_cls", "loss_rpn_loc"])
    heads = tm.roi_heads
    assert type(heads).__name__ == "CascadeROIHeads" and len(heads.box_head) == 3
    assert all(p.bbox_pred.out_features == 4 for p in heads.box_predictor)  # class-agnostic
    assert [t.weights for t in heads.box2box_transforms] == [(10.0, 10.0, 5.0, 5.0), (20.0, 20.0, 10.0, 10.0),
                                                             (30.0, 30.0, 15.0, 15.0)]
    assert [m.thresholds[1] for m in heads.proposal_matchers] == [0.5, 0.6, 0.7]


def test_cascade_stage_losses_on_the_jax_tests_config():
    """``tests/modeling/test_cascade_dcn_tta.py``'s narrow cascade (R18,
    64x64 scenes, 3 ground truth rows, no masks), sampled deterministically:
    the per-stage losses."""
    jc = _cascade_cfg()
    cfg = get_cfg()
    cfg.merge_from_other_cfg(jc)
    deterministic(cfg, g=3)
    batch = {k: np.asarray(v) for k, v in jax_test_batch(np.random.RandomState(0)).items()}
    jm = jax_build_model(_jax_cfg(cfg))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax_variables(jm, jb, 0)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda v: jm.apply(v, jb, train=True, rngs={"sampling": jax.random.key(2)}))(variables)
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(variables_to_state_dict(variables), strict=True)
    tm.train()
    got = tm(batch, generator=torch.Generator().manual_seed(0))
    assert sorted(got) == sorted(STAGE_LOSSES + ["loss_rpn_cls", "loss_rpn_loc"]) == sorted(want)
    worst = max(_rel(float(want[k]), got[k].item()) for k in want)
    print("losses", worst, {k: round(float(v), 5) for k, v in want.items()})
    assert worst <= TOL_LOSS


def test_cascade_stand_in_for_the_combined_yamls():
    """A narrow stand-in for the X-152 GN dconv cascade and the Panoptic FPN
    R-101 dconv cascade: depth 50, NUM_GROUPS 32 x WIDTH_PER_GROUP 2, the
    stride on the 3x3, GN everywhere, deformable res3-res5 and a 4-conv GN
    box head."""
    cfg = deterministic(cascade_mask_rcnn_R_50_FPN_cfg(narrow=True))
    m = cfg.MODEL
    m.RESNETS.NUM_GROUPS = 32
    m.RESNETS.WIDTH_PER_GROUP = 2
    m.RESNETS.STRIDE_IN_1X1 = False
    m.RESNETS.NORM = "GN"
    m.RESNETS.DEFORM_ON_PER_STAGE = [False, True, True, True]
    m.FPN.NORM = "GN"
    m.ROI_BOX_HEAD.NUM_CONV = 4
    m.ROI_BOX_HEAD.NORM = "GN"
    m.ROI_MASK_HEAD.NORM = "GN"
    _, tm = check_model(cfg, batch_of(cfg, seed=1), seed=1, deform=True, f64_noise=True)
    block = tm.backbone.bottom_up.res3[0]
    assert type(block).__name__ == "DeformBottleneckBlock" and block.stride_3x3 == 2
    assert tuple(block.conv2.weight.shape) == (128, 128, 3, 3)  # dense, not 32 groups
    assert len(tm.roi_heads.box_head[0].conv_norm_relus) == 4


def test_cascade_bf16_losses_as_jax():
    cfg = deterministic(cascade_mask_rcnn_R_50_FPN_cfg(narrow=True))
    check_bf16_losses(cfg, batch_of(cfg, seed=2), seed=2)


# -- the yamls -------------------------------------------------------------------------

_3X = ["SOLVER.STEPS", "(210000, 250000)", "SOLVER.MAX_ITER", "270000"]
_INSTANT = ["DATASETS.TRAIN", "('coco_2017_val_100',)", "DATASETS.TEST", "('coco_2017_val_100',)",
            "SOLVER.BASE_LR", "0.005", "SOLVER.STEPS", "(30,)", "SOLVER.MAX_ITER", "40",
            "SOLVER.IMS_PER_BATCH", "4", "DATALOADER.NUM_WORKERS", "0"]
_VAL_PROPOSALS = ("('detectron2://COCO-Detection/rpn_R_50_FPN_1x/137258492/"
                  "coco_2017_val_box_proposals_ee0dad.pkl',)")
# the 11 core yamls that build in the port from this slice on: yaml -> (its
# builder, the yaml's differences from it)
YAMLS = {
    "configs/Misc/cascade_mask_rcnn_R_50_FPN_1x.yaml": (cascade_mask_rcnn_R_50_FPN_cfg, []),
    "configs/Misc/cascade_mask_rcnn_R_50_FPN_3x.yaml": (cascade_mask_rcnn_R_50_FPN_cfg, _3X),
    "configs/quick_schedules/cascade_mask_rcnn_R_50_FPN_inference_acc_test.yaml": (
        cascade_mask_rcnn_R_50_FPN_cfg, _3X + [
            "MODEL.WEIGHTS", "detectron2://placeholder/model_final.pkl", "DATASETS.TEST", "('coco_2017_val_100',)",
            "TEST.EXPECTED_RESULTS", "[['bbox', 'AP', 50.18, 0.02], ['segm', 'AP', 43.87, 0.02]]"]),
    "configs/quick_schedules/cascade_mask_rcnn_R_50_FPN_instant_test.yaml": (cascade_mask_rcnn_R_50_FPN_cfg,
                                                                             _INSTANT),
    "configs/Misc/mask_rcnn_R_50_FPN_1x_dconv_c3-c5.yaml": (mask_rcnn_R_50_FPN_dconv_cfg, []),
    "configs/Misc/mask_rcnn_R_50_FPN_3x_dconv_c3-c5.yaml": (mask_rcnn_R_50_FPN_dconv_cfg, _3X),
    "configs/Misc/cascade_mask_rcnn_X_152_32x8d_FPN_IN5k_gn_dconv.yaml": (
        cascade_mask_rcnn_X_152_32x8d_FPN_IN5k_gn_dconv_cfg, []),
    "configs/Misc/panoptic_fpn_R_101_dconv_cascade_gn_3x.yaml": (panoptic_fpn_R_101_dconv_cascade_gn_cfg, []),
    "configs/COCO-Detection/fast_rcnn_R_50_FPN_1x.yaml": (fast_rcnn_R_50_FPN_cfg, []),
    "configs/quick_schedules/fast_rcnn_R_50_FPN_inference_acc_test.yaml": (fast_rcnn_R_50_FPN_cfg, [
        "MODEL.WEIGHTS", "detectron2://placeholder/model_final.pkl", "DATASETS.TEST", "('coco_2017_val_100',)",
        "TEST.EXPECTED_RESULTS", "[['bbox', 'AP', 45.70, 0.02]]"]),
    "configs/quick_schedules/fast_rcnn_R_50_FPN_instant_test.yaml": (fast_rcnn_R_50_FPN_cfg, _INSTANT + [
        "DATASETS.PROPOSAL_FILES_TRAIN", _VAL_PROPOSALS]),
}


@pytest.mark.parametrize("yaml", sorted(YAMLS))
def test_core_yaml_equals_its_builder_and_builds(yaml):
    """The yaml merged into the defaults equals its builder (with its
    differences) and the tree the JAX package reads from it, and the port
    builds its full-width model on the CPU with the heads, backbone and
    proposal source it names."""
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, yaml))
    builder, opts = YAMLS[yaml]
    want = get_cfg()
    want.merge_from_other_cfg(builder())
    want.merge_from_list(opts)
    assert want.to_dict() == cfg.to_dict()
    jc = jax_get_cfg()
    jc.merge_from_file(os.path.join(ROOT, yaml))
    jc.MODEL.DEVICE = cfg.MODEL.DEVICE
    assert jc.to_dict() == cfg.to_dict()
    model = build_model(cfg, device="cpu")
    assert type(model.roi_heads).__name__ == cfg.MODEL.ROI_HEADS.NAME
    assert (model.proposal_generator is None) == (cfg.MODEL.PROPOSAL_GENERATOR.NAME == "PrecomputedProposals")
    deform = sum(type(m).__name__ == "DeformBottleneckBlock" for m in model.backbone.modules())
    assert deform == (0 if not any(cfg.MODEL.RESNETS.DEFORM_ON_PER_STAGE) else
                      {50: 13, 101: 30, 152: 47}[cfg.MODEL.RESNETS.DEPTH])
