"""The C4 family in the port held against the JAX package on the CPU: Mask
R-CNN R50-C4 (``Res5ROIHeads`` with the C4 mask head) and Faster R-CNN on
the WS-ResNet-50's res4 (``WSRes5ROIHeads``), both in their narrow forms
(``mask_rcnn_R_50_C4_cfg(narrow=True)``, ``faster_rcnn_WSR_50_C4_cfg(narrow=True)``)
with seeded weights carried across by ``checkpoint.variables_to_state_dict``;
the 16 yamls of the C4 family, Trident OICR and the WSR-50 FPN against
their builders; and the checkpoints of ``roi_heads.res5`` and of the
multi-rate trunk through both packages' converters.

Sampling is deterministic on both sides, as ``tests/test_torch_train_step.py``
sets out: 2048 RPN slots for the 1320 anchors of a 128x176 image's res4,
and 128 proposals plus 4 ground truth rows for the 132 ROI slots, at
positive fraction 1.0; no image has more than 128 foreground slots, so
the C4 mask head reads every one and no draw decides ``loss_mask``. The
box classifier's kernel is scaled by 0.05 on both sides: at random
weights res5's mean saturates the softmax, whose ties of 1.0 then rank
either way.

Tolerances (float32 on both sides, JAX matmul precision "highest";
measured on the CPU in brackets):

* detections: classes and validity equal, boxes within 1e-3 px of the
  network's input (at most 5.6e-4, WSR-50 C4's), scores and mask
  probabilities within 1e-4 of the JAX side's largest (at most 3.6e-6 and
  6.1e-7);
* the train step's losses within 1e-5 relative (at most 6.3e-7), each
  parameter's gradient within 1e-4 of its L2 norm (at most 3.7e-5); a
  norm below 1e-2 of the largest is held relative to that 1e-2 instead.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jtsm_tpu.wsl  # noqa: F401  (registers the WSL modules)
from jtsm_tpu.checkpoint.c2_model_loading import convert_d2_state_dict_to_variables
from jtsm_tpu.config import get_cfg as jax_get_cfg
from jtsm_tpu.modeling import build_model as jax_build_model
from jtsm_tpu.wsl import add_wsl_config as jax_add_wsl_config
from jtsm_tpu_torch.checkpoint import variables_to_state_dict
from jtsm_tpu_torch.config import (
    C4_TRIDENT_FPN_ZOO,
    faster_rcnn_R_50_C4_cfg,
    faster_rcnn_WSR_50_C4_cfg,
    get_cfg,
    mask_rcnn_R_50_C4_cfg,
    oicr_TRD_WSR_18_DC5_cfg,
    wsl_cfg,
)
from jtsm_tpu_torch.layers import ShapeSpec
from jtsm_tpu_torch.modeling import build_model
from jtsm_tpu_torch.modeling.roi_heads.mask_head import build_mask_head
from tests.test_torch_jtsm import _jax_cfg
from tests.test_torch_meta_archs import _random_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_REL = 1e-4
TOL_PX = 1e-3
TOL_LOSS = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _rel(want, got):
    a, b = np.asarray(want, np.float64), np.asarray(got, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max(initial=0.0)) / max(1e-30, float(np.abs(a).max(initial=0.0)))


def train_batch(h=128, w=176, g=4, seed=0, masks=True):
    """Two images of the narrow configurations' bucket with ``g`` ground
    truth rows each (the last invalid), 30-90 px boxes and, with
    ``masks``, their 28x28 crops."""
    rng = np.random.RandomState(seed)
    xy = rng.rand(2, g, 2) * [w - 100, h - 100]
    batch = {
        "image": (rng.rand(2, h, w, 3) * 255).astype(np.float32),
        "image_sizes": np.array([[h, w], [h - 16, w - 32]], np.int32),
        "orig_sizes": np.array([[2 * h, 2 * w], [h - 16, w - 32]], np.int32),
        "gt_boxes": np.concatenate([xy, xy + 30 + rng.rand(2, g, 2) * 60], -1).astype(np.float32),
        "gt_classes": rng.randint(0, 20, (2, g)).astype(np.int32),
        "gt_valid": np.array([[True] * (g - 1) + [False]] * 2),
    }
    if masks:
        batch["gt_mask_crops"] = rng.rand(2, g, 28, 28) > 0.5
    return batch


def deterministic_sampling(cfg, g=4):
    """Every anchor an RPN slot and every proposal and ground truth row a
    ROI slot, at positive fraction 1.0; detections scored from 0."""
    cfg.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 2048
    cfg.MODEL.RPN.POSITIVE_FRACTION = 1.0
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN + g
    cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION = 1.0
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0
    return cfg


def _scaled(variables, names, factor):
    return jax.tree_util.tree_map_with_path(
        lambda path, a: a * factor if any(n in str(path) for n in names) and "kernel" in str(path) else a, variables)


def check_supervised_model(cfg, batch, seed=0, grad_tol=TOL_REL):
    """``cfg``'s model in both packages from the same seeded weights (the
    box classifier's kernel scaled by 0.05): the serving detections (and
    masks) of ``batch``'s images, then one train step's losses and every
    parameter's gradient. Returns the JAX losses, the worst gradient gap
    and the port's model."""
    jm = jax_build_model(_jax_cfg(cfg))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = _scaled(_random_variables(jm, jb, seed=seed, train=False), ("cls_score",), 0.05)
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(variables_to_state_dict(variables), strict=True)

    def run(params):
        def loss(p):
            out = jm.apply({**variables, "params": p}, jb, train=True, rngs={"sampling": jax.random.key(1)})
            return sum(out.values()), out

        (_, losses), grads = jax.value_and_grad(loss, has_aux=True)(params)
        return jm.apply({**variables, "params": params}, jb, train=False), losses, grads

    with jax.default_matmul_precision("highest"):
        want, want_losses, grads = jax.jit(run)(variables["params"])
    serve = {k: v for k, v in batch.items() if not k.startswith("gt_")}
    got = tm.inference(serve)
    assert sorted(got) == sorted(want)
    for k in ("valid", "classes"):
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]), err_msg=k)
    assert np.asarray(want["valid"]).sum() > 20
    # boxes in the network input's pixels (the answer's are the original image's)
    per_px = (batch["orig_sizes"] / batch["image_sizes"]).astype(np.float64)[:, None, [1, 0, 1, 0]]
    px = float(np.abs(_np(got["boxes"]) - np.asarray(want["boxes"])).__truediv__(per_px).max())
    print("boxes px", px)
    assert px <= TOL_PX
    for k in ("scores", "masks"):
        if k in want:
            err = _rel(np.asarray(want[k]), _np(got[k]))
            print(k, err)
            assert err <= TOL_REL, k

    tm.train()
    losses = tm(batch, generator=torch.Generator().manual_seed(0))
    assert sorted(losses) == sorted(want_losses)
    worst = max(_rel(float(want_losses[k]), losses[k].item()) for k in want_losses)
    print("losses", worst)
    assert worst <= TOL_LOSS and all(float(v) > 0 for v in want_losses.values())
    sum(losses.values()).backward()
    want_grads = variables_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, grads)})
    scale = max(float(np.linalg.norm(g.numpy())) for g in want_grads.values())
    worst = 0.0
    for name, p in tm.named_parameters():
        w = want_grads[name].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        err = np.linalg.norm(w - g) / max(np.linalg.norm(w), 1e-2 * scale)
        worst = max(worst, err)
        assert err <= grad_tol, (name, err)
    print("gradients", worst)
    return want_losses, worst, tm


# -- the C4 models -------------------------------------------------------------------


def test_mask_rcnn_c4_serves_and_trains_as_jax():
    cfg = deterministic_sampling(mask_rcnn_R_50_C4_cfg(narrow=True))
    losses, _, tm = check_supervised_model(cfg, train_batch())
    assert sorted(losses) == ["loss_box_reg", "loss_cls", "loss_mask", "loss_rpn_cls", "loss_rpn_loc"]
    heads = tm.roi_heads
    assert type(heads).__name__ == "Res5ROIHeads" and len(heads.res5) == 3
    assert heads.res5[0].conv1.stride == (2, 2) and heads.pooler.output_size == (14, 14)
    # the C4 mask head: no convolution, the deconvolution on res5's channels
    assert not heads.mask_head.conv_norm_relus and heads.mask_head.deconv.in_channels == 256


def test_wsr_50_c4_serves_and_trains_as_jax():
    cfg = deterministic_sampling(faster_rcnn_WSR_50_C4_cfg(narrow=True))
    losses, _, tm = check_supervised_model(cfg, train_batch(seed=1, masks=False), seed=1)
    assert "loss_mask" not in losses
    assert type(tm.roi_heads).__name__ == "WSRes5ROIHeads"
    assert type(tm.backbone.stem).__name__ == "WSLStem"


def test_c4_mask_head_builds_without_convolutions_on_res5():
    """At full width the C4 mask head is the deconvolution from 2048
    channels and the predictor, its logits (N, 80, 14, 14) from res5's
    7x7."""
    cfg = mask_rcnn_R_50_C4_cfg()
    head = build_mask_head(cfg, ShapeSpec(channels=2048, height=7, width=7))
    assert not head.conv_norm_relus and head.deconv.in_channels == 2048
    assert head(torch.zeros(3, 7, 7, 2048)).shape == (3, 80, 14, 14)


# -- the yamls -------------------------------------------------------------------------

# the yamls of the slice that have no builder of their own: yaml -> (the
# builder they differ from, their differences)
_3X = ["SOLVER.STEPS", "(210000, 250000)", "SOLVER.MAX_ITER", "270000"]
_INSTANT = ["DATASETS.TRAIN", "('coco_2017_val_100',)", "DATASETS.TEST", "('coco_2017_val_100',)",
            "SOLVER.STEPS", "(30,)", "SOLVER.MAX_ITER", "40", "SOLVER.IMS_PER_BATCH", "4",
            "DATALOADER.NUM_WORKERS", "0"]
VARIANTS = {
    "configs/COCO-Detection/faster_rcnn_R_50_C4_3x.yaml": (faster_rcnn_R_50_C4_cfg, _3X),
    "configs/COCO-Detection/faster_rcnn_R_101_C4_3x.yaml": (faster_rcnn_R_50_C4_cfg, _3X + [
        "MODEL.RESNETS.DEPTH", "101", "MODEL.WEIGHTS", "detectron2://ImageNetPretrained/MSRA/R-101.pkl"]),
    "configs/COCO-InstanceSegmentation/mask_rcnn_R_50_C4_3x.yaml": (mask_rcnn_R_50_C4_cfg, _3X),
    "configs/COCO-InstanceSegmentation/mask_rcnn_R_101_C4_3x.yaml": (mask_rcnn_R_50_C4_cfg, _3X + [
        "MODEL.RESNETS.DEPTH", "101", "MODEL.WEIGHTS", "detectron2://ImageNetPretrained/MSRA/R-101.pkl"]),
    "configs/quick_schedules/mask_rcnn_R_50_C4_instant_test.yaml": (mask_rcnn_R_50_C4_cfg, _INSTANT + [
        "SOLVER.BASE_LR", "0.005"]),
    "configs/quick_schedules/mask_rcnn_R_50_C4_GCV_instant_test.yaml": (mask_rcnn_R_50_C4_cfg, _INSTANT + [
        "SOLVER.BASE_LR", "0.001", "SOLVER.CLIP_GRADIENTS.ENABLED", "True", "SOLVER.CLIP_GRADIENTS.CLIP_TYPE",
        "value", "SOLVER.CLIP_GRADIENTS.CLIP_VALUE", "1.0"]),
    "configs/quick_schedules/mask_rcnn_R_50_C4_inference_acc_test.yaml": (mask_rcnn_R_50_C4_cfg, _3X + [
        "MODEL.WEIGHTS", "detectron2://placeholder/model_final.pkl", "DATASETS.TEST", "('coco_2017_val_100',)",
        "TEST.EXPECTED_RESULTS", "[['bbox', 'AP', 47.37, 0.02], ['segm', 'AP', 40.99, 0.02]]"]),
    "configs/quick_schedules/mask_rcnn_R_50_C4_training_acc_test.yaml": (mask_rcnn_R_50_C4_cfg, [
        "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "256", "DATASETS.TRAIN", "('coco_2017_val_100',)",
        "DATASETS.TEST", "('coco_2017_val_100',)", "INPUT.MIN_SIZE_TRAIN", "(600,)", "INPUT.MAX_SIZE_TRAIN", "1000",
        "INPUT.MIN_SIZE_TEST", "800", "INPUT.MAX_SIZE_TEST", "1000", "SOLVER.IMS_PER_BATCH", "8",
        "SOLVER.WARMUP_FACTOR", "0.33333", "SOLVER.WARMUP_ITERS", "100", "SOLVER.STEPS", "(11000, 11600)",
        "SOLVER.MAX_ITER", "12000",
        "TEST.EXPECTED_RESULTS", "[['bbox', 'AP', 41.88, 2.5], ['segm', 'AP', 33.79, 4.0]]"]),
    "projects/WSL/configs/PascalVOC-Detection/faster_rcnn_R_50_C4.yaml": (faster_rcnn_R_50_C4_cfg, [
        "MODEL.ROI_HEADS.NUM_CLASSES", "20", "INPUT.MIN_SIZE_TRAIN", "(480, 512, 544, 576, 608, 640, 672, 704, 736, "
        "768, 800)", "INPUT.MIN_SIZE_TEST", "800", "DATASETS.TRAIN", "('voc_2007_train', 'voc_2007_val')",
        "DATASETS.TEST", "('voc_2007_test',)", "SOLVER.STEPS", "(12000, 16000)", "SOLVER.MAX_ITER", "18000",
        "SOLVER.WARMUP_ITERS", "100", "SOLVER.REFERENCE_WORLD_SIZE", "8"]),
}
YAMLS = sorted([y for y, _ in C4_TRIDENT_FPN_ZOO.values()] + list(VARIANTS))


def _tree(yaml):
    return wsl_cfg() if yaml.startswith("projects") else get_cfg()


def _expected(yaml):
    for y, builder in C4_TRIDENT_FPN_ZOO.values():
        if y == yaml:
            return builder()
    builder, opts = VARIANTS[yaml]
    cfg = _tree(yaml)
    cfg.merge_from_other_cfg(builder())
    cfg.merge_from_list(opts)
    return cfg


def test_sixteen_yamls():
    assert len(YAMLS) == 16


@pytest.mark.parametrize("yaml", YAMLS)
def test_yaml_equals_its_builder_and_builds_in_both_packages(yaml):
    """The yaml merged into the defaults (the WSL defaults under
    ``projects/``) equals its builder (with the variant's differences) and
    the tree the JAX package reads from it, and the port builds the full-width
    model on the CPU, with the heads the yaml names."""
    cfg = _tree(yaml)
    cfg.merge_from_file(os.path.join(ROOT, yaml))
    assert _expected(yaml).to_dict() == cfg.to_dict()
    jc = jax_get_cfg()
    if yaml.startswith("projects"):
        jax_add_wsl_config(jc)
    jc.merge_from_file(os.path.join(ROOT, yaml))
    jc.MODEL.DEVICE = cfg.MODEL.DEVICE  # "tpu" there, "cuda" here
    assert jc.to_dict() == cfg.to_dict()
    model = build_model(cfg, device="cpu")
    assert type(model.roi_heads).__name__ == cfg.MODEL.ROI_HEADS.NAME
    for name, (y, builder) in C4_TRIDENT_FPN_ZOO.items():
        if y == yaml:
            narrow = builder(narrow=True)
            assert narrow.MODEL.ROI_HEADS.NAME == cfg.MODEL.ROI_HEADS.NAME
            assert narrow.TPU.COMPUTE_DTYPE == "float32" and narrow.INPUT.MIN_SIZE_TEST == 128


# -- checkpoints -----------------------------------------------------------------------


@pytest.mark.parametrize("case", ["c4", "trident"])
def test_checkpoints_cross_both_converters(case):
    """The port's detectron2 names (``roi_heads.res5.{b}.*`` of the C4
    heads; the multi-rate trunk's one set of res5 weights) load into the
    JAX package's tree through its converter, every key matched, and come
    back through the port's converter unchanged."""
    cfg = mask_rcnn_R_50_C4_cfg(narrow=True) if case == "c4" else oicr_TRD_WSR_18_DC5_cfg(narrow=True)
    jm = jax_build_model(_jax_cfg(cfg))
    batch = train_batch(masks=False)
    batch = {k: jnp.asarray(v) for k, v in batch.items() if not k.startswith("gt_")}
    if case == "trident":
        batch["proposals"] = jnp.asarray(np.tile([[[8.0, 8.0, 60.0, 50.0]]], (2, 16, 1)))
        batch["proposal_scores"] = jnp.zeros((2, 16))
    variables = _random_variables(jm, batch, seed=3, train=False)
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(variables_to_state_dict(variables), strict=True)
    state = {k: v.numpy() for k, v in tm.state_dict().items()}
    if case == "c4":
        assert {f"roi_heads.res5.{b}.conv1.weight" for b in range(3)} <= set(state)
        assert "roi_heads.res5.0.shortcut.weight" in state and "backbone.res5.0.conv1.weight" not in state
    else:
        assert "backbone.res5.1.conv2.weight" in state and not any("mrrp" in k for k in state)
    back, matched, unmatched = convert_d2_state_dict_to_variables(state, variables)
    assert not unmatched and len(matched) == len(state) == len(jax.tree_util.tree_leaves(variables))
    again = variables_to_state_dict(jax.tree_util.tree_map(np.asarray, back))
    for k, v in state.items():
        np.testing.assert_array_equal(again[k].numpy(), v, err_msg=k)
