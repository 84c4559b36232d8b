"""The port's other core meta-architectures held against the JAX package on
the CPU: Keypoint R-CNN, RetinaNet, ProposalNetwork, PanopticFPN and
SemanticSegmentor on the tiny configs of ``tests/modeling/test_meta_archs.py``
with seeded weights (carried across by
``checkpoint.variables_to_state_dict``), and their new pieces one by one:
``LastLevelP6P7``, the anchors of several sizes a level, RetinaNet's decode,
the keypoint head and its decode, OKS and keypoint AP, the proposals'
recall, the Python configs, and the RetinaNet and keypoint heads in bf16.

Tolerances (float32 on both sides, TF32 off, JAX matmul precision
"highest"; measured on the CPU in brackets):

* logits, sem-seg logits, heatmaps, scores and mask probabilities: within
  1e-4 of the largest magnitude of the JAX side (largest measured: the RPN
  logits 2.8e-4 of a scale above 2.8, detection scores 2.8e-5, keypoint
  logits 5.1e-6, mask probabilities 3.4e-6, sem-seg logits 1.0e-7);
* boxes, proposals and keypoint x, y: within 1e-3 px of the network's
  input (boxes 3.1e-4 px, proposals 3.2e-4 px, keypoints 1.9e-4 px);
* integers (classes, validity, the sem-seg argmax, each keypoint's bin):
  equal, except where the two values that decide them lie within 1e-4 of
  the scale on the JAX side, a near-tie that float32 rounding may break
  either way (a proposal's rank: slots may trade places only with a score
  within that of the other's); measured: 1 keypoint of 1751 on another
  bin, its two maxima 8.9e-8 of the logits' scale apart, every other
  integer equal, but for the subnormal scores below;
* XLA's CPU flushes subnormal floats to zero (ROADMAP §3): at
  SCORE_THRESH_TEST 0, 12 of 200 slots of Keypoint R-CNN and Panoptic FPN
  hold a detection scored below 1.2e-38 on the port's side only;
* bf16 (both sides float32 parameters, bf16 compute): the heads' outputs
  within one bf16 step (2^-7) of the scale, the bound of
  ``tests/test_torch_compute_dtype.py``'s heads (measured: RetinaNet's
  logits and deltas 1.3e-3 to 2.1e-3, the keypoint heatmaps 2.2e-3).

The whole models carry seeded numpy weights in the JAX package's layout
(``_random_variables``: traced, not compiled, so the JAX side compiles only
its forward); the heads start from the JAX package's initialisers. The port
runs on two intra-op threads here, as ``tests/test_torch_trainer.py`` sets
out.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jtsm_tpu.config import get_cfg as jax_get_cfg
from jtsm_tpu.data.catalog import MetadataCatalog as JaxMetadataCatalog
from jtsm_tpu.evaluation import COCOProposalEvaluator as JaxProposalEvaluator
from jtsm_tpu.evaluation.cocoeval import COCOEval as JaxCOCOEval
from jtsm_tpu.evaluation.cocoeval import oks_iou as jax_oks_iou
from jtsm_tpu.modeling import build_model as jax_build_model
from jtsm_tpu.modeling.anchor_generator import DefaultAnchorGenerator as JaxAnchorGenerator
from jtsm_tpu.modeling.backbone.fpn import LastLevelP6P7 as JaxLastLevelP6P7
from jtsm_tpu.modeling.meta_arch.retinanet import RetinaNetHead as JaxRetinaNetHead
from jtsm_tpu.modeling.roi_heads.keypoint_head import KRCNNConvDeconvUpsampleHead as JaxKeypointHead
from jtsm_tpu.structures.keypoints import heatmaps_to_keypoints as jax_heatmaps_to_keypoints
from jtsm_tpu_torch import config as port_config
from jtsm_tpu_torch.checkpoint import variables_to_state_dict
from jtsm_tpu_torch.config import get_cfg
from jtsm_tpu_torch.data import MetadataCatalog
from jtsm_tpu_torch.evaluation import COCOEval, COCOProposalEvaluator, oks_iou
from jtsm_tpu_torch.layers import ShapeSpec
from jtsm_tpu_torch.modeling import build_model
from jtsm_tpu_torch.modeling.anchor_generator import DefaultAnchorGenerator
from jtsm_tpu_torch.modeling.backbone import LastLevelP6P7
from jtsm_tpu_torch.modeling.meta_arch.retinanet import RetinaNetHead, retinanet_inference
from jtsm_tpu_torch.modeling.roi_heads.keypoint_head import KRCNNConvDeconvUpsampleHead
from jtsm_tpu_torch.ops.box_regression import Box2BoxTransform
from jtsm_tpu_torch.structures import heatmaps_to_keypoints
from tests.modeling.test_meta_archs import _fpn_tiny

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_REL = 1e-4  # of the JAX side's largest magnitude
TOL_PX = 1e-3
TOL_TIE = 1e-4  # of the scale: values this close may rank either way
BF16_STEP = 2.0**-7


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().float().numpy().astype(np.float64) if torch.is_tensor(x) else np.asarray(x, np.float64)


def _close(want, got, atol):
    want, got = _np(want), _np(got)
    assert want.shape == got.shape, (want.shape, got.shape)
    assert np.array_equal(np.isfinite(want), np.isfinite(got))
    fin = np.isfinite(want)
    gap = float(np.abs(want[fin] - got[fin]).max(initial=0.0))
    assert gap <= atol, (gap, atol)
    return gap


def _rel(want, got, tol=TOL_REL):
    scale = max(1.0, float(np.abs(_np(want)[np.isfinite(_np(want))]).max(initial=0.0)))
    return _close(want, got, tol * scale) / scale


def _batch(b=2, h=64, w=96, seed=0):
    rng = np.random.RandomState(seed)
    return {
        "image": (rng.rand(b, h, w, 3) * 255).astype(np.float32),
        "image_sizes": np.array([[h - 8, w - 20], [h, w]], np.int32)[:b],
        "orig_sizes": np.array([[2 * h, 2 * w], [h, w]], np.int32)[:b],
    }


def _tiny(arch):
    cfg = _fpn_tiny(jax_get_cfg())
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0  # random weights score below 0.05
    cfg.MODEL.RETINANET.SCORE_THRESH_TEST = 0.0
    if arch == "keypoint_rcnn":
        cfg.MODEL.KEYPOINT_ON = True
        cfg.MODEL.ROI_KEYPOINT_HEAD.CONV_DIMS = (32, 32)
    elif arch == "retinanet":
        cfg.MODEL.META_ARCHITECTURE = "RetinaNet"
        cfg.MODEL.BACKBONE.NAME = "build_retinanet_resnet_fpn_backbone"
        cfg.MODEL.RESNETS.OUT_FEATURES = ["res3", "res4", "res5"]
        cfg.MODEL.FPN.IN_FEATURES = ["res3", "res4", "res5"]
        cfg.MODEL.ANCHOR_GENERATOR.SIZES = [[s, s * 2 ** (1 / 3), s * 2 ** (2 / 3)] for s in (16, 32, 64, 128, 256)]
        cfg.MODEL.RETINANET.NUM_CONVS = 2
        cfg.MODEL.RETINANET.TOPK_CANDIDATES_TEST = 300
    elif arch == "proposal_network":
        cfg.MODEL.META_ARCHITECTURE = "ProposalNetwork"
    elif arch == "panoptic_fpn":
        cfg.MODEL.META_ARCHITECTURE = "PanopticFPN"
        cfg.MODEL.MASK_ON = True
    elif arch == "semantic_segmentor":
        cfg.MODEL.META_ARCHITECTURE = "SemanticSegmentor"
    return cfg


def _jax_init_apply(module, *args, seed=0, **kwargs):
    """``module``'s initial variables from ``seed`` and its outputs on
    ``args``, in one jitted call (one compilation), at matmul precision
    "highest"; the variables as numpy arrays."""

    def run(key):
        variables = module.init(key, *args, **kwargs)
        return variables, module.apply(variables, *args, **kwargs)

    with jax.default_matmul_precision("highest"):
        variables, out = jax.jit(run)(jax.random.key(seed))
    return jax.tree_util.tree_map(np.asarray, variables), out


def _random_variables(module, *args, seed=0, **kwargs):
    """Seeded numpy weights in the layout of ``module``'s variables (traced
    with ``jax.eval_shape``, so nothing is compiled): kernels normal with
    std 1/sqrt(fan-in); the box-regression outputs and the mask and sem-seg
    predictors std 0.001, as the JAX package initialises them (boxes stay
    near their anchors and proposals); biases and norm shifts small, norm
    scales and frozen statistics near identity."""
    shapes = jax.eval_shape(lambda k: module.init(k, *args, **kwargs), jax.random.key(0))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        names = [getattr(p, "key", str(p)) for p in path]
        shape = leaf.shape
        if names[-1] == "running_var":
            a = rng.uniform(0.5, 2.0, shape)
        elif names[-1] in ("scale", "weight"):
            a = rng.normal(1.0, 0.1, shape)
        elif names[-1] in ("bias", "running_mean"):
            a = rng.normal(0.0, 0.1, shape)
        elif any(n in ("anchor_deltas", "bbox_pred", "predictor") for n in names):
            a = rng.normal(0.0, 0.001, shape)
        else:
            a = rng.normal(0.0, 1.0 / np.sqrt(np.prod(shape[:-1])), shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_apply(module, variables, *args, **kwargs):
    with jax.default_matmul_precision("highest"):
        return jax.jit(lambda v, *a: module.apply(v, *a, **kwargs))(variables, *args)


def _models(cfg, batch, seed=0):
    """The JAX model's outputs and the port's model with the same seeded
    weights (``_random_variables``)."""
    jm = jax_build_model(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = _random_variables(jm, jb, seed=seed, train=False)
    want = _jax_apply(jm, variables, jb, train=False)
    tcfg = get_cfg()
    tcfg.merge_from_other_cfg(cfg)
    tm = build_model(tcfg, device="cpu")
    tm.load_state_dict(variables_to_state_dict(variables), strict=True)
    return {k: np.asarray(v) for k, v in want.items()}, tm


def _same_detections(want, got, score_tol=TOL_REL, upscale=1.0):
    """Validity and classes equal, boxes within 1e-3 px of the network's
    input (``upscale``: the largest original-to-input size ratio, which
    the boxes' rescale multiplies), scores within ``score_tol``."""
    # XLA's CPU flushes subnormal floats to zero: at SCORE_THRESH_TEST 0 a
    # class probability below float32's smallest normal is 0 there and
    # fails the threshold, while PyTorch keeps it (ROADMAP §3); such slots
    # hold a detection on the port's side only, in the last valid places
    g_scores = got["scores"].numpy()
    subnormal = got["valid"].numpy() & ~want["valid"] & (g_scores < np.finfo(np.float32).tiny)
    np.testing.assert_array_equal(got["valid"].numpy()[~subnormal], want["valid"][~subnormal])
    live = want["valid"]  # what a padded slot holds is arbitrary
    np.testing.assert_array_equal(got["classes"].numpy()[live], want["classes"][live])
    _close(want["boxes"][live], got["boxes"].numpy()[live], TOL_PX * upscale)
    _rel(want["scores"][live], g_scores[live], score_tol)
    return int(subnormal.sum())


def _same_keypoints(want, got):
    """x, y within 1e-3 px and logits and probabilities within 1e-4 of
    their scale, but at keypoints whose bins differ: there the two maxima
    (the JAX side's at its bin, the port's at another) must lie within 1e-4
    of the logits' scale, a near-tie of two bins. Returns how many moved."""
    want, got = np.asarray(want, np.float64), _np(got)
    moved = np.abs(want[..., :2] - got[..., :2]).max(-1) > TOL_PX
    scale = np.abs(want[..., 2]).max()
    assert np.abs(want[moved][:, 2] - got[moved][:, 2]).max(initial=0.0) <= TOL_TIE * scale
    _close(want[~moved][:, :2], got[~moved][:, :2], TOL_PX)
    _rel(want[~moved][:, 2:], got[~moved][:, 2:])
    return int(moved.sum())


def _same_sem_seg(want, got):
    _rel(want["sem_seg_logits"], got["sem_seg_logits"])
    differ = got["sem_seg"].numpy() != want["sem_seg"]
    if differ.any():  # only where the two largest logits nearly tie
        top2 = np.sort(want["sem_seg_logits"][differ], axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).max() <= TOL_TIE * np.abs(want["sem_seg_logits"]).max()


@pytest.mark.parametrize("arch", ["keypoint_rcnn", "retinanet", "proposal_network", "panoptic_fpn",
                                  "semantic_segmentor"])
def test_meta_arch_inference_matches_jax(arch):
    batch = _batch()
    want, tm = _models(_tiny(arch), batch)
    got = tm.inference(batch)
    assert sorted(got) == sorted(want)
    if arch == "proposal_network":
        # slots may trade places only at near-tied scores
        _rel(np.sort(want["scores"], -1), np.sort(got["scores"].numpy(), -1))
        order_w = np.argsort(-want["scores"], -1, kind="stable")
        order_g = np.argsort(-got["scores"].numpy(), -1, kind="stable")
        same = order_w == order_g
        scale = np.abs(want["scores"][np.isfinite(want["scores"])]).max()
        assert same.mean() > 0.9
        pw = np.take_along_axis(want["proposals"], order_w[..., None], 1)
        pg = np.take_along_axis(got["proposals"].numpy(), order_g[..., None], 1)
        _close(pw[same], pg[same], TOL_PX)
        sw = np.take_along_axis(want["scores"], order_w, 1)
        assert np.abs(np.diff(sw, axis=-1)[..., :][~same[..., 1:] | ~same[..., :-1]]).max(initial=0) <= TOL_TIE * scale
        return
    if arch == "semantic_segmentor":
        _same_sem_seg(want, got)
        return
    # the first image is rescaled 2x; at most 12 of 200 slots subnormal
    assert _same_detections(want, got, upscale=2.0) <= 12
    assert got["valid"].any()
    live = want["valid"]
    if arch == "keypoint_rcnn":
        assert got["keypoints"].shape == (2, 100, 17, 4)
        assert _same_keypoints(want["keypoints"][live], got["keypoints"].numpy()[live]) <= 2
    if arch == "panoptic_fpn":
        _rel(want["masks"][live], got["masks"].numpy()[live])
        _same_sem_seg(want, got)
        assert got["sem_seg_logits"].shape == (2, 64, 96, 4)


def test_last_level_p6p7_matches_jax():
    rng = np.random.RandomState(1)
    res5 = rng.randn(2, 5, 7, 48).astype(np.float32)
    variables, want = _jax_init_apply(JaxLastLevelP6P7(out_channels=16), jnp.asarray(res5), seed=2)
    top = LastLevelP6P7(48, 16)
    top.load_state_dict(variables_to_state_dict(variables), strict=True)
    got = top(torch.from_numpy(res5).permute(0, 3, 1, 2))
    assert [tuple(g.shape) for g in got] == [(2, 16, 3, 4), (2, 16, 2, 2)]
    for w, g in zip(want, got):
        _rel(w, g.permute(0, 2, 3, 1))


def test_anchors_of_several_sizes_match_jax():
    sizes = [[s, s * 2 ** (1 / 3), s * 2 ** (2 / 3)] for s in (32, 64)]
    ratios = [[0.5, 1.0, 2.0]]
    want = JaxAnchorGenerator(sizes=sizes, aspect_ratios=ratios, strides=[8, 16])([(5, 7), (3, 4)])
    got = DefaultAnchorGenerator(sizes, ratios, [8, 16])([(5, 7), (3, 4)], "cpu")
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # cell order: size-major, then ratio, so a flat index // K is the anchor
    assert got[0].shape == (5 * 7 * 9, 4)


def _decode_inputs(seed, hw, a, k, tied):
    rng = np.random.RandomState(seed)
    logits, deltas = [], []
    for h, w in hw:
        if tied:  # few distinct logits: long runs of equal scores
            lg = rng.randint(-2, 4, (2, h, w, a * k)).astype(np.float32) * 0.5
        else:
            lg = rng.randn(2, h, w, a * k).astype(np.float32)
        logits.append(lg)
        deltas.append((rng.randn(2, h, w, a * 4) * 0.2).astype(np.float32))
    strides = [8 * 2**i for i in range(len(hw))]
    sizes = [[4 * s * 2 ** (i / 3) for i in range(a // 3)] for s in strides]
    return logits, deltas, strides, sizes


@pytest.mark.parametrize("case", ["tied_scores", "over_1024_candidates"])
def test_retinanet_decode_matches_jax(case):
    """The decode alone on seeded head outputs: runs of exactly tied scores
    (ranked by index on both sides), and 5 x 1000 candidates cut to the
    1024 the JAX package gives its NMS."""
    tied = case == "tied_scores"
    hw = [(12, 16), (6, 8), (3, 4)] if tied else [(20, 28), (10, 14), (5, 7), (3, 4), (2, 2)]
    k, a = 5, 9
    logits, deltas, strides, sizes = _decode_inputs(3, hw, a, k, tied)
    cfg = _tiny("retinanet")
    cfg.MODEL.RETINANET.SCORE_THRESH_TEST = 0.3
    cfg.MODEL.RETINANET.TOPK_CANDIDATES_TEST = 200 if tied else 1000
    cfg.MODEL.RETINANET.NUM_CLASSES = k
    jm = jax_build_model(cfg)
    anchors = JaxAnchorGenerator(sizes=sizes, aspect_ratios=[[0.5, 1.0, 2.0]], strides=strides)(hw)
    image_sizes = jnp.asarray([[96, 128], [96, 128]], jnp.int32)
    want = jax.jit(jm._inference)(anchors, [jnp.asarray(lg.reshape(2, -1, k)) for lg in logits],
                                  [jnp.asarray(d.reshape(2, -1, 4)) for d in deltas], image_sizes)
    got = retinanet_inference(
        [torch.from_numpy(np.asarray(x)) for x in anchors],
        [torch.from_numpy(lg).permute(0, 3, 1, 2) for lg in logits],
        [torch.from_numpy(d).permute(0, 3, 1, 2) for d in deltas],
        Box2BoxTransform(cfg.MODEL.RETINANET.BBOX_REG_WEIGHTS), k, cfg.MODEL.RETINANET.TOPK_CANDIDATES_TEST,
        0.3, 0.5, 100,
    )
    want = {kk: np.asarray(v) for kk, v in want.items()}
    _same_detections(want, got)
    assert got["valid"].sum() > 50
    if tied:
        assert len(np.unique(want["scores"][want["valid"]])) < 10
    else:
        assert sum(min(1000, h * w * a * k) for h, w in hw) > 1024


@pytest.mark.parametrize("s", [7, 14])
def test_keypoint_head_matches_jax(s):
    """The conv stack, the 4x4/2 transposed convolution (flax's kernel
    mirrored into torch's) and the 2x bilinear upsample, at an odd and an
    even pooled size."""
    rng = np.random.RandomState(s)
    x = rng.randn(3, s, s, 16).astype(np.float32)
    jm = JaxKeypointHead(num_keypoints=17, conv_dims=(24, 24))

    def run(key):
        variables = jm.init(key, jnp.asarray(x))
        # random biases too, so that a bias mapped wrongly shows
        variables = jax.tree_util.tree_map(lambda v: v + 0.1 * jax.random.normal(jax.random.key(1), v.shape),
                                           variables)
        return variables, jm.apply(variables, jnp.asarray(x))

    with jax.default_matmul_precision("highest"):
        variables, want = jax.jit(run)(jax.random.key(s))
    want = np.asarray(want)
    head = KRCNNConvDeconvUpsampleHead(ShapeSpec(channels=16), 17, (24, 24))
    head.load_state_dict(variables_to_state_dict(jax.tree_util.tree_map(np.asarray, variables)), strict=True)
    got = head(torch.from_numpy(x))
    assert got.shape == (3, 17, 4 * s, 4 * s) and got.dtype == torch.float32
    _rel(want.transpose(0, 3, 1, 2), got)


def test_heatmaps_to_keypoints_matches_jax():
    """First maximum on the raw grid, half-bin offsets, the logit and the
    softmax probability there; maps with exact ties take the first."""
    rng = np.random.RandomState(4)
    maps = rng.randn(6, 17, 56, 56).astype(np.float32)
    maps[0, 0] = 0.0
    maps[1, :, 10, 20] = maps[1, :, 30, 5] = 50.0  # two equal maxima: the first, row-major
    rois = np.array([[10, 20, 60, 90], [0, 0, 0.5, 0.5], [5.5, 3.25, 200, 101], [1, 1, 2, 30],
                     [-10, -10, 40, 40], [3, 4, 5, 6]], np.float32)
    want = np.asarray(jax_heatmaps_to_keypoints(jnp.asarray(maps), jnp.asarray(rois)))
    got = heatmaps_to_keypoints(torch.from_numpy(maps), torch.from_numpy(rois))
    _close(want[..., :2], got[..., :2], TOL_PX)
    _rel(want[..., 2:], got[..., 2:])
    assert got[1, :, 0].tolist() == pytest.approx([(20.5) * 1.0 / 56] * 17, abs=1e-6)  # width taken as 1


def _keypoint_scenes(seed):
    """A person keypoint COCO dict with seeded boxes and keypoints (some
    unlabelled, one ground truth without any) and detections near them."""
    rng = np.random.RandomState(seed)
    images, anns, dets = [], [], []
    for img_id in range(4):
        images.append({"id": img_id, "height": 200, "width": 300})
        for _ in range(3):
            x, y = rng.uniform(0, 150), rng.uniform(0, 100)
            bw, bh = rng.uniform(20, 140), rng.uniform(20, 90)
            kp = np.stack([x + rng.uniform(0, bw, 17), y + rng.uniform(0, bh, 17), rng.choice([0, 1, 2], 17)], 1)
            if len(anns) == 4:
                kp[:, 2] = 0
            anns.append({"id": len(anns) + 1, "image_id": img_id, "category_id": 1, "bbox": [x, y, bw, bh],
                         "area": bw * bh, "iscrowd": 0, "keypoints": kp.reshape(-1).tolist(),
                         "num_keypoints": int((kp[:, 2] > 0).sum())})
            for _ in range(2):
                dk = kp.copy()
                dk[:, :2] += rng.randn(17, 2) * rng.uniform(1, 15)
                dk[:, 2] = 2
                dets.append({"image_id": img_id, "category_id": 1, "bbox": [x, y, bw, bh],
                             "score": float(rng.uniform()), "keypoints": dk.reshape(-1).tolist()})
    gt = {"images": images, "annotations": anns, "categories": [{"id": 1, "name": "person"}]}
    return gt, dets


def test_oks_iou_matches_jax():
    gt, dets = _keypoint_scenes(5)
    sigmas = np.linspace(0.02, 0.1, 17)
    for s in (None, sigmas):
        want = jax_oks_iou([d["keypoints"] for d in dets], None, gt["annotations"], sigmas=s)
        got = oks_iou([d["keypoints"] for d in dets], gt["annotations"], s)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert 0 < got.max() <= 1


def test_keypoint_ap_matches_jax():
    gt, dets = _keypoint_scenes(6)
    want = JaxCOCOEval(gt, "keypoints", use_native=False).evaluate(dets)
    got = COCOEval(gt, "keypoints").evaluate(dets)
    assert list(got) == list(want) == ["AP", "AP50", "AP75", "APm", "APl", "AR", "AR50", "AR75", "ARm", "ARl"]
    np.testing.assert_allclose([got[k] for k in got], [want[k] for k in want], rtol=0, atol=1e-12)
    assert 0 < got["AP"] < 1


def test_proposal_evaluator_matches_jax(tmp_path):
    """AR@100 and AR@1000 of seeded proposals (padding at -inf) against a
    COCO json with a crowd, through both packages' evaluators."""
    rng = np.random.RandomState(7)
    images, anns = [], []
    for img_id in range(3):
        images.append({"id": img_id, "height": 240, "width": 320})
        for j in range(5):
            x, y, bw, bh = rng.uniform(0, 200), rng.uniform(0, 150), rng.uniform(10, 100), rng.uniform(10, 80)
            anns.append({"id": len(anns) + 1, "image_id": img_id, "category_id": 1, "bbox": [x, y, bw, bh],
                         "area": bw * bh, "iscrowd": int(j == 4)})
    path = tmp_path / "gt.json"
    path.write_text(json.dumps({"images": images, "annotations": anns, "categories": [{"id": 1, "name": "a"}]}))
    name = "torch_meta_archs_proposals"
    JaxMetadataCatalog.get(name).set(json_file=str(path))
    MetadataCatalog.get(name).set(json_file=str(path))
    gts = np.array([a["bbox"] for a in anns], np.float32).reshape(3, 5, 4)
    gts[..., 2:] += gts[..., :2]
    boxes = np.concatenate([gts[:, rng.randint(0, 5, 1200)] + rng.randn(3, 1200, 4).astype(np.float32) * 6], 1)
    scores = rng.randn(3, 1200).astype(np.float32)
    scores[:, 1100:] = -np.inf
    inputs = {"image_ids": np.arange(3)}
    results = []
    for ev in (JaxProposalEvaluator(name), COCOProposalEvaluator(name)):
        ev.reset()
        ev.process(inputs, {"proposals": boxes, "scores": scores})
        results.append(ev.evaluate())
    assert results[1] == results[0]
    assert set(results[1]["box_proposals"]) == {"AR@100", "AR@1000"}


BUILDERS = [
    ("panoptic_fpn_R_50_cfg", "configs/COCO-PanopticSegmentation/panoptic_fpn_R_50_1x.yaml"),
    ("retinanet_R_50_FPN_cfg", "configs/COCO-Detection/retinanet_R_50_FPN_1x.yaml"),
    ("rpn_R_50_FPN_cfg", "configs/COCO-Detection/rpn_R_50_FPN_1x.yaml"),
    ("keypoint_rcnn_R_50_FPN_cfg", "configs/COCO-Keypoints/keypoint_rcnn_R_50_FPN_1x.yaml"),
    ("panoptic_fpn_gate_cfg", "configs/quick_schedules/panoptic_fpn_R_18_synthetic_inference_acc_test.yaml"),
    ("retinanet_gate_cfg", "configs/quick_schedules/retinanet_R_18_synthetic_inference_acc_test.yaml"),
    ("rpn_gate_cfg", "configs/quick_schedules/rpn_R_18_synthetic_inference_acc_test.yaml"),
    ("keypoint_rcnn_gate_cfg", "configs/quick_schedules/keypoint_rcnn_R_18_synthetic_inference_acc_test.yaml"),
]


@pytest.mark.parametrize("builder,path", BUILDERS, ids=[b for b, _ in BUILDERS])
def test_python_config_equals_merged_yaml(builder, path):
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, path))
    assert getattr(port_config, builder)().to_dict() == cfg.to_dict()
    jcfg = jax_get_cfg()  # and the port's defaults are the JAX package's, but for the device
    jcfg.merge_from_file(os.path.join(ROOT, path))
    jcfg.MODEL.DEVICE = "cuda"
    assert jcfg.to_dict() == cfg.to_dict()


@pytest.mark.parametrize("head", ["retinanet", "keypoint"])
def test_bf16_heads_match_jax(head):
    """Both packages' heads in bf16 over float32 parameters, from the same
    weights and inputs: within one bf16 step of the outputs' scale, and the
    port's bf16 head apart from its float32 one (it does compute in bf16)."""
    rng = np.random.RandomState(8)
    if head == "retinanet":
        feats = [rng.randn(2, h, w, 32).astype(np.float32) for h, w in ((8, 12), (4, 6))]
        jm = JaxRetinaNetHead(num_classes=5, num_anchors=9, num_convs=2, in_channels=32, dtype=jnp.bfloat16)
        variables, want = _jax_init_apply(jm, [jnp.asarray(f) for f in feats])
        state = {k[len("head."):]: v for k, v in variables_to_state_dict({"params": {"head": variables["params"]}}).items()}
        outs = {}
        for dt in (torch.bfloat16, torch.float32):
            pm = RetinaNetHead(32, 5, 9, 2, compute_dtype=dt)
            pm.load_state_dict(state, strict=True)
            logits, deltas = pm([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
            outs[dt] = [t.permute(0, 2, 3, 1) for t in logits + deltas]
        pairs = list(zip([w for part in want for w in part], outs[torch.bfloat16], outs[torch.float32]))
    else:
        x = rng.randn(4, 14, 14, 32).astype(np.float32)
        jm = JaxKeypointHead(num_keypoints=17, conv_dims=(32, 32), dtype=jnp.bfloat16)
        variables, want = _jax_init_apply(jm, jnp.asarray(x))
        state = variables_to_state_dict(variables)
        outs = {}
        for dt in (torch.bfloat16, torch.float32):
            pm = KRCNNConvDeconvUpsampleHead(ShapeSpec(channels=32), 17, (32, 32), dt)
            pm.load_state_dict(state, strict=True)
            outs[dt] = pm(torch.from_numpy(x)).permute(0, 2, 3, 1)
        pairs = [(want, outs[torch.bfloat16], outs[torch.float32])]
    for w, g16, g32 in pairs:
        w = _np(jnp.asarray(w, jnp.float32))
        assert g16.dtype == torch.float32  # handed on in float32, computed in bf16
        scale = np.abs(w).max()
        gap16 = np.abs(w - _np(g16)).max() / scale
        assert gap16 <= BF16_STEP, gap16
        assert np.abs(_np(g16) - _np(g32)).max() > 0
