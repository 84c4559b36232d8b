"""The rotated family's structures and ops in the port held against the JAX
package on the CPU, on the same seeded numpy inputs: ``pairwise_iou_rotated``
(the cases of ``tests/structures/test_rotated_boxes.py``: axis-aligned, 90
degrees, 45 degrees, a box against itself at any angle, disjoint),
``RotatedBoxes``, ``Box2BoxTransformRotated``, the four rotated NMS
functions, ``roi_align_rotated`` and ``RotatedAnchorGenerator``
(``tests/test_torch_rotated_model.py`` holds the modules and the model).

Tolerances (float32 on both sides; the largest gap measured on the CPU in
brackets):

* the IoU within 1e-5 absolute (3.0e-7: the port rounds as XLA's fused
  multiply-adds and its sums do, ``structures/rotated_boxes.py``);
* NMS: the kept sets identical;
* ``roi_align_rotated`` within 1e-5 absolute in float32 (4.6e-6 on values up
  to 2.6), and within 2**-7 absolute in bfloat16 (3.9e-3, one bfloat16 step
  at 1: the blend rounds in bfloat16 on both sides, in different orders),
  its features' gradient within 1e-5 of the JAX one's scale (2.0e-6);
* the codec within 1e-5 relative, the anchors equal.
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jtsm_tpu.modeling.anchor_generator import RotatedAnchorGenerator as JaxRotatedAnchorGenerator
from jtsm_tpu.ops.box_regression import Box2BoxTransformRotated as JaxBox2BoxTransformRotated
from jtsm_tpu.structures.rotated_boxes import RotatedBoxes as JaxRotatedBoxes
from jtsm_tpu.structures.rotated_boxes import pairwise_iou_rotated as jax_iou
from jtsm_tpu_torch.config import rotated_faster_rcnn_R_50_cfg
from jtsm_tpu_torch.layers import ROIAlignRotated, batched_nms_rotated, nms_rotated, roi_align_rotated
from jtsm_tpu_torch.modeling.anchor_generator import RotatedAnchorGenerator
from jtsm_tpu_torch.ops.box_regression import Box2BoxTransformRotated
from jtsm_tpu_torch.ops.nms import batched_nms_rotated_mask, nms_rotated_mask
from jtsm_tpu_torch.ops.roi_align_rotated import roi_align_rotated_batched
from jtsm_tpu_torch.structures import RotatedBoxes, pairwise_iou_rotated
from tests.test_torch_c4 import _rel

jax_nms = importlib.import_module("jtsm_tpu.ops.nms")
jax_roi_align_rotated = importlib.import_module("jtsm_tpu.ops.roi_align_rotated")

TOL_IOU = 1e-5
TOL_F32 = 1e-5
TOL_BF16 = 2.0 ** -7


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def random_boxes(rng, n, extent=100.0, sides=(5.0, 40.0)):
    b = np.zeros((n, 5), np.float32)
    b[:, :2] = rng.uniform(0, extent, (n, 2))
    b[:, 2:4] = rng.uniform(*sides, (n, 2))
    b[:, 4] = rng.uniform(-180, 180, n)
    return b


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- structures ------------------------------------------------------------------------


def test_pairwise_iou_rotated_as_jax():
    rng = np.random.default_rng(0)
    a, b = random_boxes(rng, 300), random_boxes(rng, 200)
    b[:10] = a[:10]  # a box against itself
    b[10:20] = a[10:20]
    b[10:20, 4] += 90  # and turned by 90 degrees
    a[20:30, 4], b[20:30, 4] = 0.0, 0.0  # axis-aligned
    a[30:40, 4] = 45.0
    b[40:50, :2] = a[40:50, :2] + 500.0  # disjoint
    want = np.asarray(jax.jit(jax_iou)(a, b))
    got = pairwise_iou_rotated(t(a), t(b)).numpy()
    err = float(np.abs(want - got).max())
    print("iou max_abs_err", err)
    assert err <= TOL_IOU and (want > 0).mean() > 0.1
    assert (got[40:50, 40:50] == 0).all()
    # leading dimensions broadcast: (2, N, 5) against (M, 5)
    stacked = pairwise_iou_rotated(t(np.stack([a[:50], a[50:100]])), t(b[:30])).numpy()
    np.testing.assert_array_equal(stacked, np.stack([got[:50, :30], got[50:100, :30]]))


@pytest.mark.parametrize("case", ["axis_aligned", "identical_any_angle", "90deg_swap", "45deg", "disjoint"])
def test_pairwise_iou_rotated_cases_as_jax(case):
    """The cases of ``tests/structures/test_rotated_boxes.py``."""
    if case == "axis_aligned":
        b1 = np.array([[10, 10, 8, 6, 0], [30, 30, 10, 10, 0]], np.float32)
        b2 = np.array([[12, 10, 8, 6, 0], [20, 20, 4, 4, 0], [30, 32, 10, 6, 0]], np.float32)
    elif case == "identical_any_angle":
        b1 = np.array([[50, 40, 20, 10, a] for a in range(-180, 181, 15)], np.float32)
        b2 = b1
    elif case == "90deg_swap":
        b1 = np.array([[20, 20, 10, 4, 0]], np.float32)
        b2 = np.array([[20, 20, 4, 10, 90]], np.float32)
    elif case == "45deg":
        b1 = np.array([[0, 0, 1, 1, 0]], np.float32)
        b2 = np.array([[0, 0, 1, 1, 45]], np.float32)
    else:
        b1 = np.array([[0, 0, 2, 2, 30]], np.float32)
        b2 = np.array([[100, 100, 2, 2, -10]], np.float32)
    want = np.asarray(jax.jit(jax_iou)(b1, b2))
    got = pairwise_iou_rotated(t(b1), t(b2)).numpy()
    assert np.abs(want - got).max() <= TOL_IOU, (case, want, got)
    if case == "identical_any_angle":
        assert np.abs(np.diag(got) - 1.0).max() < 1e-4
    if case == "45deg":
        inter = 2 * (math.sqrt(2) - 1)  # a regular octagon
        assert abs(got[0, 0] - inter / (2 - inter)) < 1e-3
    if case == "disjoint":
        assert got[0, 0] == 0.0


def test_rotated_boxes_methods_as_jax():
    rng = np.random.default_rng(1)
    raw = random_boxes(rng, 40, extent=120.0)
    raw[:10, 4] = rng.uniform(-1, 1, 10)  # nearly axis-aligned: these clip
    raw[10:15, 2] = 0.0  # empty
    raw[15:20, :2] = -20.0  # outside
    jb, tb = JaxRotatedBoxes(jnp.asarray(raw)), RotatedBoxes(t(raw))

    def same(want, got, tol=1e-5):
        want = np.asarray(want.tensor if isinstance(want, JaxRotatedBoxes) else want)
        got = (got.tensor if isinstance(got, RotatedBoxes) else got).numpy()
        assert want.shape == got.shape and want.dtype == got.dtype
        if want.dtype == bool:
            np.testing.assert_array_equal(got, want)
        else:
            assert _rel(want, got) <= tol

    same(jb.area(), tb.area())
    same(jb.normalize_angles(), tb.normalize_angles())
    same(jb.clip((100, 90)), tb.clip((100, 90)))
    same(jb.nonempty(), tb.nonempty())
    same(jb.inside_box((100, 90), 5.0), tb.inside_box((100, 90), 5.0))
    same(jb.get_centers(), tb.get_centers())
    same(jb.scale(1.5, 0.75), tb.scale(1.5, 0.75))
    same(JaxRotatedBoxes.cat([jb[3], jb[5:9]]), RotatedBoxes.cat([tb[3], tb[5:9]]))
    assert len(tb) == 40 and len(RotatedBoxes(torch.zeros(0))) == 0 and len(RotatedBoxes.cat([])) == 0


def test_box2box_transform_rotated_as_jax():
    rng = np.random.default_rng(2)
    src, tgt = random_boxes(rng, 500), random_boxes(rng, 500)
    deltas = rng.normal(0, 1, (500, 5)).astype(np.float32)
    deltas[:5, 2:4] = 10.0  # past the scale clamp
    for weights in ((1.0, 1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0, 1.0)):
        jt, tt = JaxBox2BoxTransformRotated(weights), Box2BoxTransformRotated(weights)
        assert _rel(np.asarray(jt.get_deltas(jnp.asarray(src), jnp.asarray(tgt))),
                    tt.get_deltas(t(src), t(tgt)).numpy()) <= TOL_F32
        want = np.asarray(jt.apply_deltas(jnp.asarray(deltas), jnp.asarray(src)))
        got = tt.apply_deltas(t(deltas), t(src)).numpy()
        assert _rel(want, got) <= TOL_F32
        assert (got[:, 4] >= -180).all() and (got[:, 4] < 180).all()
        back = tt.apply_deltas(tt.get_deltas(t(src), t(tgt)), t(src)).numpy()
        np.testing.assert_allclose(back[:, :4], tgt[:, :4], rtol=1e-4, atol=1e-3)


# -- NMS -------------------------------------------------------------------------------

NMS_N = 250
# jitted as the models run them (XLA fuses, and contracts into multiply-adds,
# only under jit), once for every seed
JAX_NMS = {
    "nms_rotated_mask": jax.jit(lambda b, s: jax_nms.nms_rotated_mask(b, s, 0.5)),
    "batched_nms_rotated_mask": jax.jit(lambda b, s, i: jax_nms.batched_nms_rotated_mask(b, s, i, 0.3)),
    "nms_rotated": jax.jit(lambda b, s: jax_nms.nms_rotated(b, s, 0.7, 50)),
    "batched_nms_rotated": jax.jit(lambda b, s, i: jax_nms.batched_nms_rotated(b, s, i, 0.5, NMS_N + 5)),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rotated_nms_keeps_as_jax(seed):
    """The four rotated NMS functions keep the JAX package's sets: crowded
    boxes, a tenth of the scores -inf, tied scores, 80 classes for the
    batched forms (class offsets near 1e5 px)."""
    rng = np.random.default_rng(seed)
    n = NMS_N
    boxes = random_boxes(rng, n, extent=300.0, sides=(10.0, 80.0))
    scores = rng.uniform(size=n).astype(np.float32)
    scores[rng.uniform(size=n) < 0.1] = -np.inf
    scores[50:60] = scores[40]  # ties rank by index
    idxs = rng.integers(0, 80, n).astype(np.int32)
    jb, js, ji = jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(idxs)
    checks = {
        "nms_rotated_mask": (JAX_NMS["nms_rotated_mask"](jb, js), nms_rotated_mask(t(boxes), t(scores), 0.5)),
        "batched_nms_rotated_mask": (JAX_NMS["batched_nms_rotated_mask"](jb, js, ji),
                                     batched_nms_rotated_mask(t(boxes), t(scores), t(idxs), 0.3)),
        "nms_rotated": (JAX_NMS["nms_rotated"](jb, js), nms_rotated(t(boxes), t(scores), 0.7, 50)),
        "batched_nms_rotated": (JAX_NMS["batched_nms_rotated"](jb, js, ji),
                                batched_nms_rotated(t(boxes), t(scores), t(idxs), 0.5, NMS_N + 5)),
    }
    for name, (want, got) in checks.items():
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
    kept = checks["nms_rotated_mask"][1]
    assert 0 < int(kept.sum()) < int(np.isfinite(scores).sum())
    # leading batch dimensions are independent problems
    other = random_boxes(rng, n, extent=300.0, sides=(10.0, 80.0))
    two = nms_rotated_mask(t(np.stack([boxes, other])), t(np.stack([scores, scores])), 0.5)
    np.testing.assert_array_equal(two[0].numpy(), kept.numpy())
    np.testing.assert_array_equal(two[1].numpy(), nms_rotated_mask(t(other), t(scores), 0.5).numpy())


# -- rotated ROIAlign ------------------------------------------------------------------


def _roi_inputs(seed=0, r=60):
    rng = np.random.default_rng(seed)
    feat = rng.normal(size=(2, 24, 30, 16)).astype(np.float32)
    boxes = np.zeros((r, 5), np.float32)
    boxes[:, 0] = rng.uniform(-20, 500, r)
    boxes[:, 1] = rng.uniform(-20, 400, r)
    boxes[:, 2:4] = rng.uniform(8, 300, (r, 2))
    boxes[:, 4] = rng.uniform(-180, 180, r)
    boxes[:5, 4], boxes[5:10, 4] = 0.0, 90.0
    return feat, boxes, rng.integers(0, 2, r).astype(np.int32)


def test_roi_align_rotated_as_jax():
    feat, boxes, bidx = _roi_inputs()
    pool = jax.jit(lambda f, b, i: jax_roi_align_rotated.roi_align_rotated_batched(f, b, i, 7, 1 / 16, 2))
    want = np.asarray(pool(feat, boxes, bidx))
    got = roi_align_rotated_batched(t(feat), t(boxes), t(bidx), 7, 1 / 16, 2).numpy()
    err = float(np.abs(want - got).max())
    print("f32", err, float(np.abs(want).max()))
    assert err <= TOL_F32
    want16 = np.asarray(pool(jnp.asarray(feat, jnp.bfloat16), boxes, bidx)).astype(np.float32)
    got16 = roi_align_rotated_batched(t(feat).bfloat16(), t(boxes), t(bidx), 7, 1 / 16, 2)
    assert got16.dtype == torch.bfloat16
    err16 = float(np.abs(want16 - got16.float().numpy()).max())
    print("bf16", err16)
    assert err16 <= TOL_BF16
    # the functional alias and the module form, rois (batch, cx, cy, w, h, angle)
    rois = np.concatenate([bidx[:, None].astype(np.float32), boxes], 1)
    np.testing.assert_array_equal(ROIAlignRotated(7, 1 / 16, 2)(t(feat), t(rois)).numpy(), got)
    np.testing.assert_array_equal(roi_align_rotated(t(feat), t(boxes), t(bidx), 7, 1 / 16, 2).numpy(), got)
    assert "sampling_ratio=2" in repr(ROIAlignRotated((7, 7), 0.5))


def test_roi_align_rotated_gradient_as_jax():
    feat, boxes, bidx = _roi_inputs(1, r=20)
    cot = np.random.default_rng(5).normal(size=(20, 5, 5, 16)).astype(np.float32)
    want = np.asarray(jax.grad(lambda f: jnp.sum(jax_roi_align_rotated.roi_align_rotated_batched(
        f, boxes, bidx, 5, 1 / 8, 2) * cot))(feat))
    f = t(feat).requires_grad_()
    (roi_align_rotated_batched(f, t(boxes), t(bidx), 5, 1 / 8, 2) * t(cot)).sum().backward()
    err = _rel(want, f.grad.numpy())
    print("gradient", err)
    assert err <= TOL_F32


# -- anchors ---------------------------------------------------------------------------


def test_rotated_anchor_generator_as_jax():
    """The full-width configuration's generator: 45 anchors a cell, 189000
    over an 800x1344 image's 50x84 res4."""
    cfg = rotated_faster_rcnn_R_50_cfg()
    kw = dict(sizes=cfg.MODEL.ANCHOR_GENERATOR.SIZES, aspect_ratios=cfg.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS,
              strides=[16], angles=cfg.MODEL.ANCHOR_GENERATOR.ANGLES)
    jg, tg = JaxRotatedAnchorGenerator(**kw), RotatedAnchorGenerator(**kw)
    assert jg.num_anchors == tg.num_anchors == [45]
    want = np.asarray(jg([(50, 84)])[0])
    got = tg([(50, 84)], "cpu")[0].numpy()
    assert got.shape == (189000, 5)
    np.testing.assert_array_equal(got, want)
