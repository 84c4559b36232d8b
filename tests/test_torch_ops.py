"""The port's box ops, NMS and ROIAlign held against the JAX package on the
CPU, on the same numpy inputs.

Tolerances: NMS keep-masks and level assignments must be equal. Float
outputs are float32 on both sides with JAX's matmul precision at "highest";
the two frameworks round some operations differently, so they agree to a
few float32 ulps of the output's scale: atol 2e-5 relative to that scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jtsm_tpu.modeling.poolers import assign_boxes_to_levels as jax_assign_levels
from jtsm_tpu.ops.box_regression import Box2BoxTransform as JaxBox2BoxTransform
from jtsm_tpu.ops.nms import batched_nms_mask as jax_batched_nms_mask
from jtsm_tpu.ops.nms import nms_mask as jax_nms_mask
from jtsm_tpu.ops.roi_align import roi_align_batched as jax_roi_align_batched
from jtsm_tpu.ops.roi_align import roi_align_multilevel as jax_roi_align_multilevel
from jtsm_tpu.structures.boxes import clip_boxes as jax_clip_boxes
from jtsm_tpu.structures.boxes import nonempty_boxes as jax_nonempty_boxes
from jtsm_tpu.structures.boxes import pairwise_iou as jax_pairwise_iou
from jtsm_tpu_torch.modeling.poolers import assign_boxes_to_levels
from jtsm_tpu_torch.ops import nms, roi_align
from jtsm_tpu_torch.ops.box_regression import Box2BoxTransform
from jtsm_tpu_torch.structures import boxes


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this file runs, as the other port test
    files have: at one a core, PyTorch's pools spin under the parallel
    tier-1 run and slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(a, b, rel=2e-5):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(1.0, float(np.abs(a).max(initial=0.0)))
    np.testing.assert_allclose(b, a, rtol=0, atol=rel * scale)


def _random_boxes(rng, n, extent=100.0, size=40.0):
    xy = rng.rand(n, 2) * extent
    wh = rng.rand(n, 2) * size + 1.0
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


@pytest.mark.parametrize(
    "n,thresh,pad_frac,tie_frac",
    [(40, 0.5, 0.0, 0.0), (100, 0.7, 0.2, 0.3), (300, 0.5, 0.1, 0.2), (129, 0.3, 0.5, 0.5)],
)
def test_nms_mask_matches_jax(n, thresh, pad_frac, tie_frac):
    rng = np.random.RandomState(n)
    b = _random_boxes(rng, n)
    s = rng.rand(n).astype(np.float32)
    # ties: copy scores (and some boxes) onto later entries
    ties = rng.rand(n) < tie_frac
    s[ties] = s[0]
    b[ties & (rng.rand(n) < 0.5)] = b[0]
    s[rng.rand(n) < pad_frac] = -np.inf
    want = np.asarray(jax_nms_mask(jnp.asarray(b), jnp.asarray(s), thresh))
    got = nms.nms_mask(torch.from_numpy(b), torch.from_numpy(s), thresh).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0
    assert not got[~np.isfinite(s)].any()


def test_nms_mask_batched_dims_are_independent():
    rng = np.random.RandomState(7)
    b = np.stack([_random_boxes(rng, 150) for _ in range(6)]).reshape(2, 3, 150, 4)
    s = rng.rand(2, 3, 150).astype(np.float32)
    s[..., 140:] = -np.inf
    got = nms.nms_mask(torch.from_numpy(b), torch.from_numpy(s), 0.6).numpy()
    for i in range(2):
        for j in range(3):
            want = np.asarray(jax_nms_mask(jnp.asarray(b[i, j]), jnp.asarray(s[i, j]), 0.6))
            np.testing.assert_array_equal(got[i, j], want)


@pytest.mark.parametrize("n", [60, 400])
def test_batched_nms_mask_matches_jax(n):
    rng = np.random.RandomState(n + 1)
    b = _random_boxes(rng, n, extent=60.0)
    s = rng.rand(n).astype(np.float32)
    s[rng.rand(n) < 0.15] = -np.inf
    cls = rng.randint(0, 4, n).astype(np.int32)
    want = np.asarray(
        jax_batched_nms_mask(jnp.asarray(b), jnp.asarray(s), jnp.asarray(cls), 0.5)
    )
    got = nms.batched_nms_mask(
        torch.from_numpy(b), torch.from_numpy(s), torch.from_numpy(cls), 0.5
    ).numpy()
    np.testing.assert_array_equal(got, want)


def test_box_ops_match_jax():
    rng = np.random.RandomState(3)
    a = _random_boxes(rng, 30, extent=80.0) - 10.0
    c = _random_boxes(rng, 20)
    _close(jax_pairwise_iou(jnp.asarray(a), jnp.asarray(c)),
           boxes.pairwise_iou(torch.from_numpy(a), torch.from_numpy(c)))
    _close(jax_clip_boxes(jnp.asarray(a), (50, 70)),
           boxes.clip_boxes(torch.from_numpy(a), (50, 70)))
    np.testing.assert_array_equal(
        np.asarray(jax_nonempty_boxes(jnp.asarray(a), 20.0)),
        boxes.nonempty_boxes(torch.from_numpy(a), 20.0).numpy(),
    )


def test_box2box_transform_matches_jax():
    rng = np.random.RandomState(4)
    src = _random_boxes(rng, 50)
    tgt = _random_boxes(rng, 50)
    deltas = (rng.randn(50, 12) * 3).astype(np.float32)  # large dw/dh hit the clamp
    w = (10.0, 10.0, 5.0, 5.0)
    jt = JaxBox2BoxTransform(w)
    tt = Box2BoxTransform(w)
    _close(jt.get_deltas(jnp.asarray(src), jnp.asarray(tgt)),
           tt.get_deltas(torch.from_numpy(src), torch.from_numpy(tgt)))
    _close(jt.apply_deltas(jnp.asarray(deltas), jnp.asarray(src)),
           tt.apply_deltas(torch.from_numpy(deltas), torch.from_numpy(src)))


def test_assign_boxes_to_levels_matches_jax():
    rng = np.random.RandomState(5)
    b = _random_boxes(rng, 500, extent=800.0, size=700.0)
    b[:5] = [[0, 0, 0, 0], [5, 5, 5, 9], [0, 0, 224, 224], [0, 0, 112, 112], [3, 3, 1, 1]]
    want = np.asarray(jax_assign_levels(jnp.asarray(b), 2, 5))
    got = assign_boxes_to_levels(torch.from_numpy(b), 2, 5).numpy()
    np.testing.assert_array_equal(got, want)


def _pyramid(rng, b, c, hw):
    return [rng.randn(b, h, w, c).astype(np.float32) for h, w in hw]


def _roi_cases(rng, r, extent_hw):
    """Boxes spread over the image, with ROIs at the adaptive cap (large),
    hugging the borders, partly and wholly outside the image, and empty."""
    h, w = extent_hw
    b = _random_boxes(rng, r, extent=max(h, w), size=max(h, w) / 2)
    k = r // 6
    b[:k] = [0, 0, w, h]  # full image: many-pixel bins, grid capped at 4
    b[k : 2 * k, :2] = -rng.rand(k, 2) * 8  # across the top-left border
    b[2 * k : 3 * k, 2:] = [w + 3, h + 3]  # across the bottom-right border
    b[3 * k : 3 * k + 3] = [[-50, -50, -20, -20], [w + 40, h + 40, w + 80, h + 80], [7, 7, 7, 7]]
    return b


@pytest.mark.parametrize(
    "sampling_ratio,aligned,output_size",
    [(0, True, 7), (0, True, 14), (2, True, 7), (0, False, 7)],
)
def test_roi_align_multilevel_matches_jax(sampling_ratio, aligned, output_size):
    rng = np.random.RandomState(11)
    hw = [(32, 48), (16, 24), (8, 12), (4, 6)]
    feats = _pyramid(rng, 2, 16, hw)
    r = 60
    b = _roi_cases(rng, r, (128, 192))
    levels = rng.randint(0, 4, r).astype(np.int32)
    bidx = rng.randint(0, 2, r).astype(np.int32)
    scales = (1 / 4, 1 / 8, 1 / 16, 1 / 32)
    want = jax_roi_align_multilevel(
        tuple(jnp.asarray(f) for f in feats), scales, jnp.asarray(b), jnp.asarray(bidx),
        jnp.asarray(levels), output_size, sampling_ratio, aligned,
    )
    got = roi_align.roi_align_multilevel(
        [torch.from_numpy(f) for f in feats], scales, torch.from_numpy(b),
        torch.from_numpy(bidx), torch.from_numpy(levels), output_size, sampling_ratio, aligned,
    )
    assert got.shape == (r, output_size, output_size, 16)
    _close(want, got)
    # out-of-range ROIs pool to zero on both sides
    assert np.abs(got[3 * (r // 6) : 3 * (r // 6) + 2].numpy()).max() == 0.0


def test_roi_align_batched_matches_jax():
    rng = np.random.RandomState(12)
    f = rng.randn(3, 20, 28, 8).astype(np.float32)
    r = 40
    b = _roi_cases(rng, r, (80, 112))
    bidx = rng.randint(0, 3, r).astype(np.int32)
    want = jax_roi_align_batched(
        jnp.asarray(f), jnp.asarray(b), jnp.asarray(bidx), 7, 0.25, 0, True
    )
    got = roi_align.roi_align_batched(
        torch.from_numpy(f), torch.from_numpy(b), torch.from_numpy(bidx), 7, 0.25, 0, True
    )
    _close(want, got)


def test_cuda_wrapper_refuses_cpu_tensors():
    from jtsm_tpu_torch.ops.roi_align_cuda import KERNEL, roi_align_multilevel_cuda

    before = KERNEL.launches
    f = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError):
        roi_align_multilevel_cuda(
            [f], [1.0], torch.zeros(1, 4), torch.zeros(1, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), 2,
        )
    assert KERNEL.launches == before
