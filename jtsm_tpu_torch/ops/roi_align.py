"""Multilevel ROIAlign, forward and backward: the plain PyTorch versions and
the dispatch to the CUDA kernels.

Semantics: the JAX package's ``ops/roi_align.py`` (:236
``roi_align_multilevel``, :204 ``roi_align_batched``), which is detectron2's
ROIAlign (``layers/roi_align.py:31``) in its v2 form (``aligned=True``, a
half-pixel offset) with one difference kept on purpose:

* ``sampling_ratio=0`` is the adaptive mode: each ROI samples a
  ``ceil(bin)`` grid per bin on each axis, clipped to
  ``[1, ADAPTIVE_MAX_RATIO]``. detectron2 does not cap the grid; the JAX
  package caps it at 4, and the port reproduces the JAX package.
* samples lie at ``origin + (bin + (k + 0.5) / ratio) * bin_size``; a bin is
  the sum of its live samples divided by ``ratio_y * ratio_x``;
* boundary rules: a sample outside ``[-1, size]`` on either axis counts as
  zero; a coordinate below 0 snaps to 0; a sample at or past the last cell
  takes the last cell (``lo = size - 2``, ``frac = 1``).

Layout follows the JAX package: features are a list of channels-last maps
(B, Hi, Wi, C), fine to coarse; the result is (R, P, P, C).

The backward is the transpose of the forward (ROIAlign is linear in the
features): every live sample spreads its bin's cotangent, divided by the
ROI's count, onto its four taps with the forward's weights.

:func:`roi_align_multilevel` runs the plain versions for tensors on the CPU
and launches the kernels (``roi_align_cuda``: K1 forward, K2 backward) for
tensors on the card; there is no fallback from one to the other.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

# the cap on the adaptive (sampling_ratio=0) sample grid per bin and axis
ADAPTIVE_MAX_RATIO = 4
# elements of one tap tensor of the plain version (64 MB in float32)
_PLAIN_CHUNK_ELEMENTS = 1 << 24


def _pair(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x, x)


def _axis_samples(p: int, s: int, bin_size, origin, ratio, size):
    """Sample taps along one axis for every ROI: (R, p, s) low index,
    fraction and a zero-mask (outside the map, or slot k >= ratio)."""
    dev = origin.device
    bins = torch.arange(p, dtype=torch.float32, device=dev)[:, None]
    slots = torch.arange(s, dtype=torch.float32, device=dev)[None, :]
    rr = ratio.to(torch.float32)[:, None, None]
    grid = bins[None] + (slots[None] + 0.5) / rr
    pos = origin[:, None, None] + grid * bin_size[:, None, None]
    size = size[:, None, None]
    dead = (pos < -1.0) | (pos > size) | ~(slots[None] < rr)
    pos = pos.clamp(min=0.0)
    lo = torch.floor(pos)
    frac = pos - lo
    lo = lo.to(torch.int64)
    hi_edge = lo >= size - 1
    lo = torch.where(hi_edge, size - 2, lo)
    frac = torch.where(hi_edge, torch.ones_like(frac), frac)
    lo = torch.minimum(lo.clamp(min=0), (size - 2).clamp(min=0))
    return lo, frac, dead


def _level_geometry(feature_shapes, spatial_scales, boxes, batch_indices, levels, ph, pw,
                    sampling_ratio, aligned):
    """Per-ROI sample geometry shared by the forward and the backward: the
    flat row offset of each ROI's image on its level, the row stride, the
    taps of both axes and the averaging divisor. ``feature_shapes`` are the
    (B, Hi, Wi, C) shapes of the levels."""
    dev = boxes.device
    r = boxes.shape[0]
    adaptive = int(sampling_ratio) == 0
    s = ADAPTIVE_MAX_RATIO if adaptive else max(int(sampling_ratio), 1)
    starts, acc = [], 0
    for shp in feature_shapes:
        starts.append(acc)
        acc += shp[0] * shp[1] * shp[2]
    starts = torch.tensor(starts, dtype=torch.int64, device=dev)
    hs = torch.tensor([shp[1] for shp in feature_shapes], dtype=torch.int64, device=dev)
    ws = torch.tensor([shp[2] for shp in feature_shapes], dtype=torch.int64, device=dev)
    scales = torch.tensor(list(spatial_scales), dtype=torch.float32, device=dev)

    lvl = levels.to(torch.int64).clamp(0, len(feature_shapes) - 1)
    h, w = hs[lvl], ws[lvl]
    base = starts[lvl] + batch_indices.to(torch.int64) * h * w

    offset = 0.5 if aligned else 0.0
    bx = boxes.to(torch.float32) * scales[lvl][:, None] - offset
    roi_w = bx[:, 2] - bx[:, 0]
    roi_h = bx[:, 3] - bx[:, 1]
    if not aligned:
        roi_w = roi_w.clamp(min=1.0)
        roi_h = roi_h.clamp(min=1.0)
    # tensor divisors: on the card PyTorch divides by a Python number as a
    # multiplication by its reciprocal, which rounds differently from the
    # kernel's (and the CPU's) true division
    bin_w = roi_w / torch.full_like(roi_w, pw)
    bin_h = roi_h / torch.full_like(roi_h, ph)
    if adaptive:
        ry = torch.ceil(bin_h).clamp(1, s).to(torch.int64)
        rx = torch.ceil(bin_w).clamp(1, s).to(torch.int64)
    else:
        ry = torch.full((r,), s, dtype=torch.int64, device=dev)
        rx = ry
    ylo, yfrac, ydead = _axis_samples(ph, s, bin_h, bx[:, 1], ry, h)
    xlo, xfrac, xdead = _axis_samples(pw, s, bin_w, bx[:, 0], rx, w)
    count = (ry * rx).to(torch.float32)
    return s, acc, base, w, (ylo, yfrac, ydead), (xlo, xfrac, xdead), count


def _live_slots(dead: torch.Tensor) -> int:
    """1 + the last sample slot of (R, p, s) ``dead`` that is live for some
    ROI (at least 1)."""
    live = (~dead).flatten(0, 1).any(dim=0).nonzero()
    return int(live.max()) + 1 if len(live) else 1


def roi_align_multilevel_plain(
    features: Sequence[torch.Tensor],
    spatial_scales: Sequence[float],
    boxes: torch.Tensor,
    batch_indices: torch.Tensor,
    levels: torch.Tensor,
    output_size,
    sampling_ratio: int = 0,
    aligned: bool = True,
) -> torch.Tensor:
    """The plain PyTorch version: gathers the four taps of every sample from
    one flattened pyramid and averages in float32. Returns (R, P, P, C) in
    the features' dtype. Runs on any device; the CUDA kernel is held
    against it."""
    ph, pw = _pair(output_size)
    r = boxes.shape[0]
    c = features[0].shape[-1]
    s, _, base, w, (ylo, yfrac, ydead), (xlo, xfrac, xdead), count = _level_geometry(
        [f.shape for f in features], spatial_scales, boxes, batch_indices, levels, ph, pw,
        sampling_ratio, aligned,
    )
    flat = torch.cat([f.reshape(-1, c) for f in features], dim=0)
    count = count[:, None, None, None]
    out = torch.empty((r, ph, pw, c), dtype=features[0].dtype, device=boxes.device)
    # sample slots past the last one that any ROI uses add zeros: leave them
    # out (the adaptive grid of small ROIs is 1x1, a sixteenth of the slots)
    sy, sx = (_live_slots(dead) for dead in (ydead, xdead))
    ylo, yfrac, ydead = (a[:, :, :sy] for a in (ylo, yfrac, ydead))
    xlo, xfrac, xdead = (a[:, :, :sx] for a in (xlo, xfrac, xdead))
    # ROIs in chunks, so the (R, ph, sy, pw, sx, C) tap tensors stay small
    step = max(1, _PLAIN_CHUNK_ELEMENTS // (ph * pw * sy * sx * c))
    for i in range(0, r, step):
        j = slice(i, i + step)
        # (n, ph, s, pw, s) row indices into the flat pyramid
        idx = (
            base[j, None, None, None, None]
            + ylo[j, :, :, None, None] * w[j, None, None, None, None]
            + xlo[j, None, None, :, :]
        )
        w_b = w[j, None, None, None, None]

        def tap(k):
            return flat[k.reshape(-1)].to(torch.float32).reshape(k.shape + (c,))

        wy = yfrac[j, :, :, None, None, None]
        wx = xfrac[j, None, None, :, :, None]
        val = (
            tap(idx) * (1 - wy) * (1 - wx)
            + tap(idx + 1) * (1 - wy) * wx
            + tap(idx + w_b) * wy * (1 - wx)
            + tap(idx + w_b + 1) * wy * wx
        )
        dead = ydead[j, :, :, None, None] | xdead[j, None, None, :, :]
        val = torch.where(dead[..., None], torch.zeros_like(val), val)
        out[j] = (val.sum(dim=(2, 4)) / count[j]).to(out.dtype)
    return out


def roi_align_multilevel_backward_plain(
    grad: torch.Tensor,
    feature_shapes: Sequence[Sequence[int]],
    spatial_scales: Sequence[float],
    boxes: torch.Tensor,
    batch_indices: torch.Tensor,
    levels: torch.Tensor,
    output_size,
    sampling_ratio: int = 0,
    aligned: bool = True,
) -> List[torch.Tensor]:
    """The transpose of :func:`roi_align_multilevel_plain`: each ROI's
    (P, P, C) cotangent ``grad`` spreads back through the forward's own
    taps and weights, ``grad / count * wy * wx`` per live sample and tap,
    and is summed with ``index_add_`` into one flat float32 pyramid.
    Returns per level the (B, Hi, Wi, C) gradient, contiguous, in the
    cotangent's dtype (the features' dtype). Runs on any device; the CUDA
    kernel K2 is held against it."""
    ph, pw = _pair(output_size)
    r = boxes.shape[0]
    c = grad.shape[-1]
    s, total, base, w, (ylo, yfrac, ydead), (xlo, xfrac, xdead), count = _level_geometry(
        feature_shapes, spatial_scales, boxes, batch_indices, levels, ph, pw,
        sampling_ratio, aligned,
    )
    acc = torch.zeros((total, c), dtype=torch.float32, device=grad.device)
    # (R * ph * pw, C): the cotangent of each bin, divided by its ROI's count
    gc = (grad.to(torch.float32) / count[:, None, None, None]).reshape(-1, c)
    dev = boxes.device
    py = torch.arange(ph, device=dev)[None, :, None, None, None]
    px = torch.arange(pw, device=dev)[None, None, None, :, None]
    step = max(1, _PLAIN_CHUNK_ELEMENTS // (ph * pw * s * s * c))
    for i in range(0, r, step):
        j = slice(i, i + step)
        rois = torch.arange(i, min(i + step, r), device=dev)[:, None, None, None, None]
        live = ~(ydead[j, :, :, None, None] | xdead[j, None, None, :, :])
        idx = (
            base[j, None, None, None, None]
            + ylo[j, :, :, None, None] * w[j, None, None, None, None]
            + xlo[j, None, None, :, :]
        )
        w_b = w[j, None, None, None, None].expand_as(idx)
        bins = (rois * ph + py) * pw + px
        g = gc[bins.expand_as(idx)[live]]
        wy = yfrac[j, :, :, None, None].expand_as(idx)[live]
        wx = xfrac[j, None, None, :, :].expand_as(idx)[live]
        rows, w_b = idx[live], w_b[live]
        for k, weight in (
            (rows, (1 - wy) * (1 - wx)),
            (rows + 1, (1 - wy) * wx),
            (rows + w_b, wy * (1 - wx)),
            (rows + w_b + 1, wy * wx),
        ):
            acc.index_add_(0, k, g * weight[:, None])
    out, start = [], 0
    for shp in feature_shapes:
        n = shp[0] * shp[1] * shp[2]
        out.append(acc[start : start + n].reshape(tuple(shp[:3]) + (c,)).to(grad.dtype))
        start += n
    return out


class _RoIAlignPlain(torch.autograd.Function):
    """The plain forward with the plain backward, on any device."""

    @staticmethod
    def forward(ctx, boxes, batch_indices, levels, geometry, *features):
        scales, ph, pw, sampling_ratio, aligned = geometry
        ctx.geometry = geometry
        ctx.feature_shapes = [tuple(f.shape) for f in features]
        ctx.save_for_backward(boxes, batch_indices, levels)
        return roi_align_multilevel_plain(
            features, scales, boxes, batch_indices, levels, (ph, pw), sampling_ratio, aligned
        )

    @staticmethod
    def backward(ctx, grad):
        scales, ph, pw, sampling_ratio, aligned = ctx.geometry
        boxes, batch_indices, levels = ctx.saved_tensors
        grads = roi_align_multilevel_backward_plain(
            grad, ctx.feature_shapes, scales, boxes, batch_indices, levels, (ph, pw),
            sampling_ratio, aligned,
        )
        return (None, None, None, None, *grads)


def roi_align_geometry(spatial_scales, output_size, sampling_ratio, aligned) -> tuple:
    """The non-tensor arguments of the autograd Functions, normalised: 0 is
    the adaptive grid, any other ratio a fixed grid of at least 1."""
    ph, pw = _pair(output_size)
    ratio = 0 if int(sampling_ratio) == 0 else max(int(sampling_ratio), 1)
    return (tuple(float(s) for s in spatial_scales), ph, pw, ratio, bool(aligned))


def roi_align_multilevel_plain_autograd(
    features: Sequence[torch.Tensor],
    spatial_scales: Sequence[float],
    boxes: torch.Tensor,
    batch_indices: torch.Tensor,
    levels: torch.Tensor,
    output_size,
    sampling_ratio: int = 0,
    aligned: bool = True,
) -> torch.Tensor:
    """:func:`roi_align_multilevel_plain` whose gradient is
    :func:`roi_align_multilevel_backward_plain`, on any device: the CPU path
    of :func:`roi_align_multilevel`, and the plain path that the kernels are
    held against on the card."""
    geometry = roi_align_geometry(spatial_scales, output_size, sampling_ratio, aligned)
    return _RoIAlignPlain.apply(boxes, batch_indices, levels, geometry, *features)


def roi_align_multilevel(
    features: Sequence[torch.Tensor],
    spatial_scales: Sequence[float],
    boxes: torch.Tensor,
    batch_indices: torch.Tensor,
    levels: torch.Tensor,
    output_size,
    sampling_ratio: int = 0,
    aligned: bool = True,
) -> torch.Tensor:
    """ROIAlign of each box (R, 4), in image coordinates, on its level
    ``levels`` (R,) of image ``batch_indices`` (R,). Returns (R, P, P, C),
    differentiable in the features.

    Tensors on the card go through the CUDA kernels (K1 forward, K2
    backward), tensors on the CPU through the plain versions."""
    if boxes.device.type == "cuda":
        from .roi_align_cuda import roi_align_multilevel_cuda

        return roi_align_multilevel_cuda(
            features, spatial_scales, boxes, batch_indices, levels,
            output_size, sampling_ratio, aligned,
        )
    if boxes.device.type != "cpu":
        raise NotImplementedError(f"ROIAlign has no path for device {boxes.device}")
    return roi_align_multilevel_plain_autograd(
        features, spatial_scales, boxes, batch_indices, levels,
        output_size, sampling_ratio, aligned,
    )


def roi_align_batched(
    features: torch.Tensor,
    boxes: torch.Tensor,
    batch_indices: torch.Tensor,
    output_size,
    spatial_scale: float = 1.0,
    sampling_ratio: int = 0,
    aligned: bool = True,
) -> torch.Tensor:
    """Single-level ROIAlign on (B, H, W, C) features: the multilevel op
    with one level."""
    levels = torch.zeros_like(batch_indices, dtype=torch.int32)
    return roi_align_multilevel(
        [features], [spatial_scale], boxes, batch_indices, levels,
        output_size, sampling_ratio, aligned,
    )
