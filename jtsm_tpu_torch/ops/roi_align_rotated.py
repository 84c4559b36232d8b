"""Rotated ROIAlign (reference: detectron2/layers/roi_align_rotated.py:19
and ``csrc/ROIAlignRotated``; JAX package ``ops/roi_align_rotated.py:21-133``).

The JAX package's gather-and-blend with the sampling grid rotated by each
ROI's angle around its centre: for each ROI a (P*S) x (P*S) grid of
samples (S = ``sampling_ratio``), each the bilinear blend of its four
taps, a sample outside [-1, size] counting zero, a coordinate below 0
snapping to 0 and one at or past the last cell taking the last cell;
each bin the mean of its S x S samples. The blend runs in the features'
dtype, as in the JAX package (``:82-95``). The sample coordinates round as
XLA computes the JAX package's (the correctly rounded cosine and sine,
fused multiply-adds).

No Pallas kernel lies behind this op in the JAX package (XLA fuses it):
the port runs it in plain PyTorch on either device, ROIs in chunks that
bound each gather to ``_CHUNK_ELEMENTS`` elements, differentiable in the
features through ``index_select``. Features are channels-last (B, H, W,
C); the result is (R, P, P, C).
"""

from __future__ import annotations

import math

import torch

from ..structures.rotated_boxes import fma32

# elements of one tap gather (64 MB in float32)
_CHUNK_ELEMENTS = 1 << 24


def _prep(coords: torch.Tensor, size: int):
    """Low tap, fraction and zero mask of sample coordinates on an axis of
    ``size`` cells (JAX :59 ``prep2``)."""
    out_of_range = (coords < -1.0) | (coords > size)
    coords = coords.clamp(min=0.0)
    lo = torch.floor(coords)
    frac = coords - lo
    lo = lo.to(torch.int64)
    hi_oob = lo >= size - 1
    lo = torch.where(hi_oob, torch.full_like(lo, size - 2), lo)
    frac = torch.where(hi_oob, torch.ones_like(frac), frac)
    return lo.clamp(0, max(size - 2, 0)), frac, out_of_range


def _pool_chunk(flat, h, w, boxes, batch_indices, p, s, spatial_scale):
    r = boxes.shape[0]
    cx = boxes[:, 0] * spatial_scale - 0.5
    cy = boxes[:, 1] * spatial_scale - 0.5
    rw = boxes[:, 2] * spatial_scale
    rh = boxes[:, 3] * spatial_scale
    theta = (boxes[:, 4] * (math.pi / 180.0)).double()
    cos_t = torch.cos(theta).float()[:, None, None]
    sin_t = torch.sin(theta).float()[:, None, None]
    dev = boxes.device
    grid = (torch.arange(p, dtype=torch.float32, device=dev)[:, None]
            + (torch.arange(s, dtype=torch.float32, device=dev)[None, :] + 0.5) / s).reshape(-1)
    # a true division: PyTorch's CUDA divides by a host scalar through its reciprocal
    bins = torch.full((), float(p), device=dev)
    ly = fma32(grid[None, :], (rh / bins)[:, None], -(rh[:, None] / 2))[:, :, None]  # (R, PS, 1)
    lx = fma32(grid[None, :], (rw / bins)[:, None], -(rw[:, None] / 2))[:, None, :]  # (R, 1, PS)
    n = p * s
    ys = fma32(lx.expand(r, n, n), sin_t.expand(r, n, n), fma32(ly.expand(r, n, n), cos_t.expand(r, n, n),
                                                                cy[:, None, None].expand(r, n, n)))
    xs = fma32(lx.expand(r, n, n), cos_t.expand(r, n, n), fma32(-ly.expand(r, n, n), sin_t.expand(r, n, n),
                                                                cx[:, None, None].expand(r, n, n)))
    # each bin's S x S samples side by side: (R, P*P, S*S), row-major in the samples as the mean reads them
    ys, xs = (v.reshape(r, p, s, p, s).permute(0, 1, 3, 2, 4).reshape(r, p * p, s * s) for v in (ys, xs))
    ylo, yfrac, y_oob = _prep(ys, h)
    xlo, xfrac, x_oob = _prep(xs, w)
    base = batch_indices.to(torch.int64)[:, None, None] * (h * w) + ylo * w + xlo
    last = flat.shape[0] - 1

    def gather(idx):
        return flat.index_select(0, idx.reshape(-1).clamp(0, last)).reshape(r, p * p, s * s, -1)

    dt = flat.dtype
    fy, fx = yfrac[..., None].to(dt), xfrac[..., None].to(dt)
    one = torch.ones((), dtype=dt, device=dev)
    val = (gather(base) * (one - fy) * (one - fx) + gather(base + 1) * (one - fy) * fx
           + gather(base + w) * fy * (one - fx) + gather(base + w + 1) * fy * fx)
    val = torch.where((y_oob | x_oob)[..., None], torch.zeros((), dtype=dt, device=dev), val)
    # the bin's mean as jnp.mean takes it: a float32 sum, divided, in the features' dtype
    count = torch.full((), float(s * s), device=dev)
    return (val.sum(dim=2, dtype=torch.float32) / count).to(dt).reshape(r, p, p, -1)


def roi_align_rotated_batched(
    features: torch.Tensor,  # (B, H, W, C)
    boxes: torch.Tensor,  # (R, 5) (cx, cy, w, h, angle in degrees)
    batch_indices: torch.Tensor,  # (R,)
    output_size: int,
    spatial_scale: float = 1.0,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """(R, P, P, C) rotated ROIAlign of ``boxes`` in image coordinates over
    channels-last ``features`` (JAX :21)."""
    b, h, w, c = features.shape
    p, s = int(output_size), max(int(sampling_ratio), 1)
    r = boxes.shape[0]
    if r == 0:
        return features.new_zeros((0, p, p, c))
    flat = features.reshape(b * h * w, c)
    boxes = boxes.to(torch.float32)
    step = max(1, _CHUNK_ELEMENTS // (p * s * p * s * c))
    return torch.cat([_pool_chunk(flat, h, w, boxes[i:i + step], batch_indices[i:i + step], p, s, spatial_scale)
                      for i in range(0, r, step)])


def roi_align_rotated(features, boxes, batch_indices, output_size, spatial_scale=1.0, sampling_ratio=2):
    """:func:`roi_align_rotated_batched` under the reference's public name
    (layers/roi_align_rotated.py:19; JAX :100)."""
    return roi_align_rotated_batched(features, boxes, batch_indices, output_size, spatial_scale, sampling_ratio)


class ROIAlignRotated:
    """Module-style wrapper (reference layers/roi_align_rotated.py:50; JAX
    :108): ``rois`` (R, 6) rows (batch index, cx, cy, w, h, angle)."""

    def __init__(self, output_size, spatial_scale: float, sampling_ratio: int = 2):
        self.output_size = output_size if isinstance(output_size, int) else output_size[0]
        self.spatial_scale = float(spatial_scale)
        self.sampling_ratio = int(sampling_ratio)

    def __call__(self, features: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
        return roi_align_rotated_batched(features, rois[:, 1:6], rois[:, 0].to(torch.int32), self.output_size,
                                         self.spatial_scale, self.sampling_ratio)

    def __repr__(self):
        return (f"ROIAlignRotated(output_size={self.output_size}, spatial_scale={self.spatial_scale}, "
                f"sampling_ratio={self.sampling_ratio})")
