"""Mask paste: ROI mask probabilities to full-image bool masks, on the
masks' device, batched over detections (the paste the JAX package scores
with, ``evaluation/coco_evaluation.py:31`` ``_paste_mask_np``, which matches
detectron2's ``_do_paste_mask``: ``grid_sample`` with align_corners=False
and zero padding).

The numpy version works in float64: its sample positions and weights are
float64 and the float32 mask values are promoted. This one does the same
products and sums in the same order in float64 on the device, so that the
masks thresholded at 0.5 are identical. Each operation is its own PyTorch
call and every divisor is a tensor (a Python divisor becomes a product by
its reciprocal on the card), so no step rounds differently.

Memory: detections are pasted in chunks so that one (chunk, H, W) float64
array holds at most ``CHUNK_BYTES`` (32 MiB); a chunk keeps about eight
such arrays alive at its peak (weights, gathered values, sums), about 256
MiB on the device. The flagship's 100 detections at 480x640 (2.4 MB per
detection and array) go in chunks of 13.
"""

from __future__ import annotations

import torch

CHUNK_BYTES = 32 * 2**20


def _axis_taps(lo: torch.Tensor, hi: torch.Tensor, size: int, s: int):
    """Per detection and output pixel along one axis: the two mask cells
    sampled (clamped into the mask), the fraction, and whether each cell
    lies inside the mask. ``lo``, ``hi`` are float32 box edges."""
    extent = (hi - lo).to(torch.float64)  # the float32 difference, as numpy takes it
    extent = torch.where(extent < 1e-6, torch.full_like(extent, 1e-6), extent)
    pos = torch.arange(size, dtype=torch.float64, device=lo.device) + 0.5
    c = (pos[None, :] - lo.to(torch.float64)[:, None]) / extent[:, None] * s - 0.5
    i0 = torch.floor(c)
    f = c - i0
    i0 = i0.to(torch.int64)
    i1 = i0 + 1
    v0 = (i0 >= 0) & (i0 < s)
    v1 = (i1 >= 0) & (i1 < s)
    return i0.clamp(0, s - 1), i1.clamp(0, s - 1), f, v0, v1


def paste_masks(masks: torch.Tensor, boxes: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, S, S) mask probabilities inside (N, 4) float32 XYXY boxes ->
    (N, h, w) bool masks at the image's size (probability at least 0.5),
    on the masks' device."""
    n, s = masks.shape[0], masks.shape[-1]
    out = torch.empty((n, h, w), dtype=torch.bool, device=masks.device)
    chunk = max(1, CHUNK_BYTES // (8 * h * w))
    masks = masks.to(torch.float32)
    boxes = boxes.to(device=masks.device, dtype=torch.float32)
    for start in range(0, n, chunk):
        m = masks[start: start + chunk]
        b = boxes[start: start + chunk]
        k = m.shape[0]
        y0i, y1i, fy, vy0, vy1 = _axis_taps(b[:, 1], b[:, 3], h, s)
        x0i, x1i, fx, vx0, vx1 = _axis_taps(b[:, 0], b[:, 2], w, s)
        gy, gx = 1.0 - fy, 1.0 - fx
        rows = torch.arange(k, device=m.device)[:, None, None]

        def term(yi, xi, wy, wx, vy, vx):
            weight = wy[:, :, None] * wx[:, None, :] * (vy[:, :, None] & vx[:, None, :])
            return m[rows, yi[:, :, None], xi[:, None, :]] * weight

        acc = term(y0i, x0i, gy, gx, vy0, vx0)
        acc = acc + term(y0i, x1i, gy, fx, vy0, vx1)
        acc = acc + term(y1i, x0i, fy, gx, vy1, vx0)
        acc = acc + term(y1i, x1i, fy, fx, vy1, vx1)
        out[start: start + k] = acc >= 0.5
    return out
