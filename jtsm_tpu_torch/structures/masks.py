"""Mask resampling for mask targets (JAX package ``structures/masks.py:71``
``crop_and_resize_masks``, which replaces detectron2's route through the
ROIAlign op, ``structures/masks.py:169``)."""

from __future__ import annotations

import torch


def _axis_weights(c0: torch.Tensor, bin_size: torch.Tensor, s: int, m: int) -> torch.Tensor:
    """(N, s, m) bilinear hat weights of one sample at the centre of each of
    the s output bins, over the m input cells; taps outside [0, m) match no
    cell and so weigh nothing (zero padding)."""
    centres = torch.arange(s, dtype=torch.float32, device=c0.device) + 0.5
    coords = c0[:, None] + centres * bin_size[:, None] - 0.5
    lo = torch.floor(coords)
    f = coords - lo
    lo = lo.to(torch.int64)[..., None]
    k = torch.arange(m, device=c0.device)
    zero = torch.zeros((), dtype=torch.float32, device=c0.device)
    return torch.where(k == lo, (1.0 - f)[..., None], zero) + torch.where(k == lo + 1, f[..., None], zero)


def crop_and_resize_masks(masks: torch.Tensor, boxes: torch.Tensor, mask_size: int) -> torch.Tensor:
    """Bilinear crop of (N, H, W) masks to (N, S, S) by the aligned ROIAlign
    convention (half-pixel centres, one sample per bin), as two batched
    products with separable hat-weight matrices. ``boxes`` (N, 4) are in
    the masks' pixel frame. Plain PyTorch: float32 products, which stay
    float32 on the card with TF32 off."""
    s = mask_size
    h, w = masks.shape[-2:]
    wy = _axis_weights(boxes[:, 1], (boxes[:, 3] - boxes[:, 1]) / s, s, h)
    wx = _axis_weights(boxes[:, 0], (boxes[:, 2] - boxes[:, 0]) / s, s, w)
    tmp = torch.einsum("nih,nhw->niw", wy, masks.to(torch.float32))
    return torch.einsum("njw,niw->nij", wx, tmp)
