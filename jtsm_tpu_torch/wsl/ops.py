"""The WSL pooling ops of the JTSM path, in plain PyTorch.

Semantics: the JAX package's ``wsl/ops.py`` (``superpixel_membership_grid``
:34, ``sample_membership_grid`` :59, ``moi_pool`` :101, ``moi_pool_exact``
:559, ``roi_pool`` :649), which express the reference's MOIPool and RoIPool
kernels (``projects/WSL/wsl/layers/csrc/MOIPool``) in ``jnp``. Like them,
every function takes ONE image; callers loop over the batch.

Where the JAX package forms one-hot matrix products (exact 0/1 values on
the TPU's matrix unit), the port gathers the same 0/1 values. A superpixel
id outside ``[0, S)`` belongs to no proposal.

A division by a constant is a product by the constant's float32
reciprocal, as XLA compiles it in the JAX package's jitted functions (and
as the card computes a division by a Python number): a quotient one ulp
off can move a sample or a bin edge across a rounding boundary and so
change which pixel it reads.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# ROIs pooled at once by the exact formulations (each step holds an
# (ROIs, H, W, C) tensor)
_EXACT_CHUNK_ELEMENTS = 1 << 24


def _t(x, like: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """A scalar on ``like``'s device, filled there (no copy from the host)."""
    return torch.full((), float(x), dtype=dtype, device=like.device)


def _inv(d, like: torch.Tensor) -> torch.Tensor:
    """The float32 reciprocal of the constant ``d``, on ``like``'s device."""
    return _t(np.float32(1) / np.float32(d), like)


def _membership(oh_labels: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """oh_labels (R, S) bool and ids (R, ...) -> (R, ...) bool:
    ``oh_labels[r, ids[r, ...]]``, False for ids outside [0, S)."""
    r, ns = oh_labels.shape
    ok = (ids >= 0) & (ids < ns)
    flat = ids.clamp(0, max(ns - 1, 0)).reshape(r, -1).long()
    return torch.gather(oh_labels.bool(), 1, flat).reshape(ids.shape) & ok


def superpixel_membership_grid(
    superpixels: torch.Tensor,  # (Hs, Ws) int superpixel ids at image resolution
    oh_labels: torch.Tensor,  # (R, S) bool membership of superpixel s in proposal r
    grid_stride: int,
) -> torch.Tensor:
    """(R, Hg, Wg) float 0/1: ``oh[r, sp[gy*g + g//2, gx*g + g//2]]``, the
    membership of each stride-g cell centre."""
    g = int(grid_stride)
    off = g // 2
    sp_g = superpixels[off::g, off::g]
    r = oh_labels.shape[0]
    ids = sp_g.reshape(1, -1).expand(r, -1)
    return _membership(oh_labels, ids).reshape((r,) + tuple(sp_g.shape)).float()


def sample_membership_grid(
    mask_g: torch.Tensor,  # (R, Hg, Wg) 0/1 grid
    gy: torch.Tensor,  # (R, K) grid row of each y sample
    gx: torch.Tensor,  # (R, L) grid column of each x sample
    y_ok: torch.Tensor | None = None,  # (R, K) bool
    x_ok: torch.Tensor | None = None,  # (R, L)
) -> torch.Tensor:
    """(R, K, L) float 0/1: ``mask_g[r, gy_k, gx_l]`` with the indices
    clipped into the grid (pixels past the last cell centre belong to the
    last cell), 0 where ``y_ok`` or ``x_ok`` is False."""
    hg, wg = mask_g.shape[1:]
    yy = gy.long().clamp(0, hg - 1)
    xx = gx.long().clamp(0, wg - 1)
    rows = torch.gather(mask_g, 1, yy[:, :, None].expand(-1, -1, wg))  # (R, K, Wg)
    out = torch.gather(rows, 2, xx[:, None, :].expand(-1, yy.shape[1], -1))
    if y_ok is not None:
        out = out * y_ok[:, :, None]
    if x_ok is not None:
        out = out * x_ok[:, None, :]
    return out


def _sample_axis(origin, bin_size, p: int, s: int):
    """Static-grid sample positions along one axis, (R, P*S): the JAX
    package's ``ops/roi_align.py`` ``_axis_positions`` without a ratio."""
    dev = origin.device
    bins = torch.arange(p, dtype=torch.float32, device=dev)[:, None]
    slots = torch.arange(s, dtype=torch.float32, device=dev)[None, :]
    grid = (bins + (slots + 0.5) * _inv(s, origin)).reshape(-1)
    return origin[:, None] + grid[None, :] * bin_size[:, None]


def _sample_grid(boxes, p: int, s: int, spatial_scale: float):
    """ROIAlignV2 sample coordinates on the feature map, (R, P*S) per axis
    (JAX ``ops/roi_align.py`` ``_sample_grid`` with ``aligned=True``)."""
    bx = boxes.float() * _t(spatial_scale, boxes) - 0.5
    x0, y0, x1, y1 = bx.unbind(-1)
    bin_w = (x1 - x0) * _inv(p, boxes)
    bin_h = (y1 - y0) * _inv(p, boxes)
    return _sample_axis(y0, bin_h, p, s), _sample_axis(x0, bin_w, p, s)


def moi_pool(
    features: torch.Tensor,  # (H, W, C) one image's map
    boxes: torch.Tensor,  # (R, 4) XYXY in image coordinates
    superpixels: torch.Tensor,  # (Hs, Ws) int superpixel ids at image resolution
    oh_labels: torch.Tensor,  # (R, S) bool
    spatial_scale: float = 1.0,
    output_size: int = 7,
    sampling_ratio: int = 2,
    sp_grid_stride: int = 4,
    nonneg_features: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked-out-of-interest ROI max pool: (pooled (R, P, P, C), valid_frac
    (R, P, P)).

    Each bin maxes over ``max(sampling_ratio, 1)**2`` nearest-neighbour
    samples at the ROIAlignV2 positions, each kept only where its
    superpixel belongs to the proposal. The superpixel of a sample is read
    at the centre of the stride-g cell holding its pixel
    ``round(pos / spatial_scale)`` (half to even); ``sp_grid_stride`` 1 reads
    the pixel itself. With ``nonneg_features`` a masked sample reads zero (a
    bin without a member pools to 0); otherwise it reads ``value - 1e30``
    and bins left below -5e29 become 0. ``valid_frac`` is the bin's share
    of member samples."""
    p = output_size
    s = max(int(sampling_ratio), 1)
    h, w, c = features.shape
    r = boxes.shape[0]
    hs, ws = superpixels.shape
    g = max(int(sp_grid_stride), 1)

    ys, xs = _sample_grid(boxes, p, s, spatial_scale)  # (R, P*S)
    y_ok = ~((ys < -1.0) | (ys > h))
    x_ok = ~((xs < -1.0) | (xs > w))
    yi = torch.round(ys).long().clamp(0, h - 1)
    xi = torch.round(xs).long().clamp(0, w - 1)

    inv_scale = _inv(spatial_scale, boxes)
    off = g // 2 if g > 1 else 0
    sp_g = superpixels[off::g, off::g]
    hg, wg = sp_g.shape
    gy = (torch.round(ys * inv_scale).long().clamp(0, hs - 1) // g).clamp(0, hg - 1)
    gx = (torch.round(xs * inv_scale).long().clamp(0, ws - 1) // g).clamp(0, wg - 1)
    ids = sp_g[gy[:, :, None], gx[:, None, :]]  # (R, K, K)
    member = _membership(oh_labels, ids) & y_ok[:, :, None] & x_ok[:, None, :]

    flat = features.reshape(h * w, c)
    if nonneg_features:
        flat = torch.cat([flat, flat.new_zeros((1, c))])
    neg_inf = _t(-1e30, features, features.dtype)
    pooled = None
    for jy in range(s):
        for jx in range(s):
            idx = yi[:, jy::s, None] * w + xi[:, None, jx::s]  # (R, P, P)
            m = member[:, jy::s, jx::s]
            if nonneg_features:
                masked = flat[torch.where(m, idx, h * w).reshape(-1)].reshape(r, p, p, c)
            else:
                vals = flat[idx.reshape(-1)].reshape(r, p, p, c)
                mf = m.to(vals.dtype)[..., None]
                masked = vals + (mf - 1.0) * (-neg_inf)
            pooled = masked if pooled is None else torch.maximum(pooled, masked)
    valid_frac = member.float().reshape(r, p, s, p, s).sum(dim=(2, 4)) * _inv(s * s, boxes)
    if not nonneg_features:
        pooled = torch.where(pooled <= neg_inf / 2, torch.zeros_like(pooled), pooled)
    return pooled, valid_frac


def _c_round(x: torch.Tensor) -> torch.Tensor:
    """C's round() on nonnegative coordinates, as the JAX package writes it."""
    return torch.floor(x + 0.5).long()


def _fixed_bins(boxes, scale, p: int, h: int, w: int):
    """The integer ROI window and RoIPool's overlapping floor/ceil bins:
    (x1, y1, x2, y2) and (hstart, hend, wstart, wend), each (R,) or (R, P)."""
    sc = _t(scale, boxes)
    x1, y1, x2, y2 = (_c_round(boxes[:, i].float() * sc) for i in range(4))
    roi_w = (x2 - x1 + 1).clamp(min=1).float()
    roi_h = (y2 - y1 + 1).clamp(min=1).float()
    bh = roi_h * _inv(p, boxes)
    bw = roi_w * _inv(p, boxes)
    phs = torch.arange(p, dtype=torch.float32, device=boxes.device)
    hstart = (torch.floor(phs * bh[:, None]).long() + y1[:, None]).clamp(0, h)
    hend = (torch.ceil((phs + 1) * bh[:, None]).long() + y1[:, None]).clamp(0, h)
    wstart = (torch.floor(phs * bw[:, None]).long() + x1[:, None]).clamp(0, w)
    wend = (torch.ceil((phs + 1) * bw[:, None]).long() + x1[:, None]).clamp(0, w)
    return (x1, y1, x2, y2), (hstart, hend, wstart, wend)


def _chunks(r: int, per_roi: int):
    step = max(1, _EXACT_CHUNK_ELEMENTS // max(per_roi, 1))
    return [(i, min(i + step, r)) for i in range(0, r, step)]


def moi_pool_exact(
    features: torch.Tensor,  # (H, W, C)
    boxes: torch.Tensor,  # (R, 4)
    superpixels: torch.Tensor,  # (Hs, Ws)
    oh_labels: torch.Tensor,  # (R, S) bool
    spatial_scale: float = 1.0,
    output_size: int = 7,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference-exact MOIPool forward (``WSL.MOI_POOL_EXACT``):
    (pooled (R, P, P, C), valid (R, P, P) bool). Each feature pixel takes
    the superpixel of its image pixel ``floor(row / spatial_scale)``; bins
    are laid over the ranks of the member pixels (per column for rows, per
    row for columns), and a bin whose fixed RoIPool window is empty, or
    that holds no member, pools to 0 and is invalid."""
    p = output_size
    h, w, c = features.shape
    hs, ws = superpixels.shape
    r = boxes.shape[0]
    dev = features.device
    inv_scale = _inv(spatial_scale, boxes)
    rows = torch.arange(h, device=dev)
    cols = torch.arange(w, device=dev)
    img_y = torch.floor(rows.float() * inv_scale).long().clamp(0, hs - 1)
    img_x = torch.floor(cols.float() * inv_scale).long().clamp(0, ws - 1)
    sp_feat = superpixels[img_y][:, img_x]  # (H, W)

    (x1, y1, x2, y2), (hstart, hend, wstart, wend) = _fixed_bins(boxes, spatial_scale, p, h, w)
    inroi = (
        ((rows[None, :] >= y1[:, None]) & (rows[None, :] < y2[:, None]))[:, :, None]
        & ((cols[None, :] >= x1[:, None]) & (cols[None, :] < x2[:, None]))[:, None, :]
    )
    member = _membership(oh_labels, sp_feat.reshape(1, h, w).expand(r, h, w)) & inroi
    t_h = torch.cumsum(member, dim=1).float()  # (R, H, W) row rank
    t_w = torch.cumsum(member, dim=2).float()
    T_h = member.sum(dim=1).float()  # (R, W)
    T_w = member.sum(dim=2).float()  # (R, H)
    phs = torch.arange(p, dtype=torch.float32, device=dev)
    inv_p = _inv(p, boxes)
    lo_h = (T_h * inv_p)[:, None, :, None] * phs
    hi_h = (T_h * inv_p)[:, None, :, None] * (phs + 1.0)
    keep_h = (lo_h <= t_h[..., None]) & (t_h[..., None] <= hi_h)  # (R, H, W, P)
    lo_w = (T_w * inv_p)[:, :, None, None] * phs
    hi_w = (T_w * inv_p)[:, :, None, None] * (phs + 1.0)
    keep_w = (lo_w <= t_w[..., None]) & (t_w[..., None] <= hi_w)
    nonempty_fixed = (hend > hstart)[:, :, None] & (wend > wstart)[:, None, :]  # (R, P, P)

    out = features.new_zeros((r, p, p, c))
    valid = torch.zeros((r, p, p), dtype=torch.bool, device=dev)
    neg_inf = _t(float("-inf"), features, features.dtype)
    for a, b in _chunks(r, h * w * c):
        for ph in range(p):
            for pw in range(p):
                k2 = member[a:b] & keep_h[a:b, :, :, ph] & keep_w[a:b, :, :, pw]  # (n, H, W)
                any_k = k2.any(dim=(1, 2)) & nonempty_fixed[a:b, ph, pw]
                v = torch.where(k2[..., None], features[None], neg_inf).amax(dim=(1, 2))
                out[a:b, ph, pw] = torch.where(any_k[:, None], v, torch.zeros_like(v))
                valid[a:b, ph, pw] = any_k
    return out, valid


def roi_pool(
    features: torch.Tensor,  # (H, W, C)
    boxes: torch.Tensor,  # (R, 4)
    spatial_scale: float = 1.0,
    output_size: int = 7,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain RoIPool (torchvision's semantics, the reference's
    ``MOIPool_cpu.cpp`` ``RoIPoolForward``): the rounded ROI window split
    into overlapping floor/ceil bins, a hard max over each, empty bins 0 and
    invalid. Returns (pooled (R, P, P, C), valid (R, P, P) bool)."""
    p = output_size
    h, w, c = features.shape
    r = boxes.shape[0]
    dev = features.device
    _, (hstart, hend, wstart, wend) = _fixed_bins(boxes, spatial_scale, p, h, w)
    rows = torch.arange(h, device=dev)
    cols = torch.arange(w, device=dev)
    keep_h = (rows[None, :, None] >= hstart[:, None, :]) & (rows[None, :, None] < hend[:, None, :])  # (R, H, P)
    keep_w = (cols[None, :, None] >= wstart[:, None, :]) & (cols[None, :, None] < wend[:, None, :])  # (R, W, P)
    neg_inf = _t(float("-inf"), features, features.dtype)
    out = features.new_empty((r, p, p, c))
    for a, b in _chunks(r, h * w * c):
        for ph in range(p):
            colmax = torch.where(keep_h[a:b, :, ph, None, None], features[None], neg_inf).amax(dim=1)  # (n, W, C)
            for pw in range(p):
                out[a:b, ph, pw] = torch.where(keep_w[a:b, :, pw, None], colmax, neg_inf).amax(dim=1)
    valid = (hend > hstart)[:, :, None] & (wend > wstart)[:, None, :]
    return torch.where(valid[..., None], out, torch.zeros_like(out)), valid
