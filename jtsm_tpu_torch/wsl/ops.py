"""The WSL pooling and labelling ops, in plain PyTorch.

Semantics: the JAX package's ``wsl/ops.py`` (``superpixel_membership_grid``
:34, ``sample_membership_grid`` :59, ``moi_pool`` :101, ``roi_loop_pool``
:219, ``roi_label`` :332, ``pcl_losses`` :407, ``crf_mean_field`` :452,
``csc_constraint`` :545, ``moi_pool_exact`` :559, ``roi_pool`` :649), which
express the reference's MOIPool, RoIPool,
ROILoopPool and ROILabel kernels (``projects/WSL/wsl/layers/csrc``) in
``jnp``. The MOIPool and RoIPool functions take ONE image (callers loop
over the batch); ``roi_loop_pool`` takes batch indices, and ``roi_label``,
``pcl_losses`` and ``crf_mean_field`` a leading batch dim.

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


def _bins(x1, y1, x2, y2, p: int, h: int, w: int):
    """RoIPool's overlapping floor/ceil bins of the integer windows (R,)
    clamped to the (h, w) map: (hstart, hend, wstart, wend), each (R, P)."""
    roi_w = (x2 - x1 + 1).clamp(min=1).float()
    roi_h = (y2 - y1 + 1).clamp(min=1).float()
    bh = roi_h * _inv(p, roi_h)
    bw = roi_w * _inv(p, roi_w)
    phs = torch.arange(p, dtype=torch.float32, device=x1.device)
    hstart = (torch.floor(phs * bh[:, None]).long() + y1[:, None]).clamp(0, h)
    hend = (torch.ceil((phs + 1) * bh[:, None]).long() + y1[:, None]).clamp(0, h)
    wstart = (torch.floor(phs * bw[:, None]).long() + x1[:, None]).clamp(0, w)
    wend = (torch.ceil((phs + 1) * bw[:, None]).long() + x1[:, None]).clamp(0, w)
    return hstart, hend, wstart, wend


def _fixed_bins(boxes, scale, p: int, h: int, w: int):
    """The integer ROI window and RoIPool's overlapping floor/ceil bins:
    (x1, y1, x2, y2) and (hstart, hend, wstart, wend), each (R,) or (R, P)."""
    sc = _t(scale, boxes)
    x1, y1, x2, y2 = (_c_round(boxes[:, i].float() * sc) for i in range(4))
    return (x1, y1, x2, y2), _bins(x1, y1, x2, y2, p, h, w)


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


# elements of one chunk of roi_loop_pool's gathered bin windows
# (ROIs, P, P, Hb, Wb, C): 512 MiB in float32
_LOOP_CHUNK_ELEMENTS = 1 << 27


def _loop_pool_regions(boxes, scale: float, p: int, h: int, w: int, context_ratio: float):
    """The three regions of each ROI (JAX ``ops.py:284-318``): the (3, R, P)
    ``hstart``, ``hend``, ``wstart`` and ``wend`` of the roi windows twice,
    then of the context window, and the (3, R, 4) rectangles (x1, y1, x2,
    y2) whose strict inside each region leaves out: none, the inner box,
    the ROI."""
    b = boxes.float()
    x1, y1, x2, y2 = (_c_round(b[:, i] * _t(scale, b)) for i in range(4))
    bw = (b[:, 2] - b[:, 0]).double()
    bh = (b[:, 3] - b[:, 1]).double()
    # XLA contracts ``bw - bw / cr`` and ``bw * cr - bw`` into fused
    # multiply-adds (the division a product by the reciprocal): in float64
    # both products and differences are exact, so one rounding to float32
    # gives the fused result
    inv_cr = float(np.float32(1) / np.float32(context_ratio))
    cr = float(np.float32(context_ratio))
    in_w, in_h = ((v - v * inv_cr).float() * 0.5 for v in (bw, bh))
    out_w, out_h = ((v * cr - v).float() * 0.5 for v in (bw, bh))
    img_w, img_h = float(np.float32(w / scale)), float(np.float32(h / scale))
    sc = _t(scale, b)

    def rnd(v, hi):
        return _c_round(v.clamp(0.0, hi) * sc)

    inner = (rnd(b[:, 0] + in_w, img_w), rnd(b[:, 1] + in_h, img_h), rnd(b[:, 2] - in_w, img_w),
             rnd(b[:, 3] - in_h, img_h))
    outer = (rnd(b[:, 0] - out_w, img_w), rnd(b[:, 1] - out_h, img_h), rnd(b[:, 2] + out_w, img_w),
             rnd(b[:, 3] + out_h, img_h))
    roi_bins = _bins(x1, y1, x2, y2, p, h, w)
    ctx_bins = _bins(*outer, p, h, w)
    bins = [torch.stack([roi_bins[i], roi_bins[i], ctx_bins[i]]) for i in range(4)]
    none = torch.zeros_like(x1)
    excl = torch.stack([torch.stack([none] * 4, -1), torch.stack(inner, -1), torch.stack((x1, y1, x2, y2), -1)])
    return bins, excl


def _bucket_sizes(largest: int) -> np.ndarray:
    """1, 2, 3, 4, 6, 8, 12, 16, ...: the window extents a chunk rounds up
    to (at most 1.5x the extent), up to ``largest``."""
    sizes, k = [1, 2, 3], 2
    while sizes[-1] < largest:
        sizes += [2 ** k, 3 * 2 ** (k - 1)]
        k += 1
    return np.asarray(sizes, np.int64)


def _loop_pool_plan(extent, per_roi: int, budget: int):
    """Chunks of ROIs whose bins' largest windows (``extent`` (3, R, 2)
    numpy: each region's rows and columns) round up to the same (Hb, Wb) of
    ``_bucket_sizes``, each chunk holding at most ``budget`` gathered
    elements (at least one ROI): a list of (region, first, last, Hb, Wb)
    slices of the returned order, the (region, roi) of the chunks' rows."""
    sizes = _bucket_sizes(int(extent.max(initial=1)))
    chunks, order = [], []
    for g in range(extent.shape[0]):
        r = extent.shape[1]
        hb = sizes[np.searchsorted(sizes, extent[g, :, 0])]
        wb = sizes[np.searchsorted(sizes, extent[g, :, 1])]
        idx = np.lexsort((np.arange(r), wb, hb))
        bounds = np.flatnonzero(np.diff(hb[idx] * (sizes[-1] + 1) + wb[idx])) + 1
        for seg in np.split(idx, bounds):
            if not seg.size:
                continue
            h, w = int(hb[seg[0]]), int(wb[seg[0]])
            n = max(1, budget // (h * w * per_roi))
            for i in range(0, seg.size, n):
                part = seg[i:i + n]
                chunks.append((g, len(order), len(order) + part.size, h, w))
                order.extend(g * r + part)
    return chunks, np.asarray(order, np.int64)


def _masked(pixels: torch.Tensor, index: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The (n, P, P, Hb, Wb, C) window values, -inf outside the windows."""
    return torch.where(mask[..., None], pixels[index], float("-inf"))


def _loop_pool_max(v: torch.Tensor) -> torch.Tensor:
    """(n, P, P, Hb, Wb, C) masked window values -> (n, P, P, C): the
    maximum over each column's rows, then over the columns, floored at 0,
    in the JAX package's two stages."""
    out = v.amax(dim=3).amax(dim=3)
    return torch.maximum(out, torch.zeros_like(out))


def _loop_pool_max_backward(v: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """The gradient of ``_loop_pool_max`` in ``v`` for the cotangent
    ``grad`` (n, P, P, C), as autograd forms it from ``torch.maximum`` and
    ``amax`` (JAX's rule too): half of it to the floor where the maximum is
    exactly 0, and within each stage a tie's share split evenly (divided by
    the count, then masked)."""
    col = v.amax(dim=3)
    pre = col.amax(dim=3)
    g = torch.where(pre > 0, grad, torch.where(pre == 0, grad / 2, torch.zeros_like(grad)))
    tie_c = col == pre[:, :, :, None]
    g_col = torch.where(tie_c, (g / tie_c.sum(dim=3))[:, :, :, None], 0.0)
    tie_r = v == col[:, :, :, None]
    return torch.where(tie_r, (g_col / tie_r.sum(dim=3))[:, :, :, None], 0.0)


class _LoopPool:
    """The windows of one roi_loop_pool call and their chunks."""

    def __init__(self, features, boxes, batch_indices, scale, p, context_ratio, budget):
        bimg, h, w, c = features.shape
        r = boxes.shape[0]
        self.p = p
        (self.hs, self.he, self.ws, self.we), self.excl = _loop_pool_regions(boxes, scale, p, h, w, context_ratio)
        self.bidx = batch_indices.long()
        extent = torch.stack([(self.he - self.hs).amax(-1), (self.we - self.ws).amax(-1)], -1).clamp(min=1)
        self.chunks, order = _loop_pool_plan(extent.cpu().numpy(), p * p * c, budget)  # one copy to the host
        inverse = np.empty_like(order)
        inverse[order] = np.arange(order.size)
        both = torch.from_numpy(np.concatenate([order % max(r, 1), inverse])).to(boxes.device, non_blocking=True)
        self.rois, self.inverse = both[:order.size], both[order.size:]
        self.shape = (h, w)

    def index(self, chunk):
        """The (n, P, P, Hb, Wb) windows' pixels, as rows of the map viewed
        as (B*H*W, C), and their membership."""
        g, a, b, hb, wb = chunk
        rois = self.rois[a:b]
        h, w = self.shape
        dev = rois.device
        rows = self.hs[g, rois][:, :, None] + torch.arange(hb, device=dev)  # (n, P, Hb)
        cols = self.ws[g, rois][:, :, None] + torch.arange(wb, device=dev)  # (n, P, Wb)
        ex1, ey1, ex2, ey2 = self.excl[g, rois].unbind(-1)
        row_ok = rows < self.he[g, rois][:, :, None]
        col_ok = cols < self.we[g, rois][:, :, None]
        in_r = (rows > ey1[:, None, None]) & (rows < ey2[:, None, None])
        in_c = (cols > ex1[:, None, None]) & (cols < ex2[:, None, None])
        rr, cc = (slice(None), slice(None), None, slice(None), None), (slice(None), None, slice(None), None, slice(None))
        mask = row_ok[rr] & col_ok[cc] & ~(in_r[rr] & in_c[cc])
        index = (self.bidx[rois][:, None, None, None, None] * h + rows.clamp(max=h - 1)[rr]) * w + cols.clamp(
            max=w - 1)[cc]
        return index, mask


class _RoiLoopPoolFn(torch.autograd.Function):
    """Forward chunk by chunk; the backward gathers each chunk again and
    adds its windows' gradients into the map, so that no chunk's windows
    outlive it."""

    @staticmethod
    def forward(ctx, features, plan: _LoopPool):
        ctx.plan = plan
        ctx.save_for_backward(features)
        c = features.shape[-1]
        pixels = features.reshape(-1, c)
        outs = [_loop_pool_max(_masked(pixels, *plan.index(chunk))) for chunk in plan.chunks]
        out = torch.cat(outs) if outs else features.new_zeros((0, plan.p, plan.p, c))
        return out[plan.inverse]

    @staticmethod
    def backward(ctx, grad):
        (features,) = ctx.saved_tensors
        plan = ctx.plan
        grad = grad[torch.argsort(plan.inverse)]  # the chunks' row order
        c = features.shape[-1]
        pixels = features.detach().reshape(-1, c)
        out = torch.zeros_like(pixels)
        for chunk in plan.chunks:
            index, mask = plan.index(chunk)
            g = _loop_pool_max_backward(_masked(pixels, index, mask), grad[chunk[1]:chunk[2]])
            out.index_add_(0, index.reshape(-1), g.reshape(-1, c))
        return out.reshape(features.shape), None


def roi_loop_pool(
    features: torch.Tensor,  # (B, H, W, C)
    boxes: torch.Tensor,  # (R, 4) XYXY in image coordinates
    batch_indices: torch.Tensor,  # (R,)
    spatial_scale: float,
    output_size: int = 7,
    context_ratio: float = 1.8,
) -> torch.Tensor:
    """ContextLocNet's ROILoopPool (JAX package ``wsl/ops.py:219``, the
    reference's ``csrc/ROILoopPool``): RoIPool-style integer max pooling of
    three regions of each ROI, in block order [roi, frame, context] ->
    (3R, P, P, C). The roi region is the ROI's fixed grid of floor/ceil
    bins; the frame the same bins without the pixels strictly inside the
    inner box (the ROI shrunk by ``context_ratio`` about its centre); the
    context the bins of the outer box (grown by ``context_ratio``, clamped
    to the image) without the pixels strictly inside the ROI. Each bin is
    the maximum over its window's rows for each column, then over the
    columns, floored at 0 (an empty window pools 0).

    The JAX package masks the whole map for each ROI and bin row; here each
    bin gathers only its window, (P, P, Hb, Wb, C) a ROI with Hb x Wb its
    chunk's window extent (the largest of its bins', rounded up by
    ``_bucket_sizes``), and each chunk holds at most
    ``_LOOP_CHUNK_ELEMENTS`` elements, in the forward and again in the
    backward. The chunks are
    planned on the host from the windows' extents: one copy to the host
    and one back a call."""
    plan = _LoopPool(features, boxes, batch_indices, spatial_scale, output_size, context_ratio, _LOOP_CHUNK_ELEMENTS)
    return _RoiLoopPoolFn.apply(features, plan)


def roi_label(
    scores: torch.Tensor,  # (B, R, C) proposal class scores, -inf on rows not to mine
    ious: torch.Tensor,  # (B, R, R) proposal IoU
    image_labels: torch.Tensor,  # (B, C) multi-hot
    class_weights: torch.Tensor,  # (B, C)
    fg_threshold: float = 0.5,
    bg_threshold_hi: float = 0.5,
    bg_threshold_lo: float = -1.0,
    top_k: int = 1,
):
    """CMIL's ROILabel (JAX package ``wsl/ops.py:332``, the reference's
    ``csrc/ROILabel``): for each present class in turn, its ``top_k``
    highest-scoring proposals not mined before (for any class; the first
    maximum), then each proposal labelled by the mined proposal it overlaps
    most: that class at IoU >= ``fg_threshold``, the background (C) in
    [``bg_threshold_lo``, ``bg_threshold_hi``), else ignored (weight 0,
    the class kept); the weight is the mined class's ``class_weights``
    entry, with its gradient. The reference's random fg/bg caps are
    ignored, as in the JAX package. Returns (B, R) ``label``, ``weight``,
    ``matched_idx`` and ``max_iou``, and (B, C * top_k) ``mined_idx`` (-1
    where none) and ``mined_ok``."""
    b, r, c = scores.shape
    present = image_labels > 0
    taken = torch.zeros((b, r), dtype=torch.bool, device=scores.device)
    neg_inf = torch.full_like(scores[..., 0], float("-inf"))
    mined_idx, mined_ok = [], []
    for ci in range(c):
        for _ in range(top_k):
            col = torch.where(taken, neg_inf, scores[..., ci])
            idx = col.argmax(dim=1, keepdim=True)  # the first maximum, as jnp.argmax
            ok = present[:, ci:ci + 1] & torch.isfinite(col.gather(1, idx))
            mined_idx.append(torch.where(ok, idx, torch.full_like(idx, -1)))
            mined_ok.append(ok)
            taken = taken.scatter(1, idx, taken.gather(1, idx) | ok)
    mined_idx = torch.cat(mined_idx, 1)  # (B, G)
    mined_ok = torch.cat(mined_ok, 1)
    g = mined_idx.shape[1]
    mined_cls = torch.arange(c, device=scores.device).repeat_interleave(top_k)
    iou = torch.gather(ious, 2, mined_idx.clamp(min=0)[:, None, :].expand(b, r, g))
    iou = torch.where(mined_ok[:, None, :], iou, torch.full_like(iou, float("-inf")))
    best = iou.amax(dim=-1)
    arg = iou.argmax(dim=-1)
    assign = mined_cls[arg]
    fg = best >= fg_threshold
    bg = ~fg & (best >= bg_threshold_lo) & (best < bg_threshold_hi)
    label = torch.where(fg | ~bg, assign, torch.full_like(assign, c))
    weight = torch.where(fg | bg, torch.gather(class_weights, 1, assign), torch.zeros_like(best))
    return {
        "label": label,
        "weight": weight,
        "matched_idx": torch.gather(mined_idx, 1, arg),
        "max_iou": best,
        "mined_idx": mined_idx,
        "mined_ok": mined_ok,
    }


def pcl_losses(
    pcl_probs: torch.Tensor,  # (B, R, 1+C) proposal probabilities, BACKGROUND FIRST
    labels: torch.Tensor,  # (B, R) cluster classes in [0, C], 0 the background
    cls_loss_weights: torch.Tensor,  # (B, R) the assigned cluster's score (0 ignores)
    gt_assignment: torch.Tensor,  # (B, R) each proposal's cluster, -1 for the background
    pc_labels: torch.Tensor,  # (B, G) each cluster's class, from 1
    pc_count: torch.Tensor,  # (B, G) each cluster's member count
    img_cls_loss_weights: torch.Tensor,  # (B, G) each cluster's summed member weights
    im_labels: torch.Tensor,  # (B, 1+C), 1 at 0 (the background is always present)
) -> torch.Tensor:
    """(B,) proposal-cluster-learning losses (JAX package ``wsl/ops.py:407``,
    the reference's ``csrc/pcl_loss`` forward normalised by R): each
    background proposal's weighted cross entropy on channel 0, plus, for
    each cluster of a present class, -weight * log of its members' mean
    probability at the cluster's class; both over R. Autograd gives the
    gradient, which the JAX docstring holds equal to the reference's
    hand-written backward."""
    b, r, k = pcl_probs.shape
    g = pc_labels.shape[-1]
    eps = 1e-6
    bg = (labels == 0) & (im_labels[:, :1] != 0)
    p_bg = pcl_probs[..., 0].clamp(min=eps)
    loss_bg = (-cls_loss_weights * torch.log(p_bg) * bg.to(pcl_probs.dtype)).sum(dim=-1)
    member = gt_assignment >= 0
    seg = torch.where(member, gt_assignment, torch.full_like(gt_assignment, g))
    cols = pc_labels.long().clamp(0, k - 1)
    p_at_cls = torch.gather(pcl_probs, 2, cols[:, None, :].expand(b, r, g))  # (B, R, G)
    onehot = (seg[..., None] == torch.arange(g, device=seg.device)).to(pcl_probs.dtype)
    pc_probs = (p_at_cls * onehot).sum(dim=1) / pc_count.clamp(min=1)
    present = torch.gather(im_labels, 1, pc_labels.long().clamp(0, k - 1)) != 0
    cluster_present = (pc_count > 0) & present & (pc_labels > 0)
    loss_fg = torch.where(
        cluster_present, -img_cls_loss_weights * torch.log(pc_probs.clamp(min=eps)), torch.zeros_like(pc_probs)
    ).sum(dim=-1)
    return (loss_bg + loss_fg) * _inv(max(r, 1), pcl_probs)


def crf_mean_field(
    unary: torch.Tensor,  # (B, H, W, K) class probabilities
    image: torch.Tensor,  # (B, H, W, 3) float
    num_iter: int = 5,
    pos_w: float = 3.0,
    pos_xy_std: float = 3.0,
    bi_w: float = 4.0,
    bi_xy_std: float = 49.0,
    bi_rgb_std: float = 5.0,
    num_bins: int = 16,
) -> torch.Tensor:
    """Dense-CRF mean field with Potts compatibility (JAX :452, standing in
    for the reference's ``csrc/crf``), float32, (B, H, W, K). The
    smoothness kernel is an exact separable Gaussian blur, two band
    matrices (zero padding: rows near the border sum to less than 1). The
    appearance kernel is a luminance bilateral grid: each image's
    probabilities are splatted into ``num_bins`` bins of its own luminance
    range (rounded half to even, as ``jnp.round``), each bin's slice takes
    the wide spatial blur, the bins mix by the range kernel and each pixel
    reads its own bin. Both messages are normalised and leave out the
    pixel's own term. Computes in float32 (float64 given float64)."""
    b, h, w, k = unary.shape
    dev = unary.device
    dt = torch.promote_types(unary.dtype, torch.float32)  # float32, or float64 given float64

    def blur_of(sigma):
        radius = max(int(2 * sigma), 1)
        coords = torch.arange(-radius, radius + 1, dtype=dt, device=dev)
        kern = torch.exp(-0.5 * (coords * _inv(sigma, coords)) ** 2)
        kern = kern / kern.sum()

        def band(n):
            offs = torch.arange(n, device=dev)[None, :] - torch.arange(n, device=dev)[:, None] + radius
            inside = (offs >= 0) & (offs < kern.shape[0])
            return torch.where(inside, kern[offs.clamp(0, kern.shape[0] - 1)], torch.zeros((), dtype=dt, device=dev))

        by, bx = band(h), band(w)

        def blur(x):  # (B, H, W, C)
            x = torch.einsum("ij,bjwc->biwc", by, x)
            return torch.einsum("ij,bhjc->bhic", bx, x)

        return blur, kern[radius] ** 2  # the 2-D self weight

    blur_pos, c_pos = blur_of(pos_xy_std)
    blur_bi, c_bi = blur_of(bi_xy_std)
    den_pos = blur_pos(torch.ones((1, h, w, 1), dtype=dt, device=dev)) - c_pos

    lum = image.to(dt).mean(dim=-1)  # (B, H, W)
    lo, hi = lum.amin(dim=(1, 2), keepdim=True), lum.amax(dim=(1, 2), keepdim=True)
    span = (hi - lo).clamp(min=1e-6)
    z = torch.round((lum - lo) * ((num_bins - 1) / span)).clamp(0, num_bins - 1).long()
    onehot = (z[..., None] == torch.arange(num_bins, device=dev)).to(dt)  # (B, H, W, N)
    steps = (torch.arange(num_bins, device=dev)[:, None] - torch.arange(num_bins, device=dev)[None, :]).to(dt)
    d = steps[None] * (span * _inv(num_bins - 1, span))  # (B, N, N), in intensity units
    g_range = torch.exp(-0.5 * (d * _inv(bi_rgb_std, d)) ** 2)

    def bilateral(x):  # (B, H, W, C): splat, blur each bin, mix the bins, slice
        grid = onehot[..., None] * x[..., None, :]  # (B, H, W, N, C)
        grid = blur_bi(grid.reshape(b, h, w, -1)).reshape(b, h, w, num_bins, -1)
        grid = torch.einsum("bnm,bhwmx->bhwnx", g_range, grid)
        return torch.einsum("bhwn,bhwnx->bhwx", onehot, grid)

    den_bi = bilateral(torch.ones((b, h, w, 1), dtype=dt, device=dev)) - c_bi
    q = unary.to(dt)
    log_unary = torch.log(q.clamp(min=1e-8))
    eps = 1e-6
    for _ in range(num_iter):
        msg_pos = (blur_pos(q) - c_pos * q) / den_pos.clamp(min=eps)
        msg_bi = (bilateral(q) - c_bi * q) / den_bi.clamp(min=eps)
        q = torch.softmax(log_unary + pos_w * msg_pos + bi_w * msg_bi, dim=-1)
    return q


def csc_constraint(x: torch.Tensor, w: torch.Tensor, polar: bool = True) -> torch.Tensor:
    """The CSC spatial constraint (JAX :545, the reference's
    ``_CSCConstraint``): ``x`` times the positive part of the CSC weight
    ``w`` (``polar``) or the negated negative part; the weight carries no
    gradient."""
    w_ = w.clamp(min=0.0) if polar else -w.clamp(max=0.0)
    return x * w_.detach()
