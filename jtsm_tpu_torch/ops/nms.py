"""Exact greedy NMS returning keep-masks over fixed-size inputs.

Reference: detectron2/layers/nms.py:10 (``batched_nms`` with the class
offset trick); JAX package ``ops/nms.py`` :98 ``nms_mask`` and :174
``batched_nms_mask`` and their index forms :160 ``nms`` and :188
``batched_nms``, and the rotated forms :203-267 (``nms_rotated_mask``,
``batched_nms_rotated_mask``, ``nms_rotated``, ``batched_nms_rotated``),
whose semantics this module reproduces:

* boxes are visited in descending score order, ties in index order (a stable
  sort, like the JAX package's ``argsort(-scores)``);
* a box whose score is not finite (padding carries -inf) is never kept and
  suppresses nothing;
* every kept box suppresses each later box whose IoU with it exceeds the
  threshold.

Leading batch dimensions are independent problems, solved together. The
greedy pass runs tile by tile (the tiled scheme of the JAX package): inside a
tile a fixpoint resolves the survivors, each iteration of which reads one
flag back to the host; then one vectorised pass suppresses every later box
that a survivor overlaps. Host syncs are thus counted per tile, not per box.
"""

from __future__ import annotations

import torch

from ..structures.boxes import pairwise_iou
from ..structures.rotated_boxes import fma32, rotated_suppression


def _resolve_tile(iou_gt: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Exact greedy survivors within one tile.

    iou_gt: (..., T, T) bool, True where row i suppresses column j (i < j);
    valid: (..., T). A candidate with no live predecessor suppressing it is
    alive; everything an alive box suppresses is dead; repeat until nothing
    changes. Each round settles at least the first undecided box.
    """
    dead = torch.zeros_like(valid)
    alive = torch.zeros_like(valid)
    while True:
        candidates = valid & ~dead
        incoming = (iou_gt & candidates[..., :, None]).any(dim=-2)
        new_alive = candidates & ~incoming
        alive_now = alive | new_alive
        newly_dead = (iou_gt & alive_now[..., :, None]).any(dim=-2)
        new_dead = dead | (newly_dead & ~new_alive & valid)
        changed = bool(((new_dead != dead) | (new_alive & ~alive)).any())
        dead, alive = new_dead, alive_now
        if not changed:
            return valid & ~dead


def nms_mask(
    boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float, tile: int = 128
) -> torch.Tensor:
    """(..., N, 4) boxes and (..., N) scores -> (..., N) bool keep-mask."""
    n = boxes.shape[-2]
    if n == 0:
        return torch.zeros(scores.shape, dtype=torch.bool, device=scores.device)
    pad = 0 if n <= tile else (-n) % tile
    if pad:
        boxes = torch.cat([boxes, boxes.new_zeros(boxes.shape[:-2] + (pad, 4))], dim=-2)
        scores = torch.cat(
            [scores, scores.new_full(scores.shape[:-1] + (pad,), float("-inf"))], dim=-1
        )
    np_ = n + pad
    t = min(tile, np_)

    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    boxes_sorted = torch.gather(boxes, -2, order[..., None].expand(boxes.shape))
    keep_sorted = torch.isfinite(torch.gather(scores, -1, order))
    tri = torch.triu(torch.ones((t, t), dtype=torch.bool, device=boxes.device), diagonal=1)
    positions = torch.arange(np_, device=boxes.device)
    for start in range(0, np_, t):
        tile_boxes = boxes_sorted[..., start : start + t, :]
        iou_gt = (pairwise_iou(tile_boxes, tile_boxes) > iou_threshold) & tri
        survivors = _resolve_tile(iou_gt, keep_sorted[..., start : start + t])
        keep_sorted = keep_sorted.clone()
        keep_sorted[..., start : start + t] = survivors
        if start + t < np_:
            cross = pairwise_iou(tile_boxes, boxes_sorted) > iou_threshold
            suppressed = (cross & survivors[..., :, None]).any(dim=-2)
            keep_sorted = keep_sorted & ~(suppressed & (positions >= start + t))
    keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
    return keep[..., :n]


def batched_nms_mask(
    boxes: torch.Tensor, scores: torch.Tensor, idxs: torch.Tensor, iou_threshold: float
) -> torch.Tensor:
    """Class-aware NMS by the coordinate-offset trick: boxes of different
    ``idxs`` are shifted into disjoint regions, so one pass never suppresses
    across categories. Shapes as in :func:`nms_mask`."""
    if boxes.shape[-2] == 0:
        return torch.zeros(scores.shape, dtype=torch.bool, device=scores.device)
    live = torch.where(torch.isfinite(scores)[..., None], boxes, torch.zeros_like(boxes))
    max_coord = live.flatten(-2).amax(dim=-1) + 1.0
    offsets = idxs.to(boxes.dtype) * max_coord[..., None]
    return nms_mask(boxes + offsets[..., None], scores, iou_threshold)


def _kept_indices(keep: torch.Tensor, scores: torch.Tensor, max_out) -> torch.Tensor:
    """The indices of the kept boxes by descending score (ties in index
    order, as ``lax.top_k``), padded with -1 up to ``max_out`` (or N)."""
    n = scores.shape[-1]
    k = n if max_out is None else max_out
    masked = torch.where(keep, scores, torch.full_like(scores, float("-inf")))
    top, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    top, idx = top[..., : min(k, n)], idx[..., : min(k, n)]
    out = torch.where(torch.isfinite(top), idx, torch.full_like(idx, -1))
    if k > n:
        out = torch.cat([out, out.new_full(out.shape[:-1] + (k - n,), -1)], dim=-1)
    return out


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float, max_out=None) -> torch.Tensor:
    """(N, 4) boxes and (N,) scores -> the kept indices sorted by score,
    padded with -1 up to ``max_out`` (or N) (JAX package ``ops/nms.py:160``)."""
    return _kept_indices(nms_mask(boxes, scores, iou_threshold), scores, max_out)


def batched_nms(
    boxes: torch.Tensor, scores: torch.Tensor, idxs: torch.Tensor, iou_threshold: float, max_out=None
) -> torch.Tensor:
    """:func:`nms` per category of ``idxs`` (JAX package ``ops/nms.py:188``)."""
    return _kept_indices(batched_nms_mask(boxes, scores, idxs, iou_threshold), scores, max_out)


# ---------------------------------------------------------------------------
# Rotated NMS (reference: layers/csrc/nms_rotated/; JAX package
# ``ops/nms.py:203-267``)
# ---------------------------------------------------------------------------


def _greedy_over(suppress: torch.Tensor, valid: torch.Tensor, tile: int = 128) -> torch.Tensor:
    """The exact greedy survivors (..., N) of boxes in NMS order, given the
    (..., N, N) upper-triangular matrix of which box suppresses which and
    their ``valid`` mask: tile by tile, the tile's fixpoint, then one pass
    over the later boxes (as :func:`nms_mask` does with the IoU)."""
    n = valid.shape[-1]
    keep = valid.clone()
    for start in range(0, n, tile):
        stop = min(n, start + tile)
        survivors = _resolve_tile(suppress[..., start:stop, start:stop], keep[..., start:stop])
        keep[..., start:stop] = survivors
        if stop < n:
            hit = (suppress[..., start:stop, stop:] & survivors[..., :, None]).any(dim=-2)
            keep[..., stop:] &= ~hit
    return keep


def nms_rotated_mask(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Greedy NMS on (..., N, 5) rotated boxes with the exact rotated IoU:
    (..., N) bool keep-mask, the rules of this module's docstring (JAX
    package ``ops/nms.py:203``, whose loop visits every sorted box). Only
    the pairs whose circles meet are clipped
    (``structures.rotated_boxes.rotated_suppression``)."""
    n = boxes.shape[-2]
    if n == 0:
        return torch.zeros(scores.shape, dtype=torch.bool, device=scores.device)
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    boxes_sorted = torch.gather(boxes, -2, order[..., None].expand(boxes.shape)).reshape(-1, n, 5)
    valid = torch.isfinite(torch.gather(scores, -1, order)).reshape(-1, n)
    suppress = torch.stack([rotated_suppression(b, v, iou_threshold) for b, v in zip(boxes_sorted, valid)])
    keep_sorted = _greedy_over(suppress, valid).reshape(order.shape)
    return torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)


def batched_nms_rotated_mask(
    boxes: torch.Tensor, scores: torch.Tensor, idxs: torch.Tensor, iou_threshold: float
) -> torch.Tensor:
    """Class-aware rotated NMS (reference layers/nms.py:103; JAX package
    ``ops/nms.py:226``): every centre moves by its class times one more
    than the largest corner extent of the finite-score boxes, in float32
    with one rounding (a fused multiply-add, as XLA computes the JAX
    package's offset) so that near-threshold keeps agree; then one NMS."""
    if boxes.shape[-2] == 0:
        return torch.zeros(scores.shape, dtype=torch.bool, device=scores.device)
    extent = torch.where(torch.isfinite(scores)[..., None], boxes[..., :2] + boxes[..., 2:4] / 2,
                         torch.zeros_like(boxes[..., :2]))
    max_coord = extent.flatten(-2).amax(dim=-1) + 1.0
    idx = idxs.to(boxes.dtype)[..., None].expand(boxes[..., :2].shape)
    centers = fma32(idx, max_coord[..., None, None].expand(idx.shape), boxes[..., :2])
    return nms_rotated_mask(torch.cat([centers, boxes[..., 2:]], dim=-1), scores, iou_threshold)


def nms_rotated(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float, max_out=None) -> torch.Tensor:
    """(N, 5) boxes and (N,) scores -> the kept indices sorted by score,
    padded with -1 up to ``max_out`` (or N) (JAX package ``ops/nms.py:242``)."""
    return _kept_indices(nms_rotated_mask(boxes, scores, iou_threshold), scores, max_out)


def batched_nms_rotated(
    boxes: torch.Tensor, scores: torch.Tensor, idxs: torch.Tensor, iou_threshold: float, max_out=None
) -> torch.Tensor:
    """:func:`nms_rotated` per category of ``idxs`` (JAX package ``ops/nms.py:255``)."""
    return _kept_indices(batched_nms_rotated_mask(boxes, scores, idxs, iou_threshold), scores, max_out)
