"""Proposal selection (reference:
detectron2/modeling/proposal_generator/proposal_utils.py
``find_top_rpn_proposals``; JAX package ``proposal_utils.py``).

Fixed capacities: every stage works on fixed-K tensors whose padding scores
-inf, and the result is always (B, POST_NMS_TOPK) boxes and scores."""

from __future__ import annotations

from typing import List, Tuple

import torch

from ...ops.nms import nms_mask
from ...structures.boxes import clip_boxes, nonempty_boxes


def topk_stable(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last dim, ties in index order (the order of
    the JAX package's ``lax.top_k``)."""
    values, indices = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def find_top_rpn_proposals(
    proposals: List[torch.Tensor],  # per level (B, Ni, 4) decoded boxes
    scores: List[torch.Tensor],  # per level (B, Ni) objectness logits
    image_sizes: torch.Tensor,  # (B, 2) true (h, w)
    nms_thresh: float,
    pre_nms_topk: int,
    post_nms_topk: int,
    min_box_size: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, post_nms_topk, 4) boxes and (B, post_nms_topk) scores, -inf
    scores marking padding. Per level: top-k, clip, drop empty or non-finite
    boxes, NMS on each level on its own (the reference's level-keyed batched
    NMS never suppresses across levels); then the top-k over all levels."""
    b = image_sizes.shape[0]
    k_cap = min(pre_nms_topk, max(s.shape[-1] for s in scores))
    size = image_sizes.to(torch.float32)[:, None, :]
    lvl_boxes, lvl_scores = [], []
    for boxes, s in zip(proposals, scores):
        k = min(pre_nms_topk, s.shape[-1])
        topv, topi = topk_stable(s, k)
        bb = torch.gather(boxes, 1, topi[..., None].expand(b, k, 4))
        bb = clip_boxes(bb, size)
        keep = nonempty_boxes(bb, min_box_size) & torch.isfinite(bb).all(dim=-1)
        topv = torch.where(keep, topv, torch.full_like(topv, float("-inf")))
        if k < k_cap:
            bb = torch.cat([bb, bb.new_zeros((b, k_cap - k, 4))], dim=1)
            topv = torch.cat([topv, topv.new_full((b, k_cap - k), float("-inf"))], dim=1)
        lvl_boxes.append(bb)
        lvl_scores.append(topv)
    boxes = torch.stack(lvl_boxes, dim=1)  # (B, L, K, 4)
    scores = torch.stack(lvl_scores, dim=1)  # (B, L, K)
    keep = nms_mask(boxes, scores, nms_thresh)
    masked = torch.where(keep, scores, torch.full_like(scores, float("-inf"))).reshape(b, -1)
    boxes = boxes.reshape(b, -1, 4)
    k = min(post_nms_topk, masked.shape[1])
    top_scores, idx = topk_stable(masked, k)
    top_boxes = torch.gather(boxes, 1, idx[..., None].expand(b, k, 4))
    if post_nms_topk > k:
        pad = post_nms_topk - k
        top_boxes = torch.cat([top_boxes, top_boxes.new_zeros((b, pad, 4))], dim=1)
        top_scores = torch.cat([top_scores, top_scores.new_full((b, pad), float("-inf"))], dim=1)
    return top_boxes, top_scores


def add_ground_truth_to_proposals(
    gt_boxes: torch.Tensor,  # (B, G, 4)
    gt_valid: torch.Tensor,  # (B, G)
    proposals: torch.Tensor,  # (B, K, 4)
    scores: torch.Tensor,  # (B, K)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Appends the ground truth boxes as proposals of logit 10 (JAX
    ``proposal_utils.py:76``); padded rows score -inf, so they count as
    padding downstream."""
    gt_logit = torch.where(
        gt_valid.bool(), torch.full_like(gt_valid, 10.0, dtype=scores.dtype),
        torch.full_like(gt_valid, float("-inf"), dtype=scores.dtype),
    )
    return torch.cat([proposals, gt_boxes.to(proposals.dtype)], dim=1), torch.cat([scores, gt_logit], dim=1)
