"""Labelling and sampling of the second stage's proposals (reference:
detectron2/modeling/roi_heads/roi_heads.py:123 ``label_and_sample_proposals``;
JAX package ``roi_heads/proposal_sampling.py:23``
``sample_proposals_single``, here with the image axis written out).

Fixed shapes: every image gets exactly ``batch_size_per_image`` slots with a
validity mask. The three uniform draws are arguments (see ``ops.sampling``)."""

from __future__ import annotations

from typing import Dict

import torch

from ...ops.matcher import Matcher
from ...ops.sampling import subsample_labels
from ...structures.boxes import pairwise_iou
from ..proposal_generator.proposal_utils import add_ground_truth_to_proposals, topk_stable


def sample_proposals(
    proposals: torch.Tensor,  # (B, K, 4)
    proposal_scores: torch.Tensor,  # (B, K), -inf on padding
    gt_boxes: torch.Tensor,  # (B, G, 4)
    gt_classes: torch.Tensor,  # (B, G)
    gt_valid: torch.Tensor,  # (B, G)
    u_pos: torch.Tensor,  # (B, N) uniform draws, N = K (+ G with append_gt)
    u_neg: torch.Tensor,
    u_tie: torch.Tensor,
    *,
    num_classes: int,
    batch_size_per_image: int,
    positive_fraction: float,
    matcher: Matcher,
    append_gt: bool = True,
) -> Dict[str, torch.Tensor]:
    """Matches proposals to the ground truth, samples foreground and
    background with ``u_pos`` and ``u_neg``, and orders the sampled slots
    (foreground first, then background, each in ``u_tie`` order). Returns
    per image (B, S) ``boxes`` (B, S, 4), ``gt_classes`` (``num_classes``
    is background), ``gt_boxes`` (B, S, 4), ``matched_idx``, ``valid`` and
    ``fg``."""
    gt_valid = gt_valid.bool()
    if append_gt:
        proposals, proposal_scores = add_ground_truth_to_proposals(
            gt_boxes, gt_valid, proposals, proposal_scores
        )
    if proposals.shape[1] < batch_size_per_image:
        raise ValueError(
            f"{proposals.shape[1]} candidates cannot fill {batch_size_per_image} slots per image"
        )
    prop_valid = torch.isfinite(proposal_scores)
    iou = pairwise_iou(gt_boxes.to(torch.float32), proposals)  # (B, G, N)
    iou = torch.where(prop_valid[:, None, :], iou, torch.full_like(iou, -1.0))
    matched_idx, matched_labels = matcher(iou, gt_valid=gt_valid)

    classes = torch.where(
        matched_labels == 1, torch.gather(gt_classes.long(), 1, matched_idx),
        torch.full_like(matched_idx, num_classes),
    )
    sample_lbl = torch.where(
        prop_valid, matched_labels.to(torch.int32), torch.full_like(matched_labels, -1, dtype=torch.int32)
    )
    pos_mask, neg_mask = subsample_labels(
        sample_lbl, batch_size_per_image, positive_fraction, 0, u_pos, u_neg
    )
    neg_inf = torch.full_like(u_tie, float("-inf"))
    priority = torch.where(pos_mask, 2.0 + u_tie, torch.where(neg_mask, 1.0 + u_tie, neg_inf))
    vals, idx = topk_stable(priority, batch_size_per_image)
    valid = torch.isfinite(vals)
    sel_classes = torch.where(
        valid, torch.gather(classes, 1, idx), torch.full_like(idx, num_classes)
    )
    sel_matched = torch.gather(matched_idx, 1, idx)
    b, s = idx.shape
    return {
        "boxes": torch.gather(proposals, 1, idx[..., None].expand(b, s, 4)),
        "gt_classes": sel_classes,
        "gt_boxes": torch.gather(gt_boxes, 1, sel_matched[..., None].expand(b, s, 4)),
        "matched_idx": sel_matched,
        "valid": valid,
        "fg": valid & (sel_classes < num_classes),
    }
