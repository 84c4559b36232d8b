"""WSOD ROI-head pieces of the JTSM path (reference:
projects/WSL/wsl/modeling/roi_heads/roi_heads.py:146, roi_heads_jtsm.py:166,
box_head.py:106 and fast_rcnn_oicr.py:712-786; JAX package
``wsl/modeling/roi_heads_wsl.py`` :50 ``image_level_gt``, :56
``image_level_gt_stuff``, :68 ``DiscriminativeAdaptionNeck``, :108
``wsl_inference_single``)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...layers import Linear
from ...modeling.proposal_generator.proposal_utils import topk_stable
from ...ops.nms import batched_nms_mask
from ...structures.boxes import clip_boxes, nonempty_boxes


def image_level_gt(gt_classes: torch.Tensor, gt_valid: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(B, G) classes and validity -> (B, C) float multi-hot image labels."""
    oh = F.one_hot(gt_classes.long().clamp(0, num_classes - 1), num_classes).float()
    return (oh * gt_valid[..., None].float()).sum(dim=1).clamp(0, 1)


def image_level_gt_stuff(gt_sem_seg: torch.Tensor, num_stuff: int, ignore_value: int = 255) -> torch.Tensor:
    """(B, H, W) stuff labels -> (B, num_stuff) float presence of each class
    (pixels of ``ignore_value`` or outside [0, num_stuff) count for none)."""
    b = gt_sem_seg.shape[0]
    s = gt_sem_seg.reshape(b, -1).long()
    ok = (s != ignore_value) & (s >= 0) & (s < num_stuff)
    present = torch.zeros((b, num_stuff + 1), dtype=torch.float32, device=gt_sem_seg.device)
    present.scatter_(1, torch.where(ok, s, torch.full_like(s, num_stuff)), 1.0)
    return present[:, :num_stuff]


class DiscriminativeAdaptionNeck(nn.Module):
    """The DAN: fully connected layers ``dan1``, ``dan2``, ... with ReLU and
    dropout over the pooled features flattened as detectron2 flattens them,
    (C, P, P); the converter turns the JAX package's (P, P, C) rows of
    ``dan1`` into that order. Dropout acts in train mode only, as flax's
    does: each unit is kept where a uniform draw from ``generator`` (None:
    PyTorch's default generator) is below 1 - p, and kept units are scaled
    by 1 / (1 - p)."""

    def __init__(self, input_size: int, dims: Sequence[int] = (4096, 4096), dropout: float = 0.5,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fcs = []
        for i, d in enumerate(dims):
            fc = Linear(input_size, d, compute_dtype=compute_dtype)
            self.add_module(f"dan{i + 1}", fc)
            self.fcs.append(fc)
            input_size = d
        self.dropout = dropout
        self.output_size = input_size

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (R, P, P, C) pooled features, or (R, D)."""
        if x.dim() > 2:
            x = x.permute(0, 3, 1, 2).flatten(1)
        keep = 1.0 - self.dropout
        for fc in self.fcs:
            x = F.relu(fc(x))
            if self.training and self.dropout > 0:
                kept = torch.rand(x.shape, generator=generator, device=x.device) < keep
                x = torch.where(kept, x / keep, torch.zeros_like(x))
        return x


def wsl_inference(
    boxes: torch.Tensor,  # (B, R, 4) proposals, or (B, R, C, 4) per-class boxes
    scores: torch.Tensor,  # (B, R, C) class probabilities
    valid: torch.Tensor,  # (B, R)
    image_sizes: torch.Tensor,  # (B, 2)
    score_thresh: float,
    nms_thresh: float,
    topk_per_image: int,
    nms_candidates: int = 1024,
) -> Dict[str, torch.Tensor]:
    """Per image: clip, threshold the probabilities, take the top
    ``nms_candidates`` of the R x C grid, class-aware NMS, then the top
    ``topk_per_image``; ``prop_idx`` is each detection's source proposal.
    Ties keep the lower index (stable sorts, as ``lax.top_k``)."""
    b, r, c = scores.shape
    if boxes.dim() == 3:
        boxes = boxes[:, :, None, :].expand(b, r, c, 4)
    size = image_sizes.to(boxes.dtype)[:, None, None, :]
    flat_boxes = clip_boxes(boxes, size).reshape(b, -1, 4)
    flat_scores = scores.reshape(b, -1)
    keepable = (
        (scores > score_thresh).reshape(b, -1)
        & valid.repeat_interleave(c, dim=1)
        & nonempty_boxes(flat_boxes)
    )
    flat_scores = torch.where(keepable, flat_scores, torch.full_like(flat_scores, float("-inf")))
    cc = min(nms_candidates, flat_scores.shape[1])
    cand_scores, cand_idx = topk_stable(flat_scores, cc)
    cand_boxes = torch.gather(flat_boxes, 1, cand_idx[..., None].expand(b, cc, 4))
    cand_classes = (cand_idx % c).to(torch.int32)
    keep = batched_nms_mask(cand_boxes, cand_scores, cand_classes, nms_thresh)
    final = torch.where(keep, cand_scores, torch.full_like(cand_scores, float("-inf")))
    k = min(topk_per_image, cc)
    top_scores, top_i = topk_stable(final, k)
    out_valid = torch.isfinite(top_scores)
    out = {
        "boxes": torch.gather(cand_boxes, 1, top_i[..., None].expand(b, k, 4)),
        "scores": torch.where(out_valid, top_scores, torch.zeros_like(top_scores)),
        "classes": torch.gather(cand_classes, 1, top_i),
        "valid": out_valid,
        "prop_idx": (torch.gather(cand_idx, 1, top_i) // c).to(torch.int32),
    }
    if topk_per_image > k:
        pad = topk_per_image - k
        out = {key: torch.cat([v, v.new_zeros((b, pad) + v.shape[2:])], dim=1) for key, v in out.items()}
    return out
