"""WSOD ROI-head pieces of the JTSM serving path (reference:
projects/WSL/wsl/modeling/roi_heads/box_head.py:106 and
fast_rcnn_oicr.py:712-786; JAX package ``wsl/modeling/roi_heads_wsl.py``
:68 ``DiscriminativeAdaptionNeck``, :108 ``wsl_inference_single``)."""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...layers import Linear
from ...modeling.proposal_generator.proposal_utils import topk_stable
from ...ops.nms import batched_nms_mask
from ...structures.boxes import clip_boxes, nonempty_boxes


class DiscriminativeAdaptionNeck(nn.Module):
    """The DAN: fully connected layers ``dan1``, ``dan2``, ... with ReLU and
    dropout (active only in train mode) over the pooled features flattened
    as detectron2 flattens them, (C, P, P); the converter turns the JAX
    package's (P, P, C) rows of ``dan1`` into that order."""

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (R, P, P, C) pooled features, or (R, D)."""
        if x.dim() > 2:
            x = x.permute(0, 3, 1, 2).flatten(1)
        for fc in self.fcs:
            x = F.relu(fc(x))
            if self.dropout > 0:
                x = F.dropout(x, self.dropout, self.training)
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
