"""MIL scoring layers, pseudo-ground-truth (PGT) mining and the OICR losses
(reference: projects/WSL/wsl/modeling/roi_heads/fast_rcnn_wsddn.py,
fast_rcnn_tsm.py:346,573-586, fast_rcnn_oicr.py:166,247-362,
roi_heads_jtsm.py:1038,1168; JAX package ``wsl/modeling/mil_heads.py`` :34
``MILOutputLayers``, :98 ``wsddn_scores``, :108 ``mil_image_loss``, :122
``OICROutputLayers``, :153-328 the mining and loss functions).

The layers compute in ``compute_dtype`` and return float32 logits, as the
JAX layers cast their outputs. The JAX functions take one image and are
vmapped by their callers; here every function takes a leading batch dim
(B, ...) and keeps the JAX package's fixed capacities and validity masks.
Top-k is a stable descending sort, so ties keep the lower index as
``lax.top_k`` does; ``argmax`` takes the first maximum on both sides. No
function reads a value back to the host."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ...layers import Linear
from ...modeling.proposal_generator.proposal_utils import topk_stable
from ...ops.losses import smooth_l1_loss, softmax_cross_entropy
from ...ops.nms import nms_mask
from ...structures.boxes import pairwise_iou


class MILOutputLayers(nn.Module):
    """Two linear branches, ``cls`` and ``det``, over the joint classes."""

    def __init__(self, input_size: int, num_classes: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cls = Linear(input_size, num_classes, compute_dtype=compute_dtype)
        self.det = Linear(input_size, num_classes, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.cls(x).float(), self.det(x).float()


def wsddn_scores(cls_logit: torch.Tensor, det_logit: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(..., R, C) logits and (..., R) validity -> (..., R, C) MIL scores: a
    softmax over classes times a softmax over the valid proposals (invalid
    ones score 0)."""
    s_cls = torch.softmax(cls_logit, dim=-1)
    v = valid[..., None]
    det = torch.where(v, det_logit, torch.full_like(det_logit, float("-inf")))
    s_det = torch.where(v, torch.softmax(det, dim=-2), torch.zeros_like(det))
    return s_cls * s_det


class OICROutputLayers(nn.Module):
    """One refinement branch: a (K+1)-way classifier ``refine_score`` and,
    with ``with_reg``, class-specific box deltas ``refine_reg`` over
    ``reg_classes`` (reference fast_rcnn_oicr.py:488)."""

    def __init__(self, input_size: int, num_classes: int, with_reg: bool = False, reg_classes: int = 1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.refine_score = Linear(input_size, num_classes + 1, compute_dtype=compute_dtype)
        self.refine_reg = (
            Linear(input_size, 4 * reg_classes, compute_dtype=compute_dtype) if with_reg else None
        )

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        deltas = None if self.refine_reg is None else self.refine_reg(x).float()
        return self.refine_score(x).float(), deltas


def mil_image_loss(proposal_scores: torch.Tensor, image_labels: torch.Tensor, mean_loss: bool = True) -> torch.Tensor:
    """(B, R, C) MIL scores and (B, C) multi-hot labels -> (B,) image-level
    binary cross entropy: the image score is the sum of the proposal scores,
    clamped to (0, 1); the mean over classes (``WSL.MEAN_LOSS``) or the
    sum."""
    img_score = proposal_scores.sum(dim=1).clamp(1e-6, 1.0 - 1e-6)
    labels = image_labels.float()
    bce = -(labels * torch.log(img_score) + (1 - labels) * torch.log(1 - img_score))
    return bce.mean(dim=-1) if mean_loss else bce.sum(dim=-1)


def _pgt_gather_boxes(boxes: torch.Tensor, topi: torch.Tensor) -> torch.Tensor:
    """(B, R, 4) shared or (B, R, C, 4) per-class boxes and (B, C, K)
    indices -> (B, C, K, 4) mined boxes: with per-class boxes the box of
    class c is that class's box."""
    b, c, k = topi.shape
    if boxes.dim() == 4:
        per_class = boxes.permute(0, 2, 1, 3)  # (B, C, R, 4)
        return torch.gather(per_class, 2, topi[..., None].expand(b, c, k, 4))
    return torch.gather(boxes, 1, topi.reshape(b, c * k, 1).expand(b, c * k, 4)).reshape(b, c, k, 4)


def _class_grid(b: int, c: int, k: int, device) -> torch.Tensor:
    return torch.arange(c, device=device)[None, :, None].expand(b, c, k)


def get_pgt_top_k(
    boxes: torch.Tensor,  # (B, R, 4) or (B, R, C, 4) per-class regressed
    scores: torch.Tensor,  # (B, R, C)
    valid: torch.Tensor,  # (B, R)
    image_labels: torch.Tensor,  # (B, C) multi-hot
    top_k: int = 1,
    img_weights: Optional[torch.Tensor] = None,  # (B, C)
) -> Dict[str, torch.Tensor]:
    """The ``top_k`` highest-scoring valid proposals of every present class
    (JAX :163): fixed (B, C, K) ``boxes`` (with a trailing 4), ``weight``,
    ``score``, ``valid``, ``classes`` and ``idx``. The weight is the image
    weight of the class where ``img_weights`` is given, else the mined
    score."""
    masked = torch.where(valid[..., None], scores, torch.full_like(scores, float("-inf")))
    topv, topi = topk_stable(masked.transpose(1, 2), top_k)  # (B, C, K)
    pgt_valid = (image_labels[..., None] > 0) & torch.isfinite(topv)
    zero = torch.zeros_like(topv)
    pgt_score = torch.where(pgt_valid, topv, zero)
    if img_weights is None:
        pgt_weight = pgt_score
    else:
        pgt_weight = torch.where(pgt_valid, img_weights[..., None].expand_as(topv), zero)
    b, c, k = topi.shape
    return {
        "boxes": _pgt_gather_boxes(boxes, topi),
        "weight": pgt_weight,
        "score": pgt_score,
        "valid": pgt_valid,
        "classes": _class_grid(b, c, k, topi.device),
        "idx": topi,
    }


def get_pgt_mist(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    image_labels: torch.Tensor,
    top_pct: float = 0.15,
    iou_thresh: float = 0.2,
    max_k: int = 32,
) -> Dict[str, torch.Tensor]:
    """MIST mining (JAX :202): the top ``top_pct`` of the valid proposals
    of every present class (at least one, at most ``max_k``), then one
    class-agnostic NMS at ``iou_thresh`` over all the candidates of an
    image. Weight and score are the mined score. Fields as
    :func:`get_pgt_top_k`."""
    b, r, c = scores.shape
    k = min(max_k, r)
    masked = torch.where(valid[..., None], scores, torch.full_like(scores, float("-inf")))
    topv, topi = topk_stable(masked.transpose(1, 2), k)  # (B, C, k)
    num_take = (valid.sum(dim=-1).float() * top_pct).to(torch.int32).clamp(min=1)
    in_pct = torch.arange(k, device=scores.device)[None, None, :] < num_take[:, None, None]
    cand_valid = (image_labels[..., None] > 0) & in_pct & torch.isfinite(topv)
    pgt_boxes = _pgt_gather_boxes(boxes, topi)
    flat_scores = torch.where(cand_valid, topv, torch.full_like(topv, float("-inf"))).reshape(b, c * k)
    keep = nms_mask(pgt_boxes.reshape(b, c * k, 4), flat_scores, iou_thresh).reshape(b, c, k)
    pgt_valid = cand_valid & keep
    pgt_score = torch.where(pgt_valid, topv, torch.zeros_like(topv))
    return {
        "boxes": pgt_boxes,
        "weight": pgt_score,
        "score": pgt_score,
        "valid": pgt_valid,
        "classes": _class_grid(b, c, k, topi.device),
        "idx": topi,
    }


def label_proposals_by_pgt(
    boxes: torch.Tensor,  # (B, R, 4)
    valid: torch.Tensor,  # (B, R)
    pgt: Dict[str, torch.Tensor],
    num_classes: int,
    fg_thresh: float = 0.5,
    bg_thresh: Optional[float] = None,
    iou_thresholds: Optional[Sequence[float]] = None,
    iou_labels: Optional[Sequence[int]] = None,
) -> Dict[str, torch.Tensor]:
    """Each proposal's (class, weight) from the mined PGT it overlaps most
    (JAX :246): IoU >= ``fg_thresh`` takes the PGT's class, anything else
    the background class ``num_classes``, with the matched PGT's weight;
    with ``bg_thresh`` the background between it and ``fg_thresh`` is
    ignored (weight 0). With ``iou_thresholds``/``iou_labels`` the
    Matcher's intervals decide (1 foreground, 0 background, -1 ignore). An
    image without any valid PGT weighs nothing. Returns (B, R) ``labels``,
    ``weights``, ``fg`` and (B, R, 4) ``matched_pgt_boxes``."""
    b, c, k = pgt["valid"].shape
    pgt_boxes = pgt["boxes"].reshape(b, c * k, 4)
    pgt_w = pgt["weight"].reshape(b, c * k)
    pgt_cls = pgt["classes"].reshape(b, c * k)
    pgt_valid = pgt["valid"].reshape(b, c * k)

    iou = pairwise_iou(boxes, pgt_boxes)  # (B, R, CK)
    iou = torch.where(pgt_valid[:, None, :], iou, torch.full_like(iou, -1.0))
    best = iou.amax(dim=-1)
    arg = iou.argmax(dim=-1)  # the first maximum, as jnp.argmax
    if iou_thresholds is not None:
        lab = torch.tensor(list(iou_labels), dtype=torch.int64, device=boxes.device)
        interval = sum((best >= t).long() for t in iou_thresholds)
        match_label = lab[interval]
        fg = match_label == 1
        ignore = match_label == -1
    else:
        fg = best >= fg_thresh
        ignore = (~fg) & (best >= bg_thresh) if bg_thresh is not None else torch.zeros_like(fg)
    labels = torch.where(fg, torch.gather(pgt_cls, 1, arg), torch.full_like(arg, num_classes))
    zero = torch.zeros_like(best)
    weights = torch.where(valid, torch.gather(pgt_w, 1, arg), zero)
    weights = torch.where(pgt_valid.any(dim=-1, keepdim=True), weights, zero)
    weights = torch.where(ignore, zero, weights)
    return {
        "labels": labels,
        "weights": weights,
        "matched_pgt_boxes": torch.gather(pgt_boxes, 1, arg[..., None].expand(b, arg.shape[1], 4)),
        "fg": fg & valid,
    }


def oicr_branch_loss(logits: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(B, R, K+1) logits, (B, R) labels and weights -> (B,) weighted cross
    entropy over each image's proposals, divided by its count of weighted
    proposals (JAX :304)."""
    ce = softmax_cross_entropy(logits, labels)
    return (ce * weights).sum(dim=-1) / (weights > 0).sum(dim=-1).float().clamp(min=1.0)


def oicr_branch_loss_terms(
    logits: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per image, the weighted cross entropy summed and the count of
    weights above 1e-12 (JAX :314): the caller sums both over the batch and
    divides once, the reference's batch-level normaliser."""
    ce = softmax_cross_entropy(logits, labels)
    return (ce * weights).sum(dim=-1), (weights > 1e-12).float().sum(dim=-1)


def oicr_reg_loss_sum(
    deltas: torch.Tensor,  # (B, R, reg_classes * 4)
    labels: torch.Tensor,  # (B, R)
    weights: torch.Tensor,  # (B, R)
    fg: torch.Tensor,  # (B, R) bool
    prop_boxes: torch.Tensor,  # (B, R, 4)
    pgt_boxes: torch.Tensor,  # (B, R, 4) matched PGT boxes
    box2box_transform,
    beta: float = 0.0,
) -> torch.Tensor:
    """Per image (B,), the weighted smooth-L1 of each foreground proposal's
    class delta block against the deltas to its matched PGT box, summed
    (JAX :328); the caller divides by the batch's proposal count."""
    b, r = labels.shape
    t = box2box_transform.get_deltas(prop_boxes, pgt_boxes)
    if deltas.shape[-1] == 4:
        d = deltas
    else:
        nrc = deltas.shape[-1] // 4
        idx = labels.long().clamp(0, nrc - 1)
        d = torch.gather(deltas.reshape(b, r, nrc, 4), 2, idx[..., None, None].expand(b, r, 1, 4))[:, :, 0]
    per = smooth_l1_loss(d, t, beta).sum(dim=-1)
    return (per * weights * fg.to(per.dtype)).sum(dim=-1)
