"""Elementwise losses of the detectors (reference: fvcore's
``smooth_l1_loss`` and ``giou_loss`` as detectron2's RPN and Fast R-CNN
use them; JAX package ``ops/losses.py`` :17, :25, :52, :65, :74). Each returns per-element (or
per-row) losses; the callers mask and normalise."""

from __future__ import annotations

import torch


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor, beta: float) -> torch.Tensor:
    """Huber loss per element; beta below 1e-5 is the L1 loss, as in fvcore."""
    diff = (pred - target).abs()
    if beta < 1e-5:
        return diff
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def _floor(x: torch.Tensor, lo: float) -> torch.Tensor:
    """max(x, lo) with ``jnp.maximum``'s gradient: half to each side where
    they tie (``clamp`` passes all of it), as ``jnp.clip`` gives it."""
    return torch.maximum(x, x.new_full((), lo))


def giou_loss(pred_boxes: torch.Tensor, target_boxes: torch.Tensor) -> torch.Tensor:
    """1 - GIoU per box of aligned (..., 4) XYXY boxes, as the JAX package
    computes it (``ops/losses.py:25-49``): the intersection's sides and
    both areas' sides clipped at 0, the IoU over the union floored at 1e-7,
    the enclosing box's area (unclipped) floored at 1e-7 where it divides.
    The gradient at a tie (a degenerate box, boxes that touch) is JAX's."""
    px0, py0, px1, py1 = pred_boxes.unbind(-1)
    tx0, ty0, tx1, ty1 = target_boxes.unbind(-1)
    inter = (_floor(torch.minimum(px1, tx1) - torch.maximum(px0, tx0), 0.0)
             * _floor(torch.minimum(py1, ty1) - torch.maximum(py0, ty0), 0.0))
    area_p = _floor(px1 - px0, 0.0) * _floor(py1 - py0, 0.0)
    area_t = _floor(tx1 - tx0, 0.0) * _floor(ty1 - ty0, 0.0)
    union = area_p + area_t - inter
    iou = inter / _floor(union, 1e-7)
    area_c = (torch.maximum(px1, tx1) - torch.minimum(px0, tx0)) * (torch.maximum(py1, ty1) - torch.minimum(py0, ty0))
    giou = iou - (area_c - union) / _floor(area_c, 1e-7)
    return 1.0 - giou


def binary_cross_entropy_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Binary cross entropy per element, in the JAX package's stable form."""
    return logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor, alpha: float = 0.25,
                       gamma: float = 2.0) -> torch.Tensor:
    """Focal loss per element for targets in {0, 1} (RetinaNet's, in the JAX
    package's form: the stable binary cross entropy times (1 - p_t)^gamma
    and, for ``alpha`` >= 0, the alpha weighting; a negative ``alpha``
    turns the weighting off). At ``gamma`` 0 the factor is 1, and so is
    its gradient where p_t saturates to 1 (a power's gradient there is
    0 * inf in PyTorch, 0 in JAX)."""
    ce = binary_cross_entropy_with_logits(logits, targets)
    loss = ce
    if gamma != 0:
        p = torch.sigmoid(logits)
        p_t = p * targets + (1 - p) * (1 - targets)
        loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return loss


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Cross entropy per row of (..., K) logits for integer labels; labels
    out of range are clamped into it, so the caller masks those rows."""
    logz = torch.logsumexp(logits, dim=-1)
    idx = labels.long().clamp(0, logits.shape[-1] - 1)
    return logz - torch.gather(logits, -1, idx[..., None])[..., 0]
