"""Fast R-CNN output layers, losses and fixed-capacity inference
(reference: detectron2/modeling/roi_heads/fast_rcnn.py:46
``fast_rcnn_inference``, :144 the losses, :369 ``FastRCNNOutputLayers``; JAX
package ``roi_heads/fast_rcnn.py`` :58-160).

Inference keeps a fixed budget: the top ``nms_candidates`` of the R x K
score grid after thresholding go through class-aware NMS, and the result is
(B, DETECTIONS_PER_IMAGE) detections with a validity mask."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ...layers import Linear, normal
from ...ops.box_regression import Box2BoxTransform
from ...ops.losses import giou_loss, smooth_l1_loss, softmax_cross_entropy
from ...ops.nms import batched_nms_mask
from ...structures.boxes import clip_boxes, nonempty_boxes
from ..proposal_generator.proposal_utils import topk_stable


class FastRCNNOutputLayers(nn.Module):
    """(K+1)-way classification and per-class box deltas, computed in
    ``compute_dtype`` and returned in float32 (JAX ``fast_rcnn.py:55``)."""

    def __init__(self, input_size: int, num_classes: int, cls_agnostic_bbox_reg: bool = False, box_dim: int = 4,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cls_score = Linear(input_size, num_classes + 1, compute_dtype=compute_dtype, kernel_init=normal(0.01))
        num_bbox_reg_classes = 1 if cls_agnostic_bbox_reg else num_classes
        self.bbox_pred = Linear(input_size, num_bbox_reg_classes * box_dim, compute_dtype=compute_dtype,
                                kernel_init=normal(0.001))

    def forward(self, x: torch.Tensor):
        x = x.flatten(1)
        return self.cls_score(x).float(), self.bbox_pred(x).float()


def fast_rcnn_losses(
    scores: torch.Tensor,  # (N, K+1) logits
    deltas: torch.Tensor,  # (N, K*4) or (N, 4)
    proposal_boxes: torch.Tensor,  # (N, 4)
    gt_classes: torch.Tensor,  # (N,) in [0, K]; K is background
    gt_boxes: torch.Tensor,  # (N, 4) matched ground truth box of each slot
    valid: torch.Tensor,  # (N,) sampled slots
    box2box_transform: Box2BoxTransform,
    num_classes: int,
    smooth_l1_beta: float = 0.0,
    box_reg_loss_type: str = "smooth_l1",
) -> Dict[str, torch.Tensor]:
    """Softmax cross entropy over the valid slots and, on the foreground
    slots' deltas of their class, smooth-L1 or (``box_reg_loss_type``
    giou) the GIoU loss of the boxes they decode to, both over the number
    of valid slots (JAX ``fast_rcnn.py:58-95``). As in the JAX package,
    ROI_BOX_HEAD.BBOX_REG_LOSS_WEIGHT does not scale ``loss_box_reg``
    (ROADMAP §3)."""
    valid_f = valid.to(torch.float32)
    normalizer = valid_f.sum().clamp(min=1.0)
    loss_cls = (softmax_cross_entropy(scores, gt_classes) * valid_f).sum() / normalizer

    fg = valid & (gt_classes >= 0) & (gt_classes < num_classes)
    if deltas.shape[-1] == 4:
        sel = deltas
    else:
        d = deltas.reshape(deltas.shape[0], -1, 4)
        cls = gt_classes.long().clamp(0, d.shape[1] - 1)
        sel = torch.gather(d, 1, cls[:, None, None].expand(-1, 1, 4))[:, 0]
    if box_reg_loss_type == "smooth_l1":
        reg = smooth_l1_loss(sel, box2box_transform.get_deltas(proposal_boxes, gt_boxes), smooth_l1_beta).sum(dim=-1)
    else:
        reg = giou_loss(box2box_transform.apply_deltas(sel, proposal_boxes), gt_boxes)
    loss_box = (reg * fg.to(torch.float32)).sum() / normalizer
    return {"loss_cls": loss_cls, "loss_box_reg": loss_box}


def fast_rcnn_candidates(
    scores: torch.Tensor,  # (B, R, K+1) logits
    deltas: torch.Tensor,  # (B, R, K*4) or (B, R, 4)
    proposal_boxes: torch.Tensor,  # (B, R, 4)
    proposal_valid: torch.Tensor,  # (B, R)
    image_sizes: torch.Tensor,  # (B, 2)
    box2box_transform: Box2BoxTransform,
    num_classes: int,
    score_thresh: float,
    nms_candidates: int = 1024,
):
    """Per image: softmax, decode and clip per class, threshold, then the
    top ``nms_candidates`` of the R*K (proposal, class) scores (a stable
    sort: ties keep the lower index). Returns their scores (-inf where none
    passed), boxes, classes and flat indices (proposal * K + class), each
    (B, C, ...)."""
    b, r = scores.shape[:2]
    probs = torch.softmax(scores, dim=-1)[..., :num_classes]  # (B, R, K)
    size = image_sizes.to(torch.float32)[:, None, None, :]
    decoded = box2box_transform.apply_deltas(deltas, proposal_boxes)
    if deltas.shape[-1] == 4:
        boxes = clip_boxes(decoded, size[:, 0])[:, :, None, :].expand(b, r, num_classes, 4)
    else:
        boxes = clip_boxes(decoded.reshape(b, r, num_classes, 4), size)

    flat_scores = probs.reshape(b, -1)  # (B, R*K)
    flat_boxes = boxes.reshape(b, -1, 4)
    keepable = (
        (probs > score_thresh).reshape(b, -1)
        & proposal_valid.repeat_interleave(num_classes, dim=1)
        & nonempty_boxes(flat_boxes)
    )
    neg_inf = torch.full_like(flat_scores, float("-inf"))
    flat_scores = torch.where(keepable, flat_scores, neg_inf)

    c = min(nms_candidates, flat_scores.shape[1])
    cand_scores, cand_idx = topk_stable(flat_scores, c)
    cand_boxes = torch.gather(flat_boxes, 1, cand_idx[..., None].expand(b, c, 4))
    cand_classes = (cand_idx % num_classes).to(torch.int32)
    return cand_scores, cand_boxes, cand_classes, cand_idx


def fast_rcnn_select(cand_scores: torch.Tensor, cand_boxes: torch.Tensor, cand_classes: torch.Tensor,
                     nms_thresh: float, topk_per_image: int, cand_idx=None) -> Dict[str, torch.Tensor]:
    """Class-aware NMS over the candidates, then the top ``topk_per_image``
    (zero-padded past the candidates) as (B, D) detections; with
    ``cand_idx``, each detection's flat (proposal, class) index too
    (``pairs``)."""
    b, c = cand_scores.shape
    keep = batched_nms_mask(cand_boxes, cand_scores, cand_classes, nms_thresh)
    final_scores = torch.where(keep, cand_scores, torch.full_like(cand_scores, float("-inf")))
    k = min(topk_per_image, c)
    top_scores, top_i = topk_stable(final_scores, k)
    valid = torch.isfinite(top_scores)
    out = {
        "boxes": torch.gather(cand_boxes, 1, top_i[..., None].expand(b, k, 4)),
        "scores": torch.where(valid, top_scores, torch.zeros_like(top_scores)),
        "classes": torch.gather(cand_classes, 1, top_i),
        "valid": valid,
    }
    if cand_idx is not None:
        out["pairs"] = torch.gather(cand_idx, 1, top_i)
    if topk_per_image > k:
        pad = topk_per_image - k
        out = {
            key: torch.cat([v, v.new_zeros((b, pad) + v.shape[2:])], dim=1)
            for key, v in out.items()
        }
    return out


def fast_rcnn_inference(
    scores: torch.Tensor,  # (B, R, K+1) logits
    deltas: torch.Tensor,  # (B, R, K*4) or (B, R, 4)
    proposal_boxes: torch.Tensor,  # (B, R, 4)
    proposal_valid: torch.Tensor,  # (B, R)
    image_sizes: torch.Tensor,  # (B, 2)
    box2box_transform: Box2BoxTransform,
    num_classes: int,
    score_thresh: float,
    nms_thresh: float,
    topk_per_image: int,
    nms_candidates: int = 1024,
) -> Dict[str, torch.Tensor]:
    """Per image: softmax, decode and clip per class, threshold, top
    ``nms_candidates``, class-aware NMS, top ``topk_per_image``. The
    candidate budget is the JAX package's (``fast_rcnn.py:109,136-137``);
    detectron2 keeps every candidate above the threshold (ROADMAP §3)."""
    cand_scores, cand_boxes, cand_classes, _ = fast_rcnn_candidates(
        scores, deltas, proposal_boxes, proposal_valid, image_sizes, box2box_transform, num_classes, score_thresh,
        nms_candidates)
    return fast_rcnn_select(cand_scores, cand_boxes, cand_classes, nms_thresh, topk_per_image)
