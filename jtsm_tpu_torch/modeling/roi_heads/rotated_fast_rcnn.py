"""Rotated Fast R-CNN heads (reference:
detectron2/modeling/roi_heads/rotated_fast_rcnn.py ``RROIHeads``; JAX
package ``roi_heads/rotated_fast_rcnn.py``): rotated ROIAlign over one
map, the box head, a (K+1)-way classifier and one class-agnostic 5-dim
box regression, rotated class-aware NMS in serving.

It keeps the JAX package's departures from detectron2 (ROADMAP §3): one
level only (JAX :48); the box codec's weights fixed at (10, 10, 5, 5, 1)
(:72-74) whatever ROI_BOX_HEAD.BBOX_REG_WEIGHTS says; sampling ratio 2
where POOLER_SAMPLING_RATIO is 0 (:56-58); the class-agnostic regression
(:104-109); smooth L1 at beta 0; the ground truth not appended to the
proposals; in serving the top 512 (proposal, class) candidates go to NMS
(:184).

Training samples ``BATCH_SIZE_PER_IMAGE`` slots an image as the JAX
package does (:111-135): ``subsample_labels`` on the matched labels, then
the slots ordered by a uniform priority above the class of sample
(positives, negatives, the rest), with three uniform draws a proposal from
the caller's generator (positives, negatives, priority). Ties in every
top-k rank by index, as ``lax.top_k`` does (:126, :183, :189).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ...layers import ShapeSpec, compute_dtype
from ...ops.box_regression import Box2BoxTransformRotated
from ...ops.losses import smooth_l1_loss, softmax_cross_entropy
from ...ops.matcher import Matcher
from ...ops.nms import batched_nms_rotated_mask
from ...ops.roi_align_rotated import roi_align_rotated_batched
from ...ops.sampling import subsample_labels
from ...structures.rotated_boxes import pairwise_iou_rotated
from ..proposal_generator.proposal_utils import topk_stable
from .box_head import build_box_head
from .fast_rcnn import FastRCNNOutputLayers

# (proposal, class) candidates an image that reach the NMS (JAX :184)
NMS_CANDIDATES = 512


class RROIHeads(nn.Module):
    def __init__(self, cfg, input_shape: Dict[str, ShapeSpec]):
        super().__init__()
        rh, bh = cfg.MODEL.ROI_HEADS, cfg.MODEL.ROI_BOX_HEAD
        self.in_features = tuple(rh.IN_FEATURES)
        if len(self.in_features) != 1:
            raise ValueError(f"RROIHeads pools one map, not {self.in_features}")
        shape = input_shape[self.in_features[0]]
        self.num_classes = rh.NUM_CLASSES
        self.pooler_resolution = bh.POOLER_RESOLUTION
        self.pooler_scale = 1.0 / shape.stride
        self.sampling_ratio = bh.POOLER_SAMPLING_RATIO if bh.POOLER_SAMPLING_RATIO > 0 else 2
        res = self.pooler_resolution
        self.box_head = build_box_head(cfg, ShapeSpec(channels=shape.channels, height=res, width=res))
        self.box_predictor = FastRCNNOutputLayers(self.box_head.output_size, self.num_classes,
                                                  cls_agnostic_bbox_reg=True, box_dim=5,
                                                  compute_dtype=compute_dtype(cfg))
        self.box2box_transform = Box2BoxTransformRotated(weights=(10.0, 10.0, 5.0, 5.0, 1.0))
        self.proposal_matcher = Matcher(rh.IOU_THRESHOLDS, rh.IOU_LABELS, allow_low_quality_matches=False)
        self.batch_size_per_image = rh.BATCH_SIZE_PER_IMAGE
        self.positive_fraction = rh.POSITIVE_FRACTION
        self.score_thresh = rh.SCORE_THRESH_TEST
        self.nms_thresh = rh.NMS_THRESH_TEST
        self.detections_per_image = cfg.TEST.DETECTIONS_PER_IMAGE

    def forward(
        self,
        features: Dict[str, torch.Tensor],
        proposals: torch.Tensor,  # (B, K, 5)
        proposal_scores: torch.Tensor,  # (B, K)
        image_sizes: torch.Tensor,  # (B, 2)
        targets: Optional[Dict[str, torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """Detections in eval mode (``boxes`` (B, D, 5), ``scores``,
        ``classes``, ``valid``); in training the losses ``loss_cls`` and
        ``loss_box_reg`` against the ``targets`` (``gt_boxes`` (B, G, 5),
        ``gt_classes``, ``gt_valid``)."""
        if self.training:
            if targets is None:
                raise ValueError("training the ROI heads needs the gt_* targets")
            return self.losses(features, self.sample(proposals, proposal_scores, targets, generator))
        scores, deltas = self.box_outputs(self.pool(features, proposals), proposals.shape[1])
        return self.inference(scores, deltas, proposals, torch.isfinite(proposal_scores))

    def pool(self, features: Dict[str, torch.Tensor], boxes: torch.Tensor) -> torch.Tensor:
        """Rotated ROIAlign of (B, K, 5) boxes over the map: (B*K, P, P, C)."""
        b, k = boxes.shape[:2]
        feat = features[self.in_features[0]].permute(0, 2, 3, 1)  # channels-last
        bidx = torch.arange(b, dtype=torch.int32, device=boxes.device).repeat_interleave(k)
        return roi_align_rotated_batched(feat, boxes.reshape(b * k, 5), bidx, self.pooler_resolution,
                                         self.pooler_scale, self.sampling_ratio)

    def box_outputs(self, pooled: torch.Tensor, k: int):
        """The box head and predictor on pooled ROIs, ``k`` an image: (B, K,
        C+1) class logits and (B, K, 5) deltas, float32."""
        scores, deltas = self.box_predictor(self.box_head(pooled))
        return scores.reshape(-1, k, scores.shape[-1]), deltas.reshape(-1, k, 5)

    def inference(self, scores, deltas, proposals, valid) -> Dict[str, torch.Tensor]:
        """(B, D) detections from the box outputs (JAX :172-206)."""
        cand = rotated_fast_rcnn_candidates(scores, deltas, proposals, valid, self.box2box_transform,
                                            self.num_classes, self.score_thresh)
        return rotated_fast_rcnn_select(*cand, self.nms_thresh, self.detections_per_image)

    def sample(self, proposals, proposal_scores, targets, generator) -> Dict[str, torch.Tensor]:
        """``BATCH_SIZE_PER_IMAGE`` slots an image (JAX :111-135): their
        proposals (B, S, 5), classes (B, S) (NUM_CLASSES for background and
        unused slots), matched ground truth boxes (B, S, 5) and ``ok``
        (B, S)."""
        b, k = proposals.shape[:2]
        s = self.batch_size_per_image
        if s > k:
            raise ValueError(f"ROI_HEADS.BATCH_SIZE_PER_IMAGE {s} exceeds the {k} proposals an image (the JAX "
                             "package's top-k needs at most as many)")
        gt_boxes = targets["gt_boxes"].to(torch.float32)
        gt_classes, gt_valid = targets["gt_classes"], targets["gt_valid"].bool()
        u_pos, u_neg, u = (torch.rand((b, k), generator=generator, device=proposals.device) for _ in range(3))
        valid = torch.isfinite(proposal_scores)
        iou = pairwise_iou_rotated(gt_boxes, proposals)
        iou = torch.where(valid[:, None, :], iou, torch.full_like(iou, -1.0))
        matched_idx, matched_labels = self.proposal_matcher(iou, gt_valid=gt_valid)
        fg = matched_labels == 1
        cls = torch.where(fg, torch.gather(gt_classes.long(), 1, matched_idx),
                          torch.full_like(matched_idx, self.num_classes))
        labels = torch.where(~valid, torch.full_like(matched_idx, -1), fg.long()).to(torch.int32)
        pos, neg = subsample_labels(labels, s, self.positive_fraction, 0, u_pos, u_neg)
        inf = torch.full_like(u, float("-inf"))
        priority = torch.where(pos, 2.0 + u, torch.where(neg, 1.0 + u, inf))
        top, idx = topk_stable(priority, s)
        ok = torch.isfinite(top)
        slot_gt = torch.gather(matched_idx, 1, idx)
        return {
            "boxes": torch.gather(proposals, 1, idx[..., None].expand(b, s, 5)),
            "classes": torch.where(ok, torch.gather(cls, 1, idx), torch.full_like(idx, self.num_classes)),
            "gt_boxes": torch.gather(gt_boxes, 1, slot_gt[..., None].expand(b, s, 5)),
            "ok": ok,
        }

    def losses(self, features, sampled) -> Dict[str, torch.Tensor]:
        """Softmax cross entropy over the ``ok`` slots and smooth L1 of the
        foreground slots' deltas, both over the number of ``ok`` slots (JAX
        :137-161)."""
        boxes = sampled["boxes"]
        scores, deltas = self.box_outputs(self.pool(features, boxes), boxes.shape[1])
        scores, deltas = scores.flatten(0, 1), deltas.flatten(0, 1)
        ok, classes = sampled["ok"].reshape(-1), sampled["classes"].reshape(-1)
        okf = ok.to(torch.float32)
        norm = okf.sum().clamp(min=1.0)
        loss_cls = (softmax_cross_entropy(scores, classes) * okf).sum() / norm
        fg = ok & (classes < self.num_classes)
        target = self.box2box_transform.get_deltas(boxes.reshape(-1, 5), sampled["gt_boxes"].reshape(-1, 5))
        reg = smooth_l1_loss(deltas, target, 0.0).sum(-1)
        return {"loss_cls": loss_cls, "loss_box_reg": (reg * fg.to(torch.float32)).sum() / norm}


def rotated_fast_rcnn_candidates(scores, deltas, proposals, valid, box2box_transform, num_classes: int,
                                 score_thresh: float):
    """Per image the top ``NMS_CANDIDATES`` (proposal, class) pairs of the
    class probabilities above ``score_thresh`` on valid proposals:
    their scores (-inf past the threshold), boxes (B, c, 5) (each
    proposal's decoded box) and classes (JAX :173-183)."""
    b, k = proposals.shape[:2]
    probs = torch.softmax(scores, dim=-1)[..., :num_classes]
    boxes = box2box_transform.apply_deltas(deltas, proposals)
    flat = torch.where((probs > score_thresh) & valid[..., None], probs,
                       torch.full_like(probs, float("-inf"))).reshape(b, -1)
    c = min(NMS_CANDIDATES, flat.shape[1])
    top, idx = topk_stable(flat, c)
    cand_boxes = torch.gather(boxes, 1, (idx // num_classes)[..., None].expand(b, c, 5))
    return top, cand_boxes, (idx % num_classes).to(torch.int32)


def rotated_fast_rcnn_select(scores, boxes, classes, nms_thresh: float, detections_per_image: int):
    """Class-aware rotated NMS of the candidates, then the top
    ``detections_per_image``: (B, D) ``boxes``, ``scores`` (0 where
    ``valid`` is False), ``classes``, ``valid`` (JAX :184-206)."""
    b, c = scores.shape
    keep = batched_nms_rotated_mask(boxes, scores, classes, nms_thresh)
    final = torch.where(keep, scores, torch.full_like(scores, float("-inf")))
    d = min(detections_per_image, c)
    top, idx = topk_stable(final, d)
    ok = torch.isfinite(top)
    out = {
        "boxes": torch.gather(boxes, 1, idx[..., None].expand(b, d, 5)),
        "scores": torch.where(ok, top, torch.zeros_like(top)),
        "classes": torch.gather(classes, 1, idx),
        "valid": ok,
    }
    if detections_per_image > d:
        pad = detections_per_image - d
        out = {
            "boxes": torch.cat([out["boxes"], out["boxes"].new_zeros((b, pad, 5))], 1),
            "scores": torch.cat([out["scores"], out["scores"].new_zeros((b, pad))], 1),
            "classes": torch.cat([out["classes"], out["classes"].new_zeros((b, pad))], 1),
            "valid": torch.cat([out["valid"], out["valid"].new_zeros((b, pad))], 1),
        }
    return out
