"""Cascade R-CNN heads (reference: detectron2/modeling/roi_heads/cascade_rcnn.py;
JAX package ``roi_heads/cascade_rcnn.py:31-217``).

One box head and one class-agnostic ``FastRCNNOutputLayers`` a stage
(``box_head.{s}``, ``box_predictor.{s}``, detectron2's keys), whatever
CLS_AGNOSTIC_BBOX_REG says; each stage decodes with its own
``Box2BoxTransform`` (ROI_BOX_CASCADE_HEAD.BBOX_REG_WEIGHTS) and, in
training, matches with its own ``Matcher([iou], [0, 1])`` (IOUS, no
low-quality matches).

Serving (JAX :154-205): each stage pools the current (B, K) boxes with the
box pooler, decodes them with its deltas and clips them to the image; the
stages' softmax probabilities are averaged, and ``log(max(p, 1e-8))`` goes
with zero deltas on the thrice-decoded boxes through
``fast_rcnn_inference``; the mask branch pools the detections.

Training (JAX :91-152), a stage at a time: the sampler runs on the stage's
boxes (the proposals, with the ground truth appended at stage 0 only; then
the previous stage's decoded and clipped sampled boxes, scored 0 where the
slot is valid and -inf elsewhere), the stage's losses are
``loss_cls_stage{s}`` and ``loss_box_reg_stage{s}``, and the deltas are
detached before decoding. Where the JAX package departs from detectron2,
the port follows it (ROADMAP §3): stages 1 and 2 resample at
POSITIVE_FRACTION instead of relabelling every box, the mask branch trains
on the last stage's sample (IoU 0.7 foreground) instead of stage 0's
proposals, and no ``1 / num_stages`` scale reaches the box features'
gradient. Each stage's sampler draws its three uniforms from the caller's
generator (``StandardROIHeads.sample``), then the mask branch its pick.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ...layers import ShapeSpec, compute_dtype
from ...ops.box_regression import Box2BoxTransform
from ...ops.matcher import Matcher
from ...structures.boxes import clip_boxes
from .box_head import build_box_head
from .fast_rcnn import FastRCNNOutputLayers, fast_rcnn_inference, fast_rcnn_losses
from .roi_heads import StandardROIHeads


class CascadeROIHeads(StandardROIHeads):
    def __init__(self, cfg, input_shape: Dict[str, ShapeSpec]):
        super().__init__(cfg, input_shape)
        ch, bh = cfg.MODEL.ROI_BOX_CASCADE_HEAD, cfg.MODEL.ROI_BOX_HEAD
        ious = tuple(ch.IOUS)
        shape = ShapeSpec(channels=input_shape[self.in_features[0]].channels, height=bh.POOLER_RESOLUTION,
                          width=bh.POOLER_RESOLUTION)
        self.box_head = nn.ModuleList([build_box_head(cfg, shape) for _ in ious])
        self.box_predictor = nn.ModuleList([
            FastRCNNOutputLayers(h.output_size, self.num_classes, cls_agnostic_bbox_reg=True,
                                 compute_dtype=compute_dtype(cfg))
            for h in self.box_head
        ])
        self.box2box_transforms = [Box2BoxTransform(weights=tuple(w)) for w in ch.BBOX_REG_WEIGHTS]
        self.proposal_matchers = [Matcher([iou], [0, 1], allow_low_quality_matches=False) for iou in ious]

    @property
    def num_stages(self) -> int:
        return len(self.proposal_matchers)

    def forward(
        self,
        features: Dict[str, torch.Tensor],
        proposals: torch.Tensor,  # (B, K, 4)
        proposal_scores: torch.Tensor,  # (B, K)
        image_sizes: torch.Tensor,  # (B, 2)
        targets: Optional[Dict[str, torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """Detections in eval mode; in training the loss dict (see the
        module docstring)."""
        if self.training:
            if targets is None:
                raise ValueError("training the ROI heads needs the gt_* targets")
            return self._forward_cascade_train(features, proposals, proposal_scores, image_sizes, targets, generator)
        return self.forward_with_given_boxes(features, self.detect(features, proposals, proposal_scores, image_sizes))

    def run_stage(self, s: int, feats: List[torch.Tensor], boxes: torch.Tensor, image_sizes: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Serving's stage ``s`` on (B, K, 4) boxes: its class
        probabilities (B, K, C+1) and the boxes its deltas decode to,
        clipped to each image."""
        b, k = boxes.shape[:2]
        flat = boxes.reshape(b * k, 4)
        batch_idx = torch.arange(b, dtype=torch.int32, device=boxes.device).repeat_interleave(k)
        scores, deltas = self.box_predictor[s](self.box_head[s](self.box_pooler(feats, flat, batch_idx)))
        decoded = self.box2box_transforms[s].apply_deltas(deltas, flat).reshape(b, k, 4)
        return torch.softmax(scores.reshape(b, k, -1), dim=-1), clip_boxes(decoded, image_sizes[:, None])

    def combine(self, stage_probs: List[torch.Tensor], boxes: torch.Tensor, proposal_scores: torch.Tensor,
                image_sizes: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The stages' mean probabilities as log-probabilities, with zero
        deltas on the last stage's boxes, through ``fast_rcnn_inference``
        (thresholds, per-class NMS, the top DETECTIONS_PER_IMAGE)."""
        mean = sum(stage_probs) / self.num_stages
        return fast_rcnn_inference(
            torch.log(mean.clamp(min=1e-8)),
            torch.zeros_like(boxes),
            boxes,
            torch.isfinite(proposal_scores),
            image_sizes,
            self.box2box_transforms[-1],
            self.num_classes,
            self.score_thresh,
            self.nms_thresh,
            self.detections_per_image,
        )

    def detect(
        self,
        features: Dict[str, torch.Tensor],
        proposals: torch.Tensor,
        proposal_scores: torch.Tensor,
        image_sizes: torch.Tensor,
    ) -> Dict[str, torch.Tensor]:
        """The box branch in eval mode: the stages in turn, then
        ``combine``."""
        feats = [features[f] for f in self.in_features]
        boxes, probs = proposals, []
        for s in range(self.num_stages):
            p, boxes = self.run_stage(s, feats, boxes, image_sizes)
            probs.append(p)
        return self.combine(probs, boxes, proposal_scores, image_sizes)

    def _forward_cascade_train(self, features, proposals, proposal_scores, image_sizes, targets, generator):
        feats = [features[f] for f in self.in_features]
        b = proposals.shape[0]
        n = self.batch_size_per_image
        batch_idx = torch.arange(b, dtype=torch.int32, device=proposals.device).repeat_interleave(n)
        losses = {}
        boxes, scores = proposals, proposal_scores
        for s in range(self.num_stages):
            sampled = self.sample(boxes, scores, targets, generator, matcher=self.proposal_matchers[s],
                                  append_gt=self.proposal_append_gt and s == 0)
            flat = sampled["boxes"].reshape(b * n, 4)
            logits, deltas = self.box_predictor[s](self.box_head[s](self.box_pooler(feats, flat, batch_idx)))
            stage_losses = fast_rcnn_losses(
                logits, deltas, flat, sampled["gt_classes"].reshape(-1), sampled["gt_boxes"].reshape(-1, 4),
                sampled["valid"].reshape(-1), self.box2box_transforms[s], self.num_classes, self.smooth_l1_beta,
                self.box_reg_loss_type,
            )
            losses.update({f"{k}_stage{s}": v for k, v in stage_losses.items()})
            decoded = self.box2box_transforms[s].apply_deltas(deltas.detach(), flat).reshape(b, n, 4)
            boxes = clip_boxes(decoded, image_sizes[:, None])
            scores = torch.where(sampled["valid"], 0.0, float("-inf"))
        if self.mask_on:
            losses["loss_mask"] = self._forward_mask_train(feats, sampled, targets, generator)
        return losses
