"""The C4 second stage (reference:
detectron2/modeling/roi_heads/roi_heads.py:343 ``Res5ROIHeads``; JAX package
``modeling/roi_heads/res5_roi_heads.py:38-294``).

One ROIPooler level (ROI_HEADS.IN_FEATURES, res4 at stride 16) at
ROI_BOX_HEAD.POOLER_RESOLUTION (14): one K1 launch on the card, and K2 in
its backward. Then res5 inside the head: three bottleneck blocks
(``roi_heads.res5.{0,1,2}``, detectron2's names), the first at stride 2,
so 14x14 becomes 7x7 with RES2_OUT_CHANNELS * 8 channels; the mean over
the map feeds ``FastRCNNOutputLayers``. The matcher takes no low-quality
matches.

Training samples as ``StandardROIHeads`` does (its draws, in its order),
and under MASK_ON the C4 mask head reads the res5 features of up to
``mask_fg_capacity`` (128) foreground slots an image, picked by a uniform
priority drawn next from the generator (JAX :215-225); ``loss_mask``
against ``mask_targets_from_crops`` at the logits' size. Serving pools the
proposals, then under MASK_ON pools the (B, D) detections again and runs
res5 again for the mask head (JAX :256, :280-287)."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ...layers import ShapeSpec, compute_dtype
from ...ops.box_regression import Box2BoxTransform
from ...ops.matcher import Matcher
from ..backbone.resnet import BottleneckBlock
from ..poolers import ROIPooler
from .fast_rcnn import FastRCNNOutputLayers, fast_rcnn_inference, fast_rcnn_losses
from .mask_head import build_mask_head, mask_rcnn_inference, mask_rcnn_loss, mask_targets_from_crops
from .roi_heads import StandardROIHeads


class Res5ROIHeads(nn.Module):
    def __init__(self, cfg, input_shape: Dict[str, ShapeSpec]):
        super().__init__()
        rh, bh, r = cfg.MODEL.ROI_HEADS, cfg.MODEL.ROI_BOX_HEAD, cfg.MODEL.RESNETS
        self.in_features = tuple(rh.IN_FEATURES)
        if len(self.in_features) != 1:
            raise ValueError(f"Res5ROIHeads pools one map, not {self.in_features}")
        shape = input_shape[self.in_features[0]]
        self.num_classes = rh.NUM_CLASSES
        self.pooler = ROIPooler(bh.POOLER_RESOLUTION, (1.0 / shape.stride,), bh.POOLER_SAMPLING_RATIO,
                                bh.POOLER_TYPE)
        dt = compute_dtype(cfg)
        out_channels = r.RES2_OUT_CHANNELS * 8
        bottleneck_channels = r.NUM_GROUPS * r.WIDTH_PER_GROUP * 8
        blocks, in_channels = [], shape.channels
        for b in range(3):
            blocks.append(BottleneckBlock(in_channels, out_channels, bottleneck_channels, 2 if b == 0 else 1,
                                          r.NUM_GROUPS, r.NORM, r.STRIDE_IN_1X1, dt))
            in_channels = out_channels
        self.res5 = nn.Sequential(*blocks)
        self.box_predictor = FastRCNNOutputLayers(out_channels, self.num_classes, bh.CLS_AGNOSTIC_BBOX_REG,
                                                  compute_dtype=dt)
        self.box2box_transform = Box2BoxTransform(weights=bh.BBOX_REG_WEIGHTS)
        self.proposal_matcher = Matcher(rh.IOU_THRESHOLDS, rh.IOU_LABELS, allow_low_quality_matches=False)
        self.batch_size_per_image = rh.BATCH_SIZE_PER_IMAGE
        self.positive_fraction = rh.POSITIVE_FRACTION
        self.proposal_append_gt = rh.PROPOSAL_APPEND_GT
        self.smooth_l1_beta = bh.SMOOTH_L1_BETA
        self.box_reg_loss_type = bh.BBOX_REG_LOSS_TYPE
        self.score_thresh = rh.SCORE_THRESH_TEST
        self.nms_thresh = rh.NMS_THRESH_TEST
        self.detections_per_image = cfg.TEST.DETECTIONS_PER_IMAGE
        self.mask_fg_capacity = 128
        self.mask_on = cfg.MODEL.MASK_ON
        if self.mask_on:
            p = bh.POOLER_RESOLUTION // 2
            self.mask_head = build_mask_head(cfg, ShapeSpec(channels=out_channels, height=p, width=p))

    forward = StandardROIHeads.forward
    sample = StandardROIHeads.sample
    _pick_foreground = StandardROIHeads._pick_foreground

    def pool(self, features: Dict[str, torch.Tensor], boxes: torch.Tensor) -> torch.Tensor:
        """(B, N, 4) boxes -> their (B*N, C, P, P) pooled features (an
        NCHW view of the pooler's channels-last rows)."""
        b, n = boxes.shape[:2]
        batch_idx = torch.arange(b, dtype=torch.int32, device=boxes.device).repeat_interleave(n)
        pooled = self.pooler([features[self.in_features[0]]], boxes.reshape(b * n, 4), batch_idx)
        return pooled.permute(0, 3, 1, 2)

    def box_outputs(self, res5: torch.Tensor):
        """The class logits and box deltas of res5 features, from their
        mean over the map."""
        return self.box_predictor(res5.mean(dim=(2, 3)))

    def mask_logits(self, res5: torch.Tensor) -> torch.Tensor:
        """(N, K, 2S, 2S) logits of the mask head on (N, C, S, S) res5
        features (the head reads them channels-last)."""
        return self.mask_head(res5.permute(0, 2, 3, 1))

    def detect(self, features, proposals, proposal_scores, image_sizes) -> Dict[str, torch.Tensor]:
        """The box branch in eval mode: all B*K proposals pooled and run
        through res5, then ``detections``."""
        return self.detections(self.res5(self.pool(features, proposals)), proposals, proposal_scores, image_sizes)

    def detections(self, res5, proposals, proposal_scores, image_sizes) -> Dict[str, torch.Tensor]:
        """(B, D) detections from the B*K proposals' res5 features: the
        predictor, then per-class NMS."""
        b, k = proposals.shape[:2]
        scores, deltas = self.box_outputs(res5)
        return fast_rcnn_inference(
            scores.reshape(b, k, -1), deltas.reshape(b, k, -1), proposals, torch.isfinite(proposal_scores),
            image_sizes, self.box2box_transform, self.num_classes, self.score_thresh, self.nms_thresh,
            self.detections_per_image,
        )

    def forward_with_given_boxes(self, features, detections: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """With MASK_ON, ``masks`` (B, D, S, S) of the (B, D) detections:
        pooled again, res5 again, the mask head."""
        if not self.mask_on:
            return detections
        b, d = detections["boxes"].shape[:2]
        logits = self.mask_logits(self.res5(self.pool(features, detections["boxes"])))
        probs = mask_rcnn_inference(logits, detections["classes"].reshape(-1))
        return dict(detections, masks=probs.reshape((b, d) + probs.shape[-2:]))

    def _forward_train(self, features, proposals, proposal_scores, targets, generator):
        sampled = self.sample(proposals, proposal_scores, targets, generator)
        b, s = sampled["boxes"].shape[:2]
        flat_boxes = sampled["boxes"].reshape(b * s, 4)
        res5 = self.res5(self.pool(features, sampled["boxes"]))
        scores, deltas = self.box_outputs(res5)
        losses = fast_rcnn_losses(
            scores, deltas, flat_boxes, sampled["gt_classes"].reshape(-1), sampled["gt_boxes"].reshape(-1, 4),
            sampled["valid"].reshape(-1), self.box2box_transform, self.num_classes, self.smooth_l1_beta,
            self.box_reg_loss_type,
        )
        if self.mask_on:
            idx, picked, boxes = self._pick_foreground(sampled, generator)
            sm = idx.shape[1]
            rows = (idx + torch.arange(b, device=idx.device)[:, None] * s).reshape(-1)
            logits = self.mask_logits(res5[rows])
            size = logits.shape[-1]
            mask_targets = mask_targets_from_crops(
                targets["gt_mask_crops"], targets["gt_boxes"], torch.gather(sampled["matched_idx"], 1, idx), boxes,
                size,
            )
            losses["loss_mask"] = mask_rcnn_loss(
                logits, torch.gather(sampled["gt_classes"], 1, idx).reshape(-1),
                mask_targets.reshape(b * sm, size, size), picked.reshape(-1),
            )
        return losses
