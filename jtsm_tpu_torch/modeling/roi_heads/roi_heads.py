"""Second stage, inference (reference:
detectron2/modeling/roi_heads/roi_heads.py:520 ``StandardROIHeads``; JAX
package ``roi_heads/roi_heads.py`` :197 onward).

Proposals are fixed (B, K, 4) with -inf-score padding; detections are fixed
(B, D) with a validity mask. The box pooler pools all B*K proposals and the
mask pooler all B*D detections, padding included, as the JAX package does.
The training branch comes with the training slice."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ...layers import ShapeSpec
from ...ops.box_regression import Box2BoxTransform
from ..poolers import ROIPooler
from .box_head import build_box_head
from .fast_rcnn import FastRCNNOutputLayers, fast_rcnn_inference
from .mask_head import build_mask_head, mask_rcnn_inference


class StandardROIHeads(nn.Module):
    def __init__(self, cfg, input_shape: Dict[str, ShapeSpec]):
        super().__init__()
        if cfg.MODEL.KEYPOINT_ON:
            raise NotImplementedError("the keypoint head is not ported yet")
        self.in_features = tuple(cfg.MODEL.ROI_HEADS.IN_FEATURES)
        self.num_classes = cfg.MODEL.ROI_HEADS.NUM_CLASSES
        scales = tuple(1.0 / input_shape[k].stride for k in self.in_features)
        in_channels = input_shape[self.in_features[0]].channels
        bh = cfg.MODEL.ROI_BOX_HEAD
        self.box_pooler = ROIPooler(
            bh.POOLER_RESOLUTION, scales, bh.POOLER_SAMPLING_RATIO, bh.POOLER_TYPE
        )
        self.box_head = build_box_head(
            cfg, ShapeSpec(channels=in_channels, height=bh.POOLER_RESOLUTION, width=bh.POOLER_RESOLUTION)
        )
        self.box_predictor = FastRCNNOutputLayers(
            self.box_head.output_size, self.num_classes, bh.CLS_AGNOSTIC_BBOX_REG
        )
        self.box2box_transform = Box2BoxTransform(weights=bh.BBOX_REG_WEIGHTS)
        self.score_thresh = cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST
        self.nms_thresh = cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST
        self.detections_per_image = cfg.TEST.DETECTIONS_PER_IMAGE
        self.mask_on = cfg.MODEL.MASK_ON
        if self.mask_on:
            mh = cfg.MODEL.ROI_MASK_HEAD
            self.mask_pooler = ROIPooler(
                mh.POOLER_RESOLUTION, scales, mh.POOLER_SAMPLING_RATIO, mh.POOLER_TYPE
            )
            self.mask_head = build_mask_head(
                cfg, ShapeSpec(channels=in_channels, height=mh.POOLER_RESOLUTION, width=mh.POOLER_RESOLUTION)
            )

    def forward(
        self,
        features: Dict[str, torch.Tensor],
        proposals: torch.Tensor,  # (B, K, 4)
        proposal_scores: torch.Tensor,  # (B, K)
        image_sizes: torch.Tensor,  # (B, 2)
    ) -> Dict[str, torch.Tensor]:
        feats = [features[f] for f in self.in_features]
        b, k = proposals.shape[:2]
        batch_idx = torch.arange(b, dtype=torch.int32, device=proposals.device)
        box_feats = self.box_pooler(feats, proposals.reshape(b * k, 4), batch_idx.repeat_interleave(k))
        scores, deltas = self.box_predictor(self.box_head(box_feats))
        detections = fast_rcnn_inference(
            scores.reshape(b, k, -1),
            deltas.reshape(b, k, -1),
            proposals,
            torch.isfinite(proposal_scores),
            image_sizes,
            self.box2box_transform,
            self.num_classes,
            self.score_thresh,
            self.nms_thresh,
            self.detections_per_image,
        )
        if self.mask_on:
            d = detections["boxes"].shape[1]
            mask_feats = self.mask_pooler(
                feats, detections["boxes"].reshape(b * d, 4), batch_idx.repeat_interleave(d)
            )
            probs = mask_rcnn_inference(self.mask_head(mask_feats), detections["classes"].reshape(-1))
            detections["masks"] = probs.reshape((b, d) + probs.shape[-2:])
        return detections


def build_roi_heads(cfg, input_shape: Dict[str, ShapeSpec]) -> StandardROIHeads:
    name = cfg.MODEL.ROI_HEADS.NAME
    if name != "StandardROIHeads":
        raise NotImplementedError(f"ROI heads {name!r} are not ported yet")
    return StandardROIHeads(cfg, input_shape)
