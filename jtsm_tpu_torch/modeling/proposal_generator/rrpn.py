"""Rotated RPN (reference: detectron2/modeling/proposal_generator/rrpn.py;
JAX package ``proposal_generator/rrpn.py``): (cx, cy, w, h, angle) anchors
from ``RotatedAnchorGenerator``, 5-dim deltas, anchors matched to the
ground truth by rotated IoU, rotated NMS.

It keeps the JAX package's departures from detectron2 (ROADMAP §3): the
box codec's weights are (1, 1, 1, 1, 1) whatever RPN.BBOX_REG_WEIGHTS says
(JAX :66-68); proposals come from the top PRE_NMS_TOPK of all levels at
once, with no per-level top-k, clip or minimum size; no anchor is ignored
at the image's border; the box loss is smooth L1 on the deltas.

The head (``rpn_head``, ``StandardRPNHead`` with 5 deltas an anchor)
computes in the ``TPU.COMPUTE_DTYPE``; its outputs go to float32 before
top-k, decoding and the losses (JAX :96-101). Ties in the objectness
top-k rank by index, as ``lax.top_k`` does (JAX :139, :144). In training
the sampling draws two uniforms an anchor from the caller's generator,
positives then negatives, as ``RPN`` does.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ...layers import ShapeSpec, compute_dtype
from ...ops.box_regression import Box2BoxTransformRotated
from ...ops.losses import binary_cross_entropy_with_logits, smooth_l1_loss
from ...ops.matcher import Matcher
from ...ops.nms import nms_rotated_mask
from ...ops.sampling import subsample_labels
from ...structures.rotated_boxes import pairwise_iou_rotated
from ..anchor_generator import RotatedAnchorGenerator
from .proposal_utils import topk_stable
from .rpn import StandardRPNHead


class RRPN(nn.Module):
    def __init__(self, cfg, input_shape: Dict[str, ShapeSpec]):
        super().__init__()
        r = cfg.MODEL.RPN
        if r.HEAD_NAME != "StandardRPNHead":
            raise NotImplementedError(f"RPN head {r.HEAD_NAME!r} is not ported yet")
        self.in_features = tuple(r.IN_FEATURES)
        shapes = [input_shape[f] for f in self.in_features]
        self.anchor_generator = RotatedAnchorGenerator.from_config(cfg, shapes)
        num_anchors = self.anchor_generator.num_anchors
        self.rpn_head = StandardRPNHead(shapes[0].channels, num_anchors[0], 5, tuple(r.CONV_DIMS), compute_dtype(cfg))
        self.box2box_transform = Box2BoxTransformRotated(weights=(1.0, 1.0, 1.0, 1.0, 1.0))
        self.anchor_matcher = Matcher(r.IOU_THRESHOLDS, r.IOU_LABELS, allow_low_quality_matches=True)
        self.batch_size_per_image = r.BATCH_SIZE_PER_IMAGE
        self.positive_fraction = r.POSITIVE_FRACTION
        self.pre_nms_topk, self.post_nms_topk = r.PRE_NMS_TOPK_TEST, r.POST_NMS_TOPK_TEST
        self.pre_nms_topk_train, self.post_nms_topk_train = r.PRE_NMS_TOPK_TRAIN, r.POST_NMS_TOPK_TRAIN
        self.nms_thresh = r.NMS_THRESH
        self.loss_weight = r.LOSS_WEIGHT
        self.smooth_l1_beta = r.SMOOTH_L1_BETA

    def forward(
        self,
        image_sizes: torch.Tensor,
        features: Dict[str, torch.Tensor],
        gt_boxes: Optional[torch.Tensor] = None,
        gt_valid: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """(B, K, 5) proposals and (B, K) objectness logits (-inf where
        NMS suppressed a slot or none was left), and in training the loss
        dict against ``gt_boxes`` (B, G, 5) and ``gt_valid`` (B, G)."""
        anchors, logits, deltas = self.head_outputs(features)
        losses = {}
        if self.training:
            if gt_boxes is None or gt_valid is None:
                raise ValueError("training the RRPN needs gt_boxes and gt_valid")
            if gt_boxes.shape[-1] != 5:
                raise ValueError(f"RRPN trains on (B, G, 5) rotated gt_boxes, not {tuple(gt_boxes.shape)}: the "
                                 "DatasetMapper makes 4-dim boxes, as the JAX package's does; make the targets with "
                                 "data.detection_utils.annotations_to_instances_rotated")
            u_pos, u_neg = (torch.rand(logits.shape, generator=generator, device=logits.device) for _ in range(2))
            losses = self.losses(anchors, logits, deltas, gt_boxes, gt_valid, u_pos, u_neg)
        proposals, scores = self.predict_proposals(anchors, logits, deltas, image_sizes)
        return proposals, scores, losses

    def head_outputs(self, features: Dict[str, torch.Tensor]):
        """All levels' anchors (N, 5), and the head's objectness logits
        (B, N) and deltas (B, N, 5) in float32, location-major like the
        anchors."""
        feats = [features[f] for f in self.in_features]
        logits, deltas = self.rpn_head(feats)
        anchors = self.anchor_generator([tuple(f.shape[-2:]) for f in feats], feats[0].device)
        b = feats[0].shape[0]
        logits = torch.cat([lg.permute(0, 2, 3, 1).reshape(b, -1).float() for lg in logits], dim=1)
        deltas = torch.cat([dl.permute(0, 2, 3, 1).reshape(b, -1, 5).float() for dl in deltas], dim=1)
        return torch.cat(anchors), logits, deltas

    def predict_proposals(self, anchors, logits, deltas, image_sizes):
        """The top PRE_NMS_TOPK logits of each image, their anchors decoded,
        rotated NMS, then the top POST_NMS_TOPK survivors (JAX :133-156);
        no gradient."""
        post_k = self.post_nms_topk_train if self.training else self.post_nms_topk
        with torch.no_grad():
            topv, boxes = self.decode_top(anchors, logits, deltas)
            b, k = topv.shape
            keep = nms_rotated_mask(boxes, topv, self.nms_thresh)
            masked = torch.where(keep, topv, torch.full_like(topv, float("-inf")))
            k2 = min(post_k, k)
            scores, idx = topk_stable(masked, k2)
            proposals = torch.gather(boxes, 1, idx[..., None].expand(b, k2, 5))
            if post_k > k2:
                proposals = torch.cat([proposals, proposals.new_zeros((b, post_k - k2, 5))], dim=1)
                scores = torch.cat([scores, scores.new_full((b, post_k - k2), float("-inf"))], dim=1)
        return proposals, scores

    def decode_top(self, anchors, logits, deltas):
        """The top PRE_NMS_TOPK (train or test) logits of each image (B, k)
        and their anchors' decoded boxes (B, k, 5): what the NMS takes."""
        pre_k = self.pre_nms_topk_train if self.training else self.pre_nms_topk
        b, n = logits.shape
        k = min(pre_k, n)
        topv, topi = topk_stable(logits.detach(), k)
        sel = torch.gather(deltas.detach(), 1, topi[..., None].expand(b, k, 5))
        return topv, self.box2box_transform.apply_deltas(sel, anchors[topi])

    def losses(self, anchors, logits, deltas, gt_boxes, gt_valid, u_pos, u_neg):
        """``loss_rpn_cls`` (objectness BCE over the sampled anchors) and
        ``loss_rpn_loc`` (smooth L1 of the positives' deltas), both over
        ``BATCH_SIZE_PER_IMAGE * B`` (JAX :104-131)."""
        b, n = logits.shape
        gt_boxes = gt_boxes.to(torch.float32)
        iou = pairwise_iou_rotated(gt_boxes, anchors)  # (B, G, N)
        matched_idx, match_labels = self.anchor_matcher(iou, gt_valid=gt_valid.bool())
        pos, neg = subsample_labels(match_labels.to(torch.int32), self.batch_size_per_image,
                                    self.positive_fraction, 0, u_pos, u_neg)
        sampled = (pos | neg).to(torch.float32)
        obj_loss = (binary_cross_entropy_with_logits(logits, pos.to(torch.float32)) * sampled).sum()
        matched_gt = torch.gather(gt_boxes, 1, matched_idx[..., None].expand(b, n, 5))
        target = self.box2box_transform.get_deltas(anchors.expand(b, n, 5), matched_gt)
        reg = smooth_l1_loss(deltas, target, self.smooth_l1_beta).sum(-1)
        reg_loss = (reg * pos.to(torch.float32)).sum()
        normalizer = self.batch_size_per_image * b
        return {
            "loss_rpn_cls": obj_loss / normalizer * self.loss_weight,
            "loss_rpn_loc": reg_loss / normalizer * self.loss_weight,
        }
