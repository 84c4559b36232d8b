"""Second stage (reference: detectron2/modeling/roi_heads/roi_heads.py:520
``StandardROIHeads``; JAX package ``roi_heads/roi_heads.py`` :197 onward).

Proposals are fixed (B, K, 4) with -inf-score padding; detections are fixed
(B, D) with a validity mask. The box pooler pools all B*K proposals and the
mask pooler all B*D detections, padding included, as the JAX package does;
under KEYPOINT_ON the keypoint pooler (ROIAlignV2 at 14x14 over the box
head's levels) does the same, and the detections gain ``keypoints`` (B, D,
K, 4) in network-input coordinates (JAX ``roi_heads.py:174-192,305-315``).

In training the heads sample ``BATCH_SIZE_PER_IMAGE`` slots per image and
pick up to ``mask_fg_capacity`` foreground slots of them for the mask
branch, and as many again for the keypoint branch, with uniform draws from
the caller's generator; the ROIs of each branch are image-major, so each
pooler runs once per step, and the heads return the losses ``loss_cls``,
``loss_box_reg``, ``loss_mask`` and ``loss_keypoint`` (the last where the
targets hold ``gt_keypoints``, JAX ``roi_heads.py:270-272``), and those of
``_forward_extra_train``. Under ROI_BOX_HEAD.TRAIN_ON_PRED_BOXES the mask
and keypoint branches pool, and take their targets on, the boxes that the
box head's detached deltas of each slot's class decode to, not the
sampled proposals."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ...layers import ShapeSpec, compute_dtype
from ...ops.box_regression import Box2BoxTransform
from ...ops.matcher import Matcher
from ..poolers import ROIPooler
from ..proposal_generator.proposal_utils import topk_stable
from .box_head import build_box_head
from .fast_rcnn import FastRCNNOutputLayers, fast_rcnn_inference, fast_rcnn_losses
from .keypoint_head import build_keypoint_head, keypoint_rcnn_inference, keypoint_rcnn_loss
from .mask_head import build_mask_head, mask_rcnn_inference, mask_rcnn_loss, mask_targets_from_crops
from .proposal_sampling import sample_proposals


class StandardROIHeads(nn.Module):
    def __init__(self, cfg, input_shape: Dict[str, ShapeSpec]):
        super().__init__()
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
            self.box_head.output_size, self.num_classes, bh.CLS_AGNOSTIC_BBOX_REG,
            compute_dtype=compute_dtype(cfg),
        )
        self.box2box_transform = Box2BoxTransform(weights=bh.BBOX_REG_WEIGHTS)
        rh = cfg.MODEL.ROI_HEADS
        self.proposal_matcher = Matcher(rh.IOU_THRESHOLDS, rh.IOU_LABELS, allow_low_quality_matches=False)
        self.batch_size_per_image = rh.BATCH_SIZE_PER_IMAGE
        self.positive_fraction = rh.POSITIVE_FRACTION
        self.proposal_append_gt = rh.PROPOSAL_APPEND_GT
        self.smooth_l1_beta = bh.SMOOTH_L1_BETA
        if bh.BBOX_REG_LOSS_TYPE not in ("smooth_l1", "giou"):
            raise ValueError(f"box loss {bh.BBOX_REG_LOSS_TYPE!r} is not one of smooth_l1, giou")
        self.box_reg_loss_type = bh.BBOX_REG_LOSS_TYPE
        self.train_on_pred_boxes = bh.TRAIN_ON_PRED_BOXES
        self.score_thresh = cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST
        self.nms_thresh = cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST
        self.detections_per_image = cfg.TEST.DETECTIONS_PER_IMAGE
        # foreground slots per image that train the mask and keypoint heads
        # (the JAX package's field of the same name, roi_heads.py:93)
        self.mask_fg_capacity = 128
        self.mask_on = cfg.MODEL.MASK_ON
        if self.mask_on:
            mh = cfg.MODEL.ROI_MASK_HEAD
            self.mask_pooler = ROIPooler(
                mh.POOLER_RESOLUTION, scales, mh.POOLER_SAMPLING_RATIO, mh.POOLER_TYPE
            )
            self.mask_head = build_mask_head(
                cfg, ShapeSpec(channels=in_channels, height=mh.POOLER_RESOLUTION, width=mh.POOLER_RESOLUTION)
            )
            self.mask_size = 2 * mh.POOLER_RESOLUTION
        self.keypoint_on = cfg.MODEL.KEYPOINT_ON
        if self.keypoint_on:
            kh = cfg.MODEL.ROI_KEYPOINT_HEAD
            self.keypoint_pooler = ROIPooler(
                kh.POOLER_RESOLUTION, scales, kh.POOLER_SAMPLING_RATIO, kh.POOLER_TYPE
            )
            self.keypoint_head = build_keypoint_head(
                cfg, ShapeSpec(channels=in_channels, height=kh.POOLER_RESOLUTION, width=kh.POOLER_RESOLUTION)
            )
            self.normalize_loss_by_visible_keypoints = kh.NORMALIZE_LOSS_BY_VISIBLE_KEYPOINTS
            self.keypoint_loss_weight = kh.LOSS_WEIGHT

    def forward(
        self,
        features: Dict[str, torch.Tensor],
        proposals: torch.Tensor,  # (B, K, 4)
        proposal_scores: torch.Tensor,  # (B, K)
        image_sizes: torch.Tensor,  # (B, 2)
        targets: Optional[Dict[str, torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """Detections in eval mode; in training the loss dict, from the
        ``targets`` (the batch's ``gt_*`` fields) and uniform draws from
        ``generator``."""
        if self.training:
            if targets is None:
                raise ValueError("training the ROI heads needs the gt_* targets")
            return self._forward_train(features, proposals, proposal_scores, targets, generator)
        return self.forward_with_given_boxes(features, self.detect(features, proposals, proposal_scores, image_sizes))

    def detect(
        self,
        features: Dict[str, torch.Tensor],
        proposals: torch.Tensor,  # (B, K, 4)
        proposal_scores: torch.Tensor,  # (B, K)
        image_sizes: torch.Tensor,  # (B, 2)
    ) -> Dict[str, torch.Tensor]:
        """The box branch in eval mode: the box pooler over all B*K
        proposals, the box head, and per-class NMS to (B, D) detections."""
        scores, deltas = self.box_outputs(features, proposals)
        return fast_rcnn_inference(
            scores,
            deltas,
            proposals,
            torch.isfinite(proposal_scores),
            image_sizes,
            self.box2box_transform,
            self.num_classes,
            self.score_thresh,
            self.nms_thresh,
            self.detections_per_image,
        )

    def box_outputs(self, features: Dict[str, torch.Tensor], proposals: torch.Tensor):
        """The box pooler over all B*K proposals and the box head: (B, K, C+1)
        class logits and (B, K, C*4) (or 4, class-agnostic) deltas."""
        feats = [features[f] for f in self.in_features]
        b, k = proposals.shape[:2]
        batch_idx = torch.arange(b, dtype=torch.int32, device=proposals.device)
        box_feats = self.box_pooler(feats, proposals.reshape(b * k, 4), batch_idx.repeat_interleave(k))
        scores, deltas = self.box_predictor(self.box_head(box_feats))
        return scores.reshape(b, k, -1), deltas.reshape(b, k, -1)

    def forward_with_given_boxes(
        self, features: Dict[str, torch.Tensor], detections: Dict[str, torch.Tensor]
    ) -> Dict[str, torch.Tensor]:
        """The per-box branches on (B, D) detections (``boxes``, ``classes``,
        in network-input coordinates), each pooler over all B*D boxes: with
        MASK_ON, ``masks`` (B, D, S, S) probabilities (JAX package
        ``roi_heads.py:319``; the test-time augmentation's mask re-run calls
        it on merged boxes); with KEYPOINT_ON, ``keypoints`` (B, D, K, 4)
        (JAX ``roi_heads.py:305-315,320-335``)."""
        if not (self.mask_on or self.keypoint_on):
            return detections
        feats = [features[f] for f in self.in_features]
        b, d = detections["boxes"].shape[:2]
        boxes = detections["boxes"].reshape(b * d, 4)
        batch_idx = torch.arange(b, dtype=torch.int32, device=boxes.device).repeat_interleave(d)
        detections = dict(detections)
        if self.mask_on:
            probs = mask_rcnn_inference(self.mask_head(self.mask_pooler(feats, boxes, batch_idx)),
                                        detections["classes"].reshape(-1))
            detections["masks"] = probs.reshape((b, d) + probs.shape[-2:])
        if self.keypoint_on:
            heatmaps = self.keypoint_head(self.keypoint_pooler(feats, boxes, batch_idx))
            detections["keypoints"] = keypoint_rcnn_inference(heatmaps, boxes).reshape(b, d, -1, 4)
        return detections

    def sample(self, proposals, proposal_scores, targets, generator, matcher: Optional[Matcher] = None,
               append_gt: Optional[bool] = None) -> Dict[str, torch.Tensor]:
        """``BATCH_SIZE_PER_IMAGE`` slots an image (``sample_proposals``),
        with the positive, negative and slot-order draws from
        ``generator``; ``matcher`` and ``append_gt`` (a cascade stage's)
        default to the heads' own."""
        matcher = self.proposal_matcher if matcher is None else matcher
        append_gt = self.proposal_append_gt if append_gt is None else append_gt
        b, k = proposals.shape[:2]
        n = k + targets["gt_boxes"].shape[1] if append_gt else k
        u_pos, u_neg, u_tie = (torch.rand((b, n), generator=generator, device=proposals.device) for _ in range(3))
        return sample_proposals(
            proposals, proposal_scores, targets["gt_boxes"], targets["gt_classes"],
            targets["gt_valid"], u_pos, u_neg, u_tie,
            num_classes=self.num_classes, batch_size_per_image=self.batch_size_per_image,
            positive_fraction=self.positive_fraction, matcher=matcher, append_gt=append_gt,
        )

    def _forward_train(self, features, proposals, proposal_scores, targets, generator):
        feats = [features[f] for f in self.in_features]
        b = proposals.shape[0]
        dev = proposals.device
        sampled = self.sample(proposals, proposal_scores, targets, generator)
        s = self.batch_size_per_image
        flat_boxes = sampled["boxes"].reshape(b * s, 4)
        batch_idx = torch.arange(b, dtype=torch.int32, device=dev).repeat_interleave(s)
        scores, deltas = self.box_predictor(self.box_head(self.box_pooler(feats, flat_boxes, batch_idx)))
        losses = fast_rcnn_losses(
            scores, deltas, flat_boxes, sampled["gt_classes"].reshape(-1),
            sampled["gt_boxes"].reshape(-1, 4), sampled["valid"].reshape(-1),
            self.box2box_transform, self.num_classes, self.smooth_l1_beta, self.box_reg_loss_type,
        )
        if self.train_on_pred_boxes:
            # the later branches take the boxes the gt class's deltas decode
            # to, as data (JAX roi_heads.py:256-264)
            d = deltas.detach().reshape(b * s, -1, 4)
            cls = sampled["gt_classes"].reshape(-1).long().clamp(0, d.shape[1] - 1)
            sel = torch.gather(d, 1, cls[:, None, None].expand(-1, 1, 4))[:, 0]
            sampled = dict(sampled, boxes=self.box2box_transform.apply_deltas(sel, flat_boxes).reshape(b, s, 4))
        if self.mask_on:
            losses["loss_mask"] = self._forward_mask_train(feats, sampled, targets, generator)
        if self.keypoint_on and "gt_keypoints" in targets:
            losses["loss_keypoint"] = self._forward_keypoint_train(feats, sampled, targets, generator)
        losses.update(self._forward_extra_train(features, sampled, targets, generator))
        return losses

    def _forward_extra_train(self, features, sampled, targets, generator) -> Dict[str, torch.Tensor]:
        """The losses of a subclass's further branches on the sampled slots
        (JAX ``roi_heads.py:339``); none here."""
        return {}

    def _pick_foreground(self, sampled, generator):
        """Up to ``mask_fg_capacity`` foreground slots per image by priority
        1 + u, u uniform from ``generator`` (-inf off the foreground): the
        slots' indices (B, Sm), whether each holds a foreground slot, and
        their boxes (B, Sm, 4)."""
        fg = sampled["fg"]  # (B, S)
        b, s = fg.shape
        sm = min(self.mask_fg_capacity, s)
        u = torch.rand((b, s), generator=generator, device=fg.device)
        priority = torch.where(fg, 1.0 + u, torch.full_like(u, float("-inf")))
        vals, idx = topk_stable(priority, sm)
        return idx, torch.isfinite(vals), torch.gather(sampled["boxes"], 1, idx[..., None].expand(b, sm, 4))

    def _forward_mask_train(self, feats, sampled, targets, generator):
        """The foreground pick (``_pick_foreground``) pooled at 14x14, BCE
        against the resampled crops (JAX ``roi_heads.py:347``)."""
        idx, picked, boxes = self._pick_foreground(sampled, generator)
        b, sm = idx.shape
        classes = torch.gather(sampled["gt_classes"], 1, idx)
        matched = torch.gather(sampled["matched_idx"], 1, idx)
        mask_targets = mask_targets_from_crops(
            targets["gt_mask_crops"], targets["gt_boxes"], matched, boxes, self.mask_size
        )
        batch_idx = torch.arange(b, dtype=torch.int32, device=idx.device).repeat_interleave(sm)
        logits = self.mask_head(self.mask_pooler(feats, boxes.reshape(b * sm, 4), batch_idx))
        return mask_rcnn_loss(
            logits, classes.reshape(-1), mask_targets.reshape(b * sm, self.mask_size, self.mask_size),
            picked.reshape(-1),
        )

    def _forward_keypoint_train(self, feats, sampled, targets, generator):
        """The foreground pick (``_pick_foreground``, its own draw) pooled by
        the keypoint pooler, the heatmap cross entropy against each slot's
        matched ground truth keypoints, times ROI_KEYPOINT_HEAD.LOSS_WEIGHT
        (JAX ``roi_heads.py:403-436``)."""
        idx, picked, boxes = self._pick_foreground(sampled, generator)
        b, sm = idx.shape
        matched = torch.gather(sampled["matched_idx"], 1, idx).long()
        gt = targets["gt_keypoints"].to(torch.float32)
        kpts = torch.gather(gt, 1, matched[..., None, None].expand((b, sm) + gt.shape[2:]))
        flat_boxes = boxes.reshape(b * sm, 4)
        batch_idx = torch.arange(b, dtype=torch.int32, device=idx.device).repeat_interleave(sm)
        logits = self.keypoint_head(self.keypoint_pooler(feats, flat_boxes, batch_idx))
        loss = keypoint_rcnn_loss(logits, kpts.reshape(b * sm, -1, 3), flat_boxes, picked.reshape(-1),
                                  self.normalize_loss_by_visible_keypoints)
        return loss * self.keypoint_loss_weight


def build_roi_heads(cfg, input_shape: Dict[str, ShapeSpec]) -> nn.Module:
    """The ROI heads named by ROI_HEADS.NAME: ``StandardROIHeads``,
    ``CascadeROIHeads``, the C4 ``Res5ROIHeads``, or its WSL name
    ``WSRes5ROIHeads``."""
    name = cfg.MODEL.ROI_HEADS.NAME
    if name == "StandardROIHeads":
        return StandardROIHeads(cfg, input_shape)
    if name == "CascadeROIHeads":
        from .cascade_rcnn import CascadeROIHeads

        return CascadeROIHeads(cfg, input_shape)
    if name == "Res5ROIHeads":
        from .res5_roi_heads import Res5ROIHeads

        return Res5ROIHeads(cfg, input_shape)
    if name == "WSRes5ROIHeads":
        from ...wsl.modeling.roi_heads_wsl import WSRes5ROIHeads

        return WSRes5ROIHeads(cfg, input_shape)
    raise NotImplementedError(f"ROI heads {name!r} are not ported yet")
