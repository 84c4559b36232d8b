"""JTSMROIHeads, inference (reference: projects/WSL/wsl/modeling/roi_heads/
roi_heads_jtsm.py:198; JAX package ``wsl/modeling/roi_heads_jtsm.py:131``
``from_config`` :170, ``__call__`` :238-348, ``_inference`` :640,
``_mask_probs`` :706, ``forward_with_given_boxes`` :724).

Per image, the precomputed proposals are pooled on the first input map by
MOIPool (superpixel-masked max pool; RoIPool without superpixels), each
ROI's features are scaled by P^2 / (nonempty bins + 1) and, under
``WSL.USE_OBN``, by (objectness + 1), then go through the DAN and the
refinement branches. Detections average the branches' softmax and their
class-specific deltas before one decode, then take ``wsl_inference``. Masks
come from the refinery heads' mean logits over the mask pooler (ROIAlignV2
on the one map: K1 on the card), or, with ``WSL.TEST_NO_PASTE``, as the
union of the source proposal's superpixels at image resolution.

The MIL layers and the base mask head hold weights used only by the
training losses, which wait for the JTSM training slice; the JAX graph
computes the MIL scores at inference too, where jit drops them unused.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from ...layers import ShapeSpec, compute_dtype
from ...modeling.poolers import ROIPooler
from ...modeling.roi_heads.mask_head import build_mask_head, mask_rcnn_inference
from ...ops.box_regression import Box2BoxTransform
from ..ops import moi_pool, moi_pool_exact, roi_pool
from .mil_heads import MILOutputLayers, OICROutputLayers
from .roi_heads_wsl import DiscriminativeAdaptionNeck, wsl_inference


def _mask_logits(head, x):
    """WSL mask heads return (logits, features); the core head logits."""
    out = head(x)
    return out[0] if isinstance(out, tuple) else out


class JTSMROIHeads(nn.Module):
    def __init__(self, cfg, input_shape: Dict[str, ShapeSpec]):
        super().__init__()
        self.in_features = tuple(cfg.MODEL.ROI_HEADS.IN_FEATURES)
        first = input_shape[self.in_features[0]]
        self.num_classes = cfg.MODEL.ROI_HEADS.NUM_CLASSES
        self.num_classes_stuff = cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES
        self.spatial_scale = 1.0 / first.stride
        self.pool_size = cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION
        self.sampling_ratio = cfg.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO
        w = cfg.WSL
        self.refine_num = w.REFINE_NUM
        self.sp_on = w.SP_ON
        self.sp_grid_stride = w.SP_GRID_STRIDE
        self.moi_pool_exact = w.MOI_POOL_EXACT
        self.moi_nonneg = w.MOI_NONNEG_FEATURES
        self.use_obn = w.USE_OBN
        self.test_no_paste = w.TEST_NO_PASTE
        self.mask_on = cfg.MODEL.MASK_ON
        self.score_thresh_test = cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST
        self.nms_thresh_test = cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST
        self.detections_per_image = cfg.TEST.DETECTIONS_PER_IMAGE
        self.box2box_transform = Box2BoxTransform(weights=cfg.MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS)

        dt = compute_dtype(cfg)
        p = self.pool_size
        self.dan = DiscriminativeAdaptionNeck(first.channels * p * p, cfg.MODEL.ROI_BOX_HEAD.DAN_DIM, 0.5, dt)
        joint = self.num_classes + self.num_classes_stuff - 1
        self.mil = MILOutputLayers(self.dan.output_size, joint, dt)
        refine_reg = tuple(w.REFINE_REG[: self.refine_num])
        self.refine = []
        for k in range(self.refine_num):
            branch = OICROutputLayers(
                self.dan.output_size, self.num_classes,
                with_reg=refine_reg[k] if k < len(refine_reg) else False,
                reg_classes=self.num_classes, compute_dtype=dt,
            )
            self.add_module(f"refine{k}", branch)
            self.refine.append(branch)

        self.mask_refinery: List[nn.Module] = []
        self.mask_head = None
        if self.mask_on:
            res = cfg.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION
            shape = ShapeSpec(channels=first.channels, height=res, width=res)
            # the base head is class-agnostic; the refinery heads keep the
            # config's setting (reference :440-460)
            cfg_base = cfg.clone()
            cfg_base.defrost()
            cfg_base.MODEL.ROI_MASK_HEAD.CLS_AGNOSTIC_MASK = True
            self.mask_head = build_mask_head(cfg_base, shape)
            for i in range(cfg.WSL.MASK_REFINE_NUM):
                head = build_mask_head(cfg, shape)
                self.add_module(f"mask_refinery_{i}", head)
                self.mask_refinery.append(head)
            self.mask_pooler = ROIPooler(
                output_size=res,
                scales=tuple(1.0 / input_shape[f].stride for f in self.in_features),
                sampling_ratio=cfg.MODEL.ROI_MASK_HEAD.POOLER_SAMPLING_RATIO,
                pooler_type="ROIAlignV2",
            )

    def pool(self, feat, proposals, superpixels=None, oh_labels=None):
        """(B, H, W, C) map and (B, R, 4) proposals -> pooled (B*R, P, P, C)
        and the (B, R) count of nonempty bins."""
        b, r = proposals.shape[:2]
        p = self.pool_size
        pooled, nonempty = [], []
        for i in range(b):
            if self.sp_on and superpixels is not None and oh_labels is not None:
                if self.moi_pool_exact:
                    out, bins = moi_pool_exact(
                        feat[i], proposals[i], superpixels[i], oh_labels[i], self.spatial_scale, p
                    )
                else:
                    out, bins = moi_pool(
                        feat[i], proposals[i], superpixels[i], oh_labels[i], self.spatial_scale, p,
                        self.sampling_ratio, self.sp_grid_stride, self.moi_nonneg,
                    )
                    bins = bins > 0  # bins with any member sample
            else:
                out, bins = roi_pool(feat[i], proposals[i], self.spatial_scale, p)
            pooled.append(out)
            nonempty.append(bins.sum(dim=(1, 2)).float())
        return torch.cat(pooled).reshape(b * r, p, p, -1), torch.stack(nonempty)

    def forward(
        self,
        features: Dict[str, torch.Tensor],  # NCHW maps
        proposals: torch.Tensor,  # (B, R, 4)
        proposal_scores: torch.Tensor,  # (B, R), non-finite on padding
        image_sizes: torch.Tensor,  # (B, 2)
        superpixels: Optional[torch.Tensor] = None,  # (B, Hs, Ws)
        oh_labels: Optional[torch.Tensor] = None,  # (B, R, S)
    ) -> Dict[str, torch.Tensor]:
        feat = features[self.in_features[0]].permute(0, 2, 3, 1)  # NHWC view
        pooled, nonempty = self.pool(feat, proposals, superpixels, oh_labels)
        branches = self.refine_branches(pooled, nonempty, proposal_scores)
        det = self.detect(proposals, proposal_scores, branches, image_sizes)
        return self.add_masks(det, features, superpixels, oh_labels)

    def refine_branches(self, pooled, nonempty, proposal_scores):
        """The mask-area and objectness rescale, the DAN and the refinement
        branches: [(logits (B, R, K+1), deltas (B, R, 4K) or None)]."""
        b, r = proposal_scores.shape
        p = self.pool_size
        feat_scale = torch.full_like(nonempty, p * p) / (nonempty + 1.0)
        if self.use_obn:
            valid = torch.isfinite(proposal_scores)
            obj = torch.where(valid, proposal_scores, torch.zeros_like(proposal_scores))
            feat_scale = feat_scale * (obj + 1.0)
        x = self.dan(pooled * feat_scale.reshape(b * r, 1, 1, 1).to(pooled.dtype))
        branches = []
        for head in self.refine:
            logits, deltas = head(x)
            branches.append((logits.reshape(b, r, -1), None if deltas is None else deltas.reshape(b, r, -1)))
        return branches

    def detect(self, proposals, proposal_scores, branches, image_sizes) -> Dict[str, torch.Tensor]:
        """The branches' softmax and class-specific deltas averaged before
        one decode (reference fast_rcnn_oicr.py:712-786), then
        ``wsl_inference``."""
        b, r = proposals.shape[:2]
        ct = self.num_classes
        avg = proposals.new_zeros((b, r, ct))
        for logits, _ in branches:
            avg = avg + torch.softmax(logits, dim=-1)[..., :ct]
        avg = avg / max(self.refine_num, 1)
        final_boxes = proposals
        reg = [d for _, d in branches if d is not None]
        if reg:
            mean_deltas = sum(reg) / len(reg)
            final_boxes = self.box2box_transform.apply_deltas(
                mean_deltas.reshape(-1, 4),
                proposals[:, :, None, :].expand(b, r, ct, 4).reshape(-1, 4),
            ).reshape(b, r, ct, 4)
        det = wsl_inference(
            final_boxes, avg, torch.isfinite(proposal_scores), image_sizes, self.score_thresh_test,
            self.nms_thresh_test, self.detections_per_image,
        )
        det["proposal_class_scores"] = avg
        return det

    def add_masks(self, det, features, superpixels=None, oh_labels=None) -> Dict[str, torch.Tensor]:
        """The detections' masks: with ``WSL.TEST_NO_PASTE`` each source
        proposal's superpixels at image resolution (reference
        roi_heads_jtsm.py:969-997), else the mask branch's probabilities."""
        if self.test_no_paste and self.sp_on and superpixels is not None and oh_labels is not None:
            b, d = det["prop_idx"].shape
            s = oh_labels.shape[-1]
            members = torch.gather(oh_labels.bool(), 1, det["prop_idx"].long()[..., None].expand(b, d, s))
            det["masks_full"] = torch.stack(
                [members[i][:, superpixels[i].long().clamp(0, s - 1)] for i in range(b)]
            )
            det["no_paste"] = det["valid"]
        elif self.mask_on:
            det["masks"] = self._mask_probs(features, det["boxes"], det["classes"])
        return det

    def _mask_probs(self, features, boxes, classes):
        """(B, D, S, S) mask probabilities of each detection's class, from
        the refinery heads' mean logits (reference :952-960)."""
        b, d = boxes.shape[:2]
        feats = [features[f] for f in self.in_features]
        batch_idx = torch.arange(b, dtype=torch.int32, device=boxes.device).repeat_interleave(d)
        mask_feats = self.mask_pooler(feats, boxes.reshape(b * d, 4), batch_idx)
        heads = self.mask_refinery or [self.mask_head]
        logits = _mask_logits(heads[0], mask_feats)
        for head in heads[1:]:
            logits = logits + _mask_logits(head, mask_feats)
        logits = logits / len(heads)
        probs = mask_rcnn_inference(logits, classes.reshape(-1))
        return probs.reshape(b, d, probs.shape[-2], probs.shape[-1])

    def forward_with_given_boxes(self, features, detections: Dict[str, torch.Tensor]):
        """Only the mask branch, on given detections (the TTA mask re-run,
        reference test_time_augmentation_avg.py:405-428)."""
        detections = dict(detections)
        if self.mask_on:
            detections["masks"] = self._mask_probs(features, detections["boxes"], detections["classes"])
        return detections
