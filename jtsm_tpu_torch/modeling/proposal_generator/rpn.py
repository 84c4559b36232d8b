"""Region Proposal Network (reference:
detectron2/modeling/proposal_generator/rpn.py:68 ``StandardRPNHead``, :143
``RPN``; JAX package ``proposal_generator/rpn.py``).

Module names follow detectron2 (``rpn_head.conv``,
``rpn_head.objectness_logits``, ``rpn_head.anchor_deltas``). In training
the RPN also matches anchors to the padded ground truth, samples them with
uniform draws from the caller's generator and returns its two losses; the
proposals carry no gradient.

The head computes in the ``TPU.COMPUTE_DTYPE`` that the RPN reads (JAX
``rpn.py:120``); its objectness logits and deltas go back to float32 before
top-k, decoding and the losses, as in the JAX package (``rpn.py:185-188``)."""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...layers import Conv2d, ShapeSpec, compute_dtype, normal
from ...ops.box_regression import Box2BoxTransform
from ...ops.losses import binary_cross_entropy_with_logits, giou_loss, smooth_l1_loss
from ...ops.matcher import Matcher
from ...ops.sampling import subsample_labels
from ...structures.boxes import pairwise_iou
from ..anchor_generator import build_anchor_generator
from .proposal_utils import find_top_rpn_proposals, topk_stable


class StandardRPNHead(nn.Module):
    """3x3 conv(s) -> (objectness 1x1, deltas 1x1), shared across levels.
    One entry in ``conv_dims`` builds ``conv`` (detectron2's name); several
    build ``conv0``, ``conv1``, ... in a chain (MODEL.RPN.CONV_DIMS; JAX
    ``rpn.py:44-60``), under the JAX package's names, which its weights
    carry over by (detectron2 nests them as ``conv.conv{i}``). An entry of
    -1 keeps the head's input width, as in the JAX package."""

    def __init__(self, in_channels: int, num_anchors: int, box_dim: int = 4, conv_dims=(-1,),
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        dt = compute_dtype
        self.conv_names = ["conv"] if len(conv_dims) == 1 else [f"conv{i}" for i in range(len(conv_dims))]
        cur = in_channels
        for name, cd in zip(self.conv_names, conv_dims):
            out_c = in_channels if cd == -1 else cd
            setattr(self, name, Conv2d(cur, out_c, kernel_size=3, padding=1, activation=F.relu,
                                       kernel_init=normal(0.01), compute_dtype=dt))
            cur = out_c
        self.objectness_logits = Conv2d(cur, num_anchors, kernel_size=1, compute_dtype=dt, kernel_init=normal(0.01))
        self.anchor_deltas = Conv2d(cur, num_anchors * box_dim, kernel_size=1, compute_dtype=dt,
                                    kernel_init=normal(0.01))

    def forward(self, features: List[torch.Tensor]):
        logits, deltas = [], []
        for x in features:
            t = x
            for name in self.conv_names:
                t = getattr(self, name)(t)
            logits.append(self.objectness_logits(t))
            deltas.append(self.anchor_deltas(t))
        return logits, deltas


class RPN(nn.Module):
    def __init__(self, cfg, input_shape: Dict[str, ShapeSpec]):
        super().__init__()
        if cfg.MODEL.RPN.HEAD_NAME != "StandardRPNHead":
            raise NotImplementedError(f"RPN head {cfg.MODEL.RPN.HEAD_NAME!r} is not ported yet")
        self.in_features = tuple(cfg.MODEL.RPN.IN_FEATURES)
        shapes = [input_shape[f] for f in self.in_features]
        self.anchor_generator = build_anchor_generator(cfg, shapes)
        num_anchors = self.anchor_generator.num_anchors
        if len(set(num_anchors)) != 1:
            raise ValueError("all levels must share one anchor count")
        self.rpn_head = StandardRPNHead(
            shapes[0].channels, num_anchors[0], self.anchor_generator.box_dim,
            tuple(cfg.MODEL.RPN.CONV_DIMS), compute_dtype(cfg),
        )
        r = cfg.MODEL.RPN
        self.box2box_transform = Box2BoxTransform(weights=r.BBOX_REG_WEIGHTS)
        self.pre_nms_topk, self.post_nms_topk = r.PRE_NMS_TOPK_TEST, r.POST_NMS_TOPK_TEST
        self.pre_nms_topk_train, self.post_nms_topk_train = r.PRE_NMS_TOPK_TRAIN, r.POST_NMS_TOPK_TRAIN
        self.nms_thresh = r.NMS_THRESH
        self.min_box_size = float(cfg.MODEL.PROPOSAL_GENERATOR.MIN_SIZE)
        self.anchor_matcher = Matcher(r.IOU_THRESHOLDS, r.IOU_LABELS, allow_low_quality_matches=True)
        self.batch_size_per_image = r.BATCH_SIZE_PER_IMAGE
        self.positive_fraction = r.POSITIVE_FRACTION
        self.boundary_threshold = float(r.BOUNDARY_THRESH)
        self.loss_weight = r.LOSS_WEIGHT
        self.box_reg_loss_weight = r.BBOX_REG_LOSS_WEIGHT
        self.smooth_l1_beta = r.SMOOTH_L1_BETA
        if r.BBOX_REG_LOSS_TYPE not in ("smooth_l1", "giou"):
            raise ValueError(f"RPN box loss {r.BBOX_REG_LOSS_TYPE!r} is not one of smooth_l1, giou")
        self.box_reg_loss_type = r.BBOX_REG_LOSS_TYPE

    def forward(
        self,
        image_sizes: torch.Tensor,
        features: Dict[str, torch.Tensor],
        gt_boxes: Optional[torch.Tensor] = None,
        gt_valid: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        defer_losses: bool = False,
    ):
        """(B, 2) true image sizes and the feature maps -> (B, K, 4)
        proposals and (B, K) objectness logits, -inf on padding, and in
        training the loss dict (``gt_boxes`` (B, G, 4) and ``gt_valid``
        (B, G) then required); in eval the dict is empty. With
        ``defer_losses`` (UWSOD, JAX ``rpn.py:193-206``) training needs no
        ground truth: the dict holds ``_deferred``, what ``get_losses``
        takes once the ground truth is known."""
        anchors, logits, deltas = self.head_outputs(features)
        losses = {}
        if self.training and defer_losses:
            losses = {"_deferred": (torch.cat(anchors), torch.cat(logits, dim=1), torch.cat(deltas, dim=1),
                                    image_sizes)}
        elif self.training:
            if gt_boxes is None or gt_valid is None:
                raise ValueError("training the RPN needs gt_boxes and gt_valid")
            losses = self.get_losses((torch.cat(anchors), torch.cat(logits, dim=1), torch.cat(deltas, dim=1),
                                      image_sizes), gt_boxes, gt_valid, generator)
        proposals, scores = self.predict_proposals(anchors, logits, deltas, image_sizes)
        return proposals, scores, losses

    def get_losses(self, deferred, gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                   generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """The losses of a ``_deferred`` forward against ``gt_boxes`` (B, G,
        4) and ``gt_valid`` (B, G), the sampling's uniform draws (B, anchors)
        twice from ``generator`` (JAX ``rpn.py:220`` ``get_losses``)."""
        anchors, logits, deltas, image_sizes = deferred
        u_pos, u_neg = (torch.rand(logits.shape, generator=generator, device=logits.device) for _ in range(2))
        return self.losses(anchors, logits, deltas, gt_boxes, gt_valid, image_sizes, u_pos, u_neg)

    def head_outputs(self, features: Dict[str, torch.Tensor]):
        """Per level the anchors (Hi*Wi*A, 4), and the head's objectness
        logits (B, Hi*Wi*A) and deltas (B, Hi*Wi*A, 4) in float32, flattened
        location-major like the anchors."""
        feats = [features[f] for f in self.in_features]
        logits, deltas = self.rpn_head(feats)
        anchors = self.anchor_generator([tuple(f.shape[-2:]) for f in feats], feats[0].device)
        b = feats[0].shape[0]
        logits = [lg.permute(0, 2, 3, 1).reshape(b, -1).float() for lg in logits]
        deltas = [dl.permute(0, 2, 3, 1).reshape(b, -1, 4).float() for dl in deltas]
        return anchors, logits, deltas

    def predict_proposals(self, anchors, logits, deltas, image_sizes):
        """Top-k on the raw objectness of each level, then decode only the
        survivors, then ``find_top_rpn_proposals``; gradients are cut, the
        proposals are data to the second stage."""
        pre_k = self.pre_nms_topk_train if self.training else self.pre_nms_topk
        post_k = self.post_nms_topk_train if self.training else self.post_nms_topk
        b = image_sizes.shape[0]
        boxes_lvls, score_lvls = [], []
        for anc, lg, dl in zip(anchors, logits, deltas):
            lg, dl = lg.detach(), dl.detach()
            k = min(pre_k, lg.shape[1])
            topv, topi = topk_stable(lg, k)
            sel = torch.gather(dl, 1, topi[..., None].expand(b, k, 4))
            boxes_lvls.append(self.box2box_transform.apply_deltas(sel, anc[topi]))
            score_lvls.append(topv)
        return find_top_rpn_proposals(
            boxes_lvls, score_lvls, image_sizes, self.nms_thresh,
            pre_k, post_k, self.min_box_size,
        )

    def losses(self, anchors, logits, deltas, gt_boxes, gt_valid, image_sizes, u_pos, u_neg):
        """``loss_rpn_cls`` and ``loss_rpn_loc`` of anchors (N, 4), logits
        (B, N) and deltas (B, N, 4) against the padded ground truth (JAX
        ``rpn.py:246``): match, ignore anchors past ``BOUNDARY_THRESH``,
        sample with the uniform draws ``u_pos`` and ``u_neg`` (B, N),
        objectness BCE over the sampled anchors and, on the positives,
        smooth L1 on the deltas or (BBOX_REG_LOSS_TYPE giou) the GIoU loss
        of the decoded boxes, both over ``BATCH_SIZE_PER_IMAGE * B``."""
        b, n = logits.shape
        gt_boxes = gt_boxes.to(torch.float32)
        iou = pairwise_iou(gt_boxes, anchors)  # (B, G, N)
        matched_idx, match_labels = self.anchor_matcher(iou, gt_valid=gt_valid.bool())
        if self.boundary_threshold >= 0:
            t = self.boundary_threshold
            h = image_sizes[:, 0:1].to(torch.float32)
            w = image_sizes[:, 1:2].to(torch.float32)
            inside = (
                (anchors[:, 0] >= -t) & (anchors[:, 1] >= -t)
                & (anchors[:, 2] < w + t) & (anchors[:, 3] < h + t)
            )
            match_labels = torch.where(inside, match_labels, torch.full_like(match_labels, -1))
        pos_mask, neg_mask = subsample_labels(
            match_labels.to(torch.int32), self.batch_size_per_image, self.positive_fraction, 0,
            u_pos, u_neg,
        )
        sampled = (pos_mask | neg_mask).to(torch.float32)
        obj_loss = (binary_cross_entropy_with_logits(logits, pos_mask.to(torch.float32)) * sampled).sum()
        matched_gt = torch.gather(gt_boxes, 1, matched_idx[..., None].expand(b, n, 4))
        if self.box_reg_loss_type == "smooth_l1":
            target = self.box2box_transform.get_deltas(anchors, matched_gt)
            reg = smooth_l1_loss(deltas, target, self.smooth_l1_beta)
            reg_loss = (reg * pos_mask[..., None].to(torch.float32)).sum()
        else:  # giou on the decoded boxes (JAX rpn.py:287-293)
            reg = giou_loss(self.box2box_transform.apply_deltas(deltas, anchors), matched_gt)
            reg_loss = (reg * pos_mask.to(torch.float32)).sum()
        normalizer = self.batch_size_per_image * b
        return {
            "loss_rpn_cls": obj_loss / normalizer * self.loss_weight,
            "loss_rpn_loc": reg_loss / normalizer * self.loss_weight * self.box_reg_loss_weight,
        }


def build_proposal_generator(cfg, input_shape: Dict[str, ShapeSpec]) -> Optional[RPN]:
    """The RPN, or None for ``PrecomputedProposals``: the model then takes
    the batch's ``proposals`` (JAX ``rpn.py:359-365``)."""
    name = cfg.MODEL.PROPOSAL_GENERATOR.NAME
    if name == "PrecomputedProposals":
        return None
    if name != "RPN":
        raise NotImplementedError(f"proposal generator {name!r} is not ported yet")
    return RPN(cfg, input_shape)
