"""Region Proposal Network, inference (reference:
detectron2/modeling/proposal_generator/rpn.py:68 ``StandardRPNHead``, :143
``RPN``; JAX package ``proposal_generator/rpn.py``).

Module names follow detectron2 (``rpn_head.conv``,
``rpn_head.objectness_logits``, ``rpn_head.anchor_deltas``). The training
branch (anchor matching, sampling, losses) comes with the training slice."""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from ...layers import Conv2d, ShapeSpec
from ...ops.box_regression import Box2BoxTransform
from ..anchor_generator import build_anchor_generator
from .proposal_utils import find_top_rpn_proposals, topk_stable


class StandardRPNHead(nn.Module):
    """3x3 conv -> (objectness 1x1, deltas 1x1), shared across levels."""

    def __init__(self, in_channels: int, num_anchors: int, box_dim: int = 4, conv_dims=(-1,)):
        super().__init__()
        if len(conv_dims) != 1:
            raise NotImplementedError("an RPN head of several convs is not ported yet")
        out_c = in_channels if conv_dims[0] == -1 else conv_dims[0]
        self.conv = Conv2d(in_channels, out_c, kernel_size=3, padding=1, activation=F.relu)
        self.objectness_logits = nn.Conv2d(out_c, num_anchors, kernel_size=1)
        self.anchor_deltas = nn.Conv2d(out_c, num_anchors * box_dim, kernel_size=1)

    def forward(self, features: List[torch.Tensor]):
        logits, deltas = [], []
        for x in features:
            t = self.conv(x)
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
            tuple(cfg.MODEL.RPN.CONV_DIMS),
        )
        self.box2box_transform = Box2BoxTransform(weights=cfg.MODEL.RPN.BBOX_REG_WEIGHTS)
        self.pre_nms_topk = cfg.MODEL.RPN.PRE_NMS_TOPK_TEST
        self.post_nms_topk = cfg.MODEL.RPN.POST_NMS_TOPK_TEST
        self.nms_thresh = cfg.MODEL.RPN.NMS_THRESH
        self.min_box_size = float(cfg.MODEL.PROPOSAL_GENERATOR.MIN_SIZE)

    def forward(self, image_sizes: torch.Tensor, features: Dict[str, torch.Tensor]):
        """(B, 2) true image sizes and the feature maps -> (B, K, 4)
        proposals and (B, K) objectness logits, -inf on padding."""
        feats = [features[f] for f in self.in_features]
        logits, deltas = self.rpn_head(feats)
        anchors = self.anchor_generator([tuple(f.shape[-2:]) for f in feats], feats[0].device)
        b = feats[0].shape[0]
        boxes_lvls, score_lvls = [], []
        for anc, lg, dl in zip(anchors, logits, deltas):
            # (B, A, H, W) -> (B, H*W*A); (B, A*4, H, W) -> (B, H*W*A, 4):
            # location-major like the anchors
            lg = lg.permute(0, 2, 3, 1).reshape(b, -1).float()
            dl = dl.permute(0, 2, 3, 1).reshape(b, -1, 4).float()
            # top-k on the raw objectness first, then decode only the survivors
            k = min(self.pre_nms_topk, lg.shape[1])
            topv, topi = topk_stable(lg, k)
            sel = torch.gather(dl, 1, topi[..., None].expand(b, k, 4))
            boxes_lvls.append(self.box2box_transform.apply_deltas(sel, anc[topi]))
            score_lvls.append(topv)
        return find_top_rpn_proposals(
            boxes_lvls, score_lvls, image_sizes, self.nms_thresh,
            self.pre_nms_topk, self.post_nms_topk, self.min_box_size,
        )


def build_proposal_generator(cfg, input_shape: Dict[str, ShapeSpec]) -> RPN:
    name = cfg.MODEL.PROPOSAL_GENERATOR.NAME
    if name != "RPN":
        raise NotImplementedError(f"proposal generator {name!r} is not ported yet")
    return RPN(cfg, input_shape)
