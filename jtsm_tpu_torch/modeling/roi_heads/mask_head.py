"""Mask head, inference (reference: detectron2/modeling/roi_heads/mask_head.py
``MaskRCNNConvUpsampleHead``, ``mask_rcnn_inference``; JAX package
``roi_heads/mask_head.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...layers import Conv2d, ConvTranspose2d, ShapeSpec, get_norm


class MaskRCNNConvUpsampleHead(nn.Module):
    """3x3 convs, a 2x2/2 deconv with ReLU, a 1x1 predictor: pooled features
    (N, S, S, C) -> mask logits (N, K, 2S, 2S)."""

    def __init__(self, input_shape: ShapeSpec, num_classes: int, num_conv=4, conv_dim=256, norm="", cls_agnostic_mask=False):
        super().__init__()
        c = input_shape.channels
        self.conv_norm_relus = []
        for i in range(num_conv):
            conv = Conv2d(
                c, conv_dim, kernel_size=3, padding=1, bias=not norm,
                norm=get_norm(norm, conv_dim), activation=F.relu,
            )
            self.add_module(f"mask_fcn{i + 1}", conv)
            self.conv_norm_relus.append(conv)
            c = conv_dim
        self.deconv = ConvTranspose2d(c, conv_dim, kernel_size=2, stride=2)
        self.predictor = nn.Conv2d(conv_dim, 1 if cls_agnostic_mask else num_classes, kernel_size=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # channels-last NCHW view
        for conv in self.conv_norm_relus:
            x = conv(x)
        return self.predictor(F.relu(self.deconv(x)))


def mask_rcnn_inference(mask_logits: torch.Tensor, pred_classes: torch.Tensor) -> torch.Tensor:
    """(N, K, S, S) logits and (N,) classes -> (N, S, S) probabilities of
    each ROI's class."""
    if mask_logits.shape[1] == 1:
        sel = mask_logits[:, 0]
    else:
        idx = pred_classes.long().clamp(0, mask_logits.shape[1] - 1)
        sel = mask_logits[torch.arange(mask_logits.shape[0], device=idx.device), idx]
    return torch.sigmoid(sel.float())


def build_mask_head(cfg, input_shape: ShapeSpec) -> MaskRCNNConvUpsampleHead:
    h = cfg.MODEL.ROI_MASK_HEAD
    if h.NAME != "MaskRCNNConvUpsampleHead":
        raise NotImplementedError(f"mask head {h.NAME!r} is not ported yet")
    return MaskRCNNConvUpsampleHead(
        input_shape, cfg.MODEL.ROI_HEADS.NUM_CLASSES, h.NUM_CONV, h.CONV_DIM, h.NORM,
        h.CLS_AGNOSTIC_MASK,
    )
