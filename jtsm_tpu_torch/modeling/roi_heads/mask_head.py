"""Mask head, its targets and its loss (reference:
detectron2/modeling/roi_heads/mask_head.py ``MaskRCNNConvUpsampleHead``,
``mask_rcnn_loss``, ``mask_rcnn_inference``; JAX package
``roi_heads/mask_head.py``).

Ground truth masks arrive as the JAX package's fixed-size crops rasterised
inside each ground truth box (``gt_mask_crops``, (B, G, M, M)); each
proposal's target is the matched crop resampled under the proposal to gt
box map.

The head computes in the ``TPU.COMPUTE_DTYPE`` that the builder reads (JAX
``mask_head.py:80``) and returns its logits in that dtype; the loss and the
inference select each ROI's class first and cast that map to float32 (JAX
``mask_head.py:139,154``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...layers import Conv2d, ConvTranspose2d, ShapeSpec, compute_dtype, get_norm, normal, variance_scaling
from ...ops.losses import binary_cross_entropy_with_logits
from ...structures.masks import crop_and_resize_masks


class MaskRCNNConvUpsampleHead(nn.Module):
    """3x3 convs, a 2x2/2 deconv with ReLU, a 1x1 predictor: pooled features
    (N, S, S, C) -> mask logits (N, K, 2S, 2S)."""

    def __init__(self, input_shape: ShapeSpec, num_classes: int, num_conv=4, conv_dim=256, norm="", cls_agnostic_mask=False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        c = input_shape.channels
        self.conv_norm_relus = []
        for i in range(num_conv):
            conv = Conv2d(
                c, conv_dim, kernel_size=3, padding=1, bias=not norm,
                norm=get_norm(norm, conv_dim), activation=F.relu, compute_dtype=compute_dtype,
                kernel_init=variance_scaling(2.0, "fan_out", "normal"),
            )
            self.add_module(f"mask_fcn{i + 1}", conv)
            self.conv_norm_relus.append(conv)
            c = conv_dim
        self.deconv = ConvTranspose2d(c, conv_dim, kernel_size=2, stride=2, compute_dtype=compute_dtype)
        self.predictor = Conv2d(
            conv_dim, 1 if cls_agnostic_mask else num_classes, kernel_size=1, compute_dtype=compute_dtype,
            kernel_init=normal(0.001),
        )

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


def mask_targets_from_crops(
    gt_mask_crops: torch.Tensor,  # (B, G, M, M) bool or float
    gt_boxes: torch.Tensor,  # (B, G, 4)
    matched_idx: torch.Tensor,  # (B, N) matched ground truth row of each proposal
    proposal_boxes: torch.Tensor,  # (B, N, 4)
    mask_size: int,
) -> torch.Tensor:
    """(B, N, S, S) float targets: each proposal's box in its matched
    crop's frame, then ``crop_and_resize_masks`` (JAX ``mask_head.py:97``)."""
    b, n = matched_idx.shape
    m = gt_mask_crops.shape[-1]
    rows = matched_idx.long()
    crops = torch.gather(
        gt_mask_crops.to(torch.float32), 1, rows[..., None, None].expand(b, n, m, m)
    ).reshape(b * n, m, m)
    gb = torch.gather(gt_boxes.to(torch.float32), 1, rows[..., None].expand(b, n, 4)).reshape(-1, 4)
    pb = proposal_boxes.reshape(-1, 4)
    gw = (gb[:, 2] - gb[:, 0]).clamp(min=1e-6)
    gh = (gb[:, 3] - gb[:, 1]).clamp(min=1e-6)
    rel = torch.stack(
        [
            (pb[:, 0] - gb[:, 0]) / gw * m,
            (pb[:, 1] - gb[:, 1]) / gh * m,
            (pb[:, 2] - gb[:, 0]) / gw * m,
            (pb[:, 3] - gb[:, 1]) / gh * m,
        ],
        dim=1,
    )
    return crop_and_resize_masks(crops, rel, mask_size).reshape(b, n, mask_size, mask_size)


def mask_rcnn_loss(
    mask_logits: torch.Tensor,  # (N, K, S, S)
    gt_classes: torch.Tensor,  # (N,)
    mask_targets: torch.Tensor,  # (N, S, S) in [0, 1]
    fg_valid: torch.Tensor,  # (N,) rows that count
) -> torch.Tensor:
    """Mean per-pixel BCE of each ROI's class mask against its target
    binarised at 0.5, averaged over the counted ROIs (JAX
    ``mask_head.py:123``)."""
    if mask_logits.shape[1] == 1:
        logits = mask_logits[:, 0]
    else:
        idx = gt_classes.long().clamp(0, mask_logits.shape[1] - 1)
        logits = mask_logits[torch.arange(mask_logits.shape[0], device=idx.device), idx]
    targets = (mask_targets >= 0.5).to(torch.float32)
    per_roi = binary_cross_entropy_with_logits(logits.float(), targets).mean(dim=(1, 2))
    fg = fg_valid.to(torch.float32)
    return (per_roi * fg).sum() / fg.sum().clamp(min=1.0)


def build_mask_head(cfg, input_shape: ShapeSpec) -> MaskRCNNConvUpsampleHead:
    h = cfg.MODEL.ROI_MASK_HEAD
    if h.NAME == "MaskRCNNConvUpsampleHead":
        cls = MaskRCNNConvUpsampleHead
    elif h.NAME in ("MaskRCNNConvUpsampleWSLHead", "MaskRCNNUpsampleWSLHead", "MaskRCNNWSLHead"):
        # the JAX package builds all three names as the conv-upsample WSL
        # head at ROI_MASK_HEAD.NUM_CONV (mask_head_wsl.py:41-50,81-92)
        from ...wsl.modeling.mask_head_wsl import MaskRCNNConvUpsampleWSLHead as cls
    else:
        raise NotImplementedError(f"mask head {h.NAME!r} is not ported yet")
    return cls(
        input_shape, cfg.MODEL.ROI_HEADS.NUM_CLASSES, h.NUM_CONV, h.CONV_DIM, h.NORM,
        h.CLS_AGNOSTIC_MASK, compute_dtype(cfg),
    )
