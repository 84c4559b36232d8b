"""The keypoint head, its loss and its decode (reference:
detectron2/modeling/roi_heads/keypoint_head.py ``KRCNNConvDeconvUpsampleHead``,
``keypoint_rcnn_loss``, ``keypoint_rcnn_inference``; JAX package
``roi_heads/keypoint_head.py:24-58,67-90``).

``score_lowres`` is the JAX package's flax ``ConvTranspose`` (kernel 4,
stride 2, padding "SAME", the kernel not transposed, ``layers/wrappers.py:
171-186``): in PyTorch a ``ConvTranspose2d`` of padding 1, whose weight is
the flax kernel mirrored in both spatial axes (``checkpoint/convert.py``
does it). A 2x bilinear upsample (half-pixel centres) in float32 follows."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...layers import Conv2d, ConvTranspose2d, ShapeSpec, compute_dtype, interpolate_bilinear, variance_scaling
from ...ops.losses import softmax_cross_entropy
from ...structures.keypoints import heatmaps_to_keypoints, keypoints_to_heatmap


class KRCNNConvDeconvUpsampleHead(nn.Module):
    """3x3 conv-ReLU layers ``conv_fcn1..``, the 4x4/2 deconv
    ``score_lowres`` and a 2x bilinear upsample: pooled features (N, S, S, C)
    -> heatmap logits (N, K, 4S, 4S) float32."""

    def __init__(self, input_shape: ShapeSpec, num_keypoints: int, conv_dims, compute_dtype=torch.float32):
        super().__init__()
        c = input_shape.channels
        self.convs = []
        for i, dim in enumerate(conv_dims):
            conv = Conv2d(c, dim, kernel_size=3, padding=1, activation=F.relu, compute_dtype=compute_dtype,
                          kernel_init=variance_scaling(2.0, "fan_out", "normal"))
            self.add_module(f"conv_fcn{i + 1}", conv)
            self.convs.append(conv)
            c = dim
        self.score_lowres = ConvTranspose2d(c, num_keypoints, kernel_size=4, stride=2, padding=1,
                                            compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # channels-last NCHW view
        for conv in self.convs:
            x = conv(x)
        x = self.score_lowres(x).float()
        return interpolate_bilinear(x, (x.shape[-2] * 2, x.shape[-1] * 2))


def build_keypoint_head(cfg, input_shape: ShapeSpec) -> KRCNNConvDeconvUpsampleHead:
    kh = cfg.MODEL.ROI_KEYPOINT_HEAD
    if kh.NAME != "KRCNNConvDeconvUpsampleHead":
        raise NotImplementedError(f"keypoint head {kh.NAME!r} is not ported yet")
    return KRCNNConvDeconvUpsampleHead(input_shape, kh.NUM_KEYPOINTS, tuple(kh.CONV_DIMS), compute_dtype(cfg))


def keypoint_rcnn_loss(
    keypoint_logits: torch.Tensor,  # (N, K, S, S)
    gt_keypoints: torch.Tensor,  # (N, K, 3)
    proposal_boxes: torch.Tensor,  # (N, 4)
    fg_valid: torch.Tensor,  # (N,) rows that count
    normalize_by_visible: bool = True,
) -> torch.Tensor:
    """The cross entropy over each map's S*S bins at its keypoint's bin
    (``keypoints_to_heatmap``), summed over the valid keypoints of the
    counted ROIs, over their number (``normalize_by_visible``) or over the
    number of counted ROIs (JAX ``keypoint_head.py:67``)."""
    n, k, s, _ = keypoint_logits.shape
    heatmaps, valid = keypoints_to_heatmap(gt_keypoints, proposal_boxes, s)
    ce = softmax_cross_entropy(keypoint_logits.float().reshape(n, k, s * s), heatmaps)
    fg = fg_valid.to(torch.float32)
    w = valid.to(torch.float32) * fg[:, None]
    total = (ce * w).sum()
    return total / (w.sum() if normalize_by_visible else fg.sum()).clamp(min=1.0)


def keypoint_rcnn_inference(keypoint_logits: torch.Tensor, pred_boxes: torch.Tensor) -> torch.Tensor:
    """(N, K, S, S) heatmap logits and (N, 4) boxes -> (N, K, 4) keypoints
    (x, y, logit, probability) in the boxes' coordinates."""
    return heatmaps_to_keypoints(keypoint_logits, pred_boxes)
