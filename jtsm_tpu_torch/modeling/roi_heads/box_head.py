"""Box feature head (reference: detectron2/modeling/roi_heads/box_head.py
``FastRCNNConvFCHead``; JAX package ``roi_heads/box_head.py``). Its convs
and fully connected layers compute in the ``TPU.COMPUTE_DTYPE`` that the
builder reads (JAX ``box_head.py:59``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...layers import Conv2d, Linear, ShapeSpec, compute_dtype, get_norm, variance_scaling


class FastRCNNConvFCHead(nn.Module):
    """Optional 3x3 convs, then fully connected layers with ReLU. Takes
    pooled features (R, P, P, C) and flattens them channel-major, (C, P, P),
    as detectron2 does, so ``fc1`` keeps detectron2's weight layout."""

    def __init__(self, input_shape: ShapeSpec, num_conv=0, conv_dim=256, num_fc=2, fc_dim=1024, norm="",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        c, h, w = input_shape.channels, input_shape.height, input_shape.width
        self.conv_norm_relus = []
        for i in range(num_conv):
            conv = Conv2d(
                c, conv_dim, kernel_size=3, padding=1, bias=not norm,
                norm=get_norm(norm, conv_dim), activation=F.relu, compute_dtype=compute_dtype,
            )
            self.add_module(f"conv{i + 1}", conv)
            self.conv_norm_relus.append(conv)
            c = conv_dim
        self.fcs = []
        in_dim = c * h * w
        for i in range(num_fc):
            fc = Linear(in_dim, fc_dim, compute_dtype=compute_dtype,
                        kernel_init=variance_scaling(1.0, "fan_in", "uniform"))
            self.add_module(f"fc{i + 1}", fc)
            self.fcs.append(fc)
            in_dim = fc_dim
        self.output_size = in_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for conv in self.conv_norm_relus:
            x = conv(x)
        if self.fcs:
            x = x.flatten(1)
            for fc in self.fcs:
                x = F.relu(fc(x))
        return x


def build_box_head(cfg, input_shape: ShapeSpec) -> FastRCNNConvFCHead:
    h = cfg.MODEL.ROI_BOX_HEAD
    if (h.NAME or "FastRCNNConvFCHead") != "FastRCNNConvFCHead":
        raise NotImplementedError(f"box head {h.NAME!r} is not ported yet")
    return FastRCNNConvFCHead(
        input_shape, h.NUM_CONV, h.CONV_DIM, h.NUM_FC, h.FC_DIM, h.NORM, compute_dtype(cfg)
    )
