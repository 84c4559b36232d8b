"""Feature Pyramid Network with the ``LastLevelMaxPool`` p6 or, for
RetinaNet, the ``LastLevelP6P7`` convolutions on res5 (reference:
detectron2/modeling/backbone/fpn.py:16, :173, :188, :202, :223; JAX package
``modeling/backbone/fpn.py:33,175``). The laterals and outputs compute in
the ``TPU.COMPUTE_DTYPE`` that the builder reads (JAX ``fpn.py:162``), and
the top-down sums, the p6 pool and the P6/P7 convolutions run in that dtype
too."""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...layers import Conv2d, ShapeSpec, compute_dtype, get_norm, interpolate_nearest, variance_scaling
from .resnet import ResNet, build_resnet_backbone


_XAVIER_FILL = variance_scaling(1.0, "fan_in", "uniform")  # JAX package fpn.py:49,58


class LastLevelP6P7(nn.Module):
    """p6 = conv3x3/2(res5), p7 = conv3x3/2(relu(p6)) (reference fpn.py:188;
    JAX ``fpn.py:33``)."""

    num_levels = 2
    in_feature = "res5"

    def __init__(self, in_channels: int, out_channels: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        for name, c in (("p6", in_channels), ("p7", out_channels)):
            self.add_module(name, Conv2d(c, out_channels, kernel_size=3, stride=2, padding=1,
                                         compute_dtype=compute_dtype, kernel_init=_XAVIER_FILL))

    def forward(self, x: torch.Tensor):
        p6 = self.p6(x)
        return [p6, self.p7(F.relu(p6))]


class FPN(nn.Module):
    """Laterals, a nearest x2 top-down sum, 3x3 outputs, and the top block:
    p6 as a stride-2 subsample of the last output, or ``top_block``'s
    levels from its ``in_feature`` of the bottom-up maps. Module names are
    detectron2's (``bottom_up``, ``fpn_lateral{k}``, ``fpn_output{k}``,
    ``top_block.p6``)."""

    def __init__(
        self,
        bottom_up: ResNet,
        in_features: Sequence[str],
        out_channels: int,
        norm: str = "",
        fuse_type: str = "sum",
        compute_dtype: torch.dtype = torch.float32,
        top_block: Optional[nn.Module] = None,
    ):
        super().__init__()
        if fuse_type not in ("sum", "avg"):
            raise ValueError(f"FPN fuse_type {fuse_type!r}")
        self.bottom_up = bottom_up
        self.in_features = tuple(in_features)
        self.fuse_type = fuse_type
        shapes = bottom_up.output_shape()
        self.in_strides = [shapes[f].stride for f in self.in_features]
        self.out_channels = out_channels
        self.top_block = top_block
        self.stages = [int(math.log2(s)) for s in self.in_strides]
        for f, k in zip(self.in_features, self.stages):
            self.add_module(f"fpn_lateral{k}", Conv2d(
                shapes[f].channels, out_channels, kernel_size=1, bias=not norm,
                norm=get_norm(norm, out_channels), compute_dtype=compute_dtype, kernel_init=_XAVIER_FILL,
            ))
            self.add_module(f"fpn_output{k}", Conv2d(
                out_channels, out_channels, kernel_size=3, padding=1, bias=not norm,
                norm=get_norm(norm, out_channels), compute_dtype=compute_dtype, kernel_init=_XAVIER_FILL,
            ))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        bottom_up = self.bottom_up(x)
        laterals = [
            getattr(self, f"fpn_lateral{k}")(bottom_up[f])
            for f, k in zip(self.in_features, self.stages)
        ]
        results = [None] * len(laterals)
        prev = results[-1] = laterals[-1]
        for i in range(len(laterals) - 2, -1, -1):
            h, w = laterals[i].shape[-2:]
            prev = laterals[i] + interpolate_nearest(prev, 2)[..., :h, :w]
            if self.fuse_type == "avg":
                prev = prev / 2.0
            results[i] = prev
        outputs = {
            f"p{k}": getattr(self, f"fpn_output{k}")(r) for k, r in zip(self.stages, results)
        }
        if self.top_block is None:
            # LastLevelMaxPool: p6 = max_pool(p5, kernel 1, stride 2)
            extra = [F.max_pool2d(outputs[f"p{self.stages[-1]}"], 1, 2)]
        else:
            extra = self.top_block(bottom_up[self.top_block.in_feature])
        for i, e in enumerate(extra):
            outputs[f"p{self.stages[-1] + 1 + i}"] = e
        return outputs

    def output_shape(self) -> Dict[str, ShapeSpec]:
        levels = 1 if self.top_block is None else self.top_block.num_levels
        strides = self.in_strides + [self.in_strides[-1] * 2 ** (i + 1) for i in range(levels)]
        return {
            f"p{int(math.log2(s))}": ShapeSpec(channels=self.out_channels, stride=s)
            for s in strides
        }


def build_resnet_fpn_backbone(cfg) -> FPN:
    return FPN(
        bottom_up=build_resnet_backbone(cfg),
        in_features=cfg.MODEL.FPN.IN_FEATURES,
        out_channels=cfg.MODEL.FPN.OUT_CHANNELS,
        norm=cfg.MODEL.FPN.NORM,
        fuse_type=cfg.MODEL.FPN.FUSE_TYPE,
        compute_dtype=compute_dtype(cfg),
    )


def build_retinanet_resnet_fpn_backbone(cfg) -> FPN:
    """The FPN over res3-res5 with P6/P7 from res5 (reference fpn.py:223;
    JAX ``fpn.py:175``)."""
    bottom_up = build_resnet_backbone(cfg)
    dt = compute_dtype(cfg)
    return FPN(
        bottom_up=bottom_up,
        in_features=cfg.MODEL.FPN.IN_FEATURES,
        out_channels=cfg.MODEL.FPN.OUT_CHANNELS,
        norm=cfg.MODEL.FPN.NORM,
        fuse_type=cfg.MODEL.FPN.FUSE_TYPE,
        compute_dtype=dt,
        top_block=LastLevelP6P7(bottom_up.output_shape()["res5"].channels, cfg.MODEL.FPN.OUT_CHANNELS, dt),
    )


def build_backbone(cfg) -> nn.Module:
    from ...wsl.modeling.resnet_wsl import build_wsl_resnet_backbone, build_wsl_resnet_v2_backbone
    from ...wsl.modeling.vgg import build_vgg_backbone

    name = cfg.MODEL.BACKBONE.NAME
    builders = {
        "build_resnet_backbone": build_resnet_backbone,
        "build_resnet_fpn_backbone": build_resnet_fpn_backbone,
        "build_retinanet_resnet_fpn_backbone": build_retinanet_resnet_fpn_backbone,
        "build_wsl_resnet_backbone": build_wsl_resnet_backbone,
        "build_wsl_resnet_v2_backbone": build_wsl_resnet_v2_backbone,
        "build_vgg_backbone": build_vgg_backbone,
    }
    if name not in builders:
        raise NotImplementedError(f"backbone {name!r} is not ported yet")
    return builders[name](cfg)
