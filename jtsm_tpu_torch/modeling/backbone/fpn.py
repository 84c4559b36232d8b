"""Feature Pyramid Network with the ``LastLevelMaxPool`` p6 (reference:
detectron2/modeling/backbone/fpn.py:16, :173, :202; JAX package
``modeling/backbone/fpn.py``). The laterals and outputs compute in the
``TPU.COMPUTE_DTYPE`` that the builder reads (JAX ``fpn.py:162``), and the
top-down sums and the p6 pool run in that dtype too."""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...layers import Conv2d, ShapeSpec, compute_dtype, get_norm, interpolate_nearest
from .resnet import ResNet, build_resnet_backbone


class FPN(nn.Module):
    """Laterals, a nearest x2 top-down sum, 3x3 outputs and p6 as a
    stride-2 subsample of p5. Module names are detectron2's
    (``bottom_up``, ``fpn_lateral{k}``, ``fpn_output{k}``)."""

    def __init__(
        self,
        bottom_up: ResNet,
        in_features: Sequence[str],
        out_channels: int,
        norm: str = "",
        fuse_type: str = "sum",
        compute_dtype: torch.dtype = torch.float32,
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
        self.stages = [int(math.log2(s)) for s in self.in_strides]
        for f, k in zip(self.in_features, self.stages):
            self.add_module(f"fpn_lateral{k}", Conv2d(
                shapes[f].channels, out_channels, kernel_size=1, bias=not norm,
                norm=get_norm(norm, out_channels), compute_dtype=compute_dtype,
            ))
            self.add_module(f"fpn_output{k}", Conv2d(
                out_channels, out_channels, kernel_size=3, padding=1, bias=not norm,
                norm=get_norm(norm, out_channels), compute_dtype=compute_dtype,
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
        # LastLevelMaxPool: p6 = max_pool(p5, kernel 1, stride 2)
        outputs[f"p{self.stages[-1] + 1}"] = F.max_pool2d(outputs[f"p{self.stages[-1]}"], 1, 2)
        return outputs

    def output_shape(self) -> Dict[str, ShapeSpec]:
        strides = self.in_strides + [self.in_strides[-1] * 2]
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


def build_backbone(cfg) -> nn.Module:
    from ...wsl.modeling.resnet_wsl import build_wsl_resnet_backbone, build_wsl_resnet_v2_backbone

    name = cfg.MODEL.BACKBONE.NAME
    builders = {
        "build_resnet_backbone": build_resnet_backbone,
        "build_resnet_fpn_backbone": build_resnet_fpn_backbone,
        "build_wsl_resnet_backbone": build_wsl_resnet_backbone,
        "build_wsl_resnet_v2_backbone": build_wsl_resnet_v2_backbone,
    }
    if name not in builders:
        raise NotImplementedError(f"backbone {name!r} is not ported yet")
    return builders[name](cfg)
