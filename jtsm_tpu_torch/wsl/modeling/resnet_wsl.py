"""WS-ResNet backbones for WSOD (reference:
projects/WSL/wsl/modeling/backbone/resnet_wsl.py:631
``build_wsl_resnet_backbone`` and resnet_wsl_v2.py:749; JAX package
``wsl/modeling/resnet_wsl.py:23-80``): the ResNet with the DRN-WSOD stem,
whose max pool is 2x2 with stride 2 and no padding. The MRRP and FPN
variants wait for a later slice."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...layers import Conv2d, compute_dtype, get_norm
from ...modeling.backbone.resnet import ResNet, build_resnet_backbone


class WSLStem(nn.Module):
    """7x7/2 conv, norm, ReLU, then a 2x2/2 max pool without padding
    (stride 4, like the basic stem)."""

    def __init__(self, in_channels: int = 3, out_channels: int = 64, norm: str = "FrozenBN",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(
            in_channels, out_channels, kernel_size=7, stride=2, padding=3, bias=False,
            norm=get_norm(norm, out_channels), activation=F.relu, compute_dtype=compute_dtype,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(self.conv1(x), kernel_size=2, stride=2)


def build_wsl_resnet_backbone(cfg) -> ResNet:
    r = cfg.MODEL.RESNETS
    stem = WSLStem(3, r.STEM_OUT_CHANNELS, r.NORM, compute_dtype(cfg))
    return build_resnet_backbone(cfg, stem=stem)


def build_wsl_resnet_v2_backbone(cfg) -> ResNet:
    """The reference registers the v2 builder with the same config surface
    (JAX ``resnet_wsl.py:78``)."""
    return build_wsl_resnet_backbone(cfg)
