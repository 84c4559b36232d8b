"""Atrous spatial pyramid pooling (reference: detectron2/layers/aspp.py:14;
JAX package ``layers/aspp.py``): a 1x1 convolution ``conv1x1``, three 3x3
convolutions at dilations 6, 12 and 18 (``conv3x3_d6`` ...), and the image
pooled to one cell, through ``image_pool_conv`` and resized back
bilinearly; the five concatenated and projected by the 1x1 ``project``.
Each convolution is followed by its norm (the convolution then has no
bias) and a ReLU, the pooled branch's by a ReLU only. The JAX module's
``pool_kernel_size`` and dropout (0) options, which no configuration sets,
are left out."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .batch_norm import get_norm
from .wrappers import Conv2d, interpolate_bilinear


class ASPP(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, dilations: Sequence[int] = (6, 12, 18), norm: str = "",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if len(dilations) != 3:
            raise ValueError(f"ASPP takes 3 dilations, not {len(dilations)}")

        def conv(name, cin, k, d=1, normed=True):
            layer = Conv2d(cin, out_channels, kernel_size=k, padding=d * (k // 2), dilation=d,
                           bias=not (norm and normed), norm=get_norm(norm, out_channels) if normed else None,
                           activation=F.relu, compute_dtype=compute_dtype)
            self.add_module(name, layer)
            return layer

        self.branches = [conv("conv1x1", in_channels, 1)] + [conv(f"conv3x3_d{d}", in_channels, 3, d)
                                                             for d in dilations]
        self.image_pool_conv = conv("image_pool_conv", in_channels, 1, normed=False)
        self.project = conv("project", 5 * out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW -> NCHW at ``out_channels``."""
        res = [conv(x) for conv in self.branches]
        pooled = self.image_pool_conv(x.mean(dim=(2, 3), keepdim=True))
        res.append(interpolate_bilinear(pooled, tuple(x.shape[-2:])))
        return self.project(torch.cat(res, dim=1))
