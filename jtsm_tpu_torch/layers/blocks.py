"""Shared CNN blocks (reference: detectron2/layers/blocks.py:16
``CNNBlockBase``, :58 ``DepthwiseSeparableConv2d``; JAX package
``layers/blocks.py:16,29``)."""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from .batch_norm import get_norm
from .wrappers import Conv2d


class CNNBlockBase(nn.Module):
    """A block with ``in_channels``, ``out_channels`` and ``stride``. As in
    the JAX package it has no ``freeze()``: the backbones stop gradients at
    FREEZE_AT instead."""

    def __init__(self, in_channels: int, out_channels: int, stride: int):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.stride = stride


class DepthwiseSeparableConv2d(nn.Module):
    """A depthwise ``kernel_size`` conv (one group a channel), then a 1x1
    pointwise conv, each with an optional norm (and then no bias) and
    activation; named ``depthwise`` and ``pointwise`` as in both
    references."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, padding: int = 1,
                 dilation: int = 1, *, norm1: Optional[str] = None, activation1: Optional[Callable] = None,
                 norm2: Optional[str] = None, activation2: Optional[Callable] = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depthwise = Conv2d(in_channels, in_channels, kernel_size=kernel_size, padding=padding, dilation=dilation,
                                groups=in_channels, bias=not norm1, norm=get_norm(norm1, in_channels),
                                activation=activation1, compute_dtype=compute_dtype)
        self.pointwise = Conv2d(in_channels, out_channels, kernel_size=1, bias=not norm2,
                                norm=get_norm(norm2, out_channels), activation=activation2,
                                compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.depthwise(x))
