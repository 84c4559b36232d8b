"""VGG backbones for WSOD (reference: projects/WSL/wsl/modeling/backbone/vgg.py
``build_vgg_backbone``; JAX package ``wsl/modeling/vgg.py:26-97``).

VGG16's convolutions ``conv{stage}_{i}``, each 3x3 with a bias and a ReLU,
and a 2x2/2 max pool after stages 1-3 and, unless CONV5_DILATION is 2,
after stage 4; with it, stage 5 convolves at dilation 2 and ``plain5`` has
stride 8. The multi-rate form (``MRRPVGG``) waits (ROADMAP queue 1 item
6).

FREEZE_AT follows the JAX package, not the reference: it detaches the
entries of the outputs dict up to its stage, and nothing else, so with
OUT_FEATURES ["plain5"] every convolution trains (the reference freezes
conv1 and conv2 at FREEZE_AT 2; ROADMAP §3)."""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...layers import Conv2d, ShapeSpec, compute_dtype

_VGG_CFGS = {
    16: [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512],
}
_CHANNELS = {"plain1": 64, "plain2": 128, "plain3": 256, "plain4": 512, "plain5": 512}


class VGG(nn.Module):
    def __init__(self, depth: int = 16, conv5_dilation: int = 1, out_features: Sequence[str] = ("plain5",),
                 freeze_at: int = 0, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if depth not in _VGG_CFGS:
            raise ValueError(f"VGG depth {depth} is not one of {sorted(_VGG_CFGS)}")
        self.conv5_dilation = conv5_dilation
        self.out_features = tuple(out_features)
        self.freeze_at = freeze_at
        self.layers = []  # ("pool", None) or (name, conv), in order
        stage, idx, in_channels = 1, 1, 3
        for v in _VGG_CFGS[depth]:
            if v == "M":
                self.layers.append(("pool", None))
                stage, idx = stage + 1, 1
                continue
            d = conv5_dilation if stage == 5 else 1
            conv = Conv2d(in_channels, v, kernel_size=3, padding=d, dilation=d, activation=F.relu,
                          compute_dtype=compute_dtype)
            name = f"conv{stage}_{idx}"
            self.add_module(name, conv)
            self.layers.append((name, conv))
            idx += 1
            in_channels = v

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        outputs = {}
        stage, pools = 1, 0
        for name, conv in self.layers:
            if conv is not None:
                x = conv(x)
                continue
            # the conv4 -> conv5 pool goes when conv5 is dilated
            if pools < 3 or self.conv5_dilation == 1:
                x = F.max_pool2d(x, kernel_size=2, stride=2)
            pools += 1
            outputs[f"plain{stage}"] = x
            stage += 1
        outputs[f"plain{stage}"] = x
        return {
            k: (v.detach() if int(k[-1]) <= self.freeze_at else v)
            for k, v in outputs.items() if k in self.out_features
        }

    def output_shape(self) -> Dict[str, ShapeSpec]:
        strides = {"plain1": 2, "plain2": 4, "plain3": 8, "plain4": 8, "plain5": 8}
        if self.conv5_dilation == 1:
            strides["plain4"], strides["plain5"] = 8, 16
        return {f: ShapeSpec(channels=_CHANNELS[f], stride=strides[f]) for f in self.out_features}

    @property
    def size_divisibility(self) -> int:
        return 16


def build_vgg_backbone(cfg) -> VGG:
    v = cfg.MODEL.VGG
    return VGG(v.DEPTH, v.CONV5_DILATION, tuple(v.OUT_FEATURES), cfg.MODEL.BACKBONE.FREEZE_AT, compute_dtype(cfg))
