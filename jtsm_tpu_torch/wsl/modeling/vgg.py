"""VGG backbones for WSOD (reference: projects/WSL/wsl/modeling/backbone/vgg.py
``build_vgg_backbone``; JAX package ``wsl/modeling/vgg.py:26-97``).

VGG16's convolutions ``conv{stage}_{i}``, each 3x3 with a bias and a ReLU,
and a 2x2/2 max pool after stages 1-3 and, unless CONV5_DILATION is 2,
after stage 4; with it, stage 5 convolves at dilation 2 and ``plain5`` has
stride 8. ``MRRPVGG`` (JAX :99-237, reference ``vgg_mrrp.py``, UWSOD's
backbone) runs its MODEL.MRRP.MRRP_STAGE as a multi-rate region pyramid:
each of that stage's convolutions (``MRRPConv``) holds one weight and
applies it to each of MODEL.MRRP.NUM_BRANCH copies of the stage's input at
its own dilation, MODEL.MRRP.BRANCH_DILATIONS times CONV5_DILATION in stage
5 ((2, 4, 8) for UWSOD), and the branches' outputs are folded into the
batch, branch-major: (NUM_BRANCH * B, C, H, W). Every branch runs in
serving as in training: the JAX model calls its backbone in its train form
there, so MODEL.MRRP.TEST_BRANCH_IDX is not read.

FREEZE_AT follows the JAX package, not the reference: it detaches the
entries of the outputs dict up to its stage, and nothing else, so with
OUT_FEATURES ["plain5"] every convolution trains (the reference freezes
conv1 and conv2 at FREEZE_AT 2; ROADMAP §3)."""

from __future__ import annotations

from typing import Dict, List, Sequence

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


class MRRPConv(Conv2d):
    """A 3x3 convolution (with its bias and ReLU) whose one weight runs on
    a list of branches, branch i at dilation ``dilations[i]`` (padding the
    same), as the JAX ``MRRPConv`` (reference ``mrrp_conv.py:10``)."""

    def __init__(self, in_channels: int, out_channels: int, dilations: Sequence[int],
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size=3, padding=1, activation=F.relu,
                         compute_dtype=compute_dtype)
        self.dilations = tuple(dilations)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        return [Conv2d.forward(self, x, d) for x, d in zip(xs, self.dilations)]


class MRRPVGG(VGG):
    def __init__(self, depth: int = 16, conv5_dilation: int = 1, out_features: Sequence[str] = ("plain5",),
                 freeze_at: int = 0, compute_dtype: torch.dtype = torch.float32, num_branch: int = 3,
                 branch_dilations: Sequence[int] = (1, 2, 4), mrrp_stage: str = "plain5"):
        super().__init__(depth, conv5_dilation, out_features, freeze_at, compute_dtype)
        if mrrp_stage == "plain1":
            raise NotImplementedError("an MRRP stage plain1 is not ported yet")
        self.mrrp_stage = mrrp_stage
        self.num_branch = num_branch
        stage = int(mrrp_stage[-1])
        base = conv5_dilation if stage == 5 else 1
        dils = tuple(base * d for d in list(branch_dilations)[:num_branch])
        for i, (name, conv) in enumerate(self.layers):
            if conv is not None and name.startswith(f"conv{stage}_"):
                mrrp = MRRPConv(conv.in_channels, conv.out_channels, dils, compute_dtype)
                self.add_module(name, mrrp)
                self.layers[i] = (name, mrrp)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        outputs = {}
        stage, pools = 1, 0
        xs = [x]
        for name, conv in self.layers:
            if isinstance(conv, MRRPConv):
                xs = conv(xs * self.num_branch if len(xs) == 1 else xs)
            elif conv is not None:
                xs = [conv(b) for b in xs]
            else:
                if pools < 3 or self.conv5_dilation == 1:
                    xs = [F.max_pool2d(b, kernel_size=2, stride=2) for b in xs]
                pools += 1
                outputs[f"plain{stage}"] = torch.cat(xs) if len(xs) > 1 else xs[0]
                stage += 1
        outputs[f"plain{stage}"] = torch.cat(xs) if len(xs) > 1 else xs[0]
        return {
            k: (v.detach() if int(k[-1]) <= self.freeze_at else v)
            for k, v in outputs.items() if k in self.out_features
        }


def build_mrrp_vgg_backbone(cfg) -> MRRPVGG:
    v, m = cfg.MODEL.VGG, cfg.MODEL.MRRP
    return MRRPVGG(v.DEPTH, v.CONV5_DILATION, tuple(v.OUT_FEATURES), cfg.MODEL.BACKBONE.FREEZE_AT, compute_dtype(cfg),
                   m.NUM_BRANCH, tuple(m.BRANCH_DILATIONS), m.MRRP_STAGE)
