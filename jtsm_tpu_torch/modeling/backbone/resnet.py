"""ResNet backbone (reference: detectron2/modeling/backbone/resnet.py:33
``BasicBlock``, :101 ``BottleneckBlock``, :331 ``BasicStem``, :362
``ResNet``, :563 ``build_resnet_backbone``; JAX package
``modeling/backbone/resnet.py``).

NCHW maps; module names follow detectron2 (``stem.conv1``, ``res2.0.conv1``,
``shortcut``), so ``state_dict()`` keys are detectron2's. FREEZE_AT detaches
the stem (1) and the stages up to res{FREEZE_AT} from the graph, as the JAX
package's ``stop_gradient`` does (``backbone/resnet.py:388-407``): their
parameters get no gradient. Their trainable batch norms (BN, SyncBN) still
normalise with batch statistics and move their running statistics in a
train step, as in the JAX package (FrozenBN has none to move).
Every convolution computes in the ``TPU.COMPUTE_DTYPE`` that
``build_resnet_backbone`` reads (JAX ``backbone/resnet.py:442``) over
float32 parameters. ``RES5_DILATION`` 2 (DC5) runs res5 at stride 1 with
its bottleneck 3x3 convolutions dilated, so res5 keeps stride 16; basic
blocks (R18/R34) take the stride but not the dilation, as the JAX package's
``BasicBlock`` is built (``backbone/resnet.py:337-355``). Both blocks take
a call-time ``dilation`` that replaces their own on the same weights (the
multi-rate trunk of ``wsl/modeling/resnet_wsl.py`` runs res5 at three).
Deformable blocks wait for a later slice.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...layers import Conv2d, ShapeSpec, compute_dtype, get_norm

_DEPTH_TO_BLOCKS = {
    18: [2, 2, 2, 2],
    34: [3, 4, 6, 3],
    50: [3, 4, 6, 3],
    101: [3, 4, 23, 3],
    152: [3, 8, 36, 3],
}


class BasicStem(nn.Module):
    """7x7/2 conv, norm, ReLU, 3x3/2 max pool with padding 1 (JAX :47)."""

    def __init__(self, in_channels: int = 3, out_channels: int = 64, norm: str = "FrozenBN",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(
            in_channels, out_channels, kernel_size=7, stride=2, padding=3, bias=False,
            norm=get_norm(norm, out_channels), activation=F.relu, compute_dtype=compute_dtype,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(self.conv1(x), kernel_size=3, stride=2, padding=1)


def _shortcut(in_channels, out_channels, stride, norm, compute_dtype):
    if in_channels == out_channels and stride == 1:
        return None
    return Conv2d(
        in_channels, out_channels, kernel_size=1, stride=stride, bias=False,
        norm=get_norm(norm, out_channels), compute_dtype=compute_dtype,
    )


class BasicBlock(nn.Module):
    """Two 3x3 convs (R18/R34)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1, norm: str = "FrozenBN",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.shortcut = _shortcut(in_channels, out_channels, stride, norm, compute_dtype)
        self.conv1 = Conv2d(
            in_channels, out_channels, kernel_size=3, stride=stride, padding=1, bias=False,
            norm=get_norm(norm, out_channels), activation=F.relu, compute_dtype=compute_dtype,
        )
        self.conv2 = Conv2d(
            out_channels, out_channels, kernel_size=3, padding=1, bias=False,
            norm=get_norm(norm, out_channels), compute_dtype=compute_dtype,
        )

    def forward(self, x: torch.Tensor, dilation: int = 0) -> torch.Tensor:
        """``dilation``, when given, dilates (and pads) both 3x3 convs for
        this call (JAX ``backbone/resnet.py:66-70``)."""
        out = self.conv2(self.conv1(x, dilation), dilation)
        shortcut = x if self.shortcut is None else self.shortcut(x)
        return F.relu(out + shortcut)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1, the stride on the 1x1 when ``stride_in_1x1``."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        bottleneck_channels: int,
        stride: int = 1,
        num_groups: int = 1,
        norm: str = "FrozenBN",
        stride_in_1x1: bool = True,
        compute_dtype: torch.dtype = torch.float32,
        dilation: int = 1,
    ):
        super().__init__()
        stride_1x1, stride_3x3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.shortcut = _shortcut(in_channels, out_channels, stride, norm, compute_dtype)
        self.conv1 = Conv2d(
            in_channels, bottleneck_channels, kernel_size=1, stride=stride_1x1, bias=False,
            norm=get_norm(norm, bottleneck_channels), activation=F.relu,
            compute_dtype=compute_dtype,
        )
        self.conv2 = Conv2d(
            bottleneck_channels, bottleneck_channels, kernel_size=3, stride=stride_3x3,
            padding=dilation, dilation=dilation, groups=num_groups, bias=False,
            norm=get_norm(norm, bottleneck_channels), activation=F.relu,
            compute_dtype=compute_dtype,
        )
        self.conv3 = Conv2d(
            bottleneck_channels, out_channels, kernel_size=1, bias=False,
            norm=get_norm(norm, out_channels), compute_dtype=compute_dtype,
        )

    def forward(self, x: torch.Tensor, dilation: int = 0) -> torch.Tensor:
        """``dilation``, when given, replaces the 3x3 conv's own dilation
        (and padding) for this call; the stride stays (JAX
        ``backbone/resnet.py:123-124``)."""
        out = self.conv3(self.conv2(self.conv1(x), dilation))
        shortcut = x if self.shortcut is None else self.shortcut(x)
        return F.relu(out + shortcut)


class ResNet(nn.Module):
    def __init__(
        self,
        depth: int = 50,
        stem_out_channels: int = 64,
        res2_out_channels: int = 256,
        num_groups: int = 1,
        width_per_group: int = 64,
        stride_in_1x1: bool = True,
        norm: str = "FrozenBN",
        out_features: Sequence[str] = ("res4",),
        freeze_at: int = 0,
        compute_dtype: torch.dtype = torch.float32,
        res5_dilation: int = 1,
        stem: nn.Module | None = None,
    ):
        super().__init__()
        self.freeze_at = freeze_at
        if depth not in _DEPTH_TO_BLOCKS:
            raise ValueError(f"ResNet depth {depth} is not one of {sorted(_DEPTH_TO_BLOCKS)}")
        if res5_dilation not in (1, 2):
            raise ValueError(f"RES5_DILATION {res5_dilation} is not 1 or 2")
        self.res5_dilation = res5_dilation
        self.out_features = tuple(out_features)
        self.stem = stem if stem is not None else BasicStem(3, stem_out_channels, norm, compute_dtype)
        is_basic = depth in (18, 34)
        if is_basic and res2_out_channels != 64:
            raise ValueError("Must set MODEL.RESNETS.RES2_OUT_CHANNELS = 64 for R18/R34")
        max_stage = max(int(f[3:]) for f in self.out_features if f != "stem")

        in_channels = stem_out_channels
        out_channels = res2_out_channels
        bottleneck_channels = num_groups * width_per_group
        self.stage_names = []
        self._out_channels = {"stem": stem_out_channels}
        for idx, stage_idx in enumerate(range(2, max_stage + 1)):
            dilation = res5_dilation if stage_idx == 5 else 1
            first_stride = 1 if idx == 0 or dilation == 2 else 2
            blocks = []
            for b in range(_DEPTH_TO_BLOCKS[depth][idx]):
                stride = first_stride if b == 0 else 1
                if is_basic:
                    block = BasicBlock(in_channels, out_channels, stride, norm, compute_dtype)
                else:
                    block = BottleneckBlock(
                        in_channels, out_channels, bottleneck_channels, stride,
                        num_groups, norm, stride_in_1x1, compute_dtype, dilation,
                    )
                blocks.append(block)
                in_channels = out_channels
            name = f"res{stage_idx}"
            self.add_module(name, nn.Sequential(*blocks))
            self.stage_names.append(name)
            self._out_channels[name] = out_channels
            out_channels *= 2
            bottleneck_channels *= 2

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        outputs = {}
        x = self.stem(x)
        if self.freeze_at >= 1:
            x = x.detach()
        if "stem" in self.out_features:
            outputs["stem"] = x
        for i, name in enumerate(self.stage_names):
            x = getattr(self, name)(x)
            if self.freeze_at >= i + 2:
                x = x.detach()
            if name in self.out_features:
                outputs[name] = x
        return outputs

    def output_shape(self) -> Dict[str, ShapeSpec]:
        strides = {"stem": 4, "res2": 4, "res3": 8, "res4": 16, "res5": 32 // self.res5_dilation}
        return {
            f: ShapeSpec(channels=self._out_channels[f], stride=strides[f])
            for f in self.out_features
        }


def build_resnet_backbone(cfg, stem: nn.Module | None = None, cls: type = ResNet, **overrides) -> ResNet:
    """The ResNet of MODEL.RESNETS; ``stem`` replaces the basic stem (the
    WSL backbones' 2x2 pool), ``cls`` the class (the multi-rate trunk), and
    ``overrides`` replace or add constructor arguments."""
    r = cfg.MODEL.RESNETS
    if any(r.DEFORM_ON_PER_STAGE):
        raise NotImplementedError("deformable ResNets are not ported yet")
    args = dict(
        depth=r.DEPTH,
        stem_out_channels=r.STEM_OUT_CHANNELS,
        res2_out_channels=r.RES2_OUT_CHANNELS,
        num_groups=r.NUM_GROUPS,
        width_per_group=r.WIDTH_PER_GROUP,
        stride_in_1x1=r.STRIDE_IN_1X1,
        norm=r.NORM,
        out_features=tuple(r.OUT_FEATURES),
        freeze_at=cfg.MODEL.BACKBONE.FREEZE_AT,
        compute_dtype=compute_dtype(cfg),
        res5_dilation=r.RES5_DILATION,
        stem=stem,
    )
    return cls(**{**args, **overrides})
