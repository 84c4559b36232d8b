"""WS-ResNet backbones for WSOD (reference:
projects/WSL/wsl/modeling/backbone/resnet_wsl.py:631
``build_wsl_resnet_backbone``, resnet_wsl_v2.py:749 and
resnet_wsl_mrrp.py:1033; JAX package ``wsl/modeling/resnet_wsl.py``): the
ResNet with the DRN-WSOD stem, whose max pool is 2x2 with stride 2 and no
padding (:23-80); the multi-rate trunk ``MRRPWSLResNet`` (:83-157); and
the FPN over the WS-ResNet (:161-190)."""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...layers import Conv2d, compute_dtype, get_norm
from ...modeling.backbone.fpn import FPN, build_resnet_fpn_backbone
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


def build_wsl_resnet_backbone(cfg, **overrides) -> ResNet:
    """The ResNet of MODEL.RESNETS on the WSL stem; ``overrides`` go to
    ``build_resnet_backbone``."""
    r = cfg.MODEL.RESNETS
    stem = WSLStem(3, r.STEM_OUT_CHANNELS, r.NORM, compute_dtype(cfg))
    return build_resnet_backbone(cfg, stem=stem, **overrides)


def build_wsl_resnet_v2_backbone(cfg) -> ResNet:
    """The reference registers the v2 builder with the same config surface
    (JAX ``resnet_wsl.py:78``)."""
    return build_wsl_resnet_backbone(cfg)


class MRRPWSLResNet(ResNet):
    """The WS-ResNet whose ``mrrp_stage`` runs as a multi-rate pyramid: its
    blocks, with their one set of weights, run ``num_branch`` times, branch
    i at call-time dilation ``branch_dilations[i]``, which replaces the
    stage's own (so WSR-50's res5 under RES5_DILATION 2 keeps stride 1, and
    its branch 0 runs at dilation 1); the stride stays. The branches run
    on through the later stages and each output is their concatenation on
    the batch axis, branch-major: image i of branch k is row i + k * B.
    FREEZE_AT detaches each branch. Every branch runs whatever the mode
    (MRRP.TEST_BRANCH_IDX is not read, as in the JAX package, whose
    backbone is always called in its training form)."""

    def __init__(self, *args, num_branch: int = 3, branch_dilations: Sequence[int] = (1, 2, 3),
                 mrrp_stage: str = "res5", **kwargs):
        super().__init__(*args, **kwargs)
        if mrrp_stage not in self.stage_names:
            raise ValueError(f"MRRP stage {mrrp_stage!r} is not one of {self.stage_names}")
        self.mrrp_stage = mrrp_stage
        self.branch_dilations = tuple(branch_dilations)[:num_branch]

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        outputs = {}
        x = self.stem(x)
        if self.freeze_at >= 1:
            x = x.detach()
        if "stem" in self.out_features:
            outputs["stem"] = x
        xs = [x]
        for i, name in enumerate(self.stage_names):
            stage = getattr(self, name)
            if name == self.mrrp_stage:
                xs = [xs[0]] * len(self.branch_dilations)
                for block in stage:
                    xs = [block(b, d) for b, d in zip(xs, self.branch_dilations)]
            else:
                xs = [stage(b) for b in xs]
            if self.freeze_at >= i + 2:
                xs = [b.detach() for b in xs]
            if name in self.out_features:
                outputs[name] = xs[0] if len(xs) == 1 else torch.cat(xs)
        return outputs


def build_mrrp_wsl_resnet_backbone(cfg) -> MRRPWSLResNet:
    """The multi-rate WS-ResNet of MODEL.RESNETS and MODEL.MRRP (JAX
    ``resnet_wsl.py:137``; also under the transposed name
    ``build_wsl_mrrp_resnet_backbone`` that the reference's
    ``oicr_TRD_WSR_50_DC5_1x.yaml`` gives it, :209)."""
    m = cfg.MODEL.MRRP
    return build_wsl_resnet_backbone(cfg, cls=MRRPWSLResNet, num_branch=m.NUM_BRANCH,
                                     branch_dilations=tuple(m.BRANCH_DILATIONS), mrrp_stage=m.MRRP_STAGE)


def build_wsl_resnet_fpn_backbone(cfg) -> FPN:
    """The FPN of MODEL.FPN with the ``LastLevelMaxPool`` p6 over the
    WS-ResNet, which runs res5 undilated and returns res2-res5 whatever
    MODEL.RESNETS says (JAX ``resnet_wsl.py:161``)."""
    bottom_up = build_wsl_resnet_backbone(cfg, res5_dilation=1, out_features=("res2", "res3", "res4", "res5"))
    return build_resnet_fpn_backbone(cfg, bottom_up=bottom_up)
