"""``SemanticSegmentor`` and the FPN semantic-segmentation head (reference:
detectron2/modeling/meta_arch/semantic_seg.py:28, :104 ``SemSegFPNHead``; JAX
package ``modeling/meta_arch/semantic_seg.py:30,146``, the loss :115-135):
each input level goes through 3x3 conv-GN-ReLU layers, each followed by a
2x bilinear upsample until it reaches the common stride; the levels are
summed (cropped to the smallest grid) and a 1x1 predictor gives the logits
at the common stride, in float32. The loss is the cross entropy at the
common stride over the pixels that are not ``IGNORE_VALUE``, times
``LOSS_WEIGHT``."""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...layers import (
    Conv2d,
    ShapeSpec,
    compute_dtype,
    exact_float32,
    get_norm,
    interpolate_bilinear,
    normal,
    variance_scaling,
)
from ...ops.losses import softmax_cross_entropy
from .rcnn import BackboneModel, serving


class SemSegFPNHead(nn.Module):
    has_loss = True

    def __init__(
        self,
        input_shape: Dict[str, ShapeSpec],
        in_features: Sequence[str],
        num_classes: int,
        conv_dims: int = 128,
        common_stride: int = 4,
        norm: str = "GN",
        compute_dtype: torch.dtype = torch.float32,
        loss_weight: float = 1.0,
        ignore_value: int = 255,
    ):
        super().__init__()
        self.in_features = tuple(in_features)
        self.num_classes = num_classes
        self.common_stride = common_stride
        self.loss_weight = loss_weight
        self.ignore_value = ignore_value
        self.heads = {}
        for f in self.in_features:
            stride = input_shape[f].stride
            c = input_shape[f].channels
            head_length = max(1, int(math.log2(stride) - math.log2(common_stride)))
            convs = []
            for k in range(head_length):
                conv = Conv2d(
                    c, conv_dims, kernel_size=3, padding=1, bias=not norm,
                    norm=get_norm(norm, conv_dims), activation=F.relu, compute_dtype=compute_dtype,
                    kernel_init=variance_scaling(1.0, "fan_out", "normal"),
                )
                self.add_module(f"{f}_head_conv{k}", conv)
                convs.append(conv)
                c = conv_dims
            self.heads[f] = (stride, convs)
        self.predictor = Conv2d(conv_dims, num_classes, kernel_size=1, compute_dtype=compute_dtype,
                                kernel_init=normal(0.001))

    def forward(self, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        """NCHW maps -> (B, K, H/common_stride, W/common_stride) float32
        logits."""
        out = None
        for f in self.in_features:
            stride, convs = self.heads[f]
            x = features[f]
            for conv in convs:
                x = conv(x)
                if stride != self.common_stride:
                    x = interpolate_bilinear(x, (x.shape[-2] * 2, x.shape[-1] * 2))
                    stride //= 2
            if out is None:
                out = x
            else:
                hh, ww = min(out.shape[-2], x.shape[-2]), min(out.shape[-1], x.shape[-1])
                out = out[..., :hh, :ww] + x[..., :hh, :ww]
        return self.predictor(out).float()

    def losses(self, logits: torch.Tensor, targets: torch.Tensor, targets_stride: int = 1) -> Dict[str, torch.Tensor]:
        """``loss_sem_seg`` of (B, K, h, w) logits against (B, H, W) integer
        targets sampled at ``targets_stride`` (1: full resolution): every
        (common_stride / targets_stride)-th target, cropped to the logits'
        grid."""
        if self.common_stride % targets_stride:
            raise ValueError(f"targets at stride {targets_stride} do not divide {self.common_stride}")
        rs = self.common_stride // targets_stride
        th, tw = logits.shape[-2:]
        t = targets[:, ::rs, ::rs][:, :th, :tw].long()
        valid = (t != self.ignore_value) & (t >= 0)
        ce = softmax_cross_entropy(logits.permute(0, 2, 3, 1), t.clamp(0, self.num_classes - 1))
        loss = (ce * valid).sum() / valid.sum().float().clamp(min=1.0)
        return {"loss_sem_seg": loss * self.loss_weight}


def build_sem_seg_head(cfg, input_shape: Dict[str, ShapeSpec]) -> nn.Module:
    h = cfg.MODEL.SEM_SEG_HEAD
    if h.NAME == "SemSegFPNHead":
        return SemSegFPNHead(
            input_shape, h.IN_FEATURES, h.NUM_CLASSES, h.CONVS_DIM, h.COMMON_STRIDE, h.NORM,
            compute_dtype(cfg), h.LOSS_WEIGHT, h.IGNORE_VALUE,
        )
    if h.NAME == "TwoClassHead":
        from ...wsl.modeling.seg_heads import TwoClassHead

        return TwoClassHead()
    raise NotImplementedError(f"sem-seg head {h.NAME!r} is not ported yet")


def upsampled_sem_seg(logits: torch.Tensor, image_hw) -> Dict[str, torch.Tensor]:
    """(B, K, h, w) float32 logits at the common stride, bilinearly
    resized to the padded input size (B, H, W): ``sem_seg`` (B, H, W) int32,
    the first of equal maxima, and ``sem_seg_logits`` (B, H, W, K) (JAX
    package ``panoptic_fpn.py:101-105``, ``semantic_seg.py:177-180``)."""
    up = interpolate_bilinear(logits, tuple(image_hw))
    return {"sem_seg": up.argmax(dim=1).to(torch.int32), "sem_seg_logits": up.permute(0, 2, 3, 1)}


class SemanticSegmentor(BackboneModel):
    """The backbone and the sem-seg head (JAX package ``semantic_seg.py:146``):
    ``sem_seg`` and ``sem_seg_logits`` at the padded input size; in train
    mode the head's ``loss_sem_seg`` against the batch's ``gt_sem_seg``
    (B, H, W) (JAX ``semantic_seg.py:167-175``; no draws)."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.sem_seg_head = build_sem_seg_head(cfg, self.backbone.output_shape())

    @serving
    def inference(self, batch: Dict) -> Dict[str, torch.Tensor]:
        with exact_float32(self.compute_dtype == torch.float32):
            features, _ = self._features(batch)
            return upsampled_sem_seg(self.sem_seg_head(features), batch["image"].shape[1:3])

    def forward(self, batch: Dict, generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        if not self.training:
            return self.inference(batch)
        features, _ = self._features(batch)
        targets = torch.as_tensor(batch["gt_sem_seg"], device=self.device)
        return self.sem_seg_head.losses(self.sem_seg_head(features), targets)
