"""The WSL segmentation heads (reference:
projects/WSL/wsl/modeling/seg_heads.py:79 ``ASPPHead``, :232
``TwoClassHead``; JAX package ``wsl/modeling/seg_heads.py:24-162``
``ASPPHead``, :166 ``TwoClassHead``)."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ...layers import ASPP, Conv2d, ShapeSpec, compute_dtype, interpolate_bilinear, normal
from ...ops.losses import softmax_cross_entropy
from ..ops import crf_mean_field


class ASPPHead(nn.Module):
    """ASPP over the last of SEM_SEG_HEAD.IN_FEATURES (``aspp``, its width
    SEM_SEG_HEAD.ASSP_CONVS_DIM, its norm SEM_SEG_HEAD.NORM) and a 1x1
    ``predictor`` to SEM_SEG_HEAD.NUM_CLASSES channels (one more for the
    background under SEM_SEG_HEAD.MASK_SOFTMAX), float32 logits at the
    map's stride. Its losses: ``binary_losses``, WSJDS's per-class
    supervision, and ``losses``, the cross entropy against integer targets
    with, under SEM_SEG_HEAD.CONSTRAINT "CRF" and given the images, the
    constraint loss toward the CRF-refined distribution. In eval mode
    under the CRF and given the images, the logits are the log of the CRF's
    refinement (``crf_mean_field`` over the softmax, the images resized
    bilinearly to the logits' grid)."""

    has_loss = True

    def __init__(self, cfg, input_shape: Dict[str, ShapeSpec]):
        super().__init__()
        h = cfg.MODEL.SEM_SEG_HEAD
        self.in_features = tuple(h.IN_FEATURES)
        self.num_classes = h.NUM_CLASSES
        self.common_stride = input_shape[self.in_features[0]].stride
        self.loss_weight = h.LOSS_WEIGHT
        self.ignore_value = h.IGNORE_VALUE
        self.use_crf = h.CONSTRAINT == "CRF"
        self.mask_softmax = bool(h.MASK_SOFTMAX)
        dt = compute_dtype(cfg)
        width = h.ASSP_CONVS_DIM
        self.aspp = ASPP(input_shape[self.in_features[-1]].channels, width, norm=h.NORM, compute_dtype=dt)
        self.predictor = Conv2d(width, self.num_classes + int(self.mask_softmax), kernel_size=1, compute_dtype=dt,
                                kernel_init=normal(0.001))

    def crf(self, logits: torch.Tensor, images: torch.Tensor) -> torch.Tensor:
        """(B, K, h, w) logits and (B, H, W, 3) images -> the CRF-refined
        (B, h, w, K) probabilities."""
        small = interpolate_bilinear(images.float().permute(0, 3, 1, 2), tuple(logits.shape[-2:]))
        return crf_mean_field(torch.softmax(logits, dim=1).permute(0, 2, 3, 1), small.permute(0, 2, 3, 1))

    def forward(self, features: Dict[str, torch.Tensor], images: Optional[torch.Tensor] = None) -> torch.Tensor:
        logits = self.predictor(self.aspp(features[self.in_features[-1]])).float()
        if not self.training and self.use_crf and images is not None:
            logits = torch.log(self.crf(logits, images).clamp(min=1e-8)).permute(0, 3, 1, 2)
        return logits

    def losses(self, logits: torch.Tensor, targets: torch.Tensor, targets_stride: int = 1,
               images: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """``loss_sem_seg`` of (B, K, h, w) logits against (B, H, W) integer
        targets sampled at ``targets_stride``, and ``loss_constraint``:
        under the CRF and given the images, the KL divergence from the CRF's
        refinement (no gradient) to the predicted distribution."""
        if self.common_stride % targets_stride:
            raise ValueError(f"targets at stride {targets_stride} do not divide {self.common_stride}")
        s = self.common_stride // targets_stride
        th, tw = logits.shape[-2:]
        t = targets[:, ::s, ::s][:, :th, :tw].long()
        valid = (t != self.ignore_value) & (t >= 0)
        ce = softmax_cross_entropy(logits.permute(0, 2, 3, 1), t.clamp(0, self.num_classes - 1))
        out = {"loss_sem_seg": (ce * valid).sum() / valid.sum().float().clamp(min=1.0) * self.loss_weight}
        if self.use_crf and images is not None:
            q = self.crf(logits, images).detach()
            log_p = torch.log_softmax(logits, dim=1).permute(0, 2, 3, 1)
            kl = (q * (torch.log(q.clamp(min=1e-8)) - log_p)).sum(dim=-1)
            out["loss_constraint"] = kl.mean() * self.loss_weight
        return out

    def binary_losses(self, logits: torch.Tensor, binary_targets: torch.Tensor,
                      binary_weights: torch.Tensor) -> Dict[str, torch.Tensor]:
        """WSJDS's det-to-seg supervision (JAX :126-162): (B, C, Ht, Wt)
        per-class 0/1 targets and weights taken every (Ht // h)-th row and
        (Wt // w)-th column onto the logits' grid, each class's foreground
        and background weighed again by their counts there; the weighted
        binary cross entropy with logits summed, or under MASK_SOFTMAX the
        (C+1)-way cross entropy (the background where no class is
        foreground) over the cells some class weighs."""
        h, w = logits.shape[-2:]
        sy, sx = max(binary_targets.shape[2] // h, 1), max(binary_targets.shape[3] // w, 1)
        bt = binary_targets[:, :, ::sy, ::sx][:, :, :h, :w]
        bw = binary_weights[:, :, ::sy, ::sx][:, :, :h, :w]
        pos = (bt > 0.5) & (bw > 0)
        neg = (bt <= 0.5) & (bw > 0)
        n_pos = pos.sum(dim=(2, 3), keepdim=True).float().clamp(min=1.0)
        n_neg = neg.sum(dim=(2, 3), keepdim=True).float().clamp(min=1.0)
        zero = torch.zeros((), device=logits.device)
        wgt = torch.where(pos, 1.0 / n_pos, torch.where(neg, 1.0 / n_neg, zero))
        if self.mask_softmax:
            cls = torch.where(pos.any(dim=1), (bt * wgt).argmax(dim=1),
                              torch.full_like(pos[:, 0], self.num_classes, dtype=torch.long))
            valid = (bw > 0).any(dim=1)
            ce = softmax_cross_entropy(logits.permute(0, 2, 3, 1), cls)
            return {"loss_sem_seg": (ce * valid).sum() / valid.sum().float().clamp(min=1.0) * self.loss_weight}
        t = bt.float()
        bce = torch.maximum(logits, zero) - logits * t + torch.log1p(torch.exp(-logits.abs()))
        return {"loss_sem_seg": (bce * wgt).sum() * self.loss_weight}


class TwoClassHead(nn.Module):
    """Constant logits, no parameters and no loss: channel 1 is 1 and
    channel 0 is 0 at every cell of the first input map, so everything that
    is not a thing is background."""

    num_classes = 2
    has_loss = False

    def forward(self, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        f = next(iter(features.values()))
        b, _, h, w = f.shape
        logits = torch.zeros((b, 2, h, w), dtype=torch.float32, device=f.device)
        logits[:, 1] = 1.0
        return logits
