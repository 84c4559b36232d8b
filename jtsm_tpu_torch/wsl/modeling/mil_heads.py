"""MIL scoring layers (reference: projects/WSL/wsl/modeling/roi_heads/
fast_rcnn_wsddn.py, fast_rcnn_tsm.py:573-586, fast_rcnn_oicr.py:166; JAX
package ``wsl/modeling/mil_heads.py`` :34 ``MILOutputLayers``, :98
``wsddn_scores``, :122 ``OICROutputLayers``). Inference only: the losses and
the pseudo-ground-truth mining wait for the JTSM training slice.

The layers compute in ``compute_dtype`` and return float32 logits, as the
JAX layers cast their outputs."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ...layers import Linear


class MILOutputLayers(nn.Module):
    """Two linear branches, ``cls`` and ``det``, over the joint classes."""

    def __init__(self, input_size: int, num_classes: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cls = Linear(input_size, num_classes, compute_dtype=compute_dtype)
        self.det = Linear(input_size, num_classes, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.cls(x).float(), self.det(x).float()


def wsddn_scores(cls_logit: torch.Tensor, det_logit: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(..., R, C) logits and (..., R) validity -> (..., R, C) MIL scores: a
    softmax over classes times a softmax over the valid proposals (invalid
    ones score 0)."""
    s_cls = torch.softmax(cls_logit, dim=-1)
    v = valid[..., None]
    det = torch.where(v, det_logit, torch.full_like(det_logit, float("-inf")))
    s_det = torch.where(v, torch.softmax(det, dim=-2), torch.zeros_like(det))
    return s_cls * s_det


class OICROutputLayers(nn.Module):
    """One refinement branch: a (K+1)-way classifier ``refine_score`` and,
    with ``with_reg``, class-specific box deltas ``refine_reg`` over
    ``reg_classes`` (reference fast_rcnn_oicr.py:488)."""

    def __init__(self, input_size: int, num_classes: int, with_reg: bool = False, reg_classes: int = 1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.refine_score = Linear(input_size, num_classes + 1, compute_dtype=compute_dtype)
        self.refine_reg = (
            Linear(input_size, 4 * reg_classes, compute_dtype=compute_dtype) if with_reg else None
        )

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        deltas = None if self.refine_reg is None else self.refine_reg(x).float()
        return self.refine_score(x).float(), deltas
