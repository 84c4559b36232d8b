"""Normalization layers (reference: detectron2/layers/batch_norm.py:14
``FrozenBatchNorm2d``, :128 ``get_norm``; JAX package ``layers/batch_norm.py``).

Only the norms of the ported main path are here: FrozenBN and none. The
others (BN, SyncBN, GN) wait for a later slice.
"""

from __future__ import annotations

import torch
from torch import nn


class FrozenBatchNorm2d(nn.Module):
    """Batch norm with fixed statistics and affine terms, held as float32
    buffers under detectron2's names, applied as one multiply-add on NCHW
    maps in the input's dtype (JAX ``layers/batch_norm.py:42``): the scale
    and shift are computed in float32 and cast to it."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]

    def extra_repr(self) -> str:
        return f"{self.num_features}, eps={self.eps}"


def get_norm(norm: str | None, out_channels: int) -> nn.Module | None:
    """A norm module for ``out_channels``, or None for "" (reference
    batch_norm.py:128)."""
    if not norm:
        return None
    if norm == "FrozenBN":
        return FrozenBatchNorm2d(out_channels)
    raise NotImplementedError(f"norm {norm!r} is not ported yet")
