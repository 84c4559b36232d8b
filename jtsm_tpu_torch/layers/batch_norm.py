"""Normalization layers (reference: detectron2/layers/batch_norm.py:14
``FrozenBatchNorm2d``, :128 ``get_norm``, :171 ``NaiveSyncBatchNorm``; JAX
package ``layers/batch_norm.py``).

FrozenBN, trainable batch norm (BN and the SyncBN names), GN (the FPN
sem-seg head), LN and none.

Trainable batch norm takes its mode from the call, as the JAX package's
``NaiveSyncBatchNorm`` takes it from whether ``batch_stats`` is mutable:
inside ``with batch_statistics():`` (the train step, PreciseBN) it
normalises with the statistics of the batch and updates its running ones;
everywhere else (serving, scoring, test-time augmentation, and a model
called in ``train()`` mode outside that block, as the JAX package's
``apply(train=True)`` without a mutable ``batch_stats``) it normalises with
the running statistics. ``self.training`` plays no part.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import List

import torch
from torch import nn

_BATCH_STATISTICS = [False]


@contextmanager
def batch_statistics(enabled: bool = True):
    """While the block runs, and when ``enabled``, every
    ``NaiveSyncBatchNorm`` normalises with its batch's statistics and
    updates its running statistics once a call."""
    saved = _BATCH_STATISTICS[0]
    _BATCH_STATISTICS[0] = enabled
    try:
        yield
    finally:
        _BATCH_STATISTICS[0] = saved


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


class NaiveSyncBatchNorm(nn.Module):
    """Batch norm over every axis but the channel (axis 1) of what the
    tensor holds, padding included, as the JAX package's
    ``NaiveSyncBatchNorm`` computes it (``layers/batch_norm.py:45-87``):
    statistics in float32, the biased variance E[x^2] - E[x]^2, ``mul =
    weight * rsqrt(var + eps)``, ``add = bias - mean * mul``, both cast to
    the input's dtype before ``x * mul + add``. The running statistics move
    as ``momentum * old + (1 - momentum) * batch`` (momentum 0.9 weighs the
    old value, and the variance stored is the biased one). One card holds
    the whole batch, so SyncBN is BN. The state dict holds ``weight``,
    ``bias``, ``running_mean`` and ``running_var``, the JAX converter's
    names."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _BATCH_STATISTICS[0]:
            xf = x.float()
            axes = [0] + list(range(2, x.dim()))
            mean = xf.mean(dim=axes)
            var = (xf * xf).mean(dim=axes) - mean * mean
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = self.weight * torch.rsqrt(var + self.eps)
        add = self.bias - mean * mul
        shape = (-1,) + (1,) * (x.dim() - 2)
        return x * mul.to(x.dtype).reshape(shape) + add.to(x.dtype).reshape(shape)

    def extra_repr(self) -> str:
        return f"{self.num_features}, eps={self.eps}, momentum={self.momentum}"


def batch_norms(model: nn.Module) -> List[NaiveSyncBatchNorm]:
    """The model's trainable batch norms, in module order."""
    return [m for m in model.modules() if isinstance(m, NaiveSyncBatchNorm)]


class GroupNorm32(nn.GroupNorm):
    """Group norm over ``gcd(32, C)`` groups, eps 1e-5 (JAX
    ``layers/batch_norm.py:90`` ``GroupNorm32``): statistics and affine in
    float32, the result in the input's dtype, as flax's
    ``GroupNorm(dtype=x.dtype)`` computes them."""

    def __init__(self, num_features: int, num_groups: int = 32, eps: float = 1e-5):
        super().__init__(math.gcd(num_groups, num_features), num_features, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.weight.dtype)  # float32, or float64 in a float64 model
        y = nn.functional.group_norm(x.to(dt), self.num_groups, self.weight, self.bias, self.eps)
        return y.to(x.dtype)


class LayerNormCF(nn.Module):
    """Layer norm over the channels (axis 1) of each position, eps 1e-6
    (JAX ``layers/batch_norm.py:106`` ``LayerNormCF``, flax's ``LayerNorm``
    over the channel-last axis): statistics and affine in float32, the
    result in the input's dtype."""

    def __init__(self, num_features: int, eps: float = 1e-6):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = nn.functional.layer_norm(x.float().movedim(1, -1), (self.num_features,), self.weight, self.bias,
                                     self.eps)
        return y.movedim(-1, 1).to(x.dtype)


_NORMS = {
    "BN": NaiveSyncBatchNorm,
    "SyncBN": NaiveSyncBatchNorm,
    "nnSyncBN": NaiveSyncBatchNorm,
    "naiveSyncBN": NaiveSyncBatchNorm,
    "FrozenBN": FrozenBatchNorm2d,
    "GN": GroupNorm32,
    "LN": LayerNormCF,
}


def get_norm(norm: str | None, out_channels: int) -> nn.Module | None:
    """A norm module for ``out_channels``, or None for "" (reference
    batch_norm.py:128, JAX ``layers/batch_norm.py:117-131``)."""
    if not norm:
        return None
    if norm not in _NORMS:
        raise KeyError(f"Unknown norm type: {norm}")
    return _NORMS[norm](out_channels)
