"""Conv/Linear wrappers (reference: detectron2/layers/wrappers.py:40
``Conv2d``; JAX package ``layers/wrappers.py``).

Layout: NCHW activations and OIHW kernels, PyTorch's own. ``Conv2d`` keeps
detectron2's parameter names (``weight``, ``bias``, ``norm.*``), so a
model's ``state_dict()`` keys are detectron2's.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

# detectron2 uses the plain torch layers for these
Linear = nn.Linear
ConvTranspose2d = nn.ConvTranspose2d


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` followed by an optional norm module and activation."""

    def __init__(
        self,
        *args,
        norm: Optional[nn.Module] = None,
        activation: Optional[Callable] = None,
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        self.norm = norm
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = super().forward(x)
        if self.norm is not None:
            x = self.norm(x)
        if self.activation is not None:
            x = self.activation(x)
        return x


def interpolate_nearest(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Nearest-neighbour upsampling of NCHW maps by an integer factor (FPN
    top-down; JAX ``layers/wrappers.py:263``)."""
    return F.interpolate(x, scale_factor=scale, mode="nearest")
