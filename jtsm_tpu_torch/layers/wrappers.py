"""Conv/Linear wrappers (reference: detectron2/layers/wrappers.py:40
``Conv2d``; JAX package ``layers/wrappers.py``).

Layout: NCHW activations and OIHW kernels, PyTorch's own. The layers keep
detectron2's parameter names (``weight``, ``bias``, ``norm.*``), so a
model's ``state_dict()`` keys are detectron2's.

Precision follows the JAX package's split (``TPU.COMPUTE_DTYPE``): the
parameters stay float32, and each layer casts its input, weight and bias to
its ``compute_dtype`` inside ``forward``, as the JAX layers cast to their
``dtype`` (``layers/wrappers.py:106-115,240-242``), so autograd hands
float32 gradients back to the float32 parameters. In float32 the casts are
no-ops.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn


def compute_dtype(cfg) -> torch.dtype:
    """The dtype of the compute path named by ``TPU.COMPUTE_DTYPE``, as the
    JAX builders read it (``jnp.bfloat16 if ... == "bfloat16" else
    jnp.float32``)."""
    return torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16" else torch.float32


@contextlib.contextmanager
def exact_float32(enabled: bool = True):
    """While the block runs, and when ``enabled``, float32 matrix products
    and cuDNN convolutions run in full float32 (TF32 off); the caller's
    flags come back afterwards. PyTorch leaves cuDNN's TF32 on by default,
    which keeps about three decimal digits."""
    if not enabled:
        yield
        return
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype``, followed by an optional
    norm module and activation (applied in that dtype)."""

    def __init__(
        self,
        *args,
        norm: Optional[nn.Module] = None,
        activation: Optional[Callable] = None,
        compute_dtype: torch.dtype = torch.float32,
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        self.norm = norm
        self.activation = activation
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = self._conv_forward(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))
        if self.norm is not None:
            x = self.norm(x)
        if self.activation is not None:
            x = self.activation(x)
        return x


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` (detectron2 uses the
    plain torch layer)."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing in ``compute_dtype`` (detectron2
    uses the plain torch layer)."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv_transpose2d(
            x.to(dt), self.weight.to(dt), _cast(self.bias, dt), self.stride, self.padding,
            self.output_padding, self.groups, self.dilation,
        )


def interpolate_nearest(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Nearest-neighbour upsampling of NCHW maps by an integer factor (FPN
    top-down; JAX ``layers/wrappers.py:263``)."""
    return F.interpolate(x, scale_factor=scale, mode="nearest")
