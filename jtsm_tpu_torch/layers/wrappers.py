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

Initialisation follows the JAX package's initialisers, so that a model
trained from scratch (MODEL.WEIGHTS "") starts from the same
distributions: each layer draws its kernel from PyTorch's global generator
with ``kernel_init`` (the JAX layers' defaults: MSRA fan-out truncated
normal for convolutions, LeCun normal for linear layers and the
transposed convolution, ``layers/wrappers.py:54,134,199`` and flax's
``ConvTranspose``) and zeroes its bias; heads pass the JAX package's own
choice (``variance_scaling``, ``normal``). Fans are counted on the JAX
package's kernel layout, as flax counts them.
"""

from __future__ import annotations

import contextlib
import dataclasses
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


Init = Callable[[torch.Tensor, int, int], None]


def _truncated_normal_(weight: torch.Tensor, std: float) -> None:
    """A normal of ``std`` truncated at 2 standard deviations: the draws out
    of range (about 5%) are drawn again until none is."""
    flat = weight.view(-1).normal_(0.0, std)
    idx = torch.nonzero(flat.abs() > 2 * std).squeeze(1)
    while idx.numel():
        redrawn = torch.empty(idx.numel(), dtype=weight.dtype, device=weight.device).normal_(0.0, std)
        flat[idx] = redrawn
        idx = idx[redrawn.abs() > 2 * std]


@dataclasses.dataclass(frozen=True)
class _VarianceScaling:
    scale: float
    mode: str
    distribution: str

    def __call__(self, weight: torch.Tensor, fan_in: int, fan_out: int) -> None:
        fan = {"fan_in": fan_in, "fan_out": fan_out, "fan_avg": (fan_in + fan_out) / 2}[self.mode]
        variance = self.scale / max(1.0, fan)
        if self.distribution == "truncated_normal":
            _truncated_normal_(weight, variance ** 0.5 / 0.87962566103423978)
        elif self.distribution == "normal":
            nn.init.normal_(weight, 0.0, variance ** 0.5)
        elif self.distribution == "uniform":
            limit = (3 * variance) ** 0.5
            nn.init.uniform_(weight, -limit, limit)
        else:
            raise ValueError(f"unknown distribution {self.distribution!r}")


@dataclasses.dataclass(frozen=True)
class _Normal:
    std: float

    def __call__(self, weight: torch.Tensor, fan_in: int, fan_out: int) -> None:
        nn.init.normal_(weight, 0.0, self.std)


def variance_scaling(scale: float, mode: str, distribution: str) -> Init:
    """flax's ``variance_scaling``: variance ``scale / fan`` (fan_in,
    fan_out or their mean), drawn from a normal truncated at 2 standard
    deviations and rescaled to that variance, a normal, or a uniform."""
    return _VarianceScaling(scale, mode, distribution)


def normal(std: float) -> Init:
    """flax's ``normal(std)``."""
    return _Normal(std)


MSRA_FILL = variance_scaling(2.0, "fan_out", "truncated_normal")  # the JAX Conv2d's default
LECUN_NORMAL = variance_scaling(1.0, "fan_in", "truncated_normal")  # the JAX Linear's and ConvTranspose's


def _init(layer: nn.Module, fan_in: int, fan_out: int) -> None:
    with torch.no_grad():
        layer.kernel_init(layer.weight, fan_in, fan_out)
        if layer.bias is not None:
            layer.bias.zero_()


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype``, followed by an optional
    norm module and activation (applied in that dtype)."""

    def __init__(
        self,
        *args,
        norm: Optional[nn.Module] = None,
        activation: Optional[Callable] = None,
        compute_dtype: torch.dtype = torch.float32,
        kernel_init: Init = MSRA_FILL,
        **kwargs,
    ):
        self.kernel_init = kernel_init  # read by reset_parameters, which the base __init__ calls
        super().__init__(*args, **kwargs)
        self.norm = norm
        self.activation = activation
        self.compute_dtype = compute_dtype

    def reset_parameters(self) -> None:
        receptive = self.weight[0, 0].numel()
        _init(self, self.weight.shape[1] * receptive, self.weight.shape[0] * receptive)

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

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, kernel_init: Init = LECUN_NORMAL,
                 **kwargs):
        self.kernel_init = kernel_init
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def reset_parameters(self) -> None:
        _init(self, self.in_features, self.out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing in ``compute_dtype`` (detectron2
    uses the plain torch layer)."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, kernel_init: Init = LECUN_NORMAL,
                 **kwargs):
        self.kernel_init = kernel_init
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def reset_parameters(self) -> None:
        receptive = self.weight[0, 0].numel()  # weight (in, out, kh, kw)
        _init(self, self.weight.shape[0] * receptive, self.weight.shape[1] * receptive)

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


def interpolate_bilinear(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear resize of NCHW maps, written out as the JAX package's
    ``layers/wrappers.py:270`` (half-pixel centres, source coordinates
    clamped to [0, size - 1], the low tap at most size - 2), in the input's
    dtype."""
    h, w = x.shape[-2:]
    oh, ow = out_hw
    dev = x.device

    def axis(n_in, n_out):
        pos = (torch.arange(n_out, dtype=torch.float32, device=dev) + 0.5) * (n_in / n_out) - 0.5
        pos = pos.clamp(0.0, n_in - 1.0)
        lo = torch.floor(pos).to(torch.int64).clamp(0, max(n_in - 2, 0))
        hi = torch.minimum(lo + 1, torch.full_like(lo, n_in - 1))
        return lo, hi, (pos - lo).to(x.dtype)

    y0, y1, fy = axis(h, oh)
    x0, x1, fx = axis(w, ow)
    rows0, rows1 = x[..., y0, :], x[..., y1, :]
    top = rows0[..., x0] * (1 - fx) + rows0[..., x1] * fx
    bot = rows1[..., x0] * (1 - fx) + rows1[..., x1] * fx
    return top * (1 - fy)[:, None] + bot * fy[:, None]
