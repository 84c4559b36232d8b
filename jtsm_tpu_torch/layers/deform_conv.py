"""Deformable convolution v1 and v2 (reference: detectron2/layers/deform_conv.py
``DeformConv``, ``ModulatedDeformConv``; JAX package
``layers/deform_conv.py:20-147``).

The JAX package has no kernel for it: each output position gathers, for
each of the K x K taps, a bilinear sample of the input at the tap's place
plus its learned offset (4 corners, a corner outside the map counting 0),
then one matrix product contracts the (B*OH*OW, K*K*Cin) columns with the
(K*K*Cin, Cout) kernel. Here the same in plain PyTorch, forward and
autograd backward (the gathers' backward is a scatter-add), on the CPU and
on the card alike.

Semantics, the JAX package's:

* the grid is centred: tap (i, j) of output (y, x) samples at
  ``(y * stride + (i - (K-1)/2) * dilation + dy, x * stride + (j - (K-1)/2)
  * dilation + dx)`` over ``OH = (H - 1) // stride + 1`` rows (detectron2's
  padding ``dilation * (K - 1) / 2``; no padding argument);
* the offsets come as (dy, dx) pairs per tap, tap-major (channel ``2t`` is
  tap t's dy, ``2t + 1`` its dx, t = i * K + j);
* DCNv2's mask (K*K channels) multiplies each tap's sample;
  ``ModulatedDeformConv`` takes it as logits and applies the sigmoid;
* the input and the kernel are cast to the compute dtype, but the offsets,
  the bilinear weights and the mask are float32, so the samples, the
  columns and the product are float32 under bfloat16 compute (JAX's type
  promotion of a bfloat16 sample times a float32 weight), and so is the
  result.

Layout: NCHW maps in, NCHW out (a view of channels-last rows). The columns
are gathered as channels-last rows, so the product is one ``torch.matmul``
over (B*OH*OW, K*K*Cin): at 800x1344 they hold 16,800 x 1152 float32
numbers an image in res3 (77 MB).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .wrappers import MSRA_FILL


def deform_conv2d(
    x: torch.Tensor,  # (B, Cin, H, W)
    offsets: torch.Tensor,  # (B, 2*K*K, OH, OW), (dy, dx) per tap
    weight: torch.Tensor,  # (Cout, Cin, K, K)
    mask: Optional[torch.Tensor] = None,  # (B, K*K, OH, OW), DCNv2's modulation
    stride: int = 1,
    dilation: int = 1,
) -> torch.Tensor:
    """The deformable convolution of ``x`` (see the module docstring), in
    float32 (float64 when the input or the kernel is), (B, Cout, OH, OW)."""
    b, cin, h, w = x.shape
    cout, _, k, _ = weight.shape
    oh, ow = (h - 1) // stride + 1, (w - 1) // stride + 1
    if offsets.shape != (b, 2 * k * k, oh, ow):
        raise ValueError(f"offsets {tuple(offsets.shape)} are not (B, 2*K*K, OH, OW) = {(b, 2 * k * k, oh, ow)}")
    work = torch.promote_types(torch.float32, torch.promote_types(x.dtype, weight.dtype))
    dev = x.device
    rows = x.permute(0, 2, 3, 1).reshape(b * h * w, cin)

    taps = (torch.arange(k, device=dev, dtype=work) - (k - 1) / 2.0) * dilation
    base_y = (torch.arange(oh, device=dev, dtype=work) * stride)[:, None, None, None] + taps[None, None, :, None]
    base_x = (torch.arange(ow, device=dev, dtype=work) * stride)[None, :, None, None] + taps[None, None, None, :]
    off = offsets.permute(0, 2, 3, 1).to(work).reshape(b, oh, ow, k * k, 2)
    sy = (base_y[None] + off[..., 0].reshape(b, oh, ow, k, k)).reshape(-1)  # (B*OH*OW*K*K,)
    sx = (base_x[None] + off[..., 1].reshape(b, oh, ow, k, k)).reshape(-1)
    y0, x0 = torch.floor(sy), torch.floor(sx)
    fy, fx = (sy - y0)[:, None], (sx - x0)[:, None]
    y0, x0 = y0.to(torch.int64), x0.to(torch.int64)
    image = torch.arange(b, device=dev).repeat_interleave(oh * ow * k * k) * (h * w)

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = image + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        return rows[idx].to(work) * valid[:, None].to(work)

    cols = tap(y0, x0) * (1 - fy) * (1 - fx)
    cols = cols + tap(y0, x0 + 1) * (1 - fy) * fx
    cols = cols + tap(y0 + 1, x0) * fy * (1 - fx)
    cols = cols + tap(y0 + 1, x0 + 1) * fy * fx
    if mask is not None:
        cols = cols * mask.permute(0, 2, 3, 1).to(work).reshape(-1, 1)
    wmat = weight.permute(2, 3, 1, 0).reshape(k * k * cin, cout).to(work)
    out = torch.matmul(cols.reshape(b * oh * ow, k * k * cin), wmat)
    return out.reshape(b, oh, ow, cout).permute(0, 3, 1, 2)


class DeformConv(nn.Module):
    """DCNv1 (JAX ``layers/deform_conv.py:82``): a (Cout, Cin, K, K)
    kernel, no bias, and detectron2's optional ``norm`` after it; the
    offsets come from the caller. The input and the kernel are cast to
    ``compute_dtype``; the result is float32 (see the module docstring).
    The kernel is drawn as the JAX package draws it
    (``variance_scaling(2.0, "fan_out", "truncated_normal")`` on its
    (K, K, Cin, Cout) layout)."""

    modulated = False

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, stride: int = 1,
                 dilation: int = 1, norm: Optional[nn.Module] = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride = stride
        self.dilation = dilation
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size, kernel_size))
        receptive = kernel_size * kernel_size
        with torch.no_grad():
            MSRA_FILL(self.weight, in_channels * receptive, out_channels * receptive)
        self.norm = norm

    def _apply_conv(self, x, offsets, mask):
        dt = self.compute_dtype
        y = deform_conv2d(x.to(dt), offsets, self.weight.to(dt), mask, self.stride, self.dilation)
        return y if self.norm is None else self.norm(y)

    def forward(self, x: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
        return self._apply_conv(x, offsets, None)

    def extra_repr(self) -> str:
        o, i, k, _ = self.weight.shape
        return f"{i}, {o}, kernel_size={k}, stride={self.stride}, dilation={self.dilation}"


class ModulatedDeformConv(DeformConv):
    """DCNv2 (JAX ``layers/deform_conv.py:115``): ``DeformConv`` with a
    mask of K*K logits, whose sigmoid (float32) scales each tap's sample."""

    modulated = True

    def forward(self, x: torch.Tensor, offsets: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        work = torch.promote_types(torch.float32, mask.dtype)
        return self._apply_conv(x, offsets, torch.sigmoid(mask.to(work)))
