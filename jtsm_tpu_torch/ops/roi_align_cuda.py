"""Wrapper of the CUDA kernel ``csrc/roi_align_fwd.cu``: multilevel ROIAlign
forward on the card.

It replaces the TPU kernel K1 of the JAX package
(``jtsm_tpu/ops/pallas/roi_align_kernel.py``: ``_make_resident_kernel`` via
``_pallas_call_resident`` and ``_make_kernel`` via ``_pallas_call``, both
behind ``roi_align_multilevel_pallas``). Its plain version is
``roi_align.roi_align_multilevel_plain``.

Layout: the kernel reads each level as a contiguous channels-last
(B, Hi, Wi, C) map and writes a contiguous (R, P, P, C) tensor, bin-major
with channels innermost, the order of the plain version. The box head
flattens it as (C, P, P) after ``permute(0, 3, 1, 2)``; the mask head takes
that permuted view as a channels-last NCHW map.

The library is built at the first launch in a process (``cuda_build``);
``KERNEL.launches`` counts launches, and nothing else adds to it.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from .cuda_build import build
from .roi_align import ADAPTIVE_MAX_RATIO, _pair

MAX_LEVELS = 5
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class RoIAlignFwdKernel:
    name = "roi_align_fwd"
    source = "jtsm_tpu_torch/ops/csrc/roi_align_fwd.cu"
    replaces = "jtsm_tpu/ops/pallas/roi_align_kernel.py:212"

    def __init__(self):
        self.launches = 0
        self.built = None

    def load(self):
        if self.built is None:
            built = build(self.name, "roi_align_fwd.cu")
            fn = built.lib.jtsm_roi_align_fwd
            p, i = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [
                i, p, p, p, p, i, i, i, p, p, p, i, i, i, i, i, i, p, p,
            ]
            fn.restype = i
            self.built = built
        return self.built

    def launch(self, features, scales, boxes, batch_indices, levels, ph, pw,
               sampling_ratio, aligned) -> torch.Tensor:
        _check(features, boxes, batch_indices, levels)
        b, _, _, c = features[0].shape
        r = boxes.shape[0]
        out = torch.empty((r, ph, pw, c), dtype=features[0].dtype, device=boxes.device)
        if r == 0:
            return out
        fn = self.load().lib.jtsm_roi_align_fwd
        n = len(features)
        data = (ctypes.c_void_p * n)(*[f.data_ptr() for f in features])
        heights = (ctypes.c_int * n)(*[f.shape[1] for f in features])
        widths = (ctypes.c_int * n)(*[f.shape[2] for f in features])
        scale_arr = (ctypes.c_float * n)(*[float(s) for s in scales])
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = fn(
            _DTYPES[features[0].dtype], data, heights, widths, scale_arr, n, b, c,
            boxes.data_ptr(), batch_indices.data_ptr(), levels.data_ptr(), r,
            ph, pw, int(sampling_ratio), ADAPTIVE_MAX_RATIO, int(bool(aligned)),
            out.data_ptr(), stream,
        )
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed with CUDA error {err}")
        self.launches += 1
        return out


KERNEL = RoIAlignFwdKernel()


def _check(features, boxes, batch_indices, levels):
    if not 1 <= len(features) <= MAX_LEVELS:
        raise ValueError(f"ROIAlign takes 1 to {MAX_LEVELS} levels, got {len(features)}")
    dev = boxes.device
    f0 = features[0]
    if f0.dtype not in _DTYPES:
        raise TypeError(f"ROIAlign kernel takes float32 or bfloat16 features, not {f0.dtype}")
    for f in features:
        if f.device != dev or f.dtype != f0.dtype or f.dim() != 4:
            raise ValueError("features must be 4-D, on the boxes' device, of one dtype")
        if f.shape[0] != f0.shape[0] or f.shape[3] != f0.shape[3]:
            raise ValueError("every level must have the same batch and channels")
        if not f.is_contiguous():
            raise ValueError("features must be contiguous (B, H, W, C)")
    r = boxes.shape[0]
    if boxes.dtype != torch.float32 or boxes.shape != (r, 4) or not boxes.is_contiguous():
        raise ValueError("boxes must be a contiguous (R, 4) float32 tensor")
    for name, t in (("batch_indices", batch_indices), ("levels", levels)):
        if t.dtype != torch.int32 or t.shape != (r,) or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name} must be a contiguous (R,) int32 tensor on {dev}")


class _RoIAlignFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, boxes, batch_indices, levels, geometry, *features):
        scales, ph, pw, sampling_ratio, aligned = geometry
        return KERNEL.launch(
            list(features), scales, boxes, batch_indices, levels, ph, pw,
            sampling_ratio, aligned,
        )

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "the ROIAlign backward kernel (K2, roi_align_kernel.py:416) is not ported yet"
        )


def roi_align_multilevel_cuda(
    features: Sequence[torch.Tensor],
    spatial_scales: Sequence[float],
    boxes: torch.Tensor,
    batch_indices: torch.Tensor,
    levels: torch.Tensor,
    output_size,
    sampling_ratio: int = 0,
    aligned: bool = True,
) -> torch.Tensor:
    """The kernel's entry: arguments as ``roi_align.roi_align_multilevel``,
    all on one CUDA device. Returns (R, P, P, C) in the features' dtype."""
    if boxes.device.type != "cuda":
        raise ValueError("roi_align_multilevel_cuda takes CUDA tensors")
    ph, pw = _pair(output_size)
    # 0 is the adaptive grid; any other value a fixed grid of at least 1
    ratio = 0 if int(sampling_ratio) == 0 else max(int(sampling_ratio), 1)
    geometry = (tuple(float(s) for s in spatial_scales), ph, pw, ratio, bool(aligned))
    return _RoIAlignFwd.apply(boxes, batch_indices, levels, geometry, *features)
