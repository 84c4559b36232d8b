"""Wrappers of the CUDA kernels ``csrc/roi_align_fwd.cu`` (K1) and
``csrc/roi_align_bwd.cu`` (K2): multilevel ROIAlign forward and backward on
the card.

K1 replaces the forward TPU kernel of the JAX package
(``jtsm_tpu/ops/pallas/roi_align_kernel.py``: ``_make_resident_kernel`` via
``_pallas_call_resident`` and ``_make_kernel`` via ``_pallas_call``, both
behind ``roi_align_multilevel_pallas``); its plain version is
``roi_align.roi_align_multilevel_plain``. K2 replaces the backward TPU
kernel (``_make_resident_bwd_kernel`` via ``_pallas_call_resident_bwd``);
its plain version is ``roi_align.roi_align_multilevel_backward_plain``.

Layout: K1 reads each level as a contiguous channels-last (B, Hi, Wi, C)
map and writes a contiguous (R, P, P, C) tensor, bin-major with channels
innermost, the order of the plain version. The box head flattens it as
(C, P, P) after ``permute(0, 3, 1, 2)``; the mask head takes that permuted
view as a channels-last NCHW map. K2 reads the (R, P, P, C) cotangent and
returns each level's gradient as a contiguous (B, Hi, Wi, C) tensor, so
autograd's permute back to the backbone's NCHW maps is a free view of
channels-last memory.

Each library is built at its kernel's first launch in a process
(``cuda_build``); ``load_kernels`` builds both at once. Each kernel's
``launches`` counts its launches, and nothing else adds to it. A launch
runs inside the tensors' device guard, on that device's current stream.

Vector width: K1 moves 16 bytes a thread (4 float32 or 8 bfloat16
channels) and K2 4 channels a thread when the channel count is a multiple
of that width and the levels, the output (K1) or the cotangent (K2) lie on
16-byte (K1) or vector-sized (K2) boundaries. Otherwise the C entry launches
the same kernel with one channel a thread: the result is the same and only
the speed differs; nothing falls back to the plain version.
"""

from __future__ import annotations

import ctypes
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence

import torch

from .cuda_build import build
from .roi_align import ADAPTIVE_MAX_RATIO, roi_align_geometry

MAX_LEVELS = 5
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class _Kernel:
    """One CUDA source built into a library with one C entry point."""

    name: str
    source: str
    replaces: str
    entry: str
    argtypes: list

    def __init__(self):
        self.launches = 0
        self.built = None

    def load(self):
        if self.built is None:
            built = build(self.name, self.source.rsplit("/", 1)[-1])
            fn = getattr(built.lib, self.entry)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self.built = built
        return self.built

    def _call(self, device: torch.device, *args):
        """Launch on ``device``, the tensors' card, on its current stream.
        The C entry runs inside that device's guard, so its launch, its
        memset and its error check address the tensors' card whatever
        device is current in the caller."""
        fn = getattr(self.load().lib, self.entry)
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed with CUDA error {err}")
        self.launches += 1


def _level_arrays(shapes, scales):
    n = len(shapes)
    return (
        (ctypes.c_int * n)(*[s[1] for s in shapes]),
        (ctypes.c_int * n)(*[s[2] for s in shapes]),
        (ctypes.c_float * n)(*[float(s) for s in scales]),
    )


_P, _I = ctypes.c_void_p, ctypes.c_int


class RoIAlignFwdKernel(_Kernel):
    name = "roi_align_fwd"
    source = "jtsm_tpu_torch/ops/csrc/roi_align_fwd.cu"
    replaces = "jtsm_tpu/ops/pallas/roi_align_kernel.py:212"
    entry = "jtsm_roi_align_fwd"
    argtypes = [_I, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P]

    def launch(self, features, scales, boxes, batch_indices, levels, ph, pw,
               sampling_ratio, aligned) -> torch.Tensor:
        _check(features, boxes, batch_indices, levels)
        b, _, _, c = features[0].shape
        r = boxes.shape[0]
        out = torch.empty((r, ph, pw, c), dtype=features[0].dtype, device=boxes.device)
        if r == 0:
            return out
        n = len(features)
        data = (ctypes.c_void_p * n)(*[f.data_ptr() for f in features])
        heights, widths, scale_arr = _level_arrays([f.shape for f in features], scales)
        self._call(
            boxes.device, _DTYPES[features[0].dtype], data, heights, widths, scale_arr, n, b, c,
            boxes.data_ptr(), batch_indices.data_ptr(), levels.data_ptr(), r,
            ph, pw, int(sampling_ratio), ADAPTIVE_MAX_RATIO, int(bool(aligned)),
            out.data_ptr(),
        )
        return out


class RoIAlignBwdKernel(_Kernel):
    name = "roi_align_bwd"
    source = "jtsm_tpu_torch/ops/csrc/roi_align_bwd.cu"
    replaces = "jtsm_tpu/ops/pallas/roi_align_kernel.py:416"
    entry = "jtsm_roi_align_bwd"
    argtypes = [_I, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P]

    def launch(self, grad, feature_shapes, scales, boxes, batch_indices, levels,
               sampling_ratio, aligned) -> List[torch.Tensor]:
        """``grad`` (R, P, P, C) -> per level the (B, Hi, Wi, C) gradient,
        contiguous, in ``grad``'s dtype."""
        r, ph, pw, c = grad.shape
        _check_bwd(grad, feature_shapes, boxes, batch_indices, levels)
        dev = grad.device
        sizes = [s[0] * s[1] * s[2] * c for s in feature_shapes]
        if r == 0:
            return [torch.zeros(tuple(s[:3]) + (c,), dtype=grad.dtype, device=dev)
                    for s in feature_shapes]
        accum = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
        out = accum if grad.dtype == torch.float32 else torch.empty_like(accum, dtype=grad.dtype)
        heights, widths, scale_arr = _level_arrays(feature_shapes, scales)
        self._call(
            dev, _DTYPES[grad.dtype], grad.data_ptr(), heights, widths, scale_arr,
            len(feature_shapes), feature_shapes[0][0], c, boxes.data_ptr(),
            batch_indices.data_ptr(), levels.data_ptr(), r, ph, pw, int(sampling_ratio),
            ADAPTIVE_MAX_RATIO, int(bool(aligned)), accum.data_ptr(), out.data_ptr(),
        )
        return [
            g.view(tuple(s[:3]) + (c,)) for g, s in zip(out.split(sizes), feature_shapes)
        ]


KERNEL = RoIAlignFwdKernel()
BWD_KERNEL = RoIAlignBwdKernel()
KERNELS = (KERNEL, BWD_KERNEL)


def load_kernels():
    """Build every kernel library not built yet, one nvcc for each source,
    all at once."""
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        return list(pool.map(lambda k: k.load(), KERNELS))


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
    _check_rois(dev, boxes.shape[0], boxes, batch_indices, levels)


def _check_rois(dev, r, boxes, batch_indices, levels):
    if boxes.device != dev or boxes.device.type != "cuda":
        raise ValueError("the ROIAlign kernels take CUDA tensors on one device")
    if boxes.dtype != torch.float32 or boxes.shape != (r, 4) or not boxes.is_contiguous():
        raise ValueError("boxes must be a contiguous (R, 4) float32 tensor")
    for name, t in (("batch_indices", batch_indices), ("levels", levels)):
        if t.dtype != torch.int32 or t.shape != (r,) or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name} must be a contiguous (R,) int32 tensor on {dev}")


def _check_bwd(grad, feature_shapes, boxes, batch_indices, levels):
    if not 1 <= len(feature_shapes) <= MAX_LEVELS:
        raise ValueError(f"ROIAlign takes 1 to {MAX_LEVELS} levels, got {len(feature_shapes)}")
    if grad.dtype not in _DTYPES or grad.dim() != 4 or not grad.is_contiguous():
        raise ValueError("the cotangent must be a contiguous (R, P, P, C) float32 or bfloat16 tensor")
    for s in feature_shapes:
        if len(s) != 4 or s[0] != feature_shapes[0][0] or s[3] != grad.shape[3]:
            raise ValueError("every level must be (B, H, W, C) with the cotangent's C")
    _check_rois(grad.device, grad.shape[0], boxes, batch_indices, levels)


class _RoIAlignFwd(torch.autograd.Function):
    """K1 forward, K2 backward. ROIAlign is linear in the features, so the
    backward needs the ROIs and the levels' shapes but not their values."""

    @staticmethod
    def forward(ctx, boxes, batch_indices, levels, geometry, *features):
        scales, ph, pw, sampling_ratio, aligned = geometry
        ctx.geometry = geometry
        ctx.feature_shapes = [tuple(f.shape) for f in features]
        ctx.save_for_backward(boxes, batch_indices, levels)
        return KERNEL.launch(
            list(features), scales, boxes, batch_indices, levels, ph, pw,
            sampling_ratio, aligned,
        )

    @staticmethod
    def backward(ctx, grad):
        scales, _, _, sampling_ratio, aligned = ctx.geometry
        boxes, batch_indices, levels = ctx.saved_tensors
        grads = BWD_KERNEL.launch(
            grad.contiguous(), ctx.feature_shapes, scales, boxes, batch_indices, levels,
            sampling_ratio, aligned,
        )
        return (None, None, None, None, *grads)


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
    geometry = roi_align_geometry(spatial_scales, output_size, sampling_ratio, aligned)
    return _RoIAlignFwd.apply(boxes, batch_indices, levels, geometry, *features)


def roi_align_multilevel_backward_cuda(
    grad: torch.Tensor,
    feature_shapes: Sequence[Sequence[int]],
    spatial_scales: Sequence[float],
    boxes: torch.Tensor,
    batch_indices: torch.Tensor,
    levels: torch.Tensor,
    output_size,
    sampling_ratio: int = 0,
    aligned: bool = True,
) -> List[torch.Tensor]:
    """K2's entry, arguments as ``roi_align.roi_align_multilevel_backward_plain``,
    all on one CUDA device: per level the (B, Hi, Wi, C) gradient."""
    if boxes.device.type != "cuda":
        raise ValueError("roi_align_multilevel_backward_cuda takes CUDA tensors")
    scales, ph, pw, ratio, aligned = roi_align_geometry(
        spatial_scales, output_size, sampling_ratio, aligned
    )
    if tuple(grad.shape[1:3]) != (ph, pw):
        raise ValueError(f"cotangent of shape {tuple(grad.shape)} for output size {(ph, pw)}")
    return BWD_KERNEL.launch(
        grad.contiguous(), [tuple(s) for s in feature_shapes], scales, boxes, batch_indices,
        levels, ratio, aligned,
    )
