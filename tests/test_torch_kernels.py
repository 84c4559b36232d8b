"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card and skips without one. The card's
machine has no JAX, which ``tests/conftest.py`` imports, so run them there
without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tolerances: float32 1e-5 of the output's scale (the kernel does the plain
version's float operations in the same order; only the order of the sum
over samples differs); bfloat16 2^-7 of it (both round one float32 sum to
bfloat16, and another summation order can move that rounding one step).
"""

import numpy as np
import pytest
import torch

from jtsm_tpu_torch.ops.roi_align import roi_align_multilevel_plain
from jtsm_tpu_torch.ops.roi_align_cuda import KERNEL, roi_align_multilevel_cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _boxes(rng, r, h, w):
    xy = rng.rand(r, 2) * [w, h]
    b = np.concatenate([xy, xy + rng.rand(r, 2) * [w / 2, h / 2] + 0.5], 1)
    k = r // 6
    b[:k] = [0, 0, w, h]  # bins of many pixels: the adaptive grid at its cap
    b[k : 2 * k, :2] = -rng.rand(k, 2) * 8  # across the top-left border
    b[2 * k : 3 * k, 2:] = [w + 3, h + 3]  # across the bottom-right border
    b[3 * k : 3 * k + 3] = [[-50, -50, -20, -20], [w + 40, h + 40, w + 80, h + 80], [7, 7, 7, 7]]
    return b.astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "dtype,sampling_ratio,aligned,p,levels",
    [
        (torch.float32, 0, True, 7, 4),
        (torch.float32, 0, True, 14, 4),
        (torch.float32, 2, True, 7, 4),
        (torch.float32, 0, False, 7, 4),
        (torch.float32, 0, True, 14, 1),
        (torch.bfloat16, 0, True, 7, 4),
    ],
)
def test_roi_align_kernel_matches_plain(dtype, sampling_ratio, aligned, p, levels):
    _card()
    rng = np.random.RandomState(0)
    b, c, h, w, r = 2, 96, 128, 192, 300
    feats = [
        torch.from_numpy(rng.randn(b, h // s, w // s, c).astype(np.float32)).cuda().to(dtype)
        for s in (4, 8, 16, 32)[:levels]
    ]
    scales = [1.0 / s for s in (4, 8, 16, 32)[:levels]]
    args = (
        feats, scales, torch.from_numpy(_boxes(rng, r, h, w)).cuda(),
        torch.from_numpy(rng.randint(0, b, r).astype(np.int32)).cuda(),
        torch.from_numpy(rng.randint(0, levels, r).astype(np.int32)).cuda(),
        p, sampling_ratio, aligned,
    )
    before = KERNEL.launches
    got = roi_align_multilevel_cuda(*args)
    want = roi_align_multilevel_plain(*args)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    assert got.shape == want.shape == (r, p, p, c) and got.dtype == dtype
    tol = (2.0**-7 if dtype == torch.bfloat16 else 1e-5) * max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= tol
