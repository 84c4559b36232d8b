"""The port's CUDA kernels against their plain PyTorch versions, on the card:
K1 (ROIAlign forward), K2 (ROIAlign backward) and one tiny train step
through both against the same step through the plain versions.

Every test here needs an NVIDIA card and skips without one. The card's
machine has no JAX, which ``tests/conftest.py`` imports, so run them there
without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tolerances: float32 1e-5 of the output's scale (the kernel does the plain
version's float operations in the same order; only the order of the sum
over samples differs); bfloat16 2^-7 of it (both round one float32 sum to
bfloat16, and another summation order can move that rounding one step).
K2 is held to the same tolerances relative to the gradient's scale: its
atomic sums land in another order than the plain version's ``index_add_``.
The train step compares losses to 1e-5 of their scale and gradients to 1e-4
of each parameter's gradient scale (the K1/K2 differences of ~1e-7 pass
through the backbone's backward).
"""

import numpy as np
import pytest
import torch

from jtsm_tpu_torch.ops.roi_align import (
    roi_align_multilevel_backward_plain,
    roi_align_multilevel_plain,
)
from jtsm_tpu_torch.ops.roi_align_cuda import (
    BWD_KERNEL,
    KERNEL,
    roi_align_multilevel_backward_cuda,
    roi_align_multilevel_cuda,
)


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


def _spread_boxes(rng, r, h, w):
    """Log-uniform sizes from 8 px to the image, over the whole image: the
    FPN rule sends them to every level."""
    size = np.exp(rng.uniform(np.log(8), np.log(max(h, w)), (r, 2)))
    xy = rng.rand(r, 2) * [w, h] - size / 4
    return np.concatenate([xy, xy + size], 1).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "dtype,sampling_ratio,aligned,p,levels,size",
    [
        (torch.float32, 0, True, 7, 4, "small"),
        (torch.float32, 0, True, 14, 4, "small"),
        (torch.float32, 2, True, 7, 4, "small"),
        (torch.float32, 0, False, 7, 4, "small"),
        (torch.float32, 0, True, 14, 1, "small"),
        (torch.bfloat16, 0, True, 7, 4, "small"),
        (torch.float32, 0, True, 7, 4, "train"),
        (torch.float32, 0, True, 14, 4, "train"),
        (torch.bfloat16, 0, True, 7, 4, "train"),
    ],
)
def test_roi_align_backward_kernel_matches_plain(dtype, sampling_ratio, aligned, p, levels, size):
    """K2 against the plain backward; "train" is the flagship's training
    shapes: B=2 at 800x1344, C=256, R=1024 box or R=256 mask ROIs."""
    _card()
    from jtsm_tpu_torch.modeling.poolers import assign_boxes_to_levels

    rng = np.random.RandomState(1)
    if size == "small":
        b, c, h, w, r = 2, 96, 128, 192, 300
        boxes = _boxes(rng, r, h, w)
        lv = rng.randint(0, levels, r).astype(np.int32)
    else:
        b, c, h, w = 2, 256, 800, 1344
        r = 1024 if p == 7 else 256
        boxes = _spread_boxes(rng, r, h, w)
        lv = assign_boxes_to_levels(torch.from_numpy(boxes), 2, 5).numpy()
    strides = (4, 8, 16, 32)[:levels]
    shapes = [(b, h // s, w // s, c) for s in strides]
    grad = torch.from_numpy(rng.randn(r, p, p, c).astype(np.float32)).cuda().to(dtype)
    args = (
        grad, shapes, [1.0 / s for s in strides], torch.from_numpy(boxes).cuda(),
        torch.from_numpy(rng.randint(0, b, r).astype(np.int32)).cuda(),
        torch.from_numpy(lv).cuda(), p, sampling_ratio, aligned,
    )
    before = BWD_KERNEL.launches
    got = roi_align_multilevel_backward_cuda(*args)
    want = roi_align_multilevel_backward_plain(*args)
    torch.cuda.synchronize()
    assert BWD_KERNEL.launches == before + 1
    for g, wnt, shp in zip(got, want, shapes):
        assert g.shape == wnt.shape == shp and g.dtype == dtype and g.is_contiguous()
        scale = max(1.0, wnt.float().abs().max().item())
        tol = (2.0**-7 if dtype == torch.bfloat16 else 1e-5) * scale
        assert (g.float() - wnt.float()).abs().max().item() <= tol


@pytest.mark.gpu
def test_roi_align_autograd_launches_both_kernels():
    _card()
    rng = np.random.RandomState(2)
    feats = [
        torch.from_numpy(rng.randn(2, 32 // s, 48 // s, 64).astype(np.float32)).cuda().requires_grad_()
        for s in (1, 2)
    ]
    boxes = torch.from_numpy(_boxes(rng, 40, 64, 96)).cuda()
    bidx = torch.from_numpy(rng.randint(0, 2, 40).astype(np.int32)).cuda()
    lv = torch.from_numpy(rng.randint(0, 2, 40).astype(np.int32)).cuda()
    k1, k2 = KERNEL.launches, BWD_KERNEL.launches
    out = roi_align_multilevel_cuda(feats, [0.5, 0.25], boxes, bidx, lv, 7)
    out.permute(0, 3, 1, 2).sum().backward()  # a non-contiguous cotangent
    assert (KERNEL.launches, BWD_KERNEL.launches) == (k1 + 1, k2 + 1)
    want = roi_align_multilevel_backward_plain(
        torch.ones_like(out), [f.shape for f in feats], [0.5, 0.25], boxes, bidx, lv, 7
    )
    for f, wnt in zip(feats, want):
        assert (f.grad - wnt).abs().max().item() <= 1e-5 * max(1.0, wnt.abs().max().item())


@pytest.mark.gpu
def test_tiny_train_step_kernels_match_plain(monkeypatch):
    """One train step of a narrow Mask R-CNN through K1/K2 and through the
    plain versions, from the same weights, batch and generator seed."""
    _card()
    import jtsm_tpu_torch.modeling.poolers as poolers
    from jtsm_tpu_torch.checkpoint import random_state_dict
    from jtsm_tpu_torch.config import mask_rcnn_gate_cfg
    from jtsm_tpu_torch.engine import create_train_state, make_train_step
    from jtsm_tpu_torch.modeling import build_model
    from jtsm_tpu_torch.ops.roi_align import roi_align_multilevel_plain_autograd
    from jtsm_tpu_torch.solver import build_lr_schedule, build_optimizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    cfg = mask_rcnn_gate_cfg()
    cfg.SOLVER.CLIP_GRADIENTS.ENABLED = False
    rng = np.random.RandomState(3)
    b, h, w, g = 2, 128, 176, 6
    xy = rng.rand(b, g, 2) * [w - 40, h - 40]
    batch = {
        "image": (rng.rand(b, h, w, 3) * 255).astype(np.float32),
        "image_sizes": np.array([[h, w], [h - 16, w - 32]], np.int32),
        "gt_boxes": np.concatenate([xy, xy + 10 + rng.rand(b, g, 2) * 30], -1).astype(np.float32),
        "gt_classes": rng.randint(0, 80, (b, g)).astype(np.int32),
        "gt_valid": np.arange(g)[None].repeat(b, 0) < 4,
        "gt_mask_crops": rng.rand(b, g, 56, 56) > 0.5,
    }
    state = random_state_dict(build_model(cfg, device="cpu"), seed=0)

    def step():
        model = build_model(cfg)
        model.load_state_dict(state)
        opt = build_optimizer(cfg, model)
        ts = create_train_state(model, opt, seed=0)
        metrics = make_train_step(model, opt, build_lr_schedule(cfg))(ts, batch)
        return metrics, {n: p.grad.clone() for n, p in model.named_parameters()}

    k1, k2 = KERNEL.launches, BWD_KERNEL.launches
    m_kernel, g_kernel = step()
    assert (KERNEL.launches - k1, BWD_KERNEL.launches - k2) == (2, 2)
    monkeypatch.setattr(poolers, "roi_align_multilevel", roi_align_multilevel_plain_autograd)
    m_plain, g_plain = step()
    assert (KERNEL.launches - k1, BWD_KERNEL.launches - k2) == (2, 2)
    for k in m_kernel:
        a, p = m_kernel[k].item(), m_plain[k].item()
        assert np.isfinite(a) and abs(a - p) <= 1e-5 * max(1.0, abs(p)), (k, a, p)
    for n in g_kernel:
        scale = max(1e-6, g_plain[n].abs().max().item())
        assert (g_kernel[n] - g_plain[n]).abs().max().item() <= 1e-4 * scale, n
