"""The port's CUDA kernels against their plain PyTorch versions, on the card:
K1 (ROIAlign forward), K2 (ROIAlign backward) and one tiny train step
through both against the same step through the plain versions; the JTSM
gate model's mask pooler, which must launch K1 once a request; and JTSM
scoring, whose panoptic fusion on the card must give the CPU's maps.

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

The edge cases hold both kernels to the same tolerances on the inputs that
their vector and table paths are most likely to get wrong: channel counts
off the vector width, level views and cotangents off 16-byte boundaries,
maps of one row or column, ROIs outside the map, of zero area, at the
adaptive grid's cap, stacked on one cell, covering whole levels, and R = 0.
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
        (torch.bfloat16, 0, True, 14, 4, "train"),
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


def _unaligned(t):
    """A contiguous copy of ``t`` that starts one element past a 16-byte
    boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


def _edge_case(name, rng):
    """(level shapes (B, H, W, C), scales, boxes, batch indices, levels, P)."""
    b, c, p = 2, 64, 7
    shapes = [(b, 32, 48, c), (b, 16, 24, c), (b, 8, 12, c)]
    scales = [1 / 4, 1 / 8, 1 / 16]
    r = 64
    boxes = _boxes(rng, r, 128, 192)
    if name in ("c40", "c42"):
        c = int(name[1:])
        shapes = [(b, hh, ww, c) for b, hh, ww, _ in shapes]
    elif name == "one_row":
        # a level of one row, one of one column, one of one cell; on a
        # degenerate axis every sample lies in (-1, 1), where the map's one
        # cell is the whole answer (see _plain_one_row)
        shapes = [(b, 1, 48, c), (b, 16, 1, c), (b, 1, 1, c)]
        levels = rng.randint(0, 3, r).astype(np.int32)
        reach = np.array([[190.0, 6.0], [12.0, 120.0], [24.0, 24.0]], np.float32)[levels]
        start = np.array([[0.0, -2.0], [-4.0, 0.0], [-8.0, -8.0]], np.float32)[levels]
        lo = start + rng.rand(r, 2).astype(np.float32) * (reach - start) * 0.3
        boxes = np.concatenate([lo, lo + rng.rand(r, 2).astype(np.float32) * (reach - lo)], 1)
        return shapes, scales, boxes, rng.randint(0, b, r).astype(np.int32), levels, p
    elif name == "outside":
        boxes[: r // 2] = [[-90.0, -90.0, -30.0, -40.0], [300.0, 200.0, 400.0, 260.0]] * (r // 4)
    elif name == "zero_area":
        xy = rng.rand(r, 2) * [192, 128]
        boxes = np.concatenate([xy, xy], 1).astype(np.float32)
        boxes[::4, 2] -= 5.0  # inverted in x
    elif name == "ratio_cap":
        # bins of exactly 4, just over 4, exactly 3 and just over 3 cells on
        # level 0 (stride 4): grids of 4, 4 (capped), 3 and 4
        side = np.array([4.0, 4.001, 3.0, 3.001] * (r // 4), np.float32) * 4 * p
        xy = rng.rand(r, 2) * 20
        boxes = np.concatenate([xy, xy + side[:, None]], 1).astype(np.float32)
        return shapes, scales, boxes, np.zeros(r, np.int32), np.zeros(r, np.int32), p
    elif name == "stacked":
        r = 512
        boxes = np.tile(np.array([[40.0, 30.0, 52.0, 41.0]], np.float32), (r, 1))
        boxes[: r // 2] += rng.rand(r // 2, 4).astype(np.float32) * 0.01
        return shapes, scales, boxes, np.zeros(r, np.int32), np.zeros(r, np.int32), 14
    elif name == "whole_levels":
        boxes = np.tile(np.array([[-8.0, -8.0, 200.0, 136.0]], np.float32), (r, 1))
    elif name == "r0":
        boxes = np.zeros((0, 4), np.float32)
        r = 0
    levels = rng.randint(0, len(shapes), r).astype(np.int32)
    return shapes, scales, boxes.astype(np.float32), rng.randint(0, b, r).astype(np.int32), levels, p


def _plain_one_row(args, bwd_args):
    """The plain versions' answers for maps of one row or column. The plain
    version, as the JAX formulation, reads the tap after a map's last cell
    unclamped (the next row of the flat pyramid, or past its end), where the
    kernels take the last cell again; with every sample of a degenerate axis
    inside (-1, 1) the kernels' answer is the plain version's on the map
    with its one row (column) doubled, and the gradient that one's summed
    back over the two."""
    feats, scales, *rois = args[:5]
    doubled = [f.repeat(1, 2 if f.shape[1] == 1 else 1, 2 if f.shape[2] == 1 else 1, 1) for f in feats]
    want = roi_align_multilevel_plain(doubled, scales, *rois, *args[5:])
    grad, shapes = bwd_args[:2]
    want_g = roi_align_multilevel_backward_plain(
        grad.float(), [f.shape for f in doubled], *bwd_args[2:]
    )
    want_g = [
        g.unflatten(1, (g.shape[1] // s[1], s[1])).sum(1)
        .unflatten(2, (g.shape[2] // s[2], s[2])).sum(2).to(grad.dtype)
        for g, s in zip(want_g, shapes)
    ]
    return want, want_g


EDGE_CASES = ["c40", "c42", "unaligned", "one_row", "outside", "zero_area", "ratio_cap",
              "stacked", "whole_levels", "r0"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", EDGE_CASES)
def test_roi_align_kernels_edge_cases_match_plain(name, dtype):
    _card()
    rng = np.random.RandomState(EDGE_CASES.index(name))
    shapes, scales, boxes, bidx, levels, p = _edge_case(name, rng)
    feats = [torch.from_numpy(rng.randn(*s).astype(np.float32)).cuda().to(dtype) for s in shapes]
    r, c = boxes.shape[0], shapes[0][3]
    grad = torch.from_numpy(rng.randn(r, p, p, c).astype(np.float32)).cuda().to(dtype)
    if name == "unaligned":
        feats = [_unaligned(f) for f in feats]
        grad = _unaligned(grad)
    rois = (torch.from_numpy(boxes).cuda(), torch.from_numpy(bidx).cuda(),
            torch.from_numpy(levels).cuda())
    tol = 2.0**-7 if dtype == torch.bfloat16 else 1e-5
    k1, k2 = KERNEL.launches, BWD_KERNEL.launches

    args = (feats, scales, *rois, p, 0, True)
    bwd_args = (grad, shapes, scales, *rois, p, 0, True)
    got = roi_align_multilevel_cuda(*args)
    got_g = roi_align_multilevel_backward_cuda(*bwd_args)
    if name == "one_row":
        want, want_g = _plain_one_row(args, bwd_args)
    else:
        want = roi_align_multilevel_plain(*args)
        want_g = roi_align_multilevel_backward_plain(*bwd_args)
    torch.cuda.synchronize()
    # R = 0 launches nothing: the wrappers return the empty output and zeros
    assert (KERNEL.launches - k1, BWD_KERNEL.launches - k2) == ((0, 0) if r == 0 else (1, 1))
    assert got.shape == want.shape == (r, p, p, c) and got.dtype == dtype
    if r:
        scale = max(1.0, want.float().abs().max().item())
        assert (got.float() - want.float()).abs().max().item() <= tol * scale
    if name == "outside":
        assert got[: r // 2].float().abs().max().item() == 0.0
    for g, wnt, shp in zip(got_g, want_g, shapes):
        assert g.shape == wnt.shape == shp and g.dtype == dtype and g.is_contiguous()
        scale = max(1.0, wnt.float().abs().max().item())
        assert (g.float() - wnt.float()).abs().max().item() <= tol * scale, name


@pytest.mark.gpu
def test_launch_runs_inside_the_tensors_device(monkeypatch):
    """Each wrapper enters ``torch.cuda.device`` of its tensors' device and
    takes that device's stream inside it; the guard is a spy around the
    real one, so this also runs on a machine with one card."""
    _card()
    real_device, real_stream = torch.cuda.device, torch.cuda.current_stream
    entered, streams = [], []
    inside = [False]

    class Spy:
        def __init__(self, device):
            entered.append(torch.device(device))
            self.guard = real_device(device)

        def __enter__(self):
            inside[0] = True
            return self.guard.__enter__()

        def __exit__(self, *exc):
            inside[0] = False
            return self.guard.__exit__(*exc)

    def stream(device=None):
        streams.append((torch.device(device), inside[0]))
        return real_stream(device)

    monkeypatch.setattr(torch.cuda, "device", Spy)
    monkeypatch.setattr(torch.cuda, "current_stream", stream)
    rng = np.random.RandomState(5)
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    feats = [torch.from_numpy(rng.randn(2, 16, 24, 32).astype(np.float32)).to(dev)]
    rois = (torch.from_numpy(_boxes(rng, 12, 64, 96)).to(dev),
            torch.from_numpy(rng.randint(0, 2, 12).astype(np.int32)).to(dev),
            torch.zeros(12, dtype=torch.int32, device=dev))
    out = roi_align_multilevel_cuda(feats, [0.25], *rois, 7)
    roi_align_multilevel_backward_cuda(torch.ones_like(out), [f.shape for f in feats], [0.25], *rois, 7)
    monkeypatch.undo()
    torch.cuda.synchronize(dev)
    assert entered == [dev, dev]
    assert streams == [(dev, True), (dev, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jtsm_mask_pooler_launches_k1_once_a_request(monkeypatch, dtype):
    """The JTSM gate model on the card: its mask pooler (one 512-channel
    level) runs K1 once a request and the plain ROIAlign never."""
    _card()
    import os

    import jtsm_tpu_torch.ops.roi_align as roi_align
    from jtsm_tpu_torch.checkpoint import load_gate_ckpt, variables_to_state_dict
    from jtsm_tpu_torch.config import jtsm_gate_cfg
    from jtsm_tpu_torch.engine import Predictor
    from jtsm_tpu_torch.wsl.data import compute_superpixels_grid, oh_labels_from_boxes

    def plain(*args, **kwargs):
        raise AssertionError("the plain ROIAlign ran on the card")

    monkeypatch.setattr(roi_align, "roi_align_multilevel_plain_autograd", plain)
    cfg = jtsm_gate_cfg()
    cfg.TPU.COMPUTE_DTYPE = dtype
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    predictor = Predictor(cfg, variables_to_state_dict(load_gate_ckpt(os.path.join(root, cfg.MODEL.WEIGHTS))))
    rng = np.random.RandomState(0)
    h, w = 128, 176
    xy = rng.rand(64, 2) * [w - 30, h - 30]
    boxes = np.concatenate([xy, xy + rng.rand(64, 2) * 60 + 10], 1).astype(np.float32)
    sp = compute_superpixels_grid(h, w)
    request = {
        "image": (rng.rand(1, h, w, 3) * 255).astype(np.float32),
        "image_sizes": np.array([[h, w]], np.int32),
        "proposals": boxes[None],
        "proposal_scores": rng.rand(1, 64).astype(np.float32),
        "superpixels": sp[None],
        "oh_labels": oh_labels_from_boxes(boxes, sp, cfg.WSL.MAX_SUPERPIXELS)[None],
    }
    before = KERNEL.launches
    out = predictor(request)
    torch.cuda.synchronize()
    assert KERNEL.launches - before == 1
    assert out["masks"].shape == (1, 100, 28, 28) and bool(out["valid"].any())


@pytest.mark.gpu
def test_jtsm_scoring_fuses_on_the_card_as_on_the_cpu(monkeypatch):
    """The JTSM gate scores three in-memory cocovar scenes on the card: K1
    launches once a batch and the plain ROIAlign never; its outputs fused on
    the card and, copied, on the CPU give the same panoptic id maps,
    segments and sem-seg maps."""
    _card()
    import os

    import jtsm_tpu_torch.ops.roi_align as roi_align
    from jtsm_tpu_torch.checkpoint import load_gate_ckpt, variables_to_state_dict
    from jtsm_tpu_torch.config import jtsm_gate_cfg
    from jtsm_tpu_torch.data import DatasetCatalog, MetadataCatalog
    from jtsm_tpu_torch.data.datasets.synthetic import register_synthetic_cocovar
    from jtsm_tpu_torch.engine import test
    from jtsm_tpu_torch.evaluation import COCOEvaluator, COCOPanopticEvaluator, DatasetEvaluators, SemSegEvaluator
    from jtsm_tpu_torch.modeling import build_model
    from jtsm_tpu_torch.modeling.meta_arch.panoptic_fpn import panoptic_fusion_postprocess
    from jtsm_tpu_torch.wsl.train_net import build_test_loader

    def plain(*args, **kwargs):
        raise AssertionError("the plain ROIAlign ran on the card")

    monkeypatch.setattr(roi_align, "roi_align_multilevel_plain_autograd", plain)
    name = "torch_kernels_jtsm_score"
    cfg = jtsm_gate_cfg()
    cfg.DATASETS.TEST = (name,)
    cfg.DATASETS.PROPOSAL_FILES_TEST = (register_synthetic_cocovar(name, num=3),)
    try:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        model = build_model(cfg, device="cuda")
        model.load_state_dict(variables_to_state_dict(load_gate_ckpt(os.path.join(root, cfg.MODEL.WEIGHTS))))
        raw = []
        inference = model.inference

        def capture(batch):
            out = inference(batch)
            raw.append((out, batch["image_sizes"], batch["orig_sizes"]))
            return out

        model.inference = capture
        evaluator = DatasetEvaluators([COCOEvaluator(name), SemSegEvaluator(name), COCOPanopticEvaluator(name)])
        before = KERNEL.launches
        results = test(cfg, model, evaluators=[evaluator], build_test_loader=build_test_loader)
        assert KERNEL.launches - before == len(raw) == 3
        assert set(results) == {"bbox", "segm", "sem_seg", "panoptic_seg"}
        combine = cfg.MODEL.PANOPTIC_FPN.COMBINE
        args = (combine.OVERLAP_THRESH, combine.STUFF_AREA_LIMIT, combine.INSTANCES_CONFIDENCE_THRESH)
        for out, image_sizes, orig_sizes in raw:
            on_card = panoptic_fusion_postprocess(out, image_sizes, orig_sizes, *args)
            on_cpu = panoptic_fusion_postprocess({k: v.cpu() for k, v in out.items()}, image_sizes, orig_sizes, *args)
            for (cm, cs), (hm, hs) in zip(on_card["panoptic_seg"], on_cpu["panoptic_seg"]):
                np.testing.assert_array_equal(cm, hm)
                assert cs == hs and cs
            for a, b in zip(on_card["sem_seg"], on_cpu["sem_seg"]):
                np.testing.assert_array_equal(a, b)
    finally:
        DatasetCatalog.remove(name)
        MetadataCatalog.remove(name)
