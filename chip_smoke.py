#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``jtsm_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--baseline DIR]

Phases, in order; any failure ends the run with a non-zero exit:

1. device: the card's name and power limit;
2. build: every CUDA kernel of the served and trained paths, compiled with
   nvcc from the sources in this checkout (and, with ``--baseline DIR``, the
   same C interfaces from the sources in DIR, an earlier version of
   ``jtsm_tpu_torch/ops/csrc``, into a temporary directory, to time beside
   them);
3. kernels: K1 against its plain PyTorch version at the shapes the served
   path gives it, in float32 and bfloat16, with the stated tolerance, timed
   with CUDA events beside its bound (and beside the baseline, in turns),
   both as calls issued back to back (host cost per call included) and as
   the device's time alone;
4. serve: Mask R-CNN R50-FPN at full width (random weights from a seed)
   answers 8 requests of one 800x1344 image in each of its configured
   TPU.COMPUTE_DTYPE (bfloat16) and float32, the two in turns; every
   kernel's launch count is set to 0 before and read after, and K1 must run
   twice a request in each; then each stage's time and host syncs;
5. trained weights: the committed gate checkpoint (a narrow R50, float32) on
   one seeded image, through the kernel and through the plain version on
   the card, must give the same detections;
6. training kernels: K1 and K2 (the ROIAlign backward) against their plain
   versions at the flagship's training shapes (B=2 at 800x1344, 1024 box
   ROIs at P=7 and 256 mask ROIs at P=14) in float32 and bfloat16, timed
   beside their bounds (and the baseline); then both kernels against their
   plain versions on the edge cases of ``tests/test_torch_kernels.py``;
7. train: the flagship at full width (random weights from a seed) takes 5
   SGD steps on a seeded synthetic batch of 2 images at 800x1344, in
   bfloat16 and in float32; every loss must be finite, and K1 and K2 must
   each launch 2 times a step in each;
8. train, kernel against plain: one float32 step from the gate checkpoint
   through K1/K2 and through the plain forward and backward on the card must
   give the same losses and gradients.

The last three lines are {"kernels": [...]} (``kernel_line`` says which
times), the card's name and power limit as nvidia-smi gives them,
and {"ok": true, "device": {...}}. Needs one card, torch, numpy and pytest;
imports nothing of JAX. Without a card, or outside a checkout of the
repository, it exits with 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
FLOPS_PER_TAP_SAMPLE = 12  # 4 taps x (2 mul) + 3 adds + 1 accumulate, per channel
BWD_FLOPS_PER_SAMPLE = 8  # 4 taps x (1 mul + 1 accumulate), per channel
TOL_F32 = 1e-5  # same float ops in the same order; only the sum order differs
# both sides sum in f32 and round once to bf16; another summation order can
# move that rounding by one bf16 step, 2^-7 of the value's binade
TOL_BF16 = 2.0**-7

DEVICE = "cuda"
FLAGSHIP_HW = (800, 1344)
LEVEL_STRIDES = (4, 8, 16, 32)
TRAIN_BATCH = 2  # the per-card batch of the reference's 8-card IMS_PER_BATCH 16
TRAIN_STEPS = 5
SERVE_ROUNDS = 8  # requests in each dtype
STAGE_ROUNDS = 5
DTYPE_NAMES = {"bfloat16": "bf16", "float32": "f32"}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int, queued: bool = False) -> float:
    """Mean time of ``fn`` over ``reps`` back-to-back calls, from CUDA events
    recorded around them as the host issues them: a call whose host cost
    (the wrapper's Python, ctypes and allocations) exceeds its device time
    is timed at its host cost. With ``queued`` the stream first
    sleeps a few milliseconds, so the host has queued every call before the
    first starts and the time is the device's alone."""
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(5_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_in_turns(fns: dict, reps: int = 20) -> dict:
    """``cuda_time_ms`` of each callable under both timers, twice each, in
    turns (a, b, b, a), and the mean of its two: versions compared on one
    card in one run. Returns {name: {"ms": t, "device_ms": t}}."""
    times = {k: {"ms": [], "device_ms": []} for k in fns}
    for queued, key in ((False, "ms"), (True, "device_ms")):
        for k in list(fns) + list(reversed(fns)):
            times[k][key].append(cuda_time_ms(fns[k], reps, queued))
    return {k: {key: sum(v) / len(v) for key, v in t.items()} for k, t in times.items()}


def roi_align_counts(features, scales, boxes, batch_indices, levels, p, sampling_ratio):
    """For these inputs: the feature cells the live samples tap (each
    counted once) and the number of live samples."""
    import torch

    from jtsm_tpu_torch.ops.roi_align import ADAPTIVE_MAX_RATIO, _axis_samples

    s = ADAPTIVE_MAX_RATIO if sampling_ratio == 0 else sampling_ratio
    touched, live_samples = 0, 0
    for lvl, (f, sc) in enumerate(zip(features, scales)):
        sel = levels.long() == lvl
        if not sel.any():
            continue
        h, w = f.shape[1], f.shape[2]
        bx = boxes[sel].float() * sc - 0.5
        bin_w, bin_h = (bx[:, 2] - bx[:, 0]) / p, (bx[:, 3] - bx[:, 1]) / p
        ry = torch.ceil(bin_h).clamp(1, s).long() if sampling_ratio == 0 else torch.full_like(bx[:, 0], s).long()
        rx = torch.ceil(bin_w).clamp(1, s).long() if sampling_ratio == 0 else ry
        n = bx.shape[0]

        def taps(origin, bin_size, ratio, size):
            sz = torch.full((n,), size, dtype=torch.long, device=boxes.device)
            lo, _, dead = _axis_samples(p, s, bin_size, origin, ratio, sz)
            hi = torch.minimum(lo + 1, sz[:, None, None] - 1)
            mask = torch.zeros((n, size + 1), dtype=torch.bool, device=boxes.device)
            for t in (lo, hi):
                mask.scatter_(1, torch.where(dead, size, t).reshape(n, -1), True)
            return mask[:, :size], (~dead).sum(dim=(1, 2))

        rows, ly = taps(bx[:, 1], bin_h, ry, h)
        cols, lx = taps(bx[:, 0], bin_w, rx, w)
        live_samples += int((ly * lx).sum())
        bidx = batch_indices[sel].long()
        for b in bidx.unique():
            m = bidx == b
            touched += int(((rows[m].float().T @ cols[m].float()) > 0).sum())
    return touched, live_samples


def roi_align_work(features, scales, boxes, batch_indices, levels, p, sampling_ratio):
    """Bytes the ROIAlign forward must move and float operations it must do
    for these inputs: the feature cells its live samples tap (each read
    once), the output written once, the per-ROI inputs; 12 operations per
    live sample and channel and one division per output."""
    esize = features[0].element_size()
    c = features[0].shape[-1]
    r = boxes.shape[0]
    touched, live_samples = roi_align_counts(features, scales, boxes, batch_indices, levels, p, sampling_ratio)
    nbytes = touched * c * esize + r * p * p * c * esize + r * (16 + 4 + 4)
    flops = live_samples * c * FLOPS_PER_TAP_SAMPLE + r * p * p * c
    return nbytes, flops


def roi_align_bwd_work(features, scales, boxes, batch_indices, levels, p, sampling_ratio):
    """Bytes the ROIAlign backward must move and float operations it must
    do: the cotangent and the per-ROI inputs read once and the gradient
    pyramid written once (every cell: those no sample taps are zeros); one
    division per cotangent element and 8 operations per live sample and
    channel. Also the bytes when only the touched cells are read and
    written, the accumulation's own traffic, for comparison."""
    esize = features[0].element_size()
    c = features[0].shape[-1]
    r = boxes.shape[0]
    touched, live_samples = roi_align_counts(features, scales, boxes, batch_indices, levels, p, sampling_ratio)
    cotangent = r * p * p * c * esize + r * (16 + 4 + 4)
    pyramid = sum(f.numel() for f in features) * esize
    flops = live_samples * c * BWD_FLOPS_PER_SAMPLE + r * p * p * c
    return cotangent + pyramid, flops, cotangent + 2 * touched * c * esize


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flagship_pyramid(gen, c=256, dtype=None, batch=1):
    import torch

    h, w = FLAGSHIP_HW
    return [
        torch.randn((batch, h // s, w // s, c), generator=gen, device=DEVICE, dtype=torch.float32).to(dtype)
        for s in LEVEL_STRIDES
    ]


def spread_boxes(gen, r):
    """Boxes of log-uniform size from 8 to 800 px over the image: the FPN
    rule assigns them to all four levels."""
    import torch

    h, w = FLAGSHIP_HW
    size = torch.exp(torch.empty(r, 2, device=DEVICE).uniform_(math.log(8), math.log(800), generator=gen))
    xy = torch.rand(r, 2, generator=gen, device=DEVICE) * torch.tensor([w, h], device=DEVICE) - size / 4
    return torch.cat([xy, xy + size], dim=1).contiguous()


def dtype_tag(t) -> str:
    import torch

    return "bf16" if t.dtype == torch.bfloat16 else "f32"


def format_times(times) -> str:
    """The kernel's times under both timers, and the baseline's when it ran."""
    text = f"kernel_ms={times['new']['ms']:.4f} kernel_device_ms={times['new']['device_ms']:.4f}"
    old = times.get("baseline")
    if old is None:
        return text + " baseline_ms=not measured"
    return text + f" baseline_ms={old['ms']:.4f} baseline_device_ms={old['device_ms']:.4f}"


def check_and_time_fwd(tag, feats, scales, boxes, bidx, levels, p, baseline, phase="kernels"):
    """K1 against its plain version at these inputs, then its time (in turns
    with the baseline's K1 when there is one), the plain version's, and the
    bound. Returns the row's numbers."""
    import torch

    from jtsm_tpu_torch.ops.roi_align import roi_align_multilevel_plain
    from jtsm_tpu_torch.ops.roi_align_cuda import roi_align_multilevel_cuda

    args = (feats, scales, boxes, bidx, levels, p, 0, True)
    got = roi_align_multilevel_cuda(*args)
    want = roi_align_multilevel_plain(*args)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    tol = (TOL_BF16 if feats[0].dtype == torch.bfloat16 else TOL_F32) * scale
    fns = {"new": lambda: roi_align_multilevel_cuda(*args)}
    if baseline:
        old = baseline[0]
        fns["baseline"] = lambda: old.launch(feats, scales, boxes, bidx, levels, p, p, 0, True)
        if not (old.launch(feats, scales, boxes, bidx, levels, p, p, 0, True).float() - want.float()).abs().max().item() <= tol:
            raise AssertionError(f"roi_align_fwd {tag}: the baseline kernel disagrees with the plain version")
    times = time_in_turns(fns)
    p_ms = cuda_time_ms(lambda: roi_align_multilevel_plain(*args), 3)
    nbytes, flops = roi_align_work(feats, scales, boxes, bidx, levels, p, 0)
    b_ms, b_by = bound(nbytes, flops)
    per_level = [int((levels == i).sum()) for i in range(len(feats))]
    log(f"[{phase}] roi_align_fwd {tag}: R={boxes.shape[0]} P={p} C={feats[0].shape[-1]} rois/level={per_level} "
        f"max_abs_err={err:.3e} max_rel_err={err / scale:.3e} (tol {tol:.3e} abs, {tol / scale:.3e} of the "
        f"output's scale {scale:.3f}) {format_times(times)} plain_ms={p_ms:.4f} bound_ms={b_ms:.4f} "
        f"({b_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP) kernel/bound={times['new']['ms'] / b_ms:.2f}")
    if not err <= tol:
        raise AssertionError(f"roi_align_fwd {tag}: max_abs_err {err} > {tol}")
    return dict(err=err, times=times, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, nbytes=nbytes, flops=flops)


def check_and_time_bwd(tag, feats, scales, boxes, bidx, levels, p, gen, baseline):
    """K2 against its plain version, as ``check_and_time_fwd``."""
    import torch

    from jtsm_tpu_torch.ops.roi_align import roi_align_multilevel_backward_plain
    from jtsm_tpu_torch.ops.roi_align_cuda import roi_align_multilevel_backward_cuda

    dtype = feats[0].dtype
    shapes = [tuple(f.shape) for f in feats]
    grad = torch.randn((boxes.shape[0], p, p, shapes[0][3]), generator=gen, device=DEVICE).to(dtype)
    args = (grad, shapes, scales, boxes, bidx, levels, p, 0, True)
    got = roi_align_multilevel_backward_cuda(*args)
    want = roi_align_multilevel_backward_plain(*args)
    torch.cuda.synchronize()
    contiguous = all(g.is_contiguous() and tuple(g.shape) == s for g, s in zip(got, shapes))
    err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
    scale = max(1.0, max(w.float().abs().max().item() for w in want))
    tol = (TOL_BF16 if dtype == torch.bfloat16 else TOL_F32) * scale
    fns = {"new": lambda: roi_align_multilevel_backward_cuda(*args)}
    if baseline:
        old = baseline[1]
        fns["baseline"] = lambda: old.launch(grad, shapes, scales, boxes, bidx, levels, 0, True)
        old_err = max((g.float() - w.float()).abs().max().item() for g, w in zip(fns["baseline"](), want))
        if not old_err <= tol:
            raise AssertionError(f"roi_align_bwd {tag}: the baseline kernel disagrees with the plain version")
    times = time_in_turns(fns)
    p_ms = cuda_time_ms(lambda: roi_align_multilevel_backward_plain(*args), 3)
    nbytes, flops, touched_bytes = roi_align_bwd_work(feats, scales, boxes, bidx, levels, p, 0)
    b_ms, b_by = bound(nbytes, flops)
    log(f"[train_kernels] roi_align_bwd {tag}: R={boxes.shape[0]} P={p} max_abs_err={err:.3e} "
        f"max_rel_err={err / scale:.3e} (tol {tol:.3e} abs, {tol / scale:.3e} of the gradient's scale "
        f"{scale:.3f}) {format_times(times)} plain_ms={p_ms:.4f} bound_ms={b_ms:.4f} "
        f"({b_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP; touched cells read and written once: "
        f"{touched_bytes / 1e6:.1f} MB, {touched_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms) "
        f"kernel/bound={times['new']['ms'] / b_ms:.2f} contiguous (B, H, W, C) gradients: {contiguous}")
    if not err <= tol:
        raise AssertionError(f"roi_align_bwd {tag}: max_abs_err {err} > {tol}")
    if not contiguous:
        raise AssertionError(f"roi_align_bwd {tag}: gradients not contiguous (B, H, W, C)")
    return dict(err=err, times=times, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, nbytes=nbytes, flops=flops)


def phase_kernels(gen, baseline):
    """K1 at the served path's shapes, in float32 and bfloat16, and the
    single-level case (K1b's shape)."""
    import torch

    from jtsm_tpu_torch.modeling.poolers import assign_boxes_to_levels

    scales = [1.0 / s for s in LEVEL_STRIDES]
    pyr32 = flagship_pyramid(gen, dtype=torch.float32)
    pyr16 = [f.to(torch.bfloat16) for f in pyr32]
    single = [torch.randn((2, 50, 84, 256), generator=gen, device=DEVICE)]
    cases = [
        # name, features, scales, R, P, batch
        ("box pooler f32", pyr32, scales, 1000, 7, 1),
        ("mask pooler f32", pyr32, scales, 100, 14, 1),
        ("box pooler bf16", pyr16, scales, 1000, 7, 1),
        ("mask pooler bf16", pyr16, scales, 100, 14, 1),
        ("single level f32 (L=1, B=2)", single, [1.0 / 16], 512, 14, 2),
    ]
    results = {}
    for name, feats, scs, r, p, batch in cases:
        boxes = spread_boxes(gen, r)
        if len(feats) > 1:
            levels = assign_boxes_to_levels(boxes, 2, 5)
        else:
            levels = torch.zeros(r, dtype=torch.int32, device=DEVICE)
        bidx = torch.randint(0, batch, (r,), generator=gen, device=DEVICE, dtype=torch.int32)
        results[name] = check_and_time_fwd(name, feats, scs, boxes, bidx, levels, p, baseline)
    return results


def request(rng, image_hw, true_hw, orig_hw):
    import numpy as np

    h, w = image_hw
    img = np.zeros((1, h, w, 3), np.float32)
    th, tw = true_hw
    img[0, :th, :tw] = rng.uniform(0, 255, (th, tw, 3)).astype(np.float32)
    return {
        "image": img,
        "image_sizes": np.array([true_hw], np.int32),
        "orig_sizes": np.array([orig_hw], np.int32),
    }


def check_detections(out, d, s):
    import torch

    shapes = {"boxes": (1, d, 4), "scores": (1, d), "classes": (1, d), "valid": (1, d), "masks": (1, d, s, s)}
    for k, shape in shapes.items():
        if tuple(out[k].shape) != shape:
            raise AssertionError(f"{k} has shape {tuple(out[k].shape)}, expected {shape}")
        if not torch.isfinite(out[k].float()).all():
            raise AssertionError(f"{k} holds non-finite values")


def tf32_flags():
    import torch

    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


def count_host_syncs(fn):
    """Runs ``fn`` and counts the operations in it that made the host wait
    for the card (PyTorch's sync debug mode warns once for each)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def phase_serve(kernel, dtypes, state):
    """The flagship answers SERVE_ROUNDS requests in each dtype after a
    warm-up in each, the dtypes in turns (a b, b a, ...) so that both meet
    the same host; then the first request split by stage, in turns too, and
    the host syncs of each stage. Returns K1's launches per dtype."""
    import numpy as np
    import torch

    from jtsm_tpu_torch.config import mask_rcnn_R_50_FPN_cfg
    from jtsm_tpu_torch.engine import Predictor
    from jtsm_tpu_torch.layers import exact_float32

    rng = np.random.default_rng(0)
    h, w = FLAGSHIP_HW
    warm = request(rng, (h, w), (h, w), (h, w))
    reqs = [
        request(rng, (h, w), (h, w), (h, w)),
        request(rng, (h, w), (h, w), (480, 640)),
        request(rng, (h, w), (h - 50, w - 11), (h - 50, w - 11)),  # content smaller than the canvas
        request(rng, (h, w), (h, w), (h, w)),
    ]
    flags = tf32_flags()
    predictors, mem = {}, {}
    for d in dtypes:
        cfg = mask_rcnn_R_50_FPN_cfg()
        cfg.TPU.COMPUTE_DTYPE = d
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        predictors[d] = Predictor(cfg, state)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        predictors[d](warm)
        torch.cuda.synchronize()
        mem[d] = ((resident - before) / 2**30, (torch.cuda.max_memory_allocated() - resident) / 2**30)
    detections = cfg.TEST.DETECTIONS_PER_IMAGE, 2 * cfg.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION

    kernel.launches = 0
    lat = {d: [] for d in dtypes}
    valid = {d: [] for d in dtypes}
    launches = dict.fromkeys(dtypes, 0)
    for i in range(SERVE_ROUNDS):
        req = reqs[i % len(reqs)]
        for d in dtypes if i % 2 == 0 else dtypes[::-1]:
            before = kernel.launches
            t0 = time.perf_counter()
            out = predictors[d](req)
            torch.cuda.synchronize()
            lat[d].append((time.perf_counter() - t0) * 1e3)
            check_detections(out, *detections)
            launches[d] += kernel.launches - before
            if kernel.launches - before != 2:
                raise AssertionError(f"{d} request {i}: roi_align_fwd launched {kernel.launches - before} times, not 2")
            bh, bw = req["orig_sizes"][0]
            boxes = out["boxes"][0]
            if (boxes[:, 2] > bw).any() or (boxes[:, 3] > bh).any() or (boxes < 0).any():
                raise AssertionError(f"{d} request {i}: boxes leave the original image")
            valid[d].append(int(out["valid"].sum()))
    if kernel.launches == 0:
        raise AssertionError("roi_align_fwd was not launched on the served path")
    if tf32_flags() != flags:
        raise AssertionError(f"serving changed the caller's TF32 flags {flags} to {tf32_flags()}")
    for d in dtypes:
        tag = DTYPE_NAMES[d]
        log(f"[serve] R50-FPN Mask R-CNN 800x1344 {tag}, {SERVE_ROUNDS} requests in turns with "
            f"{'/'.join(DTYPE_NAMES[o] for o in dtypes if o != d)}: latency_ms={[round(x, 3) for x in lat[d]]} "
            f"mean_ms={sum(lat[d]) / len(lat[d]):.3f} median_ms={sorted(lat[d])[len(lat[d]) // 2]:.3f} "
            f"valid_detections={valid[d]} roi_align_fwd_launches={launches[d]} "
            f"weights_gib={mem[d][0]:.3f} request_peak_gib={mem[d][1]:.3f}")

    # where a request's time goes: the model's stages one by one on the
    # first request, each ended by a synchronize (host clock, median of
    # STAGE_ROUNDS runs, the dtypes in turns); then one more run of each
    # stage counting its host syncs
    def run_stages(model, measure):
        """The three stages of ``req`` through ``model``; ``measure`` makes
        each call and returns its reading."""
        r = {}
        with torch.no_grad(), exact_float32(model.compute_dtype == torch.float32):
            readings = {
                "backbone": measure(lambda: r.update(zip(("feats", "sizes"), model._features(req)))),
                "rpn": measure(lambda: r.update(zip(("proposals", "scores", "_"), model.proposal_generator(
                    r["sizes"], r["feats"])))),
                "roi_heads": measure(lambda: model.roi_heads(r["feats"], r["proposals"], r["scores"], r["sizes"])),
            }
        return readings, r["feats"].values()

    def timed(call):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    req = reqs[0]
    stage_ms = {d: {} for d in dtypes}
    for i in range(STAGE_ROUNDS):
        for d in dtypes if i % 2 == 0 else dtypes[::-1]:
            for k, ms in run_stages(predictors[d].model, timed)[0].items():
                stage_ms[d].setdefault(k, []).append(ms)
    for d in dtypes:
        syncs, feats = run_stages(predictors[d].model, count_host_syncs)
        if not all(f.is_contiguous(memory_format=torch.channels_last) for f in feats):
            raise AssertionError(f"{d}: the FPN maps are not channels-last")
        log(f"[serve] {DTYPE_NAMES[d]} stages_ms (median of {STAGE_ROUNDS}) "
            + " ".join(f"{k}={sorted(v)[len(v) // 2]:.3f}" for k, v in stage_ms[d].items())
            + " | host syncs " + " ".join(f"{k}={n}" for k, n in syncs.items())
            + f" | FPN maps {sorted({str(f.dtype) for f in feats})}, channels-last (free NHWC views for the poolers)")
    return launches


def phase_trained():
    import numpy as np
    import torch

    import jtsm_tpu_torch.modeling.poolers as poolers
    from jtsm_tpu_torch.checkpoint import load_gate_ckpt, variables_to_state_dict
    from jtsm_tpu_torch.config import mask_rcnn_gate_cfg
    from jtsm_tpu_torch.modeling import build_model
    from jtsm_tpu_torch.ops.roi_align import roi_align_multilevel_plain

    cfg = mask_rcnn_gate_cfg()
    model = build_model(cfg)
    model.load_state_dict(variables_to_state_dict(load_gate_ckpt(os.path.join(REPO, cfg.MODEL.WEIGHTS))))
    rng = np.random.RandomState(1)
    h, w = 128, 176
    img = np.full((h, w, 3), 128.0, np.float32)
    img[: h // 2] = [205, 115, 95]
    img[h // 2:] = [95, 175, 95]
    for _ in range(4):
        y0, x0 = rng.randint(0, h - 40), rng.randint(0, w - 40)
        img[y0: y0 + rng.randint(20, 60), x0: x0 + rng.randint(20, 60)] = rng.randint(55, 255, 3)
    img += rng.randn(h, w, 3).astype(np.float32) * 3
    batch = {"image": img[None], "image_sizes": np.array([[h, w]], np.int32),
             "orig_sizes": np.array([[2 * h, 2 * w]], np.int32)}
    torch.backends.cudnn.deterministic = True
    kernel_out = model.inference(batch)
    # the same model with its poolers calling the plain version on the card
    routed = poolers.roi_align_multilevel
    poolers.roi_align_multilevel = roi_align_multilevel_plain
    try:
        plain_out = model.inference(batch)
    finally:
        poolers.roi_align_multilevel = routed
    torch.cuda.synchronize()
    k = {n: v.float().cpu() for n, v in kernel_out.items()}
    p = {n: v.float().cpu() for n, v in plain_out.items()}
    n_valid = int(k["valid"].sum())
    if n_valid == 0:
        raise AssertionError("the trained gate model found nothing on its synthetic scene")
    if not (torch.equal(k["valid"], p["valid"]) and torch.equal(k["classes"], p["classes"])):
        raise AssertionError("kernel and plain paths disagree on valid detections or classes")
    errs = {n: (k[n] - p[n]).abs().max().item() for n in ("boxes", "scores", "masks")}
    tols = {"boxes": 1e-3 * max(h, w), "scores": 1e-4, "masks": 1e-4}
    log(f"[trained] gate checkpoint ({cfg.TPU.COMPUTE_DTYPE}), 1 image {h}x{w}: valid_detections={n_valid} "
        f"classes={kernel_out['classes'][0][kernel_out['valid'][0]].tolist()[:10]} "
        f"max_abs_err={errs} tol={tols}")
    for n in errs:
        if not errs[n] <= tols[n]:
            raise AssertionError(f"kernel vs plain {n}: {errs[n]} > {tols[n]}")


def phase_train_kernels(gen, baseline):
    """K1 and K2 against their plain versions at the training shapes: B=2,
    the flagship pyramid, 1024 box ROIs (P=7) and 256 mask ROIs (P=14), in
    float32 and bfloat16; then the edge cases of the card-only tests."""
    import torch

    from jtsm_tpu_torch.modeling.poolers import assign_boxes_to_levels

    scales = [1.0 / s for s in LEVEL_STRIDES]
    pyr32 = flagship_pyramid(gen, dtype=torch.float32, batch=TRAIN_BATCH)
    results = {}
    for pooler, r, p in (("box", 1024, 7), ("mask", 256, 14)):
        boxes = spread_boxes(gen, r)
        levels = assign_boxes_to_levels(boxes, 2, 5)
        # image-major, as the train step pools them
        bidx = torch.arange(TRAIN_BATCH, dtype=torch.int32, device=DEVICE).repeat_interleave(r // TRAIN_BATCH)
        for dtype in (torch.float32, torch.bfloat16):
            feats = [f.to(dtype) for f in pyr32]
            name = f"{pooler} pooler {dtype_tag(feats[0])}"
            results[f"fwd {name}"] = check_and_time_fwd(
                f"{name} B={TRAIN_BATCH}", feats, scales, boxes, bidx, levels, p, baseline, "train_kernels"
            )
            results[f"bwd {name}"] = check_and_time_bwd(
                f"{name} B={TRAIN_BATCH}", feats, scales, boxes, bidx, levels, p, gen, baseline
            )
    del pyr32

    # both kernels on the edge cases their vector and table paths could get
    # wrong, with the card-only tests' own inputs and tolerances (the file is
    # loaded by its path: another package named "tests" may be installed)
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "card_tests", os.path.join(REPO, "tests", "test_torch_kernels.py")
    )
    card_tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(card_tests)
    for name in card_tests.EDGE_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            card_tests.test_roi_align_kernels_edge_cases_match_plain(name, dtype)
    log(f"[train_kernels] K1 and K2 match their plain versions on the edge cases {card_tests.EDGE_CASES} "
        "in float32 and bfloat16")
    return results


def synthetic_train_batch(seed, b, hw, g=100, valid=8, crop=56):
    """A batch in the JAX package's schema: seeded images, ``valid`` ground
    truth boxes per image in a capacity of ``g`` (TPU.MAX_GT_INSTANCES),
    their classes, and ``crop`` x ``crop`` ellipse masks inside each box."""
    import numpy as np

    rng = np.random.default_rng(seed)
    h, w = hw
    size = rng.uniform(0.04, 0.5, (b, g, 2)) * min(h, w)
    xy = rng.uniform(0, 1, (b, g, 2)) * (np.array([w, h]) - size)
    boxes = np.concatenate([xy, xy + size], -1).astype(np.float32)
    yy, xx = np.mgrid[0:crop, 0:crop] + 0.5
    ry, rx = rng.uniform(0.5, 1.0, (2, b, g, 1, 1)) * crop / 2
    crops = ((yy - crop / 2) / ry) ** 2 + ((xx - crop / 2) / rx) ** 2 <= 1.0
    return {
        "image": rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32),
        "image_sizes": np.array([[h, w]] * b, np.int32),
        "gt_boxes": boxes,
        "gt_classes": rng.integers(0, 80, (b, g)).astype(np.int32),
        "gt_valid": np.arange(g)[None].repeat(b, 0) < valid,
        "gt_mask_crops": crops,
    }


def phase_train(kernels, dtype, state_dict):
    """The flagship at ``dtype`` takes TRAIN_STEPS steps at full width; then
    one more step split by stage."""
    import torch

    from jtsm_tpu_torch.config import mask_rcnn_R_50_FPN_cfg
    from jtsm_tpu_torch.engine import create_train_state, make_train_step
    from jtsm_tpu_torch.layers import exact_float32
    from jtsm_tpu_torch.modeling import build_model
    from jtsm_tpu_torch.solver import build_lr_schedule, build_optimizer

    cfg = mask_rcnn_R_50_FPN_cfg()
    cfg.TPU.COMPUTE_DTYPE = dtype
    tag = DTYPE_NAMES[dtype]
    model = build_model(cfg)
    model.load_state_dict(state_dict)
    optimizer = build_optimizer(cfg, model)
    state = create_train_state(model, optimizer, seed=0)
    train_step = make_train_step(model, optimizer, build_lr_schedule(cfg))
    batch = synthetic_train_batch(0, TRAIN_BATCH, FLAGSHIP_HW, g=cfg.TPU.MAX_GT_INSTANCES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    keys = ["loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "loss_mask"]
    for k in kernels:
        k.launches = 0
    times = []
    for i in range(TRAIN_STEPS):
        before = [k.launches for k in kernels]
        t0 = time.perf_counter()
        metrics = train_step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        values = {k: v.item() for k, v in metrics.items()}
        if sorted(values) != sorted(keys + ["total_loss"]):
            raise AssertionError(f"{tag} step {i}: loss keys {sorted(values)}")
        if not all(math.isfinite(v) for v in values.values()):
            raise AssertionError(f"{tag} step {i}: non-finite losses {values}")
        per_step = [k.launches - b for k, b in zip(kernels, before)]
        if per_step != [2] * len(kernels):
            raise AssertionError(f"{tag} step {i}: launches {dict(zip([k.name for k in kernels], per_step))}, not 2 each")
        log(f"[train] {tag} step {i}: ms={times[-1]:.3f} " + " ".join(f"{k}={values[k]:.6g}" for k in keys + ["total_loss"]))
    launches = {k.name: k.launches for k in kernels}
    if any(n == 0 for n in launches.values()):
        raise AssertionError(f"a kernel was not launched on the train path: {launches}")
    if {p.dtype for p in model.parameters()} != {torch.float32}:
        raise AssertionError("training moved parameters off float32")
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = sorted(times[1:])[len(times[1:]) // 2]
    log(f"[train] R50-FPN Mask R-CNN, {TRAIN_BATCH} images 800x1344 per step, {tag}"
        f"{' (TF32 off)' if dtype == 'float32' else ''}: {TRAIN_STEPS} steps "
        f"step_ms={[round(t, 3) for t in times]} median_after_first_ms={med:.3f} launches={launches} "
        f"peak_mem_gib={peak:.3f}")

    # one more step, split by stage (host clock, a synchronize after each);
    # hooks on the FPN maps read the layout of the gradients the poolers
    # and the RPN hand back to the backbone
    stage = {}
    grad_layout = {}
    dev = model.device
    with exact_float32(model.compute_dtype == torch.float32):
        t0 = time.perf_counter()
        features, sizes = model._features(batch)
        for name in ("p2", "p3", "p4", "p5"):
            features[name].register_hook(
                lambda g, name=name: grad_layout.__setitem__(name, g.is_contiguous(memory_format=torch.channels_last))
            )
        targets = {k: torch.as_tensor(v, device=dev) for k, v in batch.items() if k.startswith("gt_")}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        proposals, scores, losses = model.proposal_generator(
            sizes, features, targets["gt_boxes"], targets["gt_valid"], state.generator
        )
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        losses.update(model.roi_heads(features, proposals, scores, sizes, targets, state.generator))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        optimizer.zero_grad(set_to_none=True)
        sum(losses.values()).backward()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for group in optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        optimizer.step()
        torch.cuda.synchronize()
        t5 = time.perf_counter()
    for k, (a, b) in {"backbone": (t0, t1), "rpn": (t1, t2), "roi_heads": (t2, t3), "backward": (t3, t4),
                      "optimizer": (t4, t5)}.items():
        stage[k] = (b - a) * 1e3
    log(f"[train] {tag} stages_ms " + " ".join(f"{k}={v:.3f}" for k, v in stage.items())
        + f" | FPN map gradients channels-last (no copy to another format): {grad_layout}")
    if len(grad_layout) != 4 or not all(grad_layout.values()):
        raise AssertionError(f"{tag}: FPN map gradients {grad_layout}, not channels-last on all four")
    return launches, med


def phase_train_trained():
    """One train step from the gate checkpoint through K1/K2 and through
    the plain forward and backward on the card: losses and the gradient of
    every parameter must agree."""
    import torch

    import jtsm_tpu_torch.modeling.poolers as poolers
    from jtsm_tpu_torch.checkpoint import load_gate_ckpt, variables_to_state_dict
    from jtsm_tpu_torch.config import mask_rcnn_gate_cfg
    from jtsm_tpu_torch.engine import create_train_state, make_train_step
    from jtsm_tpu_torch.modeling import build_model
    from jtsm_tpu_torch.ops.roi_align import roi_align_multilevel_plain_autograd
    from jtsm_tpu_torch.solver import build_lr_schedule, build_optimizer

    cfg = mask_rcnn_gate_cfg()
    cfg.SOLVER.CLIP_GRADIENTS.ENABLED = False  # not ported yet; the gradients are compared before it
    state_dict = variables_to_state_dict(load_gate_ckpt(os.path.join(REPO, cfg.MODEL.WEIGHTS)))
    batch = synthetic_train_batch(1, 2, (128, 176), g=cfg.TPU.MAX_GT_INSTANCES, valid=4)

    def step():
        model = build_model(cfg)
        model.load_state_dict(state_dict)
        optimizer = build_optimizer(cfg, model)
        state = create_train_state(model, optimizer, seed=0)
        metrics = make_train_step(model, optimizer, build_lr_schedule(cfg))(state, batch)
        return ({k: v.item() for k, v in metrics.items()},
                {n: p.grad.detach().clone() for n, p in model.named_parameters()})

    torch.backends.cudnn.deterministic = True
    kernel_losses, kernel_grads = step()
    routed = poolers.roi_align_multilevel
    poolers.roi_align_multilevel = roi_align_multilevel_plain_autograd
    try:
        plain_losses, plain_grads = step()
    finally:
        poolers.roi_align_multilevel = routed
    loss_err = max(abs(kernel_losses[k] - plain_losses[k]) / max(1.0, abs(plain_losses[k])) for k in plain_losses)
    grad_err = max(
        ((kernel_grads[n] - plain_grads[n]).abs().max() / plain_grads[n].abs().max().clamp(min=1e-12)).item()
        for n in plain_grads
    )
    log(f"[train_trained] gate checkpoint ({cfg.TPU.COMPUTE_DTYPE}), 2 images 128x176, one step: "
        f"losses={kernel_losses} max_rel_loss_err={loss_err:.3e} (tol 1e-5) max_rel_grad_err={grad_err:.3e} over "
        f"{len(plain_grads)} parameters (tol 1e-4 of each parameter's gradient scale)")
    if not all(math.isfinite(v) for v in kernel_losses.values()):
        raise AssertionError(f"non-finite losses {kernel_losses}")
    if not loss_err <= 1e-5:
        raise AssertionError(f"kernel vs plain losses differ by {loss_err}")
    if not grad_err <= 1e-4:
        raise AssertionError(f"kernel vs plain gradients differ by {grad_err}")


def kernel_line(kernel, launches, rows, f32_errs):
    """One entry of the kernels JSON line. ``ms``, ``plain_ms`` and
    ``bound_ms`` keep their long-standing meaning: the float32 box and mask
    pooler rows summed, under the timer without a queue, against the bound
    of the summed work. Beside them: ``device_ms`` (the same rows, the
    device's time alone), the bf16 rows (the flagship's compute dtype) and,
    with --baseline, the earlier kernel's times on the same inputs."""

    def summed(key, who, timer):
        return rows[f"box pooler {key}"]["times"][who][timer] + rows[f"mask pooler {key}"]["times"][who][timer]

    def summed_bound(key):
        box, mask = rows[f"box pooler {key}"], rows[f"mask pooler {key}"]
        return bound(box["nbytes"] + mask["nbytes"], box["flops"] + mask["flops"])

    box, mask = rows["box pooler f32"], rows["mask pooler f32"]
    b_ms, b_by = summed_bound("f32")
    line = {
        "name": kernel.name,
        "route": "cuda",
        "source": kernel.source,
        "replaces": kernel.replaces,
        "launches": launches,
        "max_abs_err": max(f32_errs),
        "ms": summed("f32", "new", "ms"),
        "plain_ms": box["plain_ms"] + mask["plain_ms"],
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
        "device_ms": summed("f32", "new", "device_ms"),
        "bf16_ms": summed("bf16", "new", "ms"),
        "bf16_device_ms": summed("bf16", "new", "device_ms"),
        "bf16_bound_ms": summed_bound("bf16")[0],
        "bf16_max_abs_err": max(rows["box pooler bf16"]["err"], rows["mask pooler bf16"]["err"]),
    }
    if "baseline" in box["times"]:
        line.update({
            "baseline_ms": summed("f32", "baseline", "ms"),
            "baseline_device_ms": summed("f32", "baseline", "device_ms"),
            "bf16_baseline_ms": summed("bf16", "baseline", "ms"),
            "bf16_baseline_device_ms": summed("bf16", "baseline", "device_ms"),
        })
    return line


def build_baseline(src_dir):
    """K1 and K2 from the sources in ``src_dir`` (an earlier
    ``jtsm_tpu_torch/ops/csrc`` with the same C interfaces), compiled with the
    package's nvcc command into a temporary directory outside the checkout,
    which is removed once both libraries are loaded. Their launches count
    apart from the package's kernels."""
    import ctypes
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    from jtsm_tpu_torch.ops.cuda_build import NVCC_FLAGS, BuiltLibrary, find_nvcc
    from jtsm_tpu_torch.ops.roi_align_cuda import RoIAlignBwdKernel, RoIAlignFwdKernel

    out_dir = tempfile.mkdtemp(prefix="jtsm_baseline_kernels_")

    def one(kernel):
        src = os.path.join(src_dir, os.path.basename(kernel.source))
        out = os.path.join(out_dir, f"lib{kernel.name}.so")
        t0 = time.perf_counter()
        proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", out, src], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on {src}:\n{proc.stdout}\n{proc.stderr}")
        lib = ctypes.CDLL(out)
        fn = getattr(lib, kernel.entry)
        fn.argtypes = kernel.argtypes
        fn.restype = ctypes.c_int
        kernel.built = BuiltLibrary(lib, Path(src), time.perf_counter() - t0, "")
        return kernel

    try:
        with ThreadPoolExecutor(2) as pool:
            return tuple(pool.map(one, (RoIAlignFwdKernel(), RoIAlignBwdKernel())))
    finally:
        shutil.rmtree(out_dir)


def main(argv=None) -> int:
    t_run = time.perf_counter()
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--baseline", metavar="DIR", help="sources of an earlier "
                        "jtsm_tpu_torch/ops/csrc to build and time beside this checkout's kernels")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "jtsm_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)

    # 1. device
    t0 = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} | TF32 (matmul, cuDNN) as found: {tf32_flags()}; the port "
        f"turns both off in float32 | {time.perf_counter() - t0:.1f}s")

    # 2. build
    t0 = time.perf_counter()
    from concurrent.futures import ThreadPoolExecutor

    from jtsm_tpu_torch.ops.roi_align_cuda import BWD_KERNEL, KERNEL, KERNELS, load_kernels

    with ThreadPoolExecutor(1) as pool:
        pending = pool.submit(build_baseline, args.baseline) if args.baseline else None
        for k, built in zip(KERNELS, load_kernels()):
            log(f"[build] {k.source} -> {os.path.relpath(built.path, REPO)} in {built.seconds:.1f}s (nvcc)")
            for line in built.ptxas_log.splitlines():
                log(f"[build] {line.strip()}")
        baseline = pending and pending.result()
    for k in baseline or ():
        log(f"[build] baseline {k.built.path} in {k.built.seconds:.1f}s (nvcc, into a temporary directory)")
    log(f"[build] done in {time.perf_counter() - t0:.1f}s (one nvcc per source, in parallel)"
        + ("" if baseline else "; no --baseline: times beside an earlier version not measured"))

    # 3. K1 against its plain version at the served shapes
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    res = phase_kernels(gen, baseline)
    log(f"[kernels] done in {time.perf_counter() - t0:.1f}s")

    # 4. serve the flagship at its configured dtype, then in float32
    from jtsm_tpu_torch.checkpoint import random_state_dict
    from jtsm_tpu_torch.config import mask_rcnn_R_50_FPN_cfg
    from jtsm_tpu_torch.modeling import build_model

    flagship = mask_rcnn_R_50_FPN_cfg()
    main_dtype = flagship.TPU.COMPUTE_DTYPE
    if main_dtype != "bfloat16":
        raise AssertionError(f"the flagship's TPU.COMPUTE_DTYPE is {main_dtype}, not bfloat16")
    state = random_state_dict(build_model(flagship, device="cpu"), seed=0)
    t0 = time.perf_counter()
    launches = phase_serve(KERNEL, (main_dtype, "float32"), state)
    log(f"[serve] done in {time.perf_counter() - t0:.1f}s")

    # 5. trained weights, kernel against plain on the card
    t0 = time.perf_counter()
    phase_trained()
    log(f"[trained] done in {time.perf_counter() - t0:.1f}s")

    # 6. the training kernels against their plain versions
    t0 = time.perf_counter()
    tres = phase_train_kernels(gen, baseline)
    log(f"[train_kernels] done in {time.perf_counter() - t0:.1f}s")

    # 7. train the flagship (cuDNN's own algorithm choice, as a user trains)
    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = False
    train = {d: phase_train(KERNELS, d, state) for d in (main_dtype, "float32")}
    log(f"[train] done in {time.perf_counter() - t0:.1f}s")

    # 8. a train step from trained weights, kernels against plain
    t0 = time.perf_counter()
    phase_train_trained()
    log(f"[train_trained] done in {time.perf_counter() - t0:.1f}s")

    # per served request K1 pools boxes (R=1000, P=7) and masks (R=100,
    # P=14); per train step K1 and K2 pool and unpool boxes (R=1024, P=7)
    # and masks (R=256, P=14). Times as kernel_line says; launches: both
    # main paths, serve and train, in both dtypes.
    k1_launches = sum(launches.values()) + sum(t[0][KERNEL.name] for t in train.values())
    k2_launches = sum(t[0][BWD_KERNEL.name] for t in train.values())
    bwd = {k[4:]: v for k, v in tres.items() if k.startswith("bwd ")}
    kernels = [
        kernel_line(KERNEL, k1_launches, res, [r["err"] for n, r in res.items() if "f32" in n]),
        kernel_line(BWD_KERNEL, k2_launches, bwd, [r["err"] for n, r in bwd.items() if "f32" in n]),
    ]
    log("[train] median step ms " + " ".join(f"{DTYPE_NAMES[d]}={t[1]:.3f}" for d, t in train.items())
        + f"; K1 launches serve {launches}, train " + str({d: t[0][KERNEL.name] for d, t in train.items()}))
    log(f"[done] {time.perf_counter() - t_run:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
