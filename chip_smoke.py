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
   give the same losses and gradients;
9. score: (a) the committed gate checkpoint (float32) scores the 8 synthetic
   COCO scenes of its gate (``data.datasets.synthetic``, the seed and count
   of ``tests/test_inference_gates.py``, before JPEG encoding) through
   ``engine.defaults.test`` on the card (K1, paste on the card) and on this
   machine's CPU (plain pooler, paste on the CPU): the COCO result lists must
   hold the same detections (boxes within 1e-3 px, scores within 1e-4,
   each mask's IoU at least 0.999), the CPU run's outputs pasted on the
   card must give the CPU's masks pixel for pixel, and bbox and segm AP
   must agree within 0.02; then the same on
   the card in bfloat16, reported beside float32; K1 must launch twice an
   image in each run on the card; (b) the flagship at full width (random
   weights from phase 4's seed) scores 16 synthetic scenes of 480x640,
   resized to 800 (max 1333), in bfloat16 and float32 in turns, with the
   seconds per image of each stage (data, model, paste, RLE encode,
   COCOEval), K1's launches and the peak memory, and the model's time alone
   on the same batches collated beforehand; its AP is printed, not checked
   (random weights);
10. jtsm: (a) K1 against its plain version at the JTSM mask pooler's shape
   (one level, a (1, 64, 64, 512) res5 map, R=100, P=14) in float32 and
   bfloat16, timed beside its bound; (b) the JTSM flagship
   (``jtsm_WSR_18_DC5_1x.yaml``, test-time augmentation off) at full width
   with random weights from a seed serves 8 requests in each of bfloat16
   and float32, in turns: one VOC-size 375x500 image resized to 688x917 in
   the 1024x1024 bucket, 4000 seeded proposals (the last 150 padding),
   1000 Voronoi superpixels and their membership; K1 must launch once a
   request and the plain ROIAlign never; then the stage split with its
   host syncs and the peak memory; (c) the committed JTSM gate checkpoint
   on two seeded 128x176 requests on the card against the CPU: detections
   matched by (source proposal, class), boxes within 1e-3 px, scores and
   mask probabilities within 1e-4, so that a mask pixel lands on the other
   side of 0.5 only within 1e-4 of it (each mask's IoU is reported);
   detections may trade slots only with a score within 1e-4
   (``match_detections``);
11. jtsm train: (a) K1 and K2 against their plain versions at the JTSM
   mask pooler's train shape (a (4, 64, 64, 512) res5 map, R=256 mined
   boxes, P=14) in float32 and bfloat16, timed beside their bounds; (b) the
   JTSM flagship at full width and depth (random weights from phase 10's
   seed) takes 5 SGD steps in each of bfloat16 and float32, in turns, on
   IMS_PER_BATCH 4 seeded requests of phase 10's kind with seeded image
   labels; every loss must be finite, K1 must launch once a step and K2
   never (FREEZE_AT 5: no gradient reaches the maps), and the plain
   ROIAlign never runs; then the stage split with its host syncs, peak
   memory, and one step at the largest train scale (short side 1200);
   (c) the JTSM gate config (FREEZE_AT 0, the full-model clip, seeded
   weights, dropout 0) takes 3 steps on the card and on the CPU from the
   same weights and batch: the mined mask ROIs and the painted pseudo
   sem-seg map equal, losses within 1e-4 relative, every parameter within
   1e-5 of its scale after the steps, K1 and K2 once a step on the card;
12. jtsm score: (a) the committed JTSM gate checkpoint scores the 12 scenes
   of the dev script's cocovar tree, made in memory before JPEG
   (``data.datasets.synthetic``), through the WSL test loader, panoptic
   fusion and the COCO, SemSeg and panoptic evaluators
   (``engine.defaults.test``), on the card (K1 once an image, the plain
   ROIAlign stubbed to raise on the card) and on this machine's CPU:
   detections matched by (source proposal, class) as in phase 10(c), the
   fused sem-seg maps equal but where the two largest upsampled logits lie
   within 1e-4, and bbox AP, segm AP, mIoU and PQ within 0.02; (b) the JTSM
   flagship at full width (phase 10's random weights, test-time
   augmentation off) scores 8 seeded VOC-shaped 375x500 scenes at 688x917
   (4000 proposals, 1000 superpixels, 1-3 VOC things over the background
   stuff, registered with the VOC panoptic-separated metadata) in
   bfloat16 and float32, 2 runs each in turns: K1 once an image, the four
   tasks' numbers present (printed, not checked: random weights), the
   seconds per image of each stage (data, model, fusion, paste, encode,
   each evaluator, total) and the peak memory.

The last three lines are {"kernels": [...]} (``kernel_line`` says which
times; ``l1_*`` are K1's single-level rows of phase 10, ``jt_*`` K1's and
K2's rows at phase 11's train shape, ``js_launches`` its launches in phase
12), the card's name and power limit as
nvidia-smi gives them, and {"ok": true, "device": {...}}. Needs one card, torch, numpy and pytest;
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
GATE_SCENES = 8  # tests/test_inference_gates.py: make_synthetic_coco.py --num 8
SCORE_SCENES = 16
SCORE_HW = (480, 640)  # COCO's usual image size
SCORE_ROUNDS = 2  # flagship scoring runs in each dtype, in turns
JTSM_IMAGE_HW = (375, 500)  # a VOC-size image
JTSM_ROUNDS = 8  # JTSM requests in each dtype
JTSM_PADDING = 150  # padded proposal slots of the 4000
JTSM_SUPERPIXELS = 1000  # Voronoi cells (WSL.MAX_SUPERPIXELS is 1024)
JTSM_TRAIN_STEPS = 5  # train steps in each dtype
JTSM_TRAIN_SHORT = 688  # an INPUT.MIN_SIZE_TRAIN scale, the one phase 10 serves
JTSM_TRAIN_LARGEST = (1200, (1216, 1600))  # the largest train scale and a canvas that holds it
JTSM_GATE_STEPS = 3
JTSM_FLAGSHIP_LOSSES = sorted(["loss_mil", "loss_mask", "loss_mask_r0", "total_loss"]
                              + [f"loss_refine_{k}{i}" for k in ("cls", "reg") for i in range(4)])
GATE_VAR_SCENES = 12  # the dev script's cocovar tree (--num-varied 12)
JTSM_SCORE_SCENES = 8
JTSM_SCORE_ROUNDS = 2  # flagship scoring runs in each dtype, in turns
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


def check_and_time_bwd(tag, feats, scales, boxes, bidx, levels, p, gen, baseline, phase="train_kernels"):
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
    log(f"[{phase}] roi_align_bwd {tag}: R={boxes.shape[0]} P={p} max_abs_err={err:.3e} "
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
    cfg.SOLVER.CLIP_GRADIENTS.ENABLED = False  # the gradients are compared as the backward pass leaves them
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


def score_once(cfg, state_dict, device, evaluator_name, kernel, captured=None):
    """``engine.defaults.test`` of ``cfg`` on ``device``, K1's count set to
    0 just before and read just after: returns the results, the COCO result
    list, K1's launches, the seconds of each stage (``timings``) and the
    peak device memory of the run (GiB above what was allocated before).
    With ``captured`` (a list), the model's raw outputs and the batch's
    original sizes are appended to it, batch by batch."""
    import torch

    from jtsm_tpu_torch.engine import test
    from jtsm_tpu_torch.evaluation import COCOEvaluator
    from jtsm_tpu_torch.modeling import build_model

    model = build_model(cfg, device=device)
    model.load_state_dict(state_dict)
    if captured is not None:
        inference = model.inference

        def capture(batch):
            out = inference(batch)
            captured.append((out, batch["orig_sizes"]))
            return out

        model.inference = capture
    timings = {}
    evaluator = COCOEvaluator(evaluator_name, timings=timings)  # no output_dir: writes nothing
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    kernel.launches = 0
    t0 = time.perf_counter()
    results = test(cfg, model, evaluators=[evaluator], timings=timings)
    timings["total"] = time.perf_counter() - t0
    launches = kernel.launches
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30 if on_card else float("nan")
    return results, evaluator.predictions, launches, timings, peak


def compare_results(want, got):
    """The largest box and score differences between two COCO result lists
    of the same detections in the same order, and for their masks the
    smallest IoU, the masks that differ and their differing pixels; raises
    where the lists do not hold the same detections."""
    from jtsm_tpu_torch.data.rle import decode_segmentation

    if len(got) != len(want):
        raise AssertionError(f"{len(got)} detections against {len(want)}")
    box_err = score_err = 0.0
    min_iou, masks_differ, pixels_differ = 1.0, 0, 0
    for g, w in zip(got, want):
        if (g["image_id"], g["category_id"]) != (w["image_id"], w["category_id"]):
            raise AssertionError(f"detection {g['image_id'], g['category_id']} against {w['image_id'], w['category_id']}")
        box_err = max(box_err, max(abs(a - b) for a, b in zip(g["bbox"], w["bbox"])))
        score_err = max(score_err, abs(g["score"] - w["score"]))
        if g["segmentation"] != w["segmentation"]:
            gm, wm = (decode_segmentation(r["segmentation"], 0, 0) for r in (g, w))
            union = int((gm | wm).sum())
            min_iou = min(min_iou, int((gm & wm).sum()) / union if union else 1.0)
            masks_differ += 1
            pixels_differ += int((gm != wm).sum())
    return box_err, score_err, min_iou, masks_differ, pixels_differ


def check_paste_on_card(captured):
    """The CPU run's raw outputs pasted on the card and on the CPU: the
    same masks, pixel for pixel. Returns the number of masks compared."""
    import torch

    from jtsm_tpu_torch.ops.paste_masks import paste_masks

    n = 0
    for out, orig_sizes in captured:
        for i, (h, w) in enumerate(orig_sizes.tolist()):
            sel = out["valid"][i]
            masks, boxes = out["masks"][i][sel], out["boxes"][i][sel]
            on_cpu = paste_masks(masks, boxes, h, w)
            on_card = paste_masks(masks.to(DEVICE), boxes.to(DEVICE), h, w).cpu()
            if not torch.equal(on_card, on_cpu):
                raise AssertionError(f"the paste on the card differs from the CPU's on {int((on_card != on_cpu).sum())} pixels")
            n += int(sel.sum())
    return n


def format_ap(results):
    return " ".join(f"{task}_AP={results[task]['AP']:.4f}" for task in ("bbox", "segm"))


def phase_score(kernel, state):
    """(a) the gate on the card against the port on the CPU, and in bf16;
    (b) the flagship's scoring at full width, stage by stage. Returns K1's
    launches."""
    import torch

    from jtsm_tpu_torch.checkpoint import load_gate_ckpt, variables_to_state_dict
    from jtsm_tpu_torch.config import mask_rcnn_gate_cfg, mask_rcnn_R_50_FPN_cfg
    from jtsm_tpu_torch.data.datasets.synthetic import register_synthetic_coco
    from jtsm_tpu_torch.engine.defaults import build_test_loader
    from jtsm_tpu_torch.modeling import build_model

    launches = 0
    # (a) the gate: the card against the CPU in float32, then bf16 on the card
    gate = "chip_smoke_gate"
    register_synthetic_coco(gate, num=GATE_SCENES, seed=0)
    cfg = mask_rcnn_gate_cfg()
    cfg.DATASETS.TEST = (gate,)
    weights = variables_to_state_dict(load_gate_ckpt(os.path.join(REPO, cfg.MODEL.WEIGHTS)))
    runs, cpu_outputs = {}, []
    for name, device, dtype in (("card f32", DEVICE, "float32"), ("cpu f32", "cpu", "float32"),
                                ("card bf16", DEVICE, "bfloat16")):
        c = cfg.clone()
        c.TPU.COMPUTE_DTYPE = dtype
        runs[name] = score_once(c, weights, device, gate, kernel, cpu_outputs if device == "cpu" else None)
        n = runs[name][2]
        if device != "cpu":
            launches += n
            if n != 2 * GATE_SCENES:
                raise AssertionError(f"gate {name}: roi_align_fwd launched {n} times for {GATE_SCENES} images, not 2 each")
        log(f"[score] gate checkpoint on {GATE_SCENES} synthetic scenes (before JPEG), {name}: "
            f"{format_ap(runs[name][0])} detections={len(runs[name][1])} roi_align_fwd_launches={n} "
            f"seconds={runs[name][3]['total']:.2f}")
    pasted = check_paste_on_card(cpu_outputs)
    box_err, score_err, min_iou, masks_differ, pixels_differ = compare_results(runs["cpu f32"][1], runs["card f32"][1])
    ap_diff = {t: abs(runs["card f32"][0][t]["AP"] - runs["cpu f32"][0][t]["AP"]) for t in ("bbox", "segm")}
    bf16_diff = {t: runs["card bf16"][0][t]["AP"] - runs["card f32"][0][t]["AP"] for t in ("bbox", "segm")}
    # the paste is exact: on the same inputs the card's masks are the CPU's
    # (checked above); across the two runs its inputs differ by the boxes'
    # and mask probabilities' float32 rounding, which moves the odd pixel
    # whose value lies next to the threshold
    log(f"[score] gate card f32 against cpu f32: {len(runs['card f32'][1])} detections, max box diff "
        f"{box_err:.3e} px (tol 1e-3), max score diff {score_err:.3e} (tol 1e-4), masks differing "
        f"{masks_differ} by {pixels_differ} pixels, min mask IoU {min_iou:.6f} (tol 0.999); the CPU run's outputs "
        f"pasted on the card and on the CPU: {pasted} masks, equal pixel for pixel | AP diff bbox "
        f"{ap_diff['bbox']:.4f} segm {ap_diff['segm']:.4f} (tol 0.02) | "
        f"bf16 minus f32 on the card: bbox {bf16_diff['bbox']:+.4f} segm {bf16_diff['segm']:+.4f} AP")
    if not box_err <= 1e-3 or not score_err <= 1e-4 or not min_iou >= 0.999:
        raise AssertionError("the card's gate detections differ from the CPU's")
    if not max(ap_diff.values()) <= 0.02:
        raise AssertionError(f"the card's gate AP differs from the CPU's by {ap_diff}")

    # (b) the flagship at full width: 16 scenes at 480x640, bf16 and f32 in turns
    name = "chip_smoke_flagship"
    register_synthetic_coco(name, num=SCORE_SCENES, seed=0, image_hw=SCORE_HW)
    dtypes = (mask_rcnn_R_50_FPN_cfg().TPU.COMPUTE_DTYPE, "float32")
    stats = {d: [] for d in dtypes}
    for i in range(SCORE_ROUNDS):
        for d in dtypes if i % 2 == 0 else dtypes[::-1]:
            c = mask_rcnn_R_50_FPN_cfg()
            c.TPU.COMPUTE_DTYPE = d
            c.DATASETS.TEST = (name,)
            results, preds, n, timings, peak = score_once(c, state, DEVICE, name, kernel)
            launches += n
            if n != 2 * SCORE_SCENES:
                raise AssertionError(f"flagship {d}: roi_align_fwd launched {n} times for {SCORE_SCENES} images")
            stats[d].append((results, len(preds), timings, peak, n))
    # the model alone on the same batches, collated beforehand: no loader
    # thread runs beside it
    alone = {}
    for d in dtypes:
        c = mask_rcnn_R_50_FPN_cfg()
        c.TPU.COMPUTE_DTYPE = d
        c.DATASETS.TEST = (name,)
        batches = list(build_test_loader(c, name))
        model = build_model(c, device=DEVICE)
        model.load_state_dict(state)
        model.inference(batches[0])
        seconds = []
        for b in batches:
            t0 = time.perf_counter()
            model.inference(b)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        alone[d] = sum(seconds) / len(seconds)
        del model
    stages = ("data", "model", "paste", "encode", "eval", "total")
    for d in dtypes:
        per_image = {k: sum(r[2][k] for r in stats[d]) / sum(r[2]["images"] for r in stats[d]) for k in stages}
        later = sum(r[2]["model"] - r[2]["model_first"] for r in stats[d]) / sum(r[2]["images"] - 1 for r in stats[d])
        log(f"[score] R50-FPN Mask R-CNN {DTYPE_NAMES[d]}, {SCORE_SCENES} synthetic scenes {SCORE_HW[0]}x{SCORE_HW[1]} "
            f"resized to {c.INPUT.MIN_SIZE_TEST} (max {c.INPUT.MAX_SIZE_TEST}), {SCORE_ROUNDS} runs in turns: "
            "seconds per image " + " ".join(f"{k}={v:.5f}" for k, v in per_image.items())
            + f" | detections={[r[1] for r in stats[d]]} roi_align_fwd_launches={sum(r[4] for r in stats[d])} "
            f"peak_mem_gib={max(r[3] for r in stats[d]):.3f} | model after each run's first image {later:.5f} s/img, "
            f"alone on the collated batches {alone[d]:.5f} s/img | random weights: {format_ap(stats[d][0][0])} "
            "(not checked)")
    return launches


def jtsm_mask_boxes(gen, r, hw):
    """R boxes of log-uniform size from 16 to 600 px inside an image of
    ``hw``, as the JTSM detections are."""
    import torch

    h, w = hw
    size = torch.exp(torch.empty(r, 2, device=DEVICE).uniform_(math.log(16), math.log(600), generator=gen))
    size = torch.minimum(size, torch.tensor([w, h], device=DEVICE, dtype=torch.float32))
    xy = torch.rand(r, 2, generator=gen, device=DEVICE) * (torch.tensor([w, h], device=DEVICE) - size)
    return torch.cat([xy, xy + size], dim=1).contiguous()


def voronoi_superpixels(seed, h, w, n):
    """(h, w) int32 ids of the nearest of ``n`` seeded centres, computed on
    the card in chunks of rows."""
    import numpy as np
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    centres = torch.rand(n, 2, generator=gen, device=DEVICE) * torch.tensor([h, w], device=DEVICE)
    xs = torch.arange(w, device=DEVICE, dtype=torch.float32)
    out = np.empty((h, w), np.int32)
    for y0 in range(0, h, 64):
        ys = torch.arange(y0, min(y0 + 64, h), device=DEVICE, dtype=torch.float32)
        pix = torch.stack(torch.meshgrid(ys, xs, indexing="ij"), -1).reshape(-1, 2)
        out[y0: y0 + len(ys)] = torch.cdist(pix, centres).argmin(1).reshape(len(ys), w).cpu().numpy()
    return out


def jtsm_request(cfg, seed, short=None, max_size=None, canvas=None):
    """One JTSM request at the config's test size (or the short edge
    ``short``, at most ``max_size``): a seeded 375x500 image resized to
    it, padded into its bucket (or ``canvas``); the top
    PRECOMPUTED_PROPOSAL_TOPK_TEST seeded proposals (log-uniform sizes,
    descending objectness, the last JTSM_PADDING slots padding with -inf
    scores); Voronoi superpixels; their membership by centroid
    (``wsl.data.add_wsl_batch_fields``)."""
    import numpy as np

    from jtsm_tpu_torch.data.detection_utils import pick_bucket
    from jtsm_tpu_torch.data.transforms.augmentation import ResizeShortestEdge
    from jtsm_tpu_torch.wsl.data import add_wsl_batch_fields

    rng = np.random.default_rng(seed)
    oh, ow = JTSM_IMAGE_HW
    h, w = ResizeShortestEdge.get_output_shape(
        oh, ow, short or cfg.INPUT.MIN_SIZE_TEST, max_size or cfg.INPUT.MAX_SIZE_TEST
    )
    bh, bw = canvas or pick_bucket(h, w, cfg.TPU.IMAGE_BUCKETS)
    img = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    canvas = np.zeros((1, bh, bw, 3), np.float32)
    canvas[0, :h, :w] = img
    r = cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST
    live = r - JTSM_PADDING
    size = np.minimum(np.exp(rng.uniform(np.log(16), np.log(600), (live, 2))), [w, h])
    xy = rng.uniform(0, 1, (live, 2)) * ([w, h] - size)
    boxes = np.zeros((r, 4), np.float32)
    boxes[:live] = np.concatenate([xy, xy + size], 1)
    scores = np.full(r, -np.inf, np.float32)
    scores[:live] = np.sort(rng.uniform(0, 1, live))[::-1]
    sp = voronoi_superpixels(seed, h, w, JTSM_SUPERPIXELS)
    batch = {
        "image": canvas,
        "image_sizes": np.array([[h, w]], np.int32),
        "orig_sizes": np.array([[oh, ow]], np.int32),
        "proposals": boxes[None],
        "proposal_scores": scores[None],
    }
    add_wsl_batch_fields(batch, [{"image": img, "proposals": {"boxes": boxes, "superpixels": sp}}],
                         cfg.WSL.MAX_SUPERPIXELS)
    return batch


def jtsm_gate_request():
    """Two seeded 128x176 scenes of the gate's size, 64 proposals each (the
    last five of the second padding), the grid superpixels and their
    membership."""
    import numpy as np

    from jtsm_tpu_torch.wsl.data import compute_superpixels_grid, oh_labels_from_boxes

    h, w, r = 128, 176, 64
    rng = np.random.RandomState(0)
    imgs = []
    for _ in range(2):
        img = np.full((h, w, 3), 128.0, np.float32)
        img[: h // 2] = [205, 115, 95]
        img[h // 2:] = [95, 175, 95]
        for _ in range(4):
            y0, x0 = rng.randint(0, h - 40), rng.randint(0, w - 40)
            img[y0: y0 + rng.randint(20, 60), x0: x0 + rng.randint(20, 60)] = rng.randint(55, 255, 3)
        imgs.append(img + rng.randn(h, w, 3).astype(np.float32) * 3)
    xy = rng.rand(2, r, 2) * [w - 30, h - 30]
    boxes = np.concatenate([xy, xy + rng.rand(2, r, 2) * 60 + 10], -1).astype(np.float32)
    scores = rng.rand(2, r).astype(np.float32)
    scores[1, -5:] = -np.inf
    sp = compute_superpixels_grid(h, w)
    return {
        "image": np.stack(imgs),
        "image_sizes": np.array([[h, w], [h - 16, w - 32]], np.int32),
        "orig_sizes": np.array([[2 * h, 2 * w], [h - 16, w - 32]], np.int32),
        "proposals": boxes,
        "proposal_scores": scores,
        "superpixels": np.stack([sp, sp]).astype(np.int32),
        "oh_labels": np.stack([oh_labels_from_boxes(boxes[i], sp, 512) for i in range(2)]),
    }


def jtsm_stages(model, batch, measure):
    """The JTSM request ``batch`` through ``model`` stage by stage;
    ``measure`` makes each call and returns its reading."""
    import torch

    from jtsm_tpu_torch.layers import exact_float32, interpolate_bilinear

    heads = model.roi_heads
    dev = model.device
    r = {}

    def backbone():
        r["feats"], r["sizes"] = model._features(batch)
        r["props"] = torch.as_tensor(batch["proposals"], dtype=torch.float32, device=dev)
        r["scores"] = torch.as_tensor(batch["proposal_scores"], dtype=torch.float32, device=dev)
        r["sp"] = torch.as_tensor(batch["superpixels"], device=dev)
        r["oh"] = torch.as_tensor(batch["oh_labels"], device=dev)

    def moipool():
        feat = r["feats"][heads.in_features[0]].permute(0, 2, 3, 1)
        r["pooled"], r["nonempty"] = heads.pool(feat, r["props"], r["sp"], r["oh"])

    def stuff():
        logits = interpolate_bilinear(model.sem_seg_head(r["feats"]), tuple(batch["image"].shape[1:3]))
        return logits.argmax(dim=1)

    with torch.no_grad(), exact_float32(model.compute_dtype == torch.float32):
        return {
            "backbone": measure(backbone),
            "moipool": measure(moipool),
            "dan_refine": measure(lambda: r.update(branches=heads.refine_branches(
                r["pooled"], r["nonempty"], r["scores"]))),
            "detect_nms": measure(lambda: r.update(det=heads.detect(r["props"], r["scores"], r["branches"], r["sizes"]))),
            "mask": measure(lambda: heads.add_masks(r["det"], r["feats"])),
            "stuff": measure(stuff),
        }


def match_detections(card, host, score_tol):
    """The detections of two runs on the same request matched by their
    (source proposal, class), which names a detection uniquely: scores,
    boxes and mask probabilities are compared pair by pair, and the masks'
    IoU at 0.5 is reported with the largest distance from 0.5 of a pixel
    that lands on the other side of it. Two
    detections whose scores lie within ``score_tol`` may take each other's
    slots, and one within ``score_tol`` of the last kept score may fall on
    either side of the cut; anything else that is on one side only fails."""
    import torch

    out = dict(matched=0, reordered=0, at_cut=0, reorder_gap=0.0, boxes=0.0, scores=0.0, masks=0.0, iou=1.0,
               flip_margin=0.0,
               class_scores=(card["proposal_class_scores"] - host["proposal_class_scores"]).abs().max().item())
    for i in range(host["valid"].shape[0]):
        sides = []
        for run in (card, host):
            keys = zip(run["prop_idx"][i].tolist(), run["classes"][i].tolist(), run["valid"][i].tolist())
            sides.append({(p, c): j for j, (p, c, v) in enumerate(keys) if v})
        (kc, kh), scores = sides, (card["scores"][i], host["scores"][i])
        cut = min(float(scores[1][list(kh.values())].min()), float(scores[0][list(kc.values())].min()))
        for key in set(kc) ^ set(kh):
            run, j = (0, kc[key]) if key in kc else (1, kh[key])
            if float(scores[run][j]) > cut + score_tol:
                raise AssertionError(f"jtsm gate image {i}: detection {key} (score {float(scores[run][j])}) "
                                     f"only on the {'card' if run == 0 else 'CPU'}")
            out["at_cut"] += 1
        for key in set(kc) & set(kh):
            jc, jh = kc[key], kh[key]
            out["matched"] += 1
            if jc != jh:
                out["reordered"] += 1
                out["reorder_gap"] = max(out["reorder_gap"], abs(float(scores[1][jh] - scores[1][jc])))
            out["boxes"] = max(out["boxes"], (card["boxes"][i, jc] - host["boxes"][i, jh]).abs().max().item())
            out["scores"] = max(out["scores"], abs(float(scores[0][jc] - scores[1][jh])))
            pc, ph = card["masks"][i, jc], host["masks"][i, jh]
            out["masks"] = max(out["masks"], (pc - ph).abs().max().item())
            a, b = pc >= 0.5, ph >= 0.5
            union = int((a | b).sum())
            out["iou"] = min(out["iou"], int((a & b).sum()) / union if union else 1.0)
            out["flip_margin"] = max(out["flip_margin"], (ph[a != b] - 0.5).abs().max().item() if (a != b).any() else 0.0)
    if out["reorder_gap"] > score_tol:
        raise AssertionError(f"jtsm gate: detections swapped slots across a score gap of {out['reorder_gap']}")
    return out


def phase_jtsm(kernel, gen, baseline):
    """Phase 10: (a) K1 at the JTSM mask pooler's shape, (b) the JTSM
    flagship served at full width in both dtypes, (c) the gate checkpoint on
    the card against the CPU. Returns K1's rows, its launches on the served
    path and the gate run, the per-dtype latencies and the flagship's
    random weights."""
    import numpy as np
    import torch

    import jtsm_tpu_torch.ops.roi_align as roi_align
    from jtsm_tpu_torch.checkpoint import load_gate_ckpt, random_state_dict, variables_to_state_dict
    from jtsm_tpu_torch.config import jtsm_gate_cfg, jtsm_WSR_18_DC5_cfg
    from jtsm_tpu_torch.engine import Predictor
    from jtsm_tpu_torch.modeling import build_model

    # (a) K1 at the mask pooler's shape: one level, res5 at stride 16 of
    # the 1024x1024 bucket, 100 detections of the 688x917 image
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        feat = torch.randn((1, 64, 64, 512), generator=gen, device=DEVICE).to(dtype)
        boxes = jtsm_mask_boxes(gen, 100, (688, 917))
        zeros = torch.zeros(100, dtype=torch.int32, device=DEVICE)
        tag = f"jtsm mask pooler {'bf16' if dtype == torch.bfloat16 else 'f32'} (L=1)"
        rows[tag] = check_and_time_fwd(tag, [feat], [1.0 / 16], boxes, zeros, zeros, 14, baseline, phase="jtsm")

    # (b) the flagship at full width
    t0 = time.perf_counter()
    flagship = jtsm_WSR_18_DC5_cfg()
    flagship.TEST.AUG.ENABLED = False  # test-time augmentation waits for a later slice
    main_dtype = flagship.TPU.COMPUTE_DTYPE
    dtypes = (main_dtype, "float32")
    flagship_state = random_state_dict(build_model(flagship, device="cpu"), seed=0)
    reqs = [jtsm_request(flagship, seed) for seed in (1, 2)]
    req = reqs[0]
    log(f"[jtsm] flagship {flagship.MODEL.BACKBONE.NAME} R{flagship.MODEL.RESNETS.DEPTH} "
        f"RES5_DILATION={flagship.MODEL.RESNETS.RES5_DILATION}, image {JTSM_IMAGE_HW} -> "
        f"{tuple(req['image_sizes'][0].tolist())} in {req['image'].shape[1:3]}, R={req['proposals'].shape[1]} "
        f"({JTSM_PADDING} padding), superpixels {int(req['superpixels'].max()) + 1} of "
        f"{flagship.WSL.MAX_SUPERPIXELS}, oh_labels {req['oh_labels'].shape} "
        f"({req['oh_labels'].sum(-1).mean():.1f} members a proposal), DAN {list(flagship.MODEL.ROI_BOX_HEAD.DAN_DIM)}, "
        f"{flagship.WSL.REFINE_NUM} refinement branches, mask refinery {flagship.WSL.MASK_REFINE_NUM}; "
        f"weights and requests made in {time.perf_counter() - t0:.1f}s")

    def plain(*a, **k):
        raise AssertionError("the plain ROIAlign ran on the card in the JTSM flagship")

    routed = roi_align.roi_align_multilevel_plain_autograd
    roi_align.roi_align_multilevel_plain_autograd = plain
    try:
        predictors, mem = {}, {}
        for d in dtypes:
            cfg = flagship.clone()
            cfg.TPU.COMPUTE_DTYPE = d
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            predictors[d] = Predictor(cfg, flagship_state)
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            predictors[d](req)  # warm-up
            torch.cuda.synchronize()
            mem[d] = ((resident - before) / 2**30, (torch.cuda.max_memory_allocated() - resident) / 2**30)

        kernel.launches = 0
        lat = {d: [] for d in dtypes}
        valid = {d: [] for d in dtypes}
        launches = dict.fromkeys(dtypes, 0)
        for i in range(JTSM_ROUNDS):
            for d in dtypes if i % 2 == 0 else dtypes[::-1]:
                before = kernel.launches
                t0 = time.perf_counter()
                out = predictors[d](reqs[i % len(reqs)])
                torch.cuda.synchronize()
                lat[d].append((time.perf_counter() - t0) * 1e3)
                n = kernel.launches - before
                launches[d] += n
                if n != 1:
                    raise AssertionError(f"jtsm {d} request {i}: roi_align_fwd launched {n} times, not 1")
                canvas = (1,) + reqs[i % len(reqs)]["image"].shape[1:3]
                for k, shape in (("boxes", (1, 100, 4)), ("masks", (1, 100, 28, 28)), ("sem_seg", canvas)):
                    if tuple(out[k].shape) != shape or not torch.isfinite(out[k].float()).all():
                        raise AssertionError(f"jtsm {d} request {i}: {k} {tuple(out[k].shape)} not finite {shape}")
                boxes = out["boxes"][0][out["valid"][0]]
                if (boxes[:, 2] > JTSM_IMAGE_HW[1]).any() or (boxes[:, 3] > JTSM_IMAGE_HW[0]).any() or (boxes < 0).any():
                    raise AssertionError(f"jtsm {d} request {i}: boxes leave the original image")
                if not bool(out["valid"].any()):
                    raise AssertionError(f"jtsm {d} request {i}: no detection")
                valid[d].append(int(out["valid"].sum()))
        serve_launches = kernel.launches
        for d in dtypes:
            tag = DTYPE_NAMES[d]
            log(f"[jtsm] JTSM WSR-18 DC5 {'x'.join(map(str, req['image_sizes'][0]))} {tag}, {JTSM_ROUNDS} requests in turns: "
                f"latency_ms={[round(x, 3) for x in lat[d]]} mean_ms={sum(lat[d]) / len(lat[d]):.3f} "
                f"median_ms={sorted(lat[d])[len(lat[d]) // 2]:.3f} valid_detections={valid[d]} "
                f"roi_align_fwd_launches={launches[d]} weights_gib={mem[d][0]:.3f} request_peak_gib={mem[d][1]:.3f}")

        def timed(call):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        stage_ms = {d: {} for d in dtypes}
        for i in range(STAGE_ROUNDS):
            for d in dtypes if i % 2 == 0 else dtypes[::-1]:
                for k, ms in jtsm_stages(predictors[d].model, req, timed).items():
                    stage_ms[d].setdefault(k, []).append(ms)
        for d in dtypes:
            syncs = jtsm_stages(predictors[d].model, req, count_host_syncs)
            log(f"[jtsm] {DTYPE_NAMES[d]} stages_ms (median of {STAGE_ROUNDS}) "
                + " ".join(f"{k}={sorted(v)[len(v) // 2]:.3f}" for k, v in stage_ms[d].items())
                + " | host syncs " + " ".join(f"{k}={n}" for k, n in syncs.items()))
        del predictors
    finally:
        roi_align.roi_align_multilevel_plain_autograd = routed

    # (c) the gate checkpoint on the card against the CPU
    cfg = jtsm_gate_cfg()
    state = variables_to_state_dict(load_gate_ckpt(os.path.join(REPO, cfg.MODEL.WEIGHTS)))
    batch = jtsm_gate_request()
    before = kernel.launches
    card = {k: v.cpu() for k, v in Predictor(cfg, state)(batch).items()}
    gate_launches = kernel.launches - before
    if gate_launches != 1:
        raise AssertionError(f"jtsm gate on the card: roi_align_fwd launched {gate_launches} times, not 1")
    host = Predictor(cfg, state, device="cpu")(batch)
    if not bool(host["valid"].any()):
        raise AssertionError("jtsm gate: no detection")
    m = match_detections(card, host, score_tol=1e-4)
    sem_agree = (card["sem_seg"] == host["sem_seg"]).float().mean().item()
    log(f"[jtsm] gate checkpoint (float32), 2 images 128x176, 64 proposals: valid_detections="
        f"{host['valid'].sum(1).tolist()}, card vs CPU: proposal class scores max_abs_err={m['class_scores']:.3e}; "
        f"detections matched by (source proposal, class): {m['matched']} matched, {m['reordered']} in another "
        f"slot (scores within {m['reorder_gap']:.3e} of a neighbour), {m['at_cut']} only on one side at the "
        f"100-detection cut; boxes max_abs_err={m['boxes']:.3e} px (tol 1e-3), scores {m['scores']:.3e} "
        f"(tol 1e-4), classes and prop_idx equal by construction, mask probabilities {m['masks']:.3e} (tol 1e-4), "
        f"min mask IoU at 0.5 {m['iou']:.6f} (pixels across 0.5 lie within {m['flip_margin']:.3e} of it, tol 1e-4), "
        f"sem_seg pixels equal {sem_agree:.6f}, roi_align_fwd_launches={gate_launches}")
    if not (m["boxes"] <= 1e-3 and m["scores"] <= 1e-4 and m["masks"] <= 1e-4 and m["flip_margin"] <= 1e-4):
        raise AssertionError(f"jtsm gate: the card disagrees with the CPU: {m}")
    return rows, serve_launches + gate_launches, {d: sum(x) / len(x) for d, x in lat.items()}, flagship_state


def jtsm_train_batch(cfg, seeds, short, max_size, canvas=None):
    """``jtsm_request`` for each seed at the short edge ``short``, stacked,
    with seeded image labels collated by ``wsl.data.add_wsl_train_fields``:
    1 to 3 of the thing classes, and the stuff map of VOC's panoptic
    labels, class 1 (background) over each image."""
    import numpy as np

    from jtsm_tpu_torch.wsl.data import add_wsl_train_fields

    reqs = [jtsm_request(cfg, seed, short, max_size, canvas) for seed in seeds]
    batch = {k: np.concatenate([r[k] for r in reqs]) for k in reqs[0]}
    rng = np.random.default_rng(seeds[0])
    per_image = [{"gt_classes": rng.choice(cfg.MODEL.ROI_HEADS.NUM_CLASSES, rng.integers(1, 4), replace=False),
                  "sem_seg": np.ones(tuple(r["image_sizes"][0]), np.int32)} for r in reqs]
    add_wsl_train_fields(batch, per_image, cfg.TPU.MAX_GT_INSTANCES)
    return batch


def jtsm_train_stages(model, optimizer, schedule, state, batch, measure, upto="sgd"):
    """One train step of ``batch`` through ``model`` stage by stage, as
    ``GeneralizedMCNNWSL.forward`` and ``engine.make_train_step`` run it,
    up to the stage ``upto``; ``measure`` makes each call and returns its
    reading. Returns the readings and the stages' outputs."""
    import torch

    from jtsm_tpu_torch.engine.train_loop import sgd_update
    from jtsm_tpu_torch.layers import exact_float32

    heads = model.roi_heads
    r = {}

    def backbone():
        r["feats"], _ = model._features(batch)
        r["props"], r["scores"], r["sp"], r["oh"] = model.request_fields(batch)
        r["targets"] = {k: torch.as_tensor(batch[k], device=model.device)
                        for k in ("gt_classes", "gt_valid", "gt_sem_seg") if k in batch}

    def moipool():
        feat = r["feats"][heads.in_features[0]].permute(0, 2, 3, 1)
        r["pooled"], r["nonempty"] = heads.pool(feat, r["props"], r["sp"], r["oh"])

    def dan_branches():
        r["mil"], r["branches"] = heads.train_outputs(r["pooled"], r["nonempty"], r["scores"], state.generator)

    def mining():
        r["losses"], r["aux"], r["mined"] = heads.mine(
            r["props"], r["scores"], r["mil"], r["branches"], r["targets"], r["sp"], r["oh"])

    def mask():
        r["losses"].update(heads.mask_losses(r["feats"], r["mined"]))
        if "pgt_sem_seg" in r["aux"]:
            r["losses"].update(model.sem_seg_head.losses(
                model.sem_seg_head(r["feats"]), r["aux"]["pgt_sem_seg"], r["aux"]["pgt_sem_seg_stride"]))

    def backward():
        optimizer.zero_grad(set_to_none=True)
        sum(r["losses"].values()).backward()

    def sgd():
        sgd_update(optimizer, schedule(state.step))
        state.step += 1

    stages = {"backbone": backbone, "moipool": moipool, "dan_branches": dan_branches, "mining": mining,
              "mask": mask, "backward": backward, "sgd": sgd}
    readings = {}
    with exact_float32(model.compute_dtype == torch.float32):
        for k, fn in stages.items():
            readings[k] = measure(fn)
            if k == upto:
                break
    return readings, r


def gate_train_state(model, seed):
    """Seeded weights for the gate (``random_state_dict``) with the heads'
    spread of ``tests/test_torch_jtsm.py``: the DAN's first layer and the
    box deltas at 0.05 of the usual scale and the predictors at 0.1, so
    that the WSDDN scores do not tie."""
    from jtsm_tpu_torch.checkpoint import random_state_dict

    state = random_state_dict(model, seed)
    gains = {"dan1.weight": 0.05, "refine_reg.weight": 0.05, "predictor.weight": 0.1}
    for key in state:
        for name, gain in gains.items():
            if key.endswith(name):
                state[key] = state[key] * gain
    return state


def phase_jtsm_train(kernels, gen, baseline, flagship_state):
    """Phase 11: (a) K1 and K2 at the JTSM train step's mask pooler shape,
    (b) the flagship's train step at full width in both dtypes, (c) the
    gate config's steps on the card against the CPU. Returns the kernel
    rows, each kernel's launches in (b) and (c), and the median step
    times."""
    import numpy as np
    import torch

    import jtsm_tpu_torch.ops.roi_align as roi_align
    from jtsm_tpu_torch.config import jtsm_gate_cfg, jtsm_WSR_18_DC5_cfg
    from jtsm_tpu_torch.engine import create_train_state, make_train_step
    from jtsm_tpu_torch.modeling import build_model
    from jtsm_tpu_torch.solver import build_lr_schedule, build_optimizer

    k1, k2 = kernels
    # (a) the mask pooler of a flagship step: res5 of four images in the
    # 1024x1024 bucket, 64 mined ROIs an image
    rows = {}
    b, r = 4, 256
    boxes = jtsm_mask_boxes(gen, r, (688, 917))
    bidx = torch.arange(b, dtype=torch.int32, device=DEVICE).repeat_interleave(r // b)
    zeros = torch.zeros(r, dtype=torch.int32, device=DEVICE)
    for dtype in (torch.float32, torch.bfloat16):
        feat = torch.randn((b, 64, 64, 512), generator=gen, device=DEVICE).to(dtype)
        tag = f"jtsm train mask pooler {dtype_tag(feat)} B={b} (L=1)"
        rows[f"fwd {dtype_tag(feat)}"] = check_and_time_fwd(
            tag, [feat], [1.0 / 16], boxes, bidx, zeros, 14, baseline, phase="jtsm_train")
        rows[f"bwd {dtype_tag(feat)}"] = check_and_time_bwd(
            tag, [feat], [1.0 / 16], boxes, bidx, zeros, 14, gen, baseline, phase="jtsm_train")
    del feat

    # (b) the flagship's train step at full width, both dtypes in turns
    t0 = time.perf_counter()
    flagship = jtsm_WSR_18_DC5_cfg()
    dtypes = (flagship.TPU.COMPUTE_DTYPE, "float32")
    seeds = tuple(range(21, 21 + flagship.SOLVER.IMS_PER_BATCH))
    batch = jtsm_train_batch(flagship, seeds, JTSM_TRAIN_SHORT, flagship.INPUT.MAX_SIZE_TRAIN)
    log(f"[jtsm_train] flagship FREEZE_AT={flagship.MODEL.BACKBONE.FREEZE_AT}, IMS_PER_BATCH="
        f"{flagship.SOLVER.IMS_PER_BATCH}: images {batch['image_sizes'].tolist()} in {batch['image'].shape[1:3]}, "
        f"R={batch['proposals'].shape[1]} ({JTSM_PADDING} padding), superpixels {JTSM_SUPERPIXELS}, image labels "
        f"{[np.flatnonzero(v).size for v in batch['gt_valid']]} classes, DAN {list(flagship.MODEL.ROI_BOX_HEAD.DAN_DIM)}, "
        f"clip {flagship.SOLVER.CLIP_GRADIENTS.ENABLED}; batch made in {time.perf_counter() - t0:.1f}s")

    def plain(*a, **k):
        raise AssertionError("the plain ROIAlign ran on the card in the JTSM train step")

    routed = roi_align.roi_align_multilevel_plain_autograd
    roi_align.roi_align_multilevel_plain_autograd = plain
    torch.backends.cudnn.deterministic = False  # cuDNN's own algorithm choice, as a user trains
    try:
        runs = {}
        for d in dtypes:
            cfg = flagship.clone()
            cfg.TPU.COMPUTE_DTYPE = d
            model = build_model(cfg)
            model.load_state_dict(flagship_state)
            optimizer = build_optimizer(cfg, model)
            schedule = build_lr_schedule(cfg)
            runs[d] = (model, optimizer, schedule, create_train_state(model, optimizer, seed=0),
                       make_train_step(model, optimizer, schedule))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = {d: [] for d in dtypes}
        for k in kernels:
            k.launches = 0
        for i in range(JTSM_TRAIN_STEPS):
            for d in dtypes if i % 2 == 0 else dtypes[::-1]:
                model, _, _, state, train_step = runs[d]
                before = [k.launches for k in kernels]
                t0 = time.perf_counter()
                metrics = train_step(state, batch)
                torch.cuda.synchronize()
                times[d].append((time.perf_counter() - t0) * 1e3)
                values = {k: v.item() for k, v in metrics.items()}
                if sorted(values) != JTSM_FLAGSHIP_LOSSES or not all(math.isfinite(v) for v in values.values()):
                    raise AssertionError(f"jtsm train {d} step {i}: losses {values}")
                per_step = [k.launches - n for k, n in zip(kernels, before)]
                if per_step != [1, 0]:
                    raise AssertionError(f"jtsm train {d} step {i}: launches {per_step}, not K1 once and K2 never")
                log(f"[jtsm_train] {DTYPE_NAMES[d]} step {i}: ms={times[d][-1]:.3f} "
                    + " ".join(f"{k}={v:.6g}" for k, v in values.items()))
        peak = torch.cuda.max_memory_allocated() / 2**30
        train_launches = {k.name: k.launches for k in kernels}
        med = {d: sorted(t[1:])[len(t[1:]) // 2] for d, t in times.items()}
        for d in dtypes:
            log(f"[jtsm_train] JTSM WSR-18 DC5, {len(seeds)} images {JTSM_TRAIN_SHORT} short side per step, "
                f"{DTYPE_NAMES[d]}{' (TF32 off)' if d == 'float32' else ''}: step_ms={[round(t, 3) for t in times[d]]} "
                f"median_of_steps_2_to_{JTSM_TRAIN_STEPS}_ms={med[d]:.3f}")
        log(f"[jtsm_train] launches over {2 * JTSM_TRAIN_STEPS} steps {train_launches}; peak_mem_gib={peak:.3f} "
            "(both dtypes' models, gradients and momentum resident)")

        def timed(call):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        for d in dtypes:
            model, optimizer, schedule, state, _ = runs[d]
            stage_ms = jtsm_train_stages(model, optimizer, schedule, state, batch, timed)[0]
            syncs = jtsm_train_stages(model, optimizer, schedule, state, batch, count_host_syncs)[0]
            log(f"[jtsm_train] {DTYPE_NAMES[d]} stages_ms " + " ".join(f"{k}={v:.3f}" for k, v in stage_ms.items())
                + f" sum={sum(stage_ms.values()):.3f} | host syncs " + " ".join(f"{k}={n}" for k, n in syncs.items()))
        del runs, model, optimizer, state

        # one step at the largest train scale, for its peak memory
        short, canvas = JTSM_TRAIN_LARGEST
        big = jtsm_train_batch(flagship, seeds, short, flagship.INPUT.MAX_SIZE_TRAIN, canvas)
        model = build_model(flagship)
        model.load_state_dict(flagship_state)
        optimizer = build_optimizer(flagship, model)
        state = create_train_state(model, optimizer, seed=0)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        values = {k: v.item() for k, v in make_train_step(model, optimizer, build_lr_schedule(flagship))(state, big).items()}
        torch.cuda.synchronize()
        big_ms = (time.perf_counter() - t0) * 1e3
        big_peak = torch.cuda.max_memory_allocated() / 2**30
        if not all(math.isfinite(v) for v in values.values()):
            raise AssertionError(f"jtsm train at short side {short}: losses {values}")
        log(f"[jtsm_train] {DTYPE_NAMES[dtypes[0]]} one step at short side {short}: images "
            f"{big['image_sizes'].tolist()} in {canvas}, ms={big_ms:.3f} (first step of a new model) "
            f"peak_mem_gib={big_peak:.3f} (of which {base / 2**30:.3f} before the step: weights)")
        train_launches = {k.name: k.launches for k in kernels}
        del model, optimizer, state
    finally:
        roi_align.roi_align_multilevel_plain_autograd = routed

    # (c) the gate config on the card against the CPU
    cfg = jtsm_gate_cfg()
    if cfg.SOLVER.CLIP_GRADIENTS.CLIP_TYPE != "full_model" or cfg.MODEL.BACKBONE.FREEZE_AT != 0:
        raise AssertionError("the JTSM gate config is not the full-model clip over a trained backbone")
    weights = gate_train_state(build_model(cfg, device="cpu"), seed=1)
    batch = jtsm_gate_request()
    rng = np.random.RandomState(19)
    batch["gt_classes"] = rng.randint(0, 80, (2, 4)).astype(np.int32)
    batch["gt_valid"] = np.array([[1, 1, 1, 0], [1, 1, 0, 0]], bool)
    batch["gt_boxes"] = np.zeros((2, 4, 4), np.float32)
    batch["gt_sem_seg"] = rng.randint(0, 54, (2, 128, 176)).astype(np.int32)
    torch.backends.cudnn.deterministic = True
    gate = {}
    for name, device in (("card", DEVICE), ("cpu", "cpu")):
        model = build_model(cfg, device=device)
        model.load_state_dict(weights)
        model.roi_heads.dan.dropout = 0.0  # the two devices' generators draw other bits
        optimizer = build_optimizer(cfg, model)
        state = create_train_state(model, optimizer, seed=0)
        with torch.no_grad():
            _, r = jtsm_train_stages(model, optimizer, None, state, batch, lambda fn: fn(), upto="mining")
        mined = {k: v.cpu() for k, v in r["mined"].items()}
        mined["pgt_sem_seg"] = r["aux"]["pgt_sem_seg"].cpu()
        before = [k.launches for k in kernels]
        train_step = make_train_step(model, optimizer, build_lr_schedule(cfg))
        losses = []
        for i in range(JTSM_GATE_STEPS):
            losses.append({k: v.item() for k, v in train_step(state, batch).items()})
            if device != "cpu" and [k.launches - n for k, n in zip(kernels, before)] != [i + 1, i + 1]:
                raise AssertionError(f"jtsm gate step {i} on the card: K1 and K2 did not launch once a step")
        launches = [k.launches - n for k, n in zip(kernels, before)]
        gate[name] = (mined, losses, {n: p.detach().cpu() for n, p in model.named_parameters()}, launches)
        del model, optimizer, state, r
    (m_card, l_card, p_card, gate_launches), (m_cpu, l_cpu, p_cpu, _) = gate["card"], gate["cpu"]
    unequal = [k for k in m_cpu if not torch.equal(m_card[k], m_cpu[k])]
    loss_err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for a, b in zip(l_card, l_cpu) for k in b)
    param_err = max(((p_card[n] - p_cpu[n]).abs().max() / p_cpu[n].abs().max().clamp(min=1e-12)).item() for n in p_cpu)
    finite = all(math.isfinite(v) for step in l_card for v in step.values())
    log(f"[jtsm_train] gate config (float32, FREEZE_AT 0, full-model clip {cfg.SOLVER.CLIP_GRADIENTS.CLIP_VALUE}), "
        f"2 images 128x176, {JTSM_GATE_STEPS} steps on the card and on the CPU: mined mask ROIs "
        f"{int(m_cpu['ok'].sum())} of {m_cpu['ok'].numel()}, mined fields equal: {not unequal} {unequal or ''}; "
        f"losses {len(l_cpu[0])} keys, max_rel_err={loss_err:.3e} (tol 1e-4), loss_mil by step card "
        f"{[round(x['loss_mil'], 6) for x in l_card]} cpu {[round(x['loss_mil'], 6) for x in l_cpu]}; parameters "
        f"after {JTSM_GATE_STEPS} steps max_err={param_err:.3e} of each one's scale (tol 1e-5) over {len(p_cpu)}; "
        f"launches on the card K1/K2 {gate_launches}")
    if unequal or not finite or not loss_err <= 1e-4 or not param_err <= 1e-5:
        raise AssertionError("jtsm gate: the card's train steps disagree with the CPU's")
    launches = {k.name: train_launches[k.name] + n for k, n in zip(kernels, gate_launches)}
    return rows, launches, med


def jtsm_score_once(cfg, state_dict, device, kernel):
    """``engine.defaults.test`` of the WSL config ``cfg`` on ``device``
    through the WSL test loader, with the COCO, SemSeg and panoptic
    evaluators (writing nothing) and panoptic fusion, K1's count set to 0
    just before and read just after: returns the results, each batch's
    fused outputs on the host, K1's launches, the seconds of each stage and
    the peak device memory of the run (GiB above what was allocated
    before)."""
    import torch

    from jtsm_tpu_torch.engine import test
    from jtsm_tpu_torch.evaluation import (COCOEvaluator, COCOPanopticEvaluator, DatasetEvaluator,
                                           DatasetEvaluators, SemSegEvaluator)
    from jtsm_tpu_torch.modeling import build_model
    from jtsm_tpu_torch.wsl.train_net import build_test_loader

    class Captured(DatasetEvaluator):
        def __init__(self):
            self.batches = []

        def process(self, inputs, outputs):
            out = {k: v.cpu() if torch.is_tensor(v) else v for k, v in outputs.items()}
            self.batches.append(dict(out, image_sizes=inputs["image_sizes"]))

    model = build_model(cfg, device=device)
    model.load_state_dict(state_dict)
    name = cfg.DATASETS.TEST[0]
    timings, captured = {}, Captured()
    evaluator = DatasetEvaluators([COCOEvaluator(name, timings=timings), SemSegEvaluator(name, timings=timings),
                                   COCOPanopticEvaluator(name, timings=timings), captured])
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    kernel.launches = 0
    t0 = time.perf_counter()
    results = test(cfg, model, evaluators=[evaluator], timings=timings, build_test_loader=build_test_loader)
    timings["total"] = time.perf_counter() - t0
    launches = kernel.launches
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30 if on_card else float("nan")
    return results, captured.batches, launches, timings, peak


JTSM_TASK_METRICS = (("bbox", "AP"), ("segm", "AP"), ("sem_seg", "mIoU"), ("panoptic_seg", "PQ"))


def format_jtsm(results):
    return " ".join(f"{t}_{m}={results[t][m]:.4f}" for t, m in JTSM_TASK_METRICS)


def sem_seg_near_ties(logits, image_size, orig_size, pixels):
    """The gap between the two largest of the upsampled stuff logits (the
    fusion's float64 resize) at each of ``pixels`` (an (N, 2) index)."""
    import torch

    from jtsm_tpu_torch.modeling.meta_arch.panoptic_fpn import bilinear_resize

    (h, w), (h0, w0) = image_size, orig_size
    up = bilinear_resize(logits[:h, :w].float(), h0, w0)[pixels[:, 0], pixels[:, 1]]
    top2 = torch.topk(up, 2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]).abs()


def voc_scenes(num, seed, r):
    """``num`` seeded VOC-shaped scenes of JTSM_IMAGE_HW: a noisy background
    (the stuff class "background") with 1-3 rectangles of VOC things in
    their palette colours; the instance json, the pixels, the stuff and
    panoptic maps and the panoptic json in the separated format, and the
    MCG-style proposal dict (``r`` log-uniform boxes with descending
    objectness, JTSM_SUPERPIXELS Voronoi superpixels, membership by
    centroid)."""
    import numpy as np

    from jtsm_tpu_torch.wsl.builtin import VOC_CATEGORIES
    from jtsm_tpu_torch.wsl.data import oh_labels_from_boxes

    rng = np.random.default_rng(seed)
    h, w = JTSM_IMAGE_HW
    things = [c for c in VOC_CATEGORIES if c["isthing"]]
    infos, anns, pan_anns = [], [], []
    images, sem_maps, pan_maps = {}, {}, {}
    props = {"ids": [], "boxes": [], "objectness_logits": [], "superpixels": [], "oh_labels": [], "bbox_mode": 0}
    for i in range(num):
        infos.append({"id": i, "file_name": f"{i:06d}.jpg", "height": h, "width": w})
        img = np.empty((h, w, 3), np.uint8)
        img[:] = rng.integers(60, 200, 3)
        ids = np.ones((h, w), np.uint32)
        segments = [{"id": 1, "category_id": 21, "iscrowd": 0}]
        for k in range(int(rng.integers(1, 4))):
            bw, bh = rng.uniform(40, w / 2), rng.uniform(40, h / 2)
            x, y = rng.uniform(0, w - bw - 1), rng.uniform(0, h - bh - 1)
            cat = int(rng.integers(1, 21))
            anns.append({"id": len(anns) + 1, "image_id": i, "category_id": cat, "bbox": [x, y, bw, bh],
                         "area": bw * bh, "iscrowd": 0,
                         "segmentation": [[x, y, x + bw, y, x + bw, y + bh, x, y + bh]]})
            xi, yi, bwi, bhi = (int(round(v)) for v in (x, y, bw, bh))
            img[yi: yi + bhi, xi: xi + bwi] = things[cat - 1]["color"]
            ids[yi: yi + bhi, xi: xi + bwi] = k + 2
            segments.append({"id": k + 2, "category_id": cat, "iscrowd": 0})
        images[i] = np.clip(img.astype(np.int16) + rng.integers(-12, 13, (h, w, 3)), 0, 255).astype(np.uint8)
        areas = np.bincount(ids.reshape(-1), minlength=len(segments) + 1)
        pan_anns.append({"image_id": i, "file_name": f"{i:06d}.png", "segments_info": [
            dict(s, area=int(areas[s["id"]])) for s in segments if areas[s["id"]] > 0]})
        pan_maps[i], sem_maps[i] = ids, (ids == 1).astype(np.uint8)
        size = np.minimum(np.exp(rng.uniform(np.log(16), np.log(400), (r, 2))), [w - 1, h - 1])
        xy = rng.uniform(0, 1, (r, 2)) * ([w - 1, h - 1] - size)
        boxes = np.concatenate([xy, xy + size], 1).astype(np.float32)
        sp = voronoi_superpixels(seed + i, h, w, JTSM_SUPERPIXELS)
        props["ids"].append(i)
        props["boxes"].append(boxes)
        props["objectness_logits"].append(np.sort(rng.uniform(0, 1, r))[::-1].astype(np.float32))
        props["superpixels"].append(sp)
        props["oh_labels"].append(oh_labels_from_boxes(boxes, sp, JTSM_SUPERPIXELS))
    coco = {"images": infos, "annotations": anns,
            "categories": [{"id": c["id"], "name": c["name"]} for c in things]}
    pan_json = {"images": infos, "annotations": pan_anns,
                "categories": [{"id": c["id"], "name": c["name"], "isthing": c["isthing"]} for c in VOC_CATEGORIES]}
    return coco, images, sem_maps, pan_maps, pan_json, props


def phase_jtsm_score(kernel, flagship_state):
    """Phase 12: (a) the JTSM gate checkpoint scores the 12 in-memory
    cocovar scenes on the card and on the CPU; (b) the JTSM flagship scores
    seeded VOC scenes at full width by stage. Returns K1's launches."""
    import numpy as np
    import torch

    import jtsm_tpu_torch.ops.roi_align as roi_align
    from jtsm_tpu_torch.checkpoint import load_gate_ckpt, variables_to_state_dict
    from jtsm_tpu_torch.config import jtsm_gate_cfg, jtsm_WSR_18_DC5_cfg
    from jtsm_tpu_torch.data.datasets.synthetic import register_synthetic_cocovar, register_synthetic_panoptic
    from jtsm_tpu_torch.wsl.builtin import _voc_sbd_panoptic_separated_meta

    routed = roi_align.roi_align_multilevel_plain_autograd

    def plain_on_cpu_only(features, scales, boxes, *a, **k):
        if boxes.device.type != "cpu":
            raise AssertionError("the plain ROIAlign ran on the card in JTSM scoring")
        return routed(features, scales, boxes, *a, **k)

    roi_align.roi_align_multilevel_plain_autograd = plain_on_cpu_only
    try:
        # (a) the gate: the card against the CPU, float32
        name = "chip_smoke_jtsm_gate"
        cfg = jtsm_gate_cfg()
        cfg.DATASETS.TEST = (name,)
        cfg.DATASETS.PROPOSAL_FILES_TEST = (register_synthetic_cocovar(name, num=GATE_VAR_SCENES),)
        state = variables_to_state_dict(load_gate_ckpt(os.path.join(REPO, cfg.MODEL.WEIGHTS)))
        runs = {k: jtsm_score_once(cfg, state, dev, kernel) for k, dev in (("card", DEVICE), ("cpu", "cpu"))}
        (res_card, out_card, launches, _, _), (res_cpu, out_cpu, _, t_cpu, _) = runs["card"], runs["cpu"]
        if launches != GATE_VAR_SCENES:
            raise AssertionError(f"jtsm gate scoring on the card: roi_align_fwd launched {launches} times for "
                                 f"{GATE_VAR_SCENES} images, not once each")
        m = {"matched": 0, "reordered": 0, "at_cut": 0, "boxes": 0.0, "scores": 0.0, "masks": 0.0, "flip": 0.0}
        sem_pixels, sem_differ, sem_gap = 0, 0, 0.0
        for bc, bh in zip(out_card, out_cpu):
            one = match_detections(bc, bh, score_tol=1e-4)
            for k in ("matched", "reordered", "at_cut"):
                m[k] += one[k]
            for k, src in (("boxes", "boxes"), ("scores", "scores"), ("masks", "masks"), ("flip", "flip_margin")):
                m[k] = max(m[k], one[src])
            for i, (sc, sh) in enumerate(zip(bc["sem_seg"], bh["sem_seg"])):
                sem_pixels += sh.size
                diff = np.argwhere(sc != sh)
                if len(diff):
                    sem_differ += len(diff)
                    gaps = sem_seg_near_ties(bh["sem_seg_logits"][i], bh["image_sizes"][i], sh.shape,
                                             torch.as_tensor(diff))
                    sem_gap = max(sem_gap, gaps.max().item())
        task_diff = {t: abs(res_card[t][k] - res_cpu[t][k]) for t, k in JTSM_TASK_METRICS}
        log(f"[jtsm_score] gate checkpoint (float32) on the {GATE_VAR_SCENES} in-memory cocovar scenes: card "
            f"{format_jtsm(res_card)} | cpu {format_jtsm(res_cpu)} (cpu {t_cpu['total']:.1f}s) | detections matched "
            f"by (source proposal, class): {m['matched']}, {m['reordered']} in another slot, {m['at_cut']} at the "
            f"cut; boxes max_abs_err={m['boxes']:.3e} px (tol 1e-3), scores {m['scores']:.3e} (tol 1e-4), mask "
            f"probabilities {m['masks']:.3e} (tol 1e-4, pixels across 0.5 within {m['flip']:.3e} of it) | sem_seg "
            f"maps: {sem_differ} of {sem_pixels} pixels differ, their two largest logits within {sem_gap:.3e} "
            f"(tol 1e-4) | task diffs " + " ".join(f"{t}={d:.4f}" for t, d in task_diff.items())
            + f" (tol 0.02) | roi_align_fwd_launches={launches}")
        if not (m["boxes"] <= 1e-3 and m["scores"] <= 1e-4 and m["masks"] <= 1e-4 and m["flip"] <= 1e-4):
            raise AssertionError(f"jtsm gate scoring: the card's detections disagree with the CPU's: {m}")
        if sem_differ and not sem_gap <= 1e-4:
            raise AssertionError(f"jtsm gate scoring: sem_seg maps differ where the logits are {sem_gap} apart")
        if not max(task_diff.values()) <= 0.02:
            raise AssertionError(f"jtsm gate scoring: the card's numbers differ from the CPU's by {task_diff}")
        total = launches

        # (b) the flagship at full width: VOC scenes, bf16 and f32 in turns
        name = "chip_smoke_jtsm_voc"
        t0 = time.perf_counter()
        base = jtsm_WSR_18_DC5_cfg()
        coco, images, sem_maps, pan_maps, pan_json, props = voc_scenes(
            JTSM_SCORE_SCENES, 3, base.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST)
        register_synthetic_panoptic(name, coco, images, sem_maps, pan_maps, pan_json,
                                    _voc_sbd_panoptic_separated_meta())
        log(f"[jtsm_score] {JTSM_SCORE_SCENES} seeded VOC scenes {JTSM_IMAGE_HW}, {len(coco['annotations'])} things, "
            f"{props['boxes'][0].shape[0]} proposals and {JTSM_SUPERPIXELS} superpixels each, made in "
            f"{time.perf_counter() - t0:.1f}s")
        dtypes = (base.TPU.COMPUTE_DTYPE, "float32")
        stats = {d: [] for d in dtypes}
        for i in range(JTSM_SCORE_ROUNDS):
            for d in dtypes if i % 2 == 0 else dtypes[::-1]:
                c = base.clone()
                c.TEST.AUG.ENABLED = False  # test-time augmentation waits for a later slice
                c.TPU.COMPUTE_DTYPE = d
                c.DATASETS.TEST = (name,)
                c.DATASETS.PROPOSAL_FILES_TEST = (props,)
                results, outs, n, timings, peak = jtsm_score_once(c, flagship_state, DEVICE, kernel)
                total += n
                if n != JTSM_SCORE_SCENES:
                    raise AssertionError(f"jtsm flagship scoring {d}: roi_align_fwd launched {n} times for "
                                         f"{JTSM_SCORE_SCENES} images, not once each")
                missing = [(t, k) for t, k in JTSM_TASK_METRICS if t not in results or k not in results[t]]
                shapes = {out["panoptic_seg"][j][0].shape for out in outs for j in range(len(out["panoptic_seg"]))}
                if missing or shapes != {JTSM_IMAGE_HW}:
                    raise AssertionError(f"jtsm flagship scoring {d}: missing {missing}, panoptic maps {shapes}")
                stats[d].append((results, timings, peak, n))
        stages = ("data", "model", "fusion", "paste", "encode", "eval", "eval_sem_seg", "eval_panoptic_seg", "total")
        for d in dtypes:
            per_image = {k: sum(r[1].get(k, 0.0) for r in stats[d]) / sum(r[1]["images"] for r in stats[d])
                         for k in stages}
            log(f"[jtsm_score] JTSM WSR-18 DC5 {DTYPE_NAMES[d]}, {JTSM_SCORE_SCENES} VOC scenes "
                f"{JTSM_IMAGE_HW[0]}x{JTSM_IMAGE_HW[1]} at {base.INPUT.MIN_SIZE_TEST}, {JTSM_SCORE_ROUNDS} runs in "
                "turns: seconds per image " + " ".join(f"{k}={v:.5f}" for k, v in per_image.items())
                + f" (eval = COCOEval) | roi_align_fwd_launches={sum(r[3] for r in stats[d])} "
                f"peak_mem_gib={max(r[2] for r in stats[d]):.3f} | random weights: {format_jtsm(stats[d][0][0])} "
                "(not checked)")
    finally:
        roi_align.roi_align_multilevel_plain_autograd = routed
    return total


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

    # 9. score: the gate on the card against the CPU; the flagship by stage
    t0 = time.perf_counter()
    score_launches = phase_score(KERNEL, state)
    log(f"[score] done in {time.perf_counter() - t0:.1f}s")

    # 10. the JTSM flagship: K1 at its mask pooler's shape, serving, the gate
    t0 = time.perf_counter()
    jtsm_rows, jtsm_launches, jtsm_lat, jtsm_state = phase_jtsm(KERNEL, gen, baseline)
    log(f"[jtsm] done in {time.perf_counter() - t0:.1f}s")

    # 11. JTSM training: K1 and K2 at its mask pooler's shape, the flagship's
    # step in both dtypes, the gate's steps on the card against the CPU
    t0 = time.perf_counter()
    jt_rows, jt_launches, jt_med = phase_jtsm_train(KERNELS, gen, baseline, jtsm_state)
    log(f"[jtsm_train] done in {time.perf_counter() - t0:.1f}s")

    # 12. JTSM scoring: the gate on the card against the CPU; the flagship by stage
    t0 = time.perf_counter()
    js_launches = phase_jtsm_score(KERNEL, jtsm_state)
    log(f"[jtsm_score] done in {time.perf_counter() - t0:.1f}s")

    # per served request K1 pools boxes (R=1000, P=7) and masks (R=100,
    # P=14); per train step K1 and K2 pool and unpool boxes (R=1024, P=7)
    # and masks (R=256, P=14); per JTSM request K1 pools masks on one level
    # (R=100, P=14, C=512); per JTSM train step K1 pools masks on one level
    # (B=4, R=256, P=14, C=512), and K2 unpools them where the maps train
    # (the gate); per JTSM scored image K1 pools masks on one level (R=100,
    # P=14, C=512). Times as kernel_line says; launches: the main paths,
    # serve, train, score, JTSM, JTSM train and JTSM score, in both dtypes.
    k1_launches = (sum(launches.values()) + sum(t[0][KERNEL.name] for t in train.values()) + score_launches
                   + jtsm_launches + jt_launches[KERNEL.name] + js_launches)
    k2_launches = sum(t[0][BWD_KERNEL.name] for t in train.values()) + jt_launches[BWD_KERNEL.name]
    bwd = {k[4:]: v for k, v in tres.items() if k.startswith("bwd ")}
    kernels = [
        kernel_line(KERNEL, k1_launches, res, [r["err"] for n, r in res.items() if "f32" in n]),
        kernel_line(BWD_KERNEL, k2_launches, bwd, [r["err"] for n, r in bwd.items() if "f32" in n]),
    ]
    # the single-level row (K1b's shape): the JTSM mask pooler
    l1, l1_bf16 = jtsm_rows["jtsm mask pooler f32 (L=1)"], jtsm_rows["jtsm mask pooler bf16 (L=1)"]
    kernels[0].update({
        "l1_launches": jtsm_launches,
        "l1_max_abs_err": l1["err"],
        "l1_ms": l1["times"]["new"]["ms"],
        "l1_device_ms": l1["times"]["new"]["device_ms"],
        "l1_plain_ms": l1["plain_ms"],
        "l1_bound_ms": l1["bound_ms"],
        "l1_bf16_max_abs_err": l1_bf16["err"],
        "l1_bf16_ms": l1_bf16["times"]["new"]["ms"],
        "l1_bf16_device_ms": l1_bf16["times"]["new"]["device_ms"],
        "l1_bf16_bound_ms": l1_bf16["bound_ms"],
    })
    kernels[0]["js_launches"] = js_launches
    # the JTSM train rows: the mask pooler of a flagship step, one level,
    # B=4, R=256, P=14, C=512 (K1 forward, K2 backward)
    for line, kind in ((kernels[0], "fwd"), (kernels[1], "bwd")):
        f32, bf16 = jt_rows[f"{kind} f32"], jt_rows[f"{kind} bf16"]
        line.update({
            "jt_launches": jt_launches[line["name"]],
            "jt_max_abs_err": f32["err"],
            "jt_ms": f32["times"]["new"]["ms"],
            "jt_device_ms": f32["times"]["new"]["device_ms"],
            "jt_plain_ms": f32["plain_ms"],
            "jt_bound_ms": f32["bound_ms"],
            "jt_bf16_max_abs_err": bf16["err"],
            "jt_bf16_ms": bf16["times"]["new"]["ms"],
            "jt_bf16_device_ms": bf16["times"]["new"]["device_ms"],
            "jt_bf16_plain_ms": bf16["plain_ms"],
            "jt_bf16_bound_ms": bf16["bound_ms"],
        })
    log("[train] median step ms " + " ".join(f"{DTYPE_NAMES[d]}={t[1]:.3f}" for d, t in train.items())
        + f"; K1 launches serve {launches}, train " + str({d: t[0][KERNEL.name] for d, t in train.items()})
        + f", score {score_launches}, jtsm {jtsm_launches}, jtsm score {js_launches}; JTSM request mean ms "
        + " ".join(f"{DTYPE_NAMES[d]}={ms:.3f}" for d, ms in jtsm_lat.items())
        + "; JTSM train step median ms " + " ".join(f"{DTYPE_NAMES[d]}={ms:.3f}" for d, ms in jt_med.items())
        + f", launches {jt_launches}")
    log(f"[done] {time.perf_counter() - t_run:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
