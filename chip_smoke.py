#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``jtsm_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. device: the card's name and power limit; TF32 off for matmul and cuDNN;
2. build: every CUDA kernel of the served path, compiled with nvcc from the
   sources in this checkout;
3. kernels: each kernel against its plain PyTorch version at the shapes the
   served path gives it, with the stated tolerance, timed with CUDA events
   beside its bound;
4. serve: Mask R-CNN R50-FPN at full width (random weights from a seed)
   answers 4 requests of one 800x1344 image each; every kernel's launch
   count is set to 0 before and read after, and each must have run;
5. trained weights: the committed gate checkpoint (a narrow R50) on one
   seeded image, through the kernel and through the plain version on the
   card, must give the same detections;
6. training kernels: K1 and K2 (the ROIAlign backward) against their plain
   versions at the flagship's training shapes (B=2 at 800x1344, 1024 box
   ROIs at P=7 and 256 mask ROIs at P=14), K2 in float32 and bfloat16,
   timed beside their bounds;
7. train: the flagship at full width (random weights from a seed) takes 5
   SGD steps on a seeded synthetic batch of 2 images at 800x1344; every
   loss must be finite, and K1 and K2 must each launch 2 times a step;
8. train, kernel against plain: one step from the gate checkpoint through
   K1/K2 and through the plain forward and backward on the card must give
   the same losses and gradients.

The last three lines are {"kernels": [...]}, the card's name and power
limit as nvidia-smi gives them, and {"ok": true, "device": {...}}. Needs one
card, torch and numpy; imports nothing of JAX. Without a card, or outside a
checkout of the repository, it exits with 2 and prints no result.
"""

from __future__ import annotations

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


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def phase_kernels(gen):
    import torch

    from jtsm_tpu_torch.modeling.poolers import assign_boxes_to_levels
    from jtsm_tpu_torch.ops.roi_align import roi_align_multilevel_plain
    from jtsm_tpu_torch.ops.roi_align_cuda import roi_align_multilevel_cuda

    scales = [1.0 / s for s in LEVEL_STRIDES]
    pyr32 = flagship_pyramid(gen, dtype=torch.float32)
    cases = [
        # name, features, scales, R, P, batch
        ("box pooler f32", pyr32, scales, 1000, 7, 1),
        ("mask pooler f32", pyr32, scales, 100, 14, 1),
        ("box pooler bf16", [f.to(torch.bfloat16) for f in pyr32], scales, 1000, 7, 1),
        ("single level f32 (L=1, B=2)", [torch.randn((2, 50, 84, 256), generator=gen, device=DEVICE)],
         [1.0 / 16], 512, 14, 2),
    ]
    results = {}
    for name, feats, scs, r, p, batch in cases:
        boxes = spread_boxes(gen, r)
        if len(feats) > 1:
            levels = assign_boxes_to_levels(boxes, 2, 5)
        else:
            levels = torch.zeros(r, dtype=torch.int32, device=DEVICE)
        bidx = torch.randint(0, batch, (r,), generator=gen, device=DEVICE, dtype=torch.int32)
        args = (feats, scs, boxes, bidx, levels, p, 0, True)
        got = roi_align_multilevel_cuda(*args)
        want = roi_align_multilevel_plain(*args)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        scale = max(1.0, want.float().abs().max().item())
        tol = (TOL_BF16 if feats[0].dtype == torch.bfloat16 else TOL_F32) * scale
        k_ms = cuda_time_ms(lambda: roi_align_multilevel_cuda(*args), 20)
        p_ms = cuda_time_ms(lambda: roi_align_multilevel_plain(*args), 3)
        nbytes, flops = roi_align_work(feats, scs, boxes, bidx, levels, p, 0)
        b_ms, b_by = bound(nbytes, flops)
        per_level = [int((levels == i).sum()) for i in range(len(feats))]
        log(f"[kernels] roi_align_fwd {name}: R={r} P={p} C={feats[0].shape[-1]} rois/level={per_level} "
            f"max_abs_err={err:.3e} max_rel_err={err / scale:.3e} (tol {tol:.3e} abs, "
            f"{tol / scale:.3e} of the output's scale {scale:.3f}) kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP)")
        if not err <= tol:
            raise AssertionError(f"roi_align_fwd {name}: max_abs_err {err} > {tol}")
        results[name] = dict(err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                             nbytes=nbytes, flops=flops)
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


def phase_serve(kernel):
    import numpy as np
    import torch

    from jtsm_tpu_torch.checkpoint import random_state_dict
    from jtsm_tpu_torch.config import mask_rcnn_R_50_FPN_cfg
    from jtsm_tpu_torch.engine import Predictor
    from jtsm_tpu_torch.modeling import build_model

    cfg = mask_rcnn_R_50_FPN_cfg()
    state = random_state_dict(build_model(cfg, device="cpu"), seed=0)
    predictor = Predictor(cfg, state)
    rng = np.random.default_rng(0)
    h, w = FLAGSHIP_HW
    warm = request(rng, (h, w), (h, w), (h, w))
    reqs = [
        request(rng, (h, w), (h, w), (h, w)),
        request(rng, (h, w), (h, w), (480, 640)),
        request(rng, (h, w), (h - 50, w - 11), (h - 50, w - 11)),  # content smaller than the canvas
        request(rng, (h, w), (h, w), (h, w)),
    ]
    predictor(warm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel.launches = 0
    lat, valid = [], []
    for i, req in enumerate(reqs):
        before = kernel.launches
        t0 = time.perf_counter()
        out = predictor(req)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        check_detections(out, cfg.TEST.DETECTIONS_PER_IMAGE, 2 * cfg.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION)
        if kernel.launches - before != 2:
            raise AssertionError(f"request {i}: roi_align_fwd launched {kernel.launches - before} times, not 2")
        bh, bw = req["orig_sizes"][0]
        boxes = out["boxes"][0]
        if (boxes[:, 2] > bw).any() or (boxes[:, 3] > bh).any() or (boxes < 0).any():
            raise AssertionError(f"request {i}: boxes leave the original image")
        valid.append(int(out["valid"].sum()))
    launches = kernel.launches
    if launches == 0:
        raise AssertionError("roi_align_fwd was not launched on the served path")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[serve] R50-FPN Mask R-CNN 800x1344, 4 requests: latency_ms={[round(x, 3) for x in lat]} "
        f"mean_ms={sum(lat) / len(lat):.3f} valid_detections={valid} roi_align_fwd_launches={launches} "
        f"peak_mem_gib={peak:.3f}")

    # where a request's time goes: the model's stages one by one, each
    # ended by a synchronize (host clock, mean of 3 runs of the first request)
    model, req = predictor.model, reqs[0]
    stage_ms = {"backbone": 0.0, "rpn": 0.0, "roi_heads": 0.0}
    with torch.no_grad():
        for _ in range(3):
            t0 = time.perf_counter()
            images = torch.as_tensor(req["image"], device=DEVICE)
            sizes = torch.as_tensor(req["image_sizes"], device=DEVICE)
            feats = model.backbone(((images - model.pixel_mean) / model.pixel_std).permute(0, 3, 1, 2))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            proposals, scores, _ = model.proposal_generator(sizes, feats)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            model.roi_heads(feats, proposals, scores, sizes)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            for k, dt in zip(stage_ms, (t1 - t0, t2 - t1, t3 - t2)):
                stage_ms[k] += dt * 1e3 / 3
    channels_last = all(f.is_contiguous(memory_format=torch.channels_last) for f in feats.values())
    log("[serve] stages_ms " + " ".join(f"{k}={v:.3f}" for k, v in stage_ms.items())
        + f" | FPN maps channels-last (free NHWC views for the poolers): {channels_last}")
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
    log(f"[trained] gate checkpoint, 1 image {h}x{w}: valid_detections={n_valid} "
        f"classes={kernel_out['classes'][0][kernel_out['valid'][0]].tolist()[:10]} "
        f"max_abs_err={errs} tol={tols}")
    for n in errs:
        if not errs[n] <= tols[n]:
            raise AssertionError(f"kernel vs plain {n}: {errs[n]} > {tols[n]}")


def phase_train_kernels(gen):
    """K1 and K2 against their plain versions at the training shapes: B=2,
    the flagship pyramid, 1024 box ROIs (P=7) and 256 mask ROIs (P=14)."""
    import torch

    from jtsm_tpu_torch.modeling.poolers import assign_boxes_to_levels
    from jtsm_tpu_torch.ops.roi_align import (
        roi_align_multilevel_backward_plain,
        roi_align_multilevel_plain,
    )
    from jtsm_tpu_torch.ops.roi_align_cuda import (
        roi_align_multilevel_backward_cuda,
        roi_align_multilevel_cuda,
    )

    scales = [1.0 / s for s in LEVEL_STRIDES]
    pyr32 = flagship_pyramid(gen, dtype=torch.float32, batch=TRAIN_BATCH)
    results = {}
    for pooler, r, p in (("box", 1024, 7), ("mask", 256, 14)):
        boxes = spread_boxes(gen, r)
        levels = assign_boxes_to_levels(boxes, 2, 5)
        # image-major, as the train step pools them
        bidx = torch.arange(TRAIN_BATCH, dtype=torch.int32, device=DEVICE).repeat_interleave(r // TRAIN_BATCH)
        per_level = [int((levels == i).sum()) for i in range(len(pyr32))]

        # K1
        args = (pyr32, scales, boxes, bidx, levels, p, 0, True)
        got = roi_align_multilevel_cuda(*args)
        want = roi_align_multilevel_plain(*args)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = max(1.0, want.abs().max().item())
        k_ms = cuda_time_ms(lambda: roi_align_multilevel_cuda(*args), 20)
        p_ms = cuda_time_ms(lambda: roi_align_multilevel_plain(*args), 3)
        nbytes, flops = roi_align_work(pyr32, scales, boxes, bidx, levels, p, 0)
        b_ms, b_by = bound(nbytes, flops)
        log(f"[train_kernels] roi_align_fwd {pooler} pooler f32 B={TRAIN_BATCH}: R={r} P={p} rois/level={per_level} "
            f"max_abs_err={err:.3e} max_rel_err={err / scale:.3e} (tol {TOL_F32 * scale:.3e}) kernel_ms={k_ms:.4f} "
            f"plain_ms={p_ms:.4f} bound_ms={b_ms:.4f} ({b_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP)")
        if not err <= TOL_F32 * scale:
            raise AssertionError(f"roi_align_fwd {pooler} pooler B={TRAIN_BATCH}: max_abs_err {err}")
        results[f"fwd {pooler}"] = dict(err=err, ms=k_ms, plain_ms=p_ms, nbytes=nbytes, flops=flops)

        # K2, in float32 and bfloat16
        for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
            feats = [f.to(dtype) for f in pyr32]
            shapes = [tuple(f.shape) for f in feats]
            grad = torch.randn((r, p, p, 256), generator=gen, device=DEVICE).to(dtype)
            args = (grad, shapes, scales, boxes, bidx, levels, p, 0, True)
            got = roi_align_multilevel_backward_cuda(*args)
            want = roi_align_multilevel_backward_plain(*args)
            torch.cuda.synchronize()
            contiguous = all(g.is_contiguous() and tuple(g.shape) == s for g, s in zip(got, shapes))
            err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
            scale = max(1.0, max(w.float().abs().max().item() for w in want))
            k_ms = cuda_time_ms(lambda: roi_align_multilevel_backward_cuda(*args), 20)
            p_ms = cuda_time_ms(lambda: roi_align_multilevel_backward_plain(*args), 3)
            nbytes, flops, touched_bytes = roi_align_bwd_work(feats, scales, boxes, bidx, levels, p, 0)
            b_ms, b_by = bound(nbytes, flops)
            name = f"{pooler} pooler {'bf16' if dtype == torch.bfloat16 else 'f32'}"
            log(f"[train_kernels] roi_align_bwd {name} B={TRAIN_BATCH}: R={r} P={p} max_abs_err={err:.3e} "
                f"max_rel_err={err / scale:.3e} (tol {tol * scale:.3e} abs, {tol:.3e} of the gradient's scale "
                f"{scale:.3f}) kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={b_ms:.4f} ({b_by}: "
                f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP; touched cells read and written once: "
                f"{touched_bytes / 1e6:.1f} MB, {touched_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms) "
                f"contiguous (B, H, W, C) gradients: {contiguous}")
            if not err <= tol * scale:
                raise AssertionError(f"roi_align_bwd {name}: max_abs_err {err} > {tol * scale}")
            if not contiguous:
                raise AssertionError(f"roi_align_bwd {name}: gradients not contiguous (B, H, W, C)")
            results[f"bwd {name}"] = dict(err=err, ms=k_ms, plain_ms=p_ms, nbytes=nbytes, flops=flops)
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


def phase_train(kernels):
    """The flagship takes TRAIN_STEPS steps at full width; then one more
    step split by stage."""
    import torch

    from jtsm_tpu_torch.checkpoint import random_state_dict
    from jtsm_tpu_torch.config import mask_rcnn_R_50_FPN_cfg
    from jtsm_tpu_torch.engine import create_train_state, make_train_step
    from jtsm_tpu_torch.modeling import build_model
    from jtsm_tpu_torch.solver import build_lr_schedule, build_optimizer

    cfg = mask_rcnn_R_50_FPN_cfg()
    model = build_model(cfg)
    model.load_state_dict(random_state_dict(build_model(cfg, device="cpu"), seed=0))
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
            raise AssertionError(f"step {i}: loss keys {sorted(values)}")
        if not all(math.isfinite(v) for v in values.values()):
            raise AssertionError(f"step {i}: non-finite losses {values}")
        per_step = [k.launches - b for k, b in zip(kernels, before)]
        if per_step != [2] * len(kernels):
            raise AssertionError(f"step {i}: launches {dict(zip([k.name for k in kernels], per_step))}, not 2 each")
        log(f"[train] step {i}: ms={times[-1]:.3f} " + " ".join(f"{k}={values[k]:.6g}" for k in keys + ["total_loss"]))
    launches = {k.name: k.launches for k in kernels}
    if any(n == 0 for n in launches.values()):
        raise AssertionError(f"a kernel was not launched on the train path: {launches}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = sorted(times[1:])[len(times[1:]) // 2]
    log(f"[train] R50-FPN Mask R-CNN, {TRAIN_BATCH} images 800x1344 per step, f32 (TF32 off): {TRAIN_STEPS} steps "
        f"step_ms={[round(t, 3) for t in times]} median_after_first_ms={med:.3f} launches={launches} "
        f"peak_mem_gib={peak:.3f}")

    # one more step, split by stage (host clock, a synchronize after each);
    # hooks on the FPN maps read the layout of the gradients the poolers
    # and the RPN hand back to the backbone
    stage = {}
    grad_layout = {}
    dev = model.device
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
    log("[train] stages_ms " + " ".join(f"{k}={v:.3f}" for k, v in stage.items())
        + f" | FPN map gradients channels-last (no copy to another format): {grad_layout}")
    if len(grad_layout) != 4:
        raise AssertionError(f"gradients reached only {sorted(grad_layout)} of the FPN maps")
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
    log(f"[train_trained] gate checkpoint, 2 images 128x176, one step: losses={kernel_losses} "
        f"max_rel_loss_err={loss_err:.3e} (tol 1e-5) max_rel_grad_err={grad_err:.3e} over "
        f"{len(plain_grads)} parameters (tol 1e-4 of each parameter's gradient scale)")
    if not all(math.isfinite(v) for v in kernel_losses.values()):
        raise AssertionError(f"non-finite losses {kernel_losses}")
    if not loss_err <= 1e-5:
        raise AssertionError(f"kernel vs plain losses differ by {loss_err}")
    if not grad_err <= 1e-4:
        raise AssertionError(f"kernel vs plain gradients differ by {grad_err}")


def main() -> int:
    t_run = time.perf_counter()
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} | TF32 off | {time.perf_counter() - t0:.1f}s")

    # 2. build
    t0 = time.perf_counter()
    from jtsm_tpu_torch.ops.roi_align_cuda import BWD_KERNEL, KERNEL, KERNELS, load_kernels

    for k, built in zip(KERNELS, load_kernels()):
        log(f"[build] {k.source} -> {os.path.relpath(built.path, REPO)} in {built.seconds:.1f}s (nvcc)")
        for line in built.ptxas_log.splitlines():
            log(f"[build] {line.strip()}")
    log(f"[build] done in {time.perf_counter() - t0:.1f}s (one nvcc per source, in parallel)")

    # 3. kernels against their plain versions
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    res = phase_kernels(gen)
    log(f"[kernels] done in {time.perf_counter() - t0:.1f}s")

    # 4. serve the flagship
    t0 = time.perf_counter()
    launches = phase_serve(KERNEL)
    log(f"[serve] done in {time.perf_counter() - t0:.1f}s")

    # 5. trained weights, kernel against plain on the card
    t0 = time.perf_counter()
    phase_trained()
    log(f"[trained] done in {time.perf_counter() - t0:.1f}s")

    # 6. the training kernels against their plain versions
    t0 = time.perf_counter()
    tres = phase_train_kernels(gen)
    log(f"[train_kernels] done in {time.perf_counter() - t0:.1f}s")

    # 7. train the flagship (cuDNN's own algorithm choice, as a user trains)
    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = False
    train_launches, step_ms = phase_train(KERNELS)
    log(f"[train] done in {time.perf_counter() - t0:.1f}s")

    # 8. a train step from trained weights, kernels against plain
    t0 = time.perf_counter()
    phase_train_trained()
    log(f"[train_trained] done in {time.perf_counter() - t0:.1f}s")

    # per served request K1 pools boxes (R=1000, P=7) and masks (R=100,
    # P=14); per train step K1 and K2 pool and unpool boxes (R=1024, P=7)
    # and masks (R=256, P=14). Launches: both main paths, serve and train.
    box, mask = res["box pooler f32"], res["mask pooler f32"]
    b_ms, b_by = bound(box["nbytes"] + mask["nbytes"], box["flops"] + mask["flops"])
    bbox, bmask = tres["bwd box pooler f32"], tres["bwd mask pooler f32"]
    k2_ms, k2_by = bound(bbox["nbytes"] + bmask["nbytes"], bbox["flops"] + bmask["flops"])
    kernels = [{
        "name": KERNEL.name,
        "route": "cuda",
        "source": KERNEL.source,
        "replaces": KERNEL.replaces,
        "launches": launches + train_launches[KERNEL.name],
        "max_abs_err": max(r["err"] for n, r in res.items() if "f32" in n),
        "ms": box["ms"] + mask["ms"],
        "plain_ms": box["plain_ms"] + mask["plain_ms"],
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    }, {
        "name": BWD_KERNEL.name,
        "route": "cuda",
        "source": BWD_KERNEL.source,
        "replaces": BWD_KERNEL.replaces,
        "launches": train_launches[BWD_KERNEL.name],
        "max_abs_err": max(bbox["err"], bmask["err"]),
        "ms": bbox["ms"] + bmask["ms"],
        "plain_ms": bbox["plain_ms"] + bmask["plain_ms"],
        "bound_ms": k2_ms,
        "bound_by": k2_by,
        "library_ms": None,
    }]
    log(f"[train] median step ms {step_ms:.3f}; K1 launches serve {launches}, train {train_launches[KERNEL.name]}")
    log(f"[done] {time.perf_counter() - t_run:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
