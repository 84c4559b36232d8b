"""WSL batch helpers in numpy (reference:
projects/WSL/wsl/data/detection_utils.py:266; JAX package ``wsl/data.py``
:163 ``compute_superpixels_grid``, :172 ``oh_labels_from_boxes``, :196
``add_wsl_batch_fields``, and the training fields of
``data/detection_utils.py:418,476`` ``instances_to_static_targets`` and
``build_static_batch``), copied so that the port serves and trains JTSM
without the JAX package. The MCG proposal loaders and ``WSLDatasetMapper``
wait for the JTSM scoring slice.

Static shapes: ``superpixels`` (B, H, W) int32 ids clipped to
``[0, max_superpixels)``, ``oh_labels`` (B, R, max_superpixels) bool;
for training ``gt_classes`` (B, G) int32, ``gt_valid`` (B, G) bool,
``gt_boxes`` (B, G, 4) float32 and ``gt_sem_seg`` (B, H, W) int32 with 255
outside each image.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def compute_superpixels_grid(h: int, w: int, cell: int = 16) -> np.ndarray:
    """Fallback superpixel map: a regular grid (used when MCG superpixels are
    unavailable; also handy for tests)."""
    yy = np.arange(h)[:, None] // cell
    xx = np.arange(w)[None, :] // cell
    ncols = (w + cell - 1) // cell
    return (yy * ncols + xx).astype(np.int32)


def oh_labels_from_boxes(
    boxes: np.ndarray, superpixels: np.ndarray, max_superpixels: int
) -> np.ndarray:
    """Membership of each superpixel in each box (by the superpixel's
    centroid): fallback when MCG per-proposal segment membership is absent."""
    s = int(superpixels.max()) + 1
    s = min(s, max_superpixels)
    ys, xs = np.mgrid[0 : superpixels.shape[0], 0 : superpixels.shape[1]]
    flat = superpixels.reshape(-1)
    cnt = np.bincount(flat, minlength=s)[:s].astype(np.float64)
    cy = np.bincount(flat, weights=ys.reshape(-1), minlength=s)[:s] / np.maximum(cnt, 1)
    cx = np.bincount(flat, weights=xs.reshape(-1), minlength=s)[:s] / np.maximum(cnt, 1)
    r = boxes.shape[0]
    oh = np.zeros((r, max_superpixels), dtype=bool)
    inside = (
        (cx[None, :] >= boxes[:, 0:1])
        & (cy[None, :] >= boxes[:, 1:2])
        & (cx[None, :] <= boxes[:, 2:3])
        & (cy[None, :] <= boxes[:, 3:4])
    )
    oh[:, :s] = inside
    return oh


def add_wsl_batch_fields(
    batch: Dict[str, np.ndarray], per_image: List[dict], max_superpixels: int
) -> None:
    """Collate superpixels/oh_labels into the static batch (companion to
    data.detection_utils.build_static_batch)."""
    b = batch["image"].shape[0]
    bh, bw = batch["image"].shape[1:3]
    r = batch["proposals"].shape[1]
    batch["superpixels"] = np.zeros((b, bh, bw), np.int32)
    batch["oh_labels"] = np.zeros((b, r, max_superpixels), bool)
    for i, d in enumerate(per_image):
        p = d.get("proposals", {})
        sp = p.get("superpixels")
        if sp is None:
            h, w = d["image"].shape[:2]
            sp = compute_superpixels_grid(h, w)
        hh, ww = sp.shape
        batch["superpixels"][i, :hh, :ww] = np.clip(sp, 0, max_superpixels - 1)
        oh = p.get("oh_labels")
        if oh is None and "boxes" in p:
            oh = oh_labels_from_boxes(p["boxes"], sp, max_superpixels)
        if oh is not None:
            n = min(len(oh), r)
            batch["oh_labels"][i, :n] = oh[:n, :max_superpixels]


def add_wsl_train_fields(batch: Dict[str, np.ndarray], per_image: List[dict], max_instances: int) -> None:
    """Collate the image-level targets of a JTSM train step into the static
    batch, as the JAX package's ``build_static_batch`` does: each
    per-image dict's ``gt_classes`` (and ``gt_boxes`` when present) fill the
    first rows of a ``max_instances`` capacity, marked in ``gt_valid``; its
    ``sem_seg`` (h, w), where any dict has one, fills ``gt_sem_seg``."""
    b = batch["image"].shape[0]
    bh, bw = batch["image"].shape[1:3]
    g = max_instances
    batch["gt_boxes"] = np.zeros((b, g, 4), np.float32)
    batch["gt_classes"] = np.zeros((b, g), np.int32)
    batch["gt_valid"] = np.zeros((b, g), bool)
    if any("sem_seg" in d for d in per_image):
        batch["gt_sem_seg"] = np.full((b, bh, bw), 255, np.int32)
    for i, d in enumerate(per_image):
        classes = np.asarray(d.get("gt_classes", ()), np.int32)[:g]
        n = len(classes)
        batch["gt_classes"][i, :n] = classes
        batch["gt_valid"][i, :n] = True
        if "gt_boxes" in d:
            batch["gt_boxes"][i, :n] = np.asarray(d["gt_boxes"], np.float32)[:n]
        if "sem_seg" in d:
            h, w = d["sem_seg"].shape
            batch["gt_sem_seg"][i, :h, :w] = d["sem_seg"]
