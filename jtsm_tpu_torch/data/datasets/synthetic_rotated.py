"""Synthetic scenes of rotated boxes, made in memory: each a few filled
rotated rectangles in the colour of their class on a noisy background, with
XYWHA_ABS annotations (cx, cy, w, h, angle in degrees, counter-clockwise, the
convention of ``structures.rotated_boxes.rotated_box_corners``). The records
carry their RGB pixels (``image``), which the mapper takes in place of a
file, so the scenes score without Pillow (the card's machine). No public
set of rotated boxes is in the repository; these stand in for one.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ...structures.boxes import BoxMode
from ..catalog import DatasetCatalog, MetadataCatalog
from .synthetic import class_color


def paint_rotated_box(img: np.ndarray, box, color) -> None:
    """Fills the pixels whose centres lie in the rotated ``box`` (cx, cy, w,
    h, angle) with ``color``, in place."""
    h, w = img.shape[:2]
    cx, cy, bw, bh, a = (float(v) for v in box)
    theta = a * np.pi / 180.0
    c, s = np.cos(theta), np.sin(theta)
    yy, xx = np.mgrid[0:h, 0:w] + 0.5
    u = (xx - cx) * c + (yy - cy) * s
    v = -(xx - cx) * s + (yy - cy) * c
    img[(np.abs(u) <= bw / 2) & (np.abs(v) <= bh / 2)] = color


def make_synthetic_rotated(num: int = 8, seed: int = 0, image_hw: Tuple[int, int] = (64, 64),
                           num_classes: int = 3) -> List[Dict]:
    """``num`` records of ``image_hw`` scenes: 1-3 rotated rectangles each,
    sides from a tenth to half the image's shorter side, any angle in
    [-90, 90), classes in [0, num_classes)."""
    rng = np.random.default_rng(seed)
    h, w = image_hw
    side = min(h, w)
    records = []
    for i in range(num):
        img = np.full((h, w, 3), 60, np.int16)
        annos = []
        for _ in range(int(rng.integers(1, 4))):
            bw, bh = rng.uniform(0.1 * side, 0.5 * side, 2)
            cx, cy = rng.uniform(0.25, 0.75, 2) * (w, h)
            box = [float(cx), float(cy), float(bw), float(bh), float(rng.uniform(-90, 90))]
            cat = int(rng.integers(0, num_classes))
            paint_rotated_box(img, box, class_color(cat + 1))
            annos.append({"bbox": box, "bbox_mode": BoxMode.XYWHA_ABS, "category_id": cat, "iscrowd": 0})
        noise = rng.integers(-12, 13, (h, w, 3))
        records.append({
            "file_name": f"rotated_{i:06d}.png", "image_id": i, "height": h, "width": w,
            "image": np.clip(img + noise, 0, 255).astype(np.uint8), "annotations": annos,
        })
    return records


def register_synthetic_rotated(name: str, num: int = 8, seed: int = 0, image_hw: Tuple[int, int] = (64, 64),
                               num_classes: int = 3) -> List[Dict]:
    """Registers ``name``: the scenes of ``make_synthetic_rotated`` with
    ``num_classes`` thing classes and no json, so that the COCO evaluators
    convert the records (``convert_to_coco_dict``, 5-dim boxes). Returns the
    records."""
    records = make_synthetic_rotated(num, seed, image_hw, num_classes)
    DatasetCatalog.register(name, lambda: [dict(r) for r in records])
    MetadataCatalog.get(name).set(thing_classes=[f"class_{k}" for k in range(num_classes)])
    return records
