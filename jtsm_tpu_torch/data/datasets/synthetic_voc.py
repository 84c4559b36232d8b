"""Seeded Pascal VOC-style detection scenes with precomputed proposals, in
memory or written as a VOC tree, for the WSOD baselines' checks where VOC
2007 and its MCG proposals are not at hand.

Each scene is a noisy gray canvas with 1-3 objects, filled rectangles in
their class's colour at integer VOC corners (1-based ``xmin``, ``ymin``),
a quarter of them ``difficult``. Half the proposals of an image
are jittered copies of its objects' boxes, the rest boxes drawn at random, with
normal objectness logits: a detectron2 proposal dict {ids, boxes,
objectness_logits, bbox_mode}.

* ``make_synthetic_voc(num, ...)``: (records as ``load_voc_instances``
  makes them, each with its pixels as ``image``; the proposal dict);
* ``register_synthetic_voc(name, ...)``: a dataset of those records with
  the VOC metadata (``pascal_voc`` evaluator), read without Pillow; it
  returns the proposal dict, which stands for a proposal file;
* ``write_synthetic_voc(root, ...)``: ``root/VOC2007`` (``JPEGImages``,
  ``Annotations``, ``ImageSets/Main/<split>.txt``) and the proposal
  pickle (needs Pillow).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Tuple

import numpy as np

from ...structures import BoxMode
from ..catalog import DatasetCatalog, MetadataCatalog
from .pascal_voc import CLASS_NAMES, voc_instance, voc_metadata
from .synthetic import class_color


def _scene(rng: np.random.RandomState, h: int, w: int):
    img = np.clip(128 + rng.randn(h, w, 3) * 12, 0, 255).astype(np.uint8)
    objects = []
    for _ in range(rng.randint(1, 4)):
        cls = int(rng.randint(len(CLASS_NAMES)))
        bw, bh = int(rng.randint(w // 5, w // 2)), int(rng.randint(h // 5, h // 2))
        x0, y0 = int(rng.randint(1, w - bw)), int(rng.randint(1, h - bh))
        img[y0 - 1 : y0 - 1 + bh, x0 - 1 : x0 - 1 + bw] = class_color(cls + 1)
        objects.append({"name": CLASS_NAMES[cls], "difficult": int(rng.rand() < 0.25),
                        "bndbox": (x0, y0, x0 + bw - 1, y0 + bh - 1)})
    return img, objects


def _proposals(rng: np.random.RandomState, h: int, w: int, objects: List[dict], r: int) -> np.ndarray:
    boxes = []
    per_object = max(1, r // (2 * max(len(objects), 1)))
    for o in objects:
        x0, y0, x1, y1 = o["bndbox"]
        bw, bh = x1 - x0, y1 - y0
        jitter = rng.randn(per_object, 4) * [bw, bh, bw, bh] * 0.1
        boxes.append(np.asarray([x0 - 1, y0 - 1, x1, y1], np.float64) + jitter)
    rand = rng.rand(r - per_object * len(objects), 4) * [w, h, w, h]
    boxes.append(np.concatenate([np.minimum(rand[:, :2], rand[:, 2:]), np.maximum(rand[:, :2], rand[:, 2:]) + 8], 1))
    boxes = np.concatenate(boxes)
    boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, w - 1)
    boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, h - 1)
    return boxes.astype(np.float32)


def make_synthetic_voc(num: int = 8, seed: int = 0, image_hw: Tuple[int, int] = (96, 128),
                       num_proposals: int = 64) -> Tuple[List[dict], Dict]:
    """``num`` scenes of ``image_hw`` with ids "000001", ... and their
    ``num_proposals`` proposals each."""
    rng = np.random.RandomState(seed)
    h, w = image_hw
    records, ids, boxes, logits = [], [], [], []
    for i in range(num):
        image_id = f"{i + 1:06d}"
        img, objects = _scene(rng, h, w)
        annotations = [voc_instance(o["name"], o["difficult"], o["bndbox"]) for o in objects]
        records.append({"file_name": f"{image_id}.jpg", "image_id": image_id, "height": h, "width": w,
                        "annotations": annotations, "image": img, "objects": objects})
        ids.append(image_id)
        boxes.append(_proposals(rng, h, w, objects, num_proposals))
        logits.append(rng.randn(num_proposals).astype(np.float32))
    return records, {"ids": ids, "boxes": boxes, "objectness_logits": logits, "bbox_mode": BoxMode.XYXY_ABS}


def register_synthetic_voc(name: str, num: int = 8, seed: int = 0, image_hw: Tuple[int, int] = (96, 128),
                           num_proposals: int = 64) -> Dict:
    records, proposals = make_synthetic_voc(num, seed, image_hw, num_proposals)
    for r in records:
        del r["objects"]
    DatasetCatalog.register(name, lambda: [dict(r) for r in records])
    MetadataCatalog.get(name).set(**voc_metadata(None, "test", 2007))
    return proposals


def _annotation_xml(record: dict) -> str:
    objects = "".join(
        f"<object><name>{o['name']}</name><difficult>{o['difficult']}</difficult><bndbox>"
        + "".join(f"<{k}>{v}</{k}>" for k, v in zip(("xmin", "ymin", "xmax", "ymax"), o["bndbox"]))
        + "</bndbox></object>"
        for o in record["objects"]
    )
    return (f"<annotation><filename>{record['image_id']}.jpg</filename><size><width>{record['width']}</width>"
            f"<height>{record['height']}</height><depth>3</depth></size>{objects}</annotation>")


def write_synthetic_voc(root: str, num: int = 8, seed: int = 0, image_hw: Tuple[int, int] = (96, 128),
                        num_proposals: int = 64) -> str:
    """Writes ``root/VOC2007`` with every scene in both ``test`` and
    ``trainval``, and
    ``root/proposals_voc_2007.pkl``; returns the pickle's path."""
    from PIL import Image

    records, proposals = make_synthetic_voc(num, seed, image_hw, num_proposals)
    voc = os.path.join(root, "VOC2007")
    for sub in ("JPEGImages", "Annotations", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(voc, sub), exist_ok=True)
    for r in records:
        Image.fromarray(r["image"]).save(os.path.join(voc, "JPEGImages", r["image_id"] + ".jpg"), quality=95)
        with open(os.path.join(voc, "Annotations", r["image_id"] + ".xml"), "w") as f:
            f.write(_annotation_xml(r))
    for split in ("test", "trainval"):
        with open(os.path.join(voc, "ImageSets", "Main", split + ".txt"), "w") as f:
            f.write("".join(r["image_id"] + "\n" for r in records))
    path = os.path.join(root, "proposals_voc_2007.pkl")
    with open(path, "wb") as f:
        pickle.dump(proposals, f)
    return path
