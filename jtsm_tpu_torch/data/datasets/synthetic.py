"""The synthetic COCO instance set, made in memory (a copy of the instance
part of ``dev/make_synthetic_coco.py``: ``make_images``, ``make_instances``,
``render_images``, for the ``coco`` tree).

From the same seed and count it makes the same json and the same pixels
as the dev script does before it encodes them as JPEG, so the port scores
on a machine without Pillow (the card's). Two ways to use it:

* ``register_synthetic_coco(name, ...)``: a dataset whose records carry
  their RGB pixels (``image``), which the mapper takes without decoding,
  and whose metadata holds the json dict;
* ``write_synthetic_coco(root, ...)``: the json and JPEG files of the dev
  script's ``coco`` tree under ``root`` (needs Pillow).

``image_hw`` fixes every image's size instead of drawing it (the flagship
scores 480x640 scenes, COCO's usual size).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from ..catalog import DatasetCatalog, MetadataCatalog
from .builtin_meta import COCO_CATEGORIES, _get_builtin_metadata
from .coco import load_coco_json

_THING = [c for c in COCO_CATEGORIES if c["isthing"]]
COCO_80 = [c["id"] for c in _THING]  # the 80 thing ids, 1..90 with gaps
STUFF_A_COLOR = np.asarray([95, 115, 205], np.uint8)
STUFF_B_COLOR = np.asarray([95, 175, 95], np.uint8)
JSON_NAME = os.path.join("annotations", "instances_val2017_100.json")
IMAGE_DIR = "val2017"


def class_color(cat_id: int) -> np.ndarray:
    r = (37 * cat_id + 61) % 200 + 55
    g = (91 * cat_id + 13) % 200 + 55
    b = (53 * cat_id + 137) % 200 + 55
    return np.asarray([r, g, b], np.uint8)


def _paint_stuff(img: np.ndarray, h: int, w: int) -> None:
    """Two textured stuff bands split at half height."""
    split = int(h * 0.5)
    img[:split] = STUFF_A_COLOR
    img[0:split:6] = np.clip(STUFF_A_COLOR.astype(np.int16) - 35, 0, 255)
    img[split:] = STUFF_B_COLOR
    yy, xx = np.mgrid[split:h, 0:w]
    img[split:][((yy - split) // 8 + xx // 8)[: h - split] % 2 == 0] = np.clip(
        STUFF_B_COLOR.astype(np.int16) + 30, 0, 255
    )


def make_synthetic_coco(num: int = 8, seed: int = 0,
                        image_hw: Optional[Tuple[int, int]] = None) -> Tuple[Dict, Dict[int, np.ndarray]]:
    """The instance json dict and each image's (H, W, 3) uint8 RGB pixels by
    id: 1-4 rectangles a scene in the colour of their category, polygon
    masks, on two stuff bands, with pixel noise."""
    rng = np.random.default_rng(seed)
    infos = []
    for i in range(num):
        if image_hw is None:
            h, w = int(rng.integers(240, 321)), int(rng.integers(320, 401))
        else:
            h, w = image_hw
        infos.append({"id": i, "file_name": f"{i:012d}.jpg", "height": h, "width": w})
    anns = []
    for info in infos:
        for _ in range(int(rng.integers(1, 5))):
            bw = float(rng.uniform(20, info["width"] / 2))
            bh = float(rng.uniform(20, info["height"] / 2))
            x = float(rng.uniform(0, info["width"] - bw - 1))
            y = float(rng.uniform(0, info["height"] - bh - 1))
            anns.append({
                "id": len(anns) + 1,
                "image_id": info["id"],
                "category_id": int(rng.choice(COCO_80)),
                "bbox": [x, y, bw, bh],
                "area": bw * bh,
                "iscrowd": 0,
                "segmentation": [[x, y, x + bw, y, x + bw, y + bh, x, y + bh]],
            })
    coco = {
        "images": infos,
        "annotations": anns,
        "categories": [{"id": c["id"], "name": c["name"]} for c in _THING],
    }
    images = {}
    for info in infos:
        h, w = info["height"], info["width"]
        img = np.zeros((h, w, 3), np.uint8)
        _paint_stuff(img, h, w)
        for a in anns:
            if a["image_id"] == info["id"]:
                x, y, bw, bh = (int(round(v)) for v in a["bbox"])
                img[y: y + bh, x: x + bw] = class_color(int(a["category_id"]))
        noise = rng.integers(-12, 13, (h, w, 3))
        images[info["id"]] = np.clip(img.astype(np.int16) + noise, 0, 255).astype(np.uint8)
    return coco, images


def register_synthetic_coco(name: str, num: int = 8, seed: int = 0,
                            image_hw: Optional[Tuple[int, int]] = None) -> Dict:
    """Registers ``name``: the scenes of ``make_synthetic_coco`` with their
    pixels in the records, COCO metadata, and the json dict for the
    evaluator. Returns the json dict."""
    coco, images = make_synthetic_coco(num, seed, image_hw)

    def load():
        records = load_coco_json(coco, IMAGE_DIR, name)
        for r in records:
            r["image"] = images[r["image_id"]]
        return records

    DatasetCatalog.register(name, load)
    MetadataCatalog.get(name).set(json_file=coco, image_root=IMAGE_DIR, evaluator_type="coco",
                                  **_get_builtin_metadata("coco"))
    return coco


def write_synthetic_coco(root: str, num: int = 8, seed: int = 0) -> str:
    """Writes ``coco/annotations/instances_val2017_100.json`` and the scenes
    as JPEG under ``root``, as the dev script's ``coco`` tree (needs
    Pillow); returns the tree's directory."""
    from PIL import Image

    coco, images = make_synthetic_coco(num, seed)
    tree = os.path.join(root, "coco")
    os.makedirs(os.path.join(tree, "annotations"), exist_ok=True)
    os.makedirs(os.path.join(tree, IMAGE_DIR), exist_ok=True)
    with open(os.path.join(tree, JSON_NAME), "w") as f:
        json.dump(coco, f)
    for info in coco["images"]:
        Image.fromarray(images[info["id"]]).save(os.path.join(tree, IMAGE_DIR, info["file_name"]))
    return tree
