"""Seeded LVIS-format sets, in memory or written as files, for the LVIS
checks where LVIS and its COCO images are not at hand.

The scenes are those of ``synthetic.make_synthetic_coco`` (1-4 rectangles a
scene in the colour of their COCO class). COCO's 80 thing classes become
the LVIS categories 1-80 in COCO's order (the contiguous ids 0-79, so that
the Mask R-CNN gate's classifier rows carry over); the json lists
``num_classes`` categories (LVIS v1's 1203 by default), their frequencies
"r", "c", "f" in turn by id. Each image lists two classes it does not show
as negative and its first annotated class as not exhaustive.

* ``make_synthetic_lvis(num, ...)``: (the LVIS json dict, each image's
  (H, W, 3) uint8 RGB pixels by id, the ids from ``first_id``);
  ``version`` "v1" names images by ``coco_url``, "v0.5" by a 2014-style
  ``file_name``;
* ``register_synthetic_lvis(name, ...)``: a dataset of the json's records
  with their pixels (``image``), scored by ``LVISEvaluator``, read without
  Pillow;
* ``write_synthetic_lvis(root, name, ...)``: ``root/lvis/<name>.json`` and
  the images under ``root/coco/`` by their bare file names, the layout
  ``builtin.register_all_lvis`` reads (needs Pillow).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from ..catalog import DatasetCatalog, MetadataCatalog
from .lvis import load_lvis_json
from .synthetic import COCO_80, make_synthetic_coco

LVIS_CLASSES = {"v1": 1203, "v0.5": 1230}
FREQUENCIES = ("r", "c", "f")


def _file_key(image_id: int, version: str) -> Dict:
    if version == "v0.5":
        return {"file_name": f"COCO_val2014_{image_id:012d}.jpg"}
    return {"coco_url": f"http://images.cocodataset.org/val2017/{image_id:012d}.jpg"}


def make_synthetic_lvis(num: int = 8, seed: int = 0, image_hw: Optional[Tuple[int, int]] = None,
                        version: str = "v1", num_classes: Optional[int] = None,
                        first_id: int = 0) -> Tuple[Dict, Dict[int, np.ndarray]]:
    coco, images = make_synthetic_coco(num, seed, image_hw)
    for info in coco["images"]:
        info["id"] += first_id
    for a in coco["annotations"]:
        a["image_id"] += first_id
    images = {k + first_id: v for k, v in images.items()}
    num_classes = num_classes or LVIS_CLASSES[version]
    lvis_id = {cid: i + 1 for i, cid in enumerate(COCO_80)}
    rng = np.random.default_rng(seed + 1)
    present = {}
    anns = []
    for a in coco["annotations"]:
        cat = lvis_id[a["category_id"]]
        present.setdefault(a["image_id"], []).append(cat)
        anns.append({"id": a["id"], "image_id": a["image_id"], "category_id": cat, "bbox": a["bbox"],
                     "area": a["area"], "segmentation": a["segmentation"]})
    infos = []
    for info in coco["images"]:
        cats = present.get(info["id"], [])
        absent = [c for c in range(1, len(COCO_80) + 1) if c not in cats]
        infos.append({"id": info["id"], "height": info["height"], "width": info["width"],
                      **_file_key(info["id"], version),
                      "neg_category_ids": sorted(int(c) for c in rng.choice(absent, 2, replace=False)),
                      "not_exhaustive_category_ids": cats[:1]})
    categories = [{"id": i, "name": f"class_{i}", "synonyms": [f"class_{i}", f"thing_{i}"],
                   "frequency": FREQUENCIES[(i - 1) % 3]} for i in range(1, num_classes + 1)]
    return {"images": infos, "annotations": anns, "categories": categories}, images


def register_synthetic_lvis(name: str, num: int = 8, seed: int = 0, image_hw: Optional[Tuple[int, int]] = None,
                            version: str = "v1", num_classes: Optional[int] = None, first_id: int = 0) -> Dict:
    """Registers ``name`` (see the module's docstring); returns the json."""
    lvis, images = make_synthetic_lvis(num, seed, image_hw, version, num_classes, first_id)

    def load():
        records = load_lvis_json(lvis, "coco", name)
        for r in records:
            r["image"] = images[r["image_id"]]
        return records

    DatasetCatalog.register(name, load)
    MetadataCatalog.get(name).set(json_file=lvis, image_root="coco", evaluator_type="lvis")
    return lvis


def write_synthetic_lvis(root: str, name: str = "lvis_v1_val", num: int = 8, seed: int = 0,
                         image_hw: Optional[Tuple[int, int]] = None, version: str = "v1",
                         num_classes: Optional[int] = None, first_id: int = 0) -> str:
    """Writes the json and JPEG images; returns the json's path. Splits
    that share ``root/coco`` need image ids of their own (``first_id``),
    as LVIS's splits have."""
    from PIL import Image

    lvis, images = make_synthetic_lvis(num, seed, image_hw, version, num_classes, first_id)
    os.makedirs(os.path.join(root, "lvis"), exist_ok=True)
    os.makedirs(os.path.join(root, "coco"), exist_ok=True)
    for info in lvis["images"]:
        bare = info["file_name"][-16:] if "file_name" in info else info["coco_url"].split("/")[-1]
        Image.fromarray(images[info["id"]]).save(os.path.join(root, "coco", bare), quality=95)
    path = os.path.join(root, "lvis", f"{name}.json")
    with open(path, "w") as f:
        json.dump(lvis, f)
    return path
