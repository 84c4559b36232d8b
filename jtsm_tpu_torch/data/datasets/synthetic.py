"""The synthetic COCO sets of ``dev/make_synthetic_coco.py``, made in memory
(a copy of the dev script's ``make_images``, ``make_instances``,
``stuff_split_row``, ``paint_stuff``, ``render_images`` and
``_write_panoptic_and_proposals``): the instance set of its ``coco`` tree,
and the panoptic set of its ``cocovar`` tree (the stuff bands' presence
cycling per image) with its MCG-style proposals.

From the same seed and count it makes the same json and the same pixels
as the dev script does before it encodes them as JPEG, the same stuff and
panoptic maps as its PNGs hold and the same proposal dict as its pickle,
so the port scores on a machine without Pillow (the card's):

* ``register_synthetic_coco(name, ...)``, ``register_synthetic_cocovar(name,
  ...)``: a dataset whose records carry their RGB pixels (``image``) and,
  for the panoptic set, their stuff map (``sem_seg``) and panoptic id map
  (``pan_seg``), which the mapper and the evaluators take in place of
  files, and whose metadata holds the json dicts;
* ``write_synthetic_coco(root, ...)``: the dev script's ``coco`` files
  under ``root`` (needs Pillow).

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


def stuff_split_row(info: dict, varied: bool = False) -> int:
    """The row that splits the two stuff bands: half the height, or in the
    varied set by image id mod 3 both bands, band A only (the height) or
    band B only (0)."""
    h = info["height"]
    if varied:
        pat = info["id"] % 3
        if pat == 1:
            return h
        if pat == 2:
            return 0
    return int(h * 0.5)


def _paint_stuff(img: np.ndarray, h: int, w: int, split: int) -> None:
    """Two textured stuff bands split at row ``split``."""
    img[:split] = STUFF_A_COLOR
    img[0:split:6] = np.clip(STUFF_A_COLOR.astype(np.int16) - 35, 0, 255)
    img[split:] = STUFF_B_COLOR
    yy, xx = np.mgrid[split:h, 0:w]
    img[split:][((yy - split) // 8 + xx // 8)[: h - split] % 2 == 0] = np.clip(
        STUFF_B_COLOR.astype(np.int16) + 30, 0, 255
    )


def make_synthetic_coco(num: int = 8, seed: int = 0, image_hw: Optional[Tuple[int, int]] = None,
                        varied: bool = False) -> Tuple[Dict, Dict[int, np.ndarray]]:
    """The instance json dict and each image's (H, W, 3) uint8 RGB pixels by
    id: 1-4 rectangles a scene in the colour of their category, polygon
    masks, on two stuff bands (``stuff_split_row``), with pixel noise."""
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
        _paint_stuff(img, h, w, stuff_split_row(info, varied))
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


VARIED_SEED = 7  # the dev script's seed of its cocovar tree
PANOPTIC_DIR = "panoptic_val2017_100"


def make_panoptic_and_proposals(coco: Dict):
    """The panoptic and proposal side of the varied synthetic set: by image
    id, the panoptic id map (H, W) uint32 (stuff band A 1, band B 2, then
    the rectangles painted in order) and the stuff map (H, W) uint8
    (things 0, bands 1 and 2); the panoptic json dict; and the MCG-style
    proposal dict (jittered copies of the rectangles, the image, its bands
    and quarters, random boxes up to 64, descending objectness; a
    superpixel map of 24-pixel cells in each band and in each rectangle;
    membership by centroid)."""
    from ...wsl.data import oh_labels_from_boxes

    stuff = [c for c in COCO_CATEGORIES if not c["isthing"]]
    anns_by_image: Dict[int, list] = {}
    for a in coco["annotations"]:
        anns_by_image.setdefault(a["image_id"], []).append(a)
    pan_maps, sem_maps, pan_anns = {}, {}, []
    for info in coco["images"]:
        h, w = info["height"], info["width"]
        ids = np.zeros((h, w), np.uint32)
        split = stuff_split_row(info, varied=True)
        ids[:split] = 1
        ids[split:] = 2
        segments = [{"id": 1, "category_id": stuff[0]["id"], "iscrowd": 0, "area": int(split * w)},
                    {"id": 2, "category_id": stuff[1]["id"], "iscrowd": 0, "area": int((h - split) * w)}]
        seg_id = 3
        for a in anns_by_image.get(info["id"], []):
            x, y, bw, bh = (int(round(v)) for v in a["bbox"])
            ids[y: y + bh, x: x + bw] = seg_id
            segments.append({"id": seg_id, "category_id": int(a["category_id"]), "iscrowd": 0, "area": int(bw * bh)})
            seg_id += 1
        areas = np.bincount(ids.reshape(-1), minlength=seg_id)
        segments = [dict(s, area=int(areas[s["id"]])) for s in segments if areas[s["id"]] > 0]
        pan_maps[info["id"]] = ids
        sem_maps[info["id"]] = np.where(ids == 1, 1, np.where(ids == 2, 2, 0)).astype(np.uint8)
        pan_anns.append({"image_id": info["id"], "file_name": info["file_name"].replace(".jpg", ".png"),
                         "segments_info": segments})
    pan_json = {
        "images": coco["images"],
        "annotations": pan_anns,
        "categories": [{"id": c["id"], "name": c["name"], "isthing": c["isthing"]} for c in COCO_CATEGORIES],
    }

    rng = np.random.default_rng(1)  # the dev script's own stream for the proposals
    ids_list, boxes_list, logits_list, sp_list, oh_list = [], [], [], [], []
    cell = 24
    for info in coco["images"]:
        h, w = info["height"], info["width"]
        split = stuff_split_row(info, varied=True)
        ncols = (w + cell - 1) // cell
        row_a = np.arange(h)[:, None] // cell
        row_b = (split + cell - 1) // cell + (np.arange(h)[:, None] - split) // cell
        sp = np.where(np.arange(h)[:, None] < split, row_a, row_b) * ncols + (np.arange(w)[None, :] // cell)
        next_id = int(sp.max()) + 1
        gt = []
        for a in anns_by_image.get(info["id"], []):
            x, y, bw, bh = (int(round(v)) for v in a["bbox"])
            local = (np.arange(bh)[:, None] // cell) * ((bw + cell - 1) // cell) + (np.arange(bw)[None, :] // cell)
            sp[y: y + bh, x: x + bw] = next_id + local
            next_id += int(local.max()) + 1
            gt.append([x, y, x + bw, y + bh])
        gt = np.asarray(gt, np.float32).reshape(-1, 4)
        stuff_boxes = np.asarray([
            [0, 0, w - 1, h - 1], [0, 0, w - 1, split - 1], [0, split, w - 1, h - 1], [0, 0, w // 2, h // 2],
            [w // 2, 0, w - 1, h // 2], [0, h // 2, w // 2, h - 1], [w // 2, h // 2, w - 1, h - 1],
        ], np.float32)
        stuff_boxes = stuff_boxes[(stuff_boxes[:, 3] > stuff_boxes[:, 1]) & (stuff_boxes[:, 2] > stuff_boxes[:, 0])]
        jit = np.concatenate([gt + rng.normal(0, 3, gt.shape) for _ in range(3)] + [gt, stuff_boxes], 0)
        n_rand = max(0, 64 - len(jit))
        rx1 = rng.uniform(0, w * 0.7, n_rand)
        ry1 = rng.uniform(0, h * 0.7, n_rand)
        rnd_boxes = np.stack([rx1, ry1, rx1 + rng.uniform(16, w * 0.3, n_rand), ry1 + rng.uniform(16, h * 0.3, n_rand)],
                             1)
        boxes = np.concatenate([jit, rnd_boxes], 0).astype(np.float32)
        boxes = np.clip(boxes, [0, 0, 0, 0], [w - 1, h - 1, w - 1, h - 1])
        logits = np.sort(rng.uniform(0, 1, len(boxes)))[::-1].astype(np.float32)
        ids_list.append(info["id"])
        boxes_list.append(boxes)
        logits_list.append(logits)
        sp_list.append(sp.astype(np.int32))
        oh_list.append(oh_labels_from_boxes(boxes, sp.astype(np.int32), next_id))
    proposals = {"ids": ids_list, "boxes": boxes_list, "objectness_logits": logits_list, "superpixels": sp_list,
                 "oh_labels": oh_list, "bbox_mode": 0}
    return pan_maps, sem_maps, pan_json, proposals


def register_synthetic_panoptic(name: str, coco: Dict, images: Dict[int, np.ndarray], sem_maps: Dict,
                                pan_maps: Dict, pan_json: Dict, metadata: Dict) -> None:
    """Registers ``name``, a separated panoptic set (evaluator type
    ``coco_panoptic_seg``) whose records carry their pixels (``image``),
    stuff map (``sem_seg``) and panoptic id map (``pan_seg``), with
    ``metadata`` and the instance and panoptic json dicts."""

    def load():
        records = load_coco_json(coco, IMAGE_DIR, name)
        for r in records:
            r["image"], r["sem_seg"], r["pan_seg"] = images[r["image_id"]], sem_maps[r["image_id"]], pan_maps[r["image_id"]]
        return records

    DatasetCatalog.register(name, load)
    MetadataCatalog.get(name).set(json_file=coco, image_root=IMAGE_DIR, panoptic_json=pan_json,
                                  panoptic_root=PANOPTIC_DIR, evaluator_type="coco_panoptic_seg", **metadata)


def make_synthetic_cocovar(num: int = 12, seed: int = VARIED_SEED):
    """The dev script's ``cocovar`` tree in memory: the instance json, the
    pixels, the stuff and panoptic maps, the panoptic json and the proposal
    dict."""
    coco, images = make_synthetic_coco(num, seed, varied=True)
    pan_maps, sem_maps, pan_json, proposals = make_panoptic_and_proposals(coco)
    return coco, images, sem_maps, pan_maps, pan_json, proposals


def register_synthetic_cocovar(name: str, num: int = 12, seed: int = VARIED_SEED) -> Dict:
    """Registers ``name``: the ``cocovar`` scenes as a separated COCO
    panoptic set (``register_synthetic_panoptic``). Returns the proposal
    dict, to stand in DATASETS.PROPOSAL_FILES_TEST."""
    coco, images, sem_maps, pan_maps, pan_json, proposals = make_synthetic_cocovar(num, seed)
    register_synthetic_panoptic(name, coco, images, sem_maps, pan_maps, pan_json,
                                _get_builtin_metadata("coco_panoptic_separated"))
    return proposals
