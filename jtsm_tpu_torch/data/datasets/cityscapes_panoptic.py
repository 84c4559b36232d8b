"""Cityscapes panoptic splits (reference:
detectron2/data/datasets/cityscapes_panoptic.py:51,127; JAX package
``data/datasets/cityscapes_panoptic.py:44,97,111``), from the outputs of
cityscapesscripts' ``createPanopticImgs.py`` (the panoptic PNGs and json)
and ``createTrainIdLabelImgs.py`` (``*_labelTrainIds.png``).

Their evaluator type is ``cityscapes_panoptic_seg``, for which the JAX
package's ``build_evaluator`` has no branch, so these splits do not score
there; the port's raises a NotImplementedError that says so (ROADMAP §3).
Panoptic-DeepLab (ROADMAP queue 1 item 8) is their only user.
"""

from __future__ import annotations

import json
import logging
import os
from typing import List

from ..catalog import DatasetCatalog, MetadataCatalog

logger = logging.getLogger(__name__)

# the 19 evaluated classes: (dataset id, trainId, isthing, name, colour)
CITYSCAPES_CATEGORIES = [
    (7, 0, 0, "road", (128, 64, 128)),
    (8, 1, 0, "sidewalk", (244, 35, 232)),
    (11, 2, 0, "building", (70, 70, 70)),
    (12, 3, 0, "wall", (102, 102, 156)),
    (13, 4, 0, "fence", (190, 153, 153)),
    (17, 5, 0, "pole", (153, 153, 153)),
    (19, 6, 0, "traffic light", (250, 170, 30)),
    (20, 7, 0, "traffic sign", (220, 220, 0)),
    (21, 8, 0, "vegetation", (107, 142, 35)),
    (22, 9, 0, "terrain", (152, 251, 152)),
    (23, 10, 0, "sky", (70, 130, 180)),
    (24, 11, 1, "person", (220, 20, 60)),
    (25, 12, 1, "rider", (255, 0, 0)),
    (26, 13, 1, "car", (0, 0, 142)),
    (27, 14, 1, "truck", (0, 0, 70)),
    (28, 15, 1, "bus", (0, 60, 100)),
    (31, 16, 1, "train", (0, 80, 100)),
    (32, 17, 1, "motorcycle", (0, 0, 230)),
    (33, 18, 1, "bicycle", (119, 11, 32)),
]


def load_cityscapes_panoptic(image_dir: str, gt_dir: str, gt_json: str, meta: dict) -> List[dict]:
    """One record an annotated image: ``pan_seg_file_name``,
    ``segments_info`` with category ids mapped to trainIds, and
    ``sem_seg_file_name`` the image's ``*_gtFine_labelTrainIds.png``."""
    thing_map = meta["thing_dataset_id_to_contiguous_id"]
    stuff_map = meta["stuff_dataset_id_to_contiguous_id"]
    with open(gt_json) as f:
        json_info = json.load(f)
    img_to_file = {}
    for city in sorted(os.listdir(image_dir)):
        city_dir = os.path.join(image_dir, city)
        if not os.path.isdir(city_dir):
            continue
        for basename in sorted(os.listdir(city_dir)):
            if basename.endswith("_leftImg8bit.png"):
                img_to_file[basename[: -len("_leftImg8bit.png")]] = os.path.join(city_dir, basename)
    ret = []
    for ann in json_info["annotations"]:
        image_file = img_to_file.get(ann["image_id"])
        if image_file is None:
            continue
        segments_info = [dict(seg, category_id=thing_map[seg["category_id"]] if seg["category_id"] in thing_map
                              else stuff_map[seg["category_id"]]) for seg in ann["segments_info"]]
        sem_file = image_file.replace("leftImg8bit", "gtFine").rsplit(".", 1)[0] + "_labelTrainIds.png"
        ret.append({
            "file_name": image_file,
            "image_id": ann["image_id"],
            "sem_seg_file_name": sem_file,
            "pan_seg_file_name": os.path.join(gt_dir, ann["file_name"]),
            "segments_info": segments_info,
        })
    if not ret:
        logger.warning("No panoptic images found in %s", image_dir)
    return ret


_RAW_SPLITS = {
    "cityscapes_fine_panoptic_train": ("cityscapes/leftImg8bit/train", "cityscapes/gtFine/cityscapes_panoptic_train",
                                       "cityscapes/gtFine/cityscapes_panoptic_train.json"),
    "cityscapes_fine_panoptic_val": ("cityscapes/leftImg8bit/val", "cityscapes/gtFine/cityscapes_panoptic_val",
                                     "cityscapes/gtFine/cityscapes_panoptic_val.json"),
}


def cityscapes_panoptic_meta() -> dict:
    """The 19 classes as both things and stuff, with trainIds as the
    contiguous ids of each kind."""
    return {
        "thing_classes": [c[3] for c in CITYSCAPES_CATEGORIES],
        "thing_colors": [c[4] for c in CITYSCAPES_CATEGORIES],
        "stuff_classes": [c[3] for c in CITYSCAPES_CATEGORIES],
        "stuff_colors": [c[4] for c in CITYSCAPES_CATEGORIES],
        "thing_dataset_id_to_contiguous_id": {c[0]: c[1] for c in CITYSCAPES_CATEGORIES if c[2]},
        "stuff_dataset_id_to_contiguous_id": {c[0]: c[1] for c in CITYSCAPES_CATEGORIES if not c[2]},
    }


def register_all_cityscapes_panoptic(root: str) -> None:
    meta = cityscapes_panoptic_meta()
    for key, (image_dir, gt_dir, gt_json) in _RAW_SPLITS.items():
        if key in DatasetCatalog:
            continue
        image_dir, gt_dir, gt_json = (os.path.join(root, p) for p in (image_dir, gt_dir, gt_json))
        DatasetCatalog.register(key, lambda x=image_dir, y=gt_dir, z=gt_json: load_cityscapes_panoptic(x, y, z, meta))
        MetadataCatalog.get(key).set(panoptic_root=gt_dir, image_root=image_dir, panoptic_json=gt_json,
                                     gt_dir=gt_dir.replace("cityscapes_panoptic_", ""),
                                     evaluator_type="cityscapes_panoptic_seg", ignore_label=255, label_divisor=1000,
                                     **meta)
