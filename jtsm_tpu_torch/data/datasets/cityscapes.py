"""Cityscapes fine annotations: the 8-class instance splits and the
semantic splits (reference: detectron2/data/datasets/cityscapes.py:53; JAX
package ``data/datasets/cityscapes.py:48,89,100``). cityscapesscripts is
not a dependency: the gtFine polygon json files are parsed here, as the JAX
package parses them.

An instance record holds each polygon of a thing class (a "group" label is
its class with ``iscrowd`` 1) as one segmentation polygon, with its box the
polygon's extent (XYXY_ABS); image ids are the file prefixes
(``frankfurt_000000_000294``). A semantic record names the
``*_gtFine_labelIds.png`` (label ids, not trainIds).
"""

from __future__ import annotations

import json
import logging
import os
from typing import List

import numpy as np

from ...structures import BoxMode
from ..catalog import DatasetCatalog, MetadataCatalog

logger = logging.getLogger(__name__)

# the 8 thing classes of the Cityscapes instance benchmark
CITYSCAPES_THING_CLASSES = ["person", "rider", "car", "truck", "bus", "train", "motorcycle", "bicycle"]
CITYSCAPES_STUFF_CLASSES = [
    "road", "sidewalk", "building", "wall", "fence", "pole", "traffic light", "traffic sign", "vegetation",
    "terrain", "sky", "person", "rider", "car", "truck", "bus", "train", "motorcycle", "bicycle",
]
IMAGE_SUFFIX = "_leftImg8bit.png"


def _files_in_split(image_dir: str, gt_dir: str):
    """(image, polygon json, labelIds PNG) of every image of a split, city
    by city and file by file in name order."""
    for city in sorted(os.listdir(image_dir)):
        city_img_dir = os.path.join(image_dir, city)
        if not os.path.isdir(city_img_dir):
            continue
        for basename in sorted(os.listdir(city_img_dir)):
            if not basename.endswith(IMAGE_SUFFIX):
                continue
            prefix = basename[: -len(IMAGE_SUFFIX)]
            yield (os.path.join(city_img_dir, basename),
                   os.path.join(gt_dir, city, prefix + "_gtFine_polygons.json"),
                   os.path.join(gt_dir, city, prefix + "_gtFine_labelIds.png"))


def cityscapes_instance_record(file_name: str, poly: dict) -> dict:
    """The instance record of one image from its parsed gtFine polygon
    json."""
    record = {
        "file_name": file_name,
        "image_id": os.path.basename(file_name)[: -len(IMAGE_SUFFIX)],
        "height": poly["imgHeight"],
        "width": poly["imgWidth"],
    }
    annos = []
    for obj in poly.get("objects", []):
        label = obj["label"]
        iscrowd = 0
        if label.endswith("group"):
            label, iscrowd = label[: -len("group")], 1
        if label not in CITYSCAPES_THING_CLASSES:
            continue
        pts = np.asarray(obj["polygon"], dtype=np.float64).reshape(-1)
        if pts.size < 6:
            continue
        xs, ys = pts[0::2], pts[1::2]
        annos.append({
            "category_id": CITYSCAPES_THING_CLASSES.index(label),
            "bbox": [xs.min(), ys.min(), xs.max(), ys.max()],
            "bbox_mode": BoxMode.XYXY_ABS,
            "segmentation": [pts.tolist()],
            "iscrowd": iscrowd,
        })
    record["annotations"] = annos
    return record


def load_cityscapes_instances(image_dir: str, gt_dir: str) -> List[dict]:
    """The instance records of the images under ``image_dir`` (``<city>/
    *_leftImg8bit.png``) that have a polygon json under ``gt_dir``."""
    dataset_dicts = []
    for img_file, poly_file, _ in _files_in_split(image_dir, gt_dir):
        if not os.path.exists(poly_file):
            continue
        with open(poly_file) as f:
            dataset_dicts.append(cityscapes_instance_record(img_file, json.load(f)))
    return dataset_dicts


def load_cityscapes_semantic(image_dir: str, gt_dir: str) -> List[dict]:
    """{file_name, sem_seg_file_name} of the images with a labelIds PNG."""
    return [{"file_name": img_file, "sem_seg_file_name": label_file}
            for img_file, _, label_file in _files_in_split(image_dir, gt_dir) if os.path.exists(label_file)]


def register_cityscapes(root: str) -> None:
    """``cityscapes_fine_instance_seg_{train,val,test}`` (evaluator type
    ``cityscapes_instance``) and ``cityscapes_fine_sem_seg_{train,val,test}``
    (``cityscapes_sem_seg``) under ``root/cityscapes``."""
    for split in ("train", "val", "test"):
        img_dir = os.path.join(root, "cityscapes", "leftImg8bit", split)
        gt_dir = os.path.join(root, "cityscapes", "gtFine", split)
        inst_name = f"cityscapes_fine_instance_seg_{split}"
        if inst_name not in DatasetCatalog:
            DatasetCatalog.register(inst_name, lambda i=img_dir, g=gt_dir: load_cityscapes_instances(i, g))
            MetadataCatalog.get(inst_name).set(thing_classes=list(CITYSCAPES_THING_CLASSES),
                                               evaluator_type="cityscapes_instance", image_dir=img_dir, gt_dir=gt_dir)
        sem_name = f"cityscapes_fine_sem_seg_{split}"
        if sem_name not in DatasetCatalog:
            DatasetCatalog.register(sem_name, lambda i=img_dir, g=gt_dir: load_cityscapes_semantic(i, g))
            MetadataCatalog.get(sem_name).set(stuff_classes=list(CITYSCAPES_STUFF_CLASSES),
                                              evaluator_type="cityscapes_sem_seg", ignore_label=255,
                                              image_dir=img_dir, gt_dir=gt_dir)
