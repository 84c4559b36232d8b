"""COCO-format instance datasets, read from the json with no pycocotools,
and sem-seg ground truth paired with images by name (reference:
detectron2/data/datasets/coco.py:30 ``load_coco_json``, :209
``load_sem_seg``, :449 ``register_coco_instances``; JAX package
``data/datasets/coco.py:24,95,133``)."""

from __future__ import annotations

import json
import logging
import os
from collections import defaultdict
from typing import Dict, List, Optional, Union

from ...structures import BoxMode
from ..catalog import DatasetCatalog, MetadataCatalog

logger = logging.getLogger(__name__)


def load_json(json_file: Union[str, Dict]) -> Dict:
    """The COCO dict of ``json_file``: a path, or a dict already parsed
    (datasets made in memory, ``datasets.synthetic``)."""
    if isinstance(json_file, dict):
        return json_file
    with open(json_file) as f:
        return json.load(f)


def load_coco_json(
    json_file: Union[str, Dict],
    image_root: str,
    dataset_name: Optional[str] = None,
) -> List[dict]:
    """The standard list of dataset dicts, one per image. With
    ``dataset_name``, the json's categories also set the dataset's
    ``thing_classes`` and ``thing_dataset_id_to_contiguous_id`` (ids sorted,
    contiguous ids 0..K-1)."""
    coco = load_json(json_file)
    cats = sorted(coco.get("categories", []), key=lambda c: c["id"])
    id_map = {c["id"]: i for i, c in enumerate(cats)}
    if dataset_name is not None:
        meta = MetadataCatalog.get(dataset_name)
        meta.thing_classes = [c["name"] for c in cats]
        meta.thing_dataset_id_to_contiguous_id = id_map

    anns_by_image: Dict[int, List[dict]] = defaultdict(list)
    for ann in coco.get("annotations", []):
        anns_by_image[ann["image_id"]].append(ann)
    ann_keys = ["iscrowd", "bbox", "keypoints", "category_id"]

    dataset_dicts = []
    num_without_valid_segmentation = 0
    for img in coco["images"]:
        record = {
            "file_name": os.path.join(image_root, img["file_name"]),
            "height": img["height"],
            "width": img["width"],
            "image_id": img["id"],
        }
        objs = []
        for ann in anns_by_image.get(img["id"], []):
            obj = {k: ann[k] for k in ann_keys if k in ann}
            segm = ann.get("segmentation")
            if segm is not None:
                if not isinstance(segm, dict):
                    # polygons: drop those with fewer than 3 points
                    segm = [p for p in segm if len(p) % 2 == 0 and len(p) >= 6]
                    if len(segm) == 0:
                        num_without_valid_segmentation += 1
                        continue
                obj["segmentation"] = segm
            obj["bbox_mode"] = BoxMode.XYWH_ABS
            if id_map:
                if obj["category_id"] not in id_map:
                    continue
                obj["category_id"] = id_map[obj["category_id"]]
            objs.append(obj)
        record["annotations"] = objs
        dataset_dicts.append(record)
    if num_without_valid_segmentation > 0:
        logger.warning(f"Filtered out {num_without_valid_segmentation} instances without valid segmentation.")
    return dataset_dicts


def _walk(root: str, ext: str):
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(ext):
                yield os.path.relpath(os.path.join(dirpath, f), root)


def load_sem_seg(gt_root: str, image_root: str, gt_ext: str = "png", image_ext: str = "jpg") -> List[dict]:
    """{file_name, sem_seg_file_name} for each image under ``image_root``
    with a ground-truth file of the same base name under ``gt_root``, in
    the order of their relative paths."""

    def file2id(folder_path, file_path):
        return os.path.splitext(os.path.normpath(os.path.relpath(file_path, start=folder_path)))[0]

    input_files = sorted((os.path.join(image_root, f) for f in _walk(image_root, image_ext)),
                         key=lambda p: file2id(image_root, p))
    gt_files = sorted((os.path.join(gt_root, f) for f in _walk(gt_root, gt_ext)), key=lambda p: file2id(gt_root, p))
    assert len(gt_files) > 0, f"No annotations found in {gt_root}."
    if len(input_files) != len(gt_files):
        input_basenames = [os.path.basename(f)[: -len(image_ext) - 1] for f in input_files]
        gt_basenames = [os.path.basename(f)[: -len(gt_ext) - 1] for f in gt_files]
        intersect = sorted(set(input_basenames) & set(gt_basenames))
        input_files = [os.path.join(image_root, f + "." + image_ext) for f in intersect]
        gt_files = [os.path.join(gt_root, f + "." + gt_ext) for f in intersect]
    return [{"file_name": i, "sem_seg_file_name": g} for i, g in zip(input_files, gt_files)]


def register_coco_instances(name: str, metadata: dict, json_file: Union[str, Dict], image_root: str):
    """Registers ``name`` to load lazily from ``json_file`` (a path or a
    parsed dict) with its images under ``image_root``."""
    assert isinstance(name, str), name
    DatasetCatalog.register(name, lambda: load_coco_json(json_file, image_root, name))
    MetadataCatalog.get(name).set(json_file=json_file, image_root=image_root, evaluator_type="coco", **metadata)
