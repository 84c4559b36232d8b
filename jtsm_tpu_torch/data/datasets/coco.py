"""COCO-format instance datasets, read from the json with no pycocotools,
sem-seg ground truth paired with images by name, and any registered
dataset written back as a COCO dict (reference:
detectron2/data/datasets/coco.py:30 ``load_coco_json``, :209
``load_sem_seg``, :306 ``convert_to_coco_dict``, :415
``convert_to_coco_json``, :449 ``register_coco_instances``; JAX package
``data/datasets/coco.py:24,95,133,142,201``)."""

from __future__ import annotations

import json
import logging
import os
from collections import defaultdict
from typing import Dict, List, Optional, Union

import numpy as np

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


def convert_to_coco_dict(dataset_name: str) -> Dict:
    """The COCO dict of a registered dataset's records: the images, every
    annotation with its box as XYWH (rounded to 3 decimals), its area (the
    box's), ``iscrowd``, the dataset's own category id and, where the record
    has them, its segmentation and keypoints; the categories of
    ``thing_classes``. Image ids are the records' (their index where a
    record has none). Only 4-dim boxes: the rotated (XYWHA) form waits for
    the rotated family (ROADMAP)."""
    dataset_dicts = DatasetCatalog.get(dataset_name)
    metadata = MetadataCatalog.get(dataset_name)
    if hasattr(metadata, "thing_dataset_id_to_contiguous_id"):
        reverse = {v: k for k, v in metadata.thing_dataset_id_to_contiguous_id.items()}
        reverse_id = reverse.__getitem__
    else:
        reverse_id = lambda contiguous_id: contiguous_id  # noqa: E731
    categories = [{"id": reverse_id(i), "name": name} for i, name in enumerate(metadata.thing_classes)]
    coco_images, coco_annotations = [], []
    for image_dict in dataset_dicts:
        coco_image = {
            "id": image_dict.get("image_id", len(coco_images)),
            "width": int(image_dict["width"]),
            "height": int(image_dict["height"]),
            "file_name": str(image_dict["file_name"]),
        }
        coco_images.append(coco_image)
        for annotation in image_dict.get("annotations", []):
            bbox = annotation["bbox"]
            if isinstance(bbox, np.ndarray):
                bbox = bbox.tolist()
            if len(bbox) != 4:
                raise NotImplementedError(f"{dataset_name}: a {len(bbox)}-dim box; rotated (XYWHA) boxes wait for "
                                          "the rotated family (ROADMAP)")
            bbox = BoxMode.convert(bbox, annotation["bbox_mode"], BoxMode.XYWH_ABS)
            coco_annotation = {
                "id": len(coco_annotations) + 1,
                "image_id": coco_image["id"],
                "bbox": [round(float(x), 3) for x in bbox],
                "area": float(abs(bbox[2] * bbox[3])),
                "iscrowd": int(annotation.get("iscrowd", 0)),
                "category_id": int(reverse_id(annotation["category_id"])),
            }
            if "segmentation" in annotation:
                coco_annotation["segmentation"] = annotation["segmentation"]
            if "keypoints" in annotation:
                kpts = np.asarray(annotation["keypoints"]).reshape(-1).tolist()
                coco_annotation["keypoints"] = kpts
                coco_annotation["num_keypoints"] = sum(k > 0 for k in kpts[2::3])
            coco_annotations.append(coco_annotation)
    return {
        "info": {"description": "Automatically generated COCO json file."},
        "images": coco_images,
        "annotations": coco_annotations,
        "categories": categories,
        "licenses": None,
    }


def convert_to_coco_json(dataset_name: str, output_file: str, allow_cached: bool = True) -> None:
    """Writes ``convert_to_coco_dict(dataset_name)`` to ``output_file``
    (through a temporary file and ``os.replace``, so that a reader never
    sees half a file); with ``allow_cached`` an existing file is kept."""
    d = os.path.dirname(output_file)
    if d:
        os.makedirs(d, exist_ok=True)
    if os.path.exists(output_file) and allow_cached:
        logger.warning(f"Using previously cached COCO format annotations at '{output_file}'. "
                       "You need to clear the cache file if your dataset has been modified.")
        return
    logger.info(f"Converting annotations of dataset '{dataset_name}' to COCO format ...")
    coco_dict = convert_to_coco_dict(dataset_name)
    tmp_file = output_file + ".tmp"
    with open(tmp_file, "w") as f:
        json.dump(coco_dict, f)
    os.replace(tmp_file, output_file)
