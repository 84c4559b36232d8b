"""The builtin splits, registered when this module is imported (reference:
detectron2/data/datasets/builtin.py; JAX package
``data/datasets/builtin.py:17,43,62,82,103,155,201,230,245,273,291,308,330-350``):
COCO instances and person keypoints; COCO panoptic, separated (instances
and stuff PNGs) and standard (``load_coco_panoptic_json``); the Pascal VOC
2007 and 2012 detection splits; LVIS v0.5 and v1; ADE20K-150; Cityscapes
instances, semantics and panoptic. Paths resolve under ``$JTSM_DATASETS``
(default ``./datasets``); nothing is read until a dataset is used. The WSL
web and mined-label splits are not registered (ROADMAP queue 1 item 6)."""

from __future__ import annotations

import copy
import json
import os
from typing import List, Optional

from ..catalog import DatasetCatalog, MetadataCatalog
from .builtin_meta import ADE20K_SEM_SEG_CATEGORIES, _get_builtin_metadata
from .cityscapes import register_cityscapes
from .cityscapes_panoptic import register_all_cityscapes_panoptic
from .coco import load_coco_json, load_sem_seg, register_coco_instances
from .lvis import register_lvis_instances
from .pascal_voc import register_pascal_voc

_PREDEFINED_SPLITS_COCO = {
    "coco_2017_train": ("coco/train2017", "coco/annotations/instances_train2017.json"),
    "coco_2017_val": ("coco/val2017", "coco/annotations/instances_val2017.json"),
    # the 8-image synthetic tree of dev/make_synthetic_coco.py uses this name
    "coco_2017_val_100": ("coco/val2017", "coco/annotations/instances_val2017_100.json"),
    "coco_2017_varied_100": ("cocovar/val2017", "cocovar/annotations/instances_val2017_100.json"),
    "coco_2017_test": ("coco/test2017", "coco/annotations/image_info_test2017.json"),
    "coco_2017_test-dev": ("coco/test2017", "coco/annotations/image_info_test-dev2017.json"),
    "coco_2014_train": ("coco/train2014", "coco/annotations/instances_train2014.json"),
    "coco_2014_val": ("coco/val2014", "coco/annotations/instances_val2014.json"),
    "coco_2014_minival": ("coco/val2014", "coco/annotations/instances_minival2014.json"),
    "coco_2014_minival_100": ("coco/val2014", "coco/annotations/instances_minival2014_100.json"),
    "coco_2014_valminusminival": ("coco/val2014", "coco/annotations/instances_valminusminival2014.json"),
}

# the person keypoint splits (metadata "coco_person": the 17 keypoints, their
# flip map and connection rules); the synthetic tree writes the _100 one
_PREDEFINED_SPLITS_COCO_PERSON = {
    "keypoints_coco_2017_train": ("coco/train2017", "coco/annotations/person_keypoints_train2017.json"),
    "keypoints_coco_2017_val": ("coco/val2017", "coco/annotations/person_keypoints_val2017.json"),
    "keypoints_coco_2017_val_100": ("coco/val2017", "coco/annotations/person_keypoints_val2017_100.json"),
}

# the panoptic splits: (panoptic PNGs, panoptic json, stuff sem-seg PNGs);
# the synthetic trees of dev/make_synthetic_coco.py use the _100 names
_PREDEFINED_SPLITS_COCO_PANOPTIC = {
    "coco_2017_train_panoptic": ("coco/panoptic_train2017", "coco/annotations/panoptic_train2017.json",
                                 "coco/panoptic_stuff_train2017"),
    "coco_2017_val_panoptic": ("coco/panoptic_val2017", "coco/annotations/panoptic_val2017.json",
                               "coco/panoptic_stuff_val2017"),
    "coco_2017_val_100_panoptic": ("coco/panoptic_val2017_100", "coco/annotations/panoptic_val2017_100.json",
                                   "coco/panoptic_stuff_val2017_100"),
    "coco_2017_varied_100_panoptic": ("cocovar/panoptic_val2017_100",
                                      "cocovar/annotations/panoptic_val2017_100.json",
                                      "cocovar/panoptic_stuff_val2017_100"),
}


def register_all_coco(root: str) -> None:
    for splits, meta in ((_PREDEFINED_SPLITS_COCO, "coco"), (_PREDEFINED_SPLITS_COCO_PERSON, "coco_person")):
        for name, (image_root, json_file) in splits.items():
            if name in DatasetCatalog:
                continue
            register_coco_instances(
                name, _get_builtin_metadata(meta), os.path.join(root, json_file), os.path.join(root, image_root)
            )


def register_coco_panoptic_separated(name: str, metadata: dict, image_root: str, panoptic_root: str,
                                     panoptic_json, sem_seg_root: str, instances_json) -> None:
    """Registers ``<name>_separated``, the COCO instances with each image's
    stuff PNG as ``sem_seg_file_name`` (evaluator type
    ``coco_panoptic_seg``), and ``<name>_stuffonly``, the stuff PNGs alone
    (``sem_seg``)."""
    panoptic_name = name + "_separated"

    def merged():
        detection = load_coco_json(instances_json, image_root, panoptic_name)
        sem = {os.path.basename(x["file_name"]).split(".")[0]: x["sem_seg_file_name"]
               for x in load_sem_seg(sem_seg_root, image_root)}
        for d in detection:
            key = os.path.basename(d["file_name"]).split(".")[0]
            if key in sem:
                d["sem_seg_file_name"] = sem[key]
        return detection

    DatasetCatalog.register(panoptic_name, merged)
    MetadataCatalog.get(panoptic_name).set(
        panoptic_root=panoptic_root, image_root=image_root, panoptic_json=panoptic_json,
        sem_seg_root=sem_seg_root, json_file=instances_json, evaluator_type="coco_panoptic_seg", **metadata,
    )
    stuff_name = name + "_stuffonly"
    DatasetCatalog.register(stuff_name, lambda: load_sem_seg(sem_seg_root, image_root))
    stuff_meta = dict(metadata)
    stuff_meta.setdefault("ignore_label", 255)
    stuff_meta.update(sem_seg_root=sem_seg_root, image_root=image_root, evaluator_type="sem_seg")
    MetadataCatalog.get(stuff_name).set(**stuff_meta)


def load_coco_panoptic_json(json_file: str, image_dir: str, gt_dir: str, meta: dict) -> List[dict]:
    """The standard panoptic records of a COCO panoptic json: the image
    (``.jpg`` of the PNG's name under ``image_dir``), ``pan_seg_file_name``
    (the id-encoded PNG) and ``segments_info`` with contiguous category ids
    and ``isthing`` (reference datasets/coco_panoptic.py:14-64)."""

    def convert_category_id(segment_info):
        cid = segment_info["category_id"]
        if cid in meta["thing_dataset_id_to_contiguous_id"]:
            return dict(segment_info, category_id=meta["thing_dataset_id_to_contiguous_id"][cid], isthing=True)
        return dict(segment_info, category_id=meta["stuff_dataset_id_to_contiguous_id"][cid], isthing=False)

    with open(json_file) as f:
        json_info = json.load(f)
    ret = [{
        "file_name": os.path.join(image_dir, os.path.splitext(ann["file_name"])[0] + ".jpg"),
        "image_id": int(ann["image_id"]),
        "pan_seg_file_name": os.path.join(gt_dir, ann["file_name"]),
        "segments_info": [convert_category_id(x) for x in ann["segments_info"]],
    } for ann in json_info["annotations"]]
    assert ret, f"No images found in {image_dir}!"
    return ret


def register_coco_panoptic(name: str, metadata: dict, image_root: str, panoptic_root: str, panoptic_json: str,
                           instances_json: Optional[str] = None) -> None:
    """Registers ``name``, a standard panoptic set (one record an image with
    its id-encoded PNG and ``segments_info``; the format Panoptic-DeepLab
    trains on; evaluator type ``coco_panoptic_seg``)."""
    DatasetCatalog.register(name, lambda: load_coco_panoptic_json(panoptic_json, image_root, panoptic_root, metadata))
    MetadataCatalog.get(name).set(panoptic_root=panoptic_root, image_root=image_root, panoptic_json=panoptic_json,
                                  json_file=instances_json, evaluator_type="coco_panoptic_seg", ignore_label=255,
                                  label_divisor=1000, **metadata)


def merge_to_panoptic(detection_dicts: List[dict], sem_seg_dicts: List[dict]) -> List[dict]:
    """Each detection record updated with the sem-seg record of its
    ``file_name`` (reference datasets/coco_panoptic.py:169)."""
    sem_seg_file_to_entry = {x["file_name"]: x for x in sem_seg_dicts}
    assert len(sem_seg_file_to_entry) > 0
    results = []
    for det_dict in detection_dicts:
        dic = copy.copy(det_dict)
        dic.update(sem_seg_file_to_entry[dic["file_name"]])
        results.append(dic)
    return results


def register_all_coco_panoptic(root: str) -> None:
    """Each panoptic split twice: ``<prefix>_separated`` (with
    ``<prefix>_stuffonly``) and the standard ``<prefix>``."""
    for prefix, (panoptic_root, panoptic_json, semantic_root) in _PREDEFINED_SPLITS_COCO_PANOPTIC.items():
        if prefix + "_separated" in DatasetCatalog:
            continue
        image_root, instances_json = _PREDEFINED_SPLITS_COCO[prefix[: -len("_panoptic")]]
        image_root, instances_json = os.path.join(root, image_root), os.path.join(root, instances_json)
        panoptic_root, panoptic_json = os.path.join(root, panoptic_root), os.path.join(root, panoptic_json)
        register_coco_panoptic_separated(
            prefix, _get_builtin_metadata("coco_panoptic_separated"), image_root, panoptic_root, panoptic_json,
            os.path.join(root, semantic_root), instances_json,
        )
        register_coco_panoptic(prefix, _get_builtin_metadata("coco_panoptic_standard"), image_root, panoptic_root,
                               panoptic_json, instances_json)


_PREDEFINED_SPLITS_VOC = (
    ("voc_2007_trainval", "VOC2007", "trainval", 2007),
    ("voc_2007_train", "VOC2007", "train", 2007),
    ("voc_2007_val", "VOC2007", "val", 2007),
    ("voc_2007_test", "VOC2007", "test", 2007),
    ("voc_2012_trainval", "VOC2012", "trainval", 2012),
    ("voc_2012_train", "VOC2012", "train", 2012),
    ("voc_2012_val", "VOC2012", "val", 2012),
)


def register_all_pascal_voc(root: str) -> None:
    for name, dirname, split, year in _PREDEFINED_SPLITS_VOC:
        if name in DatasetCatalog:
            continue
        register_pascal_voc(name, os.path.join(root, dirname), split, year)


_PREDEFINED_SPLITS_LVIS = {
    "lvis_v1_train": ("coco/", "lvis/lvis_v1_train.json"),
    "lvis_v1_val": ("coco/", "lvis/lvis_v1_val.json"),
    "lvis_v0.5_train": ("coco/", "lvis/lvis_v0.5_train.json"),
    "lvis_v0.5_val": ("coco/", "lvis/lvis_v0.5_val.json"),
}


def register_all_lvis(root: str) -> None:
    """The LVIS splits, their images under ``coco/`` (see
    ``datasets.lvis`` on the image path)."""
    for name, (image_root, json_file) in _PREDEFINED_SPLITS_LVIS.items():
        if name in DatasetCatalog:
            continue
        register_lvis_instances(name, {}, os.path.join(root, json_file), os.path.join(root, image_root))


def register_all_ade20k(root: str) -> None:
    """``ade20k_sem_seg_{train,val}``: the ADE20K-150 images and their
    ``annotations_detectron2`` label PNGs (reference builtin.py:237)."""
    base = os.path.join(root, "ADEChallengeData2016")
    for split, dirname in (("train", "training"), ("val", "validation")):
        name = f"ade20k_sem_seg_{split}"
        if name in DatasetCatalog:
            continue
        image_dir = os.path.join(base, "images", dirname)
        gt_dir = os.path.join(base, "annotations_detectron2", dirname)
        DatasetCatalog.register(name, lambda x=image_dir, y=gt_dir: load_sem_seg(y, x, gt_ext="png", image_ext="jpg"))
        MetadataCatalog.get(name).set(stuff_classes=ADE20K_SEM_SEG_CATEGORIES[:], image_root=image_dir,
                                      sem_seg_root=gt_dir, evaluator_type="sem_seg", ignore_label=255)


_root = os.environ.get("JTSM_DATASETS", "datasets")
register_all_coco(_root)
register_all_coco_panoptic(_root)
register_all_lvis(_root)
register_all_ade20k(_root)
register_all_pascal_voc(_root)
register_cityscapes(_root)
register_all_cityscapes_panoptic(_root)
