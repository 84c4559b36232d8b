"""The builtin COCO instance splits, the person keypoint splits and the
separated panoptic splits, and the Pascal VOC 2007 and 2012 detection
splits (reference: detectron2/data/datasets/builtin.py; JAX package
``data/datasets/builtin.py:17,43,62,82,103,245,273``), registered when this
module is imported. Paths resolve under ``$JTSM_DATASETS`` (default
``./datasets``); nothing is read until a dataset is used. The standard
panoptic variant (``load_coco_panoptic_json``) is not ported yet
(ROADMAP)."""

from __future__ import annotations

import os

from ..catalog import DatasetCatalog, MetadataCatalog
from .builtin_meta import _get_builtin_metadata
from .coco import load_coco_json, load_sem_seg, register_coco_instances
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


def register_all_coco_panoptic(root: str) -> None:
    for prefix, (panoptic_root, panoptic_json, semantic_root) in _PREDEFINED_SPLITS_COCO_PANOPTIC.items():
        if prefix + "_separated" in DatasetCatalog:
            continue
        image_root, instances_json = _PREDEFINED_SPLITS_COCO[prefix[: -len("_panoptic")]]
        register_coco_panoptic_separated(
            prefix, _get_builtin_metadata("coco_panoptic_separated"), os.path.join(root, image_root),
            os.path.join(root, panoptic_root), os.path.join(root, panoptic_json), os.path.join(root, semantic_root),
            os.path.join(root, instances_json),
        )


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


_root = os.environ.get("JTSM_DATASETS", "datasets")
register_all_coco(_root)
register_all_coco_panoptic(_root)
register_all_pascal_voc(_root)
