"""The builtin COCO instance splits (reference:
detectron2/data/datasets/builtin.py; JAX package
``data/datasets/builtin.py:17,82``), registered when this module is
imported. Paths resolve under ``$JTSM_DATASETS`` (default ``./datasets``);
nothing is read until a dataset is used."""

from __future__ import annotations

import os

from ..catalog import DatasetCatalog
from .builtin_meta import _get_builtin_metadata
from .coco import register_coco_instances

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


def register_all_coco(root: str) -> None:
    for name, (image_root, json_file) in _PREDEFINED_SPLITS_COCO.items():
        if name in DatasetCatalog:
            continue
        register_coco_instances(
            name, _get_builtin_metadata("coco"), os.path.join(root, json_file), os.path.join(root, image_root)
        )


register_all_coco(os.environ.get("JTSM_DATASETS", "datasets"))
