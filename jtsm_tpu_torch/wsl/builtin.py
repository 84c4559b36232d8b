"""The VOC 2012 + SBD splits of the JTSM plane (reference:
projects/WSL/wsl/data/datasets/builtin.py:38-166, builtin_meta.py:186,289;
JAX package ``wsl/builtin.py:27-47,110``, ``wsl/voc_sbd.py:29-51``),
registered when ``jtsm_tpu_torch.wsl`` is imported, under
``$JTSM_DATASETS/VOC_SBD`` (default ``./datasets``): the instance splits and
the separated panoptic splits that the converters of the JAX package's
``wsl/voc_sbd.py`` write. The converters themselves, the web and the
mined-label splits are not ported yet (ROADMAP).

VOC has 20 thing classes (ids 1-20) and one stuff class, "background"
(id 21), coloured by the VOC palette.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from ..data.catalog import DatasetCatalog
from ..data.datasets.builtin import register_coco_panoptic_separated
from ..data.datasets.coco import register_coco_instances

VOC_CLASS_NAMES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


def voc_colormap(n: int = 256) -> np.ndarray:
    """The VOC palette, (n, 3) uint8: each index's bits, three at a time,
    reversed into the high bits of red, green and blue."""
    cmap = np.zeros((n, 3), dtype=np.uint8)
    for i in range(n):
        r = g = b = 0
        cid = i
        for j in range(8):
            r |= ((cid >> 0) & 1) << (7 - j)
            g |= ((cid >> 1) & 1) << (7 - j)
            b |= ((cid >> 2) & 1) << (7 - j)
            cid >>= 3
        cmap[i] = (r, g, b)
    return cmap


_CMAP = voc_colormap()
VOC_CATEGORIES: List[Dict] = [
    {"id": i + 1, "name": name, "isthing": 1, "color": _CMAP[i + 1].tolist()}
    for i, name in enumerate(VOC_CLASS_NAMES)
] + [{"id": 21, "name": "background", "isthing": 0, "color": _CMAP[0].tolist()}]


def _voc_sbd_instances_meta() -> dict:
    things = [c for c in VOC_CATEGORIES if c["isthing"]]
    return {
        "thing_classes": [c["name"] for c in things],
        "thing_colors": [c["color"] for c in things],
        "thing_dataset_id_to_contiguous_id": {c["id"]: i for i, c in enumerate(things)},
    }


def _voc_sbd_panoptic_separated_meta() -> dict:
    stuff = [c for c in VOC_CATEGORIES if not c["isthing"]]
    ret = {
        "stuff_classes": ["things"] + [c["name"] for c in stuff],
        "stuff_colors": [[82, 18, 128]] + [c["color"] for c in stuff],
        "stuff_dataset_id_to_contiguous_id": {c["id"]: i + 1 for i, c in enumerate(stuff)},
        "ignore_label": 255,
    }
    ret.update(_voc_sbd_instances_meta())
    return ret


_SPLITS_VOC_SBD = {
    "voc_2012_train_instance": "voc_2012_train_instance.json",
    "voc_2012_val_instance": "voc_2012_val_instance.json",
    "sbd_9118_instance": "sbd_9118_instance.json",
    "voc_2012_train_instance_pgt": "voc_2012_train_instance_pgt.json",
    "sbd_9118_instance_pgt": "sbd_9118_instance_pgt.json",
}
_SPLITS_VOC_SBD_PANOPTIC = ("voc_2012_train", "voc_2012_val", "sbd_9118")


def register_all_voc_sbd(root: str) -> None:
    base = os.path.join(root, "VOC_SBD")
    for name, json_name in _SPLITS_VOC_SBD.items():
        if name in DatasetCatalog:
            continue
        register_coco_instances(name, _voc_sbd_instances_meta(), os.path.join(base, "annotations", json_name),
                                os.path.join(base, "images"))
    for split in _SPLITS_VOC_SBD_PANOPTIC:
        name = f"{split}_panoptic"
        if name + "_separated" in DatasetCatalog:
            continue
        register_coco_panoptic_separated(
            name, _voc_sbd_panoptic_separated_meta(),
            image_root=os.path.join(base, "images"),
            panoptic_root=os.path.join(base, "annotations", "panoptic"),
            panoptic_json=os.path.join(base, "annotations", f"{split}_panoptic.json"),
            sem_seg_root=os.path.join(base, "annotations", "panoptic_stuff"),
            instances_json=os.path.join(base, "annotations", f"{split}_instance.json"),
        )


register_all_voc_sbd(os.environ.get("JTSM_DATASETS", "datasets"))
