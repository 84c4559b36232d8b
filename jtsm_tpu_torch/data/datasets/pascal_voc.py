"""Pascal VOC detection sets (reference:
detectron2/data/datasets/pascal_voc.py:26 ``load_voc_instances``, :78
``register_pascal_voc``; JAX package ``data/datasets/pascal_voc.py:25-76``).

A record keeps VOC's string ``image_id`` (the file id), the boxes in
XYXY_ABS with one pixel taken off ``xmin`` and ``ymin`` (VOC's 1-based
corners), and each object's ``difficult`` flag. The metadata keeps the
split's ``dirname``, ``split`` and ``year``; the evaluator type is
``pascal_voc``."""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from ...structures import BoxMode
from ..catalog import DatasetCatalog, MetadataCatalog

__all__ = ["CLASS_NAMES", "load_voc_instances", "register_pascal_voc", "voc_instance", "voc_metadata"]

CLASS_NAMES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


def voc_instance(name: str, difficult: int, bndbox) -> dict:
    """One annotation from a VOC object's class name, ``difficult`` flag
    and 1-based ``(xmin, ymin, xmax, ymax)``."""
    xmin, ymin, xmax, ymax = (float(v) for v in bndbox)
    return {
        "category_id": CLASS_NAMES.index(name),
        "bbox": [xmin - 1.0, ymin - 1.0, xmax, ymax],
        "bbox_mode": BoxMode.XYXY_ABS,
        "difficult": bool(difficult),
    }


def voc_metadata(dirname, split: str, year: int) -> dict:
    return dict(thing_classes=list(CLASS_NAMES), dirname=dirname, year=year, split=split,
                evaluator_type="pascal_voc")


def load_voc_instances(dirname: str, split: str):
    """The records of ``ImageSets/Main/<split>.txt`` under ``dirname``,
    from ``Annotations/<id>.xml``, with ``JPEGImages/<id>.jpg``."""
    with open(os.path.join(dirname, "ImageSets", "Main", split + ".txt")) as f:
        fileids = np.loadtxt(f, dtype=str, ndmin=1)
    dicts = []
    for fileid in fileids:
        fileid = str(fileid)
        with open(os.path.join(dirname, "Annotations", fileid + ".xml")) as f:
            tree = ET.parse(f)
        r = {
            "file_name": os.path.join(dirname, "JPEGImages", fileid + ".jpg"),
            "image_id": fileid,
            "height": int(tree.findall("./size/height")[0].text),
            "width": int(tree.findall("./size/width")[0].text),
        }
        instances = []
        for obj in tree.findall("object"):
            bndbox = obj.find("bndbox")
            instances.append(voc_instance(obj.find("name").text, int(obj.find("difficult").text),
                                          [float(bndbox.find(x).text) for x in ("xmin", "ymin", "xmax", "ymax")]))
        r["annotations"] = instances
        dicts.append(r)
    return dicts


def register_pascal_voc(name: str, dirname: str, split: str, year: int = 2007) -> None:
    DatasetCatalog.register(name, lambda: load_voc_instances(dirname, split))
    MetadataCatalog.get(name).set(**voc_metadata(dirname, split, year))
