"""LVIS instance datasets, read from the json as the COCO loader reads its
own (reference: detectron2/data/datasets/lvis.py:40; JAX package
``data/datasets/lvis.py:18,65,71``).

Category ids become ``category_id - 1`` (LVIS numbers them from 1, with no
gaps), ``thing_classes`` are each category's first synonym, a polygon is
kept when it has an even number of at least 6 coordinates, and a record
carries its image's ``not_exhaustive_category_ids`` and
``neg_category_ids``; no annotation sets ``iscrowd``.

The image path is the root joined with a bare file name: the last 16
characters of a v0.5 ``file_name`` (``COCO_val2014_000000397133.jpg`` ->
``000000397133.jpg``), or the last part of a v1 ``coco_url``. The JAX
package does so (``lvis.py:33-38``), and ``register_all_lvis`` roots both
at ``coco/``, so no ``train2017/`` or ``val2017/`` folder is in the path;
detectron2 takes the split folder from ``coco_url`` (ROADMAP §3). The port
copies the JAX package.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Optional, Union

from ...structures import BoxMode
from ..catalog import DatasetCatalog, MetadataCatalog
from .coco import load_json


def load_lvis_json(json_file: Union[str, Dict], image_root: str, dataset_name: Optional[str] = None) -> List[dict]:
    """The standard list of dataset dicts of an LVIS json (a path, or a dict
    already parsed); with ``dataset_name``, its ``thing_classes`` too."""
    lvis = load_json(json_file)
    if dataset_name is not None:
        MetadataCatalog.get(dataset_name).set(**get_lvis_instances_meta(lvis))
    anns_by_image = defaultdict(list)
    for ann in lvis.get("annotations", []):
        anns_by_image[ann["image_id"]].append(ann)
    dataset_dicts = []
    for img in lvis["images"]:
        if "file_name" in img:
            file_name = img["file_name"]
            if file_name.startswith("COCO"):
                file_name = file_name[-16:]
        else:
            file_name = img["coco_url"].split("/")[-1]
        record = {
            "file_name": os.path.join(image_root, file_name),
            "height": img["height"],
            "width": img["width"],
            "image_id": img["id"],
            "not_exhaustive_category_ids": img.get("not_exhaustive_category_ids", []),
            "neg_category_ids": img.get("neg_category_ids", []),
        }
        objs = []
        for ann in anns_by_image.get(img["id"], []):
            obj = {"bbox": ann["bbox"], "bbox_mode": BoxMode.XYWH_ABS, "category_id": ann["category_id"] - 1}
            if "segmentation" in ann:
                obj["segmentation"] = [p for p in ann["segmentation"] if len(p) % 2 == 0 and len(p) >= 6]
            objs.append(obj)
        record["annotations"] = objs
        dataset_dicts.append(record)
    return dataset_dicts


def get_lvis_instances_meta(lvis_json_dict: Dict) -> Dict:
    """``thing_classes``: each category's first synonym (its name, or its
    id, where it has none), in id order."""
    cats = sorted(lvis_json_dict.get("categories", []), key=lambda c: c["id"])
    return {"thing_classes": [c.get("synonyms", [c.get("name", str(c["id"]))])[0] for c in cats]}


def register_lvis_instances(name: str, metadata: dict, json_file: Union[str, Dict], image_root: str) -> None:
    """Registers ``name`` to load lazily from ``json_file`` (a path or a
    parsed dict), scored by ``LVISEvaluator`` (evaluator type ``lvis``)."""
    DatasetCatalog.register(name, lambda: load_lvis_json(json_file, image_root, name))
    MetadataCatalog.get(name).set(json_file=json_file, image_root=image_root, evaluator_type="lvis", **metadata)
