"""Seeded Cityscapes-style scenes, in memory or written as a gtFine tree,
for the Cityscapes checks where Cityscapes is not at hand.

The scenes are those of ``synthetic.make_synthetic_coco`` (the same pixels:
1-4 rectangles a scene in the colour of their COCO class, on two stuff
bands, with noise), relabelled: the upper band is sky (label id 23), the
lower road (7), and each rectangle an object of one of the 8 thing
classes, at integer vertices: the class that ``CITY_TO_COCO`` maps its COCO
class to, or for the other COCO classes the thing class of the COCO
class's index mod 8. One object in five is a "group" label (a crowd), and
each scene has one "sky" polygon, which no instance split keeps. The
label-id and instance-id maps (instance ``id * 1000 + k``) are filled with
the port's rasteriser (``polygons_to_bitmask``), which agrees with
Pillow's on rectangles. The Mask R-CNN gate was trained on the 8 scenes of
seed 0, so on those its classifier rows of the ``CITY_TO_COCO`` classes
carry over (``checkpoint.select_class_rows``).

* ``make_synthetic_cityscapes(num, ...)``: one entry a scene: (image id,
  city, gtFine polygon json dict, pixels, label ids, instance ids);
* ``register_synthetic_cityscapes(name, ...)``: an instance split of those
  scenes (``cityscapes_instance``), records with their pixels;
  ``register_synthetic_cityscapes_sem_seg(name, ...)`` the semantic split
  (``cityscapes_sem_seg``) with its ``sem_seg`` label ids and
  ``instance_ids``; both read without Pillow;
* ``write_synthetic_cityscapes(root, split, ...)``: ``root/cityscapes/
  leftImg8bit/<split>/<city>/*_leftImg8bit.png`` and ``gtFine/<split>/
  <city>/*_gtFine_{polygons.json,labelIds.png,instanceIds.png}``, which
  ``builtin`` registers as ``cityscapes_fine_*_<split>`` (needs Pillow).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

from ...structures.masks import polygons_to_bitmask
from ..catalog import DatasetCatalog, MetadataCatalog
from .cityscapes import CITYSCAPES_STUFF_CLASSES, CITYSCAPES_THING_CLASSES, cityscapes_instance_record
from .cityscapes_labels import name2label
from .synthetic import COCO_80, make_synthetic_coco, stuff_split_row

# each thing class's stand-in among COCO's classes (a COCO category id):
# classes of the Mask R-CNN gate's training scenes, which it knows
CITY_TO_COCO = {"person": 49, "rider": 38, "car": 31, "truck": 2, "bus": 59, "train": 89, "motorcycle": 43,
                "bicycle": 37}
_FROM_COCO = {v: k for k, v in CITY_TO_COCO.items()}
CITIES = ("synthcity", "mocktown")


def city_class(coco_id: int) -> str:
    return _FROM_COCO.get(coco_id, CITYSCAPES_THING_CLASSES[COCO_80.index(coco_id) % 8])


def make_synthetic_cityscapes(num: int = 4, seed: int = 0, image_hw: Optional[Tuple[int, int]] = None):
    coco, images = make_synthetic_coco(num, seed, image_hw)
    scenes = []
    for i, info in enumerate(coco["images"]):
        h, w = info["height"], info["width"]
        city = CITIES[i % len(CITIES)]
        image_id = f"{city}_{i:06d}_{19 * i:06d}"
        label_ids = np.full((h, w), name2label["road"].id, np.int64)
        label_ids[: stuff_split_row(info)] = name2label["sky"].id
        instance_ids = label_ids.copy()
        objects = [{"label": "sky", "polygon": [[0, 0], [w // 3, 0], [w // 3, h // 8], [0, h // 8]]}]
        counts = {}
        for n, a in enumerate(a for a in coco["annotations"] if a["image_id"] == info["id"]):
            cls = city_class(a["category_id"])
            group = (n + i) % 5 == 4
            x, y, bw, bh = (int(round(v)) for v in a["bbox"])
            flat = [x, y, x + bw, y, x + bw, y + bh, x, y + bh]
            objects.append({"label": cls + "group" if group else cls,
                            "polygon": [[flat[j], flat[j + 1]] for j in range(0, len(flat), 2)]})
            m = polygons_to_bitmask([np.asarray(flat, np.float64)], h, w)
            lab = name2label[cls].id
            label_ids[m] = lab
            instance_ids[m] = lab if group else lab * 1000 + counts.get(lab, 0)
            counts[lab] = counts.get(lab, 0) + (not group)
        poly = {"imgHeight": h, "imgWidth": w, "objects": objects}
        scenes.append((image_id, city, poly, images[info["id"]], label_ids, instance_ids))
    return scenes


def _file_name(split: str, city: str, image_id: str) -> str:
    return os.path.join("cityscapes", "leftImg8bit", split, city, image_id + "_leftImg8bit.png")


def register_synthetic_cityscapes(name: str, num: int = 4, seed: int = 0,
                                  image_hw: Optional[Tuple[int, int]] = None) -> None:
    scenes = make_synthetic_cityscapes(num, seed, image_hw)

    def load():
        records = []
        for image_id, city, poly, pixels, _, _ in scenes:
            r = cityscapes_instance_record(_file_name("val", city, image_id), poly)
            r["image"] = pixels
            records.append(r)
        return records

    DatasetCatalog.register(name, load)
    MetadataCatalog.get(name).set(thing_classes=list(CITYSCAPES_THING_CLASSES), evaluator_type="cityscapes_instance")


def register_synthetic_cityscapes_sem_seg(name: str, num: int = 4, seed: int = 0,
                                          image_hw: Optional[Tuple[int, int]] = None) -> None:
    scenes = make_synthetic_cityscapes(num, seed, image_hw)
    DatasetCatalog.register(name, lambda: [
        {"file_name": _file_name("val", city, image_id), "image_id": image_id, "height": pixels.shape[0],
         "width": pixels.shape[1], "image": pixels, "sem_seg": labels, "instance_ids": inst}
        for image_id, city, _, pixels, labels, inst in scenes])
    MetadataCatalog.get(name).set(stuff_classes=list(CITYSCAPES_STUFF_CLASSES), evaluator_type="cityscapes_sem_seg",
                                  ignore_label=255)


def write_synthetic_cityscapes(root: str, split: str = "val", num: int = 4, seed: int = 0,
                               image_hw: Optional[Tuple[int, int]] = None) -> str:
    """Writes the split's tree under ``root``; returns ``root/cityscapes``."""
    from PIL import Image

    for image_id, city, poly, pixels, labels, inst in make_synthetic_cityscapes(num, seed, image_hw):
        img = os.path.join(root, _file_name(split, city, image_id))
        gt = os.path.join(root, "cityscapes", "gtFine", split, city, image_id + "_gtFine_")
        os.makedirs(os.path.dirname(img), exist_ok=True)
        os.makedirs(os.path.dirname(gt), exist_ok=True)
        Image.fromarray(pixels).save(img)
        Image.fromarray(labels.astype(np.uint8)).save(gt + "labelIds.png")
        Image.fromarray(inst.astype(np.uint16)).save(gt + "instanceIds.png")
        with open(gt + "polygons.json", "w") as f:
            json.dump(poly, f)
    return os.path.join(root, "cityscapes")
