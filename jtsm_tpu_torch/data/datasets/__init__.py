from . import builtin  # noqa: F401  registers the builtin splits
from .builtin import load_coco_panoptic_json, merge_to_panoptic, register_coco_panoptic
from .cityscapes import load_cityscapes_instances, load_cityscapes_semantic, register_cityscapes
from .coco import convert_to_coco_dict, convert_to_coco_json, load_coco_json, register_coco_instances
from .lvis import get_lvis_instances_meta, load_lvis_json, register_lvis_instances
from .pascal_voc import load_voc_instances, register_pascal_voc

__all__ = [
    "convert_to_coco_dict",
    "convert_to_coco_json",
    "get_lvis_instances_meta",
    "load_cityscapes_instances",
    "load_cityscapes_semantic",
    "load_coco_json",
    "load_coco_panoptic_json",
    "load_lvis_json",
    "load_voc_instances",
    "merge_to_panoptic",
    "register_cityscapes",
    "register_coco_instances",
    "register_coco_panoptic",
    "register_lvis_instances",
    "register_pascal_voc",
]
