from . import builtin  # noqa: F401  registers the builtin splits
from .coco import load_coco_json, register_coco_instances
from .pascal_voc import load_voc_instances, register_pascal_voc

__all__ = ["load_coco_json", "load_voc_instances", "register_coco_instances", "register_pascal_voc"]
