from . import builtin  # noqa: F401  registers the builtin splits
from .coco import load_coco_json, register_coco_instances

__all__ = ["load_coco_json", "register_coco_instances"]
