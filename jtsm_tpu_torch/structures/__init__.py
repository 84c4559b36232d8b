from .boxes import BoxMode, box_area, clip_boxes, nonempty_boxes, pairwise_iou
from .masks import polygons_to_bitmask

__all__ = ["BoxMode", "box_area", "clip_boxes", "nonempty_boxes", "pairwise_iou", "polygons_to_bitmask"]
