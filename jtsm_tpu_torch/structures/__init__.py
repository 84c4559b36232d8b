from .boxes import BoxMode, box_area, clip_boxes, nonempty_boxes, pairwise_iou
from .instances import Instances
from .keypoints import heatmaps_to_keypoints, keypoints_to_heatmap
from .masks import PolygonMasks, bitmask_bounding_boxes, polygons_to_bitmask, rasterize_polygons_within_box
from .rotated_boxes import RotatedBoxes, pairwise_iou_rotated

__all__ = [
    "BoxMode",
    "Instances",
    "PolygonMasks",
    "RotatedBoxes",
    "bitmask_bounding_boxes",
    "box_area",
    "clip_boxes",
    "heatmaps_to_keypoints",
    "nonempty_boxes",
    "pairwise_iou",
    "pairwise_iou_rotated",
    "polygons_to_bitmask",
    "rasterize_polygons_within_box",
]
