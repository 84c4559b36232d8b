from .boxes import BoxMode, box_area, clip_boxes, nonempty_boxes, pairwise_iou
from .instances import Instances
from .keypoints import heatmaps_to_keypoints, keypoints_to_heatmap
from .masks import PolygonMasks, bitmask_bounding_boxes, polygons_to_bitmask, rasterize_polygons_within_box

__all__ = [
    "BoxMode",
    "Instances",
    "PolygonMasks",
    "bitmask_bounding_boxes",
    "box_area",
    "clip_boxes",
    "heatmaps_to_keypoints",
    "nonempty_boxes",
    "pairwise_iou",
    "polygons_to_bitmask",
    "rasterize_polygons_within_box",
]
