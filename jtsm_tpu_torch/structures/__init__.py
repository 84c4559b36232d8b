from .boxes import box_area, clip_boxes, nonempty_boxes, pairwise_iou

__all__ = ["box_area", "clip_boxes", "nonempty_boxes", "pairwise_iou"]
