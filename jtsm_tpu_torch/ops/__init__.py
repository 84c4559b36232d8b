from .box_regression import Box2BoxTransform
from .nms import batched_nms_mask, nms_mask
from .roi_align import (
    roi_align_batched,
    roi_align_multilevel,
    roi_align_multilevel_backward_plain,
    roi_align_multilevel_plain,
)

__all__ = [
    "Box2BoxTransform",
    "batched_nms_mask",
    "nms_mask",
    "roi_align_batched",
    "roi_align_multilevel",
    "roi_align_multilevel_backward_plain",
    "roi_align_multilevel_plain",
]
