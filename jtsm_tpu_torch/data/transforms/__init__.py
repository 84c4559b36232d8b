from .augmentation import AugInput, Augmentation, AugmentationList, ResizeShortestEdge
from .transform import (
    NoOpTransform,
    ResizeTransform,
    Transform,
    TransformList,
    resize_bilinear_float,
    resize_bilinear_uint8,
    resize_nearest,
)

__all__ = [
    "AugInput",
    "Augmentation",
    "AugmentationList",
    "NoOpTransform",
    "ResizeShortestEdge",
    "ResizeTransform",
    "Transform",
    "TransformList",
    "resize_bilinear_float",
    "resize_bilinear_uint8",
    "resize_nearest",
]
