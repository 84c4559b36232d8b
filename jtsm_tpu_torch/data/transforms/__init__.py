from .augmentation import AugInput, Augmentation, AugmentationList, RandomFlip, ResizeShortestEdge
from .transform import (
    HFlipTransform,
    NoOpTransform,
    ResizeTransform,
    Transform,
    TransformList,
    VFlipTransform,
    resize_bilinear_float,
    resize_bilinear_uint8,
    resize_nearest,
)

__all__ = [
    "AugInput",
    "Augmentation",
    "AugmentationList",
    "HFlipTransform",
    "NoOpTransform",
    "RandomFlip",
    "ResizeShortestEdge",
    "ResizeTransform",
    "Transform",
    "TransformList",
    "VFlipTransform",
    "resize_bilinear_float",
    "resize_bilinear_uint8",
    "resize_nearest",
]
