from .batch_norm import FrozenBatchNorm2d, GroupNorm32, get_norm
from .shape_spec import ShapeSpec
from .wrappers import (
    Conv2d,
    ConvTranspose2d,
    Linear,
    compute_dtype,
    exact_float32,
    interpolate_bilinear,
    interpolate_nearest,
)

__all__ = [
    "Conv2d",
    "ConvTranspose2d",
    "FrozenBatchNorm2d",
    "Linear",
    "ShapeSpec",
    "compute_dtype",
    "exact_float32",
    "get_norm",
    "GroupNorm32",
    "interpolate_bilinear",
    "interpolate_nearest",
]
