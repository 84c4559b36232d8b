from .aspp import ASPP
from .batch_norm import (
    FrozenBatchNorm2d,
    GroupNorm32,
    LayerNormCF,
    NaiveSyncBatchNorm,
    batch_norms,
    batch_statistics,
    get_norm,
)
from .shape_spec import ShapeSpec
from .wrappers import (
    Conv2d,
    ConvTranspose2d,
    Linear,
    compute_dtype,
    exact_float32,
    interpolate_bilinear,
    interpolate_nearest,
    normal,
    variance_scaling,
)

__all__ = [
    "ASPP",
    "Conv2d",
    "ConvTranspose2d",
    "FrozenBatchNorm2d",
    "LayerNormCF",
    "NaiveSyncBatchNorm",
    "batch_norms",
    "batch_statistics",
    "Linear",
    "ShapeSpec",
    "compute_dtype",
    "exact_float32",
    "get_norm",
    "GroupNorm32",
    "interpolate_bilinear",
    "interpolate_nearest",
    "normal",
    "variance_scaling",
]
