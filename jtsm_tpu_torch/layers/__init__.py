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
from .blocks import CNNBlockBase, DepthwiseSeparableConv2d
from .deform_conv import DeformConv, ModulatedDeformConv, deform_conv2d
from .shape_spec import ShapeSpec
from ..ops.nms import batched_nms_rotated, nms_rotated
from ..ops.roi_align_rotated import ROIAlignRotated, roi_align_rotated
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
    "CNNBlockBase",
    "Conv2d",
    "DepthwiseSeparableConv2d",
    "DeformConv",
    "ModulatedDeformConv",
    "ROIAlignRotated",
    "batched_nms_rotated",
    "deform_conv2d",
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
    "nms_rotated",
    "normal",
    "roi_align_rotated",
    "variance_scaling",
]
