"""ShapeSpec (reference: detectron2/layers/shape_spec.py)."""

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ShapeSpec:
    channels: Optional[int] = None
    height: Optional[int] = None
    width: Optional[int] = None
    stride: Optional[int] = None
