"""Multi-level region feature extraction (reference:
detectron2/modeling/poolers.py:22 ``assign_boxes_to_levels``, :98
``ROIPooler``; JAX package ``modeling/poolers.py``).

Every ROI carries its level into one ROIAlign call over the whole pyramid:
on the card that is one launch of the CUDA forward kernel, and in training
one of the backward kernel, for one level as for several; on the CPU it is
the plain versions. There is no other path.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

from ..ops.roi_align import roi_align_multilevel


def assign_boxes_to_levels(
    boxes: torch.Tensor,  # (R, 4)
    min_level: int,
    max_level: int,
    canonical_box_size: int = 224,
    canonical_level: int = 4,
) -> torch.Tensor:
    """FPN paper eq. (1), as level indices from 0 (reference poolers.py:22)."""
    area = (boxes[:, 2] - boxes[:, 0]).clamp(min=0) * (boxes[:, 3] - boxes[:, 1]).clamp(min=0)
    sqrt_area = torch.sqrt(area)
    lvl = torch.floor(
        canonical_level + torch.log2(sqrt_area.clamp(min=1e-8) / canonical_box_size + 1e-8)
    )
    lvl = lvl.clamp(min_level, max_level)
    return (lvl - min_level).to(torch.int32)


class ROIPooler:
    """Stateless: NCHW feature maps of the pooled levels and (R, 4) boxes
    in image coordinates -> (R, P, P, C) pooled features."""

    def __init__(
        self,
        output_size: int | Tuple[int, int],
        scales: Sequence[float],
        sampling_ratio: int,
        pooler_type: str = "ROIAlignV2",
        canonical_box_size: int = 224,
        canonical_level: int = 4,
    ):
        if pooler_type not in ("ROIAlign", "ROIAlignV2"):
            raise NotImplementedError(f"pooler type {pooler_type!r} is not ported yet")
        self.output_size = (
            (output_size, output_size) if isinstance(output_size, int) else tuple(output_size)
        )
        self.scales = tuple(scales)
        self.sampling_ratio = int(sampling_ratio)
        self.aligned = pooler_type == "ROIAlignV2"
        self.min_level = -int(math.log2(self.scales[0]))
        self.max_level = -int(math.log2(self.scales[-1]))
        if self.max_level - self.min_level + 1 != len(self.scales):
            raise ValueError(f"pooler scales {self.scales} are not consecutive levels")
        self.canonical_box_size = canonical_box_size
        self.canonical_level = canonical_level

    def __call__(
        self,
        features: List[torch.Tensor],  # per level (B, C, Hi, Wi)
        boxes: torch.Tensor,  # (R, 4)
        batch_indices: torch.Tensor,  # (R,)
    ) -> torch.Tensor:
        if len(features) == 1:
            levels = torch.zeros(boxes.shape[0], dtype=torch.int32, device=boxes.device)
        else:
            levels = assign_boxes_to_levels(
                boxes, self.min_level, self.max_level,
                self.canonical_box_size, self.canonical_level,
            )
        # channels-last maps: a free view when the backbone ran channels-last
        maps = [f.permute(0, 2, 3, 1).contiguous() for f in features]
        return roi_align_multilevel(
            maps, self.scales, boxes.float().contiguous(),
            batch_indices.to(torch.int32).contiguous(), levels,
            self.output_size, self.sampling_ratio, self.aligned,
        )
