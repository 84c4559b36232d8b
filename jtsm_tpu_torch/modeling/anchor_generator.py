"""Anchor generation (reference: detectron2/modeling/anchor_generator.py:81
``DefaultAnchorGenerator``; JAX package ``modeling/anchor_generator.py``).

Anchors depend only on the feature shapes: they are computed with numpy and
kept per (grid sizes, device)."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def _broadcast_params(params, num_features: int, name: str):
    if not isinstance(params, (list, tuple)) or not params:
        raise ValueError(f"{name} must be a non-empty list")
    if not isinstance(params[0], (list, tuple)):
        return [list(params)] * num_features
    if len(params) == 1:
        return list(params) * num_features
    if len(params) != num_features:
        raise ValueError(f"Got {name} of length {len(params)} for {num_features} features")
    return [list(p) for p in params]


def generate_cell_anchors(
    sizes: Sequence[float] = (32, 64, 128, 256, 512),
    aspect_ratios: Sequence[float] = (0.5, 1, 2),
) -> np.ndarray:
    """(A, 4) XYXY anchors centered at (0, 0) (reference :154)."""
    anchors = []
    for size in sizes:
        area = size**2.0
        for ar in aspect_ratios:
            w = math.sqrt(area / ar)
            h = ar * w
            anchors.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.asarray(anchors, dtype=np.float32)


class DefaultAnchorGenerator:
    box_dim = 4

    def __init__(self, sizes, aspect_ratios, strides, offset: float = 0.0):
        self.strides = list(strides)
        n = len(self.strides)
        sizes = _broadcast_params(sizes, n, "sizes")
        aspect_ratios = _broadcast_params(aspect_ratios, n, "aspect_ratios")
        self.cell_anchors = [generate_cell_anchors(s, a) for s, a in zip(sizes, aspect_ratios)]
        self.offset = offset
        self._cache: Dict[Tuple, List[torch.Tensor]] = {}

    @classmethod
    def from_config(cls, cfg, input_shape):
        return cls(
            sizes=cfg.MODEL.ANCHOR_GENERATOR.SIZES,
            aspect_ratios=cfg.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS,
            strides=[x.stride for x in input_shape],
            offset=cfg.MODEL.ANCHOR_GENERATOR.OFFSET,
        )

    @property
    def num_anchors(self) -> List[int]:
        return [len(c) for c in self.cell_anchors]

    def __call__(self, grid_sizes: List[Tuple[int, int]], device) -> List[torch.Tensor]:
        """Per level (Hi * Wi * A, 4) anchors, location-major."""
        key = (tuple(grid_sizes), str(device))
        if key not in self._cache:
            anchors = []
            for (h, w), stride, cell in zip(grid_sizes, self.strides, self.cell_anchors):
                shift_x, shift_y = np.meshgrid(
                    (np.arange(w, dtype=np.float32) + self.offset) * stride,
                    (np.arange(h, dtype=np.float32) + self.offset) * stride,
                )
                sx, sy = shift_x.reshape(-1), shift_y.reshape(-1)
                shifts = np.stack([sx, sy, sx, sy], axis=1)
                a = (shifts[:, None, :] + cell[None, :, :]).reshape(-1, 4)
                anchors.append(torch.from_numpy(a).to(device))
            self._cache[key] = anchors
        return self._cache[key]


def build_anchor_generator(cfg, input_shape) -> DefaultAnchorGenerator:
    name = cfg.MODEL.ANCHOR_GENERATOR.NAME
    if name != "DefaultAnchorGenerator":
        raise NotImplementedError(f"anchor generator {name!r} is not ported yet")
    return DefaultAnchorGenerator.from_config(cfg, input_shape)
