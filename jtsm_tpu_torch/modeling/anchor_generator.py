"""Anchor generation (reference: detectron2/modeling/anchor_generator.py:81
``DefaultAnchorGenerator``, :230 ``RotatedAnchorGenerator``; JAX package
``modeling/anchor_generator.py``).

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
        self.cell_anchors = self._make_cells(_broadcast_params(sizes, n, "sizes"),
                                             _broadcast_params(aspect_ratios, n, "aspect_ratios"))
        self.offset = offset
        self._cache: Dict[Tuple, List[torch.Tensor]] = {}

    def _make_cells(self, sizes, aspect_ratios) -> List[np.ndarray]:
        return [generate_cell_anchors(s, a) for s, a in zip(sizes, aspect_ratios)]

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

    @staticmethod
    def _shifts(sx: np.ndarray, sy: np.ndarray) -> np.ndarray:
        """Each location's shift of a cell anchor: (HW, box_dim)."""
        return np.stack([sx, sy, sx, sy], axis=1)

    def __call__(self, grid_sizes: List[Tuple[int, int]], device) -> List[torch.Tensor]:
        """Per level (Hi * Wi * A, box_dim) anchors, location-major."""
        key = (tuple(grid_sizes), str(device))
        if key not in self._cache:
            anchors = []
            for (h, w), stride, cell in zip(grid_sizes, self.strides, self.cell_anchors):
                shift_x, shift_y = np.meshgrid(
                    (np.arange(w, dtype=np.float32) + self.offset) * stride,
                    (np.arange(h, dtype=np.float32) + self.offset) * stride,
                )
                shifts = self._shifts(shift_x.reshape(-1), shift_y.reshape(-1))
                a = (shifts[:, None, :] + cell[None, :, :]).reshape(-1, self.box_dim)
                anchors.append(torch.from_numpy(a).to(device))
            self._cache[key] = anchors
        return self._cache[key]


class RotatedAnchorGenerator(DefaultAnchorGenerator):
    """(cx, cy, w, h, angle) anchors: every size, aspect ratio and angle
    at each location (JAX :107; reference :230), angles innermost."""

    box_dim = 5

    def __init__(self, sizes, aspect_ratios, strides, angles, offset: float = 0.0):
        self.angles = _broadcast_params(angles, len(strides), "angles")
        super().__init__(sizes, aspect_ratios, strides, offset)

    def _make_cells(self, sizes, aspect_ratios) -> List[np.ndarray]:
        return [self._cell_anchors(s, a, ang) for s, a, ang in zip(sizes, aspect_ratios, self.angles)]

    @classmethod
    def from_config(cls, cfg, input_shape):
        return cls(
            sizes=cfg.MODEL.ANCHOR_GENERATOR.SIZES,
            aspect_ratios=cfg.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS,
            strides=[x.stride for x in input_shape],
            angles=cfg.MODEL.ANCHOR_GENERATOR.ANGLES,
            offset=cfg.MODEL.ANCHOR_GENERATOR.OFFSET,
        )

    @staticmethod
    def _cell_anchors(sizes, aspect_ratios, angles) -> np.ndarray:
        anchors = []
        for size in sizes:
            area = size**2.0
            for ar in aspect_ratios:
                w = math.sqrt(area / ar)
                anchors.extend([0, 0, w, ar * w, a] for a in angles)
        return np.asarray(anchors, dtype=np.float32)

    @staticmethod
    def _shifts(sx: np.ndarray, sy: np.ndarray) -> np.ndarray:
        zeros = np.zeros_like(sx)
        return np.stack([sx, sy, zeros, zeros, zeros], axis=1)


def build_anchor_generator(cfg, input_shape):
    """The generator named by MODEL.ANCHOR_GENERATOR.NAME:
    ``DefaultAnchorGenerator`` or ``RotatedAnchorGenerator``."""
    name = cfg.MODEL.ANCHOR_GENERATOR.NAME
    if name == "RotatedAnchorGenerator":
        return RotatedAnchorGenerator.from_config(cfg, input_shape)
    if name != "DefaultAnchorGenerator":
        raise NotImplementedError(f"anchor generator {name!r} is not ported yet")
    return DefaultAnchorGenerator.from_config(cfg, input_shape)
