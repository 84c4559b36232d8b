"""Polygon rasterisation for ground truth (JAX package
``structures/masks.py:27`` ``polygons_to_bitmask``) and mask resampling for
mask targets (``structures/masks.py:71`` ``crop_and_resize_masks``, which
replaces detectron2's route through the ROIAlign op).

The JAX package fills polygons with Pillow (``ImageDraw.polygon(xy,
outline=1, fill=1)``, which with the outline equal to the fill draws the
fill alone). Pillow is absent where the port runs on the card, so
``polygons_to_bitmask`` is Pillow's scan-line fill written out in Python
(``src/libImaging/Draw.c``: vertices truncated to int, ``add_edge``,
``polygon_generic`` with float32 crossings, ``hline``). It gives Pillow's
pixels for axis-aligned rectangles (every polygon of the synthetic COCO
set); for other polygons its corner joins can differ from Pillow's at a
few vertex pixels (111 of 447,275 over 400 random polygons,
``tests/test_torch_data.py``).
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

_f32 = np.float32


class _Edge:
    __slots__ = ("x0", "y0", "xmin", "xmax", "ymin", "ymax", "dx")

    def __init__(self, x0: int, y0: int, x1: int, y1: int):
        self.xmin, self.xmax = (x0, x1) if x0 <= x1 else (x1, x0)
        self.ymin, self.ymax = (y0, y1) if y0 <= y1 else (y1, y0)
        self.dx = _f32(0.0) if y0 == y1 else _f32(_f32(x1 - x0) / _f32(y1 - y0))
        self.x0, self.y0 = x0, y0

    def x_at(self, y: int):
        """The edge's crossing of row ``y``, in float32 as in C."""
        return _f32(_f32(y - self.y0) * self.dx) + _f32(self.x0)


def _round_up(f) -> int:  # Draw.c ROUND_UP
    return math.floor(_f32(f + _f32(0.5))) if f >= 0 else -math.floor(_f32(abs(f) + _f32(0.5)))


def _round_down(f) -> int:  # Draw.c ROUND_DOWN
    return math.ceil(_f32(f - _f32(0.5))) if f >= 0 else -math.ceil(_f32(abs(f) - _f32(0.5)))


def _roundf(f) -> float:  # C roundf: halves away from zero
    return math.floor(f + 0.5) if f >= 0 else -math.floor(-f + 0.5)


def _fill_polygon(mask: np.ndarray, xy: List[int]) -> None:
    """Pillow's ``ImagingDrawPolygon`` with ``fill`` set, on a bool mask."""
    height, width = mask.shape
    count = len(xy) // 2
    edges: List[_Edge] = []
    for i in range(count - 1):
        x0, y0, x1, y1 = xy[2 * i: 2 * i + 4]
        if y0 == y1 and i != 0 and y0 == xy[2 * i - 1]:
            # a horizontal edge right after another one going the same way
            if x1 > x0 > xy[2 * i - 2]:
                edges[-1].xmax = x1
                continue
            if x1 < x0 < xy[2 * i - 2]:
                edges[-1].xmin = x1
                continue
        edges.append(_Edge(x0, y0, x1, y1))
    last = 2 * (count - 1)
    if xy[last] != xy[0] or xy[last + 1] != xy[1]:
        edges.append(_Edge(xy[last], xy[last + 1], xy[0], xy[1]))

    def hline(x0: int, y: int, x1: int) -> None:
        if 0 <= y < height and x0 < width and x1 >= 0:
            x0, x1 = max(x0, 0), min(x1, width - 1)
            if x0 <= x1:
                mask[y, x0: x1 + 1] = True

    ymin, ymax = height - 1, 0
    table = []
    for e in edges:
        ymin, ymax = min(ymin, e.ymin), max(ymax, e.ymax)
        if e.ymin == e.ymax:
            hline(e.xmin, e.ymin, e.xmax)
        else:
            table.append(e)
    for y in range(max(ymin, 0), min(ymax, height) + 1):
        xx = []
        for i, cur in enumerate(table):
            if not cur.ymin <= y <= cur.ymax:
                continue
            xx.append(cur.x_at(y))
            if y == cur.ymax and y < ymax:
                xx.append(xx[-1])
            elif cur.dx != 0 and len(xx) % 2 == 1 and _roundf(xx[-1]) == xx[-1]:
                # join a corner that the next (or, on the last row, the
                # previous) row would leave detached
                for k in range(i):
                    other = table[k]
                    if (cur.dx > 0 and other.dx <= 0) or (cur.dx < 0 and other.dx >= 0):
                        continue
                    if xx[-1] != other.x_at(y):
                        continue
                    offset = -1 if y == ymax else 1
                    a, b = float(cur.x_at(y + offset)), float(other.x_at(y + offset))
                    if y == cur.ymax:
                        v = max(a, b) + 1 if cur.dx > 0 else min(a, b) - 1
                    else:
                        v = min(a, b) if cur.dx > 0 else max(a, b) + 1
                    if k < len(xx):  # C writes slot k of its buffer; a slot past the crossings is unread
                        xx[k] = _f32(v)
                    break
        xx.sort()
        for j in range(1, len(xx), 2):
            x_start, x_end = _round_up(xx[j - 1]), _round_down(xx[j])
            if x_end >= x_start:
                hline(x_start, y, x_end)


def polygons_to_bitmask(polygons: List[np.ndarray], height: int, width: int) -> np.ndarray:
    """Fill polygons (flat x, y lists) into a (height, width) bool mask, as
    the JAX package's Pillow fill does; polygons of fewer than 3 points are
    skipped."""
    mask = np.zeros((height, width), dtype=bool)
    for p in polygons:
        p = np.asarray(p, dtype=np.float64).reshape(-1)
        if p.size < 6:
            continue
        _fill_polygon(mask, [int(v) for v in p[: p.size // 2 * 2]])
    return mask


def _axis_weights(c0: torch.Tensor, bin_size: torch.Tensor, s: int, m: int) -> torch.Tensor:
    """(N, s, m) bilinear hat weights of one sample at the centre of each of
    the s output bins, over the m input cells; taps outside [0, m) match no
    cell and so weigh nothing (zero padding)."""
    centres = torch.arange(s, dtype=torch.float32, device=c0.device) + 0.5
    coords = c0[:, None] + centres * bin_size[:, None] - 0.5
    lo = torch.floor(coords)
    f = coords - lo
    lo = lo.to(torch.int64)[..., None]
    k = torch.arange(m, device=c0.device)
    zero = torch.zeros((), dtype=torch.float32, device=c0.device)
    return torch.where(k == lo, (1.0 - f)[..., None], zero) + torch.where(k == lo + 1, f[..., None], zero)


def crop_and_resize_masks(masks: torch.Tensor, boxes: torch.Tensor, mask_size: int) -> torch.Tensor:
    """Bilinear crop of (N, H, W) masks to (N, S, S) by the aligned ROIAlign
    convention (half-pixel centres, one sample per bin), as two batched
    products with separable hat-weight matrices. ``boxes`` (N, 4) are in
    the masks' pixel frame. Plain PyTorch: float32 products, which stay
    float32 on the card with TF32 off."""
    s = mask_size
    h, w = masks.shape[-2:]
    wy = _axis_weights(boxes[:, 1], (boxes[:, 3] - boxes[:, 1]) / s, s, h)
    wx = _axis_weights(boxes[:, 0], (boxes[:, 2] - boxes[:, 0]) / s, s, w)
    tmp = torch.einsum("nih,nhw->niw", wy, masks.to(torch.float32))
    return torch.einsum("njw,niw->nij", wx, tmp)
