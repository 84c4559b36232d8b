"""Polygon rasterisation for ground truth (JAX package
``structures/masks.py:27`` ``polygons_to_bitmask``) and mask resampling for
mask targets (``structures/masks.py:71`` ``crop_and_resize_masks``, which
replaces detectron2's route through the ROIAlign op).

The JAX package fills polygons with Pillow (``ImageDraw.polygon(xy,
outline=1, fill=1)``, which with the outline equal to the fill draws the
fill alone). Pillow is absent where the port runs on the card, so
``polygons_to_bitmask`` is Pillow's scan-line fill written out in Python
(``src/libImaging/Draw.c``: vertices truncated to int, ``add_edge``,
``polygon_generic`` with float32 crossings, ``hline``), with the joins
Pillow adds at top and bottom vertices found by experiment
(``_corner_joins``). It gives Pillow's pixels for axis-aligned rectangles
(every polygon of the synthetic COCO set) and for 400 random polygons
(``tests/test_torch_data.py``); degenerate ones, with a vertex repeated
apart or folded back on an edge, can still differ at a few pixels.
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
    ymax = min(ymax, height)
    for y in range(max(ymin, 0), ymax + 1):
        xx = []
        for cur in table:
            if not cur.ymin <= y <= cur.ymax:
                continue
            xx.append(cur.x_at(y))
            if y == cur.ymax and y < ymax:
                xx.append(xx[-1])
        xx.sort()
        for j in range(1, len(xx), 2):
            x_start, x_end = _round_up(xx[j - 1]), _round_down(xx[j])
            if x_end >= x_start:
                hline(x_start, y, x_end)
    for y, x0, x1 in _corner_joins(xy, ymax):
        hline(x0, y, x1)


def _corner_joins(xy: List[int], last_row: int):
    """The pixels Pillow adds at a top vertex, or at a bottom vertex on the
    last row ``last_row``, when both of its edges run the same way in x: on
    the vertex's row, from the vertex toward the adjacent row's crossings of
    the two edges, up to ``ROUND_UP(max + 1)`` on the left or
    ``ROUND_UP(min) - 1`` on the right. Derived by experiment against
    Pillow 12.1's fill (a bottom vertex above the last row ends two edges
    whose crossings the scan doubles, and gets no join); consecutive repeated
    vertices count once. Yields (row, x0, x1) spans."""
    pts = [(xy[2 * i], xy[2 * i + 1]) for i in range(len(xy) // 2)]
    pts = [q for i, q in enumerate(pts) if q != pts[i - 1]]
    n = len(pts)
    for i in range(n):
        (vx, vy), (px, py), (nx, ny) = pts[i], pts[i - 1], pts[(i + 1) % n]
        if py == vy or ny == vy or (py > vy) != (ny > vy):
            continue
        top = py > vy
        if not top and vy != last_row:
            continue
        dxa, dxb = _f32(_f32(px - vx) / _f32(py - vy)), _f32(_f32(nx - vx) / _f32(ny - vy))
        if dxa == 0 or dxb == 0 or (dxa > 0) != (dxb > 0):
            continue
        y = vy + (1 if top else -1)
        a = float(_f32(_f32(y - vy) * dxa) + _f32(vx))
        b = float(_f32(_f32(y - vy) * dxb) + _f32(vx))
        if top == (dxa < 0):  # the edges run left of the vertex on the adjacent row
            start = _round_up(max(a, b) + 1)
            if start <= vx:
                yield vy, start, vx
        else:
            end = _round_up(min(a, b)) - 1
            if end >= vx:
                yield vy, vx, end


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
