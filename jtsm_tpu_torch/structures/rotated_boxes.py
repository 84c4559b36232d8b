"""Rotated boxes (cx, cy, w, h, angle in degrees, counter-clockwise) and
their exact IoU (reference: detectron2/structures/rotated_boxes.py
``RotatedBoxes`` and ``layers/csrc/box_iou_rotated``; JAX package
``structures/rotated_boxes.py:25-236``).

The IoU clips each pair's quadrilaterals against each other as the JAX
package does (a Sutherland-Hodgman clip with room for 8 vertices, the
same arithmetic in the same order, in float32), vectorised over pairs in
plain PyTorch. Two boxes whose circumscribed circles do not meet are
disjoint: their IoU is 0 and they are never clipped, so the work follows
the pairs that can overlap. The pairs are found row chunk by row chunk
(one ``nonzero`` each, a host sync) and clipped in chunks of
``PAIR_CHUNK``, which bounds the scratch memory (about 1 KB a pair) at
any problem size. The IoU carries no gradient.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

_MAX_VERTS = 8
# pairs clipped at once: about 2 GiB of scratch
PAIR_CHUNK = 1 << 21
# elements of one row chunk's candidate mask
_ROW_CHUNK_ELEMENTS = 1 << 24


def angle_mod(x: torch.Tensor, y: float) -> torch.Tensor:
    """``x`` modulo ``y`` with the divisor's sign, as ``jnp.remainder``
    computes it: the truncated remainder, moved by ``y`` where the signs
    differ."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to float32, as a fused multiply-add gives it
    (float32 products are exact in float64). XLA contracts the JAX
    package's ``a * b - c * d`` into ``fma(a, b, -(c * d))`` on the CPU;
    the port rounds the same way, so that near-degenerate clips (a box
    against itself) round as the JAX package's do."""
    return torch.addcmul(c.double(), a.double(), b.double()).float()


def rotated_box_corners(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 5) -> (..., 4, 2) corners, counter-clockwise (JAX :25). The
    cosine and sine are float64's rounded to float32 (XLA's are nearly
    always the correctly rounded ones)."""
    cx, cy, w, h, a = boxes.float().unbind(-1)
    theta = (a * (math.pi / 180.0)).double()
    c, s = torch.cos(theta).float()[..., None], torch.sin(theta).float()[..., None]
    dx, dy = w / 2.0, h / 2.0
    lx = torch.stack([dx, -dx, -dx, dx], -1)
    ly = torch.stack([dy, dy, -dy, -dy], -1)
    rot_x = fma32(lx, c, -(ly * s))
    rot_y = fma32(lx, s, ly * c)
    return torch.stack([rot_x + cx[..., None], rot_y + cy[..., None]], -1)


def _clip_by_halfplane(verts, count, p0, p1, idx):
    """One Sutherland-Hodgman step for P polygons (P, 8, 2) of ``count``
    vertices: keep what lies left of the edge p0 -> p1 (P, 2); each vertex
    emits itself if inside and the edge crossing if its successor lies on
    the other side, compacted in order (JAX :51)."""
    cap = verts.shape[1]
    edge = p1 - p0
    nxt = torch.where(idx + 1 >= count[:, None], torch.zeros_like(idx), idx + 1)
    v_nxt = torch.gather(verts, 1, nxt[..., None].expand(-1, -1, 2))

    def side(v):
        rel = v - p0[:, None, :]
        return fma32(edge[:, 0:1], rel[..., 1], -(edge[:, 1:2] * rel[..., 0]))

    s_cur, s_nxt = side(verts), side(v_nxt)
    in_cur, in_nxt = s_cur >= 0, s_nxt >= 0
    denom = s_cur - s_nxt
    t = torch.where(denom.abs() > 1e-12, s_cur / torch.where(denom == 0, torch.ones_like(denom), denom),
                    torch.zeros_like(denom))
    inter = fma32(v_nxt - verts, t[..., None], verts)
    active = idx < count[:, None]
    emits = torch.stack([in_cur & active, (in_cur ^ in_nxt) & active], -1).reshape(-1, 2 * cap)
    pts = torch.stack([verts, inter], 2).reshape(-1, 2 * cap, 2)
    new_count = emits.sum(1)
    pos = torch.cumsum(emits, 1) - 1
    slot = torch.where(emits & (pos < cap), pos, torch.full_like(pos, cap))
    out = verts.new_zeros((verts.shape[0], cap + 1, 2)).scatter_(1, slot[..., None].expand(-1, -1, 2), pts)
    return out[:, :cap], new_count.clamp(max=cap)


def _intersection_area(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """(P,) intersection areas of P pairs of convex quads (P, 4, 2)
    (JAX :104)."""
    p = c1.shape[0]
    verts = torch.cat([c1, c1.new_zeros((p, _MAX_VERTS - 4, 2))], 1)
    count = torch.full((p,), 4, dtype=torch.int64, device=c1.device)
    idx = torch.arange(_MAX_VERTS, device=c1.device)[None]
    for k in range(4):
        verts, count = _clip_by_halfplane(verts, count, c2[:, k], c2[:, (k + 1) % 4], idx)
    nxt = torch.where(idx + 1 >= count[:, None], torch.zeros_like(idx), idx + 1)
    v_nxt = torch.gather(verts, 1, nxt[..., None].expand(-1, -1, 2))
    live = (idx < count[:, None]).to(verts.dtype)
    cross = fma32(verts[..., 0], v_nxt[..., 1], -(v_nxt[..., 0] * verts[..., 1])) * live
    while cross.shape[1] > 1:  # XLA's order of the sum: halves, 8 -> 4 -> 2 -> 1
        half = cross.shape[1] // 2
        cross = cross[:, :half] + cross[:, half:]
    area = 0.5 * cross[:, 0].abs()
    return torch.where(count >= 3, area, torch.zeros_like(area))


def _pair_iou(c1, c2, area1, area2) -> torch.Tensor:
    inter = _intersection_area(c1, c2)
    union = area1 + area2 - inter
    iou = torch.where(union > 1e-12, inter / union.clamp(min=1e-12), torch.zeros_like(inter))
    return iou.clamp(0.0, 1.0)


class _Prepared:
    """What the IoU reads of a set of boxes: corners, areas, centres and
    circumscribed radii (float32)."""

    def __init__(self, boxes: torch.Tensor, live: Optional[torch.Tensor] = None):
        b = boxes.float()
        self.corners = rotated_box_corners(b)
        self.area = b[:, 2] * b[:, 3]
        self.center = b[:, :2]
        radius = 0.5 * torch.sqrt(b[:, 2] * b[:, 2] + b[:, 3] * b[:, 3])
        # a margin well past float32's rounding keeps the skip conservative
        self.reach = radius * (1 + 1e-4) + 1e-4
        if live is not None:
            self.reach = torch.where(live, self.reach, torch.full_like(self.reach, -math.inf))


def _near_pairs(a: _Prepared, b: _Prepared, r0: int, r1: int, upper: bool):
    """The (row, column) pairs of rows r0:r1 of ``a`` against ``b`` whose
    circles meet (and, with ``upper``, whose column lies past the row)."""
    d = a.center[r0:r1, None, :] - b.center[None, :, :]
    reach = a.reach[r0:r1, None] + b.reach[None, :]
    near = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] <= reach * reach) & (reach >= 0)
    if upper:
        cols = torch.arange(b.center.shape[0], device=near.device)
        near &= cols[None, :] > torch.arange(r0, r1, device=near.device)[:, None]
    return near.nonzero(as_tuple=True)


def _iou_of_pairs(a: _Prepared, b: _Prepared, ii: torch.Tensor, jj: torch.Tensor) -> torch.Tensor:
    out = a.area.new_empty(ii.shape[0])
    for p0 in range(0, ii.shape[0], PAIR_CHUNK):
        i, j = ii[p0:p0 + PAIR_CHUNK], jj[p0:p0 + PAIR_CHUNK]
        out[p0:p0 + PAIR_CHUNK] = _pair_iou(a.corners[i], b.corners[j], a.area[i], b.area[j])
    return out


def _row_chunk(n_cols: int) -> int:
    return max(1, _ROW_CHUNK_ELEMENTS // max(n_cols, 1))


def _iou_matrix(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    a, b = _Prepared(boxes1), _Prepared(boxes2)
    n, m = boxes1.shape[0], boxes2.shape[0]
    out = a.area.new_zeros((n, m))
    rows = _row_chunk(m)
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        ii, jj = _near_pairs(a, b, r0, r1, upper=False)
        out[r0 + ii, jj] = _iou_of_pairs(a, b, r0 + ii, jj)
    return out


@torch.no_grad()
def pairwise_iou_rotated(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Exact rotated IoU, (..., N, 5) x (..., M, 5) -> (..., N, M) in
    float32, the leading dimensions broadcast (JAX :119 on one pair of
    sets)."""
    lead = torch.broadcast_shapes(boxes1.shape[:-2], boxes2.shape[:-2])
    n, m = boxes1.shape[-2], boxes2.shape[-2]
    b1 = boxes1.expand(lead + (n, 5)).reshape(-1, n, 5)
    b2 = boxes2.expand(lead + (m, 5)).reshape(-1, m, 5)
    out = torch.stack([_iou_matrix(x, y) for x, y in zip(b1, b2)]) if b1.shape[0] else b1.new_zeros((0, n, m))
    return out.reshape(lead + (n, m))


@torch.no_grad()
def rotated_suppression(boxes: torch.Tensor, live: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """(N, 5) boxes in NMS order and their (N,) ``live`` mask -> (N, N)
    bool, True where row i's IoU with a later column j exceeds the
    threshold, both live (the upper triangle of the JAX package's
    ``iou > iou_threshold``, ``ops/nms.py:211``)."""
    a = _Prepared(boxes, live)
    n = boxes.shape[0]
    out = torch.zeros((n, n), dtype=torch.bool, device=boxes.device)
    rows = _row_chunk(n)
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        ii, jj = _near_pairs(a, a, r0, r1, upper=True)
        out[r0 + ii, jj] = _iou_of_pairs(a, a, r0 + ii, jj) > iou_threshold
    return out


class RotatedBoxes:
    """(N, 5) (cx, cy, w, h, angle) boxes (JAX :140; reference
    rotated_boxes.py:213)."""

    def __init__(self, tensor):
        device = tensor.device if torch.is_tensor(tensor) else torch.device("cpu")
        tensor = torch.as_tensor(tensor, dtype=torch.float32, device=device)
        if tensor.numel() == 0:
            tensor = tensor.reshape((0, 5))
        if tensor.ndim != 2 or tensor.shape[-1] != 5:
            raise ValueError(f"RotatedBoxes takes (N, 5), not {tuple(tensor.shape)}")
        self.tensor = tensor

    def clone(self) -> "RotatedBoxes":
        return RotatedBoxes(self.tensor.clone())

    def to(self, *args, **kwargs) -> "RotatedBoxes":
        return RotatedBoxes(self.tensor.to(*args, **kwargs))

    @property
    def device(self) -> torch.device:
        return self.tensor.device

    def area(self) -> torch.Tensor:
        return self.tensor[:, 2] * self.tensor[:, 3]

    def normalize_angles(self) -> "RotatedBoxes":
        """Angles into [-180, 180)."""
        t = self.tensor.clone()
        t[:, 4] = angle_mod(t[:, 4] + 180.0, 360.0) - 180.0
        return RotatedBoxes(t)

    def clip(self, box_size: Tuple[int, int], clip_angle_threshold: float = 1.0) -> "RotatedBoxes":
        """Clips the boxes within ``clip_angle_threshold`` degrees of
        axis-aligned to [0, w] x [0, h] (``box_size`` (h, w)); the others
        stay as they are, as in the reference."""
        h, w = box_size
        t = self.tensor
        a = angle_mod(t[:, 4] + 180.0, 360.0) - 180.0
        x1 = (t[:, 0] - t[:, 2] / 2.0).clamp(0, w)
        y1 = (t[:, 1] - t[:, 3] / 2.0).clamp(0, h)
        x2 = (t[:, 0] + t[:, 2] / 2.0).clamp(0, w)
        y2 = (t[:, 1] + t[:, 3] / 2.0).clamp(0, h)
        new = torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1, t[:, 4]], -1)
        return RotatedBoxes(torch.where((a.abs() <= clip_angle_threshold)[:, None], new, t))

    def nonempty(self, threshold: float = 0.0) -> torch.Tensor:
        return (self.tensor[:, 2] > threshold) & (self.tensor[:, 3] > threshold)

    def inside_box(self, box_size: Tuple[int, int], boundary_threshold: float = 0.0) -> torch.Tensor:
        """Whether each centre lies within the (h, w) image, widened by
        ``boundary_threshold``."""
        h, w = box_size
        cx, cy = self.tensor[:, 0], self.tensor[:, 1]
        t = boundary_threshold
        return (cx >= -t) & (cy >= -t) & (cx < w + t) & (cy < h + t)

    def get_centers(self) -> torch.Tensor:
        return self.tensor[:, :2]

    def scale(self, scale_x: float, scale_y: float) -> "RotatedBoxes":
        """The boxes under an anisotropic scaling, each refit as a rotated
        rectangle through its edges' midpoints (reference :390)."""
        return RotatedBoxes(scale_rotated(self.tensor, scale_x, scale_y))

    def __getitem__(self, item) -> "RotatedBoxes":
        if isinstance(item, int):
            return RotatedBoxes(self.tensor[item:item + 1])
        return RotatedBoxes(self.tensor[item])

    def __len__(self) -> int:
        return self.tensor.shape[0]

    def __repr__(self) -> str:
        return f"RotatedBoxes({self.tensor})"

    @classmethod
    def cat(cls, boxes_list: List["RotatedBoxes"]) -> "RotatedBoxes":
        if not boxes_list:
            return cls(torch.zeros((0, 5)))
        return cls(torch.cat([b.tensor for b in boxes_list], 0))


def scale_rotated(t: torch.Tensor, scale_x, scale_y) -> torch.Tensor:
    """(..., 5) rotated boxes scaled by ``scale_x`` and ``scale_y`` (numbers,
    or tensors that broadcast against ``t[..., 0]``): the centre scales, the
    width and height follow their edges' scaled directions, and the angle is
    re-derived from them (JAX :192, ``modeling/postprocessing.py:31-45``)."""
    theta = t[..., 4] * (math.pi / 180.0)
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([
        t[..., 0] * scale_x,
        t[..., 1] * scale_y,
        t[..., 2] * torch.sqrt((scale_x * c) ** 2 + (scale_y * s) ** 2),
        t[..., 3] * torch.sqrt((scale_x * s) ** 2 + (scale_y * c) ** 2),
        torch.atan2(scale_x * s, scale_y * c) * (180.0 / math.pi),
    ], -1)
