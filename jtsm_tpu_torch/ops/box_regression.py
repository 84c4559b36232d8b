"""Box delta encoding and decoding (reference:
detectron2/modeling/box_regression.py:16 ``Box2BoxTransform``, :115
``Box2BoxTransformRotated``; JAX package ``ops/box_regression.py``)."""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..structures.rotated_boxes import angle_mod

_DEFAULT_SCALE_CLAMP = math.log(1000.0 / 16)


class Box2BoxTransform:
    def __init__(
        self,
        weights: Tuple[float, float, float, float],
        scale_clamp: float = _DEFAULT_SCALE_CLAMP,
    ):
        self.weights = tuple(weights)
        self.scale_clamp = scale_clamp

    def get_deltas(self, src_boxes: torch.Tensor, target_boxes: torch.Tensor) -> torch.Tensor:
        """dx, dy, dw, dh encoding of target w.r.t. src (both (..., 4) XYXY)."""
        src_w = src_boxes[..., 2] - src_boxes[..., 0]
        src_h = src_boxes[..., 3] - src_boxes[..., 1]
        src_cx = src_boxes[..., 0] + 0.5 * src_w
        src_cy = src_boxes[..., 1] + 0.5 * src_h
        tgt_w = target_boxes[..., 2] - target_boxes[..., 0]
        tgt_h = target_boxes[..., 3] - target_boxes[..., 1]
        tgt_cx = target_boxes[..., 0] + 0.5 * tgt_w
        tgt_cy = target_boxes[..., 1] + 0.5 * tgt_h

        wx, wy, ww, wh = self.weights
        eps = 1e-7
        src_w = src_w.clamp(min=eps)
        src_h = src_h.clamp(min=eps)
        dx = wx * (tgt_cx - src_cx) / src_w
        dy = wy * (tgt_cy - src_cy) / src_h
        dw = ww * torch.log(tgt_w.clamp(min=eps) / src_w)
        dh = wh * torch.log(tgt_h.clamp(min=eps) / src_h)
        return torch.stack([dx, dy, dw, dh], dim=-1)

    def apply_deltas(self, deltas: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """deltas: (..., k*4); boxes: (..., 4) -> (..., k*4) decoded XYXY."""
        boxes = boxes.to(deltas.dtype)
        widths = boxes[..., 2] - boxes[..., 0]
        heights = boxes[..., 3] - boxes[..., 1]
        ctr_x = boxes[..., 0] + 0.5 * widths
        ctr_y = boxes[..., 1] + 0.5 * heights

        wx, wy, ww, wh = self.weights
        d = deltas.reshape(deltas.shape[:-1] + (-1, 4))
        dx = d[..., 0] / wx
        dy = d[..., 1] / wy
        dw = (d[..., 2] / ww).clamp(max=self.scale_clamp)
        dh = (d[..., 3] / wh).clamp(max=self.scale_clamp)

        pred_ctr_x = dx * widths[..., None] + ctr_x[..., None]
        pred_ctr_y = dy * heights[..., None] + ctr_y[..., None]
        pred_w = torch.exp(dw) * widths[..., None]
        pred_h = torch.exp(dh) * heights[..., None]
        out = torch.stack(
            [
                pred_ctr_x - 0.5 * pred_w,
                pred_ctr_y - 0.5 * pred_h,
                pred_ctr_x + 0.5 * pred_w,
                pred_ctr_y + 0.5 * pred_h,
            ],
            dim=-1,
        )
        return out.reshape(deltas.shape)


class Box2BoxTransformRotated:
    """The (dx, dy, dw, dh, da) codec of rotated (cx, cy, w, h, angle) boxes
    (reference box_regression.py:115; JAX package ``box_regression.py:82``):
    the angle delta in radians times its weight, both angles wrapped into
    [-180, 180) degrees."""

    def __init__(
        self,
        weights: Tuple[float, float, float, float, float],
        scale_clamp: float = _DEFAULT_SCALE_CLAMP,
    ):
        self.weights = tuple(weights)
        self.scale_clamp = scale_clamp

    def get_deltas(self, src_boxes: torch.Tensor, target_boxes: torch.Tensor) -> torch.Tensor:
        s_cx, s_cy, s_w, s_h, s_a = src_boxes.unbind(-1)
        t_cx, t_cy, t_w, t_h, t_a = target_boxes.unbind(-1)
        wx, wy, ww, wh, wa = self.weights
        dx = wx * (t_cx - s_cx) / s_w
        dy = wy * (t_cy - s_cy) / s_h
        dw = ww * torch.log(t_w / s_w)
        dh = wh * torch.log(t_h / s_h)
        da = angle_mod(t_a - s_a + 180.0, 360.0) - 180.0
        da = da * wa * (math.pi / 180.0)
        return torch.stack([dx, dy, dw, dh, da], dim=-1)

    def apply_deltas(self, deltas: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """deltas (..., 5) on boxes (..., 5) -> (..., 5) decoded boxes."""
        boxes = boxes.to(deltas.dtype)
        cx, cy, w, h, a = boxes.unbind(-1)
        # true divisions on either device (PyTorch's CUDA divides by a host
        # scalar through its reciprocal), so that the card decodes as the CPU
        wx, wy, ww, wh, wa = (deltas.new_full((), v) for v in self.weights)
        dx = deltas[..., 0] / wx
        dy = deltas[..., 1] / wy
        dw = (deltas[..., 2] / ww).clamp(max=self.scale_clamp)
        dh = (deltas[..., 3] / wh).clamp(max=self.scale_clamp)
        da = deltas[..., 4] * (180.0 / math.pi) / wa
        return torch.stack([
            dx * w + cx,
            dy * h + cy,
            torch.exp(dw) * w,
            torch.exp(dh) * h,
            angle_mod(da + a + 180.0, 360.0) - 180.0,
        ], dim=-1)
