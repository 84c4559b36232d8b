"""Box delta encoding and decoding (reference:
detectron2/modeling/box_regression.py:16 ``Box2BoxTransform``; JAX package
``ops/box_regression.py``)."""

from __future__ import annotations

import math
from typing import Tuple

import torch

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
