"""Functional ops on (..., 4) XYXY box tensors (reference:
detectron2/structures/boxes.py:185 ``clip``, :199 ``nonempty``, :369
``pairwise_iou``; JAX package ``structures/boxes.py``)."""

from __future__ import annotations

from enum import IntEnum

import numpy as np
import torch


class BoxMode(IntEnum):
    """How a dataset record's box is written (reference:
    detectron2/structures/boxes.py:23)."""

    XYXY_ABS = 0
    XYWH_ABS = 1
    XYXY_REL = 2
    XYWH_REL = 3
    XYWHA_ABS = 4

    @staticmethod
    def convert(box: np.ndarray, from_mode: "BoxMode", to_mode: "BoxMode") -> np.ndarray:
        """(N, 4) boxes from one absolute mode to another (reference
        boxes.py:35): the array as it is when the modes agree, else float64;
        only XYXY_ABS and XYWH_ABS are ported: the rotated XYWHA_ABS waits
        for the rotated family (ROADMAP), and the relative modes raise, as
        in the JAX package."""
        if from_mode == to_mode:
            return box
        arr = np.asarray(box, dtype=np.float64)
        a, b, c, d = (arr[..., i] for i in range(4))
        if (from_mode, to_mode) == (BoxMode.XYWH_ABS, BoxMode.XYXY_ABS):
            return np.stack([a, b, a + c, b + d], axis=-1)
        if (from_mode, to_mode) == (BoxMode.XYXY_ABS, BoxMode.XYWH_ABS):
            return np.stack([a, b, c - a, d - b], axis=-1)
        if BoxMode.XYWHA_ABS in (from_mode, to_mode):
            raise NotImplementedError(f"BoxMode.convert from {from_mode!r} to {to_mode!r}: the rotated (XYWHA) "
                                      "conversions wait for the rotated family (ROADMAP)")
        raise NotImplementedError(f"BoxMode.convert from {from_mode!r} to {to_mode!r}: relative modes are not "
                                  "supported")


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def clip_boxes(boxes: torch.Tensor, box_size) -> torch.Tensor:
    """Clip to [0, w] x [0, h]. ``box_size`` is (h, w): two numbers, or a
    tensor whose ``[..., 0]`` and ``[..., 1]`` broadcast against
    ``boxes[..., 0]``."""
    h = torch.as_tensor(box_size[..., 0] if torch.is_tensor(box_size) else box_size[0])
    w = torch.as_tensor(box_size[..., 1] if torch.is_tensor(box_size) else box_size[1])
    h = h.to(device=boxes.device, dtype=boxes.dtype)
    w = w.to(device=boxes.device, dtype=boxes.dtype)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x0 = torch.minimum(torch.maximum(boxes[..., 0], zero), w)
    y0 = torch.minimum(torch.maximum(boxes[..., 1], zero), h)
    x1 = torch.minimum(torch.maximum(boxes[..., 2], zero), w)
    y1 = torch.minimum(torch.maximum(boxes[..., 3], zero), h)
    return torch.stack([x0, y0, x1, y1], dim=-1)


def nonempty_boxes(boxes: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """Bool mask of boxes with both sides > threshold."""
    widths = boxes[..., 2] - boxes[..., 0]
    heights = boxes[..., 3] - boxes[..., 1]
    return (widths > threshold) & (heights > threshold)


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) -> (..., N, M) IoU, 0 where boxes do not
    intersect."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:4], boxes2[..., None, :, 2:4])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    iou = inter / union.clamp(min=1e-12)
    return torch.where(inter > 0, iou, torch.zeros_like(iou))
