"""Functional ops on (..., 4) XYXY box tensors (reference:
detectron2/structures/boxes.py:185 ``clip``, :199 ``nonempty``, :369
``pairwise_iou``; JAX package ``structures/boxes.py``)."""

from __future__ import annotations

import math
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
    def convert(box, from_mode: "BoxMode", to_mode: "BoxMode"):
        """Boxes from one absolute mode to another (reference boxes.py:35,
        JAX package ``structures/boxes.py:35-90``): the input as it is when
        the modes agree; else an (N, 4) or (N, 5) array comes back in its own
        dtype, a 4- or 5-long list or tuple as its own type. XYWHA_ABS
        (cx, cy, w, h, angle in degrees, counter-clockwise) converts to
        XYXY_ABS as the envelope of the rotated box, and XYWH_ABS to XYWHA_ABS
        at angle 0; the relative modes raise, as in the JAX package."""
        if from_mode == to_mode:
            return box
        if BoxMode.XYXY_REL in (from_mode, to_mode) or BoxMode.XYWH_REL in (from_mode, to_mode):
            raise NotImplementedError(f"BoxMode.convert from {from_mode!r} to {to_mode!r}: relative modes are not "
                                      "supported")
        single_box = isinstance(box, (list, tuple))
        if single_box and len(box) not in (4, 5):
            raise ValueError("BoxMode.convert takes a 4- or 5-long list or tuple, or an (N, 4) or (N, 5) array")
        arr = np.array(box, dtype=np.float64)[None, :] if single_box else np.asarray(box, dtype=np.float64)
        if (from_mode, to_mode) == (BoxMode.XYWHA_ABS, BoxMode.XYXY_ABS):
            if arr.shape[-1] != 5:
                raise ValueError("The last dimension of input shape must be 5 for XYWHA format")
            cx, cy, w, h, a = (arr[..., i] for i in range(5))
            theta = a * math.pi / 180.0
            c, s = np.abs(np.cos(theta)), np.abs(np.sin(theta))
            new_w, new_h = c * w + s * h, c * h + s * w
            out = np.stack([cx - new_w / 2.0, cy - new_h / 2.0, cx + new_w / 2.0, cy + new_h / 2.0], axis=-1)
        elif (from_mode, to_mode) == (BoxMode.XYWH_ABS, BoxMode.XYWHA_ABS):
            x, y, w, h = (arr[..., i] for i in range(4))
            out = np.stack([x + w / 2.0, y + h / 2.0, w, h, np.zeros_like(x)], axis=-1)
        elif (from_mode, to_mode) == (BoxMode.XYWH_ABS, BoxMode.XYXY_ABS):
            a, b, c, d = (arr[..., i] for i in range(4))
            out = np.stack([a, b, a + c, b + d], axis=-1)
        elif (from_mode, to_mode) == (BoxMode.XYXY_ABS, BoxMode.XYWH_ABS):
            a, b, c, d = (arr[..., i] for i in range(4))
            out = np.stack([a, b, c - a, d - b], axis=-1)
        else:
            raise NotImplementedError(f"Conversion from BoxMode {from_mode!r} to {to_mode!r} is not supported yet")
        if single_box:
            return type(box)(out[0].tolist())
        if isinstance(box, np.ndarray):
            return out.astype(box.dtype)
        return out


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
