"""Output resolution mapping (reference: detectron2/modeling/postprocessing.py
``detector_postprocess``; JAX package ``modeling/postprocessing.py:16``)."""

from __future__ import annotations

from typing import Dict

import torch

from ..structures.boxes import clip_boxes


def detector_postprocess_batched(
    detections: Dict[str, torch.Tensor],
    image_sizes: torch.Tensor,  # (B, 2) network-input true sizes
    orig_sizes: torch.Tensor,  # (B, 2) original image sizes
) -> Dict[str, torch.Tensor]:
    """Rescale boxes from network-input to original-image coordinates, clip
    them there, and mark boxes that clipped to empty invalid. Masks stay
    (D, S, S) ROI probabilities; ``ops.paste_masks`` pastes them into the
    image."""
    scale = orig_sizes.to(torch.float32) / image_sizes.to(torch.float32).clamp(min=1.0)
    sy = scale[:, 0][:, None]
    sx = scale[:, 1][:, None]
    b = detections["boxes"]
    boxes = torch.stack([b[..., 0] * sx, b[..., 1] * sy, b[..., 2] * sx, b[..., 3] * sy], dim=-1)
    boxes = clip_boxes(boxes, orig_sizes.to(torch.float32)[:, None, :])
    out = dict(detections)
    out["boxes"] = boxes
    nonempty = (boxes[..., 2] > boxes[..., 0]) & (boxes[..., 3] > boxes[..., 1])
    out["valid"] = out["valid"] & nonempty
    return out
