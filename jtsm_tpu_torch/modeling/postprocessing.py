"""Output resolution mapping (reference: detectron2/modeling/postprocessing.py
``detector_postprocess``; JAX package ``modeling/postprocessing.py:16``)."""

from __future__ import annotations

from typing import Dict

import torch

from ..structures.boxes import clip_boxes
from ..structures.rotated_boxes import scale_rotated


def detector_postprocess_batched(
    detections: Dict[str, torch.Tensor],
    image_sizes: torch.Tensor,  # (B, 2) network-input true sizes
    orig_sizes: torch.Tensor,  # (B, 2) original image sizes
) -> Dict[str, torch.Tensor]:
    """Rescale boxes from network-input to original-image coordinates, clip
    them there, and mark boxes that clipped to empty invalid (where there is
    a ``valid``). Rotated (..., 5) boxes are refit under the anisotropic
    scale (``structures.rotated_boxes.scale_rotated``) and neither clipped
    nor invalidated, as in the JAX package (``postprocessing.py:31-45``).
    Keypoints (B, D, K, 4) follow the boxes' scale in x and y.
    Masks stay (D, S, S) ROI probabilities; ``ops.paste_masks`` pastes them
    into the image."""
    scale = orig_sizes.to(torch.float32) / image_sizes.to(torch.float32).clamp(min=1.0)
    sy = scale[:, 0][:, None]
    sx = scale[:, 1][:, None]
    b = detections["boxes"]
    out = dict(detections)
    if b.shape[-1] == 5:
        out["boxes"] = scale_rotated(b, sx, sy)
    else:
        boxes = torch.stack([b[..., 0] * sx, b[..., 1] * sy, b[..., 2] * sx, b[..., 3] * sy], dim=-1)
        out["boxes"] = boxes = clip_boxes(boxes, orig_sizes.to(torch.float32)[:, None, :])
    if "valid" in out and b.shape[-1] == 4:
        nonempty = (boxes[..., 2] > boxes[..., 0]) & (boxes[..., 3] > boxes[..., 1])
        out["valid"] = out["valid"] & nonempty
    if "keypoints" in out:
        kp = out["keypoints"]
        out["keypoints"] = torch.cat([kp[..., 0:1] * sx[..., None, None], kp[..., 1:2] * sy[..., None, None],
                                      kp[..., 2:]], dim=-1)
    return out
