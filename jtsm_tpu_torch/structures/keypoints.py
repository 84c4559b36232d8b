"""The keypoint heatmap decode (JAX package ``structures/keypoints.py:93``).

This is the JAX package's decode, not detectron2's: detectron2
(``structures/keypoints.py:143``) resizes each ROI's heatmap bicubically to
the box's size and takes the maximum there; the JAX package takes the first
maximum on the raw S x S grid, puts the keypoint at that bin's centre in the
box, and keeps the bin's logit and its softmax probability (ROADMAP §3).
The heatmap encode for training (``keypoints_to_heatmap``) waits for the
training slice."""

from __future__ import annotations

import torch


def heatmaps_to_keypoints(maps: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
    """(N, K, S, S) heatmap logits and (N, 4) boxes -> (N, K, 4) keypoints
    (x, y, logit, probability) in the boxes' coordinates: the first maximum
    of each map (row-major), at the centre of its bin, the box's width and
    height taken as at least 1."""
    n, k, s, _ = maps.shape
    widths = (rois[:, 2] - rois[:, 0]).clamp(min=1.0)
    heights = (rois[:, 3] - rois[:, 1]).clamp(min=1.0)
    flat = maps.reshape(n, k, s * s)
    idx = flat.argmax(dim=2)
    max_logit = torch.gather(flat, 2, idx[..., None])[..., 0]
    max_prob = torch.gather(torch.softmax(flat, dim=2), 2, idx[..., None])[..., 0]
    xs = (idx % s).to(maps.dtype) + 0.5
    ys = torch.div(idx, s, rounding_mode="floor").to(maps.dtype) + 0.5
    x = xs * (widths / s)[:, None] + rois[:, 0:1]
    y = ys * (heights / s)[:, None] + rois[:, 1:2]
    return torch.stack([x, y, max_logit, max_prob], dim=2)
