"""The keypoint heatmap encode and decode (JAX package
``structures/keypoints.py:60,93``).

This is the JAX package's decode, not detectron2's: detectron2
(``structures/keypoints.py:143``) resizes each ROI's heatmap bicubically to
the box's size and takes the maximum there; the JAX package takes the first
maximum on the raw S x S grid, puts the keypoint at that bin's centre in the
box, and keeps the bin's logit and its softmax probability (ROADMAP §3).
The encode for training (``keypoints_to_heatmap``) is detectron2's
(``structures/keypoints.py:84``)."""

from __future__ import annotations

import torch


def keypoints_to_heatmap(keypoints: torch.Tensor, rois: torch.Tensor, heatmap_size: int):
    """(N, K, 3) keypoints (x, y, visibility) and (N, 4) boxes -> the bin of
    each keypoint on the box's ``heatmap_size`` grid, flattened row-major,
    (N, K) int32 (0 where not valid), and its validity (N, K) int32: the
    offsets from the box's corner scaled and truncated toward zero, a
    point on the box's far edge (``x == x1``, ``y == y1``) in the last bin,
    valid where inside the grid and visible."""
    x0, y0, x1, y1 = (rois[:, i: i + 1] for i in range(4))
    # a tensor divides the size: ``int / tensor`` is the reciprocal times
    # the int in PyTorch, which rounds twice and moves points that lie on a
    # bin's edge into the bin before it
    size = rois.new_tensor(float(heatmap_size))
    scale_x = size / (x1 - x0).clamp(min=1e-6)
    scale_y = size / (y1 - y0).clamp(min=1e-6)
    x, y = keypoints[..., 0], keypoints[..., 1]
    last = torch.full_like(x, heatmap_size - 1, dtype=torch.int32)
    xi = torch.where(x == x1, last, ((x - x0) * scale_x).to(torch.int32))
    yi = torch.where(y == y1, last, ((y - y0) * scale_y).to(torch.int32))
    inside = (xi >= 0) & (yi >= 0) & (xi < heatmap_size) & (yi < heatmap_size)
    valid = (inside & (keypoints[..., 2] > 0)).to(torch.int32)
    return (yi * heatmap_size + xi) * valid, valid


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
