"""Ground truth to prediction matching (reference: detectron2/modeling/
matcher.py:8 ``Matcher``; JAX package ``ops/matcher.py:17``).

Fixed shapes: padded ground truth rows are masked by ``gt_valid`` instead of
being removed, and any leading batch dimensions are kept."""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch


class Matcher:
    """Assigns each prediction (a column of the match matrix) to the ground
    truth row of highest quality and labels it by the interval its quality
    falls in: ``thresholds`` [0.3, 0.7] with ``labels`` [0, -1, 1] is the
    RPN's rule (below 0.3 background, between ignored, from 0.7 on
    foreground)."""

    def __init__(self, thresholds: List[float], labels: List[int], allow_low_quality_matches: bool = False):
        thresholds = list(thresholds)
        if thresholds[0] <= 0:
            raise ValueError(f"the first threshold must be positive, got {thresholds}")
        thresholds = [-float("inf")] + thresholds + [float("inf")]
        if any(lo > hi for lo, hi in zip(thresholds[:-1], thresholds[1:])):
            raise ValueError(f"thresholds must increase, got {thresholds}")
        if any(label not in (-1, 0, 1) for label in labels) or len(labels) != len(thresholds) - 1:
            raise ValueError(f"labels {labels} do not fit thresholds {thresholds}")
        self.thresholds = thresholds
        self.labels = list(labels)
        self.allow_low_quality_matches = allow_low_quality_matches

    def __call__(
        self, match_quality: torch.Tensor, gt_valid: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``match_quality`` (..., M, N) of M ground truth rows against N
        predictions; ``gt_valid`` (..., M) marks the real rows. Returns the
        matched row (..., N) int64, the first maximum on ties as
        ``jnp.argmax`` takes it, and the label (..., N) int8 in {-1, 0, 1}."""
        m, n = match_quality.shape[-2:]
        if gt_valid is not None:
            match_quality = torch.where(
                gt_valid[..., :, None], match_quality, torch.full_like(match_quality, -1.0)
            )
        if m > 0:
            matched_vals = match_quality.amax(dim=-2)
            matches = match_quality.argmax(dim=-2)  # the first maximum
        else:
            matched_vals = match_quality.new_zeros(match_quality.shape[:-2] + (n,))
            matches = matched_vals.to(torch.int64)

        match_labels = torch.full_like(matches, self.labels[0], dtype=torch.int8)
        for low, high, label in zip(self.thresholds[:-1], self.thresholds[1:], self.labels):
            inside = (matched_vals >= low) & (matched_vals < high)
            match_labels = torch.where(inside, torch.full_like(match_labels, label), match_labels)

        if self.allow_low_quality_matches and m > 0:
            # each real ground truth row's best predictions become foreground
            highest = match_quality.max(dim=-1).values  # (..., M)
            is_best = (match_quality == highest[..., None]) & (highest[..., None] > 0)
            if gt_valid is not None:
                is_best = is_best & gt_valid[..., :, None]
            match_labels = torch.where(
                is_best.any(dim=-2), torch.ones_like(match_labels), match_labels
            )
        return matches, match_labels
