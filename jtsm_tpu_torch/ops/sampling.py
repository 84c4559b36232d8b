"""Random foreground and background subsampling with fixed shapes
(reference: detectron2/modeling/sampling.py:9 ``subsample_labels``; JAX
package ``ops/sampling.py:19``).

Instead of index lists of data-dependent length, every function returns
selection masks of the input's shape. The randomness is an argument: the
uniform draws ``u`` in [0, 1), one per element, which the caller makes with
``torch.rand(..., generator=g)`` from an explicit ``torch.Generator`` (the
tests pass the JAX package's own ``jax.random.uniform`` draws, so both
sides select the same elements). A draw of exactly 0 never selects, as in
the JAX package. Any leading batch dimensions are kept."""

from __future__ import annotations

from typing import Tuple

import torch


def _sorted_desc(x: torch.Tensor) -> torch.Tensor:
    """Values sorted in descending order along the last dim, stably (the
    order of the JAX package's ``lax.top_k``)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).values


def _random_topk_mask(eligible: torch.Tensor, k: int, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selects min(k, eligible.sum()) random elements of ``eligible``
    (..., N) for a fixed k. Returns the mask and the number selected."""
    n = eligible.shape[-1]
    if k <= 0:
        return torch.zeros_like(eligible), eligible.new_zeros(eligible.shape[:-1], dtype=torch.int64)
    priority = torch.where(eligible, u, torch.full_like(u, -1.0))
    kth = _sorted_desc(priority)[..., min(k, n) - 1]
    take = eligible.sum(dim=-1).clamp(max=k)
    mask = eligible & (priority >= kth.clamp(min=0.0)[..., None]) & (priority > 0.0)
    return mask, torch.minimum(take, mask.sum(dim=-1))


def _random_topk_mask_dynamic(
    eligible: torch.Tensor, k_dynamic: torch.Tensor, k_max: int, u: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """As :func:`_random_topk_mask` with a per-row cap ``k_dynamic`` (...,)
    of at most ``k_max``: only the k_max largest priorities can be the
    threshold."""
    n = eligible.shape[-1]
    priority = torch.where(eligible, u, torch.full_like(u, -1.0))
    kk = min(k_max, n)
    top_p = _sorted_desc(priority)[..., :kk]
    k_dynamic = k_dynamic.clamp(0, kk)
    at = (k_dynamic - 1).clamp(0, kk - 1)
    kth = torch.where(
        k_dynamic > 0,
        torch.gather(top_p, -1, at[..., None])[..., 0],
        torch.full_like(top_p[..., 0], float("inf")),
    )
    mask = eligible & (priority >= kth[..., None]) & (priority > 0.0)
    return mask, mask.sum(dim=-1)


def subsample_labels(
    labels: torch.Tensor,
    num_samples: int,
    positive_fraction: float,
    bg_label: int,
    u_pos: torch.Tensor,
    u_neg: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``labels`` (..., N): -1 ignore, ``bg_label`` background, anything else
    foreground. Returns (pos_mask, neg_mask) with at most ``num_samples *
    positive_fraction`` positives and negatives filling the rest of the
    ``num_samples``, each chosen uniformly by the draws ``u_pos`` and
    ``u_neg`` (..., N)."""
    positive = (labels != -1) & (labels != bg_label)
    negative = labels == bg_label
    pos_mask, num_pos = _random_topk_mask(positive, int(num_samples * positive_fraction), u_pos)
    neg_mask, _ = _random_topk_mask_dynamic(negative, num_samples - num_pos, num_samples, u_neg)
    return pos_mask, neg_mask
