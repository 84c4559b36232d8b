"""Samplers (reference: detectron2/data/samplers/distributed_sampler.py:12
``TrainingSampler``, :57 ``RepeatFactorTrainingSampler``, :173
``InferenceSampler``; JAX package ``data/samplers/distributed_sampler.py:20,
46,100``). One process: the port trains and scores on one card, so every
index stream is the JAX package's at rank 0 of 1."""

from __future__ import annotations

import math
from typing import Iterator, List

import numpy as np


class TrainingSampler:
    """An infinite stream of indices in [0, size): a fresh
    ``RandomState(seed).permutation`` for every pass (or the indices in
    order without ``shuffle``)."""

    def __init__(self, size: int, shuffle: bool = True, seed: int = 0):
        assert size > 0
        self._size = size
        self._shuffle = shuffle
        self._seed = int(seed)

    def __iter__(self) -> Iterator[int]:
        rng = np.random.RandomState(self._seed)
        while True:
            if self._shuffle:
                yield from rng.permutation(self._size).tolist()
            else:
                yield from range(self._size)


class RepeatFactorTrainingSampler(TrainingSampler):
    """LVIS-style class-balanced resampling: each pass repeats image i
    floor(r_i) times and once more with probability frac(r_i)."""

    def __init__(self, repeat_factors: np.ndarray, *, shuffle: bool = True, seed: int = 0):
        self._int_part = np.floor(repeat_factors)
        self._frac_part = repeat_factors - self._int_part
        self._shuffle = shuffle
        self._seed = int(seed)

    @staticmethod
    def repeat_factors_from_category_frequency(dataset_dicts: List[dict], repeat_thresh: float) -> np.ndarray:
        """r_i = max over the image's categories c of max(1, sqrt(t / f_c)),
        f_c the fraction of images holding c."""
        category_freq: dict = {}
        for d in dataset_dicts:
            for cat_id in {ann["category_id"] for ann in d["annotations"]}:
                category_freq[cat_id] = category_freq.get(cat_id, 0) + 1
        num_images = len(dataset_dicts)
        category_rep = {c: max(1.0, math.sqrt(repeat_thresh / (f / num_images))) for c, f in category_freq.items()}
        return np.asarray([max({category_rep[ann["category_id"]] for ann in d["annotations"]}, default=1.0)
                           for d in dataset_dicts], dtype=np.float32)

    def _epoch_indices(self, rng: np.random.RandomState) -> np.ndarray:
        rep_factors = self._int_part + (rng.rand(len(self._frac_part)) < self._frac_part)
        return np.asarray([i for i, r in enumerate(rep_factors) for _ in range(int(r))], dtype=np.int64)

    def __iter__(self) -> Iterator[int]:
        rng = np.random.RandomState(self._seed)
        while True:
            indices = self._epoch_indices(rng)
            yield from (indices[rng.permutation(len(indices))] if self._shuffle else indices).tolist()


class InferenceSampler:
    """Every index once, in order."""

    def __init__(self, size: int):
        assert size > 0
        self._size = size

    def __iter__(self) -> Iterator[int]:
        yield from range(self._size)

    def __len__(self) -> int:
        return self._size
