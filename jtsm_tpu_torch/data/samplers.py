"""Samplers (reference: detectron2/data/samplers/distributed_sampler.py:173
``InferenceSampler``; JAX package ``data/samplers/distributed_sampler.py:100``).
One process: the port scores on one card."""

from __future__ import annotations

from typing import Iterator


class InferenceSampler:
    """Every index once, in order."""

    def __init__(self, size: int):
        assert size > 0
        self._size = size

    def __iter__(self) -> Iterator[int]:
        yield from range(self._size)

    def __len__(self) -> int:
        return self._size
