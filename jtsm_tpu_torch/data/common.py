"""Dataset wrappers (reference: detectron2/data/common.py:16 ``MapDataset``,
:62 ``DatasetFromList``, :152 ``AspectRatioGroupedDataset``; JAX package
``data/common.py:14,45,82``)."""

from __future__ import annotations

import pickle
from typing import Callable, Iterable, Iterator, List

import numpy as np


class MapDataset:
    """A dataset with a function mapped over its items."""

    def __init__(self, dataset, map_func: Callable):
        self._dataset = dataset
        self._map_func = map_func

    def __len__(self):
        return len(self._dataset)

    def __getitem__(self, idx):
        return self._map_func(self._dataset[idx])

    def draw(self, idx=None):
        """The map function's random draws for item ``idx`` (its
        ``draw()``, or ``draw(record)`` where they depend on the record),
        or None for a function without draws."""
        draw = getattr(self._map_func, "draw", None)
        if draw is None:
            return None
        return draw(self._dataset[idx]) if getattr(self._map_func, "draws_on_record", False) else draw()

    def map(self, idx, drawn):
        """Item ``idx`` mapped with the draws ``drawn`` (from ``draw()``)."""
        if drawn is None:
            return self[idx]
        return self._map_func(self._dataset[idx], drawn)


class DatasetFromList:
    """A list held as one pickled buffer, to keep Python objects few
    (reference common.py:62); each item comes back as a fresh copy."""

    def __init__(self, lst: List):
        serialized = [np.frombuffer(pickle.dumps(x, protocol=-1), dtype=np.uint8) for x in lst]
        self._addr = np.cumsum(np.asarray([len(x) for x in serialized], dtype=np.int64))
        self._lst = np.concatenate(serialized)

    def __len__(self):
        return len(self._addr)

    def __getitem__(self, idx):
        start = 0 if idx == 0 else self._addr[idx - 1].item()
        return pickle.loads(self._lst[start: self._addr[idx].item()].tobytes())


class AspectRatioGroupedDataset:
    """Batches of ``batch_size`` consecutive items of one orientation (wider
    than tall, or not), so that a batch pads into a tight bucket
    (reference common.py:152, JAX package ``common.py:82``)."""

    def __init__(self, dataset: Iterable, batch_size: int):
        self.dataset = dataset
        self.batch_size = batch_size
        self._buckets: List[List] = [[], []]

    def __iter__(self) -> Iterator[List]:
        for d in self.dataset:
            bucket = self._buckets[0 if d["width"] > d["height"] else 1]
            bucket.append(d)
            if len(bucket) == self.batch_size:
                yield bucket[:]
                del bucket[:]
