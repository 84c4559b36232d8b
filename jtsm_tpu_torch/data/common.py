"""Dataset wrappers (reference: detectron2/data/common.py:16 ``MapDataset``,
:62 ``DatasetFromList``; JAX package ``data/common.py:14,45``)."""

from __future__ import annotations

import pickle
from typing import Callable, List

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
