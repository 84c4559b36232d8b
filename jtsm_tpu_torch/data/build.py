"""Test loading (reference: detectron2/data/build.py:209
``get_detection_dataset_dicts``, :414 ``build_detection_test_loader``; JAX
package ``data/build.py:101,182,393``).

The loader yields static padded batches (``detection_utils.build_static_batch``)
with their ``image_ids``; a final partial batch is padded with copies of its
last image and ``image_ids`` keeps only the real ones, so that the caller
trims the outputs (``engine.defaults.test``). A background thread maps and
collates ahead while the model runs."""

from __future__ import annotations

import itertools
import queue
import threading
import time
from typing import Iterator, List

import numpy as np

from .catalog import DatasetCatalog
from .common import DatasetFromList, MapDataset
from .dataset_mapper import DatasetMapper
from .detection_utils import build_static_batch
from .samplers import InferenceSampler


def get_detection_dataset_dicts(names) -> List[dict]:
    """The dataset dicts of ``names``, concatenated, every image kept (the
    test loader's; filtering images without annotations comes with the
    train loader)."""
    if isinstance(names, str):
        names = [names]
    assert len(names), names
    dataset_dicts = [DatasetCatalog.get(name) for name in names]
    for name, dicts in zip(names, dataset_dicts):
        if not len(dicts):
            raise ValueError(f"Dataset '{name}' is empty!")
    return list(itertools.chain.from_iterable(dataset_dicts))


class StaticBatchLoader:
    """Mapped per-image dicts to static padded batches of ``batch_size``,
    one pass over the sampler. ``busy_seconds`` sums the time spent
    mapping and collating (decode, resize, padding)."""

    PREFETCH = 2  # batches mapped ahead

    def __init__(self, dataset: MapDataset, sampler, batch_size: int, buckets, pad_final: bool = False):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.buckets = [tuple(b) for b in buckets]
        self.pad_final = pad_final
        self.busy_seconds = 0.0

    def _batches(self) -> Iterator[dict]:
        it = iter(self.sampler)
        while True:
            t0 = time.perf_counter()
            group = [self.dataset[i] for i in itertools.islice(it, self.batch_size)]
            if not group:
                return
            real = len(group)
            if self.pad_final and real < self.batch_size:
                # keep the batch shape static: repeat the last image
                group = group + [group[-1]] * (self.batch_size - real)
            batch = build_static_batch(group, self.buckets)
            batch["image_ids"] = np.asarray([g.get("image_id", -1) for g in group[:real]], dtype=np.int64)
            self.busy_seconds += time.perf_counter() - t0
            yield batch

    def __iter__(self) -> Iterator[dict]:
        q: "queue.Queue" = queue.Queue(maxsize=self.PREFETCH)
        done = object()

        def producer():
            try:
                for b in self._batches():
                    q.put(b)
            except Exception as e:  # raised again in the consumer
                q.put(e)
            finally:
                q.put(done)

        threading.Thread(target=producer, daemon=True).start()
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, Exception):
                raise item
            yield item

    def __len__(self):
        return (len(self.sampler) + self.batch_size - 1) // self.batch_size


def build_detection_test_loader(cfg, dataset_name: str, batch_size: int = 1) -> StaticBatchLoader:
    """Every image of ``dataset_name`` once, in order, through the test
    ``DatasetMapper``, in batches of ``batch_size`` padded to
    ``TPU.IMAGE_BUCKETS`` (reference build.py:414)."""
    dataset = MapDataset(DatasetFromList(get_detection_dataset_dicts([dataset_name])), DatasetMapper(cfg, False))
    return StaticBatchLoader(dataset, InferenceSampler(len(dataset)), batch_size, cfg.TPU.IMAGE_BUCKETS,
                             pad_final=batch_size > 1)
