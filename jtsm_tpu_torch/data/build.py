"""Test loading (reference: detectron2/data/build.py:166
``load_proposals_into_dataset``, :209 ``get_detection_dataset_dicts``, :414
``build_detection_test_loader``; JAX package ``data/build.py:70,103,396``).

The loader yields static padded batches (``detection_utils.build_static_batch``)
with their ``image_ids``; a final partial batch is padded with copies of its
last image and ``image_ids`` keeps only the real ones, so that the caller
trims the outputs (``engine.defaults.test``). A background thread maps and
collates ahead while the model runs.

A proposal file is a pickle ({ids, boxes, objectness_logits, bbox_mode?},
the keys ``indexes`` and ``scores`` accepted for the last two), named by a
path in which ``$VAR`` expands, or that dict already loaded (datasets made
in memory)."""

from __future__ import annotations

import itertools
import logging
import os
import pickle
import queue
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Union

import numpy as np

from ..structures import BoxMode
from .catalog import DatasetCatalog
from .common import DatasetFromList, MapDataset
from .dataset_mapper import DatasetMapper
from .detection_utils import build_static_batch
from .samplers import InferenceSampler

logger = logging.getLogger(__name__)


def load_proposal_file(proposal_file: Union[str, Dict]) -> Dict:
    """The proposal dict of ``proposal_file`` (a path or a loaded dict),
    with ``indexes`` and ``scores`` renamed ``ids`` and
    ``objectness_logits``; a loaded dict is not modified."""
    if isinstance(proposal_file, dict):
        proposals = dict(proposal_file)
    else:
        logger.info(f"Loading proposals from: {proposal_file}")
        with open(os.path.expandvars(proposal_file), "rb") as f:
            proposals = pickle.load(f, encoding="latin1")
    for old, new in (("indexes", "ids"), ("scores", "objectness_logits")):
        if old in proposals:
            proposals[new] = proposals.pop(old)
    return proposals


def attach_proposals(dataset_dicts: List[dict], proposals: Dict, fields: Dict[str, str]) -> List[dict]:
    """Sets each record's ``proposal_<field>`` from the proposal dict's
    entry of its image id, for each (record key, dict key) of ``fields``
    the dict has, and ``proposal_bbox_mode``."""
    img_ids = {str(record["image_id"]) for record in dataset_dicts}
    id_to_index = {str(i): n for n, i in enumerate(proposals["ids"]) if str(i) in img_ids}
    bbox_mode = BoxMode(proposals["bbox_mode"]) if "bbox_mode" in proposals else BoxMode.XYXY_ABS
    for record in dataset_dicts:
        i = id_to_index[str(record["image_id"])]
        for key, src in fields.items():
            if src in proposals:
                record[key] = proposals[src][i]
        record["proposal_bbox_mode"] = bbox_mode
    return dataset_dicts


def load_proposals_into_dataset(dataset_dicts: List[dict], proposal_file: Union[str, Dict]) -> List[dict]:
    """Each record gains its image's precomputed ``proposal_boxes``,
    ``proposal_objectness_logits`` and ``proposal_bbox_mode`` (reference
    build.py:166)."""
    return attach_proposals(dataset_dicts, load_proposal_file(proposal_file), {
        "proposal_boxes": "boxes", "proposal_objectness_logits": "objectness_logits"})


def get_detection_dataset_dicts(names, proposal_files=None,
                                proposal_loader: Optional[Callable] = None) -> List[dict]:
    """The dataset dicts of ``names``, concatenated, every image kept (the
    test loader's; filtering images without annotations comes with the
    train loader). With ``proposal_files`` (one per name), each dataset's
    records take their proposals through ``proposal_loader`` (default
    ``load_proposals_into_dataset``; the WSL loader also attaches the
    superpixels)."""
    if isinstance(names, str):
        names = [names]
    assert len(names), names
    dataset_dicts = [DatasetCatalog.get(name) for name in names]
    for name, dicts in zip(names, dataset_dicts):
        if not len(dicts):
            raise ValueError(f"Dataset '{name}' is empty!")
    if proposal_files is not None:
        assert len(names) == len(proposal_files), (names, len(proposal_files))
        loader = proposal_loader or load_proposals_into_dataset
        dataset_dicts = [loader(dicts, f) for dicts, f in zip(dataset_dicts, proposal_files)]
    return list(itertools.chain.from_iterable(dataset_dicts))


class StaticBatchLoader:
    """Mapped per-image dicts to static padded batches of ``batch_size``,
    one pass over the sampler. ``busy_seconds`` sums the time spent
    mapping and collating (decode, resize, padding)."""

    PREFETCH = 2  # batches mapped ahead

    def __init__(self, dataset: MapDataset, sampler, batch_size: int, buckets, pad_final: bool = False,
                 proposal_topk: int = 0):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.buckets = [tuple(b) for b in buckets]
        self.pad_final = pad_final
        self.proposal_topk = proposal_topk
        self.busy_seconds = 0.0

    def collate(self, group: List[dict]) -> Dict[str, np.ndarray]:
        """One static batch of mapped dicts; subclasses add fields."""
        return build_static_batch(group, self.buckets, self.proposal_topk)

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
            batch = self.collate(group)
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


def build_detection_test_loader(cfg, dataset_name: str, mapper: Optional[Callable] = None, batch_size: int = 1,
                                proposal_loader: Optional[Callable] = None,
                                loader_class=StaticBatchLoader) -> StaticBatchLoader:
    """Every image of ``dataset_name`` once, in order, through ``mapper``
    (the test ``DatasetMapper`` by default), in batches of ``batch_size``
    padded to ``TPU.IMAGE_BUCKETS`` (reference build.py:414). Under
    MODEL.LOAD_PROPOSALS the records take the dataset's entry of
    DATASETS.PROPOSAL_FILES_TEST (through ``proposal_loader``) and the
    batches PRECOMPUTED_PROPOSAL_TOPK_TEST proposal slots."""
    proposals = cfg.MODEL.LOAD_PROPOSALS
    proposal_files = (
        [cfg.DATASETS.PROPOSAL_FILES_TEST[list(cfg.DATASETS.TEST).index(dataset_name)]] if proposals else None
    )
    dicts = get_detection_dataset_dicts([dataset_name], proposal_files, proposal_loader)
    dataset = MapDataset(DatasetFromList(dicts), mapper or DatasetMapper(cfg, False))
    return loader_class(dataset, InferenceSampler(len(dataset)), batch_size, cfg.TPU.IMAGE_BUCKETS,
                        pad_final=batch_size > 1,
                        proposal_topk=cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST if proposals else 0)
