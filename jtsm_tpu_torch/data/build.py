"""Train and test loading (reference: detectron2/data/build.py:166
``load_proposals_into_dataset``, :209 ``get_detection_dataset_dicts``, :261
``build_batch_data_loader``, :348 ``build_detection_train_loader``, :414
``build_detection_test_loader``; JAX package ``data/build.py:34,70,103,182,
306,341,396``).

The loaders yield static padded batches (``detection_utils.build_static_batch``)
with their ``image_ids``. The test loader passes over the dataset once; a
final partial batch is padded with copies of its last image and
``image_ids`` keeps only the real ones, so that the caller trims the
outputs (``engine.defaults.test``). The train loader never ends: a
shuffled index stream (``samplers.TrainingSampler``), mapped with the
train augmentations and, under DATALOADER.ASPECT_RATIO_GROUPING, grouped
by orientation into batches with their instance ground truth. A
background thread maps and collates ahead while the model runs; with
DATALOADER.NUM_WORKERS > 0 a pool of that many threads maps the records,
in order, each with the augmentation draws made for it in the sampler's
order, so the batches are those of NUM_WORKERS 0.

The train loader's seed chain is the JAX package's: its
``default_setup`` seeds the global ``np.random`` with SEED, the sampler's
seed is the stream's first ``randint(2**31)`` (``comm.shared_random_seed``)
and the augmentations draw on from there. Here a
``np.random.RandomState(SEED)`` makes the same draws in the same order:
the sampler's seed, then each record's augmentation draws (the mapper
owns it).

A proposal file is a pickle ({ids, boxes, objectness_logits, bbox_mode?},
the keys ``indexes`` and ``scores`` accepted for the last two), named by a
path in which ``$VAR`` expands, or that dict already loaded (datasets made
in memory)."""

from __future__ import annotations

import collections
import itertools
import logging
import os
import pickle
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Union

import numpy as np

from ..structures import BoxMode
from .catalog import DatasetCatalog
from .common import AspectRatioGroupedDataset, DatasetFromList, MapDataset
from .dataset_mapper import DatasetMapper
from .detection_utils import build_static_batch
from .samplers import InferenceSampler, RepeatFactorTrainingSampler, TrainingSampler

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


def filter_images_with_only_crowd_annotations(dataset_dicts: List[dict]) -> List[dict]:
    """The records with at least one annotation that is not a crowd."""
    out = [d for d in dataset_dicts if any(a.get("iscrowd", 0) == 0 for a in d.get("annotations", []))]
    logger.info(f"Removed {len(dataset_dicts) - len(out)} images with no usable annotations. {len(out)} images left.")
    return out


def filter_images_with_few_keypoints(dataset_dicts: List[dict], min_keypoints_per_image: int) -> List[dict]:
    """The records with at least ``min_keypoints_per_image`` visible
    keypoints over their annotations (reference build.py:74)."""

    def visible(d):
        return sum((np.asarray(a["keypoints"][2::3]) > 0).sum() for a in d["annotations"] if "keypoints" in a)

    out = [d for d in dataset_dicts if visible(d) >= min_keypoints_per_image]
    logger.info(f"Removed {len(dataset_dicts) - len(out)} images with fewer than {min_keypoints_per_image} keypoints.")
    return out


def get_detection_dataset_dicts(names, proposal_files=None, proposal_loader: Optional[Callable] = None,
                                filter_empty: bool = False, min_keypoints: int = 0) -> List[dict]:
    """The dataset dicts of ``names``, concatenated. With ``proposal_files``
    (one per name), each dataset's records take their proposals through
    ``proposal_loader`` (default ``load_proposals_into_dataset``; the WSL
    loader also attaches the superpixels). With ``filter_empty`` (the
    train loader's DATALOADER.FILTER_EMPTY_ANNOTATIONS), records whose
    annotations are all crowds, or that have none, are dropped when the
    records carry annotations; with ``min_keypoints`` > 0 so are those
    with fewer visible keypoints (``filter_images_with_few_keypoints``)."""
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
    dataset_dicts = list(itertools.chain.from_iterable(dataset_dicts))
    has_instances = "annotations" in dataset_dicts[0]
    if filter_empty and has_instances:
        dataset_dicts = filter_images_with_only_crowd_annotations(dataset_dicts)
    if min_keypoints > 0 and has_instances:
        dataset_dicts = filter_images_with_few_keypoints(dataset_dicts, min_keypoints)
    return dataset_dicts


class StaticBatchLoader:
    """Mapped per-image dicts to static padded batches of ``batch_size``.
    One pass over the sampler in order (the test loader), or with
    ``aspect_ratio_grouping`` batches of one orientation from an endless
    sampler (the train loader). ``max_instances`` and ``mask_crop_size``
    collate the instance ground truth. ``num_workers`` threads map the
    records (0: the background thread itself). ``busy_seconds`` sums the
    background thread's time producing batches (with NUM_WORKERS 0 the
    decode, augment and rasterise, and the pad; with threads the wait for
    their records and the pad, while they map on outside it);
    ``map_seconds`` sums each record's mapping in the thread that maps it
    (threads overlap, and a thread's time includes its waits for the
    interpreter lock); ``batches`` counts the batches."""

    PREFETCH = 2  # batches mapped ahead

    def __init__(self, dataset: MapDataset, sampler, batch_size: int, buckets, pad_final: bool = False,
                 proposal_topk: int = 0, max_instances: int = 0, mask_crop_size: int = 0,
                 aspect_ratio_grouping: bool = False, num_workers: int = 0):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.buckets = [tuple(b) for b in buckets]
        self.pad_final = pad_final
        self.proposal_topk = proposal_topk
        self.max_instances = max_instances
        self.mask_crop_size = mask_crop_size
        self.aspect_ratio_grouping = aspect_ratio_grouping
        self.num_workers = num_workers
        self.busy_seconds = 0.0
        self.map_seconds = 0.0
        self.batches = 0

    def collate(self, group: List[dict]) -> Dict[str, np.ndarray]:
        """One static batch of mapped dicts; subclasses add fields."""
        return build_static_batch(group, self.buckets, self.proposal_topk, self.max_instances, self.mask_crop_size)

    def _timed_map(self, idx, drawn):
        t0 = time.perf_counter()
        return self.dataset.map(idx, drawn), time.perf_counter() - t0

    def _mapped_stream(self) -> Iterator[dict]:
        """The sampler's records mapped, in its order, each with the draws
        made for it in that order."""

        def timed(result):
            record, seconds = result
            self.map_seconds += seconds
            return record

        if self.num_workers <= 0:
            for idx in self.sampler:
                yield timed(self._timed_map(idx, self.dataset.draw(idx)))
            return
        depth = max(self.num_workers * 2, self.batch_size)
        with ThreadPoolExecutor(self.num_workers) as pool:
            pending: collections.deque = collections.deque()
            try:
                for idx in self.sampler:
                    pending.append(pool.submit(self._timed_map, idx, self.dataset.draw(idx)))
                    if len(pending) >= depth:
                        yield timed(pending.popleft().result())
                while pending:
                    yield timed(pending.popleft().result())
            finally:
                for f in pending:
                    f.cancel()

    def _groups(self) -> Iterator[List[dict]]:
        it = self._mapped_stream()
        if self.aspect_ratio_grouping:
            yield from AspectRatioGroupedDataset(it, self.batch_size)
            return
        while True:
            group = list(itertools.islice(it, self.batch_size))
            if not group:
                return
            yield group

    def _batches(self) -> Iterator[dict]:
        groups = self._groups()
        while True:
            t0 = time.perf_counter()
            group = next(groups, None)
            if group is None:
                return
            real = len(group)
            if self.pad_final and real < self.batch_size:
                # keep the batch shape static: repeat the last image
                group = group + [group[-1]] * (self.batch_size - real)
            batch = self.collate(group)
            batch["image_ids"] = image_ids([g.get("image_id", -1) for g in group[:real]])
            self.busy_seconds += time.perf_counter() - t0
            self.batches += 1
            yield batch

    def __iter__(self) -> Iterator[dict]:
        q: "queue.Queue" = queue.Queue(maxsize=self.PREFETCH)
        done, stop = object(), threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            batches = self._batches()
            try:
                for b in batches:
                    if not put(b):
                        return
            except Exception as e:  # raised again in the consumer
                put(e)
            finally:
                batches.close()
                put(done)

        threading.Thread(target=producer, daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is done:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()  # an endless loader's consumer stopped: the producer ends

    def __len__(self):
        return (len(self.sampler) + self.batch_size - 1) // self.batch_size


def image_ids(ids: List) -> np.ndarray:
    """A batch's image ids: int64, or strings where the dataset's ids are
    strings (Pascal VOC's file ids). The JAX package casts every id to
    int64, so that a VOC id "000005" becomes 5 and its detections miss
    their ground truth (ROADMAP §3)."""
    return np.asarray(ids) if any(isinstance(i, str) for i in ids) else np.asarray(ids, dtype=np.int64)


def build_batch_data_loader(dataset: MapDataset, sampler, total_batch_size: int, *, buckets,
                            aspect_ratio_grouping: bool = True, max_instances: int = 100, mask_crop_size: int = 0,
                            proposal_topk: int = 0, num_workers: int = 0,
                            loader_class=StaticBatchLoader) -> StaticBatchLoader:
    """Batches of ``total_batch_size`` (one process holds them all) of a
    mapped dataset over an endless ``sampler``, grouped by orientation
    when ``aspect_ratio_grouping``, with the instance ground truth
    (reference build.py:261)."""
    return loader_class(dataset, sampler, total_batch_size, buckets, proposal_topk=proposal_topk,
                        max_instances=max_instances, mask_crop_size=mask_crop_size,
                        aspect_ratio_grouping=aspect_ratio_grouping, num_workers=num_workers)


def build_detection_train_loader(cfg, mapper: Optional[Callable] = None, proposal_loader: Optional[Callable] = None,
                                 loader_class=StaticBatchLoader) -> StaticBatchLoader:
    """The endless train loader of DATASETS.TRAIN (reference build.py:348):
    records filtered under DATALOADER.FILTER_EMPTY_ANNOTATIONS and, under
    MODEL.KEYPOINT_ON, ROI_KEYPOINT_HEAD.MIN_KEYPOINTS_PER_IMAGE, with the
    precomputed proposals of DATASETS.PROPOSAL_FILES_TRAIN under
    MODEL.LOAD_PROPOSALS, through ``mapper`` (the train ``DatasetMapper``
    by default), in the order of DATALOADER.SAMPLER_TRAIN, SOLVER.IMS_PER_BATCH
    a batch padded to TPU.IMAGE_BUCKETS with TPU.MAX_GT_INSTANCES instance
    slots and, under MODEL.MASK_ON, mask crops of 4x
    ROI_MASK_HEAD.POOLER_RESOLUTION. SEED (negative: fresh entropy) starts
    the sampler's and the augmentations' draws."""
    mapper = mapper or DatasetMapper(cfg, True)
    proposals = cfg.MODEL.LOAD_PROPOSALS
    dicts = get_detection_dataset_dicts(cfg.DATASETS.TRAIN, cfg.DATASETS.PROPOSAL_FILES_TRAIN if proposals else None,
                                        proposal_loader, filter_empty=cfg.DATALOADER.FILTER_EMPTY_ANNOTATIONS,
                                        min_keypoints=cfg.MODEL.ROI_KEYPOINT_HEAD.MIN_KEYPOINTS_PER_IMAGE
                                        if cfg.MODEL.KEYPOINT_ON else 0)
    rng = np.random.RandomState(cfg.SEED % 2**31 if cfg.SEED >= 0 else None)
    sampler_seed = int(rng.randint(2**31))
    mapper.rng = rng
    name = cfg.DATALOADER.SAMPLER_TRAIN
    if name == "TrainingSampler":
        sampler = TrainingSampler(len(dicts), seed=sampler_seed)
    elif name == "RepeatFactorTrainingSampler":
        factors = RepeatFactorTrainingSampler.repeat_factors_from_category_frequency(
            dicts, cfg.DATALOADER.REPEAT_THRESHOLD)
        sampler = RepeatFactorTrainingSampler(factors, seed=sampler_seed)
    else:
        raise ValueError(f"Unknown training sampler: {name}")
    return build_batch_data_loader(
        MapDataset(DatasetFromList(dicts), mapper), sampler, cfg.SOLVER.IMS_PER_BATCH, buckets=cfg.TPU.IMAGE_BUCKETS,
        aspect_ratio_grouping=cfg.DATALOADER.ASPECT_RATIO_GROUPING, max_instances=cfg.TPU.MAX_GT_INSTANCES,
        mask_crop_size=cfg.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION * 4 if cfg.MODEL.MASK_ON else 0,
        proposal_topk=cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN if proposals else 0,
        num_workers=cfg.DATALOADER.NUM_WORKERS, loader_class=loader_class)


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
