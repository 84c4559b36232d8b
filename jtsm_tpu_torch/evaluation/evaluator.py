"""Evaluator interface and the inference loop (reference:
detectron2/evaluation/evaluator.py:13, :64, :101; JAX package
``evaluation/evaluator.py:21,32,56``)."""

from __future__ import annotations

import datetime
import logging
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional

import torch

logger = logging.getLogger(__name__)


def add_time(timings: Optional[Dict[str, float]], key: str, seconds: float) -> None:
    if timings is not None:
        timings[key] = timings.get(key, 0.0) + seconds


def synchronize(outputs: Dict) -> None:
    """Waits for the card where any output lies on one, so that the time
    of the call that made them is the device's too."""
    for v in outputs.values():
        if torch.is_tensor(v) and v.is_cuda:
            torch.cuda.synchronize(v.device)
            return


class DatasetEvaluator:
    def reset(self):
        pass

    def process(self, inputs, outputs):
        pass

    def evaluate(self):
        pass


class DatasetEvaluators(DatasetEvaluator):
    """Several evaluators fed the same outputs; their results merged, each
    task from one evaluator only."""

    def __init__(self, evaluators: List[DatasetEvaluator]):
        self._evaluators = evaluators

    def reset(self):
        for evaluator in self._evaluators:
            evaluator.reset()

    def process(self, inputs, outputs):
        for evaluator in self._evaluators:
            evaluator.process(inputs, outputs)

    def evaluate(self):
        results = OrderedDict()
        for evaluator in self._evaluators:
            for k, v in (evaluator.evaluate() or {}).items():
                assert k not in results, f"Different evaluators produce results with the same key {k}"
                results[k] = v
        return results


def inference_on_dataset(predict_fn: Callable, data_loader, evaluator: DatasetEvaluator,
                         timings: Optional[Dict[str, float]] = None, postprocess: Optional[Callable] = None):
    """Runs ``predict_fn(batch) -> outputs`` over the loader, then
    ``postprocess(batch, outputs) -> outputs`` where given, and feeds the
    evaluator; the timing log leaves out the first 5 batches, as in the
    reference. ``timings`` (optional) gathers the seconds of ``model``
    (the call, ended by a device synchronize; ``model_first`` the first
    batch's alone), ``data`` (the loader's mapping and collating) and the
    ``images`` scored."""
    num_warmup = 5
    start_time = time.perf_counter()
    total_compute_time = 0.0
    total = 0
    evaluator.reset()
    for idx, inputs in enumerate(data_loader):
        if idx == num_warmup:
            start_time = time.perf_counter()
            total_compute_time = 0.0
        t0 = time.perf_counter()
        outputs = predict_fn(inputs)
        synchronize(outputs)
        seconds = time.perf_counter() - t0
        total_compute_time += seconds
        add_time(timings, "model", seconds)
        if idx == 0:
            add_time(timings, "model_first", seconds)
        if postprocess is not None:
            outputs = postprocess(inputs, outputs)
        evaluator.process(inputs, outputs)
        n = len(inputs["image_ids"])
        total += n
        add_time(timings, "images", n)
    total_time = time.perf_counter() - start_time
    scored = max(total - num_warmup, 1) if total > num_warmup else max(total, 1)
    logger.info(
        f"Total inference time: {datetime.timedelta(seconds=total_time)} ({total_time / scored:.6f} s / img); "
        f"pure compute {total_compute_time / scored:.6f} s / img"
    )
    add_time(timings, "data", getattr(data_loader, "busy_seconds", 0.0))
    return evaluator.evaluate() or {}
