"""Scoring a model on the test datasets (reference:
detectron2/engine/defaults.py:504 ``DefaultTrainer.test``; JAX package
``engine/defaults.py:473-575``), as module-level functions: ``DefaultTrainer``
itself waits for the train loader (ROADMAP queue 1). The functions that
build the test loader and the evaluator are arguments, so that the WSL
command (``wsl/train_net.py``) runs the same loop with its own."""

from __future__ import annotations

import logging
import os
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional

from ..data import MetadataCatalog, build_detection_test_loader
from ..evaluation import COCOEvaluator, inference_on_dataset, print_csv_format
from ..evaluation.evaluator import add_time
from ..modeling.meta_arch.panoptic_fpn import panoptic_fusion_postprocess

logger = logging.getLogger(__name__)


def build_test_loader(cfg, dataset_name: str):
    return build_detection_test_loader(cfg, dataset_name, batch_size=max(1, cfg.TEST.IMS_PER_BATCH))


def build_evaluator(cfg, dataset_name: str, timings: Optional[Dict[str, float]] = None):
    """COCOEvaluator for a COCO dataset, writing its results under
    OUTPUT_DIR/inference; other evaluators are not ported yet."""
    evaluator_type = MetadataCatalog.get(dataset_name).get("evaluator_type", "coco")
    if evaluator_type != "coco" or cfg.MODEL.META_ARCHITECTURE != "GeneralizedRCNN":
        raise NotImplementedError(f"no evaluator ported yet for {dataset_name} ({evaluator_type})")
    return COCOEvaluator(dataset_name, output_dir=os.path.join(cfg.OUTPUT_DIR, "inference"), timings=timings)


def test(cfg, model, evaluators: Optional[List] = None, timings: Optional[Dict[str, float]] = None,
         build_test_loader: Callable = build_test_loader, build_evaluator: Callable = build_evaluator):
    """Scores ``model`` (on its device) on each of DATASETS.TEST; returns
    {dataset: {task: {metric: value}}}, or the one dataset's dict when
    there is one. A final batch that the loader padded is trimmed to its
    real images. On a ``coco_panoptic_seg`` dataset with
    MODEL.PANOPTIC_FPN.COMBINE.ENABLED, the outputs are fused into panoptic
    maps (``panoptic_fusion_postprocess``) before the evaluators see them.
    ``timings`` (optional) gathers the seconds of each stage
    (``evaluation.inference_on_dataset``, ``fusion``, and the evaluators
    built here)."""
    if cfg.TEST.AUG.ENABLED:
        raise NotImplementedError("test-time augmentation is not ported yet (ROADMAP queue 1)")
    combine = cfg.MODEL.PANOPTIC_FPN.COMBINE
    results = OrderedDict()
    for idx, dataset_name in enumerate(cfg.DATASETS.TEST):
        data_loader = build_test_loader(cfg, dataset_name)
        evaluator = evaluators[idx] if evaluators is not None else build_evaluator(cfg, dataset_name, timings=timings)
        combine_on = combine.ENABLED and MetadataCatalog.get(dataset_name).get("evaluator_type") == "coco_panoptic_seg"

        def predict(batch):
            out = model.inference({k: v for k, v in batch.items() if k != "image_ids"})
            nreal = len(batch["image_ids"])
            if nreal < batch["image"].shape[0]:
                # the loader padded the final batch with copies: drop them
                out = {k: v[:nreal] for k, v in out.items()}
            return out

        def fuse(batch, out):
            if not (combine_on and "sem_seg_logits" in out and "boxes" in out):
                return out
            t0 = time.perf_counter()
            out = panoptic_fusion_postprocess(out, batch["image_sizes"], batch["orig_sizes"], combine.OVERLAP_THRESH,
                                              combine.STUFF_AREA_LIMIT, combine.INSTANCES_CONFIDENCE_THRESH)
            add_time(timings, "fusion", time.perf_counter() - t0)
            return out

        results[dataset_name] = inference_on_dataset(predict, data_loader, evaluator, timings, postprocess=fuse)
        print_csv_format(results[dataset_name])
    if len(results) == 1:
        results = list(results.values())[0]
    return results
