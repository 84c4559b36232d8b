"""COCO evaluation of the model's batched outputs (reference:
detectron2/evaluation/coco_evaluation.py:30 ``COCOEvaluator``, :357
``instances_to_coco_json``; JAX package ``evaluation/coco_evaluation.py:64,
135,168``).

Masks are pasted at each image's original size on the outputs' device
(``ops.paste_masks``), then run-length encoded on the host in numpy.
"""

from __future__ import annotations

import json
import logging
import os
import time
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.catalog import MetadataCatalog
from ..data.datasets.coco import load_json
from ..data.rle import rle_string_encode
from ..ops.paste_masks import paste_masks
from .cocoeval import COCOEval
from .evaluator import DatasetEvaluator, add_time

logger = logging.getLogger(__name__)


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def batched_outputs_to_coco_json(
    outputs: Dict,
    image_ids: np.ndarray,
    orig_sizes: np.ndarray,
    reverse_id_mapping: Optional[Dict[int, int]] = None,
    with_masks: bool = False,
    timings: Optional[Dict[str, float]] = None,
) -> List[dict]:
    """Fixed-capacity (B, D, ...) detections (tensors or arrays) -> COCO
    result dicts, image by image in slot order, valid slots only. With
    ``with_masks``, each image's valid masks are pasted at its original
    size in one batched call and encoded as compressed RLE. ``timings``
    (optional) gathers the seconds of the ``paste`` and the ``encode``."""
    boxes, scores = _numpy(outputs["boxes"]), _numpy(outputs["scores"])
    classes, valid = _numpy(outputs["classes"]), _numpy(outputs["valid"]).astype(bool)
    masks = outputs.get("masks") if with_masks else None
    if masks is not None and not torch.is_tensor(masks):
        masks = torch.as_tensor(np.asarray(masks))
    results = []
    for i in range(scores.shape[0]):
        img_id = int(image_ids[i])
        h, w = int(orig_sizes[i][0]), int(orig_sizes[i][1])
        slots = np.nonzero(valid[i])[0]
        rles = None
        if masks is not None and len(slots):
            t0 = time.perf_counter()
            sel = torch.as_tensor(slots, device=masks.device)
            pasted = paste_masks(masks[i][sel], torch.as_tensor(boxes[i][slots], device=masks.device), h, w)
            pasted = pasted.cpu().numpy()
            t1 = time.perf_counter()
            rles = [rle_string_encode(m) for m in pasted]
            add_time(timings, "paste", t1 - t0)
            add_time(timings, "encode", time.perf_counter() - t1)
        for n, j in enumerate(slots):
            x0, y0, x1, y1 = boxes[i, j].tolist()
            cat = int(classes[i, j])
            res = {
                "image_id": img_id,
                "category_id": reverse_id_mapping[cat] if reverse_id_mapping is not None else cat,
                "bbox": [x0, y0, x1 - x0, y1 - y0],
                "score": float(scores[i, j]),
            }
            if rles is not None:
                res["segmentation"] = rles[n]
            results.append(res)
    return results


class COCOEvaluator(DatasetEvaluator):
    """bbox AP, and segm AP when the model emits masks, against the
    dataset's COCO json. ``timings`` (optional) gathers the seconds of
    ``paste``, ``encode`` and ``eval``."""

    def __init__(self, dataset_name: str, output_dir: Optional[str] = None,
                 timings: Optional[Dict[str, float]] = None):
        self._output_dir = output_dir
        self._metadata = MetadataCatalog.get(dataset_name)
        self._timings = timings
        if not hasattr(self._metadata, "json_file"):
            raise NotImplementedError(
                f"'{dataset_name}' has no COCO json; converting dataset dicts to COCO is not ported yet"
            )
        self._coco_gt = load_json(self._metadata.json_file)
        self._do_masks = False
        self._predictions: List[dict] = []

    def reset(self):
        self._predictions = []

    def process(self, inputs, outputs):
        reverse_id_mapping = None
        if hasattr(self._metadata, "thing_dataset_id_to_contiguous_id"):
            reverse_id_mapping = {v: k for k, v in self._metadata.thing_dataset_id_to_contiguous_id.items()}
        with_masks = "masks" in outputs
        self._do_masks = self._do_masks or with_masks
        self._predictions.extend(batched_outputs_to_coco_json(
            outputs, inputs["image_ids"], inputs["orig_sizes"], reverse_id_mapping, with_masks, self._timings
        ))

    @property
    def predictions(self) -> List[dict]:
        return self._predictions

    def evaluate(self) -> Optional[Dict]:
        predictions = self._predictions
        if len(predictions) == 0:
            logger.warning("[COCOEvaluator] Did not receive valid predictions.")
            return {}
        if self._output_dir:
            os.makedirs(self._output_dir, exist_ok=True)
            with open(os.path.join(self._output_dir, "coco_instances_results.json"), "w") as f:
                json.dump(predictions, f)
        tasks = ("bbox", "segm") if self._do_masks else ("bbox",)
        t0 = time.perf_counter()
        results = OrderedDict()
        for task in tasks:
            stats = COCOEval(self._coco_gt, iou_type=task).evaluate(predictions)
            results[task] = {k: 100 * v for k, v in stats.items()}
            logger.info(f"Evaluation results for {task}: {results[task]}")
        add_time(self._timings, "eval", time.perf_counter() - t0)
        return results
