"""LVIS evaluation (reference: detectron2/evaluation/lvis_evaluation.py;
JAX package ``evaluation/lvis_evaluation.py:28,74``): the port's COCO
protocol (``cocoeval.COCOEval``) with LVIS's particulars.

* maxDets 300 (the LVIS cap of detections an image; applied per image and
  category here, which is the same whenever a model emits at most 300 an
  image, as the LVIS configurations do);
* the federated rule: a detection of a category that is neither positive
  (annotated) nor negative in its image is dropped before matching; the
  images' ``not_exhaustive_category_ids`` change nothing (as in the JAX
  package);
* APr, APc and APf: AP over the categories of each frequency bucket
  (``frequency`` "r", "c", "f"; a category without one counts as "f");
* predictions take their category id back to the dataset's (contiguous id
  + 1).

The port runs in one process: ``distributed`` is accepted and changes
nothing (the JAX package gathers across processes when it is True).
"""

from __future__ import annotations

import json
import logging
import os
import time
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from ..data.catalog import MetadataCatalog
from ..data.datasets.coco import load_json
from .coco_evaluation import batched_outputs_to_coco_json
from .cocoeval import COCOEval
from .evaluator import DatasetEvaluator, add_time

logger = logging.getLogger(__name__)


class LVISEval(COCOEval):
    """COCOEval at maxDets 300 with the federated rule and the frequency
    buckets' APs (APr, APc, APf; nan where a bucket has no category or no
    ground truth)."""

    def __init__(self, gt_dataset: Dict, iou_type: str = "bbox"):
        super().__init__(gt_dataset, iou_type, max_dets=(300,))
        self._cat_freq = {c["id"]: c.get("frequency", "f") for c in gt_dataset.get("categories", [])}
        self._img_neg = {img["id"]: set(img.get("neg_category_ids", [])) for img in gt_dataset["images"]}
        self._img_pos: Dict = {}
        for ann in gt_dataset.get("annotations", []):
            self._img_pos.setdefault(ann["image_id"], set()).add(ann["category_id"])

    def _keep_det(self, det) -> bool:
        cat = det["category_id"]
        return cat in self._img_pos.get(det["image_id"], ()) or cat in self._img_neg.get(det["image_id"], ())

    def evaluate(self, detections: List[Dict], img_ids=None) -> Dict[str, float]:
        stats = super().evaluate([d for d in detections if self._keep_det(d)], img_ids)
        for bucket, key in (("r", "APr"), ("c", "APc"), ("f", "APf")):
            ks = [ki for ki, cid in enumerate(self.cat_ids) if self._cat_freq.get(cid) == bucket]
            stats[key] = float("nan")
            if ks:
                s = self.precision[:, :, ks, 0, -1]
                valid = s[s > -1]
                if valid.size:
                    stats[key] = float(np.mean(valid))
        return stats


class LVISEvaluator(DatasetEvaluator):
    """bbox (and segm when the model emits masks) LVIS numbers against the
    dataset's LVIS json (a path, or a dict for a set made in memory).
    ``timings`` (optional) gathers the seconds of ``paste``, ``encode`` and
    ``eval``."""

    def __init__(self, dataset_name: str, distributed: bool = True, output_dir: Optional[str] = None,
                 timings: Optional[Dict[str, float]] = None):
        self._output_dir = output_dir
        self._timings = timings
        self._metadata = MetadataCatalog.get(dataset_name)
        self._gt = load_json(self._metadata.json_file)
        self._do_masks = False
        self._predictions: List[dict] = []

    def reset(self):
        self._predictions = []

    def process(self, inputs, outputs):
        with_masks = "masks" in outputs
        self._do_masks = self._do_masks or with_masks
        preds = batched_outputs_to_coco_json(outputs, inputs["image_ids"], inputs["orig_sizes"], None, with_masks,
                                             self._timings)
        for p in preds:
            p["category_id"] += 1  # the contiguous ids are the dataset's minus 1
        self._predictions.extend(preds)

    @property
    def predictions(self) -> List[dict]:
        return self._predictions

    def evaluate(self) -> Dict:
        predictions = self._predictions
        if not predictions:
            logger.warning("[LVISEvaluator] no predictions")
            return {}
        if self._output_dir:
            os.makedirs(self._output_dir, exist_ok=True)
            with open(os.path.join(self._output_dir, "lvis_instances_results.json"), "w") as f:
                json.dump(predictions, f)
        t0 = time.perf_counter()
        results = OrderedDict()
        for task in ("bbox", "segm") if self._do_masks else ("bbox",):
            stats = LVISEval(self._gt, iou_type=task).evaluate(predictions)
            results[task] = {k: 100 * v for k, v in stats.items()}
            logger.info(f"LVIS {task}: {results[task]}")
        add_time(self._timings, "eval", time.perf_counter() - t0)
        return results
