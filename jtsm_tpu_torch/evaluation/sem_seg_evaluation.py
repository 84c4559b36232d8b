"""Semantic segmentation evaluation (reference:
detectron2/evaluation/sem_seg_evaluation.py:19; JAX package
``evaluation/sem_seg_evaluation.py:23``): a confusion matrix over the
dataset's ``stuff_classes`` with the ignore label as an extra row, then
mIoU, fwIoU, mACC, pACC and each class's IoU.

The numbers follow the JAX package as it is written: IoU is computed for
the classes with ground truth (``acc_valid``) and mIoU divides their sum by
the count of classes with ground truth or predictions (``iou_valid``).

Ground truth: a record's ``sem_seg`` array (datasets made in memory), or
its ``sem_seg_file_name`` PNG, read with Pillow.
"""

from __future__ import annotations

import json
import logging
import os
import time
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np

from ..data.catalog import DatasetCatalog, MetadataCatalog
from ..data.detection_utils import read_sem_seg
from .evaluator import DatasetEvaluator, add_time

logger = logging.getLogger(__name__)


class SemSegEvaluator(DatasetEvaluator):
    """``timings`` (optional) gathers the seconds of ``process`` and
    ``evaluate`` under ``eval_sem_seg``."""

    def __init__(self, dataset_name: str, output_dir: Optional[str] = None,
                 timings: Optional[Dict[str, float]] = None):
        self._output_dir = output_dir
        self._timings = timings
        meta = MetadataCatalog.get(dataset_name)
        self._num_classes = len(meta.stuff_classes)
        self._ignore_label = meta.get("ignore_label", 255)
        self._class_names = meta.stuff_classes
        self._gt_by_id = {}
        for d in DatasetCatalog.get(dataset_name):
            gt = d.get("sem_seg", d.get("sem_seg_file_name"))
            if gt is not None:
                self._gt_by_id[d.get("image_id", d["file_name"])] = gt
        self._conf_matrix = None

    def reset(self):
        self._conf_matrix = np.zeros((self._num_classes + 1, self._num_classes + 1), dtype=np.int64)

    def process(self, inputs, outputs):
        """``outputs["sem_seg"]``: per image an (H, W) map of class ids at
        the original size (or (H, W, C) logits), cropped to the ground
        truth's size."""
        t0 = time.perf_counter()
        preds = outputs["sem_seg"]
        for i in range(len(preds)):
            gt = self._gt_by_id.get(int(inputs["image_ids"][i]))
            if gt is None:
                continue
            gt = read_sem_seg(gt, np.int64) if isinstance(gt, str) else np.array(gt, dtype=np.int64)
            pred = preds[i]
            pred = pred.detach().cpu().numpy() if hasattr(pred, "detach") else np.asarray(pred)
            if pred.ndim == 3:
                pred = pred.argmax(-1)
            h, w = gt.shape
            pred = pred[:h, :w].astype(np.int64)
            gt[gt == self._ignore_label] = self._num_classes
            self._conf_matrix += np.bincount(
                (self._num_classes + 1) * pred.reshape(-1) + gt.reshape(-1), minlength=self._conf_matrix.size
            ).reshape(self._conf_matrix.shape)
        add_time(self._timings, "eval_sem_seg", time.perf_counter() - t0)

    def evaluate(self):
        t0 = time.perf_counter()
        acc = np.full(self._num_classes, np.nan, dtype=np.float64)
        iou = np.full(self._num_classes, np.nan, dtype=np.float64)
        tp = self._conf_matrix.diagonal()[:-1].astype(np.float64)
        pos_gt = np.sum(self._conf_matrix[:-1, :-1], axis=0).astype(np.float64)
        class_weights = pos_gt / max(np.sum(pos_gt), 1)
        pos_pred = np.sum(self._conf_matrix[:-1, :-1], axis=1).astype(np.float64)
        acc_valid = pos_gt > 0
        acc[acc_valid] = tp[acc_valid] / pos_gt[acc_valid]
        iou_valid = (pos_gt + pos_pred) > 0
        union = pos_gt + pos_pred - tp
        iou[acc_valid] = tp[acc_valid] / union[acc_valid]
        macc = np.sum(acc[acc_valid]) / max(np.sum(acc_valid), 1)
        miou = np.sum(iou[acc_valid]) / max(np.sum(iou_valid), 1)
        fiou = np.sum(iou[acc_valid] * class_weights[acc_valid])
        pacc = np.sum(tp) / max(np.sum(pos_gt), 1)
        res = {"mIoU": 100 * miou, "fwIoU": 100 * fiou, "mACC": 100 * macc, "pACC": 100 * pacc}
        for i, name in enumerate(self._class_names):
            res[f"IoU-{name}"] = 100 * iou[i]
        if self._output_dir:
            os.makedirs(self._output_dir, exist_ok=True)
            with open(os.path.join(self._output_dir, "sem_seg_evaluation.json"), "w") as f:
                json.dump(res, f)
        results = OrderedDict({"sem_seg": res})
        logger.info(results)
        add_time(self._timings, "eval_sem_seg", time.perf_counter() - t0)
        return results
