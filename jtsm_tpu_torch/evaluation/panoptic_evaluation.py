"""Panoptic quality (reference: detectron2/evaluation/panoptic_evaluation.py:23
``COCOPanopticEvaluator``, which calls panopticapi's ``pq_compute``; JAX
package ``evaluation/panoptic_evaluation.py``, which writes it out): a
predicted and a ground-truth segment of one category match at IoU above
0.5, the IoU's union leaving out the prediction's void pixels; per class
PQ = sum IoU / (TP + FP/2 + FN/2), SQ = sum IoU / TP, RQ = TP / (TP + FP/2
+ FN/2), averaged over the classes that occur, over things and over stuff.
Crowd segments match nothing and are no false negatives; a prediction
mostly on void, or on a crowd segment of its class, is no false positive.

Ground truth: the dataset's ``panoptic_json`` (a path or the dict) and, per
image, the record's ``pan_seg`` id map (datasets made in memory) or the PNG
under ``panoptic_root``, read with Pillow (id = R + 256 G + 256^2 B).
"""

from __future__ import annotations

import logging
import os
import time
from collections import OrderedDict, defaultdict
from typing import Dict, List, Optional

import numpy as np

from ..data.catalog import DatasetCatalog, MetadataCatalog
from ..data.datasets.coco import load_json
from ..data.detection_utils import read_sem_seg
from .evaluator import DatasetEvaluator, add_time

logger = logging.getLogger(__name__)

VOID = 0
OFFSET = 256 * 256 * 256


def rgb2id(color: np.ndarray) -> np.ndarray:
    """panopticapi's id of an (..., 3) colour: R + 256 G + 256^2 B."""
    color = color.astype(np.uint32)
    return color[..., 0] + 256 * color[..., 1] + 256 * 256 * color[..., 2]


class PQStat:
    def __init__(self):
        self.per_cat = defaultdict(lambda: {"iou": 0.0, "tp": 0, "fp": 0, "fn": 0})

    def __iadd__(self, other: "PQStat"):
        for k, v in other.per_cat.items():
            s = self.per_cat[k]
            for f in ("iou", "tp", "fp", "fn"):
                s[f] += v[f]
        return self

    def pq_average(self, categories: Dict[int, dict], isthing: Optional[bool] = None):
        pq, sq, rq, n = 0.0, 0.0, 0.0, 0
        for cat_id, cat in categories.items():
            if isthing is not None and bool(cat["isthing"]) != isthing:
                continue
            s = self.per_cat[cat_id]
            tp, fp, fn = s["tp"], s["fp"], s["fn"]
            if tp + fp + fn == 0:
                continue
            n += 1
            pq += s["iou"] / (tp + 0.5 * fp + 0.5 * fn)
            sq += s["iou"] / tp if tp != 0 else 0.0
            rq += tp / (tp + 0.5 * fp + 0.5 * fn)
        if n == 0:
            return {"pq": 0.0, "sq": 0.0, "rq": 0.0, "n": 0}
        return {"pq": pq / n, "sq": sq / n, "rq": rq / n, "n": n}


def pq_compute_single_image(pan_gt: np.ndarray, pan_pred: np.ndarray, gt_segments: List[dict],
                            pred_segments: List[dict]) -> PQStat:
    """One image's PQ statistics from (H, W) segment-id maps and their
    segments ({id, category_id, iscrowd?})."""
    stat = PQStat()
    gt_info = {s["id"]: s for s in gt_segments}
    pred_info = {s["id"]: s for s in pred_segments}
    gt_area_map = dict(zip(*(a.tolist() for a in np.unique(pan_gt, return_counts=True))))
    pred_area_map = dict(zip(*(a.tolist() for a in np.unique(pan_pred, return_counts=True))))
    combined = pan_gt.astype(np.uint64) * OFFSET + pan_pred.astype(np.uint64)
    inter = {(cid // OFFSET, cid % OFFSET): area
             for cid, area in zip(*(a.tolist() for a in np.unique(combined, return_counts=True)))}

    matched_gt, matched_pred = set(), set()
    for (gt_id, pred_id), intersection in inter.items():
        if gt_id not in gt_info or pred_id not in pred_info:
            continue
        g, p = gt_info[gt_id], pred_info[pred_id]
        if g.get("iscrowd", 0) == 1 or g["category_id"] != p["category_id"]:
            continue
        union = (gt_area_map.get(gt_id, 0) + pred_area_map.get(pred_id, 0) - intersection
                 - inter.get((VOID, pred_id), 0))
        iou = intersection / union if union > 0 else 0.0
        if iou > 0.5:
            s = stat.per_cat[g["category_id"]]
            s["tp"] += 1
            s["iou"] += iou
            matched_gt.add(gt_id)
            matched_pred.add(pred_id)

    crowd_by_cat = {}
    for gt_id, g in gt_info.items():
        if gt_id in matched_gt:
            continue
        if g.get("iscrowd", 0) == 1:
            crowd_by_cat[g["category_id"]] = gt_id
            continue
        stat.per_cat[g["category_id"]]["fn"] += 1
    for pred_id, p in pred_info.items():
        if pred_id in matched_pred:
            continue
        intersection = inter.get((VOID, pred_id), 0)
        if p["category_id"] in crowd_by_cat:
            intersection += inter.get((crowd_by_cat[p["category_id"]], pred_id), 0)
        if intersection / max(pred_area_map.get(pred_id, 1), 1) > 0.5:
            continue
        stat.per_cat[p["category_id"]]["fp"] += 1
    return stat


class COCOPanopticEvaluator(DatasetEvaluator):
    """PQ, SQ and RQ, over all classes and over things and stuff, of the
    fused ``panoptic_seg`` outputs: per image (id map, segments with
    contiguous category ids and ``isthing``). ``timings`` (optional)
    gathers the seconds of ``process`` and ``evaluate`` under
    ``eval_panoptic_seg``."""

    def __init__(self, dataset_name: str, output_dir: Optional[str] = None,
                 timings: Optional[Dict[str, float]] = None):
        self._metadata = MetadataCatalog.get(dataset_name)
        self._output_dir = output_dir
        self._timings = timings
        self._thing_reverse = {v: k for k, v in self._metadata.get("thing_dataset_id_to_contiguous_id", {}).items()}
        self._stuff_reverse = {v: k for k, v in self._metadata.get("stuff_dataset_id_to_contiguous_id", {}).items()}
        self._gt_maps = {d["image_id"]: d["pan_seg"] for d in DatasetCatalog.get(dataset_name) if "pan_seg" in d}
        self._predictions: List[dict] = []

    def reset(self):
        self._predictions = []

    def _convert_category_id(self, segment_info: dict) -> dict:
        if segment_info.get("isthing") is True:
            return dict(segment_info, category_id=self._thing_reverse[segment_info["category_id"]])
        if segment_info.get("isthing") is False:
            return dict(segment_info, category_id=self._stuff_reverse[segment_info["category_id"]])
        return segment_info

    def process(self, inputs, outputs):
        t0 = time.perf_counter()
        for i, (panoptic_img, segments_info) in enumerate(outputs["panoptic_seg"]):
            self._predictions.append({
                "image_id": int(inputs["image_ids"][i]),
                "id_map": np.asarray(panoptic_img),
                "segments_info": [self._convert_category_id(s) for s in segments_info],
            })
        add_time(self._timings, "eval_panoptic_seg", time.perf_counter() - t0)

    def _gt_map(self, ann: dict) -> np.ndarray:
        if ann["image_id"] in self._gt_maps:
            return np.asarray(self._gt_maps[ann["image_id"]])
        return rgb2id(read_sem_seg(os.path.join(self._metadata.panoptic_root, ann["file_name"])))

    def evaluate(self):
        t0 = time.perf_counter()
        gt = load_json(self._metadata.panoptic_json)
        gt_by_image = {a["image_id"]: a for a in gt["annotations"]}
        categories = {c["id"]: c for c in gt["categories"]}
        stat = PQStat()
        for pred in self._predictions:
            ann = gt_by_image.get(pred["image_id"])
            if ann is None:
                continue
            stat += pq_compute_single_image(self._gt_map(ann), pred["id_map"], ann["segments_info"],
                                            pred["segments_info"])
        res = {}
        for suffix, isthing in (("", None), ("_th", True), ("_st", False)):
            m = stat.pq_average(categories, isthing=isthing)
            res.update({f"PQ{suffix}": 100 * m["pq"], f"SQ{suffix}": 100 * m["sq"], f"RQ{suffix}": 100 * m["rq"]})
        results = OrderedDict({"panoptic_seg": res})
        logger.info(results)
        add_time(self._timings, "eval_panoptic_seg", time.perf_counter() - t0)
        return results
