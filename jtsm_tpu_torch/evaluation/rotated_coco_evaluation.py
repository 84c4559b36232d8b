"""COCO AP of rotated (XYWHA) boxes (reference:
detectron2/evaluation/rotated_coco_evaluation.py; JAX package
``evaluation/rotated_coco_evaluation.py``): ``COCOEval`` whose box IoU is
the exact IoU of rotated rectangles, and an evaluator that emits 5-dim
results. A 4-dim XYWH box on either side counts as a rotated box at angle
0; crowd ground truth is refused, as in the reference (:60).

Matching runs on the host after inference, so the IoU here is numpy
polygon clipping in float64 (the JAX package's ``:33-103``, copied), not
the model's float32 ``structures.rotated_boxes.pairwise_iou_rotated``.
"""

from __future__ import annotations

import json
import logging
import os
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from .coco_evaluation import COCOEvaluator, _numpy
from .cocoeval import COCOEval

logger = logging.getLogger(__name__)


def rotated_box_corners_np(boxes: np.ndarray) -> np.ndarray:
    """(N, 5) XYWHA (angle in degrees, counter-clockwise) -> (N, 4, 2)
    corners."""
    cx, cy, w, h, a = [boxes[:, i] for i in range(5)]
    theta = a * np.pi / 180.0
    c, s = np.cos(theta), np.sin(theta)
    dx = np.stack([w / 2, w / 2, -w / 2, -w / 2], axis=1)
    dy = np.stack([-h / 2, h / 2, h / 2, -h / 2], axis=1)
    x = cx[:, None] + dx * c[:, None] - dy * s[:, None]
    y = cy[:, None] + dx * s[:, None] + dy * c[:, None]
    return np.stack([x, y], axis=2)


def _cross2(a: np.ndarray, b: np.ndarray) -> float:
    return a[0] * b[1] - a[1] * b[0]


def _polygon_clip(subject: List[np.ndarray], clip: np.ndarray) -> List[np.ndarray]:
    """Sutherland-Hodgman: a convex polygon clipped by another."""
    out = subject
    n = len(clip)
    for i in range(n):
        p0, p1 = clip[i], clip[(i + 1) % n]
        edge = p1 - p0
        inp, out = out, []
        if not inp:
            break
        prev = inp[-1]
        prev_in = _cross2(edge, prev - p0) >= 0
        for cur in inp:
            cur_in = _cross2(edge, cur - p0) >= 0
            if cur_in != prev_in:
                d = cur - prev
                denom = _cross2(edge, d)
                if abs(denom) > 1e-12:
                    out.append(prev + _cross2(edge, p0 - prev) / denom * d)
            if cur_in:
                out.append(cur)
            prev, prev_in = cur, cur_in
    return out


def _poly_area(pts: List[np.ndarray]) -> float:
    if len(pts) < 3:
        return 0.0
    p = np.asarray(pts)
    x, y = p[:, 0], p[:, 1]
    return 0.5 * abs(float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))))


def pairwise_iou_rotated_np(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """(N, 5) x (M, 5) XYWHA -> (N, M) exact IoU in float64."""
    n, m = boxes1.shape[0], boxes2.shape[0]
    out = np.zeros((n, m))
    if n == 0 or m == 0:
        return out
    c1 = rotated_box_corners_np(boxes1.astype(np.float64))
    c2 = rotated_box_corners_np(boxes2.astype(np.float64))
    a1 = np.abs(boxes1[:, 2] * boxes1[:, 3])
    a2 = np.abs(boxes2[:, 2] * boxes2[:, 3])
    for i in range(n):
        for j in range(m):
            inter = _poly_area(_polygon_clip(list(c1[i]), c2[j]))
            union = a1[i] + a2[j] - inter
            out[i, j] = inter / union if union > 0 else 0.0
    return out


def _to_xywha(box) -> List[float]:
    box = list(map(float, box))
    if len(box) == 5:
        return box
    if len(box) != 4:
        raise ValueError(f"a box of {len(box)} numbers")
    x, y, w, h = box
    return [x + w / 2, y + h / 2, w, h, 0.0]


class RotatedCOCOEval(COCOEval):
    """``COCOEval`` with the exact rotated IoU on boxes (JAX :114; reference
    :15); 4-dim ground truth or detections count as rotated at angle 0."""

    def _compute_iou(self, dets, gts, img_id):
        if self.iou_type != "bbox":
            raise ValueError("rotated COCO evaluation scores boxes only")
        if any(g.get("iscrowd", 0) for g in gts):
            raise ValueError("crowd ground truth is not supported with rotated boxes")
        d = np.asarray([_to_xywha(det["bbox"]) for det in dets], np.float64).reshape(-1, 5)
        g = np.asarray([_to_xywha(gt["bbox"]) for gt in gts], np.float64).reshape(-1, 5)
        return pairwise_iou_rotated_np(d, g)

    def _det_area(self, det):
        bb = det["bbox"]
        return float(abs(bb[2] * bb[3]))

    def _gt_area(self, gt):
        if "area" in gt:
            return float(gt["area"])
        bb = gt["bbox"]
        return float(abs(bb[2] * bb[3]))


class RotatedCOCOEvaluator(COCOEvaluator):
    """COCO box AP of rotated detections (JAX :140; reference :97):
    ``process`` takes a rotated model's batched outputs, ``boxes`` (B, D, 5)
    XYWHA in original-image coordinates, and keeps the valid ones as 5-dim
    results; ``evaluate`` runs ``RotatedCOCOEval`` on them."""

    def process(self, inputs, outputs):
        reverse_id_mapping = None
        if hasattr(self._metadata, "thing_dataset_id_to_contiguous_id"):
            reverse_id_mapping = {v: k for k, v in self._metadata.thing_dataset_id_to_contiguous_id.items()}
        boxes, scores = _numpy(outputs["boxes"]), _numpy(outputs["scores"])
        classes, valid = _numpy(outputs["classes"]), _numpy(outputs["valid"]).astype(bool)
        image_ids = np.asarray(inputs["image_ids"])
        for i in range(scores.shape[0]):
            for j in np.nonzero(valid[i])[0]:
                cat = int(classes[i, j])
                self._predictions.append({
                    "image_id": int(image_ids[i]),
                    "category_id": reverse_id_mapping[cat] if reverse_id_mapping is not None else cat,
                    "bbox": _to_xywha(boxes[i, j]),
                    "score": float(scores[i, j]),
                })

    def evaluate(self) -> Optional[Dict]:
        predictions = self._predictions
        if len(predictions) == 0:
            logger.warning("[RotatedCOCOEvaluator] Did not receive valid predictions.")
            return {}
        if self._output_dir:
            os.makedirs(self._output_dir, exist_ok=True)
            with open(os.path.join(self._output_dir, "coco_instances_results.json"), "w") as f:
                json.dump(predictions, f)
        stats = RotatedCOCOEval(self._coco_gt, iou_type="bbox").evaluate(predictions)
        results = OrderedDict(bbox={k: 100 * v for k, v in stats.items()})
        logger.info(f"Evaluation results for rotated bbox: {results['bbox']}")
        return results
