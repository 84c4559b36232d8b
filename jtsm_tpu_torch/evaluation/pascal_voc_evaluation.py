"""Pascal VOC detection AP and CorLoc (reference:
detectron2/evaluation/pascal_voc_evaluation.py:21, the fork's AP and CorLoc
over IoU 0.50:0.05:0.95 at :118-170 and :358-452; JAX package
``evaluation/pascal_voc_evaluation.py:24-251``).

AP is VOC's: the 11-point metric for 2007, the area under the interpolated
curve otherwise; difficult boxes neither count as positives nor make a
detection false. CorLoc judges each image's top detection of a class, over
the images holding a non-difficult box of it. Boxes overlap by VOC's
inclusive pixel areas (+1). The ground truth comes from ``DatasetCatalog``,
keyed by each record's ``image_id`` (VOC's file id, a string)."""

from __future__ import annotations

import logging
import time
from collections import OrderedDict, defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.catalog import DatasetCatalog, MetadataCatalog
from .evaluator import DatasetEvaluator

logger = logging.getLogger(__name__)


def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool = False) -> float:
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.sum(rec >= t) > 0 else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1]))


def _overlaps(bb: np.ndarray, bbgt: np.ndarray) -> np.ndarray:
    """IoU of one XYXY box with (N, 4) boxes, in VOC's inclusive pixels."""
    iw = np.maximum(np.minimum(bbgt[:, 2], bb[2]) - np.maximum(bbgt[:, 0], bb[0]) + 1.0, 0.0)
    ih = np.maximum(np.minimum(bbgt[:, 3], bb[3]) - np.maximum(bbgt[:, 1], bb[1]) + 1.0, 0.0)
    inters = iw * ih
    uni = ((bb[2] - bb[0] + 1.0) * (bb[3] - bb[1] + 1.0)
           + (bbgt[:, 2] - bbgt[:, 0] + 1.0) * (bbgt[:, 3] - bbgt[:, 1] + 1.0) - inters)
    return inters / uni


def _class_records(gts_by_image: Dict) -> Dict:
    return {
        image_id: {"bbox": np.asarray(rec["bbox"], dtype=np.float64).reshape(-1, 4),
                   "difficult": np.asarray(rec["difficult"], dtype=bool)}
        for image_id, rec in gts_by_image.items()
    }


def voc_eval_class(dets: List[dict], gts_by_image: Dict, ovthresh: float = 0.5, use_07_metric: bool = False):
    """(recall, precision, AP) of one class. ``dets``: [{image_id, bbox
    XYXY, score}]; ``gts_by_image``: image_id -> {"bbox": (N, 4) XYXY,
    "difficult": (N,) bool}."""
    class_recs = _class_records(gts_by_image)
    npos = sum(int((~r["difficult"]).sum()) for r in class_recs.values())
    for r in class_recs.values():
        r["det"] = [False] * len(r["difficult"])
    dets = sorted(dets, key=lambda d: -d["score"])
    nd = len(dets)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d_i, det in enumerate(dets):
        r = class_recs.get(det["image_id"])
        ovmax, jmax = -np.inf, -1
        if r is not None and len(r["bbox"]):
            overlaps = _overlaps(np.asarray(det["bbox"], dtype=np.float64), r["bbox"])
            ovmax = np.max(overlaps)
            jmax = int(np.argmax(overlaps))
        if ovmax > ovthresh:
            if not r["difficult"][jmax]:
                if not r["det"][jmax]:
                    tp[d_i] = 1.0
                    r["det"][jmax] = True
                else:
                    fp[d_i] = 1.0
        else:
            fp[d_i] = 1.0
    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(max(npos, 1))
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec, use_07_metric)


def voc_eval_corloc_class(dets: List[dict], gts_by_image: Dict, ovthresh: float = 0.5) -> float:
    """The share of the images holding a non-difficult box of the class
    whose top detection of the class overlaps one of its boxes above
    ``ovthresh``; images whose boxes of the class are all difficult count
    in neither."""
    class_recs = _class_records(gts_by_image)
    npos_im = sum(min(1, int((~r["difficult"]).sum())) for r in class_recs.values() if len(r["difficult"]))
    if npos_im == 0:
        return 0.0
    seen = set()
    n_correct = 0
    for det in sorted(dets, key=lambda d: -d["score"]):
        image_id = det["image_id"]
        if image_id in seen:
            continue
        r = class_recs.get(image_id)
        if r is None or len(r["difficult"]) == 0 or bool(r["difficult"].all()):
            continue
        seen.add(image_id)
        if np.max(_overlaps(np.asarray(det["bbox"], dtype=np.float64), r["bbox"])) > ovthresh:
            n_correct += 1
    return n_correct / npos_im


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


class PascalVOCDetectionEvaluator(DatasetEvaluator):
    """``bbox`` AP, AP50 and AP75 and ``bbox CorLoc`` CL, CL50 and CL75:
    the means over the classes at each IoU threshold 0.50:0.05:0.95, AP and
    CL their means over the thresholds. ``process`` takes the batched
    detections in original-image coordinates (``boxes``, ``scores``,
    ``classes``, ``valid``) and the batch's ``image_ids``. ``timings``
    (optional) gathers the seconds of ``process`` and ``evaluate`` as
    ``eval``."""

    def __init__(self, dataset_name: str, timings: Optional[Dict[str, float]] = None):
        self._dataset_name = dataset_name
        meta = MetadataCatalog.get(dataset_name)
        self._class_names = meta.thing_classes
        self._is_2007 = meta.get("year", 2007) == 2007
        self._timings = timings
        self._predictions = defaultdict(list)

    def reset(self):
        self._predictions = defaultdict(list)

    def process(self, inputs, outputs):
        t0 = time.perf_counter()
        boxes, scores = _host(outputs["boxes"]), _host(outputs["scores"])
        classes, valid = _host(outputs["classes"]), _host(outputs["valid"])
        for i, image_id in enumerate(inputs["image_ids"]):
            image_id = image_id if isinstance(image_id, str) else int(image_id)
            for j in np.nonzero(valid[i])[0]:
                self._predictions[int(classes[i, j])].append(
                    {"image_id": image_id, "bbox": boxes[i, j].tolist(), "score": float(scores[i, j])})
        self._add_time(t0)

    def _add_time(self, t0: float) -> None:
        if self._timings is not None:
            self._timings["eval"] = self._timings.get("eval", 0.0) + time.perf_counter() - t0

    def gt_for_class(self, cls_idx: int) -> Dict:
        """image_id -> the class's boxes and their difficult flags."""
        gts = {}
        for d in DatasetCatalog.get(self._dataset_name):
            anns = [a for a in d.get("annotations", []) if a["category_id"] == cls_idx]
            gts[d.get("image_id", d["file_name"])] = {
                "bbox": [a["bbox"] for a in anns], "difficult": [a.get("difficult", False) for a in anns]}
        return gts

    def evaluate(self):
        t0 = time.perf_counter()
        aps = defaultdict(list)  # IoU threshold (percent) -> each class's AP
        corlocs = defaultdict(list)
        ap50_per_class = {}
        for cls_idx, cls_name in enumerate(self._class_names):
            gts = self.gt_for_class(cls_idx)
            dets = self._predictions.get(cls_idx, [])
            for thresh in range(50, 100, 5):
                _, _, ap = voc_eval_class(dets, gts, thresh / 100.0, self._is_2007)
                aps[thresh].append(ap * 100)
                corlocs[thresh].append(voc_eval_corloc_class(dets, gts, thresh / 100.0) * 100)
            ap50_per_class[cls_name] = aps[50][-1]
        m_ap = {t: float(np.mean(x)) for t, x in aps.items()}
        m_cl = {t: float(np.mean(x)) for t, x in corlocs.items()}
        ret = OrderedDict()
        ret["bbox"] = {"AP": float(np.mean(list(m_ap.values()))), "AP50": m_ap[50], "AP75": m_ap[75]}
        ret["bbox CorLoc"] = {"CL": float(np.mean(list(m_cl.values()))), "CL50": m_cl[50], "CL75": m_cl[75]}
        logger.info(f"VOC AP50: {m_ap[50]:.2f}  AP: {ret['bbox']['AP']:.2f}  CorLoc50: {m_cl[50]:.2f}")
        logger.info("per-class AP50: " + " ".join(f"{n}={v:.1f}" for n, v in ap50_per_class.items()))
        self._add_time(t0)
        return ret
