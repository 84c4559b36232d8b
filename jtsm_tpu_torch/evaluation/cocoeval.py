"""COCO box, mask and keypoint AP in numpy, no pycocotools (JAX package
``evaluation/cocoeval.py:38,58,83,117,155,375``): greedy matching per
(image, category) over IoU (for keypoints OKS) thresholds .50:.05:.95 with
crowd and ignore handling, four area ranges, maxDets 1/10/100, and
101-point interpolated precision. Keypoints report the JAX package's ten
numbers (no small range; ``cocoeval.py:255-260``).

The JAX package routes the matching through a g++-built library when g++
is present (``fast_eval_api.py``, ``rle_native.py``); this is its numpy
path, which gives the same 12 numbers (``tests/test_torch_evaluation.py``).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..data.rle import decode_segmentation, rle_area

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNGS = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = (1, 10, 100)
# COCO's per-keypoint OKS sigmas of the 17 person keypoints
OKS_SIGMAS = np.array(
    [0.26, 0.25, 0.25, 0.35, 0.35, 0.79, 0.79, 0.72, 0.72, 0.62, 0.62, 1.07, 1.07, 0.87, 0.87, 0.89, 0.89]
) / 10.0


def box_iou_xywh(dets: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """(D, 4) x (G, 4) XYWH -> (D, G); a crowd box divides by the
    detection's area."""
    out = np.zeros((dets.shape[0], gts.shape[0]))
    if out.size == 0:
        return out
    dx1, dy1 = dets[:, 0] + dets[:, 2], dets[:, 1] + dets[:, 3]
    gx1, gy1 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    iw = np.clip(np.minimum(dx1[:, None], gx1[None, :]) - np.maximum(dets[:, 0][:, None], gts[:, 0][None, :]), 0, None)
    ih = np.clip(np.minimum(dy1[:, None], gy1[None, :]) - np.maximum(dets[:, 1][:, None], gts[:, 1][None, :]), 0, None)
    inter = iw * ih
    da = (dets[:, 2] * dets[:, 3])[:, None]
    ga = (gts[:, 2] * gts[:, 3])[None, :]
    union = np.where(iscrowd[None, :], da, da + ga - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def mask_iou(det_rles: List, gt_segms: List, iscrowd: np.ndarray, h: int, w: int) -> np.ndarray:
    """(D, G) IoU of detection RLEs against ground-truth segmentations
    (polygons or RLEs, rasterised at h x w); a crowd divides by the
    detection's area."""
    out = np.zeros((len(det_rles), len(gt_segms)))
    if out.size == 0:
        return out
    det_masks = [decode_segmentation(r, h, w) for r in det_rles]
    gt_masks = [decode_segmentation(r, h, w) for r in gt_segms]
    det_areas = [m.sum() for m in det_masks]
    gt_areas = [m.sum() for m in gt_masks]
    for i, dm in enumerate(det_masks):
        for j, gm in enumerate(gt_masks):
            inter = np.logical_and(dm, gm).sum()
            denom = det_areas[i] if iscrowd[j] else det_areas[i] + gt_areas[j] - inter
            out[i, j] = inter / denom if denom > 0 else 0.0
    return out


def oks_iou(dets_kpts: List, gts: List[dict], sigmas: Optional[np.ndarray] = None) -> np.ndarray:
    """(D, G) object keypoint similarity of detections' flat (x, y, v)
    keypoints against ground-truth annotations: over the labelled keypoints
    of each ground truth, or, where it has none, the distance outside its
    box doubled on each side; each squared distance over (2 sigma)^2, the
    ground truth's area and 2 (JAX package ``cocoeval.py:83``)."""
    out = np.zeros((len(dets_kpts), len(gts)))
    if out.size == 0:
        return out
    vars_ = ((OKS_SIGMAS if sigmas is None else np.asarray(sigmas)) * 2) ** 2
    for j, gt in enumerate(gts):
        gk = np.asarray(gt["keypoints"], dtype=np.float64).reshape(-1, 3)
        xg, yg, vg = gk[:, 0], gk[:, 1], gk[:, 2]
        k1 = int((vg > 0).sum())
        bb = gt["bbox"]
        x0, y0 = bb[0] - bb[2], bb[1] - bb[3]
        x1, y1 = bb[0] + bb[2] * 2, bb[1] + bb[3] * 2
        area = gt.get("area", bb[2] * bb[3])
        for i, det in enumerate(dets_kpts):
            dk = np.asarray(det, dtype=np.float64).reshape(-1, 3)
            xd, yd = dk[:, 0], dk[:, 1]
            if k1 > 0:
                dx, dy = xd - xg, yd - yg
            else:
                dx = np.maximum(0, x0 - xd) + np.maximum(0, xd - x1)
                dy = np.maximum(0, y0 - yd) + np.maximum(0, yd - y1)
            e = (dx**2 + dy**2) / vars_ / (area + np.spacing(1)) / 2
            if k1 > 0:
                e = e[vg > 0]
            out[i, j] = np.sum(np.exp(-e)) / e.shape[0] if e.shape[0] else 0.0
    return out


class COCOEval:
    """Detections against a COCO-format ground-truth dict. ``kpt_oks_sigmas``
    (keypoints only): the per-keypoint sigmas, COCO's when empty;
    ``max_dets``: the detection caps per (image, category), the last one
    the cap of the AP numbers (LVIS: 300)."""

    def __init__(self, gt_dataset: Dict, iou_type: str = "bbox", kpt_oks_sigmas=None,
                 max_dets: Sequence[int] = MAX_DETS):
        if iou_type not in ("bbox", "segm", "keypoints"):
            raise NotImplementedError(f"COCO {iou_type!r} evaluation is not ported yet")
        self.iou_type = iou_type
        self.oks_sigmas = (np.asarray(kpt_oks_sigmas, dtype=np.float64)
                           if kpt_oks_sigmas is not None and len(kpt_oks_sigmas) else OKS_SIGMAS)
        self.max_dets = tuple(max_dets)
        self.imgs = {img["id"]: img for img in gt_dataset["images"]}
        self.cat_ids = sorted(c["id"] for c in gt_dataset.get("categories", []))
        self._gts = defaultdict(list)
        for ann in gt_dataset.get("annotations", []):
            self._gts[(ann["image_id"], ann["category_id"])].append(ann)

    def evaluate(self, detections: List[Dict], img_ids: Optional[Sequence] = None) -> Dict[str, float]:
        """``detections``: COCO results (image_id, category_id, score, bbox or
        segmentation). Returns the 12 standard numbers (fractions; nan
        where no ground truth falls in an area range)."""
        img_ids = sorted(self.imgs) if img_ids is None else list(img_ids)
        dts = defaultdict(list)
        for det in detections:
            dts[(det["image_id"], det["category_id"])].append(det)
        a_names = list(AREA_RNGS)
        k_count = len(self.cat_ids)
        max_det = max(self.max_dets)

        eval_imgs = {}
        for ki, cat_id in enumerate(self.cat_ids):
            for img_id in img_ids:
                gts = self._gts.get((img_id, cat_id), [])
                # a stable sort: equal scores keep the order of the results list
                dets = sorted(dts.get((img_id, cat_id), []), key=lambda d: -d["score"])[:max_det]
                if len(gts) == 0 and len(dets) == 0:
                    continue
                ious = self._compute_iou(dets, gts, img_id)
                det_areas = np.asarray([self._det_area(d) for d in dets])
                for ai, aname in enumerate(a_names):
                    eval_imgs[(ki, ai, img_id)] = self._match(dets, gts, ious, det_areas, AREA_RNGS[aname])

        precision = -np.ones((len(IOU_THRS), len(REC_THRS), k_count, len(a_names), len(self.max_dets)))
        recall = -np.ones((len(IOU_THRS), k_count, len(a_names), len(self.max_dets)))
        for ki in range(k_count):
            for ai in range(len(a_names)):
                for di, md in enumerate(self.max_dets):
                    entries = [eval_imgs[(ki, ai, i)] for i in img_ids if (ki, ai, i) in eval_imgs]
                    if not entries:
                        continue
                    n_gt = sum(e["num_gt"] for e in entries)
                    if n_gt == 0:
                        continue
                    scores = np.concatenate([e["scores"][:md] for e in entries])
                    order = np.argsort(-scores, kind="mergesort")
                    matched = np.concatenate([e["det_matched"][:, :md] for e in entries], axis=1)[:, order]
                    det_ignore = np.concatenate([e["det_ignore"][:, :md] for e in entries], axis=1)[:, order]
                    tp_sum = np.cumsum(matched & ~det_ignore, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(~matched & ~det_ignore, axis=1).astype(np.float64)
                    for ti in range(len(IOU_THRS)):
                        tp, fp = tp_sum[ti], fp_sum[ti]
                        rc = tp / n_gt
                        pr = (tp / np.maximum(tp + fp, np.spacing(1))).tolist()
                        recall[ti, ki, ai, di] = rc[-1] if len(rc) else 0
                        for i in range(len(pr) - 1, 0, -1):  # make precision monotone
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        q = np.zeros(len(REC_THRS))
                        for ri, pi in enumerate(inds):
                            if pi < len(pr):
                                q[ri] = pr[pi]
                        precision[ti, :, ki, ai, di] = q
        self.precision, self.recall = precision, recall

        def summarize(ap=True, iou_thr=None, area="all", max_dets=None):
            ai = a_names.index(area)
            di = self.max_dets.index(max_dets if max_dets is not None else self.max_dets[-1])
            s = precision if ap else recall
            if iou_thr is not None:
                s = s[np.where(np.isclose(IOU_THRS, iou_thr))[0]]
            s = s[:, :, :, ai, di] if ap else s[:, :, ai, di]
            valid = s[s > -1]
            return float(np.mean(valid)) if valid.size else float("nan")

        if self.iou_type == "keypoints":
            stats = {
                "AP": summarize(True), "AP50": summarize(True, 0.5), "AP75": summarize(True, 0.75),
                "APm": summarize(True, area="medium"), "APl": summarize(True, area="large"),
                "AR": summarize(False), "AR50": summarize(False, 0.5), "AR75": summarize(False, 0.75),
                "ARm": summarize(False, area="medium"), "ARl": summarize(False, area="large"),
            }
        else:
            stats = self._box_stats(summarize)
        self.per_category_ap = {}
        for ki, cat_id in enumerate(self.cat_ids):
            s = precision[:, :, ki, 0, len(self.max_dets) - 1]
            valid = s[s > -1]
            self.per_category_ap[cat_id] = float(np.mean(valid)) if valid.size else float("nan")
        return stats

    def _box_stats(self, summarize) -> Dict[str, float]:
        return {
            "AP": summarize(True),
            "AP50": summarize(True, iou_thr=0.5),
            "AP75": summarize(True, iou_thr=0.75),
            "APs": summarize(True, area="small"),
            "APm": summarize(True, area="medium"),
            "APl": summarize(True, area="large"),
            **{f"AR{md}": summarize(False, max_dets=md) for md in self.max_dets},
            "ARs": summarize(False, area="small"),
            "ARm": summarize(False, area="medium"),
            "ARl": summarize(False, area="large"),
        }

    def _compute_iou(self, dets: List[dict], gts: List[dict], img_id) -> np.ndarray:
        iscrowd = np.asarray([g.get("iscrowd", 0) for g in gts], dtype=bool)
        if self.iou_type == "bbox":
            d = np.asarray([det["bbox"] for det in dets], dtype=np.float64).reshape(-1, 4)
            g = np.asarray([gt["bbox"] for gt in gts], dtype=np.float64).reshape(-1, 4)
            return box_iou_xywh(d, g, iscrowd)
        if self.iou_type == "keypoints":
            return oks_iou([det["keypoints"] for det in dets], gts, self.oks_sigmas)
        img = self.imgs[img_id]
        return mask_iou([d["segmentation"] for d in dets], [g["segmentation"] for g in gts], iscrowd,
                        img["height"], img["width"])

    def _gt_area(self, gt: dict) -> float:
        if "area" in gt:
            return float(gt["area"])
        if self.iou_type == "segm" and isinstance(gt.get("segmentation"), dict):
            return float(rle_area(gt["segmentation"]))
        bb = gt["bbox"]
        return float(bb[2] * bb[3])

    def _det_area(self, det: dict) -> float:
        if self.iou_type == "segm":
            return float(rle_area(det["segmentation"]))
        bb = det["bbox"]
        return float(bb[2] * bb[3])

    def _match(self, dets: List[dict], gts: List[dict], ious: np.ndarray, det_areas: np.ndarray, area_rng):
        """Greedy matching of one (image, category) over every IoU
        threshold: detections in score order take the best free ground
        truth, real ones before ignored ones."""
        d, g = len(dets), len(gts)
        gt_ignore = np.asarray(
            [bool(gt.get("ignore", False)) or bool(gt.get("iscrowd", 0))
             or not (area_rng[0] <= self._gt_area(gt) < area_rng[1]) for gt in gts],
            dtype=bool,
        )
        g_order = np.argsort(gt_ignore, kind="mergesort")  # real ground truth first
        ious_sorted = ious[:, g_order] if g else ious
        gt_ignore_sorted = gt_ignore[g_order] if g else gt_ignore
        iscrowd_sorted = np.asarray([gts[i].get("iscrowd", 0) for i in g_order], dtype=bool) if g else gt_ignore

        det_matched = np.zeros((len(IOU_THRS), d), dtype=bool)
        det_ignore = np.zeros((len(IOU_THRS), d), dtype=bool)
        for ti, thr in enumerate(IOU_THRS):
            gt_used = np.zeros(g, dtype=bool)
            for di in range(d):
                best_iou = min(thr, 1 - 1e-10)
                best_g = -1
                for gi in range(g):
                    if gt_used[gi] and not iscrowd_sorted[gi]:
                        continue
                    # stop at ignored ground truth once a real match is found
                    if best_g > -1 and not gt_ignore_sorted[best_g] and gt_ignore_sorted[gi]:
                        break
                    if ious_sorted[di, gi] < best_iou:
                        continue
                    best_iou = ious_sorted[di, gi]
                    best_g = gi
                if best_g == -1:
                    continue
                gt_used[best_g] = True
                det_matched[ti, di] = True
                det_ignore[ti, di] = gt_ignore_sorted[best_g]
        # unmatched detections outside the area range are ignored
        out_of_rng = (det_areas < area_rng[0]) | (det_areas >= area_rng[1]) if d else np.zeros(0, bool)
        det_ignore = det_ignore | (~det_matched & out_of_rng[None, :])
        return {
            "scores": np.asarray([det["score"] for det in dets]),
            "det_matched": det_matched,
            "det_ignore": det_ignore,
            "num_gt": int((~gt_ignore).sum()),
        }
