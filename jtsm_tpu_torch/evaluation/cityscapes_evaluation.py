"""Cityscapes evaluation (reference:
detectron2/evaluation/cityscapes_evaluation.py, which defers to
cityscapesscripts; JAX package ``evaluation/cityscapes_evaluation.py:42,131``,
whose protocols the port copies).

* ``CityscapesInstanceEvaluator``: mask AP and AP50 over the 8 thing
  classes. The ground truth polygons are rasterised and run-length encoded,
  and the predictions' masks are matched against them by the port's COCO
  segm protocol (``cocoeval.COCOEval``), not by cityscapesscripts' own
  matching (its ignore regions and minimum region size; ROADMAP §3). The
  JAX package rasterises with Pillow's ``ImageDraw``; the port with its own
  fill (``structures.masks.polygons_to_bitmask``), which differs from
  Pillow's at a few corner joins of self-crossing polygons (ROADMAP §3) and
  nowhere on rectangles or convex polygons.
* ``CityscapesSemSegEvaluator``: the pixel protocol of
  cityscapesscripts' ``evalPixelLevelSemanticLabeling``: trainId
  predictions and label-id ground truth mapped through the label table onto
  the 19 evaluated classes; IoU of each class and of the 7 categories, and
  the instance-weighted iIoU from ``*_gtFine_instanceIds.png`` where that
  file is present. The ground truth is a record's ``sem_seg`` label-id
  array (and ``instance_ids``; sets made in memory, which need no Pillow)
  or its ``sem_seg_file_name`` PNG (and the instanceIds PNG beside it).

The port runs in one process: nothing is gathered.
"""

from __future__ import annotations

import logging
import os
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from ..data.catalog import DatasetCatalog, MetadataCatalog
from ..data.datasets.cityscapes_labels import id2label, labels
from ..data.detection_utils import read_sem_seg
from ..data.rle import rle_area, rle_string_encode
from ..structures import BoxMode
from ..structures.masks import polygons_to_bitmask
from .coco_evaluation import batched_outputs_to_coco_json
from .cocoeval import COCOEval
from .evaluator import DatasetEvaluator

logger = logging.getLogger(__name__)


def cityscapes_instance_gt(dataset_name: str, thing_classes: List[str]) -> Dict:
    """The COCO dict of an instance split: image ids are the records'
    indices, each polygon annotation rasterised and encoded (its area the
    pixels it fills), an RLE kept, a box without a mask filled as its box."""
    images, annotations = [], []
    for img_id, d in enumerate(DatasetCatalog.get(dataset_name)):
        h, w = d["height"], d["width"]
        images.append({"id": img_id, "height": h, "width": w})
        for ann in d.get("annotations", []):
            bbox = BoxMode.convert(ann["bbox"], ann["bbox_mode"], BoxMode.XYWH_ABS)
            segm = ann.get("segmentation")
            if isinstance(segm, list):
                mask = polygons_to_bitmask([np.asarray(p, dtype=np.float64) for p in segm], h, w)
                rle, area = rle_string_encode(mask), float(mask.sum())
            elif isinstance(segm, dict):
                rle, area = segm, float(rle_area(segm))
            else:
                mask = np.zeros((h, w), dtype=bool)
                x0, y0 = int(bbox[0]), int(bbox[1])
                x1, y1 = min(int(np.ceil(bbox[0] + bbox[2])), w), min(int(np.ceil(bbox[1] + bbox[3])), h)
                mask[max(y0, 0): y1, max(x0, 0): x1] = True
                rle, area = rle_string_encode(mask), float(mask.sum())
            annotations.append({
                "id": len(annotations) + 1,
                "image_id": img_id,
                "category_id": ann["category_id"] + 1,
                "bbox": list(bbox),
                "segmentation": rle,
                "area": area,
                "iscrowd": ann.get("iscrowd", 0),
            })
    cats = [{"id": c + 1, "name": n} for c, n in enumerate(thing_classes)]
    return {"images": images, "annotations": annotations, "categories": cats}


class CityscapesInstanceEvaluator(DatasetEvaluator):
    """segm AP and AP50 of the model's masks on a Cityscapes instance split
    (see the module's docstring)."""

    def __init__(self, dataset_name: str):
        self._metadata = MetadataCatalog.get(dataset_name)
        self._gt = cityscapes_instance_gt(dataset_name, self._metadata.thing_classes)
        self._str_ids = {d["image_id"]: i for i, d in enumerate(DatasetCatalog.get(dataset_name))}
        self._predictions: List[dict] = []

    def reset(self):
        self._predictions = []

    def process(self, inputs, outputs):
        preds = batched_outputs_to_coco_json(outputs, inputs["image_ids"], inputs["orig_sizes"], None, True,
                                             image_sizes=inputs.get("image_sizes"))
        for p in preds:
            p["category_id"] += 1
            p["image_id"] = self._str_ids.get(p["image_id"], p["image_id"])  # the record's index
        self._predictions.extend(preds)

    @property
    def predictions(self) -> List[dict]:
        return self._predictions

    def evaluate(self):
        if not self._predictions:
            return {}
        stats = COCOEval(self._gt, "segm").evaluate(self._predictions)
        ret = OrderedDict({"segm": {"AP": 100 * stats["AP"], "AP50": 100 * stats["AP50"]}})
        logger.info(ret)
        return ret


class CityscapesSemSegEvaluator(DatasetEvaluator):
    """IoU, iIoU, IoU_sup (the categories' IoU), iIoU_sup and each class's
    IoU of trainId predictions on a Cityscapes semantic split (see the
    module's docstring). ``distributed`` and ``output_dir`` are accepted as
    the JAX package's are and change nothing."""

    # the 19 evaluated classes in trainId order
    _EVAL = [lab for lab in labels if not lab.ignoreInEval and lab.trainId != 255]

    def __init__(self, dataset_name: str, distributed: bool = True, output_dir: Optional[str] = None):
        self._gt_by_id = {}
        for d in DatasetCatalog.get(dataset_name):
            gt = d.get("sem_seg", d.get("sem_seg_file_name"))
            if gt is not None:
                self._gt_by_id[d.get("image_id", d["file_name"])] = (gt, d.get("instance_ids"))
        self._n = len(self._EVAL)
        # label id, and trainId, -> index of the evaluated class (n: not evaluated)
        self._id_to_idx = np.full(256, self._n, dtype=np.int64)
        self._train_to_idx = np.full(256, self._n, dtype=np.int64)
        for idx, lab in enumerate(self._EVAL):
            self._id_to_idx[lab.id] = idx
            self._train_to_idx[lab.trainId] = idx
        self.reset()

    def reset(self):
        self._conf = np.zeros((self._n + 1, self._n + 1), dtype=np.int64)
        self._inst_records: List[tuple] = []  # (class index, instance pixels, true-positive pixels)

    @staticmethod
    def _gt_arrays(gt, inst):
        """The label ids, and the instance ids where there are any: in-memory
        arrays, or the labelIds PNG and the instanceIds PNG beside it."""
        if not isinstance(gt, str):
            return np.asarray(gt, dtype=np.int64), None if inst is None else np.asarray(inst, dtype=np.int64)
        inst_file = gt.replace("_labelIds.png", "_instanceIds.png")
        inst = read_sem_seg(inst_file, np.int64) if inst_file != gt and os.path.exists(inst_file) else None
        return read_sem_seg(gt, np.int64), inst

    def process(self, inputs, outputs):
        preds = outputs["sem_seg"]
        for i in range(len(preds)):
            img_id = inputs["image_ids"][i] if "image_ids" in inputs else None
            if hasattr(img_id, "item"):
                img_id = img_id.item()
            entry = self._gt_by_id.get(img_id)
            if entry is None:
                continue
            pred = preds[i]
            pred = pred.detach().cpu().numpy() if hasattr(pred, "detach") else np.asarray(pred)
            if pred.ndim == 3:  # (H, W, C) logits
                pred = pred.argmax(-1)
            gt_ids, inst_ids = self._gt_arrays(*entry)
            pred = pred[: gt_ids.shape[0], : gt_ids.shape[1]]
            pred_idx = self._train_to_idx[np.clip(pred, 0, 255)]
            gt_idx = self._id_to_idx[np.clip(gt_ids, 0, 255)]
            self._conf += np.bincount(gt_idx.reshape(-1) * (self._n + 1) + pred_idx.reshape(-1),
                                      minlength=(self._n + 1) ** 2).reshape(self._n + 1, self._n + 1)
            if inst_ids is not None:
                # an instance is label id * 1000 + k; ids below 1000 are regions without instances
                for iid in np.unique(inst_ids[inst_ids >= 1000]):
                    lab = id2label.get(int(iid) // 1000)
                    if lab is None or lab.ignoreInEval or lab.trainId == 255 or not lab.hasInstances:
                        continue
                    idx = int(self._id_to_idx[lab.id])
                    m = inst_ids == iid
                    self._inst_records.append((idx, int(m.sum()), int((pred_idx[m] == idx).sum())))

    def evaluate(self):
        conf, n = self._conf, self._n
        # evalPixelLevelSemanticLabeling: a false negative is any mispredicted
        # pixel of the class; a false positive only lies on evaluated pixels
        tp = np.diag(conf)[:n].astype(np.float64)
        fp = conf[:n, :n].sum(0) - tp
        fn = conf[:n, :n].sum(1) + conf[:n, n] - tp
        denom = tp + fp + fn
        iou = np.where(denom > 0, tp / np.maximum(denom, 1), np.nan)
        cat_iou = {}
        for c in sorted({lab.category for lab in self._EVAL}):
            sel = np.asarray([lab.category == c for lab in self._EVAL])
            m = conf[:n, :n]
            ctp = float(m[np.ix_(sel, sel)].sum())
            cfp = float(m[np.ix_(~sel, sel)].sum())
            cfn = float(m[np.ix_(sel, ~sel)].sum() + conf[:n, n][sel].sum())
            d = ctp + cfp + cfn
            cat_iou[c] = ctp / d if d > 0 else np.nan
        # iIoU: true positives and false negatives weighted by the class's
        # mean instance size over the instance's; false positives unweighted
        i_iou, i_parts = {}, {}
        if self._inst_records:
            sizes = {}
            for idx, size, _ in self._inst_records:
                sizes.setdefault(idx, []).append(size)
            avg = {idx: float(np.mean(v)) for idx, v in sizes.items()}
            for idx in [i for i, lab in enumerate(self._EVAL) if lab.hasInstances]:
                recs = [r for r in self._inst_records if r[0] == idx]
                if not recs:
                    continue
                w = [avg[idx] / max(size, 1) for _, size, _ in recs]
                itp = sum(wi * tp_i for wi, (_, _, tp_i) in zip(w, recs))
                ifn = sum(wi * (size - tp_i) for wi, (_, size, tp_i) in zip(w, recs))
                fpc = float(fp[idx])
                i_parts[idx] = (itp, ifn, fpc)
                d = itp + fpc + ifn
                i_iou[idx] = itp / d if d > 0 else np.nan
        res = {
            "IoU": 100.0 * float(np.nanmean(iou)) if (~np.isnan(iou)).any() else float("nan"),
            "iIoU": 100.0 * float(np.mean(list(i_iou.values()))) if i_iou else float("nan"),
            "IoU_sup": 100.0 * float(np.nanmean(list(cat_iou.values()))),
            "iIoU_sup": float("nan"),
        }
        for idx, lab in enumerate(self._EVAL):
            res[f"IoU-{lab.name}"] = 100.0 * float(iou[idx])
        if i_parts:
            cat_parts = {}
            for idx, (itp, ifn, fpc) in i_parts.items():
                a = cat_parts.setdefault(self._EVAL[idx].category, [0.0, 0.0, 0.0])
                a[0] += itp
                a[1] += ifn
                a[2] += fpc
            vals = [itp / (itp + ifn + fpc) for itp, ifn, fpc in cat_parts.values() if itp + ifn + fpc > 0]
            if vals:
                res["iIoU_sup"] = 100.0 * float(np.mean(vals))
        ret = OrderedDict({"sem_seg": res})
        logger.info(ret)
        return ret
