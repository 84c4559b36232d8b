"""COCO evaluation of the model's batched outputs (reference:
detectron2/evaluation/coco_evaluation.py:30 ``COCOEvaluator``, :357
``instances_to_coco_json``, :421 the proposals' AR; JAX package
``evaluation/coco_evaluation.py:64,135,168,231``).

Masks are pasted at each image's original size on the outputs' device
(``ops.paste_masks``), then run-length encoded on the host in numpy. A WSL
model's ``no_paste`` detections carry image-size masks (``masks_full``) at
the network's input size instead: each is cropped to the image and sampled
at the original size (JAX package ``coco_evaluation.py:95-110``). A
keypoint model's detections carry their keypoints as COCO's flat (x, y, 2)
triples (``:125-130``), and the tasks follow what the model emits: bbox,
segm with masks, keypoints with keypoints.
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
from ..data.datasets.coco import convert_to_coco_dict, load_json
from ..data.rle import rle_string_encode
from ..ops.paste_masks import paste_masks
from .cocoeval import COCOEval
from .evaluator import DatasetEvaluator, add_time

logger = logging.getLogger(__name__)


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _tensor(x) -> Optional[torch.Tensor]:
    return x if x is None or torch.is_tensor(x) else torch.as_tensor(np.asarray(x))


def _sample_full_masks(masks_full: torch.Tensor, ih: int, iw: int, h: int, w: int) -> np.ndarray:
    """(N, H, W) image-size masks at the network's input size, cropped to
    (ih, iw) and sampled at (h, w) by the nearest half-pixel centre (numpy's
    ``round``, halves to even), at 0.5."""
    def index(n, size):
        return torch.as_tensor(np.clip((np.arange(size) + 0.5) * n / size - 0.5, 0, n - 1).round().astype(int),
                               device=masks_full.device)

    m = masks_full[:, :ih, :iw]
    ys, xs = index(m.shape[1], h), index(m.shape[2], w)
    return (m[:, ys[:, None], xs[None, :]].to(torch.float32) >= 0.5).cpu().numpy()


def batched_outputs_to_coco_json(
    outputs: Dict,
    image_ids: np.ndarray,
    orig_sizes: np.ndarray,
    reverse_id_mapping: Optional[Dict[int, int]] = None,
    with_masks: bool = False,
    timings: Optional[Dict[str, float]] = None,
    image_sizes: Optional[np.ndarray] = None,
) -> List[dict]:
    """Fixed-capacity (B, D, ...) detections (tensors or arrays) -> COCO
    result dicts, image by image in slot order, valid slots only. With
    ``with_masks``, each image's valid masks are pasted at its original
    size in one batched call and encoded as compressed RLE; a detection
    flagged ``no_paste`` takes its ``masks_full`` mask cropped to its
    ``image_sizes`` entry instead. ``keypoints`` (B, D, K, 4) become flat
    (x, y, 2) triples. ``timings`` (optional) gathers the seconds of the
    ``paste`` and the ``encode``."""
    boxes, scores = _numpy(outputs["boxes"]), _numpy(outputs["scores"])
    if boxes.shape[-1] != 4:
        raise ValueError(f"COCO results take 4-dim boxes, not {boxes.shape[-1]}: score a rotated model with "
                         "evaluation.RotatedCOCOEvaluator (the JAX package's build_evaluator picks none either)")
    classes, valid = _numpy(outputs["classes"]), _numpy(outputs["valid"]).astype(bool)
    masks = _tensor(outputs.get("masks")) if with_masks else None
    masks_full = _tensor(outputs.get("masks_full")) if with_masks else None
    keypoints = _numpy(outputs["keypoints"]) if "keypoints" in outputs else None
    no_paste = np.zeros(valid.shape, bool)
    if masks_full is not None and outputs.get("no_paste") is not None:
        no_paste = _numpy(outputs["no_paste"]).astype(bool)
    results = []
    for i in range(scores.shape[0]):
        img_id = image_ids[i]
        img_id = str(img_id) if isinstance(img_id, str) else int(img_id)  # Cityscapes' ids are strings
        h, w = int(orig_sizes[i][0]), int(orig_sizes[i][1])
        slots = np.nonzero(valid[i])[0]
        rles = None
        if (masks is not None or masks_full is not None) and len(slots):
            t0 = time.perf_counter()
            full = np.zeros((len(slots), h, w), bool)
            flat = no_paste[i][slots]
            if flat.any():
                ih, iw = (int(v) for v in image_sizes[i]) if image_sizes is not None else masks_full.shape[2:4]
                sel = torch.as_tensor(slots[flat], device=masks_full.device)
                full[flat] = _sample_full_masks(masks_full[i][sel], ih, iw, h, w)
            if masks is not None and not flat.all():
                sel = torch.as_tensor(slots[~flat], device=masks.device)
                pasted = paste_masks(masks[i][sel], torch.as_tensor(boxes[i][slots[~flat]], device=masks.device), h, w)
                full[~flat] = pasted.cpu().numpy()
            t1 = time.perf_counter()
            # a detection with neither kind of mask has no segmentation
            rles = [rle_string_encode(m) if f or masks is not None else None for m, f in zip(full, flat)]
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
            if rles is not None and rles[n] is not None:
                res["segmentation"] = rles[n]
            if keypoints is not None:
                res["keypoints"] = [v for x, y, _, _ in keypoints[i, j].tolist() for v in (float(x), float(y), 2.0)]
            results.append(res)
    return results


class COCOEvaluator(DatasetEvaluator):
    """bbox AP, segm AP when the model emits masks and keypoints AP (OKS
    with ``kpt_oks_sigmas``, COCO's when empty) when it emits keypoints,
    against the dataset's COCO json, or, for a dataset registered without
    one, its records converted (``convert_to_coco_dict``, JAX package
    ``coco_evaluation.py:151-156``). ``timings`` (optional) gathers the
    seconds of ``paste``, ``encode`` and ``eval``."""

    def __init__(self, dataset_name: str, output_dir: Optional[str] = None,
                 timings: Optional[Dict[str, float]] = None, kpt_oks_sigmas=()):
        self._output_dir = output_dir
        self._kpt_oks_sigmas = kpt_oks_sigmas
        self._metadata = MetadataCatalog.get(dataset_name)
        self._timings = timings
        if not hasattr(self._metadata, "json_file"):
            logger.info(f"'{dataset_name}' is not registered by `register_coco_instances`. "
                        "Converting it to COCO format ...")
            self._coco_gt = convert_to_coco_dict(dataset_name)
        else:
            self._coco_gt = load_json(self._metadata.json_file)
        self._do_masks = False
        self._do_keypoints = False
        self._predictions: List[dict] = []

    def reset(self):
        self._predictions = []

    def process(self, inputs, outputs):
        reverse_id_mapping = None
        if hasattr(self._metadata, "thing_dataset_id_to_contiguous_id"):
            reverse_id_mapping = {v: k for k, v in self._metadata.thing_dataset_id_to_contiguous_id.items()}
        with_masks = "masks" in outputs or "masks_full" in outputs
        self._do_masks = self._do_masks or with_masks
        self._do_keypoints = self._do_keypoints or "keypoints" in outputs
        self._predictions.extend(batched_outputs_to_coco_json(
            outputs, inputs["image_ids"], inputs["orig_sizes"], reverse_id_mapping, with_masks, self._timings,
            inputs.get("image_sizes"),
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
        tasks = ("bbox",) + ("segm",) * self._do_masks + ("keypoints",) * self._do_keypoints
        t0 = time.perf_counter()
        results = OrderedDict()
        for task in tasks:
            stats = COCOEval(self._coco_gt, iou_type=task, kpt_oks_sigmas=self._kpt_oks_sigmas).evaluate(predictions)
            results[task] = {k: 100 * v for k, v in stats.items()}
            logger.info(f"Evaluation results for {task}: {results[task]}")
        add_time(self._timings, "eval", time.perf_counter() - t0)
        return results


class COCOProposalEvaluator(DatasetEvaluator):
    """The proposals' average recall at 100 and 1000 (JAX package
    ``coco_evaluation.py:231-312``; reference ``_evaluate_box_proposals``):
    per image the ``limit`` best finite-scored proposals matched greedily
    one to one to the ground truth that is not a crowd (the largest IoU
    first, each proposal and each ground truth used once), and the recall
    of all ground truths pooled over the images, averaged over IoU
    thresholds 0.5:0.05:0.95."""

    def __init__(self, dataset_name: str, limits=(100, 1000)):
        self._coco_gt = load_json(MetadataCatalog.get(dataset_name).json_file)
        self._gt_by_img: Dict = {}
        for ann in self._coco_gt["annotations"]:
            if not ann.get("iscrowd", 0):
                self._gt_by_img.setdefault(ann["image_id"], []).append(ann["bbox"])
        self._limits = limits
        self._proposals: List[dict] = []

    def reset(self):
        self._proposals = []

    def process(self, inputs, outputs):
        boxes, scores = _numpy(outputs["proposals"]), _numpy(outputs["scores"])
        for i in range(len(inputs["image_ids"])):
            live = np.isfinite(scores[i])
            self._proposals.append({"image_id": int(inputs["image_ids"][i]), "boxes": boxes[i][live],
                                    "scores": scores[i][live]})

    def evaluate(self):
        thresholds = np.arange(0.5, 0.95 + 1e-5, 0.05)
        results = {}
        for limit in self._limits:
            best_ious = []
            for p in self._proposals:
                gts = np.asarray(self._gt_by_img.get(p["image_id"], []), dtype=np.float64)
                if len(gts) == 0:
                    continue
                gts[:, 2:] += gts[:, :2]
                boxes = p["boxes"][np.argsort(-p["scores"])[:limit]]  # numpy's sort, as the JAX package's
                if len(boxes) == 0:
                    best_ious.append(np.zeros(len(gts)))
                    continue
                iou = _iou_np(gts, boxes)  # (G, D)
                gt_ovr = np.zeros(len(gts))
                for j in range(min(len(gts), len(boxes))):
                    gt_ind, box_ind = np.unravel_index(np.argmax(iou), iou.shape)
                    if iou[gt_ind, box_ind] < 0:
                        break
                    gt_ovr[j] = iou[gt_ind, box_ind]
                    iou[gt_ind, :] = -1
                    iou[:, box_ind] = -1
                best_ious.append(gt_ovr)
            if best_ious:
                best = np.concatenate(best_ious)
                results[f"AR@{limit}"] = 100.0 * float(np.mean([np.mean(best >= t) for t in thresholds]))
        return {"box_proposals": results}


def _iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(G, 4) x (D, 4) XYXY -> (G, D) IoU, 0 where the union is empty."""
    iw = np.clip(np.minimum(a[:, None, 2], b[None, :, 2]) - np.maximum(a[:, None, 0], b[None, :, 0]), 0, None)
    ih = np.clip(np.minimum(a[:, None, 3], b[None, :, 3]) - np.maximum(a[:, None, 1], b[None, :, 1]), 0, None)
    inter = iw * ih
    union = ((a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1]))[:, None] + ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]))[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0)
