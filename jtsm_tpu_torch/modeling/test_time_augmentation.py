"""Test-time augmentation (reference:
detectron2/modeling/test_time_augmentation.py:27 ``DatasetMapperTTA``, :85
``GeneralizedRCNNWithTTA``, and the WSL variants
projects/WSL/wsl/modeling/test_time_augmentation_avg.py and _union.py; JAX
package ``modeling/test_time_augmentation.py``).

Host-orchestrated, as in the JAX package. Each view, every size of
TEST.AUG.MIN_SIZES and then its flip, is resized on the host (Pillow's
float ``BILINEAR`` in numpy, ``data.transforms``), padded to the smallest
bucket that holds it and run through the model on its device. The merge
averages or concatenates on the host in numpy float32, in the JAX
package's order of operations; its NMS (``ops.nms.batched_nms``,
``wsl_inference_single``) runs on the model's device. Each image is
resized once: the mask re-run on the merged boxes reads the same views.

A predict function takes the JAX package's batch dict (numpy arrays) and
returns the model's outputs (tensors or arrays): ``model.inference``.
``timings`` (optional) gathers the seconds of ``tta_resize`` (the views'
resize, flip and padding, and the superpixels'), ``tta_views`` (the
views' passes, to their outputs on the host), ``tta_logits`` (the sem-seg
logits to the host and back to the original size), ``tta_merge`` and
``tta_rerun`` (the mask re-run).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.detection_utils import pick_bucket
from ..data.transforms import ResizeShortestEdge, resize_bilinear_float, resize_nearest
from ..evaluation.evaluator import add_time
from ..ops.nms import batched_nms


def _host(x) -> np.ndarray:
    """A tensor or array on the host as numpy (bf16 as float32)."""
    if torch.is_tensor(x):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
    return np.asarray(x)


def _flip_boxes(boxes: np.ndarray, width) -> np.ndarray:
    """(N, 4) XYXY boxes mirrored in an image ``width`` wide."""
    return np.stack([width - boxes[:, 2], boxes[:, 1], width - boxes[:, 0], boxes[:, 3]], axis=1)


def _to_view(boxes: np.ndarray, batch: Dict, flipped: bool, h0: int, w0: int) -> np.ndarray:
    """Original-image boxes in a view's coordinates: scaled in float32,
    then mirrored in the view's width."""
    hh, ww = (int(v) for v in batch["image_sizes"][0])
    sx, sy = ww / w0, hh / h0
    p = boxes * np.asarray([sx, sy, sx, sy], np.float32)
    return _flip_boxes(p, ww) if flipped else p


class TTAWrapperBase:
    def __init__(
        self,
        predict_fn: Callable[[Dict[str, np.ndarray]], Dict],
        min_sizes: Sequence[int] = (400, 500, 600, 700, 800),
        max_size: int = 1333,
        flip: bool = True,
        buckets: Sequence[Tuple[int, int]] = ((800, 1344), (1344, 800), (1024, 1024)),
        device="cuda",
        timings: Optional[Dict[str, float]] = None,
    ):
        self.predict_fn = predict_fn
        self.min_sizes = list(min_sizes)
        self.max_size = max_size
        self.flip = flip
        self.buckets = [tuple(b) for b in buckets]
        self.device = torch.device(device)
        self.timings = timings

    def _augmented_batches(self, image: np.ndarray, orig_size) -> List[Tuple[Dict[str, np.ndarray], bool]]:
        """(batch, flipped) of each view, in the order size, then flip: the
        image resized so its short edge is the size (its long one at most
        ``max_size``) and zero-padded to the bucket ``pick_bucket`` gives.
        A view that fits no bucket raises a ValueError, as the JAX
        package's padding does."""
        t0 = time.perf_counter()
        h0, w0 = image.shape[:2]
        views = []
        for ms in self.min_sizes:
            img = ResizeShortestEdge([ms, ms], self.max_size).get_transform(image).apply_image(image)
            for im, flipped in [(img, False)] + ([(img[:, ::-1], True)] if self.flip else []):
                hh, ww = im.shape[:2]
                bh, bw = pick_bucket(hh, ww, self.buckets)
                if hh > bh or ww > bw:
                    raise ValueError(
                        f"the {ms} view of a {h0}x{w0} image is {hh}x{ww}"
                        f"{' (flipped)' if flipped else ''}, which no bucket of {self.buckets} holds"
                    )
                canvas = np.zeros((1, bh, bw, 3), np.float32)
                canvas[0, :hh, :ww] = im
                views.append(({
                    "image": canvas,
                    "image_sizes": np.asarray([[hh, ww]], np.int32),
                    "orig_sizes": np.asarray([orig_size], np.int32),
                }, flipped))
        add_time(self.timings, "tta_resize", time.perf_counter() - t0)
        return views

    def _predict(self, predict_fn, batch: Dict, keys: Sequence[str]) -> Dict[str, np.ndarray]:
        """The outputs ``keys`` (those present) of one pass, on the host."""
        t0 = time.perf_counter()
        out = predict_fn(batch)
        out = {k: _host(out[k]) for k in keys if k in out}
        add_time(self.timings, "tta_views" if "detected_boxes" not in batch else "tta_rerun",
                 time.perf_counter() - t0)
        return out

    def _rerun_masks(self, predict_fn, views, boxes: np.ndarray, classes: np.ndarray, valid: np.ndarray,
                     h0: int, w0: int) -> Optional[np.ndarray]:
        """Reference ``_rescale_detected_boxes`` + ``_reduce_pred_masks``:
        the (D, 4) original-image boxes projected into every view, the mask
        branch run there on them (the given-boxes inference), each view's
        (D, S, S) probabilities un-flipped, and their mean; None where the
        model returns no masks."""
        acc = None
        for batch, flipped in views:
            out = self._predict(predict_fn, dict(
                batch, detected_boxes=_to_view(boxes, batch, flipped, h0, w0)[None],
                detected_classes=classes[None], detected_valid=valid[None]), ("masks",))
            if "masks" not in out:
                return None
            m = out["masks"][0]
            if flipped:
                m = m[..., ::-1]
            acc = m if acc is None else acc + m
        return acc / len(views)


class GeneralizedRCNNWithTTA(TTAWrapperBase):
    """Union of the views' detections (mapped back to the original image),
    ``batched_nms`` to ``topk``, then the mask branch re-run on the merged
    boxes in every view and the probabilities averaged (reference
    test_time_augmentation.py:85; the WSL UNION variant
    test_time_augmentation_union.py:190-291 is the same flow). The model's
    given-boxes branch does the re-run; an error there propagates."""

    def __call__(self, image: np.ndarray, topk: int = 100, nms_thresh: float = 0.5) -> Dict[str, np.ndarray]:
        """The merged ``boxes`` (N, 4) in original-image coordinates,
        ``scores``, ``classes`` and, for a model with masks, ``masks`` (N,
        S, S) probabilities."""
        h0, w0 = image.shape[:2]
        views = self._augmented_batches(image, (h0, w0))
        parts: Dict[str, list] = {"boxes": [], "scores": [], "classes": []}
        for batch, flipped in views:
            out = self._predict(self.predict_fn, batch, ("boxes", "scores", "classes", "valid", "masks"))
            valid = out["valid"][0]
            boxes = out["boxes"][0][valid]
            parts["boxes"].append(_flip_boxes(boxes, w0) if flipped else boxes)
            for k in ("scores", "classes", "masks"):
                if k in out:
                    parts.setdefault(k, []).append(out[k][0][valid])
        if sum(len(b) for b in parts["boxes"]) == 0:
            return {
                "boxes": np.zeros((0, 4), np.float32),
                "scores": np.zeros((0,), np.float32),
                "classes": np.zeros((0,), np.int64),
            }
        t0 = time.perf_counter()
        merged = {k: np.concatenate(v) for k, v in parts.items()}
        keep = batched_nms(*(torch.as_tensor(merged[k], device=self.device) for k in ("boxes", "scores", "classes")),
                           nms_thresh, max_out=topk)
        keep = _host(keep)
        keep = keep[keep >= 0]
        result = {k: v[keep] for k, v in merged.items()}
        add_time(self.timings, "tta_merge", time.perf_counter() - t0)
        n = len(keep)
        if "masks" in result and n:
            # static capacity: ``topk`` slots, the merged boxes first
            boxes = np.zeros((topk, 4), np.float32)
            boxes[:n] = result["boxes"]
            classes = np.zeros((topk,), np.int32)
            classes[:n] = result["classes"]
            valid = np.arange(topk) < n
            masks = self._rerun_masks(self.predict_fn, views, boxes, classes, valid, h0, w0)
            if masks is not None:
                result["masks"] = masks[:n]
        return result


class GeneralizedRCNNWithTTAAVG(TTAWrapperBase):
    """WSOD TTA (reference test_time_augmentation_avg.py:383-441): the
    proposals are fixed, so each proposal's class scores
    (``proposal_class_scores``) and the sem-seg logits are averaged over
    the views; one ``wsl_inference_single`` on the mean scores over the
    original-image proposals gives the detections, and the mask branch is
    re-run on them in every view."""

    def __call__(
        self,
        image: np.ndarray,
        proposals: np.ndarray,  # (R, 4) in original-image coordinates
        proposal_scores: np.ndarray,  # (R,), -inf marks padding
        predict: Callable,  # the model's per-view predict function
        score_thresh: float = 1e-5,
        nms_thresh: float = 0.3,
        topk: int = 100,
        superpixels: Optional[np.ndarray] = None,  # (H0, W0) int32
        oh_labels: Optional[np.ndarray] = None,  # (R, S) membership, the same in every view
    ) -> Dict:
        """``proposal_class_scores`` (R, C) and ``sem_seg_logits`` (H0, W0,
        K) averaged over the views, and ``detections`` (``boxes``,
        ``scores``, ``classes`` and, where the model has masks, the
        re-run ``masks``) of the valid slots."""
        from ..wsl.modeling.roi_heads_wsl import wsl_inference_single

        h0, w0 = image.shape[:2]
        views = self._augmented_batches(image, (h0, w0))
        acc = sem_acc = None
        saw_masks = False
        for batch, flipped in views:
            hh, ww = (int(v) for v in batch["image_sizes"][0])
            request = dict(batch, proposals=_to_view(proposals, batch, flipped, h0, w0)[None],
                           proposal_scores=proposal_scores[None])
            if superpixels is not None:
                # the superpixel map follows the view: nearest resize, flip, pad
                t0 = time.perf_counter()
                sp = resize_nearest(superpixels.astype(np.int32), hh, ww)
                bh, bw = batch["image"].shape[1:3]
                request["superpixels"] = np.zeros((1, bh, bw), np.int32)
                request["superpixels"][0, :hh, :ww] = sp[:, ::-1] if flipped else sp
                add_time(self.timings, "tta_resize", time.perf_counter() - t0)
            if oh_labels is not None:
                request["oh_labels"] = oh_labels[None]
            t0 = time.perf_counter()
            raw = predict(request)
            if "proposal_class_scores" not in raw:
                # PCL's, ContextLocNet's and CMIL's heads return none, as in
                # the JAX package, whose TTA-AVG fails here with a KeyError
                # (ROADMAP §3)
                heads = getattr(getattr(predict, "__self__", None), "roi_heads", None)
                name = type(heads).__name__ if heads is not None else "the model's heads"
                raise ValueError(f"TTA-AVG averages each proposal's class scores, and the model returns no "
                                 f"proposal_class_scores ({name} returns none): score it with "
                                 "TEST.AUG.ENABLED False")
            out = {"proposal_class_scores": _host(raw["proposal_class_scores"])}
            saw_masks = saw_masks or "masks" in raw or "masks_full" in raw
            add_time(self.timings, "tta_views", time.perf_counter() - t0)
            scores = out["proposal_class_scores"][0]
            acc = scores if acc is None else acc + scores
            if "sem_seg_logits" in raw:
                t0 = time.perf_counter()
                sem = _host(raw["sem_seg_logits"][0, :hh, :ww])
                sem = resize_bilinear_float(sem[:, ::-1] if flipped else sem, h0, w0)
                sem_acc = sem if sem_acc is None else sem_acc + sem
                add_time(self.timings, "tta_logits", time.perf_counter() - t0)
        t0 = time.perf_counter()
        result = {"proposal_class_scores": acc / len(views)}
        if sem_acc is not None:
            result["sem_seg_logits"] = sem_acc / len(views)
        # the final merge (reference test_time_augmentation_avg.py:392-404):
        # one per-class NMS over the mean scores of the fixed proposals
        valid = (proposals[:, 2] - proposals[:, 0] > 0) & (proposals[:, 3] - proposals[:, 1] > 0)
        det = wsl_inference_single(
            torch.as_tensor(proposals, device=self.device),
            torch.as_tensor(result["proposal_class_scores"], device=self.device),
            torch.as_tensor(valid, device=self.device),
            torch.as_tensor([h0, w0], dtype=torch.float32, device=self.device),
            score_thresh, nms_thresh, topk,
        )
        det = {k: _host(v) for k, v in det.items()}
        dv = det["valid"]
        result["detections"] = {k: det[k][dv] for k in ("boxes", "scores", "classes")}
        add_time(self.timings, "tta_merge", time.perf_counter() - t0)
        if saw_masks:
            # reference test_time_augmentation_avg.py:405-428, every slot
            # re-run with its validity
            masks = self._rerun_masks(predict, views, det["boxes"].astype(np.float32), det["classes"], dv, h0, w0)
            if masks is not None:
                result["detections"]["masks"] = masks[dv]
        return result


# the WSL UNION TTA (test_time_augmentation_union.py) is the base flow:
# union, NMS, then the mask re-run on the merged boxes
GeneralizedRCNNWithTTAUNION = GeneralizedRCNNWithTTA


class DatasetMapperTTA:
    """One dataset dict to its views (reference test_time_augmentation.py:27):
    each size of ``min_sizes``, then its flip, as dicts with the view's
    ``image`` and its ``flipped``, ``scale_x`` and ``scale_y``; the wrappers
    above enumerate the same views themselves."""

    def __init__(self, cfg=None, *, min_sizes=None, max_size=None, flip=None):
        if cfg is not None:
            min_sizes = list(cfg.TEST.AUG.MIN_SIZES) if min_sizes is None else min_sizes
            max_size = cfg.TEST.AUG.MAX_SIZE if max_size is None else max_size
            flip = cfg.TEST.AUG.FLIP if flip is None else flip
        self.min_sizes = list(min_sizes if min_sizes is not None else (400, 500, 600, 700, 800))
        self.max_size = max_size if max_size is not None else 1333
        self.flip = True if flip is None else bool(flip)

    def __call__(self, dataset_dict: Dict) -> List[Dict]:
        image = np.asarray(dataset_dict["image"])
        h0, w0 = image.shape[:2]
        out = []
        for ms in self.min_sizes:
            img = ResizeShortestEdge([ms, ms], self.max_size).get_transform(image).apply_image(image)
            for im, flipped in [(img, False)] + ([(img[:, ::-1], True)] if self.flip else []):
                out.append(dict(dataset_dict, image=im, flipped=flipped, scale_x=im.shape[1] / w0,
                                scale_y=im.shape[0] / h0))
        return out


class DatasetMapperTTAAVG(DatasetMapperTTA):
    """The WSOD views (reference wsl/test_time_augmentation_avg.py:126): as
    :class:`DatasetMapperTTA`, with the fixed ``proposals`` (original-image
    coordinates) and the ``superpixels`` map carried into each view's
    geometry, as the wrappers do."""

    def __call__(self, dataset_dict: Dict) -> List[Dict]:
        views = super().__call__(dataset_dict)
        proposals = dataset_dict.get("proposals")
        superpixels = dataset_dict.get("superpixels")
        for d in views:
            hh, ww = d["image"].shape[:2]
            if proposals is not None:
                p = np.asarray(proposals, np.float32) * np.asarray(
                    [d["scale_x"], d["scale_y"], d["scale_x"], d["scale_y"]], np.float32)
                d["proposals"] = _flip_boxes(p, ww) if d["flipped"] else p
            if superpixels is not None:
                sp = resize_nearest(np.asarray(superpixels, np.int32), hh, ww)
                d["superpixels"] = sp[:, ::-1] if d["flipped"] else sp
        return views


# the reference UNION mapper transforms the views as the AVG one does
DatasetMapperTTAUNION = DatasetMapperTTAAVG
