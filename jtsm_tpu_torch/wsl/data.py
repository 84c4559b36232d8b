"""WSL data plumbing in numpy (reference:
projects/WSL/wsl/data/detection_utils.py:266, wsl/data/build.py; JAX package
``wsl/data.py`` :29 ``load_mcg_proposals``, :109 ``transform_proposals_seg``,
:163 ``compute_superpixels_grid``, :172 ``oh_labels_from_boxes``, :196
``add_wsl_batch_fields``, :235 ``load_mcg_proposals_into_dataset``, :268
``WSLDatasetMapper``, :298 ``WSLStaticBatchLoader``, :342
``build_wsl_test_loader``, and the training fields of
``data/detection_utils.py:418,476`` ``instances_to_static_targets`` and
``build_static_batch``), copied so that the port serves, trains and scores
JTSM without the JAX package. The MCG ``.mat`` converters and the train
loader are not ported yet (ROADMAP).

An MCG-style proposal pickle is {ids, boxes, objectness_logits, bbox_mode,
and optionally superpixels (H, W) ids and oh_labels (R, S) bool
membership}, one entry of each per image.

Static shapes: ``superpixels`` (B, H, W) int32 ids clipped to
``[0, max_superpixels)``, ``oh_labels`` (B, R, max_superpixels) bool;
for training ``gt_classes`` (B, G) int32, ``gt_valid`` (B, G) bool,
``gt_boxes`` (B, G, 4) float32 and ``gt_sem_seg`` (B, H, W) int32 with 255
outside each image.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Union

import numpy as np

from ..data.build import StaticBatchLoader, attach_proposals, build_detection_test_loader, load_proposal_file
from ..data.dataset_mapper import DatasetMapper
from ..data.detection_utils import transformed_proposals


load_mcg_proposals = load_proposal_file  # a converted MCG pickle: a path, or the dict already loaded


def load_mcg_proposals_into_dataset(dataset_dicts: List[dict], proposal_file: Union[str, Dict]) -> List[dict]:
    """``data.build.load_proposals_into_dataset``, and the superpixel map
    (``proposal_superpixels``) and the membership (``proposal_oh_labels``)
    of each image where the pickle carries them."""
    return attach_proposals(dataset_dicts, load_mcg_proposals(proposal_file), {
        "proposal_boxes": "boxes", "proposal_objectness_logits": "objectness_logits",
        "proposal_superpixels": "superpixels", "proposal_oh_labels": "oh_labels"})


def transform_proposals_seg(dataset_dict: dict, image_shape, transforms, *, proposal_topk: int,
                            max_superpixels: int = 1024, min_box_size: float = 0.0) -> None:
    """``data.detection_utils.transform_proposals`` for MCG proposals: the
    superpixel map goes through the transforms as a segmentation (Pillow's
    nearest filter, float32 for int ids) and is clipped to ``[0,
    max_superpixels)``; the kept proposals' membership rows follow their
    boxes, padded or cut to ``max_superpixels`` columns."""
    if "proposal_boxes" not in dataset_dict:
        return
    superpixels = dataset_dict.pop("proposal_superpixels", None)
    oh_labels = dataset_dict.pop("proposal_oh_labels", None)
    boxes, logits, keep = transformed_proposals(dataset_dict, image_shape, transforms, min_box_size)
    order = np.argsort(-logits)[:proposal_topk]
    out = {"boxes": boxes[order].astype(np.float32), "objectness_logits": logits[order].astype(np.float32)}
    if superpixels is not None:
        sp = transforms.apply_segmentation(np.asarray(superpixels).astype(np.int32))
        out["superpixels"] = np.clip(sp, 0, max_superpixels - 1)
    if oh_labels is not None:
        oh = np.asarray(oh_labels)[keep][order]
        s = oh.shape[1]
        oh = np.pad(oh, ((0, 0), (0, max_superpixels - s))) if s < max_superpixels else oh[:, :max_superpixels]
        out["oh_labels"] = oh.astype(bool)
    dataset_dict["proposals"] = out


def compute_superpixels_grid(h: int, w: int, cell: int = 16) -> np.ndarray:
    """Fallback superpixel map: a regular grid (used when MCG superpixels are
    unavailable; also handy for tests)."""
    yy = np.arange(h)[:, None] // cell
    xx = np.arange(w)[None, :] // cell
    ncols = (w + cell - 1) // cell
    return (yy * ncols + xx).astype(np.int32)


def oh_labels_from_boxes(
    boxes: np.ndarray, superpixels: np.ndarray, max_superpixels: int
) -> np.ndarray:
    """Membership of each superpixel in each box (by the superpixel's
    centroid): fallback when MCG per-proposal segment membership is absent."""
    s = int(superpixels.max()) + 1
    s = min(s, max_superpixels)
    ys, xs = np.mgrid[0 : superpixels.shape[0], 0 : superpixels.shape[1]]
    flat = superpixels.reshape(-1)
    cnt = np.bincount(flat, minlength=s)[:s].astype(np.float64)
    cy = np.bincount(flat, weights=ys.reshape(-1), minlength=s)[:s] / np.maximum(cnt, 1)
    cx = np.bincount(flat, weights=xs.reshape(-1), minlength=s)[:s] / np.maximum(cnt, 1)
    r = boxes.shape[0]
    oh = np.zeros((r, max_superpixels), dtype=bool)
    inside = (
        (cx[None, :] >= boxes[:, 0:1])
        & (cy[None, :] >= boxes[:, 1:2])
        & (cx[None, :] <= boxes[:, 2:3])
        & (cy[None, :] <= boxes[:, 3:4])
    )
    oh[:, :s] = inside
    return oh


def add_wsl_batch_fields(
    batch: Dict[str, np.ndarray], per_image: List[dict], max_superpixels: int
) -> None:
    """Collate superpixels/oh_labels into the static batch (companion to
    data.detection_utils.build_static_batch)."""
    b = batch["image"].shape[0]
    bh, bw = batch["image"].shape[1:3]
    r = batch["proposals"].shape[1]
    batch["superpixels"] = np.zeros((b, bh, bw), np.int32)
    batch["oh_labels"] = np.zeros((b, r, max_superpixels), bool)
    for i, d in enumerate(per_image):
        p = d.get("proposals", {})
        sp = p.get("superpixels")
        if sp is None:
            h, w = d["image"].shape[:2]
            sp = compute_superpixels_grid(h, w)
        hh, ww = sp.shape
        batch["superpixels"][i, :hh, :ww] = np.clip(sp, 0, max_superpixels - 1)
        oh = p.get("oh_labels")
        if oh is None and "boxes" in p:
            oh = oh_labels_from_boxes(p["boxes"], sp, max_superpixels)
        if oh is not None:
            n = min(len(oh), r)
            batch["oh_labels"][i, :n] = oh[:n, :max_superpixels]


def add_wsl_train_fields(batch: Dict[str, np.ndarray], per_image: List[dict], max_instances: int) -> None:
    """Collate the image-level targets of a JTSM train step into the static
    batch, as the JAX package's ``build_static_batch`` does: each
    per-image dict's ``gt_classes`` (and ``gt_boxes`` when present) fill the
    first rows of a ``max_instances`` capacity, marked in ``gt_valid``; its
    ``sem_seg`` (h, w), where any dict has one, fills ``gt_sem_seg``."""
    b = batch["image"].shape[0]
    bh, bw = batch["image"].shape[1:3]
    g = max_instances
    batch["gt_boxes"] = np.zeros((b, g, 4), np.float32)
    batch["gt_classes"] = np.zeros((b, g), np.int32)
    batch["gt_valid"] = np.zeros((b, g), bool)
    if any("sem_seg" in d for d in per_image):
        batch["gt_sem_seg"] = np.full((b, bh, bw), 255, np.int32)
    for i, d in enumerate(per_image):
        classes = np.asarray(d.get("gt_classes", ()), np.int32)[:g]
        n = len(classes)
        batch["gt_classes"][i, :n] = classes
        batch["gt_valid"][i, :n] = True
        if "gt_boxes" in d:
            batch["gt_boxes"][i, :n] = np.asarray(d["gt_boxes"], np.float32)[:n]
        if "sem_seg" in d:
            h, w = d["sem_seg"].shape
            batch["gt_sem_seg"][i, :h, :w] = d["sem_seg"]


class WSLDatasetMapper(DatasetMapper):
    """The test ``DatasetMapper`` whose proposal step also transforms the
    MCG superpixel map and membership (``transform_proposals_seg``)."""

    def __init__(self, cfg, is_train: bool = False):
        super().__init__(cfg, is_train)
        self.max_superpixels = cfg.WSL.MAX_SUPERPIXELS

    def _transform_proposals(self, dataset_dict: dict, image_shape, transforms) -> None:
        transform_proposals_seg(dataset_dict, image_shape, transforms, proposal_topk=self.proposal_topk,
                                max_superpixels=self.max_superpixels)


class WSLStaticBatchLoader(StaticBatchLoader):
    """The static-batch loader whose batches also carry ``superpixels``
    and ``oh_labels`` (``add_wsl_batch_fields``) at ``max_superpixels``."""

    def __init__(self, *args, max_superpixels: int, **kwargs):
        super().__init__(*args, **kwargs)
        self.max_superpixels = max_superpixels

    def collate(self, group: List[dict]) -> Dict[str, np.ndarray]:
        batch = super().collate(group)
        add_wsl_batch_fields(batch, group, self.max_superpixels)
        return batch


def build_wsl_test_loader(cfg, dataset_name: str, batch_size: int = 1):
    """The test loader of a WSL model: under WSL.SP_ON the MCG proposal
    loader, ``WSLDatasetMapper`` and the superpixel batch fields, else the
    plain test loader."""
    if not cfg.WSL.SP_ON:
        return build_detection_test_loader(cfg, dataset_name, batch_size=batch_size)
    return build_detection_test_loader(
        cfg, dataset_name, WSLDatasetMapper(cfg, False), batch_size, load_mcg_proposals_into_dataset,
        loader_class=functools.partial(WSLStaticBatchLoader, max_superpixels=cfg.WSL.MAX_SUPERPIXELS),
    )
