"""DatasetMapper: a dataset dict to the per-image dict the collator takes
(reference: detectron2/data/dataset_mapper.py:20; JAX package
``data/dataset_mapper.py:22,85,92,99-158``): decode, check the size, draw
and apply the augmentations to the image and its sem-seg ground truth,
transform the precomputed proposals, keep the image HWC float32 and, in
training, turn the annotations that are not crowds into ``instances``
(boxes, classes and, under MODEL.MASK_ON, masks, under MODEL.KEYPOINT_ON
keypoints, mirrored through ``keypoint_hflip_indices`` under a flip), the
empty ones dropped.

A record that carries its pixels (``image``, uint8 RGB) or its stuff map
(``sem_seg``, uint8, at the image's size), as ``datasets.synthetic`` makes
them, is not decoded; one that names a file (``file_name``,
``sem_seg_file_name``) is, with Pillow, and raises where Pillow is absent.

In training under INPUT.CROP the crop comes first (``RandomCrop``, or the
category-area crop when SINGLE_CATEGORY_MAX_AREA is below 1), and under
MODEL.MASK_ON the boxes are recomputed from the cropped masks before the
empty ones are dropped (JAX package ``dataset_mapper.py:55-70,149-158``);
precomputed proposals are clipped to the crop and filtered
(``transform_proposals``).

The random augmentations draw from ``rng``, a ``np.random.RandomState``
that the mapper owns (the train loader seeds it, ``data.build``); the
JAX package draws the same calls from the global ``np.random``.
``draw(record)`` makes one record's draws ahead of mapping it, so that the
loader's threads map records in any order with the draws of the
sampler's order. The crop draws on the record's size (its ``height`` and
``width``) and the category-area crop on its stuff map, which ``draw``
reads then.
"""

from __future__ import annotations

import copy
import logging
from typing import List, Optional

import numpy as np

from . import detection_utils as utils
from . import transforms as T
from ..structures import PolygonMasks, bitmask_bounding_boxes


class DatasetMapper:
    def __init__(self, cfg, is_train: bool = False):
        augmentations = utils.build_augmentation(cfg, is_train)
        c = cfg.INPUT.CROP
        crop = is_train and c.ENABLED
        if crop and c.SINGLE_CATEGORY_MAX_AREA < 1.0:
            augmentations.insert(0, T.RandomCrop_CategoryAreaConstraint(
                c.TYPE, c.SIZE, c.SINGLE_CATEGORY_MAX_AREA, cfg.MODEL.SEM_SEG_HEAD.IGNORE_VALUE))
        elif crop:
            augmentations.insert(0, T.RandomCrop(c.TYPE, c.SIZE))
        self.recompute_boxes = crop and cfg.MODEL.MASK_ON
        self.is_train = is_train
        self.augmentations = T.AugmentationList(augmentations)
        self.image_format = cfg.INPUT.FORMAT
        self.use_instance_mask = cfg.MODEL.MASK_ON
        self.instance_mask_format = cfg.INPUT.MASK_FORMAT
        self.use_keypoint = cfg.MODEL.KEYPOINT_ON
        self.keypoint_hflip_indices = (
            utils.create_keypoint_hflip_indices(cfg.DATASETS.TRAIN) if is_train and cfg.MODEL.KEYPOINT_ON else None
        )
        self.rng = np.random.RandomState()
        topk = cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN if is_train else cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST
        self.proposal_topk: Optional[int] = topk if cfg.MODEL.LOAD_PROPOSALS else None
        mode = "training" if is_train else "inference"
        logging.getLogger(__name__).info(f"[DatasetMapper] Augmentations used in {mode}: {augmentations}")

    @property
    def draws_on_record(self) -> bool:
        """Whether ``draw`` needs the record (the crops)."""
        return self.augmentations.draws_on_image

    def draw(self, record: Optional[dict] = None) -> List:
        """One record's augmentation draws, from ``rng``; the crops read the
        record's size and, for the category-area crop, its stuff map."""
        if not self.draws_on_record:
            return self.augmentations.draw(self.rng)
        if "height" in record and "width" in record:
            shape = (record["height"], record["width"])
        else:
            shape = utils.record_image(record).shape[:2]
        sem_seg = None
        if "sem_seg" in self.augmentations.augs[0].input_args:
            sem_seg = record.get("sem_seg")
            if sem_seg is None and "sem_seg_file_name" in record:
                sem_seg = utils.read_sem_seg(record["sem_seg_file_name"])
        return self.augmentations.draw(self.rng, shape, sem_seg)

    def _transform_proposals(self, dataset_dict: dict, image_shape, transforms) -> None:
        """The proposal step; subclasses extend it (``wsl.data.WSLDatasetMapper``
        also transforms the superpixels and their membership)."""
        utils.transform_proposals(dataset_dict, image_shape, transforms, proposal_topk=self.proposal_topk)

    def __call__(self, dataset_dict: dict, drawn: Optional[List] = None) -> dict:
        """The mapped record, with the augmentation draws ``drawn`` (from
        ``draw()``; made here when None)."""
        dataset_dict = copy.deepcopy(dataset_dict)
        image = utils.record_image(dataset_dict, self.image_format)
        dataset_dict.pop("image", None)
        utils.check_image_size(dataset_dict, image)
        sem_seg_gt = dataset_dict.pop("sem_seg", None)
        if "sem_seg_file_name" in dataset_dict:
            sem_seg_gt = utils.read_sem_seg(dataset_dict.pop("sem_seg_file_name"))
        aug_input = T.AugInput(image, sem_seg=sem_seg_gt)
        if drawn is None:
            drawn = self.augmentations.draw(self.rng, image.shape[:2], sem_seg_gt)
        transforms = self.augmentations(aug_input, drawn)
        image, sem_seg_gt = aug_input.image, aug_input.sem_seg
        image_shape = image.shape[:2]
        dataset_dict["image"] = np.ascontiguousarray(image.astype(np.float32))
        if sem_seg_gt is not None:
            dataset_dict["sem_seg"] = sem_seg_gt.astype(np.int64)
        if self.proposal_topk is not None:
            self._transform_proposals(dataset_dict, image_shape, transforms)
        dataset_dict.pop("pan_seg", None)
        annos = dataset_dict.pop("annotations", None)
        if not self.is_train or annos is None:
            return dataset_dict
        for anno in annos:
            if not self.use_instance_mask:
                anno.pop("segmentation", None)
            if not self.use_keypoint:
                anno.pop("keypoints", None)
        annos = [utils.transform_instance_annotations(obj, transforms, image_shape,
                                                      keypoint_hflip_indices=self.keypoint_hflip_indices)
                 for obj in annos if obj.get("iscrowd", 0) == 0]
        instances = utils.annotations_to_instances(annos, image_shape, mask_format=self.instance_mask_format)
        if self.recompute_boxes and instances.has("gt_masks"):
            gm = instances.gt_masks
            instances.gt_boxes = gm.get_bounding_boxes() if isinstance(gm, PolygonMasks) else bitmask_bounding_boxes(gm)
        dataset_dict["instances"] = utils.filter_empty_instances(instances)
        return dataset_dict
