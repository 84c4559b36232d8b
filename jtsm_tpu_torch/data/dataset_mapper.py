"""DatasetMapper: a dataset dict to the per-image dict the collator takes
(reference: detectron2/data/dataset_mapper.py:20; JAX package
``data/dataset_mapper.py:22,85,92,99``), in test mode: decode, check the
size, resize the image and its sem-seg ground truth, transform the
precomputed proposals, and keep the image HWC float32.

A record that carries its pixels (``image``, uint8 RGB) or its stuff map
(``sem_seg``, uint8, at the image's size), as ``datasets.synthetic`` makes
them, is not decoded; one that names a file (``file_name``,
``sem_seg_file_name``) is, with Pillow, and raises where Pillow is absent.
"""

from __future__ import annotations

import copy
import logging
from typing import Optional

import numpy as np

from . import detection_utils as utils
from . import transforms as T


class DatasetMapper:
    def __init__(self, cfg, is_train: bool = False):
        if is_train:
            raise NotImplementedError("the train mapper is not ported yet (ROADMAP queue 1)")
        augmentations = utils.build_augmentation(cfg, False)
        self.augmentations = T.AugmentationList(augmentations)
        self.image_format = cfg.INPUT.FORMAT
        self.proposal_topk: Optional[int] = (
            cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST if cfg.MODEL.LOAD_PROPOSALS else None
        )
        logging.getLogger(__name__).info(f"[DatasetMapper] Augmentations used in inference: {augmentations}")

    def _transform_proposals(self, dataset_dict: dict, image_shape, transforms) -> None:
        """The proposal step; subclasses extend it (``wsl.data.WSLDatasetMapper``
        also transforms the superpixels and their membership)."""
        utils.transform_proposals(dataset_dict, image_shape, transforms, proposal_topk=self.proposal_topk)

    def __call__(self, dataset_dict: dict) -> dict:
        dataset_dict = copy.deepcopy(dataset_dict)
        pixels = dataset_dict.pop("image", None)
        if pixels is None:
            image = utils.read_image(dataset_dict["file_name"], format=self.image_format)
        else:
            image = utils.convert_rgb_to_format(pixels, self.image_format)
        utils.check_image_size(dataset_dict, image)
        sem_seg_gt = dataset_dict.pop("sem_seg", None)
        if "sem_seg_file_name" in dataset_dict:
            sem_seg_gt = utils.read_sem_seg(dataset_dict.pop("sem_seg_file_name"))
        aug_input = T.AugInput(image, sem_seg=sem_seg_gt)
        transforms = self.augmentations(aug_input)
        image, sem_seg_gt = aug_input.image, aug_input.sem_seg
        dataset_dict["image"] = np.ascontiguousarray(image.astype(np.float32))
        if sem_seg_gt is not None:
            dataset_dict["sem_seg"] = sem_seg_gt.astype(np.int64)
        if self.proposal_topk is not None:
            self._transform_proposals(dataset_dict, image.shape[:2], transforms)
        dataset_dict.pop("annotations", None)
        dataset_dict.pop("pan_seg", None)
        return dataset_dict
