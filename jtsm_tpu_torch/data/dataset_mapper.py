"""DatasetMapper: a dataset dict to the per-image dict the collator takes
(reference: detectron2/data/dataset_mapper.py:20; JAX package
``data/dataset_mapper.py:22,99``), in test mode: decode, check the size,
resize, and keep the image HWC float32. A record that carries its pixels
(``image``, uint8 RGB, from ``datasets.synthetic``) is not decoded."""

from __future__ import annotations

import copy
import logging

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
        logging.getLogger(__name__).info(f"[DatasetMapper] Augmentations used in inference: {augmentations}")

    def __call__(self, dataset_dict: dict) -> dict:
        dataset_dict = copy.deepcopy(dataset_dict)
        pixels = dataset_dict.pop("image", None)
        if pixels is None:
            image = utils.read_image(dataset_dict["file_name"], format=self.image_format)
        else:
            image = utils.convert_rgb_to_format(pixels, self.image_format)
        utils.check_image_size(dataset_dict, image)
        aug_input = T.AugInput(image)
        self.augmentations(aug_input)
        dataset_dict["image"] = np.ascontiguousarray(aug_input.image.astype(np.float32))
        dataset_dict.pop("annotations", None)
        return dataset_dict
