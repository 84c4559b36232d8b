"""Augmentations: each picks a deterministic Transform for its input
(reference: detectron2/data/transforms/augmentation.py:77, :241, :275 and
augmentation_impl.py:122 ``ResizeShortestEdge``; JAX package
``data/transforms/augmentation.py:169``), as the test path uses them; the
random train augmentations come with the train loader (ROADMAP)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .transform import NoOpTransform, ResizeTransform, Transform, TransformList


class Augmentation:
    input_args: Tuple[str, ...] = ("image",)

    def get_transform(self, *args) -> Transform:
        raise NotImplementedError

    def __call__(self, aug_input) -> Transform:
        tfm = self.get_transform(*[getattr(aug_input, a) for a in self.input_args])
        aug_input.transform(tfm)
        return tfm

    def __repr__(self):
        return self.__class__.__name__

    __str__ = __repr__


class AugInput:
    """Carries an image, and optionally its sem-seg map, through a chain of
    transforms (reference augmentation.py:275)."""

    def __init__(self, image: np.ndarray, *, sem_seg: Optional[np.ndarray] = None):
        self.image = image
        self.sem_seg = sem_seg

    def transform(self, tfm: Transform) -> None:
        self.image = tfm.apply_image(self.image)
        if self.sem_seg is not None:
            self.sem_seg = tfm.apply_segmentation(self.sem_seg)


class AugmentationList(Augmentation):
    def __init__(self, augs):
        self.augs = list(augs)

    def __call__(self, aug_input) -> TransformList:
        return TransformList([x(aug_input) for x in self.augs])


class ResizeShortestEdge(Augmentation):
    """Resize the short edge to one of ``short_edge_length`` (chosen with
    ``np.random``, as the reference's "choice" style does), the long edge
    no longer than ``max_size`` (reference augmentation_impl.py:122); a
    length of 0 leaves the image as it is."""

    def __init__(self, short_edge_length, max_size: int):
        if isinstance(short_edge_length, int):
            short_edge_length = (short_edge_length,)
        self.short_edge_length = short_edge_length
        self.max_size = max_size

    def get_transform(self, image):
        h, w = image.shape[:2]
        size = np.random.choice(self.short_edge_length)
        if size == 0:
            return NoOpTransform()
        return ResizeTransform(h, w, *ResizeShortestEdge.get_output_shape(h, w, size, self.max_size))

    @staticmethod
    def get_output_shape(oldh: int, oldw: int, short_edge_length: int, max_size: int):
        h, w = oldh, oldw
        size = short_edge_length * 1.0
        scale = size / min(h, w)
        if h < w:
            newh, neww = size, scale * w
        else:
            newh, neww = scale * h, size
        if max(newh, neww) > max_size:
            scale = max_size * 1.0 / max(newh, neww)
            newh = newh * scale
            neww = neww * scale
        return int(newh + 0.5), int(neww + 0.5)
