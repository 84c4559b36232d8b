"""Augmentations: each picks a deterministic Transform for its input
(reference: detectron2/data/transforms/augmentation.py:77, :241, :275 and
augmentation_impl.py:70 ``RandomFlip``, :122 ``ResizeShortestEdge``; JAX
package ``data/transforms/augmentation.py:134,169``).

An augmentation's random choice is made apart from its image: ``draw(rng)``
takes it from a ``np.random.RandomState`` (or the module ``np.random``,
the default, as the JAX package draws), and ``get_transform(image,
drawn)`` builds the transform from it. The draws do not depend on the
image, so a loader can make them in the sampler's order and map the
images on worker threads in any order (``data.build``). Each draw is the
JAX package's call on the same stream: ``randint`` for the range style,
``choice`` for the choice style, one ``uniform`` for the flip.

The crops (``RandomCrop``, ``RandomCrop_CategoryAreaConstraint``;
reference augmentation_impl.py:229,291, JAX package
``augmentation.py:218-285``) draw on the image's size, and the
category-area crop on its stuff map, so they are ``draws_on_image``: their
``draw(rng, image_shape, sem_seg)`` takes both, and an augmentation list
puts one only first, where the record's own size is the image's.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Tuple

import numpy as np

from .transform import CropTransform, HFlipTransform, NoOpTransform, ResizeTransform, Transform, TransformList, VFlipTransform


class Augmentation:
    input_args: Tuple[str, ...] = ("image",)
    draws_on_image = False  # the draw needs the image's size (and stuff map)

    def draw(self, rng=np.random):
        """The random choice, from ``rng``; None for a fixed augmentation."""
        return None

    def get_transform(self, image, drawn=None) -> Transform:
        """The transform of ``image`` for the choice ``drawn`` (made here
        from ``np.random`` when None)."""
        raise NotImplementedError

    def __call__(self, aug_input, drawn=None) -> Transform:
        tfm = self.get_transform(*[getattr(aug_input, a) for a in self.input_args], drawn=drawn)
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

    @property
    def draws_on_image(self) -> bool:
        return any(a.draws_on_image for a in self.augs)

    def draw(self, rng=np.random, image_shape=None, sem_seg=None) -> List:
        """Each augmentation's choice, in order; one that draws on the image
        (first in the list) takes ``image_shape`` (h, w) and ``sem_seg``."""
        if any(a.draws_on_image for a in self.augs[1:]):
            raise ValueError("an augmentation that draws on the image must come first")
        return [a.draw(rng, image_shape, sem_seg) if a.draws_on_image else a.draw(rng) for a in self.augs]

    def __call__(self, aug_input, drawn: Optional[List] = None) -> TransformList:
        if drawn is None:
            drawn = self.draw(np.random, aug_input.image.shape[:2], aug_input.sem_seg)
        return TransformList([a(aug_input, d) for a, d in zip(self.augs, drawn)])

    def __repr__(self):
        return repr(self.augs)


class RandomFlip(Augmentation):
    """Flip with probability ``prob``, horizontally or vertically
    (reference augmentation_impl.py:70)."""

    def __init__(self, prob: float = 0.5, *, horizontal: bool = True, vertical: bool = False):
        if horizontal and vertical:
            raise ValueError("Cannot do both horiz and vert. Use two Flip instead.")
        if not horizontal and not vertical:
            raise ValueError("At least one of horiz or vert has to be True!")
        self.prob = prob
        self.horizontal = horizontal

    def draw(self, rng=np.random) -> bool:
        return bool(rng.uniform(0.0, 1.0, []) < self.prob)

    def get_transform(self, image, drawn=None):
        if drawn is None:
            drawn = self.draw()
        if not drawn:
            return NoOpTransform()
        h, w = image.shape[:2]
        return HFlipTransform(w) if self.horizontal else VFlipTransform(h)


class ResizeShortestEdge(Augmentation):
    """Resize the short edge to a length drawn from ``short_edge_length``
    (an integer in [lo, hi] in the "range" style, one of the list in the
    "choice" style), the long edge no longer than ``max_size`` (reference
    augmentation_impl.py:122); a length of 0 leaves the image as it is."""

    def __init__(self, short_edge_length, max_size: int = sys.maxsize, sample_style: str = "range"):
        assert sample_style in ("range", "choice"), sample_style
        self.is_range = sample_style == "range"
        if isinstance(short_edge_length, int):
            short_edge_length = (short_edge_length, short_edge_length)
        self.short_edge_length = short_edge_length
        self.max_size = max_size

    def draw(self, rng=np.random) -> int:
        if self.is_range:
            return int(rng.randint(self.short_edge_length[0], self.short_edge_length[1] + 1))
        return int(rng.choice(self.short_edge_length))

    def get_transform(self, image, drawn=None):
        size = self.draw() if drawn is None else drawn
        if size == 0:
            return NoOpTransform()
        h, w = image.shape[:2]
        return ResizeTransform(h, w, *ResizeShortestEdge.get_output_shape(h, w, size, self.max_size))

    def __repr__(self):
        style = "range" if self.is_range else "choice"
        return f"ResizeShortestEdge(short_edge_length={tuple(self.short_edge_length)}, max_size={self.max_size}, " \
               f"sample_style={style!r})"

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


class RandomCrop(Augmentation):
    """A window of the image whose size follows ``crop_type`` (reference
    augmentation_impl.py:229, JAX package ``augmentation.py:218``):
    "relative" (``crop_size`` fractions of h and w), "relative_range" (each
    fraction drawn in [crop_size, 1]), "absolute" (``crop_size`` pixels, at
    most the image) or "absolute_range" (each side drawn in [crop_size[0],
    crop_size[1]], at most the image); its corner uniform over the places
    it fits. The draws are the JAX package's, in its order: ``rand(2)`` for
    "relative_range" (``randint`` for h, then w, for "absolute_range"), then
    ``randint`` for y0, then for x0."""

    draws_on_image = True

    def __init__(self, crop_type: str, crop_size):
        if crop_type not in ("relative_range", "relative", "absolute", "absolute_range"):
            raise ValueError(f"RandomCrop crop_type {crop_type!r}")
        self.crop_type = crop_type
        self.crop_size = crop_size

    def get_crop_size(self, image_size, rng=np.random) -> Tuple[int, int]:
        h, w = image_size
        if self.crop_type == "relative":
            ch, cw = self.crop_size
            return int(h * ch + 0.5), int(w * cw + 0.5)
        if self.crop_type == "relative_range":
            crop_size = np.asarray(self.crop_size, dtype=np.float32)
            ch, cw = crop_size + rng.rand(2) * (1 - crop_size)
            return int(h * ch + 0.5), int(w * cw + 0.5)
        if self.crop_type == "absolute":
            return min(self.crop_size[0], h), min(self.crop_size[1], w)
        assert self.crop_size[0] <= self.crop_size[1]
        ch = rng.randint(min(h, self.crop_size[0]), min(h, self.crop_size[1]) + 1)
        cw = rng.randint(min(w, self.crop_size[0]), min(w, self.crop_size[1]) + 1)
        return int(ch), int(cw)

    def draw(self, rng=np.random, image_shape=None, sem_seg=None) -> Tuple[int, int, int, int]:
        """(x0, y0, w, h) of the window in an image of ``image_shape``."""
        h, w = image_shape
        croph, cropw = self.get_crop_size((h, w), rng)
        assert h >= croph and w >= cropw, f"Shape computation in {self} has bugs."
        y0 = int(rng.randint(h - croph + 1))
        x0 = int(rng.randint(w - cropw + 1))
        return x0, y0, cropw, croph

    def get_transform(self, image, drawn=None) -> CropTransform:
        if drawn is None:
            drawn = self.draw(np.random, image.shape[:2])
        return CropTransform(*drawn)


class RandomCrop_CategoryAreaConstraint(Augmentation):
    """``RandomCrop`` drawn again, up to 10 times, until no category of the
    stuff map but ``ignored_category`` covers ``single_category_max_area``
    or more of the window and more than one does (reference
    augmentation_impl.py:291, JAX package ``augmentation.py:250-285``);
    the last window when none passes. At ``single_category_max_area`` 1 or
    without a stuff map it is ``RandomCrop``."""

    input_args = ("image", "sem_seg")
    draws_on_image = True

    def __init__(self, crop_type: str, crop_size, single_category_max_area: float = 1.0,
                 ignored_category: Optional[int] = None):
        self.crop_aug = RandomCrop(crop_type, crop_size)
        self.single_category_max_area = single_category_max_area
        self.ignored_category = ignored_category

    def draw(self, rng=np.random, image_shape=None, sem_seg=None) -> Tuple[int, int, int, int]:
        if self.single_category_max_area >= 1.0 or sem_seg is None:
            return self.crop_aug.draw(rng, image_shape)
        h, w = sem_seg.shape
        for _ in range(10):
            croph, cropw = self.crop_aug.get_crop_size((h, w), rng)
            y0 = int(rng.randint(h - croph + 1))
            x0 = int(rng.randint(w - cropw + 1))
            labels, counts = np.unique(sem_seg[y0:y0 + croph, x0:x0 + cropw], return_counts=True)
            if self.ignored_category is not None:
                counts = counts[labels != self.ignored_category]
            if len(counts) > 1 and np.max(counts) < np.sum(counts) * self.single_category_max_area:
                break
        return x0, y0, cropw, croph

    def get_transform(self, image, sem_seg, drawn=None) -> CropTransform:
        if drawn is None:
            drawn = self.draw(np.random, image.shape[:2], sem_seg)
        return CropTransform(*drawn)
