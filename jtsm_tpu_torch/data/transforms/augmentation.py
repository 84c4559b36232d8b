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
"""

from __future__ import annotations

import sys
from typing import List, Optional, Tuple

import numpy as np

from .transform import HFlipTransform, NoOpTransform, ResizeTransform, Transform, TransformList, VFlipTransform


class Augmentation:
    input_args: Tuple[str, ...] = ("image",)

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

    def draw(self, rng=np.random) -> List:
        """Each augmentation's choice, in order."""
        return [a.draw(rng) for a in self.augs]

    def __call__(self, aug_input, drawn: Optional[List] = None) -> TransformList:
        if drawn is None:
            drawn = self.draw()
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
