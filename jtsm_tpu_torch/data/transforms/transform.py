"""Deterministic image transforms on the host, in numpy (reference:
detectron2/data/transforms/transform.py:94 ``ResizeTransform``; JAX package
``data/transforms/transform.py:111``).

The JAX package resizes uint8 images with Pillow's ``BILINEAR`` filter.
Pillow is absent where the port runs on the card, so ``resize_bilinear_uint8``
is Pillow's separable resampler written out in numpy
(``src/libImaging/Resample.c``: ``precompute_coeffs``, 8-bit coefficients
with 22 fraction bits, the horizontal pass into a uint8 image, then the
vertical pass). It gives Pillow's pixels bit for bit. When downscaling,
Pillow's bilinear filter is a triangle of the scale's width
(antialiasing), not a 2x2 interpolation.

Segmentations resize with Pillow's ``NEAREST`` filter, which the JAX package
applies in ``L`` mode to uint8 maps and in ``F`` mode (float32) to others,
such as the int32 superpixel ids. ``resize_nearest`` is that filter written
out (``src/libImaging/Geometry.c`` ``ImagingScaleAffine``): the source
coordinate of output index ``i`` is a double that starts at half the scale
and adds the scale once per step, truncated to an index.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

PRECISION_BITS = 32 - 8 - 2  # Resample.c: 8-bit values, 2 bits of headroom


def _bilinear_coeffs(in_size: int, out_size: int):
    """For each output index: the first input index it reads, and the
    integer weights of up to ``ksize`` consecutive inputs (zero past the
    filter's support), as ``precompute_coeffs`` and
    ``normalize_coeffs_8bpc`` compute them in double precision."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale  # the bilinear filter's support is 1
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C casts to int by truncation; the lower bound is clamped at 0 anyway
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    x = np.arange(ksize)
    live = x[None, :] < xmax[:, None]
    t = np.abs((x[None, :] + xmin[:, None] - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(live & (t < 1.0), 1.0 - t, 0.0)
    ww = np.zeros(out_size)
    for i in range(ksize):  # the C loop's order of summation
        ww = ww + w[:, i]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    k = np.trunc(0.5 + w * (1 << PRECISION_BITS)).astype(np.int64)  # the weights are >= 0
    return xmin, np.where(live, k, 0), ksize


def _resample_axis(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One pass of Pillow's 8-bit resampler along ``axis`` (0 or 1): integer
    accumulation from a half, then the shift, clipped to 0..255. The sums
    stay below 2^31 (255 times weights that add up to about 2^22)."""
    in_size = img.shape[axis]
    xmin, k, ksize = _bilinear_coeffs(in_size, out_size)
    k = k.astype(np.int32)
    src = img.astype(np.int32)
    wshape = [1] * src.ndim
    wshape[axis] = -1
    acc = np.full(src.shape[:axis] + (out_size,) + src.shape[axis + 1:], 1 << (PRECISION_BITS - 1), np.int32)
    for i in range(ksize):
        taps = np.take(src, np.minimum(xmin + i, in_size - 1), axis=axis)
        taps *= k[:, i].reshape(wshape)
        acc += taps
    acc >>= PRECISION_BITS
    return np.clip(acc, 0, 255).astype(np.uint8)


def resize_bilinear_uint8(img: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """``Image.fromarray(img).resize((new_w, new_h), Image.BILINEAR)`` of a
    uint8 (H, W) or (H, W, C) array, without Pillow."""
    assert img.dtype == np.uint8, img.dtype
    out = img
    if new_w != img.shape[1]:
        out = _resample_axis(out, 1, new_w)
    if new_h != img.shape[0]:
        out = _resample_axis(out, 0, new_h)
    return np.ascontiguousarray(out)


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """The input index Pillow's nearest filter reads for each of
    ``out_size`` outputs: the coordinate accumulates in double precision,
    as the C loop does (``xo = a * 0.5``, then ``xo += a``)."""
    steps = np.full(out_size, float(in_size) / out_size)
    steps[0] *= 0.5
    return np.trunc(np.add.accumulate(steps)).astype(np.int64)


def resize_nearest(img: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """``Image.resize((new_w, new_h), Image.NEAREST)`` of an (H, W) or (H, W,
    C) array, without Pillow; the array keeps its dtype."""
    ys = _nearest_index(img.shape[0], new_h)
    xs = _nearest_index(img.shape[1], new_w)
    return np.ascontiguousarray(img[ys[:, None], xs[None, :]])


class Transform:
    """A deterministic transform of an image and of what lies on it: boxes
    (through their corners) and segmentations."""

    def apply_image(self, img: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def apply_coords(self, coords: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def apply_box(self, box: np.ndarray) -> np.ndarray:
        """(N, 4) XYXY boxes: the envelope of the transformed corners."""
        box = np.asarray(box, dtype=np.float64).reshape(-1, 4)
        coords = self.apply_coords(box[:, [0, 1, 2, 1, 0, 3, 2, 3]].reshape(-1, 2)).reshape(-1, 4, 2)
        return np.concatenate((coords.min(axis=1), coords.max(axis=1)), axis=1)

    def apply_segmentation(self, segmentation: np.ndarray) -> np.ndarray:
        return self.apply_image(segmentation)


class TransformList(Transform):
    def __init__(self, transforms: Sequence[Transform]):
        self.transforms: List[Transform] = []
        for t in transforms:
            self.transforms.extend(t.transforms if isinstance(t, TransformList) else [t])

    def apply_image(self, img):
        for t in self.transforms:
            img = t.apply_image(img)
        return img

    def apply_coords(self, coords):
        for t in self.transforms:
            coords = t.apply_coords(coords)
        return coords

    def apply_segmentation(self, seg):
        for t in self.transforms:
            seg = t.apply_segmentation(seg)
        return seg

    def __len__(self):
        return len(self.transforms)

    def __getitem__(self, i):
        return self.transforms[i]


class NoOpTransform(Transform):
    def apply_image(self, img):
        return img

    def apply_coords(self, coords):
        return coords


class ResizeTransform(Transform):
    """Resize (h, w) to (new_h, new_w) (reference transform.py:94). Images
    are uint8, resized as Pillow's ``BILINEAR`` does (other filters and
    float images are not ported yet); segmentations as its ``NEAREST``
    does, in float32 unless they are uint8 or bool, as the JAX package's
    ``F`` mode gives them."""

    def __init__(self, h: int, w: int, new_h: int, new_w: int):
        self.h, self.w, self.new_h, self.new_w = h, w, new_h, new_w

    def apply_image(self, img: np.ndarray) -> np.ndarray:
        assert img.shape[:2] == (self.h, self.w), (img.shape, self.h, self.w)
        if img.dtype != np.uint8:
            raise NotImplementedError("only uint8 images are resized in the port so far")
        return resize_bilinear_uint8(img, self.new_h, self.new_w)

    def apply_coords(self, coords):
        coords = np.asarray(coords, dtype=np.float64).copy()
        coords[:, 0] = coords[:, 0] * (self.new_w * 1.0 / self.w)
        coords[:, 1] = coords[:, 1] * (self.new_h * 1.0 / self.h)
        return coords

    def apply_segmentation(self, seg: np.ndarray) -> np.ndarray:
        assert seg.shape[:2] == (self.h, self.w), (seg.shape, self.h, self.w)
        if seg.dtype == np.uint8 or seg.dtype == bool:
            return resize_nearest(seg, self.new_h, self.new_w)
        return resize_nearest(seg.astype(np.float32), self.new_h, self.new_w)
