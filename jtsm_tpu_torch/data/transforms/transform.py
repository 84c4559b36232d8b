"""Deterministic image transforms on the host, in numpy (reference:
detectron2/data/transforms/transform.py:94 ``ResizeTransform``; JAX package
``data/transforms/transform.py:34,97,111,173,203,219``): resizes, flips and
crops of images, coordinates, boxes, polygons and segmentations.

The JAX package resizes uint8 images with Pillow's ``BILINEAR`` filter.
Pillow is absent where the port runs on the card, so ``resize_bilinear_uint8``
is Pillow's separable resampler written out in numpy
(``src/libImaging/Resample.c``: ``precompute_coeffs``, 8-bit coefficients
with 22 fraction bits, the horizontal pass into a uint8 image, then the
vertical pass). It gives Pillow's pixels bit for bit. When downscaling,
Pillow's bilinear filter is a triangle of the scale's width
(antialiasing), not a 2x2 interpolation.

Float images (the test-time augmentation's views, and the sem-seg logits it
resizes back) go through Pillow's 32-bit path, which the JAX package takes
channel by channel in ``F`` mode: the same coefficients kept as normalised
doubles, each output a double sum in the taps' order stored as float32,
the horizontal pass first (``resize_bilinear_float``).

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
    normalised double weights of up to ``ksize`` consecutive inputs (zero
    past the filter's support), as ``precompute_coeffs`` computes them."""
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
    return xmin, np.where(live, w, 0.0), ksize


def _resample_axis(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One pass of Pillow's 8-bit resampler along ``axis`` (0 or 1): the
    weights quantised to ``PRECISION_BITS`` (``normalize_coeffs_8bpc``),
    integer accumulation from a half, then the shift, clipped to 0..255.
    The sums stay below 2^31 (255 times weights that add up to about
    2^22)."""
    in_size = img.shape[axis]
    xmin, w, ksize = _bilinear_coeffs(in_size, out_size)
    k = np.trunc(0.5 + w * (1 << PRECISION_BITS)).astype(np.int32)  # the weights are >= 0
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


def _resample_axis_float(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One pass of Pillow's 32-bit resampler along ``axis`` (0 or 1) of a
    float32 array: each output the double sum, in the taps' order, of the
    inputs times their normalised weights, stored as float32
    (``ImagingResampleHorizontal_32bpc`` and its vertical twin). A tap past
    the support has weight 0 and adds 0 (the inputs are finite)."""
    in_size = img.shape[axis]
    xmin, w, ksize = _bilinear_coeffs(in_size, out_size)
    wshape = [1] * img.ndim
    wshape[axis] = -1
    src = img.astype(np.float64)
    acc = np.zeros(img.shape[:axis] + (out_size,) + img.shape[axis + 1:], np.float64)
    for i in range(ksize):
        taps = np.take(src, np.minimum(xmin + i, in_size - 1), axis=axis)
        taps *= w[:, i].reshape(wshape)
        acc += taps
    return acc.astype(np.float32)


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


def resize_bilinear_float(img: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """Pillow's ``F``-mode ``BILINEAR`` resize of each channel of an (H, W)
    or (H, W, C) array taken as float32 (``Image.fromarray(img[..., c],
    mode="F").resize((new_w, new_h), Image.BILINEAR)``), float32, without
    Pillow."""
    out = np.asarray(img, np.float32)
    if new_w != img.shape[1]:
        out = _resample_axis_float(out, 1, new_w)
    if new_h != img.shape[0]:
        out = _resample_axis_float(out, 0, new_h)
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

    def apply_polygons(self, polygons: List[np.ndarray]) -> List[np.ndarray]:
        """Flat (x0, y0, x1, y1, ...) polygons through ``apply_coords``."""
        return [self.apply_coords(np.asarray(p).reshape(-1, 2)).reshape(-1) for p in polygons]

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


class HFlipTransform(Transform):
    """Mirror left to right an image ``width`` wide (reference
    transform.py:173, JAX package ``transform.py:173``)."""

    def __init__(self, width: int):
        self.width = width

    def apply_image(self, img):
        return np.ascontiguousarray(img[:, ::-1])

    def apply_coords(self, coords):
        coords = np.asarray(coords, dtype=np.float64).copy()
        coords[:, 0] = self.width - coords[:, 0]
        return coords

    def apply_box(self, box):
        box = np.asarray(box, dtype=np.float64).reshape(-1, 4).copy()
        x0 = self.width - box[:, 2]
        x1 = self.width - box[:, 0]
        box[:, 0], box[:, 2] = x0, x1
        return box


class VFlipTransform(Transform):
    """Mirror top to bottom an image ``height`` tall (JAX package
    ``transform.py:203``)."""

    def __init__(self, height: int):
        self.height = height

    def apply_image(self, img):
        return np.ascontiguousarray(img[::-1])

    def apply_coords(self, coords):
        coords = np.asarray(coords, dtype=np.float64).copy()
        coords[:, 1] = self.height - coords[:, 1]
        return coords


class ResizeTransform(Transform):
    """Resize (h, w) to (new_h, new_w) (reference transform.py:94). Images
    resize as Pillow's ``BILINEAR`` does: uint8 ones in its 8-bit mode,
    others in float32 channel by channel (``F`` mode), as the JAX package
    hands them to Pillow (other filters are not ported yet); segmentations
    as its ``NEAREST`` does, in float32 unless they are uint8 or bool, as
    the JAX package's ``F`` mode gives them."""

    def __init__(self, h: int, w: int, new_h: int, new_w: int):
        self.h, self.w, self.new_h, self.new_w = h, w, new_h, new_w

    def apply_image(self, img: np.ndarray) -> np.ndarray:
        assert img.shape[:2] == (self.h, self.w), (img.shape, self.h, self.w)
        if img.dtype == np.uint8:
            return resize_bilinear_uint8(img, self.new_h, self.new_w)
        return resize_bilinear_float(img, self.new_h, self.new_w)

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


class CropTransform(Transform):
    """The window of ``w`` x ``h`` at (``x0``, ``y0``) (reference
    transform.py ``CropTransform``; JAX package ``transform.py:219-231``):
    images and segmentations are sliced, coordinates shifted. Polygons are
    shifted point by point and not clipped to the window, as in the JAX
    package (detectron2 clips them with shapely; ROADMAP §3); boxes take
    the envelope of their shifted corners, which the callers clip."""

    def __init__(self, x0: int, y0: int, w: int, h: int):
        self.x0, self.y0, self.w, self.h = x0, y0, w, h

    def apply_image(self, img):
        return img[self.y0:self.y0 + self.h, self.x0:self.x0 + self.w]

    def apply_coords(self, coords):
        coords = np.asarray(coords, dtype=np.float64).copy()
        coords[:, 0] -= self.x0
        coords[:, 1] -= self.y0
        return coords
