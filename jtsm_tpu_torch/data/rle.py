"""COCO run-length mask codec in numpy, no pycocotools (JAX package
``data/rle.py:29,41,66,85,100``).

Runs are column-major (Fortran order) and start with a run of zeros;
compressed counts are the LEB128-like text of ``maskApi.c`` ``rleToString``.
"""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np


def rle_decode_counts(counts: List[int], h: int, w: int) -> np.ndarray:
    """Uncompressed counts -> (h, w) bool mask."""
    flat = np.zeros(h * w, dtype=bool)
    pos = 0
    val = False
    for c in counts:
        if val:
            flat[pos: pos + c] = True
        pos += c
        val = not val
    return flat.reshape((w, h)).T


def _runs(mask: np.ndarray) -> np.ndarray:
    """Column-major run lengths of an (h, w) bool mask, the first a run of
    zeros (0 when the first pixel is set)."""
    flat = np.ascontiguousarray(mask.T).reshape(-1)
    change = np.flatnonzero(flat[1:] != flat[:-1])
    runs = np.diff(np.concatenate([[-1], change, [flat.size - 1]]))
    if flat.size and flat[0]:
        runs = np.concatenate([[0], runs])
    return runs.astype(np.int64)


def rle_encode(mask: np.ndarray) -> Dict:
    """(h, w) bool -> uncompressed RLE dict."""
    h, w = mask.shape
    return {"counts": _runs(mask).tolist(), "size": [h, w]}


def rle_string_to_counts(s: Union[str, bytes]) -> List[int]:
    """Compressed counts text (``maskApi.c`` ``rleFrString``) -> counts."""
    if isinstance(s, str):
        s = s.encode("ascii")
    counts: List[int] = []
    i, n = 0, len(s)
    while i < n:
        x, k, more = 0, 0, True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def rle_string_decode(s: Union[str, bytes], h: int, w: int) -> np.ndarray:
    """Compressed counts text -> (h, w) bool mask."""
    return rle_decode_counts(rle_string_to_counts(s), h, w)


def rle_string_encode(mask: np.ndarray) -> Dict:
    """(h, w) bool -> compressed RLE dict (``maskApi.c`` ``rleToString``):
    each count after the second as its difference from the count two
    before, in groups of 5 bits, low first, each group a character from
    48, bit 5 set while more follow. All counts are encoded at once."""
    h, w = mask.shape
    counts = _runs(mask)
    x = counts.copy()
    x[3:] -= counts[1:-2]
    chars, emitted = [], []
    live = np.ones(x.shape, dtype=bool)
    while live.any():
        c = x & 0x1F
        x = x >> 5  # arithmetic, as Python's shift of a negative int
        more = ~(((x == 0) & ((c & 0x10) == 0)) | ((x == -1) & ((c & 0x10) != 0)))
        chars.append(np.where(more, c | 0x20, c) + 48)
        emitted.append(live)
        live = live & more
    text = np.stack(chars, axis=1)[np.stack(emitted, axis=1)] if chars else np.zeros(0, np.int64)
    return {"counts": text.astype(np.uint8).tobytes().decode("ascii"), "size": [h, w]}


def decode_segmentation(seg, h: int, w: int) -> np.ndarray:
    """A COCO ``segmentation`` (polygon list or RLE dict) -> (h, w) bool."""
    if isinstance(seg, dict):
        counts = seg["counts"]
        sh, sw = seg.get("size", (h, w))
        if isinstance(counts, list):
            return rle_decode_counts(counts, sh, sw)
        return rle_string_decode(counts, sh, sw)
    if isinstance(seg, list):
        from ..structures.masks import polygons_to_bitmask

        return polygons_to_bitmask([np.asarray(p) for p in seg], h, w)
    raise ValueError(f"Unsupported segmentation type: {type(seg)}")


def rle_area(rle: Dict) -> int:
    """The mask's pixel count: the sum of its runs of ones."""
    counts = rle["counts"]
    if not isinstance(counts, list):
        counts = rle_string_to_counts(counts)
    return int(sum(counts[1::2]))
