"""Image decoding, the test augmentation, precomputed proposals and the
static-batch collator (reference: detectron2/data/detection_utils.py:165
``read_image``, :212 ``transform_proposals``, :571 ``build_augmentation``;
JAX package ``data/detection_utils.py:64,83,91,106,379,405,476``).

``read_image`` and ``read_sem_seg`` decode with Pillow, imported when they
are called; where Pillow is absent they raise. Images and ground truth made
in memory (``datasets.synthetic``) reach the mapper as arrays and need no
decoding.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..structures import BoxMode
from . import transforms as T


class SizeMismatchError(ValueError):
    pass


_EXIF_ORIENT = 274


def _apply_exif_orientation(image):
    from PIL import Image

    try:
        exif = image.getexif()
    except Exception:
        return image
    method = {
        2: Image.FLIP_LEFT_RIGHT,
        3: Image.ROTATE_180,
        4: Image.FLIP_TOP_BOTTOM,
        5: Image.TRANSPOSE,
        6: Image.ROTATE_270,
        7: Image.TRANSVERSE,
        8: Image.ROTATE_90,
    }.get(exif.get(_EXIF_ORIENT))
    return image.transpose(method) if method is not None else image


def convert_rgb_to_format(image: np.ndarray, format: Optional[str]) -> np.ndarray:
    """An (H, W, 3) uint8 RGB array in the channel order ``format`` names
    (None and "RGB" keep it, "BGR" reverses it)."""
    if format in (None, "RGB"):
        return image
    if format == "BGR":
        return image[:, :, ::-1]
    raise NotImplementedError(f"image format {format!r} is not ported yet")


def convert_PIL_to_numpy(image, format: Optional[str]) -> np.ndarray:
    """A Pillow image as an array in ``format`` (reference
    detection_utils.py:64): the RGB and BGR channel orders."""
    if format is None:
        return np.asarray(image)
    return convert_rgb_to_format(np.asarray(image.convert("RGB" if format == "BGR" else format)), format)


def _pillow(file_name: str):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"reading {file_name} needs Pillow, which is not installed; datasets made in memory "
            "(jtsm_tpu_torch.data.datasets.synthetic) carry their pixels and ground truth as arrays and need none"
        ) from e
    return Image


def read_image(file_name: str, format: Optional[str] = None) -> np.ndarray:
    """Decode an image file, with its EXIF rotation (reference
    detection_utils.py:165). Needs Pillow."""
    Image = _pillow(file_name)
    with open(file_name, "rb") as f:
        return convert_PIL_to_numpy(_apply_exif_orientation(Image.open(f)), format)


def read_sem_seg(file_name: str, dtype=np.uint8) -> np.ndarray:
    """A PNG of labels (a stuff map, or a panoptic map in RGB) as Pillow
    decodes it, in ``dtype``. Needs Pillow."""
    Image = _pillow(file_name)
    with open(file_name, "rb") as f:
        return np.array(Image.open(f), dtype=dtype)


def check_image_size(dataset_dict: dict, image: np.ndarray) -> None:
    if "width" in dataset_dict or "height" in dataset_dict:
        image_wh = (image.shape[1], image.shape[0])
        expected_wh = (dataset_dict["width"], dataset_dict["height"])
        if not image_wh == expected_wh:
            raise SizeMismatchError(
                f"Mismatched image shape for {dataset_dict.get('file_name', '')}: "
                f"got {image_wh}, expect {expected_wh}."
            )
    dataset_dict.setdefault("width", image.shape[1])
    dataset_dict.setdefault("height", image.shape[0])


def build_augmentation(cfg, is_train: bool) -> List[T.Augmentation]:
    """The test augmentation: the short edge to INPUT.MIN_SIZE_TEST, the long
    one at most INPUT.MAX_SIZE_TEST (reference detection_utils.py:571). The
    train branch comes with the train loader (ROADMAP)."""
    if is_train:
        raise NotImplementedError("the train augmentation is not ported yet (ROADMAP queue 1)")
    return [T.ResizeShortestEdge(cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST)]


def transform_proposals(dataset_dict: dict, image_shape, transforms, *, proposal_topk: int,
                        min_box_size: float = 0) -> None:
    """The record's precomputed proposals through ``transforms``, clipped to
    the image, boxes of at most ``min_box_size`` dropped, the
    ``proposal_topk`` of highest objectness kept, as ``proposals`` =
    {boxes, objectness_logits} (reference detection_utils.py:212). The
    order is ``np.argsort`` of the negated logits, as the JAX package
    takes it (its order among ties)."""
    if "proposal_boxes" not in dataset_dict:
        return
    boxes, logits, _ = transformed_proposals(dataset_dict, image_shape, transforms, min_box_size)
    order = np.argsort(-logits)[:proposal_topk]
    dataset_dict["proposals"] = {
        "boxes": boxes[order].astype(np.float32),
        "objectness_logits": logits[order].astype(np.float32),
    }


def transformed_proposals(dataset_dict: dict, image_shape, transforms, min_box_size: float):
    """Pops the record's proposal boxes and logits, transforms and clips the
    boxes; returns the boxes and logits that are wider and taller than
    ``min_box_size``, and that mask of the records' proposals."""
    boxes = BoxMode.convert(
        np.asarray(dataset_dict.pop("proposal_boxes")),
        dataset_dict.pop("proposal_bbox_mode", BoxMode.XYXY_ABS),
        BoxMode.XYXY_ABS,
    )
    boxes = transforms.apply_box(boxes)
    boxes = np.clip(boxes, [0, 0, 0, 0], [image_shape[1], image_shape[0]] * 2)
    logits = np.asarray(dataset_dict.pop("proposal_objectness_logits"))
    keep = ((boxes[:, 2] - boxes[:, 0]) > min_box_size) & ((boxes[:, 3] - boxes[:, 1]) > min_box_size)
    return boxes[keep], logits[keep], keep


def pick_bucket(h: int, w: int, buckets: Sequence[Sequence[int]]) -> Tuple[int, int]:
    """The smallest bucket that fits (h, w); the largest when none does."""
    best, best_area = None, None
    for bh, bw in buckets:
        if bh >= h and bw >= w and (best_area is None or bh * bw < best_area):
            best, best_area = (bh, bw), bh * bw
    if best is None:
        best = tuple(max(b[i] for b in buckets) for i in (0, 1))
    return best


def build_static_batch(per_image: List[dict], buckets: Sequence[Sequence[int]],
                       proposal_topk: int = 0) -> Dict[str, np.ndarray]:
    """Mapped per-image dicts (HWC float32 images) collated into one padded
    batch in the schema the models' ``inference`` takes: ``image`` (B, H,
    W, 3) in the smallest bucket that fits them all, zero padded, the true
    ``image_sizes`` and the ``orig_sizes`` to map boxes back to (JAX
    package ``detection_utils.py:476``). With ``proposal_topk``,
    ``proposals`` (B, K, 4) and ``proposal_scores`` (B, K), -inf in unused
    slots; where any dict has a resized ``sem_seg``, ``gt_sem_seg`` (B, H,
    W) int32 with 255 outside each image. Instance ground truth is
    collated with the train loader (ROADMAP)."""
    b = len(per_image)
    bh, bw = pick_bucket(max(d["image"].shape[0] for d in per_image),
                         max(d["image"].shape[1] for d in per_image), buckets)
    batch = {
        "image": np.zeros((b, bh, bw, 3), np.float32),
        "image_sizes": np.zeros((b, 2), np.int32),
        "orig_sizes": np.zeros((b, 2), np.int32),
    }
    if proposal_topk > 0:
        batch["proposals"] = np.zeros((b, proposal_topk, 4), np.float32)
        batch["proposal_scores"] = np.full((b, proposal_topk), -np.inf, np.float32)
    if any("sem_seg" in d for d in per_image):
        batch["gt_sem_seg"] = np.full((b, bh, bw), 255, np.int32)
    for i, d in enumerate(per_image):
        img = d["image"]
        h, w = img.shape[:2]
        batch["image"][i, :h, :w] = img
        batch["image_sizes"][i] = (h, w)
        batch["orig_sizes"][i] = (d.get("height", h), d.get("width", w))
        if "sem_seg" in d:
            batch["gt_sem_seg"][i, :h, :w] = d["sem_seg"]
        if proposal_topk > 0 and "proposals" in d:
            p = d["proposals"]
            n = min(len(p["boxes"]), proposal_topk)
            batch["proposals"][i, :n] = p["boxes"][:n]
            batch["proposal_scores"][i, :n] = p["objectness_logits"][:n]
    return batch
