"""Image decoding, the augmentations, precomputed proposals, instance
annotations with their keypoints and the static-batch collator (reference:
detectron2/data/detection_utils.py:165 ``read_image``, :212
``transform_proposals``, :260 ``transform_instance_annotations``, :320
``transform_keypoint_annotations``, :366 ``annotations_to_instances``,
:460 ``filter_empty_instances``, :494 ``create_keypoint_hflip_indices``,
:512 ``gen_crop_transform_with_instance``, :571 ``build_augmentation``; JAX package ``data/detection_utils.py:64,83,
91,106,133,169,197,275,303,357,379,405,418,468,476``).

``read_image`` and ``read_sem_seg`` decode with Pillow, imported when they
are called; where Pillow is absent they raise. Images and ground truth made
in memory (``datasets.synthetic``) reach the mapper as arrays and need no
decoding.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..structures import BoxMode, Instances, PolygonMasks, polygons_to_bitmask, rasterize_polygons_within_box
from . import transforms as T
from .catalog import MetadataCatalog
from .rle import decode_segmentation


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


def record_image(dataset_dict: dict, format: Optional[str] = None) -> np.ndarray:
    """A record's pixels in ``format``: its in-memory ``image`` (uint8 RGB)
    as it is, else its ``file_name`` decoded (``read_image``)."""
    if dataset_dict.get("image") is not None:
        return convert_rgb_to_format(dataset_dict["image"], format)
    return read_image(dataset_dict["file_name"], format)


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


def gen_crop_transform_with_instance(crop_size, image_size, instance, rng=np.random) -> T.CropTransform:
    """A ``crop_size`` (h, w) window of an image of ``image_size`` (h, w)
    that holds the centre of ``instance``'s box (reference
    detection_utils.py:512, JAX package ``detection_utils.py:357-376``),
    its corner drawn with ``randint`` from ``rng``, y0 then x0."""
    crop_size = np.asarray(crop_size, dtype=np.int32)
    bbox = BoxMode.convert(instance["bbox"], instance["bbox_mode"], BoxMode.XYXY_ABS)
    center_yx = (bbox[1] + bbox[3]) * 0.5, (bbox[0] + bbox[2]) * 0.5
    assert image_size[0] >= center_yx[0] and image_size[1] >= center_yx[1], \
        "The annotation bounding box is outside of the image!"
    assert image_size[0] >= crop_size[0] and image_size[1] >= crop_size[1], "Crop size is larger than image size!"
    min_yx = np.maximum(np.floor(center_yx).astype(np.int32) - crop_size, 0)
    max_yx = np.maximum(np.asarray(image_size, dtype=np.int32) - crop_size, 0)
    max_yx = np.minimum(max_yx, np.ceil(center_yx).astype(np.int32))
    y0 = rng.randint(min_yx[0], max_yx[0] + 1)
    x0 = rng.randint(min_yx[1], max_yx[1] + 1)
    return T.CropTransform(x0, y0, crop_size[1], crop_size[0])


def build_augmentation(cfg, is_train: bool) -> List[T.Augmentation]:
    """The short edge to INPUT.MIN_SIZE_TRAIN (drawn in the style of
    MIN_SIZE_TRAIN_SAMPLING), the long one at most MAX_SIZE_TRAIN, then
    INPUT.RANDOM_FLIP, in training; the short edge to MIN_SIZE_TEST, the
    long one at most MAX_SIZE_TEST, in testing (reference
    detection_utils.py:571)."""
    if not is_train:
        return [T.ResizeShortestEdge(cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST, "choice")]
    augmentation = [T.ResizeShortestEdge(cfg.INPUT.MIN_SIZE_TRAIN, cfg.INPUT.MAX_SIZE_TRAIN,
                                         cfg.INPUT.MIN_SIZE_TRAIN_SAMPLING)]
    if cfg.INPUT.RANDOM_FLIP != "none":
        augmentation.append(T.RandomFlip(horizontal=cfg.INPUT.RANDOM_FLIP == "horizontal",
                                         vertical=cfg.INPUT.RANDOM_FLIP == "vertical"))
    return augmentation


def transform_instance_annotations(annotation: dict, transforms, image_size: Tuple[int, int], *,
                                   keypoint_hflip_indices: Optional[np.ndarray] = None) -> dict:
    """One annotation through ``transforms`` in place (reference
    detection_utils.py:260): its box, as the envelope of its transformed
    corners clipped to the image of ``image_size`` (h, w), in XYXY_ABS;
    its polygons point by point; an RLE segmentation decoded and
    transformed as a mask (bool); its keypoints
    (``transform_keypoint_annotations``)."""
    if isinstance(transforms, (tuple, list)):
        transforms = T.TransformList(transforms)
    bbox = BoxMode.convert(annotation["bbox"], annotation["bbox_mode"], BoxMode.XYXY_ABS)
    bbox = transforms.apply_box(np.array([bbox]))[0]
    bbox = np.minimum(bbox, list(image_size + image_size)[::-1])
    annotation["bbox"] = np.maximum(bbox, 0)
    annotation["bbox_mode"] = BoxMode.XYXY_ABS
    if "segmentation" in annotation:
        segm = annotation["segmentation"]
        if isinstance(segm, list):
            annotation["segmentation"] = [
                p.reshape(-1) for p in transforms.apply_polygons([np.asarray(p).reshape(-1) for p in segm])
            ]
        elif isinstance(segm, dict):
            mask = decode_segmentation(segm, *segm["size"])
            annotation["segmentation"] = transforms.apply_segmentation(mask.astype(np.uint8)).astype(bool)
        else:
            raise ValueError(f"Unsupported segmentation type {type(segm)}")
    if "keypoints" in annotation:
        annotation["keypoints"] = transform_keypoint_annotations(
            annotation["keypoints"], transforms, image_size, keypoint_hflip_indices
        )
    return annotation


def transform_keypoint_annotations(keypoints, transforms, image_size: Tuple[int, int],
                                   keypoint_hflip_indices: Optional[np.ndarray] = None) -> np.ndarray:
    """Flat (x, y, v, ...) keypoints through ``transforms``: (K, 3) float64,
    reordered by ``keypoint_hflip_indices`` when the transforms flip left to
    right an odd number of times, a point outside the image of
    ``image_size`` (h, w) made invisible, and every invisible point zeroed
    (JAX package ``detection_utils.py:169-194``)."""
    keypoints = np.asarray(keypoints, dtype="float64").reshape(-1, 3)
    xy = transforms.apply_coords(keypoints[:, :2])
    parts = transforms.transforms if isinstance(transforms, T.TransformList) else [transforms]
    do_hflip = sum(isinstance(t, T.HFlipTransform) for t in parts) % 2 == 1
    keypoints[:, :2] = xy
    if do_hflip and keypoint_hflip_indices is not None:
        keypoints = keypoints[np.asarray(keypoint_hflip_indices, dtype=np.int32), :]
    inside = ((xy >= np.array([0, 0])) & (xy <= np.array(image_size[::-1]))).all(axis=1)
    keypoints[:, 2][~inside] = 0
    keypoints[keypoints[:, 2] == 0] = 0
    return keypoints


def create_keypoint_hflip_indices(dataset_names) -> np.ndarray:
    """For each keypoint of the first dataset's ``keypoint_names``, the index
    of its mirror image under the metadata's ``keypoint_flip_map`` (itself
    where it has none; reference detection_utils.py:494)."""
    if isinstance(dataset_names, str):
        dataset_names = [dataset_names]
    meta = MetadataCatalog.get(dataset_names[0])
    names = list(meta.keypoint_names)
    flip_map = dict(meta.keypoint_flip_map)
    flip_map.update({v: k for k, v in flip_map.items()})
    return np.asarray([names.index(flip_map.get(n, n)) for n in names])


def annotations_to_instances(annos: List[dict], image_size: Tuple[int, int],
                             mask_format: str = "polygon") -> Instances:
    """Transformed annotations as ``Instances`` of numpy fields (reference
    detection_utils.py:366): ``gt_boxes`` (N, 4) float32 XYXY,
    ``gt_classes`` (N,) int64 and, where the annotations have a
    segmentation, ``gt_masks``: ``PolygonMasks`` in the "polygon" format
    (every segmentation must be polygons there, as in detectron2), else
    (N, h, w) bool masks; where they have keypoints, ``gt_keypoints``
    (N, K, 3) float32."""
    boxes = (np.stack([BoxMode.convert(o["bbox"], o["bbox_mode"], BoxMode.XYXY_ABS) for o in annos]).astype(np.float32)
             if annos else np.zeros((0, 4), np.float32))
    target = Instances(image_size)
    target.gt_boxes = boxes
    target.gt_classes = np.asarray([int(o["category_id"]) for o in annos], dtype=np.int64)
    if annos and "segmentation" in annos[0]:
        segms = [o["segmentation"] for o in annos]
        if mask_format == "polygon":
            if not all(isinstance(s, list) for s in segms):
                raise ValueError("an RLE or bitmask segmentation needs INPUT.MASK_FORMAT 'bitmask'")
            target.gt_masks = PolygonMasks([[np.asarray(p) for p in s] for s in segms])
        else:
            masks = []
            for segm in segms:
                if isinstance(segm, list):
                    masks.append(polygons_to_bitmask([np.asarray(p) for p in segm], *image_size))
                elif isinstance(segm, dict):
                    masks.append(decode_segmentation(segm, *image_size))
                else:
                    masks.append(np.asarray(segm).astype(bool))
            target.gt_masks = np.stack(masks)
    if annos and "keypoints" in annos[0]:
        target.gt_keypoints = np.stack(
            [np.asarray(o.get("keypoints", np.zeros(0))).reshape(-1, 3) for o in annos]
        ).astype(np.float32)
    return target


def filter_empty_instances(instances: Instances, by_box: bool = True, by_mask: bool = True,
                           box_threshold: float = 1e-5) -> Instances:
    """The instances whose box is wider and taller than ``box_threshold``
    and whose mask is not empty (reference detection_utils.py:460)."""
    keep = []
    if by_box:
        b = instances.gt_boxes
        keep.append(((b[:, 2] - b[:, 0]) > box_threshold) & ((b[:, 3] - b[:, 1]) > box_threshold))
    if instances.has("gt_masks") and by_mask:
        gm = instances.gt_masks
        keep.append(gm.nonempty() if isinstance(gm, PolygonMasks) else gm.reshape(len(gm), -1).any(axis=1))
    if not keep:
        return instances
    m = keep[0]
    for x in keep[1:]:
        m = m & x
    return instances[np.asarray(m)]


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


def instances_to_static_targets(instances: Instances, max_instances: int,
                                mask_crop_size: int = 0) -> Dict[str, np.ndarray]:
    """The first ``max_instances`` instances in fixed slots: ``gt_boxes``
    (G, 4) float32, ``gt_classes`` (G,) int32, ``gt_valid`` (G,) bool and,
    with ``mask_crop_size``, ``gt_mask_crops`` (G, M, M) bool, each mask
    cut to its box (polygons rasterised in the box, bit masks sampled at
    the cells' centres), zero where an instance has no mask; where the
    instances have keypoints, ``gt_keypoints`` (G, K, 3) float32, zero in
    the padding."""
    n = min(len(instances), max_instances)
    g = max_instances
    out = {
        "gt_boxes": np.zeros((g, 4), np.float32),
        "gt_classes": np.zeros((g,), np.int32),
        "gt_valid": np.zeros((g,), bool),
    }
    boxes = np.asarray(instances.gt_boxes)[:n]
    out["gt_boxes"][:n] = boxes
    out["gt_classes"][:n] = np.asarray(instances.gt_classes)[:n]
    out["gt_valid"][:n] = True
    if mask_crop_size > 0:
        out["gt_mask_crops"] = np.zeros((g, mask_crop_size, mask_crop_size), bool)
        if instances.has("gt_masks"):
            gm = instances.gt_masks
            for i in range(n):
                if isinstance(gm, PolygonMasks):
                    out["gt_mask_crops"][i] = rasterize_polygons_within_box(gm.polygons[i], boxes[i], mask_crop_size)
                else:
                    out["gt_mask_crops"][i] = _crop_bitmask(gm[i], boxes[i], mask_crop_size)
    if instances.has("gt_keypoints"):
        k = np.asarray(instances.gt_keypoints)
        out["gt_keypoints"] = np.zeros((g, k.shape[1] if k.ndim == 3 else 17, 3), np.float32)
        out["gt_keypoints"][:n] = k[:n]
    return out


def _crop_bitmask(mask: np.ndarray, box: np.ndarray, size: int) -> np.ndarray:
    """The mask sampled at the centres of ``size`` x ``size`` cells over
    ``box`` (nearest pixel, clamped to the mask)."""
    h, w = mask.shape
    x0, y0, x1, y1 = box
    xs = np.clip(np.linspace(x0, x1, size, endpoint=False) + (x1 - x0) / (2 * size), 0, w - 1).astype(int)
    ys = np.clip(np.linspace(y0, y1, size, endpoint=False) + (y1 - y0) / (2 * size), 0, h - 1).astype(int)
    return mask[ys[:, None], xs[None, :]]


def build_static_batch(per_image: List[dict], buckets: Sequence[Sequence[int]], proposal_topk: int = 0,
                       max_instances: int = 0, mask_crop_size: int = 0) -> Dict[str, np.ndarray]:
    """Mapped per-image dicts (HWC float32 images) collated into one padded
    batch in the schema the models take: ``image`` (B, H, W, 3) in the
    smallest bucket that fits them all, zero padded, the true
    ``image_sizes`` and the ``orig_sizes`` to map boxes back to (JAX
    package ``detection_utils.py:476``). With ``proposal_topk``,
    ``proposals`` (B, K, 4) and ``proposal_scores`` (B, K), -inf in unused
    slots; where any dict has a resized ``sem_seg``, ``gt_sem_seg`` (B, H,
    W) int32 with 255 outside each image. With ``max_instances``, the
    dicts' ``instances`` in ``instances_to_static_targets``'s slots
    (``gt_boxes``, ``gt_classes``, ``gt_valid``, ``gt_mask_crops``,
    ``gt_keypoints``), zero for a dict without them. A batch that no bucket holds raises a
    ValueError (the JAX package pads into the largest bucket and fails in
    numpy's broadcast)."""
    b = len(per_image)
    h_max = max(d["image"].shape[0] for d in per_image)
    w_max = max(d["image"].shape[1] for d in per_image)
    bh, bw = pick_bucket(h_max, w_max, buckets)
    if h_max > bh or w_max > bw:
        raise ValueError(f"no bucket of TPU.IMAGE_BUCKETS {[list(x) for x in buckets]} holds an image of "
                         f"{h_max}x{w_max}: add a bucket that does")
    batch = {
        "image": np.zeros((b, bh, bw, 3), np.float32),
        "image_sizes": np.zeros((b, 2), np.int32),
        "orig_sizes": np.zeros((b, 2), np.int32),
    }
    targets: List[Optional[dict]] = [None] * b
    if max_instances > 0:
        for i, d in enumerate(per_image):
            if "instances" in d:
                targets[i] = instances_to_static_targets(d["instances"], max_instances, mask_crop_size)
                for k, v in targets[i].items():
                    batch.setdefault(k, np.zeros((b,) + v.shape, v.dtype))
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
        if targets[i] is not None:
            for k, v in targets[i].items():
                batch[k][i] = v
        if proposal_topk > 0 and "proposals" in d:
            p = d["proposals"]
            n = min(len(p["boxes"]), proposal_topk)
            batch["proposals"][i, :n] = p["boxes"][:n]
            batch["proposal_scores"][i, :n] = p["objectness_logits"][:n]
    return batch
