"""``PanopticFPN`` (reference: detectron2/modeling/meta_arch/panoptic_fpn.py:20;
JAX package ``modeling/meta_arch/panoptic_fpn.py:31``) and the panoptic
fusion at test time (reference ``panoptic_fpn.py:133``
``combine_semantic_and_instance_outputs``; JAX package
``modeling/meta_arch/panoptic_fpn.py:112,176,201``): each image's stuff
logits resized to its original size and argmaxed, its instance masks pasted
there, and the two painted into one panoptic id map.

The JAX package does all of it on the host in numpy float64. Here the
logits' resize and argmax and the masks' paste run in float64 on the
outputs' device, with the same products and sums in the same order (the
sample positions and weights are computed in numpy, as there, then
copied), so the maps equal numpy's; the painting runs on the host as there,
in the order ``np.argsort`` of the negated scores gives (its order among
equal scores included).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...layers import exact_float32
from ...ops.paste_masks import paste_masks
from ..postprocessing import detector_postprocess_batched
from .rcnn import GeneralizedRCNN, serving
from .semantic_seg import build_sem_seg_head, upsampled_sem_seg

CHUNK_BYTES = 32 * 2**20  # one (rows, W, C) float64 array of the resize at most


class PanopticFPN(GeneralizedRCNN):
    """Mask R-CNN and the sem-seg head on one FPN (JAX package
    ``panoptic_fpn.py:31-110``): the detection dict of ``GeneralizedRCNN``
    (boxes at the original scale, masks) with ``sem_seg`` (B, H, W) and
    ``sem_seg_logits`` (B, H, W, K) float32 at the padded input size;
    ``engine.defaults.test`` fuses them (``panoptic_fusion_postprocess``).
    In train mode (JAX ``panoptic_fpn.py:65-97``) the sem-seg head's
    ``loss_sem_seg``, then the ROI heads' losses times
    PANOPTIC_FPN.INSTANCE_LOSS_WEIGHT, then the RPN's, in that order;
    the draws are ``GeneralizedRCNN``'s."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.sem_seg_head = build_sem_seg_head(cfg, self.backbone.output_shape())
        self.instance_loss_weight = cfg.MODEL.PANOPTIC_FPN.INSTANCE_LOSS_WEIGHT

    @serving
    def inference(self, batch: Dict) -> Dict[str, Any]:
        with exact_float32(self.compute_dtype == torch.float32):
            features, image_sizes = self._features(batch)
            sem_logits = self.sem_seg_head(features)
            proposals, proposal_scores, _ = self.propose(batch, image_sizes, features)
            detections = self.roi_heads(features, proposals, proposal_scores, image_sizes)
            out = detector_postprocess_batched(detections, image_sizes, self.orig_sizes(batch, image_sizes))
            out.update(upsampled_sem_seg(sem_logits, batch["image"].shape[1:3]))
            return out

    def forward(self, batch: Dict, generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        if not self.training:
            return self.inference(batch)
        features, image_sizes = self._features(batch)
        targets = self.targets(batch)
        losses = self.sem_seg_head.losses(self.sem_seg_head(features), targets["gt_sem_seg"])
        rpn_losses, roi_losses = self.instance_losses(features, image_sizes, targets, generator,
                                                      self.batch_proposals(batch))
        losses.update({k: v * self.instance_loss_weight for k, v in roi_losses.items()})
        losses.update(rpn_losses)
        return losses


def combine_semantic_and_instance_outputs(
    instance_masks: np.ndarray,  # (D, H, W) bool
    instance_scores: np.ndarray,  # (D,)
    instance_classes: np.ndarray,  # (D,)
    instance_valid: np.ndarray,  # (D,)
    semantic_seg: np.ndarray,  # (H, W) int
    overlap_threshold: float = 0.5,
    stuff_area_limit: int = 4096,
    instances_confidence_threshold: float = 0.5,
) -> Tuple[np.ndarray, List[dict]]:
    """The panoptic id map (H, W) int32 and its segments: valid instances
    painted by descending score down to the confidence threshold, each
    skipped when more than ``overlap_threshold`` of it is already painted,
    then each stuff label but 0 ("things") on what is left, where at least
    ``stuff_area_limit`` pixels."""
    panoptic_seg = np.zeros_like(semantic_seg, dtype=np.int32)
    current_segment_id = 0
    segments_info: List[dict] = []
    for i in np.argsort(-instance_scores):
        if not instance_valid[i]:
            continue
        score = float(instance_scores[i])
        if score < instances_confidence_threshold:
            break
        mask = instance_masks[i]
        mask_area = int(mask.sum())
        if mask_area == 0:
            continue
        intersect_area = int((mask & (panoptic_seg > 0)).sum())
        if intersect_area * 1.0 / mask_area > overlap_threshold:
            continue
        if intersect_area > 0:
            mask = mask & (panoptic_seg == 0)
        current_segment_id += 1
        panoptic_seg[mask] = current_segment_id
        segments_info.append({"id": current_segment_id, "isthing": True, "score": score,
                              "category_id": int(instance_classes[i]), "instance_id": int(i),
                              "area": int(mask.sum())})
    for semantic_label in np.unique(semantic_seg):
        if semantic_label == 0:  # "things" in a separated sem-seg map
            continue
        mask = (semantic_seg == semantic_label) & (panoptic_seg == 0)
        mask_area = int(mask.sum())
        if mask_area < stuff_area_limit:
            continue
        current_segment_id += 1
        panoptic_seg[mask] = current_segment_id
        segments_info.append({"id": current_segment_id, "isthing": False, "category_id": int(semantic_label),
                              "area": mask_area})
    return panoptic_seg, segments_info


def _resize_taps(size: int, out_size: int):
    """Half-pixel-centre bilinear taps along one axis, in numpy float64 as
    the JAX package's ``_bilinear_resize_np`` computes them: the two
    neighbours (clamped) and the clamped fraction."""
    pos = (np.arange(out_size) + 0.5) * size / out_size - 0.5
    i0 = np.clip(np.floor(pos).astype(int), 0, size - 1)
    i1 = np.clip(i0 + 1, 0, size - 1)
    return i0, i1, np.clip(pos - i0, 0.0, 1.0)


def bilinear_resize(x: torch.Tensor, out_h: int, out_w: int, rows=None) -> torch.Tensor:
    """(H, W, C) -> (out_h, out_w, C) float64 on ``x``'s device, half-pixel
    centres (``jax.image.resize``, ``F.interpolate`` with align_corners
    False), equal to the JAX package's ``_bilinear_resize_np``. ``rows``
    (a slice) gives only those output rows."""
    h, w = x.shape[:2]
    y0, y1, fy = (a[rows] if rows is not None else a for a in _resize_taps(h, out_h))
    x0, x1, fx = _resize_taps(w, out_w)
    dev = x.device
    y0, y1, x0, x1 = (torch.as_tensor(a, device=dev) for a in (y0, y1, x0, x1))
    fy = torch.as_tensor(fy, device=dev)[:, None, None]
    fx = torch.as_tensor(fx, device=dev)[None, :, None]
    x = x.to(torch.float64)
    gy, gx = 1 - fy, 1 - fx
    out = x[y0[:, None], x0[None, :]] * gy * gx
    out = out + x[y0[:, None], x1[None, :]] * gy * fx
    out = out + x[y1[:, None], x0[None, :]] * fy * gx
    return out + x[y1[:, None], x1[None, :]] * fy * fx


def resized_argmax(logits: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """The argmax over classes (the first of equal maxima) of (H, W, C)
    logits resized by ``bilinear_resize``, (out_h, out_w) int32, in row
    chunks of at most ``CHUNK_BYTES`` per float64 array."""
    out = torch.empty((out_h, out_w), dtype=torch.int32, device=logits.device)
    step = max(1, CHUNK_BYTES // (8 * out_w * logits.shape[-1]))
    for r0 in range(0, out_h, step):
        rows = slice(r0, min(r0 + step, out_h))
        out[rows] = bilinear_resize(logits, out_h, out_w, rows).argmax(dim=-1).to(torch.int32)
    return out


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def panoptic_fusion_postprocess(
    outputs: Dict[str, Any],
    image_sizes: np.ndarray,  # (B, 2) network-input sizes before padding
    orig_sizes: np.ndarray,  # (B, 2) original image sizes
    overlap_threshold: float = 0.5,
    stuff_area_limit: int = 4096,
    instances_confidence_threshold: float = 0.5,
) -> Dict[str, Any]:
    """The batched outputs (boxes at the original scale, ``sem_seg_logits``
    (B, H, W, K) at the padded input size) with ``panoptic_seg``, a list of
    (id map (H0, W0) int32, segments), and ``sem_seg``, a list of (H0, W0)
    int32 argmax maps, one per image, on the host. Instance masks: the
    mask branch's probabilities pasted into their boxes, or under
    ``no_paste`` the image-size ``masks_full`` cropped and resized
    bilinearly, each at 0.5; a box-only model's boxes."""
    scores, classes = _numpy(outputs["scores"]).astype(np.float32), _numpy(outputs["classes"]).astype(np.int32)
    valid = _numpy(outputs["valid"]).astype(bool) if "valid" in outputs else np.ones(scores.shape, bool)
    boxes = outputs["boxes"]
    masks = outputs.get("masks")
    if masks is None and "masks_full" in outputs:
        masks = outputs["masks_full"]
    no_paste = _numpy(outputs["no_paste"]).astype(bool) if "no_paste" in outputs else None
    logits = outputs["sem_seg_logits"]
    if not torch.is_tensor(logits):
        logits = torch.as_tensor(np.asarray(logits, np.float32))
    panoptic, sem_maps = [], []
    for i in range(scores.shape[0]):
        h, w = int(image_sizes[i][0]), int(image_sizes[i][1])
        h0, w0 = int(orig_sizes[i][0]), int(orig_sizes[i][1])
        semantic = resized_argmax(logits[i][:h, :w].to(torch.float32), h0, w0).cpu().numpy()
        sem_maps.append(semantic)
        d = scores.shape[1]
        inst_masks = np.zeros((d, h0, w0), bool)
        if masks is not None:
            # the painting never reads a mask below the confidence threshold
            live = valid[i] & (scores[i] >= instances_confidence_threshold)
            flat = live & no_paste[i] if no_paste is not None else np.zeros(d, bool)
            pasted = np.nonzero(live & ~flat)[0]
            if len(pasted):
                m = masks[i] if torch.is_tensor(masks) else torch.as_tensor(np.asarray(masks[i], np.float32))
                sel = torch.as_tensor(pasted, device=m.device)
                b = boxes[i] if torch.is_tensor(boxes) else torch.as_tensor(np.asarray(boxes[i], np.float32))
                inst_masks[pasted] = paste_masks(m[sel], b.to(m.device)[sel], h0, w0).cpu().numpy()
            for j in np.nonzero(flat)[0]:
                src = outputs["masks_full"][i, j]
                src = src if torch.is_tensor(src) else torch.as_tensor(np.asarray(src))
                full = bilinear_resize(src[:h, :w, None].to(torch.float32), h0, w0)[..., 0]
                inst_masks[j] = (full >= 0.5).cpu().numpy()
        else:
            for j in np.nonzero(valid[i])[0]:  # a box-only model: the box as the mask
                x0, y0, x1, y1 = _numpy(boxes[i, j]).astype(np.float32)
                x0, y0 = max(int(x0), 0), max(int(y0), 0)
                x1, y1 = min(int(np.ceil(x1)), w0), min(int(np.ceil(y1)), h0)
                if x1 > x0 and y1 > y0:
                    inst_masks[j, y0:y1, x0:x1] = True
        panoptic.append(combine_semantic_and_instance_outputs(
            inst_masks, scores[i], classes[i], valid[i], semantic, overlap_threshold, stuff_area_limit,
            instances_confidence_threshold,
        ))
    out = dict(outputs)
    out["panoptic_seg"] = panoptic
    out["sem_seg"] = sem_maps
    return out
