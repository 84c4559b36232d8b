"""RetinaNet (reference: detectron2/modeling/meta_arch/retinanet.py:40, :505
``RetinaNetHead``, :449 ``inference_single_image``; JAX package
``modeling/meta_arch/retinanet.py:29,103,195,234``).

The head's two towers are detectron2's ``cls_subnet`` and ``bbox_subnet``
(convolutions at 0, 2, 4, ... with ReLUs between), then ``cls_score`` and
``bbox_pred``; they compute in ``TPU.COMPUTE_DTYPE`` and hand float32 maps
on. Decoding follows the JAX package's fixed-capacity form:

* each level's (B, A*K, H, W) logits are flattened in (H, W, A, K) order
  (detectron2's ``permute_to_N_HWA_K``, the JAX package's NHWC reshape), so
  a flat index ``i`` is anchor ``i // K`` and class ``i % K``;
* per level, the ``TOPK_CANDIDATES_TEST`` largest sigmoid scores by a stable
  sort (ties keep the lower index, as ``lax.top_k``), their boxes decoded
  from the anchors, scores not above ``SCORE_THRESH_TEST`` set to -inf;
* the levels' candidates concatenated and cut to the ``NMS_CANDIDATES_TEST``
  (1024) best, a cap the JAX package adds for its NMS matrix (the reference
  has none; ROADMAP §3); class-aware NMS on the unclipped boxes;
* the ``DETECTIONS_PER_IMAGE`` best survivors, then ``detector_postprocess``
  (the clip to the original image happens only there).

In training (``model.train()``) the loss dict ``loss_cls`` and
``loss_box_reg`` (``retinanet_losses``): each image's anchors matched to its
padded ground truth by MODEL.RETINANET.IOU_THRESHOLDS and IOU_LABELS with
the low-quality matches, the focal loss over the anchors that are not
ignored, smooth-L1 at SMOOTH_L1_LOSS_BETA over the positives, both over the
batch's positive count. The JAX package takes that count as it is; the
reference keeps a moving average of it (ROADMAP §3). No draws: the
generator is not read.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...layers import Conv2d, compute_dtype, exact_float32, get_norm, normal
from ...ops.box_regression import Box2BoxTransform
from ...ops.losses import sigmoid_focal_loss, smooth_l1_loss
from ...ops.matcher import Matcher
from ...ops.nms import batched_nms_mask
from ...structures.boxes import pairwise_iou
from ..anchor_generator import build_anchor_generator
from ..postprocessing import detector_postprocess_batched
from ..proposal_generator.proposal_utils import topk_stable
from .rcnn import BackboneModel, serving

NMS_CANDIDATES_TEST = 1024  # the JAX package's cap (retinanet.py:113; the reference: none)


class RetinaNetHead(nn.Module):
    """Shared classification and box towers over every level: (B, C, H, W)
    maps -> per level (B, A*K, H, W) class logits and (B, A*4, H, W) box
    deltas, float32."""

    def __init__(self, in_channels: int, num_classes: int, num_anchors: int, num_convs: int = 4,
                 prior_prob: float = 0.01, norm: str = "", compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        for name in ("cls_subnet", "bbox_subnet"):
            layers = []
            for _ in range(num_convs):
                layers += [
                    Conv2d(in_channels, in_channels, kernel_size=3, padding=1, bias=not norm,
                           norm=get_norm(norm, in_channels), compute_dtype=compute_dtype, kernel_init=normal(0.01)),
                    nn.ReLU(),
                ]
            self.add_module(name, nn.Sequential(*layers))
        self.cls_score = Conv2d(in_channels, num_anchors * num_classes, kernel_size=3, padding=1,
                                compute_dtype=compute_dtype, kernel_init=normal(0.01))
        self.bbox_pred = Conv2d(in_channels, num_anchors * 4, kernel_size=3, padding=1,
                                compute_dtype=compute_dtype, kernel_init=normal(0.01))
        with torch.no_grad():  # the focal-loss prior: sigmoid(bias) = prior_prob
            self.cls_score.bias.fill_(-math.log((1 - prior_prob) / prior_prob))

    def forward(self, features: List[torch.Tensor]):
        logits = [self.cls_score(self.cls_subnet(f)).float() for f in features]
        deltas = [self.bbox_pred(self.bbox_subnet(f)).float() for f in features]
        return logits, deltas


def retinanet_inference(
    anchors: List[torch.Tensor],  # per level (Hi*Wi*A, 4)
    logits: List[torch.Tensor],  # per level (B, A*K, Hi, Wi) float32
    deltas: List[torch.Tensor],  # per level (B, A*4, Hi, Wi) float32
    box2box_transform: Box2BoxTransform,
    num_classes: int,
    topk_candidates: int,
    score_thresh: float,
    nms_thresh: float,
    detections_per_image: int,
    nms_candidates: int = NMS_CANDIDATES_TEST,
) -> Dict[str, torch.Tensor]:
    """Fixed (B, D) detections in network-input coordinates, unclipped:
    ``boxes``, ``scores`` (0 where invalid), ``classes`` and ``valid``, D =
    min(DETECTIONS_PER_IMAGE, candidates). Decoding as the module
    docstring sets it out."""
    b, k = logits[0].shape[0], num_classes
    cand_boxes, cand_scores, cand_classes = [], [], []
    for anc, lg, dl in zip(anchors, logits, deltas):
        probs = torch.sigmoid(lg.permute(0, 2, 3, 1).reshape(b, -1))  # (B, H*W*A*K)
        dl = dl.permute(0, 2, 3, 1).reshape(b, -1, 4)  # (B, H*W*A, 4)
        topv, topi = topk_stable(probs, min(topk_candidates, probs.shape[1]))
        anchor_idx = torch.div(topi, k, rounding_mode="floor")
        sel = torch.gather(dl, 1, anchor_idx[..., None].expand(-1, -1, 4))
        cand_boxes.append(box2box_transform.apply_deltas(sel, anc[anchor_idx]))
        cand_scores.append(torch.where(topv > score_thresh, topv, torch.full_like(topv, float("-inf"))))
        cand_classes.append((topi % k).to(torch.int32))
    boxes, scores, classes = (torch.cat(c, dim=1) for c in (cand_boxes, cand_scores, cand_classes))
    top_scores, idx = topk_stable(scores, min(nms_candidates, scores.shape[1]))
    boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    classes = torch.gather(classes, 1, idx)
    keep = batched_nms_mask(boxes, top_scores, classes, nms_thresh)
    final = torch.where(keep, top_scores, torch.full_like(top_scores, float("-inf")))
    out_scores, oi = topk_stable(final, min(detections_per_image, final.shape[1]))
    valid = torch.isfinite(out_scores)
    return {
        "boxes": torch.gather(boxes, 1, oi[..., None].expand(-1, -1, 4)),
        "scores": torch.where(valid, out_scores, torch.zeros_like(out_scores)),
        "classes": torch.gather(classes, 1, oi),
        "valid": valid,
    }


def retinanet_losses(
    anchors: torch.Tensor,  # (N, 4), every level's
    logits: torch.Tensor,  # (B, N, K) float32
    deltas: torch.Tensor,  # (B, N, 4) float32
    gt_boxes: torch.Tensor,  # (B, G, 4)
    gt_classes: torch.Tensor,  # (B, G)
    gt_valid: torch.Tensor,  # (B, G)
    matcher: Matcher,
    box2box_transform: Box2BoxTransform,
    focal_alpha: float,
    focal_gamma: float,
    smooth_l1_beta: float,
) -> Dict[str, torch.Tensor]:
    """``loss_cls`` and ``loss_box_reg`` (JAX package ``retinanet.py:
    195-232``): the focal loss of every anchor the matcher does not ignore
    against its one-hot class (none for background), smooth-L1 of the
    positives' deltas, each summed over the batch and divided by the
    batch's positive count (at least 1)."""
    b, n, k = logits.shape
    gt_boxes = gt_boxes.to(torch.float32)
    matched_idx, match_labels = matcher(pairwise_iou(gt_boxes, anchors), gt_valid=gt_valid.bool())
    fg = match_labels == 1
    valid = match_labels != -1
    classes = torch.where(fg, torch.gather(gt_classes.long(), 1, matched_idx), torch.full_like(matched_idx, k))
    targets = F.one_hot(classes, k + 1)[..., :k].to(torch.float32)
    cls_loss = (sigmoid_focal_loss(logits, targets, focal_alpha, focal_gamma).sum(-1) * valid).sum()
    matched_gt = torch.gather(gt_boxes, 1, matched_idx[..., None].expand(b, n, 4))
    target_deltas = box2box_transform.get_deltas(anchors, matched_gt)
    reg_loss = (smooth_l1_loss(deltas, target_deltas, smooth_l1_beta).sum(-1) * fg).sum()
    normalizer = fg.sum().to(torch.float32).clamp(min=1.0)
    return {"loss_cls": cls_loss / normalizer, "loss_box_reg": reg_loss / normalizer}


class RetinaNet(BackboneModel):
    """Single-stage detector (JAX package ``retinanet.py:103``): in eval
    mode the detection dict of ``GeneralizedRCNN`` without masks, in train
    mode ``retinanet_losses`` of the batch's ``gt_*`` fields."""

    def __init__(self, cfg):
        super().__init__(cfg)
        r = cfg.MODEL.RETINANET
        self.in_features = tuple(r.IN_FEATURES)
        shapes = [self.backbone.output_shape()[f] for f in self.in_features]
        self.anchor_generator = build_anchor_generator(cfg, shapes)
        num_anchors = self.anchor_generator.num_anchors
        if len(set(num_anchors)) != 1:
            raise ValueError("all levels must share one anchor count")
        self.head = RetinaNetHead(shapes[0].channels, r.NUM_CLASSES, num_anchors[0], r.NUM_CONVS, r.PRIOR_PROB,
                                  r.NORM, compute_dtype(cfg))
        self.box2box_transform = Box2BoxTransform(weights=r.BBOX_REG_WEIGHTS)
        self.anchor_matcher = Matcher(r.IOU_THRESHOLDS, r.IOU_LABELS, allow_low_quality_matches=True)
        self.focal_loss_alpha = r.FOCAL_LOSS_ALPHA
        self.focal_loss_gamma = r.FOCAL_LOSS_GAMMA
        self.smooth_l1_beta = r.SMOOTH_L1_LOSS_BETA
        self.num_classes = r.NUM_CLASSES
        self.topk_candidates = r.TOPK_CANDIDATES_TEST
        self.score_thresh = r.SCORE_THRESH_TEST
        self.nms_thresh = r.NMS_THRESH_TEST
        self.detections_per_image = cfg.TEST.DETECTIONS_PER_IMAGE

    def head_outputs(self, features: Dict[str, torch.Tensor]):
        """The head's per-level logits and deltas, and the anchors."""
        feats = [features[f] for f in self.in_features]
        logits, deltas = self.head(feats)
        anchors = self.anchor_generator([tuple(f.shape[-2:]) for f in feats], feats[0].device)
        return anchors, logits, deltas

    def decode(self, anchors, logits, deltas) -> Dict[str, torch.Tensor]:
        return retinanet_inference(
            anchors, logits, deltas, self.box2box_transform, self.num_classes, self.topk_candidates,
            self.score_thresh, self.nms_thresh, self.detections_per_image,
        )

    @serving
    def inference(self, batch: Dict) -> Dict[str, torch.Tensor]:
        with exact_float32(self.compute_dtype == torch.float32):
            features, image_sizes = self._features(batch)
            detections = self.decode(*self.head_outputs(features))
            return detector_postprocess_batched(detections, image_sizes, self.orig_sizes(batch, image_sizes))

    def losses(self, anchors, logits, deltas, batch) -> Dict[str, torch.Tensor]:
        """``retinanet_losses`` of the head's per-level outputs, flattened
        in (H, W, A) order as the anchors are."""
        b, k, dev = logits[0].shape[0], self.num_classes, self.device
        return retinanet_losses(
            torch.cat(anchors),
            torch.cat([lg.permute(0, 2, 3, 1).reshape(b, -1, k) for lg in logits], dim=1),
            torch.cat([dl.permute(0, 2, 3, 1).reshape(b, -1, 4) for dl in deltas], dim=1),
            *(torch.as_tensor(batch[f], device=dev) for f in ("gt_boxes", "gt_classes", "gt_valid")),
            self.anchor_matcher, self.box2box_transform, self.focal_loss_alpha, self.focal_loss_gamma,
            self.smooth_l1_beta,
        )

    def forward(self, batch: Dict, generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """The loss dict in train mode (``generator`` unused), else
        :meth:`inference`."""
        if not self.training:
            return self.inference(batch)
        features, _ = self._features(batch)
        return self.losses(*self.head_outputs(features), batch)
