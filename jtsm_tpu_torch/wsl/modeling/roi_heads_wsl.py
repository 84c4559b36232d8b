"""WSOD ROI heads and their pieces (reference:
projects/WSL/wsl/modeling/roi_heads/roi_heads.py:146, roi_heads_jtsm.py:166,
box_head.py:106, roi_heads_wsddn.py, roi_heads_oicr.py and
fast_rcnn_oicr.py:712-786; JAX package ``wsl/modeling/roi_heads_wsl.py``
:50 ``image_level_gt``, :56 ``image_level_gt_stuff``, :68
``DiscriminativeAdaptionNeck``, :108 ``wsl_inference_single``, :164
``WSDDNROIHeads``, :201 ``_apply_gam``, :275 ``OICRROIHeads`` with
``WSL.SAMPLING`` :291-332 and :423-475 and the cascade :499-536, :574
``CascadeOICRROIHeads``).

``WSDDNROIHeads`` and ``OICRROIHeads`` (and PCL's, ``wsod_zoo.py``) pool
the precomputed proposals on their one input map by ROIAlignV2 at
POOLER_SAMPLING_RATIO, whatever POOLER_TYPE says, as the JAX heads do: K1
on the card, and K2 under it where the map trains. Under WSL.HAS_GAM the
guided attention module rescales that map first (``attend``), so K1 reads
the attended map, and K2 runs wherever ``conv6`` trains. Then the DAN, the
MIL layers (``cls`` and ``det``) and their WSDDN scores; OICR adds its
refinement branches, and the cascade pools its mined boxes through K1 as
well. Called as ``heads(features, proposals, proposal_scores,
image_sizes)`` they return the detections of ``wsl_inference`` and each
proposal's class scores (``proposal_class_scores``, which TTA-AVG
averages); with ``targets`` (``gt_classes``, ``gt_valid``) and
``train=True``, the loss dict. Each stage is a method of its own
(``attend``, ``pool`` or ``pool_proposals``, ``dan``, ``predict``,
``detect``, ``losses``), so that it can be timed."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...layers import Linear, ShapeSpec, compute_dtype, normal
from ...modeling.poolers import ROIPooler
from ...modeling.proposal_generator.proposal_utils import topk_stable
from ...ops.box_regression import Box2BoxTransform
from ...ops.nms import batched_nms_mask
from ...structures.boxes import clip_boxes, nonempty_boxes
from .mil_heads import (
    GAMLayer,
    MILOutputLayers,
    OICROutputLayers,
    branch_average,
    gam_image_loss,
    get_pgt_mist,
    mil_image_loss,
    oicr_branch_loss,
    oicr_refine_losses,
    wsddn_scores,
)


def image_level_gt(gt_classes: torch.Tensor, gt_valid: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(B, G) classes and validity -> (B, C) float multi-hot image labels."""
    oh = F.one_hot(gt_classes.long().clamp(0, num_classes - 1), num_classes).float()
    return (oh * gt_valid[..., None].float()).sum(dim=1).clamp(0, 1)


def image_level_gt_stuff(gt_sem_seg: torch.Tensor, num_stuff: int, ignore_value: int = 255) -> torch.Tensor:
    """(B, H, W) stuff labels -> (B, num_stuff) float presence of each class
    (pixels of ``ignore_value`` or outside [0, num_stuff) count for none)."""
    b = gt_sem_seg.shape[0]
    s = gt_sem_seg.reshape(b, -1).long()
    ok = (s != ignore_value) & (s >= 0) & (s < num_stuff)
    present = torch.zeros((b, num_stuff + 1), dtype=torch.float32, device=gt_sem_seg.device)
    present.scatter_(1, torch.where(ok, s, torch.full_like(s, num_stuff)), 1.0)
    return present[:, :num_stuff]


class DiscriminativeAdaptionNeck(nn.Module):
    """The DAN: fully connected layers ``dan1``, ``dan2``, ... with ReLU and
    dropout over the pooled features flattened as detectron2 flattens them,
    (C, P, P); the converter turns the JAX package's (P, P, C) rows of
    ``dan1`` into that order. Dropout acts in train mode only, as flax's
    does: each unit is kept where a uniform draw from ``generator`` (None:
    PyTorch's default generator) is below 1 - p, and kept units are scaled
    by 1 / (1 - p)."""

    def __init__(self, input_size: int, dims: Sequence[int] = (4096, 4096), dropout: float = 0.5,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fcs = []
        for i, d in enumerate(dims):
            fc = Linear(input_size, d, compute_dtype=compute_dtype, kernel_init=normal(0.005))
            self.add_module(f"dan{i + 1}", fc)
            self.fcs.append(fc)
            input_size = d
        self.dropout = dropout
        self.output_size = input_size

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (R, P, P, C) pooled features, or (R, D)."""
        if x.dim() > 2:
            x = x.permute(0, 3, 1, 2).flatten(1)
        keep = 1.0 - self.dropout
        for fc in self.fcs:
            x = F.relu(fc(x))
            if self.training and self.dropout > 0:
                kept = torch.rand(x.shape, generator=generator, device=x.device) < keep
                x = torch.where(kept, x / keep, torch.zeros_like(x))
        return x


def wsl_inference(
    boxes: torch.Tensor,  # (B, R, 4) proposals, or (B, R, C, 4) per-class boxes
    scores: torch.Tensor,  # (B, R, C) class probabilities
    valid: torch.Tensor,  # (B, R)
    image_sizes: torch.Tensor,  # (B, 2)
    score_thresh: float,
    nms_thresh: float,
    topk_per_image: int,
    nms_candidates: int = 1024,
) -> Dict[str, torch.Tensor]:
    """Per image: clip, threshold the probabilities, take the top
    ``nms_candidates`` of the R x C grid, class-aware NMS, then the top
    ``topk_per_image``; ``prop_idx`` is each detection's source proposal.
    Ties keep the lower index (stable sorts, as ``lax.top_k``)."""
    b, r, c = scores.shape
    if boxes.dim() == 3:
        boxes = boxes[:, :, None, :].expand(b, r, c, 4)
    size = image_sizes.to(boxes.dtype)[:, None, None, :]
    flat_boxes = clip_boxes(boxes, size).reshape(b, -1, 4)
    flat_scores = scores.reshape(b, -1)
    keepable = (
        (scores > score_thresh).reshape(b, -1)
        & valid.repeat_interleave(c, dim=1)
        & nonempty_boxes(flat_boxes)
    )
    flat_scores = torch.where(keepable, flat_scores, torch.full_like(flat_scores, float("-inf")))
    cc = min(nms_candidates, flat_scores.shape[1])
    cand_scores, cand_idx = topk_stable(flat_scores, cc)
    cand_boxes = torch.gather(flat_boxes, 1, cand_idx[..., None].expand(b, cc, 4))
    cand_classes = (cand_idx % c).to(torch.int32)
    keep = batched_nms_mask(cand_boxes, cand_scores, cand_classes, nms_thresh)
    final = torch.where(keep, cand_scores, torch.full_like(cand_scores, float("-inf")))
    k = min(topk_per_image, cc)
    top_scores, top_i = topk_stable(final, k)
    out_valid = torch.isfinite(top_scores)
    out = {
        "boxes": torch.gather(cand_boxes, 1, top_i[..., None].expand(b, k, 4)),
        "scores": torch.where(out_valid, top_scores, torch.zeros_like(top_scores)),
        "classes": torch.gather(cand_classes, 1, top_i),
        "valid": out_valid,
        "prop_idx": (torch.gather(cand_idx, 1, top_i) // c).to(torch.int32),
    }
    if topk_per_image > k:
        pad = topk_per_image - k
        out = {key: torch.cat([v, v.new_zeros((b, pad) + v.shape[2:])], dim=1) for key, v in out.items()}
    return out


def wsl_inference_single(
    boxes: torch.Tensor,  # (R, 4) proposals, or (R, C, 4) per-class boxes
    scores: torch.Tensor,  # (R, C) class probabilities
    valid: torch.Tensor,  # (R,)
    image_size: torch.Tensor,  # (2,) (h, w)
    score_thresh: float,
    nms_thresh: float,
    topk_per_image: int,
    nms_candidates: int = 1024,
) -> Dict[str, torch.Tensor]:
    """:func:`wsl_inference` of one image (JAX package
    ``roi_heads_wsl.py:108``): (topk_per_image,) detections."""
    out = wsl_inference(boxes[None], scores[None], valid[None], torch.as_tensor(image_size)[None], score_thresh,
                        nms_thresh, topk_per_image, nms_candidates)
    return {k: v[0] for k, v in out.items()}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1 item 6)")


class WSDDNROIHeads(nn.Module):
    """The MIL-only head (reference roi_heads_wsddn.py; JAX :164): the
    image-level binary cross entropy of the summed WSDDN scores, as the
    mean over classes or, under WSL.MEAN_LOSS False, their sum. Under
    WSL.HAS_GAM, the guided attention module ``gam`` on the input map and
    its ``loss_gam`` (heads whose ``uses_gam`` is False ignore the key, as
    the JAX package's ContextLocNet and CMIL heads do)."""

    uses_gam = True

    def __init__(self, cfg, input_shape: Dict[str, ShapeSpec]):
        super().__init__()
        self.in_features = tuple(cfg.MODEL.ROI_HEADS.IN_FEATURES)
        if len(self.in_features) != 1:
            raise _not_ported(f"WSOD heads over several maps {self.in_features}")
        self.num_classes = cfg.MODEL.ROI_HEADS.NUM_CLASSES
        p = cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION
        self.pooler = ROIPooler(
            output_size=p,
            scales=tuple(1.0 / input_shape[f].stride for f in self.in_features),
            sampling_ratio=cfg.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO,
            pooler_type="ROIAlignV2",
        )
        dt = compute_dtype(cfg)
        channels = input_shape[self.in_features[0]].channels
        self.dan = DiscriminativeAdaptionNeck(channels * p * p, cfg.MODEL.ROI_BOX_HEAD.DAN_DIM, 0.5, dt)
        self.mil = MILOutputLayers(self.dan.output_size, self.num_classes, dt)
        self.gam = GAMLayer(channels, self.num_classes, dt) if cfg.WSL.HAS_GAM and self.uses_gam else None
        self.mean_loss = cfg.WSL.MEAN_LOSS
        self.score_thresh_test = cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST
        self.nms_thresh_test = cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST
        self.detections_per_image = cfg.TEST.DETECTIONS_PER_IMAGE

    def prepare_features(self, features: Dict[str, torch.Tensor], b: int) -> Dict[str, torch.Tensor]:
        """The maps the heads attend to and pool for ``b`` images: as they
        are here; the multi-rate heads average the branches that their
        backbone folds into the batch (JAX ``_prepare_features``, :213)."""
        return features

    def attend(self, features: Dict[str, torch.Tensor]):
        """The maps the heads pool and the (B, C) GAM logits: under
        WSL.HAS_GAM the input map rescaled by its attention, else the maps
        as they are and None."""
        if self.gam is None:
            return features, None
        f = self.in_features[0]
        attended, logits = self.gam(features[f])
        return {**features, f: attended}, logits

    def gam_loss(self, gam_logits: torch.Tensor, targets: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        img_labels = image_level_gt(targets["gt_classes"], targets["gt_valid"], self.num_classes)
        return {"loss_gam": gam_image_loss(gam_logits, img_labels)}

    def pool(self, features: Dict[str, torch.Tensor], proposals: torch.Tensor) -> torch.Tensor:
        """NCHW maps and (B, R, 4) proposals -> (B*R, P, P, C), one K1
        launch on the card."""
        b, r = proposals.shape[:2]
        batch_idx = torch.arange(b, dtype=torch.int32, device=proposals.device).repeat_interleave(r)
        return self.pooler([features[f] for f in self.in_features], proposals.reshape(b * r, 4), batch_idx)

    def pool_proposals(self, features: Dict[str, torch.Tensor], proposals: torch.Tensor,
                       proposal_scores: torch.Tensor) -> torch.Tensor:
        """What the DAN takes: ``pool`` of the proposals (WSJDS scales it
        by their objectness)."""
        return self.pool(features, proposals)

    def predict(self, x: torch.Tensor, proposal_scores: torch.Tensor):
        """(B*R, D) neck features -> the (B, R, C) WSDDN scores and the
        refinement branches' [(logits, deltas or None)] (none here)."""
        b, r = proposal_scores.shape
        cls_logit, det_logit = self.mil(x)
        mil = wsddn_scores(cls_logit.reshape(b, r, -1), det_logit.reshape(b, r, -1), torch.isfinite(proposal_scores))
        return mil, []

    def class_scores(self, mil, branches) -> torch.Tensor:
        """Each proposal's (B, R, C) class scores, as the detections carry
        them in ``proposal_class_scores``."""
        return mil

    def proposal_class_scores(self, features: Dict[str, torch.Tensor], proposals: torch.Tensor,
                              proposal_scores: torch.Tensor) -> torch.Tensor:
        """The (B, R, C) ``class_scores`` of the proposals, without the
        detections' decoding and NMS (the class-peak-gradient pass)."""
        features, _ = self.attend(self.prepare_features(features, proposals.shape[0]))
        x = self.dan(self.pool_proposals(features, proposals, proposal_scores))
        return self.class_scores(*self.predict(x, proposal_scores))

    def detect(self, proposals, proposal_scores, mil, branches, image_sizes) -> Dict[str, torch.Tensor]:
        """The detections of the WSDDN scores over the proposals."""
        det = wsl_inference(proposals, mil, torch.isfinite(proposal_scores), image_sizes, self.score_thresh_test,
                            self.nms_thresh_test, self.detections_per_image)
        det["proposal_class_scores"] = mil
        return det

    def losses(self, proposals, proposal_scores, mil, branches, targets, features=None,
               generator=None) -> Dict[str, torch.Tensor]:
        """The loss dict of the predictions; ``features`` (the maps the
        heads pooled) and ``generator`` serve the heads that pool or draw
        again in their losses (the cascade, the sampling)."""
        img_labels = image_level_gt(targets["gt_classes"], targets["gt_valid"], self.num_classes)
        return {"loss_mil": mil_image_loss(mil, img_labels, self.mean_loss).mean()}

    def forward(
        self,
        features: Dict[str, torch.Tensor],  # NCHW maps
        proposals: torch.Tensor,  # (B, R, 4)
        proposal_scores: torch.Tensor,  # (B, R), non-finite on padding
        image_sizes: torch.Tensor,  # (B, 2)
        targets: Optional[Dict[str, torch.Tensor]] = None,  # gt_classes, gt_valid
        train: bool = False,
        generator: Optional[torch.Generator] = None,  # the DAN's dropout draws, the sampling's
        **loss_args,
    ) -> Dict[str, torch.Tensor]:
        """Detections, or with ``train`` the loss dict (``loss_args`` go
        to ``losses``)."""
        features, gam_logits = self.attend(self.prepare_features(features, proposals.shape[0]))
        x = self.dan(self.pool_proposals(features, proposals, proposal_scores), generator)
        mil, branches = self.predict(x, proposal_scores)
        if not train:
            return self.detect(proposals, proposal_scores, mil, branches, image_sizes)
        losses = self.losses(proposals, proposal_scores, mil, branches, targets, features, generator, **loss_args)
        if gam_logits is not None:
            losses.update(self.gam_loss(gam_logits, targets))
        return losses


class OICRROIHeads(WSDDNROIHeads):
    """WSDDN's MIL and WSL.REFINE_NUM refinement branches (reference
    roi_heads_oicr.py, fast_rcnn_oicr.py; JAX :275): each a (C+1)-way
    classifier ``refine{k}.refine_score`` and, under WSL.REFINE_REG[k],
    class-specific deltas ``refine{k}.refine_reg``, trained by
    ``oicr_refine_losses`` (WSL.REFINE_MIST: MIST mining; WSL.SAMPLING:
    each branch's Matcher and proposal sampling); inference averages the
    branches (``branch_average``)."""

    def __init__(self, cfg, input_shape: Dict[str, ShapeSpec]):
        super().__init__(cfg, input_shape)
        w = cfg.WSL
        s = w.SAMPLING
        self.sampling = (
            [(tuple(s.IOU_THRESHOLDS[k]), tuple(s.IOU_LABELS[k]), int(s.BATCH_SIZE_PER_IMAGE[k]),
              float(s.POSITIVE_FRACTION[k])) for k in range(w.REFINE_NUM)]
            if s.SAMPLING_ON else None
        )
        self.refine_mist = w.REFINE_MIST
        self.box2box_transform = Box2BoxTransform(weights=cfg.MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS)
        refine_reg = tuple(w.REFINE_REG[: w.REFINE_NUM])
        self.refine: List[OICROutputLayers] = []
        for k in range(w.REFINE_NUM):
            branch = OICROutputLayers(
                self.dan.output_size, self.num_classes,
                with_reg=refine_reg[k] if k < len(refine_reg) else False,
                reg_classes=self.num_classes, compute_dtype=self.mil.cls.compute_dtype,
            )
            self.add_module(f"refine{k}", branch)
            self.refine.append(branch)

    def predict(self, x: torch.Tensor, proposal_scores: torch.Tensor):
        mil, _ = super().predict(x, proposal_scores)
        b, r = proposal_scores.shape
        branches: List[Tuple[torch.Tensor, Optional[torch.Tensor]]] = []
        for head in self.refine:
            logits, deltas = head(x)
            branches.append((logits.reshape(b, r, -1), None if deltas is None else deltas.reshape(b, r, -1)))
        return mil, branches

    def class_scores(self, mil, branches) -> torch.Tensor:
        avg = sum((torch.softmax(lg, dim=-1)[..., : self.num_classes] for lg, _ in branches), mil.new_zeros(mil.shape))
        return avg / max(len(branches), 1)

    def detect(self, proposals, proposal_scores, mil, branches, image_sizes) -> Dict[str, torch.Tensor]:
        avg, boxes = branch_average(proposals, branches, self.num_classes, self.box2box_transform)
        return super().detect(boxes, proposal_scores, avg, branches, image_sizes)

    def _mil_losses(self, mil, img_labels, proposals, valid, targets) -> Dict[str, torch.Tensor]:
        """The MIL image loss (CSC-OICR weighs it by CSC instead)."""
        return {"loss_mil": mil_image_loss(mil, img_labels, self.mean_loss).mean()}

    def losses(self, proposals, proposal_scores, mil, branches, targets, features=None,
               generator=None) -> Dict[str, torch.Tensor]:
        img_labels = image_level_gt(targets["gt_classes"], targets["gt_valid"], self.num_classes)
        losses = self._mil_losses(mil, img_labels, proposals, torch.isfinite(proposal_scores), targets)
        # the image probabilities weight the top-k miner's PGT
        # (reference roi_heads_oicr.py:752); they keep their gradient
        img_probs = mil.sum(dim=1).clamp(1e-6, 1.0 - 1e-6)
        refine, _, _ = oicr_refine_losses(
            proposals, torch.isfinite(proposal_scores), mil, branches, img_labels, img_probs,
            self.box2box_transform, self.refine_mist, self.sampling, generator,
        )
        losses.update(refine)
        return losses


class CascadeOICRROIHeads(OICRROIHeads):
    """Cascade OICR (reference roi_heads_all.py:2822 under WSL.CASCADE_ON;
    JAX :574, the loss :499-536): OICR, and for each branch k > 0 the boxes
    MIST-mined from branch k-1's detached softmax over the proposals (a
    fixed C x min(32, R) rows an image, ``get_pgt_mist``), pooled by K1
    from the maps the heads pooled, through the shared DAN (its dropout
    drawn after the proposals', branch by branch) and branch k's
    classifier, supervised as their mined class with the mining confidence
    as weight: ``loss_refine_cls{k}_cascade``, the mean over the images.
    Inference is OICR's."""

    def __init__(self, cfg, input_shape: Dict[str, ShapeSpec]):
        super().__init__(cfg, input_shape)
        self.cascade_on = cfg.WSL.CASCADE_ON

    def losses(self, proposals, proposal_scores, mil, branches, targets, features=None,
               generator=None) -> Dict[str, torch.Tensor]:
        losses = super().losses(proposals, proposal_scores, mil, branches, targets, features, generator)
        if not self.cascade_on:
            return losses
        b = proposals.shape[0]
        c = self.num_classes
        valid = torch.isfinite(proposal_scores)
        img_labels = image_level_gt(targets["gt_classes"], targets["gt_valid"], c)
        for k in range(1, len(branches)):
            source = torch.softmax(branches[k - 1][0].detach(), dim=-1)[..., :c]
            mined = get_pgt_mist(proposals, source, valid, img_labels)
            boxes = mined["boxes"].reshape(b, -1, 4)
            ok = mined["valid"].reshape(b, -1)
            logits, _ = self.refine[k](self.dan(self.pool(features, boxes), generator))
            labels = torch.where(ok, mined["classes"].reshape(b, -1), torch.full_like(ok, c, dtype=torch.long))
            weights = torch.where(ok, mined["weight"].reshape(b, -1), torch.zeros_like(mined["weight"].reshape(b, -1)))
            losses[f"loss_refine_cls{k}_cascade"] = oicr_branch_loss(
                logits.reshape(b, boxes.shape[1], -1), labels, weights).mean()
        return losses


def branch_mean(features: Dict[str, torch.Tensor], names: Sequence[str], b: int) -> Dict[str, torch.Tensor]:
    """``features`` with each map of ``names`` whose batch holds more than
    ``b`` images (a multi-rate backbone's branches, folded branch-major)
    replaced by its mean over the branches, in its dtype."""
    out = dict(features)
    for f in names:
        x = features[f]
        if x.shape[0] > b:
            out[f] = x.reshape(-1, b, *x.shape[1:]).mean(dim=0)
    return out


class MultiRateHeads:
    """What the WSOD heads over a multi-rate backbone add (JAX
    ``_prepare_features``, :609-622): under MODEL.MRRP.MRRP_ON the
    branches that the backbone folds into the batch are averaged before
    the heads attend and pool (K1 reads the mean map), one pooled row a
    proposal. Mixed in before a WSOD heads class."""

    def __init__(self, cfg, input_shape: Dict[str, ShapeSpec]):
        super().__init__(cfg, input_shape)
        self.mrrp_num_branch = cfg.MODEL.MRRP.NUM_BRANCH if cfg.MODEL.MRRP.MRRP_ON else 1

    def prepare_features(self, features: Dict[str, torch.Tensor], b: int) -> Dict[str, torch.Tensor]:
        return features if self.mrrp_num_branch <= 1 else branch_mean(features, self.in_features, b)


class MRRPOICRROIHeads(MultiRateHeads, OICRROIHeads):
    """OICR over a multi-rate backbone (reference roi_heads_all.py:4620;
    JAX :591)."""


class TridentOICRROIHeads(MRRPOICRROIHeads):
    """The name the trident yamls (``reg_all/oicr_TRD_*.yaml``) give
    ``MRRPOICRROIHeads`` (JAX :625)."""


class MRRPWSDDNROIHeads(MultiRateHeads, WSDDNROIHeads):
    """WSDDN over a multi-rate backbone (reference roi_heads_all.py:809;
    JAX :631). No yaml names it."""


from ...modeling.roi_heads.res5_roi_heads import Res5ROIHeads  # noqa: E402


class WSRes5ROIHeads(Res5ROIHeads):
    """The reference's name (wsl/modeling/roi_heads/roi_heads.py:410; JAX
    :654) for the fully supervised C4 second stage over the WS-ResNet,
    which ``faster_rcnn_WSR_50_C4_1x.yaml`` names: ``Res5ROIHeads``
    itself."""
