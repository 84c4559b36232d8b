"""GeneralizedMCNNWSL, the JTSM meta-architecture, and GeneralizedRCNNWSL,
the WSOD baselines' (at the end of this module). JTSM (reference:
projects/WSL/wsl/modeling/meta_arch/mcnn.py:25; JAX package
``wsl/modeling/meta_arch.py:114``, train branch :158-208, inference
:137-223).

Request: the ``GeneralizedRCNN`` batch dict plus ``proposals`` (B, R, 4)
and ``proposal_scores`` (B, R) (padding non-finite), and for MOIPool
``superpixels`` (B, H, W) int ids and ``oh_labels`` (B, R, S) bool
(``wsl.data.add_wsl_batch_fields``). Answer: the detections of
``JTSMROIHeads`` mapped to ``orig_sizes`` (``boxes``, ``scores``,
``classes``, ``valid``, ``prop_idx``, ``proposal_class_scores`` and
``masks``, or ``masks_full`` and ``no_paste`` under ``WSL.TEST_NO_PASTE``),
``sem_seg`` (B, H, W) int32, the stuff map's argmax, and its logits
``sem_seg_logits`` (B, H, W, K) upsampled bilinearly to the padded image. With
``detected_boxes`` (and ``detected_classes``) in the request, only the mask
branch runs on those boxes.

Training (``model.train()``, then ``model(batch, generator=g)``): the
request's fields plus the image-level targets ``gt_classes`` and
``gt_valid`` (B, G) (``gt_boxes`` is accepted and unused) and, for the
stuff labels under ``WSL.PS_ON``, ``gt_sem_seg`` (B, H, W) with 255 for
ignored pixels (``wsl.data.add_wsl_train_fields``). It returns the loss
dict of ``JTSMROIHeads`` and, for a stuff head with a loss, its
``loss_sem_seg`` against the pseudo sem-seg map the heads painted at the
head's stride. ``generator`` (on the model's device; None is PyTorch's
default generator) draws the DAN's dropout.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ...layers import exact_float32
from ...modeling.meta_arch.rcnn import BackboneModel, GeneralizedRCNN, serving
from ...modeling.meta_arch.semantic_seg import build_sem_seg_head, upsampled_sem_seg
from ...modeling.postprocessing import detector_postprocess_batched
from .roi_heads_jtsm import JTSMROIHeads


class GeneralizedMCNNWSL(BackboneModel):
    def __init__(self, cfg):
        if cfg.MODEL.ROI_HEADS.NAME != "JTSMROIHeads":
            raise NotImplementedError(f"ROI heads {cfg.MODEL.ROI_HEADS.NAME!r} are not ported yet")
        super().__init__(cfg)
        shapes = self.backbone.output_shape()
        self.sem_seg_head = build_sem_seg_head(cfg, shapes)
        self.roi_heads = JTSMROIHeads(cfg, shapes, mine_sem_seg=self.sem_seg_head.has_loss)

    given_detections = GeneralizedRCNN.given_detections

    @serving
    def inference(self, batch: Dict) -> Dict[str, torch.Tensor]:
        with exact_float32(self.compute_dtype == torch.float32):
            features, image_sizes = self._features(batch)
            if "detected_boxes" in batch:
                return self.roi_heads.forward_with_given_boxes(features, self.given_detections(batch))

            proposals, scores, superpixels, oh_labels = self.request_fields(batch)
            det = self.roi_heads(features, proposals, scores, image_sizes, superpixels, oh_labels)
            det = detector_postprocess_batched(det, image_sizes, self.orig_sizes(batch, image_sizes))
            det.update(upsampled_sem_seg(self.sem_seg_head(features), batch["image"].shape[1:3]))
            return det

    def request_fields(self, batch: Dict):
        """The proposals, their scores, the superpixels and their membership
        of a request on the model's device (None where absent)."""
        dev = self.device

        def field(k, dtype=None):
            return None if k not in batch else torch.as_tensor(batch[k], dtype=dtype, device=dev)

        return (field("proposals", torch.float32), field("proposal_scores", torch.float32), field("superpixels"),
                field("oh_labels", torch.bool))

    def forward(self, batch: Dict, generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """In train mode the loss dict (see the module docstring); in eval
        mode :meth:`inference`."""
        if not self.training:
            return self.inference(batch)
        features, image_sizes = self._features(batch)
        proposals, scores, superpixels, oh_labels = self.request_fields(batch)
        targets = {
            k: torch.as_tensor(batch[k], device=self.device)
            for k in ("gt_classes", "gt_valid", "gt_boxes", "gt_sem_seg") if k in batch
        }
        aux, losses = self.roi_heads(
            features, proposals, scores, image_sizes, superpixels, oh_labels, targets=targets, train=True,
            generator=generator,
        )
        if "pgt_sem_seg" in aux:
            losses.update(self.sem_seg_head.losses(
                self.sem_seg_head(features), aux["pgt_sem_seg"], aux["pgt_sem_seg_stride"]
            ))
        return losses


def build_wsl_roi_heads(cfg, input_shape):
    """The WSOD heads named by ROI_HEADS.NAME (JAX package registry
    ``ROI_HEADS_REGISTRY``): ``WSDDNROIHeads``, ``OICRROIHeads``,
    ``CascadeOICRROIHeads``, ``PCLROIHeads``, ``ContextLocNetROIHeads`` or
    ``CMILROIHeads``."""
    from .roi_heads_wsl import CascadeOICRROIHeads, OICRROIHeads, WSDDNROIHeads
    from .wsod_zoo import CMILROIHeads, ContextLocNetROIHeads, PCLROIHeads

    heads = {h.__name__: h for h in (WSDDNROIHeads, OICRROIHeads, CascadeOICRROIHeads, PCLROIHeads,
                                     ContextLocNetROIHeads, CMILROIHeads)}
    name = cfg.MODEL.ROI_HEADS.NAME
    if name not in heads:
        raise NotImplementedError(f"ROI heads {name!r} under GeneralizedRCNNWSL are not ported yet "
                                  "(ROADMAP queue 1 item 6)")
    return heads[name](cfg, input_shape)


class GeneralizedRCNNWSL(BackboneModel):
    """The WSOD meta-architecture (reference
    projects/WSL/wsl/modeling/meta_arch/rcnn.py:24; JAX package
    ``wsl/modeling/meta_arch.py:34-111``): the image normalised in float32,
    the backbone, the request's precomputed ``proposals`` (B, R, 4) and
    ``proposal_scores`` (B, R) (-inf marks padding), the WSOD heads
    (``build_wsl_roi_heads``), and the detections mapped to ``orig_sizes``
    (``boxes``, ``scores``, ``classes``, ``valid``, ``prop_idx`` and, but
    for PCL, ContextLocNet and CMIL, ``proposal_class_scores``). In train mode, with the image
    labels ``gt_classes`` and ``gt_valid`` (B, G), the heads' loss dict;
    ``generator`` draws the DAN's dropout. The learned proposal generator
    (UWSOD's ``RPNWSL``) is not ported."""

    def __init__(self, cfg):
        if cfg.MODEL.PROPOSAL_GENERATOR.NAME != "PrecomputedProposals":
            raise NotImplementedError(
                f"GeneralizedRCNNWSL with the proposal generator {cfg.MODEL.PROPOSAL_GENERATOR.NAME!r} (UWSOD's "
                "RPNWSL) is not ported yet (ROADMAP queue 1 item 6)")
        super().__init__(cfg)
        self.roi_heads = build_wsl_roi_heads(cfg, self.backbone.output_shape())

    def request_fields(self, batch: Dict):
        dev = self.device
        return (torch.as_tensor(batch["proposals"], dtype=torch.float32, device=dev),
                torch.as_tensor(batch["proposal_scores"], dtype=torch.float32, device=dev))

    @serving
    def inference(self, batch: Dict) -> Dict[str, torch.Tensor]:
        with exact_float32(self.compute_dtype == torch.float32):
            features, image_sizes = self._features(batch)
            proposals, scores = self.request_fields(batch)
            det = self.roi_heads(features, proposals, scores, image_sizes)
            return detector_postprocess_batched(det, image_sizes, self.orig_sizes(batch, image_sizes))

    def forward(self, batch: Dict, generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """In train mode the loss dict; in eval mode :meth:`inference`."""
        if not self.training:
            return self.inference(batch)
        features, image_sizes = self._features(batch)
        proposals, scores = self.request_fields(batch)
        targets = {k: torch.as_tensor(batch[k], device=self.device) for k in ("gt_classes", "gt_valid")}
        return self.roi_heads(features, proposals, scores, image_sizes, targets=targets, train=True,
                              generator=generator)
