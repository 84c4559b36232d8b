"""GeneralizedMCNNWSL, the JTSM meta-architecture (reference:
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
from torch import nn

from ...layers import compute_dtype, exact_float32, interpolate_bilinear
from ...modeling.backbone import build_backbone
from ...modeling.meta_arch.rcnn import GeneralizedRCNN
from ...modeling.meta_arch.semantic_seg import build_sem_seg_head
from ...modeling.postprocessing import detector_postprocess_batched
from .roi_heads_jtsm import JTSMROIHeads


class GeneralizedMCNNWSL(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        if cfg.MODEL.ROI_HEADS.NAME != "JTSMROIHeads":
            raise NotImplementedError(f"ROI heads {cfg.MODEL.ROI_HEADS.NAME!r} are not ported yet")
        self.compute_dtype = compute_dtype(cfg)
        self.backbone = build_backbone(cfg)
        shapes = self.backbone.output_shape()
        self.sem_seg_head = build_sem_seg_head(cfg, shapes)
        self.roi_heads = JTSMROIHeads(cfg, shapes, mine_sem_seg=self.sem_seg_head.has_loss)
        self.register_buffer(
            "pixel_mean", torch.tensor(cfg.MODEL.PIXEL_MEAN, dtype=torch.float32), persistent=False
        )
        self.register_buffer(
            "pixel_std", torch.tensor(cfg.MODEL.PIXEL_STD, dtype=torch.float32), persistent=False
        )

    device = GeneralizedRCNN.device
    # f32 normalisation, then the backbone in the compute dtype
    _features = GeneralizedRCNN._features

    @torch.no_grad()
    def inference(self, batch: Dict) -> Dict[str, torch.Tensor]:
        dev = self.device
        with exact_float32(self.compute_dtype == torch.float32):
            features, image_sizes = self._features(batch)
            if "detected_boxes" in batch:
                boxes = torch.as_tensor(batch["detected_boxes"], dtype=torch.float32, device=dev)
                b, d = boxes.shape[:2]
                det = {
                    "boxes": boxes,
                    "classes": torch.as_tensor(batch["detected_classes"], device=dev),
                    "scores": torch.as_tensor(batch.get("detected_scores", torch.ones((b, d))), device=dev),
                    "valid": torch.as_tensor(
                        batch.get("detected_valid", torch.ones((b, d), dtype=torch.bool)), device=dev
                    ),
                }
                return self.roi_heads.forward_with_given_boxes(features, det)

            proposals, scores, superpixels, oh_labels = self.request_fields(batch)
            det = self.roi_heads(features, proposals, scores, image_sizes, superpixels, oh_labels)
            orig_sizes = torch.as_tensor(batch.get("orig_sizes", image_sizes), device=dev)
            det = detector_postprocess_batched(det, image_sizes, orig_sizes)
            h, w = batch["image"].shape[1:3]
            logits = interpolate_bilinear(self.sem_seg_head(features), (h, w))  # (B, K, H, W)
            det["sem_seg"] = logits.argmax(dim=1).to(torch.int32)
            det["sem_seg_logits"] = logits.permute(0, 2, 3, 1)
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
