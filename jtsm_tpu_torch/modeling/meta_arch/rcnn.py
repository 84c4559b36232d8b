"""GeneralizedRCNN and ProposalNetwork (reference:
detectron2/modeling/meta_arch/rcnn.py:24, :177 ``inference``, :249
``ProposalNetwork``; JAX package ``modeling/meta_arch/rcnn.py:37,123``), and
``build_model`` for every ported meta-architecture.

Input contract, the JAX package's batch dict:
  image:        (B, H, W, 3) float, raw pixel scale, channel order per cfg
  image_sizes:  (B, 2) int true (h, w) inside the padded canvas
  orig_sizes:   (B, 2) int original sizes (boxes are mapped back to them)
  gt_boxes:     (B, G, 4) float             (training; (B, G, 5) rotated
                                             (cx, cy, w, h, angle) under RRPN)
  gt_classes:   (B, G) int                  (training)
  gt_valid:     (B, G) bool                 (training)
  gt_mask_crops:(B, G, M, M) bool           (training, MASK_ON)
Output in eval mode: fixed (B, D) detections with a ``valid`` mask: ``boxes``
(B, D, 4) (a rotated model's, RRPN and RROIHeads, (B, D, 5) (cx, cy, w, h,
angle), its proposals too), ``scores`` (B, D), ``classes`` (B, D) int32, ``valid`` (B, D)
bool and, with MASK_ON, ``masks`` (B, D, S, S) ROI probabilities, with
KEYPOINT_ON ``keypoints`` (B, D, K, 4) (x, y, logit, probability); given
``detected_boxes``, only the per-box branches
(:meth:`GeneralizedRCNN.inference`). In train mode (``model.train()``): the
loss dict ``loss_rpn_cls``, ``loss_rpn_loc``, ``loss_cls``,
``loss_box_reg`` and, with MASK_ON, ``loss_mask``, with KEYPOINT_ON
``loss_keypoint`` (under CascadeROIHeads ``loss_cls_stage{s}`` and
``loss_box_reg_stage{s}``). Under PrecomputedProposals (Fast R-CNN) there is
no RPN: the batch's ``proposals`` (B, K, 4) and ``proposal_scores`` (B, K,
-inf in unused slots) go to the ROI heads, and there are no RPN losses. ``inference`` serves as in eval mode in either mode
(``serving``). Trainable batch norms normalise with the batch's statistics
only under ``layers.batch_statistics`` (the train step, PreciseBN); a
train-mode forward outside it takes the running statistics, as the JAX
package's ``apply(train=True)`` without a mutable ``batch_stats`` does.

Sampling in training draws uniforms from the generator passed to
``forward``, in this order: the RPN's positive and negative anchor draws
(B, anchors) each, the ROI heads' positive, negative and slot-order draws
(B, proposals + G) each, the mask branch's draw (B, slots) and the
keypoint branch's draw (B, slots).

Precision: ``TPU.COMPUTE_DTYPE`` (``compute_dtype``). Images are normalised
in float32, as in the JAX package (``rcnn.py:63``), and the backbone takes
them in the compute dtype; the modules compute in it over float32
parameters. In float32, inference and training (``engine.train_loop``) run
with TF32 off for matrix products and cuDNN (``exact_float32``).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ...layers import batch_statistics, compute_dtype, exact_float32
from ..backbone import build_backbone
from ..postprocessing import detector_postprocess_batched
from ..proposal_generator.rpn import build_proposal_generator
from ..roi_heads.roi_heads import build_roi_heads


def serving(inference):
    """Makes a meta-architecture's ``inference`` serve as in eval mode
    whatever mode the model is in: without gradients, every module in
    eval mode for the call (the RPN's test top-k, the heads' detections)
    and the batch norms on their running statistics, as the JAX package's
    ``apply(train=False)`` without ``mutable``; the modules' modes come
    back afterwards."""

    @functools.wraps(inference)
    def wrapped(self, *args, **kwargs):
        modes = [(m, m.training) for m in self.modules()]
        self.eval()
        try:
            with torch.no_grad(), batch_statistics(False):
                return inference(self, *args, **kwargs)
        finally:
            for m, training in modes:
                m.training = training

    return wrapped


class BackboneModel(nn.Module):
    """The backbone, the pixel statistics and the compute dtype that every
    meta-architecture holds, and the normalisation in front of the
    backbone."""

    def __init__(self, cfg):
        super().__init__()
        self.compute_dtype = compute_dtype(cfg)
        self.backbone = build_backbone(cfg)
        self.register_buffer(
            "pixel_mean", torch.tensor(cfg.MODEL.PIXEL_MEAN, dtype=torch.float32), persistent=False
        )
        self.register_buffer(
            "pixel_std", torch.tensor(cfg.MODEL.PIXEL_STD, dtype=torch.float32), persistent=False
        )

    @property
    def device(self) -> torch.device:
        return self.pixel_mean.device

    def _features(self, batch):
        dev = self.device
        images = torch.as_tensor(batch["image"], dtype=torch.float32, device=dev)
        image_sizes = torch.as_tensor(batch["image_sizes"], device=dev)
        # normalise NHWC, then an NCHW view of it: the backbone runs
        # channels-last, so the poolers read the maps without a copy
        x = ((images - self.pixel_mean) / self.pixel_std).permute(0, 3, 1, 2)
        return self.backbone(x.to(self.compute_dtype)), image_sizes

    def orig_sizes(self, batch, image_sizes: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(batch.get("orig_sizes", image_sizes), device=self.device)

    def targets(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """The batch's ``gt_*`` fields on the model's device."""
        return {k: torch.as_tensor(v, device=self.device) for k, v in batch.items() if k.startswith("gt_")}


class GeneralizedRCNN(BackboneModel):
    def __init__(self, cfg):
        super().__init__(cfg)
        shapes = self.backbone.output_shape()
        self.proposal_generator = build_proposal_generator(cfg, shapes)
        self.roi_heads = build_roi_heads(cfg, shapes)

    def given_detections(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """The request's ``detected_boxes`` (B, D, 4) in network-input
        coordinates and ``detected_classes`` (B, D) on the model's device,
        with ``detected_scores`` (default 1) and ``detected_valid`` (default
        all) as ``scores`` and ``valid``."""
        dev = self.device
        boxes = torch.as_tensor(batch["detected_boxes"], dtype=torch.float32, device=dev)
        b, d = boxes.shape[:2]
        scores, valid = batch.get("detected_scores"), batch.get("detected_valid")
        return {
            "boxes": boxes,
            "classes": torch.as_tensor(batch["detected_classes"], device=dev),
            "scores": torch.ones((b, d), device=dev) if scores is None else torch.as_tensor(scores, device=dev),
            "valid": (torch.ones((b, d), dtype=torch.bool, device=dev) if valid is None
                      else torch.as_tensor(valid, dtype=torch.bool, device=dev)),
        }

    @serving
    def inference(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Detections for a batch dict (see the module docstring). Inputs
        are moved to the model's device. With ``detected_boxes`` (and
        ``detected_classes``, optionally ``detected_scores`` and
        ``detected_valid``) in the request, the RPN and the box head are
        skipped and only the per-box branches run on those boxes, which
        stay in network-input coordinates (JAX package ``rcnn.py:76-93``)."""
        with exact_float32(self.compute_dtype == torch.float32):
            features, image_sizes = self._features(batch)
            if "detected_boxes" in batch:
                return self.roi_heads.forward_with_given_boxes(features, self.given_detections(batch))
            proposals, proposal_scores, _ = self.propose(batch, image_sizes, features)
            detections = self.roi_heads(features, proposals, proposal_scores, image_sizes)
            return detector_postprocess_batched(detections, image_sizes, self.orig_sizes(batch, image_sizes))

    def forward(
        self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None
    ) -> Dict[str, torch.Tensor]:
        """In train mode the loss dict of a batch with its ``gt_*`` fields,
        sampling with uniform draws from ``generator`` (on the model's
        device; None draws from PyTorch's default generator); in eval mode
        :meth:`inference`."""
        if not self.training:
            return self.inference(batch)
        features, image_sizes = self._features(batch)
        rpn_losses, roi_losses = self.instance_losses(features, image_sizes, self.targets(batch), generator,
                                                      self.batch_proposals(batch))
        return {**rpn_losses, **roi_losses}

    def batch_proposals(self, batch: Dict) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """Without a proposal generator (PrecomputedProposals), the batch's
        ``proposals`` (B, K, 4) and ``proposal_scores`` (B, K), -inf in
        unused slots, on the model's device (JAX ``rcnn.py:93-104``); else
        None."""
        if self.proposal_generator is not None:
            return None
        if "proposals" not in batch:
            raise ValueError("PrecomputedProposals: the batch has no proposals (MODEL.LOAD_PROPOSALS and "
                             "DATASETS.PROPOSAL_FILES_* put them there)")
        dev = self.device
        return (torch.as_tensor(batch["proposals"], dtype=torch.float32, device=dev),
                torch.as_tensor(batch["proposal_scores"], dtype=torch.float32, device=dev))

    def propose(self, batch: Dict, image_sizes: torch.Tensor, features: Dict[str, torch.Tensor]):
        """Serving's proposals, their scores and (empty) losses: the RPN's,
        or the batch's (``batch_proposals``)."""
        given = self.batch_proposals(batch)
        if given is not None:
            return (*given, {})
        return self.proposal_generator(image_sizes, features)

    def instance_losses(self, features, image_sizes, targets, generator=None, proposals=None):
        """The RPN's losses and the ROI heads' losses of one train step on
        ``features``, sampling with draws from ``generator``. ``proposals``
        (boxes and scores, ``batch_proposals``) replace the RPN's, which
        a model without a proposal generator must be given; it has no RPN
        losses."""
        if proposals is not None:
            (proposals, proposal_scores), rpn_losses = proposals, {}
        elif self.proposal_generator is None:
            raise ValueError("a model without a proposal generator trains on the batch's proposals")
        else:
            proposals, proposal_scores, rpn_losses = self.proposal_generator(
                image_sizes, features, targets["gt_boxes"], targets["gt_valid"], generator
            )
        roi_losses = self.roi_heads(features, proposals, proposal_scores, image_sizes, targets, generator)
        return rpn_losses, roi_losses


class ProposalNetwork(BackboneModel):
    """The RPN alone (JAX package ``rcnn.py:123``): ``proposals``
    (B, POST_NMS_TOPK_TEST, 4) in original-image coordinates (rescaled and
    clipped as detections are) and their objectness logits ``scores``, -inf
    on padding; in train mode the RPN's ``loss_rpn_cls`` and
    ``loss_rpn_loc``, sampling with the RPN's draws from ``generator``."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.proposal_generator = build_proposal_generator(cfg, self.backbone.output_shape())

    @serving
    def inference(self, batch: Dict) -> Dict[str, torch.Tensor]:
        with exact_float32(self.compute_dtype == torch.float32):
            features, image_sizes = self._features(batch)
            proposals, scores, _ = self.proposal_generator(image_sizes, features)
            post = detector_postprocess_batched({"boxes": proposals}, image_sizes, self.orig_sizes(batch, image_sizes))
            return {"proposals": post["boxes"], "scores": scores}

    def forward(self, batch: Dict, generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        if not self.training:
            return self.inference(batch)
        features, image_sizes = self._features(batch)
        targets = self.targets(batch)
        _, _, losses = self.proposal_generator(
            image_sizes, features, targets["gt_boxes"], targets["gt_valid"], generator
        )
        return losses


def resolve_device(device) -> torch.device:
    """The device to run on: the card unless the caller asks for another.
    Asking for the card on a machine without one raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return device


def build_model(cfg, device="cuda") -> nn.Module:
    """The model named by MODEL.META_ARCHITECTURE (``GeneralizedRCNN``,
    ``ProposalNetwork``, ``RetinaNet``, ``PanopticFPN``,
    ``SemanticSegmentor``, the JTSM ``GeneralizedMCNNWSL`` or the WSOD
    ``GeneralizedRCNNWSL``; JAX package
    ``meta_arch/build.py:11``), in eval mode, on ``device``. Weights
    start from the JAX package's initialisers, drawn from PyTorch's global
    generator (``layers.wrappers``; ``engine.default_setup`` seeds it):
    train from there, or load a state dict (``checkpoint``) before serving
    or training; call ``.train()`` to train (``engine.create_train_state``
    does)."""
    from .panoptic_fpn import PanopticFPN
    from .retinanet import RetinaNet
    from .semantic_seg import SemanticSegmentor

    name = cfg.MODEL.META_ARCHITECTURE
    archs = {
        "GeneralizedRCNN": GeneralizedRCNN,
        "ProposalNetwork": ProposalNetwork,
        "RetinaNet": RetinaNet,
        "PanopticFPN": PanopticFPN,
        "SemanticSegmentor": SemanticSegmentor,
    }
    if name == "GeneralizedMCNNWSL":
        from ...wsl.modeling.meta_arch import GeneralizedMCNNWSL as arch
    elif name == "GeneralizedRCNNWSL":
        from ...wsl.modeling.meta_arch import GeneralizedRCNNWSL as arch
    elif name in archs:
        arch = archs[name]
    else:
        raise NotImplementedError(f"meta architecture {name!r} is not ported yet")
    device = resolve_device(device)
    return arch(cfg).to(device).eval()
