"""GeneralizedRCNN (reference: detectron2/modeling/meta_arch/rcnn.py:24,
:177 ``inference``; JAX package ``modeling/meta_arch/rcnn.py``).

Input contract, the JAX package's batch dict:
  image:        (B, H, W, 3) float, raw pixel scale, channel order per cfg
  image_sizes:  (B, 2) int true (h, w) inside the padded canvas
  orig_sizes:   (B, 2) int original sizes (boxes are mapped back to them)
  gt_boxes:     (B, G, 4) float             (training)
  gt_classes:   (B, G) int                  (training)
  gt_valid:     (B, G) bool                 (training)
  gt_mask_crops:(B, G, M, M) bool           (training, MASK_ON)
Output in eval mode: fixed (B, D) detections with a ``valid`` mask: ``boxes``
(B, D, 4), ``scores`` (B, D), ``classes`` (B, D) int32, ``valid`` (B, D)
bool and, with MASK_ON, ``masks`` (B, D, S, S) ROI probabilities. In train
mode (``model.train()``): the loss dict ``loss_rpn_cls``, ``loss_rpn_loc``,
``loss_cls``, ``loss_box_reg`` and, with MASK_ON, ``loss_mask``.

Sampling in training draws uniforms from the generator passed to
``forward``, in this order: the RPN's positive and negative anchor draws
(B, anchors) each, the ROI heads' positive, negative and slot-order draws
(B, proposals + G) each, and the mask branch's draw (B, slots).

Precision: ``TPU.COMPUTE_DTYPE`` (``compute_dtype``). Images are normalised
in float32, as in the JAX package (``rcnn.py:63``), and the backbone takes
them in the compute dtype; the modules compute in it over float32
parameters. In float32, inference and training (``engine.train_loop``) run
with TF32 off for matrix products and cuDNN (``exact_float32``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ...layers import compute_dtype, exact_float32
from ..backbone import build_backbone
from ..postprocessing import detector_postprocess_batched
from ..proposal_generator.rpn import build_proposal_generator
from ..roi_heads.roi_heads import build_roi_heads


class GeneralizedRCNN(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.compute_dtype = compute_dtype(cfg)
        self.backbone = build_backbone(cfg)
        shapes = self.backbone.output_shape()
        self.proposal_generator = build_proposal_generator(cfg, shapes)
        self.roi_heads = build_roi_heads(cfg, shapes)
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

    @torch.no_grad()
    def inference(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Detections for a batch dict (see the module docstring). Inputs
        are moved to the model's device."""
        with exact_float32(self.compute_dtype == torch.float32):
            features, image_sizes = self._features(batch)
            orig_sizes = torch.as_tensor(batch.get("orig_sizes", image_sizes), device=self.device)
            proposals, proposal_scores, _ = self.proposal_generator(image_sizes, features)
            detections = self.roi_heads(features, proposals, proposal_scores, image_sizes)
            return detector_postprocess_batched(detections, image_sizes, orig_sizes)

    def forward(
        self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None
    ) -> Dict[str, torch.Tensor]:
        """In train mode the loss dict of a batch with its ``gt_*`` fields,
        sampling with uniform draws from ``generator`` (on the model's
        device; None draws from PyTorch's default generator); in eval mode
        :meth:`inference`."""
        if not self.training:
            return self.inference(batch)
        dev = self.device
        features, image_sizes = self._features(batch)
        targets = {
            k: torch.as_tensor(v, device=dev) for k, v in batch.items() if k.startswith("gt_")
        }
        proposals, proposal_scores, losses = self.proposal_generator(
            image_sizes, features, targets["gt_boxes"], targets["gt_valid"], generator
        )
        losses.update(
            self.roi_heads(features, proposals, proposal_scores, image_sizes, targets, generator)
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
    """The model named by MODEL.META_ARCHITECTURE (``GeneralizedRCNN``, or
    the JTSM ``GeneralizedMCNNWSL``), in eval mode, on ``device``. Weights
    are left at PyTorch's initialisation: load a state dict
    (``checkpoint.convert``) before serving or training; call ``.train()``
    to train (``engine.create_train_state`` does)."""
    name = cfg.MODEL.META_ARCHITECTURE
    if name == "GeneralizedRCNN":
        arch = GeneralizedRCNN
    elif name == "GeneralizedMCNNWSL":
        from ...wsl.modeling.meta_arch import GeneralizedMCNNWSL as arch
    else:
        raise NotImplementedError(f"meta architecture {name!r} is not ported yet")
    device = resolve_device(device)
    return arch(cfg).to(device).eval()
