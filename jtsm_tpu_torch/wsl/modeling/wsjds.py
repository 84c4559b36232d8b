"""CSC, CSC-OICR and WSJDS: heads whose MIL loss is weighed by contrastive
spatial confidence (CSC) from class peak gradient (CPG) maps, and the CPG
pass (reference: projects/WSL/wsl/modeling/roi_heads/roi_heads_csc.py,
seg_heads/wsjds_heads.py; JAX package ``wsl/modeling/wsjds.py`` :46
``sem_seg_targets_from_cpg``, :71 ``csc_weighted_mil_image_loss``, :110
``WSJDSROIHeads``, :290 ``CSCROIHeads``, :302 ``CSCOICRROIHeads``, :350-414
``make_cpg_batch_transform``).

The maps ride in the train batch as ``cpg`` (B, C, H, W), one a class at
the padded image's size, each normalised to a maximum of 1, zero for the
absent classes and for those whose image score is below ``CPG_TAU``.
``make_cpg_batch_transform`` makes them before each train step until
WSL.CSC_MAX_ITER (``class_peak_gradients``); without them the heads train
on the plain MIL loss.

``class_peak_gradients`` is the JAX transform's pass with one forward: the
model in eval mode (no dropout), the image a leaf that takes gradients,
the heads' proposal class scores summed over the proposals (no decoding,
no NMS); then for each occupied class slot (at most ``CPG_MAX_CLASSES``:
the JAX package runs all eight, the empty ones give zero maps) one
backward to the image, which reuses the forward's graph, each image's
gradient weighed by whether its slot holds a present class whose score
passes the gate (the images do not interact, so this equals the JAX
package's per-slot gradient zeroed after the gate). The map is the
channel maximum of the absolute gradient over its maximum (at least
1e-20), max-scattered into its class. Where the pooled maps carry no
gradient (FREEZE_AT detaches them), every map is exactly zero and no
backward runs. On the card each backward runs K2 under the box pooler
wherever the pooled map trains.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import numpy as np
import torch

from ...layers import ShapeSpec, batch_statistics, exact_float32, interpolate_bilinear
from .mil_heads import mil_image_loss
from .roi_heads_wsl import OICRROIHeads, WSDDNROIHeads, image_level_gt
from .seg_heads import ASPPHead
from .wsod_zoo import compute_cpg, csc_full

# the heads that read CPG maps (the reference's ``has_cpg`` set)
CPG_ROI_HEADS = ("CSCROIHeads", "CSCOICRROIHeads", "WSJDSROIHeads")
# classes whose image score is below tau get no map (roi_heads_csc.py:111);
# at most this many present classes an image get maps
CPG_TAU = 0.7
CPG_MAX_CLASSES = 8


def sem_seg_targets_from_cpg(
    cpg: torch.Tensor,  # (B, C, H, W) normalised CPG maps
    img_labels: torch.Tensor,  # (B, C) multi-hot
    fg_threshold: float = 0.7,
    bg_threshold: float = 0.1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-class binary targets and balanced weights (JAX :46): a map at or
    above ``fg_threshold`` is foreground, below ``bg_threshold`` background,
    ignored between; absent classes are all background, present classes
    with an all-zero map all ignored; foreground and background weigh 1
    over their counts."""
    present = img_labels[:, :, None, None] > 0.5
    has_map = cpg.amax(dim=(2, 3), keepdim=True) > 0
    pos = (cpg >= fg_threshold) & present & has_map
    neg = ((cpg < bg_threshold) & present & has_map) | ~present
    n_pos = pos.sum(dim=(2, 3), keepdim=True).float().clamp(min=1.0)
    n_neg = neg.sum(dim=(2, 3), keepdim=True).float().clamp(min=1.0)
    zero = torch.zeros((), device=cpg.device)
    return pos.float(), torch.where(pos, 1.0 / n_pos, torch.where(neg, 1.0 / n_neg, zero))


def csc_weighted_mil_image_loss(
    mil: torch.Tensor,  # (B, R, C) WSDDN scores
    boxes: torch.Tensor,  # (B, R, 4)
    valid: torch.Tensor,  # (B, R)
    labels: torch.Tensor,  # (B, C) multi-hot
    cpg: torch.Tensor,  # (B, C, H, W) normalised maps
    fg_threshold: float = 0.1,
    mean_loss: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B,) ``loss_cls_pos`` and ``loss_cls_neg`` (JAX :71): the CSC weights
    W of the image predictions (the summed scores, with their gradient),
    the binary cross entropy of the scores summed under max(W, 0) against
    the labels and of those under |min(W, 0)| against 0, each sum clipped
    to [1e-20, 1 - 1e-20] (1 in float32), the mean over the classes (or
    their sum without ``mean_loss``). Maxima, minima and clips split their
    gradient at ties, as ``jnp.maximum`` does."""
    w = csc_full(cpg, boxes, valid, labels, mil.sum(dim=1), fg_threshold=fg_threshold)
    zero = torch.zeros((), device=mil.device)
    lo, hi = torch.full((), 1e-20, device=mil.device), torch.full((), 1.0 - 1e-20, device=mil.device)
    img_pos = torch.minimum(torch.maximum((mil * torch.maximum(w, zero)).sum(dim=1), lo), hi)
    img_neg = torch.minimum(torch.maximum((mil * torch.abs(torch.minimum(w, zero))).sum(dim=1), lo), hi)

    def bce(p, t):
        return -(t * torch.log(p) + (1.0 - t) * torch.log1p(-p))

    pos, neg = bce(img_pos, labels.float()), bce(img_neg, torch.zeros_like(img_neg))
    if mean_loss:
        return pos.mean(dim=-1), neg.mean(dim=-1)
    return pos.sum(dim=-1), neg.sum(dim=-1)


class WSJDSROIHeads(WSDDNROIHeads):
    """WSJDS's box branch (JAX :110): WSDDN over pooled features scaled by
    (objectness + 1) (padding's objectness counts as 0), without GAM. With
    ``cpg`` in the targets, ``loss_cls_pos`` and ``loss_cls_neg`` of
    ``csc_weighted_mil_image_loss`` (WSL.CSC_FG_THRESHOLD), else the MIL
    loss ``loss_mil``. Under SEM_SEG_HEAD.NAME ASPPHead the head owns
    ``sem_seg_head``: trained on the maps' binary targets
    (WSL.SEM_FG_THRESHOLD, WSL.SEM_BG_THRESHOLD; ``loss_sem_seg``), its
    sigmoid masks resized bilinearly to the maps' size and normalised to a
    maximum of 1 weigh the MIL scores again by CSC (``loss_mask_cls_pos``
    and ``loss_mask_cls_neg``, times 0.1); in serving each detection's
    ``masks_full`` (B, D, H, W) is its class's sigmoid mask at the padded
    image's size (the map's size times its stride) inside its box, and
    ``no_paste`` its validity. The seg head gets no image, so
    SEM_SEG_HEAD.CONSTRAINT "CRF" changes nothing here, as in the JAX
    package. Stages: ``pool_proposals``, ``dan``, ``predict``, ``detect``
    and ``segment``, or ``losses``."""

    uses_gam = False
    has_seg = True

    def __init__(self, cfg, input_shape: Dict[str, ShapeSpec]):
        super().__init__(cfg, input_shape)
        w = cfg.WSL
        self.csc_fg_threshold = w.CSC_FG_THRESHOLD
        self.sem_fg_threshold = w.SEM_FG_THRESHOLD
        self.sem_bg_threshold = w.SEM_BG_THRESHOLD
        self.sem_seg_head = (ASPPHead(cfg, input_shape)
                             if self.has_seg and cfg.MODEL.SEM_SEG_HEAD.NAME == "ASPPHead" else None)
        self.seg_stride = input_shape[self.in_features[-1]].stride

    def pool_proposals(self, features, proposals, proposal_scores):
        pooled = self.pool(features, proposals)
        obj = torch.where(torch.isfinite(proposal_scores), proposal_scores, torch.zeros_like(proposal_scores))
        return pooled * (obj + 1.0).reshape(-1, 1, 1, 1).to(pooled.dtype)

    def losses(self, proposals, proposal_scores, mil, branches, targets, features=None,
               generator=None) -> Dict[str, torch.Tensor]:
        img_labels = image_level_gt(targets["gt_classes"], targets["gt_valid"], self.num_classes)
        cpg = targets.get("cpg")
        if cpg is None:
            return {"loss_mil": mil_image_loss(mil, img_labels, self.mean_loss).mean()}
        valid = torch.isfinite(proposal_scores)
        pos, neg = csc_weighted_mil_image_loss(mil, proposals, valid, img_labels, cpg, self.csc_fg_threshold,
                                               self.mean_loss)
        losses = {"loss_cls_pos": pos.mean(), "loss_cls_neg": neg.mean()}
        if self.sem_seg_head is not None:
            losses.update(self.seg_losses(features, mil, proposals, valid, img_labels, cpg))
        return losses

    def seg_losses(self, features, mil, proposals, valid, img_labels, cpg) -> Dict[str, torch.Tensor]:
        """Det to seg to det (JAX :145-181)."""
        sem_t, sem_w = sem_seg_targets_from_cpg(cpg, img_labels, self.sem_fg_threshold, self.sem_bg_threshold)
        logits = self.sem_seg_head(features)
        losses = self.sem_seg_head.binary_losses(logits, sem_t, sem_w)
        masks = interpolate_bilinear(torch.sigmoid(logits.float()), tuple(cpg.shape[-2:]))
        masks = masks / masks.amax(dim=(2, 3), keepdim=True).clamp(min=1e-12)
        pos, neg = csc_weighted_mil_image_loss(mil, proposals, valid, img_labels, masks, self.csc_fg_threshold,
                                               self.mean_loss)
        losses["loss_mask_cls_pos"] = 0.1 * pos.mean()
        losses["loss_mask_cls_neg"] = 0.1 * neg.mean()
        return losses

    def segment(self, features: Dict[str, torch.Tensor], det: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``masks_full`` and ``no_paste`` of the detections (JAX :183-208)."""
        if self.sem_seg_head is None:
            return det
        f = features[self.in_features[-1]]
        h, w = f.shape[-2] * self.seg_stride, f.shape[-1] * self.seg_stride
        probs = interpolate_bilinear(torch.sigmoid(self.sem_seg_head(features).float()), (h, w))
        b, d = det["classes"].shape
        cls = det["classes"].long().clamp(0, self.num_classes - 1)
        maps = torch.gather(probs, 1, cls[..., None, None].expand(b, d, h, w))
        x0, y0, x1, y1 = (det["boxes"][..., i, None, None] for i in range(4))
        yy = torch.arange(h, dtype=torch.float32, device=f.device)[:, None]
        xx = torch.arange(w, dtype=torch.float32, device=f.device)[None, :]
        window = (yy >= y0) & (yy < y1) & (xx >= x0) & (xx < x1)
        return dict(det, masks_full=maps * window, no_paste=det["valid"])

    def forward(self, features, proposals, proposal_scores, image_sizes, targets=None, train=False, generator=None):
        out = super().forward(features, proposals, proposal_scores, image_sizes, targets, train, generator)
        return out if train else self.segment(features, out)


class CSCROIHeads(WSJDSROIHeads):
    """CSC (JAX :290, reference roi_heads_csc.py:35): WSJDS's box branch
    without the segmentation branch."""

    has_seg = False


class CSCOICRROIHeads(OICRROIHeads):
    """CSC-OICR (JAX :302): OICR whose MIL loss is CSC-weighted given
    ``cpg`` (``loss_cls_pos``, ``loss_cls_neg``), the plain ``loss_mil``
    without; the refinement branches are OICR's."""

    def __init__(self, cfg, input_shape: Dict[str, ShapeSpec]):
        super().__init__(cfg, input_shape)
        self.csc_fg_threshold = cfg.WSL.CSC_FG_THRESHOLD

    def _mil_losses(self, mil, img_labels, proposals, valid, targets) -> Dict[str, torch.Tensor]:
        cpg = targets.get("cpg")
        if cpg is None:
            return super()._mil_losses(mil, img_labels, proposals, valid, targets)
        pos, neg = csc_weighted_mil_image_loss(mil, proposals, valid, img_labels, cpg, self.csc_fg_threshold,
                                               self.mean_loss)
        return {"loss_cls_pos": pos.mean(), "loss_cls_neg": neg.mean()}


@contextlib.contextmanager
def _serving_modes(model):
    """Every module in eval mode and the batch norms on their running
    statistics, gradients on; the modes come back afterwards."""
    modes = [(m, m.training) for m in model.modules()]
    model.eval()
    try:
        with torch.enable_grad(), batch_statistics(False), exact_float32(model.compute_dtype == torch.float32):
            yield
    finally:
        for m, training in modes:
            m.training = training


def cpg_slots(gt_classes, gt_valid, max_classes: int = CPG_MAX_CLASSES) -> Tuple[np.ndarray, np.ndarray]:
    """(B, K) class slots and their occupancy on the host: each image's
    present classes, sorted, at most ``max_classes``."""
    gt_c = torch.as_tensor(gt_classes).cpu().numpy()
    gt_v = torch.as_tensor(gt_valid).cpu().numpy().astype(bool)
    b = gt_c.shape[0]
    idx = np.zeros((b, max_classes), np.int64)
    ok = np.zeros((b, max_classes), bool)
    for i in range(b):
        present = np.unique(gt_c[i][gt_v[i]])[:max_classes]
        idx[i, : len(present)] = present
        ok[i, : len(present)] = True
    return idx, ok


def class_peak_gradients(model, batch: Dict, num_classes: int, tau: float = CPG_TAU,
                         max_classes: int = CPG_MAX_CLASSES) -> Tuple[torch.Tensor, int]:
    """The (B, C, H, W) float32 CPG maps of a train batch on the model's
    device (see the module docstring) and the number of backward passes."""
    dev = model.device
    idx_np, ok_np = cpg_slots(batch["gt_classes"], batch["gt_valid"], max_classes)
    images = torch.as_tensor(batch["image"], dtype=torch.float32, device=dev).detach().requires_grad_()
    b, h, w, _ = images.shape
    out = torch.zeros((b, num_classes, h, w), dtype=images.dtype, device=dev)
    slots = [k for k in range(max_classes) if ok_np[:, k].any()]
    heads = model.roi_heads
    with _serving_modes(model):
        x = ((images - model.pixel_mean) / model.pixel_std).permute(0, 3, 1, 2)
        features = model.backbone(x.to(model.compute_dtype))
        if not slots or not any(features[f].requires_grad for f in heads.in_features):
            return out, 0
        proposals, proposal_scores = model.request_fields(batch)
        scores = heads.proposal_class_scores(features, proposals, proposal_scores).sum(dim=1)  # (B, C)
        idx = torch.as_tensor(idx_np, device=dev)
        ok = torch.as_tensor(ok_np, device=dev) & (torch.gather(scores.detach().clamp(0.0, 1.0), 1, idx) >= tau)
        for n, k in enumerate(slots):
            cpg = compute_cpg(scores, images, idx[:, k], ok[:, k].float(), retain_graph=n + 1 < len(slots))
            out.scatter_reduce_(1, idx[:, k, None, None, None].expand(b, 1, h, w), cpg[:, None], reduce="amax")
    return out, len(slots)


def make_cpg_batch_transform(model, csc_max_iter: int, num_classes: int):
    """The trainer's ``batch_transform(state, batch, iteration)`` (JAX
    :350): until ``iteration`` passes ``csc_max_iter`` (WSL.CSC_MAX_ITER;
    the iteration counts mini-batches, as the JAX trainer's), the batch with
    its ``cpg`` maps; afterwards the batch as it is, and the heads fall back
    to the plain MIL loss."""

    def transform(state, batch, iteration):
        if iteration > csc_max_iter or "gt_classes" not in batch:
            return batch
        return dict(batch, cpg=class_peak_gradients(model, batch, num_classes)[0])

    return transform
