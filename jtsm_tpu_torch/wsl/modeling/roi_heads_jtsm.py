"""JTSMROIHeads, the joint thing-and-stuff mining heads (reference:
projects/WSL/wsl/modeling/roi_heads/roi_heads_jtsm.py:198; JAX package
``wsl/modeling/roi_heads_jtsm.py:131`` ``from_config`` :170, ``__call__``
:238-348, ``_joint_labels`` :351, ``_losses`` :366, ``_mine_sem_seg`` :476,
``_mask_losses`` :520, ``_inference`` :640, ``_mask_probs`` :706,
``forward_with_given_boxes`` :724).

Per image, the precomputed proposals are pooled on the first input map by
MOIPool (superpixel-masked max pool; RoIPool without superpixels), each
ROI's features are scaled by P^2 / (nonempty bins + 1) and, under
``WSL.USE_OBN``, by (objectness + 1), then go through the DAN, the MIL
layers and the refinement branches.

Inference: detections average the branches' softmax and their
class-specific deltas before one decode, then take ``wsl_inference``. Masks
come from the refinery heads' mean logits over the mask pooler (ROIAlignV2
on the one map: K1 on the card), or, with ``WSL.TEST_NO_PASTE``, as the
union of the source proposal's superpixels at image resolution.

Training (``train=True``) returns ``(aux, losses)`` as the JAX heads do:
the image-level MIL loss over the joint thing and stuff classes; for each
refinement branch, the cross entropy and class-specific box regression
against the pseudo ground truth (PGT) mined from the previous branch (the
MIL scores for the first), with batch-level normalisers; the pseudo
sem-seg map painted from the stuff classes' top proposals (``aux``); and
the mask losses: the top proposal of each present thing class and its
IoU-nearest neighbours, capped at ``WSL.MASK_CAPACITY`` an image, with the
union of each ROI's superpixels as its target, train the class-agnostic
base head, and each refinery head trains on the previous head's
thresholded prediction. Mining reads detached scores and boxes, as the
JAX package's ``stop_gradient`` calls do; the image-level probabilities
that weight the refinement losses keep their gradient. Mining stays on the
device: nothing is read back to the host.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ...layers import ShapeSpec, compute_dtype
from ...modeling.poolers import ROIPooler
from ...modeling.proposal_generator.proposal_utils import topk_stable
from ...modeling.roi_heads.mask_head import build_mask_head, mask_rcnn_inference, mask_rcnn_loss
from ...ops.box_regression import Box2BoxTransform
from ...structures.boxes import pairwise_iou
from ..ops import moi_pool, moi_pool_exact, roi_pool, sample_membership_grid, superpixel_membership_grid
from .mil_heads import (
    MILOutputLayers,
    OICROutputLayers,
    branch_average,
    get_pgt_top_k,
    mil_image_loss,
    oicr_refine_losses,
    wsddn_scores,
)
from .roi_heads_wsl import DiscriminativeAdaptionNeck, image_level_gt, image_level_gt_stuff, wsl_inference


def _mask_logits(head, x):
    """WSL mask heads return (logits, features); the core head logits."""
    out = head(x)
    return out[0] if isinstance(out, tuple) else out


def _crop_rows(boxes: torch.Tensor, lo: int, hi: int, mask_size: int, limit: int) -> torch.Tensor:
    """(..., 4) boxes -> (..., mask_size) integer pixel coordinates of the
    crop's cell centres along the axis of ``boxes[..., lo]`` and
    ``boxes[..., hi]``, truncated and clamped into [0, limit). The cell
    centres are (i + 0.5) times the float32 reciprocal of ``mask_size``, the
    product XLA makes of the JAX package's division by a constant."""
    i = torch.arange(mask_size, dtype=torch.float32, device=boxes.device)
    centres = (i + 0.5) * torch.full((), float(np.float32(1) / np.float32(mask_size)), device=boxes.device)
    a, b = boxes[..., lo : lo + 1], boxes[..., hi : hi + 1]
    return (a + centres * (b - a)).to(torch.int32).clamp(0, limit - 1)


def superpixel_union_mask_crop(
    superpixels: torch.Tensor,  # (Hs, Ws) int
    oh_labels_r: torch.Tensor,  # (S,) membership of one proposal
    box: torch.Tensor,  # (4,)
    mask_size: int,
) -> torch.Tensor:
    """(mask_size, mask_size) bool: the union of one proposal's member
    superpixels, read at the pixels of its box's cell centres (JAX :65)."""
    return superpixel_union_mask_crops(superpixels[None], oh_labels_r[None, None], box[None, None], mask_size, 1)[0, 0]


def superpixel_union_mask_crops(
    superpixels: torch.Tensor,  # (B, Hs, Ws) int
    oh_sel: torch.Tensor,  # (B, D, S) membership rows of the mined proposals
    boxes: torch.Tensor,  # (B, D, 4)
    mask_size: int,
    grid_stride: int = 4,
) -> torch.Tensor:
    """(B, D, mask_size, mask_size) bool object evidence (JAX :90): the
    union of each ROI's member superpixels at its box's cell centres. With
    ``grid_stride`` g > 1 the superpixel map is read at the centres of its
    stride-g cells (``wsl.ops.superpixel_membership_grid``) and an id
    outside [0, S) belongs to no proposal; g <= 1 reads each pixel, and an
    id past S reads the last membership entry, as the JAX gather clamps
    it."""
    b, d = boxes.shape[:2]
    hs, ws = superpixels.shape[1:]
    ys = _crop_rows(boxes, 1, 3, mask_size, hs)  # (B, D, M)
    xs = _crop_rows(boxes, 0, 2, mask_size, ws)
    if grid_stride <= 1:
        bi = torch.arange(b, device=boxes.device)[:, None, None, None]
        sp = superpixels[bi, ys.long()[..., :, None], xs.long()[..., None, :]].long()  # (B, D, M, M)
        s = oh_sel.shape[-1]
        ids = sp.clamp(0, s - 1).reshape(b, d, -1)
        return torch.gather(oh_sel.bool(), 2, ids).reshape(b, d, mask_size, mask_size)
    g = int(grid_stride)
    mask_g = torch.stack([superpixel_membership_grid(superpixels[i], oh_sel[i], g) for i in range(b)])
    member = sample_membership_grid(
        mask_g.reshape((b * d,) + mask_g.shape[2:]), (ys // g).reshape(b * d, -1), (xs // g).reshape(b * d, -1)
    )
    return (member >= 0.5).reshape(b, d, mask_size, mask_size)


class JTSMROIHeads(nn.Module):
    def __init__(self, cfg, input_shape: Dict[str, ShapeSpec], mine_sem_seg: bool = True):
        """``mine_sem_seg``: paint the pseudo sem-seg map in training. The
        JAX package always paints it, and jit drops it where the stuff head
        takes no loss; the meta-architecture passes False for such a head."""
        super().__init__()
        self.in_features = tuple(cfg.MODEL.ROI_HEADS.IN_FEATURES)
        first = input_shape[self.in_features[0]]
        self.num_classes = cfg.MODEL.ROI_HEADS.NUM_CLASSES
        self.num_classes_stuff = cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES
        self.spatial_scale = 1.0 / first.stride
        self.pool_size = cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION
        self.sampling_ratio = cfg.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO
        w = cfg.WSL
        self.refine_num = w.REFINE_NUM
        self.refine_mist = w.REFINE_MIST
        self.sp_on = w.SP_ON
        self.sp_grid_stride = w.SP_GRID_STRIDE
        self.moi_pool_exact = w.MOI_POOL_EXACT
        self.moi_nonneg = w.MOI_NONNEG_FEATURES
        self.ps_on = w.PS_ON
        self.use_obn = w.USE_OBN
        self.mean_loss = w.MEAN_LOSS
        self.test_no_paste = w.TEST_NO_PASTE
        self.mask_on = cfg.MODEL.MASK_ON
        self.mask_mined_top_k = w.MASK_MINED_TOP_K
        self.mask_capacity = w.MASK_CAPACITY
        self.object_evidence_mode = w.OBJECT_EVIDENCE
        self.mine_sem_seg = mine_sem_seg
        # the pseudo sem-seg map is painted at the stuff head's stride
        self.pgt_stride = cfg.MODEL.SEM_SEG_HEAD.COMMON_STRIDE if w.PS_ON else 1
        self.sem_seg_ignore = cfg.MODEL.SEM_SEG_HEAD.IGNORE_VALUE
        self.score_thresh_test = cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST
        self.nms_thresh_test = cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST
        self.detections_per_image = cfg.TEST.DETECTIONS_PER_IMAGE
        self.box2box_transform = Box2BoxTransform(weights=cfg.MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS)

        dt = compute_dtype(cfg)
        p = self.pool_size
        self.dan = DiscriminativeAdaptionNeck(first.channels * p * p, cfg.MODEL.ROI_BOX_HEAD.DAN_DIM, 0.5, dt)
        joint = self.num_classes + self.num_classes_stuff - 1
        self.mil = MILOutputLayers(self.dan.output_size, joint, dt)
        refine_reg = tuple(w.REFINE_REG[: self.refine_num])
        self.refine = []
        for k in range(self.refine_num):
            branch = OICROutputLayers(
                self.dan.output_size, self.num_classes,
                with_reg=refine_reg[k] if k < len(refine_reg) else False,
                reg_classes=self.num_classes, compute_dtype=dt,
            )
            self.add_module(f"refine{k}", branch)
            self.refine.append(branch)

        self.mask_refinery: List[nn.Module] = []
        self.mask_head = None
        if self.mask_on:
            res = cfg.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION
            self.mask_size = 2 * res
            shape = ShapeSpec(channels=first.channels, height=res, width=res)
            # the base head is class-agnostic; the refinery heads keep the
            # config's setting (reference :440-460)
            cfg_base = cfg.clone()
            cfg_base.defrost()
            cfg_base.MODEL.ROI_MASK_HEAD.CLS_AGNOSTIC_MASK = True
            self.mask_head = build_mask_head(cfg_base, shape)
            for i in range(cfg.WSL.MASK_REFINE_NUM):
                head = build_mask_head(cfg, shape)
                self.add_module(f"mask_refinery_{i}", head)
                self.mask_refinery.append(head)
            self.mask_pooler = ROIPooler(
                output_size=res,
                scales=tuple(1.0 / input_shape[f].stride for f in self.in_features),
                sampling_ratio=cfg.MODEL.ROI_MASK_HEAD.POOLER_SAMPLING_RATIO,
                pooler_type="ROIAlignV2",
            )

    def pool(self, feat, proposals, superpixels=None, oh_labels=None):
        """(B, H, W, C) map and (B, R, 4) proposals -> pooled (B*R, P, P, C)
        and the (B, R) count of nonempty bins."""
        b, r = proposals.shape[:2]
        p = self.pool_size
        pooled, nonempty = [], []
        for i in range(b):
            if self.sp_on and superpixels is not None and oh_labels is not None:
                if self.moi_pool_exact:
                    out, bins = moi_pool_exact(
                        feat[i], proposals[i], superpixels[i], oh_labels[i], self.spatial_scale, p
                    )
                else:
                    out, bins = moi_pool(
                        feat[i], proposals[i], superpixels[i], oh_labels[i], self.spatial_scale, p,
                        self.sampling_ratio, self.sp_grid_stride, self.moi_nonneg,
                    )
                    bins = bins > 0  # bins with any member sample
            else:
                out, bins = roi_pool(feat[i], proposals[i], self.spatial_scale, p)
            pooled.append(out)
            nonempty.append(bins.sum(dim=(1, 2)).float())
        return torch.cat(pooled).reshape(b * r, p, p, -1), torch.stack(nonempty)

    def forward(
        self,
        features: Dict[str, torch.Tensor],  # NCHW maps
        proposals: torch.Tensor,  # (B, R, 4)
        proposal_scores: torch.Tensor,  # (B, R), non-finite on padding
        image_sizes: torch.Tensor,  # (B, 2)
        superpixels: Optional[torch.Tensor] = None,  # (B, Hs, Ws)
        oh_labels: Optional[torch.Tensor] = None,  # (B, R, S)
        targets: Optional[Dict[str, torch.Tensor]] = None,  # gt_classes, gt_valid[, gt_sem_seg]
        train: bool = False,
        generator: Optional[torch.Generator] = None,  # the DAN's dropout draws
    ):
        """Detections, or with ``train`` the pair (aux, losses)."""
        feat = features[self.in_features[0]].permute(0, 2, 3, 1)  # NHWC view
        pooled, nonempty = self.pool(feat, proposals, superpixels, oh_labels)
        if not train:
            branches = self.refine_branches(pooled, nonempty, proposal_scores)
            det = self.detect(proposals, proposal_scores, branches, image_sizes)
            return self.add_masks(det, features, superpixels, oh_labels)
        mil, branches = self.train_outputs(pooled, nonempty, proposal_scores, generator)
        losses, aux, mined = self.mine(proposals, proposal_scores, mil, branches, targets, superpixels, oh_labels)
        if mined is not None:
            losses.update(self.mask_losses(features, mined))
        return aux, losses

    def box_features(self, pooled, nonempty, proposal_scores, generator=None):
        """The mask-area and objectness rescale, then the DAN: (B*R, D)."""
        b, r = proposal_scores.shape
        p = self.pool_size
        feat_scale = torch.full_like(nonempty, p * p) / (nonempty + 1.0)
        if self.use_obn:
            valid = torch.isfinite(proposal_scores)
            obj = torch.where(valid, proposal_scores, torch.zeros_like(proposal_scores))
            feat_scale = feat_scale * (obj + 1.0)
        return self.dan(pooled * feat_scale.reshape(b * r, 1, 1, 1).to(pooled.dtype), generator)

    def branch_outputs(self, x, b, r):
        """[(logits (B, R, K+1), deltas (B, R, 4K) or None)] of the
        refinement branches."""
        branches = []
        for head in self.refine:
            logits, deltas = head(x)
            branches.append((logits.reshape(b, r, -1), None if deltas is None else deltas.reshape(b, r, -1)))
        return branches

    def refine_branches(self, pooled, nonempty, proposal_scores):
        """Inference: the DAN and the refinement branches."""
        b, r = proposal_scores.shape
        return self.branch_outputs(self.box_features(pooled, nonempty, proposal_scores), b, r)

    def train_outputs(self, pooled, nonempty, proposal_scores, generator=None):
        """Training: the DAN (with dropout), the (B, R, joint classes) MIL
        scores and the refinement branches."""
        b, r = proposal_scores.shape
        x = self.box_features(pooled, nonempty, proposal_scores, generator)
        cls_logit, det_logit = self.mil(x)
        mil = wsddn_scores(cls_logit.reshape(b, r, -1), det_logit.reshape(b, r, -1), torch.isfinite(proposal_scores))
        return mil, self.branch_outputs(x, b, r)

    # -- training ----------------------------------------------------------

    def _joint_labels(self, targets, b, device):
        """(B, things + stuff - 1) image labels: the thing classes of the
        ground truth, then the stuff classes present in ``gt_sem_seg`` but
        class 0 ("things"); no stuff without ``WSL.PS_ON`` or a map."""
        thing = image_level_gt(targets["gt_classes"], targets["gt_valid"], self.num_classes)
        if self.ps_on and "gt_sem_seg" in targets:
            stuff = image_level_gt_stuff(targets["gt_sem_seg"], self.num_classes_stuff, self.sem_seg_ignore)[:, 1:]
        else:
            stuff = torch.zeros((b, self.num_classes_stuff - 1), device=device)
        return torch.cat([thing, stuff], dim=1)

    def mine(self, proposals, proposal_scores, mil, branches, targets, superpixels=None, oh_labels=None):
        """The MIL loss, the refinement cascade with its mining and losses,
        the pseudo sem-seg painting and the mask mining: returns (losses,
        aux, the mined mask ROIs or None)."""
        b = proposal_scores.shape[0]
        ct = self.num_classes
        valid = torch.isfinite(proposal_scores)
        img_labels = self._joint_labels(targets, b, proposals.device)
        losses = {"loss_mil": mil_image_loss(mil, img_labels, self.mean_loss).mean()}
        # image-level class probabilities: the weights of every top-k
        # mining step (reference predict_probs_img, fast_rcnn_tsm.py:840)
        img_probs = mil.sum(dim=1).clamp(1e-6, 1.0 - 1e-6)
        # the cascade runs over the thing classes; stuff is MIL-only
        refine, source, src_boxes = oicr_refine_losses(
            proposals, valid, mil[:, :, :ct], branches, img_labels[:, :ct], img_probs[:, :ct],
            self.box2box_transform, self.refine_mist,
        )
        losses.update(refine)

        aux = {}
        if self.ps_on and self.mine_sem_seg and superpixels is not None:
            st = self.pgt_stride
            aux["pgt_sem_seg"] = self._mine_sem_seg(
                proposals, valid, mil.detach(), img_labels, superpixels[:, ::st, ::st], oh_labels
            )
            aux["pgt_sem_seg_stride"] = st
        mined = None
        if self.mask_on and superpixels is not None:
            mined = self._mine_masks(
                proposals, valid, source.detach(), img_labels, superpixels, oh_labels, img_probs,
                src_boxes.detach(),
            )
        return losses, aux, mined

    def _mine_sem_seg(self, proposals, valid, mil, img_labels, superpixels, oh_labels):
        """(B, hs, ws) int32 pseudo sem-seg labels (JAX :476): the top
        proposal of each present stuff class paints its superpixels with the
        class's value (1 + its stuff index), the highest mined score winning
        a superpixel; a present class painted over entirely is painted back,
        in class order; the rest stays 0 ("things")."""
        b = proposals.shape[0]
        ct = self.num_classes
        cs = self.num_classes_stuff - 1
        pgt = get_pgt_top_k(proposals, mil[:, :, ct:], valid, img_labels[:, ct:], 1)
        ridx = pgt["idx"][:, :, 0]  # (B, Cs)
        present = pgt["valid"][:, :, 0]
        score = pgt["score"][:, :, 0]
        s = oh_labels.shape[-1]
        ohc = torch.gather(oh_labels.bool(), 1, ridx[..., None].expand(b, cs, s))  # (B, Cs, S)
        covers = ohc & present[..., None]
        w_sp = torch.where(covers, score[..., None], torch.full_like(ohc, float("-inf"), dtype=score.dtype))
        win = w_sp.argmax(dim=1)  # (B, S), the first maximum
        out_sp = torch.where(covers.any(dim=1), win + 1, torch.zeros_like(win)).to(torch.int32)
        for c in range(cs):
            absent = ~(out_sp == c + 1).any(dim=-1, keepdim=True)
            out_sp = torch.where(absent & covers[:, c], torch.full_like(out_sp, c + 1), out_sp)
        ids = superpixels.reshape(b, -1).long().clamp(0, s - 1)
        return torch.gather(out_sp, 1, ids).reshape(superpixels.shape)

    def _mine_masks(self, proposals, valid, scores, img_labels, superpixels, oh_labels, img_probs, src_boxes):
        """The mask ROIs of each image (JAX :551-611): the top proposal of
        each present thing class (from the last branch's scores and boxes,
        weighted by the image probabilities) and its ``WSL.MASK_MINED_TOP_K``
        IoU-nearest valid proposals with IoU >= 0.5, ranked by weight and cut
        at ``WSL.MASK_CAPACITY``; each carries its class and its superpixel
        union as target. Returns (B, cap) ``boxes`` (with a trailing 4),
        ``classes``, ``ok``, ``idx`` and (B, cap, M, M) ``targets``."""
        if self.object_evidence_mode == "grabcut":
            raise NotImplementedError("WSL.OBJECT_EVIDENCE 'grabcut' (host GrabCut evidence) is not ported yet")
        b, r = valid.shape
        ct = self.num_classes
        k_nn = max(1, min(self.mask_mined_top_k, r))
        cm = min(self.mask_capacity, ct * k_nn)
        pgt = get_pgt_top_k(src_boxes, scores[:, :, :ct], valid, img_labels[:, :ct], 1, img_probs[:, :ct])
        pboxes = pgt["boxes"][:, :, 0]  # (B, Ct, 4)
        pw = pgt["weight"][:, :, 0].detach()
        pvalid = pgt["valid"][:, :, 0] & (pw > 0)
        # the PGT proposal itself is its own first neighbour (IoU 1)
        iou = pairwise_iou(pboxes, proposals)  # (B, Ct, R)
        iou = torch.where(valid[:, None, :], iou, torch.full_like(iou, -1.0))
        nbr_iou, nbr_idx = topk_stable(iou, k_nn)  # (B, Ct, K)
        cand_ok = pvalid[..., None] & (nbr_iou >= 0.5)
        cand_w = torch.where(cand_ok, pw[..., None], torch.zeros_like(nbr_iou)).reshape(b, ct * k_nn)
        topw, sel = topk_stable(cand_w, cm)  # the capacity cap
        ridx = torch.gather(nbr_idx.reshape(b, -1), 1, sel)
        ok = torch.gather(cand_ok.reshape(b, -1), 1, sel) & (topw > 0)
        boxes = torch.gather(proposals, 1, ridx[..., None].expand(b, cm, 4))
        s = oh_labels.shape[-1]
        members = torch.gather(oh_labels.bool(), 1, ridx[..., None].expand(b, cm, s))
        targets = superpixel_union_mask_crops(superpixels, members, boxes, self.mask_size, self.sp_grid_stride)
        return {"boxes": boxes, "classes": sel // k_nn, "ok": ok, "idx": ridx, "targets": targets}

    def mask_losses(self, features, mined) -> Dict[str, torch.Tensor]:
        """The mask pooler on the mined ROIs (K1 on the card, K2 in its
        backward when the maps train), the base head's loss on the
        superpixel targets and each refinery head's on the previous head's
        prediction at 0.5 (reference get_pgt_mask :1997)."""
        feats = [features[f] for f in self.in_features]
        b, cm = mined["classes"].shape
        batch_idx = torch.arange(b, dtype=torch.int32, device=mined["boxes"].device).repeat_interleave(cm)
        mask_feats = self.mask_pooler(feats, mined["boxes"].reshape(b * cm, 4), batch_idx)
        cls = mined["classes"].reshape(-1)
        ok = mined["ok"].reshape(-1)
        targets = mined["targets"].reshape(b * cm, self.mask_size, self.mask_size).float()
        logits = _mask_logits(self.mask_head, mask_feats)
        losses = {"loss_mask": mask_rcnn_loss(logits, cls, targets, ok)}
        prev = logits
        for kk, head in enumerate(self.mask_refinery):
            self_t = mask_rcnn_inference(prev.detach(), cls)
            logits_k = _mask_logits(head, mask_feats)
            losses[f"loss_mask_r{kk}"] = mask_rcnn_loss(logits_k, cls, (self_t >= 0.5).float(), ok)
            prev = logits_k
        return losses

    # -- inference ---------------------------------------------------------

    def detect(self, proposals, proposal_scores, branches, image_sizes) -> Dict[str, torch.Tensor]:
        """The branches' softmax and class-specific deltas averaged before
        one decode (reference fast_rcnn_oicr.py:712-786), then
        ``wsl_inference``."""
        avg, final_boxes = branch_average(proposals, branches, self.num_classes, self.box2box_transform)
        det = wsl_inference(
            final_boxes, avg, torch.isfinite(proposal_scores), image_sizes, self.score_thresh_test,
            self.nms_thresh_test, self.detections_per_image,
        )
        det["proposal_class_scores"] = avg
        return det

    def add_masks(self, det, features, superpixels=None, oh_labels=None) -> Dict[str, torch.Tensor]:
        """The detections' masks: with ``WSL.TEST_NO_PASTE`` each source
        proposal's superpixels at image resolution (reference
        roi_heads_jtsm.py:969-997), else the mask branch's probabilities."""
        if self.test_no_paste and self.sp_on and superpixels is not None and oh_labels is not None:
            b, d = det["prop_idx"].shape
            s = oh_labels.shape[-1]
            members = torch.gather(oh_labels.bool(), 1, det["prop_idx"].long()[..., None].expand(b, d, s))
            det["masks_full"] = torch.stack(
                [members[i][:, superpixels[i].long().clamp(0, s - 1)] for i in range(b)]
            )
            det["no_paste"] = det["valid"]
        elif self.mask_on:
            det["masks"] = self._mask_probs(features, det["boxes"], det["classes"])
        return det

    def _mask_probs(self, features, boxes, classes):
        """(B, D, S, S) mask probabilities of each detection's class, from
        the refinery heads' mean logits (reference :952-960)."""
        b, d = boxes.shape[:2]
        feats = [features[f] for f in self.in_features]
        batch_idx = torch.arange(b, dtype=torch.int32, device=boxes.device).repeat_interleave(d)
        mask_feats = self.mask_pooler(feats, boxes.reshape(b * d, 4), batch_idx)
        heads = self.mask_refinery or [self.mask_head]
        logits = _mask_logits(heads[0], mask_feats)
        for head in heads[1:]:
            logits = logits + _mask_logits(head, mask_feats)
        logits = logits / len(heads)
        probs = mask_rcnn_inference(logits, classes.reshape(-1))
        return probs.reshape(b, d, probs.shape[-2], probs.shape[-1])

    def forward_with_given_boxes(self, features, detections: Dict[str, torch.Tensor]):
        """Only the mask branch, on given detections (the TTA mask re-run,
        reference test_time_augmentation_avg.py:405-428)."""
        detections = dict(detections)
        if self.mask_on:
            detections["masks"] = self._mask_probs(features, detections["boxes"], detections["classes"])
        return detections
