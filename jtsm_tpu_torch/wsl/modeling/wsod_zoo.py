"""The WSOD method zoo's heads beyond WSDDN and OICR (reference:
projects/WSL/wsl/modeling/roi_heads/roi_heads_contextlocnet.py,
roi_heads_pcl.py, third_party/pcl.py, roi_heads_cmil.py and
csrc/ROIMerge; JAX package ``wsl/modeling/wsod_zoo.py`` :58
``ContextLocNetROIHeads``, :127 ``build_proposal_clusters``, :188
``PCLROIHeads``, :284 ``roi_merge_lambda``, :294 ``roi_merge``, :371
``CMILROIHeads``). CSC and UWSOD wait (ROADMAP queue 1 item 6).

ContextLocNet: WSDDN whose detection logits contrast each proposal's frame
with its context: ``wsl.ops.roi_loop_pool`` pools the roi, frame and
context regions (no K1), the one DAN and the one pair of MIL layers take
all three, the class logits come from the roi rows and the detection
logits are the frame's minus the context's.

PCL: WSDDN's MIL and WSL.REFINE_NUM refinement branches, each supervised by
proposal clusters mined from the previous branch's detached scores (the
MIL scores for the first): up to 5 cluster centres a present class, every
proposal in its best-overlapping centre's cluster, and the cluster loss of
``wsl.ops.pcl_losses``, averaged over the images. Inference averages the
branches' softmax over the proposals and returns no
``proposal_class_scores``, as the JAX heads do, so TTA-AVG cannot merge it
(``modeling/test_time_augmentation.py`` raises; ROADMAP §3).

CMIL: the WSDDN logits merged over proposal cliques (``roi_merge``, the
cliques found on the host from one copy of the detached objectness and the
IoU among the top 200), WSDDN scores over the cluster rows and their MIL
loss, and WSL.REFINE_NUM branches supervised by ``wsl.ops.roi_label`` from
the previous branch's detached scores (the clusters' for the first).
Inference averages the branches' softmax. ContextLocNet and CMIL return no
``proposal_class_scores`` either."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ...layers import ShapeSpec
from ...modeling.proposal_generator.proposal_utils import topk_stable
from ...ops.box_regression import Box2BoxTransform
from ...ops.losses import smooth_l1_loss
from ...ops.nms import nms_mask
from ...structures.boxes import pairwise_iou
from ..ops import pcl_losses, roi_label, roi_loop_pool
from .mil_heads import OICROutputLayers, branch_average, mil_image_loss, oicr_branch_loss, wsddn_scores
from .roi_heads_wsl import WSDDNROIHeads, image_level_gt, wsl_inference


class ContextLocNetROIHeads(WSDDNROIHeads):
    """ContextLocNet's contrastive head (JAX :58), WSDDN's loss; no GAM,
    and no ``proposal_class_scores`` in its detections."""

    uses_gam = False

    def pool(self, features: Dict[str, torch.Tensor], proposals: torch.Tensor) -> torch.Tensor:
        """NCHW maps and (B, R, 4) proposals -> (3 B*R, P, P, C): the roi,
        frame and context blocks of ``roi_loop_pool``."""
        b, r = proposals.shape[:2]
        feat = features[self.in_features[0]].permute(0, 2, 3, 1)
        bidx = torch.arange(b, dtype=torch.int32, device=proposals.device).repeat_interleave(r)
        return roi_loop_pool(feat, proposals.reshape(b * r, 4), bidx, self.pooler.scales[0],
                             self.pooler.output_size[0])

    def predict(self, x: torch.Tensor, proposal_scores: torch.Tensor):
        """(3 B*R, D) neck rows, roi then frame then context (one DAN pass
        over all three, its dropout drawn in that order) -> the (B, R, C)
        WSDDN scores of the roi rows' class logits and the frame's minus
        the context's detection logits."""
        b, r = proposal_scores.shape
        cls_logit, det_logit = self.mil(x)
        n = b * r
        det = det_logit[n:2 * n] - det_logit[2 * n:]
        return wsddn_scores(cls_logit[:n].reshape(b, r, -1), det.reshape(b, r, -1), torch.isfinite(proposal_scores)), []

    def detect(self, proposals, proposal_scores, mil, branches, image_sizes) -> Dict[str, torch.Tensor]:
        return wsl_inference(proposals, mil, torch.isfinite(proposal_scores), image_sizes, self.score_thresh_test,
                             self.nms_thresh_test, self.detections_per_image)


def build_proposal_clusters(
    boxes: torch.Tensor,  # (B, R, 4)
    source_scores: torch.Tensor,  # (B, R, C)
    valid: torch.Tensor,  # (B, R)
    image_labels: torch.Tensor,  # (B, C)
    num_centers: int = 5,
    iou_thresh: float = 0.4,
) -> Dict[str, torch.Tensor]:
    """The proposal clusters of each image (JAX :127): per class, the top
    ``min(3 * num_centers, R)`` valid proposals, greedy NMS at ``iou_thresh``
    among them, and the ``num_centers`` best survivors as centres (of a
    present class only); each proposal joins the centre it overlaps most
    (the first maximum). IoU >= 0.5 makes it a member (``labels`` its
    class, ``labels_ref`` the class from 1), below 0.1 it weighs nothing in
    the reference's layout (``weights_ref``). Fixed (B, C * num_centers)
    cluster fields ``pc_labels``, ``pc_count`` and
    ``img_cls_loss_weights``."""
    b, r, c = source_scores.shape
    if r < num_centers:
        raise ValueError(f"{r} proposals cannot hold {num_centers} cluster centres a class")
    k = min(num_centers * 3, r)
    masked = torch.where(valid[..., None], source_scores, torch.full_like(source_scores, float("-inf")))
    topv, topi = topk_stable(masked.transpose(1, 2), k)  # (B, C, k)
    cand = torch.gather(boxes, 1, topi.reshape(b, c * k, 1).expand(b, c * k, 4)).reshape(b, c, k, 4)
    keep = nms_mask(cand, topv, iou_thresh)
    pri = torch.where(keep, topv, torch.full_like(topv, float("-inf")))
    cv, ci = topk_stable(pri, num_centers)  # (B, C, K)
    centers = torch.gather(topi, 2, ci)
    ok = torch.isfinite(cv) & (image_labels[..., None] > 0)
    weights = torch.where(ok, cv, torch.zeros_like(cv)).reshape(b, -1)
    g = c * num_centers
    center_boxes = torch.gather(boxes, 1, centers.reshape(b, g, 1).expand(b, g, 4))
    iou = pairwise_iou(boxes, center_boxes)  # (B, R, G)
    iou = torch.where(ok.reshape(b, 1, g), iou, torch.full_like(iou, -1.0))
    best = iou.amax(dim=-1)
    assign = iou.argmax(dim=-1)  # the first maximum, as jnp.argmax
    cls_of_cluster = torch.arange(c, device=boxes.device).repeat_interleave(num_centers)  # (G,)
    assigned_cls = cls_of_cluster[assign]
    fg = best >= 0.5
    w = torch.where(valid, torch.gather(weights, 1, assign), torch.zeros_like(best))
    w_ref = torch.where(best < 0.1, torch.zeros_like(w), w)
    assign_ref = torch.where(fg & valid, assign, torch.full_like(assign, -1))
    member = (assign_ref[..., None] == torch.arange(g, device=boxes.device)).to(w_ref.dtype)  # (B, R, G)
    return {
        "labels": torch.where(fg, assigned_cls, torch.full_like(assigned_cls, c)),
        "weights": w,
        "assignment": assign,
        "center_ok": ok.reshape(b, g),
        "labels_ref": torch.where(fg, assigned_cls + 1, torch.zeros_like(assigned_cls)),
        "weights_ref": w_ref,
        "assignment_ref": assign_ref,
        "pc_labels": (cls_of_cluster + 1)[None].expand(b, g),
        "pc_count": member.sum(dim=1),
        "img_cls_loss_weights": (member * w_ref[..., None]).sum(dim=1),
    }


class PCLROIHeads(WSDDNROIHeads):
    """WSDDN's MIL and the PCL refinement branches ``refine{k}`` (JAX
    :188); no box regression."""

    def __init__(self, cfg, input_shape: Dict[str, ShapeSpec]):
        super().__init__(cfg, input_shape)
        self.refine = []
        for k in range(cfg.WSL.REFINE_NUM):
            branch = OICROutputLayers(self.dan.output_size, self.num_classes,
                                      compute_dtype=self.mil.cls.compute_dtype)
            self.add_module(f"refine{k}", branch)
            self.refine.append(branch)

    def predict(self, x: torch.Tensor, proposal_scores: torch.Tensor):
        mil, _ = super().predict(x, proposal_scores)
        b, r = proposal_scores.shape
        return mil, [(head(x)[0].reshape(b, r, -1), None) for head in self.refine]

    def detect(self, proposals, proposal_scores, mil, branches, image_sizes) -> Dict[str, torch.Tensor]:
        avg, _ = branch_average(proposals, branches, self.num_classes, None)
        return wsl_inference(proposals, avg, torch.isfinite(proposal_scores), image_sizes, self.score_thresh_test,
                             self.nms_thresh_test, self.detections_per_image)

    def losses(self, proposals, proposal_scores, mil, branches, targets, features=None,
               generator=None) -> Dict[str, torch.Tensor]:
        img_labels = image_level_gt(targets["gt_classes"], targets["gt_valid"], self.num_classes)
        losses = {"loss_mil": mil_image_loss(mil, img_labels, self.mean_loss).mean()}
        valid = torch.isfinite(proposal_scores)
        im_labels = torch.cat([torch.ones_like(img_labels[:, :1]), img_labels], dim=1)
        source = mil
        for k, (logits, _) in enumerate(branches):
            clusters = build_proposal_clusters(proposals, source.detach(), valid, img_labels)
            p = torch.softmax(logits, dim=-1)  # (B, R, C + 1), the background last
            p_bg_first = torch.cat([p[..., -1:], p[..., :-1]], dim=-1)
            loss = pcl_losses(
                p_bg_first, clusters["labels_ref"], clusters["weights_ref"], clusters["assignment_ref"],
                clusters["pc_labels"], clusters["pc_count"], clusters["img_cls_loss_weights"], im_labels,
            )
            losses[f"loss_refine_cls{k}"] = loss.mean()
            source = p[..., : self.num_classes]
        return losses


def roi_merge_lambda(cur_iter, max_epoch: float, size_epoch: float) -> float:
    """CMIL's continuation threshold at iteration ``cur_iter`` (JAX :284,
    the reference's ``getlambda``): from 0 at iteration 0 to 1 at
    ``max_epoch`` epochs of ``size_epoch`` iterations, logarithmically; the
    logarithms in float32, as the JAX function computes them from Python
    numbers."""
    f = np.float32
    low = 0.01
    x = cur_iter / size_epoch
    return float((np.log(f(x + low)) - np.log(f(low))) / (np.log(f(max_epoch + low)) - np.log(f(low))))


def _clique_ids(order: np.ndarray, valid: np.ndarray, iou: np.ndarray, r: int, lam: float,
                window: int) -> Tuple[np.ndarray, int]:
    """One image's cluster of each of its ``r`` proposals (JAX :320-343):
    the pivots in ``order`` (the top of the objectness order, its
    ``valid`` rows and their ``iou`` block), each one not yet taken opening
    a clique that the next ``window`` untaken valid candidates join when
    their IoU with every member is at least ``lam``; the rest are
    singletons in index order. Returns the ids and their count."""
    k = order.size
    w = min(window, k)
    pos = [-1] * k
    rows = iou.tolist()
    valid = valid.tolist()
    cur = 0
    for t in range(k):
        if pos[t] != -1 or not valid[t]:
            continue
        pos[t] = cur
        members = [t]
        for u in range(t + 1, min(t + w, k)):
            if pos[u] == -1 and valid[u]:
                row = rows[u]
                if all(row[m] >= lam for m in members):
                    pos[u] = cur
                    members.append(u)
        cur += 1
    ids = np.full(r, -1, np.int64)
    taken = np.asarray(pos) >= 0
    ids[order[taken]] = np.asarray(pos)[taken]
    rest = ids == -1
    ids[rest] = cur + np.arange(int(rest.sum()))
    return ids, cur + int(rest.sum())


def roi_merge_ids(objectness: torch.Tensor, boxes: torch.Tensor, lam: float, top_cap: int = 200,
                  window: int = 40) -> torch.Tensor:
    """The (B, R) cluster ids of ``roi_merge`` (the JAX package's clique
    loop, :320-343): the proposals in descending ``objectness`` order (a
    stable sort; -inf marks padding, which neither pivots nor joins), the
    pivots within the first ``top_cap``, each clique within a ``window``
    of the pivot. The ids carry no gradient: the objectness order, the
    validity and the IoU among the top ``top_cap`` go to the host in one
    copy, the cliques are found there, and the ids come back in one."""
    b, r = objectness.shape
    k = min(top_cap, r)
    obj = objectness.detach()
    order = torch.argsort(-obj, dim=1, stable=True)[:, :k]
    top = torch.gather(boxes.detach().float(), 1, order[..., None].expand(b, k, 4))
    packed = torch.cat([order.float(), torch.isfinite(torch.gather(obj, 1, order)).float(),
                        pairwise_iou(top, top).reshape(b, k * k)], dim=1).cpu().numpy()
    lam = float(np.float32(lam))
    ids = [_clique_ids(row[:k].astype(np.int64), row[k:2 * k] > 0, row[2 * k:].reshape(k, k), r, lam, window)[0]
           for row in packed]
    return torch.from_numpy(np.stack(ids)).to(objectness.device, non_blocking=True)


def roi_merge(
    ids: torch.Tensor,  # (B, R) cluster ids (roi_merge_ids)
    cls_scores: torch.Tensor,  # (B, R, C)
    det_scores: torch.Tensor,  # (B, R, C)
) -> Dict[str, torch.Tensor]:
    """CMIL's ROIMerge (JAX :294, the reference's
    ``csrc/ROIMerge/ROIMerge_cpu.cpp``) given the cluster ids: dense (B, R,
    C) cluster rows, the members' means from the one-hot matrix product
    (rows past the clusters are 0), so that a member's gradient is its
    cluster row's divided by its count; (B, R) ``counts`` and
    ``row_valid`` (the rows that are clusters)."""
    r = ids.shape[1]
    onehot = (ids[..., None] == torch.arange(r, device=ids.device)).to(cls_scores.dtype)  # (B, R, R)
    counts = onehot.sum(dim=1)
    denom = counts.clamp(min=1.0)[..., None]
    num_id = ids.amax(dim=1, keepdim=True) + 1
    return {
        "merged_cls": onehot.transpose(1, 2) @ cls_scores / denom,
        "merged_det": onehot.transpose(1, 2) @ det_scores / denom,
        "ids": ids,
        "counts": counts,
        "row_valid": torch.arange(r, device=ids.device) < num_id,
    }


class CMILROIHeads(WSDDNROIHeads):
    """Continuation MIL (reference roi_heads_cmil.py; JAX :371): the MIL
    loss over the merged cluster rows, and WSL.REFINE_NUM branches
    ``refine{k}`` (a (C+1)-way classifier and, under WSL.REFINE_REG[k],
    class-agnostic deltas) supervised by ``roi_label`` (fg 0.6, bg [0.1,
    0.4), top 1) from the previous branch's detached scores, its class
    weights the clipped image scores of the clusters (with their
    gradient). The continuation threshold is ``roi_merge_lambda`` at
    ``cur_iter`` under WSL.CMIL, and 1.0 (exact duplicates merge) when the
    caller passes none, as ``GeneralizedRCNNWSL`` does in both packages.
    Inference averages the branches' softmax and decodes the last branch's
    deltas; no GAM, no ``proposal_class_scores``. Stages: ``pool``,
    ``dan``, ``predict``, ``merge``, ``label_losses``, ``detect``."""

    uses_gam = False

    def __init__(self, cfg, input_shape: Dict[str, ShapeSpec]):
        super().__init__(cfg, input_shape)
        w = cfg.WSL
        self.max_iter = cfg.SOLVER.MAX_ITER
        self.size_epoch = float(w.SIZE_EPOCH)
        self.continuation_on = w.CMIL
        self.box2box_transform = Box2BoxTransform(weights=cfg.MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS)
        refine_reg = tuple(w.REFINE_REG[: w.REFINE_NUM])
        self.refine: List[OICROutputLayers] = []
        for k in range(w.REFINE_NUM):
            branch = OICROutputLayers(self.dan.output_size, self.num_classes,
                                      with_reg=bool(refine_reg[k]) if k < len(refine_reg) else False,
                                      compute_dtype=self.mil.cls.compute_dtype)
            self.add_module(f"refine{k}", branch)
            self.refine.append(branch)

    def predict(self, x: torch.Tensor, proposal_scores: torch.Tensor):
        """-> ((B, R, C) class and detection logits, the branches'
        [(logits, deltas or None)])."""
        b, r = proposal_scores.shape
        cls_logit, det_logit = self.mil(x)
        branches: List[Tuple[torch.Tensor, Optional[torch.Tensor]]] = []
        for head in self.refine:
            logits, deltas = head(x)
            branches.append((logits.reshape(b, r, -1), None if deltas is None else deltas.reshape(b, r, -1)))
        return (cls_logit.reshape(b, r, -1), det_logit.reshape(b, r, -1)), branches

    def continuation(self, cur_iter=None) -> float:
        if cur_iter is None or not self.continuation_on:
            return 1.0
        return roi_merge_lambda(cur_iter, max(self.max_iter / self.size_epoch, 1.0), self.size_epoch)

    def merge(self, proposals, proposal_scores, logits, cur_iter=None):
        """-> the (B, R, C) WSDDN scores of the cluster rows and of each
        proposal (its cluster's row): the objectness orders the cliques
        (its unmerged WSDDN scores summed over the classes)."""
        cls_logit, det_logit = logits
        valid = torch.isfinite(proposal_scores)
        obn = wsddn_scores(cls_logit, det_logit, valid).sum(dim=-1)
        obn = torch.where(valid, obn, torch.full_like(obn, float("-inf")))
        m = roi_merge(roi_merge_ids(obn, proposals, self.continuation(cur_iter)), cls_logit, det_logit)
        member_valid = torch.zeros_like(m["counts"]).scatter_add_(1, m["ids"], valid.to(m["counts"].dtype))
        cluster = wsddn_scores(m["merged_cls"], m["merged_det"], (member_valid > 0) & m["row_valid"])
        return cluster, torch.gather(cluster, 1, m["ids"][..., None].expand_as(cluster))

    def label_losses(self, proposals, proposal_scores, cluster, prop_scores, branches, targets):
        c = self.num_classes
        valid = torch.isfinite(proposal_scores)
        img_labels = image_level_gt(targets["gt_classes"], targets["gt_valid"], c)
        losses = {"loss_mil": mil_image_loss(cluster, img_labels, self.mean_loss).mean()}
        img_preds = cluster.sum(dim=1).clamp(0.0, 1.0)  # the class weights, with their gradient
        iou = pairwise_iou(proposals, proposals)
        source = prop_scores
        for k, (logits, deltas) in enumerate(branches):
            src = torch.where(valid[..., None], source.detach(), torch.full_like(source, float("-inf")))
            rl = roi_label(src, iou, img_labels, img_preds, fg_threshold=0.6, bg_threshold_hi=0.4,
                           bg_threshold_lo=0.1, top_k=1)
            w = torch.where(valid, rl["weight"], torch.zeros_like(rl["weight"]))
            losses[f"loss_refine_cls{k}"] = oicr_branch_loss(logits, rl["label"], w).mean()
            if deltas is not None:
                mined = torch.gather(proposals, 1, rl["matched_idx"].clamp(min=0)[..., None].expand_as(proposals))
                target = self.box2box_transform.get_deltas(proposals, mined)
                fg_w = w * (rl["label"] < c).to(w.dtype)
                reg = smooth_l1_loss(deltas, target, 0.0).sum(dim=-1)
                losses[f"loss_refine_reg{k}"] = (
                    (reg * fg_w).sum(dim=-1) / (fg_w > 0).sum(dim=-1).float().clamp(min=1.0)).mean()
            source = torch.softmax(logits, dim=-1)[..., :c]
        return losses

    def losses(self, proposals, proposal_scores, mil, branches, targets, features=None, generator=None,
               cur_iter=None) -> Dict[str, torch.Tensor]:
        cluster, prop_scores = self.merge(proposals, proposal_scores, mil, cur_iter)
        return self.label_losses(proposals, proposal_scores, cluster, prop_scores, branches, targets)

    def detect(self, proposals, proposal_scores, mil, branches, image_sizes) -> Dict[str, torch.Tensor]:
        """The detections of the branches' mean softmax (of the proposals'
        cluster scores without branches; the clusters do not change the
        detections otherwise, so serving merges nothing)."""
        b, r = proposal_scores.shape
        boxes = proposals
        if branches:
            scores = sum(torch.softmax(lg, dim=-1)[..., : self.num_classes] for lg, _ in branches) / len(branches)
            last = branches[-1][1]
            if last is not None:
                boxes = self.box2box_transform.apply_deltas(last.reshape(-1, 4), proposals.reshape(-1, 4)).reshape(
                    b, r, 4)
        else:
            scores = self.merge(proposals, proposal_scores, mil)[1]
        return wsl_inference(boxes, scores, torch.isfinite(proposal_scores), image_sizes, self.score_thresh_test,
                             self.nms_thresh_test, self.detections_per_image)
