"""The WSOD method zoo's heads beyond WSDDN and OICR (reference:
projects/WSL/wsl/modeling/roi_heads/roi_heads_pcl.py and
third_party/pcl.py; JAX package ``wsl/modeling/wsod_zoo.py`` :127
``build_proposal_clusters``, :188 ``PCLROIHeads``). ContextLocNet, CMIL,
CSC and UWSOD wait (ROADMAP queue 1 item 6).

PCL: WSDDN's MIL and WSL.REFINE_NUM refinement branches, each supervised by
proposal clusters mined from the previous branch's detached scores (the
MIL scores for the first): up to 5 cluster centres a present class, every
proposal in its best-overlapping centre's cluster, and the cluster loss of
``wsl.ops.pcl_losses``, averaged over the images. Inference averages the
branches' softmax over the proposals and returns no
``proposal_class_scores``, as the JAX heads do, so TTA-AVG cannot merge it
(``modeling/test_time_augmentation.py`` raises; ROADMAP §3)."""

from __future__ import annotations

from typing import Dict

import torch

from ...layers import ShapeSpec
from ...modeling.proposal_generator.proposal_utils import topk_stable
from ...ops.nms import nms_mask
from ...structures.boxes import pairwise_iou
from ..ops import pcl_losses
from .mil_heads import OICROutputLayers, branch_average, mil_image_loss
from .roi_heads_wsl import WSDDNROIHeads, image_level_gt, wsl_inference


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

    def losses(self, proposals, proposal_scores, mil, branches, targets) -> Dict[str, torch.Tensor]:
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
