"""Command line of the port's WSL plane (reference:
projects/WSL/tools/train_net.py; JAX package counterpart
``projects/WSL/tools/train_net.py:24-92``):

    python -m jtsm_tpu_torch.wsl.train_net --config-file CFG.yaml \
        [--resume] [--eval-only] [--device cpu] [KEY VALUE ...]

Training runs ``Trainer``: ``engine.DefaultTrainer`` with the WSL train
loader (MCG proposals with their superpixels, ``build_wsl_train_loader``)
and WSL.ITER_SIZE mini-batches to an update (the mean of their
gradients, as the JAX package's ``optax.MultiSteps``; SOLVER.MAX_ITER
counts mini-batches, the schedule counts updates). The CPG batch
transform of the CSC heads is not ported (those heads are not).

``--eval-only`` builds the model on the card (or ``--device``) from the
WSL config, loads MODEL.WEIGHTS (or with ``--resume`` the newest
checkpoint of OUTPUT_DIR), scores it on DATASETS.TEST through the WSL
test loader (MCG
proposals with their superpixels, ``build_wsl_test_loader``) and the
evaluators of the dataset's type (VOC AP and CorLoc for a Pascal VOC
set), fuses panoptic outputs on the way
(``engine.defaults.test``) and checks TEST.EXPECTED_RESULTS. With
TEST.AUG.ENABLED (every shipped WSL yaml) it scores through
``test_with_TTA``: the views' scores and sem-seg logits averaged over the
fixed proposals (TTA-AVG) and the masks re-run on the merged boxes.
Datasets and proposal files resolve under ``$JTSM_DATASETS``.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..config import wsl_cfg
from ..data import MetadataCatalog, get_detection_dataset_dicts
from ..data.detection_utils import record_image
from ..engine import defaults as engine_defaults
from ..engine import DefaultTrainer, test
from ..evaluation import (
    COCOEvaluator,
    COCOPanopticEvaluator,
    DatasetEvaluators,
    PascalVOCDetectionEvaluator,
    SemSegEvaluator,
    verify_results,
)
from ..evaluation.evaluator import add_time
from ..modeling import build_model
from ..modeling.meta_arch.panoptic_fpn import panoptic_fusion_postprocess
from ..modeling.test_time_augmentation import GeneralizedRCNNWithTTAAVG
from ..structures import BoxMode
from ..tools.train_net import argument_parser, configure_logging, load_weights, setup
from .data import build_wsl_test_loader, build_wsl_train_loader, load_mcg_proposals_into_dataset


def build_test_loader(cfg, dataset_name: str):
    return build_wsl_test_loader(cfg, dataset_name, batch_size=max(1, cfg.TEST.IMS_PER_BATCH))


def build_evaluator(cfg, dataset_name: str, timings: Optional[Dict[str, float]] = None):
    """As the JAX command chooses (``projects/WSL/tools/train_net.py:
    74-95``): VOC AP and CorLoc for a ``pascal_voc`` dataset; COCO for a
    ``coco`` one; COCO, SemSeg and panoptic quality for a
    ``coco_panoptic_seg`` one."""
    output_folder = os.path.join(cfg.OUTPUT_DIR, "inference")
    evaluator_type = MetadataCatalog.get(dataset_name).get("evaluator_type", "coco")
    if evaluator_type == "pascal_voc":
        return PascalVOCDetectionEvaluator(dataset_name, timings=timings)
    if evaluator_type not in ("coco", "coco_panoptic_seg"):
        raise NotImplementedError(f"no evaluator ported yet for {dataset_name} ({evaluator_type})")
    evaluators = [COCOEvaluator(dataset_name, output_dir=output_folder, timings=timings)]
    if evaluator_type == "coco_panoptic_seg":
        evaluators.append(SemSegEvaluator(dataset_name, output_dir=output_folder, timings=timings))
        evaluators.append(COCOPanopticEvaluator(dataset_name, output_folder, timings=timings))
    return evaluators[0] if len(evaluators) == 1 else DatasetEvaluators(evaluators)


def tta_records(cfg):
    """(dataset name, records with their proposals) of each set the WSL
    TTA scores: DATASETS.TEST and, under TEST.EVAL_TRAIN, the train sets
    that are not test sets (the WSOD habit of scoring the train set,
    reference train_net.py:220-253), each with its proposal file."""
    def proposal_file(files, i):
        return files[i] if files else None

    sets = [(n, proposal_file(cfg.DATASETS.PROPOSAL_FILES_TEST, i)) for i, n in enumerate(cfg.DATASETS.TEST)]
    if cfg.TEST.EVAL_TRAIN:
        sets += [(n, proposal_file(cfg.DATASETS.PROPOSAL_FILES_TRAIN, i)) for i, n in enumerate(cfg.DATASETS.TRAIN)
                 if n not in cfg.DATASETS.TEST]
    loader = load_mcg_proposals_into_dataset if cfg.WSL.SP_ON else None
    return [(n, get_detection_dataset_dicts([n], [f] if f is not None else None, loader)) for n, f in sets]


def tta_inputs(cfg, d):
    """A record's TTA inputs (JAX package ``projects/WSL/tools/train_net.py:
    185-218``): the float32 image, its proposals ordered by objectness and
    cut to PRECOMPUTED_PROPOSAL_TOPK_TEST, then padded to it with zero
    boxes and -inf logits, the membership rows of the kept ones padded to
    WSL.MAX_SUPERPIXELS, and the superpixel ids clipped below it."""
    topk, s_cap = cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST, cfg.WSL.MAX_SUPERPIXELS
    image = record_image(d, cfg.INPUT.FORMAT).astype(np.float32)
    boxes = np.asarray(d.get("proposal_boxes", np.zeros((0, 4))), np.float32)
    if len(boxes):
        boxes = BoxMode.convert(boxes, d.get("proposal_bbox_mode", BoxMode.XYXY_ABS), BoxMode.XYXY_ABS)
        boxes = boxes.astype(np.float32, copy=False)
    logits = np.asarray(d.get("proposal_objectness_logits", np.zeros((0,))), np.float32)
    order = np.argsort(-logits)[:topk]
    boxes, logits = boxes[order], logits[order]
    oh = d.get("proposal_oh_labels")
    if oh is not None:
        oh = np.asarray(oh, bool)[order]
        oh_pad = np.zeros((topk, s_cap), bool)
        oh_pad[: len(oh), : min(oh.shape[1], s_cap)] = oh[:, :s_cap]
        oh = oh_pad
    superpixels = d.get("proposal_superpixels")
    if superpixels is not None:
        superpixels = np.clip(np.asarray(superpixels, np.int32), 0, s_cap - 1)
    pad = topk - len(boxes)
    if pad > 0:
        boxes = np.concatenate([boxes, np.zeros((pad, 4), np.float32)])
        logits = np.concatenate([logits, np.full((pad,), -np.inf, np.float32)])
    return image, boxes, logits, superpixels, oh


def test_with_TTA(cfg, model, timings: Optional[Dict[str, float]] = None,
                  build_evaluator=build_evaluator):
    """Scores a WSL model with test-time augmentation (JAX package
    ``projects/WSL/tools/train_net.py:127-264``). Over precomputed
    proposals, TTA-AVG (``GeneralizedRCNNWithTTAAVG``) on each record of
    ``tta_records``; its detections, re-run masks and ``sem_seg`` (the
    argmax of the merged logits) go to the evaluators, through the
    panoptic fusion at the original size on a ``coco_panoptic_seg`` set
    under MODEL.PANOPTIC_FPN.COMBINE.ENABLED. Other proposal generators
    take the union TTA of ``engine.defaults.test_with_TTA``. ``timings``
    gathers the wrapper's stages, ``fusion`` and the evaluators'."""
    if cfg.MODEL.PROPOSAL_GENERATOR.NAME != "PrecomputedProposals":
        return engine_defaults.test_with_TTA(cfg, model, timings)
    tta = GeneralizedRCNNWithTTAAVG(model.inference, **engine_defaults.tta_wrapper_args(cfg, model, timings))
    combine = cfg.MODEL.PANOPTIC_FPN.COMBINE

    def score(d, dataset_name):
        image, boxes, logits, superpixels, oh = tta_inputs(cfg, d)
        merged = tta(image, boxes, logits, model.inference, score_thresh=cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST,
                     nms_thresh=cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST, topk=cfg.TEST.DETECTIONS_PER_IMAGE,
                     superpixels=superpixels, oh_labels=oh)
        det = merged["detections"]
        n = len(det["boxes"])
        outputs = {"boxes": det["boxes"][None], "scores": det["scores"][None], "classes": det["classes"][None],
                   "valid": np.ones((1, n), bool)}
        if "masks" in det:
            # to the model's device, where the evaluators paste them
            outputs["masks"] = torch.as_tensor(det["masks"][None], device=model.device)
        if "sem_seg_logits" in merged:
            outputs["sem_seg"] = np.argmax(merged["sem_seg_logits"], -1)[None]
            if combine.ENABLED and MetadataCatalog.get(dataset_name).get("evaluator_type") == "coco_panoptic_seg":
                t0 = time.perf_counter()
                sizes = np.asarray([[d["height"], d["width"]]])
                outputs = panoptic_fusion_postprocess(
                    dict(outputs, sem_seg_logits=merged["sem_seg_logits"][None]), sizes, sizes,
                    combine.OVERLAP_THRESH, combine.STUFF_AREA_LIMIT, combine.INSTANCES_CONFIDENCE_THRESH)
                add_time(timings, "fusion", time.perf_counter() - t0)
        return outputs

    return engine_defaults.evaluate_datasets(cfg, tta_records(cfg), build_evaluator, timings, score)


def score(cfg, model):
    """Scores ``model`` as the WSL command does: ``test_with_TTA`` under
    TEST.AUG.ENABLED, else ``engine.test`` with the WSL loader and
    evaluators."""
    if cfg.TEST.AUG.ENABLED:
        return test_with_TTA(cfg, model)
    return test(cfg, model, build_test_loader=build_test_loader, build_evaluator=build_evaluator)


class Trainer(DefaultTrainer):
    """The WSL trainer (JAX package ``projects/WSL/tools/train_net.py:24``):
    the WSL train loader, WSL.ITER_SIZE mini-batches to an update, the CPG
    maps of the CSC heads (``wsjds.make_cpg_batch_transform``, until
    WSL.CSC_MAX_ITER), and scoring as the WSL command scores."""

    def __init__(self, cfg, device="cuda"):
        super().__init__(cfg, device=device)
        from .modeling.wsjds import CPG_ROI_HEADS, make_cpg_batch_transform

        if cfg.MODEL.ROI_HEADS.NAME in CPG_ROI_HEADS:
            self._trainer.batch_transform = make_cpg_batch_transform(
                self.model, cfg.WSL.CSC_MAX_ITER, cfg.MODEL.ROI_HEADS.NUM_CLASSES)

    @classmethod
    def build_iter_size(cls, cfg) -> int:
        return max(1, cfg.WSL.ITER_SIZE)

    @classmethod
    def build_train_loader(cls, cfg):
        return build_wsl_train_loader(cfg)

    @classmethod
    def test(cls, cfg, model):
        return score(cfg, model)


def main(args):
    cfg = setup(args, wsl_cfg())
    if not args.eval_only:
        trainer = Trainer(cfg, device=args.device)
        trainer.resume_or_load(resume=args.resume)
        return trainer.train()
    model = build_model(cfg, device=args.device)
    load_weights(model, cfg.MODEL.WEIGHTS, cfg.OUTPUT_DIR, args.resume)
    res = score(cfg, model)
    if cfg.TEST.EXPECTED_RESULTS:
        verify_results(cfg, res)
    return res


if __name__ == "__main__":
    configure_logging()
    main(argument_parser().parse_args())
