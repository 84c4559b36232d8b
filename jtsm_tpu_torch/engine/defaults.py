"""The command line's setup, the trainer and scoring (reference:
detectron2/engine/defaults.py:47 ``default_argument_parser``, :112
``default_setup``, :271 ``DefaultTrainer``, :504 ``DefaultTrainer.test``;
JAX package ``engine/defaults.py:53,72,194,326,363,371,401,473-575``).

Scoring is module-level functions; the functions that build the test
loader and the evaluator are arguments, so that the WSL command
(``wsl/train_net.py``) runs the same loop with its own.

``DefaultTrainer(cfg)`` builds the model on the card (or ``device``), the
train loader, the optimizer of SOLVER.OPTIMIZER and the schedule, and trains with the
hooks of ``build_hooks``: the iteration timer, the learning rate, the
periodic checkpoints, under TEST.PRECISE_BN and with trainable batch
norms PreciseBN every TEST.EVAL_PERIOD iterations, scoring every
TEST.EVAL_PERIOD iterations (none when it is 0, as in the JAX package)
and the writers (the console, ``metrics.json`` and TensorBoard's event
files in OUTPUT_DIR, every 20 iterations). ``resume_or_load()`` loads
MODEL.WEIGHTS or, with ``resume``, the newest checkpoint of OUTPUT_DIR
with the optimizer's and the trainer's state; ``train()`` runs to
SOLVER.MAX_ITER."""

from __future__ import annotations

import argparse
import logging
import os
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional

import numpy as np

from ..checkpoint import DetectionCheckpointer, PeriodicCheckpointer
from ..data import DatasetCatalog, MetadataCatalog, build_detection_test_loader, build_detection_train_loader
from ..data.detection_utils import record_image
from ..evaluation import (
    CityscapesInstanceEvaluator,
    CityscapesSemSegEvaluator,
    COCOEvaluator,
    COCOPanopticEvaluator,
    COCOProposalEvaluator,
    DatasetEvaluators,
    LVISEvaluator,
    PascalVOCDetectionEvaluator,
    SemSegEvaluator,
    inference_on_dataset,
    print_csv_format,
    verify_results,
)
from ..evaluation.evaluator import add_time
from ..layers import batch_norms
from ..modeling import build_model
from ..modeling.meta_arch.panoptic_fpn import panoptic_fusion_postprocess
from ..modeling.test_time_augmentation import GeneralizedRCNNWithTTA
from ..solver import build_lr_schedule, build_optimizer
from ..utils.env import seed_all_rng
from ..utils.events import CommonMetricPrinter, JSONWriter, TensorboardXWriter
from . import hooks
from .trainer import SimpleTrainer, TrainerBase

logger = logging.getLogger(__name__)


def build_test_loader(cfg, dataset_name: str):
    return build_detection_test_loader(cfg, dataset_name, batch_size=max(1, cfg.TEST.IMS_PER_BATCH))


def build_evaluator(cfg, dataset_name: str, timings: Optional[Dict[str, float]] = None):
    """The evaluators of a dataset by its ``evaluator_type``, as the JAX
    package chooses them (``engine/defaults.py:273-312``): on ``coco``,
    ``COCOProposalEvaluator`` for a ``ProposalNetwork`` and ``COCOEvaluator``
    (keypoints with TEST.KEYPOINT_OKS_SIGMAS) for the others, which a
    ``coco_panoptic_seg`` set also gets; ``SemSegEvaluator`` on ``sem_seg``
    and ``coco_panoptic_seg``; ``COCOPanopticEvaluator`` on
    ``coco_panoptic_seg``; ``PascalVOCDetectionEvaluator`` (AP and CorLoc)
    on ``pascal_voc``; ``LVISEvaluator`` on ``lvis``;
    ``CityscapesInstanceEvaluator`` on ``cityscapes_instance`` and
    ``CityscapesSemSegEvaluator`` on ``cityscapes_sem_seg``. Results are
    written under OUTPUT_DIR/inference. One evaluator is returned alone,
    several as ``DatasetEvaluators``; a type with none raises, as in the
    JAX package (``cityscapes_panoptic_seg`` among them: ROADMAP §3)."""
    output_dir = os.path.join(cfg.OUTPUT_DIR, "inference")
    evaluator_type = MetadataCatalog.get(dataset_name).get("evaluator_type", "coco")
    evaluators = []
    if evaluator_type == "coco" and cfg.MODEL.META_ARCHITECTURE == "ProposalNetwork":
        evaluators.append(COCOProposalEvaluator(dataset_name))
    elif evaluator_type in ("coco", "coco_panoptic_seg"):
        evaluators.append(COCOEvaluator(dataset_name, output_dir=output_dir, timings=timings,
                                        kpt_oks_sigmas=cfg.TEST.KEYPOINT_OKS_SIGMAS))
    if evaluator_type in ("sem_seg", "coco_panoptic_seg"):
        evaluators.append(SemSegEvaluator(dataset_name, output_dir=output_dir, timings=timings))
    if evaluator_type == "coco_panoptic_seg":
        evaluators.append(COCOPanopticEvaluator(dataset_name, output_dir=output_dir, timings=timings))
    if evaluator_type == "pascal_voc":
        evaluators.append(PascalVOCDetectionEvaluator(dataset_name, timings=timings))
    if evaluator_type == "lvis":
        evaluators.append(LVISEvaluator(dataset_name, output_dir=output_dir, timings=timings))
    if evaluator_type == "cityscapes_instance":
        evaluators.append(CityscapesInstanceEvaluator(dataset_name))
    if evaluator_type == "cityscapes_sem_seg":
        evaluators.append(CityscapesSemSegEvaluator(dataset_name))
    if not evaluators:
        raise NotImplementedError(f"No evaluator for dataset {dataset_name} with type {evaluator_type}: the JAX "
                                  "package's build_evaluator has none either")
    return evaluators[0] if len(evaluators) == 1 else DatasetEvaluators(evaluators)


def test(cfg, model, evaluators: Optional[List] = None, timings: Optional[Dict[str, float]] = None,
         build_test_loader: Callable = build_test_loader, build_evaluator: Callable = build_evaluator):
    """Scores ``model`` (on its device) on each of DATASETS.TEST; returns
    {dataset: {task: {metric: value}}}, or the one dataset's dict when
    there is one. A final batch that the loader padded is trimmed to its
    real images. On a ``coco_panoptic_seg`` dataset with
    MODEL.PANOPTIC_FPN.COMBINE.ENABLED, the outputs are fused into panoptic
    maps (``panoptic_fusion_postprocess``) before the evaluators see them.
    ``timings`` (optional) gathers the seconds of each stage
    (``evaluation.inference_on_dataset``, ``fusion``, and the evaluators
    built here). With TEST.AUG.ENABLED the model scores through
    ``test_with_TTA``."""
    if cfg.TEST.AUG.ENABLED:
        return test_with_TTA(cfg, model, timings, build_evaluator)
    combine = cfg.MODEL.PANOPTIC_FPN.COMBINE
    results = OrderedDict()
    for idx, dataset_name in enumerate(cfg.DATASETS.TEST):
        data_loader = build_test_loader(cfg, dataset_name)
        evaluator = evaluators[idx] if evaluators is not None else build_evaluator(cfg, dataset_name, timings=timings)
        combine_on = combine.ENABLED and MetadataCatalog.get(dataset_name).get("evaluator_type") == "coco_panoptic_seg"

        def predict(batch):
            out = model.inference({k: v for k, v in batch.items() if k != "image_ids"})
            nreal = len(batch["image_ids"])
            if nreal < batch["image"].shape[0]:
                # the loader padded the final batch with copies: drop them
                out = {k: v[:nreal] for k, v in out.items()}
            return out

        def fuse(batch, out):
            if not (combine_on and "sem_seg_logits" in out and "boxes" in out):
                return out
            t0 = time.perf_counter()
            out = panoptic_fusion_postprocess(out, batch["image_sizes"], batch["orig_sizes"], combine.OVERLAP_THRESH,
                                              combine.STUFF_AREA_LIMIT, combine.INSTANCES_CONFIDENCE_THRESH)
            add_time(timings, "fusion", time.perf_counter() - t0)
            return out

        results[dataset_name] = inference_on_dataset(predict, data_loader, evaluator, timings, postprocess=fuse)
        print_csv_format(results[dataset_name])
    if len(results) == 1:
        results = list(results.values())[0]
    return results


def tta_wrapper_args(cfg, model, timings: Optional[Dict[str, float]] = None) -> Dict:
    """The TTA wrappers' arguments from TEST.AUG and TPU.IMAGE_BUCKETS, on
    ``model``'s device."""
    aug = cfg.TEST.AUG
    return dict(min_sizes=tuple(aug.MIN_SIZES), max_size=aug.MAX_SIZE, flip=aug.FLIP,
                buckets=[tuple(b) for b in cfg.TPU.IMAGE_BUCKETS], device=model.device, timings=timings)


def evaluate_datasets(cfg, datasets, build_evaluator: Callable, timings, score_record: Callable):
    """Each (dataset name, its records) scored image by image:
    ``score_record(record) -> outputs`` (batch of one, original-image
    coordinates) into the dataset's evaluator, the results printed; the
    one dataset's dict when there is one."""
    results = OrderedDict()
    for dataset_name, records in datasets:
        evaluator = build_evaluator(cfg, dataset_name, timings=timings)
        evaluator.reset()
        for d in records:
            inputs = {"image_ids": np.asarray([d.get("image_id", -1)]),
                      "orig_sizes": np.asarray([[d["height"], d["width"]]])}
            evaluator.process(inputs, score_record(d, dataset_name))
            add_time(timings, "images", 1)
        results[dataset_name] = evaluator.evaluate() or {}
        print_csv_format(results[dataset_name])
    if len(results) == 1:
        results = list(results.values())[0]
    return results


def test_with_TTA(cfg, model, timings: Optional[Dict[str, float]] = None,
                  build_evaluator: Callable = build_evaluator):
    """Scores ``model`` with test-time augmentation (JAX package
    ``engine/defaults.py:427``): each image of DATASETS.TEST through
    ``GeneralizedRCNNWithTTA`` (the union of the views' detections and the
    mask re-run), its merged boxes, scores and classes to the evaluator.
    As in the JAX package the masks are not handed on, so a Mask R-CNN
    scores bbox AP only. ``timings`` gathers the wrapper's stages and the
    evaluators'."""
    tta = GeneralizedRCNNWithTTA(model.inference, **tta_wrapper_args(cfg, model, timings))

    def score(d, dataset_name):
        merged = tta(record_image(d, cfg.INPUT.FORMAT).astype(np.float32))
        n = len(merged["boxes"])
        return {"boxes": merged["boxes"][None], "scores": merged["scores"][None],
                "classes": merged["classes"][None], "valid": np.ones((1, n), bool)}

    return evaluate_datasets(cfg, [(n, DatasetCatalog.get(n)) for n in cfg.DATASETS.TEST], build_evaluator,
                             timings, score)


def default_argument_parser(epilog=None) -> argparse.ArgumentParser:
    """The command line of the training scripts (reference
    defaults.py:47): ``--config-file``, ``--resume``, ``--eval-only``,
    ``--device`` (default: the card), KEY VALUE pairs, and detectron2's
    launcher flags, accepted and ignored (one process, one card)."""
    parser = argparse.ArgumentParser(epilog=epilog)
    parser.add_argument("--config-file", default="", metavar="FILE", help="path to config file")
    parser.add_argument("--resume", action="store_true", help="resume from the last checkpoint of OUTPUT_DIR")
    parser.add_argument("--eval-only", action="store_true", help="perform evaluation only")
    parser.add_argument("--device", default="cuda", help="device to run on (default: the card)")
    parser.add_argument("--num-gpus", type=int, default=1, help="ignored: the port runs one process")
    parser.add_argument("--num-machines", type=int, default=1, help="ignored")
    parser.add_argument("--machine-rank", type=int, default=0, help="ignored")
    parser.add_argument("--dist-url", default="auto", help="ignored")
    parser.add_argument("opts", nargs=argparse.REMAINDER, help="KEY VALUE pairs that override the config")
    return parser


def default_setup(cfg, args=None) -> None:
    """Makes OUTPUT_DIR, writes the config into it, and seeds Python's,
    numpy's and PyTorch's generators with SEED (reference defaults.py:112,
    JAX package ``engine/defaults.py:72``)."""
    if cfg.OUTPUT_DIR:
        os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
        with open(os.path.join(cfg.OUTPUT_DIR, "config.yaml"), "w") as f:
            f.write(str(cfg) + "\n")
    if args is not None and getattr(args, "config_file", ""):
        logger.info(f"Contents of args.config_file={args.config_file}")
    seed_all_rng(None if cfg.SEED < 0 else cfg.SEED)


class DefaultTrainer(TrainerBase):
    """Trains the model of ``cfg`` on DATASETS.TRAIN (see the module
    docstring). ``iter_size`` mini-batches go into an update (1 here; the
    WSL trainer takes WSL.ITER_SIZE)."""

    def __init__(self, cfg, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.iter_size = self.build_iter_size(cfg)
        self.model = build_model(cfg, device=device)
        self.data_loader = self.build_train_loader(cfg)
        self.optimizer = build_optimizer(cfg, self.model)
        self.schedule = build_lr_schedule(cfg)
        self._trainer = SimpleTrainer(self.model, self.data_loader, self.optimizer, self.schedule,
                                      seed=max(cfg.SEED, 0), iter_size=self.iter_size)
        self.checkpointer = DetectionCheckpointer(self.model, cfg.OUTPUT_DIR, optimizer=self.optimizer,
                                                  trainer=self._trainer)
        self.start_iter = 0
        self.max_iter = cfg.SOLVER.MAX_ITER
        self.register_hooks(self.build_hooks())

    @classmethod
    def build_iter_size(cls, cfg) -> int:
        return 1

    @classmethod
    def build_train_loader(cls, cfg):
        return build_detection_train_loader(cfg)

    @classmethod
    def test(cls, cfg, model):
        return test(cfg, model)

    def build_hooks(self) -> List[hooks.HookBase]:
        cfg = self.cfg
        if cfg.VIS_PERIOD > 0:
            logger.warning("VIS_PERIOD is not ported; training without the visualization")
        ret = [
            hooks.IterationTimer(),
            hooks.LRScheduler(self.schedule),
            hooks.PeriodicCheckpointerHook(PeriodicCheckpointer(self.checkpointer, cfg.SOLVER.CHECKPOINT_PERIOD,
                                                                cfg.SOLVER.MAX_ITER)),
        ]

        def test_and_save_results():
            self.model.eval()
            try:
                self._last_eval_results = self.test(self.cfg, self.model)
            finally:
                self.model.train()
            return self._last_eval_results

        if cfg.TEST.PRECISE_BN.ENABLED and batch_norms(self.model):
            ret.append(hooks.PreciseBN(cfg.TEST.EVAL_PERIOD, cfg.TEST.PRECISE_BN.NUM_ITER))
        if cfg.TEST.EVAL_PERIOD > 0:
            ret.append(hooks.EvalHook(cfg.TEST.EVAL_PERIOD, test_and_save_results))
        ret.append(hooks.PeriodicWriter(self.build_writers(), period=20))
        return ret

    def build_writers(self):
        return [CommonMetricPrinter(self.max_iter), JSONWriter(os.path.join(self.cfg.OUTPUT_DIR, "metrics.json")),
                TensorboardXWriter(self.cfg.OUTPUT_DIR)]

    def update_precise_bn(self, num_iter: int = 200) -> None:
        """The batch norms' running statistics recomputed over ``num_iter``
        train batches (``SimpleTrainer.update_precise_bn``)."""
        self._trainer.update_precise_bn(num_iter)

    def resume_or_load(self, resume: bool = True) -> None:
        """MODEL.WEIGHTS into the model; with ``resume`` and a checkpoint in
        OUTPUT_DIR, that checkpoint with the optimizer's and the trainer's
        state, and training goes on from the iteration after it. The loader
        starts again from its seed, as in the JAX package."""
        extra = self.checkpointer.resume_or_load(self.cfg.MODEL.WEIGHTS, resume=resume)
        if resume and "iteration" in extra:
            self.start_iter = int(extra["iteration"]) + 1

    def train(self):
        """Trains from ``start_iter`` to SOLVER.MAX_ITER; returns the last
        scoring's results (checked against TEST.EXPECTED_RESULTS), if any."""
        try:
            super().train(self.start_iter, self.max_iter)
        finally:
            self._trainer.close()
        if hasattr(self, "_last_eval_results"):
            verify_results(self.cfg, self._last_eval_results)
            return self._last_eval_results

    def run_step(self):
        self._trainer.iter = self.iter
        self._trainer.storage = self.storage
        self._trainer.run_step()

    @property
    def state(self):
        return self._trainer.state
