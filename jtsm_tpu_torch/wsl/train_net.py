"""Command line of the port's WSL plane (reference:
projects/WSL/tools/train_net.py; JAX package counterpart
``projects/WSL/tools/train_net.py:64-92``). Scoring only:

    python -m jtsm_tpu_torch.wsl.train_net --eval-only --config-file CFG.yaml \
        [--device cpu] [KEY VALUE ...]

builds the model on the card (or ``--device``) from the WSL config, loads
MODEL.WEIGHTS, scores it on DATASETS.TEST through the WSL test loader (MCG
proposals with their superpixels, ``build_wsl_test_loader``) and the
evaluators of the dataset's type, fuses panoptic outputs on the way
(``engine.defaults.test``) and checks TEST.EXPECTED_RESULTS. Datasets and
proposal files resolve under ``$JTSM_DATASETS``. Training from this command
waits for the train loader (ROADMAP queue 1).
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Dict, Optional

from ..config import wsl_cfg
from ..data import MetadataCatalog
from ..engine import test
from ..evaluation import COCOEvaluator, COCOPanopticEvaluator, DatasetEvaluators, SemSegEvaluator, verify_results
from ..modeling import build_model
from ..tools.train_net import argument_parser, load_weights, setup
from .data import build_wsl_test_loader


def build_test_loader(cfg, dataset_name: str):
    return build_wsl_test_loader(cfg, dataset_name, batch_size=max(1, cfg.TEST.IMS_PER_BATCH))


def build_evaluator(cfg, dataset_name: str, timings: Optional[Dict[str, float]] = None):
    """COCO for a ``coco`` dataset; COCO, SemSeg and panoptic quality for a
    ``coco_panoptic_seg`` one. Pascal VOC detection is not ported yet."""
    output_folder = os.path.join(cfg.OUTPUT_DIR, "inference")
    evaluator_type = MetadataCatalog.get(dataset_name).get("evaluator_type", "coco")
    if evaluator_type == "pascal_voc":
        raise NotImplementedError("PascalVOCDetectionEvaluator is not ported yet (ROADMAP queue 1)")
    if evaluator_type not in ("coco", "coco_panoptic_seg"):
        raise NotImplementedError(f"no evaluator ported yet for {dataset_name} ({evaluator_type})")
    evaluators = [COCOEvaluator(dataset_name, output_dir=output_folder, timings=timings)]
    if evaluator_type == "coco_panoptic_seg":
        evaluators.append(SemSegEvaluator(dataset_name, output_dir=output_folder, timings=timings))
        evaluators.append(COCOPanopticEvaluator(dataset_name, output_folder, timings=timings))
    return evaluators[0] if len(evaluators) == 1 else DatasetEvaluators(evaluators)


def main(args):
    if not args.eval_only:
        sys.exit("training from this command is not ported yet (ROADMAP queue 1, the train loader); "
                 "pass --eval-only to score a model")
    cfg = setup(args, wsl_cfg())
    model = build_model(cfg, device=args.device)
    load_weights(model, cfg.MODEL.WEIGHTS)
    res = test(cfg, model, build_test_loader=build_test_loader, build_evaluator=build_evaluator)
    if cfg.TEST.EXPECTED_RESULTS:
        verify_results(cfg, res)
    return res


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="[%(asctime)s %(name)s]: %(levelname)s %(message)s", datefmt="%m/%d %H:%M:%S")
    main(argument_parser().parse_args())
