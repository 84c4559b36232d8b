"""Command line for the port (reference: tools/train_net.py; JAX package
counterpart ``tools/train_net.py:29-61``):

    python -m jtsm_tpu_torch.tools.train_net --config-file CFG.yaml \\
        [--resume] [--eval-only] [--device cpu] [KEY VALUE ...]

Training builds ``engine.DefaultTrainer`` on the card (or ``--device``),
loads MODEL.WEIGHTS (or with ``--resume`` the newest checkpoint in
OUTPUT_DIR) and trains to SOLVER.MAX_ITER, writing ``metrics.json`` and
the checkpoints (``model_{iter:07d}.pth``, ``model_final.pth``) into
OUTPUT_DIR. ``--eval-only`` loads the weights the same way (a ``.pth`` of
the port or of detectron2, a zoo ``.pkl``, the JAX package's ``.ckpt`` or
``.ckpt.gz``), scores the model on DATASETS.TEST (``engine.defaults.test``;
with TEST.AUG.ENABLED, ``test_with_TTA``, bbox only, as in the JAX package)
and checks TEST.EXPECTED_RESULTS. Datasets resolve under
``$JTSM_DATASETS``.
"""

from __future__ import annotations

import logging
import sys

from ..checkpoint import DetectionCheckpointer
from ..config import get_cfg
from ..engine import DefaultTrainer, default_argument_parser, default_setup, test
from ..evaluation import verify_results
from ..modeling import build_model

logger = logging.getLogger("jtsm_tpu_torch")


def setup(args, cfg=None):
    """The config: ``cfg`` (default ``get_cfg()``) with the file and the
    command line's KEY VALUE pairs merged in, frozen, then
    ``default_setup``."""
    cfg = cfg if cfg is not None else get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts)
    cfg.freeze()
    default_setup(cfg, args)
    return cfg


argument_parser = default_argument_parser


def load_weights(model, path: str, save_dir: str = "", resume: bool = False) -> None:
    """``path`` into ``model`` (``checkpoint.DetectionCheckpointer``), or
    with ``resume`` the newest checkpoint of ``save_dir`` when it has one;
    an empty path keeps the initialisation."""
    if not path and not resume:
        logger.warning("MODEL.WEIGHTS is empty: scoring the untrained initialisation")
    DetectionCheckpointer(model, save_dir).resume_or_load(path, resume=resume)


def main(args):
    cfg = setup(args)
    if not args.eval_only:
        trainer = DefaultTrainer(cfg, device=args.device)
        trainer.resume_or_load(resume=args.resume)
        return trainer.train()
    model = build_model(cfg, device=args.device)
    load_weights(model, cfg.MODEL.WEIGHTS, cfg.OUTPUT_DIR, args.resume)
    res = test(cfg, model)
    if cfg.TEST.EXPECTED_RESULTS:
        verify_results(cfg, res)
    return res


def configure_logging() -> None:
    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="[%(asctime)s %(name)s]: %(levelname)s %(message)s", datefmt="%m/%d %H:%M:%S")


if __name__ == "__main__":
    configure_logging()
    main(argument_parser().parse_args())
