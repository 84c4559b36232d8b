"""Command line for the port (reference: tools/train_net.py; JAX package
counterpart ``tools/train_net.py:29``). Scoring only:

    python -m jtsm_tpu_torch.tools.train_net --eval-only --config-file CFG.yaml \
        [--device cpu] [KEY VALUE ...]

builds the model on the card (or ``--device``), loads MODEL.WEIGHTS,
scores it on DATASETS.TEST (``engine.defaults.test``) and checks
TEST.EXPECTED_RESULTS. Datasets resolve under ``$JTSM_DATASETS``.
Training from this command waits for ``DefaultTrainer`` (ROADMAP queue 1
item 5).
"""

from __future__ import annotations

import argparse
import logging
import sys

from ..checkpoint import load_gate_ckpt, variables_to_state_dict
from ..config import get_cfg
from ..engine import test
from ..evaluation import verify_results
from ..modeling import build_model

logger = logging.getLogger("jtsm_tpu_torch")


def argument_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="jtsm_tpu_torch scoring")
    parser.add_argument("--config-file", default="", metavar="FILE", help="path to a yaml config")
    parser.add_argument("--eval-only", action="store_true", help="score the model (the only mode ported)")
    parser.add_argument("--device", default="cuda", help="device to run on (default: the card)")
    parser.add_argument("opts", nargs=argparse.REMAINDER, help="KEY VALUE pairs that override the config")
    return parser


def setup(args, cfg=None):
    """The config: ``cfg`` (default ``get_cfg()``) with the file and the
    command line's KEY VALUE pairs merged in, frozen."""
    cfg = cfg if cfg is not None else get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts)
    cfg.freeze()
    return cfg


def load_weights(model, path: str) -> None:
    """MODEL.WEIGHTS into ``model``: the committed gate checkpoints
    (``.ckpt.gz``, flax variables); an empty path keeps the initialisation."""
    if not path:
        logger.warning("MODEL.WEIGHTS is empty: scoring the untrained initialisation")
        return
    if not path.endswith(".ckpt.gz"):
        raise NotImplementedError(f"loading {path} is not ported yet (ROADMAP queue 1 item 5: checkpoints)")
    model.load_state_dict(variables_to_state_dict(load_gate_ckpt(path)), strict=True)


def main(args):
    if not args.eval_only:
        sys.exit("training from this command is not ported yet (ROADMAP queue 1 item 5, DefaultTrainer); "
                 "pass --eval-only to score a model")
    cfg = setup(args)
    model = build_model(cfg, device=args.device)
    load_weights(model, cfg.MODEL.WEIGHTS)
    res = test(cfg, model)
    if cfg.TEST.EXPECTED_RESULTS:
        verify_results(cfg, res)
    return res


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="[%(asctime)s %(name)s]: %(levelname)s %(message)s", datefmt="%m/%d %H:%M:%S")
    main(argument_parser().parse_args())
