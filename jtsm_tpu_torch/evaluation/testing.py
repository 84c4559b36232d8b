"""Printing and checking results (reference:
detectron2/evaluation/testing.py:10, :28; JAX package
``evaluation/testing.py:17,31``)."""

from __future__ import annotations

import logging
import pprint
import sys
from collections.abc import Mapping

import numpy as np

logger = logging.getLogger(__name__)


def print_csv_format(results: Mapping) -> None:
    for task, res in results.items():
        if isinstance(res, Mapping):
            important = [(k, v) for k, v in res.items() if "-" not in k]
            logger.info(f"copypaste: Task: {task}")
            logger.info("copypaste: " + ",".join(k for k, _ in important))
            logger.info("copypaste: " + ",".join(f"{v:.4f}" for _, v in important))
        else:
            logger.info(f"copypaste: {task}={res}")


def verify_results(cfg, results: Mapping) -> bool:
    """Checks ``results`` against TEST.EXPECTED_RESULTS ([task, metric,
    value, tolerance] rows); a miss ends the process with status 1, as the
    reference does."""
    expected_results = cfg.TEST.EXPECTED_RESULTS
    if not len(expected_results):
        return True
    ok = True
    for task, metric, expected, tolerance in expected_results:
        actual = results[task].get(metric, None)
        if actual is None or not np.isfinite(actual) or abs(actual - expected) > tolerance:
            ok = False
    if not ok:
        logger.error("Result verification failed!")
        logger.error("Expected Results: " + str(expected_results))
        logger.error("Actual Results: " + pprint.pformat(results))
        sys.exit(1)
    logger.info("Results verification passed.")
    return ok
