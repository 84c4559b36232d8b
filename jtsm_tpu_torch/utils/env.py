"""Seeding (reference: detectron2/utils/env.py:21 ``seed_all_rng``; JAX
package ``utils/env.py:13``)."""

from __future__ import annotations

import datetime
import logging
import os
import random

import numpy as np
import torch


def seed_all_rng(seed=None) -> int:
    """Seeds Python's, numpy's and PyTorch's global generators with ``seed``
    modulo 2^31 (a seed from the time, the pid and the OS when None or
    negative) and returns it."""
    if seed is None or seed < 0:
        seed = os.getpid() + int(datetime.datetime.now().strftime("%S%f")) + int.from_bytes(os.urandom(2), "big")
        logging.getLogger(__name__).info(f"Using a generated random seed {seed}")
    seed = int(seed) % 2**31
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    return seed
