"""Optimizer and learning-rate schedule from the config (reference:
detectron2/solver/build.py:110 ``build_optimizer``, :127
``get_default_optimizer_params``; JAX package ``solver/build.py`` :25
``build_lr_schedule``, :113 ``_param_label_fn``, :128 ``build_optimizer``).

The JAX package's optax chain per parameter group is
``add_decayed_weights(wd)`` -> ``trace(momentum)`` -> ``scale_by_schedule(-lr
* factor)``: that is ``torch.optim.SGD`` with dampening 0, whose learning
rate at update count ``n`` is ``schedule(n) * factor``; the train step sets
it before each update. Three groups follow ``_param_label_fn``: ``regular``,
``bias`` (BIAS_LR_FACTOR, WEIGHT_DECAY_BIAS) and ``norm``
(WEIGHT_DECAY_NORM).
"""

from __future__ import annotations

from typing import Callable

import torch

from .lr_scheduler import WarmupCosineLR, WarmupMultiStepLR


def build_lr_schedule(cfg) -> Callable[[int], float]:
    """``step -> lr`` for SOLVER.LR_SCHEDULER_NAME."""
    s = cfg.SOLVER
    warmup = dict(
        warmup_factor=s.WARMUP_FACTOR, warmup_iters=s.WARMUP_ITERS, warmup_method=s.WARMUP_METHOD
    )
    if s.LR_SCHEDULER_NAME == "WarmupMultiStepLR":
        return WarmupMultiStepLR(s.BASE_LR, s.STEPS, s.GAMMA, **warmup)
    if s.LR_SCHEDULER_NAME == "WarmupCosineLR":
        return WarmupCosineLR(s.BASE_LR, s.MAX_ITER, **warmup)
    raise NotImplementedError(f"LR scheduler {s.LR_SCHEDULER_NAME!r} is not ported yet")


def param_label(name: str) -> str:
    """``norm``, ``bias`` or ``regular`` for a parameter's dotted name, by
    the JAX package's rule: any module in the path whose name holds
    "norm", "bn" or "gn" makes a norm parameter, else a leaf named "bias" a
    bias. FrozenBN holds buffers, which never reach the optimizer."""
    *modules, leaf = name.split(".")
    if any(k in m.lower() for m in modules for k in ("norm", "bn", "gn")):
        return "norm"
    return "bias" if leaf == "bias" else "regular"


def build_optimizer(cfg, model: torch.nn.Module) -> torch.optim.SGD:
    """SGD with momentum over every trainable parameter of ``model``, in
    the three groups; each group's ``lr_factor`` scales the schedule."""
    s = cfg.SOLVER
    if s.OPTIMIZER.upper() != "SGD":
        raise NotImplementedError(f"optimizer {s.OPTIMIZER!r} is not ported yet")
    if s.CLIP_GRADIENTS.ENABLED:
        raise NotImplementedError("SOLVER.CLIP_GRADIENTS is not ported yet")
    settings = {
        "regular": (s.WEIGHT_DECAY, 1.0),
        "bias": (s.WEIGHT_DECAY_BIAS, s.BIAS_LR_FACTOR),
        "norm": (s.WEIGHT_DECAY_NORM, 1.0),
    }
    params = {label: [] for label in settings}
    for name, p in model.named_parameters():
        if p.requires_grad:
            params[param_label(name)].append(p)
    groups = [
        {"params": params[label], "weight_decay": float(wd or 0.0), "lr_factor": float(factor),
         "label": label}
        for label, (wd, factor) in settings.items() if params[label]
    ]
    return torch.optim.SGD(
        groups, lr=float(s.BASE_LR), momentum=s.MOMENTUM, dampening=0.0, nesterov=s.NESTEROV
    )
