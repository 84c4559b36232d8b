"""Optimizer and learning-rate schedule from the config (reference:
detectron2/solver/build.py:110 ``build_optimizer``, :127
``get_default_optimizer_params``; JAX package ``solver/build.py`` :25
``build_lr_schedule``, :113 ``_param_label_fn``, :128 ``build_optimizer``).
SOLVER.OPTIMIZER ``ADAM`` gives :class:`Adam` (see ``build_optimizer``).

The JAX package's optax chain per parameter group is
``add_decayed_weights(wd)`` -> ``trace(momentum)`` -> ``scale_by_schedule(-lr
* factor)``: that is ``torch.optim.SGD`` with dampening 0, whose learning
rate at update count ``n`` is ``schedule(n) * factor``; the train step sets
it before each update. Three groups follow ``_param_label_fn``: ``regular``,
``bias`` (BIAS_LR_FACTOR, WEIGHT_DECAY_BIAS) and ``norm``
(WEIGHT_DECAY_NORM).

``SOLVER.CLIP_GRADIENTS`` (JAX package ``solver/build.py:148-185``) comes
first in that chain, on the raw gradients: the optimizer is :class:`SGD`
(or :class:`Adam`), whose ``clip_gradients()`` the train step calls
between the backward pass and ``step()``. ``value`` clamps each element to [-c, c] (``optax.clip``);
``full_model`` rescales every gradient by c / (global L2 norm) when the
norm is at least c (``optax.clip_by_global_norm``, no epsilon);
``norm`` rescales each parameter's gradient on its own by min(1, c /
(its NORM_TYPE norm + 1e-6)), torch's ``clip_grad_norm_`` per tensor
(the JAX package's ``clip_per_param_norm``).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from .lr_scheduler import WarmupCosineLR, WarmupMultiStepLR, WarmupPolyLR


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
    if s.LR_SCHEDULER_NAME == "WarmupPolyLR":
        return WarmupPolyLR(s.BASE_LR, s.MAX_ITER, power=getattr(s, "POLY_LR_POWER", 0.9),
                            constant_ending=getattr(s, "POLY_LR_CONSTANT_ENDING", 0.0), **warmup)
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


def clip_by_value(grads: List[torch.Tensor], clip_value: float) -> None:
    """Clamps every element to [-clip_value, clip_value], in place."""
    for g in grads:
        g.clamp_(-clip_value, clip_value)


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> None:
    """When the L2 norm of all the gradients together is at least
    ``max_norm``, divides each by that norm and multiplies by ``max_norm``
    (optax's order), in place. No value is read back to the host."""
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm.to(g.dtype) * max_norm))


def clip_per_param_norm(grads: List[torch.Tensor], max_norm: float, norm_type: float = 2.0) -> None:
    """Each gradient times min(1, max_norm / (its ``norm_type`` norm +
    1e-6)), in place."""
    for g in grads:
        gf = g.float()
        if norm_type == float("inf"):
            n = gf.abs().amax()
        else:
            n = gf.abs().pow(norm_type).sum().pow(1.0 / norm_type)
        g.copy_(gf * (max_norm / (n + 1e-6)).clamp(max=1.0))


def build_gradient_clipper(cfg) -> Optional[Callable[[List[torch.Tensor]], None]]:
    """The in-place clip of ``SOLVER.CLIP_GRADIENTS``, or None when it is
    off."""
    c = cfg.SOLVER.CLIP_GRADIENTS
    if not c.ENABLED:
        return None
    value = float(c.CLIP_VALUE)
    if c.CLIP_TYPE == "value":
        return lambda grads: clip_by_value(grads, value)
    if c.CLIP_TYPE == "full_model":
        return lambda grads: clip_by_global_norm(grads, value)
    if c.CLIP_TYPE == "norm":
        return lambda grads: clip_per_param_norm(grads, value, float(c.NORM_TYPE))
    raise ValueError(f"SOLVER.CLIP_GRADIENTS.CLIP_TYPE {c.CLIP_TYPE!r} is not one of value, full_model, norm")


class _Clipped:
    """An optimizer with the configured gradient clip, which the train step
    applies before ``step()``."""

    def __init__(self, params, clip: Optional[Callable[[List[torch.Tensor]], None]] = None, **kwargs):
        super().__init__(params, **kwargs)
        self.clip = clip

    def clip_gradients(self) -> None:
        """Applies the clip to the gradients of every group (all of them
        must be set)."""
        if self.clip is not None:
            self.clip([p.grad for group in self.param_groups for p in group["params"]])


class SGD(_Clipped, torch.optim.SGD):
    """``torch.optim.SGD`` with the configured gradient clip."""


class Adam(_Clipped, torch.optim.Adam):
    """``torch.optim.Adam`` with the configured gradient clip."""


def build_optimizer(cfg, model: torch.nn.Module) -> torch.optim.Optimizer:
    """SOLVER.OPTIMIZER over every trainable parameter of ``model``, in the
    three groups; each group's ``lr_factor`` scales the schedule. ``SGD``
    is SGD with momentum; ``ADAM`` is the JAX package's per-group chain
    ``add_decayed_weights(wd)`` -> ``scale_by_adam()`` -> the scheduled
    rate (``solver/build.py:127-139``), which is ``torch.optim.Adam`` with
    L2 weight decay added to the gradient, betas (0.9, 0.999) and eps 1e-8
    outside the square root. SOLVER.MOMENTUM and NESTEROV do not reach
    Adam, as in the JAX package."""
    s = cfg.SOLVER
    optimizer = s.OPTIMIZER.upper()
    if optimizer not in ("SGD", "ADAM"):
        raise ValueError(f"SOLVER.OPTIMIZER {s.OPTIMIZER!r} is not one of SGD, ADAM")
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
    if optimizer == "ADAM":
        return Adam(groups, clip=build_gradient_clipper(cfg), lr=float(s.BASE_LR), betas=(0.9, 0.999), eps=1e-8)
    return SGD(
        groups, clip=build_gradient_clipper(cfg), lr=float(s.BASE_LR), momentum=s.MOMENTUM, dampening=0.0,
        nesterov=s.NESTEROV,
    )
