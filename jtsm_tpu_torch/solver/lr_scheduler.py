"""Learning-rate schedules as pure ``step -> lr`` callables (reference:
detectron2/solver/lr_scheduler.py:16 ``WarmupMultiStepLR``, :52
``WarmupCosineLR``, :90 ``_get_warmup_factor_at_iter``; JAX package
``solver/lr_scheduler.py``).

The reference classes are ``_LRScheduler``s that mutate an optimizer; here,
as in the JAX package, a schedule maps the update count to the learning
rate, and the train step writes it into the optimizer's groups before each
update (``engine.train_loop``)."""

from __future__ import annotations

import math
from typing import Sequence


def get_warmup_factor_at_iter(method: str, it: int, warmup_iters: int, warmup_factor: float) -> float:
    """The warmup multiplier at iteration ``it`` (reference :90)."""
    if warmup_iters <= 0 or it >= warmup_iters:
        return 1.0
    if method == "constant":
        return warmup_factor
    if method == "linear":
        alpha = min(max(it / warmup_iters, 0.0), 1.0)
        return warmup_factor * (1 - alpha) + alpha
    raise ValueError(f"Unknown warmup method: {method}")


class _WarmupSchedule:
    def __init__(self, base_lr: float, warmup_factor: float, warmup_iters: int, warmup_method: str):
        self.base_lr = float(base_lr)
        self.warmup_factor = float(warmup_factor)
        self.warmup_iters = int(warmup_iters)
        self.warmup_method = warmup_method

    def _warmup(self, step: int) -> float:
        return get_warmup_factor_at_iter(self.warmup_method, step, self.warmup_iters, self.warmup_factor)


class WarmupMultiStepLR(_WarmupSchedule):
    """Warmup, then ``gamma`` at each milestone (reference :16)."""

    def __init__(
        self,
        base_lr: float = 1.0,
        milestones: Sequence[int] = (),
        gamma: float = 0.1,
        warmup_factor: float = 0.001,
        warmup_iters: int = 1000,
        warmup_method: str = "linear",
    ):
        if list(milestones) != sorted(milestones):
            raise ValueError(f"Milestones should be increasing integers. Got {milestones}")
        super().__init__(base_lr, warmup_factor, warmup_iters, warmup_method)
        self.milestones = tuple(int(m) for m in milestones)
        self.gamma = float(gamma)

    def __call__(self, step: int) -> float:
        decay = self.gamma ** sum(step >= m for m in self.milestones)
        return self.base_lr * self._warmup(step) * decay


class WarmupCosineLR(_WarmupSchedule):
    """Warmup, then a half cosine over ``max_iters`` (reference :52)."""

    def __init__(
        self,
        base_lr: float = 1.0,
        max_iters: int = 1,
        warmup_factor: float = 0.001,
        warmup_iters: int = 1000,
        warmup_method: str = "linear",
    ):
        super().__init__(base_lr, warmup_factor, warmup_iters, warmup_method)
        self.max_iters = int(max_iters)

    def __call__(self, step: int) -> float:
        progress = min(max(step / max(self.max_iters, 1), 0.0), 1.0)
        return self.base_lr * self._warmup(step) * 0.5 * (1.0 + math.cos(math.pi * progress))


class WarmupPolyLR(_WarmupSchedule):
    """Warmup, then ``(1 - step / max_iters) ** power``, progress clipped to
    [0, 1], never below ``constant_ending`` (DeepLab's schedule; JAX
    package ``solver/build.py:58-66`` and ``lr_scheduler.py:93-115``). As
    there, the floor applies in warm-up too."""

    def __init__(
        self,
        base_lr: float = 1.0,
        max_iters: int = 1,
        warmup_factor: float = 0.001,
        warmup_iters: int = 1000,
        warmup_method: str = "linear",
        power: float = 0.9,
        constant_ending: float = 0.0,
    ):
        super().__init__(base_lr, warmup_factor, warmup_iters, warmup_method)
        self.max_iters = int(max_iters)
        self.power = float(power)
        self.constant_ending = float(constant_ending)

    def __call__(self, step: int) -> float:
        progress = min(max(step / max(self.max_iters, 1), 0.0), 1.0)
        poly = max((1.0 - progress) ** self.power, self.constant_ending)
        return self.base_lr * self._warmup(step) * poly
