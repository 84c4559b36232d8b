"""Trainer hooks (reference: detectron2/engine/hooks.py:75
``IterationTimer``, :147 ``PeriodicWriter``, :181 ``PeriodicCheckpointer``,
:200 ``LRScheduler``, :307 ``EvalHook``, :367 ``PreciseBN``; JAX package
``engine/hooks.py:59,90,110,125,138,197``). The profiler and the
visualization hooks are not ported (ROADMAP)."""

from __future__ import annotations

import datetime
import logging
import time
from typing import Callable

from ..evaluation.testing import flatten_results_dict
from ..utils.events import get_event_storage

logger = logging.getLogger(__name__)


class HookBase:
    trainer = None  # set by TrainerBase.register_hooks

    def before_train(self):
        pass

    def after_train(self):
        pass

    def before_step(self):
        pass

    def after_step(self):
        pass


class IterationTimer(HookBase):
    """Puts ``time``, the seconds from one iteration's start to its end
    (loader wait and step), after ``warmup_iter`` iterations, and logs
    the mean at the end."""

    def __init__(self, warmup_iter: int = 3):
        self._warmup_iter = warmup_iter
        self._step_timer = self._start_time = time.perf_counter()

    def before_train(self):
        self._start_time = time.perf_counter()

    def after_train(self):
        total_time = time.perf_counter() - self._start_time
        num_iter = self.trainer.iter + 1 - self.trainer.start_iter - self._warmup_iter
        if num_iter > 0:
            logger.info(f"Total training time: {datetime.timedelta(seconds=int(total_time))} "
                        f"({total_time / num_iter:.4f} s / it)")

    def before_step(self):
        self._step_timer = time.perf_counter()

    def after_step(self):
        if self.trainer.iter - self.trainer.start_iter + 1 > self._warmup_iter:
            get_event_storage().put_scalar("time", time.perf_counter() - self._step_timer)


class PeriodicWriter(HookBase):
    """Flushes ``writers`` every ``period`` iterations, after the last, and
    at the end."""

    def __init__(self, writers, period: int = 20):
        self._writers = writers
        self._period = period

    def after_step(self):
        if (self.trainer.iter + 1) % self._period == 0 or self.trainer.iter == self.trainer.max_iter - 1:
            for writer in self._writers:
                writer.write()

    def after_train(self):
        for writer in self._writers:
            writer.write()
            writer.close()


class PeriodicCheckpointerHook(HookBase):
    """Steps a ``checkpoint.PeriodicCheckpointer`` after every iteration."""

    def __init__(self, periodic_checkpointer):
        self._pc = periodic_checkpointer

    def before_train(self):
        self._pc.max_iter = self.trainer.max_iter

    def after_step(self):
        self._pc.step(self.trainer.iter)


class LRScheduler(HookBase):
    """Puts ``lr``, the schedule at ``iter``, as the JAX package logs it.
    Under ``iter_size`` k > 1 the update the iteration's gradients go into
    takes the schedule at ``iter // k`` (the train step sets it), so the
    logged rate runs k times ahead of the applied one (ROADMAP §3)."""

    def __init__(self, schedule_fn: Callable[[int], float]):
        self._schedule_fn = schedule_fn

    def after_step(self):
        get_event_storage().put_scalar("lr", float(self._schedule_fn(self.trainer.iter)), smoothing_hint=False)


class PreciseBN(HookBase):
    """Every ``period`` iterations, the trainer's ``update_precise_bn`` over
    ``num_iter`` batches (JAX package ``engine/hooks.py:197-214``); the
    trainer registers it before the scoring hook, so scoring reads the new
    statistics."""

    def __init__(self, period: int, num_iter: int = 200):
        self._period = period
        self._num_iter = num_iter

    def after_step(self):
        next_iter = self.trainer.iter + 1
        if self._period > 0 and next_iter % self._period == 0:
            self.trainer.update_precise_bn(self._num_iter)


class EvalHook(HookBase):
    """Calls ``eval_function`` every ``eval_period`` iterations and after the
    last, and puts its results' numbers."""

    def __init__(self, eval_period: int, eval_function: Callable):
        self._period = eval_period
        self._func = eval_function

    def _do_eval(self):
        results = self._func()
        if results:
            assert isinstance(results, dict), f"Eval function must return a dict. Got {results} instead."
            for k, v in flatten_results_dict(results).items():
                try:
                    get_event_storage().put_scalar(k, float(v), smoothing_hint=False)
                except (ValueError, TypeError):
                    pass

    def after_step(self):
        next_iter = self.trainer.iter + 1
        if self._period > 0 and next_iter % self._period == 0 and next_iter != self.trainer.max_iter:
            self._do_eval()

    def after_train(self):
        if self.trainer.iter + 1 >= self.trainer.max_iter:
            self._do_eval()
        del self._func
