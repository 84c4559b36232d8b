"""The training loop (reference: detectron2/engine/train_loop.py:78
``TrainerBase``, :171 ``SimpleTrainer``; JAX package ``engine/trainer.py:30,
87``).

``TrainerBase`` runs iterations between hooks inside an ``EventStorage``.
``SimpleTrainer`` takes one batch from the loader an iteration, passes it
through its ``batch_transform`` where one is set (JAX package
``engine/trainer.py:123-135``; the wait and the transform are
``data_time``), and takes one train step (``train_loop.make_train_step``).
Its metrics are read one iteration late, as in the JAX package: the
scalars put at iteration i are the losses of iteration i - 1, so the loop
reads the device once an iteration, after the next step is queued, and
the last iteration's losses are never put. The read raises
``FloatingPointError`` when the losses' sum is not finite.
``update_precise_bn`` is the PreciseBN hook's recomputation of the batch
norms' running statistics.
"""

from __future__ import annotations

import logging
import math
import time
import weakref
from typing import Dict, List, Optional

import torch

from ..layers import batch_norms, batch_statistics, exact_float32
from ..utils.events import EventStorage
from .hooks import HookBase
from .train_loop import create_train_state, make_train_step

logger = logging.getLogger(__name__)


class TrainerBase:
    iter_size = 1  # iterations (mini-batches) to an update

    def __init__(self):
        self._hooks: List[HookBase] = []
        self.iter = 0
        self.start_iter = 0
        self.max_iter = 0
        self.storage: Optional[EventStorage] = None

    def register_hooks(self, hooks) -> None:
        for h in hooks:
            if h is not None:
                h.trainer = weakref.proxy(self)
                self._hooks.append(h)

    def train(self, start_iter: int, max_iter: int) -> None:
        logger.info(f"Starting training from iteration {start_iter}")
        self.iter = self.start_iter = start_iter
        self.max_iter = max_iter
        with EventStorage(start_iter) as self.storage:
            try:
                self.before_train()
                for self.iter in range(start_iter, max_iter):
                    self.before_step()
                    self.run_step()
                    self.after_step()
                self.iter += 1
            except Exception:
                logger.exception("Exception during training:")
                raise
            finally:
                self.after_train()

    def before_train(self):
        for h in self._hooks:
            h.before_train()

    def after_train(self):
        self.storage.iter = self.iter
        for h in self._hooks:
            h.after_train()

    def before_step(self):
        self.storage.iter = self.iter
        for h in self._hooks:
            h.before_step()

    def after_step(self):
        for h in self._hooks:
            h.after_step()

    def run_step(self):
        raise NotImplementedError


class SimpleTrainer(TrainerBase):
    """Train steps of ``model`` on the batches of ``data_loader`` with
    ``optimizer`` at the learning rates of ``schedule`` (by update count),
    sampling from a generator seeded with ``seed``; an update every
    ``iter_size`` iterations. ``state_dict``/``load_state_dict`` carry what
    a resumed run needs beside the model and the optimizer: the update
    count, the generator's state and the gradient accumulator."""

    def __init__(self, model, data_loader, optimizer, schedule, seed: int, iter_size: int = 1):
        super().__init__()
        self.model = model
        self.data_loader = data_loader
        self._data_loader_iter = iter(data_loader)
        self.optimizer = optimizer
        self.schedule = schedule
        self.iter_size = iter_size
        self.state = create_train_state(model, optimizer, seed)
        self._train_step = make_train_step(model, optimizer, schedule, iter_size)
        self._pending_metrics: Optional[Dict[str, torch.Tensor]] = None
        # batch_transform(state, batch, iteration) -> batch, applied before
        # the step and counted in data_time (the WSL trainer's CPG maps)
        self.batch_transform = None

    def run_step(self):
        start = time.perf_counter()
        batch = next(self._data_loader_iter)
        batch = {k: v for k, v in batch.items() if k != "image_ids"}
        if self.batch_transform is not None:
            batch = self.batch_transform(self.state, batch, self.iter)
        data_time = time.perf_counter() - start
        metrics = self._train_step(self.state, batch)
        self._write_metrics(metrics, data_time)

    def _write_metrics(self, metrics: Dict[str, torch.Tensor], data_time: float) -> None:
        self.storage.put_scalar("data_time", data_time)
        pending, self._pending_metrics = self._pending_metrics, metrics
        if pending is None:
            return
        values = {k: float(v) for k, v in pending.items()}
        for k, v in values.items():
            self.storage.put_scalar(k, v)
        total = sum(v for k, v in values.items() if k.startswith("loss"))
        if not math.isfinite(total):
            raise FloatingPointError(f"Loss became infinite or NaN at iteration={self.iter - 1}!\n"
                                     f"loss_dict = {values}")

    def update_precise_bn(self, num_iter: int = 200) -> None:
        """PreciseBN as the JAX package computes it (``engine/trainer.py:
        180-218``): ``num_iter`` batches from the train loader, each through
        the model in train mode with batch statistics (sampling from the
        train state's generator, no gradient), each batch norm's running
        statistics taken after one momentum step from the same starting
        statistics every time, and their mean kept: 0.9 * old + 0.1 * (the
        mean of the batch statistics), not detectron2's population
        statistics (ROADMAP §3). Nothing happens without a trainable batch
        norm."""
        norms = batch_norms(self.model)
        if not norms:
            return
        start = [(bn.running_mean.clone(), bn.running_var.clone()) for bn in norms]
        sums = [(torch.zeros_like(m), torch.zeros_like(v)) for m, v in start]
        with torch.no_grad(), exact_float32(self.model.compute_dtype == torch.float32), batch_statistics():
            for _ in range(num_iter):
                batch = {k: v for k, v in next(self._data_loader_iter).items() if k != "image_ids"}
                self.model(batch, generator=self.state.generator)
                for bn, (m, v), (sm, sv) in zip(norms, start, sums):
                    sm.add_(bn.running_mean)
                    sv.add_(bn.running_var)
                    bn.running_mean.copy_(m)
                    bn.running_var.copy_(v)
            for bn, (sm, sv) in zip(norms, sums):
                bn.running_mean.copy_(sm / max(num_iter, 1))
                bn.running_var.copy_(sv / max(num_iter, 1))

    def close(self) -> None:
        """Stops the loader's background thread."""
        self._data_loader_iter.close()

    def state_dict(self) -> Dict:
        s = self.state
        return {"step": s.step, "generator": s.generator.get_state(), "mini_step": s.mini_step,
                "acc": None if s.acc is None else [a.detach().cpu() for a in s.acc]}

    def load_state_dict(self, d: Dict) -> None:
        s = self.state
        s.step, s.mini_step = int(d["step"]), int(d["mini_step"])
        s.generator.set_state(d["generator"])
        dev = next(self.model.parameters()).device
        s.acc = None if d["acc"] is None else [a.to(dev) for a in d["acc"]]
