"""The train step (reference: detectron2/engine/train_loop.py:78
``SimpleTrainer.run_step``; JAX package ``engine/train_loop.py:30``
``create_train_state``, :46 ``make_train_step``).

A step is forward (the loss dict), the sum of the losses, backward, the
configured gradient clip (``solver.SGD.clip_gradients``, on the raw
gradients as the JAX package's optax chain clips them), the learning rate
of the step's update count, and one SGD update. The model is called with
the train state's generator, which draws its random sampling and dropout.
Parameters
that the graph leaves without a gradient (the stages FREEZE_AT detaches)
get a zero gradient before the update, so weight decay and momentum move
them as the JAX package's optax chain moves its frozen-stage weights;
detectron2 would leave them out of the optimizer instead. A model that
computes in float32 (``model.compute_dtype``) takes the whole step with
TF32 off for matrix products and cuDNN."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import torch

from ..layers import exact_float32


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    generator: torch.Generator  # the sampling draws, on the model's device


def create_train_state(model, optimizer, seed: int) -> TrainState:
    """The model in train mode, the optimizer, update count 0 and a
    sampling generator on the model's device seeded with ``seed``."""
    dev = next(model.parameters()).device
    model.train()
    return TrainState(model, optimizer, 0, torch.Generator(device=dev).manual_seed(seed))


def sgd_update(optimizer, lr: float) -> None:
    """The update after the backward pass: a zero gradient for every
    parameter the graph left without one, the gradient clip of a
    ``solver.SGD``, each group's learning rate ``lr * lr_factor``, one
    step."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        group["lr"] = lr * group.get("lr_factor", 1.0)
    clip = getattr(optimizer, "clip_gradients", None)
    if clip is not None:
        clip()
    optimizer.step()


def make_train_step(model, optimizer, schedule: Callable[[int], float]):
    """Returns ``train_step(state, batch) -> metrics``: the loss dict and
    ``total_loss``, detached. It advances ``state.step``."""

    def train_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        with exact_float32(model.compute_dtype == torch.float32):
            optimizer.zero_grad(set_to_none=True)
            losses = model(batch, generator=state.generator)
            total = sum(losses.values())
            total.backward()
            sgd_update(optimizer, schedule(state.step))
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        return metrics

    return train_step
