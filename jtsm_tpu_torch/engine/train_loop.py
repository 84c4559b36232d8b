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
TF32 off for matrix products and cuDNN. The forward runs under
``layers.batch_statistics``: trainable batch norms normalise with the
batch's statistics and move their running statistics once (the JAX
package's step with ``batch_stats`` mutable), frozen stages' included, as
FREEZE_AT stops only their gradients there.

With ``iter_size`` k > 1 (WSL.ITER_SIZE) a step is one mini-batch, and
every k-th takes the update, as the JAX package's ``optax.MultiSteps``
does (``projects/WSL/tools/train_net.py:45-57``): the gradients
accumulate as a running mean in float32 (``acc += (g - acc) / (n + 1)``,
optax's form), the update clips that mean, decays the weights and moves
the momentum once, at the learning rate of the update count, and the
parameters do not move in between. ``TrainState.step`` counts updates;
the accumulator and its count ride in the state (and the checkpoint)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch

from ..layers import batch_statistics, exact_float32


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int  # updates taken
    generator: torch.Generator  # the sampling draws, on the model's device
    acc: Optional[List[torch.Tensor]] = None  # the running mean of the mini-batches' gradients
    mini_step: int = 0  # mini-batches in ``acc``


def create_train_state(model, optimizer, seed: int) -> TrainState:
    """The model in train mode, the optimizer, update count 0 and a
    sampling generator on the model's device seeded with ``seed``."""
    dev = next(model.parameters()).device
    model.train()
    return TrainState(model, optimizer, 0, torch.Generator(device=dev).manual_seed(seed))


def _optimized_params(optimizer) -> List[torch.Tensor]:
    return [p for group in optimizer.param_groups for p in group["params"]]


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


def accumulate(state: TrainState, params: List[torch.Tensor]) -> None:
    """Folds the parameters' gradients (zero where unset) into the running
    mean ``state.acc``."""
    if state.acc is None:
        state.acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
    n = state.mini_step
    for a, p in zip(state.acc, params):
        g = torch.zeros_like(a) if p.grad is None else p.grad.float()
        a.add_((g - a) / (n + 1))
    state.mini_step += 1


def make_train_step(model, optimizer, schedule: Callable[[int], float], iter_size: int = 1):
    """Returns ``train_step(state, batch) -> metrics``: the loss dict and
    ``total_loss``, detached. An update advances ``state.step``: every
    step, or every ``iter_size``-th with the mean of the mini-batches'
    gradients."""
    params = _optimized_params(optimizer)

    def train_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        with exact_float32(model.compute_dtype == torch.float32):
            optimizer.zero_grad(set_to_none=True)
            with batch_statistics():
                losses = model(batch, generator=state.generator)
            total = sum(losses.values())
            total.backward()
            if iter_size > 1:
                accumulate(state, params)
            if iter_size == 1 or state.mini_step == iter_size:
                if iter_size > 1:
                    for p, a in zip(params, state.acc):
                        p.grad = a.to(p.dtype)
                    state.acc, state.mini_step = None, 0
                sgd_update(optimizer, schedule(state.step))
                state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        return metrics

    return train_step
