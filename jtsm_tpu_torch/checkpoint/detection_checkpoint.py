"""Checkpoints: save, load and resume (reference:
detectron2/checkpoint/detection_checkpoint.py:11 and fvcore's
``Checkpointer``/``PeriodicCheckpointer``; JAX package
``checkpoint/detection_checkpoint.py:30,36,79,119-135,145``).

The port saves detectron2's own format, ``{"model": state dict in
detectron2's names, float32 on the CPU, "iteration": ..., and each
checkpointable's state}`` as ``<name>.pth`` with ``torch.save``, and
names the newest in ``last_checkpoint``. The JAX package loads the same
file (its ``align_and_update_state_dict`` reads a ``.pth``'s ``model``).

It loads:
* ``.pth``: detectron2's format, the port's own included (every key of
  the model must match);
* ``.pkl``: a zoo file of detectron2's or Caffe2's names
  (``c2_model_loading``); keys the model lacks, or of another shape, are
  skipped and listed, as the JAX package skips them;
* ``.ckpt`` and ``.ckpt.gz``: the JAX package's pickled flax variables,
  through ``convert.variables_to_state_dict``; the optimizer state the
  JAX package pickles beside them is not read.
An empty path keeps the model as it is.
"""

from __future__ import annotations

import gzip
import logging
import os
import pickle
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .c2_model_loading import load_pkl_state_dict
from .convert import load_gate_ckpt, variables_to_state_dict

logger = logging.getLogger(__name__)


class _Opaque:
    """Stands in for a class of the JAX stack (optax states) while a JAX
    checkpoint unpickles; such entries are not read."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


class _JaxCheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "chex"):
            return _Opaque
        return super().find_class(module, name)


def load_jax_variables(path: str) -> Dict[str, Any]:
    """The flax variables of a JAX package checkpoint, float32."""
    if path.endswith(".ckpt.gz"):
        return load_gate_ckpt(path)
    with open(path, "rb") as f:
        data = _JaxCheckpointUnpickler(f).load()
    return data["variables"]


def load_state_dict_matching(model: torch.nn.Module, state_dict: Dict[str, Any], strict: bool) -> List[str]:
    """Copies each entry of ``state_dict`` whose name and shape the model
    has; returns the names that were skipped. ``strict`` raises instead of
    skipping, and also when the model has a key the dict lacks."""
    own = model.state_dict()
    skipped = [k for k, v in state_dict.items() if k not in own or tuple(own[k].shape) != tuple(np.shape(v))]
    if strict and (skipped or set(own) - set(state_dict)):
        raise KeyError(f"the checkpoint does not match the model: unexpected or misshapen {skipped[:10]}, "
                       f"missing {sorted(set(own) - set(state_dict))[:10]}")
    with torch.no_grad():
        for k, v in state_dict.items():
            if k not in skipped:
                own[k].copy_(torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v))
    return skipped


class DetectionCheckpointer:
    """Saves ``model`` and ``checkpointables`` (objects with ``state_dict``
    and ``load_state_dict``: the optimizer, the trainer's state) under
    ``save_dir``, and loads them back."""

    def __init__(self, model: torch.nn.Module, save_dir: str = "", **checkpointables: Any):
        self.model = model
        self.save_dir = save_dir
        self.checkpointables = checkpointables

    def save(self, name: str, **kwargs: Any) -> None:
        if not self.save_dir:
            return
        data: Dict[str, Any] = {"model": {k: v.detach().cpu() for k, v in self.model.state_dict().items()}}
        for key, obj in self.checkpointables.items():
            data[key] = obj.state_dict()
        data.update(kwargs)
        os.makedirs(self.save_dir, exist_ok=True)
        basename = f"{name}.pth"
        save_file = os.path.join(self.save_dir, basename)
        logger.info(f"Saving checkpoint to {save_file}")
        torch.save(data, save_file)
        self.tag_last_checkpoint(basename)

    def load(self, path: str, checkpointables: Optional[List[str]] = None) -> Dict[str, Any]:
        """Loads the weights of ``path`` into the model and, from the port's
        ``.pth``, the ``checkpointables`` named (all by default); returns
        what else the file holds (``iteration``)."""
        if not path:
            logger.info("No checkpoint given; the model stays as it is.")
            return {}
        logger.info(f"Loading checkpoint from {path}")
        if path.endswith(".pkl"):
            skipped = load_state_dict_matching(self.model, load_pkl_state_dict(path, self.model.state_dict()), False)
            if skipped:
                logger.info(f"Keys of {path} the model does not take (first 20): {skipped[:20]}")
            return {}
        if path.endswith(".ckpt") or path.endswith(".ckpt.gz"):
            load_state_dict_matching(self.model, variables_to_state_dict(load_jax_variables(path)), True)
            return {}
        data = torch.load(path, map_location="cpu", weights_only=False)
        if "model" not in data:  # a bare state dict
            data = {"model": data}
        load_state_dict_matching(self.model, data.pop("model"), True)
        for key in self.checkpointables if checkpointables is None else checkpointables:
            if key in data:
                self.checkpointables[key].load_state_dict(data.pop(key))
        return data

    def has_checkpoint(self) -> bool:
        return os.path.exists(os.path.join(self.save_dir, "last_checkpoint"))

    def get_checkpoint_file(self) -> str:
        """The newest checkpoint named in ``last_checkpoint``, or ""."""
        try:
            with open(os.path.join(self.save_dir, "last_checkpoint")) as f:
                return os.path.join(self.save_dir, f.read().strip())
        except OSError:
            return ""

    def tag_last_checkpoint(self, basename: str) -> None:
        with open(os.path.join(self.save_dir, "last_checkpoint"), "w") as f:
            f.write(basename)

    def resume_or_load(self, path: str, *, resume: bool = True) -> Dict[str, Any]:
        """With ``resume`` and a ``last_checkpoint``, everything of the
        checkpoint it names; else the weights of ``path`` alone."""
        if resume and self.has_checkpoint():
            return self.load(self.get_checkpoint_file())
        return self.load(path, checkpointables=[])


class PeriodicCheckpointer:
    """Saves ``model_{iteration:07d}`` after every ``period`` iterations and
    ``model_final`` after the last of ``max_iter``, with the iteration."""

    def __init__(self, checkpointer: DetectionCheckpointer, period: int, max_iter: Optional[int] = None):
        self.checkpointer = checkpointer
        self.period = period
        self.max_iter = max_iter

    def step(self, iteration: int) -> None:
        iteration = int(iteration)
        if (iteration + 1) % self.period == 0:
            self.checkpointer.save(f"model_{iteration:07d}", iteration=iteration)
        if self.max_iter is not None and iteration >= self.max_iter - 1:
            self.checkpointer.save("model_final", iteration=iteration)
