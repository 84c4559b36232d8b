"""Weights carried across from the JAX package.

``variables_to_state_dict`` takes the JAX package's flax variables (a nested
dict of numpy arrays with the ``params``, ``frozen`` and ``batch_stats``
collections) and
returns the detectron2-named state dict that the port's modules load. It
inverts the JAX package's ``checkpoint/c2_model_loading.py:231-285``
(``convert_d2_state_dict_to_variables``):

* conv kernels HWIO -> OIHW;
* the transposed convolutions' kernels (kh, kw, in, out) (the mask head's
  ``deconv``, the keypoint head's ``score_lowres``), stored spatially
  mirrored, -> torch's (in, out, kh, kw);
* dense kernels (in, out) -> (out, in);
* ``fc1`` rows, which the JAX package flattens (P, P, C), -> detectron2's
  (C, P, P);
* flax paths -> detectron2 names (``res2_block0`` -> ``res2.0``, the RPN's
  ``head`` -> ``rpn_head``, also under ``RPNWSL``'s ``rpn``, RetinaNet's
  tower convolutions ``cls_subnet{i}`` and ``bbox_subnet{i}`` ->
  ``cls_subnet.{2i}`` (its
  ``nn.Sequential`` of convolutions and ReLUs, JAX
  ``c2_model_loading.py:114-118``), ``conv/kernel`` and ``dense/kernel`` ->
  ``weight``, a group norm's ``norm/GroupNorm_0/scale``, a layer norm's
  ``norm/LayerNorm_0/scale`` and a batch norm's ``norm/scale`` ->
  ``norm.weight``, a batch norm's ``batch_stats`` ``mean`` and ``var`` ->
  ``norm.running_mean`` and ``norm.running_var``, the deformable block's
  ``conv2/kernel`` (K, K, I, O) -> ``conv2.weight`` and its ``conv2_norm``
  -> ``conv2.norm``, the cascade's ``box_head_stage{s}`` and
  ``box_predictor_stage{s}`` -> ``box_head.{s}`` and ``box_predictor.{s}``,
  detectron2's ``nn.ModuleList`` keys, and ``RROIHeads``' own ``cls_score``
  and ``bbox_pred`` -> ``roi_heads.box_predictor.cls_score`` and
  ``.bbox_pred``, detectron2's names);
  the WSL modules keep their flax names: VGG16's ``backbone.conv1_1`` to
  ``backbone.conv5_3`` (an ``MRRPConv``'s one shared kernel among them),
  the ASPP head of WSJDS (``roi_heads.sem_seg_head.aspp.conv1x1``, ...,
  ``roi_heads.sem_seg_head.predictor``), the WSOD and JTSM heads'
  ``roi_heads.dan.dan1``, ``roi_heads.mil.cls``, ``roi_heads.refine0.refine_score`` and
  ``roi_heads.refine0.refine_reg``, ``roi_heads.mask_refinery_0.mask_fcn1``,
  ``sem_seg_head.res5_head_conv0``.

``load_gate_ckpt`` reads the committed ``tests/fixtures/gate_ckpts/*.ckpt.gz``
files: gzip-pickled plain dicts of numpy arrays, float16 on disk, upcast
here to float32. They unpickle without JAX. Unpickling runs code, so load
only these first-party files.
"""

from __future__ import annotations

import gzip
import logging
import pickle
import re
from typing import Any, Dict, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

# first fully connected layers that take flattened pooled maps
_CONV_FLATTEN_FCS = ("fc1", "dan1")
# trainable batch norms' statistics: flax names -> detectron2's
_RUNNING = {"mean": "running_mean", "var": "running_var"}
# transposed convolutions: (in, out, kh, kw) in torch, mirrored in flax
_DECONVS = ("deconv", "score_lowres")


def _is_deconv(name: str) -> bool:
    return any(d in name for d in _DECONVS)


def _flatten(tree: Dict, prefix=()) -> Dict[Tuple[str, ...], Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _d2_module_path(path: Tuple[str, ...]) -> list:
    out = []
    for p in path:
        m = re.match(r"^(res\d)_block(\d+)$", p)
        tower = re.match(r"^(cls_subnet|bbox_subnet)(\d+)$", p)
        stage = re.match(r"^(box_head|box_predictor)_stage(\d+)$", p)
        if m:
            out.extend(m.groups())
        elif stage:
            out.extend(stage.groups())
        elif p == "conv2_norm":
            out.extend(["conv2", "norm"])
        elif tower and out == ["head"]:
            out.extend([tower.group(1), str(2 * int(tower.group(2)))])
        elif p == "head" and out in (["proposal_generator"], ["proposal_generator", "rpn"]):
            out.append("rpn_head")
        elif p in ("cls_score", "bbox_pred") and out == ["roi_heads"]:  # RROIHeads' predictor
            out.extend(["box_predictor", p])
        else:
            out.append(p)
    return out


def _chw_rows_from_hwc(w: np.ndarray) -> np.ndarray:
    """(out, P*P*C) with columns in (P, P, C) order -> (C, P, P) order. P is
    inferred as the JAX package's ``_reorder_chw_rows_to_hwc`` infers it."""
    in_dim = w.shape[1]
    for p in (7, 14, 28, 3, 2):
        if in_dim % (p * p) == 0:
            c = in_dim // (p * p)
            if c in (32, 64, 96, 128, 256, 512, 1024, 2048):
                return w.reshape(w.shape[0], p, p, c).transpose(0, 3, 1, 2).reshape(w.shape)
    logger.warning(f"cannot infer the pooled layout of an fc of in_dim {in_dim}")
    return w


def variables_to_state_dict(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``{'params': ..., 'frozen': ..., 'batch_stats': ...}`` of numpy
    arrays -> a detectron2-named state dict of float32 CPU tensors."""
    state = {}
    for collection in ("params", "frozen", "batch_stats"):
        for path, arr in _flatten(variables.get(collection, {})).items():
            arr = np.asarray(arr, dtype=np.float32)
            *module, leaf = path
            if leaf in ("kernel", "bias") and module and module[-1] in ("conv", "dense"):
                module = module[:-1]
            if module and module[-1] in ("GroupNorm_0", "LayerNorm_0"):
                module = module[:-1]
            if leaf == "scale":  # a norm's scale: GN's, LN's, BN's
                leaf = "weight"
            name = ".".join(_d2_module_path(tuple(module)))
            if collection == "frozen":
                key = f"{name}.{leaf}"  # FrozenBN: weight, bias, running_mean, running_var
            elif collection == "batch_stats":
                key = f"{name}.{_RUNNING[leaf]}"
            elif leaf in ("bias", "weight"):
                key = f"{name}.{leaf}"
            elif leaf == "kernel":
                key = f"{name}.weight"
                if arr.ndim == 4 and any(_is_deconv(p) for p in module):
                    arr = np.transpose(arr[::-1, ::-1], (2, 3, 0, 1))
                elif arr.ndim == 4:
                    arr = np.transpose(arr, (3, 2, 0, 1))
                elif arr.ndim == 2:
                    arr = arr.T
                    if any(p in _CONV_FLATTEN_FCS for p in module):
                        arr = _chw_rows_from_hwc(arr)
            else:
                raise KeyError(f"no detectron2 name for {collection}/{'/'.join(path)}")
            state[key] = torch.tensor(np.ascontiguousarray(arr))
    return state


def load_gate_ckpt(path: str) -> Dict[str, Any]:
    """The flax variables of a committed gate checkpoint, float32."""
    with gzip.open(path, "rb") as f:
        data = pickle.load(f)
    flat = _flatten(data["variables"])
    out: Dict[str, Any] = {}
    for p, v in flat.items():
        node = out
        for k in p[:-1]:
            node = node.setdefault(k, {})
        v = np.asarray(v)
        node[p[-1]] = v.astype(np.float32) if v.dtype == np.float16 else v
    return out


def random_state_dict(model: torch.nn.Module, seed: int, keys=None) -> Dict[str, torch.Tensor]:
    """Seeded random weights for every entry of ``model.state_dict()``, for
    serving without trained weights: conv and linear weights normal with
    std 1/sqrt(fan_in), so activations keep their scale through the
    network; the box-regression outputs (``anchor_deltas``, ``bbox_pred``,
    the OICR branches' ``refine_reg``) with std 0.001 as detectron2 and the
    JAX package initialise them, so boxes stay near their anchors and
    proposals; biases small and FrozenBN near identity. With ``keys``, only
    those entries (drawn in the state dict's order)."""
    rng = np.random.default_rng(seed)
    state = {}
    for key, t in model.state_dict().items():
        if keys is not None and key not in keys:
            continue
        shape = tuple(t.shape)
        if key.endswith("running_var"):
            a = rng.uniform(0.5, 2.0, shape)
        elif key.endswith("norm.weight"):
            a = rng.normal(1.0, 0.1, shape)
        elif key.endswith("running_mean") or key.endswith("bias"):
            a = rng.normal(0.0, 0.1, shape)
        elif key.endswith(("anchor_deltas.weight", "bbox_pred.weight", "refine_reg.weight")):
            a = rng.normal(0.0, 0.001, shape)
        else:
            # (out, in, ...) for conv and linear, (in, out, kh, kw) for the deconv
            fan_in = int(np.prod(shape)) // shape[1 if _is_deconv(key) else 0]
            a = rng.normal(0.0, 1.0 / np.sqrt(fan_in), shape)
        state[key] = torch.from_numpy(a.astype(np.float32))
    return state


def select_class_rows(state: Dict[str, torch.Tensor], rows, num_classes: int,
                      absent_logit: float = -20.0) -> Dict[str, torch.Tensor]:
    """``state`` (a detector's, class-specific box regression) with its box
    and mask predictors remade for ``num_classes``: class k takes the old
    class ``rows[k]`` for k < len(rows); every other class gets zero weights
    and the classification bias ``absent_logit`` (so that it scores under
    any usual threshold); the background row stays last. Used to carry a
    trained detector's classes onto a dataset with other class ids (the
    Mask R-CNN gate onto LVIS and Cityscapes scenes)."""
    out = dict(state)

    def remade(t: torch.Tensor, per: int, fill: float) -> torch.Tensor:
        new = torch.full((num_classes * per,) + tuple(t.shape[1:]), fill, dtype=t.dtype)
        for k, r in enumerate(rows):
            new[k * per: (k + 1) * per] = t[r * per: (r + 1) * per]
        return new

    for leaf in ("weight", "bias"):
        cls = state[f"roi_heads.box_predictor.cls_score.{leaf}"]
        fill = absent_logit if leaf == "bias" else 0.0
        out[f"roi_heads.box_predictor.cls_score.{leaf}"] = torch.cat([remade(cls[:-1], 1, fill), cls[-1:]])
        key = f"roi_heads.box_predictor.bbox_pred.{leaf}"
        out[key] = remade(state[key], 4, 0.0)
        key = f"roi_heads.mask_head.predictor.{leaf}"
        if key in state:
            out[key] = remade(state[key], 1, 0.0)
    return out
