"""Weights in the reference's formats (reference:
detectron2/checkpoint/c2_model_loading.py:12 ``convert_basic_c2_names``,
:68 ``convert_c2_detectron_names``; JAX package
``checkpoint/c2_model_loading.py:32,67,306,346``), copied so that the
port loads them without the JAX package.

A ``.pkl`` of the model zoo is either detectron2's own (``{"model": state
dict, "__author__": "detectron2"}``, names kept) or Caffe2's (Detectron's
zoo and the ImageNet backbones: ``res2_0_branch2a_w`` and so on, renamed to
detectron2's names, the ImageNet classifier dropped, and an ImageNet
backbone's bare names put under the model's backbone). Its arrays are in
PyTorch's layouts, as the port's modules hold them. Unpickling runs code,
so load only files of a known source.
"""

from __future__ import annotations

import pickle
import re
from typing import Dict, Iterable, List, Tuple

import numpy as np


def convert_basic_c2_names(original_keys: Iterable[str]) -> List[str]:
    """Caffe2 names to detectron2 names: the norm suffixes, ``_w``/``_b``/
    ``_s``, the stem, and ``resN_M_branch2{a,b,c}``/``branch1`` to
    ``resN.M.conv{1,2,3}``/``shortcut``."""
    layer_keys = list(original_keys)
    for pattern, repl in (("_(bn)?_b$", ".norm.bias"), ("_bn_s$", ".norm.weight"),
                          ("_bn_rm$", ".norm.running_mean"), ("_bn_riv$", ".norm.running_var"),
                          ("_bn_gamma$", ".norm.weight"), ("_bn_beta$", ".norm.bias"),
                          ("_bn_running_mean$", ".norm.running_mean"), ("_bn_running_var$", ".norm.running_var"),
                          ("_b$", ".bias"), ("_w$", ".weight"), ("_s$", ".weight"),
                          ("^conv1\\.norm", "stem.conv1.norm"), ("^conv1\\.", "stem.conv1."),
                          ("^res\\.conv1\\.norm\\.", "conv1.norm.")):
        layer_keys = [re.sub(pattern, repl, k) for k in layer_keys]

    def convert_residual(k: str) -> str:
        m = re.match(r"^res(\d)_(\d+)_branch([12])([abc]?)(.*)$", k)
        if m is None:
            return k
        stage, block, branch, sub, rest = m.groups()
        name = "shortcut" if branch == "1" else {"a": "conv1", "b": "conv2", "c": "conv3"}[sub]
        return f"res{stage}.{block}.{name}{rest}"

    return [convert_residual(k) for k in layer_keys]


def convert_c2_detectron_names(weights: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A Caffe2 name -> array dict renamed to detectron2's names, the
    ImageNet classifier (``fc1000``) dropped."""
    original_keys = sorted(weights.keys())
    return {new: weights[old] for old, new in zip(original_keys, convert_basic_c2_names(original_keys))
            if not new.startswith("fc1000")}


def load_reference_pkl(path: str) -> Tuple[Dict[str, np.ndarray], bool]:
    """A zoo ``.pkl``'s arrays by name, and whether they carry Caffe2's
    names: those of a ``model`` dict without an ``__author__`` or by
    Caffe2, and bare dicts, do. Caffe2's ``_momentum`` blobs are
    dropped."""
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    if "model" in data:
        author = data.get("__author__")
        if author == "Caffe2" or author is None:
            return {k: np.asarray(v) for k, v in data["model"].items() if not k.endswith("_momentum")}, True
        return {k: np.asarray(v) for k, v in data["model"].items()}, False
    return {k: np.asarray(v) for k, v in data.items() if not k.endswith("_momentum")}, True


def prefix_backbone(state_dict: Dict[str, np.ndarray], model_keys: Iterable[str]) -> Dict[str, np.ndarray]:
    """An ImageNet backbone's bare names (``stem.conv1.weight``) under the
    model's backbone: ``backbone.bottom_up.`` for an FPN, else
    ``backbone.``."""
    prefix = "backbone.bottom_up." if any(k.startswith("backbone.bottom_up.") for k in model_keys) else "backbone."
    return {prefix + k: v for k, v in state_dict.items()}


def load_pkl_state_dict(path: str, model_keys: Iterable[str]) -> Dict[str, np.ndarray]:
    """The detectron2-named arrays of a zoo ``.pkl`` for a model whose
    state-dict keys are ``model_keys``."""
    state_dict, is_c2 = load_reference_pkl(path)
    if is_c2:
        state_dict = prefix_backbone(convert_c2_detectron_names(state_dict), list(model_keys))
    return state_dict
