"""Hierarchical, freezable configuration tree.

A copy of the JAX package's ``config/cfgnode.py`` (the port imports nothing
of that package), with the same user-facing semantics as detectron2's
``CfgNode`` (reference: detectron2/config/config.py:12):

* attribute access (``cfg.MODEL.WEIGHTS``)
* yaml loading with ``_BASE_`` file inheritance (``merge_from_file``)
* ``merge_from_list`` for CLI ``KEY VALUE`` overrides
* ``freeze()`` / ``defrost()`` immutability

``yaml`` is imported only where a yaml file or string is parsed, so the
package loads on a machine without PyYAML; configurations can then be built
in Python (see ``defaults.mask_rcnn_R_50_FPN_cfg``).
"""

from __future__ import annotations

import ast
import copy
import logging
import os
from typing import Any, Dict, List

logger = logging.getLogger(__name__)

BASE_KEY = "_BASE_"


class CfgNode(dict):
    """A dict with attribute access, freezing, and yaml loading."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict: Dict | None = None):
        init_dict = {} if init_dict is None else init_dict
        super().__init__()
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        for k, v in init_dict.items():
            if isinstance(v, dict):
                v = CfgNode(v)
            dict.__setitem__(self, k, v)

    # -- attribute protocol ------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"Non-existent config key: {name}")

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __setitem__(self, name, value) -> None:
        if self.is_frozen():
            raise AttributeError(f"Attempted to set {name} on an immutable CfgNode.")
        if isinstance(value, dict) and not isinstance(value, CfgNode):
            value = CfgNode(value)
        dict.__setitem__(self, name, value)

    # -- mutability --------------------------------------------------------
    def is_frozen(self) -> bool:
        return getattr(self, CfgNode.IMMUTABLE)

    def _set_immutable(self, flag: bool) -> None:
        object.__setattr__(self, CfgNode.IMMUTABLE, flag)
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(flag)

    def freeze(self) -> "CfgNode":
        self._set_immutable(True)
        return self

    def defrost(self) -> "CfgNode":
        self._set_immutable(False)
        return self

    def clone(self) -> "CfgNode":
        out = CfgNode()
        for k, v in self.items():
            if isinstance(v, CfgNode):
                dict.__setitem__(out, k, v.clone())
            else:
                dict.__setitem__(out, k, copy.deepcopy(v))
        return out

    # -- merging -----------------------------------------------------------
    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        _merge_a_into_b(other, self)

    def merge_from_file(self, filename: str) -> None:
        import yaml

        _merge_a_into_b(CfgNode(_load_yaml_with_base(filename, yaml)), self)

    def merge_from_list(self, opts: List[str]) -> None:
        if len(opts) % 2:
            raise ValueError(f"Override list has odd length: {opts}")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    raise KeyError(f"Non-existent key: {key}")
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Non-existent key: {key}")
            node[leaf] = _decode_and_coerce(value, node[leaf], key)

    def to_dict(self) -> Dict:
        return {k: v.to_dict() if isinstance(v, CfgNode) else v for k, v in self.items()}

    def __str__(self) -> str:
        lines = []
        for k, v in sorted(self.items()):
            if isinstance(v, CfgNode):
                lines.append(f"{k}:")
                lines.extend("  " + line for line in str(v).split("\n"))
            else:
                lines.append(f"{k}: {v}")
        return "\n".join(lines)

    __repr__ = __str__


def _decode_and_coerce(value: str, old: Any, key: str) -> Any:
    """Parse a CLI string and coerce it to the type of the existing value."""
    try:
        parsed = ast.literal_eval(value)
    except (ValueError, SyntaxError):
        parsed = value
    if old is None or parsed is None:
        return parsed
    if isinstance(old, tuple) and isinstance(parsed, list):
        return tuple(parsed)
    if isinstance(old, list) and isinstance(parsed, tuple):
        return list(parsed)
    if isinstance(old, bool):
        if isinstance(parsed, bool):
            return parsed
        raise ValueError(f"Cannot coerce {value!r} to bool for key {key}")
    if isinstance(old, float) and isinstance(parsed, int):
        return float(parsed)
    if type(parsed) is not type(old) and (isinstance(parsed, str) or isinstance(old, str)):
        raise ValueError(
            f"Type mismatch ({type(old).__name__} vs {type(parsed).__name__}) "
            f"for key {key} with value {value!r}"
        )
    return parsed


def _merge_a_into_b(a: CfgNode, b: CfgNode) -> None:
    for k, v_a in a.items():
        if k in b and isinstance(b[k], CfgNode) and isinstance(v_a, dict):
            _merge_a_into_b(CfgNode(v_a) if not isinstance(v_a, CfgNode) else v_a, b[k])
        else:
            if isinstance(v_a, dict):
                v_a = CfgNode(v_a) if not isinstance(v_a, CfgNode) else v_a.clone()
            elif k in b and b[k] is not None and v_a is not None:
                v_a = _coerce_value(v_a, b[k])
            dict.__setitem__(b, k, v_a)


def _coerce_value(new: Any, old: Any) -> Any:
    if isinstance(new, str) and not isinstance(old, str):
        # yaml leaves python-literal syntax like "(60000, 80000)" as a string;
        # yacs literal-evals it — match that behavior.
        try:
            new = ast.literal_eval(new)
        except (ValueError, SyntaxError):
            pass
    if isinstance(old, tuple) and isinstance(new, list):
        return tuple(new)
    if isinstance(old, list) and isinstance(new, tuple):
        return list(new)
    if isinstance(old, float) and isinstance(new, int):
        return float(new)
    return new


def _load_yaml_with_base(filename: str, yaml) -> Dict:
    """Load yaml supporting the ``_BASE_`` inheritance key: the base file is
    loaded first (path relative to the child file unless absolute), then the
    child's keys are merged over it (detectron2/config/config.py:29-77)."""
    with open(filename, "r") as f:
        try:
            cfg = yaml.safe_load(f)
        except yaml.constructor.ConstructorError:
            # reference yamls may carry python tags (Base-RetinaNet.yaml anchor
            # SIZES); like the reference, first-party configs load unsafely
            f.seek(0)
            logger.warning(f"Loading {filename} with unsafe yaml (python tags)")
            cfg = yaml.unsafe_load(f)
    cfg = cfg or {}
    if BASE_KEY in cfg:
        base_filename = os.path.expanduser(cfg.pop(BASE_KEY))
        if not os.path.isabs(base_filename):
            base_filename = os.path.join(os.path.dirname(filename), base_filename)
        base = _load_yaml_with_base(base_filename, yaml)
        _dict_merge(cfg, base)
        return base
    return cfg


def _dict_merge(src: Dict, dst: Dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _dict_merge(v, dst[k])
        else:
            dst[k] = v
