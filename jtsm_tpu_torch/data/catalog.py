"""Dataset and metadata catalogs (reference: detectron2/data/catalog.py:13
``DatasetCatalog``, :91 ``Metadata``, :181 ``MetadataCatalog``; JAX package
``data/catalog.py:11,46,95``)."""

from __future__ import annotations

import types
from typing import Callable, Dict, List


class _DatasetCatalog:
    def __init__(self):
        self._registry: Dict[str, Callable] = {}

    def register(self, name: str, func: Callable) -> None:
        assert callable(func), "You must register a function with DatasetCatalog.register!"
        assert name not in self._registry, f"Dataset '{name}' is already registered!"
        self._registry[name] = func

    def get(self, name: str) -> List[dict]:
        try:
            f = self._registry[name]
        except KeyError as e:
            raise KeyError(
                f"Dataset '{name}' is not registered! Available: {', '.join(sorted(self._registry))}"
            ) from e
        return f()

    def remove(self, name: str) -> None:
        self._registry.pop(name)

    def __contains__(self, name: str) -> bool:
        return name in self._registry


DatasetCatalog = _DatasetCatalog()


class Metadata(types.SimpleNamespace):
    """Attribute namespace whose attributes, once set, keep their value
    (reference catalog.py:91)."""

    name: str = "N/A"

    def __getattr__(self, key):
        raise AttributeError(
            f"Attribute '{key}' does not exist in the metadata of dataset '{self.name}'. "
            f"Available keys are {sorted(self.__dict__)}."
        )

    def __setattr__(self, key, val):
        try:
            oldval = getattr(self, key)
        except AttributeError:
            super().__setattr__(key, val)
            return
        assert oldval == val, (
            f"Attribute '{key}' in the metadata of '{self.name}' cannot be set to a different "
            f"value!\n{oldval} != {val}"
        )

    def set(self, **kwargs) -> "Metadata":
        for k, v in kwargs.items():
            setattr(self, k, v)
        return self

    def get(self, key, default=None):
        try:
            return getattr(self, key)
        except AttributeError:
            return default


class _MetadataCatalog:
    def __init__(self):
        self._registry: Dict[str, Metadata] = {}

    def get(self, name: str) -> Metadata:
        assert len(name)
        if name not in self._registry:
            self._registry[name] = Metadata(name=name)
        return self._registry[name]

    def remove(self, name: str) -> None:
        self._registry.pop(name)

    def __contains__(self, name: str) -> bool:
        return name in self._registry


MetadataCatalog = _MetadataCatalog()
