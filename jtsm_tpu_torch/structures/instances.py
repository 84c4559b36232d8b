"""Per-image ground truth on the host (reference:
detectron2/structures/instances.py:8; JAX package
``structures/instances.py:20``), as far as the train mapper and the
collator need it: named fields of one length (numpy arrays or
:class:`PolygonMasks`), set and read as attributes, sliced together."""

from __future__ import annotations

from typing import Any, Dict, Tuple


class Instances:
    def __init__(self, image_size: Tuple[int, int], **fields: Any):
        self._image_size = tuple(int(x) for x in image_size)
        self._fields: Dict[str, Any] = {}
        for k, v in fields.items():
            self.set(k, v)

    @property
    def image_size(self) -> Tuple[int, int]:
        return self._image_size

    def __setattr__(self, name: str, val: Any) -> None:
        if name.startswith("_"):
            super().__setattr__(name, val)
        else:
            self.set(name, val)

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_") or name not in self._fields:
            raise AttributeError(f"Cannot find field '{name}' in the given Instances!")
        return self._fields[name]

    def set(self, name: str, value: Any) -> None:
        if self._fields and len(value) != len(self):
            raise AssertionError(f"Adding a field of length {len(value)} to a Instances of length {len(self)}")
        self._fields[name] = value

    def has(self, name: str) -> bool:
        return name in self._fields

    def get_fields(self) -> Dict[str, Any]:
        return self._fields

    def __getitem__(self, item) -> "Instances":
        """The instances that ``item`` (a bool mask, indices or a slice)
        selects, every field alike."""
        return Instances(self._image_size, **{k: v[item] for k, v in self._fields.items()})

    def __len__(self) -> int:
        for v in self._fields.values():
            return len(v)
        return 0
