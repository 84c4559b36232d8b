"""Datasets, the test mapper and the static-batch test loader (JAX package
``data/``): the scoring slice's input side. The train loader waits (ROADMAP)."""

from . import datasets  # noqa: F401  registers the builtin datasets
from .build import build_detection_test_loader, get_detection_dataset_dicts
from .catalog import DatasetCatalog, Metadata, MetadataCatalog
from .dataset_mapper import DatasetMapper

__all__ = [
    "DatasetCatalog",
    "DatasetMapper",
    "Metadata",
    "MetadataCatalog",
    "build_detection_test_loader",
    "get_detection_dataset_dicts",
]
