"""Datasets, the mapper and the static-batch train and test loaders (JAX
package ``data/``)."""

from . import datasets  # noqa: F401  registers the builtin datasets
from .build import build_detection_test_loader, build_detection_train_loader, get_detection_dataset_dicts
from .catalog import DatasetCatalog, Metadata, MetadataCatalog
from .dataset_mapper import DatasetMapper

__all__ = [
    "DatasetCatalog",
    "DatasetMapper",
    "Metadata",
    "MetadataCatalog",
    "build_detection_test_loader",
    "build_detection_train_loader",
    "get_detection_dataset_dicts",
]
