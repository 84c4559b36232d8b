"""COCO evaluation of the model's outputs (JAX package ``evaluation/``):
the scoring slice's output side. The other evaluators wait (ROADMAP)."""

from .coco_evaluation import COCOEvaluator, batched_outputs_to_coco_json
from .cocoeval import COCOEval
from .evaluator import DatasetEvaluator, inference_on_dataset
from .testing import print_csv_format, verify_results

__all__ = [
    "COCOEval",
    "COCOEvaluator",
    "DatasetEvaluator",
    "batched_outputs_to_coco_json",
    "inference_on_dataset",
    "print_csv_format",
    "verify_results",
]
