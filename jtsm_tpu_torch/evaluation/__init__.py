"""Evaluation of the model's outputs (JAX package ``evaluation/``): COCO
boxes and masks, semantic segmentation and panoptic quality, the scoring
slices' output side. The other evaluators wait (ROADMAP)."""

from .coco_evaluation import COCOEvaluator, batched_outputs_to_coco_json
from .cocoeval import COCOEval
from .evaluator import DatasetEvaluator, DatasetEvaluators, inference_on_dataset
from .panoptic_evaluation import COCOPanopticEvaluator, pq_compute_single_image
from .sem_seg_evaluation import SemSegEvaluator
from .testing import print_csv_format, verify_results

__all__ = [
    "COCOEval",
    "COCOEvaluator",
    "COCOPanopticEvaluator",
    "DatasetEvaluator",
    "DatasetEvaluators",
    "SemSegEvaluator",
    "batched_outputs_to_coco_json",
    "inference_on_dataset",
    "pq_compute_single_image",
    "print_csv_format",
    "verify_results",
]
