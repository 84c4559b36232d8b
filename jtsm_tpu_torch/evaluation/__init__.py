"""Evaluation of the model's outputs (JAX package ``evaluation/``): COCO
boxes, masks and keypoints, the proposals' recall, semantic segmentation and
panoptic quality, Pascal VOC AP and CorLoc, the scoring slices' output
side. The other evaluators wait (ROADMAP)."""

from .coco_evaluation import COCOEvaluator, COCOProposalEvaluator, batched_outputs_to_coco_json
from .cocoeval import COCOEval, oks_iou
from .evaluator import DatasetEvaluator, DatasetEvaluators, inference_on_dataset
from .panoptic_evaluation import COCOPanopticEvaluator, pq_compute_single_image
from .pascal_voc_evaluation import PascalVOCDetectionEvaluator
from .sem_seg_evaluation import SemSegEvaluator
from .testing import print_csv_format, verify_results

__all__ = [
    "COCOEval",
    "COCOEvaluator",
    "COCOPanopticEvaluator",
    "COCOProposalEvaluator",
    "DatasetEvaluator",
    "DatasetEvaluators",
    "PascalVOCDetectionEvaluator",
    "SemSegEvaluator",
    "batched_outputs_to_coco_json",
    "inference_on_dataset",
    "oks_iou",
    "pq_compute_single_image",
    "print_csv_format",
    "verify_results",
]
