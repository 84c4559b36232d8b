"""Evaluation of the model's outputs (JAX package ``evaluation/``): COCO
boxes, masks and keypoints, the proposals' recall, LVIS, Cityscapes
instances and semantics, semantic segmentation and panoptic quality, Pascal
VOC AP and CorLoc. The rotated COCO evaluator waits for the rotated family
(ROADMAP)."""

from .cityscapes_evaluation import CityscapesInstanceEvaluator, CityscapesSemSegEvaluator
from .coco_evaluation import COCOEvaluator, COCOProposalEvaluator, batched_outputs_to_coco_json
from .cocoeval import COCOEval, oks_iou
from .evaluator import DatasetEvaluator, DatasetEvaluators, inference_on_dataset
from .lvis_evaluation import LVISEval, LVISEvaluator
from .panoptic_evaluation import COCOPanopticEvaluator, pq_compute_single_image
from .pascal_voc_evaluation import PascalVOCDetectionEvaluator
from .sem_seg_evaluation import SemSegEvaluator
from .testing import print_csv_format, verify_results

__all__ = [
    "COCOEval",
    "COCOEvaluator",
    "COCOPanopticEvaluator",
    "COCOProposalEvaluator",
    "CityscapesInstanceEvaluator",
    "CityscapesSemSegEvaluator",
    "DatasetEvaluator",
    "DatasetEvaluators",
    "LVISEval",
    "LVISEvaluator",
    "PascalVOCDetectionEvaluator",
    "SemSegEvaluator",
    "batched_outputs_to_coco_json",
    "inference_on_dataset",
    "oks_iou",
    "pq_compute_single_image",
    "print_csv_format",
    "verify_results",
]
