from .panoptic_fpn import PanopticFPN
from .rcnn import GeneralizedRCNN, ProposalNetwork, build_model
from .retinanet import RetinaNet
from .semantic_seg import SemanticSegmentor

__all__ = ["GeneralizedRCNN", "PanopticFPN", "ProposalNetwork", "RetinaNet", "SemanticSegmentor", "build_model"]
