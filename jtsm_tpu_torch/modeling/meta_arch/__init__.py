from .rcnn import GeneralizedRCNN, build_model

__all__ = ["GeneralizedRCNN", "build_model"]
