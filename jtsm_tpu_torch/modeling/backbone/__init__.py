from .fpn import FPN, LastLevelP6P7, build_backbone, build_resnet_fpn_backbone, build_retinanet_resnet_fpn_backbone
from .resnet import ResNet, build_resnet_backbone

__all__ = [
    "FPN",
    "LastLevelP6P7",
    "ResNet",
    "build_backbone",
    "build_resnet_backbone",
    "build_resnet_fpn_backbone",
    "build_retinanet_resnet_fpn_backbone",
]
