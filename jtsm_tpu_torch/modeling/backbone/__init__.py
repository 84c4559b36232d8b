from .fpn import FPN, build_backbone, build_resnet_fpn_backbone
from .resnet import ResNet, build_resnet_backbone

__all__ = ["FPN", "ResNet", "build_backbone", "build_resnet_backbone", "build_resnet_fpn_backbone"]
