from .cfgnode import CfgNode
from .defaults import get_cfg, mask_rcnn_gate_cfg, mask_rcnn_R_50_FPN_cfg

__all__ = ["CfgNode", "get_cfg", "mask_rcnn_R_50_FPN_cfg", "mask_rcnn_gate_cfg"]
