from .cfgnode import CfgNode
from .defaults import get_cfg, mask_rcnn_gate_cfg, mask_rcnn_R_50_FPN_cfg
from .wsl import jtsm_gate_cfg, jtsm_WSR_18_DC5_cfg, wsl_cfg

__all__ = [
    "CfgNode",
    "get_cfg",
    "jtsm_WSR_18_DC5_cfg",
    "jtsm_gate_cfg",
    "mask_rcnn_R_50_FPN_cfg",
    "mask_rcnn_gate_cfg",
    "wsl_cfg",
]
