from .c2_model_loading import convert_c2_detectron_names, load_reference_pkl
from .convert import load_gate_ckpt, random_state_dict, select_class_rows, variables_to_state_dict
from .detection_checkpoint import DetectionCheckpointer, PeriodicCheckpointer

__all__ = [
    "DetectionCheckpointer",
    "PeriodicCheckpointer",
    "convert_c2_detectron_names",
    "load_gate_ckpt",
    "load_reference_pkl",
    "random_state_dict",
    "select_class_rows",
    "variables_to_state_dict",
]
