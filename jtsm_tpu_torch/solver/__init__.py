from .build import SGD, build_gradient_clipper, build_lr_schedule, build_optimizer, param_label
from .lr_scheduler import WarmupCosineLR, WarmupMultiStepLR, get_warmup_factor_at_iter

__all__ = [
    "SGD",
    "build_gradient_clipper",
    "WarmupCosineLR",
    "WarmupMultiStepLR",
    "build_lr_schedule",
    "build_optimizer",
    "get_warmup_factor_at_iter",
    "param_label",
]
