"""The weakly supervised (WSL) plane of the port: the JTSM flagship's
serving, training and scoring paths (reference: projects/WSL; JAX package
``wsl/``). Importing it registers the VOC 2012 + SBD splits."""

from . import builtin  # noqa: F401  registers the VOC + SBD splits
from .config import add_wsl_config

__all__ = ["add_wsl_config"]
