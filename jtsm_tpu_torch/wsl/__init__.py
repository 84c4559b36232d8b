"""The weakly supervised (WSL) plane of the port: the serving, training and
scoring paths of the JTSM flagship and of the WSOD baselines (WSDDN, OICR,
PCL) (reference: projects/WSL; JAX package ``wsl/``). Importing it
registers the VOC 2012 + SBD splits."""

from . import builtin  # noqa: F401  registers the VOC + SBD splits
from .config import add_wsl_config

__all__ = ["add_wsl_config"]
