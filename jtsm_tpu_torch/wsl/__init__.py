"""The weakly supervised (WSL) plane of the port: the JTSM flagship's
serving and training paths (reference: projects/WSL; JAX package
``wsl/``)."""

from .config import add_wsl_config

__all__ = ["add_wsl_config"]
