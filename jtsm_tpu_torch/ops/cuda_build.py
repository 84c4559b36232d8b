"""Build a CUDA source of this package into a shared library and load it.

Each source under ``ops/csrc/`` has a plain ``extern "C"`` interface and
includes no PyTorch header, so ``nvcc`` builds it in seconds. The library
goes into ``build/jtsm_tpu_torch_kernels/`` at the root of the checkout
(listed in ``.gitignore``) at first use in a process; a stale library of the
same name is removed first, so what runs is always built from the sources
in the checkout. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
BUILD_DIR = PACKAGE_DIR.parent / "build" / "jtsm_tpu_torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # keep each float operation as written, so a kernel's arithmetic is
    # that of its plain PyTorch version
    "-fmad=false",
    "-Xptxas", "-v",
]


@dataclass
class BuiltLibrary:
    lib: ctypes.CDLL
    path: Path
    seconds: float
    ptxas_log: str


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def build(name: str, source: str) -> BuiltLibrary:
    """Compile ``ops/csrc/<source>`` into ``lib<name>.so`` and load it."""
    src = PACKAGE_DIR / "ops" / "csrc" / source
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"lib{name}.so"
    out.unlink(missing_ok=True)
    tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.so"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {src}:\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    # ptxas -v: registers, stack and spills of each kernel
    log = "\n".join(
        line.strip() for line in (proc.stdout + proc.stderr).splitlines()
        if "ptxas" in line or "spill" in line
    )
    return BuiltLibrary(ctypes.CDLL(str(out)), out, seconds, log)
