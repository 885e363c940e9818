"""Build and load the port's CUDA kernels.

The sources under ``ops/csrc/`` have a plain C interface, so each compiles
with ``nvcc`` alone (no PyTorch headers) into a shared library that
``ctypes`` loads.  A library is built at first use, from the sources in the
checkout, into ``authorino_tpu_torch/_build/`` under a name that carries a
digest of its source and flags, so an edited source never loads a stale
library.  A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

__all__ = ["BuildError", "find_nvcc", "load_library", "build_seconds",
           "build_log", "BUILD_DIR", "CSRC_DIR", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = _PKG / "_build"
CSRC_DIR = Path(__file__).resolve().parent / "csrc"
CUDA_ROOT_DEFAULT = "/usr/local/cuda"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_BUILD_S: Dict[str, float] = {}
_BUILD_LOG: Dict[str, str] = {}


class BuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def find_nvcc() -> str:
    """``nvcc`` from PATH, else ``$CUDA_HOME/bin``, else the toolkit's
    default install root; raises BuildError when none exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), CUDA_ROOT_DEFAULT):
        if root:
            cand = Path(root) / "bin" / "nvcc"
            if cand.is_file() and os.access(cand, os.X_OK):
                return str(cand)
    raise BuildError(
        "nvcc not found on PATH, under $CUDA_HOME/bin or under "
        f"{CUDA_ROOT_DEFAULT}/bin: the CUDA kernels cannot be built")


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built if needed)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        src = CSRC_DIR / f"{name}.cu"
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        out = BUILD_DIR / f"lib{name}-{digest}.so"
        if not out.exists():
            nvcc = find_nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise BuildError(
                    f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
            _BUILD_S[name] = time.perf_counter() - t0
            _BUILD_LOG[name] = proc.stdout + proc.stderr
        lib = ctypes.CDLL(str(out))
        _LIBS[name] = lib
        return lib


def build_seconds(name: str) -> Optional[float]:
    """Seconds this process spent compiling ``name`` (None: it was loaded
    from an earlier build)."""
    return _BUILD_S.get(name)


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory report) for ``name``
    when this process built it."""
    return _BUILD_LOG.get(name, "")
