"""The card, read without a CUDA context of the harness's own while the
server runs: ``torch.cuda`` only counts cards (NVML), and ``nvidia-smi``
reads the memory in use, the name and the power limit."""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import List, Optional

NVML_CHECK = "PYTORCH_NVML_BASED_CUDA_CHECK"


def cards() -> int:
    """How many CUDA cards ``torch`` sees (0 without one), counted through
    NVML: no driver context in this process, and none passed on to the
    server's environment."""
    import torch

    before = os.environ.get(NVML_CHECK)
    os.environ[NVML_CHECK] = "1"
    try:
        if not torch.cuda.is_available():
            return 0
        return torch.cuda.device_count()
    finally:
        if before is None:
            del os.environ[NVML_CHECK]
        else:
            os.environ[NVML_CHECK] = before


def physical_index(ordinal: int = 0) -> str:
    """nvidia-smi's index of the process's CUDA ``ordinal``."""
    vis = os.environ.get("CUDA_VISIBLE_DEVICES", "")
    ids = [v.strip() for v in vis.split(",") if v.strip()]
    return ids[ordinal] if ordinal < len(ids) else str(ordinal)


def smi(fields: str, ordinal: int = 0) -> Optional[List[str]]:
    """One card's ``--query-gpu`` fields, or None without nvidia-smi."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    out = subprocess.run([exe, f"--query-gpu={fields}",
                          "--format=csv,noheader,nounits", "-i",
                          physical_index(ordinal)],
                         capture_output=True, text=True, timeout=30)
    if out.returncode != 0 or not out.stdout.strip():
        return None
    return [x.strip() for x in out.stdout.strip().splitlines()[0].split(",")]


def memory_used_bytes() -> Optional[int]:
    r = smi("memory.used")
    return int(float(r[0]) * 2**20) if r else None


def power_limit_w() -> Optional[str]:
    r = smi("power.limit")
    return r[0] if r else None


def name() -> str:
    """The card's name as ``torch.cuda.get_device_name`` gives it (call
    once the server has stopped: it opens a context)."""
    import torch

    return torch.cuda.get_device_name(0)
