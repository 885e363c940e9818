"""The load generator's build: ``g++`` into ``benchmark/_build/`` under a
name that carries a digest of its source and flags, so only the first
run in a checkout compiles and an edited source never runs stale.
Processes that need it at once take turns on a lock file beside it."""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional, Tuple

BENCH_DIR = Path(__file__).resolve().parent.parent
BUILD_DIR = BENCH_DIR / "_build"
SOURCE = BENCH_DIR / "loadgen" / "loadgen.cpp"
FLAGS = ("-O2", "-std=c++17")


class BuildError(RuntimeError):
    """g++ is missing or refused the source."""


def build_loadgen() -> Tuple[Path, Optional[float]]:
    """(the generator's path, seconds spent compiling it here or None)."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"loadgen-{digest}"
    if out.exists():
        return out, None
    cxx = shutil.which("g++")
    if cxx is None:
        raise BuildError("g++ not found on PATH: the load generator cannot "
                         "be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(out.with_name(out.name + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out, None
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.monotonic()
        proc = subprocess.run([cxx, *FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise BuildError(f"g++ failed on {SOURCE.name} (exit "
                             f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
        return out, time.monotonic() - t0
