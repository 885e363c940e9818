"""Native (C++) host code of the port: the batch encoder, the gRPC frontend
and its load generator.

``native/csrc/encoder.cpp`` + ``frontend.cpp`` + ``pymod.cpp`` build into
one CPython extension module (``_atpuenc_torch``).  The encoder is the host
half of the hot path — selector walk → gjson-String render → intern lookup
→ tensor scatter — with two front-ends:

  - ``encode_docs``: walks the Python dict documents directly (no JSON
    round-trip); default.
  - ``encode_json``: parses a JSON blob with the interpreter lock released,
    on threads of its own (AUTHORINO_TPU_ENCODE_MODE=json).

The ``fe_*`` functions are the epoll HTTP/2 gRPC server of
``runtime/native_frontend.py``; it loads the system's ``libnghttp2`` with
``dlopen`` at its start (hence ``-ldl``), so the encoder builds and loads
without it.

``compiler/encode.py``'s Python implementation is the semantic reference.
The library is built at first use with ``g++`` from the sources under
``native/csrc/`` into ``authorino_tpu_torch/_build/``, under a name that
carries a digest of the sources, flags and interpreter.  Processes
that need it at once (test workers) take turns on a file lock beside it,
so one compiles and the others load its result; the compiler writes a
temporary name that is renamed into place.  A failed build raises
``BuildError``, as a failed ``nvcc`` does: nothing falls back to the
Python encoder in silence.
``AUTHORINO_TPU_NATIVE=0`` asks for the Python encoder.

``build_loadgen()`` compiles ``native/csrc/loadgen.cpp``, a standalone
HTTP/2 gRPC load generator (no library beyond libc), into the same build
directory under a digest name, and returns its path.
"""

from __future__ import annotations

import fcntl
import hashlib
import importlib.util
import os
import shutil
import subprocess
import sys
import sysconfig
import threading
import time
from pathlib import Path
from typing import Optional

from ..ops._build import BUILD_DIR, BuildError

__all__ = ["BuildError", "load_library", "native_enabled", "library_path",
           "build_seconds", "build_loadgen", "NativeEncoder",
           "get_native_encoder", "CSRC_DIR", "CXX", "CXX_FLAGS", "SOURCES",
           "LOADGEN_SOURCE"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
# pymod.cpp #includes encoder.cpp and frontend.cpp
SOURCES = ("encoder.cpp", "frontend.cpp", "pymod.cpp")
CXX = "g++"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")
# frontend.cpp dlopens libnghttp2
LINK_FLAGS = ("-ldl",)
# the load generator: a program of its own, not part of the extension
LOADGEN_SOURCE = "loadgen.cpp"
LOADGEN_FLAGS = ("-O2", "-std=c++17")
MODULE = "_atpuenc_torch"

_LOCK = threading.Lock()
_MOD = None
_BUILD_S: Optional[float] = None


def native_enabled() -> bool:
    return os.environ.get("AUTHORINO_TPU_NATIVE", "1") not in ("0", "false", "no")


def _include_dir() -> str:
    return sysconfig.get_paths()["include"]


def library_path() -> Path:
    """Where the library for the current sources, flags and interpreter
    lives (built or not)."""
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((CSRC_DIR / name).read_bytes())
    h.update(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    h.update(_include_dir().encode())
    h.update(sys.version.encode())
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return BUILD_DIR / f"{MODULE}-{h.hexdigest()[:16]}{suffix}"


def _build(out: Path) -> None:
    cxx = shutil.which(CXX)
    if cxx is None:
        raise BuildError(f"{CXX} not found on PATH: the native encoder "
                         "cannot be built")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-I", _include_dir(),
           str(CSRC_DIR / "pymod.cpp"), *LINK_FLAGS, "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise BuildError(f"{CXX} could not run on pymod.cpp: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise BuildError(f"{CXX} failed on pymod.cpp (exit {proc.returncode}):"
                         f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def load_library():
    """The imported ``_atpuenc_torch`` extension, built if its library is
    missing.  Raises BuildError when the build or the import fails."""
    global _MOD, _BUILD_S
    if _MOD is not None:
        return _MOD
    with _LOCK:
        if _MOD is not None:
            return _MOD
        out = library_path()
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            with open(out.with_name(out.name + ".lock"), "w") as lock:
                # one compile per digest across processes; the kernel
                # drops the lock if its holder dies
                fcntl.flock(lock, fcntl.LOCK_EX)
                if not out.exists():
                    t0 = time.perf_counter()
                    _build(out)
                    _BUILD_S = time.perf_counter() - t0
        try:
            spec = importlib.util.spec_from_file_location(MODULE, str(out))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        except (ImportError, OSError) as e:
            raise BuildError(f"native encoder {out.name} does not load: "
                             f"{e}") from e
        _MOD = mod
        return _MOD


def _compile_locked(out: Path, cmd_of) -> None:
    """Compile to ``out`` unless present, one compile per digest across
    processes (an flock beside it); ``cmd_of(tmp)`` is the command."""
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.with_name(out.name + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return
        tmp = out.with_name(
            f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        try:
            proc = subprocess.run(cmd_of(tmp), capture_output=True,
                                  text=True, timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            raise BuildError(f"{CXX} could not run: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise BuildError(f"{CXX} failed (exit {proc.returncode}):\n"
                             f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)


def build_loadgen() -> Path:
    """Path of the load generator built from ``csrc/loadgen.cpp`` (built
    here if missing).  Usage: ``loadgen <host> <port> <payload_file>
    <seconds> <warmup_s> <depth> <conns>``; the payload file holds
    [u32 big-endian length][CheckRequest bytes] records; it prints one
    JSON line (rps, p50/p99 ms, ...).  Raises BuildError."""
    src = CSRC_DIR / LOADGEN_SOURCE
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(LOADGEN_FLAGS).encode())
    out = BUILD_DIR / f"loadgen-{h.hexdigest()[:16]}"
    if not out.exists():
        cxx = shutil.which(CXX)
        if cxx is None:
            raise BuildError(f"{CXX} not found on PATH: the load generator "
                             "cannot be built")
        _compile_locked(out, lambda tmp: [cxx, *LOADGEN_FLAGS, str(src),
                                          "-o", str(tmp)])
    return out


def build_seconds() -> Optional[float]:
    """Seconds this process spent compiling the library (None: it was
    loaded from an earlier build, or not yet loaded)."""
    return _BUILD_S


from .encoder import NativeEncoder, get_native_encoder  # noqa: E402,F401
