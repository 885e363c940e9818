"""The JAX package's native extension (``_atpuenc``), loaded steadily for the
port's tests.

``authorino_tpu.native.load_library`` builds into one fixed temporary name
(``_build/_atpuenc.so.tmp``) and then renames it.  When several pytest-xdist
workers import modules that load it at once from a checkout with no
``_build/``, two builds can share that name: one renames the other's file
away, its own rename then fails with ENOENT, and its process remembers the
failure (``_load_failed``) for the rest of its life.  Every port test in
that worker that reaches the reference's encoder or native frontend would
then fail for a reason that is not the port's.

``ref_native_library()`` serialises the port tests' loads on a lock file
and, where the reference's load failed while a complete library stands
newer than every source its staleness check reads (the race was lost to a
build that did finish), clears the remembered failure and loads again.  It
fails the calling test with the build's own message when there is still no
library; it never skips.  No file of the JAX package is touched: only its
module state, at test time.
"""

from __future__ import annotations

import fcntl
import logging
import os
import tempfile

import pytest

_LOCK_PATH = os.path.join(tempfile.gettempdir(), "authorino_tpu_ref_native.lock")


class _Messages(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _fresh(native) -> bool:
    """A built library newer than every source ``load_library`` checks."""
    try:
        built = os.path.getmtime(native._LIB_PATH)
        return built >= max(
            os.path.getmtime(os.path.join(native._NATIVE_DIR, f))
            for f in ("encoder.cpp", "frontend.cpp", "pymod.cpp"))
    except OSError:
        return False


def ref_native_library():
    """The reference's loaded ``_atpuenc`` module; fails the test (with the
    build's own log message) when it cannot be had."""
    from authorino_tpu import native

    handler = _Messages()
    logger = logging.getLogger("authorino_tpu.native")
    logger.addHandler(handler)
    try:
        with open(_LOCK_PATH, "a") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                mod = native.load_library()
                if mod is None and native._load_failed and _fresh(native):
                    # a concurrent build won the rename: its library is
                    # whole, so this process's remembered failure is stale
                    native._load_failed = False
                    mod = native.load_library()
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
    finally:
        logger.removeHandler(handler)
    if mod is None:
        pytest.fail("the reference's native library is unavailable: "
                    + ("; ".join(handler.messages) or "no build message"
                       + (" (AUTHORINO_TPU_NATIVE disables it)"
                          if not native.native_enabled() else "")))
    return mod
