"""One atomic-write discipline for the port's durable artifacts (the
flight recorder's bundles today): a tmp file in the destination directory,
write, flush, fsync, ``os.replace``.  A SIGKILL (or a power cut, modulo a
directory fsync) at any instant leaves the destination either old-valid or
new-valid, never half-written.

The writers double as the injection points of the fault plane's ``fs``
stage (runtime/faults.py): when faults are armed, each call consults
``FAULTS.fs_fault(artifact)`` and realizes the matched crash shape — torn /
short / rename-fail / eio / enospc — deterministically (prefix lengths come
from the armed seed).  Zero-cost when off: the hook is one ``sys.modules``
lookup unless this package's fault plane is loaded AND armed.  The lookup
names this package's module: a process that also loads the reference
package holds two planes, and only this one arms these writers.

A failure of any origin (real or injected) increments
``auth_server_state_write_failures_total{artifact}`` and leaves no stray
tmp file behind; the one deliberate exception is an injected *torn* write,
which scribbles a prefix over the destination itself — the crash aftermath
a reader must reject."""

from __future__ import annotations

import errno
import json
import os
import sys
from typing import Any, Optional

from . import metrics as metrics_mod

__all__ = ["atomic_write_bytes", "atomic_write_json", "atomic_write_text"]


_FAULTS_MODULE = "authorino_tpu_torch.runtime.faults"


def _fs_rule(artifact: str):
    """The armed fs-stage fault rule scoped to ``artifact``, or None.
    Reaches the fault plane through sys.modules, so an un-imported (and
    therefore un-armed) faults module costs one dict get."""
    faults = sys.modules.get(_FAULTS_MODULE)
    if faults is None or not faults.ACTIVE:
        return None
    return faults.FAULTS.fs_fault(artifact)


def _prefix_len(n: int) -> int:
    """Deterministic torn/short prefix length in [0, n), drawn from the
    fault plane's seeded rng."""
    faults = sys.modules[_FAULTS_MODULE]
    if n <= 1:
        return 0
    return int(faults.FAULTS.rand() * n) % n


def _inject(rule, path: str, tmp: str, data: bytes) -> None:
    """Realize one fs crash shape.  Always raises OSError; what is on disk
    afterwards is the point:

    - eio:         nothing written anywhere
    - enospc:      a prefix in tmp (caller unlinks it), destination intact
    - short:       a prefix in tmp (caller unlinks it), destination intact
    - rename-fail: full tmp (caller unlinks it), destination intact
    - torn:        a prefix over the DESTINATION
    """
    mode = rule.mode
    if mode == "eio":
        raise OSError(errno.EIO, f"injected fs:eio writing {path}")
    if mode in ("enospc", "short"):
        k = _prefix_len(len(data))
        with open(tmp, "wb") as f:
            f.write(data[:k])
            f.flush()
            os.fsync(f.fileno())
        if mode == "enospc":
            raise OSError(errno.ENOSPC,
                          f"injected fs:enospc after {k}/{len(data)} bytes "
                          f"of {path}")
        raise OSError(errno.EIO,
                      f"injected fs:short write: {k}/{len(data)} bytes "
                      f"of {path}")
    if mode == "rename-fail":
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        raise OSError(errno.EIO, f"injected fs:rename-fail replacing {path}")
    if mode == "torn":
        k = _prefix_len(len(data))
        with open(path, "wb") as f:
            f.write(data[:k])
            f.flush()
            os.fsync(f.fileno())
        raise OSError(errno.EIO,
                      f"injected fs:torn write: {k}/{len(data)} bytes tore "
                      f"{path}")
    raise OSError(errno.EIO, f"injected fs:{mode} writing {path}")


def atomic_write_bytes(path: str, data: bytes, artifact: str = "artifact",
                       fsync: bool = True) -> str:
    """Write ``data`` to ``path`` atomically (tmp + flush + fsync +
    os.replace).  ``artifact`` names the durable-artifact kind for the fs
    fault plane and the failure metric.  Raises OSError on failure — real
    or injected — with the destination left old-valid (except an injected
    torn write, by design) and the tmp file removed."""
    tmp = path + ".tmp"
    try:
        rule = _fs_rule(artifact)
        if rule is not None:
            _inject(rule, path, tmp, data)
        with open(tmp, "wb") as f:
            f.write(data)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        written = os.path.getsize(tmp)
        if written != len(data):
            raise OSError(errno.EIO,
                          f"short write: {written}/{len(data)} bytes of "
                          f"{path}")
        os.replace(tmp, path)
        return path
    except BaseException:
        metrics_mod.state_write_failures.labels(artifact).inc()
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_text(path: str, text: str, artifact: str = "artifact",
                      fsync: bool = True) -> str:
    return atomic_write_bytes(path, text.encode("utf-8"), artifact=artifact,
                              fsync=fsync)


def atomic_write_json(path: str, obj: Any, artifact: str = "artifact",
                      fsync: bool = True, indent: Optional[int] = None,
                      sort_keys: bool = False, default=None) -> str:
    text = json.dumps(obj, indent=indent, sort_keys=sort_keys,
                      default=default)
    return atomic_write_text(path, text, artifact=artifact, fsync=fsync)
