"""One atomic-write discipline for the port's durable artifacts (the
flight recorder's bundles today): a tmp file in the destination directory,
write, flush, fsync, ``os.replace``.  A SIGKILL (or a power cut, modulo a
directory fsync) at any instant leaves the destination either old-valid or
new-valid, never half-written.

A failure increments ``auth_server_state_write_failures_total{artifact}``
and leaves no stray tmp file behind.  The reference's writers are also the
injection points of its fault plane's ``fs`` stage; the port has no fault
plane yet (ROADMAP queue 1 item 7), so these writers inject nothing."""

from __future__ import annotations

import errno
import json
import os
from typing import Any, Optional

from . import metrics as metrics_mod

__all__ = ["atomic_write_bytes", "atomic_write_json", "atomic_write_text"]


def atomic_write_bytes(path: str, data: bytes, artifact: str = "artifact",
                       fsync: bool = True) -> str:
    """Write ``data`` to ``path`` atomically (tmp + flush + fsync +
    os.replace).  ``artifact`` names the durable-artifact kind for the
    failure metric.  Raises OSError on failure, with the destination left
    old-valid and the tmp file removed."""
    tmp = path + ".tmp"
    try:
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
