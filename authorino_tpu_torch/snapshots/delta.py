"""Apply a delta plan as device uploads: only changed rows cross the link.

The previous snapshot's tensors stay untouched: in-flight batches are
pinned to that snapshot, and the native frontend's record holds its
params.  So a ``rows`` entry clones the previous tensor on the device and
copies the shipped rows into the clone (``index_copy_``), a ``full`` entry
uploads the new host array, and a ``reuse`` entry hands over the previous
tensor object itself.  The rebuilt tree is a fresh dict (and tuple) at
every level, built from the new host view's keys only, so nothing the
wrapper cached on the previous tree (``params["kernel"]["launch_words"]``:
the device pointers of tensors this upload may replace) carries over.
Python ints of the host view (the program's ``S``, ``tab_bytes``,
``max_local``, ``max_kids``, the ``bounds`` entries) come back as ints."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.operands import _put, host_array, resolve_device
from .diff import DeltaPlan

__all__ = ["apply_delta", "full_upload", "view_bytes"]


def view_bytes(view: Dict[str, Any]) -> int:
    """Total operand bytes of one host view (the full-upload cost)."""
    total = 0

    def walk(v):
        nonlocal total
        if v is None:
            return
        if isinstance(v, dict):
            for x in v.values():
                walk(x)
        elif isinstance(v, (tuple, list)):
            for x in v:
                walk(x)
        else:
            total += int(host_array(v).nbytes)

    walk(view)
    return total


def full_upload(view: Dict[str, Any], device=None) -> Tuple[Any, int]:
    """Stage every operand (the non-incremental path): the params tree on
    ``device`` (the card unless named) + bytes shipped."""
    return _put(view, resolve_device(device)), view_bytes(view)


def apply_delta(prev_params: Dict[str, Any], new_view: Dict[str, Any],
                plan: Optional[DeltaPlan], device=None) -> Tuple[Any, int]:
    """Build the new params on ``device`` (the card unless named) from the
    previous snapshot's tensors and the delta plan: (params, bytes
    shipped), the bytes equal to ``plan.upload_bytes``.  ``plan`` None
    uploads in full."""
    dev = resolve_device(device)
    if plan is None:
        return full_upload(new_view, dev)
    by_name = {e.name: e for e in plan.entries}
    uploaded = 0

    def leaf(name: str, new_h, prev_d):
        nonlocal uploaded
        e = by_name.get(name)
        if isinstance(new_h, (int, np.integer)):
            if e is not None and e.mode != "reuse":
                uploaded += int(np.asarray(new_h).nbytes)
            return int(new_h)
        if e is None or prev_d is None or e.mode == "full":
            uploaded += int(host_array(new_h).nbytes)
            return _put(new_h, dev)
        if e.mode == "reuse":
            return prev_d
        # rows: the changed leading-axis rows and their int32 indices
        # cross the link; the clone keeps the previous tensor unchanged
        uploaded += int(e.upload_bytes)
        rows = _put(new_h[torch.from_numpy(e.rows).long()]
                    if isinstance(new_h, torch.Tensor) else new_h[e.rows],
                    dev)
        idx = _put(e.rows, dev).long()
        out = prev_d.clone()
        out.index_copy_(0, idx, rows)
        return out

    def rebuild(prefix: str, new_v, prev_v):
        if new_v is None:
            return None
        if isinstance(new_v, dict):
            pd = prev_v if isinstance(prev_v, dict) else {}
            return {k: rebuild(f"{prefix}.{k}" if prefix else str(k),
                               new_v[k], pd.get(k)) for k in new_v}
        if isinstance(new_v, (tuple, list)):
            pt = prev_v if isinstance(prev_v, (tuple, list)) else ()
            return tuple(
                rebuild(f"{prefix}.{i}", x,
                        pt[i] if i < len(pt) else None)
                for i, x in enumerate(new_v))
        return leaf(prefix, new_v, prev_v)

    return rebuild("", new_view, prev_params), uploaded
