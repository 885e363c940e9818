"""Snapshot diff plans — which configs changed, which operand rows they
touch, and what a delta upload ships vs a full re-stage.

Numpy over the host views: the same plan drives the reconcile-time delta
H2D upload (snapshots/delta.py) and ``format_snapshot_diff``'s report.  A
plan is computed between two HOST operand views (the port's
``ops/operands.py::host_view``: any lane's whole nested operand tree, the
matmul subtree and its ``level_mats`` included, plus the fused lane's
per-config program or the other lanes' bounds); per operand it picks:

  reuse — byte-identical array: the previous device tensor serves as-is,
          zero bytes cross the link
  rows  — same shape/dtype, a minority of leading-axis rows differ: ship
          only those rows + their indices (a device-side row copy)
  full  — shape/dtype changed, or so many rows differ that a full
          re-stage is cheaper than the row copy

Exactness is trivial by construction: the plan only decides HOW the new
host arrays reach the device, never what they contain.  A CSR offset
column that shifts (a config whose program changed size moves every later
config's offsets) differs in most of its rows, so it goes ``full``."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ["ArrayDelta", "DeltaPlan", "flatten_view", "plan_delta",
           "snapshot_diff", "format_snapshot_diff"]

# a rows-delta must beat a full upload by at least 2x to be worth the
# row copy's index traffic and launch overhead
_ROWS_WIN_FACTOR = 2


@dataclass
class ArrayDelta:
    name: str
    mode: str                          # "reuse" | "rows" | "full"
    rows: Optional[np.ndarray] = None  # changed leading-axis indices (rows)
    upload_bytes: int = 0
    full_bytes: int = 0

    def to_json(self) -> Dict[str, Any]:
        return {
            "name": self.name, "mode": self.mode,
            "rows": int(self.rows.shape[0]) if self.rows is not None else 0,
            "upload_bytes": int(self.upload_bytes),
            "full_bytes": int(self.full_bytes),
        }


@dataclass
class DeltaPlan:
    entries: List[ArrayDelta] = field(default_factory=list)
    upload_bytes: int = 0
    full_bytes: int = 0

    @property
    def mode(self) -> str:
        if not self.entries:
            return "full"
        if all(e.mode == "reuse" for e in self.entries):
            return "reuse"
        return "delta"

    def to_json(self) -> Dict[str, Any]:
        touched = [e.to_json() for e in self.entries if e.mode != "reuse"]
        return {
            "mode": self.mode,
            "upload_bytes": int(self.upload_bytes),
            "full_bytes": int(self.full_bytes),
            "arrays_reused": sum(1 for e in self.entries if e.mode == "reuse"),
            "arrays_touched": touched,
        }


def flatten_view(view: Dict[str, Any]) -> Dict[str, Optional[np.ndarray]]:
    """Flatten a host operand tree to named numpy leaves — generic over
    nested dicts/tuples (a python int, such as the program's ``S`` or a
    ``bounds`` entry, becomes a 0-d array; a bf16 matrix of the matmul
    lane, a CPU tensor, its int16 bit pattern)."""
    from ..ops.operands import host_array

    out: Dict[str, Optional[np.ndarray]] = {}

    def walk(prefix: str, v: Any) -> None:
        if v is None:
            out[prefix] = None
        elif isinstance(v, dict):
            for k in v:
                walk(f"{prefix}.{k}" if prefix else str(k), v[k])
        elif isinstance(v, (tuple, list)):
            for i, x in enumerate(v):
                walk(f"{prefix}.{i}", x)
        else:
            out[prefix] = host_array(v)

    walk("", view)
    return out


def _delta_one(name: str, old: np.ndarray, new: np.ndarray,
               rows_win_factor: float = _ROWS_WIN_FACTOR) -> ArrayDelta:
    full = int(new.nbytes)
    if old.shape != new.shape or old.dtype != new.dtype:
        return ArrayDelta(name, "full", upload_bytes=full, full_bytes=full)
    if old is new or np.array_equal(old, new):
        return ArrayDelta(name, "reuse", full_bytes=full)
    if new.ndim >= 1 and new.shape[0] > 1:
        diff = old != new
        if diff.ndim > 1:
            diff = diff.reshape(diff.shape[0], -1).any(axis=1)
        idx = np.nonzero(diff)[0].astype(np.int32)
        row_bytes = int(new[idx].nbytes + idx.nbytes)
        if row_bytes * rows_win_factor <= full:
            return ArrayDelta(name, "rows", rows=idx,
                              upload_bytes=row_bytes, full_bytes=full)
    return ArrayDelta(name, "full", upload_bytes=full, full_bytes=full)


def plan_delta(old_view: Optional[Dict[str, Any]],
               new_view: Dict[str, Any],
               rows_win_factor: float = _ROWS_WIN_FACTOR
               ) -> Optional[DeltaPlan]:
    """Diff two host operand views into a delta plan, or None when no
    structure-preserving delta exists (a kernel-lane change, a level-count
    change, a DFA, numeric or relation lane appearing/vanishing, or no
    previous view at all) — the caller then uploads in full.

    ``rows_win_factor`` sets how decisively a rows-delta must beat the full
    upload.  The mesh lane passes 1.0: there the leading axis is the shard
    axis, and shipping any strict subset of shards is the point."""
    if old_view is None:
        return None
    old_flat = flatten_view(old_view)
    new_flat = flatten_view(new_view)
    if set(old_flat) != set(new_flat):
        # level count changed, or a whole lane appeared or vanished: the
        # buffer layout reshuffled, restage everything
        return None
    plan = DeltaPlan()
    for name in new_flat:
        o, n = old_flat[name], new_flat[name]
        if o is None and n is None:
            continue  # e.g. no DFA lane on either side
        if o is None or n is None:
            return None  # a lane appeared/vanished: full restage
        plan.entries.append(_delta_one(name, o, n, rows_win_factor))
    plan.upload_bytes = sum(e.upload_bytes for e in plan.entries)
    plan.full_bytes = sum(e.full_bytes for e in plan.entries)
    return plan


# ---------------------------------------------------------------------------
# Config-level diff (fingerprint maps) + its human-readable rendering
# ---------------------------------------------------------------------------


def snapshot_diff(old_fps: Dict[str, str],
                  new_fps: Dict[str, str]) -> Dict[str, Any]:
    """Name-level diff of two fingerprint maps: which configs a reconcile
    must recompile (added + changed), which verdict-cache entries survive
    (unchanged), and which die (removed + changed)."""
    old_names, new_names = set(old_fps), set(new_fps)
    added = sorted(new_names - old_names)
    removed = sorted(old_names - new_names)
    changed = sorted(n for n in (old_names & new_names)
                     if old_fps[n] != new_fps[n])
    unchanged = sorted(n for n in (old_names & new_names)
                       if old_fps[n] == new_fps[n])
    return {
        "added": added, "removed": removed, "changed": changed,
        "unchanged": len(unchanged),
        "recompile": sorted(set(added) | set(changed)),
    }


def format_snapshot_diff(old_meta: Dict[str, Any], new_meta: Dict[str, Any],
                         old_view: Optional[Dict[str, Any]] = None,
                         new_view: Optional[Dict[str, Any]] = None) -> str:
    """Human-readable diff between two (de)serialized snapshots: the
    config-level recompile set, then the operand-level rows/bytes a delta
    upload would ship.  ``*_meta`` carry the per-config fingerprint maps
    (snapshots/serialize.py header meta)."""
    d = snapshot_diff(old_meta.get("fingerprints", {}),
                      new_meta.get("fingerprints", {}))
    lines = [
        f"snapshot diff: generation {old_meta.get('generation', '?')} -> "
        f"{new_meta.get('generation', '?')}",
        f"  configs: {d['unchanged']} unchanged, "
        f"{len(d['changed'])} changed, {len(d['added'])} added, "
        f"{len(d['removed'])} removed",
    ]
    for kind in ("changed", "added", "removed"):
        for name in d[kind][:16]:
            lines.append(f"    {kind}: {name}")
        extra = len(d[kind]) - 16
        if extra > 0:
            lines.append(f"    ... and {extra} more {kind}")
    lines.append(f"  recompile set: {len(d['recompile'])} config(s)")
    if new_view is not None:
        plan = plan_delta(old_view, new_view)
        if plan is None:
            lines.append("  upload: FULL re-stage (no structure-preserving "
                         "delta between these snapshots)")
        else:
            lines.append(
                f"  upload: {plan.mode} — {plan.upload_bytes:,} bytes vs "
                f"{plan.full_bytes:,} full "
                f"({sum(1 for e in plan.entries if e.mode == 'reuse')} "
                f"operand(s) reused as-is)")
            for e in plan.entries:
                if e.mode == "reuse":
                    continue
                rows = (f"{int(e.rows.shape[0])} row(s)"
                        if e.rows is not None else "all")
                lines.append(f"    {e.name}: {e.mode} ({rows}, "
                             f"{e.upload_bytes:,} bytes)")
    return "\n".join(lines)
