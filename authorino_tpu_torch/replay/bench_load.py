"""Replayed-traffic load model for a benchmark's open loop (layer 4).

The open-loop generator schedules SYNTHETIC arrival timetables
(steady/burst/diurnal/zipf) — honest about overload, but every artifact
measures a shape someone invented.  ``bench.py --replay-log DIR`` swaps
the synthetic timetable for a CAPTURED one: the recorded inter-arrival
gaps, key skew and per-request documents of a real (or previously
benched) traffic window, replayed open-loop.  BENCH artifacts become
reproducible against recorded traffic, and the block is stamped
``load_model="replay"`` so replay numbers can never masquerade as
synthetic open-loop ones (the ROADMAP bench-reality rule).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

__all__ = ["load_timetable"]


def load_timetable(source: str, *, speed: float = 1.0,
                   limit: Optional[int] = None
                   ) -> Tuple[List[float], List[str], List[Any],
                              Dict[str, Any]]:
    """Capture dir/segment → (offsets, authconfig names, docs, meta).

    Offsets are seconds from the first captured record, divided by
    ``speed`` (2.0 = replay twice as fast — time-compression for long
    capture windows); records sort by capture timestamp so an
    out-of-order multi-segment log still replays causally.  ``limit``
    truncates AFTER sorting (the head of the window, not a random
    subset)."""
    from .capture import CaptureFormatError, read_capture

    records = [r for r in read_capture(source)
               if r.get("doc") is not None and r.get("authconfig")]
    if not records:
        raise CaptureFormatError(
            f"capture log {source!r} holds no replayable records")
    records.sort(key=lambda r: float(r.get("t", 0.0)))
    if limit:
        records = records[:int(limit)]
    speed = max(float(speed), 1e-9)
    t0 = float(records[0].get("t", 0.0))
    offsets = [max(0.0, (float(r.get("t", 0.0)) - t0) / speed)
               for r in records]
    names = [str(r["authconfig"]) for r in records]
    docs = [r["doc"] for r in records]
    span = offsets[-1] if offsets else 0.0
    meta = {
        "source": str(source),
        "records": len(records),
        "span_s": round(span, 3),
        "speed": speed,
        "offered_rps": round(len(records) / span, 1) if span > 0 else None,
        "captured_deny_rate": round(
            sum(1 for r in records if r.get("verdict") == "deny")
            / len(records), 4),
    }
    return offsets, names, docs, meta
