"""Traffic replay & what-if preflight (docs/replay.md).

Four layers composing the snapshot container, decision/attribution
provenance and the canary guards into "test a policy change against
yesterday's traffic with zero live exposure":

- :mod:`.capture`   — opt-in byte-bounded sampled request log (in-memory
  ring + checksummed on-disk segments), fed off the hot path;
- :mod:`.replay`    — offline verdict-diff: re-decide captured requests
  against two snapshots through the exact host oracle, flips grouped by
  (authconfig, rule) via provenance attribution;
- :mod:`.pregate`   — the reconcile preflight gate: a diff breaching the
  canary guard thresholds rejects the swap BEFORE the canary window;
- :mod:`.bench_load` — captured arrivals as bench.py's open-loop
  timetable (``--replay-log``).

Only the import-light capture surface is re-exported here; the replay /
pregate layers import the host oracle — pull them in explicitly:
``from authorino_tpu_torch.replay.replay import replay_records``.
"""

from .capture import (  # noqa: F401
    CAPTURE,
    CAPTURE_SCHEMA,
    CaptureFormatError,
    CaptureLog,
    read_capture,
    read_segment,
    write_segment,
)

__all__ = ["CAPTURE", "CAPTURE_SCHEMA", "CaptureFormatError", "CaptureLog",
           "read_capture", "read_segment", "write_segment"]
