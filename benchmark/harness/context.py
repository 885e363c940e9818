"""What a run hands its metrics' readers (``metrics/<name>.py``, each a
``read(run)`` that returns a number or None where it finds nothing to
read)."""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from harness.cells import BENCH_DIR
from harness.judge import Judgement
from harness.trace import DeviceTrace


@dataclass
class RunData:
    trace_on: bool
    setup_s: float = 0.0
    lg: dict = field(default_factory=dict)          # the generator's line
    judgement: Optional[Judgement] = None
    # the native frontend's counters at the window's edges (traced runs)
    fe_window: Tuple[Optional[dict], Optional[dict]] = (None, None)
    # the device's ops in the traced window (traced runs on a card)
    trace: Optional[DeviceTrace] = None
    card: str = ""
    power_limit_w: Optional[str] = None
    reference: object = None
    requests: list = field(default_factory=list)   # in payload order

    @staticmethod
    def _delta(pair) -> Optional[Dict[str, int]]:
        a, b = pair
        if a is None or b is None:
            return None
        return {k: b[k] - a.get(k, 0) for k in b
                if isinstance(b[k], (int, float))}

    def window_counts(self) -> Optional[Dict[str, int]]:
        return self._delta(self.fe_window)

    def work_per_row(self) -> Optional[Tuple[float, float]]:
        """(bytes moved, integer operations) of the mean device row over
        the payload set, by the reference's own-config count (requests
        that need no device row left out)."""
        works = [w for w in (self.reference.row_work(r)
                             for r in self.requests) if w is not None]
        if not works:
            return None
        n = len(works)
        return (sum(r + w for r, w, _ in works) / n,
                sum(o for _, _, o in works) / n)

    def peaks(self) -> Optional[dict]:
        """This card's row of ``peaks.json``, matched by name prefix."""
        table = json.loads((BENCH_DIR / "peaks.json").read_text())
        for prefix, row in table["cards"].items():
            if self.card.startswith(prefix):
                return row
        return None
