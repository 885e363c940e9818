"""Multi-window SLO burn-rate tracking (the reference's utils/slo.py).

One tracker per serving lane.  The SLI is request goodness: a request is
*bad* when its observed latency exceeds the ``--slo-ms`` target or it failed
with a serving error (typed deadline/overload rejections are the protection
mechanism working, so callers decide which errors burn budget).  The burn
rate over a window is

    burn = (bad / total in window) / (1 - objective)

i.e. 1.0 means the lane is burning its error budget exactly at the rate
that would exhaust it at the SLO period's end; the Google SRE multi-window
multi-burn rule (alert when BOTH a short and a long window burn hot — fast
detection without flapping) is why several windows are tracked at once.

Implementation: a ring of per-second (total, bad) buckets sized to the
longest window, fed per BATCH (counts, not per-request observes — the
native fast lane's zero-per-request-Python contract), folded into
auth_server_slo_burn_rate{lane,window} gauges at most once per second.
Thread-safe; everything is O(1) per batch plus an O(window) fold on the
1 Hz gauge refresh."""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional, Sequence, Tuple

from . import metrics as metrics_mod

__all__ = ["SloTracker", "KeyedBurn", "DEFAULT_WINDOWS"]

# (seconds, label) — short windows page, long windows confirm
DEFAULT_WINDOWS: Tuple[Tuple[int, str], ...] = (
    (60, "1m"), (300, "5m"), (3600, "1h"))


class SloTracker:
    def __init__(self, lane: str, slo_ms: float, objective: float = 0.999,
                 windows: Sequence[Tuple[int, str]] = DEFAULT_WINDOWS):
        self.lane = lane
        self.slo_ms = float(slo_ms)
        self.slo_s = self.slo_ms / 1e3
        self.objective = min(max(float(objective), 0.0), 0.999999)
        self.budget = 1.0 - self.objective
        self.windows = tuple(windows)
        self._span = max(w for w, _ in self.windows)
        # per-second ring: index = epoch_second % span
        self._totals = [0] * self._span
        self._bad = [0] * self._span
        self._stamp = [0] * self._span   # epoch second each bucket holds
        self._lock = threading.Lock()
        self._last_gauge = 0.0
        self.total = 0
        self.bad_total = 0
        self._g = {label: metrics_mod.slo_burn_rate.labels(lane, label)
                   for _, label in self.windows}
        self._c_bad = metrics_mod.slo_bad_total.labels(lane)
        self._c_total = metrics_mod.slo_observed_total.labels(lane)

    # -- feeding -----------------------------------------------------------

    def observe(self, n: int, n_bad: int,
                now: Optional[float] = None) -> None:
        """Fold one batch: ``n`` requests observed, ``n_bad`` of them over
        the latency target (or errored).  One call per micro-batch."""
        if n <= 0:
            return
        now = time.time() if now is None else now
        sec = int(now)
        i = sec % self._span
        with self._lock:
            if self._stamp[i] != sec:
                self._stamp[i] = sec
                self._totals[i] = 0
                self._bad[i] = 0
            self._totals[i] += n
            self._bad[i] += n_bad
            self.total += n
            self.bad_total += n_bad
        self._c_total.inc(n)
        if n_bad:
            self._c_bad.inc(n_bad)
        if now - self._last_gauge >= 1.0:
            self._last_gauge = now
            self._refresh_gauges(sec)

    def observe_errors(self, n: int, now: Optional[float] = None) -> None:
        """Serving errors burn the whole budget for their requests."""
        self.observe(n, n, now=now)

    # -- reading -----------------------------------------------------------

    def _window_counts(self, window_s: int, sec: int) -> Tuple[int, int]:
        total = bad = 0
        lo = sec - window_s
        for j in range(window_s):
            i = (sec - j) % self._span
            if lo < self._stamp[i] <= sec:
                total += self._totals[i]
                bad += self._bad[i]
        return total, bad

    def window_counts(self, window_s: int,
                      now: Optional[float] = None) -> Tuple[int, int]:
        """(total, bad) observed inside the trailing window — the COUNT
        view of ``burn_rate``, for folds that must aggregate before
        dividing (the fleet aggregator sums per-replica counts and takes
        one global burn; averaging per-replica burn rates would weight an
        idle replica's 0/0 the same as a flooded one's)."""
        sec = int(time.time() if now is None else now)
        with self._lock:
            return self._window_counts(window_s, sec)

    def burn_rate(self, window_s: int, now: Optional[float] = None) -> float:
        sec = int(time.time() if now is None else now)
        with self._lock:
            total, bad = self._window_counts(window_s, sec)
        if not total:
            return 0.0
        return (bad / total) / self.budget

    def _refresh_gauges(self, sec: int) -> None:
        with self._lock:
            counts = {label: self._window_counts(w, sec)
                      for w, label in self.windows}
        for label, (total, bad) in counts.items():
            self._g[label].set((bad / total) / self.budget if total else 0.0)

    def to_json(self, now: Optional[float] = None) -> Dict[str, Any]:
        sec = int(time.time() if now is None else now)
        out: Dict[str, Any] = {
            "slo_ms": self.slo_ms,
            "objective": self.objective,
            "observed_total": self.total,
            "bad_total": self.bad_total,
            "windows": {},
        }
        with self._lock:
            for w, label in self.windows:
                total, bad = self._window_counts(w, sec)
                out["windows"][label] = {
                    "total": total, "bad": bad,
                    "burn_rate": round((bad / total) / self.budget, 4)
                    if total else 0.0,
                }
        return out


class KeyedBurn:
    """Per-KEY SLO burn over one coarse sliding window (the tenant axis
    of the burn-rate fold: ``tenancy/stats.py``).

    The per-lane :class:`SloTracker` keeps a per-second ring — affordable
    once per lane, not once per tenant.  Here each key holds exactly TWO
    half-window buckets (current + previous) that rotate in place, so the
    whole table is O(live keys) memory and O(1) per fold: burn reads the
    sum of both buckets — a sliding window with half-window granularity,
    plenty for the noisy-neighbor detector and the /debug/tenants view.
    Keys idle past a full window are dropped on the amortized sweep."""

    def __init__(self, window_s: float = 60.0, objective: float = 0.999,
                 max_keys: int = 8192):
        self.window_s = float(window_s)
        self.half_s = self.window_s / 2.0
        self.budget = 1.0 - min(max(float(objective), 0.0), 0.999999)
        self.max_keys = int(max_keys)
        self._lock = threading.Lock()
        # key -> [bucket_start, total, bad, prev_total, prev_bad]
        self._k: Dict[str, list] = {}
        self._last_gc = 0.0

    def _rotate(self, rec: list, now: float) -> None:
        if now - rec[0] < self.half_s:
            return
        if now - rec[0] >= self.window_s:
            rec[3] = rec[4] = 0  # both halves stale
        else:
            rec[3], rec[4] = rec[1], rec[2]
        rec[0], rec[1], rec[2] = now, 0, 0

    def fold(self, key: str, n: int, bad: int,
             now: Optional[float] = None) -> None:
        if n <= 0:
            return
        now = time.monotonic() if now is None else now
        with self._lock:
            rec = self._k.get(key)
            if rec is None:
                rec = self._k[key] = [now, 0, 0, 0, 0]
            self._rotate(rec, now)
            rec[1] += int(n)
            rec[2] += int(bad)
            if len(self._k) > self.max_keys or \
                    now - self._last_gc > self.window_s:
                self._last_gc = now
                for k in [k for k, r in self._k.items()
                          if now - r[0] > self.window_s]:
                    self._k.pop(k, None)

    def counts(self, key: str, now: Optional[float] = None):
        now = time.monotonic() if now is None else now
        with self._lock:
            rec = self._k.get(key)
            if rec is None:
                return 0, 0
            self._rotate(rec, now)
            return rec[1] + rec[3], rec[2] + rec[4]

    def burn(self, key: str, now: Optional[float] = None) -> float:
        total, bad = self.counts(key, now=now)
        if not total:
            return 0.0
        return (bad / total) / self.budget

    def to_json(self, top: int = 8,
                now: Optional[float] = None) -> Dict[str, Any]:
        now = time.monotonic() if now is None else now
        rows = []
        with self._lock:
            for k, rec in self._k.items():
                total = rec[1] + rec[3]
                bad = rec[2] + rec[4]
                if total:
                    rows.append((k, round((bad / total) / self.budget, 4),
                                 total, bad))
        rows.sort(key=lambda r: -r[1])
        return {
            "window_s": self.window_s,
            "keys": len(rows),
            "top_burn": [{"key": k, "burn_rate": b, "total": t, "bad": d}
                         for k, b, t, d in rows[:top]],
        }
