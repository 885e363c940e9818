"""Overload resilience: admission control + the adaptive window.

A burst above window × batch / RTT would otherwise grow the dispatch queue
without bound until every queued request blew its deadline at once — the
classic open-loop overload collapse.  Two controllers prevent that, one per
concern:

``AdmissionController`` — a CoDel-style, wait-targeted admission gate on
the submit queue.  Instead of a fixed request cap (which is either too
small at high service rates or useless at low ones), the *effective* queue
bound is derived from the observed service rate and the wait target::

    effective_cap = service_rate_ewma × target_s        (≥ a small floor)

so the standing queue can never hold more work than drains within one wait
target — under 2× overload the queue fills to the cap, every arrival
beyond it is rejected with a typed ``RESOURCE_EXHAUSTED`` at admission
(before encode, before a kernel is spent), and accepted work still meets
its deadline.  On top of the bound, the CoDel signal proper: when the
*minimum* observed queue wait stays above ``target_s`` for a full
``interval_s`` (a standing queue, not a transient burst), the controller
flips to the OVERLOADED state — surfaced on ``auth_server_admission_state``
— and paces additional rejections with the CoDel control law
(``interval / sqrt(drop_count)``) for consumers that have no per-request
depth signal.  Requests whose propagated deadline lands inside the
predicted wait + one device RTT are rejected as ``DEADLINE_EXCEEDED`` at
admission — doomed work never queues.

``AdaptiveWindow`` — the controller that tunes the in-flight window below
its configured cap ``max_inflight_batches``.  Little's law sets the
target::

    window* = ceil(arrival_rate × device_RTT / batch_cut) + 2

tracked from EWMAs of the observed arrival rate, device round trip and
batch-cut size; the live window slews toward the target (fast up, slow
down, never while a backlog is standing) and is HARD-clamped to
``[1, cap]``.  The analogous batch-cut target ``cut* = arrival_rate × RTT /
window`` (pow2-bucketed) is advisory.

Both controllers are import-light, allocation-free on the hot path, and
thread-safe (submit runs on event loops; observations arrive from encode
workers and the completer).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, Optional, Tuple

from ..utils import bucket_pow2
from ..utils import metrics as metrics_mod
from ..utils.rpc import DEADLINE_EXCEEDED, RESOURCE_EXHAUSTED
from .flight_recorder import RECORDER

__all__ = ["AdmissionController", "AdaptiveWindow", "ADMIT", "OVERLOADED"]

ADMIT, OVERLOADED = "admit", "overloaded"
_STATE_VALUE = {ADMIT: 0, OVERLOADED: 1}

# rejection reasons (the `reason` label of
# auth_server_admission_rejected_total)
R_QUEUE_FULL = "queue-full"    # hard queue_cap exceeded
R_OVERLOAD = "overload"        # wait-targeted effective cap exceeded
R_DOOMED = "doomed-deadline"   # could not complete inside the deadline


class AdmissionController:
    """Wait-targeted admission gate for one serving lane.

    Feeds (any thread):
      - ``observe_waits(waits)``   per-request queue waits of one batch cut
      - ``observe_service(rows)``  rows completed (service-rate estimator)
    Decisions:
      - ``admit(depth, deadline)`` at submit time — None, or a typed
        ``(code, reason)`` rejection; mutates CoDel drop state
      - ``precheck(deadline)``     deterministic front-door subset (no
        pacing state consumed) for the gRPC/HTTP servers
      - ``drop_now()``             CoDel-paced drop signal for consumers
        without a depth feed
    """

    def __init__(self, lane: str, target_s: float = 0.05,
                 interval_s: float = 0.5, queue_cap: int = 0,
                 min_cap: int = 64):
        self.lane = lane
        self.target_s = float(target_s)
        self.interval_s = float(interval_s)
        # hard bound on the submit queue (0 = none beyond the dynamic cap)
        self.queue_cap = int(queue_cap)
        # the dynamic cap's floor: before any service-rate observation the
        # gate must not reject a cold-start burst
        self.min_cap = max(1, int(min_cap))
        self._lock = threading.Lock()
        self._state = ADMIT
        self.wait_ewma = 0.0           # mean queue wait (estimates)
        self._min_wait = None          # min wait inside the current interval
        self._above_since: Optional[float] = None
        self._service_rate = 0.0       # rows/s EWMA
        self._svc_count = 0
        self._svc_t0: Optional[float] = None
        self._drop_next = 0.0
        self._drop_count = 0
        self._last_wait_obs = 0.0
        # lane-aware doomed-deadline floor: a callable returning
        # the FASTEST serving lane's expected service time in seconds.
        # With lane selection on, a deadline only the microsecond host lane
        # can meet is no longer doomed just because the device RTT says so
        # — the host lane will answer it.  None = device-RTT-only (the
        # pre-lane-selection behavior).
        self.lane_floor: Optional[Any] = None
        self.rejected: Dict[str, int] = {}
        self._g_state = metrics_mod.admission_state.labels(lane)
        self._g_state.set(0)
        self._g_wait = metrics_mod.admission_queue_wait.labels(lane)

    # -- feeds ---------------------------------------------------------------

    def observe_waits(self, waits, now: Optional[float] = None) -> None:
        """Fold one batch cut's per-request queue waits (seconds,
        array-like or scalar).  The batch MINIMUM drives the CoDel signal
        (a high min = a standing queue; a high mean alone = one burst)."""
        try:
            n = len(waits)
        except TypeError:
            waits, n = (waits,), 1
        if not n:
            return
        if hasattr(waits, "min"):
            # numpy path (the engine's per-cut wait array): vectorized —
            # builtin min()/sum() would iterate element-by-element on the
            # encode hot path
            w_min = float(waits.min())
            w_mean = float(waits.mean())
        else:
            w_min = min(waits)
            w_mean = sum(waits) / n
        now = time.monotonic() if now is None else now
        with self._lock:
            self._last_wait_obs = now
            self.wait_ewma = (w_mean if not self.wait_ewma
                              else 0.8 * self.wait_ewma + 0.2 * w_mean)
            self._g_wait.set(self.wait_ewma)
            if self._min_wait is None or w_min < self._min_wait:
                self._min_wait = w_min
            if self._min_wait <= self.target_s:
                # the standing queue cleared inside the interval
                self._above_since = None
                self._min_wait = None
                self._set_state(ADMIT)
            elif self._above_since is None:
                self._above_since = now
            elif now - self._above_since >= self.interval_s:
                if self._state is not OVERLOADED:
                    self._set_state(OVERLOADED)
                    self._drop_count = 0
                    self._drop_next = now
                self._min_wait = None  # re-measure each interval
                self._above_since = now

    def observe_service(self, rows: int, now: Optional[float] = None) -> None:
        """Count completed rows toward the service-rate EWMA (fed by batch
        completions — device, degraded and brownout lanes all count: they
        all drain the queue)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if self._svc_t0 is None:
                self._svc_t0 = now
                self._svc_count = rows
                return
            self._svc_count += rows
            dt = now - self._svc_t0
            if dt < 0.1:
                return  # too short a window for a stable rate
            rate = self._svc_count / dt
            self._service_rate = (rate if not self._service_rate
                                  else 0.7 * self._service_rate + 0.3 * rate)
            self._svc_t0, self._svc_count = now, 0

    # -- decisions -----------------------------------------------------------

    def effective_cap(self) -> int:
        """The wait-targeted queue bound: no more standing work than the
        observed service rate drains within one wait target."""
        dyn = int(self._service_rate * self.target_s)
        cap = max(self.min_cap, dyn)
        if self.queue_cap:
            cap = min(cap, self.queue_cap)
        return cap

    def predicted_wait(self, depth: int) -> float:
        """Expected queue wait of a request admitted at ``depth``."""
        if self._service_rate > 0:
            return depth / self._service_rate
        return self.wait_ewma

    def _doomed(self, depth: int, now: float, deadline: Optional[float],
                rtt_s: float) -> bool:
        if deadline is None:
            return False
        if self.lane_floor is not None:
            # predicted-wait is lane-aware: the service-time term is the
            # FASTEST lane's, not the device RTT — the cost model routes
            # tight-deadline work host-side instead of shedding it
            try:
                rtt_s = min(rtt_s, float(self.lane_floor()))
            except Exception:
                pass
        return deadline - now <= self.predicted_wait(depth) + rtt_s

    def _maybe_idle_reset(self, now: float) -> None:
        """Clear a stale OVERLOADED flag once the load has vanished (no
        wait observations for 2×interval) — without this, an engine that
        went overloaded and then fully idle would latch the state (no
        batch cuts = no observations) and 504 the first arrivals of the
        next quiet-period burst.  Called from every decision point."""
        if self._state is not OVERLOADED:
            return
        with self._lock:
            if (self._state is OVERLOADED
                    and now - self._last_wait_obs > 2 * self.interval_s):
                self._above_since = None
                self._min_wait = None
                self._set_state(ADMIT)

    def admit(self, depth: int, now: Optional[float] = None,
              deadline: Optional[float] = None,
              rtt_s: float = 0.0,
              doom_depth: Optional[int] = None) -> Optional[Tuple[int, str]]:
        """Admission decision for one submit at queue ``depth``.  Returns
        None (admitted) or (rpc code, reason) — the caller raises the typed
        CheckAbort and counts the metric via ``count_reject``.

        ``doom_depth``: the depth the DOOMED-deadline predictor
        uses, when it differs from the global queue depth — the tenant QoS
        plane passes the submitting tenant's fair-share effective depth,
        so one tenant's standing backlog cannot doom another tenant's
        deadlines (the queue-bound checks below always use the real global
        ``depth``; fairness must never weaken the memory bound)."""
        now = time.monotonic() if now is None else now
        self._maybe_idle_reset(now)
        if self._doomed(depth if doom_depth is None else doom_depth,
                        now, deadline, rtt_s):
            return (DEADLINE_EXCEEDED, R_DOOMED)
        if self.queue_cap and depth >= self.queue_cap:
            return (RESOURCE_EXHAUSTED, R_QUEUE_FULL)
        if depth >= self.effective_cap():
            return (RESOURCE_EXHAUSTED, R_OVERLOAD)
        return None

    def precheck(self, depth: int, now: Optional[float] = None,
                 deadline: Optional[float] = None,
                 rtt_s: float = 0.0) -> Optional[Tuple[int, str]]:
        """Deterministic front-door subset for the gRPC/HTTP servers at
        the ACTUAL queue ``depth``: a request that arrives into a full
        hard cap, or that is doomed on arrival while the lane is
        overloaded, is rejected before a span/pipeline is even built.
        Never consumes pacing state, and never rejects anything the
        submit-time ``admit`` would accept — that gate stays the one true
        admission point."""
        now = time.monotonic() if now is None else now
        self._maybe_idle_reset(now)
        if self.queue_cap and depth >= self.queue_cap:
            return (RESOURCE_EXHAUSTED, R_QUEUE_FULL)
        if self._state is OVERLOADED and self._doomed(
                depth, now, deadline, rtt_s):
            return (DEADLINE_EXCEEDED, R_DOOMED)
        return None

    def drop_now(self, now: Optional[float] = None) -> bool:
        """CoDel-paced drop signal while OVERLOADED, for consumers without
        a per-request depth feed: drops start one
        per interval and accelerate by 1/sqrt(n) until the standing queue
        clears."""
        now = time.monotonic() if now is None else now
        self._maybe_idle_reset(now)
        with self._lock:
            if self._state is not OVERLOADED:
                return False
            if now < self._drop_next:
                return False
            self._drop_count += 1
            self._drop_next = now + self.interval_s / math.sqrt(self._drop_count)
            return True

    def count_reject(self, reason: str) -> None:
        metrics_mod.admission_rejected.labels(self.lane, reason).inc()
        with self._lock:
            self.rejected[reason] = self.rejected.get(reason, 0) + 1

    # -- introspection -------------------------------------------------------

    def health_signal(self, depth: int) -> Dict[str, Any]:
        """Router-facing health slice: the per-replica load and
        pressure signals the fleet router's spillover/load-shift decisions
        consume, at the caller's observed queue ``depth``."""
        return {
            "overloaded": self.overloaded,
            "queue_depth": int(depth),
            "predicted_wait_s": self.predicted_wait(depth),
            "effective_cap": self.effective_cap(),
            "rejected_total": sum(self.rejected.values()),
        }

    def _set_state(self, state: str) -> None:
        # caller holds _lock
        if state != self._state:
            self._state = state
            self._g_state.set(_STATE_VALUE[state])
            # admission flips ride the flight recorder's ring; entering
            # OVERLOADED is an anomaly trigger (auto-dump)
            RECORDER.record(
                "admission-overloaded" if state is OVERLOADED
                else "admission", lane=self.lane, detail={"state": state})

    @property
    def state(self) -> str:
        return self._state

    @property
    def overloaded(self) -> bool:
        return self._state is OVERLOADED

    def to_json(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "state": self._state,
                "target_s": self.target_s,
                "interval_s": self.interval_s,
                "queue_cap": self.queue_cap,
                "effective_cap": self.effective_cap(),
                "queue_wait_ewma_s": round(self.wait_ewma, 6),
                "service_rate_rps": round(self._service_rate, 1),
                "rejected": dict(self.rejected),
            }


class AdaptiveWindow:
    """Little's-law window + batch-cut controller for one serving lane.

    The live window starts AT the cap (exactly the old static behavior, so
    a cold burst is never window-starved).  Two regimes:

    - **backlog standing** (queue depth > 0 at observation): the window is
      not draining offered load — open it toward the cap (+cap/8 per
      completion) and cut full batches.  Work-conserving by construction;
      the Little's-law target is deliberately NOT consulted here, because
      a saturated lane measures arrival rate == achieved rate and tracking
      it would pin the controller to a self-consistent low-throughput
      fixed point.
    - **queue clear**: track the Little's-law target
      ``window* = ceil(rate × rtt / cut) + 1`` — up fast (+cap/4), down by
      1 per observation — so idle lanes gradually return device memory.

    ``batch_cut`` is the controller's ADVISORY cut target (Little's-law
    ``rate × rtt / window``, pow2-bucketed): surfaced on the gauge for
    operators sizing max_batch, but deliberately NOT clamped onto the
    dispatch path — the engine's cut is completion-driven (it grows with
    load and is bounded by max_batch), and fragmenting a standing queue
    into smaller cuts would only add launches.

    The clamp IS the contract: ``window`` and ``batch_cut`` can never
    leave their bounds whatever the observations."""

    def __init__(self, lane: str, cap: int, batch_cap: int,
                 enabled: bool = True):
        self.lane = lane
        self.cap = max(1, int(cap))
        self.batch_cap = max(1, int(batch_cap))
        # idle floor: even a quiet lane keeps a few slots open so the next
        # batch's encode overlaps the previous batch's wait (shrinking all
        # the way to 1 serializes encode behind the RTT)
        self.min_window = min(4, self.cap)
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._window = self.cap
        self._batch_cut = self.batch_cap
        self.rtt_ewma = 0.0
        self.rate_ewma = 0.0
        self.cut_ewma = 0.0
        # monotonic arrival counter: observe_arrivals only ever ADDS (under
        # the caller's queue lock); the rate estimator reads deltas against
        # its own watermark, so there is no reset for a concurrent
        # read-modify-write to resurrect
        self._arrivals = 0
        self._arrivals_seen = 0
        self._rate_t0: Optional[float] = None
        self._g_window = metrics_mod.adaptive_window.labels(lane)
        self._g_window.set(self._window)
        self._g_cut = metrics_mod.adaptive_batch_cut.labels(lane)
        self._g_cut.set(self._batch_cut)

    # -- feeds ---------------------------------------------------------------

    def observe_arrivals(self, n: int = 1) -> None:
        """Count admitted submits.  MONOTONIC add only (callers hold their
        queue lock, so adds never race each other); the rate estimator
        never writes this counter — it tracks its own watermark."""
        self._arrivals += n

    def observe_batch(self, rtt_s: float, batch_size: int, queue_depth: int,
                      now: Optional[float] = None) -> None:
        """One batch completed: fold its device round trip and size, refresh
        the arrival-rate estimate, and step the window/cut toward target."""
        now = time.monotonic() if now is None else now
        if not (rtt_s >= 0.0) or not math.isfinite(rtt_s):
            rtt_s = 0.0  # junk observation: never poisons the EWMA
        batch_size = max(1, int(batch_size))
        with self._lock:
            self.rtt_ewma = (rtt_s if not self.rtt_ewma
                             else 0.8 * self.rtt_ewma + 0.2 * rtt_s)
            self.cut_ewma = (float(batch_size) if not self.cut_ewma
                             else 0.8 * self.cut_ewma + 0.2 * batch_size)
            if self._rate_t0 is None:
                self._rate_t0 = now
                self._arrivals_seen = self._arrivals
            else:
                dt = now - self._rate_t0
                if dt >= 0.1:
                    cur = self._arrivals
                    rate = max(0, cur - self._arrivals_seen) / dt
                    self.rate_ewma = (rate if not self.rate_ewma
                                      else 0.7 * self.rate_ewma + 0.3 * rate)
                    self._rate_t0, self._arrivals_seen = now, cur
            if not self.enabled:
                return
            w = self._window
            if queue_depth > 0:
                # WORK-CONSERVING under backlog: a standing queue means the
                # current window is not draining offered load, so open up
                # toward the cap and cut full batches to amortize the RTT.
                # (The Little's-law target below is NOT usable here: with a
                # saturated lane the measured arrival rate equals the
                # achieved rate, and tracking it pins the controller to
                # whatever throughput the too-small window happens to
                # produce — a self-consistent low fixed point.)
                w = w + max(1, self.cap // 8)
                cut = self.batch_cap
            else:
                target = max(self._target_window(), self.min_window)
                if target > w:
                    w = min(target, w + max(1, self.cap // 4))
                elif target < w:
                    w = w - 1
                cut = self._target_cut()
            self._window = min(self.cap, max(1, w))
            self._g_window.set(self._window)
            self._batch_cut = min(self.batch_cap, max(1, cut))
            self._g_cut.set(self._batch_cut)

    def _target_window(self) -> int:
        # +2 headroom over the Little's-law point: one slot so the next
        # cut's encode overlaps the current batch's wait, one for rate
        # estimation lag
        cut = max(1.0, self.cut_ewma)
        return int(math.ceil(self.rate_ewma * self.rtt_ewma / cut)) + 2

    def _target_cut(self) -> int:
        if not self.rate_ewma or not self.rtt_ewma:
            return self.batch_cap
        per_batch = self.rate_ewma * self.rtt_ewma / max(1, self._window)
        # floored at 16 (or the cap, if smaller): light load cuts whatever
        # is queued anyway, and a burst arriving into a quiet lane must not
        # be sliced into 1-row batches while the controller re-ramps
        floor = min(16, self.batch_cap)
        return max(floor, int(bucket_pow2(max(1, int(math.ceil(per_batch))))))

    # -- reads (hot path: GIL-atomic attribute reads) ------------------------

    @property
    def window(self) -> int:
        return self._window if self.enabled else self.cap

    @property
    def batch_cut(self) -> int:
        return self._batch_cut if self.enabled else self.batch_cap

    def to_json(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "enabled": self.enabled,
                "window": self._window,
                "window_cap": self.cap,
                "batch_cut": self._batch_cut,
                "batch_cap": self.batch_cap,
                "rtt_ewma_s": round(self.rtt_ewma, 6),
                "arrival_rate_rps": round(self.rate_ewma, 1),
                "cut_ewma": round(self.cut_ewma, 1),
                "target_window": self._target_window(),
            }
