"""Device circuit breaker (the reference's runtime/breaker.py): consecutive
micro-batch failures trip the lane OPEN — whole batches stay off the card
(the engine answers them UNAVAILABLE on a card, through the host oracle on
the CPU) — and a half-open probe re-admits one batch after the cooldown to
test recovery.

State machine (per lane; the engine owns one):

    CLOSED ──(threshold consecutive batch failures)──▶ OPEN
    OPEN ──(reset_s cooldown elapsed)──▶ HALF_OPEN (ONE probe batch admitted)
    HALF_OPEN ──(probe batch succeeds)──▶ CLOSED
    HALF_OPEN ──(probe batch fails)──▶ OPEN (cooldown restarts)

Thread-safe: the encode pool's threads and the completer all report into
one breaker.  Every transition is counted in
auth_server_circuit_transitions_total{lane,state}, logged at WARNING and
recorded by the flight recorder (entering OPEN is an anomaly: it writes a
bundle); the live state rides the auth_server_circuit_state{lane} gauge
(0=closed, 1=half-open, 2=open), /readyz and /debug/vars.

The mesh lane (parallel/sharded_eval.py) keeps one breaker per mesh device
(``DeviceBreakerSet``): a sick device's batches fail over to a healthy one,
and the engine's lane breaker opens only once the whole mesh stops
answering.  The router ranks devices with the ``candidate()`` peek and
claims a probe slot with ``admit_device()`` on the one it picks.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List

from ..utils import metrics as metrics_mod
from .flight_recorder import RECORDER

__all__ = ["CircuitBreaker", "DeviceBreakerSet", "CLOSED", "HALF_OPEN",
           "OPEN"]

log = logging.getLogger(__name__)

CLOSED, HALF_OPEN, OPEN = "closed", "half-open", "open"
_GAUGE_VALUE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    def __init__(self, lane: str, threshold: int = 5, reset_s: float = 5.0):
        self.lane = lane
        self.threshold = max(1, int(threshold))
        self.reset_s = float(reset_s)
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        self.transitions: List[Dict[str, Any]] = []  # bounded trail
        self._g_state = metrics_mod.circuit_state.labels(lane)
        self._g_state.set(0)

    # -- internal ----------------------------------------------------------

    def _transition(self, state: str, reason: str) -> None:
        # caller holds _lock
        if state == self._state:
            return
        self._state = state
        self._g_state.set(_GAUGE_VALUE[state])
        metrics_mod.circuit_transitions.labels(self.lane, state).inc()
        self.transitions.append(
            {"t": time.time(), "state": state, "reason": reason})
        del self.transitions[:-64]
        # every transition rides the flight recorder's ring; entering OPEN
        # is an anomaly trigger (a bundle).  record() is a deque append —
        # safe under this lock, fail-safe inside
        RECORDER.record("breaker-open" if state == OPEN else "breaker",
                        lane=self.lane,
                        detail={"state": state, "reason": reason})
        log.warning("circuit breaker (%s lane) -> %s (%s)",
                    self.lane, state.upper(), reason)

    # -- dispatch-time gate ------------------------------------------------

    def admit_device(self) -> bool:
        """True when this batch may touch the device.  OPEN past the
        cooldown atomically claims the single half-open probe slot; every
        other caller stays off the device until that probe resolves."""
        return self.admit_device_probe()[0]

    def admit_device_probe(self) -> "tuple[bool, bool]":
        """(allowed, probe): ``admit_device`` that also says whether this
        admission claimed the half-open probe slot (the reference's
        ``admit_device``).  A CPU engine's speculative dual dispatch arms
        exactly on probes: the probe batch rides both lanes and resolves
        first-wins, while the device half's outcome still decides the
        breaker."""
        with self._lock:
            if self._state == CLOSED:
                return True, False
            if self._state == OPEN:
                if time.monotonic() - self._opened_at < self.reset_s:
                    return False, False
                self._transition(HALF_OPEN, "cooldown elapsed; probing")
                self._probe_inflight = True
                return True, True
            # HALF_OPEN: exactly one probe at a time
            if self._probe_inflight:
                return False, False
            self._probe_inflight = True
            return True, True

    # -- batch outcomes ----------------------------------------------------

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            self._probe_inflight = False
            if self._state != CLOSED:
                self._transition(CLOSED, "probe batch succeeded")

    def release_probe(self) -> None:
        """The admitted batch never touched the device (every row was
        answered by the verdict cache): free the half-open probe slot
        without recording a verdict, so the next real batch can probe."""
        with self._lock:
            self._probe_inflight = False

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive += 1
            if self._state == HALF_OPEN:
                self._probe_inflight = False
                self._opened_at = time.monotonic()
                self._transition(OPEN, "probe batch failed")
            elif self._state == CLOSED and self._consecutive >= self.threshold:
                self._opened_at = time.monotonic()
                self._transition(
                    OPEN, f"{self._consecutive} consecutive batch failures")

    # -- introspection -----------------------------------------------------

    @property
    def state(self) -> str:
        return self._state

    def to_json(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = {
                "state": self._state,
                "consecutive_failures": self._consecutive,
                "threshold": self.threshold,
                "reset_s": self.reset_s,
                "transitions": list(self.transitions),
            }
            if self._state == OPEN:
                out["retry_in_s"] = max(
                    0.0, self.reset_s - (time.monotonic() - self._opened_at))
            return out

    # -- mesh routing peeks (no probe claim) --------------------------------

    def candidate(self) -> bool:
        """True when this breaker would plausibly admit a dispatch right
        now: CLOSED, OPEN past its cooldown (a probe is due), or HALF_OPEN
        with no probe in flight.  A pure peek: unlike ``admit_device`` it
        never claims the half-open probe slot, so the mesh router can rank
        many devices without stranding probes on the ones it skips."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                return time.monotonic() - self._opened_at >= self.reset_s
            return not self._probe_inflight


class DeviceBreakerSet:
    """Per-device circuit breakers for the mesh lane: one ``CircuitBreaker``
    per mesh device, so a single sick device routes its batches to healthy
    neighbours instead of tripping the whole lane.  The engine's lane
    breaker stays the outer guard (it opens only once the whole mesh stops
    answering)."""

    def __init__(self, lane: str, device_ids, threshold: int = 3,
                 reset_s: float = 5.0):
        self.lane = lane
        self.breakers: Dict[int, CircuitBreaker] = {
            int(d): CircuitBreaker(f"{lane}-dev{int(d)}", threshold=threshold,
                                   reset_s=reset_s)
            for d in device_ids
        }

    def get(self, device_id: int) -> CircuitBreaker:
        return self.breakers[int(device_id)]

    def all_closed(self) -> bool:
        """True when every mesh device is healthy: the full-mesh launch is
        the plan."""
        return all(b.state == CLOSED for b in self.breakers.values())

    def candidates(self) -> List[int]:
        """Device ids a single-device dispatch may target right now,
        healthy (CLOSED) devices first.  A pure peek: the router claims the
        probe slot with ``get(id).admit_device()`` only on the device it
        picks."""
        closed = [i for i, b in self.breakers.items() if b.state == CLOSED]
        probing = [i for i, b in self.breakers.items()
                   if b.state != CLOSED and b.candidate()]
        return closed + probing

    def record_failure(self, device_id: int) -> None:
        b = self.breakers.get(int(device_id))
        if b is not None:
            b.record_failure()

    def record_success(self, device_ids) -> None:
        for d in device_ids:
            b = self.breakers.get(int(d))
            if b is not None:
                b.record_success()

    def to_json(self) -> Dict[str, Any]:
        return {str(i): b.to_json() for i, b in sorted(self.breakers.items())}
