"""Cost-model lane selection, brownout's switch and speculative dual
dispatch (the reference's runtime/lane_select.py, plus the port's rule for
where they run).

The host twin of the kernel is exact: the engine's expression oracle
(``host_results``) and, in the native frontend, the kernel's plain
version on the slot's encoded operands.  On a CPU engine it is a serving
lane of its own, as in the reference:

``LaneCostModel`` — EWMAs of everything the decision needs, fed from both
lanes' completion paths (reads are atomic under the interpreter lock):

  - host-lane service time per ROW (``observe_host``: each host decision
    batch folds duration/rows);
  - device round trip per batch (``observe_device``);
  - queue depth and window occupancy at completion (the congestion terms:
    a deep queue means a device dispatch waits behind in-flight work);
  - per-lane SLO burn fractions (``observe_slo``), so selection leans
    toward the lane that is NOT burning budget.

``LaneSelector`` — the per-batch-cut decision.  The law::

    host_cost(n)   = host_row_s × n                     (× burn bias)
    device_cost(n) = device_rtt × (1 + inflight/window) (× burn bias,
                     × mesh penalty when devices are down)

    pick HOST when host_cost < device_cost AND n ≤ host_max_rows AND the
    host lane has concurrency headroom; DEVICE otherwise.

Requests whose propagated deadline lands inside the device cost but
outside the host cost are rescued onto the host lane even when the cut
itself rides the device.

``Speculation`` — the first-wins token for dual dispatch while the breaker
is HALF-OPEN: the probe batch goes to BOTH lanes, the first completion
resolves the futures, the loser's work is ignored (the verdicts are
bit-identical), and the device half still reports its outcome to the
breaker.  ``claim`` is a one-shot compare-and-set.

Brownout (the overload spill) and lane selection (the latency choice)
share the host twin but have distinct triggers and counters.

**The port's rule.** On a card only the kernel answers a row, so every one
of these mechanisms resolves OFF there (``resolve_host_lanes``): the
selector exists with ``enabled=False`` and counts every cut
``<lane>-device``/``disabled``, its cost model still learns the card's
round trip, and asking for a mechanism explicitly on a card raises.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional, Tuple

from ..utils import metrics as metrics_mod

__all__ = ["LaneCostModel", "LaneSelector", "Speculation",
           "HOST", "DEVICE", "resolve_host_lanes", "CARD_RULE"]

HOST, DEVICE = "host", "device"

# decision reasons (the `reason` label of auth_server_lane_decisions_total)
R_COST = "cost-model"          # host_cost(n) beat device_cost(n)
R_DEADLINE = "deadline"        # latency-critical head rescued host-side
R_SPECULATIVE = "speculative"  # dual-dispatch twin (breaker half-open)
R_BATCH = "batch"              # device: the cut is batch-shaped work
R_HOST_BUSY = "host-busy"      # device: host lane at its concurrency cap
R_DISABLED = "disabled"        # device: selection off / lane unavailable
R_BURN = "slo-burn"            # the burn bias flipped the raw cost verdict
R_EXPLORE = "explore"          # device: periodic RTT-freshness probe

# cold-start host estimate: optimistic but conservative against a real
# device round trip; the first host decision measures the truth and the
# EWMA takes over
_HOST_ROW_COLD_S = 100e-6
# EWMA smoothing (the engine's device EWMA's: 0.8 old / 0.2 new)
_ALPHA = 0.2
# per-lane burn windows decay on this horizon (seconds)
_BURN_DECAY_S = 30.0

CARD_RULE = ("on a card only the mega-kernel answers a row: brownout, lane "
             "selection and speculative dispatch run on a CPU engine only")


def resolve_host_lanes(device, brownout: Optional[bool] = None,
                       lane_select: Optional[bool] = None,
                       speculative: Optional[bool] = None
                       ) -> Tuple[bool, bool, bool]:
    """(brownout, lane_select, speculative) for an engine or frontend on
    ``device``.  ``None`` means "not asked": on a CPU device the
    reference's defaults (all on), on a CUDA device all off.  An explicit
    ``False`` turns a mechanism off anywhere; an explicit ``True`` on a
    card raises ``ValueError`` naming the port's rule, never resolves off
    quietly."""
    on_card = getattr(device, "type", str(device).split(":")[0]) != "cpu"
    asked = {"brownout": brownout, "lane_select": lane_select,
             "speculative_dispatch": speculative}
    if on_card:
        on = sorted(k for k, v in asked.items() if v)
        if on:
            raise ValueError(f"{', '.join(on)}=True on {device}: {CARD_RULE}")
        return False, False, False
    return tuple(True if v is None else bool(v)
                 for v in (brownout, lane_select, speculative))


class LaneCostModel:
    """Shared cost state for one serving lane pair (host twin + device).

    Thread-safe: feeds arrive from encode workers, completer threads and
    host-lane worker threads; decision-time reads are atomic floats."""

    def __init__(self, lane: str):
        self.lane = lane
        self.host_row_s = 0.0       # EWMA seconds per host-decided row
        self.device_rtt_s = 0.0     # EWMA device batch round trip
        self.depth_ewma = 0.0       # queue depth at batch completion
        self.occupancy_ewma = 0.0   # in-flight window occupancy fraction
        self.host_batches = 0
        self.device_batches = 0
        # the mesh's cost feed (sharded_eval.cost_feed): > 1.0 when part of
        # the mesh is down — the surviving devices carry the load, so the
        # effective device cost rises
        self.mesh_penalty = 1.0
        self._lock = threading.Lock()
        # per-lane decayed SLO burn counters (total, bad, last update):
        # the bias signal, not an alerting surface (the SloTracker is)
        self._burn: Dict[str, list] = {HOST: [0.0, 0.0, 0.0],
                                       DEVICE: [0.0, 0.0, 0.0]}
        self._g_host = metrics_mod.lane_cost_ewma.labels(lane, HOST)
        self._g_device = metrics_mod.lane_cost_ewma.labels(lane, DEVICE)

    # -- feeds -------------------------------------------------------------

    def observe_host(self, dur_s: float, rows: int) -> None:
        """One host-lane batch decided: fold per-row service time."""
        if rows <= 0 or not (dur_s >= 0.0):
            return
        per_row = dur_s / rows
        self.host_row_s = (per_row if not self.host_row_s
                           else (1 - _ALPHA) * self.host_row_s
                           + _ALPHA * per_row)
        self.host_batches += 1
        self._g_host.set(self.host_row_s)

    def observe_device(self, rtt_s: float, rows: int, depth: int = 0,
                       inflight: int = 0, window: int = 1) -> None:
        """One device batch completed: fold its round trip plus the
        congestion terms (queue depth, window occupancy) at completion."""
        if not (rtt_s >= 0.0):
            return
        self.device_rtt_s = (rtt_s if not self.device_rtt_s
                             else (1 - _ALPHA) * self.device_rtt_s
                             + _ALPHA * rtt_s)
        self.depth_ewma = ((1 - _ALPHA) * self.depth_ewma
                           + _ALPHA * float(depth))
        occ = float(inflight) / float(max(1, window))
        self.occupancy_ewma = ((1 - _ALPHA) * self.occupancy_ewma
                               + _ALPHA * occ)
        self.device_batches += 1
        self._g_device.set(self.device_rtt_s)

    def observe_slo(self, which: str, n: int, n_bad: int,
                    now: Optional[float] = None) -> None:
        """Per-lane burn feed: ``n`` requests decided on ``which`` lane,
        ``n_bad`` of them over the SLO target (or errored).  Decayed so a
        recovered lane sheds its bad history within ~_BURN_DECAY_S."""
        if n <= 0:
            return
        now = time.monotonic() if now is None else now
        rec = self._burn.get(which)
        if rec is None:
            return
        with self._lock:
            total, bad, t_last = rec
            if t_last:
                decay = 0.5 ** ((now - t_last) / _BURN_DECAY_S)
                total *= decay
                bad *= decay
            rec[0] = total + n
            rec[1] = bad + n_bad
            rec[2] = now

    def burn_frac(self, which: str) -> float:
        rec = self._burn.get(which)
        if rec is None:
            return 0.0
        total, bad, _ = rec
        return (bad / total) if total >= 1.0 else 0.0

    # -- cost estimates ----------------------------------------------------

    def host_cost(self, n: int) -> float:
        """Expected seconds to answer ``n`` rows on the host twin."""
        per_row = self.host_row_s or _HOST_ROW_COLD_S
        return per_row * max(1, n)

    def device_cost(self, inflight: int = 0, window: int = 1) -> float:
        """Expected seconds for a device answer dispatched NOW: one round
        trip, inflated by window occupancy (a launch behind a full window
        waits out earlier completions) and the mesh penalty."""
        rtt = self.device_rtt_s
        if not rtt:
            return float("inf") if self.host_row_s else 0.0
        occ = float(inflight) / float(max(1, window))
        return rtt * (1.0 + occ) * self.mesh_penalty

    def burn_bias(self) -> float:
        """Multiplier > 1 applied to the DEVICE cost when the device lane
        is burning SLO budget faster than the host lane (and < 1 when the
        host lane is).  Bounded to [0.5, 2]: the bias nudges a close call,
        it never overrides a 10x cost gap."""
        d = self.burn_frac(DEVICE) - self.burn_frac(HOST)
        return min(2.0, max(0.5, 1.0 + d))

    def min_service_s(self) -> float:
        """The fastest lane's expected service time for a small batch —
        the lane-aware admission floor (a deadline only the host lane can
        meet is not doomed while the host lane serves)."""
        host = self.host_cost(1)
        dev = self.device_rtt_s or host
        return min(host, dev)

    def to_json(self) -> Dict[str, Any]:
        return {
            "host_row_ewma_s": round(self.host_row_s, 9),
            "device_rtt_ewma_s": round(self.device_rtt_s, 6),
            "queue_depth_ewma": round(self.depth_ewma, 2),
            "occupancy_ewma": round(self.occupancy_ewma, 4),
            "mesh_penalty": round(self.mesh_penalty, 3),
            "host_batches": self.host_batches,
            "device_batches": self.device_batches,
            "burn_frac": {k: round(self.burn_frac(k), 4)
                          for k in (HOST, DEVICE)},
            "burn_bias": round(self.burn_bias(), 3),
        }


class Speculation:
    """First-wins token for one dual-dispatched batch.  ``claim(which)``
    is a one-shot compare-and-set: the first lane to claim resolves the
    futures and runs the request-level telemetry (SLO, admission service
    count, provenance fold); every later claimer gets False and treats
    its verdicts as confirmation only.  The device half's breaker
    bookkeeping is not gated on winning: the probe's purpose is a breaker
    verdict, whoever answered the clients first."""

    __slots__ = ("lane", "t0", "_winner", "_lock")

    def __init__(self, lane: str):
        self.lane = lane
        self.t0 = time.monotonic()
        self._winner: Optional[str] = None
        self._lock = threading.Lock()

    def claim(self, which: str) -> bool:
        with self._lock:
            if self._winner is None:
                self._winner = which
                return True
            return False

    def acquire(self, which: str) -> bool:
        """Idempotent ownership check: True when ``which`` is (or just
        became) the winner.  A lane that already owns the batch (the device
        half re-entering through the retry path) keeps ownership instead of
        reading its own earlier claim as a loss."""
        with self._lock:
            if self._winner is None:
                self._winner = which
            return self._winner == which

    @property
    def winner(self) -> Optional[str]:
        return self._winner


class LaneSelector:
    """Per-batch-cut lane decision for one serving lane.

    ``decide`` runs under the caller's queue lock (engine) or on the
    dispatcher thread (native): no locks, no allocation — EWMA reads and a
    handful of float ops."""

    def __init__(self, lane: str, enabled: bool = True,
                 host_max_rows: int = 64, speculative: bool = True,
                 host_concurrency: int = 2, explore_every: int = 64,
                 cost: Optional[LaneCostModel] = None):
        self.lane = lane
        self.enabled = bool(enabled)
        self.host_max_rows = max(1, int(host_max_rows))
        self.speculative = bool(speculative)
        # RTT-freshness exploration: every Nth host-winning decision rides
        # the device anyway, so the device RTT EWMA cannot go stale during
        # a long host-only regime.  0 disables exploration
        self.explore_every = max(0, int(explore_every))
        self._host_streak = 0
        # concurrent host-lane batches are bounded: the host twin rescues
        # latency, it must not become an unbounded CPU amplifier
        self.host_limit = max(1, int(host_concurrency))
        self.host_inflight = 0     # guarded by the caller's queue lock
        self.cost = cost if cost is not None else LaneCostModel(lane)
        self.decisions: Dict[str, int] = {}
        self.rows: Dict[str, int] = {HOST: 0, DEVICE: 0}
        self.speculative_outcomes: Dict[str, int] = {}
        self._children: Dict[Tuple[str, str], Any] = {}
        self._spec_children: Dict[str, Any] = {}

    # -- decision ----------------------------------------------------------

    def decide(self, n: int, inflight: int, window: int,
               host_inflight: Optional[int] = None) -> Tuple[str, str]:
        """(lane, reason) for a cut of ``n`` rows with ``inflight`` device
        batches riding a ``window``-deep in-flight window."""
        if not self.enabled:
            return DEVICE, R_DISABLED
        if n > self.host_max_rows:
            return DEVICE, R_BATCH
        hi = self.host_inflight if host_inflight is None else host_inflight
        if hi >= self.host_limit:
            return DEVICE, R_HOST_BUSY
        host = self.cost.host_cost(n)
        dev = self.cost.device_cost(inflight, window)
        bias = self.cost.burn_bias()
        if host < dev * bias:
            self._host_streak += 1
            if self.explore_every and \
                    self._host_streak % self.explore_every == 0:
                return DEVICE, R_EXPLORE
            return HOST, (R_COST if host < dev else R_BURN)
        self._host_streak = 0
        if host < dev:
            return DEVICE, R_BURN  # raw cost said host; burn bias said no
        return DEVICE, R_COST

    # -- accounting --------------------------------------------------------

    def admission_floor(self) -> float:
        """Lane-aware doomed-deadline floor for the admission gate: the
        fastest lane's expected service time, but only while the host lane
        has headroom to take the work.  With its concurrency cap taken the
        floor is +inf, so the gate falls back to the device RTT and keeps
        providing backpressure."""
        if not self.enabled or self.host_inflight >= self.host_limit:
            return float("inf")
        return self.cost.min_service_s()

    def count(self, which: str, reason: str, n: int = 1) -> None:
        key = (which, reason)
        ch = self._children.get(key)
        if ch is None:
            ch = self._children[key] = metrics_mod.lane_decisions.labels(
                f"{self.lane}-{which}", reason)
        ch.inc(n)
        k = f"{which}:{reason}"
        self.decisions[k] = self.decisions.get(k, 0) + n

    def count_rows(self, which: str, n: int) -> None:
        """Requests actually SERVED per lane (the decision counter above is
        per batch-cut decision)."""
        self.rows[which] = self.rows.get(which, 0) + n

    def count_speculative(self, outcome: str) -> None:
        ch = self._spec_children.get(outcome)
        if ch is None:
            ch = self._spec_children[outcome] = (
                metrics_mod.speculative_dispatch.labels(outcome))
        ch.inc()
        self.speculative_outcomes[outcome] = (
            self.speculative_outcomes.get(outcome, 0) + 1)

    def to_json(self) -> Dict[str, Any]:
        return {
            "enabled": self.enabled,
            "host_max_rows": self.host_max_rows,
            "speculative": self.speculative,
            "host_inflight": self.host_inflight,
            "host_concurrency_limit": self.host_limit,
            "decisions": dict(self.decisions),
            "rows": dict(self.rows),
            "speculative_outcomes": dict(self.speculative_outcomes),
            "cost": self.cost.to_json(),
        }
