"""Per-tenant admission: token-bucket quotas, per-tenant CoDel wait
tracking, and tenant-aware doomed-deadline depth.

The global admission gate (runtime/admission.py) protects the PROCESS; this
module scopes the same disciplines to one tenant so the protection itself
cannot become a noisy-neighbor amplifier:

- **quota**: a per-tenant token bucket (rate from the
  ``authorino.tpu/qos-quota-rps`` annotation or the CLI default).  A tenant
  over its quota gets a typed ``RESOURCE_EXHAUSTED`` scoped to THAT tenant
  — the global OVERLOADED latch is untouched and every other tenant keeps
  its full admission budget;
- **per-tenant CoDel wait**: each tenant's observed queue waits feed its
  own EWMA + standing-above-target detector (the same min-wait discipline
  as the global gate, folded per batch from the tenant axis) — surfaced on
  /debug/tenants and consumed by the noisy-neighbor detector;
- **tenant-aware doom depth**: the doomed-deadline shedder used to predict
  wait from the GLOBAL queue depth, so one tenant's standing backlog doomed
  every tenant's deadlines.  ``doom_depth`` returns the depth THIS tenant's
  request actually waits behind under the weighted-fair cut: its own
  backlog scaled by the inverse of its fair share.  A cold tenant in front
  of a hot standing queue predicts a near-zero wait — exactly what the
  fair cut delivers.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional, Tuple

from ..utils.rpc import RESOURCE_EXHAUSTED

__all__ = ["TenantAdmission", "R_TENANT_QUOTA", "R_TENANT_CONTAINED",
           "R_TENANT_SHARE", "TokenBucket"]

# rejection reason labels (ride auth_server_admission_rejected_total and
# auth_server_tenant_rejected_total)
R_TENANT_QUOTA = "tenant-quota"
R_TENANT_CONTAINED = "tenant-contained"
R_TENANT_SHARE = "tenant-queue-share"


class TokenBucket:
    __slots__ = ("rate", "burst", "tokens", "t")

    def __init__(self, rate: float, burst: Optional[float] = None,
                 now: Optional[float] = None):
        self.rate = float(rate)
        # one second of burst headroom by default: quotas bound sustained
        # rates, they must not chop a normal arrival burst into rejections
        self.burst = float(burst if burst is not None else max(rate, 1.0))
        self.tokens = self.burst
        self.t = time.monotonic() if now is None else now

    def allow(self, now: Optional[float] = None, n: float = 1.0) -> bool:
        now = time.monotonic() if now is None else now
        self.tokens = min(self.burst,
                          self.tokens + (now - self.t) * self.rate)
        self.t = now
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False


class _TenantWait:
    """One tenant's CoDel-ish wait state, fed per batch (never per
    request) from the tenant-axis fold."""

    __slots__ = ("ewma", "above_since", "overloaded", "last_obs")

    def __init__(self):
        self.ewma = 0.0
        self.above_since: Optional[float] = None
        self.overloaded = False
        self.last_obs = 0.0


class TenantAdmission:
    """Per-tenant admission state for one serving lane.  All feeds are per
    batch or per submit; every dict is bounded by live tenants (entries of
    tenants idle past ``gc_idle_s`` are dropped on the amortized sweep)."""

    def __init__(self, weight_book, target_s: float = 0.05,
                 interval_s: float = 0.5, gc_idle_s: float = 300.0,
                 max_tenants: int = 8192):
        self.book = weight_book
        self.target_s = float(target_s)
        self.interval_s = float(interval_s)
        self.gc_idle_s = float(gc_idle_s)
        self.max_tenants = int(max_tenants)
        self._lock = threading.Lock()
        self._buckets: Dict[str, TokenBucket] = {}
        self._waits: Dict[str, _TenantWait] = {}
        self._backlog: Dict[str, int] = {}
        self.rejected: Dict[str, Dict[str, int]] = {}  # tenant -> reason -> n
        self._last_gc = time.monotonic()

    # -- backlog ------------------------------------------------------------
    # enqueue/dequeue run under the engine's queue lock, but doom_depth
    # reads from event loops WITHOUT it — the plane's own lock makes the
    # backlog-iteration in share() safe (an unguarded dict iteration under
    # concurrent dequeues raises RuntimeError mid-submit)

    def on_enqueue(self, tenant: str) -> None:
        with self._lock:
            self._backlog[tenant] = self._backlog.get(tenant, 0) + 1

    def on_dequeue(self, batch) -> None:
        with self._lock:
            for p in batch:
                t = p.config_name
                left = self._backlog.get(t, 0) - 1
                if left > 0:
                    self._backlog[t] = left
                else:
                    self._backlog.pop(t, None)

    def backlog(self, tenant: str) -> int:
        return self._backlog.get(tenant, 0)

    def backlogged_tenants(self):
        with self._lock:
            return list(self._backlog)

    # -- quota --------------------------------------------------------------

    def quota_reject(self, tenant: str,
                     now: Optional[float] = None) -> Optional[Tuple[int, str]]:
        rate = self.book.quota_rps(tenant)
        if not rate:
            return None
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is None or bucket.rate != rate:
                bucket = TokenBucket(rate, now=now)
                self._buckets[tenant] = bucket
            if bucket.allow(now):
                return None
        return (RESOURCE_EXHAUSTED, R_TENANT_QUOTA)

    # -- per-tenant queue-occupancy bound -----------------------------------

    # headroom over the exact weighted share of the queue cap, and the
    # floor below which the bound never bites (a burst of a handful of
    # rows is normal arrival jitter, not occupation)
    SHARE_HEADROOM = 2.0
    SHARE_FLOOR = 16

    def share_reject(self, tenant: str, global_depth: int,
                     effective_cap: int) -> Optional[Tuple[int, str]]:
        """Per-tenant queue-occupancy bound — the WFQ companion the fair
        cut needs at ADMISSION time: the cut divides service fairly, but
        the shared queue itself is a bounded resource, and a flooding
        tenant that fills it to the global cap gets every OTHER tenant's
        arrivals rejected indiscriminately by the global gate (and worse,
        only after they waited).  Once the queue is past half its
        wait-targeted cap, a tenant whose own standing backlog already
        exceeds its weighted share of the cap (x SHARE_HEADROOM, floored)
        is rejected typed and tenant-scoped IMMEDIATELY — milliseconds,
        not detector latency — so the queue always keeps room for
        everyone else.  Below half-cap the bound never bites: bursts into
        an idle queue are absorbed whole (work conservation)."""
        if effective_cap <= 0 or global_depth < effective_cap // 2:
            return None
        mine = self._backlog.get(tenant, 0)
        if mine < self.SHARE_FLOOR:
            return None
        # entitlement against the WHOLE corpus (global_share), not the
        # currently-backlogged set: the shared queue belongs to every
        # tenant, and a flooding tenant must not earn a bigger occupancy
        # just because its victims are momentarily fast enough to drain
        share = self.book.global_share(tenant)
        limit = max(self.SHARE_FLOOR,
                    int(self.SHARE_HEADROOM * share * effective_cap))
        if mine >= limit:
            return (RESOURCE_EXHAUSTED, R_TENANT_SHARE)
        return None

    # -- tenant-aware doomed depth -------------------------------------------

    def doom_depth(self, tenant: str, global_depth: int) -> int:
        """The queue depth this tenant's NEXT request effectively waits
        behind under the weighted-fair cut: its own backlog divided by its
        fair share of service.  Bounded by the global depth — fair queuing
        can only make a tenant's wait shorter than FIFO, never longer."""
        mine = self._backlog.get(tenant, 0)
        if mine <= 0:
            return 0
        with self._lock:
            among = list(self._backlog)
        share = self.book.share(tenant, among)
        eff = int(mine / max(share, 1e-6))
        return min(eff, int(global_depth))

    # -- per-tenant CoDel wait (fed per batch from the tenant fold) ---------

    def observe_waits(self, tenant: str, mean_wait: float, min_wait: float,
                      now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            w = self._waits.get(tenant)
            if w is None:
                w = self._waits[tenant] = _TenantWait()
            w.last_obs = now
            w.ewma = mean_wait if not w.ewma else \
                0.8 * w.ewma + 0.2 * mean_wait
            if min_wait <= self.target_s:
                w.above_since = None
                w.overloaded = False
            elif w.above_since is None:
                w.above_since = now
            elif now - w.above_since >= self.interval_s:
                w.overloaded = True
        self._maybe_gc(now)

    def wait_ewma(self, tenant: str) -> float:
        w = self._waits.get(tenant)
        return w.ewma if w is not None else 0.0

    def overloaded(self, tenant: str) -> bool:
        w = self._waits.get(tenant)
        return bool(w is not None and w.overloaded)

    # -- accounting ----------------------------------------------------------

    def count_reject(self, tenant: str, reason: str) -> None:
        with self._lock:
            per = self.rejected.setdefault(tenant, {})
            per[reason] = per.get(reason, 0) + 1

    def _maybe_gc(self, now: float) -> None:
        if (now - self._last_gc < self.gc_idle_s
                and len(self._waits) <= self.max_tenants):
            return
        with self._lock:
            self._last_gc = now
            stale = [t for t, w in self._waits.items()
                     if now - w.last_obs > self.gc_idle_s
                     and t not in self._backlog]
            for t in stale:
                self._waits.pop(t, None)
                self._buckets.pop(t, None)

    def to_json(self) -> Dict[str, Any]:
        with self._lock:
            overloaded = sorted(t for t, w in self._waits.items()
                                if w.overloaded)
            worst = sorted(((t, round(w.ewma, 6))
                            for t, w in self._waits.items()),
                           key=lambda x: -x[1])[:8]
        return {
            "target_s": self.target_s,
            "backlogged_tenants": len(self._backlog),
            "tracked_tenants": len(self._waits),
            "overloaded_tenants": overloaded[:16],
            "worst_wait_ewma_s": dict(worst),
            "rejected": {t: dict(r)
                         for t, r in sorted(self.rejected.items())[:32]},
        }
