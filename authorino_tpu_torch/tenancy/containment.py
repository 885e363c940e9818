"""Noisy-neighbor containment: a TENANT-scoped brownout/shed
instead of the global OVERLOADED latch.

Detection rides the per-tenant folds (tenancy/stats.py) on an amortized
cadence — never per request:

    contain(t) when  share(t) > weight_share(t) x threshold
               AND   global queue wait EWMA > the admission wait target
               ... sustained for ``sustain_s``

Both conditions matter: a hot tenant on an idle box is just traffic
(weights only bind under contention — the fair cut already gives everyone
their share), and a loaded box with proportional shares has no neighbor to
blame.  While contained, the tenant's rows are split off at the batch cut
into a part of their own, launched on the device behind the cut's other
parts (the engine's ``_maybe_dispatch``; the reference sends them to its
host-oracle lane, which the port does not serve a card from), and, past a
paced allowance, rejected typed ``RESOURCE_EXHAUSTED``/``tenant-contained``
at admission.  The global latch, breaker and brownout state never see any
of it.

Containment AUTO-RELEASES on decay: once the tenant's share falls back
inside its weighted entitlement (or the global wait clears) for
``release_s``, the clamp lifts.  Every transition lands in the flight
recorder; the CONTAIN transition is an anomaly (kind ``tenant-contained``)
and auto-dumps a diagnostic bundle."""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

from ..utils import metrics as metrics_mod
from .quota import TokenBucket

__all__ = ["NoisyNeighborDetector"]


class NoisyNeighborDetector:
    def __init__(self, weight_book, stats, wait_ewma: Callable[[], float],
                 target_s: Callable[[], float], lane: str = "engine",
                 threshold: float = 3.0, sustain_s: float = 0.5,
                 release_s: float = 5.0, min_share: float = 0.05,
                 max_contained: int = 8, check_interval_s: float = 0.1,
                 allowance_rps: float = 100.0, reject_count=None):
        """``threshold`` multiplies the tenant's WEIGHTED share entitlement
        (share > weight_share x threshold); ``min_share`` is an absolute
        floor so a 0.1%-share tenant can never be 'noisy' whatever its
        weight.  ``allowance_rps`` paces how much contained traffic still
        flows (its own part of each cut; typed rejections beyond it).

        ``reject_count`` (optional zero-arg callable): a monotonically
        increasing count of GLOBAL admission rejections (overload /
        queue-full).  It is the second pressure signal: the wait-targeted
        admission cap CLAMPS the queue at exactly the wait target — and
        the fair cut keeps the CoDel min-wait low by serving cold rows
        promptly — so under a contained-size queue + indiscriminate cap
        rejections the wait EWMA alone can sit right AT the target while
        cold tenants are being turned away.  Rising global rejections are
        pressure, whatever the wait gauge says."""
        self.book = weight_book
        self.stats = stats
        self.wait_ewma = wait_ewma
        self.target_s = target_s
        self.lane = lane
        self.threshold = float(threshold)
        self.sustain_s = float(sustain_s)
        self.release_s = float(release_s)
        self.min_share = float(min_share)
        self.max_contained = int(max_contained)
        self.check_interval_s = float(check_interval_s)
        self.allowance_rps = float(allowance_rps)
        self.reject_count = reject_count
        self._last_rejects = 0.0
        self._lock = threading.Lock()
        self._hot_since: Dict[str, float] = {}
        self._cool_since: Dict[str, float] = {}
        self._contained: Dict[str, Dict[str, Any]] = {}
        self._pacers: Dict[str, TokenBucket] = {}
        self._last_check = 0.0
        self.contain_total = 0
        self.release_total = 0

    # -- the per-batch entry point (amortized) -------------------------------

    def maybe_check(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        if now - self._last_check < self.check_interval_s:
            return
        self._last_check = now
        try:
            self.check(now)
        except Exception:  # a detector bug must never fail a batch
            import logging

            logging.getLogger("authorino_tpu_torch.tenancy").exception(
                "noisy-neighbor check failed (serving unaffected)")

    def check(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        shares = self.stats.shares()
        wait_hot = self.wait_ewma() > self.target_s()
        if self.reject_count is not None:
            try:
                r = float(self.reject_count())
            except Exception:
                r = self._last_rejects
            if r > self._last_rejects:
                wait_hot = True
            self._last_rejects = r
        weights_among = list(shares) or None
        # each tenant's weighted share among the served ones, the sum taken
        # once per check (per tenant it would make a check O(tenants^2))
        share_of = (self.book.share_of_among(weights_among)
                    if weights_among else None)
        with self._lock:
            # --- containment candidates
            if wait_hot and weights_among:
                for t, share in shares.items():
                    if t in self._contained:
                        continue
                    entitled = share_of(t)
                    if share > max(entitled * self.threshold,
                                   self.min_share):
                        since = self._hot_since.setdefault(t, now)
                        if (now - since >= self.sustain_s
                                and len(self._contained)
                                < self.max_contained):
                            self._contain(t, share, entitled, now)
                    else:
                        self._hot_since.pop(t, None)
            else:
                self._hot_since.clear()
            # --- auto-release on decay
            for t in list(self._contained):
                share = shares.get(t, 0.0)
                entitled = (share_of(t) if share_of is not None
                            else self.book.share(t, [t]))
                cooled = (not wait_hot) or share <= entitled * 1.1
                if cooled:
                    since = self._cool_since.setdefault(t, now)
                    if now - since >= self.release_s:
                        self._release(t, now)
                else:
                    self._cool_since.pop(t, None)

    def _contain(self, tenant: str, share: float, entitled: float,
                 now: float) -> None:
        self._hot_since.pop(tenant, None)
        self._cool_since.pop(tenant, None)
        self._contained[tenant] = {
            "since": now, "share_at_contain": round(share, 4),
            "entitled_share": round(entitled, 4),
        }
        self._pacers[tenant] = TokenBucket(self.allowance_rps, now=now)
        self.contain_total += 1
        metrics_mod.tenant_contained.labels(tenant).set(1)
        from ..runtime.flight_recorder import RECORDER

        RECORDER.record("tenant-contained", lane=self.lane, detail={
            "tenant": tenant, "share": round(share, 4),
            "entitled_share": round(entitled, 4),
            "threshold": self.threshold,
            "contained_now": sorted(self._contained),
        })

    def _release(self, tenant: str, now: float) -> None:
        info = self._contained.pop(tenant, None)
        self._cool_since.pop(tenant, None)
        self._pacers.pop(tenant, None)
        self.release_total += 1
        metrics_mod.tenant_contained.labels(tenant).set(0)
        # drop the label child on release: live children then equal the
        # contained set (<= max_contained) — without this, every tenant
        # EVER contained would keep a permanent series and containment
        # churn across a large corpus would mint labels without bound,
        # the exact leak the declared TENANT_LABEL_BOUNDS forbids
        try:
            metrics_mod.tenant_contained.remove(tenant)
        except Exception:
            pass
        from ..runtime.flight_recorder import RECORDER

        RECORDER.record("tenant-released", lane=self.lane, detail={
            "tenant": tenant,
            "contained_s": round(now - info["since"], 3) if info else None,
        })

    def reset(self, now: Optional[float] = None) -> None:
        """Release every contained tenant and clear the hot/cool timers —
        bench/test seam for starting a measured window from a known
        state (records `tenant-released` per tenant like a normal
        decay)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            for t in list(self._contained):
                self._release(t, now)
            self._hot_since.clear()
            self._cool_since.clear()

    # -- enforcement hooks ---------------------------------------------------

    def is_contained(self, tenant: str) -> bool:
        return tenant in self._contained

    def has_contained(self) -> bool:
        return bool(self._contained)

    def pace_reject(self, tenant: str,
                    now: Optional[float] = None) -> bool:
        """True when a contained tenant's arrival should be REJECTED typed
        (past the paced allowance); False = admit (the cut splits it into
        the contained part)."""
        pacer = self._pacers.get(tenant)
        if pacer is None:
            return False
        return not pacer.allow(now)

    def contained(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {t: dict(v) for t, v in self._contained.items()}

    def to_json(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "threshold": self.threshold,
                "sustain_s": self.sustain_s,
                "release_s": self.release_s,
                "max_contained": self.max_contained,
                "allowance_rps": self.allowance_rps,
                "contained": {t: dict(v)
                              for t, v in self._contained.items()},
                "contain_total": self.contain_total,
                "release_total": self.release_total,
            }
