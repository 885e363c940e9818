"""Fleet-wide fold aggregation: global guards over per-replica
evidence.

Every guard the serving stack grew — SLO burn, noisy-neighbor
containment, canary deny/error/SLO deltas — acted on ONE
replica's slice of the traffic.  Consistent-hash routing makes that slice
systematically unrepresentative: a fleet-hot tenant's requests concentrate
on few replicas, where the LOCAL fair share among the few tenants present
is large — so every replica individually judges the tenant entitled while
the tenant eats an outsized share of the FLEET.  Dually, a poison config
canaried on one replica shows its deny spike only there; the other
replicas' clean folds must serve as its baseline cohort.

So replicas publish lightweight FOLDS (engine.fleet_fold(): cumulative
counters + rate EWMAs, one small dict on a cadence — never per-request
anything), and this aggregator:

- differences consecutive folds into per-replica DELTAS and replays them
  through a :class:`~..runtime.change_safety.CanaryGuard` via its
  count-level feed — the canary replica's deltas land on the canary side,
  the rest of the fleet's on the baseline side, so ``breach()`` judges
  GLOBAL deltas with the exact thresholds/min-sample gates/changed-set
  restriction the in-process canary uses;
- sums per-tenant served-rate EWMAs into GLOBAL tenant shares and runs
  the containment inequality (share > entitled × threshold, under global
  pressure) on them — the check that fires when every per-replica share
  is individually under threshold.

Import-light by construction (stdlib + numpy via change_safety): the
cross-replica guard math must load and tier-1-test on images without the
identity-evaluator dependency set."""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from ..runtime.change_safety import CanaryGuard, GuardThresholds
from ..utils import metrics as metrics_mod

__all__ = ["FleetAggregator", "GlobalContainment"]


class GlobalContainment:
    """The cross-replica noisy-neighbor inequality on GLOBAL shares.

    Mirrors tenancy/containment.py's per-replica check — contain when
    share > max(entitled × threshold, min_share) under pressure, sustained
    — but `share` is the tenant's fraction of the FLEET's served rate
    (per-replica rate EWMAs summed, then normalized) and `entitled` its
    fair share among the tenants active fleet-wide.  Per-replica shares
    are never averaged: routing concentration makes each of them lie."""

    def __init__(self, threshold: float = 3.0, min_share: float = 0.05,
                 sustain_s: float = 0.5, weights=None):
        self.threshold = float(threshold)
        self.min_share = float(min_share)
        self.sustain_s = float(sustain_s)
        # tenant -> weight (defaults to 1.0: equal entitlement)
        self.weights = dict(weights or {})
        self._hot_since: Dict[str, float] = {}
        self.suspects: Dict[str, Dict[str, Any]] = {}

    def _entitled(self, tenant: str, active: List[str]) -> float:
        total = sum(self.weights.get(t, 1.0) for t in active)
        if total <= 0:
            return 0.0
        return self.weights.get(tenant, 1.0) / total

    def check(self, rates: Dict[str, float], pressure: bool,
              now: Optional[float] = None) -> Dict[str, Dict[str, Any]]:
        """One containment evaluation over summed per-tenant rates.
        Returns the sustained suspects: tenant -> {share, entitled,
        ratio}.  ``pressure`` is the fleet-pressure gate (any replica's
        wait over target, or rising global admission rejections) — a hot
        tenant on an idle fleet is just traffic."""
        now = time.monotonic() if now is None else now
        total = sum(r for r in rates.values() if r > 0)
        if not pressure or total <= 0:
            self._hot_since.clear()
            self.suspects = {}
            return {}
        active = [t for t, r in rates.items() if r > 0]
        out: Dict[str, Dict[str, Any]] = {}
        for tenant in active:
            share = rates[tenant] / total
            entitled = self._entitled(tenant, active)
            bound = max(entitled * self.threshold, self.min_share)
            if share > bound:
                since = self._hot_since.setdefault(tenant, now)
                if now - since >= self.sustain_s:
                    out[tenant] = {
                        "share": round(share, 4),
                        "entitled": round(entitled, 4),
                        "ratio": round(share / entitled, 4)
                        if entitled else float("inf"),
                    }
            else:
                self._hot_since.pop(tenant, None)
        self.suspects = out
        return out


class FleetAggregator:
    """Latest-fold store + delta replay into the global guards.

    ``ingest`` takes one replica's fold (engine.fleet_fold()); the
    aggregator differences it against that replica's previous fold and —
    while a fleet canary is armed — replays the delta through the global
    :class:`CanaryGuard` (canary replica → canary cohort, everyone else →
    baseline).  ``global_shares``/``containment_check`` read the latest
    folds directly (rate EWMAs are levels, not counters — no differencing
    needed)."""

    def __init__(self, containment: Optional[GlobalContainment] = None):
        self._lock = threading.Lock()
        self._latest: Dict[str, Dict[str, Any]] = {}
        self._guard_seen: Dict[str, Dict[str, Any]] = {}
        self.containment = containment or GlobalContainment()
        self.guard: Optional[CanaryGuard] = None
        self._canary_replica: Optional[str] = None
        self.breaches: List[Dict[str, Any]] = []

    # -- fold ingestion -----------------------------------------------------

    def ingest(self, replica: str, fold: Dict[str, Any]) -> None:
        with self._lock:
            self._latest[replica] = dict(fold, _ingested=time.monotonic())
            guard = self.guard
            if guard is None:
                return
            delta = self._delta(replica, fold)
        if delta is not None:
            guard.observe_counts(replica == self._canary_replica, **delta)

    def forget(self, replica: str) -> None:
        """Drop a removed/crashed replica's fold — its rates must stop
        counting toward global shares the moment it leaves the fleet."""
        with self._lock:
            self._latest.pop(replica, None)
            self._guard_seen.pop(replica, None)

    def _delta(self, replica: str,
               fold: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Cumulative-counter delta of one fold vs the replica's previous
        GUARD-SEEN fold.  Counter resets (a restarted replica reports
        smaller cumulatives) clamp to zero instead of going negative."""
        prev = self._guard_seen.get(replica) or {}
        self._guard_seen[replica] = fold

        def d(key: str) -> int:
            return max(0, int(fold.get(key, 0)) - int(prev.get(key, 0)))

        configs: Dict[str, tuple] = {}
        prev_t = prev.get("tenants") or {}
        for name, c in (fold.get("tenants") or {}).items():
            p = prev_t.get(name) or {}
            dr = max(0, int(c.get("requests", 0)) - int(p.get("requests", 0)))
            dd = max(0, int(c.get("denies", 0)) - int(p.get("denies", 0)))
            if dr or dd:
                configs[name] = (dr, dd)
        rejects: Dict[str, int] = {}
        prev_r = prev.get("tenant_rejects") or {}
        for name, n in (fold.get("tenant_rejects") or {}).items():
            dn = max(0, int(n) - int(prev_r.get(name, 0)))
            if dn:
                rejects[name] = dn
        total = sum(t for t, _ in configs.values())
        denies = sum(dd for _, dd in configs.values())
        if not (total or denies or d("errors") or d("slo_total") or rejects):
            return None
        return {
            "total": total, "denies": denies, "errors": d("errors"),
            "slo_total": d("slo_total"), "slo_bad": d("slo_bad"),
            "configs": configs, "tenant_rejects": rejects,
        }

    # -- fleet canary guard -------------------------------------------------

    def arm_guard(self, canary_replica: str,
                  changed: Optional[set] = None,
                  thresholds: Optional[GuardThresholds] = None,
                  check_interval_s: float = 0.0) -> CanaryGuard:
        """Arm the global canary guard: ``canary_replica``'s fold deltas
        feed the canary cohort, every other replica's the baseline.
        ``changed`` is the candidate reconcile's recompile set (the
        fingerprint diff) — the same selection-bias restriction the
        in-process guard applies."""
        with self._lock:
            self.guard = CanaryGuard(thresholds=thresholds,
                                     check_interval_s=check_interval_s,
                                     changed=changed)
            self._canary_replica = canary_replica
            # re-baseline the delta window: counts accumulated BEFORE the
            # canary applied must not leak into either cohort
            self._guard_seen = {r: f for r, f in self._latest.items()}
            return self.guard

    def disarm_guard(self) -> None:
        with self._lock:
            guard, self.guard = self.guard, None
            self._canary_replica = None
        if guard is not None:
            guard.close()

    def guard_breach(self) -> Optional[Dict[str, Any]]:
        guard = self.guard
        if guard is None:
            return None
        b = guard.breach(force=True)
        if b is not None and not any(x is b for x in self.breaches):
            self.breaches.append(b)
            for g in b.get("guards", []):
                metrics_mod.fleet_guard_breach.labels(g).inc()
        return b

    # -- global tenant shares / containment ---------------------------------

    def global_rates(self) -> Dict[str, float]:
        """Per-tenant served rates summed across the fleet (the EWMAs are
        levels — summing across replicas is the fold)."""
        out: Dict[str, float] = {}
        with self._lock:
            for fold in self._latest.values():
                for name, c in (fold.get("tenants") or {}).items():
                    r = float(c.get("rate", 0.0))
                    if r > 0:
                        out[name] = out.get(name, 0.0) + r
        return out

    def global_shares(self) -> Dict[str, float]:
        rates = self.global_rates()
        total = sum(rates.values())
        if total <= 0:
            return {}
        return {t: r / total for t, r in rates.items()}

    def fleet_pressure(self) -> bool:
        """Any replica under admission pressure (wait over target or a
        non-HEALTHY admission state) pressurizes the fleet check — one
        saturated replica is exactly where a concentrated hot tenant
        does its damage."""
        with self._lock:
            folds = list(self._latest.values())
        for f in folds:
            if f.get("wait_hot") or \
                    (f.get("admission_state") or "HEALTHY") != "HEALTHY":
                return True
        return False

    def containment_check(self, now: Optional[float] = None,
                          ) -> Dict[str, Dict[str, Any]]:
        suspects = self.containment.check(self.global_rates(),
                                          self.fleet_pressure(), now=now)
        for _ in suspects:
            metrics_mod.fleet_guard_breach.labels(
                "global-tenant-share").inc()
        return suspects

    def to_json(self) -> Dict[str, Any]:
        with self._lock:
            folds = {r: {k: v for k, v in f.items()
                         if k not in ("tenants", "tenant_rejects")}
                     for r, f in self._latest.items()}
            canary = self._canary_replica
        return {
            "replicas": sorted(folds),
            "folds": folds,
            "canary_replica": canary,
            "guard": self.guard.to_json() if self.guard is not None
            else None,
            "global_shares": {t: round(s, 4)
                              for t, s in self.global_shares().items()},
            "containment_suspects": self.containment.suspects,
            "breaches": self.breaches[-4:],
        }
