"""Per-tenant observability folds: the tenant axis of the
vectorized provenance/SLO folds.

One call per micro-batch (never per request): ``fold`` groups the batch's
kernel rows by tenant with one ``np.unique`` + ``np.bincount`` pass — the
Python work is bounded by DISTINCT tenants in the batch, exactly the
composite-key discipline the rule heat map set — and accumulates per-tenant
requests, denies, queue-wait means, SLO bad counts and a served-rate EWMA
(the noisy-neighbor detector's share signal).

Prometheus exposition is bounded-cardinality by construction: the flush
(amortized on a cadence, forced by /debug reads) assigns real tenant label
values only to the top-K tenants by cumulative request volume and folds
everyone else into the reserved ``other`` bucket.  K is clamped to the
family's declared hard bound in ``utils.metrics.TENANT_LABEL_BOUNDS`` —
the table the metrics-catalog cardinality lint enforces."""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

import numpy as np

from ..utils import metrics as metrics_mod
from ..utils.slo import KeyedBurn

__all__ = ["TenantStats"]


class _TenantCounters:
    __slots__ = ("requests", "denies", "slo_bad", "wait_ewma", "rate_ewma",
                 "rate_t", "rate_pend", "last_seen")

    def __init__(self, now: float):
        self.requests = 0
        self.denies = 0
        self.slo_bad = 0
        self.wait_ewma = 0.0
        self.rate_ewma = 0.0   # served rows/s (decaying)
        self.rate_t = now
        # rows folded since the last rate-EWMA step: batches can land far
        # faster than the 50ms rate window, and dividing only the LAST
        # batch's rows by the full elapsed dt would silently undercount
        # exactly the hot tenants the detector's share signal exists for
        self.rate_pend = 0
        self.last_seen = now


class TenantStats:
    FLUSH_S = 2.0

    def __init__(self, lane: str, top_k: int = 16, max_tenants: int = 8192,
                 burn_window_s: float = 60.0, gc_idle_s: float = 600.0):
        self.lane = lane
        bound = min(metrics_mod.TENANT_LABEL_BOUNDS.get(
            "auth_server_tenant_requests_total", 32), 32)
        self.top_k = max(1, min(int(top_k), bound))
        self.max_tenants = int(max_tenants)
        self.gc_idle_s = float(gc_idle_s)
        self._lock = threading.Lock()
        self._t: Dict[str, _TenantCounters] = {}
        # Prometheus deltas keyed by the FOLD's lane (the plane is shared
        # across engine + native; the aggregate _t table serves shares/
        # waits, but exported counters must say which lane served)
        self._lane_delta: Dict[str, Dict[str, list]] = {}
        self.burn = KeyedBurn(window_s=burn_window_s)
        self._last_flush = time.monotonic()
        self._label_of: Dict[str, str] = {}  # tenant -> prometheus label
        self.fold_calls = 0
        self.total_requests = 0
        # wait-observation sink (TenantAdmission.observe_waits), attached
        # by the plane so the per-tenant CoDel signal rides this same fold
        self.wait_sink = None

    # -- folding (one call per batch) ---------------------------------------

    def fold(self, heat, rows, firing=None, shards=None, waits=None,
             bad_mask=None, denied_mask=None, lane: Optional[str] = None,
             now: Optional[float] = None) -> None:
        """Fold one batch's tenant axis.  ``heat`` resolves kernel rows to
        tenant names (the snapshot's HeatMap — attribution and tenancy
        read identical evidence); ``firing`` (or ``denied_mask``) marks
        denials; ``waits`` (seconds, per row, optional) are QUEUE waits —
        they feed the per-tenant wait EWMAs and the per-tenant CoDel sink
        (pass None on lanes without a per-request queue clock);
        ``bad_mask`` (bool per row, optional) marks SLO-budget burns
        (callers decide the SLI — sojourn vs batch round trip); ``lane``
        labels the Prometheus deltas (defaults to the plane's lane)."""
        if heat is None:
            return
        rows = np.asarray(rows, dtype=np.int64)
        n = int(rows.size)
        if not n:
            return
        now = time.monotonic() if now is None else now
        lane = lane or self.lane
        self.fold_calls += 1
        self.total_requests += n
        flat = rows
        cps = getattr(heat, "configs_per_shard", None)
        if shards is not None and cps:
            flat = np.asarray(shards, dtype=np.int64) * cps + rows
        if denied_mask is None and firing is not None:
            denied_mask = np.asarray(firing, dtype=np.int64) >= 0
        uniq, inv = np.unique(flat, return_inverse=True)
        tot = np.bincount(inv, minlength=len(uniq))
        den = (np.bincount(inv[denied_mask], minlength=len(uniq))
               if denied_mask is not None and np.any(denied_mask)
               else np.zeros(len(uniq), dtype=np.int64))
        if waits is not None:
            waits = np.asarray(waits, dtype=np.float64)
            if waits.size == n:
                wsum = np.bincount(inv, weights=waits, minlength=len(uniq))
                wmin = np.full(len(uniq), np.inf)
                np.minimum.at(wmin, inv, waits)
            else:
                waits = None
        bad = None
        if bad_mask is not None:
            bad_mask = np.asarray(bad_mask, dtype=bool)
            bad = (np.bincount(inv[bad_mask], minlength=len(uniq))
                   if np.any(bad_mask)
                   else np.zeros(len(uniq), dtype=np.int64))
        with self._lock:
            per_lane = self._lane_delta.setdefault(lane, {})
            for i, u in enumerate(uniq):
                name = heat.name(int(u))
                if not name:
                    continue
                c = self._t.get(name)
                if c is None:
                    c = self._t[name] = _TenantCounters(now)
                k = int(tot[i])
                c.requests += k
                c.denies += int(den[i])
                c.last_seen = now
                # served-rate EWMA: rows accumulate across folds inside
                # the 50ms window, then the whole window's rows divide
                # the elapsed dt (never just the last batch's)
                c.rate_pend += k
                dt = now - c.rate_t
                if dt > 0.05:
                    inst = c.rate_pend / dt
                    c.rate_ewma = inst if not c.rate_ewma else \
                        0.7 * c.rate_ewma + 0.3 * inst
                    c.rate_t = now
                    c.rate_pend = 0
                if waits is not None:
                    mean = float(wsum[i]) / k
                    c.wait_ewma = mean if not c.wait_ewma else \
                        0.8 * c.wait_ewma + 0.2 * mean
                    if self.wait_sink is not None:
                        self.wait_sink(name, mean, float(wmin[i]), now)
                b = int(bad[i]) if bad is not None else 0
                if b:
                    c.slo_bad += b
                if bad is not None:
                    self.burn.fold(name, k, b, now=now)
                d = per_lane.setdefault(name, [0, 0, 0])
                d[0] += k
                d[1] += int(den[i])
                d[2] += b
        if now - self._last_flush > self.FLUSH_S:
            self.flush(now=now)

    # -- shares (the detector's signal) -------------------------------------

    def share(self, tenant: str) -> float:
        """This tenant's share of the lane's recently-served rows (rate
        EWMAs — decays as traffic shifts)."""
        with self._lock:
            c = self._t.get(tenant)
            if c is None or not c.rate_ewma:
                return 0.0
            total = sum(x.rate_ewma for x in self._t.values())
            return c.rate_ewma / total if total > 0 else 0.0

    def shares(self) -> Dict[str, float]:
        with self._lock:
            total = sum(x.rate_ewma for x in self._t.values())
            if total <= 0:
                return {}
            return {t: c.rate_ewma / total for t, c in self._t.items()
                    if c.rate_ewma > 0}

    def rate(self, tenant: str) -> float:
        with self._lock:
            c = self._t.get(tenant)
            return c.rate_ewma if c is not None else 0.0

    def export_fold(self) -> Dict[str, Dict[str, float]]:
        """Raw per-tenant counters for a fleet fold publisher:
        cumulative requests/denies/slo_bad plus the live served-rate EWMA.
        Cumulative counts let the aggregator difference consecutive folds
        into deltas; the rate EWMAs are what global tenant share sums —
        per-replica SHARES cannot be averaged (consistent-hash routing
        concentrates tenants, so a fleet-hot tenant can look locally
        entitled on every replica at once — the exact blindness the global
        fold exists to remove)."""
        with self._lock:
            return {name: {
                "requests": c.requests,
                "denies": c.denies,
                "slo_bad": c.slo_bad,
                "rate": c.rate_ewma,
            } for name, c in self._t.items()}

    # -- prometheus flush (top-K + other) -----------------------------------

    def _labels(self) -> Dict[str, str]:
        """Tenant -> label value: the top-K tenants by cumulative volume
        get their own value, everyone else folds into `other`.  A tenant
        that falls OUT of the top-K keeps its minted label (monotonic
        counters must not teleport into `other`); the hard bound holds
        because minted labels only grow to the bound and then stop."""
        ranked = sorted(self._t.items(), key=lambda kv: -kv[1].requests)
        bound = min(metrics_mod.TENANT_LABEL_BOUNDS.get(
            "auth_server_tenant_requests_total", 32), 32)
        for name, _ in ranked[:self.top_k]:
            if name not in self._label_of and len(self._label_of) < bound:
                self._label_of[name] = name
        return self._label_of

    def flush(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._last_flush = now
            labels = self._labels()
            deltas = []
            for lane, per in self._lane_delta.items():
                for name, (dr, dd, db) in per.items():
                    deltas.append((lane,
                                   labels.get(name,
                                              metrics_mod.TENANT_OTHER),
                                   dr, dd, db))
            self._lane_delta.clear()
            gauges = [(labels[name], c.wait_ewma) for name, c in
                      self._t.items() if name in labels]
            if len(self._t) > self.max_tenants:
                for t in [t for t, c in self._t.items()
                          if now - c.last_seen > self.gc_idle_s]:
                    self._t.pop(t, None)
        for lane, label, dr, dd, db in deltas:
            if dr:
                metrics_mod.tenant_requests.labels(lane, label).inc(dr)
            if dd:
                metrics_mod.tenant_denied.labels(lane, label).inc(dd)
            if db:
                metrics_mod.tenant_slo_bad.labels(lane, label).inc(db)
        for label, w in gauges:
            metrics_mod.tenant_queue_wait.labels(label).set(round(w, 6))

    def count_reject(self, tenant: str, reason: str) -> None:
        with self._lock:
            label = self._label_of.get(tenant, metrics_mod.TENANT_OTHER)
        metrics_mod.tenant_rejected.labels(label, reason).inc()

    # -- introspection -------------------------------------------------------

    def to_json(self, top: int = 16) -> Dict[str, Any]:
        with self._lock:
            ranked = sorted(self._t.items(), key=lambda kv: -kv[1].requests)
            total_rate = sum(c.rate_ewma for _, c in ranked) or 1.0
            rows = [{
                "tenant": name,
                "requests": c.requests,
                "denies": c.denies,
                "slo_bad": c.slo_bad,
                "queue_wait_ewma_ms": round(c.wait_ewma * 1e3, 3),
                "share": round(c.rate_ewma / total_rate, 4),
            } for name, c in ranked[:top]]
            n = len(self._t)
        return {
            "lane": self.lane,
            "tenants_seen": n,
            "top_k": self.top_k,
            "fold_calls": self.fold_calls,
            "requests_total": self.total_requests,
            "top": rows,
            "slo_burn": self.burn.to_json(top=8),
        }
