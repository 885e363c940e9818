"""Change safety: canary snapshot swaps, guard-breach rollback, and
poison-config quarantine.

A *semantically valid yet wrong* AuthConfig (an operator typo that
constant-denies a hot host) passes every compile-time gate and, in a
hot-swap model, serves 100% of traffic the instant the swap lands.  This
module is the runtime side of the blast-radius control:

- **canary cohort**: a deterministic hash-fraction of requests
  (``--canary-fraction``) routes to the NEW snapshot generation while the
  rest keeps serving the previous one.  The hash is over stable request
  identity (host|path|method), so a request lands in the same cohort on
  every retry and on every replica — no per-request randomness, no sticky
  state;
- **guards** (:class:`CanaryGuard`): per-cohort deny rates (overall and
  per-authconfig — fed from the which-rule-fired attribution fold),
  typed-error rates, and SLO bad-fractions, compared canary vs baseline.
  A breach inside the ``--canary-window`` triggers automatic rollback; a
  clean window promotes to 100%;
- **quarantine** (driven by the engine): on breach, the fingerprint
  diff (snapshots/diff.py) names the configs the reconcile changed and the guard's per-config
  deltas pin the deny spike on specific ones; the reconcile is re-applied
  with only those poison configs reverted to their prior compiled
  artifacts — the rest of the change still lands.

Everything here is per-BATCH work (the same fold cadence as the heat map),
never per-request Python; the state machine itself lives in
``runtime/engine.py``.  The port's copy of the JAX package's module: the
cohort hash, the guard's arithmetic and its JSON are held equal to it."""

from __future__ import annotations

import threading
import time
import zlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..utils import metrics as metrics_mod

__all__ = ["COHORT_BUCKETS", "cohort_bucket", "in_canary_cohort",
           "GuardThresholds", "CanaryGuard", "CanaryPhase",
           "guard_self_test"]

# cohort hash resolution: fraction granularity is 1/10000 (0.01%)
COHORT_BUCKETS = 10000


def cohort_bucket(doc: Any) -> int:
    """Deterministic cohort bucket of one authorization JSON: crc32 over
    the request's stable identity (host|path|method).  The same request —
    retried, re-dispatched, or hitting another replica — always lands in
    the same bucket, so a canary never flaps a client between generations
    mid-session."""
    try:
        req = doc.get("request") or {}
        key = "%s|%s|%s" % (req.get("host", ""),
                            req.get("path") or req.get("url_path", ""),
                            req.get("method", ""))
    except Exception:
        key = ""
    return zlib.crc32(key.encode("utf-8", "replace")) % COHORT_BUCKETS


def in_canary_cohort(doc: Any, fraction: float) -> bool:
    if fraction <= 0.0:
        return False
    if fraction >= 1.0:
        return True
    return cohort_bucket(doc) < int(fraction * COHORT_BUCKETS)


@dataclass
class GuardThresholds:
    """Breach thresholds for the canary guards.  Deltas are ABSOLUTE rate
    differences (canary − baseline): a poison constant-deny pushes a hot
    config's deny-rate delta toward 1.0, far above any honest policy
    change; transient noise on a handful of requests stays below the
    minimum sample counts and can never breach."""

    deny_delta: float = 0.25          # overall deny-rate delta
    config_deny_delta: float = 0.5    # per-authconfig deny-rate delta
    error_delta: float = 0.10         # typed serving-error rate delta
    slo_delta: float = 0.25           # SLO bad-fraction delta
    min_requests: int = 32            # per cohort, for the overall guards
    min_config_requests: int = 16     # per (cohort, authconfig)
    # allow-collapse guard: a config whose canary cohort keeps LESS than
    # this fraction of its baseline allow rate breaches even when the
    # baseline deny rate was already high (where an absolute deny delta
    # saturates — a constant-deny on a 70%-deny config only moves the
    # delta 0.3).  Requires at least min_config_allows baseline allows so
    # an always-denying config can never trip it.
    allow_collapse_ratio: float = 0.5
    min_config_allows: int = 8
    # per-tenant rejection guard: a canaried change that pushes
    # its OWN tenant's traffic into tenant-scoped rejections (quota /
    # containment / tenant-aware doomed shedding) at an elevated rate vs
    # the baseline cohort breaches — the per-config deny deltas above see
    # only DECIDED requests, so a change that turns a tenant's traffic
    # into admission rejections would otherwise promote blind.
    tenant_reject_delta: float = 0.25
    min_tenant_attempts: int = 16


class _CohortStats:
    __slots__ = ("total", "denies", "errors", "slo_total", "slo_bad",
                 "configs", "tenant_rejects")

    def __init__(self):
        self.total = 0
        self.denies = 0
        self.errors = 0
        self.slo_total = 0
        self.slo_bad = 0
        # authconfig name -> [requests, denies]
        self.configs: Dict[str, List[int]] = {}
        # tenant (== authconfig) -> tenant-scoped admission rejections
        # (quota / containment / tenant-aware doomed shedding)
        self.tenant_rejects: Dict[str, int] = {}

    def to_json(self) -> Dict[str, Any]:
        return {
            "requests": self.total,
            "denies": self.denies,
            "errors": self.errors,
            "slo_observed": self.slo_total,
            "slo_bad": self.slo_bad,
            "configs_seen": len(self.configs),
            "tenant_rejections": sum(self.tenant_rejects.values()),
        }


class CanaryGuard:
    """Per-cohort decision statistics + the breach decision.

    ``observe_batch`` is the hot entry point — one ``np.unique`` fold per
    micro-batch over the SAME (rows, firing) arrays the heat-map fold
    already consumes, so attribution and guarding read identical evidence.
    ``breach()`` is rate-limited (at most every ``check_interval_s``) and
    sticky: once breached, it stays breached — the engine's rollback is
    the only exit."""

    def __init__(self, thresholds: Optional[GuardThresholds] = None,
                 check_interval_s: float = 0.1,
                 changed: Optional[set] = None):
        """``changed`` restricts the per-config guards to the configs the
        reconcile actually touched (the fingerprint diff's recompile
        set): only a changed config can be poison — its siblings share the
        baseline's literal artifacts — and the cohort hash partitions the
        REQUEST space, so with few distinct requests per config the two
        cohorts sample different fixed doc subsets and an unchanged
        config's rates can differ persistently (selection bias).  None =
        no restriction (the overall guards are never restricted)."""
        self.thresholds = thresholds or GuardThresholds()
        self.changed = set(changed) if changed is not None else None
        self.check_interval_s = float(check_interval_s)
        self._lock = threading.Lock()
        self._baseline = _CohortStats()
        self._canary = _CohortStats()
        self._breach: Optional[Dict[str, Any]] = None
        self._last_check = 0.0
        self._closed = False
        self._g_delta = {
            g: metrics_mod.canary_guard_delta.labels(g)
            for g in ("deny-rate", "config-deny-rate", "error-rate",
                      "slo-bad-rate", "tenant-rejection-rate")}

    def _side(self, canary: bool) -> _CohortStats:
        return self._canary if canary else self._baseline

    # -- feeding (per batch, both lanes) ------------------------------------

    def observe_batch(self, canary: bool, rows, firing, heat,
                      shards=None) -> None:
        """Fold one batch's attribution into the cohort's stats: ``rows``
        are kernel config rows, ``firing`` the per-request firing column
        (−1 = allowed), ``heat`` the snapshot's HeatMap (row → authconfig
        name; both cohorts' corpora name configs identically)."""
        if heat is None or firing is None:
            return
        rows = np.asarray(rows, dtype=np.int64)
        firing = np.asarray(firing, dtype=np.int64)
        if rows.size == 0:
            return
        if shards is not None and getattr(heat, "configs_per_shard", None):
            rows = np.asarray(shards, dtype=np.int64) * \
                heat.configs_per_shard + rows
        denied = firing >= 0
        uniq, inv = np.unique(rows, return_inverse=True)
        tot = np.bincount(inv, minlength=len(uniq))
        den = np.bincount(inv[denied], minlength=len(uniq)) if \
            denied.any() else np.zeros(len(uniq), dtype=np.int64)
        side = self._side(canary)
        with self._lock:
            side.total += int(rows.size)
            side.denies += int(np.count_nonzero(denied))
            for u, t, d in zip(uniq, tot, den):
                name = heat.name(int(u))
                if not name:
                    continue
                st = side.configs.setdefault(name, [0, 0])
                st[0] += int(t)
                st[1] += int(d)

    def observe_counts(self, canary: bool, total: int = 0, denies: int = 0,
                       errors: int = 0, slo_total: int = 0,
                       slo_bad: int = 0, configs=None,
                       tenant_rejects=None) -> None:
        """Count-level cohort feed: fold pre-aggregated deltas
        into one cohort's stats.  The fleet aggregator replays each
        replica's published fold deltas through this — the canary
        replica's counts land on the canary side, the rest of the fleet's
        on the baseline side — so ``breach()`` judges GLOBAL deny/error/
        SLO deltas with the exact thresholds, minimum-sample gates, and
        changed-set restriction the in-process canary uses.  ``configs``
        maps authconfig name → (requests, denies); ``tenant_rejects``
        maps tenant → tenant-scoped rejection count."""
        side = self._side(canary)
        with self._lock:
            side.total += max(0, int(total))
            side.denies += max(0, int(denies))
            side.errors += max(0, int(errors))
            side.slo_total += max(0, int(slo_total))
            side.slo_bad += max(0, int(slo_bad))
            for name, td in (configs or {}).items():
                st = side.configs.setdefault(str(name), [0, 0])
                st[0] += max(0, int(td[0]))
                st[1] += max(0, int(td[1]))
            for name, n in (tenant_rejects or {}).items():
                if n > 0:
                    side.tenant_rejects[str(name)] = \
                        side.tenant_rejects.get(str(name), 0) + int(n)

    def observe_errors(self, canary: bool, n: int) -> None:
        """Typed serving errors (UNAVAILABLE-class — deadline sheds and
        overload rejections are the protection mechanism working and stay
        out of the guard, mirroring the SLO tracker's semantics)."""
        if n <= 0:
            return
        side = self._side(canary)
        with self._lock:
            side.errors += int(n)

    def observe_slo(self, canary: bool, n: int, n_bad: int) -> None:
        if n <= 0:
            return
        side = self._side(canary)
        with self._lock:
            side.slo_total += int(n)
            side.slo_bad += int(n_bad)

    def observe_tenant_rejection(self, canary: bool, tenant: str,
                                 n: int = 1) -> None:
        """Tenant-scoped admission rejections — per-tenant guard
        evidence: the changed tenant's cohort must not start eating
        quota/containment rejections the baseline cohort does not.  Unfed
        until the port has a tenancy plane."""
        if n <= 0:
            return
        side = self._side(canary)
        with self._lock:
            side.tenant_rejects[tenant] = \
                side.tenant_rejects.get(tenant, 0) + int(n)

    # -- deciding ------------------------------------------------------------

    def breach(self, now: Optional[float] = None,
               force: bool = False) -> Optional[Dict[str, Any]]:
        """The guard verdict: a dict naming the breached guard(s), the
        deltas, and the suspect configs — or None.  Sticky once breached;
        rate-limited between evaluations (the per-config scan is bounded
        by configs SEEN by the cohorts, evaluated on the check cadence,
        never per batch).  ``force`` bypasses the rate limit — the
        window-expiry conclusion must never skip its final evaluation
        just because a per-batch check ran moments earlier."""
        if self._breach is not None:
            return self._breach
        now = time.monotonic() if now is None else now
        if not force and now - self._last_check < self.check_interval_s:
            return None
        self._last_check = now
        th = self.thresholds
        with self._lock:
            b, c = self._baseline, self._canary
            deltas: Dict[str, float] = {}
            breached: List[str] = []
            suspects: List[Tuple[str, float]] = []
            overall_ok = (c.total >= th.min_requests
                          and b.total >= th.min_requests)
            b_rate = (b.denies / b.total) if b.total else 0.0
            if overall_ok:
                deltas["deny-rate"] = c.denies / c.total - b_rate
                if deltas["deny-rate"] > th.deny_delta:
                    breached.append("deny-rate")
            # the error guard counts ATTEMPTED requests (decided +
            # errored), not decided ones: a canary whose batches ALL fail
            # never accumulates decided samples — exactly the generation
            # that must not ride the min-sample gate to a blind promote
            ce_n, be_n = c.total + c.errors, b.total + b.errors
            if ce_n >= th.min_requests and be_n >= th.min_requests:
                deltas["error-rate"] = c.errors / ce_n - b.errors / be_n
                if deltas["error-rate"] > th.error_delta:
                    breached.append("error-rate")
            if (c.slo_total >= th.min_requests
                    and b.slo_total >= th.min_requests):
                deltas["slo-bad-rate"] = (c.slo_bad / c.slo_total
                                          - b.slo_bad / b.slo_total)
                if deltas["slo-bad-rate"] > th.slo_delta:
                    breached.append("slo-bad-rate")
            # per-authconfig guards: the quarantine's attribution
            # evidence, restricted to the CHANGED configs (see __init__).
            # Two criteria: an absolute deny-rate delta, and an
            # allow-collapse ratio (constant-deny on an already-denying
            # config saturates the absolute delta).  The baseline rate
            # falls back to the cohort-wide baseline when the specific
            # config lacks baseline samples — never to 0, so an
            # always-denying config cannot false-breach.
            for name, (ct, cd) in c.configs.items():
                if self.changed is not None and name not in self.changed:
                    continue
                if ct < th.min_config_requests:
                    continue
                bt, bd = b.configs.get(name, (0, 0))
                if bt >= th.min_config_requests:
                    base = bd / bt
                elif b.total >= th.min_requests:
                    bt, bd = b.total, b.denies
                    base = b_rate
                else:
                    continue
                delta = cd / ct - base
                collapsed = (bt - bd >= th.min_config_allows
                             and (ct - cd) / ct
                             < th.allow_collapse_ratio * (bt - bd) / bt)
                if delta > th.config_deny_delta or collapsed:
                    suspects.append((name, delta))
            if suspects:
                breached.append("config-deny-rate")
                deltas["config-deny-rate"] = max(d for _, d in suspects)
            # per-TENANT rejection guard: the changed tenant's
            # cohort specifically — the per-config deny deltas see only
            # decided requests; a change that converts its tenant's traffic
            # into tenant-scoped admission rejections (quota, containment,
            # tenant-aware doomed shedding) must breach here instead of
            # promoting blind.  Attempts = decided + rejected per tenant.
            t_suspects: List[Tuple[str, float]] = []
            for name in set(c.tenant_rejects) | set(b.tenant_rejects):
                if self.changed is not None and name not in self.changed:
                    continue
                ct, _cd = c.configs.get(name, (0, 0))
                bt, _bd = b.configs.get(name, (0, 0))
                cr = c.tenant_rejects.get(name, 0)
                br = b.tenant_rejects.get(name, 0)
                c_att, b_att = ct + cr, bt + br
                if (c_att < th.min_tenant_attempts
                        or b_att < th.min_tenant_attempts):
                    continue
                t_delta = cr / c_att - br / b_att
                if t_delta > th.tenant_reject_delta:
                    t_suspects.append((name, t_delta))
            if t_suspects:
                breached.append("tenant-rejection-rate")
                deltas["tenant-rejection-rate"] = max(
                    d for _, d in t_suspects)
                suspects.extend(t_suspects)
        if not self._closed:
            for g, child in self._g_delta.items():
                if g in deltas:
                    child.set(deltas[g])
        if not breached:
            return None
        suspects.sort(key=lambda x: -x[1])
        self._breach = {
            "guards": breached,
            "deltas": {k: round(v, 4) for k, v in deltas.items()},
            "suspects": [name for name, _ in suspects],
            "suspect_deltas": {name: round(d, 4) for name, d in suspects},
            "baseline": self._baseline.to_json(),
            "canary": self._canary.to_json(),
        }
        return self._breach

    def close(self) -> None:
        """Canary concluded (promote or rollback): zero the live delta
        gauges — they are documented as the deltas of the canary IN
        PROGRESS, and a breach-level value lingering after the rollback
        already handled it keeps dashboards and alerts firing."""
        self._closed = True
        for child in self._g_delta.values():
            child.set(0.0)

    def to_json(self) -> Dict[str, Any]:
        with self._lock:
            out = {
                "thresholds": {
                    "deny_delta": self.thresholds.deny_delta,
                    "config_deny_delta": self.thresholds.config_deny_delta,
                    "error_delta": self.thresholds.error_delta,
                    "slo_delta": self.thresholds.slo_delta,
                    "min_requests": self.thresholds.min_requests,
                    "min_config_requests":
                        self.thresholds.min_config_requests,
                    "allow_collapse_ratio":
                        self.thresholds.allow_collapse_ratio,
                    "min_config_allows": self.thresholds.min_config_allows,
                },
                "changed_watched": (sorted(self.changed)[:32]
                                    if self.changed is not None else None),
                "baseline": self._baseline.to_json(),
                "canary": self._canary.to_json(),
            }
        out["breach"] = self._breach
        return out


class CanaryPhase:
    """One in-progress canary swap: the candidate snapshot, the baseline it
    canaries against (both pinned — rollback is a pointer swap), the
    reconcile's entries (the quarantine re-apply input), both host indexes,
    and the guard.  Transitions (promote / rollback) are owned by the
    engine under its swap lock; this object only carries state + the
    window timer."""

    def __init__(self, snap, baseline, entries, index, baseline_index,
                 fraction: float, window_s: float,
                 guard: Optional[CanaryGuard] = None,
                 preflight: Optional[Dict[str, Any]] = None):
        self.snap = snap
        self.baseline = baseline
        self.entries = list(entries)
        self.index = index
        self.baseline_index = baseline_index
        self.fraction = float(fraction)
        self.window_s = float(window_s)
        self.guard = guard or CanaryGuard()
        # replay preflight summary: a candidate that survived a pregate
        # carries the evidence here and /debug/canary shows it (the port
        # has no pregate yet: None)
        self.preflight = preflight
        # kernel cost stamp: the reconcile's modeled-cost
        # record — a canaried swap whose per-row cost regressed >=2x
        # carries the evidence on /debug/canary and the bench artifact
        self.kernel_cost: Optional[Dict[str, Any]] = None
        self.t_start = time.monotonic()
        self.started_unix = time.time()
        self._timer: Optional[threading.Timer] = None

    def in_cohort(self, doc: Any) -> bool:
        return in_canary_cohort(doc, self.fraction)

    def expired(self) -> bool:
        return time.monotonic() - self.t_start >= self.window_s

    def start_timer(self, conclude) -> None:
        """Arm the window-expiry timer: promotion must not wait for
        traffic (an idle canary with no breach evidence promotes at the
        window end, like a clean one)."""
        t = threading.Timer(self.window_s, conclude)
        t.daemon = True
        t.name = "atpu-canary-window"
        self._timer = t
        t.start()

    def cancel_timer(self) -> None:
        t = self._timer
        if t is not None:
            t.cancel()
            self._timer = None

    def to_json(self) -> Dict[str, Any]:
        return {
            "generation": getattr(self.snap, "generation", None),
            "baseline_generation": getattr(self.baseline, "generation",
                                           None),
            "fraction": self.fraction,
            "window_s": self.window_s,
            "age_s": round(time.monotonic() - self.t_start, 3),
            "started_unix": self.started_unix,
            "guard": self.guard.to_json(),
            "preflight": self.preflight,
            "kernel_cost": self.kernel_cost,
        }


# ---------------------------------------------------------------------------
# self-test (pinned by the tests): a blind guard is itself
# a failure — a planted constant-deny poison MUST breach, a clean churn
# MUST stay clean (and therefore promote at the window end)
# ---------------------------------------------------------------------------


class _StubHeat:
    configs_per_shard = None

    def __init__(self, names):
        self._names = list(names)

    def name(self, row: int, shard=None) -> str:
        return self._names[row] if 0 <= row < len(self._names) else ""


def _feed(guard: CanaryGuard, canary: bool, heat, row: int, n: int,
          deny_frac: float) -> None:
    rows = np.full(n, row, dtype=np.int64)
    firing = np.full(n, -1, dtype=np.int64)
    firing[: int(n * deny_frac)] = 0
    guard.observe_batch(canary, rows, firing, heat)


def guard_self_test() -> List[str]:
    """Prove the guard can still see: (a) a planted constant-deny poison
    on one config breaches with that config named as the suspect; (b) an
    identical-rate clean churn does NOT breach (it would promote).  Pinned
    by the tests — a blind or trigger-happy guard fails both."""
    errors: List[str] = []
    heat = _StubHeat(["cfg-clean", "cfg-poison"])

    clean = CanaryGuard(check_interval_s=0.0)
    for _ in range(4):
        _feed(clean, False, heat, 0, 64, 0.10)
        _feed(clean, True, heat, 0, 64, 0.10)
        _feed(clean, False, heat, 1, 64, 0.05)
        _feed(clean, True, heat, 1, 64, 0.05)
    if clean.breach() is not None:
        errors.append("guard breached on a CLEAN churn (identical deny "
                      f"rates both cohorts): {clean.breach()}")

    poisoned = CanaryGuard(check_interval_s=0.0)
    for _ in range(4):
        _feed(poisoned, False, heat, 0, 64, 0.10)
        _feed(poisoned, True, heat, 0, 64, 0.10)
        _feed(poisoned, False, heat, 1, 64, 0.05)
        _feed(poisoned, True, heat, 1, 64, 1.00)  # constant-deny poison
    b = poisoned.breach()
    if b is None:
        errors.append("guard BLIND: a planted constant-deny poison config "
                      "did not breach inside the window")
    elif "cfg-poison" not in b.get("suspects", []):
        errors.append("guard failed to pin the deny spike on the poison "
                      f"config (suspects={b.get('suspects')})")
    elif "cfg-clean" in b.get("suspects", []):
        errors.append("guard mis-attributed the poison to a clean config")

    # allow-collapse: a constant-deny on a config whose baseline ALREADY
    # denied 70% moves the absolute delta only 0.3 — the collapse ratio
    # (canary kept <50% of the baseline allow rate) must still breach
    collapse = CanaryGuard(check_interval_s=0.0)
    for _ in range(4):
        _feed(collapse, False, heat, 1, 64, 0.70)
        _feed(collapse, True, heat, 1, 64, 1.00)
    bc = collapse.breach()
    if bc is None or "cfg-poison" not in bc.get("suspects", []):
        errors.append("guard BLIND to constant-deny on a high-baseline-"
                      f"deny config (allow collapse): {bc}")

    # changed-set restriction: cohort selection bias on an UNCHANGED
    # config (the cohorts sample different fixed request subsets) must
    # not breach when the guard knows what the reconcile touched
    biased = CanaryGuard(check_interval_s=0.0, changed={"cfg-poison"})
    for _ in range(8):  # bulk balanced traffic on the changed config
        _feed(biased, False, heat, 1, 64, 0.10)
        _feed(biased, True, heat, 1, 64, 0.10)
    _feed(biased, False, heat, 0, 64, 0.10)
    _feed(biased, True, heat, 0, 64, 0.90)  # unchanged + cohort-biased
    if biased.breach() is not None:
        errors.append("guard breached on an UNCHANGED config (the changed-"
                      "set restriction is not applied): "
                      f"{biased.breach()}")

    # determinism of the cohort hash: same doc, same cohort, always
    doc = {"request": {"host": "h", "path": "/a", "method": "GET"}}
    if cohort_bucket(doc) != cohort_bucket(dict(doc)):
        errors.append("cohort hash is not deterministic over equal docs")
    if in_canary_cohort(doc, 1.0) is not True or \
            in_canary_cohort(doc, 0.0) is not False:
        errors.append("cohort fraction bounds broken (0.0 must exclude, "
                      "1.0 must include)")
    return errors
