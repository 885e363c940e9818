"""Decision provenance: which-rule-fired attribution, the runtime rule heat
map, and the head-sampled decision log.

The mega-kernel's [B, W] readback ships per-rule result/skip columns beside
every verdict.  Here they become:

- **attribution**: the first evaluator column that evaluated false and was
  not condition-skipped is *the* rule that denied the request
  (``ops.operands.firing_columns`` — the reference pipeline's
  short-circuit order).  The engine decodes it per BATCH over the final
  columns, so the fan-out paths (within-batch dedup, verdict-cache hits,
  host-oracle fallback rows) attribute identically: they all reproduce
  the same (rule, skipped) columns;
- **rule heat map**: ``auth_server_rule_fired_total{authconfig,rule}``,
  folded per batch into a composite (config row, firing column) count
  array — one vectorized ``np.add.at`` per batch, whatever its size.  The
  never-fired set is the dead-rule report on ``debug_vars()``;
- **decision log**: a bounded ring of head-sampled structured decision
  records (host, authconfig, verdict, firing rule, lane, latency, snapshot
  generation).  Sampling is 1-in-N decisions per authconfig, at most one
  record per authconfig per batch.

The heat map's own counts, ``to_json`` and the dead-rule report do not
depend on ``prometheus_client``; without it the rule-fired and
decision-record families are no-ops.

Privacy: rule SOURCE strings reach clients (X-Ext-Auth-Reason) only behind
``--expose-deny-reason`` (module flag ``EXPOSE_DENY_REASON``); Envoy
``dynamic_metadata`` provenance and the operator surfaces (metrics,
``debug_vars()``) always carry them — they are mesh-internal."""

from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..utils import metrics as metrics_mod

__all__ = ["EXPOSE_DENY_REASON", "RULE_LABEL_MAX", "HeatMap", "DecisionLog",
           "DECISIONS", "DecisionSchemaError", "check_decision_schema",
           "rule_label", "deny_provenance", "deny_reason",
           "dead_rule_report", "fired_pairs", "fold_and_sample",
           "flush_heatmaps"]

# --expose-deny-reason: when False (default), deny responses keep the
# generic "Unauthorized" reason and attribution rides only dynamic_metadata
# + operator surfaces.  Set by the CLI; module-level so the evaluator seam
# (evaluators/authorization/pattern_matching.py) needs no plumbing.
EXPOSE_DENY_REASON = False

# rule-source label truncation: heat-map label values must stay bounded
# (Prometheus label cardinality is per distinct VALUE, and sources are
# operator-authored — truncation only shortens, never merges rules, because
# the evaluator index prefixes the label)
RULE_LABEL_MAX = 120


def rule_label(col: int, source: str) -> str:
    src = source if len(source) <= RULE_LABEL_MAX else \
        source[:RULE_LABEL_MAX - 1] + "…"
    return f"{col}:{src}"


# process-wide fired set, merged across lanes and snapshot generations:
# (authconfig, evaluator column) pairs that have attributed at least one
# denial since process start.  The dead-rule report subtracts it from the
# serving snapshot's registered rules.
_FIRED: set = set()
_FIRED_LOCK = threading.Lock()


def fired_pairs() -> set:
    with _FIRED_LOCK:
        return set(_FIRED)


def _reset_fired_for_tests() -> None:
    with _FIRED_LOCK:
        _FIRED.clear()


# live heat maps, flushed at Prometheus scrape time by _FlushCollector (so
# rule-fired counters are current on every scrape even when traffic — and
# with it the amortized in-fold flush — has stopped)
_LIVE_HEATMAPS: "weakref.WeakSet" = weakref.WeakSet()


def flush_heatmaps() -> None:
    """Flush every live heat map's accumulated deltas into their Prometheus
    children.  A metrics handler calls this BEFORE exposition:
    collector iteration order puts the registered _FlushCollector after the
    counter families, so relying on it alone would lag the rule-fired
    series by one scrape once traffic (and the in-fold flush) stops."""
    for heat in list(_LIVE_HEATMAPS):
        try:
            heat.flush()
        except Exception:
            pass


class _FlushCollector:
    """Zero-series collector whose collect() flushes every live heat map —
    registering it ties scrape time to flush time for registry consumers
    that bypass the HTTP handler (one-scrape lag at worst)."""

    def collect(self):
        flush_heatmaps()
        return []


try:
    from prometheus_client import REGISTRY as _PROM_REGISTRY

    _PROM_REGISTRY.register(_FlushCollector())
except Exception:  # prometheus_client is optional: its absence is no fault
    pass


class HeatMap:
    """Per-snapshot attribution folder: kernel config rows → (authconfig
    name, per-evaluator rule sources), with cached Prometheus label
    children per (row, firing column).

    ``fold(rows, firing)`` is the one entry point, called once per
    batch: rows/firing are int arrays; the composite-key bincount keeps the
    Python work bounded by distinct (config, rule) pairs."""

    # Prometheus flush cadence: fold() accumulates into a plain int64 array
    # (one vectorized np.add.at per batch — Python work is O(1) per batch);
    # the per-(config,rule) counter children only see the accumulated
    # deltas every FLUSH_S seconds, on a debug read, or at scrape time
    # (the registered _FlushCollector).  Counters may lag a flush period;
    # they never lose counts.
    FLUSH_S = 2.0

    def __init__(self, names_by_row: Sequence[str],
                 sources_by_row: Sequence[Sequence[str]], n_evaluators: int,
                 configs_per_shard: Optional[int] = None):
        self.names_by_row = list(names_by_row)
        self.sources_by_row = [list(s) for s in sources_by_row]
        self.E = int(n_evaluators)
        # mesh corpora: rows arrive (shard, row) and flatten as
        # shard * configs_per_shard + row; None = single corpus
        self.configs_per_shard = configs_per_shard
        self._children: Dict[int, Any] = {}   # composite key -> counter child
        self._lock = threading.Lock()
        n_keys = max(1, len(self.names_by_row)) * (self.E + 1)
        self._counts = np.zeros(n_keys, dtype=np.int64)
        self._flushed = np.zeros(n_keys, dtype=np.int64)
        self._last_flush = time.monotonic()
        self.fold_calls = 0       # per-batch evidence for the perf guard
        self.fold_seconds = 0.0   # cumulative fold cost (bench overhead delta)
        _LIVE_HEATMAPS.add(self)

    # -- construction ------------------------------------------------------

    @classmethod
    def from_policy(cls, policy) -> "HeatMap":
        names = [""] * policy.n_configs
        for name, row in policy.config_ids.items():
            names[row] = name
        return cls(names, policy.rule_sources(),
                   int(policy.eval_rule.shape[1]))

    @classmethod
    def from_sharded(cls, sharded) -> "HeatMap":
        """Mesh corpora: rows flatten as shard * G + row."""
        G = sharded.configs_per_shard
        names = [""] * (sharded.n_shards * G)
        sources: List[List[str]] = [[] for _ in range(sharded.n_shards * G)]
        for s, pol in enumerate(sharded.shards):
            srcs = pol.rule_sources()
            for name, row in pol.config_ids.items():
                names[s * G + row] = name
                sources[s * G + row] = srcs[row]
        return cls(names, sources, int(sharded.shards[0].eval_rule.shape[1]),
                   configs_per_shard=G)

    @classmethod
    def for_snapshot(cls, policy=None, sharded=None) -> "Optional[HeatMap]":
        """The heat map of one snapshot's compiled corpus, single or
        mesh-sharded (None: the snapshot compiled nothing, as the
        bootstrap deny-all)."""
        if sharded is not None:
            return cls.from_sharded(sharded)
        if policy is not None:
            return cls.from_policy(policy)
        return None

    # -- folding -----------------------------------------------------------

    def fold(self, rows, firing, shards=None) -> None:
        """Fold one batch's attribution into the heat map: ONE vectorized
        np.add.at into the composite-key count array — Python work is O(1)
        per batch, independent of batch size AND of the number of distinct
        rules.  Prometheus children are refreshed by flush() (amortized
        here on the FLUSH_S cadence, and forced by scrapes/debug reads).

        fold_seconds meters THREAD CPU time, not wall: on a saturated box
        the encode-pool thread gets preempted mid-fold, and a wall meter
        would bill those descheduled gaps to the fold (observed ~100x
        inflation on the CPU-only bench image, where the 'device' kernel
        competes for the same cores)."""
        t0 = time.thread_time()
        rows = np.asarray(rows, dtype=np.int64)
        firing = np.asarray(firing, dtype=np.int64)
        if shards is not None and self.configs_per_shard:
            rows = np.asarray(shards, dtype=np.int64) * \
                self.configs_per_shard + rows
        self.fold_calls += 1
        denied = firing >= 0
        if denied.any():
            comp = rows[denied] * (self.E + 1) + firing[denied]
            with self._lock:
                np.add.at(self._counts, comp, 1)
        if time.monotonic() - self._last_flush > self.FLUSH_S:
            self._flush_locked_free()
        self.fold_seconds += time.thread_time() - t0

    def flush(self) -> None:
        """Push accumulated deltas into the per-(config,rule) Prometheus
        children and the process-wide fired set.  Cost is bounded by the
        number of distinct pairs that moved since the last flush — paid on
        the flush cadence / scrape, never per batch."""
        self._flush_locked_free()

    def _flush_locked_free(self) -> None:
        with self._lock:
            delta = self._counts - self._flushed
            moved = np.nonzero(delta)[0]
            if moved.size == 0:
                self._last_flush = time.monotonic()
                return
            np.copyto(self._flushed, self._counts)
            self._last_flush = time.monotonic()
            amounts = delta[moved]
        for key, n in zip(moved, amounts):
            self._bump(int(key), int(n))

    def _bump(self, comp_key: int, n: int) -> None:
        child = self._children.get(comp_key)
        if child is None:
            row, col = divmod(comp_key, self.E + 1)
            if row >= len(self.names_by_row):
                return  # padded/unknown row: nothing to attribute
            name = self.names_by_row[row]
            sources = self.sources_by_row[row] if row < len(
                self.sources_by_row) else []
            src = sources[col] if col < len(sources) else "<padded>"
            with self._lock:
                child = self._children.get(comp_key)
                if child is None:
                    child = metrics_mod.rule_fired.labels(
                        name, rule_label(col, src))
                    self._children[comp_key] = child
            with _FIRED_LOCK:
                _FIRED.add((name, col))
        child.inc(n)

    # -- attribution lookups ----------------------------------------------

    def source(self, row: int, col: int, shard: Optional[int] = None) -> str:
        if shard is not None and self.configs_per_shard:
            row = shard * self.configs_per_shard + row
        sources = self.sources_by_row[row] if 0 <= row < len(
            self.sources_by_row) else []
        return sources[col] if 0 <= col < len(sources) else ""

    def name(self, row: int, shard: Optional[int] = None) -> str:
        if shard is not None and self.configs_per_shard:
            row = shard * self.configs_per_shard + row
        return self.names_by_row[row] if 0 <= row < len(
            self.names_by_row) else ""

    # -- reporting ---------------------------------------------------------

    def registered_rules(self):
        """Every real (authconfig, column, source) rule in this snapshot."""
        for row, sources in enumerate(self.sources_by_row):
            name = self.names_by_row[row]
            if not name:
                continue  # padded config row
            for col, src in enumerate(sources):
                yield name, col, src

    def to_json(self) -> Dict[str, Any]:
        self.flush()
        return {
            "configs": sum(1 for n in self.names_by_row if n),
            "rules": sum(len(s) for r, s in enumerate(self.sources_by_row)
                         if self.names_by_row[r]),
            "fold_calls": self.fold_calls,
            "fold_seconds": round(self.fold_seconds, 6),
        }


def dead_rule_report(heat: Optional[HeatMap],
                     analysis: Optional[Dict[str, Any]],
                     limit: int = 100) -> Optional[Dict[str, Any]]:
    """Cross-reference the heat map's never-fired set against the static
    policy-analysis findings: a rule that static analysis already
    called constant-allow CANNOT fire (it never denies) — expected-dead;
    a never-fired rule with no static explanation is runtime-dead policy
    surface worth pruning.  ``analysis`` is None until the port has the
    static analysis (every never-fired rule is then unexplained).
    ``debug_vars()["provenance"]["dead_rules"]``."""
    if heat is None:
        return None
    heat.flush()  # the fired set must reflect every folded batch
    # keyed (config, evaluator index): a constant-allow finding on
    # evaluator 0 must not "explain" evaluator 1's silence — per-config
    # keying would mark live-but-quiet rules as safe to prune
    static_by_rule: Dict[Any, List[str]] = {}
    for f in (analysis or {}).get("findings", []):
        kind = f.get("kind", "")
        if kind in ("constant-allow", "shadowed-rule", "duplicate-rule"):
            d = f.get("detail") or {}
            cfg = str(d.get("config", ""))
            ev = d.get("evaluator")
            key = (cfg, int(ev)) if ev is not None else cfg
            static_by_rule.setdefault(key, []).append(kind)
    fired = fired_pairs()
    never: List[Dict[str, Any]] = []
    total = fired_n = 0
    for name, col, src in heat.registered_rules():
        total += 1
        if (name, col) in fired:
            fired_n += 1
            continue
        if len(never) < limit:
            never.append({
                "authconfig": name,
                "rule": rule_label(col, src),
                # evaluator-keyed findings first; config-wide ones (no
                # evaluator in the finding detail) apply to every column
                "static_findings": (static_by_rule.get((name, col), []) +
                                    static_by_rule.get(name, [])),
            })
    return {
        "rules_total": total,
        "rules_fired": fired_n,
        "never_fired_count": total - fired_n,
        "never_fired": never,
        "statically_explained": sum(1 for d in never if d["static_findings"]),
    }


# ---------------------------------------------------------------------------
# decision log: bounded ring of head-sampled structured decision records
# ---------------------------------------------------------------------------

# pinned record schema (tests/test_torch_provenance.py): every record
# carries exactly these keys, so downstream log pipelines can rely on the
# shape.  Each RECORD is stamped with the schema it was written under — a
# saved decision-log JSON names its own version, so offline readers reject
# skew with the typed DecisionSchemaError instead of misparsing.
DECISION_SCHEMA = 2
DECISION_FIELDS = ("schema", "t", "lane", "host", "authconfig", "verdict",
                   "rule", "rule_index", "latency_ms", "generation")


class DecisionSchemaError(ValueError):
    """A decision-log payload was written under a different schema version
    than this reader understands.  Typed so offline tooling fails loudly
    instead of misparsing."""


def check_decision_schema(payload: Any) -> None:
    """Raise :class:`DecisionSchemaError` when ``payload`` (a
    ``DecisionLog.to_json``-shaped dict) names a schema this reader does not
    speak.  A payload without a schema field predates versioning and is
    rejected too — silence is exactly the misparse this gate exists to
    stop."""
    got = payload.get("schema") if isinstance(payload, dict) else None
    if got != DECISION_SCHEMA:
        raise DecisionSchemaError(
            f"decision-log schema skew: payload schema {got!r} != reader "
            f"schema {DECISION_SCHEMA} (refusing to misparse; re-save the "
            f"log with a matching build)")


class DecisionLog:
    """Head-sampled decision ring, sampled STRATIFIED per tenant (the
    authconfig).  One global 1-in-N counter would let a zipf-hot tenant's
    batches win essentially every fire and its records evict every
    cold-tenant record from the bounded ring.  So:

    - ``should_sample_tenant(tenant, n)`` keeps an independent 1-in-N
      counter PER tenant (bounded LRU table), and ``fold_and_sample``
      fires it once per distinct tenant in the batch — at most one record
      per tenant per batch, Python work bounded by distinct tenants (the
      same composite-key discipline as the heat-map fold);
    - alongside the global ring, each tenant keeps a small per-tenant
      sub-ring (``tenant_capacity`` newest records, LRU-bounded tenants),
      so a hot tenant filling the global ring can never evict a cold
      tenant's last records — ``to_json(tenant=NAME)`` serves them.

    ``should_sample(n)`` (the legacy global gate) remains for callers with
    no tenant axis."""

    MAX_TENANTS = 512

    def __init__(self, capacity: int = 1024, sample_n: int = 64,
                 tenant_capacity: int = 4):
        self.capacity = max(1, int(capacity))
        self.sample_n = max(1, int(sample_n))
        self.tenant_capacity = max(1, int(tenant_capacity))
        self._ring: deque = deque(maxlen=self.capacity)
        # guards ring append vs snapshot: completions record concurrently
        # while a reader lists the ring, and iterating a deque
        # that another thread appends to raises RuntimeError
        self._lock = threading.Lock()
        self._seen = 0
        self._next_fire = 1  # first decision samples (head of the stream)
        # tenant -> [seen, next_fire]; insertion order is the LRU axis
        self._tenant_gate: Dict[str, list] = {}
        # tenant -> deque(maxlen=tenant_capacity) of its newest records
        self._tenant_ring: Dict[str, deque] = {}
        self.records_total = 0

    def configure(self, capacity: Optional[int] = None,
                  sample_n: Optional[int] = None) -> None:
        if capacity is not None and int(capacity) != self.capacity:
            self.capacity = max(1, int(capacity))
            with self._lock:
                self._ring = deque(self._ring, maxlen=self.capacity)
        if sample_n is not None:
            self.sample_n = max(1, int(sample_n))
            # re-arm from here: a tighter rate must not wait out the fire
            # point the old (possibly much larger) rate scheduled
            self._next_fire = self._seen + self.sample_n
            with self._lock:
                self._tenant_gate.clear()

    def should_sample(self, n_decisions: int) -> bool:
        """Advance the decision counter by this batch's size; True when the
        1-in-N sampler fires inside the batch — at most one record per
        batch, O(1) per batch (a racing add under free threading can only
        lose a sample, never add per-request work)."""
        if n_decisions <= 0:
            return False
        seen = self._seen = self._seen + n_decisions
        if seen >= self._next_fire:
            self._next_fire = seen + self.sample_n
            return True
        return False

    def should_sample_tenant(self, tenant: str, n_decisions: int) -> bool:
        """The stratified gate: this TENANT's own 1-in-N counter, advanced
        by its decision count within the batch.  The first decision a
        tenant ever shows always samples (cold tenants become visible on
        their first batch, not after N of them)."""
        if n_decisions <= 0:
            return False
        gate = self._tenant_gate.get(tenant)
        if gate is None:
            if len(self._tenant_gate) >= self.MAX_TENANTS:
                with self._lock:
                    # LRU-ish bound: drop the oldest-inserted third
                    for t in list(self._tenant_gate)[:self.MAX_TENANTS // 3]:
                        self._tenant_gate.pop(t, None)
            gate = self._tenant_gate[tenant] = [0, 1]
        gate[0] += n_decisions
        if gate[0] >= gate[1]:
            gate[1] = gate[0] + self.sample_n
            return True
        return False

    def record(self, lane: str, host: str, authconfig: str, verdict: bool,
               rule: Optional[str], rule_index: int, latency_ms: float,
               generation: Any) -> None:
        rec = {
            "schema": DECISION_SCHEMA,
            "t": time.time(),
            "lane": lane,
            "host": host,
            "authconfig": authconfig,
            "verdict": "allow" if verdict else "deny",
            "rule": rule,
            "rule_index": rule_index,
            "latency_ms": round(float(latency_ms), 3),
            "generation": generation,
        }
        with self._lock:
            self._ring.append(rec)
            self.records_total += 1
            if authconfig:
                sub = self._tenant_ring.get(authconfig)
                if sub is None:
                    if len(self._tenant_ring) >= self.MAX_TENANTS:
                        for t in list(self._tenant_ring)[
                                :self.MAX_TENANTS // 3]:
                            self._tenant_ring.pop(t, None)
                    sub = self._tenant_ring[authconfig] = deque(
                        maxlen=self.tenant_capacity)
                sub.append(rec)
        metrics_mod.decision_records.labels(lane).inc()

    def to_json(self, n: Optional[int] = None,
                tenant: Optional[str] = None) -> Dict[str, Any]:
        with self._lock:
            if tenant is not None:
                records = list(self._tenant_ring.get(tenant, ()))
            else:
                records = list(self._ring)
            tenants_tracked = len(self._tenant_ring)
        if n is not None:
            n = max(0, int(n))
            records = records[-n:] if n else []
        out = {
            "schema": DECISION_SCHEMA,
            "capacity": self.capacity,
            "sample_n": self.sample_n,
            "records_total": self.records_total,
            "records": records,
            "stratified": {
                "tenants_tracked": tenants_tracked,
                "per_tenant_capacity": self.tenant_capacity,
            },
        }
        if tenant is not None:
            out["tenant"] = tenant
        return out


# one ring per process: every engine samples into it
DECISIONS = DecisionLog()


def fold_and_sample(heat: HeatMap, rows, firing, n: int, *, lane: str,
                    host: str = "", latency_ms: float = 0.0,
                    generation: Any = None, host_of=None,
                    latency_of=None) -> None:
    """The one per-batch observability sequence every lane's completion
    runs: fold the batch's attribution into the heat map, then sample
    decision records STRATIFIED per tenant — at most one record per
    distinct tenant (authconfig) per batch, each tenant gated by its own
    1-in-N counter, so a zipf-hot tenant can neither win every sample nor
    evict the cold tenants' records.  Python work is
    bounded by distinct tenants in the batch, never the batch size.
    Keeping it here means a schema or sampling change lands once, not once
    per lane."""
    heat.fold(rows, firing)
    if not n:
        return
    rows_a = np.asarray(rows, dtype=np.int64)
    uniq, first, counts = np.unique(rows_a, return_index=True,
                                    return_counts=True)
    for u, i, k in zip(uniq, first, counts):
        name = heat.name(int(u))
        if not DECISIONS.should_sample_tenant(name, int(k)):
            continue
        i = int(i)
        col = int(firing[i])
        row_i = int(rows_a[i])
        # per-record resolvers (``host_of``/``latency_of``, called only
        # for SAMPLED tenants): each tenant's record carries ITS OWN
        # request's host/latency — the batch head's values belong to a
        # different tenant in a mixed batch, which is exactly the wrong
        # evidence in the per-tenant sub-rings
        DECISIONS.record(
            lane=lane,
            host=(host_of(i) if host_of is not None else host),
            authconfig=name,
            verdict=col < 0,
            rule=(rule_label(col, heat.source(row_i, col))
                  if col >= 0 else None),
            rule_index=col,
            latency_ms=(latency_of(i) if latency_of is not None
                        else latency_ms),
            generation=generation)


# ---------------------------------------------------------------------------
# deny-response attribution (the X-Ext-Auth-Reason / dynamic_metadata seam)
# ---------------------------------------------------------------------------


def deny_provenance(authconfig: str, rule_index: int, source: str,
                    lane: str = "engine") -> Dict[str, Any]:
    """The JSON-safe provenance object a denied response carries in Envoy
    dynamic_metadata (always) and X-Ext-Auth-Reason (knob-gated)."""
    return {
        "authconfig": authconfig,
        "rule_index": int(rule_index),
        "rule": source,
        "lane": lane,
    }


def deny_reason(prov: Optional[Dict[str, Any]]) -> str:
    """The deny message: attributed behind --expose-deny-reason, the
    reference's generic 'Unauthorized' otherwise."""
    if prov and EXPOSE_DENY_REASON:
        return (f"denied by {prov['authconfig']} "
                f"rule[{prov['rule_index']}]: {prov['rule']}")
    return "Unauthorized"
