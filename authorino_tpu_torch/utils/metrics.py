"""Prometheus metrics — the reference's metric names, types, labels and
buckets (ref: pkg/service/auth_pipeline.go:26-36, pkg/metrics/metrics.go):
the auth pipeline's families, and those of the planes the port holds (the
serving core, provenance, the per-batch and stage telemetry, the reconcile
phases, the compile cache and the delta upload, the SLO tracker, the
flight recorder, the kernel cost ledger and the kernel lanes, the circuit
breaker, the degrade and the fault plane, the reconcile's verification
planes, the relation tables, the metadata prefetch cache, traffic capture
and the replay pregate, the host fallback).
The families of planes not in the port yet come with them.

Per-evaluator (deep) metrics are gated by the evaluator's ``metrics: true``
flag or the global DEEP_METRICS_ENABLED (ref: pkg/metrics/metrics.go:86-96,
main.go:182); the aggregate per-AuthConfig metrics are always recorded.

Without ``prometheus_client`` every metric is a no-op.  With it, each name
is registered once in the default registry: a second registration of the
same name (a module re-import, or another package of this process that
records the same series) resolves to the collector already there, so both
record into one series."""

from __future__ import annotations

import contextlib
import logging
import math

import numpy as np

try:
    from prometheus_client import REGISTRY, Counter, Gauge, Histogram

    _PROM = True
except ImportError:
    _PROM = False

DEEP_METRICS_ENABLED = False

_EVAL_LABELS = ("namespace", "authconfig", "evaluator_type", "evaluator_name")
_CONF_LABELS = ("namespace", "authconfig")


class _NoopMetric:
    def labels(self, *a, **k):
        return self

    def inc(self, *a):
        pass

    def observe(self, *a):
        pass

    def set(self, *a):
        pass

    def time(self):
        return contextlib.nullcontext()


def _existing_collector(name):
    """The already-registered collector for ``name``, or None.  A duplicate
    registration raises ValueError; returning a fresh _NoopMetric there
    would silently detach this process's series, so the duplicate resolves
    to the ORIGINAL collector."""
    try:
        by_name = REGISTRY._names_to_collectors
    except AttributeError:  # pragma: no cover - library internals changed
        return None
    for candidate in (name, name + "_total", name + "_count"):
        col = by_name.get(candidate)
        if col is not None:
            return col
    return None


def _register(kind, name, doc, labels, buckets=None):
    """The reference's ``_counter``/``_gauge``/``_histogram`` in one: a
    collector of ``kind`` registered under ``name``, or the one already
    registered under it, which must be of the same kind (a name registered
    twice with two types would record one package's series into the
    other's and garble both)."""
    if not _PROM:
        return _NoopMetric()
    cls = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}[kind]
    kw = {"buckets": buckets} if buckets is not None else {}
    try:
        return cls(name, doc, labels, **kw)
    except ValueError:  # already registered
        col = _existing_collector(name)
        if col is None:
            return _NoopMetric()
        if not isinstance(col, cls):
            raise ValueError(f"metric {name!r} is registered as a "
                             f"{type(col).__name__}, not a {cls.__name__}")
        return col


evaluator_total = _register(
    "counter", "auth_server_evaluator_total",
    "Total number of evaluations of individual authconfig rule performed by the auth server.",
    _EVAL_LABELS,
)
evaluator_cancelled = _register(
    "counter", "auth_server_evaluator_cancelled",
    "Number of evaluations of individual authconfig rule cancelled by the auth server.",
    _EVAL_LABELS,
)
evaluator_ignored = _register(
    "counter", "auth_server_evaluator_ignored",
    "Number of evaluations of individual authconfig rule ignored by the auth server.",
    _EVAL_LABELS,
)
evaluator_denied = _register(
    "counter", "auth_server_evaluator_denied",
    "Number of denials from individual authconfig rule evaluated by the auth server.",
    _EVAL_LABELS,
)
evaluator_duration = _register(
    "histogram", "auth_server_evaluator_duration_seconds",
    "Response latency of individual authconfig rule evaluated by the auth server (in seconds).",
    _EVAL_LABELS,
)
authconfig_total = _register(
    "counter", "auth_server_authconfig_total",
    "Total number of authconfigs enforced by the auth server, partitioned by authconfig.",
    _CONF_LABELS,
)
authconfig_response_status = _register(
    "counter", "auth_server_authconfig_response_status",
    "Response status of authconfigs sent by the auth server, partitioned by authconfig.",
    _CONF_LABELS + ("status",),
)
authconfig_duration = _register(
    "histogram", "auth_server_authconfig_duration_seconds",
    "Response latency of authconfig enforced by the auth server (in seconds).",
    _CONF_LABELS,
)
response_status = _register(
    "counter", "auth_server_response_status",
    "Status of HTTP response sent by the auth server.",
    ("status",),
)


# ---------------------------------------------------------------------------
# the engine's serving core (runtime/engine.py, runtime/admission.py): the
# dispatch window, batch dedup and the verdict cache, admission and
# deadline shedding, retries and the completer watchdog.  Reference names.
# ---------------------------------------------------------------------------

_LANE_LABELS = ("lane",)
OCCUPANCY_BUCKETS = (0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9,
                     0.95, 1.0)

inflight_batches = _register(
    "gauge", "auth_server_inflight_batches",
    "Micro-batches currently in flight on the device (launched, readback "
    "not yet resolved).  The dispatch window bounds this at "
    "max_inflight_batches.",
    _LANE_LABELS,
)
dispatch_queue_depth = _register(
    "gauge", "auth_server_dispatch_queue_depth",
    "Requests queued for the next micro-batch cut (sampled at each "
    "dispatch/completion).",
    _LANE_LABELS,
)
batch_dedup_ratio = _register(
    "histogram", "auth_server_batch_dedup_ratio",
    "Per-micro-batch fraction of rows collapsed before device dispatch "
    "(1 - unique_rows / rows, cache-resolved rows included): 0 = all rows "
    "shipped, 0.9 = the device evaluated one row in ten.",
    _LANE_LABELS, buckets=OCCUPANCY_BUCKETS,
)
verdict_cache_hits = _register(
    "counter", "auth_server_verdict_cache_hits_total",
    "Rows resolved from the snapshot-scoped verdict cache without touching "
    "the device.",
    _LANE_LABELS,
)
verdict_cache_misses = _register(
    "counter", "auth_server_verdict_cache_misses_total",
    "Cache-eligible rows whose verdict was not cached (evaluated on device, "
    "then inserted).",
    _LANE_LABELS,
)
verdict_cache_evictions = _register(
    "counter", "auth_server_verdict_cache_evictions_total",
    "Verdict-cache entries dropped by the LRU bound (raise "
    "verdict_cache_size if this grows at steady state).",
    _LANE_LABELS,
)
batch_retries = _register(
    "counter", "auth_server_batch_retries_total",
    "Failed micro-batches retried once on a fresh device dispatch.",
    _LANE_LABELS,
)
deadline_shed = _register(
    "counter", "auth_server_deadline_shed_total",
    "Requests failed fast (DEADLINE_EXCEEDED) at admission or before "
    "encode because their propagated Check() deadline could not be met "
    "(queue wait + estimated device RTT exceed the time remaining).",
    _LANE_LABELS,
)
watchdog_timeouts = _register(
    "counter", "auth_server_device_watchdog_timeouts_total",
    "In-flight micro-batches abandoned by the completer watchdog because "
    "their readback never arrived within device_timeout_s (counted as "
    "circuit-breaker failures; the batch retries once, then answers "
    "UNAVAILABLE on a card or degrades to the host oracle on the CPU).",
    _LANE_LABELS,
)
# the device circuit breaker, the host-oracle degrade and the fault plane's
# own evidence counter (runtime/breaker.py, runtime/faults.py)
circuit_state = _register(
    "gauge", "auth_server_circuit_state",
    "Device circuit-breaker state per lane: 0 = closed (device serving), "
    "1 = half-open (one probe batch in flight), 2 = open (batches kept "
    "off the device until the cooldown probe succeeds).",
    _LANE_LABELS,
)
circuit_transitions = _register(
    "counter", "auth_server_circuit_transitions_total",
    "Circuit-breaker state transitions per lane (state = the state entered).",
    _LANE_LABELS + ("state",),
)
degraded_decisions = _register(
    "counter", "auth_server_degraded_decisions_total",
    "Requests decided host-side because the device path failed (retry "
    "exhausted) or the circuit breaker was open: an exact re-decision "
    "through the expression oracle (a CPU engine only).",
    _LANE_LABELS,
)
injected_faults = _register(
    "counter", "auth_server_injected_faults_total",
    "Faults fired by the injection plane (runtime/faults.py) — non-zero "
    "only under --fault-profile, chip_smoke.py's failure phase or tests.",
    ("stage", "mode", "lane"),
)
admission_state = _register(
    "gauge", "auth_server_admission_state",
    "Admission-control state per lane: 0 = admitting, 1 = overloaded (the "
    "minimum queue wait stayed above the CoDel target for a full "
    "interval).",
    _LANE_LABELS,
)
admission_rejected = _register(
    "counter", "auth_server_admission_rejected_total",
    "Requests rejected at admission (before queueing, before encode): "
    "queue-full = hard queue cap, overload = wait-targeted effective cap, "
    "doomed-deadline = the propagated deadline lands inside the predicted "
    "queue wait + device RTT (typed DEADLINE_EXCEEDED; the others are "
    "typed RESOURCE_EXHAUSTED).",
    _LANE_LABELS + ("reason",),
)
admission_queue_wait = _register(
    "gauge", "auth_server_admission_queue_wait_ewma_seconds",
    "EWMA of the per-request submit-queue wait the admission controller "
    "tracks.",
    _LANE_LABELS,
)
adaptive_window = _register(
    "gauge", "auth_server_adaptive_window",
    "Live in-flight window chosen by the adaptive controller (Little's "
    "law, clamped to [1, max_inflight_batches]).",
    _LANE_LABELS,
)
adaptive_batch_cut = _register(
    "gauge", "auth_server_adaptive_batch_cut",
    "Live batch-cut target chosen by the adaptive controller (advisory; "
    "clamped to [1, max_batch]).",
    _LANE_LABELS,
)
brownout_decisions = _register(
    "counter", "auth_server_brownout_decisions_total",
    "Requests decided on the exact host lane because the device pipeline "
    "was saturated (window full + standing queue): overload degrades "
    "throughput, never correctness.  Engine lane: the host expression "
    "oracle; native lane: the kernel's plain version on the CPU.  A card "
    "engine has no host lane: it never counts here.",
    _LANE_LABELS,
)
brownout_batches = _register(
    "counter", "auth_server_brownout_batches_total",
    "Micro-batches spilled to the host lane under device-pipeline "
    "saturation (the per-batch companion of "
    "auth_server_brownout_decisions_total).",
    _LANE_LABELS,
)

# ---------------------------------------------------------------------------
# Lane selection: the host twin as a first-class serving lane on a CPU
# engine (per-batch-cut cost-model decisions, speculative dual dispatch
# while the breaker is half-open).  On a card every cut counts
# <lane>-device/disabled.  See runtime/lane_select.py.
# ---------------------------------------------------------------------------

lane_decisions = _register(
    "counter", "auth_server_lane_decisions_total",
    "Batch-cut lane decisions by the cost model (runtime/lane_select.py): "
    "lane = <serving lane>-host / <serving lane>-device, reason = "
    "cost-model (the winning cost estimate), deadline (latency-critical "
    "head rescued host-side), speculative (dual-dispatch twin while the "
    "breaker is half-open), batch (cut too large for the host lane), "
    "host-busy (host concurrency cap), slo-burn (burn bias flipped the "
    "raw cost verdict), explore (periodic device probe keeping the RTT "
    "EWMA fresh during host-only regimes), disabled (off, as on a card).",
    _LANE_LABELS + ("reason",),
)
lane_cost_ewma = _register(
    "gauge", "auth_server_lane_cost_ewma_seconds",
    "Live cost-model EWMAs per lane: host = seconds per host-decided ROW, "
    "device = seconds per device batch round trip.  The decision law "
    "compares host_row x cut_size against device_rtt x (1 + occupancy).",
    _LANE_LABELS + ("which",),
)
speculative_dispatch = _register(
    "counter", "auth_server_speculative_dispatch_total",
    "Speculative dual-dispatch outcomes (breaker half-open): launched = "
    "one batch sent to BOTH lanes, host-win / device-win = which lane "
    "resolved the futures first (the loser's work is ignored — verdicts "
    "are bit-identical by construction), host-fail = the host twin "
    "raised or partially failed (the device half owns the batch), "
    "device-fail = the device half failed while the host half answered "
    "(the probe's breaker verdict).",
    ("outcome",),
)

_dedup_children: dict = {}


def observe_dedup(lane, n_rows, n_device_rows, cache_hits, cache_misses,
                  evictions_delta=0) -> None:
    """Fold one micro-batch's dedup/cache outcome: ``n_device_rows`` of
    ``n_rows`` actually shipped (after cache hits AND within-batch
    collapse).  Cached label children — runs once per micro-batch."""
    ch = _dedup_children.get(lane)
    if ch is None:
        ch = _dedup_children[lane] = (
            batch_dedup_ratio.labels(lane),
            verdict_cache_hits.labels(lane),
            verdict_cache_misses.labels(lane),
            verdict_cache_evictions.labels(lane),
        )
    if n_rows:
        ch[0].observe(1.0 - n_device_rows / n_rows)
    if cache_hits:
        ch[1].inc(cache_hits)
    if cache_misses:
        ch[2].inc(cache_misses)
    if evictions_delta:
        ch[3].inc(evictions_delta)


# ---------------------------------------------------------------------------
# decision provenance (runtime/provenance.py): the rule heat map, folded
# once per micro-batch from the readback's rule columns, and the
# head-sampled decision log.  Reference names.
# ---------------------------------------------------------------------------

rule_fired = _register(
    "counter", "auth_server_rule_fired_total",
    "Denials attributed to one compiled authorization rule (the FIRST "
    "evaluator column that evaluated false and was not condition-skipped — "
    "the same short-circuit order the reference's pipeline denies in).  "
    "rule = '<evaluator idx>:<rule source>' (truncated); folded once per "
    "micro-batch from the readback's rule columns on every lane — device, "
    "cached, deduped, degraded, brownout.  The runtime rule heat map: "
    "never-incremented rules cross-reference the static constant/shadowed "
    "findings in the /debug/vars dead-rule report.",
    ("authconfig", "rule"),
)
decision_records = _register(
    "counter", "auth_server_decision_records_total",
    "Head-sampled structured decision records appended to the bounded "
    "decision log (served on /debug/decisions; one record at most per "
    "micro-batch, sampled 1-in-N decisions).",
    _LANE_LABELS,
)


# ---------------------------------------------------------------------------
# per-batch engine telemetry (runtime/engine.py), recorded ONCE PER
# MICRO-BATCH, never per request: batch size and pad occupancy, the true
# per-request queue waits folded in O(buckets), the launch-to-readback
# wall time, host-oracle fallback rows, and the four pipeline stages.
# Reference names, labels and buckets.
# ---------------------------------------------------------------------------

# µs-scale stage bounds (the reference's native frontend buckets in the
# same bounds, so its drains map 1:1)
STAGE_BUCKETS = (
    10e-6, 25e-6, 50e-6, 100e-6, 250e-6, 500e-6,
    1e-3, 2.5e-3, 5e-3, 10e-3, 25e-3, 50e-3, 100e-3, 250e-3, 1.0,
)
# powers of two: batches pad to pow2 buckets (utils.bucket_pow2), so these
# bounds land exactly on the pad grid
BATCH_SIZE_BUCKETS = tuple(float(1 << i) for i in range(13))  # 1 .. 4096
FALLBACK_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0,
                    512.0, 1024.0)

batch_size = _register(
    "histogram", "auth_server_batch_size",
    "Requests per micro-batch at kernel launch (before padding).",
    _LANE_LABELS, buckets=BATCH_SIZE_BUCKETS,
)
batch_pad_occupancy = _register(
    "histogram", "auth_server_batch_pad_occupancy",
    "Per-batch occupancy of the chosen pad bucket (device rows / pad): "
    "1.0 = a full bucket, low values = pad waste (device cycles spent on "
    "discarded rows).",
    _LANE_LABELS, buckets=OCCUPANCY_BUCKETS,
)
batch_queue_wait = _register(
    "histogram", "auth_server_batch_queue_wait_seconds",
    "Per-request queue wait (enqueue to dispatch cut), engine lane only — "
    "every member's wait is folded per batch (bucketed, O(buckets)/batch).",
    _LANE_LABELS, buckets=STAGE_BUCKETS,
)
device_dispatch_duration = _register(
    "histogram", "auth_server_device_dispatch_seconds",
    "Wall time of one kernel launch: operand upload + device execute + "
    "verdict readback.",
    _LANE_LABELS, buckets=STAGE_BUCKETS,
)
batch_host_fallback = _register(
    "histogram", "auth_server_batch_host_fallback",
    "Host-oracle fallback requests (membership overflow) per micro-batch.",
    _LANE_LABELS, buckets=FALLBACK_BUCKETS,
)
snapshot_generation = _register(
    "gauge", "auth_server_snapshot_generation",
    "Monotonic generation of the serving snapshot, per component (engine = "
    "compiled-corpus swaps via apply_snapshot).",
    ("component",),
)
pipeline_stage_duration = _register(
    "histogram", "auth_server_pipeline_stage_seconds",
    "Per-batch wall time of each dispatch pipeline stage: encode = host "
    "encode/pack + cache lookup and dedup; launch = the non-blocking "
    "kernel dispatch call (staging buffer H2D enqueue + launch + D2H "
    "enqueue); device = launch to readback arrival (copies + kernel); "
    "resolve = readback to future resolution.",
    _LANE_LABELS + ("stage",), buckets=STAGE_BUCKETS,
)
reconcile_phase = _register(
    "histogram", "auth_server_reconcile_phase_seconds",
    "Per-phase reconcile timing on the engine lane: compile (incremental "
    "corpus compile through the per-config artifact cache), diff (the new "
    "host operand view with the per-config kernel program, and the delta "
    "plan against the old one), upload (H2D staging — delta rows or full "
    "re-stage — and the probe launch).  The sum is what a reconcile costs "
    "the control plane.",
    ("phase",),
    buckets=(.0005, .002, .01, .05, .1, .25, .5, 1.0, 2.5, 5.0, 10.0),
)
compile_cache_events = _register(
    "counter", "auth_server_compile_cache_events_total",
    "Per-config compile-cache outcomes per reconcile: hit = the config's "
    "source fingerprint matched a cached artifact (no re-lowering, no "
    "re-determinization), miss = the config was actually compiled.  An "
    "unchanged corpus is all hits; changing one config is exactly one "
    "miss.",
    ("outcome",),
)
delta_upload_bytes = _register(
    "counter", "auth_server_delta_upload_bytes_total",
    "Operand bytes actually shipped to the device per reconcile upload "
    "(changed rows + their indices on the delta path; whole tensors on a "
    "full re-stage).  Compare against auth_server_full_upload_bytes_total "
    "for the avoided traffic.",
    ("lane",),
)
full_upload_bytes = _register(
    "counter", "auth_server_full_upload_bytes_total",
    "Operand bytes a FULL re-stage of each reconciled snapshot would have "
    "shipped (the delta baseline).",
    ("lane",),
)

# ---------------------------------------------------------------------------
# The native gRPC frontend (runtime/native_frontend.py): its on-box stage
# histogram and the C++ fe_stats() counters, drained as deltas into one
# labelled counter family (no per-request Python work).
# ---------------------------------------------------------------------------

frontend_stage_duration = _register(
    "histogram", "auth_server_frontend_stage_duration_seconds",
    "On-box per-request stage latency of the native frontend (queue-wait: "
    "encode to batch flush; execute: flush to verdict; respond: verdict to "
    "HTTP/2 submit).",
    ("stage",), buckets=STAGE_BUCKETS,
)

# fe_stats() keys that are live backlog gauges, not monotonic counters
NATIVE_QUEUE_KEYS = ("slow_pending", "slow_queued")
# the port's further backlog (the work its stop() drain waits out): flushed
# batches not completed, the filling batch's rows, answers not yet handed
# to the epoll thread.  Read by the drain, not exported.
NATIVE_BACKLOG_KEYS = ("batches_pending", "filling", "done_queued")

# event keys whose labelled series exist on /metrics before they first move:
# the C++ verified-credential cache's dyn_* counters and the verdict-cache
# traffic the frontend folds into the same drain
NATIVE_ENSURE_KEYS = ("dyn_hit", "dyn_miss", "dyn_add",
                      "vdict_hit", "vdict_miss", "vdict_add", "vdict_evict")

native_frontend_events = _register(
    "counter", "auth_server_native_frontend_events_total",
    "Native (C++) frontend event counters drained from fe_stats(): "
    "fast/slow lane decisions, shed work, credential-cache traffic, "
    "trace sampling, parse errors.",
    ("event",),
)
native_frontend_queue_depth = _register(
    "gauge", "auth_server_native_frontend_queue_depth",
    "Live backlog of the native frontend's slow lane (queued = awaiting "
    "Python pickup, pending = in the pipeline).",
    ("queue",),
)


class NativeStatsDrain:
    """Folds successive fe_stats() snapshots into Prometheus as deltas.
    Single-owner: one thread folds a given instance at a time (the
    frontend serializes its callers under a lock)."""

    def __init__(self):
        self._last: dict = {}
        self._children: dict = {}

    def fold(self, stats) -> None:
        if not stats:
            return
        for key in NATIVE_ENSURE_KEYS:
            if key not in self._children:
                self._children[key] = native_frontend_events.labels(key)
        for key, value in stats.items():
            if key in NATIVE_BACKLOG_KEYS:
                continue
            if key in NATIVE_QUEUE_KEYS:
                child = self._children.get(key)
                if child is None:
                    child = self._children[key] = (
                        native_frontend_queue_depth.labels(key))
                child.set(value)
                continue
            delta = value - self._last.get(key, 0)
            if delta > 0:
                child = self._children.get(key)
                if child is None:
                    child = self._children[key] = (
                        native_frontend_events.labels(key))
                child.inc(delta)
            self._last[key] = value


_bucketed_fallback_warned = False


def observe_bucketed(hist_child, bucket_counts, sum_seconds) -> None:
    """Fold pre-bucketed counts (non-cumulative per-le, same bounds as the
    histogram) into a prometheus_client Histogram child in O(buckets):
    per-request observe() calls would put Python back on the per-request
    path.  Uses the histogram's ``_buckets``/``_sum`` internals, probed
    here so a library change degrades loudly; the fallback keeps the
    distribution's shape by spreading observes across each bucket's
    midpoint, shifted to match the drained sum."""
    try:
        # resolve EVERY internal before mutating anything: a partial apply
        # followed by the fallback would double-count the distribution
        bucket_incs = [b.inc for b in hist_child._buckets]
        sum_inc = hist_child._sum.inc
    except (AttributeError, TypeError):
        bucket_incs = None
    if bucket_incs is not None:
        for i, n in enumerate(bucket_counts):
            if n:
                bucket_incs[i](n)
        if sum_seconds:
            sum_inc(sum_seconds)
        return
    global _bucketed_fallback_warned
    if not _bucketed_fallback_warned:
        _bucketed_fallback_warned = True
        logging.getLogger(__name__).warning(
            "prometheus_client histogram internals changed "
            "(_buckets/_sum missing) — falling back to per-bucket midpoint "
            "observes for bucketed folds")
    if not hasattr(hist_child, "observe"):
        return
    bounds = list(getattr(hist_child, "_upper_bounds", ()))[:len(bucket_counts)]
    total = sum(bucket_counts)
    if not total:
        return
    if not bounds:
        hist_child.observe(sum_seconds / total)
        return
    # a huge backlog must not stall the caller for seconds: counts above
    # the cap are thinned proportionally (logged)
    cap = 200_000
    scale = 1.0
    if total > cap:
        scale = cap / total
        logging.getLogger(__name__).warning(
            "histogram fallback fold thinned %d observations to %d",
            total, cap)
    counts: list = []
    values: list = []
    lo = 0.0
    for i, n in enumerate(bucket_counts):
        hi = bounds[i] if i < len(bounds) else float("inf")
        if hi == float("inf"):
            # strictly above the last finite bound, else observe() bins
            # these overflow counts into the last finite bucket (le is <=)
            v = math.nextafter(lo, math.inf)
        else:
            v = (lo + hi) / 2.0
        if n:
            counts.append((int(round(n * scale)), len(values)))
            values.append((v, lo, hi))
        if hi != float("inf"):
            lo = hi
    # match the folded sum by shifting values inside their buckets, from
    # the top bucket down (the +Inf bucket is unbounded above)
    residual = sum_seconds * scale - sum(n * values[j][0] for n, j in counts)
    for n, j in reversed(counts):
        if not n or abs(residual) <= 1e-12:
            continue
        v, b_lo, b_hi = values[j]
        want = v + residual / n
        got = max(want, math.nextafter(b_lo, math.inf))
        if b_hi != float("inf"):
            got = min(got, b_hi)
        values[j] = (got, b_lo, b_hi)
        residual -= (got - v) * n
    for n, j in counts:
        v = values[j][0]
        for _ in range(n):
            hist_child.observe(v)


_batch_children: dict = {}
_stage_children: dict = {}


def observe_pipeline_stage(lane, stage, seconds) -> None:
    """Record one pipeline-stage wall-time sample (cached label children:
    this runs up to four times per micro-batch)."""
    ch = _stage_children.get((lane, stage))
    if ch is None:
        ch = _stage_children[(lane, stage)] = (
            pipeline_stage_duration.labels(lane, stage))
    ch.observe(seconds)


def fold_queue_waits(lane, waits) -> None:
    """Fold TRUE per-request queue waits (seconds, array-like) into the
    batch_queue_wait histogram in O(buckets) via observe_bucketed."""
    waits = np.asarray(waits, dtype=np.float64)
    if waits.size == 0:
        return
    ch = _ensure_batch_children(lane)
    edges = [0.0] + list(STAGE_BUCKETS) + [np.inf]
    counts, _ = np.histogram(np.clip(waits, 0.0, None), bins=edges)
    observe_bucketed(ch[2], counts.tolist(), float(waits.sum()))


def _ensure_batch_children(lane):
    ch = _batch_children.get(lane)
    if ch is None:
        ch = _batch_children[lane] = (
            batch_size.labels(lane),
            batch_pad_occupancy.labels(lane),
            batch_queue_wait.labels(lane),
            device_dispatch_duration.labels(lane),
            batch_host_fallback.labels(lane),
        )
    return ch


def observe_batch(lane, n, pad, queue_wait_s, dispatch_s,
                  fallback_n=None, device_rows=None) -> None:
    """Record one batch's telemetry (size, pad occupancy, queue wait,
    dispatch wall time, host-fallback rows).  ``queue_wait_s`` may be a
    scalar (one representative wait) or an array of TRUE per-request waits
    (folded in O(buckets), not O(batch)).  ``device_rows`` is the row count
    that shipped after dedup and cache hits (defaults to ``n``): occupancy
    stays the device-true ratio ≤ 1.  Label children are cached."""
    ch = _ensure_batch_children(lane)
    ch[0].observe(n)
    if pad:
        ch[1].observe((n if device_rows is None else device_rows) / pad)
    if queue_wait_s is not None:
        if hasattr(queue_wait_s, "__len__"):
            fold_queue_waits(lane, queue_wait_s)
        else:
            ch[2].observe(queue_wait_s)
    ch[3].observe(dispatch_s)
    if fallback_n is not None:
        ch[4].observe(fallback_n)


# ---------------------------------------------------------------------------
# the SLO burn-rate tracker (utils/slo.py) and the flight recorder
# (runtime/flight_recorder.py).  Reference names.
# ---------------------------------------------------------------------------

slo_burn_rate = _register(
    "gauge", "auth_server_slo_burn_rate",
    "Multi-window SLO burn rate per lane: (bad fraction in the window) / "
    "(error budget fraction), where bad = latency over --slo-ms or a "
    "non-deadline serving error.  1.0 = burning exactly the budget; "
    "sustained values over ~14 on the short window are page-worthy "
    "(multi-window multi-burn alerting).",
    _LANE_LABELS + ("window",),
)
slo_bad_total = _register(
    "counter", "auth_server_slo_bad_total",
    "Requests counted against the SLO error budget (latency over --slo-ms "
    "or a serving error), per lane.  The companion total rides "
    "auth_server_slo_observed_total.",
    _LANE_LABELS,
)
slo_observed_total = _register(
    "counter", "auth_server_slo_observed_total",
    "Requests observed by the SLO burn-rate tracker, per lane (the "
    "denominator for auth_server_slo_bad_total).",
    _LANE_LABELS,
)
flight_events = _register(
    "counter", "auth_server_flight_recorder_events_total",
    "Lifecycle events appended to the flight-recorder ring (watchdog "
    "fires, snapshot swaps, admission flips, reconcile phases, drain).",
    ("kind",),
)
flight_dumps = _register(
    "counter", "auth_server_flight_recorder_dumps_total",
    "Diagnostic bundles auto-dumped by the flight recorder on anomaly "
    "triggers (watchdog fire, admission OVERLOADED, cost regression), by "
    "the anomaly kind that triggered the dump.",
    ("trigger",),
)
# ---------------------------------------------------------------------------
# change safety (runtime/change_safety.py): canary snapshot swaps,
# guard-breach rollback and poison-config quarantine.  Reference names.
# ---------------------------------------------------------------------------

canary_state = _register(
    "gauge", "auth_server_canary_state",
    "Canary swap state per lane: 0 = no canary in progress, 1 = a newly "
    "reconciled snapshot is serving only its deterministic hash-fraction "
    "cohort (--canary-fraction) while the previous generation serves the "
    "rest; a clean --canary-window promotes to 100%, a guard breach "
    "rolls back.",
    _LANE_LABELS,
)
snapshot_rollbacks = _register(
    "counter", "auth_server_snapshot_rollbacks_total",
    "Snapshot generations rolled back, by reason: guard-breach (a canary "
    "guard tripped inside the window: deny-rate/error-rate/SLO delta, "
    "canary vs baseline), superseded (a newer reconcile landed before the "
    "canary concluded), manual (operator override through /debug/canary).  "
    "A rollback is a pointer swap to the retained previous generation: "
    "its device buffers were never written.",
    ("reason",),
)
quarantined_configs = _register(
    "gauge", "auth_server_quarantined_configs",
    "AuthConfigs currently quarantined per lane: after a guard-breach "
    "rollback, the reconcile is re-applied with these configs reverted to "
    "their prior compiled artifacts (the rest of the change still lands). "
    "Quarantine clears when the operator ships a FIXED config (changed "
    "fingerprint) or overrides via clear-quarantine.",
    _LANE_LABELS,
)
canary_guard_delta = _register(
    "gauge", "auth_server_canary_guard_delta",
    "Live canary-vs-baseline guard deltas during a canary window: "
    "deny-rate (overall), config-deny-rate (worst per-authconfig delta), "
    "error-rate (typed serving errors), slo-bad-rate (SLO bad fraction). "
    "A delta past its threshold breaches the guard and rolls the canary "
    "back.",
    ("guard",),
)
# ---------------------------------------------------------------------------
# The tenant QoS plane (tenancy/): per-tenant serving counters, tenant-scoped
# admission rejections and containment state.  Reference names.
#
# Every family with a `tenant` label is bounded by construction: the
# tenancy stats flush gives real tenant names only to the top-K tenants by
# request volume (K at most the family's bound below) and folds everyone
# else into the reserved `other` bucket.
# ---------------------------------------------------------------------------

# the reserved fold-over label value for tenants outside the top-K
TENANT_OTHER = "other"

# family (exposition name) -> the most distinct real-tenant label values the
# flush may mint (the `other` bucket rides on top)
TENANT_LABEL_BOUNDS = {
    "auth_server_tenant_requests_total": 32,
    "auth_server_tenant_denied_total": 32,
    "auth_server_tenant_slo_bad_total": 32,
    "auth_server_tenant_rejected_total": 32,
    "auth_server_tenant_queue_wait_seconds": 32,
    "auth_server_tenant_contained": 32,
}

tenant_requests = _register(
    "counter", "auth_server_tenant_requests_total",
    "Requests decided per tenant (AuthConfig identity) and lane, folded "
    "once per micro-batch from the tenant axis of the provenance fold; "
    "the device lane, the contained part and the CPU engine's degrade all "
    "count.  Bounded cardinality: top-K tenants by volume + `other`.",
    _LANE_LABELS + ("tenant",),
)
tenant_denied = _register(
    "counter", "auth_server_tenant_denied_total",
    "Denials per tenant and lane (the same per-batch fold as "
    "auth_server_tenant_requests_total).  Top-K + `other` bounded.",
    _LANE_LABELS + ("tenant",),
)
tenant_slo_bad = _register(
    "counter", "auth_server_tenant_slo_bad_total",
    "Requests counted against the SLO error budget per tenant (latency "
    "over --slo-ms).  Top-K + `other` bounded.",
    _LANE_LABELS + ("tenant",),
)
tenant_rejected = _register(
    "counter", "auth_server_tenant_rejected_total",
    "Tenant-scoped admission rejections by reason: tenant-quota (the "
    "tenant's token bucket ran dry), tenant-queue-share (the tenant's "
    "standing backlog exceeded its weighted share of the submit queue "
    "while the queue was past half its cap), tenant-contained (containment "
    "paced this tenant's traffic), doomed-deadline (the tenant's own "
    "fair-share wait doomed the deadline).  The global OVERLOADED latch "
    "is untouched by all of these.  Top-K + `other` bounded.",
    ("tenant", "reason"),
)
tenant_queue_wait = _register(
    "gauge", "auth_server_tenant_queue_wait_seconds",
    "Per-tenant queue-wait EWMA, refreshed on the tenancy flush cadence "
    "for the top-K tenants by volume.",
    ("tenant",),
)
tenant_contained = _register(
    "gauge", "auth_server_tenant_contained",
    "1 while the noisy-neighbor detector has this tenant contained "
    "(sustained share above weight x threshold with the global queue "
    "wait over target): its rows ride a part of their own at each cut, "
    "past a paced allowance typed rejections; 0 after auto-release.",
    ("tenant",),
)
state_write_failures = _register(
    "counter", "auth_server_state_write_failures_total",
    "Durable-artifact writes that failed inside the shared atomic writer "
    "(utils/atomicio.py), by artifact kind (flight, ...); the destination "
    "is left old-valid.",
    ("artifact",),
)


# ---------------------------------------------------------------------------
# snapshot distribution, the durable state plane and the decision corpus:
# leader/replica outcomes, warm-restart phases and the served blob's age,
# the hot-set warm-join, corpus distillation, synthesis and the corpus
# pregate's verdicts.  Reference names and labels.
# ---------------------------------------------------------------------------

snapshot_distribution = _register(
    "counter", "auth_server_snapshot_distribution_total",
    "Leader/replica snapshot distribution outcomes: role = leader | "
    "replica; result = published | applied | rejected (admission gate: "
    "uncertified or locally-failing snapshot, old snapshot keeps serving) "
    "| error (unreadable/corrupt source) | retry (a poll retried after a "
    "load failure under exponential backoff).",
    ("role", "result"),
)
warm_restart = _register(
    "counter", "auth_server_warm_restart_total",
    "Warm-restart phase outcomes at boot when --state-dir is set, by phase "
    "(snapshot = load + strict re-lint + apply of the local blob before "
    "the control plane connects; hotset = verdict-cache import from the "
    "local HOTSET.json) and result (ok; stale = served fail-static but "
    "older than --max-snapshot-age; miss = no artifact on disk; error = "
    "artifact present but rejected typed; a cold start, never a crash).",
    ("phase", "result"),
)
snapshot_age = _register(
    "gauge", "auth_server_snapshot_age_seconds",
    "Age of the state-dir snapshot being served fail-statically (manifest "
    "published_unix to now), set at warm start and zeroed once a live "
    "control-plane snapshot replaces it.",
    (),
)
# the mesh lane (parallel/sharded_eval.py): per-device occupancy,
# breaker-aware failover and per-shard delta bytes
mesh_shard_occupancy = _register(
    "gauge", "auth_server_mesh_shard_occupancy",
    "In-flight micro-batches currently occupying one mesh device (full-mesh "
    "launches count on every device; failover single-device dispatches on "
    "their target only).  The occupancy-aware router sends failover batches "
    "to the emptiest window.",
    ("device",),
)
device_failover = _register(
    "counter", "auth_server_device_failover_total",
    "Micro-batches re-dispatched AWAY from one mesh device after it failed "
    "a launch/probe (per-device circuit breaker attribution) — the batch "
    "resolved on a healthy device, not the host oracle.  device = the "
    "device that FAILED.",
    ("device",),
)
mesh_shard_upload_bytes = _register(
    "counter", "auth_server_mesh_shard_upload_bytes_total",
    "Reconcile upload bytes shipped to each mesh shard (the 'mp' rule "
    "slice).  A one-config mutation ships rows only to the shard(s) owning "
    "it; unchanged shards receive zero bytes (per-shard delta uploads).",
    ("shard",),
)
# the fleet plane (fleet/): the router's decisions and replica states, and
# the aggregator's global guard breaches
fleet_routed = _register(
    "counter", "auth_server_fleet_routed_total",
    "Routing decisions by the fleet router shim, by outcome: primary (the "
    "rendezvous-hash first choice took it — cache/dedup locality "
    "preserved), spillover (deadline-aware spill to the second-choice "
    "replica: the first choice's predicted wait could not meet the "
    "request deadline), load-shift (least-loaded hybrid: the first "
    "choice's backlog exceeded the second's by the imbalance factor), "
    "unhealthy (the first choice was not ready / draining / breaker-open "
    "and the second took it), failover (the routed replica failed typed "
    "mid-flight and the request re-routed), no-replica (every candidate "
    "was unroutable — the caller saw a typed UNAVAILABLE).",
    ("outcome",),
)
fleet_replicas = _register(
    "gauge", "auth_server_fleet_replicas",
    "Replicas currently registered with the fleet router, by state: "
    "ready (routable), draining (SIGTERM choreography in progress — no "
    "new work), down (crashed/removed but not yet deregistered).",
    ("state",),
)
fleet_guard_breach = _register(
    "counter", "auth_server_fleet_guard_breach_total",
    "Fleet-wide guard breaches raised by the fold aggregator, by guard "
    "(the same guard names as auth_server_canary_guard_delta, judged on "
    "GLOBAL cohort counts: the canary replica's fold vs the rest of the "
    "fleet; plus global-tenant-share for the cross-replica containment "
    "check that fires when every per-replica share is individually under "
    "threshold).",
    ("guard",),
)
fleet_warm_join = _register(
    "counter", "auth_server_fleet_warm_join_total",
    "Verdict-cache warm-join outcomes: imported (hot-set entries adopted "
    "under the local snapshot's cache tokens), skipped (entries whose "
    "config fingerprint the joining snapshot does not carry), mismatch "
    "(the whole digest refused: interner content or version diverged).",
    ("result",),
)
corpus_records = _register(
    "counter", "auth_server_corpus_records_total",
    "Corpus distillation accounting by result: distilled (distinct "
    "decision rows emitted), deduped (captured records that collapsed "
    "into an existing row), dropped-unparseable (records with no "
    "authconfig or a non-JSON document, accounted, never silently "
    "discarded).",
    ("result",),
)
corpus_rows = _register(
    "gauge", "auth_server_corpus_rows",
    "Rows in the corpus the engine's --corpus-pregate loaded, by origin: "
    "captured (distilled from real traffic, frequency-weighted) vs "
    "synthetic (truth-table witnesses for never-fired rules).",
    ("origin",),
)
corpus_pregate = _register(
    "counter", "auth_server_corpus_pregate_total",
    "Corpus preflights by result: pass (weighted verdict diff under the "
    "canary guard thresholds), breach (the candidate snapshot was "
    "REJECTED on corpus evidence before any byte of it reached the card), "
    "skipped (no corpus loaded or below the evidence floor).",
    ("result",),
)
corpus_synth = _register(
    "counter", "auth_server_corpus_synth_total",
    "Truth-table row synthesis outcomes by reason: ok (a verified "
    "witness document was admitted) or a typed uncoverability code "
    "(atom-budget-exceeded, statically-dead, unsatisfiable, "
    "unsupported-selector, selector-conflict, opaque-cpu-tree, "
    "materialization-failed).",
    ("reason",),
)


# ---------------------------------------------------------------------------
# the kernel cost observatory (runtime/kernel_cost.py): structural device
# cost folded ONCE PER MICRO-BATCH by the CostLedger (launches, bytes,
# rows — counts that do not swing with the host), and the modeled cost of
# the serving snapshot's kernel.  Reference names.
# ---------------------------------------------------------------------------

kernel_launches = _register(
    "counter", "auth_server_kernel_launches_total",
    "Kernel launches per lane.  One batch with a device row = ONE launch "
    "of the mega-kernel; a batch the verdict cache answers whole counts "
    "ZERO.",
    _LANE_LABELS,
)
kernel_h2d_bytes = _register(
    "counter", "auth_server_kernel_h2d_bytes_total",
    "Request-operand bytes staged host-to-device per lane (the fused "
    "staging buffer of each launch).  Snapshot uploads are not counted "
    "here.",
    _LANE_LABELS,
)
kernel_d2h_bytes = _register(
    "counter", "auth_server_kernel_d2h_bytes_total",
    "Verdict readback bytes device-to-host per lane: the bitpacked "
    "[pad, packed_width(1+2E)] uint8 result of each launch.",
    _LANE_LABELS,
)
kernel_pad_waste_rows = _register(
    "counter", "auth_server_kernel_pad_waste_rows_total",
    "Padded-minus-real rows per launch (device cycles spent on discarded "
    "rows), the counter twin of the auth_server_batch_pad_occupancy "
    "ratio.",
    _LANE_LABELS,
)
kernel_modeled_flops_per_row = _register(
    "gauge", "auth_server_kernel_modeled_flops_per_row",
    "Modeled operations per row of the serving snapshot's kernel, computed "
    "at reconcile from its per-config program by the own-config rule "
    "(a row runs only its own config's leaves, circuit and DFA rows; the "
    "mean over configs).  The CUDA mega-kernel does no floating point: the "
    "value counts INTEGER operations (the name is the reference's).  "
    "Modeled, not measured: compare generations, not wall clock.  A >=2x "
    "jump vs the previous generation raises the cost-regression "
    "flight-recorder anomaly.",
    ("entry",),
)

kernel_lane = _register(
    "counter", "auth_server_kernel_lane_total",
    "Batches dispatched per kernel lane: fused = the one-launch CUDA "
    "mega-kernel, matmul = the one-hot product lane, gather = the indexed "
    "reference lane.  Selection is --kernel-lane / "
    "AUTHORINO_TPU_KERNEL_LANE (auto arms fused).",
    ("lane",),
)

_kernel_children: dict = {}
_kernel_lane_children: dict = {}


def observe_kernel_lane(lane: str) -> None:
    """Count one dispatched batch on its kernel lane (cached label child,
    once per micro-batch)."""
    ch = _kernel_lane_children.get(lane)
    if ch is None:
        ch = _kernel_lane_children[lane] = kernel_lane.labels(lane)
    ch.inc()


def observe_kernel_cost(lane, launches, h2d_bytes, d2h_bytes,
                        pad_waste_rows) -> None:
    """Fold one batch's structural device cost (cached label children —
    runs once per micro-batch, zero values skipped)."""
    ch = _kernel_children.get(lane)
    if ch is None:
        ch = _kernel_children[lane] = (
            kernel_launches.labels(lane),
            kernel_h2d_bytes.labels(lane),
            kernel_d2h_bytes.labels(lane),
            kernel_pad_waste_rows.labels(lane),
        )
    if launches:
        ch[0].inc(launches)
    if h2d_bytes:
        ch[1].inc(h2d_bytes)
    if d2h_bytes:
        ch[2].inc(d2h_bytes)
    if pad_waste_rows:
        ch[3].inc(pad_waste_rows)


# the reconcile's verification planes (strict verify, translation
# validation, policy analysis, lowerability), the metadata prefetch cache
# and traffic capture with its replay pregate
snapshot_rejected = _register(
    "counter", "auth_server_snapshot_rejected_total",
    "Compiled snapshots rejected by --strict-verify tensor lint at swap "
    "time, per component (engine = apply_snapshot, native_frontend = C++ "
    "fe_swap refresh).  The previously-serving snapshot stays live.",
    ("component",),
)
policy_analysis_findings = _register(
    "counter", "auth_server_policy_analysis_findings_total",
    "Reconcile-time policy semantic-analysis findings (Cedar-style): "
    "constant-allow/constant-deny rules, shadowed/duplicate rules, hosts "
    "routed to more than one AuthConfig.  Recorded once per reconcile, "
    "never per request.",
    ("kind", "authconfig"),
)
policy_analysis_skipped = _register(
    "counter", "auth_server_policy_analysis_skipped_total",
    "Evaluators the semantic analyzer SKIPPED because their operand "
    "support exceeds the bounded-evaluation limit (MAX_ATOMS).  Skipped "
    "rules are listed on /debug/vars under policy_analysis.summary.skipped "
    "— they still serve, they are just unanalyzed.",
    ("authconfig",),
)
translation_validate = _register(
    "counter", "auth_server_translation_validate_total",
    "Per-config translation-validation outcomes at reconcile time "
    "(analysis/translation_validate.py): validated = certified against "
    "the host expression oracle this reconcile, cache_hit = unchanged "
    "fingerprint served from the process-wide certificate cache, failed = "
    "certification failure (under --strict-verify the snapshot is "
    "rejected and the old one keeps serving).",
    ("result",),
)
lowerability_configs = _register(
    "counter", "auth_server_lowerability_configs_total",
    "Per-reconcile lowerability classification: lane = fast (verdict "
    "rides the kernel) or slow (interpreter path), reason = the reason "
    "code ('' for configs with no reason; catalogue in "
    "docs/static_analysis.md).  Incremented once per (config, reason) "
    "pair per reconcile — a config with N reason codes lands in N series, "
    "so sum by lane over-counts multi-reason configs; /debug/vars "
    "engine.lowerability carries the exact per-lane config counts.",
    ("lane", "reason"),
)
lowerability_blocking = _register(
    "gauge", "auth_server_lowerability_blocking_configs",
    "Would-be-fast-if-fixed rollup per slow-lane reason code: "
    "kind = 'configs' (every slow config carrying the reason) or "
    "'sole_blocker' (configs this reason ALONE exiles — fixing it moves "
    "exactly that many to the fast lane).  Set once per reconcile from "
    "the lowerability report's blocking_reasons block, so per-reason "
    "progress trends across reconciles.",
    ("reason", "kind"),
)
relation_table_rows = _register(
    "gauge", "auth_server_relation_table_rows",
    "Entity rows of the compiled relation bitmatrix "
    "(relations/closure.py): the per-snapshot ancestor-closure table the "
    "kernel's OP_RELATION bitmask gather reads.  0 when the corpus "
    "declares no relations.",
    (),
)
relation_table_bytes = _register(
    "gauge", "auth_server_relation_table_bytes",
    "Bytes of the compiled relation bitmatrix uploaded with the snapshot "
    "(rows x ceil(queried-group columns / 8)).",
    (),
)
host_fallback_total = _register(
    "counter", "auth_server_host_fallback_total",
    "Requests re-decided by the host expression oracle because the compact "
    "device payload was lossy for them (membership overflow past members_k).",
    (),
)
host_fallback_shed_total = _register(
    "counter", "auth_server_host_fallback_shed_total",
    "Fallback requests denied (fail closed) because the per-batch host "
    "fallback cap was exceeded.",
    (),
)
metadata_prefetch = _register(
    "counter", "auth_server_metadata_prefetch_total",
    "Metadata prefetch cache outcomes (relations/prefetch.py): "
    "hit = pinned document served with zero network I/O, miss = no pin "
    "yet (live fetch fall-through), stale = pin older than the staleness "
    "bound (live fetch fall-through), refresh = background re-pin "
    "completed, error = a re-pin fetch failed (the previous pin, if any, "
    "keeps serving until stale).",
    ("result",),
)
metadata_prefetch_docs = _register(
    "gauge", "auth_server_metadata_prefetch_docs",
    "Currently pinned (healthy) prefetched metadata documents.",
    (),
)
capture_records = _register(
    "counter", "auth_server_capture_records_total",
    "Sampled full-fidelity capture-log records by result: stored (encoded "
    "into the byte-bounded ring, and persisted when --capture-log-dir is "
    "set) vs dropped (offer-queue overflow or an unencodable document — "
    "capture loss is accounted, never backpressure on the serving path). "
    "Ring evictions against --capture-log-size-mb are normal operation "
    "and ride /debug/replay, not this counter.",
    ("result",),
)
replay_pregate = _register(
    "counter", "auth_server_replay_pregate_total",
    "Reconcile replay preflights by result: pass (verdict diff under the "
    "canary guard thresholds — the swap proceeds to its canary with "
    "tightened guards), breach (the candidate snapshot was REJECTED "
    "before serving any live request; a replay-pregate-breach flight "
    "bundle carries the attributed diff), skipped (capture ring below "
    "min_requests — not enough replay evidence to judge).",
    ("result",),
)
replay_diff_flips = _register(
    "gauge", "auth_server_replay_diff_flips",
    "Verdict flips (allow<->deny, both directions) found by the most "
    "recent replay preflight on this lane — 0 after a clean preflight; a "
    "breach leaves the flip count that rejected the swap standing as "
    "incident evidence until the next preflight.",
    _LANE_LABELS,
)
