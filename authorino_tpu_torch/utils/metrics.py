"""Prometheus metrics of the auth pipeline — the reference's metric names
and labels (ref: pkg/service/auth_pipeline.go:26-36, pkg/metrics/metrics.go).

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
    if not _PROM:
        return _NoopMetric()
    cls = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}[kind]
    kw = {"buckets": buckets} if buckets is not None else {}
    try:
        return cls(name, doc, labels, **kw)
    except ValueError:  # already registered
        return _existing_collector(name) or _NoopMetric()


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
    "their readback never arrived within device_timeout_s (the batch "
    "retries once, then answers UNAVAILABLE).",
    _LANE_LABELS,
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
