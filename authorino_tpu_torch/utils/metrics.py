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
    from prometheus_client import REGISTRY, Counter, Histogram

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


def _register(kind, name, doc, labels):
    if not _PROM:
        return _NoopMetric()
    cls = Counter if kind == "counter" else Histogram
    try:
        return cls(name, doc, labels)
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
