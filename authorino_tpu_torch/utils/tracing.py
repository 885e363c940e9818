"""Tracing: W3C TraceContext propagation end to end, and OTLP span export
(semantics: ref pkg/trace/exporter.go:26-117, trace.go:20-27 — request spans
carry authorino.request_id and propagate x-request-id; W3C headers are
injected into every outbound evaluator HTTP call).

Export is the built-in OTLP/HTTP JSON exporter of this module: the OTLP
JSON mapping needs no SDK, so an ``http(s)://`` endpoint exports on any
machine.  The OpenTelemetry SDK is never imported; an ``rpc://`` (gRPC
OTLP) endpoint logs a warning and exports nothing.  Propagation always
works: that is the part that affects request correctness."""

from __future__ import annotations

import asyncio
import base64
import json
import logging
import random
import re
import secrets
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional
from urllib.parse import urlsplit

from . import http as http_mod

log = logging.getLogger("authorino_tpu.trace")

# crypto-seeded PRNG for span/trace ids (GIL-atomic getrandbits)
_ID_RNG = random.Random(secrets.token_bytes(16))

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)

_native_exporter: Optional["NativeOtlpExporter"] = None


class NativeOtlpExporter:
    """SDK-free OTLP/HTTP JSON exporter: finished spans batch into
    ExportTraceServiceRequest JSON (trace/span ids hex per the OTLP JSON
    mapping) POSTed to ``<endpoint>/v1/traces`` through ``utils/http.py``."""

    def __init__(self, endpoint: str, headers: Dict[str, str],
                 service_name: str = "authorino-tpu",
                 flush_interval_s: float = 2.0, max_queue: int = 4096):
        url = endpoint.rstrip("/")
        self.url = url if url.endswith("/v1/traces") else url + "/v1/traces"
        self.headers = {"content-type": "application/json", **headers}
        self.service_name = service_name
        self.flush_interval_s = flush_interval_s
        self.max_queue = max_queue
        self._queue: list = []
        self._task: Any = None
        self._timer: Any = None  # threading.Timer for loop-less enqueues
        # guards the queue swap in flush(): the timer thread and the event
        # loop may both flush — without this, both could LOAD the same
        # span list before either STOREs [] and export it twice
        self._flush_lock = threading.Lock()

    def enqueue(self, span: dict) -> None:
        if len(self._queue) >= self.max_queue:
            return  # shed rather than grow unbounded (collector outage)
        self._queue.append(span)
        if self._task is None or self._task.done():
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                # sync caller (the completer thread, drain threads): no
                # loop to ride.  A later loop-context enqueue flushes these
                # too, but none may ever come — arm a one-shot timer thread
                # so the spans are never stranded.
                self._arm_timer()
                return
            self._task = loop.create_task(self._run())

    def _arm_timer(self) -> None:
        t = self._timer
        if t is not None and t.is_alive():
            return
        t = threading.Timer(self.flush_interval_s, self._thread_flush)
        t.daemon = True
        self._timer = t
        t.start()

    def _thread_flush(self) -> None:
        """Timer-thread flush for spans enqueued outside any event loop,
        on a throwaway loop."""
        # clear the handle FIRST: this method runs on the timer thread, so
        # is_alive() in _arm_timer would see it and skip every re-arm —
        # stranding any span enqueued while the flush is in flight
        self._timer = None
        task = self._task
        if task is not None and not task.done():
            alive = True
            try:
                alive = not task.get_loop().is_closed()
            except RuntimeError:
                alive = False
            if alive:
                return  # a loop-context task owns the queue now
            # the task's loop closed without draining it (embedder teardown
            # skipped shutdown_tracing): it will never run — the timer owns
            # the queue from here on
            self._task = None
        if self._queue:
            try:
                asyncio.run(self.flush())
            except Exception as e:
                log.warning("OTLP timer flush failed: %s", e)
        if self._queue:
            self._arm_timer()  # more loop-less spans arrived meanwhile

    def _payload(self, spans: list) -> dict:
        return {
            "resourceSpans": [{
                "resource": {"attributes": [{
                    "key": "service.name",
                    "value": {"stringValue": self.service_name},
                }]},
                "scopeSpans": [{
                    "scope": {"name": "authorino-tpu"},
                    "spans": spans,
                }],
            }]
        }

    async def flush(self) -> None:
        with self._flush_lock:  # held only for the list swap
            if not self._queue:
                return
            spans, self._queue = self._queue, []
        try:
            resp = await http_mod.request(
                "POST", self.url, headers=self.headers,
                data=json.dumps(self._payload(spans)).encode())
            if resp.status >= 400:
                log.warning("OTLP export rejected: HTTP %d", resp.status)
        except Exception as e:
            log.warning("OTLP export failed: %s", e)

    async def _run(self) -> None:
        while self._queue:
            await asyncio.sleep(self.flush_interval_s)
            await self.flush()


def tracing_active() -> bool:
    """True while spans are exported — serving paths that cannot mint
    per-request spans must defer to the Python pipeline while this
    holds."""
    return _native_exporter is not None


async def shutdown_tracing() -> None:
    """Flush the exporter on shutdown."""
    if _native_exporter is not None:
        task = _native_exporter._task
        if task is not None and not task.done():
            task.cancel()
        timer = _native_exporter._timer
        if timer is not None:
            timer.cancel()
        await _native_exporter.flush()


def setup_tracing(endpoint: str, service_name: str = "authorino-tpu") -> bool:
    """Configure the built-in OTLP/HTTP JSON exporter.  Returns True when
    exporting is active (ref: CreateTraceProvider)."""
    global _native_exporter
    if not endpoint:
        return False
    # endpoint userinfo → basic-auth header
    split = urlsplit(endpoint)
    headers: Dict[str, str] = {}
    if split.username:
        cred = f"{split.username}:{split.password or ''}"
        headers["authorization"] = ("Basic "
                                    + base64.b64encode(cred.encode()).decode())
        endpoint = endpoint.replace(f"{split.username}:{split.password or ''}@",
                                    "", 1)
    if split.scheme in ("rpc", "grpc"):
        log.warning(
            "tracing endpoint %s needs an OTLP gRPC exporter, which this "
            "server does not have; spans propagate W3C context but are not "
            "exported (use an http(s):// endpoint for the built-in "
            "OTLP/JSON exporter)", endpoint)
        return False
    _native_exporter = NativeOtlpExporter(endpoint, headers, service_name)
    log.info("using the built-in OTLP/HTTP JSON exporter → %s",
             _native_exporter.url)
    return True


@dataclass
class RequestSpan:
    """Per-request span: parsed-or-minted W3C trace context
    (ref: NewAuthorizationRequestSpan, pkg/trace/trace.go:20-27)."""

    trace_id: str
    span_id: str
    sampled: bool = True
    request_id: str = ""
    start: float = field(default_factory=time.monotonic)
    start_ns: int = field(default_factory=time.time_ns)  # wall clock for OTLP

    @classmethod
    def from_headers(cls, headers: Dict[str, str],
                     request_id: str = "") -> "RequestSpan":
        tp = headers.get("traceparent", "")
        m = _TRACEPARENT_RE.match(tp) if tp else None
        if m:
            trace_id = m.group(2)
            sampled = bool(int(m.group(4), 16) & 1)
        else:
            # PRNG ids, crypto-seeded once: trace ids are correlation
            # handles, not secrets.  `| 1` keeps the all-zero id W3C-invalid
            # case out.
            trace_id = "%032x" % (_ID_RNG.getrandbits(128) | 1)
            sampled = True
        return cls(
            trace_id=trace_id,
            span_id="%016x" % (_ID_RNG.getrandbits(64) | 1),
            sampled=sampled,
            request_id=request_id,
        )

    def traceparent(self) -> str:
        """Outbound W3C header (the span id uniquely marks this hop)."""
        flags = "01" if self.sampled else "00"
        return f"00-{self.trace_id}-{self.span_id}-{flags}"

    def inject(self, headers: Dict[str, str]) -> Dict[str, str]:
        headers["traceparent"] = self.traceparent()
        if self.request_id:
            headers["x-request-id"] = self.request_id
        return headers

    def end(self, error: Optional[str] = None) -> None:
        if _native_exporter is not None and self.sampled:
            _native_exporter.enqueue({
                "traceId": self.trace_id,
                "spanId": self.span_id,
                "name": "Check",
                "kind": 2,  # SERVER
                "startTimeUnixNano": str(self.start_ns),
                "endTimeUnixNano": str(
                    self.start_ns + int((time.monotonic() - self.start) * 1e9)),
                "attributes": [{
                    "key": "authorino.request_id",
                    "value": {"stringValue": self.request_id},
                }],
                "status": {"code": 2, "message": error} if error else {},
            })

    def child(self, name: str) -> Optional["PhaseSpan"]:
        """Child span for one pipeline phase (identity/metadata/
        authorization/response).  None when span export is off or this
        request is unsampled — phase spans must never cost an untraced
        request more than this method call."""
        if not self.sampled or _native_exporter is None:
            return None
        return PhaseSpan(
            trace_id=self.trace_id,
            span_id="%016x" % (_ID_RNG.getrandbits(64) | 1),
            parent_span_id=self.span_id,
            name=name,
        )


@dataclass
class PhaseSpan:
    """One pipeline phase under a request span (each phase's share of a
    slow request becomes directly visible)."""

    trace_id: str
    span_id: str
    parent_span_id: str
    name: str
    start: float = field(default_factory=time.monotonic)
    start_ns: int = field(default_factory=time.time_ns)

    def end(self, error: Optional[str] = None) -> None:
        if _native_exporter is not None:
            _native_exporter.enqueue({
                "traceId": self.trace_id,
                "spanId": self.span_id,
                "parentSpanId": self.parent_span_id,
                "name": self.name,
                "kind": 1,  # INTERNAL
                "startTimeUnixNano": str(self.start_ns),
                "endTimeUnixNano": str(
                    self.start_ns + int((time.monotonic() - self.start) * 1e9)),
                "status": {"code": 2, "message": error} if error else {},
            })


def export_device_batch_span(batch_size: int, pad: int, eff: int,
                             links, start_ns: int,
                             duration_s: float) -> None:
    """One ``DeviceBatch`` span per kernel launch, span-LINKED (not
    parented: a batch belongs to many traces at once) to the request spans
    whose verdicts rode it.  ``links`` is [(trace_id_hex, span_id_hex)].
    Carries batch_size / pad / eff so pad waste is attributable per
    launch."""
    if _native_exporter is None:
        return
    end_ns = start_ns + int(duration_s * 1e9)
    _native_exporter.enqueue({
        # fresh trace: the batch is no single request's descendant — the
        # links below stitch it to each constituent request trace
        "traceId": "%032x" % (_ID_RNG.getrandbits(128) | 1),
        "spanId": "%016x" % (_ID_RNG.getrandbits(64) | 1),
        "name": "DeviceBatch",
        "kind": 1,  # INTERNAL
        "startTimeUnixNano": str(start_ns),
        "endTimeUnixNano": str(end_ns),
        "attributes": [
            {"key": "batch.size", "value": {"intValue": str(int(batch_size))}},
            {"key": "batch.pad", "value": {"intValue": str(int(pad))}},
            {"key": "batch.eff", "value": {"intValue": str(int(eff))}},
        ],
        "links": [{"traceId": t, "spanId": s} for t, s in links],
        "status": {},
    })
