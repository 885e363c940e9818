"""The port's tracing (``authorino_tpu_torch/utils/tracing.py``) on the
cases of tests/test_tracing.py: a ``traceparent`` parsed or minted,
``x-request-id``, injection into an outbound evaluator call, and the
built-in OTLP/HTTP JSON exporter posting to a fake collector — the
payload equal in shape to the reference's built-in exporter's.  Also the
engine's DeviceBatch span, linked to the request spans of its batch."""

import asyncio
import base64

from aiohttp import web
from aiohttp.test_utils import TestServer

from authorino_tpu.utils import http as ref_http_mod
from authorino_tpu.utils import tracing as ref_tracing
from authorino_tpu_torch.authjson import (CheckRequestModel,
                                          HttpRequestAttributes, JSONValue)
from authorino_tpu_torch.controllers import translate_auth_config
from authorino_tpu_torch.evaluators import (IdentityConfig, MetadataConfig,
                                            RuntimeAuthConfig)
from authorino_tpu_torch.evaluators.identity import Noop
from authorino_tpu_torch.evaluators.metadata import GenericHttp
from authorino_tpu_torch.pipeline import AuthPipeline
from authorino_tpu_torch.runtime import PolicyEngine
from authorino_tpu_torch.utils import tracing
from authorino_tpu_torch.utils.tracing import RequestSpan

TP = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(asyncio.wait_for(coro, 60))
    finally:
        loop.close()


def test_traceparent_parse_and_mint():
    parent = "00-0123456789abcdef0123456789abcdef-00f067aa0ba902b7-01"
    span = RequestSpan.from_headers({"traceparent": parent}, request_id="req-1")
    assert span.trace_id == "0123456789abcdef0123456789abcdef"
    assert span.span_id != "00f067aa0ba902b7"  # new span id per hop
    out = span.inject({})
    assert out["traceparent"].startswith(
        "00-0123456789abcdef0123456789abcdef-")
    assert out["x-request-id"] == "req-1"
    unsampled = RequestSpan.from_headers(
        {"traceparent": parent[:-2] + "00"}, "r")
    assert not unsampled.sampled and unsampled.inject({})[
        "traceparent"].endswith("-00")
    minted = RequestSpan.from_headers({"traceparent": "garbage"},
                                      request_id="req-2")
    assert len(minted.trace_id) == 32 and len(minted.span_id) == 16
    assert minted.sampled and minted.inject({})["x-request-id"] == "req-2"
    assert "x-request-id" not in RequestSpan.from_headers({}).inject({})
    # no exporter: phase spans cost nothing
    assert span.child("identity") is None


def test_outbound_propagation_through_generic_http():
    async def body():
        seen = {}

        async def meta(request):
            seen["traceparent"] = request.headers.get("traceparent")
            seen["x-request-id"] = request.headers.get("x-request-id")
            return web.json_response({"ok": True})

        app = web.Application()
        app.router.add_get("/meta", meta)
        server = TestServer(app)
        await server.start_server()
        try:
            base = str(server.make_url("")).rstrip("/")
            cfg = RuntimeAuthConfig(
                identity=[IdentityConfig("anon", Noop())],
                metadata=[MetadataConfig("m", GenericHttp(
                    endpoint=JSONValue(static=base + "/meta")))],
            )
            req = CheckRequestModel(http=HttpRequestAttributes(
                method="GET", path="/", host="svc.example.com",
                headers={"traceparent": TP}))
            span = RequestSpan.from_headers(req.http.headers, "rid-9")
            result = await AuthPipeline(req, cfg, span=span).evaluate()
            return result, seen
        finally:
            await server.close()

    result, seen = run(body())
    assert result.success()
    assert seen["traceparent"].startswith("00-" + "ab" * 16 + "-")
    assert seen["x-request-id"] == "rid-9"


async def collect(setup, emit, flush):
    """Run ``setup(url)`` against a fake collector, ``emit()`` spans, then
    ``flush()``; returns [(authorization header, payload)]."""
    got = []

    async def v1_traces(request):
        got.append((request.headers.get("authorization", ""),
                    await request.json()))
        return web.json_response({})

    app = web.Application()
    app.router.add_post("/v1/traces", v1_traces)
    server = TestServer(app)
    await server.start_server()
    try:
        base = str(server.make_url("")).rstrip("/")
        assert setup(base.replace("http://", "http://u:pw@", 1)) is True
        emit()
        await flush()
        return got
    finally:
        await server.close()


def shape(payload):
    """The payload with every id and time replaced by its kind."""
    if isinstance(payload, dict):
        return {k: (("hex", len(v)) if k in ("traceId", "spanId",
                                             "parentSpanId")
                    else "ns" if k.endswith("UnixNano") else shape(v))
                for k, v in payload.items()}
    if isinstance(payload, list):
        return [shape(v) for v in payload]
    return payload


def test_exporter_posts_what_the_references_built_in_exporter_posts():
    def emit(mod):
        def go():
            span = mod.RequestSpan.from_headers({"traceparent": TP}, "rid-1")
            child = span.child("identity")
            child.end()
            span.end()
            mod.RequestSpan.from_headers({}, "rid-2").end(error="Unauthorized")
            mod.export_device_batch_span(
                3, 16, 0, [(span.trace_id, span.span_id)], 1_000, 0.5)
        return go

    try:
        port_got = run(collect(tracing.setup_tracing, emit(tracing),
                               lambda: tracing._native_exporter.flush()))
    finally:
        tracing._native_exporter = None
    try:
        ref_got = run(collect(ref_tracing.setup_tracing, emit(ref_tracing),
                              lambda: ref_tracing._native_exporter.flush()))
    finally:
        ref_tracing._native_exporter = None
        run(ref_http_mod.close_sessions())
    assert len(port_got) == len(ref_got) == 1
    (auth, payload), (ref_auth, ref_payload) = port_got[0], ref_got[0]
    assert auth == ref_auth == "Basic " + base64.b64encode(b"u:pw").decode()
    assert shape(payload) == shape(ref_payload)
    rs = payload["resourceSpans"][0]
    spans = rs["scopeSpans"][0]["spans"]
    assert [s["name"] for s in spans] == ["identity", "Check", "Check",
                                          "DeviceBatch"]
    assert spans[1]["traceId"] == "ab" * 16
    assert spans[0]["parentSpanId"] == spans[1]["spanId"]
    assert spans[2]["status"] == {"code": 2, "message": "Unauthorized"}
    assert spans[3]["links"] == [{"traceId": "ab" * 16,
                                  "spanId": spans[1]["spanId"]}]
    assert int(spans[1]["endTimeUnixNano"]) >= int(
        spans[1]["startTimeUnixNano"])


def test_grpc_endpoint_stays_propagation_only():
    assert tracing.setup_tracing("rpc://collector:4317") is False
    assert tracing._native_exporter is None and not tracing.tracing_active()
    assert tracing.setup_tracing("") is False


def test_engine_exports_one_device_batch_span_per_batch():
    """With export on, a burst of Check()s through a CPU engine produces
    Check and phase spans, and one DeviceBatch span per batch whose links
    are the batch's request spans."""
    spec = {"hosts": ["t.test"], "authentication": {"a": {"anonymous": {}}},
            "authorization": {"r": {"patternMatching": {"patterns": [
                {"selector": "request.method", "operator": "eq",
                 "value": "GET"}]}}}}

    async def body():
        engine = PolicyEngine(max_batch=4, device="cpu", lane_select=False,
                              verdict_cache_size=0, batch_dedup=False)
        engine.apply_snapshot([await translate_auth_config(
            "t", "ns", spec, engine=engine)])
        spans = []

        async def one(k):
            req = CheckRequestModel(http=HttpRequestAttributes(
                method="GET", path=f"/{k}", host="t.test"))
            span = RequestSpan.from_headers({}, f"rid-{k}")
            spans.append(span)
            try:
                return await engine.check(req, span=span)
            finally:
                span.end()

        results = await asyncio.gather(*(one(k) for k in range(8)))
        return results, spans, engine.stats["batches"]

    async def go():
        got = []

        async def v1_traces(request):
            got.append(await request.json())
            return web.json_response({})

        app = web.Application()
        app.router.add_post("/v1/traces", v1_traces)
        server = TestServer(app)
        await server.start_server()
        try:
            tracing.setup_tracing(str(server.make_url("")).rstrip("/"))
            out = await body()
            # the completer thread enqueues outside any loop: its timer
            # flush may race this one, so flush until every span is in
            for _ in range(50):
                await tracing._native_exporter.flush()
                names = [s["name"] for p in got for s in
                         p["resourceSpans"][0]["scopeSpans"][0]["spans"]]
                if names.count("DeviceBatch") >= out[2]:
                    break
                await asyncio.sleep(0.05)
            return out, got
        finally:
            await server.close()

    try:
        (results, req_spans, batches), got = run(go())
    finally:
        timer = tracing._native_exporter._timer
        if timer is not None:
            timer.cancel()
        tracing._native_exporter = None
    assert [r.code for r in results] == [0] * 8 and batches == 2
    spans = [s for p in got for s in
             p["resourceSpans"][0]["scopeSpans"][0]["spans"]]
    batch_spans = [s for s in spans if s["name"] == "DeviceBatch"]
    assert len(batch_spans) == batches
    linked = sorted(lk["spanId"] for s in batch_spans for lk in s["links"])
    assert linked == sorted(s.span_id for s in req_spans)
    for s in batch_spans:
        attrs = {a["key"]: a["value"]["intValue"] for a in s["attributes"]}
        assert attrs["batch.size"] == "4" and attrs["batch.pad"] == "16"
    assert sum(s["name"] == "Check" for s in spans) == 8
    assert sum(s["name"] == "authorization" for s in spans) == 8
