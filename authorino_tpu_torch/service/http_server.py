"""Raw-HTTP ext_authz adapter: POST/GET /check, K8s ValidatingWebhook
(AdmissionReview) support, health, metrics and debug endpoints
(semantics: ref pkg/service/auth.go:89-235, main.go:490-492,419-432).

An incoming HTTP request is synthesized into the same CheckRequestModel the
gRPC path produces (headers lower-cased, body captured, TLS peer cert →
source.certificate) and runs through the identical engine/pipeline.

``/debug/tenants`` serves the tenant QoS plane's state, ``/debug/replay``
the capture log's accounting and the replay pregate's last verdict (POST
``?flush=1`` forces the pending capture segment to disk).  ``/debug/canary``
is the change-safety plane's: GET reads the canary, quarantine and
rollback-history state, POST ``?action=promote|rollback|clear-quarantine``
drives it."""

from __future__ import annotations

import asyncio
import json
import math
import os
import ssl
import tempfile
import time
from typing import Optional

from aiohttp import web
from multidict import CIMultiDict

from ..authjson.wellknown import (
    CheckRequestModel,
    HttpRequestAttributes,
    PeerAttributes,
)
from ..runtime import provenance as prov_mod
from ..runtime.engine import PolicyEngine
from ..utils import metrics as metrics_mod
from ..utils.rpc import OK, http_status_for
from ..utils.tracing import RequestSpan

__all__ = ["build_app", "make_check_handler"]

DEFAULT_MAX_BODY = 1024 * 1024  # --max-http-request-body-size analog

def synthesize_check_request(request: web.Request, body: bytes) -> CheckRequestModel:
    """(ref: pkg/service/auth.go:140-177)"""
    headers = {k.lower(): v for k, v in request.headers.items()}
    peer = request.transport.get_extra_info("peername") if request.transport else None
    source = PeerAttributes(
        address=peer[0] if peer else "", port=peer[1] if peer and len(peer) > 1 else 0
    )
    # TLS peer certificate → Attributes.Source.Certificate (ref :166-172)
    ssl_obj = request.transport.get_extra_info("ssl_object") if request.transport else None
    if ssl_obj is not None:
        try:
            der = ssl_obj.getpeercert(binary_form=True)
            if der:
                source.certificate = ssl.DER_cert_to_PEM_cert(der)
        except Exception:
            pass
    path = request.path_qs
    return CheckRequestModel(
        http=HttpRequestAttributes(
            id=headers.get("x-request-id", ""),
            method=request.method,
            headers=headers,
            path=path,
            host=headers.get("host", request.host or ""),
            scheme=request.scheme,
            protocol="HTTP/1.1",
            body=body.decode("utf-8", "replace") if body else "",
            raw_body=body,
            size=len(body) if body else -1,
        ),
        source=source,
    )


def _admission_review(body: bytes) -> Optional[dict]:
    """Detect a v1 AdmissionReview payload (ref: pkg/service/auth.go:191-234)."""
    if not body:
        return None
    try:
        payload = json.loads(body)
    except Exception:
        return None
    if isinstance(payload, dict) and payload.get("kind") == "AdmissionReview":
        return payload
    return None


def make_check_handler(engine: PolicyEngine, max_body: int = DEFAULT_MAX_BODY):
    async def check(request: web.Request) -> web.StreamResponse:
        # request.read() buffers the complete (possibly chunked) body;
        # content.read(n) would return only what's already streamed in
        try:
            body = await request.read()
        except web.HTTPRequestEntityTooLarge:
            return web.Response(status=413, text="request body too large")
        if len(body) > max_body:
            return web.Response(status=413, text="request body too large")

        check_request = synthesize_check_request(request, body)

        # Envoy's HTTP ext_authz filter forwards its route timeout in
        # x-envoy-expected-rq-timeout-ms: propagate it as the Check()
        # deadline so the dispatcher can shed doomed requests before encode
        deadline = None
        timeout_ms = check_request.http.headers.get(
            "x-envoy-expected-rq-timeout-ms")
        if timeout_ms:
            try:
                deadline = time.monotonic() + max(float(timeout_ms), 0.0) / 1e3
            except ValueError:
                pass
        # front-door admission: a request that is doomed on arrival while
        # the engine is overloaded is answered typed before a span or
        # pipeline exists — the submit-time gate stays the one true
        # admission point (this check is deterministic)
        rejected = engine.admission_precheck(deadline)
        if rejected is not None:
            status = http_status_for(rejected.code, rejected.status)
            metrics_mod.response_status.labels(str(status)).inc()
            return web.Response(
                status=status,
                headers={"X-Ext-Auth-Reason": rejected.message or ""},
                text="")
        span = RequestSpan.from_headers(
            check_request.http.headers, check_request.http.id
        )
        try:
            result = await engine.check(check_request, span=span,
                                        deadline=deadline)
        finally:
            span.end(error=None)

        status = http_status_for(result.code, result.status)
        metrics_mod.response_status.labels(str(status)).inc()

        admission = _admission_review(body)
        if admission is not None:
            review = {
                "apiVersion": "admission.k8s.io/v1",
                "kind": "AdmissionReview",
                "response": {
                    "uid": (admission.get("request") or {}).get("uid", ""),
                    "allowed": result.code == OK,
                },
            }
            if result.code != OK and result.message:
                review["response"]["status"] = {"message": result.message}
            return web.json_response(review)

        # multidict: repeated header names must survive (e.g. one
        # WWW-Authenticate challenge per identity config — ref config.go:29-40)
        headers: CIMultiDict = CIMultiDict()
        for hs in result.headers:
            for k, v in hs.items():
                headers.add(k, v)
        if result.code != OK and result.message:
            # reason travels in the X-Ext-Auth-Reason header (ref :470-480)
            headers["X-Ext-Auth-Reason"] = result.message
        return web.Response(status=status, headers=headers, text=result.body or "")

    return check


def build_app(engine: PolicyEngine, readiness=None, max_body: int = DEFAULT_MAX_BODY,
              enable_profile: bool = False, frontend=None) -> web.Application:
    """``readiness`` is a zero-arg callable (the reconciler's ``ready``).
    ``enable_profile`` arms the /debug/profile ``torch.profiler`` hook
    (opt-in: a trace capture costs device time and writes to disk).
    ``frontend`` is the NativeFrontend, or a zero-arg callable resolving to
    it or to a ``{"enabled": False, "reason": ...}`` dict (the CLI builds
    this app before the frontend starts)."""
    app = web.Application(client_max_size=max_body + 1024)

    async def healthz(_):
        return web.Response(text="ok")  # liveness (ref main.go:428-432)

    async def readyz(request: web.Request):
        # readiness aggregates reconciler state (ref pkg/health/health.go:48-71):
        # a draining server answers 503 so the LB stops routing here while
        # in-flight work completes; a tripped device circuit is surfaced
        # but STAYS ready, as the reference's — the half-open probe that
        # closes it rides live traffic, so removing the endpoint would keep
        # it open (a card engine answers UNAVAILABLE meanwhile, a CPU
        # engine the host oracle's exact verdicts); overload is surfaced
        # but stays ready too — admission is
        # shedding typed rejections precisely so accepted work still meets
        # its SLO
        if engine.draining:
            return web.Response(status=503, text="draining")
        if readiness is None or readiness():
            degraded = []
            fe = _frontend()
            for lane, owner in (("engine", engine), ("native", fe)):
                breaker = getattr(owner, "breaker", None) if owner else None
                if breaker is not None and breaker.state != "closed":
                    degraded.append(f"{lane} device circuit {breaker.state}")
                adm = getattr(owner, "admission", None) if owner else None
                if adm is not None and adm.overloaded:
                    degraded.append(f"{lane} admission overloaded")
            # an active quarantine is surfaced but stays ready: the
            # quarantined configs serve their prior artifacts, and a 503
            # would take every healthy config down with them
            if getattr(engine, "quarantine_active", False):
                degraded.append("quarantine active")
            # a state-dir snapshot older than --max-snapshot-age is
            # surfaced but stays ready (fail-static old verdicts beat no
            # verdicts); the first live swap clears it
            plane = getattr(engine, "state_plane", None)
            if plane is not None:
                try:
                    stale = plane.stale_reason()
                except Exception:
                    stale = None
                if stale:
                    degraded.append(stale)
            if degraded:
                return web.Response(
                    text=f"ok (degraded: {'; '.join(degraded)})")
            return web.Response(text="ok")
        return web.Response(status=503, text="not ready")

    async def server_metrics(_):
        try:
            from prometheus_client import generate_latest

            # rule heat maps accumulate in-process and flush on a cadence;
            # flushing here makes the rule-fired series current on THIS
            # scrape (collector ordering alone lags it by one)
            prov_mod.flush_heatmaps()
            return web.Response(body=generate_latest(), content_type="text/plain")
        except Exception:
            return web.Response(status=501, text="prometheus_client unavailable")

    def _frontend():
        return frontend() if callable(frontend) else frontend

    async def debug_vars(_):
        """Live introspection snapshot (the expvar analog): engine queue
        depths, config generation, admission, the window and provenance,
        and the native frontend's state (or why it does not serve).
        Everything here is a read under the GIL; safe to scrape under
        load."""
        data = {
            "engine": engine.debug_vars(),
            "process": {"pid": os.getpid(), "time": time.time()},
        }
        fe = _frontend()
        if isinstance(fe, dict):
            data["native_frontend"] = fe
        elif fe is not None:
            fe.drain_native_stats()  # /metrics reflects this scrape too
            data["native_frontend"] = fe.debug_vars()
        return web.json_response(data)

    async def debug_decisions(request: web.Request):
        """Head-sampled decision log: the bounded ring of structured
        decision records — host, authconfig, verdict, firing rule, lane,
        latency, snapshot generation.  ``?n=K`` returns the newest K
        records; ``?tenant=NAME`` returns that tenant's stratified
        sub-ring."""
        n = None
        if "n" in request.query:
            try:
                n = int(request.query["n"])
            except ValueError:
                return web.Response(status=400, text="bad n")
        tenant = request.query.get("tenant") or None
        return web.json_response(
            prov_mod.DECISIONS.to_json(n=n, tenant=tenant))

    async def debug_tenants(_):
        """The tenant QoS plane's state: weights and quotas, fair-cut
        evidence, per-tenant admission and wait state, the top tenants
        with their SLO burn, and the containment set."""
        plane = getattr(engine, "tenancy", None)
        if plane is None:
            return web.json_response({"enabled": False})
        return web.json_response(plane.to_json())

    async def debug_canary(request: web.Request):
        """Change-safety state and the operator's override: GET returns
        the canary, quarantine and rollback-history state;
        ``?action=promote`` promotes an in-progress canary at once,
        ``?action=rollback`` rolls it back (or, with none in progress,
        re-serves the newest retained generation),
        ``?action=clear-quarantine`` releases the quarantine."""
        action = request.query.get("action", "")
        if not action:
            return web.json_response(engine.change_safety_vars())
        if request.method != "POST":
            # the actions change the serving snapshot: never off a GET,
            # idempotent by contract (link prefetchers, dashboards)
            return web.json_response(
                {"error": "state-changing actions require POST"},
                status=405)
        ops = {
            "promote": engine.canary_promote,
            "rollback": engine.canary_rollback,
            "clear-quarantine": engine.clear_quarantine,
        }
        op = ops.get(action)
        if op is None:
            return web.Response(
                status=400,
                text=f"unknown action {action!r} "
                     f"(want promote|rollback|clear-quarantine)")
        # promote and rollback fan out to the swap listeners (the native
        # frontend's C++ snapshot rebuild): never on the serving loop
        applied = await asyncio.get_running_loop().run_in_executor(None, op)
        return web.json_response({
            "action": action, "applied": bool(applied),
            "change_safety": engine.change_safety_vars(),
        })

    async def debug_replay(request: web.Request):
        """Traffic replay's state (docs/replay.md): the capture log's
        accounting (ring bytes and records, drops, segments) and the last
        replay-preflight verdict.  POST ``?flush=1`` forces the pending
        capture segment to disk first."""
        from ..replay.capture import CAPTURE

        if request.query.get("flush") and request.method == "POST":
            await asyncio.get_running_loop().run_in_executor(
                None, CAPTURE.flush)
        return web.json_response(engine.replay_vars())

    profile_state = {"busy": False}

    async def debug_profile(request: web.Request):
        """Opt-in on-demand profile: captures a ``torch.profiler`` trace
        (CPU and, when a card is visible, CUDA activities) for ?seconds=N
        (cap 60) into a fresh temp dir and returns its path.  Single-flight
        — a capture in progress answers 409."""
        if not enable_profile:
            return web.Response(
                status=403,
                text="profiling disabled (start with --debug-profile)")
        try:
            seconds = float(request.query.get("seconds", 1.0))
        except ValueError:
            return web.Response(status=400, text="bad seconds")
        if not math.isfinite(seconds):
            # NaN passes float() and poisons min/max + asyncio.sleep —
            # the capture would never stop and busy would stick
            return web.Response(status=400, text="bad seconds")
        seconds = min(max(seconds, 0.1), 60.0)
        if profile_state["busy"]:
            return web.Response(status=409, text="profile capture in progress")
        profile_state["busy"] = True
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            trace_dir = tempfile.mkdtemp(prefix="authorino-tpu-profile-")
            prof = profile(activities=activities)
            prof.start()
            try:
                await asyncio.sleep(seconds)
            finally:
                prof.stop()
            prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
            return web.json_response({"trace_dir": trace_dir, "seconds": seconds})
        except Exception as e:
            return web.Response(status=500, text=f"profile capture failed: {e}")
        finally:
            profile_state["busy"] = False

    app.router.add_get("/healthz", healthz)
    app.router.add_get("/readyz", readyz)
    app.router.add_get("/metrics", server_metrics)
    app.router.add_get("/server-metrics", server_metrics)
    app.router.add_get("/debug/vars", debug_vars)
    app.router.add_get("/debug/decisions", debug_decisions)
    app.router.add_get("/debug/tenants", debug_tenants)
    app.router.add_get("/debug/canary", debug_canary)
    app.router.add_post("/debug/canary", debug_canary)
    app.router.add_get("/debug/replay", debug_replay)
    app.router.add_post("/debug/replay", debug_replay)
    app.router.add_get("/debug/profile", debug_profile)
    # catch-all LAST: Envoy's HTTP ext_authz filter forwards the ORIGINAL
    # request path (path_prefix + :path), so /check is just the conventional
    # prefix — any path must evaluate (ref: pkg/service/auth.go:89-177
    # synthesizes the CheckRequest from the incoming request itself)
    app.router.add_route("*", "/{tail:.*}", make_check_handler(engine, max_body))
    return app
