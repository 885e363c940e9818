"""gRPC ext_authz v3 frontend (semantics: ref pkg/service/auth.go:239-357,
main.go:437-488) over grpc.aio with generic method handlers whose
serializers are the port's own protobuf codec (``protos/wire.py``).

The Envoy CheckRequest is converted to the transport-independent
CheckRequestModel and runs through the same PolicyEngine/AuthPipeline as the
raw-HTTP adapter."""

from __future__ import annotations

import math
import os
import random
import time
from typing import Dict, Optional

import grpc

from ..authjson.wellknown import (
    CheckRequestModel,
    HttpRequestAttributes,
    PeerAttributes,
)
from ..pipeline.pipeline import AuthResult
from ..protos import wire
from ..runtime.engine import PolicyEngine
from ..utils.rpc import INVALID_ARGUMENT, OK, http_status_for
from ..utils.tracing import RequestSpan

__all__ = ["build_server", "request_model_from_proto", "check_response_from_result",
           "request_proto_from_model"]

AUTHORIZATION_SERVICE = "envoy.service.auth.v3.Authorization"
HEALTH_SERVICE = "grpc.health.v1.Health"

# 10k concurrent streams like the reference (ref main.go:68-69)
DEFAULT_MAX_CONCURRENT_STREAMS = 10000


def _peer_from_proto(peer: wire.Peer) -> PeerAttributes:
    sock = peer.address.socket_address
    return PeerAttributes(
        address=sock.address,
        port=int(sock.port_value),
        service=peer.service,
        labels=dict(peer.labels),
        principal=peer.principal,
        certificate=peer.certificate,
    )


def _metadata_context_dict(metadata: wire.Metadata) -> Dict[str, dict]:
    out: Dict[str, dict] = {}
    for key, struct in metadata.filter_metadata.items():
        out[key] = wire.struct_to_dict(struct)
    return {"filter_metadata": out} if out else {}


# request-id UUIDs come from a crypto-seeded PRNG: they are log/trace
# correlation handles, not secrets, and os.urandom per request is a
# measurable cost
_RID_RNG = random.Random(os.urandom(16))


def _request_id() -> str:
    s = "%032x" % _RID_RNG.getrandbits(128)
    return f"{s[:8]}-{s[8:12]}-4{s[13:16]}-{s[16:20]}-{s[20:]}"


def request_model_from_proto(req: wire.CheckRequest) -> Optional[CheckRequestModel]:
    """CheckRequest → CheckRequestModel; None when http attributes are
    missing (→ INVALID_ARGUMENT, ref auth.go:242-255)."""
    attrs = req.attributes
    if attrs is None or attrs.request is None or attrs.request.http is None:
        return None
    http = attrs.request.http
    time_str = None
    if attrs.request.time is not None:
        time_str = attrs.request.time.ToJsonString()
    return CheckRequestModel(
        http=HttpRequestAttributes(
            id=http.id or _request_id(),
            method=http.method,
            headers=dict(http.headers),
            path=http.path,
            host=http.host,
            scheme=http.scheme,
            query=http.query,
            fragment=http.fragment,
            size=http.size,
            protocol=http.protocol,
            body=http.body,
            raw_body=bytes(http.raw_body),
        ),
        source=_peer_from_proto(attrs.source),
        destination=_peer_from_proto(attrs.destination),
        context_extensions=dict(attrs.context_extensions),
        metadata_context=(_metadata_context_dict(attrs.metadata_context)
                          if attrs.metadata_context is not None else {}),
        time=time_str,
    )


def request_proto_from_model(model: CheckRequestModel) -> wire.CheckRequest:
    """The CheckRequest an Envoy would send for ``model`` (the client's
    side of ``request_model_from_proto``; ``time`` is not carried)."""

    def peer(p: PeerAttributes) -> wire.Peer:
        return wire.Peer(
            address=wire.Address(wire.SocketAddress(p.address, p.port)),
            service=p.service, labels=dict(p.labels), principal=p.principal,
            certificate=p.certificate)

    h = model.http
    md = model.metadata_context.get("filter_metadata")
    return wire.CheckRequest(attributes=wire.AttributeContext(
        source=peer(model.source), destination=peer(model.destination),
        request=wire.Request(http=wire.HttpRequest(
            id=h.id, method=h.method, headers=dict(h.headers), path=h.path,
            host=h.host, scheme=h.scheme, query=h.query, fragment=h.fragment,
            size=h.size, protocol=h.protocol, body=h.body,
            raw_body=bytes(h.raw_body))),
        context_extensions=dict(model.context_extensions),
        metadata_context=wire.Metadata(dict(md)) if md else None))


def _headers_to_options(headers):
    out = []
    for hs in headers:
        for k, v in hs.items():
            out.append(wire.HeaderValueOption(header=wire.HeaderValue(key=k, value=v)))
    return out


def _attach_dynamic_metadata(resp: wire.CheckResponse, result: AuthResult) -> None:
    """AuthResult.metadata → CheckResponse.dynamic_metadata, on BOTH the
    allow and deny paths.  On denials this carries the attributed firing
    rule (pipeline.deny_provenance → ext_authz_provenance) into Envoy's
    metadata exchange even when the client-visible reason stays the
    generic one.  Unencodable metadata is dropped, never fails the
    response."""
    if not result.metadata:
        return
    try:
        resp.dynamic_metadata = wire.encode_struct(result.metadata)
    except Exception:
        pass


def check_response_from_result(result: AuthResult) -> wire.CheckResponse:
    """AuthResult → CheckResponse (ref auth.go:315-357)."""
    if result.success():
        resp = wire.CheckResponse(
            status=wire.Status(code=OK),
            ok_response=wire.OkHttpResponse(
                headers=_headers_to_options(result.headers)
            ),
        )
        _attach_dynamic_metadata(resp, result)
        return resp

    headers = list(result.headers)
    if result.message:
        headers = headers + [{"X-Ext-Auth-Reason": result.message}]
    resp = wire.CheckResponse(
        status=wire.Status(code=result.code),
        denied_response=wire.DeniedHttpResponse(
            status=wire.HttpStatus(
                code=http_status_for(result.code, result.status)
            ),
            headers=_headers_to_options(headers),
            body=result.body,
        ),
    )
    _attach_dynamic_metadata(resp, result)
    return resp


def build_server(
    engine: PolicyEngine,
    address: str = "0.0.0.0:50051",
    tls_credentials: Optional[grpc.ServerCredentials] = None,
    max_concurrent_streams: int = DEFAULT_MAX_CONCURRENT_STREAMS,
) -> grpc.aio.Server:
    async def check(request: wire.CheckRequest, context) -> wire.CheckResponse:
        model = request_model_from_proto(request)
        if model is None:
            return check_response_from_result(
                AuthResult(code=INVALID_ARGUMENT, message="Invalid request")
            )
        # propagate Envoy's Check() deadline into the dispatch queue:
        # deadline-aware shedding fails doomed requests BEFORE encode
        # instead of wasting a kernel on an answer that arrives dead
        deadline = None
        try:
            remaining = context.time_remaining()
            if remaining is not None and math.isfinite(remaining) and remaining > 0:
                deadline = time.monotonic() + remaining
        except Exception:
            pass
        # front-door admission: doomed-on-arrival work under overload
        # answers typed here, before a span/pipeline is built (the
        # submit-time gate in the engine stays the true admission point —
        # this subset is deterministic)
        rejected = engine.admission_precheck(deadline)
        if rejected is not None:
            return check_response_from_result(rejected)
        span = RequestSpan.from_headers(model.http.headers, model.http.id)
        try:
            result = await engine.check(model, span=span, deadline=deadline)
        finally:
            span.end()
        return check_response_from_result(result)

    async def health_check(request: wire.HealthCheckRequest, context):
        return wire.HealthCheckResponse(status=wire.SERVING)

    server = grpc.aio.server(
        options=[("grpc.max_concurrent_streams", max_concurrent_streams)]
    )
    server.add_generic_rpc_handlers(
        (
            grpc.method_handlers_generic_handler(
                AUTHORIZATION_SERVICE,
                {
                    "Check": grpc.unary_unary_rpc_method_handler(
                        check,
                        request_deserializer=wire.decode_check_request,
                        response_serializer=wire.encode_check_response,
                    )
                },
            ),
            grpc.method_handlers_generic_handler(
                HEALTH_SERVICE,
                {
                    "Check": grpc.unary_unary_rpc_method_handler(
                        health_check,
                        request_deserializer=wire.decode_health_request,
                        response_serializer=wire.encode_health_response,
                    )
                },
            ),
        )
    )
    if tls_credentials is not None:
        port = server.add_secure_port(address, tls_credentials)
    else:
        port = server.add_insecure_port(address)
    # OS-assigned port for ":0" addresses (tests); real deployments pass a
    # fixed port and read back the same number
    server.bound_port = port
    return server
