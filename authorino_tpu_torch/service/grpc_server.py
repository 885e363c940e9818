"""gRPC ext_authz v3 frontend (semantics: ref pkg/service/auth.go:239-357,
main.go:437-488) over grpc.aio with generic method handlers whose
serializers are the port's own protobuf codec (``protos/wire.py``).

The Envoy CheckRequest is converted to the transport-independent
CheckRequestModel and runs through the same PolicyEngine/AuthPipeline as the
raw-HTTP adapter."""

from __future__ import annotations

import math
import time
from typing import Optional

import grpc

from ..pipeline.pipeline import AuthResult
from ..protos import wire
from ..protos.ext_authz import (  # noqa: F401  (re-exported)
    check_response_from_result,
    request_model_from_proto,
    request_proto_from_model,
)
from ..runtime.engine import PolicyEngine
from ..utils.rpc import INVALID_ARGUMENT
from ..utils.tracing import RequestSpan

__all__ = ["build_server", "request_model_from_proto", "check_response_from_result",
           "request_proto_from_model"]

AUTHORIZATION_SERVICE = "envoy.service.auth.v3.Authorization"
HEALTH_SERVICE = "grpc.health.v1.Health"

# 10k concurrent streams like the reference (ref main.go:68-69)
DEFAULT_MAX_CONCURRENT_STREAMS = 10000


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
