"""gRPC status codes + HTTP status mapping used by the check responses
(codes: google.rpc; mapping: ref pkg/service/auth.go:52-59)."""

from __future__ import annotations

OK = 0
CANCELLED = 1
UNKNOWN = 2
INVALID_ARGUMENT = 3
DEADLINE_EXCEEDED = 4
NOT_FOUND = 5
PERMISSION_DENIED = 7
RESOURCE_EXHAUSTED = 8
FAILED_PRECONDITION = 9
ABORTED = 10
UNIMPLEMENTED = 12
INTERNAL = 13
UNAVAILABLE = 14
UNAUTHENTICATED = 16

# rpc code → HTTP status (ref pkg/service/auth.go:52-59 statusCodeMapping)
HTTP_STATUS = {
    OK: 200,
    FAILED_PRECONDITION: 400,
    INVALID_ARGUMENT: 400,
    UNAUTHENTICATED: 401,
    PERMISSION_DENIED: 403,
    NOT_FOUND: 404,
    RESOURCE_EXHAUSTED: 429,
    INTERNAL: 500,
    UNIMPLEMENTED: 501,
    UNAVAILABLE: 503,
    DEADLINE_EXCEEDED: 504,
}


def http_status_for(code: int, override: int = 0) -> int:
    if override:
        return override
    return HTTP_STATUS.get(code, 403)


class CheckAbort(Exception):
    """Typed fail-closed abort of one Check(): carries the rpc code the
    response must use instead of the generic PERMISSION_DENIED mapping.

    Raised by the serving runtime (engine dispatch failures that could not
    degrade → UNAVAILABLE, deadline-aware shedding → DEADLINE_EXCEEDED,
    drain admission stop → UNAVAILABLE) and resolved into an AuthResult by
    AuthPipeline.evaluate — a raw exception must never leak its repr into
    a deny reason."""

    def __init__(self, code: int, message: str):
        self.code = code
        self.message = message
        super().__init__(message)
