"""The ext_authz v3 request and response conversions, without ``grpc``:
Envoy ``CheckRequest`` → ``CheckRequestModel`` and ``AuthResult`` →
``CheckResponse`` (semantics: ref pkg/service/auth.go:239-357).  The
grpc.aio server (``service/grpc_server.py``) and the native frontend
(``runtime/native_frontend.py``) both answer through these functions, so
their responses are byte-equal."""

from __future__ import annotations

import os
import random
from typing import Dict, Optional

from ..authjson.wellknown import (
    CheckRequestModel,
    HttpRequestAttributes,
    PeerAttributes,
)
from ..pipeline.pipeline import AuthResult
from ..utils.rpc import OK, http_status_for
from . import wire

__all__ = ["request_model_from_proto", "check_response_from_result",
           "request_proto_from_model"]


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
