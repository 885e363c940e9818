"""Authorization-JSON assembly: well-known attributes + envoy context mirror.

Structural port of the reference's schema (ref:
pkg/service/well_known_attributes.go:29-200 and
pkg/service/auth_pipeline.go:536-616): the document seen by every selector has

  - ``context.*``      — the raw Envoy AttributeContext (legacy, kept for
                         back-compat, snake_case keys)
  - ``request.*`` ``source.*`` ``destination.*`` ``metadata.*``
                       — the flattened well-known mirrors
  - ``auth.identity|metadata|authorization|response|callbacks``
                       — phase outputs

Difference from Authorino (the Go "ref"): the document is a plain Python dict
reused in place — phase outputs are written into ``auth.*`` incrementally
instead of re-marshaling the world per evaluator read (Authorino's hot-loop
cost, ref: pkg/service/auth_pipeline.go:542-579).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional
from urllib.parse import urlsplit

__all__ = ["PeerAttributes", "HttpRequestAttributes", "CheckRequestModel", "build_authorization_json"]


@dataclass
class PeerAttributes:
    """Envoy AttributeContext.Peer equivalent."""

    address: str = ""
    port: int = 0
    service: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    principal: str = ""
    certificate: str = ""

    def context_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if self.address:
            out["address"] = {
                "socket_address": {"address": self.address, "port_value": self.port}
            }
        for k in ("service", "principal", "certificate"):
            v = getattr(self, k)
            if v:
                out[k] = v
        if self.labels:
            out["labels"] = dict(self.labels)
        return out

    def wellknown_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if self.address:
            out["address"] = self.address
        if self.port:
            out["port"] = self.port
        if self.service:
            out["service"] = self.service
        if self.labels:
            out["labels"] = dict(self.labels)
        if self.principal:
            out["principal"] = self.principal
        if self.certificate:
            out["certificate"] = self.certificate
        return out


@dataclass
class HttpRequestAttributes:
    """Envoy AttributeContext.HttpRequest equivalent."""

    id: str = ""
    method: str = "GET"
    headers: Dict[str, str] = field(default_factory=dict)  # lower-cased keys
    path: str = "/"
    host: str = ""
    scheme: str = ""
    query: str = ""
    fragment: str = ""
    size: int = -1
    protocol: str = "HTTP/1.1"
    body: str = ""
    raw_body: bytes = b""


@dataclass
class CheckRequestModel:
    """Transport-independent Check() request (what Envoy CheckRequest carries,
    synthesized identically by the raw-HTTP adapter — ref: pkg/service/auth.go:140-177)."""

    http: HttpRequestAttributes = field(default_factory=HttpRequestAttributes)
    source: PeerAttributes = field(default_factory=PeerAttributes)
    destination: PeerAttributes = field(default_factory=PeerAttributes)
    context_extensions: Dict[str, str] = field(default_factory=dict)
    metadata_context: Dict[str, Any] = field(default_factory=dict)
    time: Optional[str] = None  # RFC3339

    def host(self) -> str:
        return self.context_extensions.get("host") or self.http.host

    def context_dict(self) -> Dict[str, Any]:
        """Raw AttributeContext mirror (legacy ``context.*`` keys,
        snake_case like Go's proto json tags)."""
        http: Dict[str, Any] = {
            "id": self.http.id,
            "method": self.http.method,
            "headers": dict(self.http.headers),
            "path": self.http.path,
            "host": self.http.host,
            "scheme": self.http.scheme,
            "query": self.http.query,
            "fragment": self.http.fragment,
            "size": self.http.size,
            "protocol": self.http.protocol,
        }
        if self.http.body:
            http["body"] = self.http.body
        req: Dict[str, Any] = {"http": {k: v for k, v in http.items() if v not in ("", None)}}
        if self.time:
            req["time"] = self.time
        out: Dict[str, Any] = {
            "source": self.source.context_dict(),
            "destination": self.destination.context_dict(),
            "request": req,
        }
        if self.context_extensions:
            out["context_extensions"] = dict(self.context_extensions)
        if self.metadata_context:
            out["metadata_context"] = self.metadata_context
        return out


def build_authorization_json(req: CheckRequestModel, auth_data: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Assemble the full Authorization JSON document
    (ref: pkg/service/auth_pipeline.go:610-616 + well_known_attributes.go:129-200)."""
    http = req.http
    split = urlsplit(http.path)
    headers = http.headers
    request: Dict[str, Any] = {
        "id": http.id,
        "protocol": http.protocol,
        "scheme": http.scheme,
        "host": http.host,
        "method": http.method,
        "path": http.path,
        "url_path": split.path,
        "query": split.query or http.query,
        "headers": headers,
        "referer": headers.get("referer", ""),
        "user_agent": headers.get("user-agent", ""),
        "size": http.size,
    }
    if req.time:
        request["time"] = req.time
    if http.body:
        request["body"] = http.body
    if req.context_extensions:
        request["context_extensions"] = dict(req.context_extensions)

    auth = auth_data or {}
    doc: Dict[str, Any] = {
        "context": req.context_dict(),
        "metadata": req.metadata_context or None,
        "request": request,
        "source": req.source.wellknown_dict(),
        "destination": req.destination.wellknown_dict(),
        "auth": {
            "identity": auth.get("identity"),
            "metadata": auth.get("metadata", {}),
            "authorization": auth.get("authorization", {}),
            "response": auth.get("response", {}),
            "callbacks": auth.get("callbacks", {}),
        },
    }
    return doc
