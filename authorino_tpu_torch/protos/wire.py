"""Envoy ext_authz v3, gRPC health and SpiceDB ``CheckPermission`` on the
protobuf wire, in plain Python on ``bytes`` (no ``google.protobuf``).

The messages are the ones the service needs, with the field numbers of
the public protos (``envoy.service.auth.v3``, ``envoy.config.core.v3``,
``envoy.type.v3``, ``google.rpc``, ``google.protobuf.{Struct,Timestamp}``,
``grpc.health.v1``, ``authzed.api.v1``).  Each message is a dataclass whose
fields carry the generated code's names.

Decoding follows upb, the parser of the Python protobuf runtime: strings
are strict UTF-8 (``raw_body`` stays ``bytes``); an unknown field of any
wire type (groups included) is skipped, and so is a known field sent with
another wire type; a submessage sent twice is merged, a repeated map key
keeps its last value, the last member of a oneof wins; a truncated or
malformed message raises ``DecodeError``.  A present but empty submessage
is present: ``CheckRequest.attributes``, ``AttributeContext.request`` and
``metadata_context``, ``Request.time`` and ``http`` are ``None`` only when
absent.  A ``Struct`` decodes to what ``json_format.MessageToDict`` gives
(numbers are floats, ``null_value`` and an unset ``Value`` are ``None``);
``struct_to_dict`` then raises on a non-finite number as it does.

Encoding writes fields in field-number order, as upb does, omitting proto3
defaults but never a set submessage or oneof member; ``encode_struct``
follows ``Struct.update``: ``bool`` before ``int``, an ``int`` or ``float``
is a double, a ``dict`` a Struct, a ``list`` or ``tuple`` a ListValue, and
any other type raises ``ValueError`` (a non-``str`` key ``TypeError``)."""

from __future__ import annotations

import datetime
import struct as _struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "DecodeError", "SocketAddress", "Address", "Peer", "Timestamp",
    "HttpRequest", "Request", "Metadata", "AttributeContext",
    "CheckRequest", "Status", "HttpStatus", "HeaderValue",
    "HeaderValueOption", "DeniedHttpResponse", "OkHttpResponse",
    "CheckResponse", "HealthCheckRequest", "HealthCheckResponse",
    "SERVING", "decode_check_request", "encode_check_request",
    "encode_check_response", "decode_check_response", "encode_struct",
    "struct_to_dict", "decode_health_request",
    "encode_health_request", "decode_health_response",
    "encode_health_response", "encode_check_permission",
    "decode_check_permission", "encode_check_permission_response",
]

_U64 = (1 << 64) - 1
_DOUBLE = _struct.Struct("<d")


class DecodeError(ValueError):
    """A message that is not valid protobuf for its type."""


# ---- primitives -------------------------------------------------------------

def _varint(n: int) -> bytes:
    n &= _U64
    if n < 0x80:
        return bytes((n,))
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _read_varint(buf: bytes, i: int, end: int) -> Tuple[int, int]:
    shift = value = 0
    while shift < 70:
        if i >= end:
            raise DecodeError("truncated varint")
        b = buf[i]
        i += 1
        value |= (b & 0x7F) << shift
        if b < 0x80:
            return value & _U64, i
        shift += 7
    raise DecodeError("varint longer than 10 bytes")


def _signed(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


def _fields(buf: bytes, i: int, end: int):
    """Yield (field number, wire type, value) for each field of one
    message: the integer of a varint or fixed field, the (start, stop)
    span of a length-delimited one.  Groups are skipped whole."""
    while i < end:
        key, i = _read_varint(buf, i, end)
        num, wire = key >> 3, key & 7
        if num == 0:
            raise DecodeError("field number 0")
        if wire == 0:
            v, i = _read_varint(buf, i, end)
        elif wire == 2:
            n, i = _read_varint(buf, i, end)
            if n > end - i:
                raise DecodeError("truncated length-delimited field")
            v = (i, i + n)
            i += n
        elif wire == 1:
            if i + 8 > end:
                raise DecodeError("truncated fixed64")
            v = int.from_bytes(buf[i:i + 8], "little")
            i += 8
        elif wire == 5:
            if i + 4 > end:
                raise DecodeError("truncated fixed32")
            v = int.from_bytes(buf[i:i + 4], "little")
            i += 4
        elif wire == 3:
            i = _skip_group(buf, i, end, num)
            continue
        else:  # 4 (an end without its start), 6, 7
            raise DecodeError(f"bad wire type {wire}")
        yield num, wire, v


def _skip_group(buf: bytes, i: int, end: int, num: int) -> int:
    while True:
        if i >= end:
            raise DecodeError("unterminated group")
        key, i = _read_varint(buf, i, end)
        n, wire = key >> 3, key & 7
        if n == 0:
            raise DecodeError("field number 0")
        if wire == 4:
            if n != num:
                raise DecodeError("mismatched end group")
            return i
        if wire == 0:
            _, i = _read_varint(buf, i, end)
        elif wire == 2:
            ln, i = _read_varint(buf, i, end)
            if ln > end - i:
                raise DecodeError("truncated length-delimited field")
            i += ln
        elif wire == 1:
            i += 8
        elif wire == 5:
            i += 4
        elif wire == 3:
            i = _skip_group(buf, i, end, n)
        else:
            raise DecodeError(f"bad wire type {wire}")
        if i > end:
            raise DecodeError("truncated group")


def _text(buf: bytes, span) -> str:
    try:
        return buf[span[0]:span[1]].decode("utf-8")
    except UnicodeDecodeError as e:
        raise DecodeError(f"invalid UTF-8 in a string field: {e}") from None


def _tag(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _ld(num: int, payload: bytes) -> bytes:
    return _tag(num, 2) + _varint(len(payload)) + payload


def _str_field(num: int, s: str) -> bytes:
    return _ld(num, s.encode("utf-8")) if s else b""


def _int_field(num: int, v: int) -> bytes:
    return _tag(num, 0) + _varint(v) if v else b""


def _string_map(buf: bytes, span, out: Dict[str, str]) -> None:
    """One map<string, string> entry into ``out`` (a later key wins)."""
    key = value = ""
    for num, wire, v in _fields(buf, span[0], span[1]):
        if wire != 2:
            continue
        if num == 1:
            key = _text(buf, v)
        elif num == 2:
            value = _text(buf, v)
    out[key] = value


def _encode_string_map(num: int, m: Dict[str, str]) -> bytes:
    return b"".join(_ld(num, _ld(1, k.encode("utf-8"))
                        + _ld(2, v.encode("utf-8"))) for k, v in m.items())


# ---- google.protobuf.Struct / Value / ListValue ------------------------------

def _decode_value(buf: bytes, i: int, end: int):
    kind, val = None, None
    for num, wire, v in _fields(buf, i, end):
        if num == 1 and wire == 0:
            kind, val = "null", None
        elif num == 2 and wire == 1:
            kind, val = "number", _DOUBLE.unpack(v.to_bytes(8, "little"))[0]
        elif num == 3 and wire == 2:
            kind, val = "string", _text(buf, v)
        elif num == 4 and wire == 0:
            kind, val = "bool", bool(v)
        elif num == 5 and wire == 2:
            if kind != "struct":
                kind, val = "struct", {}
            _decode_struct_into(buf, v[0], v[1], val)
        elif num == 6 and wire == 2:
            if kind != "list":
                kind, val = "list", []
            _decode_list_into(buf, v[0], v[1], val)
    return val


def _decode_struct_into(buf: bytes, i: int, end: int, out: dict) -> None:
    for num, wire, span in _fields(buf, i, end):
        if num != 1 or wire != 2:
            continue
        key, value = "", None
        for n, w, v in _fields(buf, span[0], span[1]):
            if n == 1 and w == 2:
                key = _text(buf, v)
            elif n == 2 and w == 2:
                value = _decode_value(buf, v[0], v[1])
        out[key] = value


def _decode_list_into(buf: bytes, i: int, end: int, out: list) -> None:
    for num, wire, v in _fields(buf, i, end):
        if num == 1 and wire == 2:
            out.append(_decode_value(buf, v[0], v[1]))


def struct_to_dict(value: Any) -> Any:
    """``value`` (a decoded Struct) checked as ``MessageToDict`` checks it:
    an infinite or NaN number raises ValueError."""
    if isinstance(value, dict):
        for v in value.values():
            struct_to_dict(v)
    elif isinstance(value, list):
        for v in value:
            struct_to_dict(v)
    elif isinstance(value, float) and value - value != 0.0:
        name = "NaN" if value != value else "Infinity"
        raise ValueError(f"Fail to serialize {name} for Value.number_value, "
                         "which would parse as string_value")
    return value


def _encode_value(value: Any) -> bytes:
    if value is None:
        return b"\x08\x00"
    if isinstance(value, bool):
        return b"\x20\x01" if value else b"\x20\x00"
    if isinstance(value, str):
        return _ld(3, value.encode("utf-8"))
    if isinstance(value, (int, float)):
        return b"\x11" + _DOUBLE.pack(float(value))
    if isinstance(value, dict):
        return _ld(5, encode_struct(value))
    if isinstance(value, (list, tuple)):
        return _ld(6, b"".join(_ld(1, _encode_value(v)) for v in value))
    raise ValueError("Unexpected type")


def encode_struct(value: dict) -> bytes:
    """A ``google.protobuf.Struct`` holding ``value`` (``Struct.update``)."""
    out = []
    for key, v in value.items():
        if not isinstance(key, str):
            raise TypeError(f"Struct key {key!r} is not a str")
        out.append(_ld(1, _ld(1, key.encode("utf-8"))
                       + _ld(2, _encode_value(v))))
    return b"".join(out)


# ---- google.protobuf.Timestamp ----------------------------------------------

_TS_MIN, _TS_MAX = -62135596800, 253402300799


@dataclass(slots=True)
class Timestamp:
    seconds: int = 0
    nanos: int = 0

    def ToJsonString(self) -> str:
        """RFC 3339 ending in ``Z``, with 0, 3, 6 or 9 fraction digits."""
        if not _TS_MIN <= self.seconds <= _TS_MAX:
            raise ValueError(
                "Timestamp is not valid: Seconds {0} must be in range "
                "[-62135596800, 253402300799].".format(self.seconds))
        if not 0 <= self.nanos < 1_000_000_000:
            raise ValueError("Timestamp is not valid: Nanos {} must be in a "
                             "range [0, 999999].".format(self.nanos))
        nanos = self.nanos
        secs = self.seconds % 86400
        days = (self.seconds - secs) // 86400
        result = (datetime.datetime(1970, 1, 1)
                  + datetime.timedelta(days, secs)).isoformat()
        if nanos == 0:
            return result + "Z"
        if nanos % 1_000_000 == 0:
            return result + ".%03dZ" % (nanos // 1_000_000)
        if nanos % 1_000 == 0:
            return result + ".%06dZ" % (nanos // 1_000)
        return result + ".%09dZ" % nanos


def _decode_timestamp(buf: bytes, span, ts: Timestamp) -> None:
    for num, wire, v in _fields(buf, span[0], span[1]):
        if wire != 0:
            continue
        if num == 1:
            ts.seconds = _signed(v, 64)
        elif num == 2:
            ts.nanos = _signed(v, 32)


def _encode_timestamp(ts: Timestamp) -> bytes:
    return _int_field(1, ts.seconds) + _int_field(2, ts.nanos)


# ---- the CheckRequest --------------------------------------------------------

@dataclass(slots=True)
class SocketAddress:
    address: str = ""
    port_value: int = 0


@dataclass(slots=True)
class Address:
    socket_address: SocketAddress = field(default_factory=SocketAddress)


@dataclass(slots=True)
class Peer:
    address: Address = field(default_factory=Address)
    service: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    principal: str = ""
    certificate: str = ""


@dataclass(slots=True)
class HttpRequest:
    id: str = ""
    method: str = ""
    headers: Dict[str, str] = field(default_factory=dict)
    path: str = ""
    host: str = ""
    scheme: str = ""
    query: str = ""
    fragment: str = ""
    size: int = 0
    protocol: str = ""
    body: str = ""
    raw_body: bytes = b""


@dataclass(slots=True)
class Request:
    time: Optional[Timestamp] = None
    http: Optional[HttpRequest] = None


@dataclass(slots=True)
class Metadata:
    # filter name → the decoded Struct
    filter_metadata: Dict[str, dict] = field(default_factory=dict)


@dataclass(slots=True)
class AttributeContext:
    source: Peer = field(default_factory=Peer)
    destination: Peer = field(default_factory=Peer)
    request: Optional[Request] = None
    context_extensions: Dict[str, str] = field(default_factory=dict)
    metadata_context: Optional[Metadata] = None


@dataclass(slots=True)
class CheckRequest:
    attributes: Optional[AttributeContext] = None


def _decode_socket_address(buf: bytes, span, sa: SocketAddress) -> None:
    for num, wire, v in _fields(buf, span[0], span[1]):
        if num == 2 and wire == 2:
            sa.address = _text(buf, v)
        elif num == 3 and wire == 0:
            sa.port_value = v & 0xFFFFFFFF
        elif num == 4 and wire == 2:
            _text(buf, v)         # named_port: the oneof's other member
            sa.port_value = 0
        elif num == 5 and wire == 2:
            _text(buf, v)         # resolver_name


def _decode_address(buf: bytes, span, addr: Address) -> None:
    for num, wire, v in _fields(buf, span[0], span[1]):
        if wire != 2:
            continue
        if num == 1:
            _decode_socket_address(buf, v, addr.socket_address)
        elif num == 2:
            # a pipe: the oneof's other member clears the socket address
            for n, w, p in _fields(buf, v[0], v[1]):
                if n == 1 and w == 2:
                    _text(buf, p)
            addr.socket_address = SocketAddress()


def _decode_peer(buf: bytes, span, peer: Peer) -> None:
    for num, wire, v in _fields(buf, span[0], span[1]):
        if wire != 2:
            continue
        if num == 1:
            _decode_address(buf, v, peer.address)
        elif num == 2:
            peer.service = _text(buf, v)
        elif num == 3:
            _string_map(buf, v, peer.labels)
        elif num == 4:
            peer.principal = _text(buf, v)
        elif num == 5:
            peer.certificate = _text(buf, v)


_HTTP_TEXT = {1: "id", 2: "method", 4: "path", 5: "host", 6: "scheme",
              7: "query", 8: "fragment", 10: "protocol", 11: "body"}


def _decode_http(buf: bytes, span, http: HttpRequest) -> None:
    for num, wire, v in _fields(buf, span[0], span[1]):
        if wire == 2:
            name = _HTTP_TEXT.get(num)
            if name is not None:
                setattr(http, name, _text(buf, v))
            elif num == 3:
                _string_map(buf, v, http.headers)
            elif num == 12:
                http.raw_body = buf[v[0]:v[1]]
        elif num == 9 and wire == 0:
            http.size = _signed(v, 64)


def _decode_request(buf: bytes, span, req: Request) -> None:
    for num, wire, v in _fields(buf, span[0], span[1]):
        if wire != 2:
            continue
        if num == 1:
            if req.time is None:
                req.time = Timestamp()
            _decode_timestamp(buf, v, req.time)
        elif num == 2:
            if req.http is None:
                req.http = HttpRequest()
            _decode_http(buf, v, req.http)


def _decode_metadata(buf: bytes, span, md: Metadata) -> None:
    for num, wire, v in _fields(buf, span[0], span[1]):
        if wire != 2:
            continue
        if num == 1:
            key, value = "", {}
            for n, w, p in _fields(buf, v[0], v[1]):
                if w != 2:
                    continue
                if n == 1:
                    key = _text(buf, p)
                elif n == 2:
                    value = {}
                    _decode_struct_into(buf, p[0], p[1], value)
            md.filter_metadata[key] = value
        elif num == 2:
            # typed_filter_metadata (map<string, Any>): validated, not kept
            for n, w, p in _fields(buf, v[0], v[1]):
                if n == 1 and w == 2:
                    _text(buf, p)
                elif n == 2 and w == 2:
                    for an, aw, ap in _fields(buf, p[0], p[1]):
                        if an == 1 and aw == 2:
                            _text(buf, ap)


def _decode_attributes(buf: bytes, span, attrs: AttributeContext) -> None:
    for num, wire, v in _fields(buf, span[0], span[1]):
        if wire != 2:
            continue
        if num == 1:
            _decode_peer(buf, v, attrs.source)
        elif num == 2:
            _decode_peer(buf, v, attrs.destination)
        elif num == 4:
            if attrs.request is None:
                attrs.request = Request()
            _decode_request(buf, v, attrs.request)
        elif num == 10:
            _string_map(buf, v, attrs.context_extensions)
        elif num == 11:
            if attrs.metadata_context is None:
                attrs.metadata_context = Metadata()
            _decode_metadata(buf, v, attrs.metadata_context)


def decode_check_request(data: bytes) -> CheckRequest:
    """``envoy.service.auth.v3.CheckRequest`` from its bytes."""
    data = bytes(data)
    req = CheckRequest()
    for num, wire, v in _fields(data, 0, len(data)):
        if num == 1 and wire == 2:
            if req.attributes is None:
                req.attributes = AttributeContext()
            _decode_attributes(data, v, req.attributes)
    return req


def _encode_peer(p: Peer) -> bytes:
    sa = p.address.socket_address
    sock = _str_field(2, sa.address) + _int_field(3, sa.port_value)
    return ((_ld(1, _ld(1, sock)) if sock else b"")
            + _str_field(2, p.service) + _encode_string_map(3, p.labels)
            + _str_field(4, p.principal) + _str_field(5, p.certificate))


def _encode_http(h: HttpRequest) -> bytes:
    return (_str_field(1, h.id) + _str_field(2, h.method)
            + _encode_string_map(3, h.headers) + _str_field(4, h.path)
            + _str_field(5, h.host) + _str_field(6, h.scheme)
            + _str_field(7, h.query) + _str_field(8, h.fragment)
            + _int_field(9, h.size) + _str_field(10, h.protocol)
            + _str_field(11, h.body)
            + (_ld(12, bytes(h.raw_body)) if h.raw_body else b""))


def encode_check_request(req: CheckRequest) -> bytes:
    """The client's side: a CheckRequest's bytes (an empty peer is left
    out)."""
    a = req.attributes
    if a is None:
        return b""
    body = b""
    for num, peer in ((1, a.source), (2, a.destination)):
        enc = _encode_peer(peer)
        if enc:
            body += _ld(num, enc)
    if a.request is not None:
        r = b""
        if a.request.time is not None:
            r += _ld(1, _encode_timestamp(a.request.time))
        if a.request.http is not None:
            r += _ld(2, _encode_http(a.request.http))
        body += _ld(4, r)
    body += _encode_string_map(10, a.context_extensions)
    if a.metadata_context is not None:
        body += _ld(11, b"".join(
            _ld(1, _ld(1, k.encode("utf-8")) + _ld(2, encode_struct(v)))
            for k, v in a.metadata_context.filter_metadata.items()))
    return _ld(1, body)


# ---- the CheckResponse -------------------------------------------------------

@dataclass(slots=True)
class Status:
    code: int = 0
    message: str = ""


@dataclass(slots=True)
class HttpStatus:
    code: int = 0


@dataclass(slots=True)
class HeaderValue:
    key: str = ""
    value: str = ""


@dataclass(slots=True)
class HeaderValueOption:
    header: HeaderValue = field(default_factory=HeaderValue)


@dataclass(slots=True)
class DeniedHttpResponse:
    status: HttpStatus = field(default_factory=HttpStatus)
    headers: List[HeaderValueOption] = field(default_factory=list)
    body: str = ""


@dataclass(slots=True)
class OkHttpResponse:
    headers: List[HeaderValueOption] = field(default_factory=list)


@dataclass(slots=True)
class CheckResponse:
    status: Status = field(default_factory=Status)
    denied_response: Optional[DeniedHttpResponse] = None
    ok_response: Optional[OkHttpResponse] = None
    # an encoded google.protobuf.Struct (``encode_struct``), or None
    dynamic_metadata: Optional[bytes] = None


def _encode_headers(num: int, headers: List[HeaderValueOption]) -> bytes:
    return b"".join(_ld(num, _ld(1, _str_field(1, h.header.key)
                                 + _str_field(2, h.header.value)))
                    for h in headers)


def encode_check_response(resp: CheckResponse) -> bytes:
    out = [_ld(1, _int_field(1, resp.status.code)
               + _str_field(2, resp.status.message))]
    if resp.denied_response is not None:
        d = resp.denied_response
        out.append(_ld(2, _ld(1, _int_field(1, d.status.code))
                       + _encode_headers(2, d.headers)
                       + _str_field(3, d.body)))
    elif resp.ok_response is not None:
        out.append(_ld(3, _encode_headers(2, resp.ok_response.headers)))
    if resp.dynamic_metadata is not None:
        out.append(_ld(4, resp.dynamic_metadata))
    return b"".join(out)


def _decode_headers(buf: bytes, span, out: List[HeaderValueOption]) -> None:
    opt = HeaderValueOption()
    for num, wire, v in _fields(buf, span[0], span[1]):
        if num == 1 and wire == 2:
            for n, w, p in _fields(buf, v[0], v[1]):
                if w != 2:
                    continue
                if n == 1:
                    opt.header.key = _text(buf, p)
                elif n == 2:
                    opt.header.value = _text(buf, p)
    out.append(opt)


def decode_check_response(data: bytes) -> CheckResponse:
    """The client's side: a CheckResponse from its bytes (the Struct of
    ``dynamic_metadata`` kept encoded)."""
    data = bytes(data)
    resp = CheckResponse()
    for num, wire, v in _fields(data, 0, len(data)):
        if wire != 2:
            continue
        if num == 1:
            for n, w, p in _fields(data, v[0], v[1]):
                if n == 1 and w == 0:
                    resp.status.code = _signed(p, 32)
                elif n == 2 and w == 2:
                    resp.status.message = _text(data, p)
        elif num == 2:
            d = resp.denied_response or DeniedHttpResponse()
            resp.denied_response, resp.ok_response = d, None
            for n, w, p in _fields(data, v[0], v[1]):
                if n == 1 and w == 2:
                    for n2, w2, c in _fields(data, p[0], p[1]):
                        if n2 == 1 and w2 == 0:
                            d.status.code = _signed(c, 32)
                elif n == 2 and w == 2:
                    _decode_headers(data, p, d.headers)
                elif n == 3 and w == 2:
                    d.body = _text(data, p)
        elif num == 3:
            ok = resp.ok_response or OkHttpResponse()
            resp.ok_response, resp.denied_response = ok, None
            for n, w, p in _fields(data, v[0], v[1]):
                if n == 2 and w == 2:
                    _decode_headers(data, p, ok.headers)
        elif num == 4:
            resp.dynamic_metadata = (resp.dynamic_metadata or b"") + \
                data[v[0]:v[1]]
    return resp


# ---- grpc.health.v1 ----------------------------------------------------------

SERVING = 1


@dataclass(slots=True)
class HealthCheckRequest:
    service: str = ""


@dataclass(slots=True)
class HealthCheckResponse:
    status: int = 0


def decode_health_request(data: bytes) -> HealthCheckRequest:
    data = bytes(data)
    req = HealthCheckRequest()
    for num, wire, v in _fields(data, 0, len(data)):
        if num == 1 and wire == 2:
            req.service = _text(data, v)
    return req


def encode_health_request(req: HealthCheckRequest) -> bytes:
    return _str_field(1, req.service)


def encode_health_response(resp: HealthCheckResponse) -> bytes:
    return _int_field(1, resp.status)


def decode_health_response(data: bytes) -> HealthCheckResponse:
    data = bytes(data)
    resp = HealthCheckResponse()
    for num, wire, v in _fields(data, 0, len(data)):
        if num == 1 and wire == 0:
            resp.status = _signed(v, 32)
    return resp


# ---- authzed.api.v1 PermissionsService.CheckPermission -----------------------

def encode_check_permission(resource_type: str, resource_id: str,
                            permission: str, subject_type: str,
                            subject_id: str) -> bytes:
    """CheckPermissionRequest: resource (2) {object_type (1), object_id (2)},
    permission (3), subject (4) {object (1) {object_type, object_id}};
    every field written, empty or not."""

    def obj_ref(t: str, i: str) -> bytes:
        return _ld(1, t.encode()) + _ld(2, i.encode())

    return (_ld(2, obj_ref(resource_type, resource_id))
            + _ld(3, permission.encode())
            + _ld(4, _ld(1, obj_ref(subject_type, subject_id))))


def decode_check_permission(data: bytes) -> int:
    """The permissionship (field 2) of a CheckPermissionResponse, read as
    the reference reads it, which fails closed: one-byte keys, the first
    varint field 2 with its whole value, 0 when absent or at the first
    field of a wire type other than varint or length-delimited.  Anything
    but 2 denies, so a response a strict protobuf parser would read as
    HAS_PERMISSION past an unexpected field still denies here.  A
    truncated varint raises IndexError, as the reference's does."""
    data = bytes(data)
    i = 0
    while i < len(data):
        key = data[i]
        field, wire = key >> 3, key & 7
        i += 1
        if wire not in (0, 2):
            break
        val = shift = 0
        while True:
            b = data[i]
            i += 1
            val |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        if wire == 0 and field == 2:
            return val
        if wire == 2:
            i += val
    return 0


def encode_check_permission_response(permissionship: int,
                                     token: str = "") -> bytes:
    """A CheckPermissionResponse: checked_at (1) {token (1)}, permissionship
    (2) (a SpiceDB's side, for fakes and tests)."""
    return _ld(1, _str_field(1, token)) + _int_field(2, permissionship)
