"""The few protobuf messages the benchmark speaks, in plain Python.

Envoy's ``envoy.service.auth.v3.CheckRequest`` is written with only the
fields a benchmark request carries (``attributes.request.http``: method,
headers, path, host), and ``CheckResponse`` is read back whole (status,
denied or ok response with headers and body, whether dynamic metadata
came and what it names).  Field numbers are Envoy's (``external_auth.proto``,
``attribute_context.proto``) and google.rpc's ``Status``.
"""

from __future__ import annotations

import functools
import struct
from typing import Dict, List, Optional, Tuple

__all__ = ["encode_check_request", "decode_check_response", "decode_struct",
           "Response"]


_ONE_BYTE = [bytes([n]) for n in range(128)]


def _varint(n: int) -> bytes:
    if n < 128:
        return _ONE_BYTE[n]
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _ld(field: int, payload: bytes) -> bytes:
    """A length-delimited field (wire type 2)."""
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def _s(field: int, text: str) -> bytes:
    return _ld(field, text.encode()) if text else b""


@functools.lru_cache(maxsize=1 << 16)
def _text(field: int, text: str) -> bytes:
    return _s(field, text)


@functools.lru_cache(maxsize=1 << 16)
def _entry(key: str, value: str) -> bytes:
    """One headers map entry (HttpRequest field 3); entries repeat across
    requests, so each is encoded once."""
    return _ld(3, _s(1, key) + _s(2, value))


def encode_check_request(method: str, path: str, host: str,
                         headers: Dict[str, str]) -> bytes:
    """CheckRequest{attributes{request{http{method, headers, path,
    host}}}}; header entries in the order given."""
    http = b"".join([_entry(k, v) for k, v in headers.items()])
    http = _text(2, method) + http + _text(4, path) + _text(5, host)
    return _ld(1, _ld(4, _ld(2, http)))


def _fields(buf: bytes) -> List[Tuple[int, int, object]]:
    """(field number, wire type, value) of one message, in order: a
    varint as int, a length-delimited field as bytes."""
    out, i, n = [], 0, len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        num, wt = key >> 3, key & 7
        if wt == 0:
            val, i = _read_varint(buf, i)
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            if i + ln > n:
                raise ValueError("truncated length-delimited field")
            val, i = buf[i:i + ln], i + ln
        elif wt == 1:
            val, i = buf[i:i + 8], i + 8
        elif wt == 5:
            val, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"wire type {wt}")
        out.append((num, wt, val))
    return out


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = val = 0
    while True:
        if i >= len(buf):
            raise ValueError("truncated varint")
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _headers(entries: List[bytes]) -> Tuple[Tuple[str, str], ...]:
    """HeaderValueOption{header{key, value}} entries, sorted by key then
    value: Envoy applies them as a set."""
    out = []
    for raw in entries:
        key = value = ""
        for num, _, hv in _fields(raw):
            if num == 1:
                for n2, _, v in _fields(hv):
                    if n2 == 1:
                        key = v.decode()
                    elif n2 == 2:
                        value = v.decode()
        out.append((key.lower(), value))
    return tuple(sorted(out))


class Response(tuple):
    """A decoded CheckResponse as a comparable tuple: (rpc code, rpc
    message, kind, http status, headers, body, provenance); kind is
    "denied", "ok" or "" (neither); provenance is the AuthConfig that
    the dynamic metadata's ``ext_authz_provenance`` names, "" where it
    names none, None where the response carries no dynamic metadata."""

    __slots__ = ()
    FIELDS = ("code", "message", "kind", "http_status", "headers", "body",
              "provenance")

    def __new__(cls, code: int, message: str = "", kind: str = "",
                http_status: int = 0, headers=(), body: str = "",
                provenance: Optional[str] = None):
        return super().__new__(cls, (code, message, kind, http_status,
                                     tuple(sorted(headers)), body,
                                     provenance))

    def __getnewargs__(self):
        return tuple(self)

    def __getattr__(self, name):
        try:
            return self[Response.FIELDS.index(name)]
        except ValueError:
            raise AttributeError(name) from None

    def to_json(self) -> dict:
        return dict(zip(Response.FIELDS, self))


def decode_struct(buf: bytes) -> dict:
    """google.protobuf.Struct as a dict (numbers as float, lists as
    lists)."""
    out = {}
    for num, _, entry in _fields(buf):
        if num != 1:
            continue
        key, value = "", None
        for n2, _, v in _fields(entry):
            if n2 == 1:
                key = v.decode()
            elif n2 == 2:
                value = _decode_value(v)
        out[key] = value
    return out


def _decode_value(buf: bytes):
    value = None
    for num, wt, v in _fields(buf):
        if num == 1:
            value = None
        elif num == 2:
            value = struct.unpack("<d", v)[0]
        elif num == 3:
            value = v.decode()
        elif num == 4:
            value = bool(v)
        elif num == 5:
            value = decode_struct(v)
        elif num == 6:
            value = [_decode_value(x) for n3, _, x in _fields(v) if n3 == 1]
    return value


def decode_check_response(buf: bytes) -> Response:
    code, message, kind, http_status, body = 0, "", "", 0, ""
    headers: List[bytes] = []
    provenance = None
    for num, _, val in _fields(buf):
        if num == 1:
            for n2, _, v in _fields(val):
                if n2 == 1:
                    code = v
                elif n2 == 2:
                    message = v.decode()
        elif num in (2, 3):
            kind = "denied" if num == 2 else "ok"
            for n2, _, v in _fields(val):
                if num == 2 and n2 == 1:
                    http_status = dict((a, c) for a, _, c in _fields(v)).get(1, 0)
                elif n2 == 2:
                    headers.append(v)
                elif num == 2 and n2 == 3:
                    body = v.decode()
        elif num == 4:
            prov = decode_struct(val).get("ext_authz_provenance")
            provenance = prov.get("authconfig", "") if isinstance(prov, dict) \
                else ""
    return Response(code, message, kind, http_status, _headers(headers), body,
                    provenance)
