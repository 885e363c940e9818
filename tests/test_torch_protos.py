"""The port's protobuf codec (``authorino_tpu_torch/protos/wire.py``) held
to the reference's generated pb2, both ways.

Requests: hypothesis draws CheckRequests (unicode headers and labels,
present but empty submessages, negative ``size``, ``raw_body`` bytes,
nested ``metadata_context`` Structs, timestamps with 0/ms/µs/ns fractions)
and splices unknown fields of every wire type into each message, a known
field with the wrong wire type, and an ``http`` sent in two halves; the
same bytes go through pb2 and the reference's ``request_model_from_proto``
and through the port's decoder and its ``request_model_from_proto``; the
CheckRequestModels are equal (a minted request id is checked for its
shape).  Responses: a table of AuthResults through the port's encoder
parses in pb2 equal to the reference's ``check_response_from_result``.
Health and SpiceDB messages equal the reference's bytes.  Tolerance 0."""

import dataclasses
import re

import numpy as np
import pytest
from google.protobuf import struct_pb2, timestamp_pb2
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from authorino_tpu import protos as ref_protos
from authorino_tpu.evaluators.authorization import authzed as ref_authzed
from authorino_tpu.pipeline.pipeline import AuthResult as RefAuthResult
from authorino_tpu.service import grpc_server as ref_grpc
from authorino_tpu_torch.pipeline.pipeline import AuthResult as PortAuthResult
from authorino_tpu_torch.protos import wire
from authorino_tpu_torch.service import grpc_server as port_grpc

pb = ref_protos.external_auth_pb2
ac_pb = ref_protos.attribute_context_pb2
addr_pb = ref_protos.address_pb2
health_pb = ref_protos.health_pb2

UUID4 = re.compile(r"^[0-9a-f]{8}-[0-9a-f]{4}-4[0-9a-f]{3}-[0-9a-f]{4}-"
                   r"[0-9a-f]{12}$")


# ---- wire helpers of the test's own (never the port's) -----------------------

def varint(n):
    n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def ld(num, payload):
    return varint((num << 3) | 2) + varint(len(payload)) + payload


UNKNOWN_NUMS = (13, 15, 20, 99, 1000, 536870911)


@st.composite
def unknown_fields(draw, taken=()):
    """Zero to three fields a message does not declare, of every wire
    type, groups with a nested field included."""
    out = b""
    for _ in range(draw(st.integers(0, 3))):
        num = draw(st.sampled_from([n for n in UNKNOWN_NUMS
                                    if n not in taken]))
        wt = draw(st.sampled_from((0, 1, 2, 3, 5)))
        key = varint((num << 3) | wt)
        if wt == 0:
            out += key + varint(draw(st.integers(0, 2 ** 64 - 1)))
        elif wt == 1:
            out += key + draw(st.binary(min_size=8, max_size=8))
        elif wt == 2:
            out += ld(num, draw(st.binary(max_size=12)))
        elif wt == 5:
            out += key + draw(st.binary(min_size=4, max_size=4))
        else:
            out += key + varint(8) + varint(5) + varint((num << 3) | 4)
    return out


text = st.text(max_size=12)
small_dict = st.dictionaries(text, text, max_size=4)
json_leaf = (st.none() | st.booleans() | text
             | st.floats(allow_nan=False, allow_infinity=False))
json_value = st.recursive(
    json_leaf, lambda inner: st.lists(inner, max_size=3)
    | st.dictionaries(text, inner, max_size=3), max_leaves=8)


@st.composite
def peer_bytes(draw):
    p = ac_pb.AttributeContext.Peer(
        service=draw(text), principal=draw(text), certificate=draw(text))
    for k, v in draw(small_dict).items():
        p.labels[k] = v
    if draw(st.booleans()):
        sa = p.address.socket_address
        sa.address = draw(text)
        sa.port_value = draw(st.integers(0, 2 ** 32 - 1))
    return p.SerializeToString() + draw(unknown_fields())


@st.composite
def http_bytes(draw):
    h = ac_pb.AttributeContext.HttpRequest(
        id=draw(st.sampled_from(("", "rid-1", "ñ-7"))), method=draw(text),
        path=draw(text), host=draw(text), scheme=draw(text),
        query=draw(text), fragment=draw(text), protocol=draw(text),
        body=draw(text), raw_body=draw(st.binary(max_size=16)),
        size=draw(st.sampled_from((0, -1, 7, -(2 ** 63), 2 ** 63 - 1))
                  | st.integers(-(2 ** 63), 2 ** 63 - 1)))
    for k, v in draw(small_dict).items():
        h.headers[k] = v
    data = h.SerializeToString()
    if draw(st.booleans()):
        # a known field (method, 2) sent as a varint: an unknown field
        data += varint((2 << 3) | 0) + varint(5)
    return data + draw(unknown_fields())


@st.composite
def check_request_bytes(draw):
    """The bytes of a CheckRequest with unknown fields at every level, or
    None where a submessage is absent."""
    if draw(st.integers(0, 9)) == 0:
        return draw(unknown_fields(taken=(1,)))   # no attributes
    attrs = b""
    for num in (1, 2):
        if draw(st.booleans()):
            attrs += ld(num, draw(peer_bytes()))
    if draw(st.integers(0, 7)):
        req = b""
        if draw(st.booleans()):
            ns = draw(st.sampled_from((0, 5_000_000, 7_000, 123_456_789))
                      if draw(st.booleans()) else st.just(0))
            ts = timestamp_pb2.Timestamp(
                seconds=draw(st.integers(-62135596800, 253402300799)),
                nanos=ns)
            req += ld(1, ts.SerializeToString())
        if draw(st.integers(0, 7)):
            hb = draw(http_bytes())
            if draw(st.booleans()) and hb:
                cut = draw(st.integers(0, 1))
                # the http submessage in two halves (fields split at a
                # field boundary: the first half is a whole message)
                first = ac_pb.AttributeContext.HttpRequest(
                    method="FIRST" if cut else "")
                req += ld(2, first.SerializeToString())
            req += ld(2, hb)
        attrs += ld(4, req + draw(unknown_fields(taken=(1, 2))))
    for k, v in draw(small_dict).items():
        attrs += ld(10, ld(1, k.encode()) + ld(2, v.encode()))
    if draw(st.booleans()):
        md = b""
        for key, val in draw(st.dictionaries(text, st.dictionaries(
                text, json_value, max_size=3), max_size=2)).items():
            s = struct_pb2.Struct()
            s.update(val)
            md += ld(1, ld(1, key.encode()) + ld(2, s.SerializeToString()))
        attrs += ld(11, md)
    attrs += draw(unknown_fields(taken=(1, 2, 4, 10, 11)))
    return ld(1, attrs) + draw(unknown_fields(taken=(1,)))


def model_dict(model):
    d = dataclasses.asdict(model)
    d["http"]["raw_body"] = bytes(d["http"]["raw_body"])
    return d


def same_model(ref_model, port_model, sent_id):
    if ref_model is None:
        assert port_model is None
        return
    r, p = model_dict(ref_model), model_dict(port_model)
    if not sent_id:
        assert UUID4.match(r["http"]["id"]) and UUID4.match(p["http"]["id"])
        r["http"]["id"] = p["http"]["id"] = ""
    assert p == r


@settings(max_examples=250, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(check_request_bytes())
def test_decoded_request_equals_the_references(data):
    ref_msg = pb.CheckRequest.FromString(data)
    port_msg = wire.decode_check_request(data)
    sent_id = ref_msg.attributes.request.http.id
    same_model(ref_grpc.request_model_from_proto(ref_msg),
               port_grpc.request_model_from_proto(port_msg), sent_id)
    # presence as HasField reads it
    assert (port_msg.attributes is not None) == ref_msg.HasField("attributes")
    if port_msg.attributes is not None:
        a, ra = port_msg.attributes, ref_msg.attributes
        assert (a.request is not None) == ra.HasField("request")
        assert (a.metadata_context is not None) == ra.HasField(
            "metadata_context")
        if a.request is not None:
            assert (a.request.http is not None) == ra.request.HasField("http")
            assert (a.request.time is not None) == ra.request.HasField("time")


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(check_request_bytes())
def test_client_encoding_parses_equal_in_pb2(data):
    """What the port's client side writes parses in pb2 to the message the
    decoded bytes held (unknown fields aside)."""
    port_msg = wire.decode_check_request(data)
    again = pb.CheckRequest.FromString(wire.encode_check_request(port_msg))
    ref = pb.CheckRequest.FromString(data)
    ref.DiscardUnknownFields()
    # an empty peer or socket address is present in ``ref`` and left out
    # by the client encoder: compare what the server reads
    same_model(ref_grpc.request_model_from_proto(ref),
               ref_grpc.request_model_from_proto(again),
               ref.attributes.request.http.id)


@pytest.mark.parametrize("case", ["empty-http", "size--1", "invalid-utf8",
                                  "truncated", "field-0", "group",
                                  "bad-wire", "map-last-wins",
                                  "pipe-clears-socket", "named-port",
                                  "struct-dup-key", "value-oneof",
                                  "nan-metadata", "bad-timestamp"])
def test_edge_cases_as_upb(case):
    """The edge cases one by one: what pb2 (upb) accepts the port accepts
    with the same model; what it rejects the port rejects."""
    http = ac_pb.AttributeContext.HttpRequest
    if case == "empty-http":
        m = pb.CheckRequest()
        m.attributes.request.http.SetInParent()
        data = m.SerializeToString()
    elif case == "size--1":
        m = pb.CheckRequest()
        m.attributes.request.http.size = -1
        data = m.SerializeToString()
        assert len(varint(-1)) == 10
    elif case == "invalid-utf8":
        data = ld(1, ld(4, ld(2, ld(2, b"\xff"))))
    elif case == "truncated":
        data = ld(1, ld(4, ld(2, ld(2, b"GET"))))[:-1]
    elif case == "field-0":
        data = ld(1, ld(4, ld(2, b"\x00\x01")))
    elif case == "group":
        data = ld(1, ld(4, ld(2, bytes([0x7b, 0x08, 0x01, 0x7c])
                             + ld(2, b"GET"))))
    elif case == "bad-wire":
        data = ld(1, ld(4, ld(2, bytes([0x7e]))))
    elif case == "map-last-wins":
        data = ld(1, ld(4, ld(2, ld(3, ld(1, b"k") + ld(2, b"a"))
                             + ld(3, ld(1, b"k") + ld(2, b"b")))))
    elif case == "pipe-clears-socket":
        sock = addr_pb.SocketAddress(address="1.2.3.4", port_value=8)
        data = ld(1, ld(1, ld(1, ld(1, sock.SerializeToString())
                             + ld(2, ld(1, b"/tmp/s"))))
                  + ld(4, ld(2, b"")))
    elif case == "named-port":
        data = ld(1, ld(1, ld(1, ld(1, bytes([0x18, 0x05]) + ld(4, b"h"))))
                  + ld(4, ld(2, b"")))
    elif case == "struct-dup-key":
        s1, s2 = struct_pb2.Struct(), struct_pb2.Struct()
        s1.update({"a": 1})
        s2.update({"b": [True, None]})
        md = (ld(1, ld(1, b"f") + ld(2, s1.SerializeToString()))
              + ld(1, ld(1, b"f") + ld(2, s2.SerializeToString())))
        data = ld(1, ld(4, ld(2, b"")) + ld(11, md))
    elif case == "value-oneof":
        v1, v2, v3 = struct_pb2.Value(), struct_pb2.Value(), struct_pb2.Value()
        v1.struct_value.update({"a": 1})
        v2.struct_value.update({"b": 2})
        v3.number_value = 3
        s = (ld(1, ld(1, b"x") + ld(2, v1.SerializeToString()
                                    + v2.SerializeToString()))
             + ld(1, ld(1, b"y") + ld(2, v1.SerializeToString()
                                      + v3.SerializeToString()
                                      + v2.SerializeToString()))
             + ld(1, ld(1, b"z") + ld(2, b"")))
        data = ld(1, ld(4, ld(2, b"")) + ld(11, ld(1, ld(1, b"f")
                                                   + ld(2, s))))
    elif case == "nan-metadata":
        s = struct_pb2.Struct()
        s.update({"n": float("nan")})
        data = ld(1, ld(4, ld(2, b"")) + ld(11, ld(1, ld(1, b"f")
                                                   + ld(2, s.SerializeToString()))))
    else:  # bad-timestamp: nanos out of range
        data = ld(1, ld(4, ld(1, bytes([0x10]) + varint(-1)) + ld(2, b"")))
    try:
        ref_msg = pb.CheckRequest.FromString(data)
    except Exception:
        with pytest.raises(wire.DecodeError):
            wire.decode_check_request(data)
        return
    port_msg = wire.decode_check_request(data)
    try:
        ref_model = ref_grpc.request_model_from_proto(ref_msg)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e)[:20])):
            port_grpc.request_model_from_proto(port_msg)
        return
    same_model(ref_model, port_grpc.request_model_from_proto(port_msg),
               ref_msg.attributes.request.http.id)


# ---- the CheckResponse --------------------------------------------------------

RESULTS = [
    dict(code=0),
    dict(code=0, headers=[{"x-ext-auth-data": "{\"a\":1}"},
                          {"x-user": "ñandú"}]),
    dict(code=7, message="Unauthorized"),
    dict(code=16, message="credential not found", body="denied",
         headers=[{"WWW-Authenticate": "Bearer realm=\"a\""},
                  {"WWW-Authenticate": "APIKEY realm=\"b\""}]),
    dict(code=7, status=418, message="teapot"),
    dict(code=7, status=302, headers=[{"Location": "https://login/x?y=1"}]),
    dict(code=5, message="Service not found"),
    dict(code=14, message="policy evaluation unavailable"),
    dict(code=0, metadata={"ext": {"user": "a", "n": 3, "f": 2.5,
                                   "ok": True, "none": None,
                                   "list": [1, "x", [False]],
                                   "tuple": ("a", {"b": -1})}}),
    dict(code=7, message="Unauthorized",
         metadata={"ext_authz_provenance": {"authconfig": "ns/a",
                                            "rule": "0:(x == y)",
                                            "lane": "engine"}}),
    dict(code=0, headers=[{"a": "b"}], metadata={"bad": b"bytes"}),
    dict(code=7, message="m", metadata={"bad": np.int64(3)}),
    dict(code=0, metadata={1: "int key"}),
    dict(code=0, metadata={"big": 10 ** 400}),
    dict(code=0, metadata={"np": np.float64(1.5), "b": np.bool_(True)}),
]


@pytest.mark.parametrize("i", range(len(RESULTS)))
def test_check_response_parses_equal_to_the_references(i):
    fields = RESULTS[i]
    want = ref_grpc.check_response_from_result(RefAuthResult(**fields))
    resp = port_grpc.check_response_from_result(PortAuthResult(**fields))
    got = pb.CheckResponse.FromString(wire.encode_check_response(resp))
    assert got == want
    assert got.WhichOneof("http_response") == (
        "denied_response" if resp.denied_response is not None
        else "ok_response")


@settings(max_examples=200, deadline=None)
@given(st.dictionaries(text, json_value | st.tuples(json_leaf, json_leaf)
                       | st.integers(-(2 ** 70), 2 ** 70), max_size=4))
def test_struct_encoding_is_struct_update(value):
    want = struct_pb2.Struct()
    want.update(value)
    got = struct_pb2.Struct.FromString(wire.encode_struct(value))
    assert got == want


def test_health_and_spicedb_bytes_equal_the_references():
    assert wire.encode_health_response(wire.HealthCheckResponse(
        status=wire.SERVING)) == health_pb.HealthCheckResponse(
            status=health_pb.HealthCheckResponse.SERVING).SerializeToString()
    for svc in ("", "envoy.service.auth.v3.Authorization"):
        data = health_pb.HealthCheckRequest(service=svc).SerializeToString()
        assert wire.encode_health_request(wire.HealthCheckRequest(svc)) == data
        assert wire.decode_health_request(data).service == svc
    for args in (("doc", "1", "read", "user", "alice"),
                 ("", "", "", "", ""), ("dóc", "x" * 200, "w", "u", "ñ")):
        assert wire.encode_check_permission(*args) == \
            ref_authzed._encode_check_request(*args)
    for perm in (0, 1, 2, 3):
        for token in ("", "zed-token"):
            resp = wire.encode_check_permission_response(perm, token)
            assert wire.decode_check_permission(resp) == \
                ref_authzed._decode_check_response(resp) == perm


def _decoded(fn, data):
    try:
        return fn(data)
    except IndexError:
        return "truncated"


# (bytes, what the reference decodes): a SpiceDB writing each field once,
# in number order, then four answers a strict protobuf parser would read
# as HAS_PERMISSION (2) but the reference does not
SPICEDB_ANSWERS = [
    (ld(1, ld(1, b"tok")) + b"\x10\x02", 2),
    (b"\x35\x00\x00\x00\x00\x10\x02", 0),           # fixed32 field 6 first
    (b"\x10\x01\x10\x02", 1),                       # field 2 twice
    (varint(16 << 3) + b"\x01\x10\x02", 0),         # two-byte key first
    (b"\x10" + varint((1 << 32) + 2), (1 << 32) + 2),
]


@pytest.mark.parametrize("data,want", SPICEDB_ANSWERS, ids=[
    "canonical", "fixed32-first", "field2-twice", "two-byte-key",
    "past-int32"])
def test_spicedb_answer_decodes_as_the_reference(data, want):
    assert wire.decode_check_permission(data) == \
        ref_authzed._decode_check_response(data) == want


@settings(max_examples=300, deadline=None)
@given(st.binary(max_size=24) | st.lists(
    st.sampled_from([b"\x10\x02", b"\x10\x01", b"\x08\x05", b"\x0a\x00",
                     b"\x35\x00\x00\x00\x00", b"\x80\x01\x01", b"\x12\x01x",
                     b"\x10\xff", b"\x10\x82\x80\x80\x80\x10"]),
    max_size=6).map(b"".join))
def test_spicedb_answer_decodes_as_the_reference_on_drawn_bytes(data):
    assert _decoded(wire.decode_check_permission, data) == \
        _decoded(ref_authzed._decode_check_response, data)


def test_timestamps_print_as_to_json_string():
    ts_pb = timestamp_pb2.Timestamp
    for secs in (0, 1, 1_700_000_000, -1, -62135596800, 253402300799):
        for ns in (0, 1_000_000, 5_000, 1, 999_999_999):
            want = ts_pb(seconds=secs, nanos=ns).ToJsonString()
            assert wire.Timestamp(secs, ns).ToJsonString() == want
    for secs, ns in ((253402300800, 0), (0, -1), (0, 10 ** 9)):
        with pytest.raises(ValueError):
            ts_pb(seconds=secs, nanos=ns).ToJsonString()
        with pytest.raises(ValueError):
            wire.Timestamp(secs, ns).ToJsonString()
