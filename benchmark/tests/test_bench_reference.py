"""The plain references on AuthConfigs and requests worked by hand, the
controls that break one guarantee, and the benchmark's protobuf codec."""

import json

import pytest

from harness.cells import load_cell
from harness.proto import (Response, decode_check_response, decode_struct,
                           encode_check_request)
from harness.requests import Request


def _northstar(n=3):
    cell = load_cell("northstar-1k.unique-sat")
    cfg = dict(cell.config, auth_configs=n)
    return cell.config_mod, cfg


def _apikey(n=3):
    cell = load_cell("apikey-1k.keys-sat")
    cfg = dict(cell.config, auth_configs=n)
    return cell.config_mod, cfg


def _req(host, method="GET", **headers):
    h = {":authority": host, ":method": method, ":path": "/x"}
    h.update({k.replace("_", "-"): v for k, v in headers.items()})
    return Request(method, "/x", host, h)


DENY = (("x-ext-auth-reason", "Unauthorized"),)


@pytest.mark.parametrize("req,want", [
    (_req("svc-1.bench", x_api_tier="tier-1"), Response(0, kind="ok")),
    (_req("svc-1.bench", "POST", x_attr_3="v-1-3"), Response(0, kind="ok")),
    (_req("svc-1.bench", "DELETE", x_api_tier="tier-1"),
     Response(7, kind="denied", http_status=403, headers=DENY,
              provenance="bench/cfg-1")),
    (_req("svc-1.bench", x_api_tier="tier-2", x_attr_3="v-2-3"),
     Response(7, kind="denied", http_status=403, headers=DENY,
              provenance="bench/cfg-1")),
    (_req("svc-2.bench"),
     Response(7, kind="denied", http_status=403, headers=DENY,
              provenance="bench/cfg-2")),
    (_req("svc-9.bench", x_api_tier="tier-9"),
     Response(5, kind="denied", http_status=404,
              headers=(("x-ext-auth-reason", "Service not found"),))),
])
def test_northstar_reference_by_hand(req, want):
    mod, cfg = _northstar()
    assert mod.Reference(cfg, 1).expected(req) == want


def test_northstar_manifests_state_the_rules():
    mod, cfg = _northstar()
    text = mod.manifests(cfg, 1)["authconfigs.yaml"]
    docs = [json.loads(d) for d in text.split("---\n")]
    assert [d["spec"]["hosts"] for d in docs] == [[f"svc-{i}.bench"]
                                                  for i in range(3)]
    pats = docs[1]["spec"]["authorization"]["rules"]["patternMatching"][
        "patterns"]
    assert pats[0] == {"selector": "request.method", "operator": "neq",
                       "value": "DELETE"}
    assert len(pats[1]["any"]) == 1 + cfg["attr_headers"]
    assert all(d["metadata"]["resourceVersion"] == "1" for d in docs)


def test_apikey_reference_by_hand():
    mod, cfg = _apikey()
    ks = mod.keys(cfg, 5)
    ref = mod.Reference(cfg, 5)
    admin0, user0 = ks[(0, "admin")], ks[(0, "user")]
    challenge0 = ("www-authenticate", 'APIKEY realm="keys-0"')
    assert ref.expected(_req("key-0.bench", authorization=f"APIKEY {user0}")) \
        == Response(0, kind="ok")
    assert ref.expected(_req("key-0.bench")) == Response(
        16, kind="denied", http_status=401,
        headers=(challenge0, ("x-ext-auth-reason", "credential not found")))
    assert ref.expected(_req("key-0.bench",
                             authorization=f"APIKEY {ks[(1, 'admin')]}")) \
        == Response(16, kind="denied", http_status=401, headers=(
            challenge0,
            ("x-ext-auth-reason", "the API Key provided is invalid")))
    assert ref.expected(_req("key-1.bench", x_api_key=ks[(1, "admin")])) == \
        Response(0, kind="ok")
    assert ref.expected(_req("key-1.bench", x_api_key=ks[(1, "user")])) == \
        Response(7, kind="denied", http_status=403, headers=DENY,
                 provenance="bench/key-1")
    assert ref.expected(_req("key-2.bench", x_api_key=ks[(2, "user")])) == \
        Response(7, kind="denied", http_status=403, provenance="bench/key-2",
                 headers=(("x-denied-user", "user-2"),
                          ("x-ext-auth-reason", "role user may not pass")))
    # an Authorization header without the prefix presents no key
    assert ref.expected(_req("key-0.bench", authorization=admin0)).code == 16


def test_apikey_manifests_select_each_configs_own_secrets():
    mod, cfg = _apikey()
    files = mod.manifests(cfg, 5)
    configs = [json.loads(d) for d in files["authconfigs.yaml"].split("---\n")]
    secrets = [json.loads(d) for d in files["secrets.yaml"].split("---\n")]
    assert len(secrets) == 2 * len(configs)
    for i, ac in enumerate(configs):
        sel = ac["spec"]["authentication"][f"keys-{i}"]["apiKey"]["selector"]
        mine = [s for s in secrets if all(
            s["metadata"]["labels"].get(k) == v
            for k, v in sel["matchLabels"].items())]
        assert sorted(s["metadata"]["annotations"]["role"] for s in mine) == \
            ["admin", "user"]
        assert ("authorization" in ac["spec"]) == (i % 3 != 0)
        assert ("response" in ac["spec"]) == (i % 3 == 2)


def test_controls_break_their_guarantee():
    mod, cfg = _northstar()
    ref = mod.Reference(cfg, 1)
    reqs = [_req("svc-1.bench", x_api_tier="tier-1"), _req("svc-1.bench")]
    assert ref.control(reqs)[1] != ref.expected(reqs[1])
    mod, cfg = _apikey()
    ks = mod.keys(cfg, 5)
    ref = mod.Reference(cfg, 5)
    foreign = _req("key-1.bench", x_api_key=ks[(2, "admin")])
    assert ref.expected(foreign).code == 16
    assert ref.control([foreign])[0] == Response(0, kind="ok")


def test_request_encoding_by_hand():
    b = encode_check_request("GET", "/p", "h", {"a": "b"})
    # attributes(1) { request(4) { http(2) { method(2) headers(3) path(4)
    # host(5) } } }
    http = b"\x12\x03GET" + b"\x1a\x06\x0a\x01a\x12\x01b" + b"\x22\x02/p" \
        + b"\x2a\x01h"
    assert b == b"\x0a" + bytes([len(http) + 4]) + b"\x22" + \
        bytes([len(http) + 2]) + b"\x12" + bytes([len(http)]) + http


def test_response_decoding_by_hand():
    # Struct{ext_authz_provenance: Struct{authconfig: "c"}}
    prov = b"\x0a\x0a\x61uthconfig\x12\x03\x1a\x01c"
    inner = b"\x0a" + bytes([len(prov)]) + prov
    value = b"\x2a" + bytes([len(inner)]) + inner
    entry = b"\x0a\x14ext_authz_provenance\x12" + bytes([len(value)]) + value
    struct = b"\x0a" + bytes([len(entry)]) + entry
    assert decode_struct(struct) == {"ext_authz_provenance": {
        "authconfig": "c"}}
    header = b"\x0a\x0a\x0a\x01X\x12\x05Nope!"
    denied = b"\x0a\x03\x08\x93\x03" + b"\x12" + bytes([len(header)]) + \
        header + b"\x1a\x04body"
    msg = b"\x0a\x02\x08\x07" + b"\x12" + bytes([len(denied)]) + denied + \
        b"\x22" + bytes([len(struct)]) + struct
    assert decode_check_response(msg) == Response(
        7, kind="denied", http_status=403, headers=(("x", "Nope!"),),
        body="body", provenance="c")
    assert decode_check_response(b"\x0a\x00\x1a\x00") == Response(0, kind="ok")
