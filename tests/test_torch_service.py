"""The port's serving surfaces beside the reference's, on CPU engines over
the same translated specs (tolerance 0):

* gRPC ext_authz: the same serialized CheckRequest bytes go to both
  servers (``service/grpc_server.py``) and the CheckResponses parse equal
  in the reference's pb2 — the cases of tests/test_service_grpc.py (allow,
  deny with reason, NOT_FOUND, the ``context_extensions`` host,
  INVALID_ARGUMENT, health) and three corpora: a small north-star, the
  API-key control-plane corpus and x509 with the PEM in
  ``source.certificate``;
* HTTP /check (``service/http_server.py``): the cases of
  tests/test_service_http.py (allow, deny with reason, the ``:port``
  strip, a wildcard host, 413, AdmissionReview, repeated
  WWW-Authenticate, the deadline header) answer the same status, headers
  and body; the debug routes of unported planes never become a Check();
* tests/test_tls_listeners.py's three cases on certificates made by the
  port's own writer;
* OIDC discovery and JWKS bodies; the webhooks on the cases of
  tests/test_leader_and_webhooks.py;
* SpiceDB allow, deny and an unreachable endpoint against a fake
  CheckPermission server on loopback."""

import asyncio
import datetime
import json
import random
import ssl

import grpc
import pytest
from aiohttp.test_utils import TestClient, TestServer

from authorino_tpu import protos as ref_protos
from authorino_tpu.service import grpc_server as ref_grpc
from authorino_tpu.service import http_server as ref_http
from authorino_tpu.service import oidc_server as ref_oidc
from authorino_tpu.service import webhooks as ref_webhooks
from authorino_tpu_torch import cli as port_cli
from authorino_tpu_torch.apis import to_v1beta2
from authorino_tpu_torch.models import control_plane as cp
from authorino_tpu_torch.models import northstar
from authorino_tpu_torch.protos import wire
from authorino_tpu_torch.service import grpc_server as port_grpc
from authorino_tpu_torch.service import http_server as port_http
from authorino_tpu_torch.service import oidc_server as port_oidc
from authorino_tpu_torch.service import webhooks as port_webhooks
from authorino_tpu_torch.utils import pki

from test_leader_and_webhooks import SPEC as WEBHOOK_SPEC
from test_leader_and_webhooks import make_resource
from test_torch_check import WRISTBAND_SECRET, cluster_of
from test_torch_pipeline import PORT, REF, engine_of, result_fields, run

pb = ref_protos.external_auth_pb2
health_pb = ref_protos.health_pb2
CHECK = "/envoy.service.auth.v3.Authorization/Check"
HEALTH = "/grpc.health.v1.Health/Check"
RAW = {"request_serializer": lambda b: b, "response_deserializer": lambda b: b}
TIMEOUT = 60


def anon(hosts, authorization=None, **spec):
    out = {"hosts": hosts, "authentication": {"anon": {"anonymous": {}}}}
    if authorization:
        out["authorization"] = authorization
    out.update(spec)
    return out


def pattern(*items):
    return {"patternMatching": {"patterns": list(items)}}


def eq(sel, value, op="eq"):
    return {"selector": sel, "operator": op, "value": value}


KEYS = {"matchLabels": {"audience": "talker-api"}}
KEY_SECRET = {"name": "client-1", "namespace": "t",
              "labels": {"audience": "talker-api"},
              "data": {"api_key": b"secret-key-1"}}

# the configs of tests/test_service_{grpc,http}.py as AuthConfig specs
SERVICE_SPECS = [
    ("cfg", anon(["svc.example.com"], {"org": pattern(
        eq("request.headers.x-org", "acme"))})),
    ("talker-api", anon(
        ["talker-api.example.com", "*.wild.example.com"],
        {"tier-check": dict(pattern(
            eq("request.headers.x-api-tier", "gold"),
            eq("request.method", "DELETE", "neq")),
            when=[eq("request.url_path", "^/protected", "matches")])},
        response={"success": {"headers": {"x-auth-data": {"json": {
            "properties": {"tier": {
                "selector": "request.headers.x-api-tier"}}}}}}})),
    ("tier", anon(["tier.example.com"], {"tier": pattern(
        eq("request.headers.x-api-tier", "gold"))})),
    ("w", anon(["webhook.example.com"], {"no-delete": pattern(
        eq("request.body.@fromstr.request.operation", "DELETE", "neq"))})),
    ("keys", {"hosts": ["keys.example.com"], "authentication": {
        "header-key": {"apiKey": {"selector": KEYS},
                       "credentials": {"customHeader": {"name": "x-api-key"}}},
        "query-key": {"apiKey": {"selector": KEYS},
                      "credentials": {"queryString": {"name": "key"}}}},
        "authorization": {"get": pattern(eq("request.method", "GET"))}}),
]


def translated_engines(specs, secrets=(), namespace="t"):
    """(reference engine, port engine) with ``specs`` [(name, spec)]
    translated by each package into one snapshot."""
    engines = []
    for ns in (REF, PORT):
        engine = engine_of(ns, max_batch=16)
        cluster = cluster_of(ns, secrets)

        async def body(ns=ns, engine=engine, cluster=cluster):
            return [await ns.controllers.translate_auth_config(
                name, namespace, spec, cluster=cluster, engine=engine)
                for name, spec in specs]

        engine.apply_snapshot(run(body()))
        engines.append(engine)
    return engines


async def grpc_answers(engines, payloads, timeout=None):
    """Each payload's CheckResponse bytes from the reference's and the
    port's gRPC server, sent concurrently over one channel each."""
    servers = [ref_grpc.build_server(engines[0], address="127.0.0.1:0"),
               port_grpc.build_server(engines[1], address="127.0.0.1:0")]
    for s in servers:
        await s.start()
    try:
        out = []
        for s in servers:
            async with grpc.aio.insecure_channel(
                    f"127.0.0.1:{s.bound_port}") as ch:
                call = ch.unary_unary(CHECK, **RAW)
                out.append(await asyncio.wait_for(asyncio.gather(
                    *(call(p, timeout=timeout) for p in payloads)), TIMEOUT))
        return out
    finally:
        for s in servers:
            await s.stop(None)


def grpc_parity(engines, payloads, timeout=None):
    ref_out, port_out = run(grpc_answers(engines, payloads, timeout))
    got = [pb.CheckResponse.FromString(b) for b in port_out]
    want = [pb.CheckResponse.FromString(b) for b in ref_out]
    for k, (g, w) in enumerate(zip(got, want)):
        assert g == w, (k, g, w)
    return got


def model_bytes(model):
    return wire.encode_check_request(port_grpc.request_proto_from_model(model))


def check_request(host="svc.example.com", org="acme", ctx_host=None):
    req = pb.CheckRequest()
    http = req.attributes.request.http
    http.method = "GET"
    http.path = "/hello"
    http.host = host
    http.headers["x-org"] = org
    http.headers["host"] = host
    if ctx_host:
        req.attributes.context_extensions["host"] = ctx_host
    return req


@pytest.fixture(scope="module")
def service_engines():
    return translated_engines(SERVICE_SPECS, [KEY_SECRET])


def test_grpc_cases_of_the_reference(service_engines):
    """tests/test_service_grpc.py's cases, the ``:port`` strip, an API key
    in a header and in the query, none (two challenges), and a Check()
    deadline."""
    reqs = [check_request(org="acme"), check_request(org="evil"),
            check_request(host="nope.example.com"),
            check_request(host="nope.example.com",
                          ctx_host="svc.example.com"),
            pb.CheckRequest(), check_request(host="svc.example.com:8080")]
    for path, headers in (("/", {"x-api-key": "secret-key-1"}),
                          ("/?key=secret-key-1", {}), ("/", {}),
                          ("/", {"x-api-key": "wrong"})):
        r = pb.CheckRequest()
        r.attributes.request.http.method = "GET"
        r.attributes.request.http.path = path
        r.attributes.request.http.host = "keys.example.com"
        for k, v in headers.items():
            r.attributes.request.http.headers[k] = v
        reqs.append(r)
    got = grpc_parity(service_engines,
                      [r.SerializeToString() for r in reqs], timeout=30)
    codes = [g.status.code for g in got]
    assert codes == [0, 7, 5, 0, 3, 0, 0, 0, 16, 16]
    assert got[0].WhichOneof("http_response") == "ok_response"
    assert got[1].denied_response.status.code == 403
    reasons = {h.header.key: h.header.value
               for h in got[1].denied_response.headers}
    assert reasons.get("X-Ext-Auth-Reason") == "Unauthorized"
    assert got[2].denied_response.status.code == 404
    challenges = [h.header.value for h in got[8].denied_response.headers
                  if h.header.key == "WWW-Authenticate"]
    assert len(challenges) == 2


def test_grpc_health_and_deadline(service_engines):
    async def body():
        server = port_grpc.build_server(service_engines[1],
                                        address="127.0.0.1:0")
        await server.start()
        try:
            async with grpc.aio.insecure_channel(
                    f"127.0.0.1:{server.bound_port}") as ch:
                health = ch.unary_unary(HEALTH, **RAW)
                hr = health_pb.HealthCheckResponse.FromString(
                    await asyncio.wait_for(health(
                        health_pb.HealthCheckRequest().SerializeToString()),
                        TIMEOUT))
                check = ch.unary_unary(CHECK, **RAW)
                # a Check() deadline reaches the engine: an allow within it
                resp = pb.CheckResponse.FromString(await asyncio.wait_for(
                    check(check_request().SerializeToString(), timeout=20),
                    TIMEOUT))
                return hr, resp
        finally:
            await server.stop(None)

    hr, resp = run(body())
    assert hr.status == health_pb.HealthCheckResponse.SERVING
    assert resp.status.code == 0


def test_grpc_northstar_corpus_equals_the_reference():
    n = 12
    specs = [(o["metadata"]["name"], o["spec"])
             for o in northstar.build_auth_configs(n, 4)]
    engines = translated_engines(specs)
    reqs = northstar.build_check_requests(48, n)
    got = grpc_parity(engines, [model_bytes(r) for r in reqs])
    assert {g.status.code for g in got} == {0, 7}


def api_key_corpus(n):
    specs = [(o["metadata"]["name"], to_v1beta2(json.loads(json.dumps(o)))
              ["spec"]) for o in cp.build_auth_configs(n, 4)]
    secrets = []
    for i in range(n):
        doc = cp.api_key_secret(i)
        secrets.append({"name": doc["metadata"]["name"],
                        "namespace": cp.NAMESPACE, "labels": doc["metadata"]["labels"],
                        "data": {"api_key": doc["stringData"]["api_key"]
                                 .encode()}})
    return specs, secrets


def test_grpc_api_key_corpus_equals_the_reference_and_the_oracle():
    n = 8
    specs, secrets = api_key_corpus(n)
    engines = translated_engines(specs, secrets, cp.NAMESPACE)
    reqs, cfgs, known = cp.build_check_requests(64, n)
    got = grpc_parity(engines, [model_bytes(r) for r in reqs])
    rules = cp.config_rules(n, 4)
    want = [cp.expected_code(q, i, rules, good)
            for q, i, good in zip(reqs, cfgs, known)]
    assert [g.status.code for g in got] == want


def test_grpc_x509_corpus_equals_the_reference():
    rng = random.Random(3)
    O = cp.OID
    ca = cp.CertAuthority(pki.generate_ec_private_key(pki.P256, rng),
                          [[(O["CN"], "clients")]])
    foreign = cp.CertAuthority(pki.generate_ec_private_key(pki.P256, rng),
                               [[(O["CN"], "clients")]])
    specs, secrets = [], []
    for k in range(2):
        doc = cp.mtls_auth_config(k)
        specs.append((doc["metadata"]["name"], doc["spec"]))
    secrets.append({"name": "ca", "namespace": cp.NAMESPACE,
                    "labels": dict(cp.CA_LABEL),
                    "data": {"ca.crt": ca.pem}})
    engines = translated_engines(specs, secrets, cp.NAMESPACE)
    payloads = []
    for k in range(2):
        for cert in (ca.issue([[(O["O"], f"org-{k}")]]),
                     ca.issue([[(O["O"], "org-9")]]),
                     ca.issue([[(O["O"], f"org-{k}")]], valid_from_days=-30,
                              valid_days=10),
                     foreign.issue([[(O["O"], f"org-{k}")]]), b""):
            r = pb.CheckRequest()
            r.attributes.request.http.method = "GET"
            r.attributes.request.http.host = cp.MTLS_HOST.format(k=k)
            r.attributes.source.certificate = cert.decode()
            payloads.append(r.SerializeToString())
    got = grpc_parity(engines, payloads)
    assert [g.status.code for g in got] == [0, 7, 16, 16, 16] * 2


# ---- HTTP /check -------------------------------------------------------------

async def http_answers(apps, requests):
    """Each (method, path, headers, body) through both apps: (status,
    reason, every WWW-Authenticate, x-auth-data, body)."""
    out = []
    for app in apps:
        async with TestClient(TestServer(app)) as client:
            rows = []
            for method, path, headers, body in requests:
                r = await asyncio.wait_for(client.request(
                    method, path, headers=headers, data=body), TIMEOUT)
                rows.append((r.status, r.headers.get("X-Ext-Auth-Reason"),
                             r.headers.getall("WWW-Authenticate", []),
                             r.headers.get("x-auth-data"), await r.text()))
            out.append(rows)
    return out


def test_http_cases_of_the_reference(service_engines):
    review = {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
              "request": {"uid": "abc-123", "operation": "CREATE"}}
    deleting = json.loads(json.dumps(review))
    deleting["request"]["operation"] = "DELETE"

    def get(host, **h):
        return ("GET", "/check", dict(h, Host=host), None)

    requests = [
        get("talker-api.example.com", **{"X-Api-Tier": "gold"}),
        get("talker-api.example.com", **{"X-Api-Tier": "bronze"}),
        get("unknown.example.com", **{"X-Api-Tier": "gold"}),
        get("deep.wild.example.com", **{"X-Api-Tier": "gold"}),
        get("tier.example.com", **{"X-Api-Tier": "gold"}),
        get("tier.example.com", **{"X-Api-Tier": "bronze"}),
        get("tier.example.com:8000", **{"X-Api-Tier": "bronze"}),
        ("POST", "/check", {"Host": "webhook.example.com"}, json.dumps(review)),
        ("POST", "/check", {"Host": "webhook.example.com"},
         json.dumps(deleting)),
        get("keys.example.com"),
        get("keys.example.com", **{"X-Api-Key": "secret-key-1"}),
        ("GET", "/any/path?key=secret-key-1", {"Host": "keys.example.com"},
         None),
        get("tier.example.com", **{"X-Api-Tier": "gold",
                                   "x-envoy-expected-rq-timeout-ms": "0"}),
        get("tier.example.com", **{"X-Api-Tier": "gold",
                                   "x-envoy-expected-rq-timeout-ms": "x"}),
        ("POST", "/check", {"Host": "tier.example.com"}, b"x" * 200),
    ]
    apps = [ref_http.build_app(service_engines[0], max_body=128),
            port_http.build_app(service_engines[1], max_body=128)]
    ref_rows, port_rows = run(http_answers(apps, requests))
    assert port_rows == ref_rows
    assert [r[0] for r in port_rows] == [200, 200, 404, 200, 200, 403, 403,
                                         200, 200, 401, 200, 200, 504, 200,
                                         413]
    assert port_rows[2][1] == "Service not found"
    assert port_rows[5][1] == "Unauthorized"
    assert len(port_rows[9][2]) == 2   # one challenge per identity config
    assert json.loads(port_rows[7][4])["response"] == {
        "uid": "abc-123", "allowed": True}
    assert json.loads(port_rows[8][4])["response"]["allowed"] is False


def test_http_concurrent_checks_and_surfaces(service_engines):
    """16 concurrent /check requests coalesce and answer as the reference
    does; /healthz, /readyz, /metrics and /debug/vars answer; /debug/canary
    answers GET and POST with the reference's JSON; the routes of unported
    planes are never a Check()."""

    async def canary_answers(app):
        out = []
        async with TestClient(TestServer(app)) as client:
            for method, path in (("GET", "/debug/canary"),
                                 ("POST", "/debug/canary?action=promote"),
                                 ("POST", "/debug/canary?action=rollback"),
                                 ("POST", "/debug/canary?action=clear-"
                                          "quarantine"),
                                 ("GET", "/debug/canary?action=promote"),
                                 ("POST", "/debug/canary?action=bogus")):
                r = await client.request(method, path)
                out.append((method, path, r.status, await r.text()))
        return out

    ref_canary = run(canary_answers(ref_http.build_app(service_engines[0])))
    port_canary = run(canary_answers(port_http.build_app(
        service_engines[1])))

    async def body():
        out = []
        app = port_http.build_app(service_engines[1],
                                  readiness=lambda: True)
        async with TestClient(TestServer(app)) as client:
            rs = await asyncio.wait_for(asyncio.gather(*(client.get(
                "/check", headers={"Host": "tier.example.com",
                                   "X-Api-Tier": "gold" if i % 2 == 0
                                   else "bronze"}) for i in range(16))),
                TIMEOUT)
            out.append([r.status for r in rs])
            for path in ("/healthz", "/readyz", "/metrics", "/debug/vars",
                         "/debug/decisions?n=0", "/debug/tenants",
                         "/debug/canary", "/debug/replay", "/debug/profile"):
                r = await client.get(path, headers={"Host": "tier.example.com"})
                out.append((path, r.status, await r.text()))
            r = await client.post("/debug/canary?action=promote")
            out.append(("POST /debug/canary", r.status, await r.text()))
        return out

    statuses, *routes = run(body())
    assert statuses == [200 if i % 2 == 0 else 403 for i in range(16)]
    by = {p: (s, t) for p, s, t in routes}
    assert by["/healthz"] == (200, "ok") and by["/readyz"] == (200, "ok")
    assert by["/metrics"][0] == 200
    assert "auth_server_response_status" in by["/metrics"][1]
    assert json.loads(by["/debug/vars"][1])["engine"]["generation"] == 1
    assert json.loads(by["/debug/decisions?n=0"][1])["records"] == []
    assert json.loads(by["/debug/tenants"][1]) == {"enabled": False}
    assert by["/debug/replay"][0] == 501 and "ROADMAP" in by["/debug/replay"][1]
    assert by["/debug/canary"][0] == 200
    assert json.loads(by["/debug/canary"][1])["canary"] is None
    assert by["POST /debug/canary"][0] == 200
    assert json.loads(by["POST /debug/canary"][1])["applied"] is False
    assert by["/debug/profile"][0] == 403
    # the reference's answers, code and JSON, on its engine
    assert [r[:3] for r in port_canary] == [r[:3] for r in ref_canary]
    assert [r[2] for r in port_canary] == [200, 200, 200, 200, 405, 400]
    for got, want in zip(port_canary, ref_canary):
        if got[2] == 400:
            assert got[3] == want[3]
        else:
            assert json.loads(got[3]) == json.loads(want[3])


def test_http_debug_profile_captures_a_torch_trace(service_engines):
    async def body():
        app = port_http.build_app(service_engines[1], enable_profile=True)
        async with TestClient(TestServer(app)) as client:
            bad = await client.get("/debug/profile?seconds=nan")
            r = await client.get("/debug/profile?seconds=0.1")
            return bad.status, r.status, await r.json()

    bad, status, payload = run(body())
    assert (bad, status) == (400, 200)
    import os

    assert os.path.exists(os.path.join(payload["trace_dir"], "trace.json"))


def test_readyz_not_ready_then_draining():
    state = {"ready": False}
    engine = translated_engines(SERVICE_SPECS[:1])[1]

    async def body():
        app = port_http.build_app(engine, readiness=lambda: state["ready"])
        out = []
        async with TestClient(TestServer(app)) as client:
            for step in ("wait", "ready", "drain"):
                if step == "ready":
                    state["ready"] = True
                if step == "drain":
                    engine.begin_drain()
                r = await client.get("/readyz")
                out.append((r.status, await r.text()))
        return out

    assert run(body()) == [(503, "not ready"), (200, "ok"),
                           (503, "draining")]


# ---- TLS (tests/test_tls_listeners.py on the port's own certificates) -------

@pytest.fixture(scope="module")
def self_signed():
    key = pki.generate_ec_private_key(pki.P256, random.Random(8))
    name = [[(cp.OID["CN"], "localhost")]]
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = cp.pem(cp.make_certificate(
        name, name, key.public_key(), key,
        now - datetime.timedelta(minutes=1), now + datetime.timedelta(hours=1),
        dns_names=["localhost"]))
    return cert, pki.private_key_to_pem(key)


def tls_engine():
    return translated_engines([("cfg", anon(["svc.example.com"], {
        "rules": pattern(eq("request.method", "DELETE", "neq"))}))])[1]


def test_grpc_tls_check(self_signed):
    cert_pem, key_pem = self_signed
    engine = tls_engine()

    async def body():
        creds = grpc.ssl_server_credentials([(key_pem, cert_pem)])
        server = port_grpc.build_server(engine, address="localhost:0",
                                        tls_credentials=creds)
        await server.start()
        try:
            chan = grpc.ssl_channel_credentials(root_certificates=cert_pem)
            async with grpc.aio.secure_channel(
                    f"localhost:{server.bound_port}", chan) as ch:
                req = pb.CheckRequest()
                http = req.attributes.request.http
                http.method = "GET"
                http.host = "svc.example.com"
                http.headers["host"] = "svc.example.com"
                raw = await asyncio.wait_for(
                    ch.unary_unary(CHECK, **RAW)(req.SerializeToString()),
                    TIMEOUT)
                return pb.CheckResponse.FromString(raw)
        finally:
            await server.stop(0.1)

    assert run(body()).status.code == 0


def test_http_tls_check(self_signed, tmp_path):
    cert_pem, key_pem = self_signed
    cert_file, key_file = tmp_path / "tls.crt", tmp_path / "tls.key"
    cert_file.write_bytes(cert_pem)
    key_file.write_bytes(key_pem)
    engine = tls_engine()

    async def body():
        import aiohttp
        from aiohttp import web

        server_ctx = port_cli._ssl_ctx(str(cert_file), str(key_file))
        assert server_ctx.minimum_version == ssl.TLSVersion.TLSv1_2
        runner = web.AppRunner(port_http.build_app(engine))
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0, ssl_context=server_ctx)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
        try:
            client_ctx = ssl.create_default_context(cadata=cert_pem.decode())
            client_ctx.check_hostname = False
            async with aiohttp.ClientSession() as sess:
                async with sess.get(f"https://127.0.0.1:{port}/check",
                                    headers={"Host": "svc.example.com"},
                                    ssl=client_ctx) as r:
                    return r.status
        finally:
            await runner.cleanup()

    assert run(body()) == 200


def test_mismatched_flags_rejected():
    with pytest.raises(SystemExit):
        port_cli._ssl_ctx("/some/cert.pem", "")


# ---- OIDC discovery, webhooks ------------------------------------------------

def test_oidc_discovery_and_jwks_equal_the_references():
    spec = anon(["w.example.com"], response={"success": {"headers": {
        "x-wristband": {"wristband": {
            "issuer": "https://authorino.example/t/wb/x-wristband",
            "signingKeyRefs": [{"name": "wristband-key",
                                "algorithm": "ES256"}]}}}}})
    engines = translated_engines([("wb", spec)], [WRISTBAND_SECRET])
    paths = ["/t/wb/x-wristband/.well-known/openid-configuration",
             "/t/wb/x-wristband/.well-known/openid-connect/certs",
             "/t/wb/nope/.well-known/openid-configuration",
             "/t/other/x-wristband/.well-known/openid-connect/certs"]

    async def body():
        out = []
        for mod, engine in ((ref_oidc, engines[0]), (port_oidc, engines[1])):
            async with TestClient(TestServer(mod.build_oidc_app(engine))) \
                    as client:
                rows = []
                for p in paths:
                    r = await client.get(p)
                    rows.append((r.status, r.headers.get("Content-Type"),
                                 await r.text()))
                out.append(rows)
        return out

    ref_rows, port_rows = run(body())
    assert port_rows == ref_rows
    assert [r[0] for r in port_rows] == [200, 200, 404, 404]
    issuer = engines[1].lookup("w.example.com").runtime.response[0].evaluator
    assert port_rows[0][2] == issuer.openid_config()
    assert port_rows[1][2] == issuer.jwks()


def webhook_reviews():
    obj = make_resource()
    conv = ref_webhooks.convert_review({"request": {
        "uid": "u1", "desiredAPIVersion": "authorino.kuadrant.io/v1beta1",
        "objects": [obj]}})["response"]["convertedObjects"][0]
    with_status = dict(make_resource(), status={"summary": {"ready": True}})
    converts = [
        {"apiVersion": "apiextensions.k8s.io/v1", "kind": "ConversionReview",
         "request": {"uid": "u1",
                     "desiredAPIVersion": "authorino.kuadrant.io/v1beta1",
                     "objects": [obj]}},
        {"request": {"uid": "u2",
                     "desiredAPIVersion": "authorino.kuadrant.io/v1beta2",
                     "objects": [conv]}},
        {"request": {"uid": "u", "desiredAPIVersion":
                     "authorino.kuadrant.io/v9", "objects": []}},
        {"request": {"uid": "u", "desiredAPIVersion":
                     "authorino.kuadrant.io/v1beta1",
                     "objects": [with_status]}},
    ]

    def review(o, op="CREATE"):
        return {"request": {"uid": "u", "operation": op, "object": o}}

    validates = [
        review(make_resource()),
        review(make_resource(spec={"authorization": {}})),
        review(make_resource(spec={**WEBHOOK_SPEC, "identity": []})),
        review(make_resource(spec={}), op="DELETE"),
        review(make_resource(spec={"hosts": ["h"], "authorization": {"a": {
            "patternMatching": {"patterns": [
                {"selector": "request.path", "operator": "matches",
                 "value": "([unclosed"}]}}}})),
        review(make_resource(spec={"hosts": ["h"], "when": [
            {"selector": "request.path", "operator": "gte", "value": "1"}]})),
        review(conv),
    ]
    return converts, validates


def test_webhook_reviews_equal_the_references():
    converts, validates = webhook_reviews()
    for r in converts:
        assert port_webhooks.convert_review(json.loads(json.dumps(r))) == \
            ref_webhooks.convert_review(json.loads(json.dumps(r)))
    for r in validates:
        assert port_webhooks.validate_review(json.loads(json.dumps(r))) == \
            ref_webhooks.validate_review(json.loads(json.dumps(r)))
    assert [port_webhooks.validate_review(r)["response"]["allowed"]
            for r in validates] == [True, False, False, True, False, False,
                                    True]


def test_webhook_app_equals_the_references():
    converts, validates = webhook_reviews()

    async def body():
        out = []
        for mod in (ref_webhooks, port_webhooks):
            async with TestClient(TestServer(mod.build_webhook_app())) \
                    as client:
                rows = []
                for path, reviews in (("/convert", converts),
                                      ("/validate-authconfig", validates)):
                    for r in reviews:
                        resp = await client.post(path, json=r)
                        rows.append((resp.status, await resp.json()))
                    resp = await client.post(path, data=b"{not json")
                    rows.append((resp.status, await resp.text()))
                resp = await client.get("/healthz")
                rows.append((resp.status, await resp.text()))
                out.append(rows)
        return out

    ref_rows, port_rows = run(body())
    assert port_rows == ref_rows


# ---- SpiceDB ------------------------------------------------------------------

class FakeSpiceDB:
    """A CheckPermission server on loopback (a grpcio generic handler):
    HAS_PERMISSION (2) when the request names the subject ``alice``,
    NO_PERMISSION (1) otherwise; records each request's bytes and bearer
    token."""

    def __init__(self):
        self.seen = []

    async def start(self):
        async def check(request: bytes, context):
            md = dict(context.invocation_metadata())
            self.seen.append((request, md.get("authorization")))
            perm = 2 if b"alice" in request else 1
            return wire.encode_check_permission_response(perm, "zed")

        self.server = grpc.aio.server()
        self.server.add_generic_rpc_handlers((
            grpc.method_handlers_generic_handler(
                "authzed.api.v1.PermissionsService",
                {"CheckPermission": grpc.unary_unary_rpc_method_handler(
                    check, request_deserializer=lambda b: b,
                    response_serializer=lambda b: b)}),))
        self.port = self.server.add_insecure_port("127.0.0.1:0")
        await self.server.start()
        return self


def spicedb_spec(endpoint):
    return anon(["db.example.com"], {"spicedb": {"spicedb": {
        "endpoint": endpoint, "insecure": True,
        "sharedSecretRef": {"name": "spicedb", "key": "token"},
        "subject": {"kind": {"value": "user"},
                    "name": {"selector": "request.headers.x-user"}},
        "resource": {"kind": {"value": "doc"},
                     "name": {"selector": "request.url_path"}},
        "permission": {"selector": "request.method"}}}})


SPICEDB_SECRET = {"name": "spicedb", "namespace": "t",
                  "data": {"token": b"s3cr3t"}}


def test_spicedb_allow_deny_unreachable_equal_the_references():
    from test_torch_pipeline import request_of

    requests = [{"method": "GET", "path": "/doc-1", "host": "db.example.com",
                 "headers": {"x-user": user}} for user in ("alice", "bob")]

    async def body():
        fake = await FakeSpiceDB().start()
        try:
            out = []
            for endpoint in (f"127.0.0.1:{fake.port}", "127.0.0.1:1"):
                rows = []
                for ns in (REF, PORT):
                    engine = engine_of(ns)
                    entry = await ns.controllers.translate_auth_config(
                        "db", "t", spicedb_spec(endpoint),
                        cluster=cluster_of(ns, [SPICEDB_SECRET]),
                        engine=engine)
                    engine.apply_snapshot([entry])
                    rows.append([result_fields(await asyncio.wait_for(
                        engine.check(request_of(ns, dict(r))), TIMEOUT))
                        for r in requests])
                out.append(rows)
            return out, fake.seen
        finally:
            await fake.server.stop(None)

    (reachable, unreachable), seen = run(body())
    assert reachable[1] == reachable[0]
    assert [r[0] for r in reachable[1]] == [0, 7]
    assert reachable[1][1][2] == "PERMISSIONSHIP_NO_PERMISSION"
    assert len(seen) == 4
    assert {tok for _, tok in seen} == {"Bearer s3cr3t"}
    assert seen[0][0] == seen[2][0]   # the same request bytes from both
    # the unreachable endpoint: the gRPC error's text carries timestamps,
    # so the reason is compared up to it
    for ref_row, port_row in zip(*unreachable):
        assert port_row[:2] == ref_row[:2] == (7, 0)
        assert port_row[2].split(":")[0] == ref_row[2].split(":")[0]
