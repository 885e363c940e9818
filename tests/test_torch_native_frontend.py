"""The port's native gRPC frontend (``authorino_tpu_torch/runtime/
native_frontend.py`` + ``native/csrc/frontend.cpp``) against the
reference's (``authorino_tpu/runtime/native_frontend.py``) and against the
port's own grpc.aio server, over real loopback gRPC, on the CPU: the port's
engine runs on ``device="cpu"`` (the kernel's plain version), the
reference's on JAX's CPU backend.  Both corpora come from one seeded spec
(``build_corpus``) built with each package's classes.  Tolerance 0: bytes
and decoded responses compare exactly.

What differs by design, named where the tests compare:

* ``dynamic_metadata.ext_authz_provenance`` of a fast-lane denial: the
  port's frontend attaches the denying rule's provenance as its grpc.aio
  server (and the reference's Python server) do; the reference's native
  frontend leaves it out (ROADMAP.md queue 3).
* none of the reference's fast-lane kinds is deferred any more
  (``DEFERRED`` is empty): the hybrid lane (a config whose authorization
  is only partly kernel-covered) and the verified-credential cache
  (OIDC/JWT, mTLS, OAuth2, Kubernetes) are held to the reference here and
  in ``tests/test_torch_native_frontend_dyn.py``.

Each test stops the frontends it starts in ``finally`` and runs under a
time bound of its own (``bounded``), so a hang fails the test instead of
holding the suite."""

from __future__ import annotations

import asyncio
import functools
import json
import struct
import subprocess
import threading
import time
from types import SimpleNamespace

import grpc
import numpy as np
import pytest
import torch
from google.protobuf.json_format import MessageToDict

import authorino_tpu.authjson.value as r_value
import authorino_tpu.compiler as r_compiler
import authorino_tpu.evaluators as r_ev
import authorino_tpu.evaluators.authorization as r_authz
import authorino_tpu.evaluators.cache as r_cache
import authorino_tpu.evaluators.credentials as r_cred
import authorino_tpu.evaluators.identity as r_ident
import authorino_tpu.expressions as r_expr
import authorino_tpu.k8s.client as r_k8s
import authorino_tpu.runtime as r_runtime
import authorino_tpu_torch.authjson.value as p_value
import authorino_tpu_torch.compiler as p_compiler
import authorino_tpu_torch.evaluators as p_ev
import authorino_tpu_torch.evaluators.authorization as p_authz
import authorino_tpu_torch.evaluators.cache as p_cache
import authorino_tpu_torch.evaluators.credentials as p_cred
import authorino_tpu_torch.evaluators.identity as p_ident
import authorino_tpu_torch.expressions as p_expr
import authorino_tpu_torch.k8s.client as p_k8s
import authorino_tpu_torch.runtime as p_runtime
from authorino_tpu import protos as ref_protos
from authorino_tpu.runtime import faults as ref_faults
from authorino_tpu.runtime import native_frontend as ref_nf
from authorino_tpu_torch import native as p_native
from authorino_tpu_torch.ops import fused_kernel as p_fk
from authorino_tpu_torch.protos import wire
from authorino_tpu_torch.runtime import faults as port_faults
from authorino_tpu_torch.runtime import native_frontend as port_nf
from authorino_tpu_torch.runtime.kernel_cost import LEDGER
from torch_ref_native import ref_native_library

pb = ref_protos.external_auth_pb2
CHECK = "/envoy.service.auth.v3.Authorization/Check"


@pytest.fixture(scope="module", autouse=True)
def _ref_native():
    """The reference's native library, loaded past a lost build race
    (``tests/torch_ref_native.py``) before any test here reaches it."""
    return ref_native_library()


def _ns(compiler, ev, authz, cred, ident, expr, k8s, runtime, value):
    return SimpleNamespace(
        ConfigRules=compiler.ConfigRules,
        AuthorizationConfig=ev.AuthorizationConfig, DenyWith=ev.DenyWith,
        DenyWithValues=ev.DenyWithValues, IdentityConfig=ev.IdentityConfig,
        RuntimeAuthConfig=ev.RuntimeAuthConfig, MetadataConfig=ev.MetadataConfig,
        JSONProperty=value.JSONProperty, JSONValue=value.JSONValue,
        OPA=authz.OPA, PatternMatching=authz.PatternMatching,
        AuthCredentials=cred.AuthCredentials, APIKey=ident.APIKey,
        Noop=ident.Noop, All=expr.All, Any_=expr.Any_,
        Operator=expr.Operator, Pattern=expr.Pattern,
        LabelSelector=k8s.LabelSelector, Secret=k8s.Secret,
        EngineEntry=runtime.EngineEntry, PolicyEngine=runtime.PolicyEngine)


REF = _ns(r_compiler, r_ev, r_authz, r_cred, r_ident, r_expr, r_k8s,
          r_runtime, r_value)
PORT = _ns(p_compiler, p_ev, p_authz, p_cred, p_ident, p_expr, p_k8s,
           p_runtime, p_value)

# the config ids whose kind the port defers: fast in the reference, slow in
# the port (none: every kind of the reference's fast lane is ported)
DEFERRED: dict = {}


def bounded(seconds: float):
    """Run the test body on a thread of its own and fail the test if it
    has not ended within ``seconds`` (the body's own ``finally`` still
    stops its frontends when it does end)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            box = {}

            def run():
                try:
                    box["ret"] = fn(*args, **kwargs)
                except BaseException as e:  # re-raised on the test thread
                    box["exc"] = e

            t = threading.Thread(target=run, daemon=True,
                                 name=f"bounded-{fn.__name__}")
            t.start()
            t.join(seconds)
            assert not t.is_alive(), f"{fn.__name__} exceeded {seconds}s"
            if "exc" in box:
                raise box["exc"]
            return box.get("ret")

        return wrapper

    return deco


# ---------------------------------------------------------------------------
# the corpus: one spec, either package
# ---------------------------------------------------------------------------


def build_corpus(ns, engine):
    """Fast-lane, slow-lane and deferred configs built with ``ns``'s
    classes and bound to ``engine`` (every pattern evaluator carries the
    engine's provider and attributor)."""

    def pm(cfg_id, rule, slot=0):
        return ns.PatternMatching(rule,
                                  batched_provider=engine.provider_for(cfg_id),
                                  evaluator_slot=slot,
                                  attributor=engine.attribution_for(cfg_id))

    def pattern_entry(cfg_id, hosts, rule, cond=None, deny_with=None):
        nsp, _, nm = cfg_id.partition("/")
        runtime = ns.RuntimeAuthConfig(
            labels={"namespace": nsp, "name": nm},
            identity=[ns.IdentityConfig("anon", ns.Noop())],
            authorization=[ns.AuthorizationConfig("rules", pm(cfg_id, rule))],
            deny_with=deny_with or ns.DenyWith())
        return ns.EngineEntry(
            id=cfg_id, hosts=hosts, runtime=runtime,
            rules=ns.ConfigRules(name=cfg_id, evaluators=[(cond, rule)]))

    P, Op = ns.Pattern, ns.Operator
    entries = [
        pattern_entry("ns/fast-eq", ["fast-eq.test"],
                      ns.All(P("request.method", Op.EQ, "GET"),
                             P("request.headers.x-org", Op.EQ, "acme"))),
        pattern_entry("ns/fast-cond", ["fast-cond.test"],
                      P("request.headers.x-role", Op.EQ, "admin"),
                      cond=P("request.method", Op.EQ, "POST")),
        pattern_entry("ns/fast-rx", ["fast-rx.test"],
                      P("request.url_path", Op.MATCHES, r"^/api/v[0-9]+/ok")),
        pattern_entry("ns/fast-deny", ["fast-deny.test"],
                      P("request.headers.x-pass", Op.EQ, "yes"),
                      deny_with=ns.DenyWith(unauthorized=ns.DenyWithValues(
                          code=302, message=ns.JSONValue(static="moved"),
                          headers=[ns.JSONProperty(
                              "Location",
                              ns.JSONValue(static="http://login.test"))]))),
        pattern_entry("ns/slow-tmpl", ["slow-tmpl.test"],
                      P("request.method", Op.EQ, "GET"),
                      deny_with=ns.DenyWith(unauthorized=ns.DenyWithValues(
                          message=ns.JSONValue(pattern="request.path")))),
        pattern_entry("ns/fast-wild", ["*.wild.test"],
                      P("request.method", Op.NEQ, "DELETE")),
    ]
    # API-key identity only: a C++ credential-map decision, no kernel
    key_only = ns.APIKey(
        "friends", ns.LabelSelector.from_spec({"matchLabels": {"g": "t"}}),
        credentials=ns.AuthCredentials(key_selector="APIKEY"))
    key_only.add_k8s_secret_based_identity(ns.Secret(
        namespace="ns", name="k1", labels={"g": "t"},
        data={"api_key": b"sekret"}))
    entries.append(ns.EngineEntry(
        id="ns/fast-keyonly", hosts=["key-only.test"],
        runtime=ns.RuntimeAuthConfig(
            labels={"namespace": "ns", "name": "fast-keyonly"},
            identity=[ns.IdentityConfig(
                "friends", key_only,
                credentials=ns.AuthCredentials(key_selector="APIKEY"))])))
    # API-key identity + a pattern over auth.identity.*: per-key constants
    team = ns.APIKey(
        "team", ns.LabelSelector.from_spec({"matchLabels": {"g": "t2"}}),
        credentials=ns.AuthCredentials(key_selector="X-API-KEY",
                                       location="custom_header"))
    for name, role, key in (("adm", "admin", b"adminkey"),
                            ("usr", "user", b"userkey")):
        team.add_k8s_secret_based_identity(ns.Secret(
            namespace="ns", name=name, labels={"g": "t2"},
            annotations={"role": role}, data={"api_key": key}))
    role_rule = P("auth.identity.metadata.annotations.role", Op.EQ, "admin")
    entries.append(ns.EngineEntry(
        id="ns/fast-key", hosts=["fast-key.test"],
        runtime=ns.RuntimeAuthConfig(
            labels={"namespace": "ns", "name": "fast-key"},
            identity=[ns.IdentityConfig(
                "team", team, credentials=ns.AuthCredentials(
                    key_selector="X-API-KEY", location="custom_header"))],
            authorization=[ns.AuthorizationConfig(
                "rules", pm("ns/fast-key", role_rule))]),
        rules=ns.ConfigRules(name="ns/fast-key",
                             evaluators=[(None, role_rule)])))
    # the identity-templated denial (API key + denyWith over auth.identity)
    viewer = ns.APIKey(
        "keys", ns.LabelSelector.from_spec({"matchLabels": {"g": "dt"}}),
        credentials=ns.AuthCredentials(key_selector="APIKEY"))
    viewer.add_k8s_secret_based_identity(ns.Secret(
        namespace="ns", name="eve-key", labels={"g": "dt"},
        annotations={"role": "viewer"}, data={"api_key": b"eve-secret"}))
    entries.append(ns.EngineEntry(
        id="ns/deny-tmpl", hosts=["deny-tmpl.test"],
        runtime=ns.RuntimeAuthConfig(
            labels={"namespace": "ns", "name": "deny-tmpl"},
            identity=[ns.IdentityConfig(
                "keys", viewer,
                credentials=ns.AuthCredentials(key_selector="APIKEY"))],
            authorization=[ns.AuthorizationConfig(
                "rules", pm("ns/deny-tmpl", role_rule))],
            deny_with=ns.DenyWith(unauthorized=ns.DenyWithValues(
                code=403, message=ns.JSONValue(
                    pattern="role {auth.identity.metadata.annotations.role}"
                            " may not pass"),
                headers=[ns.JSONProperty("x-denied-user", ns.JSONValue(
                    pattern="auth.identity.metadata.name"))]))),
        rules=ns.ConfigRules(name="ns/deny-tmpl",
                             evaluators=[(None, role_rule)])))
    # cookie / query credential locations
    for host, loc, sel in (("cookie-key.test", "cookie", "ses"),
                           ("query-key.test", "query", "tok")):
        ak = ns.APIKey(f"k-{loc}",
                       ns.LabelSelector.from_spec({"matchLabels": {"g": loc}}),
                       credentials=ns.AuthCredentials(key_selector=sel,
                                                      location=loc))
        ak.add_k8s_secret_based_identity(ns.Secret(
            namespace="ns", name=f"s-{loc}", labels={"g": loc},
            data={"api_key": b"c0ffee"}))
        entries.append(ns.EngineEntry(
            id=f"ns/fast-{loc}", hosts=[host],
            runtime=ns.RuntimeAuthConfig(
                labels={"namespace": "ns", "name": f"fast-{loc}"},
                identity=[ns.IdentityConfig(
                    f"k-{loc}", ak, credentials=ns.AuthCredentials(
                        key_selector=sel, location=loc))])))
    # a pattern + lowered inline Rego (two kernel columns; the Rego in a
    # later priority bucket, so the first failing column is deterministic)
    opa = ns.OPA("ns/fast-rego/rego", inline_rego=(
        'allow { input.request.method == "GET" }\n'
        'allow { input.request.headers["x-root"] == "true" }'))
    lowered = opa.lowered_verdict()
    assert lowered is not None
    opa.kernel_slot = 1
    tier = P("request.headers.x-tier", Op.EQ, "gold")
    entries.append(ns.EngineEntry(
        id="ns/fast-rego", hosts=["fast-rego.test"],
        runtime=ns.RuntimeAuthConfig(
            labels={"namespace": "ns", "name": "fast-rego"},
            identity=[ns.IdentityConfig("anon", ns.Noop())],
            authorization=[ns.AuthorizationConfig("rules",
                                                  pm("ns/fast-rego", tier)),
                           ns.AuthorizationConfig("rego", opa, priority=1)]),
        rules=ns.ConfigRules(name="ns/fast-rego",
                             evaluators=[(None, tier), (None, lowered)])))
    # the hybrid lane: a pattern + procedural Rego
    proc = ns.OPA("ns/hybrid/rego", inline_rego=(
        'allow { count(input.request.headers) > 1 }'))
    entries.append(ns.EngineEntry(
        id="ns/hybrid", hosts=["hybrid.test"],
        runtime=ns.RuntimeAuthConfig(
            labels={"namespace": "ns", "name": "hybrid"},
            identity=[ns.IdentityConfig("anon", ns.Noop())],
            authorization=[ns.AuthorizationConfig("rules",
                                                  pm("ns/hybrid", tier)),
                           ns.AuthorizationConfig("rego", proc,
                                                  priority=1)]),
        rules=ns.ConfigRules(name="ns/hybrid", evaluators=[(None, tier)])))
    return entries


def make_req(host, method="GET", path="/", headers=None, ctx=None) -> bytes:
    req = pb.CheckRequest()
    http = req.attributes.request.http
    http.method = method
    http.path = path
    http.host = host
    for k, v in (headers or {}).items():
        http.headers[k] = v
    for k, v in (ctx or {}).items():
        req.attributes.context_extensions[k] = v
    return req.SerializeToString()


REQUESTS = [
    make_req("fast-eq.test", headers={"x-org": "acme"}),
    make_req("fast-eq.test", headers={"x-org": "evil"}),
    make_req("fast-eq.test", method="POST", headers={"x-org": "acme"}),
    make_req("fast-eq.test"),
    make_req("fast-cond.test"),
    make_req("fast-cond.test", method="POST"),
    make_req("fast-cond.test", method="POST", headers={"x-role": "admin"}),
    make_req("fast-rx.test", path="/api/v2/ok?x=1"),
    make_req("fast-rx.test", path="/api/nope"),
    make_req("fast-rx.test", path="/api/v9/ok" + "a" * 100),
    make_req("fast-deny.test", headers={"x-pass": "yes"}),
    make_req("fast-deny.test", headers={"x-pass": "no"}),
    make_req("key-only.test", headers={"authorization": "APIKEY sekret"}),
    make_req("key-only.test", headers={"authorization": "APIKEY wrong"}),
    make_req("key-only.test"),
    make_req("key-only.test", headers={"authorization": "Bearer sekret"}),
    make_req("fast-key.test", headers={"x-api-key": "adminkey"}),
    make_req("fast-key.test", headers={"x-api-key": "userkey"}),
    make_req("fast-key.test", headers={"x-api-key": "nope"}),
    make_req("fast-key.test"),
    make_req("deny-tmpl.test", headers={"authorization": "APIKEY eve-secret"}),
    make_req("deny-tmpl.test"),
    make_req("slow-tmpl.test", method="POST", path="/here"),
    make_req("cookie-key.test", headers={"cookie": "a=1; ses=c0ffee; b=2"}),
    make_req("cookie-key.test", headers={"cookie": "ses=wrong"}),
    make_req("cookie-key.test", headers={"cookie": "other=1"}),
    make_req("query-key.test", path="/hello?x=1&tok=c0ffee&y=2"),
    make_req("query-key.test", path="/hello?tok=bad"),
    make_req("query-key.test", path="/hello"),
    make_req("a.wild.test"),
    make_req("a.wild.test", method="DELETE"),
    make_req("deep.a.wild.test"),
    make_req("wild.test"),
    make_req("a.wild.test:8443"),
    make_req("unknown.test"),
    make_req("fast-eq.test:8080", headers={"x-org": "acme"}),
    make_req("other.test", headers={"x-org": "acme"},
             ctx={"host": "fast-eq.test"}),
    make_req("fast-rego.test", headers={"x-tier": "gold"}),
    make_req("fast-rego.test", method="DELETE", headers={"x-tier": "gold"}),
    make_req("fast-rego.test", method="DELETE",
             headers={"x-tier": "gold", "x-root": "true"}),
    make_req("fast-rego.test", headers={"x-tier": "wood"}),
    make_req("fast-rego.test", method="DELETE", headers={"x-root": "TRUE"}),
    make_req("hybrid.test", headers={"x-tier": "gold", "x-a": "1"}),
    make_req("hybrid.test", headers={"x-tier": "wood"}),
]


# ---------------------------------------------------------------------------
# servers
# ---------------------------------------------------------------------------


def serve_grpc_aio(build_server, engine):
    """A grpc.aio server (either package's) on a loop thread of its own;
    returns (port, stop())."""
    started = threading.Event()
    holder = {}

    def runner():
        async def main():
            server = build_server(engine, address="127.0.0.1:0")
            await server.start()
            holder["port"] = server.bound_port
            holder["loop"] = asyncio.get_running_loop()
            holder["stop"] = asyncio.Event()
            started.set()
            await holder["stop"].wait()
            await server.stop(0.2)

        asyncio.run(main())

    t = threading.Thread(target=runner, daemon=True)
    t.start()
    assert started.wait(30)

    def stop():
        holder["loop"].call_soon_threadsafe(holder["stop"].set)
        t.join(timeout=10)

    return holder["port"], stop


def call(port, payload: bytes, timeout=10) -> bytes:
    with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
        c = ch.unary_unary(CHECK, request_serializer=lambda b: b,
                           response_deserializer=lambda b: b)
        return c(payload, timeout=timeout)


def call_many(port, payloads, timeout=30):
    """Concurrent Check()s over one channel (so a burst gathers)."""

    async def body():
        async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
            c = ch.unary_unary(CHECK, request_serializer=lambda b: b,
                               response_deserializer=lambda b: b)
            return await asyncio.gather(*(c(p, timeout=timeout)
                                          for p in payloads))

    return asyncio.run(body())


def as_dict(raw: bytes, drop_provenance: bool = False) -> dict:
    d = MessageToDict(pb.CheckResponse.FromString(raw))
    if drop_provenance:
        md = d.get("dynamicMetadata")
        if md is not None:
            md.pop("ext_authz_provenance", None)
            if not md:
                d.pop("dynamicMetadata")
    return d


@pytest.fixture(scope="module")
def reference():
    """The reference's engine, NativeFrontend and grpc.aio server over the
    corpus (JAX on the CPU; lane selection and brownout off, so every
    fast-lane slot rides its kernel path)."""
    from authorino_tpu.service.grpc_server import build_server

    engine = REF.PolicyEngine(max_batch=64, mesh=None)
    engine.apply_snapshot(build_corpus(REF, engine))
    fe = ref_nf.NativeFrontend(engine, port=0, max_batch=64, window_us=500,
                               lane_select=False, brownout=False,
                               breaker_threshold=1, breaker_reset_s=0.2)
    stop_grpc = None
    try:
        fe_port = fe.start()
        assert fe.wait_warm(300)
        py_port, stop_grpc = serve_grpc_aio(build_server, engine)
        yield SimpleNamespace(engine=engine, fe=fe, port=fe_port,
                              py_port=py_port)
    finally:
        if stop_grpc is not None:
            stop_grpc()
        fe.stop()


class PortStack:
    """The port's CPU engine over the corpus, its NativeFrontend and its
    grpc.aio server; ``close()`` stops both."""

    def __init__(self, **fe_kw):
        from authorino_tpu_torch.service.grpc_server import build_server

        self.engine = PORT.PolicyEngine(max_batch=64, device="cpu")
        self.engine.apply_snapshot(build_corpus(PORT, self.engine))
        self.fe = port_nf.NativeFrontend(
            self.engine, port=0, **dict(dict(max_batch=64, window_us=500),
                                        **fe_kw))
        self._stop_grpc = None
        try:
            self.port = self.fe.start()
            assert self.fe.wait_warm(60)
            self.py_port, self._stop_grpc = serve_grpc_aio(build_server,
                                                           self.engine)
        except BaseException:
            self.close()
            raise

    def close(self):
        if self._stop_grpc is not None:
            self._stop_grpc()
            self._stop_grpc = None
        self.fe.stop(drain_s=5)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    port_faults.FAULTS.disarm()
    ref_faults.FAULTS.disarm()


# ---------------------------------------------------------------------------
# responses
# ---------------------------------------------------------------------------


@bounded(240)
def test_responses_equal_reference_and_own_grpc_aio(reference):
    """Every request, one at a time: the port's native answer is
    byte-equal to the port's grpc.aio server's, equal (decoded) to the
    reference's Python server's, and equal to the reference's native
    frontend's but for the provenance block of a fast-lane denial."""
    stack = PortStack()
    try:
        for i, req in enumerate(REQUESTS):
            native = call(stack.port, req)
            assert native == call(stack.py_port, req), f"request #{i}"
            assert as_dict(native) == as_dict(
                call(reference.py_port, req)), f"request #{i}"
            assert as_dict(native, drop_provenance=True) == as_dict(
                call(reference.port, req), drop_provenance=True), \
                f"request #{i}"
        st = stack.fe.stats()
        assert st["fast"] > 0 and st["slow"] > 0
        assert st["fe_plain_calls"] > 0 and st["fe_launches"] == 0
        # fast-lane denials carry the denying rule's provenance
        d = as_dict(call(stack.port, REQUESTS[1]))
        prov = d["dynamicMetadata"]["ext_authz_provenance"]
        assert prov["authconfig"] == "ns/fast-eq" and prov["rule_index"] == 0
    finally:
        stack.close()


def sharded_corpus(ns, engine):
    """The reference's sharded fast-lane corpus
    (``tests/test_native_frontend.py::test_sharded_engine_serves_fast_lane``)
    built with ``ns``'s classes: ten configs over the mesh's shards, a
    device-DFA regex, and API-key credential variants whose per-key
    ``auth.*`` constants resolve against the owning shard's compile."""
    P, Op = ns.Pattern, ns.Operator

    def entry(cfg_id, hosts, rule):
        pm = ns.PatternMatching(rule,
                                batched_provider=engine.provider_for(cfg_id),
                                evaluator_slot=0,
                                attributor=engine.attribution_for(cfg_id))
        nsp, _, nm = cfg_id.partition("/")
        return ns.EngineEntry(
            id=cfg_id, hosts=hosts, runtime=ns.RuntimeAuthConfig(
                labels={"namespace": nsp, "name": nm},
                identity=[ns.IdentityConfig("anon", ns.Noop())],
                authorization=[ns.AuthorizationConfig("rules", pm)],
                deny_with=ns.DenyWith()),
            rules=ns.ConfigRules(name=cfg_id, evaluators=[(None, rule)]))

    entries = [entry(f"ns/shard-{i}", [f"shard-{i}.test"],
                     ns.All(P("request.headers.x-org", Op.EQ, f"org-{i}"),
                            P("request.method", Op.NEQ, "DELETE")))
               for i in range(10)]
    entries.append(entry("ns/shard-rx", ["shard-rx.test"],
                         P("request.url_path", Op.MATCHES, r"^/v[0-9]+/ok")))
    aks = ns.APIKey("sh-keys", ns.LabelSelector.from_spec(
        {"matchLabels": {"g": "sh"}}),
        credentials=ns.AuthCredentials(key_selector="APIKEY"))
    for name, role, key in (("sh-adm", "admin", b"sh-admin"),
                            ("sh-usr", "user", b"sh-user")):
        aks.add_k8s_secret_based_identity(ns.Secret(
            namespace="ns", name=name, labels={"g": "sh"},
            annotations={"role": role}, data={"api_key": key}))
    rule_sh = P("auth.identity.metadata.annotations.role", Op.EQ, "admin")
    pm_sh = ns.PatternMatching(
        rule_sh, batched_provider=engine.provider_for("ns/shard-key"),
        evaluator_slot=0, attributor=engine.attribution_for("ns/shard-key"))
    entries.append(ns.EngineEntry(
        id="ns/shard-key", hosts=["shard-key.test"],
        runtime=ns.RuntimeAuthConfig(
            labels={"namespace": "ns", "name": "shard-key"},
            identity=[ns.IdentityConfig(
                "sh-keys", aks,
                credentials=ns.AuthCredentials(key_selector="APIKEY"))],
            authorization=[ns.AuthorizationConfig("rules", pm_sh)]),
        rules=ns.ConfigRules(name="ns/shard-key",
                             evaluators=[(None, rule_sh)])))
    return entries


@bounded(300)
def test_sharded_engine_serves_fast_lane():
    """A mesh-sharded corpus rides the fast lane: the C++ encoder lays each
    request into its owning shard's [B, S, ...] slice and one mesh dispatch
    serves the slot.  What the reference's test asserts (its own run fails
    on a shard_map pytree error there): every answer equal to the Python
    server's on the same sharded engine, all but the 404 fast, and a
    seeded sweep across shards, credentials and regex overflow with no
    divergence.  The port's mesh is 8 logical slots over the CPU (dp = 2,
    mp = 4); each answer is also equal to a single-corpus engine's."""
    from authorino_tpu_torch.parallel import build_mesh
    from authorino_tpu_torch.service.grpc_server import build_server

    mesh = build_mesh([torch.device("cpu")] * 8, dp=2)
    engine = PORT.PolicyEngine(max_batch=16, device="cpu", mesh=mesh)
    engine.apply_snapshot(sharded_corpus(PORT, engine))
    assert engine._snapshot.sharded is not None, "mesh path not engaged"
    single = PORT.PolicyEngine(max_batch=16, device="cpu", mesh=None)
    single.apply_snapshot(sharded_corpus(PORT, single))
    fe = port_nf.NativeFrontend(engine, port=0, max_batch=16, window_us=500)
    stops = []
    try:
        port = fe.start()
        assert fe.wait_warm(60)
        py_port, stop = serve_grpc_aio(build_server, engine)
        stops.append(stop)
        single_port, stop = serve_grpc_aio(build_server, single)
        stops.append(stop)
        reqs = []
        for i in range(10):
            reqs.append(make_req(f"shard-{i}.test",
                                 headers={"x-org": f"org-{i}"}))
            reqs.append(make_req(f"shard-{i}.test",
                                 headers={"x-org": "evil"}))
            reqs.append(make_req(f"shard-{i}.test", method="DELETE",
                                 headers={"x-org": f"org-{i}"}))
        reqs.append(make_req("shard-rx.test", path="/v2/ok"))
        reqs.append(make_req("shard-rx.test", path="/nope"))
        reqs.append(make_req("shard-rx.test", path="/v2/ok" + "x" * 200))
        for key in ("APIKEY sh-admin", "APIKEY sh-user", "APIKEY nope"):
            reqs.append(make_req("shard-key.test",
                                 headers={"authorization": key}))
        reqs.append(make_req("shard-key.test"))
        reqs.append(make_req("unknown.test"))
        for i, req in enumerate(reqs):
            native = call(port, req)
            assert native == call(py_port, req), f"sharded req #{i}"
            assert as_dict(native) == as_dict(call(single_port, req)), \
                f"sharded req #{i} vs the single corpus"
        stats = fe.stats()
        assert stats["fast"] > 0, f"sharded fast lane never engaged: {stats}"
        assert stats["fast"] >= len(reqs) - 1  # all but the 404 ride fast
        rng = __import__("random").Random(8)
        mism = []
        for i in range(120):
            host = rng.choice([f"shard-{rng.randrange(10)}.test",
                               "shard-rx.test", "shard-key.test",
                               "nope.test"])
            headers = {}
            if rng.random() < 0.6:
                headers["x-org"] = rng.choice(
                    [f"org-{rng.randrange(10)}", "evil", ""])
            if rng.random() < 0.5:
                headers["authorization"] = rng.choice(
                    ["APIKEY sh-admin", "APIKEY sh-user", "APIKEY zz", ""])
            req = make_req(host, method=rng.choice(["GET", "DELETE"]),
                           path=rng.choice(["/v2/ok", "/no",
                                            "/v1/ok" + "y" * 180]),
                           headers=headers)
            if call(port, req) != call(py_port, req):
                mism.append(i)
        assert not mism, f"{len(mism)} diverged on the mesh: {mism[:5]}"
        assert fe.stats()["fe_batches"] > 0
    finally:
        for stop in stops:
            stop()
        fe.stop()


@bounded(240)
def test_identity_templated_deny_carries_provenance(reference):
    """The identity-templated denial is decided on the fast lane and is
    what the reference's test asserts of it — equal to the Python
    server's answer (provenance included), 403, the caller named in a
    header — where the reference's native frontend omits the provenance."""
    stack = PortStack()
    try:
        hdr = {"authorization": "APIKEY eve-secret"}
        req = make_req("deny-tmpl.test", headers=hdr)
        before = stack.fe.stats()
        native = call(stack.port, req)
        after = stack.fe.stats()
        assert (after["fast"] - before["fast"],
                after["slow"] - before["slow"]) == (1, 0)
        assert native == call(stack.py_port, req)
        assert as_dict(native) == as_dict(call(reference.py_port, req))
        msg = pb.CheckResponse.FromString(native)
        assert msg.status.code == 7
        assert msg.denied_response.status.code == 403
        hdrs = {h.header.key: h.header.value
                for h in msg.denied_response.headers}
        assert hdrs["x-denied-user"] == "eve-key"
        assert "ext_authz_provenance" in as_dict(native)["dynamicMetadata"]
        ref_native = as_dict(call(reference.port, req))
        assert "dynamicMetadata" not in ref_native   # the divergence
        assert as_dict(native, drop_provenance=True) == ref_native
    finally:
        stack.close()


@bounded(240)
def test_eligibility_equals_reference_but_the_deferred_kinds(reference):
    """``fast_lane_eligible`` of the port equals the reference's on every
    config of the corpus, the hybrid one included (``DEFERRED`` is empty:
    no kind is left out)."""
    assert DEFERRED == {}
    stack = PortStack()
    try:
        r_snap, p_snap = reference.engine._snapshot, stack.engine._snapshot
        p_by_id = {e.id: e for e in p_snap.entries}
        for cfg_id, r_entry in r_snap.by_id.items():
            r_spec = ref_nf.fast_lane_eligible(r_entry, r_snap.policy)
            p_spec = port_nf.fast_lane_eligible(p_by_id[cfg_id],
                                                p_snap.policy)
            if cfg_id in DEFERRED:
                assert r_spec is not None and r_spec.hybrid
                assert p_spec is None, DEFERRED[cfg_id]
                continue
            assert (r_spec is None) == (p_spec is None), cfg_id
            if p_spec is None:
                continue
            assert p_spec.has_batch == r_spec.has_batch, cfg_id
            assert p_spec.hybrid == r_spec.hybrid, cfg_id
            assert p_spec.plans == r_spec.plans, cfg_id
            assert p_spec.auth_attrs == r_spec.auth_attrs, cfg_id
            assert p_spec.deny_templated == r_spec.deny_templated, cfg_id
            assert [(s.cred_kind, s.cred_key, s.dyn, s.ttl_cap,
                     [(k, v) for k, v, _ in s.variants])
                    for s in p_spec.sources] == \
                [(s.cred_kind, s.cred_key, s.dyn, s.ttl_cap,
                  [(k, v) for k, v, _ in s.variants])
                 for s in r_spec.sources], cfg_id
        assert port_nf.fast_lane_eligible(
            p_by_id["ns/slow-tmpl"], p_snap.policy) is None
        assert port_nf.fast_lane_eligible(
            p_by_id["ns/hybrid"], p_snap.policy).hybrid
        # the plan kinds and event codes the C++ side pins
        for name in ("K_CONST", "K_METHOD", "K_PATH", "K_URL_PATH",
                     "K_QUERY", "K_HOST", "K_SCHEME", "K_PROTOCOL",
                     "K_SIZE", "K_FRAGMENT", "K_HEADER", "K_CTX_EXT",
                     "EV_TIMEOUT", "EV_BATCH", "EV_SNAP_RETIRED",
                     "EV_STOPPED"):
            assert getattr(port_nf, name) == getattr(ref_nf, name), name
        src = (p_native.CSRC_DIR / "frontend.cpp").read_text()
        assert ("K_CONST = 0, K_METHOD, K_PATH, K_URL_PATH, K_QUERY, "
                "K_HOST, K_SCHEME,\n  K_PROTOCOL, K_SIZE, K_FRAGMENT, "
                "K_HEADER, K_CTX_EXT,") in src
        assert ("EV_TIMEOUT = 0, EV_BATCH = 1, EV_SNAP_RETIRED = 3, "
                "EV_STOPPED = 4") in src
        assert ("V_ALLOW = %d, V_UNAVAILABLE = %d" % (
            port_nf.V_ALLOW, port_nf.V_UNAVAILABLE)) in src
    finally:
        stack.close()


@bounded(240)
def test_stats_and_debug_vars_keys(reference):
    """The port's fe_stats keys are the reference's plus ``unavailable``,
    ``drain_refused`` and the backlog its drain waits out;
    stats() adds the verdict cache's and the frontend's own counts;
    debug_vars() carries the knobs, the breaker, admission, the ledger,
    the serving snapshot, the engine's change-safety state and its tenant
    plane."""
    stack = PortStack()
    try:
        call(stack.port, REQUESTS[0])
        ref_keys = set(reference.fe.stats())
        port_keys = set(stack.fe.stats())
        fe_own = {k for k in port_keys if k.startswith("fe_")}
        assert port_keys - fe_own == ref_keys | {
            "unavailable", "drain_refused", "batches_pending", "filling",
            "done_queued"}
        assert fe_own == {f"fe_{k}" for k in stack.fe.counts}
        dv = stack.fe.debug_vars()
        assert set(dv) == {
            "enabled", "running", "port", "nghttp2", "device",
            "host_degrade", "stats", "max_batch", "window_us", "slots",
            "dispatch_threads", "inflight_batches", "inflight_peak",
            "trace_sample_n", "batch_dedup", "verdict_cache", "breaker",
            "device_timeout_s", "admission", "slo", "provenance",
            "kernel_cost", "change_safety", "snapshot", "tenancy"}
        assert dv["change_safety"] == stack.engine.change_safety_vars()
        # the engine's tenant plane, shared (the reference's key)
        assert "tenancy" in reference.fe.debug_vars()
        assert dv["tenancy"] == stack.engine.tenancy.to_json()
        assert dv["snapshot"]["warm_done"] and dv["host_degrade"] is True
        assert dv["snapshot"]["fast_configs"] == sum(
            1 for e in stack.engine._snapshot.entries
            if port_nf.fast_lane_eligible(e, stack.engine._snapshot.policy)
            is not None and e.rules is not None)
        # the corpus's one hybrid config; no dyn source in it
        assert (dv["snapshot"]["hybrid_configs"],
                dv["snapshot"]["dyn_registrations"]) == (1, 0)
        ref_snap = reference.fe.debug_vars()["snapshot"]
        assert {k: dv["snapshot"][k] for k in (
            "fast_configs", "hybrid_configs", "dyn_registrations")} == \
            {k: ref_snap[k] for k in (
                "fast_configs", "hybrid_configs", "dyn_registrations")}
        json.dumps(dv)
        assert dv["kernel_cost"]["ledger"]["native"]["rows"] >= 1
    finally:
        stack.close()


# ---------------------------------------------------------------------------
# dedup, cache, swap, drain
# ---------------------------------------------------------------------------


@bounded(240)
def test_batch_dedup_and_the_verdict_cache():
    """A burst of duplicate fast-lane requests gathers into slots whose
    unique rows alone reach the kernel's plain version; a second burst is
    answered by the cache with no call at all; every answer equals the
    grpc.aio server's."""
    stack = PortStack(window_us=20000)
    try:
        burst = [REQUESTS[k % 2] for k in range(32)]   # two distinct rows
        want = [call(stack.py_port, r) for r in REQUESTS[:2]]
        c0 = dict(stack.fe.counts)
        got = call_many(stack.port, burst)
        assert got == [want[k % 2] for k in range(32)]
        c1 = dict(stack.fe.counts)
        d = {k: c1[k] - c0[k] for k in c1}
        assert d["rows"] == 32
        assert d["device_rows"] + d["dedup_rows"] + d["cache_rows"] == 32
        # at most the two distinct rows per slot that reached the kernel
        assert d["device_rows"] <= 2 * (d["batches"] - d["cached_batches"])
        assert d["plain_calls"] == d["batches"] - d["cached_batches"]
        assert d["dedup_rows"] >= 1
        got2 = call_many(stack.port, burst)
        assert got2 == got
        c2 = dict(stack.fe.counts)
        assert c2["cache_rows"] - c1["cache_rows"] == 32
        assert c2["plain_calls"] == c1["plain_calls"]
        assert c2["device_rows"] == c1["device_rows"]
    finally:
        stack.close()


@bounded(240)
def test_cache_off_every_row_rides_the_kernel():
    """With ``verdict_cache_size=0, batch_dedup=False`` every fast-lane
    row reaches the kernel (here its plain version): device rows equal
    rows, and each slot is one call."""
    stack = PortStack(verdict_cache_size=0, batch_dedup=False,
                      window_us=20000)
    try:
        burst = [REQUESTS[k % 2] for k in range(24)]
        c0 = dict(stack.fe.counts)
        call_many(stack.port, burst)
        c1 = dict(stack.fe.counts)
        assert c1["rows"] - c0["rows"] == 24
        assert c1["device_rows"] - c0["device_rows"] == 24
        assert c1["plain_calls"] - c0["plain_calls"] == \
            c1["batches"] - c0["batches"]
        assert c1["cache_rows"] == c0["cache_rows"] == 0
    finally:
        stack.close()


@bounded(240)
def test_a_swap_is_seen_by_the_next_request():
    """``apply_snapshot`` with a changed rule: the swap listener rebuilds
    the C++ snapshot, the next request answers by the new rule, and the
    superseded snapshot retires."""
    stack = PortStack()
    try:
        req = make_req("fast-eq.test", headers={"x-org": "evil"})
        assert pb.CheckResponse.FromString(
            call(stack.port, req)).status.code == 7
        engine = stack.engine
        entries = [e for e in build_corpus(PORT, engine)
                   if e.id != "ns/fast-eq"]
        rule = PORT.Pattern("request.headers.x-org", PORT.Operator.EQ, "evil")
        pm = PORT.PatternMatching(
            rule, batched_provider=engine.provider_for("ns/fast-eq"),
            evaluator_slot=0, attributor=engine.attribution_for("ns/fast-eq"))
        entries.append(PORT.EngineEntry(
            id="ns/fast-eq", hosts=["fast-eq.test"],
            runtime=PORT.RuntimeAuthConfig(
                labels={"namespace": "ns", "name": "fast-eq"},
                identity=[PORT.IdentityConfig("anon", PORT.Noop())],
                authorization=[PORT.AuthorizationConfig("rules", pm)]),
            rules=PORT.ConfigRules(name="ns/fast-eq",
                                   evaluators=[(None, rule)])))
        engine.apply_snapshot(entries)
        assert stack.fe._cur_rec.snap_id == 2
        got = call(stack.port, req)
        assert pb.CheckResponse.FromString(got).status.code == 0
        assert got == call(stack.py_port, req)
        deadline = time.monotonic() + 20
        while len(stack.fe._snaps) > 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert list(stack.fe._snaps) == [2]
    finally:
        stack.close()


@bounded(120)
def test_stop_drains_in_flight_slow_requests():
    """stop() with a slow-lane request in flight (a metadata call that
    sleeps) answers it before the listener goes."""
    import concurrent.futures

    class SleepyMeta:
        async def call(self, pipeline):
            await asyncio.sleep(1.0)
            return {}

    engine = PORT.PolicyEngine(max_batch=16, device="cpu")
    engine.apply_snapshot([PORT.EngineEntry(
        id="ns/sleepy", hosts=["sleepy.test"],
        runtime=PORT.RuntimeAuthConfig(
            identity=[PORT.IdentityConfig("anon", PORT.Noop())],
            metadata=[PORT.MetadataConfig("m", SleepyMeta())]))])
    fe = port_nf.NativeFrontend(engine, port=0, max_batch=16, window_us=500)
    stopped = False
    try:
        port = fe.start()
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            fut = pool.submit(call, port, make_req("sleepy.test"))
            deadline = time.monotonic() + 5
            while fe.stats().get("slow", 0) < 1 and time.monotonic() < deadline:
                time.sleep(0.02)
            t0 = time.monotonic()
            fe.stop()
            stopped = True
            resp = pb.CheckResponse.FromString(fut.result(timeout=10))
            assert resp.status.code == 0
            assert time.monotonic() - t0 < 8
    finally:
        if not stopped:
            fe.stop()


# ---------------------------------------------------------------------------
# failures
# ---------------------------------------------------------------------------


@bounded(240)
def test_cpu_degrade_under_an_open_breaker_equals_the_reference(reference):
    """``device-down`` armed in both packages (breaker threshold 1): a
    fast-lane slot fails, retries, and is re-decided on the host; the
    port's answers equal its healthy answers and the reference's degraded
    ones (provenance aside), every row counted as degraded, none
    UNAVAILABLE."""
    stack = PortStack(breaker_threshold=1, breaker_reset_s=60.0,
                      verdict_cache_size=0)
    fast = [r for r in REQUESTS[:12]]
    try:
        healthy = [call(stack.port, r) for r in fast]
        d0 = stack.fe.counts["degraded_rows"]
        h0 = LEDGER.snapshot("host")["rows"]
        port_faults.FAULTS.arm("device-down", seed=7)
        ref_faults.FAULTS.arm("device-down", seed=7)
        degraded = [call(stack.port, r) for r in fast]
        ref_degraded = [call(reference.port, r) for r in fast]
        assert degraded == healthy
        assert [as_dict(a, True) for a in degraded] == \
            [as_dict(b, True) for b in ref_degraded]
        n_kernel = stack.fe.counts["degraded_rows"] - d0
        assert n_kernel >= 1
        assert LEDGER.snapshot("host")["rows"] - h0 == n_kernel
        assert stack.fe.counts["unavailable_rows"] == 0
        assert stack.fe.breaker.state == "open"
        assert stack.fe.counts["breaker_open_batches"] >= 1
    finally:
        port_faults.FAULTS.disarm()
        ref_faults.FAULTS.disarm()
        stack.close()
    time.sleep(0.3)   # the reference's breaker half-opens for later tests


@bounded(240)
def test_card_frontend_answers_unavailable_never_the_oracle(monkeypatch):
    """A card engine (its device a stub: launches count as the card's and
    every readback fails) answers each fast-lane slot it could not decide
    UNAVAILABLE — the first after its retry, then every slot the open
    breaker keeps off the card — and never through the kernel's plain
    version or a host lane: nothing counts as degraded."""
    stack = PortStack(breaker_threshold=2, breaker_reset_s=60.0,
                      verdict_cache_size=0, batch_dedup=False)
    try:
        stack.engine.device = torch.device("cuda")
        assert stack.fe.host_degrade is False

        class CardHandle:
            launches, plain_calls = 1, 0

            def __init__(self, nbytes):
                self.nbytes = nbytes

            def is_ready(self):
                return True

            def wait(self):
                raise RuntimeError("readback failed: secret detail")

        launches = []

        def stub_dispatch(params, db):
            launches.append(db)
            W = p_fk.packed_width(1 + 2 * int(params["eval_rule"].shape[1]))
            return CardHandle(int(db.attrs_val.shape[0]) * W)

        def not_on_a_card(*a, **k):
            raise AssertionError("a card frontend answered through "
                                 "another lane")

        monkeypatch.setattr(p_fk, "dispatch_megakernel", stub_dispatch)
        monkeypatch.setattr(p_fk, "fused_packed_plain", not_on_a_card)
        monkeypatch.setattr(p_fk, "eval_fused_kernel", not_on_a_card)
        monkeypatch.setattr(stack.fe, "_host_eval", not_on_a_card)
        p0 = p_fk.plain_calls
        h0 = LEDGER.snapshot("host")["rows"]
        unavailable = wire.encode_check_response(
            port_nf.check_response_from_result(port_nf.AuthResult(
                code=14, message=port_nf.UNAVAILABLE_MSG)))
        fast = REQUESTS[:4] + REQUESTS[7:12]
        got = [call(stack.port, r) for r in fast]
        assert got == [unavailable] * len(fast)
        assert b"secret" not in b"".join(got)
        # identity-only decisions never need the card
        ok_key = call(stack.port, REQUESTS[12])
        assert pb.CheckResponse.FromString(ok_key).status.code == 0
        c = stack.fe.counts
        assert len(launches) == 2          # the first slot and its retry
        assert c["unavailable_rows"] == len(fast)
        assert c["degraded_rows"] == 0
        assert c["breaker_open_batches"] == len(fast) - 1
        assert p_fk.plain_calls == p0
        assert LEDGER.snapshot("host")["rows"] == h0
        assert stack.fe.stats()["unavailable"] == len(fast)
        assert stack.fe.breaker.state == "open"
    finally:
        stack.close()


# ---------------------------------------------------------------------------
# the load generator and the helpers
# ---------------------------------------------------------------------------


@bounded(240)
def test_loadgen_prints_its_json_line(tmp_path):
    """The port's load generator builds from its own source and, against
    the port's frontend for one short pass, prints one JSON line with the
    reference generator's keys, every request answered."""
    from authorino_tpu import native as r_native

    port_lg = str(p_native.build_loadgen())
    ref_lg = r_native.build_loadgen()
    assert ref_lg is not None
    assert "authorino_tpu_torch" in port_lg
    payloads = tmp_path / "wire.payloads"
    with open(payloads, "wb") as f:
        for b in REQUESTS[:12]:
            f.write(struct.pack(">I", len(b)) + b)
    stack = PortStack()
    try:
        out = {}
        for name, lg in (("port", port_lg), ("ref", ref_lg)):
            proc = subprocess.run(
                [lg, "127.0.0.1", str(stack.port), str(payloads), "1", "0.2",
                 "16", "1"], capture_output=True, text=True, timeout=60)
            assert proc.returncode == 0, proc.stderr
            lines = proc.stdout.strip().splitlines()
            assert len(lines) == 1
            out[name] = json.loads(lines[0])
        assert set(out["port"]) == set(out["ref"]) == {
            "total", "seconds", "rps", "p50_ms", "p90_ms", "p99_ms",
            "errors", "conns", "depth"}
        assert out["port"]["total"] > 0 and out["port"]["errors"] == 0
        assert (out["port"]["conns"], out["port"]["depth"]) == (1, 16)
    finally:
        stack.close()


TEMPLATES = ["plain", "{auth.identity.name}", "a {x} b {y.z} c",
             "esc \\{not} {yes}", "nested {a@mod:{\"k\":1}} tail",
             "{}", "{unterminated", "\\\\{x}", "{a}{b}{c}"]


def test_template_selectors_equal_reference():
    for t in TEMPLATES:
        assert p_value.template_selectors(t) == r_value.template_selectors(t)


def test_cache_key_pattern_and_remaining_equal_reference():
    for ns, mod in ((REF, r_cache), (PORT, p_cache)):
        c = mod.EvaluatorCache(ns.JSONValue(pattern="request.headers.x-k"), 60)
        s = mod.EvaluatorCache(ns.JSONValue(static="k"), 60)
        assert (c.key_pattern, s.key_pattern) == ("request.headers.x-k", "")
        assert c.remaining(None) is None and c.remaining("absent") is None
        c.set("k", {"v": 1})
        rem = c.remaining("k")
        assert 59 < rem <= 60
    short = [mod.EvaluatorCache(ns.JSONValue(static="k"), 0)
             for ns, mod in ((REF, r_cache), (PORT, p_cache))]
    for c in short:
        c.set("k", 1)
    assert [c.remaining("k") for c in short] == [None, None]


def test_snapshot_secrets_equal_reference():
    out = []
    for ns in (REF, PORT):
        ak = ns.APIKey("k", ns.LabelSelector.from_spec(
            {"matchLabels": {"g": "x"}}),
            credentials=ns.AuthCredentials(key_selector="APIKEY"))
        for i in range(3):
            ak.add_k8s_secret_based_identity(ns.Secret(
                namespace="ns", name=f"s{i}", labels={"g": "x"},
                annotations={"n": str(i)}, data={"api_key": f"key{i}".encode()}))
        snap = ak.snapshot_secrets()
        ak.add_k8s_secret_based_identity(ns.Secret(
            namespace="ns", name="s3", labels={"g": "x"},
            data={"api_key": b"key3"}))
        assert len(snap) == 3   # a copy: later changes do not show
        out.append({k: s.to_identity_object() for k, s in snap.items()})
    assert out[0] == out[1]


def test_native_frontend_metric_families_equal_reference():
    """The frontend's metric families carry the reference's names, types,
    labels and buckets (each package's module in a process of its own),
    and the series made before they first move are the reference's, the
    C++ credential cache's ``dyn_*`` included."""
    import os
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    code = (
        "import importlib, json, sys\n"
        "m = importlib.import_module(sys.argv[1])\n"
        "out = {}\n"
        "for a in ('frontend_stage_duration', 'native_frontend_events', "
        "'native_frontend_queue_depth'):\n"
        "    c = getattr(m, a)\n"
        "    out[a] = [c._name, c._type, list(c._labelnames), "
        "list(getattr(c, '_upper_bounds', []))]\n"
        "out['keys'] = [list(m.NATIVE_QUEUE_KEYS), "
        "list(m.NATIVE_ENSURE_KEYS)]\n"
        "print(json.dumps(out))\n")
    got = []
    for mod in ("authorino_tpu_torch.utils.metrics",
                "authorino_tpu.utils.metrics"):
        proc = subprocess.run([sys.executable, "-c", code, mod],
                              cwd=str(root), capture_output=True, text=True,
                              env=dict(os.environ, PYTHONPATH=str(root)),
                              timeout=300)
        assert proc.returncode == 0, proc.stderr
        got.append(json.loads(proc.stdout))
    port, ref = got
    assert port == ref
    assert {"dyn_hit", "dyn_miss", "dyn_add"} <= set(port["keys"][1])


def test_verdict_codes_name_the_first_failing_column_by_priority():
    """``_codes``: allowed rows answer V_ALLOW; a denied row names its
    config's first failing column in priority order (a column the
    condition skipped does not fail)."""
    rec = port_nf._SnapRec(snap_id=1, policy=None, params=None, encoder=None)
    rec.col_rank = np.array([[0, 1, 2], [2, 0, 1]], dtype=np.int16)
    fe = port_nf.NativeFrontend.__new__(port_nf.NativeFrontend)
    E = 3
    # columns: [verdict, rule x3, skipped x3]
    cols = np.array([
        [1, 1, 1, 1, 0, 0, 0],     # allowed
        [0, 0, 0, 1, 0, 0, 0],     # config 0: columns 0, 1 fail → 0
        [0, 0, 0, 1, 0, 0, 0],     # config 1: column 1 first by rank
        [0, 0, 1, 0, 1, 0, 0],     # config 0: 0 skipped, 2 fails → 2
    ], dtype=bool)
    rows = np.array([0, 0, 1, 0])
    codes, firing = fe._codes(rec, rows, cols, E)
    assert codes.tolist() == [port_nf.V_ALLOW, port_nf.V_COL0 + 0,
                              port_nf.V_COL0 + 1, port_nf.V_COL0 + 2]
    assert firing.tolist() == [-1, 0, 0, 2]


def test_backlog_keys_are_read_by_the_drain_not_exported():
    """The port's backlog keys (``batches_pending``, ``filling``,
    ``done_queued``) stay out of /metrics; the slow lane's queue gauges
    and the event counters are folded as the reference's."""
    from prometheus_client import generate_latest

    from authorino_tpu_torch.utils import metrics as m

    drain = m.NativeStatsDrain()
    drain.fold({"batches_pending": 3, "filling": 7, "done_queued": 2,
                "slow_queued": 5, "fast": 11})
    text = generate_latest().decode()
    for key in m.NATIVE_BACKLOG_KEYS:
        assert f'queue="{key}"' not in text and f'event="{key}"' not in text
    assert 'auth_server_native_frontend_queue_depth{queue="slow_queued"}' \
        in text
    assert 'auth_server_native_frontend_events_total{event="fast"}' in text


# (seconds since the first drain, slow-lane completions, queued + pending)
# per drain: a steady lane, a burst whose first drain interval sees few
# completions (the estimate jumps to queued / max(rate, 1)), and a lane
# that stalls
ADMISSION_FEEDS = {
    "steady": [(0, 0, 0), (2, 1000, 20), (4, 2000, 10), (6, 3000, 0)],
    "burst, few completions": [(0, 0, 0), (2, 1000, 0), (4, 1022, 4096),
                               (6, 2400, 2700), (8, 4000, 1100),
                               (10, 5100, 0), (12, 5100, 4096)],
    "stall": [(0, 0, 0), (2, 0, 64), (4, 0, 64), (6, 0, 64), (8, 0, 64),
              (10, 0, 64)],
}


@pytest.mark.parametrize("feed", sorted(ADMISSION_FEEDS))
def test_slow_lane_admission_feed_equals_reference(feed, monkeypatch):
    """``_feed_admission``, the slow lane's CoDel input (Little's law over
    one drain interval: queued / max(completions / seconds, 1)), moves the
    admission state as the reference's does on the same fe_stats()
    readings, the jump of an interval with few completions included."""
    from authorino_tpu.runtime import admission as r_adm
    from authorino_tpu_torch.runtime import admission as p_adm

    states = []
    for nf_mod, adm_mod in ((port_nf, p_adm), (ref_nf, r_adm)):
        fe = object.__new__(nf_mod.NativeFrontend)
        fe.admission = adm_mod.AdmissionController(
            "native", target_s=0.05, interval_s=4.0)
        fe._slow_last = {"slow": 0.0, "t": 0.0}
        clock = {"t": 0.0}
        monkeypatch.setattr(nf_mod.time, "monotonic", lambda: clock["t"])
        out = []
        for t, done, queued in ADMISSION_FEEDS[feed]:
            clock["t"] = 100.0 + t
            fe.stats = lambda d=done, q=queued: {"slow": d, "slow_queued": q,
                                                 "slow_pending": 0}
            fe._feed_admission()
            out.append(fe.admission.to_json())
        states.append(out)
    assert states[0] == states[1]
    if feed == "burst, few completions":
        # 4,096 queued behind 22 completions in 2 s: ~372 s estimated
        assert states[0][2]["queue_wait_ewma_s"] > 100
