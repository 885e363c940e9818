"""The native frontend's verified-credential cache (OIDC/JWT, mTLS, OAuth2
introspection and Kubernetes TokenReview under a cache opt-in) and its
hybrid lane (authorization only partly kernel-covered), in the port
(``authorino_tpu_torch/runtime/native_frontend.py``) against the
reference's (``authorino_tpu/runtime/native_frontend.py``) and the port's
own grpc.aio server, over real loopback gRPC, on the CPU.

Both packages build one corpus (``build_dyn_corpus``) with their own
classes against one fake Keycloak (``models/oidc_corpus.FakeKeycloak``,
RSA-1024 keys from a seed), one CA and its client certificates
(``models/control_plane.CertAuthority``, P-256 keys from a seed) and an
in-memory cluster each.  The reference's stack is shared by the module
(its JAX warm-up is the slow part); each test starts a port stack of its
own (one C++ server per process) and stops it in ``finally``, under a
time bound (``bounded``).  Tolerance 0: the port's native answer is
byte-equal to its grpc.aio server's, and decoded it equals the
reference's native answer but for the provenance block of a kernel
denial (a divergence by design, ``tests/test_torch_native_frontend.py``).
Lane counts (``fast``, ``slow``, ``hybrid``, the C++ cache's ``dyn_*``)
are held equal to the reference's on the same request sequence: both
frontends run with the verdict cache off, so ``dyn_*`` counts the
credential cache alone."""

from __future__ import annotations

import asyncio
import importlib
import random
import threading
import time
import urllib.parse
from types import SimpleNamespace

import grpc
import pytest
import torch

from authorino_tpu_torch.models import control_plane as cp
from authorino_tpu_torch.models import oidc_corpus as oc
from authorino_tpu_torch.ops import fused_kernel as p_fk
from authorino_tpu_torch.pipeline.pipeline import AuthPipeline
from authorino_tpu_torch.protos import wire
from authorino_tpu_torch.runtime import native_frontend as port_nf
from authorino_tpu_torch.utils import jose, pki
from authorino_tpu_torch.utils import metrics as p_metrics
from test_torch_native_frontend import CHECK, as_dict, bounded, call, pb, \
    serve_grpc_aio
from torch_ref_native import ref_native_library

CLUSTER_USER = {"username": "system:serviceaccount:ns:app",
                "groups": ["system:authenticated"]}


@pytest.fixture(scope="module", autouse=True)
def _ref_native():
    """The reference's native library, loaded past a lost build race
    (``tests/torch_ref_native.py``) before any test here reaches it."""
    return ref_native_library()
OAUTH_TTL = 1          # the OAuth2 config's cache opt-in, seconds
K8S_TTL = 60           # the Kubernetes config's
PROC_REGO = "allow { count(input.request.path) > 5 }"   # does not lower
COUNTED = ("fast", "slow", "hybrid", "dyn_hit", "dyn_miss", "dyn_add")


def _ns(pkg: str) -> SimpleNamespace:
    def m(name):
        return importlib.import_module(f"{pkg}.{name}")

    ev, ident, expr = m("evaluators"), m("evaluators.identity"), m("expressions")
    k8s = m("k8s")
    return SimpleNamespace(
        pkg=pkg, ConfigRules=m("compiler").ConfigRules,
        AuthorizationConfig=ev.AuthorizationConfig,
        IdentityConfig=ev.IdentityConfig, ResponseConfig=ev.ResponseConfig,
        RuntimeAuthConfig=ev.RuntimeAuthConfig,
        JSONValue=m("authjson.value").JSONValue,
        OPA=m("evaluators.authorization").OPA,
        PatternMatching=m("evaluators.authorization").PatternMatching,
        Plain=m("evaluators.response").Plain,
        EvaluatorCache=m("evaluators.cache").EvaluatorCache,
        OIDC=ident.OIDC, MTLS=ident.MTLS, OAuth2=ident.OAuth2,
        KubernetesAuth=ident.KubernetesAuth, Noop=ident.Noop,
        Pattern=expr.Pattern, Operator=expr.Operator,
        LabelSelector=k8s.LabelSelector, Secret=k8s.Secret,
        InMemoryCluster=k8s.InMemoryCluster,
        EngineEntry=m("runtime").EngineEntry,
        PolicyEngine=m("runtime").PolicyEngine,
        nf=m("runtime.native_frontend"),
        build_server=m("service.grpc_server").build_server)


REF = _ns("authorino_tpu")
PORT = _ns("authorino_tpu_torch")


# ---------------------------------------------------------------------------
# the world both packages serve: a fake Keycloak, a CA, its certificates
# ---------------------------------------------------------------------------


class AuxLoop:
    """An asyncio loop on a thread of its own (the reference's OIDC
    refresh keeps its aiohttp session per loop)."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()

    def run(self, coro, timeout=60):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)


@pytest.fixture(scope="module")
def world():
    keys = oc.make_keys(31, rsa_bits=1024)
    idp = oc.FakeKeycloak(keys).start()
    rng = random.Random(17)
    O = cp.OID
    ca = cp.CertAuthority(pki.generate_ec_private_key(pki.P256, rng),
                          [[(O["CN"], "test-ca")]])
    foreign = cp.CertAuthority(pki.generate_ec_private_key(pki.P256, rng),
                               [[(O["CN"], "test-ca")]])

    def subject(org):
        return [[(O["CN"], "john")], [(O["O"], org, cp.PRINTABLE)]]

    aux = AuxLoop()
    try:
        yield SimpleNamespace(
            keys=keys, idp=idp, issuer=idp.issuer, ca_pem=ca.pem,
            leaf=ca.issue(subject("acme")),
            other_org=ca.issue(subject("evil")),
            rogue=foreign.issue(subject("acme")),
            # notAfter five minutes ahead: it, not the 600 s cap, bounds the
            # cache entry
            short_lived=ca.issue(subject("acme"),
                                 valid_days=1 + 300 / 86400),
            aux=aux)
    finally:
        aux.close()
        idp.stop()


def build_dyn_corpus(ns, engine, w):
    """Dyn-source and hybrid configs built with ``ns``'s classes, bound to
    ``engine``; returns (entries, the parts a test reaches into)."""
    P, Op = ns.Pattern, ns.Operator
    IdC, AC = ns.IdentityConfig, ns.AuthorizationConfig

    def pm(cfg_id, rule):
        return ns.PatternMatching(rule,
                                  batched_provider=engine.provider_for(cfg_id),
                                  evaluator_slot=0,
                                  attributor=engine.attribution_for(cfg_id))

    def entry(cfg_id, identity, authz=(), rules=(), response=()):
        nsp, _, nm = cfg_id.partition("/")
        return ns.EngineEntry(
            id=cfg_id, hosts=[f"{nm}.test"],
            runtime=ns.RuntimeAuthConfig(
                labels={"namespace": nsp, "name": nm}, identity=identity,
                authorization=list(authz), response=list(response)),
            rules=(ns.ConfigRules(name=cfg_id,
                                  evaluators=[(None, r) for r in rules])
                   if rules else None))

    def opt_in(ttl):
        return ns.EvaluatorCache(
            ns.JSONValue(pattern="request.headers.authorization"), ttl)

    def proc(cfg_id):
        return ns.OPA(f"{cfg_id}/rego", inline_rego=PROC_REGO)

    cluster = ns.InMemoryCluster()
    cluster.put_secret(ns.Secret(name="ca", namespace="ns",
                                 labels={"app": "mtls"},
                                 data={"ca.crt": w.ca_pem}))
    cluster.token_reviews["sa-token"] = {"status": {
        "authenticated": True, "user": dict(CLUSTER_USER)}}
    reviews = {"n": 0}
    review = cluster.token_review

    async def counted_review(token, audiences):
        reviews["n"] += 1
        return await review(token, audiences)

    cluster.token_review = counted_review
    mtls = ns.MTLS("mtls", ns.LabelSelector.parse("app=mtls"),
                   cluster=cluster)
    asyncio.run(mtls.load_secrets())
    oidc = ns.OIDC("kc", w.issuer)
    url = w.issuer + "/protocol/openid-connect/token/introspect"
    admin = P("auth.identity.realm_access.roles", Op.INCL, "admin")
    tier = P("request.headers.x-tier", Op.EQ, "gold")
    org = P("auth.identity.Organization", Op.EQ, "acme")
    sa = P("auth.identity.username", Op.EQ, CLUSTER_USER["username"])
    anon = [IdC("anon", ns.Noop())]
    entries = [
        entry("ns/oidc", [IdC("kc", oidc)], [AC("rules", pm("ns/oidc", admin))],
              [admin]),
        # identity-only: token validity is the decision
        entry("ns/oidc-only", [IdC("kc", oidc)]),
        # the Keycloak RBAC claims pattern beside a procedural Rego
        entry("ns/oidc-hyb", [IdC("kc", oidc)],
              [AC("rules", pm("ns/oidc-hyb", admin)),
               AC("rego", proc("ns/oidc-hyb"), priority=1)], [admin]),
        entry("ns/oauth-nocache",
              [IdC("oa", ns.OAuth2("oa", url, oc.CLIENT_ID,
                                   oc.CLIENT_SECRET))]),
        entry("ns/oauth",
              [IdC("oa", ns.OAuth2("oa", url, oc.CLIENT_ID, oc.CLIENT_SECRET),
                   cache=opt_in(OAUTH_TTL))]),
        entry("ns/k8s",
              [IdC("k8s", ns.KubernetesAuth("k8s", audiences=["talker-api"],
                                            cluster=cluster),
                   cache=opt_in(K8S_TTL))],
              [AC("rules", pm("ns/k8s", sa))], [sa]),
        # no explicit audiences: the review's audience is the request host
        entry("ns/k8s-hostaud",
              [IdC("k8s", ns.KubernetesAuth("k8s", cluster=cluster),
                   cache=opt_in(K8S_TTL))]),
        entry("ns/mtls", [IdC("mtls", mtls)], [AC("rules", pm("ns/mtls", org))],
              [org]),
        entry("ns/mtls-only", [IdC("mtls", mtls)]),
        entry("ns/hyb", anon, [AC("rules", pm("ns/hyb", tier)),
                               AC("rego", proc("ns/hyb"))], [tier]),
        # per-request response templates are fine on a hybrid config
        entry("ns/hr", anon, [AC("rules", pm("ns/hr", tier)),
                              AC("rego", proc("ns/hr"))], [tier],
              response=[ns.ResponseConfig("x-path", ns.Plain(
                  ns.JSONValue(pattern="request.path")))]),
        # the uncovered Rego in an EARLIER bucket: no hybrid lane
        entry("ns/hp", anon, [AC("rules", pm("ns/hp", tier), priority=1),
                              AC("rego", proc("ns/hp"), priority=0)], [tier]),
    ]
    return entries, SimpleNamespace(oidc=oidc, mtls=mtls, cluster=cluster,
                                    reviews=reviews)


CONFIG_IDS = ("ns/oidc", "ns/oidc-only", "ns/oidc-hyb", "ns/oauth-nocache",
              "ns/oauth", "ns/k8s", "ns/k8s-hostaud", "ns/mtls",
              "ns/mtls-only", "ns/hyb", "ns/hr", "ns/hp")


class Stack:
    """One package's CPU engine over the corpus, its NativeFrontend (the
    verdict cache off unless asked) and its grpc.aio server."""

    def __init__(self, ns, w, **fe_kw):
        engine_kw = ({"device": "cpu"} if ns is PORT else {"mesh": None})
        # the frontends' host lanes off in both packages: every fast-lane
        # slot rides the kernel's path
        fe_kw = dict(dict(lane_select=False, brownout=False), **fe_kw)
        self.ns = ns
        self.engine = ns.PolicyEngine(max_batch=16, **engine_kw)
        self.entries, self.parts = build_dyn_corpus(ns, self.engine, w)
        self.engine.apply_snapshot(self.entries)
        self.fe = ns.nf.NativeFrontend(
            self.engine, port=0,
            **dict(dict(max_batch=16, window_us=500, verdict_cache_size=0),
                   **fe_kw))
        self._stop_grpc = None
        try:
            self.port = self.fe.start()
            assert self.fe.wait_warm(300)
            self.py_port, self._stop_grpc = serve_grpc_aio(ns.build_server,
                                                           self.engine)
        except BaseException:
            self.close()
            raise

    def counts(self):
        s = self.fe.stats()
        return {k: s.get(k, 0) for k in COUNTED}

    def close(self):
        if self._stop_grpc is not None:
            self._stop_grpc()
            self._stop_grpc = None
        self.fe.stop(drain_s=5)


@pytest.fixture(scope="module")
def reference(world):
    stack = Stack(REF, world)
    try:
        yield stack
    finally:
        stack.close()


def req(host, path="/", headers=None, cert=None) -> bytes:
    r = pb.CheckRequest()
    http = r.attributes.request.http
    http.method, http.path, http.host = "GET", path, host
    for k, v in (headers or {}).items():
        http.headers[k] = v
    if cert is not None:
        r.attributes.source.certificate = urllib.parse.quote(cert)
    return r.SerializeToString()


def entry_of(snap, cfg_id):
    """The snapshot's entry ``cfg_id`` (the reference's snapshot indexes
    them by id, the port's lists them)."""
    by_id = getattr(snap, "by_id", None)
    if by_id is not None:
        return by_id[cfg_id]
    return next(x for x in snap.entries if x.id == cfg_id)


def bearer(token):
    return {"authorization": f"Bearer {token}"}


def code(raw: bytes) -> int:
    return pb.CheckResponse.FromString(raw).status.code


def delta(after, before):
    return {k: after[k] - before[k] for k in after}


def settle(read, want, timeout=10.0):
    """Poll ``read()`` until it equals ``want`` (telemetry lands after the
    answer does) and return its last value."""
    deadline = time.monotonic() + timeout
    got = read()
    while got != want and time.monotonic() < deadline:
        time.sleep(0.02)
        got = read()
    return got


def held(port: Stack, ref: Stack, payloads, races=()):
    """Send ``payloads`` one at a time to the port's frontend, its
    grpc.aio server and the reference's frontend; assert the port's
    answers byte-equal to its grpc.aio server's and (decoded, provenance
    aside) to the reference's, and the lane counts equal the reference's.
    ``races`` lists the payloads on which a hybrid config's covered and
    uncovered evaluators of one priority bucket both fail: the pipeline
    names whichever failed first, the kernel the covered one (both within
    the reference's semantics), so the two answers are held equal but for
    the denying rule's provenance.  Returns the port's answers and its
    count deltas."""
    p0, r0 = port.counts(), ref.counts()
    out = []
    for i, payload in enumerate(payloads):
        native = call(port.port, payload)
        ref_native = call(ref.port, payload)
        out.append(native)
        aio = call(port.py_port, payload)
        if i in races:
            assert as_dict(native, True) == as_dict(aio, True), f"#{i}"
        else:
            assert native == aio, f"payload #{i}"
        assert as_dict(native, drop_provenance=True) == as_dict(
            ref_native, drop_provenance=True), f"payload #{i}"
    dp, dr = delta(port.counts(), p0), delta(ref.counts(), r0)
    assert dp == dr, (dp, dr)
    return out, dp


# ---------------------------------------------------------------------------
# eligibility
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg_id", CONFIG_IDS)
def test_eligibility_equals_reference(world, cfg_id):
    """``fast_lane_eligible`` of the port equals the reference's on each
    dyn-source and hybrid config: eligible or not, hybrid or not, its
    plans, its attr rows and its sources (kind, key, dyn, TTL cap)."""
    specs = []
    for ns in (REF, PORT):
        engine = (ns.PolicyEngine(max_batch=8, device="cpu") if ns is PORT
                  else ns.PolicyEngine(max_batch=8, mesh=None))
        entries, _ = build_dyn_corpus(ns, engine, world)
        engine.apply_snapshot(entries)
        snap = engine._snapshot
        e = entry_of(snap, cfg_id)
        specs.append(ns.nf.fast_lane_eligible(e, snap.policy))
    r, p = specs
    assert (r is None) == (p is None)
    want_none = cfg_id in ("ns/oauth-nocache", "ns/k8s-hostaud", "ns/hp")
    assert (p is None) == want_none
    if p is None:
        return
    assert (p.hybrid, p.has_batch, p.plans, p.auth_attrs,
            p.deny_templated) == (r.hybrid, r.has_batch, r.plans,
                                  r.auth_attrs, r.deny_templated)
    assert [(s.cred_kind, s.cred_key, s.dyn, s.ttl_cap, s.missing_msg)
            for s in p.sources] == \
        [(s.cred_kind, s.cred_key, s.dyn, s.ttl_cap, s.missing_msg)
         for s in r.sources]
    # a hybrid config's column order lists its covered columns only
    assert p.col_order == ([0] if p.has_batch else [])


# ---------------------------------------------------------------------------
# the reference's native-frontend tests, held side by side
# ---------------------------------------------------------------------------


@bounded(240)
def test_oidc_token_cache_equals_reference(world, reference):
    """First sight of a token verifies in the slow lane and registers it;
    repeats ride the fast lane (claims resolved from the cache, the
    wrong role denied by the kernel); an identity-only config answers a
    cached token in C++; misses, bad tokens and missing credentials
    answer as the pipeline does."""
    idp = world.idp
    admin = idp.token({"realm_access": {"roles": ["admin"]}, "sub": "a-1"})
    user = idp.token({"realm_access": {"roles": ["user"]}, "sub": "u-1"})
    port = Stack(PORT, world)
    try:
        first = [req("oidc.test", headers=bearer(admin)),
                 req("oidc.test", headers=bearer(user)),
                 req("oidc-only.test", headers=bearer(admin))]
        out, d = held(port, reference, first)
        assert [code(x) for x in out] == [0, 7, 0]
        assert d == dict(fast=0, slow=3, hybrid=0, dyn_hit=0, dyn_miss=3,
                         dyn_add=3)
        matrix = first + [
            req("oidc.test", headers=bearer("not-a-token")),
            req("oidc.test", headers={"authorization": "Basic zzz"}),
            req("oidc.test"),
            req("oidc-only.test"),
        ]
        out, d = held(port, reference, matrix)
        assert [code(x) for x in out] == [0, 7, 0, 16, 16, 16, 16]
        # the three registered tokens now ride the fast lane
        # the three registered tokens now ride the fast lane; the missing
        # credentials answer there too, from the static templates
        assert (d["fast"], d["dyn_hit"], d["dyn_add"]) == (6, 3, 0)
        assert port.fe.counts["dyn_registered"] == 3
        # the configs with a dyn source: oidc, oidc-only, oidc-hyb, oauth,
        # k8s, mtls, mtls-only
        assert port.fe.debug_vars()["snapshot"]["dyn_registrations"] == \
            reference.fe.debug_vars()["snapshot"]["dyn_registrations"] == 7
    finally:
        port.close()


@bounded(240)
def test_oidc_jwks_rotation_drops_the_cache(world, reference):
    """A rotation of the provider's keys refreshes the frontend (a thread
    of its own, joined by stop()): a token signed by the retired key is
    never answered OK again, in both packages; a token of the new key
    registers and rides fast."""
    idp, keys = world.idp, world.keys
    old = idp.token({"realm_access": {"roles": ["admin"]}, "sub": "rot-1"})
    port = Stack(PORT, world)
    before = list(idp.jwks)
    try:
        _, d = held(port, reference, [req("oidc.test", headers=bearer(old))] * 2)
        assert (d["dyn_add"], d["dyn_hit"]) == (1, 1)
        snap0 = port.fe._cur_rec.snap_id
        idp.jwks = [jose.jwk_from_public_key(keys.rogue.public_key(),
                                             kid=oc.ROGUE_KID), before[1]]
        asyncio.run(port.parts.oidc.refresh())
        world.aux.run(reference.parts.oidc.refresh())
        deadline = time.monotonic() + 60
        while (port.fe._cur_rec.snap_id == snap0
               and time.monotonic() < deadline):
            time.sleep(0.05)
        assert port.fe._cur_rec.snap_id > snap0
        assert len(port.fe._refresh_threads) >= 1
        while time.monotonic() < deadline:
            if code(call(reference.port, req(
                    "oidc.test", headers=bearer(old)))) == 16:
                break
            time.sleep(0.2)
        new = idp.token({"realm_access": {"roles": ["admin"]},
                         "sub": "rot-2"}, key=keys.rogue, kid=oc.ROGUE_KID)
        out, d = held(port, reference,
                      [req("oidc.test", headers=bearer(old)),
                       req("oidc.test", headers=bearer(new)),
                       req("oidc.test", headers=bearer(new))])
        assert [code(x) for x in out] == [16, 0, 0]
        assert (d["slow"], d["fast"], d["dyn_add"]) == (2, 1, 1)
    finally:
        idp.jwks = before
        asyncio.run(port.parts.oidc.refresh())
        world.aux.run(reference.parts.oidc.refresh())
        port.close()
        # stop() unwired the listener and joined every refresh thread
        assert port.fe._refresh_threads == []
        assert port.fe._on_oidc_change not in \
            port.parts.oidc._change_listeners


@bounded(240)
def test_oidc_cache_survives_a_reconcile_storm(world, reference):
    """Reconcile swaps drop the cache (a fresh snapshot, empty variant
    maps); under a storm of swaps with live traffic every answer stays
    OK, misses re-verify and re-register, hits serve natively — in both
    packages."""
    token = world.idp.token({"realm_access": {"roles": ["admin"]},
                             "sub": "storm"})
    payload = req("oidc.test", headers=bearer(token))
    port = Stack(PORT, world)
    try:
        for stack in (port, reference):
            call(stack.port, payload)   # prime
            base = list(stack.entries)
            stop = threading.Event()
            codes = []

            def loader():
                with grpc.insecure_channel(f"127.0.0.1:{stack.port}") as ch:
                    c = ch.unary_unary(CHECK, request_serializer=lambda b: b,
                                       response_deserializer=lambda b: b)
                    while not stop.is_set():
                        codes.append(code(c(payload, timeout=30)))

            adds = [stack.fe.stats()["dyn_add"]]
            hits0 = stack.fe.stats()["dyn_hit"]
            threads = [threading.Thread(target=loader) for _ in range(2)]
            for t in threads:
                t.start()
            try:
                for i in range(4):
                    ns, eng = stack.ns, stack.engine
                    rule = ns.Pattern("request.method", ns.Operator.NEQ,
                                      "DELETE")
                    extra = ns.EngineEntry(
                        id=f"ns/storm-{i}", hosts=[f"storm-{i}.test"],
                        runtime=ns.RuntimeAuthConfig(
                            identity=[ns.IdentityConfig("anon", ns.Noop())],
                            authorization=[ns.AuthorizationConfig(
                                "rules", ns.PatternMatching(
                                    rule, batched_provider=eng.provider_for(
                                        f"ns/storm-{i}"),
                                    evaluator_slot=0,
                                    attributor=eng.attribution_for(
                                        f"ns/storm-{i}")))]),
                        rules=ns.ConfigRules(name=f"ns/storm-{i}",
                                             evaluators=[(None, rule)]))
                    eng.apply_snapshot(base + [extra])
                    time.sleep(0.4)
                    adds.append(stack.fe.stats()["dyn_add"])
            finally:
                stop.set()
                for t in threads:
                    t.join(timeout=60)
            stack.engine.apply_snapshot(base)
            assert codes and all(c == 0 for c in codes), stack.ns.pkg
            assert adds[-1] >= adds[0] + 3, (stack.ns.pkg, adds)
            assert stack.fe.stats()["dyn_hit"] > hits0, stack.ns.pkg
    finally:
        port.close()


@bounded(240)
def test_oauth2_cache_opt_in_equals_reference(world, reference):
    """OAuth2 introspection rides the dyn lane only under a cache opt-in:
    within cache.ttl a repeat is fast and makes no introspection call;
    after it, one call again, and a revoked token answers
    UNAUTHENTICATED.  Without the opt-in every check introspects."""
    idp = world.idp
    path = "POST /protocol/openid-connect/token/introspect"
    port = Stack(PORT, world)
    try:
        for stack, tok in ((port, "opaque-port"), (reference, "opaque-ref")):
            idp.active_tokens[tok] = {"active": True, "username": "svc"}
            hdr = bearer(tok)
            n0 = idp.counts[path]
            c0 = stack.counts()
            r1 = call(stack.port, req("oauth.test", headers=hdr))
            t_reg = time.monotonic()
            r2 = call(stack.port, req("oauth.test", headers=hdr))
            n1 = idp.counts[path]
            assert (code(r1), code(r2)) == (0, 0)
            assert r1 == r2 == call(stack.py_port, req("oauth.test",
                                                       headers=hdr))
            if time.monotonic() - t_reg < 0.8 * OAUTH_TTL:
                # r2 within the window: no call; the grpc.aio server's
                # check hit the pipeline's own cache
                assert n1 - n0 == 1, stack.ns.pkg
                assert delta(stack.counts(), c0)["dyn_hit"] >= 1
            s0 = stack.counts()["slow"]
            n2 = idp.counts[path]
            for _ in range(2):
                assert code(call(stack.port, req("oauth-nocache.test",
                                                 headers=hdr))) == 0
            assert stack.counts()["slow"] - s0 == 2
            assert idp.counts[path] - n2 == 2
            # revocation shows once the opted-in window lapses
            idp.active_tokens[tok] = {"active": False}
            time.sleep(max(0.0, OAUTH_TTL + 0.3
                           - (time.monotonic() - t_reg)))
            n3 = idp.counts[path]
            r4 = call(stack.port, req("oauth.test", headers=hdr))
            assert code(r4) == 16, stack.ns.pkg
            assert idp.counts[path] - n3 == 1
            assert r4 == call(stack.py_port, req("oauth.test", headers=hdr))
    finally:
        port.close()


@bounded(240)
def test_oauth2_registration_off_a_pipeline_cache_hit_keeps_the_window(
        world):
    """A registration that follows a pipeline-cache hit is bounded by what
    is left of the opted-in window, not a fresh cache.ttl: the C++ entry
    never outlives the last real introspection by more than the TTL."""
    idp = world.idp
    idp.active_tokens["opaque-window"] = {"active": True, "username": "w"}
    port = Stack(PORT, world)
    calls = []
    mod = port.fe._mod

    class Spy:
        def __getattr__(self, name):
            return getattr(mod, name)

        def fe_add_variant(self, *a):
            calls.append((time.time(), a))
            return mod.fe_add_variant(*a)

    try:
        port.fe._mod = Spy()
        hdr = bearer("opaque-window")
        t_first = time.time()
        assert code(call(port.port, req("oauth.test", headers=hdr))) == 0
        # a snapshot swap drops the C++ entry but not the pipeline's cache
        port.engine.notify_swap_listeners()
        time.sleep(0.5 * OAUTH_TTL)
        assert code(call(port.port, req("oauth.test", headers=hdr))) == 0
        assert len(calls) == 2
        exp_ns = [a[-1] for _, a in calls]
        assert exp_ns[1] <= exp_ns[0] + 50_000_000
        assert exp_ns[1] / 1e9 <= t_first + OAUTH_TTL + 0.05
    finally:
        port.fe._mod = mod
        port.close()


@bounded(240)
def test_k8s_tokenreview_cache_opt_in_equals_reference(world, reference):
    """Kubernetes TokenReview under a cache opt-in with explicit
    audiences: the first review slow, repeats native with no review,
    the pattern over the reviewed user resolved from the cached
    identity; every answer as the pipeline's."""
    port = Stack(PORT, world)
    try:
        hdr = bearer("sa-token")
        reviews0 = (port.parts.reviews["n"], reference.parts.reviews["n"])
        out, d = held(port, reference, [
            req("k8s.test", headers=hdr), req("k8s.test", headers=hdr),
            req("k8s.test", headers=hdr),
            req("k8s.test", headers=bearer("bad")), req("k8s.test")])
        assert [code(x) for x in out] == [0, 0, 0, 16, 16]
        # the missing credential answers fast from the static template
        assert (d["dyn_add"], d["dyn_hit"], d["fast"]) == (1, 2, 3)
        # the native lanes: one review for the token, one for the bad
        # token; the port's grpc.aio server adds one for the bad token
        # (its good-token checks hit the pipeline's own cache)
        assert (port.parts.reviews["n"] - reviews0[0],
                reference.parts.reviews["n"] - reviews0[1]) == (3, 2)
    finally:
        port.close()


@bounded(240)
def test_hybrid_procedural_rego_equals_reference(world, reference):
    """A kernel denial answers natively with no slow-lane work; a kernel
    PASS is handed off and decided by the pipeline (the Rego allows or
    denies); every answer as the grpc.aio server's."""
    port = Stack(PORT, world)
    try:
        out, d = held(port, reference, [
            req("hyb.test", path="/abcdefg", headers={"x-tier": "wood"})])
        assert code(out[0]) == 7 and d["fast"] == 1 and d["slow"] == 0
        out, d = held(port, reference, [
            req("hyb.test", path="/ab", headers={"x-tier": "gold"}),
            req("hyb.test", path="/abcdefg", headers={"x-tier": "gold"})])
        assert [code(x) for x in out] == [7, 0]
        assert (d["hybrid"], d["slow"]) == (2, 2)
        matrix = [req("hyb.test", path=p, headers=h)
                  for p in ("/ab", "/abcdefg")
                  for h in ({"x-tier": "gold"}, {"x-tier": "wood"}, {})]
        # "/ab" fails the Rego: where the pattern fails too, a race
        out, d = held(port, reference, matrix, races=(1, 2))
        assert [code(x) for x in out] == [7, 7, 7, 0, 7, 7]
        assert d["hybrid"] == 2
        assert port.fe.debug_vars()["snapshot"]["hybrid_configs"] == 3
    finally:
        port.close()


def test_hybrid_priority_guard(world):
    """An uncovered evaluator in an EARLIER priority bucket than a covered
    one keeps the whole config slow, in both packages; its answers equal
    the pipeline's."""
    for ns in (REF, PORT):
        engine = (ns.PolicyEngine(max_batch=8, device="cpu") if ns is PORT
                  else ns.PolicyEngine(max_batch=8, mesh=None))
        entries, _ = build_dyn_corpus(ns, engine, world)
        engine.apply_snapshot(entries)
        snap = engine._snapshot
        hp, hyb = entry_of(snap, "ns/hp"), entry_of(snap, "ns/hyb")
        assert ns.nf.fast_lane_eligible(hp, snap.policy) is None
        assert ns.nf.fast_lane_eligible(hyb, snap.policy).hybrid


@bounded(240)
def test_hybrid_allows_arbitrary_responses(world, reference):
    """A hybrid OK runs the whole pipeline, so a per-request response
    template (which keeps a config off the full fast lane) is served; a
    kernel denial still answers natively."""
    port = Stack(PORT, world)
    try:
        out, d = held(port, reference, [
            req("hr.test", path="/abcdefg", headers={"x-tier": "gold"}),
            req("hr.test", path="/abcdefg", headers={"x-tier": "wood"})])
        ok = pb.CheckResponse.FromString(out[0])
        assert ok.status.code == 0
        assert {h.header.key: h.header.value
                for h in ok.ok_response.headers}["x-path"] == "/abcdefg"
        assert code(out[1]) == 7
        assert d["slow"] == d["hybrid"] == 1 and d["fast"] == 2
    finally:
        port.close()


@bounded(240)
def test_jwt_hybrid_equals_reference(world, reference):
    """The Keycloak RBAC claims pattern beside a procedural Rego in a
    later bucket (BASELINE's JWT and mixed-evaluator configs in one): a
    token's first sight verifies and registers in the slow lane; repeats
    ride the kernel — a denial final there, a PASS handed to the pipeline
    for the Rego; every answer byte-equal to the grpc.aio server's."""
    idp = world.idp
    admin = idp.token({"realm_access": {"roles": ["admin"]}, "sub": "h-a"})
    user = idp.token({"realm_access": {"roles": ["user"]}, "sub": "h-u"})
    port = Stack(PORT, world)
    try:
        first = [req("oidc-hyb.test", path="/abcdefg", headers=bearer(admin)),
                 req("oidc-hyb.test", path="/abcdefg", headers=bearer(user))]
        out, d = held(port, reference, first)
        assert [code(x) for x in out] == [0, 7]
        assert (d["slow"], d["dyn_add"], d["hybrid"]) == (2, 2, 0)
        out, d = held(port, reference, first + [
            req("oidc-hyb.test", path="/ab", headers=bearer(admin))])
        assert [code(x) for x in out] == [0, 7, 7]
        # the user's token denied by the kernel; the admin's two PASSes
        # decided by the pipeline (the second one by the Rego)
        assert (d["fast"], d["dyn_hit"], d["hybrid"], d["slow"]) == \
            (3, 3, 2, 2)
    finally:
        port.close()


@bounded(240)
def test_mtls_cert_cache_equals_reference(world, reference):
    """The forwarded client certificate is the credential: its first
    sight verifies in the slow lane, repeats ride fast, the subject's
    organization is resolved from the cached identity; a certificate of
    another CA, of another organization or none at all answers as the
    pipeline does."""
    port = Stack(PORT, world)
    try:
        first = [req("mtls.test", cert=world.leaf.decode()),
                 req("mtls-only.test", cert=world.leaf.decode()),
                 req("mtls.test", cert=world.other_org.decode())]
        out, d = held(port, reference, first)
        assert [code(x) for x in out] == [0, 0, 7]
        assert (d["slow"], d["dyn_add"]) == (3, 3)
        out, d = held(port, reference, first + [
            req("mtls.test", cert=world.rogue.decode()),
            req("mtls.test"), req("mtls-only.test")])
        assert [code(x) for x in out] == [0, 0, 7, 16, 16, 16]
        assert (d["fast"], d["dyn_hit"], d["dyn_add"]) == (5, 3, 0)
    finally:
        port.close()


# ---------------------------------------------------------------------------
# the port's own
# ---------------------------------------------------------------------------


@bounded(240)
def test_mtls_deadline_equals_cryptography(world, reference):
    """The cache entry of a certificate whose notAfter comes before
    the frontend's 600 s cap ends at notAfter: the port reads it with its own X.509
    reader (``utils/x509.py``), the reference with ``cryptography`` — on
    the same certificate both register the same deadline, the one
    ``cryptography`` reads."""
    from cryptography import x509 as c_x509

    pem = world.short_lived
    want = int(c_x509.load_pem_x509_certificate(pem).not_valid_after_utc
               .timestamp() * 1e9)
    got = {}
    port = Stack(PORT, world)
    spies = []
    try:
        for name, stack in (("port", port), ("ref", reference)):
            mod = stack.fe._mod

            class Spy:
                def __getattr__(self, attr, mod=mod):
                    return getattr(mod, attr)

                def fe_add_variant(self, *a, mod=mod, name=name):
                    got[name] = a[-1]
                    return mod.fe_add_variant(*a)

            spies.append((stack.fe, mod))
            stack.fe._mod = Spy()
            assert code(call(stack.port, req(
                "mtls-only.test", cert=pem.decode()))) == 0
        assert got == {"port": want, "ref": want}
    finally:
        for fe, mod in spies:
            fe._mod = mod
        port.close()


@bounded(240)
def test_expired_token_goes_slow_with_a_warm_verdict_cache(world):
    """A registered token past its ``exp`` misses the credential cache
    even while the verdict cache holds its row's verdict: it rides the
    slow lane (the pipeline's leeway decides), is not registered again,
    and answers as the grpc.aio server does."""
    token = world.idp.token({"realm_access": {"roles": ["admin"]},
                             "sub": "short", "exp": int(time.time()) + 2})
    payload = req("oidc.test", headers=bearer(token))
    port = Stack(PORT, world, verdict_cache_size=1024)
    try:
        assert code(call(port.port, payload)) == 0       # slow, registers
        assert code(call(port.port, payload)) == 0       # fast, cached row
        s = port.fe.stats()
        assert s["vdict_add"] >= 1 and port.fe.counts["dyn_registered"] == 1
        while time.time() < jose.decode_unverified(token)[1]["exp"] + 0.2:
            time.sleep(0.1)
        before = port.counts()
        v0 = port.fe.stats()["vdict_hit"]
        after_exp = [call(port.port, payload) for _ in range(2)]
        d = delta(port.counts(), before)
        assert (d["slow"], d["fast"]) == (2, 0)
        assert port.fe.stats()["vdict_hit"] == v0
        assert port.fe.counts["dyn_registered"] == 1
        assert after_exp == [call(port.py_port, payload)] * 2
    finally:
        port.close()


@bounded(240)
def test_hybrid_row_counted_once_in_authconfig_total(world):
    """``authconfig_total`` counts each hybrid request once: a kernel
    denial at completion, a handed-off PASS in the pipeline only."""
    child = p_metrics.authconfig_total.labels("ns", "hyb")
    ok = p_metrics.authconfig_response_status.labels("ns", "hyb", "OK")
    port = Stack(PORT, world)
    try:
        t0, ok0 = child._value.get(), ok._value.get()
        answers = [call(port.port, req("hyb.test", path=p,
                                       headers={"x-tier": t}))
                   for p, t in (("/abcdefg", "wood"), ("/ab", "gold"),
                                ("/abcdefg", "gold"), ("/abcdefg", "gold"))]
        assert [code(a) for a in answers] == [7, 7, 0, 0]
        assert settle(lambda: child._value.get() - t0, 4) == 4
        assert settle(lambda: ok._value.get() - ok0, 2) == 2
        time.sleep(0.2)   # nothing lands twice
        assert (child._value.get() - t0, ok._value.get() - ok0) == (4, 2)
        assert port.fe.stats()["hybrid"] == 3
    finally:
        port.close()


@bounded(240)
def test_card_frontend_never_hands_an_unavailable_hybrid_slot_on(
        world, monkeypatch):
    """On a card engine a hybrid slot the card did not decide answers
    UNAVAILABLE: it is never handed to the pipeline (nothing reaches the
    slow lane, no hybrid handoff) and never re-decided on the host."""
    port = Stack(PORT, world, breaker_threshold=2, breaker_reset_s=60.0,
                 batch_dedup=False)
    try:
        port.engine.device = torch.device("cuda")
        assert port.fe.host_degrade is False

        class CardHandle:
            launches, plain_calls = 1, 0

            def __init__(self, nbytes):
                self.nbytes = nbytes

            def is_ready(self):
                return True

            def wait(self):
                raise RuntimeError("readback failed")

        def stub_dispatch(params, db):
            W = p_fk.packed_width(1 + 2 * int(params["eval_rule"].shape[1]))
            return CardHandle(int(db.attrs_val.shape[0]) * W)

        def not_on_a_card(*a, **k):
            raise AssertionError("a card frontend answered through "
                                 "another lane")

        evaluated = []
        real_evaluate = AuthPipeline.evaluate

        async def spy_evaluate(self):
            evaluated.append(self)
            return await real_evaluate(self)

        monkeypatch.setattr(p_fk, "dispatch_megakernel", stub_dispatch)
        monkeypatch.setattr(p_fk, "fused_packed_plain", not_on_a_card)
        monkeypatch.setattr(p_fk, "eval_fused_kernel", not_on_a_card)
        monkeypatch.setattr(port.fe, "_host_eval", not_on_a_card)
        monkeypatch.setattr(AuthPipeline, "evaluate", spy_evaluate)
        unavailable = wire.encode_check_response(
            port_nf.check_response_from_result(port_nf.AuthResult(
                code=14, message=port_nf.UNAVAILABLE_MSG)))
        before = port.counts()
        got = [call(port.port, req("hyb.test", path="/abcdefg",
                                   headers={"x-tier": "gold"}))
               for _ in range(3)]
        assert got == [unavailable] * 3
        d = delta(port.counts(), before)
        assert (d["hybrid"], d["slow"]) == (0, 0)
        assert evaluated == []
        assert port.fe.counts["unavailable_rows"] == 3
        assert port.fe.counts["degraded_rows"] == 0
    finally:
        port.close()


@bounded(240)
def test_registration_lands_only_on_the_serving_snapshot(world):
    """A registration whose snapshot record was superseded while its
    pipeline ran (a rotation or a reconcile swapped it) is dropped, and
    one on the serving record lands and is counted."""
    token = world.idp.token({"realm_access": {"roles": ["admin"]},
                             "sub": "stale"})
    port = Stack(PORT, world)
    try:
        rec = port.fe._cur_rec
        port.engine.notify_swap_listeners()
        assert port.fe._cur_rec is not rec
        from authorino_tpu_torch.authjson import CheckRequestModel, \
            HttpRequestAttributes

        model = CheckRequestModel(http=HttpRequestAttributes(
            method="GET", path="/", host="oidc.test",
            headers=bearer(token)))
        entry = port.engine.lookup("oidc.test")
        pipeline = AuthPipeline(model, entry.runtime)
        assert asyncio.run(pipeline.evaluate()).code == 0
        port.fe._register_dyn(rec, entry, pipeline, model)
        assert port.fe.counts["dyn_registered"] == 0
        port.fe._register_dyn(port.fe._cur_rec, entry, pipeline, model)
        assert port.fe.counts["dyn_registered"] == 1
        assert port.fe.counts["dyn_register_ns"] > 0
        s0 = port.counts()
        assert code(call(port.port, req("oidc.test",
                                        headers=bearer(token)))) == 0
        assert delta(port.counts(), s0)["dyn_hit"] == 1
    finally:
        port.close()
