"""The Check() request path of the port against the JAX package's: the same
AuthConfig spec dict goes through both packages' ``translate_auth_config``,
the same Secrets into both ``InMemoryCluster``s, and the same request dicts
through both engines' ``check``; every AuthResult field must be equal
(tolerance 0).  The reference engine is built as tests/test_torch_engine.py
builds it (``mesh=None, lane_select=False, kernel_lane="fused"``); the port's
runs on the CPU, through the kernel's plain version.

Also here: the translate coverage table (every kind the reference
translates either translates to the same entry shape or is refused as not
yet in the port, and that list is the one ROADMAP.md names) and the
north-star request path at 40 AuthConfigs."""

import asyncio
import json
import re
from pathlib import Path

import pytest

from authorino_tpu_torch.controllers import translate as p_translate
from authorino_tpu_torch.models import northstar
from authorino_tpu_torch.runtime import PolicyEngine

from test_control_plane import V2_SPEC
from test_torch_compiler import PORT as PORT_C
from test_torch_compiler import REF as REF_C
from test_torch_compiler import assert_same_policy
from test_torch_pipeline import (PORT, REF, Stub, engine_of,
                                 port_request_to, request_of, result_fields,
                                 run)

ROOT = Path(__file__).resolve().parent.parent


def cluster_of(ns, secrets):
    cluster = ns.k8s.InMemoryCluster()
    for s in secrets:
        cluster.put_secret(ns.k8s.Secret(**s))
    return cluster


async def translate_all(ns, engine, configs, cluster):
    return [await ns.controllers.translate_auth_config(
        name, "t", spec, cluster=cluster, engine=engine)
        for name, spec in configs]


def check_all(ns, configs, secrets, requests, concurrent=False, setup=None):
    """Translate ``configs`` [(name, spec)] with one engine of ``ns``,
    install them in one snapshot, and answer ``requests`` [http dict].
    ``setup(cluster)`` seeds the cluster's reviews."""
    engine = engine_of(ns)
    cluster = cluster_of(ns, secrets)
    if setup is not None:
        setup(cluster)

    async def body():
        entries = await translate_all(ns, engine, configs, cluster)
        engine.apply_snapshot(entries)
        reqs = [request_of(ns, dict(r)) for r in requests]
        if concurrent:
            results = await asyncio.gather(*(engine.check(r) for r in reqs))
        else:
            results = [await engine.check(r) for r in reqs]
        return entries, results, engine

    return run(body())


def entry_shape(e):
    rt = e.runtime
    phases = {ph: [(c.name, c.type, c.priority, c.conditions is not None,
                    getattr(c.evaluator, "kernel_slot", None))
                   for c in getattr(rt, ph)]
              for ph in ("identity", "metadata", "authorization", "response",
                         "callbacks")}
    rules = (None if e.rules is None else
             [(str(c) if c is not None else None, str(r))
              for c, r in e.rules.evaluators])
    return (e.id, e.hosts, phases, rt.conditions is not None, rules)


# ---- the case table --------------------------------------------------------

KEY_SECRET = {"name": "client-1", "namespace": "t",
              "labels": {"audience": "talker-api", "role": "admin"},
              "data": {"api_key": b"secret-key-1"}}
USER_SECRET = {"name": "client-2", "namespace": "t",
               "labels": {"audience": "talker-api", "role": "user"},
               "data": {"api_key": b"secret-key-2"}}
OTHER_NS_SECRET = {"name": "client-3", "namespace": "elsewhere",
                   "labels": {"audience": "talker-api", "role": "admin"},
                   "data": {"api_key": b"secret-key-3"}}


def req(host, method="GET", path="/", headers=None):
    return {"method": method, "path": path, "host": host,
            "headers": headers or {}}


V2_HOST = "talker-api.example.com"
V2_REQUESTS = [
    req(V2_HOST, path="/admin/x", headers={"authorization": "APIKEY secret-key-1"}),
    req(V2_HOST, path="/admin/x"),
    req(V2_HOST, path="/admin/x", headers={"authorization": "APIKEY wrong"}),
    req(V2_HOST, path="/admin/x", headers={"authorization": "APIKEY secret-key-2"}),
    req(V2_HOST, path="/public"),
    req(V2_HOST, path="/public", headers={"authorization": "APIKEY secret-key-2"}),
    req(V2_HOST, method="OPTIONS", path="/admin/x"),
    req(V2_HOST + ":8000", path="/admin/x"),
    req(V2_HOST + ":8000", path="/public"),
    req("unknown.example.com", path="/admin/x"),
]

_ORG_RULE = {"rules": {"patternMatching": {"patterns": [
    {"selector": "request.headers.x-org", "operator": "eq", "value": "acme"}]}}}


def _gated(host, when, authentication):
    return {"hosts": [host], "when": when, "authentication": authentication,
            "authorization": _ORG_RULE}


def _methods(host, headers=None):
    return [req(host, m, "/x", dict(h, **(headers or {})))
            for m in ("OPTIONS", "GET", "POST")
            for h in ({}, {"x-org": "acme"}, {"x-org": "evil"})]


FOLD = _gated("gated.test", [{"selector": "request.method", "operator": "neq",
                              "value": "OPTIONS"}], {"anon": {"anonymous": {}}})
CREDENTIAL_GATE = _gated(
    "gated-key.test",
    [{"selector": "context.request.http.method", "operator": "neq",
      "value": "OPTIONS"}],
    {"keys": {"apiKey": {"selector": {"matchLabels": {"audience": "talker-api"}}}}})
AUTH_ROOTED_GATE = _gated(
    "gated-auth.test",
    [{"selector": "auth.identity.anonymous", "operator": "neq", "value": "true"}],
    {"anon": {"anonymous": {}}})
NESTED_GATE = dict(_gated(
    "gated-nest.test",
    [{"any": [{"selector": "request.method", "operator": "eq", "value": "GET"},
              {"patternRef": "who"}]}],
    {"anon": {"anonymous": {}}}),
    patterns={"who": [{"selector": "auth.identity.sub", "operator": "eq",
                       "value": "x"}]})
# an anonymous config whose only authorization is a lowerable inline Rego:
# its top-level gate must stay on the pipeline, because the pipeline runs
# the interpreter, which the gate would no longer reach if it folded into
# the kernel slot
FOLD_OPA = {"hosts": ["gated-opa.test"],
            "when": [{"selector": "request.method", "operator": "neq",
                      "value": "OPTIONS"}],
            "authentication": {"anon": {"anonymous": {}}},
            "authorization": {"rules": {"opa": {
                "rego": 'allow { input.request.headers["x-org"] == "acme" }'}}}}
CONDITIONED_ANON = _gated(
    "gated-cond.test",
    [{"selector": "request.method", "operator": "neq", "value": "OPTIONS"}],
    {"anon": {"anonymous": {}, "when": [
        {"selector": "request.headers.x-flag", "operator": "eq", "value": "on"}]}})

# identity priority, first success, defaults/overrides, a conditioned
# identity, an identity cache
IDENTITIES = {
    "hosts": ["ids.test"],
    "authentication": {
        "keys": {"apiKey": {"selector": {"matchLabels": {"audience": "talker-api"}}},
                 "credentials": {"customHeader": {"name": "x-api-key"}},
                 "overrides": {"tier": {"value": "gold"}},
                 "cache": {"key": {"selector": "request.headers.x-api-key"},
                           "ttl": 30}},
        "all-keys": {"apiKey": {"selector": {"matchLabels": {"audience": "talker-api"}},
                                "allNamespaces": True},
                     "credentials": {"queryString": {"name": "key"}},
                     "priority": 1},
        "header-user": {"plain": {"selector": "request.headers.x-user|@fromstr"},
                        "defaults": {"tier": {"value": "bronze"},
                                     "via": {"selector": "request.method"}},
                        "overrides": {"name": {"selector": "request.headers.x-name"}},
                        "when": [{"selector": "request.method", "operator": "neq",
                                  "value": "DELETE"}],
                        "priority": 2},
        "anon": {"anonymous": {}, "priority": 3, "when": [
            {"selector": "request.method", "operator": "neq", "value": "PATCH"}]},
    },
    "authorization": {"who": {"patternMatching": {"patterns": [
        {"any": [{"selector": "auth.identity.tier", "operator": "eq", "value": "gold"},
                 {"selector": "auth.identity.name", "operator": "eq", "value": "ann"},
                 {"selector": "auth.identity.anonymous", "operator": "eq", "value": "true"}]}]}}},
    "response": {
        "unauthenticated": {
            "code": 401, "message": {"value": "no identity"},
            "headers": {"www-authenticate": {"value": 'APIKEY realm="ids"'}}},
        "success": {"headers": {"x-identity": {"json": {"properties": {
        "tier": {"selector": "auth.identity.tier"},
        "name": {"selector": "auth.identity.name"},
        "via": {"selector": "auth.identity.via"},
        "kind": {"selector": "auth.identity.kind"}}}}}}},
}
IDENTITY_REQUESTS = [
    req("ids.test", headers={"x-api-key": "secret-key-2"}),
    req("ids.test", headers={"x-api-key": "secret-key-2"}),  # cache hit
    req("ids.test", headers={"x-api-key": "nope"}),
    req("ids.test", path="/?key=secret-key-3"),
    req("ids.test", headers={"x-user": '{"name":"bob","tier":"silver"}',
                             "x-name": "ann"}),
    req("ids.test", headers={"x-user": '{"name":"bob"}', "x-name": "bob"}),
    req("ids.test", method="DELETE", headers={"x-user": '{"name":"bob"}'}),
    req("ids.test", headers={"x-user": "[1, 2]"}),
    req("ids.test"),
    req("ids.test", method="PATCH"),
    req("ids.test", method="PATCH", headers={"x-api-key": "secret-key-2"}),
]

# several pattern slots, named patterns, all/any, conditions per slot,
# ingroup over relations, denyWith with selectors and templates
SLOTS = {
    "hosts": ["*.slots.test", "slots.test"],
    "patterns": {
        "is-get": [{"selector": "request.method", "operator": "eq", "value": "GET"}],
        "api": [{"selector": "request.url_path", "operator": "matches",
                 "value": "^/api/v[0-9]+/"}],
    },
    "relations": {"org": {"edges": [["alice", "eng"], ["eng", "staff"],
                                    ["bob", "sales"], ["sales", "staff"]]}},
    "authentication": {"anon": {"anonymous": {}}},
    "authorization": {
        "get-or-api": {"patternMatching": {"patterns": [{"any": [
            {"patternRef": "is-get"}, {"patternRef": "api"}]}]}},
        "staff-only": {"patternMatching": {"patterns": [
            {"selector": "request.headers.x-user", "operator": "ingroup",
             "value": "staff", "relation": "org"}]},
            "when": [{"patternRef": "api"}]},
        "no-banned": {"patternMatching": {"patterns": [{"all": [
            {"selector": "request.headers.x-tags", "operator": "excl", "value": "banned"},
            {"selector": "request.headers.x-user", "operator": "neq", "value": "mallory"}]}]},
            "priority": 1},
    },
    "response": {
        "unauthenticated": {"code": 401, "message": {"value": "who?"}},
        "unauthorized": {
            "code": 403,
            "message": {"selector": "request.method"},
            "headers": {"x-denied-path": {"selector": "request.path"},
                        "location": {"selector": "https://login/?to={request.path}"}},
            "body": {"value": {"error": "denied"}}},
        "success": {
            "headers": {"x-plain": {"plain": {"selector": "auth.identity.anonymous"}},
                        "x-user-json": {"json": {"properties": {
                            "user": {"selector": "request.headers.x-user"},
                            "n": {"value": 1}}}, "key": "x-user-data"}},
            "dynamicMetadata": {"ext": {"json": {"properties": {
                "path": {"selector": "request.url_path"}}}},
                "gated-meta": {"plain": {"value": "on"}, "when": [
                    {"selector": "request.method", "operator": "eq", "value": "POST"}]}},
        },
    },
}
SLOT_REQUESTS = [
    req("slots.test", "GET", "/x"),
    req("a.slots.test", "POST", "/x"),
    req("b.slots.test", "POST", "/api/v1/x", {"x-user": "alice"}),
    req("b.slots.test", "POST", "/api/v1/x", {"x-user": "carol"}),
    req("b.slots.test", "POST", "/api/v2/y", {"x-user": "bob", "x-tags": "banned"}),
    req("deep.b.slots.test", "GET", "/z", {"x-user": "mallory"}),
    req("slots.test:443", "GET", "/z", {"x-user": "bob"}),
    req("other.test", "GET", "/z"),
]

# inline OPA: a lowered policy beside a pattern, allValues read by a
# success header, a data document, a `when`-gated policy and a policy that
# does not lower (it stays on the interpreter)
OPA_SPEC = {
    "hosts": ["opa.test"],
    "authentication": {"user": {"plain": {
        "selector": "request.headers.x-user|@fromstr"}}},
    "authorization": {
        "not-banned": {"patternMatching": {"patterns": [
            {"selector": "request.headers.x-banned", "operator": "neq",
             "value": "yes"}]}},
        "lowered": {"opa": {"rego": (
            'allow { input.request.method == "GET"; '
            'startswith(input.request.path, "/api") }\n'
            'allow { regex.match("^t-[0-9]+$", input.request.headers["x-tier"]); '
            'input.request.size < 1024 }\n'
            'allow { input.request.method != "GET"; '
            'not input.request.headers["x-org"] == "evil" }')}},
        "values": {"opa": {"rego": (
            'allow { input.auth.identity.role == "admin" }\n'
            'allow { input.request.method != "DELETE" }\n'
            'user := input.auth.identity.name\n'
            'roles := [r | r := input.auth.identity.roles[_]]'),
            "allValues": True}, "priority": 1},
        "with-data": {"opa": {"rego": (
            'allow { input.auth.identity.name == data.users[_] }\n'
            'allow { input.request.method == "POST" }'),
            "data": {"users": ["ann", "bob"]}}, "priority": 1},
        "gated": {"opa": {"rego": 'allow { input.request.headers["x-org"] == "acme" }'},
                  "when": [{"selector": "request.url_path", "operator": "matches",
                            "value": "^/api/org"}]},
        "procedural": {"opa": {"rego": 'allow { count(input.request.headers) < 3 }'},
                       "priority": 2},
    },
    "response": {"success": {"headers": {"x-opa": {"json": {"properties": {
        "user": {"selector": "auth.authorization.values.user"},
        "roles": {"selector": "auth.authorization.values.roles"}}}}}}},
}


def _user(name, role="user", roles=None):
    return json.dumps({"name": name, "role": role, "roles": roles or []})


OPA_REQUESTS = [
    req("opa.test", "GET", "/api/x", {"x-user": _user("ann", roles=["a", "b"])}),
    req("opa.test", "GET", "/api/x", {"x-user": _user("ann"), "x-banned": "yes"}),
    req("opa.test", "GET", "/web", {"x-user": _user("ann"), "x-tier": "t-7"}),
    req("opa.test", "GET", "/web", {"x-user": _user("ann"), "x-tier": "gold"}),
    req("opa.test", "POST", "/web", {"x-user": _user("zed")}),
    req("opa.test", "POST", "/web", {"x-user": _user("zed"), "x-org": "evil"}),
    req("opa.test", "DELETE", "/web", {"x-user": _user("bob", "admin")}),
    req("opa.test", "DELETE", "/web", {"x-user": _user("zed", "admin")}),
    req("opa.test", "DELETE", "/web", {"x-user": _user("ann")}),
    req("opa.test", "POST", "/api/org/1", {"x-user": _user("ann"), "x-org": "acme"}),
    req("opa.test", "POST", "/api/org/1", {"x-user": _user("ann"), "x-org": "other"}),
    req("opa.test", "GET", "/api/x", {"x-user": _user("ann"), "x-org": "a",
                                      "x-tier": "t-1"}),
    req("opa.test", "GET", "/api/x", {}),
    req("opa.test", "GET", "/api/x", {"x-user": "[1, 2]"}),
]

# Kubernetes TokenReview (an explicit audience through a custom header, the
# default audience — the request's host — through the bearer token) and
# SubjectAccessReview (resource attributes on /api, the request's path and
# lower-cased verb elsewhere)
K8S_SPEC = {
    "hosts": ["k8s.test"],
    "authentication": {
        "explicit": {"kubernetesTokenReview": {"audiences": ["talker-api"]},
                     "credentials": {"customHeader": {"name": "x-sa-token"}}},
        "default-audience": {"kubernetesTokenReview": {}, "priority": 1},
    },
    "authorization": {
        "resource": {"kubernetesSubjectAccessReview": {
            "user": {"selector": "auth.identity.username"},
            "groups": ["devs"],
            "resourceAttributes": {
                "namespace": {"selector": "request.headers.x-ns"},
                "resource": {"value": "pods"},
                "verb": {"value": "get"}}},
            "when": [{"selector": "request.url_path", "operator": "matches",
                      "value": "^/api"}]},
        "non-resource": {"kubernetesSubjectAccessReview": {
            "user": {"selector": "auth.identity.username"}},
            "when": [{"selector": "request.url_path", "operator": "matches",
                      "value": "^/healthz"}]},
    },
    "response": {"success": {"headers": {"x-k8s-user": {"plain": {
        "selector": "auth.identity.username"}}}}},
}
# token -> (user, the audience the token was issued for)
K8S_TOKENS = {"tok-alice": ("alice", "talker-api"), "tok-bob": ("bob", "k8s.test"),
              "tok-carol": ("carol", "elsewhere")}
K8S_ALLOWED = [
    {"user": "alice", "groups": ["devs"], "resourceAttributes": {
        "namespace": "dev", "resource": "pods", "verb": "get"}},
    {"user": "bob", "nonResourceAttributes": {"path": "/healthz", "verb": "get"}},
]


def k8s_setup(cluster):
    """Seed ``cluster``'s reviews: a token authenticates only for its own
    audience, and a denied review names the spec it was asked."""
    real = cluster.token_review
    for token, (user, _) in K8S_TOKENS.items():
        cluster.token_reviews[token] = {"status": {
            "authenticated": True, "user": {"username": user,
                                            "groups": ["devs"]}}}

    async def token_review(token, audiences):
        issued = K8S_TOKENS.get(token, (None, None))[1]
        if issued is not None and issued not in audiences:
            return {"status": {"authenticated": False,
                               "error": f"audiences {audiences} exclude {issued}"}}
        return await real(token, audiences)

    def access_review(spec):
        if spec in K8S_ALLOWED:
            return {"status": {"allowed": True}}
        return {"status": {"allowed": False,
                           "reason": json.dumps(spec, sort_keys=True)}}

    cluster.token_review = token_review
    cluster.access_reviews = access_review


def _k8s(method="GET", path="/api/pods", headers=None, host="k8s.test"):
    return req(host, method, path, headers)


K8S_REQUESTS = [
    _k8s(headers={"x-sa-token": "tok-alice", "x-ns": "dev"}),
    _k8s(headers={"x-sa-token": "tok-alice", "x-ns": "prod"}),
    _k8s(path="/healthz", headers={"authorization": "Bearer tok-bob"}),
    _k8s("POST", "/healthz", {"authorization": "Bearer tok-bob"}),
    _k8s(path="/healthz", headers={"authorization": "Bearer tok-alice"}),
    _k8s(path="/healthz", headers={"x-sa-token": "tok-bob"}),
    _k8s(path="/healthz", headers={"authorization": "Bearer tok-bob"},
         host="k8s.test:8443"),
    _k8s(headers={"authorization": "Bearer tok-carol"}),
    _k8s(headers={"authorization": "Bearer tok-nobody"}),
    _k8s(headers={"x-sa-token": "tok-nobody"}),
    _k8s(),
    _k8s(path="/other", headers={"authorization": "Bearer tok-bob"}),
]

CASES = {
    "v2_spec": ([("ac", V2_SPEC)], [KEY_SECRET, USER_SECRET], V2_REQUESTS),
    "anonymous_gate_folds": ([("gated", FOLD)], [], _methods("gated.test")),
    "credential_gate_does_not_fold": (
        [("gk", CREDENTIAL_GATE)], [KEY_SECRET],
        _methods("gated-key.test")
        + _methods("gated-key.test", {"authorization": "Bearer secret-key-1"})),
    "auth_rooted_gate_does_not_fold": (
        [("ga", AUTH_ROOTED_GATE)], [], _methods("gated-auth.test")),
    "nested_auth_rooted_gate_does_not_fold": (
        [("gn", NESTED_GATE)], [], _methods("gated-nest.test")),
    "conditioned_anonymous_does_not_fold": (
        [("gc", CONDITIONED_ANON)], [],
        _methods("gated-cond.test") + _methods("gated-cond.test", {"x-flag": "on"})),
    "identities": ([("ids", IDENTITIES)], [USER_SECRET, OTHER_NS_SECRET],
                   IDENTITY_REQUESTS),
    "pattern_slots_and_responses": ([("slots", SLOTS)], [], SLOT_REQUESTS),
    "opa": ([("opa", OPA_SPEC)], [], OPA_REQUESTS),
    "opa_gate_does_not_fold": ([("gated-opa", FOLD_OPA)], [],
                               _methods("gated-opa.test")),
    "kubernetes_reviews": ([("k8s", K8S_SPEC)], [], K8S_REQUESTS, k8s_setup),
    "all_in_one_snapshot": (
        [("ac", V2_SPEC), ("gated", FOLD), ("gk", CREDENTIAL_GATE),
         ("ga", AUTH_ROOTED_GATE), ("ids", IDENTITIES), ("slots", SLOTS),
         ("opa", OPA_SPEC), ("k8s", K8S_SPEC)],
        [KEY_SECRET, USER_SECRET, OTHER_NS_SECRET],
        V2_REQUESTS + _methods("gated.test") + IDENTITY_REQUESTS
        + SLOT_REQUESTS + OPA_REQUESTS + K8S_REQUESTS, k8s_setup),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_check_equals_reference(name):
    configs, secrets, requests, *setup = CASES[name]
    concurrent = name == "all_in_one_snapshot"
    r_entries, want, _ = check_all(REF, configs, secrets, requests, concurrent,
                                   *setup)
    p_entries, got, engine = check_all(PORT, configs, secrets, requests,
                                       concurrent, *setup)
    assert [entry_shape(e) for e in p_entries] == \
        [entry_shape(e) for e in r_entries]
    for i, (w, g) in enumerate(zip(want, got)):
        assert result_fields(g) == result_fields(w), (i, requests[i])
    st = engine.stats
    assert st["failed_batches"] == 0
    assert st["launches"] + st["plain_calls"] == st["batches"]


def test_case_table_reaches_every_outcome():
    """Allow, 401, 403 with provenance, NOT_FOUND, a denyWith status, the
    kernel-folded gate and a port-stripped host all occur in the table."""
    codes, statuses, provenance = set(), set(), 0
    for configs, secrets, requests, *setup in CASES.values():
        entries, results, _ = check_all(PORT, configs, secrets, requests,
                                        False, *setup)
        for r in results:
            codes.add(r.code)
            statuses.add(r.status)
            provenance += "ext_authz_provenance" in r.metadata
    rpc = PORT.rpc
    assert codes == {rpc.OK, rpc.UNAUTHENTICATED, rpc.PERMISSION_DENIED,
                     rpc.NOT_FOUND}
    assert {0, 302, 401, 403} <= statuses
    assert provenance > 0


def test_snapshot_swap_moves_index_and_corpus_together():
    """The host index rides on the snapshot: a swap that drops a config
    drops its host in the same store, and configs without compiled rules
    are indexed too."""
    engine = PolicyEngine(max_batch=8, device="cpu")
    anon_only = {"hosts": ["open.test"], "authentication": {"a": {"anonymous": {}}}}

    async def body():
        ns = PORT.controllers
        first = [await ns.translate_auth_config("g", "t", FOLD, engine=engine),
                 await ns.translate_auth_config("o", "t", anon_only, engine=engine)]
        assert first[1].rules is None
        engine.apply_snapshot(first)
        snap = engine._snapshot
        assert engine.lookup("open.test") is first[1]
        assert engine.lookup("gated.test:80") is first[0]
        open_ok = await engine.check(request_of(PORT, req("open.test")))
        engine.apply_snapshot(first[1:])
        assert engine._snapshot is not snap and engine._snapshot.policy is None
        gone = await engine.check(request_of(PORT, req("gated.test")))
        return open_ok, gone

    open_ok, gone = run(body())
    assert (open_ok.code, gone.code, gone.message) == \
        (PORT.rpc.OK, PORT.rpc.NOT_FOUND, "Service not found")


def test_collision_without_override_raises():
    engine = PolicyEngine(device="cpu")
    entries = run(translate_all(PORT, engine, [("a", FOLD), ("b", FOLD)], None))
    engine.apply_snapshot(entries)  # override=True: the later entry wins
    assert engine.lookup("gated.test").id == "t/b"
    with pytest.raises(PORT.index.IndexError_):
        engine.apply_snapshot(entries, override=False)


# cases with pattern denials that no denyWith message overrides
EXPOSED_CASES = ("anonymous_gate_folds", "identities", "all_in_one_snapshot")


@pytest.mark.parametrize("name", EXPOSED_CASES)
def test_check_equals_reference_with_deny_reason_exposed(name, monkeypatch):
    """With EXPOSE_DENY_REASON on in both packages, a denial's message
    names the rule that fired, equal to the reference's."""
    for ns in (REF, PORT):
        monkeypatch.setattr(ns.provenance, "EXPOSE_DENY_REASON", True)
    configs, secrets, requests, *setup = CASES[name]
    _, want, _ = check_all(REF, configs, secrets, requests, False, *setup)
    _, got, _ = check_all(PORT, configs, secrets, requests, False, *setup)
    for i, (w, g) in enumerate(zip(want, got)):
        assert result_fields(g) == result_fields(w), (i, requests[i])
    assert any(g.message.startswith("denied by t/") for g in got)


def test_engine_timeout_equals_reference():
    """``timeout_s`` bounds every Check()'s pipeline on both engines: a
    config with a slow identity answers DEADLINE_EXCEEDED, a fast one
    answers as without the bound."""

    async def body(ns):
        engine = engine_of(ns, timeout_s=0.05)
        slow = ns.ev.RuntimeAuthConfig(identity=[
            ns.ev.IdentityConfig("slow", Stub(ns, {"u": 1}, delay=2.0))])
        engine.apply_snapshot([
            await ns.controllers.translate_auth_config(
                "gated", "t", FOLD, engine=engine),
            ns.runtime.EngineEntry(id="t/slow", hosts=["slow.test"],
                                   runtime=slow)])
        return [await engine.check(request_of(ns, r)) for r in
                [req("slow.test")] + _methods("gated.test")]

    want, got = run(body(REF)), run(body(PORT))
    assert [result_fields(g) for g in got] == [result_fields(w) for w in want]
    assert got[0].code == PORT.rpc.DEADLINE_EXCEEDED
    assert {g.code for g in got[1:]} == {PORT.rpc.OK,
                                         PORT.rpc.PERMISSION_DENIED}


def test_pattern_evaluator_has_no_host_path():
    """The port's PatternMatching decides only through an engine's
    provider, and an engine installs no entry whose pattern evaluators
    another engine (or none) would decide."""
    with pytest.raises(TypeError):
        PORT.authz.PatternMatching(PORT.expr.All())
    with pytest.raises(TypeError):
        run(PORT.controllers.translate_auth_config("g", "t", FOLD))
    mine, other = PolicyEngine(device="cpu"), PolicyEngine(device="cpu")
    entry = run(PORT.controllers.translate_auth_config("g", "t", FOLD,
                                                       engine=other))
    with pytest.raises(ValueError, match="not bound to this engine"):
        mine.apply_snapshot([entry])
    assert mine._snapshot is None
    # a provider of this engine, but for a config the entry does not hold
    foreign = run(PORT.controllers.translate_auth_config(
        "g", "t", FOLD, engine=mine))
    foreign.rules.name = "t/elsewhere"
    with pytest.raises(ValueError, match="not bound to this engine"):
        mine.apply_snapshot([foreign])
    mine.apply_snapshot([run(PORT.controllers.translate_auth_config(
        "g", "t", FOLD, engine=mine))])
    assert mine.lookup("gated.test").id == "t/g"


# ---- translate coverage ----------------------------------------------------

def _auth(kind, body):
    return {"hosts": ["k.test"], "authentication": {"x": {kind: body}}}


def _authz(kind, body):
    return {"hosts": ["k.test"], "authentication": {"a": {"anonymous": {}}},
            "authorization": {"x": {kind: body}}}


def _resp(kind, body, wrapper):
    return {"hosts": ["k.test"], "authentication": {"a": {"anonymous": {}}},
            "response": {"success": {wrapper: {"x": {kind: body}}}}}


SELECTOR = {"matchLabels": {"audience": "talker-api"}}
KINDS = {
    ("authentication", "apiKey"): _auth("apiKey", {"selector": SELECTOR}),
    ("authentication", "plain"): _auth("plain", {"selector": "request.headers.x-u"}),
    ("authentication", "anonymous"): _auth("anonymous", {}),
    ("authentication", "jwt"): _auth("jwt", {"issuerUrl": "http://issuer.invalid"}),
    ("authentication", "oauth2Introspection"): _auth(
        "oauth2Introspection", {"endpoint": "http://introspect.invalid"}),
    ("authentication", "x509"): _auth("x509", {"selector": SELECTOR}),
    ("authentication", "kubernetesTokenReview"): _auth(
        "kubernetesTokenReview", {"audiences": ["a"]}),
    ("metadata", "http"): dict(_authz("patternMatching", {"patterns": []}),
                               metadata={"x": {"http": {"url": "http://md.invalid"}}}),
    ("metadata", "userInfo"): dict(_auth("anonymous", {}), metadata={
        "x": {"userInfo": {"identitySource": "x"}}}),
    ("metadata", "uma"): dict(_auth("anonymous", {}), metadata={
        "x": {"uma": {"endpoint": "http://uma.invalid"}}}),
    ("authorization", "patternMatching"): _authz("patternMatching", {"patterns": [
        {"selector": "request.method", "operator": "eq", "value": "GET"}]}),
    ("authorization", "opa"): _authz("opa", {
        "rego": 'allow { input.request.method == "GET" }\nallow = true { '
                'regex.match("^/api/v[0-9]+", input.request.path) }',
        "allValues": True, "data": {"k": 1}}),
    ("authorization", "kubernetesSubjectAccessReview"): _authz(
        "kubernetesSubjectAccessReview", {"user": {"value": "u"}}),
    ("authorization", "spicedb"): _authz("spicedb", {"endpoint": "spicedb.invalid"}),
    ("response", "json"): _resp("json", {"properties": {"a": {"value": 1}}},
                                "headers"),
    ("response", "plain"): _resp("plain", {"value": "v"}, "dynamicMetadata"),
    ("response", "wristband"): _resp("wristband", {"issuer": "http://w.invalid"},
                                     "headers"),
    ("callbacks", "http"): dict(_auth("anonymous", {}), callbacks={
        "x": {"http": {"url": "http://cb.invalid"}}}),
}


def roadmap_not_in_port():
    """The ``section.kind`` names ROADMAP.md lists as not yet in the
    port's translate."""
    text = (ROOT / "ROADMAP.md").read_text()
    m = re.search(r"Kinds not yet in the port's translate:(.*?)\n\n", text,
                  re.S)
    assert m, "ROADMAP.md lists no kinds not yet in the port"
    return sorted(tuple(k.split(".")) for k in re.findall(r"`([\w.]+)`",
                                                          m.group(1)))


def test_not_in_port_list_is_the_roadmaps():
    listed = sorted((sec, k) for sec, kinds in p_translate.NOT_IN_PORT.items()
                    for k in kinds)
    assert listed == roadmap_not_in_port()
    assert set(listed) <= set(KINDS)


@pytest.mark.parametrize("section,kind", sorted(KINDS))
def test_translate_kind_matches_reference_or_is_refused(section, kind):
    spec = KINDS[(section, kind)]
    if kind in p_translate.NOT_IN_PORT[section]:
        with pytest.raises(p_translate.TranslationError,
                           match=f"kind '{kind}' is not yet in the port"):
            run(PORT.controllers.translate_auth_config(
                "k", "t", spec, cluster=cluster_of(PORT, [KEY_SECRET]),
                engine=PolicyEngine(device="cpu")))
        return
    shapes, rules = [], []
    for ns in (REF, PORT):
        entry = run(ns.controllers.translate_auth_config(
            "k", "t", spec, cluster=cluster_of(ns, [KEY_SECRET]),
            engine=engine_of(ns)))
        shapes.append(entry_shape(entry))
        rules.append(entry.rules)
    assert shapes[1] == shapes[0]
    if rules[0] is None:
        assert rules[1] is None
        return
    want = REF_C.compile_corpus([rules[0]], members_k=16)
    got = PORT_C.compile_corpus([rules[1]], members_k=16)
    assert_same_policy(want, got)


def test_opa_external_policy_is_refused_by_name():
    """The registry download waits for an HTTP client: translate refuses
    ``opa.externalPolicy`` by name, also beside an inline policy."""
    for opa in ({"externalPolicy": {"url": "http://registry.invalid/p"}},
                {"rego": "allow = true",
                 "externalPolicy": {"url": "http://registry.invalid/p",
                                    "ttl": 60}}):
        with pytest.raises(p_translate.TranslationError,
                           match="authorization 'x': kind "
                                 "'opa.externalPolicy' is not yet in the port"):
            run(PORT.controllers.translate_auth_config(
                "k", "t", _authz("opa", opa),
                engine=PolicyEngine(device="cpu")))


def test_invalid_rego_error_matches_reference():
    spec = _authz("opa", {"rego": "default x = input.y"})
    msgs = []
    for ns in (REF, PORT):
        with pytest.raises(ns.controllers.TranslationError) as e:
            run(ns.controllers.translate_auth_config("k", "t", spec,
                                                     engine=engine_of(ns)))
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0] and msgs[0].startswith("invalid rego policy")


def test_gate_beside_lowered_opa_stays_on_the_pipeline():
    """An anonymous config with a request-rooted top-level `when` whose
    only authorization is a lowerable inline Rego: the gate does not fold
    into the kernel slot (the pipeline's interpreter would then run
    ungated), so a gate-unmatched request answers OK as in the reference,
    and a gate-matched one takes the Rego verdict."""
    requests = [req("gated-opa.test", "OPTIONS", "/x"),
                req("gated-opa.test", "OPTIONS", "/x", {"x-org": "evil"}),
                req("gated-opa.test", "GET", "/x"),
                req("gated-opa.test", "GET", "/x", {"x-org": "acme"})]
    results = {}
    for ns in (REF, PORT):
        entries, got, _ = check_all(ns, [("gated-opa", FOLD_OPA)], [],
                                    requests)
        results[ns is PORT] = (entries[0], got)
    (r_entry, want), (p_entry, got) = results[False], results[True]
    assert p_entry.runtime.conditions is not None
    assert entry_shape(p_entry) == entry_shape(r_entry)
    assert p_entry.rules.evaluators[0][0] is None  # the slot is ungated
    assert [result_fields(g) for g in got] == [result_fields(w) for w in want]
    assert [g.code for g in got] == [PORT.rpc.OK, PORT.rpc.OK,
                                     PORT.rpc.PERMISSION_DENIED, PORT.rpc.OK]


def test_unported_kind_behind_a_ported_one_keeps_reference_precedence():
    """A spec that sets a ported kind the reference tries first translates
    as the reference does; one that only sets an unported kind is refused
    even beside a later ported kind."""
    both = _auth("apiKey", {"selector": SELECTOR})
    both["authentication"]["x"]["jwt"] = {"issuerUrl": "http://issuer.invalid"}
    engine = PolicyEngine(device="cpu")
    entry = run(PORT.controllers.translate_auth_config(
        "k", "t", both, cluster=cluster_of(PORT, []), engine=engine))
    assert entry.runtime.identity[0].type == "API_KEY"
    later = _auth("plain", {"selector": "request.headers.x"})
    later["authentication"]["x"]["x509"] = {"selector": SELECTOR}
    with pytest.raises(p_translate.TranslationError, match="'x509'"):
        run(PORT.controllers.translate_auth_config("k", "t", later,
                                                   engine=engine))
    # the reference tries x509 before kubernetesTokenReview, and opa and
    # kubernetesSubjectAccessReview before spicedb
    review = _auth("kubernetesTokenReview", {})
    review["authentication"]["x"]["x509"] = {"selector": SELECTOR}
    with pytest.raises(p_translate.TranslationError, match="'x509'"):
        run(PORT.controllers.translate_auth_config("k", "t", review,
                                                   engine=engine))
    for kind, body, etype in (
            ("opa", {"rego": "allow = true"}, "OPA"),
            ("kubernetesSubjectAccessReview", {"user": {"value": "u"}},
             "KUBERNETES_SUBJECT_ACCESS_REVIEW")):
        spec = _authz(kind, body)
        spec["authorization"]["x"]["spicedb"] = {"endpoint": "s.invalid"}
        entry = run(PORT.controllers.translate_auth_config(
            "k", "t", spec, engine=engine))
        assert entry.runtime.authorization[0].type == etype


def test_translate_errors_match_reference():
    bad = [
        {"authentication": {"a": {"anonymous": {}}}},
        {"hosts": ["h"], "authorization": {"z": {"patternMatching": {
            "patterns": [{"patternRef": "nope"}]}}}},
        {"hosts": ["h"], "authorization": {"z": {"patternMatching": {
            "patterns": [{"selector": "a", "operator": "ingroup",
                          "value": "g", "relation": "none"}]}}}},
        {"hosts": ["h"], "relations": {"r": {"edges": [["a"]]}}},
        {"hosts": ["h"], "authentication": {"a": {}}},
        {"hosts": ["h"], "authorization": {"z": {}}},
        {"hosts": ["h"], "response": {"success": {"headers": {"h": {}}}}},
    ]
    for spec in bad:
        msgs = []
        for ns in (REF, PORT):
            with pytest.raises(ns.controllers.TranslationError) as e:
                run(ns.controllers.translate_auth_config(
                    "x", "ns", spec, engine=engine_of(ns)))
            msgs.append(str(e.value))
        assert msgs[1] == msgs[0], spec


# ---- the north-star request path -------------------------------------------

def test_northstar_check_equals_reference_engine():
    """40 north-star AuthConfigs, 48 concurrent Check()s: every code and
    every deny provenance equals the reference engine's, and each batch
    went through the kernel's entry point once."""
    acs = northstar.build_auth_configs(40, 10)
    requests = northstar.build_check_requests(48, 40)
    corpus = northstar.build_corpus(40, 10)

    async def body(ns, engine, reqs):
        entries = [await ns.controllers.translate_auth_config(
            o["metadata"]["name"], o["metadata"]["namespace"], o["spec"],
            engine=engine) for o in acs]
        engine.apply_snapshot(entries)
        return entries, await asyncio.gather(*(engine.check(r) for r in reqs))

    r_engine = engine_of(REF, max_batch=32)
    _, want = run(body(REF, r_engine, [port_request_to(REF, r)
                                       for r in requests]))
    p_engine = engine_of(PORT, max_batch=32)
    entries, got = run(body(PORT, p_engine, requests))

    # the same rule build_corpus draws, under the translated name
    for c, e in zip(corpus, entries):
        assert [str(r) for _, r in e.rules.evaluators] == \
            [str(r) for _, r in c.evaluators]
    codes = [g.code for g in got]
    assert codes == [w.code for w in want]
    assert [result_fields(g) for g in got] == [result_fields(w) for w in want]
    assert 0 < codes.count(PORT.rpc.OK) < len(codes)
    for g in got:
        if g.code == PORT.rpc.PERMISSION_DENIED:
            prov = g.metadata["ext_authz_provenance"]
            assert prov["lane"] == "engine" and prov["rule"]
    st = p_engine.stats
    assert st["launches"] + st["plain_calls"] == st["batches"] == 2
    assert st["rows"] == 48 and st["failed_batches"] == 0
