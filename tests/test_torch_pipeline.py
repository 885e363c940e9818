"""The port's five-phase AuthPipeline against the JAX package's: each case
builds the same runtime AuthConfig with each package's own classes, runs one
request through both pipelines and compares the AuthResult field by field
(code, status, message, headers, metadata, body) and the ``auth`` section
of the Authorization JSON (tolerance 0: every output is a code, a string, a
dict or a bool).  The cases are the contract of tests/test_pipeline.py for
the evaluators the port holds.

A pattern evaluator takes its verdicts from an engine of its own package
on the CPU, bound as ``translate_auth_config`` binds it (the port's
PatternMatching has no other way to decide).  The reference engine is built
as tests/test_torch_engine.py builds it.

The helpers here (``pkg``, ``REF``, ``PORT``, ``engine_of``,
``request_of``, ``result_fields``) are shared by the other
``test_torch_*`` files."""

import asyncio
import dataclasses
import importlib
import time
from types import SimpleNamespace

import pytest

_MODULES = {
    "aj": "authjson", "ev": "evaluators", "ident": "evaluators.identity",
    "resp": "evaluators.response", "authz": "evaluators.authorization",
    "expr": "expressions", "pipeline": "pipeline", "rpc": "utils.rpc",
    "index": "index", "k8s": "k8s", "controllers": "controllers",
    "runtime": "runtime", "provenance": "runtime.provenance",
    "compile": "compiler.compile", "metrics": "utils.metrics",
}


def pkg(root: str) -> SimpleNamespace:
    """Every module of the request path of package ``root``, by role."""
    return SimpleNamespace(**{
        k: importlib.import_module(f"{root}.{m}") for k, m in _MODULES.items()})


REF = pkg("authorino_tpu")
PORT = pkg("authorino_tpu_torch")


def engine_of(ns, max_batch=8, **kw):
    """A policy engine of package ``ns`` on the CPU."""
    if ns is REF:
        return ns.runtime.PolicyEngine(max_batch=max_batch, mesh=None,
                                       lane_select=False, kernel_lane="fused",
                                       **kw)
    return ns.runtime.PolicyEngine(max_batch=max_batch, device="cpu",
                                   lane_select=False, **kw)


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def request_of(ns, http: dict, **fields):
    """One CheckRequestModel of package ``ns`` from plain dicts (the same
    dicts go to both packages)."""
    peers = {k: ns.aj.PeerAttributes(**fields.pop(k))
             for k in ("source", "destination") if k in fields}
    return ns.aj.CheckRequestModel(
        http=ns.aj.HttpRequestAttributes(**http), **peers, **fields)


def port_request_to(ns, req):
    """A port CheckRequestModel rebuilt in package ``ns``."""
    d = dataclasses.asdict(req)
    return request_of(ns, d.pop("http"), **d)


def result_fields(r) -> tuple:
    return (r.code, r.status, r.message, r.headers, r.metadata, r.body)


class Stub:
    """Configurable leaf evaluator raising package ``ns``'s errors."""

    def __init__(self, ns, result=None, error=None, delay=0.0, abort=None):
        self.ns = ns
        self.result = result
        self.error = error
        self.delay = delay
        self.abort = abort

    async def call(self, pipeline):
        if self.delay:
            await asyncio.sleep(self.delay)
        if self.abort is not None:
            raise self.ns.rpc.CheckAbort(*self.abort)
        if self.error:
            raise self.ns.ev.EvaluationError(self.error)
        return self.result


def http(headers=None, method="GET", path="/"):
    return {"method": method, "path": path, "host": "svc.example.com",
            "headers": headers or {}}


# ---- the cases: ns → (RuntimeAuthConfig, http dict, pipeline kwargs) ------


def _anon(ns):
    return ns.ev.IdentityConfig("anon", ns.ident.Noop())


def c_anonymous_success(ns):
    return ns.ev.RuntimeAuthConfig(identity=[_anon(ns)]), http(), {}


def c_single_identity_failure(ns):
    cfg = ns.ev.RuntimeAuthConfig(identity=[
        ns.ev.IdentityConfig("x", Stub(ns, error="bad token"))])
    return cfg, http(), {}


def c_identity_failures_aggregate(ns):
    cfg = ns.ev.RuntimeAuthConfig(identity=[
        ns.ev.IdentityConfig("a", Stub(ns, error="err-a")),
        ns.ev.IdentityConfig("b", Stub(ns, error="err-b"))])
    return cfg, http(), {}


def c_first_success_wins(ns):
    cfg = ns.ev.RuntimeAuthConfig(identity=[
        ns.ev.IdentityConfig("slow", Stub(ns, {"u": "slow"}, delay=5.0)),
        ns.ev.IdentityConfig("fast", Stub(ns, {"u": "fast"}))])
    return cfg, http(), {}


def c_priority_buckets(ns):
    cfg = ns.ev.RuntimeAuthConfig(identity=[
        ns.ev.IdentityConfig("p1", Stub(ns, {"u": 1}), priority=1),
        ns.ev.IdentityConfig("p0", Stub(ns, error="nope"), priority=0)])
    return cfg, http(), {}


def c_extended_properties(ns):
    JSONValue = ns.aj.JSONValue
    cfg = ns.ev.RuntimeAuthConfig(identity=[ns.ev.IdentityConfig(
        "plain", ns.ident.Plain("request.headers.x-user|@fromstr"),
        extended_properties=[
            ns.ev.IdentityExtension("tier", JSONValue(static="gold")),
            ns.ev.IdentityExtension("name", JSONValue(static="kept")),
            ns.ev.IdentityExtension("org", JSONValue(
                pattern="request.headers.x-org"), overwrite=True)])])
    return cfg, http({"x-user": '{"name":"john","org":"a"}',
                      "x-org": "b"}), {}


def c_plain_identity_missing(ns):
    cfg = ns.ev.RuntimeAuthConfig(identity=[ns.ev.IdentityConfig(
        "plain", ns.ident.Plain("request.headers.x-user|@fromstr"))])
    return cfg, http(), {}


def c_conditions_skip_identity(ns):
    P, Op = ns.expr.Pattern, ns.expr.Operator
    cfg = ns.ev.RuntimeAuthConfig(identity=[
        ns.ev.IdentityConfig("gated", Stub(ns, {"u": 1}),
                             conditions=P("request.method", Op.EQ, "POST")),
        _anon(ns)])
    return cfg, http(method="GET"), {}


def _pattern_cfg(ns, *authz):
    return ns.ev.RuntimeAuthConfig(identity=[_anon(ns)],
                                   authorization=list(authz))


def _org_pattern_cfg(ns):
    """An anonymous config whose one pattern evaluator an engine of ``ns``
    evaluates, installed in that engine's snapshot."""
    P, Op = ns.expr.Pattern, ns.expr.Operator
    rule = ns.expr.All(P("request.headers.x-org", Op.EQ, "acme"))
    engine, cfg_id = engine_of(ns), "t/rbac"
    cfg = _pattern_cfg(ns, ns.ev.AuthorizationConfig(
        "rbac", ns.authz.PatternMatching(rule, engine.provider_for(cfg_id), 0,
                                         engine.attribution_for(cfg_id))))
    engine.apply_snapshot([ns.runtime.EngineEntry(
        id=cfg_id, hosts=["svc.example.com"], runtime=cfg,
        rules=ns.compile.ConfigRules(name=cfg_id, evaluators=[(None, rule)]))])
    return cfg


def c_pattern_allow(ns):
    return _org_pattern_cfg(ns), http({"x-org": "acme"}), {}


def c_pattern_deny(ns):
    return _org_pattern_cfg(ns), http({"x-org": "evil"}), {}


def c_all_must_pass(ns):
    # the denial lands after the allow: which of two racers that finish in
    # one loop iteration is read first is a set's order in either package
    return _pattern_cfg(
        ns, ns.ev.AuthorizationConfig("ok", Stub(ns, True)),
        ns.ev.AuthorizationConfig("bad", Stub(ns, error="denied by policy",
                                              delay=0.02))
    ), http(), {}


def c_conditions_skip_authorization(ns):
    P, Op = ns.expr.Pattern, ns.expr.Operator
    return _pattern_cfg(ns, ns.ev.AuthorizationConfig(
        "gated", Stub(ns, error="would deny"),
        conditions=P("request.method", Op.EQ, "DELETE"))), http(), {}


def c_authorization_result_in_json(ns):
    return _pattern_cfg(ns, ns.ev.AuthorizationConfig(
        "policy-x", Stub(ns, {"score": 9}))), http(), {}


def c_check_abort_passes_typed(ns):
    return _pattern_cfg(ns, ns.ev.AuthorizationConfig(
        "dev", Stub(ns, abort=(14, "policy evaluation unavailable")))), \
        http(), {}


def c_metadata_failures_tolerated(ns):
    cfg = ns.ev.RuntimeAuthConfig(identity=[_anon(ns)], metadata=[
        ns.ev.MetadataConfig("good", Stub(ns, {"m": 1})),
        ns.ev.MetadataConfig("bad", Stub(ns, error="boom"))])
    return cfg, http(), {}


def c_response_headers_and_metadata(ns):
    JSONValue, JSONProperty = ns.aj.JSONValue, ns.aj.JSONProperty
    cfg = ns.ev.RuntimeAuthConfig(identity=[_anon(ns)], response=[
        ns.ev.ResponseConfig("x-ext-auth-data", ns.resp.DynamicJSON([
            JSONProperty("user", JSONValue(pattern="auth.identity.anonymous"))])),
        ns.ev.ResponseConfig("x-path", ns.resp.Plain(
            JSONValue(pattern="path={request.path}"))),
        ns.ev.ResponseConfig("rate-limit-data", ns.resp.DynamicJSON([
            JSONProperty("level", JSONValue(static=3))]),
            wrapper="envoyDynamicMetadata", wrapper_key="ext_auth_data")])
    return cfg, http(path="/p"), {}


def c_top_level_skip(ns):
    P, Op = ns.expr.Pattern, ns.expr.Operator
    cfg = ns.ev.RuntimeAuthConfig(
        conditions=P("request.path", Op.EQ, "/admin"),
        identity=[ns.ev.IdentityConfig("x", Stub(ns, error="not run"))])
    return cfg, http(path="/public"), {}


def c_deny_with_unauthorized(ns):
    JSONValue, JSONProperty = ns.aj.JSONValue, ns.aj.JSONProperty
    cfg = ns.ev.RuntimeAuthConfig(
        identity=[_anon(ns)],
        authorization=[ns.ev.AuthorizationConfig("deny", Stub(ns, error="nope"))],
        deny_with=ns.ev.DenyWith(unauthorized=ns.ev.DenyWithValues(
            code=302, message=JSONValue(static="redirecting"),
            headers=[JSONProperty("Location", JSONValue(
                pattern="http://login{request.path}"))],
            body=JSONValue(static={"go": "login"}))))
    return cfg, http(path="/x"), {}


def c_deny_with_unauthenticated(ns):
    JSONValue = ns.aj.JSONValue
    cfg = ns.ev.RuntimeAuthConfig(
        identity=[ns.ev.IdentityConfig("x", Stub(ns, error="bad"))],
        deny_with=ns.ev.DenyWith(unauthenticated=ns.ev.DenyWithValues(
            code=401, message=JSONValue(pattern="request.method"))))
    return cfg, http(method="PUT"), {}


def c_timeout(ns):
    cfg = ns.ev.RuntimeAuthConfig(identity=[
        ns.ev.IdentityConfig("slow", Stub(ns, {"u": 1}, delay=2.0))])
    return cfg, http(), {"timeout": 0.05}


def c_expired_deadline(ns):
    return ns.ev.RuntimeAuthConfig(identity=[_anon(ns)]), http(), {
        "deadline": time.monotonic() - 1.0}


CASES = {f.__name__[2:]: f for f in (
    c_anonymous_success, c_single_identity_failure,
    c_identity_failures_aggregate, c_first_success_wins, c_priority_buckets,
    c_extended_properties, c_plain_identity_missing,
    c_conditions_skip_identity, c_pattern_allow, c_pattern_deny,
    c_all_must_pass, c_conditions_skip_authorization,
    c_authorization_result_in_json, c_check_abort_passes_typed,
    c_metadata_failures_tolerated, c_response_headers_and_metadata,
    c_top_level_skip, c_deny_with_unauthorized, c_deny_with_unauthenticated,
    c_timeout, c_expired_deadline)}


def evaluate(ns, case):
    cfg, req, kw = case(ns)
    pipeline = ns.pipeline.AuthPipeline(request_of(ns, req), cfg, **kw)
    result = run(pipeline.evaluate())
    return result, pipeline.authorization_json()["auth"]


@pytest.mark.parametrize("name", sorted(CASES))
def test_pipeline_result_equals_reference(name):
    want, want_auth = evaluate(REF, CASES[name])
    got, got_auth = evaluate(PORT, CASES[name])
    assert type(got).__module__.startswith("authorino_tpu_torch.")
    assert result_fields(got) == result_fields(want)
    assert got_auth == want_auth


def test_cases_reach_every_code_they_name():
    """The table is not vacuous: it covers allow, both denials, the typed
    abort and the deadline."""
    codes = {evaluate(PORT, c)[0].code for c in CASES.values()}
    rpc = PORT.rpc
    assert codes == {rpc.OK, rpc.UNAUTHENTICATED, rpc.PERMISSION_DENIED,
                     rpc.UNAVAILABLE, rpc.DEADLINE_EXCEEDED}


def test_host_index_matches_reference():
    ops = [("set", "cfg-1", "talker-api.example.com", "A", False),
           ("set", "cfg-2", "*.example.org", "B", False),
           ("set", "cfg-3", "example.org", "C", False),
           ("set", "cfg-4", "*.deep.example.org", "D", False),
           ("set", "cfg-9", "talker-api.example.com", "Z", True),
           ("delete", "cfg-2"),
           ("delete_key", "cfg-4", "*.deep.example.org")]
    hosts = ["talker-api.example.com", "anything.example.org",
             "deep.nested.example.org", "x.deep.example.org", "example.org",
             "unknown.example.com", ""]
    seen = []
    for ns in (REF, PORT):
        idx = ns.index.HostIndex()
        trail = []
        for op in ops:
            getattr(idx, op[0])(*op[1:])
            trail.append(([idx.get(h) for h in hosts],
                          [idx.find_id(h) for h in hosts],
                          idx.find_keys("cfg-3"), sorted(idx.list()),
                          idx.empty()))
        with pytest.raises(ns.index.IndexError_):
            idx.set("cfg-7", "example.org", "Y")
        seen.append(trail)
    assert seen[0] == seen[1]


def test_metrics_share_the_reference_series():
    """Both packages record the pipeline's metric families into one
    collector per name in the default registry, so a count read here is a
    delta over whatever else this process recorded."""
    from prometheus_client import REGISTRY

    import authorino_tpu.utils.metrics as r_metrics
    import authorino_tpu_torch.utils.metrics as p_metrics

    for name in ("evaluator_total", "evaluator_ignored", "evaluator_denied",
                 "evaluator_cancelled", "evaluator_duration",
                 "authconfig_total", "authconfig_duration",
                 "authconfig_response_status"):
        assert getattr(p_metrics, name) is getattr(r_metrics, name), name

    labels = {"namespace": "metrics-ns", "authconfig": "metrics-cfg"}

    def count(metric, **extra):
        return REGISTRY.get_sample_value(metric, dict(labels, **extra)) or 0.0

    t0 = count("auth_server_authconfig_total")
    s0 = count("auth_server_authconfig_response_status_total",
               status="PERMISSION_DENIED")
    deep0 = count("auth_server_evaluator_denied_total",
                  evaluator_type="PATTERN_MATCHING", evaluator_name="rbac")
    for ns in (REF, PORT):
        cfg, req, kw = c_pattern_deny(ns)
        cfg.labels = {"namespace": "metrics-ns", "name": "metrics-cfg"}
        cfg.authorization[0].type = "PATTERN_MATCHING"
        cfg.authorization[0].metrics = True
        run(ns.pipeline.AuthPipeline(request_of(ns, req), cfg, **kw).evaluate())
    assert count("auth_server_authconfig_total") - t0 == 2
    assert count("auth_server_authconfig_response_status_total",
                 status="PERMISSION_DENIED") - s0 == 2
    assert count("auth_server_evaluator_denied_total",
                 evaluator_type="PATTERN_MATCHING",
                 evaluator_name="rbac") - deep0 == 2


# the per-evaluator sample names (counters' ``_total``, the histogram's
# ``_count``); durations themselves are wall-clock and not compared
_DEEP_SAMPLES = ("auth_server_evaluator_total",
                 "auth_server_evaluator_ignored_total",
                 "auth_server_evaluator_denied_total",
                 "auth_server_evaluator_cancelled_total",
                 "auth_server_evaluator_duration_seconds_count")


def deep_counts(ns, tag, name):
    """Run case ``name`` in package ``ns`` under labels of its own; return
    the result and its per-evaluator metric samples."""
    from prometheus_client import REGISTRY

    cfg, req, kw = CASES[name](ns)
    cfg.labels = {"namespace": f"deep-{tag}", "name": name}
    result = run(ns.pipeline.AuthPipeline(request_of(ns, req), cfg,
                                          **kw).evaluate())
    counts = {}
    for family in REGISTRY.collect():
        for s in family.samples:
            if (s.name in _DEEP_SAMPLES
                    and s.labels.get("namespace") == f"deep-{tag}"
                    and s.labels.get("authconfig") == name):
                counts[(s.name, s.labels["evaluator_type"],
                        s.labels["evaluator_name"])] = s.value
    return result, counts


# cases that stop before any evaluator runs
_NO_EVALUATOR = {"top_level_skip", "expired_deadline"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_deep_metrics_equal_reference(name, monkeypatch):
    """With DEEP_METRICS_ENABLED on in both packages, every evaluator's
    total, ignored, denied, cancelled and duration counts equal the
    reference's, and so does the result."""
    for ns in (REF, PORT):
        monkeypatch.setattr(ns.metrics, "DEEP_METRICS_ENABLED", True)
    want, want_counts = deep_counts(REF, "ref", name)
    got, got_counts = deep_counts(PORT, "port", name)
    assert result_fields(got) == result_fields(want)
    assert got_counts == want_counts
    assert bool(got_counts) == (name not in _NO_EVALUATOR)
