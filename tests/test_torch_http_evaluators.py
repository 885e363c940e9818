"""The port's JWT/OIDC identity and outbound-HTTP evaluators (on the
standard library's HTTP client and the port's JOSE layer) against the JAX
package's (on aiohttp and ``cryptography``), both talking to one fake
Keycloak (``models/oidc_corpus.py``, ``http.server`` on ``127.0.0.1:0``).

Each case translates the same AuthConfig spec with each package's
``translate_auth_config``, reads the same Secrets, answers the same
requests through each package's engine (the port's on the CPU, through the
kernel's plain version) and compares every ``AuthResult`` field
(tolerance 0).  A wristband differs only in its signature (ECDSA draws a
random nonce) and its clock: its claims are compared, and each package's
token verifies under the other's JOSE.  Direct evaluator calls compare
HTTP errors; a refused connection is compared by its ``request failed:``
prefix, since aiohttp words its exception differently.

Every server binds port 0 and is stopped in a ``finally``; every wait has
a timeout."""

import asyncio
import hashlib
import json
import random
import time

import pytest

from authorino_tpu.utils import http as r_http
from authorino_tpu.utils import jose as r_jose
from authorino_tpu_torch.models import oidc_corpus as oc
from authorino_tpu_torch.utils import http as p_http
from authorino_tpu_torch.utils import jose as p_jose
from authorino_tpu_torch.utils import pki

from test_torch_check import cluster_of
from test_torch_pipeline import PORT, REF, engine_of, request_of, result_fields, run

NS = oc.NAMESPACE
HTTP = {id(REF): r_http, id(PORT): p_http}


@pytest.fixture(scope="module")
def keys():
    return oc.make_keys(21, rsa_bits=1024)


@pytest.fixture
def idp(keys):
    server = oc.FakeKeycloak(keys).start()
    try:
        yield server
    finally:
        server.stop()


def req(host, token=None, method="GET", path="/pets", headers=None):
    h = dict(headers or {})
    if token is not None:
        h["authorization"] = f"Bearer {token}"
    return {"method": method, "path": path, "host": host, "headers": h}


def answer(ns, configs, requests, secrets, during=None, prefetch=False):
    """Translate ``configs`` [(name, spec)] with one engine of ``ns``,
    install them, and answer ``requests`` one at a time;
    ``during(entries, check)`` runs (and is awaited) between install and
    the requests, with ``check(http dict)`` answering one request.
    Returns (entries, results).  ``prefetch`` sets both engines' metadata
    prefetch cache: off, each package fetches each document when a
    request needs it, as Authorino does; on, the install's first re-pin
    of every request-independent document lands before the requests."""
    engine = engine_of(ns, metadata_prefetch=prefetch)
    cluster = cluster_of(ns, secrets)

    async def body():
        entries = []
        try:
            for name, spec in configs:
                entries.append(await ns.controllers.translate_auth_config(
                    name, NS, spec, cluster=cluster, engine=engine))
            engine.apply_snapshot(entries)
            pf = engine.metadata_prefetcher
            if pf is not None and pf.to_json()["registered"]:
                deadline = time.monotonic() + 20
                while pf.to_json()["counters"]["refresh"] < 1:
                    assert time.monotonic() < deadline, "no re-pin landed"
                    await asyncio.sleep(0.01)

            async def check(r):
                return await engine.check(request_of(ns, dict(r)))

            if during is not None:
                await during(entries, check)
            return entries, [await check(r) for r in requests]
        finally:
            if engine.metadata_prefetcher is not None:
                engine.metadata_prefetcher.stop()
            for e in entries:
                await e.runtime.clean()
            await HTTP[id(ns)].close_sessions()

    return run(body())


def both(configs, requests, secrets, during=None):
    """(reference results, port results) as lists of ``result_fields``."""
    out = []
    for ns in (REF, PORT):
        _, results = answer(ns, configs, requests, secrets, during)
        out.append([result_fields(r) for r in results])
    return out


# ---- the JWT identity ----------------------------------------------------------

def jwt_spec(issuer, **jwt):
    return {"hosts": ["jwt.test"],
            "authentication": {"keycloak": {"jwt": dict(issuerUrl=issuer, **jwt)}},
            "authorization": {"roles": {"patternMatching": {"patterns": [
                {"selector": "auth.identity.realm_access.roles",
                 "operator": "incl", "value": "admin"}]}}},
            "response": {"success": {"headers": {"x-user": {"json": {
                "properties": {"sub": {"selector": "auth.identity.sub"},
                               "iss": {"selector": "auth.identity.iss"}}}}}}}}


ADMIN = {"realm_access": {"roles": ["admin"]}}
VIEWER = {"realm_access": {"roles": ["viewer"]}}
JWT_CASES = {
    "rs256_admin": lambda idp: idp.token(ADMIN),
    "es256_admin": lambda idp: idp.token(ADMIN, alg="ES256"),
    "rs256_viewer": lambda idp: idp.token(VIEWER),
    "ps256_against_rs256_jwk": lambda idp: idp.token(ADMIN, alg="PS256"),
    "es256_under_the_rsa_kid": lambda idp: idp.token(
        ADMIN, alg="ES256", kid=oc.RSA_KID),
    "bad_signature": lambda idp: idp.bad_token("signature", ADMIN),
    "expired": lambda idp: idp.bad_token("expired", ADMIN),
    "within_leeway": lambda idp: idp.token(dict(ADMIN, exp=int(time.time()) - 5)),
    "not_yet_valid": lambda idp: idp.token(dict(ADMIN, nbf=int(time.time()) + 600)),
    "foreign_issuer": lambda idp: idp.bad_token("issuer", ADMIN),
    "unknown_key": lambda idp: idp.bad_token("unknown_key", ADMIN),
    "alg_none": lambda idp: ".".join([
        p_jose.b64url_encode(b'{"alg":"none"}'),
        idp.token(ADMIN).split(".")[1], ""]),
    "malformed": lambda idp: "not-a-jwt",
    "no_credential": lambda idp: None,
}


@pytest.mark.parametrize("case", sorted(JWT_CASES))
def test_jwt_identity_equals_reference(idp, keys, case):
    token = JWT_CASES[case](idp)
    want, got = both([("jwt", jwt_spec(idp.issuer))],
                     [req("jwt.test", token)], oc.cluster_secrets(keys))
    assert got == want
    if case in ("rs256_admin", "es256_admin", "within_leeway"):
        assert got[0][0] == PORT.rpc.OK
    elif case == "rs256_viewer":
        assert got[0][0] == PORT.rpc.PERMISSION_DENIED
    else:
        assert got[0][0] == PORT.rpc.UNAUTHENTICATED


def test_jwt_with_another_credential_location_equals_reference(idp, keys):
    spec = jwt_spec(idp.issuer)
    spec["authentication"]["keycloak"]["credentials"] = {
        "customHeader": {"name": "x-token"}}
    token = idp.token(ADMIN)
    requests = [req("jwt.test", headers={"x-token": token}),
                req("jwt.test", token)]
    want, got = both([("jwt", spec)], requests, oc.cluster_secrets(keys))
    assert got == want
    assert [g[0] for g in got] == [PORT.rpc.OK, PORT.rpc.UNAUTHENTICATED]


def test_oidc_key_rotation_seen_by_the_ttl_refresh(idp, keys):
    """``ttl: 1``: a token under a key the JWKS does not hold yet fails;
    once the provider publishes the key, the refresh worker picks it up,
    the change listeners fire once and the token verifies."""
    new_key = pki.generate_rsa_private_key(1024, random.Random(77))
    new_jwk = p_jose.jwk_from_public_key(new_key.public_key(), kid="rsa-2")
    token = idp.token(ADMIN, key=new_key, kid="rsa-2")
    old_jwks = list(idp.jwks)
    seen = {}

    async def during(entries, check):
        oidc = entries[0].runtime.identity[0].evaluator
        fired = seen["fired"] = []
        oidc.add_change_listener(lambda: fired.append(1))
        seen["before"] = result_fields(await check(req("jwt.test", token)))
        idp.jwks = old_jwks + [new_jwk]
        deadline = time.monotonic() + 10
        while new_jwk not in oidc.jwks:
            assert time.monotonic() < deadline, "the JWKS refresh never came"
            await asyncio.sleep(0.05)

    results = []
    for ns in (REF, PORT):
        idp.jwks = list(old_jwks)
        _, res = answer(ns, [("jwt", jwt_spec(idp.issuer, ttl=1))],
                        [req("jwt.test", token)], oc.cluster_secrets(keys),
                        during=during)
        results.append((seen["before"], result_fields(res[0]),
                        len(seen["fired"])))
    assert results[1] == results[0]
    before, after, n_fired = results[1]
    assert (before[0], after[0], n_fired) == (PORT.rpc.UNAUTHENTICATED,
                                             PORT.rpc.OK, 1)


def test_jwt_discovery_failure_is_a_translation_error(idp, keys):
    """Discovery at translate time: an issuer that answers 404, or whose
    discovery document has no ``issuer``, fails translation in both
    packages with the same words up to the transport's own text."""
    for issuer in (idp.issuer + "/status/404", idp.issuer + "/echo"):
        msgs = []
        for ns in (REF, PORT):
            with pytest.raises(ns.controllers.TranslationError) as e:
                answer(ns, [("jwt", jwt_spec(issuer))], [], [])
            msgs.append(str(e.value))
        assert msgs[1] == msgs[0]
        assert msgs[0].startswith("failed OIDC discovery for 'keycloak': ")


# ---- OAuth2 introspection --------------------------------------------------------

INTROSPECTION_CASES = {
    "active": ("opaque-active", None),
    "inactive": ("opaque-unknown", None),
    "no_credential": (None, None),
    "wrong_client_secret": ("opaque-active", b"not-the-secret"),
}


@pytest.mark.parametrize("case", sorted(INTROSPECTION_CASES))
def test_oauth2_introspection_equals_reference(idp, keys, case):
    token, client_secret = INTROSPECTION_CASES[case]
    secrets = oc.cluster_secrets(keys)
    if client_secret is not None:
        for s in secrets:
            if s["name"] == "introspection-credentials":
                s["data"] = dict(s["data"], clientSecret=client_secret)
    spec = oc.introspection_auth_config(idp.issuer)["spec"]
    want, got = both([("introspect", spec)],
                     [req(oc.INTROSPECTION_HOST, token)], secrets)
    assert got == want
    assert got[0][0] == (PORT.rpc.OK if case == "active"
                         else PORT.rpc.UNAUTHENTICATED)


# ---- metadata: userInfo, http, uma -----------------------------------------------

def md_spec(issuer, metadata, authentication=None, patterns=None):
    """Anonymous (or ``authentication``) config whose success header shows
    the whole ``auth.metadata``."""
    spec = {"hosts": ["md.test"],
            "authentication": authentication or {"anon": {"anonymous": {}}},
            "metadata": metadata,
            "response": {"success": {"headers": {"x-md": {"json": {
                "properties": {"md": {"selector": "auth.metadata"}}}}}}}}
    if patterns:
        spec["authorization"] = {"md": {"patternMatching": {
            "patterns": patterns}}}
    return spec


def test_userinfo_bound_and_unbound_equals_reference(idp, keys):
    """userInfo resolves for a request the jwt identity authenticated,
    and fails (a tolerated metadata error) for one the anonymous fallback
    took."""
    spec = md_spec(idp.issuer, {"ui": {"userInfo": {"identitySource": "keycloak"}}},
                   authentication={
                       "keycloak": {"jwt": {"issuerUrl": idp.issuer}},
                       "anon": {"anonymous": {}, "priority": 1}})
    requests = [req("md.test", idp.token(ADMIN)), req("md.test")]
    want, got = both([("md", spec)], requests, oc.cluster_secrets(keys))
    assert got == want
    bound = json.loads(got[0][3][0]["x-md"])["md"]
    unbound = json.loads(got[1][3][0]["x-md"])["md"]
    assert bound["ui"] == idp.userinfo and "ui" not in unbound


def test_userinfo_without_its_identity_source_is_refused(idp, keys):
    spec = md_spec(idp.issuer, {"ui": {"userInfo": {"identitySource": "nope"}}})
    msgs = []
    for ns in (REF, PORT):
        with pytest.raises(ns.controllers.TranslationError) as e:
            answer(ns, [("md", spec)], [], [])
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]


def http_md(issuer, **kw):
    return {"http": dict(url=issuer + kw.pop("path", "/echo"), **kw)}


HTTP_CASES = {
    "get_templated_query": lambda iss: http_md(
        iss, path="/echo/q?user={auth.identity.anonymous}",
        headers={"x-tag": {"value": "v1"},
                 "x-method": {"selector": "request.method"}}),
    "get_parameters": lambda iss: http_md(
        iss, bodyParameters={"a": {"value": "1"},
                             "m": {"selector": "request.method"}}),
    "post_json_parameters": lambda iss: http_md(
        iss, method="POST", bodyParameters={
            "a": {"value": {"nested": [1, 2]}},
            "path": {"selector": "request.path"}}),
    "post_form_parameters": lambda iss: http_md(
        iss, method="POST", contentType="application/x-www-form-urlencoded",
        bodyParameters={"a": {"value": "x y"},
                        "m": {"selector": "request.method"}}),
    "post_body": lambda iss: http_md(
        iss, method="POST", body={"value": "raw body text"},
        contentType="text/plain"),
    "put_body_selector": lambda iss: http_md(
        iss, method="PUT", body={"selector": "request.headers"}),
    "shared_secret_authorization_header": lambda iss: http_md(
        iss, sharedSecretRef={"name": "echo-secret", "key": "token"}),
    "shared_secret_custom_header": lambda iss: http_md(
        iss, sharedSecretRef={"name": "echo-secret", "key": "token"},
        credentials={"customHeader": {"name": "x-shared"}}),
    "shared_secret_query": lambda iss: http_md(
        iss, sharedSecretRef={"name": "echo-secret", "key": "token"},
        credentials={"queryString": {"name": "key"}}),
    "shared_secret_cookie": lambda iss: http_md(
        iss, sharedSecretRef={"name": "echo-secret", "key": "token"},
        credentials={"cookie": {"name": "session"}}),
    "oauth2_client_credentials": lambda iss: http_md(
        iss, oauth2={"tokenUrl": iss + "/protocol/openid-connect/token",
                     "clientId": oc.CLIENT_ID,
                     "clientSecretRef": {"name": "uma-credentials"},
                     "scopes": ["read", "write"]}),
    "redirected_get": lambda iss: http_md(iss, path="/redirect?to=/echo/r"),
    "text_response": lambda iss: http_md(iss, path="/text"),
    "status_error": lambda iss: http_md(iss, path="/status/503"),
    "bad_json": lambda iss: http_md(iss, path="/badjson"),
}


@pytest.mark.parametrize("case", sorted(HTTP_CASES))
def test_generic_http_metadata_equals_reference(idp, keys, case):
    spec = md_spec(idp.issuer, {"echo": HTTP_CASES[case](idp.issuer)})
    requests = [req("md.test", method="GET", path="/a b?x=1",
                    headers={"x-in": "1"}),
                req("md.test", method="POST", path="/p")]
    want, got = both([("md", spec)], requests, oc.cluster_secrets(keys))
    assert got == want
    assert all(g[0] == PORT.rpc.OK for g in got)


@pytest.mark.parametrize("case", sorted(HTTP_CASES))
def test_generic_http_metadata_prefetched_equals_reference(idp, keys, case):
    """The same cases with both engines' metadata prefetch cache on (the
    reference's default): equal results, equal prefetch counts, and the
    same live fetches during the requests: none where the document is
    request-independent and pinned, one per request otherwise."""
    spec = md_spec(idp.issuer, {"echo": HTTP_CASES[case](idp.issuer)})
    requests = [req("md.test", method="GET", path="/a b?x=1",
                    headers={"x-in": "1"}),
                req("md.test", method="POST", path="/p")]
    runs = []
    for ns in (REF, PORT):
        seen = {}

        async def during(entries, check, seen=seen):
            seen["before"] = sum(idp.counts.values())
            seen["entries"] = entries

        _, res = answer(ns, [("md", spec)], requests,
                        oc.cluster_secrets(keys), during, prefetch=True)
        md = seen["entries"][0].runtime.metadata[0]
        pf, _ = md.prefetch if md.prefetch is not None else (None, None)
        runs.append(([result_fields(r) for r in res],
                     sum(idp.counts.values()) - seen["before"],
                     md.prefetchable, md.prefetch_pinned,
                     {k: v for k, v in pf.to_json()["counters"].items()
                      if k != "refresh"} if pf is not None else None))
    assert runs[1] == runs[0]
    _, live, prefetchable, pinned, counts = runs[1]
    assert prefetchable == pinned
    if pinned and case not in ("status_error", "bad_json", "text_response"):
        assert counts["hit"] == 2 and live == 0


def test_oauth2_token_is_cached_until_it_expires(idp, keys):
    """Client credentials: one token request serves three metadata calls
    (the token is valid 300 s), in both packages."""
    spec = md_spec(idp.issuer, {"echo": HTTP_CASES["oauth2_client_credentials"](
        idp.issuer)})
    counts = []
    for ns in (REF, PORT):
        before = idp.counts["POST /protocol/openid-connect/token"]
        answer(ns, [("md", spec)], [req("md.test")] * 3, oc.cluster_secrets(keys))
        counts.append(idp.counts["POST /protocol/openid-connect/token"] - before)
    assert counts == [1, 1]


def test_metadata_cache_equals_reference(idp, keys):
    """``cache`` on an http metadata evaluator: requests with the same
    key are answered from the cache (the endpoint is hit once per key)."""
    md = HTTP_CASES["get_templated_query"](idp.issuer)
    md["cache"] = {"key": {"selector": "request.headers.x-user"}, "ttl": 60}
    spec = md_spec(idp.issuer, {"echo": md})
    requests = [req("md.test", headers={"x-user": u}) for u in "aaba"]
    hits, results = [], []
    for ns in (REF, PORT):
        before = idp.counts["GET /echo/q"]
        _, res = answer(ns, [("md", spec)], requests, oc.cluster_secrets(keys))
        hits.append(idp.counts["GET /echo/q"] - before)
        results.append([result_fields(r) for r in res])
    assert results[1] == results[0]
    assert hits == [2, 2]


def test_uma_metadata_equals_reference(idp, keys):
    spec = md_spec(idp.issuer, {"res": {"uma": {
        "endpoint": idp.issuer, "credentialsRef": {"name": "uma-credentials"}}}},
        patterns=[{"selector": "auth.metadata.res.0.name", "operator": "eq",
                   "value": "pets"}])
    requests = [req("md.test", path="/pets"), req("md.test", path="/orders"),
                req("md.test", path="/nothing")]
    want, got = both([("md", spec)], requests, oc.cluster_secrets(keys))
    assert got == want
    assert [g[0] for g in got] == [PORT.rpc.OK, PORT.rpc.PERMISSION_DENIED,
                                   PORT.rpc.PERMISSION_DENIED]


# ---- direct evaluator calls: errors and trace propagation -------------------------

def pipeline_of(ns, identity=None, span=None):
    p = ns.pipeline.AuthPipeline(request_of(ns, req("svc.test")),
                                 ns.ev.RuntimeAuthConfig(), span=span)
    if identity is not None:
        p.identity_results[ns.ev.IdentityConfig("test", ns.ident.Noop())] = \
            identity
        p._sync_auth()
    return p


def call_http(ns, url, span=None, **kw):
    """(result or error text) of one GenericHttp call of package ``ns``."""
    from importlib import import_module

    md = import_module(f"{ns.ev.__name__}.metadata")
    value = import_module(f"{ns.aj.__name__}.value")
    ev = md.GenericHttp(endpoint=value.JSONValue(pattern=url) if "{" in url
                        else value.JSONValue(static=url), **kw)

    async def body():
        try:
            return ("ok", await ev.call(pipeline_of(ns, {"user": "u1"}, span)))
        except ns.ev.EvaluationError as e:
            return ("error", str(e))
        finally:
            await HTTP[id(ns)].close_sessions()

    return run(body())


@pytest.mark.parametrize("path", ["/status/404", "/status/500", "/status/401",
                                  "/badjson", "/text", "/echo?u={auth.identity.user}",
                                  "/redirect?to=/echo/after"])
def test_http_results_and_errors_equal_reference(idp, path):
    got = [call_http(ns, idp.issuer + path) for ns in (REF, PORT)]
    assert got[1] == got[0]


def test_refused_connection_has_the_same_prefix(idp):
    port = idp.issuer.rsplit(":", 1)[1]
    idp.stop()  # nothing listens on the port any more
    got = [call_http(ns, f"http://127.0.0.1:{port}/echo") for ns in (REF, PORT)]
    assert [g[0] for g in got] == ["error", "error"]
    assert all(g[1].startswith("request failed: ") for g in got), got


class FakeSpan:
    def inject(self, headers):
        headers["traceparent"] = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"


def test_span_context_rides_the_outbound_call(idp):
    got = [call_http(ns, idp.issuer + "/echo", span=FakeSpan())
           for ns in (REF, PORT)]
    assert got[1] == got[0]
    assert got[0][1]["headers"]["traceparent"].startswith("00-0af765")


# ---- wristband and callbacks --------------------------------------------------------

def test_full_config_equals_reference(idp, keys):
    """The full config of ``oidc_corpus``: a jwt identity, userInfo, http
    and uma metadata, a pattern over ``auth.metadata.*``, a wristband
    header and an http callback.  Results are equal but the wristband's
    signature and clock; each package's wristband verifies under the
    other's JOSE against its JWKS; the callback counts are equal."""
    spec = oc.full_auth_config(idp.issuer)["spec"]
    admin = dict(ADMIN, org="org-7")
    requests = [req(oc.FULL_HOST, idp.token(admin, alg="ES256")),
                req(oc.FULL_HOST, idp.token(admin), path="/orders"),
                req(oc.FULL_HOST, idp.token(dict(admin, org="org-8"))),
                req(oc.FULL_HOST, idp.bad_token("expired", admin))]
    runs = []
    for ns in (REF, PORT):
        n0 = len(idp.callbacks)
        entries, res = answer(ns, [("full", spec)], requests,
                              oc.cluster_secrets(keys))
        wristband = entries[0].runtime.response[0].evaluator
        runs.append((res, json.loads(wristband.jwks())["keys"],
                     idp.callbacks[n0:]))
    (r_res, r_jwks, r_cb), (p_res, p_jwks, p_cb) = runs
    assert p_jwks == r_jwks
    assert p_cb == r_cb and len(p_cb) == len(requests)
    assert [r.code for r in p_res] == [PORT.rpc.OK, PORT.rpc.PERMISSION_DENIED,
                                       PORT.rpc.PERMISSION_DENIED,
                                       PORT.rpc.UNAUTHENTICATED]
    for r, p in zip(r_res, p_res):
        r_f, p_f = result_fields(r), result_fields(p)
        if p.code != PORT.rpc.OK:
            assert p_f == r_f
            continue
        assert (p_f[:3], p_f[4:]) == (r_f[:3], r_f[4:])
        r_tok, p_tok = r.headers[0]["x-wristband"], p.headers[0]["x-wristband"]
        r_claims = r_jose.verify_jws(p_tok, r_jwks)
        p_claims = p_jose.verify_jws(r_tok, p_jwks)
        for c in (r_claims, p_claims):
            assert c["exp"] - c["iat"] == 300
            c.pop("exp"), c.pop("iat")
        assert p_claims == r_claims
        assert r_jose.decode_unverified(p_tok)[0] == \
            r_jose.decode_unverified(r_tok)[0]
        identity = p_jose.decode_unverified(requests[0]["headers"][
            "authorization"][len("Bearer "):])[1]
        assert p_claims["sub"] == hashlib.sha256(json.dumps(
            identity, separators=(",", ":"), sort_keys=True).encode()
        ).hexdigest()


def test_wristband_identity_of_its_own_issuer_passes_through(keys):
    """A resolved identity whose OIDC endpoint is the wristband's issuer
    gets no new wristband (both packages answer None)."""
    from importlib import import_module

    pem = pki.private_key_to_pem(keys.wristband)
    got = []
    for ns in (REF, PORT):
        wb = import_module(f"{ns.resp.__name__}.wristband")
        oidc = import_module(f"{ns.ident.__name__}.oidc")
        w = wb.Wristband(issuer="http://w.test", signing_keys=[
            wb.SigningKey.from_pem("k", "ES256", pem)])
        p = pipeline_of(ns)
        p.identity_results[ns.ev.IdentityConfig(
            "w", oidc.OIDC("w", "http://w.test"))] = {"sub": "x"}
        got.append(run(w.call(p)))
    assert got == [None, None]


@pytest.mark.parametrize("where", ["metadata", "callbacks"])
def test_gate_beside_http_evaluator_does_not_fold(idp, keys, where):
    """An anonymous config with a request-rooted top-level `when`, pattern
    authorization and an http metadata or callback evaluator: the gate
    stays on the pipeline (a skipped pipeline runs no metadata and no
    response), so a gate-unmatched request answers OK without touching the
    endpoint's result, as the reference does."""
    spec = {"hosts": ["gate.test"],
            "when": [{"selector": "request.method", "operator": "neq",
                      "value": "OPTIONS"}],
            "authentication": {"anon": {"anonymous": {}}},
            "authorization": {"r": {"patternMatching": {"patterns": [
                {"selector": "request.headers.x-org", "operator": "eq",
                 "value": "acme"}]}}},
            where: {"x": {"http": {"url": idp.issuer + "/callback",
                                   "method": "POST"}}}}
    requests = [req("gate.test", method=m, headers=h)
                for m in ("OPTIONS", "GET") for h in ({}, {"x-org": "acme"})]
    shapes, results = [], []
    for ns in (REF, PORT):
        entries, res = answer(ns, [("gate", spec)], requests,
                              oc.cluster_secrets(keys))
        e = entries[0]
        shapes.append((e.runtime.conditions is not None,
                       [c is None for c, _ in e.rules.evaluators]))
        results.append([result_fields(r) for r in res])
    assert shapes == [(True, [True]), (True, [True])]
    assert results[1] == results[0]
    assert [r[0] for r in results[1]] == [PORT.rpc.OK, PORT.rpc.OK,
                                          PORT.rpc.PERMISSION_DENIED,
                                          PORT.rpc.OK]
