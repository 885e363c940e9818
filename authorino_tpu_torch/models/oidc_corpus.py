"""The Keycloak RBAC workload: OIDC JWT authentication with
``patternMatching`` on the token's claims (Authorino's user guide
"OpenID Connect Discovery and authentication with JWTs" with the
Keycloak realm-roles RBAC of "Simple pattern-matching authorization
policies"), and a fake Keycloak to serve it on loopback.

- ``make_keys``: the provider's RSA-2048 and P-256 signing keys, a key it
  does not publish and a wristband signing key, all made from a seed in
  pure Python (``utils/pki.py``: Miller-Rabin primes, a scalar draw).
- ``FakeKeycloak``: ``http.server.ThreadingHTTPServer`` on
  ``127.0.0.1:0`` on a daemon thread, serving OIDC discovery, the JWKS
  (one RSA and one EC key, by kid), userinfo, RFC 7662 introspection, a
  client-credentials token endpoint, UMA discovery and resources, a
  metadata echo, status/text/redirect endpoints and a callback counter.
  Any HTTP client can talk to it: the port's and an aiohttp one alike.
- ``build_auth_configs``: ``northstar``'s rules (same seed, same draws) as
  v1beta2 AuthConfigs ``jwt-{i}`` on host ``jwt-{i}.oidc``, each with one
  ``jwt`` identity on the fake issuer and one ``patternMatching``
  evaluator over the verified claims.
- ``full_auth_config`` and ``introspection_auth_config``: one AuthConfig
  that uses every other kind of this family (userInfo, http and uma
  metadata, a pattern on ``auth.metadata.*``, a wristband header, an http
  callback) and one OAuth2-introspection AuthConfig (with a ``cache``
  opt-in keyed by the bearer header, if asked); ``cluster_secrets`` the
  Secrets they read.
- ``build_check_requests``: Check() requests carrying ``build_docs``'
  claims as RS256 bearer tokens, one request in 32 with a bad token.
"""

from __future__ import annotations

import base64
import json
import random
import threading
import time
import urllib.parse
from collections import Counter
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from ..authjson.wellknown import CheckRequestModel, HttpRequestAttributes
from ..utils import jose, pki
from .northstar import _draw_rules, build_docs

__all__ = ["NAMESPACE", "RSA_KID", "EC_KID", "ROGUE_KID", "CLIENT_ID",
           "CLIENT_SECRET", "BAD_TOKENS", "Keys", "make_keys",
           "FakeKeycloak", "host_of", "build_auth_configs",
           "full_auth_config", "introspection_auth_config",
           "cluster_secrets", "build_check_requests", "WRISTBAND_ISSUER",
           "FULL_HOST", "INTROSPECTION_HOST", "INTROSPECTION_CACHED_HOST"]

NAMESPACE = "oidc"
RSA_KID, EC_KID, ROGUE_KID = "rsa-1", "ec-1", "rogue-1"
CLIENT_ID, CLIENT_SECRET = "authorino", "client-s3cr3t"
ECHO_SECRET = "echo-s3cr3t"
WRISTBAND_ISSUER = "https://authorino.oidc/full/wristband"
# the ways a token goes bad, in turns, one request in 32
BAD_TOKENS = ("signature", "expired", "issuer", "unknown_key")
FOREIGN_ISSUER = "https://idp.foreign.example/realms/other"


@dataclass
class Keys:
    rsa: pki.RSAPrivateKey
    ec: pki.ECPrivateKey
    rogue: pki.RSAPrivateKey      # signs tokens under a kid the JWKS lacks
    wristband: pki.ECPrivateKey   # the wristband's signing key


def make_keys(seed: int = 42, rsa_bits: int = 2048) -> Keys:
    rng = random.Random(seed)
    return Keys(rsa=pki.generate_rsa_private_key(rsa_bits, rng),
                ec=pki.generate_ec_private_key(pki.P256, rng),
                rogue=pki.generate_rsa_private_key(rsa_bits, rng),
                wristband=pki.generate_ec_private_key(pki.P256, rng))


def host_of(i: int) -> str:
    return f"jwt-{i}.{NAMESPACE}"


# ---------------------------------------------------------------------------
# the fake Keycloak
# ---------------------------------------------------------------------------

_OIDC = "/protocol/openid-connect"
_RESOURCES = "/authz/protection/resource_set"
# the request headers the echo returns (clients add others of their own)
_ECHOED = ("authorization", "content-type", "cookie", "traceparent")


class FakeKeycloak:
    """A realm of one fake Keycloak on loopback.  Its state is plain data
    that a test may change between requests: ``jwks`` (a rotation),
    ``userinfo``, ``active_tokens``, ``resources``; ``counts`` counts the
    requests by ``"METHOD /path"`` and ``callbacks`` keeps each callback's
    body.
    Use as a context manager, or ``start()`` and ``stop()``."""

    def __init__(self, keys: Keys):
        self.keys = keys
        self.jwks: List[Dict[str, Any]] = [
            jose.jwk_from_public_key(keys.rsa.public_key(), kid=RSA_KID),
            jose.jwk_from_public_key(keys.ec.public_key(), kid=EC_KID)]
        self.userinfo = {"sub": "user-0", "email": "user-0@acme.example",
                         "email_verified": True}
        self.active_tokens = {"opaque-active": {
            "active": True, "username": "svc-batch", "scope": "read"}}
        # id -> resource; a resource answers a lookup by any of its uris
        self.resources = {
            "r-pets": {"_id": "r-pets", "name": "pets", "owner": "user-0",
                       "uris": ["/pets", "/pets/1"]},
            "r-orders": {"_id": "r-orders", "name": "orders",
                         "owner": "user-1", "uris": ["/orders"]}}
        self.counts: Counter = Counter()
        self.callbacks: List[str] = []
        self._lock = threading.Lock()
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.issuer = ""

    # --- lifecycle ---

    def start(self) -> "FakeKeycloak":
        self._server = ThreadingHTTPServer(("127.0.0.1", 0), _handler(self))
        self._server.daemon_threads = True
        self.issuer = f"http://127.0.0.1:{self._server.server_address[1]}"
        # a short poll keeps stop() quick: shutdown() waits for one poll
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        args=(0.05,), name="fake-keycloak",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._thread.join(timeout=10)
            self._server = self._thread = None

    def __enter__(self) -> "FakeKeycloak":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # --- tokens ---

    def token(self, claims: Optional[Dict[str, Any]] = None, alg: str = "RS256",
              key=None, kid: Optional[str] = None) -> str:
        """A token of this issuer (valid an hour) over ``claims``, signed
        with the RSA key (RS*/PS*) or the EC key (ES*) unless ``key`` is
        given."""
        now = int(time.time())
        payload = {"iss": self.issuer, "sub": "user-0", "iat": now,
                   "exp": now + 3600}
        payload.update(claims or {})
        if key is None:
            key, default_kid = ((self.keys.ec, EC_KID) if alg.startswith("ES")
                                else (self.keys.rsa, RSA_KID))
            kid = default_kid if kid is None else kid
        return jose.sign_jwt(payload, key, alg, kid=kid or "")

    def bad_token(self, kind: str, claims: Dict[str, Any]) -> str:
        """A token over ``claims`` that fails verification as ``kind`` of
        ``BAD_TOKENS`` says."""
        if kind == "signature":
            h, p, s = self.token(claims).split(".")
            sig = bytearray(jose.b64url_decode(s))
            sig[len(sig) // 2] ^= 0x01
            return f"{h}.{p}.{jose.b64url_encode(bytes(sig))}"
        if kind == "expired":  # a minute past the verifier's 30 s leeway
            now = int(time.time())
            return self.token(dict(claims, iat=now - 3600, exp=now - 90))
        if kind == "issuer":
            return self.token(dict(claims, iss=FOREIGN_ISSUER))
        if kind == "unknown_key":
            return self.token(claims, key=self.keys.rogue, kid=ROGUE_KID)
        raise ValueError(f"unknown bad token kind {kind!r}")

    # --- documents ---

    def discovery(self) -> Dict[str, Any]:
        iss = self.issuer
        return {"issuer": iss,
                "jwks_uri": iss + _OIDC + "/certs",
                "userinfo_endpoint": iss + _OIDC + "/userinfo",
                "token_endpoint": iss + _OIDC + "/token",
                "introspection_endpoint": iss + _OIDC + "/token/introspect"}

    def uma_discovery(self) -> Dict[str, Any]:
        return {"issuer": self.issuer,
                "token_endpoint": self.issuer + _OIDC + "/token",
                "resource_registration_endpoint": self.issuer + _RESOURCES}

    @staticmethod
    def _client_ok(authorization: str) -> bool:
        """Basic auth with the realm's client credentials."""
        want = base64.b64encode(f"{CLIENT_ID}:{CLIENT_SECRET}".encode())
        return authorization.encode() == b"Basic " + want

    def answer(self, method: str, target: str, headers: Dict[str, str],
               body: bytes) -> Tuple[int, Dict[str, str], bytes]:
        """(status, headers, body) for one request; ``headers`` has
        lower-case names."""
        url = urllib.parse.urlsplit(target)
        path = url.path
        query = dict(urllib.parse.parse_qsl(url.query))
        auth = headers.get("authorization", "")
        with self._lock:
            self.counts[f"{method} {path}"] += 1

        def js(obj, status=200):
            return status, {"Content-Type": "application/json"}, \
                json.dumps(obj).encode()

        def text(s, status):
            return status, {"Content-Type": "text/plain; charset=utf-8"}, \
                s.encode()

        if path == "/.well-known/openid-configuration":
            return js(self.discovery())
        if path == "/.well-known/uma2-configuration":
            return js(self.uma_discovery())
        if path == _OIDC + "/certs":
            return js({"keys": self.jwks})
        if path == _OIDC + "/userinfo":
            if not auth.startswith("Bearer "):
                return text("missing bearer token", 401)
            return js(self.userinfo)
        if path == _OIDC + "/token/introspect" and method == "POST":
            if not self._client_ok(auth):
                return text("invalid client credentials", 401)
            form = dict(urllib.parse.parse_qsl(body.decode()))
            return js(self.active_tokens.get(form.get("token"),
                                             {"active": False}))
        if path == _OIDC + "/token" and method == "POST":
            if not self._client_ok(auth):
                return text("invalid client credentials", 401)
            return js({"access_token": f"pat-{CLIENT_ID}",
                       "token_type": "Bearer", "expires_in": 300})
        if path.startswith(_RESOURCES):
            if not auth.startswith("Bearer pat-"):
                return text("missing protection API token", 401)
            rid = path[len(_RESOURCES) + 1:]
            if not rid:
                return js([r["_id"] for r in self.resources.values()
                           if query.get("uri") in r["uris"]])
            if rid not in self.resources:
                return text(f"resource {rid} not found", 404)
            return js(self.resources[rid])
        if path.startswith("/echo"):
            return js({"method": method, "path": path, "query": query,
                       "headers": {k: v for k, v in headers.items()
                                   if k in _ECHOED or k.startswith("x-")},
                       "body": body.decode()})
        if path.startswith("/status/"):
            code = int(path.split("/")[2])  # /status/<code>[/anything]
            return text(f"status {code} from the fake Keycloak", code)
        if path == "/text":
            return text("plain text answer", 200)
        if path == "/badjson":
            return 200, {"Content-Type": "application/json"}, b"{not json"
        if path == "/redirect":
            return 302, {"Location": query.get("to", "/echo")}, b""
        if path == "/callback" and method == "POST":
            with self._lock:
                self.callbacks.append(body.decode())
            return js({"ok": True})
        return text(f"no route for {method} {path}", 404)


def _handler(idp: FakeKeycloak):
    class Handler(BaseHTTPRequestHandler):
        def _serve(self):
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length) if length else b""
            headers = {k.lower(): v for k, v in self.headers.items()}
            status, out_headers, out = idp.answer(self.command, self.path,
                                                  headers, body)
            self.send_response(status)
            for k, v in out_headers.items():
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)

        do_GET = do_POST = do_PUT = do_PATCH = do_DELETE = _serve

        def log_message(self, *args):
            pass

    return Handler


# ---------------------------------------------------------------------------
# AuthConfigs and Secrets
# ---------------------------------------------------------------------------

def build_auth_configs(n: int, rules: int, issuer: str,
                       seed: int = 42) -> List[dict]:
    """v1beta2 AuthConfig resources ``jwt-{i}`` in namespace ``oidc``,
    host ``jwt-{i}.oidc``: a ``jwt`` identity on ``issuer`` and one
    ``patternMatching`` evaluator whose patterns are ``northstar``'s rule
    for config i (same seed, same draws)."""
    out = []
    for i, pats in enumerate(_draw_rules(n, rules, seed)):
        items = [{"selector": sel, "operator": op.value, "value": val}
                 for sel, op, val in pats]
        out.append({
            "apiVersion": "authorino.kuadrant.io/v1beta2",
            "kind": "AuthConfig",
            "metadata": {"name": f"jwt-{i}", "namespace": NAMESPACE},
            "spec": {
                "hosts": [host_of(i)],
                "authentication": {"keycloak": {"jwt": {"issuerUrl": issuer}}},
                "authorization": {
                    "rules": {"patternMatching": {"patterns": [
                        items[0], {"any": items[1:]}]}}},
            },
        })
    return out


FULL_HOST = f"full.{NAMESPACE}"
INTROSPECTION_HOST = f"introspect.{NAMESPACE}"
INTROSPECTION_CACHED_HOST = f"introspect-cached.{NAMESPACE}"


def full_auth_config(issuer: str) -> dict:
    """One AuthConfig on host ``full.oidc`` that uses every other kind of
    this family: a ``jwt`` identity, ``userInfo``, ``http`` (a shared
    secret in a custom header, a templated query and header) and ``uma``
    metadata, a pattern over ``auth.metadata.*`` and the identity's realm
    roles, a ``wristband`` header and an ``http`` callback."""
    return {
        "apiVersion": "authorino.kuadrant.io/v1beta2",
        "kind": "AuthConfig",
        "metadata": {"name": "full", "namespace": NAMESPACE},
        "spec": {
            "hosts": [FULL_HOST],
            "authentication": {"keycloak": {"jwt": {"issuerUrl": issuer}}},
            "metadata": {
                "userinfo": {"userInfo": {"identitySource": "keycloak"}},
                "echo": {"http": {
                    "url": issuer + "/echo?org={auth.identity.org}",
                    "sharedSecretRef": {"name": "echo-secret",
                                        "key": "token"},
                    "credentials": {"customHeader": {"name": "x-echo-secret"}},
                    "headers": {"x-tenant": {"selector": "auth.identity.org"}}}},
                "resources": {"uma": {"endpoint": issuer, "credentialsRef": {
                    "name": "uma-credentials"}}},
            },
            "authorization": {"rules": {"patternMatching": {"patterns": [
                {"selector": "auth.metadata.userinfo.email_verified",
                 "operator": "eq", "value": "true"},
                {"selector": "auth.metadata.echo.query.org", "operator": "eq",
                 "value": "org-7"},
                {"selector": "auth.metadata.resources.0.name",
                 "operator": "eq", "value": "pets"},
                {"selector": "auth.identity.realm_access.roles",
                 "operator": "incl", "value": "admin"}]}}},
            "response": {"success": {"headers": {"x-wristband": {
                "wristband": {
                    "issuer": WRISTBAND_ISSUER,
                    "customClaims": {"org": {"selector": "auth.identity.org"}},
                    "tokenDuration": 300,
                    "signingKeyRefs": [{"name": "wristband-key",
                                        "algorithm": "ES256"}]}}}}},
            "callbacks": {"notify": {"http": {
                "url": issuer + "/callback", "method": "POST",
                "contentType": "application/x-www-form-urlencoded",
                "bodyParameters": {"sub": {"selector": "auth.identity.sub"}}}}},
        },
    }


def introspection_auth_config(issuer: str,
                              cache_ttl: Optional[int] = None) -> dict:
    """One AuthConfig on host ``introspect.oidc`` that authenticates
    opaque tokens by RFC 7662 introspection and allows GETs.  With
    ``cache_ttl``, ``introspect-cached`` on host ``introspect-cached.oidc``
    keeps each introspection that long, keyed by the Authorization header
    (the user's own opt-in: a revoked token passes until it lapses)."""
    opaque: Dict[str, Any] = {"oauth2Introspection": {
        "endpoint": issuer + _OIDC + "/token/introspect",
        "credentialsRef": {"name": "introspection-credentials"}}}
    name, host = "introspect", INTROSPECTION_HOST
    if cache_ttl is not None:
        opaque["cache"] = {"key": {"selector": "request.headers.authorization"},
                           "ttl": cache_ttl}
        name, host = "introspect-cached", INTROSPECTION_CACHED_HOST
    return {
        "apiVersion": "authorino.kuadrant.io/v1beta2",
        "kind": "AuthConfig",
        "metadata": {"name": name, "namespace": NAMESPACE},
        "spec": {
            "hosts": [host],
            "authentication": {"opaque": opaque},
            "authorization": {"rules": {"patternMatching": {"patterns": [
                {"selector": "request.method", "operator": "eq",
                 "value": "GET"}]}}},
        },
    }


def cluster_secrets(keys: Keys) -> List[dict]:
    """The Secrets the full and introspection configs read, as plain
    fields of a Secret."""
    creds = {"clientID": CLIENT_ID.encode(),
             "clientSecret": CLIENT_SECRET.encode()}
    return [
        {"name": "echo-secret", "namespace": NAMESPACE,
         "data": {"token": ECHO_SECRET.encode()}},
        {"name": "uma-credentials", "namespace": NAMESPACE, "data": creds},
        {"name": "introspection-credentials", "namespace": NAMESPACE,
         "data": creds},
        {"name": "wristband-key", "namespace": NAMESPACE,
         "data": {"key.pem": pki.private_key_to_pem(keys.wristband)}},
    ]


# ---------------------------------------------------------------------------
# Check() requests
# ---------------------------------------------------------------------------

def build_check_requests(idp: FakeKeycloak, n: int, n_configs: int,
                         n_tokens: int = 1024, seed: int = 7
                         ) -> Tuple[List[CheckRequestModel],
                                    List[Optional[str]],
                                    List[Dict[str, Any]]]:
    """``n`` Check() requests: request k carries the method, path and
    headers of ``build_docs(n_tokens, seed)[k % n_tokens]`` and an RS256
    bearer token over its identity claims (``n_tokens`` distinct tokens),
    and goes to the host of a config drawn uniformly from ``n_configs``.
    One request in each block of 32 carries a bad token instead, of the
    kinds of ``BAD_TOKENS`` in turns; its place in the block moves by one
    on each pass over the tokens, so every token is also sent good.
    Returns the requests, each one's bad kind (None for a good token) and
    each one's token claims."""
    docs = build_docs(n_tokens, seed=seed)
    claims = [dict(d["auth"]["identity"], sub=f"user-{j}")
              for j, d in enumerate(docs)]
    tokens = [idp.token(c) for c in claims]
    pick = random.Random(seed + 1)
    requests, kinds, used = [], [], []
    for k in range(n):
        j = k % n_tokens
        bad = k % 32 == 31 - (k // n_tokens) % 32
        kind = BAD_TOKENS[(k // 32) % len(BAD_TOKENS)] if bad else None
        token = tokens[j] if kind is None else idp.bad_token(kind, claims[j])
        req = docs[j]["request"]
        requests.append(CheckRequestModel(http=HttpRequestAttributes(
            method=req["method"], path=req["url_path"],
            host=host_of(pick.randrange(n_configs)),
            headers=dict(req["headers"], authorization=f"Bearer {token}"))))
        kinds.append(kind)
        used.append(jose.decode_unverified(token)[1])
    return requests, kinds, used
