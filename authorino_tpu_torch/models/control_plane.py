"""The control-plane workload: AuthConfig and Secret manifests as a
deployment keeps them, the X.509 material of an mTLS deployment, and
loopback servers standing in for the Kubernetes API and an OPA policy
registry.

- ``make_certificate`` writes a DER X.509 v3 certificate signed by a
  ``utils/pki.py`` key (RSA PKCS#1 v1.5 or ECDSA, SHA-1/224/256/384/512),
  with an optional SubjectAlternativeName and CA basic constraints;
  ``CertAuthority`` makes a self-signed CA and issues client
  certificates.  Names are RDN lists of (OID, value[, string tag]).
- ``build_auth_configs``: ``northstar``'s rules (same seed, same draws) as
  AuthConfigs ``key-{i}`` on host ``key-{i}.keys``, even ``i`` as v1beta2
  and odd ``i`` as v1beta1, each with an ``apiKey`` identity that selects
  its own labeled Secret (``api_key_secret``) and takes the claims Envoy's
  jwt_authn filter verified as ``overrides``, so the rule reads
  ``auth.identity.{org,roles,groups}``.
- ``mtls_auth_config``: an ``x509`` identity trusting the CA Secrets of a
  label, with a pattern on the certificate's subject;
  ``opa_external_auth_config``: an ``opa.externalPolicy`` with a TTL.
- ``config_rules`` and ``expected_code``: the oracle of a request to
  ``build_auth_configs``' corpus (the config's rule over the
  authorization JSON the identity yields); ``GenerationLog`` records the
  snapshot generation each Check()'s batch was cut against.
- ``PolicyRegistry``: a loopback OPA registry whose policy a caller may
  change; it counts the downloads.
- ``FakeApiServer``: a loopback Kubernetes API server (``http.server``):
  AuthConfig and Secret lists with ``labelSelector`` and a list
  resourceVersion, Secret get, chunked watch streams resuming from a
  resourceVersion (410 Gone below the compaction point, and a scripted
  410 or dropped connection), Leases with resourceVersion
  compare-and-swap, merge-patched AuthConfig status (recorded with the
  writer's bearer token; a status write emits no watch event, and an
  update of the object keeps its status), token and subject-access
  reviews.  Every request is recorded.
"""

from __future__ import annotations

import base64
import copy
import datetime
import json
import random
import socket
import threading
import time
import urllib.parse
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..authjson.value import JSONValue
from ..authjson.wellknown import (CheckRequestModel, HttpRequestAttributes,
                                  build_authorization_json)
from ..expressions import All, Any_, Pattern
from ..k8s.client import LabelSelector, Secret
from ..utils import rpc
from ..utils import pki
from ..utils.pki import _SEQ, _der_int, _oid_der, _tlv
from .northstar import JWT_CLAIMS_SELECTOR, JWT_FILTER, _draw_rules, build_docs

__all__ = ["OID", "make_certificate", "pem", "CertAuthority",
           "NAMESPACE", "host_of", "api_key_of", "api_key_secret",
           "ca_secret", "build_auth_configs", "mtls_auth_config",
           "opa_external_auth_config", "build_check_requests",
           "PolicyRegistry", "FakeApiServer", "MTLS_HOST", "OPA_HOST",
           "CA_LABEL", "CLAIMS", "config_rules", "expected_code",
           "GenerationLog", "SlowEndpoint", "callback_auth_config",
           "CALLBACK_HOST", "TOKENREVIEW_HOST", "TOKENREVIEW_AUDIENCE",
           "tokenreview_auth_config"]

NAMESPACE = "keys"
MTLS_HOST = "mtls-{k}.keys"
OPA_HOST = "opa-external.keys"
CA_LABEL = {"authorino.kuadrant.io/ca": "clients"}
TOKENREVIEW_HOST = "tokenreview.keys"
TOKENREVIEW_AUDIENCE = "talker-api"
# the jwt_authn claims an API-key identity takes as overrides
CLAIMS = JWT_CLAIMS_SELECTOR

# name-attribute OIDs
OID = {"CN": "2.5.4.3", "O": "2.5.4.10", "OU": "2.5.4.11", "C": "2.5.4.6",
       "L": "2.5.4.7", "ST": "2.5.4.8", "SERIAL": "2.5.4.5",
       "STREET": "2.5.4.9", "POSTAL": "2.5.4.17",
       "EMAIL": "1.2.840.113549.1.9.1", "DC": "0.9.2342.19200300.100.1.25",
       "UID": "0.9.2342.19200300.100.1.1", "GIVEN": "2.5.4.42",
       "SURNAME": "2.5.4.4", "TITLE": "2.5.4.12"}
UTF8, PRINTABLE, IA5 = 0x0C, 0x13, 0x16

_RSA_SIG = {"1": "1.2.840.113549.1.1.5", "224": "1.2.840.113549.1.1.14",
            "256": "1.2.840.113549.1.1.11", "384": "1.2.840.113549.1.1.12",
            "512": "1.2.840.113549.1.1.13"}
_EC_SIG = {"1": "1.2.840.10045.4.1", "224": "1.2.840.10045.4.3.1",
           "256": "1.2.840.10045.4.3.2", "384": "1.2.840.10045.4.3.3",
           "512": "1.2.840.10045.4.3.4"}


# ---------------------------------------------------------------------------
# certificates
# ---------------------------------------------------------------------------

def _name_der(rdns: Sequence[Sequence[tuple]]) -> bytes:
    """A Name from RDNs of (OID, value) or (OID, value, string tag); a
    SET's members sorted by encoding, as DER wants."""
    out = b""
    for rdn in rdns:
        atvs = []
        for attr in rdn:
            oid, value = attr[0], attr[1]
            tag = attr[2] if len(attr) > 2 else UTF8
            atvs.append(_tlv(_SEQ, _oid_der(oid) + _tlv(tag, value.encode())))
        out += _tlv(0x31, b"".join(sorted(atvs)))
    return _tlv(_SEQ, out)


def _time_der(t: datetime.datetime) -> bytes:
    t = t.astimezone(datetime.timezone.utc)
    if 1950 <= t.year < 2050:
        return _tlv(0x17, t.strftime("%y%m%d%H%M%SZ").encode())
    return _tlv(0x18, t.strftime("%Y%m%d%H%M%SZ").encode())


def _spki(key) -> bytes:
    if isinstance(key, pki.RSAPublicKey):
        alg = _tlv(_SEQ, _oid_der(pki._RSA_OID) + b"\x05\x00")
        bits = _tlv(_SEQ, _der_int(key.n) + _der_int(key.e))
    else:
        alg = _tlv(_SEQ, _oid_der(pki._EC_OID) + _oid_der(key.curve.oid))
        size = (key.curve.key_size + 7) // 8
        bits = b"\x04" + key.x.to_bytes(size, "big") + key.y.to_bytes(size, "big")
    return _tlv(_SEQ, alg + _tlv(0x03, b"\x00" + bits))


def make_certificate(subject, issuer, public_key, signing_key,
                     not_before: datetime.datetime,
                     not_after: datetime.datetime, serial: int = 1,
                     dns_names: Optional[Sequence[str]] = None,
                     is_ca: bool = False, hash_bits: str = "256") -> bytes:
    """A DER X.509 v3 certificate of ``public_key`` signed by
    ``signing_key`` (a pki private key).  ``dns_names`` None leaves the
    SubjectAlternativeName out; ``[]`` writes one without DNS names (an
    email address instead, so the extension is not empty)."""
    if isinstance(signing_key, pki.RSAPrivateKey):
        alg = _tlv(_SEQ, _oid_der(_RSA_SIG[hash_bits]) + b"\x05\x00")
    else:
        alg = _tlv(_SEQ, _oid_der(_EC_SIG[hash_bits]))
    exts = b""
    if is_ca:
        exts += _tlv(_SEQ, _oid_der("2.5.29.19") + b"\x01\x01\xff"
                     + _tlv(0x04, _tlv(_SEQ, b"\x01\x01\xff")))
    if dns_names is not None:
        names = b"".join(_tlv(0x82, d.encode()) for d in dns_names) or \
            _tlv(0x81, b"nobody@example.com")
        exts += _tlv(_SEQ, _oid_der("2.5.29.17")
                     + _tlv(0x04, _tlv(_SEQ, names)))
    tbs = _tlv(_SEQ, b"".join([
        _tlv(0xA0, _der_int(2)), _der_int(serial), alg, _name_der(issuer),
        _tlv(_SEQ, _time_der(not_before) + _time_der(not_after)),
        _name_der(subject), _spki(public_key),
        _tlv(0xA3, _tlv(_SEQ, exts)) if exts else b""]))
    if isinstance(signing_key, pki.RSAPrivateKey):
        sig = signing_key.sign(tbs, "PKCS1v15", hash_bits)
    else:
        r, s = signing_key.sign(tbs, hash_bits)
        sig = _tlv(_SEQ, _der_int(r) + _der_int(s))
    return _tlv(_SEQ, tbs + alg + _tlv(0x03, b"\x00" + sig))


def pem(der: bytes) -> bytes:
    return pki._pem("CERTIFICATE", der)


class CertAuthority:
    """A self-signed CA (valid from a day ago for ten years) issuing
    client certificates."""

    def __init__(self, key, subject, serial: int = 1, hash_bits: str = "256"):
        self.key = key
        self.subject = subject
        self.hash_bits = hash_bits
        now = datetime.datetime.now(datetime.timezone.utc)
        self.der = make_certificate(
            subject, subject, key.public_key(), key,
            now - datetime.timedelta(days=1), now + datetime.timedelta(days=3650),
            serial=serial, is_ca=True, hash_bits=hash_bits)
        self.pem = pem(self.der)
        self._serial = serial

    def issue(self, subject, key=None, dns_names=None, valid_from_days=-1.0,
              valid_days=365.0, hash_bits: Optional[str] = None) -> bytes:
        """The PEM of a client certificate for ``subject`` (its key: the
        given one or the CA's own, which is quicker to make and as good for
        a signature check), valid from ``valid_from_days`` for
        ``valid_days``."""
        self._serial += 1
        now = datetime.datetime.now(datetime.timezone.utc)
        start = now + datetime.timedelta(days=valid_from_days)
        pub = (key if key is not None else self.key).public_key()
        return pem(make_certificate(
            subject, self.subject, pub, self.key, start,
            start + datetime.timedelta(days=valid_days), serial=self._serial,
            dns_names=dns_names, hash_bits=hash_bits or self.hash_bits))


# ---------------------------------------------------------------------------
# manifests
# ---------------------------------------------------------------------------

def host_of(i: int) -> str:
    return f"key-{i}.{NAMESPACE}"


def api_key_of(i: int, generation: int = 0) -> str:
    return f"key-{i}-{generation}-" + format(
        random.Random(i * 7919 + generation).getrandbits(64), "016x")


def api_key_secret(i: int, generation: int = 0) -> dict:
    """The Secret manifest of config i's API key."""
    return {
        "apiVersion": "v1", "kind": "Secret",
        "metadata": {"name": f"key-{i}-{generation}", "namespace": NAMESPACE,
                     "labels": {"authorino.kuadrant.io/managed-by": "authorino",
                                "app": f"key-{i}"}},
        "stringData": {"api_key": api_key_of(i, generation)},
    }


def ca_secret(name: str, ca_pem: bytes) -> dict:
    return {
        "apiVersion": "v1", "kind": "Secret",
        "metadata": {"name": name, "namespace": NAMESPACE,
                     "labels": {"authorino.kuadrant.io/managed-by": "authorino",
                                **CA_LABEL}},
        "data": {"ca.crt": base64.b64encode(ca_pem).decode()},
    }


def _claims_overrides() -> dict:
    return {k: {"selector": f"{CLAIMS}.{k}"} for k in ("org", "roles", "groups")}


def build_auth_configs(n: int, rules: int, seed: int = 42,
                       flip: Sequence[int] = ()) -> List[dict]:
    """AuthConfigs ``key-{i}``: even i as v1beta2, odd as v1beta1.  A
    config in ``flip`` gets its first pattern's method flipped (GET ↔
    POST): the changed rule of a reconcile."""
    out = []
    for i, pats in enumerate(_draw_rules(n, rules, seed)):
        items = [{"selector": sel, "operator": op.value, "value": val}
                 for sel, op, val in _flipped(pats, i, flip)]
        meta = {"name": f"key-{i}", "namespace": NAMESPACE}
        selector = {"matchLabels": {"app": f"key-{i}"}}
        patterns = [items[0], {"any": items[1:]}]
        if i % 2 == 0:
            out.append({
                "apiVersion": "authorino.kuadrant.io/v1beta2",
                "kind": "AuthConfig", "metadata": meta,
                "spec": {
                    "hosts": [host_of(i)],
                    "authentication": {"api-key": {
                        "apiKey": {"selector": selector},
                        "credentials": {"authorizationHeader": {"prefix": "APIKEY"}},
                        "overrides": _claims_overrides()}},
                    "authorization": {"rules": {
                        "patternMatching": {"patterns": patterns}}}}})
        else:
            out.append({
                "apiVersion": "authorino.kuadrant.io/v1beta1",
                "kind": "AuthConfig", "metadata": meta,
                "spec": {
                    "hosts": [host_of(i)],
                    "identity": [{
                        "name": "api-key",
                        "apiKey": {"selector": selector},
                        "credentials": {"in": "authorization_header",
                                        "keySelector": "APIKEY"},
                        "extendedProperties": [
                            {"name": k, "overwrite": True,
                             "valueFrom": {"authJSON": f"{CLAIMS}.{k}"}}
                            for k in ("org", "roles", "groups")]}],
                    "authorization": [{
                        "name": "rules",
                        "json": {"rules": patterns}}]}})
    return out


def mtls_auth_config(k: int) -> dict:
    """``mtls-{k}``: an x509 identity trusting the CA Secrets labeled
    ``CA_LABEL``; a client whose subject's organization is ``org-{k}`` is
    allowed."""
    return {
        "apiVersion": "authorino.kuadrant.io/v1beta2", "kind": "AuthConfig",
        "metadata": {"name": f"mtls-{k}", "namespace": NAMESPACE},
        "spec": {
            "hosts": [MTLS_HOST.format(k=k)],
            "authentication": {"mtls": {"x509": {
                "selector": {"matchLabels": dict(CA_LABEL)}}}},
            "authorization": {"org": {"patternMatching": {"patterns": [
                {"selector": "auth.identity.Organization", "operator": "eq",
                 "value": f"org-{k}"}]}}}}}


def tokenreview_auth_config(cache_ttl: int, user: str) -> dict:
    """``tokenreview``: a Kubernetes TokenReview identity with an explicit
    audience, each review kept ``cache_ttl`` seconds keyed by the
    Authorization header (the user's own opt-in); ``user`` passes."""
    return {
        "apiVersion": "authorino.kuadrant.io/v1beta2", "kind": "AuthConfig",
        "metadata": {"name": "tokenreview", "namespace": NAMESPACE},
        "spec": {
            "hosts": [TOKENREVIEW_HOST],
            "authentication": {"sa": {
                "kubernetesTokenReview": {"audiences": [TOKENREVIEW_AUDIENCE]},
                "cache": {"key": {"selector": "request.headers.authorization"},
                          "ttl": cache_ttl}}},
            "authorization": {"user": {"patternMatching": {"patterns": [
                {"selector": "auth.identity.username", "operator": "eq",
                 "value": user}]}}}}}


def opa_external_auth_config(url: str, ttl: int) -> dict:
    return {
        "apiVersion": "authorino.kuadrant.io/v1beta2", "kind": "AuthConfig",
        "metadata": {"name": "opa-external", "namespace": NAMESPACE},
        "spec": {
            "hosts": [OPA_HOST],
            "authentication": {"anon": {"anonymous": {}}},
            "authorization": {"registry": {"opa": {"externalPolicy": {
                "url": url, "ttl": ttl}}}}}}


def build_check_requests(n: int, n_configs: int, seed: int = 7,
                         unknown_every: int = 16) -> Tuple[List[CheckRequestModel], List[int], List[bool]]:
    """Check() requests to config i's host with ``build_docs``' method,
    path, headers and claims; one in ``unknown_every`` carries an API key
    no Secret holds.  Returns (requests, config of each, key known)."""
    pick = random.Random(seed + 1)
    reqs, cfgs, known = [], [], []
    for k, doc in enumerate(build_docs(n, seed=seed)):
        i = pick.randrange(n_configs)
        good = bool(unknown_every) and k % unknown_every != unknown_every - 1
        key = api_key_of(i) if good else f"unknown-{k}"
        r = doc["request"]
        reqs.append(CheckRequestModel(
            http=HttpRequestAttributes(
                method=r["method"], path=r["url_path"], host=host_of(i),
                headers=dict(r["headers"], authorization=f"APIKEY {key}")),
            metadata_context={"filter_metadata": {
                JWT_FILTER: {"verified_jwt": doc["auth"]["identity"]}}}))
        cfgs.append(i)
        known.append(good)
    return reqs, cfgs, known


def _flipped(pats, i, flip):
    if i not in flip:
        return pats
    sel, op, val = pats[0]
    return [(sel, op, {"GET": "POST", "POST": "GET"}[val])] + pats[1:]


def config_rules(n: int, rules: int, seed: int = 42, flip: Sequence[int] = ()):
    """The rule of each config of ``build_auth_configs(n, rules, seed,
    flip)`` as an expression."""
    out = []
    for i, pats in enumerate(_draw_rules(n, rules, seed)):
        leaves = [Pattern(*p) for p in _flipped(pats, i, flip)]
        out.append(All(leaves[0], Any_(*leaves[1:])))
    return out


def expected_code(req: CheckRequestModel, i: int, rules, key_known: bool,
                  generation: int = 0) -> int:
    """The oracle of a request to config i: UNAUTHENTICATED without a
    known key; else the config's rule over the authorization JSON whose
    identity is the key's Secret (of ``generation``) with the verified
    claims as overrides.  A request without the claims (one over HTTP
    /check, which carries no metadata) gets each override as its selector
    resolves over that request."""
    if not key_known:
        return rpc.UNAUTHENTICATED
    filters = req.metadata_context.get("filter_metadata") or {}
    if JWT_FILTER in filters:
        claims = filters[JWT_FILTER]["verified_jwt"]
    else:
        doc = build_authorization_json(req, {})
        claims = {k: JSONValue(pattern=f"{CLAIMS}.{k}").resolve_for(doc)
                  for k in ("org", "roles", "groups")}
    doc = api_key_secret(i, generation)
    identity = Secret(
        name=doc["metadata"]["name"], namespace=NAMESPACE,
        labels=doc["metadata"]["labels"],
        data={"api_key": api_key_of(i, generation).encode()}).to_identity_object()
    identity.update({k: claims[k] for k in ("org", "roles", "groups")})
    allowed = rules[i].matches(build_authorization_json(req, {"identity": identity}))
    return rpc.OK if allowed else rpc.PERMISSION_DENIED


class GenerationLog:
    """Records, per Check() request object, the generation of the snapshot
    its pattern verdict came from: ``engine.provider_for`` is wrapped, so
    every entry translated for ``engine`` from now on reports through it
    (the engine's own ``_check_bound`` still sees the engine's
    provider)."""

    def __init__(self, engine):
        self.by_request: Dict[int, int] = {}
        inner_for = engine.provider_for

        def provider_for(config_name: str):
            inner = inner_for(config_name)

            async def provider(pipeline, evaluator_slot: int):
                out = await inner(pipeline, evaluator_slot)
                self.by_request[id(pipeline.request)] = \
                    pipeline.eval_snapshot.generation
                return out

            provider.engine = inner.engine
            provider.config_name = inner.config_name
            return provider

        engine.provider_for = provider_for


# ---------------------------------------------------------------------------
# loopback servers
# ---------------------------------------------------------------------------

class _Loopback:
    """A ThreadingHTTPServer on 127.0.0.1:0 on a daemon thread."""

    name = "loopback"

    def __init__(self):
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.url = ""

    def _handler(self):
        raise NotImplementedError

    def start(self):
        self._server = ThreadingHTTPServer(("127.0.0.1", 0), self._handler())
        self._server.daemon_threads = True
        self.url = f"http://127.0.0.1:{self._server.server_address[1]}"
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        args=(0.05,), name=self.name,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._thread.join(timeout=10)
            self._server = self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class PolicyRegistry(_Loopback):
    """``GET /policy`` answers ``policy`` (as the OPA API's
    ``{"result": {"raw": ...}}`` when ``as_json``); a request without the
    bearer ``secret`` (when set) gets 401.  ``downloads`` counts the
    answered downloads and ``requests`` keeps (method, path, headers)."""

    name = "policy-registry"

    def __init__(self, policy: str, secret: str = "", as_json: bool = False):
        super().__init__()
        self.policy = policy
        self.secret = secret
        self.as_json = as_json
        self.downloads = 0
        self.requests: List[Tuple[str, str, Dict[str, str]]] = []

    def _handler(self):
        reg = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                reg.requests.append(("GET", self.path, dict(self.headers)))
                if reg.secret and self.headers.get("Authorization") != f"Bearer {reg.secret}":
                    body, code, ctype = b"unauthorized", 401, "text/plain"
                elif urllib.parse.urlsplit(self.path).path != "/policy":
                    body, code, ctype = b"not found", 404, "text/plain"
                else:
                    reg.downloads += 1
                    if reg.as_json:
                        body = json.dumps({"result": {"raw": reg.policy}}).encode()
                        code, ctype = 200, "application/json"
                    else:
                        body, code, ctype = reg.policy.encode(), 200, "text/plain"
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        return H


class SlowEndpoint(_Loopback):
    """Answers every GET or POST with ``{"ok": true}`` after ``delay_s``;
    ``hits`` counts the requests that arrived (a callback target that
    keeps Check()s in flight after their verdict)."""

    name = "slow-endpoint"

    def __init__(self, delay_s: float):
        super().__init__()
        self.delay_s = delay_s
        self.hits = 0
        self._lock = threading.Lock()

    def _handler(self):
        ep = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _answer(self):
                with ep._lock:
                    ep.hits += 1
                length = int(self.headers.get("Content-Length") or 0)
                if length:
                    self.rfile.read(length)
                time.sleep(ep.delay_s)
                body = b'{"ok": true}'
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            do_GET = do_POST = _answer

        return H


CALLBACK_HOST = f"callback.{NAMESPACE}"


def callback_auth_config(url: str) -> dict:
    """``callback``: anonymous, a GET is allowed, and every Check() then
    calls ``url`` (its verdict is decided before the callback runs)."""
    return {
        "apiVersion": "authorino.kuadrant.io/v1beta2", "kind": "AuthConfig",
        "metadata": {"name": "callback", "namespace": NAMESPACE},
        "spec": {
            "hosts": [CALLBACK_HOST],
            "authentication": {"anon": {"anonymous": {}}},
            "authorization": {"get": {"patternMatching": {"patterns": [
                {"selector": "request.method", "operator": "eq",
                 "value": "GET"}]}}},
            "callbacks": {"done": {"http": {"url": url}}}}}


def _merge_patch(target: Any, patch: Any) -> Any:
    """RFC 7386 JSON merge patch."""
    if not isinstance(patch, dict):
        return copy.deepcopy(patch)
    out = dict(target) if isinstance(target, dict) else {}
    for k, v in patch.items():
        if v is None:
            out.pop(k, None)
        else:
            out[k] = _merge_patch(out.get(k), v)
    return out


class FakeApiServer(_Loopback):
    """A Kubernetes API server of AuthConfigs (v1beta2), Secrets and
    Leases.  State changes through ``put``/``delete`` (each bumps the
    global resourceVersion and logs a watch event) and through the API.
    ``compact()`` makes every resourceVersion so far too old (a watch
    resuming below it gets an ERROR 410 event); ``fault(kind, what)``
    scripts the next watch event of ``kind`` ("authconfigs" or
    "secrets"): ``"gone"`` sends ERROR 410 and ends the stream, ``"drop"``
    closes the connection mid-stream.  ``requests`` records (method,
    path, query, headers, body) and ``status_writes`` (bearer token,
    namespace, name, status)."""

    name = "fake-api-server"
    AC_PREFIX = "/apis/authorino.kuadrant.io/v1beta2"
    LEASE_PREFIX = "/apis/coordination.k8s.io/v1/namespaces/"

    def __init__(self):
        super().__init__()
        self.rv = 100
        self.objects: Dict[str, Dict[Tuple[str, str], dict]] = {
            "authconfigs": {}, "secrets": {}, "leases": {}}
        self.events: Dict[str, List[Tuple[int, str, dict]]] = {
            "authconfigs": [], "secrets": []}
        self.compacted = 0
        self.faults: Dict[str, deque] = {"authconfigs": deque(), "secrets": deque()}
        self.requests: List[Tuple[str, str, Dict[str, List[str]], Dict[str, str], Any]] = []
        self.status_writes: List[Tuple[str, str, str, dict]] = []
        self.watches: Dict[str, int] = {"authconfigs": 0, "secrets": 0}
        self.token_reviews: Dict[str, dict] = {}
        self._cond = threading.Condition()
        self._stopping = False

    # --- state ---

    def _bump(self) -> str:
        self.rv += 1
        return str(self.rv)

    def put(self, kind: str, obj: dict) -> dict:
        """Create or replace an AuthConfig or Secret (a Secret's
        ``stringData`` is folded into base64 ``data``)."""
        obj = copy.deepcopy(obj)
        if kind == "secrets" and obj.get("stringData"):
            data = obj.setdefault("data", {})
            for k, v in obj.pop("stringData").items():
                data[k] = base64.b64encode(v.encode()).decode()
        meta = obj.setdefault("metadata", {})
        key = (meta.get("namespace", "default"), meta.get("name", ""))
        with self._cond:
            existed = key in self.objects[kind]
            if existed and "status" in self.objects[kind][key] \
                    and "status" not in obj:
                # the status subresource outlives an update of the object
                obj["status"] = self.objects[kind][key]["status"]
            meta["resourceVersion"] = self._bump()
            self.objects[kind][key] = obj
            self.events[kind].append((self.rv, "MODIFIED" if existed else "ADDED",
                                      copy.deepcopy(obj)))
            self._cond.notify_all()
        return obj

    def delete(self, kind: str, namespace: str, name: str) -> None:
        with self._cond:
            obj = self.objects[kind].pop((namespace, name), None)
            if obj is None:
                return
            obj = copy.deepcopy(obj)
            obj["metadata"]["resourceVersion"] = self._bump()
            self.events[kind].append((self.rv, "DELETED", obj))
            self._cond.notify_all()

    def compact(self) -> None:
        with self._cond:
            self.compacted = self.rv
            self._cond.notify_all()

    def fault(self, kind: str, what: str) -> None:
        with self._cond:
            self.faults[kind].append(what)
            self._cond.notify_all()

    def stop(self) -> None:
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        super().stop()

    # --- the API ---

    def _handler(self):
        api = self

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _body(self):
                n = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(n) if n else b""
                return json.loads(raw) if raw else None

            def _send(self, code: int, obj: Any) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _status(self, code: int, reason: str) -> None:
                self._send(code, {"kind": "Status", "apiVersion": "v1",
                                  "status": "Failure", "reason": reason,
                                  "code": code})

            def _handle(self, method: str) -> None:
                parts = urllib.parse.urlsplit(self.path)
                query = urllib.parse.parse_qs(parts.query)
                body = self._body() if method in ("PUT", "POST", "PATCH") else None
                api.requests.append((method, parts.path, query,
                                     dict(self.headers), body))
                try:
                    api._route(self, method, parts.path,
                               {k: v[-1] for k, v in query.items()}, body)
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def do_GET(self):
                self._handle("GET")

            def do_PUT(self):
                self._handle("PUT")

            def do_POST(self):
                self._handle("POST")

            def do_PATCH(self):
                self._handle("PATCH")

        return H

    def _route(self, h, method: str, path: str, q: Dict[str, str], body) -> None:
        seg = [s for s in path.split("/") if s]
        if path == f"{self.AC_PREFIX}/authconfigs" and method == "GET":
            return self._list_or_watch(h, "authconfigs", None, q)
        if path == "/api/v1/secrets" and method == "GET":
            return self._list_or_watch(h, "secrets", None, q)
        if seg[:3] == ["api", "v1", "namespaces"] and len(seg) >= 5 \
                and seg[4] == "secrets" and method == "GET":
            if len(seg) == 5:
                return self._list_or_watch(h, "secrets", seg[3], q)
            obj = self.objects["secrets"].get((seg[3], seg[5]))
            return h._send(200, obj) if obj else h._status(404, "NotFound")
        if path.startswith(self.AC_PREFIX + "/namespaces/") and \
                path.endswith("/status") and method == "PATCH":
            ns, name = seg[4], seg[6]
            with self._cond:
                obj = self.objects["authconfigs"].get((ns, name))
                if obj is None:
                    return h._status(404, "NotFound")
                merged = _merge_patch(obj, body or {})
                obj["status"] = merged.get("status")
                token = h.headers.get("Authorization", "")
                self.status_writes.append((token, ns, name, obj["status"]))
            return h._send(200, obj)
        if path.startswith(self.LEASE_PREFIX):
            return self._lease(h, method, seg, body)
        if path == "/apis/authentication.k8s.io/v1/tokenreviews" and method == "POST":
            token = ((body or {}).get("spec") or {}).get("token", "")
            review = self.token_reviews.get(token) or {
                "status": {"authenticated": False}}
            return h._send(201, dict(body, **review))
        if path == "/apis/authorization.k8s.io/v1/subjectaccessreviews" and method == "POST":
            user = ((body or {}).get("spec") or {}).get("user", "")
            return h._send(201, dict(body, status={"allowed": user == "admin"}))
        return h._status(404, "NotFound")

    def _lease(self, h, method: str, seg: List[str], body) -> None:
        ns = seg[4]
        name = seg[6] if len(seg) > 6 else (body or {}).get("metadata", {}).get("name", "")
        key = (ns, name)
        with self._cond:
            cur = self.objects["leases"].get(key)
            if method == "GET":
                return h._send(200, cur) if cur else h._status(404, "NotFound")
            if method == "POST":
                if cur is not None:
                    return h._status(409, "AlreadyExists")
            elif method == "PUT":
                if cur is None:
                    return h._status(404, "NotFound")
                want = (body.get("metadata") or {}).get("resourceVersion")
                if want and want != cur["metadata"]["resourceVersion"]:
                    return h._status(409, "Conflict")
            else:
                return h._status(405, "MethodNotAllowed")
            obj = copy.deepcopy(body)
            obj["metadata"]["resourceVersion"] = self._bump()
            self.objects["leases"][key] = obj
        return h._send(201 if method == "POST" else 200, obj)

    @staticmethod
    def _selected(obj: dict, sel: Optional[LabelSelector]) -> bool:
        return sel is None or sel.matches(
            (obj.get("metadata") or {}).get("labels") or {})

    def _list_or_watch(self, h, kind: str, ns: Optional[str], q) -> None:
        sel = LabelSelector.parse(q["labelSelector"]) if q.get("labelSelector") else None
        if q.get("watch") == "true":
            return self._watch(h, kind, sel, q)
        with self._cond:
            items = [copy.deepcopy(o) for (ons, _), o in self.objects[kind].items()
                     if (ns is None or ons == ns) and self._selected(o, sel)]
            rv = str(self.rv)
        h._send(200, {"kind": "List", "metadata": {"resourceVersion": rv},
                      "items": items})

    def _watch(self, h, kind: str, sel, q) -> None:
        self.watches[kind] += 1
        since = int(q.get("resourceVersion") or self.rv)
        deadline = time.monotonic() + float(q.get("timeoutSeconds") or 300)
        h.send_response(200)
        h.send_header("Content-Type", "application/json")
        h.send_header("Transfer-Encoding", "chunked")
        h.end_headers()

        def line(obj) -> None:
            data = json.dumps(obj).encode() + b"\n"
            h.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
            h.wfile.flush()

        def end() -> None:
            h.wfile.write(b"0\r\n\r\n")
            h.wfile.flush()

        gone = {"type": "ERROR", "object": {
            "kind": "Status", "apiVersion": "v1", "status": "Failure",
            "reason": "Expired", "code": 410,
            "message": "too old resource version"}}
        if since < self.compacted:
            line(gone)
            return end()
        while True:
            with self._cond:
                while True:
                    fresh = [e for e in self.events[kind] if e[0] > since]
                    left = deadline - time.monotonic()
                    if fresh or self.faults[kind] or self._stopping or left <= 0:
                        break
                    self._cond.wait(min(left, 0.5))
                fault = self.faults[kind].popleft() if self.faults[kind] else None
            if self._stopping or (not fresh and fault is None):
                return end()
            for rv, etype, obj in fresh:
                since = rv
                if self._selected(obj, sel):
                    line({"type": etype, "object": obj})
            if fault == "gone":
                line(gone)
                return end()
            if fault == "drop":
                h.close_connection = True
                try:
                    h.connection.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                return
