"""The wire corpus of the reference's native-frontend benchmark
(``bench.py::build_wire_entries``/``make_wire_payload``, its
``run_native_mode``): ``n`` pattern-only AuthConfigs over request headers,
anonymous identity, one host each, and Envoy ``CheckRequest`` payloads for
them drawn from a seeded ``random.Random``.  Every config's evaluator is
kernel-covered, so every request rides the native frontend's fast lane.

``hybrid_auth_configs`` pairs each config's pattern with a procedural
Rego that does not lower (``opa_corpus._procedural``) in a later
priority bucket: the mixed-evaluator AuthConfig of the native frontend's
hybrid lane, whose requests are ``wire_payloads`` to its hosts.

``build_key_entries``/``key_payloads`` add API-key AuthConfigs of the
three kinds the fast lane decides for API keys (the credential alone, a
pattern over the key's identity, that pattern with an identity-templated
denial), each with its own Secrets, and requests that carry a key of the
config, another config's key or none, each beside the code it must get.

The rules and payloads are the reference's; the entries bind each
pattern evaluator to ``engine``'s provider and attributor (the port's
``PatternMatching`` takes both), and the payloads are encoded with the
port's codec (``protos/wire.py``)."""

from __future__ import annotations

import random
from typing import List

__all__ = ["build_wire_entries", "make_wire_payload", "wire_payloads",
           "expected_allow", "build_key_entries", "key_payloads", "KEY_KINDS",
           "HYBRID_NAMESPACE", "HYBRID_HOST", "hybrid_auth_configs"]

WIRE_HOST = "svc-{}.bench"


def _rule(i: int, n_rules: int):
    from ..expressions import All, Any_, Operator, Pattern

    return All(
        Pattern("request.method", Operator.NEQ, "DELETE"),
        Any_(
            Pattern("request.headers.x-api-tier", Operator.EQ, f"tier-{i}"),
            *[Pattern(f"request.headers.x-attr-{k}", Operator.EQ,
                      f"v-{i}-{k}") for k in range(max(1, n_rules - 2))],
        ),
    )


def build_wire_entries(n_cfg: int, n_rules: int, engine) -> list:
    """``n_cfg`` EngineEntries ``ns/cfg-i`` on host ``svc-i.bench``: an
    anonymous identity and one pattern evaluator of ``n_rules`` leaves
    (method ≠ DELETE ∧ (tier ∨ attrs))."""
    from ..compiler import ConfigRules
    from ..evaluators import (AuthorizationConfig, IdentityConfig,
                              RuntimeAuthConfig)
    from ..evaluators.authorization import PatternMatching
    from ..evaluators.identity import Noop
    from ..runtime import EngineEntry

    entries = []
    for i in range(n_cfg):
        rule = _rule(i, n_rules)
        cfg_id = f"ns/cfg-{i}"
        pm = PatternMatching(rule, batched_provider=engine.provider_for(cfg_id),
                             evaluator_slot=0,
                             attributor=engine.attribution_for(cfg_id))
        runtime = RuntimeAuthConfig(
            identity=[IdentityConfig("anon", Noop())],
            authorization=[AuthorizationConfig("rules", pm)],
        )
        entries.append(EngineEntry(
            id=cfg_id, hosts=[f"svc-{i}.bench"], runtime=runtime,
            rules=ConfigRules(name=cfg_id, evaluators=[(None, rule)])))
    return entries


def make_wire_payload(i: int, n_cfg: int, rng: random.Random,
                      host_fmt: str = WIRE_HOST) -> bytes:
    """Request ``i``: a GET to ``svc-(i mod n).bench`` (or ``host_fmt``'s
    host of config i mod n) whose tier header matches its config with
    probability one half (one ``rng`` draw)."""
    from ..protos import wire

    host = host_fmt.format(i % n_cfg)
    tier = f"tier-{i % n_cfg}" if rng.random() < 0.5 else "none"
    return wire.encode_check_request(wire.CheckRequest(
        attributes=wire.AttributeContext(request=wire.Request(
            http=wire.HttpRequest(method="GET", path="/bench", host=host,
                                  headers={"host": host,
                                           "x-api-tier": tier})))))


def wire_payloads(n: int, n_cfg: int, seed: int = 5,
                  host_fmt: str = WIRE_HOST) -> List[bytes]:
    """The first ``n`` payloads of ``random.Random(seed)``."""
    rng = random.Random(seed)
    return [make_wire_payload(i, n_cfg, rng, host_fmt) for i in range(n)]


def expected_allow(payload: bytes, n_rules: int) -> bool:
    """The oracle of one payload: its config's rule over the request's
    authorization JSON (the expression oracle, no kernel)."""
    from ..authjson import build_authorization_json
    from ..protos import wire
    from ..protos.ext_authz import request_model_from_proto

    model = request_model_from_proto(wire.decode_check_request(payload))
    i = int(model.http.host.split(".")[0].split("-")[1])
    return bool(_rule(i, n_rules).matches(build_authorization_json(model, {})))


HYBRID_NAMESPACE = "hybrid"
HYBRID_HOST = "hyb-{}.bench"


def _rule_patterns(i: int, n_rules: int) -> list:
    """``_rule(i, n_rules)`` as AuthConfig ``patternMatching`` patterns."""
    return [
        {"selector": "request.method", "operator": "neq", "value": "DELETE"},
        {"any": [{"selector": "request.headers.x-api-tier", "operator": "eq",
                  "value": f"tier-{i}"}]
         + [{"selector": f"request.headers.x-attr-{k}", "operator": "eq",
             "value": f"v-{i}-{k}"} for k in range(max(1, n_rules - 2))]},
    ]


def hybrid_auth_configs(n_cfg: int, n_rules: int, seed: int = 11) -> list:
    """v1beta2 AuthConfigs ``hyb-{i}`` in namespace ``hybrid`` on host
    ``hyb-{i}.bench``: an anonymous identity, config i's wire rule as a
    ``patternMatching`` evaluator (the kernel's part) and, at priority 1,
    an inline Rego policy that does not lower (``opa_corpus._procedural``:
    ``count(...)`` or a ``data.*`` reference), which the pipeline runs."""
    from .opa_corpus import _procedural

    rng = random.Random(seed)
    out = []
    for i in range(n_cfg):
        src, data = _procedural(rng)
        opa = {"rego": src} if data is None else {"rego": src, "data": data}
        out.append({
            "apiVersion": "authorino.kuadrant.io/v1beta2",
            "kind": "AuthConfig",
            "metadata": {"name": f"hyb-{i}", "namespace": HYBRID_NAMESPACE},
            "spec": {
                "hosts": [HYBRID_HOST.format(i)],
                "authentication": {"anon": {"anonymous": {}}},
                "authorization": {
                    "rules": {"patternMatching": {
                        "patterns": _rule_patterns(i, n_rules)}},
                    "policy": {"opa": opa, "priority": 1},
                },
            },
        })
    return out


# API-key configs, by ``i % 3``: the key alone decides (Authorization:
# APIKEY <key>); a pattern over the key's role annotation (x-api-key
# header; admin passes); that pattern with a denial templated on the
# identity (403, the role in the message, the Secret's name in a header)
KEY_KINDS = ("key only", "role rule", "templated denial")


def _key(i: int, role: str) -> str:
    return f"{role}-{i}-{(i * 2654435761) % (1 << 32):08x}"


def build_key_entries(n_cfg: int, engine) -> list:
    """``n_cfg`` API-key EngineEntries ``ns/key-i`` on host ``key-i.bench``
    of ``KEY_KINDS[i % 3]``, each reading two Secrets of its own label
    (an admin key and a user key)."""
    from ..authjson.value import JSONProperty, JSONValue
    from ..compiler import ConfigRules
    from ..evaluators import (AuthorizationConfig, DenyWith, DenyWithValues,
                              IdentityConfig, RuntimeAuthConfig)
    from ..evaluators.authorization import PatternMatching
    from ..evaluators.credentials import AuthCredentials
    from ..evaluators.identity import APIKey
    from ..expressions import Operator, Pattern
    from ..k8s.client import LabelSelector, Secret
    from ..runtime import EngineEntry

    role_rule = Pattern("auth.identity.metadata.annotations.role",
                        Operator.EQ, "admin")
    entries = []
    for i in range(n_cfg):
        kind = i % 3
        cfg_id = f"ns/key-{i}"
        creds = (AuthCredentials(key_selector="APIKEY") if kind == 0 else
                 AuthCredentials(key_selector="x-api-key",
                                 location="custom_header"))
        ak = APIKey(f"keys-{i}", LabelSelector.from_spec(
            {"matchLabels": {"g": f"k{i}"}}), credentials=creds)
        for role in ("admin", "user"):
            ak.add_k8s_secret_based_identity(Secret(
                namespace="ns", name=f"{role}-{i}", labels={"g": f"k{i}"},
                annotations={"role": role},
                data={"api_key": _key(i, role).encode()}))
        runtime = RuntimeAuthConfig(
            labels={"namespace": "ns", "name": f"key-{i}"},
            identity=[IdentityConfig(f"keys-{i}", ak, credentials=creds)])
        rules = None
        if kind:
            runtime.authorization = [AuthorizationConfig(
                "rules", PatternMatching(
                    role_rule, batched_provider=engine.provider_for(cfg_id),
                    evaluator_slot=0,
                    attributor=engine.attribution_for(cfg_id)))]
            rules = ConfigRules(name=cfg_id, evaluators=[(None, role_rule)])
        if kind == 2:
            runtime.deny_with = DenyWith(unauthorized=DenyWithValues(
                code=403, message=JSONValue(
                    pattern="role {auth.identity.metadata.annotations.role}"
                            " may not pass"),
                headers=[JSONProperty("x-denied-user", JSONValue(
                    pattern="auth.identity.metadata.name"))]))
        entries.append(EngineEntry(id=cfg_id, hosts=[f"key-{i}.bench"],
                                   runtime=runtime, rules=rules))
    return entries


def key_payloads(n: int, n_cfg: int, seed: int = 5) -> List[tuple]:
    """``n`` (payload, expected gRPC code) pairs for ``build_key_entries``:
    request ``j`` goes to ``key-(j mod n_cfg).bench`` with its config's
    admin key (0.4), its user key (0.3), another config's admin key (0.15)
    or no key (0.15), one ``random.Random(seed)`` draw each."""
    from ..protos import wire
    from ..utils import rpc

    rng = random.Random(seed)
    out = []
    for j in range(n):
        i, r = j % n_cfg, rng.random()
        kind = i % 3
        host = f"key-{i}.bench"
        if r < 0.4:
            key, code = _key(i, "admin"), rpc.OK
        elif r < 0.7:
            key, code = _key(i, "user"), (rpc.OK if kind == 0
                                          else rpc.PERMISSION_DENIED)
        elif r < 0.85:
            key, code = _key((i + 1) % n_cfg, "admin"), rpc.UNAUTHENTICATED
        else:
            key, code = None, rpc.UNAUTHENTICATED
        headers = {"host": host}
        if key is not None:
            if kind == 0:
                headers["authorization"] = f"APIKEY {key}"
            else:
                headers["x-api-key"] = key
        out.append((wire.encode_check_request(wire.CheckRequest(
            attributes=wire.AttributeContext(request=wire.Request(
                http=wire.HttpRequest(method="GET", path="/bench", host=host,
                                      headers=headers))))), code))
    return out
