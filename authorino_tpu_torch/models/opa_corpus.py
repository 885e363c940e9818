"""The OPA workload: AuthConfigs that authorize with inline Rego beside a
pattern, and the Check() requests that exercise them.

The deployment is the one of Authorino's user guides "OPA authorization"
and "Kubernetes TokenReview / SubjectAccessReview", behind Envoy's
``jwt_authn`` filter as in ``northstar``: each AuthConfig takes Envoy's
verified claims as a ``plain`` identity, denies one tenant by a
``patternMatching`` evaluator, and authorizes the request with an inline
Rego policy of two or three OR-ed ``allow`` bodies.  The bodies mix
``==``/``!=`` on the method, ``startswith`` on the path, ``regex.match``
on an ``x-tier`` header and a numeric compare on the request's size, so
the lowered verdict reads the regex-DFA and the int32 numeric lanes of the
mega-kernel.  About one config in ten carries a procedural policy that
does not lower (``count(...)``, a ``data.*`` reference): it stays on the
interpreter.  The Rego evaluator runs at priority 1, after the pattern, so
a request the pattern denies is denied with the pattern's provenance.

``k8s_auth_config`` is one AuthConfig with a Kubernetes TokenReview
identity and a SubjectAccessReview authorization; ``k8s_cluster_data``
the token and access reviews its cluster answers.

Everything is plain data (v1beta2 dicts, request fields) made from a seed,
so any translate can take it.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Tuple

from ..authjson.wellknown import CheckRequestModel, HttpRequestAttributes
from .northstar import JWT_CLAIMS_SELECTOR, JWT_FILTER

__all__ = ["NAMESPACE", "host_of", "build_auth_configs",
           "build_check_requests", "K8S_HOST", "k8s_auth_config",
           "k8s_cluster_data", "k8s_access_review", "k8s_check_requests"]

NAMESPACE = "opa"
METHODS = ("GET", "POST", "PUT", "DELETE")
PATHS = ("/api/v1/pets", "/api/v2/orders", "/admin/users", "/public/a",
         "/static/x.css", "/")
TIERS = ("t-1", "t-22", "gold", "silver", "", None)  # None: no header
TENANTS = 8


def host_of(i: int) -> str:
    return f"opa-{i}.{NAMESPACE}"


def _atom(rng: random.Random) -> str:
    """One lowerable body expression."""
    kind = rng.randrange(6)
    if kind == 0:
        return f'input.request.method == "{rng.choice(METHODS)}"'
    if kind == 1:
        return f'input.request.method != "{rng.choice(METHODS)}"'
    if kind == 2:
        prefix = rng.choice(("/api/", "/admin", "/public/", "/static/"))
        return f'startswith(input.request.path, "{prefix}")'
    if kind == 3:
        rx = rng.choice(("^t-[0-9]+$", "^(gold|silver)$", "^t-[0-9]$"))
        return f'regex.match("{rx}", input.request.headers["x-tier"])'
    op = rng.choice(("<", "<=", ">", ">="))
    return f"input.request.size {op} {rng.choice((256, 1024, 4096))}"


def _procedural(rng: random.Random) -> Tuple[str, Any]:
    """A policy outside the lowerable subset, and its data document."""
    if rng.random() < 0.5:
        return ('allow { count(input.request.headers) > 1; '
                f'{_atom(rng)} }}\n'
                f'allow {{ {_atom(rng)}; {_atom(rng)} }}', None)
    methods = rng.sample(METHODS, 2)
    return ('allow { input.request.method == data.methods[_] }\n'
            f'allow {{ {_atom(rng)}; {_atom(rng)} }}', {"methods": methods})


def _rego(rng: random.Random) -> str:
    bodies = []
    for _ in range(rng.choice((2, 3))):
        atoms = [_atom(rng) for _ in range(rng.choice((1, 2, 2, 3)))]
        bodies.append("allow { " + "; ".join(atoms) + " }")
    return "\n".join(bodies)


def build_auth_configs(n: int, seed: int = 11) -> List[dict]:
    """v1beta2 AuthConfig resources ``opa-{i}`` in namespace ``opa``, host
    ``opa-{i}.opa``: a ``plain`` identity over Envoy's jwt_authn claims,
    a ``patternMatching`` evaluator denying one tenant, and an inline
    Rego evaluator at priority 1 (every tenth one, on average,
    procedural)."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        opa: Dict[str, Any]
        if rng.random() < 0.1:
            src, data = _procedural(rng)
            opa = {"rego": src} if data is None else {"rego": src,
                                                       "data": data}
        else:
            opa = {"rego": _rego(rng)}
        out.append({
            "apiVersion": "authorino.kuadrant.io/v1beta2",
            "kind": "AuthConfig",
            "metadata": {"name": f"opa-{i}", "namespace": NAMESPACE},
            "spec": {
                "hosts": [host_of(i)],
                "authentication": {
                    "envoy-jwt": {"plain": {"selector": JWT_CLAIMS_SELECTOR}}},
                "authorization": {
                    "tenant": {"patternMatching": {"patterns": [
                        {"selector": "auth.identity.tenant", "operator": "neq",
                         "value": f"tenant-{rng.randrange(TENANTS)}"}]}},
                    "policy": {"opa": opa, "priority": 1},
                },
            },
        })
    return out


def build_check_requests(n: int, n_configs: int,
                         seed: int = 13) -> List[CheckRequestModel]:
    """Check() requests to hosts of configs drawn uniformly from
    ``n_configs``, with methods, paths, ``x-tier`` values (or none) and
    sizes drawn so that both verdicts of the Rego bodies occur often, and
    the tenant claim where Envoy's jwt_authn filter puts it."""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        headers = {"x-req": f"r{rng.randrange(1000)}"}
        tier = rng.choice(TIERS)
        if tier is not None:
            headers["x-tier"] = tier
        if rng.random() < 0.3:
            headers["x-extra"] = "1"
        claims = {"sub": f"user-{rng.randrange(100)}",
                  "tenant": f"tenant-{rng.randrange(TENANTS)}"}
        out.append(CheckRequestModel(
            http=HttpRequestAttributes(
                method=rng.choice(METHODS), path=rng.choice(PATHS),
                host=host_of(rng.randrange(n_configs)), headers=headers,
                size=rng.choice((0, 100, 256, 1000, 1024, 5000))),
            metadata_context={"filter_metadata": {
                JWT_FILTER: {"verified_jwt": claims}}}))
    return out


# ---- Kubernetes TokenReview + SubjectAccessReview --------------------------

K8S_HOST = "k8s-api.opa"
K8S_AUDIENCE = "talker-api"


def k8s_auth_config() -> dict:
    """A TokenReview identity (bearer token, explicit audience) and a
    SubjectAccessReview of the reviewed user on the request's resource:
    the namespace from a header, the verb from the method."""
    return {
        "apiVersion": "authorino.kuadrant.io/v1beta2",
        "kind": "AuthConfig",
        "metadata": {"name": "k8s", "namespace": NAMESPACE},
        "spec": {
            "hosts": [K8S_HOST],
            "authentication": {"sa-token": {"kubernetesTokenReview": {
                "audiences": [K8S_AUDIENCE]}}},
            "authorization": {"sar": {"kubernetesSubjectAccessReview": {
                "user": {"selector": "auth.identity.username"},
                "groups": ["developers"],
                "resourceAttributes": {
                    "namespace": {"selector": "request.headers.x-ns"},
                    "group": {"value": "apps"},
                    "resource": {"value": "deployments"},
                    "verb": {"selector": "request.method"}}}}},
        },
    }


def k8s_cluster_data() -> Tuple[Dict[str, dict], List[Tuple[str, str, str]]]:
    """(token reviews by token, the (user, namespace, verb) triples the
    cluster allows).  ``alice`` may GET in ``dev``; ``bob`` may do nothing."""
    reviews = {
        f"token-{u}": {"status": {"authenticated": True, "user": {
            "username": f"system:serviceaccount:dev:{u}",
            "groups": ["developers"]}}}
        for u in ("alice", "bob")}
    allowed = [("system:serviceaccount:dev:alice", "dev", "GET")]
    return reviews, allowed


def k8s_access_review(allowed):
    """The cluster's answer to one SubjectAccessReview spec."""
    def review(spec: dict) -> dict:
        ra = spec.get("resourceAttributes") or {}
        ok = (spec.get("user"), ra.get("namespace"), ra.get("verb")) \
            in set(allowed)
        return {"status": {"allowed": ok} if ok else {
            "allowed": False, "reason": "no RBAC rule"}}
    return review


def k8s_check_requests() -> List[Tuple[CheckRequestModel, str]]:
    """(request, expected outcome) for: a valid token allowed, a valid
    token denied, an unknown token, no token."""
    def req(token, method="GET", ns="dev"):
        headers = {"x-ns": ns}
        if token is not None:
            headers["authorization"] = f"Bearer {token}"
        return CheckRequestModel(http=HttpRequestAttributes(
            method=method, path="/apis/apps/v1/deployments", host=K8S_HOST,
            headers=headers))
    return [(req("token-alice"), "allowed"),
            (req("token-alice", method="DELETE"), "denied"),
            (req("token-bob"), "denied"),
            (req("token-nobody"), "unauthenticated"),
            (req(None), "unauthenticated")]
