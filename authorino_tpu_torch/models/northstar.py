"""The north-star workload: a synthetic corpus of AuthConfigs and request
documents at the size the system serves (1k AuthConfigs × 10 rules,
``members_k=16`` in the default configuration).

Each config is ``All(method eq, Any_(org eq, ~5% path regexes, ~40% role
membership, ~20% group exclusion, the rest header inequalities))`` with
config-unique constants, so global leaf dedup cannot collapse the rule axis.
The same generators (same seeds, same draws) as the JAX package's bench.

``build_auth_configs`` states the same rules as v1beta2 AuthConfig resources
for the request path, and ``build_check_requests`` the same documents as
Check() requests.  The deployment is Authorino behind Envoy's ``jwt_authn``
filter (Authorino's documentation, "Envoy JWT Authn and Authorino"): Envoy
verifies the JWT and passes its claims in the request's metadata, and each
AuthConfig takes them as its identity through a ``plain`` identity.
"""

from __future__ import annotations

import random
from typing import List, Tuple

from ..authjson.wellknown import CheckRequestModel, HttpRequestAttributes
from ..compiler.compile import ConfigRules
from ..expressions import All, Any_, Operator, Pattern

__all__ = ["build_corpus", "build_docs", "build_auth_configs",
           "build_check_requests", "NAMESPACE", "JWT_FILTER",
           "JWT_CLAIMS_SELECTOR", "host_of"]

NAMESPACE = "northstar"
# where Envoy's jwt_authn filter puts the verified claims
# (payload_in_metadata: verified_jwt)
JWT_FILTER = "envoy.filters.http.jwt_authn"
JWT_CLAIMS_SELECTOR = (r"context.metadata_context.filter_metadata."
                       r"envoy\.filters\.http\.jwt_authn|verified_jwt")


def host_of(i: int) -> str:
    return f"svc-{i}.{NAMESPACE}"


def _draw_rules(n_configs: int, rules_per_config: int, seed: int
                ) -> List[List[Tuple[str, Operator, str]]]:
    """Each config's (selector, operator, value) triples: the first is the
    method, the rest the Any_ branch."""
    rng = random.Random(seed)
    configs = []
    for i in range(n_configs):
        pats = []
        pats.append(("request.method", Operator.EQ, rng.choice(["GET", "POST"])))
        pats.append(("auth.identity.org", Operator.EQ, f"org-{i}"))
        for j in range(rules_per_config - 3):
            kind = rng.random()
            if kind < 0.05:
                pats.append(("request.url_path", Operator.MATCHES, rf"^/api/v\d+/r{j}"))
            elif kind < 0.45:
                pats.append(("auth.identity.roles", Operator.INCL, f"role-{i}-{rng.randrange(50)}"))
            elif kind < 0.65:
                pats.append(("auth.identity.groups", Operator.EXCL, f"banned-{i}-{rng.randrange(20)}"))
            else:
                pats.append((f"request.headers.x-attr-{rng.randrange(8)}", Operator.NEQ, f"v-{i}-{rng.randrange(9)}"))
        configs.append(pats)
    return configs


def build_corpus(n_configs: int, rules_per_config: int,
                 seed: int = 42) -> List[ConfigRules]:
    configs = []
    for i, pats in enumerate(_draw_rules(n_configs, rules_per_config, seed)):
        leaves = [Pattern(*p) for p in pats]
        rule = All(leaves[0], Any_(*leaves[1:]))
        configs.append(ConfigRules(name=f"cfg-{i}", evaluators=[(None, rule)]))
    return configs


def build_auth_configs(n: int, rules: int, seed: int = 42) -> List[dict]:
    """v1beta2 AuthConfig resources ``cfg-{i}`` in namespace ``northstar``,
    host ``svc-{i}.northstar``: a ``plain`` identity reading the claims
    Envoy's jwt_authn filter verified, and one ``patternMatching``
    evaluator whose patterns are ``build_corpus``'s rule for config i
    (same seed, same draws)."""
    out = []
    for i, pats in enumerate(_draw_rules(n, rules, seed)):
        items = [{"selector": sel, "operator": op.value, "value": val}
                 for sel, op, val in pats]
        out.append({
            "apiVersion": "authorino.kuadrant.io/v1beta2",
            "kind": "AuthConfig",
            "metadata": {"name": f"cfg-{i}", "namespace": NAMESPACE},
            "spec": {
                "hosts": [host_of(i)],
                "authentication": {
                    "envoy-jwt": {"plain": {"selector": JWT_CLAIMS_SELECTOR}}},
                "authorization": {
                    "rules": {"patternMatching": {"patterns": [
                        items[0], {"any": items[1:]}]}}},
            },
        })
    return out


def build_docs(n_docs: int, seed: int = 7,
               cohort_entropy: bool = False) -> List[dict]:
    """``cohort_entropy`` appends a URL fragment that spreads request
    identity over ~4096 keys; path regexes are prefix-anchored, so regex
    truth is unchanged."""
    rng = random.Random(seed)
    docs = []
    for _ in range(n_docs):
        frag = f"#c{rng.randrange(4096)}" if cohort_entropy else ""
        docs.append(
            {
                "request": {
                    "method": rng.choice(["GET", "POST", "DELETE"]),
                    "url_path": rng.choice(["/api/v1/r0", "/api/v2/r1", "/x"]) + frag,
                    "headers": {f"x-attr-{k}": f"v{rng.randrange(9)}" for k in range(4)},
                },
                "auth": {
                    "identity": {
                        "org": f"org-{rng.randrange(1000)}",
                        "roles": [f"role-{rng.randrange(1000)}-{rng.randrange(50)}" for _ in range(rng.randrange(1, 6))],
                        "groups": [f"g-{rng.randrange(30)}" for _ in range(rng.randrange(0, 4))],
                    }
                },
            }
        )
    return docs


def build_check_requests(n: int, n_configs: int,
                         seed: int = 7) -> List[CheckRequestModel]:
    """Check() requests carrying ``build_docs(n, seed)``'s method, path and
    headers, with its identity claims where Envoy's jwt_authn filter puts
    them; request k goes to the host of a config drawn uniformly from
    ``n_configs``."""
    pick = random.Random(seed + 1)
    out = []
    for doc in build_docs(n, seed=seed):
        req = doc["request"]
        out.append(CheckRequestModel(
            http=HttpRequestAttributes(
                method=req["method"], path=req["url_path"],
                host=host_of(pick.randrange(n_configs)),
                headers=dict(req["headers"])),
            metadata_context={"filter_metadata": {
                JWT_FILTER: {"verified_jwt": doc["auth"]["identity"]}}}))
    return out
