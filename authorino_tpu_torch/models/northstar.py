"""The north-star workload: a synthetic corpus of AuthConfigs and request
documents at the size the system serves (1k AuthConfigs × 10 rules,
``members_k=16`` in the default configuration).

Each config is ``All(method eq, Any_(org eq, ~5% path regexes, ~40% role
membership, ~20% group exclusion, the rest header inequalities))`` with
config-unique constants, so global leaf dedup cannot collapse the rule axis.
The same generators (same seeds, same draws) as the JAX package's bench.
"""

from __future__ import annotations

import random
from typing import List

from ..compiler.compile import ConfigRules
from ..expressions import All, Any_, Operator, Pattern

__all__ = ["build_corpus", "build_docs"]


def build_corpus(n_configs: int, rules_per_config: int,
                 seed: int = 42) -> List[ConfigRules]:
    rng = random.Random(seed)
    configs = []
    for i in range(n_configs):
        pats = []
        pats.append(Pattern("request.method", Operator.EQ, rng.choice(["GET", "POST"])))
        pats.append(Pattern("auth.identity.org", Operator.EQ, f"org-{i}"))
        for j in range(rules_per_config - 3):
            kind = rng.random()
            if kind < 0.05:
                pats.append(Pattern("request.url_path", Operator.MATCHES, rf"^/api/v\d+/r{j}"))
            elif kind < 0.45:
                pats.append(Pattern("auth.identity.roles", Operator.INCL, f"role-{i}-{rng.randrange(50)}"))
            elif kind < 0.65:
                pats.append(Pattern("auth.identity.groups", Operator.EXCL, f"banned-{i}-{rng.randrange(20)}"))
            else:
                pats.append(Pattern(f"request.headers.x-attr-{rng.randrange(8)}", Operator.NEQ, f"v-{i}-{rng.randrange(9)}"))
        rule = All(pats[0], Any_(*pats[1:]))
        configs.append(ConfigRules(name=f"cfg-{i}", evaluators=[(None, rule)]))
    return configs


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
