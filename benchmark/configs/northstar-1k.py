"""northstar-1k: its manifests, its requests and its plain reference.

The configuration file beside this one (``northstar-1k.json``) holds the
sizes; everything here reads them from there.  The reference answers a
request from the request's own fields and the AuthConfig rules written
out below, as Authorino's pattern-matching guide defines them: a selector
that finds nothing reads as the empty string, ``eq``/``neq`` compare
strings.
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

from harness.proto import Response
from harness.requests import Request, draw_shares, unique_draws

OK, PERMISSION_DENIED, NOT_FOUND = 0, 7, 5


def _host(cfg: dict, i: int) -> str:
    return cfg["host_format"].format(i=i)


def _patterns(cfg: dict, i: int) -> list:
    return [
        {"selector": "request.method", "operator": "neq", "value": "DELETE"},
        {"any": [{"selector": "request.headers.x-api-tier", "operator": "eq",
                  "value": f"tier-{i}"}]
         + [{"selector": f"request.headers.x-attr-{k}", "operator": "eq",
             "value": f"v-{i}-{k}"} for k in range(cfg["attr_headers"])]},
    ]


def manifests(cfg: dict, seed: int) -> Dict[str, str]:
    """{file name: text} of the watch directory: every AuthConfig as one
    JSON document of a multi-document YAML file."""
    docs = []
    for i in range(cfg["auth_configs"]):
        docs.append({
            "apiVersion": cfg["api_version"], "kind": "AuthConfig",
            "metadata": {"name": f"cfg-{i}", "namespace": cfg["namespace"],
                         "resourceVersion": "1"},
            "spec": {
                "hosts": [_host(cfg, i)],
                "authentication": {"anonymous": {"anonymous": {}}},
                "authorization": {"rules": {"patternMatching": {
                    "patterns": _patterns(cfg, i)}}},
            },
        })
    return {"authconfigs.yaml": "---\n".join(json.dumps(d) + "\n"
                                             for d in docs)}


def requests(cfg: dict, mix: dict, seed: int) -> List[Request]:
    """``mix["distinct"]`` requests that differ in what the rules read
    (host, method, tier, the x-attr headers), drawn from ``seed``: a host
    uniform over the AuthConfigs; the method by ``mix["methods"]``; the
    tier header its config's with ``tier_match``, else another config's;
    each x-attr header present with ``attr_present``, its config's value
    with ``attr_match``, else another config's."""
    n, n_attr = cfg["auth_configs"], cfg["attr_headers"]
    methods = list(mix["methods"].items())

    def other(rng, i):
        j = rng.randrange(n - 1)
        return j + (j >= i)

    def draw(rng):
        i = rng.randrange(n)
        method = draw_shares(rng, methods)
        tier = f"tier-{i if rng.random() < mix['tier_match'] else other(rng, i)}"
        attrs = []
        for k in range(n_attr):
            if rng.random() < mix["attr_present"]:
                owner = i if rng.random() < mix["attr_match"] else other(rng, i)
                attrs.append((f"x-attr-{k}", f"v-{owner}-{k}"))
        return (i, method, tier, tuple(attrs))

    out = []
    for i, method, tier, attrs in unique_draws(draw, mix["distinct"], seed):
        host = _host(cfg, i)
        headers = {":authority": host, ":method": method,
                   ":path": f"/objects/{len(out) % 4096}",
                   "x-api-tier": tier}
        headers.update(attrs)
        out.append(Request(method, headers[":path"], host, headers))
    return out


class Reference:
    """The plain reference over the manifests' rules."""

    def __init__(self, cfg: dict, seed: int):
        self.cfg = cfg
        self.index = {_host(cfg, i): i for i in range(cfg["auth_configs"])}

    def allowed(self, i: int, req: Request) -> bool:
        h = req.headers
        if req.method == "DELETE":
            return False
        if h.get("x-api-tier", "") == f"tier-{i}":
            return True
        return any(h.get(f"x-attr-{k}", "") == f"v-{i}-{k}"
                   for k in range(self.cfg["attr_headers"]))

    def expected(self, req: Request) -> Response:
        i = self.index.get(req.host)
        if i is None:
            return Response(NOT_FOUND, kind="denied", http_status=404,
                            headers=(("x-ext-auth-reason",
                                      "Service not found"),))
        if self.allowed(i, req):
            return Response(OK, kind="ok")
        return Response(PERMISSION_DENIED, kind="denied", http_status=403,
                        headers=(("x-ext-auth-reason", "Unauthorized"),),
                        provenance=f"{self.cfg['namespace']}/cfg-{i}")

    def control(self, reqs: List[Request]) -> List[Response]:
        """The reference with one guarantee broken: a verdict kept per
        (host, method) and served to every later request of that pair,
        whatever its headers say (a cache key that leaves the headers
        out)."""
        memo: Dict[Tuple[str, str], Response] = {}
        return [memo.setdefault((r.host, r.method), self.expected(r))
                for r in reqs]

    def row_work(self, req: Request) -> Tuple[int, int, int]:
        """(bytes read, bytes written, integer operations) of one device
        row by the own-config rule: the request's values that its
        config's leaves read, once each; its config's leaves as
        (selector, operator, operand) records of 4 + 1 + len(operand)
        bytes; one verdict byte written; per leaf one comparison per 4
        bytes of the longer string, and one operation per leaf to fold
        the circuit."""
        i = self.index[req.host]
        leaves = [("request.method", req.method, "DELETE"),
                  ("x-api-tier", req.headers.get("x-api-tier", ""),
                   f"tier-{i}")]
        leaves += [(f"x-attr-{k}", req.headers.get(f"x-attr-{k}", ""),
                    f"v-{i}-{k}") for k in range(self.cfg["attr_headers"])]
        read = sum(len(v.encode()) + 5 + len(op.encode())
                   for _, v, op in leaves)
        ops = sum(-(-max(len(v), len(op)) // 4) + 1 for _, v, op in leaves)
        return read, 1, ops
