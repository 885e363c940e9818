"""apikey-1k: its manifests, its requests and its plain reference.

The configuration file beside this one (``apikey-1k.json``) holds the
sizes.  The reference follows Authorino's API-key guide: a key is valid
for an AuthConfig only if one of the Secrets its label selector picks
holds it; the identity is that Secret, so ``auth.identity.metadata.
annotations.role`` reads its role annotation; a missing credential
answers "credential not found", a key no selected Secret holds "the API
Key provided is invalid", each with a challenge naming the credential's
key selector and the identity's name as realm.
"""

from __future__ import annotations

import json
import random
from typing import Dict, List, Optional, Tuple

from harness.proto import Response
from harness.requests import Request, draw_shares, unique_draws

OK, PERMISSION_DENIED, UNAUTHENTICATED, NOT_FOUND = 0, 7, 16, 5
ROLE_SELECTOR = "auth.identity.metadata.annotations.role"


def _host(cfg: dict, i: int) -> str:
    return cfg["host_format"].format(i=i)


def _kind(i: int) -> int:
    return i % 3


def keys(cfg: dict, seed: int) -> Dict[Tuple[int, str], str]:
    """{(config, role): key}: 32 hex digits each, drawn from ``seed``."""
    rng = random.Random(f"apikey-1k keys {seed}")
    out: Dict[Tuple[int, str], str] = {}
    for i in range(cfg["auth_configs"]):
        for role in cfg["roles"]:
            out[(i, role)] = f"{rng.getrandbits(128):032x}"
    return out


def _credential(i: int) -> Tuple[str, str]:
    """(where the key travels, its key selector): kind 0 the
    Authorization header with the APIKEY prefix, the others x-api-key."""
    return ("authorization", "APIKEY") if _kind(i) == 0 else ("x-api-key",
                                                              "x-api-key")


def manifests(cfg: dict, seed: int) -> Dict[str, str]:
    """{file name: text}: the AuthConfigs and the Secrets, each a
    multi-document YAML file of JSON documents."""
    ns, label = cfg["namespace"], cfg["secret_label"]
    ks = keys(cfg, seed)
    configs, secrets = [], []
    for i in range(cfg["auth_configs"]):
        creds = ({"authorizationHeader": {"prefix": "APIKEY"}}
                 if _kind(i) == 0 else {"customHeader": {"name": "x-api-key"}})
        spec = {
            "hosts": [_host(cfg, i)],
            "authentication": {f"keys-{i}": {
                "apiKey": {"selector": {"matchLabels": {"group": f"k{i}"}}},
                "credentials": creds}},
        }
        if _kind(i):
            spec["authorization"] = {"role-rule": {"patternMatching": {
                "patterns": [{"selector": ROLE_SELECTOR, "operator": "eq",
                              "value": "admin"}]}}}
        if _kind(i) == 2:
            spec["response"] = {"unauthorized": {
                "code": 403,
                "message": {"selector": f"role {{{ROLE_SELECTOR}}} may not pass"},
                "headers": {"x-denied-user": {
                    "selector": "auth.identity.metadata.name"}}}}
        configs.append({"apiVersion": cfg["api_version"], "kind": "AuthConfig",
                        "metadata": {"name": f"key-{i}", "namespace": ns,
                                     "resourceVersion": "1"},
                        "spec": spec})
        for role in cfg["roles"]:
            secrets.append({
                "apiVersion": "v1", "kind": "Secret",
                "metadata": {"name": f"{role}-{i}", "namespace": ns,
                             "resourceVersion": "1",
                             "labels": {label: "authorino", "group": f"k{i}"},
                             "annotations": {"role": role}},
                "stringData": {"api_key": ks[(i, role)]}})
    return {name: "---\n".join(json.dumps(d) + "\n" for d in docs)
            for name, docs in (("authconfigs.yaml", configs),
                               ("secrets.yaml", secrets))}


def requests(cfg: dict, mix: dict, seed: int) -> List[Request]:
    """``mix["distinct"]`` distinct requests drawn from ``seed``: a host
    uniform over the AuthConfigs; the method by ``mix["methods"]``; the
    credential by ``mix["credential"]``: ``own`` (one of its config's
    keys, either role), ``foreign`` (a key of another config, either
    role) or ``none``."""
    n, roles = cfg["auth_configs"], cfg["roles"]
    methods = list(mix["methods"].items())
    creds = list(mix["credential"].items())
    ks = keys(cfg, seed)

    def draw(rng):
        i = rng.randrange(n)
        method = draw_shares(rng, methods)
        cred = draw_shares(rng, creds)
        owner = i
        if cred == "foreign":
            owner = rng.randrange(n - 1)
            owner += owner >= i
        key = None if cred == "none" else ks[(owner, rng.choice(roles))]
        return (i, method, key, rng.randrange(mix["paths"]))

    out = []
    for i, method, key, p in unique_draws(draw, mix["distinct"], seed):
        host = _host(cfg, i)
        headers = {":authority": host, ":method": method,
                   ":path": f"/objects/{p}"}
        if key is not None:
            where, selector = _credential(i)
            headers[where] = f"{selector} {key}" if where == "authorization" \
                else key
        out.append(Request(method, headers[":path"], host, headers))
    return out


class Reference:
    """The plain reference over the manifests' AuthConfigs and Secrets."""

    def __init__(self, cfg: dict, seed: int):
        self.cfg = cfg
        self.index = {_host(cfg, i): i for i in range(cfg["auth_configs"])}
        # each key's Secret: (the config whose selector picks it, role)
        self.secret_of = {k: owner for owner, k in keys(cfg, seed).items()}

    def _presented(self, i: int, req: Request) -> Optional[str]:
        where, selector = _credential(i)
        raw = req.headers.get(where)
        if raw is None:
            return None
        if where == "authorization":
            prefix = selector + " "
            return raw[len(prefix):] if raw.startswith(prefix) else None
        return raw

    def _identity(self, i: int, key: Optional[str],
                  any_config: bool) -> Optional[Tuple[int, str]]:
        owner = self.secret_of.get(key) if key is not None else None
        if owner is None or (owner[0] != i and not any_config):
            return None
        return owner

    def _answer(self, i: int, req: Request, any_config: bool) -> Response:
        key = self._presented(i, req)
        ident = self._identity(i, key, any_config)
        if ident is None:
            _, selector = _credential(i)
            reason = ("credential not found" if key is None
                      else "the API Key provided is invalid")
            return Response(UNAUTHENTICATED, kind="denied", http_status=401,
                            headers=(("www-authenticate",
                                      f'{selector} realm="keys-{i}"'),
                                     ("x-ext-auth-reason", reason)))
        owner, role = ident
        if _kind(i) == 0 or role == "admin":
            return Response(OK, kind="ok")
        prov = f"{self.cfg['namespace']}/key-{i}"
        if _kind(i) == 1:
            return Response(PERMISSION_DENIED, kind="denied", http_status=403,
                            headers=(("x-ext-auth-reason", "Unauthorized"),),
                            provenance=prov)
        return Response(PERMISSION_DENIED, kind="denied", http_status=403,
                        headers=(("x-denied-user", f"{role}-{owner}"),
                                 ("x-ext-auth-reason",
                                  f"role {role} may not pass")),
                        provenance=prov)

    def expected(self, req: Request) -> Response:
        i = self.index.get(req.host)
        if i is None:
            return Response(NOT_FOUND, kind="denied", http_status=404,
                            headers=(("x-ext-auth-reason",
                                      "Service not found"),))
        return self._answer(i, req, any_config=False)

    def control(self, reqs: List[Request]) -> List[Response]:
        """The reference with one guarantee broken: a key is valid if any
        AuthConfig's Secret holds it (the label selector left out)."""
        return [self._answer(self.index[r.host], r, any_config=True)
                for r in reqs]

    def row_work(self, req: Request) -> Optional[Tuple[int, int, int]]:
        """(bytes read, bytes written, integer operations) of the device
        row of one request by the own-config rule, None where it needs
        none (no identity, or no rule): the identity's role value once,
        the config's one leaf as a (selector, operator, operand) record of
        4 + 1 + len(operand) bytes, one verdict byte written, one
        comparison per 4 bytes of the longer string and one to fold."""
        i = self.index[req.host]
        ident = self._identity(i, self._presented(i, req), False)
        if ident is None or _kind(i) == 0:
            return None
        role = ident[1]
        return len(role) + 5 + len("admin"), 1, -(-max(len(role), 5) // 4) + 1
