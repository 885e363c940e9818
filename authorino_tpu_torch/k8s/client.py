"""Cluster abstraction: the narrow seam every Kubernetes-touching evaluator
goes through (the analog of the reference's injected controller-runtime
client / typed clientsets).

``InMemoryCluster`` serves tests and standalone mode (Secrets handed in by
the caller).  A client of a real cluster's REST API is not in the port
yet."""

from __future__ import annotations

import base64
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Protocol, Tuple

__all__ = ["Secret", "LabelSelector", "ClusterReader", "InMemoryCluster"]


@dataclass
class Secret:
    name: str
    namespace: str = "default"
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    data: Dict[str, bytes] = field(default_factory=dict)
    uid: str = ""

    @property
    def key(self) -> Tuple[str, str]:
        return (self.namespace, self.name)

    def to_identity_object(self) -> Dict[str, Any]:
        """K8s-Secret-shaped JSON: what the API-key evaluator resolves as the
        identity object (ref: pkg/evaluators/identity/api_key.go:79-82 returns
        the Secret resource)."""
        return {
            "apiVersion": "v1",
            "kind": "Secret",
            "metadata": {
                "name": self.name,
                "namespace": self.namespace,
                "labels": dict(self.labels),
                "annotations": dict(self.annotations),
                "uid": self.uid,
            },
            "data": {k: base64.b64encode(v).decode() for k, v in self.data.items()},
        }


@dataclass(frozen=True)
class LabelSelector:
    """matchLabels + a subset of string-form expressions ("k=v,k2 in (a,b),!k3")."""

    match_labels: Tuple[Tuple[str, str], ...] = ()
    expressions: Tuple[Tuple[str, str, Tuple[str, ...]], ...] = ()  # (key, op, values)

    @classmethod
    def parse(cls, selector: str) -> "LabelSelector":
        match_labels: List[Tuple[str, str]] = []
        expressions: List[Tuple[str, str, Tuple[str, ...]]] = []
        s = selector.strip()
        i = 0
        parts: List[str] = []
        depth = 0
        buf = []
        for ch in s:
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
            if ch == "," and depth == 0:
                parts.append("".join(buf))
                buf = []
            else:
                buf.append(ch)
        if buf:
            parts.append("".join(buf))
        for part in parts:
            part = part.strip()
            if not part:
                continue
            if " in " in part or " notin " in part:
                op = "in" if " in " in part else "notin"
                key, _, rest = part.partition(f" {op} ")
                vals = tuple(v.strip() for v in rest.strip().strip("()").split(","))
                expressions.append((key.strip(), op, vals))
            elif part.startswith("!"):
                expressions.append((part[1:].strip(), "!", ()))
            elif "!=" in part:
                k, _, v = part.partition("!=")
                expressions.append((k.strip(), "!=", (v.strip(),)))
            elif "=" in part:
                k, _, v = part.partition("==") if "==" in part else part.partition("=")
                match_labels.append((k.strip(), v.strip()))
            else:
                expressions.append((part, "exists", ()))
        return cls(tuple(match_labels), tuple(expressions))

    @classmethod
    def from_spec(cls, spec: Optional[dict]) -> "LabelSelector":
        """From a K8s LabelSelector object ({matchLabels, matchExpressions})."""
        if not spec:
            return cls()
        ml = tuple(sorted((spec.get("matchLabels") or {}).items()))
        exprs = []
        for e in spec.get("matchExpressions") or []:
            op = {"In": "in", "NotIn": "notin", "Exists": "exists", "DoesNotExist": "!"}.get(
                e.get("operator", ""), "exists"
            )
            exprs.append((e.get("key", ""), op, tuple(e.get("values") or ())))
        return cls(ml, tuple(exprs))

    def matches(self, labels: Dict[str, str]) -> bool:
        for k, v in self.match_labels:
            if labels.get(k) != v:
                return False
        for key, op, values in self.expressions:
            if op == "in" and labels.get(key) not in values:
                return False
            if op == "notin" and labels.get(key) in values:
                return False
            if op == "exists" and key not in labels:
                return False
            if op == "!" and key in labels:
                return False
            if op == "!=" and labels.get(key) == values[0]:
                return False
        return True

    def to_string(self) -> str:
        out = [f"{k}={v}" for k, v in self.match_labels]
        for key, op, values in self.expressions:
            if op == "in":
                out.append(f"{key} in ({','.join(values)})")
            elif op == "notin":
                out.append(f"{key} notin ({','.join(values)})")
            elif op == "exists":
                out.append(key)
            elif op == "!":
                out.append(f"!{key}")
            elif op == "!=":
                out.append(f"{key}!={values[0]}")
        return ",".join(out)

    def empty(self) -> bool:
        return not self.match_labels and not self.expressions


class ClusterReader(Protocol):
    async def list_secrets(self, selector: LabelSelector, namespace: Optional[str] = None) -> List[Secret]: ...
    async def get_secret(self, namespace: str, name: str) -> Optional[Secret]: ...
    async def token_review(self, token: str, audiences: List[str]) -> Dict[str, Any]: ...
    async def subject_access_review(self, spec: Dict[str, Any]) -> Dict[str, Any]: ...


class InMemoryCluster:
    """Fake cluster for tests/standalone mode; secret/authconfig mutations
    notify subscribers (drives the reconcilers like watch streams)."""

    def __init__(self):
        self._secrets: Dict[Tuple[str, str], Secret] = {}
        self._secret_listeners: List[Callable[[str, Secret], None]] = []
        self._auth_configs: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._auth_config_listeners: List[Callable[[str, Dict[str, Any]], None]] = []
        self.statuses: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self.token_reviews: Dict[str, Dict[str, Any]] = {}
        self.access_reviews: Callable[[Dict[str, Any]], Dict[str, Any]] = lambda spec: {
            "status": {"allowed": False}
        }

    # --- authconfigs ---
    @staticmethod
    def _ac_key(obj: Dict[str, Any]) -> Tuple[str, str]:
        meta = obj.get("metadata") or {}
        return (meta.get("namespace", "default"), meta.get("name", ""))

    def put_auth_config(self, obj: Dict[str, Any]) -> None:
        self._auth_configs[self._ac_key(obj)] = obj
        for fn in self._auth_config_listeners:
            fn("upsert", obj)

    def remove_auth_config(self, namespace: str, name: str) -> None:
        obj = self._auth_configs.pop((namespace, name), None)
        if obj is not None:
            for fn in self._auth_config_listeners:
                fn("delete", obj)

    def on_auth_config_event(self, fn: Callable[[str, Dict[str, Any]], None]) -> None:
        self._auth_config_listeners.append(fn)

    async def list_auth_configs(self, selector: Optional["LabelSelector"] = None) -> List[Dict[str, Any]]:
        out = []
        for obj in self._auth_configs.values():
            labels = (obj.get("metadata") or {}).get("labels") or {}
            if selector is None or selector.matches(labels):
                out.append(obj)
        return out

    async def patch_auth_config_status(self, namespace: str, name: str, status: Dict[str, Any]) -> None:
        self.statuses[(namespace, name)] = status
        obj = self._auth_configs.get((namespace, name))
        if obj is not None:
            obj["status"] = status

    # --- secrets ---
    def put_secret(self, secret: Secret) -> None:
        self._secrets[secret.key] = secret
        for fn in self._secret_listeners:
            fn("upsert", secret)

    def remove_secret(self, namespace: str, name: str) -> None:
        secret = self._secrets.pop((namespace, name), None)
        if secret is not None:
            for fn in self._secret_listeners:
                fn("delete", secret)

    def on_secret_event(self, fn: Callable[[str, Secret], None]) -> None:
        self._secret_listeners.append(fn)

    async def list_secrets(self, selector: LabelSelector, namespace: Optional[str] = None) -> List[Secret]:
        return [
            s
            for s in self._secrets.values()
            if (namespace is None or s.namespace == namespace) and selector.matches(s.labels)
        ]

    async def get_secret(self, namespace: str, name: str) -> Optional[Secret]:
        return self._secrets.get((namespace, name))

    # --- reviews ---
    async def token_review(self, token: str, audiences: List[str]) -> Dict[str, Any]:
        hit = self.token_reviews.get(token)
        if hit is None:
            return {"status": {"authenticated": False, "error": "invalid token"}}
        return hit

    async def subject_access_review(self, spec: Dict[str, Any]) -> Dict[str, Any]:
        return self.access_reviews(spec)
