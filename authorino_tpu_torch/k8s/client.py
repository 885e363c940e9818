"""Cluster abstraction: the narrow seam every Kubernetes-touching evaluator
goes through (the analog of the reference's injected controller-runtime
client / typed clientsets).

Implementations:
  - InMemoryCluster — tests and standalone mode (Secrets loaded from
    manifests), with an in-memory lease store
  - RestCluster    — a real cluster over its REST API on the port's
    standard-library HTTP client (``utils/http.py``; in-cluster service
    account or a given token), without the ``kubernetes`` package
"""

from __future__ import annotations

import base64
import datetime
import json
import os
import ssl
import threading
import time
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Callable, Dict, List, Optional, Protocol, Set, Tuple

from ..utils import http as http_util

__all__ = ["Secret", "LabelSelector", "ClusterReader", "InMemoryCluster", "RestCluster"]


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

    # --- leases (delegated to an in-memory CAS store) ---
    @property
    def _lease_store(self):
        if not hasattr(self, "_leases_impl"):
            from .leader import InMemoryLeases

            self._leases_impl = InMemoryLeases()
        return self._leases_impl

    async def get_lease(self, namespace: str, name: str):
        return await self._lease_store.get_lease(namespace, name)

    async def put_lease(self, namespace: str, name: str, lease) -> bool:
        return await self._lease_store.put_lease(namespace, name, lease)


class RestCluster:
    """Kubernetes REST client on the port's HTTP client (no `kubernetes`
    package, no aiohttp).

    In-cluster: reads the service-account token + CA from
    /var/run/secrets/kubernetes.io/serviceaccount (like client-go's
    InClusterConfig the reference relies on through controller-runtime).
    ``stop()`` ends every open watch at once by shutting its socket."""

    SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

    def __init__(self, base_url: Optional[str] = None, token: Optional[str] = None, ca_file: Optional[str] = None):
        if base_url is None:
            host = os.environ.get("KUBERNETES_SERVICE_HOST")
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            if not host:
                raise RuntimeError("not running in-cluster and no base_url given")
            base_url = f"https://{host}:{port}"
        self.base_url = base_url.rstrip("/")
        self._token = token
        self._ca_file = ca_file or os.path.join(self.SA_DIR, "ca.crt")
        self._ssl: Optional[ssl.SSLContext] = None
        self._streams: Set[http_util.LineStream] = set()
        self._streams_lock = threading.Lock()

    def _auth_headers(self) -> Dict[str, str]:
        token = self._token
        if token is None:
            try:
                with open(os.path.join(self.SA_DIR, "token")) as f:
                    token = f.read().strip()
            except OSError:
                token = ""
        return {"Authorization": f"Bearer {token}"} if token else {}

    def _ssl_ctx(self):
        if self._ssl is None and os.path.exists(self._ca_file):
            self._ssl = ssl.create_default_context(cafile=self._ca_file)
        return self._ssl

    async def _request(self, method: str, path: str, *, params=None, json_body=None,
                       headers: Optional[Dict[str, str]] = None) -> Any:
        hdrs = {**self._auth_headers(), **(headers or {})}
        data = None
        if json_body is not None:
            # aiohttp's json=: the body as json.dumps writes it, typed
            # application/json unless the caller names another type
            data = json.dumps(json_body).encode()
            if not any(k.lower() == "content-type" for k in hdrs):
                hdrs["Content-Type"] = "application/json"
        resp = await http_util.request(
            method, f"{self.base_url}{path}", headers=hdrs, params=params,
            data=data, ssl=self._ssl_ctx())
        body = resp.text()
        if resp.status >= 300:
            raise RuntimeError(f"k8s api {method} {path}: {resp.status} {body[:200]}")
        return json.loads(body) if body else {}

    @staticmethod
    def _secret_from_obj(obj: Dict[str, Any]) -> Secret:
        meta = obj.get("metadata", {})
        return Secret(
            name=meta.get("name", ""),
            namespace=meta.get("namespace", "default"),
            labels=meta.get("labels", {}) or {},
            annotations=meta.get("annotations", {}) or {},
            uid=meta.get("uid", ""),
            data={k: base64.b64decode(v) for k, v in (obj.get("data") or {}).items()},
        )

    async def list_secrets(self, selector: LabelSelector, namespace: Optional[str] = None) -> List[Secret]:
        secrets, _ = await self.list_secrets_rv(selector, namespace)
        return secrets

    async def list_secrets_rv(
        self, selector: LabelSelector, namespace: Optional[str] = None
    ) -> Tuple[List[Secret], Optional[str]]:
        path = f"/api/v1/namespaces/{namespace}/secrets" if namespace else "/api/v1/secrets"
        params = {}
        sel = selector.to_string()
        if sel:
            params["labelSelector"] = sel
        payload = await self._request("GET", path, params=params)
        rv = (payload.get("metadata") or {}).get("resourceVersion")
        return [self._secret_from_obj(o) for o in payload.get("items", [])], rv

    async def get_secret(self, namespace: str, name: str) -> Optional[Secret]:
        try:
            obj = await self._request("GET", f"/api/v1/namespaces/{namespace}/secrets/{name}")
        except RuntimeError:
            return None
        return self._secret_from_obj(obj)

    async def token_review(self, token: str, audiences: List[str]) -> Dict[str, Any]:
        body = {
            "apiVersion": "authentication.k8s.io/v1",
            "kind": "TokenReview",
            "spec": {"token": token, "audiences": audiences},
        }
        return await self._request(
            "POST", "/apis/authentication.k8s.io/v1/tokenreviews", json_body=body
        )

    async def subject_access_review(self, spec: Dict[str, Any]) -> Dict[str, Any]:
        body = {
            "apiVersion": "authorization.k8s.io/v1",
            "kind": "SubjectAccessReview",
            "spec": spec,
        }
        return await self._request(
            "POST", "/apis/authorization.k8s.io/v1/subjectaccessreviews", json_body=body
        )

    # --- AuthConfig CRs (authorino.kuadrant.io) ---------------------------
    AC_GROUP = "authorino.kuadrant.io"
    AC_VERSION = "v1beta2"

    def _ac_path(self, namespace: Optional[str] = None, name: Optional[str] = None) -> str:
        base = f"/apis/{self.AC_GROUP}/{self.AC_VERSION}"
        if namespace:
            base += f"/namespaces/{namespace}"
        base += "/authconfigs"
        if name:
            base += f"/{name}"
        return base

    async def list_auth_configs(self, selector: Optional[LabelSelector] = None) -> List[Dict[str, Any]]:
        items, _ = await self.list_auth_configs_rv(selector)
        return items

    async def list_auth_configs_rv(
        self, selector: Optional[LabelSelector] = None
    ) -> Tuple[List[Dict[str, Any]], Optional[str]]:
        """List + the list's resourceVersion, so a watch can start exactly
        where this snapshot ends (no missed-delete gap between list and
        watch — ref: controller-runtime informer ListAndWatch)."""
        params = {}
        if selector is not None and not selector.empty():
            params["labelSelector"] = selector.to_string()
        payload = await self._request("GET", self._ac_path(), params=params)
        rv = (payload.get("metadata") or {}).get("resourceVersion")
        return payload.get("items", []), rv

    async def patch_auth_config_status(self, namespace: str, name: str, status: Dict[str, Any]) -> None:
        """Status subresource merge-patch (the leader-elected writer's
        operation — ref: controllers/auth_config_status_updater.go:35-103)."""
        await self._request(
            "PATCH",
            self._ac_path(namespace, name) + "/status",
            json_body={"status": status},
            headers={"Content-Type": "application/merge-patch+json"},
        )

    async def watch(self, path: str, params: Optional[Dict[str, str]] = None,
                    timeout_seconds: int = 300) -> AsyncIterator[Tuple[str, Dict[str, Any]]]:
        """Yield (event_type, object) from a K8s watch stream (chunked JSON
        lines).  Caller re-lists + re-watches on stream end (the informer
        resync the reference gets from controller-runtime).  Bounded both
        server-side (timeoutSeconds) and client-side (each read waits at
        most timeout_seconds + 30 s) so a half-open TCP connection can't
        hang the watch forever."""
        q = dict(params or {})
        q["watch"] = "true"
        q["timeoutSeconds"] = str(timeout_seconds)
        stream = http_util.LineStream(
            f"{self.base_url}{path}", headers=self._auth_headers(), params=q,
            read_timeout=timeout_seconds + 30, ssl=self._ssl_ctx())
        with self._streams_lock:
            self._streams.add(stream)
        try:
            status = await stream.open()
            if status >= 300:
                raise RuntimeError(f"k8s watch {path}: {status}")
            async for line in stream.lines():
                try:
                    ev = json.loads(line)
                except ValueError:
                    continue
                yield ev.get("type", ""), ev.get("object", {})
        finally:
            stream.close()
            with self._streams_lock:
                self._streams.discard(stream)

    def stop(self) -> None:
        """End every open watch now: its socket is shut, so a read blocked
        on it returns at once (the watch then ends like a dropped
        stream)."""
        with self._streams_lock:
            streams = list(self._streams)
        for stream in streams:
            stream.close()

    # --- Leases (coordination.k8s.io/v1) ----------------------------------
    def _lease_path(self, namespace: str, name: Optional[str] = None) -> str:
        p = f"/apis/coordination.k8s.io/v1/namespaces/{namespace}/leases"
        return f"{p}/{name}" if name else p

    async def get_lease(self, namespace: str, name: str):
        from .leader import Lease

        try:
            obj = await self._request("GET", self._lease_path(namespace, name))
        except RuntimeError as e:
            # only not-found means "unheld"; transient API errors must NOT
            # look like a free lease or followers would seize leadership on
            # every apiserver blip
            if ": 404" in str(e):
                return None
            raise
        spec = obj.get("spec") or {}
        lease = Lease(
            holder=spec.get("holderIdentity", ""),
            acquire_time=0.0,
            renew_time=0.0,
            duration_s=float(spec.get("leaseDurationSeconds", 15)),
            transitions=int(spec.get("leaseTransitions", 0)),
        )
        # renewTime is RFC3339; convert to a monotonic-comparable age
        rt = spec.get("renewTime")
        if rt:
            try:
                dt = datetime.datetime.fromisoformat(rt.replace("Z", "+00:00"))
                age = (datetime.datetime.now(datetime.timezone.utc) - dt).total_seconds()
                lease.renew_time = time.monotonic() - age
            except ValueError:
                pass
        lease._resource_version = (obj.get("metadata") or {}).get("resourceVersion")  # type: ignore[attr-defined]
        return lease

    async def put_lease(self, namespace: str, name: str, lease) -> bool:
        now = datetime.datetime.now(datetime.timezone.utc)
        if getattr(lease, "released", False):
            # voluntary release: persist a renewTime already past the lease
            # duration so the next candidate can take over immediately
            now -= datetime.timedelta(seconds=lease.duration_s + 1)
        now_iso = now.isoformat().replace("+00:00", "Z")
        body = {
            "apiVersion": "coordination.k8s.io/v1",
            "kind": "Lease",
            "metadata": {"name": name, "namespace": namespace},
            "spec": {
                "holderIdentity": lease.holder,
                "leaseDurationSeconds": int(lease.duration_s),
                "renewTime": now_iso,
                "leaseTransitions": lease.transitions,
            },
        }
        # compare-and-swap both ways: a lease the elector read is replaced
        # only at the resourceVersion it read, and one it found absent is
        # only created, so of two replicas that both found none, the
        # second's POST meets a 409 and loses (the reference PUTs without
        # a version first, which lets both lead)
        rv = getattr(lease, "_resource_version", None)
        try:
            if rv:
                body["metadata"]["resourceVersion"] = rv
                await self._request("PUT", self._lease_path(namespace, name), json_body=body)
            else:
                await self._request("POST", self._lease_path(namespace), json_body=body)
            return True
        except RuntimeError:
            return False  # conflict: another holder created or updated first
