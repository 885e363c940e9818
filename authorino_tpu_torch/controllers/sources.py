"""AuthConfig/Secret resource sources.

The reference's control plane is Kubernetes watch streams via
controller-runtime (ref main.go:241-306).  Here sources are pluggable:

  - YamlDirSource: standalone/gitops mode — AuthConfig (v1beta1 or v1beta2)
    and Secret manifests in a directory, mtime-polled
  - K8sWatchSource: real cluster via the REST client's watch endpoints
    (RestCluster); resyncs on connection loss
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import yaml

from ..apis.convert import to_v1beta2
from ..k8s.client import InMemoryCluster, LabelSelector, RestCluster, Secret
from .reconciler import AuthConfigReconciler, SecretReconciler

__all__ = ["YamlDirSource", "K8sWatchSource", "load_manifests"]

log = logging.getLogger(__name__)

# libyaml's safe loader where PyYAML was built with it: the same documents
# as yaml.SafeLoader's, about ten times faster on a directory of manifests
_SAFE_LOADER = getattr(yaml, "CSafeLoader", yaml.SafeLoader)


def load_manifests(path: str) -> Tuple[List[dict], List[Secret]]:
    """Parse all YAML docs under a file/dir into (authconfigs, secrets)."""
    import base64

    files: List[str] = []
    if os.path.isdir(path):
        for root, _, names in os.walk(path):
            files.extend(
                os.path.join(root, n) for n in names if n.endswith((".yaml", ".yml", ".json"))
            )
    else:
        files = [path]
    authconfigs: List[dict] = []
    secrets: List[Secret] = []
    for f in sorted(files):
        try:
            with open(f) as fh:
                docs = list(yaml.load_all(fh, Loader=_SAFE_LOADER))
        except Exception as e:
            log.warning("skipping unparseable manifest %s: %s", f, e)
            continue
        for doc in docs:
            if not isinstance(doc, dict):
                continue
            kind = doc.get("kind")
            if kind == "AuthConfig":
                authconfigs.append(to_v1beta2(doc))
            elif kind == "Secret":
                meta = doc.get("metadata") or {}
                data = {
                    k: base64.b64decode(v) for k, v in (doc.get("data") or {}).items()
                }
                for k, v in (doc.get("stringData") or {}).items():
                    data[k] = v.encode()
                secrets.append(
                    Secret(
                        name=meta.get("name", ""),
                        namespace=meta.get("namespace", "default"),
                        labels=meta.get("labels") or {},
                        annotations=meta.get("annotations") or {},
                        data=data,
                    )
                )
    return authconfigs, secrets


class YamlDirSource:
    """Standalone control plane: manifests from disk, polled for changes."""

    def __init__(
        self,
        path: str,
        reconciler: AuthConfigReconciler,
        cluster: InMemoryCluster,
        secret_reconciler: Optional[SecretReconciler] = None,
        poll_interval_s: float = 2.0,
    ):
        self.path = path
        self.reconciler = reconciler
        self.cluster = cluster
        self.secret_reconciler = secret_reconciler
        self.poll_interval_s = poll_interval_s
        self._snapshot_sig: Optional[tuple] = None
        self._task: Optional[asyncio.Task] = None
        if secret_reconciler is not None:
            cluster.on_secret_event(secret_reconciler.on_event)

    def _signature(self) -> tuple:
        sig = []
        if os.path.isdir(self.path):
            for root, _, names in os.walk(self.path):
                for n in sorted(names):
                    p = os.path.join(root, n)
                    try:
                        sig.append((p, os.path.getmtime(p), os.path.getsize(p)))
                    except OSError:
                        pass
        elif os.path.exists(self.path):
            sig.append((self.path, os.path.getmtime(self.path), os.path.getsize(self.path)))
        return tuple(sig)

    async def sync(self) -> None:
        authconfigs, secrets = load_manifests(self.path)
        current = {s.key for s in secrets}
        for existing in await self.cluster.list_secrets(LabelSelector()):
            if existing.key not in current:
                self.cluster.remove_secret(*existing.key)
        for s in secrets:
            self.cluster.put_secret(s)
        await self.reconciler.reconcile_all(authconfigs)

    async def run(self) -> None:
        while True:
            sig = self._signature()
            if sig != self._snapshot_sig:
                self._snapshot_sig = sig
                try:
                    await self.sync()
                except Exception as e:
                    log.error("sync failed: %s", e)
            await asyncio.sleep(self.poll_interval_s)

    def start(self) -> "YamlDirSource":
        self._task = asyncio.ensure_future(self.run())
        return self

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass


class K8sWatchSource:
    """Real-cluster control plane: list + watch AuthConfigs and Secrets via
    the REST client, feeding the reconcilers — the role controller-runtime's
    informers play for the reference (ref: main.go:241-306).  On watch-stream
    loss, re-lists (informer resync)."""

    def __init__(
        self,
        cluster: RestCluster,
        reconciler: AuthConfigReconciler,
        secret_reconciler: Optional[SecretReconciler] = None,
        secret_label_selector: Optional[LabelSelector] = None,
        resync_interval_s: float = 10.0,
    ):
        self.cluster = cluster
        self.reconciler = reconciler
        self.secret_reconciler = secret_reconciler
        self.secret_label_selector = secret_label_selector or LabelSelector.parse(
            "authorino.kuadrant.io/managed-by=authorino"
        )
        self.resync_interval_s = resync_interval_s
        self._tasks: List[asyncio.Task] = []
        # list→watch resourceVersion continuity: objects deleted between the
        # list and the watch start still produce DELETED events when the
        # watch resumes from the list's snapshot version
        self._ac_rv: Optional[str] = None
        self._sec_rv: Optional[str] = None

    def _ac_params(self) -> Dict[str, str]:
        """Server-side sharding: a label-selected instance must not stream
        the whole cluster's AuthConfigs (ref: label_selector.go predicate,
        here pushed down to the API like the secret path)."""
        sel = self.reconciler.label_selector.to_string()
        return {"labelSelector": sel} if sel else {}

    async def _initial_sync(self) -> None:
        list_rv = getattr(self.cluster, "list_auth_configs_rv", None)
        if list_rv is not None:
            items, self._ac_rv = await list_rv(self.reconciler.label_selector)
        else:
            items = await self.cluster.list_auth_configs(self.reconciler.label_selector)
        await self.reconciler.reconcile_all([to_v1beta2(o) for o in items])

    async def _watch_auth_configs(self) -> None:
        path = self.cluster._ac_path()
        while True:
            try:
                params = self._ac_params()
                if self._ac_rv:
                    params["resourceVersion"] = self._ac_rv
                    params["allowWatchBookmarks"] = "true"
                async for ev_type, obj in self.cluster.watch(path, params):
                    if ev_type == "ERROR":
                        # e.g. 410 Gone Status object: resume point is
                        # invalid — drop it and re-list
                        self._ac_rv = None
                        break
                    meta = obj.get("metadata") or {}
                    rv = meta.get("resourceVersion")
                    if rv:
                        self._ac_rv = rv
                    if ev_type == "BOOKMARK":
                        continue
                    id_ = f"{meta.get('namespace', 'default')}/{meta.get('name', '')}"
                    if ev_type == "DELETED":
                        await self.reconciler.delete(id_)
                    elif ev_type in ("ADDED", "MODIFIED"):
                        await self.reconciler.upsert(to_v1beta2(obj))
            except asyncio.CancelledError:
                raise
            except Exception as e:
                # includes 410 Gone (resourceVersion too old): the re-list
                # below refreshes the snapshot + resume point
                log.warning("authconfig watch lost (%s); re-listing", e)
                self._ac_rv = None
            await asyncio.sleep(self.resync_interval_s)
            try:
                await self._initial_sync()
            except Exception as e:
                log.warning("authconfig re-list failed: %s", e)

    async def _watch_secrets(self) -> None:
        if self.secret_reconciler is None:
            return
        params = {}
        sel = self.secret_label_selector.to_string()
        if sel:
            params["labelSelector"] = sel
        first = True
        known: Dict[tuple, Secret] = {}
        while True:
            if not first:
                # events during the gap are gone from the stream; replay the
                # current state (upserts + synthesized deletes) so adds and
                # revocations aren't lost
                try:
                    list_rv = getattr(self.cluster, "list_secrets_rv", None)
                    if list_rv is not None:
                        secrets, self._sec_rv = await list_rv(self.secret_label_selector)
                    else:
                        secrets = await self.cluster.list_secrets(self.secret_label_selector)
                    listed = {s.key: s for s in secrets}
                    for key in set(known) - set(listed):
                        self.secret_reconciler.on_event("delete", known[key])
                    for s in listed.values():
                        self.secret_reconciler.on_event("upsert", s)
                    known = listed
                except Exception as e:
                    log.warning("secret re-list failed: %s", e)
            first = False
            try:
                q = dict(params)
                if self._sec_rv:
                    q["resourceVersion"] = self._sec_rv
                    q["allowWatchBookmarks"] = "true"
                async for ev_type, obj in self.cluster.watch("/api/v1/secrets", q):
                    if ev_type == "ERROR":
                        self._sec_rv = None
                        break
                    rv = (obj.get("metadata") or {}).get("resourceVersion")
                    if rv:
                        self._sec_rv = rv
                    if ev_type not in ("ADDED", "MODIFIED", "DELETED"):
                        continue  # BOOKMARK or unknown: never a Secret object
                    secret = RestCluster._secret_from_obj(obj)
                    kind = "delete" if ev_type == "DELETED" else "upsert"
                    if kind == "delete":
                        known.pop(secret.key, None)
                    else:
                        known[secret.key] = secret
                    self.secret_reconciler.on_event(kind, secret)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                log.warning("secret watch lost (%s); retrying", e)
                self._sec_rv = None
            await asyncio.sleep(self.resync_interval_s)

    async def sync(self, max_attempts: int = 0) -> None:
        """Initial list with retry — serving must not start (nor readiness
        pass) on an empty index because the apiserver was briefly down at
        boot.  max_attempts=0 retries forever (cache-sync semantics)."""
        attempt = 0
        while True:
            attempt += 1
            try:
                await self._initial_sync()
                self._synced = True
                return
            except Exception as e:
                if max_attempts and attempt >= max_attempts:
                    raise
                delay = min(2.0 * attempt, self.resync_interval_s)
                log.warning("initial AuthConfig list failed (%s); retrying in %.1fs", e, delay)
                await asyncio.sleep(delay)

    async def run(self) -> None:
        if not getattr(self, "_synced", False):
            await self.sync()
        await asyncio.gather(self._watch_auth_configs(), self._watch_secrets())

    def start(self) -> "K8sWatchSource":
        loop = asyncio.get_event_loop()
        self._tasks = [loop.create_task(self.run())]
        return self

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        self._tasks = []
