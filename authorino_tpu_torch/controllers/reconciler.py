"""AuthConfig reconciler: sources of AuthConfig resources → translate →
engine snapshot swap + status reporting
(semantics: ref controllers/auth_config_controller.go:74-157 Reconcile,
:605-636 addToIndex/hostTaken, :638-693 bootstrapIndex,
controllers/status_report.go, controllers/auth_config_status_updater.go).

The accelerator-era difference: a successful reconcile triggers
whole-corpus tensor recompilation and an atomic device-buffer swap — the
analog of the reference's per-policy OPA precompile, amortized across the
corpus.  The port recompiles and re-uploads the whole corpus on every
reconcile (no delta upload yet), on a worker thread while the engine keeps
serving the previous snapshot.  The port's translate reads no AuthConfig
annotations yet (tenancy), so none are passed."""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..evaluators.deny_all import new_deny_all_config
from ..k8s.client import ClusterReader, LabelSelector, Secret
from ..runtime.engine import EngineEntry, PolicyEngine
from .translate import TranslationError, translate_auth_config

__all__ = ["AuthConfigReconciler", "SecretReconciler", "StatusReport", "StatusReportMap"]

log = logging.getLogger(__name__)

STATUS_RECONCILED = "Reconciled"
STATUS_RECONCILING = "Reconciling"
STATUS_CACHING_ERROR = "CachingError"
STATUS_HOSTS_NOT_LINKED = "HostsNotLinked"


@dataclass
class StatusReport:
    """(ref: controllers/status_report.go:10-60)"""

    reason: str = STATUS_RECONCILING
    message: str = ""
    hosts_ready: List[str] = field(default_factory=list)

    def ready(self) -> bool:
        return self.reason == STATUS_RECONCILED


class StatusReportMap:
    def __init__(self):
        self._lock = threading.Lock()
        self._reports: Dict[str, StatusReport] = {}

    def set(self, id_: str, reason: str, message: str = "", hosts_ready: Optional[List[str]] = None):
        with self._lock:
            self._reports[id_] = StatusReport(reason, message, hosts_ready or [])

    def get(self, id_: str) -> Optional[StatusReport]:
        with self._lock:
            return self._reports.get(id_)

    def clear(self, id_: str):
        with self._lock:
            self._reports.pop(id_, None)

    def all(self) -> Dict[str, StatusReport]:
        with self._lock:
            return dict(self._reports)

    def ready(self) -> bool:
        """Readiness gate: not-Ready while any AuthConfig is unreconciled
        (ref: controllers/auth_config_controller.go:705-719)."""
        with self._lock:
            return all(r.ready() for r in self._reports.values())

    def status_object(self, id_: str) -> Dict[str, Any]:
        """K8s-style status conditions + summary
        (ref: controllers/auth_config_status_updater.go:35-103)."""
        report = self.get(id_) or StatusReport()
        ready = report.ready()
        return {
            "conditions": [
                {"type": "Available", "status": "True" if ready else "False", "reason": report.reason},
                {"type": "Ready", "status": "True" if ready else "False", "reason": report.reason,
                 "message": report.message},
            ],
            "summary": {
                "ready": ready,
                "hostsReady": report.hosts_ready,
                "numHostsReady": len(report.hosts_ready),
            },
        }


class AuthConfigReconciler:
    """Translates a full set of AuthConfig resources and swaps the engine
    snapshot.  Whole-set reconciliation keeps the corpus compile atomic
    (its cost at 1k configs: chip_smoke.py phase 10)."""

    def __init__(
        self,
        engine: PolicyEngine,
        cluster: Optional[ClusterReader] = None,
        label_selector: Optional[LabelSelector] = None,
        allow_superseding_host_subsets: bool = False,
    ):
        self.engine = engine
        self.cluster = cluster
        # instance sharding (ref: controllers/label_selector.go:14-45)
        self.label_selector = label_selector or LabelSelector()
        self.allow_superseding_host_subsets = allow_superseding_host_subsets
        self.status = StatusReportMap()
        self._resources: Dict[str, dict] = {}  # id → CR dict (v1beta2-shaped)
        self._lock = asyncio.Lock()
        self._bootstrapped = False

    def watched(self, resource: dict) -> bool:
        """Label-selector sharding predicate (ref: label_selector.go:14)."""
        labels = (resource.get("metadata") or {}).get("labels") or {}
        return self.label_selector.matches(labels)

    async def upsert(self, resource: dict) -> None:
        meta = resource.get("metadata") or {}
        id_ = f"{meta.get('namespace', 'default')}/{meta.get('name', '')}"
        if not self.watched(resource):
            # unwatched: treat as delete (ref :88-104)
            await self.delete(id_)
            return
        async with self._lock:
            old = self._resources.get(id_)
            rv = meta.get("resourceVersion")
            report = self.status.get(id_)
            if old is not None and rv and (
                (old.get("metadata") or {}).get("resourceVersion") == rv
            ) and report is not None and report.reason != STATUS_CACHING_ERROR:
                # same resourceVersion: a resync replay, not a change — do
                # not re-translate the world (informer-style dedup; watch
                # re-lists after stream drops re-deliver every object).
                # CachingError configs are exempt: their translate failure
                # may be transient (Secret read, discovery) and resyncs are
                # the retry mechanism.
                self._resources[id_] = resource
                return
            self._resources[id_] = resource
            self.status.set(id_, STATUS_RECONCILING)
            await self._rebuild()

    async def delete(self, id_: str) -> None:
        async with self._lock:
            if id_ in self._resources:
                del self._resources[id_]
                self.status.clear(id_)
                await self._rebuild()

    @staticmethod
    def _rv_map(resources: Dict[str, dict]) -> Optional[Dict[str, str]]:
        """id → resourceVersion, or None when any object lacks one (then
        change detection is impossible and a rebuild is forced)."""
        out: Dict[str, str] = {}
        for id_, r in resources.items():
            rv = (r.get("metadata") or {}).get("resourceVersion")
            if not rv:
                return None
            out[id_] = rv
        return out

    async def reconcile_all(self, resources: List[dict]) -> None:
        """Cold-start path: index deny-all for every host first (bootstrap
        safety, ref :638-693), then translate for real."""
        async with self._lock:
            if self._bootstrapped:
                new_map = {}
                for r in resources:
                    if not self.watched(r):
                        continue
                    meta = r.get("metadata") or {}
                    new_map[f"{meta.get('namespace', 'default')}/{meta.get('name', '')}"] = r
                new_rvs = self._rv_map(new_map)
                healthy = all(
                    (r := self.status.get(id_)) is not None
                    and r.reason != STATUS_CACHING_ERROR
                    for id_ in new_map
                )
                if (healthy and new_rvs is not None
                        and new_rvs == self._rv_map(self._resources)):
                    # re-list after a watch drop delivered the exact state we
                    # already serve, and nothing is in a (possibly transient)
                    # translate-error state: skip the corpus rebuild (no
                    # duplicate reconcile), keep the refreshed dicts.
                    # CachingError configs force the rebuild — resyncs are
                    # their retry path and /readyz stays 503 until they heal.
                    self._resources = new_map
                    return
            self._resources = {}
            deny_entries: List[EngineEntry] = []
            stale_ids = set(self.status.all())
            for r in resources:
                if not self.watched(r):
                    continue
                meta = r.get("metadata") or {}
                id_ = f"{meta.get('namespace', 'default')}/{meta.get('name', '')}"
                self._resources[id_] = r
                self.status.set(id_, STATUS_RECONCILING)
                hosts = list((r.get("spec") or {}).get("hosts") or [])
                deny_entries.append(
                    EngineEntry(id=id_, hosts=hosts, runtime=new_deny_all_config())
                )
            # prune reports for configs deleted while the watch was down —
            # a stale non-ready entry would wedge /readyz at 503 and make
            # the status updater patch a deleted CR forever
            for id_ in stale_ids - set(self._resources):
                self.status.clear(id_)
            if not self._bootstrapped:
                try:
                    self.engine.apply_snapshot(deny_entries, override=True)
                except Exception as e:
                    log.warning("bootstrap deny-all failed: %s", e)
                self._bootstrapped = True
            await self._rebuild()

    async def _rebuild(self) -> None:
        entries: List[EngineEntry] = []
        taken_hosts: Dict[str, str] = {}
        for id_, resource in self._resources.items():
            meta = resource.get("metadata") or {}
            spec = resource.get("spec") or {}
            try:
                entry = await translate_auth_config(
                    meta.get("name", ""),
                    meta.get("namespace", "default"),
                    spec,
                    labels=meta.get("labels"),
                    cluster=self.cluster,
                    engine=self.engine,
                )
            except TranslationError as e:
                self.status.set(id_, STATUS_CACHING_ERROR, str(e))
                continue
            except Exception as e:
                self.status.set(id_, STATUS_CACHING_ERROR, f"unexpected: {e}")
                continue
            # host collision policy (ref :605-636 hostTaken +
            # AllowSupersedingHostSubsets)
            linked: List[str] = []
            for host in entry.hosts:
                owner = taken_hosts.get(host)
                if owner is None or owner == id_:
                    taken_hosts[host] = id_
                    linked.append(host)
                elif self.allow_superseding_host_subsets and _is_subset_host(host, taken_hosts):
                    taken_hosts[host] = id_
                    linked.append(host)
            entry.hosts = linked
            entries.append(entry)
            if linked and len(linked) == len(spec.get("hosts") or []):
                self.status.set(id_, STATUS_RECONCILED, hosts_ready=linked)
            elif linked:
                self.status.set(
                    id_, STATUS_RECONCILED,
                    message="one or more hosts not linked to the resource",
                    hosts_ready=linked,
                )
            else:
                self.status.set(id_, STATUS_HOSTS_NOT_LINKED, "hosts already taken")
        # capture evaluators being replaced so their background workers and
        # caches stop (ref: authConfig.Clean on de-index,
        # controllers/auth_config_controller.go:88-104); compile + device
        # upload run off the serving loop
        old_entries = self.engine.index.list()
        try:
            await asyncio.to_thread(self.engine.apply_snapshot, entries, True)
        except Exception as e:
            # the engine still serves the OLD corpus: statuses set above
            # must not claim Reconciled, or the resourceVersion resync
            # dedup would skip every retry and the engine never converges
            for entry in entries:
                self.status.set(entry.id, STATUS_CACHING_ERROR,
                                f"corpus swap failed: {e}")
            raise
        # change safety: a config the engine quarantined after
        # a canary guard breach SERVES (its prior vetted artifact), so it
        # stays Ready — but the status message must tell the operator the
        # new spec was rolled back and is being held out
        cs_vars = getattr(self.engine, "change_safety_vars", None)
        q = (cs_vars() or {}).get("quarantine") if cs_vars else None
        if q:
            for cid in q.get("configs", []):
                report = self.status.get(cid)
                if report is not None:
                    self.status.set(
                        cid, STATUS_RECONCILED,
                        message="quarantined after canary guard breach: "
                                "serving the previous vetted rules; ship a "
                                "fixed spec (or clear-quarantine) to "
                                "release",
                        hosts_ready=report.hosts_ready)
        if old_entries:
            await self._clean_entries(old_entries)

    @staticmethod
    async def _clean_entries(entries: List[EngineEntry]) -> None:
        for e in entries:
            try:
                await e.runtime.clean()
            except Exception:
                pass

    def ready(self) -> bool:
        return self.status.ready()


def _is_subset_host(host: str, taken: Dict[str, str]) -> bool:
    """A more specific host may supersede a wildcard superset
    (ref: controllers/auth_config_controller.go AllowSupersedingHostSubsets)."""
    for t in taken:
        if t.startswith("*.") and host.endswith(t[1:]):
            return True
    return False


class SecretReconciler:
    """Watches labeled Secrets and pushes add/revoke into API-key and mTLS
    evaluators in place (semantics: ref controllers/secret_controller.go:40-130)."""

    def __init__(self, engine: PolicyEngine, secret_label_selector: Optional[LabelSelector] = None):
        self.engine = engine
        # --secret-label-selector analog (ref main.go)
        self.secret_label_selector = secret_label_selector or LabelSelector()

    def _k8s_secret_based_evaluators(self):
        for entry in self.engine.index.list():
            for idc in entry.runtime.identity:
                ev = idc.evaluator
                if hasattr(ev, "add_k8s_secret_based_identity"):
                    yield ev

    def on_event(self, kind: str, secret: Secret) -> None:
        changed = False
        if kind == "delete" or not self.secret_label_selector.matches(secret.labels):
            # deleted or unlabeled → revoke everywhere (ref :49-53)
            for ev in self._k8s_secret_based_evaluators():
                changed |= bool(
                    ev.revoke_k8s_secret_based_identity(secret.namespace, secret.name))
        else:
            for ev in self._k8s_secret_based_evaluators():
                # per-evaluator selector match → add or revoke (ref :55-60, :108-130)
                if ev.get_k8s_secret_label_selectors().matches(secret.labels):
                    changed |= bool(ev.add_k8s_secret_based_identity(secret))
                else:
                    changed |= bool(
                        ev.revoke_k8s_secret_based_identity(secret.namespace, secret.name))
        if changed:
            # listeners that compile credential views must follow a
            # rotation (no corpus swap)
            self.engine.notify_swap_listeners()
