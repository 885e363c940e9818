"""Leader-elected AuthConfig status writer.

The reference runs a second controller-runtime manager whose sole job is
patching ``status.conditions`` + ``status.summary``, with leader election so
only one replica writes (ref: main.go:308-336,
controllers/auth_config_status_updater.go:35-103).  Here: a loop that, while
holding the Lease, diffs the reconciler's StatusReportMap against what was
last written and merge-patches the status subresource.
"""

from __future__ import annotations

import asyncio
import logging
import socket
import uuid
from typing import Any, Dict, Optional, Protocol

from ..k8s.leader import LeaderElector, LeaseClient
from .reconciler import AuthConfigReconciler

__all__ = ["AuthConfigStatusUpdater", "StatusWriter"]

log = logging.getLogger(__name__)


class StatusWriter(Protocol):
    async def patch_auth_config_status(
        self, namespace: str, name: str, status: Dict[str, Any]
    ) -> None: ...


class AuthConfigStatusUpdater:
    def __init__(
        self,
        reconciler: AuthConfigReconciler,
        writer: StatusWriter,
        leases: Optional[LeaseClient] = None,
        namespace: str = "default",
        identity: Optional[str] = None,
        interval_s: float = 2.0,
        leader_election: bool = True,
        lease_name: Optional[str] = None,
    ):
        self.reconciler = reconciler
        self.writer = writer
        self.interval_s = interval_s
        self._written: Dict[str, Any] = {}
        self._task: Optional[asyncio.Task] = None
        self.elector: Optional[LeaderElector] = None
        if leader_election and leases is not None:
            self.elector = LeaderElector(
                leases,
                identity=identity or f"{socket.gethostname()}-{uuid.uuid4().hex[:8]}",
                namespace=namespace,
                name=lease_name,
                # on leadership change, rewrite everything (a prior leader may
                # have written stale statuses)
                on_started_leading=self._written.clear,
            )

    def _is_writer(self) -> bool:
        return self.elector is None or self.elector.is_leader()

    async def sync_once(self) -> int:
        """Patch statuses that changed since last write; returns #patches."""
        if not self._is_writer():
            return 0
        n = 0
        reports = self.reconciler.status.all()
        # prune deleted configs: a recreated CR must get its status re-patched
        # even when the recomputed status equals the last written one
        for gone in set(self._written) - set(reports):
            del self._written[gone]
        for id_, _report in reports.items():
            status = self.reconciler.status.status_object(id_)
            if self._written.get(id_) == status:
                continue
            ns, _, name = id_.partition("/")
            try:
                await self.writer.patch_auth_config_status(ns, name, status)
                self._written[id_] = status
                n += 1
            except Exception as e:  # retry next tick (ref Requeue:true)
                log.warning("status patch %s failed: %s", id_, e)
        return n

    async def run(self) -> None:
        while True:
            await self.sync_once()
            await asyncio.sleep(self.interval_s)

    def start(self) -> "AuthConfigStatusUpdater":
        loop = asyncio.get_event_loop()
        if self.elector is not None:
            self.elector.start()
        self._task = loop.create_task(self.run())
        return self

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        if self.elector is not None:
            await self.elector.stop()
