"""Lease-based leader election.

The reference elects one replica to write AuthConfig statuses through
controller-runtime's leaderelection on a coordination.k8s.io/v1 Lease
(ref: main.go:308-314 enableLeaderElection, RBAC
controllers/auth_config_status_updater.go:31).  This is the same algorithm
implemented against our minimal REST client: acquire the Lease if unheld or
expired, renew every ``renew_interval``, step down when renewal fails.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Protocol

__all__ = ["Lease", "LeaseClient", "InMemoryLeases", "LeaderElector",
           "leader_election_id"]

log = logging.getLogger(__name__)


def leader_election_id(auth_config_label_selector: str = "") -> str:
    """Lease name derived from the watched AuthConfig label selector, so two
    label-sharded instances in one namespace elect independent leaders and
    both shards' statuses get written (ref: main.go LeaderElectionID =
    sha256(watchedAuthConfigLabelSelector)[:8 hex] + suffix)."""
    digest = hashlib.sha256(auth_config_label_selector.encode("utf-8")).hexdigest()
    return f"{digest[:8]}.authorino.kuadrant.io"


@dataclass
class Lease:
    holder: str
    acquire_time: float
    renew_time: float
    duration_s: float
    transitions: int = 0
    released: bool = False  # voluntary give-up: backends persist it as expired

    def expired(self, now: float) -> bool:
        return self.released or now - self.renew_time > self.duration_s


class LeaseClient(Protocol):
    async def get_lease(self, namespace: str, name: str) -> Optional[Lease]: ...
    async def put_lease(self, namespace: str, name: str, lease: Lease) -> bool:
        """Create-or-replace; returns False on conflict (someone else won)."""
        ...


class InMemoryLeases:
    """Test/standalone lease store with compare-and-swap semantics."""

    def __init__(self):
        self._leases: Dict[tuple, Lease] = {}
        self._lock = asyncio.Lock()

    async def get_lease(self, namespace: str, name: str) -> Optional[Lease]:
        return self._leases.get((namespace, name))

    async def put_lease(self, namespace: str, name: str, lease: Lease) -> bool:
        async with self._lock:
            cur = self._leases.get((namespace, name))
            now = time.monotonic()
            if cur is not None and cur.holder != lease.holder and not cur.expired(now):
                return False
            self._leases[(namespace, name)] = lease
            return True


class LeaderElector:
    """Run loop: try to acquire/renew the lease; fire callbacks on
    transitions.  ``is_leader()`` gates status writes."""

    def __init__(
        self,
        leases: LeaseClient,
        identity: str,
        namespace: str = "default",
        name: Optional[str] = None,
        duration_s: float = 15.0,
        renew_interval: Optional[float] = None,
        renew_deadline_s: Optional[float] = None,
        on_started_leading: Optional[Callable[[], None]] = None,
        on_stopped_leading: Optional[Callable[[], None]] = None,
    ):
        self.leases = leases
        self.identity = identity
        self.namespace = namespace
        self.name = name if name is not None else leader_election_id()
        self.duration_s = duration_s
        # client-go defaults: renewDeadline (10s) strictly inside
        # leaseDuration (15s) and retryPeriod (2s) inside renewDeadline —
        # so a partitioned leader demotes itself before any follower can
        # legally acquire the expired lease.  Defaults scale with
        # duration_s so short test leases stay valid without extra args.
        self.renew_interval = (
            renew_interval if renew_interval is not None else duration_s * 2.0 / 15.0
        )
        self.renew_deadline_s = (
            renew_deadline_s if renew_deadline_s is not None else duration_s * 2.0 / 3.0
        )
        # client-go rejects these at construction (leaderelection.go config
        # validation): a deadline at/after lease expiry voids the "demote
        # strictly before a follower can acquire" invariant
        if self.renew_deadline_s >= duration_s:
            raise ValueError(
                f"renew_deadline_s ({self.renew_deadline_s}) must be < "
                f"duration_s ({duration_s})"
            )
        if self.renew_interval >= self.renew_deadline_s:
            raise ValueError(
                f"renew_interval ({self.renew_interval}) must be < "
                f"renew_deadline_s ({self.renew_deadline_s})"
            )
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self._leading = False
        self._last_renew = 0.0
        self._task: Optional[asyncio.Task] = None

    def is_leader(self) -> bool:
        return self._leading

    async def try_acquire_or_renew(self) -> bool:
        now = time.monotonic()
        try:
            cur = await self.leases.get_lease(self.namespace, self.name)
            if cur is not None and cur.holder != self.identity and not cur.expired(now):
                self._set_leading(False)
                return False
            lease = Lease(
                holder=self.identity,
                acquire_time=cur.acquire_time if cur and cur.holder == self.identity else now,
                renew_time=now,
                duration_s=self.duration_s,
                transitions=(cur.transitions + 1) if cur and cur.holder != self.identity else (cur.transitions if cur else 0),
            )
            if cur is not None:
                # optimistic concurrency: the PUT must CAS on the version we
                # read, or two candidates racing an expired lease both win
                rv = getattr(cur, "_resource_version", None)
                if rv is not None:
                    lease._resource_version = rv  # type: ignore[attr-defined]
            ok = await self.leases.put_lease(self.namespace, self.name, lease)
            if ok:
                self._last_renew = now
            self._set_leading(bool(ok))
            return bool(ok)
        except Exception as e:  # API unreachable — retryable while leading
            log.warning("lease renew failed: %s", e)
            # renew-deadline semantics (client-go): a transient API error
            # does not demote the leader — no other replica can take the
            # still-unexpired lease, and demoting leaves zero status
            # writers.  Step down at the renew deadline, strictly before
            # lease expiry, so a partitioned leader never overlaps a
            # follower that legally acquires the expired lease.
            # re-read the clock: time blocked inside the failed API call
            # counts against the deadline (a request that hangs past lease
            # expiry must demote NOW, not one cycle later)
            if (
                self._leading
                and time.monotonic() - self._last_renew <= self.renew_deadline_s
            ):
                return True
            self._set_leading(False)
            return False

    def _set_leading(self, leading: bool) -> None:
        if leading and not self._leading:
            log.info("leader election: %s started leading", self.identity)
            if self.on_started_leading:
                self.on_started_leading()
        elif not leading and self._leading:
            log.info("leader election: %s stopped leading", self.identity)
            if self.on_stopped_leading:
                self.on_stopped_leading()
        self._leading = leading

    async def run(self) -> None:
        try:
            while True:
                await self.try_acquire_or_renew()
                await asyncio.sleep(self.renew_interval)
        finally:
            await self.release()

    def start(self) -> "LeaderElector":
        self._task = asyncio.get_event_loop().create_task(self.run())
        return self

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def release(self) -> None:
        """Voluntarily give up the lease (fast failover on clean shutdown)."""
        if not self._leading:
            return
        try:
            cur = await self.leases.get_lease(self.namespace, self.name)
            if cur is not None and cur.holder == self.identity:
                # mark expired so the next candidate can take it immediately
                cur.renew_time = time.monotonic() - cur.duration_s - 1
                cur.released = True
                await self.leases.put_lease(self.namespace, self.name, cur)
        except Exception:
            pass
        self._set_leading(False)
