"""In-process fleet replica: one engine behind the router's
contract.

A *replica* to the router/harness is four capabilities — serve a check,
report health, publish a fold, drain on request — and this wrapper
provides them over one :class:`~..runtime.engine.PolicyEngine` running its
own event loop on a dedicated thread.  The bench and tier-1 drive N of
these inside one process (real process replicas would publish the same
shapes over HTTP: ``/readyz`` + ``engine.fleet_health()`` for health,
``engine.fleet_fold()`` on a cadence; the router and aggregator consume
dicts and never know the difference).

Crash semantics are the acceptance criterion: ``crash()`` models a replica
dying mid-flight — every subsequent (and in-flight) check resolves to a
TYPED ``CheckAbort(UNAVAILABLE)``, never a raw exception, so the harness's
failover retry and the caller's error taxonomy both stay honest.  Snapshot
adoption goes through the ordinary distribution path
(:class:`~..snapshots.distribution.SnapshotReplica` ``poll_once``), so a
replica joining mid-canary converges on the manifest's ``current`` — the
leader's serving DECISION — never on the newest blob file in the
directory."""

from __future__ import annotations

import asyncio
import threading
from typing import Any, Dict, Optional, Tuple

from ..snapshots.distribution import SnapshotReplica, load_hotset
from ..utils.rpc import UNAVAILABLE, CheckAbort
from . import warmjoin

__all__ = ["InProcessReplica"]


class InProcessReplica:
    """One engine + one event-loop thread, addressable by name."""

    def __init__(self, name: str, engine, source: Optional[str] = None,
                 poll_s: float = 5.0):
        self.name = name
        self.engine = engine
        self.crashed = False
        self.warm_imported = 0
        self.warm_skipped = 0
        # snapshot adoption: the standard replica poller, driven manually
        # (sync()) by the harness so tests/bench stay deterministic; the
        # CLI path starts the background loop instead
        self.poller = (SnapshotReplica(engine, source, poll_s=poll_s)
                       if source else None)
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._serve_loop, name=f"atpu-fleet-{name}", daemon=True)
        self._thread.start()

    # -- serving -------------------------------------------------------------

    def _serve_loop(self) -> None:
        asyncio.set_event_loop(self._loop)
        try:
            self._loop.run_forever()
        finally:
            self._loop.close()

    async def _submit(self, config_name: str, doc: Any,
                      deadline: Optional[float]):
        if self.crashed:
            raise CheckAbort(UNAVAILABLE, f"replica {self.name} crashed")
        result = await self.engine.submit(doc, config_name,
                                          deadline=deadline)
        if self.crashed:
            # died between verdict and response: the caller must see the
            # typed loss, not a verdict the wire never carried
            raise CheckAbort(UNAVAILABLE, f"replica {self.name} crashed")
        return result

    def check(self, config_name: str, doc: Any,
              deadline: Optional[float] = None):
        """Submit one check; returns a concurrent.futures.Future resolving
        to (rule_results, skipped) or raising a typed CheckAbort."""
        if self.crashed:
            raise CheckAbort(UNAVAILABLE, f"replica {self.name} crashed")
        return asyncio.run_coroutine_threadsafe(
            self._submit(config_name, doc, deadline), self._loop)

    # -- the router/aggregator contract --------------------------------------

    def health(self) -> Dict[str, Any]:
        if self.crashed:
            return {"ready": False}
        return self.engine.fleet_health()

    def fold(self) -> Dict[str, Any]:
        return self.engine.fleet_fold()

    # -- snapshot + hot-set adoption -----------------------------------------

    def sync(self) -> bool:
        """One manifest poll-and-apply (True when a new snapshot landed)."""
        if self.poller is None:
            return False
        return self.poller.poll_once()

    def warm_join(self) -> Tuple[int, int]:
        """Adopt the published snapshot, then seed the verdict cache from
        the leader's hot-set digest.  Returns (imported, skipped)."""
        self.sync()
        if self.poller is None:
            return 0, 0
        digest = load_hotset(self.poller.source)
        self.warm_imported, self.warm_skipped = warmjoin.import_hotset(
            self.engine, digest)
        return self.warm_imported, self.warm_skipped

    # -- lifecycle -----------------------------------------------------------

    def crash(self) -> None:
        """Simulate process death: health collapses, every check from now
        on fails typed UNAVAILABLE.  Nothing is drained — that is the
        point."""
        self.crashed = True

    def stop(self, timeout_s: float = 5.0) -> bool:
        """SIGTERM choreography: stop admitting (drain begins), let queued
        work finish (bounded), then stop the loop thread.  Mirrors the
        CLI's drain path; every wait here is bounded by contract
        (analysis/code_lint.py unbounded-wait)."""
        drained = True
        if not self.crashed:
            drained = self.engine.drain(timeout_s=timeout_s)
        if self.poller is not None:
            self.poller.stop(timeout_s=1.0)
        if self._loop.is_running():
            self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=timeout_s)
        return drained

    def to_json(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "crashed": self.crashed,
            "health": self.health(),
            "warm_imported": self.warm_imported,
            "warm_skipped": self.warm_skipped,
            "poller": self.poller.to_json() if self.poller else None,
        }
