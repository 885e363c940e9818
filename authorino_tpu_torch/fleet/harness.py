"""Fleet harness: elastic choreography over N in-process
replicas.

One object owns the whole topology the bench and tier-1 drive: a LEADER
engine that compiles and publishes (snapshots/distribution.py), N serving
replicas that adopt published snapshots (and warm-join the verdict-cache
hot set), the consistent-hash/least-loaded router fronting them, and the
fold aggregator running the global guards.  The harness choreographs the
state changes a real fleet sees:

- **join**: new replica adopts the manifest's ``current`` (the leader's
  serving DECISION — never the newest blob file), then optionally imports
  the published hot-set digest (fleet/warmjoin.py) before taking traffic;
- **leave**: router stops routing first, then the replica drains bounded
  (the SIGTERM choreography — queued work completes, nothing new admits);
- **crash**: health collapses and in-flight checks fail TYPED; the
  router's next decisions route around it and the harness's failover
  retry re-runs the lost requests on the second hash choice;
- **fleet canary**: ONE replica applies the candidate snapshot while the
  fleet holds baseline; every replica's fold deltas feed the global
  CanaryGuard (canary cohort vs fleet baseline); a breach rolls the
  canary back to the manifest and republishes baseline with the
  rollback/quarantine record so the whole fleet — including replicas
  that join later — converges via the manifest.

Every wait in here is bounded (analysis/code_lint.py unbounded-wait:
drain/stop/fleet/replica/router/join functions run exactly when a peer
may be wedged)."""

from __future__ import annotations

import concurrent.futures
import logging
import time
from typing import Any, Callable, Dict, List, Optional

from ..snapshots.distribution import SnapshotPublisher
from ..utils.rpc import UNAVAILABLE, CheckAbort
from . import warmjoin
from .aggregate import FleetAggregator
from .replica import InProcessReplica
from .router import FleetRouter, in_fleet_cohort, routing_key

__all__ = ["FleetHarness"]

log = logging.getLogger(__name__)


class FleetHarness:
    def __init__(self, directory: str,
                 engine_factory: Callable[[], Any],
                 router: Optional[FleetRouter] = None,
                 aggregator: Optional[FleetAggregator] = None,
                 poll_s: float = 0.5):
        self.directory = directory
        self.engine_factory = engine_factory
        self.router = router or FleetRouter()
        self.aggregator = aggregator or FleetAggregator()
        self.poll_s = poll_s
        self.publisher = SnapshotPublisher(directory)
        self.replicas: Dict[str, InProcessReplica] = {}
        self.leader: Optional[InProcessReplica] = None
        self.canary_record: Optional[Dict[str, Any]] = None
        # per-serve observation point: called with the serving replica's
        # name before each submit (both the routed choice and the failover
        # retry).  Harness embeddings use it for per-replica accounting and
        # capacity shaping — the router never sees it.
        self.serve_observer: Optional[Callable[[str], None]] = None

    # -- membership choreography ---------------------------------------------

    def add_leader(self, name: str = "leader",
                   entries: Optional[List[Any]] = None) -> InProcessReplica:
        """The compile leader: serves traffic like any replica, but its
        snapshot swaps publish (publisher attached as a swap listener)."""
        engine = self.engine_factory()
        self.publisher.attach(engine)
        if entries is not None:
            engine.apply_snapshot(entries, override=True)
            self.publisher.flush(timeout_s=10.0)
        replica = InProcessReplica(name, engine)
        self.leader = self.replicas[name] = replica
        self.router.add_replica(name, replica.health)
        return replica

    def add_replica(self, name: str,
                    warm_join: bool = True) -> InProcessReplica:
        """Join: adopt the published snapshot (manifest ``current``), warm
        the verdict cache from the hot-set digest when asked, THEN start
        taking routed traffic."""
        engine = self.engine_factory()
        replica = InProcessReplica(name, engine, source=self.directory,
                                   poll_s=self.poll_s)
        if warm_join:
            replica.warm_join()
        else:
            replica.sync()
        self.replicas[name] = replica
        self.router.add_replica(name, replica.health)
        log.info("replica %s joined (warm=%s, imported=%d)", name,
                 warm_join, replica.warm_imported)
        return replica

    def remove_replica(self, name: str, timeout_s: float = 5.0) -> bool:
        """Graceful leave: unroute first, drain bounded, then forget the
        fold (its rates must stop counting toward global shares)."""
        replica = self.replicas.pop(name, None)
        if replica is None:
            return False
        self.router.remove_replica(name)
        drained = replica.stop(timeout_s=timeout_s)
        self.aggregator.forget(name)
        log.info("replica %s left (drained=%s)", name, drained)
        return drained

    def crash_replica(self, name: str) -> None:
        """Hard death: no unroute, no drain — the router discovers it via
        health on its next decisions and the failover retry absorbs the
        in-flight losses (typed, never raw)."""
        replica = self.replicas.get(name)
        if replica is not None:
            replica.crash()
            self.aggregator.forget(name)

    # -- serving (route + bounded failover) ----------------------------------

    def check(self, config_name: str, doc: Any,
              deadline: Optional[float] = None,
              deadline_budget_s: Optional[float] = None,
              timeout_s: float = 10.0):
        """Route one request and serve it, failing over ONCE to the second
        hash choice when the chosen replica dies mid-flight (typed
        UNAVAILABLE).  Every other typed rejection — admission, tenant
        QoS, deadline — propagates untouched: backpressure must never be
        retried into amplification.

        While a fleet canary is armed, a deterministic hash cohort of the
        traffic (``start_canary(fraction=...)``) is PINNED to the canary
        replica and everything else is kept off it — the traffic split
        that makes canary-vs-baseline folds comparable cohorts instead of
        the canary's (biased) rendezvous share.  A cohort request whose
        canary died mid-flight falls back to normal routing: losing the
        canary must never lose the cohort's traffic."""
        key = routing_key(config_name, doc)
        exclude = None
        rec = self.canary_record
        if rec is not None and rec.get("breach") is None \
                and rec["canary"] in self.replicas:
            canary = rec["canary"]
            canary_rep = self.replicas[canary]
            if not canary_rep.crashed and in_fleet_cohort(
                    key, rec.get("fraction", 0.25)):
                try:
                    return self._serve_on(canary, config_name, doc,
                                          deadline, timeout_s)
                except CheckAbort as e:
                    if e.code != UNAVAILABLE or not canary_rep.crashed:
                        raise
                    self.router.count_failover()
            exclude = canary
        first, second = self.router.route(
            key, deadline_budget_s=deadline_budget_s, exclude=exclude)
        if first is None:
            raise CheckAbort(UNAVAILABLE, "no routable replica")
        try:
            return self._serve_on(first, config_name, doc, deadline,
                                  timeout_s)
        except CheckAbort as e:
            crashed = getattr(self.replicas.get(first), "crashed", False)
            if e.code != UNAVAILABLE or not crashed or second is None:
                raise
            self.router.count_failover()
            return self._serve_on(second, config_name, doc, deadline,
                                  timeout_s)

    def _serve_on(self, name: str, config_name: str, doc: Any,
                  deadline: Optional[float], timeout_s: float):
        replica = self.replicas.get(name)
        if replica is None:
            raise CheckAbort(UNAVAILABLE, f"replica {name} left the fleet")
        if self.serve_observer is not None:
            self.serve_observer(name)
        fut = replica.check(config_name, doc, deadline=deadline)
        try:
            return fut.result(timeout=timeout_s)
        except (TimeoutError, concurrent.futures.TimeoutError):
            fut.cancel()
            raise CheckAbort(UNAVAILABLE,
                             f"replica {name} timed out after {timeout_s}s")

    # -- folds + hot set -----------------------------------------------------

    def publish_folds(self) -> None:
        """One fold cadence tick: every live replica's fold lands in the
        aggregator (a real fleet pushes these over the wire; the shape is
        the contract, not the transport)."""
        for name, replica in list(self.replicas.items()):
            if not replica.crashed:
                self.aggregator.ingest(name, replica.fold())

    def publish_hotset(self, k: int = 1024) -> bool:
        """Fold the leader's verdict-cache hot set into HOTSET.json next
        to the manifest (advisory: stale/missing only costs joiners a
        cold cache)."""
        if self.leader is None:
            return False
        digest = warmjoin.export_hotset(self.leader.engine, k=k)
        if digest is None:
            return False
        self.publisher.publish_hotset(digest)
        return True

    # -- fleet canary --------------------------------------------------------

    def start_canary(self, canary: str, entries: List[Any],
                     changed: Optional[set] = None,
                     thresholds=None, fraction: float = 0.25) -> None:
        """ONE replica applies the candidate corpus while the fleet holds
        baseline; the aggregator's global guard starts judging canary-vs-
        fleet deltas.  ``changed`` is the candidate's changed-config set
        (the selection-bias restriction for the per-config deny guard);
        ``fraction`` is the traffic slice ``check`` pins to the canary
        replica while the guard is armed."""
        replica = self.replicas[canary]
        self.publish_folds()  # watermark: pre-canary counts leak nowhere
        self.aggregator.arm_guard(canary, changed=changed,
                                  thresholds=thresholds)
        replica.engine.apply_snapshot(entries, override=True)
        self.canary_record = {
            "canary": canary,
            "armed_monotonic": time.monotonic(),
            "changed": sorted(changed or ()),
            "fraction": float(fraction),
            "breach": None,
        }

    def canary_tick(self) -> Optional[Dict[str, Any]]:
        """One guard evaluation over the folds published so far.  On
        breach: detection is stamped, the canary rolls back to the
        manifest (baseline), and the leader republishes baseline with the
        rollback/quarantine record — the fleet-wide convergence channel
        (late joiners adopt it from the manifest, never the poison blob).
        Returns the breach record once, then the guard disarms."""
        rec = self.canary_record
        if rec is None or rec.get("breach") is not None:
            return None
        breach = self.aggregator.guard_breach()
        if breach is None:
            return None
        now = time.monotonic()
        rec["breach"] = breach
        rec["detection_s"] = round(now - rec["armed_monotonic"], 6)
        canary = self.replicas.get(rec["canary"])
        if canary is not None and canary.poller is not None:
            # re-adopt the manifest's baseline (digest dedup cleared: the
            # manifest still points at the same baseline blob)
            canary.poller._seen_digest = None
            canary.sync()
        self._republish_rollback(rec, breach)
        rec["mttr_s"] = round(time.monotonic() - now, 6)
        self.aggregator.disarm_guard()
        log.warning("fleet canary breached on %s (%s): rolled back in "
                    "%.3fs", rec["canary"],
                    ",".join(breach.get("guards", [])), rec["mttr_s"])
        return rec

    def _republish_rollback(self, rec: Dict[str, Any],
                            breach: Dict[str, Any]) -> None:
        """Republish baseline with the change-safety record in the
        manifest — same shape the in-engine rollback publishes
        (engine._canary_rollback → swap listener → publisher), so
        replicas and late joiners converge on one channel."""
        if self.leader is None:
            return
        snap = self.leader.engine._snapshot
        if snap is None:
            return
        safety = dict(getattr(snap, "change_safety", None) or {})
        safety["rollback"] = {
            "reason": "fleet-guard-breach",
            "canary_replica": rec["canary"],
            "guards": list(breach.get("guards", [])),
        }
        if rec.get("changed"):
            safety["quarantine"] = {
                "reason": "fleet-guard-breach",
                "configs": list(rec["changed"]),
            }
        snap.change_safety = safety
        try:
            self.publisher.publish_from_engine(self.leader.engine)
        except Exception:
            log.exception("rollback republish failed (fleet converges on "
                          "the prior manifest)")

    # -- lifecycle -----------------------------------------------------------

    def sync_replicas(self) -> int:
        """Drive one manifest poll on every follower (tests/bench run the
        distribution loop by hand for determinism)."""
        n = 0
        for replica in list(self.replicas.values()):
            if not replica.crashed and replica.sync():
                n += 1
        return n

    def shutdown(self, timeout_s: float = 5.0) -> None:
        for name in list(self.replicas):
            replica = self.replicas.pop(name)
            self.router.remove_replica(name)
            if not replica.crashed:
                replica.stop(timeout_s=timeout_s)
        self.leader = None

    def to_json(self) -> Dict[str, Any]:
        return {
            "replicas": {n: r.to_json() for n, r in self.replicas.items()},
            "router": self.router.to_json(),
            "aggregator": self.aggregator.to_json(),
            "canary": self.canary_record,
        }
