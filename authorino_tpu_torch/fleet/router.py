"""Fleet router shim: consistent-hash / least-loaded hybrid.

One router fronts N replicas.  Placement is rendezvous (highest-random-
weight) hashing over the request's ROUTING KEY — a stable digest of
(config, canonical authorization JSON), the request-side proxy for the
verdict-cache row key (compiler/pack.py row_key_bytes needs the compiled
snapshot to encode; the routing key is computable before any replica is
chosen and is constant for byte-identical requests, which is exactly the
property dedup and cache locality need: the same request always lands on
the same replica, so its verdict is cached ONCE fleet-wide instead of N
times).

Pure placement is not enough under skew, so each decision considers the
top-TWO rendezvous choices and may take the second:

- **unhealthy**: the first choice is not ready / draining / breaker-open;
- **spillover** (deadline-aware): the first choice's predicted queue wait
  cannot meet the request deadline but the second's can — latency rescue
  beats cache affinity for a deadline-critical request;
- **load-shift** (least-loaded hybrid): the first choice's backlog
  exceeds the second's by ``load_factor``× past ``min_shift_depth`` —
  power-of-two-choices bounded to the two hash choices, so even shifted
  traffic stays within the key's small candidate set (cache entries
  concentrate on two replicas, never spray over N).

Health is consumed as a dict in the `/readyz` + admission/breaker shape
(service/http_server.py readyz; runtime/admission.py health_signal) —
in-process replicas (fleet/replica.py) and process replicas polled over
HTTP publish the identical shape, so the router never knows the
difference.  Import-light: stdlib only."""

from __future__ import annotations

import hashlib
import json
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils import metrics as metrics_mod

__all__ = ["FleetRouter", "in_fleet_cohort", "routing_key"]


def routing_key(config_name: str, doc: Any) -> bytes:
    """Stable routing key of one request: config identity + the canonical
    JSON rendering of its authorization document.  Byte-identical requests
    (the dedup/cache population) get identical keys on every replica and
    every retry — no per-request randomness, no sticky state."""
    try:
        canon = json.dumps(doc, sort_keys=True, separators=(",", ":"),
                           default=str)
    except Exception:
        canon = repr(doc)
    return ("%s\x00%s" % (config_name, canon)).encode("utf-8", "replace")


def in_fleet_cohort(key: bytes, fraction: float) -> bool:
    """Deterministic canary-cohort membership of one ROUTING KEY: while a
    fleet canary is armed the harness pins this slice of traffic to the
    canary replica and keeps the rest off it.  Hashed with its own salt —
    never the rendezvous placement scores — so cohort membership is
    independent of which replica the key would otherwise land on (a
    placement-correlated cohort would canary only the canary replica's
    own hash share, a biased sample)."""
    h = hashlib.blake2b(key, key=b"fleet-canary-cohort", digest_size=8)
    return int.from_bytes(h.digest(), "big") % 10000 < round(
        max(0.0, min(1.0, float(fraction))) * 10000)


def _score(key: bytes, replica: str) -> int:
    """Rendezvous weight of (key, replica): each replica scores every key
    independently, so adding/removing a replica only moves the keys whose
    argmax changed — 1/N of the keyspace, the consistent-hash property."""
    h = hashlib.blake2b(key, key=replica.encode("utf-8", "replace")[:64],
                        digest_size=8)
    return int.from_bytes(h.digest(), "big")


class FleetRouter:
    """Routing decisions over a live replica set.

    Replicas register with a ``health`` callable returning the /readyz-
    shaped dict (``ready``, ``draining``, ``breaker_open``, ``overloaded``,
    ``queue_depth``, ``predicted_wait_s``).  ``route`` returns the chosen
    replica name plus the second choice (the caller's failover target when
    the chosen replica dies mid-flight), or (None, None) when nothing is
    routable."""

    def __init__(self, load_factor: float = 2.0, min_shift_depth: int = 8,
                 deadline_slack_s: float = 0.0):
        self.load_factor = max(1.0, float(load_factor))
        self.min_shift_depth = max(1, int(min_shift_depth))
        self.deadline_slack_s = float(deadline_slack_s)
        self._lock = threading.Lock()
        self._health: Dict[str, Callable[[], Dict[str, Any]]] = {}
        self.outcomes: Dict[str, int] = {}
        self._c_routed = {
            o: metrics_mod.fleet_routed.labels(o)
            for o in ("primary", "spillover", "load-shift", "unhealthy",
                      "failover", "no-replica")}

    # -- membership ---------------------------------------------------------

    def add_replica(self, name: str,
                    health: Callable[[], Dict[str, Any]]) -> None:
        with self._lock:
            self._health[name] = health
        self._refresh_gauges()

    def remove_replica(self, name: str) -> None:
        with self._lock:
            self._health.pop(name, None)
        self._refresh_gauges()

    def replicas(self) -> List[str]:
        with self._lock:
            return sorted(self._health)

    def _refresh_gauges(self) -> None:
        states = {"ready": 0, "draining": 0, "down": 0}
        for h in self._snapshot_health().values():
            if h.get("draining"):
                states["draining"] += 1
            elif h.get("ready"):
                states["ready"] += 1
            else:
                states["down"] += 1
        for state, n in states.items():
            metrics_mod.fleet_replicas.labels(state).set(n)

    def _snapshot_health(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            providers = dict(self._health)
        out: Dict[str, Dict[str, Any]] = {}
        for name, provider in providers.items():
            try:
                out[name] = provider() or {}
            except Exception:
                # a health probe that raises is a down replica, not a
                # router failure
                out[name] = {"ready": False}
        return out

    # -- the decision -------------------------------------------------------

    @staticmethod
    def _routable(h: Dict[str, Any]) -> bool:
        return bool(h.get("ready")) and not h.get("draining") \
            and not h.get("breaker_open")

    def _count(self, outcome: str) -> None:
        self.outcomes[outcome] = self.outcomes.get(outcome, 0) + 1
        self._c_routed[outcome].inc()

    def route(self, key: bytes, deadline_budget_s: Optional[float] = None,
              exclude: Optional[str] = None,
              ) -> Tuple[Optional[str], Optional[str]]:
        """Pick (replica, failover replica) for one routing key.
        ``deadline_budget_s`` is the request's remaining budget (seconds);
        when given, a first choice whose predicted wait eats the budget
        spills to the second choice if that one can still make it.
        ``exclude`` removes one replica from consideration entirely —
        caller policy (the fleet canary keeps non-cohort traffic off the
        canary replica), not ill health, so exclusion never counts as an
        `unhealthy` outcome."""
        health = self._snapshot_health()
        ranked = sorted(health, key=lambda n: _score(key, n), reverse=True)
        if exclude is not None:
            ranked = [n for n in ranked if n != exclude]
        candidates = [n for n in ranked if self._routable(health[n])]
        if not candidates:
            self._count("no-replica")
            return None, None
        first = candidates[0]
        second = candidates[1] if len(candidates) > 1 else None
        if first != ranked[0]:
            # the hash's first choice was unroutable — affinity already
            # lost, serve from the best routable candidate
            self._count("unhealthy")
            return first, second
        if second is not None:
            fh, sh = health[first], health[second]
            if deadline_budget_s is not None:
                fw = float(fh.get("predicted_wait_s") or 0.0)
                sw = float(sh.get("predicted_wait_s") or 0.0)
                budget = deadline_budget_s - self.deadline_slack_s
                if fw >= budget > sw:
                    self._count("spillover")
                    return second, first
            fd = int(fh.get("queue_depth") or 0)
            sd = int(sh.get("queue_depth") or 0)
            if fd >= self.min_shift_depth and fd > self.load_factor * \
                    max(sd, 1):
                self._count("load-shift")
                return second, first
        self._count("primary")
        return first, second

    def count_failover(self) -> None:
        """The caller re-routed after its chosen replica failed typed
        mid-flight (crash between the health snapshot and the submit)."""
        self._count("failover")

    def to_json(self) -> Dict[str, Any]:
        health = self._snapshot_health()
        return {
            "replicas": {n: {
                "ready": bool(h.get("ready")),
                "draining": bool(h.get("draining")),
                "breaker_open": bool(h.get("breaker_open")),
                "queue_depth": int(h.get("queue_depth") or 0),
                "predicted_wait_s": round(
                    float(h.get("predicted_wait_s") or 0.0), 6),
            } for n, h in sorted(health.items())},
            "load_factor": self.load_factor,
            "min_shift_depth": self.min_shift_depth,
            "outcomes": dict(self.outcomes),
        }
