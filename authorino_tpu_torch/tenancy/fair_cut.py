"""Weighted-fair batch cuts: deficit-round-robin INSIDE the
engine's submit-queue cut — fairness is a property of the cut, not a
pre-queue.

The engine's dispatcher used to pop the leftmost ``n`` requests per cut.
Under a hot-tenant burst that is strictly FIFO-unfair: the hot tenant's
standing queue fills every batch and a cold tenant's lone request waits out
the entire hot backlog.  The fair cutter replaces the pop with a
deficit-round-robin selection over per-tenant virtual queues (materialized
from the one real deque at cut time — requests never migrate between
queues, so arrival order within a tenant is preserved exactly):

- each backlogged tenant accrues ``quantum x weight`` deficit per round and
  takes rows while its deficit covers them (row cost 1);
- the cut loops rounds until ``n`` rows are selected or the queue is empty —
  WORK-CONSERVING by construction: unused share spills to whoever is still
  backlogged, and a sole-backlogged tenant always gets the whole batch;
- deficits PERSIST across cuts while a tenant stays backlogged (share
  accuracy converges within one batch of slack) and reset when its virtual
  queue empties (classic DRR — an idle tenant cannot bank credit into a
  later burst);
- the selected rows keep their ARRIVAL order inside the batch, and the
  unselected remainder keeps its arrival order in the queue — fairness
  reorders service, it never re-decides anything (the kernel is a pure
  per-row function; tests pin byte-identical verdict + attribution vs the
  unfair cut).

Cost: one pass over the queue per cut, O(depth) — and the cutter only runs
when the cut is actually contended (depth > n); an uncontended cut takes
everything, exactly like the unfair pop.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable, Dict, List

__all__ = ["FairCutter"]


def _tenant_of(p: Any) -> str:
    return p.config_name


class FairCutter:
    """Deficit-round-robin cut over the engine's pending deque.

    ``cut(queue, n)`` MUTATES the deque: selected items are removed (and
    returned in arrival order), the rest stay queued in arrival order.
    Callers hold the queue lock; the cutter's own state (the persistent
    deficit table) has its own lock only for introspection safety."""

    def __init__(self, weight_of: Callable[[str], float],
                 quantum: float = 1.0, max_tenants: int = 4096):
        self.weight_of = weight_of
        self.quantum = max(float(quantum), 1e-6)
        self.max_tenants = int(max_tenants)
        self._deficit: Dict[str, float] = {}
        # persistent round-robin pointer: the tenant AFTER the one the
        # previous cut's boundary landed on starts the next cut — without
        # it, every cut would restart the round at the same tenant and the
        # boundary would systematically truncate the late tenants' share
        # (an ~0.5-row-per-cut bias the share-accuracy property test
        # catches over a few dozen cuts)
        self._last_served: str = ""
        self._lock = threading.Lock()
        self.cuts = 0
        self.contended_cuts = 0

    def cut(self, queue: deque, n: int) -> List[Any]:
        """Select up to ``n`` items from ``queue`` by weighted fair share."""
        self.cuts += 1
        depth = len(queue)
        if depth <= n:
            # uncontended: take everything (the unfair pop's exact result)
            out = list(queue)
            queue.clear()
            return out
        self.contended_cuts += 1
        # materialize per-tenant virtual queues (item order = arrival order)
        per: Dict[str, List[Any]] = {}
        arrival: List[Any] = list(queue)
        for p in arrival:
            per.setdefault(_tenant_of(p), []).append(p)
        with self._lock:
            deficit = self._deficit
            # round-robin over a stable tenant order; rounds continue until
            # the cut is full — work conserving
            heads: Dict[str, int] = {t: 0 for t in per}
            selected: set = set()
            taken = 0
            active = [t for t in per]
            if self._last_served in per:
                i = active.index(self._last_served) + 1
                active = active[i:] + active[:i]
            while taken < n and active:
                progressed = False
                still = []
                for t in active:
                    q = per[t]
                    h = heads[t]
                    if h >= len(q):
                        # virtual queue drained inside this cut: classic
                        # DRR deficit reset (no banking)
                        deficit.pop(t, None)
                        continue
                    # weight floor 0.05: a pathologically tiny weight must
                    # not turn one row into hundreds of accrual rounds
                    d = deficit.get(t, 0.0) + self.quantum * \
                        max(self.weight_of(t), 0.05)
                    while h < len(q) and d >= 1.0 and taken < n:
                        selected.add(id(q[h]))
                        h += 1
                        d -= 1.0
                        taken += 1
                        progressed = True
                        self._last_served = t
                    heads[t] = h
                    if h >= len(q):
                        # drained by this round: reset, nothing to carry
                        deficit.pop(t, None)
                    else:
                        deficit[t] = d
                        still.append(t)
                    if taken >= n:
                        break
                active = still
                if not progressed and active:
                    # every active tenant is below one row of deficit:
                    # loop again (each round adds quantum x weight) — with
                    # quantum >= 1 this cannot happen, but guard float dust
                    continue
            # tenants that left the queue entirely drop their deficit so
            # the table stays bounded by live tenants
            if len(deficit) > self.max_tenants:
                for t in list(deficit):
                    if t not in per:
                        deficit.pop(t, None)
        batch = [p for p in arrival if id(p) in selected]
        queue.clear()
        queue.extend(p for p in arrival if id(p) not in selected)
        return batch

    def to_json(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "quantum": self.quantum,
                "cuts": self.cuts,
                "contended_cuts": self.contended_cuts,
                "tenants_with_deficit": len(self._deficit),
            }
