"""Ancestor closure of entity→group edges — the host-side half of the
compiled relation tables (the Cedar move from PAPERS.md
arXiv 2403.04651: hierarchical membership is *data*, sliced and closed at
reconcile time, so request-time evaluation is a single table lookup).

An edge ``(child, parent)`` asserts direct membership of ``child`` in
``parent``.  ``contains(entity, group)`` is reachability through one or
more edges — the transitive ancestor closure — computed once by a
monotone bitset fixpoint (cycle-safe: membership only ever grows), so
diamond graphs and deep hierarchies cost the same lookup as flat ones.

The closure is FROZEN after construction and identified by a canonical
digest over its sorted edge set: two configs declaring identical edges
share one compiled table, fingerprints fold the digest (a changed edge
re-certifies exactly the configs reading that relation), and the replica
deserializer rebuilds an identical closure from the serialized edges.

Import-light: stdlib + hashlib only.
"""

from __future__ import annotations

import hashlib
from typing import Dict, FrozenSet, Iterable, List, Sequence, Tuple

__all__ = ["RelationClosure"]


class RelationClosure:
    """Immutable transitive closure of a (child, parent) edge set."""

    __slots__ = ("edges", "digest", "_groups_of", "_entities", "_groups")

    def __init__(self, edges: Iterable[Sequence[str]]):
        canon: List[Tuple[str, str]] = sorted(
            {(str(c), str(p)) for c, p in edges})
        self.edges: Tuple[Tuple[str, str], ...] = tuple(canon)
        h = hashlib.sha256()
        for c, p in canon:
            h.update(c.encode("utf-8", "replace"))
            h.update(b"\x00")
            h.update(p.encode("utf-8", "replace"))
            h.update(b"\x01")
        self.digest: str = h.hexdigest()

        parents: Dict[str, set] = {}
        nodes: set = set()
        for c, p in canon:
            parents.setdefault(c, set()).add(p)
            nodes.add(c)
            nodes.add(p)
        # monotone fixpoint: groups_of[n] ∪= groups_of[parent] until stable.
        # Monotonicity makes cycles harmless (a cycle's members converge on
        # the cycle's union) and diamonds free (sets dedupe the two paths).
        acc: Dict[str, set] = {n: set(parents.get(n, ())) for n in nodes}
        changed = True
        while changed:
            changed = False
            for n in nodes:
                mine = acc[n]
                before = len(mine)
                for p in tuple(mine):
                    up = acc.get(p)
                    if up:
                        mine |= up
                if len(mine) != before:
                    changed = True
        self._groups_of: Dict[str, FrozenSet[str]] = {
            n: frozenset(s) for n, s in acc.items() if s}
        # entities: every node (any node can be queried as an entity);
        # groups: every node that is some edge's parent (a column target)
        self._entities: Tuple[str, ...] = tuple(sorted(nodes))
        self._groups: Tuple[str, ...] = tuple(
            sorted({p for _, p in canon}))

    # -- queries -----------------------------------------------------------

    def groups_of(self, entity: str) -> FrozenSet[str]:
        """All groups ``entity`` belongs to, transitively (empty for
        unknown entities — an unknown principal is in no groups)."""
        return self._groups_of.get(entity, frozenset())

    def contains(self, entity: str, group: str) -> bool:
        return group in self._groups_of.get(entity, ())

    @property
    def entities(self) -> Tuple[str, ...]:
        return self._entities

    @property
    def groups(self) -> Tuple[str, ...]:
        return self._groups

    @property
    def n_edges(self) -> int:
        return len(self.edges)

    def depth(self) -> int:
        """Longest ancestor chain (levels of hierarchy) — reporting only."""
        memo: Dict[str, int] = {}

        def d(n: str, seen: frozenset) -> int:
            if n in memo:
                return memo[n]
            if n in seen:
                return 0  # cycle: bounded
            best = 0
            for c, p in self.edges:
                if c == n:
                    best = max(best, 1 + d(p, seen | {n}))
            memo[n] = best
            return best

        return max((d(e, frozenset()) for e in self._entities), default=0)

    # -- identity ----------------------------------------------------------

    def __eq__(self, other) -> bool:
        return isinstance(other, RelationClosure) and \
            other.digest == self.digest

    def __hash__(self) -> int:
        return hash(self.digest)

    def __repr__(self) -> str:
        return (f"RelationClosure({len(self.edges)} edges, "
                f"{len(self._entities)} entities, "
                f"{len(self._groups)} groups, {self.digest[:12]})")
