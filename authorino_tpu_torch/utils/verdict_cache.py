"""Snapshot-scoped verdict cache: bounded LRU over (cache token, row digest).

Authorization verdicts are pure functions of (compiled snapshot, encoded
operand row) — Cedar (arxiv 2403.04651) and the microservice-auth survey
(arxiv 2009.02114) both identify decision memoization at the enforcement
point as the standard lever for amortizing authz latency, and every
avoided row is a row the card never evaluates.  Keys fold the snapshot's
cache token in (snapshots/fingerprint.py: encoding epoch and config
fingerprint), so invalidation is structural: a snapshot swap that changes
a config or the encoding makes its old entries unreachable (they then age
out of the LRU) — no TTL races with in-flight batches, which insert and
serve under the tokens they were encoded against.

The row digest is the full canonical operand byte string
(compiler/pack.py row_key_bytes): exact, collision-free, and it already
folds in config_id and the host_fallback flag.  Host-fallback rows must
never be cached by callers — their compact encoding is lossy (membership
overflow past K), so the digest does not determine their verdict.

Thread-safe; counters are plain ints read without the lock (GIL-atomic,
monotonic — consumers fold deltas)."""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Hashable, Optional

__all__ = ["VerdictCache"]


class VerdictCache:
    def __init__(self, max_entries: int = 32768):
        self.max_entries = max(1, int(max_entries))
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Hashable, Any]" = OrderedDict()
        # monotonic counters (GIL-atomic increments under the lock;
        # lock-free reads): hits/misses count get(), adds counts distinct
        # put()s, evictions counts LRU drops
        self.hits = 0
        self.misses = 0
        self.adds = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: Hashable) -> Optional[Any]:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return entry

    def put(self, key: Hashable, value: Any) -> None:
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self._entries[key] = value
                return
            self._entries[key] = value
            self.adds += 1
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self.evictions += 1

    def counts(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "adds": self.adds, "evictions": self.evictions,
                "entries": len(self._entries)}

    def hottest(self, k: int) -> list:
        """Top-``k`` (key, value) pairs, most-recently-used first — the
        hot-set export.  The LRU order IS the heat signal this cache
        keeps: the MRU head is exactly the working set a cold replica
        joining mid-flood would otherwise re-miss.
        Values are returned as stored (callers must not mutate them)."""
        if k <= 0:
            return []
        with self._lock:
            out = []
            for key in reversed(self._entries):
                out.append((key, self._entries[key]))
                if len(out) >= k:
                    break
            return out
