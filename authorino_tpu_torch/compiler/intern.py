"""String interning — the bridge between string-heavy pattern semantics and
integer tensor compares.

The reference compares gjson-String() renderings per pattern per request
(ref: pkg/jsonexp/expressions.go:59-96).  Here every constant that appears in
any rule is interned to an int32 id at compile time; at request time resolved
attribute values are *looked up* (never inserted), so device-side equality of
ids is exact string equality — no hash-collision false-allows.

Sentinels:
  - id 0 is always the empty string "" (a missing gjson value renders as "")
  - UNSEEN (-2): a request value that matches no rule constant
  - PAD (-3): padding slot in membership vectors (never equals a real id)
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterable, List

__all__ = ["StringInterner", "UNSEEN", "PAD", "EMPTY_ID"]

UNSEEN = -2
PAD = -3
EMPTY_ID = 0

_SERIAL = itertools.count(1)


class StringInterner:
    __slots__ = ("_table", "serial")

    def __init__(self):
        self._table: Dict[str, int] = {"": EMPTY_ID}
        # process-unique, never-reused identity token.  Encoded operand ids
        # only mean the same thing under the SAME interner object (a fresh
        # interner may assign the same id to a different string), so the
        # per-config verdict-cache key folds this serial into its encoding
        # epoch (snapshots/fingerprint.py): a persistent interner keeps
        # cached verdicts reachable across reconciles, a rebuilt one
        # structurally invalidates them.
        self.serial: int = next(_SERIAL)

    def intern(self, s: str) -> int:
        """Compile-time: insert and return the id."""
        i = self._table.get(s)
        if i is None:
            i = len(self._table)
            self._table[s] = i
        return i

    def lookup(self, s: str) -> int:
        """Request-time: id if known, else UNSEEN (cannot equal any constant)."""
        return self._table.get(s, UNSEEN)

    def __len__(self) -> int:
        return len(self._table)

    def reverse(self) -> Dict[int, str]:
        """id → string view (analysis-time only: fingerprints serialize
        constant *strings*, never ids, so they survive interning reorders)."""
        return {i: s for s, i in self._table.items()}

    def freeze_copy(self) -> "StringInterner":
        out = StringInterner()
        out._table = dict(self._table)
        return out

    def content_digest(self) -> str:
        """Content hash of the string→id mapping (insertion order IS the id
        assignment).  The ``serial`` above is identity, deliberately
        process-unique — two replicas deserializing the SAME published
        snapshot get different serials but identical tables, so their
        encoded operand ids (and verdict-cache row keys) agree.  The fleet
        warm-join protocol (fleet/warmjoin.py) keys hot-set portability on
        this digest: same content ⇒ same row-key bytes ⇒ the leader's hot
        verdicts are valid under the joining replica's own epoch."""
        import hashlib

        h = hashlib.sha256()
        for s, i in self._table.items():
            h.update(s.encode("utf-8", "surrogatepass"))
            h.update(b"\x00")
            h.update(str(i).encode("ascii"))
            h.update(b"\x01")
        return h.hexdigest()[:16]
