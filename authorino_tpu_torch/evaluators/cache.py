"""Per-evaluator TTL cache keyed by a JSONValue resolved against the
Authorization JSON (semantics: ref pkg/evaluators/cache.go:16-89; the
reference uses freecache with a global size flag — here a simple
size-bounded dict with monotonic-clock TTL, which serves the same contract)."""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Optional

from ..authjson.value import JSONValue, stringify_json

__all__ = ["EvaluatorCache", "EVALUATOR_CACHE_MAX_ENTRIES"]

# global knob, the analog of --evaluator-cache-size (ref main.go:228)
EVALUATOR_CACHE_MAX_ENTRIES = 4096


class EvaluatorCache:
    def __init__(self, key_value: JSONValue, ttl_seconds: int, max_entries: Optional[int] = None):
        self._key_value = key_value
        self._ttl = ttl_seconds
        self._max = max_entries or EVALUATOR_CACHE_MAX_ENTRIES
        self._store: "OrderedDict[str, tuple[float, Any]]" = OrderedDict()
        self._lock = threading.Lock()

    @property
    def ttl(self) -> int:
        return self._ttl

    @property
    def key_pattern(self) -> str:
        """The key's selector pattern ("" for static keys) — the native
        frontend checks it for credential equivalence."""
        return getattr(self._key_value, "pattern", "") or ""

    def resolve_key_for(self, auth_json: Any) -> Optional[str]:
        key = self._key_value.resolve_for(auth_json)
        if key is None:
            return None
        return stringify_json(key)

    def get(self, key: Optional[str]) -> Optional[Any]:
        if key is None:
            return None
        now = time.monotonic()
        with self._lock:
            hit = self._store.get(key)
            if hit is None:
                return None
            expires, obj = hit
            if now >= expires:
                del self._store[key]
                return None
            self._store.move_to_end(key)
            return obj

    def remaining(self, key: Optional[str]) -> Optional[float]:
        """Seconds until this key's entry expires, or None when absent or
        expired — a fast-lane entry bounded by it never extends the
        opted-in window."""
        if key is None:
            return None
        now = time.monotonic()
        with self._lock:
            hit = self._store.get(key)
            if hit is None or now >= hit[0]:
                return None
            return hit[0] - now

    def set(self, key: Optional[str], obj: Any) -> None:
        if key is None:
            return
        with self._lock:
            self._store[key] = (time.monotonic() + self._ttl, obj)
            self._store.move_to_end(key)
            while len(self._store) > self._max:
                self._store.popitem(last=False)

    def shutdown(self) -> None:
        with self._lock:
            self._store.clear()
