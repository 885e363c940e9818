"""Host → AuthConfig index: radix tree over reversed dot-separated host
labels with ``*`` wildcard lookup walking upward
(semantics: ref pkg/index/index.go:37-243).

Thread-safe via an RLock (reconcilers swap entries from worker threads while
the asyncio serving loop reads).  The engine builds a
fresh index with every snapshot and swaps the two together
(runtime/engine.py)."""

from __future__ import annotations

import threading
from typing import Dict, Generic, List, Optional, Tuple, TypeVar

__all__ = ["HostIndex", "IndexError_"]

T = TypeVar("T")


class IndexError_(Exception):
    """Host already taken by another AuthConfig (ref pkg/index/index.go:181)."""


class _Node(Generic[T]):
    __slots__ = ("label", "entry_id", "entry", "parent", "children")

    def __init__(self, label: str, parent: Optional["_Node[T]"]):
        self.label = label
        self.parent = parent
        self.children: Dict[str, _Node[T]] = {}
        self.entry_id: Optional[str] = None
        self.entry: Optional[T] = None


def _revert(key: str) -> List[str]:
    """host labels reversed, rooted at "" (ref :236-243)."""
    labels = key.split(".")
    labels.append("")
    return labels[::-1]


class HostIndex(Generic[T]):
    """``Set/Get/Delete/DeleteKey/List/Empty/FindId/FindKeys``
    (iface: ref pkg/index/index.go:16-26)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._root: _Node[T] = _Node("", None)
        self._keys: Dict[str, List[str]] = {}

    # ---- lookups ---------------------------------------------------------

    def get(self, key: str) -> Optional[T]:
        with self._lock:
            node = self._get_node(key)
            return node.entry if node else None

    def find_id(self, key: str) -> Optional[str]:
        with self._lock:
            node = self._get_node(key)
            return node.entry_id if node else None

    def find_keys(self, id_: str) -> List[str]:
        with self._lock:
            return list(self._keys.get(id_, []))

    def list(self) -> List[T]:
        with self._lock:
            out: List[T] = []
            stack = [self._root]
            while stack:
                n = stack.pop()
                if n.entry is not None:
                    out.append(n.entry)
                stack.extend(n.children.values())
            return out

    def empty(self) -> bool:
        with self._lock:
            return not self._keys

    # ---- mutations -------------------------------------------------------

    def set(self, id_: str, key: str, config: T, override: bool = False) -> None:
        with self._lock:
            node, tail = self._longest_common(_revert(key))
            if not tail:
                if node.entry is not None and not override:
                    raise IndexError_(f"authconfig already exists in the index: {key}")
            else:
                for label in tail:
                    child = _Node(label, node)
                    node.children[label] = child
                    node = child
            node.entry_id = id_
            node.entry = config
            self._keys.setdefault(id_, [])
            if key not in self._keys[id_]:
                self._keys[id_].append(key)

    def delete(self, id_: str) -> None:
        with self._lock:
            for key in self._keys.pop(id_, []):
                self._delete_key(id_, key)

    def delete_key(self, id_: str, key: str) -> None:
        with self._lock:
            self._delete_key(id_, key)
            if id_ in self._keys and key in self._keys[id_]:
                self._keys[id_].remove(key)
                if not self._keys[id_]:
                    del self._keys[id_]

    # ---- internals -------------------------------------------------------

    def _delete_key(self, id_: str, key: str) -> None:
        node, tail = self._longest_common(_revert(key))
        if not tail and node.entry is not None and node.entry_id == id_:
            node.entry = None
            node.entry_id = None

    def _get_node(self, key: str) -> Optional[_Node[T]]:
        node, tail = self._longest_common(_revert(key))
        # exact match
        if not tail and node.entry is not None:
            return node
        # wildcard lookup upward until the root (ref :161-173)
        curr: Optional[_Node[T]] = node
        while curr is not None:
            child = curr.children.get("*")
            if child is not None and child.entry is not None:
                return child
            curr = curr.parent
        return None

    def _longest_common(self, labels: List[str]) -> Tuple[_Node[T], List[str]]:
        node = self._root
        i = 1  # labels[0] is the "" root
        while i < len(labels):
            child = node.children.get(labels[i])
            if child is None:
                break
            node = child
            i += 1
        return node, labels[i:]
