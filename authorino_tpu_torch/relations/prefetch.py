"""Metadata prefetch cache: pin request-independent external
metadata/OIDC documents at reconcile cadence so metadata-dependent configs
stop being automatic slow-lane residents.

The microservice-auth survey (PAPERS.md arXiv 2009.02114) frames the
problem: a shared PDP must not pay a per-request external-document fetch on
its hot path.  Most real metadata evaluators fetch a REQUEST-INDEPENDENT
document (a static JWKS/OIDC discovery doc, a feature-flag set, an org
policy blob): their endpoint/body/params/headers templates reference no
selectors, so the document is a pure function of the reconcile-time config.
Those are *prefetchable*: a background refresher snapshots them once per
refresh interval and the serving path reads the pinned copy.

Exactness/staleness contract:

  - a PINNED document within ``max_age_s`` serves with zero network I/O
    (counted ``hit``); the pipeline's metadata phase sees exactly what a
    live fetch at pin time returned
  - a stale or never-fetched document falls through, TYPED, to the live
    evaluator call (counted ``stale``/``miss``) — the slow lane remains
    the correctness backstop, prefetch is purely a latency/lane dial
  - request-DEPENDENT evaluators (UserInfo, UMA, templated endpoints,
    per-request conditions/caches) are never prefetchable and keep the
    metadata-dependency slow-lane classification

Each pinned document carries a canonical sha256 digest; the capture log
stamps it per decision (``metadata_doc_digest``) so replays are
reproducible (docs/replay.md).
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["MetadataPrefetcher", "PrefetchedDoc", "mark_prefetchable",
           "is_prefetchable", "doc_digest"]

log = logging.getLogger("authorino_tpu_torch.prefetch")


def doc_digest(doc: Any) -> str:
    """Canonical digest of one (JSON-safe) metadata document set."""
    try:
        payload = json.dumps(doc, sort_keys=True, separators=(",", ":"),
                             default=str)
    except Exception:
        payload = repr(doc)
    return hashlib.sha256(payload.encode("utf-8", "replace")).hexdigest()


def _static_value(v: Any) -> bool:
    """True when a JSONValue-shaped object resolves independently of the
    request document (no selector pattern)."""
    return v is None or not getattr(v, "pattern", "")


def is_prefetchable(conf: Any) -> bool:
    """A MetadataConfig is prefetchable iff its evaluator is a GenericHttp
    whose request is a pure function of the reconcile-time config: static
    endpoint/body, static parameters and headers, no `when` conditions and
    no per-request evaluator cache key.  OAuth2 client-credentials and
    shared-secret auth are request-independent and allowed.  Duck-typed on
    shape, not class, so the analysis layer stays import-light."""
    if getattr(conf, "conditions", None) is not None:
        return False
    if getattr(conf, "cache", None) is not None:
        return False
    ev = getattr(conf, "evaluator", None)
    if ev is None or getattr(conf, "type", "") != "METADATA_GENERIC_HTTP":
        return False
    if not _static_value(getattr(ev, "endpoint", None)):
        return False
    if not _static_value(getattr(ev, "body", None)):
        return False
    for p in list(getattr(ev, "parameters", None) or ()) + list(
            getattr(ev, "headers", None) or ()):
        if not _static_value(getattr(p, "value", None)):
            return False
    return True


def mark_prefetchable(conf: Any) -> bool:
    """Stamp the prefetchability bit on a MetadataConfig at translate time
    (the lowerability classifier and the engine's prefetcher both read the
    plain attribute — no imports on their side)."""
    ok = is_prefetchable(conf)
    conf.prefetchable = ok
    conf.prefetch_pinned = False  # set by MetadataPrefetcher.reconcile
    return ok


class PrefetchedDoc:
    __slots__ = ("doc", "digest", "fetched_at", "error")

    def __init__(self, doc: Any, fetched_at: float,
                 error: Optional[str] = None):
        self.doc = doc
        self.digest = doc_digest(doc) if error is None else ""
        self.fetched_at = fetched_at
        self.error = error


class _StubPipeline:
    """The document context a prefetch fetch runs against: an EMPTY
    authorization JSON — prefetchable evaluators never read it (that is
    the definition), a misclassified one would resolve selectors to ""
    and produce a wrong pin, which is why is_prefetchable is conservative."""

    def __init__(self):
        self._doc: Dict[str, Any] = {"auth": {"identity": None,
                                              "metadata": {}}}
        self.span = None

    def authorization_json(self) -> Dict[str, Any]:
        return self._doc


class MetadataPrefetcher:
    """Background refresher + pinned-document cache.

    ``reconcile(entries)`` (engine swap path) registers every prefetchable
    metadata evaluator of the snapshot, binds the serving-side lookup onto
    the MetadataConfig (``conf.prefetch = (self, key)``), and triggers an
    asynchronous refresh; ``refresh_s`` re-pins on a cadence after that.
    ``fetcher`` is injectable for tests (default: run the evaluator's own
    ``call`` on a private asyncio loop thread)."""

    def __init__(self, max_age_s: float = 300.0, refresh_s: float = 60.0,
                 fetcher=None, fetch_timeout_s: float = 10.0):
        self.max_age_s = float(max_age_s)
        self.refresh_s = float(refresh_s)
        self.fetch_timeout_s = float(fetch_timeout_s)
        self._fetcher = fetcher
        self._lock = threading.Lock()
        self._registry: Dict[Tuple[str, str], Any] = {}   # key -> evaluator
        self._docs: Dict[Tuple[str, str], PrefetchedDoc] = {}
        self._counters = {"hit": 0, "miss": 0, "stale": 0,
                          "refresh": 0, "error": 0}
        self._thread: Optional[threading.Thread] = None
        self._wake = threading.Event()
        self._stop = False

    # -- registration ------------------------------------------------------

    def reconcile(self, entries) -> int:
        """Register the snapshot's prefetchable metadata evaluators and
        wake the refresher.  Returns the number of registered documents;
        stamps ``prefetch_pinned`` on each registered MetadataConfig (the
        bit the lowerability classifier lifts the exile on)."""
        registry: Dict[Tuple[str, str], Any] = {}
        for entry in entries:
            runtime = getattr(entry, "runtime", None)
            for conf in (getattr(runtime, "metadata", None) or ()):
                if not getattr(conf, "prefetchable", False):
                    continue
                key = (str(getattr(entry, "id", "")), str(conf.name))
                registry[key] = conf.evaluator
                conf.prefetch = (self, key)
                conf.prefetch_pinned = True
        with self._lock:
            self._registry = registry
            self._docs = {k: v for k, v in self._docs.items()
                          if k in registry}
        if registry:
            self._ensure_thread()
            self._wake.set()
        return len(registry)

    # -- serving -----------------------------------------------------------

    def lookup(self, key: Tuple[str, str]) -> Optional[PrefetchedDoc]:
        """The hot-path read: the pinned document, or None (miss/stale/
        failed pin) — the caller falls through to the live fetch."""
        from ..utils import metrics as metrics_mod

        with self._lock:
            rec = self._docs.get(key)
        if rec is None or rec.error is not None:
            self._count("miss")
            metrics_mod.metadata_prefetch.labels("miss").inc()
            return None
        if time.monotonic() - rec.fetched_at > self.max_age_s:
            self._count("stale")
            metrics_mod.metadata_prefetch.labels("stale").inc()
            return None
        self._count("hit")
        metrics_mod.metadata_prefetch.labels("hit").inc()
        return rec

    def digest_for(self, config_id: str) -> Optional[str]:
        """Combined digest of every pinned document of one config — the
        ``metadata_doc_digest`` stamped into capture records."""
        with self._lock:
            parts = sorted(
                (k[1], rec.digest) for k, rec in self._docs.items()
                if k[0] == config_id and rec.error is None)
        if not parts:
            return None
        return hashlib.sha256(repr(parts).encode()).hexdigest()

    # -- refresh -----------------------------------------------------------

    def refresh(self) -> Dict[str, int]:
        """Fetch every registered document once, synchronously (callers:
        the refresher thread, tests, and the analysis CLI)."""
        from ..utils import metrics as metrics_mod

        with self._lock:
            items = list(self._registry.items())
        ok = err = 0
        for key, evaluator in items:
            now = time.monotonic()
            try:
                doc = self._fetch(evaluator)
                rec = PrefetchedDoc(doc, now)
                ok += 1
                metrics_mod.metadata_prefetch.labels("refresh").inc()
            except Exception as e:  # typed miss at serve time, never a raise
                err += 1
                self._count("error")
                metrics_mod.metadata_prefetch.labels("error").inc()
                log.warning("metadata prefetch of %s failed: %s", key, e)
                with self._lock:
                    prev = self._docs.get(key)
                    if prev is not None and prev.error is None:
                        # a transient re-pin failure must NOT evict a
                        # still-healthy pin: it keeps serving (with its
                        # original fetched_at) until the staleness bound —
                        # the contract the error metric documents
                        continue
                    rec = PrefetchedDoc(None, now, error=str(e))
                    if key in self._registry:
                        self._docs[key] = rec
                continue
            with self._lock:
                if key in self._registry:
                    self._docs[key] = rec
        self._count("refresh")
        with self._lock:
            metrics_mod.metadata_prefetch_docs.set(
                sum(1 for r in self._docs.values() if r.error is None))
        return {"ok": ok, "error": err}

    def _fetch(self, evaluator) -> Any:
        if self._fetcher is not None:
            return self._fetcher(evaluator)
        # run the evaluator's own async call on a private loop: the
        # refresher thread owns it, nothing here touches the serving loops
        return asyncio.run(asyncio.wait_for(
            evaluator.call(_StubPipeline()), self.fetch_timeout_s))

    def _ensure_thread(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop = False
        self._thread = threading.Thread(
            target=self._loop, name="atpu-md-prefetch", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop:
            self._wake.wait(timeout=self.refresh_s)
            self._wake.clear()
            if self._stop:
                return
            try:
                self.refresh()
            except Exception:
                log.exception("metadata prefetch refresh failed")

    def stop(self, timeout_s: float = 2.0) -> None:
        self._stop = True
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout_s)

    # -- reporting ---------------------------------------------------------

    def _count(self, key: str) -> None:
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + 1

    def export_docs(self) -> Dict[str, Dict[str, Any]]:
        """{config_id: {metadata_name: document}} of every healthy pin —
        what `analysis --replay ... --metadata-docs` consumes to un-blind
        the replay oracle for metadata-dependent configs."""
        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            for (cfg, name), rec in self._docs.items():
                if rec.error is None:
                    out.setdefault(cfg, {})[name] = rec.doc
        return out

    def to_json(self) -> Dict[str, Any]:
        with self._lock:
            docs = {
                f"{cfg}/{name}": {
                    "digest": rec.digest[:16],
                    "age_s": round(time.monotonic() - rec.fetched_at, 3),
                    "error": rec.error,
                }
                for (cfg, name), rec in sorted(self._docs.items())[:64]
            }
            return {
                "registered": len(self._registry),
                "pinned": sum(1 for r in self._docs.values()
                              if r.error is None),
                "max_age_s": self.max_age_s,
                "refresh_s": self.refresh_s,
                "counters": dict(self._counters),
                "docs": docs,
            }
