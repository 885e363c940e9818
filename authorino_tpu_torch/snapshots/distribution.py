"""Compile-leader / serving-replica snapshot distribution.

The leader compiles, strict-verifies (tensor lint + translation
certification — the admission gate), serializes the vetted snapshot, and
publishes it atomically into a directory (tmp + rename, then a MANIFEST
pointer).  Replicas poll the directory (or an HTTP mirror of it) and apply
each new vetted snapshot WITHOUT recompiling anything: load is pure
deserialization + the local admission gate.  Compile once, serve many.

Failure modes (docs/control_plane.md):

  leader down          → the MANIFEST stops advancing; replicas keep
                         serving the last vetted snapshot indefinitely
  corrupt blob         → sha256 trailer mismatch: SnapshotLoadError at
                         load, old snapshot keeps serving
  uncertified blob     → ``certified`` missing/false in the meta: rejected
                         at admission (SnapshotRejected), old snapshot
                         keeps serving — a snapshot that never passed the
                         leader's strict verify can never serve
  torn publish         → the atomic rename makes a half-written blob
                         unreachable; the MANIFEST only ever points at a
                         fully-renamed file"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..utils.atomicio import atomic_write_bytes, atomic_write_json
from .serialize import SnapshotFormatError, deserialize_policy, serialize_policy

__all__ = [
    "SnapshotLoadError", "LoadedSnapshot", "SnapshotPublisher",
    "load_latest", "load_snapshot_blob", "SnapshotReplica",
    "load_hotset",
]

log = logging.getLogger("authorino_tpu_torch.snapshots")

MANIFEST = "MANIFEST.json"
# verdict-cache hot-set digest (fleet/warmjoin.py): published
# NEXT TO the manifest, never inside it — a replica that predates the
# fleet plane keeps loading MANIFEST.json untouched
HOTSET = "HOTSET.json"


class SnapshotLoadError(RuntimeError):
    """A published snapshot could not be loaded (missing, corrupt,
    unparseable).  The caller's serving snapshot stays untouched."""


@dataclass
class LoadedSnapshot:
    policy: Any                      # CompiledPolicy (host arrays only)
    meta: Dict[str, Any]
    generation: int = 0
    digest: str = ""                 # manifest sha256 (hex) when known

    @property
    def certified(self) -> bool:
        return bool(self.meta.get("certified"))

    @property
    def fingerprints(self) -> Dict[str, str]:
        return dict(self.meta.get("fingerprints") or {})

    @property
    def entries(self) -> List[Tuple[str, List[str]]]:
        """(config id, hosts) pairs the leader served this corpus under."""
        return [(str(e["id"]), [str(h) for h in e.get("hosts", [])])
                for e in (self.meta.get("entries") or [])]


def _sha256_hex(blob: bytes) -> str:
    import hashlib

    return hashlib.sha256(blob).hexdigest()


# ---------------------------------------------------------------------------
# leader side
# ---------------------------------------------------------------------------


class SnapshotPublisher:
    """Atomic directory publisher.  ``publish_from_engine`` serializes the
    engine's CURRENT snapshot (fingerprints, certification state, host
    routing included) — attach it as a swap listener on the leader and
    every vetted reconcile becomes a published artifact."""

    def __init__(self, directory: str, keep: int = 4,
                 include_loaded: bool = False):
        self.directory = directory
        self.keep = max(1, int(keep))
        # include_loaded=True turns the publisher into a STATE-PLANE writer
        # (--state-dir): snapshots this process itself loaded
        # from an upstream publisher (published_origin set) are persisted
        # too, so a SIGKILLed replica restarts warm from its own disk.
        # The default (False) keeps the fleet loop breaker: replicas never
        # republish into a distribution directory.
        self.include_loaded = bool(include_loaded)
        os.makedirs(directory, exist_ok=True)
        # async publish machinery (attach): serialize+fsync must never sit
        # on the swap-listener critical path — a revoking reconcile has to
        # reach the native fast lane at swap speed, not behind disk I/O
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._engine = None
        self._last_published_snap: Any = None

    def publish_blob(self, blob: bytes, generation: int,
                     extra: Optional[Dict[str, Any]] = None) -> str:
        """``extra`` merges additional manifest fields — the change-safety
        record: ``active_generation`` (the leader's serving
        decision, which replicas converge on) and, after a guard-breach,
        the ``rollback``/``quarantine`` provenance, so a fleet operator
        can see WHY the manifest moved backwards semantically."""
        name = f"snapshot-{generation:012d}.atpusnap"
        path = os.path.join(self.directory, name)
        atomic_write_bytes(path, blob, artifact="snapshot-blob")
        manifest = {
            "current": name,
            "generation": int(generation),
            "active_generation": int(generation),
            "sha256": _sha256_hex(blob),
            "size": len(blob),
            "published_unix": time.time(),
        }
        if extra:
            manifest.update(extra)
        atomic_write_json(os.path.join(self.directory, MANIFEST), manifest,
                          artifact="manifest")
        self._gc(keep_name=name)
        return path

    def _gc(self, keep_name: str) -> None:
        snaps = sorted(n for n in os.listdir(self.directory)
                       if n.endswith(".atpusnap"))
        for n in snaps[:-self.keep]:
            if n != keep_name:
                try:
                    os.unlink(os.path.join(self.directory, n))
                except OSError:
                    pass

    def publish_hotset(self, digest: Dict[str, Any]) -> str:
        """Atomically publish the verdict-cache hot-set digest
        (fleet/warmjoin.py export_hotset) next to the manifest.  Same
        tmp+rename discipline as the blob: a joining replica never reads a
        torn digest.  Advisory data — a stale or missing HOTSET.json only
        costs a cold cache, never correctness (entries are re-validated
        against the joining snapshot's tokens at import)."""
        path = os.path.join(self.directory, HOTSET)
        atomic_write_json(path, digest, artifact="hotset")
        return path

    def publish_from_engine(self, engine) -> Optional[str]:
        """Serialize + publish the engine's current snapshot.  Returns the
        published path, or None when there is nothing publishable (no
        compiled corpus, or a mesh-sharded snapshot — per-shard policies
        do not round-trip through one container)."""
        snap = engine._snapshot
        if snap is None or snap.policy is None:
            return None
        if getattr(snap, "published_origin", None) and not self.include_loaded:
            # this snapshot was itself loaded from a publisher: replicas
            # never republish (loop breaker — see engine.from_published).
            # A state-plane publisher (include_loaded=True) opts out: its
            # directory is this process's own crash-recovery store, never
            # another replica's source (cli.py refuses --state-dir ==
            # --snapshot-source), so persisting loaded snapshots is safe.
            return None
        change_safety = getattr(snap, "change_safety", None)
        meta = {
            "generation": int(snap.generation),
            "certified": bool(getattr(snap, "lint_ok", False)),
            "fingerprints": dict(getattr(snap, "fingerprints", {}) or {}),
            "translation": getattr(snap, "translation", None),
            "entries": [{"id": e.id, "hosts": list(e.hosts)}
                        for e in snap.by_id.values()],
        }
        if change_safety:
            meta["change_safety"] = change_safety
        blob = serialize_policy(snap.policy, meta=meta)
        path = self.publish_blob(blob, snap.generation,
                                 extra=(dict(change_safety)
                                        if change_safety else None))
        log.info("published snapshot generation %d (%d bytes, certified=%s"
                 "%s) -> %s", snap.generation, len(blob), meta["certified"],
                 f", change_safety={sorted(change_safety)}"
                 if change_safety else "", path)
        return path

    def attach(self, engine) -> None:
        """Register as a swap listener: every engine snapshot swap (already
        vetted when --strict-verify is on) publishes — ASYNCHRONOUSLY, on
        the publisher's own thread.  The listener itself only sets an
        event, so revocation propagation to the other listeners (the
        native frontend's refresh) never waits behind serialize + fsync;
        back-to-back swaps coalesce to the newest snapshot (the manifest
        points at the latest generation anyway).  A publish failure must
        never fail a reconcile."""
        self._engine = engine
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._publish_loop, name="atpu-snapshot-publisher",
                daemon=True)
            self._thread.start()
        engine.add_swap_listener(self._wake.set)

    def flush(self, timeout_s: float = 10.0) -> bool:
        """Block until the engine's CURRENT snapshot has been published (or
        the timeout expires — False).  Tests and orderly shutdown only;
        the serving path never needs it."""
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            engine = self._engine
            if engine is None or engine._snapshot is None \
                    or self._last_published_snap is engine._snapshot:
                return True
            time.sleep(0.005)
        return False

    def _publish_loop(self) -> None:
        from ..utils import metrics as metrics_mod

        while True:
            self._wake.wait()
            self._wake.clear()
            engine = self._engine
            snap = engine._snapshot if engine is not None else None
            if snap is None or snap is self._last_published_snap:
                continue
            try:
                if self.publish_from_engine(engine) is not None:
                    metrics_mod.snapshot_distribution.labels(
                        "leader", "published").inc()
            except Exception:
                log.exception("snapshot publish failed (serving unaffected)")
            finally:
                self._last_published_snap = snap


# ---------------------------------------------------------------------------
# replica side
# ---------------------------------------------------------------------------


def _read_source(source: str, name: str) -> bytes:
    """Read one artifact from a directory path or an http(s) mirror."""
    if source.startswith(("http://", "https://")):
        from urllib.request import urlopen

        with urlopen(source.rstrip("/") + "/" + name, timeout=10) as r:
            return r.read()
    path = os.path.join(source, name)
    with open(path, "rb") as f:
        return f.read()


def load_snapshot_blob(blob: bytes, digest: str = "") -> LoadedSnapshot:
    try:
        policy, meta = deserialize_policy(blob)
    except SnapshotFormatError as e:
        raise SnapshotLoadError(str(e))
    except Exception as e:
        # containment: NO malformed blob may escape as anything but a load
        # error — the replica's serving snapshot must survive every bad
        # publish (docs/control_plane.md failure modes)
        raise SnapshotLoadError(f"malformed snapshot blob: {e!r}")
    return LoadedSnapshot(policy=policy, meta=meta,
                          generation=int(meta.get("generation", 0)),
                          digest=digest)


def load_latest(source: str) -> LoadedSnapshot:
    """Resolve the MANIFEST and load the snapshot it points at, verifying
    the manifest digest against the blob BEFORE parsing anything."""
    try:
        manifest = json.loads(_read_source(source, MANIFEST).decode("utf-8"))
        name = str(manifest["current"])
        if "/" in name or name.startswith("."):
            raise SnapshotLoadError(f"suspicious manifest entry {name!r}")
        blob = _read_source(source, name)
    except SnapshotLoadError:
        raise
    except Exception as e:
        raise SnapshotLoadError(f"snapshot source unreadable: {e}")
    want = str(manifest.get("sha256", ""))
    got = _sha256_hex(blob)
    if want and got != want:
        raise SnapshotLoadError(
            f"manifest digest mismatch ({want[:12]}... != {got[:12]}...)")
    return load_snapshot_blob(blob, digest=got)


def load_hotset(source: str) -> Optional[Dict[str, Any]]:
    """Load the published verdict-cache hot-set digest, or None when the
    source has none (a pre-fleet leader, or hot-set publishing off).
    Malformed digests also resolve to None — warm-join is advisory; a
    replica must join cold rather than fail to join."""
    try:
        doc = json.loads(_read_source(source, HOTSET).decode("utf-8"))
    except Exception:
        return None
    return doc if isinstance(doc, dict) else None


class SnapshotReplica:
    """Poll a snapshot source and apply each new vetted snapshot to a local
    engine.  The engine's ``apply_published`` is the admission gate: an
    uncertified or locally-failing snapshot is rejected and the previous
    one keeps serving — leader down simply means no new generations."""

    # load-failure backoff: ceiling multiple of poll_s (a dead leader
    # settles at poll_s * 2**MAX_BACKOFF_DOUBLINGS between attempts)
    MAX_BACKOFF_DOUBLINGS = 5

    def __init__(self, engine, source: str, poll_s: float = 5.0):
        self.engine = engine
        self.source = source
        self.poll_s = max(0.2, float(poll_s))
        self._seen_digest: Optional[str] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.applied = 0
        self.rejected = 0
        self.errors = 0
        # consecutive load failures — drives the exponential poll backoff
        # and demotes repeat WARNINGs to DEBUG (a dead leader must not
        # flood the replica's log at the poll cadence); any successful
        # load (or a rejection — the source IS reachable) resets it
        self.error_streak = 0
        self.last_error: Optional[str] = None

    def poll_once(self) -> bool:
        """One load-and-apply attempt.  True when a NEW snapshot was
        applied; False on no-change, load failure, or rejection."""
        from ..runtime.engine import SnapshotRejected
        from ..utils import metrics as metrics_mod

        try:
            loaded = load_latest(self.source)
        except SnapshotLoadError as e:
            self.errors += 1
            self.error_streak += 1
            self.last_error = str(e)
            if self.error_streak == 1:
                metrics_mod.snapshot_distribution.labels(
                    "replica", "error").inc()
                log.warning("replica load failed (serving snapshot "
                            "unchanged; backing polls off): %s", e)
            else:
                # retries of a standing failure: counted, logged quietly —
                # the WARNING above already said the leader is unreadable
                metrics_mod.snapshot_distribution.labels(
                    "replica", "retry").inc()
                log.debug("replica load retry %d failed (next poll in "
                          "%.1fs): %s", self.error_streak,
                          self.next_poll_s(), e)
            return False
        self.error_streak = 0
        if loaded.digest and loaded.digest == self._seen_digest:
            return False
        try:
            self.engine.apply_published(loaded)
        except SnapshotRejected as e:
            self.rejected += 1
            self.last_error = str(e)
            # remember the digest: re-polling the same rejected blob every
            # interval would re-run the admission gate for nothing
            self._seen_digest = loaded.digest or None
            metrics_mod.snapshot_distribution.labels(
                "replica", "rejected").inc()
            log.error("replica REJECTED snapshot generation %d at admission "
                      "(previous snapshot keeps serving): %s",
                      loaded.generation, e)
            return False
        self._seen_digest = loaded.digest or None
        self.applied += 1
        self.last_error = None
        metrics_mod.snapshot_distribution.labels("replica", "applied").inc()
        log.info("replica applied snapshot generation %d (%d config(s))",
                 loaded.generation, len(loaded.policy.config_ids))
        return True

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop,
                                        name="atpu-snapshot-replica",
                                        daemon=True)
        self._thread.start()

    def next_poll_s(self) -> float:
        """Current poll interval: poll_s while healthy, doubling per
        consecutive load failure up to poll_s * 2**MAX_BACKOFF_DOUBLINGS.
        A success (or an admission rejection — the source answered)
        snaps it back to poll_s."""
        if self.error_streak <= 0:
            return self.poll_s
        doublings = min(self.error_streak, self.MAX_BACKOFF_DOUBLINGS)
        return self.poll_s * (1 << doublings)

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:
                log.exception("replica poll failed")
            self._stop.wait(self.next_poll_s())

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout_s)

    def to_json(self) -> Dict[str, Any]:
        return {
            "source": self.source, "poll_s": self.poll_s,
            "next_poll_s": self.next_poll_s(),
            "applied": self.applied, "rejected": self.rejected,
            "errors": self.errors, "error_streak": self.error_streak,
            "last_error": self.last_error,
        }
