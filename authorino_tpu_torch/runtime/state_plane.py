"""Durable local state plane: crash-safe warm restart.

A process that dies by SIGKILL loses everything the graceful-drain
choreography would have saved: the vetted serving snapshot, the proven
verdict-cache hot set, and with them the restart MTTR story — a cold
restart pays a full compile (or a control-plane round trip) before the
first verdict.  ``--state-dir`` closes that hole with a small local
write-behind store built entirely out of existing machinery:

  state_dir/
    snapshot-<generation>.atpusnap   last vetted snapshots (container,
    MANIFEST.json                    publisher: coalescing writer
                                     thread, tmp+fsync+rename, bounded GC)
    HOTSET.json                      verdict-cache hot-set digest (the fleet's
                                     export/import, same trust boundary)

The publisher runs with ``include_loaded=True``: unlike a distribution
directory, the state dir also persists snapshots this process itself
LOADED from an upstream leader (a replica's own crash recovery).  cli.py
refuses ``--state-dir`` == ``--snapshot-source`` so the fleet loop
breaker is never weakened.

Warm start (BEFORE the control plane connects):

  snapshot phase   load_latest(state_dir) → engine.apply_published — the
                   exact replica admission gate: sha256-verified, typed
                   rejection, strict-verify re-lint when armed.  The
                   engine serves these verdicts fail-statically until the
                   first successful replica poll swaps in the leader's
                   blob via the normal delta path (a reachable leader
                   always wins; see tests/test_warm_restart.py).
  staleness        ``--max-snapshot-age`` bounds how old the blob may be
                   (manifest ``published_unix``): past the bound the
                   engine STILL serves (old verdicts beat no verdicts)
                   but /readyz degrades to "ok (degraded: stale
                   snapshot, age=...)", a ``stale-snapshot`` flight
                   anomaly dumps evidence, and
                   auth_server_snapshot_age_seconds exposes the age.
  hotset phase     load_hotset(state_dir) → fleet.warmjoin.import_hotset:
                   fingerprint + interner-digest proven entries only,
                   whole digest discarded on mismatch.

Write-behind (while serving): every vetted swap re-publishes through the
coalescing publisher thread (never on the swap-listener critical path),
and the hot set is exported on a periodic cadence plus best-effort at
drain.  All writes ride utils/atomicio.py, so a SIGKILL at any instant
leaves every artifact old-valid or new-valid.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, Optional

from ..snapshots.distribution import (MANIFEST, SnapshotLoadError,
                                      SnapshotPublisher, load_hotset,
                                      load_latest)
from ..utils import metrics as metrics_mod

__all__ = ["StatePlane"]

log = logging.getLogger("authorino_tpu_torch.state_plane")


class StatePlane:
    """Owns one ``--state-dir``: warm start at boot, write-behind while
    serving, best-effort hot-set flush at drain.  Attach via
    ``engine.state_plane = plane`` so /readyz and /debug/vars see it."""

    def __init__(self, engine, state_dir: str,
                 max_snapshot_age_s: float = 0.0,
                 hotset_k: int = 1024, hotset_s: float = 30.0,
                 keep: int = 4):
        self.engine = engine
        self.state_dir = state_dir
        self.max_snapshot_age_s = max(0.0, float(max_snapshot_age_s))
        self.hotset_k = max(1, int(hotset_k))
        self.hotset_s = max(0.5, float(hotset_s))
        self.publisher = SnapshotPublisher(state_dir, keep=keep,
                                           include_loaded=True)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # warm-start provenance: which engine generation the state-dir blob
        # became, and when the leader originally published it — staleness
        # is judged against publish time, live, for as long as that
        # generation keeps serving
        self._warm_generation: Optional[int] = None
        self._published_unix: Optional[float] = None
        self._stale_reported = False
        self._superseded_logged = False
        self.warm_summary: Dict[str, Any] = {}

    # -- warm start (boot, before the control plane) -----------------------

    def _manifest_published_unix(self) -> Optional[float]:
        try:
            with open(os.path.join(self.state_dir, MANIFEST)) as f:
                return float(json.load(f).get("published_unix", 0.0)) or None
        except Exception:
            return None

    def warm_start(self) -> Dict[str, Any]:
        """Load + apply the local snapshot and import the local hot set.
        Never raises: every failure is a typed cold start for that phase
        (result recorded in auth_server_warm_restart_total{phase,result})
        — a corrupt state dir must never keep the process from booting."""
        summary: Dict[str, Any] = {"snapshot": "miss", "hotset": "miss"}
        t0 = time.monotonic()
        if not os.path.exists(os.path.join(self.state_dir, MANIFEST)):
            metrics_mod.warm_restart.labels("snapshot", "miss").inc()
            metrics_mod.warm_restart.labels("hotset", "miss").inc()
            self.warm_summary = summary
            return summary
        # snapshot phase: the replica admission gate end-to-end
        try:
            loaded = load_latest(self.state_dir)
            self.engine.apply_published(loaded)
        except SnapshotLoadError as e:
            summary["snapshot"] = "error"
            summary["snapshot_error"] = str(e)
            metrics_mod.warm_restart.labels("snapshot", "error").inc()
            log.warning("state-dir snapshot unloadable (cold start): %s", e)
        except Exception as e:
            # SnapshotRejected (admission) and anything else: typed cold
            # start, never a boot failure
            summary["snapshot"] = "error"
            summary["snapshot_error"] = str(e)
            metrics_mod.warm_restart.labels("snapshot", "error").inc()
            log.warning("state-dir snapshot rejected at admission "
                        "(cold start): %s", e)
        else:
            self._warm_generation = self.engine.generation
            self._published_unix = self._manifest_published_unix()
            age = (time.time() - self._published_unix
                   if self._published_unix else 0.0)
            metrics_mod.snapshot_age.set(age)
            stale = (self.max_snapshot_age_s > 0
                     and age > self.max_snapshot_age_s)
            summary["snapshot"] = "stale" if stale else "ok"
            summary["snapshot_generation"] = loaded.generation
            summary["snapshot_age_s"] = round(age, 3)
            metrics_mod.warm_restart.labels(
                "snapshot", summary["snapshot"]).inc()
            if stale:
                self._record_stale(age)
            log.info("warm restart: serving state-dir snapshot "
                     "generation %d fail-statically (age %.1fs%s) until "
                     "the control plane answers", loaded.generation, age,
                     ", STALE" if stale else "")
        # hotset phase: advisory — any failure is a cold cache, nothing more
        try:
            digest = load_hotset(self.state_dir)
            if digest is None:
                metrics_mod.warm_restart.labels("hotset", "miss").inc()
            else:
                from ..fleet.warmjoin import import_hotset

                imported, skipped = import_hotset(self.engine, digest)
                summary["hotset"] = "ok"
                summary["hotset_imported"] = imported
                summary["hotset_skipped"] = skipped
                metrics_mod.warm_restart.labels("hotset", "ok").inc()
        except Exception as e:
            summary["hotset"] = "error"
            summary["hotset_error"] = str(e)
            metrics_mod.warm_restart.labels("hotset", "error").inc()
            log.warning("state-dir hotset import failed (cold cache): %s", e)
        summary["warm_start_s"] = round(time.monotonic() - t0, 4)
        self.warm_summary = summary
        return summary

    def _record_stale(self, age: float) -> None:
        if self._stale_reported:
            return
        self._stale_reported = True
        from .flight_recorder import RECORDER

        RECORDER.record("stale-snapshot", lane="engine", detail={
            "age_s": round(age, 1),
            "max_snapshot_age_s": self.max_snapshot_age_s,
            "generation": self.engine.generation,
            "state_dir": self.state_dir,
        })

    # -- serving-time state ------------------------------------------------

    def serving_warm(self) -> bool:
        """True while the engine is still on the warm-start snapshot —
        i.e. no reconcile or control-plane poll has swapped since boot."""
        return (self._warm_generation is not None
                and self.engine.generation == self._warm_generation)

    def snapshot_age_s(self) -> Optional[float]:
        if not self.serving_warm() or self._published_unix is None:
            return None
        return time.time() - self._published_unix

    def stale_reason(self) -> Optional[str]:
        """The /readyz degraded reason, or None.  Judged live: a blob that
        was fresh at boot degrades once its publish time falls behind the
        bound with the control plane still unreachable; the first live
        swap clears everything."""
        age = self.snapshot_age_s()
        if age is None:
            # superseded by a live snapshot: zero the gauge once
            if not self._superseded_logged and self._warm_generation is not None \
                    and self.engine.generation != self._warm_generation:
                self._superseded_logged = True
                metrics_mod.snapshot_age.set(0.0)
            return None
        metrics_mod.snapshot_age.set(age)
        if self.max_snapshot_age_s > 0 and age > self.max_snapshot_age_s:
            self._record_stale(age)
            return f"stale snapshot, age={age:.0f}s"
        return None

    # -- write-behind ------------------------------------------------------

    def start(self) -> None:
        """Attach the coalescing publisher (every vetted swap persists,
        off the swap-listener critical path) and start the periodic
        hot-set export."""
        self.publisher.attach(self.engine)
        if self._thread is None:
            self._thread = threading.Thread(target=self._hotset_loop,
                                            name="atpu-state-hotset",
                                            daemon=True)
            self._thread.start()

    def export_hotset_once(self) -> bool:
        """One hot-set export to the state dir (periodic cadence and the
        drain path).  Best-effort: False on nothing-to-export or failure."""
        try:
            from ..fleet.warmjoin import export_hotset

            digest = export_hotset(self.engine, k=self.hotset_k)
            if digest is None:
                return False
            self.publisher.publish_hotset(digest)
            return True
        except Exception:
            log.exception("state-dir hotset export failed "
                          "(serving unaffected)")
            return False

    def _hotset_loop(self) -> None:
        while not self._stop.wait(self.hotset_s):
            self.export_hotset_once()

    def shutdown(self, timeout_s: float = 2.0) -> None:
        """Drain hook: stop the cadence, flush the publisher (so the last
        vetted swap is on disk) and export the final hot set — all
        best-effort and bounded; drain must finish on time regardless."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=min(1.0, timeout_s))
        try:
            self.publisher.flush(timeout_s=timeout_s)
        except Exception:
            pass
        self.export_hotset_once()

    def to_json(self) -> Dict[str, Any]:
        age = self.snapshot_age_s()
        return {
            "state_dir": self.state_dir,
            "max_snapshot_age_s": self.max_snapshot_age_s,
            "hotset_k": self.hotset_k,
            "hotset_s": self.hotset_s,
            "serving_warm": self.serving_warm(),
            "snapshot_age_s": (round(age, 1) if age is not None else None),
            "stale": bool(self.stale_reason()),
            "warm_start": dict(self.warm_summary),
        }
