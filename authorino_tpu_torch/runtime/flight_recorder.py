"""Black-box flight recorder (the reference's runtime/flight_recorder.py):
a bounded process-wide ring of serving-lifecycle events — watchdog fires,
snapshot swaps, admission state flips, reconcile phases, drain, modeled
kernel-cost regressions — that auto-dumps a diagnostic bundle when an
anomaly fires.

The aviation model: the ring records continuously at negligible cost (one
deque append per event; events are per-incident, never per-request), and an
anomaly trigger — breaker OPEN, watchdog timeout, snapshot rejection,
admission OVERLOADED — freezes the evidence by writing a bundle containing
the event trail, every registered component's /debug/vars snapshot, and the
full Prometheus exposition, to ``--flight-dir``.  Incident forensics then
start from the bundle (one JSON document, schema ``BUNDLE_SCHEMA``), not
from whatever the process happened to log.

Recording hooks live in runtime/admission.py, runtime/breaker.py and
runtime/engine.py (the reference's native frontend records here too; the
port has none yet).  The anomaly set is the reference's whole set, so a kind
recorded by a plane ported later triggers as it does there.  Everything
here is fail-safe — a recorder bug must never take down the serving path,
so every public entry point swallows its own exceptions after logging.
"""

from __future__ import annotations

import json
import logging
import math
import os
import tempfile
import threading
import time
import weakref
from collections import deque
from typing import Any, Dict, List, Optional

from ..utils import metrics as metrics_mod
from ..utils.atomicio import atomic_write_json

__all__ = ["FlightRecorder", "RECORDER", "BUNDLE_SCHEMA"]

log = logging.getLogger("authorino_tpu_torch.flight_recorder")

# bundle schema version: bumped whenever the bundle layout changes, so the
# analysis CLI can refuse bundles it does not understand
BUNDLE_SCHEMA = 1

# event kinds that trigger an auto-dump (the anomaly set); every other kind
# only rides the ring as context
ANOMALY_KINDS = frozenset({
    "breaker-open", "watchdog-timeout", "snapshot-rejected",
    "admission-overloaded", "snapshot-rollback",
    # a reconcile whose replay preflight breached — the bundle freezes
    # the top-N verdict-diff rows (attributed flips) as evidence
    "replay-pregate-breach",
    # a reconcile whose CORPUS preflight breached — same evidence
    # shape, but the flips may be synthetic-origin rows (a rule no live
    # traffic ever exercised), which is exactly the zero-exposure catch
    "corpus-pregate-breach",
    # the noisy-neighbor detector CONTAINED a tenant (tenant-
    # scoped brownout/shed) — the bundle freezes the per-tenant shares,
    # weights and wait state that justified the clamp.  The auto-release
    # (kind `tenant-released`) rides the ring as context only.
    "tenant-contained",
    # a reconcile whose modeled per-row kernel cost regressed >=2x vs the
    # previous generation (advisory — the swap still lands; the bundle
    # freezes the modeled ops/bytes diff per entry point)
    "cost-regression",
    # a warm restart served the state-dir snapshot past its
    # --max-snapshot-age bound — fail-static by design (old verdicts beat
    # no verdicts), but the bundle freezes the age/generation evidence and
    # /readyz degrades until a live control-plane snapshot lands
    "stale-snapshot",
})


class FlightRecorder:
    """Bounded event ring + anomaly-triggered bundle dumps.

    ``record()`` is the hot entry point: deque append + one counter inc,
    safe from any thread (including under the breaker's lock).  Dumps run
    on their own daemon thread and are rate-limited (``min_dump_interval_s``
    between bundles) so a flapping breaker cannot turn the recorder into a
    disk-filling amplifier."""

    def __init__(self, capacity: int = 512, dump_dir: Optional[str] = None,
                 min_dump_interval_s: float = 30.0, enabled: bool = True,
                 keep: int = 16):
        self.capacity = max(16, int(capacity))
        # on-disk bundle retention: a flapping lane on a long-lived pod
        # would otherwise slowly fill the disk with bundles nobody read.
        # Only the newest ``keep`` bundles survive each dump.
        self.keep = max(1, int(keep))
        self._ring: deque = deque(maxlen=self.capacity)
        # guards ring append vs snapshot: record() fires from any thread
        # (breaker/admission hooks) while the dump thread lists the ring —
        # an unguarded list(deque) under concurrent appends raises, and a
        # swallowed raise there silently loses the incident's bundle
        self._ring_lock = threading.Lock()
        self.enabled = bool(enabled)
        self.dump_dir = dump_dir or os.environ.get(
            "AUTHORINO_TPU_FLIGHT_DIR",
            os.path.join(tempfile.gettempdir(), "authorino-tpu-flight"))
        self.min_dump_interval_s = float(min_dump_interval_s)
        # no dump yet: the first anomaly always dumps.  (0.0 here would
        # rate-limit it against the monotonic clock's origin, which is
        # the host's boot: on a host up for less than the interval the
        # first incident would lose its bundle.)
        self._last_dump = -math.inf
        self._dump_lock = threading.Lock()
        # registered context providers: name -> weakref'd zero-arg callable
        # returning a JSON-safe dict (engine.debug_vars, fe.debug_vars).
        # Weak by owner: engines are created freely in tests/reconciles and
        # a strong ref here would leak every one of them.
        self._providers: Dict[str, Any] = {}
        self._provider_lock = threading.Lock()
        self.events_total = 0
        self.dumps: List[str] = []  # bundle paths written this process
        # the last bundle name and how often it has been taken: two
        # anomalies of one trigger in one second get distinct names
        self._name_lock = threading.Lock()
        self._last_name = ("", 0)

    # -- configuration -----------------------------------------------------

    def configure(self, dump_dir: Optional[str] = None,
                  capacity: Optional[int] = None,
                  min_dump_interval_s: Optional[float] = None,
                  enabled: Optional[bool] = None,
                  keep: Optional[int] = None) -> None:
        if dump_dir is not None:
            self.dump_dir = dump_dir
        if capacity is not None and int(capacity) != self.capacity:
            self.capacity = max(16, int(capacity))
            with self._ring_lock:
                self._ring = deque(self._ring, maxlen=self.capacity)
        if min_dump_interval_s is not None:
            self.min_dump_interval_s = float(min_dump_interval_s)
        if enabled is not None:
            self.enabled = bool(enabled)
        if keep is not None:
            self.keep = max(1, int(keep))

    def register_provider(self, name: str, owner: Any,
                          method: str = "debug_vars") -> None:
        """Register ``owner.<method>()`` as a context provider for bundles.
        Held weakly; a later registration under the same name wins (the
        latest engine is the serving one)."""
        with self._provider_lock:
            self._providers[name] = (weakref.ref(owner), method)

    # -- recording ---------------------------------------------------------

    def record(self, kind: str, lane: str = "", detail: Any = None,
               anomaly: Optional[bool] = None) -> None:
        """Append one lifecycle event; auto-dump when it is an anomaly
        (``kind in ANOMALY_KINDS``, overridable via ``anomaly=``)."""
        if not self.enabled:
            return
        try:
            with self._ring_lock:
                self._ring.append({
                    "t": time.time(), "kind": kind, "lane": lane,
                    "detail": detail,
                })
                self.events_total += 1
            metrics_mod.flight_events.labels(kind).inc()
            if anomaly if anomaly is not None else kind in ANOMALY_KINDS:
                self._schedule_dump(kind)
        except Exception:
            log.exception("flight-recorder record failed (serving unaffected)")

    # -- dumping -----------------------------------------------------------

    def _schedule_dump(self, trigger: str) -> None:
        now = time.monotonic()
        with self._dump_lock:
            if now - self._last_dump < self.min_dump_interval_s:
                return
            self._last_dump = now
        t = threading.Thread(target=self._dump_safe, args=(trigger,),
                             name="atpu-flight-dump", daemon=True)
        t.start()

    def _dump_safe(self, trigger: str) -> None:
        try:
            self.dump(trigger)
        except Exception:
            log.exception("flight-recorder dump failed (serving unaffected)")

    def _gather_vars(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        with self._provider_lock:
            items = list(self._providers.items())
        dead = []
        for name, (ref, method) in items:
            owner = ref()
            if owner is None:
                dead.append(name)
                continue
            try:
                out[name] = getattr(owner, method)()
            except Exception as e:
                out[name] = {"error": repr(e)}
        if dead:
            with self._provider_lock:
                for name in dead:
                    self._providers.pop(name, None)
        return out

    def bundle(self, trigger: str) -> Dict[str, Any]:
        """The diagnostic bundle as a dict: the event trail, every live
        provider's debug-vars snapshot, and the Prometheus exposition."""
        try:
            from prometheus_client import generate_latest

            metrics_text = generate_latest().decode("utf-8", "replace")
        except Exception:
            metrics_text = ""
        with self._ring_lock:
            events = list(self._ring)
        return {
            "schema": BUNDLE_SCHEMA,
            "kind": "authorino-tpu-flight-bundle",
            "trigger": trigger,
            "t": time.time(),
            "pid": os.getpid(),
            "events": events,
            "vars": self._gather_vars(),
            "metrics": metrics_text,
        }

    def dump(self, trigger: str) -> str:
        """Write one bundle to ``dump_dir`` and return its path (also
        counted in auth_server_flight_recorder_dumps_total{trigger})."""
        bundle = self.bundle(trigger)
        os.makedirs(self.dump_dir, exist_ok=True)
        base = "flight-%d-%s-%d" % (
            int(bundle["t"]), trigger.replace("/", "_"), os.getpid())
        # the reference's name; a second bundle of the same trigger in the
        # same second takes a suffix (with one name, two concurrent writes
        # would share their temporary file and one would be lost)
        with self._name_lock:
            taken = self._last_name[1] if self._last_name[0] == base else 0
            self._last_name = (base, taken + 1)
        fname = base + (".json" if not taken else "-%d.json" % taken)
        path = os.path.join(self.dump_dir, fname)
        # the shared atomic writer: fsynced, so a crash cannot surface a
        # zero-length bundle
        atomic_write_json(path, bundle, artifact="flight", default=str)
        metrics_mod.flight_dumps.labels(trigger).inc()
        self.dumps.append(path)
        del self.dumps[:-32]
        self._prune_disk()
        log.warning("flight recorder dumped diagnostic bundle (%s): %s",
                    trigger, path)
        return path

    def _prune_disk(self) -> None:
        """Bounded on-disk retention: keep only the newest ``keep``
        bundles in dump_dir (by mtime).  Best-effort — a prune failure
        must never lose the bundle that was just written."""
        try:
            names = [n for n in os.listdir(self.dump_dir)
                     if n.startswith("flight-") and n.endswith(".json")]
            if len(names) <= self.keep:
                return
            names.sort(key=lambda n: os.path.getmtime(
                os.path.join(self.dump_dir, n)))
            for n in names[:-self.keep]:
                try:
                    os.unlink(os.path.join(self.dump_dir, n))
                except OSError:
                    pass
        except OSError:
            pass

    # -- introspection -----------------------------------------------------

    def to_json(self) -> Dict[str, Any]:
        with self._ring_lock:
            depth, tail = len(self._ring), list(self._ring)[-16:]
        return {
            "enabled": self.enabled,
            "capacity": self.capacity,
            "events_recorded": self.events_total,
            "ring_depth": depth,
            "dump_dir": self.dump_dir,
            "keep": self.keep,
            "min_dump_interval_s": self.min_dump_interval_s,
            "dumps": list(self.dumps),
            "tail": tail,
        }


# the process-wide recorder every hook reports into (one black box per
# process, like one breaker trail per lane)
def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


RECORDER = FlightRecorder(
    enabled=os.environ.get("AUTHORINO_TPU_FLIGHT_RECORDER", "1").lower()
    not in ("0", "false", "no"),
    keep=_env_int("AUTHORINO_TPU_FLIGHT_KEEP", 16))
