"""Injectable fault plane for the device dispatch path (the reference's
runtime/faults.py).

The engine (runtime/engine.py) calls into this module at the points of every
micro-batch — encode, H2D staging, kernel launch, readback — so tests, a
``--fault-profile`` server run and ``chip_smoke.py`` can make any stage
raise, hang, or slow down per batch, deterministically, without touching the
device code.  The durable writers (utils/atomicio.py) consult the ``fs``
stage.

Zero-cost when off: hot paths gate every hook on the module-level ``ACTIVE``
flag (one attribute read per batch); nothing else of this module runs until
``FAULTS.arm()`` flips it.

Spec grammar (also accepted by AUTHORINO_TPU_FAULTS / --fault-profile)::

    spec  := profile | rule (";" rule)*
    rule  := stage ":" mode [":" key=value]*
    stage := encode | h2d | kernel | dispatch (= kernel) | readback | fs
    mode  := raise | hang | delay                       (device stages)
    mode  := torn | short | rename-fail | eio | enospc  (fs stage)
    keys  := p=<probability 0..1> n=<max firings> delay=<seconds>
             for=<seconds active> after=<seconds before active>
             lane=<engine|native> device=<device id>
             artifact=<snapshot-blob|manifest|hotset|capture|corpus|...>

Named profiles::

    device-down   kernel:raise               every dispatch fails
    one-device-down  kernel:raise:device=0   mesh device 0 fails, rest healthy
    flaky         kernel:raise:p=0.3         ~1 in 3 dispatches fails
    flap          kernel:raise:for=2         device down 2s, then recovers
    slow-device   kernel:delay:delay=0.05    +50ms readback latency/batch
    wedge         kernel:hang                readbacks never arrive

``device=`` scopes a rule to ONE mesh device: it fires only for probes that
name that device, and such probes fire only device-scoped rules (generic
rules get their once-per-batch chance at the lane-level check).  The rules
parse and are kept; the port has no mesh yet (ROADMAP queue 1 item 13), so
nothing probes a device and a device-scoped rule never fires.

``hang`` is realized by wrapping the in-flight result handle: ``is_ready()``
stays False (until the rule's ``for=`` window closes), which is exactly what
a wedged device looks like to the completer — the watchdog path, not the
exception path, must catch it.  Device-stage ``delay`` rules ride the same
wrapper with a per-batch release deadline: the readback arrives ``delay_s``
late, so the measured device round trip (and everything keyed off it —
deadline shedding, the adaptive window) inflates exactly like a genuinely
slow device; only encode-stage delays sleep on the worker thread.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

__all__ = ["ACTIVE", "FAULTS", "FaultPlane", "FaultRule", "InjectedFault",
           "HungHandle", "PROFILES"]

log = logging.getLogger(__name__)

# module-level gate: the ONLY thing serving paths read while faults are off
ACTIVE = False

PROFILES = {
    "device-down": "kernel:raise",
    "one-device-down": "kernel:raise:device=0",
    "flaky": "kernel:raise:p=0.3",
    "flap": "kernel:raise:for=2",
    "slow-device": "kernel:delay:delay=0.05",
    "wedge": "kernel:hang",
}

_STAGES = ("encode", "h2d", "kernel", "readback", "fs")
_MODES = ("raise", "hang", "delay")
# The fs stage models filesystem failure at a durable-artifact writer
# (utils/atomicio.py consults fs_fault() under the same ACTIVE gate the
# device hooks use).  Its modes are crash shapes, not exception shapes:
#   torn        a prefix of the new bytes lands over the DESTINATION
#               (power cut after a non-atomic overwrite) — readers must
#               reject the torn artifact typed, never crash or serve it
#   short       the tmp file ends up shorter than requested (quota,
#               interrupted write); the writer's size check catches it
#               and the destination is untouched
#   rename-fail os.replace itself fails; tmp is discarded, old state wins
#   eio         open/write raises EIO before any byte lands
#   enospc      a partial tmp write then ENOSPC; destination untouched
_FS_MODES = ("torn", "short", "rename-fail", "eio", "enospc")


class InjectedFault(RuntimeError):
    """Raised by an armed ``raise`` rule — the synthetic stand-in for a
    failed H2D transfer / kernel launch / readback.  ``device_id`` names
    the mesh device a device-scoped rule fired for (None otherwise)."""

    def __init__(self, message: str, device_id: Optional[int] = None):
        super().__init__(message)
        self.device_id = device_id


@dataclass
class FaultRule:
    stage: str                    # encode | h2d | kernel | readback | fs
    mode: str                     # raise | hang | delay | <fs mode>
    lane: str = "*"               # engine | native | *
    device: Optional[int] = None  # scope to one mesh device id (None = any)
    artifact: str = "*"           # fs stage: scope to one artifact kind
    p: float = 1.0                # firing probability per eligible batch
    n: int = -1                   # max firings (-1 = unlimited)
    delay_s: float = 0.05         # mode=delay: added latency
    for_s: Optional[float] = None   # active window from arm time (None = ∞)
    after_s: float = 0.0          # inactive for this long after arm time
    fired: int = 0

    def live(self, elapsed: float) -> bool:
        if self.n >= 0 and self.fired >= self.n:
            return False
        if elapsed < self.after_s:
            return False
        if self.for_s is not None and elapsed >= self.after_s + self.for_s:
            return False
        return True

    def describe(self) -> str:
        extras = []
        if self.lane != "*":
            extras.append(f"lane={self.lane}")
        if self.device is not None:
            extras.append(f"device={self.device}")
        if self.artifact != "*":
            extras.append(f"artifact={self.artifact}")
        if self.p < 1.0:
            extras.append(f"p={self.p}")
        if self.n >= 0:
            extras.append(f"n={self.n}")
        if self.for_s is not None:
            extras.append(f"for={self.for_s}")
        if self.after_s:
            extras.append(f"after={self.after_s}")
        return ":".join([self.stage, self.mode] + extras)


class HungHandle:
    """Wraps an in-flight device handle (``is_ready()`` / ``wait()``, as
    ``ops/fused_kernel.py::MegakernelHandle``) so its readback never
    arrives: ``release_at`` is the monotonic deadline after which the
    underlying handle shows through again, or None for a permanent
    wedge."""

    def __init__(self, handle: Any, release_at: Optional[float] = None):
        self._handle = handle
        self._release_at = release_at

    def _released(self) -> bool:
        return self._release_at is not None and time.monotonic() >= self._release_at

    def is_ready(self) -> bool:
        if self._released():
            is_ready = getattr(self._handle, "is_ready", None)
            return True if is_ready is None else bool(is_ready())
        return False

    def wait(self):
        # a blocking wait on a wedged handle would deadlock the caller —
        # fail loudly instead (the watchdog is the intended consumer)
        if not self._released() or self._handle is None:
            raise InjectedFault("readback of a hung device handle")
        return self._handle.wait()

    def release(self) -> None:
        """Drop the wrapped handle (the watchdog abandoned it): its
        readback buffer, event and stream go with it."""
        inner, self._handle = self._handle, None
        release = getattr(inner, "release", None)
        if release is not None:
            release()


def _parse_rule(text: str) -> FaultRule:
    parts = [p.strip() for p in text.split(":") if p.strip()]
    if len(parts) < 2:
        raise ValueError(f"fault rule {text!r}: want stage:mode[:k=v...]")
    stage, mode = parts[0].lower(), parts[1].lower()
    if stage == "dispatch":
        stage = "kernel"
    if stage not in _STAGES:
        raise ValueError(f"fault rule {text!r}: unknown stage {stage!r} "
                         f"(want one of {_STAGES})")
    if stage == "fs":
        if mode not in _FS_MODES:
            raise ValueError(f"fault rule {text!r}: unknown fs mode {mode!r} "
                             f"(want one of {_FS_MODES})")
    elif mode not in _MODES:
        raise ValueError(f"fault rule {text!r}: unknown mode {mode!r} "
                         f"(want one of {_MODES})")
    rule = FaultRule(stage=stage, mode=mode)
    for kv in parts[2:]:
        if "=" not in kv:
            raise ValueError(f"fault rule {text!r}: bad key {kv!r}")
        k, v = kv.split("=", 1)
        k = k.strip().lower()
        if k == "p":
            rule.p = float(v)
        elif k == "n":
            rule.n = int(v)
        elif k in ("delay", "delay_s"):
            rule.delay_s = float(v)
        elif k == "delay_ms":
            rule.delay_s = float(v) / 1000.0
        elif k in ("for", "for_s"):
            rule.for_s = float(v)
        elif k in ("after", "after_s"):
            rule.after_s = float(v)
        elif k == "lane":
            rule.lane = v.strip().lower()
        elif k == "device":
            rule.device = int(v)
        elif k == "artifact":
            rule.artifact = v.strip().lower()
        else:
            raise ValueError(f"fault rule {text!r}: unknown key {k!r}")
    return rule


class FaultPlane:
    """Process-wide fault injector (singleton: ``FAULTS``).  Thread-safe:
    hooks run on the encode pool's and the completer's threads at once."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rules: List[FaultRule] = []
        self._armed_at = 0.0
        self._rng = random.Random()
        self.fired: Dict[str, int] = {}   # "stage:mode:lane" → count

    # -- control -----------------------------------------------------------

    def arm(self, spec: str, seed: Optional[int] = None) -> None:
        """Parse and activate ``spec`` (a named profile or rule list).
        Re-arming replaces the previous rule set and restarts the clock.
        The rng is seeded with ``seed``, else AUTHORINO_TPU_FAULT_SEED,
        else 1234."""
        global ACTIVE
        spec = (spec or "").strip()
        if not spec:
            self.disarm()
            return
        spec = PROFILES.get(spec, spec)
        rules = [_parse_rule(r) for r in spec.replace(",", ";").split(";")
                 if r.strip()]
        if seed is None:
            env_seed = os.environ.get("AUTHORINO_TPU_FAULT_SEED", "")
            seed = int(env_seed) if env_seed else 1234
        with self._lock:
            self._rules = rules
            self._armed_at = time.monotonic()
            self._rng = random.Random(seed)
            self.fired = {}
        ACTIVE = True
        log.warning("fault injection ARMED: %s",
                    "; ".join(r.describe() for r in rules))

    def disarm(self) -> None:
        global ACTIVE
        with self._lock:
            self._rules = []
        ACTIVE = False

    def describe(self) -> Dict[str, Any]:
        """JSON-safe state for /debug/vars."""
        with self._lock:
            return {
                "armed": bool(self._rules),
                "rules": [r.describe() for r in self._rules],
                "armed_for_s": (time.monotonic() - self._armed_at
                                if self._rules else 0.0),
                "fired": dict(self.fired),
            }

    # -- hooks (hot path; callers gate on faults.ACTIVE) -------------------

    def _match(self, stage: str, lane: str,
               device: Optional[int] = None) -> Optional[FaultRule]:
        with self._lock:
            elapsed = time.monotonic() - self._armed_at
            for r in self._rules:
                if r.stage != stage or r.mode == "hang":
                    continue  # hang rules fire at wrap_handle, not here
                if r.mode == "delay" and r.stage != "encode":
                    # device-stage delays model a SLOW DEVICE: they ride
                    # wrap_handle as readback latency, never a sleep that
                    # stalls the encode worker
                    continue
                if r.lane not in ("*", lane):
                    continue
                if r.device is not None and r.device != device:
                    continue  # device-scoped: only probes naming it
                if device is not None and r.device is None:
                    # per-device probe, generic rule: the lane-level check
                    # already gave it its once-per-batch chance
                    continue
                if not r.live(elapsed):
                    continue
                if r.p < 1.0 and self._rng.random() >= r.p:
                    continue
                r.fired += 1
                key = f"{r.stage}:{r.mode}:{lane}"
                self.fired[key] = self.fired.get(key, 0) + 1
                return r
        return None

    def check(self, stage: str, lane: str,
              device: Optional[int] = None) -> None:
        """Raise/delay hook for one batch at ``stage``.  ``hang`` rules are
        not handled here — they ride ``wrap_handle`` at launch.  ``device``
        is the mesh device id a per-device probe names."""
        rule = self._match(stage, lane, device=device)
        if rule is None:
            return
        from ..utils import metrics as metrics_mod

        metrics_mod.injected_faults.labels(stage, rule.mode, lane).inc()
        if rule.mode == "raise":
            raise InjectedFault(
                f"injected {stage} fault ({lane} lane"
                + (f", device {device}" if rule.device is not None else "")
                + ")",
                device_id=rule.device if rule.device is not None else None)
        if rule.mode == "delay":
            time.sleep(rule.delay_s)

    def fs_fault(self, artifact: str) -> Optional[FaultRule]:
        """Durable-writer hook: the armed ``fs`` rule matching ``artifact``
        (or None).  The caller — utils/atomicio.py — realizes the crash
        shape; this method only does the rule bookkeeping, so firing
        counts, ``n=``/``for=`` windows and the seeded rng behave exactly
        like the device stages."""
        with self._lock:
            elapsed = time.monotonic() - self._armed_at
            for r in self._rules:
                if r.stage != "fs":
                    continue
                if r.artifact not in ("*", artifact):
                    continue
                if not r.live(elapsed):
                    continue
                if r.p < 1.0 and self._rng.random() >= r.p:
                    continue
                r.fired += 1
                key = f"fs:{r.mode}:{artifact}"
                self.fired[key] = self.fired.get(key, 0) + 1
                rule = r
                break
            else:
                return None
        from ..utils import metrics as metrics_mod

        metrics_mod.injected_faults.labels("fs", rule.mode, artifact).inc()
        return rule

    def rand(self) -> float:
        """One draw from the seeded rng — fs-mode writers use it to pick
        torn/short prefix lengths, so one AUTHORINO_TPU_FAULT_SEED
        reproduces the same crash bytes."""
        with self._lock:
            return self._rng.random()

    def wrap_handle(self, handle: Any, lane: str) -> Any:
        """Launch-time hook for device-stage ``hang`` and ``delay`` rules:
        the in-flight handle is wrapped so its readback never arrives
        (hang — until the rule's active window closes, when the real
        handle shows through: a recovering wedge) or arrives ``delay_s``
        late (a slow device)."""
        with self._lock:
            elapsed = time.monotonic() - self._armed_at
            rule = None
            for r in self._rules:
                if r.mode not in ("hang", "delay") or r.stage == "encode":
                    continue
                if r.device is not None:
                    continue  # device scoping is raise-only (probe-time)
                if r.lane not in ("*", lane):
                    continue
                if not r.live(elapsed):
                    continue
                if r.p < 1.0 and self._rng.random() >= r.p:
                    continue
                r.fired += 1
                key = f"{r.stage}:{r.mode}:{lane}"
                self.fired[key] = self.fired.get(key, 0) + 1
                rule = r
                break
        if rule is None:
            return handle
        from ..utils import metrics as metrics_mod

        metrics_mod.injected_faults.labels(rule.stage, rule.mode, lane).inc()
        if rule.mode == "delay":
            return HungHandle(handle,
                              release_at=time.monotonic() + rule.delay_s)
        release = (None if rule.for_s is None
                   else self._armed_at + rule.after_s + rule.for_s)
        return HungHandle(handle, release_at=release)


FAULTS = FaultPlane()
