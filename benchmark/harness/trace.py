"""A traced run's device timeline (``traced_server.py``'s profiler trace)
reduced to what the metrics read: every kernel, copy and set the card
ran inside the traced window, how long the card was busy and where it
sat idle.

Times are put on the host's monotonic clock by the anchor kernel: its
start in the trace lies between the host's times around its launch and
completion, so the trace's times are off by at most half that span."""

from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

KERNEL = "fused_megakernel"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class Op:
    name: str
    start: float      # host monotonic seconds
    end: float
    called: float     # the host's call that enqueued it (or its start)


@dataclass
class DeviceTrace:
    window: Tuple[float, float]
    ops: List[Op] = field(default_factory=list)   # started in the window
    anchor_error_s: float = 0.0

    @classmethod
    def read(cls, path: str, window: Tuple[float, float]
             ) -> Optional["DeviceTrace"]:
        """None where the run was not traced on a card."""
        meta_path = Path(path + ".anchor.json")
        if not meta_path.is_file():
            return None
        meta = json.loads(meta_path.read_text())
        if not meta.get("trace") or not Path(path).is_file():
            return None
        with open(path) as f:
            d = json.load(f)
        events = d["traceEvents"] if isinstance(d, dict) else d
        dev = sorted((e for e in events if e.get("cat") in DEVICE_CATS
                      and "dur" in e), key=lambda e: float(e["ts"]))
        kernels = [e for e in dev if e["cat"] == "kernel"]
        if len(kernels) <= meta["kernels_before"]:
            raise ValueError("the profiler's trace holds no anchor kernel")
        t0, t1 = meta["host_t0"], meta["host_t1"]
        a_ts = float(kernels[meta["kernels_before"]]["ts"]) * 1e-6
        offset = (t0 + t1) / 2 - a_ts

        called: Dict[int, float] = {}
        for e in events:
            if e.get("cat") in HOST_CATS:
                c = (e.get("args") or {}).get("correlation")
                if c is not None:
                    called[c] = float(e["ts"]) * 1e-6 + offset
        a, b = window
        ops = []
        for e in dev:
            s = float(e["ts"]) * 1e-6 + offset
            if not a <= s < b:
                continue
            c = (e.get("args") or {}).get("correlation")
            ops.append(Op(e.get("name", "?"), s, s + float(e["dur"]) * 1e-6,
                          called.get(c, s)))
        return cls(window, ops, (t1 - t0) / 2)

    @property
    def span_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernel_durations(self) -> List[float]:
        """Each mega-kernel's device time."""
        return [o.end - o.start for o in self.ops if KERNEL in o.name]

    def merged(self) -> List[List[float]]:
        """Union of the ops' intervals clipped to the window, each with
        the host time of the call that began it."""
        out: List[List[float]] = []
        for o in self.ops:
            end = min(o.end, self.window[1])
            if out and o.start <= out[-1][2]:
                out[-1][2] = max(out[-1][2], end)
            else:
                out.append([o.called, o.start, end])
        return out

    @property
    def busy_s(self) -> float:
        return sum(k1 - k0 for _, k0, k1 in self.merged())

    def top_device_ops(self, k: int = 10) -> List[list]:
        by: Dict[str, float] = defaultdict(float)
        for o in self.ops:
            by[o.name] += min(o.end, self.window[1]) - o.start
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The ``k`` longest stretches of the window with nothing running
        on the card, each named by what held the next op back: the host
        had not called it yet, or it was called and waited on its
        stream."""
        gaps, t = [], self.window[0]
        for called, k0, k1 in self.merged():
            if k0 > t:
                why = ("host: the next op not yet called" if called > t
                       else "stream: the next op called, waiting to run")
                gaps.append((k0 - t, why))
            t = max(t, k1)
        if self.window[1] > t:
            gaps.append((self.window[1] - t,
                         "host: no op before the window closed"))
        gaps.sort(key=lambda g: -g[0])
        return [[why, secs] for secs, why in gaps[:k]]
