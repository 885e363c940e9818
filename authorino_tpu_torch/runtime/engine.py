"""Micro-batching policy engine on one device.

``submit(doc, config_name)`` queues one request and resolves to that
request's per-evaluator ``(rule_results [E], skipped [E])``.  Every submit
scheduled in the same event-loop iteration lands in one batch cut: the
dispatch decision is deferred one iteration (``call_soon``), so a burst of
concurrent submits is cut into batches of at most ``max_batch`` rows while a
lone request still dispatches right after its iteration.

Each batch is padded to a power-of-two bucket (≥ 16 rows) and goes
encode → pack → one staging buffer → one kernel launch → one asynchronous
D2H readback → ``unpack_verdicts`` → host-oracle re-decision of the rows the
compact encoding could not represent (``apply_host_fallback``).  Encode
runs on the event loop (the Python encoder); launched batches complete on
a worker thread, so the card works on batch N+1 while the host waits for
batch N.

``stats`` counts batches, kernel launches, rows, pad rows and the H2D/D2H
bytes per batch; ``batch_latency_s`` keeps each batch's time from its cut to
its resolved futures.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from ..compiler.compile import CompiledPolicy, ConfigRules, compile_corpus
from ..compiler.encode import encode_batch
from ..compiler.pack import pack_batch
from ..models.policy_model import apply_host_fallback, host_results
from ..ops import fused_kernel as fk
from ..ops.operands import (packed_width, resolve_device, staged_h2d_bytes,
                            to_device, unpack_verdicts)
from ..utils import bucket_pow2

__all__ = ["EngineEntry", "PolicyEngine"]


@dataclass
class EngineEntry:
    """One AuthConfig as the control plane hands it to the engine."""

    id: str
    hosts: List[str]
    runtime: Any = None
    rules: Optional[ConfigRules] = None  # compilable pattern surface


class _Snapshot:
    """Compiled corpus + its device params, swapped whole on reconcile."""

    def __init__(self, entries: Sequence[EngineEntry], members_k: int,
                 ovf_assist: Optional[bool], device):
        rules = [e.rules for e in entries if e.rules is not None]
        self.policy: Optional[CompiledPolicy] = None
        self.params = None
        if rules:
            self.policy = compile_corpus(rules, members_k=members_k,
                                         ovf_assist=ovf_assist)
            self.params = to_device(self.policy, device=device)
            fk.prewarm_fused(self.policy, self.params)


@dataclass
class _Pending:
    doc: Any
    config_name: str
    future: asyncio.Future


class PolicyEngine:
    def __init__(self, max_batch: int = 256, members_k: int = 16,
                 ovf_assist: Optional[bool] = None, device=None):
        self.max_batch = int(max_batch)
        self.members_k = members_k
        self.ovf_assist = ovf_assist
        self.device = resolve_device(device)
        self._snapshot: Optional[_Snapshot] = None
        self._queue: List[_Pending] = []
        self._scheduled = False
        self._inflight: set = set()
        # "launches": kernel launches on the card; "plain_calls": batches
        # the CPU device ran through the kernel's plain version instead
        self.stats = {"batches": 0, "launches": 0, "plain_calls": 0,
                      "rows": 0, "pad_rows": 0, "h2d_bytes": 0,
                      "d2h_bytes": 0, "host_fallback": 0}
        self.batch_latency_s: List[float] = []

    # ---- control plane ----------------------------------------------------

    def apply_snapshot(self, entries: Sequence[EngineEntry]) -> None:
        """Compile, upload and swap in a new corpus.  In-flight batches
        finish on the snapshot they were encoded against."""
        self._snapshot = _Snapshot(entries, self.members_k, self.ovf_assist,
                                   self.device)

    # ---- request path -----------------------------------------------------

    async def submit(self, doc: Any, config_name: str
                     ) -> Tuple[np.ndarray, np.ndarray]:
        snap = self._snapshot
        if snap is None or snap.policy is None:
            raise RuntimeError("no compiled snapshot is installed")
        if config_name not in snap.policy.config_ids:
            raise KeyError(f"unknown AuthConfig {config_name!r}")
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._queue.append(_Pending(doc, config_name, fut))
        if not self._scheduled:
            self._scheduled = True
            loop.call_soon(self._dispatch)
        return await fut

    def _dispatch(self) -> None:
        """Cut the queue into batches of at most ``max_batch`` and launch
        each; completions run as tasks."""
        self._scheduled = False
        while self._queue:
            batch = self._queue[:self.max_batch]
            del self._queue[:self.max_batch]
            try:
                inflight = self._encode_and_launch(self._snapshot, batch)
            except Exception as exc:  # fail this batch's requests, loudly
                for p in batch:
                    if not p.future.done():
                        p.future.set_exception(exc)
                continue
            task = asyncio.get_running_loop().create_task(
                self._complete(*inflight))
            self._inflight.add(task)
            task.add_done_callback(self._inflight.discard)

    def _encode_and_launch(self, snap: _Snapshot, batch: List[_Pending]):
        t0 = time.monotonic()
        n = len(batch)
        pad = bucket_pow2(n)
        policy = snap.policy
        docs = [p.doc for p in batch]
        rows = [policy.config_ids[p.config_name] for p in batch]
        db = pack_batch(policy, encode_batch(policy, docs, rows,
                                             batch_pad=pad))
        launches0, plain0 = fk.launches, fk.plain_calls
        handle = fk.dispatch_megakernel(snap.params, db)
        E = int(policy.eval_rule.shape[1])
        st = self.stats
        st["batches"] += 1
        st["launches"] += fk.launches - launches0
        st["plain_calls"] += fk.plain_calls - plain0
        st["rows"] += n
        st["pad_rows"] += pad
        st["h2d_bytes"] += staged_h2d_bytes(db)
        st["d2h_bytes"] += handle.nbytes
        if handle.nbytes != pad * packed_width(1 + 2 * E):
            raise RuntimeError("readback is not [pad, W] uint8")

        def finalize(packed):
            cols = unpack_verdicts(packed, 1 + 2 * E)
            own_rule = cols[:n, 1:1 + E].copy()
            own_skipped = cols[:n, 1 + E:1 + 2 * E].copy()
            fb = np.nonzero(db.host_fallback[:n])[0]
            if len(fb):
                st["host_fallback"] += len(fb)
                apply_host_fallback(
                    lambda r: host_results(policy, docs[r], rows[r])[1:],
                    fb, own_rule, own_skipped, None)
            return own_rule, own_skipped

        return batch, handle, finalize, t0

    async def _complete(self, batch, handle, finalize, t0) -> None:
        try:
            if handle.is_ready():
                packed = handle.wait()
            else:
                packed = await asyncio.get_running_loop().run_in_executor(
                    None, handle.wait)
            own_rule, own_skipped = finalize(packed)
        except Exception as exc:
            for p in batch:
                if not p.future.done():
                    p.future.set_exception(exc)
            return
        for i, p in enumerate(batch):
            if not p.future.done():
                p.future.set_result((own_rule[i], own_skipped[i]))
        self.batch_latency_s.append(time.monotonic() - t0)
