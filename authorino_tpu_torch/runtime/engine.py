"""Micro-batching policy engine on one device, and the Check() request path
in front of it.

``check(request)`` is the full request-time flow: host lookup in the
snapshot's ``HostIndex`` (with a retry that strips ``:port``), then the
AuthConfig's five-phase ``AuthPipeline``, whose pattern-matching evaluators
reach the engine through ``provider_for``.

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

A batch that fails (encode, launch, readback) fails its requests with a
typed ``CheckAbort(UNAVAILABLE)``, which the pipeline passes through as the
Check()'s code: never the raw exception, whose text would otherwise become
a deny reason, and never a switch to the host oracle or the plain version.
The raw cause is logged and the batch counted in ``stats["failed_batches"]``.

``stats`` counts batches, kernel launches, rows, pad rows and the H2D/D2H
bytes per batch; ``batch_latency_s`` keeps each batch's time from its cut to
its resolved futures.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from ..authjson.wellknown import CheckRequestModel
from ..compiler.compile import CompiledPolicy, ConfigRules, compile_corpus
from ..compiler.encode import encode_batch
from ..compiler.pack import pack_batch
from ..evaluators.authorization import PatternMatching
from ..index import HostIndex
from ..models.policy_model import apply_host_fallback, host_results
from ..ops import fused_kernel as fk
from ..ops.operands import (packed_width, resolve_device, staged_h2d_bytes,
                            to_device, unpack_verdicts)
from ..pipeline import AuthPipeline, AuthResult
from ..utils import bucket_pow2
from ..utils.rpc import NOT_FOUND, UNAVAILABLE, CheckAbort
from . import provenance as prov_mod

__all__ = ["EngineEntry", "PolicyEngine"]

log = logging.getLogger(__name__)


@dataclass
class EngineEntry:
    """One AuthConfig as the control plane hands it to the engine."""

    id: str
    hosts: List[str]
    runtime: Any = None
    rules: Optional[ConfigRules] = None  # compilable pattern surface


class _Snapshot:
    """Compiled corpus + its device params + the host index of every entry
    (those without compilable rules too), swapped whole on reconcile."""

    def __init__(self, entries: Sequence[EngineEntry], members_k: int,
                 ovf_assist: Optional[bool], device, override: bool = True):
        self.index: HostIndex[EngineEntry] = HostIndex()
        for e in entries:
            for host in e.hosts:
                self.index.set(e.id, host, e, override=override)
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
                 ovf_assist: Optional[bool] = None, device=None,
                 timeout_s: Optional[float] = None):
        self.max_batch = int(max_batch)
        self.members_k = members_k
        self.ovf_assist = ovf_assist
        self.device = resolve_device(device)
        self.timeout_s = timeout_s  # bound of one Check()'s pipeline
        self._snapshot: Optional[_Snapshot] = None
        self._queue: List[_Pending] = []
        self._scheduled = False
        self._inflight: set = set()
        # "launches": kernel launches on the card; "plain_calls": batches
        # the CPU device ran through the kernel's plain version instead;
        # "failed_batches": batches whose requests got UNAVAILABLE
        self.stats = {"batches": 0, "launches": 0, "plain_calls": 0,
                      "rows": 0, "pad_rows": 0, "h2d_bytes": 0,
                      "d2h_bytes": 0, "host_fallback": 0,
                      "failed_batches": 0}
        self.batch_latency_s: List[float] = []

    # ---- control plane ----------------------------------------------------

    def apply_snapshot(self, entries: Sequence[EngineEntry],
                       override: bool = True) -> None:
        """Index, compile, upload and swap in a new corpus.  The host index
        rides on the snapshot, so one store swaps both: a lookup never
        finds an entry whose config the installed snapshot lacks.
        In-flight batches finish on the snapshot they were encoded
        against.  An entry whose pattern evaluators are not bound to this
        engine is refused (ValueError) before anything is swapped."""
        for e in entries:
            self._check_bound(e)
        self._snapshot = _Snapshot(entries, self.members_k, self.ovf_assist,
                                   self.device, override=override)

    def _check_bound(self, entry: EngineEntry) -> None:
        """Every PatternMatching of ``entry`` must take its verdicts from
        this engine's provider for the entry's compiled config, at a slot
        that config has: its decisions are the kernel's, never another
        engine's."""
        slots = len(entry.rules.evaluators) if entry.rules is not None else 0
        for conf in getattr(entry.runtime, "authorization", ()):
            ev = conf.evaluator
            if not isinstance(ev, PatternMatching):
                continue
            provider = ev.batched_provider
            if (getattr(provider, "engine", None) is not self
                    or entry.rules is None
                    or getattr(provider, "config_name", None)
                    != entry.rules.name
                    or not 0 <= ev.evaluator_slot < slots):
                raise ValueError(
                    f"AuthConfig {entry.id!r}: pattern evaluator "
                    f"{conf.name!r} is not bound to this engine's compiled "
                    "config (translate it with engine= this engine)")

    @property
    def index(self) -> HostIndex:
        snap = self._snapshot
        return snap.index if snap is not None else HostIndex()

    # ---- request path -----------------------------------------------------

    def lookup(self, host: str) -> Optional[EngineEntry]:
        """Host lookup with :port-stripping retry
        (ref: pkg/service/auth.go:270-289)."""
        index = self.index
        entry = index.get(host)
        if entry is None and ":" in host:
            entry = index.get(host.rsplit(":", 1)[0])
        return entry

    async def check(self, request: CheckRequestModel, span=None,
                    deadline: Optional[float] = None) -> AuthResult:
        """Full request-time flow (ref: pkg/service/auth.go:239-310).
        ``deadline`` is the propagated Envoy Check() deadline (monotonic
        seconds): it bounds the pipeline below ``timeout_s``."""
        entry = self.lookup(request.host())
        if entry is None:
            return AuthResult(code=NOT_FOUND, message="Service not found")
        pipeline = AuthPipeline(request, entry.runtime, timeout=self.timeout_s,
                                span=span, deadline=deadline)
        return await pipeline.evaluate()

    def provider_for(self, config_name: str):
        """BatchedVerdictProvider bound to one compiled config — handed to
        PatternMatching evaluators at translate time."""

        async def provider(pipeline, evaluator_slot: int) -> Tuple[bool, bool]:
            rule, skipped, snap = await self.submit(
                pipeline.authorization_json(), config_name,
                return_snapshot=True)
            # pin the evaluating snapshot on the pipeline: a deny built
            # moments later attributes against THIS corpus, not whatever
            # a concurrent reconcile swapped in since
            pipeline.eval_snapshot = snap
            e = evaluator_slot
            return bool(rule[e]), bool(skipped[e])

        provider.engine = self  # read by _check_bound at apply_snapshot
        provider.config_name = config_name
        return provider

    def attribution_for(self, config_name: str):
        """Deny-attribution resolver bound to one config, handed to
        PatternMatching evaluators at translate time alongside
        provider_for.  Returns the provenance dict for Envoy
        dynamic_metadata / X-Ext-Auth-Reason, or None when no compiled
        snapshot covers the config."""

        def attributor(evaluator_slot: int, snap=None):
            # prefer the snapshot that evaluated the request (pinned on
            # the pipeline by provider_for); fall back to the serving one
            if snap is None:
                snap = self._snapshot
            policy = snap.policy if snap is not None else None
            if policy is None or config_name not in policy.config_ids:
                return None
            sources = policy.rule_sources()[policy.config_ids[config_name]]
            src = (sources[evaluator_slot]
                   if 0 <= evaluator_slot < len(sources) else "")
            return prov_mod.deny_provenance(config_name, evaluator_slot,
                                            src, lane="engine")

        return attributor

    async def submit(self, doc: Any, config_name: str,
                     return_snapshot: bool = False):
        """Queue one request for the next micro-batch; resolves to that
        request's per-evaluator ``(rule_results [E], skipped [E])``, plus
        the snapshot that evaluated it when ``return_snapshot``."""
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
        rule, skipped, used = await fut
        return (rule, skipped, used) if return_snapshot else (rule, skipped)

    def _fail(self, batch: List[_Pending], exc: Exception) -> None:
        """Fail a batch's unresolved requests with a TYPED CheckAbort —
        never the raw exception, whose text would otherwise serve as a
        deny reason; the raw cause is logged here.  There is no degrade
        path: the batch's requests answer UNAVAILABLE."""
        log.error("batch of %d failed: %r", len(batch), exc, exc_info=exc)
        self.stats["failed_batches"] += 1
        abort = CheckAbort(UNAVAILABLE, "policy evaluation unavailable")
        for p in batch:
            if not p.future.done():
                p.future.set_exception(abort)

    def _dispatch(self) -> None:
        """Cut the queue into batches of at most ``max_batch`` and launch
        each; completions run as tasks."""
        self._scheduled = False
        while self._queue:
            batch = self._queue[:self.max_batch]
            del self._queue[:self.max_batch]
            try:
                inflight = self._encode_and_launch(self._snapshot, batch)
            except Exception as exc:
                self._fail(batch, exc)
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

        return batch, handle, finalize, t0, snap

    async def _complete(self, batch, handle, finalize, t0, snap) -> None:
        try:
            if handle.is_ready():
                packed = handle.wait()
            else:
                packed = await asyncio.get_running_loop().run_in_executor(
                    None, handle.wait)
            own_rule, own_skipped = finalize(packed)
        except Exception as exc:
            self._fail(batch, exc)
            return
        for i, p in enumerate(batch):
            if not p.future.done():
                p.future.set_result((own_rule[i], own_skipped[i], snap))
        self.batch_latency_s.append(time.monotonic() - t0)
