"""Micro-batching policy engine on one device, and the Check() request path
in front of it.

``check(request)`` is the full request-time flow: host lookup in the
snapshot's ``HostIndex`` (with a retry that strips ``:port``), then the
AuthConfig's five-phase ``AuthPipeline``, whose pattern-matching evaluators
reach the engine through ``provider_for`` (which carries the Check()'s
span and deadline into ``submit``).

``submit(doc, config_name)`` admits one request and resolves to that
request's per-evaluator ``(rule_results [E], skipped [E])``.  Dispatch is a
three-stage pipeline shared by every event loop (futures resolve on their
own loop through ``call_soon_threadsafe``):

  1. admission — ``AdmissionController`` (runtime/admission.py) rejects,
     typed and before the request queues, work past the queue caps
     (RESOURCE_EXHAUSTED) and work whose deadline lands inside the
     predicted wait + one device round trip (DEADLINE_EXCEEDED); a
     draining engine answers UNAVAILABLE;
  2. cut + encode — the dispatch decision is deferred one loop iteration
     (``call_soon``), so a burst of concurrent submits lands in one cut;
     batches of at most ``max_batch`` are cut while the in-flight window
     (``AdaptiveWindow``, at most ``max_inflight_batches``) has a free
     slot, and each cut goes to the process-wide encode pool.  There a
     worker sheds the requests whose deadline passed, encodes (the
     snapshot's native encoder where its corpus allows) and packs the
     batch, answers the rows whose verdict is cached, collapses the
     rest to unique rows (``batch_dedup``), pads them to a power of two
     ≥ 16 and launches the kernel once on them — none at all when every
     row was cached;
  3. completion — one process-wide completer thread polls the in-flight
     readbacks and finalizes each arrived batch itself: it fans the
     verdicts back out, re-decides the rows the compact encoding could not
     represent through the host oracle (``apply_host_fallback``), fills
     the verdict cache, folds the batch's which-rule-fired columns into
     the snapshot's rule heat map (and samples the decision log), and
     resolves the futures; the freed slot cuts the next batch.
     Completion order is arrival order, not launch order.
     (The reference hands finalize to the encode pool; with a Python
     encoder holding the interpreter lock that hand-off queues a finished
     batch behind every encode job of its burst, so here the completer
     finalizes.)

A batch that fails (encode, launch, readback, or a readback wedged past
``device_timeout_s``) counts against the device circuit breaker
(runtime/breaker.py) and is retried once on a fresh dispatch on the same
card.  ``breaker_threshold`` consecutive failures trip the breaker OPEN:
whole batches then stay off the card until, ``breaker_reset_s`` later, one
half-open probe batch launches the kernel again and closes it.  What a
batch the card did not decide answers (its retry failed, or the open
breaker kept it off the card) depends on the engine's device:

  * on a card, a typed ``CheckAbort(UNAVAILABLE)``: the port serves no
    verdict its kernel did not compute, so a failing card fails loudly
    and the caller (Envoy's failure mode, a peer replica) decides;
  * on the CPU, every request is re-decided exactly, row by row, by the
    host expression oracle (``host_results``, the kernel's
    differential-test reference), as the reference's ``_degrade_batch``
    does.  The degrade is loud: every degraded row counts in
    ``auth_server_degraded_decisions_total``, ``stats["degraded_rows"]``,
    the cost ledger's ``host`` lane (no launch) and a batch record with no
    launch; only a row whose oracle run itself fails answers UNAVAILABLE.

Either end runs on the encode pool, never on the completer, so one sick
batch does not stall the other completions.  Every transition logs a
WARNING and records a flight event, and entering OPEN writes a bundle.  A
request with no compiled snapshot to decide it answers UNAVAILABLE too;
the pipeline passes the typed code through as the Check()'s, never the raw
exception, whose text would otherwise become a deny reason.  The fault
plane (runtime/faults.py) hooks encode, H2D staging, the launch
(``wrap_handle``) and the readback.

The verdict cache is keyed by (the config's cache token, the encoded row's
bytes): the token (snapshots/fingerprint.py) is the encoding epoch and the
config's source fingerprint, so a swap that leaves a config unchanged keeps
its entries reachable and one that changes it makes them unreachable.
Rows of a config compiled uncacheable and lossy host-fallback rows never
enter the cache.

``stats`` counts batches (one per dispatch attempt), kernel launches, plain
calls, rows, device rows, rows saved by dedup and by the cache, batches the
cache answered whole, pad rows and H2D/D2H bytes of what went to the
device, host-fallback rows, retries, failed batches, deadline sheds,
watchdog timeouts, degraded rows and batches (CPU only), and the batches
the open breaker kept off the card; ``batch_records`` keeps the
same per batch with the generation of the snapshot the batch was cut
against (a degraded batch's record has no launch and names its reason),
and ``batch_latency_s`` each device batch's time from its encode to its
verdicts.  The structural contract: one launch per batch with at least one
unique uncached row and none for a batch the cache answers whole; D2H = Σ
pad_u × W; rows = device rows + rows saved by dedup + rows saved by the
cache + degraded rows.  During a canary a batch is one (cut, cohort) part:
a cut that holds both cohorts makes two, each on its own generation.

The observability planes ride the reference's sites: the encode and launch
stages are timed in the encode stage and the device and resolve stages
at completion (``auth_server_pipeline_stage_seconds``); each cut folds
once into the process-wide cost ledger (``runtime/kernel_cost.py``: one
device computation per cut with a device row, none for one the cache
answered whole) and each completed batch into the batch families with
its true per-request queue waits and, behind ``slo_ms``, into the SLO
tracker; a swap, a reconcile (its compile, diff and upload phases), a
watchdog fire and a drain are flight-recorder events, and each generation
gets a modeled kernel cost.  Every plane is advisory: its fault is logged and
never changes a verdict or re-dispatches a batch.

``apply_snapshot`` may run on a worker thread (the reconciler calls it
through ``asyncio.to_thread``) while batches are in flight: the new corpus
compiles, uploads and passes the probe kernel before it is published under
the swap lock, every batch keeps the snapshot it was cut against, and the
old snapshot's device memory goes when its last in-flight batch resolves.
The install is incremental where the compile cache allows: only the
configs whose source changed build their artifacts (canonical trees,
interned constants, determinized regexes), though the corpus is still
lowered whole, and only the operand rows that moved are shipped, into
fresh tensors (the old snapshot's are never written); the same corpus
again reuses the installed params outright.
Swap listeners fire after each swap, and ``notify_swap_listeners`` fires
them without one (the Secret reconciler after an in-place rotation).

Change safety (runtime/change_safety.py) rides the swap: with
``canary_fraction`` > 0 a corpus-changing reconcile serves a hash cohort
of requests (over host|path|method) from the new generation while the
rest stays on the old one, both generations' params on the device at
once; the host index is the reconcile's from the start.  The guards fold
per part (deny, per-config deny, typed-error and SLO rates by cohort); a
breach rolls back to a clone of the retained baseline and quarantines
the poison configs (the rest of the reconcile re-applied without them), a
clean window promotes.  The swap listeners fire only at promotion or
rollback.  A bounded history of earlier generations (params included)
backs ``rollback_last``, a pointer swap: nothing compiled, nothing
uploaded.

The tenant QoS plane (``tenancy/``) rides admission, the cut and the
per-batch fold: the tenant is the AuthConfig, weighted by its annotations.
Admission rejects a tenant past its quota, its queue share or its
containment allowance, typed and tenant-scoped, before the global gate; a
contended cut is a weighted deficit round robin; a contained tenant's rows
ride parts of their own behind each cut's others, on the device (the
reference sends them to its host-oracle lane); every lane's fold counts
each tenant's requests, denies, waits and SLO burn.

The reconcile gates a candidate on the host before any byte of it is
staged on the device: strict verify (``strict_verify``: the tensor lint of
the fused operands and the per-config program, then translation
validation against the host oracle with a process-wide certificate cache)
and the replay pregate (``replay_pregate``: the capture ring replayed
through both snapshots' host oracles, judged by the canary guard
thresholds).  A rejected candidate raises ``SnapshotRejected`` and the
serving snapshot stays.  Each reconcile then runs the advisory policy
analysis and lowerability report (``analyze_policies``), and the metadata
prefetcher (``metadata_prefetch``) pins the snapshot's request-independent
metadata documents.  The per-batch fold offers each sampled decision to
the capture log (``replay/capture.py``), whose own thread encodes it.

The mesh lane (``mesh=``, parallel/sharded_eval.py): the corpus compiles as
a ``ShardedPolicyModel``, its configs round-robined over the mesh's ``mp``
shards, the batch split over ``dp``.  A batch's rows key dedup and the
verdict cache by their (shard, row) tokens and launch through
``dispatch_routed``: per-device breakers, failover to the emptiest healthy
device, and with every device down the retry path (UNAVAILABLE on a card,
the host oracle on the CPU).  The fleet plane (fleet/) reads
``fleet_health`` and ``fleet_fold``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..authjson.wellknown import CheckRequestModel
from ..compiler.compile import CompiledPolicy, ConfigRules
from ..compiler.encode import encode_batch
from ..compiler.pack import batch_row_keys, dedup_rows, pack_batch, select_rows
from ..evaluators.authorization import PatternMatching
from ..index import HostIndex
from ..models.policy_model import apply_host_fallback, host_results
from ..native import get_native_encoder
from ..ops import fused_kernel as fk
from ..ops import pattern_eval as pe
from ..ops.operands import (firing_columns, host_view, packed_width,
                            resolve_device, staged_h2d_bytes,
                            unpack_verdicts)
from ..pipeline import AuthPipeline, AuthResult
from ..relations.prefetch import MetadataPrefetcher
from ..replay.capture import CAPTURE
from ..snapshots.compile_cache import CompileCache, CompileReport
from ..snapshots.delta import apply_delta
from ..snapshots.diff import plan_delta, snapshot_diff
from ..snapshots.fingerprint import cache_tokens, rules_fingerprint
from ..tenancy import TenantPlane
from ..utils import bucket_pow2
from ..utils import metrics as metrics_mod
from ..utils import tracing as tracing_mod
from ..utils.rpc import DEADLINE_EXCEEDED, NOT_FOUND, UNAVAILABLE, CheckAbort
from ..utils.slo import SloTracker
from ..utils.verdict_cache import VerdictCache
from . import change_safety as safety_mod
from . import faults
from . import kernel_cost as kernel_cost_mod
from . import provenance as prov_mod
from .admission import AdaptiveWindow, AdmissionController
from .breaker import CircuitBreaker
from .flight_recorder import RECORDER
from .kernel_cost import LEDGER, CostModel

__all__ = ["EngineEntry", "PolicyEngine", "SnapshotRejected"]

log = logging.getLogger(__name__)

# per-batch records and batch latencies kept (the newest)
BATCH_RECORDS = 65536

_STAT_KEYS = ("batches", "launches", "plain_calls", "rows", "device_rows",
              "dedup_rows", "cache_rows", "cached_batches", "pad_rows",
              "h2d_bytes", "d2h_bytes", "host_fallback", "retries",
              "failed_batches", "deadline_shed", "watchdog_timeouts",
              "degraded_rows", "degraded_batches", "breaker_open_batches",
              "contained_parts", "contained_rows")


class SnapshotRejected(RuntimeError):
    """A compiled snapshot failed a reconcile gate (strict verify's tensor
    lint or translation validation, or the replay pregate).  The snapshot
    that was serving stays live; ``findings`` says why."""

    def __init__(self, findings):
        self.findings = findings
        super().__init__(
            f"snapshot rejected by tensor lint ({len(findings)} finding(s)): "
            + "; ".join(str(f) for f in findings[:3]))


@dataclass
class EngineEntry:
    """One AuthConfig as the control plane hands it to the engine."""

    id: str
    hosts: List[str]
    runtime: Any = None
    rules: Optional[ConfigRules] = None  # compilable pattern surface
    # AuthConfig metadata.annotations: the tenant QoS plane resolves each
    # tenant's weight and quota from these at every install
    annotations: Optional[Dict[str, str]] = None


class _Snapshot:
    """Compiled corpus + its device params + the host index of every entry
    (those without compilable rules too), swapped whole on reconcile.
    ``generation`` is set at the swap; ``entries`` are the installed
    entries (the native frontend reads them); ``cache_tokens`` key the
    verdict cache per config row.  The corpus's native encoder is built here (None
    for a corpus outside its domain): a failed build fails the install,
    never a batch.  ``heat`` is the corpus's rule heat map.

    The install is incremental against ``prev`` (the serving snapshot):
    compile goes through the engine's compile cache, so only configs whose
    source fingerprint is new build their artifacts (the corpus is still
    lowered whole); a fingerprint-identical corpus
    reuses ``prev``'s policy, params, host view, cache tokens, native
    encoder and heat map outright (upload mode ``reuse``, nothing shipped);
    otherwise the new host view is diffed against ``prev``'s and only the
    changed rows are shipped, into fresh tensors (snapshots/delta.py).

    The install has two halves.  The constructor is the host half: the
    index, the compile and, with ``strict_verify``, the tensor lint and
    translation validation (``_verify``; a reuse skips it only when
    ``prev`` was vetted).  ``stage`` is the device half (encoder, host
    view, diff, upload, probe).  A gate between them (the replay pregate)
    rejects a candidate before any byte of it reaches the device."""

    # the kernel lane this snapshot's operands are built for (None: the
    # environment's, ``pattern_eval.to_device``).  A class-level default:
    # a loaded snapshot (``from_published``) resolves the lane from the
    # environment like any lane-unaware caller
    kernel_lane: Optional[str] = None

    def __init__(self, entries: Sequence[EngineEntry], members_k: int,
                 ovf_assist: Optional[bool], compile_cache: CompileCache,
                 prev: "Optional[_Snapshot]" = None, override: bool = True,
                 strict_verify: bool = False,
                 kernel_lane: Optional[str] = None, mesh=None,
                 breaker_threshold: int = 3,
                 breaker_reset_s: float = 5.0):
        self.kernel_lane = kernel_lane
        self.index: HostIndex[EngineEntry] = HostIndex()
        self.entries: List[EngineEntry] = list(entries)
        self.by_id: Dict[str, EngineEntry] = {e.id: e for e in entries}
        # the rollback or quarantine record of a snapshot that is one (set
        # on rollback clones and quarantine re-applies)
        self.change_safety: Optional[Dict[str, Any]] = None
        for e in entries:
            for host in e.hosts:
                self.index.set(e.id, host, e, override=override)
        rules = [e.rules for e in entries if e.rules is not None]
        self.generation = 0
        self.policy: Optional[CompiledPolicy] = None
        self.params = None
        self.host_view = None
        self.fingerprints: Dict[str, str] = {}
        self.cache_tokens = None
        self.encoder = None
        self.encoder_build_s = 0.0
        self.heat: Optional[prov_mod.HeatMap] = None
        self.compile_report: Optional[CompileReport] = None
        self.upload: Optional[Dict[str, Any]] = None
        # strict verify: True once the tensor lint and translation
        # validation passed (or the vetted predecessor's artifacts were
        # reused); ``translation`` holds the certification's counts
        self.lint_ok = False
        self.translation: Optional[Dict[str, int]] = None
        # reconcile phases, seconds: compile (the incremental corpus
        # compile, its fingerprints and cache tokens), validate (strict
        # verify), diff (the new host view with the per-config program,
        # and its delta plan), upload (the planned rows or whole tensors
        # to the device, the probe launch)
        self.phase_s: Dict[str, float] = {}
        # the manifest digest of a snapshot loaded from a publisher
        # (``from_published``), None for one compiled here: a publisher
        # never republishes a loaded snapshot (the fleet's loop breaker)
        self.published_origin: Optional[str] = None
        # the mesh lane (parallel/sharded_eval.py): the rules-sharded
        # corpus, and its verdict-cache tokens indexed [shard][row]
        self.sharded = None
        self.mesh_tokens = None
        if not rules:
            return
        if mesh is not None:
            self._compile_mesh(rules, members_k, mesh, strict_verify, prev,
                               breaker_threshold, breaker_reset_s,
                               ovf_assist=ovf_assist,
                               kernel_lane=kernel_lane)
            return
        prev_ok = prev is not None and prev.policy is not None
        t0 = time.perf_counter()
        self.policy, report = compile_cache.compile(
            rules, members_k=members_k,
            prev_fps=prev.fingerprints if prev_ok else None,
            prev_policy=prev.policy if prev_ok else None,
            ovf_assist=ovf_assist)
        self.compile_report = report
        self.fingerprints = dict(report.fingerprints)
        if report.reused_policy and (prev.lint_ok or not strict_verify):
            # fingerprint-identical corpus: the previous snapshot's device
            # state serves as-is, and so does its vetting: every config's
            # certificate is (trivially) a cache hit, nothing re-validated
            self.lint_ok = prev.lint_ok
            self.translation = (
                {"validated": 0, "cache_hits": len(prev.policy.config_ids),
                 "failed": 0, "sampled": 0, "dfa_witnesses": 0}
                if strict_verify and prev.lint_ok else prev.translation)
            self.params = prev.params
            self.host_view = prev.host_view
            self.cache_tokens = prev.cache_tokens
            self.encoder = prev.encoder
            self.heat = prev.heat
            self.upload = {"mode": "reuse", "upload_bytes": 0,
                           "full_bytes": 0, "arrays_reused": None,
                           "arrays_touched": []}
            self.phase_s["compile"] = time.perf_counter() - t0
            return
        self.cache_tokens = cache_tokens(self.policy, self.fingerprints)
        self.phase_s["compile"] = time.perf_counter() - t0
        if strict_verify:
            # lint and certify BEFORE the host view is built and anything
            # is staged: a miscompiled corpus is rejected on the host and
            # never reaches the device (nor crashes mid-operand-build)
            t0 = time.perf_counter()
            self._verify()
            self.phase_s["validate"] = time.perf_counter() - t0

    def _compile_mesh(self, rules, members_k: int, mesh, strict_verify: bool,
                      prev: "Optional[_Snapshot]", breaker_threshold: int,
                      breaker_reset_s: float,
                      ovf_assist: Optional[bool] = None,
                      kernel_lane: Optional[str] = None) -> None:
        """The host half of a mesh install: compile the shards with the
        stacked host operands (``defer_upload``), fingerprint, strict
        verify (the packed shards are linted before any byte is staged),
        and the [shard][row] cache tokens.  The previous mesh snapshot's
        interner is adopted (insert-only: ids stay stable), so an
        untouched shard keeps its encoding epoch and its cached verdicts
        across the swap."""
        from ..parallel import ShardedPolicyModel

        t0 = time.perf_counter()
        prev_ok = (prev is not None and prev.sharded is not None
                   and prev.sharded.mesh is mesh)
        self.sharded = ShardedPolicyModel(
            rules, mesh, members_k=members_k,
            interner=(prev.sharded.interner if prev_ok else None),
            defer_upload=True, breaker_threshold=breaker_threshold,
            breaker_reset_s=breaker_reset_s, ovf_assist=ovf_assist,
            kernel_lane=kernel_lane)
        memo: Dict[int, str] = {}
        self.fingerprints = {c.name: rules_fingerprint(c, memo)
                             for c in rules}
        self.phase_s["compile"] = time.perf_counter() - t0
        if strict_verify:
            t0 = time.perf_counter()
            self._verify()
            self.phase_s["validate"] = time.perf_counter() - t0
        self.mesh_tokens = self.sharded.cache_tokens(self.fingerprints)

    @property
    def compiled(self) -> bool:
        """True when the snapshot holds a compiled corpus (single or
        mesh-sharded); False for the bootstrap deny-all."""
        return self.policy is not None or self.sharded is not None

    def has_config(self, name: str) -> bool:
        if self.sharded is not None:
            return name in self.sharded.locator
        return self.policy is not None and name in self.policy.config_ids

    def stage(self, device, prev: "Optional[_Snapshot]" = None) -> None:
        """The device half of the install: the native encoder, the host
        view and its delta plan against ``prev`` (the serving snapshot the
        compile ran against), the upload and the probe.  The engine calls
        it once the candidate passed every host-side gate (strict verify,
        the replay pregate), so a rejected candidate stages no byte.  A
        reused corpus has nothing to stage; a snapshot with no compiled
        config (the bootstrap deny-all) has nothing to upload, but the card
        still proves it launches.  A mesh snapshot stages each shard onto
        its mesh column, per-shard delta against a previous mesh snapshot
        on the same mesh."""
        if self.sharded is not None:
            if self.upload is not None:
                return
            prev_ok = (prev is not None and prev.sharded is not None
                       and prev.sharded.mesh is self.sharded.mesh)
            t0 = time.perf_counter()
            self.upload = self.sharded.upload(
                prev.sharded if prev_ok else None)
            self.phase_s["upload"] = time.perf_counter() - t0
            try:
                self.heat = prov_mod.HeatMap.for_snapshot(
                    None, sharded=self.sharded)
            except Exception:
                log.exception("rule heat map build failed (swap unaffected)")
            return
        if self.policy is None:
            if device.type == "cuda":
                fk.fused_kernel_supported(device, recheck=True)
            return
        if self.upload is not None:
            return
        prev_ok = prev is not None and prev.policy is not None
        t0 = time.perf_counter()
        self.encoder = get_native_encoder(self.policy)
        self.encoder_build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.host_view = host_view(pe.to_device(
            self.policy, device=device, host=True, lane=self.kernel_lane))
        plan = (plan_delta(prev.host_view, self.host_view)
                if prev_ok and prev.params is not None else None)
        self.phase_s["diff"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        # no plan: apply_delta stages every operand
        self.params, uploaded = apply_delta(
            prev.params if plan is not None else None, self.host_view, plan,
            device)
        self.upload = (plan.to_json() if plan is not None else
                       {"mode": "full", "full_bytes": uploaded,
                        "arrays_reused": 0, "arrays_touched": []})
        self.upload["upload_bytes"] = uploaded
        fk.prewarm_fused(self.policy, self.params)
        self.phase_s["upload"] = time.perf_counter() - t0
        try:
            self.heat = prov_mod.HeatMap.for_snapshot(self.policy)
        except Exception:
            log.exception("rule heat map build failed (swap unaffected)")

    def _verify(self) -> None:
        """Strict verify: the tensor lint (structural invariants the kernel
        assumes), then translation validation (the compiled circuits and
        DFA tables decide like the host expression oracle; per-config
        fingerprints and the process-wide certificate cache make an
        unchanged config a cache hit).  Raises SnapshotRejected with the
        findings; sets ``lint_ok`` and the ``translation`` counts."""
        from ..analysis.tensor_lint import lint_snapshot
        from ..analysis.translation_validate import (certify_snapshot,
                                                     snapshot_policies)

        findings = lint_snapshot(self)
        if findings:
            raise SnapshotRejected(findings)
        stats = {"validated": 0, "cache_hits": 0, "failed": 0,
                 "sampled": 0, "dfa_witnesses": 0}
        failures = []
        for pol in snapshot_policies(self):
            _, fails, st = certify_snapshot(pol)
            failures += fails
            for k in stats:
                stats[k] += st.get(k, 0)
        self.translation = stats
        if failures:
            raise SnapshotRejected(failures)
        self.lint_ok = True

    @classmethod
    def from_published(cls, loaded, strict_verify: bool = False,
                       prev: "Optional[_Snapshot]" = None) -> "_Snapshot":
        """The host half of a replica's install: wrap a leader-serialized
        corpus (snapshots/distribution.py ``LoadedSnapshot``) without
        compiling anything.  The admission gate: an uncertified snapshot
        is rejected outright; with ``strict_verify`` the replica re-runs
        the tensor lint and translation validation itself (the
        fingerprint-keyed certificate cache makes repeats cheap), else the
        leader's certificate vouches for it.  Entries carry hosts only
        (``runtime=None``): a replica serves the compiled verdict lane.
        The engine then stages it like a compiled candidate."""
        if not loaded.certified:
            raise SnapshotRejected([
                "snapshot is not certified: the leader never marked it "
                "strict-verified (lint + translation certification)"])
        entries = [EngineEntry(id=cid, hosts=hosts, runtime=None, rules=None)
                   for cid, hosts in loaded.entries]
        snap = cls(entries, 0, None, None)
        snap.policy = loaded.policy
        snap.fingerprints = loaded.fingerprints
        snap.translation = (loaded.meta or {}).get("translation")
        snap.change_safety = (loaded.meta or {}).get("change_safety")
        # this snapshot was LOADED, not compiled here: the publisher skips
        # it, or a node whose source and publish directory meet (even
        # through an HTTP relay) would republish and re-apply forever
        snap.published_origin = loaded.digest or "<loaded>"
        if strict_verify:
            t0 = time.perf_counter()
            snap._verify()
            snap.phase_s["validate"] = time.perf_counter() - t0
        else:
            snap.lint_ok = True
        if prev is not None and prev.policy is not None:
            # interner continuity: every deserialize builds a fresh
            # interner (a new identity serial, so a new encoding epoch,
            # which would drop every cached verdict at each applied
            # generation); the leader's interner is insert-only, so a
            # loaded table that prefix-extends the previous one means the
            # same ids: extend and adopt the previous interner
            _adopt_interner(prev.policy.interner, loaded.policy)
        snap.cache_tokens = cache_tokens(loaded.policy, snap.fingerprints)
        return snap

    def clone(self) -> "_Snapshot":
        """Shallow re-serve copy (a rollback is a pointer swap): shares the
        compiled policy, the device params, the host index, the heat map
        and the cache tokens; only the generation and the change-safety
        record are its own, so batches pinned to the original keep
        resolving and inserting verdicts under their own generation."""
        c = _Snapshot.__new__(_Snapshot)
        c.__dict__.update(self.__dict__)
        c.change_safety = None
        return c


def _adopt_interner(prev_interner, new_policy) -> None:
    """Replica-side interner continuity (``_Snapshot.from_published``):
    when the freshly deserialized policy's id table prefix-extends the
    previous snapshot's, graft the new entries onto the previous interner
    and point the policy at it.  Ids are positional in the
    insertion-ordered table, so a true prefix match proves every shared id
    means the same string; any mismatch (a leader restarted with a fresh
    interner) keeps the new interner, a structural epoch change."""
    old_t = prev_interner._table
    new_t = new_policy.interner._table
    if len(new_t) < len(old_t):
        return
    it = iter(new_t.items())
    for want in old_t.items():
        if next(it) != want:
            return
    for s, i in new_t.items():
        if s not in old_t:
            old_t[s] = i
    new_policy.interner = prev_interner


@dataclass
class _Pending:
    doc: Any
    config_name: str
    future: asyncio.Future
    loop: Any                         # owning event loop
    span: Any = None                  # the Check()'s RequestSpan
    t_enq: float = 0.0                # monotonic enqueue time
    deadline: Optional[float] = None  # monotonic Check() deadline
    # the canary cohort, stamped at submit while a canary is in progress:
    # a cut partitions by it, so every launch rides one generation
    canary: bool = False
    # set at the cut when the tenant was contained: the row rides a part
    # of its own (its batch record says so)
    contained: bool = False


class _Resolved:
    """The handle of a batch the cache answered whole: ready at once, no
    launch, no bytes."""

    nbytes = launches = plain_calls = 0

    def is_ready(self) -> bool:
        return True

    def wait(self) -> np.ndarray:
        return np.zeros((0, 1), dtype=np.uint8)


class _Inflight:
    """One launched micro-batch riding the device window: the result
    handle plus everything the completion stage needs to finalize and
    resolve it.  ``handle`` needs ``is_ready()`` (non-blocking) and
    ``wait()`` (the readback as numpy) — tests substitute stubs."""

    __slots__ = ("engine", "batch", "handle", "finalize", "binfo", "waits",
                 "t_launch", "snap", "attempt", "route")

    def __init__(self, engine, batch, handle, finalize, binfo, waits,
                 snap=None, attempt=0):
        self.engine = engine
        self.batch = batch
        self.handle = handle
        self.finalize = finalize
        self.binfo = binfo
        self.waits = waits
        self.t_launch = time.monotonic()
        self.snap = snap          # pinned snapshot (retry path)
        self.attempt = attempt    # 0 = first dispatch, 1 = the one retry
        self.route = None         # mesh lane: the occupied device windows

    def ready(self) -> bool:
        is_ready = getattr(self.handle, "is_ready", None)
        if is_ready is None:
            return True  # no readiness probe: wait() blocks
        try:
            return bool(is_ready())
        except Exception:
            return True  # let wait() surface the real error

    def expired(self) -> bool:
        """Watchdog probe: True once this batch has been in the window
        past the engine's ``device_timeout_s``."""
        t = self.engine.device_timeout_s
        return bool(t) and (time.monotonic() - self.t_launch) > t


class PolicyEngine:
    def __init__(self, max_batch: int = 256, members_k: int = 16,
                 ovf_assist: Optional[bool] = None, device=None,
                 timeout_s: Optional[float] = None,
                 max_inflight_batches: int = 48,
                 dispatch_workers: int = 4,
                 verdict_cache_size: int = 32768,
                 batch_dedup: bool = True,
                 admission_target_s: float = 0.05,
                 admission_queue_cap: int = 0,
                 admission_min_cap: Optional[int] = None,
                 adaptive_window: bool = True,
                 device_timeout_s: Optional[float] = None,
                 slo_ms: float = 0.0,
                 breaker_threshold: int = 5,
                 breaker_reset_s: float = 5.0,
                 canary_fraction: float = 0.0,
                 canary_window_s: float = 30.0,
                 canary_thresholds=None,
                 snapshot_history: int = 4,
                 tenant_qos: bool = True,
                 tenant_default_weight: float = 1.0,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 tenant_quota_rps: float = 0.0,
                 tenant_contain_threshold: float = 3.0,
                 tenant_contain_allowance_rps: float = 100.0,
                 tenant_top_k: int = 16,
                 strict_verify: bool = False,
                 analyze_policies: bool = True,
                 metadata_prefetch: bool = True,
                 metadata_prefetch_max_age_s: float = 300.0,
                 metadata_prefetch_refresh_s: float = 60.0,
                 replay_pregate: bool = False,
                 replay_pregate_budget_s: float = 2.0,
                 corpus_pregate: str = "",
                 corpus_pregate_budget_s: float = 2.0,
                 kernel_lane: Optional[str] = None,
                 mesh: Any = "auto"):
        """``max_inflight_batches`` caps the dispatch window (launched
        batches awaiting readback); the adaptive controller tunes the live
        window inside it.  ``dispatch_workers`` sizes the process-wide
        encode pool (the first engine in the process sets it).
        ``batch_dedup`` collapses identical encoded rows of a batch before
        the launch; ``verdict_cache_size`` bounds the verdict LRU (0 turns
        it off).  ``admission_target_s``, ``admission_queue_cap`` (0 = no
        hard cap) and ``admission_min_cap`` (None = one full window of
        batches) parameterize the admission gate.  ``device_timeout_s``
        (None = off) abandons a batch whose readback has not arrived by
        then, as a breaker-counted failure.  ``breaker_threshold``
        consecutive batch failures trip the device circuit breaker OPEN
        (whole batches kept off the card: UNAVAILABLE on a card, the host
        oracle on the CPU); ``breaker_reset_s`` later one half-open probe
        batch tests the card again.
        ``timeout_s`` bounds one Check()'s
        pipeline.  ``slo_ms`` (0 = off) arms the SLO burn-rate tracker:
        a request is bad when its queue wait plus its batch's device
        stage exceeds it, or when it fails with a serving error.

        Change safety: with ``canary_fraction`` > 0, a reconcile that
        changes the compiled corpus does not swap at 100%: a deterministic
        hash-fraction of requests (runtime/change_safety.py
        ``in_canary_cohort``) rides the new generation for
        ``canary_window_s`` while the rest keeps the previous one, both
        generations' params resident on the device.  Guards
        (``canary_thresholds``: ``GuardThresholds``) compare the cohorts'
        deny, error and SLO rates; a breach rolls back (a pointer swap to
        the retained baseline) and quarantines the poison configs, a clean
        window promotes.  ``snapshot_history`` bounds the previous
        generations retained for ``rollback_last``.

        The tenant QoS plane (``tenancy/``; off with ``tenant_qos=False``):
        the tenant is the AuthConfig.  Its weight and quota come from the
        entry's annotations (``authorino.tpu/qos-class``, ``qos-weight``,
        ``qos-quota-rps``), ``tenant_weights`` overrides weights by name,
        ``tenant_default_weight`` and ``tenant_quota_rps`` are the defaults.
        A contended cut is a weighted deficit round robin over per-tenant
        virtual queues; a tenant over its quota, or past its queue share, or
        a contained tenant past ``tenant_contain_allowance_rps``, is
        rejected typed and tenant-scoped before the global gate.  A tenant
        whose served share stays over ``tenant_contain_threshold`` times its
        weighted share while the queue wait is over target is contained:
        its rows ride a part of their own at each cut, launched behind the
        cut's other parts.  ``tenant_top_k`` bounds the tenant labels of
        the metrics.

        ``strict_verify`` lints (analysis/tensor_lint.py) and certifies
        (analysis/translation_validate.py) every compiled snapshot before
        any byte of it is staged on the device: a snapshot with a finding
        raises SnapshotRejected (``auth_server_snapshot_rejected_total``)
        and the previous one keeps serving.  ``analyze_policies`` runs the
        Cedar-style semantic pass and the lowerability report once per
        reconcile: advisory, on /debug/vars and the metrics, never a gate.

        ``metadata_prefetch`` pins every request-independent metadata
        document (relations/prefetch.py) at reconcile cadence: within
        ``metadata_prefetch_max_age_s`` a pinned document serves with no
        network I/O, a stale one falls through to the live fetch;
        ``metadata_prefetch_refresh_s`` is the re-pin cadence.

        ``replay_pregate``: a corpus-changing reconcile is first replayed
        against the process's capture ring (replay/capture.py ``CAPTURE``,
        armed by ``--capture``) through the host oracle on both the serving
        and the candidate snapshot.  A verdict diff that breaches the canary
        guard thresholds rejects the candidate (SnapshotRejected and a
        ``replay-pregate-breach`` flight bundle) before it is staged on the
        device or answers a request; a clean preflight halves the canary's
        deny-delta thresholds.  ``replay_pregate_budget_s`` bounds the
        replay; records past it are reported truncated.

        ``corpus_pregate`` (a corpus file or a directory of
        ``*.atpucorp`` containers; "" = off): the same judgment over the
        long-retention decision corpus, frequency-weighted, plus synthetic
        witness rows for the rules it never saw fire (corpus/), so an edit
        to a zero-traffic rule is caught with zero live exposure; it runs
        after the replay pregate, still before the candidate is staged.  A
        missing or unreadable corpus skips, never blocks.
        ``corpus_pregate_budget_s`` bounds its replay.

        ``mesh``: "auto" and None serve the single corpus, whose batch is
        one mega-kernel launch on a card; an explicit
        ``parallel.build_mesh(devices, dp=...)`` (logical slots may repeat
        a device) always shards.  A mesh block runs the op chain, not the
        mega-kernel, so "auto" does not shard over several cards.  The mesh's
        per-device breakers take ``breaker_threshold`` and
        ``breaker_reset_s`` at the first engine that touches the mesh."""
        self.max_batch = int(max_batch)
        self.members_k = members_k
        self.ovf_assist = ovf_assist
        # fused | gather | matmul, or None: the environment's lane
        # (AUTHORINO_TPU_KERNEL_LANE, ``pattern_eval.to_device``)
        self.kernel_lane = kernel_lane
        # the mesh lane: "auto" and None serve the single corpus; an
        # explicit ``parallel.build_mesh(...)`` always shards
        self._mesh = mesh
        self.device = resolve_device(device)
        self.timeout_s = timeout_s
        self.max_inflight_batches = max(1, int(max_inflight_batches))
        self.dispatch_workers = max(1, int(dispatch_workers))
        self.batch_dedup = bool(batch_dedup)
        self.device_timeout_s = (float(device_timeout_s)
                                 if device_timeout_s else None)
        self._verdict_cache = (VerdictCache(verdict_cache_size)
                               if verdict_cache_size else None)
        # the persistent per-config compile cache (fingerprint → artifact),
        # always on: it owns the one string table of every snapshot, so ids
        # stay stable across reconciles and an unchanged config keeps its
        # encoding epoch (and its cached verdicts)
        self.compile_cache = CompileCache()
        self.generation = 0
        self._snapshot: Optional[_Snapshot] = None
        self._swap_lock = threading.Lock()
        self._queue: deque = deque()
        self._queue_lock = threading.Lock()
        self._inflight = 0
        self.inflight_peak = 0
        self._draining = False
        # EWMA of launch → readback: the shedding horizon
        self._device_ewma = 0.0
        if admission_min_cap is None:
            admission_min_cap = max(64, self.max_inflight_batches * max_batch)
        self.admission = AdmissionController(
            "engine", target_s=admission_target_s,
            queue_cap=admission_queue_cap, min_cap=admission_min_cap)
        self.controller = AdaptiveWindow(
            "engine", cap=self.max_inflight_batches, batch_cap=max_batch,
            enabled=adaptive_window)
        self.breaker = CircuitBreaker("engine", threshold=breaker_threshold,
                                      reset_s=breaker_reset_s)
        # cumulative typed serving errors (the fleet fold): requests failed
        # UNAVAILABLE with no lane left.  Deadline sheds stay out: they are
        # the protection working
        self.error_total = 0
        self._g_inflight = metrics_mod.inflight_batches.labels("engine")
        self._g_depth = metrics_mod.dispatch_queue_depth.labels("engine")
        self._swap_listeners: List[Any] = []
        self._stats_lock = threading.Lock()
        self.stats = dict.fromkeys(_STAT_KEYS, 0)
        self.batch_records: deque = deque(maxlen=BATCH_RECORDS)
        self.batch_latency_s: deque = deque(maxlen=BATCH_RECORDS)
        self.slo = SloTracker("engine", slo_ms) if slo_ms else None
        # the modeled kernel cost per generation, and the last reconcile's
        # phases (the /debug/vars control_plane block)
        self._cost_model = CostModel("engine")
        self._control_plane: Optional[Dict[str, Any]] = None
        # change safety: the canary in progress, the quarantine record
        # (poison config id -> fingerprints) with the prior entry each
        # resync substitutes back in, the bounded history of earlier
        # snapshots for manual rollback, and the last rollback's evidence
        self.canary_fraction = min(max(float(canary_fraction), 0.0), 1.0)
        self.canary_window_s = float(canary_window_s)
        self.canary_thresholds = canary_thresholds
        self._canary: Optional[safety_mod.CanaryPhase] = None
        self._quarantine: Optional[Dict[str, Any]] = None
        self._quarantine_prior: Dict[str, EngineEntry] = {}
        self._history: deque = deque(maxlen=max(1, int(snapshot_history)))
        self._last_rollback: Optional[Dict[str, Any]] = None
        self._g_canary = metrics_mod.canary_state.labels("engine")
        self._g_quarantine = metrics_mod.quarantined_configs.labels("engine")
        self.tenancy = TenantPlane(
            "engine", enabled=bool(tenant_qos),
            default_weight=tenant_default_weight,
            weight_overrides=tenant_weights,
            default_quota_rps=tenant_quota_rps,
            admission_target_s=self.admission.target_s,
            contain_threshold=tenant_contain_threshold,
            contain_allowance_rps=tenant_contain_allowance_rps,
            top_k=tenant_top_k,
            wait_ewma=lambda: self.admission.wait_ewma,
            wait_target_s=lambda: self.admission.target_s,
            # the second pressure signal: rising global rejections (the
            # wait-targeted cap holds the queue at the target, so the wait
            # alone can read healthy while cold tenants are turned away)
            # and queue-share rejections (a tenant holding more of the
            # shared queue than its share)
            reject_count=lambda: (
                self.admission.rejected.get("overload", 0)
                + self.admission.rejected.get("queue-full", 0)
                + self.admission.rejected.get("tenant-queue-share", 0)))
        # the reconcile's verification planes: strict verify gates, the
        # policy analysis and lowerability report advise (/debug/vars)
        self.strict_verify = bool(strict_verify)
        self.analyze_policies = bool(analyze_policies)
        self._analysis: Optional[Dict[str, Any]] = None
        self._lowerability: Optional[Dict[str, Any]] = None
        self.metadata_prefetcher: Optional[MetadataPrefetcher] = (
            MetadataPrefetcher(max_age_s=metadata_prefetch_max_age_s,
                               refresh_s=metadata_prefetch_refresh_s)
            if metadata_prefetch else None)
        # the replay pregate's state and its last verdict
        self.replay_pregate = bool(replay_pregate)
        self.replay_pregate_budget_s = float(replay_pregate_budget_s)
        self._last_pregate: Optional[Dict[str, Any]] = None
        self._g_replay_flips = metrics_mod.replay_diff_flips.labels("engine")
        # the corpus pregate: its source, the captured rows (loaded once),
        # the synthetic witness rows built against the serving baseline
        # (cached per baseline generation: (generation, rows, report)), and
        # the last verdict
        self.corpus_pregate = str(corpus_pregate or "")
        self.corpus_pregate_budget_s = float(corpus_pregate_budget_s)
        self._corpus_rows: Optional[list] = None
        self._corpus_load_error: Optional[str] = None
        self._corpus_synth: Tuple[int, list, Dict[str, Any]] = (-1, [], {})
        self._last_corpus_pregate: Optional[Dict[str, Any]] = None
        # the durable state plane (runtime/state_plane.py) the CLI attaches
        # with --state-dir: /readyz and /debug/vars read it
        self.state_plane = None
        RECORDER.register_provider("engine", self, "debug_vars")

    def _add_stats(self, **counts) -> None:
        with self._stats_lock:
            for k, v in counts.items():
                self.stats[k] += v

    # ---- control plane ----------------------------------------------------

    def add_swap_listener(self, cb) -> None:
        self._swap_listeners.append(cb)

    def remove_swap_listener(self, cb) -> None:
        if cb in self._swap_listeners:
            self._swap_listeners.remove(cb)

    def notify_swap_listeners(self) -> None:
        """Fire swap listeners without a corpus swap — used by the secret
        reconciler after in-place API-key/mTLS rotation
        (ref controllers/secret_controller.go:40-130 mutates evaluators in
        place)."""
        for cb in list(self._swap_listeners):
            cb()

    def apply_snapshot(self, entries: Sequence[EngineEntry],
                       override: bool = True) -> None:
        """Index, compile, upload and swap in a new corpus, incrementally
        against the serving snapshot (``_Snapshot``).  The host index
        rides on the snapshot, so one store swaps both: a lookup never
        finds an entry whose config the installed snapshot lacks.
        In-flight batches finish on the snapshot they were cut against,
        and insert and serve verdicts under its cache tokens.  An entry
        whose pattern evaluators are not bound to this engine is refused
        (ValueError) before anything is swapped.

        Change safety: still-poisoned quarantined configs are substituted
        with their prior artifacts before the compile, and a
        corpus-changing swap enters the canary phase instead of serving
        100% at once (``canary_fraction`` > 0)."""
        self._apply_entries(entries, override=override, allow_canary=True)

    def _apply_entries(self, entries: Sequence[EngineEntry],
                       override: bool = True,
                       allow_canary: bool = True) -> None:
        for e in entries:
            self._check_bound(e)
        phase = self._canary
        if phase is not None:
            # a newer reconcile supersedes an undecided canary: the
            # baseline re-serves first and the new corpus gets its own
            # canary (never two candidate generations)
            self._canary_rollback(phase, reason="superseded",
                                  quarantine=False)
        entries = self._substitute_quarantined(entries)
        prev = self._snapshot
        try:
            snap = _Snapshot(entries, self.members_k, self.ovf_assist,
                             self.compile_cache, prev=prev,
                             override=override,
                             strict_verify=self.strict_verify,
                             kernel_lane=self.kernel_lane,
                             mesh=self._resolve_mesh(),
                             breaker_threshold=self.breaker.threshold,
                             breaker_reset_s=self.breaker.reset_s)
        except SnapshotRejected as e:
            metrics_mod.snapshot_rejected.labels("engine").inc()
            RECORDER.record("snapshot-rejected", lane="engine", detail={
                "generation": self.generation,
                "findings": [str(f) for f in e.findings[:5]]})
            log.error(
                "snapshot REJECTED by strict verify (previous generation "
                "%d keeps serving): %s", self.generation,
                "; ".join(str(f) for f in e.findings[:5]))
            raise
        q = self._quarantine
        if q is not None:
            # the active quarantine rides the snapshot it shaped
            snap.change_safety = {"quarantine": {
                "configs": sorted(q["configs"]),
                "from_generation": q["from_generation"]}}
        # the replay pregate judges a corpus-changing swap on replayed
        # captured traffic before the candidate is staged or serves: a
        # breach raises SnapshotRejected here.  Quarantine and rollback
        # re-applies (allow_canary=False) skip it: they must always land
        preflight = None
        if self.replay_pregate and allow_canary and not self._draining \
                and self._comparable_change(snap):
            preflight = self._run_replay_pregate(snap)
        # the corpus pregate: the same judgment over the long-retention
        # corpus and synthetic witnesses, also ahead of the staging (the
        # reference judges it after its upload)
        if self.corpus_pregate and allow_canary and not self._draining \
                and self._comparable_change(snap):
            self._run_corpus_pregate(snap)
        snap.stage(self.device, prev)
        if allow_canary and self._should_canary(snap):
            self._enter_canary(snap, entries, preflight=preflight)
        else:
            self._install_snapshot(snap)
        if self.analyze_policies:
            self._run_policy_analysis(entries, snap)
            self._run_lowerability(entries, snap)

    def _resolve_mesh(self):
        # "auto" stays on the single corpus on every device: the
        # reference shards over its visible devices, but a mesh block here
        # runs the op chain, and a card's batch belongs to the mega-kernel
        if isinstance(self._mesh, str) and self._mesh == "auto":
            self._mesh = None
        return self._mesh

    def apply_published(self, loaded) -> None:
        """A replica's swap: install a leader-serialized vetted snapshot
        (snapshots/distribution.py ``LoadedSnapshot``) without compiling
        anything.  The admission gate is ``_Snapshot.from_published``: an
        uncertified or locally failing snapshot raises SnapshotRejected
        before any byte of it is staged, and the previous generation keeps
        serving.  Then the device half (encoder, host view, the delta plan
        against the serving snapshot, the upload, the probe) and the
        shared swap tail."""
        prev = self._snapshot
        try:
            snap = _Snapshot.from_published(
                loaded, strict_verify=self.strict_verify, prev=prev)
        except SnapshotRejected as e:
            metrics_mod.snapshot_rejected.labels("engine").inc()
            RECORDER.record("snapshot-rejected", lane="engine", detail={
                "generation": self.generation, "published": True,
                "findings": [str(f) for f in e.findings[:5]]})
            log.error(
                "published snapshot REJECTED at admission (previous "
                "generation %d keeps serving): %s", self.generation,
                "; ".join(str(f) for f in e.findings[:5]))
            raise
        snap.stage(self.device, prev)
        self._install_snapshot(snap)

    def _install_snapshot(self, snap: _Snapshot) -> None:
        """The swap at 100%: publish under the swap lock, retain the
        outgoing snapshot in the bounded history (a later rollback
        re-serves it as it stands: its device buffers are never written),
        the tenant weights of its entries, telemetry, swap listeners."""
        # a reuse install (the same compiled corpus) rebinds too: an
        # annotation changes no fingerprint
        self._bind_tenants(snap)
        with self._swap_lock:
            self.generation += 1
            snap.generation = self.generation
            prev = self._snapshot
            self._snapshot = snap
            metrics_mod.snapshot_generation.labels("engine").set(
                self.generation)
            if prev is not None and prev.compiled:
                self._history.append(prev)
        RECORDER.record("snapshot-swap", lane="engine", detail={
            "generation": snap.generation, "configs": len(snap.by_id)})
        self._record_control_plane(snap)
        self.notify_swap_listeners()
        self._reconcile_prefetch(snap)
        self._record_relation_tables(snap)

    @staticmethod
    def _record_relation_tables(snap: _Snapshot) -> None:
        """The relation-table footprint gauges, from the serving
        snapshot's policies.  Never fails a swap."""
        try:
            from ..analysis.translation_validate import snapshot_policies

            rows = nbytes = 0
            for pol in snapshot_policies(snap):
                if getattr(pol, "rel_bits", None) is not None:
                    rows += int(pol.rel_bits.shape[0])
                    nbytes += int(pol.rel_bits.nbytes)
            metrics_mod.relation_table_rows.set(rows)
            metrics_mod.relation_table_bytes.set(nbytes)
        except Exception:
            log.exception("relation-table telemetry failed (swap unaffected)")

    def _reconcile_prefetch(self, snap: _Snapshot) -> None:
        """Register the served snapshot's request-independent metadata
        evaluators with the prefetcher and wake it to re-pin their
        documents: after the swap listeners, off the swap-speed path.
        Never fails a reconcile."""
        if self.metadata_prefetcher is None:
            return
        try:
            self.metadata_prefetcher.reconcile(snap.entries)
        except Exception:
            log.exception("metadata prefetch registration failed "
                          "(reconcile unaffected)")

    def _bind_tenants(self, snap: Optional[_Snapshot]) -> None:
        """Rebuild the tenant weight book from the entries ``snap`` serves
        (their annotations).  Advisory: never fails a swap."""
        if snap is None:
            return
        try:
            self.tenancy.bind_entries(snap.entries)
        except Exception:
            log.exception("tenant weight rebuild failed (swap unaffected)")

    def _record_control_plane(self, snap: _Snapshot) -> None:
        """Reconcile telemetry after a swap: the phase histograms, the
        compile-cache hit/miss and upload byte counters, a ``reconcile``
        flight-recorder event, the /debug/vars control_plane block (the
        phases, the compile report, the upload plan, the compile cache's
        stats), and the modeled kernel cost of the new generation (a >=2x
        per-row regression raises the cost-regression anomaly).  Advisory:
        never fails a swap."""
        phases_ms = {k: round(v * 1e3, 3) for k, v in snap.phase_s.items()}
        try:
            for phase, dt in snap.phase_s.items():
                metrics_mod.reconcile_phase.labels(phase).observe(dt)
            rep = snap.compile_report
            if rep is not None:
                if rep.cached:
                    metrics_mod.compile_cache_events.labels("hit").inc(
                        rep.cached)
                if rep.compiled:
                    metrics_mod.compile_cache_events.labels("miss").inc(
                        rep.compiled)
            if snap.upload is not None:
                metrics_mod.delta_upload_bytes.labels("engine").inc(
                    int(snap.upload.get("upload_bytes", 0)))
                metrics_mod.full_upload_bytes.labels("engine").inc(
                    int(snap.upload.get("full_bytes", 0)))
            RECORDER.record("reconcile", lane="engine", detail={
                "generation": snap.generation, "phases_ms": phases_ms})
            self._control_plane = {
                "generation": snap.generation,
                "phases_ms": phases_ms,
                "compile": rep.to_json() if rep is not None else None,
                "upload": snap.upload,
                "compile_cache": self.compile_cache.stats(),
                "per_config_cache_keying": (snap.cache_tokens is not None
                                            or snap.mesh_tokens is not None),
            }
        except Exception:
            log.exception("control-plane telemetry failed (swap unaffected)")
        try:
            t0 = time.perf_counter()
            cost_rec = self._cost_model.analyze(
                snap.generation, policy=snap.policy, params=snap.params,
                recorder=RECORDER)
            if isinstance(self._control_plane, dict):
                self._control_plane["kernel_cost"] = cost_rec
                self._control_plane["kernel_cost_ms"] = round(
                    (time.perf_counter() - t0) * 1e3, 3)
            phase = self._canary
            if phase is not None and phase.snap is snap:
                phase.kernel_cost = cost_rec
        except Exception:
            log.exception("kernel cost analysis failed (swap unaffected)")

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

    # ---- change safety: canary, rollback, quarantine -----------------------

    def _should_canary(self, snap: _Snapshot) -> bool:
        """A swap canaries when change safety is on, the engine is not
        draining and the compiled corpus actually changed (an
        identical-fingerprint resync has nothing to prove)."""
        if not (self.canary_fraction > 0.0 and self.canary_window_s > 0.0):
            return False
        if self._draining:
            return False
        return self._comparable_change(snap)

    def _comparable_change(self, snap: _Snapshot) -> bool:
        """True when ``snap`` changes the compiled corpus of the serving
        snapshot: the precondition the canary split and the replay pregate
        share (an identical-fingerprint resync has nothing to prove)."""
        prev = self._snapshot
        if prev is None or not prev.compiled or not snap.compiled:
            return False
        if (prev.sharded is None) != (snap.sharded is None):
            return False  # a lane change swaps through: nothing to compare
        return snap.fingerprints != prev.fingerprints

    def _enter_canary(self, snap: _Snapshot,
                      entries: Sequence[EngineEntry],
                      preflight: Optional[Dict[str, Any]] = None) -> None:
        """Start the canary phase: the reconcile's host index lands at
        once (``index`` reads the phase's), but the verdict lane splits —
        the hash-fraction cohort rides the new generation, everyone else
        the baseline, each on its own params.  The swap listeners do not
        fire: the native fast lane keeps the baseline until promotion, so
        a breach never has to claw anything back from it."""
        baseline = self._snapshot
        # the per-config guards watch only what this reconcile changed:
        # an unchanged config shares the baseline's artifact and can only
        # differ by cohort selection bias
        changed = set(snapshot_diff(baseline.fingerprints or {},
                                    snap.fingerprints or {})["recompile"])
        # a candidate whose replay diff came back clean over a real traffic
        # window canaries under halved deny-delta thresholds, so a
        # live-only regression (a metadata dependency, traffic the capture
        # window missed) trips earlier.  A skipped preflight, or one with
        # flips under the thresholds, keeps the operator's thresholds
        thresholds = self.canary_thresholds
        if preflight is not None and preflight.get("result") == "pass" \
                and not preflight.get("flips_total"):
            base_th = thresholds or safety_mod.GuardThresholds()
            thresholds = dataclasses.replace(
                base_th, deny_delta=base_th.deny_delta / 2,
                config_deny_delta=base_th.config_deny_delta / 2)
            preflight = dict(preflight, guards_tightened=True)
        phase = safety_mod.CanaryPhase(
            snap=snap, baseline=baseline, entries=entries,
            index=snap.index, baseline_index=baseline.index,
            fraction=self.canary_fraction, window_s=self.canary_window_s,
            guard=safety_mod.CanaryGuard(thresholds, changed=changed),
            preflight=preflight)
        # the reconcile's annotations hold from the canary's start, as its
        # host index does
        self._bind_tenants(snap)
        with self._swap_lock:
            self.generation += 1
            snap.generation = self.generation
            self._canary = phase
        self._g_canary.set(1)
        RECORDER.record("canary-start", lane="engine", detail={
            "generation": snap.generation,
            "baseline_generation": baseline.generation,
            "fraction": self.canary_fraction,
            "window_s": self.canary_window_s,
            "configs": len(snap.by_id)})
        self._record_control_plane(snap)
        log.info("canary started: generation %d serving %.1f%% of traffic "
                 "for %.1fs (baseline %d serves the rest)",
                 snap.generation, self.canary_fraction * 100,
                 self.canary_window_s, baseline.generation)
        phase.start_timer(lambda: self._canary_conclude(phase))

    def _canary_conclude(self, phase) -> None:
        """Window expiry (the phase timer's thread, or a worker): one final
        guard evaluation, forced past the rate limit, then promote or roll
        back."""
        if self._draining:
            return
        try:
            b = phase.guard.breach(force=True)
            if b is not None:
                self._canary_rollback(phase, reason="guard-breach",
                                      detail=b)
            else:
                self._canary_promote(phase)
        except Exception:
            log.exception("canary conclude failed")

    def _canary_guard_check(self, phase) -> None:
        """Breach/expiry check (worker threads only: promotion and
        rollback fan out to the swap listeners and a rollback recompiles,
        never on a serving loop or the completer)."""
        if self._canary is not phase or self._draining:
            return
        b = phase.guard.breach()
        if b is not None:
            self._canary_rollback(phase, reason="guard-breach", detail=b)
        elif phase.expired():
            self._canary_conclude(phase)

    def _canary_poke(self, phase) -> None:
        """After a guard feed: when the guard has breached or the window
        has run out, hand the decision to the encode pool (the feeder may
        be the completer thread or a readback thread)."""
        if phase.guard.breach() is not None or phase.expired():
            _encode_pool(self.dispatch_workers).submit(
                self._canary_guard_check, phase)

    def _resolve_after_guard(self, phase, resolve) -> None:
        """Run ``resolve`` (the batch's future resolutions) now, or, when
        the batch's fold left the canary ``phase`` with a decision due, on
        the encode pool right after that decision (never on the completer:
        a rollback recompiles).  The batch that tipped the guard resolves
        only once the rollback or the promotion is in place, as the
        reference's synchronous check orders it: a caller that saw its
        answer never submits into the phase that answer concluded."""
        if phase is None:
            resolve()
            return

        def decide_then_resolve():
            try:
                self._canary_guard_check(phase)
            finally:
                resolve()

        _encode_pool(self.dispatch_workers).submit(decide_then_resolve)

    def _canary_promote(self, phase, manual: bool = False) -> bool:
        """Clean window (or the operator's override): the candidate
        serves 100% — a pointer swap; the baseline joins the history and
        the swap listeners finally fire."""
        with self._swap_lock:
            if self._canary is not phase:
                return False
            # the serving snapshot first: a cut that reads no phase finds
            # the candidate already in place (never a torn read)
            self._snapshot = phase.snap
            self._canary = None
            if phase.baseline is not None and phase.baseline.compiled:
                self._history.append(phase.baseline)
            metrics_mod.snapshot_generation.labels("engine").set(
                phase.snap.generation)
        phase.cancel_timer()
        phase.guard.close()
        self._g_canary.set(0)
        self._bind_tenants(phase.snap)
        RECORDER.record("canary-promote", lane="engine", detail={
            "generation": phase.snap.generation, "manual": manual,
            "age_s": round(time.monotonic() - phase.t_start, 3)})
        log.info("canary promoted to 100%%: generation %d now serves all "
                 "traffic%s", phase.snap.generation,
                 " (manual override)" if manual else "")
        self.notify_swap_listeners()
        return True

    def _canary_rollback(self, phase, reason: str,
                         detail: Optional[Dict[str, Any]] = None,
                         quarantine: bool = True,
                         manual: bool = False) -> bool:
        """Guard breach (or supersede, or the operator): the baseline
        re-serves 100% at once — a pointer swap to a clone of the retained
        baseline under a fresh generation (batches pinned to the candidate
        keep resolving under its tokens) — then the poison configs are
        quarantined and the rest of the reconcile re-applied."""
        t_detect = time.monotonic()
        clone = phase.baseline.clone()
        clone.change_safety = {"rollback": {
            "from_generation": phase.snap.generation, "reason": reason}}
        with self._swap_lock:
            if self._canary is not phase:
                return False
            self.generation += 1
            clone.generation = self.generation
            self._snapshot = clone
            self._canary = None
            metrics_mod.snapshot_generation.labels("engine").set(
                clone.generation)
        phase.cancel_timer()
        phase.guard.close()
        self._g_canary.set(0)
        self._bind_tenants(clone)
        metrics_mod.snapshot_rollbacks.labels(reason).inc()
        self._last_rollback = {
            "t": time.time(), "reason": reason, "manual": manual,
            "from_generation": phase.snap.generation,
            "to_generation": clone.generation,
            "detect_ms": round((t_detect - phase.t_start) * 1e3, 3),
            "detail": detail, "quarantined": [],
        }
        RECORDER.record("snapshot-rollback", lane="engine", detail={
            "reason": reason,
            "from_generation": phase.snap.generation,
            "to_generation": clone.generation,
            "guard": detail})
        log.error("canary ROLLED BACK (%s): generation %d abandoned, "
                  "baseline re-serving as generation %d%s", reason,
                  phase.snap.generation, clone.generation,
                  f" — guard: {detail}" if detail else "")
        self.notify_swap_listeners()
        if quarantine and reason == "guard-breach":
            try:
                self._quarantine_poison(phase, detail, t_detect)
            except Exception:
                log.exception("quarantine re-apply failed (rolled-back "
                              "baseline keeps serving)")
        return True

    def _quarantine_poison(self, phase, detail: Optional[Dict[str, Any]],
                           t_detect: float) -> None:
        """After a guard-breach rollback: the fingerprint diff names what
        the reconcile changed, the guard's per-config deltas pin the spike
        — their intersection is the poison set (every changed config when
        the breach had no per-config attribution).  The reconcile is then
        re-applied with only the poison configs reverted to their prior
        artifacts (the compile cache makes that nearly free).  The
        quarantine persists across resyncs until the operator ships a
        fixed config or clears it."""
        changed = set(snapshot_diff(phase.baseline.fingerprints or {},
                                    phase.snap.fingerprints or {})
                      ["recompile"])
        suspects = [s for s in (detail or {}).get("suspects", [])
                    if s in changed]
        poison = suspects or sorted(changed)
        if not poison:
            return
        base_by_id = phase.baseline.by_id
        configs: Dict[str, Dict[str, Any]] = {}
        prior: Dict[str, EngineEntry] = {}
        for e in phase.entries:
            if e.id not in poison:
                continue
            configs[e.id] = {
                "poison": (phase.snap.fingerprints or {}).get(e.id),
                "prior": (phase.baseline.fingerprints or {}).get(e.id),
            }
            pe = base_by_id.get(e.id)
            if pe is not None:
                prior[e.id] = pe
            # no prior entry: the poison config is new this reconcile and
            # quarantines out entirely
        if not configs:
            return
        self._quarantine = {
            "since": time.time(), "reason": "guard-breach",
            "from_generation": phase.snap.generation,
            "configs": configs,
        }
        self._quarantine_prior = prior
        self._g_quarantine.set(len(configs))
        RECORDER.record("quarantine", lane="engine", detail={
            "configs": sorted(configs),
            "from_generation": phase.snap.generation})
        log.warning("quarantined %d poison config(s) %s: re-applying the "
                    "reconcile with their prior artifacts", len(configs),
                    sorted(configs))
        # the original entries again: the armed quarantine substitutes
        # each poison entry (or drops one with no prior), as a control
        # plane resync would — one substitution path
        self._apply_entries(phase.entries, override=True,
                            allow_canary=False)
        if self._last_rollback is not None:
            self._last_rollback["quarantined"] = sorted(configs)
            self._last_rollback["recover_ms"] = round(
                (time.monotonic() - t_detect) * 1e3, 3)

    def _substitute_quarantined(
            self, entries: Sequence[EngineEntry]) -> Sequence[EngineEntry]:
        """Resync guard: while a quarantine is active, an incoming entry
        that still carries the poison fingerprint is replaced by its prior
        entry (the control plane keeps resyncing the same bad spec — it
        must not re-serve it); an entry whose fingerprint changed (neither
        poison nor prior) was fixed by the operator and takes the normal
        (canaried) path."""
        q = self._quarantine
        if not q:
            return entries
        qc: Dict[str, Dict[str, Any]] = q["configs"]
        out: List[EngineEntry] = []
        still: Dict[str, Dict[str, Any]] = {}
        for e in entries:
            rec = qc.get(e.id)
            if rec is None:
                out.append(e)
                continue
            fp = rules_fingerprint(e.rules) if e.rules is not None else None
            if fp == rec["poison"]:
                still[e.id] = rec
                pe = self._quarantine_prior.get(e.id)
                if pe is not None:
                    out.append(EngineEntry(id=e.id, hosts=list(e.hosts),
                                           runtime=pe.runtime,
                                           rules=pe.rules))
                # no prior entry: stays quarantined out
            elif fp == rec["prior"]:
                # already the prior artifact (the quarantine's own
                # re-apply, or the operator reverting by hand): serve it,
                # and keep the quarantine armed against the poison spec
                still[e.id] = rec
                out.append(e)
            else:
                log.info("quarantine released for %s: fingerprint changed "
                         "(operator fix) — the new spec takes the normal "
                         "path", e.id)
                out.append(e)
        if still != qc:
            if still:
                self._quarantine = dict(q, configs=still)
            else:
                self.clear_quarantine(note="all poison configs changed")
            self._g_quarantine.set(len(still))
        return out

    def clear_quarantine(self, note: str = "") -> bool:
        q = self._quarantine
        if q is None:
            return False
        RECORDER.record("quarantine-clear", lane="engine", detail={
            "note": note, "configs": sorted(q["configs"])})
        log.info("quarantine cleared (%s): %s", note or "operator",
                 sorted(q["configs"]))
        self._quarantine = None
        self._quarantine_prior = {}
        self._g_quarantine.set(0)
        return True

    @property
    def quarantine_active(self) -> bool:
        return self._quarantine is not None

    def canary_promote(self) -> bool:
        """The operator's override (/debug/canary): promote the canary in
        progress at once, guard unconsulted."""
        phase = self._canary
        return self._canary_promote(phase, manual=True) \
            if phase is not None else False

    def canary_rollback(self, reason: str = "manual") -> bool:
        """The operator's override: roll back the canary in progress (no
        quarantine — the operator is driving), or, with none in progress,
        re-serve the newest retained generation."""
        phase = self._canary
        if phase is not None:
            return self._canary_rollback(phase, reason=reason,
                                         quarantine=False, manual=True)
        return self.rollback_last(reason=reason)

    def rollback_last(self, reason: str = "manual") -> bool:
        """Manual rollback outside a canary: re-serve the newest retained
        snapshot (its host index rides on it) of the bounded history as a
        fresh generation — nothing compiled, nothing uploaded, no probe."""
        with self._swap_lock:
            if not self._history:
                return False
            prev_snap = self._history.pop()
            clone = prev_snap.clone()
            from_gen = (self._snapshot.generation
                        if self._snapshot is not None else 0)
            self.generation += 1
            clone.generation = self.generation
            clone.change_safety = {"rollback": {
                "from_generation": from_gen, "reason": reason}}
            self._snapshot = clone
            metrics_mod.snapshot_generation.labels("engine").set(
                clone.generation)
        self._bind_tenants(clone)
        metrics_mod.snapshot_rollbacks.labels(reason).inc()
        self._last_rollback = {
            "t": time.time(), "reason": reason, "manual": True,
            "from_generation": from_gen,
            "to_generation": clone.generation,
            "detect_ms": None, "detail": None, "quarantined": [],
        }
        RECORDER.record("snapshot-rollback", lane="engine", detail={
            "reason": reason, "from_generation": from_gen,
            "to_generation": clone.generation})
        log.warning("manual rollback: generation %d re-serving as %d",
                    from_gen, clone.generation)
        self.notify_swap_listeners()
        return True

    def canary_observe_external(self, rows, firing, heat,
                                shards=None) -> None:
        """Baseline-cohort guard evidence from outside the engine's own
        dispatch: the native fast lane serves the baseline during a
        canary (its C++ snapshot rebuilds only at promotion or rollback),
        so its per-batch attribution strengthens the comparison.  A
        decision hops to the encode pool: the caller may be a readback
        thread."""
        phase = self._canary
        if phase is None or heat is None or firing is None:
            return
        try:
            phase.guard.observe_batch(False, rows, firing, heat,
                                      shards=shards)
            self._canary_poke(phase)
        except Exception:
            log.exception("external canary guard feed failed")

    # ---- the reconcile's gates and advisory passes --------------------------

    def _run_replay_pregate(self, snap: _Snapshot) -> Dict[str, Any]:
        """Replay the candidate against the capture ring and judge the
        verdict diff (docs/replay.md, "Preflight gate").  Returns the
        preflight summary on a pass or a skip; raises SnapshotRejected on
        a breach, before the candidate is staged: the serving snapshot
        keeps serving and the candidate never sees a request.  Bounded by
        ``replay_pregate_budget_s``: what the replay could not cover is
        reported truncated (partial evidence, not full coverage)."""
        from ..replay import pregate as pregate_mod

        t0 = time.monotonic()
        baseline = self._snapshot
        thresholds = self.canary_thresholds or safety_mod.GuardThresholds()
        records = CAPTURE.ring_records()
        if len(records) < thresholds.min_requests:
            return self._pregate_skipped(
                f"capture ring holds {len(records)} record(s) < "
                f"min_requests {thresholds.min_requests} — not enough "
                f"replay evidence to judge"
                + ("" if CAPTURE.enabled else
                   " (capture is OFF: arm --capture)"))
        changed = set(snapshot_diff(baseline.fingerprints or {},
                                    snap.fingerprints or {})["recompile"])
        try:
            pf = pregate_mod.preflight(
                baseline, snap, records, thresholds, changed=changed,
                time_budget_s=self.replay_pregate_budget_s)
        except Exception:
            # a pregate fault must never block the control plane: the swap
            # proceeds under its normal canary protection, loudly
            log.exception("replay pregate errored (swap proceeds under "
                          "canary protection only)")
            self._last_pregate = {"result": "skipped",
                                  "reason": "pregate error (see logs)",
                                  "replayed": 0}
            metrics_mod.replay_pregate.labels("skipped").inc()
            return self._last_pregate
        report, breach = pf["report"], pf["breach"]
        self._g_replay_flips.set(report["flips"]["total"])
        elapsed_ms = round((time.monotonic() - t0) * 1e3, 3)
        if breach is None and report["replayed"] < thresholds.min_requests:
            # the ring looked big enough, but the replay could not
            # re-decide min_requests records (configs missing on one side,
            # or the budget truncated them): absent evidence, not clean
            # evidence, so the canary keeps its normal guards
            return self._pregate_skipped(
                f"only {report['replayed']} of {len(records)} record(s) "
                f"re-decided (missing configs / time budget) < "
                f"min_requests {thresholds.min_requests}",
                replayed=report["replayed"],
                skipped_detail=report["skipped"], elapsed_ms=elapsed_ms)
        if breach is not None:
            metrics_mod.replay_pregate.labels("breach").inc()
            metrics_mod.snapshot_rejected.labels("engine").inc()
            self._last_pregate = {
                "result": "breach",
                "replayed": report["replayed"],
                "flips_total": report["flips"]["total"],
                "flips": report["flips"],
                "guards": breach["guards"],
                "suspects": breach["suspects"],
                "elapsed_ms": elapsed_ms,
            }
            # the anomaly kind dumps a flight bundle with the top-N
            # attributed verdict-diff rows frozen as incident evidence
            RECORDER.record(pregate_mod.PREGATE_ANOMALY, lane="engine",
                            detail={
                                "baseline_generation": baseline.generation,
                                "breach": breach,
                                "replayed": report["replayed"],
                                "elapsed_ms": elapsed_ms,
                            })
            findings = [
                f"replay pregate breach: {', '.join(breach['guards'])} over "
                f"{report['replayed']} replayed request(s) "
                f"({report['flips']['newly_denied']} newly denied, "
                f"{report['flips']['newly_allowed']} newly allowed)"
            ] + [
                f"{g['authconfig']} rule[{g['rule_index']}] {g['rule']} "
                f"{g['direction']} {g['count']} replayed request(s)"
                for g in breach["top_flips"][:3]
            ]
            log.error("replay pregate REJECTED the candidate snapshot "
                      "(generation %d keeps serving, zero live exposure): "
                      "%s", baseline.generation, "; ".join(findings))
            exc = SnapshotRejected(findings)
            exc.replay_diff = breach  # the full attributed evidence
            raise exc
        self._last_pregate = {
            "result": "pass",
            "replayed": report["replayed"],
            "flips_total": report["flips"]["total"],
            "flips": report["flips"],
            "truncated": report["skipped"]["truncated"],
            "elapsed_ms": elapsed_ms,
        }
        metrics_mod.replay_pregate.labels("pass").inc()
        RECORDER.record("replay-pregate", lane="engine",
                        detail=self._last_pregate)
        log.info("replay pregate PASS: %d record(s) replayed, %d flip(s), "
                 "%.0fms", report["replayed"], report["flips"]["total"],
                 elapsed_ms)
        return self._last_pregate

    def _corpus_pregate_rows(self, baseline: _Snapshot) -> Optional[list]:
        """The captured corpus rows (loaded once from ``corpus_pregate``)
        plus synthetic witness rows built against the BASELINE policy
        (cached per baseline generation: synthesis costs a reconcile only
        on the first swap of each generation).  None when the corpus is
        unreadable (the pregate skips, loudly)."""
        from ..corpus import read_corpus
        from ..corpus.synthesize import augment_corpus

        if self._corpus_rows is None and self._corpus_load_error is None:
            try:
                self._corpus_rows = read_corpus(self.corpus_pregate)
            except Exception as e:
                self._corpus_load_error = str(e)
                log.error("corpus pregate: corpus unreadable at %s: %s",
                          self.corpus_pregate, e)
        if self._corpus_rows is None:
            return None
        gen, synth, _rep = self._corpus_synth
        if gen != baseline.generation:
            synth, rep = [], {}
            if baseline.policy is not None:
                try:
                    aug = augment_corpus(baseline.policy, self._corpus_rows)
                    synth, rep = aug["rows"], {
                        "reasons": aug["synthesis"]["reasons"],
                        "uncoverable": aug["synthesis"]["uncoverable"][:20],
                        "coverage_before":
                            aug["coverage_before"]["fraction"],
                        "coverage_after": aug["coverage_after"]["fraction"],
                    }
                except Exception:
                    # synthesis is additive evidence: a synthesis fault
                    # must not disarm the captured rows' judgment
                    log.exception("corpus pregate: synthesis errored "
                                  "(captured rows only this generation)")
            self._corpus_synth = (baseline.generation, synth, rep)
            try:
                metrics_mod.corpus_rows.labels("captured").set(
                    len(self._corpus_rows))
                metrics_mod.corpus_rows.labels("synthetic").set(len(synth))
            except Exception:
                pass
        return self._corpus_rows + self._corpus_synth[1]

    def _corpus_pregate_skipped(self, reason: str, replayed: int = 0,
                                **extra) -> Dict[str, Any]:
        self._last_corpus_pregate = dict(
            {"result": "skipped", "reason": reason, "replayed": replayed},
            **extra)
        metrics_mod.corpus_pregate.labels("skipped").inc()
        RECORDER.record("corpus-pregate", lane="engine",
                        detail=self._last_corpus_pregate)
        log.warning("corpus pregate SKIPPED: %s", reason)
        return self._last_corpus_pregate

    def _run_corpus_pregate(self, snap: _Snapshot) -> Dict[str, Any]:
        """Judge the candidate on the frequency-weighted decision corpus
        (corpus/pregate.py): the replay pregate's state machine, with the
        long-retention corpus and synthetic truth-table witnesses as its
        evidence, so a breaching edit to a rule no traffic exercised is
        rejected with zero live exposure.  Raises SnapshotRejected on a
        breach, before the candidate is staged."""
        from ..corpus import pregate as corpus_pregate_mod
        from ..snapshots.diff import snapshot_diff

        t0 = time.monotonic()
        baseline = self._snapshot
        thresholds = self.canary_thresholds or safety_mod.GuardThresholds()
        rows = self._corpus_pregate_rows(baseline)
        if not rows:
            return self._corpus_pregate_skipped(
                f"corpus unreadable: {self._corpus_load_error}"
                if self._corpus_load_error else
                f"corpus at {self.corpus_pregate} holds no rows")
        changed = set(snapshot_diff(baseline.fingerprints or {},
                                    snap.fingerprints or {})["recompile"])
        try:
            pf = corpus_pregate_mod.corpus_preflight(
                baseline, snap, rows, thresholds, changed=changed,
                time_budget_s=self.corpus_pregate_budget_s)
        except Exception:
            log.exception("corpus pregate errored (swap proceeds under "
                          "canary protection only)")
            self._last_corpus_pregate = {
                "result": "skipped", "reason": "pregate error (see logs)",
                "replayed": 0}
            metrics_mod.corpus_pregate.labels("skipped").inc()
            return self._last_corpus_pregate
        report, breach = pf["report"], pf["breach"]
        elapsed_ms = round((time.monotonic() - t0) * 1e3, 3)
        if breach is None and report["replayed"] < thresholds.min_requests:
            # below the weighted evidence floor: absent evidence, recorded
            # as skipped, never a false pass
            return self._corpus_pregate_skipped(
                f"weighted corpus evidence {report['replayed']} "
                f"< min_requests {thresholds.min_requests}",
                replayed=report["replayed"],
                skipped_detail=report["skipped"], elapsed_ms=elapsed_ms)
        if breach is not None:
            metrics_mod.corpus_pregate.labels("breach").inc()
            metrics_mod.snapshot_rejected.labels("engine").inc()
            self._last_corpus_pregate = {
                "result": "breach",
                "replayed": report["replayed"],
                "replayed_rows": report.get("replayed_rows", 0),
                "flips": report["flips"],
                "guards": breach["guards"],
                "suspects": breach["suspects"],
                "origins": report.get("origins", {}),
                "elapsed_ms": elapsed_ms,
            }
            RECORDER.record(corpus_pregate_mod.CORPUS_PREGATE_ANOMALY,
                            lane="engine", detail={
                                "baseline_generation": baseline.generation,
                                "breach": breach,
                                "origins": report.get("origins", {}),
                                "replayed": report["replayed"],
                                "elapsed_ms": elapsed_ms,
                            })
            top = breach["top_flips"][:3]
            findings = [
                f"corpus pregate breach: {', '.join(breach['guards'])} over "
                f"{report['replayed']} weighted corpus decision(s) "
                f"({report['flips']['newly_denied']} newly denied, "
                f"{report['flips']['newly_allowed']} newly allowed)"
            ] + [
                f"{g['authconfig']} rule[{g['rule_index']}] {g['rule']} "
                f"{g['direction']} weight {g['count']} "
                f"(origins: {', '.join(g.get('origins') or []) or 'n/a'})"
                for g in top
            ]
            log.error("corpus pregate REJECTED the candidate snapshot "
                      "(generation %d keeps serving, zero live exposure): "
                      "%s", baseline.generation, "; ".join(findings))
            exc = SnapshotRejected(findings)
            exc.corpus_diff = breach  # the full attributed evidence
            raise exc
        self._last_corpus_pregate = {
            "result": "pass",
            "replayed": report["replayed"],
            "replayed_rows": report.get("replayed_rows", 0),
            "flips": report["flips"],
            "origins": report.get("origins", {}),
            "truncated": report["skipped"]["truncated"],
            "elapsed_ms": elapsed_ms,
        }
        metrics_mod.corpus_pregate.labels("pass").inc()
        RECORDER.record("corpus-pregate", lane="engine",
                        detail=self._last_corpus_pregate)
        log.info("corpus pregate PASS: %d weighted decision(s) "
                 "(%d row(s)) replayed, %d flip(s), %.0fms",
                 report["replayed"], report.get("replayed_rows", 0),
                 report["flips"]["total"], elapsed_ms)
        return self._last_corpus_pregate

    def corpus_vars(self) -> Dict[str, Any]:
        """The corpus pregate's source, its row counts by origin, the
        synthesis summary for the serving baseline and the last verdict
        (the ``corpus`` block of /debug/vars)."""
        return {
            "enabled": bool(self.corpus_pregate),
            "source": self.corpus_pregate or None,
            "budget_s": self.corpus_pregate_budget_s,
            "rows_captured": (len(self._corpus_rows)
                              if self._corpus_rows is not None else 0),
            "rows_synthetic": len(self._corpus_synth[1]),
            "synthesis": self._corpus_synth[2] or None,
            "load_error": self._corpus_load_error,
            "last": self._last_corpus_pregate,
        }

    def _pregate_skipped(self, reason: str, replayed: int = 0,
                         **extra) -> Dict[str, Any]:
        """Record a preflight that had too little evidence to judge."""
        self._last_pregate = dict({"result": "skipped", "reason": reason,
                                   "replayed": replayed}, **extra)
        metrics_mod.replay_pregate.labels("skipped").inc()
        RECORDER.record("replay-pregate", lane="engine",
                        detail=self._last_pregate)
        log.warning("replay pregate SKIPPED: %s", reason)
        return self._last_pregate

    def _run_policy_analysis(self, entries: Sequence[EngineEntry],
                             snap: _Snapshot) -> None:
        """Cedar-style semantic pass, once per reconcile (never per
        request): constant-allow/deny rules, shadowed/duplicate rules,
        duplicate-host routing.  Logged once here, counted in
        auth_server_policy_analysis_findings_total{kind,authconfig}, kept
        JSON-safe for /debug/vars.  Advisory: a fault inside the analyzer
        never fails the reconcile."""
        try:
            from ..analysis.policy_analysis import analyze_snapshot

            findings, summary = analyze_snapshot(entries, snap.policy,
                                                 sharded=snap.sharded)
            for f in findings:
                metrics_mod.policy_analysis_findings.labels(
                    f.kind, str(f.detail.get("config", ""))).inc()
            if findings:
                by_kind: Dict[str, int] = {}
                for f in findings:
                    by_kind[f.kind] = by_kind.get(f.kind, 0) + 1
                log.warning(
                    "policy analysis (generation %d): %d finding(s) %s — "
                    "first: %s (full list on /debug/vars)",
                    snap.generation, len(findings), by_kind, findings[0])
            skipped = summary.get("skipped", [])
            for s in skipped:
                metrics_mod.policy_analysis_skipped.labels(
                    str(s.get("config", ""))).inc()
            # the per-config list is bounded; the remainder still counts,
            # under the catch-all label, so the total equals skipped_wide
            extra = int(summary.get("skipped_wide", 0)) - len(skipped)
            if extra > 0:
                metrics_mod.policy_analysis_skipped.labels("").inc(extra)
            self._analysis = {
                "generation": snap.generation,
                "findings": [f.to_json() for f in findings],
                "summary": summary,
            }
        except Exception:
            log.exception("policy analysis failed (reconcile unaffected)")

    def _run_lowerability(self, entries: Sequence[EngineEntry],
                          snap: _Snapshot) -> None:
        """The lowerability report: every config classified fast-lane or
        slow-lane with reason codes, once per reconcile.  Advisory: on
        /debug/vars, counted per (lane, reason) in
        auth_server_lowerability_configs_total, never a reconcile
        failure."""
        try:
            from ..analysis.translation_validate import (lowerability_report,
                                                         snapshot_policies)

            report = lowerability_report(entries, snapshot_policies(snap))
            for lane, reason, n in report["series"]:
                metrics_mod.lowerability_configs.labels(lane, reason).inc(n)
            # the would-be-fast-if-fixed rollup trends each reason's exile
            # count across reconciles
            for reason, b in (report.get("blocking_reasons") or {}).items():
                metrics_mod.lowerability_blocking.labels(
                    reason, "configs").set(b["configs"])
                metrics_mod.lowerability_blocking.labels(
                    reason, "sole_blocker").set(b["sole_blocker"])
            report["generation"] = snap.generation
            self._lowerability = report
        except Exception:
            log.exception("lowerability report failed (reconcile unaffected)")

    def replay_vars(self) -> Dict[str, Any]:
        """The capture log's state and the pregate's last verdict: the
        ``replay`` block of /debug/vars, served whole on /debug/replay."""
        return {
            "capture": CAPTURE.to_json(),
            "pregate": {
                "enabled": self.replay_pregate,
                "budget_s": self.replay_pregate_budget_s,
                "last": self._last_pregate,
            },
        }

    def change_safety_vars(self) -> Dict[str, Any]:
        """JSON-safe change-safety state (a pure read: /debug/canary,
        /debug/vars, the native frontend's vars)."""
        phase = self._canary
        q = self._quarantine
        with self._swap_lock:
            # a reconcile appends to the history under this lock
            history = [s.generation for s in self._history]
        return {
            "canary_fraction": self.canary_fraction,
            "canary_window_s": self.canary_window_s,
            "canary": phase.to_json() if phase is not None else None,
            "quarantine": ({
                "since": q["since"], "reason": q["reason"],
                "from_generation": q["from_generation"],
                "configs": sorted(q["configs"]),
            } if q is not None else None),
            "history_generations": history,
            "last_rollback": self._last_rollback,
        }

    @property
    def index(self) -> HostIndex:
        """The host index the pipeline looks hosts up in: the canary's
        (the reconcile's) while one is in progress, else the serving
        snapshot's."""
        phase = self._canary
        if phase is not None:
            return phase.index
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
                    deadline: Optional[float] = None,
                    after=None) -> AuthResult:
        """Full request-time flow (ref: pkg/service/auth.go:239-310).
        ``deadline`` is the propagated Envoy Check() deadline (monotonic
        seconds): it bounds the pipeline below ``timeout_s`` and arms
        admission and deadline shedding in the dispatcher.  ``after(entry,
        pipeline)``, where given, runs once the pipeline has decided and
        before the result is returned: the native frontend's slow lane
        registers a verified credential there, so a repeat of it is
        servable fast by the time the client has its answer."""
        entry = self.lookup(request.host())
        if entry is None:
            return AuthResult(code=NOT_FOUND, message="Service not found")
        pipeline = AuthPipeline(request, entry.runtime, timeout=self.timeout_s,
                                span=span, deadline=deadline)
        result = await pipeline.evaluate()
        if after is not None:
            after(entry, pipeline)
        return result

    def admission_precheck(self, deadline: Optional[float] = None):
        """Front-door overload check at the actual queue depth: a request
        arriving into a full hard cap, or doomed on arrival while the lane
        is OVERLOADED, is answered typed before a pipeline is built.
        Deterministic — the submit-time gate stays the one true admission
        point and this never rejects anything that gate would accept.
        Returns an AuthResult to serve, or None to proceed."""
        rej = self.admission.precheck(len(self._queue), deadline=deadline,
                                      rtt_s=self._device_ewma)
        if rej is None:
            return None
        code, reason = rej
        self.admission.count_reject(reason)
        if code == DEADLINE_EXCEEDED:
            self._count_shed(1)
            return AuthResult(code=code,
                              message="rejected at admission: deadline "
                                      "cannot be met")
        return AuthResult(code=code, message=f"server overloaded ({reason})")

    def provider_for(self, config_name: str):
        """BatchedVerdictProvider bound to one compiled config — handed to
        PatternMatching evaluators at translate time."""

        async def provider(pipeline, evaluator_slot: int) -> Tuple[bool, bool]:
            rule, skipped, snap = await self.submit(
                pipeline.authorization_json(), config_name,
                span=pipeline.span,
                deadline=getattr(pipeline, "deadline", None),
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
            if snap is not None and snap.sharded is not None:
                loc = snap.sharded.locator.get(config_name)
                if loc is None or snap.heat is None:
                    return None
                src = snap.heat.source(loc[1], evaluator_slot, shard=loc[0])
                return prov_mod.deny_provenance(config_name, evaluator_slot,
                                                src, lane="engine")
            policy = snap.policy if snap is not None else None
            if policy is None or config_name not in policy.config_ids:
                return None
            sources = policy.rule_sources()[policy.config_ids[config_name]]
            src = (sources[evaluator_slot]
                   if 0 <= evaluator_slot < len(sources) else "")
            return prov_mod.deny_provenance(config_name, evaluator_slot,
                                            src, lane="engine")

        return attributor

    def _count_shed(self, n: int) -> None:
        metrics_mod.deadline_shed.labels("engine").inc(n)
        self._add_stats(deadline_shed=n)

    async def submit(self, doc: Any, config_name: str, span: Any = None,
                     deadline: Optional[float] = None,
                     return_snapshot: bool = False):
        """Admit one request for the next micro-batch; resolves to that
        request's per-evaluator ``(rule_results [E], skipped [E])``, plus
        the snapshot that evaluated it when ``return_snapshot``.
        ``deadline`` (monotonic seconds) arms shedding: a request that
        cannot make it answers a typed DEADLINE_EXCEEDED before encode.

        The dispatch decision is deferred one loop iteration (call_soon):
        every submit scheduled in the same iteration lands in one batch
        cut, while a lone request still dispatches right after its
        iteration."""
        if self._draining:
            raise CheckAbort(UNAVAILABLE, "server draining")
        # the canary cohort, stamped here: deterministic over the
        # request's identity, so a retry keeps its cohort.  A config the
        # canaried reconcile added has no baseline artifact: its traffic
        # rides the candidate whatever its cohort
        phase = self._canary
        in_canary = phase is not None and (
            phase.in_cohort(doc) or config_name not in phase.baseline.by_id)
        # tenant-scoped admission runs before the global gate: the quota's
        # token bucket, the queue-share bound, then containment's pacing.
        # A typed RESOURCE_EXHAUSTED names the tenant; the global
        # OVERLOADED latch and its CoDel state are untouched, so every
        # other tenant keeps its whole budget (a contained tenant's flood
        # paced here cannot fill the shared queue to the global cap)
        ten = self.tenancy
        if ten.enabled:
            trej = ten.admit(config_name, depth=len(self._queue),
                             effective_cap=self.admission.effective_cap())
            if trej is not None:
                code, reason = trej
                self.admission.count_reject(reason)
                ten.count_reject(config_name, reason)
                self._canary_tenant_rejection(phase, in_canary, config_name)
                raise CheckAbort(
                    code, f"tenant {config_name} over its QoS budget "
                          f"({reason}): admission rejected")
        # the doomed-deadline predictor sees this tenant's fair-share
        # depth, not the global queue: one tenant's standing backlog
        # cannot doom another's deadlines.  Without a deadline nothing is
        # doomed, so the depth (O(backlogged tenants)) is not taken
        doom_depth = ten.doom_depth(config_name, len(self._queue)) \
            if ten.enabled and deadline is not None else None
        rej = self.admission.admit(len(self._queue), deadline=deadline,
                                   rtt_s=self._device_ewma,
                                   doom_depth=doom_depth)
        if rej is not None:
            code, reason = rej
            self.admission.count_reject(reason)
            if code == DEADLINE_EXCEEDED:
                self._count_shed(1)
                if doom_depth is not None:
                    # the shed is scoped to this tenant's own standing
                    # queue: a tenant-scoped rejection like the others
                    ten.count_reject(config_name, "doomed-deadline")
                    self._canary_tenant_rejection(phase, in_canary,
                                                  config_name)
                raise CheckAbort(code, "rejected at admission: deadline "
                                       "cannot be met")
            raise CheckAbort(code, f"server overloaded ({reason}): "
                                   "admission rejected")
        snap = phase.snap if in_canary else self._snapshot
        if snap is None or not snap.compiled:
            # typed, as the reference answers a batch cut with no compiled
            # snapshot: nothing (device or oracle) can decide it.  A config
            # the snapshot lacks (unknown, or quarantined out since the
            # caller resolved it) queues as in the reference, and the
            # encode stage answers that row (``_answer_unknown_configs``)
            raise CheckAbort(UNAVAILABLE, "no compiled policy snapshot")
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        with self._queue_lock:
            self._queue.append(_Pending(doc, config_name, fut, loop,
                                        span=span, t_enq=time.monotonic(),
                                        deadline=deadline,
                                        canary=in_canary))
            self.controller.observe_arrivals()
            ten.on_enqueue(config_name)
        loop.call_soon(self._maybe_dispatch)
        rule, skipped, used = await fut
        return (rule, skipped, used) if return_snapshot else (rule, skipped)

    def _canary_tenant_rejection(self, phase, in_canary: bool,
                                 tenant: str) -> None:
        """The per-tenant canary guard's feed: a canaried change that
        pushes its own tenant into tenant-scoped rejections must gather
        breach evidence.  A decision hops to the encode pool (this runs on
        a serving loop)."""
        if phase is None:
            return
        try:
            phase.guard.observe_tenant_rejection(in_canary, tenant)
            self._canary_poke(phase)
        except Exception:
            log.exception("tenant canary feed failed")

    # ---- pipelined dispatch -----------------------------------------------

    def _maybe_dispatch(self) -> None:
        """Cut and hand off batches while the window has a free slot and
        the queue is not empty.  Runs on event loops (after a submit) and
        on the completer and pool threads (after a batch resolves); a call
        with nothing to do is a cheap no-op, so no timer is needed: a full
        window means a completion will come, and it cuts the next batch.
        During a canary a cut splits by cohort into at most two parts,
        each its own job (and window slot) on its own generation.

        With the tenant plane on, a contended cut (more queued than it
        takes) is the weighted-fair cut; an uncontended one takes
        everything in arrival order.  A contained tenant's rows then leave
        the cut for parts of their own (one per cohort), launched on the
        device behind the cut's other parts, each its own window slot:
        the other tenants' rows never wait behind them."""
        ten = self.tenancy
        while True:
            with self._queue_lock:
                depth = len(self._queue)
                if not depth or self._inflight >= self.controller.window:
                    break
                n = min(depth, self.max_batch)
                if ten.enabled and depth > n:
                    batch = ten.cut(self._queue, n)
                else:
                    batch = [self._queue.popleft() for _ in range(n)]
                ten.on_dequeue(batch)
                phase = self._canary
                contained = []
                if ten.has_contained():
                    batch, div = ten.split_contained(batch)
                    if div:
                        for p in div:
                            p.contained = True
                        contained = _split_cohorts(div, phase)
                parts = (_split_cohorts(batch, phase) if batch else []) \
                    + contained
                self._inflight += len(parts)
                self.inflight_peak = max(self.inflight_peak, self._inflight)
                inflight = self._inflight
            if contained:
                self._add_stats(
                    contained_parts=len(contained),
                    contained_rows=sum(len(part) for _, part in contained))
            self._g_inflight.set(inflight)
            for is_canary, part in parts:
                # pinned per part: a swap admitted later never relabels
                # it.  A phase that concluded since the stamp collapses
                # to the serving snapshot: still one generation
                _encode_pool(self.dispatch_workers).submit(
                    self._encode_launch_job,
                    self._snap_for(phase, is_canary), part)
        self._g_depth.set(len(self._queue))

    def _snap_for(self, phase, is_canary: bool) -> Optional[_Snapshot]:
        if phase is None:
            return self._snapshot
        return phase.snap if is_canary else phase.baseline

    def _encode_launch_job(self, snap: Optional[_Snapshot],
                           batch: List[_Pending], attempt: int = 0) -> None:
        """Encode stage (pool thread): shed the expired, encode + launch
        without waiting on the device, hand the batch to the completer.
        An open circuit breaker keeps the whole batch off the card
        (``_end_undecided``); a failure takes the retry path
        (``_batch_failed``)."""
        batch = self._shed_expired(batch)
        if not batch:
            self._launch_done()
            return
        if snap is None or not snap.compiled:
            self._resolve_error(batch, CheckAbort(
                UNAVAILABLE, "no compiled policy snapshot"))
            self._launch_done()
            return
        batch = self._answer_unknown_configs(snap, batch)
        if not batch:
            self._launch_done()
            return
        if not self.breaker.admit_device():
            self._end_undecided(snap, batch, reason="breaker-open")
            return
        try:
            if faults.ACTIVE:
                faults.FAULTS.check("encode", "engine")
            item = self._encode_and_launch(snap, batch)
            item.snap = snap
            item.attempt = attempt
        except Exception as e:
            self._batch_failed(snap, batch, attempt, e)
            return
        _completer_submit(item)

    def _answer_unknown_configs(self, snap: _Snapshot,
                                batch: List[_Pending]) -> List[_Pending]:
        """Rows whose config the pinned snapshot lacks (a quarantine or a
        loaded snapshot dropped it after the submit was queued) answer
        UNAVAILABLE "policy evaluation unavailable" here, what the
        reference's row-by-row host degrade gives them; the rest of the
        part goes on to the launch.  Nothing reached the device, so the
        breaker counts no failure."""
        unknown = [p for p in batch if not snap.has_config(p.config_name)]
        if not unknown:
            return batch
        self._add_stats(failed_batches=1)
        self.error_total += len(unknown)
        self._canary_errors(unknown, len(unknown))
        self._fail_all(unknown, CheckAbort(
            UNAVAILABLE, "policy evaluation unavailable"))
        return [p for p in batch if snap.has_config(p.config_name)]

    def _shed_expired(self, batch: List[_Pending]) -> List[_Pending]:
        """Requests whose propagated deadline lands inside one expected
        device round trip (EWMA) answer a typed DEADLINE_EXCEEDED here
        instead of riding a launch whose answer would arrive dead."""
        if all(p.deadline is None for p in batch):
            return batch
        horizon = time.monotonic() + self._device_ewma
        live = [p for p in batch if p.deadline is None or p.deadline > horizon]
        shed = [p for p in batch if p.deadline is not None
                and p.deadline <= horizon]
        if shed:
            self._count_shed(len(shed))
            self._resolve_error(shed, CheckAbort(
                DEADLINE_EXCEEDED,
                "request shed before dispatch: deadline cannot be met"))
        return live

    def _batch_failed(self, snap: _Snapshot, batch: List[_Pending],
                      attempt: int, exc: Exception) -> None:
        """A launched (or launching) batch failed: count it against the
        circuit breaker and retry it once on a fresh dispatch; a failed
        retry ends the batch (``_end_undecided``) on the encode pool, as
        the retry runs: this may be the completer's thread.  The window
        slot stays held until the batch resolves."""
        self.breaker.record_failure()
        if attempt == 0:
            metrics_mod.batch_retries.labels("engine").inc()
            self._add_stats(retries=1)
            log.warning("micro-batch of %d failed (%r): retrying once on a "
                        "fresh dispatch", len(batch), exc)
            _encode_pool(self.dispatch_workers).submit(
                self._encode_launch_job, snap, batch, 1)
            return
        _encode_pool(self.dispatch_workers).submit(
            self._end_undecided, snap, batch, exc)

    @property
    def host_degrade(self) -> bool:
        """Whether a batch the device did not decide is re-decided by the
        host oracle: only on a CPU engine.  A card engine answers it
        UNAVAILABLE."""
        return self.device.type == "cpu"

    def _end_undecided(self, snap: _Snapshot, batch: List[_Pending],
                       exc: Optional[Exception] = None,
                       reason: str = "device-failure") -> None:
        """End a batch the device did not decide (pool thread): its retry
        failed (``exc``), or the open breaker kept it off the card.  The
        host oracle's degrade on a CPU engine, a typed UNAVAILABLE on a
        card.  Whatever raises here, every future resolves and the window
        slot is freed."""
        try:
            if reason == "breaker-open":
                self._add_stats(breaker_open_batches=1)
            if self.host_degrade:
                self._degrade_batch(snap, batch, exc=exc, reason=reason)
            else:
                self._resolve_error(batch, exc if exc is not None else
                                    CheckAbort(UNAVAILABLE,
                                               "engine device circuit open"))
        except Exception:
            log.exception("ending an undecided batch failed")
            self._fail_all(batch, CheckAbort(
                UNAVAILABLE, "policy evaluation unavailable"))
        finally:
            self._launch_done()

    def _watchdog_fire(self, item: _Inflight) -> None:
        """An in-flight batch wedged past ``device_timeout_s``: abandon its
        handle (its readback buffer and stream go; a late readback lands
        nowhere) and take the retry path as a breaker-counted failure."""
        self._route_done(item, ok=False)
        release = getattr(item.handle, "release", None)
        item.handle = None
        if release is not None:
            try:
                release()
            except Exception:
                log.exception("abandoned handle release failed")
        metrics_mod.watchdog_timeouts.labels("engine").inc()
        self._add_stats(watchdog_timeouts=1)
        RECORDER.record("watchdog-timeout", lane="engine", detail={
            "requests": len(item.batch), "attempt": item.attempt,
            "device_timeout_s": self.device_timeout_s})
        log.warning("device batch (%d requests, attempt %d) wedged past "
                    "device_timeout_s %.3fs: abandoning the handle",
                    len(item.batch), item.attempt, self.device_timeout_s)
        self._batch_failed(item.snap, item.batch, item.attempt,
                           TimeoutError("device readback watchdog timeout"))

    # ---- graceful drain ---------------------------------------------------

    @property
    def draining(self) -> bool:
        return self._draining

    def begin_drain(self) -> None:
        """Stop admitting (submit answers a typed UNAVAILABLE); queued and
        in-flight work keeps flowing to completion.  A canary in progress
        stays undecided: its window timer is cancelled."""
        if not self._draining:
            self._draining = True
            phase = self._canary
            if phase is not None:
                # a window expiry mid-drain must not promote or roll back
                # into a tearing-down process (the swap listeners would
                # rebuild a stopped frontend): the canary stays undecided
                # and cohort routing serves until exit
                phase.cancel_timer()
            if self.metadata_prefetcher is not None:
                # the refresher must not re-pin into a tearing-down
                # process; a stale pin only falls through to the live
                # fetch, so stopping early is always safe
                self.metadata_prefetcher.stop(timeout_s=0.5)
            RECORDER.record("drain", lane="engine", detail={
                "queue": len(self._queue), "inflight": self._inflight})
            log.info("engine draining: admission stopped "
                     "(queue=%d, inflight=%d)", len(self._queue),
                     self._inflight)

    def drain(self, timeout_s: float = 10.0) -> bool:
        """Block until every queued request and in-flight batch has
        resolved (True), or the timeout expires (False).  Call from a
        worker thread; begin_drain() is implied."""
        self.begin_drain()
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._queue_lock:
                if not self._queue and self._inflight == 0:
                    return True
            time.sleep(0.01)
        log.warning("engine drain timed out after %.1fs (queue=%d, "
                    "inflight=%d)", timeout_s, len(self._queue),
                    self._inflight)
        return False

    # ---- the fleet plane -------------------------------------------------

    def fleet_health(self) -> Dict[str, Any]:
        """The fleet router's per-replica health dict: the /readyz,
        admission and breaker evidence (``admission.health_signal``), so
        in-process replicas and replicas polled over HTTP publish one
        shape.  Every read is atomic under the interpreter lock: safe from
        the router's decision path under load."""
        h = self.admission.health_signal(len(self._queue))
        h["ready"] = self._snapshot is not None and not self._draining
        h["draining"] = self._draining
        h["breaker_open"] = self.breaker.state != "closed"
        h["generation"] = self.generation
        return h

    def fleet_fold(self) -> Dict[str, Any]:
        """One replica's fold for the fleet aggregator (fleet/aggregate.py):
        health, cumulative counters (the aggregator differences consecutive
        folds; cumulatives survive a missed publish) and the per-tenant
        rate EWMAs whose fleet-wide sum is the global tenant share.  Small
        and cadence-published, never anything per request."""
        fold = self.fleet_health()
        fold["errors"] = self.error_total
        if self.slo is not None:
            fold["slo_total"] = self.slo.total
            fold["slo_bad"] = self.slo.bad_total
        else:
            fold["slo_total"] = fold["slo_bad"] = 0
        ten = self.tenancy
        if ten.enabled:
            fold["tenants"] = ten.stats.export_fold()
            fold["tenant_rejects"] = {
                t: sum(r.values())
                for t, r in list(ten.admission.rejected.items())}
        else:
            fold["tenants"] = {}
            fold["tenant_rejects"] = {}
        # the fleet-pressure gate of the global containment check: this
        # replica's wait is hot or its admission gate left HEALTHY
        fold["wait_hot"] = bool(
            self.admission.wait_ewma > self.admission.target_s
            or self.admission.overloaded)
        fold["admission_state"] = ("OVERLOADED" if self.admission.overloaded
                                   else "HEALTHY")
        return fold

    # ---- dedup and the verdict cache ---------------------------------------

    def _cache_keys(self, keys, n, snap, rows):
        """Full verdict-cache keys of one batch: (the row's config cache
        token, the row's bytes)."""
        if keys is None or self._verdict_cache is None:
            return None
        tokens = snap.cache_tokens
        return [(tokens[rows[r]], keys[r]) for r in range(n)]

    def _dedup_plan(self, keys, ckeys, n, eligible):
        """Cache lookup + within-batch collapse of one batch.
        ``eligible(r)`` gates the cache (a cacheable config and not a lossy
        host-fallback row).  Returns (cached {row: value}, miss_rows,
        unique_rows, inverse, eligible_misses)."""
        cache = self._verdict_cache
        cached: Dict[int, Any] = {}
        eligible_misses = 0
        if cache is not None and ckeys is not None:
            miss_rows: List[int] = []
            for r in range(n):
                if eligible(r):
                    v = cache.get(ckeys[r])
                    if v is not None:
                        cached[r] = v
                        continue
                    eligible_misses += 1
                miss_rows.append(r)
        else:
            miss_rows = list(range(n))
        if self.batch_dedup and keys is not None:
            unique_rows, inverse = dedup_rows(keys, miss_rows)
        else:
            unique_rows, inverse = miss_rows, np.arange(len(miss_rows))
        return cached, miss_rows, unique_rows, inverse, eligible_misses

    def _cache_insert(self, ckeys, unique_rows, eligible,
                      own_rule, own_skipped) -> int:
        """Insert freshly evaluated unique rows under the keys taken from
        the batch's pinned snapshot; returns the evictions it caused."""
        cache = self._verdict_cache
        if cache is None or ckeys is None:
            return 0
        evict0 = cache.evictions
        for r in unique_rows:
            if eligible(r):
                cache.put(ckeys[r],
                          (own_rule[r].copy(), own_skipped[r].copy()))
        return cache.evictions - evict0

    def _encode_and_launch(self, snap: _Snapshot,
                           batch: List[_Pending]) -> _Inflight:
        """Encode, pack, answer cached rows, collapse the rest to unique
        rows and launch once on them; returns the in-flight batch.  The
        finalize closure runs on the completion stage with the readback
        and fans the verdicts back out (bit-identical: the kernel is a
        pure per-row function of the operand bytes)."""
        if snap.sharded is not None:
            return self._encode_and_launch_sharded(snap, batch)
        n = len(batch)
        pad = bucket_pow2(n)
        t0 = time.monotonic()
        waits = np.array([(t0 - p.t_enq) if p.t_enq else 0.0 for p in batch])
        self.admission.observe_waits(waits, now=t0)
        policy = snap.policy
        docs = [p.doc for p in batch]
        rows = [policy.config_ids[p.config_name] for p in batch]
        db = pack_batch(policy, encode_batch(policy, docs, rows,
                                             batch_pad=pad))
        cacheable = policy.config_cacheable
        keys = (batch_row_keys(db, n)
                if self.batch_dedup or self._verdict_cache is not None
                else None)
        ckeys = self._cache_keys(keys, n, snap, rows)

        def eligible(r: int) -> bool:
            return bool(cacheable[rows[r]]) and not bool(db.host_fallback[r])

        cached, miss_rows, unique_rows, inverse, elig_miss = self._dedup_plan(
            keys, ckeys, n, eligible)
        u = len(unique_rows)
        E = int(policy.eval_rule.shape[1])
        W = packed_width(1 + 2 * E)
        if u == n:
            db_u, pad_u = db, pad   # nothing collapsed: ship the batch as is
        elif u:
            pad_u = bucket_pow2(u)
            db_u = select_rows(db, unique_rows, batch_pad=pad_u)
        else:
            db_u, pad_u = None, 0   # every row from the cache: no launch
        _observe_stage("encode", time.monotonic() - t0)
        # the DeviceBatch span's window opens at the launch
        t1 = time.monotonic()
        start_ns = time.time_ns()
        if db_u is not None:
            if faults.ACTIVE:
                faults.FAULTS.check("h2d", "engine")
                faults.FAULTS.check("kernel", "engine")
            launched = pe.dispatch_fused(snap.params, db_u)
            if launched.nbytes != pad_u * W:
                raise RuntimeError("readback is not [pad, W] uint8")
            # a hang or delay rule wraps the real launch's handle
            handle = (faults.FAULTS.wrap_handle(launched, "engine")
                      if faults.ACTIVE else launched)
        else:
            launched = handle = _Resolved()
        _observe_stage("launch", time.monotonic() - t1)
        record = {"rows": n, "device_rows": u, "pad_rows": pad_u,
                  "dedup_rows": len(miss_rows) - u, "cache_rows": len(cached),
                  "degraded_rows": 0,
                  "launches": launched.launches,
                  "plain_calls": launched.plain_calls,
                  "h2d_bytes": staged_h2d_bytes(db_u) if u else 0,
                  "d2h_bytes": launched.nbytes}
        self.batch_records.append(dict(
            record, generation=snap.generation,
            **({"contained": True} if batch[0].contained else {})))
        self._add_stats(batches=1, cached_batches=int(u == 0), **record)
        # the structural cost fold: one device computation per cut with a
        # device row (the kernel's launch on a card, its plain version's
        # call on the CPU), none for a cut the cache answered whole
        try:
            LEDGER.observe(
                "engine", rows=n, device_rows=u,
                launches=(record["launches"] + record["plain_calls"]
                          + getattr(launched, "lane_calls", 0)),
                h2d_bytes=record["h2d_bytes"], d2h_bytes=record["d2h_bytes"],
                pad_rows=pad_u, dedup_avoided_rows=record["dedup_rows"],
                cache_avoided_rows=record["cache_rows"])
        except Exception:
            log.exception("kernel cost fold failed (batch unaffected)")
        binfo = {"batch_size": n, "device_rows": u, "t0": t0, "pad": pad_u,
                 "eff": (int(db_u.attr_bytes.shape[-1])
                         if db_u is not None and db_u.attr_bytes is not None
                         and snap.params["dfa_tables"] is not None else 0),
                 "start_ns": start_ns}

        def finalize(packed):
            # rows the cache answered start from the kernel's pad values
            # and are overwritten below
            own_rule = np.ones((n, E), dtype=bool)
            own_skipped = np.zeros((n, E), dtype=bool)
            if u:
                cols = unpack_verdicts(packed, 1 + 2 * E)
                mr = np.asarray(miss_rows)
                own_rule[mr] = cols[inverse, 1:1 + E]
                own_skipped[mr] = cols[inverse, 1 + E:1 + 2 * E]
            for r, (c_rule, c_skip) in cached.items():
                own_rule[r] = c_rule
                own_skipped[r] = c_skip
            fb = np.nonzero(db.host_fallback[:n])[0]
            binfo["fallback_n"] = len(fb)
            if len(fb):
                # the compact payload was lossy for these rows (membership
                # overflow): exact re-decision through the host oracle
                self._add_stats(host_fallback=len(fb))
                apply_host_fallback(
                    lambda r: host_results(policy, docs[r], rows[r])[1:],
                    fb, own_rule, own_skipped, None)
            evicted = self._cache_insert(ckeys, unique_rows, eligible,
                                         own_rule, own_skipped)
            metrics_mod.observe_dedup("engine", n, u, len(cached),
                                      elig_miss, evicted)
            # attribution: one per-batch fold over the FINAL columns —
            # cache hits, dedup fan-out and fallback rows are already
            # folded back in, so every path attributes identically
            # (``waits``, the queue waits at the encode, feed the tenant
            # plane's wait signal: they must not absorb the device trip)
            # the canary phase this fold left a decision due on, if any:
            # the completion resolves the batch after that decision
            binfo["due"] = self._observe_provenance(
                snap, batch, rows, own_rule, own_skipped, waits=waits)
            return own_rule, own_skipped

        return _Inflight(self, batch, handle, finalize, binfo, waits)

    def _encode_and_launch_sharded(self, snap: _Snapshot,
                                   batch: List[_Pending]) -> _Inflight:
        """The mesh mirror of ``_encode_and_launch``: the row key folds in
        shard_of/row_of (config identity on the mesh), cached rows answer
        from the [shard][row] tokens, the unique rows re-pad to the
        dp-aligned bucket, and the launch is the routed mesh dispatch
        (per-device breakers, failover to the emptiest healthy device;
        ``MeshUnavailable`` when every device is down takes the retry
        path)."""
        from ..parallel.sharded_eval import flat_config_rows

        sharded = snap.sharded
        n = len(batch)
        pad = bucket_pow2(n)
        t0 = time.monotonic()
        waits = np.array([(t0 - p.t_enq) if p.t_enq else 0.0 for p in batch])
        self.admission.observe_waits(waits, now=t0)
        docs = [p.doc for p in batch]
        names = [p.config_name for p in batch]
        enc = sharded.encode(docs, names, batch_pad=pad)
        keys = (sharded.row_keys(enc, n)
                if self.batch_dedup or self._verdict_cache is not None
                else None)
        tokens = snap.mesh_tokens
        ckeys = ([(tokens[enc.shard_of[r]][enc.row_of[r]], keys[r])
                  for r in range(n)]
                 if keys is not None and self._verdict_cache is not None
                 else None)

        def eligible(r: int) -> bool:
            return (bool(sharded.config_cacheable[enc.shard_of[r],
                                                  enc.row_of[r]])
                    and not bool(enc.host_fallback[r]))

        cached, miss_rows, unique_rows, inverse, elig_miss = self._dedup_plan(
            keys, ckeys, n, eligible)
        u = len(unique_rows)
        E = sharded.E
        W = packed_width(1 + 2 * E)
        if u == n:
            enc_u = enc
        elif u:
            enc_u = sharded.select_rows(enc, unique_rows,
                                        batch_pad=bucket_pow2(u))
        else:
            enc_u = None  # every row from the cache: no launch
        pad_u = int(enc_u.attrs_val.shape[0]) if enc_u is not None else 0
        _observe_stage("encode", time.monotonic() - t0)
        t1 = time.monotonic()
        start_ns = time.time_ns()
        route = None
        if enc_u is not None:
            if faults.ACTIVE:
                faults.FAULTS.check("h2d", "engine")
                faults.FAULTS.check("kernel", "engine")
            launched, route = sharded.dispatch_routed(enc_u, lane="engine")
            if launched.nbytes != pad_u * W:
                sharded.complete_route(route, ok=False)
                raise RuntimeError("readback is not [pad, W] uint8")
            handle = (faults.FAULTS.wrap_handle(launched, "engine")
                      if faults.ACTIVE else launched)
        else:
            launched = handle = _Resolved()
        _observe_stage("launch", time.monotonic() - t1)
        record = {"rows": n, "device_rows": u, "pad_rows": pad_u,
                  "dedup_rows": len(miss_rows) - u, "cache_rows": len(cached),
                  "degraded_rows": 0, "launches": 0, "plain_calls": 0,
                  "h2d_bytes": (sharded._encoded_h2d_bytes(enc_u)
                                if enc_u is not None else 0),
                  "d2h_bytes": launched.nbytes}
        self.batch_records.append(dict(
            record, generation=snap.generation, lane="mesh",
            devices=list(route.devices) if route is not None else [],
            **({"contained": True} if batch[0].contained else {})))
        self._add_stats(batches=1, cached_batches=int(u == 0), **record)
        # the mesh lane's fold: the shard-step's launch and bytes were
        # counted at the dispatch (failovers included); this adds the
        # batch's rows, dedup and cache cuts and pad waste
        try:
            LEDGER.observe(
                "mesh", rows=n, device_rows=u, pad_rows=pad_u,
                dedup_avoided_rows=record["dedup_rows"],
                cache_avoided_rows=record["cache_rows"])
        except Exception:
            log.exception("kernel cost fold failed (batch unaffected)")
        binfo = {"batch_size": n, "device_rows": u, "t0": t0, "pad": pad_u,
                 "eff": (int(enc_u.attr_bytes.shape[-1])
                         if enc_u is not None and enc_u.attr_bytes is not None
                         else 0),
                 "start_ns": start_ns}
        flat = flat_config_rows(enc.shard_of[:n], enc.row_of[:n],
                                sharded.configs_per_shard)

        def finalize(packed):
            own_rule = np.ones((n, E), dtype=bool)
            own_skipped = np.zeros((n, E), dtype=bool)
            if u:
                cols = unpack_verdicts(packed, 1 + 2 * E)
                mr = np.asarray(miss_rows)
                own_rule[mr] = cols[inverse, 1:1 + E]
                own_skipped[mr] = cols[inverse, 1 + E:1 + 2 * E]
            for r, (c_rule, c_skip) in cached.items():
                own_rule[r] = c_rule
                own_skipped[r] = c_skip
            fb_n = sharded.apply_fallback(enc.host_fallback, docs, names,
                                          own_rule, own_skipped)
            binfo["fallback_n"] = fb_n
            if fb_n:
                self._add_stats(host_fallback=fb_n)
            evicted = self._cache_insert(ckeys, unique_rows, eligible,
                                         own_rule, own_skipped)
            metrics_mod.observe_dedup("engine", n, u, len(cached),
                                      elig_miss, evicted)
            binfo["due"] = self._observe_provenance(
                snap, batch, flat, own_rule, own_skipped, waits=waits)
            return own_rule, own_skipped

        item = _Inflight(self, batch, handle, finalize, binfo, waits)
        item.route = route
        return item

    @staticmethod
    def _route_done(item: _Inflight, ok: bool) -> None:
        """Terminal mesh-route accounting for one in-flight batch: the
        per-device breaker verdicts and the occupancy release (idempotent;
        a no-op off the mesh)."""
        route = item.route
        if route is None:
            return
        item.route = None
        try:
            sharded = getattr(item.snap, "sharded", None) \
                if item.snap is not None else None
            if sharded is not None:
                sharded.complete_route(route, ok, lane="engine")
            else:
                route.release()
        except Exception:
            log.exception("mesh route accounting failed (batch unaffected)")

    # ---- decision observability -------------------------------------------

    def _observe_provenance(self, snap: _Snapshot, pendings: List[_Pending],
                            rows, own_rule, own_skipped, waits=None):
        """Per-batch decision-observability fold: which-rule-fired columns →
        the snapshot's heat map (one vectorized composite-key add), plus at
        most one head-sampled decision record per authconfig, and the
        tenant plane's per-tenant counters.  Never raises — a telemetry
        fault must not re-dispatch a decided batch.  Returns the canary
        phase whose guard decision this fold left due (its breach or its
        window's end), else None: the caller resolves the batch after that
        decision (``_resolve_after_guard``)."""
        try:
            heat = snap.heat
            if heat is None:
                return None
            due = None
            firing = firing_columns(own_rule, own_skipped)
            p = pendings[0] if pendings else None
            now_m = time.monotonic()
            prov_mod.fold_and_sample(
                heat, rows, firing, len(pendings), lane="engine",
                host=_doc_host(p.doc) if p is not None else "",
                latency_ms=((now_m - p.t_enq) * 1e3
                            if p is not None and p.t_enq else 0.0),
                generation=snap.generation,
                # each sampled authconfig's record carries ITS OWN
                # request's host/latency, not the batch head's
                host_of=lambda i: _doc_host(pendings[i].doc),
                latency_of=lambda i: ((now_m - pendings[i].t_enq) * 1e3
                                      if pendings[i].t_enq else 0.0))
            # the tenant axis rides the same per-batch seam, on every lane
            # (the device's, the contained part's, the CPU degrade's), with
            # two clocks: ``waits`` (queue waits at the encode; the sojourn
            # where none were taken) feed the per-tenant CoDel signal, and
            # the SLO mask reads the whole sojourn at completion
            if self.tenancy.enabled:
                sojourn = np.asarray([(now_m - q.t_enq) if q.t_enq else 0.0
                                      for q in pendings])
                self.tenancy.fold(
                    heat, rows, firing=firing,
                    waits=(waits if waits is not None else sojourn),
                    bad_mask=(sojourn > self.slo.slo_s
                              if self.slo is not None else None),
                    lane="engine")
            # traffic capture rides the same per-batch seam: one enabled
            # check per batch when off; when on, each sampled decision's
            # (authconfig, doc, firing column of the readback) is queued
            # for the capture log's own drain thread, which encodes and
            # persists it (never this thread)
            if CAPTURE.enabled:
                self._offer_capture(snap, pendings, firing)
            # the canary guards read the same attribution columns: a part
            # rides one generation, so the evaluating snapshot names the
            # cohort
            phase = self._canary
            if phase is not None and \
                    (snap is phase.snap or snap is phase.baseline):
                phase.guard.observe_batch(snap is phase.snap, rows, firing,
                                          heat)
                if phase.guard.breach() is not None or phase.expired():
                    due = phase
        except Exception:
            log.exception("provenance fold failed (decision unaffected)")
            return None
        return due

    def _offer_capture(self, snap: _Snapshot, pendings: List[_Pending],
                       firing) -> None:
        """Queue this batch's sampled decisions for capture, each stamped
        with the digest of the pinned metadata documents its config was
        decided under (None: nothing pinned)."""
        pf = self.metadata_prefetcher
        md_digests: Dict[str, Optional[str]] = {}
        for i in CAPTURE.sample_indices(len(pendings)):
            pi = pendings[i]
            md = None
            if pf is not None:
                if pi.config_name not in md_digests:
                    md_digests[pi.config_name] = pf.digest_for(
                        pi.config_name)
                md = md_digests[pi.config_name]
            CAPTURE.offer(pi.config_name, pi.doc, int(firing[i]), "engine",
                          snap.generation, metadata_doc_digest=md)

    # ---- the host-oracle degrade ------------------------------------------

    def _host_decide_batch(self, snap: _Snapshot, batch: List[_Pending]):
        """Row-by-row exact host decisions for one batch through the
        expression oracle (``host_results``, membership overflow
        included).  Returns (resolutions-by-loop, failed-futures-by-loop,
        rows decided, the canary phase the fold left due); a row whose oracle run itself failed lands in
        ``failed`` (typed UNAVAILABLE, fail closed).  The batch folds into
        the cost ledger's ``host`` lane (no launch, no bytes) and its
        columns into the same heat map and decision log as the device
        lane's, through the same per-batch fold."""
        by_loop: Dict[Any, list] = {}
        failed: Dict[Any, list] = {}
        decided = []   # (pending, config row, rule [E], skipped [E])
        for p in batch:
            try:
                if snap.sharded is not None:
                    s_, r_ = snap.sharded.locator[p.config_name]
                    row = s_ * snap.sharded.configs_per_shard + r_
                    rule, skipped = snap.sharded.host_decide(p.config_name,
                                                             p.doc)
                else:
                    row = snap.policy.config_ids[p.config_name]
                    _, rule, skipped = host_results(snap.policy, p.doc, row)
            except Exception:
                log.exception("host oracle failed for config %r "
                              "(fail-closed UNAVAILABLE)", p.config_name)
                failed.setdefault(p.loop, []).append(p.future)
                continue
            decided.append((p, row, rule, skipped))
            by_loop.setdefault(p.loop, []).append(
                (p.future, rule, skipped, snap))
        if batch:
            try:
                LEDGER.observe("host", rows=len(batch))
            except Exception:
                log.exception("kernel cost fold failed (batch unaffected)")
        due = None
        if decided:
            pendings, rows, rules, skips = zip(*decided)
            due = self._observe_provenance(
                snap, list(pendings), np.asarray(rows), np.stack(rules),
                np.stack(skips))
        return by_loop, failed, len(decided), due

    @staticmethod
    def _resolve_host_decisions(by_loop, failed) -> None:
        for loop, resolutions in by_loop.items():
            try:
                loop.call_soon_threadsafe(_resolve_many, resolutions)
            except RuntimeError:
                pass  # the loop closed since submit: its futures are moot
        for loop, futs in failed.items():
            try:
                loop.call_soon_threadsafe(_fail_many, futs, CheckAbort(
                    UNAVAILABLE, "policy evaluation unavailable"))
            except RuntimeError:
                pass

    def _degrade_batch(self, snap: _Snapshot, batch: List[_Pending],
                       exc: Optional[Exception] = None,
                       reason: str = "device-failure") -> None:
        """The CPU engine's last lane: every request re-decided row by row
        through the host oracle, counted as degraded (the metric, ``stats``, the
        ledger's ``host`` lane, a batch record with no launch) and fed to
        admission and the SLO once.  Typed UNAVAILABLE only for rows whose
        oracle run itself fails."""
        by_loop, failed, n_ok, due = self._host_decide_batch(snap, batch)
        n_failed = len(batch) - n_ok
        if n_ok:
            metrics_mod.degraded_decisions.labels("engine").inc(n_ok)
            self.admission.observe_service(n_ok)
            if self.slo is not None:
                now = time.monotonic()
                n_bad = sum(1 for p in batch if p.t_enq
                            and now - p.t_enq > self.slo.slo_s)
                self.slo.observe(n_ok, min(n_bad, n_ok))
            if exc is not None:
                log.warning("micro-batch of %d re-decided host-side after "
                            "device failure (%r)", len(batch), exc)
        self.batch_records.append({
            "rows": len(batch), "device_rows": 0, "pad_rows": 0,
            "dedup_rows": 0, "cache_rows": 0, "degraded_rows": n_ok,
            "launches": 0, "plain_calls": 0, "h2d_bytes": 0, "d2h_bytes": 0,
            "generation": snap.generation, "degraded": reason})
        self._add_stats(degraded_rows=n_ok, degraded_batches=1,
                        failed_batches=int(n_failed > 0))
        self.error_total += n_failed
        if n_failed and batch:
            # rows the oracle itself fails are serving errors: a canary
            # artifact broken on both lanes still feeds the guard
            self._canary_errors(batch, n_failed)
        self._resolve_after_guard(
            due, lambda: self._resolve_host_decisions(by_loop, failed))

    def debug_vars(self) -> Dict[str, Any]:
        """JSON-safe live state: the config generation, the dispatcher's
        backlog and in-flight window, admission and the adaptive window,
        the circuit breaker and the fault plane,
        the last reconcile's phases and modeled kernel cost, the SLO
        burn-rate windows, the flight recorder's tail, the kernel cost
        ledger, and decision provenance (heat-map shape and fold evidence,
        the never-fired rules, the decision log's state).  Read-only."""
        snap = self._snapshot
        heat = snap.heat if snap is not None else None
        return {
            "generation": self.generation,
            "max_batch": self.max_batch,
            "members_k": self.members_k,
            "queue_depth": len(self._queue),
            "inflight_batches": self._inflight,
            "inflight_peak": self.inflight_peak,
            "max_inflight_batches": self.max_inflight_batches,
            "dispatch_workers": self.dispatch_workers,
            "batch_dedup": self.batch_dedup,
            "verdict_cache": (self._verdict_cache.counts()
                              if self._verdict_cache is not None else None),
            "breaker": self.breaker.to_json(),
            # the mesh lane: per-device breakers and their trail,
            # occupancy, launches, failovers, the per-shard upload
            "sharded": snap is not None and snap.sharded is not None,
            "mesh": (snap.sharded.mesh_vars()
                     if snap is not None and snap.sharded is not None
                     else None),
            "host_degrade": self.host_degrade,
            "draining": self._draining,
            "device_timeout_s": self.device_timeout_s,
            "device_rtt_ewma_s": self._device_ewma,
            "admission": self.admission.to_json(),
            "adaptive": self.controller.to_json(),
            "control_plane": self._control_plane,
            # the reconcile's verification planes: the gate's setting, the
            # advisory passes' reports and the serving snapshot's
            # translation-validation counts
            "strict_verify": self.strict_verify,
            "policy_analysis": self._analysis,
            "lowerability": self._lowerability,
            "translation_validation": (snap.translation
                                       if snap is not None else None),
            # pinned-document counts, staleness and refresh knobs, the
            # hit/miss/stale counters
            "metadata_prefetch": (self.metadata_prefetcher.to_json()
                                  if self.metadata_prefetcher is not None
                                  else None),
            "replay": self.replay_vars(),
            # the decision corpus and its pregate's last verdict
            "corpus": self.corpus_vars(),
            # the durable state plane (--state-dir): the warm start's
            # outcome per phase, live staleness, the write-behind cadence
            "state_plane": (self.state_plane.to_json()
                            if self.state_plane is not None else None),
            "change_safety": self.change_safety_vars(),
            # the tenant plane: weights, the fair cut, per-tenant admission
            # and waits, the top tenants and containment (/debug/tenants)
            "tenancy": self.tenancy.to_json(),
            "slo": self.slo.to_json() if self.slo is not None else None,
            "faults": (faults.FAULTS.describe() if faults.ACTIVE else
                       {"armed": False}),
            "flight_recorder": RECORDER.to_json(),
            # the process-wide structural ledger (launches, bytes, pad
            # waste per lane), the modeled per-row cost lineage, and the
            # kernel entry points the serving snapshot dispatches through
            "kernel_cost": {
                "ledger": LEDGER.to_json(),
                "modeled": self._cost_model.to_json(),
                "entry_points": kernel_cost_mod.entry_points(
                    snap.policy if snap is not None else None),
            },
            "provenance": {
                "expose_deny_reason": prov_mod.EXPOSE_DENY_REASON,
                "heat": heat.to_json() if heat is not None else None,
                # cross-referenced against the static policy analysis: a
                # rule it calls constant-allow cannot fire
                "dead_rules": prov_mod.dead_rule_report(heat,
                                                        self._analysis),
                "decisions": {
                    "capacity": prov_mod.DECISIONS.capacity,
                    "sample_n": prov_mod.DECISIONS.sample_n,
                    "records_total": prov_mod.DECISIONS.records_total,
                },
            },
        }

    # ---- completion -------------------------------------------------------

    def _complete(self, item: _Inflight) -> None:
        """Completion stage (the completer thread, once the readback
        arrived): finalize, resolve the futures on their own loops, free
        the window slot.  A readback or finalize failure is a device
        failure and takes the retry path; a failure after the
        verdicts exist is a host bug: it never feeds the breaker and
        answers the unresolved requests UNAVAILABLE without a retry."""
        try:
            t_done = time.monotonic()
            if faults.ACTIVE:
                faults.FAULTS.check("readback", "engine")
            packed = item.handle.wait()
            own_rule, own_skipped = item.finalize(packed)
        except Exception as e:
            # a mesh batch: its devices' breakers and windows first, then
            # the retry (whose fresh dispatch routes around a sick device)
            self._route_done(item, ok=False)
            self._batch_failed(item.snap, item.batch, item.attempt, e)
            return
        self._route_done(item, ok=True)
        slo_counted = False
        due = item.binfo.get("due")
        try:
            # the device answered: clear the breaker's consecutive-failure
            # count (and close a half-open probe) before the resolution
            # work.  A batch the cache answered whole proves nothing about
            # the device: it only frees a claimed probe slot
            if item.binfo.get("device_rows", 1) == 0:
                self.breaker.release_probe()
            else:
                self.breaker.record_success()
            dur = t_done - item.t_launch
            self._device_ewma = (dur if not self._device_ewma
                                 else 0.8 * self._device_ewma + 0.2 * dur)
            n = item.binfo["batch_size"]
            self.controller.observe_batch(dur, n, len(self._queue),
                                          now=t_done)
            self.admission.observe_service(n, now=t_done)
            slo_counted = self._observe_batch(item, dur)
            if tracing_mod.tracing_active():
                # one DeviceBatch span per batch, span-linked to every
                # constituent request's trace (export only: a link list per
                # batch, nothing per request)
                links = [(p.span.trace_id, p.span.span_id)
                         for p in item.batch if p.span is not None
                         and getattr(p.span, "sampled", True)]
                if links:
                    binfo = item.binfo
                    tracing_mod.export_device_batch_span(
                        n, binfo["pad"], binfo["eff"], links,
                        binfo["start_ns"], dur)
            by_loop: Dict[Any, list] = {}
            for i, p in enumerate(item.batch):
                by_loop.setdefault(p.loop, []).append(
                    (p.future, own_rule[i], own_skipped[i], item.snap))
            self._resolve_after_guard(
                due, lambda: self._resolve_host_decisions(by_loop, {}))
            self.batch_latency_s.append(time.monotonic() - item.binfo["t0"])
            _observe_stage("resolve", time.monotonic() - t_done)
        except Exception as e:
            log.exception("post-completion work failed (batch verdicts "
                          "already computed)")
            self._resolve_after_guard(due, lambda: self._resolve_error(
                item.batch, e, slo_counted=slo_counted))
        finally:
            self._launch_done()

    def _observe_batch(self, item: _Inflight, dur: float) -> bool:
        """The per-batch observability fold at completion, O(1) or one
        vectorized pass over the batch: the SLO (a request is bad when its
        queue wait plus this batch's device stage exceeds the target), the
        device stage and the batch families.  Never raises — a telemetry
        fault must not change a decided batch's verdicts.  Returns whether
        the SLO counted the batch."""
        counted = False
        try:
            if self.slo is not None:
                lat = np.asarray(item.waits) + dur
                n_bad = int(np.count_nonzero(lat > self.slo.slo_s))
                self.slo.observe(len(item.batch), n_bad)
                counted = True
                # the SLO guard: per-cohort bad fractions from the same
                # per-batch counts
                phase = self._canary
                if phase is not None and \
                        item.snap in (phase.snap, phase.baseline):
                    phase.guard.observe_slo(item.snap is phase.snap,
                                            len(item.batch), n_bad)
            binfo = item.binfo
            metrics_mod.observe_pipeline_stage("engine", "device", dur)
            metrics_mod.observe_batch(
                "engine", binfo["batch_size"], binfo.get("pad", 0),
                item.waits, dur, binfo.get("fallback_n"),
                device_rows=binfo.get("device_rows"))
        except Exception:
            log.exception("batch telemetry fold failed (decision unaffected)")
        return counted

    def _resolve_error(self, batch: List[_Pending], exc: Exception,
                       slo_counted: bool = False) -> None:
        """Fail unresolved requests with a TYPED CheckAbort — never the raw
        exception, whose text would otherwise serve as a deny reason; the
        raw cause is logged here and the batch counted in
        ``failed_batches`` (deadline sheds are not failures).  Serving
        errors burn the SLO budget (``slo_counted``: a failure after the
        success path already observed the batch does not burn twice)."""
        if not isinstance(exc, CheckAbort):
            log.error("batch of %d failed: %r", len(batch), exc,
                      exc_info=exc)
            exc = CheckAbort(UNAVAILABLE, "policy evaluation unavailable")
        if exc.code != DEADLINE_EXCEEDED:
            self._add_stats(failed_batches=1)
            self.error_total += len(batch)
            if self.slo is not None and not slo_counted:
                try:
                    self.slo.observe_errors(len(batch))
                except Exception:
                    log.exception("SLO error fold failed")
            # a canary generation whose batches keep failing must breach
            # even when it never produces a deny column
            self._canary_errors(batch, len(batch))
        self._fail_all(batch, exc)

    def _canary_errors(self, batch: List[_Pending], n: int) -> None:
        """The typed-error guard feed: ``n`` serving errors of one part
        (parts are cohort-homogeneous)."""
        phase = self._canary
        if phase is None or not batch:
            return
        try:
            phase.guard.observe_errors(bool(batch[0].canary), n)
            self._canary_poke(phase)
        except Exception:
            log.exception("canary error feed failed")

    @staticmethod
    def _fail_all(batch: List[_Pending], exc: CheckAbort) -> None:
        """Fail every unresolved future of ``batch`` with ``exc`` on its
        own loop; nothing counted."""
        by_loop: Dict[Any, list] = {}
        for p in batch:
            by_loop.setdefault(p.loop, []).append(p.future)
        for loop, futs in by_loop.items():
            try:
                loop.call_soon_threadsafe(_fail_many, futs, exc)
            except RuntimeError:
                pass

    def _launch_done(self) -> None:
        with self._queue_lock:
            self._inflight -= 1
            inflight = self._inflight
        self._g_inflight.set(inflight)
        self._maybe_dispatch()


def _observe_stage(stage: str, seconds: float) -> None:
    """One pipeline-stage sample; never raises (a telemetry fault must not
    fail a decided batch)."""
    try:
        metrics_mod.observe_pipeline_stage("engine", stage, seconds)
    except Exception:
        log.exception("pipeline stage fold failed (decision unaffected)")


def _doc_host(doc) -> str:
    """Best-effort host of one authorization JSON (decision-log records)."""
    try:
        return str((doc.get("request") or {}).get("host", ""))
    except Exception:
        return ""


def _split_cohorts(batch, phase):
    """Partition one cut by canary cohort: [(is_canary, items), ...] with
    empties dropped.  With no canary in progress the cut ships whole."""
    if phase is None:
        return [(False, batch)]
    base = [p for p in batch if not p.canary]
    can = [p for p in batch if p.canary]
    parts = []
    if base:
        parts.append((False, base))
    if can:
        parts.append((True, can))
    return parts or [(False, batch)]


def _resolve_many(resolutions) -> None:
    for fut, rule, skipped, snap in resolutions:
        if not fut.done():
            fut.set_result((rule, skipped, snap))


def _fail_many(futs, exc) -> None:
    for fut in futs:
        if not fut.done():
            fut.set_exception(exc)


# ---------------------------------------------------------------------------
# shared pipeline stages, process-wide: engines are created freely (tests,
# reconciles) and per-engine threads with no shutdown path would leak.
#
#   encode pool — workers for the encode stage and the retries; its size
#                 bounds host parallelism, not the in-flight window (each
#                 engine's own counter)
#   completer   — one thread that polls the in-flight readbacks and
#                 finalizes each arrived batch the moment it lands
# ---------------------------------------------------------------------------

_ENCODE_POOL: Optional[ThreadPoolExecutor] = None
_ENCODE_POOL_LOCK = threading.Lock()


def _encode_pool(workers: int = 4) -> ThreadPoolExecutor:
    global _ENCODE_POOL
    if _ENCODE_POOL is None:
        with _ENCODE_POOL_LOCK:
            if _ENCODE_POOL is None:
                _ENCODE_POOL = ThreadPoolExecutor(
                    max_workers=max(1, workers),
                    thread_name_prefix="authz-engine-encode")
    return _ENCODE_POOL


_COMPLETER: Optional[threading.Thread] = None
_COMPLETER_LOCK = threading.Lock()
_COMPLETER_ITEMS: deque = deque()
_COMPLETER_EVT = threading.Event()
# the completer's poll while nothing in flight is ready (a new batch wakes
# it at once)
POLL_S = 5e-4


def _completer_submit(item: _Inflight) -> None:
    _ensure_completer()
    _COMPLETER_ITEMS.append(item)
    _COMPLETER_EVT.set()


def _ensure_completer() -> None:
    global _COMPLETER
    if _COMPLETER is None or not _COMPLETER.is_alive():
        with _COMPLETER_LOCK:
            if _COMPLETER is None or not _COMPLETER.is_alive():
                t = threading.Thread(target=_completer_loop,
                                     name="authz-engine-completer",
                                     daemon=True)
                t.start()
                _COMPLETER = t


def _completer_loop() -> None:
    pending: List[_Inflight] = []
    while True:
        while _COMPLETER_ITEMS:
            try:
                pending.append(_COMPLETER_ITEMS.popleft())
            except IndexError:
                break
        if not pending:
            _COMPLETER_EVT.wait()
            _COMPLETER_EVT.clear()
            continue
        progressed = False
        for item in list(pending):
            if item.ready():
                job = item.engine._complete
            elif item.expired():
                # the watchdog: abandon the handle, retry the batch
                job = item.engine._watchdog_fire
            else:
                continue
            pending.remove(item)
            progressed = True
            try:
                # here, not on the encode pool, whose queue may hold the
                # rest of the burst's encode jobs ahead of it
                job(item)
            except Exception:
                log.exception("batch completion failed")
        # drop the last batch: its snapshot (device params, encoder) must
        # not outlive a swap while the completer idles
        item = job = None
        if not progressed:
            # nothing ready: a sub-millisecond poll keeps resolution
            # independent of launch order
            _COMPLETER_EVT.wait(POLL_S)
            _COMPLETER_EVT.clear()
