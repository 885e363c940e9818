"""Rules-sharded (mp) and data-parallel (dp) policy evaluation over a mesh
of torch devices.

The config axis of the rule corpus is partitioned over ``mp`` shards: each
shard holds the whole boolean circuit of its configs, so the tree reduction
stays shard-local and the only cross-shard step is the final merge of each
request's own-config columns.

Layout:
  - configs are round-robined into ``mp`` groups; each group compiles as its
    own sub-corpus against one shared interner, with ``ShapeTargets``
    forcing identical operand shapes (the DFA row, state and byte-slot axes
    included, so the device regex lane rides the mesh too); the host
    operands stack on a leading ``[S]`` axis;
  - the mesh (``build_mesh``) lays a list of ``torch.device``s out as
    ``[dp, mp]``.  A device may repeat: logical slots on one card (or on
    the CPU), or one card per slot.  Slot ``i * mp + j`` is block (i, j),
    the device id the breakers, the fault plane and the metrics name;
  - one step is a loop over the (dp, mp) blocks: block (i, j) evaluates dp
    slice i of the batch against shard j on its own device (on a card, on
    its own CUDA stream), through the op-chain lane's ``eval_verdicts``,
    and keeps the rows whose config shard j owns.  The blocks' [B_l, 1+2E]
    columns merge by OR (each row is owned by exactly one shard) and
    bitpack into the same [B, W] uint8 readback the single-corpus lanes
    give.  One process: no ``torch.distributed``.

The block's lane is an op-chain lane (``gather`` or ``matmul``); a mesh
asked for the ``fused`` lane runs ``matmul`` blocks.  The plain version of
the mega-kernel serves only CPU tensors, and a mega-kernel launch per
block is a speed candidate, not a port of the mesh (whose step is an op
chain in the JAX package too).

Mesh as a serving lane:

  - **grid relief**: each shard compiles only its sub-corpus, so its
    member-attr grid is ~1/mp of the monolithic corpus and the compact
    membership K grows to ``min(members_k * mp, max(members_k,
    MEMBERS_K_RELIEF_CAP))``: rows that overflowed the single-corpus K ride
    the device when the corpus is rule-sharded;
  - **two-phase staging**: ``defer_upload=True`` compiles and stacks the
    operands on the host only; ``upload()`` stages them.  Strict verify
    lints the packed shards between the two, so a corrupt corpus is
    rejected before any byte reaches a device;
  - **per-shard delta uploads**: ``upload(prev=...)`` diffs the stacked host
    views; the leading axis of every stacked leaf is the shard axis, so a
    mutation ships bytes only to the shards it touched
    (``auth_server_mesh_shard_upload_bytes_total{shard}``);
  - **per-device failover**: ``dispatch_routed`` probes the fault plane per
    device, keeps one circuit breaker per device (runtime/breaker.py
    ``DeviceBreakerSet``, process-wide per mesh, so device health outlives
    reconciles), and re-dispatches a batch that failed on one device to
    the healthy device with the emptiest in-flight window.  With every
    device down it raises ``MeshUnavailable``: the engine's retry, then on
    a CPU engine the host oracle, on a card a typed UNAVAILABLE.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..compiler.compile import (CompiledPolicy, ConfigRules, ShapeTargets,
                                compile_corpus)
from ..compiler.encode import encode_batch
from ..compiler.intern import StringInterner
from ..ops import pattern_eval as pe
from ..ops.fused_kernel import MegakernelHandle
from ..ops.operands import (_put, host_view as checked_view, packed_width,
                            unpack_verdicts)
from ..runtime.kernel_cost import LEDGER

__all__ = ["ShardedPolicyModel", "Mesh", "build_mesh", "MeshUnavailable",
           "MEMBERS_K_RELIEF_CAP", "flat_config_rows", "mesh_lane"]

log = logging.getLogger(__name__)

# grid relief ceiling: rule-sharding shrinks each shard's member-attr grid
# ~1/mp, so the compact membership K can grow ~mp× inside the same
# per-device payload budget.  Beyond it the host-fallback lane remains
# (exactness is never K's job: K only decides which rows ride the device)
MEMBERS_K_RELIEF_CAP = 64


def flat_config_rows(shards, rows, configs_per_shard):
    """Flatten mesh (shard, row) config coordinates to the one flat row key
    the heat map, the per-authconfig telemetry and the tenant folds share:
    ``shard * configs_per_shard + row``, over whole batch arrays."""
    return (np.asarray(shards, dtype=np.int64) * int(configs_per_shard)
            + np.asarray(rows, dtype=np.int64))


class MeshUnavailable(RuntimeError):
    """Every mesh device is down (breakers open, probes failing)."""


def mesh_lane(kernel_lane: Optional[str] = None) -> str:
    """The op-chain lane a mesh block runs: ``gather`` or ``matmul`` when
    asked for by name (``kernel_lane=``, else ``AUTHORINO_TPU_KERNEL_LANE``),
    otherwise ``AUTHORINO_TPU_EVAL_LANE`` (default ``matmul``), the JAX
    package's lane off a TPU."""
    lane = kernel_lane or pe._kernel_lane()
    if lane in ("gather", "matmul"):
        return lane
    env = pe._eval_lane()
    return env if env in ("gather", "matmul") else "matmul"


class Mesh:
    """A ``[dp, mp]`` layout of torch devices.  Two meshes over the same
    devices and shape compare equal and share one routing state (device
    health outlives snapshots)."""

    def __init__(self, devices: Sequence[Sequence[Any]]):
        grid = [[torch.device(d) for d in row] for row in devices]
        if not grid or not grid[0] or any(len(r) != len(grid[0])
                                           for r in grid):
            raise ValueError("a mesh is a non-empty [dp, mp] grid of devices")
        self.grid = grid
        self.shape = {"dp": len(grid), "mp": len(grid[0])}
        self.device_ids = list(range(self.shape["dp"] * self.shape["mp"]))
        self._key = (tuple(str(d) for row in grid for d in row),
                     self.shape["dp"], self.shape["mp"])

    def device(self, slot: int) -> torch.device:
        """The torch device of logical slot ``slot`` (block (i, j) is slot
        ``i * mp + j``)."""
        i, j = divmod(int(slot), self.shape["mp"])
        return self.grid[i][j]

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and other._key == self._key

    def __hash__(self) -> int:
        return hash(self._key)

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.shape['dp']}, mp={self.shape['mp']}, "
                f"devices={list(self._key[0])})")


def build_mesh(devices: Optional[Sequence[Any]] = None,
               dp: Optional[int] = None,
               n_devices: Optional[int] = None) -> Mesh:
    """A ``[dp, mp]`` mesh over ``devices`` (default: every visible CUDA
    card; a device may repeat, e.g. ``[torch.device("cpu")] * 8`` or
    ``[torch.device("cuda", 0)] * 4``).  ``n_devices`` takes the first N;
    ``dp`` defaults to 2 when the count is even and above 1."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not n:
            raise RuntimeError(
                "build_mesh: no CUDA device is visible; pass devices= "
                "(e.g. [torch.device('cpu')] * 8)")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if n_devices:
        devices = devices[:n_devices]
    n = len(devices)
    if not n:
        raise ValueError("build_mesh: no devices")
    if dp is None:
        dp = 2 if n % 2 == 0 and n > 1 else 1
    mp = n // dp
    if not mp:
        raise ValueError(f"build_mesh: dp={dp} exceeds {n} devices")
    return Mesh([devices[i * mp:(i + 1) * mp] for i in range(dp)])


# ---------------------------------------------------------------------------
# operand trees: stack the shards' host trees, slice one shard back out
# ---------------------------------------------------------------------------


def _stack_leaves(xs):
    if all(x is None for x in xs):
        return None
    if isinstance(xs[0], torch.Tensor):
        # a matmul-lane count matrix may be float32 in one shard and bf16
        # in another (``_exact_dtype``): float32 holds both exactly
        dts = {x.dtype for x in xs}
        dt = xs[0].dtype if len(dts) == 1 else torch.float32
        return torch.stack([x.to(dt) for x in xs])
    return np.stack([np.asarray(x) for x in xs])


def _stack_trees(trees: List[Any]):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in t0}
    if isinstance(t0, tuple):
        return tuple(_stack_trees([t[i] for t in trees])
                     for i in range(len(t0)))
    return _stack_leaves(trees)


def _slice_tree(tree, j: int):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _slice_tree(v, j) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_slice_tree(v, j) for v in tree)
    return tree[j]


def _leaf_names(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(flat name, leaf) pairs in ``snapshots.diff.flatten_view``'s naming."""
    out: List[Tuple[str, Any]] = []
    if isinstance(tree, dict):
        for k, v in tree.items():
            out += _leaf_names(v, f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            out += _leaf_names(v, f"{prefix}.{i}")
    else:
        out.append((prefix, tree))
    return out


def _rebuild(tree, fn, prefix: str = ""):
    """``tree``'s structure with each leaf replaced by ``fn(name, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, f"{prefix}.{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_rebuild(v, fn, f"{prefix}.{i}")
                     for i, v in enumerate(tree))
    return fn(prefix, tree)


def _leaf_at(tree, name: str):
    for part in name.split("."):
        if tree is None:
            return None
        tree = tree[int(part)] if isinstance(tree, tuple) else tree.get(part)
    return tree


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return int(x.numel() * x.element_size())
    return int(np.asarray(x).nbytes)


# ---------------------------------------------------------------------------
# per-mesh routing state: device breakers, occupancy, failover evidence,
# process-wide keyed by the mesh (device health outlives snapshots)
# ---------------------------------------------------------------------------

_MESH_STATE: Dict[Mesh, "MeshState"] = {}
_MESH_STATE_LOCK = threading.Lock()


class MeshState:
    def __init__(self, mesh: Mesh, threshold: int = 3, reset_s: float = 5.0):
        from ..runtime.breaker import DeviceBreakerSet

        self.device_ids = list(mesh.device_ids)
        self.breakers = DeviceBreakerSet("mesh", self.device_ids,
                                         threshold=threshold, reset_s=reset_s)
        self.lock = threading.Lock()
        # serializes one batch's enqueue of its blocks, so two dispatcher
        # threads never interleave their blocks on the slots' streams (the
        # JAX package holds the same lock around its collective launch)
        self.launch_lock = threading.Lock()
        self.occupancy: Dict[int, int] = {d: 0 for d in self.device_ids}
        self.occupancy_peak: Dict[int, int] = {d: 0 for d in self.device_ids}
        self.launches: Dict[int, int] = {d: 0 for d in self.device_ids}
        self.failovers: Dict[int, int] = {d: 0 for d in self.device_ids}
        # one CUDA stream per (slot, device) of a card: blocks of one step
        # run concurrently
        self._streams: Dict[Tuple[int, str], Any] = {}

    def stream(self, slot: int, device: torch.device):
        key = (int(slot), str(device))
        s = self._streams.get(key)
        if s is None:
            with self.lock:
                s = self._streams.get(key)
                if s is None:
                    s = self._streams[key] = torch.cuda.Stream(device)
        return s

    def acquire(self, devices: List[int]) -> "MeshRoute":
        from ..utils import metrics as metrics_mod

        with self.lock:
            for d in devices:
                n = self.occupancy[d] = self.occupancy.get(d, 0) + 1
                if n > self.occupancy_peak.get(d, 0):
                    self.occupancy_peak[d] = n
                self.launches[d] = self.launches.get(d, 0) + 1
                metrics_mod.mesh_shard_occupancy.labels(str(d)).set(n)
        return MeshRoute(self, devices)

    def release(self, devices: List[int]) -> None:
        from ..utils import metrics as metrics_mod

        with self.lock:
            for d in devices:
                n = self.occupancy[d] = max(0, self.occupancy.get(d, 0) - 1)
                metrics_mod.mesh_shard_occupancy.labels(str(d)).set(n)

    def device_failed(self, device_id: int, lane: str,
                      failover: bool = True) -> None:
        """Breaker and evidence fold for one attributed device failure.
        ``failover=True`` (dispatch time: the batch re-dispatches elsewhere
        now) also counts auth_server_device_failover_total; a readback
        failure reported through ``complete_route`` passes False."""
        from ..runtime.flight_recorder import RECORDER
        from ..utils import metrics as metrics_mod

        self.breakers.record_failure(device_id)
        if failover:
            metrics_mod.device_failover.labels(str(device_id)).inc()
            with self.lock:
                self.failovers[device_id] = self.failovers.get(device_id, 0) + 1
        RECORDER.record("device-failover", lane=lane,
                        detail={"device": device_id})

    def to_json(self) -> Dict[str, Any]:
        with self.lock:
            return {
                "devices": list(self.device_ids),
                "occupancy": {str(d): n for d, n in self.occupancy.items()},
                "occupancy_peak": {str(d): n
                                   for d, n in self.occupancy_peak.items()},
                "launches": {str(d): n for d, n in self.launches.items()},
                "failovers": {str(d): n for d, n in self.failovers.items()},
                "breakers": self.breakers.to_json(),
            }


def _mesh_state(mesh: Mesh, threshold: int = 3,
                reset_s: float = 5.0) -> MeshState:
    """One MeshState per mesh, process-wide.  The breaker knobs apply only
    at creation: the first engine to touch a mesh fixes its per-device
    breaker tuning."""
    state = _MESH_STATE.get(mesh)
    if state is None:
        with _MESH_STATE_LOCK:
            state = _MESH_STATE.get(mesh)
            if state is None:
                state = _MESH_STATE[mesh] = MeshState(
                    mesh, threshold=threshold, reset_s=reset_s)
    return state


def _reset_mesh_state_for_tests() -> None:
    """Drop every mesh's routing state (breakers, occupancy, failover
    evidence): a fault-injection test must not leak open breakers into its
    neighbours, since equal meshes share one state."""
    with _MESH_STATE_LOCK:
        _MESH_STATE.clear()


class MeshRoute:
    """One launched batch's claim on its device windows and the idempotent
    release.  The engine releases at terminal completion and records the
    per-device breaker outcome through ``ShardedPolicyModel.complete_route``."""

    __slots__ = ("state", "devices", "_done")

    def __init__(self, state: MeshState, devices: List[int]):
        self.state = state
        self.devices = list(devices)
        self._done = False

    def release(self) -> None:
        if not self._done:
            self._done = True
            self.state.release(self.devices)


@dataclass
class _ShardedEncoded:
    attrs_val: np.ndarray      # [B, S, A]
    members_c: np.ndarray      # [B, S, M, K] compact membership rows
    cpu_dense: np.ndarray      # [B, S, C] dense CPU-lane columns
    attr_bytes: Optional[np.ndarray]  # [B, S, NB, LB] uint8 (None: no DFA)
    byte_ovf: Optional[np.ndarray]    # [B, S, NB] bool
    shard_of: np.ndarray       # [B] the shard owning the request's config
    row_of: np.ndarray         # [B] its row within that shard
    host_fallback: np.ndarray  # [B] bool: exact re-decision on the host
    attrs_num: Optional[np.ndarray] = None   # [B, S, NN] int32
    num_valid: Optional[np.ndarray] = None   # [B, S, NN] bool
    rel_rows: Optional[np.ndarray] = None    # [B, S, NR] int32
    member_ovf: Optional[np.ndarray] = None  # [B, S, M] bool


_OPERANDS = ("attrs_val", "members_c", "cpu_dense", "attr_bytes", "byte_ovf",
             "attrs_num", "num_valid", "rel_rows", "member_ovf")


class ShardedPolicyModel:
    """Rule corpus partitioned over the mesh's ``mp`` axis, batch over
    ``dp``.

    Two-phase: the constructor compiles the shards and stacks every operand
    on the host (``host_view``); ``upload()`` stages each shard's slice on
    the devices of its mesh column (full, or a per-shard delta against a
    previous model).  ``defer_upload=True`` stops after the host phase so a
    strict-verify lint can gate the upload."""

    def __init__(self, configs: Sequence[ConfigRules], mesh: Mesh,
                 members_k: int = 16, interner: Optional[StringInterner] = None,
                 defer_upload: bool = False, grid_relief: bool = True,
                 breaker_threshold: int = 3, breaker_reset_s: float = 5.0,
                 ovf_assist: Optional[bool] = None,
                 kernel_lane: Optional[str] = None):
        self.mesh = mesh
        self.kernel_lane = mesh_lane(kernel_lane)
        S = mesh.shape["mp"]
        self.n_shards = S
        self.members_k = members_k  # the requested (single-corpus) K
        if grid_relief and S > 1:
            self.members_k_eff = min(members_k * S,
                                     max(members_k, MEMBERS_K_RELIEF_CAP))
        else:
            self.members_k_eff = members_k
        self.interner = interner if interner is not None else StringInterner()
        groups: List[List[ConfigRules]] = [[] for _ in range(S)]
        self.locator: Dict[str, Tuple[int, int]] = {}
        for i, cfg in enumerate(configs):
            shard = i % S
            self.locator[cfg.name] = (shard, len(groups[shard]))
            groups[shard].append(cfg)

        # two-pass compile: natural shapes, their union, the final compile
        # (one dfa_cache over both passes and every shard: each distinct
        # regex determinizes once)
        dfa_cache: Dict[str, Any] = {}
        k = self.members_k_eff
        first = [compile_corpus(g, members_k=k, interner=self.interner,
                                dfa_cache=dfa_cache, ovf_assist=ovf_assist)
                 for g in groups]
        targets = ShapeTargets.union([p.shape_targets() for p in first])
        self.shards: List[CompiledPolicy] = [
            compile_corpus(g, members_k=k, interner=self.interner,
                           targets=targets, dfa_cache=dfa_cache,
                           ovf_assist=ovf_assist)
            for g in groups]
        self.has_dfa = self.shards[0].n_byte_attrs > 0
        self.has_num = int(getattr(self.shards[0], "n_num_attrs", 0)) > 0
        self.has_rel = int(getattr(self.shards[0], "n_rel_slots", 0)) > 0
        self.has_ovf = bool(getattr(self.shards[0], "ovf_assist", False))
        self.configs_per_shard = self.shards[0].n_configs
        self.E = int(self.shards[0].eval_rule.shape[1])
        # [S, G] verdict-cache eligibility, indexed (shard_of, row_of)
        self.config_cacheable = np.stack(
            [p.config_cacheable for p in self.shards])
        # each shard's host tree, range-checked on the host (no tree reaches
        # a device without the checks), then stacked on a leading [S] axis:
        # the next reconcile diffs against it, failover stages from it
        lane_dev = mesh.device(0)
        per_shard = []
        for p in self.shards:
            tree = pe.to_device(p, device=lane_dev, host=True,
                                lane=self.kernel_lane)
            checked_view(tree)
            per_shard.append(tree)
        self.host_view = _stack_trees(per_shard)
        self.has_matmul = self.host_view.get("matmul") is not None
        self.params: Optional[List[Dict[str, Any]]] = None  # set by upload()
        self.upload_report: Optional[Dict[str, Any]] = None
        self.state = _mesh_state(mesh, threshold=breaker_threshold,
                                 reset_s=breaker_reset_s)
        self._device_params: Dict[str, List[Any]] = {}  # failover staging
        self._device_params_lock = threading.Lock()
        if not defer_upload:
            self.upload()

    # ---- staging ----------------------------------------------------------

    def upload(self, prev: "Optional[ShardedPolicyModel]" = None
               ) -> Dict[str, Any]:
        """Stage the stacked host operands: shard j's slice onto every
        distinct device of mesh column j.  With ``prev`` (an uploaded model
        on an equal mesh) a delta plan is computed between the stacked host
        views; the leading axis is the shard axis, so a shard whose slice
        no entry changed reuses ``prev``'s tensors and receives zero bytes.
        Returns the upload report (also ``self.upload_report``)."""
        from ..snapshots.diff import plan_delta
        from ..utils import metrics as metrics_mod

        S = self.n_shards
        plan = None
        if (prev is not None and prev.mesh == self.mesh
                and prev.params is not None and prev.host_view is not None):
            plan = plan_delta(prev.host_view, self.host_view,
                              rows_win_factor=1.0)
        per_shard = [0] * S
        # changed[name] = the shards whose slice of that leaf ships
        changed: Dict[str, Optional[set]] = {}
        if plan is None:
            total = 0
            for _, leaf in _leaf_names(self.host_view):
                if leaf is None:
                    continue
                total += _nbytes(leaf)
                for s in range(S):
                    per_shard[s] += _nbytes(leaf[s])
            report = {"mode": "full", "upload_bytes": total,
                      "full_bytes": total, "arrays_reused": 0,
                      "arrays_touched": []}
        else:
            by_name = {e.name: e for e in plan.entries}
            uploaded = 0
            for name, leaf in _leaf_names(self.host_view):
                if leaf is None:
                    continue
                e = by_name.get(name)
                if e is None or e.mode == "full":
                    uploaded += _nbytes(leaf)
                    for s in range(S):
                        per_shard[s] += _nbytes(leaf[s])
                elif e.mode == "reuse":
                    changed[name] = set()
                else:
                    # rows mode: the changed leading rows are the shards
                    # this reconcile rewrote
                    uploaded += int(e.upload_bytes)
                    rows = {int(s) for s in e.rows.tolist() if s < S}
                    for s in rows:
                        per_shard[s] += _nbytes(leaf[s])
                    changed[name] = rows
            report = dict(plan.to_json(), upload_bytes=uploaded)

        params: List[Dict[str, Any]] = []
        for j in range(S):
            on_dev: Dict[str, Any] = {}
            for dev in self._column_devices(j):
                key = str(dev)
                prev_tree = (prev.params[j].get(key)
                             if plan is not None else None)

                def leaf_for(name, leaf, j=j, dev=dev, prev_tree=prev_tree):
                    keep = changed.get(name)
                    if prev_tree is not None and keep is not None \
                            and j not in keep:
                        old = _leaf_at(prev_tree, name)
                        if old is not None:
                            return old
                    return _put(leaf[j], dev)

                on_dev[key] = _rebuild(self.host_view, leaf_for)
            params.append(on_dev)
        self.params = params
        report["per_shard_bytes"] = {str(s): int(b)
                                     for s, b in enumerate(per_shard)}
        for s, b in enumerate(per_shard):
            if b:
                metrics_mod.mesh_shard_upload_bytes.labels(str(s)).inc(b)
        self.upload_report = report
        return report

    def _column_devices(self, j: int) -> List[torch.device]:
        out: List[torch.device] = []
        for row in self.mesh.grid:
            if row[j] not in out:
                out.append(row[j])
        return out

    def cache_tokens(self, fingerprints: Dict[str, str]):
        """Per-shard per-row verdict-cache tokens: (the owning shard's
        encoding epoch, the config's source fingerprint), indexed
        [shard_of][row_of].  A config a reconcile did not touch keeps its
        token (same interner, same epoch), so its entries survive."""
        from ..snapshots.fingerprint import cache_tokens as _tokens

        return [_tokens(p, fingerprints) for p in self.shards]

    # ---- encode -----------------------------------------------------------

    def _dp_pad(self, B: int) -> int:
        dp = self.mesh.shape["dp"]
        return B + (dp - B % dp) % dp

    def encode(self, docs: Sequence[Any], config_names: Sequence[str],
               batch_pad: int = 0) -> _ShardedEncoded:
        from ..compiler.intern import EMPTY_ID, PAD
        from ..compiler.pack import pack_batch

        B = max(len(docs), 1)
        if batch_pad and batch_pad > B:
            B = batch_pad
        B = self._dp_pad(B)
        S = self.n_shards
        p0 = self.shards[0]
        A, K = p0.n_attrs, p0.members_k
        M, C = p0.n_member_attrs, p0.n_cpu_leaves
        attrs_val = np.full((B, S, A), EMPTY_ID, dtype=np.int32)
        members_c = np.full((B, S, M, K), PAD, dtype=np.int32)
        cpu_dense = np.zeros((B, S, C), dtype=bool)
        if self.has_dfa:
            from ..compiler.compile import DFA_VALUE_BYTES

            NB = p0.n_byte_attrs
            attr_bytes = np.zeros((B, S, NB, DFA_VALUE_BYTES), dtype=np.uint8)
            byte_ovf = np.zeros((B, S, NB), dtype=bool)
        else:
            attr_bytes = byte_ovf = None
        if self.has_num:
            NN = p0.n_num_attrs
            attrs_num = np.zeros((B, S, NN), dtype=np.int32)
            num_valid = np.zeros((B, S, NN), dtype=bool)
        else:
            attrs_num = num_valid = None
        rel_rows = (np.zeros((B, S, p0.n_rel_slots), dtype=np.int32)
                    if self.has_rel else None)
        member_ovf = (np.zeros((B, S, M), dtype=bool)
                      if self.has_ovf else None)
        shard_of = np.zeros((B,), dtype=np.int32)
        row_of = np.zeros((B,), dtype=np.int32)
        host_fallback = np.zeros((B,), dtype=bool)
        # group requests by owning shard and encode each group in one call
        by_shard: Dict[int, List[int]] = {}
        for r, (doc, name) in enumerate(zip(docs, config_names)):
            shard, row = self.locator[name]
            shard_of[r], row_of[r] = shard, row
            by_shard.setdefault(shard, []).append(r)
        for shard, rs in by_shard.items():
            enc = encode_batch(self.shards[shard], [docs[r] for r in rs],
                               [int(row_of[r]) for r in rs])
            db = pack_batch(self.shards[shard], enc, trim_bytes=False)
            attrs_val[rs, shard] = db.attrs_val[: len(rs)]
            members_c[rs, shard] = db.members_c[: len(rs)]
            cpu_dense[rs, shard] = db.cpu_dense[: len(rs)]
            if self.has_dfa:
                lb = db.attr_bytes.shape[-1]
                attr_bytes[rs, shard, :, :lb] = db.attr_bytes[: len(rs)]
                byte_ovf[rs, shard] = db.byte_ovf[: len(rs)]
            if self.has_num:
                attrs_num[rs, shard] = db.attrs_num[: len(rs)]
                num_valid[rs, shard] = db.num_valid[: len(rs)]
            if self.has_rel:
                rel_rows[rs, shard] = db.rel_rows[: len(rs)]
            if self.has_ovf:
                member_ovf[rs, shard] = db.member_ovf[: len(rs)]
            host_fallback[rs] = db.host_fallback[: len(rs)]
        if self.has_dfa:
            from ..compiler.pack import _trim_bytes

            attr_bytes = _trim_bytes(attr_bytes)
        return _ShardedEncoded(
            attrs_val, members_c, cpu_dense, attr_bytes, byte_ovf,
            shard_of, row_of, host_fallback,
            attrs_num=attrs_num, num_valid=num_valid,
            rel_rows=rel_rows, member_ovf=member_ovf)

    def row_keys(self, encoded: _ShardedEncoded, n: int):
        """Canonical per-row keys for dedup and the verdict cache: the
        operand bytes plus shard_of/row_of (config identity on the mesh)
        and the lossy-row flag."""
        from ..compiler.pack import row_key_bytes

        return row_key_bytes(
            [encoded.shard_of, encoded.row_of, encoded.attrs_val,
             encoded.members_c, encoded.cpu_dense, encoded.attr_bytes,
             encoded.byte_ovf, encoded.host_fallback, encoded.attrs_num,
             encoded.num_valid, encoded.rel_rows, encoded.member_ovf], n)

    def select_rows(self, encoded: _ShardedEncoded, rows: Sequence[int],
                    batch_pad: int = 0) -> _ShardedEncoded:
        """Row-subset view for dedup dispatch: the unique rows re-padded to
        ``batch_pad`` (dp-aligned like encode) by repeating the first row;
        the pad rows' verdicts are discarded by the inverse fan-out."""
        u = len(rows)
        B = self._dp_pad(max(u, 1, batch_pad))
        fill = rows[0] if u else 0
        idx = np.asarray(list(rows) + [fill] * (B - u))

        def take(a):
            return a[idx] if a is not None else None

        return _ShardedEncoded(
            take(encoded.attrs_val), take(encoded.members_c),
            take(encoded.cpu_dense), take(encoded.attr_bytes),
            take(encoded.byte_ovf), take(encoded.shard_of),
            take(encoded.row_of), take(encoded.host_fallback),
            attrs_num=take(encoded.attrs_num),
            num_valid=take(encoded.num_valid),
            rel_rows=take(encoded.rel_rows),
            member_ovf=take(encoded.member_ovf))

    # ---- the step ---------------------------------------------------------

    def _operand_arrays(self, encoded: _ShardedEncoded) -> Dict[str, Any]:
        ops = {}
        for name in _OPERANDS:
            a = getattr(encoded, name)
            if a is None or (name in ("attr_bytes", "byte_ovf")
                             and not self.has_dfa):
                continue
            ops[name] = a
        return ops

    @staticmethod
    def _stage(arrays: Dict[str, np.ndarray], device) -> Dict[str, Any]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                    device, non_blocking=False)
                for k, v in arrays.items()}

    def _block(self, tree, ops: Dict[str, Any], j: int, shard_of, row_of):
        """One block: dp slice ``ops`` (operands [B_l, S, ...]) against shard
        ``j``'s tree; the rows whose config shard j owns keep their own
        verdict, rule and skipped columns ([B_l, 1+2E] bool, the others
        all False)."""
        def sl(name):
            a = ops.get(name)
            return a[:, j] if a is not None else None

        verdict, (rule, skipped) = pe.eval_verdicts(
            tree, sl("attrs_val"), sl("members_c"), sl("cpu_dense"),
            sl("attr_bytes"), sl("byte_ovf"), sl("attrs_num"),
            sl("num_valid"), sl("rel_rows"), sl("member_ovf"))
        G = verdict.shape[1]
        mask = ((shard_of == j)[:, None]
                & (row_of[:, None] == torch.arange(
                    G, dtype=row_of.dtype, device=row_of.device)[None, :]))
        own = (verdict & mask).any(dim=1)
        own_rule = (rule & mask[:, :, None]).any(dim=1)
        own_skip = (skipped & mask[:, :, None]).any(dim=1)
        return torch.cat([own[:, None], own_rule, own_skip], dim=1)

    def _run_blocks(self, encoded: _ShardedEncoded, blocks, trees):
        """Evaluate ``blocks`` ([(slot, dp index, shard, device)]) and merge
        them into the bitpacked [B, W] uint8 readback on the first block's
        device; returns (packed, the stream the merge ran on)."""
        arrays = self._operand_arrays(encoded)
        arrays["shard_of"] = encoded.shard_of
        arrays["row_of"] = encoded.row_of
        B = int(encoded.attrs_val.shape[0])
        dp = self.mesh.shape["dp"]
        Bl = B // dp
        out_dev = blocks[0][3]
        staged: Dict[str, Dict[str, Any]] = {}
        single = len({str(b[3]) for b in blocks}) == 1
        if single:
            staged[str(out_dev)] = self._stage(arrays, out_dev)
        main = (torch.cuda.current_stream(out_dev)
                if out_dev.type == "cuda" else None)
        merged = torch.zeros((B, 1 + 2 * self.E), dtype=torch.bool,
                             device=out_dev)
        pending = []
        for slot, i, j, dev in blocks:
            lo, hi = i * Bl, (i + 1) * Bl
            if single:
                full = staged[str(dev)]
                ops = {k: v[lo:hi] for k, v in full.items()}
            else:
                ops = self._stage({k: v[lo:hi] for k, v in arrays.items()},
                                  dev)
            tree = trees(j, dev)
            if dev.type == "cuda":
                s = self.state.stream(slot, dev)
                s.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(s):
                    for v in ops.values():
                        v.record_stream(s)
                    out = self._block(tree, ops, j, ops.pop("shard_of"),
                                      ops.pop("row_of"))
                pending.append((lo, hi, out, s))
            else:
                out = self._block(tree, ops, j, ops.pop("shard_of"),
                                  ops.pop("row_of"))
                pending.append((lo, hi, out, None))
        for lo, hi, out, s in pending:
            if s is not None:
                main_s = (main if out.device == out_dev
                          else torch.cuda.current_stream(out.device))
                main_s.wait_stream(s)
                out.record_stream(main_s)
            merged[lo:hi] |= out.to(out_dev)
        return pe._bitpack_rows(merged), main

    def _shard_trees(self, j: int, dev) -> Any:
        return self.params[j][str(dev)]

    def _blocks_full(self):
        mp = self.mesh.shape["mp"]
        return [(slot, slot // mp, slot % mp, self.mesh.device(slot))
                for slot in self.mesh.device_ids]

    def dispatch_full(self, encoded: _ShardedEncoded) -> MegakernelHandle:
        """Non-blocking launch over every (dp, mp) block: the handle's [B, W]
        uint8 own-rows readback starts its D2H copy at once."""
        if self.params is None:
            raise RuntimeError(
                "ShardedPolicyModel not staged: call upload() after the "
                "deferred (strict-verify) construction")
        with self.state.launch_lock:
            packed, stream = self._run_blocks(
                encoded, self._blocks_full(), self._shard_trees)
            handle = MegakernelHandle(packed, stream, kernel=False)
        # one shard-step: the blocks and their merge are one launch of the
        # lane, however many blocks the mesh holds
        LEDGER.observe_launch("mesh", 1,
                              h2d_bytes=self._encoded_h2d_bytes(encoded),
                              d2h_bytes=self._d2h_bytes(encoded))
        return handle

    def _encoded_h2d_bytes(self, encoded: _ShardedEncoded) -> int:
        """Request-operand bytes one launch of ``encoded`` stages (every
        present operand and the shard_of/row_of routing rows)."""
        total = 0
        for name in _OPERANDS + ("shard_of", "row_of"):
            arr = getattr(encoded, name, None)
            if arr is not None:
                total += arr.nbytes
        return total

    def _d2h_bytes(self, encoded: _ShardedEncoded) -> int:
        """Readback bytes of one launch: the bitpacked [B, W] uint8."""
        return int(encoded.attrs_val.shape[0]) * packed_width(1 + 2 * self.E)

    # ---- per-device failover ----------------------------------------------

    def device_params(self, device_id: int) -> List[Any]:
        """The whole stacked corpus on the device of ``device_id``: the
        shards already staged there are reused, the others staged from the
        host view once and kept for the rest of the incident."""
        dev = self.mesh.device(device_id)
        key = str(dev)
        trees = self._device_params.get(key)
        if trees is None:
            with self._device_params_lock:
                trees = self._device_params.get(key)
                if trees is None:
                    trees = [
                        self.params[j].get(key)
                        if self.params[j].get(key) is not None
                        else _put(_slice_tree(self.host_view, j), dev)
                        for j in range(self.n_shards)]
                    self._device_params[key] = trees
        return trees

    def dispatch_on_device(self, encoded: _ShardedEncoded,
                           device_id: int) -> MegakernelHandle:
        """Single-device launch of one batch against the whole stacked
        corpus (every shard's block on that device, the whole batch as one
        dp slice): the failover lane when part of the mesh is down.  The
        same bitpacked own-rows readback as ``dispatch_full``."""
        dev = self.mesh.device(device_id)
        trees = self.device_params(device_id)
        dp = self.mesh.shape["dp"]
        # the whole batch on one device: every dp slice, every shard
        blocks = [(device_id, i, j, dev) for i in range(dp)
                  for j in range(self.n_shards)]
        with self.state.launch_lock:
            packed, stream = self._run_blocks(
                encoded, blocks, lambda j, _d: trees[j])
            handle = MegakernelHandle(packed, stream, kernel=False)
        # a failover re-dispatch is a real extra launch: the ledger shows it
        LEDGER.observe_launch("mesh", 1,
                              h2d_bytes=self._encoded_h2d_bytes(encoded),
                              d2h_bytes=self._d2h_bytes(encoded))
        return handle

    def dispatch_routed(self, encoded: _ShardedEncoded, lane: str = "engine"
                        ) -> Tuple[Any, MeshRoute]:
        """Breaker- and occupancy-aware launch (the engine's mesh entry):

        1. every device healthy: the full-mesh launch;
        2. a device fails its fault probe or launch: its breaker records
           the failure and the batch re-dispatches to the healthy device
           with the emptiest in-flight window;
        3. no device left: MeshUnavailable.

        Returns (the handle, the MeshRoute of the occupied windows); the
        caller releases it at terminal completion (``complete_route``)."""
        from ..runtime import faults
        from ..runtime.breaker import CLOSED

        state = self.state
        tried: set = set()
        full_mesh_eligible = state.breakers.all_closed()
        while True:
            if full_mesh_eligible:
                full_mesh_eligible = False
                try:
                    if faults.ACTIVE:
                        for d in state.device_ids:
                            faults.FAULTS.check("kernel", lane, device=d)
                    handle = self.dispatch_full(encoded)
                    return handle, state.acquire(list(state.device_ids))
                except MeshUnavailable:
                    raise
                except Exception as e:
                    dev = getattr(e, "device_id", None)
                    if dev is None:
                        raise  # unattributed: the engine's retry owns it
                    state.device_failed(int(dev), lane)
                    tried.add(int(dev))
                    log.warning(
                        "mesh device %d failed a full-mesh launch probe: "
                        "failing the batch over to a healthy device", dev)
                    continue
            cands = [d for d in state.breakers.candidates() if d not in tried]
            if not cands:
                raise MeshUnavailable(
                    f"no healthy mesh device left (excluded {sorted(tried)})")
            # due probes first (an open device past its cooldown recovers
            # only if some batch probes it), then the emptiest window
            with state.lock:
                cands.sort(key=lambda d: (
                    state.breakers.get(d).state == CLOSED,
                    state.occupancy.get(d, 0)))
            dev = cands[0]
            if not state.breakers.get(dev).admit_device():
                tried.add(dev)
                continue
            try:
                if faults.ACTIVE:
                    faults.FAULTS.check("kernel", lane, device=dev)
                handle = self.dispatch_on_device(encoded, dev)
                return handle, state.acquire([dev])
            except Exception:
                state.device_failed(dev, lane)
                tried.add(dev)
                continue

    def complete_route(self, route: Optional[MeshRoute], ok: bool,
                       lane: str = "engine") -> None:
        """Terminal accounting for one routed batch: the per-device breaker
        verdicts (a single-device route's failure is attributable, a
        full-mesh readback failure is not: the lane breaker owns those) and
        the idempotent occupancy release."""
        if route is None:
            return
        try:
            if ok:
                self.state.breakers.record_success(route.devices)
            elif len(route.devices) == 1:
                self.state.device_failed(route.devices[0], lane,
                                         failover=False)
        finally:
            route.release()

    def cost_feed(self) -> float:
        """Mesh-lane cost multiplier (>= 1.0): the device count over the
        healthy device count, rising as devices trip their breakers."""
        from ..runtime.breaker import CLOSED

        breakers = self.state.breakers.breakers
        total = len(breakers)
        if not total:
            return 1.0
        healthy = sum(1 for b in breakers.values() if b.state == CLOSED)
        return float(total) / float(max(1, healthy))

    def mesh_vars(self) -> Dict[str, Any]:
        """JSON-safe mesh-lane state for /debug/vars."""
        out = self.state.to_json()
        out.update({
            "dp": int(self.mesh.shape["dp"]),
            "mp": int(self.mesh.shape["mp"]),
            "slots": [str(self.mesh.device(d)) for d in self.mesh.device_ids],
            "lane": self.kernel_lane,
            "members_k": self.members_k,
            "members_k_eff": self.members_k_eff,
            "configs_per_shard": self.configs_per_shard,
            "upload": self.upload_report,
        })
        return out

    # ---- blocking entries ---------------------------------------------------

    def _run_step(self, encoded: _ShardedEncoded) -> np.ndarray:
        """Own-rows result [B, 1+2E] bool from the bitpacked readback."""
        return unpack_verdicts(np.asarray(self.dispatch_full(encoded)),
                               1 + 2 * self.E)

    def apply(self, encoded: _ShardedEncoded) -> np.ndarray:
        return self._run_step(encoded)[:, 0]

    def apply_full(self, encoded: _ShardedEncoded
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Own-config (verdict [B], rule results [B, E], skipped [B, E]):
        the single-corpus ``eval_full`` contract."""
        packed = self._run_step(encoded)
        E = self.E
        return (packed[:, 0], packed[:, 1:1 + E].copy(),
                packed[:, 1 + E:1 + 2 * E].copy())

    def host_decide(self, config_name: str, doc: Any
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact host-oracle decision for one request of this corpus:
        (rule_results [E], skipped [E]) with the kernel's padding
        semantics."""
        from ..models.policy_model import host_results

        shard, row = self.locator[config_name]
        return host_results(self.shards[shard], doc, int(row))[1:]

    def host_decide_many(self, config_names: Sequence[str],
                         docs: Sequence[Any]
                         ) -> List[Optional[Tuple[np.ndarray, np.ndarray]]]:
        """``host_decide`` per request, or None for a row whose oracle run
        failed (the caller answers it typed UNAVAILABLE)."""
        out: List[Optional[Tuple[np.ndarray, np.ndarray]]] = []
        for name, doc in zip(config_names, docs):
            try:
                out.append(self.host_decide(name, doc))
            except Exception:
                log.exception("host oracle failed for config %r", name)
                out.append(None)
        return out

    def apply_fallback(self, host_fallback: np.ndarray, docs: Sequence[Any],
                       config_names: Sequence[str], own_rule: np.ndarray,
                       own_skipped: np.ndarray,
                       max_fallback: Optional[int] = None) -> int:
        """Host-oracle completion of the membership-overflow rows, in place
        (at most ``max_fallback`` re-decide; past the cap, fail-closed
        deny).  Returns the number of fallback rows."""
        from ..models.policy_model import apply_host_fallback, host_results
        from ..utils import metrics as metrics_mod

        def decide(r: int):
            shard, row = self.locator[config_names[r]]
            return host_results(self.shards[shard], docs[r], int(row))[1:]

        fallback_rows = np.nonzero(host_fallback[: len(docs)])[0]
        metrics_mod.batch_host_fallback.labels("engine").observe(
            len(fallback_rows))
        apply_host_fallback(decide, fallback_rows, own_rule, own_skipped,
                            max_fallback)
        return len(fallback_rows)

    def finalize_full(self, packed, enc: _ShardedEncoded,
                      docs: Sequence[Any], config_names: Sequence[str],
                      max_fallback: Optional[int] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """The completion half of ``run_full``: the packed readback of
        ``dispatch_full(enc)`` plus the host-oracle fallback."""
        packed = np.asarray(packed)
        E = self.E
        if packed.dtype == np.uint8:
            packed = unpack_verdicts(packed, 1 + 2 * E)
        own_rule = packed[:, 1:1 + E].copy()
        own_skipped = packed[:, 1 + E:1 + 2 * E].copy()
        self.apply_fallback(enc.host_fallback, docs, config_names,
                            own_rule, own_skipped, max_fallback)
        return own_rule, own_skipped

    def run_full(self, docs: Sequence[Any], config_names: Sequence[str],
                 batch_pad: int = 0, max_fallback: Optional[int] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-request per-evaluator (rule_results [B, E], skipped [B, E]):
        encode, dispatch_full, finalize_full in one blocking call."""
        enc = self.encode(docs, config_names, batch_pad=batch_pad)
        return self.finalize_full(self.dispatch_full(enc), enc, docs,
                                  config_names, max_fallback=max_fallback)

    def decide(self, docs: Sequence[Any],
               config_names: Sequence[str]) -> List[bool]:
        from ..models.policy_model import host_results

        enc = self.encode(docs, config_names)
        own = self.apply(enc)
        out = [bool(b) for b in own[: len(docs)]]
        for r in np.nonzero(enc.host_fallback[: len(docs)])[0]:
            shard, row = self.locator[config_names[r]]
            out[r], _, _ = host_results(self.shards[shard], docs[r], int(row))
        return out
