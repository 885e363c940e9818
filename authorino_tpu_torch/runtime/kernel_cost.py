"""Kernel cost observatory: the structural count of what every batch costs
the device, and a model of what the serving snapshot's kernel costs per
row.

Two planes:

1. **CostLedger** (the reference's, verbatim) — per-batch STRUCTURAL
   device-cost counters folded O(1) per micro-batch from every dispatch
   site: kernel launches (one per batch with a device row), H2D bytes (the
   fused staging buffer; snapshot uploads are not counted here), D2H bytes
   (the bitpacked ``[pad, W]`` readback), pad waste (padded − real rows),
   and the dedup/cache-avoided rows that never shipped.  The ledger is
   PROCESS-WIDE like /metrics: every engine in the process folds into the
   same lanes.  The port folds the ``engine`` lane, the ``native`` lane
   (the native gRPC frontend's slots: launches, rows, device, dedup and
   cache rows, H2D/D2H bytes) and, on a CPU engine's degrade, the
   ``host`` lane; ``mesh`` keeps the reference's name for item 13.

2. **CostModel** — per generation, at the snapshot swap, the modeled cost
   of the one entry point the port dispatches, the CUDA mega-kernel
   (``ops/csrc/fused_kernel.cu``).  The reference asks XLA
   (``lower().compile().cost_analysis()``); nothing answers that for a
   hand-written kernel, so this module reckons it from the snapshot's
   per-config program (``ops/operands.py::_own_program``) by the
   own-config rule the kernel follows: a row evaluates only its own
   config's leaves, circuit nodes and DFA rows, and reads only its own
   config's program.  Operations are INTEGER operations (the kernel does
   no floating point): a leaf costs one compare or lookup (``K`` for a
   membership leaf), a circuit node one operation per child that is not
   its padding, a DFA row ``LB`` table steps plus its accept lookup, an
   evaluator 3.  Bytes are each read once: the staging buffer but its
   ``cpu_dense`` block, the ``cpu_dense`` columns the row's own config
   reads, its config's program, the DFA image when a config reads a DFA
   row, and the ``[B, W]`` output.  The record keeps the reference's keys
   (``flops_per_row`` counts these integer operations).  A reconcile whose
   modeled per-row cost regresses ≥2× against the previous generation
   raises a ``cost-regression`` flight-recorder anomaly — ADVISORY, never
   rejects the swap.  Analyses are memoized by a fingerprint of the
   program's shapes AND bytes: the model reads the program's values (which
   config reaches what), so two corpora of one shape may differ.
"""

from __future__ import annotations

import hashlib
import logging
import threading
from typing import Any, Dict, List, Tuple

import numpy as np

from ..compiler.compile import OP_EXCL, OP_INCL
from ..utils import metrics as metrics_mod

log = logging.getLogger(__name__)

# modeled per-row cost must grow by this factor generation-over-generation
# to count as a regression (2x: a pad-bucket step or an added operand lane
# never doubles per-row cost by itself — a kernel-structure change does)
REGRESSION_FACTOR = 2.0

_FIELDS = (
    "batches", "launches", "zero_launch_batches", "rows", "device_rows",
    "h2d_bytes", "d2h_bytes", "pad_rows", "pad_waste_rows",
    "eff_slack_cols", "dedup_avoided_rows", "cache_avoided_rows",
)


class _LaneCost:
    __slots__ = _FIELDS

    def __init__(self) -> None:
        for f in _FIELDS:
            setattr(self, f, 0)

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {f: int(getattr(self, f)) for f in _FIELDS}
        if self.batches:
            d["launches_per_batch"] = round(self.launches / self.batches, 4)
        if self.device_rows:
            d["h2d_bytes_per_device_row"] = round(
                self.h2d_bytes / self.device_rows, 2)
        if self.pad_rows:
            d["d2h_bytes_per_pad_row"] = round(
                self.d2h_bytes / self.pad_rows, 2)
            d["pad_occupancy"] = round(self.device_rows / self.pad_rows, 4)
        return d


class CostLedger:
    """Process-wide structural device-cost counters, one fold per batch."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._lanes: Dict[str, _LaneCost] = {}

    def observe(self, lane: str, *, rows: int, device_rows: int = 0,
                launches: int = 0, h2d_bytes: int = 0, d2h_bytes: int = 0,
                pad_rows: int = 0, eff_slack_cols: int = 0,
                dedup_avoided_rows: int = 0,
                cache_avoided_rows: int = 0) -> None:
        """Fold one batch: ``rows`` real requests in the cut, of which
        ``device_rows`` actually shipped (``pad_rows`` after padding) in
        ``launches`` device calls.  A cut the cache answers whole folds
        with launches=0 and zero byte counts."""
        pad_waste = max(0, pad_rows - device_rows)
        with self._lock:
            lc = self._lanes.get(lane)
            if lc is None:
                lc = self._lanes[lane] = _LaneCost()
            lc.batches += 1
            lc.launches += launches
            if launches == 0 and device_rows == 0:
                lc.zero_launch_batches += 1
            lc.rows += rows
            lc.device_rows += device_rows
            lc.h2d_bytes += h2d_bytes
            lc.d2h_bytes += d2h_bytes
            lc.pad_rows += pad_rows
            lc.pad_waste_rows += pad_waste
            lc.eff_slack_cols += eff_slack_cols
            lc.dedup_avoided_rows += dedup_avoided_rows
            lc.cache_avoided_rows += cache_avoided_rows
        metrics_mod.observe_kernel_cost(
            lane, launches, h2d_bytes, d2h_bytes, pad_waste)

    def observe_launch(self, lane: str, launches: int = 1,
                       h2d_bytes: int = 0, d2h_bytes: int = 0) -> None:
        """Count device launches + bytes at the dispatch site WITHOUT
        folding a batch (the reference's mesh shard-step hook)."""
        with self._lock:
            lc = self._lanes.get(lane)
            if lc is None:
                lc = self._lanes[lane] = _LaneCost()
            lc.launches += launches
            lc.h2d_bytes += h2d_bytes
            lc.d2h_bytes += d2h_bytes
        metrics_mod.observe_kernel_cost(lane, launches, h2d_bytes,
                                        d2h_bytes, 0)

    def snapshot(self, lane: str) -> Dict[str, Any]:
        """One lane's raw counters (zeros if the lane never folded) —
        callers delta two snapshots around a dispatch to pin exact
        counts."""
        with self._lock:
            lc = self._lanes.get(lane)
            return lc.to_json() if lc is not None else _LaneCost().to_json()

    def to_json(self) -> Dict[str, Any]:
        with self._lock:
            return {lane: lc.to_json()
                    for lane, lc in sorted(self._lanes.items())}

    def reset_for_tests(self) -> None:
        with self._lock:
            self._lanes.clear()


LEDGER = CostLedger()


# ---------------------------------------------------------------------------
# The modeled plane: the mega-kernel's work by the own-config rule.
# ---------------------------------------------------------------------------

# the host copy of the program columns the model reads, per params tree
_PROGRAM_KEYS = ("cfg_off", "leaf_rec", "node_rec")


def _program(params) -> Dict[str, Any]:
    """The model's view of a params tree's kernel program, as host numpy:
    per-config CSR offsets (leaves, nodes, DFA rows, levels, children),
    each leaf's op code and CPU-lane column, each node's child count, the
    DFA image's size, E, and whether the corpus has the DFA lane."""
    kp = params["kernel"]
    host = {k: kp[k].cpu().numpy() if hasattr(kp[k], "cpu")
            else np.asarray(kp[k]) for k in _PROGRAM_KEYS}
    img = kp["dfa_image"]
    return {
        "off": host["cfg_off"].astype(np.int64),
        "leaf_op": host["leaf_rec"][:, 0].astype(np.int64),
        "leaf_cpu_col": host["leaf_rec"][:, 3].astype(np.int64),
        "n_kids": (host["node_rec"][:, 1].astype(np.int64) >> 1),
        "image_bytes": int(img.numel() if hasattr(img, "numel")
                           else img.size) if img is not None else 0,
        "E": int(params["eval_rule"].shape[1]),
        "has_dfa": params["dfa_tables"] is not None,
    }


def _per_config_sum(values: np.ndarray, off_col: np.ndarray) -> np.ndarray:
    """Σ of ``values`` over each config's CSR range ``off_col[g]:
    off_col[g + 1]``."""
    cum = np.concatenate([[0], np.cumsum(values, dtype=np.int64)])
    return cum[off_col[1:]] - cum[off_col[:-1]]


def config_ops(params, K: int, LB: int) -> np.ndarray:
    """Integer operations one request of each config needs, [G] int64: its
    leaves (``K`` for a membership leaf, else 1), one per non-padding
    child of each of its circuit nodes, ``LB + 1`` per DFA row it reads
    (``LB`` = the batch's byte width, 0 without the DFA lane), 3 per
    evaluator."""
    return _config_ops(_program(params), K, LB)


def _config_ops(pr, K: int, LB: int) -> np.ndarray:
    off = pr["off"]
    leaf_cost = np.where(np.isin(pr["leaf_op"], (OP_INCL, OP_EXCL)), K, 1)
    ops = (3 * pr["E"] + _per_config_sum(leaf_cost, off[:, 0])
           + _per_config_sum(pr["n_kids"], off[:, 1]))
    if LB and pr["has_dfa"]:
        ops = ops + np.diff(off[:, 2]) * (LB + 1)
    return ops.astype(np.int64)


def _config_program_bytes(pr) -> np.ndarray:
    """Bytes of each config's own program the kernel reads, [G] int64: its
    ``cfg_off`` row and evaluator words, 16 per leaf, node and DFA record,
    4 per child index and level end."""
    off = pr["off"]
    count = off[1:, :5] - off[:-1, :5]
    return (off.shape[1] * 4 + pr["E"] * 4
            + 16 * count[:, :3].sum(axis=1) + 4 * count[:, 3:5].sum(axis=1))


def _config_cpu_columns(pr) -> np.ndarray:
    """The ``cpu_dense`` columns each config's own leaves read, [G]."""
    return _per_config_sum((pr["leaf_cpu_col"] >= 0).astype(np.int64),
                           pr["off"][:, 0])


def batch_work(params, db) -> Tuple[int, int]:
    """(bytes the kernel must move, integer operations its rows need) for
    one DeviceBatch, by the own-config rule: the staging buffer but its
    ``cpu_dense`` block, the ``cpu_dense`` columns the rows' own configs
    read, the program of each config present in the batch (once), the DFA
    image when a present config reads a DFA row, the [B, W] output; and
    ``config_ops`` of each row's config.  A pad row with no config needs
    neither."""
    from ..ops.operands import packed_width, staged_h2d_bytes

    pr = _program(params)
    G = pr["off"].shape[0] - 1
    cid = np.asarray(db.config_id, dtype=np.int64)
    own = cid[(cid >= 0) & (cid < G)]
    present = np.unique(own)
    program = int(_config_program_bytes(pr)[present].sum())
    if pr["image_bytes"] and np.diff(pr["off"][:, 2])[present].any():
        program += pr["image_bytes"]
    staging = staged_h2d_bytes(db)
    if db.cpu_dense is not None:
        staging += (int(_config_cpu_columns(pr)[own].sum())
                    * db.cpu_dense.itemsize - db.cpu_dense.nbytes)
    out = db.attrs_val.shape[0] * packed_width(1 + 2 * pr["E"])
    has_dfa = pr["has_dfa"] and db.attr_bytes is not None
    ops = _config_ops(pr, db.members_c.shape[2],
                     db.attr_bytes.shape[2] if has_dfa else 0)
    return staging + program + out, int(ops[own].sum())


def _representative_batch(policy, pad: int):
    """A zero batch of ``pad`` rows at the corpus's operand shapes, the
    byte tensor trimmed as a live batch's is (the reference's throwaway
    zero operands): its staging bytes and byte width are the model's."""
    from ..compiler.encode import encode_batch_py
    from ..compiler.pack import pack_batch

    return pack_batch(policy, encode_batch_py(policy, [], [], batch_pad=pad))


def modeled_fused_cost(policy, params, pad: int = 16) -> Dict[str, Any]:
    """The mega-kernel's modeled cost at one batch shape: a batch of
    ``pad`` rows whose configs are spread uniformly over the corpus, each
    row bringing its own config's program (so per row: the mean config's
    operations and program, cpu columns, staging and output bytes; the DFA
    image amortized over the batch when any config reads a DFA row).
    {entry, pad, eff, flops, bytes_accessed, flops_per_row,
    bytes_per_row}; ``flops`` are integer operations."""
    from ..ops.operands import packed_width, staged_h2d_bytes

    pr = _program(params)
    db = _representative_batch(policy, pad)
    eff = (int(db.attr_bytes.shape[-1])
           if pr["has_dfa"] and db.attr_bytes is not None else 0)
    ops = _config_ops(pr, policy.members_k, eff)
    prog = _config_program_bytes(pr)
    cpu = _config_cpu_columns(pr)
    staging = staged_h2d_bytes(db)
    if db.cpu_dense is not None:
        staging -= db.cpu_dense.nbytes
        staging += pad * float(cpu.mean()) * db.cpu_dense.itemsize
    flops = pad * float(ops.mean())
    bytes_acc = (staging + pad * (float(prog.mean())
                                  + packed_width(1 + 2 * pr["E"])))
    if pr["image_bytes"] and np.diff(pr["off"][:, 2]).any():
        bytes_acc += pr["image_bytes"]
    return {
        "entry": "fused_kernel", "pad": pad, "eff": eff,
        "flops": flops, "bytes_accessed": float(bytes_acc),
        "flops_per_row": round(flops / pad, 2),
        "bytes_per_row": round(bytes_acc / pad, 2),
    }


# fingerprint -> modeled record; bounded (one entry per distinct program)
_ANALYSIS_MEMO: Dict[str, Dict[str, Any]] = {}
_MEMO_MAX = 64


def program_fingerprint(params, pad: int) -> str:
    """Digest of the program the model reads (its shapes and bytes) and of
    the corpus's operand shapes: equal exactly when the model's answer
    is."""
    h = hashlib.sha1(str(pad).encode())
    kp = params["kernel"]
    for k in _PROGRAM_KEYS:
        a = kp[k].cpu().numpy() if hasattr(kp[k], "cpu") else np.asarray(kp[k])
        h.update(f"{k}{a.shape}{a.dtype}".encode())
        h.update(np.ascontiguousarray(a).tobytes())
    for k in sorted(params):
        v = params[k]
        if hasattr(v, "shape"):
            h.update(f"{k}{tuple(v.shape)}{v.dtype}".encode())
    img = kp["dfa_image"]
    h.update(str(None if img is None else tuple(img.shape)).encode())
    return h.hexdigest()


def entry_points(policy=None) -> List[Dict[str, Any]]:
    """The kernel entry points a serving snapshot can dispatch through,
    with the operand lanes each one stages, as the JAX package lists them:
    the op-chain lanes' bitpacked readback (``pattern_eval.eval_bitpacked``,
    per-operand transfers) and its one-staging-buffer form
    (``eval_fused``, what ``dispatch_fused`` runs for the gather and
    matmul lanes), then the fused mega-kernel.  The last ``--kernel-lane
    auto`` resolution rides the mega-kernel's entry as a field
    (``kernel_lane_auto``).  The reference's ``sharded_step`` comes with
    ROADMAP queue 1 item 13."""
    if policy is None:
        return []
    ops = ["attrs_val", "members_c", "cpu_dense", "config_id"]
    if getattr(policy, "n_byte_attrs", 0):
        ops += ["attr_bytes", "byte_ovf"]      # device regex (DFA) lane
    if getattr(policy, "n_num_attrs", 0):
        ops += ["attrs_num", "num_valid"]      # numeric lane
    if getattr(policy, "rel_bits", None) is not None:
        ops += ["rel_rows"]                    # relation lane
    if getattr(policy, "ovf_assist", False):
        ops += ["member_ovf"]                  # membership-overflow assist
    out = [{
        "entry": "eval_bitpacked",
        "kind": "single-corpus bitpacked readback [pad, W] uint8 "
                "(gather/matmul op chain, one transfer per operand)",
        "operands": list(ops),
    }, {
        "entry": "eval_fused",
        "kind": "single fused H2D staging buffer (same compute as "
                "eval_bitpacked), the gather/matmul lanes' serving entry",
        "operands": list(ops),
    }, {
        "entry": "fused_kernel",
        "kind": "one-launch mega-kernel, CUDA C++ sm_90a "
                "(ops/csrc/fused_kernel.cu): every lane + circuit + "
                "in-kernel bitpack, one fused staging buffer in, "
                "[pad, W] uint8 out, armed by --kernel-lane fused/auto",
        "operands": list(ops),
    }]
    from ..ops.pattern_eval import last_auto_decision

    dec = last_auto_decision()
    if dec is not None:
        out[-1]["kernel_lane_auto"] = dec
    return out


class CostModel:
    """Per-component modeled-cost lineage: one record per snapshot
    generation, compared against the previous one at reconcile time."""

    HISTORY = 8

    def __init__(self, component: str) -> None:
        self.component = component
        self._lock = threading.Lock()
        self._history: List[Dict[str, Any]] = []

    # -- recording ------------------------------------------------------
    def analyze(self, generation: int, *, policy=None, params=None,
                pad: int = 16, recorder=None) -> Dict[str, Any]:
        """Model the serving snapshot's kernel cost and diff it against
        the previous generation.  Advisory end to end: any failure
        degrades to an empty record, never blocks the swap."""
        with self._lock:
            if self._history and \
                    self._history[-1]["generation"] == int(generation):
                return self._history[-1]
        entries: Dict[str, Dict[str, Any]] = {}
        try:
            entries = self._model_entries(policy=policy, params=params,
                                          pad=pad)
        except Exception:
            log.exception("kernel cost analysis failed (advisory)")
        rec: Dict[str, Any] = {"generation": int(generation),
                               "entries": entries, "regressions": []}
        with self._lock:
            prev = self._history[-1] if self._history else None
            if prev is not None:
                rec["regressions"] = self._diff(prev, rec)
            self._history.append(rec)
            del self._history[:-self.HISTORY]
        for name, e in entries.items():
            metrics_mod.kernel_modeled_flops_per_row.labels(name).set(
                e["flops_per_row"])
        if rec["regressions"] and recorder is not None:
            try:
                recorder.record(
                    "cost-regression", lane=self.component,
                    detail={"generation": int(generation),
                            "regressions": rec["regressions"]},
                    anomaly=True)
            except Exception:
                log.exception("cost-regression record failed")
        return rec

    @staticmethod
    def _model_entries(*, policy, params, pad: int) -> Dict[str, Dict[str, Any]]:
        if policy is None or params is None or params.get("kernel") is None:
            return {}  # the model is the mega-kernel's (the fused lane)
        key = program_fingerprint(params, pad)
        hit = _ANALYSIS_MEMO.get(key)
        if hit is None:
            hit = modeled_fused_cost(policy, params, pad)
            if len(_ANALYSIS_MEMO) >= _MEMO_MAX:
                _ANALYSIS_MEMO.pop(next(iter(_ANALYSIS_MEMO)))
            _ANALYSIS_MEMO[key] = hit
        return {"fused_kernel": dict(hit)}

    @staticmethod
    def _diff(prev: Dict[str, Any], cur: Dict[str, Any]) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for name, e in cur["entries"].items():
            pe = prev["entries"].get(name)
            if pe is None:
                continue
            for axis in ("flops_per_row", "bytes_per_row"):
                base, now = pe.get(axis, 0.0), e.get(axis, 0.0)
                if base > 0 and now >= REGRESSION_FACTOR * base:
                    out.append({
                        "entry": name, "axis": axis,
                        "previous": base, "current": now,
                        "ratio": round(now / base, 2),
                        "previous_generation": prev["generation"],
                    })
        return out

    # -- surfaces -------------------------------------------------------
    def to_json(self) -> Dict[str, Any]:
        with self._lock:
            cur = self._history[-1] if self._history else None
            regressed = [r for rec in self._history
                         for r in rec["regressions"]]
            return {
                "component": self.component,
                "generations_analyzed": len(self._history),
                "current": cur,
                "regressions_seen": len(regressed),
                "last_regression": regressed[-1] if regressed else None,
            }
