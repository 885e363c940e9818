"""Transfer compaction: wide EncodedBatch → minimal device payload.

The device sits behind a host↔device link (PCIe) whose latency dominates the
hot path long before the device's arithmetic does.  The wide encoder output is built for
semantic clarity — [B, A, K] membership for every attr, a [B, L] CPU lane —
but the kernel can only ever *read*:

  - membership vectors of attrs with an incl/excl leaf  → [B, M, K], M ≤ A
  - CPU-lane booleans of true-CPU leaves (regex fallback, whole-tree
    oracle) and DFA leaves' byte-overflow columns        → [B, C], C ≪ L

Everything else is dead weight on the wire (the [B, L] lane alone is ~8KB per
request at 10k rules).  This module slices the payload down to what the
kernel reads (~0.25KB per request) and flags the rare requests the compact
form cannot represent — membership arrays with more than K elements, whose
exact incl/excl answer the reference computes over the full array
(ref: pkg/jsonexp/expressions.go:70-80) — for whole-request host fallback
via the expression oracle (models/policy_model.py host_decide)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .compile import CompiledPolicy
from .encode import EncodedBatch
from .intern import PAD

__all__ = ["DeviceBatch", "PackError", "pack_batch", "row_key_bytes",
           "dedup_rows", "batch_row_keys", "select_rows"]


class PackError(ValueError):
    """An operand exceeds its padded device grid.  Raised INSTEAD of the
    silent failure modes numpy would otherwise pick (int16 wire-dtype
    wraparound, broadcast errors deep inside slicing): the packer and the
    tensor lint (analysis/tensor_lint.py) must agree on what is invalid,
    and an invalid batch must fail loudly host-side — never ship wrong
    operand bytes to the kernel."""


@dataclass
class DeviceBatch:
    """What actually crosses the wire (plus host-side fallback flags).
    Id tensors travel as int16 whenever the corpus interner fits (< 32k
    distinct constants — virtually always): the ids are the bulk of the
    payload, and the kernel upcasts on device after the transfer."""

    attrs_val: np.ndarray      # [B, A] int16/int32 (wire dtype)
    members_c: np.ndarray      # [B, M, K] int16/int32 — compact membership
    cpu_dense: np.ndarray      # [B, C] bool — dense CPU-lane columns
    config_id: np.ndarray      # [B] int32
    attr_bytes: Optional[np.ndarray]  # [B, NB, LB] uint8 (None: no DFA lane)
    byte_ovf: Optional[np.ndarray]    # [B, NB] bool
    host_fallback: np.ndarray  # [B] bool — HOST-side only, never transferred
    # optional lanes (None when the corpus lacks them):
    attrs_num: Optional[np.ndarray] = None   # [B, NN] int32 numeric values
    num_valid: Optional[np.ndarray] = None   # [B, NN] bool
    rel_rows: Optional[np.ndarray] = None    # [B, NR] int32 entity rows
    member_ovf: Optional[np.ndarray] = None  # [B, M] bool (ovf_assist only)


def wire_dtype(policy: CompiledPolicy):
    """int16 when every id (incl. the UNSEEN/PAD sentinels) fits."""
    return np.int16 if len(policy.interner) < 32767 else np.int32


def _trim_bytes(attr_bytes: np.ndarray) -> np.ndarray:
    """Drop trailing all-zero byte columns, bucketed to powers of two (≥16)
    to bound jit variants.  Exact: NUL padding is identity in every DFA
    (compiler/redfa.py), so the final scan state — the only thing the
    kernel reads — is unchanged.  The byte tensor is the largest single
    wire item; typical values (URL paths, headers) use a fraction of the
    DFA_VALUE_BYTES budget."""
    from ..utils import bucket_pow2

    LB = attr_bytes.shape[-1]
    used = attr_bytes.any(axis=tuple(range(attr_bytes.ndim - 1)))  # [LB]
    max_used = int(np.nonzero(used)[0][-1]) + 1 if used.any() else 1
    eff = bucket_pow2(max_used)
    if eff >= LB:
        return attr_bytes
    return np.ascontiguousarray(attr_bytes[..., :eff])


def pack_batch(policy: CompiledPolicy, enc: EncodedBatch,
               trim_bytes: bool = True) -> DeviceBatch:
    """Cheap numpy slicing; no per-request Python work.  ``trim_bytes=False``
    skips the byte-column trim — the sharded model assembles per-shard
    batches into one tensor and trims once at the end instead."""
    B = enc.attrs_val.shape[0]
    M, C, K = policy.n_member_attrs, policy.n_cpu_leaves, policy.members_k
    dt = wire_dtype(policy)

    member_attrs = policy.member_attrs
    m_real = member_attrs.shape[0]
    c_real = policy.cpu_leaf_list.shape[0]
    if m_real > M:
        raise PackError(
            f"{m_real} member attrs exceed the padded grid M={M} "
            "(compile targets too small for this corpus)")
    if c_real > C:
        raise PackError(
            f"{c_real} CPU-lane leaves exceed the padded grid C={C}")
    if dt == np.int16:
        # the wire narrows ids to int16 when the interner fits; an id past
        # that range would silently WRAP on .astype — a wrong operand, not
        # an error.  O(B·A[, K]) max-scans, trivial next to the row-key
        # build the dedup stage already does per batch.
        lim = np.iinfo(np.int16).max
        if (enc.attrs_val.size and int(enc.attrs_val.max()) > lim) or (
                enc.attrs_members.size
                and int(enc.attrs_members.max()) > lim):
            raise PackError(
                f"encoded id exceeds the int16 wire dtype (> {lim}): "
                "interner/encoder disagree on the id range")
    if enc.attr_bytes is not None and policy.n_byte_attrs > 0 and \
            enc.attr_bytes.shape[1] < policy.n_byte_attrs:
        raise PackError(
            f"byte tensor carries {enc.attr_bytes.shape[1]} slots < "
            f"n_byte_attrs={policy.n_byte_attrs} DFA byte attrs")
    if M == m_real:
        members_c = np.ascontiguousarray(enc.attrs_members[:, member_attrs], dtype=dt)
    else:
        members_c = np.full((B, M, K), PAD, dtype=dt)
        members_c[:, :m_real] = enc.attrs_members[:, member_attrs]

    cpu_list = policy.cpu_leaf_list
    if C == c_real:
        cpu_dense = np.ascontiguousarray(enc.cpu_lane[:, cpu_list])
    else:
        cpu_dense = np.zeros((B, C), dtype=bool)
        cpu_dense[:, :c_real] = enc.cpu_lane[:, cpu_list]

    # membership overflow on an attr the kernel reads: without the assist
    # the compact form is lossy for this request → host oracle; WITH the
    # assist the exact per-leaf answers ride the dense columns
    # and the [B, M] overflow mask selects them in-kernel — no fallback
    assist = bool(getattr(policy, "ovf_assist", False))
    if assist:
        host_fallback = np.zeros((B,), dtype=bool)
        member_ovf = np.zeros((B, M), dtype=bool)
        member_ovf[:, :m_real] = enc.overflow[:, member_attrs]
    else:
        host_fallback = enc.overflow[:, member_attrs].any(axis=1)
        member_ovf = None

    has_dfa = policy.n_byte_attrs > 0
    return DeviceBatch(
        attrs_val=enc.attrs_val.astype(dt, copy=False),
        members_c=members_c,
        cpu_dense=cpu_dense,
        config_id=enc.config_id,
        attr_bytes=(_trim_bytes(enc.attr_bytes) if trim_bytes else enc.attr_bytes)
        if has_dfa else None,
        byte_ovf=enc.byte_ovf if has_dfa else None,
        host_fallback=host_fallback,
        attrs_num=enc.attrs_num,
        num_valid=enc.num_valid,
        rel_rows=enc.rel_rows,
        member_ovf=member_ovf,
    )


# ---------------------------------------------------------------------------
# batch row dedup: canonical row keys + within-batch collapse
# ---------------------------------------------------------------------------
#
# The kernel is a pure function of each request's encoded operand row, so
# two rows with identical operand bytes MUST produce identical verdicts —
# the device only needs to evaluate unique rows, and the completion stage
# fans verdicts back out through the inverse map.  The canonical key is the
# raw concatenated operand bytes (config_id + attrs + members + CPU lane +
# DFA bytes/overflow + the host_fallback flag): exact by construction, no
# hash-collision risk.  host_fallback rides the key because the compact
# encoding is LOSSY for overflow rows — without it, an overflow request
# could alias a non-overflow request with the same visible prefix.


def row_key_bytes(arrays: Sequence[Optional[np.ndarray]], n: int) -> List[bytes]:
    """Per-row canonical keys over the first ``n`` rows of each array
    (None entries skipped; every array's axis 0 is the row axis)."""
    parts = []
    for a in arrays:
        if a is None:
            continue
        c = np.ascontiguousarray(a[:n])
        parts.append(c.view(np.uint8).reshape(n, -1) if n else
                     c.view(np.uint8).reshape(0, 0))
    if not parts:
        return [b""] * n
    rows = np.concatenate(parts, axis=1) if len(parts) > 1 else parts[0]
    rows = np.ascontiguousarray(rows)
    width = rows.shape[1]
    if width == 0:
        return [b""] * n
    void_rows = rows.view(np.dtype((np.void, width))).ravel()
    return [v.tobytes() for v in void_rows]


def batch_row_keys(db: DeviceBatch, n: int) -> List[bytes]:
    """Canonical row keys for one DeviceBatch (dedup + verdict-cache keys)."""
    return row_key_bytes(
        [db.config_id, db.attrs_val, db.members_c, db.cpu_dense,
         db.attr_bytes, db.byte_ovf, db.host_fallback,
         db.attrs_num, db.num_valid, db.rel_rows, db.member_ovf], n)


def select_rows(db: DeviceBatch, rows: Sequence[int],
                batch_pad: int = 0) -> DeviceBatch:
    """Row-subset DeviceBatch for dedup dispatch: the unique rows re-padded
    to ``batch_pad`` by repeating the first row (padding verdicts are
    discarded by the inverse fan-out).  One definition of the subset
    contract, so a new DeviceBatch field can't be forgotten at one of the
    call sites."""
    u = len(rows)
    pad = max(batch_pad, u, 1)
    fill = rows[0] if u else 0
    idx = np.asarray(list(rows) + [fill] * (pad - u))

    def take(a):
        return a[idx] if a is not None else None

    return DeviceBatch(
        attrs_val=take(db.attrs_val), members_c=take(db.members_c),
        cpu_dense=take(db.cpu_dense), config_id=take(db.config_id),
        attr_bytes=take(db.attr_bytes), byte_ovf=take(db.byte_ovf),
        host_fallback=take(db.host_fallback),
        attrs_num=take(db.attrs_num), num_valid=take(db.num_valid),
        rel_rows=take(db.rel_rows), member_ovf=take(db.member_ovf))


def dedup_rows(keys: Sequence[bytes],
               rows: Sequence[int]) -> Tuple[List[int], np.ndarray]:
    """Collapse ``rows`` (original row indices) by their canonical keys:
    returns (unique_rows, inverse) with unique_rows[inverse[j]] the
    representative of rows[j].  First occurrence wins (order-stable, so
    all-unique batches come back in submission order)."""
    uniq_of_key: dict = {}
    unique_rows: List[int] = []
    inverse = np.empty(len(rows), dtype=np.int64)
    for j, r in enumerate(rows):
        k = keys[r]
        u = uniq_of_key.get(k)
        if u is None:
            u = uniq_of_key[k] = len(unique_rows)
            unique_rows.append(r)
        inverse[j] = u
    return unique_rows, inverse
