"""Tensor-IR lint: pure-host structural verification of a compiled snapshot.

Every transform between ``compile_corpus`` and the kernels (packing, dedup,
lane operand builds) preserves exactness only if the compiled artifacts obey
invariants the device code silently assumes — a ``dfa_table_of_row`` entry
past the table axis, a circuit child referencing a *later* buffer slot, or a
scatter map that is not an exact cover each produce silently wrong verdicts,
not crashes.  This module states those invariants once, as checks a host can
run in milliseconds, so a malformed snapshot is caught at reconcile time
(``--strict-verify``) or in CI, never as a wrong verdict under load.

Checks and their finding kinds (catalogue: docs/static_analysis.md):

  dfa-table-index    every dfa_table_of_row entry < n_dfa_tables (and >= 0)
  dfa-next-state     transition tables are [T, S, 256] with next-states < S
  circuit-order      And/Or children reference strictly earlier buffer slots
                     (acyclic + topologically ordered by construction)
  operand-range      eval tables / leaf attrs / slot maps inside their grids
  lane-contract      dtype + shape contracts of the gather, matmul and
                     fused lanes' operand trees (to_device host build)
                     and the fused lane's per-config program
  scatter-cover      a dedup plan's fan-out reproduces the batch exactly
  pack-grid          packed DeviceBatch axes match the policy's padded grid
  shard-stack        every mesh shard's padded grid matches shard 0's — the
                     stacked [S]-axis device pytree silently truncates or
                     misaligns operands if the ShapeTargets union missed an
                     axis (mesh lane)
  fused-perm         dfa_row_perm is a bijection over the DFA rows AND
                     groups rows by owning table (dfa_table_of_row composed
                     with the permutation is nondecreasing) — the fused
                     lane's contiguous-gather layout
  fused-int8         leaf_op_i8 round-trips leaf_op losslessly (all op
                     codes < 2^7; a lossy cast reroutes every affected leaf
                     through the wrong comparison)
  fused-pack-width   fused_pack_w == packed_width(1 + 2E) — the in-kernel
                     bitpack readback width the dispatchers decode against
"""

from __future__ import annotations

from typing import Any, List, Sequence

import numpy as np

from ..compiler.compile import (
    NUMERIC_OPS,
    OP_CPU,
    OP_EQ,
    OP_ERROR,
    OP_EXCL,
    OP_INCL,
    OP_NEQ,
    OP_REGEX_DFA,
    OP_RELATION,
    OP_TREE_CPU,
    CompiledPolicy,
)
from . import Finding

__all__ = ["tensor_lint", "lint_snapshot", "lint_scatter_plan",
           "lint_device_batch", "lint_sharded_stack"]

_LAYER = "tensor_lint"
_KNOWN_OPS = (OP_EQ, OP_NEQ, OP_INCL, OP_EXCL, OP_CPU, OP_ERROR,
              OP_TREE_CPU, OP_REGEX_DFA) + NUMERIC_OPS + (OP_RELATION,)


def _err(kind: str, message: str, location: str = "", **detail) -> Finding:
    return Finding(kind=kind, message=message, layer=_LAYER,
                   severity="error", location=location, detail=detail)


def _leaf_base() -> int:
    return 2  # TRUE_SLOT, FALSE_SLOT precede the leaf block


def _check_dfa(policy: CompiledPolicy, out: List[Finding]) -> None:
    tables = policy.dfa_tables
    if tables.ndim != 3 or tables.shape[2] != 256:
        out.append(_err(
            "dfa-next-state",
            f"transition tables must be [T, S, 256], got {tables.shape}",
            "dfa_tables"))
        return
    T, S = int(tables.shape[0]), int(tables.shape[1])
    # uint8 tables can't go negative, but the lint must not trust the
    # dtype it is auditing — a corrupt artifact may arrive signed
    if tables.size and (int(tables.min()) < 0 or int(tables.max()) >= S):
        bad = np.argwhere((tables < 0) | (tables >= S))[0]
        out.append(_err(
            "dfa-next-state",
            f"next-state {int(tables[tuple(bad)])} out of range [0, S={S}) "
            f"at table {int(bad[0])}, state {int(bad[1])}, byte {int(bad[2])}",
            "dfa_tables"))
    if policy.dfa_accept.shape != (T, S):
        out.append(_err(
            "dfa-next-state",
            f"accept mask shape {policy.dfa_accept.shape} != tables' ({T}, {S})",
            "dfa_accept"))
    rows = policy.dfa_table_of_row
    if rows.size and (int(rows.min()) < 0 or int(rows.max()) >= T):
        r = int(np.argmax((rows < 0) | (rows >= T)))
        out.append(_err(
            "dfa-table-index",
            f"dfa_table_of_row[{r}] = {int(rows[r])} outside [0, "
            f"n_dfa_tables={T})", "dfa_table_of_row"))
    R = int(rows.shape[0])
    ldr = policy.leaf_dfa_row
    if ldr.size and (int(ldr.min()) < 0 or int(ldr.max()) >= max(R, 1)):
        out.append(_err(
            "operand-range",
            f"leaf_dfa_row max {int(ldr.max())} outside [0, R={R})",
            "leaf_dfa_row"))
    A = policy.n_attrs
    dla = policy.dfa_leaf_attr
    if dla.size and (int(dla.min()) < 0 or int(dla.max()) >= A):
        out.append(_err(
            "operand-range",
            f"dfa_leaf_attr max {int(dla.max())} outside [0, A={A})",
            "dfa_leaf_attr"))
    abs_ = policy.attr_byte_slot
    if abs_.size and (int(abs_.min()) < -1
                      or int(abs_.max()) >= max(policy.n_byte_attrs, 1)):
        out.append(_err(
            "operand-range",
            f"attr_byte_slot outside [-1, n_byte_attrs="
            f"{policy.n_byte_attrs})", "attr_byte_slot"))


def _check_circuit(policy: CompiledPolicy, out: List[Finding]) -> None:
    """Children must reference strictly earlier buffer slots: the kernels
    evaluate level-by-level over a growing prefix, so a forward (or self)
    reference is either a cycle or a read of an undefined slot — both
    produce garbage verdicts, silently."""
    cursor = _leaf_base() + policy.n_leaves
    for l, (children, is_and) in enumerate(policy.levels):
        if children.ndim != 2 or is_and.shape != (children.shape[0],):
            out.append(_err(
                "circuit-order",
                f"level {l}: children {children.shape} / is_and "
                f"{is_and.shape} malformed", f"levels[{l}]"))
            return
        if children.size:
            lo, hi = int(children.min()), int(children.max())
            if lo < 0 or hi >= cursor:
                r, c = np.unravel_index(
                    int(np.argmax((children < 0) | (children >= cursor))),
                    children.shape)
                out.append(_err(
                    "circuit-order",
                    f"level {l} node {int(r)} child {int(c)} references "
                    f"buffer slot {int(children[r, c])}, but only slots "
                    f"[0, {cursor}) are defined at this level (forward "
                    f"reference = cycle or undefined read)",
                    f"levels[{l}]"))
        cursor += int(children.shape[0])
    # cursor is now buffer_size; eval tables must stay inside it
    if cursor != policy.buffer_size:
        out.append(_err(
            "operand-range",
            f"level rows sum to buffer size {cursor} != "
            f"policy.buffer_size {policy.buffer_size}", "levels"))


def _check_operands(policy: CompiledPolicy, out: List[Finding]) -> None:
    L, A, B = policy.n_leaves, policy.n_attrs, policy.buffer_size
    for name in ("eval_cond", "eval_rule"):
        t = getattr(policy, name)
        if t.shape != policy.eval_rule.shape:
            out.append(_err("operand-range",
                            f"{name} shape {t.shape} != eval_rule "
                            f"{policy.eval_rule.shape}", name))
            continue
        if t.size and (int(t.min()) < 0 or int(t.max()) >= B):
            g, e = np.unravel_index(
                int(np.argmax((t < 0) | (t >= B))), t.shape)
            out.append(_err(
                "operand-range",
                f"{name}[{int(g)}, {int(e)}] = {int(t[g, e])} outside the "
                f"padded result buffer [0, {B})", name))
    la = policy.leaf_attr
    if la.shape != (L,):
        out.append(_err("operand-range",
                        f"leaf_attr shape {la.shape} != [L={L}]", "leaf_attr"))
    elif la.size and (int(la.min()) < 0 or int(la.max()) >= A):
        out.append(_err(
            "operand-range",
            f"leaf_attr max {int(la.max())} outside [0, A={A})", "leaf_attr"))
    lo = policy.leaf_op
    if lo.size and not np.isin(lo, _KNOWN_OPS).all():
        i = int(np.argmax(~np.isin(lo, _KNOWN_OPS)))
        out.append(_err("operand-range",
                        f"leaf_op[{i}] = {int(lo[i])} is not a known op code",
                        "leaf_op"))
    mas = policy.member_attr_slot
    M = policy.n_member_attrs
    if mas.size and (int(mas.min()) < -1 or int(mas.max()) >= M):
        out.append(_err(
            "operand-range",
            f"member_attr_slot outside [-1, M={M})", "member_attr_slot"))
    ma = policy.member_attrs
    if ma.size and (int(ma.min()) < 0 or int(ma.max()) >= A):
        out.append(_err("operand-range",
                        f"member_attrs outside [0, A={A})", "member_attrs"))
    cll = policy.cpu_leaf_list
    if cll.size and (int(cll.min()) < 0 or int(cll.max()) >= L):
        out.append(_err("operand-range",
                        f"cpu_leaf_list outside [0, L={L})", "cpu_leaf_list"))
    if cll.shape[0] > policy.n_cpu_leaves:
        out.append(_err(
            "operand-range",
            f"{cll.shape[0]} CPU-lane leaves exceed the padded grid "
            f"C={policy.n_cpu_leaves}", "cpu_leaf_list"))
    if ma.shape[0] > M:
        out.append(_err(
            "operand-range",
            f"{ma.shape[0]} member attrs exceed the padded grid M={M}",
            "member_attrs"))
    # numeric lane
    NN = int(getattr(policy, "n_num_attrs", 0) or 0)
    nas = getattr(policy, "num_attr_slot", None)
    if nas is not None and nas.size and (
            int(nas.min()) < -1 or int(nas.max()) >= max(NN, 1)):
        out.append(_err(
            "operand-range",
            f"num_attr_slot outside [-1, NN={NN})", "num_attr_slot"))
    if np.isin(lo, NUMERIC_OPS).any() and NN == 0:
        out.append(_err(
            "operand-range",
            "numeric leaves present but n_num_attrs == 0 (no value lane)",
            "num_attr_slot"))
    # relation lane
    NR = int(getattr(policy, "n_rel_slots", 0) or 0)
    rb = getattr(policy, "rel_bits", None)
    has_rel_leaf = bool((lo == OP_RELATION).any()) if lo.size else False
    if has_rel_leaf and (NR == 0 or rb is None):
        out.append(_err(
            "operand-range",
            "relation leaves present but the relation lane is absent",
            "rel_bits"))
    if rb is not None:
        if rb.ndim != 2 or rb.dtype != np.uint8:
            out.append(_err(
                "operand-range",
                f"rel_bits must be a [Rp, W] uint8 bitmatrix, got "
                f"{rb.dtype} {rb.shape}", "rel_bits"))
        elif rb.shape[0] and rb[0].any():
            out.append(_err(
                "operand-range",
                "rel_bits row 0 (the reserved unknown-entity row) has set "
                "bits: unknown principals would gain memberships",
                "rel_bits"))
        lrs = getattr(policy, "leaf_rel_slot", None)
        if lrs is not None and lrs.size and (
                int(lrs.min()) < 0 or int(lrs.max()) >= max(NR, 1)):
            out.append(_err(
                "operand-range",
                f"leaf_rel_slot outside [0, NR={NR})", "leaf_rel_slot"))
        lrc = getattr(policy, "leaf_rel_col", None)
        if lrc is not None and rb.ndim == 2 and lrc.size and (
                int(lrc.min()) < 0 or int(lrc.max()) >= rb.shape[1] * 8):
            out.append(_err(
                "operand-range",
                f"leaf_rel_col outside the bitmatrix width "
                f"[0, {rb.shape[1] * 8})", "leaf_rel_col"))


_INT_DTYPES = (np.int32, np.int64)


def _check_fused_layout(policy: CompiledPolicy, out: List[Finding]) -> None:
    """Packed-layout invariants, audited against their SOURCES
    (the fused fields are stored on the policy, so a corrupted layout is a
    real miscompile, not a stale cache)."""
    from ..ops.operands import packed_width

    perm = getattr(policy, "dfa_row_perm", None)
    if policy.dfa_table_of_row is not None:
        R = int(policy.dfa_table_of_row.shape[0])
        if perm is None or perm.shape != (R,) or \
                not np.array_equal(np.sort(np.asarray(perm)), np.arange(R)):
            out.append(_err(
                "fused-perm",
                f"dfa_row_perm must be a bijection over [0, R={R}) "
                f"(got {None if perm is None else perm.tolist()[:8]}...)",
                "dfa_row_perm"))
        else:
            # grouping is only meaningful over a VALID table map: when
            # dfa_table_of_row itself is out of range, dfa-table-index owns
            # the finding — re-reporting it here as fused-perm would blame
            # the (correct) permutation for the corrupted source.
            rows = np.asarray(policy.dfa_table_of_row)
            T = int(policy.dfa_tables.shape[0]) \
                if policy.dfa_tables is not None else 0
            rows_valid = (not rows.size) or \
                (int(rows.min()) >= 0 and int(rows.max()) < T)
            grouped = rows[np.asarray(perm)]
            if rows_valid and grouped.size and np.any(np.diff(grouped) < 0):
                out.append(_err(
                    "fused-perm",
                    "dfa_row_perm does not group rows by owning table "
                    "(dfa_table_of_row[perm] is not nondecreasing)",
                    "dfa_row_perm"))
    i8 = getattr(policy, "leaf_op_i8", None)
    if policy.leaf_op is not None:
        if i8 is None or i8.dtype != np.int8 or \
                not np.array_equal(i8.astype(np.int64),
                                   policy.leaf_op.astype(np.int64)):
            out.append(_err(
                "fused-int8",
                "leaf_op_i8 is not a lossless int8 image of leaf_op",
                "leaf_op_i8"))
    if policy.eval_rule is not None:
        E = int(policy.eval_rule.shape[1])
        want = packed_width(1 + 2 * E)
        if int(getattr(policy, "fused_pack_w", 0)) != want:
            out.append(_err(
                "fused-pack-width",
                f"fused_pack_w {getattr(policy, 'fused_pack_w', 0)} != "
                f"packed_width(1+2E) = {want}", "fused_pack_w"))


def _check_lanes(policy: CompiledPolicy, out: List[Finding]) -> None:
    """Dtype/shape contracts of the device operand trees of all three
    lanes (host build, ``to_device(host=True)``: no device, no transfer);
    for the fused lane, the one the CUDA mega-kernel reads, then its
    per-config program: ``host_view``'s range checks and ``_own_program``
    (ops/operands.py), which the kernel reads without bounds checks."""
    from ..ops.pattern_eval import _F32_EXACT, to_device

    L, A, B = policy.n_leaves, policy.n_attrs, policy.buffer_size
    G, E = policy.eval_rule.shape
    for lane in ("gather", "matmul", "fused"):
        try:
            params = to_device(policy, host=True, lane=lane)
        except Exception as e:
            out.append(_err("lane-contract",
                            f"{lane} lane operand build failed: {e!r}",
                            f"to_device[{lane}]"))
            continue
        loc = f"params[{lane}]"
        if params["leaf_op"].dtype not in _INT_DTYPES or \
                params["leaf_op"].shape != (L,):
            out.append(_err("lane-contract",
                            f"leaf_op must be int32 [L={L}], got "
                            f"{params['leaf_op'].dtype} "
                            f"{params['leaf_op'].shape}", loc))
        csi = params["cpu_scatter_idx"]
        # padding columns target the dump slot at L (sliced off on device);
        # anything past it clobbers memory the kernel never wrote
        if csi.size and (int(csi.min()) < 0 or int(csi.max()) > L):
            out.append(_err("lane-contract",
                            f"cpu_scatter_idx outside [0, L={L}]", loc))
        msl = params["member_slot_of_leaf"]
        if msl.shape != (L,) or (msl.size and (
                int(msl.min()) < 0
                or int(msl.max()) >= policy.n_member_attrs)):
            out.append(_err("lane-contract",
                            f"member_slot_of_leaf must index [0, M="
                            f"{policy.n_member_attrs}) over [L={L}]", loc))
        if lane == "fused":
            _check_fused_lane(policy, params, loc, out)
            continue
        mm = params.get("matmul")
        if lane == "matmul" and mm is None:
            # large interners legitimately force the gather lane; only a
            # silent None on a small corpus is a contract break
            if len(policy.interner) + 4 < _F32_EXACT:
                out.append(_err("lane-contract",
                                "matmul lane requested but operands missing",
                                loc))
            continue
        if mm is None:
            continue
        expect = {
            "attr_onehot": (A, L),
            "memb_onehot": (policy.n_member_attrs, L),
            "cpu_oh": (policy.n_cpu_leaves, L),
            "rule_m": (G * E, B),
            "cond_m": (G * E, B),
        }
        for name, shape in expect.items():
            if tuple(mm[name].shape) != shape:
                out.append(_err(
                    "lane-contract",
                    f"matmul operand {name} shape {tuple(mm[name].shape)} "
                    f"!= {shape}", loc))
        # selection matrices must be exact one-hots: a doubled or missing
        # entry silently selects the wrong operand (or none)
        for name, axis in (("attr_onehot", 0), ("rule_m", 1), ("cond_m", 1)):
            sums = _float64(mm[name]).sum(axis=axis)
            if sums.size and not np.allclose(sums, 1.0):
                out.append(_err(
                    "lane-contract",
                    f"matmul operand {name} is not an exact one-hot "
                    f"(per-{'column' if axis == 0 else 'row'} sum != 1)",
                    loc))
        cursor = _leaf_base() + L
        for l, m in enumerate(mm["level_mats"]):
            rows = int(policy.levels[l][0].shape[0])
            if tuple(m.shape) != (rows, cursor):
                out.append(_err(
                    "lane-contract",
                    f"level_mats[{l}] shape {tuple(m.shape)} != ({rows}, "
                    f"{cursor}) (count matrix must cover exactly the buffer "
                    f"prefix visible to its level)", loc))
            cursor += rows
        if policy.n_byte_attrs:
            R = int(policy.dfa_table_of_row.shape[0])
            S = int(policy.dfa_tables.shape[1])
            if tuple(mm["dfa_tables_f"].shape) != (R, S, 256):
                out.append(_err(
                    "lane-contract",
                    f"dfa_tables_f shape {tuple(mm['dfa_tables_f'].shape)} "
                    f"!= ({R}, {S}, 256) (matmul lane expands per-row)",
                    loc))


def _float64(m) -> np.ndarray:
    """A matmul-lane matrix as float64 numpy (a bf16 host matrix is a CPU
    tensor: numpy has no bf16)."""
    if hasattr(m, "double"):
        return m.double().numpy()
    return np.asarray(m, dtype=np.float64)


def _check_fused_lane(policy: CompiledPolicy, params, loc: str,
                      out: List[Finding]) -> None:
    """The fused lane's own operands, then its per-config program."""
    from ..ops.operands import host_view

    L = policy.n_leaves
    fz = params.get("fused")
    if fz is None:
        out.append(_err("lane-contract",
                        "fused lane requested but operands missing", loc))
        return
    i8 = fz.get("leaf_op_i8")
    if i8 is None or i8.dtype != np.int8 or i8.shape != (L,):
        out.append(_err(
            "lane-contract",
            f"leaf_op_i8 must be int8 [L={L}], got "
            f"{None if i8 is None else (i8.dtype, i8.shape)}", loc))
    if policy.n_byte_attrs:
        R = int(policy.dfa_table_of_row.shape[0])
        for name, n in (("dfa_table_of_row_g", R),
                        ("dfa_byte_slot_g", R),
                        ("leaf_dfa_pos", L)):
            a = fz.get(name)
            if a is None or a.shape != (n,) or \
                    a.dtype not in _INT_DTYPES:
                out.append(_err(
                    "lane-contract",
                    f"fused operand {name} must be int32 [{n}], "
                    f"got {None if a is None else (a.dtype, a.shape)}",
                    loc))
    if out:
        return
    # the per-config program: built from indices checked above, so a
    # failure here is the program's own (a local index past 16 bits, two
    # CPU columns on one leaf), not a re-report of a base-layout finding
    try:
        host_view(params)
    except Exception as e:
        out.append(_err("lane-contract",
                        f"own-config program build failed: {e}",
                        f"{loc}.kernel"))


def lint_scatter_plan(keys: Sequence[bytes], rows: Sequence[int],
                      unique_rows: Sequence[int],
                      inverse: np.ndarray) -> List[Finding]:
    """Verify a dedup plan (compiler/pack.py dedup_rows output) is an exact
    cover: fanning the unique rows' verdicts back out through ``inverse``
    must reproduce every original row's verdict.  Exact because the kernel
    is a pure per-row function of the canonical key bytes — so cover ≡
    key equality, checkable without evaluating anything."""
    out: List[Finding] = []
    inv = np.asarray(inverse)
    if inv.shape != (len(rows),):
        out.append(_err("scatter-cover",
                        f"inverse length {inv.shape} != rows {len(rows)}",
                        "dedup_rows"))
        return out
    u = len(unique_rows)
    if inv.size and (int(inv.min()) < 0 or int(inv.max()) >= u):
        out.append(_err("scatter-cover",
                        f"inverse references unique slot {int(inv.max())} "
                        f"outside [0, {u})", "dedup_rows"))
        return out
    seen = set()
    for i, ur in enumerate(unique_rows):
        k = keys[ur]
        if k in seen:
            out.append(_err("scatter-cover",
                            f"unique_rows[{i}] duplicates an earlier key "
                            "(the collapse is not minimal, so the plan "
                            "disagrees with the cache keying)",
                            "dedup_rows"))
            return out
        seen.add(k)
    for j, r in enumerate(rows):
        if keys[unique_rows[int(inv[j])]] != keys[r]:
            out.append(_err(
                "scatter-cover",
                f"row {r} fans out from unique row "
                f"{unique_rows[int(inv[j])]} whose key differs — the "
                "scatter map is not a cover (verdict would be wrong)",
                "dedup_rows"))
            return out
    return out


def lint_device_batch(policy: CompiledPolicy, db: Any) -> List[Finding]:
    """Packed-artifact check: one DeviceBatch's axes against the policy's
    padded grid (compiler/pack.py pack_batch contract)."""
    out: List[Finding] = []
    B = int(db.attrs_val.shape[0])
    grid = {
        "attrs_val": (B, policy.n_attrs),
        "members_c": (B, policy.n_member_attrs, policy.members_k),
        "cpu_dense": (B, policy.n_cpu_leaves),
        "config_id": (B,),
        "host_fallback": (B,),
    }
    for name, shape in grid.items():
        arr = getattr(db, name)
        if arr.shape != shape:
            out.append(_err("pack-grid",
                            f"{name} shape {arr.shape} != padded grid "
                            f"{shape}", name))
    cid = np.asarray(db.config_id)
    G = policy.n_configs
    if cid.size and (int(cid.min()) < 0 or int(cid.max()) >= G):
        out.append(_err("pack-grid",
                        f"config_id outside [0, G={G})", "config_id"))
    if db.attr_bytes is not None:
        NB = max(policy.n_byte_attrs, 1)
        if db.attr_bytes.shape[0] != B or db.attr_bytes.shape[1] != NB:
            out.append(_err("pack-grid",
                            f"attr_bytes shape {db.attr_bytes.shape} != "
                            f"[B={B}, NB={NB}, ...]", "attr_bytes"))
    NN = int(getattr(policy, "n_num_attrs", 0) or 0)
    for name, want in (
        ("attrs_num", (B, NN)),
        ("num_valid", (B, NN)),
        ("rel_rows", (B, int(getattr(policy, "n_rel_slots", 0) or 0))),
        ("member_ovf", (B, policy.n_member_attrs)),
    ):
        arr = getattr(db, name, None)
        if arr is not None and arr.shape != want:
            out.append(_err("pack-grid",
                            f"{name} shape {arr.shape} != padded grid "
                            f"{want}", name))
    rr = getattr(db, "rel_rows", None)
    rb = getattr(policy, "rel_bits", None)
    if rr is not None and rb is not None and rr.size and (
            int(rr.min()) < 0 or int(rr.max()) >= rb.shape[0]):
        out.append(_err("pack-grid",
                        f"rel_rows outside the bitmatrix row axis "
                        f"[0, {rb.shape[0]})", "rel_rows"))
    return out


def tensor_lint(policy: CompiledPolicy,
                check_lanes: bool = True) -> List[Finding]:
    """All structural checks over one compiled corpus.  Pure host, no
    device contact; ~ms even at 1k configs."""
    out: List[Finding] = []
    _check_operands(policy, out)
    _check_circuit(policy, out)
    _check_dfa(policy, out)
    _check_fused_layout(policy, out)
    if check_lanes and not out:
        # lane builds index through the arrays checked above; skip when the
        # base layout is already broken (they would raise, not report)
        _check_lanes(policy, out)
    return out


def _shard_grid_sig(p: CompiledPolicy) -> tuple:
    """The padded-grid signature every mesh shard must share for the
    stacked [S]-axis pytree to be well-formed (one np.stack per leaf)."""
    return (
        p.n_attrs, p.n_leaves, p.n_member_attrs, p.members_k,
        p.n_cpu_leaves, p.n_byte_attrs, p.buffer_size,
        tuple(p.eval_rule.shape),
        tuple((tuple(children.shape), int(is_and.shape[0]))
              for children, is_and in p.levels),
        int(getattr(p, "n_num_attrs", 0) or 0),
        int(getattr(p, "n_rel_slots", 0) or 0),
        tuple(p.rel_bits.shape) if getattr(p, "rel_bits", None) is not None
        else (),
        bool(getattr(p, "ovf_assist", False)),
    )


def lint_sharded_stack(sharded: Any) -> List[Finding]:
    """Mesh stacking invariant: every shard compiled against the
    same ShapeTargets union, so every operand's padded grid is identical
    across shards — a mismatched shard would make the [S]-axis stack (and
    with it every launch) silently wrong or impossible.  Host-only, runs
    BEFORE the upload on the strict-verify path."""
    out: List[Finding] = []
    shards = list(getattr(sharded, "shards", ()))
    if len(shards) < 2:
        return out
    ref = _shard_grid_sig(shards[0])
    for i, p in enumerate(shards[1:], 1):
        sig = _shard_grid_sig(p)
        if sig != ref:
            out.append(_err(
                "shard-stack",
                f"shard {i} padded grid {sig} != shard 0 {ref} — the "
                "ShapeTargets union did not cover every axis; the stacked "
                "device pytree would misalign",
                f"shard[{i}]"))
    return out


def lint_snapshot(snap: Any, check_lanes: bool = True) -> List[Finding]:
    """Lint an engine snapshot: the single compiled corpus, or every shard
    of a mesh-sharded one (runtime/engine.py _Snapshot duck type) plus the
    cross-shard stacking invariant."""
    policy = getattr(snap, "policy", None)
    sharded = getattr(snap, "sharded", None)
    if policy is None and sharded is None and isinstance(
            snap, CompiledPolicy):
        policy = snap
    out: List[Finding] = []
    if policy is not None:
        out += tensor_lint(policy, check_lanes=check_lanes)
    if sharded is not None:
        for i, shard in enumerate(getattr(sharded, "shards", ())):
            for f in tensor_lint(shard, check_lanes=check_lanes):
                f.location = f"shard[{i}].{f.location}" if f.location \
                    else f"shard[{i}]"
                out.append(f)
        out += lint_sharded_stack(sharded)
    return out
