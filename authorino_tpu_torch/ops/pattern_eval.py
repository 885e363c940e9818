"""Batched policy evaluation on the op-chain lanes, and the lane router.

One call evaluates a micro-batch of requests against the whole compiled
rule corpus and returns per-request, per-config allow verdicts.  Three
lanes compute the same function:

  - ``fused``: the hand-written CUDA mega-kernel (``fused_kernel``), one
    launch per batch; on the CPU its plain PyTorch version;
  - ``matmul``: every gather reformulated as a one-hot product, as the
    JAX package's default lane off a TPU.  Exactness does not rest on the
    process-wide matmul precision switches:
      * leaf operand selection (ids up to 2^24 through a 0/1 one-hot) runs
        in float64, which no TF32 setting touches, so each selected id
        comes back bit-exact;
      * every other product (circuit counts, rule/cond extraction, the CPU
        lane spread, the relation and overflow spreads) takes a 0/1 left
        operand and a matrix stored in bf16 only where bf16 holds its
        every value (0/1, bytes <= 255, child counts <= 256).  A level
        matrix with a larger count (the compiler pads each And row to the
        level's widest node with TRUE, all counted in one column: a
        5-child And beside a 300-child node counts 295 there, which bf16
        would round to 296 and so read an And with one false child as
        true) stays float32 (``_exact_dtype``).  A bf16 matrix multiplies
        in float32 (its values are exact in TF32's 11 significant bits,
        the sums exact below 2^24), a float32 one in float64 (TF32 would
        round a count above 2^11): never a bf16 or TF32-rounded result;
      * the regex-DFA byte scan keeps the byte-one-hot x transition-table
        step: next states <= 255 and each sum picks one term;
  - ``gather``: direct indexing, the semantic reference of the other two
    and the fallback when the interner outgrows exact float32 ids.

``to_device`` builds the operand tree of one lane (the ``matmul`` or
``fused`` subtree, or neither), and ``eval_verdicts`` branches on their
presence.  ``dispatch_fused`` is the serving entry: it counts the batch on
``auth_server_kernel_lane_total`` and returns a handle whose [B, W] uint8
readback is byte-equal across the lanes.

Lane resolution: ``lane=`` wins, else ``AUTHORINO_TPU_KERNEL_LANE``
(``--kernel-lane``), else ``auto``.  ``auto`` arms ``fused`` when every
device the operands can land on is a CUDA device or the CPU (where the
plain version answers), and otherwise takes ``AUTHORINO_TPU_EVAL_LANE``
(default ``matmul``).

Membership overflow (arrays longer than K) and DFA byte overflow cannot be
answered from the compact payload per leaf; overflowed requests are
flagged ``host_fallback`` by ``pack_batch`` and re-decided on the host
(models/policy_model.py) — the lanes' result for those rows is ignored.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..compiler.compile import (
    NUMERIC_OPS, OP_CPU, OP_EQ, OP_EXCL, OP_INCL, OP_NEQ, OP_NUM_GE,
    OP_NUM_GT, OP_NUM_LT, OP_REGEX_DFA, OP_RELATION, OP_TREE_CPU,
    CompiledPolicy)
from .operands import (check_batch, defuse, firing_columns, fuse_batch,
                       host_operands, packed_width, params_from_numpy,
                       staged_h2d_bytes, unpack_attribution, unpack_verdicts)

__all__ = ["DevicePolicy", "to_device", "eval_verdicts", "eval_batch",
           "forward", "eval_full", "eval_packed", "eval_bitpacked",
           "eval_fused", "dispatch_packed", "dispatch_lane",
           "dispatch_fused", "fuse_batch", "unpack_verdicts",
           "packed_width", "firing_columns",
           "unpack_attribution", "staged_h2d_bytes", "kernel_lane_of",
           "auto_lane", "last_auto_decision", "LANES"]

LANES = ("fused", "gather", "matmul")

# exact integer range of float32 accumulation: larger interners take the
# gather lane
_F32_EXACT = 1 << 24


def _eval_lane() -> str:
    return os.environ.get("AUTHORINO_TPU_EVAL_LANE", "matmul")


def _kernel_lane() -> str:
    """Env mirror of ``--kernel-lane``: ``fused`` arms the mega-kernel,
    ``gather``/``matmul`` force those lanes, ``auto`` (default) resolves
    through ``auto_lane``."""
    return os.environ.get("AUTHORINO_TPU_KERNEL_LANE", "auto")


# the last ``--kernel-lane auto`` resolution: what got armed, over which
# device platforms (surfaced in kernel_cost.entry_points)
_AUTO_DECISION: dict = {}


def _visible_devices():
    """Every device an upload without an explicit target can land on: the
    CUDA cards, or the CPU when none is visible."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return ([torch.device("cuda", i) for i in range(n)]
            or [torch.device("cpu")])


def auto_lane(device=None) -> str:
    """Resolve ``--kernel-lane auto`` for one operand upload: ``fused`` iff
    every device the operands can land on is a CUDA card or the CPU.  The
    consulted set is the explicit target device when one is given, else
    every visible device."""
    devices = ([torch.device(device)] if device is not None
               else list(_visible_devices()))
    platforms = sorted({str(getattr(d, "type", "unknown")) for d in devices})
    lane = ("fused" if platforms and set(platforms) <= {"cuda", "cpu"}
            else _eval_lane())
    _AUTO_DECISION.clear()
    _AUTO_DECISION.update({
        "requested": "auto", "lane": lane,
        "devices": len(devices), "platforms": platforms,
    })
    return lane


def last_auto_decision() -> Optional[dict]:
    """The most recent auto-lane resolution, or None before any auto
    upload (explicit lanes never consult this path)."""
    return dict(_AUTO_DECISION) if _AUTO_DECISION else None


def kernel_lane_of(params) -> str:
    """Which kernel lane a params tree dispatches through (structural, in
    ``eval_verdicts``' branch order)."""
    if params.get("fused") is not None:
        return "fused"
    if params.get("matmul") is not None:
        return "matmul"
    return "gather"


def _mm_dtype(device=None) -> torch.dtype:
    """bf16 on a CUDA target, float32 on the CPU, from the target device
    when one is given, else from what is visible."""
    if device is not None:
        kind = torch.device(device).type
    else:
        kind = "cuda" if torch.cuda.is_available() else "cpu"
    return torch.float32 if kind == "cpu" else torch.bfloat16


def _cast(m: np.ndarray, cdt: torch.dtype):
    """A float32 host matrix in the lane's dtype: numpy for float32, a CPU
    tensor for bf16 (numpy has no bf16)."""
    if cdt == torch.float32:
        return m.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(m, dtype=np.float32)).to(cdt)


def _exact_dtype(m: np.ndarray, cdt: torch.dtype) -> torch.dtype:
    """The lane's dtype where it holds every value of ``m`` exactly, else
    float32: bf16 has 8 significant bits, so a count above 256 may round."""
    if cdt == torch.bfloat16 and m.size and float(np.abs(m).max()) > 256:
        return torch.float32
    return cdt


def _matmul_operands(policy: CompiledPolicy, row_slot: np.ndarray,
                     device=None) -> dict:
    """One-hot and count matrices of the matmul lane.  ``row_slot`` is the
    per-DFA-row byte-tensor slot (the gather lane's ``dfa_byte_slot``, so
    the two lanes can never disagree on which byte tensor a row scans)."""
    L = policy.n_leaves
    A = policy.n_attrs
    M = policy.n_member_attrs
    C = policy.n_cpu_leaves
    cdt = _mm_dtype(device)
    attr_onehot = np.zeros((A, L), dtype=np.float32)
    attr_onehot[policy.leaf_attr, np.arange(L)] = 1.0

    # compact-membership one-hot: member slot of each incl/excl leaf's attr
    memb_onehot = np.zeros((M, L), dtype=np.float32)
    is_memb = policy.leaf_is_membership
    if is_memb.any():
        slots = policy.member_attr_slot[policy.leaf_attr[is_memb]]
        memb_onehot[slots, np.nonzero(is_memb)[0]] = 1.0

    # dense CPU lane spread: [C] columns → [L] leaf axis
    cpu_oh = np.zeros((C, L), dtype=np.float32)
    cl = policy.cpu_leaf_list
    if cl.shape[0]:
        cpu_oh[np.arange(cl.shape[0]), cl] = 1.0

    # per-level count matrices over the buffer prefix visible to that level
    # (the count threshold, the level's child width, comes from
    # params["levels"] at evaluation time)
    level_mats = []
    cursor = 2 + L  # TRUE/FALSE slots + leaf block
    for children, is_and in policy.levels:
        rows, width = children.shape
        m = np.zeros((rows, cursor), dtype=np.float32)
        np.add.at(m, (np.repeat(np.arange(rows), width),
                      children.reshape(-1)), 1.0)
        level_mats.append(_cast(m, _exact_dtype(m, cdt)))
        cursor += rows

    # eval-table one-hots over the full buffer
    G, E = policy.eval_rule.shape
    rule_m = np.zeros((G * E, cursor), dtype=np.float32)
    rule_m[np.arange(G * E), policy.eval_rule.reshape(-1)] = 1.0
    cond_m = np.zeros((G * E, cursor), dtype=np.float32)
    cond_m[np.arange(G * E), policy.eval_cond.reshape(-1)] = 1.0

    out = {
        "attr_onehot": attr_onehot,  # float32: selected in float64
        "memb_onehot": memb_onehot,  # float32: selected in float64
        "cpu_oh": _cast(cpu_oh, cdt),
        "level_mats": tuple(level_mats),
        "rule_m": _cast(rule_m, cdt),
        "cond_m": _cast(cond_m, cdt),
    }

    # numeric lane: int32 compares happen slot-wise (exact); this bool mask
    # spreads each slot's verdict onto its leaves by a masked any-reduce
    if getattr(policy, "n_num_attrs", 0):
        NN = policy.n_num_attrs
        num_mask = np.zeros((NN, L), dtype=bool)
        is_num = np.isin(policy.leaf_op, NUMERIC_OPS)
        if is_num.any():
            slots = np.maximum(
                policy.num_attr_slot[policy.leaf_attr[is_num]], 0)
            num_mask[slots, np.nonzero(is_num)[0]] = True
        out["num_slot_leaf_mask"] = num_mask

    # relation lane: per (entity row, leaf) bit matrix, each relation
    # leaf's column unpacked onto its leaf, selected by a one-hot over rows
    if getattr(policy, "n_rel_slots", 0):
        Rp = int(policy.rel_bits.shape[0])
        NR = policy.n_rel_slots
        is_rel = policy.leaf_op == OP_RELATION
        rel_leaf_mat = np.zeros((Rp, L), dtype=np.float32)
        rel_slot_leaf = np.zeros((NR, L), dtype=np.float32)
        for l in np.nonzero(is_rel)[0]:
            c = int(policy.leaf_rel_col[l])
            rel_leaf_mat[:, l] = (policy.rel_bits[:, c >> 3]
                                  >> np.uint8(c & 7)) & 1
            rel_slot_leaf[int(policy.leaf_rel_slot[l]), l] = 1.0
        out["rel_leaf_mat"] = _cast(rel_leaf_mat, cdt)
        out["rel_slot_leaf_oh"] = _cast(rel_slot_leaf, cdt)

    # device regex lane: per-row transition tables (the deduped tables
    # expanded back to rows: the einsum contracts over the row axis) and
    # the spread one-hots
    if policy.n_byte_attrs:
        R = policy.dfa_table_of_row.shape[0]
        NB = policy.n_byte_attrs
        slot_row_oh = np.zeros((NB, R), dtype=np.float32)
        slot_row_oh[row_slot, np.arange(R)] = 1.0
        is_dfa_leaf = policy.leaf_op == OP_REGEX_DFA
        row_leaf_oh = np.zeros((R, L), dtype=np.float32)
        row_leaf_oh[policy.leaf_dfa_row[is_dfa_leaf],
                    np.nonzero(is_dfa_leaf)[0]] = 1.0
        slot_leaf_oh = np.zeros((NB, L), dtype=np.float32)
        leaf_slot = row_slot[policy.leaf_dfa_row[is_dfa_leaf]]
        slot_leaf_oh[leaf_slot, np.nonzero(is_dfa_leaf)[0]] = 1.0
        out.update({
            # next-state values <= 255 and state count <= 256: exact in bf16
            "dfa_tables_f": _cast(policy.dfa_tables_by_row, cdt),
            "dfa_accept_f": _cast(policy.dfa_accept_by_row, cdt),
            "slot_row_oh": _cast(slot_row_oh, cdt),
            "row_leaf_oh": _cast(row_leaf_oh, cdt),
            "slot_leaf_oh": _cast(slot_leaf_oh, cdt),
        })
    return out


def to_device(policy: CompiledPolicy, device=None, lane: Optional[str] = None,
              host: bool = False) -> dict:
    """One compiled corpus's operand tree for one lane, as tensors on
    ``device`` (the CUDA card unless named; index operands are range-checked
    on the host first, ``operands.host_view``), or with ``host=True`` as the
    host tree (numpy arrays; bf16 matrices as CPU tensors), leaf for leaf
    the JAX package's ``to_device(host=True, lane=...)``.  ``lane`` overrides
    the environment's lane selection."""
    if lane is None:
        kl = _kernel_lane()
        lane = kl if kl in LANES else auto_lane(device)
    if lane not in LANES:
        raise ValueError(f"unknown kernel lane {lane!r}")
    if lane == "matmul" and len(policy.interner) + 4 >= _F32_EXACT:
        lane = "gather"  # ids no longer exact in float32 accumulation
    tree = host_operands(policy, lane=lane, device=device)
    if host:
        return tree
    return params_from_numpy(tree, device)


DevicePolicy = dict


# ---------------------------------------------------------------------------
# helpers every lane shares
# ---------------------------------------------------------------------------


def _cpu_full(params, cpu_dense):
    """Spread the dense [B, C] CPU lane onto the [B, L] leaf axis (padding
    columns land in a dump slot at L, sliced off)."""
    B = cpu_dense.shape[0]
    L = params["leaf_op"].shape[0]
    buf = torch.zeros((B, L + 1), dtype=torch.bool, device=cpu_dense.device)
    buf[:, params["cpu_scatter_idx"].long()] = cpu_dense
    return buf[:, :L]


def _leaf_op_cascade(leaf_op, eq, incl, dfa_leaf_val, cpu_lane,
                     num_cmp=None, rel_res=None, leaf_movf=None):
    """Per-leaf results from the lanes' primitive comparisons by op code.
    Under the membership-overflow mask both INCL and EXCL read the CPU lane
    as it is: the encoder stores the final excl answer there."""
    op = leaf_op[None, :]
    false = torch.zeros_like(eq)
    if leaf_movf is None:
        incl_eff, excl_eff = incl, ~incl
    else:
        incl_eff = torch.where(leaf_movf, cpu_lane, incl)
        excl_eff = torch.where(leaf_movf, cpu_lane, ~incl)
    if num_cmp is None:
        num_res = false
    else:
        gt, ge, lt, le = num_cmp
        num_res = torch.where(
            op == OP_NUM_GT, gt,
            torch.where(op == OP_NUM_GE, ge,
                        torch.where(op == OP_NUM_LT, lt, le)))
    tail = torch.where(
        (op == OP_CPU) | (op == OP_TREE_CPU), cpu_lane,
        torch.where(op >= OP_NUM_GT,
                    torch.where(op == OP_RELATION,
                                rel_res if rel_res is not None else false,
                                num_res),
                    false))  # OP_ERROR → False
    return torch.where(
        op == OP_EQ, eq,
        torch.where(
            op == OP_NEQ, ~eq,
            torch.where(
                op == OP_INCL, incl_eff,
                torch.where(
                    op == OP_EXCL, excl_eff,
                    torch.where(op == OP_REGEX_DFA, dfa_leaf_val, tail)))))


def _verdict_from_tables(params, cond, rule):
    """Per-config verdicts: ∧ over evaluators of (¬cond ∨ rule)."""
    skipped = params["eval_has_cond"][None, :, :] & ~cond
    verdict = torch.where(skipped, True, rule).all(dim=-1)   # [B, G]
    return verdict, (rule, skipped)


def _select_own(config_id, n_configs: int):
    """[B, G] one-hot mask of each row's own config (a mask, not an index:
    an out-of-range id selects nothing)."""
    cid = config_id.to(torch.int64)
    return cid[:, None] == torch.arange(n_configs, device=cid.device)[None, :]


def _bitpack_rows(mat):
    """[B, C] bool → [B, ceil(C/8)] uint8, little bit order (bit j of byte
    k is column 8k+j), zero padding bits."""
    B, C = mat.shape
    W = packed_width(C)
    padded = torch.zeros((B, W * 8), dtype=torch.int32, device=mat.device)
    padded[:, :C] = mat.to(torch.int32)
    weights = 1 << torch.arange(8, dtype=torch.int32, device=mat.device)
    return (padded.reshape(B, W, 8) * weights).sum(dim=-1).to(torch.uint8)


# ---------------------------------------------------------------------------
# the gather lane's stages (the staged baseline runs them one by one)
# ---------------------------------------------------------------------------


def _gather_leaves(params, attrs_val, members_c, cpu_dense):
    """(eq, incl, cpu_lane) [B, L]: each leaf's attr compare, membership
    and CPU-lane column."""
    attrs_val = attrs_val.to(torch.int32)
    members_c = members_c.to(torch.int32)
    const = params["leaf_const"]
    eq = attrs_val[:, params["leaf_attr"].long()] == const[None, :]
    memb = members_c[:, params["member_slot_of_leaf"].long()]   # [B, L, K]
    incl = (memb == const[None, :, None]).any(dim=-1)
    return eq, incl, _cpu_full(params, cpu_dense)


def _gather_dfa(params, attr_bytes, byte_ovf, cpu_lane):
    """[B, L] regex leaf values: the DFA byte scan over the compile-order
    row layout (overflowed values read their CPU-lane answer)."""
    B = attr_bytes.shape[0]
    tables = params["dfa_tables"]                          # [T, S, 256]
    tab_idx = params["dfa_table_of_row"].long()[None, :].expand(B, -1)
    slot = params["dfa_byte_slot"].long()
    row_bytes = attr_bytes[:, slot]                         # [B, R, LB]
    states = torch.zeros(tab_idx.shape, dtype=torch.long,
                         device=attr_bytes.device)
    for i in range(row_bytes.shape[2]):
        states = tables[tab_idx, states, row_bytes[:, :, i].long()].long()
    dfa_row_res = params["dfa_accept"][tab_idx, states]     # [B, R]
    row = params["leaf_dfa_row"].long()
    leaf_bovf = byte_ovf[:, slot[row]]
    return torch.where(leaf_bovf, cpu_lane, dfa_row_res[:, row])


def _gather_value_lanes(params, attrs_num, num_valid, rel_rows, member_ovf):
    """(numeric (gt, ge, lt, le), relation, membership-overflow) [B, L]
    results; None where the batch or the corpus lacks the lane."""
    const = params["leaf_const"]
    num_cmp = None
    if params.get("leaf_num_slot") is not None and attrs_num is not None:
        slot = params["leaf_num_slot"].long()
        lv, lok = attrs_num[:, slot], num_valid[:, slot]
        ic = const[None, :]
        num_cmp = (lok & (lv > ic), lok & (lv >= ic),
                   lok & (lv < ic), lok & (lv <= ic))
    rel_res = None
    if params.get("rel_bits") is not None and rel_rows is not None:
        rows_l = rel_rows[:, params["leaf_rel_slot"].long()].long()
        col = params["leaf_rel_col"].long()
        byte = params["rel_bits"][rows_l, (col >> 3)[None, :]].long()
        rel_res = ((byte >> (col & 7)[None, :]) & 1) != 0
    leaf_movf = None
    if member_ovf is not None:
        leaf_movf = member_ovf[:, params["member_slot_of_leaf"].long()]
    return num_cmp, rel_res, leaf_movf


def _gather_circuit(params, res):
    """Per-config verdict [B, G] and (rule, skipped) [B, G, E] from the
    [B, L] leaf results: the And/Or levels, then the evaluator tables."""
    B = res.shape[0]
    dev = res.device
    buffer = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev),
                        torch.zeros((B, 1), dtype=torch.bool, device=dev),
                        res], dim=1)
    for children, is_and in params["levels"]:
        ch = buffer[:, children.reshape(-1).long()]
        ch = ch.reshape(B, children.shape[0], children.shape[1])
        node = torch.where(is_and[None, :], ch.all(dim=-1), ch.any(dim=-1))
        buffer = torch.cat([buffer, node], dim=1)
    G, E = params["eval_rule"].shape
    cond = buffer[:, params["eval_cond"].reshape(-1).long()].reshape(B, G, E)
    rule = buffer[:, params["eval_rule"].reshape(-1).long()].reshape(B, G, E)
    return _verdict_from_tables(params, cond, rule)


def _eval_verdicts_gather(params, attrs_val, members_c, cpu_dense,
                          attr_bytes, byte_ovf, attrs_num=None,
                          num_valid=None, rel_rows=None, member_ovf=None):
    eq, incl, cpu_lane = _gather_leaves(params, attrs_val, members_c,
                                        cpu_dense)
    if params["dfa_tables"] is not None and attr_bytes is not None:
        dfa_leaf_val = _gather_dfa(params, attr_bytes, byte_ovf, cpu_lane)
    else:
        dfa_leaf_val = cpu_lane  # regexes ride the CPU lane entirely
    num_cmp, rel_res, leaf_movf = _gather_value_lanes(
        params, attrs_num, num_valid, rel_rows, member_ovf)
    res = _leaf_op_cascade(params["leaf_op"], eq, incl, dfa_leaf_val,
                           cpu_lane, num_cmp, rel_res, leaf_movf)
    return _gather_circuit(params, res)


# ---------------------------------------------------------------------------
# the matmul lane
# ---------------------------------------------------------------------------


def _mm(a, b):
    """The exact product of a 0/1 operand ``a`` and a stored matrix ``b``
    (module doc): in float32 when ``b`` is bf16, else in float64."""
    dt = torch.float32 if b.dtype == torch.bfloat16 else torch.float64
    return torch.matmul(a.to(dt), b.to(dt))


def _eval_verdicts_matmul(params, attrs_val, members_c, cpu_dense,
                          attr_bytes, byte_ovf, attrs_num=None,
                          num_valid=None, rel_rows=None, member_ovf=None):
    mm = params["matmul"]
    f64 = torch.float64
    B = attrs_val.shape[0]
    dev = attrs_val.device
    const = params["leaf_const"].to(f64)                      # [L]

    # ---- leaf selection: one-hot products in float64 (exact ids) --------
    val = torch.matmul(attrs_val.to(f64), mm["attr_onehot"].to(f64))
    eq = val == const[None, :]                                # [B, L]
    memb = torch.einsum("bmk,ml->bkl", members_c.to(f64),
                        mm["memb_onehot"].to(f64))            # [B, K, L]
    incl = (memb == const[None, None, :]).any(dim=1)          # [B, L]

    # ---- dense CPU lane spread onto the leaf axis ------------------------
    cpu_lane = _mm(cpu_dense, mm["cpu_oh"]) > 0.5             # [B, L]

    # ---- device regex lane: DFA scan, transitions as batched products ----
    if params["dfa_tables"] is not None and attr_bytes is not None:
        tables = mm["dfa_tables_f"].float()                   # [R, S, 256]
        S = tables.shape[1]
        # spread each row's attr bytes from its slot: [B, NB, LB] → [B, R, LB]
        row_bytes = torch.einsum("bnl,nr->brl", attr_bytes.float(),
                                 mm["slot_row_oh"].float())
        iota_s = torch.arange(S, dtype=torch.float32, device=dev)
        iota_c = torch.arange(256, dtype=torch.float32, device=dev)
        state = row_bytes[:, :, 0] * 0.0                      # [B, R]
        for i in range(row_bytes.shape[2]):
            byte_oh = (row_bytes[:, :, i, None] == iota_c).float()
            # per-state next state given this byte: [R,S,256] x [B,R,256]
            nxt_by_state = torch.einsum("rsc,brc->brs", tables, byte_oh)
            st_oh = (state[..., None] == iota_s).float()
            state = (st_oh * nxt_by_state).sum(dim=-1)
        final_oh = (state[..., None] == iota_s).float()
        dfa_row_res = torch.einsum("brs,rs->br", final_oh,
                                   mm["dfa_accept_f"].float()) > 0.5
        leaf_dfa = _mm(dfa_row_res, mm["row_leaf_oh"]) > 0.5
        leaf_bovf = _mm(byte_ovf, mm["slot_leaf_oh"]) > 0.5
        # overflowed values: exact answer precomputed into the CPU lane
        dfa_leaf_val = torch.where(leaf_bovf, cpu_lane, leaf_dfa)
    else:
        dfa_leaf_val = cpu_lane  # regexes ride the CPU lane entirely

    # ---- numeric lane: slot-wise int32 compares, mask-spread -------------
    num_cmp = None
    if params.get("leaf_num_slot") is not None and attrs_num is not None:
        num_mask = mm["num_slot_leaf_mask"]                   # [NN, L] bool
        iconst = params["leaf_const"][None, None, :]          # [1, 1, L]
        v = attrs_num[:, :, None]                             # [B, NN, 1]
        lane_ok = num_valid[:, :, None] & num_mask[None]      # [B, NN, L]
        num_cmp = ((lane_ok & (v > iconst)).any(dim=1),
                   (lane_ok & (v >= iconst)).any(dim=1),
                   (lane_ok & (v < iconst)).any(dim=1),
                   (lane_ok & (v <= iconst)).any(dim=1))

    # ---- relation lane: one-hot row selection per slot over the unpacked
    # per-leaf column matrix (0/1 products) --------------------------------
    rel_res = None
    if params.get("rel_bits") is not None and rel_rows is not None:
        rel_mat = mm["rel_leaf_mat"]                          # [Rp, L]
        Rp = rel_mat.shape[0]
        iota_r = torch.arange(Rp, device=dev)
        slot_oh = mm["rel_slot_leaf_oh"].float()              # [NR, L]
        acc = torch.zeros((B, rel_mat.shape[1]), dtype=torch.float32,
                          device=dev)
        for n_i in range(slot_oh.shape[0]):                   # static, small
            oh = rel_rows[:, n_i].long()[:, None] == iota_r[None, :]
            acc = acc + _mm(oh, rel_mat) * slot_oh[n_i][None, :]
        rel_res = acc > 0.5

    # ---- membership-overflow assist: spread the [B, M] mask to leaves ---
    leaf_movf = None
    if member_ovf is not None:
        leaf_movf = _mm(member_ovf, mm["memb_onehot"]) > 0.5  # [B, L]

    res = _leaf_op_cascade(params["leaf_op"], eq, incl, dfa_leaf_val,
                           cpu_lane, num_cmp, rel_res, leaf_movf)

    # ---- boolean circuit: per-level count products -----------------------
    buffer = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev),
                        torch.zeros((B, 1), dtype=torch.bool, device=dev),
                        res], dim=1)
    for m, (children, is_and) in zip(mm["level_mats"], params["levels"]):
        width = children.shape[1]  # the level's padded child count
        counts = _mm(buffer, m.T)                             # [B, rows]
        # And-padding children point at TRUE (counted), Or-padding at FALSE
        # (adds 0): count == width is all, count > 0 is any
        node = torch.where(is_and[None, :], counts >= width - 0.5,
                           counts > 0.5)
        buffer = torch.cat([buffer, node], dim=1)

    # ---- per-config rule/cond extraction: one-hot products ---------------
    G, E = params["eval_rule"].shape
    rule = _mm(buffer, mm["rule_m"].T) > 0.5
    cond = _mm(buffer, mm["cond_m"].T) > 0.5
    return _verdict_from_tables(params, cond.reshape(B, G, E),
                                rule.reshape(B, G, E))


# ---------------------------------------------------------------------------
# the lanes' entries
# ---------------------------------------------------------------------------


def eval_verdicts(params: DevicePolicy, attrs_val, members_c, cpu_dense,
                  attr_bytes=None, byte_ovf=None, attrs_num=None,
                  num_valid=None, rel_rows=None, member_ovf=None):
    """(verdict [B, G] bool, (rule [B, G, E], skipped [B, G, E])) on the
    params' lane."""
    if params.get("fused") is not None:
        from . import fused_kernel as _fk  # lazy: fused_kernel imports us

        ops = {"attrs_val": attrs_val, "members_c": members_c,
               "cpu_dense": cpu_dense}
        for name, a in (("attr_bytes", attr_bytes), ("byte_ovf", byte_ovf),
                        ("attrs_num", attrs_num), ("num_valid", num_valid),
                        ("rel_rows", rel_rows), ("member_ovf", member_ovf)):
            if a is not None:
                ops[name] = a
        verdict, rule, skipped = _fk._eval_verdicts_plain(params, ops)
        return verdict, (rule, skipped)
    lane = (_eval_verdicts_matmul if params.get("matmul") is not None
            else _eval_verdicts_gather)
    return lane(params, attrs_val.to(torch.int32), members_c.to(torch.int32),
                cpu_dense, attr_bytes, byte_ovf, attrs_num, num_valid,
                rel_rows, member_ovf)


def forward(params, attrs_val, members_c, cpu_dense, config_id,
            attr_bytes=None, byte_ovf=None, attrs_num=None, num_valid=None,
            rel_rows=None, member_ovf=None):
    """Encoded micro-batch → (own verdicts [B], verdict matrix [B, G])."""
    verdict, _ = eval_verdicts(params, attrs_val, members_c, cpu_dense,
                               attr_bytes, byte_ovf, attrs_num, num_valid,
                               rel_rows, member_ovf)
    own_mask = _select_own(config_id, verdict.shape[1])
    return (verdict & own_mask).any(dim=1), verdict


def eval_full(params, attrs_val, members_c, cpu_dense, config_id,
              attr_bytes=None, byte_ovf=None, attrs_num=None, num_valid=None,
              rel_rows=None, member_ovf=None):
    """(own verdict [B], own rule [B, E], own skipped [B, E])."""
    verdict, (rule, skipped) = eval_verdicts(
        params, attrs_val, members_c, cpu_dense, attr_bytes, byte_ovf,
        attrs_num, num_valid, rel_rows, member_ovf)
    own_mask = _select_own(config_id, verdict.shape[1])
    own = (verdict & own_mask).any(dim=1)
    own_rule = (rule & own_mask[:, :, None]).any(dim=1)
    own_skipped = (skipped & own_mask[:, :, None]).any(dim=1)
    return own, own_rule, own_skipped


def eval_packed(params, attrs_val, members_c, cpu_dense, config_id,
                attr_bytes=None, byte_ovf=None, attrs_num=None,
                num_valid=None, rel_rows=None, member_ovf=None):
    """One [B, 1+2E] bool result: own verdict, own rule results, own
    skipped flags."""
    own, own_rule, own_skipped = eval_full(
        params, attrs_val, members_c, cpu_dense, config_id, attr_bytes,
        byte_ovf, attrs_num, num_valid, rel_rows, member_ovf)
    return torch.cat([own[:, None], own_rule, own_skipped], dim=1)


def eval_bitpacked(params, attrs_val, members_c, cpu_dense, config_id,
                   attr_bytes=None, byte_ovf=None, attrs_num=None,
                   num_valid=None, rel_rows=None, member_ovf=None):
    """``eval_packed`` bitpacked: the [B, ceil((1+2E)/8)] uint8 readback."""
    return _bitpack_rows(eval_packed(
        params, attrs_val, members_c, cpu_dense, config_id, attr_bytes,
        byte_ovf, attrs_num, num_valid, rel_rows, member_ovf))


def _operands(params, db) -> dict:
    """One DeviceBatch's operands as tensors on the params' device, absent
    lanes absent (the DFA pair only where the corpus has the lane)."""
    dev = params["leaf_op"].device
    has_dfa = params["dfa_tables"] is not None
    ops = {}
    for name in ("attrs_val", "members_c", "cpu_dense", "config_id",
                 "attr_bytes", "byte_ovf", "attrs_num", "num_valid",
                 "rel_rows", "member_ovf"):
        a = getattr(db, name)
        if a is None or (name in ("attr_bytes", "byte_ovf") and not has_dfa):
            continue
        ops[name] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return ops


def _extra_operands(ops: dict) -> tuple:
    """The value-lane tail of one operand dict (absent lanes None)."""
    return tuple(ops.get(n) for n in ("attrs_num", "num_valid", "rel_rows",
                                      "member_ovf"))


def _bitpacked_ops(params, ops: dict):
    return eval_bitpacked(
        params, ops["attrs_val"], ops["members_c"], ops["cpu_dense"],
        ops["config_id"], ops.get("attr_bytes"), ops.get("byte_ovf"),
        *_extra_operands(ops))


def dispatch_packed(params, db, bitpack: bool = False):
    """One batch with one transfer per operand: the packed [B, 1+2E] bool
    result, or with ``bitpack=True`` the [B, W] uint8 bitmask, on the
    params' device (not synchronised)."""
    check_batch(params, db)
    ops = _operands(params, db)
    if bitpack:
        return _bitpacked_ops(params, ops)
    return eval_packed(
        params, ops["attrs_val"], ops["members_c"], ops["cpu_dense"],
        ops["config_id"], ops.get("attr_bytes"), ops.get("byte_ovf"),
        *_extra_operands(ops))


def eval_fused(params, buf: torch.Tensor, layout: tuple):
    """The bitpacked readback over one staging buffer already on the
    params' device (``operands.fuse_batch``): decode, evaluate, pack."""
    ops = defuse(buf, layout)
    if params["dfa_tables"] is None:
        ops.pop("attr_bytes", None)
        ops.pop("byte_ovf", None)
    return _bitpacked_ops(params, ops)


def _stage_batch(params, db):
    """(staging buffer on the params' device, layout): one H2D copy on the
    card, a view of the host buffer on the CPU."""
    from . import fused_kernel as _fk

    check_batch(params, db)
    buf, layout = fuse_batch(db)
    dev = params["leaf_op"].device
    if dev.type == "cuda":
        return _fk._stage(buf, dev), layout
    if dev.type != "cpu":
        raise ValueError(f"no lane for device {dev}")
    return torch.from_numpy(buf), layout


def dispatch_lane(params, db):
    """One batch, non-blocking, on the params' lane, uncounted: the fused
    lane launches the mega-kernel (``fused_kernel.dispatch_megakernel``);
    the gather and matmul lanes stage the batch in one H2D copy and run
    their op chain on the calling thread's current stream.  Either way the
    handle's [B, W] uint8 readback starts its D2H copy at once and
    ``np.asarray(handle)`` waits for it."""
    from . import fused_kernel as _fk

    if params.get("fused") is not None:
        return _fk.dispatch_megakernel(params, db)
    dev = params["leaf_op"].device
    stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
    buf, layout = _stage_batch(params, db)
    return _fk.MegakernelHandle(eval_fused(params, buf, layout), stream,
                                kernel=False)


def dispatch_fused(params, db):
    """The lane router of the serving paths: ``dispatch_lane``, with the
    batch counted on ``auth_server_kernel_lane_total``."""
    try:
        from ..utils.metrics import observe_kernel_lane

        observe_kernel_lane(kernel_lane_of(params))
    except Exception:
        pass  # metrics are advisory; never fail a dispatch over them
    return dispatch_lane(params, db)


def eval_batch(params, db) -> Tuple[np.ndarray, np.ndarray]:
    """Compact batch → (own verdicts [B], verdict matrix [B, G]) as numpy."""
    check_batch(params, db)
    ops = _operands(params, db)
    own, verdict = forward(
        params, ops["attrs_val"], ops["members_c"], ops["cpu_dense"],
        ops["config_id"], ops.get("attr_bytes"), ops.get("byte_ovf"),
        *_extra_operands(ops))
    return own.cpu().numpy(), verdict.cpu().numpy()
