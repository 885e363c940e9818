"""Operand and readback layer of the lanes (host numpy + torch).

Everything that surrounds the lanes' evaluation and runs on the host lives
here:

  - ``host_operands`` builds one lane's operand tree of one compiled
    corpus as numpy arrays, with ``None`` kept structural for absent lanes
    (``pattern_eval.to_device`` resolves the lane);
  - ``params_from_numpy`` turns such a tree into torch tensors on a device
    in two steps: ``host_view`` checks on the host that every index operand
    lies in range (so neither the kernel nor the op-chain lanes index out
    of bounds) and, on the fused lane, adds the ``"kernel"`` subtree: the
    per-config program, each config's own leaves, nodes and DFA rows with
    indices local to one row's circuit buffer; then the tree goes to the
    device (a reconcile diffs two host views first and ships only what
    changed, snapshots/delta.py);
  - ``fuse_batch`` concatenates one batch's operands into one uint8 staging
    buffer (one H2D copy per batch) and ``defuse`` decodes it in torch;
  - ``unpack_verdicts`` / ``firing_columns`` / ``unpack_attribution`` decode
    the [B, W] uint8 bitpacked readback on the host.

The staging buffer carries multi-byte operands in little-endian order, as
numpy lays them out on this host; the kernel assembles them byte by byte.
A big-endian host would stage the bytes in the other order, so the module
refuses to load there instead of decoding wrong ids.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..compiler.compile import (
    OP_EQ, OP_EXCL, OP_INCL, OP_NEQ, OP_NUM_GT, OP_REGEX_DFA, OP_RELATION,
    CompiledPolicy)

__all__ = [
    "resolve_device", "host_operands", "fused_operands", "host_view",
    "host_array",
    "params_from_numpy", "to_device", "check_batch", "packed_width",
    "unpack_verdicts", "firing_columns", "unpack_attribution", "FUSED_FIELDS",
    "fuse_batch", "staged_h2d_bytes", "defuse",
]

if sys.byteorder != "little":
    raise RuntimeError(
        "authorino_tpu_torch stages operands little-endian; this host is "
        f"{sys.byteorder}-endian")


def resolve_device(device=None) -> torch.device:
    """The entry points' device: the CUDA card unless the caller names
    another.  Raises when no card is visible and none was named — a CPU run
    must ask for ``device="cpu"`` explicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run the "
                "plain PyTorch version on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    return dev


# ---------------------------------------------------------------------------
# the fused-lane operand tree
# ---------------------------------------------------------------------------


def fused_operands(policy: CompiledPolicy, dfa_byte_slot: np.ndarray) -> dict:
    """The ``tree["fused"]`` subtree: int8 op codes and the DFA row arrays
    regrouped by ``policy.dfa_row_perm`` (rows sorted by owning table);
    ``leaf_dfa_pos`` is each leaf's row position after the regrouping."""
    fz = {"leaf_op_i8": np.asarray(policy.leaf_op_i8)}
    if policy.n_byte_attrs:
        perm = np.asarray(policy.dfa_row_perm)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.shape[0], dtype=np.int32)
        fz["dfa_table_of_row_g"] = policy.dfa_table_of_row[perm]
        fz["dfa_byte_slot_g"] = dfa_byte_slot.astype(np.int32)[perm]
        fz["leaf_dfa_pos"] = inv[policy.leaf_dfa_row].astype(np.int32)
    return fz


def host_operands(policy: CompiledPolicy, lane: str = "fused",
                  device=None) -> dict:
    """Numpy operand tree of one lane: the base tree every lane reads,
    ``"fused"`` set only on the fused lane and ``"matmul"`` only on the
    matmul lane (``None`` otherwise, structural).  Leaf for leaf (names,
    dtypes, shapes, ``None`` structure) the tree the JAX package builds for
    that lane.  ``device`` is the upload's target, which decides the matmul
    lane's dtype."""
    n_num = getattr(policy, "n_num_attrs", 0)
    n_rel = getattr(policy, "n_rel_slots", 0)
    has_dfa = bool(policy.n_byte_attrs)
    dfa_byte_slot = np.maximum(policy.attr_byte_slot[policy.dfa_leaf_attr], 0)
    L = policy.n_leaves
    member_slot_of_leaf = np.maximum(
        policy.member_attr_slot[policy.leaf_attr], 0).astype(np.int32)
    # dense CPU cols → leaf axis; padding cols land in a dump slot at L
    C = policy.n_cpu_leaves
    cpu_scatter_idx = np.full((C,), L, dtype=np.int32)
    cpu_scatter_idx[: policy.cpu_leaf_list.shape[0]] = policy.cpu_leaf_list
    a = np.asarray
    mm = fz = None
    if lane == "matmul":
        from .pattern_eval import _matmul_operands  # lazy: it imports us

        mm = _matmul_operands(policy, dfa_byte_slot, device=device)
    elif lane == "fused":
        fz = {k: a(v) for k, v in
              fused_operands(policy, dfa_byte_slot).items()}
    return {
        "matmul": mm,
        "fused": fz,
        "leaf_op": a(policy.leaf_op),
        "leaf_attr": a(policy.leaf_attr),
        "leaf_const": a(policy.leaf_const),
        "member_slot_of_leaf": member_slot_of_leaf,
        "cpu_scatter_idx": cpu_scatter_idx,
        "levels": tuple((a(ch), a(ia)) for ch, ia in policy.levels),
        "eval_cond": a(policy.eval_cond),
        "eval_rule": a(policy.eval_rule),
        "eval_has_cond": a(policy.eval_has_cond),
        "dfa_tables": a(policy.dfa_tables) if has_dfa else None,
        "dfa_accept": a(policy.dfa_accept) if has_dfa else None,
        "dfa_table_of_row": a(policy.dfa_table_of_row) if has_dfa else None,
        "dfa_byte_slot": dfa_byte_slot.astype(np.int32) if has_dfa else None,
        "leaf_dfa_row": a(policy.leaf_dfa_row) if has_dfa else None,
        "leaf_num_slot": np.maximum(
            policy.num_attr_slot[policy.leaf_attr], 0).astype(np.int32)
        if n_num else None,
        "rel_bits": a(policy.rel_bits) if n_rel else None,
        "leaf_rel_slot": a(policy.leaf_rel_slot) if n_rel else None,
        "leaf_rel_col": a(policy.leaf_rel_col) if n_rel else None,
    }


def _check_range(name: str, arr: np.ndarray, lo: int, hi: int) -> None:
    """Every entry of ``arr`` in ``[lo, hi)``, else a ValueError naming it."""
    if arr.size and (int(arr.min()) < lo or int(arr.max()) >= hi):
        raise ValueError(
            f"operand {name} holds an index outside [{lo}, {hi}): "
            f"[{int(arr.min())}, {int(arr.max())}]")


def _max_or(arr: Optional[np.ndarray], default: int = -1) -> int:
    return int(arr.max()) if arr is not None and arr.size else default


# A row's circuit buffer is addressed by 16-bit local indices: the kernel
# packs an evaluator's rule and cond slots into one 32-bit word.
LOCAL_LIMIT = 1 << 16


def _round16(n: int) -> int:
    return (int(n) + 15) // 16 * 16


def _check_tree(tree: dict) -> dict:
    """Validate the internal indices every lane reads (the compile-order
    layout) and return ``bounds``: the largest index each leaf operand
    takes into a batch operand, checked against each batch's shapes by
    ``check_batch``.  On a card an index out of range would read past a
    buffer (the kernel has no bounds checks) or fail a device-side assert
    that poisons the context for every later launch (the op-chain lanes),
    so no tree reaches the device without these checks."""
    L = int(tree["leaf_op"].shape[0])
    for name in ("leaf_attr", "leaf_const", "member_slot_of_leaf"):
        if tree[name].shape != (L,):
            raise ValueError(f"operand {name} has shape {tree[name].shape}, "
                             f"expected ({L},)")
    for name in ("leaf_dfa_row", "leaf_num_slot", "leaf_rel_slot",
                 "leaf_rel_col"):
        arr = tree[name]
        if arr is not None and arr.shape != (L,):
            raise ValueError(f"operand {name} does not span the leaf axis")
    _check_range("leaf_attr", tree["leaf_attr"], 0, 1 << 31)
    _check_range("member_slot_of_leaf", tree["member_slot_of_leaf"], 0,
                 1 << 31)
    sc = tree["cpu_scatter_idx"]
    _check_range("cpu_scatter_idx", sc, 0, L + 1)
    real = sc[sc < L]
    if np.unique(real).size != real.size:
        raise ValueError("cpu_scatter_idx maps two CPU columns onto one leaf")

    base = 2 + L
    for lv, (ch, ia) in enumerate(tree["levels"]):
        rows = int(ch.shape[0])
        if ch.ndim != 2 or ia.shape != (rows,):
            raise ValueError(f"level {lv}: is_and does not match children")
        _check_range(f"levels[{lv}].children", ch, 0, base)
        base += rows
    G, E = tree["eval_rule"].shape
    for name in ("eval_cond", "eval_rule", "eval_has_cond"):
        if tree[name].shape != (G, E):
            raise ValueError(f"operand {name} is not [{G}, {E}]")
    _check_range("eval_cond", tree["eval_cond"], 0, base)
    _check_range("eval_rule", tree["eval_rule"], 0, base)

    bounds = {
        "attr": _max_or(tree["leaf_attr"]),
        "member": _max_or(tree["member_slot_of_leaf"]),
        "byte": -1, "num": -1, "rel": -1, "rel_rows": 0,
    }
    if tree["dfa_tables"] is not None:
        T, S, nc = tree["dfa_tables"].shape
        if nc != 256 or tree["dfa_accept"].shape != (T, S):
            raise ValueError("dfa_tables/dfa_accept are not [T, S, 256]/[T, S]")
        if tree["dfa_tables"].dtype != np.uint8:
            raise ValueError("dfa_tables must be uint8")
        _check_range("dfa_tables", tree["dfa_tables"], 0, S)
        R = int(tree["dfa_table_of_row"].shape[0])
        if tree["dfa_byte_slot"].shape != (R,):
            raise ValueError("dfa_byte_slot does not match the DFA rows")
        _check_range("dfa_table_of_row", tree["dfa_table_of_row"], 0, T)
        _check_range("dfa_byte_slot", tree["dfa_byte_slot"], 0, 1 << 31)
        _check_range("leaf_dfa_row", tree["leaf_dfa_row"], 0, R)
        bounds["byte"] = _max_or(tree["dfa_byte_slot"])
    if tree["leaf_num_slot"] is not None:
        _check_range("leaf_num_slot", tree["leaf_num_slot"], 0, 1 << 31)
        bounds["num"] = _max_or(tree["leaf_num_slot"])
    if tree["rel_bits"] is not None:
        Rp, RW = tree["rel_bits"].shape
        _check_range("leaf_rel_slot", tree["leaf_rel_slot"], 0, 1 << 31)
        _check_range("leaf_rel_col", tree["leaf_rel_col"], 0, RW * 8)
        bounds["rel"] = _max_or(tree["leaf_rel_slot"])
        bounds["rel_rows"] = int(Rp)
    mm = tree.get("matmul")
    if mm is not None and len(mm["level_mats"]) != len(tree["levels"]):
        raise ValueError("matmul level_mats do not match the levels")
    return bounds


def _kernel_layout(tree: dict) -> dict:
    """Validate the tree's internal indices (``_check_tree``, then the
    fused layout's own) and build the kernel's per-config program
    (``_own_program``).  Returns host numpy arrays plus python ints, and
    ``bounds`` (``_check_tree``)."""
    bounds = _check_tree(tree)
    fz = tree["fused"]
    L = int(tree["leaf_op"].shape[0])
    for name, arr in (("leaf_op_i8", fz["leaf_op_i8"]),
                      ("leaf_dfa_pos", fz.get("leaf_dfa_pos"))):
        if arr is not None and arr.shape != (L,):
            raise ValueError(f"operand {name} does not span the leaf axis")
    _check_range("leaf_op_i8", fz["leaf_op_i8"], 0, 128)
    buf_size = 2 + L + sum(int(c.shape[0]) for c, _ in tree["levels"])
    if tree["dfa_tables"] is not None:
        T = int(tree["dfa_tables"].shape[0])
        R = int(fz["dfa_table_of_row_g"].shape[0])
        if fz["dfa_byte_slot_g"].shape != (R,):
            raise ValueError("dfa_byte_slot_g does not match the DFA rows")
        _check_range("dfa_table_of_row_g", fz["dfa_table_of_row_g"], 0, T)
        _check_range("dfa_byte_slot_g", fz["dfa_byte_slot_g"], 0, 1 << 31)
        _check_range("leaf_dfa_pos", fz["leaf_dfa_pos"], 0, R)
        bounds["byte"] = _max_or(fz["dfa_byte_slot_g"])
    prog = _own_program(tree, L, buf_size)
    prog["bounds"] = bounds
    return prog


def _reached_slots(tree: dict, L: int, buf_size: int) -> np.ndarray:
    """Every (config, buffer slot) its evaluators reach, as sorted unique
    keys ``g * buf_size + slot`` (slots 0 and 1 excluded).  The walk starts
    from ``eval_rule[g]`` and, where ``eval_has_cond``, ``eval_cond[g]``,
    and goes down the levels from the last: a node's children lie in
    earlier slots.  A node's padding children (TRUE under And, FALSE under
    Or) are not its children."""
    nb = np.int64(buf_size)
    G, E = tree["eval_rule"].shape
    g = np.repeat(np.arange(G, dtype=np.int64), E).reshape(G, E)
    has = np.asarray(tree["eval_has_cond"], dtype=bool)
    keys = [(g * nb + tree["eval_rule"]).ravel(),
            (g * nb + tree["eval_cond"])[has]]
    bases = np.cumsum([2 + L] + [int(c.shape[0]) for c, _ in tree["levels"]])
    for lv in reversed(range(len(tree["levels"]))):
        ch, ia = tree["levels"][lv]
        k = np.unique(np.concatenate(keys))
        slot = k % nb
        k = k[(slot >= bases[lv]) & (slot < bases[lv + 1])]
        row = k % nb - bases[lv]
        kids = np.asarray(ch, dtype=np.int64)[row]
        real = kids != np.where(np.asarray(ia)[row], 0, 1)[:, None]
        keys.append(((k // nb * nb)[:, None] + kids)[real])
    k = np.unique(np.concatenate(keys))
    return k[k % nb >= 2]


def _own_program(tree: dict, L: int, buf_size: int) -> dict:
    """The per-config program: for each config g, only the leaves, nodes
    and DFA rows its evaluators reach (``_reached_slots``), every index
    local to one row's circuit buffer [TRUE, FALSE, own leaves..., own
    nodes...].  Built with numpy over all configs at once.

      - ``cfg_off`` [G+1, 8] int32: the CSR offsets of config g's leaves,
        nodes, DFA rows, levels and node children, one column each (the
        last three columns are 0, so a row is two 16-byte loads);
      - ``leaf_rec`` [*, 4] int32, one 16-byte record per leaf: (op code,
        constant or relation column, the one slot the op reads, CPU-lane
        column or -1);
      - ``node_rec`` [*, 4] int32: (offset of the node's children among
        its config's, n_kids << 1 | is_and, then the 64-bit mask of its
        children's local slots, low word first), each config's nodes in
        level order.  The mask is filled where the config's whole buffer
        fits 64 slots (and its leaves, nodes and DFA rows 32 each): the
        kernel then runs that row's circuit on one 64-bit word;
      - ``node_kids`` [*] int32: the children as local indices, config by
        config (``max_kids``: the most one config has);
      - ``lvl_end`` [*] int32: per level of a config, the end of that level
        in the config's node list (one level's nodes are independent);
      - ``dfa_rec`` [*, 4] int32: (table, byte slot, local leaf, 0), one
        per reachable device-regex leaf, in the config's leaf order;
      - ``ev`` [G, E] int32: local rule | local cond << 16, cond TRUE (0)
        where the evaluator has none;
      - ``dfa_image``: uint8 tables [T, S, 256] then accept [T, S], each
        padded to 16 bytes (one bulk copy), ``tab_bytes`` the accept's
        offset, ``S``;
      - ``max_local``: the largest row buffer over all configs."""
    fz = tree["fused"]
    nb = np.int64(buf_size)
    G, E = tree["eval_rule"].shape
    k = _reached_slots(tree, L, buf_size)
    kg, slot = k // nb, k % nb
    cfg_start = np.searchsorted(k, np.arange(G + 1, dtype=np.int64) * nb)
    gs = np.arange(G + 1)

    def local(g, s):
        """Local index of slot ``s`` (reached by config ``g``)."""
        s = np.asarray(s, dtype=np.int64)
        pos = np.searchsorted(k, g * nb + s)
        return np.where(s < 2, s, 2 + pos - cfg_start[g])

    is_leaf = slot < 2 + L
    lg, l = kg[is_leaf], slot[is_leaf] - 2
    ng, ns = kg[~is_leaf], slot[~is_leaf]
    leaf_off = np.searchsorted(lg, gs)
    node_off = np.searchsorted(ng, gs)
    n_own = 2 + np.diff(leaf_off) + np.diff(node_off)
    max_local = int(n_own.max(initial=2))
    if max_local > LOCAL_LIMIT:
        raise ValueError(f"a config's circuit buffer holds {max_local} slots; "
                         f"local indices are 16 bits wide (< {LOCAL_LIMIT})")

    # leaves: one 16-byte record each
    op = np.asarray(fz["leaf_op_i8"], dtype=np.int64)[l]
    const = np.asarray(tree["leaf_const"], dtype=np.int64)[l]
    rd = np.zeros(l.shape, dtype=np.int64)
    eq = (op == OP_EQ) | (op == OP_NEQ)
    rd[eq] = tree["leaf_attr"][l[eq]]
    mem = (op == OP_INCL) | (op == OP_EXCL)
    rd[mem] = tree["member_slot_of_leaf"][l[mem]]
    rel = op == OP_RELATION
    if tree["rel_bits"] is not None:
        rd[rel] = tree["leaf_rel_slot"][l[rel]]
        const[rel] = tree["leaf_rel_col"][l[rel]]
    num = (op >= OP_NUM_GT) & ~rel
    if tree["leaf_num_slot"] is not None:
        rd[num] = tree["leaf_num_slot"][l[num]]
    sc = tree["cpu_scatter_idx"]
    col_of = np.full(L + 1, -1, dtype=np.int64)
    col_of[sc] = np.arange(sc.shape[0])
    cpu_col = col_of[l]          # padding columns land on L, no leaf's
    rx = np.zeros(l.shape, dtype=bool)
    dfa_rec = np.zeros((0, 4), dtype=np.int32)
    if tree["dfa_tables"] is not None:
        rx = op == OP_REGEX_DFA
        pos = np.asarray(fz["leaf_dfa_pos"], dtype=np.int64)[l[rx]]
        bslot = np.asarray(fz["dfa_byte_slot_g"], dtype=np.int64)[pos]
        rd[rx] = bslot
        dg = lg[rx]
        leaf_local = 2 + np.nonzero(rx)[0] - leaf_off[dg]
        dfa_rec = np.stack([fz["dfa_table_of_row_g"][pos], bslot, leaf_local,
                            np.zeros_like(bslot)], axis=1).astype(np.int32)
    dfa_off = np.searchsorted(lg[rx], gs)
    leaf_rec = np.stack([op, const, rd, cpu_col],
                        axis=1).astype(np.int32)

    # nodes: level order per config, children local
    bases = np.cumsum([2 + L] + [int(c.shape[0]) for c, _ in tree["levels"]])
    n_lv = max(len(tree["levels"]), 1)
    level_of = np.searchsorted(bases, ns, side="right") - 1
    n_kids = np.zeros(ns.shape, dtype=np.int64)
    is_and = np.zeros(ns.shape, dtype=np.int64)
    per_level = []
    for lv, (ch, ia) in enumerate(tree["levels"]):
        idx = np.nonzero(level_of == lv)[0]
        row = ns[idx] - bases[lv]
        kids = np.asarray(ch, dtype=np.int64)[row]
        real = kids != np.where(np.asarray(ia)[row], 0, 1)[:, None]
        n_kids[idx] = real.sum(axis=1)
        is_and[idx] = np.asarray(ia)[row]
        per_level.append((idx, kids, real))
    kid_begin = np.cumsum(n_kids) - n_kids
    node_kids = np.zeros(int(n_kids.sum()), dtype=np.int64)
    for idx, kids, real in per_level:
        at = kid_begin[idx][:, None] + np.cumsum(real, axis=1) - 1
        node_kids[at[real]] = local(
            np.broadcast_to(ng[idx][:, None], kids.shape)[real], kids[real])
    node_local = 2 + np.diff(leaf_off)[ng] + np.arange(ng.size) - node_off[ng]
    owner = np.repeat(np.arange(ng.size), n_kids)
    if node_kids.size and np.any(node_kids >= node_local[owner]):
        raise ValueError("a node reads a slot at or after its own")
    kid_off = np.concatenate([[0], np.cumsum(n_kids)])[node_off]
    # a config whose whole row buffer fits 64 bits (and one warp's lanes)
    # runs its circuit on a bit mask: each node carries its children's bits
    fast = ((np.diff(leaf_off) <= 32) & (np.diff(node_off) <= 32)
            & (np.diff(dfa_off) <= 32) & (n_own <= 64))
    kid_mask = np.zeros(ng.size, dtype=np.uint64)
    on = fast[ng][owner]
    np.bitwise_or.at(kid_mask, owner[on],
                     np.left_shift(np.uint64(1), node_kids[on].astype(np.uint64)))
    node_rec = np.stack([kid_begin - kid_off[ng], n_kids << 1 | is_and,
                         (kid_mask & np.uint64(0xFFFFFFFF)).astype(np.int64),
                         (kid_mask >> np.uint64(32)).astype(np.int64)],
                        axis=1).astype(np.uint32).view(np.int32)
    pair, counts = np.unique(ng * n_lv + level_of, return_counts=True)
    pg = pair // n_lv
    lvl_off = np.searchsorted(pg, gs)
    lvl_end = (np.cumsum(counts) - node_off[pg]).astype(np.int32)

    # evaluators, local
    g = np.repeat(np.arange(G, dtype=np.int64), E).reshape(G, E)
    cond = np.where(tree["eval_has_cond"], tree["eval_cond"], 0)
    rule_l, cond_l = local(g, tree["eval_rule"]), local(g, cond)
    if np.any(rule_l >= n_own[:G, None]) or np.any(cond_l >= n_own[:G, None]):
        raise ValueError("an evaluator reads outside its config's buffer")
    ev = rule_l | cond_l << 16

    image, tab_bytes, S = None, 0, 0
    if tree["dfa_tables"] is not None:
        tab = np.ascontiguousarray(tree["dfa_tables"]).reshape(-1)
        acc = np.asarray(tree["dfa_accept"]).astype(np.uint8).reshape(-1)
        tab_bytes = _round16(tab.size)
        image = np.zeros(tab_bytes + _round16(acc.size), dtype=np.uint8)
        image[:tab.size] = tab
        image[tab_bytes:tab_bytes + acc.size] = acc
        S = int(tree["dfa_tables"].shape[1])
    zero = np.zeros_like(leaf_off)
    return {
        "cfg_off": np.stack([leaf_off, node_off, dfa_off, lvl_off, kid_off,
                             zero, zero, zero], axis=1).astype(np.int32),
        "leaf_rec": leaf_rec, "node_rec": node_rec,
        "node_kids": node_kids.astype(np.int32), "lvl_end": lvl_end,
        "dfa_rec": dfa_rec, "ev": ev.astype(np.uint32).view(np.int32),
        "dfa_image": image, "tab_bytes": int(tab_bytes), "S": S,
        "max_local": max_local, "max_kids": int(np.diff(kid_off).max(initial=0)),
    }


def _put(x, device):
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _put(v, device) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_put(v, device) for v in x)
    if isinstance(x, int):
        return x
    if isinstance(x, torch.Tensor):
        return x.contiguous().to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def host_array(x) -> np.ndarray:
    """A host operand as numpy: a bf16 CPU tensor (numpy has no bf16) as
    its int16 bit pattern, so byte comparisons and sizes stay exact."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    return np.asarray(x)


def host_view(tree: dict) -> dict:
    """The host step of an upload: a numpy operand tree of any lane,
    validated, plus on the fused lane the ``"kernel"`` subtree (the
    per-config program) and on the other lanes the ``"bounds"`` dict — the
    whole tree the device reads, as numpy arrays (bf16 matrices as CPU
    tensors) and python ints.  The range checks run on every call, for
    every lane, so no tree reaches the device without them."""
    host = {k: v for k, v in tree.items() if k not in ("kernel", "bounds")}
    if host.get("fused") is not None:
        host["kernel"] = _kernel_layout(host)
    else:
        host["bounds"] = _check_tree(host)
    return host


def params_from_numpy(tree: dict, device=None) -> dict:
    """The weight carry-over: a numpy operand tree of any lane (the port's
    ``host_operands`` or the JAX package's ``to_device(policy, host=True,
    lane=...)``) → the port's tensor tree on ``device``, validated
    (``host_view``)."""
    dev = resolve_device(device)
    return _put(host_view(tree), dev)


def to_device(policy: CompiledPolicy, device=None, host: bool = False,
              lane: Optional[str] = None) -> dict:
    """``pattern_eval.to_device``, the one definition: one compiled
    corpus's operands for the resolved lane (``host=True``: the numpy
    tree, no device needed)."""
    from .pattern_eval import to_device as _to_device

    return _to_device(policy, device=device, lane=lane, host=host)


def check_batch(params: dict, db) -> None:
    """Raise unless every index the params take into this batch's operands
    lies in range — the kernel reads without bounds checks."""
    bd = (params["kernel"] if params.get("fused") is not None
          else params)["bounds"]
    A = db.attrs_val.shape[1]
    M = db.members_c.shape[1]
    if bd["attr"] >= A:
        raise ValueError(f"leaf_attr reaches attr {bd['attr']} of a [B, {A}] batch")
    if bd["member"] >= M:
        raise ValueError(f"member_slot_of_leaf reaches slot {bd['member']} "
                         f"of a [B, {M}, K] batch")
    C = int(params["cpu_scatter_idx"].shape[0])
    if db.cpu_dense.shape[1] != C:
        raise ValueError(f"batch carries {db.cpu_dense.shape[1]} CPU-lane "
                         f"columns, the corpus {C}")
    if db.member_ovf is not None and db.member_ovf.shape[1] != M:
        raise ValueError("member_ovf does not match the membership slots")
    if params["dfa_tables"] is not None and db.attr_bytes is not None:
        if db.byte_ovf is None or bd["byte"] >= db.attr_bytes.shape[1]:
            raise ValueError("DFA byte slots exceed the batch's byte tensor")
    if params["leaf_num_slot"] is not None and db.attrs_num is not None:
        if db.num_valid is None or bd["num"] >= db.attrs_num.shape[1]:
            raise ValueError("leaf_num_slot exceeds the batch's numeric slots")
    if params["rel_bits"] is not None and db.rel_rows is not None:
        if bd["rel"] >= db.rel_rows.shape[1]:
            raise ValueError("leaf_rel_slot exceeds the batch's relation slots")
        _check_range("rel_rows", db.rel_rows, 0, bd["rel_rows"])


# ---------------------------------------------------------------------------
# bitpacked readback decode (host)
# ---------------------------------------------------------------------------


def packed_width(n_cols: int) -> int:
    """Bitmask bytes per row for an ``n_cols``-wide packed bool result."""
    return (n_cols + 7) // 8


def unpack_verdicts(arr, n_cols: int) -> np.ndarray:
    """Host-side decode of a [B, W] uint8 bitmask readback (little bit
    order: bit j of byte k is column 8k+j) to a [B, n_cols] bool matrix."""
    a = np.asarray(arr)
    return np.unpackbits(a, axis=1, bitorder="little")[:, :n_cols].astype(bool)


def firing_columns(own_rule: np.ndarray, own_skipped: np.ndarray) -> np.ndarray:
    """Per row, the first evaluator column that evaluated false and was not
    condition-skipped, or -1 for allowed rows."""
    fired = ~np.asarray(own_skipped, dtype=bool) & ~np.asarray(
        own_rule, dtype=bool)                                  # [B, E]
    first = fired.argmax(axis=1).astype(np.int32)              # [B]
    first[~fired.any(axis=1)] = -1
    return first


def unpack_attribution(packed, n_evaluators: int):
    """[B, W] readback → (verdict [B] uint8, firing [B] int32); bit 0 is the
    own verdict, bits 1..E the rule results, E+1..2E the skipped flags."""
    E = n_evaluators
    cols = unpack_verdicts(packed, 1 + 2 * E)
    verdict = cols[:, 0].astype(np.uint8)
    firing = firing_columns(cols[:, 1:1 + E], cols[:, 1 + E:1 + 2 * E])
    return verdict, firing


# ---------------------------------------------------------------------------
# fused H2D staging: one host→device copy per micro-batch
# ---------------------------------------------------------------------------

FUSED_FIELDS = ("attrs_val", "members_c", "cpu_dense", "config_id",
                "attr_bytes", "byte_ovf", "attrs_num", "num_valid",
                "rel_rows", "member_ovf")

_TORCH_DTYPES = {"bool": torch.bool, "uint8": torch.uint8,
                 "int16": torch.int16, "int32": torch.int32}


def fuse_batch(db) -> Tuple[np.ndarray, tuple]:
    """(staging buffer [N] uint8, layout) for one DeviceBatch.  The layout
    is one (field, dtype, shape, offset, nbytes) per present operand, in
    ``FUSED_FIELDS`` order, packed with no alignment padding."""
    segs = []
    layout = []
    off = 0
    for name in FUSED_FIELDS:
        arr = getattr(db, name)
        if arr is None:
            continue
        a = np.ascontiguousarray(arr)
        flat = a.view(np.uint8).reshape(-1)
        layout.append((name, str(a.dtype), tuple(a.shape), off, flat.size))
        segs.append(flat)
        off += flat.size
    return np.concatenate(segs), tuple(layout)


def staged_h2d_bytes(db) -> int:
    """Exact bytes one batch stages host to device (the fused buffer size)."""
    total = 0
    for name in FUSED_FIELDS:
        arr = getattr(db, name)
        if arr is not None:
            total += arr.nbytes
    return total


def defuse(buf: torch.Tensor, layout: tuple) -> Dict[str, Any]:
    """Decode the operands out of a staging buffer tensor (any device)."""
    out = {}
    for name, dt, shape, off, size in layout:
        seg = buf[off:off + size]
        if dt == "bool":
            out[name] = seg.reshape(shape) != 0
        elif dt == "uint8":
            out[name] = seg.reshape(shape)
        else:
            # clone: a view at an odd byte offset cannot be reinterpreted
            out[name] = seg.clone().view(_TORCH_DTYPES[dt]).reshape(shape)
    return out
