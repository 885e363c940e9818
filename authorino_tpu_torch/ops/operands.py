"""Operand and readback layer of the fused lane (host numpy + torch).

Everything that surrounds the mega-kernel and runs on the host lives here:

  - ``host_operands`` builds the fused-lane operand tree of one compiled
    corpus as numpy arrays, with ``None`` kept structural for absent lanes;
  - ``params_from_numpy`` turns such a tree into torch tensors on a device,
    checks on the host that every index operand lies in range (so the kernel
    needs no bounds checks), and adds the ``"kernel"`` subtree: the circuit
    levels flattened into one children array plus a per-level table;
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

from ..compiler.compile import CompiledPolicy

__all__ = [
    "resolve_device", "host_operands", "fused_operands", "params_from_numpy",
    "to_device", "check_batch", "packed_width", "unpack_verdicts",
    "firing_columns", "unpack_attribution", "FUSED_FIELDS", "fuse_batch",
    "staged_h2d_bytes", "defuse",
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


def host_operands(policy: CompiledPolicy) -> dict:
    """Numpy operand tree of the fused lane.  Leaf for leaf (names, dtypes,
    shapes, ``None`` structure) the same tree the JAX package uploads for
    its fused lane."""
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
    return {
        "matmul": None,
        "fused": {k: a(v) for k, v in
                  fused_operands(policy, dfa_byte_slot).items()},
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


def _kernel_layout(tree: dict) -> dict:
    """Validate the tree's internal indices and flatten the circuit for the
    kernel.  Returns host numpy arrays plus python ints:

      - ``children`` / ``is_and``: every level's rows, concatenated;
      - ``level_meta`` [n_levels, 4] int32: (rows, width, offset into
        ``children``, buffer index of the level's first node);
      - ``buf_size``: 2 + L + Σ rows, the circuit buffer of one request;
      - ``bounds``: the largest index each leaf operand takes into a batch
        operand, checked against each batch's shapes by ``check_batch``."""
    fz = tree["fused"]
    L = int(tree["leaf_op"].shape[0])
    for name in ("leaf_attr", "leaf_const", "member_slot_of_leaf"):
        if tree[name].shape != (L,):
            raise ValueError(f"operand {name} has shape {tree[name].shape}, "
                             f"expected ({L},)")
    for name, arr in (("leaf_op_i8", fz["leaf_op_i8"]),
                      ("leaf_dfa_pos", fz.get("leaf_dfa_pos")),
                      ("leaf_num_slot", tree["leaf_num_slot"]),
                      ("leaf_rel_slot", tree["leaf_rel_slot"]),
                      ("leaf_rel_col", tree["leaf_rel_col"])):
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

    children, is_and, meta = [], [], []
    base, off = 2 + L, 0
    for lv, (ch, ia) in enumerate(tree["levels"]):
        rows, width = int(ch.shape[0]), int(ch.shape[1])
        if ia.shape != (rows,):
            raise ValueError(f"level {lv}: is_and does not match children")
        _check_range(f"levels[{lv}].children", ch, 0, base)
        children.append(np.ascontiguousarray(ch, dtype=np.int32).reshape(-1))
        is_and.append(np.asarray(ia, dtype=bool))
        meta.append((rows, width, off, base))
        off += rows * width
        base += rows
    buf_size = base
    G, E = tree["eval_rule"].shape
    for name in ("eval_cond", "eval_rule", "eval_has_cond"):
        if tree[name].shape != (G, E):
            raise ValueError(f"operand {name} is not [{G}, {E}]")
    _check_range("eval_cond", tree["eval_cond"], 0, buf_size)
    _check_range("eval_rule", tree["eval_rule"], 0, buf_size)

    bounds = {
        "attr": _max_or(tree["leaf_attr"]),
        "member": _max_or(tree["member_slot_of_leaf"]),
        "byte": -1, "num": -1, "rel": -1, "rel_rows": 0,
    }
    if tree["dfa_tables"] is not None:
        T, S, nc = tree["dfa_tables"].shape
        if nc != 256 or tree["dfa_accept"].shape != (T, S):
            raise ValueError("dfa_tables/dfa_accept are not [T, S, 256]/[T, S]")
        _check_range("dfa_tables", tree["dfa_tables"], 0, S)
        R = int(fz["dfa_table_of_row_g"].shape[0])
        if fz["dfa_byte_slot_g"].shape != (R,):
            raise ValueError("dfa_byte_slot_g does not match the DFA rows")
        _check_range("dfa_table_of_row_g", fz["dfa_table_of_row_g"], 0, T)
        _check_range("dfa_byte_slot_g", fz["dfa_byte_slot_g"], 0, 1 << 31)
        _check_range("leaf_dfa_pos", fz["leaf_dfa_pos"], 0, R)
        bounds["byte"] = _max_or(fz["dfa_byte_slot_g"])
    if tree["leaf_num_slot"] is not None:
        _check_range("leaf_num_slot", tree["leaf_num_slot"], 0, 1 << 31)
        bounds["num"] = _max_or(tree["leaf_num_slot"])
    if tree["rel_bits"] is not None:
        Rp, RW = tree["rel_bits"].shape
        _check_range("leaf_rel_slot", tree["leaf_rel_slot"], 0, 1 << 31)
        _check_range("leaf_rel_col", tree["leaf_rel_col"], 0, RW * 8)
        bounds["rel"] = _max_or(tree["leaf_rel_slot"])
        bounds["rel_rows"] = int(Rp)
    return {
        "children": (np.concatenate(children) if children
                     else np.zeros((0,), np.int32)),
        "is_and": (np.concatenate(is_and) if is_and
                   else np.zeros((0,), bool)),
        "level_meta": np.asarray(meta, dtype=np.int32).reshape(-1, 4),
        "buf_size": int(buf_size),
        "bounds": bounds,
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
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def params_from_numpy(tree: dict, device=None) -> dict:
    """The weight carry-over: a fused-lane numpy operand tree (the port's
    ``host_operands`` or the JAX package's ``to_device(policy, host=True,
    lane="fused")``) → the port's tensor tree on ``device``, validated, with
    the ``"kernel"`` layout subtree added."""
    dev = resolve_device(device)
    host = {k: v for k, v in tree.items() if k != "kernel"}
    host["kernel"] = _kernel_layout(host)
    return _put(host, dev)


def to_device(policy: CompiledPolicy, device=None, host: bool = False) -> dict:
    """Upload one compiled corpus's fused-lane operands.  ``host=True``
    returns the numpy tree instead (no device needed)."""
    tree = host_operands(policy)
    if host:
        return tree
    return params_from_numpy(tree, device)


def check_batch(params: dict, db) -> None:
    """Raise unless every index the params take into this batch's operands
    lies in range — the kernel reads without bounds checks."""
    bd = params["kernel"]["bounds"]
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
