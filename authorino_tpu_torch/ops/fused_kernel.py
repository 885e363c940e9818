"""The fused mega-kernel: one micro-batch in one launch.

``eval_fused_kernel`` takes one packed batch and returns the [B, W] uint8
little-endian bitmask [own verdict, own rule[E], own skipped[E]] per row:

  - on a CUDA device it stages the batch's operands in one pinned uint8
    buffer (``operands.fuse_batch``), copies it to the card in one H2D
    transfer and launches the hand-written kernel of
    ``csrc/fused_kernel.cu`` once; a failed build or a refused launch
    raises;
  - on the CPU it decodes the same staging buffer and runs
    ``fused_packed_plain``, the plain PyTorch version of the same function
    (what the CPU tests compare with the JAX package, and what the card run
    compares the kernel with).

``launches`` counts kernel launches (CUDA only); ``plain_calls`` counts the
CPU path's calls of the plain version through the same entry point.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np
import torch

from ..compiler.compile import (
    OP_CPU, OP_EQ, OP_EXCL, OP_INCL, OP_NEQ, OP_NUM_GE,
    OP_NUM_GT, OP_NUM_LT, OP_REGEX_DFA, OP_RELATION, OP_TREE_CPU,
    CompiledPolicy)
from . import _build
from .operands import _round16, check_batch, defuse, fuse_batch, packed_width

__all__ = [
    "fused_packed_plain", "eval_fused_kernel", "launch_kernel",
    "dispatch_megakernel", "MegakernelHandle", "fused_kernel_supported",
    "launch_probe", "probe_plain",
    "prewarm_fused", "occupancy_pad", "reset_counts", "launches",
    "probe_launches", "plain_calls", "smem_bytes", "tables_in_smem",
    "launch_stamped", "forget_launch_words", "SMEM_LIMIT", "WARPS",
]

# kernel launches on the card (the wrapper adds one where it launches)
launches = 0
probe_launches = 0
# calls of the plain version through eval_fused_kernel (CPU tensors only)
plain_calls = 0

# dynamic shared memory one block may use on an H100 (232,448 bytes)
SMEM_LIMIT = 232448


def reset_counts() -> None:
    global launches, probe_launches, plain_calls
    launches = probe_launches = plain_calls = 0


# ---------------------------------------------------------------------------
# the plain PyTorch version
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


def _eval_verdicts_plain(params, ops):
    """Every config's verdict [B, G] and (rule, skipped) [B, G, E]."""
    fz = params["fused"]
    attrs_val = ops["attrs_val"].to(torch.int32)
    members_c = ops["members_c"].to(torch.int32)
    cpu_dense = ops["cpu_dense"]
    attr_bytes, byte_ovf = ops.get("attr_bytes"), ops.get("byte_ovf")
    attrs_num, num_valid = ops.get("attrs_num"), ops.get("num_valid")
    rel_rows, member_ovf = ops.get("rel_rows"), ops.get("member_ovf")
    leaf_op = fz["leaf_op_i8"].to(torch.int32)
    leaf_const = params["leaf_const"]
    B = attrs_val.shape[0]

    val = attrs_val[:, params["leaf_attr"].long()]                  # [B, L]
    eq = val == leaf_const[None, :]
    memb = members_c[:, params["member_slot_of_leaf"].long()]       # [B, L, K]
    incl = (memb == leaf_const[None, :, None]).any(dim=-1)
    cpu_lane = _cpu_full(params, cpu_dense)

    if params["dfa_tables"] is not None and attr_bytes is not None:
        tables = params["dfa_tables"]                     # [T, S, 256] uint8
        tab_idx = fz["dfa_table_of_row_g"].long()[None, :].expand(B, -1)
        row_bytes = attr_bytes[:, fz["dfa_byte_slot_g"].long()]  # [B, R, LB]
        states = torch.zeros(tab_idx.shape, dtype=torch.long,
                             device=attr_bytes.device)
        for i in range(row_bytes.shape[2]):
            states = tables[tab_idx, states, row_bytes[:, :, i].long()].long()
        dfa_row_res = params["dfa_accept"][tab_idx, states]         # [B, R]
        pos = fz["leaf_dfa_pos"].long()
        leaf_dfa = dfa_row_res[:, pos]
        leaf_bovf = byte_ovf[:, fz["dfa_byte_slot_g"].long()[pos]]
        dfa_leaf_val = torch.where(leaf_bovf, cpu_lane, leaf_dfa)
    else:
        dfa_leaf_val = cpu_lane  # regexes ride the CPU lane entirely

    num_cmp = None
    if params["leaf_num_slot"] is not None and attrs_num is not None:
        slot = params["leaf_num_slot"].long()
        lv, lok = attrs_num[:, slot], num_valid[:, slot]
        ic = leaf_const[None, :]
        num_cmp = (lok & (lv > ic), lok & (lv >= ic),
                   lok & (lv < ic), lok & (lv <= ic))

    rel_res = None
    if params["rel_bits"] is not None and rel_rows is not None:
        rows_l = rel_rows[:, params["leaf_rel_slot"].long()].long()
        col = params["leaf_rel_col"].long()
        byte = params["rel_bits"][rows_l, (col >> 3)[None, :]].long()
        rel_res = ((byte >> (col & 7)[None, :]) & 1) != 0

    leaf_movf = None
    if member_ovf is not None:
        leaf_movf = member_ovf[:, params["member_slot_of_leaf"].long()]

    res = _leaf_op_cascade(leaf_op, eq, incl, dfa_leaf_val, cpu_lane,
                           num_cmp, rel_res, leaf_movf)

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
    skipped = params["eval_has_cond"][None, :, :] & ~cond
    verdict = torch.where(skipped, True, rule).all(dim=-1)         # [B, G]
    return verdict, rule, skipped


def fused_packed_plain(params, ops: dict) -> torch.Tensor:
    """The plain PyTorch version of the kernel: every config's verdicts,
    then own-config select and the little-endian bitpack → [B, W] uint8.
    ``ops`` is the operand dict ``operands.defuse`` returns; absent lanes
    are absent keys."""
    verdict, rule, skipped = _eval_verdicts_plain(params, ops)
    G = verdict.shape[1]
    cid = ops["config_id"].to(torch.int64)
    own_mask = cid[:, None] == torch.arange(G, device=cid.device)[None, :]
    own = (verdict & own_mask).any(dim=1)
    own_rule = (rule & own_mask[:, :, None]).any(dim=1)
    own_skipped = (skipped & own_mask[:, :, None]).any(dim=1)
    cols = torch.cat([own[:, None], own_rule, own_skipped], dim=1)
    B, C = cols.shape
    W = packed_width(C)
    padded = torch.zeros((B, W * 8), dtype=torch.int32, device=cols.device)
    padded[:, :C] = cols.to(torch.int32)
    weights = (1 << torch.arange(8, dtype=torch.int32, device=cols.device))
    return (padded.reshape(B, W, 8) * weights).sum(dim=-1).to(torch.uint8)


# ---------------------------------------------------------------------------
# the CUDA kernel's wrapper
# ---------------------------------------------------------------------------

# word order of the kernel's argument block (csrc/fused_kernel.cu FusedArgs)
_ARG_FIELDS = (
    "magic", "out", "buf", "B", "wide",
    "off_attrs_val", "off_members_c", "off_cpu_dense", "off_config_id",
    "off_attr_bytes", "off_byte_ovf", "off_attrs_num", "off_num_valid",
    "off_rel_rows", "off_member_ovf",
    "A", "M", "K", "C", "NB", "LB", "NN", "NR",
    "cfg_off", "leaf_rec", "node_rec", "node_kids", "lvl_end", "dfa_rec",
    "ev", "G", "E", "W", "has_num", "dfa_image", "S", "tab_bytes",
    "image_bytes", "rel_bits", "RW",
    "smem_tables", "smem_head", "warp_bytes", "kids_at", "masks_at",
    "stage_at", "stage_bytes", "s_mc", "s_movf", "s_bovf", "s_ab", "s_num",
    "s_nv", "s_rel", "e_av", "e_mc", "e_movf", "e_bovf", "e_ab", "e_num",
    "e_nv",
)
_MAGIC = 0x4155544846555633
_IDX = {f: i for i, f in enumerate(_ARG_FIELDS)}
# the words one batch's layout sets (everything else comes from the params)
_BATCH_SLICE = slice(_IDX["B"], _IDX["NR"] + 1)
_STAGE_SLICE = slice(_IDX["stage_bytes"], _IDX["e_nv"] + 1)
# the operands a row stages in shared memory, in the kernel's order
STAGE_SEGMENTS = ("attrs_val", "members_c", "member_ovf", "byte_ovf",
                  "attr_bytes", "attrs_num", "num_valid", "rel_rows")
# rows (one warp each) per block, the kernel's kWarps (chosen on the card
# from 2, 4 and 8)
WARPS = 4


def _lib() -> ctypes.CDLL:
    lib = _build.load_library("fused_kernel")
    if not getattr(lib, "_authz_typed", False):
        lib.authz_fused_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        lib.authz_fused_launch.restype = ctypes.c_int
        lib.authz_fused_stamp_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.authz_fused_stamp_launch.restype = ctypes.c_int
        lib.authz_probe_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        lib.authz_probe_launch.restype = ctypes.c_int
        lib.authz_error_string.argtypes = [ctypes.c_int]
        lib.authz_error_string.restype = ctypes.c_char_p
        lib._authz_typed = True
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.authz_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what} failed: CUDA error {err}: {msg}")


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else int(t.data_ptr())


def _warp_layout(params, stage_bytes: int = 0):
    """(children, ballot words, stage, total) offsets and bytes of one
    warp's shared memory: the row's circuit buffer, the config's node
    children as uint16, two ballot words per 32 evaluators, then the row's
    staged operands, each part padded to 16 bytes."""
    kp = params["kernel"]
    E = int(params["eval_rule"].shape[1])
    kids_at = _round16(kp["max_local"])
    masks_at = kids_at + _round16(2 * kp["max_kids"])
    stage_at = masks_at + _round16(8 * ((E + 31) // 32))
    return kids_at, masks_at, stage_at, stage_at + _round16(stage_bytes)


def smem_bytes(params, tables_in_smem: bool = True,
               stage_bytes: int = 0) -> int:
    """Dynamic shared memory one block of the kernel takes: the DFA table
    image (when it is placed in shared memory and the corpus has one), a
    16-byte slot for the copy's mbarrier, then ``WARPS`` warp regions for
    rows that stage ``stage_bytes`` of operands each."""
    img = params["kernel"]["dfa_image"]
    head = (int(img.numel()) if tables_in_smem and img is not None else 0) + 16
    return head + WARPS * _warp_layout(params, stage_bytes)[3]


def tables_in_smem(params, stage_bytes: int = 0) -> bool:
    """Whether the DFA table image fits in shared memory beside the block's
    warp regions (else the kernel reads it from device memory)."""
    return (params["kernel"]["dfa_image"] is not None
            and smem_bytes(params, True, stage_bytes) <= SMEM_LIMIT)


# every param tensor the kernel reads through a raw pointer: (subtree, name,
# the element type the kernel reads it as)
_KERNEL_PARAMS = (
    ("kernel", "cfg_off", torch.int32), ("kernel", "leaf_rec", torch.int32),
    ("kernel", "node_rec", torch.int32), ("kernel", "node_kids", torch.int32),
    ("kernel", "lvl_end", torch.int32), ("kernel", "dfa_rec", torch.int32),
    ("kernel", "ev", torch.int32), ("kernel", "dfa_image", torch.uint8),
    (None, "rel_bits", torch.uint8),
)
# (name, columns, alignment in bytes) of the program's record arrays
_RECORDS = (("cfg_off", 8, 16), ("leaf_rec", 4, 16), ("node_rec", 4, 16),
            ("dfa_rec", 4, 16))


def _check_kernel_tensors(params, dev: torch.device) -> None:
    for sub, name, dtype in _KERNEL_PARAMS:
        t = (params[sub] if sub else params).get(name)
        if t is None:
            continue
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"param {name} must be a contiguous {dtype} "
                             f"tensor on {dev}")


def _param_words(params, dev: torch.device) -> np.ndarray:
    """The argument block with every params field filled in, built and
    checked once per params tree (cached in its ``"kernel"`` subtree; the
    tree's tensors are never replaced after upload)."""
    kp = params["kernel"]
    cached = kp.get("launch_words")
    if cached is not None and cached[0] == dev:
        return cached[1]
    _check_kernel_tensors(params, dev)
    G, E = params["eval_rule"].shape
    if tuple(kp["cfg_off"].shape) != (G + 1, 8) \
            or tuple(kp["ev"].shape) != (G, E):
        raise ValueError("the per-config program does not match the "
                         "evaluator table")
    for name, cols, align in _RECORDS:
        t = kp[name]
        if t.dim() != 2 or t.shape[1] != cols or t.data_ptr() % align:
            raise ValueError(f"program array {name} must be [*, {cols}] and "
                             f"{align}-byte aligned")
    img = kp["dfa_image"]
    if img is not None and (img.data_ptr() % 16 or img.numel() % 16):
        raise ValueError("dfa_image must be 16-byte aligned and padded")
    w = np.zeros(len(_ARG_FIELDS), dtype=np.int64)
    for name, value in (
            ("magic", _MAGIC), ("G", G), ("E", E),
            ("W", packed_width(1 + 2 * E)),
            ("has_num", int(params["leaf_num_slot"] is not None)),
            ("S", kp["S"]), ("tab_bytes", kp["tab_bytes"]),
            ("image_bytes", 0 if img is None else img.numel()),
            ("dfa_image", _ptr(img)), ("rel_bits", _ptr(params["rel_bits"])),
            ("RW", 0 if params["rel_bits"] is None
             else params["rel_bits"].shape[1]),
            *zip(("kids_at", "masks_at", "stage_at"), _warp_layout(params)),
            *((n, _ptr(kp[n])) for n in ("cfg_off", "leaf_rec", "node_rec",
                                         "node_kids", "lvl_end", "dfa_rec",
                                         "ev"))):
        w[_IDX[name]] = value
    kp["launch_words"] = (dev, w)
    kp["launch_layouts"] = {}
    return w


def _layout_words(params, layout: tuple) -> np.ndarray:
    """The batch's words of the argument block for one staging layout: B,
    wire, offsets and dims, then the row stage (``stage_layout``: its
    size, each segment's start after the first, each end but the last)."""
    lay = {name: (dt, shape, off) for name, dt, shape, off, _ in layout}
    dt_val, (B, A), off_val = lay["attrs_val"]
    if lay["members_c"][0] != dt_val or dt_val not in ("int16", "int32"):
        raise ValueError("attrs_val and members_c must share an int16/int32 "
                         "wire dtype")
    _, (_, M, K), off_mem = lay["members_c"]

    def off(name):
        return lay[name][2] if name in lay else -1

    def dim(name, axis):
        return lay[name][1][axis] if name in lay else 0

    vals = dict(
        B=B, wide=int(dt_val == "int32"),
        off_attrs_val=off_val, off_members_c=off_mem,
        off_cpu_dense=off("cpu_dense"), off_config_id=off("config_id"),
        off_attr_bytes=off("attr_bytes"), off_byte_ovf=off("byte_ovf"),
        off_attrs_num=off("attrs_num"), off_num_valid=off("num_valid"),
        off_rel_rows=off("rel_rows"), off_member_ovf=off("member_ovf"),
        A=A, M=M, K=K, C=dim("cpu_dense", 1), NB=dim("attr_bytes", 1),
        LB=dim("attr_bytes", 2), NN=dim("attrs_num", 1),
        NR=dim("rel_rows", 1))
    T, starts, ends = stage_layout(params, layout)
    return np.array([vals[f] for f in _ARG_FIELDS[_BATCH_SLICE]]
                    + [T, *starts[1:], *ends[:-1]], dtype=np.int64)


def stage_layout(params, layout: tuple):
    """(bytes, starts, ends) of one row's staged operands: one segment per
    operand of ``STAGE_SEGMENTS`` that the kernel reads (an absent lane's
    is empty), each starting 4-byte aligned so the kernel reads its ids,
    numbers and byte words at their width."""
    lay = {name: (dt, shape) for name, dt, shape, _, _ in layout}
    dfa = params["kernel"]["dfa_image"] is not None and "attr_bytes" in lay
    num = params["leaf_num_slot"] is not None and "attrs_num" in lay
    rel = params["rel_bits"] is not None and "rel_rows" in lay
    used = {"attrs_val": True, "members_c": True,
            "member_ovf": "member_ovf" in lay, "byte_ovf": dfa,
            "attr_bytes": dfa, "attrs_num": num, "num_valid": num,
            "rel_rows": rel}
    starts, ends, at = [], [], 0
    for name in STAGE_SEGMENTS:
        size = 0
        if used[name]:
            if name not in lay:
                raise ValueError(f"batch lacks {name} beside its lane")
            dt, shape = lay[name]
            size = int(np.prod(shape[1:])) * np.dtype(dt).itemsize
        at = (at + 3) // 4 * 4
        starts.append(at)
        at += size
        ends.append(at)
    return at, starts, ends


def forget_launch_words(params) -> None:
    """Drop the cached argument-block words of a params tree; the next
    launch rebuilds and re-checks them."""
    params["kernel"].pop("launch_words", None)
    params["kernel"].pop("launch_layouts", None)


def _launch_template(params, dev: torch.device, layout: tuple,
                     global_tables: bool):
    """(argument block without the out and buf pointers, dynamic shared
    memory) of one (layout, placement), built and checked once and cached
    beside the params words."""
    cache = params["kernel"]["launch_layouts"]
    key = (layout, global_tables)
    hit = cache.get(key)
    if hit is not None:
        return hit
    words = _param_words(params, dev).copy()
    lw = _layout_words(params, layout)
    n_batch = _BATCH_SLICE.stop - _BATCH_SLICE.start
    words[_BATCH_SLICE], words[_STAGE_SLICE] = lw[:n_batch], lw[n_batch:]
    stage = int(words[_IDX["stage_bytes"]])
    in_smem = not global_tables and tables_in_smem(params, stage)
    smem = smem_bytes(params, in_smem, stage)
    if smem > SMEM_LIMIT:
        raise RuntimeError(
            f"{WARPS} rows need {smem} B of shared memory, over the card's "
            f"{SMEM_LIMIT} B per block")
    warp_bytes = _warp_layout(params, stage)[3]
    words[_IDX["smem_tables"]] = int(in_smem)
    words[_IDX["warp_bytes"]] = warp_bytes
    words[_IDX["smem_head"]] = smem - WARPS * warp_bytes
    if len(cache) >= 64:
        cache.clear()
    cache[key] = (words, smem)
    return words, smem


def _words(params, buf_dev: torch.Tensor, layout: tuple, out: torch.Tensor,
           global_tables: bool):
    """(argument block, dynamic shared memory) of one launch."""
    dev = buf_dev.device
    if dev.type != "cuda":
        raise ValueError("launch_kernel takes CUDA tensors only")
    if buf_dev.dtype != torch.uint8 or not buf_dev.is_contiguous():
        raise ValueError("staging buffer must be a contiguous uint8 tensor")
    _param_words(params, dev)
    template, smem = _launch_template(params, dev, layout, global_tables)
    B, W = int(template[_IDX["B"]]), int(template[_IDX["W"]])
    if out.shape != (B, W) or out.dtype != torch.uint8 \
            or out.device != dev or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous [{B}, {W}] uint8 tensor")
    words = template.copy()
    words[_IDX["out"]] = out.data_ptr()
    words[_IDX["buf"]] = buf_dev.data_ptr()
    return words, smem


def launch_kernel(params, buf_dev: torch.Tensor, layout: tuple,
                  out: torch.Tensor, *, global_tables: bool = False) -> None:
    """Launch the kernel once over a staging buffer already on the card,
    writing ``out`` [B, W] uint8.  Enqueues on the current stream and does
    not synchronise.  The DFA tables go to shared memory where they fit;
    ``global_tables=True`` forces the instance that reads them from device
    memory."""
    global launches
    words, smem = _words(params, buf_dev, layout, out, global_tables)
    lib = _lib()
    dev = buf_dev.device
    with torch.cuda.device(dev):
        err = lib.authz_fused_launch(
            words.ctypes.data, len(_ARG_FIELDS), smem,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "fused mega-kernel launch")
    launches += 1


def launch_stamped(params, buf_dev: torch.Tensor, layout: tuple,
                   out: torch.Tensor, stamps: torch.Tensor, *,
                   global_tables: bool = False) -> None:
    """The instrumented instance, for measurement only: as
    ``launch_kernel``, and writes 8 ``clock64()`` words per row into
    ``stamps`` ([B, 8] int64 on the card): entry, then the end of the
    prologue, leaves, copy wait, DFA walk, circuit and verdict phases.  It
    is not a launch of the main path and is not counted."""
    words, smem = _words(params, buf_dev, layout, out, global_tables)
    B = int(words[_IDX["B"]])
    if stamps.shape != (B, 8) or stamps.dtype != torch.int64 \
            or stamps.device != buf_dev.device or not stamps.is_contiguous():
        raise ValueError(f"stamps must be a contiguous [{B}, 8] int64 tensor")
    lib = _lib()
    dev = buf_dev.device
    with torch.cuda.device(dev):
        err = lib.authz_fused_stamp_launch(
            words.ctypes.data, len(_ARG_FIELDS), smem, _ptr(stamps),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "stamped mega-kernel launch")


def _stage(buf: np.ndarray, dev: torch.device) -> torch.Tensor:
    """One pinned host buffer → one async H2D copy on the current stream."""
    host = torch.empty((buf.size,), dtype=torch.uint8, pin_memory=True)
    host.numpy()[:] = buf
    return host.to(dev, non_blocking=True)


def eval_fused_kernel(params, db) -> torch.Tensor:
    """One packed batch through the mega-kernel; returns the [B, W] uint8
    bitpacked result on the params' device (decode with
    ``operands.unpack_verdicts``)."""
    global plain_calls
    dev = params["leaf_op"].device
    check_batch(params, db)
    buf, layout = fuse_batch(db)
    if dev.type == "cpu":
        plain_calls += 1
        return fused_packed_plain(params, defuse(torch.from_numpy(buf), layout))
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    fused_kernel_supported(dev)
    E = int(params["eval_rule"].shape[1])
    out = torch.empty((db.attrs_val.shape[0], packed_width(1 + 2 * E)),
                      dtype=torch.uint8, device=dev)
    launch_kernel(params, _stage(buf, dev), layout, out)
    return out


class MegakernelHandle:
    """An in-flight batch: the [B, W] result copied asynchronously into
    pinned host memory.  ``is_ready()`` polls without blocking;
    ``np.asarray(handle)`` waits for the copy."""

    def __init__(self, out: torch.Tensor):
        self.nbytes = out.numel() * out.element_size()
        if out.device.type == "cpu":
            self._host, self._event = out, None
            return
        self._host = torch.empty(out.shape, dtype=torch.uint8,
                                 pin_memory=True)
        self._host.copy_(out, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record(torch.cuda.current_stream(out.device))

    def is_ready(self) -> bool:
        return self._event is None or self._event.query()

    def wait(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.wait()
        return a.astype(dtype) if dtype is not None else a


def dispatch_megakernel(params, db) -> MegakernelHandle:
    """Non-blocking launch of one batch; the D2H copy starts at once."""
    return MegakernelHandle(eval_fused_kernel(params, db))


# ---------------------------------------------------------------------------
# the probe, pre-warm, mesh occupancy shaping
# ---------------------------------------------------------------------------

_PROBED: Dict[str, bool] = {}


def probe_plain(x: torch.Tensor) -> torch.Tensor:
    """The probe kernel's plain version."""
    return x + 1


def launch_probe(x: torch.Tensor) -> torch.Tensor:
    """Launch the probe kernel once: int32 [n] → x + 1."""
    global probe_launches
    if x.device.type != "cuda" or x.dtype != torch.int32 \
            or not x.is_contiguous():
        raise ValueError("the probe takes a contiguous int32 CUDA tensor")
    y = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.authz_probe_launch(
            _ptr(x), _ptr(y), int(x.numel()),
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, err, "probe launch")
    probe_launches += 1
    return y


def fused_kernel_supported(device=None, recheck: bool = False) -> bool:
    """Build the kernels and round-trip the probe kernel (int32[4] + 1) on
    ``device``, once per device unless ``recheck``.  Returns True or
    raises: there is no other lane to degrade to."""
    dev = torch.device(device) if device is not None else torch.device("cuda")
    if dev.type != "cuda":
        raise ValueError("the probe runs on a CUDA device")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = str(dev)
    if recheck or key not in _PROBED:
        x = torch.arange(4, dtype=torch.int32, device=dev)
        got = launch_probe(x).cpu()
        if not torch.equal(got, torch.arange(1, 5, dtype=torch.int32)):
            raise RuntimeError(f"probe kernel returned {got.tolist()} on {dev}")
        _PROBED[key] = True
    return True


def prewarm_fused(policy: CompiledPolicy, params) -> bool:
    """Ready a freshly uploaded snapshot before it serves: on a card, build
    the kernels (first use) and run the probe on the snapshot's device; on
    the CPU, nothing to do.  Launches no mega-kernel, so the per-batch
    launch count stays exact.  False for params without the fused
    subtree."""
    if params is None or params.get("fused") is None:
        return False
    dev = params["leaf_op"].device
    if dev.type == "cuda":
        fused_kernel_supported(dev, recheck=True)
        need = smem_bytes(params, tables_in_smem=False)
        if need > SMEM_LIMIT:
            raise RuntimeError(
                f"the corpus's largest config needs {need} B of shared "
                f"memory per block of {WARPS} rows, over the card's "
                f"{SMEM_LIMIT} B")
    return True


def occupancy_pad(shard_counts, dp: int, n_rows: int,
                  floor: int = 16, cap: Optional[int] = None) -> int:
    """Per-shard occupancy-shaped batch pad for a mesh lane: the pow2
    bucket (≥ floor) of the busiest shard's row count replicated across the
    dp axis, never below the real row count, capped at ``cap`` (but never
    below the need)."""
    occ = max((int(c) for c in shard_counts), default=0)
    need = max(int(n_rows), occ * max(int(dp), 1), 1)
    pad = max(int(floor), 1)
    while pad < need:
        pad *= 2
    if cap is not None:
        pad = min(pad, max(int(cap), need))
    return pad
