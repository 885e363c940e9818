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
from .operands import check_batch, defuse, fuse_batch, packed_width

__all__ = [
    "fused_packed_plain", "eval_fused_kernel", "launch_kernel",
    "dispatch_megakernel", "MegakernelHandle", "fused_kernel_supported",
    "launch_probe", "probe_plain",
    "prewarm_fused", "occupancy_pad", "reset_counts", "launches",
    "probe_launches", "plain_calls", "smem_bytes", "SMEM_LIMIT",
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
    "leaf_op", "leaf_attr", "leaf_const", "member_slot_of_leaf",
    "cpu_scatter_idx", "L", "children", "is_and", "level_meta", "n_levels",
    "buf_size", "eval_cond", "eval_rule", "eval_has_cond", "G", "E", "W",
    "dfa_tables", "dfa_accept", "dfa_tab_g", "dfa_slot_g", "leaf_dfa_pos",
    "S", "R", "leaf_num_slot", "rel_bits", "leaf_rel_slot", "leaf_rel_col",
    "RW",
)
_MAGIC = 0x4155544846555345


def _lib() -> ctypes.CDLL:
    lib = _build.load_library("fused_kernel")
    if not getattr(lib, "_authz_typed", False):
        lib.authz_fused_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        lib.authz_fused_launch.restype = ctypes.c_int
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


def smem_bytes(params, A: int = 0, MK: int = 0) -> int:
    """Dynamic shared memory one block of the kernel takes: the circuit
    buffer, one accept byte per DFA row, then (4-byte aligned) the row's
    ``A`` attr ids and ``MK`` membership ids as int32."""
    R = (int(params["fused"]["dfa_table_of_row_g"].shape[0])
         if params["dfa_tables"] is not None else 0)
    head = int(params["kernel"]["buf_size"]) + R
    return (head + 3) // 4 * 4 + 4 * (A + MK)


# every param tensor the kernel reads through a raw pointer: (subtree, name,
# the element type the kernel reads it as)
_KERNEL_PARAMS = (
    ("fused", "leaf_op_i8", torch.int8), (None, "leaf_attr", torch.int32),
    (None, "leaf_const", torch.int32),
    (None, "member_slot_of_leaf", torch.int32),
    (None, "cpu_scatter_idx", torch.int32), (None, "eval_cond", torch.int32),
    (None, "eval_rule", torch.int32), (None, "eval_has_cond", torch.bool),
    ("kernel", "children", torch.int32), ("kernel", "is_and", torch.bool),
    ("kernel", "level_meta", torch.int32), (None, "dfa_tables", torch.uint8),
    (None, "dfa_accept", torch.bool),
    ("fused", "dfa_table_of_row_g", torch.int32),
    ("fused", "dfa_byte_slot_g", torch.int32),
    ("fused", "leaf_dfa_pos", torch.int32),
    (None, "leaf_num_slot", torch.int32), (None, "rel_bits", torch.uint8),
    (None, "leaf_rel_slot", torch.int32), (None, "leaf_rel_col", torch.int32),
)


def _check_kernel_tensors(params, dev: torch.device) -> None:
    for sub, name, dtype in _KERNEL_PARAMS:
        t = (params[sub] if sub else params).get(name)
        if t is None:
            continue
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"param {name} must be a contiguous {dtype} "
                             f"tensor on {dev}")


def launch_kernel(params, buf_dev: torch.Tensor, layout: tuple,
                  out: torch.Tensor) -> None:
    """Launch the kernel once over a staging buffer already on the card,
    writing ``out`` [B, W] uint8.  Enqueues on the current stream and does
    not synchronise."""
    global launches
    dev = buf_dev.device
    if dev.type != "cuda":
        raise ValueError("launch_kernel takes CUDA tensors only")
    if buf_dev.dtype != torch.uint8 or not buf_dev.is_contiguous():
        raise ValueError("staging buffer must be a contiguous uint8 tensor")
    _check_kernel_tensors(params, dev)
    lay = {name: (dt, shape, off) for name, dt, shape, off, _ in layout}
    dt_val, (B, A), off_val = lay["attrs_val"]
    _, (_, M, K), off_mem = lay["members_c"]
    smem = smem_bytes(params, A, M * K)
    if smem > SMEM_LIMIT:
        raise RuntimeError(
            f"one row needs {smem} B of shared memory, over the card's "
            f"{SMEM_LIMIT} B per block")
    fz, kp = params["fused"], params["kernel"]
    G, E = params["eval_rule"].shape
    W = packed_width(1 + 2 * E)
    if tuple(out.shape) != (B, W) or out.dtype != torch.uint8 \
            or out.device != dev or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous [{B}, {W}] uint8 tensor")
    if lay["members_c"][0] != dt_val or dt_val not in ("int16", "int32"):
        raise ValueError("attrs_val and members_c must share an int16/int32 "
                         "wire dtype")

    def off(name):
        return lay[name][2] if name in lay else -1

    def dim(name, axis):
        return lay[name][1][axis] if name in lay else 0

    has_dfa = params["dfa_tables"] is not None
    w = dict(
        magic=_MAGIC, out=_ptr(out), buf=_ptr(buf_dev), B=B,
        wide=int(dt_val == "int32"),
        off_attrs_val=off_val, off_members_c=off_mem,
        off_cpu_dense=off("cpu_dense"), off_config_id=off("config_id"),
        off_attr_bytes=off("attr_bytes"), off_byte_ovf=off("byte_ovf"),
        off_attrs_num=off("attrs_num"), off_num_valid=off("num_valid"),
        off_rel_rows=off("rel_rows"), off_member_ovf=off("member_ovf"),
        A=A, M=M, K=K, C=dim("cpu_dense", 1), NB=dim("attr_bytes", 1),
        LB=dim("attr_bytes", 2), NN=dim("attrs_num", 1),
        NR=dim("rel_rows", 1),
        leaf_op=_ptr(fz["leaf_op_i8"]), leaf_attr=_ptr(params["leaf_attr"]),
        leaf_const=_ptr(params["leaf_const"]),
        member_slot_of_leaf=_ptr(params["member_slot_of_leaf"]),
        cpu_scatter_idx=_ptr(params["cpu_scatter_idx"]),
        L=int(params["leaf_op"].shape[0]),
        children=_ptr(kp["children"]), is_and=_ptr(kp["is_and"]),
        level_meta=_ptr(kp["level_meta"]),
        n_levels=int(kp["level_meta"].shape[0]), buf_size=kp["buf_size"],
        eval_cond=_ptr(params["eval_cond"]),
        eval_rule=_ptr(params["eval_rule"]),
        eval_has_cond=_ptr(params["eval_has_cond"]), G=G, E=E, W=W,
        dfa_tables=_ptr(params["dfa_tables"]),
        dfa_accept=_ptr(params["dfa_accept"]),
        dfa_tab_g=_ptr(fz.get("dfa_table_of_row_g")),
        dfa_slot_g=_ptr(fz.get("dfa_byte_slot_g")),
        leaf_dfa_pos=_ptr(fz.get("leaf_dfa_pos")),
        S=int(params["dfa_tables"].shape[1]) if has_dfa else 0,
        R=int(fz["dfa_table_of_row_g"].shape[0]) if has_dfa else 0,
        leaf_num_slot=_ptr(params["leaf_num_slot"]),
        rel_bits=_ptr(params["rel_bits"]),
        leaf_rel_slot=_ptr(params["leaf_rel_slot"]),
        leaf_rel_col=_ptr(params["leaf_rel_col"]),
        RW=int(params["rel_bits"].shape[1])
        if params["rel_bits"] is not None else 0,
    )
    words = np.array([w[f] for f in _ARG_FIELDS], dtype=np.int64)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.authz_fused_launch(
            words.ctypes.data, len(_ARG_FIELDS), smem, stream)
    _raise_on(lib, err, "fused mega-kernel launch")
    launches += 1


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
        if smem_bytes(params) > SMEM_LIMIT:
            raise RuntimeError(
                f"corpus circuit needs {smem_bytes(params)} B of shared "
                f"memory per row, over the card's {SMEM_LIMIT} B per block")
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
