#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

  1. the card: ``nvidia-smi`` name and power limit, torch's device name;
  2. build the CUDA kernels from ``authorino_tpu_torch/ops/csrc`` with nvcc
     and launch the probe kernel;
  3. the mega-kernel against its plain PyTorch version on the card, byte
     for byte: the all-lanes corpus at 3 seeds with ovf-assist on and off
     on both wire dtypes, and the north-star corpus (1000 AuthConfigs × 10
     rules, members_k 16) at B ∈ {16, 256} and LB ∈ {16, 64};
  4. the main path: a PolicyEngine on the north-star corpus (max_batch
     256) answers 4,096 concurrent submits; every verdict must equal the
     expression oracle, every batch one launch and a pad × W readback;
  5. numbers: kernel, plain-version and transfer times at B = 256, and
     the engine's decisions/s and batch latency, beside the card's name
     and power limit.

The last lines are the kernels' JSON summary, the card line and
``{"ok": true, "device": {...}}``.  Everything measured also goes to
``smoke_out/chip_smoke.json`` (gitignored).
"""

from __future__ import annotations

import asyncio
import json
import random
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
# H100 SXM peak INT32 rate, 33.5 TOPS (NVIDIA H100 Tensor Core GPU
# Architecture whitepaper, SXM5 column; an IMAD counted as two operations)
INT32_OPS_PER_S = 33.5e12
T0 = time.monotonic()


def log(msg: str) -> None:
    print(f"[{time.monotonic() - T0:7.1f}s] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi printed no card")
    return out[0]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def kernel_vs_plain(params, db, dev):
    """One launch through the wrapper against the plain version on the
    same card, same inputs; returns the max abs byte difference."""
    import torch

    from authorino_tpu_torch.ops import fused_kernel as fk
    from authorino_tpu_torch.ops.operands import defuse, fuse_batch

    got = fk.eval_fused_kernel(params, db)
    buf, layout = fuse_batch(db)
    want = fk.fused_packed_plain(
        params, defuse(torch.from_numpy(buf).to(dev), layout))
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != torch.uint8:
        raise AssertionError(f"kernel output {tuple(got.shape)} {got.dtype} "
                             f"vs plain {tuple(want.shape)}")
    err = int((got.int() - want.int()).abs().max().item()) if got.numel() else 0
    if err != 0:
        bad = (got != want).any(dim=1).nonzero().flatten()[:8].tolist()
        raise AssertionError(f"kernel disagrees with plain on rows {bad}")
    return err


def device_times_ms(fn, n: int, warm: int = 3):
    """Per-call device times, ms: CUDA events around each call, with the
    stream held busy (``torch.cuda._sleep``) while the host enqueues the
    call, so the events time the device's work and not the host's Python.
    Also returns the host's median enqueue time of one call, ms."""
    import torch

    host = []
    for _ in range(warm):
        t = time.perf_counter()
        fn()
        host.append(time.perf_counter() - t)
        torch.cuda.synchronize()
    # hold the stream for 4x the host's enqueue time (at >= 1 GHz)
    cycles = int(max(1e-3, 4 * max(host)) * 1e9)
    times = []
    for _ in range(n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        s.record()
        t = time.perf_counter()
        fn()
        host.append(time.perf_counter() - t)
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return times, statistics.median(host) * 1e3


def wall_times_ms(fn, n: int, warm: int = 3):
    """Host wall time of ``fn`` through a synchronise, ms per call."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return times


def own_config_ops(params, K: int, LB: int):
    """Integer operations one request needs, per config: a row's output is
    only its own config's verdict, rule[E] and skipped[E], so it needs the
    leaves and circuit nodes its config's evaluators reach, and the DFA
    rows those leaves read.  A leaf costs one compare or lookup (K for a
    membership leaf), a DFA row LB table steps plus its accept lookup, a
    node one operation per child that is not its padding, an evaluator 3."""
    import numpy as np

    from authorino_tpu_torch.compiler.compile import (
        OP_EXCL, OP_INCL, OP_REGEX_DFA)

    fz, kp = params["fused"], params["kernel"]
    op = fz["leaf_op_i8"].cpu().numpy()
    L = op.size
    leaf_cost = np.where(np.isin(op, (OP_INCL, OP_EXCL)), K, 1)
    dfa_pos = (fz["leaf_dfa_pos"].cpu().numpy()
               if LB and fz.get("leaf_dfa_pos") is not None else None)
    flat = kp["children"].cpu().numpy()
    is_and = kp["is_and"].cpu().numpy()
    node_children = []
    for rows, width, off, _ in kp["level_meta"].cpu().numpy().tolist():
        node_children.extend(flat[off:off + rows * width].reshape(rows, width))
    cond = params["eval_cond"].cpu().numpy()
    rule = params["eval_rule"].cpu().numpy()
    has_cond = params["eval_has_cond"].cpu().numpy()
    G, E = rule.shape
    per_config = np.zeros(G, dtype=np.int64)
    for g in range(G):
        stack = list(rule[g]) + list(cond[g][has_cond[g]])
        seen, dfa_rows, ops = set(), set(), 3 * E
        while stack:
            i = int(stack.pop())
            if i < 2 or i in seen:
                continue
            seen.add(i)
            if i < 2 + L:
                ops += int(leaf_cost[i - 2])
                if dfa_pos is not None and op[i - 2] == OP_REGEX_DFA:
                    dfa_rows.add(int(dfa_pos[i - 2]))
                continue
            n = i - 2 - L
            pad = 0 if is_and[n] else 1
            kids = [int(c) for c in node_children[n] if c != pad]
            ops += len(kids)
            stack.extend(kids)
        per_config[g] = ops + len(dfa_rows) * (LB + 1)
    return per_config


def kernel_work(params, db):
    """Bytes the kernel must move (each input once, the output once) and
    the integer operations this batch's rows need (``own_config_ops`` of
    each row's config; a pad row with no config needs none)."""
    import numpy as np

    from authorino_tpu_torch.ops.operands import staged_h2d_bytes

    def nbytes(x):
        if x is None:
            return 0
        if isinstance(x, dict):
            return sum(nbytes(v) for k, v in x.items())
        if isinstance(x, tuple):
            return sum(nbytes(v) for v in x)
        if hasattr(x, "element_size"):
            return x.numel() * x.element_size()
        return 0

    kp = params["kernel"]
    read = {k: params[k] for k in (
        "leaf_attr", "leaf_const", "member_slot_of_leaf", "cpu_scatter_idx",
        "eval_cond", "eval_rule", "eval_has_cond", "dfa_tables",
        "dfa_accept", "leaf_num_slot", "rel_bits", "leaf_rel_slot",
        "leaf_rel_col")}
    read["fused"] = params["fused"]
    read["kernel"] = {k: kp[k] for k in ("children", "is_and", "level_meta")}
    B = db.attrs_val.shape[0]
    E = int(params["eval_rule"].shape[1])
    W = (1 + 2 * E + 7) // 8
    moved = staged_h2d_bytes(db) + nbytes(read) + B * W

    has_dfa = params["dfa_tables"] is not None and db.attr_bytes is not None
    per_config = own_config_ops(params, db.members_c.shape[2],
                                db.attr_bytes.shape[2] if has_dfa else 0)
    cid = np.asarray(db.config_id, dtype=np.int64)
    own = cid[(cid >= 0) & (cid < per_config.size)]
    return int(moved), int(per_config[own].sum())


def bound_ms(moved: int, ops: int):
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


async def serve(engine, docs, names):
    return await asyncio.gather(*(engine.submit(d, n)
                                  for d, n in zip(docs, names)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    import numpy as np

    from authorino_tpu_torch.compiler import compile_corpus
    from authorino_tpu_torch.compiler.encode import encode_batch
    from authorino_tpu_torch.compiler.pack import pack_batch
    from authorino_tpu_torch.models import corpora, northstar
    from authorino_tpu_torch.models.policy_model import host_results
    from authorino_tpu_torch.ops import _build
    from authorino_tpu_torch.ops import fused_kernel as fk
    from authorino_tpu_torch.ops.operands import defuse, fuse_batch, to_device
    from authorino_tpu_torch.runtime import EngineEntry, PolicyEngine

    report = {}
    # ---- 1. the card ------------------------------------------------------
    card = card_line()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    report["card"] = card
    report["torch"] = [torch.__version__, torch.version.cuda]
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | device 0: {kind}")

    # ---- 2. build + probe -------------------------------------------------
    t = time.monotonic()
    _build.load_library("fused_kernel")
    report["build_s"] = time.monotonic() - t
    report["nvcc_s"] = _build.build_seconds("fused_kernel")
    log(f"built fused_kernel in {report['build_s']:.2f}s "
        f"(nvcc {report['nvcc_s']})")
    for line in _build.build_log("fused_kernel").splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    fk.fused_kernel_supported(dev)
    log("probe kernel: int32[4] + 1 round-trips")

    # ---- 3. kernel vs plain on the card -----------------------------------
    max_err = 0
    n_cases = 0
    for seed in (7, 19, 31):
        cfgs = corpora.all_lanes_corpus(seed)
        docs = corpora.all_lanes_docs(seed, 64)
        drng = random.Random(seed)
        names = [drng.choice(cfgs).name for _ in docs]
        for assist in (True, False):
            policy = compile_corpus(cfgs, members_k=corpora.LANES_K,
                                    ovf_assist=assist)
            params = to_device(policy, device=dev)
            rows = [policy.config_ids[n] for n in names]
            db = pack_batch(policy, encode_batch(policy, docs, rows))
            for d in (db, corpora.widen_wire(db)):
                max_err = max(max_err, kernel_vs_plain(params, d, dev))
                n_cases += 1
    log(f"all-lanes corpus: {n_cases} cases byte-equal to plain (tolerance 0)")

    t = time.monotonic()
    ns_cfgs = northstar.build_corpus(1000, 10)
    ns_policy = compile_corpus(ns_cfgs, members_k=16)
    ns_params = to_device(ns_policy, device=dev)
    report["northstar_compile_upload_s"] = time.monotonic() - t
    report["northstar_shapes"] = {
        "L": ns_policy.n_leaves, "A": ns_policy.n_attrs,
        "G": ns_policy.n_configs, "E": int(ns_policy.eval_rule.shape[1]),
        "levels": [list(c.shape) for c, _ in ns_policy.levels],
        "buf_size": int(ns_params["kernel"]["buf_size"]),
        "smem_bytes": fk.smem_bytes(ns_params),
        "dfa_rows": int(ns_policy.dfa_table_of_row.shape[0]),
        "dfa_tables": list(ns_policy.dfa_tables.shape)}
    log(f"north-star corpus compiled + uploaded in "
        f"{report['northstar_compile_upload_s']:.1f}s: "
        f"{report['northstar_shapes']}")
    ns_docs = northstar.build_docs(4096, seed=7)
    drng = random.Random(3)
    ns_names = [f"cfg-{drng.randrange(1000)}" for _ in ns_docs]
    ns_rows = [ns_policy.config_ids[n] for n in ns_names]
    batches = {}
    for B in (16, 256):
        enc = encode_batch(ns_policy, ns_docs[:B], ns_rows[:B])
        for LB, trim in ((16, True), (64, False)):
            db = pack_batch(ns_policy, enc, trim_bytes=trim)
            if db.attr_bytes.shape[2] != LB:
                raise AssertionError(f"LB {db.attr_bytes.shape[2]} != {LB}")
            max_err = max(max_err, kernel_vs_plain(ns_params, db, dev))
            batches[(B, LB)] = db
    log("north-star corpus: B in {16, 256} x LB in {16, 64} byte-equal "
        "to plain (tolerance 0)")

    # ---- 4. the main path -------------------------------------------------
    engine_entries = [EngineEntry(id=c.name, hosts=[c.name], rules=c)
                      for c in ns_cfgs]
    fk.reset_counts()
    engine = PolicyEngine(max_batch=256)
    engine.apply_snapshot(engine_entries)
    t = time.monotonic()
    out = asyncio.run(serve(engine, ns_docs, ns_names))
    wall = time.monotonic() - t
    main_launches = {"fused_megakernel": fk.launches,
                     "probe_add_one": fk.probe_launches}
    st = dict(engine.stats)
    policy = engine._snapshot.policy
    W = policy.fused_pack_w
    if not (st["launches"] == st["batches"] == fk.launches == 16):
        raise AssertionError(f"launches {fk.launches} vs batches {st}")
    if st["d2h_bytes"] != st["pad_rows"] * W or st["pad_rows"] != 4096:
        raise AssertionError(f"D2H {st['d2h_bytes']} != pad x W ({st})")
    if fk.probe_launches < 1:
        raise AssertionError("probe kernel did not run on the main path")
    wrong = 0
    allowed = 0
    for (rule, skipped), d, r in zip(out, ns_docs, ns_rows):
        own, w_rule, w_skip = host_results(policy, d, r)
        ran = ~w_skip
        ok = (bool(np.all(skipped | rule)) == own
              and skipped.tolist() == w_skip.tolist()
              and rule[ran].tolist() == w_rule[ran].tolist())
        wrong += not ok
        allowed += own
    if wrong:
        raise AssertionError(f"{wrong} of 4096 verdicts differ from the oracle")
    report["main_path"] = dict(st, requests=4096, wall_s=wall,
                               allowed=int(allowed),
                               launches=main_launches)
    log(f"main path: 4096 submits -> {st['batches']} batches, "
        f"{fk.launches} mega-kernel launches, {fk.probe_launches} probe, "
        f"D2H {st['d2h_bytes']} B = pad {st['pad_rows']} x W {W}; "
        f"all verdicts equal the oracle ({allowed} allowed)")

    # ---- 5. numbers -------------------------------------------------------
    db = batches[(256, 16)]
    buf, layout = fuse_batch(db)
    host_buf = torch.from_numpy(buf).pin_memory()
    buf_dev = host_buf.to(dev)
    kout = torch.empty((256, W), dtype=torch.uint8, device=dev)
    k_ms, k_host = device_times_ms(
        lambda: fk.launch_kernel(ns_params, buf_dev, layout, kout), 100)
    p_ms, p_host = device_times_ms(
        lambda: fk.fused_packed_plain(ns_params, defuse(buf_dev, layout)), 30)
    host_out = torch.empty((256, W), dtype=torch.uint8, pin_memory=True)

    def transfer():
        buf_dev.copy_(host_buf, non_blocking=True)
        host_out.copy_(kout, non_blocking=True)

    x_ms, _ = device_times_ms(transfer, 100)
    # one batch through the wrapper as the engine calls it: stage, H2D,
    # launch, D2H into pinned memory, wait
    w_ms = wall_times_ms(
        lambda: np.asarray(fk.dispatch_megakernel(ns_params, db)), 100)
    moved, ops = kernel_work(ns_params, db)
    k_bound, k_by = bound_ms(moved, ops)
    probe_x = torch.arange(4, dtype=torch.int32, device=dev)
    pr_err = int((fk.launch_probe(probe_x) - fk.probe_plain(probe_x))
                 .abs().max().item())
    if pr_err != 0:
        raise AssertionError(f"probe kernel disagrees with plain by {pr_err}")
    pr_ms, pr_host = device_times_ms(lambda: fk.launch_probe(probe_x), 100)
    prp_ms, _ = device_times_ms(lambda: fk.probe_plain(probe_x), 100)
    pr_bound, pr_by = bound_ms(32, 4)

    # engine throughput: three more 4,096-request runs on the warm engine
    runs = []
    for _ in range(3):
        engine.batch_latency_s.clear()
        t = time.monotonic()
        asyncio.run(serve(engine, ns_docs, ns_names))
        runs.append((4096 / (time.monotonic() - t),
                     sorted(engine.batch_latency_s)))
    rates = [r for r, _ in runs]
    lat = sorted(x for _, ls in runs for x in ls)

    def pct(xs, q):
        return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]

    numbers = {
        "card": card,
        "kernel_ms_median": statistics.median(k_ms),
        "kernel_ms_min": min(k_ms),
        "kernel_launches_timed": len(k_ms),
        "kernel_host_enqueue_ms_median": k_host,
        "plain_ms_median": statistics.median(p_ms),
        "plain_host_enqueue_ms_median": p_host,
        "h2d_d2h_ms_median": statistics.median(x_ms),
        "wrapper_batch_wall_ms_median": statistics.median(w_ms),
        "h2d_bytes": int(buf.size), "d2h_bytes": 256 * W,
        "kernel_bytes_moved": moved, "kernel_int_ops": ops,
        "bound_ms": k_bound, "bound_by": k_by,
        "probe_ms_median": statistics.median(pr_ms),
        "probe_host_enqueue_ms_median": pr_host,
        "probe_plain_ms_median": statistics.median(prp_ms),
        "engine_decisions_per_s": rates,
        "engine_decisions_per_s_median": statistics.median(rates),
        "batch_latency_ms_p50": pct(lat, 0.50) * 1e3,
        "batch_latency_ms_p99": pct(lat, 0.99) * 1e3,
        "batches_timed": len(lat),
        "first_run_wall_s": wall,
    }
    report["numbers"] = numbers
    log(f"[{card}] mega-kernel B=256 LB=16: {numbers['kernel_ms_median']:.4f} "
        f"ms median of {len(k_ms)} (bound {k_bound:.6f} ms by {k_by}: "
        f"{moved} B, {ops} int ops); plain {numbers['plain_ms_median']:.3f} "
        f"ms; H2D {buf.size} B + D2H {256 * W} B "
        f"{numbers['h2d_d2h_ms_median']:.4f} ms; host enqueue of one launch "
        f"{k_host:.4f} ms; one batch through the wrapper "
        f"{numbers['wrapper_batch_wall_ms_median']:.4f} ms wall")
    log(f"[{card}] engine: {numbers['engine_decisions_per_s_median']:.0f} "
        f"decisions/s (runs {[round(r) for r in rates]}), batch latency "
        f"p50 {numbers['batch_latency_ms_p50']:.2f} ms p99 "
        f"{numbers['batch_latency_ms_p99']:.2f} ms over {len(lat)} batches")

    kernels = [
        {"name": "fused_megakernel", "route": "cuda",
         "source": "authorino_tpu_torch/ops/csrc/fused_kernel.cu",
         "replaces": "authorino_tpu/ops/fused_kernel.py:205",
         "launches": main_launches["fused_megakernel"],
         "max_abs_err": max_err, "ms": numbers["kernel_ms_median"],
         "plain_ms": numbers["plain_ms_median"], "bound_ms": k_bound,
         "bound_by": k_by, "library_ms": None},
        {"name": "probe_add_one", "route": "cuda",
         "source": "authorino_tpu_torch/ops/csrc/fused_kernel.cu",
         "replaces": "authorino_tpu/ops/fused_kernel.py:247",
         "launches": main_launches["probe_add_one"], "max_abs_err": pr_err,
         "ms": numbers["probe_ms_median"],
         "plain_ms": numbers["probe_plain_ms_median"], "bound_ms": pr_bound,
         "bound_by": pr_by, "library_ms": None},
    ]
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} never launched on the main path")
    report["kernels"] = kernels
    Path("smoke_out").mkdir(exist_ok=True)
    Path("smoke_out/chip_smoke.json").write_text(
        json.dumps(report, indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
