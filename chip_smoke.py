#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

  1. the card: ``nvidia-smi`` name and power limit, torch's device name;
  2. build the CUDA kernels from ``authorino_tpu_torch/ops/csrc`` with nvcc
     and launch the probe kernel;
  3. the mega-kernel against its plain PyTorch version on the card, byte
     for byte: the all-lanes corpus at 3 seeds with ovf-assist on and off
     on both wire dtypes, a config past 64 circuit slots beside a small
     one, and the north-star corpus (1000 AuthConfigs × 10 rules,
     members_k 16) at B ∈ {16, 256} and LB ∈ {16, 64}; with the DFA tables
     in shared memory and with the global-tables instance forced;
  4. the main path: a PolicyEngine on the north-star corpus (max_batch
     256) answers 4,096 concurrent submits; every verdict must equal the
     expression oracle, every batch one launch and a pad × W readback;
  5. numbers, beside the card's name and power limit: at B = 256 with
     LB = 16 and 64 and at B = 16, the kernel's device time per call and
     per launch back to back (N launches between one event pair) with the
     tables in shared memory and in device memory, and the median
     per-phase clock64() stamps of the instrumented instance; the
     per-config program's size and host build time; the wrapper's host
     enqueue with its words cached and rebuilt; plain-version and
     transfer times; the probe's times and that of ``x + 1``; the
     engine's submit-only decisions/s and batch latency;
  6. the Check() request path: 1,000 north-star AuthConfigs (v1beta2
     specs, a plain identity over Envoy's jwt_authn claims) and the V2
     config of the control-plane tests translated with a card engine and
     installed in one snapshot; 4,096 concurrent ``engine.check()`` calls
     plus the V2 checks (with and without a key, an admin path, OPTIONS,
     ``host:port``, an unknown host), every result held to the expression
     oracle with its deny provenance, one launch per batch and a pad × W
     readback; then checks/s (median of 3 runs) and per-Check() latency
     p50/p99 beside the batch count, rows per batch and phase 5's
     submit-only decisions/s, and the latency of a lone Check() (200
     sent one at a time);
  7. the OPA request path: 1,000 AuthConfigs of the OPA corpus
     (``models/opa_corpus.py``: the phase-6 identity, one pattern and one
     inline Rego policy each, about nine in ten of which lower into a
     kernel slot) and one Kubernetes TokenReview + SubjectAccessReview
     config translated with a card engine into one snapshot; 4,096
     concurrent ``engine.check()`` calls plus the Kubernetes checks, every
     result held to the oracle (the pattern's verdict and deny provenance,
     then the interpreter's ``allow``), every batch one launch and a
     pad × W readback; every lowered config's kernel bit held to
     ``lower_verdict(module).matches(doc)`` and the interpreter's
     ``allow``; the mega-kernel's [256, W] readback on this corpus
     byte-equal to its plain version; then checks/s (median of 3 runs),
     per-Check() p50/p99 under the burst and alone, the share of configs
     lowered, the interpreter's host time per Check(), and the kernel's
     device time on this corpus beside its bound.

The kernels' launch counts in the summary are phase 7's; each kernel must
have launched on the paths of phases 4, 6 and 7, with the counts zeroed
just before each.

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


def kernel_vs_plain(params, db, dev, **instance):
    """One launch against the plain version on the same card, same inputs;
    returns the max abs byte difference.  With no ``instance`` keywords the
    launch goes through the wrapper as the engine calls it; else straight
    to ``launch_kernel`` with them (``global_tables``)."""
    import torch

    from authorino_tpu_torch.ops import fused_kernel as fk
    from authorino_tpu_torch.ops.operands import check_batch, defuse, fuse_batch

    buf, layout = fuse_batch(db)
    buf_dev = torch.from_numpy(buf).to(dev)
    if instance:
        check_batch(params, db)
        got = torch.empty((db.attrs_val.shape[0],
                           fk.packed_width(1 + 2 * params["eval_rule"].shape[1])),
                          dtype=torch.uint8, device=dev)
        fk.launch_kernel(params, buf_dev, layout, got, **instance)
    else:
        got = fk.eval_fused_kernel(params, db)
    want = fk.fused_packed_plain(params, defuse(buf_dev, layout))
    return max_byte_err(got, want)


def max_byte_err(got, want) -> int:
    """Max abs difference of two [B, W] uint8 results (raises unless 0)."""
    import torch

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


def enqueue_ms(fns: dict, rounds: int = 600) -> dict:
    """Host time of one call of each ``fns`` entry, ms: the calls taken in
    turns, round after round, so a shared host's drift hits all alike;
    median over rounds.  Launches enqueue without waiting, with a
    synchronise every 50 rounds to keep the queue short."""
    import torch

    times = {k: [] for k in fns}
    for r in range(rounds):
        for k, fn in fns.items():
            t = time.perf_counter()
            fn()
            times[k].append((time.perf_counter() - t) * 1e3)
        if r % 50 == 49:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return {k: statistics.median(v) for k, v in times.items()}


def sleep_cycles_per_ms() -> float:
    """The SM clock under a spin: ``torch.cuda._sleep(n)`` spins n clock64()
    cycles, timed here with CUDA events (median of 5)."""
    import torch

    n, rates = 20_000_000, []
    for _ in range(5):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        torch.cuda._sleep(n)
        e.record()
        e.synchronize()
        rates.append(n / s.elapsed_time(e))
    return statistics.median(rates)


def back_to_back_ms(fn, cycles_per_ms: float, n: int = 200):
    """Device time per call of ``n`` calls enqueued back to back between one
    event pair, ms.  A ``torch.cuda._sleep`` in front holds the stream
    until all n are enqueued, so the events see the device's work and not
    the host's Python; returns (ms per call, sleep covered the enqueue)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(20):
        fn()
    host_ms = (time.perf_counter() - t) / 20 * 1e3
    torch.cuda.synchronize()
    hold_ms = 3 * n * host_ms + 1
    for _ in range(3):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(hold_ms * cycles_per_ms))
        s.record()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        enq_ms = (time.perf_counter() - t) * 1e3
        e.record()
        e.synchronize()
        if enq_ms < hold_ms:
            return s.elapsed_time(e) / n, True
        hold_ms = 2 * enq_ms
    return s.elapsed_time(e) / n, False


def stamp_phases(launch, B: int, names, cycles_per_us: float, dev):
    """Median over rows of each phase's clock64() cycles, from one stamped
    launch after 3 warm ones; rows without a config (no stamps) are
    skipped.  Returns {phase: (cycles, us)} plus the median and the
    largest total of a row."""
    import numpy as np
    import torch

    stamps = torch.zeros((B, 8), dtype=torch.int64, device=dev)
    for _ in range(4):
        stamps.zero_()
        launch(stamps)
    torch.cuda.synchronize()
    st = stamps.cpu().numpy()[:, :len(names) + 1]
    st = st[(st > 0).all(axis=1)]
    if not len(st):
        raise AssertionError("the stamped launch wrote no stamps")
    d = np.diff(st, axis=1)
    out = {}
    for k, name in enumerate(names):
        cyc = float(np.median(d[:, k]))
        out[name] = (cyc, cyc / cycles_per_us)
    total = st[:, -1] - st[:, 0]
    for name, cyc in (("total", np.median(total)), ("slowest row", total.max())):
        out[name] = (float(cyc), float(cyc) / cycles_per_us)
    return out


def fmt_phases(ph) -> str:
    return ", ".join(f"{k} {c:.0f} cyc / {u:.3f} us" for k, (c, u) in ph.items())


PHASES = ("prologue", "leaves", "copy wait", "DFA walk", "circuit",
          "verdict")


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

    fz = params["fused"]
    op = fz["leaf_op_i8"].cpu().numpy()
    L = op.size
    leaf_cost = np.where(np.isin(op, (OP_INCL, OP_EXCL)), K, 1)
    dfa_pos = (fz["leaf_dfa_pos"].cpu().numpy()
               if LB and fz.get("leaf_dfa_pos") is not None else None)
    node_children, is_and = [], []
    for ch, ia in params["levels"]:
        node_children.extend(ch.cpu().numpy())
        is_and.extend(ia.cpu().numpy())
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
    """Bytes the kernel must move and the integer operations this batch's
    rows need, both by the own-config rule (a row's output is only its own
    config's verdict, so it reads only its own config's program).

    Bytes, each read once: the staging buffer but its ``cpu_dense`` block;
    the ``cpu_dense`` columns the rows' own CPU-lane leaves read; the
    program of each config present in the batch (its ``cfg_off`` row, its
    leaf, node, DFA-row, child and level-end records and its evaluator
    words); the DFA image when a present config reads a DFA row; the
    [B, W] output.  Operations: ``own_config_ops`` of each row's config.
    A pad row with no config needs neither."""
    import numpy as np

    from authorino_tpu_torch.ops.operands import staged_h2d_bytes

    kp = params["kernel"]
    off = kp["cfg_off"].cpu().numpy().astype(np.int64)
    cpu_col = kp["leaf_rec"].cpu().numpy()[:, 3]
    G, E = params["eval_rule"].shape
    cid = np.asarray(db.config_id, dtype=np.int64)
    own = cid[(cid >= 0) & (cid < G)]
    present = np.unique(own)
    count = off[present + 1, :5] - off[present, :5]
    leaves, nodes, dfa_rows, levels, kids = count.sum(axis=0)
    program = (present.size * (off.shape[1] * 4 + E * 4)
               + 16 * (leaves + nodes + dfa_rows) + 4 * (kids + levels))
    image = kp["dfa_image"]
    if dfa_rows and image is not None:
        program += image.numel()
    cpu_cols = np.array([int((cpu_col[off[g, 0]:off[g + 1, 0]] >= 0).sum())
                         for g in range(G)], dtype=np.int64)
    staging = staged_h2d_bytes(db)
    if db.cpu_dense is not None:
        staging += (int(cpu_cols[own].sum()) * db.cpu_dense.itemsize
                    - db.cpu_dense.nbytes)
    W = (1 + 2 * E + 7) // 8
    moved = staging + int(program) + db.attrs_val.shape[0] * W

    has_dfa = params["dfa_tables"] is not None and db.attr_bytes is not None
    per_config = own_config_ops(params, db.members_c.shape[2],
                                db.attr_bytes.shape[2] if has_dfa else 0)
    return int(moved), int(per_config[own].sum())


def bound_ms(moved: int, ops: int):
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


async def serve(engine, docs, names):
    return await asyncio.gather(*(engine.submit(d, n)
                                  for d, n in zip(docs, names)))


# ---------------------------------------------------------------------------
# phases 6 and 7: the Check() request path
# ---------------------------------------------------------------------------

# the AuthConfig of the control-plane tests: an API key from a cluster
# Secret with an anonymous fallback, a named pattern, a top-level `when`, a
# custom `unauthorized` and a json success header
V2_HOST = "talker-api.example.com"
V2_SPEC = {
    "hosts": [V2_HOST],
    "patterns": {"admin-path": [{"selector": "request.url_path",
                                 "operator": "matches", "value": "^/admin"}]},
    "when": [{"selector": "request.method", "operator": "neq",
              "value": "OPTIONS"}],
    "authentication": {
        "api-clients": {
            "apiKey": {"selector": {"matchLabels": {"audience": "talker-api"}}},
            "credentials": {"authorizationHeader": {"prefix": "APIKEY"}}},
        "anon": {"anonymous": {}, "priority": 1},
    },
    "authorization": {"admin-only": {
        "patternMatching": {"patterns": [{"any": [
            {"selector": "auth.identity.metadata.labels.role",
             "operator": "eq", "value": "admin"},
            {"selector": "auth.identity.anonymous", "operator": "neq",
             "value": "true"}]}]},
        "when": [{"patternRef": "admin-path"}]}},
    "response": {
        "unauthorized": {"code": 302, "message": {"value": "redirect"}},
        "success": {"headers": {"x-auth": {"json": {"properties": {
            "user": {"selector": "auth.identity.anonymous"}}}}}},
    },
}
V2_KEY = {"authorization": "APIKEY secret-key-1"}
# (host, method, path, headers) -> (code, HTTP status override, message)
V2_CHECKS = [
    ((V2_HOST, "GET", "/admin/x", V2_KEY), (0, 0, "")),
    ((V2_HOST, "GET", "/admin/x", {}), (7, 302, "redirect")),
    ((V2_HOST, "GET", "/public", {}), (0, 0, "")),
    ((V2_HOST, "OPTIONS", "/admin/x", {}), (0, 0, "")),
    ((V2_HOST + ":8000", "GET", "/admin/x", V2_KEY), (0, 0, "")),
    (("unknown.example.com", "GET", "/admin/x", V2_KEY),
     (5, 0, "Service not found")),
]


async def timed_checks(engine, requests):
    """Every request's Check() at once; (result, seconds) per request."""
    async def one(req):
        t = time.perf_counter()
        res = await engine.check(req)
        return res, time.perf_counter() - t

    return await asyncio.gather(*(one(r) for r in requests))


def request_path(report: dict, card: str) -> dict:
    """Phase 6: translate 1,000 north-star AuthConfigs and the V2 config
    with a card engine, install them in one snapshot, answer 4,096
    concurrent north-star Check()s and the V2 checks, hold every result to
    the expression oracle, then time three more runs.  Returns the kernel
    launch counts of the checked run (counts zeroed just before it)."""
    import numpy as np

    from authorino_tpu_torch.authjson import (CheckRequestModel,
                                              HttpRequestAttributes,
                                              build_authorization_json)
    from authorino_tpu_torch.controllers import translate_auth_config
    from authorino_tpu_torch.k8s import InMemoryCluster, Secret
    from authorino_tpu_torch.models import northstar
    from authorino_tpu_torch.ops import fused_kernel as fk
    from authorino_tpu_torch.runtime import PolicyEngine
    from authorino_tpu_torch.utils import rpc

    acs = northstar.build_auth_configs(1000, 10)
    rules = [c.evaluators[0][1] for c in northstar.build_corpus(1000, 10)]
    ns_reqs = northstar.build_check_requests(4096, 1000)
    v2_reqs = [CheckRequestModel(http=HttpRequestAttributes(
        method=m, path=path, host=h, headers=dict(hd)))
        for (h, m, path, hd), _ in V2_CHECKS]
    cluster = InMemoryCluster()
    cluster.put_secret(Secret(
        name="client-1", namespace="tenant",
        labels={"audience": "talker-api", "role": "admin"},
        data={"api_key": b"secret-key-1"}))

    fk.reset_counts()
    engine = PolicyEngine(max_batch=256)

    async def translate_all():
        entries = [await translate_auth_config(
            o["metadata"]["name"], o["metadata"]["namespace"], o["spec"],
            engine=engine) for o in acs]
        entries.append(await translate_auth_config(
            "ac", "tenant", V2_SPEC, cluster=cluster, engine=engine))
        return entries

    t = time.perf_counter()
    entries = asyncio.run(translate_all())
    t_translate = time.perf_counter() - t
    t = time.perf_counter()
    engine.apply_snapshot(entries)
    t_install = time.perf_counter() - t
    t = time.perf_counter()
    out = asyncio.run(timed_checks(engine, ns_reqs + v2_reqs))
    first_wall = time.perf_counter() - t
    launches = {"fused_megakernel": fk.launches,
                "probe_add_one": fk.probe_launches}

    st = dict(engine.stats)
    W = engine._snapshot.policy.fused_pack_w
    if st["failed_batches"]:
        raise AssertionError(f"{st['failed_batches']} batches failed: {st}")
    if not (st["launches"] == st["batches"] == fk.launches):
        raise AssertionError(f"launches {fk.launches} vs batches {st}")
    if st["d2h_bytes"] != st["pad_rows"] * W:
        raise AssertionError(f"D2H {st['d2h_bytes']} != pad x W ({st})")
    if fk.probe_launches < 1:
        raise AssertionError("probe kernel did not run at snapshot install")

    jwt = northstar.JWT_FILTER
    allowed = 0
    for k, (req, (res, _)) in enumerate(zip(ns_reqs, out)):
        if res.code == rpc.UNAVAILABLE:
            raise AssertionError(f"check {k} answered UNAVAILABLE: {res}")
        i = int(req.http.host.split(".")[0][len("svc-"):])
        claims = req.metadata_context["filter_metadata"][jwt]["verified_jwt"]
        doc = build_authorization_json(req, {"identity": claims})
        if rules[i].matches(doc):
            want = (rpc.OK, 0, "", {})
            allowed += 1
        else:
            want = (rpc.PERMISSION_DENIED, 0, "Unauthorized", {
                "ext_authz_provenance": {
                    "authconfig": f"{northstar.NAMESPACE}/cfg-{i}",
                    "rule_index": 0, "rule": str(rules[i]),
                    "lane": "engine"}})
        got = (res.code, res.status, res.message, res.metadata)
        if got != want:
            raise AssertionError(f"check {k} on cfg-{i}: {got} != oracle "
                                 f"{want}")
    for ((host, *_), want), (res, _) in zip(V2_CHECKS, out[len(ns_reqs):]):
        if (res.code, res.status, res.message) != want:
            raise AssertionError(f"V2 check on {host}: {res} != {want}")
    log(f"request path: 1001 AuthConfigs translated in {t_translate:.2f}s, "
        f"installed in {t_install:.2f}s; {len(out)} concurrent Check()s -> "
        f"{st['batches']} batches, {fk.launches} mega-kernel launches, "
        f"{fk.probe_launches} probe, D2H {st['d2h_bytes']} B = pad "
        f"{st['pad_rows']} x W {W}; every code equals the oracle "
        f"({allowed} of 4096 north-star allowed, every denial attributed), "
        f"the V2 checks as expected (NOT_FOUND for the unknown host, "
        f":port stripped)")

    runs = []
    for _ in range(3):
        b0, r0 = engine.stats["batches"], engine.stats["rows"]
        t = time.perf_counter()
        timed = asyncio.run(timed_checks(engine, ns_reqs))
        wall = time.perf_counter() - t
        runs.append({"checks_per_s": len(ns_reqs) / wall,
                     "latency_s": [x for _, x in timed],
                     "batches": engine.stats["batches"] - b0,
                     "rows": engine.stats["rows"] - r0})
    lat = np.sort(np.concatenate([r["latency_s"] for r in runs])) * 1e3
    rates = [r["checks_per_s"] for r in runs]

    async def one_at_a_time(reqs):
        return [(await timed_checks(engine, [r]))[0][1] for r in reqs]

    # a lone Check(): nothing else in flight, a batch of one row
    lone = np.sort(asyncio.run(one_at_a_time(ns_reqs[:200]))) * 1e3
    n_batches = sum(r["batches"] for r in runs)
    numbers = {
        "card": card, "configs": len(entries), "checks": len(out),
        "translate_s": t_translate, "install_s": t_install,
        "first_run_wall_s": first_wall, "allowed": allowed,
        "stats_checked_run": st,
        "checks_per_s": rates,
        "checks_per_s_median": statistics.median(rates),
        "check_latency_ms_p50": float(np.percentile(lat, 50)),
        "check_latency_ms_p99": float(np.percentile(lat, 99)),
        "batches_timed": n_batches,
        "mean_rows_per_batch": sum(r["rows"] for r in runs) / n_batches,
        "lone_check_latency_ms_p50": float(np.percentile(lone, 50)),
        "lone_check_latency_ms_p99": float(np.percentile(lone, 99)),
    }
    report["request_path"] = numbers
    return launches


def counted_batches(engine):
    """Record each batch's (launches, D2H bytes, pad rows) from the
    engine's encode-and-launch step."""
    from authorino_tpu_torch.ops import fused_kernel as fk
    from authorino_tpu_torch.utils import bucket_pow2

    per_batch = []
    launch = engine._encode_and_launch

    def counted(snap, batch):
        l0 = fk.launches
        out = launch(snap, batch)
        per_batch.append((fk.launches - l0, out[1].nbytes,
                          bucket_pow2(len(batch))))
        return out

    engine._encode_and_launch = counted
    return per_batch


def opa_oracle(entry, doc):
    """(code, status, message, metadata) the OPA corpus's config answers
    for ``doc``: the pattern first (priority 0), with its deny provenance,
    then the inline Rego's ``allow`` (priority 1)."""
    from authorino_tpu_torch.utils import rpc

    pattern = entry.rules.evaluators[0][1]
    if not pattern.matches(doc):
        return (rpc.PERMISSION_DENIED, 0, "Unauthorized", {
            "ext_authz_provenance": {
                "authconfig": entry.id, "rule_index": 0,
                "rule": str(pattern), "lane": "engine"}})
    opa = entry.runtime.authorization[1].evaluator
    if not opa._module.evaluate(doc, data=opa.data)["allow"]:
        return (rpc.PERMISSION_DENIED, 0, "Unauthorized", {})
    return (rpc.OK, 0, "", {})


def opa_path(report: dict, card: str, dev, cycles_per_ms: float) -> dict:
    """Phase 7: translate the OPA corpus and the Kubernetes config with a
    card engine, answer 4,096 concurrent Check()s and the Kubernetes
    checks, hold every result, every lowered kernel slot and the kernel's
    readback to their oracles, then time the path.  Returns the kernel
    launch counts of the checked run (counts zeroed just before it) and
    the mega-kernel's max abs byte error on this corpus."""
    import numpy as np
    import torch

    from authorino_tpu_torch.authjson import build_authorization_json
    from authorino_tpu_torch.compiler.encode import encode_batch
    from authorino_tpu_torch.compiler.pack import pack_batch
    from authorino_tpu_torch.controllers import translate_auth_config
    from authorino_tpu_torch.evaluators.authorization.rego_lower import (
        lower_verdict)
    from authorino_tpu_torch.k8s import InMemoryCluster
    from authorino_tpu_torch.models import opa_corpus
    from authorino_tpu_torch.models.northstar import JWT_FILTER
    from authorino_tpu_torch.ops import fused_kernel as fk
    from authorino_tpu_torch.ops.operands import fuse_batch
    from authorino_tpu_torch.runtime import PolicyEngine
    from authorino_tpu_torch.utils import rpc

    acs = opa_corpus.build_auth_configs(1000)
    reqs = opa_corpus.build_check_requests(4096, 1000)
    k8s = opa_corpus.k8s_check_requests()
    cluster = InMemoryCluster()
    reviews, allowed_triples = opa_corpus.k8s_cluster_data()
    cluster.token_reviews.update(reviews)
    cluster.access_reviews = opa_corpus.k8s_access_review(allowed_triples)

    fk.reset_counts()
    engine = PolicyEngine(max_batch=256)
    per_batch = counted_batches(engine)

    async def translate_all():
        entries = [await translate_auth_config(
            o["metadata"]["name"], o["metadata"]["namespace"], o["spec"],
            engine=engine) for o in acs]
        k = opa_corpus.k8s_auth_config()
        entries.append(await translate_auth_config(
            k["metadata"]["name"], k["metadata"]["namespace"], k["spec"],
            cluster=cluster, engine=engine))
        return entries

    t = time.perf_counter()
    entries = asyncio.run(translate_all())
    t_translate = time.perf_counter() - t
    t = time.perf_counter()
    engine.apply_snapshot(entries)
    t_install = time.perf_counter() - t
    t = time.perf_counter()
    out = asyncio.run(timed_checks(engine, reqs + [r for r, _ in k8s]))
    first_wall = time.perf_counter() - t
    launches = {"fused_megakernel": fk.launches,
                "probe_add_one": fk.probe_launches}

    st = dict(engine.stats)
    snap = engine._snapshot
    W = snap.policy.fused_pack_w
    if st["failed_batches"] or st["plain_calls"]:
        raise AssertionError(f"failed or plain batches: {st}")
    if not (st["launches"] == st["batches"] == fk.launches == len(per_batch)):
        raise AssertionError(f"launches {fk.launches} vs batches {st}")
    bad = [b for b in per_batch if b != (1, b[2] * W, b[2])]
    if bad or st["d2h_bytes"] != st["pad_rows"] * W:
        raise AssertionError(f"batches of other than one launch and a pad x "
                             f"W readback: {bad[:4]} ({st})")
    if fk.probe_launches < 1:
        raise AssertionError("probe kernel did not run at snapshot install")

    lowered = [e for e in entries[:-1]
               if e.runtime.authorization[1].evaluator.kernel_slot is not None]
    docs, rows = [], []
    allowed = opa_denied = 0
    for k, (req, (res, _)) in enumerate(zip(reqs, out)):
        if res.code == rpc.UNAVAILABLE:
            raise AssertionError(f"check {k} answered UNAVAILABLE: {res}")
        i = int(req.http.host.split(".")[0][len("opa-"):])
        claims = req.metadata_context["filter_metadata"][JWT_FILTER][
            "verified_jwt"]
        doc = build_authorization_json(req, {"identity": claims})
        docs.append(doc)
        rows.append(i)
        want = opa_oracle(entries[i], doc)
        got = (res.code, res.status, res.message, res.metadata)
        if got != want:
            raise AssertionError(f"check {k} on opa-{i}: {got} != oracle "
                                 f"{want}")
        allowed += res.code == rpc.OK
        opa_denied += res.code != rpc.OK and not res.metadata
    if not 0 < allowed < len(reqs) or not opa_denied:
        raise AssertionError(f"degenerate verdicts: {allowed} allowed, "
                             f"{opa_denied} denied by the Rego policy")
    k8s_codes = {"allowed": rpc.OK, "denied": rpc.PERMISSION_DENIED,
                 "unauthenticated": rpc.UNAUTHENTICATED}
    for (req, outcome), (res, _) in zip(k8s, out[len(reqs):]):
        if res.code != k8s_codes[outcome]:
            raise AssertionError(f"Kubernetes check {req.http.headers}: "
                                 f"{res.code} {res.message} != {outcome}")

    # every lowered config's kernel slot against the lowered expression and
    # the interpreter: each request's doc on its own config, and 8 docs on
    # every lowered config
    pairs = [(d, entries[i]) for d, i in zip(docs, rows)
             if entries[i].runtime.authorization[1].evaluator.kernel_slot
             is not None]
    pairs += [(docs[(j * 8 + t) % len(docs)], e)
              for j, e in enumerate(lowered) for t in range(8)]

    async def submit_all():
        return await asyncio.gather(*(engine.submit(d, e.id)
                                      for d, e in pairs))

    bits = asyncio.run(submit_all())
    relowered = {e.id: lower_verdict(
        e.runtime.authorization[1].evaluator._module) for e in lowered}
    both = set()
    for (doc, e), (rule, skipped) in zip(pairs, bits):
        opa = e.runtime.authorization[1].evaluator
        slot = opa.kernel_slot
        allow = bool(opa._module.evaluate(doc, data=opa.data)["allow"])
        low = relowered[e.id].matches(doc)
        if skipped[slot] or bool(rule[slot]) != low or low != allow:
            raise AssertionError(
                f"{e.id} slot {slot}: kernel {bool(rule[slot])} skipped "
                f"{bool(skipped[slot])}, lowered {low}, interpreter {allow}")
        both.add(allow)
    if both != {True, False}:
        raise AssertionError(f"lowered slots took only {both}")

    # the mega-kernel on this corpus against its plain version
    policy, params = snap.policy, snap.params
    db = pack_batch(policy, encode_batch(
        policy, docs[:256], [policy.config_ids[entries[i].id]
                             for i in rows[:256]]))
    max_err = max(kernel_vs_plain(params, db, dev),
                  kernel_vs_plain(params, db, dev, global_tables=True))
    buf, layout = fuse_batch(db)
    buf_dev = torch.from_numpy(buf).to(dev)
    kout = torch.empty((256, W), dtype=torch.uint8, device=dev)
    launch = (lambda: fk.launch_kernel(params, buf_dev, layout, kout))
    k_ms, _ = device_times_ms(launch, 100)
    k_b2b, _ = back_to_back_ms(launch, cycles_per_ms)
    moved, ops = kernel_work(params, db)
    k_bound, k_by = bound_ms(moved, ops)
    log(f"OPA path: {len(entries)} AuthConfigs translated in "
        f"{t_translate:.2f}s ({len(lowered)} of {len(acs)} Rego policies "
        f"lowered), installed in {t_install:.2f}s; {len(out)} concurrent "
        f"Check()s -> {st['batches']} batches, "
        f"{launches['fused_megakernel']} mega-kernel launches, "
        f"{launches['probe_add_one']} probe, D2H {st['d2h_bytes']} B = pad "
        f"{st['pad_rows']} x W {W}; every result equals the oracle "
        f"({allowed} of {len(reqs)} allowed, {opa_denied} denied by Rego), "
        f"the Kubernetes checks as expected; {len(pairs)} lowered-slot bits "
        f"equal the lowered expression and the interpreter; B=256 readback "
        f"byte-equal to plain")

    runs = []
    for _ in range(3):
        b0, r0 = engine.stats["batches"], engine.stats["rows"]
        t = time.perf_counter()
        timed = asyncio.run(timed_checks(engine, reqs))
        wall = time.perf_counter() - t
        runs.append({"checks_per_s": len(reqs) / wall,
                     "latency_s": [x for _, x in timed],
                     "batches": engine.stats["batches"] - b0,
                     "rows": engine.stats["rows"] - r0})
    lat = np.sort(np.concatenate([r["latency_s"] for r in runs])) * 1e3
    rates = [r["checks_per_s"] for r in runs]

    async def one_at_a_time(rs):
        return [(await timed_checks(engine, [r]))[0][1] for r in rs]

    lone = np.sort(asyncio.run(one_at_a_time(reqs[:200]))) * 1e3
    # the interpreter's host time: one evaluate per Check() whose pattern
    # passed (the Rego evaluator runs after it), timed alone
    ev_s, ev_n = 0.0, 0
    for d, i in zip(docs, rows):
        e = entries[i]
        if e.rules.evaluators[0][1].matches(d):
            opa = e.runtime.authorization[1].evaluator
            t = time.perf_counter()
            opa._module.evaluate(d, data=opa.data)
            ev_s += time.perf_counter() - t
            ev_n += 1
    n_batches = sum(r["batches"] for r in runs)
    numbers = {
        "card": card, "configs": len(entries),
        "lowered": len(lowered), "lowered_share": len(lowered) / len(acs),
        "checks": len(out), "translate_s": t_translate,
        "install_s": t_install, "first_run_wall_s": first_wall,
        "allowed": allowed, "denied_by_rego": opa_denied,
        "slot_bits_checked": len(pairs), "stats_checked_run": st,
        "checks_per_s": rates,
        "checks_per_s_median": statistics.median(rates),
        "check_latency_ms_p50": float(np.percentile(lat, 50)),
        "check_latency_ms_p99": float(np.percentile(lat, 99)),
        "batches_timed": n_batches,
        "mean_rows_per_batch": sum(r["rows"] for r in runs) / n_batches,
        "lone_check_latency_ms_p50": float(np.percentile(lone, 50)),
        "lone_check_latency_ms_p99": float(np.percentile(lone, 99)),
        "rego_evaluate_us_per_check": ev_s / len(docs) * 1e6,
        "rego_evaluate_us_per_call": ev_s / max(ev_n, 1) * 1e6,
        "rego_evaluate_calls": ev_n,
        "kernel_ms_median": statistics.median(k_ms),
        "kernel_back_to_back_ms": k_b2b,
        "kernel_bytes_moved": moved, "kernel_int_ops": ops,
        "bound_ms": k_bound, "bound_by": k_by, "max_abs_err": max_err,
    }
    report["opa_path"] = numbers
    return launches, max_err


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
    from authorino_tpu_torch.ops import operands
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
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")
    fk.fused_kernel_supported(dev)
    log("probe kernel: int32[4] + 1 round-trips")

    # ---- 3. kernel vs plain on the card -----------------------------------
    max_err = 0
    n_cases = n_global = 0
    for seed in (7, 19, 31):
        cfgs = corpora.all_lanes_corpus(seed)
        docs = corpora.all_lanes_docs(seed, 64)
        drng = random.Random(seed)
        names = [drng.choice(cfgs).name for _ in docs]
        for assist in (True, False):
            policy = compile_corpus(cfgs, members_k=corpora.LANES_K,
                                    ovf_assist=assist)
            params = to_device(policy, device=dev)
            if not fk.tables_in_smem(params):
                raise AssertionError("all-lanes tables should fit in smem")
            rows = [policy.config_ids[n] for n in names]
            db = pack_batch(policy, encode_batch(policy, docs, rows))
            for d in (db, corpora.widen_wire(db)):
                max_err = max(max_err, kernel_vs_plain(params, d, dev))
                max_err = max(max_err, kernel_vs_plain(
                    params, d, dev, global_tables=True))
                n_cases += 1
                n_global += 1
    log(f"all-lanes corpus: {n_cases} cases byte-equal to plain, and "
        f"{n_global} with the global-tables instance forced (tolerance 0)")
    policy = compile_corpus(corpora.wide_config_corpus(),
                            members_k=corpora.LANES_K)
    params = to_device(policy, device=dev)
    docs = corpora.wide_config_docs()
    db = pack_batch(policy, encode_batch(policy, docs,
                                         [i % 2 for i in range(len(docs))]))
    for instance in ({}, {"global_tables": True}):
        max_err = max(max_err, kernel_vs_plain(params, db, dev, **instance))
    log("a config past 64 slots (shared-memory circuit) beside a small one: "
        "byte-equal to plain (tolerance 0)")

    t = time.monotonic()
    ns_cfgs = northstar.build_corpus(1000, 10)
    ns_policy = compile_corpus(ns_cfgs, members_k=16)
    ns_params = to_device(ns_policy, device=dev)
    report["northstar_compile_upload_s"] = time.monotonic() - t
    ns_tree = to_device(ns_policy, host=True)
    build_ms = []
    for _ in range(5):
        t = time.perf_counter()
        prog = operands._kernel_layout(ns_tree)
        build_ms.append((time.perf_counter() - t) * 1e3)
    prog_bytes = {k: int(v.nbytes) for k, v in prog.items()
                  if isinstance(v, np.ndarray)}
    kp = ns_params["kernel"]
    report["northstar_shapes"] = {
        "L": ns_policy.n_leaves, "A": ns_policy.n_attrs,
        "G": ns_policy.n_configs, "E": int(ns_policy.eval_rule.shape[1]),
        "levels": [list(c.shape) for c, _ in ns_policy.levels],
        "max_local": kp["max_local"],
        "smem_bytes": fk.smem_bytes(ns_params),
        "tables_in_smem": fk.tables_in_smem(ns_params),
        "dfa_rows": int(ns_policy.dfa_table_of_row.shape[0]),
        "dfa_tables": list(ns_policy.dfa_tables.shape),
        "program_bytes": prog_bytes,
        "program_bytes_total": sum(prog_bytes.values()),
        "program_build_ms_median": statistics.median(build_ms)}
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
            max_err = max(max_err, kernel_vs_plain(ns_params, db, dev,
                                                   global_tables=True))
            batches[(B, LB)] = db
    log("north-star corpus: B in {16, 256} x LB in {16, 64} byte-equal "
        "to plain (tolerance 0), with tables in shared memory and with the "
        "global-tables instance forced")

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
    cycles_per_ms = sleep_cycles_per_ms()
    report["sm_clock_mhz"] = cycles_per_ms / 1e3
    log(f"[{card}] SM clock under a spin: {cycles_per_ms / 1e3:.0f} MHz")

    shapes = {}
    for (B, LB) in ((256, 16), (256, 64), (16, 16)):
        db = batches[(B, LB)]
        buf, layout = fuse_batch(db)
        buf_dev = torch.from_numpy(buf).to(dev)
        kout = torch.empty((B, W), dtype=torch.uint8, device=dev)
        fig = {}
        for name, global_tables in (("smem_tables", False),
                                    ("global_tables", True)):
            fn = (lambda g=global_tables: fk.launch_kernel(
                ns_params, buf_dev, layout, kout, global_tables=g))
            per_call, host = device_times_ms(fn, 100)
            b2b, covered = back_to_back_ms(fn, cycles_per_ms)
            fig[name] = {
                "per_call_ms": statistics.median(per_call),
                "per_call_ms_min": min(per_call), "host_enqueue_ms": host,
                "back_to_back_ms": b2b, "covered": covered}
        fig["stamps"] = stamp_phases(
            lambda stp: fk.launch_stamped(ns_params, buf_dev, layout, kout,
                                          stp),
            B, PHASES, cycles_per_ms / 1e3, dev)
        shapes[f"B{B}_LB{LB}"] = fig
        log(f"[{card}] v3 B={B} LB={LB}: " + "; ".join(
            f"{k} {v['per_call_ms']:.4f} ms/call {v['back_to_back_ms']:.4f} "
            f"ms back to back" for k, v in fig.items() if k != "stamps"))
        log(f"[{card}] v3 stamps B={B} LB={LB}: "
            f"{fmt_phases(fig['stamps'])}")
    report["v3_shapes"] = shapes

    db = batches[(256, 16)]
    buf, layout = fuse_batch(db)
    host_buf = torch.from_numpy(buf).pin_memory()
    buf_dev = host_buf.to(dev)
    kout = torch.empty((256, W), dtype=torch.uint8, device=dev)
    launch = (lambda: fk.launch_kernel(ns_params, buf_dev, layout, kout))
    k_ms, _ = device_times_ms(launch, 100)
    # the same wrapper with its words cache dropped before every launch:
    # each launch rebuilds the argument block and re-checks every param
    enq = enqueue_ms({
        "cached": launch,
        "rebuilt": lambda: (fk.forget_launch_words(ns_params), launch())})
    k_host, k_host_rebuilt = enq["cached"], enq["rebuilt"]
    k_b2b, _ = back_to_back_ms(launch, cycles_per_ms)
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
    pr_b2b, _ = back_to_back_ms(lambda: fk.launch_probe(probe_x),
                                cycles_per_ms)
    prp_ms, _ = device_times_ms(lambda: fk.probe_plain(probe_x), 100)
    # the one PyTorch call that computes the probe's function
    prl_ms, _ = device_times_ms(lambda: probe_x + 1, 100)
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
        "kernel_back_to_back_ms": k_b2b,
        "kernel_host_enqueue_ms_median": k_host,
        "kernel_host_enqueue_rebuilt_ms_median": k_host_rebuilt,
        "plain_ms_median": statistics.median(p_ms),
        "plain_host_enqueue_ms_median": p_host,
        "h2d_d2h_ms_median": statistics.median(x_ms),
        "wrapper_batch_wall_ms_median": statistics.median(w_ms),
        "h2d_bytes": int(buf.size), "d2h_bytes": 256 * W,
        "kernel_bytes_moved": moved, "kernel_int_ops": ops,
        "bound_ms": k_bound, "bound_by": k_by,
        "probe_ms_median": statistics.median(pr_ms),
        "probe_back_to_back_ms": pr_b2b,
        "probe_host_enqueue_ms_median": pr_host,
        "probe_plain_ms_median": statistics.median(prp_ms),
        "probe_library_ms_median": statistics.median(prl_ms),
        "engine_decisions_per_s": rates,
        "engine_decisions_per_s_median": statistics.median(rates),
        "batch_latency_ms_p50": pct(lat, 0.50) * 1e3,
        "batch_latency_ms_p99": pct(lat, 0.99) * 1e3,
        "batches_timed": len(lat),
        "first_run_wall_s": wall,
    }
    report["numbers"] = numbers
    log(f"[{card}] mega-kernel B=256 LB=16: {numbers['kernel_ms_median']:.4f} "
        f"ms median of {len(k_ms)} one-call timings, {k_b2b:.4f} ms per "
        f"launch back to back (bound {k_bound:.7f} ms by {k_by}: "
        f"{moved} B, {ops} int ops); plain {numbers['plain_ms_median']:.3f} "
        f"ms; H2D {buf.size} B + D2H {256 * W} B "
        f"{numbers['h2d_d2h_ms_median']:.4f} ms; host enqueue of one launch "
        f"{k_host:.4f} ms (words rebuilt per launch: {k_host_rebuilt:.4f} "
        f"ms); one batch through the wrapper "
        f"{numbers['wrapper_batch_wall_ms_median']:.4f} ms wall")
    log(f"[{card}] probe: {numbers['probe_ms_median']:.4f} ms one-call, "
        f"{pr_b2b:.4f} ms per launch back to back")
    log(f"[{card}] engine: {numbers['engine_decisions_per_s_median']:.0f} "
        f"decisions/s (runs {[round(r) for r in rates]}), batch latency "
        f"p50 {numbers['batch_latency_ms_p50']:.2f} ms p99 "
        f"{numbers['batch_latency_ms_p99']:.2f} ms over {len(lat)} batches")

    # ---- 6. the Check() request path --------------------------------------
    path_launches = request_path(report, card)
    rp = report["request_path"]
    log(f"[{card}] request path: {rp['checks_per_s_median']:.0f} checks/s "
        f"median of 3 runs ({[round(r) for r in rp['checks_per_s']]}), "
        f"per-Check() latency p50 {rp['check_latency_ms_p50']:.2f} ms p99 "
        f"{rp['check_latency_ms_p99']:.2f} ms; {rp['batches_timed']} "
        f"batches, {rp['mean_rows_per_batch']:.1f} rows per batch; a lone "
        f"Check() p50 {rp['lone_check_latency_ms_p50']:.3f} ms p99 "
        f"{rp['lone_check_latency_ms_p99']:.3f} ms (200 one at a time); the "
        f"engine's submit alone in this run: "
        f"{numbers['engine_decisions_per_s_median']:.0f} decisions/s")

    # ---- 7. the OPA request path ------------------------------------------
    opa_launches, opa_err = opa_path(report, card, dev, cycles_per_ms)
    max_err = max(max_err, opa_err)
    op = report["opa_path"]
    log(f"[{card}] OPA path: {op['checks_per_s_median']:.0f} checks/s "
        f"median of 3 runs ({[round(r) for r in op['checks_per_s']]}; phase "
        f"6: {rp['checks_per_s_median']:.0f}), per-Check() latency p50 "
        f"{op['check_latency_ms_p50']:.2f} ms p99 "
        f"{op['check_latency_ms_p99']:.2f} ms; a lone Check() p50 "
        f"{op['lone_check_latency_ms_p50']:.3f} ms p99 "
        f"{op['lone_check_latency_ms_p99']:.3f} ms; {op['lowered']} of 1000 "
        f"configs lowered ({op['lowered_share']:.3f}); RegoModule.evaluate "
        f"{op['rego_evaluate_us_per_check']:.1f} us host per Check() "
        f"({op['rego_evaluate_us_per_call']:.1f} us per call, "
        f"{op['rego_evaluate_calls']} calls); mega-kernel on this corpus "
        f"B=256: {op['kernel_ms_median']:.4f} ms one call, "
        f"{op['kernel_back_to_back_ms']:.4f} ms back to back, bound "
        f"{op['bound_ms']:.7f} ms by {op['bound_by']} "
        f"({op['kernel_bytes_moved']} B, {op['kernel_int_ops']} int ops)")

    kernels = [
        {"name": "fused_megakernel", "route": "cuda",
         "source": "authorino_tpu_torch/ops/csrc/fused_kernel.cu",
         "replaces": "authorino_tpu/ops/fused_kernel.py:237",
         "launches": opa_launches["fused_megakernel"],
         "max_abs_err": max_err, "ms": numbers["kernel_ms_median"],
         "plain_ms": numbers["plain_ms_median"], "bound_ms": k_bound,
         "bound_by": k_by, "library_ms": None},
        {"name": "probe_add_one", "route": "cuda",
         "source": "authorino_tpu_torch/ops/csrc/fused_kernel.cu",
         "replaces": "authorino_tpu/ops/fused_kernel.py:259",
         "launches": opa_launches["probe_add_one"], "max_abs_err": pr_err,
         "ms": numbers["probe_ms_median"],
         "plain_ms": numbers["probe_plain_ms_median"], "bound_ms": pr_bound,
         "bound_by": pr_by,
         "library_ms": numbers["probe_library_ms_median"]},
    ]
    for name in main_launches:
        if min(main_launches[name], path_launches[name],
               opa_launches[name]) < 1:
            raise AssertionError(
                f"{name} never launched on a path: engine {main_launches}, "
                f"request path {path_launches}, OPA path {opa_launches}")
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
