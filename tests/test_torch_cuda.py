"""The port's CUDA kernels on a card, against their plain PyTorch versions
on the same card (byte for byte: the outputs are uint8 bitmasks).

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed; on a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Without a card every test skips."""

import asyncio
import random
import time

import numpy as np
import pytest
import torch

from authorino_tpu_torch.compiler import compile_corpus
from authorino_tpu_torch.compiler.encode import encode_batch
from authorino_tpu_torch.compiler.pack import pack_batch
from authorino_tpu_torch.models import PolicyModel, corpora, northstar
from authorino_tpu_torch.models.policy_model import host_results
from authorino_tpu_torch.ops import fused_kernel as fk
from authorino_tpu_torch.ops.operands import (check_batch, fuse_batch,
                                              packed_width, to_device)
from authorino_tpu_torch.runtime import EngineEntry, PolicyEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def lanes_case(seed, assist):
    policy = compile_corpus(corpora.all_lanes_corpus(seed),
                            members_k=corpora.LANES_K, ovf_assist=assist)
    docs = corpora.all_lanes_docs(seed, 48)
    rng = random.Random(seed)
    rows = [rng.randrange(policy.n_configs) for _ in docs]
    return policy, docs, rows


# how a case launches the kernel: through the wrapper as the engine does
# (DFA tables in shared memory), or with the instance that reads the tables
# from device memory forced
INSTANCES = {"wrapper": None, "global_tables": {"global_tables": True}}


def launch(params, db, instance, dev):
    """One kernel launch on ``db``; returns the [B, W] readback."""
    if INSTANCES[instance] is None:
        return fk.eval_fused_kernel(params, db)
    check_batch(params, db)
    buf, layout = fuse_batch(db)
    out = torch.empty((db.attrs_val.shape[0],
                       packed_width(1 + 2 * params["eval_rule"].shape[1])),
                      dtype=torch.uint8, device=dev)
    fk.launch_kernel(params, torch.from_numpy(buf).to(dev), layout, out,
                     **INSTANCES[instance])
    return out


@pytest.mark.parametrize("instance", ["wrapper", "global_tables"])
@pytest.mark.parametrize("seed", [7, 19, 31])
@pytest.mark.parametrize("assist", [True, False])
@pytest.mark.parametrize("wide", [False, True])
def test_kernel_matches_plain_on_all_lanes(card, seed, assist, wide,
                                           instance):
    policy, docs, rows = lanes_case(seed, assist)
    db = pack_batch(policy, encode_batch(policy, docs, rows, batch_pad=33))
    db = corpora.widen_wire(db) if wide else db
    l0 = fk.launches
    got = launch(to_device(policy, device=card), db, instance, card)
    assert fk.launches - l0 == 1
    want = fk.eval_fused_kernel(to_device(policy, device="cpu"), db)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def mixed_rows(params, B):
    """Row configs alternating between the corpus's smallest and largest
    subcircuits, so every block holds rows of unequal sizes."""
    off = params["kernel"]["cfg_off"].cpu().numpy()
    size = np.diff(off[:, 0]) + np.diff(off[:, 1]) + np.diff(off[:, 2])
    order = np.argsort(size, kind="stable")
    small, large = order[:B // 2], order[::-1][:B - B // 2]
    rows = np.empty(B, dtype=np.int64)
    rows[0::2], rows[1::2] = small[:(B + 1) // 2], large[:B // 2]
    assert size[rows[0::2]].max() < size[rows[1::2]].min()
    return rows.tolist()


@pytest.mark.parametrize("B,LB,instance,mixed", [
    (16, 16, "wrapper", False), (256, 64, "wrapper", False),
    (16, 16, "global_tables", False), (256, 64, "global_tables", False),
    (64, 16, "wrapper", True)])
def test_kernel_matches_plain_on_northstar(card, B, LB, instance, mixed):
    policy = compile_corpus(northstar.build_corpus(200, 10), members_k=16)
    params = to_device(policy, device=card)
    docs = northstar.build_docs(B, seed=B)
    rows = (mixed_rows(params, B) if mixed
            else [i % policy.n_configs for i in range(B)])
    db = pack_batch(policy, encode_batch(policy, docs, rows),
                    trim_bytes=LB == 16)
    assert db.attr_bytes.shape[2] == LB
    got = launch(params, db, instance, card)
    want = fk.eval_fused_kernel(to_device(policy, device="cpu"), db)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.parametrize("instance", ["wrapper", "global_tables"])
def test_kernel_matches_plain_past_a_64_slot_row(card, instance):
    """A config past 64 slots runs its circuit in shared memory, beside a
    small one on the register path, rows of both in each block."""
    policy = compile_corpus(corpora.wide_config_corpus(),
                            members_k=corpora.LANES_K)
    docs = corpora.wide_config_docs()
    db = pack_batch(policy, encode_batch(
        policy, docs, [i % 2 for i in range(len(docs))]))
    got = launch(to_device(policy, device=card), db, instance, card)
    want = fk.eval_fused_kernel(to_device(policy, device="cpu"), db)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def test_probe_round_trips(card):
    p0 = fk.probe_launches
    assert fk.fused_kernel_supported(card, recheck=True) is True
    assert fk.probe_launches - p0 == 1


def test_model_decides_like_the_oracle(card):
    policy, docs, rows = lanes_case(19, False)
    model = PolicyModel(policy)
    assert model.device.type == "cuda"
    assert model.decide_rows(docs, rows) == \
        [host_results(policy, d, r)[0] for d, r in zip(docs, rows)]


def test_engine_one_launch_per_batch(card):
    cfgs = northstar.build_corpus(20, 10)
    engine = PolicyEngine(max_batch=32)
    engine.apply_snapshot([EngineEntry(id=c.name, hosts=[c.name], rules=c)
                           for c in cfgs])
    docs = northstar.build_docs(70, seed=5)
    names = [f"cfg-{i % 20}" for i in range(70)]

    async def go():
        return await asyncio.gather(*(engine.submit(d, n)
                                      for d, n in zip(docs, names)))

    out = asyncio.run(go())
    policy = engine._snapshot.policy
    st = engine.stats
    # one launch per batch but those the verdict cache answered whole
    assert st["batches"] == 3
    assert st["launches"] == st["batches"] - st["cached_batches"]
    assert st["rows"] == 70 == (st["device_rows"] + st["dedup_rows"]
                                + st["cache_rows"])
    assert st["d2h_bytes"] == st["pad_rows"] * policy.fused_pack_w
    for (rule, skipped), d, n in zip(out, docs, names):
        own, _, w_skip = host_results(policy, d, policy.config_ids[n])
        assert bool(np.all(rule | skipped)) == own
        assert skipped.tolist() == w_skip.tolist()


def test_check_on_the_card_equals_the_cpu(card):
    """The Check() request path: 40 north-star AuthConfigs translated with
    a card engine and a CPU engine give the same AuthResult for every
    request, with one launch per batch on the card."""
    from authorino_tpu_torch.controllers import translate_auth_config

    acs = northstar.build_auth_configs(40, 10)
    requests = northstar.build_check_requests(70, 40, seed=5)

    async def serve(engine):
        engine.apply_snapshot([await translate_auth_config(
            o["metadata"]["name"], o["metadata"]["namespace"], o["spec"],
            engine=engine) for o in acs])
        return await asyncio.gather(*(engine.check(r) for r in requests))

    on_card = PolicyEngine(max_batch=32)
    got = asyncio.run(serve(on_card))
    want = asyncio.run(serve(PolicyEngine(max_batch=32, device="cpu")))
    fields = ("code", "status", "message", "headers", "metadata", "body")
    assert [[getattr(r, f) for f in fields] for r in got] == \
        [[getattr(r, f) for f in fields] for r in want]
    st = on_card.stats
    assert st["batches"] == 3
    assert st["launches"] == st["batches"] - st["cached_batches"]
    assert st["failed_batches"] == st["plain_calls"] == 0


def test_opa_check_on_the_card_equals_the_cpu(card):
    """The OPA corpus: 40 AuthConfigs with inline Rego, most of it lowered
    into kernel slots, give the same AuthResult and the same per-slot bits
    on a card engine and a CPU engine."""
    from authorino_tpu_torch.authjson import build_authorization_json
    from authorino_tpu_torch.controllers import translate_auth_config
    from authorino_tpu_torch.models import opa_corpus

    acs = opa_corpus.build_auth_configs(40)
    requests = opa_corpus.build_check_requests(70, 40, seed=5)
    docs = [build_authorization_json(r, {"identity": r.metadata_context[
        "filter_metadata"][northstar.JWT_FILTER]["verified_jwt"]})
        for r in requests]
    names = [f"{opa_corpus.NAMESPACE}/{r.http.host.split('.')[0]}"
             for r in requests]

    async def serve(engine):
        engine.apply_snapshot([await translate_auth_config(
            o["metadata"]["name"], o["metadata"]["namespace"], o["spec"],
            engine=engine) for o in acs])
        results = await asyncio.gather(*(engine.check(r) for r in requests))
        bits = await asyncio.gather(*(engine.submit(d, n)
                                      for d, n in zip(docs, names)))
        return results, bits

    on_card = PolicyEngine(max_batch=32)
    got, got_bits = asyncio.run(serve(on_card))
    want, want_bits = asyncio.run(serve(PolicyEngine(max_batch=32,
                                                     device="cpu")))
    fields = ("code", "status", "message", "headers", "metadata", "body")
    assert [[getattr(r, f) for f in fields] for r in got] == \
        [[getattr(r, f) for f in fields] for r in want]
    for (gr, gs), (wr, ws) in zip(got_bits, want_bits):
        assert gr.tolist() == wr.tolist() and gs.tolist() == ws.tolist()
    st = on_card.stats
    assert st["batches"] == 6
    assert st["launches"] == st["batches"] - st["cached_batches"]
    assert st["failed_batches"] == st["plain_calls"] == 0


def test_first_launch_of_a_params_tree_from_8_threads(card):
    """Eight threads launch on a params tree nobody launched on yet, all
    at once: the argument words are built once and published whole, every
    readback equals plain, and no launch goes uncounted."""
    import threading

    policy, docs, rows = lanes_case(7, False)
    db = pack_batch(policy, encode_batch(policy, docs, rows))
    want = fk.eval_fused_kernel(to_device(policy, device="cpu"), db).numpy()
    params = to_device(policy, device=card)
    fk.fused_kernel_supported(card)
    assert "launch_words" not in params["kernel"]
    barrier = threading.Barrier(8)
    got, errors = [None] * 8, []

    def one(i):
        try:
            barrier.wait()
            got[i] = fk.eval_fused_kernel(params, db).cpu().numpy()
        except Exception as e:  # surfaced below
            errors.append(e)

    l0 = fk.launches
    threads = [threading.Thread(target=one, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors, errors
    assert fk.launches - l0 == 8
    for g in got:
        np.testing.assert_array_equal(g, want)
    entry = params["kernel"]["launch_words"]
    assert entry[0] == card and len(entry) == 3 and len(entry[2]) == 1


def test_launch_counts_under_concurrent_encoders(card):
    """A burst of many batches through the engine's encode pool: each
    batch counts its own launch, the counts sum to the module's, every
    H2D copy, launch and readback of a batch went on one stream, and
    every verdict equals the oracle."""
    import threading

    cfgs = northstar.build_corpus(20, 10)
    engine = PolicyEngine(max_batch=16, verdict_cache_size=0,
                          batch_dedup=False)
    engine.apply_snapshot([EngineEntry(id=c.name, hosts=[c.name], rules=c)
                           for c in cfgs])
    docs = northstar.build_docs(256, seed=9)
    names = [f"cfg-{i % 20}" for i in range(256)]
    seen = []
    real = fk.dispatch_megakernel

    def spy(params, db):
        handle = real(params, db)
        seen.append((threading.current_thread().name, handle.stream,
                     torch.cuda.current_stream(card)))
        return handle

    fk.dispatch_megakernel = spy
    try:
        l0 = fk.launches

        async def go():
            return await asyncio.gather(*(engine.submit(d, n)
                                          for d, n in zip(docs, names)))

        out = asyncio.run(go())
    finally:
        fk.dispatch_megakernel = real
    recs = list(engine.batch_records)
    assert len(recs) == 16 and all(r["launches"] == 1 for r in recs)
    assert engine.stats["launches"] == fk.launches - l0 == 16
    assert all(s == cur for _, s, cur in seen) and len(seen) == 16
    assert all(name.startswith("authz-engine-encode") for name, _, _ in seen)
    policy = engine._snapshot.policy
    for (rule, skipped), d, n in zip(out, docs, names):
        own, _, w_skip = host_results(policy, d, policy.config_ids[n])
        assert bool(np.all(rule | skipped)) == own
        assert skipped.tolist() == w_skip.tolist()


# ---- the control plane on the card -------------------------------------------

def test_bootstrap_deny_all_on_the_card(card):
    """A snapshot of deny-all entries only (no compiled config): nothing is
    uploaded, the probe kernel still runs at the install, and a Check()
    answers 503 "Busy" without a batch."""
    from authorino_tpu_torch.authjson import (CheckRequestModel,
                                              HttpRequestAttributes)
    from authorino_tpu_torch.evaluators.deny_all import new_deny_all_config

    engine = PolicyEngine(device=card)
    p0 = fk.probe_launches
    engine.apply_snapshot([EngineEntry(id="t/a", hosts=["a.test"],
                                       runtime=new_deny_all_config())])
    assert fk.probe_launches - p0 == 1
    assert engine._snapshot.params is None and engine._snapshot.policy is None
    res = asyncio.run(engine.check(CheckRequestModel(
        http=HttpRequestAttributes(method="GET", path="/", host="a.test"))))
    assert (res.status, res.message) == (503, "Busy")
    assert engine.stats["batches"] == 0


def test_swaps_under_load_on_the_card(card):
    """Waves of Check()s while three reconciles alternate between two
    corpora that differ in some configs' rules: every verdict equals the
    oracle of the generation its batch was cut against, batches were cut
    against several generations, and device memory over ten more swaps,
    from the one that fills the bounded snapshot history to the last,
    stays within one snapshot's upload (the history retains its earlier
    generations' params for a rollback)."""
    import dataclasses
    import gc

    from authorino_tpu_torch.apis import to_v1beta2
    from authorino_tpu_torch.controllers import AuthConfigReconciler
    from authorino_tpu_torch.k8s import InMemoryCluster
    from authorino_tpu_torch.models import control_plane as cp

    n, flips = 40, list(range(0, 40, 4))
    corpora = {name: [to_v1beta2(dict(ac, metadata=dict(
        ac["metadata"], resourceVersion=name))) for ac in configs]
        for name, configs in (("A", cp.build_auth_configs(n, 10)),
                              ("B", cp.build_auth_configs(n, 10, flip=flips)))}
    rules = {"A": cp.config_rules(n, 10), "B": cp.config_rules(n, 10, flip=flips)}
    reqs, cfgs, known = cp.build_check_requests(512, n)
    # wide admission bounds: the loop is busy translating for a while,
    # and this case holds verdicts, not shedding
    engine = PolicyEngine(max_batch=64, device=card, admission_target_s=60.0,
                          admission_min_cap=1 << 20)
    gens = cp.GenerationLog(engine)
    gen_corpus, target = {}, ["A"]
    engine.add_swap_listener(
        lambda: gen_corpus.__setitem__(engine.generation, target[0]))
    cluster = InMemoryCluster()
    for i in range(n):
        cluster.put_secret(cp.Secret(
            name=f"key-{i}-0", namespace=cp.NAMESPACE,
            labels=cp.api_key_secret(i)["metadata"]["labels"],
            data={"api_key": cp.api_key_of(i).encode()}))
    rec = AuthConfigReconciler(engine, cluster=cluster)

    async def go():
        await rec.reconcile_all(corpora["A"])
        waves = [[(dataclasses.replace(reqs[j]), cfgs[j], known[j])
                  for j in range(lo, lo + 64)] for lo in range(0, 512, 64)]
        issued, out = [], []
        for turn, name in enumerate(("B", "A", "B", None)):
            task = None
            if name is not None:
                target[0] = name
                task = asyncio.ensure_future(rec.reconcile_all(corpora[name]))
            for wave in waves[2 * turn:2 * turn + 2]:
                issued += wave
                out += await asyncio.gather(*(engine.check(q) for q, _, _ in wave))
            if task is not None:
                await task
        return issued, out

    issued, out = asyncio.run(go())
    seen = set()
    for (q, i, good), res in zip(issued, out):
        if not good:
            assert res.code == 16
            continue
        gen = gens.by_request.get(id(q))
        assert gen in gen_corpus, (res, gen)
        seen.add(gen)
        assert res.code == cp.expected_code(q, i, rules[gen_corpus[gen]], True)
    assert engine.generation == 5 and len(seen) >= 2

    entries = {}
    for name in "AB":
        asyncio.run(rec.reconcile_all(corpora[name]))
        entries[name] = engine.index.list()
    mem = []
    for k in range(10):
        engine.apply_snapshot(entries["AB"[k % 2]])
        gc.collect()
        torch.cuda.synchronize(card)
        mem.append(torch.cuda.memory_allocated(card))
    params = engine._snapshot.params
    upload = sum(t.numel() * t.element_size() for t in _tensors(params))
    full = engine._history.maxlen
    assert len(engine._history) == full
    assert abs(mem[-1] - mem[full]) <= upload


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def test_engine_encodes_natively_and_folds_the_heat_map(card):
    """An engine on the card encodes the north-star corpus with the native
    encoder (its counters move, nothing handed back), and its heat map
    counts the same (config, rule) denials as the oracle's firing
    columns."""
    from authorino_tpu_torch.native.encoder import TOTALS, reset_totals
    from authorino_tpu_torch.ops.operands import firing_columns

    cfgs = northstar.build_corpus(50, 10)
    engine = PolicyEngine(max_batch=128, device=card, batch_dedup=False,
                          verdict_cache_size=0)
    engine.apply_snapshot([EngineEntry(id=c.name, hosts=[c.name], rules=c)
                           for c in cfgs])
    snap = engine._snapshot
    assert snap.encoder is not None
    docs = northstar.build_docs(512, seed=11)
    rng = random.Random(2)
    names = [f"cfg-{rng.randrange(50)}" for _ in docs]
    reset_totals()
    b0 = snap.encoder.batches

    async def burst():
        return await asyncio.gather(*(engine.submit(d, n)
                                      for d, n in zip(docs, names)))

    asyncio.run(burst())
    deadline = time.monotonic() + 30
    while engine._inflight and time.monotonic() < deadline:
        time.sleep(0.01)
    assert engine._inflight == 0
    assert snap.encoder.batches - b0 == engine.stats["batches"] >= 4
    assert TOTALS["bailed"] == 0 and TOTALS["object"] == engine.stats[
        "batches"]
    want = {}
    for d, n in zip(docs, names):
        row = snap.policy.config_ids[n]
        _, rule, skipped = host_results(snap.policy, d, row)
        col = int(firing_columns(rule[None, :], skipped[None, :])[0])
        if col >= 0:
            want[(row, col)] = want.get((row, col), 0) + 1
    heat = snap.heat
    got = {divmod(int(k), heat.E + 1): int(heat._counts[k])
           for k in np.nonzero(heat._counts)[0]}
    assert want and got == want


def test_grpc_server_on_the_card_answers_as_the_cpu(card):
    """The gRPC ext_authz server over a card engine and over a CPU engine
    (40 north-star AuthConfigs): the same CheckRequest bytes give the same
    CheckResponse bytes, with one launch per batch on the card."""
    import grpc

    from authorino_tpu_torch.controllers import translate_auth_config
    from authorino_tpu_torch.protos import wire
    from authorino_tpu_torch.service.grpc_server import (
        build_server, request_proto_from_model)

    acs = northstar.build_auth_configs(40, 10)
    payloads = [wire.encode_check_request(request_proto_from_model(r))
                for r in northstar.build_check_requests(70, 40, seed=5)]

    async def serve(engine):
        engine.apply_snapshot([await translate_auth_config(
            o["metadata"]["name"], o["metadata"]["namespace"], o["spec"],
            engine=engine) for o in acs])
        server = build_server(engine, address="127.0.0.1:0")
        await server.start()
        try:
            async with grpc.aio.insecure_channel(
                    f"127.0.0.1:{server.bound_port}") as ch:
                call = ch.unary_unary(
                    "/envoy.service.auth.v3.Authorization/Check",
                    request_serializer=lambda b: b,
                    response_deserializer=lambda b: b)
                return await asyncio.wait_for(
                    asyncio.gather(*(call(p) for p in payloads)), 120)
        finally:
            await server.stop(None)

    on_card = PolicyEngine(max_batch=32)
    got = asyncio.run(serve(on_card))
    want = asyncio.run(serve(PolicyEngine(max_batch=32, device="cpu")))
    assert got == want
    assert {wire.decode_check_response(b).status.code for b in got} == {0, 7}
    st = on_card.stats
    assert st["launches"] == st["batches"] - st["cached_batches"] > 0
    assert st["failed_batches"] == st["plain_calls"] == 0


def test_ledger_equals_batch_records_and_wrapper_launches(card):
    """Phase 13 (a) at a small size: over a burst with repeats (dedup and
    the cache on), the cost ledger's engine lane moves by the sums of the
    engine's batch records and by the wrapper's own launch count, one
    launch per batch with a device row."""
    from authorino_tpu_torch.runtime.kernel_cost import LEDGER

    cfgs = northstar.build_corpus(20, 10)
    engine = PolicyEngine(max_batch=32)
    engine.apply_snapshot([EngineEntry(id=c.name, hosts=[c.name], rules=c)
                           for c in cfgs])
    docs = northstar.build_docs(40, seed=8)
    docs = docs + docs[:30]
    names = [f"cfg-{i % 20}" for i in range(70)]

    async def go():
        return await asyncio.gather(*(engine.submit(d, n)
                                      for d, n in zip(docs, names)))

    n0, l0, f0 = len(engine.batch_records), LEDGER.snapshot("engine"), \
        fk.launches
    asyncio.run(go())
    asyncio.run(go())
    deadline = time.monotonic() + 30
    while engine._inflight and time.monotonic() < deadline:
        time.sleep(0.01)
    recs = list(engine.batch_records)[n0:]
    l1 = LEDGER.snapshot("engine")
    d = {k: l1[k] - l0[k] for k in l1 if isinstance(l1[k], int)}
    assert d["batches"] == len(recs)
    assert d["launches"] == sum(r["launches"] for r in recs) \
        == fk.launches - f0 == sum(r["device_rows"] > 0 for r in recs)
    for k, rk in (("rows", "rows"), ("device_rows", "device_rows"),
                  ("pad_rows", "pad_rows"), ("dedup_avoided_rows",
                                             "dedup_rows"),
                  ("cache_avoided_rows", "cache_rows"),
                  ("h2d_bytes", "h2d_bytes"), ("d2h_bytes", "d2h_bytes")):
        assert d[k] == sum(r[rk] for r in recs), k
    assert d["cache_avoided_rows"] > 0 and d["zero_launch_batches"] >= 1


def test_overloaded_admission_bundle_on_the_card(card, tmp_path):
    """Phase 13 (d) at a small size: admission entering OVERLOADED on a
    card engine writes one bundle whose exposition's engine launch count
    equals the ledger's (only the port counts into this process's
    registry)."""
    import json
    import os

    from authorino_tpu_torch.runtime.flight_recorder import RECORDER

    saved = (RECORDER.dump_dir, RECORDER.min_dump_interval_s)
    RECORDER.configure(dump_dir=str(tmp_path), min_dump_interval_s=0.0)
    try:
        cfgs = northstar.build_corpus(8, 4)
        engine = PolicyEngine(max_batch=16)
        engine.apply_snapshot([EngineEntry(id=c.name, hosts=[c.name],
                                           rules=c) for c in cfgs])
        docs = northstar.build_docs(16, seed=2)

        async def go():
            return await asyncio.gather(*(engine.submit(
                d, f"cfg-{i % 8}") for i, d in enumerate(docs)))

        asyncio.run(go())
        with engine.admission._lock:
            engine.admission._set_state("overloaded")
        deadline = time.monotonic() + 30
        while not any(n.endswith(".json") for n in os.listdir(tmp_path)) \
                and time.monotonic() < deadline:
            time.sleep(0.01)   # the atomic writer's .tmp comes first
        with engine.admission._lock:
            engine.admission._set_state("admit")
        names = [n for n in os.listdir(tmp_path) if n.endswith(".json")]
        assert len(names) == 1 and "admission-overloaded" in names[0]
        bundle = json.loads((tmp_path / names[0]).read_text())
        assert bundle["schema"] == 1
        led = bundle["vars"]["engine"]["kernel_cost"]["ledger"]["engine"]
        line = [ln for ln in bundle["metrics"].splitlines() if ln.startswith(
            'auth_server_kernel_launches_total{lane="engine"}')]
        assert float(line[0].split()[-1]) == led["launches"] > 0
    finally:
        RECORDER.configure(dump_dir=saved[0], min_dump_interval_s=saved[1])


def test_hung_launch_abandoned_by_the_watchdog_is_released(card):
    """``kernel:hang`` wraps two real launches (the batch and its retry);
    the watchdog abandons each and releases its handle (readback buffer,
    event and stream), every row answers the typed UNAVAILABLE, and device
    memory returns to its value before the wedge."""
    import gc

    from authorino_tpu_torch.runtime import faults
    from authorino_tpu_torch.utils.rpc import UNAVAILABLE, CheckAbort

    cfgs = northstar.build_corpus(20, 10)
    engine = PolicyEngine(max_batch=32, verdict_cache_size=0,
                          batch_dedup=False, device_timeout_s=0.2,
                          breaker_threshold=100)
    engine.apply_snapshot([EngineEntry(id=c.name, hosts=[c.name], rules=c)
                           for c in cfgs])
    docs = northstar.build_docs(24, seed=6)
    names = [f"cfg-{i % 20}" for i in range(24)]

    async def go():
        return await asyncio.gather(*(engine.submit(d, n)
                                      for d, n in zip(docs, names)),
                                    return_exceptions=True)

    asyncio.run(go())                      # warm: the card serves
    torch.cuda.synchronize()
    gc.collect()
    m0, l0 = torch.cuda.memory_allocated(card), fk.launches
    real = fk.dispatch_megakernel
    handles = []

    def dispatch(params, db):
        handles.append(real(params, db))
        return handles[-1]

    fk.dispatch_megakernel = dispatch
    faults.FAULTS.arm("kernel:hang")
    try:
        out = asyncio.run(go())
    finally:
        faults.FAULTS.disarm()
        fk.dispatch_megakernel = real
    deadline = time.monotonic() + 30
    while engine._inflight and time.monotonic() < deadline:
        time.sleep(0.01)
    st = engine.stats
    assert fk.launches - l0 == len(handles) == 2
    assert all(h._host is None and h._event is None and h.stream is None
               for h in handles)
    assert (st["watchdog_timeouts"], st["retries"]) == (2, 1)
    assert (st["degraded_rows"], st["failed_batches"]) == (0, 1)
    assert all(isinstance(e, CheckAbort) and e.code == UNAVAILABLE
               for e in out)
    del handles[:]
    torch.cuda.synchronize()
    gc.collect()
    assert torch.cuda.memory_allocated(card) == m0


def test_half_open_probe_is_a_real_launch(card):
    """A flap (``kernel:raise:for=0.3``) trips the breaker; past the fault
    and the cooldown, the half-open probe batch launches the kernel and
    closes the circuit, with the verdicts of the card.  The batch that
    tripped it answered UNAVAILABLE."""
    from authorino_tpu_torch.runtime import faults
    from authorino_tpu_torch.utils.rpc import UNAVAILABLE, CheckAbort

    cfgs = northstar.build_corpus(20, 10)
    engine = PolicyEngine(max_batch=32, verdict_cache_size=0,
                          batch_dedup=False, breaker_threshold=1,
                          breaker_reset_s=0.4)
    engine.apply_snapshot([EngineEntry(id=c.name, hosts=[c.name], rules=c)
                           for c in cfgs])
    docs = northstar.build_docs(8, seed=9)

    async def one(i):
        return await engine.submit(docs[i], f"cfg-{i}")

    faults.FAULTS.arm("kernel:raise:for=0.3")
    try:
        with pytest.raises(CheckAbort) as info:
            asyncio.run(one(0))
        assert info.value.code == UNAVAILABLE
        assert engine.breaker.state == "open"
        time.sleep(0.5)
        l0 = fk.launches
        rule, skipped = asyncio.run(one(1))
    finally:
        faults.FAULTS.disarm()
    assert fk.launches - l0 == 1
    assert engine.breaker.state == "closed"
    assert [t["state"] for t in engine.breaker.transitions] == [
        "open", "half-open", "closed"]
    policy = engine._snapshot.policy
    own, _, w_skip = host_results(policy, docs[1], policy.config_ids["cfg-1"])
    assert bool(np.all(rule | skipped)) == own
    assert skipped.tolist() == w_skip.tolist()


def _frontend_on_the_card(n_cfg, **fe_kw):
    from authorino_tpu_torch.models import wire_corpus as wc
    from authorino_tpu_torch.runtime.native_frontend import NativeFrontend

    engine = PolicyEngine(max_batch=256, verdict_cache_size=0,
                          batch_dedup=False)
    engine.apply_snapshot(wc.build_wire_entries(n_cfg, 10, engine))
    fe = NativeFrontend(engine, port=0, max_batch=256, window_us=2000,
                        verdict_cache_size=0, batch_dedup=False, **fe_kw)
    fe.start()
    return engine, fe


def _grpc_burst(port, payloads):
    import grpc

    async def body():
        async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
            call = ch.unary_unary("/envoy.service.auth.v3.Authorization/Check")
            return await asyncio.gather(*(call(p, timeout=60)
                                          for p in payloads))

    return asyncio.run(body())


def test_native_frontend_one_launch_per_fast_batch(card):
    """The native frontend on the card: every fast-lane slot is one launch
    of the mega-kernel (the wrapper's count equals the frontend's), no
    plain call, every answer the oracle's."""
    from authorino_tpu_torch.models import wire_corpus as wc
    from authorino_tpu_torch.protos import wire

    engine, fe = _frontend_on_the_card(50)
    try:
        assert fe.wait_warm(60)
        payloads = wc.wire_payloads(600, 50, seed=11)
        c0, l0, p0 = dict(fe.counts), fk.launches, fk.plain_calls
        out = _grpc_burst(fe.bound_port, payloads)
        c1 = dict(fe.counts)
    finally:
        fe.stop()
    d = {k: c1[k] - c0[k] for k in c1}
    assert d["rows"] == d["device_rows"] == 600
    assert d["launches"] == d["batches"] == fk.launches - l0 >= 3
    assert d["plain_calls"] == 0 and fk.plain_calls == p0
    assert [wire.decode_check_response(r).status.code for r in out] == [
        0 if wc.expected_allow(p, 10) else 7 for p in payloads]


def test_native_frontend_readback_equals_plain(card, monkeypatch):
    """A frontend slot's readback from the card is byte-equal to the
    kernel's plain version on the same staged operands."""
    import dataclasses

    from authorino_tpu_torch.models import wire_corpus as wc
    from authorino_tpu_torch.ops.operands import defuse

    captured = []
    real = fk.dispatch_megakernel

    def capturing(params, db):
        # a copy: the batch's arrays view the frontend's slot, which the
        # C++ encoder refills once the batch completes
        copy = dataclasses.replace(db, **{
            f.name: np.array(getattr(db, f.name), copy=True)
            for f in dataclasses.fields(db)
            if getattr(db, f.name) is not None})
        h = real(params, db)
        captured.append((params, copy, h))
        return h

    engine, fe = _frontend_on_the_card(50)
    try:
        assert fe.wait_warm(60)
        monkeypatch.setattr(fk, "dispatch_megakernel", capturing)
        _grpc_burst(fe.bound_port, wc.wire_payloads(256, 50, seed=12))
    finally:
        fe.stop()
    assert captured
    for params, db, h in captured:
        buf, layout = fuse_batch(db)
        want = fk.fused_packed_plain(params, defuse(
            torch.from_numpy(buf).to(card), layout)).cpu().numpy()
        got = np.asarray(h.wait())
        assert got.shape == want.shape and np.array_equal(got, want)


def test_native_frontend_device_down_answers_unavailable(card):
    """``device-down`` on the card: every fast-lane request answers
    UNAVAILABLE — never a host verdict — and nothing counts as
    degraded; the breaker opens after its threshold."""
    from authorino_tpu_torch.models import wire_corpus as wc
    from authorino_tpu_torch.protos import wire
    from authorino_tpu_torch.runtime import faults
    from authorino_tpu_torch.utils.rpc import UNAVAILABLE

    engine, fe = _frontend_on_the_card(50, breaker_threshold=1,
                                       breaker_reset_s=60.0)
    p0 = fk.plain_calls
    try:
        faults.FAULTS.arm("device-down", seed=7)
        out = _grpc_burst(fe.bound_port, wc.wire_payloads(64, 50, seed=13))
    finally:
        faults.FAULTS.disarm()
        fe.stop()
    assert [wire.decode_check_response(r).status.code for r in out] == \
        [UNAVAILABLE] * 64
    c = fe.counts
    assert c["degraded_rows"] == 0 and c["unavailable_rows"] == 64
    assert fk.plain_calls == p0 and fe.breaker.state == "open"


def test_native_frontend_registered_jwt_repeat_rides_the_kernel(
        card, monkeypatch):
    """A JWT's first sight verifies on the slow lane and registers in the
    verified-credential cache; its repeats ride the fast lane, each slot
    one launch of ``fused_megakernel`` on the card, and that batch's
    readback is byte-equal to ``fused_packed_plain`` on the same staged
    operands."""
    import dataclasses

    from authorino_tpu_torch.controllers import translate_auth_config
    from authorino_tpu_torch.models import oidc_corpus as oc
    from authorino_tpu_torch.ops.operands import defuse
    from authorino_tpu_torch.protos import wire
    from authorino_tpu_torch.protos.ext_authz import request_proto_from_model
    from authorino_tpu_torch.runtime.native_frontend import NativeFrontend

    keys = oc.make_keys(5, rsa_bits=1024)
    with oc.FakeKeycloak(keys) as idp:
        engine = PolicyEngine(max_batch=256, verdict_cache_size=0,
                              batch_dedup=False)
        specs = oc.build_auth_configs(8, 10, idp.issuer)

        async def translate_all():
            return [await translate_auth_config(
                o["metadata"]["name"], o["metadata"]["namespace"],
                o["spec"], engine=engine) for o in specs]

        engine.apply_snapshot(asyncio.run(translate_all()))
        reqs, kinds, _ = oc.build_check_requests(idp, 32, 8, n_tokens=8)
        good = [wire.encode_check_request(request_proto_from_model(r))
                for r, k in zip(reqs, kinds) if k is None][:8]
        fe = NativeFrontend(engine, port=0, max_batch=256, window_us=2000,
                            verdict_cache_size=0, batch_dedup=False)
        fe.start()
        captured = []
        real = fk.dispatch_megakernel

        def capturing(params, db):
            copy = dataclasses.replace(db, **{
                f.name: np.array(getattr(db, f.name), copy=True)
                for f in dataclasses.fields(db)
                if getattr(db, f.name) is not None})
            h = real(params, db)
            captured.append((params, copy, h))
            return h

        try:
            assert fe.wait_warm(60)
            first = [_grpc_burst(fe.bound_port, [p])[0] for p in good]
            s0, c0, l0 = fe.stats(), dict(fe.counts), fk.launches
            monkeypatch.setattr(fk, "dispatch_megakernel", capturing)
            again = _grpc_burst(fe.bound_port, good)
            s1, c1 = fe.stats(), dict(fe.counts)
        finally:
            fe.stop()
    assert again == first
    assert (s1["fast"] - s0["fast"], s1["slow"] - s0["slow"]) == (8, 0)
    assert s1["dyn_hit"] - s0["dyn_hit"] == 8
    d = {k: c1[k] - c0[k] for k in c1}
    assert d["launches"] == d["batches"] == fk.launches - l0 >= 1
    assert d["plain_calls"] == 0 and d["device_rows"] == 8
    assert captured
    for params, db, h in captured:
        buf, layout = fuse_batch(db)
        want = fk.fused_packed_plain(params, defuse(
            torch.from_numpy(buf).to(card), layout)).cpu().numpy()
        got = np.asarray(h.wait())
        assert got.shape == want.shape and np.array_equal(got, want)


def _card_tensors(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k != "launch_words":
                out.update(_card_tensors(v, f"{prefix}.{k}"))
        return out
    if isinstance(tree, tuple):
        out = {}
        for i, v in enumerate(tree):
            out.update(_card_tensors(v, f"{prefix}.{i}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("change", northstar.CHANGES)
def test_delta_on_the_card_equals_a_full_upload(card, change):
    """A one-config change (a constant, an added leaf, an added regex)
    shipped as a delta onto the card: every param equals a full upload of
    the new corpus, the previous params' tensors keep their pointers and
    bytes (and their cached launch words stay theirs), and the kernel's
    readback on the delta-built params is byte-equal to the one on the
    full upload and to plain."""
    from authorino_tpu_torch.ops.operands import (defuse, host_operands,
                                                  host_view, params_from_numpy)
    from authorino_tpu_torch.snapshots import CompileCache, plan_delta
    from authorino_tpu_torch.snapshots.delta import apply_delta, full_upload

    cache = CompileCache()
    p0, _ = cache.compile(northstar.build_corpus(200, 10), members_k=16)
    p1, rep = cache.compile(
        northstar.build_corpus(200, 10, changed={7: change}), members_k=16)
    assert rep.compiled_names == ["cfg-7"]
    v0, v1 = host_view(host_operands(p0)), host_view(host_operands(p1))
    prev, _ = full_upload(v0, card)
    docs = northstar.build_docs(256, seed=5)
    rows = [random.Random(k).randrange(200) for k in range(256)]
    db0 = pack_batch(p0, encode_batch(p0, docs, rows))
    fk.eval_fused_kernel(prev, db0)          # caches prev's launch words
    words = prev["kernel"]["launch_words"]
    before = {k: (t.data_ptr(), t.clone())
              for k, t in _card_tensors(prev).items()
              if isinstance(t, torch.Tensor)}
    plan = plan_delta(v0, v1)
    params, shipped = apply_delta(prev, v1, plan, card)
    torch.cuda.synchronize()
    assert plan.mode == "delta" and shipped == plan.upload_bytes
    if change == "const":
        assert 0 < shipped < plan.full_bytes / 2
    assert "launch_words" not in params["kernel"]
    cold = params_from_numpy(host_operands(p1), device=card)
    got, want = _card_tensors(params), _card_tensors(cold)
    assert got.keys() == want.keys()
    for k, t in want.items():
        if isinstance(t, torch.Tensor):
            assert got[k].device == t.device and torch.equal(got[k], t), k
        else:
            assert type(got[k]) is type(t) and got[k] == t, k
    for k, (ptr, copy) in before.items():
        t = _card_tensors(prev)[k]
        assert t.data_ptr() == ptr and torch.equal(t, copy), k
    assert prev["kernel"]["launch_words"] is words
    db = pack_batch(p1, encode_batch(p1, docs, rows))
    out = fk.eval_fused_kernel(params, db)
    assert torch.equal(out, fk.eval_fused_kernel(cold, db))
    buf, layout = fuse_batch(db)
    plain = fk.fused_packed_plain(params, defuse(
        torch.from_numpy(buf).to(card), layout))
    assert torch.equal(out, plain)


def test_engine_reconciles_incrementally_on_the_card(card):
    """The engine on the card: an unchanged corpus reuses the installed
    params (no upload, no probe), a one-config change ships a delta, and
    every verdict after it equals the oracle, one launch per batch."""
    cfgs = northstar.build_corpus(100, 10)
    engine = PolicyEngine(device=card, max_batch=64, verdict_cache_size=0,
                          batch_dedup=False)
    entries = [EngineEntry(id=c.name, hosts=[c.name], rules=c) for c in cfgs]
    engine.apply_snapshot(entries)
    first = engine._snapshot
    p0 = fk.probe_launches
    engine.apply_snapshot(entries)
    assert engine._snapshot.params is first.params
    assert engine._snapshot.upload["mode"] == "reuse"
    assert fk.probe_launches == p0
    new = northstar.build_corpus(100, 10, changed={3: "const"})
    engine.apply_snapshot([EngineEntry(id=c.name, hosts=[c.name], rules=c)
                           for c in new])
    snap = engine._snapshot
    assert snap.upload["mode"] == "delta"
    assert snap.compile_report.compiled_names == ["cfg-3"]
    docs = northstar.build_docs(128, seed=9)
    names = [f"cfg-{k % 100}" for k in range(128)]
    l0 = fk.launches
    out = asyncio.run(_gather(engine, docs, names))
    assert fk.launches - l0 == 2
    for (rule, skipped), d, n in zip(out, docs, names):
        own, w_rule, w_skip = host_results(snap.policy, d,
                                           snap.policy.config_ids[n])
        assert bool(np.all(skipped | rule)) == own
        assert skipped.tolist() == w_skip.tolist()


async def _gather(engine, docs, names):
    return await asyncio.gather(*(engine.submit(d, n)
                                  for d, n in zip(docs, names)))


def _param_ptrs(params) -> dict:
    """Every device tensor of a params tree by path: its data pointer."""
    out = {}

    def walk(node, path):
        if isinstance(node, torch.Tensor):
            out[path] = node.data_ptr()
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")

    walk(params, "")
    return out


def test_canary_parts_launch_on_their_generations_and_rollback_reserves(
        card, monkeypatch):
    """A canary cut holding both cohorts makes two launches, one on each
    generation's params, each readback byte-equal to the plain version on
    the same operands; a rollback re-serves the retained baseline params
    (the same data pointers) with nothing uploaded and no probe."""
    from authorino_tpu_torch.ops.operands import defuse
    from authorino_tpu_torch.runtime.change_safety import in_canary_cohort
    from authorino_tpu_torch.utils import metrics as metrics_mod

    def entries(cfgs):
        return [EngineEntry(id=c.name, hosts=[c.name], rules=c)
                for c in cfgs]

    engine = PolicyEngine(device=card, max_batch=256, verdict_cache_size=0,
                          batch_dedup=False, canary_fraction=0.5,
                          canary_window_s=600.0)
    engine.apply_snapshot(entries(northstar.build_corpus(100, 10)))
    base = engine._snapshot
    base_ptrs = _param_ptrs(base.params)
    engine.apply_snapshot(entries(northstar.build_corpus(
        100, 10, changed={3: "const"})))
    phase = engine._canary
    assert phase is not None and phase.baseline is base
    assert _param_ptrs(phase.snap.params) != base_ptrs
    docs = northstar.build_docs(128, seed=9, cohort_entropy=True)
    names = [f"cfg-{k % 100}" for k in range(128)]
    cohorts = [in_canary_cohort(d, 0.5) for d in docs]
    assert 0 < sum(cohorts) < len(docs)
    captured = []
    real = fk.dispatch_megakernel

    def capturing(params, db):
        h = real(params, db)
        captured.append((params, db, h))
        return h

    monkeypatch.setattr(fk, "dispatch_megakernel", capturing)
    l0 = fk.launches
    out = asyncio.run(_gather(engine, docs, names))
    monkeypatch.setattr(fk, "dispatch_megakernel", real)
    assert fk.launches - l0 == 2 == len(captured)
    assert {id(p) for p, _, _ in captured} == {id(phase.snap.params),
                                               id(base.params)}
    for params, db, h in captured:
        buf, layout = fuse_batch(db)
        want = fk.fused_packed_plain(params, defuse(
            torch.from_numpy(buf).to(card), layout)).cpu().numpy()
        got = np.asarray(h.wait())
        assert got.shape == want.shape and np.array_equal(got, want)
    for (rule, skipped), d, n, c in zip(out, docs, names, cohorts):
        snap = phase.snap if c else base
        own, _, w_skip = host_results(snap.policy, d,
                                      snap.policy.config_ids[n])
        assert bool(np.all(skipped | rule)) == own
        assert skipped.tolist() == w_skip.tolist()
    up0 = metrics_mod.delta_upload_bytes.labels("engine")._value.get()
    full0 = metrics_mod.full_upload_bytes.labels("engine")._value.get()
    p0 = fk.probe_launches
    assert engine.canary_rollback()
    assert engine._snapshot.params is base.params
    assert _param_ptrs(engine._snapshot.params) == base_ptrs
    assert fk.probe_launches == p0
    assert metrics_mod.delta_upload_bytes.labels(
        "engine")._value.get() == up0
    assert metrics_mod.full_upload_bytes.labels("engine")._value.get() == \
        full0
    l0 = fk.launches
    again = asyncio.run(_gather(engine, docs, names))
    assert fk.launches - l0 == 1
    for (rule, skipped), d, n in zip(again, docs, names):
        own, _, _ = host_results(base.policy, d, base.policy.config_ids[n])
        assert bool(np.all(skipped | rule)) == own


def test_quarantined_out_config_fails_only_its_own_rows_on_the_card(card):
    """A cut on the card holding rows for a config a guard-breach
    quarantine removed and for one never compiled, beside two known rows:
    the known rows get the oracle's verdicts from one launch, the others
    answer UNAVAILABLE "policy evaluation unavailable" (the reference's
    per-row answer), and the breaker counts no failure."""
    from authorino_tpu_torch.utils.rpc import UNAVAILABLE, CheckAbort

    def entries(cfgs):
        return [EngineEntry(id=c.name, hosts=[c.name], rules=c)
                for c in cfgs]

    engine = PolicyEngine(device=card, max_batch=8, verdict_cache_size=0,
                          batch_dedup=False, canary_fraction=0.5,
                          canary_window_s=600.0)
    engine.apply_snapshot(entries(northstar.build_corpus(10, 10)))
    engine.apply_snapshot(entries(northstar.build_corpus(11, 10)))
    assert engine._canary is not None
    assert engine._canary_rollback(engine._canary, reason="guard-breach",
                                   detail={"suspects": ["cfg-10"]})
    assert sorted(engine._quarantine["configs"]) == ["cfg-10"]
    snap = engine._snapshot
    docs = northstar.build_docs(4, seed=11)
    names = ["cfg-0", "cfg-10", "cfg-unknown", "cfg-1"]

    async def burst():
        return await asyncio.gather(
            *(engine.submit(d, n) for d, n in zip(docs, names)),
            return_exceptions=True)

    for _ in range(2):
        l0 = fk.launches
        out = asyncio.run(burst())
        assert fk.launches - l0 >= 1
        for k in (1, 2):
            assert isinstance(out[k], CheckAbort)
            assert (out[k].code, str(out[k])) == (
                UNAVAILABLE, "policy evaluation unavailable")
        for k in (0, 3):
            rule, skipped = out[k]
            own, _, _ = host_results(snap.policy, docs[k],
                                     snap.policy.config_ids[names[k]])
            assert bool(np.all(skipped | rule)) == own
    assert engine.breaker.state == "closed"
    assert engine.breaker._consecutive == 0
    assert engine.stats["retries"] == 0


def test_contained_tenant_rows_launch_as_their_own_part(card, monkeypatch):
    """With one tenant contained, each cut of a burst launches the other
    tenants' rows first and the contained tenant's rows as a part of their
    own: every launch on the card, each readback byte-equal to the plain
    version on the same operands, every verdict the oracle's."""
    from authorino_tpu_torch.ops.operands import defuse
    from authorino_tpu_torch.tenancy.quota import TokenBucket

    engine = PolicyEngine(device=card, max_batch=64, verdict_cache_size=0,
                          batch_dedup=False)
    engine.apply_snapshot([EngineEntry(id=c.name, hosts=[c.name], rules=c)
                           for c in northstar.build_corpus(8, 10)])
    hot = "cfg-0"
    det = engine.tenancy.detector
    det._contained[hot] = {"since": time.monotonic()}
    det._pacers[hot] = TokenBucket(1e9)
    det.check_interval_s = 1e9   # no release mid-burst
    docs = northstar.build_docs(192, seed=5)
    names = [hot if k % 3 == 0 else f"cfg-{1 + k % 7}" for k in range(192)]
    captured, parts = [], []
    real = fk.dispatch_megakernel
    real_job = engine._encode_launch_job

    def capturing(params, db):
        h = real(params, db)
        captured.append((params, db, h))
        return h

    def job(snap, part, attempt=0):
        parts.append([(p.config_name, p.contained) for p in part])
        return real_job(snap, part, attempt)

    monkeypatch.setattr(fk, "dispatch_megakernel", capturing)
    engine._encode_launch_job = job
    l0 = fk.launches
    out = asyncio.run(_gather(engine, docs, names))
    monkeypatch.setattr(fk, "dispatch_megakernel", real)
    det._contained.clear()
    det._pacers.clear()
    contained = [p for p in parts if p[0][1]]
    assert contained and engine.stats["contained_rows"] == 64
    for part in parts:
        assert len({c for _, c in part}) == 1
        assert ({n for n, _ in part} == {hot}) == part[0][1]
    assert fk.launches - l0 == len(parts) == len(captured)
    for params, db, h in captured:
        buf, layout = fuse_batch(db)
        want = fk.fused_packed_plain(params, defuse(
            torch.from_numpy(buf).to(card), layout)).cpu().numpy()
        got = np.asarray(h.wait())
        assert got.shape == want.shape and np.array_equal(got, want)
    snap = engine._snapshot
    for (rule, skipped), d, n in zip(out, docs, names):
        own, _, w_skip = host_results(snap.policy, d,
                                      snap.policy.config_ids[n])
        assert bool(np.all(skipped | rule)) == own
        assert skipped.tolist() == w_skip.tolist()


def test_strict_verify_rejects_a_mutant_with_no_device_bytes(card,
                                                             monkeypatch):
    """Under strict verify a miscompiled corpus (a planted DFA transition
    or row permutation, a wrong readback width) is rejected before any
    byte of it reaches the card: device memory +0 B, no mega-kernel or
    probe launch, and the serving snapshot still answers exactly."""
    from authorino_tpu_torch.analysis.translation_validate import _MUTANTS
    from authorino_tpu_torch.runtime.engine import SnapshotRejected
    from authorino_tpu_torch.snapshots import compile_cache as cc

    cfgs = northstar.build_corpus(16, 10)
    engine = PolicyEngine(device=card, max_batch=64, strict_verify=True,
                          verdict_cache_size=0, analyze_policies=False)
    engine.apply_snapshot([EngineEntry(id=c.name, hosts=[c.name], rules=c)
                           for c in cfgs])
    snap = engine._snapshot
    docs = northstar.build_docs(64, seed=3)
    names = [f"cfg-{k % 16}" for k in range(64)]
    real = cc.compile_corpus
    plants = {
        "dfa-transition": dict(_MUTANTS)["dfa-transition-corrupt"],
        "dfa_row_perm": lambda p: setattr(
            p, "dfa_row_perm", np.zeros_like(p.dfa_row_perm)),
        "fused_pack_w": lambda p: setattr(p, "fused_pack_w",
                                          int(p.fused_pack_w) + 1),
    }
    for name, plant in plants.items():
        def bad(*a, _plant=plant, **k):
            p = real(*a, **k)
            _plant(p)
            return p

        monkeypatch.setattr(cc, "compile_corpus", bad)
        changed = northstar.build_corpus(16, 10, changed={3: "const"})
        torch.cuda.synchronize(card)
        mem0 = torch.cuda.memory_allocated(card)
        l0, p0 = fk.launches, fk.probe_launches
        with pytest.raises(SnapshotRejected):
            engine.apply_snapshot([EngineEntry(id=c.name, hosts=[c.name],
                                               rules=c) for c in changed])
        torch.cuda.synchronize(card)
        assert torch.cuda.memory_allocated(card) == mem0, name
        assert (fk.launches, fk.probe_launches) == (l0, p0), name
        assert engine._snapshot is snap
        monkeypatch.setattr(cc, "compile_corpus", real)
        out = asyncio.run(_gather(engine, docs, names))
        for (rule, skipped), d, n in zip(out, docs, names):
            own, _, _ = host_results(snap.policy, d,
                                     snap.policy.config_ids[n])
            assert bool(np.all(skipped | rule)) == own


def test_captured_firing_columns_equal_the_plain_version(card):
    """Capture at 1-in-1 over a burst on the card: each captured record's
    firing column is the one the plain version computes on the same
    operands, and the host oracle's."""
    from authorino_tpu_torch.ops.operands import (defuse, firing_columns,
                                                  unpack_attribution)
    from authorino_tpu_torch.replay.capture import CAPTURE

    cfgs = northstar.build_corpus(16, 10)
    engine = PolicyEngine(device=card, max_batch=64, verdict_cache_size=0,
                          batch_dedup=False)
    engine.apply_snapshot([EngineEntry(id=c.name, hosts=[c.name], rules=c)
                           for c in cfgs])
    snap = engine._snapshot
    docs = northstar.build_docs(128, seed=9)
    names = [f"cfg-{k % 16}" for k in range(128)]
    CAPTURE.configure(enabled=True, size_mb=16, sample_n=1)
    CAPTURE.clear()
    try:
        l0 = fk.launches
        asyncio.run(_gather(engine, docs, names))
        assert fk.launches > l0
        assert CAPTURE.flush()
        recs = CAPTURE.ring_records()
    finally:
        CAPTURE.configure(enabled=False)
        CAPTURE.clear()
    assert len(recs) == 128
    E = int(snap.policy.eval_rule.shape[1])
    for r in recs:
        row = snap.policy.config_ids[r["authconfig"]]
        db = pack_batch(snap.policy, encode_batch(snap.policy, [r["doc"]],
                                                  [row], batch_pad=16))
        buf, layout = fuse_batch(db)
        plain = fk.fused_packed_plain(snap.params, defuse(
            torch.from_numpy(buf).to(card), layout)).cpu().numpy()
        _, firing = unpack_attribution(plain[:1], E)
        _, rule, skipped = host_results(snap.policy, r["doc"], row)
        want = int(firing_columns(rule[None], skipped[None])[0])
        assert r["rule_index"] == int(firing[0]) == want


def _published(tmp_path, cfgs, card):
    """A strict-verify leader on the card over ``cfgs`` publishing into
    ``tmp_path``; returns (leader, publisher, directory)."""
    from authorino_tpu_torch.snapshots.distribution import SnapshotPublisher

    d = str(tmp_path / "pub")
    leader = PolicyEngine(device=card, max_batch=64, strict_verify=True,
                          verdict_cache_size=0, batch_dedup=False)
    pub = SnapshotPublisher(d)
    pub.attach(leader)
    leader.apply_snapshot([EngineEntry(id=c.name, hosts=[c.name], rules=c)
                           for c in cfgs])
    assert pub.flush()
    return leader, pub, d


def test_replica_readback_on_the_card_equals_the_leader_and_plain(
        card, tmp_path):
    """A replica on the card installs the leader's blob without compiling
    (its params are its own upload of the loaded policy): one batch's
    [B, W] readback is byte-equal to the leader's and to the plain
    version's; a one-config republish lands as a delta with the same
    readbacks as a full upload."""
    from authorino_tpu_torch.snapshots.distribution import SnapshotReplica

    cfgs = northstar.build_corpus(64, 10)
    leader, pub, d = _published(tmp_path, cfgs, card)
    replica = PolicyEngine(device=card, max_batch=64, verdict_cache_size=0,
                           batch_dedup=False)
    rep = SnapshotReplica(replica, d, poll_s=0.2)
    assert rep.poll_once()
    snap = replica._snapshot
    assert snap.compile_report is None and snap.upload["mode"] == "full"
    docs = northstar.build_docs(64, seed=5)
    rows = [k % 64 for k in range(64)]
    db = pack_batch(snap.policy, encode_batch(snap.policy, docs, rows))
    got = fk.eval_fused_kernel(snap.params, db).cpu().numpy()
    want = fk.eval_fused_kernel(leader._snapshot.params, db).cpu().numpy()
    plain = fk.eval_fused_kernel(to_device(snap.policy, device="cpu"),
                                 db).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, plain)
    changed = northstar.build_corpus(64, 10, changed={9: "const"})
    leader.apply_snapshot([EngineEntry(id=c.name, hosts=[c.name], rules=c)
                           for c in changed])
    assert pub.flush() and rep.poll_once()
    snap2 = replica._snapshot
    assert snap2.upload["mode"] == "delta"
    assert snap2.upload["upload_bytes"] < snap2.upload["full_bytes"]
    db2 = pack_batch(snap2.policy, encode_batch(snap2.policy, docs, rows))
    np.testing.assert_array_equal(
        fk.eval_fused_kernel(snap2.params, db2).cpu().numpy(),
        fk.eval_fused_kernel(to_device(snap2.policy, device=card),
                             db2).cpu().numpy())


@pytest.mark.parametrize("bad", ["uncertified", "torn"])
def test_rejected_blob_allocates_nothing_on_the_card(card, tmp_path, bad):
    """An uncertified blob (rejected at admission) and a torn one
    (rejected at load) leave the replica's card untouched: +0 B, no
    mega-kernel or probe launch, the old generation still answering."""
    import hashlib
    import json
    import os

    from authorino_tpu_torch.compiler import compile_corpus as compile_
    from authorino_tpu_torch.snapshots import (rules_fingerprint,
                                               serialize_policy)
    from authorino_tpu_torch.snapshots.distribution import SnapshotReplica

    cfgs = northstar.build_corpus(16, 10)
    leader, pub, d = _published(tmp_path, cfgs, card)
    replica = PolicyEngine(device=card, max_batch=64, verdict_cache_size=0,
                           batch_dedup=False)
    rep = SnapshotReplica(replica, d, poll_s=0.2)
    assert rep.poll_once()
    snap = replica._snapshot
    changed = northstar.build_corpus(16, 10, changed={2: "const"})
    if bad == "uncertified":
        pub.publish_blob(serialize_policy(compile_(changed, members_k=16),
                         meta={"generation": 99, "certified": False,
                               "fingerprints": {c.name: rules_fingerprint(c)
                                                for c in changed},
                               "entries": [{"id": c.name,
                                            "hosts": [c.name]}
                                           for c in changed]}), 99)
    else:
        man = json.load(open(os.path.join(d, "MANIFEST.json")))
        p = os.path.join(d, man["current"])
        raw = bytearray(open(p, "rb").read())
        raw[len(raw) // 3] ^= 0xFF
        open(p, "wb").write(bytes(raw))
        man["sha256"] = hashlib.sha256(bytes(raw)).hexdigest()
        open(os.path.join(d, "MANIFEST.json"), "w").write(json.dumps(man))
    torch.cuda.synchronize(card)
    mem0 = torch.cuda.memory_allocated(card)
    l0, p0 = fk.launches, fk.probe_launches
    assert rep.poll_once() is False
    torch.cuda.synchronize(card)
    assert torch.cuda.memory_allocated(card) == mem0
    assert (fk.launches, fk.probe_launches) == (l0, p0)
    assert replica._snapshot is snap
    assert (rep.rejected, rep.errors) == ((1, 0) if bad == "uncertified"
                                          else (0, 1))
    docs = northstar.build_docs(32, seed=4)
    names = [f"cfg-{k % 16}" for k in range(32)]
    out = asyncio.run(_gather(replica, docs, names))
    for (rule, skipped), dd, n in zip(out, docs, names):
        own, _, _ = host_results(snap.policy, dd, snap.policy.config_ids[n])
        assert bool(np.all(skipped | rule)) == own


# ---- the gather and matmul lanes and the staged baseline ------------------


def lane_readbacks(policy, db, card):
    """[B, W] readbacks of one batch: every lane and the staged baseline on
    the card, the mega-kernel, and its plain version on the CPU."""
    from authorino_tpu_torch.ops import pattern_eval as pe

    out = {lane: np.asarray(pe.dispatch_fused(
        pe.to_device(policy, device=card, lane=lane), db))
        for lane in ("gather", "matmul", "fused")}
    out["staged"] = fk.dispatch_staged(
        pe.to_device(policy, device=card, lane="fused"), db).cpu().numpy()
    out["plain"] = fk.eval_fused_kernel(to_device(policy, device="cpu"),
                                        db).numpy()
    return out


@pytest.mark.parametrize("seed", [7, 19, 31])
@pytest.mark.parametrize("assist", [True, False])
def test_every_lane_equals_the_megakernel_on_the_card(card, seed, assist):
    from authorino_tpu_torch.ops import pattern_eval as pe

    policy, docs, rows = lanes_case(seed, assist)
    db = pack_batch(policy, encode_batch(policy, docs, rows, batch_pad=64))
    params = pe.to_device(policy, device=card, lane="matmul")
    assert params["matmul"]["rule_m"].dtype == torch.bfloat16
    assert params["matmul"]["rule_m"].device.type == "cuda"
    got = lane_readbacks(policy, db, card)
    for name, packed in got.items():
        np.testing.assert_array_equal(packed, got["fused"], err_msg=name)


@pytest.mark.parametrize("width", [300, 2100])
def test_matmul_lane_exact_under_tf32_and_bf16_traps(card, width):
    """An And of ``width`` children and, in its level, Ands of 5 and 3
    children padded to ``width`` with TRUE (counts 295/297 that bf16 cannot
    hold, or 2095/2097 that TF32 cannot), with one false child in each in
    turn, and interner ids past 2^11, with TF32 switched on for the run:
    the matmul readback is the gather lane's and the mega-kernel's."""
    from authorino_tpu_torch.compiler import ConfigRules
    from authorino_tpu_torch.compiler.intern import StringInterner
    from authorino_tpu_torch.expressions import All, Operator, Pattern

    narrow = (5, 3)
    interner = StringInterner()
    for i in range(3000):
        interner.intern(f"filler-{i}")
    rule = All(*[Pattern(f"auth.identity.k{j}", Operator.EQ, f"v{j}")
                 for j in range(width)])
    evaluators = [(None, rule)] + [
        (None, All(*[Pattern(f"auth.identity.n{n}_{j}", Operator.EQ, f"w{j}")
                     for j in range(n)])) for n in narrow]
    policy = compile_corpus([ConfigRules(name="wide", evaluators=evaluators)],
                            members_k=4, interner=interner)
    assert int(policy.leaf_const.max()) >= 1 << 11
    full = {f"k{j}": f"v{j}" for j in range(width)}
    for n in narrow:
        full.update({f"n{n}_{j}": f"w{j}" for j in range(n)})
    off = [dict(full, k7="nope")] + [dict(full, **{f"n{n}_1": "nope"})
                                     for n in narrow]
    docs = [{"auth": {"identity": d}} for d in [full, *off, {}]] * 4
    db = pack_batch(policy, encode_batch(policy, docs, [0] * len(docs)))
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = lane_readbacks(policy, db, card)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    for name, packed in got.items():
        np.testing.assert_array_equal(packed, got["gather"], err_msg=name)
    assert [bool(b & 1) for b in got["matmul"][:5, 0]] == \
        [True, False, False, False, False]
    assert [got["matmul"][d, 0] >> 1 & 7 for d in range(4)] == \
        [7, 6, 5, 3]


@pytest.mark.parametrize("lane", ["gather", "matmul"])
def test_engine_on_a_lane_launches_no_megakernel(card, lane):
    cfgs = northstar.build_corpus(40, 10)
    engine = PolicyEngine(max_batch=64, device=card, kernel_lane=lane,
                          verdict_cache_size=0, batch_dedup=False)
    engine.apply_snapshot([EngineEntry(id=c.name, hosts=[c.name], rules=c)
                           for c in cfgs])
    docs = northstar.build_docs(128, seed=5)
    names = [cfgs[i % len(cfgs)].name for i in range(len(docs))]
    l0 = fk.launches

    async def go():
        return await asyncio.gather(*(engine.submit(d, n)
                                      for d, n in zip(docs, names)))

    loop = asyncio.new_event_loop()
    try:
        out = loop.run_until_complete(go())
    finally:
        loop.close()
    assert fk.launches == l0
    policy = engine._snapshot.policy
    for (rule, skipped), d, n in zip(out, docs, names):
        own, w_rule, w_skip = host_results(policy, d, policy.config_ids[n])
        assert skipped.tolist() == w_skip.tolist()
        assert rule[~w_skip].tolist() == w_rule[~w_skip].tolist()


@pytest.mark.parametrize("dp,mp", [(1, 1), (2, 1), (2, 2), (4, 2)])
def test_mesh_on_card_slots_equals_plain_and_the_megakernel(card, dp, mp):
    """The mesh over logical slots of one card: the [B, W] own-rows
    readback is byte-equal to the same mesh over CPU slots (the op chain's
    plain run) and its columns equal the single-corpus mega-kernel's on
    every row neither side sent to the host fallback."""
    from authorino_tpu_torch.ops.operands import unpack_verdicts
    from authorino_tpu_torch.parallel import ShardedPolicyModel, build_mesh

    cfgs = northstar.build_corpus(64, 10)
    docs = northstar.build_docs(256, seed=5)
    names = [cfgs[(k * 7) % 64].name for k in range(256)]
    on_card = ShardedPolicyModel(cfgs, build_mesh([card] * (dp * mp), dp=dp))
    on_cpu = ShardedPolicyModel(
        cfgs, build_mesh([torch.device("cpu")] * (dp * mp), dp=dp))
    enc = on_card.encode(docs, names)
    got = np.asarray(on_card.dispatch_full(enc))
    np.testing.assert_array_equal(got, np.asarray(on_cpu.dispatch_full(enc)))
    policy = compile_corpus(cfgs)
    rows = [policy.config_ids[n] for n in names]
    db = pack_batch(policy, encode_batch(policy, docs, rows))
    mk = fk.eval_fused_kernel(to_device(policy, device=card), db)
    E = int(policy.eval_rule.shape[1])
    assert on_card.E == E
    a = unpack_verdicts(got, 1 + 2 * E)[:256]
    b = unpack_verdicts(mk.cpu().numpy(), 1 + 2 * E)[:256]
    ok = ~(enc.host_fallback[:256] | db.host_fallback[:256])
    np.testing.assert_array_equal(a[ok], b[ok])


def test_fleet_replica_readback_equals_its_leader(card, tmp_path):
    """A fleet replica on the card installs the leader's published blob:
    one batch's [B, W] mega-kernel readback is byte-equal to its
    leader's, and the verdicts routed through the fleet equal a single
    card engine's."""
    from authorino_tpu_torch.fleet import FleetHarness

    cfgs = northstar.build_corpus(64, 10)

    def factory():
        return PolicyEngine(device=card, max_batch=64, strict_verify=True,
                            verdict_cache_size=0, batch_dedup=False)

    h = FleetHarness(str(tmp_path / "fleet"), factory, poll_s=0.2)
    try:
        h.add_leader(entries=[EngineEntry(id=c.name, hosts=[c.name], rules=c)
                              for c in cfgs])
        rep = h.add_replica("r1", warm_join=False)
        lead_snap = h.leader.engine._snapshot
        rep_snap = rep.engine._snapshot
        assert rep_snap.compile_report is None
        docs = northstar.build_docs(64, seed=5)
        rows = [k % 64 for k in range(64)]
        db = pack_batch(rep_snap.policy,
                        encode_batch(rep_snap.policy, docs, rows))
        np.testing.assert_array_equal(
            fk.eval_fused_kernel(rep_snap.params, db).cpu().numpy(),
            fk.eval_fused_kernel(lead_snap.params, db).cpu().numpy())
        single = factory()
        single.apply_snapshot([EngineEntry(id=c.name, hosts=[c.name],
                                           rules=c) for c in cfgs])
        names = [cfgs[k % 64].name for k in range(64)]

        async def go():
            return await asyncio.gather(*(single.submit(d, n)
                                          for d, n in zip(docs, names)))

        loop = asyncio.new_event_loop()
        try:
            want = loop.run_until_complete(go())
        finally:
            loop.close()
        for (wr, ws), d, n in zip(want, docs, names):
            gr, gs = h.check(n, d)
            assert gr.tolist() == wr.tolist() and gs.tolist() == ws.tolist()
    finally:
        h.shutdown()


def test_card_engine_at_its_defaults_puts_no_row_on_a_host_lane(card):
    """The host lanes resolve off on a card: a burst and lone submits at
    the engine's defaults ride the mega-kernel (one launch per batch with
    a device row), every cut counts device/disabled, no row on the host
    lane, by brownout or speculation; the cost model still learns the
    card's round trip; an explicit lane_select=True raises."""
    cfgs = northstar.build_corpus(40, 10)
    engine = PolicyEngine(max_batch=64, device=card)
    engine.apply_snapshot([EngineEntry(id=c.name, hosts=[c.name], rules=c)
                           for c in cfgs])
    docs = northstar.build_docs(160, seed=9)
    names = [cfgs[i % len(cfgs)].name for i in range(len(docs))]
    l0 = fk.launches

    async def go():
        out = await asyncio.gather(*(engine.submit(d, n)
                                     for d, n in zip(docs[:128],
                                                     names[:128])))
        for d, n in zip(docs[128:], names[128:]):
            out.append(await engine.submit(d, n))
        return out

    loop = asyncio.new_event_loop()
    try:
        out = loop.run_until_complete(go())
    finally:
        loop.close()
    policy = engine._snapshot.policy
    for (rule, skipped), d, n in zip(out, docs, names):
        own, w_rule, w_skip = host_results(policy, d, policy.config_ids[n])
        assert skipped.tolist() == w_skip.tolist()
        assert rule[~w_skip].tolist() == w_rule[~w_skip].tolist()
    ls = engine.debug_vars()["lane_select"]
    st = engine.stats
    assert not ls["enabled"] and not engine.brownout
    assert ls["rows"]["host"] == 0 and ls["speculative_outcomes"] == {}
    assert st["host_lane_rows"] == st["brownout_rows"] == 0
    assert ls["decisions"] == {"device:disabled": st["batches"]}
    device_batches = sum(1 for r in engine.batch_records if r["device_rows"])
    assert fk.launches - l0 == st["launches"] == device_batches
    assert ls["cost"]["device_batches"] == device_batches
    assert ls["cost"]["device_rtt_ewma_s"] > 0
    with pytest.raises(ValueError, match="only the mega-kernel"):
        PolicyEngine(device=card, lane_select=True)
