"""Batch dedup and the verdict cache of the port's engine against the JAX
package's: row keys, the dedup plan and the re-padded row subset
byte-equal on the all-lanes and north-star corpora; the per-config
fingerprints, encoding epoch and cache tokens string-equal; the same
(rule, skipped) per request and the same dedup and cache row counts as the
reference engine with both on and both off; a verdict never served stale
across a swap, uncacheable configs bypassing the cache, the LRU bound and
the switches off (the cases of ``tests/test_dedup_cache.py``).  Tolerance
0 throughout: every output is an integer, a boolean or a string."""

import asyncio
import random
import threading
import time

import numpy as np
import pytest

from authorino_tpu.compiler import pack as r_pack
from authorino_tpu.runtime import EngineEntry as RefEntry
from authorino_tpu.runtime import PolicyEngine as RefEngine
from authorino_tpu.runtime.kernel_cost import LEDGER
from authorino_tpu.snapshots import fingerprint as r_fp
from authorino_tpu_torch.compiler import pack as p_pack
from authorino_tpu_torch.models import northstar
from authorino_tpu_torch.runtime import EngineEntry, PolicyEngine
from authorino_tpu_torch.snapshots import fingerprint as p_fp
from authorino_tpu_torch.utils import bucket_pow2
from authorino_tpu_torch.utils.verdict_cache import VerdictCache

from test_torch_compiler import (CASES, PORT, REF, all_lanes_corpus,
                                 all_lanes_docs, assert_same, batch_of,
                                 build_case, convert_config, northstar_corpus)
from test_torch_dispatch import wait_until_sync

_FIELDS = ("attrs_val", "members_c", "cpu_dense", "config_id", "attr_bytes",
           "byte_ovf", "host_fallback", "attrs_num", "num_valid", "rel_rows",
           "member_ovf")


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def with_repeats(docs, rows, seed):
    """The batch with a third of its rows repeated at random places."""
    rng = random.Random(seed)
    docs, rows = list(docs), list(rows)
    for _ in range(len(docs) // 3):
        i, j = rng.randrange(len(docs)), rng.randrange(len(docs) + 1)
        docs.insert(j, docs[i])
        rows.insert(j, rows[i])
    return docs, rows


# ---- row keys, the dedup plan and the row subset --------------------------

@pytest.mark.parametrize("kind,seed,ovf_assist", CASES)
def test_row_keys_dedup_and_select_equal_reference(kind, seed, ovf_assist):
    rp, pp, docs, rows = build_case(kind, seed, ovf_assist)
    docs, rows = with_repeats(docs, rows, seed)
    n = len(docs)
    r_db = batch_of(REF, rp, docs, rows, batch_pad=bucket_pow2(n))
    p_db = batch_of(PORT, pp, docs, rows, batch_pad=bucket_pow2(n))
    keys = p_pack.batch_row_keys(p_db, n)
    assert keys == r_pack.batch_row_keys(r_db, n)
    for subset in (list(range(n)), list(range(0, n, 2))):
        unique, inverse = p_pack.dedup_rows(keys, subset)
        r_unique, r_inverse = r_pack.dedup_rows(keys, subset)
        assert unique == r_unique
        assert_same(r_inverse, inverse)
        assert len(unique) < len(subset)
        pad_u = bucket_pow2(len(unique))
        got = p_pack.select_rows(p_db, unique, batch_pad=pad_u)
        want = r_pack.select_rows(r_db, unique, batch_pad=pad_u)
        for f in _FIELDS:
            assert_same(getattr(want, f), getattr(got, f), f)
        assert got.attrs_val.shape[0] == pad_u
    assert p_pack.row_key_bytes([np.zeros((4, 2), np.int32)], 0) == []


# ---- fingerprints, the encoding epoch, cache tokens ------------------------

@pytest.mark.parametrize("kind,seed,ovf_assist", CASES)
def test_fingerprints_epoch_and_tokens_equal_reference(kind, seed,
                                                       ovf_assist):
    rp, pp, _, _ = build_case(kind, seed, ovf_assist, n_docs=1)
    cfgs = {"ref": (all_lanes_corpus(seed, REF) if kind == "lanes"
                    else northstar_corpus(REF, 50)),
            "port": (all_lanes_corpus(seed, PORT) if kind == "lanes"
                     else northstar_corpus(PORT, 50))}
    r_fps = {c.name: r_fp.rules_fingerprint(c) for c in cfgs["ref"]}
    p_fps = {c.name: p_fp.rules_fingerprint(c) for c in cfgs["port"]}
    assert p_fps == r_fps
    # the epoch folds in the interner's process-unique serial: each
    # package counts its own, so pin the port's to the reference's
    pp.interner.serial = rp.interner.serial
    assert p_fp.encoding_epoch(pp) == r_fp.encoding_epoch(rp)
    assert p_fp.cache_tokens(pp, p_fps) == r_fp.cache_tokens(rp, r_fps)
    # a changed rule re-fingerprints only its config
    c0 = cfgs["port"][0]
    changed = PORT.ConfigRules(name=c0.name, evaluators=[
        (None, PORT.Pattern("request.method", PORT.Operator.EQ, "TRACE"))])
    assert p_fp.rules_fingerprint(changed) != p_fps[c0.name]


# ---- the engine against the reference engine -------------------------------

def ref_engine(**kw):
    return RefEngine(mesh=None, lane_select=False, brownout=False,
                     tenant_qos=False, kernel_lane="fused", **kw)


LEDGER_OF = {"rows": "rows", "device_rows": "device_rows",
             "dedup_rows": "dedup_avoided_rows",
             "cache_rows": "cache_avoided_rows", "batches": "batches",
             "cached_batches": "zero_launch_batches", "pad_rows": "pad_rows",
             "d2h_bytes": "d2h_bytes"}


@pytest.mark.parametrize("on", [True, False])
@pytest.mark.parametrize("kind", ["lanes", "northstar"])
def test_engine_verdicts_and_row_counts_equal_reference(kind, on):
    """Three bursts of at most max_batch submits each (one cut apiece, a
    wait between): a fresh one with repeats, the same again, and a mix of
    seen and new rows."""
    seed = 19
    if kind == "lanes":
        r_cfgs, p_cfgs = all_lanes_corpus(seed, REF), all_lanes_corpus(
            seed, PORT)
        k, docs = 4, all_lanes_docs(seed, 40)
    else:
        p_cfgs = northstar_corpus(PORT, 30)
        r_cfgs = [convert_config(c, REF) for c in p_cfgs]
        k, docs = 16, northstar.build_docs(40, seed=seed)
    rng = random.Random(seed)
    names = [rng.choice(p_cfgs).name for _ in docs]
    docs, names = with_repeats(docs, names, seed)
    fresh = all_lanes_docs(seed + 1, 12) if kind == "lanes" else docs[:12]
    bursts = [(docs[:48], names[:48]), (docs[:48], names[:48]),
              (docs[30:48] + fresh, names[30:48] + names[:12])]
    knobs = dict(verdict_cache_size=4096 if on else 0, batch_dedup=on,
                 max_batch=64, members_k=k)
    ref = ref_engine(**knobs)
    ref.apply_snapshot([RefEntry(id=c.name, hosts=[c.name], runtime=None,
                                 rules=c) for c in r_cfgs])
    port = PolicyEngine(device="cpu", lane_select=False, brownout=False,
                        **knobs)
    port.apply_snapshot([EngineEntry(id=c.name, hosts=[c.name], rules=c)
                         for c in p_cfgs])

    async def burst(engine, ds, ns):
        return await asyncio.gather(*(engine.submit(d, n)
                                      for d, n in zip(ds, ns)))

    for b, (ds, ns) in enumerate(bursts):
        led0 = LEDGER.snapshot("engine")
        want = run(burst(ref, ds, ns))
        led1 = LEDGER.snapshot("engine")
        st0 = dict(port.stats)
        got = run(burst(port, ds, ns))
        assert wait_until_sync(lambda: port._inflight == 0)
        for i, ((wr, ws), (gr, gs)) in enumerate(zip(want, got)):
            assert np.asarray(wr).tolist() == gr.tolist(), (b, i)
            assert np.asarray(ws).tolist() == gs.tolist(), (b, i)
        delta = {k: port.stats[k] - st0[k] for k in LEDGER_OF}
        assert delta == {k: led1[v] - led0[v] for k, v in LEDGER_OF.items()}
        assert delta["rows"] == len(ds) == (delta["device_rows"]
                                            + delta["dedup_rows"]
                                            + delta["cache_rows"])
        if on:
            assert delta["dedup_rows"] + delta["cache_rows"] > 0
        else:
            assert delta["device_rows"] == len(ds)


# ---- the structural contract -----------------------------------------------

def test_structural_contract_with_dedup_and_cache():
    """One launch (here: one plain call) per batch with an uncached
    unique row, none for a batch the cache answers whole; D2H = Σ pad_u ×
    W; rows = device rows + rows saved by dedup + rows saved by the
    cache."""
    cfgs = northstar_corpus(PORT, 20)
    # the host lanes off: every cut rides the cache and the plain version
    engine = PolicyEngine(max_batch=64, device="cpu", lane_select=False,
                          brownout=False)
    engine.apply_snapshot([EngineEntry(id=c.name, hosts=[c.name], rules=c)
                           for c in cfgs])
    W = engine._snapshot.policy.fused_pack_w
    docs = northstar.build_docs(16, seed=5)
    ds = [docs[i % 16] for i in range(60)]
    ns = [cfgs[i % 16].name for i in range(60)]

    async def burst():
        return await asyncio.gather(*(engine.submit(d, n)
                                      for d, n in zip(ds, ns)))

    first = run(burst())
    assert wait_until_sync(lambda: engine._inflight == 0)
    second = run(burst())
    assert wait_until_sync(lambda: engine._inflight == 0)
    recs = list(engine.batch_records)
    assert [(r["rows"], r["device_rows"], r["dedup_rows"], r["cache_rows"],
             r["pad_rows"], r["plain_calls"]) for r in recs] == \
        [(60, 16, 44, 0, 16, 1), (60, 0, 0, 60, 0, 0)]
    for r in recs:
        assert r["d2h_bytes"] == r["pad_rows"] * W
        assert r["launches"] == 0   # the CPU runs the plain version
    st = engine.stats
    assert st["cached_batches"] == 1 and st["batches"] == 2
    assert st["d2h_bytes"] == st["pad_rows"] * W
    for (r1, s1), (r2, s2) in zip(first, second):
        assert r1.tolist() == r2.tolist() and s1.tolist() == s2.tolist()


# ---- the reference's engine cases ------------------------------------------

RULE_ACME = PORT.Pattern("auth.identity.org", PORT.Operator.EQ, "acme")
RULE_EVIL = PORT.Pattern("auth.identity.org", PORT.Operator.EQ, "evil")


def entry(name, rule):
    return EngineEntry(id=name, hosts=[name], rules=PORT.ConfigRules(
        name=name, evaluators=[(None, rule)]))


def build_engine(rule=RULE_ACME, **kw) -> PolicyEngine:
    kw.setdefault("max_batch", 8)
    # the host lanes off: lane selection decides ahead of the verdict cache
    kw.setdefault("lane_select", False)
    kw.setdefault("brownout", False)
    engine = PolicyEngine(members_k=4, device="cpu", **kw)
    engine.apply_snapshot([entry("c", rule)])
    return engine


def doc(org="acme"):
    return {"auth": {"identity": {"org": org}}}


def test_engine_results_identical_with_and_without_dedup_cache():
    on = build_engine(verdict_cache_size=1024, batch_dedup=True)
    off = build_engine(verdict_cache_size=0, batch_dedup=False)
    orgs = ["acme", "evil", "acme", "acme", "zed", "evil", "acme", "acme"]

    async def drive(engine):
        return await asyncio.gather(*(engine.submit(doc(o), "c")
                                      for o in orgs))

    got_on, got_off = run(drive(on)), run(drive(off))
    for (r1, s1), (r2, s2) in zip(got_on, got_off):
        np.testing.assert_array_equal(r1, r2)
        np.testing.assert_array_equal(s1, s2)
    assert [bool(r[0]) for r, _ in got_on] == [o == "acme" for o in orgs]
    # "evil" and "zed" are no constant of the rule: both encode as the
    # unseen id, so the batch holds two distinct rows
    assert on.stats["device_rows"] == 2 and off.stats["device_rows"] == 8


def test_engine_verdict_cache_hits_repeat_rows():
    engine = build_engine(verdict_cache_size=1024)

    async def burst():
        return await asyncio.gather(*(engine.submit(doc("acme"), "c")
                                      for _ in range(6)))

    run(burst())
    hits0 = engine._verdict_cache.hits
    outs = run(burst())
    assert engine._verdict_cache.hits == hits0 + 6
    assert all(bool(r[0]) for r, _ in outs)


def test_snapshot_swap_never_serves_stale_cached_verdict():
    """Entries inserted under generation G must not satisfy lookups under
    G+1 for the changed config, even while a gated G batch is still
    completing; its late inserts land under G's tokens."""
    engine = build_engine(rule=RULE_ACME, verdict_cache_size=1024)
    run(engine.submit(doc("acme"), "c"))  # seed the G cache
    assert engine._verdict_cache.adds >= 1
    gate = threading.Event()
    real = engine._encode_and_launch
    gated_launches = []

    class GatedHandle:
        def __init__(self, inner):
            self.inner = inner

        def is_ready(self):
            return gate.is_set() and self.inner.is_ready()

        def wait(self):
            return self.inner.wait()

    def gated(snap, batch):
        item = real(snap, batch)
        item.handle = GatedHandle(item.handle)
        gated_launches.append(item)
        return item

    engine._encode_and_launch = gated

    async def body():
        pre = [asyncio.ensure_future(engine.submit(doc("evil"), "c"))
               for _ in range(4)]
        deadline = time.monotonic() + 30
        while not gated_launches and time.monotonic() < deadline:
            await asyncio.sleep(0.005)
        assert gated_launches
        engine._encode_and_launch = real
        engine.apply_snapshot([entry("c", RULE_EVIL)])
        post = await asyncio.gather(*(engine.submit(doc("acme"), "c")
                                      for _ in range(3)))
        assert not any(bool(r[0]) for r, _ in post)   # G's ALLOW not served
        post_evil = await engine.submit(doc("evil"), "c")
        assert bool(post_evil[0][0])
        gate.set()
        outs = await asyncio.wait_for(asyncio.gather(*pre), 30)
        assert not any(bool(r[0]) for r, _ in outs)   # G: evil denied

    run(body())
    out = run(engine.submit(doc("evil"), "c"))
    assert bool(out[0][0])


def test_swap_keeps_an_unchanged_configs_entries():
    """A swap that changes one config: the changed one misses and answers
    its new rule, the unchanged one is answered from the cache."""
    engine = PolicyEngine(members_k=4, device="cpu", max_batch=8,
                          lane_select=False, brownout=False)
    engine.apply_snapshot([entry("a", RULE_ACME), entry("b", RULE_ACME)])

    async def both():
        return [await engine.submit(doc("acme"), n) for n in ("a", "b")]

    run(both())
    engine.apply_snapshot([entry("a", RULE_EVIL), entry("b", RULE_ACME)])
    hits0, miss0 = engine._verdict_cache.hits, engine._verdict_cache.misses
    (ra, _), (rb, _) = run(both())
    assert not bool(ra[0]) and bool(rb[0])
    assert engine._verdict_cache.hits == hits0 + 1
    assert engine._verdict_cache.misses == miss0 + 1


def test_non_cacheable_configs_bypass_the_cache():
    rule = PORT.All(PORT.Pattern("request.id", PORT.Operator.NEQ, ""),
                    PORT.Pattern("auth.identity.org", PORT.Operator.EQ,
                                 "acme"))
    policy = PORT.compile_corpus([PORT.ConfigRules(name="c", evaluators=[
        (None, rule)])])
    assert not bool(policy.config_cacheable[0])
    engine = build_engine(rule=rule, verdict_cache_size=1024)
    d = {"request": {"id": "r-1"}, "auth": {"identity": {"org": "acme"}}}

    async def twice():
        return await engine.submit(d, "c"), await engine.submit(d, "c")

    (r1, _), (r2, _) = run(twice())
    assert bool(r1[0]) and bool(r2[0])
    vc = engine._verdict_cache
    assert vc.adds == 0 and vc.hits == 0
    assert engine.stats["device_rows"] == 2


def test_dedup_and_cache_can_be_disabled():
    engine = build_engine(verdict_cache_size=0, batch_dedup=False)

    async def burst():
        return await asyncio.gather(*(engine.submit(doc("acme"), "c")
                                      for _ in range(6)))

    assert all(bool(r[0]) for r, _ in run(burst()))
    assert engine._verdict_cache is None
    assert engine.stats["device_rows"] == 6
    assert engine.stats["dedup_rows"] == engine.stats["cache_rows"] == 0


def test_verdict_cache_lru_bound_and_counters():
    vc = VerdictCache(max_entries=2)
    vc.put(("g1", b"a"), 1)
    vc.put(("g1", b"b"), 2)
    assert vc.get(("g1", b"a")) == 1
    vc.put(("g1", b"c"), 3)                   # evicts b (LRU)
    assert vc.get(("g1", b"b")) is None
    assert vc.get(("g1", b"a")) == 1
    assert vc.evictions == 1 and vc.adds == 3
    assert vc.hits == 2 and vc.misses == 1
    assert len(vc) == 2
    assert [k for k, _ in vc.hottest(5)] == [("g1", b"a"), ("g1", b"c")]


def test_verdict_cache_token_keys_are_disjoint():
    vc = VerdictCache()
    vc.put((("e1", "fp"), b"row"), "old")
    assert vc.get((("e2", "fp"), b"row")) is None
    assert vc.get((("e1", "fp2"), b"row")) is None
