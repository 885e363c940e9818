"""The port's incremental control plane against the JAX package's.

The per-config compile cache, the snapshot diff, the delta upload and the
snapshot container, each held to the reference's own answer on the same
seeded corpora, built once per package with its own expression classes
(tolerance 0: every operand is an integer or boolean array, every verdict
a boolean, every blob bytes).

The churn properties end to end: re-reconciling an unchanged corpus
compiles zero configs and uploads zero bytes; changing one config compiles
exactly that one and ships only the rows it touched, into fresh tensors
(the previous snapshot's stay untouched), keeps at least 95% of the
warmed verdict-cache entries reachable, and every verdict equals a cold
compile of the same corpus.  Three kinds of one-config change: a constant
(the shape stays: ``rows``), an added leaf (the per-config program's CSR
offsets ``cfg_off`` shift) and an added regex (the DFA image changes).

On the CPU the params live on the CPU; ``tests/test_torch_cuda.py`` holds
a delta on the card to a full upload."""

from __future__ import annotations

import asyncio
import threading
import time

import numpy as np
import pytest
import torch

from authorino_tpu.ops.pattern_eval import to_device as r_to_device
from authorino_tpu.runtime import EngineEntry as RefEntry
from authorino_tpu.runtime import PolicyEngine as RefEngine
from authorino_tpu.snapshots import CompileCache as RefCompileCache
from authorino_tpu.snapshots import format_snapshot_diff as r_format_diff
from authorino_tpu.snapshots import rules_fingerprint as r_fingerprint
from authorino_tpu.snapshots import snapshot_diff as r_snapshot_diff
from authorino_tpu.snapshots.delta import apply_delta as r_apply_delta
from authorino_tpu.snapshots.diff import plan_delta as r_plan_delta
from authorino_tpu.snapshots.serialize import SnapshotFormatError as RefFormatError
from authorino_tpu.snapshots.serialize import deserialize_policy as r_deserialize
from authorino_tpu.snapshots.serialize import serialize_policy as r_serialize
from authorino_tpu_torch.compiler.encode import encode_batch
from authorino_tpu_torch.compiler.pack import pack_batch
from authorino_tpu_torch.models.policy_model import host_results
from authorino_tpu_torch.ops import fused_kernel as p_fk
from authorino_tpu_torch.ops.operands import (host_operands, host_view,
                                              params_from_numpy, to_device)
from authorino_tpu_torch.runtime import EngineEntry, PolicyEngine
from authorino_tpu_torch.snapshots import compile_cache as port_compile_cache
from authorino_tpu_torch.snapshots import (CompileCache, SnapshotFormatError,
                                           deserialize_policy,
                                           format_snapshot_diff, plan_delta,
                                           rules_fingerprint, serialize_policy,
                                           snapshot_diff)
from authorino_tpu_torch.snapshots.delta import apply_delta, view_bytes
from authorino_tpu_torch.snapshots.diff import flatten_view

from test_torch_compiler import (PORT, REF, all_lanes_corpus, all_lanes_docs,
                                 assert_same, assert_same_policy,
                                 to_numpy_tree)

K = 4


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


# ---- the corpora, built with each package's classes ------------------------

CHANGES = ("const", "leaf", "regex")


def make_corpus(ns, n=20, mutated=(), change="const"):
    """The reference's churn corpus (``tests/test_snapshots.py::
    make_corpus``) with ``ns``'s classes: config i is
    ``method ∧ (org ∨ role ∨ url ~ ^/svc-{i%3}/)``.  A mutated config
    changes by ``change``: ``const`` its org constant, ``leaf`` one more
    leaf beside the method, ``regex`` one more regex leaf there."""
    cfgs = []
    for i in range(n):
        mut = i in mutated
        const = f"org-{i}" + ("-MUT" if mut and change == "const" else "")
        kids = [ns.Pattern("request.method", ns.Operator.EQ,
                           ["GET", "POST"][i % 2]),
                ns.Any_(
                    ns.Pattern("auth.identity.org", ns.Operator.EQ, const),
                    ns.Pattern("auth.identity.roles", ns.Operator.INCL,
                               f"role-{i}"),
                    ns.Pattern("request.url_path", ns.Operator.MATCHES,
                               rf"^/svc-{i % 3}/"))]
        if mut and change == "leaf":
            kids.append(ns.Pattern("request.method", ns.Operator.NEQ,
                                   "DELETE"))
        if mut and change == "regex":
            kids.append(ns.Pattern("request.url_path", ns.Operator.MATCHES,
                                   r"^/(svc|api)-[0-9]+/"))
        cfgs.append(ns.ConfigRules(name=f"cfg-{i}",
                                   evaluators=[(None, ns.All(*kids))]))
    return cfgs


def doc(i):
    return {"request": {"method": ["GET", "POST"][i % 2],
                        "url_path": f"/svc-{i % 3}/x"},
            "auth": {"identity": {"org": f"org-{i}", "roles": []}}}


def port_entries(cfgs):
    return [EngineEntry(id=c.name, hosts=[c.name], rules=c) for c in cfgs]


def ref_entries(cfgs):
    return [RefEntry(id=c.name, hosts=[c.name], runtime=None, rules=c)
            for c in cfgs]


def port_engine(cfgs=None, **kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("verdict_cache_size", 4096)
    engine = PolicyEngine(members_k=K, device="cpu", lane_select=False,
                          **kw)
    if cfgs is not None:
        engine.apply_snapshot(port_entries(cfgs))
    return engine


def ref_engine(cfgs=None, **kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("verdict_cache_size", 4096)
    engine = RefEngine(members_k=K, mesh=None, lane_select=False,
                       kernel_lane="fused", **kw)
    if cfgs is not None:
        engine.apply_snapshot(ref_entries(cfgs))
    return engine


async def submit_all(engine, n):
    return await asyncio.gather(*[engine.submit(doc(i), f"cfg-{i}")
                                  for i in range(n)])


def both_verdicts(got, want):
    for i, ((gr, gs), (wr, ws)) in enumerate(zip(got, want)):
        assert np.asarray(gr).tolist() == np.asarray(wr).tolist(), i
        assert np.asarray(gs).tolist() == np.asarray(ws).tolist(), i


def tensors_of(tree, prefix=""):
    """{path: leaf} of a params tree (tensors and ints), cached launch
    words left out."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k != "launch_words":
                out.update(tensors_of(v, f"{prefix}.{k}" if prefix else k))
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            out.update(tensors_of(v, f"{prefix}.{i}"))
    else:
        out[prefix] = tree
    return out


def frozen(tree):
    """Copies of every tensor of a params tree, with its data pointer."""
    return {k: (v.data_ptr(), v.clone()) for k, v in tensors_of(tree).items()
            if isinstance(v, torch.Tensor)}


def assert_untouched(tree, before):
    for k, v in tensors_of(tree).items():
        if isinstance(v, torch.Tensor):
            ptr, copy = before[k]
            assert v.data_ptr() == ptr, k
            assert torch.equal(v, copy), k


# ---- fingerprints -----------------------------------------------------------


def test_fingerprints_equal_reference_and_see_through_object_identity():
    a, b = make_corpus(PORT)[3], make_corpus(PORT)[3]
    c = make_corpus(PORT, mutated={3})[3]
    assert a.evaluators[0][1] is not b.evaluators[0][1]
    assert rules_fingerprint(a) == rules_fingerprint(b)
    assert rules_fingerprint(a) != rules_fingerprint(c)
    renamed = PORT.ConfigRules(name="other", evaluators=list(a.evaluators))
    assert rules_fingerprint(renamed) == rules_fingerprint(a)
    for change in CHANGES:
        for p, r in zip(make_corpus(PORT, mutated={3}, change=change),
                        make_corpus(REF, mutated={3}, change=change)):
            assert rules_fingerprint(p) == r_fingerprint(r)


# ---- the compile cache ------------------------------------------------------


def test_unchanged_corpus_compiles_zero_and_uploads_zero():
    port, ref = port_engine(make_corpus(PORT)), ref_engine(make_corpus(REF))
    snap1 = port._snapshot
    port.apply_snapshot(port_entries(make_corpus(PORT)))  # fresh trees
    ref.apply_snapshot(ref_entries(make_corpus(REF)))
    snap2 = port._snapshot
    rep = snap2.compile_report
    assert rep.to_json() == ref._snapshot.compile_report.to_json()
    assert rep.compiled == 0 and rep.cached == 20 and rep.reused_policy
    # the whole device state and the port's host-side companions carry over
    for attr in ("policy", "params", "host_view", "cache_tokens", "encoder",
                 "heat"):
        assert getattr(snap2, attr) is getattr(snap1, attr), attr
    assert snap2.upload == ref._snapshot.upload
    assert snap2.upload["mode"] == "reuse"
    assert snap2.upload["upload_bytes"] == 0
    assert set(snap2.phase_s) == {"compile"}
    assert snap2.generation == snap1.generation + 1
    # the encoding epoch (the interner's identity) survives the swap
    assert snap2.cache_tokens == snap1.cache_tokens


@pytest.mark.parametrize("change", CHANGES)
def test_one_changed_config_compiles_exactly_it(change):
    port, ref = port_engine(make_corpus(PORT)), ref_engine(make_corpus(REF))
    prev = port._snapshot
    before = frozen(prev.params)
    port.apply_snapshot(port_entries(make_corpus(PORT, mutated={7},
                                                 change=change)))
    ref.apply_snapshot(ref_entries(make_corpus(REF, mutated={7},
                                               change=change)))
    snap, rsnap = port._snapshot, ref._snapshot
    rep = snap.compile_report
    assert rep.to_json() == rsnap.compile_report.to_json()
    assert rep.compiled_names == ["cfg-7"] and rep.cached == 19
    assert set(snap.phase_s) == {"compile", "diff", "upload"}
    # the plan over the fields both host views share is the reference's
    up, rup = snap.upload, rsnap.upload
    assert up["mode"] == rup["mode"] == "delta"
    mine = {t["name"]: t for t in up["arrays_touched"]}
    theirs = {t["name"]: t for t in rup["arrays_touched"]}
    assert {n for n in mine if not n.startswith("kernel.")} == set(theirs)
    for name, t in theirs.items():
        assert mine[name] == t, name
    kernel_up = sum(t["upload_bytes"] for n, t in mine.items()
                    if n.startswith("kernel."))
    assert up["upload_bytes"] == rup["upload_bytes"] + kernel_up
    # the port's plan and bytes are those of the diff of its host views
    plan = plan_delta(prev.host_view, snap.host_view)
    assert plan.to_json() == up
    assert up["full_bytes"] == view_bytes(snap.host_view)
    if change == "const":
        assert 0 < up["upload_bytes"] < up["full_bytes"] / 2
        assert {t["mode"] for t in mine.values()} == {"rows"}
    if change == "leaf":
        assert mine["kernel.cfg_off"]["mode"] == "full"
    if change == "regex":
        assert mine["kernel.dfa_image"]["mode"] == "full"
    # the new params equal a cold upload of the same corpus, and the
    # previous snapshot's tensors are untouched
    assert_same(to_numpy_tree(params_from_numpy(host_operands(snap.policy),
                                                device="cpu")),
                to_numpy_tree(snap.params))
    assert_untouched(prev.params, before)


def test_compile_cache_shares_artifacts_across_identical_configs():
    for ns, cache in ((PORT, CompileCache()), (REF, RefCompileCache())):
        rule = ns.All(ns.Pattern("auth.identity.org", ns.Operator.EQ, "acme"))
        a1, hit1 = cache.artifact_for(
            ns.ConfigRules(name="a", evaluators=[(None, rule)]))
        a2, hit2 = cache.artifact_for(
            ns.ConfigRules(name="b", evaluators=[(None, rule)]))
        assert not hit1 and hit2 and a1 is a2
        assert cache.stats()["entries"] == 1


def test_compile_cache_lru_bound(monkeypatch):
    monkeypatch.setattr(port_compile_cache, "_MAX_ENTRIES", 2)
    for ns, cache in ((PORT, CompileCache()),
                      (REF, RefCompileCache(max_entries=2))):
        for i in range(4):
            cache.artifact_for(ns.ConfigRules(name=f"c{i}", evaluators=[
                (None, ns.Pattern("auth.identity.org", ns.Operator.EQ,
                                  f"o{i}"))]))
        assert len(cache) == 2
        assert (cache.hits, cache.misses) == (0, 4)


def test_compile_cache_policy_equals_reference_and_cold_compile():
    """The cache's corpus compile (artifacts, the persistent interner and
    DFA memo) is array for array the reference cache's, and a cold compile
    of the same corpus with the cache's interner."""
    port, ref = CompileCache(), RefCompileCache()
    port.compile(make_corpus(PORT), members_k=K)
    ref.compile(make_corpus(REF), members_k=K)
    for change in CHANGES:
        pp, prep = port.compile(make_corpus(PORT, mutated={5}, change=change),
                                members_k=K)
        rp, rrep = ref.compile(make_corpus(REF, mutated={5}, change=change),
                               members_k=K)
        assert prep.to_json() == rrep.to_json()
        assert_same_policy(rp, pp)
        cold = PORT.compile_corpus(make_corpus(PORT, mutated={5},
                                               change=change),
                                   members_k=K, interner=port.interner)
        assert_same(host_operands(cold), host_operands(pp))
    assert port.stats() | {"interner_serial": 0} == \
        ref.stats() | {"interner_serial": 0}


# ---- the diff plan and the delta upload --------------------------------------


def plan_inputs():
    old = {"a": np.arange(64, dtype=np.int32).reshape(8, 8),
           "b": np.ones((4, 4), dtype=np.int32),
           "c": np.zeros((3,), dtype=np.int32),
           "levels": ((np.zeros((2, 2), dtype=np.int32),
                       np.ones((2,), dtype=bool)),),
           "matmul": None, "dfa": None}
    new = {k: (v if not isinstance(v, np.ndarray) else v.copy())
           for k, v in old.items()}
    new["levels"] = ((old["levels"][0][0].copy(),
                      old["levels"][0][1].copy()),)
    new["a"][3] += 100                         # one row differs → rows
    new["c"] = np.zeros((5,), dtype=np.int32)  # shape change → full
    return old, new


def test_plan_delta_modes_equal_reference():
    old, new = plan_inputs()
    plan, rplan = plan_delta(old, new), r_plan_delta(old, new)
    assert plan.to_json() == rplan.to_json()
    modes = {e.name: e.mode for e in plan.entries}
    assert modes == {e.name: e.mode for e in rplan.entries}
    assert modes["a"] == "rows" and modes["b"] == "reuse"
    assert modes["c"] == "full" and modes["levels.0.0"] == "reuse"
    assert list(plan.entries[0].rows) == list(rplan.entries[0].rows) == [3]
    assert plan.upload_bytes < plan.full_bytes
    # a lane appearing breaks the structure: no plan, a full re-stage
    new2 = dict(new, dfa=np.ones((2, 2)))
    assert plan_delta(old, new2) is None and r_plan_delta(old, new2) is None
    # python ints (the program's scalars) diff as 0-d arrays
    assert flatten_view({"k": {"S": 3}})["k.S"].shape == ()
    assert plan_delta({"S": 3}, {"S": 4}).to_json() == \
        r_plan_delta({"S": 3}, {"S": 4}).to_json()


def test_apply_delta_reconstructs_exact_arrays():
    import jax

    old = {"a": np.arange(64, dtype=np.int32).reshape(8, 8),
           "b": np.ones((4, 4), dtype=np.int32), "matmul": None}
    new = {"a": old["a"].copy(), "b": old["b"].copy(), "matmul": None}
    new["a"][5] = -7
    prev = {k: (torch.from_numpy(v.copy()) if v is not None else None)
            for k, v in old.items()}
    plan = plan_delta(old, new)
    params, uploaded = apply_delta(prev, new, plan, device="cpu")
    rprev = jax.tree.map(jax.device_put, old)
    rparams, ruploaded = r_apply_delta(rprev, new, r_plan_delta(old, new))
    np.testing.assert_array_equal(params["a"].numpy(), new["a"])
    np.testing.assert_array_equal(params["a"].numpy(),
                                  np.asarray(rparams["a"]))
    assert uploaded == ruploaded == plan.upload_bytes
    assert 0 < uploaded < new["a"].nbytes
    assert params["b"] is prev["b"]                # the same tensor object
    np.testing.assert_array_equal(prev["a"].numpy(), old["a"])
    assert params["matmul"] is None
    # no plan: a full upload, every byte counted
    full, n = apply_delta(prev, new, None, device="cpu")
    assert n == view_bytes(new) and full["b"] is not prev["b"]


@pytest.mark.parametrize("change", CHANGES)
def test_delta_on_the_program_equals_params_from_numpy(change):
    """Over the whole tree the kernel reads (the per-config program
    included): the delta-built params equal ``params_from_numpy`` of the
    new view, leaf for leaf with ints kept ints; nothing of the previous
    tree is written, and the wrapper's cached words do not carry over.
    The fields the reference's host view shares rebuild as its
    ``apply_delta`` rebuilds them."""
    import jax

    cache, rcache = CompileCache(), RefCompileCache()
    p0, _ = cache.compile(make_corpus(PORT), members_k=K)
    p1, _ = cache.compile(make_corpus(PORT, mutated={7}, change=change),
                          members_k=K)
    r0, _ = rcache.compile(make_corpus(REF), members_k=K)
    r1, _ = rcache.compile(make_corpus(REF, mutated={7}, change=change),
                           members_k=K)
    v0, v1 = host_view(host_operands(p0)), host_view(host_operands(p1))
    prev = params_from_numpy(host_operands(p0), device="cpu")
    prev["kernel"]["launch_words"] = ("stale", None, {})
    before = frozen(prev)
    plan = plan_delta(v0, v1)
    assert plan is not None and plan.mode == "delta"
    params, uploaded = apply_delta(prev, v1, plan, device="cpu")
    assert uploaded == plan.upload_bytes
    cold = params_from_numpy(host_operands(p1), device="cpu")
    assert_same(to_numpy_tree(cold), to_numpy_tree(params))
    for k, v in tensors_of(cold).items():
        got = tensors_of(params)[k]
        assert type(got) is type(v), k
    assert "launch_words" not in params["kernel"]
    assert params["kernel"] is not prev["kernel"]
    assert_untouched(prev, before)
    for e in plan.entries:
        if e.mode == "reuse" and e.name in tensors_of(prev) \
                and isinstance(tensors_of(prev)[e.name], torch.Tensor):
            assert tensors_of(params)[e.name] is tensors_of(prev)[e.name]
    # the shared fields: the reference's delta on its own views
    rv0 = r_to_device(r0, host=True, lane="fused")
    rv1 = r_to_device(r1, host=True, lane="fused")
    rparams, _ = r_apply_delta(jax.tree.map(jax.device_put, rv0), rv1,
                               r_plan_delta(rv0, rv1))
    mine = to_numpy_tree({k: v for k, v in params.items() if k != "kernel"})
    assert_same(jax.tree.map(np.asarray, rparams), mine)


@pytest.mark.parametrize("change", CHANGES)
def test_delta_built_params_decide_as_a_cold_upload(change):
    """The plain version of the kernel on delta-built params: the [B, W]
    readback is byte-equal to the one on a cold upload of the same corpus
    and to the host oracle's verdicts."""
    engine = port_engine(make_corpus(PORT), verdict_cache_size=0,
                         batch_dedup=False)
    new = make_corpus(PORT, mutated={7}, change=change)
    engine.apply_snapshot(port_entries(new))
    snap = engine._snapshot
    cold = to_device(PORT.compile_corpus(new, members_k=K,
                                         interner=engine.compile_cache.interner),
                     device="cpu")
    docs = [doc(i) for i in range(20)] + [
        {"request": {"method": "DELETE", "url_path": "/api-7/x"},
         "auth": {"identity": {"org": "org-7-MUT", "roles": ["role-7"]}}}]
    rows = [snap.policy.config_ids[f"cfg-{i % 20}"] for i in range(20)] + [
        snap.policy.config_ids["cfg-7"]]
    db = pack_batch(snap.policy, encode_batch(snap.policy, docs, rows))
    got = p_fk.eval_fused_kernel(snap.params, db)
    want = p_fk.eval_fused_kernel(cold, db)
    assert torch.equal(got, want)
    from authorino_tpu_torch.ops.operands import unpack_verdicts

    bits = unpack_verdicts(got.numpy(), 1)[:, 0]
    for b, d, r in zip(bits, docs, rows):
        assert bool(b) == host_results(snap.policy, d, r)[0]


# ---- churn end to end ----------------------------------------------------------


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_churn_verdicts_bit_identical_to_cold_compile(seed):
    n, mut = 12, seed % 12
    change = CHANGES[seed - 1]
    engine = port_engine(make_corpus(PORT, n))
    run(submit_all(engine, n))  # warm (and fill the caches)
    engine.apply_snapshot(port_entries(make_corpus(PORT, n, mutated={mut},
                                                   change=change)))
    got = run(submit_all(engine, n))
    cold = port_engine(make_corpus(PORT, n, mutated={mut}, change=change),
                       verdict_cache_size=0, batch_dedup=False)
    both_verdicts(got, run(submit_all(cold, n)))
    ref = ref_engine(make_corpus(REF, n))
    run(submit_all(ref, n))
    ref.apply_snapshot(ref_entries(make_corpus(REF, n, mutated={mut},
                                               change=change)))
    both_verdicts(got, run(submit_all(ref, n)))


def test_verdict_cache_survival_at_least_95pct():
    """Change 1 of 40 configs: at least 95% of the warmed verdict-cache
    entries still serve after the swap (as many as the reference's), and
    the changed config answers its new rule."""
    n = 40
    survived = []
    port = port_engine(make_corpus(PORT, n))
    for engine, entries, ns in ((port, port_entries, PORT),
                                (ref_engine(make_corpus(REF, n)),
                                 ref_entries, REF)):
        run(submit_all(engine, n))
        vc = engine._verdict_cache
        assert vc.adds >= n
        engine.apply_snapshot(entries(make_corpus(ns, n, mutated={11})))
        hits0 = vc.hits
        run(submit_all(engine, n))
        survived.append(vc.hits - hits0)
    assert survived[0] == survived[1] >= int(n * 0.95)
    out = run(port.submit(doc(11), "cfg-11"))
    cold = port_engine(make_corpus(PORT, n, mutated={11}),
                       verdict_cache_size=0, batch_dedup=False)
    want = run(cold.submit(doc(11), "cfg-11"))
    np.testing.assert_array_equal(out[0], want[0])


def test_changed_config_never_serves_stale_verdict():
    d = {"auth": {"identity": {"org": "acme"}}}
    for engine, ns, entries in ((port_engine(), PORT, port_entries),
                                (ref_engine(), REF, ref_entries)):
        acme = ns.Pattern("auth.identity.org", ns.Operator.EQ, "acme")
        evil = ns.Pattern("auth.identity.org", ns.Operator.EQ, "evil")
        engine.apply_snapshot(entries(
            [ns.ConfigRules(name="c", evaluators=[(None, acme)])]))
        assert bool(run(engine.submit(d, "c"))[0][0])
        engine.apply_snapshot(entries(
            [ns.ConfigRules(name="c", evaluators=[(None, evil)])]))
        assert not bool(run(engine.submit(d, "c"))[0][0])


def test_inflight_swap_inserts_under_pinned_tokens():
    """A batch in flight across a swap resolves and inserts under its
    pinned snapshot's tokens: for an unchanged config those equal the new
    snapshot's (the late insert serves), for a changed one they differ
    (the insert is unreachable from the new snapshot)."""
    n = 4
    engine = port_engine(make_corpus(PORT, n))
    run(submit_all(engine, n))
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
    pinned = engine._snapshot

    async def body():
        d1 = {"request": {"method": "POST", "url_path": "/svc-1/z"},
              "auth": {"identity": {"org": "zzz", "roles": ["role-1"]}}}
        d2 = {"request": {"method": "GET", "url_path": "/nope/z"},
              "auth": {"identity": {"org": "org-2", "roles": []}}}
        pre = [asyncio.ensure_future(engine.submit(d1, "cfg-1")),
               asyncio.ensure_future(engine.submit(d2, "cfg-2"))]
        deadline = time.monotonic() + 30
        while not gated_launches and time.monotonic() < deadline:
            await asyncio.sleep(0.005)
        assert gated_launches
        engine._encode_and_launch = real
        engine.apply_snapshot(port_entries(make_corpus(PORT, n,
                                                       mutated={2})))
        new = engine._snapshot
        row1 = pinned.policy.config_ids["cfg-1"]
        row2 = pinned.policy.config_ids["cfg-2"]
        assert new.cache_tokens[row1] == pinned.cache_tokens[row1]
        assert new.cache_tokens[row2] != pinned.cache_tokens[row2]
        adds0 = engine._verdict_cache.adds
        gate.set()
        outs = await asyncio.wait_for(asyncio.gather(*pre), timeout=30)
        assert engine._verdict_cache.adds > adds0
        assert bool(outs[1][0][0])          # cfg-2 before the change
        out2 = await engine.submit(d2, "cfg-2")
        assert not bool(out2[0][0])          # org-2 no longer matches
        hits1 = engine._verdict_cache.hits
        out1 = await engine.submit(d1, "cfg-1")
        assert engine._verdict_cache.hits > hits1
        np.testing.assert_array_equal(out1[0], outs[0][0])

    run(body())


# ---- the snapshot container -------------------------------------------------


def corpora_pair(kind):
    if kind == "churn":
        return make_corpus(PORT, 8), make_corpus(REF, 8), K, None
    # numeric and relation lanes: the container's version 2
    return (all_lanes_corpus(7, PORT), all_lanes_corpus(7, REF), 4, True)


# the arrays the container carries (the reference test's list)
SERIALIZED_ARRAYS = (
    "leaf_op", "leaf_attr", "leaf_const", "eval_cond", "eval_rule",
    "eval_has_cond", "dfa_tables", "dfa_accept", "dfa_table_of_row",
    "leaf_dfa_row", "attr_byte_slot", "leaf_is_membership",
    "member_attr_slot", "member_attrs", "cpu_leaf_list", "config_cacheable")


def meta_of(cfgs, generation=1):
    return {"generation": generation, "certified": True,
            "fingerprints": {c.name: rules_fingerprint(c) for c in cfgs},
            "entries": [{"id": c.name, "hosts": [c.name]} for c in cfgs]}


@pytest.mark.parametrize("kind", ["churn", "all_lanes"])
def test_serialized_blob_equals_reference_both_ways(kind):
    pc, rc, k, assist = corpora_pair(kind)
    pp = PORT.compile_corpus(pc, members_k=k, ovf_assist=assist)
    rp = REF.compile_corpus(rc, members_k=k, ovf_assist=assist)
    blob = serialize_policy(pp, meta=meta_of(pc))
    rblob = r_serialize(rp, meta=meta_of(pc))
    assert blob == rblob
    # each package reads the other's blob into the same policy
    from_ref, meta = deserialize_policy(rblob)
    from_port, rmeta = r_deserialize(blob)
    assert meta == rmeta == meta_of(pc)
    assert serialize_policy(from_ref, meta=meta) == rblob
    assert r_serialize(from_port, meta=meta) == blob
    for name in SERIALIZED_ARRAYS:
        assert_same(getattr(pp, name), getattr(from_ref, name), name)
    assert_same(pp.levels, from_ref.levels, "levels")
    assert from_ref.config_ids == pp.config_ids
    assert from_ref.attr_selectors == pp.attr_selectors
    assert from_ref.interner._table == pp.interner._table
    assert [str(r) for r in from_ref.rule_sources()] == \
        [str(r) for r in pp.rule_sources()]
    # the port's upload of the loaded policy is its own compile's
    assert_same(to_numpy_tree(to_device(pp, device="cpu")),
                to_numpy_tree(to_device(from_ref, device="cpu")))
    docs = all_lanes_docs(7, 24) if assist else [doc(i) for i in range(8)]
    for i, d in enumerate(docs):
        row = i % pp.n_configs
        for a, b in zip(host_results(pp, d, row), host_results(from_ref, d, row)):
            np.testing.assert_array_equal(a, b)


def test_deserialized_reference_blob_serves_on_the_port():
    """A reference snapshot's state carried across: the port deserializes
    the JAX package's blob, uploads it and serves; the readback equals the
    one of the port's own compile of the same corpus."""
    rp = REF.compile_corpus(make_corpus(REF), members_k=K)
    pp = PORT.compile_corpus(make_corpus(PORT), members_k=K)
    loaded, _ = deserialize_policy(r_serialize(rp))
    docs = [doc(i) for i in range(20)]
    rows = list(range(20))
    db = pack_batch(loaded, encode_batch(loaded, docs, rows))
    got = p_fk.eval_fused_kernel(to_device(loaded, device="cpu"), db)
    want = p_fk.eval_fused_kernel(to_device(pp, device="cpu"),
                                  pack_batch(pp, encode_batch(pp, docs, rows)))
    assert torch.equal(got, want)


def test_serialize_rejects_corruption_and_truncation():
    blob = serialize_policy(PORT.compile_corpus(make_corpus(PORT, 4),
                                                members_k=K))
    flipped = bytearray(blob)
    flipped[len(flipped) // 2] ^= 0xFF
    bad = {"flipped": bytes(flipped), "truncated": blob[:200],
           "garbage": b"not a snapshot at all",
           "short": blob[:16]}
    for name, b in bad.items():
        with pytest.raises(SnapshotFormatError) as mine:
            deserialize_policy(b)
        with pytest.raises(RefFormatError) as theirs:
            r_deserialize(b)
        assert str(mine.value) == str(theirs.value), name


# ---- the config-level diff and its report ------------------------------------


def test_snapshot_diff_names_exactly_the_changes():
    old = {c.name: rules_fingerprint(c) for c in make_corpus(PORT, 6)}
    new_cfgs = make_corpus(PORT, 6, mutated={2})[:5]
    new = {c.name: rules_fingerprint(c) for c in new_cfgs}
    new["cfg-9"] = "f" * 64
    d = snapshot_diff(old, new)
    assert d == r_snapshot_diff(old, new)
    assert d["changed"] == ["cfg-2"] and d["removed"] == ["cfg-5"]
    assert d["added"] == ["cfg-9"] and d["unchanged"] == 4
    assert d["recompile"] == ["cfg-2", "cfg-9"]


def test_format_snapshot_diff_equals_reference():
    cache, rcache = CompileCache(), RefCompileCache()
    p0, rep0 = cache.compile(make_corpus(PORT, 6), members_k=K)
    p1, rep1 = cache.compile(make_corpus(PORT, 6, mutated={3}), members_k=K)
    r0, _ = rcache.compile(make_corpus(REF, 6), members_k=K)
    r1, _ = rcache.compile(make_corpus(REF, 6, mutated={3}), members_k=K)
    m0 = {"generation": 1, "fingerprints": dict(rep0.fingerprints)}
    m1 = {"generation": 2, "fingerprints": dict(rep1.fingerprints)}
    # the views the two packages share
    text = format_snapshot_diff(m0, m1, host_operands(p0), host_operands(p1))
    want = r_format_diff(m0, m1, r_to_device(r0, host=True, lane="fused"),
                         r_to_device(r1, host=True, lane="fused"))
    assert text == want
    assert "changed: cfg-3" in text and "recompile set: 1 config(s)" in text
    assert format_snapshot_diff(m0, m1) == r_format_diff(m0, m1)
    # the port's whole view adds the program's rows
    full = format_snapshot_diff(m0, m1, host_view(host_operands(p0)),
                                host_view(host_operands(p1)))
    assert "kernel.leaf_rec: rows (1 row(s)" in full


# ---- telemetry ------------------------------------------------------------------


def test_debug_vars_control_plane_block():
    port, ref = port_engine(make_corpus(PORT, 5)), ref_engine(make_corpus(REF, 5))
    port.apply_snapshot(port_entries(make_corpus(PORT, 5)))
    ref.apply_snapshot(ref_entries(make_corpus(REF, 5)))
    cp, rcp = port.debug_vars()["control_plane"], \
        ref.debug_vars()["control_plane"]
    for key in ("compile", "upload", "per_config_cache_keying"):
        assert cp[key] == rcp[key], key
    assert set(cp) >= {"generation", "phases_ms", "compile", "upload",
                       "compile_cache", "per_config_cache_keying"}
    assert set(cp["phases_ms"]) == set(rcp["phases_ms"]) == {"compile"}
    assert cp["compile"]["compiled"] == 0
    assert cp["upload"]["mode"] == "reuse"
    assert cp["per_config_cache_keying"] is True
    assert cp["compile_cache"]["hit_ratio"] == \
        rcp["compile_cache"]["hit_ratio"] == 0.5
    # one change: the diff and upload phases and the delta's bytes
    port.apply_snapshot(port_entries(make_corpus(PORT, 5, mutated={1})))
    cp = port.debug_vars()["control_plane"]
    assert set(cp["phases_ms"]) == {"compile", "diff", "upload"}
    assert cp["upload"]["mode"] == "delta"
    assert cp["compile"]["compiled_names"] == ["cfg-1"]


def test_reconcile_counters_follow_the_reports():
    from authorino_tpu_torch.utils import metrics as m

    if not m._PROM:
        pytest.skip("prometheus_client is not installed")
    from prometheus_client import REGISTRY

    def sample(name, labels):
        return REGISTRY.get_sample_value(name, labels) or 0.0

    names = (("auth_server_compile_cache_events_total", {"outcome": "hit"}),
             ("auth_server_compile_cache_events_total", {"outcome": "miss"}),
             ("auth_server_delta_upload_bytes_total", {"lane": "engine"}),
             ("auth_server_full_upload_bytes_total", {"lane": "engine"}))
    s0 = [sample(*x) for x in names]
    engine = port_engine(make_corpus(PORT, 6))
    first = engine._snapshot.upload
    engine.apply_snapshot(port_entries(make_corpus(PORT, 6, mutated={2})))
    second = engine._snapshot.upload
    got = [sample(*x) - s for x, s in zip(names, s0)]
    assert got == [5, 7, first["upload_bytes"] + second["upload_bytes"],
                   first["full_bytes"] + second["full_bytes"]]
