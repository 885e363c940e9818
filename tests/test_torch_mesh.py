"""The port's mesh lane against the JAX package's.

Twins of ``tests/test_mesh.py`` and ``tests/test_sharded_eval.py``.  The
reference runs on the 8 virtual CPU devices ``tests/conftest.py`` forces;
the port on a mesh of logical slots over repeated ``cpu`` devices
(``build_mesh([torch.device("cpu")] * n, dp=...)``), the same ``[dp, mp]``
shapes.  Each twin runs the same seeded corpus and requests through both
packages and holds the outputs equal, tolerance 0 (verdict, rule and
skipped bits, attribution columns, cache tokens and hits, per-shard upload
bytes, failover and degrade counts), and each package to the expression
oracle."""

from __future__ import annotations

import asyncio
import random
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import authorino_tpu.compiler as r_compiler
import authorino_tpu.expressions as r_expr
import authorino_tpu_torch.compiler as p_compiler
import authorino_tpu_torch.expressions as p_expr
from authorino_tpu.analysis import tensor_lint as r_lint_mod
from authorino_tpu.models import PolicyModel as RModel
from authorino_tpu.models.policy_model import host_results as r_host_results
from authorino_tpu.ops import pattern_eval as r_pe
from authorino_tpu.parallel import ShardedPolicyModel as RSharded
from authorino_tpu.parallel import build_mesh as r_build_mesh
from authorino_tpu.parallel import sharded_eval as r_se
from authorino_tpu.runtime import EngineEntry as REntry
from authorino_tpu.runtime import PolicyEngine as REngine
from authorino_tpu.runtime import faults as r_faults
from authorino_tpu.runtime.engine import SnapshotRejected as RRejected
from authorino_tpu_torch.analysis import tensor_lint as p_lint_mod
from authorino_tpu_torch.models import PolicyModel as PModel
from authorino_tpu_torch.models.policy_model import \
    host_results as p_host_results
from authorino_tpu_torch.ops import pattern_eval as p_pe
from authorino_tpu_torch.parallel import ShardedPolicyModel as PSharded
from authorino_tpu_torch.parallel import build_mesh as p_build_mesh
from authorino_tpu_torch.parallel import sharded_eval as p_se
from authorino_tpu_torch.runtime import EngineEntry as PEntry
from authorino_tpu_torch.runtime import PolicyEngine as PEngine
from authorino_tpu_torch.runtime import faults as p_faults
from authorino_tpu_torch.runtime.engine import SnapshotRejected as PRejected

from test_compiler_differential import oracle_verdict, random_doc, random_expr

CPU = torch.device("cpu")

# dp × mp shapes of the acceptance sweep
SHAPES = [(1, 1), (2, 1), (2, 2), (4, 2)]


def _ref_mesh(n, dp):
    return r_build_mesh(n_devices=n, dp=dp)


def _port_mesh(n, dp):
    return p_build_mesh([CPU] * n, dp=dp)


def _ref_engine(**kw):
    kw.setdefault("lane_select", False)
    return REngine(**kw)


def _port_engine(**kw):
    kw.setdefault("lane_select", False)
    return PEngine(device="cpu", **kw)


REF = SimpleNamespace(
    name="ref", Pattern=r_expr.Pattern, All=r_expr.All, Any_=r_expr.Any_,
    Operator=r_expr.Operator, ConfigRules=r_compiler.ConfigRules,
    Sharded=RSharded, mesh=_ref_mesh, se=r_se, Entry=REntry,
    make=_ref_engine, faults=r_faults, host_results=r_host_results,
    pe=r_pe, Model=RModel, lint_mod=r_lint_mod, Rejected=RRejected)
PORT = SimpleNamespace(
    name="port", Pattern=p_expr.Pattern, All=p_expr.All, Any_=p_expr.Any_,
    Operator=p_expr.Operator, ConfigRules=p_compiler.ConfigRules,
    Sharded=PSharded, mesh=_port_mesh, se=p_se, Entry=PEntry,
    make=_port_engine, faults=p_faults, host_results=p_host_results,
    pe=p_pe, Model=PModel, lint_mod=p_lint_mod, Rejected=PRejected)


def both(scenario, *args):
    """``scenario(pkg, *args)`` on both packages: equal observations."""
    ref = scenario(REF, *args)
    port = scenario(PORT, *args)
    assert port == ref, (port, ref)
    return port


def counter_value(name: str, labels=None) -> float:
    from prometheus_client import REGISTRY

    v = REGISTRY.get_sample_value(name, labels or {})
    return v if v is not None else 0.0


@pytest.fixture(autouse=True)
def _fresh_mesh_state():
    """Per-device breakers and occupancy are process-wide per mesh in both
    packages: isolate every test."""
    r_se._reset_mesh_state_for_tests()
    p_se._reset_mesh_state_for_tests()
    yield
    r_faults.FAULTS.disarm()
    p_faults.FAULTS.disarm()
    r_se._reset_mesh_state_for_tests()
    p_se._reset_mesh_state_for_tests()


def to_port(e):
    """A reference expression tree rebuilt with the port's classes."""
    if isinstance(e, r_expr.Pattern):
        return p_expr.Pattern(e.selector, p_expr.Operator(e.operator.value),
                              e.value)
    kids = [to_port(c) for c in e.children]
    return (p_expr.All(*kids) if isinstance(e, r_expr.And)
            else p_expr.Any_(*kids))


def config_for(pkg, c):
    """A reference ConfigRules as ``pkg``'s."""
    if pkg is REF:
        return c
    return p_compiler.ConfigRules(name=c.name, evaluators=[
        (to_port(cond) if cond is not None else None, to_port(rule))
        for cond, rule in c.evaluators])


def random_corpus(rng, n_configs):
    """The reference's random corpus (reference classes)."""
    configs = []
    for i in range(n_configs):
        evaluators = []
        for _ in range(rng.randint(1, 3)):
            cond = random_expr(rng) if rng.random() < 0.3 else None
            evaluators.append((cond, random_expr(rng)))
        configs.append(r_compiler.ConfigRules(name=f"cfg-{i}",
                                              evaluators=evaluators))
    return configs


def lane_corpus(pkg):
    """Every lane: device-DFA regex rows (byte overflow included),
    compiled conditions, membership rows (overflow-capable), and a
    CPU-regex leaf (outside the DFA subset)."""
    P, Op = pkg.Pattern, pkg.Operator
    rx = P("request.url_path", Op.MATCHES, r"^/api/v[0-9]+/ok")
    cond = P("request.method", Op.EQ, "GET")
    gated = P("request.path", Op.EQ, "/gated")
    mem = pkg.All(P("auth.identity.roles", Op.INCL, "admin"),
                  P("auth.identity.groups", Op.EXCL, "banned"))
    cpu_rx = P("request.query", Op.MATCHES, r"^(a+)\1$")
    mix = pkg.Any_(rx, P("auth.identity.roles", Op.INCL, "root"))
    CR = pkg.ConfigRules
    return {
        "cfg-rx": CR(name="cfg-rx", evaluators=[(None, rx), (cond, gated)]),
        "cfg-mem": CR(name="cfg-mem", evaluators=[(None, mem)]),
        "cfg-mix": CR(name="cfg-mix", evaluators=[(cond, mix)]),
        "cfg-cpu": CR(name="cfg-cpu", evaluators=[(None, cpu_rx)]),
    }


def lane_docs():
    long_ok = "/api/v3/ok" + "x" * 120      # > DFA_VALUE_BYTES: byte overflow
    many = [f"r{k}" for k in range(70)]     # > any relieved K: host fallback
    return [
        ({"request": {"url_path": "/api/v1/ok", "method": "GET",
                      "path": "/gated"}, "auth": {"identity": {}}}, "cfg-rx"),
        ({"request": {"url_path": "/api/x", "method": "POST",
                      "path": "/other"}, "auth": {"identity": {}}}, "cfg-rx"),
        ({"request": {"url_path": long_ok, "method": "GET",
                      "path": "/other"}, "auth": {"identity": {}}}, "cfg-rx"),
        ({"request": {}, "auth": {"identity": {
            "roles": many + ["admin"], "groups": []}}}, "cfg-mem"),
        ({"request": {}, "auth": {"identity": {
            "roles": many, "groups": ["banned"]}}}, "cfg-mem"),
        ({"request": {}, "auth": {"identity": {
            "roles": ["admin"], "groups": []}}}, "cfg-mem"),
        ({"request": {"url_path": "/api/v9/ok", "method": "GET"},
          "auth": {"identity": {"roles": many}}}, "cfg-mix"),
        ({"request": {"url_path": "/zzz", "method": "POST"},
          "auth": {"identity": {"roles": many + ["root"]}}}, "cfg-mix"),
        ({"request": {"query": "aaaa"}, "auth": {}}, "cfg-cpu"),
        ({"request": {"query": "aaa"}, "auth": {}}, "cfg-cpu"),
    ]


def oracle_bits(pkg, model, doc, name):
    shard, row = model.locator[name]
    _, rule, skipped = pkg.host_results(model.shards[shard], doc, int(row))
    return rule, skipped


def run_loop(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def submit_all(engine, docs, names):
    async def go():
        return await asyncio.gather(
            *(engine.submit(d, n) for d, n in zip(docs, names)))
    return [(np.asarray(r).tolist(), np.asarray(s).tolist())
            for r, s in run_loop(go())]


# ---------------------------------------------------------------------------
# the sharded model (tests/test_sharded_eval.py)
# ---------------------------------------------------------------------------


def test_eight_logical_slots_present():
    """The reference side of every twin is truly sharded (8 virtual JAX
    devices); the port's 8-slot mesh takes the same default layout."""
    assert len(jax.devices()) >= 8
    mesh = p_build_mesh([CPU] * 8)
    ref = r_build_mesh(n_devices=8)
    assert mesh.shape == {"dp": 2, "mp": 4}
    assert dict(ref.shape) == {"dp": 2, "mp": 4}
    assert mesh.device_ids == list(range(8))
    assert mesh == p_build_mesh([CPU] * 8) and mesh != p_build_mesh([CPU] * 8,
                                                                    dp=4)


@pytest.mark.parametrize("seed,dp", [(11, 2), (12, 4), (13, 1)])
def test_sharded_matches_oracle(seed, dp):
    rng = random.Random(seed)
    configs = random_corpus(rng, n_configs=13)  # uneven over the shards
    docs = [random_doc(rng) for _ in range(32)]
    names = [f"cfg-{rng.randrange(len(configs))}" for _ in docs]
    expected = [oracle_verdict(configs[int(n.split('-')[1])], d)
                for d, n in zip(docs, names)]

    def scenario(pkg):
        cfgs = [config_for(pkg, c) for c in configs]
        sharded = pkg.Sharded(cfgs, pkg.mesh(8, dp), members_k=8)
        single = pkg.Model.from_configs(cfgs, members_k=8) if pkg is REF \
            else pkg.Model.from_configs(cfgs, members_k=8, device="cpu")
        got = sharded.decide(docs, names)
        assert got == expected
        assert single.decide(docs, names) == expected
        return got

    both(scenario)


def test_sharded_params_actually_sharded():
    rng = random.Random(7)
    configs = random_corpus(rng, 8)
    r = RSharded(configs, r_build_mesh(n_devices=8, dp=2))
    p = PSharded([config_for(PORT, c) for c in configs],
                 p_build_mesh([CPU] * 8, dp=2))
    # the leaf tables carry a leading [S = 4] axis
    assert r.params["leaf_op"].shape[0] == 4
    assert p.host_view["leaf_op"].shape[0] == 4
    # each shard's slice is staged on the devices of its mesh column
    assert len(p.params) == 4
    for j in range(4):
        assert set(p.params[j]) == {"cpu"}
        np.testing.assert_array_equal(
            p.params[j]["cpu"]["leaf_op"].numpy(), p.host_view["leaf_op"][j])
    np.testing.assert_array_equal(np.asarray(r.params["leaf_op"]),
                                  p.host_view["leaf_op"])
    assert {str(d) for row in p.mesh.grid for d in row} == {"cpu"}


def test_sharded_matmul_lane_active():
    """The stacked host operands carry the matmul lane's matrices (one per
    shard on the leading [S] axis): the mesh does not fall back to the
    gather formulation."""
    rng = random.Random(31)
    configs = random_corpus(rng, 9)
    docs = [random_doc(rng) for _ in range(16)]
    names = [f"cfg-{rng.randrange(9)}" for _ in docs]
    expected = [oracle_verdict(configs[int(n.split('-')[1])], d)
                for d, n in zip(docs, names)]

    def scenario(pkg):
        m = pkg.Sharded([config_for(pkg, c) for c in configs], pkg.mesh(8, 2),
                        members_k=8)
        assert m.has_matmul
        tree = m.params if pkg is REF else m.host_view
        assert tree["matmul"]["attr_onehot"].shape[0] == 4  # [S, A, L]
        got = m.decide(docs, names)
        assert got == expected
        return got, tuple(tree["matmul"]["attr_onehot"].shape)

    both(scenario)


def test_sharded_dfa_lane_rides_the_mesh():
    """Regexes in a few configs only: the ShapeTargets union forces a
    uniform DFA lane and the device verdicts match the oracle."""
    def scenario(pkg):
        P, Op = pkg.Pattern, pkg.Operator
        configs = []
        for i in range(9):
            pats = [P("request.method", Op.EQ, "GET")]
            if i % 3 == 0:
                pats.append(P("request.url_path", Op.MATCHES,
                              rf"^/svc-{i}/\d+$"))
            configs.append(pkg.ConfigRules(
                name=f"cfg-{i}", evaluators=[(None, pkg.All(*pats))]))
        m = pkg.Sharded(configs, pkg.mesh(8, 2), members_k=4)
        tree = m.params if pkg is REF else m.host_view
        assert m.has_dfa and tree["dfa_tables"] is not None
        docs, names, expected = [], [], []
        for i in range(9):
            for path, ok in [(f"/svc-{i}/42", True), (f"/svc-{i}/x", False)]:
                docs.append({"request": {"method": "GET", "url_path": path}})
                names.append(f"cfg-{i}")
                expected.append(ok if i % 3 == 0 else True)
        got = m.decide(docs, names)
        assert got == expected
        return got

    both(scenario)


def test_sharded_full_outputs_match_single_corpus():
    """``apply_full`` gives the own (verdict, rule, skipped) the
    single-corpus ``eval_full`` gives: the contract the engine serves."""
    rng = random.Random(21)
    configs = random_corpus(rng, 11)
    docs = [random_doc(rng) for _ in range(24)]
    names = [f"cfg-{rng.randrange(len(configs))}" for _ in docs]

    def scenario(pkg):
        cfgs = [config_for(pkg, c) for c in configs]
        sharded = pkg.Sharded(cfgs, pkg.mesh(8, 2), members_k=8)
        enc = sharded.encode(docs, names)
        own_s, rule_s, skip_s = sharded.apply_full(enc)
        if pkg is REF:
            import jax.numpy as jnp

            single = pkg.Model.from_configs(cfgs, members_k=8)
            rows = [single.policy.config_ids[n] for n in names]
            db = single.encode(docs, rows)
            has_dfa = single.params["dfa_tables"] is not None
            own_1, rule_1, skip_1 = (np.asarray(a) for a in r_pe.eval_full_jit(
                single.params, jnp.asarray(db.attrs_val),
                jnp.asarray(db.members_c), jnp.asarray(db.cpu_dense),
                jnp.asarray(db.config_id),
                jnp.asarray(db.attr_bytes) if has_dfa else None,
                jnp.asarray(db.byte_ovf) if has_dfa else None))
        else:
            single = pkg.Model.from_configs(cfgs, members_k=8, device="cpu")
            rows = [single.policy.config_ids[n] for n in names]
            db = single.encode(docs, rows)
            params = p_pe.to_device(single.policy, device="cpu",
                                    lane="gather")
            ops = p_pe._operands(params, db)
            own_1, rule_1, skip_1 = (a.numpy() for a in p_pe.eval_full(
                params, ops["attrs_val"], ops["members_c"],
                ops["cpu_dense"], ops["config_id"], ops.get("attr_bytes"),
                ops.get("byte_ovf")))
        B = len(docs)
        ok = ~enc.host_fallback[:B]
        E = min(rule_s.shape[1], rule_1.shape[1])
        assert (own_s[:B][ok] == own_1[:B][ok]).all()
        assert (rule_s[:B, :E][ok] == rule_1[:B, :E][ok]).all()
        assert (skip_s[:B, :E][ok] == skip_1[:B, :E][ok]).all()
        return (own_s[:B].tolist(), rule_s[:B].tolist(), skip_s[:B].tolist(),
                enc.host_fallback[:B].tolist())

    both(scenario)


def test_engine_serves_from_sharded_snapshot():
    """The engine compiles a mesh corpus (the reference's ``mesh="auto"``
    over its 8 virtual devices, the port's explicit 8-slot mesh), the
    non-default members_k plumbed through and relieved on the grid, and
    the batched submit path is oracle-exact."""
    def scenario(pkg):
        P, Op = pkg.Pattern, pkg.Operator
        mesh = "auto" if pkg is REF else pkg.mesh(8, 2)
        engine = pkg.make(max_batch=4, members_k=4, mesh=mesh)
        entries, exprs = [], {}
        for i in range(6):
            rule = pkg.All(
                P("request.method", Op.EQ, "GET"),
                pkg.Any_(P("auth.identity.roles", Op.INCL, f"r{i}"),
                         P("request.url_path", Op.MATCHES, rf"^/pub-{i}/")))
            exprs[f"ns/cfg-{i}"] = rule
            entries.append(pkg.Entry(
                id=f"ns/cfg-{i}", hosts=[f"svc-{i}.example.com"],
                runtime=None, rules=pkg.ConfigRules(
                    name=f"ns/cfg-{i}", evaluators=[(None, rule)])))
        engine.apply_snapshot(entries)
        sharded = engine._snapshot.sharded
        assert sharded is not None
        assert sharded.members_k == 4
        assert sharded.shards[0].members_k == sharded.members_k_eff
        assert sharded.members_k_eff == 4 * sharded.n_shards
        docs = [
            {"request": {"method": "GET", "url_path": "/pub-2/x"},
             "auth": {"identity": {"roles": ["nope"]}}},
            {"request": {"method": "GET", "url_path": "/priv"},
             "auth": {"identity": {"roles": ["r3", "other"]}}},
            {"request": {"method": "POST", "url_path": "/pub-4/x"},
             "auth": {"identity": {"roles": ["r4"]}}},
            {"request": {"method": "GET", "url_path": "/priv"},
             "auth": {"identity": {"roles": [f"x{k}" for k in range(9)]
                                   + ["r5"]}}},
        ]
        names = ["ns/cfg-2", "ns/cfg-3", "ns/cfg-4", "ns/cfg-5"]
        results = submit_all(engine, docs, names)
        got = [bool(rule[0]) for rule, _ in results]
        expected = [bool(exprs[n].matches(d)) for d, n in zip(docs, names)]
        assert got == expected == [True, True, False, True]
        return results, sharded.members_k_eff

    both(scenario)


class TestServingPathBitParity:
    """The mesh serving path and the single-corpus one give identical
    per-evaluator (rule, skipped) bits on a corpus that exercises the DFA
    rows (byte overflow included), membership overflow and compiled
    conditions, across dp = 1, 2, 4, in both packages."""

    K = 4

    def corpus(self, pkg):
        P, Op = pkg.Pattern, pkg.Operator
        rx = P("request.url_path", Op.MATCHES, r"^/api/v[0-9]+/ok")
        cond = P("request.method", Op.EQ, "GET")
        gated = P("request.path", Op.EQ, "/gated")
        mem = pkg.All(P("auth.identity.roles", Op.INCL, "admin"),
                      P("auth.identity.groups", Op.EXCL, "banned"))
        mix = pkg.Any_(rx, P("auth.identity.roles", Op.INCL, "root"))
        CR = pkg.ConfigRules
        return {
            "cfg-rx": CR(name="cfg-rx",
                         evaluators=[(None, rx), (cond, gated)]),
            "cfg-mem": CR(name="cfg-mem", evaluators=[(None, mem)]),
            "cfg-mix": CR(name="cfg-mix", evaluators=[(cond, mix)]),
        }

    def docs(self):
        long_ok = "/api/v3/ok" + "x" * 120
        long_no = "/nope/" + "y" * 120
        many = [f"r{k}" for k in range(9)]
        return [
            ({"request": {"url_path": "/api/v1/ok", "method": "GET",
                          "path": "/gated"}, "auth": {"identity": {}}},
             "cfg-rx"),
            ({"request": {"url_path": "/api/x", "method": "POST",
                          "path": "/other"}, "auth": {"identity": {}}},
             "cfg-rx"),
            ({"request": {"url_path": long_ok, "method": "GET",
                          "path": "/other"}, "auth": {"identity": {}}},
             "cfg-rx"),
            ({"request": {"url_path": long_no, "method": "POST",
                          "path": "/gated"}, "auth": {"identity": {}}},
             "cfg-rx"),
            ({"request": {}, "auth": {"identity": {
                "roles": many + ["admin"], "groups": []}}}, "cfg-mem"),
            ({"request": {}, "auth": {"identity": {
                "roles": many, "groups": ["banned"]}}}, "cfg-mem"),
            ({"request": {}, "auth": {"identity": {
                "roles": ["admin"], "groups": []}}}, "cfg-mem"),
            ({"request": {"url_path": "/api/v9/ok", "method": "GET"},
              "auth": {"identity": {"roles": many}}}, "cfg-mix"),
            ({"request": {"url_path": "/zzz", "method": "POST"},
              "auth": {"identity": {"roles": many + ["root"]}}}, "cfg-mix"),
        ]

    @pytest.mark.parametrize("dp", [1, 2, 4])
    def test_bit_parity(self, dp):
        def scenario(pkg):
            corpus = self.corpus(pkg)

            def engine_for(mesh):
                e = pkg.make(max_batch=16, members_k=self.K, mesh=mesh)
                e.apply_snapshot([pkg.Entry(id=n, hosts=[n], runtime=None,
                                            rules=c)
                                  for n, c in corpus.items()])
                return e

            single = engine_for(None)
            sharded = engine_for(pkg.mesh(8, dp))
            assert sharded._snapshot.sharded is not None
            assert single._snapshot.policy is not None
            docs = [d for d, _ in self.docs()]
            names = [n for _, n in self.docs()]
            got_sharded = submit_all(sharded, docs, names)
            got_single = submit_all(single, docs, names)
            assert got_sharded == got_single
            for (doc, name), (rule_bits, skip_bits) in zip(self.docs(),
                                                           got_single):
                for e, (cond, rule) in enumerate(corpus[name].evaluators):
                    want_skip = cond is not None and not cond.matches(doc)
                    assert skip_bits[e] == want_skip, (name, e)
                    if not want_skip:
                        assert rule_bits[e] == rule.matches(doc), (name, e)
            return got_sharded

        both(scenario)


# ---------------------------------------------------------------------------
# the mesh as a serving lane (tests/test_mesh.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dp,mp", SHAPES)
def test_bit_exact_parity_across_shapes(dp, mp):
    """``run_full``'s (rule, skipped) matrices, host fallback applied,
    equal across the packages and to the oracle, every shape."""
    def scenario(pkg):
        corpus = lane_corpus(pkg)
        model = pkg.Sharded(list(corpus.values()), pkg.mesh(dp * mp, dp),
                            members_k=4)
        docs = [d for d, _ in lane_docs()]
        names = [n for _, n in lane_docs()]
        rule, skipped = model.run_full(docs, names)
        for r, (doc, name) in enumerate(zip(docs, names)):
            want_rule, want_skip = oracle_bits(pkg, model, doc, name)
            E = len(want_rule)
            assert (skipped[r, :E] == want_skip).all(), (dp, mp, r, name)
            live = ~want_skip
            assert (rule[r, :E][live] == want_rule[live]).all(), (r, name)
            evs = corpus[name].evaluators
            want = all((cond is not None and not cond.matches(doc))
                       or rule_e.matches(doc) for cond, rule_e in evs)
            got = all(skipped[r, e] or rule[r, e] for e in range(len(evs)))
            assert got == want, (dp, mp, r, name)
        return rule[:len(docs)].tolist(), skipped[:len(docs)].tolist()

    both(scenario)


@pytest.mark.parametrize("seed", [101, 202, 303])
def test_attribution_parity_property(seed):
    """firing_columns / unpack_attribution over the shard-stacked bitpacked
    readback match the oracle, and the degrade lane (host_decide_many)
    attributes as the device lane it replaces."""
    rng = random.Random(seed)
    configs = random_corpus(rng, 11)
    docs = [random_doc(rng) for _ in range(48)]
    names = [f"cfg-{rng.randrange(len(configs))}" for _ in docs]

    def scenario(pkg):
        model = pkg.Sharded([config_for(pkg, c) for c in configs],
                            pkg.mesh(8, 2), members_k=8)
        enc = model.encode(docs, names)
        packed = np.asarray(model.dispatch_full(enc))
        E = int(model.shards[0].eval_rule.shape[1])
        verdict, firing = pkg.pe.unpack_attribution(packed, E)
        degraded = model.host_decide_many(names, docs)
        for r, (doc, name) in enumerate(zip(docs, names)):
            want_rule, want_skip = oracle_bits(pkg, model, doc, name)
            want_fire = int(pkg.pe.firing_columns(want_rule[None, :],
                                                  want_skip[None, :])[0])
            d_rule, d_skip = degraded[r]
            assert int(pkg.pe.firing_columns(
                d_rule[None, :], d_skip[None, :])[0]) == want_fire
            if not enc.host_fallback[r]:
                assert int(firing[r]) == want_fire, (r, name)
                assert bool(verdict[r]) == oracle_verdict(
                    configs[int(name.split("-")[1])], doc), (r, name)
        return (np.asarray(verdict)[:len(docs)].tolist(),
                np.asarray(firing)[:len(docs)].tolist(),
                enc.host_fallback[:len(docs)].tolist())

    both(scenario)


def test_attribution_parity_through_dedup_fanout():
    """Duplicate rows collapse to unique device work; the fan-out hands
    every duplicate the same verdict and attribution (engine path)."""
    def scenario(pkg):
        corpus = lane_corpus(pkg)
        engine = pkg.make(max_batch=32, members_k=4, mesh=pkg.mesh(8, 2))
        engine.apply_snapshot([pkg.Entry(id=n, hosts=[n], runtime=None,
                                         rules=c) for n, c in corpus.items()])
        deny_doc = {"request": {"url_path": "/api/x", "method": "POST",
                                "path": "/other"}, "auth": {"identity": {}}}
        outs = submit_all(engine, [dict(deny_doc) for _ in range(6)],
                          ["cfg-rx"] * 6)
        assert len({(tuple(r), tuple(s)) for r, s in outs}) == 1
        rule, skipped = (np.asarray(a) for a in outs[0])
        want_rule, want_skip = oracle_bits(pkg, engine._snapshot.sharded,
                                           deny_doc, "cfg-rx")
        E = len(want_rule)
        assert (skipped[:E] == want_skip).all()
        live = ~want_skip
        assert (rule[:E][live] == want_rule[live]).all()
        heat = engine._snapshot.heat
        assert heat is not None and heat.fold_calls >= 1
        return outs, int(np.asarray(heat._counts).sum())

    both(scenario)


def config_i(pkg, i: int, suffix: str = ""):
    return pkg.ConfigRules(name=f"ns/c{i}", evaluators=[
        (None, pkg.Pattern("request.path", pkg.Operator.EQ, f"/p{i}{suffix}"))])


def entries_for(pkg, configs):
    return [pkg.Entry(id=c.name, hosts=[c.name], runtime=None, rules=c)
            for c in configs]


def test_mesh_cache_tokens_survive_one_of_n_mutation():
    N = 40

    def scenario(pkg):
        engine = pkg.make(max_batch=64, members_k=4, mesh=pkg.mesh(8, 2),
                          verdict_cache_size=4096)
        engine.apply_snapshot(entries_for(pkg, [config_i(pkg, i)
                                                for i in range(N)]))
        snap_old = engine._snapshot
        assert snap_old.mesh_tokens is not None
        docs = [{"request": {"path": f"/p{i}"}} for i in range(N)]
        names = [f"ns/c{i}" for i in range(N)]
        first = submit_all(engine, docs, names)
        vc = engine._verdict_cache
        assert vc.counts()["entries"] >= N
        engine.apply_snapshot(entries_for(pkg, [config_i(pkg, 0, "x")] + [
            config_i(pkg, i) for i in range(1, N)]))
        snap_new = engine._snapshot
        sharded = snap_new.sharded
        same = []
        for i in range(N):
            s, r = sharded.locator[f"ns/c{i}"]
            same.append(snap_new.mesh_tokens[s][r]
                        == snap_old.mesh_tokens[s][r])
        assert same == [False] + [True] * (N - 1)
        hits_before = vc.counts()["hits"]
        second = submit_all(engine, docs, names)
        hits = vc.counts()["hits"] - hits_before
        assert hits >= int(0.95 * N), hits
        return first, second, hits, same

    both(scenario)


def test_mesh_inflight_pinning_inserts_under_own_tokens():
    """A batch encoded against the old snapshot inserts under its tokens;
    an untouched config's token is equal on the new snapshot."""
    def scenario(pkg):
        engine = pkg.make(max_batch=8, members_k=4, mesh=pkg.mesh(8, 2),
                          verdict_cache_size=256)
        engine.apply_snapshot(entries_for(pkg, [config_i(pkg, i)
                                                for i in range(4)]))
        old = engine._snapshot
        engine.apply_snapshot(entries_for(pkg, [config_i(pkg, 0, "x")] + [
            config_i(pkg, i) for i in range(1, 4)]))
        new = engine._snapshot
        assert old is not new
        s, r = new.sharded.locator["ns/c2"]
        assert new.mesh_tokens[s][r] == old.mesh_tokens[s][r]
        s0, r0 = new.sharded.locator["ns/c0"]
        return (s, r), new.mesh_tokens[s0][r0] == old.mesh_tokens[s0][r0]

    both(scenario)


def test_strict_verify_lints_before_mesh_upload(monkeypatch):
    def scenario(pkg):
        staged_at_lint = []
        real = pkg.lint_mod.lint_snapshot

        def probe(snap, *a, **kw):
            if getattr(snap, "sharded", None) is not None:
                # nothing staged yet: the device params are None
                staged_at_lint.append(snap.sharded.params is not None)
            return real(snap, *a, **kw)

        monkeypatch.setattr(pkg.lint_mod, "lint_snapshot", probe)
        engine = pkg.make(max_batch=8, members_k=4, mesh=pkg.mesh(8, 2),
                          strict_verify=True)
        engine.apply_snapshot(entries_for(pkg, [config_i(pkg, i)
                                                for i in range(6)]))
        assert staged_at_lint == [False]
        assert engine._snapshot.sharded.params is not None
        assert engine._snapshot.lint_ok
        return staged_at_lint

    both(scenario)


def test_strict_verify_rejection_never_stages(monkeypatch):
    def scenario(pkg):
        uploads = []
        real_upload = pkg.Sharded.upload

        def counting_upload(self, prev=None):
            uploads.append(self)
            return real_upload(self, prev)

        monkeypatch.setattr(pkg.Sharded, "upload", counting_upload)
        finding = (__import__("authorino_tpu.analysis", fromlist=["Finding"])
                   if pkg is REF else __import__(
                       "authorino_tpu_torch.analysis", fromlist=["Finding"]))
        monkeypatch.setattr(
            pkg.lint_mod, "lint_snapshot",
            lambda snap, *a, **kw: [finding.Finding(
                kind="shard-stack", message="synthetic corruption",
                layer="tensor_lint", severity="error")])
        engine = pkg.make(max_batch=8, members_k=4, mesh=pkg.mesh(8, 2),
                          strict_verify=True)
        with pytest.raises(pkg.Rejected):
            engine.apply_snapshot(entries_for(pkg, [config_i(pkg, 0)]))
        assert uploads == []
        return engine.generation, len(uploads)

    both(scenario)


def run_batches(engine, n_rounds=6, n=8, idxs=(0, 1, 2, 3)):
    """``n_rounds`` batches of matching-path requests over the configs
    ``idxs`` (every verdict an allow)."""
    docs = [{"request": {"path": f"/p{idxs[i % len(idxs)]}"}}
            for i in range(n)]
    names = [f"ns/c{idxs[i % len(idxs)]}" for i in range(n)]
    got = []
    for _ in range(n_rounds):
        got += [bool(r[0]) for r, _ in submit_all(engine, docs, names)]
    return got, [True] * (n * n_rounds)


def test_one_device_down_fails_over_without_degrade():
    def scenario(pkg):
        engine = pkg.make(max_batch=8, members_k=4, mesh=pkg.mesh(8, 2),
                          verdict_cache_size=0, batch_dedup=False)
        engine.apply_snapshot(entries_for(pkg, [config_i(pkg, i)
                                                for i in range(4)]))
        degraded_before = counter_value(
            "auth_server_degraded_decisions_total", {"lane": "engine"})
        failover_before = counter_value(
            "auth_server_device_failover_total", {"device": "0"})
        pkg.faults.FAULTS.arm("one-device-down")  # kernel:raise:device=0
        try:
            got, expected = run_batches(engine)
        finally:
            pkg.faults.FAULTS.disarm()
        assert got == expected
        assert counter_value("auth_server_degraded_decisions_total",
                             {"lane": "engine"}) == degraded_before
        failovers = counter_value("auth_server_device_failover_total",
                                  {"device": "0"}) - failover_before
        assert failovers > 0
        mv = engine.debug_vars()["mesh"]
        b0 = mv["breakers"]["0"]
        assert b0["consecutive_failures"] > 0 or b0["state"] != "closed"
        assert mv["failovers"]["0"] > 0
        healthy = sum(int(v) for d, v in mv["launches"].items() if d != "0")
        assert healthy > 0
        return (got, failovers, b0["state"], mv["failovers"],
                mv["launches"])

    both(scenario)


def test_open_device_reprobes_and_rejoins_the_mesh():
    """An OPEN device past its cooldown gets its half-open probe from live
    traffic (due probes sort first), and a good probe returns the lane to
    full-mesh launches."""
    def scenario(pkg):
        engine = pkg.make(max_batch=8, members_k=4, mesh=pkg.mesh(8, 2),
                          verdict_cache_size=0, batch_dedup=False,
                          breaker_threshold=3)
        engine.apply_snapshot(entries_for(pkg, [config_i(pkg, i)
                                                for i in range(4)]))
        pkg.faults.FAULTS.arm("one-device-down")
        try:
            run_batches(engine, n_rounds=4)
        finally:
            pkg.faults.FAULTS.disarm()
        state = engine._snapshot.sharded.state
        b0 = state.breakers.get(0)
        assert b0.state == "open"
        full_launches_before = state.launches[0]
        b0._opened_at -= b0.reset_s + 1.0  # cooldown elapsed, no sleep
        got, expected = run_batches(engine, n_rounds=3)
        assert got == expected
        assert b0.state == "closed"
        trail = [t["state"] for t in b0.to_json()["transitions"]]
        assert trail[-2:] == ["half-open", "closed"]
        assert state.launches[0] > full_launches_before
        return trail, dict(state.launches), dict(state.failovers)

    both(scenario)


def test_all_devices_down_degrades_exactly():
    """Every device down: MeshUnavailable, the retry, then on a CPU engine
    the host oracle, exact."""
    def scenario(pkg):
        engine = pkg.make(max_batch=8, members_k=4, mesh=pkg.mesh(8, 2),
                          verdict_cache_size=0, batch_dedup=False,
                          breaker_threshold=1000)
        engine.apply_snapshot(entries_for(pkg, [config_i(pkg, i)
                                                for i in range(4)]))
        degraded_before = counter_value(
            "auth_server_degraded_decisions_total", {"lane": "engine"})
        pkg.faults.FAULTS.arm(";".join(f"kernel:raise:device={d}"
                                       for d in range(8)))
        try:
            got, expected = run_batches(engine, n_rounds=2)
        finally:
            pkg.faults.FAULTS.disarm()
        assert got == expected
        degraded = counter_value("auth_server_degraded_decisions_total",
                                 {"lane": "engine"}) - degraded_before
        assert degraded > 0
        return got, degraded

    both(scenario)


def test_mesh_unavailable_when_all_breakers_exhausted():
    def scenario(pkg):
        model = pkg.Sharded([config_i(pkg, i) for i in range(4)],
                            pkg.mesh(8, 2), members_k=4)
        enc = model.encode([{"request": {"path": "/p0"}}], ["ns/c0"])
        pkg.faults.FAULTS.arm(";".join(f"kernel:raise:device={d}"
                                       for d in range(8)))
        try:
            with pytest.raises(pkg.se.MeshUnavailable):
                model.dispatch_routed(enc)
        finally:
            pkg.faults.FAULTS.disarm()
        assert all(v >= 1 for v in model.state.failovers.values())
        return dict(model.state.failovers)

    both(scenario)


def test_one_config_mutation_ships_to_owning_shard_only():
    """Per-shard delta bytes, equal to the reference's byte for byte on
    the gather lane (whose operands are dtype-equal across packages)."""
    N = 8

    def scenario(pkg):
        engine = pkg.make(max_batch=8, members_k=4, mesh=pkg.mesh(8, 2),
                          kernel_lane="gather")
        engine.apply_snapshot(entries_for(pkg, [config_i(pkg, i)
                                                for i in range(N)]))
        first = engine._snapshot.upload
        assert first["mode"] == "full"
        engine.apply_snapshot(entries_for(pkg, [config_i(pkg, 0, "x")] + [
            config_i(pkg, i) for i in range(1, N)]))
        up = engine._snapshot.upload
        assert up["mode"] == "delta"
        assert up["upload_bytes"] * 2 <= up["full_bytes"]
        owner, _ = engine._snapshot.sharded.locator["ns/c0"]
        per_shard = up["per_shard_bytes"]
        assert per_shard[str(owner)] > 0
        for s, b in per_shard.items():
            if s != str(owner):
                assert b == 0, (s, per_shard)
        got, expected = run_batches(engine, n_rounds=1, n=7,
                                    idxs=tuple(range(1, N)))
        assert got == expected
        return (first["full_bytes"], first["per_shard_bytes"],
                up["upload_bytes"], up["full_bytes"], per_shard, owner)

    both(scenario)


def membership_corpus(pkg, n=6):
    return [pkg.ConfigRules(name=f"m/c{i}", evaluators=[
        (None, pkg.Pattern("auth.identity.roles", pkg.Operator.INCL,
                           f"g{i}"))]) for i in range(n)]


def relief_docs(n=6, roles=40):
    # 40 roles overflow the single-corpus K = 16 and fit the mesh's
    # relieved K (>= 32; 64 on mp = 4)
    return ([{"auth": {"identity": {
        "roles": [f"x{k}" for k in range(roles)] + [f"g{i}"]}}}
        for i in range(n)], [f"m/c{i}" for i in range(n)])


def test_grid_relief_serves_overflow_from_fast_lane():
    def scenario(pkg):
        docs, names = relief_docs()
        single = pkg.make(max_batch=8, members_k=16, mesh=None)
        single.apply_snapshot(entries_for(pkg, membership_corpus(pkg)))
        sharded = pkg.make(max_batch=8, members_k=16, mesh=pkg.mesh(8, 2))
        sharded.apply_snapshot(entries_for(pkg, membership_corpus(pkg)))
        pol = single._snapshot.policy
        rows = [pol.config_ids[n] for n in names]
        if pkg is REF:
            from authorino_tpu.compiler.encode import encode_batch
            from authorino_tpu.compiler.pack import pack_batch
        else:
            from authorino_tpu_torch.compiler.encode import encode_batch
            from authorino_tpu_torch.compiler.pack import pack_batch
        db = pack_batch(pol, encode_batch(pol, docs, rows))
        assert db.host_fallback[: len(docs)].all()
        enc = sharded._snapshot.sharded.encode(docs, names)
        assert not enc.host_fallback[: len(docs)].any()
        assert sharded._snapshot.sharded.decide(docs, names) == \
            [True] * len(docs)
        single_report = single._lowerability["by_reason"]
        mesh_report = sharded._lowerability["by_reason"]
        assert single_report.get("cpu-grid-overflow", 0) == len(names)
        assert mesh_report.get("cpu-grid-overflow", 0) == 0
        return single_report, mesh_report

    both(scenario)


def test_mesh_canary_promotes_clean_window():
    def scenario(pkg):
        engine = pkg.make(max_batch=8, members_k=4, mesh=pkg.mesh(8, 2),
                          canary_fraction=0.5, canary_window_s=0.3)
        engine.apply_snapshot(entries_for(pkg, [config_i(pkg, i)
                                                for i in range(4)]))
        gen_baseline = engine._snapshot.generation
        engine.apply_snapshot(entries_for(pkg, [config_i(pkg, 0, "x")] + [
            config_i(pkg, i) for i in range(1, 4)]))
        assert engine._canary is not None  # mesh <-> mesh swaps canary
        phase = engine._canary
        got, expected = run_batches(engine, n_rounds=2, n=6, idxs=(1, 2, 3))
        assert got == expected
        engine._canary_conclude(phase)
        assert engine._canary is None
        assert engine._snapshot.generation > gen_baseline
        assert engine._snapshot.sharded is phase.snap.sharded
        return got, engine._snapshot.generation - gen_baseline

    both(scenario)
