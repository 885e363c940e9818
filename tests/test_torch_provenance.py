"""The port's rule heat map and decision log against the JAX package's.

The reference's cases (``tests/test_provenance.py``: the heat-map fold and
dead-rule report, the decision-record schema, the sampling bounds, the
engine sampling records, one fold per batch, label truncation) run on the
port, and the port's ``HeatMap`` counts and ``to_json``, ``dead_rule_report``
and ``DecisionLog`` records are held equal to the reference's on the same
firing arrays.  At engine level the same ``Check()``s go through a CPU
engine of each package, with dedup and the cache off and then on: the heat
maps count the same (config, rule) pairs, equal to the host oracle's
firing columns, and the dead-rule reports are equal.  The heat maps' own
counts are compared, not Prometheus series: both packages record into one
registry when ``prometheus_client`` is present.  Tolerance 0 throughout."""

import asyncio

import numpy as np
import pytest

from authorino_tpu.runtime import provenance as r_prov
from authorino_tpu_torch.compiler import ConfigRules
from authorino_tpu_torch.expressions import All, Operator, Pattern
from authorino_tpu_torch.models import northstar
from authorino_tpu_torch.models.policy_model import host_results
from authorino_tpu_torch.ops.operands import firing_columns
from authorino_tpu_torch.runtime import EngineEntry, PolicyEngine
from authorino_tpu_torch.runtime import provenance as prov_mod

from test_torch_dispatch import wait_until_sync
from test_torch_pipeline import PORT, REF, engine_of, port_request_to


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def reset_fired():
    prov_mod._reset_fired_for_tests()
    r_prov._reset_fired_for_tests()


def build_engine(configs, **kw) -> PolicyEngine:
    # the host lanes off: every batch folds as the device lane's
    kw.setdefault("lane_select", False)
    kw.setdefault("brownout", False)
    engine = PolicyEngine(max_batch=32, members_k=4, device="cpu", **kw)
    engine.apply_snapshot([EngineEntry(id=c.name, hosts=[c.name], rules=c)
                           for c in configs])
    return engine


RULE = All(Pattern("request.method", Operator.EQ, "GET"),
           Pattern("auth.identity.org", Operator.EQ, "acme"))
DENY_RULE2 = Pattern("request.headers.x-tier", Operator.EQ, "gold")


def doc(method="GET", org="acme", tier="gold"):
    return {"request": {"method": method, "host": "c", "headers":
                        {"x-tier": tier}},
            "auth": {"identity": {"org": org}}}


async def _submit_one(engine, d):
    return await engine.submit(dict(d), "c")


def idle(engine) -> bool:
    """True once no batch of ``engine`` is in flight (its completer folds
    before it frees the slot)."""
    return wait_until_sync(lambda: engine._inflight == 0)


# ---- the reference's cases --------------------------------------------------

def test_heat_map_folds_and_dead_rule_report():
    reset_fired()
    configs = [ConfigRules(name="c", evaluators=[(None, RULE),
                                                 (None, DENY_RULE2)])]
    engine = build_engine(configs)
    heat = engine._snapshot.heat
    assert heat is not None
    folds_before = heat.fold_calls
    run(_submit_one(engine, doc(org="evil")))       # rule 0 fires
    assert idle(engine)
    assert heat.fold_calls > folds_before
    heat.flush()
    fired = prov_mod.fired_pairs()
    assert ("c", 0) in fired and ("c", 1) not in fired
    report = prov_mod.dead_rule_report(heat, None)
    assert report["rules_total"] == 2
    assert report["rules_fired"] == 1
    never = {d["rule"] for d in report["never_fired"]}
    assert len(never) == 1 and next(iter(never)).startswith("1:")
    assert report["statically_explained"] == 0
    view = engine.debug_vars()["provenance"]
    assert view["dead_rules"] == report
    assert view["heat"]["configs"] == 1 and view["heat"]["rules"] == 2
    try:
        from prometheus_client import REGISTRY
    except ImportError:
        return
    label = prov_mod.rule_label(0, str(RULE))
    v = REGISTRY.get_sample_value("auth_server_rule_fired_total",
                                  {"authconfig": "c", "rule": label})
    assert v and v >= 1.0


def test_decision_record_schema_pinned():
    log = prov_mod.DecisionLog(capacity=8, sample_n=1)
    log.record(lane="engine", host="a.test", authconfig="c", verdict=False,
               rule="0:x eq y", rule_index=0, latency_ms=1.25,
               generation=3)
    rec = log.to_json()["records"][-1]
    assert tuple(sorted(rec)) == tuple(sorted(prov_mod.DECISION_FIELDS))
    assert prov_mod.DECISION_FIELDS == r_prov.DECISION_FIELDS
    assert prov_mod.DECISION_SCHEMA == r_prov.DECISION_SCHEMA
    assert rec["verdict"] == "deny" and rec["rule_index"] == 0
    assert log.to_json()["schema"] == prov_mod.DECISION_SCHEMA
    prov_mod.check_decision_schema(log.to_json())
    for payload in ({"schema": 1}, {}, None, []):
        with pytest.raises(prov_mod.DecisionSchemaError):
            prov_mod.check_decision_schema(payload)
    assert issubclass(prov_mod.DecisionSchemaError, ValueError)


def test_decision_log_head_sampling_bounds():
    log = prov_mod.DecisionLog(capacity=16, sample_n=100)
    ref = r_prov.DecisionLog(capacity=16, sample_n=100)
    fires = [log.should_sample(10) for _ in range(50)]
    assert 1 <= sum(fires) <= 10
    assert fires == [ref.should_sample(10) for _ in range(50)]
    sizes = [3, 0, 40, 7, 1, 64, 5, 5, 5, 200]
    for tenant in ("a", "b"):
        assert [log.should_sample_tenant(tenant, n) for n in sizes] == \
            [ref.should_sample_tenant(tenant, n) for n in sizes]


def test_engine_samples_decision_records():
    prov_mod.DECISIONS.configure(sample_n=1)
    try:
        configs = [ConfigRules(name="c", evaluators=[(None, RULE)])]
        engine = build_engine(configs)
        before = prov_mod.DECISIONS.records_total
        run(_submit_one(engine, doc(org="evil")))
        assert idle(engine)
        assert prov_mod.DECISIONS.records_total > before
        rec = prov_mod.DECISIONS.to_json(n=1)["records"][-1]
        assert rec["authconfig"] == "c"
        assert rec["verdict"] == "deny"
        assert rec["rule"] and rec["rule"].startswith("0:")
        assert rec["host"] == "c"
        assert rec["generation"] == engine.generation
        assert engine.debug_vars()["provenance"]["decisions"][
            "records_total"] == prov_mod.DECISIONS.records_total
    finally:
        prov_mod.DECISIONS.configure(sample_n=64)


def test_fold_is_per_batch_not_per_request():
    """64 concurrent requests fold once per batch (fold_calls ≪ 64) and
    sample at most one decision record per batch."""
    prov_mod.DECISIONS.configure(sample_n=1)
    try:
        configs = [ConfigRules(name="c", evaluators=[(None, RULE)])]
        engine = build_engine(configs)
        heat = engine._snapshot.heat
        records_before = prov_mod.DECISIONS.records_total

        async def burst():
            await asyncio.gather(*(engine.submit(doc(), "c")
                                   for _ in range(64)))

        run(burst())
        assert idle(engine)
        assert 1 <= heat.fold_calls <= 16, heat.fold_calls
        assert (prov_mod.DECISIONS.records_total - records_before
                <= heat.fold_calls)
    finally:
        prov_mod.DECISIONS.configure(sample_n=64)


def test_rule_label_truncates_but_never_merges():
    long_a = "x eq " + "a" * 300
    long_b = "x eq " + "b" * 300
    la, lb = prov_mod.rule_label(0, long_a), prov_mod.rule_label(0, long_b)
    assert len(la) <= prov_mod.RULE_LABEL_MAX + 4
    assert la != lb or long_a == long_b
    assert prov_mod.rule_label(1, "short") == "1:short"
    for col, src in ((0, long_a), (3, long_b), (1, "short"), (2, "")):
        assert prov_mod.rule_label(col, src) == r_prov.rule_label(col, src)


# ---- the same firing arrays through both packages ---------------------------

G, E = 12, 4
NAMES = [f"cfg-{i}" for i in range(G - 2)] + ["", "cfg-last"]  # a pad row
SOURCES = [[f"rule {i}.{j} " + "x" * (30 * j) for j in range(E)]
           for i in range(G)]


def firing_batches(seed, n_batches=6):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        B = int(rng.integers(1, 300))
        own_rule = rng.random((B, E)) > 0.35
        own_skipped = rng.random((B, E)) > 0.8
        rows = rng.integers(0, G, size=B)
        out.append((rows, firing_columns(own_rule, own_skipped)))
    return out


@pytest.mark.parametrize("seed", [3, 11, 29])
def test_heat_map_and_report_equal_reference(seed):
    reset_fired()
    heat = prov_mod.HeatMap(NAMES, SOURCES, E)
    ref = r_prov.HeatMap(NAMES, SOURCES, E)
    for rows, firing in firing_batches(seed):
        heat.fold(rows, firing)
        ref.fold(rows, firing)
    assert np.array_equal(heat._counts, ref._counts)
    assert heat._counts.sum() > 0
    got, want = heat.to_json(), ref.to_json()
    for k in ("fold_seconds",):
        got.pop(k), want.pop(k)
    assert got == want
    assert list(heat.registered_rules()) == list(ref.registered_rules())
    assert [heat.name(r) for r in range(-1, G + 1)] == \
        [ref.name(r) for r in range(-1, G + 1)]
    assert [heat.source(r, c) for r in range(G) for c in range(-1, E + 1)] \
        == [ref.source(r, c) for r in range(G) for c in range(-1, E + 1)]
    for limit in (100, 3):
        assert prov_mod.dead_rule_report(heat, None, limit=limit) == \
            r_prov.dead_rule_report(ref, None, limit=limit)
    assert prov_mod.fired_pairs() == r_prov.fired_pairs()
    assert prov_mod.dead_rule_report(None, None) is None


@pytest.mark.parametrize("sample_n", [1, 3, 50])
def test_decision_records_equal_reference(monkeypatch, sample_n):
    """``fold_and_sample`` over the same batches writes the same records
    (all but the wall-clock stamp) into each package's decision log."""
    port_log = prov_mod.DecisionLog(capacity=64, sample_n=sample_n)
    ref_log = r_prov.DecisionLog(capacity=64, sample_n=sample_n)
    monkeypatch.setattr(prov_mod, "DECISIONS", port_log)
    monkeypatch.setattr(r_prov, "DECISIONS", ref_log)
    heat = prov_mod.HeatMap(NAMES, SOURCES, E)
    ref = r_prov.HeatMap(NAMES, SOURCES, E)
    for b, (rows, firing) in enumerate(firing_batches(sample_n + 5)):
        kw = dict(lane="engine", host="h", latency_ms=1.5 * b,
                  generation=b, host_of=lambda i: f"host-{i}",
                  latency_of=lambda i: 0.25 * i)
        prov_mod.fold_and_sample(heat, rows, firing, len(rows), **kw)
        r_prov.fold_and_sample(ref, rows, firing, len(rows), **kw)
    got, want = port_log.to_json(), ref_log.to_json()
    assert got["records_total"] == want["records_total"] > 0
    strip = [{k: v for k, v in r.items() if k != "t"}
             for r in got.pop("records")]
    assert strip == [{k: v for k, v in r.items() if k != "t"}
                     for r in want.pop("records")]
    assert got == want
    assert port_log.to_json(tenant="cfg-1")["records"][0]["authconfig"] \
        == "cfg-1"
    assert port_log.to_json(n=0)["records"] == []


# ---- engines of both packages on the same Check()s --------------------------

def oracle_counts(policy, seen):
    """(config, rule) → denials, from the host oracle's firing column of
    every submitted row."""
    counts = {}
    for d, name in seen:
        row = policy.config_ids[name]
        _, rule, skipped = host_results(policy, d, row)
        col = int(firing_columns(rule[None, :], skipped[None, :])[0])
        if col >= 0:
            counts[(name, col)] = counts.get((name, col), 0) + 1
    return counts


def heat_counts(heat):
    out = {}
    for key in np.nonzero(heat._counts)[0]:
        row, col = divmod(int(key), heat.E + 1)
        out[(heat.names_by_row[row], col)] = int(heat._counts[key])
    return out


@pytest.mark.parametrize("on", [False, True])
def test_engine_heat_maps_equal_reference_and_oracle(on):
    """North-star AuthConfigs translated by each package; the same
    concurrent Check()s (each twice, so the second pass meets the cache
    when it is on) through a CPU engine of each: equal heat-map counts,
    equal to the oracle's, and equal dead-rule reports."""
    reset_fired()
    specs = northstar.build_auth_configs(16, 10)
    requests = northstar.build_check_requests(96, 16, seed=3)
    knobs = dict(max_batch=64, verdict_cache_size=4096 if on else 0,
                 batch_dedup=on)
    heats, seen = {}, []
    for ns in (REF, PORT):
        engine = engine_of(ns, **knobs)
        if ns is PORT:
            inner = engine.submit

            async def submit(d, name, _inner=inner, **kw):
                seen.append((d, name))
                return await _inner(d, name, **kw)

            engine.submit = submit

        async def body():
            engine.apply_snapshot([
                await ns.controllers.translate_auth_config(
                    o["metadata"]["name"], o["metadata"]["namespace"],
                    o["spec"], engine=engine) for o in specs])
            reqs = (requests if ns is PORT
                    else [port_request_to(REF, r) for r in requests])
            for _ in range(2):
                await asyncio.gather(*(engine.check(r) for r in reqs))

        run(body())
        assert wait_until_sync(lambda: engine._inflight == 0)
        heats[ns is PORT] = (engine._snapshot.heat, engine)
    (ref_heat, ref_engine), (heat, engine) = heats[False], heats[True]
    assert len(seen) == 2 * len(requests)
    if on:
        assert engine.stats["cache_rows"] + engine.stats["dedup_rows"] > 0
    want = oracle_counts(engine._snapshot.policy, seen)
    assert want and heat_counts(heat) == want == heat_counts(ref_heat)
    assert heat.names_by_row == ref_heat.names_by_row
    assert heat.sources_by_row == ref_heat.sources_by_row
    report = prov_mod.dead_rule_report(heat, None)
    assert report == r_prov.dead_rule_report(ref_heat, None)
    assert report["rules_fired"] == len(want)
    assert engine.debug_vars()["provenance"]["dead_rules"] == report
