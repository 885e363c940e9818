"""The port's fleet plane against the JAX package's.

Each test of the reference's ``tests/test_fleet.py`` runs its scenario
through both packages on the same seeded inputs (router placements and
outcomes, aggregator breaches and containment suspects, warm-join counts,
harness verdict columns and canary records) and holds the observations
equal, tolerance 0: every output is a name, a count or a boolean.  The
port's replicas are CPU engines (``device="cpu"``); the reference's run
JAX on the CPU."""

from __future__ import annotations

import asyncio
import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest

import authorino_tpu.fleet as r_fleet
import authorino_tpu_torch.fleet as p_fleet
from authorino_tpu.fleet import warmjoin as r_warmjoin
from authorino_tpu_torch.fleet import warmjoin as p_warmjoin
from authorino_tpu.analysis import code_lint as r_lint
from authorino_tpu.analysis import translation_validate as r_tv
from authorino_tpu.compiler import ConfigRules as RConfigRules
from authorino_tpu.expressions import Operator as ROperator
from authorino_tpu.expressions import Pattern as RPattern
from authorino_tpu.runtime import EngineEntry as REntry
from authorino_tpu.runtime import PolicyEngine as REngine
from authorino_tpu.runtime.change_safety import GuardThresholds as RTh
from authorino_tpu.snapshots import distribution as r_dist
from authorino_tpu.utils import rpc as r_rpc
from authorino_tpu_torch.analysis import code_lint as p_lint
from authorino_tpu_torch.analysis import translation_validate as p_tv
from authorino_tpu_torch.compiler import ConfigRules as PConfigRules
from authorino_tpu_torch.expressions import Operator as POperator
from authorino_tpu_torch.expressions import Pattern as PPattern
from authorino_tpu_torch.runtime import EngineEntry as PEntry
from authorino_tpu_torch.runtime import PolicyEngine as PEngine
from authorino_tpu_torch.runtime.change_safety import GuardThresholds as PTh
from authorino_tpu_torch.snapshots import distribution as p_dist
from authorino_tpu_torch.utils import rpc as p_rpc


def _ref_engine(**kw):
    return REngine(members_k=4, mesh=None, lane_select=False,
                   kernel_lane="fused", **kw)


def _port_engine(**kw):
    return PEngine(members_k=4, device="cpu", **kw)


REF = SimpleNamespace(name="ref", fleet=r_fleet, warmjoin=r_warmjoin,
                      Entry=REntry, make=_ref_engine, ConfigRules=RConfigRules,
                      Pattern=RPattern, Operator=ROperator, TH=RTh,
                      dist=r_dist, rpc=r_rpc, tv=r_tv)
PORT = SimpleNamespace(name="port", fleet=p_fleet, warmjoin=p_warmjoin,
                       Entry=PEntry, make=_port_engine, ConfigRules=PConfigRules,
                       Pattern=PPattern, Operator=POperator, TH=PTh,
                       dist=p_dist, rpc=p_rpc, tv=p_tv)


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def both(scenario, *args):
    """Run ``scenario(pkg, *args)`` on both packages: the observations must
    be equal; returns the port's."""
    ref = scenario(REF, *args)
    port = scenario(PORT, *args)
    assert port == ref, (port, ref)
    return port


def org_corpus(pkg, orgs):
    """name -> org constant; each config allows exactly that org (a
    constant typo is a constant-deny poison: the verdict really flips)."""
    return [pkg.ConfigRules(name=n, evaluators=[
        (None, pkg.Pattern("auth.identity.org", pkg.Operator.EQ, org))])
        for n, org in orgs.items()]


def entries_of(pkg, cfgs):
    return [pkg.Entry(id=c.name, hosts=[c.name], runtime=None, rules=c)
            for c in cfgs]


def build_engine(pkg, cfgs=None, **kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("verdict_cache_size", 4096)
    # leaders certify what they publish: replicas reject uncertified
    # snapshots at admission
    kw.setdefault("strict_verify", True)
    engine = pkg.make(**kw)
    if cfgs is not None:
        engine.apply_snapshot(entries_of(pkg, cfgs))
    return engine


def cdoc(j, org):
    return {"request": {"host": f"h{j}", "path": f"/p{j}", "method": "GET"},
            "auth": {"identity": {"org": org}}}


V1 = {f"c{i}": f"org-{i}" for i in range(6)}


def thresholds(pkg):
    # low-volume thresholds for deterministic canary tests
    return pkg.TH(min_requests=8, min_config_requests=4,
                  min_config_allows=2, min_tenant_attempts=8)


def static_health(**over):
    h = {"ready": True, "draining": False, "breaker_open": False,
         "overloaded": False, "queue_depth": 0, "predicted_wait_s": 0.0}
    h.update(over)
    return h


def bits(out):
    return [(np.asarray(r).tolist(), np.asarray(s).tolist()) for r, s in out]


@pytest.fixture(autouse=True)
def _fresh_certificates():
    """The certificate caches are process-wide: each test certifies from
    scratch in both packages."""
    r_tv.clear_certificate_cache()
    p_tv.clear_certificate_cache()
    yield


# ---------------------------------------------------------------------------
# router: rendezvous placement and the hybrid outcomes
# ---------------------------------------------------------------------------


def test_routing_key_stable_and_distinct():
    def scenario(pkg):
        rk = pkg.fleet.routing_key
        a = rk("c1", cdoc(1, "org-1"))
        assert a == rk("c1", cdoc(1, "org-1"))
        assert a != rk("c2", cdoc(1, "org-1"))
        assert a != rk("c1", cdoc(2, "org-1"))
        return [rk(f"c{i}", cdoc(i, f"org-{i}")) for i in range(20)] + [
            rk("c0", {"x": object.__name__}), rk("c0", [1, "a", None])]

    both(scenario)


def test_rendezvous_moves_only_departed_replicas_keys():
    """Removing one replica reassigns exactly the keys that lived on it,
    and the placements are the reference's."""
    def scenario(pkg):
        router = pkg.fleet.FleetRouter()
        for name in ("ra", "rb", "rc", "rd"):
            router.add_replica(name, static_health)
        keys = [pkg.fleet.routing_key(f"c{i % 7}", cdoc(i, f"org-{i % 7}"))
                for i in range(300)]
        before = {k: router.route(k)[0] for k in keys}
        router.remove_replica("rb")
        after = {k: router.route(k)[0] for k in keys}
        for k in keys:
            if before[k] != "rb":
                assert after[k] == before[k]
            else:
                assert after[k] != "rb"
        moved = sum(1 for k in keys if before[k] == "rb")
        assert 0 < moved < len(keys) / 2
        return [before[k] for k in keys], [after[k] for k in keys]

    both(scenario)


def test_router_unhealthy_routes_to_best_routable():
    def scenario(pkg):
        router = pkg.fleet.FleetRouter()
        key = pkg.fleet.routing_key("c1", cdoc(1, "org-1"))
        router.add_replica("ra", static_health)
        router.add_replica("rb", static_health)
        primary = router.route(key)[0]
        other = "rb" if primary == "ra" else "ra"
        router.remove_replica(primary)
        router.add_replica(primary, lambda: static_health(ready=False))
        first, second = router.route(key)
        assert first == other and second is None
        assert router.outcomes.get("unhealthy", 0) >= 1
        router.remove_replica(primary)
        router.add_replica(primary, lambda: static_health(draining=True))
        assert router.route(key)[0] == other
        return primary, dict(router.outcomes), router.to_json()["replicas"]

    both(scenario)


def test_router_deadline_spillover_and_load_shift():
    def scenario(pkg):
        router = pkg.fleet.FleetRouter(load_factor=2.0, min_shift_depth=8)
        key = pkg.fleet.routing_key("c1", cdoc(1, "org-1"))
        router.add_replica("ra", static_health)
        router.add_replica("rb", static_health)
        primary = router.route(key)[0]
        backup = "rb" if primary == "ra" else "ra"
        router.remove_replica(primary)
        router.add_replica(primary,
                           lambda: static_health(predicted_wait_s=0.5))
        spill = router.route(key, deadline_budget_s=0.1)
        assert spill == (backup, primary)
        assert router.outcomes.get("spillover", 0) == 1
        assert router.route(key)[0] == primary
        router.remove_replica(primary)
        router.add_replica(primary, lambda: static_health(queue_depth=64))
        shift = router.route(key)
        assert shift == (backup, primary)
        assert router.outcomes.get("load-shift", 0) == 1
        return spill, shift, dict(router.outcomes)

    both(scenario)


def test_router_exclude_is_policy_not_unhealthy():
    def scenario(pkg):
        router = pkg.fleet.FleetRouter()
        key = pkg.fleet.routing_key("c1", cdoc(1, "org-1"))
        router.add_replica("ra", static_health)
        router.add_replica("rb", static_health)
        primary = router.route(key)[0]
        backup = "rb" if primary == "ra" else "ra"
        got = router.route(key, exclude=primary)
        assert got == (backup, None)
        assert router.outcomes.get("unhealthy", 0) == 0
        return got, dict(router.outcomes)

    both(scenario)


def test_router_no_replica_and_health_probe_exception():
    def scenario(pkg):
        router = pkg.fleet.FleetRouter()
        key = pkg.fleet.routing_key("c1", cdoc(1, "org-1"))
        assert router.route(key) == (None, None)
        assert router.outcomes.get("no-replica") == 1

        def bad_probe():
            raise RuntimeError("probe died")

        router.add_replica("ra", bad_probe)
        assert router.route(key) == (None, None)
        return dict(router.outcomes), router.to_json()

    both(scenario)


def test_in_fleet_cohort_fraction_and_determinism():
    def scenario(pkg):
        f = pkg.fleet
        keys = [f.routing_key(f"c{i % 5}", cdoc(i, f"org-{i % 5}"))
                for i in range(1000)]
        assert not any(f.in_fleet_cohort(k, 0.0) for k in keys)
        assert all(f.in_fleet_cohort(k, 1.0) for k in keys)
        half = [f.in_fleet_cohort(k, 0.5) for k in keys]
        assert half == [f.in_fleet_cohort(k, 0.5) for k in keys]
        assert 0.35 < sum(half) / len(half) < 0.65
        return half, [f.in_fleet_cohort(k, 0.1) for k in keys]

    both(scenario)


# ---------------------------------------------------------------------------
# aggregator: fold deltas into the global guard; global containment
# ---------------------------------------------------------------------------


def fold(requests=0, denies=0, errors=0, slo_total=0, slo_bad=0,
         tenants=None, wait_hot=False):
    return {"errors": errors, "slo_total": slo_total, "slo_bad": slo_bad,
            "tenants": tenants or {}, "tenant_rejects": {},
            "wait_hot": wait_hot,
            "admission_state": "OVERLOADED" if wait_hot else "HEALTHY"}


def tfold(**tenants):
    """tenant -> (requests, denies, rate)."""
    return {n: {"requests": r, "denies": d, "slo_bad": 0, "rate": rate}
            for n, (r, d, rate) in tenants.items()}


def _breach_view(b):
    return None if b is None else (sorted(b["guards"]),
                                   sorted(b.get("suspects") or {}))


def test_aggregator_deltas_feed_global_guard_cohorts():
    """The canary replica's deltas land on the canary side, the rest of
    the fleet's on the baseline side; a deny spike local to the canary
    breaches on global evidence."""
    def scenario(pkg):
        agg = pkg.fleet.FleetAggregator()
        agg.ingest("rc", fold(tenants=tfold(c3=(10, 0, 1.0))))
        agg.ingest("rb", fold(tenants=tfold(c3=(10, 0, 1.0))))
        agg.arm_guard("rc", changed={"c3"}, thresholds=thresholds(pkg))
        agg.ingest("rc", fold(tenants=tfold(c3=(26, 16, 1.0))))
        agg.ingest("rb", fold(tenants=tfold(c3=(40, 0, 1.0))))
        b = agg.guard_breach()
        assert b is not None and "config-deny-rate" in b["guards"]
        assert "c3" in b["suspects"]
        assert agg.breaches and agg.breaches[0] is b
        return (_breach_view(b), agg.guard._canary.total,
                agg.guard._baseline.total, agg.guard._canary.denies)

    both(scenario)


def test_aggregator_arm_rebaselines_and_clamps_counter_resets():
    def scenario(pkg):
        agg = pkg.fleet.FleetAggregator()
        agg.ingest("ra", fold(tenants=tfold(c0=(500, 500, 1.0))))
        agg.arm_guard("ra", thresholds=thresholds(pkg))
        agg.ingest("ra", fold(tenants=tfold(c0=(500, 500, 1.0))))
        assert agg.guard._canary.total == 0
        agg.ingest("ra", fold(tenants=tfold(c0=(5, 2, 1.0))))
        assert agg.guard._canary.total == 0
        assert agg.guard._canary.denies == 0
        assert agg.guard_breach() is None
        agg.disarm_guard()
        return agg.guard is None, sorted(agg.to_json()["replicas"])

    both(scenario)


def test_global_containment_fires_when_every_local_share_is_clean():
    """Consistent-hash concentration makes a fleet-hot tenant look locally
    entitled on every replica; only the global fold sees its share."""
    local = {
        "ra": {"hot": 10.0, "t1": 1.0, "t2": 1.0},
        "rb": {"t3": 1.0, "t4": 1.0, "t5": 1.0},
        "rc": {"t6": 1.0, "t7": 1.0, "t8": 1.0},
    }

    def scenario(pkg):
        t0 = 1000.0
        for rates in local.values():
            checker = pkg.fleet.GlobalContainment()
            assert checker.check(rates, pressure=True, now=t0) == {}
            assert checker.check(rates, pressure=True, now=t0 + 0.6) == {}
        agg = pkg.fleet.FleetAggregator()
        for name, rates in local.items():
            agg.ingest(name, fold(
                tenants=tfold(**{t: (100, 0, r) for t, r in rates.items()}),
                wait_hot=(name == "ra")))
        assert agg.containment_check(now=t0) == {}
        suspects = agg.containment_check(now=t0 + 0.6)
        assert "hot" in suspects and suspects["hot"]["ratio"] > 3.0
        shares = {t: round(s, 9) for t, s in agg.global_shares().items()}
        agg.forget("ra")
        assert agg.containment_check(now=t0 + 1.2) == {}
        return suspects, shares

    both(scenario)


def test_global_containment_needs_fleet_pressure():
    def scenario(pkg):
        agg = pkg.fleet.FleetAggregator()
        agg.ingest("ra", fold(tenants=tfold(hot=(100, 0, 10.0),
                                            t1=(10, 0, 0.1))))
        t0 = time.monotonic()
        first = agg.containment_check(now=t0)
        second = agg.containment_check(now=t0 + 0.6)
        assert first == second == {}
        return agg.fleet_pressure(), agg.global_rates()

    both(scenario)


# ---------------------------------------------------------------------------
# warm-join: hot-set export and import
# ---------------------------------------------------------------------------


def serve(engine, docs_cfgs):
    async def _go():
        return await asyncio.gather(
            *[engine.submit(dict(d), c) for d, c in docs_cfgs])
    return run(_go())


def leader_with_published(pkg, d):
    leader = build_engine(pkg, org_corpus(pkg, V1))
    pub = pkg.dist.SnapshotPublisher(d)
    pub.publish_from_engine(leader)
    return leader, pub


def test_hotset_roundtrip_imports_and_hits(tmp_path):
    def scenario(pkg):
        d = str(tmp_path / pkg.name)
        leader, pub = leader_with_published(pkg, d)
        traffic = [(cdoc(j, f"org-{j % 6}"), f"c{j % 6}") for j in range(24)]
        serve(leader, traffic)
        digest = pkg.warmjoin.export_hotset(leader, k=64)
        assert digest is not None and len(digest["entries"]) > 0
        pub.publish_hotset(digest)
        joiner = build_engine(pkg)
        joiner.apply_published(pkg.dist.load_latest(d))
        imported, skipped = pkg.warmjoin.import_hotset(
            joiner, pkg.dist.load_hotset(d))
        assert imported == len(digest["entries"]) and skipped == 0
        cache = joiner._verdict_cache
        h0, m0 = cache.hits, cache.misses
        got = serve(joiner, traffic[:1])
        assert cache.hits > h0 and cache.misses == m0
        want = serve(leader, traffic[:1])
        assert bits(got) == bits(want)
        return imported, skipped, bits(got)

    both(scenario)


def test_hotset_refuses_interner_and_version_mismatch(tmp_path):
    def scenario(pkg):
        d = str(tmp_path / pkg.name)
        leader, _ = leader_with_published(pkg, d)
        serve(leader, [(cdoc(j, f"org-{j % 6}"), f"c{j % 6}")
                       for j in range(12)])
        digest = pkg.warmjoin.export_hotset(leader, k=64)
        joiner = build_engine(pkg)
        joiner.apply_published(pkg.dist.load_latest(d))
        out = (pkg.warmjoin.import_hotset(joiner, dict(digest,
                                                    interner="0" * 16)),
               pkg.warmjoin.import_hotset(joiner, dict(digest, version=99)),
               pkg.warmjoin.import_hotset(joiner, None))
        assert out == ((0, 0), (0, 0), (0, 0))
        return out

    both(scenario)


# ---------------------------------------------------------------------------
# harness: join, leave, crash, canary, bit-exactness
# ---------------------------------------------------------------------------


def make_fleet(pkg, d, n_replicas=2, warm=False):
    h = pkg.fleet.FleetHarness(d, lambda: build_engine(pkg), poll_s=0.05)
    h.add_leader(entries=entries_of(pkg, org_corpus(pkg, V1)))
    for i in range(1, n_replicas + 1):
        h.add_replica(f"r{i}", warm_join=warm)
    return h


def fleet_traffic(pkg, h, n, start=0, collect=False):
    """Round-robin over the corpus; returns (ok, typed, outs)."""
    ok = typed = 0
    outs = []
    for j in range(start, start + n):
        cfg = f"c{j % 6}"
        try:
            r, s = h.check(cfg, cdoc(j, V1[cfg]))
        except pkg.rpc.CheckAbort:
            typed += 1
        else:
            ok += 1
            if collect:
                outs.append((cfg, j, bool(r[0])))
    return ok, typed, outs


def test_fleet_serves_and_crash_degrades_typed_only(tmp_path):
    def scenario(pkg):
        h = make_fleet(pkg, str(tmp_path / pkg.name), n_replicas=2)
        try:
            ok, typed, outs = fleet_traffic(pkg, h, 60, collect=True)
            assert (ok, typed) == (60, 0)
            assert all(allowed for _, _, allowed in outs)
            placed = [h.router.route(pkg.fleet.routing_key(
                f"c{i}", cdoc(i, "x")))[0] for i in range(20)]
            h.crash_replica("r2")
            ok, typed, _ = fleet_traffic(pkg, h, 60, start=60)
            assert ok + typed == 60 and ok > 0
            after = [h.router.route(pkg.fleet.routing_key(
                f"c{i}", cdoc(i, "x")))[0] for i in range(20)]
            assert "r2" not in after
            assert h.remove_replica("r1") is True
            ok2, typed2, _ = fleet_traffic(pkg, h, 30, start=120)
            assert ok2 == 30
            return outs, placed, after, (ok, typed), (ok2, typed2)
        finally:
            h.shutdown()

    both(scenario)


def test_fleet_no_routable_replica_is_typed(tmp_path):
    def scenario(pkg):
        h = pkg.fleet.FleetHarness(str(tmp_path / pkg.name),
                                   lambda: build_engine(pkg))
        with pytest.raises(pkg.rpc.CheckAbort) as ei:
            h.check("c0", cdoc(1, "org-0"))
        assert ei.value.code == pkg.rpc.UNAVAILABLE
        return ei.value.code, str(ei.value)

    both(scenario)


def test_fleet_warm_join_beats_cold(tmp_path):
    def scenario(pkg):
        h = make_fleet(pkg, str(tmp_path / pkg.name), n_replicas=0)
        try:
            trace = [(cdoc(j, f"org-{j % 6}"), f"c{j % 6}")
                     for j in range(30)]
            serve(h.leader.engine, trace)
            assert h.publish_hotset(k=256) is True
            cold = h.add_replica("cold", warm_join=False)
            warm = h.add_replica("warm", warm_join=True)
            assert warm.warm_imported > 0 and cold.warm_imported == 0
            got = {}
            for name, rep in (("cold", cold), ("warm", warm)):
                got[name] = bits(rep.check(c, dict(d)).result(timeout=10)
                                 for d, c in trace)
            cold_hits = cold.engine._verdict_cache.hits
            warm_hits = warm.engine._verdict_cache.hits
            assert warm_hits > cold_hits
            return (warm.warm_imported, cold_hits, warm_hits, got)
        finally:
            h.shutdown()

    both(scenario)


def test_fleet_verdicts_bit_exact_across_replicas(tmp_path):
    """Every port replica serves the verdict columns of a cold independent
    compile of the same corpus in the reference."""
    trace = [(cdoc(j, f"org-{j % 9}" if j % 3 else "org-elsewhere"),
              f"c{j % 6}") for j in range(40)]
    oracle = build_engine(REF, org_corpus(REF, V1))
    want = bits(serve(oracle, trace))
    h = make_fleet(PORT, str(tmp_path), n_replicas=2, warm=True)
    try:
        assert sorted(h.replicas) == ["leader", "r1", "r2"]
        for rep in h.replicas.values():
            got = bits(rep.check(c, dict(d)).result(timeout=10)
                       for d, c in trace)
            assert got == want, rep.name
    finally:
        h.shutdown()


def test_fleet_canary_breach_rolls_back_fleet_wide(tmp_path):
    """A poison canaried on one replica, judged on fleet folds, rolled
    back everywhere through the manifest, late joiners included."""
    def scenario(pkg):
        d = str(tmp_path / pkg.name)
        h = make_fleet(pkg, d, n_replicas=2)
        try:
            fleet_traffic(pkg, h, 60)
            h.publish_folds()
            poison = dict(V1, c3="org-NEVER")
            h.start_canary("r1", entries_of(pkg, org_corpus(pkg, poison)),
                           changed={"c3"}, thresholds=thresholds(pkg),
                           fraction=0.5)
            gen_canary = h.replicas["r1"].engine.generation
            breach = None
            rounds = 0
            for round_ in range(8):
                fleet_traffic(pkg, h, 60, start=1000 * (round_ + 1))
                h.publish_folds()
                rounds += 1
                breach = h.canary_tick()
                if breach:
                    break
            assert breach is not None, h.aggregator.to_json()
            assert "config-deny-rate" in breach["breach"]["guards"]
            assert "c3" in breach["breach"]["suspects"]
            assert breach["detection_s"] > 0 and breach["mttr_s"] >= 0
            r, _ = h.replicas["r1"].check(
                "c3", cdoc(7777, "org-3")).result(timeout=10)
            assert bool(r[0])
            assert h.replicas["r1"].engine.generation > gen_canary
            man = json.load(open(os.path.join(d, "MANIFEST.json")))
            assert man["rollback"]["reason"] == "fleet-guard-breach"
            assert man["rollback"]["canary_replica"] == "r1"
            assert man["quarantine"]["configs"] == ["c3"]
            late = h.add_replica("late", warm_join=False)
            r2, _ = late.check("c3", cdoc(7778, "org-3")).result(timeout=10)
            assert bool(r2[0])
            assert h.canary_tick() is None
            return (rounds, sorted(breach["breach"]["guards"]),
                    sorted(breach["breach"]["suspects"]),
                    man["rollback"], man["quarantine"]["configs"])
        finally:
            h.shutdown()

    both(scenario)


def test_fleet_canary_cohort_pins_traffic(tmp_path):
    """While armed, the cohort slice lands on the canary replica and
    nothing else does."""
    def scenario(pkg):
        h = make_fleet(pkg, str(tmp_path / pkg.name), n_replicas=2)
        try:
            h.start_canary("r1", entries_of(pkg, org_corpus(pkg, V1)),
                           changed=set(), thresholds=thresholds(pkg),
                           fraction=0.5)
            canary_engine = h.replicas["r1"].engine
            before = canary_engine.tenancy.stats.total_requests
            cohort = []
            for j in range(80):
                cfg = f"c{j % 6}"
                d = cdoc(j, V1[cfg])
                cohort.append(pkg.fleet.in_fleet_cohort(
                    pkg.fleet.routing_key(cfg, d), 0.5))
                h.check(cfg, d)
            assert any(cohort) and not all(cohort)
            served = canary_engine.tenancy.stats.total_requests - before
            assert served == sum(cohort)
            return cohort, served
        finally:
            h.shutdown()

    both(scenario)


def test_engine_fleet_fold_shape():
    """The fold contract the aggregator and process replicas share."""
    def scenario(pkg):
        engine = build_engine(pkg, org_corpus(pkg, {"ca": "org-a"}))
        serve(engine, [(cdoc(j, "org-a" if j % 2 else "org-x"), "ca")
                       for j in range(8)])
        h = engine.fleet_health()
        assert h["ready"] is True and h["draining"] is False
        assert h["breaker_open"] is False and "predicted_wait_s" in h
        f = engine.fleet_fold()
        assert f["tenants"]["ca"]["requests"] == 8
        assert f["tenants"]["ca"]["denies"] == 4
        assert f["admission_state"] in ("HEALTHY", "OVERLOADED")
        engine.drain(5.0)
        assert engine.fleet_health()["ready"] is False
        ca = f["tenants"]["ca"]
        return (sorted(f), sorted(h), f["errors"], f["slo_total"],
                f["tenant_rejects"], ca["requests"], ca["denies"],
                engine.fleet_health()["draining"])

    both(scenario)


# ---------------------------------------------------------------------------
# code lint: the fleet plane rides the unbounded-wait gate
# ---------------------------------------------------------------------------


def test_code_lint_flags_unbounded_waits_on_fleet_paths():
    """router/fleet/replica/join functions run exactly when a peer replica
    may be dead or wedged: a timeoutless wait there stalls the routing of
    the whole fleet.  The port's lint flags what the reference's does, and
    the port's fleet modules lint clean."""
    src = (
        "def router_pick(self):\n"
        "    self._evt.wait()\n"
        "def fleet_tick(self):\n"
        "    self._thread.join()\n"
        "def replica_sync(self):\n"
        "    self._evt.wait()\n"
        "async def warm_join(self):\n"
        "    await self._done.wait()\n"
        "def replica_sync_bounded(self):\n"
        "    self._evt.wait(0.5)\n"
        "def rejoin_paths(self):\n"
        "    os.path.join('a', 'b')\n"
    )
    found = p_lint.lint_source(src, "planted.py")
    assert [f.kind for f in found] == ["unbounded-wait"] * 4
    assert [f.location for f in found] == [
        "planted.py:2", "planted.py:4", "planted.py:6", "planted.py:8"]
    assert [(f.kind, f.location) for f in found] == [
        (f.kind, f.location) for f in r_lint.lint_source(src, "planted.py")]
    here = os.path.dirname(p_fleet.__file__)
    for name in ("router.py", "aggregate.py", "replica.py", "harness.py"):
        path = os.path.join(here, name)
        assert p_lint.lint_source(open(path).read(), path) == [], name
