"""The port's change safety against the JAX package's.

Canary snapshot swaps split by cohort across two generations, guard-breach
rollback, poison-config quarantine and the bounded snapshot history
(``authorino_tpu_torch/runtime/change_safety.py`` and the engine's side of
it), held to the reference's ``runtime/change_safety.py`` and engine at
tolerance 0: the cohort hash bucket for bucket, the guard's verdicts and
JSON on the same observation sequence, and each engine scenario of the
reference's ``tests/test_change_safety.py`` run through both engines (the
port's on the CPU, the plain version of its kernel) from one seeded spec,
comparing verdicts, cohorts, the generation sequence, the last rollback's
record (its times aside) and the quarantine set.  The reference test's own
assertions are checked on the port's run too.

Left out: the three scenarios that need the snapshot publisher and replica
(``snapshots/distribution.py``), which the port does not hold yet.

The port's own structure: a canary cut that holds both cohorts makes one
plain call per cohort part, each on its own generation's params; a
baseline row is never served a canary verdict from the cache, nor the
reverse; the native frontend keeps the baseline through a window and
refreshes once at promotion or rollback.  ``tests/test_torch_cuda.py``
holds the two launches to plain on the card."""

from __future__ import annotations

import asyncio
import json
import threading
import time
from types import SimpleNamespace

import grpc
import numpy as np
import pytest

import authorino_tpu.runtime.change_safety as r_cs
from authorino_tpu.runtime import EngineEntry as RefEntry
from authorino_tpu.runtime import PolicyEngine as RefEngine
from authorino_tpu.runtime.flight_recorder import RECORDER as R_RECORDER
from authorino_tpu.utils import metrics as r_metrics
import authorino_tpu_torch.runtime.change_safety as p_cs
from authorino_tpu_torch.runtime import EngineEntry, PolicyEngine
from authorino_tpu_torch.runtime.flight_recorder import RECORDER as P_RECORDER
from authorino_tpu_torch.utils import metrics as p_metrics

from test_torch_compiler import PORT as PORT_NS
from test_torch_compiler import REF as REF_NS


def ref_engine(**kw):
    return RefEngine(members_k=4, mesh=None, lane_select=False,
                     kernel_lane="fused", **kw)


def port_engine(**kw):
    return PolicyEngine(members_k=4, device="cpu", **kw)


REF = SimpleNamespace(name="ref", ns=REF_NS, cs=r_cs, Entry=RefEntry,
                      make=ref_engine, recorder=R_RECORDER,
                      metrics=r_metrics)
PORT = SimpleNamespace(name="port", ns=PORT_NS, cs=p_cs, Entry=EngineEntry,
                       make=port_engine, recorder=P_RECORDER,
                       metrics=p_metrics)


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def both_equal(scenario, *args):
    """Run ``scenario(pkg, *args)`` for each package; the observations
    must be equal.  Returns the port's."""
    want = scenario(REF, *args)
    got = scenario(PORT, *args)
    assert got == want
    return got


def org_corpus(pkg, orgs):
    """name -> org constant; each config allows exactly that org (the
    reference test's corpus, with ``pkg``'s classes)."""
    ns = pkg.ns
    return [ns.ConfigRules(name=n, evaluators=[
        (None, ns.Pattern("auth.identity.org", ns.Operator.EQ, org))])
        for n, org in orgs.items()]


def entries_of(pkg, cfgs):
    return [pkg.Entry(id=c.name, hosts=[c.name], runtime=None, rules=c)
            for c in cfgs]


def build(pkg, orgs=None, **kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("verdict_cache_size", 4096)
    engine = pkg.make(**kw)
    if orgs is not None:
        engine.apply_snapshot(entries_of(pkg, org_corpus(pkg, orgs)))
    return engine


def apply(pkg, engine, orgs):
    engine.apply_snapshot(entries_of(pkg, org_corpus(pkg, orgs)))


def cdoc(j, org):
    """Request identity varies with j — the cohort hash input."""
    return {"request": {"host": f"h{j}", "path": f"/p{j}", "method": "GET"},
            "auth": {"identity": {"org": org}}}


def docs_in_cohort(pkg, org, want, fraction, canary):
    out, j = [], 0
    while len(out) < want:
        d = cdoc(j, org)
        if pkg.cs.in_canary_cohort(d, fraction) is canary:
            out.append(d)
        j += 1
        assert j < 10000
    return out


def thresholds(pkg):
    """Unit-scale guard thresholds, the production structure."""
    return pkg.cs.GuardThresholds(min_requests=8, min_config_requests=4,
                                  min_config_allows=2)


async def _wait(pred, timeout_s=20.0, interval=0.02):
    deadline = time.monotonic() + timeout_s
    while not pred() and time.monotonic() < deadline:
        await asyncio.sleep(interval)
    return pred()


async def _submit1(engine, doc, name):
    out = await engine.submit(doc, name)
    return bool(out[0][0])


def rollback_view(lr):
    """The last rollback's record without its times (``t``, ``detect_ms``,
    ``recover_ms``) and with the guard's evidence reduced to what does not
    depend on when the rate-limited check ran."""
    if lr is None:
        return None
    out = {k: v for k, v in lr.items()
           if k not in ("t", "detect_ms", "recover_ms", "detail")}
    out["keys"] = sorted(lr)
    out["timed"] = [lr.get("detect_ms") is not None,
                    lr.get("recover_ms") is not None]
    d = lr.get("detail")
    out["suspects"] = None if d is None else d.get("suspects")
    out["config_guard"] = None if d is None else \
        "config-deny-rate" in d.get("guards", [])
    return out


def recorder_kinds(pkg):
    with pkg.recorder._ring_lock:
        return [e["kind"] for e in pkg.recorder._ring]


# ---- the module: self-test, cohort hash, guard ------------------------------


@pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])
def test_guard_self_test_is_clean(pkg):
    assert pkg.cs.guard_self_test() == []


def cohort_docs(seed, n):
    """Seeded request documents over the hash's edge cases: unicode hosts,
    a missing path (with and without ``url_path``), a missing request, a
    non-dict document and non-string fields."""
    rng = np.random.RandomState(seed)
    hosts = ["api.example.com", "ünïcödé.example", "例え.テスト", "",
             "h:8080", "🙂.emoji", "svc-{}.bench"]
    out = []
    for i in range(n):
        kind = rng.randint(8)
        host = hosts[rng.randint(len(hosts))].format(rng.randint(1000))
        method = ["GET", "POST", "DELETE", ""][rng.randint(4)]
        path = f"/p/{rng.randint(1 << 20)}/ü{rng.randint(10)}"
        if kind == 0:
            out.append({"request": {"host": host, "method": method}})
        elif kind == 1:
            out.append({"request": {"host": host, "url_path": path,
                                    "method": method}})
        elif kind == 2:
            out.append({"request": {"host": host, "path": "",
                                    "url_path": path, "method": method}})
        elif kind == 3:
            out.append({"auth": {"identity": {"org": "x"}}})
        elif kind == 4:
            out.append({"request": None})
        elif kind == 5:
            out.append(["not", "a", "dict"] if i % 2 else None)
        elif kind == 6:
            out.append({"request": {"host": rng.randint(100), "path": path,
                                    "method": method}})
        else:
            out.append({"request": {"host": host, "path": path,
                                    "method": method}})
    return out


@pytest.mark.parametrize("seed", [3, 17])
def test_cohort_bucket_equals_the_reference(seed):
    docs = cohort_docs(seed, 2500)
    got = [p_cs.cohort_bucket(d) for d in docs]
    assert got == [r_cs.cohort_bucket(d) for d in docs]
    assert len(set(got)) > 1000
    for f in (0.0, 0.01, 0.25, 0.5, 0.9999, 1.0):
        assert [p_cs.in_canary_cohort(d, f) for d in docs] == \
            [r_cs.in_canary_cohort(d, f) for d in docs]


def test_cohort_hash_is_stable_identity():
    d = cdoc(3, "org-x")
    assert p_cs.cohort_bucket(d) == p_cs.cohort_bucket(
        json.loads(json.dumps(d)))
    f = (p_cs.cohort_bucket(d) + 1) / 10000
    assert p_cs.in_canary_cohort(d, f)
    assert p_cs.in_canary_cohort(d, min(1.0, f + 0.2))


def guard_sequence(pkg, seed, changed):
    """One seeded observation sequence through ``pkg``'s guard, with an
    injected clock: every breach() answer and the final JSON."""
    rng = np.random.RandomState(seed)
    names = [f"cfg-{i}" for i in range(6)]
    heat = pkg.cs._StubHeat(names)
    th = pkg.cs.GuardThresholds(min_requests=16, min_config_requests=8,
                                min_config_allows=4, min_tenant_attempts=8)
    g = pkg.cs.CanaryGuard(th, check_interval_s=0.05,
                           changed=set(changed) if changed else None)
    now, out = 0.0, []
    poison = rng.randint(len(names))
    for step in range(120):
        now += float(rng.uniform(0.0, 0.03))
        op = rng.randint(6)
        canary = bool(rng.randint(2))
        if op <= 2:
            n = int(rng.randint(1, 24))
            rows = rng.randint(len(names), size=n)
            deny = np.where((rows == poison) & canary, 0.9, 0.15)
            firing = np.where(rng.uniform(size=n) < deny,
                              rng.randint(3, size=n), -1)
            g.observe_batch(canary, rows, firing, heat)
        elif op == 3:
            g.observe_errors(canary, int(rng.randint(0, 3)))
        elif op == 4:
            n = int(rng.randint(0, 12))
            g.observe_slo(canary, n, int(rng.randint(0, n + 1)))
        else:
            g.observe_tenant_rejection(canary, names[rng.randint(6)],
                                       int(rng.randint(0, 3)))
            g.observe_counts(canary, total=int(rng.randint(0, 5)),
                             denies=int(rng.randint(0, 2)),
                             configs={names[rng.randint(6)]: (3, 1)})
        out.append(g.breach(now=now))
    out.append(g.breach(now=now, force=True))
    return out, g.to_json()


@pytest.mark.parametrize("seed", [1, 2, 5, 11])
@pytest.mark.parametrize("changed", [None, ("cfg-1", "cfg-4")],
                         ids=["all", "changed"])
def test_guard_on_one_sequence_equals_the_reference(seed, changed):
    got = guard_sequence(PORT, seed, changed)
    assert got == guard_sequence(REF, seed, changed)
    json.dumps(got)


def test_all_error_canary_breaches_error_guard():
    def scenario(pkg):
        heat = pkg.cs._StubHeat(["cfg"])
        g = pkg.cs.CanaryGuard(thresholds=thresholds(pkg),
                               check_interval_s=0.0)
        pkg.cs._feed(g, False, heat, 0, 64, 0.0)
        g.observe_errors(True, 64)
        return g.breach(), g.to_json()

    b, _ = both_equal(scenario)
    assert b is not None and "error-rate" in b["guards"]


def test_conclude_breach_evaluation_bypasses_rate_limit():
    def scenario(pkg):
        heat = pkg.cs._StubHeat(["cfg"])
        g = pkg.cs.CanaryGuard(thresholds=thresholds(pkg),
                               check_interval_s=3600.0)
        first = g.breach()
        pkg.cs._feed(g, False, heat, 0, 64, 0.0)
        pkg.cs._feed(g, True, heat, 0, 64, 1.0)
        return first, g.breach(), g.breach(force=True)

    first, limited, forced = both_equal(scenario)
    assert first is None and limited is None
    assert forced is not None and "cfg" in forced["suspects"]


def test_guard_close_zeros_delta_gauges():
    def scenario(pkg):
        heat = pkg.cs._StubHeat(["cfg"])
        g = pkg.cs.CanaryGuard(thresholds=thresholds(pkg),
                               check_interval_s=0.0)
        pkg.cs._feed(g, False, heat, 0, 64, 0.0)
        pkg.cs._feed(g, True, heat, 0, 64, 1.0)
        breached = g.breach() is not None
        gauge = pkg.metrics.canary_guard_delta.labels("deny-rate")
        live = gauge._value.get()
        g.close()
        return breached, live, gauge._value.get()

    breached, live, closed = both_equal(scenario)
    assert breached and live > 0 and closed == 0.0


# ---- the engine scenarios ---------------------------------------------------


def poison_scenario(pkg):
    fraction = 0.5
    v1 = {"c-poison": "org-p", "c-clean": "org-c", "c-benign": "org-b"}
    engine = build(pkg, v1, canary_fraction=fraction, canary_window_s=30.0,
                   canary_thresholds=thresholds(pkg), verdict_cache_size=0,
                   batch_dedup=False)
    pc = docs_in_cohort(pkg, "org-p", 6, fraction, canary=True)
    pb = docs_in_cohort(pkg, "org-p", 6, fraction, canary=False)
    cc = docs_in_cohort(pkg, "org-c", 4, fraction, canary=True)
    cb = docs_in_cohort(pkg, "org-c", 4, fraction, canary=False)

    async def pump():
        outs = await asyncio.gather(
            *[engine.submit(dict(d), "c-poison") for d in pc + pb],
            *[engine.submit(dict(d), "c-clean") for d in cc + cb])
        return [bool(o[0][0]) for o in outs]

    obs = {"cohorts": [pkg.cs.in_canary_cohort(d, fraction)
                       for d in pc + pb + cc + cb],
           "warm": run(pump())}
    v2 = {"c-poison": "org-NEVER", "c-clean": "org-c", "c-benign": "org-b2"}
    apply(pkg, engine, v2)
    phase = engine._canary
    obs["canary"] = (phase is not None and phase.snap.generation,
                     phase is not None and phase.baseline.generation,
                     sorted(phase.guard.changed) if phase else None)

    async def drive_until_rollback():
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            await pump()
            # the port re-applies the quarantine on its encode pool: wait
            # for the re-apply to have swapped (its recovery time is set)
            if engine._canary is None and engine.quarantine_active and \
                    "recover_ms" in (engine._last_rollback or {}):
                return True
        return False

    obs["rolled_back"] = run(drive_until_rollback())
    obs["rollback"] = rollback_view(engine._last_rollback)
    obs["quarantine"] = engine._quarantine["configs"]
    obs["quarantine_vars"] = {
        k: v for k, v in engine.change_safety_vars()["quarantine"].items()
        if k != "since"}
    kinds = recorder_kinds(pkg)
    obs["recorded"] = ["snapshot-rollback" in kinds, "quarantine" in kinds]
    obs["generation"] = engine.generation
    obs["serving_change_safety"] = engine._snapshot.change_safety

    async def verdicts():
        return [await _submit1(engine, cdoc(1, "org-p"), "c-poison"),
                await _submit1(engine, cdoc(2, "org-b2"), "c-benign"),
                await _submit1(engine, cdoc(3, "org-b"), "c-benign"),
                await _submit1(engine, cdoc(4, "org-c"), "c-clean")]

    obs["after"] = run(verdicts())
    apply(pkg, engine, v2)     # the same poison spec resyncing
    obs["resync"] = (engine._canary is None, engine.quarantine_active,
                     run(_submit1(engine, cdoc(5, "org-p"), "c-poison")),
                     engine.generation)
    v3 = {"c-poison": "org-p2", "c-clean": "org-c", "c-benign": "org-b2"}
    apply(pkg, engine, v3)     # a fixed spec
    obs["fixed"] = [engine.quarantine_active, engine._canary is not None]
    if engine._canary is not None:
        obs["fixed"].append(engine.canary_promote())
    obs["fixed"].append(run(_submit1(engine, cdoc(6, "org-p2"), "c-poison")))
    obs["history"] = engine.change_safety_vars()["history_generations"]
    obs["end_generation"] = engine.generation
    return obs


def test_poison_breach_rolls_back_quarantines_and_releases():
    obs = both_equal(poison_scenario)
    assert obs["warm"] == [True] * 20
    assert obs["canary"][0] == 2 and obs["canary"][1] == 1
    assert obs["canary"][2] == ["c-benign", "c-poison"]
    assert obs["rolled_back"]
    lr = obs["rollback"]
    assert lr["reason"] == "guard-breach" and lr["timed"] == [True, True]
    assert lr["quarantined"] == ["c-poison"] and "c-poison" in lr["suspects"]
    assert sorted(obs["quarantine"]) == ["c-poison"]
    assert obs["recorded"] == [True, True]
    # canary 2, rollback 3, quarantine re-apply 4
    assert (lr["from_generation"], lr["to_generation"]) == (2, 3)
    assert obs["generation"] == 4
    assert obs["serving_change_safety"]["quarantine"]["configs"] == \
        ["c-poison"]
    assert obs["after"] == [True, True, False, True]
    assert obs["resync"][:3] == (True, True, True)
    assert obs["fixed"][0] is False and obs["fixed"][-1] is True
    assert obs["end_generation"] > obs["resync"][3]


def new_poison_scenario(pkg):
    fraction = 0.5
    engine = build(pkg, {"c-base": "org-a"}, canary_fraction=fraction,
                   canary_window_s=30.0, canary_thresholds=thresholds(pkg),
                   verdict_cache_size=0, batch_dedup=False)
    v2 = {"c-base": "org-a", "c-new": "org-NEVER"}
    apply(pkg, engine, v2)
    obs = {"canary": engine._canary is not None}
    base_docs = docs_in_cohort(pkg, "org-a", 10, fraction, canary=False)
    new_docs = docs_in_cohort(pkg, "org-a", 6, fraction, canary=True)

    async def drive():
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            await asyncio.gather(
                *[engine.submit(dict(d), "c-base") for d in base_docs],
                *[engine.submit(dict(d), "c-new") for d in new_docs])
            if engine._canary is None and engine.quarantine_active:
                return True
        return False

    obs["rolled_back"] = run(drive())
    obs["rollback"] = rollback_view(engine._last_rollback)
    obs["quarantine"] = engine._quarantine["configs"]
    apply(pkg, engine, v2)
    obs["resync"] = (engine._canary is None, engine.quarantine_active,
                     run(_submit1(engine, cdoc(0, "org-a"), "c-base")))
    apply(pkg, engine, {"c-base": "org-a", "c-new": "org-ok"})
    obs["fixed"] = [engine.quarantine_active]
    if engine._canary is not None:
        obs["fixed"].append(engine.canary_promote())
    obs["fixed"].append(run(_submit1(engine, cdoc(1, "org-ok"), "c-new")))
    obs["generation"] = engine.generation
    return obs


def test_new_poison_config_quarantines_out_and_persists():
    obs = both_equal(new_poison_scenario)
    assert obs["canary"] and obs["rolled_back"]
    assert obs["rollback"]["reason"] == "guard-breach"
    assert obs["rollback"]["quarantined"] == ["c-new"]
    assert sorted(obs["quarantine"]) == ["c-new"]
    assert obs["quarantine"]["c-new"]["prior"] is None
    assert obs["resync"] == (True, True, True)
    assert obs["fixed"][0] is False and obs["fixed"][-1] is True


def quarantined_submit_scenario(pkg):
    """A submit to a config the serving snapshot lacks: one a guard-breach
    quarantine has just removed, and one never compiled, each in a cut
    beside a known config's row.  The reference queues both and its encode
    job answers them; no wall clock decides when the quarantine lands."""
    engine = build(pkg, {"c-base": "org-a"}, canary_fraction=0.5,
                   canary_window_s=30.0, canary_thresholds=thresholds(pkg),
                   verdict_cache_size=0, batch_dedup=False)
    apply(pkg, engine, {"c-base": "org-a", "c-new": "org-NEVER"})
    engine._canary_rollback(engine._canary, reason="guard-breach",
                            detail={"suspects": ["c-new"]})

    def view(o):
        if isinstance(o, BaseException):
            return (type(o).__name__, getattr(o, "code", None), str(o))
        return bool(o[0][0])

    async def burst():
        out = await asyncio.gather(
            engine.submit(cdoc(0, "org-a"), "c-base"),
            engine.submit(cdoc(1, "org-a"), "c-new"),
            engine.submit(cdoc(2, "org-a"), "c-unknown"),
            engine.submit(cdoc(3, "org-b"), "c-base"),
            return_exceptions=True)
        return [view(o) for o in out]

    obs = {"quarantine": sorted(engine._quarantine["configs"]),
           "first": run(burst()), "second": run(burst()),
           "breaker": engine.breaker.state,
           "generation": engine.generation}
    return obs


def test_submit_to_a_quarantined_out_config_answers_as_reference():
    obs = both_equal(quarantined_submit_scenario)
    assert obs["quarantine"] == ["c-new"]
    unavailable = ("CheckAbort", grpc.StatusCode.UNAVAILABLE.value[0],
                   "policy evaluation unavailable")
    for burst in (obs["first"], obs["second"]):
        assert burst == [True, unavailable, unavailable, False]


def added_config_scenario(pkg):
    fraction = 0.5
    engine = build(pkg, {"c": "org-a"}, canary_fraction=fraction,
                   canary_window_s=30.0, canary_thresholds=thresholds(pkg))
    apply(pkg, engine, {"c": "org-a", "n": "org-n"})
    obs = {"canary": engine._canary is not None}
    docs = docs_in_cohort(pkg, "org-n", 3, fraction, canary=False) + \
        docs_in_cohort(pkg, "org-n", 3, fraction, canary=True)

    async def body():
        outs = await asyncio.gather(
            *[engine.submit(dict(d), "n") for d in docs])
        return [bool(o[0][0]) for o in outs]

    obs["both_cohorts"] = run(body())
    obs["exact"] = run(_submit1(engine, cdoc(0, "org-x"), "n"))
    obs["still"] = (engine._canary is not None, engine._last_rollback)
    obs["lookup"] = [engine.lookup(h) is not None for h in ("c", "n")]
    return obs


def test_added_config_serves_both_cohorts_mid_canary():
    obs = both_equal(added_config_scenario)
    assert obs["canary"] and obs["both_cohorts"] == [True] * 6
    assert obs["exact"] is False
    assert obs["still"] == (True, None)
    assert obs["lookup"] == [True, True]


def drain_scenario(pkg):
    engine = build(pkg, {"c": "org-a"}, canary_fraction=0.5,
                   canary_window_s=0.25, canary_thresholds=thresholds(pkg))
    apply(pkg, engine, {"c": "org-b"})
    started = engine._canary is not None
    fired = []
    engine.add_swap_listener(lambda: fired.append(1))
    engine.begin_drain()
    time.sleep(0.6)
    return started, engine._canary is not None, fired, engine.generation


def test_drain_cancels_canary_window_timer():
    assert both_equal(drain_scenario) == (True, True, [], 2)


def clean_promotion_scenario(pkg):
    engine = build(pkg, {"c": "org-a"}, canary_fraction=0.25,
                   canary_window_s=0.3, canary_thresholds=thresholds(pkg))
    apply(pkg, engine, {"c": "org-a2"})
    gen_candidate = engine._canary.snap.generation
    promoted = run(_wait(lambda: engine._canary is None, timeout_s=10))
    return (promoted, engine._last_rollback, engine._snapshot.generation,
            gen_candidate, run(_submit1(engine, cdoc(0, "org-a2"), "c")),
            run(_submit1(engine, cdoc(1, "org-a"), "c")),
            engine.change_safety_vars()["history_generations"])


def test_clean_canary_promotes_at_window_end():
    promoted, lr, serving, candidate, new_ok, old_ok, history = \
        both_equal(clean_promotion_scenario)
    assert promoted and lr is None and serving == candidate == 2
    assert new_ok and not old_ok and history == [1]


def identical_resync_scenario(pkg):
    engine = build(pkg, {"c": "org-a"}, canary_fraction=0.5,
                   canary_window_s=30.0)
    apply(pkg, engine, {"c": "org-a"})
    return engine._canary is None, engine.generation


def test_identical_resync_swaps_straight_through():
    assert both_equal(identical_resync_scenario) == (True, 2)


def supersede_scenario(pkg):
    engine = build(pkg, {"c": "org-a"}, canary_fraction=0.5,
                   canary_window_s=30.0, canary_thresholds=thresholds(pkg))
    apply(pkg, engine, {"c": "org-b"})
    first = engine._canary
    apply(pkg, engine, {"c": "org-c"})
    second = engine._canary
    obs = [first is not None, rollback_view(engine._last_rollback),
           engine.quarantine_active, second is not None and second
           is not first, second.snap.generation, second.baseline.generation,
           engine.canary_promote(),
           run(_submit1(engine, cdoc(0, "org-c"), "c")),
           run(_submit1(engine, cdoc(1, "org-b"), "c")), engine.generation]
    engine.canary_rollback()   # no canary: the newest history generation
    obs.append(run(_submit1(engine, cdoc(2, "org-a"), "c")))
    obs.append(engine.generation)
    return obs


def test_reconcile_mid_canary_supersedes():
    obs = both_equal(supersede_scenario)
    assert obs[0] and obs[1]["reason"] == "superseded"
    assert obs[1]["quarantined"] == [] and obs[2] is False and obs[3]
    assert obs[4:10] == [4, 3, True, True, False, 4]
    assert obs[10:] == [True, 5]


class GatedHandle:
    """A readback handle held back until ``gate`` opens (both packages'
    completers: ``is_ready``/``wait`` and ``__array__``)."""

    def __init__(self, inner, gate):
        self.inner = inner
        self.gate = gate

    def is_ready(self):
        return self.gate.is_set() and (
            not hasattr(self.inner, "is_ready") or self.inner.is_ready())

    def wait(self):
        return self.inner.wait()

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.inner)


def inflight_rollback_scenario(pkg):
    engine = build(pkg, {"c": "org-a"}, canary_fraction=1.0,
                   canary_window_s=30.0, canary_thresholds=thresholds(pkg))
    run(_submit1(engine, cdoc(9, "org-a"), "c"))
    apply(pkg, engine, {"c": "org-b"})
    phase = engine._canary
    gate = threading.Event()
    cls = type(engine)
    real = cls._encode_and_launch
    gated_launches = []

    def gated(snap, batch):
        item = real(engine, snap, batch)
        item.handle = GatedHandle(item.handle, gate)
        gated_launches.append(snap)
        return item

    engine._encode_and_launch = gated
    obs = {}

    async def body():
        d = cdoc(42, "org-a")   # the canary denies, the baseline allows
        fut = asyncio.ensure_future(engine.submit(dict(d), "c"))
        assert await _wait(lambda: bool(gated_launches), timeout_s=5)
        engine._encode_and_launch = real.__get__(engine, cls)
        obs["rode_canary"] = gated_launches[0] is phase.snap
        obs["rolled_back"] = engine.canary_rollback()
        obs["canary_after"] = engine._canary is None
        adds0 = engine._verdict_cache.adds
        gate.set()
        out = await asyncio.wait_for(fut, timeout=10)
        obs["pinned_verdict"] = bool(out[0][0])
        obs["late_insert"] = engine._verdict_cache.adds > adds0
        obs["baseline_verdict"] = bool((await engine.submit(dict(d), "c"))
                                       [0][0])

    run(body())
    obs["rollback"] = rollback_view(engine._last_rollback)
    return obs


def test_inflight_canary_batch_resolves_across_rollback():
    obs = both_equal(inflight_rollback_scenario)
    assert obs["rode_canary"] and obs["rolled_back"] and obs["canary_after"]
    assert obs["pinned_verdict"] is False and obs["late_insert"]
    assert obs["baseline_verdict"] is True
    assert obs["rollback"]["manual"] is True


def torn_generation_scenario(pkg):
    fraction = 0.5
    engine = build(pkg, {"c": "org-a"}, canary_fraction=fraction,
                   canary_window_s=30.0, canary_thresholds=thresholds(pkg),
                   verdict_cache_size=0, batch_dedup=False)
    apply(pkg, engine, {"c": "org-b"})
    docs = docs_in_cohort(pkg, "org-b", 12, fraction, canary=True)

    async def body():
        stop = asyncio.Event()
        results = []

        async def storm():
            while not stop.is_set():
                outs = await asyncio.gather(
                    *[engine.submit(dict(d), "c") for d in docs])
                results.extend(bool(o[0][0]) for o in outs)

        task = asyncio.ensure_future(storm())
        await asyncio.sleep(0.15)
        loop = asyncio.get_running_loop()
        promoted = await loop.run_in_executor(None, engine.canary_promote)
        await asyncio.sleep(0.15)
        stop.set()
        await task
        return promoted, results

    promoted, results = run(body())
    return (promoted, len(results) >= 12, all(results),
            engine._canary is None, engine.generation)


def test_canary_cohort_never_observes_torn_generation():
    assert both_equal(torn_generation_scenario) == (True, True, True, True, 2)


def history_scenario(pkg):
    engine = build(pkg, {"c": "org-v1"}, snapshot_history=2)
    for v in ("org-v2", "org-v3", "org-v4"):
        apply(pkg, engine, {"c": v})
    obs = [engine.change_safety_vars()["history_generations"],
           engine.canary_rollback(),
           run(_submit1(engine, cdoc(0, "org-v3"), "c")),
           engine.rollback_last(),
           run(_submit1(engine, cdoc(1, "org-v2"), "c")),
           run(_submit1(engine, cdoc(2, "org-v4"), "c")),
           engine.rollback_last(), engine.generation,
           rollback_view(engine.change_safety_vars()["last_rollback"]),
           engine._snapshot.change_safety]
    return obs


def test_manual_rollback_walks_bounded_history():
    obs = both_equal(history_scenario)
    assert obs[:8] == [[2, 3], True, True, True, True, False, False, 6]
    assert obs[8]["manual"] is True
    assert obs[9] == {"rollback": {"from_generation": 5,
                                   "reason": "manual"}}


def vars_scenario(pkg):
    engine = build(pkg, {"c": "org-a"}, canary_fraction=0.5,
                   canary_window_s=30.0)
    apply(pkg, engine, {"c": "org-b"})
    v1 = json.loads(json.dumps(engine.change_safety_vars()))
    for k in ("age_s", "started_unix", "kernel_cost"):
        v1["canary"].pop(k)
    promoted = engine.canary_promote()
    v2 = json.loads(json.dumps(engine.change_safety_vars()))
    dv = engine.debug_vars()["change_safety"]
    return v1, promoted, v2, dv == v2


def test_change_safety_vars_json_safe():
    v1, promoted, v2, same = both_equal(vars_scenario)
    assert v1["canary"]["fraction"] == 0.5 and promoted and same
    assert v2["canary"] is None and v2["history_generations"] == [1]


def test_flight_recorder_disk_retention_bounded(tmp_path):
    """The rollback's bundle is an anomaly dump; the port's recorder keeps
    the newest ``keep`` bundles on disk, as the reference's does."""
    import os

    from authorino_tpu_torch.runtime.flight_recorder import FlightRecorder

    fr = FlightRecorder(capacity=64, dump_dir=str(tmp_path),
                        min_dump_interval_s=0.0, keep=3)
    for i in range(7):
        fr.dump(f"trigger-{i}")
        time.sleep(0.01)
    names = [n for n in os.listdir(str(tmp_path))
             if n.startswith("flight-") and n.endswith(".json")]
    assert len(names) == 3
    assert any("trigger-6" in n for n in names)
    assert not any("trigger-0" in n for n in names)


# ---- the port's structure: parts, the cache, the frontend -------------------


def test_plain_calls_count_cohort_parts():
    """A canary cut holding both cohorts makes one plain call per part,
    each on its own generation's params, and counts two batch records and
    two ledger launches; a cut of one cohort makes one."""
    from authorino_tpu_torch.runtime.kernel_cost import LEDGER

    fraction = 0.5
    engine = build(PORT, {"c": "org-a", "d": "org-d"}, max_batch=64,
                   canary_fraction=fraction, canary_window_s=30.0,
                   canary_thresholds=thresholds(PORT), verdict_cache_size=0,
                   batch_dedup=False)
    apply(PORT, engine, {"c": "org-b", "d": "org-d"})
    phase = engine._canary
    canary = docs_in_cohort(PORT, "org-b", 5, fraction, canary=True)
    base = docs_in_cohort(PORT, "org-b", 7, fraction, canary=False)
    seen = []
    real = engine._encode_and_launch

    def spy(snap, batch):
        seen.append((snap, sorted(p.canary for p in batch)))
        return real(snap, batch)

    engine._encode_and_launch = spy
    stats0 = dict(engine.stats)
    launches0 = LEDGER.snapshot("engine")["launches"]
    n_rec = len(engine.batch_records)

    async def burst(docs):
        outs = await asyncio.gather(*[engine.submit(dict(d), "c")
                                      for d in docs])
        return [bool(o[0][0]) for o in outs]

    mixed = run(burst(canary + base))
    assert mixed == [True] * 5 + [False] * 7
    by_snap = {id(s): flags for s, flags in seen}
    assert by_snap == {id(phase.snap): [True] * 5,
                       id(phase.baseline): [False] * 7}
    recs = list(engine.batch_records)[n_rec:]
    assert sorted((r["generation"], r["rows"], r["plain_calls"])
                  for r in recs) == [(1, 7, 1), (2, 5, 1)]
    assert engine.stats["plain_calls"] - stats0["plain_calls"] == 2
    assert engine.stats["batches"] - stats0["batches"] == 2
    assert LEDGER.snapshot("engine")["launches"] - launches0 == 2
    seen.clear()
    assert run(burst(canary)) == [True] * 5
    assert [flags for _, flags in seen] == [[True] * 5]
    assert engine.stats["plain_calls"] - stats0["plain_calls"] == 3
    assert engine._canary is phase


def test_cache_never_crosses_cohorts():
    """The verdict cache keys a row by its config's token per generation:
    a canary-cohort row of a changed config never reads the baseline's
    entry for the same row bytes, nor the reverse, while a repeat within a
    cohort is a cache hit."""
    fraction = 0.5
    engine = build(PORT, {"c": "org-a", "u": "org-u"}, max_batch=8,
                   canary_fraction=fraction, canary_window_s=30.0,
                   canary_thresholds=thresholds(PORT), batch_dedup=False)
    # same org (so the same row bytes), different cohorts
    c_docs = docs_in_cohort(PORT, "org-a", 3, fraction, canary=True)
    b_docs = docs_in_cohort(PORT, "org-a", 3, fraction, canary=False)
    run(_submit1(engine, dict(b_docs[0]), "c"))   # a baseline entry
    apply(PORT, engine, {"c": "org-b", "u": "org-u"})
    assert engine._canary is not None

    def one(d, name="c"):
        hits0 = engine.stats["cache_rows"]
        allowed = run(_submit1(engine, dict(d), name))
        return allowed, engine.stats["cache_rows"] - hits0

    # the baseline entry from before the canary: a baseline hit, never
    # served to the canary cohort
    assert one(b_docs[1]) == (True, 1)
    assert one(c_docs[0]) == (False, 0)
    assert one(c_docs[1]) == (False, 1)   # the canary's own entry
    assert one(b_docs[2]) == (True, 1)
    # an unchanged config shares its token: one entry serves both cohorts
    u_c = docs_in_cohort(PORT, "org-u", 1, fraction, canary=True)[0]
    u_b = docs_in_cohort(PORT, "org-u", 1, fraction, canary=False)[0]
    assert one(u_c, "u") == (True, 0)
    assert one(u_b, "u") == (True, 1)
    # and after promotion the canary's entries serve everyone
    assert engine.canary_promote()
    assert one(b_docs[0]) == (False, 1)


def frontend_refresh_scenario(start_frontend):
    """A native frontend attached to a canarying engine: no refresh during
    the window, one at promotion, one at rollback; its fast-lane folds
    feed the guard's baseline cohort."""
    from authorino_tpu_torch.models import wire_corpus

    engine = port_engine(max_batch=16, canary_fraction=0.5,
                         canary_window_s=30.0,
                         canary_thresholds=thresholds(PORT))
    entries = wire_corpus.build_wire_entries(5, 3, engine)
    engine.apply_snapshot(entries[:4])
    fe, port = start_frontend(engine)
    try:
        snap_id = lambda: fe.debug_vars()["snapshot"]["snap_id"]
        ids = [snap_id()]
        engine.apply_snapshot(entries)          # a config added: canary
        phase = engine._canary
        assert phase is not None
        ids.append(snap_id())
        payloads = wire_corpus.wire_payloads(32, 4)
        with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            call = ch.unary_unary(
                "/envoy.service.auth.v3.Authorization/Check",
                request_serializer=lambda b: b,
                response_deserializer=lambda b: b)
            for p in payloads:
                call(p, timeout=30)
            added = call(wire_corpus.wire_payloads(5, 5)[4], timeout=30)
        fed = phase.guard.to_json()["baseline"]["requests"]
        vars_canary = fe.debug_vars()["change_safety"]["canary"]
        ids.append(snap_id())
        assert engine.canary_promote()
        ids.append(snap_id())
        engine.apply_snapshot(entries[:4])      # a config removed: canary
        ids.append(snap_id())
        assert engine.canary_rollback()
        ids.append(snap_id())
        return ids, fed, vars_canary is not None, len(added) > 0, \
            fe.stats()["fast"]
    finally:
        fe.stop()


def test_native_frontend_holds_the_baseline_and_refreshes_once():
    from authorino_tpu_torch.runtime import native_frontend as port_nf

    def start(engine):
        fe = port_nf.NativeFrontend(engine, port=0, max_batch=16,
                                    window_us=500)
        return fe, fe.start()

    ids, fed, has_vars, answered, fast = frontend_refresh_scenario(start)
    assert ids[1:3] == [ids[0]] * 2          # no refresh in the window
    assert ids[3] == ids[0] + 1              # one at promotion
    assert ids[4] == ids[3]                  # none at the next canary
    assert ids[5] == ids[3] + 1              # one at rollback
    assert fed >= 32 and fast >= 32 and has_vars and answered


# ---- the reconciler's quarantine status -------------------------------------


def quarantine_status_scenario(p):
    from test_torch_control_plane import resource, statuses
    from test_torch_pipeline import engine_of

    def spec(method):
        return {"hosts": ["q.example.com"],
                "authentication": {"anon": {"anonymous": {}}},
                "authorization": {"r": {"patternMatching": {"patterns": [
                    {"selector": "request.method", "operator": "eq",
                     "value": method}]}}}}

    async def body():
        engine = engine_of(p.ns, max_batch=4, canary_fraction=0.5,
                           canary_window_s=30.0)
        rec = p.rec.AuthConfigReconciler(engine)
        await rec.reconcile_all([resource(spec=spec("GET"))])
        await rec.reconcile_all([resource(spec=spec("POST"))])
        phase = engine._canary
        await asyncio.to_thread(
            engine._canary_rollback, phase, "guard-breach",
            {"suspects": ["tenant/ac"], "guards": ["config-deny-rate"]})
        await rec.reconcile_all([resource(spec=spec("POST"))])
        return (statuses(rec), engine.quarantine_active,
                sorted(engine._quarantine["configs"]))

    return run(body())


def test_reconciler_quarantine_status_equals_the_reference():
    from test_torch_control_plane import BOTH

    want, got = (quarantine_status_scenario(p) for p in BOTH)
    assert got == want
    st, active, configs = got
    assert active and configs == ["tenant/ac"]
    assert st["tenant/ac"][0] == "Reconciled"
    assert st["tenant/ac"][1].startswith(
        "quarantined after canary guard breach")
