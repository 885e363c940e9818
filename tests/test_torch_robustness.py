"""The port's failure handling against the JAX package's
(``tests/test_robustness.py``): the injectable fault plane, the device
circuit breaker with half-open probing, and the engine's retry, then the
host-oracle degrade (a CPU engine) or the typed UNAVAILABLE (a card).

- ``TestFaultPlane``: the reference's cases on the port's plane, and both
  planes armed with the same spec and seed give equal ``describe()``,
  equal firing sequences and rng draws, and equal fs crash shapes on disk;
- ``TestCircuitBreaker``: the reference's cases on the port's breaker, the
  same scripted outcomes through both breakers give equal trails, and a
  transition records a flight event (entering OPEN writes a bundle);
- ``TestEngineDegradation``: each case (transient, persistent, flap,
  membership overflow, watchdog, seeded flaky, no snapshot) runs a CPU
  engine of each package — the reference's with ``lane_select=False,
  brownout=False, speculative_dispatch=False`` — under the same spec and
  seed on the same docs; verdicts, skipped bits, heat-map counts, degraded
  counts (the metric and the ledger's ``host`` lane), retries, watchdog
  timeouts and breaker transitions are equal, tolerance 0;
- a card engine (a stub device) answers a batch it could not decide with
  the typed UNAVAILABLE, never through the host oracle or the kernel's
  plain version, and an undecided batch resolves whatever raises while it
  is ended;
- ``/readyz`` surfaces the drain and the degraded circuit as the
  reference's does.

Both packages record into one Prometheus registry here, so every metric
is read as a delta around one package's run."""

import asyncio
import errno
import os
import time

import numpy as np
import pytest
import torch
from prometheus_client import REGISTRY

from authorino_tpu.runtime import EngineEntry as RefEntry
from authorino_tpu.runtime import PolicyEngine as RefEngine
from authorino_tpu.runtime import faults as ref_faults
from authorino_tpu.runtime.breaker import CircuitBreaker as RefBreaker
from authorino_tpu.runtime.kernel_cost import LEDGER as REF_LEDGER
from authorino_tpu_torch.ops import fused_kernel as p_fk
from authorino_tpu_torch.ops.operands import packed_width
from authorino_tpu_torch.runtime import EngineEntry, PolicyEngine
from authorino_tpu_torch.runtime import engine as engine_mod
from authorino_tpu_torch.runtime import faults
from authorino_tpu_torch.runtime import flight_recorder as port_fr
from authorino_tpu_torch.runtime.breaker import CircuitBreaker
from authorino_tpu_torch.runtime.kernel_cost import LEDGER
from authorino_tpu_torch.utils import atomicio
from authorino_tpu_torch.utils.rpc import UNAVAILABLE, CheckAbort

from test_torch_compiler import PORT, REF
from test_torch_dispatch import wait_until_sync
from test_torch_provenance import heat_counts

PLANES = {id(REF): ref_faults, id(PORT): faults}


@pytest.fixture(autouse=True)
def _disarm_faults():
    """Every test leaves both packages' fault planes OFF."""
    yield
    faults.FAULTS.disarm()
    ref_faults.FAULTS.disarm()


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def sample(name, labels=None):
    v = REGISTRY.get_sample_value(name, labels or {})
    return 0.0 if v is None else v


# ---- the corpus: one config, a plain evaluator and a conditional one -------

def rules_of(ns):
    rule = ns.All(
        ns.Pattern("auth.identity.roles", ns.Operator.INCL, "admin"),
        ns.Pattern("auth.identity.groups", ns.Operator.EXCL, "banned"))
    cond = ns.Pattern("auth.identity.groups", ns.Operator.INCL, "staff")
    rule2 = ns.Pattern("auth.identity.roles", ns.Operator.INCL, "writer")
    return ns.ConfigRules(name="c", evaluators=[(None, rule), (cond, rule2)])


def engine_of(ns, **kw):
    # verdict cache off by default: a cached verdict skips the device, which
    # would mask whether a fault path ran
    kw.setdefault("verdict_cache_size", 0)
    kw.setdefault("max_batch", 8)
    if ns is REF:
        engine = RefEngine(members_k=4, mesh=None, lane_select=False,
                           brownout=False, speculative_dispatch=False, **kw)
        engine.apply_snapshot([RefEntry(id="c", hosts=["c"], runtime=None,
                                        rules=rules_of(REF))])
    else:
        engine = PolicyEngine(members_k=4, device="cpu", lane_select=False,
                              brownout=False, speculative_dispatch=False,
                              **kw)
        engine.apply_snapshot([EngineEntry(id="c", hosts=["c"],
                                           rules=rules_of(PORT))])
    return engine


def doc(i: int, allow: bool) -> dict:
    # per-index distinct docs, so no two rows dedup-collapse; every third
    # is staff (its second evaluator is not skipped), every fourth a writer
    roles = ["admin", f"r{i}"] if allow else [f"r{i}"]
    if i % 4 == 0:
        roles.append("writer")
    return {"auth": {"identity": {
        "roles": roles, "groups": ["staff"] if i % 3 == 0 else []}}}


async def submit_all(engine, docs):
    return list(await asyncio.gather(*(engine.submit(d, "c") for d in docs)))


async def staggered(engine, docs):
    out = []
    for d in docs:  # sequential: one batch each
        out.append(await engine.submit(d, "c"))
    return out


def bits(results):
    return [(np.asarray(r).tolist(), np.asarray(s).tolist())
            for r, s in results]


def decided(results):
    """Per row, each evaluator's skipped bit and, where it was not skipped,
    its rule bit: what a verdict reads.  (The rule bit of a skipped
    evaluator is free: the kernel writes False there, the oracle True.)"""
    return [[(s, None if s else r) for r, s in zip(rule, skipped)]
            for rule, skipped in results]


def oracle(docs):
    """The expression oracle's decisions per doc, as ``decided`` reads
    them."""
    from authorino_tpu_torch.compiler import compile_corpus
    from authorino_tpu_torch.models.policy_model import host_results

    policy = compile_corpus([rules_of(PORT)], members_k=4)
    out = []
    for d in docs:
        _, rule, skipped = host_results(policy, d, 0)
        out.append((rule.tolist(), skipped.tolist()))
    return decided(out)


COUNTERS = ("auth_server_degraded_decisions_total",
            "auth_server_batch_retries_total",
            "auth_server_device_watchdog_timeouts_total")


def counters():
    lab = {"lane": "engine"}
    return {n: sample(n, lab) for n in COUNTERS}


def run_case(ns, scenario, spec=None, seed=1234, **kw):
    """One package's run of ``scenario(engine, plane)`` under ``spec``:
    what the scenario observed, plus the metric deltas, the ledger's
    host-lane rows, the heat-map counts and the breaker's trail."""
    plane = PLANES[id(ns)]
    ledger = REF_LEDGER if ns is REF else LEDGER
    engine = engine_of(ns, **kw)
    c0, h0 = counters(), ledger.snapshot("host")["rows"]
    if spec:
        plane.FAULTS.arm(spec, seed=seed)
    try:
        obs = scenario(engine, plane)
    finally:
        fired = dict(plane.FAULTS.fired)
        plane.FAULTS.disarm()
    assert wait_until_sync(lambda: engine._inflight == 0)
    c1 = counters()
    out = dict(obs)
    out.update({n: c1[n] - c0[n] for n in COUNTERS})
    out["host_rows"] = ledger.snapshot("host")["rows"] - h0
    out["heat"] = heat_counts(engine._snapshot.heat)
    out["transitions"] = [(t["state"], t["reason"])
                          for t in engine.breaker.transitions]
    out["fired"] = fired
    return out, engine


def both(scenario, spec=None, seed=1234, **kw):
    """The scenario on the reference engine, then on the port's; returns
    the port's observations and engine after holding them equal."""
    want, _ = run_case(REF, scenario, spec, seed, **kw)
    got, engine = run_case(PORT, scenario, spec, seed, **kw)
    assert got == want
    # the port counts every degraded row in its stats, the ledger's host
    # lane and its batch records, as the metric does
    degraded = got["auth_server_degraded_decisions_total"]
    st = engine.stats
    assert st["degraded_rows"] == degraded == got["host_rows"]
    recs = [r for r in engine.batch_records if "degraded" in r]
    assert sum(r["degraded_rows"] for r in recs) == degraded
    assert all(r["launches"] == r["plain_calls"] == 0 for r in recs)
    for r in engine.batch_records:
        assert r["rows"] == (r["device_rows"] + r["dedup_rows"]
                             + r["cache_rows"] + r["degraded_rows"])
    assert st["retries"] == got["auth_server_batch_retries_total"]
    assert st["watchdog_timeouts"] == \
        got["auth_server_device_watchdog_timeouts_total"]
    return got, engine


# ---------------------------------------------------------------------------
# fault plane
# ---------------------------------------------------------------------------


class TestFaultPlane:
    def test_off_by_default_and_zero_cost_gate(self):
        faults.FAULTS.disarm()
        assert faults.ACTIVE is False
        assert faults.FAULTS.describe()["armed"] is False

    def test_profile_expansion_and_spec_keys(self):
        faults.FAULTS.arm("device-down")
        d = faults.FAULTS.describe()
        assert d["armed"] and d["rules"] == ["kernel:raise"]
        faults.FAULTS.arm("kernel:delay:delay_ms=20:p=0.5:n=3:lane=native")
        r = faults.FAULTS._rules[0]
        assert (r.stage, r.mode, r.lane) == ("kernel", "delay", "native")
        assert r.delay_s == pytest.approx(0.02)
        assert r.p == 0.5 and r.n == 3
        # "dispatch" is an alias for the kernel stage
        faults.FAULTS.arm("dispatch:raise")
        assert faults.FAULTS._rules[0].stage == "kernel"
        # device= rules parse and are kept
        faults.FAULTS.arm("one-device-down")
        assert faults.FAULTS._rules[0].device == 0

    @pytest.mark.parametrize("bad", ["kernel", "kernel:explode",
                                     "nostage:raise", "kernel:raise:zzz=1",
                                     "fs:raise", "kernel:raise:p"])
    def test_bad_specs_raise(self, bad):
        for plane in (faults, ref_faults):
            with pytest.raises(ValueError):
                plane.FAULTS.arm(bad)

    def test_firing_limit_and_lane_filter(self):
        faults.FAULTS.arm("kernel:raise:n=2:lane=engine")
        with pytest.raises(faults.InjectedFault):
            faults.FAULTS.check("kernel", "engine")
        # other lane and other stages never match
        faults.FAULTS.check("kernel", "native")
        faults.FAULTS.check("readback", "engine")
        with pytest.raises(faults.InjectedFault):
            faults.FAULTS.check("kernel", "engine")
        # n=2 exhausted: the rule goes quiet
        faults.FAULTS.check("kernel", "engine")
        assert faults.FAULTS.fired == {"kernel:raise:engine": 2}

    def test_time_window(self):
        faults.FAULTS.arm("kernel:raise:for=0.05")
        with pytest.raises(faults.InjectedFault):
            faults.FAULTS.check("kernel", "engine")
        time.sleep(0.08)
        faults.FAULTS.check("kernel", "engine")  # window closed: no fault

    def test_hung_handle_wrap_and_release(self):
        class H:
            released = False

            def is_ready(self):
                return True

            def wait(self):
                return np.zeros((1, 1), dtype=np.uint8)

            def release(self):
                self.released = True

        faults.FAULTS.arm("kernel:hang")
        inner = H()
        h = faults.FAULTS.wrap_handle(inner, "engine")
        assert isinstance(h, faults.HungHandle)
        assert h.is_ready() is False
        with pytest.raises(faults.InjectedFault):
            h.wait()  # a permanent wedge must not block the caller
        h.release()   # the watchdog drops the real handle with it
        assert inner.released and h._handle is None
        # a bounded wedge: the real handle shows through after the window
        h2 = faults.HungHandle(H(), release_at=time.monotonic() - 1)
        assert h2.is_ready() is True
        assert h2.wait().shape == (1, 1)
        # a delay rule releases after its delay
        faults.FAULTS.arm("kernel:delay:delay=0.05")
        h3 = faults.FAULTS.wrap_handle(H(), "engine")
        assert h3.is_ready() is False
        time.sleep(0.08)
        assert h3.is_ready() is True

    @pytest.mark.parametrize("spec", [
        "device-down", "one-device-down", "flaky", "flap", "slow-device",
        "wedge", "kernel:raise:p=0.5:n=7;readback:raise:p=0.2",
        "encode:raise:p=0.4:after=0.0;h2d:raise:p=0.1:lane=engine",
        "fs:torn:artifact=manifest:p=0.5;fs:eio"])
    def test_same_spec_and_seed_equal_the_reference(self, spec):
        """Both planes armed with one spec and seed: equal ``describe()``
        (but the clock), and equal firings over a fixed probe sequence."""
        def drive(plane):
            plane.FAULTS.arm(spec, seed=11)
            d = plane.FAULTS.describe()
            d.pop("armed_for_s")
            trail = []
            for i in range(60):
                stage = ("encode", "h2d", "kernel", "readback")[i % 4]
                try:
                    plane.FAULTS.check(stage, "engine")
                    trail.append((stage, None))
                except plane.InjectedFault as e:
                    trail.append((stage, str(e)))
                rule = plane.FAULTS.fs_fault(("manifest", "hotset")[i % 2])
                trail.append(None if rule is None else rule.describe())
                w = plane.FAULTS.wrap_handle(object(), "engine")
                trail.append(type(w).__name__)
            trail.append([plane.FAULTS.rand() for _ in range(3)])
            return d, trail, dict(plane.FAULTS.fired)

        assert drive(faults) == drive(ref_faults)

    def test_fault_seed_from_the_environment(self, monkeypatch):
        monkeypatch.setenv("AUTHORINO_TPU_FAULT_SEED", "77")
        faults.FAULTS.arm("flaky")
        ref_faults.FAULTS.arm("flaky")
        got = [faults.FAULTS.rand() for _ in range(5)]
        assert got == [ref_faults.FAULTS.rand() for _ in range(5)]
        faults.FAULTS.arm("flaky", seed=77)
        assert [faults.FAULTS.rand() for _ in range(5)] == got

    def test_injected_faults_metric_counts_each_firing(self):
        lab = {"stage": "kernel", "mode": "raise", "lane": "engine"}
        before = sample("auth_server_injected_faults_total", lab)
        faults.FAULTS.arm("kernel:raise:n=3")
        for _ in range(5):
            try:
                faults.FAULTS.check("kernel", "engine")
            except faults.InjectedFault:
                pass
        assert sample("auth_server_injected_faults_total", lab) - before == 3

    @pytest.mark.parametrize("mode", ["torn", "short", "rename-fail", "eio",
                                      "enospc"])
    def test_fs_crash_shapes_equal_the_reference(self, tmp_path, mode):
        """The port's atomic writer under an armed fs rule leaves on disk
        what the reference's leaves, with the same errno and the same
        failure metric delta; disarmed, it writes the new bytes."""
        from authorino_tpu.utils import atomicio as ref_atomicio

        data = bytes(range(256)) * 8
        lab = {"artifact": "manifest"}
        shapes = []
        for plane, writer, sub in ((faults, atomicio, "port"),
                                   (ref_faults, ref_atomicio, "ref")):
            d = tmp_path / sub
            d.mkdir()
            path = d / "MANIFEST.json"
            path.write_bytes(b"old-valid")
            plane.FAULTS.arm(f"fs:{mode}:artifact=manifest", seed=5)
            m0 = sample("auth_server_state_write_failures_total", lab)
            with pytest.raises(OSError) as info:
                writer.atomic_write_bytes(str(path), data,
                                          artifact="manifest")
            plane.FAULTS.disarm()
            shapes.append((info.value.errno, path.read_bytes(),
                           sorted(os.listdir(d)),
                           sample("auth_server_state_write_failures_total",
                                  lab) - m0))
        assert shapes[0] == shapes[1]
        assert shapes[0][3] == 1
        assert (shapes[0][1] == b"old-valid") == (mode != "torn")
        atomicio.atomic_write_bytes(str(tmp_path / "port" / "MANIFEST.json"),
                                    data, artifact="manifest")
        assert (tmp_path / "port" / "MANIFEST.json").read_bytes() == data


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------


class TestCircuitBreaker:
    def test_trips_after_threshold_and_recovers_via_probe(self):
        br = CircuitBreaker("t1", threshold=3, reset_s=0.05)
        assert br.state == "closed"
        for _ in range(2):
            br.record_failure()
        assert br.state == "closed" and br.admit_device()
        br.record_failure()
        assert br.state == "open"
        assert br.admit_device() is False  # cooldown not elapsed
        time.sleep(0.06)
        assert br.admit_device() is True   # the half-open probe slot
        assert br.state == "half-open"
        assert br.admit_device() is False  # ONE probe at a time
        br.record_success()
        assert br.state == "closed"
        assert br.admit_device() is True

    def test_probe_failure_reopens(self):
        br = CircuitBreaker("t2", threshold=1, reset_s=0.05)
        br.record_failure()
        assert br.state == "open"
        assert 0 < br.to_json()["retry_in_s"] <= 0.05
        time.sleep(0.06)
        assert br.admit_device() is True
        br.record_failure()
        assert br.state == "open"
        assert br.admit_device() is False  # cooldown restarted
        states = [t["state"] for t in br.to_json()["transitions"]]
        assert states == ["open", "half-open", "open"]

    def test_release_probe_frees_the_slot_without_a_verdict(self):
        br = CircuitBreaker("t4", threshold=1, reset_s=0.01)
        br.record_failure()
        time.sleep(0.02)
        assert br.admit_device() is True       # probe claimed
        br.release_probe()
        assert br.state == "half-open"         # no verdict recorded
        assert br.admit_device() is True       # next batch can probe again
        br.record_success()
        assert br.state == "closed"

    def test_success_resets_consecutive_count(self):
        br = CircuitBreaker("t3", threshold=2, reset_s=10)
        br.record_failure()
        br.record_success()
        br.record_failure()
        assert br.state == "closed"  # never two CONSECUTIVE failures

    def test_same_outcomes_give_the_reference_trail(self):
        """One scripted sequence of outcomes and admissions through both
        breakers: equal admissions, states, trails (but the clock) and
        ``to_json`` (but the countdown).  The reference's admission also
        says whether it claimed the probe; the port's is the bool alone."""
        script = ["f", "a", "f", "a", "s", "f", "f", "f", "a", "w", "a",
                  "a", "r", "a", "f", "a", "w", "a", "s", "a", "f"]

        def drive(cls, admit):
            br = cls("trail", threshold=3, reset_s=0.03)
            out = []
            for step in script:
                if step == "f":
                    br.record_failure()
                elif step == "s":
                    br.record_success()
                elif step == "r":
                    br.release_probe()
                elif step == "w":
                    time.sleep(0.04)
                else:
                    out.append(admit(br))
                out.append(br.state)
            js = br.to_json()
            js.pop("retry_in_s", None)
            js["transitions"] = [(t["state"], t["reason"])
                                 for t in js["transitions"]]
            return out, js

        assert drive(CircuitBreaker, CircuitBreaker.admit_device) == \
            drive(RefBreaker, RefBreaker.allow_device)

    def test_transitions_record_flight_events_and_metrics(self, tmp_path):
        saved = (port_fr.RECORDER.dump_dir,
                 port_fr.RECORDER.min_dump_interval_s)
        port_fr.RECORDER.configure(dump_dir=str(tmp_path),
                                   min_dump_interval_s=0.0)
        lab = {"lane": "t5"}
        try:
            n0 = port_fr.RECORDER.events_total
            t0 = sample("auth_server_circuit_transitions_total",
                        dict(lab, state="open"))
            br = CircuitBreaker("t5", threshold=1, reset_s=0.01)
            assert sample("auth_server_circuit_state", lab) == 0
            br.record_failure()
            assert sample("auth_server_circuit_state", lab) == 2
            time.sleep(0.02)
            br.admit_device()
            assert sample("auth_server_circuit_state", lab) == 1
            br.record_success()
            assert sample("auth_server_circuit_state", lab) == 0
            assert sample("auth_server_circuit_transitions_total",
                          dict(lab, state="open")) - t0 == 1
            tail = [e for e in port_fr.RECORDER.to_json()["tail"]
                    if e["lane"] == "t5"]
            assert [(e["kind"], e["detail"]["state"]) for e in tail] == [
                ("breaker-open", "open"), ("breaker", "half-open"),
                ("breaker", "closed")]
            assert port_fr.RECORDER.events_total - n0 == 3
            # entering OPEN is an anomaly: one bundle
            assert wait_until_sync(lambda: any(
                n.endswith(".json") and "breaker-open" in n
                for n in os.listdir(tmp_path)))
        finally:
            port_fr.RECORDER.configure(dump_dir=saved[0],
                                       min_dump_interval_s=saved[1])

    def test_cache_resolved_batch_never_closes_the_circuit(self):
        """A batch the cache answers whole claims the half-open probe but
        proves nothing about the device: it frees the slot and the circuit
        stays half-open until a real probe batch succeeds — in both
        packages alike."""
        def scenario(engine, plane):
            d = doc(0, True)
            obs = {"seed": bits(run(submit_all(engine, [d])))}
            engine.breaker.record_failure()
            obs["after_failure"] = engine.breaker.state
            time.sleep(0.06)
            obs["cached"] = bits(run(submit_all(engine, [d])))
            obs["after_cached"] = engine.breaker.state
            obs["probe"] = bits(run(submit_all(engine, [doc(1, False)])))
            obs["after_probe"] = engine.breaker.state
            return obs

        got, _ = both(scenario, verdict_cache_size=1024, breaker_threshold=1,
                      breaker_reset_s=0.05)
        assert (got["after_failure"], got["after_cached"],
                got["after_probe"]) == ("open", "half-open", "closed")
        assert got["cached"] == got["seed"]
        assert decided(got["seed"]) == oracle([doc(0, True)])


# ---------------------------------------------------------------------------
# engine lane: retry, degrade, breaker, watchdog — both packages
# ---------------------------------------------------------------------------


class TestEngineDegradation:
    def test_transient_fault_retried_once_device_answers(self):
        def scenario(engine, plane):
            return {"out": bits(run(submit_all(engine, [doc(0, True)]))),
                    "state": engine.breaker.state}

        got, engine = both(scenario, "kernel:raise:n=1")
        assert decided(got["out"]) == oracle([doc(0, True)])
        assert got["auth_server_batch_retries_total"] == 1
        # the RETRY succeeded on the device: nothing degraded
        assert got["auth_server_degraded_decisions_total"] == 0
        assert got["state"] == "closed" and got["transitions"] == []
        assert engine.stats["plain_calls"] == 1

    def test_persistent_failure_serves_exact_verdicts_and_recovers(self):
        """Under a persistent device fault every request keeps its exact
        oracle verdict, the breaker trips, an open breaker keeps batches
        off the device (the plane sees no attempt), and once the fault
        clears the half-open probe restores device serving."""
        docs = [doc(i, i % 3 != 0) for i in range(24)]
        extra = [doc(100, True), doc(101, False)]

        def scenario(engine, plane):
            obs = {"seq": bits(run(staggered(engine, docs))),
                   "state": engine.breaker.state}
            fired_open = dict(plane.FAULTS.fired)
            obs["open_burst"] = bits(run(submit_all(engine, extra)))
            obs["frozen"] = plane.FAULTS.fired == fired_open
            plane.FAULTS.disarm()
            # the cooldown, shortened only now: however slow the runs
            # above, no probe fell inside them
            engine.breaker.reset_s = 0.05
            time.sleep(0.06)
            obs["probe"] = bits(run(submit_all(engine, [doc(200, True)])))
            obs["final"] = engine.breaker.state
            return obs

        got, engine = both(scenario, "device-down", breaker_threshold=2,
                           breaker_reset_s=60.0)
        assert decided(got["seq"]) == oracle(docs)
        assert decided(got["open_burst"]) == oracle(extra)
        assert got["state"] == "open" and got["frozen"]
        assert got["final"] == "closed"
        assert [s for s, _ in got["transitions"]] == ["open", "half-open",
                                                      "closed"]
        assert got["auth_server_degraded_decisions_total"] == 26
        assert got["heat"]    # denials of the degraded rows attributed
        reasons = [r["degraded"] for r in engine.batch_records
                   if "degraded" in r]
        assert reasons == ["device-failure"] + ["breaker-open"] * 24

    def test_flap_profile_recovers_without_operator_action(self):
        """The device down for a window, then healthy: every request
        answered exactly through the flap, and the breaker re-closes on
        its own."""
        docs = [doc(i, True) for i in range(6)]

        def scenario(engine, plane):
            obs = {"flap": bits(run(staggered(engine, docs)))}
            time.sleep(1.1)  # the fault window closed AND cooldown elapsed
            obs["after"] = bits(run(submit_all(engine, [doc(10, True)])))
            obs["state"] = engine.breaker.state
            return obs

        got, _ = both(scenario, "kernel:raise:for=0.3", breaker_threshold=2,
                      breaker_reset_s=1.0)
        assert decided(got["flap"]) == oracle(docs)
        assert decided(got["after"]) == oracle([doc(10, True)])
        assert got["state"] == "closed"
        assert [s for s, _ in got["transitions"]] == ["open", "half-open",
                                                      "closed"]

    def test_degrade_is_oracle_exact_on_membership_overflow(self):
        over = {"auth": {"identity": {
            "roles": [f"r{k}" for k in range(10)] + ["admin", "writer"],
            "groups": ["staff"]}}}

        def scenario(engine, plane):
            return {"out": bits(run(submit_all(engine, [over])))}

        got, _ = both(scenario, "device-down", breaker_threshold=100)
        assert decided(got["out"]) == oracle([over])
        assert got["auth_server_degraded_decisions_total"] == 1

    def test_watchdog_times_out_wedged_batches(self):
        def scenario(engine, plane):
            t0 = time.monotonic()
            out = bits(run(submit_all(engine, [doc(0, True)])))
            return {"out": out, "slow": time.monotonic() - t0 > 0.25}

        got, _ = both(scenario, "wedge", device_timeout_s=0.15,
                      breaker_threshold=100)
        # attempt 0 wedges → the retry wedges → the oracle answers
        assert decided(got["out"]) == oracle([doc(0, True)]) and got["slow"]
        assert got["auth_server_device_watchdog_timeouts_total"] == 2
        assert got["auth_server_degraded_decisions_total"] == 1

    def test_seeded_flaky_device_equals_the_reference(self):
        """``flaky`` under one seed: the same batches fail, retry, degrade
        and trip the breaker in both packages; the retries plus the
        failure-degraded batches equal the plane's firings."""
        docs = [doc(i, i % 2 == 0) for i in range(40)]

        def scenario(engine, plane):
            return {"out": bits(run(staggered(engine, docs)))}

        got, engine = both(scenario, "flaky", seed=7, breaker_threshold=3,
                           breaker_reset_s=60.0)
        assert decided(got["out"]) == oracle(docs)
        fired = got["fired"].get("kernel:raise:engine", 0)
        failed = sum(1 for r in engine.batch_records
                     if r.get("degraded") == "device-failure")
        assert fired > 0
        assert got["auth_server_batch_retries_total"] + failed == fired

    def test_no_snapshot_is_typed_unavailable(self):
        outs = []
        for engine in (RefEngine(members_k=4, mesh=None, verdict_cache_size=0),
                       PolicyEngine(members_k=4, device="cpu",
                                    verdict_cache_size=0)):
            async def one():
                try:
                    await engine.submit(doc(0, True), "c")
                except Exception as e:
                    return type(e).__name__, e.code, e.message
                return None

            outs.append(run(one()))
        assert outs[0] == outs[1] == ("CheckAbort", UNAVAILABLE,
                                      "no compiled policy snapshot")

    def test_an_oracle_failure_answers_typed_unavailable(self, monkeypatch):
        """A row whose oracle run itself fails is the one the degrade
        cannot decide: it answers the typed UNAVAILABLE, fail closed; the
        other rows of the batch keep their exact verdicts."""
        engine = engine_of(PORT, breaker_threshold=100)
        real = engine_mod.host_results

        def planted(policy, d, row):
            if d.get("planted"):
                raise RuntimeError("oracle fault: secret detail")
            return real(policy, d, row)

        monkeypatch.setattr(engine_mod, "host_results", planted)
        faults.FAULTS.arm("device-down")
        docs = [doc(0, True), dict(doc(1, True), planted=True), doc(2, False)]

        async def body():
            return await asyncio.gather(*(engine.submit(d, "c")
                                          for d in docs),
                                        return_exceptions=True)

        outs = run(body())
        assert decided(bits([outs[0], outs[2]])) == oracle([docs[0], docs[2]])
        assert isinstance(outs[1], CheckAbort)
        assert (outs[1].code, outs[1].message) == (
            UNAVAILABLE, "policy evaluation unavailable")
        assert engine.stats["degraded_rows"] == 2
        assert engine.stats["failed_batches"] == 1


def test_card_engine_answers_unavailable_never_the_oracle(monkeypatch):
    """A CUDA-configured engine whose device is a stub — its launches
    count as the card's (one launch, no plain call) and its readbacks
    fail — answers every batch it could not decide with the typed
    UNAVAILABLE: the first batch after its retry, then every batch the
    open breaker keeps off the card.  Neither the host oracle nor the
    kernel's plain version answers a row; the wrapper's ``plain_calls``
    stays 0 and nothing counts as degraded."""
    engine = engine_of(PORT, breaker_threshold=2, breaker_reset_s=60.0)
    engine.device = torch.device("cuda")
    assert engine.host_degrade is False

    class CardHandle:
        launches, plain_calls = 1, 0

        def __init__(self, nbytes):
            self.nbytes = nbytes

        def is_ready(self):
            return True

        def wait(self):
            raise RuntimeError("readback failed: secret detail")

    launches = []

    def stub_dispatch(params, db):
        launches.append(db)
        W = packed_width(1 + 2 * int(params["eval_rule"].shape[1]))
        return CardHandle(int(db.attrs_val.shape[0]) * W)

    def not_on_a_card(*a, **k):
        raise AssertionError("a card engine answered through another lane")

    monkeypatch.setattr(p_fk, "dispatch_megakernel", stub_dispatch)
    monkeypatch.setattr(p_fk, "fused_packed_plain", not_on_a_card)
    monkeypatch.setattr(p_fk, "eval_fused_kernel", not_on_a_card)
    monkeypatch.setattr(engine_mod, "host_results", not_on_a_card)
    p0, h0 = p_fk.plain_calls, LEDGER.snapshot("host")["rows"]
    d0 = sample("auth_server_degraded_decisions_total", {"lane": "engine"})

    async def body():
        outs = []
        for i in range(12):    # sequential: one batch each
            try:
                outs.append(await engine.submit(doc(i, True), "c"))
            except CheckAbort as e:
                outs.append(e)
        return outs

    outs = run(body())
    assert all(isinstance(e, CheckAbort) and e.code == UNAVAILABLE
               and "secret" not in repr(e) for e in outs)
    assert outs[0].message == "policy evaluation unavailable"
    assert {e.message for e in outs[1:]} == {"engine device circuit open"}
    assert p_fk.plain_calls == p0
    assert len(launches) == 2          # the first batch and its retry
    st = engine.stats
    assert (st["launches"], st["plain_calls"]) == (2, 0)
    assert (st["failed_batches"], st["breaker_open_batches"]) == (12, 11)
    assert (st["degraded_rows"], st["degraded_batches"]) == (0, 0)
    assert not any("degraded" in r for r in engine.batch_records)
    assert LEDGER.snapshot("host")["rows"] == h0
    assert sample("auth_server_degraded_decisions_total",
                  {"lane": "engine"}) == d0
    assert engine.breaker.state == "open"
    assert engine.debug_vars()["host_degrade"] is False
    assert wait_until_sync(lambda: engine._inflight == 0)


@pytest.mark.parametrize("lane", ["cpu", "card"])
@pytest.mark.parametrize("reason", ["breaker-open", "device-failure"])
def test_an_undecided_batch_always_resolves(monkeypatch, lane, reason):
    """Whatever raises while a batch the device did not decide is ended
    (here the SLO fold of the CPU's degrade, the failure count of the
    card's UNAVAILABLE), every future of it still resolves, typed, and
    the window slot is freed."""
    engine = engine_of(PORT, breaker_threshold=1, breaker_reset_s=60.0,
                       slo_ms=10_000.0)
    if lane == "card":
        engine.device = torch.device("cuda")

    def broken(*a, **k):
        raise RuntimeError("fold fault")

    if lane == "cpu":
        monkeypatch.setattr(engine.slo, "observe", broken)
    else:
        real_add = engine._add_stats

        def add_stats(**kw):
            if kw.get("failed_batches"):
                broken()
            real_add(**kw)

        monkeypatch.setattr(engine, "_add_stats", add_stats)
    if reason == "breaker-open":
        engine.breaker.record_failure()
        assert engine.breaker.state == "open"
    else:
        faults.FAULTS.arm("device-down")

    async def body():
        return await asyncio.wait_for(asyncio.gather(
            *(engine.submit(doc(i, True), "c") for i in range(5)),
            return_exceptions=True), 30)

    outs = run(body())
    assert all(isinstance(e, CheckAbort) and e.code == UNAVAILABLE
               for e in outs), outs
    assert wait_until_sync(lambda: engine._inflight == 0)


def test_readyz_surfaces_drain_and_degraded_circuit():
    """The reference's case on both packages' HTTP apps: ready, a tripped
    breaker surfaced but still ready (200), draining 503; /debug/vars
    carries the breaker."""
    from aiohttp.test_utils import TestClient, TestServer

    from authorino_tpu.service.http_server import build_app as ref_app
    from authorino_tpu_torch.service.http_server import build_app as port_app

    def scenario(ns, build_app):
        engine = engine_of(ns, breaker_threshold=1)

        async def body():
            app = build_app(engine, readiness=lambda: True)
            client = TestClient(TestServer(app))
            await client.start_server()
            try:
                out = []
                r = await client.get("/readyz")
                out.append((r.status, await r.text()))
                engine.breaker.record_failure()
                r = await client.get("/readyz")
                out.append((r.status, await r.text()))
                engine.breaker.record_success()
                engine.begin_drain()
                r = await client.get("/readyz")
                out.append((r.status, await r.text()))
                dv = await (await client.get("/debug/vars")).json()
                out.append((dv["engine"]["draining"],
                            dv["engine"]["breaker"]["state"],
                            [t["state"] for t in
                             dv["engine"]["breaker"]["transitions"]],
                            dv["engine"]["faults"]))
                return out
            finally:
                await client.close()

        return run(body())

    want = scenario(REF, ref_app)
    got = scenario(PORT, port_app)
    assert got == want
    assert got[:3] == [(200, "ok"),
                       (200, "ok (degraded: engine device circuit open)"),
                       (503, "draining")]
    assert got[3] == (True, "closed", ["open", "closed"], {"armed": False})
