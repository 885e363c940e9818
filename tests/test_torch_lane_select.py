"""The port's host lanes against the JAX package's (``tests/test_lane_select.py``):
the cost model, the selector, the first-wins token, lane-aware admission,
the host lane serving light load on a CPU engine, the deadline rescue,
speculative dual dispatch on a half-open probe, and verdict + attribution
parity across the lanes.

Every case runs the same scenario through the reference's objects (its
engine on JAX's CPU backend) and the port's (a ``device="cpu"`` engine)
and holds their observations equal, tolerance 0 (verdicts and firing
columns are boolean; the cost model's arithmetic is the same float
operations on the same inputs); the reference test's own assertions are
checked on each package's run.  The engine cases replace the launch with
a stub device whose batches complete when the case says so.  The
reference's ``test_probe_rides_both_lanes_host_wins_device_confirms``
races a 0.3 s device against the host twin on the wall clock; its twin
here orders the race with events (the device readback is released only
after the clients have their answers), and so do the other races.

The port's rule for a card (``resolve_host_lanes``) is held here through
the pure resolver with ``torch.device("cuda")``; a card engine at its
defaults is held on the card in ``tests/test_torch_cuda.py``."""

from __future__ import annotations

import asyncio
import random
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from authorino_tpu.compiler import ConfigRules as RConfigRules
from authorino_tpu.expressions import All as RAll
from authorino_tpu.expressions import Any_ as RAny
from authorino_tpu.expressions import Operator as ROperator
from authorino_tpu.expressions import Pattern as RPattern
from authorino_tpu.ops.pattern_eval import firing_columns as r_firing
from authorino_tpu.parallel.sharded_eval import ShardedPolicyModel as RSharded
from authorino_tpu.runtime import EngineEntry as REntry
from authorino_tpu.runtime import PolicyEngine as REngine
from authorino_tpu.runtime import admission as r_adm
from authorino_tpu.runtime import engine as r_engine_mod
from authorino_tpu.runtime import faults as r_faults
from authorino_tpu.runtime import lane_select as r_ls
from authorino_tpu_torch.compiler import ConfigRules as PConfigRules
from authorino_tpu_torch.expressions import All as PAll
from authorino_tpu_torch.expressions import Any_ as PAny
from authorino_tpu_torch.expressions import Operator as POperator
from authorino_tpu_torch.expressions import Pattern as PPattern
from authorino_tpu_torch.ops.operands import firing_columns as p_firing
from authorino_tpu_torch.parallel.sharded_eval import \
    ShardedPolicyModel as PSharded
from authorino_tpu_torch.runtime import EngineEntry as PEntry
from authorino_tpu_torch.runtime import PolicyEngine as PEngine
from authorino_tpu_torch.runtime import admission as p_adm
from authorino_tpu_torch.runtime import engine as p_engine_mod
from authorino_tpu_torch.runtime import faults as p_faults
from authorino_tpu_torch.runtime import lane_select as p_ls
from authorino_tpu_torch.utils.rpc import DEADLINE_EXCEEDED


@pytest.fixture(autouse=True)
def _disarm_faults():
    yield
    r_faults.FAULTS.disarm()
    p_faults.FAULTS.disarm()


def _ref_engine(**kw):
    return REngine(members_k=4, mesh=None, **kw)


def _port_engine(**kw):
    return PEngine(members_k=4, device="cpu", **kw)


REF = SimpleNamespace(
    name="ref", ls=r_ls, adm=r_adm, engine_mod=r_engine_mod,
    faults=r_faults, make=_ref_engine, Entry=REntry,
    ConfigRules=RConfigRules, All=RAll, Any_=RAny, Pattern=RPattern,
    Operator=ROperator, firing=r_firing, Sharded=RSharded)
PORT = SimpleNamespace(
    name="port", ls=p_ls, adm=p_adm, engine_mod=p_engine_mod,
    faults=p_faults, make=_port_engine, Entry=PEntry,
    ConfigRules=PConfigRules, All=PAll, Any_=PAny, Pattern=PPattern,
    Operator=POperator, firing=p_firing, Sharded=PSharded)


def both(scenario, *args):
    """``scenario(ns, *args)`` on both packages: equal observations;
    returns the port's."""
    want = scenario(REF, *args)
    got = scenario(PORT, *args)
    assert got == want, (got, want)
    return got


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


async def wait_until(pred, timeout=5.0, step=0.005):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        await asyncio.sleep(step)
    return pred()


def rule_of(ns):
    return ns.All(
        ns.Pattern("auth.identity.roles", ns.Operator.INCL, "admin"),
        ns.Pattern("auth.identity.groups", ns.Operator.EXCL, "banned"))


def build_engine(ns, **kw):
    kw.setdefault("verdict_cache_size", 0)
    kw.setdefault("max_batch", 8)
    engine = ns.make(**kw)
    engine.apply_snapshot([ns.Entry(
        id="c", hosts=["c"], runtime=None,
        rules=ns.ConfigRules(name="c", evaluators=[(None, rule_of(ns))]))])
    return engine


def doc(i: int, allow: bool) -> dict:
    return {"auth": {"identity": {
        "roles": ["admin", f"r{i}"] if allow else [f"r{i}"],
        "groups": []}}}


async def submit_all(engine, docs, **kw):
    outs = await asyncio.gather(
        *(engine.submit(d, "c", **kw) for d in docs))
    return [bool(rule[0]) for rule, _ in outs]


def seed_model(engine, host_row_s=1e-4, device_rtt_s=0.1):
    """Teach the cost model a fast host lane and a slow device, so the
    next small cut decides HOST deterministically."""
    engine.lanes.cost.observe_host(host_row_s * 10, 10)
    engine.lanes.cost.observe_device(device_rtt_s, 8)
    engine._device_ewma = device_rtt_s


class FakeHandle:
    """A readback that is ready once ``evt`` is set (the reference reads
    it with ``np.asarray``, the port with ``wait()``)."""

    def __init__(self, evt):
        self.evt = evt

    def is_ready(self):
        return self.evt.is_set()

    def wait(self):
        return np.zeros((1, 1), dtype=np.uint8)

    def __array__(self, dtype=None, copy=None):
        return np.zeros((1, 1))


class StubDevice:
    """Replaces ``_encode_and_launch``: a batch completes allow-all once
    its handle's event is set — after ``latency_s`` on a timer, or when
    the case calls ``release()``, whichever the case arms."""

    def __init__(self, ns, engine, latency_s=None):
        self.ns = ns
        self.engine = engine
        self.latency_s = latency_s
        self.launched_batches = 0
        self.launched_rows = 0
        self.events = []
        engine._encode_and_launch = self._launch

    def release(self):
        for e in self.events:
            e.set()

    def _launch(self, snap, batch):
        n = len(batch)
        self.launched_batches += 1
        self.launched_rows += n
        evt = threading.Event()
        self.events.append(evt)
        if self.latency_s is not None:
            t = threading.Timer(self.latency_s, evt.set)
            t.daemon = True
            t.start()
        binfo = {"batch_size": n, "pad": n, "eff": 0, "device_rows": n,
                 "start_ns": time.time_ns(), "duration_s": 0.0,
                 "t0": time.monotonic()}

        def finalize(packed):
            rule = np.ones((n, 1), dtype=bool)
            skipped = np.zeros((n, 1), dtype=bool)
            if self.ns is REF:
                return rule, skipped, None
            return rule, skipped

        return self.ns.engine_mod._Inflight(
            self.engine, batch, FakeHandle(evt), finalize, binfo, np.zeros(n))


def lane_json(engine):
    ls = engine.lanes.to_json()
    return ls["decisions"], ls["rows"], ls["speculative_outcomes"]


# ---------------------------------------------------------------------------
# the port's rule on a card
# ---------------------------------------------------------------------------


class TestCardRule:
    def test_cpu_resolves_to_the_references_defaults(self):
        assert p_ls.resolve_host_lanes(torch.device("cpu")) == \
            (True, True, True)
        assert p_ls.resolve_host_lanes("cpu", False, None, False) == \
            (False, True, False)
        # the reference's engine at its defaults: all on
        e = build_engine(REF)
        assert (e.brownout, e.lanes.enabled, e.lanes.speculative) == \
            p_ls.resolve_host_lanes("cpu")

    @pytest.mark.parametrize("dev", ["cuda", "cuda:0"])
    def test_card_resolves_off_and_explicit_true_raises(self, dev):
        d = torch.device(dev)
        assert p_ls.resolve_host_lanes(d) == (False, False, False)
        assert p_ls.resolve_host_lanes(d, False, False, False) == \
            (False, False, False)
        for kw in ({"brownout": True}, {"lane_select": True},
                   {"speculative": True}):
            with pytest.raises(ValueError, match="only the mega-kernel "
                                                 "answers a row"):
                p_ls.resolve_host_lanes(d, **kw)

    def test_a_card_shaped_selector_counts_device_disabled(self):
        """What a card engine builds: the selector off, every cut
        device/disabled, the device RTT EWMA still fed."""
        s = p_ls.LaneSelector("t-card", enabled=False)
        s.cost.observe_device(0.002, 256)
        assert s.decide(1, 0, 8) == (p_ls.DEVICE, p_ls.R_DISABLED)
        assert s.admission_floor() == float("inf")
        assert s.to_json()["cost"]["device_rtt_ewma_s"] == 0.002


# ---------------------------------------------------------------------------
# cost model units
# ---------------------------------------------------------------------------


class TestCostModel:
    def test_host_cost_scales_with_rows(self):
        def scenario(ns):
            c = ns.ls.LaneCostModel("t-hc")
            c.observe_host(0.001, 10)  # 100us/row
            assert c.host_cost(1) == pytest.approx(1e-4, rel=0.01)
            assert c.host_cost(50) == pytest.approx(5e-3, rel=0.01)
            return c.host_cost(1), c.host_cost(50), c.to_json()
        both(scenario)

    def test_device_cost_inflates_with_occupancy_and_mesh(self):
        def scenario(ns):
            c = ns.ls.LaneCostModel("t-dc")
            c.observe_device(0.1, 256)
            base = c.device_cost(0, 8)
            assert base == pytest.approx(0.1, rel=0.01)
            assert c.device_cost(8, 8) == pytest.approx(2 * base, rel=0.01)
            c.mesh_penalty = 4.0  # 3 of 4 devices down
            assert c.device_cost(0, 8) == pytest.approx(4 * base, rel=0.01)
            return base, c.device_cost(8, 8), c.device_cost(0, 8)
        both(scenario)

    def test_cold_start_prefers_device(self):
        def scenario(ns):
            s = ns.ls.LaneSelector("t-cold")
            assert s.decide(4, 0, 8)[0] == ns.ls.DEVICE
            return s.decide(4, 0, 8), s.to_json()
        both(scenario)

    def test_burn_bias_bounded_and_directional(self):
        def scenario(ns):
            c = ns.ls.LaneCostModel("t-burn")
            assert c.burn_bias() == 1.0
            c.observe_slo(ns.ls.DEVICE, 100, 100, now=10.0)
            assert 1.0 < c.burn_bias() <= 2.0  # device burning: host favored
            c2 = ns.ls.LaneCostModel("t-burn2")
            c2.observe_slo(ns.ls.HOST, 100, 100, now=10.0)
            assert 0.5 <= c2.burn_bias() < 1.0
            return c.burn_bias(), c2.burn_bias()
        both(scenario)

    def test_burn_decays(self):
        def scenario(ns):
            c = ns.ls.LaneCostModel("t-decay")
            t0 = 100.0
            c.observe_slo(ns.ls.DEVICE, 100, 100, now=t0)
            assert c.burn_frac(ns.ls.DEVICE) == 1.0
            c.observe_slo(ns.ls.DEVICE, 1000, 0, now=t0 + 120.0)
            assert c.burn_frac(ns.ls.DEVICE) < 0.05
            return c.burn_frac(ns.ls.DEVICE), c.to_json()
        both(scenario)

    def test_min_service_is_the_admission_floor(self):
        def scenario(ns):
            c = ns.ls.LaneCostModel("t-floor")
            c.observe_host(0.001, 10)
            c.observe_device(0.5, 8)
            assert c.min_service_s() == pytest.approx(1e-4, rel=0.01)
            return c.min_service_s()
        both(scenario)


class TestSelector:
    @staticmethod
    def seeded(ns, **kw):
        c = ns.ls.LaneCostModel("t-sel")
        c.observe_host(0.001, 10)   # 100us/row
        c.observe_device(0.1, 256)  # 100ms RTT
        return ns.ls.LaneSelector("t-sel", cost=c, **kw)

    def test_small_cut_goes_host_large_goes_device(self):
        def scenario(ns):
            s = self.seeded(ns, host_max_rows=64)
            out = [s.decide(4, 0, 8), s.decide(65, 0, 8), s.decide(64, 0, 8)]
            assert out[0] == (ns.ls.HOST, ns.ls.R_COST)
            assert out[1] == (ns.ls.DEVICE, ns.ls.R_BATCH)
            assert out[2][0] == ns.ls.HOST
            return out
        both(scenario)

    def test_host_busy_and_disabled(self):
        def scenario(ns):
            s = self.seeded(ns, host_concurrency=1)
            s.host_inflight = 1
            busy = s.decide(4, 0, 8)
            assert busy == (ns.ls.DEVICE, ns.ls.R_HOST_BUSY)
            s2 = self.seeded(ns)
            s2.enabled = False
            off = s2.decide(4, 0, 8)
            assert off == (ns.ls.DEVICE, ns.ls.R_DISABLED)
            return busy, off
        both(scenario)

    def test_burn_bias_flips_a_close_call(self):
        def scenario(ns):
            c = ns.ls.LaneCostModel("t-flip")
            c.observe_host(0.08, 1)    # host 80ms/row — close to the RTT
            c.observe_device(0.1, 8)   # device 100ms
            s = ns.ls.LaneSelector("t-flip", cost=c, explore_every=0)
            first = s.decide(1, 0, 8)
            assert first[0] == ns.ls.HOST  # raw cost: 80 < 100
            c.observe_slo(ns.ls.HOST, 100, 100, now=10.0)  # host burning
            which, why = s.decide(1, 0, 8)
            assert which == ns.ls.DEVICE and why == "slo-burn"
            return first, (which, why)
        both(scenario)

    def test_explore_probes_the_device_periodically(self):
        def scenario(ns):
            s = self.seeded(ns, explore_every=8)
            picks = [s.decide(2, 0, 8) for _ in range(8)]
            assert picks[-1] == (ns.ls.DEVICE, ns.ls.R_EXPLORE)
            assert all(w == ns.ls.HOST for w, _ in picks[:-1])
            return picks
        both(scenario)


class TestSpeculation:
    def test_first_claim_wins_exactly_once(self):
        def scenario(ns):
            sp = ns.ls.Speculation("t")
            out = (sp.claim(ns.ls.HOST), sp.claim(ns.ls.DEVICE), sp.winner)
            assert out == (True, False, ns.ls.HOST)
            return out
        both(scenario)

    def test_acquire_is_idempotent_for_the_owner(self):
        def scenario(ns):
            sp = ns.ls.Speculation("t")
            out = (sp.acquire(ns.ls.DEVICE), sp.acquire(ns.ls.DEVICE),
                   sp.acquire(ns.ls.HOST))
            assert out == (True, True, False)
            return out
        both(scenario)

    def test_concurrent_claims_single_winner(self):
        def scenario(ns):
            for _ in range(50):
                sp = ns.ls.Speculation("t")
                wins = []
                barrier = threading.Barrier(2)

                def claim(which):
                    barrier.wait()
                    if sp.claim(which):
                        wins.append(which)

                ts = [threading.Thread(target=claim, args=(w,))
                      for w in (ns.ls.HOST, ns.ls.DEVICE)]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join()
                assert len(wins) == 1 and wins[0] == sp.winner
            return True
        both(scenario)


# ---------------------------------------------------------------------------
# lane-aware admission
# ---------------------------------------------------------------------------


class TestLaneAwareAdmission:
    def test_lane_floor_rescues_tight_deadlines_at_admission(self):
        def scenario(ns):
            a = ns.adm.AdmissionController("t-lane-adm", target_s=0.05,
                                           min_cap=1000)
            now = 50.0
            doomed = a.admit(0, now=now, deadline=now + 1.0, rtt_s=5.0)
            assert doomed is not None
            a.lane_floor = lambda: 1e-4
            rescued = a.admit(0, now=now, deadline=now + 1.0, rtt_s=5.0)
            assert rescued is None
            expired = a.admit(0, now=now, deadline=now - 0.01, rtt_s=5.0)
            assert expired[0] == DEADLINE_EXCEEDED
            return doomed, rescued, expired
        both(scenario)

    def test_broken_floor_never_breaks_admission(self):
        def scenario(ns):
            a = ns.adm.AdmissionController("t-lane-adm2", target_s=0.05,
                                           min_cap=10)

            def boom():
                raise RuntimeError("floor broke")

            a.lane_floor = boom
            out = a.admit(0, now=1.0, deadline=2.0, rtt_s=0.0)
            assert out is None
            return out
        both(scenario)

    def test_engine_wires_the_floor_only_when_enabled(self):
        def scenario(ns):
            e1 = build_engine(ns, lane_select=True)
            e2 = build_engine(ns, lane_select=False)
            out = (e1.admission.lane_floor is not None,
                   e2.admission.lane_floor is None)
            assert out == (True, True)
            return out
        both(scenario)

    def test_floor_collapses_when_host_lane_saturated(self):
        def scenario(ns):
            engine = build_engine(ns)
            seed_model(engine, device_rtt_s=5.0)
            floor = engine.admission.lane_floor()
            assert floor < 1.0
            engine.lanes.host_inflight = engine.lanes.host_limit
            assert engine.admission.lane_floor() == float("inf")
            now = time.monotonic()
            busy = engine.admission.admit(0, now=now, deadline=now + 1.0,
                                          rtt_s=5.0)
            assert busy is not None
            engine.lanes.host_inflight = 0
            free = engine.admission.admit(0, now=now, deadline=now + 1.0,
                                          rtt_s=5.0)
            assert free is None
            return floor, busy, free
        both(scenario)


# ---------------------------------------------------------------------------
# the engine: the host lane as a serving lane of a CPU engine
# ---------------------------------------------------------------------------


class TestHostLaneServing:
    def test_light_load_served_host_side_zero_device_launches(self):
        def scenario(ns):
            engine = build_engine(ns)
            stub = StubDevice(ns, engine, latency_s=0.2)
            seed_model(engine)
            engine.lanes.explore_every = 0  # pin: no periodic device probe
            outs = run(submit_all(engine, [doc(i, i % 2 == 0)
                                           for i in range(4)]))
            assert outs == [True, False, True, False]
            assert stub.launched_batches == 0
            ls = engine.lanes.to_json()
            assert ls["rows"][ns.ls.HOST] == 4
            assert any(k.startswith("host:") for k in ls["decisions"])
            return outs, stub.launched_batches, lane_json(engine)
        engine_out = both(scenario)
        assert engine_out[2][0] == {"host:cost-model": 1}

    def test_large_cut_rides_the_device(self):
        def scenario(ns):
            engine = build_engine(ns, max_batch=64, lane_host_max_rows=4)
            stub = StubDevice(ns, engine, latency_s=0.01)
            seed_model(engine)
            outs = run(submit_all(engine, [doc(i, True) for i in range(32)]))
            assert all(outs)
            assert stub.launched_batches >= 1
            return outs, stub.launched_rows, lane_json(engine)
        both(scenario)

    def test_host_lane_observes_cost_and_service(self):
        def scenario(ns):
            engine = build_engine(ns)
            StubDevice(ns, engine, latency_s=0.2)
            seed_model(engine)
            engine.lanes.explore_every = 0
            before = engine.lanes.cost.host_batches
            out = run(submit_all(engine, [doc(0, True)]))
            assert engine.lanes.cost.host_batches > before
            assert engine.lanes.cost.host_row_s > 0
            return out, engine.lanes.cost.host_batches - before
        both(scenario)

    def test_cache_only_batches_never_feed_the_device_rtt(self):
        def scenario(ns):
            engine = build_engine(ns)
            stub = StubDevice(ns, engine, latency_s=0.0)
            real = stub._launch

            def cache_only(snap, batch):
                item = real(snap, batch)
                item.binfo["device_rows"] = 0
                return item

            engine._encode_and_launch = cache_only
            before = engine.lanes.cost.device_batches
            out = run(submit_all(engine, [doc(0, True)]))
            assert engine.lanes.cost.device_batches == before
            assert engine.lanes.cost.device_rtt_s == 0.0
            return out, engine.lanes.cost.device_batches
        both(scenario)

    def test_explore_decision_reaches_the_device(self):
        def scenario(ns):
            engine = build_engine(ns)
            stub = StubDevice(ns, engine, latency_s=0.01)
            seed_model(engine)
            engine.lanes.explore_every = 2  # every 2nd host win explores

            async def series():
                out = []
                for i in range(4):
                    out += await submit_all(engine, [doc(i, True)])
                return out

            out = run(series())
            assert stub.launched_batches >= 1
            assert "device:explore" in engine.lanes.to_json()["decisions"]
            return out, stub.launched_batches, lane_json(engine)[0]
        decisions = both(scenario)[2]
        assert decisions == {"host:cost-model": 2, "device:explore": 2}

    def test_deadline_head_rescued_not_shed(self):
        def scenario(ns):
            engine = build_engine(ns, max_batch=16, lane_host_max_rows=2)
            StubDevice(ns, engine, latency_s=0.5)
            seed_model(engine, device_rtt_s=0.5)
            engine.lanes.explore_every = 0

            async def mixed():
                tight = time.monotonic() + 0.1
                futs = [engine.submit(doc(i, True), "c",
                                      deadline=tight if i < 2 else None)
                        for i in range(8)]
                return await asyncio.gather(*futs, return_exceptions=True)

            outs = run(mixed())
            assert not any(isinstance(o, Exception) for o in outs)
            assert all(bool(r[0][0]) for r in outs)
            dec = engine.lanes.to_json()["decisions"]
            assert dec.get("host:deadline", 0) >= 1
            return [bool(r[0][0]) for r in outs], dec
        both(scenario)

    def test_degrade_teaches_the_cost_model(self):
        def scenario(ns):
            engine = build_engine(ns, breaker_threshold=2)
            ns.faults.FAULTS.arm("kernel:raise:p=1.0")
            try:
                first = run(submit_all(engine, [doc(0, True)]))
                assert first == [True]
                assert engine.lanes.cost.host_row_s > 0  # degrade taught it
                second = run(submit_all(engine, [doc(1, False)]))
                assert second == [False]
            finally:
                ns.faults.FAULTS.disarm()
            assert engine.lanes.to_json()["rows"][ns.ls.HOST] >= 1
            return first, second, lane_json(engine)[:2]
        both(scenario)

    def test_drain_waits_out_host_lane_batches(self):
        def scenario(ns):
            engine = build_engine(ns)
            StubDevice(ns, engine, latency_s=0.05)
            seed_model(engine)
            out = run(submit_all(engine, [doc(0, True)]))
            drained = engine.drain(timeout_s=5.0)
            assert drained is True
            assert engine.lanes.host_inflight == 0
            return out, drained, engine.lanes.host_inflight
        both(scenario)

    def test_debug_vars_lane_block(self):
        def scenario(ns):
            engine = build_engine(ns)
            dv = engine.debug_vars()
            ls = dv["lane_select"]
            for key in ("enabled", "host_max_rows", "speculative",
                        "decisions", "rows", "speculative_outcomes", "cost"):
                assert key in ls
            for key in ("host_row_ewma_s", "device_rtt_ewma_s",
                        "mesh_penalty", "burn_bias"):
                assert key in ls["cost"]
            return ls, dv["brownout"]
        both(scenario)


# ---------------------------------------------------------------------------
# speculative dual dispatch: first wins, no double resolve, no double burn
# ---------------------------------------------------------------------------


def trip_to_half_open(engine, reset_s=0.02):
    """Drive the lane breaker OPEN and past its cooldown, so the next
    dispatch claims the half-open probe slot."""
    for _ in range(engine.breaker.threshold):
        engine.breaker.record_failure()
    assert engine.breaker.state == "open"
    time.sleep(reset_s + 0.01)


class TestSpeculativeDualDispatch:
    def test_probe_rides_both_lanes_host_wins_device_confirms(self):
        def scenario(ns):
            engine = build_engine(ns, breaker_threshold=2,
                                  breaker_reset_s=0.02, slo_ms=1000.0)
            # the device half completes only once released, after the
            # clients have their answers: the host twin wins by order
            stub = StubDevice(ns, engine)
            seed_model(engine, device_rtt_s=0.3)
            engine.lanes.host_max_rows = 0  # the CUT rides the device
            trip_to_half_open(engine)
            slo_before = engine.slo.total

            async def probe():
                outs = await submit_all(engine, [doc(i, True)
                                                 for i in range(3)])
                # answered while the device half is still in flight
                assert await wait_until(lambda: stub.launched_batches == 1)
                pending = (stub.launched_batches, engine._inflight,
                           engine.breaker.state)
                stub.release()
                assert await wait_until(
                    lambda: engine.breaker.state == "closed"
                    and engine._inflight == 0)
                return outs, pending

            outs, pending = run(probe())
            assert outs == [True, True, True]
            assert pending == (1, 1, "half-open")
            spec = engine.lanes.to_json()["speculative_outcomes"]
            assert spec == {"launched": 1, "host-win": 1}
            # SLO burned exactly once for the batch (host side)
            assert engine.slo.total == slo_before + 3
            assert engine._inflight == 0
            return outs, pending, spec, engine.breaker.state
        both(scenario)

    def test_wedged_losing_device_cancelled_past_watchdog(self):
        def scenario(ns):
            engine = build_engine(ns, breaker_threshold=2,
                                  breaker_reset_s=0.02,
                                  device_timeout_s=0.1, slo_ms=1000.0)
            stub = StubDevice(ns, engine)  # never released: wedged
            seed_model(engine, device_rtt_s=0.05)
            engine.lanes.host_max_rows = 0
            trip_to_half_open(engine)
            slo_before = engine.slo.total

            async def probe():
                outs = await submit_all(engine, [doc(0, True),
                                                 doc(1, False)])
                assert outs == [True, False]
                assert await wait_until(lambda: engine._inflight == 0,
                                        timeout=8.0)
                return outs

            outs = run(probe())
            spec = engine.lanes.to_json()["speculative_outcomes"]
            assert spec.get("host-win") == 1
            assert spec.get("device-fail", 0) >= 1
            assert engine.slo.total == slo_before + 2
            assert engine.breaker.state == "open"
            assert stub.launched_batches >= 1
            return outs, spec, engine.breaker.state, stub.launched_batches
        both(scenario)

    def test_device_wins_when_host_is_slow(self):
        def scenario(ns):
            engine = build_engine(ns, breaker_threshold=2,
                                  breaker_reset_s=0.02, slo_ms=1000.0)
            StubDevice(ns, engine, latency_s=0.0)
            seed_model(engine, device_rtt_s=0.02)
            engine.lanes.host_max_rows = 0
            # the host twin decides only after the device answered
            device_answered = threading.Event()
            real = engine._host_decide_batch

            def slow_host(snap, batch, *a, **kw):
                assert device_answered.wait(10.0)
                return real(snap, batch, *a, **kw)

            engine._host_decide_batch = slow_host
            trip_to_half_open(engine)
            slo_before = engine.slo.total

            async def race():
                outs = await submit_all(engine, [doc(0, True)])
                device_answered.set()
                assert await wait_until(
                    lambda: engine.lanes.host_inflight == 0, timeout=5.0)
                return outs

            outs = run(race())
            assert outs == [True]
            spec = engine.lanes.to_json()["speculative_outcomes"]
            assert spec.get("device-win") == 1
            assert spec.get("host-win", 0) == 0
            assert engine.slo.total == slo_before + 1  # burned once (device)
            assert engine.breaker.state == "closed"
            return outs, spec, engine.breaker.state
        both(scenario)

    def test_no_speculation_when_disabled_or_breaker_closed(self):
        def scenario(ns):
            engine = build_engine(ns, speculative_dispatch=False,
                                  breaker_threshold=2, breaker_reset_s=0.02)
            StubDevice(ns, engine, latency_s=0.02)
            seed_model(engine)
            engine.lanes.host_max_rows = 0
            trip_to_half_open(engine)
            off = run(submit_all(engine, [doc(0, True)]))
            assert off == [True]
            assert engine.lanes.to_json()["speculative_outcomes"] == {}
            engine2 = build_engine(ns)
            StubDevice(ns, engine2, latency_s=0.02)
            seed_model(engine2)
            engine2.lanes.host_max_rows = 0
            closed = run(submit_all(engine2, [doc(0, True)]))
            assert closed == [True]
            assert engine2.lanes.to_json()["speculative_outcomes"] == {}
            return off, closed
        both(scenario)

    def test_futures_resolve_exactly_once(self):
        """After the host twin resolved, the device completion for the same
        batch (the stub answers allow-all) must not overwrite it."""
        def scenario(ns):
            engine = build_engine(ns, breaker_threshold=2,
                                  breaker_reset_s=0.02)
            stub = StubDevice(ns, engine)
            seed_model(engine, device_rtt_s=0.15)
            engine.lanes.host_max_rows = 0
            trip_to_half_open(engine)

            async def probe():
                fut = asyncio.ensure_future(engine.submit(doc(0, False), "c"))
                rule, _ = await fut
                first = bool(rule[0])
                stub.release()
                assert await wait_until(lambda: engine._inflight == 0)
                again, _ = fut.result()
                return first, bool(again[0])

            out = run(probe())
            assert out == (False, False)  # the host oracle's exact verdict
            return out, engine.lanes.to_json()["speculative_outcomes"]
        both(scenario)


# ---------------------------------------------------------------------------
# parity: verdict + attribution identical across lanes (3 seeds)
# ---------------------------------------------------------------------------


def rand_corpus(ns, rng, n_cfg=6):
    entries, rules = [], []
    for i in range(n_cfg):
        rule = ns.All(
            ns.Pattern("request.method", ns.Operator.NEQ, "DELETE"),
            ns.Any_(
                ns.Pattern("auth.identity.org", ns.Operator.EQ, f"org-{i}"),
                ns.Pattern("auth.identity.roles", ns.Operator.INCL,
                           f"role-{rng.randrange(4)}"),
            ),
        )
        rules.append(rule)
        entries.append(ns.Entry(
            id=f"cfg-{i}", hosts=[f"h{i}"], runtime=None,
            rules=ns.ConfigRules(name=f"cfg-{i}",
                                 evaluators=[(None, rule)])))
    return entries, rules


def rand_doc(rng):
    return {
        "request": {"method": rng.choice(["GET", "POST", "DELETE"])},
        "auth": {"identity": {
            "org": f"org-{rng.randrange(8)}",
            "roles": [f"role-{rng.randrange(4)}" for _ in range(2)],
        }},
    }


@pytest.mark.parametrize("seed", [7, 23, 91])
def test_lane_parity_verdict_and_attribution(seed):
    """Random traffic through each package's engine with the host lane
    forced on against the device lane: verdicts and firing columns equal
    the host expression oracle on both lanes, and the port's equal the
    reference's."""

    def scenario(ns):
        rng = random.Random(seed)
        entries, rules = rand_corpus(ns, rng)
        docs = [rand_doc(rng) for _ in range(48)]
        which_cfg = [rng.randrange(len(entries)) for _ in docs]

        def serve(force_host: bool):
            engine = ns.make(verdict_cache_size=0, max_batch=8,
                             lane_select=force_host,
                             speculative_dispatch=False)
            engine.apply_snapshot(entries)
            if force_host:
                seed_model(engine, device_rtt_s=10.0)  # host always wins
                engine.lanes.explore_every = 0

            async def go():
                outs = []
                for d, ci in zip(docs, which_cfg):
                    rule, skipped = await engine.submit(d, f"cfg-{ci}")
                    outs.append((np.asarray(rule, dtype=bool),
                                 np.asarray(skipped, dtype=bool)))
                return outs

            out = run(go())
            if force_host:
                assert engine.lanes.to_json()["rows"][ns.ls.HOST] == len(docs)
            return out

        host_outs, dev_outs = serve(True), serve(False)
        seen = []
        for (hr, hs), (dr, ds), d, ci in zip(host_outs, dev_outs, docs,
                                             which_cfg):
            want = bool(rules[ci].matches(d))
            assert bool(hr[0]) == bool(dr[0]) == want
            hf = int(ns.firing(hr[None, :], hs[None, :])[0])
            df = int(ns.firing(dr[None, :], ds[None, :])[0])
            assert hf == df, f"attribution diverged: host {hf} device {df}"
            seen.append((want, hf, hr.tolist(), hs.tolist()))
        return seen

    both(scenario)


def test_mesh_cost_feed_units():
    """cost_feed() is total/healthy: 1.0 with a healthy mesh, rising as
    per-device breakers trip."""

    class _B:
        def __init__(self, state):
            self.state = state

    class _Set:
        def __init__(self, states):
            self.breakers = {i: _B(s) for i, s in enumerate(states)}

    def scenario(ns):
        m = ns.Sharded.__new__(ns.Sharded)
        m.state = SimpleNamespace()
        out = []
        for states in (["closed"] * 4, ["closed", "closed", "open", "open"],
                       ["open"] * 4):
            m.state.breakers = _Set(states)
            out.append(m.cost_feed())
        assert out == [1.0, 2.0, 4.0]
        return out

    both(scenario)
