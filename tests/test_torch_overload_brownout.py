"""The port's brownout against the JAX package's (``tests/test_overload.py``
``TestBrownout`` and ``TestDrainUnderOverload::
test_drain_resolves_backlog_including_brownout_jobs``).

Each case runs the reference's scenario through the reference's engine
(JAX on the CPU) and the port's CPU engine, both at the reference's
defaults (brownout and lane selection on), with a stub device that holds
the window saturated; verdicts must equal the host oracle's and each
other's, tolerance 0, and the reference test's own assertions hold on both
runs.  Both packages record into one Prometheus registry here, so the
brownout counter is read as a delta around each package's run."""

from __future__ import annotations

import asyncio
import time

import pytest
from prometheus_client import REGISTRY

from test_torch_lane_select import PORT, REF, StubDevice, both, doc, run


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


def brownout_decisions() -> float:
    v = REGISTRY.get_sample_value("auth_server_brownout_decisions_total",
                                  {"lane": "engine"})
    return 0.0 if v is None else v


class TestBrownout:
    def test_brownout_verdicts_bit_identical_to_oracle(self):
        """With the window saturated, queued requests spill to the host
        lane and their verdicts are exact, the membership-overflow row the
        compact device payload is lossy for included."""
        over = {"auth": {"identity": {
            "roles": [f"r{k}" for k in range(10)] + ["admin"],
            "groups": []}}}
        docs = [doc(i, i % 3 != 0) for i in range(9)] + [over]

        def scenario(ns):
            expected = [bool(rule_of(ns).matches(d)) for d in docs]
            engine = build_engine(ns, max_batch=4, max_inflight_batches=1,
                                  admission_target_s=0.001,
                                  brownout_max_batch=16)
            stub = StubDevice(ns, engine, latency_s=0.8)
            b0 = brownout_decisions()

            async def burst():
                first = asyncio.ensure_future(engine.submit(doc(100, True),
                                                            "c"))
                await asyncio.sleep(0.02)  # window (1) saturated
                queued = [asyncio.ensure_future(engine.submit(d, "c"))
                          for d in docs]
                await asyncio.sleep(0.05)  # head-of-queue age past target/2
                trigger = asyncio.ensure_future(
                    engine.submit(doc(101, True), "c"))
                out = await asyncio.wait_for(asyncio.gather(*queued),
                                             timeout=5)
                await asyncio.gather(first, trigger)
                return [bool(r[0]) for r, _ in out]

            got = run(burst())
            assert got == expected
            assert brownout_decisions() >= b0 + len(docs)
            assert engine._brownout_total >= len(docs)
            # brownout is not a device failure: the breaker untouched
            assert engine.breaker.state == "closed"
            assert stub.launched_batches >= 1
            return got, engine.breaker.state

        both(scenario)

    def test_brownout_rescues_deadlines_the_device_could_not_meet(self):
        """The brownout lane sheds at horizon 0, not the device round
        trip: a deadline the device's inflated estimate could not meet is
        served, not shed DEADLINE_EXCEEDED."""
        def scenario(ns):
            engine = build_engine(ns, max_batch=4, max_inflight_batches=1,
                                  admission_target_s=0.001,
                                  brownout_max_batch=16)
            StubDevice(ns, engine, latency_s=0.8)

            async def burst():
                first = asyncio.ensure_future(engine.submit(doc(100, True),
                                                            "c"))
                await asyncio.sleep(0.02)  # window (1) saturated
                queued = [asyncio.ensure_future(
                    engine.submit(doc(i, True), "c",
                                  deadline=time.monotonic() + 1.0))
                    for i in range(4)]
                await asyncio.sleep(0.05)
                # the device estimate inflates after they queued: their 1 s
                # deadlines now land inside one device round trip
                engine._device_ewma = 5.0
                trigger = asyncio.ensure_future(
                    engine.submit(doc(101, True), "c"))
                out = await asyncio.wait_for(asyncio.gather(*queued),
                                             timeout=5)
                await asyncio.gather(first, trigger)
                return [bool(r[0]) for r, _ in out]

            got = run(burst())
            assert got == [True] * 4
            assert engine._brownout_total >= 4
            return got

        both(scenario)

    def test_brownout_off_keeps_requests_queued(self):
        def scenario(ns):
            engine = build_engine(ns, max_batch=4, max_inflight_batches=1,
                                  admission_target_s=0.001, brownout=False)
            StubDevice(ns, engine, latency_s=0.3)

            async def burst():
                tasks = [asyncio.ensure_future(engine.submit(doc(i, True),
                                                             "c"))
                         for i in range(8)]
                await asyncio.sleep(0.1)
                # nothing spilled: one batch in flight, the rest queued
                spilled = engine._brownout_total
                out = await asyncio.wait_for(asyncio.gather(*tasks),
                                             timeout=5)
                return spilled, [bool(r[0]) for r, _ in out]

            spilled, out = run(burst())
            assert spilled == 0
            assert len(out) == 8
            return spilled, out, engine.debug_vars()["brownout"]["enabled"]

        assert both(scenario)[2] is False

    def test_brownout_concurrency_is_bounded(self):
        def scenario(ns):
            engine = build_engine(ns, max_batch=2, max_inflight_batches=1,
                                  admission_target_s=0.001,
                                  brownout_max_batch=2)
            StubDevice(ns, engine, latency_s=0.5)
            assert engine._brownout_limit >= 1

            async def burst():
                tasks = [asyncio.ensure_future(engine.submit(doc(i, True),
                                                             "c"))
                         for i in range(30)]
                peak = 0
                for _ in range(50):
                    await asyncio.sleep(0.01)
                    peak = max(peak, engine._brownout_inflight)
                out = await asyncio.wait_for(asyncio.gather(*tasks),
                                             timeout=10)
                return peak, [bool(r[0]) for r, _ in out]

            peak, out = run(burst())
            assert peak <= engine._brownout_limit
            assert engine._brownout_inflight == 0
            assert all(out)
            return engine._brownout_limit, out

        both(scenario)


class TestDrainUnderOverload:
    def test_drain_resolves_backlog_including_brownout_jobs(self):
        def scenario(ns):
            engine = build_engine(ns, max_batch=4, max_inflight_batches=1,
                                  admission_target_s=0.001)
            StubDevice(ns, engine, latency_s=0.15)

            async def burst():
                tasks = [asyncio.ensure_future(engine.submit(doc(i, True),
                                                             "c"))
                         for i in range(24)]
                await asyncio.sleep(0.05)
                loop = asyncio.get_running_loop()
                drained = await loop.run_in_executor(None, engine.drain, 5.0)
                done = await asyncio.gather(*tasks, return_exceptions=True)
                return drained, done

            drained, done = run(burst())
            assert drained is True
            assert engine._brownout_inflight == 0 and engine._inflight == 0
            assert engine.lanes.host_inflight == 0
            assert all(not isinstance(r, Exception) for r in done)
            return drained, [bool(r[0][0]) for r in done]

        both(scenario)


@pytest.mark.parametrize("with_overflow", [False, True])
def test_brownout_and_device_batches_equal_the_oracle_row_for_row(
        with_overflow):
    """The brownout lane's (rule, skipped) columns equal the device path's
    for the same requests on each package, and the port's equal the
    reference's: what a request is answered does not depend on the lane."""
    docs = [doc(i, i % 2 == 0) for i in range(12)]
    if with_overflow:
        docs.append({"auth": {"identity": {
            "roles": [f"r{k}" for k in range(9)] + ["admin"],
            "groups": ["banned"]}}})

    def scenario(ns):
        outs = {}
        for lane in ("device", "brownout"):
            engine = build_engine(ns, max_batch=4, lane_select=False,
                                  brownout=(lane == "brownout"),
                                  max_inflight_batches=1,
                                  admission_target_s=0.001,
                                  brownout_max_batch=16)
            if lane == "brownout":
                StubDevice(ns, engine, latency_s=0.5)

            async def burst():
                first = None
                if lane == "brownout":
                    first = asyncio.ensure_future(
                        engine.submit(doc(100, True), "c"))
                    await asyncio.sleep(0.02)
                tasks = [asyncio.ensure_future(engine.submit(d, "c"))
                         for d in docs]
                await asyncio.sleep(0.02)
                trigger = asyncio.ensure_future(
                    engine.submit(doc(101, True), "c"))
                out = await asyncio.wait_for(asyncio.gather(*tasks),
                                             timeout=10)
                await asyncio.gather(trigger, *([first] if first else []))
                return [(list(map(bool, r)), list(map(bool, s)))
                        for r, s in out]

            outs[lane] = run(burst())
            if lane == "brownout":
                assert engine._brownout_total >= len(docs)
        assert outs["device"] == outs["brownout"]
        return outs["device"]

    both(scenario)
