"""Admission and deadlines in the port's engine.  ``AdmissionController``
and ``AdaptiveWindow`` decide as the JAX package's do over the same feed
sequences with ``now`` injected (hypothesis); the engine answers a typed
RESOURCE_EXHAUSTED past its queue cap and a typed DEADLINE_EXCEEDED for a
doomed request, before encode; ``admission_precheck`` and ``drain``.

No test bounds wall-clock time: each waits on a condition with a generous
timeout of its own."""

import asyncio
import threading
import time

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from authorino_tpu.runtime import admission as r_adm
from authorino_tpu_torch.authjson import CheckRequestModel, HttpRequestAttributes
from authorino_tpu_torch.controllers import translate_auth_config
from authorino_tpu_torch.runtime import PolicyEngine
from authorino_tpu_torch.runtime import admission as p_adm
from authorino_tpu_torch.utils.rpc import (DEADLINE_EXCEEDED,
                                           RESOURCE_EXHAUSTED, UNAVAILABLE,
                                           CheckAbort)

from test_torch_dispatch import (WAIT_S, StubDevice, build_engine, doc, run,
                                 wait_until, wait_until_sync)

# ---- the controllers against the reference's ------------------------------

_dt = st.floats(min_value=0.0, max_value=0.4, allow_nan=False)
_deadline = st.one_of(st.none(), st.floats(min_value=-0.1, max_value=0.5,
                                           allow_nan=False))
_admission_op = st.one_of(
    st.tuples(st.just("waits"), _dt,
              st.lists(st.floats(min_value=0.0, max_value=0.3,
                                 allow_nan=False), min_size=1, max_size=6)),
    st.tuples(st.just("service"), _dt, st.integers(0, 600)),
    st.tuples(st.just("admit"), _dt, st.integers(0, 400), _deadline,
              st.floats(min_value=0.0, max_value=0.2, allow_nan=False)),
    st.tuples(st.just("precheck"), _dt, st.integers(0, 400), _deadline,
              st.floats(min_value=0.0, max_value=0.2, allow_nan=False)),
    st.tuples(st.just("drop"), _dt),
)


def _apply_admission(ctl, op, now):
    kind = op[0]
    if kind == "waits":
        ctl.observe_waits(list(op[2]), now=now)
        return None
    if kind == "service":
        ctl.observe_service(op[2], now=now)
        return None
    if kind in ("admit", "precheck"):
        depth, dl, rtt = op[2], op[3], op[4]
        fn = ctl.admit if kind == "admit" else ctl.precheck
        return fn(depth, now=now, deadline=None if dl is None else now + dl,
                  rtt_s=rtt)
    return ctl.drop_now(now=now)


def _admission_view(ctl, depth=100):
    j = ctl.to_json()
    return (ctl.state, ctl.effective_cap(), ctl.predicted_wait(depth),
            j["queue_wait_ewma_s"], j["service_rate_rps"])


@settings(max_examples=150, deadline=None)
@given(ops=st.lists(_admission_op, min_size=1, max_size=40),
       target=st.sampled_from([0.01, 0.05, 0.2]),
       queue_cap=st.sampled_from([0, 8, 64]),
       min_cap=st.sampled_from([1, 16, 64]))
def test_admission_controller_decides_as_the_reference(ops, target,
                                                       queue_cap, min_cap):
    kw = dict(target_s=target, interval_s=0.5, queue_cap=queue_cap,
              min_cap=min_cap)
    ref = r_adm.AdmissionController("hyp-ref", **kw)
    port = p_adm.AdmissionController("hyp-port", **kw)
    now = 1000.0
    for op in ops:
        now += op[1]
        assert _apply_admission(port, op, now) == \
            _apply_admission(ref, op, now), op
        assert _admission_view(port) == _admission_view(ref), op


_window_op = st.one_of(
    st.tuples(st.just("arrivals"), _dt, st.integers(1, 300)),
    st.tuples(st.just("batch"), _dt,
              st.floats(min_value=0.0, max_value=0.5, allow_nan=False),
              st.integers(1, 256), st.integers(0, 2000)),
)


@settings(max_examples=150, deadline=None)
@given(ops=st.lists(_window_op, min_size=1, max_size=40),
       cap=st.sampled_from([1, 4, 48]), batch_cap=st.sampled_from([8, 256]),
       enabled=st.booleans())
def test_adaptive_window_decides_as_the_reference(ops, cap, batch_cap,
                                                  enabled):
    ref = r_adm.AdaptiveWindow("hyp-ref", cap, batch_cap, enabled=enabled)
    port = p_adm.AdaptiveWindow("hyp-port", cap, batch_cap, enabled=enabled)
    now = 1000.0
    for op in ops:
        now += op[1]
        for w in (ref, port):
            if op[0] == "arrivals":
                w.observe_arrivals(op[2])
            else:
                w.observe_batch(op[2], op[3], op[4], now=now)
        assert (port.window, port.batch_cut, port.to_json()) == \
            (ref.window, ref.batch_cut, ref.to_json()), op
        assert 1 <= port.window <= cap and 1 <= port.batch_cut <= batch_cap


# ---- the engine: typed rejections before encode ----------------------------

async def outcome(coro):
    try:
        rule, _ = await coro
        return bool(rule[0])
    except CheckAbort as e:
        return e


def test_queue_cap_rejects_the_excess_typed_and_counted():
    """A burst past admission_queue_cap: the first ``cap`` queue and are
    answered; the rest answer RESOURCE_EXHAUSTED at admission, never
    reach a batch, and are counted."""
    engine = build_engine(max_batch=64, admission_queue_cap=16)
    dev = StubDevice(engine)

    async def body():
        tasks = [asyncio.ensure_future(outcome(engine.submit(doc(), "c")))
                 for _ in range(40)]
        while not all(t.done() for t in tasks):
            dev.release_all()
            await asyncio.sleep(0.005)
        return [t.result() for t in tasks]

    outs = run(body())
    assert outs[:16] == [True] * 16
    for e in outs[16:]:
        assert isinstance(e, CheckAbort) and e.code == RESOURCE_EXHAUSTED
        assert e.message == "server overloaded (queue-full): admission " \
                            "rejected"
    assert engine.admission.rejected == {"queue-full": 24}
    assert sum(n for _, n in dev.launches) == 16
    assert engine.stats["deadline_shed"] == 0


def test_doomed_deadline_is_rejected_at_admission():
    """A deadline inside the predicted wait + one device round trip answers
    DEADLINE_EXCEEDED at admission; a request without one is served."""
    engine = build_engine()
    dev = StubDevice(engine)
    engine._device_ewma = 5.0   # as if a device round trip took 5 s

    async def body():
        doomed = await outcome(engine.submit(
            doc(), "c", deadline=time.monotonic() + 1.0))
        task = asyncio.ensure_future(outcome(engine.submit(doc(), "c")))
        assert await wait_until(lambda: dev.launches)
        dev.release_all()
        return doomed, await asyncio.wait_for(task, WAIT_S)

    doomed, served = run(body())
    assert isinstance(doomed, CheckAbort) and doomed.code == DEADLINE_EXCEEDED
    assert doomed.message == "rejected at admission: deadline cannot be met"
    assert served is True
    assert engine.admission.rejected == {"doomed-deadline": 1}
    assert engine.stats["deadline_shed"] == 1
    assert sum(n for _, n in dev.launches) == 1


def test_expired_deadline_is_shed_before_encode():
    """A request admitted in time whose deadline passes while it waits for
    a window slot is shed at its cut, typed, and never encoded."""
    engine = build_engine(max_batch=4, max_inflight_batches=1,
                          adaptive_window=False)
    dev = StubDevice(engine)

    async def body():
        first = asyncio.ensure_future(outcome(engine.submit(doc(), "c")))
        assert await wait_until(lambda: len(dev.launches) == 1)
        late = asyncio.ensure_future(outcome(engine.submit(
            doc(), "c", deadline=time.monotonic() + 0.05)))
        keep = asyncio.ensure_future(outcome(engine.submit(doc(), "c")))
        assert await wait_until(lambda: len(engine._queue) == 2)
        await asyncio.sleep(0.1)    # the deadline passes in the queue
        dev.release_all()
        while not (late.done() and keep.done()):
            dev.release_all()
            await asyncio.sleep(0.005)
        return first.result(), late.result(), keep.result()

    first, late, keep = run(body())
    assert first is True and keep is True
    assert isinstance(late, CheckAbort) and late.code == DEADLINE_EXCEEDED
    assert late.message == ("request shed before dispatch: deadline cannot "
                            "be met")
    assert [n for _, n in dev.launches] == [1, 1]
    assert engine.stats["deadline_shed"] == 1
    assert engine.admission.rejected == {}


def test_check_passes_its_deadline_to_the_engine():
    """engine.check carries the Check() deadline into submit: a doomed
    one answers DEADLINE_EXCEEDED from admission, with no batch row."""
    spec = {"hosts": ["d.test"], "authentication": {"a": {"anonymous": {}}},
            "authorization": {"r": {"patternMatching": {"patterns": [
                {"selector": "request.method", "operator": "eq",
                 "value": "GET"}]}}}}
    # lane selection off: its admission floor would admit this deadline
    # (the reference's tests/test_overload.py pins the contract so)
    engine = PolicyEngine(max_batch=8, device="cpu", lane_select=False,
                          brownout=False)
    req = CheckRequestModel(http=HttpRequestAttributes(
        method="GET", path="/", host="d.test"))

    async def body():
        engine.apply_snapshot([await translate_auth_config(
            "d", "ns", spec, engine=engine)])
        ok = await engine.check(req, deadline=time.monotonic() + 60)
        engine._device_ewma = 120.0
        doomed = await engine.check(req, deadline=time.monotonic() + 60)
        return ok, doomed

    ok, doomed = run(body())
    assert ok.code == 0
    assert (doomed.code, doomed.message) == (
        DEADLINE_EXCEEDED, "rejected at admission: deadline cannot be met")
    assert engine.stats["rows"] == 1 and engine.stats["deadline_shed"] == 1


def test_admission_precheck_answers_before_a_pipeline():
    engine = build_engine(max_batch=64, admission_queue_cap=4)
    assert engine.admission_precheck() is None
    for _ in range(4):
        engine._queue.append(None)
    res = engine.admission_precheck()
    assert (res.code, res.message) == (RESOURCE_EXHAUSTED,
                                       "server overloaded (queue-full)")
    assert engine.admission.rejected == {"queue-full": 1}
    engine._queue.clear()
    assert engine.admission_precheck(deadline=time.monotonic()) is None


def test_drain_stops_admission_and_waits_for_inflight_work():
    engine = build_engine(max_batch=4)
    dev = StubDevice(engine)
    drained = []

    async def body():
        tasks = [asyncio.ensure_future(outcome(engine.submit(doc(), "c")))
                 for _ in range(6)]
        assert await wait_until(lambda: len(dev.launches) == 2)
        assert engine.drain(timeout_s=0.05) is False   # two batches held
        assert engine.draining
        late = await outcome(engine.submit(doc(), "c"))
        t = threading.Thread(target=lambda: drained.append(
            engine.drain(timeout_s=WAIT_S)))
        t.start()
        dev.release_all()
        outs = await asyncio.wait_for(asyncio.gather(*tasks), WAIT_S)
        await asyncio.get_running_loop().run_in_executor(
            None, t.join, WAIT_S)
        assert not t.is_alive()
        return late, outs

    late, outs = run(body())
    assert isinstance(late, CheckAbort) and late.code == UNAVAILABLE
    assert late.message == "server draining"
    assert outs == [True] * 6
    assert drained == [True]
    assert wait_until_sync(lambda: engine._inflight == 0)
