"""The port engine's completion-driven dispatch window, on stub devices
(the JAX package's ``tests/test_pipeline_dispatch.py`` cases, on the port's
``_Inflight``): the window bounds launched batches as a counter, batches
resolve in arrival order rather than launch order, a lone request is cut at
once, the dispatch path never waits on a readback, in-flight batches keep
their snapshot across a swap, a loop closed under a batch is survivable, a
failed batch is retried once and then re-decided exactly by the host oracle
(the reference's degrade) on a CPU engine and answered a typed UNAVAILABLE
on a card, and the watchdog abandons a wedged readback.

No test bounds wall-clock time: each waits on a condition with a generous
timeout of its own."""

import asyncio
import sys
import threading
import time

import numpy as np
import pytest
import torch

from authorino_tpu_torch.compiler import ConfigRules
from authorino_tpu_torch.compiler.encode import encode_batch
from authorino_tpu_torch.compiler.pack import pack_batch
from authorino_tpu_torch.expressions import Operator, Pattern
from authorino_tpu_torch.ops import fused_kernel as fk
from authorino_tpu_torch.ops.operands import to_device
from authorino_tpu_torch.runtime import EngineEntry, PolicyEngine
from authorino_tpu_torch.runtime import engine as engine_mod
from authorino_tpu_torch.utils.rpc import UNAVAILABLE, CheckAbort

RULE_ACME = Pattern("auth.identity.org", Operator.EQ, "acme")
RULE_EVIL = Pattern("auth.identity.org", Operator.EQ, "evil")
WAIT_S = 30.0


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def entries(rule):
    return [EngineEntry(id="c", hosts=["c"], rules=ConfigRules(
        name="c", evaluators=[(None, rule)]))]


def build_engine(rule=RULE_ACME, **kw) -> PolicyEngine:
    kw.setdefault("max_batch", 8)
    # the device path's contract: the host lanes off, as the reference's
    # tests pin it (tests/test_overload.py), or a small cut may ride the
    # host oracle instead of the stub device
    for knob in ("lane_select", "brownout", "speculative_dispatch"):
        kw.setdefault(knob, False)
    engine = PolicyEngine(members_k=4, device="cpu", **kw)
    engine.apply_snapshot(entries(rule))
    return engine


def doc(org="acme"):
    return {"auth": {"identity": {"org": org}}}


class FakeHandle:
    """A stub readback: ready once released; ``wait`` raises ``error``
    when one is set."""

    def __init__(self, error=None):
        self.evt = threading.Event()
        self.error = error

    def is_ready(self) -> bool:
        return self.evt.is_set()

    def wait(self):
        if self.error is not None:
            raise self.error
        return np.zeros((1, 1), dtype=np.uint8)


class StubDevice:
    """Replaces the engine's encode-and-launch step with one whose batches
    complete only when released; records launches and the batches in
    flight.  ``launch_error`` makes every launch raise; ``read_error``
    makes every readback raise."""

    def __init__(self, engine, allow=True, launch_error=None,
                 read_error=None):
        self.engine = engine
        self.allow = allow
        self.launch_error = launch_error
        self.read_error = read_error
        self.launches = []          # [(FakeHandle, batch size)]
        self.attempts = 0
        self.lock = threading.Lock()
        self.concurrent = 0
        self.peak = 0
        engine._encode_and_launch = self._launch

    def release_all(self):
        with self.lock:
            for h, _ in self.launches:
                h.evt.set()

    def _launch(self, snap, batch):
        n = len(batch)
        with self.lock:
            self.attempts += 1
            if self.launch_error is not None:
                raise self.launch_error
            handle = FakeHandle(self.read_error)
            self.concurrent += 1
            self.peak = max(self.peak, self.concurrent)
            self.launches.append((handle, n))

        def finalize(packed):
            with self.lock:
                self.concurrent -= 1
            return (np.full((n, 1), self.allow, dtype=bool),
                    np.zeros((n, 1), dtype=bool))

        binfo = {"batch_size": n, "device_rows": n, "t0": time.monotonic()}
        return engine_mod._Inflight(self.engine, batch, handle, finalize,
                                    binfo, np.zeros(n))


async def wait_until(cond, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        await asyncio.sleep(0.005)
    return cond()


def wait_until_sync(cond, timeout=WAIT_S):
    """Futures resolve before the completion stage's own bookkeeping (the
    slot release): poll instead of racing it."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.005)
    return cond()


def test_three_batches_in_flight_and_resolution_ignores_launch_order():
    """Three batches in flight at once, and the last launched resolves
    while the first two are still on the wire."""
    engine = build_engine(max_batch=4, max_inflight_batches=8)
    dev = StubDevice(engine)

    async def body():
        tasks = [asyncio.ensure_future(engine.submit(doc(), "c"))
                 for _ in range(12)]
        assert await wait_until(lambda: len(dev.launches) == 3)
        assert dev.concurrent == 3 and engine._inflight == 3
        assert not any(t.done() for t in tasks)
        dev.launches[2][0].evt.set()
        late = await asyncio.wait_for(asyncio.gather(*tasks[8:]), WAIT_S)
        assert all(bool(r[0]) for r, _ in late)
        assert not any(t.done() for t in tasks[:8])
        assert dev.concurrent == 2
        dev.release_all()
        early = await asyncio.wait_for(asyncio.gather(*tasks[:8]), WAIT_S)
        assert all(bool(r[0]) for r, _ in early)

    run(body())
    assert dev.peak == 3 and engine.inflight_peak == 3
    assert wait_until_sync(lambda: engine._inflight == 0)


def test_window_bounds_inflight_as_counter():
    """With max_inflight_batches=2 and six batches' worth queued, exactly
    two launch; each completion cuts the next."""
    engine = build_engine(max_batch=2, max_inflight_batches=2)
    dev = StubDevice(engine)

    async def body():
        tasks = [asyncio.ensure_future(engine.submit(doc(), "c"))
                 for _ in range(12)]
        assert await wait_until(lambda: len(dev.launches) == 2)
        # the window is full: the rest stays queued, nothing else launches
        assert engine._inflight == 2 and len(engine._queue) == 8
        for _ in range(5):
            await asyncio.sleep(0)
        assert len(dev.launches) == 2
        dev.launches[0][0].evt.set()   # one slot frees → one more batch
        assert await wait_until(lambda: len(dev.launches) == 3)
        assert len(engine._queue) == 6
        while not all(t.done() for t in tasks):
            dev.release_all()
            await asyncio.sleep(0.005)
        return await asyncio.gather(*tasks)

    outs = run(body())
    assert len(outs) == 12 and len(dev.launches) == 6
    assert dev.peak == 2 and engine.inflight_peak == 2


def test_light_load_cuts_a_lone_request_at_once():
    """A lone request with an open window is cut in the loop iteration
    after its submit: no timer, no wait for a fuller batch."""
    engine = build_engine()
    dev = StubDevice(engine)

    async def body():
        task = asyncio.ensure_future(engine.submit(doc(), "c"))
        await asyncio.sleep(0)   # the submit runs and schedules the cut
        assert len(engine._queue) == 1 and engine._inflight == 0
        await asyncio.sleep(0)   # the cut
        assert len(engine._queue) == 0 and engine._inflight == 1
        assert await wait_until(lambda: len(dev.launches) == 1)
        assert dev.launches[0][1] == 1
        dev.release_all()
        return await asyncio.wait_for(task, WAIT_S)

    rule, _ = run(body())
    assert bool(rule[0])


def test_dispatch_path_never_waits_on_a_readback():
    """Four batches all launch while no readback has arrived: nothing on
    the dispatch path waits on the device."""
    engine = build_engine(max_batch=4, max_inflight_batches=8)
    dev = StubDevice(engine)

    async def body():
        tasks = [asyncio.ensure_future(engine.submit(doc(), "c"))
                 for _ in range(16)]
        assert await wait_until(lambda: len(dev.launches) == 4)
        assert not any(h.evt.is_set() for h, _ in dev.launches)
        assert not any(t.done() for t in tasks)
        dev.release_all()
        return await asyncio.wait_for(asyncio.gather(*tasks), WAIT_S)

    outs = run(body())
    assert len(outs) == 16 and dev.peak == 4


def test_inflight_batches_survive_snapshot_swap():
    """Batches cut against generation G resolve with G's verdicts while
    apply_snapshot swaps to G+1."""
    engine = build_engine(rule=RULE_ACME, max_batch=4, verdict_cache_size=0)
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
        pre = [asyncio.ensure_future(engine.submit(doc("acme"), "c"))
               for _ in range(8)]
        assert await wait_until(lambda: len(gated_launches) >= 2)
        gen = engine.generation
        engine._encode_and_launch = real
        engine.apply_snapshot(entries(RULE_EVIL))
        assert engine.generation == gen + 1
        post = await asyncio.wait_for(asyncio.gather(
            *(engine.submit(doc("acme"), "c") for _ in range(4))), WAIT_S)
        assert not any(bool(r[0]) for r, _ in post)  # G+1: acme denied
        assert not any(t.done() for t in pre)        # G still in flight
        gate.set()
        outs = await asyncio.wait_for(asyncio.gather(*pre), WAIT_S)
        assert all(bool(r[0]) for r, _ in outs)      # G: acme allowed
        assert {item.snap.generation for item in gated_launches} == {gen}

    run(body())


def test_loop_closed_before_completion_is_survivable():
    """A loop that dies with a batch in flight: its futures are moot, the
    slot frees, and fresh loops are served."""
    engine = build_engine(max_batch=2)
    dev = StubDevice(engine)

    async def launch_and_abandon():
        asyncio.ensure_future(engine.submit(doc(), "c"))
        assert await wait_until(lambda: len(dev.launches) == 1)

    loop = asyncio.new_event_loop()
    try:
        loop.run_until_complete(launch_and_abandon())
    finally:
        loop.close()
    dev.release_all()
    assert wait_until_sync(lambda: engine._inflight == 0)
    del engine._encode_and_launch  # the real step again
    rule, _ = run(engine.submit(doc(), "c"))
    assert bool(rule[0])


def test_no_per_loop_state_accumulates():
    engine = build_engine()

    async def three():
        return await asyncio.gather(*(engine.submit(doc(), "c")
                                      for _ in range(3)))

    for _ in range(6):
        assert all(bool(r[0]) for r, _ in run(three()))
    assert len(engine._queue) == 0
    assert wait_until_sync(lambda: engine._inflight == 0)


@pytest.mark.parametrize("where", ["launch", "readback"])
def test_batch_error_reaches_every_future_typed_after_one_retry(where):
    """Every future of a failing batch answers the host oracle's exact
    verdict after exactly one retry per batch (the reference's degrade);
    the raw error never reaches a caller.  The breaker's threshold is out
    of reach, so every batch takes its retry."""
    engine = build_engine(max_batch=4, breaker_threshold=100)
    err = RuntimeError("device lost: secret detail")
    dev = StubDevice(engine, **{f"{'launch' if where == 'launch' else 'read'}"
                                f"_error": err})

    async def one(d):
        try:
            await engine.submit(d, "c")
        except CheckAbort as e:
            return e
        return None

    async def body():
        tasks = [asyncio.ensure_future(one(doc())) for _ in range(10)]
        while not all(t.done() for t in tasks):
            dev.release_all()
            await asyncio.sleep(0.005)
        return [t.result() for t in tasks]

    outs = run(body())
    assert outs == [None] * 10     # every request answered, none aborted
    st = engine.stats
    assert dev.attempts == 6                     # 3 batches, each twice
    assert (st["retries"], st["failed_batches"]) == (3, 0)
    assert (st["degraded_batches"], st["degraded_rows"]) == (3, 10)
    assert [r["degraded"] for r in engine.batch_records] == \
        ["device-failure"] * 3
    assert wait_until_sync(lambda: engine._inflight == 0)


def test_watchdog_abandons_a_wedged_readback():
    """A readback that never arrives is abandoned after device_timeout_s,
    retried once, then re-decided exactly by the host oracle; both
    attempts are counted, and the watchdog drops each abandoned handle."""
    engine = build_engine(max_batch=4, device_timeout_s=0.05)
    dev = StubDevice(engine, allow=False)   # never released; never read
    released = []
    FakeHandle.release = lambda self: released.append(self)
    try:
        rule, _ = run(asyncio.wait_for(engine.submit(doc(), "c"), WAIT_S))
    finally:
        del FakeHandle.release
    assert bool(rule[0])                  # the oracle's verdict for "acme"
    assert dev.attempts == 2
    assert [h for h, _ in dev.launches] == released
    st = engine.stats
    assert (st["watchdog_timeouts"], st["retries"], st["failed_batches"]) \
        == (2, 1, 0)
    assert st["degraded_rows"] == 1
    assert wait_until_sync(lambda: engine._inflight == 0)


@pytest.mark.parametrize("where", ["launch", "readback"])
def test_card_engine_answers_a_failed_batch_unavailable(where):
    """On a card engine (the device type is all it reads) every future of
    a batch that fails twice answers the typed CheckAbort(UNAVAILABLE),
    never the host oracle's verdict; the raw error never reaches a
    caller."""
    engine = build_engine(max_batch=4, breaker_threshold=100)
    engine.device = torch.device("cuda")
    err = RuntimeError("device lost: secret detail")
    dev = StubDevice(engine, **{f"{'launch' if where == 'launch' else 'read'}"
                                f"_error": err})

    async def body():
        tasks = [asyncio.ensure_future(engine.submit(doc(), "c"))
                 for _ in range(10)]
        while not all(t.done() for t in tasks):
            dev.release_all()
            await asyncio.sleep(0.005)
        return [t.exception() for t in tasks]

    outs = run(body())
    assert all(isinstance(e, CheckAbort) and e.code == UNAVAILABLE
               and e.message == "policy evaluation unavailable"
               and "secret" not in repr(e) for e in outs)
    st = engine.stats
    assert dev.attempts == 6                     # 3 batches, each twice
    assert (st["retries"], st["failed_batches"]) == (3, 3)
    assert (st["degraded_batches"], st["degraded_rows"]) == (0, 0)
    assert wait_until_sync(lambda: engine._inflight == 0)


def test_card_engine_watchdog_answers_unavailable():
    """On a card engine a readback wedged past device_timeout_s twice is
    abandoned (each handle released) and answered UNAVAILABLE."""
    engine = build_engine(max_batch=4, device_timeout_s=0.05)
    engine.device = torch.device("cuda")
    dev = StubDevice(engine)   # never released
    released = []
    FakeHandle.release = lambda self: released.append(self)
    try:
        with pytest.raises(CheckAbort) as info:
            run(asyncio.wait_for(engine.submit(doc(), "c"), WAIT_S))
    finally:
        del FakeHandle.release
    assert info.value.code == UNAVAILABLE
    assert dev.attempts == 2
    assert [h for h, _ in dev.launches] == released
    st = engine.stats
    assert (st["watchdog_timeouts"], st["retries"], st["failed_batches"],
            st["degraded_rows"]) == (2, 1, 1, 0)
    assert wait_until_sync(lambda: engine._inflight == 0)


def test_card_engine_open_breaker_keeps_batches_off_the_card():
    """On a card engine an open breaker answers whole batches UNAVAILABLE
    without an attempt on the device, until its cooldown lets one probe
    batch through; the probe's success closes it."""
    engine = build_engine(max_batch=4, breaker_threshold=1,
                          breaker_reset_s=60.0)
    engine.device = torch.device("cuda")
    dev = StubDevice(engine, launch_error=RuntimeError("launch failed"))

    async def one():
        try:
            return await engine.submit(doc(), "c")
        except CheckAbort as e:
            return e

    outs = [run(one()) for _ in range(4)]
    assert [e.message for e in outs] == ["engine device circuit open"] * 4
    # the first batch's one attempt tripped the breaker; its retry and the
    # other batches never reached the device
    assert dev.attempts == 1
    st = engine.stats
    assert (st["failed_batches"], st["breaker_open_batches"]) == (4, 4)
    dev.launch_error = None
    engine.breaker.reset_s = 0.0
    dev.allow = True
    task = None

    async def probe():
        nonlocal task
        task = asyncio.ensure_future(engine.submit(doc(), "c"))
        while not task.done():
            dev.release_all()
            await asyncio.sleep(0.005)
        return task.result()

    rule, _ = run(probe())
    assert bool(rule[0]) and dev.attempts == 2
    assert engine.breaker.state == "closed"
    assert wait_until_sync(lambda: engine._inflight == 0)


def test_cpu_batches_run_on_the_encode_pool_and_resolve_on_their_loop():
    """The real CPU path: encode and the plain version run on the pool's
    threads, never the event loop's, and every future resolves on the
    loop that submitted it."""
    engine = build_engine(max_batch=4)
    seen = []
    real = engine._encode_and_launch

    def spy(snap, batch):
        seen.append(threading.current_thread().name)
        return real(snap, batch)

    engine._encode_and_launch = spy

    async def body():
        loop = asyncio.get_running_loop()
        outs = await asyncio.gather(*(engine.submit(doc(o), "c")
                                      for o in ("acme", "evil") * 6))
        return loop, outs

    _, outs = run(body())
    assert [bool(r[0]) for r, _ in outs] == [True, False] * 6
    assert len(seen) == 3
    assert all(name.startswith("authz-engine-encode") for name in seen)


def test_counts_survive_concurrent_batches_and_threads():
    """Stress, with the interpreter switching threads as often as it can:
    32 batches through the four encode workers at once keep every engine
    count exact, and 16 threads calling the kernel's entry point at once
    lose no count of the wrapper's."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        engine = build_engine(max_batch=2, verdict_cache_size=0,
                              batch_dedup=False)

        async def burst():
            return await asyncio.gather(*(engine.submit(doc(o), "c")
                                          for o in ("acme", "evil") * 32))

        outs = run(burst())
        assert [bool(r[0]) for r, _ in outs] == [True, False] * 32
        assert wait_until_sync(lambda: engine._inflight == 0)
        st = engine.stats
        assert (st["batches"], st["rows"], st["plain_calls"],
                st["pad_rows"]) == (32, 64, 32, 32 * 16)
        assert len(engine.batch_records) == 32

        policy = engine._snapshot.policy
        params = to_device(policy, device="cpu")
        db = pack_batch(policy, encode_batch(policy, [doc()], [0]))
        c0 = fk.plain_calls
        threads = [threading.Thread(target=lambda: [
            fk.eval_fused_kernel(params, db) for _ in range(8)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
            assert not t.is_alive()
        assert fk.plain_calls - c0 == 16 * 8
    finally:
        sys.setswitchinterval(interval)
