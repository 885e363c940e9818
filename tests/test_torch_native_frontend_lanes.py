"""The native frontend's host lanes on a CPU engine, against its own
device slots and against the reference's frontend (the reference's
``runtime/native_frontend.py``: slot-level lane selection and the
brownout spill onto the CPU backend).

The same requests go, one at a time, through the port's frontend with its
host lanes off (every fast-lane slot rides the kernel's plain version),
then with a lane forced on: lane selection by a cost model taught a fast
host and a slow device, brownout by a slot threshold of 0 (every slot
counts as saturating).  The answers must be byte-equal to the device
slots', and equal (decoded, provenance aside, as in
``tests/test_torch_native_frontend.py``) to the reference frontend's with
the same lane forced on, its library loaded through
``tests/torch_ref_native.py``.  Tolerance 0.  On a card the frontend's
host lanes resolve off, and an explicit True raises: held here with an
engine that only names a CUDA device (nothing is started)."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from authorino_tpu.runtime import native_frontend as ref_nf
from authorino_tpu_torch.runtime import native_frontend as port_nf
from torch_ref_native import ref_native_library

from test_torch_native_frontend import (REF, REQUESTS, PortStack, as_dict,
                                        bounded, build_corpus, call)

# every request of the frontend suite: the host lanes answer only the rows
# the C++ side gathers into slots (the slow lane's never reach one)
FAST = REQUESTS


@pytest.fixture(scope="module", autouse=True)
def _ref_native():
    return ref_native_library()


def force_host(lanes):
    """Teach a selector a fast host (10 µs a row) and a slow device
    (100 ms), with no periodic device probe: every small slot rides the
    host lane."""
    lanes.cost.observe_host(1e-4, 10)
    lanes.cost.observe_device(0.1, 8)
    lanes.explore_every = 0


@pytest.fixture(scope="module")
def reference():
    """The reference's engine and frontend with both host lanes on; each
    test forces the lane it holds."""
    engine = REF.PolicyEngine(max_batch=64, mesh=None)
    engine.apply_snapshot(build_corpus(REF, engine))
    fe = ref_nf.NativeFrontend(engine, port=0, max_batch=64, window_us=500,
                               lane_select=True, brownout=True)
    try:
        port = fe.start()
        assert fe.wait_warm(300)
        yield SimpleNamespace(engine=engine, fe=fe, port=port)
    finally:
        fe.stop()


def answers(port, reqs):
    return [call(port, r) for r in reqs]


@bounded(300)
def test_lane_selected_slots_equal_device_slots_and_the_reference(reference):
    stack = PortStack()   # the host lanes off: every slot on the kernel path
    try:
        device = answers(stack.port, FAST)
        slot_rows = stack.fe.counts["rows"]
        assert slot_rows > 0 and stack.fe.lanes.rows["host"] == 0
        assert stack.fe.debug_vars()["lane_select"]["enabled"] is False
    finally:
        stack.close()
    stack = PortStack(lane_select=True)
    try:
        force_host(stack.fe.lanes)
        c0 = dict(stack.fe.counts)
        host = answers(stack.port, FAST)
        rows = dict(stack.fe.lanes.rows)
        decisions = dict(stack.fe.lanes.decisions)
        d_batches = stack.fe.counts["batches"] - c0["batches"]
        warm = stack.fe.debug_vars()["lane_select"]["host_warm_shapes"]
    finally:
        stack.close()
    assert host == device
    # every fast slot rode the host lane: no slot reached the kernel path
    assert rows["host"] == slot_rows and d_batches == 0
    assert set(decisions) == {"host:cost-model"}
    assert [16, 0] in warm or [16, 16] in warm
    reference.fe.lanes.enabled, reference.fe.brownout = True, False
    force_host(reference.fe.lanes)
    r0 = reference.fe.lanes.rows["host"]
    ref = answers(reference.port, FAST)
    assert reference.fe.lanes.rows["host"] - r0 == slot_rows
    assert [as_dict(a, True) for a in host] == [as_dict(b, True) for b in ref]


@bounded(300)
def test_brownout_slots_equal_device_slots_and_the_reference(reference):
    stack = PortStack()
    try:
        device = answers(stack.port, FAST)
        slot_rows = stack.fe.counts["rows"]
    finally:
        stack.close()
    stack = PortStack(brownout=True)
    try:
        stack.fe._brownout_threshold = 0   # every slot saturates the window
        c0 = dict(stack.fe.counts)
        spilled = answers(stack.port, FAST)
        total = stack.fe._brownout_total
        d_batches = stack.fe.counts["batches"] - c0["batches"]
        bv = stack.fe.debug_vars()["brownout"]
    finally:
        stack.close()
    assert spilled == device
    assert total == slot_rows and d_batches == 0
    assert bv["enabled"] is True and bv["decisions"] == total
    reference.fe.lanes.enabled, reference.fe.brownout = False, True
    saved = reference.fe._brownout_threshold
    reference.fe._brownout_threshold = 0
    try:
        b0 = reference.fe._brownout_total
        ref = answers(reference.port, FAST)
        assert reference.fe._brownout_total - b0 == slot_rows
    finally:
        reference.fe._brownout_threshold = saved
    assert [as_dict(a, True) for a in spilled] == \
        [as_dict(b, True) for b in ref]


class _CardEngine:
    """What the frontend's constructor reads of a card engine."""

    device = torch.device("cuda")
    tenancy = None
    host_degrade = False


def test_a_card_frontend_resolves_its_host_lanes_off():
    fe = port_nf.NativeFrontend(_CardEngine(), port=0)
    assert fe.brownout is False and fe.lanes.enabled is False
    assert fe.lanes.decide(1, 0, fe.slots) == ("device", "disabled")
    for kw in ({"lane_select": True}, {"brownout": True}):
        with pytest.raises(ValueError, match="only the mega-kernel"):
            port_nf.NativeFrontend(_CardEngine(), port=0, **kw)
    cpu = SimpleNamespace(device=torch.device("cpu"), tenancy=None,
                          host_degrade=True)
    fe = port_nf.NativeFrontend(cpu, port=0)
    assert fe.brownout is True and fe.lanes.enabled is True
    assert fe.lanes.speculative is False   # an engine feature only
