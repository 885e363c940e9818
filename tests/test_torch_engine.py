"""The port's micro-batching PolicyEngine against the JAX package's engine:
the same entries and concurrent submits give the same (rule, skipped) per
request (booleans, tolerance 0), and a burst of at most ``max_batch``
submits costs exactly one batch through the kernel's entry point."""

import asyncio

import numpy as np
import pytest

from authorino_tpu.runtime import EngineEntry as RefEntry
from authorino_tpu.runtime import PolicyEngine as RefEngine
from authorino_tpu_torch.models import northstar
from authorino_tpu_torch.models.policy_model import host_results
from authorino_tpu_torch.ops import fused_kernel as p_fk
from authorino_tpu_torch.runtime import EngineEntry, PolicyEngine
from authorino_tpu_torch.utils.rpc import UNAVAILABLE, CheckAbort

from test_torch_compiler import REF, all_lanes_corpus, all_lanes_docs, \
    convert_config


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


async def submit_all(engine, docs, names):
    return await asyncio.gather(*(engine.submit(d, n)
                                  for d, n in zip(docs, names)))


def corpus(kind):
    if kind == "lanes":
        return (all_lanes_corpus(7, REF), None, 4, all_lanes_docs(7, 48))
    port = northstar.build_corpus(40, 10)
    return ([convert_config(c, REF) for c in port], port, 16,
            northstar.build_docs(48, seed=3))


@pytest.mark.parametrize("kind,ovf_assist", [("lanes", True),
                                             ("lanes", False),
                                             ("northstar", False)])
def test_engine_matches_reference_engine(kind, ovf_assist):
    from test_torch_compiler import PORT, all_lanes_corpus as lanes

    r_cfgs, p_cfgs, k, docs = corpus(kind)
    if p_cfgs is None:
        p_cfgs = lanes(7, PORT)
    names = [r_cfgs[i % len(r_cfgs)].name for i in range(len(docs))]

    ref = RefEngine(max_batch=32, members_k=k, mesh=None,
                    ovf_assist=ovf_assist, lane_select=False,
                    kernel_lane="fused")
    ref.apply_snapshot([RefEntry(id=c.name, hosts=[c.name], runtime=None,
                                 rules=c) for c in r_cfgs])
    port = PolicyEngine(max_batch=32, members_k=k, ovf_assist=ovf_assist,
                        device="cpu", lane_select=False)
    port.apply_snapshot([EngineEntry(id=c.name, hosts=[c.name], rules=c)
                         for c in p_cfgs])

    want = run(submit_all(ref, docs, names))
    got = run(submit_all(port, docs, names))
    for i, ((wr, ws), (gr, gs)) in enumerate(zip(want, got)):
        assert np.asarray(wr).tolist() == gr.tolist(), i
        assert np.asarray(ws).tolist() == gs.tolist(), i
    assert port.stats["batches"] == 2  # 48 submits, max_batch 32
    assert port.stats["rows"] == 48


def test_burst_costs_one_batch_and_one_plain_call():
    # dedup and the verdict cache off: every row reaches the kernel's entry
    # point (the contract with them on is tests/test_torch_dedup_cache.py's)
    cfgs = northstar.build_corpus(20, 10)
    # and the host lanes off: a one-row cut would ride the host oracle
    engine = PolicyEngine(max_batch=64, device="cpu", verdict_cache_size=0,
                          batch_dedup=False, lane_select=False,
                          brownout=False)
    engine.apply_snapshot([EngineEntry(id=c.name, hosts=[c.name], rules=c)
                           for c in cfgs])
    policy = engine._snapshot.policy
    docs = northstar.build_docs(64, seed=11)
    names = [f"cfg-{i % 20}" for i in range(64)]
    c0 = p_fk.plain_calls
    out = run(submit_all(engine, docs, names))
    assert p_fk.plain_calls - c0 == 1
    st = engine.stats
    assert (st["batches"], st["plain_calls"], st["launches"]) == (1, 1, 0)
    assert st["d2h_bytes"] == st["pad_rows"] * policy.fused_pack_w == 64
    for (rule, skipped), d, n in zip(out, docs, names):
        _, w_rule, w_skip = host_results(policy, d, policy.config_ids[n])
        assert rule.tolist() == w_rule.tolist()
        assert skipped.tolist() == w_skip.tolist()

    # one more than max_batch: two cuts, the second padded to 16 rows
    run(submit_all(engine, docs + docs[:1], names + names[:1]))
    assert st["batches"] == 3 and st["pad_rows"] == 64 + 64 + 16


def test_unknown_config_and_missing_snapshot_raise():
    """No snapshot: the typed UNAVAILABLE the reference answers (nothing
    can decide the request); an unknown config: queued as the
    reference's, and its row answered UNAVAILABLE at the encode stage,
    the reference's answer after its part's retry and degrade."""
    engine = PolicyEngine(device="cpu")
    with pytest.raises(CheckAbort, match="snapshot") as info:
        run(engine.submit({}, "nope"))
    assert info.value.code == UNAVAILABLE
    engine.apply_snapshot([EngineEntry(
        id=c.name, hosts=[c.name], rules=c)
        for c in northstar.build_corpus(2, 4)])
    with pytest.raises(CheckAbort,
                       match="policy evaluation unavailable") as info:
        run(engine.submit({}, "nope"))
    assert info.value.code == UNAVAILABLE
