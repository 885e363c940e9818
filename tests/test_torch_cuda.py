"""The port's CUDA kernels on a card, against their plain PyTorch versions
on the same card (byte for byte: the outputs are uint8 bitmasks).

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed; on a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Without a card every test skips."""

import asyncio
import random

import numpy as np
import pytest
import torch

from authorino_tpu_torch.compiler import compile_corpus
from authorino_tpu_torch.compiler.encode import encode_batch
from authorino_tpu_torch.compiler.pack import pack_batch
from authorino_tpu_torch.models import PolicyModel, corpora, northstar
from authorino_tpu_torch.models.policy_model import host_results
from authorino_tpu_torch.ops import fused_kernel as fk
from authorino_tpu_torch.ops.operands import (check_batch, fuse_batch,
                                              packed_width, to_device)
from authorino_tpu_torch.runtime import EngineEntry, PolicyEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def lanes_case(seed, assist):
    policy = compile_corpus(corpora.all_lanes_corpus(seed),
                            members_k=corpora.LANES_K, ovf_assist=assist)
    docs = corpora.all_lanes_docs(seed, 48)
    rng = random.Random(seed)
    rows = [rng.randrange(policy.n_configs) for _ in docs]
    return policy, docs, rows


# how a case launches the kernel: through the wrapper as the engine does
# (DFA tables in shared memory), or with the instance that reads the tables
# from device memory forced
INSTANCES = {"wrapper": None, "global_tables": {"global_tables": True}}


def launch(params, db, instance, dev):
    """One kernel launch on ``db``; returns the [B, W] readback."""
    if INSTANCES[instance] is None:
        return fk.eval_fused_kernel(params, db)
    check_batch(params, db)
    buf, layout = fuse_batch(db)
    out = torch.empty((db.attrs_val.shape[0],
                       packed_width(1 + 2 * params["eval_rule"].shape[1])),
                      dtype=torch.uint8, device=dev)
    fk.launch_kernel(params, torch.from_numpy(buf).to(dev), layout, out,
                     **INSTANCES[instance])
    return out


@pytest.mark.parametrize("instance", ["wrapper", "global_tables"])
@pytest.mark.parametrize("seed", [7, 19, 31])
@pytest.mark.parametrize("assist", [True, False])
@pytest.mark.parametrize("wide", [False, True])
def test_kernel_matches_plain_on_all_lanes(card, seed, assist, wide,
                                           instance):
    policy, docs, rows = lanes_case(seed, assist)
    db = pack_batch(policy, encode_batch(policy, docs, rows, batch_pad=33))
    db = corpora.widen_wire(db) if wide else db
    l0 = fk.launches
    got = launch(to_device(policy, device=card), db, instance, card)
    assert fk.launches - l0 == 1
    want = fk.eval_fused_kernel(to_device(policy, device="cpu"), db)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def mixed_rows(params, B):
    """Row configs alternating between the corpus's smallest and largest
    subcircuits, so every block holds rows of unequal sizes."""
    off = params["kernel"]["cfg_off"].cpu().numpy()
    size = np.diff(off[:, 0]) + np.diff(off[:, 1]) + np.diff(off[:, 2])
    order = np.argsort(size, kind="stable")
    small, large = order[:B // 2], order[::-1][:B - B // 2]
    rows = np.empty(B, dtype=np.int64)
    rows[0::2], rows[1::2] = small[:(B + 1) // 2], large[:B // 2]
    assert size[rows[0::2]].max() < size[rows[1::2]].min()
    return rows.tolist()


@pytest.mark.parametrize("B,LB,instance,mixed", [
    (16, 16, "wrapper", False), (256, 64, "wrapper", False),
    (16, 16, "global_tables", False), (256, 64, "global_tables", False),
    (64, 16, "wrapper", True)])
def test_kernel_matches_plain_on_northstar(card, B, LB, instance, mixed):
    policy = compile_corpus(northstar.build_corpus(200, 10), members_k=16)
    params = to_device(policy, device=card)
    docs = northstar.build_docs(B, seed=B)
    rows = (mixed_rows(params, B) if mixed
            else [i % policy.n_configs for i in range(B)])
    db = pack_batch(policy, encode_batch(policy, docs, rows),
                    trim_bytes=LB == 16)
    assert db.attr_bytes.shape[2] == LB
    got = launch(params, db, instance, card)
    want = fk.eval_fused_kernel(to_device(policy, device="cpu"), db)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.parametrize("instance", ["wrapper", "global_tables"])
def test_kernel_matches_plain_past_a_64_slot_row(card, instance):
    """A config past 64 slots runs its circuit in shared memory, beside a
    small one on the register path, rows of both in each block."""
    policy = compile_corpus(corpora.wide_config_corpus(),
                            members_k=corpora.LANES_K)
    docs = corpora.wide_config_docs()
    db = pack_batch(policy, encode_batch(
        policy, docs, [i % 2 for i in range(len(docs))]))
    got = launch(to_device(policy, device=card), db, instance, card)
    want = fk.eval_fused_kernel(to_device(policy, device="cpu"), db)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def test_probe_round_trips(card):
    p0 = fk.probe_launches
    assert fk.fused_kernel_supported(card, recheck=True) is True
    assert fk.probe_launches - p0 == 1


def test_model_decides_like_the_oracle(card):
    policy, docs, rows = lanes_case(19, False)
    model = PolicyModel(policy)
    assert model.device.type == "cuda"
    assert model.decide_rows(docs, rows) == \
        [host_results(policy, d, r)[0] for d, r in zip(docs, rows)]


def test_engine_one_launch_per_batch(card):
    cfgs = northstar.build_corpus(20, 10)
    engine = PolicyEngine(max_batch=32)
    engine.apply_snapshot([EngineEntry(id=c.name, hosts=[c.name], rules=c)
                           for c in cfgs])
    docs = northstar.build_docs(70, seed=5)
    names = [f"cfg-{i % 20}" for i in range(70)]

    async def go():
        return await asyncio.gather(*(engine.submit(d, n)
                                      for d, n in zip(docs, names)))

    out = asyncio.run(go())
    policy = engine._snapshot.policy
    st = engine.stats
    assert st["launches"] == st["batches"] == 3
    assert st["d2h_bytes"] == st["pad_rows"] * policy.fused_pack_w
    for (rule, skipped), d, n in zip(out, docs, names):
        own, _, w_skip = host_results(policy, d, policy.config_ids[n])
        assert bool(np.all(rule | skipped)) == own
        assert skipped.tolist() == w_skip.tolist()


def test_check_on_the_card_equals_the_cpu(card):
    """The Check() request path: 40 north-star AuthConfigs translated with
    a card engine and a CPU engine give the same AuthResult for every
    request, with one launch per batch on the card."""
    from authorino_tpu_torch.controllers import translate_auth_config

    acs = northstar.build_auth_configs(40, 10)
    requests = northstar.build_check_requests(70, 40, seed=5)

    async def serve(engine):
        engine.apply_snapshot([await translate_auth_config(
            o["metadata"]["name"], o["metadata"]["namespace"], o["spec"],
            engine=engine) for o in acs])
        return await asyncio.gather(*(engine.check(r) for r in requests))

    on_card = PolicyEngine(max_batch=32)
    got = asyncio.run(serve(on_card))
    want = asyncio.run(serve(PolicyEngine(max_batch=32, device="cpu")))
    fields = ("code", "status", "message", "headers", "metadata", "body")
    assert [[getattr(r, f) for f in fields] for r in got] == \
        [[getattr(r, f) for f in fields] for r in want]
    st = on_card.stats
    assert st["launches"] == st["batches"] == 3
    assert st["failed_batches"] == st["plain_calls"] == 0


def test_opa_check_on_the_card_equals_the_cpu(card):
    """The OPA corpus: 40 AuthConfigs with inline Rego, most of it lowered
    into kernel slots, give the same AuthResult and the same per-slot bits
    on a card engine and a CPU engine."""
    from authorino_tpu_torch.authjson import build_authorization_json
    from authorino_tpu_torch.controllers import translate_auth_config
    from authorino_tpu_torch.models import opa_corpus

    acs = opa_corpus.build_auth_configs(40)
    requests = opa_corpus.build_check_requests(70, 40, seed=5)
    docs = [build_authorization_json(r, {"identity": r.metadata_context[
        "filter_metadata"][northstar.JWT_FILTER]["verified_jwt"]})
        for r in requests]
    names = [f"{opa_corpus.NAMESPACE}/{r.http.host.split('.')[0]}"
             for r in requests]

    async def serve(engine):
        engine.apply_snapshot([await translate_auth_config(
            o["metadata"]["name"], o["metadata"]["namespace"], o["spec"],
            engine=engine) for o in acs])
        results = await asyncio.gather(*(engine.check(r) for r in requests))
        bits = await asyncio.gather(*(engine.submit(d, n)
                                      for d, n in zip(docs, names)))
        return results, bits

    on_card = PolicyEngine(max_batch=32)
    got, got_bits = asyncio.run(serve(on_card))
    want, want_bits = asyncio.run(serve(PolicyEngine(max_batch=32,
                                                     device="cpu")))
    fields = ("code", "status", "message", "headers", "metadata", "body")
    assert [[getattr(r, f) for f in fields] for r in got] == \
        [[getattr(r, f) for f in fields] for r in want]
    for (gr, gs), (wr, ws) in zip(got_bits, want_bits):
        assert gr.tolist() == wr.tolist() and gs.tolist() == ws.tolist()
    st = on_card.stats
    assert st["launches"] == st["batches"] == 6
    assert st["failed_batches"] == st["plain_calls"] == 0
