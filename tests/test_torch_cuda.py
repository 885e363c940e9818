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
from authorino_tpu_torch.ops.operands import to_device
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


@pytest.mark.parametrize("seed", [7, 19, 31])
@pytest.mark.parametrize("assist", [True, False])
@pytest.mark.parametrize("wide", [False, True])
def test_kernel_matches_plain_on_all_lanes(card, seed, assist, wide):
    policy, docs, rows = lanes_case(seed, assist)
    db = pack_batch(policy, encode_batch(policy, docs, rows, batch_pad=33))
    db = corpora.widen_wire(db) if wide else db
    l0 = fk.launches
    got = fk.eval_fused_kernel(to_device(policy, device=card), db)
    assert fk.launches - l0 == 1
    want = fk.eval_fused_kernel(to_device(policy, device="cpu"), db)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.parametrize("B,LB", [(16, 16), (256, 64)])
def test_kernel_matches_plain_on_northstar(card, B, LB):
    policy = compile_corpus(northstar.build_corpus(200, 10), members_k=16)
    docs = northstar.build_docs(B, seed=B)
    rows = [i % policy.n_configs for i in range(B)]
    db = pack_batch(policy, encode_batch(policy, docs, rows),
                    trim_bytes=LB == 16)
    assert db.attr_bytes.shape[2] == LB
    got = fk.eval_fused_kernel(to_device(policy, device=card), db)
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
