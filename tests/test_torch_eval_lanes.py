"""The port's gather and matmul lanes, its lane router and its staged
baseline against the JAX package's lanes (tests/test_eval_lanes.py,
tests/test_fused_kernel.py): the same seeded corpora and batches give the
same verdicts, rule and skipped bits and [B, W] uint8 readbacks (every
output is integer or boolean: tolerance 0), and each lane's operand tree is
the reference's leaf for leaf.  On the CPU the fused lane is the kernel's
plain version; tests/test_torch_cuda.py holds every lane on the card to the
mega-kernel."""

import asyncio
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from authorino_tpu.models.policy_model import host_results as r_host_results
from authorino_tpu.ops import pattern_eval as r_pe
from authorino_tpu.runtime import EngineEntry as RefEntry
from authorino_tpu.runtime import PolicyEngine as RefEngine
from authorino_tpu_torch.models.policy_model import host_results
from authorino_tpu_torch.ops import fused_kernel as p_fk
from authorino_tpu_torch.ops import operands as p_ops
from authorino_tpu_torch.ops import pattern_eval as p_pe
from authorino_tpu_torch.runtime import EngineEntry, PolicyEngine
from authorino_tpu_torch.runtime.kernel_cost import LEDGER
from authorino_tpu_torch.snapshots.delta import apply_delta
from authorino_tpu_torch.snapshots.diff import plan_delta

from test_torch_compiler import (PORT, REF, assert_same, batch_of,
                                 build_case, to_numpy_tree)

try:
    from prometheus_client import REGISTRY
except ImportError:  # pragma: no cover - the image has it
    REGISTRY = None

LANES = ("gather", "matmul", "fused")


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


# ---- the corpora -------------------------------------------------------------

def mixed_corpus(ns, n_configs=23, seed=5):
    """tests/test_eval_lanes.py's ``_mixed_corpus`` with ``ns``'s classes."""
    rng = random.Random(seed)
    P, O = ns.Pattern, ns.Operator
    configs = []
    for i in range(n_configs):
        pats = [
            P("request.method", O.EQ, rng.choice(["GET", "POST"])),
            P("auth.identity.org", O.NEQ, f"org-{i % 7}"),
            P("auth.identity.roles", O.INCL, f"role-{i % 5}"),
            P("auth.identity.groups", O.EXCL, f"banned-{i % 3}"),
            P("request.url_path", O.MATCHES, rf"^/svc-{i % 4}/"),
        ]
        rule = ns.All(pats[0], ns.Any_(*pats[1:]))
        cond = P("request.headers.x-env", O.NEQ, "dev") if i % 2 else None
        configs.append(ns.ConfigRules(name=f"cfg-{i}",
                                      evaluators=[(cond, rule)]))
    return configs


def mixed_docs(n, seed=11):
    rng = random.Random(seed)
    docs = []
    for _ in range(n):
        docs.append({
            "request": {
                "method": rng.choice(["GET", "POST", "PUT"]),
                "url_path": rng.choice(["/svc-0/a", "/svc-1/b", "/other",
                                        "/svc-3/"]),
                "headers": {"x-env": rng.choice(["dev", "prod"])},
            },
            "auth": {"identity": {
                "org": f"org-{rng.randrange(9)}",
                "roles": [f"role-{rng.randrange(7)}"
                          for _ in range(rng.randrange(0, 20))],
                "groups": [f"banned-{rng.randrange(5)}"
                           for _ in range(rng.randrange(0, 3))],
            }},
        })
    return docs


def mixed_case(n_configs=23, n_docs=64, doc_seed=11):
    policies = [ns.compile_corpus(mixed_corpus(ns, n_configs), members_k=4)
                for ns in (REF, PORT)]
    docs = mixed_docs(n_docs, doc_seed)
    rows = [i % policies[1].n_configs for i in range(n_docs)]
    return policies[0], policies[1], docs, rows


def ref_args(policy, db):
    """The JAX package's positional operand tail of one batch."""
    has_dfa = policy.n_byte_attrs > 0
    return (jnp.asarray(db.attrs_val), jnp.asarray(db.members_c),
            jnp.asarray(db.cpu_dense), jnp.asarray(db.config_id),
            jnp.asarray(db.attr_bytes) if has_dfa else None,
            jnp.asarray(db.byte_ovf) if has_dfa else None,
            *r_pe._extra_operands(db))


def ref_readback(policy, db, lane="gather"):
    return np.asarray(r_pe.eval_bitpacked_jit(
        r_pe.to_device(policy, lane=lane), *ref_args(policy, db)))


def port_verdicts(params, db):
    """eval_verdicts on one batch's tensors → numpy (v, rule, skipped)."""
    t = {k: (torch.from_numpy(np.ascontiguousarray(getattr(db, k)))
             if getattr(db, k) is not None else None)
         for k in ("attrs_val", "members_c", "cpu_dense", "attr_bytes",
                   "byte_ovf")}
    v, (r, s) = p_pe.eval_verdicts(params, t["attrs_val"], t["members_c"],
                                   t["cpu_dense"], t["attr_bytes"],
                                   t["byte_ovf"])
    return v.numpy(), r.numpy(), s.numpy()


# ---- twins of tests/test_eval_lanes.py ---------------------------------------

def test_matmul_lane_matches_gather_lane():
    rp, pp, docs, rows = mixed_case()
    params = {lane: p_pe.to_device(pp, device="cpu", lane=lane)
              for lane in ("matmul", "gather")}
    assert params["matmul"]["matmul"] is not None
    assert params["gather"]["matmul"] is None
    db = batch_of(PORT, pp, docs, rows, batch_pad=64)
    r_db = batch_of(REF, rp, docs, rows, batch_pad=64)
    a = ref_args(rp, r_db)
    want_v, (want_r, want_s) = r_pe.eval_verdicts(
        r_pe.to_device(rp, lane="gather"), a[0], a[1], a[2], a[4], a[5])
    for lane, p in params.items():
        for w, g in zip((want_v, want_r, want_s), port_verdicts(p, db)):
            np.testing.assert_array_equal(np.asarray(w), g, err_msg=lane)


def test_matmul_lane_bf16_matches_gather_lane(monkeypatch):
    """bf16 operand matrices (the card's configuration) on the CPU: the
    port's exact-product construction runs here, so this does not skip; it
    is held against the JAX package's gather lane."""
    rp, pp, docs, rows = mixed_case(31, 128, 17)
    monkeypatch.setattr(p_pe, "_mm_dtype", lambda device=None: torch.bfloat16)
    params = p_pe.to_device(pp, device="cpu", lane="matmul")
    assert params["matmul"]["rule_m"].dtype == torch.bfloat16
    assert params["matmul"]["attr_onehot"].dtype == torch.float32
    db = batch_of(PORT, pp, docs, rows, batch_pad=128)
    r_db = batch_of(REF, rp, docs, rows, batch_pad=128)
    a = ref_args(rp, r_db)
    want_v, _ = r_pe.eval_verdicts(r_pe.to_device(rp, lane="gather"),
                                   a[0], a[1], a[2], a[4], a[5])
    np.testing.assert_array_equal(np.asarray(want_v),
                                  port_verdicts(params, db)[0])


def test_bitpacked_readback_roundtrips_both_lanes():
    rp, pp, docs, rows = mixed_case()
    db = batch_of(PORT, pp, docs, rows, batch_pad=64)
    want = ref_readback(rp, batch_of(REF, rp, docs, rows, batch_pad=64))
    E = int(pp.eval_rule.shape[1])
    cols = 1 + 2 * E
    for lane in ("matmul", "gather"):
        params = p_pe.to_device(pp, device="cpu", lane=lane)
        packed = p_pe.dispatch_packed(params, db, bitpack=True).numpy()
        reference = p_pe.dispatch_packed(params, db).numpy()
        assert packed.dtype == np.uint8
        assert packed.shape == (reference.shape[0], p_pe.packed_width(cols))
        np.testing.assert_array_equal(
            p_pe.unpack_verdicts(packed, cols), reference)
        np.testing.assert_array_equal(packed, want, err_msg=lane)
    # bits past the verdict columns are zero padding (byte-stable wire)
    tail_bits = p_pe.packed_width(cols) * 8 - cols
    if tail_bits:
        full = np.unpackbits(packed, axis=1, bitorder="little")
        assert not full[:, cols:].any()


def test_interner_overflow_falls_back_to_gather(monkeypatch):
    rp, pp, _, _ = mixed_case(5, 1)
    monkeypatch.setattr(p_pe, "_F32_EXACT", len(pp.interner))
    monkeypatch.setattr(r_pe, "_F32_EXACT", len(rp.interner))
    params = p_pe.to_device(pp, device="cpu", lane="matmul")
    assert params["matmul"] is None  # ids no longer exact in float32
    assert p_pe.kernel_lane_of(params) == "gather"
    assert_same(r_pe.to_device(rp, host=True, lane="matmul"),
                p_pe.to_device(pp, host=True, lane="matmul"))


# ---- twins of tests/test_fused_kernel.py -------------------------------------

@pytest.mark.parametrize("seed", [7, 19, 31])
def test_fused_bit_identical_across_lanes_and_oracle(seed):
    rp, pp, docs, rows = build_case("lanes", seed, True)
    db = batch_of(PORT, pp, docs, rows)
    assert not db.host_fallback.any()  # ovf_assist: no lossy rows
    params = {lane: p_pe.to_device(pp, device="cpu", lane=lane)
              for lane in LANES}
    for lane, p in params.items():
        assert p_pe.kernel_lane_of(p) == lane
    assert params["fused"]["fused"] is not None
    assert params["gather"]["fused"] is None

    packed_f = p_fk.eval_fused_kernel(params["fused"], db).numpy()
    assert packed_f.dtype == np.uint8
    for lane in ("gather", "matmul"):
        np.testing.assert_array_equal(
            packed_f, np.asarray(p_pe.dispatch_fused(params[lane], db)),
            err_msg=lane)
    # the JAX package's lanes give the same bytes
    r_db = batch_of(REF, rp, docs, rows)
    for lane in ("gather", "matmul"):
        np.testing.assert_array_equal(packed_f, ref_readback(rp, r_db, lane),
                                      err_msg=f"reference {lane}")

    E = int(pp.eval_rule.shape[1])
    verdict, firing = p_pe.unpack_attribution(packed_f, E)
    want = [host_results(pp, d, r) for d, r in zip(docs, rows)]
    w_fire = p_pe.firing_columns(np.stack([w[1] for w in want]),
                                 np.stack([w[2] for w in want]))
    for i in range(len(docs)):
        assert bool(verdict[i]) == bool(want[i][0]), (seed, i)
        assert int(firing[i]) == int(w_fire[i]), (seed, i)
        assert bool(want[i][0]) == bool(r_host_results(rp, docs[i],
                                                       rows[i])[0])


def test_fused_matches_gather_on_host_fallback_corpus():
    rp, pp, docs, rows = build_case("lanes", 5, False)
    db = batch_of(PORT, pp, docs, rows)
    assert db.host_fallback.any()  # K+3 role lists overflow K=4
    packed_f = p_fk.eval_fused_kernel(
        p_pe.to_device(pp, device="cpu", lane="fused"), db).numpy()
    packed_g = np.asarray(p_pe.dispatch_fused(
        p_pe.to_device(pp, device="cpu", lane="gather"), db))
    np.testing.assert_array_equal(packed_f, packed_g)
    np.testing.assert_array_equal(
        packed_g, ref_readback(rp, batch_of(REF, rp, docs, rows)))


def test_staged_baseline_bit_exact_but_multi_launch():
    rp, pp, docs, rows = build_case("lanes", 3, True, n_docs=32)
    db = batch_of(PORT, pp, docs, rows)
    params = p_pe.to_device(pp, device="cpu", lane="fused")
    fused = p_fk.eval_fused_kernel(params, db).numpy()
    staged = p_fk.dispatch_staged(params, db).numpy()
    np.testing.assert_array_equal(fused, staged)
    # a DFA + relations + numeric corpus costs 5 stages unfused: leaves,
    # DFA scan, value lanes, circuit, bitpack — as the reference counts
    assert p_fk.staged_launches(params, db) == 5
    r_params = r_pe.to_device(rp, lane="fused")
    from authorino_tpu.ops import fused_kernel as r_fk

    r_db = batch_of(REF, rp, docs, rows)
    assert r_fk.staged_launches(r_params, r_db) == 5
    np.testing.assert_array_equal(staged, np.asarray(
        r_fk.dispatch_staged(r_params, r_db)))
    b0 = LEDGER.snapshot("host")
    p_fk.dispatch_staged(params, db, ledger_lane="host")
    b1 = LEDGER.snapshot("host")
    assert b1["launches"] - b0["launches"] == 5


def test_kernel_lane_env_and_auto_resolution(monkeypatch):
    rp, pp, _, _ = mixed_case(1, 1)
    monkeypatch.setenv("AUTHORINO_TPU_KERNEL_LANE", "fused")
    p = p_pe.to_device(pp, host=True)
    assert p["fused"] is not None and p_pe.kernel_lane_of(p) == "fused"
    monkeypatch.setenv("AUTHORINO_TPU_KERNEL_LANE", "matmul")
    assert p_pe.kernel_lane_of(p_pe.to_device(pp, host=True)) == "matmul"
    monkeypatch.delenv("AUTHORINO_TPU_KERNEL_LANE")
    # divergence by design (ROADMAP queue 3): the reference's auto keeps
    # its per-stage lane off a TPU; the port's arms fused on the CPU too,
    # where the plain version answers
    assert r_pe.to_device(rp, host=True)["fused"] is None
    assert p_pe.to_device(pp, host=True)["fused"] is not None
    # an explicit argument wins whatever the environment says
    monkeypatch.setenv("AUTHORINO_TPU_KERNEL_LANE", "gather")
    assert p_pe.to_device(pp, host=True, lane="fused")["fused"] is not None
    with pytest.raises(ValueError, match="kernel lane"):
        p_pe.to_device(pp, host=True, lane="mxu")


def test_kernel_lane_auto_consults_every_device(monkeypatch):
    """The port's auto rule: fused iff every device is a CUDA card or the
    CPU (the reference's: iff every device is a TPU)."""
    assert p_pe.auto_lane("cuda:0") == "fused"
    assert p_pe.auto_lane("cpu") == "fused"
    assert p_pe.auto_lane("meta") != "fused"
    monkeypatch.setattr(p_pe, "_visible_devices", lambda: [
        torch.device("cuda", 0), torch.device("meta")])
    assert p_pe.auto_lane() == "matmul"
    dec = p_pe.last_auto_decision()
    assert dec == {"requested": "auto", "lane": "matmul", "devices": 2,
                   "platforms": ["cuda", "meta"]}
    monkeypatch.setattr(p_pe, "_visible_devices", lambda: [
        torch.device("cuda", 0), torch.device("cuda", 1)])
    assert p_pe.auto_lane() == "fused"
    assert p_pe.last_auto_decision()["platforms"] == ["cuda"]


# ---- operand trees -----------------------------------------------------------

@pytest.mark.parametrize("lane", LANES)
@pytest.mark.parametrize("kind,seed,ovf_assist", [
    ("lanes", 7, True), ("lanes", 19, False), ("northstar", 7, True)])
def test_lane_operand_tree_matches_reference(lane, kind, seed, ovf_assist):
    rp, pp, _, _ = build_case(kind, seed, ovf_assist, n_docs=1)
    want = r_pe.to_device(rp, host=True, lane=lane)
    assert_same(want, p_pe.to_device(pp, host=True, lane=lane))
    # the uploaded tree is the same tree plus its host view's extra key
    params = p_pe.to_device(pp, device="cpu", lane=lane)
    assert set(params) - set(want) == ({"kernel"} if lane == "fused"
                                       else {"bounds"})
    assert_same(want, to_numpy_tree({k: params[k] for k in want}))


def test_carried_matmul_tree_reads_like_its_own():
    """The weight carry-over on the op-chain lanes: the JAX package's host
    tree, uploaded by ``params_from_numpy``, gives the port's readback."""
    rp, pp, docs, rows = build_case("lanes", 19, True)
    db = batch_of(PORT, pp, docs, rows)
    for lane in ("gather", "matmul"):
        carried = p_ops.params_from_numpy(
            r_pe.to_device(rp, host=True, lane=lane), device="cpu")
        own = p_pe.to_device(pp, device="cpu", lane=lane)
        np.testing.assert_array_equal(np.asarray(p_pe.dispatch_fused(
            carried, db)), np.asarray(p_pe.dispatch_fused(own, db)))


def test_gather_tree_out_of_range_index_is_refused_on_the_host():
    rp, _, _, _ = build_case("lanes", 7, True, n_docs=1)
    tree = r_pe.to_device(rp, host=True, lane="gather")
    tree["leaf_dfa_row"] = tree["leaf_dfa_row"] + 1000
    with pytest.raises(ValueError, match="leaf_dfa_row"):
        p_ops.params_from_numpy(tree, device="cpu")
    _, pp, docs, rows = build_case("lanes", 7, True, n_docs=4)
    params = p_pe.to_device(pp, device="cpu", lane="matmul")
    db = batch_of(PORT, pp, docs, rows)
    db.rel_rows[1, 0] = pp.rel_bits.shape[0]
    with pytest.raises(ValueError, match="rel_rows"):
        p_pe.dispatch_fused(params, db)


# ---- the planted traps -------------------------------------------------------

NARROW = (5, 3)   # the narrow Ands planted beside the wide one


def wide_and_corpus(ns, width=300, prefill=3000, narrow=()):
    """One config whose rule is an And of ``width`` EQ children, compiled
    after ``prefill`` strings so its constants' ids are >= 2^11.  Each
    ``narrow`` width adds an evaluator whose rule is an And of that many
    children, in the wide And's level: the compiler pads its row to the
    level's width with TRUE, so its level-matrix count there is
    ``width - n``."""
    interner = ns.interner_cls()
    for i in range(prefill):
        interner.intern(f"filler-{i}")
    rule = ns.All(*[ns.Pattern(f"auth.identity.k{j}", ns.Operator.EQ,
                               f"v{j}") for j in range(width)])
    evaluators = [(None, rule)] + [
        (None, ns.All(*[ns.Pattern(f"auth.identity.n{n}_{j}", ns.Operator.EQ,
                                   f"w{j}") for j in range(n)]))
        for n in narrow]
    return ns.compile_corpus(
        [ns.ConfigRules(name="wide", evaluators=evaluators)],
        members_k=4, interner=interner)


def wide_docs(width=300, narrow=()):
    """All children true, then one child false in the wide And and in each
    narrow one, then no attributes at all."""
    full = {f"k{j}": f"v{j}" for j in range(width)}
    for n in narrow:
        full.update({f"n{n}_{j}": f"w{j}" for j in range(n)})
    off = [dict(full, k7="nope")] + [dict(full, **{f"n{n}_1": "nope"})
                                     for n in narrow]
    return [{"auth": {"identity": d}} for d in [full, *off, {}]] * 4


@pytest.fixture
def traps():
    from authorino_tpu.compiler.intern import StringInterner as RI
    from authorino_tpu_torch.compiler.intern import StringInterner as PI

    REF.interner_cls, PORT.interner_cls = RI, PI
    try:
        yield
    finally:
        del REF.interner_cls, PORT.interner_cls


@pytest.mark.parametrize("width,narrow", [(300, ()), (300, NARROW),
                                          (2100, NARROW)])
def test_wide_and_with_bf16_operands_stays_exact(monkeypatch, traps, width,
                                                  narrow):
    """bf16 forced on the CPU: an And of ``width`` children with one false
    child reads false (a bf16 count would round), and so does a narrow And
    beside it whose padding count bf16 cannot hold (its level matrix stays
    float32 and multiplies in float64)."""
    rp = wide_and_corpus(REF, width, narrow=narrow)
    pp = wide_and_corpus(PORT, width, narrow=narrow)
    assert int(pp.leaf_const.max()) >= 1 << 11
    assert max(int(c.shape[1]) for c, _ in pp.levels) >= width
    docs = wide_docs(width, narrow)
    rows = [0] * len(docs)
    db = batch_of(PORT, pp, docs, rows)
    monkeypatch.setattr(p_pe, "_mm_dtype", lambda device=None: torch.bfloat16)
    mm = p_pe.to_device(pp, device="cpu", lane="matmul")
    m = mm["matmul"]["level_mats"][0]
    pads = {width - n for n in narrow}
    assert pads <= set(m.float()[:, 0].numpy().astype(int).tolist())
    assert m.dtype == (torch.float32 if narrow else torch.bfloat16)
    assert mm["matmul"]["rule_m"].dtype == torch.bfloat16
    got = np.asarray(p_pe.dispatch_fused(mm, db))
    want = ref_readback(rp, batch_of(REF, rp, docs, rows))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(p_pe.dispatch_fused(
        p_pe.to_device(pp, device="cpu", lane="gather"), db)))
    # only the doc with every child true allows; each evaluator's rule bit
    # is false exactly in the doc that falsifies one of its children
    n_ev = 1 + len(narrow)
    assert [bool(b & 1) for b in got[:n_ev + 2, 0]] == \
        [True] + [False] * (n_ev + 1)
    rule_bits = [[bool(got[d, (1 + e) // 8] >> ((1 + e) % 8) & 1)
                  for e in range(n_ev)] for d in range(n_ev + 1)]
    assert rule_bits == [[d == 0 or e != d - 1 for e in range(n_ev)]
                         for d in range(n_ev + 1)]


# ---- the engine --------------------------------------------------------------

def lane_count(lane):
    if REGISTRY is None:
        return 0.0
    return REGISTRY.get_sample_value("auth_server_kernel_lane_total",
                                     {"lane": lane}) or 0.0


async def submit_all(engine, docs, names):
    return await asyncio.gather(*(engine.submit(d, n)
                                  for d, n in zip(docs, names)))


@pytest.mark.parametrize("lane", ("gather", "matmul"))
def test_engine_on_each_lane_matches_reference_engine(lane):
    rp, pp, docs, rows = build_case("lanes", 7, True)
    r_cfgs = [c for c in _lanes_configs(REF)]
    p_cfgs = [c for c in _lanes_configs(PORT)]
    names = [r_cfgs[i % len(r_cfgs)].name for i in range(len(docs))]
    ref = RefEngine(max_batch=32, members_k=4, mesh=None, ovf_assist=True,
                    lane_select=False, kernel_lane=lane,
                    verdict_cache_size=0, batch_dedup=False)
    ref.apply_snapshot([RefEntry(id=c.name, hosts=[c.name], runtime=None,
                                 rules=c) for c in r_cfgs])
    port = PolicyEngine(max_batch=32, members_k=4, ovf_assist=True,
                        device="cpu", kernel_lane=lane, lane_select=False,
                        verdict_cache_size=0, batch_dedup=False)
    port.apply_snapshot([EngineEntry(id=c.name, hosts=[c.name], rules=c)
                         for c in p_cfgs])
    assert p_pe.kernel_lane_of(port._snapshot.params) == lane
    l0, k0 = lane_count(lane), p_fk.plain_calls
    want = run(submit_all(ref, docs, names))
    r_delta = lane_count(lane) - l0
    l1 = lane_count(lane)
    got = run(submit_all(port, docs, names))
    p_delta = lane_count(lane) - l1
    for i, ((wr, ws), (gr, gs)) in enumerate(zip(want, got)):
        assert np.asarray(wr).tolist() == gr.tolist(), i
        assert np.asarray(ws).tolist() == gs.tolist(), i
    assert p_delta == r_delta == port.stats["batches"] == 2
    assert p_fk.plain_calls == k0  # no batch reached the fused lane
    assert port.stats["launches"] == port.stats["plain_calls"] == 0
    ledger = LEDGER.snapshot("engine")
    assert ledger["launches"] >= 2


def _lanes_configs(ns):
    from test_torch_compiler import all_lanes_corpus

    return all_lanes_corpus(7, ns)


@pytest.mark.parametrize("bf16", [False, True])
def test_matmul_delta_upload_reads_like_a_full_upload(monkeypatch, bf16):
    """A one-config change on the matmul lane (its bf16 matrices, the
    card's, as CPU tensors in the host view): the delta plan ships rows of
    the changed operands only, and the delta-built params give a readback
    byte-equal to a full upload's."""
    if bf16:
        monkeypatch.setattr(p_pe, "_mm_dtype",
                            lambda device=None: torch.bfloat16)
    _, pp, docs, rows = build_case("lanes", 7, True)
    from test_torch_compiler import all_lanes_corpus

    cfgs = all_lanes_corpus(7, PORT)
    changed = list(cfgs)
    c0 = changed[0]
    changed[0] = PORT.ConfigRules(name=c0.name, evaluators=list(
        reversed(c0.evaluators)))
    p0 = PORT.compile_corpus(cfgs, members_k=4, ovf_assist=True)
    p1 = PORT.compile_corpus(changed, members_k=4, ovf_assist=True,
                             interner=p0.interner.freeze_copy())
    v0 = p_ops.host_view(p_pe.to_device(p0, host=True, lane="matmul"))
    v1 = p_ops.host_view(p_pe.to_device(p1, host=True, lane="matmul"))
    prev = p_ops._put(v0, torch.device("cpu"))
    plan = plan_delta(v0, v1)
    assert plan is not None and plan.mode == "delta"
    assert plan.upload_bytes < plan.full_bytes
    assert any(e.name.startswith("matmul.") and e.mode != "reuse"
               for e in plan.entries)
    delta_params, shipped = apply_delta(prev, v1, plan, device="cpu")
    assert shipped == plan.upload_bytes
    full = p_ops._put(v1, torch.device("cpu"))
    db = batch_of(PORT, p1, docs, rows)
    np.testing.assert_array_equal(np.asarray(p_pe.dispatch_fused(
        delta_params, db)), np.asarray(p_pe.dispatch_fused(full, db)))
    # a lane change is no structure-preserving delta: a full restage
    assert plan_delta(v0, p_ops.host_view(
        p_pe.to_device(p1, host=True, lane="gather"))) is None


def test_router_handle_has_the_megakernel_interface():
    _, pp, docs, rows = build_case("lanes", 7, True, n_docs=8)
    db = batch_of(PORT, pp, docs, rows)
    for lane in LANES:
        h = p_pe.dispatch_fused(p_pe.to_device(pp, device="cpu", lane=lane),
                                db)
        assert h.is_ready() and h.stream is None
        assert h.nbytes == 8 * pp.fused_pack_w
        assert (h.launches, h.plain_calls, h.lane_calls) == (
            (0, 1, 0) if lane == "fused" else (0, 0, 1))
        assert np.asarray(h).shape == (8, pp.fused_pack_w)
