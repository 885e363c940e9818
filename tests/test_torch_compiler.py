"""The port's host layers against the JAX package's: compile, encode, pack
and the fused-lane operand tree, array for array (tolerance 0: every
operand is an integer or boolean array).

Each corpus is built once per package from the same seeded spec, with each
package's own expression classes.  The helpers here are shared by the other
``test_torch_*`` files."""

import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import authorino_tpu.compiler as r_compiler
import authorino_tpu.expressions as r_expr
import authorino_tpu.relations.closure as r_closure
import authorino_tpu_torch.compiler as p_compiler
import authorino_tpu_torch.expressions as p_expr
import authorino_tpu_torch.relations.closure as p_closure
from authorino_tpu.compiler.encode import encode_batch_py as r_encode
from authorino_tpu.compiler.pack import pack_batch as r_pack
from authorino_tpu.ops import pattern_eval as r_pe
from authorino_tpu_torch.compiler.encode import encode_batch_py as p_encode
from authorino_tpu_torch.compiler.pack import pack_batch as p_pack
from authorino_tpu_torch.models import corpora, northstar
from authorino_tpu_torch.models.corpora import LANES_K
from authorino_tpu_torch.models.corpora import widen_wire as widen
from authorino_tpu_torch.ops import operands as p_ops

REF = SimpleNamespace(
    Pattern=r_expr.Pattern, All=r_expr.All, Any_=r_expr.Any_,
    InGroup=r_expr.InGroup, Operator=r_expr.Operator,
    RelationClosure=r_closure.RelationClosure,
    ConfigRules=r_compiler.ConfigRules, compile_corpus=r_compiler.compile_corpus,
    encode=r_encode, pack=r_pack)
PORT = SimpleNamespace(
    Pattern=p_expr.Pattern, All=p_expr.All, Any_=p_expr.Any_,
    InGroup=p_expr.InGroup, Operator=p_expr.Operator,
    RelationClosure=p_closure.RelationClosure,
    ConfigRules=p_compiler.ConfigRules,
    compile_corpus=p_compiler.compile_corpus, encode=p_encode, pack=p_pack)

K = LANES_K
SEEDS = [7, 19, 31]


def all_lanes_corpus(seed: int, ns):
    """The all-lanes corpus (the spec of tests/test_fused_kernel.py's)
    built with ``ns``'s expression classes."""
    return corpora.all_lanes_corpus(seed, ns=ns)


all_lanes_docs = corpora.all_lanes_docs


def northstar_corpus(ns, n_configs: int, rules: int = 10):
    """The north-star generator's corpus rebuilt with ``ns``'s classes."""
    port = northstar.build_corpus(n_configs, rules)
    if ns is PORT:
        return port
    return [convert_config(c, ns) for c in port]


def convert_expr(e, ns):
    """A port expression tree rebuilt with ``ns``'s classes."""
    if isinstance(e, p_expr.Pattern):
        return ns.Pattern(e.selector, ns.Operator(e.operator.value), e.value)
    if isinstance(e, p_expr.InGroup):
        return ns.InGroup(e.selector, e.group,
                          ns.RelationClosure(e.relation.edges))
    kids = [convert_expr(c, ns) for c in e.children]
    return ns.All(*kids) if isinstance(e, p_expr.And) else ns.Any_(*kids)


def convert_config(c, ns):
    return ns.ConfigRules(name=c.name, evaluators=[
        (convert_expr(cond, ns) if cond is not None else None,
         convert_expr(rule, ns)) for cond, rule in c.evaluators])


def build_case(kind: str, seed: int = 7, ovf_assist: bool = True,
               n_docs: int = 48):
    """(ns → policy) for both packages plus one shared request batch:
    ``kind`` is "lanes" (all-lanes corpus) or "northstar" (50 configs)."""
    rng = random.Random(seed + 1000)
    out = {}
    for tag, ns in (("ref", REF), ("port", PORT)):
        if kind == "lanes":
            cfgs = all_lanes_corpus(seed, ns)
            policy = ns.compile_corpus(cfgs, members_k=K, ovf_assist=ovf_assist)
        else:
            cfgs = northstar_corpus(ns, 50)
            policy = ns.compile_corpus(cfgs, members_k=16,
                                       ovf_assist=ovf_assist)
        out[tag] = policy
    if kind == "lanes":
        docs = all_lanes_docs(seed, n_docs)
    else:
        docs = northstar.build_docs(n_docs, seed=seed)
    names = sorted(out["port"].config_ids)
    rows = [out["port"].config_ids[rng.choice(names)] for _ in docs]
    return out["ref"], out["port"], docs, rows


def batch_of(ns, policy, docs, rows, batch_pad=0):
    return ns.pack(policy, ns.encode(policy, docs, rows, batch_pad=batch_pad))


def to_numpy_tree(x):
    if isinstance(x, dict):
        return {k: to_numpy_tree(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return tuple(to_numpy_tree(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return x


def assert_same(want, got, path="tree"):
    """Deep equality: dict keys, tuple lengths, None structure, and for
    arrays dtype, shape and every value."""
    if want is None or got is None:
        assert want is None and got is None, path
    elif isinstance(want, dict):
        assert set(want) == set(got), (path, set(want) ^ set(got))
        for k in want:
            assert_same(want[k], got[k], f"{path}.{k}")
    elif isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(want) == len(got), path
        for i, (w, g) in enumerate(zip(want, got)):
            assert_same(w, g, f"{path}[{i}]")
    else:
        w, g = np.asarray(want), np.asarray(got)
        assert w.dtype == g.dtype, (path, w.dtype, g.dtype)
        assert w.shape == g.shape, (path, w.shape, g.shape)
        np.testing.assert_array_equal(w, g, err_msg=path)


_POLICY_SCALARS = ("n_byte_attrs", "members_k", "n_member_attrs",
                   "n_cpu_leaves", "n_num_attrs", "n_rel_slots", "ovf_assist",
                   "fused_pack_w", "n_leaves", "n_attrs", "n_configs",
                   "buffer_size")


def assert_same_policy(rp, pp):
    for f in _POLICY_SCALARS:
        assert getattr(rp, f) == getattr(pp, f), f
    for name, val in vars(rp).items():
        if isinstance(val, np.ndarray):
            assert_same(val, getattr(pp, name), f"policy.{name}")
    assert_same(rp.levels, pp.levels, "policy.levels")
    assert rp.attr_selectors == pp.attr_selectors
    assert rp.config_ids == pp.config_ids
    assert rp.config_attrs == pp.config_attrs
    assert rp.config_cpu_leaves == pp.config_cpu_leaves
    assert rp.interner.content_digest() == pp.interner.content_digest()
    assert [str(r) for r in rp.rule_sources()] == \
        [str(r) for r in pp.rule_sources()]


_BATCH_FIELDS = ("attrs_val", "members_c", "cpu_dense", "config_id",
                 "attr_bytes", "byte_ovf", "host_fallback", "attrs_num",
                 "num_valid", "rel_rows", "member_ovf")

CASES = ([("lanes", s, a) for s in SEEDS for a in (True, False)]
         + [("northstar", 7, True), ("northstar", 7, False)])


@pytest.mark.parametrize("kind,seed,ovf_assist", CASES)
def test_compile_encode_pack_match_reference(kind, seed, ovf_assist):
    rp, pp, docs, rows = build_case(kind, seed, ovf_assist)
    assert_same_policy(rp, pp)
    r_enc = r_encode(rp, docs, rows, batch_pad=64)
    p_enc = p_encode(pp, docs, rows, batch_pad=64)
    for f in vars(r_enc):
        assert_same(getattr(r_enc, f), getattr(p_enc, f), f"enc.{f}")
    r_db, p_db = r_pack(rp, r_enc), p_pack(pp, p_enc)
    for f in _BATCH_FIELDS:
        assert_same(getattr(r_db, f), getattr(p_db, f), f"db.{f}")
    if kind == "lanes":
        # the corpus really exercises every lane of the kernel
        assert p_db.attr_bytes is not None and p_db.byte_ovf.any()
        assert p_db.attrs_num is not None and p_db.rel_rows is not None
        assert (p_db.member_ovf is not None) == ovf_assist
        assert p_db.host_fallback.any() == (not ovf_assist)


@pytest.mark.parametrize("kind,seed,ovf_assist", CASES)
def test_host_operands_match_reference_tree(kind, seed, ovf_assist):
    rp, pp, _, _ = build_case(kind, seed, ovf_assist, n_docs=1)
    want = r_pe.to_device(rp, host=True, lane="fused")
    assert_same(want, p_ops.to_device(pp, host=True))
    # and the uploaded tensor tree is the same tree plus the kernel layout
    params = p_ops.to_device(pp, device="cpu")
    assert set(params) - set(want) == {"kernel"}
    assert_same(want, to_numpy_tree({k: params[k] for k in want}))


def test_fuse_batch_layout_and_decode():
    _, pp, docs, rows = build_case("lanes", 7, True)
    db = batch_of(PORT, pp, docs[:20], rows[:20], batch_pad=33)  # odd B
    buf, layout = p_ops.fuse_batch(db)
    assert buf.dtype == np.uint8 and buf.size == p_ops.staged_h2d_bytes(db)
    # packed without padding: offsets are running sums, some of them odd
    offs = [off for _, _, _, off, _ in layout]
    assert offs == list(np.cumsum([0] + [n for *_, n in layout])[:-1])
    assert any(o % 2 for o in offs)
    ops = p_ops.defuse(torch.from_numpy(buf), layout)
    for name, *_ in layout:
        assert_same(getattr(db, name), ops[name].numpy(), name)


def test_widened_wire_dtype_decodes():
    _, pp, docs, rows = build_case("lanes", 19, True)
    db = batch_of(PORT, pp, docs, rows)
    buf, layout = p_ops.fuse_batch(widen(db))
    ops = p_ops.defuse(torch.from_numpy(buf), layout)
    assert ops["attrs_val"].dtype == torch.int32
    np.testing.assert_array_equal(ops["members_c"].numpy(),
                                  db.members_c.astype(np.int32))
