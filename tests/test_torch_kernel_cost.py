"""The port's kernel cost observatory (``runtime/kernel_cost.py``), the
cases of the reference's ``tests/test_kernel_cost.py`` on the port.
Tolerance 0: every compared value is an integer.

- the modeled plane: per-config integer operations and one batch's bytes
  equal an independent walk written here, over the compiled corpus's
  circuit (not the kernel's per-config program the model reads), on the
  north-star, all-lanes and wide-config corpora;
- ``CostModel``: a corpus with twice the per-row circuit raises the
  ``cost-regression`` anomaly, one at 1.5x stays silent; one record per
  generation; the memo keyed by the program's values, not its shapes
  alone;
- ``entry_points``: the one entry the port dispatches, with the operand
  lanes its corpus stages;
- the engine records a model per generation and sets the gauge."""

import random

import numpy as np
import pytest
from prometheus_client import REGISTRY

from authorino_tpu_torch.compiler import ConfigRules, compile_corpus
from authorino_tpu_torch.compiler.compile import (OP_EXCL, OP_INCL,
                                                  OP_REGEX_DFA)
from authorino_tpu_torch.compiler.encode import encode_batch
from authorino_tpu_torch.compiler.pack import pack_batch
from authorino_tpu_torch.expressions import All, Operator, Pattern
from authorino_tpu_torch.models import corpora, northstar
from authorino_tpu_torch.ops.operands import staged_h2d_bytes, to_device
from authorino_tpu_torch.runtime import EngineEntry, PolicyEngine
from authorino_tpu_torch.runtime import flight_recorder as port_fr
from authorino_tpu_torch.runtime import kernel_cost as kc


# ---- an independent walk of the compiled circuit ---------------------------

def walk(tree, g):
    """(leaves, nodes) config ``g``'s evaluators reach in the compiled
    circuit: slot indices, from eval_rule[g] and the eval_cond[g] that
    exist, down the And/Or levels (a node's padding children — TRUE under
    And, FALSE under Or — are not its children)."""
    L = tree["leaf_op"].shape[0]
    children, is_and = [], []
    for ch, ia in tree["levels"]:
        children.extend(np.asarray(ch).tolist())
        is_and.extend(np.asarray(ia).tolist())
    stack = list(tree["eval_rule"][g]) + list(
        tree["eval_cond"][g][tree["eval_has_cond"][g]])
    leaves, nodes, seen = set(), {}, set()
    while stack:
        i = int(stack.pop())
        if i < 2 or i in seen:
            continue
        seen.add(i)
        if i < 2 + L:
            leaves.add(i - 2)
            continue
        n = i - 2 - L
        kids = [int(c) for c in children[n] if c != (0 if is_and[n] else 1)]
        nodes[i] = kids
        stack.extend(kids)
    return leaves, nodes


def level_of(tree, slot):
    base = 2 + tree["leaf_op"].shape[0]
    for lv, (ch, _) in enumerate(tree["levels"]):
        if slot < base + ch.shape[0]:
            return lv
        base += ch.shape[0]
    raise AssertionError(slot)


def walk_ops(tree, K, LB):
    """Integer operations per config by the own-config rule."""
    op = tree["fused"]["leaf_op_i8"]
    G, E = tree["eval_rule"].shape
    out = []
    for g in range(G):
        leaves, nodes = walk(tree, g)
        ops = 3 * E + sum(K if op[l] in (OP_INCL, OP_EXCL) else 1
                          for l in leaves)
        ops += sum(len(k) for k in nodes.values())
        if LB and tree["dfa_tables"] is not None:
            ops += sum(op[l] == OP_REGEX_DFA for l in leaves) * (LB + 1)
        out.append(ops)
    return out


def walk_bytes(tree, db):
    """Bytes one batch moves by the own-config rule: the staging buffer
    but cpu_dense, each row's own cpu_dense columns, each present
    config's program once (cfg_off row + evaluator words, 16 B per leaf,
    node and DFA record, 4 B per child and level end), the DFA image when
    a present config reads a DFA row, the [B, W] output."""
    G, E = tree["eval_rule"].shape
    op = tree["fused"]["leaf_op_i8"]
    cpu_leaves = set(int(x) for x in tree["cpu_scatter_idx"]
                     if x < tree["leaf_op"].shape[0])
    rows = [int(c) for c in db.config_id if 0 <= c < G]
    total = staged_h2d_bytes(db)
    if db.cpu_dense is not None:
        total -= db.cpu_dense.nbytes
    any_dfa = False
    for g in set(rows):
        leaves, nodes = walk(tree, g)
        n_dfa = sum(op[l] == OP_REGEX_DFA for l in leaves)
        any_dfa |= n_dfa > 0
        levels = {level_of(tree, s) for s in nodes}
        total += (32 + 4 * E + 16 * (len(leaves) + len(nodes) + n_dfa)
                  + 4 * (sum(len(k) for k in nodes.values()) + len(levels)))
    for g in rows:
        leaves, _ = walk(tree, g)
        total += len(leaves & cpu_leaves) * (
            db.cpu_dense.itemsize if db.cpu_dense is not None else 0)
    if any_dfa and tree["dfa_tables"] is not None:
        T, S, _ = tree["dfa_tables"].shape
        total += -(-T * S * 256 // 16) * 16 + -(-T * S // 16) * 16
    W = -(-(1 + 2 * E) // 8)
    return total + db.attrs_val.shape[0] * W


CORPORA = [("northstar", 7, False), ("northstar", 7, True),
           ("lanes", 7, True), ("lanes", 19, False), ("lanes", 31, True),
           ("wide", 0, False)]


def corpus(kind, seed, assist):
    if kind == "northstar":
        cfgs, k = northstar.build_corpus(60, 10), 16
        docs = northstar.build_docs(96, seed=seed)
    elif kind == "lanes":
        cfgs, k = corpora.all_lanes_corpus(seed), corpora.LANES_K
        docs = corpora.all_lanes_docs(seed, 64)
    else:
        cfgs, k = corpora.wide_config_corpus(), corpora.LANES_K
        docs = corpora.wide_config_docs()
    policy = compile_corpus(cfgs, members_k=k, ovf_assist=assist)
    rng = random.Random(seed)
    rows = [rng.randrange(len(cfgs)) for _ in docs]
    db = pack_batch(policy, encode_batch(policy, docs, rows))
    return policy, db


@pytest.mark.parametrize("kind,seed,assist", CORPORA)
def test_modeled_ops_and_bytes_equal_an_independent_walk(kind, seed, assist):
    policy, db = corpus(kind, seed, assist)
    tree = to_device(policy, host=True)
    params = to_device(policy, device="cpu")
    K = db.members_c.shape[2]
    LB = db.attr_bytes.shape[2] if db.attr_bytes is not None else 0
    got = kc.config_ops(params, K, LB)
    assert got.tolist() == walk_ops(tree, K, LB)
    assert kc.config_ops(params, K, 0).tolist() == walk_ops(tree, K, 0)
    moved, ops = kc.batch_work(params, db)
    rows = [int(c) for c in db.config_id[:len(db.config_id)]
            if 0 <= c < policy.n_configs]
    assert ops == sum(got[r] for r in rows)
    assert moved == walk_bytes(tree, db)


def test_modeled_record_is_the_mean_config_at_a_zero_batch():
    policy, _ = corpus("northstar", 7, False)
    params = to_device(policy, device="cpu")
    rec = kc.modeled_fused_cost(policy, params, pad=16)
    assert (rec["entry"], rec["pad"], rec["eff"]) == ("fused_kernel", 16, 16)
    ops = kc.config_ops(params, policy.members_k, 16)
    assert rec["flops"] == 16 * float(ops.mean())
    assert rec["flops_per_row"] == round(float(ops.mean()), 2)
    assert rec["bytes_per_row"] == round(rec["bytes_accessed"] / 16, 2)


# ---- the regression gate ----------------------------------------------------

def chain_corpus(n_leaves, G=8, membership=False):
    """G configs, each one evaluator: an All over ``n_leaves`` compares on
    distinct attributes (membership compares when ``membership``)."""
    op = Operator.INCL if membership else Operator.EQ
    cfgs = []
    for g in range(G):
        rule = All(*[Pattern(f"auth.identity.a{j}", op, f"v{g}-{j}")
                     for j in range(n_leaves)])
        cfgs.append(ConfigRules(name=f"c{g}", evaluators=[(None, rule)]))
    return compile_corpus(cfgs, members_k=4)


def analyzed(model, policy, gen, recorder=None):
    return model.analyze(gen, policy=policy,
                         params=to_device(policy, device="cpu"),
                         recorder=recorder)


@pytest.mark.parametrize("n_leaves,regress", [(12, True), (8, False)])
def test_cost_regression_raises_at_twice_the_circuit(tmp_path, n_leaves,
                                                     regress):
    """Base: 4 leaves per config, one evaluator padded to E = 2: 6 + 4 + 4
    = 14 operations per row.  12 leaves: 30 (2.14x) — a regression; 8
    leaves: 22 (1.57x) — silent."""
    rec = port_fr.FlightRecorder(dump_dir=str(tmp_path),
                                 min_dump_interval_s=3600.0)
    model = kc.CostModel("engine")
    base = analyzed(model, chain_corpus(4), 1, rec)
    assert base["entries"]["fused_kernel"]["flops_per_row"] == 14.0
    cur = analyzed(model, chain_corpus(n_leaves), 2, rec)
    per_row = cur["entries"]["fused_kernel"]["flops_per_row"]
    assert per_row == 6 + 2 * n_leaves
    axes = {r["axis"] for r in cur["regressions"]}
    kinds = [e["kind"] for e in rec.to_json()["tail"]]
    if regress:
        assert "flops_per_row" in axes
        r = [x for x in cur["regressions"] if x["axis"] == "flops_per_row"][0]
        assert (r["previous"], r["current"], r["previous_generation"]) == (
            14.0, 30.0, 1)
        assert kinds == ["cost-regression"]
        assert model.to_json()["regressions_seen"] == len(cur["regressions"])
    else:
        assert cur["regressions"] == [] and kinds == []
        assert model.to_json()["last_regression"] is None


def test_same_generation_analyzed_once_and_history_bounded():
    model = kc.CostModel("engine")
    policy = chain_corpus(3)
    first = analyzed(model, policy, 5)
    assert analyzed(model, chain_corpus(9), 5) is first
    for gen in range(6, 6 + kc.CostModel.HISTORY + 3):
        analyzed(model, policy, gen)
    js = model.to_json()
    assert js["generations_analyzed"] == kc.CostModel.HISTORY
    assert js["current"]["generation"] == 5 + kc.CostModel.HISTORY + 3


def test_memo_keys_on_program_values_not_shapes_alone():
    eq, incl = chain_corpus(4), chain_corpus(4, membership=True)
    p_eq, p_incl = (to_device(p, device="cpu") for p in (eq, incl))
    assert kc.program_fingerprint(p_eq, 16) != kc.program_fingerprint(
        p_incl, 16)
    assert kc.program_fingerprint(p_eq, 16) == kc.program_fingerprint(
        to_device(chain_corpus(4), device="cpu"), 16)
    model = kc.CostModel("engine")
    a = analyzed(model, eq, 1)["entries"]["fused_kernel"]["flops_per_row"]
    b = analyzed(model, incl, 2)["entries"]["fused_kernel"]["flops_per_row"]
    assert (a, b) == (14.0, 6 + 4 * 4 + 4)


def test_analysis_failure_is_advisory(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("model fault")

    monkeypatch.setattr(kc, "modeled_fused_cost", boom)
    monkeypatch.setattr(kc, "_ANALYSIS_MEMO", {})
    rec = analyzed(kc.CostModel("engine"), chain_corpus(2), 1)
    assert rec == {"generation": 1, "entries": {}, "regressions": []}


# ---- the entry-point audit --------------------------------------------------

BASE = ["attrs_val", "members_c", "cpu_dense", "config_id"]


def test_entry_points_list_the_fused_kernel_and_its_lanes():
    assert kc.entry_points(None) == []
    plain = kc.entry_points(chain_corpus(2))
    # the reference's list: the op-chain lanes' two entries, then the kernel
    assert [e["entry"] for e in plain] == ["eval_bitpacked", "eval_fused",
                                           "fused_kernel"]
    assert all(e["operands"] == BASE for e in plain)
    regex = ConfigRules(name="r", evaluators=[(None, Pattern(
        "request.path", Operator.MATCHES, "^/api/v[0-9]+/"))])
    ops = kc.entry_points(compile_corpus([regex], members_k=4))[0]["operands"]
    assert ops == BASE + ["attr_bytes", "byte_ovf"]
    lanes = compile_corpus(corpora.all_lanes_corpus(7),
                           members_k=corpora.LANES_K, ovf_assist=True)
    ops = kc.entry_points(lanes)[0]["operands"]
    assert ops[:4] == BASE and "member_ovf" in ops
    assert set(ops) <= {"attrs_val", "members_c", "cpu_dense", "config_id",
                        "attr_bytes", "byte_ovf", "attrs_num", "num_valid",
                        "rel_rows", "member_ovf"}


# ---- the engine -------------------------------------------------------------

def test_engine_models_each_generation_and_sets_the_gauge():
    engine = PolicyEngine(max_batch=16, members_k=4, device="cpu")
    for gen, n in ((1, 4), (2, 12)):
        policy_cfgs = [ConfigRules(name=f"c{g}", evaluators=[(None, All(*[
            Pattern(f"auth.identity.a{j}", Operator.EQ, f"v{g}-{j}")
            for j in range(n)]))]) for g in range(8)]
        engine.apply_snapshot([EngineEntry(id=c.name, hosts=[c.name],
                                           rules=c) for c in policy_cfgs])
        cp = engine.debug_vars()["control_plane"]
        e = cp["kernel_cost"]["entries"]["fused_kernel"]
        assert cp["kernel_cost"]["generation"] == gen
        assert e["flops_per_row"] == 6 + 2 * n
        assert REGISTRY.get_sample_value(
            "auth_server_kernel_modeled_flops_per_row",
            {"entry": "fused_kernel"}) == e["flops_per_row"]
        assert cp["kernel_cost_ms"] >= 0
    kcv = engine.debug_vars()["kernel_cost"]
    assert kcv["modeled"]["generations_analyzed"] == 2
    assert "flops_per_row" in {
        r["axis"] for r in kcv["modeled"]["current"]["regressions"]}
    assert [e["entry"] for e in kcv["entry_points"]] == [
        "eval_bitpacked", "eval_fused", "fused_kernel"]
