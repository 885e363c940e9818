"""The port's reconcile verification against the JAX package's: the tensor
lint, the Cedar-style policy analysis, translation validation (certificates,
fingerprints, the certificate cache, the mutation self-test), the
lowerability report, and strict verify on the engine's reconcile path.

Each case builds the same seeded input for both packages (each with its
own expression classes and compiler) and compares with tolerance 0:
findings by kind, location and message, certificates and fingerprints
field for field, cache counts, reports as JSON.

Both tensor lints check the gather, matmul and fused lanes' operand
trees; the port's also checks the per-config program its CUDA kernel
reads, which the reference has not (a finding only that program sees is
the port's own, ROADMAP queue 3)."""

from __future__ import annotations

import importlib
import json
import random
from copy import deepcopy
from types import SimpleNamespace

import numpy as np
import pytest

REF_ROOT, PORT_ROOT = "authorino_tpu", "authorino_tpu_torch"
ROOTS = (REF_ROOT, PORT_ROOT)


def ns(root: str) -> SimpleNamespace:
    """The modules of package ``root`` these cases use."""
    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    expr = m("expressions")
    return SimpleNamespace(
        root=root, fixtures=m("analysis.fixtures"),
        pa=m("analysis.policy_analysis"), tl=m("analysis.tensor_lint"),
        tv=m("analysis.translation_validate"), compiler=m("compiler"),
        compile_mod=m("compiler.compile"), encode=m("compiler.encode"),
        pack=m("compiler.pack"), Pattern=expr.Pattern, All=expr.All,
        Any_=expr.Any_, Operator=expr.Operator,
        ConfigRules=m("compiler").ConfigRules,
        compile_corpus=m("compiler").compile_corpus,
        engine_mod=m("runtime.engine"),
        compile_cache_mod=m("snapshots.compile_cache"))


REF, PORT = ns(REF_ROOT), ns(PORT_ROOT)


def engine(n, **kw):
    """A policy engine of ``n`` on the CPU."""
    if n is REF:
        return n.engine_mod.PolicyEngine(mesh=None, lane_select=False,
                                          kernel_lane="fused", **kw)
    return n.engine_mod.PolicyEngine(device="cpu", lane_select=False, **kw)


def entries(n, configs):
    return [n.engine_mod.EngineEntry(id=c.name,
                                     hosts=[f"{c.name}.example.com"],
                                     runtime=None, rules=c)
            for c in configs]


def keyed(findings):
    """Findings as comparable JSON, in order."""
    return [f.to_json() for f in findings]


def random_corpus(n, seed: int, n_configs: int = 7):
    """The reference's generated corpus (tests/test_static_analysis.py):
    every operator, a regex mix, nested And/Or."""
    rng = random.Random(seed)
    P, O = n.Pattern, n.Operator
    configs = []
    for i in range(n_configs):
        pats = [P("request.method", O.EQ, rng.choice(["GET", "POST"])),
                P("auth.identity.org", O.EQ, f"org-{i}")]
        for j in range(rng.randrange(1, 6)):
            kind = rng.random()
            if kind < 0.15:
                pats.append(P("request.url_path", O.MATCHES,
                              rf"^/api/v\d+/r{j}"))
            elif kind < 0.45:
                pats.append(P("auth.identity.roles", O.INCL,
                              f"role-{rng.randrange(6)}"))
            elif kind < 0.65:
                pats.append(P("auth.identity.groups", O.EXCL,
                              f"banned-{rng.randrange(4)}"))
            else:
                pats.append(P(f"request.headers.x-{rng.randrange(3)}",
                              O.NEQ, f"v-{rng.randrange(5)}"))
        rule = n.All(pats[0], n.Any_(*pats[1:]))
        cond = (P("request.host", O.EQ, f"h{i}")
                if rng.random() < 0.4 else None)
        configs.append(n.ConfigRules(name=f"cfg-{i}",
                                     evaluators=[(cond, rule)]))
    return configs


def random_docs(seed: int, count: int):
    rng = random.Random(seed)
    return [{
        "request": {"method": rng.choice(["GET", "POST"]),
                    "url_path": rng.choice(["/api/v1/r0", "/x"]),
                    "host": f"h{rng.randrange(4)}",
                    "headers": {f"x-{k}": f"v-{rng.randrange(5)}"
                                for k in range(3)}},
        "auth": {"identity": {
            "org": f"org-{rng.randrange(8)}",
            "roles": [f"role-{rng.randrange(6)}"
                      for _ in range(rng.randrange(3))],
            "groups": [f"banned-{rng.randrange(4)}"
                       for _ in range(rng.randrange(2))]}},
    } for _ in range(count)]


# ---------------------------------------------------------------------------
# tensor lint
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5])
def test_generated_corpora_lint_clean_in_both(seed):
    out = []
    for n in (REF, PORT):
        policy = n.compile_corpus(random_corpus(n, seed), members_k=8)
        docs = random_docs(seed, 12)
        rows = [random.Random(seed).randrange(7) for _ in docs]
        db = n.pack.pack_batch(policy, n.encode.encode_batch_py(
            policy, docs, rows, batch_pad=16))
        keys = n.pack.batch_row_keys(db, len(docs))
        unique_rows, inverse = n.pack.dedup_rows(keys, list(range(len(docs))))
        out.append((keyed(n.tl.tensor_lint(policy)),
                    keyed(n.tl.lint_device_batch(policy, db)),
                    keyed(n.tl.lint_scatter_plan(
                        keys, list(range(len(docs))), unique_rows, inverse)),
                    keys, list(unique_rows), np.asarray(inverse).tolist()))
    assert out[1] == out[0]
    assert out[1][:3] == ([], [], [])


def corrupt_dfa_table_index(p):
    p.dfa_table_of_row = p.dfa_table_of_row.copy()
    p.dfa_table_of_row[0] = p.dfa_tables.shape[0] + 3


def corrupt_cyclic_circuit(p):
    ch0 = p.levels[0][0].copy()
    ch0[0, 0] = p.buffer_size - 1  # forward reference = cycle
    p.levels = ((ch0, p.levels[0][1]),) + p.levels[1:]


def corrupt_dfa_next_state(p):
    p.dfa_tables = p.dfa_tables.copy()
    p.dfa_tables[0, 0, 0] = 255  # far past S


def corrupt_eval_table_range(p):
    p.eval_rule = p.eval_rule.copy()
    p.eval_rule[0, 0] = p.buffer_size + 10


def corrupt_row_perm(p):
    p.dfa_row_perm = np.zeros_like(p.dfa_row_perm)


def corrupt_pack_width(p):
    p.fused_pack_w = int(p.fused_pack_w) + 1


def corrupt_op_i8(p):
    p.leaf_op_i8 = p.leaf_op_i8.copy()
    p.leaf_op_i8[0] = (int(p.leaf_op_i8[0]) + 1) % 8


CORRUPTIONS = {
    "dfa-table-index": (corrupt_dfa_table_index, {"dfa-table-index"}),
    "cyclic-circuit": (corrupt_cyclic_circuit, {"circuit-order"}),
    "dfa-next-state": (corrupt_dfa_next_state, {"dfa-next-state"}),
    "eval-table-range": (corrupt_eval_table_range, {"operand-range"}),
    "row-perm": (corrupt_row_perm, {"fused-perm"}),
    "pack-width": (corrupt_pack_width, {"fused-pack-width"}),
    "op-i8": (corrupt_op_i8, {"fused-int8"}),
}


def test_fixture_policy_lints_clean_in_both():
    assert keyed(PORT.tl.tensor_lint(PORT.fixtures.fixture_policy())) == \
        keyed(REF.tl.tensor_lint(REF.fixtures.fixture_policy())) == []


@pytest.mark.parametrize("name", sorted(CORRUPTIONS))
def test_corruption_trips_the_same_finding(name):
    """Each hand-corrupted snapshot trips exactly its intended finding
    kind, with the reference's location and message."""
    plant, kinds = CORRUPTIONS[name]
    got = []
    for n in (REF, PORT):
        p = deepcopy(n.fixtures.fixture_policy())
        plant(p)
        got.append(keyed(n.tl.tensor_lint(p)))
    assert got[1] == got[0]
    assert {f["kind"] for f in got[1]} == kinds


def test_scatter_plan_corruption_equal():
    keys = [b"a", b"b", b"a", b"c"]
    rows = [0, 1, 2, 3]
    bad = np.array([0, 1, 1, 2])
    got = []
    for n in (REF, PORT):
        unique_rows, inverse = n.pack.dedup_rows(keys, rows)
        got.append((keyed(n.tl.lint_scatter_plan(keys, rows, [0, 1, 3], bad)),
                    keyed(n.tl.lint_scatter_plan(keys, rows, unique_rows,
                                                 inverse))))
    assert got[1] == got[0]
    assert {f["kind"] for f in got[1][0]} == {"scatter-cover"}
    assert got[1][1] == []


def test_pack_errors_equal():
    """The packer's typed PackError (a grid overflow, an int16 wrap), and
    the lint's agreement on the overflowing policy."""
    got = []
    for n in (REF, PORT):
        policy = n.fixtures.fixture_policy()
        enc = n.encode.encode_batch_py(policy, random_docs(1, 2), [0, 1],
                                       batch_pad=2)
        bad = deepcopy(policy)
        bad.n_member_attrs = max(bad.member_attrs.shape[0] - 1, 0)
        with pytest.raises(n.pack.PackError, match="padded grid") as e1:
            n.pack.pack_batch(bad, enc)
        lint = keyed(n.tl.tensor_lint(bad, check_lanes=False))
        enc2 = n.encode.encode_batch_py(policy, random_docs(2, 2), [0, 1],
                                        batch_pad=2)
        enc2.attrs_val = enc2.attrs_val.astype(np.int32)
        enc2.attrs_val[0, 0] = 40_000
        with pytest.raises(n.pack.PackError, match="int16") as e2:
            n.pack.pack_batch(policy, enc2)
        got.append((str(e1.value), lint, str(e2.value)))
    assert got[1] == got[0]
    assert any(f["kind"] == "operand-range" for f in got[1][1])


def test_port_lints_its_own_config_program():
    """The port's own-config program is linted too: a per-config program
    whose build fails (here: two CPU columns scattered onto one leaf,
    which only the program's checks see) is a lane-contract finding at
    the kernel's operands, where the reference, which has no such
    program, finds nothing."""
    cfgs = PORT.fixtures.fixture_configs()
    p = PORT.compile_corpus(cfgs, members_k=8)
    assert p.cpu_leaf_list.shape[0] >= 1
    p.cpu_leaf_list = p.cpu_leaf_list.copy()
    p.n_cpu_leaves = max(p.n_cpu_leaves, 2)
    p.cpu_leaf_list = np.concatenate([p.cpu_leaf_list[:1]] * 2)
    found = PORT.tl.tensor_lint(p)
    assert [(f.kind, f.location) for f in found] == [
        ("lane-contract", "params[fused].kernel")]
    assert "two CPU columns" in found[0].message


# ---------------------------------------------------------------------------
# policy analysis
# ---------------------------------------------------------------------------


def both_analyze(build):
    return [keyed(n.pa.analyze_policy(build(n))[0]) for n in (REF, PORT)]


def test_policy_analysis_planted_kinds_equal():
    got = []
    for n in (REF, PORT):
        findings, summary = n.pa.analyze_policy(
            n.compile_corpus(n.fixtures.finding_fixture_configs()))
        got.append((keyed(findings), summary))
    assert got[1] == got[0]
    kinds = {f["kind"] for f in got[1][0]}
    assert {"constant-allow", "constant-deny", "shadowed-rule",
            "duplicate-rule"} <= kinds


def test_policy_analysis_sound_rules_equal():
    got = both_analyze(lambda n: n.compile_corpus(random_corpus(n, 7)))
    assert got[1] == got[0] == []


def test_policy_analysis_complementary_atoms_equal():
    def taut(n):
        P, O = n.Pattern, n.Operator
        eq, neq = P("a.b", O.EQ, "x"), P("a.b", O.NEQ, "x")
        incl, excl = P("a.c", O.INCL, "y"), P("a.c", O.EXCL, "y")
        return n.compile_corpus([
            n.ConfigRules(name="t", evaluators=[
                (None, n.Any_(eq, neq)), (None, n.Any_(incl, excl))]),
            n.ConfigRules(name="g", evaluators=[(incl, n.All(eq, neq))])])

    got = both_analyze(taut)
    assert got[1] == got[0]
    assert [f["kind"] for f in got[1]] == ["constant-allow", "constant-allow"]


def test_policy_analysis_wide_support_skip_equal():
    def wide(n):
        pats = [n.Pattern(f"a.k{i}", n.Operator.EQ, f"v{i}")
                for i in range(n.pa.MAX_ATOMS + 2)]
        return n.compile_corpus([
            n.ConfigRules(name="wide", evaluators=[(None, n.Any_(*pats))]),
            n.ConfigRules(name="narrow", evaluators=[(None, pats[0])])])

    got = [n.pa.analyze_policy(wide(n)) for n in (REF, PORT)]
    assert [keyed(f) for f, _ in got] == [[], []]
    assert got[1][1] == got[0][1]
    assert got[1][1]["skipped"] == [
        {"config": "wide", "evaluator": 0, "atoms": PORT.pa.MAX_ATOMS + 2}]


def test_duplicate_host_detection_equal():
    class E:
        def __init__(self, id_, hosts):
            self.id, self.hosts = id_, hosts

    es = [E("ns/a", ["x.com", "y.com"]), E("ns/b", ["y.com"]), E("ns/c", [])]
    got = [keyed(n.pa.analyze_hosts(es)) for n in (REF, PORT)]
    assert got[1] == got[0]
    assert [f["kind"] for f in got[1]] == ["duplicate-host"]


# ---------------------------------------------------------------------------
# translation validation
# ---------------------------------------------------------------------------


def certs_json(certs):
    return [c.to_json() for c in certs]


def test_fixture_corpus_certificates_equal():
    got = []
    for n in (REF, PORT):
        certs, failures, stats = n.tv.certify_snapshot(
            n.fixtures.fixture_policy(), use_cache=False)
        got.append((certs_json(certs), keyed(failures), stats))
    assert got[1] == got[0]
    certs, failures, stats = got[1]
    assert failures == [] and stats["validated"] == 3
    for c in certs:
        assert c["ok"] and c["mode"] == "exhaustive"
        assert len(c["fingerprint"]) == 64


def test_invalid_regex_and_wide_tiers_equal():
    def corpora(n):
        P, O = n.Pattern, n.Operator
        bad, ok = P("p", O.MATCHES, "(["), P("m", O.EQ, "GET")
        shared = n.Any_(bad, ok)
        pats = [P(f"a.k{i}", O.EQ, f"v{i}") for i in range(18)]
        return [
            n.compile_corpus([
                n.ConfigRules("t", evaluators=[(shared, n.Any_(ok)),
                                               (None, n.All(ok, bad))]),
                n.ConfigRules("s", evaluators=[(shared, shared)])]),
            n.compile_corpus([n.ConfigRules(name="w", evaluators=[
                (None, n.Any_(*pats))])]),
        ]

    got = []
    for n in (REF, PORT):
        out = []
        for p in corpora(n):
            certs, failures, stats = n.tv.certify_snapshot(
                p, use_cache=False, seed=7)
            out.append((certs_json(certs), keyed(failures), stats))
        got.append(out)
    assert got[1] == got[0]
    assert got[1][0][2]["validated"] == 2
    (wide,) = got[1][1][0]
    assert wide["mode"] == "sampled" and wide["seed"] == 7
    assert wide["n_assignments"] == PORT.tv.SAMPLES_DEFAULT + 2


def test_sampled_tier_catches_redirected_rule_in_both():
    got = []
    for n in (REF, PORT):
        pats = [n.Pattern(f"a.k{i}", n.Operator.EQ, f"v{i}")
                for i in range(18)]
        p = n.compile_corpus([n.ConfigRules(name="w", evaluators=[
            (None, n.All(*pats))])])
        p.eval_rule = p.eval_rule.copy()
        p.eval_rule[0, 0] = n.compile_mod.TRUE_SLOT
        got.append(keyed(n.tv.certify_snapshot(p, use_cache=False)[1]))
    assert got[1] == got[0]
    assert any(f["kind"] == "translation-mismatch" for f in got[1])


MUTANT_KINDS = {
    "circuit-child-flip": "translation-mismatch",
    "eval-rule-redirect": "translation-mismatch",
    "leaf-attr-swap": "translation-mismatch",
    "leaf-const-swap": "translation-mismatch",
    "dfa-transition-corrupt": "dfa-mismatch",
    "dfa-accept-flip": "dfa-mismatch",
    "dfa-pad-corrupt": "dfa-mismatch",
}


def mutate(n, name):
    p = deepcopy(n.fixtures.fixture_policy())
    dict(n.tv._MUTANTS)[name](p)
    return p


@pytest.mark.parametrize("mutant", sorted(MUTANT_KINDS))
def test_planted_miscompile_rejected_as_the_reference(mutant):
    got = []
    for n in (REF, PORT):
        certs, failures, stats = n.tv.certify_snapshot(mutate(n, mutant),
                                                       use_cache=False)
        got.append((certs_json(certs), keyed(failures), stats))
    assert got[1] == got[0]
    assert MUTANT_KINDS[mutant] in {f["kind"] for f in got[1][1]}
    assert got[1][2]["failed"] >= 1


def test_mutation_self_tests_green_and_equal():
    """The validator is not blind in either package: every planted mutant
    class is rejected and the clean fixtures certify (the reference's
    tier-1 gate), and both packages plant the same classes."""
    assert [n.tv.mutation_self_test() for n in (REF, PORT)] == [[], []]
    assert [n.tv.relations_mutation_self_test()
            for n in (REF, PORT)] == [[], []]
    assert [name for name, _ in PORT.tv._MUTANTS] == \
        [name for name, _ in REF.tv._MUTANTS]
    assert [name for name, _ in PORT.tv._RELATION_MUTANTS] == \
        [name for name, _ in REF.tv._RELATION_MUTANTS]


def test_structureless_self_test_reports_equal():
    got = []
    for n in (REF, PORT):
        p = n.compile_corpus([n.ConfigRules("leafy", evaluators=[
            (None, n.Pattern("m", n.Operator.EQ, "GET"))])])
        got.append(keyed(n.tv.mutation_self_test(p)))
    assert got[1] == got[0]
    assert got[1] and all(f["kind"] == "validator-blind" for f in got[1])


def test_dfa_witnesses_cover_the_reject_side_in_both():
    got = []
    for n in (REF, PORT):
        p = n.compile_corpus([n.ConfigRules("c", evaluators=[
            (None, n.Pattern("p", n.Operator.MATCHES, r"^/api/v[0-9]+/"))])])
        p.dfa_tables = p.dfa_tables.copy()
        t = p.dfa_tables[0]
        dead = int(t.max()) if int(t.max()) != int(t[0, ord("/")]) else 0
        t[0, ord("/")] = dead
        got.append(keyed(n.tv.certify_snapshot(p, use_cache=False)[1]))
    assert got[1] == got[0]
    assert any(f["kind"] == "dfa-mismatch" for f in got[1])


def test_fingerprints_byte_equal_to_the_reference():
    """A certificate cache hit means the same in both packages: each
    config's canonical fingerprint is the reference's, stable across
    compile orders and sensitive to its semantics and its DFA bytes."""
    out = []
    for n in (REF, PORT):
        pa = n.compile_corpus(n.fixtures.fixture_configs())
        pb = n.compile_corpus(list(reversed(n.fixtures.fixture_configs())))
        changed = n.fixtures.fixture_configs()
        changed[1] = n.ConfigRules(name="admin", evaluators=[
            (None, n.Pattern("auth.identity.org", n.Operator.EQ,
                             "other-org"))])
        pc = n.compile_corpus(changed)
        mut = deepcopy(pa)
        mut.dfa_tables = mut.dfa_tables.copy()
        mut.dfa_tables[0, 0, ord("x")] ^= 1
        fp = lambda p: {k: n.tv.config_fingerprint(p, g)  # noqa: E731
                        for k, g in p.config_ids.items()}
        out.append((fp(pa), fp(pb), fp(pc), fp(mut)))
    assert out[1] == out[0]
    fa, fb, fc, fm = out[1]
    assert fa == fb
    assert fc["admin"] != fa["admin"] and fc["api"] == fa["api"]
    assert fm["api"] != fa["api"]
    # the relations fixtures too
    assert {k: PORT.tv.config_fingerprint(p, g) for p in [
        PORT.fixtures.relations_fixture_policy()]
        for k, g in p.config_ids.items()} == \
        {k: REF.tv.config_fingerprint(p, g) for p in [
            REF.fixtures.relations_fixture_policy()]
            for k, g in p.config_ids.items()}


def test_certificate_cache_counts_equal():
    """Re-certifying an unchanged corpus validates nothing; changing one
    config re-validates exactly it; a mutant, a padded-column corruption
    and a circuit aliased onto another config's are never shielded."""
    got = []
    for n in (REF, PORT):
        n.tv.clear_certificate_cache()
        steps = []
        steps.append(n.tv.certify_snapshot(
            n.compile_corpus(n.fixtures.fixture_configs()))[2])
        steps.append(n.tv.certify_snapshot(
            n.compile_corpus(n.fixtures.fixture_configs()))[2])
        changed = n.fixtures.fixture_configs()
        changed[2] = n.ConfigRules(name="public", evaluators=[
            (None, n.Pattern("request.method", n.Operator.EQ, "GET"))])
        certs, _, st = n.tv.certify_snapshot(n.compile_corpus(changed))
        steps.append(st)
        steps.append([c.cached for c in certs])
        steps.append(n.tv.certificate_cache_len())
        _, fails, st = n.tv.certify_snapshot(
            mutate(n, "dfa-transition-corrupt"))
        steps.append((st, keyed(fails)))
        p = n.fixtures.fixture_policy()
        row = p.config_ids["public"]
        p.eval_rule = p.eval_rule.copy()
        p.eval_rule[row, p.eval_rule.shape[1] - 1] = \
            n.compile_mod.FALSE_SLOT
        _, fails, st = n.tv.certify_snapshot(p)
        steps.append((st, keyed(fails)))
        q = n.compile_corpus([
            n.ConfigRules("a", evaluators=[
                (None, n.Pattern("m", n.Operator.EQ, "GET"))]),
            n.ConfigRules("b", evaluators=[
                (None, n.Pattern("m", n.Operator.EQ, "POST"))])])
        q.eval_rule = q.eval_rule.copy()
        q.eval_rule[q.config_ids["b"], 0] = q.eval_rule[q.config_ids["a"], 0]
        _, fails, st = n.tv.certify_snapshot(q)
        steps.append((st, keyed(fails)))
        n.tv.clear_certificate_cache()
        got.append(steps)
    assert got[1] == got[0]
    s = got[1]
    assert (s[0]["validated"], s[0]["cache_hits"]) == (3, 0)
    assert (s[1]["validated"], s[1]["cache_hits"]) == (0, 3)
    assert (s[2]["validated"], s[2]["cache_hits"]) == (1, 2)
    for st, fails in s[5:]:
        assert st["failed"] >= 1 and fails


def test_shared_corrupt_table_attributed_to_each_config_in_both():
    got = []
    for n in (REF, PORT):
        rx = n.Pattern("request.url_path", n.Operator.MATCHES,
                       r"^/api/v[0-9]+/")
        p = n.compile_corpus([n.ConfigRules("alpha", evaluators=[(None, rx)]),
                              n.ConfigRules("beta", evaluators=[(None, rx)])])
        p.dfa_accept = p.dfa_accept.copy()
        p.dfa_accept[0, 0] = not bool(p.dfa_accept[0, 0])
        got.append(keyed(n.tv.certify_snapshot(p, use_cache=False)[1]))
    assert got[1] == got[0]
    assert {"alpha", "beta"} <= {f["detail"].get("config") for f in got[1]
                                 if f["kind"] == "dfa-mismatch"}


def test_certify_config_corners_equal():
    got = []
    for n in (REF, PORT):
        p = n.fixtures.fixture_policy()
        row = p.config_ids["public"]
        p.eval_rule = p.eval_rule.copy()
        p.eval_rule[row, p.eval_rule.shape[1] - 1] = n.compile_mod.FALSE_SLOT
        _, padded = n.tv.certify_config(p, row)
        empty = n.compile_corpus([n.ConfigRules("empty", evaluators=[])])
        cert, fails = n.tv.certify_config(empty, 0)
        q = deepcopy(n.fixtures.fixture_policy())
        q.dfa_table_of_row = q.dfa_table_of_row.copy()
        q.dfa_table_of_row[0] = q.dfa_tables.shape[0] + 7
        _, unlinted, st = n.tv.certify_snapshot(q, use_cache=False)
        got.append((keyed(padded), cert.to_json(), keyed(fails),
                    keyed(unlinted), st))
    assert got[1] == got[0]
    assert any("padded evaluator" in f["message"] for f in got[1][0])
    assert got[1][1]["ok"] and got[1][2] == []
    assert any(f["kind"] == "dfa-mismatch" and "table axis" in f["message"]
               for f in got[1][3])


# ---------------------------------------------------------------------------
# the lowerability report
# ---------------------------------------------------------------------------


def test_lowerability_reports_equal():
    got = []
    for n in (REF, PORT):
        es = n.fixtures.lowerability_fixture_entries()
        rules = [e.rules for e in es if e.rules is not None]
        pol = n.compile_corpus(rules)
        rep = n.tv.lowerability_report(es, pol)
        rep2 = n.tv.lowerability_report(es, pol, max_listed=2)
        shards = [n.compile_corpus(rules[:2]), n.compile_corpus(rules[2:])]
        rep3 = n.tv.lowerability_report(es, shards)
        rel = n.tv.lowerability_report(
            [SimpleNamespace(id=c.name, rules=c, runtime=None)
             for c in n.fixtures.relations_fixture_configs()],
            n.fixtures.relations_fixture_policy())
        got.append(json.loads(json.dumps([rep, rep2, rep3, rel])))
    assert got[1] == got[0]
    rep, rep2, rep3, _ = got[1]
    assert rep["fast"] == 4 and rep["slow"] == 4
    cfg = rep["configs"]
    assert cfg["api"]["reasons"] == ["cpu-grid-overflow", "cpu-regex"]
    assert cfg["metadata-bound"]["reasons"] == ["metadata-dependency"]
    assert cfg["external-az"]["reasons"] == ["external-authorization"]
    assert rep2["truncated"] is True and len(rep2["configs"]) == 2
    assert rep3["by_reason"] == rep["by_reason"]


def test_blocking_reasons_rollup_equal():
    got = []
    for n in (REF, PORT):
        P, O = n.Pattern, n.Operator
        rules = n.ConfigRules(name="c", evaluators=[
            (None, P("request.method", O.EQ, "GET"))])
        pol = n.compile_corpus([rules])

        def ent(i, reasons):
            md = ([SimpleNamespace(type="METADATA_GENERIC_HTTP")]
                  if "md" in reasons else [])
            az = ([SimpleNamespace(type="SPICEDB",
                                   evaluator=SimpleNamespace())]
                  if "ext" in reasons else [])
            return SimpleNamespace(id=f"e{i}", rules=rules, runtime=(
                SimpleNamespace(metadata=md, authorization=az)))

        es = [ent(0, ["md"]), ent(1, ["md", "ext"]), ent(2, ["ext"]),
              ent(3, [])]
        got.append(n.tv.lowerability_report(es, pol)["blocking_reasons"])
    assert got[1] == got[0]
    assert got[1]["metadata-dependency"] == {"configs": 2, "sole_blocker": 1}


# ---------------------------------------------------------------------------
# the engine: strict verify, the advisory passes
# ---------------------------------------------------------------------------


def corrupting(n, plant, monkeypatch):
    """Make ``n``'s compile cache lower every corpus into a copy that
    ``plant`` corrupts: a compiler fault."""
    real = n.compile_cache_mod.compile_corpus

    def bad(*a, **k):
        p = real(*a, **k)
        plant(p)
        return p

    monkeypatch.setattr(n.compile_cache_mod, "compile_corpus", bad)
    return real


def changed_fixture(n):
    cfgs = n.fixtures.fixture_configs()
    cfgs[2] = n.ConfigRules(name="public", evaluators=[
        (None, n.Pattern("request.method", n.Operator.NEQ, "TRACE"))])
    return cfgs


@pytest.mark.parametrize("plant,kind", [
    (corrupt_dfa_table_index, "dfa-table-index"),
    (lambda p: dict(PORT.tv._MUTANTS)["circuit-child-flip"](p),
     "translation-mismatch"),
])
def test_strict_verify_rejects_before_staging_a_byte(plant, kind,
                                                     monkeypatch):
    """A compiler fault under strict verify: both engines raise
    SnapshotRejected with the same findings, keep the old generation
    serving, count the rejection; the port staged nothing for the
    candidate (no encoder build, no host view, no upload, no probe)."""
    got = []
    staged = []
    for n in (REF, PORT):
        n.tv.clear_certificate_cache()
        eng = engine(n, strict_verify=True, analyze_policies=False)
        eng.apply_snapshot(entries(n, n.fixtures.fixture_configs()))
        g1, snap1 = eng.generation, eng._snapshot
        assert snap1.lint_ok is True
        real = corrupting(n, plant, monkeypatch)
        if n is PORT:
            for name in ("apply_delta", "host_view", "get_native_encoder"):
                fn = getattr(n.engine_mod, name)
                monkeypatch.setattr(
                    n.engine_mod, name,
                    lambda *a, _fn=fn, _name=name, **k: (
                        staged.append(_name), _fn(*a, **k))[1])
        with pytest.raises(n.engine_mod.SnapshotRejected) as ei:
            eng.apply_snapshot(entries(n, changed_fixture(n)))
        assert eng.generation == g1 and eng._snapshot is snap1
        assert eng.lookup("api.example.com") is not None
        monkeypatch.setattr(n.compile_cache_mod, "compile_corpus", real)
        got.append(keyed(ei.value.findings))
        if n is PORT:
            assert staged == []
            eng.apply_snapshot(entries(n, changed_fixture(n)))
            assert eng.generation == g1 + 1
            assert {"apply_delta", "host_view"} <= set(staged)
        n.tv.clear_certificate_cache()
    assert got[1] == got[0]
    assert kind in {f["kind"] for f in got[1]}


def test_strict_verify_counts_and_reuse_equal():
    """Strict verify's translation counts through a reconcile sequence:
    the first install validates all, an identical resync reuses the
    vetted snapshot with every certificate a cache hit, one changed
    config validates one; off by default, where no snapshot is vetted."""
    got = []
    for n in (REF, PORT):
        n.tv.clear_certificate_cache()
        off = engine(n)
        off.apply_snapshot(entries(n, n.fixtures.fixture_configs()))
        eng = engine(n, strict_verify=True, analyze_policies=False)
        seq = [off.strict_verify, off._snapshot.lint_ok]
        for cfgs in (n.fixtures.fixture_configs(),
                     n.fixtures.fixture_configs(), changed_fixture(n)):
            eng.apply_snapshot(entries(n, cfgs))
            seq.append((eng._snapshot.lint_ok,
                        eng.debug_vars()["translation_validation"]))
        n.tv.clear_certificate_cache()
        got.append(seq)
    assert got[1] == got[0]
    assert got[1][:2] == [False, False]
    assert got[1][2][1]["validated"] == 3
    assert got[1][3][1] == {"validated": 0, "cache_hits": 3, "failed": 0,
                            "sampled": 0, "dfa_witnesses": 0}
    assert got[1][4][1]["validated"] == 1 and got[1][4][1]["cache_hits"] == 2


def test_engine_policy_analysis_and_lowerability_equal(caplog):
    import logging

    got = []
    for n in (REF, PORT):
        eng = engine(n)
        es = entries(n, n.fixtures.fixture_configs()
                     + n.fixtures.finding_fixture_configs())
        es[1].hosts.append("api.example.com")  # a planted duplicate host
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            eng.apply_snapshot(es)
        msgs = [r for r in caplog.records if "policy analysis" in r.message]
        dv = eng.debug_vars()
        got.append((dv["policy_analysis"], dv["lowerability"], len(msgs),
                    dv["provenance"]["dead_rules"]))
    assert got[1] == got[0]
    pa, low, n_logged, _ = got[1]
    assert pa["generation"] == 1 and n_logged == 1
    assert {"duplicate-host", "constant-allow", "constant-deny",
            "shadowed-rule", "duplicate-rule"} <= {
        f["kind"] for f in pa["findings"]}
    assert low["generation"] == 1 and low["fast"] == 6


def test_engine_surfaces_skipped_configs_equal():
    got = []
    for n in (REF, PORT):
        pats = [n.Pattern(f"a.k{i}", n.Operator.EQ, f"v{i}")
                for i in range(n.pa.MAX_ATOMS + 2)]
        eng = engine(n)
        eng.apply_snapshot(entries(n, [n.ConfigRules(
            name="ns/wide", evaluators=[(None, n.Any_(*pats))])]))
        got.append(eng.debug_vars()["policy_analysis"]["summary"])
    assert got[1] == got[0]
    assert got[1]["skipped_wide"] == 1
    assert got[1]["skipped"][0]["config"] == "ns/wide"
    try:
        from prometheus_client import REGISTRY
    except ImportError:
        return
    v = REGISTRY.get_sample_value(
        "auth_server_policy_analysis_skipped_total",
        {"authconfig": "ns/wide"})
    assert v is not None and v >= 2


def test_engine_analysis_fault_never_breaks_the_reconcile(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("analyzer fault")

    got = []
    for n in (REF, PORT):
        monkeypatch.setattr(n.pa, "analyze_snapshot", boom)
        eng = engine(n)
        eng.apply_snapshot(entries(n, n.fixtures.fixture_configs()))
        got.append((eng.generation, eng.debug_vars()["policy_analysis"]))
    assert got[1] == got[0] == (1, None)
