"""The port's PolicyModel against the JAX package's and the expression
oracle on random corpora (the differential of
tests/test_compiler_differential.py, built once per package from the same
seeded spec).  Verdicts are booleans: tolerance 0."""

import random

import numpy as np
import pytest

from authorino_tpu.models import PolicyModel as RefModel
from authorino_tpu.models.policy_model import host_results as r_host_results
from authorino_tpu_torch.models import PolicyModel
from authorino_tpu_torch.models import policy_model as p_pm

from test_torch_compiler import PORT, REF, build_case

SELECTORS = ["request.method", "request.url_path", "request.headers.x-org",
             "request.headers.x-tier", "auth.identity.username",
             "auth.identity.roles", "auth.identity.groups",
             "auth.identity.age"]
VALUES = ["GET", "POST", "DELETE", "/a", "/b/c", "acme", "umbrella", "gold",
          "john", "jane", "admin", "dev", "ops", "42", ""]


def random_expr(rng, ns, depth=0):
    if depth >= 3 or rng.random() < 0.5:
        Op = ns.Operator
        op = rng.choice([Op.EQ, Op.NEQ, Op.INCL, Op.EXCL, Op.MATCHES])
        sel = rng.choice(SELECTORS)
        if op is Op.MATCHES:
            # includes an invalid regex: errors must deny like the oracle
            val = rng.choice([r"^/a", r"\d+", r"^(GET|POST)$", r"adm.n",
                              r"^$", r"(["])
        else:
            val = rng.choice(VALUES)
        return ns.Pattern(sel, op, val)
    comb = ns.All if rng.random() < 0.5 else ns.Any_
    return comb(*[random_expr(rng, ns, depth + 1)
                  for _ in range(rng.randint(1, 4))])


def random_configs(seed, ns):
    rng = random.Random(seed)
    configs = []
    for i in range(rng.randint(2, 12)):
        evaluators = []
        for _ in range(rng.randint(1, 4)):
            cond = random_expr(rng, ns) if rng.random() < 0.4 else None
            evaluators.append((cond, random_expr(rng, ns)))
        configs.append(ns.ConfigRules(name=f"cfg-{i}", evaluators=evaluators))
    return configs


def random_doc(rng):
    roles = rng.sample(["admin", "dev", "ops", "root", "qa"],
                       k=rng.randint(0, 4))
    groups = [rng.choice(VALUES) for _ in range(rng.randint(0, 20))]
    doc = {"request": {"method": rng.choice(["GET", "POST", "DELETE", "PUT"]),
                       "url_path": rng.choice(["/a", "/b/c", "/x/9", ""]),
                       "headers": {}},
           "auth": {"identity": {}}}
    if rng.random() < 0.8:
        doc["request"]["headers"]["x-org"] = rng.choice(
            VALUES + ["unseen-org-xyz"])
    if rng.random() < 0.5:
        doc["request"]["headers"]["x-tier"] = rng.choice(["gold", "silver"])
    ident = doc["auth"]["identity"]
    if rng.random() < 0.9:
        ident["username"] = rng.choice(["john", "jane", "nobody-seen"])
    if rng.random() < 0.9:
        ident["roles"] = roles
    if rng.random() < 0.6:
        ident["groups"] = groups
    if rng.random() < 0.5:
        ident["age"] = rng.choice([42, 17, 0.5, None])
    return doc


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5])
def test_decide_rows_matches_reference_and_oracle(seed):
    r_policy = REF.compile_corpus(random_configs(seed, REF), members_k=8)
    p_policy = PORT.compile_corpus(random_configs(seed, PORT), members_k=8)
    rng = random.Random(seed + 100)
    docs = [random_doc(rng) for _ in range(64)]
    rows = [rng.randrange(p_policy.n_configs) for _ in docs]

    got = PolicyModel(p_policy, device="cpu").decide_rows(docs, rows)
    want = RefModel(r_policy).decide_rows(docs, rows)
    assert got == want
    for d, r, v in zip(docs, rows, got):
        p_own, p_rule, p_skip = p_pm.host_results(p_policy, d, r)
        r_own, r_rule, r_skip = r_host_results(r_policy, d, r)
        assert (p_own, p_rule.tolist(), p_skip.tolist()) == \
            (r_own, r_rule.tolist(), r_skip.tolist())
        assert v == p_own


@pytest.mark.parametrize("kind,ovf_assist", [("lanes", True),
                                             ("lanes", False),
                                             ("northstar", True)])
def test_apply_matches_host_oracle(kind, ovf_assist):
    _, pp, docs, rows = build_case(kind, 31, ovf_assist)
    model = PolicyModel(pp, device="cpu")
    db = model.encode(docs, rows)
    own, rule, skipped = model.apply(db)
    for i, (d, r) in enumerate(zip(docs, rows)):
        if db.host_fallback[i]:
            continue
        w_own, w_rule, w_skip = p_pm.host_results(pp, d, r)
        # the oracle does not evaluate a skipped evaluator's rule (it
        # reports True there); the kernel does, so compare rule bits only
        # where the evaluator ran
        ran = ~w_skip
        assert (bool(own[i]), skipped[i].tolist(), rule[i][ran].tolist()) \
            == (w_own, w_skip.tolist(), w_rule[ran].tolist()), i
    assert model.decide_rows(docs, rows) == \
        [p_pm.host_results(pp, d, r)[0] for d, r in zip(docs, rows)]


def test_host_fallback_cap_denies_fail_closed():
    own_rule = np.ones((4, 2), dtype=bool)
    own_skipped = np.ones((4, 2), dtype=bool)
    seen = []

    def decide(r):
        seen.append(r)
        return np.array([True, False]), np.array([False, True])

    before = dict(p_pm.FALLBACK_COUNTS)
    p_pm.apply_host_fallback(decide, np.array([0, 2, 3]), own_rule,
                             own_skipped, cap=2)
    assert seen == [0, 2]
    assert own_rule[0].tolist() == [True, False]
    assert not own_rule[3].any() and not own_skipped[3].any()
    assert own_rule[1].all()  # untouched row
    assert p_pm.FALLBACK_COUNTS["decided"] - before["decided"] == 2
    assert p_pm.FALLBACK_COUNTS["shed"] - before["shed"] == 1


def test_decide_by_name():
    _, pp, docs, rows = build_case("northstar", 7, True, n_docs=10)
    model = PolicyModel(pp, device="cpu")
    names = {v: k for k, v in pp.config_ids.items()}
    assert model.decide(docs, [names[r] for r in rows]) == \
        model.decide_rows(docs, rows)
