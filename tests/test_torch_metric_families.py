"""The metric families the port's registry lacked against the JAX
package's, for planes the port already serves: the host-fallback counters
metered in ``apply_host_fallback`` and the relation-table gauges set at
every snapshot install.  Both packages record into one collector per name
(``utils/metrics.py``), so each package's delta is read in turn."""

import numpy as np
import pytest

from authorino_tpu.models import policy_model as r_pm
from authorino_tpu.runtime import EngineEntry as RefEntry
from authorino_tpu.runtime import PolicyEngine as RefEngine
from authorino_tpu_torch.models import policy_model as p_pm
from authorino_tpu_torch.runtime import EngineEntry, PolicyEngine

from test_torch_compiler import PORT, REF, all_lanes_corpus, batch_of, \
    build_case

REGISTRY = pytest.importorskip("prometheus_client").REGISTRY

FALLBACK = ("auth_server_host_fallback_total",
            "auth_server_host_fallback_shed_total")
RELATION = ("auth_server_relation_table_rows",
            "auth_server_relation_table_bytes")


def sample(name):
    return REGISTRY.get_sample_value(name) or 0.0


@pytest.mark.parametrize("cap", [None, 2, 0])
def test_host_fallback_counters_equal_reference(cap):
    rp, pp, docs, rows = build_case("lanes", 5, False)
    db = batch_of(PORT, pp, docs, rows)
    fb = np.nonzero(db.host_fallback[:len(docs)])[0]
    assert len(fb) > 2  # K+3 role lists overflow K=4
    got = {}
    for tag, pm, policy in (("ref", r_pm, rp), ("port", p_pm, pp)):
        E = int(policy.eval_rule.shape[1])
        own_rule = np.ones((len(docs), E), dtype=bool)
        own_skipped = np.zeros((len(docs), E), dtype=bool)
        before = [sample(n) for n in FALLBACK]
        pm.apply_host_fallback(
            lambda r, pm=pm, policy=policy: pm.host_results(
                policy, docs[r], rows[r])[1:],
            fb, own_rule, own_skipped, cap)
        got[tag] = ([sample(n) - b for n, b in zip(FALLBACK, before)],
                    own_rule.tolist(), own_skipped.tolist())
    assert got["port"] == got["ref"]
    decided = len(fb) if cap is None else min(cap, len(fb))
    assert got["port"][0] == [decided, len(fb) - decided]


@pytest.mark.parametrize("with_relations", [True, False])
def test_relation_table_gauges_equal_reference(with_relations):
    if with_relations:
        r_cfgs, p_cfgs = all_lanes_corpus(7, REF), all_lanes_corpus(7, PORT)
    else:
        r_cfgs, p_cfgs = [[ns.ConfigRules(name="plain", evaluators=[
            (None, ns.Pattern("request.method", ns.Operator.EQ, "GET"))])]
            for ns in (REF, PORT)]
    ref = RefEngine(max_batch=16, members_k=4, mesh=None, lane_select=False)
    ref.apply_snapshot([RefEntry(id=c.name, hosts=[c.name], runtime=None,
                                 rules=c) for c in r_cfgs])
    want = [sample(n) for n in RELATION]
    for n in RELATION:  # the port must set them itself
        REGISTRY._names_to_collectors[n].set(-1)
    port = PolicyEngine(max_batch=16, members_k=4, device="cpu",
                        lane_select=False)
    port.apply_snapshot([EngineEntry(id=c.name, hosts=[c.name], rules=c)
                         for c in p_cfgs])
    got = [sample(n) for n in RELATION]
    assert got == want
    policy = port._snapshot.policy
    if with_relations:
        assert got == [policy.rel_bits.shape[0], policy.rel_bits.nbytes] \
            and got[0] > 0
    else:
        assert got == [0, 0]


HOST_LANE_FAMILIES = ("brownout_decisions", "brownout_batches",
                      "lane_decisions", "lane_cost_ewma",
                      "speculative_dispatch")


@pytest.mark.parametrize("attr", HOST_LANE_FAMILIES)
def test_host_lane_families_equal_the_reference(attr):
    """The five families of the host lanes are in the port's registry with
    the reference's name, type and labels, and one selector's feeds move
    them as the reference's move (deltas: one registry holds both)."""
    from authorino_tpu.runtime import lane_select as r_ls
    from authorino_tpu.utils import metrics as r_metrics
    from authorino_tpu_torch.runtime import lane_select as p_ls
    from authorino_tpu_torch.utils import metrics as p_metrics

    got, want = getattr(p_metrics, attr), getattr(r_metrics, attr)
    assert type(got) is type(want)
    assert (got._name, got._labelnames) == (want._name, want._labelnames)

    def feed(ls):
        s = ls.LaneSelector(f"fam-{attr}")
        s.count(ls.HOST, ls.R_COST, 3)
        s.count_speculative("launched")
        s.cost.observe_host(0.002, 4)
        return [REGISTRY.get_sample_value(n, lab) or 0.0 for n, lab in (
            ("auth_server_lane_decisions_total",
             {"lane": f"fam-{attr}-host", "reason": "cost-model"}),
            ("auth_server_lane_cost_ewma_seconds",
             {"lane": f"fam-{attr}", "which": "host"}))]

    assert feed(r_ls) == [3.0, 0.0005]
    assert feed(p_ls) == [6.0, 0.0005]
