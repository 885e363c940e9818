"""The port's decision corpus against the JAX package's.

Distillation (captured records folded into frequency-weighted rows keyed
by the canonical row key), the corpus container, coverage and truth-table
row synthesis, the weighted corpus replay and its preflight, the engine's
corpus pregate (which the port runs before the candidate is staged), and
the history bisect over a published chain.  Each case of the reference's
``tests/test_corpus.py`` runs through both packages on the same seeded
inputs, and their outputs must be equal (tolerance 0: rows, reports and
verdicts are JSON values, integers and booleans).  The synthesized rows'
kernel verdicts are held to the reference's fused kernel (the Pallas
kernel in interpret mode) byte for byte."""

from __future__ import annotations

import hashlib
import json
import random
import struct
from types import SimpleNamespace

import jax.numpy as jnp  # noqa: F401  (the reference's kernel runs on jax)
import numpy as np
import pytest

import authorino_tpu.corpus as r_corpus
import authorino_tpu.corpus.bisect as r_bisect
import authorino_tpu.corpus.pregate as r_pregate
import authorino_tpu.corpus.store as r_store
import authorino_tpu.corpus.synthesize as r_synth
import authorino_tpu.snapshots.distribution as r_dist
import authorino_tpu_torch.corpus as p_corpus
import authorino_tpu_torch.corpus.bisect as p_bisect
import authorino_tpu_torch.corpus.pregate as p_pregate
import authorino_tpu_torch.corpus.store as p_store
import authorino_tpu_torch.corpus.synthesize as p_synth
import authorino_tpu_torch.snapshots.distribution as p_dist
from authorino_tpu.analysis import fixtures as r_fixtures
from authorino_tpu.compiler import compile_corpus as r_compile
from authorino_tpu.compiler.encode import encode_batch_py as r_encode
from authorino_tpu.compiler.pack import pack_batch as r_pack
from authorino_tpu.models.policy_model import host_results as r_host
from authorino_tpu.ops import fused_kernel as r_fk
from authorino_tpu.ops import pattern_eval as r_pe
from authorino_tpu.runtime import EngineEntry as RefEntry
from authorino_tpu.runtime import PolicyEngine as RefEngine
from authorino_tpu.runtime.change_safety import GuardThresholds as RefTH
from authorino_tpu_torch.analysis import fixtures as p_fixtures
from authorino_tpu_torch.compiler import compile_corpus as p_compile
from authorino_tpu_torch.compiler.encode import encode_batch_py as p_encode
from authorino_tpu_torch.compiler.pack import pack_batch as p_pack
from authorino_tpu_torch.models.policy_model import host_results as p_host
from authorino_tpu_torch.ops import fused_kernel as p_fk
from authorino_tpu_torch.ops import operands as p_ops
from authorino_tpu_torch.runtime import EngineEntry, PolicyEngine
from authorino_tpu_torch.runtime.change_safety import GuardThresholds

from test_torch_compiler import PORT as PORT_NS
from test_torch_compiler import REF as REF_NS


def ref_engine(**kw):
    return RefEngine(mesh=None, lane_select=False, kernel_lane="fused", **kw)


def port_engine(**kw):
    return PolicyEngine(device="cpu", **kw)


REF = SimpleNamespace(
    name="ref", ns=REF_NS, corpus=r_corpus, store=r_store, synth=r_synth,
    pregate=r_pregate, bisect=r_bisect, dist=r_dist, fixtures=r_fixtures,
    compile=r_compile, host=r_host, Entry=RefEntry, make=ref_engine,
    TH=RefTH(min_requests=8, min_config_requests=1, min_config_allows=1),
    firing=r_pe.firing_columns)
PORT = SimpleNamespace(
    name="port", ns=PORT_NS, corpus=p_corpus, store=p_store, synth=p_synth,
    pregate=p_pregate, bisect=p_bisect, dist=p_dist, fixtures=p_fixtures,
    compile=p_compile, host=p_host, Entry=EngineEntry, make=port_engine,
    TH=GuardThresholds(min_requests=8, min_config_requests=1,
                       min_config_allows=1),
    firing=p_ops.firing_columns)

NOW = 1_700_000_000.0


def both_equal(scenario, *args):
    want = scenario(REF, *args)
    got = scenario(PORT, *args)
    assert got == want
    return got


def api_doc(i=0):
    return {"request": {"method": "GET", "url_path": f"/api/v1/x{i}",
                        "host": "h", "headers": {"x-tag": "aa"}},
            "auth": {"identity": {"org": "acme", "roles": ["admin"],
                                  "groups": []}}}


def api_records(n, shapes=1):
    return [{"authconfig": "api", "doc": api_doc(i % shapes),
             "t": 1.0 + i * 1e-3} for i in range(n)]


def constant_deny_admin(pkg):
    """The fixture corpus with ``admin``'s evaluator 0 rewritten to the
    unsatisfiable All(org EQ acme, org NEQ acme): the planted edit on a
    config no captured traffic ever hits."""
    ns = pkg.ns
    org = ns.Pattern("auth.identity.org", ns.Operator.EQ, "acme")
    norg = ns.Pattern("auth.identity.org", ns.Operator.NEQ, "acme")
    cfgs = pkg.fixtures.fixture_configs()
    for i, c in enumerate(cfgs):
        if c.name == "admin":
            cfgs[i] = ns.ConfigRules(name="admin", evaluators=[
                (None, ns.All(org, norg)), c.evaluators[1]])
    return cfgs


def entries_of(pkg, cfgs):
    return [pkg.Entry(id=c.name, hosts=[c.name], runtime=None, rules=c)
            for c in cfgs]


def captured_and_synth(pkg, n=32):
    baseline = pkg.fixtures.fixture_policy()
    captured = pkg.corpus.distill_records(api_records(n), baseline)["rows"]
    synth = pkg.synth.augment_corpus(baseline, captured, now=NOW)["rows"]
    return baseline, captured, synth


# ---- distillation -----------------------------------------------------------

def test_100k_records_distill_with_weights_preserved():
    n, shapes = 100_000, 8

    def scenario(pkg):
        return pkg.corpus.distill_records(api_records(n, shapes=shapes),
                                          pkg.fixtures.fixture_policy())

    d = both_equal(scenario)
    rows = d["rows"]
    assert len(rows) == shapes and sum(r["weight"] for r in rows) == n
    assert d["dedup_ratio"] == n / shapes
    assert d["counters"] == {"records_in": n, "distilled": shapes,
                             "deduped": n - shapes, "dropped_unparseable": 0,
                             "fallback_keys": 0}
    for r in rows:
        assert r["origin"] == "captured"
        assert r["row_key"] and not r["row_key"].startswith("doc:")
        assert r["first_seen"] <= r["last_seen"]
        assert r["verdict"] == "allow" and r["rule_index"] == -1


def test_distill_accounts_unparseable_never_drops_silently():
    recs = api_records(4) + [{"authconfig": "api", "doc": None, "t": 9.0},
                             {"doc": api_doc(), "t": 9.0}]
    d = both_equal(lambda pkg: pkg.corpus.distill_records(
        recs, pkg.fixtures.fixture_policy()))
    assert d["counters"]["dropped_unparseable"] == 2
    assert sum(r["weight"] for r in d["rows"]) == 4


def test_distill_keeps_missing_config_rows_bisectable():
    recs = [{"authconfig": "retired", "doc": api_doc(), "t": 1.0,
             "verdict": "deny", "rule_index": 0}]
    d = both_equal(lambda pkg: pkg.corpus.distill_records(
        recs, pkg.fixtures.fixture_policy()))
    (row,) = d["rows"]
    assert row["verdict"] == "deny" and row["row_key"].startswith("doc:")
    assert d["counters"]["fallback_keys"] == 1


# ---- the container ----------------------------------------------------------

def test_container_round_trip_bit_identical(tmp_path):
    rows = both_equal(lambda pkg: pkg.corpus.distill_records(
        api_records(16, shapes=4), pkg.fixtures.fixture_policy())["rows"])
    for writer, reader in ((PORT, REF), (REF, PORT), (PORT, PORT)):
        d = tmp_path / f"{writer.name}-{reader.name}"
        d.mkdir()
        p = str(d / "c.atpucorp")
        writer.corpus.write_corpus(p, rows, meta={"note": "t"})
        header, back = reader.corpus.read_corpus_file(p)
        assert back == rows
        assert header["count"] == 4 and header["meta"] == {"note": "t"}
        writer.corpus.write_corpus(str(d / "a.atpucorp"), rows[:1])
        assert reader.corpus.read_corpus(str(d)) == rows[:1] + rows
    # the payloads are byte-equal (the header's creation time aside)
    a = open(tmp_path / "port-ref" / "c.atpucorp", "rb").read()
    b_path = tmp_path / "ref-port" / "c.atpucorp"
    b = open(b_path, "rb").read()
    mlen = len(p_store.MAGIC)
    (ha,) = struct.unpack_from("<Q", a, mlen)
    (hb,) = struct.unpack_from("<Q", b, mlen)
    assert a[mlen + 8 + ha:-32] == b[mlen + 8 + hb:-32]
    assert p_store.MAGIC == r_store.MAGIC


@pytest.mark.parametrize("mutate", ["truncate", "magic", "flip", "version",
                                    "schema"])
def test_container_rejects_skew_typed(tmp_path, mutate):
    rows = p_corpus.distill_records(api_records(4),
                                    p_fixtures.fixture_policy())["rows"]
    p = str(tmp_path / "c.atpucorp")
    p_corpus.write_corpus(p, rows)
    blob = open(p, "rb").read()
    magic = p_store.MAGIC
    if mutate == "truncate":
        blob = blob[:10]
    elif mutate == "magic":
        blob = b"NOTACORP1\x00" + blob[len(magic):]
    elif mutate == "flip":
        b = bytearray(blob)
        b[len(b) // 2] ^= 0xFF
        blob = bytes(b)
    else:
        # a skewed header under a valid checksum: the version or schema
        # gate must fire, not the checksum's
        (hlen,) = struct.unpack_from("<Q", blob, len(magic))
        start = len(magic) + 8
        header = json.loads(blob[start:start + hlen])
        header["version" if mutate == "version" else "schema"] += 1
        hb = json.dumps(header, sort_keys=True,
                        separators=(",", ":")).encode()
        body = magic + struct.pack("<Q", len(hb)) + hb \
            + blob[start + hlen:-32]
        blob = body + hashlib.sha256(body).digest()
    with open(p, "wb") as f:
        f.write(blob)
    with pytest.raises(p_corpus.CorpusFormatError) as pe_:
        p_corpus.read_corpus_file(p)
    with pytest.raises(r_corpus.CorpusFormatError) as re_:
        r_corpus.read_corpus_file(p)
    assert str(pe_.value) == str(re_.value)


# ---- coverage and synthesis -------------------------------------------------

def test_synthesis_covers_unexercised_columns_verified_by_oracle():
    def scenario(pkg):
        policy = pkg.fixtures.fixture_policy()
        captured = pkg.corpus.distill_records(api_records(32),
                                              policy)["rows"]
        aug = pkg.synth.augment_corpus(policy, captured, now=NOW)
        checks = []
        for row in aug["rows"]:
            own, rule_res, skipped = pkg.host(
                policy, row["doc"], policy.config_ids[row["authconfig"]])
            fire = int(pkg.firing(rule_res[None, :], skipped[None, :])[0])
            checks.append(((row["verdict"] == "allow") == bool(own),
                           fire == row["rule_index"]))
        return aug, checks

    aug, checks = both_equal(scenario)
    assert aug["coverage_after"]["fraction"] \
        > aug["coverage_before"]["fraction"]
    assert checks and all(a and b for a, b in checks)
    for row in aug["rows"]:
        assert row["origin"] == "synthetic" and row["weight"] == 1
    allows = {r["authconfig"] for r in aug["rows"]
              if r["verdict"] == "allow"}
    assert {"admin", "public"} <= allows
    fired = {(r["authconfig"], r["rule_index"]) for r in aug["rows"]
             if r["verdict"] == "deny"}
    assert ("admin", 0) in fired and ("admin", 1) in fired


def test_uncoverable_columns_get_typed_reasons_never_skipped():
    def scenario(pkg):
        _, report = pkg.synth.synthesize_rows(pkg.fixtures.fixture_policy(),
                                              now=NOW)
        _, rreport = pkg.synth.synthesize_rows(
            pkg.fixtures.relations_fixture_policy(), now=NOW)
        return report, rreport

    report, rreport = both_equal(scenario)
    assert report["targets"] == report["synthesized"] \
        + len(report["uncoverable"])
    assert {"config": "public", "evaluator": 0,
            "reason": "unsatisfiable"} in report["uncoverable"]
    reasons = {(u["config"], u["evaluator"]): u["reason"]
               for u in rreport["uncoverable"]}
    assert reasons.get(("hier", 1)) == "materialization-failed"


def test_coverage_report_marks_exercised_columns():
    def scenario(pkg):
        policy = pkg.fixtures.fixture_policy()
        rows, _ = pkg.synth.synthesize_rows(policy, targets=[("api", 0)],
                                            now=NOW)
        return pkg.synth.coverage_report(policy, rows)

    cov = both_equal(scenario)
    api = cov["configs"]["api"]
    assert api["columns"][0]["exercised"] and api["unexercised"] == [1]
    assert cov["columns_exercised"] == 1


def _rand_corpus(pkg, rng: random.Random, n_configs=5):
    """The reference's seeded random corpus over the synthesizable atom
    classes (interned equality, membership, DFA regex, int numerics), with
    ``pkg``'s classes."""
    ns = pkg.ns
    orgs = ("acme", "beta", "gamma")
    roles = ("admin", "dev", "ops")
    rxs = (r"^/api/v[0-9]+/", r"^/public/", r"^/v2/[a-z]+$")
    cfgs = []
    for i in range(n_configs):
        evs = [
            (None, ns.All(ns.Pattern("auth.identity.org", ns.Operator.EQ,
                                     rng.choice(orgs)),
                          ns.Pattern("auth.identity.roles",
                                     ns.Operator.INCL, rng.choice(roles)))),
            (None, ns.Any_(ns.Pattern("request.size", ns.Operator.GE,
                                      str(rng.choice((10, 1024)))),
                           ns.Pattern("request.url_path",
                                      ns.Operator.MATCHES,
                                      rng.choice(rxs)))),
        ]
        if rng.random() < 0.5:
            evs.reverse()
        cfgs.append(ns.ConfigRules(name=f"c{i}", evaluators=evs))
    return cfgs


@pytest.mark.parametrize("seed", [7, 19, 31])
def test_synthesized_rows_decide_on_the_kernel_as_recorded(seed):
    """The same synthesized rows from both packages; encoded, the port's
    kernel (its plain version here) gives the reference's fused readback
    byte for byte, and each row's recorded verdict and attribution."""
    r_policy = r_compile(_rand_corpus(REF, random.Random(seed)),
                         members_k=4, ovf_assist=True)
    p_policy = p_compile(_rand_corpus(PORT, random.Random(seed)),
                         members_k=4, ovf_assist=True)
    rows, report = p_synth.synthesize_rows(p_policy, now=NOW)
    assert (rows, report) == r_synth.synthesize_rows(r_policy, now=NOW)
    assert report["synthesized"] >= len(p_policy.config_ids)
    docs = [r["doc"] for r in rows]
    gids = [p_policy.config_ids[r["authconfig"]] for r in rows]
    p_db = p_pack(p_policy, p_encode(p_policy, docs, gids))
    r_db = r_pack(r_policy, r_encode(r_policy, docs, gids))
    assert not p_db.host_fallback.any()
    packed = p_fk.eval_fused_kernel(p_ops.to_device(p_policy, device="cpu"),
                                    p_db).numpy()
    want = np.asarray(r_fk.eval_fused_kernel(
        r_pe.to_device(r_policy, lane="fused"), r_db))
    np.testing.assert_array_equal(packed, want)
    verdict, firing = p_ops.unpack_attribution(
        packed, int(p_policy.eval_rule.shape[1]))
    for i, row in enumerate(rows):
        assert bool(verdict[i]) == (row["verdict"] == "allow"), (seed, i)
        assert int(firing[i]) == row["rule_index"], (seed, i)


# ---- the weighted replay and its preflight -----------------------------------

def test_replay_corpus_weights_flips_by_frequency():
    def scenario(pkg):
        old = pkg.fixtures.fixture_policy()
        new = pkg.compile(constant_deny_admin(pkg))
        rows = pkg.corpus.distill_records(api_records(16), old)["rows"]
        admin_doc = api_doc()
        admin_doc["request"]["host"] = "/api/v1/h"
        rows += [{"schema": 1, "authconfig": "admin", "doc": admin_doc,
                  "verdict": "allow", "rule_index": -1, "rule": "",
                  "weight": 40_000, "first_seen": 1.0, "last_seen": 2.0,
                  "origin": "captured", "row_key": "k", "generation": 1}]
        rep = pkg.pregate.replay_corpus(old, new, rows)
        for k in ("platform", "elapsed_ms"):
            rep.pop(k)
        return rep

    rep = both_equal(scenario)
    assert rep["flips"]["newly_denied"] == 40_000
    assert rep["replayed"] == 40_016 and rep["replayed_rows"] == 2
    assert rep["per_config"]["admin"]["newly_denied"] == 40_000
    assert rep["origins"]["captured"]["flips"] == 40_000
    assert rep["load_model"] == "corpus"


def test_corpus_preflight_catches_zero_traffic_edit_on_synth_rows_only():
    def scenario(pkg):
        baseline, captured, synth = captured_and_synth(pkg)
        candidate = pkg.compile(constant_deny_admin(pkg))
        blind = pkg.pregate.corpus_preflight(baseline, candidate, captured,
                                             pkg.TH, changed={"admin"})
        pf = pkg.pregate.corpus_preflight(baseline, candidate,
                                          captured + synth, pkg.TH,
                                          changed={"admin"})
        clean = pkg.pregate.corpus_preflight(
            baseline, pkg.compile(pkg.fixtures.fixture_configs()),
            captured + synth, pkg.TH, changed={"admin"})
        return (blind["breach"], pf["breach"], pf["report"]["origins"],
                pf["report"]["flips"], clean["breach"])

    blind, breach, origins, flips, clean = both_equal(scenario)
    assert blind is None and clean is None
    assert breach is not None and "admin" in breach["suspects"]
    assert origins["captured"]["flips"] == 0
    assert origins["synthetic"]["flips"] >= 1


# ---- the engine's corpus pregate ---------------------------------------------

def engine_pregate(pkg, corpus_path, write=True):
    if write:
        pkg.corpus.write_corpus(corpus_path, pkg.corpus.distill_records(
            api_records(32), pkg.fixtures.fixture_policy())["rows"])
    engine = pkg.make(max_batch=8, analyze_policies=False,
                      metadata_prefetch=False, canary_thresholds=pkg.TH,
                      corpus_pregate=corpus_path)
    engine.apply_snapshot(entries_of(pkg, pkg.fixtures.fixture_configs()))
    gen_before = engine.generation
    obs = {}
    try:
        engine.apply_snapshot(entries_of(pkg, constant_deny_admin(pkg)))
        obs["rejected"] = None
    except Exception as e:
        obs["rejected"] = (type(e).__name__,
                           getattr(e, "corpus_diff", {}).get("suspects"),
                           getattr(e, "findings", None))
    obs["kept"] = engine.generation == gen_before
    dv = engine.debug_vars()["corpus"]
    last = dict(dv["last"])
    last.pop("elapsed_ms", None)
    dv = dict(dv, last=last, source=None,
              load_error=bool(dv["load_error"]))
    obs["vars"] = dv
    engine.apply_snapshot(entries_of(pkg, pkg.fixtures.fixture_configs()))
    obs["clean_lands"] = engine.generation > gen_before
    return obs, engine


def test_engine_corpus_pregate_rejects_with_zero_live_exposure(tmp_path):
    (want, _) = engine_pregate(REF, str(tmp_path / "r.atpucorp"))
    (got, engine) = engine_pregate(PORT, str(tmp_path / "p.atpucorp"))
    assert got == want
    assert got["rejected"][0] == "SnapshotRejected"
    assert "admin" in got["rejected"][1] and got["kept"]
    dv = got["vars"]
    assert dv["enabled"] and dv["rows_captured"] >= 1
    assert dv["rows_synthetic"] >= 1 and dv["last"]["result"] == "breach"
    assert dv["last"]["origins"]["synthetic"]["flips"] >= 1
    assert dv["last"]["origins"]["captured"]["flips"] == 0
    assert got["clean_lands"]


def test_engine_corpus_pregate_rejects_before_staging(tmp_path,
                                                      monkeypatch):
    """The port judges the corpus before the candidate's device half: a
    rejected candidate builds no encoder, host view or upload."""
    from authorino_tpu_torch.runtime import engine as engine_mod

    staged = []
    real = engine_mod._Snapshot.stage

    def spy(self, device, prev=None):
        staged.append(self)
        return real(self, device, prev)

    monkeypatch.setattr(engine_mod._Snapshot, "stage", spy)
    obs, engine = engine_pregate(PORT, str(tmp_path / "p.atpucorp"))
    assert obs["rejected"][0] == "SnapshotRejected"
    # the first install and the clean re-apply staged; the rejected
    # candidate never did
    assert len(staged) == 2


def test_engine_corpus_pregate_missing_file_skips_never_blocks(tmp_path):
    def scenario(pkg):
        obs, _ = engine_pregate(pkg, str(tmp_path / "absent.atpucorp"),
                                write=False)
        return obs

    obs = both_equal(scenario)
    assert obs["rejected"] is None and not obs["kept"]
    assert obs["vars"]["last"]["result"] == "skipped"
    assert obs["vars"]["load_error"]


# ---- the history bisect ------------------------------------------------------

def _publish_chain(pkg, directory, bad_from=3, n=4):
    pub = pkg.dist.SnapshotPublisher(directory, keep=n + 2)
    for gen in range(1, n + 1):
        cfgs = constant_deny_admin(pkg) if gen >= bad_from \
            else pkg.fixtures.fixture_configs()
        pub.publish_blob(
            pkg.dist.serialize_policy(pkg.compile(cfgs),
                                      meta={"generation": gen}), gen, {})


def corpus_diff(pkg, directory, bad_from, n_records):
    _publish_chain(pkg, directory, bad_from=bad_from, n=4)
    chain = pkg.bisect.load_generation_chain(directory)
    baseline = pkg.fixtures.fixture_policy()
    captured = pkg.corpus.distill_records(api_records(n_records),
                                          baseline)["rows"]
    rows = captured + pkg.synth.augment_corpus(baseline, captured,
                                               now=NOW)["rows"]
    report = pkg.bisect.corpus_diff(chain, rows)
    report.pop("elapsed_ms")
    return [s.generation for s in chain], report


def test_corpus_diff_attributes_flip_to_exact_generation(tmp_path):
    gens, report = corpus_diff(PORT, str(tmp_path / "p"), 3, 32)
    assert (gens, report) == corpus_diff(REF, str(tmp_path / "r"), 3, 32)
    assert gens == [1, 2, 3, 4] and report["flipped_rows"] >= 1
    assert set(report["by_generation"]) == {"3"}
    flip = report["flips"][0]
    assert (flip["generation"], flip["from_generation"]) == (3, 2)
    assert flip["authconfig"] == "admin"
    assert flip["direction"] == "newly-denied"
    assert flip["origins"] == ["synthetic"]


def test_corpus_diff_clean_chain_reports_no_flips(tmp_path):
    gens, report = corpus_diff(PORT, str(tmp_path / "p"), 99, 8)
    assert (gens, report) == corpus_diff(REF, str(tmp_path / "r"), 99, 8)
    assert report["flips"] == [] and report["flipped_rows"] == 0


def test_the_port_bisects_the_references_chain(tmp_path):
    """A chain the reference published, bisected by the port, names the
    generation the reference's bisect names."""
    d = str(tmp_path)
    _publish_chain(REF, d, bad_from=2, n=4)
    baseline = p_fixtures.fixture_policy()
    captured = p_corpus.distill_records(api_records(8), baseline)["rows"]
    rows = captured + p_synth.augment_corpus(baseline, captured,
                                             now=NOW)["rows"]
    got = p_bisect.corpus_diff(p_bisect.load_generation_chain(d), rows)
    want = r_bisect.corpus_diff(r_bisect.load_generation_chain(d), rows)
    got.pop("elapsed_ms")
    want.pop("elapsed_ms")
    assert got == want and set(got["by_generation"]) == {"2"}
