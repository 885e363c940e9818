"""The port's traffic capture, offline replay and replay pregate against
the JAX package's.

Each case builds the same seeded input for both packages and compares with
tolerance 0: capture segments byte for byte (each package writes, the
other reads), ring accounting, replay reports, pregate verdicts, and the
engine's capture hook and pregate on the reconcile path (a breach exposes
no request to the candidate, and the port stages none of its bytes; a
clean preflight halves the canary's deny-delta thresholds).

One divergence by design (ROADMAP queue 3): a replay report's
``platform`` stamp names the package's array library, ``torch`` in the
port where the reference names ``jax``; the reports are compared without
it (and without ``elapsed_ms``, a wall-clock reading)."""

from __future__ import annotations

import asyncio
import hashlib
import importlib
import json
import os
import struct
from types import SimpleNamespace

import numpy as np
import pytest

REF_ROOT, PORT_ROOT = "authorino_tpu", "authorino_tpu_torch"


def ns(root: str) -> SimpleNamespace:
    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    expr = m("expressions")
    return SimpleNamespace(
        root=root, cap=m("replay.capture"), replay=m("replay.replay"),
        pregate=m("replay.pregate"), bench_load=m("replay.bench_load"),
        engine_mod=m("runtime.engine"), prov=m("runtime.provenance"),
        cs=m("runtime.change_safety"), fr=m("runtime.flight_recorder"),
        http=m("service.http_server"), Pattern=expr.Pattern,
        Operator=expr.Operator, ConfigRules=m("compiler").ConfigRules,
        compile_corpus=m("compiler").compile_corpus)


REF, PORT = ns(REF_ROOT), ns(PORT_ROOT)
BOTH = (REF, PORT)


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def org_corpus(n, orgs):
    return [n.ConfigRules(name=name, evaluators=[
        (None, n.Pattern("auth.identity.org", n.Operator.EQ, org))])
        for name, org in orgs.items()]


def entries_of(n, cfgs):
    return [n.engine_mod.EngineEntry(id=c.name, hosts=[c.name],
                                     runtime=None, rules=c) for c in cfgs]


def cdoc(j, org):
    return {"request": {"host": f"h{j}", "path": f"/p{j}", "method": "GET"},
            "auth": {"identity": {"org": org}}}


def make_record(i, name="cfg-a", org="acme", allow=True):
    return {"schema": 2, "t": 100.0 + i * 0.01,
            "authconfig": name, "doc": cdoc(i, org),
            "verdict": "allow" if allow else "deny",
            "rule_index": -1 if allow else 0,
            "lane": "engine", "generation": 1}


def thresholds(n):
    return n.cs.GuardThresholds(min_requests=8, min_config_requests=4,
                                min_config_allows=2)


def comparable(report):
    """A replay report without its wall-clock reading and its platform
    stamp (the divergence by design)."""
    out = dict(report)
    out.pop("elapsed_ms", None)
    out.pop("platform", None)
    return out


@pytest.fixture
def capture():
    """Arm both packages' process-wide capture logs (rings only) and
    restore them."""
    for n in BOTH:
        n.cap.CAPTURE.configure(enabled=True, size_mb=4, sample_n=1)
        n.cap.CAPTURE.clear()
    yield
    for n in BOTH:
        n.cap.CAPTURE.configure(enabled=False)
        n.cap.CAPTURE.directory = None
        n.cap.CAPTURE.clear()


# ---------------------------------------------------------------------------
# the capture log
# ---------------------------------------------------------------------------


def accounting(log):
    j = log.to_json()
    return {k: j[k] for k in ("ring_records", "ring_bytes", "stored_total",
                              "dropped_total", "evicted_total",
                              "encode_failures", "schema", "size_bytes")}


def test_ring_byte_cap_equal():
    got = []
    for n in BOTH:
        log = n.cap.CaptureLog(enabled=True, size_mb=0.01)
        for i in range(500):
            log.offer("cfg", cdoc(i, "acme" * 10), -1, "engine", 1, t=float(i))
            if i % 50 == 0:
                log.flush()
        assert log.flush()
        got.append((accounting(log), log.ring_records()))
    assert got[1] == got[0]
    acc, recs = got[1]
    assert acc["ring_bytes"] <= acc["size_bytes"]
    assert acc["evicted_total"] > 0 and acc["stored_total"] == 500
    assert acc["dropped_total"] == 0
    assert recs[-1]["doc"]["request"]["host"] == "h499"


def test_queue_overflow_disabled_and_sampling_equal():
    got = []
    for n in BOTH:
        log = n.cap.CaptureLog(enabled=True, queue_max=16)
        for i in range(64):
            log.offer("cfg", cdoc(i, "acme"), -1, "engine", 1)
        queued, dropped = len(log._queue), log.dropped_total
        log.flush()
        off = n.cap.CaptureLog(enabled=False)
        off.offer("cfg", cdoc(0, "acme"), -1, "engine", 1)
        s8 = n.cap.CaptureLog(enabled=True, sample_n=8)
        picks = [list(s8.sample_indices(10)) for _ in range(100)]
        s1 = n.cap.CaptureLog(enabled=True, sample_n=1)
        got.append((queued, dropped, log.stored_total + log.dropped_total,
                    off.sample_indices(100), len(off._queue), picks,
                    list(s1.sample_indices(5))))
    assert got[1] == got[0]
    queued, dropped, total, inert, q_off, picks, every = got[1]
    assert queued <= 17 and dropped >= 47 and total == 64
    assert inert == () and q_off == 0
    assert 100 <= sum(map(len, picks)) <= 150
    assert every == [0, 1, 2, 3, 4]


def pinned_clock(monkeypatch, at=1700000000.25):
    for n in BOTH:
        monkeypatch.setattr(n.cap.time, "time", lambda: at)


def test_segments_byte_equal_and_cross_readable(tmp_path, monkeypatch):
    """The same records make byte-equal segments in both packages, and
    each package reads the other's back to equal records."""
    pinned_clock(monkeypatch)
    records = [make_record(i, allow=(i % 3 != 0)) for i in range(25)]
    records[3]["metadata_doc_digest"] = "ab" * 32
    paths = {}
    for n in BOTH:
        p = str(tmp_path / f"{n.root}{n.cap.SEGMENT_SUFFIX}")
        n.cap.write_segment(p, records, meta={"note": "test"})
        paths[n.root] = p
    blobs = [open(paths[n.root], "rb").read() for n in BOTH]
    assert blobs[1] == blobs[0]
    for reader in BOTH:
        for writer in BOTH:
            header, rt = reader.cap.read_segment(paths[writer.root])
            assert rt == records
            assert header["schema"] == 2 and header["count"] == 25
    assert [PORT.cap.encode_record(r) for r in records] == \
        [REF.cap.encode_record(r) for r in records]


def test_capture_log_segments_byte_equal(tmp_path, monkeypatch):
    """Two capture logs fed the same offers persist byte-equal segments,
    each readable by the other package."""
    pinned_clock(monkeypatch)
    dirs = {}
    for n in BOTH:
        d = str(tmp_path / n.root)
        log = n.cap.CaptureLog(enabled=True, size_mb=1.0)
        log.configure(directory=d, segment_mb=0.004)
        for i in range(120):
            log.offer("cfg-a", cdoc(i, "acme"), -1, "engine", 1, t=float(i),
                      metadata_doc_digest=None if i % 2 else "d" * 64)
        assert log.flush()
        dirs[n.root] = d
    names = [sorted(os.listdir(dirs[n.root])) for n in BOTH]
    assert names[1] == names[0] and len(names[0]) >= 2
    for name in names[0]:
        assert open(os.path.join(dirs[PORT_ROOT], name), "rb").read() == \
            open(os.path.join(dirs[REF_ROOT], name), "rb").read()
    want = REF.cap.read_capture(dirs[REF_ROOT])
    assert PORT.cap.read_capture(dirs[REF_ROOT]) == want
    assert REF.cap.read_capture(dirs[PORT_ROOT]) == want
    assert [r["doc"]["request"]["host"] for r in want] == \
        [f"h{i}" for i in range(120)]


def test_directory_pruned_equal(tmp_path, monkeypatch):
    pinned_clock(monkeypatch)
    got = []
    for n in BOTH:
        d = str(tmp_path / n.root)
        log = n.cap.CaptureLog(enabled=True, size_mb=0.01)
        log.configure(directory=d, segment_mb=0.004)
        for i in range(400):
            log.offer("cfg-a", cdoc(i, "acme" * 8), -1, "engine", 1,
                      t=float(i))
        assert log.flush()
        total = sum(os.path.getsize(os.path.join(d, x)) for x in os.listdir(d))
        got.append((sorted(os.listdir(d)), total, log.segments_written,
                    log.segments_pruned))
    assert got[1] == got[0]
    _, total, _, pruned = got[1]
    assert pruned > 0 and total <= 10485 + 4096


def skewed(n, header):
    hb = json.dumps(header).encode()
    body = n.cap.MAGIC + struct.pack("<Q", len(hb)) + hb
    return body + hashlib.sha256(body).digest()


def test_corruption_and_skew_rejected_alike(tmp_path):
    """Both readers refuse the same corrupt, truncated, version- and
    schema-skewed blobs, typed, with the same message."""
    path = str(tmp_path / "seg.atpucap")
    REF.cap.write_segment(path, [make_record(0)])
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    cases = {
        "flipped": bytes(blob), "truncated": bytes(blob[:10]),
        "version": skewed(REF, {"version": 999, "schema": 2, "count": 0}),
        "schema": skewed(REF, {"version": 1, "schema": 999, "count": 0}),
        "magic": b"X" * 64,
    }
    for name, data in cases.items():
        p = str(tmp_path / f"{name}.atpucap")
        open(p, "wb").write(data)
        msgs = []
        for n in BOTH:
            with pytest.raises(n.cap.CaptureFormatError) as e:
                n.cap.read_segment(p)
            msgs.append(str(e.value))
        assert msgs[1] == msgs[0], name
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    msgs = []
    for n in BOTH:
        with pytest.raises(n.cap.CaptureFormatError) as e:
            n.cap.read_capture(empty)
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]


def test_bench_timetables_equal(tmp_path):
    d = str(tmp_path / "cap")
    os.makedirs(d)
    records = [make_record(i) for i in range(20)]
    records.reverse()  # out of order on disk: the loader sorts
    REF.cap.write_segment(os.path.join(d, "s1.atpucap"), records)
    got = [(n.bench_load.load_timetable(d, speed=2.0),
            n.bench_load.load_timetable(d, limit=5)) for n in BOTH]
    assert got[1] == got[0]
    (offsets, names, docs, meta), (offs5, *_) = got[1]
    assert offsets[0] == 0.0 and offsets == sorted(offsets)
    assert abs(offsets[-1] - 0.095) < 1e-6 and len(offs5) == 5
    assert meta["records"] == 20 and names[0] == "cfg-a"


# ---------------------------------------------------------------------------
# replay and the pregate's judgment
# ---------------------------------------------------------------------------


def replay_case(n, old_orgs, new_orgs, records, **kw):
    old = n.compile_corpus(org_corpus(n, old_orgs), members_k=4)
    new = n.compile_corpus(org_corpus(n, new_orgs), members_k=4)
    return n.replay.replay_records(old, new, records, **kw)


REPLAY_CASES = {
    "planted-mutation": (
        {"cfg-a": "acme", "cfg-b": "beta"}, {"cfg-a": "nobody", "cfg-b": "beta"},
        [make_record(i, name="cfg-a") for i in range(10)]
        + [make_record(i, name="cfg-b", org="evil") for i in range(10)]),
    "clean-churn": ({"cfg-a": "acme", "cfg-b": "beta"},
                    {"cfg-a": "acme", "cfg-b": "beta"},
                    [make_record(i) for i in range(12)]),
    "newly-allowed": ({"cfg-a": "acme"}, {"cfg-a": "evil"},
                      [make_record(i, org="evil", allow=False)
                       for i in range(10)]),
    "missing-config": ({"cfg-a": "acme"}, {"cfg-a": "acme"},
                       [make_record(0), make_record(1, name="ghost"),
                        {"authconfig": "", "doc": None}]),
}


@pytest.mark.parametrize("case", sorted(REPLAY_CASES))
def test_replay_reports_equal(case):
    old, new, records = REPLAY_CASES[case]
    got = [replay_case(n, old, new, records) for n in BOTH]
    assert comparable(got[1]) == comparable(got[0])
    assert got[1]["platform"].startswith("host-oracle (torch ")
    assert got[0]["platform"].startswith("host-oracle")
    text = [n.replay.format_replay_report(dict(r, elapsed_ms=0.0,
                                               platform="host-oracle"))
            for n, r in zip(BOTH, got)]
    assert text[1] == text[0]
    rep = got[1]
    if case == "planted-mutation":
        assert rep["flips"] == {"newly_denied": 10, "newly_allowed": 0,
                                "total": 10}
        (g,) = rep["by_rule"]
        assert (g["authconfig"], g["direction"], g["rule_index"]) == \
            ("cfg-a", "newly-denied", 0) and "nobody" in g["rule"]
    elif case == "newly-allowed":
        assert rep["by_rule"][0]["direction"] == "newly-allowed"
        assert "acme" in rep["by_rule"][0]["rule"]
    elif case == "missing-config":
        assert rep["skipped"]["configs_missing_old"] == ["ghost"]
        assert rep["skipped"]["errors"] == 1
    else:
        assert rep["flips"]["total"] == 0 and rep["by_rule"] == []


def test_replay_truncation_is_reported():
    got = [replay_case(n, {"cfg-a": "acme"}, {"cfg-a": "acme"},
                       [make_record(i) for i in range(100)],
                       time_budget_s=0.0) for n in BOTH]
    for rep in got:
        assert rep["skipped"]["truncated"] > 0
        assert rep["replayed"] + rep["skipped"]["truncated"] == 100


def test_replay_metadata_substitution_equal():
    docs = {"c": {"flags": {"tier": "gold"}}}
    captured = {"request": {"method": "GET", "path": "/x"},
                "auth": {"metadata": {"flags": {"tier": "bronze"}}}}
    records = [{"schema": 2, "authconfig": "c", "doc": captured,
                "verdict": "deny", "rule_index": 0, "lane": "engine",
                "generation": 1, "metadata_doc_digest": "stale-digest"}]
    got = []
    for n in BOTH:
        pol = n.compile_corpus([n.ConfigRules(name="c", evaluators=[
            (None, n.Pattern("auth.metadata.flags.tier", n.Operator.EQ,
                             "gold"))])])
        got.append((comparable(n.replay.replay_records(pol, pol, records)),
                    comparable(n.replay.replay_records(
                        pol, pol, records, metadata_docs=docs))))
    assert got[1] == got[0]
    blind, seen = got[1]
    assert blind["metadata"]["substituted"] == 0
    assert seen["metadata"] == {"substituted": 1, "digest_mismatches": 1,
                                "configs": ["c"]}
    assert seen["per_config"]["c"]["new_allows"] == 1
    assert captured["auth"]["metadata"]["flags"]["tier"] == "bronze"


PREGATE_REPORTS = {
    "mass-deny": {
        "replayed": 100,
        "flips": {"newly_denied": 50, "newly_allowed": 0, "total": 50},
        "per_config": {"cfg-a": {"replayed": 50, "newly_denied": 50,
                                 "newly_allowed": 0, "old_allows": 50,
                                 "new_allows": 0}},
        "by_rule": [{"authconfig": "cfg-a", "direction": "newly-denied",
                     "rule_index": 0, "rule": "0:x", "count": 50}],
        "skipped": {"truncated": 0}},
    "confined-loosening": {
        "replayed": 1000,
        "flips": {"newly_denied": 0, "newly_allowed": 20, "total": 20},
        "per_config": {
            "payments": {"replayed": 20, "newly_denied": 0,
                         "newly_allowed": 20, "old_allows": 0,
                         "new_allows": 20},
            "other": {"replayed": 980, "newly_denied": 0,
                      "newly_allowed": 0, "old_allows": 900,
                      "new_allows": 900}},
        "by_rule": [{"authconfig": "payments", "direction": "newly-allowed",
                     "rule_index": 0, "rule": "0:x", "count": 20}],
        "skipped": {"truncated": 0}},
}


@pytest.mark.parametrize("case", sorted(PREGATE_REPORTS))
def test_pregate_judgments_equal(case):
    report = PREGATE_REPORTS[case]
    got = []
    for n in BOTH:
        th = thresholds(n)
        got.append([n.pregate.pregate_check(report, th, changed=ch)
                    for ch in (None, {"cfg-a", "payments"}, {"other"})]
                   + [n.pregate.pregate_check(dict(report, replayed=4), th)])
    assert got[1] == got[0]
    full, changed, unchanged, floor = got[1]
    assert floor is None
    if case == "mass-deny":
        assert "cfg-a" in changed["suspects"]
        assert "replay-deny-rate" in changed["guards"]
        assert unchanged is None or "cfg-a" not in unchanged["suspects"]
    else:
        assert changed["suspects"] == ["payments"]
        assert "replay-config-deny-rate" in changed["guards"]


def test_preflight_equal():
    records = [make_record(i) for i in range(20)]
    got = []
    for n in BOTH:
        old = n.compile_corpus(org_corpus(n, {"cfg-a": "acme"}), members_k=4)
        new = n.compile_corpus(org_corpus(n, {"cfg-a": "nobody"}),
                               members_k=4)
        pf = n.pregate.preflight(old, new, records, thresholds(n),
                                 changed={"cfg-a"})
        got.append((comparable(pf["report"]), pf["breach"]))
    assert got[1] == got[0]
    assert got[1][1]["suspects"] == ["cfg-a"]


# ---------------------------------------------------------------------------
# the engine: the capture hook, the pregate on the reconcile path
# ---------------------------------------------------------------------------


def build_engine(n, cfgs=None, **kw):
    kw.setdefault("max_batch", 8)
    if n is REF:
        eng = n.engine_mod.PolicyEngine(members_k=4, mesh=None,
                                        lane_select=False,
                                        kernel_lane="fused", **kw)
    else:
        eng = n.engine_mod.PolicyEngine(members_k=4, device="cpu",
                                        lane_select=False, **kw)
    if cfgs is not None:
        eng.apply_snapshot(entries_of(n, cfgs))
    return eng


async def serve(eng, count=40, names=("cfg-a", "cfg-b")):
    """Sequential submits, so each is its own batch and both packages
    capture the same sequence."""
    for j in range(count):
        await eng.submit(cdoc(j, "acme" if j % 2 == 0 else "evil"),
                         names[j % len(names)])


def ring(n):
    assert n.cap.CAPTURE.flush()
    return [{k: v for k, v in r.items() if k != "t"}
            for r in n.cap.CAPTURE.ring_records()]


def test_engine_capture_hook_equal(capture):
    got = []
    for n in BOTH:
        eng = build_engine(n, org_corpus(n, {"cfg-a": "acme",
                                             "cfg-b": "beta"}))
        run(serve(eng, 20))
        got.append(ring(n))
    assert got[1] == got[0]
    recs = got[1]
    assert len(recs) == 20 and {r["authconfig"] for r in recs} == \
        {"cfg-a", "cfg-b"}
    a = next(r for r in recs if r["authconfig"] == "cfg-a")
    assert (a["verdict"], a["rule_index"], a["generation"]) == \
        ("allow", -1, 1)
    b = next(r for r in recs if r["authconfig"] == "cfg-b")
    assert (b["verdict"], b["rule_index"]) == ("deny", 0)


def pregate_engine(n, canary_fraction=0.25):
    return build_engine(n, org_corpus(n, {"cfg-a": "acme", "cfg-b": "beta"}),
                        canary_fraction=canary_fraction,
                        canary_window_s=30.0, canary_thresholds=thresholds(n),
                        replay_pregate=True)


def last_pregate(eng):
    out = dict(eng._last_pregate)
    out.pop("elapsed_ms", None)
    return out


def test_pregate_breach_exposes_nothing_equal(capture, monkeypatch):
    """A poisoned change over the captured window is rejected before its
    canary in both packages, with the same attributed evidence; the old
    snapshot answers, no request reaches the candidate, and the port
    never staged the candidate (no host view, no upload)."""
    staged = []
    real = PORT.engine_mod.apply_delta
    monkeypatch.setattr(PORT.engine_mod, "apply_delta",
                        lambda *a, **k: (staged.append(1), real(*a, **k))[1])
    got = []
    for n in BOTH:
        eng = pregate_engine(n)
        run(serve(eng))
        n.cap.CAPTURE.flush()
        gen, staged_before = eng.generation, len(staged)
        with pytest.raises(n.engine_mod.SnapshotRejected) as ei:
            eng.apply_snapshot(entries_of(n, org_corpus(
                n, {"cfg-a": "nobody", "cfg-b": "beta"})))
        assert eng._canary is None and eng.generation == gen
        if n is PORT:
            assert len(staged) == staged_before
        rule, _ = run(eng.submit(cdoc(0, "acme"), "cfg-a"))
        with n.fr.RECORDER._ring_lock:
            kinds = [e["kind"] for e in n.fr.RECORDER._ring]
        got.append((ei.value.findings, ei.value.replay_diff,
                    last_pregate(eng), bool(rule[0]),
                    "replay-pregate-breach" in kinds,
                    eng.debug_vars()["replay"]["pregate"]["last"]["result"]))
    assert got[1] == got[0]
    findings, diff, last, allowed, recorded, result = got[1]
    assert diff["suspects"] == ["cfg-a"]
    assert any("cfg-a" in f and "newly-denied" in f for f in findings)
    assert last["result"] == "breach" and allowed and recorded
    assert result == "breach"


def test_pregate_clean_churn_tightens_the_canary_equal(capture):
    got = []
    for n in BOTH:
        eng = pregate_engine(n)
        run(serve(eng))
        n.cap.CAPTURE.flush()
        eng.apply_snapshot(entries_of(n, org_corpus(
            n, {"cfg-a": "acme", "cfg-b": "gamma"})))
        phase = eng._canary
        try:
            assert phase is not None
            pf = dict(phase.preflight)
            pf.pop("elapsed_ms")
            got.append((pf, phase.guard.thresholds.deny_delta,
                        phase.guard.thresholds.config_deny_delta,
                        last_pregate(eng)))
        finally:
            eng.canary_promote()
    assert got[1] == got[0]
    pf, deny, cfg_deny, last = got[1]
    th = thresholds(PORT)
    assert pf["result"] == "pass" and pf["flips_total"] == 0
    assert pf["guards_tightened"] is True and last["result"] == "pass"
    assert (deny, cfg_deny) == (th.deny_delta / 2, th.config_deny_delta / 2)


def test_pregate_skips_on_absent_evidence_equal(capture):
    """An empty ring, and a ring the candidate cannot re-decide, are
    'skipped' (never a pass that tightens the guards); the swap lands."""
    got = []
    for n in BOTH:
        eng = build_engine(n, org_corpus(n, {"cfg-a": "acme"}),
                           canary_fraction=0.0, replay_pregate=True,
                           canary_thresholds=thresholds(n))
        n.cap.CAPTURE.clear()
        eng.apply_snapshot(entries_of(n, org_corpus(n, {"cfg-a": "other"})))
        empty = last_pregate(eng)
        rule, _ = run(eng.submit(cdoc(0, "other"), "cfg-a"))
        eng2 = build_engine(n, org_corpus(n, {"cfg-a": "acme"}),
                            canary_fraction=0.25, canary_window_s=30.0,
                            canary_thresholds=thresholds(n),
                            replay_pregate=True)
        n.cap.CAPTURE.clear()
        run(serve(eng2, 20, names=("cfg-a",)))
        n.cap.CAPTURE.flush()
        eng2.apply_snapshot(entries_of(n, org_corpus(n, {"cfg-x": "acme"})))
        phase = eng2._canary
        try:
            got.append((empty, bool(rule[0]), last_pregate(eng2),
                        phase.preflight["result"],
                        phase.guard.thresholds.deny_delta))
        finally:
            eng2.canary_promote()
    assert got[1] == got[0]
    empty, allowed, renamed, phase_result, deny = got[1]
    assert empty["result"] == "skipped" and "min_requests" in empty["reason"]
    assert allowed
    assert renamed["result"] == "skipped" and renamed["replayed"] == 0
    assert phase_result == "skipped"
    assert deny == thresholds(PORT).deny_delta


def test_pregate_without_canary_still_rejects_equal(capture):
    got = []
    for n in BOTH:
        eng = pregate_engine(n, canary_fraction=0.0)
        run(serve(eng, 20, names=("cfg-a",)))
        n.cap.CAPTURE.flush()
        with pytest.raises(n.engine_mod.SnapshotRejected) as ei:
            eng.apply_snapshot(entries_of(n, org_corpus(
                n, {"cfg-a": "nobody", "cfg-b": "beta"})))
        rule, _ = run(eng.submit(cdoc(0, "acme"), "cfg-a"))
        got.append((ei.value.findings, bool(rule[0])))
    assert got[1] == got[0]
    assert got[1][1] is True


def test_debug_vars_and_debug_replay_equal(capture):
    from aiohttp.test_utils import TestClient, TestServer

    got = []
    for n in BOTH:
        eng = build_engine(n, org_corpus(n, {"cfg-a": "acme"}),
                           replay_pregate=True)
        run(serve(eng, 4, names=("cfg-a",)))
        n.cap.CAPTURE.flush()
        dv = eng.debug_vars()["replay"]
        json.dumps(dv)

        async def body():
            client = TestClient(TestServer(n.http.build_app(eng)))
            await client.start_server()
            try:
                r = await client.get("/debug/replay")
                p = await client.post("/debug/replay?flush=1")
                return r.status, await r.json(), p.status
            finally:
                await client.close()

        status, payload, post_status = run(body())
        assert payload == dv
        got.append((dv, status, post_status))
    for dv, _, _ in got:
        # the records' bytes hold their capture times, and the process-wide
        # log's totals count every earlier case of this process
        assert dv["capture"].pop("stored_total") >= 4
        assert dv["capture"].pop("ring_bytes") > 0
    assert got[1] == got[0]
    dv, status, post_status = got[1]
    assert dv["pregate"]["enabled"] is True and dv["capture"]["enabled"]
    assert dv["capture"]["ring_records"] == 4
    assert (status, post_status) == (200, 200)


def test_decision_record_schema_equal():
    got = []
    for n in BOTH:
        log = n.prov.DecisionLog(capacity=4, sample_n=1)
        log.record(lane="engine", host="h", authconfig="c", verdict=True,
                   rule=None, rule_index=-1, latency_ms=0.1, generation=1)
        rec = log.to_json()["records"][-1]
        errors = []
        for bad in ({"schema": 1, "records": []}, {"records": []}, []):
            with pytest.raises(n.prov.DecisionSchemaError) as e:
                n.prov.check_decision_schema(bad)
            errors.append(str(e.value))
        n.prov.check_decision_schema({"schema": n.prov.DECISION_SCHEMA,
                                      "records": []})
        got.append((sorted(rec), rec["schema"], errors))
    assert got[1] == got[0]
    assert got[1][0] == sorted(PORT.prov.DECISION_FIELDS)
