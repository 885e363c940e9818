"""The port's offline analysis CLI (``python -m authorino_tpu_torch.analysis``),
its async-hazard code lint and its metrics-catalogue gate, against the JAX
package's: twins of tests/test_static_analysis.py's code-lint and CLI
tests, tests/test_translation_validate.py's CLI tests, tests/test_replay.py's
offline CLI tests, tests/test_tenancy.py's cardinality lint,
tests/test_corpus.py's corpus self-test, tests/test_provenance.py's
catalogue gate and flight-dump read, and tests/test_snapshots.py's
snapshot-diff CLI.  Where a mode prints bytes or rows, both packages run at
the same kernel lane, set through the environment."""

import asyncio
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from authorino_tpu.analysis import code_lint as r_lint
from authorino_tpu.analysis import metrics_catalog as r_cat
from authorino_tpu.analysis.__main__ import main as r_main
from authorino_tpu_torch.analysis import code_lint as p_lint
from authorino_tpu_torch.analysis import metrics_catalog as p_cat
from authorino_tpu_torch.analysis.__main__ import main as p_main

from test_torch_replay import PORT, REF, make_record, org_corpus

ROOT = Path(__file__).resolve().parent.parent
LINTS = (r_lint, p_lint)


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def kinds(lint, src, path="<string>"):
    return [f.kind for f in lint.lint_source(src, path)]


# ---- the code lint (tests/test_static_analysis.py) ---------------------------

PLANTED = '''
import time, jax, threading
from functools import partial

async def a1():
    time.sleep(1)

async def a2(lock):
    lock.acquire()

async def ok_awaited(sem):
    await sem.acquire()

async def a3(self):
    with self._queue_lock:
        await later()

async def ok_lock_no_await(self):
    with self._queue_lock:
        x = 1

@jax.jit
def a4(x):
    if x > 0:
        return x
    return -x

@partial(jax.jit, static_argnames=())
def ok_static(params, x):
    if params["t"] is not None:
        return x
    if x.shape[0] > 2:
        return x
    return x

def a5():
    try:
        pass
    except:
        pass

async def ok_suppressed():
    time.sleep(1)  # lint-ok: blocking-in-async -- startup-only

async def ok_nested_sync():
    def helper():
        time.sleep(1)
    return helper
'''


def test_code_lint_planted_hazards():
    for lint in LINTS:
        assert sorted(kinds(lint, PLANTED, "planted.py")) == [
            "bare-except", "blocking-in-async", "blocking-in-async",
            "lock-across-await", "tracer-branch"]
        lines = {f.kind: f.location for f in lint.lint_source(PLANTED, "p.py")}
        assert lines["lock-across-await"].endswith(":15")


def test_code_lint_await_after_nested_def():
    src = ("async def f(self, fast):\n"
           "    with self._lock:\n"
           "        if fast:\n"
           "            def helper():\n"
           "                pass\n"
           "        else:\n"
           "            await later()\n")
    for lint in LINTS:
        assert kinds(lint, src) == ["lock-across-await"]


def test_code_lint_static_accessor_prunes_only_its_subtree():
    src = ("import jax\n"
           "@jax.jit\n"
           "def f(x, y):\n"
           "    if x + y.shape[0] > 3:\n"
           "        return x\n"
           "    return y\n")
    for lint in LINTS:
        assert kinds(lint, src) == ["tracer-branch"]


def test_code_lint_suppression_scopes():
    for lint in LINTS:
        src = "async def f():\n    import time\n    time.sleep(1)  # lint-ok\n"
        assert lint.lint_source(src) == []
        src = ("async def f():\n    import time\n"
               "    time.sleep(1)  # lint-ok: tracer-branch\n")
        assert kinds(lint, src) == ["blocking-in-async"]
        assert lint.lint_source("# lint: skip-file\nasync def f():\n"
                                "    import time\n    time.sleep(1)\n") == []


def test_code_lint_pickle_import_kind():
    src = "import pickle\nfrom cloudpickle import dumps\nimport dill\n"
    for lint in LINTS:
        assert kinds(lint, src, "pkg/x.py") == ["pickle-import"] * 3
        assert lint.lint_source(src, "tests/test_x.py") == []
        assert lint.lint_source(src, "pkg/tests/helper.py") == []
        ok = "import pickle  # lint-ok: pickle-import -- trusted local cache\n"
        assert lint.lint_source(ok, "pkg/x.py") == []
        assert lint.lint_source("from .pickle import x\n", "pkg/x.py") == []


def test_code_lint_non_atomic_write_kind():
    src = ("def dump(snapshot_path, blob):\n"
           "    with open(snapshot_path, 'wb') as f:\n"
           "        f.write(blob)\n")
    ok = ("import os\n"
          "def dump(snapshot_path, blob):\n"
          "    with open(snapshot_path + '.tmp', 'wb') as f:\n"
          "        f.write(blob)\n"
          "        f.flush()\n"
          "        os.fsync(f.fileno())\n"
          "    os.replace(snapshot_path + '.tmp', snapshot_path)\n")
    bad = ("import os\n"
           "def dump(snapshot_path, blob):\n"
           "    with open(snapshot_path, 'wb') as f:\n"
           "        f.write(blob)\n"
           "        os.fsync(f.fileno())\n"
           "    snapshot_path.replace('.tmp', '')\n")
    scratch = ("def dump(p, blob):\n"
               "    with open(p, 'wb') as f:\n"
               "        f.write(blob)\n")
    ok2 = ("def dump(snapshot_path, blob):\n"
           "    with open(snapshot_path, 'wb') as f:"
           "  # lint-ok: non-atomic-write -- sentinel file\n"
           "        f.write(blob)\n")
    for lint in LINTS:
        assert kinds(lint, src, "pkg/x.py") == ["non-atomic-write"]
        assert lint.lint_source(ok, "pkg/x.py") == []
        assert kinds(lint, bad, "pkg/x.py") == ["non-atomic-write"]
        assert lint.lint_source(scratch, "pkg/x.py") == []
        assert lint.lint_source("def load(manifest_path):\n"
                                "    return open(manifest_path).read()\n",
                                "pkg/x.py") == []
        assert lint.lint_source(src, "tests/test_x.py") == []
        assert lint.lint_source(ok2, "pkg/x.py") == []


def test_code_lint_device_synchronise_blocks_the_loop():
    """The port's counterparts of ``jax.block_until_ready``: a device
    synchronise inside ``async def`` stalls every request on the loop."""
    src = ("import torch\n"
           "async def f(stream, event):\n"
           "    torch.cuda.synchronize()\n"
           "    stream.synchronize()\n"
           "    event.synchronize()\n"
           "    await stream.synchronize()\n"
           "def g():\n"
           "    torch.cuda.synchronize()\n")
    assert kinds(p_lint, src) == ["blocking-in-async"] * 3
    assert kinds(r_lint, src) == []  # the JAX package's sets lack them


def test_repo_stays_lint_clean():
    """The port's twin: the code lint over authorino_tpu_torch/ reports no
    findings, with the reference's rules and the port's device
    synchronise among the blocking calls."""
    import authorino_tpu_torch

    findings = p_lint.lint_paths([authorino_tpu_torch.__path__[0]])
    assert findings == [], "\n".join(str(f) for f in findings)
    assert [str(f) for f in r_lint.lint_paths(
        [authorino_tpu_torch.__path__[0]])] == []


def test_tenancy_code_stays_clean():
    root = ROOT / "authorino_tpu_torch" / "tenancy"
    assert [str(f) for f in p_lint.lint_paths([str(root)])] == []


# ---- the CLI (tests/test_static_analysis.py, test_translation_validate.py) --

def test_cli_self_lint_json(capsys):
    assert p_main(["--self-lint", "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["ok"] is True and report["findings"] == []
    assert report["layers"][0]["paths"] == [
        str(ROOT / "authorino_tpu_torch")]


def test_cli_verify_fixtures(capsys):
    assert p_main(["--verify-fixtures"]) == 0
    assert "OK" in capsys.readouterr().out


def test_cli_reports_findings(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text("import time\nasync def f():\n    time.sleep(1)\n")
    assert p_main(["--self-lint", str(bad)]) == 1
    assert "blocking-in-async" in capsys.readouterr().out


def test_cli_verify_fixtures_runs_translation_validation(capsys):
    assert p_main(["--verify-fixtures", "--json"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert r_main(["--verify-fixtures", "--json"]) == 0
    want = json.loads(capsys.readouterr().out)
    assert got == want == {"ok": True, "findings": [], "layers": [
        {"layer": "fixture_verify", "findings": 0}]}


def test_cli_coverage_report(capsys):
    assert p_main(["--coverage-report", "--json"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert r_main(["--coverage-report", "--json"]) == 0
    want = json.loads(capsys.readouterr().out)
    cov = got["coverage"]
    assert cov["fast"] == 7 and cov["slow"] == 4
    assert cov["blocking_reasons"]["unsupported-comparator"] == {
        "configs": 1, "sole_blocker": 1}
    assert {"hier", "quota", "roles"} <= set(cov["configs"])
    assert got == want


# ---- the corpus self-test (tests/test_corpus.py) ----------------------------

def test_verify_fixtures_corpus_selftest_is_clean_and_not_blind():
    from authorino_tpu_torch.analysis.__main__ import (_corpus_selftest,
                                                       _pickle_lint_selftest)
    from authorino_tpu_torch.analysis.fixtures import fixture_policy
    from authorino_tpu_torch.corpus import synthesize as syn

    policy = fixture_policy()
    assert _corpus_selftest(policy) == []
    assert _pickle_lint_selftest() == []
    real = syn.augment_corpus

    def blind(policy, rows, **kw):
        out = real(policy, rows, **kw)
        out["rows"] = []
        out["coverage_after"] = out["coverage_before"]
        return out

    syn.augment_corpus = blind
    try:
        assert _corpus_selftest(policy)
    finally:
        syn.augment_corpus = real


# ---- the replay CLI (tests/test_replay.py) -----------------------------------

def test_analysis_decisions_reader_rejects_skew(tmp_path, capsys):
    p = str(tmp_path / "decisions.json")
    with open(p, "w") as f:
        json.dump({"schema": 1, "records": [], "capacity": 8, "sample_n": 1,
                   "records_total": 0}, f)
    for main in (p_main, r_main):
        assert main(["--decisions", p]) == 1
        assert "DecisionSchemaError" in capsys.readouterr().err


def replay_blobs(tmp_path, n):
    from importlib import import_module

    snaps = import_module(f"{n.root}.snapshots")

    def blob(path, orgs, gen):
        cfgs = org_corpus(n, orgs)
        fps = {c.name: snaps.rules_fingerprint(c) for c in cfgs}
        b = snaps.serialize_policy(n.compile_corpus(cfgs, members_k=4),
                                   meta={"fingerprints": fps,
                                         "certified": True,
                                         "generation": gen})
        with open(path, "wb") as f:
            f.write(b)

    old_p = str(tmp_path / f"{n.root}-old.atpusnap")
    new_p = str(tmp_path / f"{n.root}-new.atpusnap")
    blob(old_p, {"cfg-a": "acme", "cfg-b": "beta"}, 1)
    blob(new_p, {"cfg-a": "nobody", "cfg-b": "beta"}, 2)
    return old_p, new_p


def test_analysis_replay_cli_offline(tmp_path, capsys):
    d = str(tmp_path / "cap")
    os.makedirs(d)
    REF.cap.write_segment(os.path.join(d, f"s{REF.cap.SEGMENT_SUFFIX}"),
                          [make_record(i) for i in range(40)])
    reports = []
    for n, main in ((PORT, p_main), (REF, r_main)):
        old_p, new_p = replay_blobs(tmp_path, n)
        rc = main(["--replay", old_p, new_p, "--log", d, "--json"])
        report = json.loads(capsys.readouterr().out)
        assert rc == 1  # flips present
        assert report["flips"]["newly_denied"] == 40
        assert report["by_rule"][0]["authconfig"] == "cfg-a"
        assert report["pregate"] and "cfg-a" in report["pregate"]["suspects"]
        rc2 = main(["--replay", old_p, old_p, "--log", d, "--json"])
        report2 = json.loads(capsys.readouterr().out)
        assert rc2 == 0 and report2["flips"]["total"] == 0
        for r in (report, report2):
            r.pop("elapsed_ms", None)
            r.pop("platform", None)
        reports.append((rc, report, rc2, report2))
    assert reports[0] == reports[1]


# ---- the metrics catalogue (tests/test_tenancy.py, test_provenance.py) -------

class TestCardinalityLint:
    def test_registry_lints_clean(self):
        assert p_cat.tenant_cardinality_lint() == []
        assert r_cat.tenant_cardinality_lint() == []

    def test_planted_violation_is_caught(self):
        violations = p_cat.tenant_cardinality_lint(
            extra=(p_cat._PlantedTenantFamily(),))
        assert any("planted_violation" in v for v in violations)
        assert p_cat.tenant_lint_self_test() == []

    def test_stale_bound_is_caught(self):
        from authorino_tpu_torch.utils import metrics as metrics_mod

        bounds = dict(metrics_mod.TENANT_LABEL_BOUNDS)
        bounds["auth_server_tenant_ghost_total"] = 8
        assert any("ghost" in v for v in p_cat.tenant_cardinality_lint(bounds))

    def test_missing_bound_is_caught(self):
        from authorino_tpu_torch.utils import metrics as metrics_mod

        bounds = dict(metrics_mod.TENANT_LABEL_BOUNDS)
        bounds.pop("auth_server_tenant_requests_total")
        assert any("tenant_requests" in v
                   for v in p_cat.tenant_cardinality_lint(bounds))


def test_metrics_catalog_gate(monkeypatch, capsys):
    """Every port family is documented, and the documented families the
    port lacks are exactly the named, item-keyed list."""
    missing, stale = p_cat.catalog_drift()
    assert not missing, missing
    assert not stale, stale
    named = dict(p_cat.NOT_YET_PORTED)
    monkeypatch.setattr(p_cat, "NOT_YET_PORTED", {})
    _, unnamed = p_cat.catalog_drift()
    monkeypatch.setattr(p_cat, "NOT_YET_PORTED", named)
    assert sorted(unnamed) == sorted(named)
    assert set(p_cat.NOT_YET_PORTED.values()) == {
        "item 3", "divergence: no XLA warm grid"}
    # the port's registry is the reference's but for exactly those
    assert p_cat.registered_families() == \
        r_cat.registered_families() - set(p_cat.NOT_YET_PORTED)
    assert p_main(["--metrics-catalog"]) == 0
    assert "OK: 0 undocumented, 0 stale, 0 cardinality" in \
        capsys.readouterr().out


def test_metrics_catalog_detects_planted_drift(tmp_path, monkeypatch):
    text = open(p_cat.DOC_PATH).read()
    pruned = text.replace("auth_server_rule_fired_total", "auth_server_rule_")
    p1 = tmp_path / "pruned.md"
    p1.write_text(pruned)
    missing, _ = p_cat.catalog_drift(str(p1))
    assert "auth_server_rule_fired_total" in missing
    p2 = tmp_path / "ghost.md"
    p2.write_text(text + "\n| `auth_server_ghost_series_total` | counter |")
    _, stale = p_cat.catalog_drift(str(p2))
    assert "auth_server_ghost_series_total" in stale
    # a named family the doc lost, or one the port registers, fails too
    p3 = tmp_path / "unnamed.md"
    p3.write_text(text.replace("auth_server_jit_warm_cache_total",
                               "auth_server_jit_"))
    _, stale = p_cat.catalog_drift(str(p3))
    assert any(s.startswith("auth_server_jit_warm_cache_total (")
               for s in stale)
    monkeypatch.setattr(p_cat, "NOT_YET_PORTED", dict(
        p_cat.NOT_YET_PORTED, auth_server_rule_fired_total="item 0"))
    _, stale = p_cat.catalog_drift()
    assert any("auth_server_rule_fired_total (NOT_YET_PORTED, item 0: "
               "registered by the port)" in s for s in stale)


# ---- the flight-dump read (tests/test_provenance.py) ------------------------

def test_flight_recorder_dump_under_chaos_profile(tmp_path, capsys):
    """A live chaos drive of the port's CPU engine (device-down profile)
    writes a flight bundle with the breaker trail; both packages' CLIs
    read it the same."""
    from authorino_tpu_torch.runtime import faults
    from authorino_tpu_torch.runtime.flight_recorder import RECORDER

    old = (RECORDER.dump_dir, RECORDER.min_dump_interval_s, RECORDER.enabled)
    RECORDER.configure(dump_dir=str(tmp_path), min_dump_interval_s=0.0,
                       enabled=True)
    before = list(RECORDER.dumps)
    engine = PORT.engine_mod.PolicyEngine(
        max_batch=32, members_k=4, device="cpu", breaker_threshold=2,
        breaker_reset_s=60.0, verdict_cache_size=0)
    engine.apply_snapshot(
        [PORT.engine_mod.EngineEntry(id=c.name, hosts=[c.name], rules=c)
         for c in org_corpus(PORT, {"c": "acme"})])
    faults.FAULTS.arm("device-down")
    try:
        for _ in range(3):
            rule, _ = run(engine.submit(
                {"auth": {"identity": {"org": "evil"}}}, "c"))
            assert not bool(rule[0])
        assert engine.breaker.state == "open"
    finally:
        faults.FAULTS.disarm()
    deadline = time.monotonic() + 10.0
    new = []
    while time.monotonic() < deadline:
        new = [d for d in RECORDER.dumps if d not in before]
        if new:
            break
        time.sleep(0.05)
    RECORDER.configure(dump_dir=old[0], min_dump_interval_s=old[1],
                       enabled=old[2])
    assert new, "breaker OPEN did not produce a flight bundle"
    bundle = json.loads(open(new[0]).read())
    assert bundle["trigger"] == "breaker-open"
    assert bundle["vars"]["engine"]["breaker"]["state"] == "open"
    outs = []
    for main in (p_main, r_main):
        assert main(["--flight-dump", new[0]]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert "breaker-open" in outs[0] and "breaker=open" in outs[0]


# ---- the snapshot-diff CLI (tests/test_snapshots.py) -------------------------

def serialize_corpus(n, cfgs, generation):
    from importlib import import_module

    snaps = import_module(f"{n.root}.snapshots")
    policy = n.compile_corpus(cfgs, members_k=4)
    fps = {c.name: snaps.rules_fingerprint(c) for c in cfgs}
    meta = {"generation": generation, "certified": True, "fingerprints": fps,
            "entries": [{"id": c.name, "hosts": [c.name]} for c in cfgs]}
    return snaps.serialize_policy(policy, meta=meta)


@pytest.mark.parametrize("lane", ("matmul", "gather", "fused"))
def test_snapshot_diff_cli(tmp_path, monkeypatch, capsys, lane):
    from test_torch_compiler import PORT as PNS
    from test_torch_snapshots import make_corpus

    p1, p2 = str(tmp_path / "old.snap"), str(tmp_path / "new.snap")
    with open(p1, "wb") as f:
        f.write(serialize_corpus(PORT, make_corpus(PNS, 6), 1))
    with open(p2, "wb") as f:
        f.write(serialize_corpus(PORT, make_corpus(PNS, 6, mutated={3}), 2))
    env = dict(os.environ, AUTHORINO_TPU_KERNEL_LANE=lane,
               PYTHONPATH=str(ROOT))
    r = subprocess.run(
        [sys.executable, "-m", "authorino_tpu_torch.analysis",
         "--snapshot-diff", p1, p2, "--json"],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads(r.stdout)
    assert got["configs"]["changed"] == ["cfg-3"]
    assert got["new_generation"] == 2
    # the JAX package's CLI over the same blobs at the same lane
    monkeypatch.setenv("AUTHORINO_TPU_KERNEL_LANE", lane)
    assert r_main(["--snapshot-diff", p1, p2, "--json"]) == 0
    assert json.loads(capsys.readouterr().out) == got
