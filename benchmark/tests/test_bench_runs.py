"""Whole runs of the harness: on the CPU, a server on ``--device cpu`` at
a small size drives the rest of a run (the look for a card skipped); on
the card (marked ``cuda``), a short run as the driver makes it."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from conftest import BENCH, small_run
from harness.cells import ROOT, load_cell
from harness.server import Server, forbidden

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", [w["name"]
                                      for w in BENCHMARK["workloads"]])
def test_result_line_shape(capsys, workload):
    rc, line, err = small_run(capsys, workload)
    assert rc == 0 and line is not None, err[-3000:]
    cell = load_cell(workload)
    assert list(line)[:5] == RESULT_KEYS and list(line)[-1] == "compared"
    assert line["correct"] is True and line["failed"] == 0
    assert sorted(line["metrics"]) == sorted(m["name"]
                                             for m in cell.end_to_end)
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert line["compared"] == {"wrong_answers": {"value": 0, "limit": 0},
                                "unanswered": {"value": 0, "limit": 0}}
    assert err.strip().splitlines()[-2:] == [
        "compared wrong_answers 0 limit 0", "compared unanswered 0 limit 0"]


def test_traced_line_carries_per_layer_metrics(capsys):
    rc, line, err = small_run(capsys, "apikey-1k.keys-sat", trace=1)
    assert rc == 0 and line["correct"], err[-3000:]
    names = {m["name"] for m in load_cell("apikey-1k.keys-sat").per_layer}
    # the counters' metrics; the profiler's trace comes on a card only,
    # and with it the device's busy time and the breakdown
    assert set(line["metrics"]) == names == {"fast_lane_pct", "cache_hit_pct"}
    assert line["metrics"]["fast_lane_pct"]["value"] == 100.0
    assert "breakdown" not in line and "busy_s" not in line["device"]


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "northstar-1k.unique-sat", "--seed", "5", "--seconds", "1",
         "--trace", "0"], cwd=str(ROOT), capture_output=True, text=True,
        timeout=120)
    try:
        import torch

        has_card = torch.cuda.is_available()
    except ImportError:
        has_card = False
    if has_card:
        pytest.skip("this machine has a card")
    assert out.returncode == 2 and out.stdout == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "northstar-1k.unique-sat", "--seed", "5", "--seconds", "1",
         "--trace", "0"], cwd=str(tmp_path), capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_forbidden_names_compare_whole_top_level_names():
    assert forbidden(["authorino_tpu_torch", "authorino_tpu_torch.ops",
                      "jaxtyping", "numpy"]) == []
    assert forbidden(["jax", "jaxlib.xla", "flax.linen", "authorino_tpu",
                      "authorino_tpu.ops"]) == [
        "authorino_tpu", "authorino_tpu.ops", "flax.linen", "jax",
        "jaxlib.xla"]


def test_harness_imports_nothing_of_jax():
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(BENCH)!r})
        import run
        from harness import cells, context, judge, proto, trace
        from harness.cells import load_cell
        for w in {[w["name"] for w in BENCHMARK["workloads"]]!r}:
            c = load_cell(w)
            for m in c.end_to_end + c.per_layer:
                c.reader(m["name"])
        from harness.server import forbidden
        print(forbidden(sys.modules))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_server_imports_nothing_of_jax(tmp_path):
    cell = load_cell("northstar-1k.unique-sat")
    watch = tmp_path / "manifests"
    watch.mkdir()
    for name, text in cell.config_mod.manifests(
            dict(cell.config, auth_configs=5), 1).items():
        (watch / name).write_text(text)
    server = Server(watch, tmp_path, "cpu", traced=False)
    server.start()
    try:
        server.wait_ready(240)
    finally:
        assert server.stop() == 0
    names = server.imported_top_level()
    assert {"authorino_tpu_torch", "torch"} <= names
    assert forbidden(names) == []


# A fault planted under the timed path, in the server process: the
# verdict codes the frontend computes from each readback (device and host
# lanes alike; the verdict cache keeps what they give).
FAULTS = textwrap.dedent("""
    import os
    FAULT = os.environ.get("BENCH_FAULT")
    if FAULT:
        import numpy as np
        from authorino_tpu_torch.runtime import native_frontend as nf

        real = nf.NativeFrontend._codes
        first = []

        def codes(self, rec, rows, cols, E):
            code, firing = real(self, rec, rows, cols, E)
            code = code.copy()
            if FAULT == "altered":      # an answer altered where produced
                code[::4] = np.where(code[::4] == nf.V_ALLOW, nf.V_COL0,
                                     nf.V_ALLOW)
            elif FAULT == "half":       # half of each batch never decided
                code[len(code) // 2:] = 0
            elif FAULT == "stale":      # the first batch's answers kept
                if not first:
                    first.append(code.copy())
                code = np.resize(first[0], code.shape)
            return code, firing

        nf.NativeFrontend._codes = codes
""")


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in ("northstar-1k.unique-sat", "apikey-1k.keys-sat")
    for f in ("altered", "half", "stale")])
def test_a_planted_fault_is_not_correct(capsys, tmp_path, workload, fault):
    (tmp_path / "sitecustomize.py").write_text(FAULTS)
    env = {"PYTHONPATH": os.pathsep.join([str(tmp_path), str(ROOT)]),
           "BENCH_FAULT": fault}
    rc, line, err = small_run(capsys, workload, server_env=env)
    assert rc == 0 and line is not None, err[-3000:]
    assert line["correct"] is False
    assert line["compared"]["wrong_answers"]["value"] > 0


@pytest.mark.parametrize("workload", ["northstar-1k.unique-sat",
                                      "apikey-1k.keys-sat"])
def test_the_control_is_not_correct(capsys, workload):
    rc, line, err = small_run(capsys, workload, "--control")
    assert rc == 0 and line is not None, err[-3000:]
    assert line["correct"] is False
    assert line["compared"]["wrong_answers"]["value"] > 0
    # the program's own reading, taken in the same run, is sound
    assert "the program's reading: wrong_answers 0, unanswered 0" in err


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"]
                                      for w in BENCHMARK["workloads"]])
def test_cell_on_the_card(card, workload):
    """A short traced run as the driver makes it: correct, on the GPU,
    every per-layer metric the cell lists, the device busy."""
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", workload,
         "--seed", "3000000099", "--seconds", "5", "--trace", "1"],
        cwd=str(ROOT), capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0
    assert set(line["metrics"]) == {m["name"]
                                    for m in load_cell(workload).per_layer}
