"""The inputs are a function of the seed, the cells resolve to their
files by name, and the judgement reads the generator's tally."""

import json
import struct

import pytest

from harness.cells import BENCH_DIR, ROOT, load_cell
from harness.judge import LIMITS, judge, read_tally
from harness.proto import Response
from harness.requests import encode
from harness.trace import DeviceTrace

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
TRAFFIC = sorted(p.stem for p in (BENCH_DIR / "traffic").glob("*.json"))


def _small(name, distinct=500, auth_configs=40):
    cell = load_cell(name)
    cfg = dict(cell.config, auth_configs=auth_configs)
    mix = dict(cell.traffic["mix"], distinct=distinct)
    return cell.config_mod, cfg, mix


@pytest.mark.parametrize("name", CELLS)
def test_inputs_repeat_per_seed(name):
    mod, cfg, mix = _small(name)
    a = [encode(r) for r in mod.requests(cfg, mix, 4000000001)]
    b = [encode(r) for r in mod.requests(cfg, mix, 4000000001)]
    c = [encode(r) for r in mod.requests(cfg, mix, 4000000002)]
    assert a == b and a != c
    assert mod.manifests(cfg, 4000000001) == mod.manifests(cfg, 4000000001)
    assert len(set(a)) == len(a) == mix["distinct"]


def test_unique_mix_allows_about_half():
    mod, cfg, mix = _small("northstar-1k.unique-sat", distinct=4000,
                           auth_configs=1000)
    ref = mod.Reference(cfg, 7)
    reqs = mod.requests(cfg, mix, 7)
    allowed = sum(ref.expected(r).code == 0 for r in reqs) / len(reqs)
    assert 0.4 < allowed < 0.65
    assert len({r.host for r in reqs}) > 900


def test_keys_mix_credentials_follow_their_shares():
    mod, cfg, mix = _small("apikey-1k.keys-sat", distinct=6000,
                           auth_configs=1000)
    ref = mod.Reference(cfg, 7)
    codes = [ref.expected(r).code for r in mod.requests(cfg, mix, 7)]
    # foreign and missing keys (0.30) answer UNAUTHENTICATED
    assert 0.25 < codes.count(16) / len(codes) < 0.35


def test_every_cell_resolves_by_name():
    for w in BENCH["workloads"]:
        cell = load_cell(w["name"])
        assert cell.traffic["depth"] > 0
        for m in cell.end_to_end + cell.per_layer:
            assert callable(cell.reader(m["name"]).read)
    for t in TRAFFIC:
        assert json.loads((BENCH_DIR / "traffic" / f"{t}.json").read_text())[
            "depth"] > 0
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert (ROOT / c["file"]).with_suffix(".py").is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == \
            c["reduced"]
    assert all((BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
               for m in BENCH["end_to_end"] + BENCH["per_layer"])


def _tally(path, records):
    with open(path, "wb") as f:
        for p, kind, total, done, due, data in records:
            f.write(struct.pack("<6I", p, kind, total, done, due, len(data))
                    + data)


def test_judgement_of_a_tally(tmp_path):
    ok = b"\x0a\x00\x1a\x00"                        # OK, ok_response
    refused = b"\x0a\x02\x08\x0e"                 # UNAVAILABLE
    path = tmp_path / "tally"
    _tally(path, [(0, 0, 5, 4, 3, ok), (1, 0, 2, 2, 2, ok),
                  (1, 0, 1, 1, 1, refused), (2, 2, 1, 0, 1, b"")])
    want = {0: Response(0, kind="ok"), 1: Response(0, kind="ok"),
            2: Response(0, kind="ok")}.__getitem__
    lg = {"unanswered": 0, "unanswered_due_in_window": 0}
    j = judge(read_tally(str(path)), want, lg)
    assert (j.correct, j.correct_done_in_window, j.failed_due_in_window,
            j.refused_answers, j.wrong_answers) == (True, 6, 2, 2, 0)
    # payload 1 expected to be denied: its OK answers are wrong
    want2 = {0: Response(0, kind="ok"), 1: Response(7),
             2: Response(0, kind="ok")}.__getitem__
    j = judge(read_tally(str(path)), want2, dict(lg, unanswered=1))
    assert not j.correct and j.numbers() == {
        "wrong_answers": (2, LIMITS["wrong_answers"]),
        "unanswered": (1, LIMITS["unanswered"])}



def test_device_trace_reduction(tmp_path):
    """The profiler's trace on the host's clock through the anchor kernel:
    the union of kernels and copies in the window, the mega-kernel's
    times, the idle gaps named by the host's calls."""
    ev = [  # ts, dur in microseconds on the trace's clock
        {"cat": "kernel", "name": "fill", "ts": 10.0, "dur": 1.0},
        {"cat": "kernel", "name": "fill", "ts": 100.0, "dur": 2.0},
        {"cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 1000.0,
         "dur": 5.0, "args": {"correlation": 7}},
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 1_000_010.0,
         "dur": 10.0, "args": {"correlation": 7}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 1_000_012.0, "dur": 3.0, "args": {"correlation": 8}},
        {"cat": "kernel", "name": "void fused_megakernel<true>(FusedArgs)",
         "ts": 1_000_020.0, "dur": 8.0, "args": {"correlation": 8}},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 1_000_025.0,
         "dur": 10.0},
        {"cat": "kernel", "name": "void fused_megakernel<true>(FusedArgs)",
         "ts": 5_000_000.0, "dur": 8.0},   # after the window
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    # the anchor kernel (the second) ran between host times 50.0 and
    # 50.0002: trace time 100 us is host time 50.0001
    (tmp_path / "trace.json.anchor.json").write_text(json.dumps(
        {"trace": str(path), "kernels_before": 1, "host_t0": 50.0,
         "host_t1": 50.0002}))
    t = DeviceTrace.read(str(path), (50.5, 51.5))
    assert [o.name for o in t.ops] == [
        "Memcpy HtoD", "void fused_megakernel<true>(FusedArgs)",
        "Memcpy DtoH"]
    assert t.busy_s == pytest.approx(25e-6)           # 1_000_010 .. 035
    assert t.kernel_durations() == pytest.approx([8e-6])
    assert t.span_s == pytest.approx(1.0)
    gaps = t.idle_gaps()
    # the copy was called before the window opened: it waited on its stream
    assert gaps[0][0] == "stream: the next op called, waiting to run"
    assert gaps[0][1] == pytest.approx(0.50001)
    assert gaps[1][0] == "host: no op before the window closed"
    assert gaps[1][1] == pytest.approx(0.499965)
    names = [n for n, _ in t.top_device_ops()]
    assert names[0] in ("Memcpy HtoD", "Memcpy DtoH")
    assert DeviceTrace.read(str(tmp_path / "none.json"), (0, 1)) is None
