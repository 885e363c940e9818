"""Run one benchmark cell once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout with a CUDA card.  The run writes the cell's
manifests from the seed, starts ``python -m authorino_tpu_torch server``
over them with the native frontend on and every serving setting at its
default (a traced run through ``harness/traced_server.py``, under
``torch.profiler``), drives the cell's traffic through the benchmark's
own HTTP/2 generator against the gRPC ``Check()`` entry, measures
``--seconds`` seconds after a warm-up, stops the server and judges every
answer against the plain reference.  The server runs on all of the
process's cores but one; the generator and this process on that one.
A traced run reads the device from the generator's start (its warm-up)
to the window's close.  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or its per-layer ones with ``--trace 1``),
``device``, with ``--trace 1`` on a card ``breakdown``, and last
``compared``, the numbers the judgement compared with their limits,
which the last lines of standard error repeat.

``--control`` puts the reference with one guarantee broken (the
configuration's ``control``) in the program's place: a check that the
comparison fails it, not a measurement.

Exit codes: 0 a result printed (correct or not); 2 no CUDA card, or
fewer than the cell asks for; 3 JAX or the JAX package was imported; 4
the server or the generator failed; 5 a file the run needs is missing.
"""

from __future__ import annotations

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import shutil  # noqa: E402
import signal  # noqa: E402
import struct  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, Optional, Set, Tuple  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness import device  # noqa: E402
from harness.build import BuildError, build_loadgen  # noqa: E402
from harness.cells import ROOT, CellError, load_cell  # noqa: E402
from harness.context import RunData  # noqa: E402
from harness.judge import judge, read_tally  # noqa: E402
from harness.requests import encode  # noqa: E402
from harness.server import Server, ServerError, forbidden  # noqa: E402
from harness.trace import DeviceTrace  # noqa: E402

DRAIN_S = 60.0          # how long answers are waited for after the window
READY_TIMEOUT_S = 900.0  # the first run in a checkout builds the kernels
FRONTEND_KEYS = ("fast", "slow", "notfound", "fe_batches", "fe_launches",
                 "fe_rows", "fe_device_rows", "fe_cache_rows", "fe_dedup_rows",
                 "fe_cached_batches", "fe_unavailable_rows")


@dataclass
class Hooks:
    """What a test changes in a run: the server's device (``cpu`` skips
    the look for a card), sizes of the configuration and the traffic, the
    server's environment, and the benchmark's cells (``BENCHMARK.json``'s
    by default)."""
    device: str = "cuda"
    bench: Optional[Dict] = None
    config: Dict = field(default_factory=dict)
    traffic: Dict = field(default_factory=dict)
    mix: Dict = field(default_factory=dict)
    server_env: Dict[str, str] = field(default_factory=dict)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    return p.parse_args(argv)


class Monitor(threading.Thread):
    """Reads the generator's window markers from its standard error and,
    as they pass, the memory in use and (traced runs) the server's
    counters."""

    def __init__(self, proc, server: Server, run: RunData, on_card: bool):
        super().__init__(daemon=True)
        self.proc, self.server, self.data = proc, server, run
        self.on_card = on_card
        self.memory: Optional[int] = None
        self.errors = []
        self.lines = []

    def _counts(self):
        try:
            return self.server.frontend_stats()
        except Exception as e:  # recorded; the metric it feeds goes silent
            self.errors.append(f"counters: {e!r}")
            return None

    def run(self) -> None:  # noqa: D102 (thread body)
        start = None
        for raw in self.proc.stderr:
            line = raw.decode(errors="replace").rstrip()
            self.lines.append(line)
            if line.startswith("WINDOW_START") and self.data.trace_on:
                start = self._counts()
            elif line.startswith("WINDOW_END"):
                if self.data.trace_on:
                    self.data.fe_window = (start, self._counts())
                if self.on_card:
                    self.memory = device.memory_used_bytes()


def _exit_on_term(signum, frame):
    """SIGTERM unwinds the run, so its ``finally`` stops the server."""
    raise SystemExit(128 + signum)


def cpu_sets() -> Tuple[Optional[Set[int]], Optional[Set[int]]]:
    """(the server's cores, the generator's): disjoint, the generator's the
    last one this process may use; (None, None) on a single core."""
    cpus = sorted(os.sched_getaffinity(0))
    if len(cpus) < 2:
        return None, None
    return set(cpus[:-1]), {cpus[-1]}


def payload_file(path: Path, requests) -> None:
    with open(path, "wb") as f:
        for r in requests:
            b = encode(r)
            f.write(struct.pack(">I", len(b)) + b)


def main(argv=None, hooks: Optional[Hooks] = None) -> int:
    hooks = hooks or Hooks()
    args = parse(argv)
    on_card = hooks.device == "cuda"
    if not (ROOT / "authorino_tpu_torch" / "__init__.py").is_file():
        log("the program (authorino_tpu_torch/) is not in this checkout")
        return 5
    try:
        cell = load_cell(args.workload, hooks.bench)
    except (CellError, KeyError, ValueError) as e:
        log(f"cell: {e}")
        return 5
    cell.config.update(hooks.config)
    cell.traffic.update(hooks.traffic)
    cell.traffic["mix"] = dict(cell.traffic["mix"], **hooks.mix)
    if on_card:
        n = device.cards()
        if n < cell.chips:
            log(f"{n} CUDA cards, the cell asks for {cell.chips}: no run")
            return 2
    try:
        lg_path, lg_build_s = build_loadgen()
    except BuildError as e:
        log(str(e))
        return 4

    run = RunData(trace_on=bool(args.trace))
    run_dir = Path(tempfile.mkdtemp(prefix="bench-run-"))
    server = None
    lg_proc = None
    prev_term = signal.signal(signal.SIGTERM, _exit_on_term)
    own_cpus = os.sched_getaffinity(0)
    server_cpus, lg_cpus = cpu_sets()
    try:
        if lg_cpus:
            os.sched_setaffinity(0, lg_cpus)
        mod, cfg, traffic = cell.config_mod, cell.config, cell.traffic
        watch = run_dir / "manifests"
        watch.mkdir()
        for name, text in mod.manifests(cfg, args.seed).items():
            (watch / name).write_text(text)
        server = Server(watch, run_dir, hooks.device, run.trace_on,
                        hooks.server_env, server_cpus)
        server.start()
        # the requests, in shuffled order, while the server starts
        t_start = time.monotonic()
        requests = mod.requests(cfg, traffic["mix"], args.seed)
        random.Random(f"order {args.seed}").shuffle(requests)
        run.requests = requests
        payload_file(run_dir / "payloads", requests)
        t_made = time.monotonic()
        server.wait_ready(READY_TIMEOUT_S)
        log(f"set-up: generator {'built in %.1f s' % lg_build_s if lg_build_s else 'cached'}; "
            f"server started {t_start - T0:.3f} s into the run; "
            f"{len(requests)} distinct requests made in "
            f"{t_made - t_start:.3f} s; the server ready "
            f"{time.monotonic() - t_start:.3f} s after its start")

        cmd = [str(lg_path), "--port", str(server.grpc_port), "--payloads",
               str(run_dir / "payloads"), "--seconds", str(args.seconds),
               "--warmup", str(traffic["warmup_s"]), "--conns",
               str(traffic["connections"]), "--drain", str(DRAIN_S),
               "--tally", str(run_dir / "tally"), "--depth",
               str(traffic["depth"])]
        t_lg = time.monotonic()
        lg_proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE,
                                   stdin=subprocess.DEVNULL)
        mon = Monitor(lg_proc, server, run, on_card)
        mon.start()
        # the monitor reads its standard error; its one line of standard
        # output fits the pipe, so waiting first cannot block it
        lg_proc.wait(timeout=args.seconds + traffic["warmup_s"] + DRAIN_S
                     + 300)
        out = lg_proc.stdout.read()
        mon.join(timeout=60)
        if lg_proc.returncode != 0 or not out.strip():
            log(f"the generator failed ({lg_proc.returncode}): "
                + "\n".join(mon.lines[-20:]))
            return 4
        run.lg = lg = json.loads(out.decode().strip().splitlines()[-1])
        run.setup_s = lg["window_start"] - T0
        for e in mon.errors:
            log(f"monitor: {e}")
        try:
            totals = server.frontend_stats()
            log("frontend counters over the run: " + json.dumps(
                {k: totals.get(k) for k in FRONTEND_KEYS}))
        except Exception as e:  # a report only; the judgement decides
            log(f"frontend counters: {e!r}")
        rc = server.stop()
        if rc != 0:
            log(f"the server exited with {rc}:\n{server.log_tail()}")

        # nothing of JAX in this process or in the server's
        found = forbidden(sys.modules) + forbidden(server.imported_top_level())
        if found:
            log(f"JAX or the JAX package imported: {found}")
            return 3

        ref = run.reference = mod.Reference(cfg, args.seed)
        expected = {}

        def want(p):
            if p not in expected:
                expected[p] = ref.expected(requests[p])
            return expected[p]

        variants = read_tally(str(run_dir / "tally"))
        j = run.judgement = judge(variants, want, lg)
        if args.control:
            # the program's own reading first, then the control's in its
            # place: the result is the control's
            log("the program's reading: " + ", ".join(
                f"{k} {v}" for k, (v, _) in j.numbers().items()))
            j = run.judgement = judge(variants, want, lg,
                                      ref.control(requests).__getitem__)
        if on_card:
            run.card = device.name()
            run.power_limit_w = device.power_limit_w()
        else:
            run.card = "cpu"
        if run.trace_on:
            run.trace = DeviceTrace.read(str(server.trace_path),
                                         (t_lg, lg["window_end"]))

        metrics = {}
        for m in (cell.per_layer if run.trace_on else cell.end_to_end):
            value = cell.reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev = {"platform": "gpu" if on_card else "cpu", "kind": run.card,
               "count": cell.chips,
               "memory_peak_bytes": mon.memory if mon.memory else 0}
        if run.trace is not None:
            dev["busy_s"] = run.trace.busy_s
            dev["window_s"] = run.trace.span_s
        result = {"correct": j.correct, "attempted": int(lg["attempted"]),
                  "failed": int(j.failed_due_in_window),
                  "metrics": metrics, "device": dev}
        if run.trace is not None:
            result["breakdown"] = {"device_ops": run.trace.top_device_ops(),
                                   "idle_gaps": run.trace.idle_gaps()}
        result["compared"] = {k: {"value": v, "limit": lim}
                              for k, (v, lim) in j.numbers().items()}

        log(f"completed per second of the window: {lg['done_per_s']}")
        log(f"card {run.card}, power limit {run.power_limit_w} W; "
            f"window {lg['window_s']:.3f} s, {lg['attempted']} requests "
            f"sent in it, {j.answers} answers judged ({j.refused_answers} "
            f"refused), setup {run.setup_s:.3f} s")
        if run.trace is not None:
            log(f"traced window {run.trace.span_s:.3f} s from the "
                f"generator's start: {len(run.trace.ops)} device ops, busy "
                f"{run.trace.busy_s:.6f} s; anchor within "
                f"{run.trace.anchor_error_s * 1e6:.1f} us")
        for ex in j.examples:
            log(f"wrong answer: {json.dumps(ex)}")
        print(json.dumps(result), flush=True)
        for k, (v, lim) in j.numbers().items():
            log(f"compared {k} {v} limit {lim}")
        return 0
    except (ServerError, CellError, ValueError,
            subprocess.TimeoutExpired) as e:
        log(f"run failed: {e}")
        return 4
    finally:
        signal.signal(signal.SIGTERM, prev_term)
        os.sched_setaffinity(0, own_cpus)
        if lg_proc is not None and lg_proc.poll() is None:
            lg_proc.kill()
            lg_proc.wait()
        if server is not None:
            server.stop()
        shutil.rmtree(run_dir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
