#!/usr/bin/env python3
"""One engine configuration on the Check() request path, measured on the
card: the north-star AuthConfigs (phase 6 of ``chip_smoke.py``) translated
into one snapshot, a warm-up burst, then three timed bursts of concurrent
``engine.check()`` calls and lone Check()s sent one at a time.

    python3 engine_probe.py --knobs '{"dispatch_workers": 1}'
    python3 engine_probe.py --tree /path/to/other/checkout --knobs '{}'

``--knobs`` is a JSON object of ``PolicyEngine`` keywords (``max_batch``
256 unless given).  ``--tree`` imports ``authorino_tpu_torch`` from another checkout, to
compare two versions in one call (run them in turns: A, B, B, A).  The
process-wide encode pool takes ``dispatch_workers`` from the first engine
of a process, so each configuration needs a process of its own.  Prints
the card's name and power limit, then one JSON line: checks/s per run,
per-Check() latency p50/p99 under the burst and alone, and the batch
latency p50.  Without a card it exits non-zero unless ``--device cpu``
asks for a rehearsal, whose numbers are not the card's."""

from __future__ import annotations

import argparse
import asyncio
import json
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=None)
    ap.add_argument("--knobs", default="{}")
    ap.add_argument("--configs", type=int, default=1000)
    ap.add_argument("--checks", type=int, default=4096)
    ap.add_argument("--lone", type=int, default=300)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    if args.tree:
        sys.path.insert(0, args.tree)
    import numpy as np
    import torch

    if args.device is None and not torch.cuda.is_available():
        print("engine_probe: no CUDA device is visible", file=sys.stderr)
        return 2
    from authorino_tpu_torch.controllers import translate_auth_config
    from authorino_tpu_torch.models import northstar
    from authorino_tpu_torch.runtime import PolicyEngine

    knobs = {"max_batch": 256, **json.loads(args.knobs)}
    if args.device is not None:
        knobs["device"] = args.device
    card = "cpu rehearsal" if args.device == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    acs = northstar.build_auth_configs(args.configs, 10)
    reqs = northstar.build_check_requests(args.checks, args.configs)
    engine = PolicyEngine(**knobs)

    async def translate_all():
        return [await translate_auth_config(
            o["metadata"]["name"], o["metadata"]["namespace"], o["spec"],
            engine=engine) for o in acs]

    engine.apply_snapshot(asyncio.run(translate_all()))

    async def timed(rs):
        async def one(r):
            t = time.perf_counter()
            await engine.check(r)
            return time.perf_counter() - t

        return await asyncio.gather(*(one(r) for r in rs))

    async def one_at_a_time(rs):
        return [(await timed([r]))[0] for r in rs]

    asyncio.run(timed(reqs))
    engine.batch_latency_s.clear()
    rates, lat = [], []
    for _ in range(3):
        t = time.perf_counter()
        lat += asyncio.run(timed(reqs))
        rates.append(len(reqs) / (time.perf_counter() - t))
    batch = sorted(engine.batch_latency_s)
    lone = asyncio.run(one_at_a_time(reqs[:args.lone]))
    print(card)
    print(json.dumps({
        "tree": args.tree or ".", "knobs": knobs, "card": card,
        "checks_per_s": rates, "check_latency_ms_p50":
        float(np.percentile(lat, 50)) * 1e3,
        "check_latency_ms_p99": float(np.percentile(lat, 99)) * 1e3,
        "lone_check_latency_ms_p50": float(np.percentile(lone, 50)) * 1e3,
        "lone_check_latency_ms_p99": float(np.percentile(lone, 99)) * 1e3,
        "batch_latency_ms_p50": batch[len(batch) // 2] * 1e3,
        "batches_timed": len(batch)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
