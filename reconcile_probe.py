#!/usr/bin/env python3
"""Phase 10's one-file rebuild on the card, split into its parts: the
control-plane corpus of ``chip_smoke.py`` phase 10 (1,000 API-key
AuthConfigs of 10 rules and their Secrets, as manifests on disk) through
``YamlDirSource`` into a default engine, then ``--flips`` times one
config's rule flipped in its file, each time from the write to the first
``Check()`` that sees the new rule.

    python3 reconcile_probe.py
    python3 reconcile_probe.py --tree /path/to/other/checkout

Each rebuild is split into the source's sync before the reconciler swaps
(reading the manifests, translating every AuthConfig), the engine's
``apply_snapshot`` (with the swap's own phases: compile, encoder, diff,
upload, ...) and the rest (the first ``Check()``).  ``--tree`` imports
``authorino_tpu_torch`` from another checkout, to compare two versions in
one call (run them in turns: A, B, B, A).  Prints the card's name and
power limit, then one JSON line.  Without a card it exits non-zero unless
``--device cpu`` asks for a rehearsal, whose numbers are not the card's."""

from __future__ import annotations

import argparse
import asyncio
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=None)
    ap.add_argument("--configs", type=int, default=1000)
    ap.add_argument("--rules", type=int, default=10)
    ap.add_argument("--flips", type=int, default=4)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    if args.tree:
        sys.path.insert(0, args.tree)
    import numpy as np
    import torch

    if args.device is None and not torch.cuda.is_available():
        print("reconcile_probe: no CUDA device is visible", file=sys.stderr)
        return 2
    from authorino_tpu_torch.controllers import (AuthConfigReconciler,
                                                 SecretReconciler)
    from authorino_tpu_torch.controllers.sources import YamlDirSource
    from authorino_tpu_torch.k8s import InMemoryCluster
    from authorino_tpu_torch.models import control_plane as cp
    from authorino_tpu_torch.runtime import PolicyEngine

    card = "cpu rehearsal" if args.device == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    n = args.configs
    reqs, cfgs, known = cp.build_check_requests(256, n)
    rules = cp.config_rules(n, args.rules)
    # a request whose code a flip of its config's rule changes
    flip_j = next(j for j, (q, i, good) in enumerate(zip(reqs, cfgs, known))
                  if good and cp.expected_code(q, i, rules, True)
                  != cp.expected_code(q, i, cp.config_rules(
                      n, args.rules, flip=[i]), True))
    flip_i = cfgs[flip_j]

    def write(d: Path, configs, rv: str) -> None:
        for i, ac in enumerate(configs):
            ac = json.loads(json.dumps(ac))
            ac["metadata"]["resourceVersion"] = rv if i == flip_i else "1"
            text = json.dumps(ac)
            path = d / f"ac-{i:04d}.json"
            if not path.exists() or path.read_text() != text:
                path.write_text(text)
        for i in range(n):
            path = d / f"key-{i:04d}.json"
            if not path.exists():
                path.write_text(json.dumps(cp.api_key_secret(i)))

    knobs = {"max_batch": 256}
    if args.device is not None:
        knobs["device"] = args.device
    engine = PolicyEngine(**knobs)
    applied = []
    apply = engine.apply_snapshot

    def timed_apply(*a, **kw):
        t = time.perf_counter()
        try:
            return apply(*a, **kw)
        finally:
            applied.append((t, time.perf_counter()))

    engine.apply_snapshot = timed_apply

    async def run(d: Path) -> dict:
        cluster = InMemoryCluster()
        rec = AuthConfigReconciler(engine, cluster=cluster)
        source = YamlDirSource(str(d), rec, cluster, SecretReconciler(engine))
        write(d, cp.build_auth_configs(n, args.rules), "1")
        t = time.perf_counter()
        await source.sync()
        cold_s = time.perf_counter() - t
        flips = []
        for k in range(args.flips):
            flip = [flip_i] if k % 2 == 0 else []
            want = cp.expected_code(reqs[flip_j], flip_i, cp.config_rules(
                n, args.rules, flip=flip), True)
            gen0 = engine.generation
            applied.clear()
            t = time.perf_counter()
            write(d, cp.build_auth_configs(n, args.rules, flip=flip),
                  str(k + 2))
            t_written = time.perf_counter()
            await source.sync()
            code = (await engine.check(reqs[flip_j])).code
            t_end = time.perf_counter()
            if code != want or engine.generation != gen0 + 1 \
                    or len(applied) != 1:
                raise AssertionError(f"flip {k}: code {code} != {want}, "
                                     f"generation {engine.generation}, "
                                     f"{len(applied)} swaps")
            a0, a1 = applied[0]
            flips.append({
                "total_s": t_end - t, "write_s": t_written - t,
                "sync_before_swap_s": a0 - t_written,
                "apply_snapshot_s": a1 - a0, "after_swap_s": t_end - a1,
                "swap_phases_s": dict(engine._snapshot.phase_s)})
        return {"cold_s": cold_s, "flips": flips}

    with tempfile.TemporaryDirectory(dir=".") as d:
        out = asyncio.run(run(Path(d)))
    med = {k: float(np.median([f[k] for f in out["flips"]]))
           for k in ("total_s", "write_s", "sync_before_swap_s",
                     "apply_snapshot_s", "after_swap_s")}
    phases = {k: float(np.median([f["swap_phases_s"].get(k, 0.0)
                                  for f in out["flips"]]))
              for k in out["flips"][0]["swap_phases_s"]}
    print(card)
    print(json.dumps({"tree": args.tree or ".", "card": card,
                      "configs": n, "cold_s": out["cold_s"],
                      "median": med, "median_swap_phases_s": phases,
                      "flips": out["flips"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
