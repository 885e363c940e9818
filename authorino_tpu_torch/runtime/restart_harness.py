"""Kill harness: SIGKILL a serving process, prove the warm restart.

The crash-consistency claim is end-to-end: a process killed with SIGKILL at
an arbitrary instant — mid-reconcile, mid-capture-rotation, mid-publish —
must restart from its ``--state-dir`` alone (NO control plane) and serve the
exact allow/deny table the killed process was serving, with every on-disk
artifact either old-valid or new-valid (readers reject corruption typed,
never crash, never serve a partial state).  This module is both a runnable
harness and a library the tests drive as a subprocess:

  serve    build a deterministic engine + StatePlane, precompute the
           allow/deny table for a FIXED cycle of config variants (keyed by
           the snapshot's fingerprint digest, so the restarted process can
           find the row matching WHATEVER generation survived on disk),
           touch the ready file, then loop {reconcile → publish, capture
           rotation, hot-set export} forever until killed.  ``--stress``
           biases the loop so the kill lands mid-reconcile or mid-rotation
           with high probability.
  restart  fresh engine + StatePlane.warm_start() against the same state
           dir, re-submit the probe docs, compare verdicts bit-exact to the
           precomputed table row, and validate EVERY artifact on disk
           (snapshot blobs, MANIFEST, HOTSET, capture segments, corpus
           containers: loadable or typed rejection).  Emits a JSON report;
           exit 0 iff recovered + verdicts match + zero unhandled failures.

Usage (tests/test_torch_warm_restart.py wires this up; also runnable by
hand; ``--device cpu`` on a machine without a card):

  python -m authorino_tpu_torch.runtime.restart_harness serve \
      --state-dir /tmp/sd --table /tmp/sd/TABLE.json --ready /tmp/sd/READY \
      --stress reconcile
  kill -9 <pid>      # at any instant after READY appears
  python -m authorino_tpu_torch.runtime.restart_harness restart \
      --state-dir /tmp/sd --table /tmp/sd/TABLE.json --report /tmp/rep.json
"""

from __future__ import annotations

import argparse
import asyncio
import glob
import hashlib
import json
import os
import sys
import time
from typing import Any, Dict, List

N_PROBES = 24
VARIANT_SEED = 73


def _corpus(n_configs: int, variant: int):
    """Deterministic corpus; ``variant`` folds into one rule constant per
    config so each variant compiles to a distinct fingerprint set (and a
    distinct allow/deny table) while keeping identical tensor shapes."""
    from ..compiler import ConfigRules
    from ..expressions import All, Any_, Operator, Pattern

    cfgs = []
    for i in range(n_configs):
        rule = All(
            Pattern("request.method", Operator.EQ, ["GET", "POST"][i % 2]),
            Any_(
                Pattern("auth.identity.org", Operator.EQ,
                        f"org-{i}-v{variant % 3}"),
                Pattern("auth.identity.roles", Operator.INCL, f"role-{i}"),
                Pattern("request.url_path", Operator.MATCHES,
                        rf"^/svc-{i % 3}/"),
            ),
        )
        cfgs.append(ConfigRules(name=f"cfg-{i}", evaluators=[(None, rule)]))
    return cfgs


def _probe_docs(n_configs: int):
    """(doc, config) probes covering allow AND deny rows for every variant:
    org matches variant 0 only ⇒ different variants answer differently."""
    probes = []
    for i in range(N_PROBES):
        c = i % n_configs
        probes.append((
            {"request": {"method": ["GET", "POST"][c % 2],
                         "url_path": f"/svc-{c % 3}/x" if i % 3 else "/other"},
             "auth": {"identity": {"org": f"org-{c}-v0",
                                   "roles": [f"role-{c}"] if i % 2 else []}}},
            f"cfg-{c}",
        ))
    return probes


def table_key(engine) -> str:
    """Content key of the SERVING snapshot: digest over its sorted
    per-config fingerprints.  Generation-independent, so the restarted
    process can look up whichever variant survived the kill on disk."""
    fps = getattr(engine._snapshot, "fingerprints", None) or {}
    blob = json.dumps(sorted(fps.items())).encode("utf-8")
    return hashlib.sha256(blob).hexdigest()


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _verdicts(engine, probes) -> List[List[List[int]]]:
    import numpy as np

    async def all_probes():
        return await asyncio.gather(*[engine.submit(doc, name)
                                      for doc, name in probes])

    out = []
    for rule_res, skipped in _run(all_probes()):
        out.append([np.asarray(rule_res).astype(int).tolist(),
                    np.asarray(skipped).astype(int).tolist()])
    return out


def _new_engine(n_configs: int, device: str):
    from . import PolicyEngine

    return PolicyEngine(max_batch=max(8, n_configs), members_k=4,
                        strict_verify=True, verdict_cache_size=4096,
                        device=device)


def _build_engine(n_configs: int, variant: int, device: str):
    from . import EngineEntry

    engine = _new_engine(n_configs, device)
    engine.apply_snapshot(
        [EngineEntry(id=c.name, hosts=[c.name], runtime=None, rules=c)
         for c in _corpus(n_configs, variant)])
    return engine


# ---------------------------------------------------------------------------
# serve: precompute the truth table, then loop until SIGKILLed
# ---------------------------------------------------------------------------


def cmd_serve(args) -> int:
    from ..replay.capture import write_segment
    from ..corpus.store import write_corpus
    from ..utils.atomicio import atomic_write_json
    from .state_plane import StatePlane

    probes = _probe_docs(args.configs)
    engine = _build_engine(args.configs, 0, args.device)
    plane = StatePlane(engine, args.state_dir, hotset_k=512,
                       hotset_s=3600.0)  # cadence driven by the loop below
    plane.start()  # attach publisher: every apply_snapshot persists

    # precompute the table: every variant the loop will ever serve, keyed
    # by fingerprint digest.  The incremental compiler makes variants 1..k
    # cheap (same shapes, one constant changed per config).
    table: Dict[str, Any] = {}
    entries = None
    for v in range(args.variants):
        if v:
            from . import EngineEntry

            entries = [EngineEntry(id=c.name, hosts=[c.name], runtime=None,
                                   rules=c)
                       for c in _corpus(args.configs, v)]
            engine.apply_snapshot(entries)
        table[table_key(engine)] = {
            "variant": v,
            "verdicts": _verdicts(engine, probes),
        }
    atomic_write_json(args.table, {"configs": args.configs,
                                   "variants": args.variants,
                                   "table": table},
                      artifact="harness-table", indent=1)
    # everything the restart needs is now durable: snapshot of the LAST
    # precomputed variant is published (attached publisher), table is on
    # disk.  Flush so READY truthfully means "killable from here on".
    plane.publisher.flush(timeout_s=10.0)
    plane.export_hotset_once()
    with open(args.ready, "w") as f:  # lint-ok: non-atomic-write -- sentinel
        f.write(str(os.getpid()))
    print(f"READY pid={os.getpid()}", flush=True)

    variants = [_corpus(args.configs, v) for v in range(args.variants)]
    cap_dir = os.path.join(args.state_dir, "captures")
    corp_dir = os.path.join(args.state_dir, "corpus")
    os.makedirs(cap_dir, exist_ok=True)
    os.makedirs(corp_dir, exist_ok=True)
    from . import EngineEntry

    i = 0
    while True:
        i += 1
        v = i % args.variants
        reps = 4 if args.stress == "reconcile" else 1
        for _ in range(reps):
            engine.apply_snapshot(
                [EngineEntry(id=c.name, hosts=[c.name], runtime=None,
                             rules=c) for c in variants[v]])
            plane.publisher.flush(timeout_s=5.0)
        _verdicts(engine, probes)  # keep the verdict cache warm
        reps = 8 if args.stress == "capture" else 1
        for r in range(reps):
            rows = [{"authconfig": f"cfg-{j}", "doc": {"i": i, "r": r},
                     "rule_index": j, "lane": "device",
                     "verdict": bool(j % 2)} for j in range(16)]
            write_segment(os.path.join(cap_dir, f"seg-{i % 4}.atpucap"),
                          rows, meta={"iter": i})
            write_corpus(os.path.join(corp_dir, f"c-{i % 4}.atpucorp"),
                         rows, meta={"iter": i})
        plane.export_hotset_once()
    return 0  # unreachable: the harness dies by signal


# ---------------------------------------------------------------------------
# restart: warm start from disk alone, verify bit-exact + artifact validity
# ---------------------------------------------------------------------------


def _validate_artifacts(state_dir: str) -> Dict[str, Any]:
    """Every on-disk artifact must be loadable or rejected TYPED.  Any
    other exception is an unhandled crash-consistency failure."""
    from ..replay.capture import CaptureFormatError, read_segment
    from ..corpus.store import CorpusFormatError, read_corpus_file
    from ..snapshots.distribution import (SnapshotLoadError,
                                          load_hotset, load_snapshot_blob)

    out: Dict[str, Any] = {"valid": 0, "rejected_typed": 0, "tmp_debris": 0,
                           "unhandled": []}

    def check(path, loader, typed):
        try:
            loader(path)
            out["valid"] += 1
        except typed:
            out["rejected_typed"] += 1
        except Exception as e:  # crash-consistency violation
            out["unhandled"].append(f"{path}: {type(e).__name__}: {e}")

    def load_blob(path):
        with open(path, "rb") as f:
            load_snapshot_blob(f.read())

    for p in sorted(glob.glob(os.path.join(state_dir, "*.atpusnap"))):
        check(p, load_blob, SnapshotLoadError)
    for p in sorted(glob.glob(os.path.join(state_dir, "captures", "*"))):
        if p.endswith(".tmp"):
            out["tmp_debris"] += 1
            continue
        check(p, read_segment, CaptureFormatError)
    for p in sorted(glob.glob(os.path.join(state_dir, "corpus", "*"))):
        if p.endswith(".tmp"):
            out["tmp_debris"] += 1
            continue
        check(p, read_corpus_file, CorpusFormatError)
    # manifest + hotset: their readers are total (typed error / None)
    try:
        with open(os.path.join(state_dir, "MANIFEST.json")) as f:
            json.load(f)
        out["manifest"] = "valid"
    except FileNotFoundError:
        out["manifest"] = "missing"
    except ValueError:
        out["manifest"] = "rejected_typed"
    try:
        out["hotset"] = ("valid" if load_hotset(state_dir) is not None
                         else "none")
    except Exception as e:
        out["unhandled"].append(f"HOTSET.json: {type(e).__name__}: {e}")
    out["tmp_debris"] += len(glob.glob(os.path.join(state_dir, "*.tmp")))
    return out


def cmd_restart(args) -> int:
    from ..utils.atomicio import atomic_write_json
    from .state_plane import StatePlane

    with open(args.table) as f:
        spec = json.load(f)
    probes = _probe_docs(int(spec["configs"]))

    t0 = time.monotonic()
    engine = _new_engine(int(spec["configs"]), args.device)
    plane = StatePlane(engine, args.state_dir)
    summary = plane.warm_start()  # NO control plane anywhere in this mode
    recovered = summary.get("snapshot") in ("ok", "stale")

    report: Dict[str, Any] = {
        "recovered": recovered,
        "warm_start": summary,
        "warm_start_wall_s": round(time.monotonic() - t0, 4),
    }
    verdicts_match = False
    if recovered:
        key = table_key(engine)
        row = spec["table"].get(key)
        report["table_key"] = key
        report["table_hit"] = row is not None
        if row is not None:
            report["variant"] = row["variant"]
            got = _verdicts(engine, probes)
            verdicts_match = got == row["verdicts"]
            if not verdicts_match:
                report["mismatch"] = [i for i, (g, w) in
                                      enumerate(zip(got, row["verdicts"]))
                                      if g != w]
    report["verdicts_match"] = verdicts_match
    report["artifacts"] = _validate_artifacts(args.state_dir)
    ok = (recovered and verdicts_match
          and not report["artifacts"]["unhandled"])
    report["ok"] = ok
    atomic_write_json(args.report, report, artifact="harness-report",
                      indent=1)
    print(json.dumps(report), flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m authorino_tpu_torch.runtime.restart_harness",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("serve", help="serve + churn until SIGKILLed")
    s.add_argument("--state-dir", required=True)
    s.add_argument("--table", required=True)
    s.add_argument("--ready", required=True)
    s.add_argument("--configs", type=int, default=8)
    s.add_argument("--variants", type=int, default=3)
    s.add_argument("--stress", choices=["reconcile", "capture"],
                   default="reconcile")
    r = sub.add_parser("restart", help="warm start from disk + verify")
    r.add_argument("--state-dir", required=True)
    r.add_argument("--table", required=True)
    r.add_argument("--report", required=True)
    for p in (s, r):
        # the engine's device: the CUDA card unless the caller asks for
        # the CPU (the kernel's plain version)
        p.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.cmd == "serve":
        return cmd_serve(args)
    return cmd_restart(args)


if __name__ == "__main__":
    sys.exit(main())
