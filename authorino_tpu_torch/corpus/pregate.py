"""Corpus pregate (layer 3): judge a reconcile on the
frequency-weighted decision corpus before the canary.

The replay pregate is ring-bounded — it can only re-test what recent
traffic exercised.  The corpus pregate replays the long-retention corpus
instead: every distinct decision ever captured (weighted by how often it
occurred) PLUS every synthesized witness row for never-fired rules.  Flip
rates are **weight-weighted** — a flip on a row 40k requests collapsed
into counts as 40k flips, a flip on a synthetic witness counts as 1 — and
the weighted report is judged by the SAME :func:`pregate_check` the
replay pregate uses (weights are integers, so the canary guard arithmetic
applies unchanged).  A breaching edit to a zero-traffic rule is caught by
its synthetic-origin row with zero live exposure; the report's
``origins`` block proves which kind of evidence fired.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["CORPUS_PREGATE_ANOMALY", "replay_corpus", "corpus_preflight"]

# flight-recorder anomaly kind for a corpus-pregate breach (registered in
# runtime/flight_recorder.py ANOMALY_KINDS)
CORPUS_PREGATE_ANOMALY = "corpus-pregate-breach"


def replay_corpus(old: Any, new: Any, rows: Sequence[Dict[str, Any]],
                  *, time_budget_s: Optional[float] = None,
                  max_examples: int = 3) -> Dict[str, Any]:
    """Re-decide every corpus row through BOTH snapshots' host oracles and
    diff the verdicts, **weighted by row frequency**.  The report is
    shaped exactly like :func:`replay.replay_records`' (``replayed`` /
    ``flips`` / ``per_config`` carry weighted integer counts) so
    :func:`pregate_check` judges it unchanged, plus an ``origins`` block
    splitting flips by captured/synthetic evidence."""
    from ..ops.operands import firing_columns
    from ..replay.replay import REPLAY_SCHEMA, SnapshotOracle, replay_platform
    from ..runtime.provenance import rule_label

    old_o = old if isinstance(old, SnapshotOracle) else SnapshotOracle.of(old)
    new_o = new if isinstance(new, SnapshotOracle) else SnapshotOracle.of(new)
    t0 = time.monotonic()

    kept: List[Dict[str, Any]] = []
    o_rules: List[np.ndarray] = []
    o_skips: List[np.ndarray] = []
    n_rules: List[np.ndarray] = []
    n_skips: List[np.ndarray] = []
    errors = 0
    missing_old: set = set()
    missing_new: set = set()
    missing_n = 0
    truncated = 0

    for i, row in enumerate(rows):
        if time_budget_s is not None and (i & 63) == 0 \
                and time.monotonic() - t0 > time_budget_s:
            truncated = len(rows) - i
            break
        name = row.get("authconfig")
        doc = row.get("doc")
        if not name or doc is None:
            errors += 1
            continue
        if not old_o.has(name):
            missing_old.add(name)
            missing_n += 1
            continue
        if not new_o.has(name):
            missing_new.add(name)
            missing_n += 1
            continue
        try:
            ro, so = old_o.decide(name, doc)
            rn, sn = new_o.decide(name, doc)
        except Exception:
            errors += 1
            continue
        kept.append(row)
        o_rules.append(np.asarray(ro, dtype=bool))
        o_skips.append(np.asarray(so, dtype=bool))
        n_rules.append(np.asarray(rn, dtype=bool))
        n_skips.append(np.asarray(sn, dtype=bool))

    if kept:
        fire_old = firing_columns(np.stack(o_rules), np.stack(o_skips))
        fire_new = firing_columns(np.stack(n_rules), np.stack(n_skips))
    else:
        fire_old = fire_new = np.zeros(0, dtype=np.int32)

    per_config: Dict[str, Dict[str, int]] = {}
    groups: Dict[Tuple[str, str, int], Dict[str, Any]] = {}
    origins = {
        "captured": {"rows": 0, "weight": 0, "flips": 0},
        "synthetic": {"rows": 0, "weight": 0, "flips": 0},
    }
    newly_denied = newly_allowed = 0
    replayed_weight = 0
    for row, fo, fn in zip(kept, fire_old, fire_new):
        name = row["authconfig"]
        w = max(1, int(row.get("weight", 1)))
        org = row.get("origin")
        ob = origins.setdefault(
            org if org in origins else "captured",
            {"rows": 0, "weight": 0, "flips": 0})
        ob["rows"] += 1
        ob["weight"] += w
        replayed_weight += w
        pc = per_config.setdefault(name, {
            "replayed": 0, "newly_denied": 0, "newly_allowed": 0,
            "old_allows": 0, "new_allows": 0})
        pc["replayed"] += w
        old_allow, new_allow = int(fo) < 0, int(fn) < 0
        pc["old_allows"] += w * int(old_allow)
        pc["new_allows"] += w * int(new_allow)
        if old_allow == new_allow:
            continue
        ob["flips"] += w
        if new_allow:
            direction, col, side = "newly-allowed", int(fo), old_o
            newly_allowed += w
            pc["newly_allowed"] += w
        else:
            direction, col, side = "newly-denied", int(fn), new_o
            newly_denied += w
            pc["newly_denied"] += w
        key = (name, direction, col)
        g = groups.get(key)
        if g is None:
            g = groups[key] = {
                "authconfig": name,
                "direction": direction,
                "rule_index": col,
                "rule": rule_label(col, side.rule_source(name, col)),
                "count": 0,
                "rows": 0,
                "origins": [],
                "examples": [],
            }
        g["count"] += w
        g["rows"] += 1
        if org and org not in g["origins"]:
            g["origins"].append(org)
        if len(g["examples"]) < max_examples:
            g["examples"].append(row.get("row_key") or "")

    by_rule = sorted(groups.values(), key=lambda g: -g["count"])
    return {
        "schema": REPLAY_SCHEMA,
        "platform": replay_platform(),
        "load_model": "corpus",
        "replayed": replayed_weight,
        "replayed_rows": len(kept),
        "flips": {
            "newly_denied": newly_denied,
            "newly_allowed": newly_allowed,
            "total": newly_denied + newly_allowed,
        },
        "flip_rate": round((newly_denied + newly_allowed) / replayed_weight,
                           6) if replayed_weight else 0.0,
        "by_rule": by_rule,
        "per_config": per_config,
        "origins": origins,
        "skipped": {
            "missing_config": missing_n,
            "configs_missing_old": sorted(missing_old)[:32],
            "configs_missing_new": sorted(missing_new)[:32],
            "errors": errors,
            "truncated": truncated,
        },
        "old_generation": old_o.generation,
        "new_generation": new_o.generation,
        "elapsed_ms": round((time.monotonic() - t0) * 1e3, 3),
        "evaluators": {"old": old_o.n_evaluators(),
                       "new": new_o.n_evaluators()},
    }


def corpus_preflight(baseline: Any, candidate: Any,
                     rows: Sequence[Dict[str, Any]], thresholds: Any = None,
                     changed: Optional[Iterable[str]] = None,
                     time_budget_s: Optional[float] = None,
                     ) -> Dict[str, Any]:
    """One-call corpus preflight: weighted-replay ``rows`` old-vs-new and
    judge the diff with the :func:`pregate_check` (unchanged — the
    weighted counts are integers).  Returns ``{"report", "breach"}``; the
    engine's ``--corpus-pregate`` and the analysis CLI share this seam."""
    from ..replay.pregate import pregate_check

    report = replay_corpus(baseline, candidate, rows,
                           time_budget_s=time_budget_s)
    return {"report": report,
            "breach": pregate_check(report, thresholds, changed=changed)}
