"""Reconcile preflight gate (layer 3): decide a snapshot swap's
fate on REPLAYED traffic before any live request sees the candidate.

The canary detects a poison config only after seconds of live exposure: real requests are served wrong
answers until the guard accumulates evidence.  The pregate moves that
evidence window to zero live exposure — the candidate snapshot is replayed
against the in-process capture ring (replay/capture.py) and the verdict
diff is judged against the SAME :class:`GuardThresholds` the canary would
apply, mapped onto replay semantics:

- ``deny_delta``     → net replayed deny-rate delta ((newly-denied −
  newly-allowed) / replayed) AND the total flip rate (a change that flips
  30% of traffic each way nets zero but is still not a change to serve
  blind);
- ``config_deny_delta`` / ``allow_collapse_ratio`` → per-config
  newly-denied rate, per-config TOTAL flip rate (a config-confined mass
  deny→allow loosening lowers every deny-side rate and would otherwise
  sail through), and allow-collapse over the replayed window, evaluated
  ONLY for the configs the reconcile changed (the fingerprint diff)
  — unchanged configs share the baseline's artifacts and cannot flip;
- ``min_requests`` / ``min_config_requests`` → evidence floors: a
  near-empty capture ring yields a *skipped* preflight (recorded as such),
  never a false verdict.

A breach raises the engine's typed ``SnapshotRejected`` with the diff
attached and dumps a flight-recorder bundle (anomaly kind
``replay-pregate-breach`` with the top-N verdict-diff rows); a pass
annotates the canary phase so its guards tighten.  State machine:
docs/replay.md "Preflight gate".
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Sequence

__all__ = ["PREGATE_ANOMALY", "pregate_check", "preflight"]

# flight-recorder anomaly kind for a pregate breach (registered in
# runtime/flight_recorder.py ANOMALY_KINDS: recording it auto-dumps a
# diagnostic bundle with the verdict-diff evidence frozen inside)
PREGATE_ANOMALY = "replay-pregate-breach"


def pregate_check(report: Dict[str, Any], thresholds: Any = None,
                  changed: Optional[Iterable[str]] = None,
                  top_n: int = 10) -> Optional[Dict[str, Any]]:
    """Judge one verdict-diff report against canary guard thresholds.

    Returns the breach dict (guards, deltas, suspects, top-N diff rows) or
    None — None means EITHER a clean diff or not enough replayed evidence;
    the caller distinguishes via ``report['replayed']`` (the engine records
    a below-floor preflight as ``skipped``, not ``pass``)."""
    from ..runtime.change_safety import GuardThresholds

    th = thresholds or GuardThresholds()
    changed_set = set(changed) if changed is not None else None
    replayed = int(report.get("replayed", 0))
    if replayed < th.min_requests:
        return None
    flips = report.get("flips", {})
    nd = int(flips.get("newly_denied", 0))
    na = int(flips.get("newly_allowed", 0))
    deltas: Dict[str, float] = {
        "replay-deny-rate": round((nd - na) / replayed, 4),
        "replay-flip-rate": round((nd + na) / replayed, 4),
    }
    breached = [g for g in ("replay-deny-rate", "replay-flip-rate")
                if deltas[g] > th.deny_delta]
    suspects = []
    for name, pc in (report.get("per_config") or {}).items():
        if changed_set is not None and name not in changed_set:
            continue
        n = int(pc.get("replayed", 0))
        if n < th.min_config_requests:
            continue
        # per-config criteria: the newly-denied rate, the allow-collapse
        # ratio (both deny-side — the canary guards' semantics), AND the
        # total flip rate — a config-confined mass deny→allow flip is an
        # authorization LOOSENING the deny-side guards are structurally
        # blind to (it lowers deny rates), yet it is exactly the change a
        # preflight must not wave through unexamined
        nd = int(pc.get("newly_denied", 0))
        na = int(pc.get("newly_allowed", 0))
        delta = nd / n
        flip = (nd + na) / n
        old_allows = int(pc.get("old_allows", 0))
        collapsed = (old_allows >= th.min_config_allows
                     and pc.get("new_allows", 0)
                     < th.allow_collapse_ratio * old_allows)
        if delta > th.config_deny_delta or flip > th.config_deny_delta \
                or collapsed:
            suspects.append((name, round(max(delta, flip), 4)))
    if suspects:
        breached.append("replay-config-deny-rate")
        deltas["replay-config-deny-rate"] = max(d for _, d in suspects)
    if not breached:
        return None
    suspects.sort(key=lambda x: -x[1])
    return {
        "guards": breached,
        "deltas": deltas,
        "suspects": [name for name, _ in suspects],
        "suspect_deltas": {name: d for name, d in suspects},
        "replayed": replayed,
        "flips": dict(flips),
        "truncated": int((report.get("skipped") or {}).get("truncated", 0)),
        # the evidence a flight bundle / SnapshotRejected carries: the
        # top-N verdict-diff rows, each already (authconfig, rule)-
        # attributed by the replay's provenance fold
        "top_flips": list(report.get("by_rule", ())[:top_n]),
    }


def preflight(baseline: Any, candidate: Any,
              records: Sequence[Dict[str, Any]], thresholds: Any = None,
              changed: Optional[Iterable[str]] = None,
              time_budget_s: Optional[float] = None
              ) -> Dict[str, Any]:
    """One-call preflight: replay ``records`` old-vs-new and judge the
    diff.  Returns ``{"report": ..., "breach": breach-or-None}`` — the
    engine's ``_replay_pregate`` and the analysis CLI share this seam so
    the offline `--replay` reproduces EXACTLY the verdict the in-process
    gate reached."""
    from .replay import replay_records

    report = replay_records(baseline, candidate, records,
                            time_budget_s=time_budget_s)
    return {"report": report,
            "breach": pregate_check(report, thresholds, changed=changed)}
