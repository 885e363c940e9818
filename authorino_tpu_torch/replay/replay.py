"""Offline what-if replay (layer 2): re-decide captured traffic
against two snapshots and diff the verdicts.

EXTree (PAPERS.md) argues the useful explanation of a policy CHANGE is the
diff — which requests flip, and why — not a pile of individual verdicts;
Cedar frames change analysis as a first-class operation, not a production
experiment.  Here the oracle is the host expression evaluator
(``models.policy_model.host_results``), the same exact reference every
lane's output is certified against, so a replay verdict IS the
serving verdict by construction — no kernel, no device, no sampling error.

``replay_records(old, new, records)`` produces the verdict-diff report:
flips split by direction (allow→deny = *newly-denied*, deny→allow =
*newly-allowed*), grouped by (authconfig, rule) through the provenance
attribution columns on BOTH sides — a newly-denied request is attributed
to the NEW side's firing rule (the rule that now denies it), a
newly-allowed one to the OLD side's (the rule that used to).  Consumed by
``analysis --replay OLD NEW --log DIR`` (offline), the reconcile pregate
(replay/pregate.py) and tests.
"""

from __future__ import annotations

import hashlib
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["REPLAY_SCHEMA", "SnapshotOracle", "replay_records",
           "replay_platform", "format_replay_report"]

# verdict-diff report schema (stamped into every report/artifact so
# downstream readers can detect skew, matching the capture container)
REPLAY_SCHEMA = 1


def replay_platform() -> str:
    """The platform stamp replay artifacts carry.  Replay decides on the
    HOST oracle — never a device — so the stamp says so, naming the torch
    build beside it (the reference names its jax build here: a divergence
    by design).  ``__version__`` is a plain attribute: no device is
    initialized."""
    try:
        import torch

        return f"host-oracle (torch {torch.__version__})"
    except Exception:  # pragma: no cover - torch is the port's dependency
        return "host-oracle"


class SnapshotOracle:
    """Uniform exact-decision view over one compiled snapshot: a bare
    ``CompiledPolicy``, a ``LoadedSnapshot`` (offline blob), an engine
    ``_Snapshot`` (live pregate), or a mesh-sharded corpus — one ``decide``
    seam for the replay loop, one ``rule_source`` seam for attribution."""

    def __init__(self, policy: Any = None, sharded: Any = None,
                 generation: Any = None):
        self.policy = policy
        self.sharded = sharded
        self.generation = generation
        self._sources_cache: Dict[int, List[List[str]]] = {}

    @classmethod
    def of(cls, obj: Any) -> "SnapshotOracle":
        policy = getattr(obj, "policy", None)
        sharded = getattr(obj, "sharded", None)
        if policy is None and sharded is None:
            policy = obj  # a bare CompiledPolicy
        if policy is None and sharded is None:
            raise ValueError(f"no compiled corpus on {type(obj).__name__}")
        return cls(policy=policy, sharded=sharded,
                   generation=getattr(obj, "generation", None))

    # -- lookups -----------------------------------------------------------

    def has(self, name: str) -> bool:
        if self.sharded is not None:
            return name in self.sharded.locator
        return name in self.policy.config_ids

    def names(self) -> List[str]:
        if self.sharded is not None:
            return list(self.sharded.locator)
        return list(self.policy.config_ids)

    def n_evaluators(self) -> int:
        pol = (self.sharded.shards[0] if self.sharded is not None
               else self.policy)
        return int(pol.eval_rule.shape[1])

    def _locate(self, name: str) -> Tuple[Any, int]:
        if self.sharded is not None:
            s, row = self.sharded.locator[name]
            return self.sharded.shards[s], row
        return self.policy, self.policy.config_ids[name]

    # -- deciding ----------------------------------------------------------

    def decide(self, name: str, doc: Any) -> Tuple[np.ndarray, np.ndarray]:
        """Exact host decision for one captured request: the per-evaluator
        (rule, skipped) columns — the same attribution evidence every
        serving lane folds."""
        from ..models.policy_model import host_results

        pol, row = self._locate(name)
        _, rule_res, skipped = host_results(pol, doc, row)
        return rule_res, skipped

    def rule_source(self, name: str, col: int) -> str:
        pol, row = self._locate(name)
        key = id(pol)
        sources = self._sources_cache.get(key)
        if sources is None:
            sources = pol.rule_sources()
            self._sources_cache[key] = sources
        per_cfg = sources[row] if 0 <= row < len(sources) else []
        return per_cfg[col] if 0 <= col < len(per_cfg) else "<padded>"


def _doc_identity(doc: Any) -> str:
    try:
        req = doc.get("request") or {}
        return "%s %s%s" % (req.get("method", "?"), req.get("host", ""),
                            req.get("path") or req.get("url_path", ""))
    except Exception:
        return "<opaque>"


def replay_records(old: Any, new: Any, records: Sequence[Dict[str, Any]],
                   *, time_budget_s: Optional[float] = None,
                   max_examples: int = 3,
                   metadata_docs: Optional[Dict[str, Dict[str, Any]]] = None,
                   ) -> Dict[str, Any]:
    """Replay every captured record through BOTH snapshots' host oracles
    and diff the verdicts.  ``old``/``new`` accept anything
    :meth:`SnapshotOracle.of` does.

    ``time_budget_s`` bounds the wall-clock (the pregate's reconcile-path
    budget): replay stops at the budget and the report says how many
    records were NOT evaluated (``skipped.truncated`` — no silent caps, a
    truncated preflight must read as partial evidence, not full
    coverage).

    ``metadata_docs`` un-blinds metadata-dependent configs:
    {config_id: {metadata_name: document}} — the prefetch cache's pinned
    documents (MetadataPrefetcher.export_docs / --metadata-docs FILE).
    Records of listed configs re-decide with ``auth.metadata`` overridden
    by the pinned documents on BOTH sides (a consistent what-if under
    today's metadata), counted in ``metadata.substituted``; records whose
    captured ``metadata_doc_digest`` disagrees with the pinned set are
    additionally counted in ``metadata.digest_mismatches`` (the capture
    window saw different documents — verdicts may differ from what was
    served, by design of the what-if)."""
    from ..relations.prefetch import doc_digest as _md_digest
    from ..ops.operands import firing_columns
    from ..runtime.provenance import rule_label

    old_o = old if isinstance(old, SnapshotOracle) else SnapshotOracle.of(old)
    new_o = new if isinstance(new, SnapshotOracle) else SnapshotOracle.of(new)
    t0 = time.monotonic()
    md_substituted = md_mismatch = 0
    pinned_digest: Dict[str, str] = {}
    if metadata_docs:
        for cfg, docs in metadata_docs.items():
            parts = sorted((n, _md_digest(d)) for n, d in docs.items())
            pinned_digest[cfg] = hashlib.sha256(
                repr(parts).encode()).hexdigest()

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
    E_old, E_new = old_o.n_evaluators(), new_o.n_evaluators()

    for i, rec in enumerate(records):
        if time_budget_s is not None and (i & 63) == 0 \
                and time.monotonic() - t0 > time_budget_s:
            truncated = len(records) - i
            break
        name = rec.get("authconfig")
        doc = rec.get("doc")
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
        if metadata_docs and name in metadata_docs and isinstance(doc, dict):
            # pinned-document substitution: shallow-copy the doc and its
            # auth subtree so the caller's records stay untouched (a
            # non-dict doc — corrupt/hand-built log — skips substitution
            # and takes its chances with the oracle's own error handling)
            auth = dict(doc.get("auth") or {})
            md = dict(auth.get("metadata") or {})
            md.update(metadata_docs[name])
            auth["metadata"] = md
            doc = dict(doc)
            doc["auth"] = auth
            md_substituted += 1
            cap_digest = rec.get("metadata_doc_digest")
            if cap_digest and cap_digest != pinned_digest.get(name):
                md_mismatch += 1
        try:
            ro, so = old_o.decide(name, doc)
            rn, sn = new_o.decide(name, doc)
        except Exception:
            errors += 1
            continue
        kept.append(rec)
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
    newly_denied = newly_allowed = 0
    for rec, fo, fn in zip(kept, fire_old, fire_new):
        name = rec["authconfig"]
        pc = per_config.setdefault(name, {
            "replayed": 0, "newly_denied": 0, "newly_allowed": 0,
            "old_allows": 0, "new_allows": 0})
        pc["replayed"] += 1
        old_allow, new_allow = int(fo) < 0, int(fn) < 0
        pc["old_allows"] += int(old_allow)
        pc["new_allows"] += int(new_allow)
        if old_allow == new_allow:
            continue
        if new_allow:
            direction, col, side = "newly-allowed", int(fo), old_o
            newly_allowed += 1
            pc["newly_allowed"] += 1
        else:
            direction, col, side = "newly-denied", int(fn), new_o
            newly_denied += 1
            pc["newly_denied"] += 1
        key = (name, direction, col)
        g = groups.get(key)
        if g is None:
            g = groups[key] = {
                "authconfig": name,
                "direction": direction,
                "rule_index": col,
                "rule": rule_label(col, side.rule_source(name, col)),
                "count": 0,
                "examples": [],
            }
        g["count"] += 1
        if len(g["examples"]) < max_examples:
            g["examples"].append(_doc_identity(rec.get("doc")))

    by_rule = sorted(groups.values(), key=lambda g: -g["count"])
    replayed = len(kept)
    return {
        "schema": REPLAY_SCHEMA,
        "platform": replay_platform(),
        "load_model": "replay",
        "replayed": replayed,
        "flips": {
            "newly_denied": newly_denied,
            "newly_allowed": newly_allowed,
            "total": newly_denied + newly_allowed,
        },
        "flip_rate": round((newly_denied + newly_allowed) / replayed, 6)
        if replayed else 0.0,
        "by_rule": by_rule,
        "per_config": per_config,
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
        "evaluators": {"old": E_old, "new": E_new},
        "metadata": {
            "substituted": md_substituted,
            "digest_mismatches": md_mismatch,
            "configs": sorted(metadata_docs)[:32] if metadata_docs else [],
        },
    }


def format_replay_report(report: Dict[str, Any]) -> str:
    """Human-readable verdict-diff report for the analysis CLI."""
    lines: List[str] = []
    f = report["flips"]
    lines.append(
        f"replay: {report['replayed']} record(s) re-decided "
        f"(old gen {report.get('old_generation')} → "
        f"new gen {report.get('new_generation')}, "
        f"{report['elapsed_ms']:.0f}ms, {report['platform']})")
    sk = report["skipped"]
    if sk["missing_config"] or sk["errors"] or sk["truncated"]:
        lines.append(
            f"  skipped: {sk['missing_config']} missing-config, "
            f"{sk['errors']} error(s), {sk['truncated']} past the time "
            f"budget (partial evidence)")
        for side in ("old", "new"):
            names = sk[f"configs_missing_{side}"]
            if names:
                lines.append(f"    absent in {side}: {', '.join(names)}")
    lines.append(
        f"  flips: {f['total']} ({f['newly_denied']} newly denied, "
        f"{f['newly_allowed']} newly allowed; "
        f"rate {report['flip_rate']:.4f})")
    if not report["by_rule"]:
        lines.append("  verdict-diff EMPTY: the change is behavior-"
                     "preserving over this traffic window")
    for g in report["by_rule"]:
        lines.append(
            f"  {g['direction']:<14} {g['count']:>6}  "
            f"{g['authconfig']}  rule[{g['rule_index']}] {g['rule']}")
        for ex in g["examples"]:
            lines.append(f"      e.g. {ex}")
    return "\n".join(lines)
