"""Distillation: millions of captured requests → thousands of distinct
decision rows.

Two-stage dedup keeps the fold linear in captured records:

1. cheap grouping by (authconfig, canonical doc JSON) — only DISTINCT
   documents pay any encode work, so a 100k-record capture with a few
   hundred distinct requests costs a few hundred encodes;
2. canonical identity by the row key (``batch_row_keys`` over the
   packed operands) against the distilling snapshot — two documents that
   encode to the same device row ARE the same decision, whatever their
   JSON spelling, so they merge into one corpus row whose ``weight``
   carries the combined frequency.

Every distilled row is re-decided through the host oracle so the
stored (verdict, firing rule) is attribution evidence, not a trust-the-log
copy.  Counters land in ``auth_server_corpus_records_total`` (distilled /
deduped / dropped-unparseable): a segment-pruning byte budget that eats
coverage shows up here, never silently.
"""

from __future__ import annotations

import hashlib
import json
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .store import CORPUS_SCHEMA

__all__ = ["distill_records"]

# canonical-key encode chunk: bounds peak batch memory, amortizes the
# per-call numpy setup
_ENCODE_CHUNK = 512


def _doc_json(doc: Any) -> str:
    return json.dumps(doc, sort_keys=True, separators=(",", ":"))


def _fallback_key(name: str, doc_json: str) -> str:
    return "doc:" + hashlib.sha256(
        (name + "\x00" + doc_json).encode("utf-8")).hexdigest()


def _canonical_keys(oracle, name: str,
                    docs: Sequence[Any]) -> Optional[List[str]]:
    """Canonical row keys for ``docs`` of one config, or None when
    the snapshot cannot encode them (missing config, encoder error) —
    the caller falls back to the doc-JSON digest."""
    from ..compiler.encode import encode_batch_py
    from ..compiler.pack import batch_row_keys, pack_batch

    try:
        pol, row = oracle._locate(name)
    except Exception:
        return None
    keys: List[str] = []
    try:
        for i in range(0, len(docs), _ENCODE_CHUNK):
            chunk = docs[i:i + _ENCODE_CHUNK]
            enc = encode_batch_py(pol, chunk, [row] * len(chunk))
            db = pack_batch(pol, enc)
            keys.extend(k.hex() for k in batch_row_keys(db, len(chunk)))
    except Exception:
        return None
    return keys


def distill_records(records: Sequence[Dict[str, Any]], snapshot: Any,
                    *, now: Optional[float] = None) -> Dict[str, Any]:
    """Fold captured records into the distilled corpus against one
    reference snapshot (anything :meth:`SnapshotOracle.of` accepts).

    Returns ``{"rows", "counters", "dedup_ratio"}`` — ``rows`` in the
    pinned store.CORPUS_FIELDS shape, ``counters`` with the distilled /
    deduped / dropped_unparseable accounting the metrics mirror."""
    from ..ops.operands import firing_columns
    from ..replay.replay import SnapshotOracle
    from ..runtime.provenance import rule_label
    from ..utils import metrics as metrics_mod

    oracle = (snapshot if isinstance(snapshot, SnapshotOracle)
              else SnapshotOracle.of(snapshot))
    now = time.time() if now is None else float(now)

    # stage 1: cheap grouping by (authconfig, canonical doc JSON)
    groups: Dict[Tuple[str, str], Dict[str, Any]] = {}
    dropped = 0
    for rec in records:
        name = rec.get("authconfig")
        doc = rec.get("doc")
        if not name or not isinstance(doc, dict):
            dropped += 1
            continue
        try:
            dj = _doc_json(doc)
        except Exception:
            dropped += 1
            continue
        t = rec.get("t")
        t = float(t) if isinstance(t, (int, float)) else now
        g = groups.get((name, dj))
        if g is None:
            groups[(name, dj)] = {
                "doc": doc, "weight": 1, "first": t, "last": t,
                "verdict": rec.get("verdict"),
                "rule_index": rec.get("rule_index", -1),
            }
        else:
            g["weight"] += 1
            g["first"] = min(g["first"], t)
            g["last"] = max(g["last"], t)

    # stage 2: canonical row keys per config, merging JSON-distinct
    # documents that encode to the same device row
    by_config: Dict[str, List[Tuple[str, Dict[str, Any]]]] = {}
    for (name, dj), g in groups.items():
        by_config.setdefault(name, []).append((dj, g))
    fallback_keys = 0
    merged: Dict[Tuple[str, str], Dict[str, Any]] = {}
    for name, items in by_config.items():
        keys = _canonical_keys(oracle, name, [g["doc"] for _, g in items])
        if keys is None:
            keys = [_fallback_key(name, dj) for dj, _ in items]
            fallback_keys += len(items)
        for (dj, g), key in zip(items, keys):
            m = merged.get((name, key))
            if m is None:
                g["row_key"] = key
                merged[(name, key)] = g
            else:
                m["weight"] += g["weight"]
                m["first"] = min(m["first"], g["first"])
                m["last"] = max(m["last"], g["last"])

    # re-decide every distinct row through the host oracle (the
    # attribution — never trust the log's verdict copy); a config the
    # snapshot no longer carries keeps its captured verdict so the row
    # stays bisectable across OLDER generations that did carry it
    rows: List[Dict[str, Any]] = []
    for (name, key), g in sorted(merged.items()):
        verdict, rule_index, rule = g.get("verdict") or "allow", -1, ""
        cap_idx = g.get("rule_index")
        if verdict == "deny" and isinstance(cap_idx, int):
            rule_index = cap_idx
        try:
            rule_res, skipped = oracle.decide(name, g["doc"])
            fire = int(firing_columns(
                np.asarray(rule_res, dtype=bool)[None, :],
                np.asarray(skipped, dtype=bool)[None, :])[0])
            verdict = "allow" if fire < 0 else "deny"
            rule_index = fire
            rule = ("" if fire < 0 else
                    rule_label(fire, oracle.rule_source(name, fire)))
        except Exception:
            pass
        rows.append({
            "schema": CORPUS_SCHEMA,
            "authconfig": name,
            "doc": g["doc"],
            "verdict": verdict,
            "rule_index": rule_index,
            "rule": rule,
            "weight": int(g["weight"]),
            "first_seen": g["first"],
            "last_seen": g["last"],
            "origin": "captured",
            "row_key": g["row_key"],
            "generation": oracle.generation,
        })

    parsed = len(records) - dropped
    counters = {
        "records_in": len(records),
        "distilled": len(rows),
        "deduped": max(0, parsed - len(rows)),
        "dropped_unparseable": dropped,
        "fallback_keys": fallback_keys,
    }
    try:
        metrics_mod.corpus_records.labels("distilled").inc(len(rows))
        metrics_mod.corpus_records.labels("deduped").inc(counters["deduped"])
        metrics_mod.corpus_records.labels("dropped-unparseable").inc(dropped)
    except Exception:
        pass  # metrics are telemetry, never a distillation failure
    return {
        "rows": rows,
        "counters": counters,
        "dedup_ratio": round(parsed / len(rows), 4) if rows else 0.0,
    }
