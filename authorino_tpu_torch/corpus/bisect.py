"""History bisect (layer 4): which generation introduced a flip?

``analysis --corpus-diff`` re-decides the whole corpus across the
published-snapshot chain (the publish directory's
``snapshot-{generation:012d}.atpusnap`` blobs — names sort in generation
order, so the chain IS the bounded history the publisher retains) and, for
every row whose verdict changed anywhere along the chain, names the exact
generation that introduced the flip, with firing attribution on both
sides.  A row may flip more than once (edit → revert → re-edit); every
transition is reported, oldest first, never just the net diff.
"""

from __future__ import annotations

import os
import re
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["load_generation_chain", "corpus_diff"]

_BLOB_RE = re.compile(r"^snapshot-(\d{12})\.atpusnap$")


def load_generation_chain(publish_dir: str) -> List[Any]:
    """Load every published snapshot blob in ``publish_dir``, oldest
    generation first.  Blobs that fail to load are skipped (a pruned or
    corrupt blob must not hide the diffable rest of the chain) — the
    caller sees the surviving generations only."""
    from ..snapshots.distribution import load_snapshot_blob

    chain: List[Any] = []
    names = []
    for n in os.listdir(publish_dir):
        m = _BLOB_RE.match(n)
        if m:
            names.append((int(m.group(1)), n))
    for _gen, n in sorted(names):
        try:
            with open(os.path.join(publish_dir, n), "rb") as f:
                chain.append(load_snapshot_blob(f.read()))
        except Exception:
            continue
    return chain


def _decide_all(oracle: Any, rows: Sequence[Dict[str, Any]],
                ) -> List[Optional[int]]:
    """Firing column per row under one oracle (-1 allow, None when the
    config is missing from / errors under this generation)."""
    from ..ops.operands import firing_columns

    out: List[Optional[int]] = []
    for row in rows:
        name = row.get("authconfig")
        doc = row.get("doc")
        if not name or doc is None or not oracle.has(name):
            out.append(None)
            continue
        try:
            rr, sk = oracle.decide(name, doc)
            out.append(int(firing_columns(
                np.asarray(rr, dtype=bool)[None, :],
                np.asarray(sk, dtype=bool)[None, :])[0]))
        except Exception:
            out.append(None)
    return out


def corpus_diff(chain: Sequence[Any], rows: Sequence[Dict[str, Any]],
                max_examples: int = 5) -> Dict[str, Any]:
    """Re-decide ``rows`` under every generation in ``chain`` (oldest
    first; anything :meth:`SnapshotOracle.of` accepts) and attribute each
    verdict flip to the exact generation that introduced it.

    Returns ``{"generations", "rows", "flips": [...], "by_generation"}`` —
    each flip entry names the introducing generation, the direction, the
    firing (authconfig, rule) on the deny side, weighted row counts, and
    up to ``max_examples`` row keys as evidence."""
    from ..replay.replay import SnapshotOracle
    from ..runtime.provenance import rule_label

    t0 = time.monotonic()
    oracles = [(o if isinstance(o, SnapshotOracle) else SnapshotOracle.of(o))
               for o in chain]
    gens = [o.generation for o in oracles]
    fires = [_decide_all(o, rows) for o in oracles]

    # group transitions by (introducing generation, config, direction,
    # deny-side firing column) — the bisect verdict the CLI prints
    groups: Dict[Tuple[int, str, str, int], Dict[str, Any]] = {}
    flipped_rows = 0
    for ri, row in enumerate(rows):
        name = row.get("authconfig") or ""
        w = max(1, int(row.get("weight", 1)))
        prev_fire: Optional[int] = None
        prev_gi: Optional[int] = None
        row_flipped = False
        for gi in range(len(oracles)):
            f = fires[gi][ri]
            if f is None:
                continue             # config absent here: not a verdict
            if prev_fire is not None:
                old_allow, new_allow = prev_fire < 0, f < 0
                if old_allow != new_allow:
                    row_flipped = True
                    if new_allow:
                        direction, col, side = ("newly-allowed", prev_fire,
                                                oracles[prev_gi])
                    else:
                        direction, col, side = "newly-denied", f, oracles[gi]
                    key = (gens[gi], name, direction, col)
                    g = groups.get(key)
                    if g is None:
                        g = groups[key] = {
                            "generation": gens[gi],
                            "from_generation": gens[prev_gi],
                            "authconfig": name,
                            "direction": direction,
                            "rule_index": col,
                            "rule": rule_label(
                                col, side.rule_source(name, col)),
                            "count": 0,
                            "rows": 0,
                            "origins": [],
                            "examples": [],
                        }
                    g["count"] += w
                    g["rows"] += 1
                    org = row.get("origin")
                    if org and org not in g["origins"]:
                        g["origins"].append(org)
                    if len(g["examples"]) < max_examples:
                        g["examples"].append(row.get("row_key") or "")
            prev_fire, prev_gi = f, gi
        flipped_rows += int(row_flipped)

    flips = sorted(groups.values(),
                   key=lambda g: (g["generation"], -g["count"]))
    by_generation: Dict[int, int] = {}
    for g in flips:
        by_generation[g["generation"]] = (
            by_generation.get(g["generation"], 0) + g["count"])
    return {
        "generations": gens,
        "rows": len(rows),
        "flipped_rows": flipped_rows,
        "flips": flips,
        "by_generation": {str(k): v
                          for k, v in sorted(by_generation.items())},
        "elapsed_ms": round((time.monotonic() - t0) * 1e3, 3),
    }
