"""Verdict-cache warm-join: a joining replica inherits the hot
set.

A cold replica joining mid-flood serves its first minutes at a 0% verdict-
cache hit rate — every row the fleet already decided re-crosses its device
link.  The leader therefore publishes a HOT-SET DIGEST next to the
snapshot manifest (snapshots/distribution.py HOTSET.json): the top-K
most-recently-used verdict-cache entries, keyed portably.

Portability is by construction of the cache keys.  An entry's key is
``((encoding_epoch, rules_fingerprint), row_key_bytes)``:

- ``row_key_bytes`` is the canonical operand byte string — a pure function
  of the request and the interner's string→id TABLE, so two replicas that
  deserialized the same published snapshot encode identical bytes;
- ``rules_fingerprint`` names the config's semantics, independent of any
  process;
- ``encoding_epoch`` folds in the interner's process-unique identity
  serial — deliberately NOT portable (compiler/intern.py).  The digest
  therefore carries the interner's CONTENT digest instead, and the
  importer remaps each entry onto its OWN epoch: same content ⇒ same row
  bytes ⇒ the leader's verdict is valid under the local token.

Import is advisory and fail-closed: an interner-content or epoch mismatch
refuses the whole digest (counted ``mismatch``), an entry whose
fingerprint the joining snapshot no longer carries is skipped — a wrong
warm entry can never be created, only a cold one.  Values round-trip as
dtype/shape/base64 numpy — no pickle ever crosses the wire."""

from __future__ import annotations

import base64
import logging
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..utils import metrics as metrics_mod

__all__ = ["export_hotset", "import_hotset", "HOTSET_VERSION"]

log = logging.getLogger("authorino_tpu_torch.fleet")

HOTSET_VERSION = 1


def _pack_array(a: np.ndarray) -> Dict[str, Any]:
    a = np.ascontiguousarray(a)
    return {"d": a.dtype.str, "s": list(a.shape),
            "b": base64.b64encode(a.tobytes()).decode("ascii")}


def _unpack_array(rec: Dict[str, Any]) -> np.ndarray:
    a = np.frombuffer(base64.b64decode(rec["b"]), dtype=np.dtype(rec["d"]))
    return a.reshape([int(x) for x in rec["s"]]).copy()


def _snapshot_epoch(snap) -> Optional[str]:
    """The serving snapshot's encoding epoch: every real cache token on a
    single-corpus snapshot carries it as token[0]."""
    tokens = getattr(snap, "cache_tokens", None)
    if not tokens:
        return None
    return tokens[0][0]


def export_hotset(engine, k: int = 1024) -> Optional[Dict[str, Any]]:
    """Build the hot-set digest from a serving engine's verdict cache:
    top-``k`` MRU entries whose tokens belong to the CURRENT snapshot's
    epoch (entries surviving from older epochs are unreachable locally
    and meaningless remotely).  Returns None when there is nothing to
    export (cache off, no snapshot, or no token-keyed entries)."""
    cache = getattr(engine, "_verdict_cache", None)
    snap = getattr(engine, "_snapshot", None)
    if cache is None or snap is None or snap.policy is None:
        return None
    epoch = _snapshot_epoch(snap)
    if epoch is None:
        return None
    entries = []
    for key, value in cache.hottest(k):
        # single-corpus token keys only: ((epoch, fp), row_bytes).  Mesh
        # (generation, bytes) keys are generation-scoped by design and
        # never travel.
        if not (isinstance(key, tuple) and len(key) == 2
                and isinstance(key[0], tuple) and len(key[0]) == 2
                and isinstance(key[1], (bytes, bytearray))):
            continue
        (tok_epoch, fp), row = key
        if tok_epoch != epoch or not isinstance(fp, str):
            continue
        rule, skipped = value
        entries.append({
            "fp": fp,
            "key": base64.b64encode(bytes(row)).decode("ascii"),
            "rule": _pack_array(np.asarray(rule)),
            "skipped": _pack_array(np.asarray(skipped)),
        })
    if not entries:
        return None
    return {
        "version": HOTSET_VERSION,
        "generation": int(getattr(snap, "generation", 0)),
        "epoch": epoch,
        "interner": snap.policy.interner.content_digest(),
        "entries": entries,
    }


def import_hotset(engine, digest: Optional[Dict[str, Any]],
                  ) -> Tuple[int, int]:
    """Seed a joining engine's verdict cache from a published hot-set
    digest.  Returns (imported, skipped).  Refuses the WHOLE digest —
    (0, 0), counted ``mismatch`` — when the joining snapshot's interner
    content diverges from the digest's: the row-key bytes would not mean
    the same operands, and a wrong warm verdict is strictly worse than a
    cold miss."""
    cache = getattr(engine, "_verdict_cache", None)
    snap = getattr(engine, "_snapshot", None)
    if digest is None or cache is None or snap is None \
            or snap.policy is None:
        return 0, 0
    if int(digest.get("version", 0)) != HOTSET_VERSION:
        metrics_mod.fleet_warm_join.labels("mismatch").inc()
        return 0, 0
    local_epoch = _snapshot_epoch(snap)
    if local_epoch is None:
        return 0, 0
    try:
        local_content = snap.policy.interner.content_digest()
    except Exception:
        return 0, 0
    if digest.get("interner") != local_content:
        metrics_mod.fleet_warm_join.labels("mismatch").inc()
        log.warning("warm-join digest refused: interner content %s != "
                    "local %s (joining cold)",
                    str(digest.get("interner"))[:16], local_content[:16])
        return 0, 0
    # remap: digest fp -> the LOCAL token (local epoch folds in this
    # process's interner serial).  Only fingerprints the joining snapshot
    # actually serves are importable — a reconcile that moved on since
    # the digest was folded skips those entries.
    local_fps = set((getattr(snap, "fingerprints", None) or {}).values())
    imported = skipped = 0
    for rec in digest.get("entries", []):
        try:
            fp = rec["fp"]
            if fp not in local_fps:
                skipped += 1
                continue
            row = base64.b64decode(rec["key"])
            value = (_unpack_array(rec["rule"]),
                     _unpack_array(rec["skipped"]))
        except Exception:
            skipped += 1
            continue
        cache.put(((local_epoch, fp), row), value)
        imported += 1
    if imported:
        metrics_mod.fleet_warm_join.labels("imported").inc(imported)
    if skipped:
        metrics_mod.fleet_warm_join.labels("skipped").inc(skipped)
    log.info("warm-join: %d hot verdict(s) imported, %d skipped",
             imported, skipped)
    return imported, skipped
