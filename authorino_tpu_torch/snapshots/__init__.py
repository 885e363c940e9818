"""Incremental compile and the snapshot container.

A reconcile used to recompile the entire corpus, re-upload every device
tensor and rebuild the native encoder.  This package makes the control
plane incremental:

  fingerprint.py   — canonical per-config source fingerprints (the compile-
                     cache key) and the encoding *epoch* (everything that
                     defines the meaning of an encoded operand row), the
                     two halves of the per-config verdict-cache key
  compile_cache.py — bounded persistent compile cache: fingerprint →
                     per-config artifact; re-reconciling an unchanged
                     corpus compiles ZERO configs, changing one compiles
                     exactly that one
  diff.py          — snapshot diff plans: which configs changed, which
                     operand rows they touch, and how many bytes a delta
                     upload ships vs a full re-stage (pure numpy)
  delta.py         — applies a diff plan as device uploads (the changed
                     rows into a clone of the previous tensor; only those
                     rows cross the link)
  serialize.py     — pickle-free snapshot container (JSON header + raw
                     array payload + sha256 trailer), byte-equal to the
                     JAX package's
  distribution.py  — compile-leader publish / serving-replica load over a
                     directory (or an HTTP mirror of one): the atomic blob
                     and MANIFEST.json, the replica's poll and admission

``delta.py`` imports torch; it is not re-exported here, nor is
``distribution.py``."""

from .compile_cache import CompileCache, CompileReport, ConfigArtifact
from .diff import format_snapshot_diff, plan_delta, snapshot_diff
from .fingerprint import cache_tokens, encoding_epoch, rules_fingerprint
from .serialize import (
    SnapshotFormatError,
    deserialize_policy,
    serialize_policy,
)

__all__ = [
    "CompileCache", "CompileReport", "ConfigArtifact",
    "rules_fingerprint", "encoding_epoch", "cache_tokens",
    "snapshot_diff", "plan_delta", "format_snapshot_diff",
    "serialize_policy", "deserialize_policy", "SnapshotFormatError",
]
