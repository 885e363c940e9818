"""Corpus container: the long-retention decision-corpus store.

Same pickle-free checksummed layout as the snapshot container and the
capture segment — MAGIC + u64 header length + JSON header +
JSON-lines payload + sha256 trailer — under its own magic and suffix so a
corpus can never be misread as a capture log (and vice versa).  Every
read-side failure is a typed :class:`CorpusFormatError`; a corrupted or
version-skewed blob is rejected before any row is parsed.

Row shape (pinned, tests/test_corpus.py): one distilled-or-synthesized
decision per row —

  schema       CORPUS_SCHEMA stamp (skew is rejected typed)
  authconfig   the deciding config's id
  doc          the full request document (re-decidable forever)
  verdict      "allow" | "deny" under the distilling snapshot
  rule_index   firing column (-1 = allow)
  rule         firing rule source label ("" on allow)
  weight       frequency weight: how many captured requests collapsed
               into this row (1 for synthetic rows)
  first_seen   earliest captured timestamp (synthesis time for synthetic)
  last_seen    latest captured timestamp
  origin       "captured" | "synthetic" — the pregate proof that a
               zero-traffic breach was caught WITHOUT live evidence
               hinges on this flag being trustworthy
  row_key      hex canonical identity (batch_row_keys digest when
               the distilling snapshot could encode the doc; a doc-JSON
               digest fallback otherwise, prefixed "doc:")
  generation   the snapshot generation the row was decided under
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..utils.atomicio import atomic_write_bytes

__all__ = ["CORPUS_SCHEMA", "CORPUS_FORMAT_VERSION", "CORPUS_SUFFIX",
           "CORPUS_FIELDS", "CorpusFormatError", "encode_row",
           "write_corpus", "read_corpus_file", "read_corpus"]

CORPUS_SCHEMA = 1
CORPUS_FORMAT_VERSION = 1
MAGIC = b"ATPUCORP1\x00"
_DIGEST_LEN = 32
CORPUS_SUFFIX = ".atpucorp"

CORPUS_FIELDS = ("schema", "authconfig", "doc", "verdict", "rule_index",
                 "rule", "weight", "first_seen", "last_seen", "origin",
                 "row_key", "generation")


class CorpusFormatError(ValueError):
    """The blob is not a valid corpus container (bad magic, truncated,
    checksum mismatch, unsupported container version, or row-schema
    skew).  Read-time only — typed so callers distinguish 'not a corpus'
    from an empty or clean one."""


def encode_row(row: Dict[str, Any]) -> bytes:
    """One row → one canonical JSON line (sort_keys: byte-testable)."""
    return json.dumps(row, sort_keys=True, separators=(",", ":"),
                      default=str).encode("utf-8") + b"\n"


def write_corpus(path: str, rows: Sequence[Dict[str, Any]],
                 meta: Optional[Dict[str, Any]] = None) -> str:
    """Serialize ``rows`` into one checksummed corpus container at
    ``path`` (tmp + atomic rename — a torn write is unreachable)."""
    payload = b"".join(encode_row(r) for r in rows)
    header = {
        "version": CORPUS_FORMAT_VERSION,
        "schema": CORPUS_SCHEMA,
        "count": len(rows),
        "created_unix": time.time(),
        "meta": meta or {},
    }
    hb = json.dumps(header, sort_keys=True,
                    separators=(",", ":")).encode("utf-8")
    body = MAGIC + struct.pack("<Q", len(hb)) + hb + payload
    blob = body + hashlib.sha256(body).digest()
    return atomic_write_bytes(path, blob, artifact="corpus")


def read_corpus_file(path: str) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
    """One corpus file → (header, rows).  Verifies magic + sha256 +
    container version + row schema BEFORE parsing any row."""
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < len(MAGIC) + 8 + _DIGEST_LEN:
        raise CorpusFormatError(f"corpus container truncated: {path}")
    if blob[:len(MAGIC)] != MAGIC:
        raise CorpusFormatError(f"bad corpus magic: {path}")
    body, digest = blob[:-_DIGEST_LEN], blob[-_DIGEST_LEN:]
    if hashlib.sha256(body).digest() != digest:
        raise CorpusFormatError(
            f"corpus checksum mismatch (corrupt or tampered): {path}")
    (hlen,) = struct.unpack_from("<Q", blob, len(MAGIC))
    start = len(MAGIC) + 8
    if start + hlen > len(body):
        raise CorpusFormatError(f"corpus header overruns the blob: {path}")
    try:
        header = json.loads(body[start:start + hlen].decode("utf-8"))
    except Exception as e:
        raise CorpusFormatError(f"unparseable corpus header ({e}): {path}")
    if header.get("version") != CORPUS_FORMAT_VERSION:
        raise CorpusFormatError(
            f"unsupported corpus container version "
            f"{header.get('version')!r} (reader supports "
            f"{CORPUS_FORMAT_VERSION}): {path}")
    if header.get("schema") != CORPUS_SCHEMA:
        raise CorpusFormatError(
            f"corpus row schema skew: container {header.get('schema')!r} "
            f"!= reader {CORPUS_SCHEMA} — refusing to misparse: {path}")
    rows: List[Dict[str, Any]] = []
    for line in body[start + hlen:].splitlines():
        if not line:
            continue
        try:
            rows.append(json.loads(line.decode("utf-8")))
        except Exception as e:
            raise CorpusFormatError(f"malformed corpus row ({e}): {path}")
    return header, rows


def read_corpus(source: str) -> List[Dict[str, Any]]:
    """A corpus file OR a directory of ``*.atpucorp`` containers → every
    row, oldest container first (names sort chronologically)."""
    if os.path.isdir(source):
        names = sorted(n for n in os.listdir(source)
                       if n.endswith(CORPUS_SUFFIX))
        if not names:
            raise CorpusFormatError(
                f"no *{CORPUS_SUFFIX} containers in {source}")
        out: List[Dict[str, Any]] = []
        for n in names:
            out.extend(read_corpus_file(os.path.join(source, n))[1])
        return out
    return read_corpus_file(source)[1]
