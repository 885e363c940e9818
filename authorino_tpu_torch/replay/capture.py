"""Traffic capture (layer 1): an opt-in full-fidelity request log.

The decision log samples one structured record per batch — enough to
see WHAT the engine decided, useless for re-deciding.  This module extends
that sampling seam with the raw request tuple (authconfig + the full
authorization JSON), so a captured window can be *replayed* offline against
a candidate snapshot (replay/replay.py) or in-process by the reconcile
pregate (replay/pregate.py).

Design constraints :

- **zero-cost when off**: the engine's per-batch hook is one attribute
  check (``CAPTURE.enabled``); nothing else runs;
- **never on the batch-cut hot path**: ``offer()`` only appends a raw
  tuple to a bounded queue (drop-and-count on overflow — capture loss is
  an accounted event, never backpressure).  JSON encoding, byte
  accounting, ring eviction and segment persistence all happen on the
  capture log's OWN daemon drain thread;
- **bounded by bytes, not records**: requests vary wildly in size, so the
  in-memory ring evicts oldest-first against ``--capture-log-size-mb`` of
  ENCODED bytes, and the on-disk segment directory is pruned to the same
  budget.  A record cap would let one fat-header tenant blow the memory
  bound;
- **sampled**: ``--capture-sample N`` keeps 1-in-N decisions (per-batch
  stride, same family as the head sampler but returning every fire
  point inside the batch, not just the head);
- **readable offline**: segments are pickle-free checksummed containers in
  the serialize style (MAGIC + JSON header + JSON-lines payload +
  sha256 trailer).  A version- or schema-skewed segment raises the typed
  :class:`CaptureFormatError` instead of misparsing.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import struct
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from ..utils import metrics as metrics_mod
from ..utils.atomicio import atomic_write_bytes

__all__ = ["CAPTURE", "CaptureLog", "CaptureFormatError", "CAPTURE_SCHEMA",
           "CAPTURE_FORMAT_VERSION", "SEGMENT_SUFFIX", "write_segment",
           "read_segment", "read_capture", "encode_record"]

log = logging.getLogger("authorino_tpu_torch.replay.capture")

# capture record schema: bumped whenever the per-record field set changes,
# so offline readers (analysis --replay, bench --replay-log) can refuse
# version-skewed logs with a typed error instead of misparsing.
# v2: + metadata_doc_digest — the combined digest of the
# prefetch cache's pinned metadata documents the decision evaluated under
# (None for configs with no pinned metadata), making metadata-dependent
# replays reproducible (docs/replay.md)
CAPTURE_SCHEMA = 2
CAPTURE_FORMAT_VERSION = 1
MAGIC = b"ATPUCAP1\x00"
_DIGEST_LEN = 32
SEGMENT_SUFFIX = ".atpucap"

# pinned record shape (tests/test_replay.py): every captured record carries
# exactly these keys
CAPTURE_FIELDS = ("schema", "t", "authconfig", "doc", "verdict",
                  "rule_index", "lane", "generation",
                  "metadata_doc_digest")


class CaptureFormatError(ValueError):
    """The blob is not a valid capture segment (bad magic, truncated,
    checksum mismatch, unsupported container version, or record-schema
    skew).  Read-time only — typed so callers distinguish 'not a capture
    log' from a replay result."""


# ---------------------------------------------------------------------------
# container: MAGIC + u64 header length + JSON header + JSON-lines payload
#            + sha256 trailer (snapshot-container style, no pickle anywhere)
# ---------------------------------------------------------------------------


def encode_record(rec: Dict[str, Any]) -> bytes:
    """One record → one canonical JSON line.  sort_keys makes the encoding
    deterministic, so round-trip parity is byte-testable."""
    return json.dumps(rec, sort_keys=True, separators=(",", ":"),
                      default=str).encode("utf-8") + b"\n"


def _build_container(payload: bytes, count: int,
                     meta: Optional[Dict[str, Any]] = None) -> bytes:
    header = {
        "version": CAPTURE_FORMAT_VERSION,
        "schema": CAPTURE_SCHEMA,
        "count": int(count),
        "created_unix": time.time(),
        "meta": meta or {},
    }
    hb = json.dumps(header, sort_keys=True,
                    separators=(",", ":")).encode("utf-8")
    body = MAGIC + struct.pack("<Q", len(hb)) + hb + payload
    return body + hashlib.sha256(body).digest()


def write_segment(path: str, records: Sequence[Dict[str, Any]],
                  meta: Optional[Dict[str, Any]] = None) -> str:
    """Serialize ``records`` into one checksummed segment at ``path``
    (tmp + atomic rename — a torn write is unreachable, like the snapshot
    publisher)."""
    payload = b"".join(encode_record(r) for r in records)
    blob = _build_container(payload, len(records), meta)
    return atomic_write_bytes(path, blob, artifact="capture")


def read_segment(path: str) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
    """One segment file → (header, records).  Verifies magic + sha256 +
    container version + record schema BEFORE parsing any record; every
    failure is a typed :class:`CaptureFormatError` and the caller's state
    is untouched."""
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < len(MAGIC) + 8 + _DIGEST_LEN:
        raise CaptureFormatError(f"capture segment truncated: {path}")
    if blob[:len(MAGIC)] != MAGIC:
        raise CaptureFormatError(f"bad capture magic: {path}")
    body, digest = blob[:-_DIGEST_LEN], blob[-_DIGEST_LEN:]
    if hashlib.sha256(body).digest() != digest:
        raise CaptureFormatError(
            f"capture checksum mismatch (corrupt or tampered): {path}")
    (hlen,) = struct.unpack_from("<Q", blob, len(MAGIC))
    start = len(MAGIC) + 8
    if start + hlen > len(body):
        raise CaptureFormatError(f"capture header overruns the blob: {path}")
    try:
        header = json.loads(body[start:start + hlen].decode("utf-8"))
    except Exception as e:
        raise CaptureFormatError(f"unparseable capture header ({e}): {path}")
    if header.get("version") != CAPTURE_FORMAT_VERSION:
        raise CaptureFormatError(
            f"unsupported capture container version "
            f"{header.get('version')!r} (reader supports "
            f"{CAPTURE_FORMAT_VERSION}): {path}")
    if header.get("schema") != CAPTURE_SCHEMA:
        raise CaptureFormatError(
            f"capture record schema skew: segment {header.get('schema')!r} "
            f"!= reader {CAPTURE_SCHEMA} — refusing to misparse: {path}")
    records: List[Dict[str, Any]] = []
    for line in body[start + hlen:].splitlines():
        if not line:
            continue
        try:
            records.append(json.loads(line.decode("utf-8")))
        except Exception as e:
            raise CaptureFormatError(f"malformed capture record ({e}): {path}")
    return header, records


def read_capture(source: str) -> List[Dict[str, Any]]:
    """A segment file OR a capture directory → every record, oldest segment
    first (segment names sort chronologically: capture-<ms>-<seq>)."""
    if os.path.isdir(source):
        names = sorted(n for n in os.listdir(source)
                       if n.endswith(SEGMENT_SUFFIX))
        if not names:
            raise CaptureFormatError(
                f"no *{SEGMENT_SUFFIX} segments in {source}")
        out: List[Dict[str, Any]] = []
        for n in names:
            out.extend(read_segment(os.path.join(source, n))[1])
        return out
    return read_segment(source)[1]


# ---------------------------------------------------------------------------
# the live capture log
# ---------------------------------------------------------------------------


class CaptureLog:
    """Byte-bounded sampled request log with an offline persistence tail.

    Hot-path surface (engine `_observe_provenance`, per batch):
    ``sample_indices(n)`` → which of this batch's decisions to keep,
    ``offer(...)`` per kept decision → bounded-queue append.  Everything
    heavier — encode, byte accounting, ring eviction, segment write,
    directory pruning — runs on the drain thread."""

    def __init__(self, enabled: bool = False, size_mb: float = 64.0,
                 sample_n: int = 1, directory: Optional[str] = None,
                 segment_mb: float = 4.0, queue_max: int = 8192):
        self.enabled = bool(enabled)
        self.size_bytes = max(1, int(float(size_mb) * 1024 * 1024))
        self.sample_n = max(1, int(sample_n))
        self.directory = directory
        self.segment_bytes = max(4096, int(float(segment_mb) * 1024 * 1024))
        self.queue_max = max(16, int(queue_max))
        # raw offer queue: appended from any serving thread, drained by the
        # capture thread.  deque appends are atomic; the drop check is a
        # len() read — a racing append can momentarily overshoot by a few
        # records, never unboundedly (each offerer sees the full queue)
        self._queue: deque = deque()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # encoded ring: (nbytes, record) pairs, evicted oldest-first to the
        # byte budget.  Guarded — the drain thread appends while pregate /
        # debug readers snapshot.
        self._ring: deque = deque()
        self._ring_bytes = 0
        self._ring_lock = threading.Lock()
        # drain-side state (drain thread + flush() only, under _proc_lock)
        self._proc_lock = threading.Lock()
        self._seg_lines: List[bytes] = []
        self._seg_nbytes = 0
        self._seg_seq = 0
        # sampler state: same racy-by-design counters as the head
        # sampler — a lost race loses a sample, never adds per-request work
        self._seen = 0
        self._next_fire = 1
        # accounting
        self.stored_total = 0
        self.dropped_total = 0
        self.evicted_total = 0
        self.encode_failures = 0
        self.segments_written = 0
        self.segments_pruned = 0

    # -- configuration -----------------------------------------------------

    def configure(self, enabled: Optional[bool] = None,
                  size_mb: Optional[float] = None,
                  sample_n: Optional[int] = None,
                  directory: Optional[str] = None,
                  segment_mb: Optional[float] = None) -> None:
        if size_mb is not None:
            self.size_bytes = max(1, int(float(size_mb) * 1024 * 1024))
        if sample_n is not None:
            self.sample_n = max(1, int(sample_n))
            self._next_fire = self._seen + self.sample_n
        if segment_mb is not None:
            self.segment_bytes = max(4096,
                                     int(float(segment_mb) * 1024 * 1024))
        if directory is not None:
            self.directory = directory or None
            if self.directory:
                os.makedirs(self.directory, exist_ok=True)
        if enabled is not None:
            self.enabled = bool(enabled)
        if self.enabled:
            self._ensure_thread()

    def _ensure_thread(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        t = threading.Thread(target=self._drain_loop, name="atpu-capture",
                             daemon=True)
        self._thread = t
        t.start()

    # -- hot path (serving threads) ----------------------------------------

    def sample_indices(self, n_decisions: int) -> Iterable[int]:
        """Which of this batch's ``n_decisions`` decisions the 1-in-N
        sampler keeps (indices into the batch).  sample_n=1 keeps every
        decision; otherwise the stride sampler fires at every multiple —
        O(kept) per batch, not O(batch)."""
        if not self.enabled or n_decisions <= 0:
            return ()
        if self.sample_n <= 1:
            self._seen += n_decisions
            return range(n_decisions)
        start = self._seen
        self._seen = end = start + n_decisions
        out: List[int] = []
        nf = self._next_fire
        while nf <= end:
            out.append(nf - start - 1)
            nf += self.sample_n
        self._next_fire = nf
        return out

    def offer(self, authconfig: str, doc: Any, rule_index: int, lane: str,
              generation: Any, t: Optional[float] = None,
              metadata_doc_digest: Optional[str] = None) -> None:
        """Queue one sampled decision for capture.  Bounded queue,
        drop-and-count on overflow — the serving path never blocks on and
        never pays for capture encoding.  ``metadata_doc_digest`` pins
        which prefetched metadata documents the decision evaluated under
        (replays of metadata-dependent configs are reproducible
        and digest-checkable)."""
        if not self.enabled:
            return
        if len(self._queue) >= self.queue_max:
            self.dropped_total += 1
            metrics_mod.capture_records.labels("dropped").inc()
            return
        self._queue.append((t if t is not None else time.time(),
                            authconfig, doc, int(rule_index), lane,
                            generation, metadata_doc_digest))
        self._wake.set()

    # -- drain thread ------------------------------------------------------

    def _drain_loop(self) -> None:
        while True:
            self._wake.wait(timeout=0.05)
            self._wake.clear()
            try:
                self._process_queue()
            except Exception:
                log.exception("capture drain failed (serving unaffected)")

    def _process_queue(self) -> None:
        with self._proc_lock:
            while True:
                try:
                    item = self._queue.popleft()
                except IndexError:
                    break
                self._ingest(item)

    def _ingest(self, item: Tuple) -> None:
        t, authconfig, doc, rule_index, lane, generation, md_digest = item
        rec = {
            "schema": CAPTURE_SCHEMA,
            "t": t,
            "authconfig": authconfig,
            "doc": doc,
            "verdict": "allow" if rule_index < 0 else "deny",
            "rule_index": rule_index,
            "lane": lane,
            "generation": generation,
            "metadata_doc_digest": md_digest,
        }
        try:
            enc = encode_record(rec)
        except Exception:
            self.encode_failures += 1
            self.dropped_total += 1
            metrics_mod.capture_records.labels("dropped").inc()
            return
        n = len(enc)
        with self._ring_lock:
            self._ring.append((n, rec))
            self._ring_bytes += n
            while self._ring_bytes > self.size_bytes and len(self._ring) > 1:
                en, _ = self._ring.popleft()
                self._ring_bytes -= en
                self.evicted_total += 1
        self.stored_total += 1
        metrics_mod.capture_records.labels("stored").inc()
        if self.directory:
            self._seg_lines.append(enc)
            self._seg_nbytes += n
            if self._seg_nbytes >= self.segment_bytes:
                self._write_segment()

    def _write_segment(self) -> None:
        if not self._seg_lines or not self.directory:
            return
        payload = b"".join(self._seg_lines)
        count = len(self._seg_lines)
        self._seg_lines = []
        self._seg_nbytes = 0
        self._seg_seq += 1
        name = "capture-%013d-%06d%s" % (int(time.time() * 1e3),
                                         self._seg_seq, SEGMENT_SUFFIX)
        path = os.path.join(self.directory, name)
        try:
            blob = _build_container(payload, count,
                                    meta={"sample_n": self.sample_n})
            # shared atomic writer: the old inline tmp+replace
            # here skipped fsync, so a crash mid-rotation could surface a
            # truncated segment under a fully-renamed name
            atomic_write_bytes(path, blob, artifact="capture")
            self.segments_written += 1
            self._prune_dir()
        except Exception:
            log.exception("capture segment write failed (ring unaffected)")

    def _prune_dir(self) -> None:
        """Byte-bound the segment directory to the SAME budget as the ring:
        oldest segments go first.  Best-effort — pruning must never lose
        the segment just written."""
        try:
            names = sorted(n for n in os.listdir(self.directory)
                           if n.endswith(SEGMENT_SUFFIX))
            sizes = {n: os.path.getsize(os.path.join(self.directory, n))
                     for n in names}
            total = sum(sizes.values())
            for n in names[:-1]:  # never prune the newest
                if total <= self.size_bytes:
                    break
                try:
                    os.unlink(os.path.join(self.directory, n))
                    total -= sizes[n]
                    self.segments_pruned += 1
                except OSError:
                    pass
        except OSError:
            pass

    # -- readers -----------------------------------------------------------

    def flush(self, timeout_s: float = 5.0) -> bool:
        """Drain the queue inline and force the pending segment buffer to
        disk.  Tests, bench artifact finalization and orderly shutdown —
        the serving path never calls this."""
        deadline = time.monotonic() + timeout_s
        while self._queue and time.monotonic() < deadline:
            self._process_queue()
        self._process_queue()
        with self._proc_lock:
            self._write_segment()
        return not self._queue

    def ring_records(self) -> List[Dict[str, Any]]:
        """Snapshot of the in-memory ring, oldest first — the pregate's
        replay corpus."""
        with self._ring_lock:
            return [rec for _, rec in self._ring]

    def clear(self) -> None:
        """Drop ring + queue + sampler state (tests between scenarios)."""
        with self._ring_lock:
            self._ring.clear()
            self._ring_bytes = 0
        self._queue.clear()
        with self._proc_lock:
            self._seg_lines = []
            self._seg_nbytes = 0
        self._seen = 0
        self._next_fire = 1

    def to_json(self) -> Dict[str, Any]:
        with self._ring_lock:
            ring_n, ring_bytes = len(self._ring), self._ring_bytes
        return {
            "enabled": self.enabled,
            "schema": CAPTURE_SCHEMA,
            "size_bytes": self.size_bytes,
            "sample_n": self.sample_n,
            "directory": self.directory,
            "ring_records": ring_n,
            "ring_bytes": ring_bytes,
            "queue_depth": len(self._queue),
            "stored_total": self.stored_total,
            "dropped_total": self.dropped_total,
            "evicted_total": self.evicted_total,
            "encode_failures": self.encode_failures,
            "segments_written": self.segments_written,
            "segments_pruned": self.segments_pruned,
        }


# one capture log per process (both lanes sample into it; the pregate and
# /debug/replay read it) — opt-in: disabled until configure(enabled=True)
CAPTURE = CaptureLog()
