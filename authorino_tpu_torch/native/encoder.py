"""Wrapper for the _atpuenc_torch extension (native/csrc/encoder.cpp +
pymod.cpp).

Prepares flattened policy tables once per compiled corpus, then encodes
micro-batches through one C call — walking the Python dict documents
directly by default, or via a GIL-free threaded JSON-blob path
(AUTHORINO_TPU_ENCODE_MODE=json).  Attrs whose selectors use gjson
extensions (``#``, queries, ``@modifiers``) and whole-tree CPU leaves are
finished in Python — exact parity with compiler/encode.py is asserted by
tests/test_torch_native_encoder.py's differential suite.

The C ``Policy`` is read-only once built, so the encode pool's workers share
one encoder; its capsule frees the tables when the encoder (cached on its
compiled policy) goes with its snapshot.  ``batches`` counts the batches an
encoder answered and ``bailed`` those it handed back to the Python encoder
(a ``None`` from the C side); ``TOTALS`` sums them over every encoder of
the process by mode (``reset_totals`` zeroes it): read by
``chip_smoke.py`` and the tests, as ``ops.fused_kernel.launches`` is.
"""

from __future__ import annotations

import json
import os
import re as _re
import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..authjson import selector as sel
from ..compiler.compile import (
    DFA_VALUE_BYTES,
    OP_CPU,
    OP_ERROR,
    OP_EXCL,
    OP_INCL,
    OP_REGEX_DFA,
    OP_TREE_CPU,
    CompiledPolicy,
)
from ..compiler.encode import EncodedBatch, _MISSING, _render
from ..compiler.intern import EMPTY_ID, PAD
from ..compiler.pack import wire_dtype

__all__ = ["NativeEncoder", "get_native_encoder", "out_of_domain",
           "TOTALS", "reset_totals"]

# batches answered natively per mode, and batches handed back, process-wide
TOTALS = {"object": 0, "json": 0, "bailed": 0}
_TOTALS_LOCK = threading.Lock()


def reset_totals() -> None:
    with _TOTALS_LOCK:
        for k in TOTALS:
            TOTALS[k] = 0


def _addr(a: np.ndarray) -> int:
    return a.ctypes.data


# the exact grammar the C walkers' array-index parse accepts (encoder.cpp
# walk / pymod.cpp walk_py: ASCII space/tab trim, one sign, ASCII digits)
_C_INT_FORM = _re.compile(r"^[ \t]*[+-]?[0-9]+[ \t]*\Z")  # \Z: '$' would pass '1\n'


def _int_divergent(seg: str) -> bool:
    """True when Python int(seg) accepts a form the C parsers reject
    (underscores, non-ASCII digits, unicode whitespace): the attr must be
    Python-finished or the two paths disagree on list-index segments."""
    try:
        int(seg)
    except (ValueError, TypeError):
        return False
    return _C_INT_FORM.match(seg) is None


class _LazyDocs:
    """Parse a doc from its JSON part only if a finishing task needs it."""

    def __init__(self, parts: Sequence[bytes]):
        self._parts = parts
        self._cache: Dict[int, Any] = {}

    def __getitem__(self, i: int):
        doc = self._cache.get(i)
        if doc is None:
            doc = json.loads(self._parts[i])
            self._cache[i] = doc
        return doc

    def __len__(self):
        return len(self._parts)


def _blob(strings: List[str]):
    """(blob bytes, offs int64[n+1])"""
    parts = [s.encode("utf-8") for s in strings]
    offs = np.zeros(len(parts) + 1, dtype=np.int64)
    np.cumsum([len(p) for p in parts], out=offs[1:])
    return b"".join(parts), offs


class NativeEncoder:
    def __init__(self, mod, policy: CompiledPolicy):
        self._mod = mod
        self.policy = policy
        p = policy

        intern_strings = list(p.interner._table.keys())
        intern_ids = np.fromiter(p.interner._table.values(), dtype=np.int32,
                                 count=len(p.interner._table))
        intern_blob, intern_offs = _blob(intern_strings)

        # per-attr plain dot-paths; anything fancier is Python-finished
        segs: List[str] = []
        attr_seg_offs = np.zeros(p.n_attrs + 1, dtype=np.int32)
        attr_complex = np.zeros(p.n_attrs, dtype=np.uint8)
        self._complex_attrs: List[int] = []
        for a, selector_str in enumerate(p.attr_selectors):
            parsed = sel._parse_path(selector_str) if selector_str else ()
            if (selector_str and all(s.kind == "key" for s in parsed)
                    and not any(_int_divergent(s.key) for s in parsed)):
                segs.extend(s.key for s in parsed)
            else:
                attr_complex[a] = 1
                self._complex_attrs.append(a)
            attr_seg_offs[a + 1] = len(segs)
        seg_blob, seg_offs = _blob(segs)
        self._seg_objs = tuple(segs)  # PyUnicode keys for the dict-walk path

        cfg_attr_offs = np.zeros(p.n_configs + 1, dtype=np.int32)
        cfg_attr_idx: List[int] = []
        cfg_cpu_offs = np.zeros(p.n_configs + 1, dtype=np.int32)
        cfg_cpu_idx: List[int] = []
        for g in range(p.n_configs):
            cfg_attr_idx.extend(p.config_attrs[g])
            cfg_attr_offs[g + 1] = len(cfg_attr_idx)
            cfg_cpu_idx.extend(p.config_cpu_leaves[g])
            cfg_cpu_offs[g + 1] = len(cfg_cpu_idx)
        cfg_attr_idx_np = np.asarray(cfg_attr_idx or [0], dtype=np.int32)
        cfg_cpu_idx_np = np.asarray(cfg_cpu_idx or [0], dtype=np.int32)

        # max CPU tasks per doc of config g + cpu leaves Python must finish
        self._cpu_task_bound = np.zeros(max(p.n_configs, 1), dtype=np.int64)
        complex_set = set(self._complex_attrs)
        self._complex_cpu_leaves: List[List[int]] = []
        for g in range(p.n_configs):
            bound = 0
            cleaves = []
            for leaf in p.config_cpu_leaves[g]:
                op = int(p.leaf_op[leaf])
                is_complex = op != OP_TREE_CPU and int(p.leaf_attr[leaf]) in complex_set
                if op in (OP_TREE_CPU, OP_CPU, OP_REGEX_DFA) or is_complex:
                    bound += 1
                if is_complex:
                    cleaves.append(leaf)
            self._cpu_task_bound[g] = bound
            self._complex_cpu_leaves.append(cleaves)

        leaf_op = np.ascontiguousarray(p.leaf_op, dtype=np.int32)
        leaf_attr = np.ascontiguousarray(p.leaf_attr, dtype=np.int32)
        leaf_const = np.ascontiguousarray(p.leaf_const, dtype=np.int32)
        attr_byte_slot = np.ascontiguousarray(p.attr_byte_slot, dtype=np.int32)

        self._handle = mod.policy_new(
            intern_blob, _addr(intern_offs), _addr(intern_ids), len(intern_strings),
            p.n_attrs, seg_blob, _addr(seg_offs), len(segs), _addr(attr_seg_offs),
            _addr(attr_complex), _addr(attr_byte_slot),
            p.n_leaves, _addr(leaf_op), _addr(leaf_attr), _addr(leaf_const),
            p.n_configs, _addr(cfg_attr_offs), _addr(cfg_attr_idx_np),
            _addr(cfg_cpu_offs), _addr(cfg_cpu_idx_np),
            p.members_k, DFA_VALUE_BYTES, max(p.n_byte_attrs, 1),
        )
        self.mode = os.environ.get("AUTHORINO_TPU_ENCODE_MODE", "object")
        # a few threads beyond the core count wins even on small hosts: the
        # encode slices interleave with (GIL-released) RPC dispatch threads
        # instead of running as one long burst that delays them
        self.n_threads = int(os.environ.get(
            "AUTHORINO_TPU_ENCODE_THREADS", min(8, 4 * (os.cpu_count() or 1))))
        self.batches = 0   # batches this encoder answered
        self.bailed = 0    # batches handed back to the Python encoder

    def _count(self, out: Optional[EncodedBatch],
               mode: str) -> Optional[EncodedBatch]:
        with _TOTALS_LOCK:
            if out is None:
                self.bailed += 1
                TOTALS["bailed"] += 1
            else:
                self.batches += 1
                TOTALS[mode] += 1
        return out

    # ------------------------------------------------------------------
    def encode_batch(self, docs: Sequence[Any], config_rows: Sequence[int],
                     batch_pad: int = 0) -> Optional[EncodedBatch]:
        """Returns an EncodedBatch, or None if the native path bailed
        (caller falls back to the Python encoder)."""
        n = len(docs)
        if n and not isinstance(docs, list):
            docs = list(docs)
        if n and self.mode == "json":
            try:
                parts = [json.dumps(d, separators=(",", ":"), ensure_ascii=False).encode("utf-8")
                         for d in docs]
            except (TypeError, ValueError):
                # non-serializable doc → Python path raises the real error
                return self._count(None, "json")
            return self.encode_json_parts(parts, config_rows, batch_pad, docs=docs)
        return self._count(self._encode(docs, None, config_rows, batch_pad),
                           "object")

    def encode_json_parts(self, parts: Sequence[bytes], config_rows: Sequence[int],
                          batch_pad: int = 0, docs: Optional[Sequence[Any]] = None,
                          ) -> Optional[EncodedBatch]:
        """GIL-free hot-path entry: ``parts[i]`` is request i's authorization
        JSON as UTF-8 bytes (what a wire frontend already holds).  The C
        side parses + encodes with internal threads while the GIL is
        released.  ``docs`` (parsed dicts) is only needed when the corpus
        has whole-tree CPU leaves or gjson-extended selectors; when absent,
        the rare task that needs one parses it from the blob on demand."""
        return self._count(self._encode(docs, parts, config_rows, batch_pad),
                           "json")

    def _encode(self, docs, parts, config_rows: Sequence[int],
                batch_pad: int = 0) -> Optional[EncodedBatch]:
        p = self.policy
        n = len(parts) if parts is not None else len(docs)
        B = max(n, 1)
        if batch_pad and batch_pad > B:
            B = batch_pad
        A, K, L = p.n_attrs, p.members_k, p.n_leaves
        NB = max(p.n_byte_attrs, 1)

        # wire dtype: ids store as int16 when the interner fits — the C
        # encoder writes the narrow type directly, so pack_batch never pays
        # a cast pass over the dominant tensors
        dt = wire_dtype(p)
        attrs_val = np.full((B, A), EMPTY_ID, dtype=dt)
        attrs_members = np.full((B, A, K), PAD, dtype=dt)
        elem16 = 1 if dt == np.int16 else 0
        overflow = np.zeros((B, A), dtype=bool)
        cpu_lane = np.zeros((B, L), dtype=bool)
        config_id = np.zeros((B,), dtype=np.int32)
        attr_bytes = np.zeros((B, NB, DFA_VALUE_BYTES), dtype=np.uint8)
        byte_ovf = np.zeros((B, NB), dtype=bool)

        if n:
            rows = np.asarray(config_rows, dtype=np.int32)
            config_id[:n] = rows
            max_tasks = int(self._cpu_task_bound[rows].sum()) + 1
            arena_cap = max_tasks * (DFA_VALUE_BYTES + 64) + 4096
            task_r = np.zeros(max_tasks, dtype=np.int32)
            task_leaf = np.zeros(max_tasks, dtype=np.int32)
            task_off = np.zeros(max_tasks, dtype=np.int64)
            task_len = np.zeros(max_tasks, dtype=np.int32)
            arena = np.zeros(arena_cap, dtype=np.uint8)

            out_addrs = (
                _addr(attrs_val), _addr(attrs_members), _addr(overflow),
                _addr(cpu_lane), _addr(attr_bytes), _addr(byte_ovf),
                _addr(task_r), _addr(task_leaf), _addr(task_off), _addr(task_len),
            )
            if parts is not None:
                doc_offs = np.zeros(n + 1, dtype=np.int64)
                np.cumsum([len(pt) for pt in parts], out=doc_offs[1:])
                blob = b"".join(parts)
                rc = self._mod.encode_json(
                    self._handle, blob, _addr(doc_offs), n, _addr(rows),
                    A, K, L, NB, DFA_VALUE_BYTES, *out_addrs,
                    max_tasks, _addr(arena), arena_cap, self.n_threads, elem16)
            else:
                try:
                    rc = self._mod.encode_docs(
                        self._handle, self._seg_objs, docs, _addr(rows), n,
                        A, K, L, NB, DFA_VALUE_BYTES, *out_addrs,
                        max_tasks, _addr(arena), arena_cap, elem16)
                except Exception:
                    return None  # render error (non-serializable nested value)
            if rc < 0:
                return None

            need_doc = bool(self._complex_attrs) or rc
            if need_doc and docs is None and parts is not None:
                docs = _LazyDocs(parts)

            # ---- Python finishing: complex attrs + their cpu leaves ----
            if self._complex_attrs:
                self._finish_complex(docs, rows, attrs_val, attrs_members,
                                     overflow, cpu_lane, attr_bytes, byte_ovf)

            # ---- Python finishing: regex / tree tasks ----
            if rc:
                arena_bytes = arena.tobytes()
                for i in range(rc):
                    r, leaf, vlen = int(task_r[i]), int(task_leaf[i]), int(task_len[i])
                    if vlen == -2:
                        continue  # complex-attr leaf, handled above
                    if vlen == -1:
                        expr = p.leaf_tree[leaf]
                        try:
                            v = bool(expr.matches(docs[r])) if expr is not None else False
                        except Exception:
                            v = False
                        cpu_lane[r, leaf] = v
                        continue
                    rx = p.leaf_regex[leaf]
                    if rx is None:
                        cpu_lane[r, leaf] = False
                        continue
                    off = int(task_off[i])
                    text = arena_bytes[off:off + vlen].decode("utf-8", "surrogatepass")
                    cpu_lane[r, leaf] = rx.search(text) is not None

        return EncodedBatch(
            attrs_val=attrs_val,
            attrs_members=attrs_members,
            overflow=overflow,
            cpu_lane=cpu_lane,
            config_id=config_id,
            attr_bytes=attr_bytes,
            byte_ovf=byte_ovf,
        )

    # ------------------------------------------------------------------
    def _finish_complex(self, docs, rows, attrs_val, attrs_members, overflow,
                        cpu_lane, attr_bytes, byte_ovf) -> None:
        """Resolve gjson-extended selectors the C side skipped — same loop
        body as compiler/encode.py restricted to those attrs/leaves."""
        p = self.policy
        lookup = p.interner.lookup
        complex_set = set(self._complex_attrs)
        K = p.members_k
        for r in range(len(docs)):
            row = int(rows[r])
            todo = [a for a in p.config_attrs[row] if a in complex_set]
            if not todo:
                continue
            doc = docs[r]
            res_by_attr: Dict[int, Any] = {}
            for attr in todo:
                res = sel.get(doc, p.attr_selectors[attr])
                v = res.value if res.exists else _MISSING
                res_by_attr[attr] = v
                rendered = _render(v)
                vid = lookup(rendered)
                attrs_val[r, attr] = vid
                slot = int(p.attr_byte_slot[attr])
                if slot >= 0:
                    raw = rendered.encode("utf-8")
                    if len(raw) > DFA_VALUE_BYTES or 0 in raw:
                        byte_ovf[r, slot] = True
                    elif raw:
                        attr_bytes[r, slot, : len(raw)] = np.frombuffer(raw, dtype=np.uint8)
                if isinstance(v, list):
                    for k, e in enumerate(v[:K]):
                        attrs_members[r, attr, k] = lookup(_render(e))
                    if len(v) > K:
                        overflow[r, attr] = True
                elif v is not _MISSING and v is not None:
                    attrs_members[r, attr, 0] = vid
            for leaf in self._complex_cpu_leaves[row]:
                op = int(p.leaf_op[leaf])
                attr = int(p.leaf_attr[leaf])
                if attr not in res_by_attr:
                    continue
                v = res_by_attr[attr]
                if op == OP_REGEX_DFA:
                    slot = int(p.attr_byte_slot[attr])
                    if slot >= 0 and byte_ovf[r, slot]:
                        rx = p.leaf_regex[leaf]
                        cpu_lane[r, leaf] = rx.search(_render(v)) is not None if rx else False
                elif op == OP_CPU:
                    rx = p.leaf_regex[leaf]
                    cpu_lane[r, leaf] = rx.search(_render(v)) is not None if rx else False
                elif op in (OP_INCL, OP_EXCL) and overflow[r, attr]:
                    members = v if isinstance(v, list) else []
                    const = int(p.leaf_const[leaf])
                    is_member = any(lookup(_render(e)) == const for e in members)
                    cpu_lane[r, leaf] = is_member if op == OP_INCL else not is_member


def out_of_domain(policy: CompiledPolicy) -> Optional[str]:
    """Why the C encoder cannot encode ``policy`` (None: it can).  The C
    encoder predates the numeric/relation lanes and the overflow assist:
    corpora using them take the Python encoder — exactness over speed,
    never a partially-filled batch."""
    if int(getattr(policy, "n_num_attrs", 0) or 0):
        return "numeric lanes"
    if int(getattr(policy, "n_rel_slots", 0) or 0):
        return "relation lanes"
    if getattr(policy, "ovf_assist", False):
        return "overflow assist"
    return None


def get_native_encoder(policy: CompiledPolicy) -> Optional[NativeEncoder]:
    """Build (and cache on the policy) a NativeEncoder; None when the
    corpus is outside the C encoder's domain or AUTHORINO_TPU_NATIVE=0 asks
    for the Python encoder.  A failed build raises BuildError."""
    cached = getattr(policy, "_native_encoder", None)
    if cached is not None:
        return cached if cached is not False else None
    from . import load_library, native_enabled

    if out_of_domain(policy) is not None or not native_enabled():
        policy._native_encoder = False  # type: ignore[attr-defined]
        return None
    enc = NativeEncoder(load_library(), policy)
    policy._native_encoder = enc  # type: ignore[attr-defined]
    return enc
