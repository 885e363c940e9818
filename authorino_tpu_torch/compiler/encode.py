"""Request → tensor encoder (CPU side of the hot path).

For each request in a micro-batch, resolve only the selectors its own
AuthConfig references (other configs' verdict columns are discarded), render
with gjson-String() semantics, and intern to int32 ids.  Exactness guarantees:

  - value ids come from lookup-only interning (no collisions; unseen → UNSEEN)
  - membership vectors carry up to K element ids; longer arrays set an
    overflow bit and the exact incl/excl answer rides the CPU lane
  - regex (`matches`) leaves are always evaluated here with regexes
    precompiled at corpus-compile time (the reference recompiles per request —
    ref: pkg/jsonexp/expressions.go:87)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from ..authjson import selector as sel
from ..expressions.ast import parse_int_value
from .compile import (
    DFA_VALUE_BYTES,
    OP_CPU,
    OP_ERROR,
    OP_EXCL,
    OP_INCL,
    OP_REGEX_DFA,
    OP_TREE_CPU,
    CompiledPolicy,
)
from .intern import EMPTY_ID, PAD

__all__ = ["EncodedBatch", "encode_batch", "encode_batch_py"]


@dataclass
class EncodedBatch:
    attrs_val: np.ndarray      # [B, A] wire dtype (int16/int32 — pack.wire_dtype)
    attrs_members: np.ndarray  # [B, A, K] wire dtype
    overflow: np.ndarray       # [B, A] bool
    cpu_lane: np.ndarray       # [B, L] bool
    config_id: np.ndarray      # [B] int32
    attr_bytes: np.ndarray     # [B, NB, DFA_VALUE_BYTES] uint8 (device regex lane)
    byte_ovf: np.ndarray       # [B, NB] bool — value too long / has NUL → CPU lane
    # numeric comparator lane: parsed int32 value + validity per
    # compact numeric slot (None when the corpus has no numeric leaves)
    attrs_num: Optional[np.ndarray] = None   # [B, NN] int32
    num_valid: Optional[np.ndarray] = None   # [B, NN] bool
    # relation lane: entity row per (attr, relation) slot — row
    # 0 is the reserved empty row unknown entities resolve to
    rel_rows: Optional[np.ndarray] = None    # [B, NR] int32


_MISSING = object()


def _fast_resolvers(policy: CompiledPolicy):
    """Per-attr resolver closures, cached on the policy.  Selectors that are
    plain dot-paths (the overwhelming majority in real AuthConfigs) compile
    to direct dict walks, skipping the full gjson engine."""
    cached = getattr(policy, "_resolvers", None)
    if cached is not None:
        return cached
    resolvers = []
    for selector_str in policy.attr_selectors:
        segs = sel._parse_path(selector_str) if selector_str else ()
        if selector_str and all(s.kind == "key" for s in segs):
            keys = tuple(s.key for s in segs)

            def fast(doc, _keys=keys):
                cur = doc
                for k in _keys:
                    if isinstance(cur, dict):
                        cur = cur.get(k, _MISSING)
                        if cur is _MISSING:
                            return _MISSING
                    elif isinstance(cur, list):
                        # match selector.get: only non-negative in-range indices
                        try:
                            idx = int(k)
                        except ValueError:
                            return _MISSING
                        if 0 <= idx < len(cur):
                            cur = cur[idx]
                        else:
                            return _MISSING
                    else:
                        return _MISSING
                return cur

            resolvers.append(fast)
        else:

            def slow(doc, _s=selector_str):
                r = sel.get(doc, _s)
                return r.value if r.exists else _MISSING

            resolvers.append(slow)
    policy._resolvers = resolvers  # type: ignore[attr-defined]
    return resolvers


def _render(v) -> str:
    """gjson String() rendering of a resolved Python value."""
    if v is _MISSING or v is None:
        return ""
    if isinstance(v, str):
        return v
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return sel.num_str(v)
    return sel.to_raw_json(v)


def encode_batch(
    policy: CompiledPolicy,
    docs: Sequence[Any],
    config_rows: Sequence[int],
    batch_pad: int = 0,
) -> EncodedBatch:
    """Encode a batch against a compiled corpus — the native (C++) encoder
    for a corpus in its domain, else the Python implementation below (also
    where the native path hands a batch back: a document it cannot
    render).  ``config_rows[i]`` is the row of the request's host's config;
    ``batch_pad`` pads B up for shape-bucketing.  A failed native build
    raises (``native.BuildError``)."""
    from ..native import get_native_encoder  # lazy: avoids import cycle

    nat = get_native_encoder(policy)
    if nat is not None:
        out = nat.encode_batch(docs, config_rows, batch_pad)
        if out is not None:
            return out
    return encode_batch_py(policy, docs, config_rows, batch_pad)


def encode_batch_py(
    policy: CompiledPolicy,
    docs: Sequence[Any],
    config_rows: Sequence[int],
    batch_pad: int = 0,
) -> EncodedBatch:
    """Pure-Python encoder (the semantic oracle for the native path)."""
    B = max(len(docs), 1)
    if batch_pad and batch_pad > B:
        B = batch_pad
    A = policy.n_attrs
    K = policy.members_k
    L = policy.n_leaves

    from .pack import wire_dtype

    dt = wire_dtype(policy)  # int16 when the interner fits (pack.py)
    attrs_val = np.full((B, A), EMPTY_ID, dtype=dt)
    attrs_members = np.full((B, A, K), PAD, dtype=dt)
    overflow = np.zeros((B, A), dtype=bool)
    cpu_lane = np.zeros((B, L), dtype=bool)
    config_id = np.zeros((B,), dtype=np.int32)
    NB = max(policy.n_byte_attrs, 1)
    attr_bytes = np.zeros((B, NB, DFA_VALUE_BYTES), dtype=np.uint8)
    byte_ovf = np.zeros((B, NB), dtype=bool)
    attr_byte_slot = policy.attr_byte_slot
    # numeric + relation lanes — inert (None) when absent
    NN = int(getattr(policy, "n_num_attrs", 0) or 0)
    num_attr_slot = policy.num_attr_slot if NN else None
    attrs_num = np.zeros((B, NN), dtype=np.int32) if NN else None
    num_valid = np.zeros((B, NN), dtype=bool) if NN else None
    NR = int(getattr(policy, "n_rel_slots", 0) or 0)
    rel_rows = np.zeros((B, NR), dtype=np.int32) if NR else None
    rel_slots_of_attr = _rel_slots_of_attr(policy) if NR else None

    lookup = policy.interner.lookup
    resolvers = _fast_resolvers(policy)
    leaf_attr = policy.leaf_attr
    leaf_op = policy.leaf_op
    leaf_const = policy.leaf_const
    leaf_regex = policy.leaf_regex
    config_attrs = policy.config_attrs
    config_cpu_leaves = policy.config_cpu_leaves

    # accumulate scatter triples and bulk-assign once per batch — per-element
    # numpy scalar stores dominate encode time otherwise
    v_r: List[int] = []
    v_a: List[int] = []
    v_id: List[int] = []
    m_r: List[int] = []
    m_a: List[int] = []
    m_k: List[int] = []
    m_id: List[int] = []
    o_r: List[int] = []
    o_a: List[int] = []
    c_r: List[int] = []
    c_l: List[int] = []
    c_v: List[bool] = []

    for r, (doc, row) in enumerate(zip(docs, config_rows)):
        config_id[r] = row
        # resolve each needed selector once; share across leaves on that attr
        res_by_attr = {}
        ovf_attrs = None
        byte_ovf_attrs = None
        for attr in config_attrs[row]:
            v = resolvers[attr](doc)
            res_by_attr[attr] = v
            rendered = _render(v)
            vid = lookup(rendered)
            v_r.append(r)
            v_a.append(attr)
            v_id.append(vid)
            slot = attr_byte_slot[attr]
            if slot >= 0:
                raw = rendered.encode("utf-8")
                if len(raw) > DFA_VALUE_BYTES or 0 in raw:
                    byte_ovf[r, slot] = True
                    if byte_ovf_attrs is None:
                        byte_ovf_attrs = set()
                    byte_ovf_attrs.add(attr)
                elif raw:
                    attr_bytes[r, slot, : len(raw)] = np.frombuffer(raw, dtype=np.uint8)
            if num_attr_slot is not None:
                ns = num_attr_slot[attr]
                if ns >= 0:
                    nv = parse_int_value(rendered)
                    if nv is not None:
                        attrs_num[r, ns] = nv
                        num_valid[r, ns] = True
            if rel_slots_of_attr is not None:
                for rs, inst in rel_slots_of_attr.get(attr, ()):
                    rel_rows[r, rs] = policy.rel_entity_rows[inst].get(
                        rendered, 0)
            # gjson Array(): list → elements; null/missing → []; scalar → [v]
            if isinstance(v, list):
                for k, e in enumerate(v[:K]):
                    m_r.append(r)
                    m_a.append(attr)
                    m_k.append(k)
                    m_id.append(lookup(_render(e)))
                if len(v) > K:
                    o_r.append(r)
                    o_a.append(attr)
                    if ovf_attrs is None:
                        ovf_attrs = set()
                    ovf_attrs.add(attr)
            elif v is not _MISSING and v is not None:
                m_r.append(r)
                m_a.append(attr)
                m_k.append(0)
                m_id.append(vid)
        # CPU lane: non-DFA regex always; DFA regex and incl/excl only on
        # their respective overflows
        for leaf in config_cpu_leaves[row]:
            op = leaf_op[leaf]
            if op == OP_REGEX_DFA:
                attr = leaf_attr[leaf]
                if byte_ovf_attrs is not None and attr in byte_ovf_attrs:
                    rx = leaf_regex[leaf]
                    v = res_by_attr.get(attr, _MISSING)
                    c_r.append(r)
                    c_l.append(leaf)
                    c_v.append(rx.search(_render(v)) is not None if rx else False)
            elif op == OP_TREE_CPU:
                # whole-tree oracle fallback (invalid-regex trees): error ⇒
                # False (deny for rules, skip for conditions — exact at root)
                expr = policy.leaf_tree[leaf]
                try:
                    v_tree = bool(expr.matches(doc)) if expr is not None else False
                except Exception:
                    v_tree = False
                c_r.append(r)
                c_l.append(leaf)
                c_v.append(v_tree)
            elif op == OP_CPU:
                rx = leaf_regex[leaf]
                v = res_by_attr.get(leaf_attr[leaf], _MISSING)
                c_r.append(r)
                c_l.append(leaf)
                c_v.append(rx.search(_render(v)) is not None if rx else False)
            elif op == OP_ERROR:
                pass  # lane already False
            elif ovf_attrs is not None and leaf_attr[leaf] in ovf_attrs:
                const = leaf_const[leaf]
                v = res_by_attr.get(leaf_attr[leaf], _MISSING)
                members = v if isinstance(v, list) else []
                is_member = any(lookup(_render(e)) == const for e in members)
                c_r.append(r)
                c_l.append(leaf)
                c_v.append(is_member if op == OP_INCL else not is_member)

    if v_r:
        attrs_val[v_r, v_a] = v_id
    if m_r:
        attrs_members[m_r, m_a, m_k] = m_id
    if o_r:
        overflow[o_r, o_a] = True
    if c_r:
        cpu_lane[c_r, c_l] = c_v
    return EncodedBatch(
        attrs_val=attrs_val,
        attrs_members=attrs_members,
        overflow=overflow,
        cpu_lane=cpu_lane,
        config_id=config_id,
        attr_bytes=attr_bytes,
        byte_ovf=byte_ovf,
        attrs_num=attrs_num,
        num_valid=num_valid,
        rel_rows=rel_rows,
    )


def _rel_slots_of_attr(policy: CompiledPolicy):
    """attr → [(slot, instance), ...] for the relation lane, cached on the
    policy (the slot registry is frozen at compile time)."""
    cached = getattr(policy, "_rel_slots_of_attr", None)
    if cached is not None:
        return cached
    out: dict = {}
    for slot, (attr, inst) in enumerate(policy.rel_slots or ()):
        out.setdefault(int(attr), []).append((slot, int(inst)))
    policy._rel_slots_of_attr = out  # type: ignore[attr-defined]
    return out
