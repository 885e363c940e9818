"""Pickle-free snapshot container: a compiled corpus as one self-verifying
blob, loadable without recompiling anything.  The container is the JAX
package's, byte for byte: a blob either package writes, the other reads.

Wire layout (all little-endian):

    MAGIC  "ATPUSNAP1\\0"
    u64    header length H
    H      JSON header — format version, meta (generation, per-config
           fingerprints, certified flag, translation-validation stats),
           the string-interner table, every JSON-safe policy field, and
           an array directory {name: {dtype, shape, offset, nbytes}}
    ...    raw C-contiguous array payload (offsets relative to its start)
    32     sha256 over EVERYTHING above — the load-time integrity gate

No pickle anywhere: the JSON header carries expression trees as plain
``{"p": [selector, op, value]}`` / ``{"all": [...]}`` / ``{"any": [...]}``
nodes and the loader reconstructs real Pattern/And/Or objects (re-running
their constructor validation), so a snapshot file can never smuggle code.
Integrity ≠ authorization: the sha256 detects corruption and truncation;
the header's ``certified`` meta flag is carried verbatim, and this module
never sets or checks it (the port has no strict verify or distribution
plane yet: ROADMAP queue 1)."""

from __future__ import annotations

import hashlib
import json
import re
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..compiler.compile import CompiledPolicy
from ..compiler.intern import StringInterner
from ..expressions.ast import And, Expression, InGroup, Operator, Or, Pattern
from ..relations.closure import RelationClosure

__all__ = ["serialize_policy", "deserialize_policy", "SnapshotFormatError",
           "expr_to_json", "expr_from_json"]

MAGIC = b"ATPUSNAP1\x00"
# version 1: the layout without the numeric and relation lanes.  Version
# 2 adds the numeric and relation operand lanes + the ovf_assist flag; it is emitted ONLY when a
# corpus actually uses them, so old blobs stay loadable and an old reader
# REJECTS (typed) a blob whose lanes it cannot evaluate instead of
# silently dropping them.
FORMAT_VERSION = 1
FORMAT_VERSION_RELATIONS = 2
_DIGEST_LEN = 32


class SnapshotFormatError(ValueError):
    """The blob is not a valid snapshot container (bad magic, truncated,
    checksum mismatch, or unsupported version).  Load-time only — the
    serving snapshot is never touched."""


# ---------------------------------------------------------------------------
# expression trees <-> JSON
# ---------------------------------------------------------------------------


def expr_to_json(expr: Expression,
                 relations: Optional[Dict[str, int]] = None,
                 rel_edges: Optional[List[Any]] = None) -> Any:
    if isinstance(expr, Pattern):
        return {"p": [expr.selector, expr.operator.value, expr.value]}
    if isinstance(expr, InGroup):
        # closures dedupe into a header-level edge-set table by digest;
        # the node carries only its index — standalone callers
        # (no registry) inline the edges
        if relations is None or rel_edges is None:
            return {"rel": [expr.selector, expr.group,
                            [list(e) for e in expr.relation.edges]]}
        idx = relations.get(expr.relation.digest)
        if idx is None:
            idx = relations[expr.relation.digest] = len(rel_edges)
            rel_edges.append([list(e) for e in expr.relation.edges])
        return {"rel": [expr.selector, expr.group, idx]}
    tag = "all" if isinstance(expr, And) else "any"
    return {tag: [expr_to_json(c, relations, rel_edges)
                  for c in expr.children]}


def expr_from_json(d: Any,
                   closures: Optional[List[RelationClosure]] = None,
                   ) -> Expression:
    if not isinstance(d, dict) or len(d) != 1:
        raise SnapshotFormatError(f"malformed expression node: {d!r}")
    if "p" in d:
        sel, op, value = d["p"]
        return Pattern(str(sel), Operator.from_string(str(op)), str(value))
    if "rel" in d:
        sel, group, ref = d["rel"]
        if isinstance(ref, list):
            closure = RelationClosure(ref)  # inline edges (standalone form)
        else:
            if closures is None or not (0 <= int(ref) < len(closures)):
                raise SnapshotFormatError(
                    f"relation node references closure {ref!r} outside the "
                    "header registry")
            closure = closures[int(ref)]
        return InGroup(str(sel), str(group), closure)
    if "all" in d:
        return And(tuple(expr_from_json(c, closures) for c in d["all"]))
    if "any" in d:
        return Or(tuple(expr_from_json(c, closures) for c in d["any"]))
    raise SnapshotFormatError(f"unknown expression node: {list(d)!r}")


# ---------------------------------------------------------------------------
# serialize
# ---------------------------------------------------------------------------

_ARRAY_FIELDS = (
    "leaf_op", "leaf_attr", "leaf_const", "eval_cond", "eval_rule",
    "eval_has_cond", "dfa_tables", "dfa_accept", "dfa_table_of_row",
    "dfa_leaf_attr", "leaf_dfa_row", "attr_byte_slot", "leaf_is_membership",
    "member_attr_slot", "member_attrs", "cpu_leaf_list", "config_cacheable",
)


def serialize_policy(policy: CompiledPolicy,
                     meta: Optional[Dict[str, Any]] = None) -> bytes:
    """One compiled corpus → one self-verifying blob.  ``meta`` lands in
    the header verbatim (generation, fingerprints, certified, entries)."""
    arrays: Dict[str, np.ndarray] = {
        name: getattr(policy, name) for name in _ARRAY_FIELDS}
    for i, (children, is_and) in enumerate(policy.levels):
        arrays[f"levels.{i}.children"] = children
        arrays[f"levels.{i}.is_and"] = is_and

    # numeric and relation lanes: arrays + host metadata ride the
    # container only when a corpus uses them (then the format version
    # bumps, so an older reader rejects typed instead of silently dropping
    # a lane)
    has_num = int(getattr(policy, "n_num_attrs", 0) or 0) > 0
    has_rel = int(getattr(policy, "n_rel_slots", 0) or 0) > 0
    has_assist = bool(getattr(policy, "ovf_assist", False))
    if has_num:
        arrays["num_attr_slot"] = policy.num_attr_slot
        arrays["num_attrs"] = policy.num_attrs
    if has_rel:
        arrays["rel_bits"] = policy.rel_bits
        arrays["leaf_rel_slot"] = policy.leaf_rel_slot
        arrays["leaf_rel_col"] = policy.leaf_rel_col
        arrays["rel_slot_attr"] = policy.rel_slot_attr

    directory: Dict[str, Dict[str, Any]] = {}
    payload = bytearray()
    for name, a in arrays.items():
        c = np.ascontiguousarray(a)
        directory[name] = {
            "dtype": c.dtype.str, "shape": list(c.shape),
            "offset": len(payload), "nbytes": int(c.nbytes),
        }
        payload += c.tobytes()

    # interner table: index IS the id (insertion-ordered dict, sequential
    # ids by construction — compiler/intern.py)
    interner_table = [None] * len(policy.interner)
    for s, i in policy.interner._table.items():
        interner_table[i] = s

    rel_registry: Dict[str, int] = {}
    rel_edges: List[Any] = []
    header = {
        "version": (FORMAT_VERSION_RELATIONS
                    if has_num or has_rel or has_assist else FORMAT_VERSION),
        "meta": meta or {},
        "n_levels": len(policy.levels),
        "n_byte_attrs": int(policy.n_byte_attrs),
        "members_k": int(policy.members_k),
        "n_member_attrs": int(policy.n_member_attrs),
        "n_cpu_leaves": int(policy.n_cpu_leaves),
        "interner": interner_table,
        "attr_selectors": list(policy.attr_selectors),
        "config_ids": dict(policy.config_ids),
        "config_attrs": [list(map(int, a)) for a in policy.config_attrs],
        "config_cpu_leaves": [list(map(int, a))
                              for a in policy.config_cpu_leaves],
        "leaf_regex": [rx.pattern if rx is not None else None
                       for rx in policy.leaf_regex],
        "leaf_tree": [expr_to_json(t, rel_registry, rel_edges)
                      if t is not None else None
                      for t in policy.leaf_tree],
        "config_exprs": [
            [[expr_to_json(cond, rel_registry, rel_edges)
              if cond is not None else None,
              expr_to_json(rule, rel_registry, rel_edges)]
             for cond, rule in evs]
            for evs in policy.config_exprs
        ],
        "arrays": directory,
    }
    if has_num or has_rel or has_assist:
        header["n_num_attrs"] = int(policy.n_num_attrs)
        header["n_rel_slots"] = int(policy.n_rel_slots)
        header["ovf_assist"] = bool(policy.ovf_assist)
        header["rel_slots"] = [list(map(int, s))
                               for s in (policy.rel_slots or ())]
        header["rel_col_names"] = [[int(i), str(g)]
                                   for i, g in (policy.rel_col_names or ())]
        header["rel_entity_rows"] = [
            {str(e): int(r) for e, r in m.items()}
            for m in (policy.rel_entity_rows or ())]
        header["rel_instances"] = [
            [list(e) for e in c.edges]
            for c in (policy.rel_instances or ())]
    if rel_edges:
        header["relations"] = rel_edges
    header_bytes = json.dumps(header, sort_keys=True,
                              separators=(",", ":")).encode("utf-8")
    body = MAGIC + struct.pack("<Q", len(header_bytes)) + header_bytes + payload
    return body + hashlib.sha256(body).digest()


# ---------------------------------------------------------------------------
# deserialize
# ---------------------------------------------------------------------------


def _read_header(blob: bytes) -> Tuple[Dict[str, Any], int]:
    if len(blob) < len(MAGIC) + 8 + _DIGEST_LEN:
        raise SnapshotFormatError("snapshot blob truncated")
    if blob[:len(MAGIC)] != MAGIC:
        raise SnapshotFormatError("bad snapshot magic")
    body, digest = blob[:-_DIGEST_LEN], blob[-_DIGEST_LEN:]
    if hashlib.sha256(body).digest() != digest:
        raise SnapshotFormatError("snapshot checksum mismatch (corrupt or "
                                  "tampered blob)")
    (hlen,) = struct.unpack_from("<Q", blob, len(MAGIC))
    start = len(MAGIC) + 8
    if start + hlen > len(body):
        raise SnapshotFormatError("snapshot header overruns the blob")
    try:
        header = json.loads(body[start:start + hlen].decode("utf-8"))
    except Exception as e:
        raise SnapshotFormatError(f"unparseable snapshot header: {e}")
    if header.get("version") not in (FORMAT_VERSION,
                                     FORMAT_VERSION_RELATIONS):
        raise SnapshotFormatError(
            f"unsupported snapshot format version {header.get('version')!r}")
    return header, start + hlen


def deserialize_policy(blob: bytes) -> Tuple[CompiledPolicy, Dict[str, Any]]:
    """Blob → (CompiledPolicy, header meta).  Pure deserialization: nothing
    is recompiled, no device is touched — the replica's whole point."""
    header, payload_off = _read_header(blob)
    payload = blob[payload_off:-_DIGEST_LEN]

    def arr(name: str) -> np.ndarray:
        spec = header["arrays"].get(name)
        if spec is None:
            raise SnapshotFormatError(f"snapshot missing array {name!r}")
        try:
            end = spec["offset"] + spec["nbytes"]
            if end > len(payload):
                raise SnapshotFormatError(
                    f"array {name!r} overruns the payload")
            a = np.frombuffer(payload[spec["offset"]:end],
                              dtype=np.dtype(spec["dtype"]))
            a = a.reshape(spec["shape"])
        except SnapshotFormatError:
            raise
        except Exception as e:
            # bad dtype strings, nbytes not a multiple of the itemsize,
            # shape mismatches — a checksum only proves the WRITER's bytes,
            # not that a (version-skewed or adversarial) writer wrote a
            # well-formed directory
            raise SnapshotFormatError(f"array {name!r} malformed: {e}")
        return np.array(a)  # explicit writable copy (frombuffer is RO)

    levels = tuple(
        (arr(f"levels.{i}.children"), arr(f"levels.{i}.is_and"))
        for i in range(int(header["n_levels"])))

    interner = StringInterner()
    table: Dict[str, int] = {}
    for i, s in enumerate(header["interner"]):
        table[str(s)] = i
    if table.get("") != 0:
        raise SnapshotFormatError("interner table must map \"\" to id 0")
    interner._table = table

    leaf_regex: List[Optional[re.Pattern]] = [
        re.compile(p) if p is not None else None
        for p in header["leaf_regex"]]
    # relation closures rebuild from the deduped edge-set registry (node
    # {"rel": [sel, group, idx]} references); digests recompute identically
    try:
        node_closures = [RelationClosure(e)
                         for e in header.get("relations") or ()]
        rel_instances = [RelationClosure(e)
                         for e in header.get("rel_instances") or ()]
    except Exception as e:
        raise SnapshotFormatError(f"malformed relation edge set: {e}")
    leaf_tree: List[Optional[Expression]] = [
        expr_from_json(t, node_closures) if t is not None else None
        for t in header["leaf_tree"]]
    config_exprs = [
        [(expr_from_json(c, node_closures) if c is not None else None,
          expr_from_json(r, node_closures))
         for c, r in evs]
        for evs in header["config_exprs"]]

    has_new = int(header.get("version", 1)) >= FORMAT_VERSION_RELATIONS
    n_num = int(header.get("n_num_attrs", 0) or 0) if has_new else 0
    n_rel = int(header.get("n_rel_slots", 0) or 0) if has_new else 0

    def arr_opt(name: str):
        return arr(name) if name in header["arrays"] else None

    policy = CompiledPolicy(
        leaf_op=arr("leaf_op"),
        leaf_attr=arr("leaf_attr"),
        leaf_const=arr("leaf_const"),
        levels=levels,
        eval_cond=arr("eval_cond"),
        eval_rule=arr("eval_rule"),
        eval_has_cond=arr("eval_has_cond"),
        dfa_tables=arr("dfa_tables"),
        dfa_accept=arr("dfa_accept"),
        dfa_table_of_row=arr("dfa_table_of_row"),
        dfa_leaf_attr=arr("dfa_leaf_attr"),
        leaf_dfa_row=arr("leaf_dfa_row"),
        attr_byte_slot=arr("attr_byte_slot"),
        n_byte_attrs=int(header["n_byte_attrs"]),
        interner=interner,
        attr_selectors=[str(s) for s in header["attr_selectors"]],
        config_ids={str(k): int(v)
                    for k, v in header["config_ids"].items()},
        config_attrs=[list(map(int, a)) for a in header["config_attrs"]],
        config_cpu_leaves=[list(map(int, a))
                           for a in header["config_cpu_leaves"]],
        leaf_regex=leaf_regex,
        leaf_tree=leaf_tree,
        leaf_is_membership=arr("leaf_is_membership"),
        members_k=int(header["members_k"]),
        member_attr_slot=arr("member_attr_slot"),
        member_attrs=arr("member_attrs"),
        n_member_attrs=int(header["n_member_attrs"]),
        cpu_leaf_list=arr("cpu_leaf_list"),
        n_cpu_leaves=int(header["n_cpu_leaves"]),
        config_exprs=config_exprs,
        config_cacheable=arr("config_cacheable"),
        num_attr_slot=arr_opt("num_attr_slot"),
        num_attrs=arr_opt("num_attrs"),
        n_num_attrs=n_num,
        rel_bits=arr_opt("rel_bits"),
        leaf_rel_slot=arr_opt("leaf_rel_slot"),
        leaf_rel_col=arr_opt("leaf_rel_col"),
        rel_slot_attr=arr_opt("rel_slot_attr"),
        n_rel_slots=n_rel,
        rel_instances=rel_instances,
        rel_entity_rows=[{str(e): int(r) for e, r in m.items()}
                         for m in (header.get("rel_entity_rows") or ())],
        rel_slots=[tuple(map(int, s))
                   for s in (header.get("rel_slots") or ())],
        rel_col_names=[(int(i), str(g))
                       for i, g in (header.get("rel_col_names") or ())],
        ovf_assist=bool(header.get("ovf_assist", False)),
    )
    return policy, dict(header.get("meta") or {})
