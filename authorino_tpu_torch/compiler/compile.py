"""Rule compiler: lower pattern-expression trees across all AuthConfigs into
dense tensor operands for the batched device kernel.

This is the device-era analog of the reference's reconcile-time OPA precompile
(ref: pkg/evaluators/authorization/opa.go:141): all compilation cost is paid
once per corpus change, never per request.

Lowering model
--------------
All expressions from all configs share one flat *result buffer* per request:

  slot 0           constant TRUE   (empty And — ref pkg/jsonexp/expressions.go:111)
  slot 1           constant FALSE  (empty Or  — ref :136)
  slots 2..2+L     leaf pattern results (deduped globally by (attr, op, const))
  slots 2+L..      internal And/Or nodes, grouped by tree depth

Each And/Or node stores child *buffer indices*; children always live at
earlier buffer positions, so the kernel evaluates level-by-level with static
shapes.  And-rows pad with slot 0 (identity of ∧), Or-rows with slot 1.

Per config, each authorization evaluator contributes a (condition, rule)
pair of buffer indices; the verdict is

  verdict[cfg] = ∧ over evaluators of (¬cond ∨ rule)       # skipped ⇒ pass
                                            (ref: pkg/service/auth_pipeline.go:120-125,
                                             307-318 — all-must-pass, conditions gate)

Regex (`matches`) leaves and incl/excl membership overflow are routed through
a CPU lane: the encoder supplies exact per-(request, leaf) booleans and the
kernel selects them by op code / overflow mask (SURVEY.md §7 "hard parts").
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..expressions.ast import (
    NUMERIC_OPERATORS,
    And,
    Expression,
    InGroup,
    Operator,
    Or,
    Pattern,
)
from ..relations.closure import RelationClosure
from .intern import PAD, StringInterner

__all__ = [
    "OP_EQ", "OP_NEQ", "OP_INCL", "OP_EXCL", "OP_CPU", "OP_ERROR", "OP_TREE_CPU",
    "OP_REGEX_DFA", "OP_NUM_GT", "OP_NUM_GE", "OP_NUM_LT", "OP_NUM_LE",
    "OP_RELATION", "NUMERIC_OPS",
    "ConfigRules", "CompiledPolicy", "ShapeTargets", "compile_corpus",
    "TRUE_SLOT", "FALSE_SLOT", "DFA_VALUE_BYTES",
]

OP_EQ, OP_NEQ, OP_INCL, OP_EXCL, OP_CPU, OP_ERROR, OP_TREE_CPU, OP_REGEX_DFA = (
    0, 1, 2, 3, 4, 5, 6, 7,
)
# numeric comparator lane + compiled relation tables
OP_NUM_GT, OP_NUM_GE, OP_NUM_LT, OP_NUM_LE, OP_RELATION = 8, 9, 10, 11, 12

NUMERIC_OPS = (OP_NUM_GT, OP_NUM_GE, OP_NUM_LT, OP_NUM_LE)

_NUM_OP_OF = {
    Operator.GT: OP_NUM_GT,
    Operator.GE: OP_NUM_GE,
    Operator.LT: OP_NUM_LT,
    Operator.LE: OP_NUM_LE,
}

# max value length evaluated on the device regex lane; longer values (or
# values containing NUL) fall back to the CPU regex lane per request — an
# exactness-preserving overflow, so this is purely a transfer/compute vs
# fallback-rate dial.  The byte tensor is [B, NB, DFA_VALUE_BYTES] on the
# wire, the single biggest payload when regexes are present; 64 covers
# typical URL paths/headers with headroom.
DFA_VALUE_BYTES = int(os.environ.get("AUTHORINO_TPU_DFA_VALUE_BYTES", "64"))

TRUE_SLOT = 0
FALSE_SLOT = 1
_LEAF_BASE = 2
_DFA_MISS = object()

# Selectors whose value is unique per request or time-dependent: rows of
# configs referencing them (almost) never repeat on the wire, so caching
# their verdicts only evicts useful entries from the snapshot-scoped verdict
# cache.  Correctness NEVER depends on this bit — the cache key is the full
# encoded operand digest (runtime/engine.py, runtime/native_frontend.py);
# this is purely a cache-pollution dial.
_UNCACHEABLE_SELECTOR_PREFIXES = (
    "request.id",
    "request.time",
    "context.request.time",
    "context.request.http.id",
)


def _selector_uncacheable(selector_str: str) -> bool:
    head = selector_str.split("|", 1)[0].split("#", 1)[0].strip()
    return any(head == p or head.startswith(p + ".")
               for p in _UNCACHEABLE_SELECTOR_PREFIXES)


@dataclass
class ShapeTargets:
    """Forced operand shapes so independently-compiled sub-corpora (one per
    tensor-parallel shard) stack into a single leading-axis array with
    identical buffer layouts (parallel/sharded_eval.py)."""

    n_leaves: int                      # padded L
    n_attrs: int                       # padded A
    max_e: int                         # evaluator columns
    levels: Tuple[Tuple[int, int], ...]  # per level: (rows, children width)
    n_member_attrs: int = 1            # compact membership rows (M)
    n_cpu_leaves: int = 1              # dense CPU-lane columns (C)
    # device regex lane: DFA row/state/byte-slot axes must also stack across
    # shards.  n_byte_attrs > 0 in the union forces every shard to carry a
    # (possibly dummy) DFA lane so the stacked param structure is uniform.
    n_dfa_rows: int = 1
    n_dfa_states: int = 1
    n_byte_attrs: int = 0
    # unique DFA transition tables (rows sharing a determinized automaton
    # point at one table through dfa_table_of_row — rule-tensor compaction)
    n_dfa_tables: int = 1
    # eval-table rows (configs per shard) — unified so per-shard device
    # pytrees (incl. the matmul lane's [G*E, cursor] one-hots) stack
    n_configs: int = 1
    # numeric comparator lane: compact [B, NN] int32 value slots.
    # 0 = no lane anywhere in the union (structural, like n_byte_attrs)
    n_num_attrs: int = 0
    # compiled relation tables: [Rp, W] bitmatrix rows/width and
    # the [B, NR] entity-row operand slots.  n_rel_slots == 0 = no lane
    n_rel_slots: int = 0
    n_rel_rows: int = 1
    n_rel_width: int = 1

    @staticmethod
    def union(shapes: Sequence["ShapeTargets"]) -> "ShapeTargets":
        n_levels = max((len(s.levels) for s in shapes), default=0)
        levels = []
        for l in range(n_levels):
            rows = max((s.levels[l][0] for s in shapes if l < len(s.levels)), default=1)
            width = max((s.levels[l][1] for s in shapes if l < len(s.levels)), default=1)
            levels.append((rows, width))
        return ShapeTargets(
            n_leaves=max(s.n_leaves for s in shapes),
            n_attrs=max(s.n_attrs for s in shapes),
            max_e=max(s.max_e for s in shapes),
            levels=tuple(levels),
            n_member_attrs=max(s.n_member_attrs for s in shapes),
            n_cpu_leaves=max(s.n_cpu_leaves for s in shapes),
            n_dfa_rows=max(s.n_dfa_rows for s in shapes),
            n_dfa_states=max(s.n_dfa_states for s in shapes),
            n_byte_attrs=max(s.n_byte_attrs for s in shapes),
            n_dfa_tables=max(s.n_dfa_tables for s in shapes),
            n_configs=max(s.n_configs for s in shapes),
            n_num_attrs=max(s.n_num_attrs for s in shapes),
            n_rel_slots=max(s.n_rel_slots for s in shapes),
            n_rel_rows=max(s.n_rel_rows for s in shapes),
            n_rel_width=max(s.n_rel_width for s in shapes),
        )


@dataclass
class ConfigRules:
    """One AuthConfig's compilable authorization surface: a list of
    (conditions, rules) expression pairs — one per pattern-matching
    authorization evaluator (conditions may be None)."""

    name: str
    evaluators: List[Tuple[Optional[Expression], Expression]] = field(default_factory=list)


@dataclass
class _Leaf:
    op: int
    attr: int
    const: int
    regex: Optional[str] = None  # for CPU lane
    tree: Optional[Expression] = None  # for OP_TREE_CPU whole-tree fallback
    rel: Optional[RelationClosure] = None  # for OP_RELATION
    group: Optional[str] = None            # for OP_RELATION


def _has_invalid_regex(expr: Expression) -> bool:
    """A leaf whose evaluation can only ERROR (invalid regex, unfoldable
    numeric constant): the containing tree keeps the reference's error
    short-circuit semantics via the whole-tree CPU fallback.  The name
    predates the numeric lane; it now covers every invalid-leaf kind."""
    if isinstance(expr, Pattern):
        if expr.operator is Operator.MATCHES:
            return getattr(expr, "_regex", None) is None
        if expr.operator in NUMERIC_OPERATORS:
            return getattr(expr, "_num_const", None) is None
        return False
    if isinstance(expr, InGroup):
        return False
    return any(_has_invalid_regex(c) for c in expr.children)


@dataclass
class CompiledPolicy:
    """Dense device operands + CPU-side metadata for one compiled corpus."""

    # --- device operands (numpy here; moved to device by the engine) ---
    leaf_op: np.ndarray        # [L] int32
    leaf_attr: np.ndarray      # [L] int32
    leaf_const: np.ndarray     # [L] int32
    levels: Tuple[Tuple[np.ndarray, np.ndarray], ...]  # per level: (children [N,C] i32, is_and [N] bool)
    eval_cond: np.ndarray      # [G, E] int32 buffer idx (TRUE_SLOT when absent)
    eval_rule: np.ndarray      # [G, E] int32 buffer idx
    eval_has_cond: np.ndarray  # [G, E] bool

    # --- device regex lane (empty arrays when no DFA-compilable regexes) ---
    # transition tables are stored DEDUPED: rows whose regexes determinize to
    # the same automaton (same pattern on different attrs, or structurally
    # identical patterns across AuthConfigs) share one [S, 256] table and
    # point at it through dfa_table_of_row — rule-tensor compaction that
    # shrinks both the device corpus upload and per-snapshot host memory
    dfa_tables: np.ndarray     # [T, S, 256] uint8 — UNIQUE transition tables
    dfa_accept: np.ndarray     # [T, S] bool
    dfa_table_of_row: np.ndarray  # [R] int32 — dfa row → unique table
    dfa_leaf_attr: np.ndarray  # [R] int32 — attr idx of each dfa row
    leaf_dfa_row: np.ndarray   # [L] int32 — leaf → dfa row (0 for others)
    attr_byte_slot: np.ndarray  # [A] int32 — attr → byte-tensor slot (-1 none)
    n_byte_attrs: int

    # --- CPU-side metadata ---
    interner: StringInterner
    attr_selectors: List[str]            # attr idx -> selector string
    config_ids: Dict[str, int]           # config name -> row in eval_* tables
    config_attrs: List[List[int]]        # per config: attr idxs to resolve
    config_cpu_leaves: List[List[int]]   # per config: leaf idxs needing CPU lane
    leaf_regex: List[Optional["re.Pattern"]]  # per leaf: compiled regex or None
    leaf_tree: List[Optional[Expression]]     # per leaf: whole-tree CPU fallback
    leaf_is_membership: np.ndarray       # [L] bool — incl/excl (overflow-capable)
    members_k: int                       # K: membership vector width

    # --- transfer-compaction metadata (see compiler/pack.py) ---
    # attr → row in the compact [B, M, K] membership tensor (-1: attr has no
    # incl/excl leaf and its members are never read by the kernel)
    member_attr_slot: np.ndarray         # [A] int32
    member_attrs: np.ndarray             # [M_real] int32 (attrs with slot >= 0)
    n_member_attrs: int                  # M (padded >= 1)
    # leaves whose value rides the dense CPU lane: op CPU/TREE_CPU always,
    # plus REGEX_DFA (column read only under byte-overflow)
    cpu_leaf_list: np.ndarray            # [C_real] int32 leaf idxs
    n_cpu_leaves: int                    # C (padded >= 1)
    # original expressions per config evaluator — the host-fallback oracle
    # for requests the compact encoding cannot represent (membership overflow)
    config_exprs: List[List[Tuple[Optional[Expression], Expression]]]

    # per-config verdict-cache eligibility: False for configs whose rules
    # reference request-unique/time-dependent selectors (their rows never
    # repeat, so caching them only evicts useful entries).  Correctness
    # never depends on it — cache keys are full encoded-row digests.
    config_cacheable: np.ndarray = None  # [G] bool

    # --- numeric comparator lane (empty when no numeric leaf) ---
    # attr → compact numeric-value slot (-1: attr has no numeric leaf)
    num_attr_slot: np.ndarray = None     # [A] int32
    num_attrs: np.ndarray = None         # [NN_real] int32
    n_num_attrs: int = 0                 # NN (padded; 0 = no lane)

    # --- compiled relation tables (empty when no InGroup leaf) --
    # the per-snapshot ancestor-closure bitmatrix: row = (relation
    # instance, entity), col = (relation instance, queried group); row 0 is
    # the reserved all-zero row unknown entities resolve to.  Bit order is
    # LITTLE within each byte (bit j of byte k = column k*8+j).
    rel_bits: np.ndarray = None          # [Rp, W] uint8
    leaf_rel_slot: np.ndarray = None     # [L] int32 (slot in rel_rows; 0 dflt)
    leaf_rel_col: np.ndarray = None      # [L] int32 (column; 0 default)
    rel_slot_attr: np.ndarray = None     # [NRp] int32 (attr of each slot)
    n_rel_slots: int = 0                 # NR (padded; 0 = no lane)
    # host metadata: closure instances (deduped by digest), per-instance
    # entity → global row map, per-slot (attr, instance), per-col
    # (instance, group) — the encoder's and certifier's view of the lane
    rel_instances: List[RelationClosure] = None
    rel_entity_rows: List[Dict[str, int]] = None
    rel_slots: List[Tuple[int, int]] = None
    rel_col_names: List[Tuple[int, str]] = None

    # membership-overflow in-kernel assist: when True the
    # encoder's exact per-leaf overflow answers ride dense CPU-lane columns
    # and the kernel selects them under the [B, M] member_ovf mask —
    # overflow rows stay on the device lane instead of host_fallback
    ovf_assist: bool = False

    # --- fused mega-kernel layout ---
    # Derived deterministically in __post_init__ (so deserialized snapshots
    # rebuild byte-identical layouts without a format bump) but STORED as
    # fields: the fused lane's operand build consumes them directly, and the
    # tensor lint + translation certifier audit them against their sources —
    # a corrupted layout is a real miscompile, not a stale cache.
    # dfa rows re-keyed for contiguous gathers: stable argsort by owning
    # table, so per-byte transition gathers walk the deduped table axis
    # sequentially instead of hopping through the compile-order row map
    dfa_row_perm: np.ndarray = None      # [R] int32 (bijection over rows)
    leaf_op_i8: np.ndarray = None        # [L] int8 packed op codes (ops < 2^7)
    fused_pack_w: int = 0                # in-kernel bitpack width, packed_width(1+2E)

    def __post_init__(self) -> None:
        if self.dfa_row_perm is None and self.dfa_table_of_row is not None:
            self.dfa_row_perm = np.argsort(
                self.dfa_table_of_row, kind="stable").astype(np.int32)
        if self.leaf_op_i8 is None and self.leaf_op is not None:
            self.leaf_op_i8 = self.leaf_op.astype(np.int8)
        if not self.fused_pack_w and self.eval_rule is not None:
            self.fused_pack_w = (1 + 2 * int(self.eval_rule.shape[1]) + 7) // 8

    def rule_sources(self) -> List[List[str]]:
        """Decision provenance: per config row, the source string
        of each evaluator's rule expression — the rule-index → (authconfig,
        rule-source) map the observability layer attributes denials with.
        Derived from ``config_exprs`` (which the snapshot serializer
        round-trips, so replicas attribute identically to the compiling
        leader); memoized on first use — one walk per compiled corpus,
        never per request."""
        memo = getattr(self, "_rule_sources", None)
        if memo is None:
            memo = [[str(rule) for _cond, rule in evs]
                    for evs in self.config_exprs]
            object.__setattr__(self, "_rule_sources", memo)
        return memo

    def provenance_map(self) -> Dict[str, Dict[str, Any]]:
        """JSON-safe {config name: {"row", "rules": [source, ...]}} view of
        rule_sources (the /debug/vars + analysis-CLI shape)."""
        srcs = self.rule_sources()
        return {name: {"row": row, "rules": list(srcs[row])}
                for name, row in self.config_ids.items()}

    @property
    def dfa_tables_by_row(self) -> np.ndarray:
        """Transition tables expanded back to the per-row axis [R, S, 256]
        (consumers that index by dfa row host-side: the matmul-lane operand
        build and the native C++ encoder)."""
        return self.dfa_tables[self.dfa_table_of_row]

    @property
    def dfa_accept_by_row(self) -> np.ndarray:
        return self.dfa_accept[self.dfa_table_of_row]

    @property
    def n_leaves(self) -> int:
        return int(self.leaf_op.shape[0])

    @property
    def n_attrs(self) -> int:
        return len(self.attr_selectors)

    @property
    def n_configs(self) -> int:
        return int(self.eval_rule.shape[0])

    @property
    def buffer_size(self) -> int:
        return _LEAF_BASE + self.n_leaves + sum(lv[0].shape[0] for lv in self.levels)

    def shape_key(self) -> tuple:
        """Everything jit specializes on — used to bound recompiles."""
        return (
            self.n_leaves,
            self.n_attrs,
            self.members_k,
            self.n_member_attrs,
            self.n_cpu_leaves,
            tuple((lv[0].shape, ) for lv in self.levels),
            self.eval_rule.shape,
            self.n_num_attrs,
            self.n_rel_slots,
            tuple(self.rel_bits.shape) if self.rel_bits is not None else (),
            bool(self.ovf_assist),
        )

    def shape_targets(self) -> ShapeTargets:
        return ShapeTargets(
            n_leaves=self.n_leaves,
            n_attrs=len(self.attr_selectors),
            max_e=int(self.eval_rule.shape[1]),
            levels=tuple((int(c.shape[0]), int(c.shape[1])) for c, _ in self.levels),
            n_member_attrs=self.n_member_attrs,
            n_cpu_leaves=self.n_cpu_leaves,
            n_dfa_rows=int(self.dfa_table_of_row.shape[0]),
            n_dfa_states=int(self.dfa_tables.shape[1]),
            n_byte_attrs=self.n_byte_attrs,
            n_dfa_tables=int(self.dfa_tables.shape[0]),
            n_configs=self.n_configs,
            n_num_attrs=self.n_num_attrs,
            n_rel_slots=self.n_rel_slots,
            n_rel_rows=int(self.rel_bits.shape[0])
            if self.rel_bits is not None else 1,
            n_rel_width=int(self.rel_bits.shape[1])
            if self.rel_bits is not None else 1,
        )


def _round_up(n: int, multiple: int = 8, minimum: int = 8) -> int:
    """Pad to the next power-of-two-ish bucket so shape changes (and thus XLA
    recompiles) are logarithmic in corpus growth (SURVEY.md §7 bucketing)."""
    n = max(n, minimum)
    bucket = minimum
    while bucket < n:
        bucket *= 2
    return bucket


class _Lowerer:
    def __init__(self, interner: StringInterner, members_k: int, enable_dfa: bool = True,
                 dfa_cache: Optional[Dict[str, Optional["object"]]] = None):
        self.interner = interner
        self.members_k = members_k
        self.enable_dfa = enable_dfa
        self.attrs: Dict[str, int] = {}
        self.leaves: List[_Leaf] = []
        self.leaf_dedupe: Dict[Tuple[int, int, int, Optional[str]], int] = {}
        # nodes: (depth, is_and, children buffer idxs)
        self.nodes: List[Tuple[int, bool, List[int]]] = []
        self.depth_of: Dict[int, int] = {TRUE_SLOT: 0, FALSE_SLOT: 0}
        self.tree_leaf_by_expr: Dict[int, int] = {}
        # structural And/Or node dedup across ALL configs: two configs
        # lowering the identical subtree share one node row (and thus one
        # result-buffer slot), shrinking the per-level matrices and the
        # whole padded buffer — rule-tensor compaction at the circuit level
        self.node_dedupe: Dict[Tuple[bool, Tuple[int, ...]], int] = {}
        # regex determinization is the most expensive part of compilation;
        # a caller-shared cache lets the sharded model's two-pass compile
        # (and all its shards) determinize each distinct regex once
        self._dfa_cache: Dict[str, Optional["object"]] = (
            dfa_cache if dfa_cache is not None else {}
        )

    def _dfa_for(self, pattern: str):
        hit = self._dfa_cache.get(pattern, _DFA_MISS)
        if hit is not _DFA_MISS:
            return hit
        from .redfa import compile_regex_dfa

        dfa = compile_regex_dfa(pattern)
        self._dfa_cache[pattern] = dfa
        return dfa

    def attr_idx(self, selector: str) -> int:
        i = self.attrs.get(selector)
        if i is None:
            i = len(self.attrs)
            self.attrs[selector] = i
        return i

    def lower_relation_leaf(self, g: InGroup) -> int:
        """Hierarchical-membership leaf: one atom per (selector, closure,
        group), deduped across configs — configs declaring identical edge
        sets share one compiled relation table (closure digest identity)."""
        attr = self.attr_idx(g.selector)
        key = (OP_RELATION, attr, 0, f"{g.relation.digest}:{g.group}")
        idx = self.leaf_dedupe.get(key)
        if idx is None:
            idx = len(self.leaves)
            self.leaves.append(_Leaf(op=OP_RELATION, attr=attr, const=0,
                                     rel=g.relation, group=g.group))
            self.leaf_dedupe[key] = idx
        buf = _LEAF_BASE + idx
        self.depth_of[buf] = 0
        return buf

    def lower_leaf(self, p: Pattern) -> int:
        attr = self.attr_idx(p.selector)
        if p.operator in NUMERIC_OPERATORS:
            # constant folded + int32-bounded at Pattern construction;
            # unfoldable constants never reach here (_has_invalid_regex
            # routes the whole tree to the CPU oracle)
            key = (_NUM_OP_OF[p.operator], attr,
                   int(p._num_const), None)  # type: ignore[attr-defined]
            idx = self.leaf_dedupe.get(key)
            if idx is None:
                idx = len(self.leaves)
                self.leaves.append(
                    _Leaf(op=key[0], attr=attr, const=key[2]))
                self.leaf_dedupe[key] = idx
            buf = _LEAF_BASE + idx
            self.depth_of[buf] = 0
            return buf
        if p.operator is Operator.MATCHES:
            rx = getattr(p, "_regex", None)
            if rx is None:
                # invalid regex: evaluation errors deny in the reference
                # (error return from Pattern.Matches → deny); constant-false
                key = (OP_ERROR, attr, 0, p.value)
            elif self.enable_dfa and self._dfa_for(p.value) is not None:
                key = (OP_REGEX_DFA, attr, 0, p.value)
            else:
                key = (OP_CPU, attr, 0, p.value)
        else:
            op = {
                Operator.EQ: OP_EQ,
                Operator.NEQ: OP_NEQ,
                Operator.INCL: OP_INCL,
                Operator.EXCL: OP_EXCL,
            }[p.operator]
            key = (op, attr, self.interner.intern(p.value), None)
        idx = self.leaf_dedupe.get(key)
        if idx is None:
            idx = len(self.leaves)
            self.leaves.append(_Leaf(op=key[0], attr=key[1], const=key[2], regex=key[3]))
            self.leaf_dedupe[key] = idx
        buf = _LEAF_BASE + idx
        self.depth_of[buf] = 0
        return buf

    def lower_tree_cpu(self, expr: Expression) -> int:
        """Whole-tree CPU-fallback leaf: used when a tree contains an invalid
        regex, whose error must propagate with the reference's left-to-right
        short-circuit semantics (error ⇒ deny for rules, ⇒ skip for
        conditions; both read as False at the tree root —
        ref pkg/jsonexp/expressions.go:87-91,111-154).  Un-tensorizable, so
        the encoder evaluates the expression with the CPU oracle."""
        idx = len(self.leaves)
        self.leaves.append(_Leaf(op=OP_TREE_CPU, attr=0, const=0, tree=expr))
        self.tree_leaf_by_expr[id(expr)] = idx
        buf = _LEAF_BASE + idx
        self.depth_of[buf] = 0
        return buf

    def lower(self, expr: Expression) -> int:
        """Return the buffer index holding this expression's result."""
        if _has_invalid_regex(expr):
            return self.lower_tree_cpu(expr)
        if isinstance(expr, Pattern):
            return self.lower_leaf(expr)
        if isinstance(expr, InGroup):
            return self.lower_relation_leaf(expr)
        is_and = isinstance(expr, And)
        children = [self.lower(c) for c in expr.children]
        if not children:
            return TRUE_SLOT if is_and else FALSE_SLOT
        if len(children) == 1:
            return children[0]
        dedupe_key = (is_and, tuple(children))
        hit = self.node_dedupe.get(dedupe_key)
        if hit is not None:
            return hit
        depth = 1 + max(self.depth_of[c] for c in children)
        node_id = len(self.nodes)
        self.nodes.append((depth, is_and, children))
        # buffer position assigned later (after level grouping); use a
        # placeholder key: negative ids -(node_id+1)
        self.depth_of[-(node_id + 1)] = depth
        self.node_dedupe[dedupe_key] = -(node_id + 1)
        return -(node_id + 1)


def compile_corpus(
    configs: Sequence[ConfigRules],
    members_k: int = 16,
    pad: bool = True,
    targets: Optional[ShapeTargets] = None,
    interner: Optional[StringInterner] = None,
    enable_dfa: bool = True,
    dfa_cache: Optional[Dict[str, Any]] = None,
    ovf_assist: Optional[bool] = None,
) -> CompiledPolicy:
    """Compile all configs' pattern rules into one CompiledPolicy.

    ``targets`` forces final operand shapes — including the DFA row/state/
    byte axes, so tensor-parallel shards stack uniformly (must dominate the
    natural shapes); ``interner`` lets shards share one global string table;
    ``enable_dfa=False`` routes all regexes to the CPU lane (tests and manual
    fallback — the sharded model rides the device DFA lane by default).

    ``ovf_assist`` (default off, env AUTHORINO_TPU_OVF_ASSIST=1)
    keeps membership-overflow rows on the device lane: incl/excl leaves gain
    dense CPU-assist columns carrying the encoder's exact per-leaf overflow
    answers and the kernel selects them under the [B, M] overflow mask —
    the cpu-grid-overflow lowerability caveat drops for assisted corpora.
    Off by default so the host-fallback lane (the degrade backstop) keeps
    its full test surface."""
    if ovf_assist is None:
        ovf_assist = os.environ.get(
            "AUTHORINO_TPU_OVF_ASSIST", "") in ("1", "true", "yes")
    interner = interner if interner is not None else StringInterner()
    lw = _Lowerer(interner, members_k, enable_dfa=enable_dfa, dfa_cache=dfa_cache)

    # 1. lower every expression; remember (cond_ref, rule_ref) per evaluator
    per_config: List[Tuple[str, List[Tuple[Optional[int], int]]]] = []
    for cfg in configs:
        pairs: List[Tuple[Optional[int], int]] = []
        for cond, rule in cfg.evaluators:
            cond_ref = lw.lower(cond) if cond is not None else None
            rule_ref = lw.lower(rule)
            pairs.append((cond_ref, rule_ref))
        per_config.append((cfg.name, pairs))

    # 2. assign buffer positions: leaves first, then nodes grouped by depth.
    # Node positions must account for leaf AND level-row PADDING — the
    # kernel's result buffer holds the padded leaf block, then each padded
    # level's rows, in order.
    n_leaves = len(lw.leaves)
    Lp = _round_up(n_leaves) if pad else max(n_leaves, 1)
    if targets is not None:
        assert targets.n_leaves >= n_leaves, "targets.n_leaves too small"
        Lp = targets.n_leaves
    by_depth: Dict[int, List[int]] = {}
    for node_id, (depth, _, _) in enumerate(lw.nodes):
        by_depth.setdefault(depth, []).append(node_id)
    levels_raw: List[List[int]] = [by_depth[d] for d in sorted(by_depth)]
    n_levels = len(levels_raw)
    if targets is not None:
        assert len(targets.levels) >= n_levels, "targets.levels too shallow"
        n_levels = len(targets.levels)
        levels_raw += [[] for _ in range(n_levels - len(levels_raw))]

    def level_rows(l: int) -> int:
        natural = len(levels_raw[l])
        if targets is not None:
            assert targets.levels[l][0] >= natural, "targets level rows too small"
            return targets.levels[l][0]
        return natural

    node_pos: Dict[int, int] = {}
    cursor = _LEAF_BASE + Lp
    for l, level_nodes in enumerate(levels_raw):
        for row, node_id in enumerate(level_nodes):
            node_pos[node_id] = cursor + row
        cursor += level_rows(l)

    def ref_to_buf(ref: int) -> int:
        # negative refs encode node placeholders -(node_id+1); others are
        # already buffer positions (TRUE/FALSE slots or leaves)
        if ref < 0:
            return node_pos[-ref - 1]
        return ref

    # 3. build level tensors (padded rows evaluate And() ≡ True, harmless)
    levels: List[Tuple[np.ndarray, np.ndarray]] = []
    for l, level_nodes in enumerate(levels_raw):
        max_c = max((len(lw.nodes[nid][2]) for nid in level_nodes), default=1)
        if targets is not None:
            assert targets.levels[l][1] >= max_c, "targets level width too small"
            max_c = targets.levels[l][1]
        rows = level_rows(l)
        children = np.full((rows, max_c), TRUE_SLOT, dtype=np.int32)
        is_and = np.ones((rows,), dtype=bool)
        for row, nid in enumerate(level_nodes):
            _, node_is_and, kids = lw.nodes[nid]
            is_and[row] = node_is_and
            padv = TRUE_SLOT if node_is_and else FALSE_SLOT
            buf_kids = [ref_to_buf(k) for k in kids]
            children[row, : len(buf_kids)] = buf_kids
            children[row, len(buf_kids):] = padv
        levels.append((children, is_and))

    # 4. per-config evaluator tables.  Targets pad the row count so shards
    # stack; padded rows are all-TRUE_SLOT — trivially-allow configs that no
    # request can ever select (row ids only cover the real configs).
    n_configs = len(per_config)
    Gp = n_configs
    if targets is not None:
        assert targets.n_configs >= n_configs, "targets.n_configs too small"
        Gp = targets.n_configs
    max_e = max((len(p[1]) for p in per_config), default=1) or 1
    if targets is not None:
        assert targets.max_e >= max_e, "targets.max_e too small"
        max_e = targets.max_e
    elif pad:
        max_e = _round_up(max_e, minimum=2)
    eval_cond = np.full((Gp, max_e), TRUE_SLOT, dtype=np.int32)
    eval_rule = np.full((Gp, max_e), TRUE_SLOT, dtype=np.int32)
    eval_has_cond = np.zeros((Gp, max_e), dtype=bool)
    config_ids: Dict[str, int] = {}
    for row, (name, pairs) in enumerate(per_config):
        config_ids[name] = row
        for col, (cond_ref, rule_ref) in enumerate(pairs):
            if cond_ref is not None:
                eval_cond[row, col] = ref_to_buf(cond_ref)
                eval_has_cond[row, col] = True
            eval_rule[row, col] = ref_to_buf(rule_ref)

    # 5. leaf tensors (padded to the bucket chosen in step 2)
    leaf_op = np.full((Lp,), OP_EQ, dtype=np.int32)
    leaf_attr = np.zeros((Lp,), dtype=np.int32)
    leaf_const = np.full((Lp,), PAD, dtype=np.int32)  # PAD const: matches nothing
    leaf_regex: List[Optional[re.Pattern]] = [None] * Lp
    leaf_tree: List[Optional[Expression]] = [None] * Lp
    leaf_is_membership = np.zeros((Lp,), dtype=bool)
    leaf_dfa_row = np.zeros((Lp,), dtype=np.int32)
    dfa_rows: List[Tuple[int, Any]] = []  # (attr, DFA) per device-regex leaf
    # relation lane registry: closure instances deduped by
    # digest, (attr, instance) operand slots, (instance, group) columns
    leaf_rel_slot = np.zeros((Lp,), dtype=np.int32)
    leaf_rel_col = np.zeros((Lp,), dtype=np.int32)
    rel_instances: List[RelationClosure] = []
    rel_inst_idx: Dict[str, int] = {}
    rel_slot_idx: Dict[Tuple[int, int], int] = {}
    rel_slots_list: List[Tuple[int, int]] = []
    rel_col_idx: Dict[Tuple[int, str], int] = {}
    rel_col_names_list: List[Tuple[int, str]] = []
    for i, leaf in enumerate(lw.leaves):
        leaf_op[i] = leaf.op
        leaf_attr[i] = leaf.attr
        leaf_const[i] = leaf.const
        leaf_is_membership[i] = leaf.op in (OP_INCL, OP_EXCL)
        if leaf.op in (OP_CPU, OP_REGEX_DFA) and leaf.regex is not None:
            leaf_regex[i] = re.compile(leaf.regex)  # CPU lane / overflow fallback
        if leaf.op == OP_REGEX_DFA:
            leaf_dfa_row[i] = len(dfa_rows)
            dfa_rows.append((leaf.attr, lw._dfa_for(leaf.regex)))
        if leaf.op == OP_TREE_CPU:
            leaf_tree[i] = leaf.tree
        if leaf.op == OP_RELATION:
            inst = rel_inst_idx.get(leaf.rel.digest)
            if inst is None:
                inst = rel_inst_idx[leaf.rel.digest] = len(rel_instances)
                rel_instances.append(leaf.rel)
            slot = rel_slot_idx.get((leaf.attr, inst))
            if slot is None:
                slot = rel_slot_idx[(leaf.attr, inst)] = len(rel_slots_list)
                rel_slots_list.append((leaf.attr, inst))
            col = rel_col_idx.get((inst, leaf.group))
            if col is None:
                col = rel_col_idx[(inst, leaf.group)] = len(rel_col_names_list)
                rel_col_names_list.append((inst, leaf.group))
            leaf_rel_slot[i] = slot
            leaf_rel_col[i] = col

    n_attrs = len(lw.attrs)
    Ap = _round_up(n_attrs) if pad else max(n_attrs, 1)
    if targets is not None:
        assert targets.n_attrs >= n_attrs, "targets.n_attrs too small"
        Ap = targets.n_attrs

    # device regex lane tables (states padded to max).  Rows whose regexes
    # determinized to the same automaton — the same pattern on different
    # attrs, or byte-identical tables across AuthConfigs — share ONE
    # [S, 256] table; rows reach it through dfa_table_of_row (rule-tensor
    # compaction).  Targets force R/S/NB/T so independently-compiled shards
    # stack (padded rows/tables are never referenced; padded states
    # self-loop).
    R = len(dfa_rows)
    S = max((d.n_states for _, d in dfa_rows), default=1)
    Rp = max(R, 1)
    if targets is not None:
        assert targets.n_dfa_rows >= Rp, "targets.n_dfa_rows too small"
        assert targets.n_dfa_states >= S, "targets.n_dfa_states too small"
        Rp, S = targets.n_dfa_rows, targets.n_dfa_states
    dfa_table_of_row = np.zeros((Rp,), dtype=np.int32)
    dfa_leaf_attr = np.zeros((Rp,), dtype=np.int32)
    attr_byte_slot = np.full((Ap,), -1, dtype=np.int32)
    n_byte_attrs = 0
    table_idx: Dict[Any, int] = {}
    table_dfas: List[Any] = []
    for r_i, (attr, dfa) in enumerate(dfa_rows):
        tkey = (dfa.trans.tobytes(), dfa.accept.tobytes())
        t_i = table_idx.get(tkey)
        if t_i is None:
            t_i = table_idx[tkey] = len(table_dfas)
            table_dfas.append(dfa)
        dfa_table_of_row[r_i] = t_i
        dfa_leaf_attr[r_i] = attr
        if attr_byte_slot[attr] < 0:
            attr_byte_slot[attr] = n_byte_attrs
            n_byte_attrs += 1
    T = len(table_dfas)
    Tp = max(T, 1)
    if targets is not None:
        assert targets.n_dfa_tables >= Tp, "targets.n_dfa_tables too small"
        Tp = targets.n_dfa_tables
    dfa_tables = np.zeros((Tp, S, 256), dtype=np.uint8)
    dfa_accept = np.zeros((Tp, S), dtype=bool)
    for t_i, dfa in enumerate(table_dfas):
        s = dfa.n_states
        dfa_tables[t_i, :s] = dfa.trans
        # padded states self-loop so they can never be reached anyway
        for extra in range(s, S):
            dfa_tables[t_i, extra] = extra
        dfa_accept[t_i, :s] = dfa.accept
    for t_i in range(T, Tp):
        # padded tables (mesh targets): self-loop everywhere, never referenced
        dfa_tables[t_i] = np.arange(S, dtype=np.uint8)[:, None]
    if targets is not None:
        assert targets.n_byte_attrs >= n_byte_attrs, "targets.n_byte_attrs too small"
        # force a uniform (possibly dummy) byte-tensor axis so shards whose
        # sub-corpus has fewer (or no) regexes still stack with the others
        n_byte_attrs = targets.n_byte_attrs
    attr_selectors = [""] * Ap
    for sel, idx in lw.attrs.items():
        attr_selectors[idx] = sel

    # 5b. numeric comparator lane: attrs with numeric leaves get compact
    # [B, NN] value slots (the encoder parses the rendered value once per
    # attr; the kernel compares int32 against the folded constants)
    num_attr_slot = np.full((Ap,), -1, dtype=np.int32)
    num_attrs_list: List[int] = []
    for i in range(n_leaves):
        if leaf_op[i] in NUMERIC_OPS:
            a_i = int(leaf_attr[i])
            if num_attr_slot[a_i] < 0:
                num_attr_slot[a_i] = len(num_attrs_list)
                num_attrs_list.append(a_i)
    NN_real = len(num_attrs_list)
    NN = NN_real
    if targets is not None:
        assert targets.n_num_attrs >= NN_real, "targets.n_num_attrs too small"
        NN = targets.n_num_attrs
    elif pad and NN_real:
        NN = _round_up(NN_real, minimum=2)

    # 5c. relation tables: close every instance's edges into the bitmatrix.
    # Row 0 is the reserved all-zero row (unknown entities); each
    # instance's entities occupy a contiguous row block.  Columns exist
    # only for QUERIED (instance, group) pairs, so W tracks the policy
    # surface, not the hierarchy size.
    rel_entity_rows: List[Dict[str, int]] = []
    next_row = 1
    for rel in rel_instances:
        rel_entity_rows.append(
            {e: next_row + j for j, e in enumerate(rel.entities)})
        next_row += len(rel.entities)
    NR_real = len(rel_slots_list)
    n_rel_cols = len(rel_col_names_list)
    R_real = next_row
    Rp = _round_up(R_real) if pad else max(R_real, 1)
    W = max((n_rel_cols + 7) // 8, 1)
    NRp = NR_real
    if targets is not None:
        assert targets.n_rel_slots >= NR_real, "targets.n_rel_slots too small"
        assert targets.n_rel_rows >= R_real, "targets.n_rel_rows too small"
        assert targets.n_rel_width >= W or not NR_real, \
            "targets.n_rel_width too small"
        NRp, Rp = targets.n_rel_slots, targets.n_rel_rows
        W = max(W, targets.n_rel_width)
    has_rel = NRp > 0
    if has_rel:
        rel_bits = np.zeros((Rp, W), dtype=np.uint8)
        for c, (inst, group) in enumerate(rel_col_names_list):
            closure = rel_instances[inst]
            for entity, row in rel_entity_rows[inst].items():
                if closure.contains(entity, group):
                    rel_bits[row, c >> 3] |= np.uint8(1 << (c & 7))
        rel_slot_attr = np.zeros((max(NRp, 1),), dtype=np.int32)
        for s, (attr, _inst) in enumerate(rel_slots_list):
            rel_slot_attr[s] = attr
    else:
        rel_bits = None
        rel_slot_attr = np.zeros((1,), dtype=np.int32)

    # 6. per-config CPU metadata
    config_attrs: List[List[int]] = []
    config_cpu_leaves: List[List[int]] = []
    # which leaves belong to which config: walk expressions again via dedupe map
    leaf_of_attr: Dict[int, List[int]] = {}
    for i, leaf in enumerate(lw.leaves):
        leaf_of_attr.setdefault(leaf.attr, []).append(i)

    def collect_attrs(expr: Expression, acc_attrs: set, acc_cpu: set):
        if _has_invalid_regex(expr):
            # whole tree rode the CPU-fallback leaf; no attrs were lowered
            acc_cpu.add(lw.tree_leaf_by_expr[id(expr)])
            return
        if isinstance(expr, InGroup):
            acc_attrs.add(lw.attrs[expr.selector])
            return
        if isinstance(expr, Pattern):
            attr = lw.attrs[expr.selector]
            acc_attrs.add(attr)
            if expr.operator is Operator.MATCHES:
                rx = getattr(expr, "_regex", None)
                for op in (OP_ERROR, OP_REGEX_DFA, OP_CPU):
                    key = (op, attr, 0, expr.value)
                    if key in lw.leaf_dedupe:
                        acc_cpu.add(lw.leaf_dedupe[key])
                        break
            elif expr.operator in (Operator.INCL, Operator.EXCL):
                op = OP_INCL if expr.operator is Operator.INCL else OP_EXCL
                key = (op, attr, interner.intern(expr.value), None)
                acc_cpu.add(lw.leaf_dedupe[key])  # overflow lane candidates
        else:
            for c in expr.children:
                collect_attrs(c, acc_attrs, acc_cpu)

    for cfg in configs:
        a: set = set()
        cl: set = set()
        for cond, rule in cfg.evaluators:
            if cond is not None:
                collect_attrs(cond, a, cl)
            collect_attrs(rule, a, cl)
        config_attrs.append(sorted(a))
        config_cpu_leaves.append(sorted(cl))
    # per-config metadata padded alongside the eval-table rows (Gp): padded
    # configs resolve nothing and evaluate vacuously true, and no request
    # ever maps to them
    config_attrs += [[] for _ in range(Gp - n_configs)]
    config_cpu_leaves += [[] for _ in range(Gp - n_configs)]

    # verdict-cache eligibility: a config referencing any request-unique /
    # time-dependent selector produces rows that never repeat — exclude it
    # from the snapshot-scoped verdict cache (pollution dial, not a
    # correctness gate: the cache key is the full encoded-row digest)
    attr_uncacheable = np.zeros((Ap,), dtype=bool)
    for sel_str, a_idx in lw.attrs.items():
        attr_uncacheable[a_idx] = _selector_uncacheable(sel_str)
    config_cacheable = np.ones((Gp,), dtype=bool)
    for row, attrs_l in enumerate(config_attrs):
        if any(attr_uncacheable[a_i] for a_i in attrs_l):
            config_cacheable[row] = False

    # 7. transfer-compaction metadata: which attrs' membership vectors the
    # kernel can ever read (incl/excl leaves), and which leaves ride the
    # dense CPU lane (true-CPU regex/tree leaves; DFA leaves' columns are
    # read only under byte-overflow)
    member_attr_slot = np.full((Ap,), -1, dtype=np.int32)
    member_attrs_list: List[int] = []
    for i in range(n_leaves):
        if leaf_is_membership[i]:
            a_i = int(leaf_attr[i])
            if member_attr_slot[a_i] < 0:
                member_attr_slot[a_i] = len(member_attrs_list)
                member_attrs_list.append(a_i)
    M = targets.n_member_attrs if targets is not None else max(len(member_attrs_list), 1)
    assert M >= max(len(member_attrs_list), 1), "targets.n_member_attrs too small"

    # membership leaves join the dense assist columns under ovf_assist:
    # their exact overflow answers (already computed by the encoder) travel
    # to the device and the kernel selects them under the overflow mask
    cpu_leaf_list_: List[int] = [
        i for i in range(n_leaves)
        if leaf_op[i] in (OP_CPU, OP_TREE_CPU, OP_REGEX_DFA)
        or (ovf_assist and leaf_op[i] in (OP_INCL, OP_EXCL))
    ]
    C = targets.n_cpu_leaves if targets is not None else max(len(cpu_leaf_list_), 1)
    assert C >= max(len(cpu_leaf_list_), 1), "targets.n_cpu_leaves too small"

    return CompiledPolicy(
        leaf_op=leaf_op,
        leaf_attr=leaf_attr,
        leaf_const=leaf_const,
        levels=tuple((c.astype(np.int32), a) for c, a in levels),
        eval_cond=eval_cond,
        eval_rule=eval_rule,
        eval_has_cond=eval_has_cond,
        dfa_tables=dfa_tables,
        dfa_accept=dfa_accept,
        dfa_table_of_row=dfa_table_of_row,
        dfa_leaf_attr=dfa_leaf_attr,
        leaf_dfa_row=leaf_dfa_row,
        attr_byte_slot=attr_byte_slot,
        n_byte_attrs=n_byte_attrs,
        interner=interner,
        attr_selectors=attr_selectors,
        config_ids=config_ids,
        config_attrs=config_attrs,
        config_cpu_leaves=config_cpu_leaves,
        leaf_regex=leaf_regex,
        leaf_tree=leaf_tree,
        leaf_is_membership=leaf_is_membership,
        members_k=members_k,
        member_attr_slot=member_attr_slot,
        member_attrs=np.asarray(member_attrs_list, dtype=np.int32),
        n_member_attrs=M,
        cpu_leaf_list=np.asarray(cpu_leaf_list_, dtype=np.int32),
        n_cpu_leaves=C,
        config_exprs=[list(cfg.evaluators) for cfg in configs]
        + [[] for _ in range(Gp - n_configs)],
        config_cacheable=config_cacheable,
        num_attr_slot=num_attr_slot,
        num_attrs=np.asarray(num_attrs_list, dtype=np.int32),
        n_num_attrs=NN,
        rel_bits=rel_bits,
        leaf_rel_slot=leaf_rel_slot,
        leaf_rel_col=leaf_rel_col,
        rel_slot_attr=rel_slot_attr,
        n_rel_slots=NRp,
        rel_instances=rel_instances,
        rel_entity_rows=rel_entity_rows,
        rel_slots=rel_slots_list,
        rel_col_names=rel_col_names_list,
        ovf_assist=bool(ovf_assist),
    )
