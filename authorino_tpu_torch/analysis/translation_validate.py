"""Translation validation: certify that a compiled snapshot decides
identically to the host expression oracle, per config, with a
machine-checkable certificate.

PRs 2-5 stack exactness-preserving transforms (fused H2D, row dedup, the
verdict cache, host-oracle degrade) on one assumption: the compiler lowered
each config's ``Expression`` trees into circuits and DFA tables *correctly*.
Until now that was pinned only by example-based differential tests.  This
module certifies it per config, at reconcile time, in three layers
(the Cedar move — bounded symbolic evaluation as a first-class language
property — applied to the compiled artifact instead of the source policy):

  1. **Circuit equivalence** — the packed And/Or circuit reachable from a
     config's eval slots is cross-checked against the original expression
     trees over *all* assignments of their shared atom universe (the same
     atom model the kernel computes leaf-wise: eq/neq and incl/excl on one
     (attr, const) are exact complements, regex leaves are one atom per
     (attr, pattern), whole-tree CPU-fallback leaves are opaque atoms keyed
     by tree identity).  Configs with ≤ MAX_ATOMS atoms are checked
     exhaustively (2^n vectorized rows); wider ones get seeded randomized
     sampling plus the all-true/all-false corners, with the sample count
     recorded in the certificate.
  2. **Regex ↔ DFA equivalence** — each determinized transition table is
     checked against its reference regex via structured witness strings
     derived from BOTH the audited table and a fresh reference
     determinization (one reaching witness per state, plus an accepting and
     a rejecting extension per state, the empty string, and an exact
     DFA_VALUE_BYTES-length boundary witness).  The audited-table witnesses
     catch transitions that accept too much; the fresh-table witnesses catch
     transitions that reject too much — a miscompiled row cannot hide on
     either side.  Simulation replays the kernel's semantics exactly (full
     DFA_VALUE_BYTES scan, NUL padding as claimed-identity), so a corrupted
     pad column is caught too.
  3. **Lowerability report** — a static pass classifying every config as
     fast-lane or slow-lane with a reason code (catalogue below), surfaced
     on /debug/vars and in auth_server_lowerability_configs_total.

Each certificate is keyed by a **canonical semantic fingerprint** of the
config's lowered IR: a structural hash over selector strings, operator
kinds, constant *strings* (never interner ids — stable across interning
orders), regex patterns, DFA table bytes, and circuit shape.  A bounded
process-wide cache maps fingerprint → certificate, so re-reconciling an
unchanged config skips re-validation entirely — the first concrete piece of
the incremental-compile plan (ROADMAP item 1).

The validator proves it is not blind: ``mutation_self_test`` plants
miscompiles (flipped circuit child, redirected eval slot, swapped leaf
attr, swapped leaf const, corrupted DFA transition/accept/pad) and reports
a ``validator-blind`` finding for any mutant that certifies clean.

Import-light by construction: numpy + hashlib only, runs without
``cryptography`` and under JAX_PLATFORMS=cpu.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..compiler.compile import (
    DFA_VALUE_BYTES,
    FALSE_SLOT,
    NUMERIC_OPS,
    OP_CPU,
    OP_EQ,
    OP_ERROR,
    OP_EXCL,
    OP_INCL,
    OP_NEQ,
    OP_NUM_GE,
    OP_NUM_GT,
    OP_NUM_LE,
    OP_NUM_LT,
    OP_REGEX_DFA,
    OP_RELATION,
    OP_TREE_CPU,
    TRUE_SLOT,
    CompiledPolicy,
    _has_invalid_regex,
)
from ..expressions.ast import And, Expression, InGroup, Operator, Pattern
from . import Finding
from .policy_analysis import MAX_ATOMS, _Circuit

__all__ = [
    "Certificate", "certify_config", "certify_snapshot",
    "config_fingerprint", "lowerability_report", "mutation_self_test",
    "relations_mutation_self_test",
    "clear_certificate_cache", "certificate_cache_len", "snapshot_policies",
    "LANE_FAST", "LANE_SLOW", "REASON_CODES", "SAMPLES_DEFAULT",
]

_LAYER = "translation_validate"

# sampled tier: assignments drawn for configs wider than MAX_ATOMS (plus
# the all-true / all-false corners, always included)
SAMPLES_DEFAULT = 2048

LANE_FAST = "fast"
LANE_SLOW = "slow"

# lowerability reason-code catalogue (docs/static_analysis.md).  Slow-lane
# codes mean the verdict cannot ride the kernel at all; fast-lane caveat
# codes mean the kernel decides but specific rows/leaves get per-request
# CPU assists (all exactness-preserving).
REASON_CODES = {
    # slow lane
    "no-authorization-rules": "no compilable authorization surface",
    "unsupported-comparator": "an OPA policy outside the provably-lowerable "
                              "Rego subset keeps the interpreter",
    "external-authorization": "SubjectAccessReview / SpiceDB evaluators "
                              "require an external call per request",
    "metadata-dependency": "metadata evaluators fetch external documents "
                           "per request",
    # fast lane caveats
    "invalid-regex-fallback": "a whole-tree CPU-fallback leaf (invalid "
                              "regex or unfoldable numeric constant) is "
                              "re-evaluated host-side per request",
    "cpu-regex": "a regex outside the DFA subset rides the CPU regex lane",
    "cpu-grid-overflow": "incl/excl membership leaves can overflow the "
                         "compact K grid, routing those rows to the host "
                         "oracle (reported only while the deciding "
                         "policy's K is below MEMBERS_K_SAFE — mesh grid "
                         "relief or the ovf_assist in-kernel overflow "
                         "lane lifts configs out of this caveat)",
    "metadata-prefetch": "metadata evaluators serve from the reconcile-"
                         "cadence prefetch cache (pinned documents with a "
                         "staleness bound); a stale/unfetched document "
                         "falls through to the live fetch per request",
}

# membership grids at least this wide are treated as overflow-proof for the
# operator-facing lowerability report: role/group lists past 32 entries are
# pathological, and the host-fallback lane still guarantees exactness for
# them.  The mesh lane's grid relief (parallel/sharded_eval.py — each mp
# shard's smaller member grid funds a ~mp× larger K) is what crosses this
# bound in practice: rule-sharding a corpus across ≥2 devices drops its
# cpu-grid-overflow count.
MEMBERS_K_SAFE = 32


def _err(kind: str, message: str, location: str = "", **detail) -> Finding:
    return Finding(kind=kind, message=message, layer=_LAYER,
                   severity="error", location=location, detail=detail)


@dataclass
class Certificate:
    """Machine-checkable evidence that one config's compiled artifact
    decides identically to the host expression oracle."""

    config: str
    fingerprint: str
    ok: bool
    mode: str                 # "exhaustive" | "sampled"
    n_atoms: int
    n_assignments: int
    seed: Optional[int]       # sampling seed (None for exhaustive)
    dfa_rows: int = 0         # distinct (table, regex) pairs checked
    dfa_witnesses: int = 0    # witness strings cross-checked
    dfa_skipped: int = 0      # non-UTF-8 / over-length witnesses skipped
    cached: bool = False      # served from the fingerprint cache

    def to_json(self) -> Dict[str, Any]:
        return {
            "config": self.config, "fingerprint": self.fingerprint,
            "ok": self.ok, "mode": self.mode, "n_atoms": self.n_atoms,
            "n_assignments": self.n_assignments, "seed": self.seed,
            "dfa_rows": self.dfa_rows, "dfa_witnesses": self.dfa_witnesses,
            "dfa_skipped": self.dfa_skipped, "cached": self.cached,
        }


# ---------------------------------------------------------------------------
# Atom model shared by both sides of the equivalence check
# ---------------------------------------------------------------------------


class _TVCircuit(_Circuit):
    """policy_analysis's circuit view with one refinement: OP_TREE_CPU
    leaves are keyed by *tree object identity*, not leaf index — two leaves
    lowered from the same expression object evaluate identically at runtime
    (both run ``expr.matches(doc)``), so they must share one atom or a
    correct compile could be flagged as a mismatch."""

    def leaf_atom(self, leaf: int):
        atom, neg, const = super().leaf_atom(leaf)
        if atom is not None and atom[0] == "t":
            tree = self.policy.leaf_tree[leaf]
            if tree is not None:
                return ("t", id(tree)), neg, const
        return atom, neg, const


_HOST_NUM_OP = {
    Operator.GT: OP_NUM_GT,
    Operator.GE: OP_NUM_GE,
    Operator.LT: OP_NUM_LT,
    Operator.LE: OP_NUM_LE,
}


def _host_attr_of(attr_of: Dict[str, int], selector: str) -> int:
    attr = attr_of.get(selector)
    if attr is None:
        # the compiler never saw this selector: give it a fresh atom keyed
        # by the selector string — it can only DIFFER from the compiled
        # side, which is exactly the mismatch we want to surface
        attr = -1 - abs(hash(selector)) % (1 << 30)
    return attr


def _host_atom(policy: CompiledPolicy, attr_of: Dict[str, int],
               p: Pattern) -> Tuple[Optional[tuple], bool, Optional[bool]]:
    """(atom, negated, constant) for one ORIGINAL Pattern leaf, mirroring
    the compiled side's atom keys exactly.  Valid-regex patterns only —
    invalid-regex trees are handled wholesale by the caller."""
    attr = _host_attr_of(attr_of, p.selector)
    op = p.operator
    if op is Operator.MATCHES:
        return ("r", attr, p.value), False, None
    if op in _HOST_NUM_OP:
        # the compiled side keys numeric atoms by (op, attr, FOLDED const);
        # an unfoldable const never reaches here (whole-tree fallback)
        return ("n", _HOST_NUM_OP[op], attr,
                int(p._num_const)), False, None  # type: ignore[attr-defined]
    const = policy.interner.lookup(p.value)
    if op in (Operator.EQ, Operator.NEQ):
        return ("v", attr, const), op is Operator.NEQ, None
    return ("m", attr, const), op is Operator.EXCL, None


def _host_relation_atom(attr_of: Dict[str, int], g: InGroup) -> tuple:
    """InGroup leaf → the same ("G", attr, closure digest, group) key the
    compiled side derives from its (slot, column) bindings."""
    return ("G", _host_attr_of(attr_of, g.selector),
            g.relation.digest, g.group)


def _host_support(policy: CompiledPolicy, attr_of: Dict[str, int],
                  expr: Expression, acc: Set[tuple]) -> None:
    """Atom keys of one original expression, mirroring the lowerer's
    recursion: the top-most node containing an invalid regex becomes one
    opaque whole-tree atom (compiler/compile.py lower())."""
    if _has_invalid_regex(expr):
        acc.add(("t", id(expr)))
        return
    if isinstance(expr, Pattern):
        atom, _, _ = _host_atom(policy, attr_of, expr)
        if atom is not None:
            acc.add(atom)
        return
    if isinstance(expr, InGroup):
        acc.add(_host_relation_atom(attr_of, expr))
        return
    for c in expr.children:
        _host_support(policy, attr_of, c, acc)


def _host_eval(policy: CompiledPolicy, attr_of: Dict[str, int],
               expr: Expression, cols: Dict[tuple, np.ndarray],
               n: int) -> np.ndarray:
    """Truth column [n] of one ORIGINAL expression over the assignment
    matrix — the host oracle, evaluated symbolically over the same atoms
    the compiled circuit reads."""
    if _has_invalid_regex(expr):
        return cols[("t", id(expr))]
    if isinstance(expr, Pattern):
        atom, neg, const = _host_atom(policy, attr_of, expr)
        if atom is None:
            return np.full(n, bool(const))
        v = cols[atom]
        return ~v if neg else v
    if isinstance(expr, InGroup):
        return cols[_host_relation_atom(attr_of, expr)]
    is_and = isinstance(expr, And)
    acc: Optional[np.ndarray] = None
    for c in expr.children:
        cv = _host_eval(policy, attr_of, c, cols, n)
        acc = cv if acc is None else ((acc & cv) if is_and else (acc | cv))
    if acc is None:
        return np.full(n, is_and)  # empty And ≡ True, empty Or ≡ False
    return acc


def _reachable_leaves(circ: _Circuit, slots: Sequence[int]) -> List[int]:
    """Leaf indices reachable from the given buffer slots."""
    leaf_hi = circ.leaf_base + circ.policy.n_leaves
    seen: Set[int] = set()
    out: Set[int] = set()
    stack = [s for s in slots]
    while stack:
        s = stack.pop()
        if s in seen or s in (TRUE_SLOT, FALSE_SLOT):
            continue
        seen.add(s)
        if s < leaf_hi:
            out.add(s - circ.leaf_base)
        else:
            _, kids = circ.node_of[s]
            stack.extend(kids)
    return sorted(out)


# ---------------------------------------------------------------------------
# Layer 2: regex ↔ DFA equivalence via structured witnesses
# ---------------------------------------------------------------------------

# byte exploration order: printable ASCII first (decodable witnesses), then
# control bytes, then high bytes (only reachable for multi-byte UTF-8
# literal patterns; undecodable witnesses are skipped and counted)
_BYTE_ORDER = (list(range(0x20, 0x7F)) + list(range(1, 0x20)) + [0x7F]
               + list(range(0x80, 0x100)))


def _state_witnesses(trans: np.ndarray) -> Dict[int, bytes]:
    """Shortest-ish byte string reaching each reachable state from state 0,
    preferring printable bytes."""
    wit: Dict[int, bytes] = {0: b""}
    order = [0]
    i = 0
    while i < len(order):
        s = order[i]
        i += 1
        row = trans[s]
        for b in _BYTE_ORDER:
            t = int(row[b])
            if t not in wit:
                wit[t] = wit[s] + bytes([b])
                order.append(t)
    return wit


def _suffixes_to(trans: np.ndarray, targets: Set[int]) -> Dict[int, bytes]:
    """Per state: a shortest byte suffix driving into ``targets`` (reverse
    BFS over the transition table), preferring printable bytes."""
    S = trans.shape[0]
    rev: Dict[int, List[Tuple[int, int]]] = {}
    for s in range(S):
        row = trans[s]
        for b in _BYTE_ORDER:
            rev.setdefault(int(row[b]), []).append((s, b))
    suf: Dict[int, bytes] = {t: b"" for t in targets}
    frontier = list(targets)
    while frontier:
        nxt: List[int] = []
        for t in frontier:
            for (s, b) in rev.get(t, ()):
                if s not in suf:
                    suf[s] = bytes([b]) + suf[t]
                    nxt.append(s)
        frontier = nxt
    return suf


def _table_witnesses(trans: np.ndarray, accept: np.ndarray) -> Tuple[List[bytes], int]:
    """Witness strings derived from one transition table: a reaching
    witness per state plus an accepting and a rejecting extension per
    state, the empty string, and one exact DFA_VALUE_BYTES boundary
    witness.  Returns (witnesses, skipped_overlength)."""
    wit = _state_witnesses(trans)
    acc_states = {s for s in wit if bool(accept[s])}
    rej_states = {s for s in wit if not bool(accept[s])}
    to_acc = _suffixes_to(trans, acc_states) if acc_states else {}
    to_rej = _suffixes_to(trans, rej_states) if rej_states else {}
    out: Set[bytes] = {b""}
    skipped = 0
    for s, w in wit.items():
        cands = [w]
        if s in to_acc:
            cands.append(w + to_acc[s])
        if s in to_rej:
            cands.append(w + to_rej[s])
        for cand in cands:
            if len(cand) > DFA_VALUE_BYTES:
                skipped += 1
                continue
            out.add(cand)
    # boundary: pad some witness to EXACTLY DFA_VALUE_BYTES via a self-loop
    # byte on its final state, proving the full-length scan path
    for s, w in sorted(wit.items()):
        row = trans[s]
        loop = next((b for b in _BYTE_ORDER[:0x5F] if int(row[b]) == s), None)
        if loop is not None and len(w) < DFA_VALUE_BYTES:
            out.add(w + bytes([loop]) * (DFA_VALUE_BYTES - len(w)))
            break
    return sorted(out), skipped


def _simulate_kernel_scan(trans: np.ndarray, accept: np.ndarray,
                          witnesses: List[bytes]) -> np.ndarray:
    """Replay the kernel's DFA lane exactly: every value occupies a full
    DFA_VALUE_BYTES buffer, NUL-padded, and the scan covers ALL bytes —
    NUL transitions come from the (claimed-identity) pad column, so a
    corrupted pad column changes results here just like on device."""
    n = len(witnesses)
    buf = np.zeros((n, DFA_VALUE_BYTES), dtype=np.uint8)
    for i, w in enumerate(witnesses):
        buf[i, : len(w)] = np.frombuffer(w, dtype=np.uint8)
    state = np.zeros(n, dtype=np.int64)
    for col in range(DFA_VALUE_BYTES):
        state = trans[state, buf[:, col]].astype(np.int64)
    return accept[state]


def _check_dfa_leaf(policy: CompiledPolicy, leaf: int,
                    memo: Dict[tuple, Tuple[List[Finding], int, int]],
                    ) -> Tuple[List[Finding], int, int]:
    """Validate one OP_REGEX_DFA leaf's table against its reference regex.
    Returns (findings, n_witnesses, n_skipped); memoized per
    (table, pattern) so configs sharing a deduped table pay once."""
    rx = policy.leaf_regex[leaf]
    row = int(policy.leaf_dfa_row[leaf])
    findings: List[Finding] = []
    loc = f"leaf[{leaf}]"
    if rx is None:
        return [_err("dfa-mismatch",
                     "OP_REGEX_DFA leaf has no compiled reference regex",
                     loc, leaf=leaf)], 0, 0
    if not (0 <= row < policy.dfa_table_of_row.shape[0]):
        return [_err("dfa-mismatch",
                     f"leaf dfa row {row} outside the row axis", loc,
                     leaf=leaf)], 0, 0
    # row ↔ attr binding: the kernel gathers value bytes through
    # dfa_leaf_attr's byte slot — a swapped binding scans the WRONG
    # attribute's bytes, which no truth-table over atoms can see
    if int(policy.dfa_leaf_attr[row]) != int(policy.leaf_attr[leaf]):
        findings.append(_err(
            "dfa-mismatch",
            f"dfa row {row} is bound to attr {int(policy.dfa_leaf_attr[row])}"
            f" but its leaf reads attr {int(policy.leaf_attr[leaf])}",
            loc, leaf=leaf, row=row))
    t_i = int(policy.dfa_table_of_row[row])
    if not (0 <= t_i < policy.dfa_tables.shape[0]):
        # the tensor lint owns this invariant (dfa-table-index) on the
        # gated paths, but certify must degrade to a finding — never an
        # IndexError (or a negative-wrap audit of the wrong table) — when
        # called directly on an unlinted snapshot
        return findings + [_err(
            "dfa-mismatch",
            f"dfa row {row} points at table {t_i} outside the table axis "
            f"[0, {policy.dfa_tables.shape[0]})", loc, leaf=leaf,
            row=row)], 0, 0
    key = (t_i, rx.pattern)
    hit = memo.get(key)
    if hit is not None:
        f, w, sk = hit
        return findings + f, w, sk
    trans = policy.dfa_tables[t_i].astype(np.int64)
    accept = policy.dfa_accept[t_i]
    S = trans.shape[0]
    tbl_findings: List[Finding] = []
    n_wit = 0
    n_skip = 0
    # pad column must be the identity the whole trim/pad machinery assumes
    bad_pad = np.nonzero(trans[:, 0] != np.arange(S))[0]
    if bad_pad.size:
        s = int(bad_pad[0])
        tbl_findings.append(_err(
            "dfa-mismatch",
            f"pad byte 0 is not an identity transition at state {s} "
            f"(goes to {int(trans[s, 0])}): NUL-padded scans change state",
            f"dfa_tables[{t_i}]", table=t_i, state=s))
    # witnesses from the audited table AND from a fresh reference
    # determinization of the pattern string (ground truth): the audited
    # side catches accept-too-much, the fresh side catches reject-too-much
    sources = [(trans, accept)]
    from ..compiler.redfa import compile_regex_dfa

    fresh = compile_regex_dfa(rx.pattern)
    if fresh is None:
        tbl_findings.append(_err(
            "dfa-mismatch",
            f"pattern {rx.pattern!r} no longer determinizes but a compiled "
            "table exists for it", f"dfa_tables[{t_i}]", table=t_i))
    else:
        sources.append((fresh.trans.astype(np.int64), fresh.accept))
    for src_trans, src_accept in sources:
        wits, skipped = _table_witnesses(src_trans, src_accept)
        n_skip += skipped
        checked: List[bytes] = []
        texts: List[str] = []
        for w in wits:
            try:
                texts.append(w.decode("utf-8"))
            except UnicodeDecodeError:
                n_skip += 1  # no str value can encode to these bytes
                continue
            checked.append(w)
        if not checked:
            continue
        dev = _simulate_kernel_scan(trans, accept, checked)
        n_wit += len(checked)
        for i, text in enumerate(texts):
            host = rx.search(text) is not None
            if bool(dev[i]) != host:
                tbl_findings.append(_err(
                    "dfa-mismatch",
                    f"table {t_i} decides {bool(dev[i])} but regex "
                    f"{rx.pattern!r} decides {host} on witness {text!r}",
                    f"dfa_tables[{t_i}]", table=t_i, witness=text,
                    pattern=rx.pattern))
                break  # one witness per source is plenty of evidence
    memo[key] = (tbl_findings, n_wit, n_skip)
    return findings + tbl_findings, n_wit, n_skip


# ---------------------------------------------------------------------------
# Layer 2b: relation tables ↔ source closures, numeric lane bindings
# ---------------------------------------------------------------------------


def _check_relation_leaf(policy: CompiledPolicy, leaf: int,
                         memo: Dict[int, List[Finding]]) -> List[Finding]:
    """Audit one OP_RELATION leaf: its (slot, column) bindings and the
    FULL column against a fresh recomputation from the source closure —
    the relation twin of the regex↔DFA witness check.  A flipped bit or a
    redirected column is invisible to the truth-table layer (the bitmatrix
    is params, not atoms), so this check is what makes relation-table
    miscompiles rejectable."""
    loc = f"leaf[{leaf}]"
    col = int(policy.leaf_rel_col[leaf])
    slot = int(policy.leaf_rel_slot[leaf])
    findings: List[Finding] = []
    names = policy.rel_col_names or []
    insts = policy.rel_instances or []
    slots = policy.rel_slots or []
    if not (0 <= col < len(names)):
        return [_err("relation-mismatch",
                     f"relation leaf column {col} outside the column "
                     f"registry [0, {len(names)})", loc, leaf=leaf)]
    inst, group = names[col]
    if not (0 <= inst < len(insts)):
        return [_err("relation-mismatch",
                     f"column {col} references relation instance {inst} "
                     f"outside [0, {len(insts)})", loc, leaf=leaf)]
    closure = insts[inst]
    rows = (policy.rel_entity_rows[inst]
            if policy.rel_entity_rows and inst < len(policy.rel_entity_rows)
            else {})
    # slot binding — PER LEAF, never memoized: two leaves can share a
    # column (same closure+group on different selectors) while each reads
    # its own slot, and a swapped binding on EITHER makes the encoder
    # resolve the wrong attribute's entity row for that leaf
    if not (0 <= slot < len(slots)) or \
            slots[slot] != (int(policy.leaf_attr[leaf]), inst):
        findings.append(_err(
            "relation-mismatch",
            f"relation leaf slot {slot} is bound to "
            f"{slots[slot] if 0 <= slot < len(slots) else '<missing>'} but "
            f"the leaf reads (attr {int(policy.leaf_attr[leaf])}, "
            f"instance {inst})", loc, leaf=leaf, slot=slot))
    # column-bits audit — memoized per column (a pure function of the
    # compiled table + the source closure, shared across sharers)
    hit = memo.get(col)
    if hit is not None:
        return findings + list(hit)
    col_findings: List[Finding] = []
    if policy.rel_bits is None or col >= int(policy.rel_bits.shape[1]) * 8:
        col_findings.append(_err(
            "relation-mismatch",
            f"column {col} outside the compiled bitmatrix", loc, leaf=leaf))
        memo[col] = col_findings
        return findings + list(col_findings)
    bits = ((policy.rel_bits[:, col >> 3] >> np.uint8(col & 7)) & 1) != 0
    expected = np.zeros(bits.shape[0], dtype=bool)
    overrun = False
    for entity, row in rows.items():
        if not (0 <= row < bits.shape[0]):
            overrun = True
            continue
        expected[row] = closure.contains(entity, group)
    if overrun:
        col_findings.append(_err(
            "relation-mismatch",
            f"entity rows of instance {inst} overrun the bitmatrix "
            f"[{bits.shape[0]} rows]", f"rel_bits[:, {col}]", col=col))
    diff = np.nonzero(bits != expected)[0]
    if diff.size:
        r = int(diff[0])
        entity = next((e for e, rr in rows.items() if rr == r), f"<row {r}>")
        col_findings.append(_err(
            "relation-mismatch",
            f"relation table bit ({r}, {col}) = {bool(bits[r])} but the "
            f"closure says {entity!r} ∈ {group!r} is {bool(expected[r])} "
            "(flipped/corrupted hierarchy closure)",
            f"rel_bits[{r}, {col}]", row=r, col=col, entity=entity,
            group=group))
    memo[col] = col_findings
    return findings + list(col_findings)


def _numeric_lane_findings(policy: CompiledPolicy) -> List[Finding]:
    """Numeric-lane binding audit (once per snapshot): every numeric leaf's
    attr must own a distinct in-range value slot — a slot COLLISION makes
    the encoder overwrite one attr's value with another's, which no
    truth-table over atoms can see."""
    findings: List[Finding] = []
    if not getattr(policy, "n_num_attrs", 0):
        if np.isin(policy.leaf_op, NUMERIC_OPS).any():
            findings.append(_err(
                "numeric-mismatch",
                "corpus has numeric leaves but no numeric lane",
                "num_attr_slot"))
        return findings
    NN = int(policy.n_num_attrs)
    seen: Dict[int, int] = {}
    for leaf in range(policy.n_leaves):
        if int(policy.leaf_op[leaf]) not in NUMERIC_OPS:
            continue
        attr = int(policy.leaf_attr[leaf])
        slot = int(policy.num_attr_slot[attr])
        if not (0 <= slot < NN):
            findings.append(_err(
                "numeric-mismatch",
                f"numeric leaf {leaf} reads attr {attr} whose value slot "
                f"{slot} is outside [0, NN={NN})", f"leaf[{leaf}]",
                leaf=leaf, attr=attr))
            continue
        owner = seen.setdefault(slot, attr)
        if owner != attr:
            findings.append(_err(
                "numeric-mismatch",
                f"numeric value slot {slot} is shared by attrs {owner} and "
                f"{attr}: the encoder writes one attr's value over the "
                "other's", "num_attr_slot", slot=slot))
    return findings


def _rows_in_range(policy: CompiledPolicy) -> bool:
    """True when every dfa_table_of_row entry indexes a real table.  The
    grouping audit below only runs on a valid map: an out-of-range entry is
    the dfa-table-index lint's finding, not the permutation's fault."""
    rows = np.asarray(policy.dfa_table_of_row)
    if not rows.size:
        return True
    T = int(policy.dfa_tables.shape[0]) if policy.dfa_tables is not None else 0
    return int(rows.min()) >= 0 and int(rows.max()) < T


def _fused_layout_findings(policy: CompiledPolicy) -> List[Finding]:
    """Fused-layout audit (once per snapshot): the mega-kernel's
    packed operand layouts against their sources.  A corrupted row
    permutation silently evaluates every affected regex leaf against the
    WRONG automaton; a lossy int8 op cast reroutes leaves through the
    wrong comparison; a wrong bitpack width truncates (or pads) the
    readback the dispatchers decode — none of which a truth-table over
    atoms can see, so the certifier checks the layouts symbolically."""
    from ..ops.operands import packed_width

    findings: List[Finding] = []
    if policy.dfa_table_of_row is not None:
        R = int(policy.dfa_table_of_row.shape[0])
        perm = getattr(policy, "dfa_row_perm", None)
        if perm is None or perm.shape != (R,) or \
                not np.array_equal(np.sort(np.asarray(perm)), np.arange(R)):
            findings.append(_err(
                "fused-layout",
                f"dfa_row_perm is not a bijection over [0, R={R})",
                "dfa_row_perm"))
        elif R and _rows_in_range(policy) and np.any(np.diff(
                policy.dfa_table_of_row[np.asarray(perm)]) < 0):
            findings.append(_err(
                "fused-layout",
                "dfa_row_perm does not group DFA rows by owning table",
                "dfa_row_perm"))
    i8 = getattr(policy, "leaf_op_i8", None)
    if policy.leaf_op is not None and (
            i8 is None or i8.dtype != np.int8
            or not np.array_equal(i8.astype(np.int64),
                                  policy.leaf_op.astype(np.int64))):
        findings.append(_err(
            "fused-layout",
            "leaf_op_i8 is not a lossless int8 image of leaf_op",
            "leaf_op_i8"))
    if policy.eval_rule is not None:
        want = packed_width(1 + 2 * int(policy.eval_rule.shape[1]))
        if int(getattr(policy, "fused_pack_w", 0)) != want:
            findings.append(_err(
                "fused-layout",
                f"fused_pack_w {getattr(policy, 'fused_pack_w', 0)} != "
                f"packed_width(1+2E) = {want}", "fused_pack_w"))
    return findings


# ---------------------------------------------------------------------------
# Canonical semantic fingerprints
# ---------------------------------------------------------------------------


def _sha(payload: str) -> str:
    return hashlib.sha256(payload.encode("utf-8")).hexdigest()


def _tree_digest(expr: Expression, memo: Dict[int, str]) -> str:
    hit = memo.get(id(expr))
    if hit is not None:
        return hit
    if isinstance(expr, Pattern):
        d = _sha(repr(("p", expr.selector, expr.operator.value, expr.value)))
    elif isinstance(expr, InGroup):
        # the closure digest IS the relation's semantics: a changed edge
        # set re-fingerprints (and thus re-certifies / recompiles) exactly
        # the configs reading the relation
        d = _sha(repr(("g", expr.selector, expr.group,
                       expr.relation.digest)))
    else:
        tag = "a" if isinstance(expr, And) else "o"
        d = _sha(repr((tag, tuple(_tree_digest(c, memo)
                                  for c in expr.children))))
    memo[id(expr)] = d
    return d


def _slot_digest(policy: CompiledPolicy, circ: _Circuit, slot: int,
                 memo: Dict[int, str], rev: Dict[int, str],
                 tree_memo: Dict[int, str]) -> str:
    """Structural digest of one buffer slot — position-independent (no slot
    numbers, no interner ids), so fingerprints survive recompiles, interner
    reorders, and padding changes."""
    if slot == TRUE_SLOT:
        return "T"
    if slot == FALSE_SLOT:
        return "F"
    hit = memo.get(slot)
    if hit is not None:
        return hit
    leaf_hi = circ.leaf_base + policy.n_leaves
    if slot < leaf_hi:
        leaf = slot - circ.leaf_base
        op = int(policy.leaf_op[leaf])
        sel = policy.attr_selectors[int(policy.leaf_attr[leaf])]
        if op in (OP_EQ, OP_NEQ, OP_INCL, OP_EXCL):
            const = rev.get(int(policy.leaf_const[leaf]),
                            f"<id:{int(policy.leaf_const[leaf])}>")
            d = _sha(repr(("L", op, sel, const)))
        elif op in NUMERIC_OPS:
            # numeric consts are raw int32, not interner ids
            d = _sha(repr(("N", op, sel, int(policy.leaf_const[leaf]))))
        elif op == OP_RELATION:
            # the certificate vouches for the leaf's (slot, column)
            # bindings AND the column's bits: all of it must ride the
            # fingerprint or the cache would mask a corrupted table
            col = int(policy.leaf_rel_col[leaf])
            slot = int(policy.leaf_rel_slot[leaf])
            art = hashlib.sha256()
            if policy.rel_col_names is not None and \
                    0 <= col < len(policy.rel_col_names):
                inst, group = policy.rel_col_names[col]
                digest = (policy.rel_instances[inst].digest
                          if 0 <= inst < len(policy.rel_instances)
                          else f"<inst:{inst}>")
                art.update(repr((digest, group)).encode())
            else:
                art.update(f"<col:{col}>".encode())
            if policy.rel_bits is not None and \
                    0 <= col < int(policy.rel_bits.shape[1]) * 8:
                art.update(((policy.rel_bits[:, col >> 3]
                             >> np.uint8(col & 7)) & 1).tobytes())
            slot_attr = (int(policy.rel_slot_attr[slot])
                         if policy.rel_slot_attr is not None
                         and 0 <= slot < policy.rel_slot_attr.shape[0]
                         else -1)
            slot_sel = (policy.attr_selectors[slot_attr]
                        if 0 <= slot_attr < len(policy.attr_selectors)
                        else "?")
            art.update(slot_sel.encode("utf-8", "replace"))
            d = _sha(repr(("G", sel, art.hexdigest())))
        elif op in (OP_CPU, OP_REGEX_DFA):
            rx = policy.leaf_regex[leaf]
            pat = rx.pattern if rx is not None else ""
            if op == OP_REGEX_DFA:
                # the fingerprint must cover everything the certificate
                # vouches for: a corrupted table/accept/row binding has to
                # change the fingerprint, or the cache would mask it
                row = int(policy.leaf_dfa_row[leaf])
                t_i = int(policy.dfa_table_of_row[row]) \
                    if 0 <= row < policy.dfa_table_of_row.shape[0] else -1
                art = hashlib.sha256()
                art.update(policy.dfa_tables[t_i].tobytes()
                           if 0 <= t_i < policy.dfa_tables.shape[0] else b"?")
                art.update(policy.dfa_accept[t_i].tobytes()
                           if 0 <= t_i < policy.dfa_accept.shape[0] else b"?")
                # row→attr binding by SELECTOR STRING (attr indices are
                # interning-order-dependent; selectors are canonical)
                row_attr = (int(policy.dfa_leaf_attr[row])
                            if 0 <= row < policy.dfa_leaf_attr.shape[0]
                            else -1)
                row_sel = (policy.attr_selectors[row_attr]
                           if 0 <= row_attr < len(policy.attr_selectors)
                           else "?")
                art.update(row_sel.encode("utf-8", "replace"))
                d = _sha(repr(("R", op, sel, pat, art.hexdigest())))
            else:
                d = _sha(repr(("R", op, sel, pat)))
        elif op == OP_TREE_CPU:
            tree = policy.leaf_tree[leaf]
            d = _sha(repr(("W", _tree_digest(tree, tree_memo)
                           if tree is not None else "?")))
        else:  # OP_ERROR (constant deny) or unknown
            d = _sha(repr(("X", op, sel)))
    else:
        is_and, kids = circ.node_of[slot]
        d = _sha(repr(("N", is_and,
                       tuple(_slot_digest(policy, circ, k, memo, rev,
                                          tree_memo) for k in kids))))
    memo[slot] = d
    return d


def config_fingerprint(policy: CompiledPolicy, row: int,
                       circ: Optional[_Circuit] = None,
                       memo: Optional[Dict[int, str]] = None) -> str:
    """Canonical semantic fingerprint of one config's lowered IR — a hash
    of the (source, compiled) PAIR.  The certificate's claim is "compiled
    ≡ THIS config's host oracle", so the original expression trees are
    folded in alongside the compiled circuit: a miscompile whose wrong
    circuit happens to be structurally identical to some other validated
    config's circuit still changes the fingerprint (same compiled digest,
    different source digest) and can never be served that config's cached
    certificate."""
    circ = circ if circ is not None else _TVCircuit(policy)
    memo = memo if memo is not None else {}
    rev = getattr(policy, "_tv_rev_interner", None)
    if rev is None:
        rev = policy.interner.reverse()
        policy._tv_rev_interner = rev  # type: ignore[attr-defined]
    tree_memo: Dict[int, str] = {}
    exprs = policy.config_exprs[row]
    cols = []
    for e in range(len(exprs)):
        has_cond = bool(policy.eval_has_cond[row, e])
        cond_d = _slot_digest(policy, circ, int(policy.eval_cond[row, e]),
                              memo, rev, tree_memo) if has_cond else None
        rule_d = _slot_digest(policy, circ, int(policy.eval_rule[row, e]),
                              memo, rev, tree_memo)
        cond_x, rule_x = exprs[e]
        src_cond = _tree_digest(cond_x, tree_memo) if cond_x is not None \
            else None
        src_rule = _tree_digest(rule_x, tree_memo)
        cols.append((has_cond, cond_d, rule_d, src_cond, src_rule))
    return _sha(repr(("cfg", tuple(cols))))


# ---------------------------------------------------------------------------
# Layer 1 + 2 per config: the certificate
# ---------------------------------------------------------------------------


def _padded_column_findings(policy: CompiledPolicy, row: int,
                            name: str) -> List[Finding]:
    """Padded evaluator columns beyond the real ones must be structurally
    vacuous (TRUE_SLOT, no condition) — the kernel folds them into the same
    ∧ reduction as the real columns.  Deliberately NOT part of the config
    fingerprint (padding widths are corpus-global, not semantic), so
    certify_snapshot re-runs this check on every reconcile, cache hit or
    not — the cache can never mask a padded-column corruption."""
    findings: List[Finding] = []
    for e in range(len(policy.config_exprs[row]),
                   int(policy.eval_rule.shape[1])):
        if int(policy.eval_rule[row, e]) != TRUE_SLOT or \
                bool(policy.eval_has_cond[row, e]):
            findings.append(_err(
                "translation-mismatch",
                f"padded evaluator column {e} is not vacuously true "
                f"(rule slot {int(policy.eval_rule[row, e])}, has_cond="
                f"{bool(policy.eval_has_cond[row, e])})",
                f"{name}/evaluator[{e}]", config=name, evaluator=e))
    return findings


def certify_config(policy: CompiledPolicy, row: int, name: str = "",
                   seed: int = 0, samples: int = SAMPLES_DEFAULT,
                   max_atoms: int = MAX_ATOMS,
                   circ: Optional[_Circuit] = None,
                   dfa_memo: Optional[Dict[tuple, Any]] = None,
                   fp: Optional[str] = None,
                   pad_findings: Optional[List[Finding]] = None,
                   rel_memo: Optional[Dict[int, Any]] = None,
                   ) -> Tuple[Certificate, List[Finding]]:
    """Certify one config row: circuit equivalence against the original
    expression trees + DFA equivalence for every regex leaf it reaches.
    ``pad_findings`` lets certify_snapshot pass its precomputed padded-
    column result instead of re-scanning."""
    circ = circ if circ is not None else _TVCircuit(policy)
    dfa_memo = dfa_memo if dfa_memo is not None else {}
    name = name or next((n for n, g in policy.config_ids.items()
                         if g == row), f"row[{row}]")
    findings: List[Finding] = list(
        pad_findings if pad_findings is not None
        else _padded_column_findings(policy, row, name))
    attr_of = {sel: i for i, sel in enumerate(policy.attr_selectors) if sel}
    exprs = policy.config_exprs[row]

    # atom universe: union of both sides (they differ exactly when the
    # compile is wrong — extra/missing atoms still get assignments)
    smemo: Dict[int, frozenset] = {}
    atoms: Set[tuple] = set()
    slots: List[Tuple[Optional[int], int]] = []
    for e in range(len(exprs)):
        has_cond = bool(policy.eval_has_cond[row, e])
        cond_slot = int(policy.eval_cond[row, e]) if has_cond else None
        rule_slot = int(policy.eval_rule[row, e])
        slots.append((cond_slot, rule_slot))
        atoms |= circ.support(rule_slot, smemo)
        if cond_slot is not None:
            atoms |= circ.support(cond_slot, smemo)
        cond_x, rule_x = exprs[e]
        if cond_x is not None:
            _host_support(policy, attr_of, cond_x, atoms)
        _host_support(policy, attr_of, rule_x, atoms)

    atom_list = sorted(atoms, key=repr)
    n_atoms = len(atom_list)
    if n_atoms <= max_atoms:
        mode, used_seed = "exhaustive", None
        n = 1 << n_atoms
        idx = np.arange(n)
        cols = {a: (idx >> i) & 1 != 0 for i, a in enumerate(atom_list)}
    else:
        # seeded randomized sampling + the two corners; the corners alone
        # kill the most common miscompile shapes (slot redirected to a
        # constant), the samples cover the rest probabilistically
        mode, used_seed = "sampled", seed
        rng = np.random.RandomState(seed)
        n = samples + 2
        mat = np.zeros((n, n_atoms), dtype=bool)
        mat[0] = True
        mat[2:] = rng.randint(0, 2, size=(samples, n_atoms)).astype(bool)
        cols = {a: mat[:, i] for i, a in enumerate(atom_list)}

    vmemo: Dict[int, np.ndarray] = {}
    for e, (cond_slot, rule_slot) in enumerate(slots):
        dev = circ.eval_over(rule_slot, cols, n, vmemo)
        if cond_slot is not None:
            dev = dev | ~circ.eval_over(cond_slot, cols, n, vmemo)
        cond_x, rule_x = exprs[e]
        host = _host_eval(policy, attr_of, rule_x, cols, n)
        if cond_x is not None:
            host = host | ~_host_eval(policy, attr_of, cond_x, cols, n)
        diff = dev != host
        if diff.any():
            w = int(np.nonzero(diff)[0][0])
            witness = {repr(a): bool(cols[a][w])
                       for a in atom_list[:max_atoms]}
            findings.append(_err(
                "translation-mismatch",
                f"compiled circuit decides {bool(dev[w])} but the host "
                f"oracle decides {bool(host[w])} for evaluator {e} "
                f"(mode={mode}, assignment #{w})",
                f"{name}/evaluator[{e}]", config=name, evaluator=e,
                witness=witness, mode=mode))

    # layer 2: every regex-DFA leaf this config's circuit can read; layer
    # 2b: every relation leaf's table column vs its source closure
    all_slots = [s for pair in slots for s in pair if s is not None]
    dfa_rows = 0
    dfa_wit = 0
    dfa_skip = 0
    if rel_memo is None:
        rel_memo = {}
    for leaf in _reachable_leaves(circ, all_slots):
        op = int(policy.leaf_op[leaf])
        if op == OP_RELATION:
            f = _check_relation_leaf(policy, leaf, rel_memo)
        elif op == OP_REGEX_DFA:
            f, w, sk = _check_dfa_leaf(policy, leaf, dfa_memo)
            dfa_rows += 1
            dfa_wit += w
            dfa_skip += sk
        else:
            continue
        # COPY memoized findings before attributing them: the memo entry is
        # shared across configs reaching the same deduped table, and every
        # sharer must report its own name
        findings += [
            Finding(kind=fi.kind, message=fi.message, layer=fi.layer,
                    severity=fi.severity, location=fi.location,
                    detail={**fi.detail, "config": name})
            for fi in f]

    cert = Certificate(
        config=name,
        fingerprint=fp if fp is not None
        else config_fingerprint(policy, row, circ=circ),
        ok=not findings,
        mode=mode, n_atoms=n_atoms, n_assignments=n, seed=used_seed,
        dfa_rows=dfa_rows, dfa_witnesses=dfa_wit, dfa_skipped=dfa_skip,
    )
    return cert, findings


# ---------------------------------------------------------------------------
# Snapshot-level certification + the process-wide fingerprint cache
# ---------------------------------------------------------------------------

_CERT_CACHE: "OrderedDict[str, Certificate]" = OrderedDict()
_CERT_CACHE_MAX = 65536
_CERT_LOCK = threading.Lock()


def clear_certificate_cache() -> None:
    with _CERT_LOCK:
        _CERT_CACHE.clear()


def certificate_cache_len() -> int:
    return len(_CERT_CACHE)


def certify_snapshot(policy: CompiledPolicy, use_cache: bool = True,
                     seed: int = 0, samples: int = SAMPLES_DEFAULT,
                     ) -> Tuple[List[Certificate], List[Finding],
                                Dict[str, int]]:
    """Certify every real config of one compiled corpus.  Unchanged configs
    (same canonical fingerprint) are served from the bounded process-wide
    certificate cache — re-reconciling an unchanged corpus re-validates
    nothing.  Returns (certificates, failures, stats); stats counts are
    also recorded in auth_server_translation_validate_total{result}."""
    from ..utils import metrics as metrics_mod

    circ = _TVCircuit(policy)
    dfa_memo: Dict[tuple, Any] = {}
    rel_memo: Dict[int, Any] = {}
    digest_memo: Dict[int, str] = {}
    certs: List[Certificate] = []
    failures: List[Finding] = []
    stats = {"validated": 0, "cache_hits": 0, "failed": 0, "sampled": 0,
             "dfa_witnesses": 0}
    # numeric-lane binding audit (once per snapshot, never cached: slot
    # layout is corpus-global, not per-config semantic)
    failures += _numeric_lane_findings(policy)
    # fused packed-layout audit: same corpus-global, never-
    # cached treatment — the fused lane is a first-class certified peer
    failures += _fused_layout_findings(policy)
    for name in sorted(policy.config_ids, key=policy.config_ids.get):
        row = policy.config_ids[name]
        fp = config_fingerprint(policy, row, circ=circ, memo=digest_memo)
        # uncached structural check: padding widths are corpus-global, not
        # part of the semantic fingerprint — a corrupted padded column must
        # bypass the certificate cache or it would be served a clean cert
        pad_findings = _padded_column_findings(policy, row, name)
        if use_cache and not pad_findings:
            with _CERT_LOCK:
                hit = _CERT_CACHE.get(fp)
                if hit is not None:
                    _CERT_CACHE.move_to_end(fp)
            if hit is not None and hit.mode == "sampled" and (
                    hit.seed != seed or hit.n_assignments != samples + 2):
                # a sampled cert only vouches for ITS assignment set: a
                # caller asking for different sampling must re-validate
                # (exhaustive certs are parameter-independent)
                hit = None
            if hit is not None:
                cached = Certificate(
                    config=name, fingerprint=fp, ok=True, mode=hit.mode,
                    n_atoms=hit.n_atoms, n_assignments=hit.n_assignments,
                    seed=hit.seed, dfa_rows=hit.dfa_rows,
                    dfa_witnesses=hit.dfa_witnesses,
                    dfa_skipped=hit.dfa_skipped, cached=True)
                certs.append(cached)
                stats["cache_hits"] += 1
                metrics_mod.translation_validate.labels("cache_hit").inc()
                continue
        cert, findings = certify_config(
            policy, row, name=name, seed=seed, samples=samples,
            circ=circ, dfa_memo=dfa_memo, fp=fp, pad_findings=pad_findings,
            rel_memo=rel_memo)
        certs.append(cert)
        failures += findings
        if cert.mode == "sampled":
            stats["sampled"] += 1
        stats["dfa_witnesses"] += cert.dfa_witnesses
        if cert.ok:
            stats["validated"] += 1
            metrics_mod.translation_validate.labels("validated").inc()
            if use_cache:
                with _CERT_LOCK:
                    _CERT_CACHE[fp] = cert
                    _CERT_CACHE.move_to_end(fp)
                    while len(_CERT_CACHE) > _CERT_CACHE_MAX:
                        _CERT_CACHE.popitem(last=False)
        else:
            stats["failed"] += 1
            metrics_mod.translation_validate.labels("failed").inc()
    return certs, failures, stats


# ---------------------------------------------------------------------------
# Layer 3: lowerability report
# ---------------------------------------------------------------------------


def _policies_of(policy: Any) -> List[CompiledPolicy]:
    """Normalize the ``policy`` argument: one CompiledPolicy, a sequence of
    them (mesh shards — each shard compiles its own sub-corpus, so a
    config's CPU-assist leaves live in exactly one shard), or None."""
    if policy is None:
        return []
    if isinstance(policy, CompiledPolicy):
        return [policy]
    return [p for p in policy if p is not None]


def snapshot_policies(snap: Any) -> List[CompiledPolicy]:
    """All compiled policies of an engine ``_Snapshot``-shaped object: the
    single corpus when present, else every mesh shard.  The ONE place the
    snapshot→policies normalization lives (engine strict verify, native
    strict refresh, and bench all route through it)."""
    if snap is None:
        return []
    pol = getattr(snap, "policy", None)
    if pol is not None:
        return [pol]
    return _policies_of(
        getattr(getattr(snap, "sharded", None), "shards", None) or ())


def _classify_rules(policies: List[CompiledPolicy],
                    name: str) -> List[str]:
    """Fast-lane caveat codes from one config's compiled CPU-assist leaves.
    The membership caveat reads the OWNING policy's actual K: a corpus
    whose compact grid is at least MEMBERS_K_SAFE wide (the mesh lane's
    grid relief) is overflow-proof for operational purposes and the caveat
    drops."""
    for policy in policies:
        if name not in policy.config_ids:
            continue
        row = policy.config_ids[name]
        reasons: Set[str] = set()
        for leaf in policy.config_cpu_leaves[row]:
            op = int(policy.leaf_op[leaf])
            if op == OP_TREE_CPU or op == OP_ERROR:
                reasons.add("invalid-regex-fallback")
            elif op == OP_CPU:
                reasons.add("cpu-regex")
            elif op in (OP_INCL, OP_EXCL):
                # the ovf_assist lane answers overflow rows
                # in-kernel from the exact precomputed columns — no host
                # fallback left to caveat
                if int(getattr(policy, "members_k", 0)) < MEMBERS_K_SAFE \
                        and not getattr(policy, "ovf_assist", False):
                    reasons.add("cpu-grid-overflow")
        return sorted(reasons)
    return []


def classify_entry(entry: Any, policy: Any = None,
                   ) -> Tuple[str, List[str]]:
    """(lane, reason codes) for one EngineEntry-shaped object (``rules``
    and optionally ``runtime``).  ``policy`` is one CompiledPolicy or the
    list of mesh shards.  Works with runtime=None (bench/tests): then only
    the compiled surface is classified."""
    rules = getattr(entry, "rules", None)
    runtime = getattr(entry, "runtime", None)
    reasons: List[str] = []
    slow = False
    if rules is None:
        slow = True
        reasons.append("no-authorization-rules")
    prefetched = False
    if runtime is not None:
        md_confs = getattr(runtime, "metadata", None) or ()
        if md_confs:
            # a config whose metadata evaluators ALL serve from the
            # prefetch cache (request-independent documents
            # pinned at reconcile cadence) pays no per-request external
            # fetch — it leaves the slow lane with a visible caveat code
            if all(getattr(m, "prefetchable", False)
                   and getattr(m, "prefetch_pinned", False)
                   for m in md_confs):
                prefetched = True
            else:
                slow = True
                reasons.append("metadata-dependency")
        for az in getattr(runtime, "authorization", ()) or ():
            az_type = getattr(az, "type", "")
            if az_type == "PATTERN_MATCHING":
                continue
            if az_type == "OPA":
                if getattr(az.evaluator, "kernel_slot", None) is None:
                    slow = True
                    if "unsupported-comparator" not in reasons:
                        reasons.append("unsupported-comparator")
            else:
                slow = True
                if "external-authorization" not in reasons:
                    reasons.append("external-authorization")
        # the generic no-compiled-surface code is subsumed by any more
        # specific slow-lane reason
        if "no-authorization-rules" in reasons and len(reasons) > 1:
            reasons.remove("no-authorization-rules")
    if not slow:
        name = getattr(rules, "name", "") or getattr(entry, "id", "")
        reasons = _classify_rules(_policies_of(policy), name)
        if prefetched:
            reasons = sorted(set(reasons) | {"metadata-prefetch"})
    return (LANE_SLOW if slow else LANE_FAST), reasons


def lowerability_report(entries: Sequence[Any], policy: Any = None,
                        max_listed: int = 200) -> Dict[str, Any]:
    """Per-config fast/slow-lane classification with reason codes.
    ``policy`` is one CompiledPolicy or the mesh shard list; ``by_reason``
    counts are complete; the per-config listing is bounded at
    ``max_listed`` (100k-config corpora must not bloat /debug/vars)."""
    out: Dict[str, Any] = {"fast": 0, "slow": 0,
                           "by_reason": {}, "configs": {}, "series": [],
                           "blocking_reasons": {}}
    series: Dict[Tuple[str, str], int] = {}
    blocking: Dict[str, Dict[str, int]] = {}
    policies = _policies_of(policy)
    for entry in entries:
        lane, reasons = classify_entry(entry, policy=policies)
        out[lane] += 1
        for r in reasons or [""]:
            series[(lane, r)] = series.get((lane, r), 0) + 1
        for r in reasons:
            out["by_reason"][r] = out["by_reason"].get(r, 0) + 1
        if lane == LANE_SLOW:
            # per-reason would-be-fast-if-fixed rollup: "sole_blocker"
            # counts configs this reason ALONE exiles — fixing it moves
            # exactly that many to the fast lane;
            # "configs" counts every slow config carrying it, so progress
            # on one reason is visible per corpus even when multi-blocked
            for r in reasons:
                b = blocking.setdefault(r, {"configs": 0, "sole_blocker": 0})
                b["configs"] += 1
                if len(reasons) == 1:
                    b["sole_blocker"] += 1
        if len(out["configs"]) < max_listed:
            cfg_id = getattr(entry, "id", None) or getattr(
                getattr(entry, "rules", None), "name", "?")
            out["configs"][str(cfg_id)] = {"lane": lane, "reasons": reasons}
        else:
            out["truncated"] = True
    # JSON-safe (lane, reason, count) triples — the per-reconcile
    # increments for auth_server_lowerability_configs_total{lane,reason}
    out["series"] = [[lane, r, n] for (lane, r), n in sorted(series.items())]
    out["blocking_reasons"] = {r: blocking[r] for r in sorted(blocking)}
    return out


# ---------------------------------------------------------------------------
# Mutation self-test: prove the validator is not blind
# ---------------------------------------------------------------------------


def _mut_circuit_child_flip(p: CompiledPolicy) -> None:
    """Redirect the first real node's first child to a constant slot."""
    ch0, is_and0 = p.levels[0]
    ch0 = ch0.copy()
    ch0[0, 0] = TRUE_SLOT if int(ch0[0, 0]) != TRUE_SLOT else FALSE_SLOT
    p.levels = ((ch0, is_and0),) + p.levels[1:]


def _mut_eval_rule_redirect(p: CompiledPolicy) -> None:
    """Point a config's rule slot at constant TRUE (vacuous verdict)."""
    p.eval_rule = p.eval_rule.copy()
    for g in range(p.eval_rule.shape[0]):
        for e in range(len(p.config_exprs[g]) if g < len(p.config_exprs)
                       else 0):
            if int(p.eval_rule[g, e]) != TRUE_SLOT:
                p.eval_rule[g, e] = TRUE_SLOT
                return
    raise AssertionError("no non-trivial rule slot to redirect")


def _mut_leaf_attr_swap(p: CompiledPolicy) -> None:
    """Swap the attrs of two comparison leaves reading different attrs."""
    p.leaf_attr = p.leaf_attr.copy()
    idxs = [i for i in range(p.n_leaves)
            if int(p.leaf_op[i]) in (OP_EQ, OP_NEQ, OP_INCL, OP_EXCL)
            and int(p.leaf_const[i]) >= 0]
    for a in idxs:
        for b in idxs:
            if int(p.leaf_attr[a]) != int(p.leaf_attr[b]):
                p.leaf_attr[a], p.leaf_attr[b] = \
                    int(p.leaf_attr[b]), int(p.leaf_attr[a])
                return
    raise AssertionError("no leaf pair with distinct attrs")


def _mut_leaf_const_swap(p: CompiledPolicy) -> None:
    """Rebind a comparison leaf to a different interned constant."""
    p.leaf_const = p.leaf_const.copy()
    ids = sorted({int(c) for c in p.leaf_const if int(c) > 0})
    for i in range(p.n_leaves):
        if int(p.leaf_op[i]) in (OP_EQ, OP_NEQ, OP_INCL, OP_EXCL):
            cur = int(p.leaf_const[i])
            other = next((x for x in ids if x != cur), None)
            if other is None:
                other = cur + 1  # a fresh id: matches a different string
            p.leaf_const[i] = other
            return
    raise AssertionError("no comparison leaf to rebind")


def _mut_dfa_transition(p: CompiledPolicy) -> None:
    """Redirect one mid-pattern transition to a different state."""
    if p.n_byte_attrs == 0 or p.dfa_tables.shape[0] == 0:
        raise AssertionError("corpus has no DFA tables")
    p.dfa_tables = p.dfa_tables.copy()
    S = p.dfa_tables.shape[1]
    t = p.dfa_tables[0]
    for s in range(S):
        for b in range(0x20, 0x7F):
            cur = int(t[s, b])
            if cur != s:  # a real (non-self-loop) transition
                t[s, b] = (cur + 1) % S
                return
    raise AssertionError("no redirectable transition found")


def _mut_dfa_accept_flip(p: CompiledPolicy) -> None:
    if p.n_byte_attrs == 0:
        # no leaf references any table: flipping the padded dummy's accept
        # bit would be a semantic no-op that FALSELY reads as blindness
        raise AssertionError("corpus has no DFA lane")
    p.dfa_accept = p.dfa_accept.copy()
    p.dfa_accept[0, 0] = not bool(p.dfa_accept[0, 0])


def _mut_dfa_pad_corrupt(p: CompiledPolicy) -> None:
    """Break the NUL-pad identity column the byte-trim machinery assumes."""
    if p.n_byte_attrs == 0:
        raise AssertionError("corpus has no DFA lane")
    S = p.dfa_tables.shape[1]
    if S <= 1:
        raise AssertionError("single-state table: pad corrupt is identity")
    p.dfa_tables = p.dfa_tables.copy()
    p.dfa_tables[0, 0, 0] = 1


def _mut_fused_perm_corrupt(p: CompiledPolicy) -> None:
    """Duplicate one entry of the fused DFA row permutation (no longer a
    bijection: one row evaluates twice, another never)."""
    if p.dfa_row_perm is None or p.dfa_row_perm.shape[0] < 2:
        raise AssertionError("corpus has fewer than two DFA rows")
    p.dfa_row_perm = p.dfa_row_perm.copy()
    p.dfa_row_perm[0] = p.dfa_row_perm[1]


def _mut_fused_int8_corrupt(p: CompiledPolicy) -> None:
    """Nudge one packed int8 op code so it no longer mirrors leaf_op (the
    affected leaf routes through the wrong comparison in the fused lane
    only — invisible to every unfused check)."""
    if p.leaf_op_i8 is None or p.leaf_op_i8.shape[0] == 0:
        raise AssertionError("corpus has no leaves")
    p.leaf_op_i8 = p.leaf_op_i8.copy()
    p.leaf_op_i8[0] += 1


def _mut_fused_packw_corrupt(p: CompiledPolicy) -> None:
    """Grow the in-kernel bitpack width by one byte: the readback the
    dispatchers decode no longer matches packed_width(1+2E)."""
    p.fused_pack_w = int(p.fused_pack_w) + 1


_MUTANTS = (
    ("circuit-child-flip", _mut_circuit_child_flip),
    ("eval-rule-redirect", _mut_eval_rule_redirect),
    ("leaf-attr-swap", _mut_leaf_attr_swap),
    ("leaf-const-swap", _mut_leaf_const_swap),
    ("dfa-transition-corrupt", _mut_dfa_transition),
    ("dfa-accept-flip", _mut_dfa_accept_flip),
    ("dfa-pad-corrupt", _mut_dfa_pad_corrupt),
    # fused packed-layout classes (caught by
    # _fused_layout_findings, not the truth-table layer)
    ("fused-perm-corrupt", _mut_fused_perm_corrupt),
    ("fused-int8-corrupt", _mut_fused_int8_corrupt),
    ("fused-packw-corrupt", _mut_fused_packw_corrupt),
)


# --- mutation classes: relation tables + numeric encoders --------


def _referenced_rel_leaves(p: CompiledPolicy) -> List[int]:
    return [i for i in range(p.n_leaves)
            if int(p.leaf_op[i]) == OP_RELATION]


def _mut_relation_bit_flip(p: CompiledPolicy) -> None:
    """Flip one closure bit in a column a relation leaf actually reads —
    invisible to the truth-table layer, MUST be caught by the relation
    witness check."""
    leaves = _referenced_rel_leaves(p)
    if not leaves or p.rel_bits is None:
        raise AssertionError("corpus has no relation lane")
    col = int(p.leaf_rel_col[leaves[0]])
    inst, _group = p.rel_col_names[col]
    rows = list(p.rel_entity_rows[inst].values())
    if not rows:
        raise AssertionError("relation instance has no entities")
    p.rel_bits = p.rel_bits.copy()
    p.rel_bits[rows[0], col >> 3] ^= np.uint8(1 << (col & 7))


def _mut_relation_col_redirect(p: CompiledPolicy) -> None:
    """Rebind a relation leaf to a DIFFERENT queried column (another
    group's): the leaf then answers the wrong membership question."""
    leaves = _referenced_rel_leaves(p)
    for leaf in leaves:
        cur = int(p.leaf_rel_col[leaf])
        other = next((c for c in range(len(p.rel_col_names or ()))
                      if c != cur), None)
        if other is not None:
            p.leaf_rel_col = p.leaf_rel_col.copy()
            p.leaf_rel_col[leaf] = other
            return
    raise AssertionError("corpus has fewer than two relation columns")


def _mut_numeric_const(p: CompiledPolicy) -> None:
    """Shift a numeric leaf's folded constant by one (off-by-one boundary
    miscompile — the classic numeric-encoder bug)."""
    for i in range(p.n_leaves):
        if int(p.leaf_op[i]) in NUMERIC_OPS:
            p.leaf_const = p.leaf_const.copy()
            p.leaf_const[i] = int(p.leaf_const[i]) + 1
            return
    raise AssertionError("corpus has no numeric leaf")


def _mut_numeric_op_flip(p: CompiledPolicy) -> None:
    """GT↔GE (strictness flip): the boundary value decides differently."""
    for i in range(p.n_leaves):
        op = int(p.leaf_op[i])
        if op in NUMERIC_OPS:
            p.leaf_op = p.leaf_op.copy()
            p.leaf_op[i] = {OP_NUM_GT: OP_NUM_GE, OP_NUM_GE: OP_NUM_GT,
                            OP_NUM_LT: OP_NUM_LE, OP_NUM_LE: OP_NUM_LT}[op]
            return
    raise AssertionError("corpus has no numeric leaf")


def _mut_numeric_slot_collision(p: CompiledPolicy) -> None:
    """Two numeric attrs sharing one value slot: the encoder overwrites
    one attr's value with the other's — invisible to the truth table,
    MUST be caught by the numeric-lane binding audit."""
    attrs = [a for a in (p.num_attrs.tolist() if p.num_attrs is not None
                         else [])]
    if len(attrs) < 2:
        raise AssertionError("corpus has fewer than two numeric attrs")
    p.num_attr_slot = p.num_attr_slot.copy()
    p.num_attr_slot[attrs[1]] = int(p.num_attr_slot[attrs[0]])


_RELATION_MUTANTS = (
    ("relation-bit-flip", _mut_relation_bit_flip),
    ("relation-col-redirect", _mut_relation_col_redirect),
    ("numeric-const-corrupt", _mut_numeric_const),
    ("numeric-op-flip", _mut_numeric_op_flip),
    ("numeric-slot-collision", _mut_numeric_slot_collision),
)


def _run_mutants(base: CompiledPolicy, mutants,
                 location: str) -> List[Finding]:
    from copy import deepcopy

    out: List[Finding] = []
    _, clean_failures, _ = certify_snapshot(base, use_cache=False)
    if clean_failures:
        out.append(_err(
            "self-test",
            f"clean fixture corpus failed certification: "
            f"{clean_failures[0]}", location))
    for mname, mutate in mutants:
        mutant = deepcopy(base)
        try:
            mutate(mutant)
        except Exception as e:
            # planters raise AssertionError when a corpus lacks their
            # target structure, but ANY planter failure (e.g. IndexError
            # on a node-less circuit) must surface as a finding, not
            # crash the self-test
            out.append(_err(
                "validator-blind",
                f"mutant {mname!r} could not be planted: {e!r}",
                location, mutant=mname))
            continue
        _, failures, _ = certify_snapshot(mutant, use_cache=False)
        if not failures:
            out.append(_err(
                "validator-blind",
                f"planted miscompile {mname!r} certified CLEAN — the "
                "translation validator is blind to this class",
                location, mutant=mname))
    return out


def mutation_self_test(policy: Optional[CompiledPolicy] = None,
                       ) -> List[Finding]:
    """Plant one miscompile per class into the fixture corpus and demand
    the validator rejects every one (and passes the clean corpus).  A
    mutant that certifies clean is a ``validator-blind`` ERROR — wire this
    into CI and --verify-fixtures so the validator can never silently rot."""
    from .fixtures import fixture_policy

    base = policy if policy is not None else fixture_policy()
    return _run_mutants(base, _MUTANTS, "mutation_self_test")


def relations_mutation_self_test(policy: Optional[CompiledPolicy] = None,
                                 ) -> List[Finding]:
    """Twin of mutation_self_test over the relations fixture
    corpus: hierarchy-closure and numeric-encoder miscompile classes —
    flipped closure bits, redirected group columns, off-by-one constants,
    strictness flips, and value-slot collisions — must ALL be rejected."""
    from .fixtures import relations_fixture_policy

    base = policy if policy is not None else relations_fixture_policy()
    return _run_mutants(base, _RELATION_MUTANTS,
                        "relations_mutation_self_test")
