"""Cedar-style semantic analysis over the compiled boolean circuits.

The compiler lowers every AuthConfig's pattern rules into one shared circuit
(compiler/compile.py); that makes reconcile-time *semantic* questions cheap:
a rule that can never deny, a rule that can never allow, a rule that an
earlier always-denying rule makes unreachable — all decidable by bounded
evaluation over the circuit's operand support, before the config ever serves
traffic (the Cedar thesis: analyzability is a first-class property of an
authorization language, PAPERS.md).

Atom model (soundness): every leaf becomes a free boolean *atom*, except
that complementary op pairs share one atom with opposite polarity —
eq/neq on the same (attr, const) and incl/excl on the same (attr, const)
are exact negations in both the kernel and the reference semantics, and
OP_ERROR leaves (invalid regex → error → deny) are constant False.  Deeper
value semantics (two eq leaves on one attr with different constants are
mutually exclusive) are NOT modeled: a reported constant-allow /
constant-deny is therefore always real, but some value-level constants go
unreported.  Findings are advisory warnings, never gates.

Finding kinds (catalogue: docs/static_analysis.md):

  constant-allow   an evaluator's contribution (¬cond ∨ rule) is a
                   tautology: the rule can never deny a request (vacuous)
  constant-deny    the contribution is unsatisfiable: every request this
                   config matches is denied by this one evaluator
  shadowed-rule    an evaluator after a constant-deny one in the same
                   config: its outcome can never affect the verdict
  duplicate-rule   an evaluator structurally identical (same compiled
                   cond/rule slots) to an earlier one in the same config
  duplicate-host   a host routed to more than one AuthConfig entry
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..compiler.compile import (
    FALSE_SLOT,
    NUMERIC_OPS,
    OP_CPU,
    OP_EQ,
    OP_ERROR,
    OP_EXCL,
    OP_INCL,
    OP_NEQ,
    OP_REGEX_DFA,
    OP_RELATION,
    TRUE_SLOT,
    CompiledPolicy,
)
from . import Finding

__all__ = ["analyze_policy", "analyze_hosts", "analyze_snapshot",
           "MAX_ATOMS"]

_LAYER = "policy_analysis"

# bounded evaluation: 2^MAX_ATOMS assignments, vectorized — 14 atoms is
# 16384 rows through a few dozen numpy ops, sub-ms per evaluator.  Rules
# with a wider support are skipped (counted in the summary), keeping the
# whole corpus pass linear in practice.
MAX_ATOMS = 14


def _warn(kind: str, message: str, location: str = "", **detail) -> Finding:
    return Finding(kind=kind, message=message, layer=_LAYER,
                   severity="warning", location=location, detail=detail)


class _Circuit:
    """Host-side view of the compiled circuit: buffer slot → node."""

    def __init__(self, policy: CompiledPolicy):
        self.policy = policy
        self.leaf_base = 2
        self.node_of: Dict[int, Tuple[bool, Tuple[int, ...]]] = {}
        cursor = self.leaf_base + policy.n_leaves
        for children, is_and in policy.levels:
            for r in range(children.shape[0]):
                self.node_of[cursor + r] = (
                    bool(is_and[r]), tuple(int(c) for c in children[r]))
            cursor += int(children.shape[0])

    def leaf_atom(self, leaf: int) -> Tuple[Optional[tuple], bool, Optional[bool]]:
        """(atom key, negated, constant) for one leaf slot.  Exactly one of
        atom/constant is non-None."""
        p = self.policy
        op = int(p.leaf_op[leaf])
        attr = int(p.leaf_attr[leaf])
        const = int(p.leaf_const[leaf])
        if op == OP_ERROR:
            return None, False, False   # invalid regex: error ⇒ deny
        if op in (OP_EQ, OP_NEQ):
            return ("v", attr, const), op == OP_NEQ, None
        if op in (OP_INCL, OP_EXCL):
            return ("m", attr, const), op == OP_EXCL, None
        if op in (OP_CPU, OP_REGEX_DFA):
            rx = p.leaf_regex[leaf]
            return ("r", attr, rx.pattern if rx is not None else leaf), \
                False, None
        if op in NUMERIC_OPS:
            # one free atom per (numeric op, attr, folded const): ge/lt are
            # NOT complements (a non-integer value makes all four False),
            # and order relations between constants are not modeled —
            # sound-not-complete, like the rest of the atom model
            return ("n", op, attr, const), False, None
        if op == OP_RELATION:
            # (attr, closure digest, group): two leaves share an atom iff
            # they query the same group of the same closed relation on the
            # same selector — mirrored by the host side's InGroup key
            col = int(p.leaf_rel_col[leaf])
            if p.rel_col_names is not None and 0 <= col < len(p.rel_col_names):
                inst, group = p.rel_col_names[col]
                digest = p.rel_instances[inst].digest \
                    if 0 <= inst < len(p.rel_instances) else f"<inst:{inst}>"
            else:
                digest, group = f"<col:{col}>", ""
            return ("G", attr, digest, group), False, None
        return ("t", leaf), False, None  # OP_TREE_CPU: opaque per-leaf atom

    def support(self, buf: int, memo: Dict[int, frozenset]) -> frozenset:
        """Atom keys reachable from one buffer slot."""
        hit = memo.get(buf)
        if hit is not None:
            return hit
        if buf in (TRUE_SLOT, FALSE_SLOT):
            s: frozenset = frozenset()
        elif buf < self.leaf_base + self.policy.n_leaves:
            atom, _, _ = self.leaf_atom(buf - self.leaf_base)
            s = frozenset() if atom is None else frozenset((atom,))
        else:
            is_and, kids = self.node_of[buf]
            s = frozenset().union(
                *(self.support(k, memo) for k in set(kids)))
        memo[buf] = s
        return s

    def eval_over(self, buf: int, cols: Dict[tuple, np.ndarray], n: int,
                  memo: Dict[int, np.ndarray]) -> np.ndarray:
        """Truth column [n] of one buffer slot over the assignment matrix."""
        hit = memo.get(buf)
        if hit is not None:
            return hit
        if buf == TRUE_SLOT:
            v = np.ones(n, dtype=bool)
        elif buf == FALSE_SLOT:
            v = np.zeros(n, dtype=bool)
        elif buf < self.leaf_base + self.policy.n_leaves:
            atom, neg, const = self.leaf_atom(buf - self.leaf_base)
            if atom is None:
                v = np.full(n, bool(const))
            else:
                v = ~cols[atom] if neg else cols[atom]
        else:
            is_and, kids = self.node_of[buf]
            acc = None
            for k in set(kids):
                kv = self.eval_over(k, cols, n, memo)
                acc = kv if acc is None else (
                    (acc & kv) if is_and else (acc | kv))
            v = acc if acc is not None else np.full(n, is_and)
        memo[buf] = v
        return v


def _classify(circ: _Circuit, cond: Optional[int], rule: int,
              smemo: Dict[int, frozenset]) -> Tuple[Optional[str], int]:
    """('constant-allow' | 'constant-deny' | None, n_atoms) for one
    evaluator's contribution (¬cond ∨ rule — skipped evaluators pass,
    ref pkg/service/auth_pipeline.go:307-318).  ``smemo`` is the
    caller-shared support memo: support() is a pure function of the
    circuit, and the compiler dedups And/Or nodes ACROSS configs, so
    per-evaluator memos would re-walk every shared subtree."""
    atoms = sorted(circ.support(rule, smemo)
                   | (circ.support(cond, smemo) if cond is not None
                      else frozenset()))
    n_atoms = len(atoms)
    if n_atoms > MAX_ATOMS:
        return None, n_atoms
    n = 1 << n_atoms
    idx = np.arange(n)
    cols = {a: (idx >> i) & 1 != 0 for i, a in enumerate(atoms)}
    vmemo: Dict[int, np.ndarray] = {}
    contrib = circ.eval_over(rule, cols, n, vmemo)
    if cond is not None:
        contrib = contrib | ~circ.eval_over(cond, cols, n, vmemo)
    if contrib.all():
        return "constant-allow", n_atoms
    if not contrib.any():
        return "constant-deny", n_atoms
    return None, n_atoms


def analyze_policy(policy: Optional[CompiledPolicy],
                   max_findings: int = 200) -> Tuple[List[Finding], Dict[str, Any]]:
    """Semantic findings + summary for one compiled corpus.  Runs once per
    reconcile (never per request); bounded evaluation keeps it linear in
    evaluators."""
    findings: List[Finding] = []
    # ``skipped`` lists every wide-support skip (config/evaluator/atom
    # count, bounded) so skipped rules are visible on /debug/vars and in
    # auth_server_policy_analysis_skipped_total instead of silently
    # dropping out of the analysis with only an aggregate count
    summary: Dict[str, Any] = {"evaluators": 0, "skipped_wide": 0,
                               "configs": 0, "skipped": []}
    if policy is None:
        return findings, summary
    circ = _Circuit(policy)
    smemo: Dict[int, frozenset] = {}  # shared: circuit-pure, see _classify
    names = sorted(policy.config_ids, key=policy.config_ids.get)
    summary["configs"] = len(names)
    for name in names:
        g = policy.config_ids[name]
        n_real = len(policy.config_exprs[g])
        deny_at: Optional[int] = None
        seen: Dict[Tuple[int, int, bool], int] = {}
        for e in range(n_real):
            if len(findings) >= max_findings:
                summary["truncated"] = True
                return findings, summary
            summary["evaluators"] += 1
            has_cond = bool(policy.eval_has_cond[g, e])
            cond = int(policy.eval_cond[g, e]) if has_cond else None
            rule = int(policy.eval_rule[g, e])
            loc = f"{name}/evaluator[{e}]"
            key = (cond if cond is not None else -1, rule, has_cond)
            prev = seen.get(key)
            if prev is not None:
                findings.append(_warn(
                    "duplicate-rule",
                    f"evaluator {e} compiles to the same circuit as "
                    f"evaluator {prev} (redundant rule)", loc,
                    config=name, evaluator=e, duplicate_of=prev))
            else:
                seen[key] = e
            if deny_at is not None:
                findings.append(_warn(
                    "shadowed-rule",
                    f"evaluator {e} is shadowed: evaluator {deny_at} "
                    "always denies, so this rule's outcome can never "
                    "affect the verdict", loc,
                    config=name, evaluator=e, shadowed_by=deny_at))
                continue
            verdict, n_atoms = _classify(circ, cond, rule, smemo)
            if verdict is None and n_atoms > MAX_ATOMS:
                summary["skipped_wide"] += 1
                if len(summary["skipped"]) < 100:
                    summary["skipped"].append(
                        {"config": name, "evaluator": e, "atoms": n_atoms})
            elif verdict == "constant-allow":
                findings.append(_warn(
                    "constant-allow",
                    "rule is a tautology over its operand support: it can "
                    "never deny a request (vacuous evaluator)", loc,
                    config=name, evaluator=e))
            elif verdict == "constant-deny":
                findings.append(_warn(
                    "constant-deny",
                    "rule is unsatisfiable over its operand support: every "
                    "request matching this config is denied here", loc,
                    config=name, evaluator=e))
                deny_at = e
    return findings, summary


def analyze_hosts(entries: Sequence[Any]) -> List[Finding]:
    """Hosts routed to more than one AuthConfig: the index resolves the
    collision by override order, which is an operator surprise, never a
    request-time choice (ref controllers/auth_config_controller.go
    hostTaken)."""
    findings: List[Finding] = []
    owners: Dict[str, List[str]] = {}
    for entry in entries:
        for host in getattr(entry, "hosts", ()) or ():
            owners.setdefault(host, []).append(entry.id)
    for host, ids in owners.items():
        distinct = sorted(set(ids))
        if len(distinct) > 1:
            findings.append(_warn(
                "duplicate-host",
                f"host {host!r} is routed to {len(distinct)} AuthConfigs "
                f"({', '.join(distinct)}): only the index winner serves it",
                f"host:{host}", config=distinct[0], host=host,
                configs=distinct))
    return findings


def analyze_snapshot(entries: Sequence[Any],
                     policy: Optional[CompiledPolicy],
                     sharded: Any = None) -> Tuple[List[Finding], Dict[str, Any]]:
    """Full reconcile-time pass: host routing over the raw entries plus
    circuit analysis of the compiled corpus (each shard's on a mesh)."""
    findings = analyze_hosts(entries)
    summary: Dict[str, Any] = {}
    if policy is not None:
        f, summary = analyze_policy(policy)
        findings += f
    elif sharded is not None:
        summary = {"evaluators": 0, "skipped_wide": 0, "configs": 0,
                   "skipped": []}
        for shard in getattr(sharded, "shards", ()):
            f, s = analyze_policy(shard)
            findings += f
            for k in ("evaluators", "skipped_wide", "configs"):
                summary[k] += s.get(k, 0)
            summary["skipped"] += s.get("skipped", [])[
                : max(0, 100 - len(summary["skipped"]))]
    return findings, summary
