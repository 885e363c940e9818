"""Coverage analysis + truth-table row synthesis (layer 2).

Coverage: the corpus's fired set — (authconfig, firing evaluator column)
pairs its rows attribute under the provenance semantics — against every registered
rule column, cross-referenced with the static findings (a
constant-allow rule CANNOT fire) so the unexercised set separates
"needs a synthesized witness" from "statically impossible".

Synthesis inverts the bounded atom model: for a target evaluator
``e`` of config ``g`` it enumerates the 2^n truth assignments over the
union atom support of evaluators 0..e (``policy_analysis._Circuit``, the
Cedar-style bounded symbolic evaluation), keeps the assignments where
evaluators 0..e-1 contribute true and e's condition holds while its rule
fails — exactly the assignments that make e the *first-false* attributed
column — and materializes one into a concrete request document:

- equality atoms     → the interned constant string (or a fresh unseen
                       string to falsify every value atom on the attr);
- membership atoms   → a list of exactly the desired member constants;
- regex atoms        → accept/reject witnesses from the DFA witness
                       machinery (``_table_witnesses``) when the leaf
                       compiled to the device lane, pattern-derived
                       candidates otherwise;
- numeric atoms      → boundary values of the satisfying integer interval
                       (the int lanes), or a non-integer string to
                       falsify all four comparators at once;
- relation atoms     → a closure-table entity whose group memberships
                       match the assignment (an unknown entity falsifies
                       every group atom).

Sound, not complete: every synthesized document is VERIFIED through the
host oracle (``host_results`` + ``firing_columns``) before it is
admitted — a doc that does not make the target the first-false column is
discarded.  Rules no assignment or materialization can cover are reported
with a typed reason code from :data:`SYNTH_REASONS`, never silently
skipped.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .store import CORPUS_SCHEMA

__all__ = ["SYNTH_REASONS", "coverage_report", "synthesize_rows",
           "augment_corpus"]

# typed uncoverability reason codes (docs/policy_ci.md "Synthesis reason
# codes") — the full vocabulary, pinned so reports are machine-stable
SYNTH_REASONS = (
    "atom-budget-exceeded",    # union support of evaluators 0..e > MAX_ATOMS
    "statically-dead",         # already proved the column cannot fire
    "unsatisfiable",           # no assignment makes e the first-false column
    "unsupported-selector",    # a support attr's selector is not a plain
                               # dot-path this materializer can set
    "selector-conflict",       # two support selectors collide (one a prefix
                               # of another) so no document carries both
    "opaque-cpu-tree",         # assignments hinge on OP_TREE_CPU atoms the
                               # materializer cannot steer
    "materialization-failed",  # candidates existed but none verified
)

# bounded search: how many candidate assignments to materialize+verify
# before giving up on a target column
_MAX_TRIES = 24


# ---------------------------------------------------------------------------
# coverage
# ---------------------------------------------------------------------------


def coverage_report(policy: Any, rows: Sequence[Dict[str, Any]],
                    analysis: Optional[Dict[str, Any]] = None,
                    lowerability: Optional[Dict[str, Any]] = None,
                    ) -> Dict[str, Any]:
    """Per-(config, rule, evaluator-column) exercised/unexercised coverage
    of ``rows`` over ``policy``, cross-referenced against the
    findings (``analysis`` = the /debug/vars policy_analysis block) and
    the lowerability report (per-config lane + reasons)."""
    fired: Dict[str, set] = {}
    allow_seen: Dict[str, int] = {}
    for r in rows:
        name = r.get("authconfig")
        if not name:
            continue
        if r.get("verdict") == "deny":
            fired.setdefault(name, set()).add(int(r.get("rule_index", -1)))
        else:
            allow_seen[name] = allow_seen.get(name, 0) + 1
    static_by_rule: Dict[Tuple[str, int], List[str]] = {}
    for f in (analysis or {}).get("findings", []):
        kind = f.get("kind", "")
        if kind in ("constant-allow", "shadowed-rule"):
            d = f.get("detail") or {}
            ev = d.get("evaluator")
            if ev is not None:
                static_by_rule.setdefault(
                    (str(d.get("config", "")), int(ev)), []).append(kind)
    lower_cfg = (lowerability or {}).get("configs") or {}
    sources = policy.rule_sources()
    configs: Dict[str, Any] = {}
    total = exercised = 0
    for name, g in sorted(policy.config_ids.items()):
        n_real = len(policy.config_exprs[g])
        cols = []
        cfg_fired = fired.get(name, set())
        for e in range(n_real):
            total += 1
            hit = e in cfg_fired
            exercised += int(hit)
            cols.append({
                "evaluator": e,
                "rule": sources[g][e] if e < len(sources[g]) else "",
                "exercised": hit,
                "static_findings": static_by_rule.get((name, e), []),
            })
        entry: Dict[str, Any] = {
            "evaluators": n_real,
            "columns": cols,
            "unexercised": [c["evaluator"] for c in cols
                            if not c["exercised"]],
            "allow_rows": allow_seen.get(name, 0),
        }
        li = lower_cfg.get(name)
        if li:
            entry["lane"] = li.get("lane")
            entry["lowerability_reasons"] = li.get("reasons", [])
        configs[name] = entry
    return {
        "configs": configs,
        "columns_total": total,
        "columns_exercised": exercised,
        "fraction": round(exercised / total, 4) if total else 1.0,
    }


# ---------------------------------------------------------------------------
# materialization helpers
# ---------------------------------------------------------------------------

_PLAIN_SEG = __import__("re").compile(r"^[A-Za-z_][A-Za-z0-9_\-]*$")

# a string no corpus interner contains (NUL is unreachable through the
# JSON frontends) — falsifies every value/membership atom on its attr
_UNSEEN = "\x00unseen"


def _set_path(doc: Dict[str, Any], selector: str, value: Any) -> str:
    """Set ``value`` at the dot-path ``selector`` inside ``doc``.  Returns
    "" on success or a SYNTH_REASONS code on failure."""
    segs = selector.split(".")
    if not segs or any(not _PLAIN_SEG.match(s) for s in segs):
        return "unsupported-selector"
    cur = doc
    for s in segs[:-1]:
        nxt = cur.get(s)
        if nxt is None:
            nxt = cur[s] = {}
        elif not isinstance(nxt, dict):
            return "selector-conflict"
        cur = nxt
    leaf = segs[-1]
    if isinstance(cur.get(leaf), dict):
        return "selector-conflict"
    cur[leaf] = value
    return ""


class _AttrPlan:
    """Accumulated per-attr constraints for one candidate assignment."""

    def __init__(self) -> None:
        self.eq_true: List[int] = []
        self.eq_false: List[int] = []
        self.mem_true: List[int] = []
        self.mem_false: List[int] = []
        self.rx: List[Tuple[Any, bool, Optional[int]]] = []  # (rx, want, leaf)
        self.num: List[Tuple[int, int, bool]] = []           # (op, const, want)
        self.rel: List[Tuple[str, str, bool]] = []           # (digest, grp, want)


def _regex_candidates(policy: Any, rx: Any, leaf: Optional[int],
                      want: bool) -> List[str]:
    """Witness candidates for one regex atom: DFA-derived strings when the
    leaf compiled to the device lane (the witness machinery —
    reaching + accepting/rejecting extensions per state), pattern-derived
    heuristics otherwise.  Candidates are CHECKED by the caller with
    ``rx.search``; wrong guesses cost a try, never soundness."""
    from ..compiler.compile import OP_REGEX_DFA

    out: List[str] = []
    if leaf is not None and int(policy.leaf_op[leaf]) == OP_REGEX_DFA \
            and policy.dfa_tables is not None and policy.dfa_tables.size:
        from ..analysis.translation_validate import _table_witnesses

        row = int(policy.leaf_dfa_row[leaf])
        if 0 <= row < policy.dfa_table_of_row.shape[0]:
            t = int(policy.dfa_table_of_row[row])
            wits, _ = _table_witnesses(policy.dfa_tables[t],
                                       policy.dfa_accept[t])
            for w in wits:
                try:
                    out.append(w.decode("utf-8"))
                except UnicodeDecodeError:
                    continue
    # pattern-derived heuristics: strip anchors, resolve the common
    # wildcard tails — cheap guesses the rx.search filter vets
    pat = rx.pattern
    lit = pat.strip("^$")
    for repl in ("a", "x", "0", ""):
        out.append(lit.replace(".*", repl).replace(".+", repl or "a")
                   .replace("\\", ""))
    out += ["", "a", "zz", "\x01\x01", "no-match-\x00"]
    return out


def _value_for_attr(policy: Any, plan: _AttrPlan) -> Tuple[bool, Any]:
    """(ok, value) satisfying every constraint in ``plan`` — best-effort:
    the host-oracle verification is the soundness gate, this only has to
    be right often enough that a few tries converge."""
    rev = policy.interner.reverse()

    def _check_str(v: str) -> bool:
        from ..expressions.ast import parse_int_value

        vid = policy.interner.lookup(v)
        for c in plan.eq_true:
            if vid != c:
                return False
        for c in plan.eq_false:
            if vid == c:
                return False
        for c in plan.mem_true:          # scalar attr: members == [v]
            if vid != c:
                return False
        for c in plan.mem_false:
            if vid == c:
                return False
        for rx, want, _leaf in plan.rx:
            if bool(rx.search(v)) != want:
                return False
        iv = parse_int_value(v)
        for op, c, want in plan.num:
            if _num_truth(op, iv, c) != want:
                return False
        return True

    if len(set(plan.eq_true)) > 1:
        return False, None               # one value equals at most one const
    if plan.eq_true:
        v = rev.get(plan.eq_true[0])
        if v is None:
            return False, None
        ok = _check_str(v) and not plan.rel
        return ok, v
    if plan.mem_true:
        # a list attr: exactly the desired member constants, none of the
        # undesired ones (distinct interned ids guarantee exclusion)
        if set(plan.mem_true) & set(plan.mem_false):
            return False, None
        vals = [rev.get(c) for c in sorted(set(plan.mem_true))]
        if any(v is None for v in vals):
            return False, None
        # numeric/regex/eq atoms on a list attr see the RENDERED value;
        # desired-true ones are out of this materializer's reach
        if any(want for _, want, _ in plan.rx) \
                or any(want for *_, want in [(0, 0, w) for _, _, w in plan.num] if want):
            return False, None
        return (not plan.rel), vals
    if plan.rel:
        return _relation_entity(policy, plan, _check_str)
    if plan.num:
        ok, v = _numeric_value(plan)
        if ok and _check_str(v):
            return True, v
        return False, None
    if plan.rx:
        want_order = sorted(plan.rx, key=lambda t: not t[1])
        for rx, want, leaf in want_order:
            for cand in _regex_candidates(policy, rx, leaf, want):
                if len(cand) <= 256 and _check_str(cand):
                    return True, cand
        return False, None
    # only negative value/membership constraints: a fresh unseen string
    if _check_str(_UNSEEN):
        return True, _UNSEEN
    return False, None


def _num_truth(op: int, value: Optional[int], const: int) -> bool:
    from ..compiler.compile import OP_NUM_GE, OP_NUM_GT, OP_NUM_LE, OP_NUM_LT

    if value is None:
        return False                     # non-integer: all four comparators
    return {OP_NUM_GT: value > const, OP_NUM_GE: value >= const,
            OP_NUM_LT: value < const, OP_NUM_LE: value <= const}[op]


def _numeric_value(plan: _AttrPlan) -> Tuple[bool, str]:
    """Boundary value of the satisfying integer interval (int
    lanes), or a non-integer witness when every comparator must fail."""
    from ..compiler.compile import OP_NUM_GE, OP_NUM_GT, OP_NUM_LE, OP_NUM_LT

    LO, HI = -(2 ** 40), 2 ** 40
    lo, hi = LO, HI
    for op, c, want in plan.num:
        if want:
            if op == OP_NUM_GT:
                lo = max(lo, c + 1)
            elif op == OP_NUM_GE:
                lo = max(lo, c)
            elif op == OP_NUM_LT:
                hi = min(hi, c - 1)
            elif op == OP_NUM_LE:
                hi = min(hi, c)
        else:
            if op == OP_NUM_GT:
                hi = min(hi, c)
            elif op == OP_NUM_GE:
                hi = min(hi, c - 1)
            elif op == OP_NUM_LT:
                lo = max(lo, c)
            elif op == OP_NUM_LE:
                lo = max(lo, c + 1)
    if lo <= hi:
        # boundary-first: the tightest bound is the value most likely to
        # catch an off-by-one in a comparator lowering
        v = lo if lo != LO else (hi if hi != HI else 0)
        return True, str(v)
    if all(not want for *_, want in plan.num):
        return True, "not-an-int"
    return False, ""


def _relation_entity(policy: Any, plan: _AttrPlan, check_str) -> Tuple[bool, Any]:
    """An entity from the closure tables whose group memberships match the
    assignment (closure digests key which relation instance each atom
    queries); an unknown entity falsifies every group atom at once."""
    inst_of = {rel.digest: rel for rel in (policy.rel_instances or [])}
    cands: List[str] = []
    for digest, _g, _w in plan.rel:
        rel = inst_of.get(digest)
        if rel is not None:
            cands.extend(rel.entities)
    cands.append(_UNSEEN)
    for ent in cands:
        ok = True
        for digest, group, want in plan.rel:
            rel = inst_of.get(digest)
            got = bool(rel is not None and rel.contains(ent, group))
            if got != want:
                ok = False
                break
        if ok and check_str(ent):
            return True, ent
    return False, None


def _materialize(policy: Any, atoms: Sequence[tuple],
                 truth: Sequence[bool]) -> Tuple[Optional[Dict[str, Any]], str]:
    """One assignment → a request document, or (None, reason code)."""
    plans: Dict[int, _AttrPlan] = {}
    has_opaque = False
    for atom, want in zip(atoms, truth):
        kind = atom[0]
        if kind == "t":
            has_opaque = True            # uncontrollable: verification decides
            continue
        if kind == "v":
            _, attr, const = atom
            p = plans.setdefault(attr, _AttrPlan())
            (p.eq_true if want else p.eq_false).append(const)
        elif kind == "m":
            _, attr, const = atom
            p = plans.setdefault(attr, _AttrPlan())
            (p.mem_true if want else p.mem_false).append(const)
        elif kind == "r":
            _, attr, pat = atom
            leaf = rx = None
            for i, lrx in enumerate(policy.leaf_regex):
                if lrx is not None and int(policy.leaf_attr[i]) == attr \
                        and lrx.pattern == pat:
                    leaf, rx = i, lrx
                    break
            if rx is None:
                return None, "materialization-failed"
            plans.setdefault(attr, _AttrPlan()).rx.append((rx, want, leaf))
        elif kind == "n":
            _, op, attr, const = atom
            plans.setdefault(attr, _AttrPlan()).num.append((op, const, want))
        elif kind == "G":
            _, attr, digest, group = atom
            plans.setdefault(attr, _AttrPlan()).rel.append(
                (digest, group, want))
    doc: Dict[str, Any] = {}
    for attr, plan in sorted(plans.items()):
        ok, value = _value_for_attr(policy, plan)
        if not ok:
            return None, "materialization-failed"
        err = _set_path(doc, policy.attr_selectors[attr], value)
        if err:
            return None, err
    if has_opaque:
        return doc, "opaque-cpu-tree"    # best-effort doc; caller verifies
    return doc, ""


# ---------------------------------------------------------------------------
# synthesis
# ---------------------------------------------------------------------------


def synthesize_rows(policy: Any,
                    targets: Optional[Iterable[Tuple[str, int]]] = None,
                    analysis: Optional[Dict[str, Any]] = None,
                    now: Optional[float] = None,
                    max_tries: int = _MAX_TRIES,
                    ) -> Tuple[List[Dict[str, Any]], Dict[str, Any]]:
    """Synthesize one verified corpus row per target (config, evaluator)
    column, making that column the first-false firing rule.  A target
    evaluator of ``-1`` requests an **allow witness** — a document every
    evaluator of the config passes (verdict allow): the row a future
    constant-deny edit to ANY of the config's rules must flip, which is
    what makes the corpus pregate's zero-traffic coverage claim real.
    Default targets: every registered column plus one allow witness per
    config.  Returns (rows, report); every uncovered target carries a
    typed reason from :data:`SYNTH_REASONS`."""
    from ..analysis.policy_analysis import MAX_ATOMS, _Circuit
    from ..models.policy_model import host_results
    from ..ops.operands import firing_columns
    from ..runtime.provenance import rule_label
    from ..utils import metrics as metrics_mod

    now = time.time() if now is None else float(now)
    circ = _Circuit(policy)
    smemo: Dict[int, Any] = {}
    static_by_rule: Dict[Tuple[str, int], List[str]] = {}
    for f in (analysis or {}).get("findings", []):
        if f.get("kind") in ("constant-allow", "shadowed-rule",
                             "constant-deny"):
            d = f.get("detail") or {}
            ev = d.get("evaluator")
            if ev is not None:
                static_by_rule.setdefault(
                    (str(d.get("config", "")), int(ev)),
                    []).append(f["kind"])
    if targets is None:
        targets = [(name, e) for name, g in sorted(policy.config_ids.items())
                   for e in range(-1, len(policy.config_exprs[g]))]
    targets = list(targets)
    rows: List[Dict[str, Any]] = []
    uncoverable: List[Dict[str, Any]] = []
    reasons: Dict[str, int] = {}
    sources = policy.rule_sources()

    def _fail(name: str, e: int, reason: str) -> None:
        reasons[reason] = reasons.get(reason, 0) + 1
        uncoverable.append({"config": name, "evaluator": e,
                            "reason": reason})
        try:
            metrics_mod.corpus_synth.labels(reason).inc()
        except Exception:
            pass

    for name, e in targets:
        g = policy.config_ids.get(name)
        if g is None or e >= len(policy.config_exprs[g]):
            _fail(name, e, "unsatisfiable")
            continue
        n_real = len(policy.config_exprs[g])
        # atom union over evaluators 0..e (all of them for an allow
        # witness): the prefix must contribute true for e to be the
        # FIRST false column
        last = n_real - 1 if e < 0 else e
        atoms: set = set()
        for k in range(last + 1):
            atoms |= circ.support(int(policy.eval_rule[g, k]), smemo)
            if bool(policy.eval_has_cond[g, k]):
                atoms |= circ.support(int(policy.eval_cond[g, k]), smemo)
        atoms = sorted(atoms)
        if len(atoms) > MAX_ATOMS:
            _fail(name, e, "atom-budget-exceeded")
            continue
        n = 1 << len(atoms)
        idx = np.arange(n)
        cols = {a: (idx >> i) & 1 != 0 for i, a in enumerate(atoms)}
        vmemo: Dict[int, np.ndarray] = {}
        sel = np.ones(n, dtype=bool)
        for k in range(last + 1 if e < 0 else e):
            contrib = circ.eval_over(int(policy.eval_rule[g, k]), cols, n,
                                     vmemo)
            if bool(policy.eval_has_cond[g, k]):
                contrib = contrib | ~circ.eval_over(
                    int(policy.eval_cond[g, k]), cols, n, vmemo)
            sel &= contrib
        if e >= 0:
            sel &= ~circ.eval_over(int(policy.eval_rule[g, e]), cols, n,
                                   vmemo)
            if bool(policy.eval_has_cond[g, e]):
                sel &= circ.eval_over(int(policy.eval_cond[g, e]), cols, n,
                                      vmemo)
        cand = np.nonzero(sel)[0]
        if cand.size == 0:
            static = static_by_rule.get((name, e), [])
            _fail(name, e,
                  "statically-dead" if static else "unsatisfiable")
            continue
        # simplest assignments first (fewest true atoms → smallest docs)
        order = sorted(cand.tolist(), key=lambda i: bin(i).count("1"))
        verified = None
        last_reason = "materialization-failed"
        saw_opaque = False
        for i in order[:max_tries]:
            truth = [bool((i >> b) & 1) for b in range(len(atoms))]
            doc, err = _materialize(policy, atoms, truth)
            if doc is None:
                last_reason = err
                continue
            if err == "opaque-cpu-tree":
                saw_opaque = True
            try:
                _own, rule_res, skipped = host_results(policy, doc, g)
                fire = int(firing_columns(rule_res[None, :],
                                          skipped[None, :])[0])
            except Exception:
                continue
            if fire == e:
                verified = doc
                break
        if verified is None:
            _fail(name, e,
                  "opaque-cpu-tree" if saw_opaque else last_reason)
            continue
        reasons["ok"] = reasons.get("ok", 0) + 1
        try:
            metrics_mod.corpus_synth.labels("ok").inc()
        except Exception:
            pass
        rows.append({
            "schema": CORPUS_SCHEMA,
            "authconfig": name,
            "doc": verified,
            "verdict": "allow" if e < 0 else "deny",
            "rule_index": e,
            "rule": "" if e < 0 else rule_label(
                e, sources[g][e] if e < len(sources[g]) else ""),
            "weight": 1,
            "first_seen": now,
            "last_seen": now,
            "origin": "synthetic",
            "row_key": "",               # stamped by callers that encode
            "generation": None,
        })
    return rows, {
        "targets": len(targets),
        "synthesized": len(rows),
        "uncoverable": uncoverable,
        "reasons": reasons,
    }


def augment_corpus(policy: Any, rows: Sequence[Dict[str, Any]],
                   analysis: Optional[Dict[str, Any]] = None,
                   lowerability: Optional[Dict[str, Any]] = None,
                   now: Optional[float] = None) -> Dict[str, Any]:
    """One-call coverage close: measure coverage of ``rows``, synthesize a
    verified witness row for every unexercised column, and report
    coverage before/after.  The engine pregate, the analysis CLI, and
    bench's corpus block all share this seam."""
    before = coverage_report(policy, rows, analysis=analysis,
                             lowerability=lowerability)
    # every unexercised deny column, plus an allow witness for configs the
    # corpus never saw allow — the row a constant-deny edit must flip
    targets = [(name, e) for name, c in before["configs"].items()
               for e in c["unexercised"]]
    targets += [(name, -1) for name, c in before["configs"].items()
                if not c["allow_rows"]]
    synth, rep = synthesize_rows(policy, targets=targets,
                                 analysis=analysis, now=now)
    after = coverage_report(policy, list(rows) + synth, analysis=analysis,
                            lowerability=lowerability)
    return {
        "rows": synth,
        "synthesis": rep,
        "coverage_before": before,
        "coverage_after": after,
    }
