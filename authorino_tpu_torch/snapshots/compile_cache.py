"""Bounded persistent compile cache: per-config artifacts keyed by source
fingerprint.

This carries the compiler's dedup memos (circuit nodes, DFA tables, regex
determinization) from *within one compile* to *across reconciles*:

  - the per-config artifact pins the canonical expression trees and the
    set of regex patterns the config lowers, so a config seen before is
    never re-canonicalized, re-interned, or re-determinized — re-reconciling
    an unchanged corpus compiles zero configs, changing one compiles
    exactly that one (the cache's counters say so).  A changed corpus is
    still lowered whole (``compile_corpus`` over every artifact); only a
    fingerprint-identical one skips the lowering;
  - the persistent ``StringInterner`` keeps constant ids STABLE across
    reconciles, which is what makes both delta device uploads (unchanged
    rows byte-identical, so nothing to ship) and verdict-cache survival
    (unchanged rows produce unchanged row keys) possible at all;
  - the persistent ``dfa_cache`` is the cross-reconcile face of
    compiler/redfa.py's process-wide determinization memo: a regex pattern
    determinizes once per process.

The cache itself is bounded LRU over fingerprints.  Two configs with
identical rules (common in templated fleets) share ONE artifact —
structural sharing at the source level, mirroring the compiler's circuit
and DFA sharing at the tensor level."""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..compiler.compile import CompiledPolicy, ConfigRules, compile_corpus
from ..compiler.intern import StringInterner
from ..expressions.ast import Expression, Operator, Pattern
from .fingerprint import rules_fingerprint

__all__ = ["ConfigArtifact", "CompileCache", "CompileReport"]

# the LRU bound on cached artifacts (distinct rule fingerprints)
_MAX_ENTRIES = 65536


@dataclass(frozen=True)
class ConfigArtifact:
    """One config's compiled artifact: the canonical evaluator trees (the
    unit compile_corpus consumes) plus the regex patterns it determinizes.
    Name-free — shared by every config with identical rules."""

    fingerprint: str
    evaluators: Tuple[Tuple[Optional[Expression], Expression], ...]
    patterns: Tuple[str, ...]          # valid-regex MATCHES patterns lowered
    n_patterns: int = 0


@dataclass
class CompileReport:
    """What one incremental compile actually did (the churn evidence that
    lands on /debug/vars and the reconcile metrics)."""

    total: int = 0            # rules-bearing configs in the corpus
    compiled: int = 0         # artifacts built this reconcile (cache misses)
    cached: int = 0           # artifacts served from the cache
    fingerprints: "OrderedDict[str, str]" = field(default_factory=OrderedDict)
    compiled_names: List[str] = field(default_factory=list)
    unchanged: bool = False   # corpus fingerprint-identical to the previous
    reused_policy: bool = False  # previous CompiledPolicy object reused as-is

    def to_json(self) -> Dict[str, Any]:
        return {
            "total": self.total,
            "compiled": self.compiled,
            "cached": self.cached,
            "hit_ratio": round(self.cached / self.total, 4) if self.total else None,
            "compiled_names": self.compiled_names[:32],
            "unchanged": self.unchanged,
            "reused_policy": self.reused_policy,
        }


def _collect_patterns(expr: Expression, acc: set) -> None:
    if isinstance(expr, Pattern):
        if (expr.operator is Operator.MATCHES
                and getattr(expr, "_regex", None) is not None):
            acc.add(expr.value)
        return
    for c in getattr(expr, "children", ()):  # InGroup: leaf, no regexes
        _collect_patterns(c, acc)


class CompileCache:
    """Thread-safe; one per PolicyEngine (members_k is an engine constant
    and the DFA lane always on, so neither need ride the key)."""

    def __init__(self):
        self._lock = threading.Lock()
        # serializes whole-corpus compiles: compile_corpus and artifact
        # builds both mutate the SHARED interner/DFA memo, and
        # StringInterner.intern is an unlocked read-modify-write — two
        # concurrent compiles could hand one id to two different strings
        # (an exact-match comparator would then equate them on device).
        # Reconcile-path only; request-path interner access is read-only.
        self._compile_lock = threading.RLock()
        self._artifacts: "OrderedDict[str, ConfigArtifact]" = OrderedDict()
        # cross-reconcile faces of the compiler's memos
        self.dfa_cache: Dict[str, Any] = {}
        self.interner = StringInterner()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._artifacts)

    def stats(self) -> Dict[str, Any]:
        total = self.hits + self.misses
        return {
            "entries": len(self._artifacts),
            "hits": self.hits,
            "misses": self.misses,
            "hit_ratio": round(self.hits / total, 4) if total else None,
            "dfa_patterns": len(self.dfa_cache),
            "interned_strings": len(self.interner),
            "interner_serial": self.interner.serial,
        }

    # ------------------------------------------------------------------

    def artifact_for(self, cfg: ConfigRules) -> Tuple[ConfigArtifact, bool]:
        """Get-or-build the artifact for one config.  The build IS the
        per-config compile work: canonicalize the trees, intern every
        comparison constant (id stability across reconciles), and
        determinize every device-lane regex into the persistent memo."""
        fp = rules_fingerprint(cfg)
        with self._lock:
            hit = self._artifacts.get(fp)
            if hit is not None:
                self._artifacts.move_to_end(fp)
                self.hits += 1
                return hit, True
        # build under the (re-entrant) COMPILE lock — compile() already
        # holds it, direct callers take it here: _build mutates the shared
        # interner and DFA memo, which must never race another build or a
        # corpus compile
        with self._compile_lock:
            art = self._build(fp, cfg)
        with self._lock:
            self._artifacts[fp] = art
            self._artifacts.move_to_end(fp)
            self.misses += 1
            while len(self._artifacts) > _MAX_ENTRIES:
                self._artifacts.popitem(last=False)
        return art, False

    def _build(self, fp: str, cfg: ConfigRules) -> ConfigArtifact:
        from ..compiler.compile import _has_invalid_regex
        from ..compiler.redfa import compile_regex_dfa

        patterns: set = set()
        for cond, rule in cfg.evaluators:
            for expr in (cond, rule):
                if expr is None:
                    continue
                if _has_invalid_regex(expr):
                    # the whole tree rides the CPU-fallback leaf; none of
                    # its regexes are lowered to the device lane
                    continue
                _collect_patterns(expr, patterns)
                self._intern_consts(expr)
        for pat in patterns:
            if pat not in self.dfa_cache:
                try:
                    self.dfa_cache[pat] = compile_regex_dfa(pat)
                except Exception:
                    self.dfa_cache[pat] = None  # CPU regex lane
        return ConfigArtifact(
            fingerprint=fp,
            evaluators=tuple((cond, rule) for cond, rule in cfg.evaluators),
            patterns=tuple(sorted(patterns)),
            n_patterns=len(patterns),
        )

    def _intern_consts(self, expr: Expression) -> None:
        if isinstance(expr, Pattern):
            from ..expressions.ast import NUMERIC_OPERATORS

            # numeric constants fold to raw int32 at compile time — they
            # never enter the interner (and must not churn its serial)
            if expr.operator is not Operator.MATCHES and \
                    expr.operator not in NUMERIC_OPERATORS:
                self.interner.intern(expr.value)
            return
        for c in getattr(expr, "children", ()):  # InGroup: no string consts
            self._intern_consts(c)

    # ------------------------------------------------------------------

    def compile(
        self,
        rules: List[ConfigRules],
        members_k: int = 16,
        prev_fps: Optional["OrderedDict[str, str]"] = None,
        prev_policy: Optional[CompiledPolicy] = None,
        ovf_assist: Optional[bool] = None,
    ) -> Tuple[CompiledPolicy, CompileReport]:
        """Incremental corpus compile.  Unchanged configs (fingerprint hit)
        reuse their artifact; a corpus whose ordered fingerprint map equals
        the previous snapshot's reuses the previous CompiledPolicy object
        outright — zero configs compiled, zero tensors rebuilt, and the
        caller can skip the device upload entirely."""
        report = CompileReport(total=len(rules))
        with self._compile_lock:
            arts: List[Tuple[str, ConfigArtifact]] = []
            for cfg in rules:
                art, hit = self.artifact_for(cfg)
                arts.append((cfg.name, art))
                report.fingerprints[cfg.name] = art.fingerprint
                if hit:
                    report.cached += 1
                else:
                    report.compiled += 1
                    report.compiled_names.append(cfg.name)
            if (prev_fps is not None and prev_policy is not None
                    and list(prev_fps.items())
                    == list(report.fingerprints.items())):
                report.unchanged = True
                report.reused_policy = True
                return prev_policy, report
            cfgs = [ConfigRules(name=name, evaluators=list(art.evaluators))
                    for name, art in arts]
            policy = compile_corpus(
                cfgs, members_k=members_k, interner=self.interner,
                enable_dfa=True, dfa_cache=self.dfa_cache,
                ovf_assist=ovf_assist)
        return policy, report
