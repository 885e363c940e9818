"""Fixture AuthConfigs for the analysis CLI and the corruption tests.

A deliberately feature-dense miniature corpus: nested And/Or, every
operator, a DFA-compilable regex, a CPU-lane regex, shared subtrees across
configs (exercises node dedup), duplicate regexes (exercises DFA table
dedup) and a config pair with semantic findings (tautology, unsat,
shadowing) so ``--verify-fixtures`` proves both layers see real structure.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Any, List, Optional

from ..compiler.compile import CompiledPolicy, ConfigRules, compile_corpus
from ..expressions import All, Any_, InGroup, Operator, Pattern
from ..relations.closure import RelationClosure

__all__ = ["fixture_configs", "fixture_policy", "finding_fixture_configs",
           "FixtureEntry", "lowerability_fixture_entries",
           "relations_fixture_configs", "relations_fixture_policy",
           "fixture_relation"]


def fixture_configs() -> List[ConfigRules]:
    """A clean corpus: compiles, packs, and passes every tensor-lint check."""
    role = Pattern("auth.identity.roles", Operator.INCL, "admin")
    org = Pattern("auth.identity.org", Operator.EQ, "acme")
    path_rx = Pattern("request.url_path", Operator.MATCHES, r"^/api/v[0-9]+/")
    method = Pattern("request.method", Operator.NEQ, "TRACE")
    banned = Pattern("auth.identity.groups", Operator.EXCL, "banned")
    # backreference: not DFA-compilable, rides the CPU regex lane
    cpu_rx = Pattern("request.headers.x-tag", Operator.MATCHES, r"^(a+)\1$")
    shared = All(org, Any_(role, banned))
    return [
        ConfigRules(name="api", evaluators=[
            (None, All(method, path_rx, shared)),
            (path_rx, Any_(role, cpu_rx)),
        ]),
        ConfigRules(name="admin", evaluators=[
            # identical subtree to "api"'s → circuit-level node dedup
            (None, shared),
            # identical regex on a different selector → DFA table dedup
            (None, Pattern("request.host", Operator.MATCHES,
                           r"^/api/v[0-9]+/")),
        ]),
        ConfigRules(name="public", evaluators=[(None, All())]),
    ]


def finding_fixture_configs() -> List[ConfigRules]:
    """Configs with known semantic findings (policy_analysis layer):
    a tautology, an unsat rule, a shadowed rule, a duplicate rule."""
    eq = Pattern("auth.identity.org", Operator.EQ, "acme")
    neq = Pattern("auth.identity.org", Operator.NEQ, "acme")
    role = Pattern("auth.identity.roles", Operator.INCL, "admin")
    return [
        ConfigRules(name="vacuous", evaluators=[
            (None, Any_(eq, neq)),          # constant-allow
        ]),
        ConfigRules(name="blocked", evaluators=[
            (None, All(eq, neq)),           # constant-deny
            (None, role),                   # shadowed-rule
        ]),
        ConfigRules(name="doubled", evaluators=[
            (None, role),
            (None, role),                   # duplicate-rule
        ]),
    ]


def fixture_policy(members_k: int = 8) -> CompiledPolicy:
    return compile_corpus(fixture_configs(), members_k=members_k)


def fixture_relation() -> RelationClosure:
    """A deliberately awkward hierarchy: 9 levels deep with a diamond
    (alice reaches `all` through two distinct paths) and a disjoint
    branch — the shapes the closure fixpoint must not miscount."""
    chain = [(f"lvl{i}", f"lvl{i + 1}") for i in range(9)]
    return RelationClosure(chain + [
        ("alice", "eng"), ("alice", "ops"),        # diamond top
        ("eng", "staff"), ("ops", "staff"),        # diamond join
        ("staff", "all"), ("bob", "qa"), ("qa", "all"),
        ("eve", "guests"), ("lvl0", "all"),
    ])


def relations_fixture_configs() -> List[ConfigRules]:
    """Fixture corpus: relation leaves over a deep/diamond
    hierarchy (two queried groups — the col-redirect mutant needs a second
    column), numeric comparators on two attrs (the slot-collision mutant
    needs a second slot), bounded-arithmetic constants, and a large
    incl/excl config for the ovf_assist lane."""
    rel = fixture_relation()
    return [
        ConfigRules(name="hier", evaluators=[
            (None, All(InGroup("auth.identity.sub", "staff", rel),
                       Pattern("request.method", Operator.NEQ, "TRACE"))),
            (Pattern("request.path", Operator.EQ, "/admin"),
             InGroup("auth.identity.sub", "all", rel)),
        ]),
        ConfigRules(name="quota", evaluators=[
            (None, All(Pattern("request.size", Operator.GE, "0"),
                       Pattern("request.size", Operator.LE, "1024*1024"))),
            (None, Any_(Pattern("auth.identity.level", Operator.GT, "3"),
                        InGroup("auth.identity.sub", "staff", rel))),
        ]),
        ConfigRules(name="roles", evaluators=[
            (None, All(Pattern("auth.identity.roles", Operator.INCL, "admin"),
                       Pattern("auth.identity.roles", Operator.EXCL,
                               "banned"))),
        ]),
    ]


def relations_fixture_policy(members_k: int = 8,
                             ovf_assist: bool = True) -> CompiledPolicy:
    return compile_corpus(relations_fixture_configs(), members_k=members_k,
                          ovf_assist=ovf_assist)


@dataclass
class FixtureEntry:
    """Duck-typed EngineEntry (id/hosts/rules/runtime) so the analysis CLI
    can exercise the lowerability classifier without importing the runtime
    engine (import-light contract)."""

    id: str
    hosts: List[str] = field(default_factory=list)
    rules: Optional[ConfigRules] = None
    runtime: Any = None


def lowerability_fixture_entries() -> List[FixtureEntry]:
    """A corpus spanning the lowerability reason-code catalogue: pure
    fast-lane configs, fast-lane configs with CPU assists (cpu-regex /
    invalid-regex-fallback / cpu-grid-overflow), and slow-lane residents
    (no rules, non-lowerable OPA, external authorization, metadata)."""
    entries = [FixtureEntry(id=c.name, hosts=[c.name], rules=c)
               for c in fixture_configs()]
    entries.append(FixtureEntry(
        id="bad-regex", hosts=["bad-regex"],
        rules=ConfigRules(name="bad-regex", evaluators=[
            (None, Pattern("request.path", Operator.MATCHES, "(["))])))
    entries.append(FixtureEntry(id="interpreter-only",
                                hosts=["interpreter-only"]))
    entries.append(FixtureEntry(
        id="opa-unsupported", hosts=["opa-unsupported"],
        runtime=SimpleNamespace(
            metadata=[],
            authorization=[SimpleNamespace(
                type="OPA",
                evaluator=SimpleNamespace(kernel_slot=None))])))
    entries.append(FixtureEntry(
        id="metadata-bound", hosts=["metadata-bound"],
        rules=ConfigRules(name="metadata-bound", evaluators=[
            (None, Pattern("request.method", Operator.EQ, "GET"))]),
        runtime=SimpleNamespace(
            metadata=[SimpleNamespace(type="METADATA_GENERIC_HTTP")],
            authorization=[SimpleNamespace(
                type="PATTERN_MATCHING", evaluator=SimpleNamespace())])))
    entries.append(FixtureEntry(
        id="external-az", hosts=["external-az"],
        runtime=SimpleNamespace(
            metadata=[],
            authorization=[SimpleNamespace(
                type="SPICEDB", evaluator=SimpleNamespace())])))
    return entries
