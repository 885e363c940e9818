"""Compile-time verification subsystem (the Cedar lesson: an analyzable
policy corpus is as valuable as a fast one — "A New Language for Expressive,
Fast, Safe, and Analyzable Authorization", PAPERS.md).

Four independent layers, each pure-host and import-light:

  - ``tensor_lint``   — structural invariants of a compiled snapshot that the
                        device kernels silently assume (index ranges, circuit
                        topology, lane dtype/shape contracts, scatter covers).
                        Runs at reconcile time under ``--strict-verify`` so a
                        malformed snapshot is rejected before it serves.
  - ``translation_validate`` — per-config certificates that the compiled
                        circuits and DFA tables DECIDE identically to the
                        host expression oracle (truth-table equivalence +
                        DFA witness cross-checks), keyed by canonical
                        semantic fingerprints with a process-wide cache so
                        unchanged configs skip re-validation; plus the
                        fast/slow-lane lowerability report.  Gates under
                        ``--strict-verify``; proven non-blind by a mutation
                        self-test.
  - ``policy_analysis`` — Cedar-style semantic findings over the compiled
                        boolean circuits: constant-allow / constant-deny
                        rules, shadowed and duplicate rules, hosts routed to
                        more than one AuthConfig.  Warnings, never gates.
  - ``code_lint``     — an AST linter for this repo's own async-hazard
                        classes (blocking calls in ``async def``, a device
                        synchronise among them, locks held across
                        ``await``, tracer branches in jitted fns, bare
                        excepts on completer/drain threads).

CLI: ``python -m authorino_tpu_torch.analysis`` (see __main__.py); rule
catalogue: docs/static_analysis.md."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

__all__ = ["Finding", "findings_to_json"]


@dataclass
class Finding:
    """One analysis result.  ``kind`` is the stable machine-readable rule id
    (the metrics label and the suppression token); ``layer`` names the
    producing analyzer (tensor_lint / policy_analysis / code_lint)."""

    kind: str
    message: str
    layer: str
    severity: str = "error"          # error = gate-worthy; warning = advisory
    location: str = ""               # file:line, config/evaluator, array name
    detail: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        out = {
            "kind": self.kind,
            "message": self.message,
            "layer": self.layer,
            "severity": self.severity,
        }
        if self.location:
            out["location"] = self.location
        if self.detail:
            out["detail"] = self.detail
        return out

    def __str__(self) -> str:
        loc = f" [{self.location}]" if self.location else ""
        return f"{self.severity}: {self.kind}{loc}: {self.message}"


def findings_to_json(findings: List[Finding]) -> List[Dict[str, Any]]:
    return [f.to_json() for f in findings]
