"""Metrics-catalogue drift gate over the port's registry.

Every Prometheus family the port registers in ``utils/metrics.py`` must be
documented in the repo's ``docs/observability.md`` (the catalogue the JAX
package is held to; read as a file), and every ``auth_server_*`` family the
doc names must exist in the port's code — unless it is one of
``NOT_YET_PORTED``, the families of the reference's planes the port does
not hold yet, each keyed to the ROADMAP.md queue 1 item that brings it.
That list must be exact: a named family the port registers, or one the doc
does not name, fails the gate too.  Wired as
``python -m authorino_tpu_torch.analysis --metrics-catalog`` and a test.

Doc parsing understands the catalogue's two brace conventions:

- expansion braces mid-name: ``auth_server_evaluator_{total,denied}`` →
  both families;
- label braces after a complete name: ``auth_server_rule_fired_total
  {authconfig,rule}`` → labels are dropped, the family is the prefix.

The distinction is structural: an expansion group is preceded by ``_``, a
label group by a completed family name."""

from __future__ import annotations

import os
import re
from typing import List, Set, Tuple

__all__ = ["registered_families", "documented_families", "catalog_drift",
           "tenant_label_families", "tenant_cardinality_lint",
           "tenant_lint_self_test", "DOC_PATH", "NOT_YET_PORTED"]

DOC_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "docs", "observability.md")

# documented families of planes the port does not hold yet → the ROADMAP.md
# queue 1 item that brings each ("divergence" for a plane the port does not
# have by design: the JAX package's XLA warm grid)
NOT_YET_PORTED = {
    "auth_server_jit_warm_cache_total": "divergence: no XLA warm grid",
}

_TOKEN_RE = re.compile(r"auth_server_[a-z0-9_]+(?:\{[^}]*\}[a-z0-9_]*)*")

# sample-suffix forms the doc may use when naming histogram/counter series
# explicitly (e.g. `auth_server_batch_size_bucket`); strip back to family
_SAMPLE_SUFFIXES = ("_bucket", "_count", "_sum")


def registered_families() -> Set[str]:
    """Every auth_server_* family the port's utils/metrics.py declares
    (prometheus_client stores counters without the _total suffix; re-append
    it so names compare in exposition form)."""
    from ..utils import metrics as metrics_mod

    fams: Set[str] = set()
    for value in vars(metrics_mod).values():
        name = getattr(value, "_name", None)
        mtype = getattr(value, "_type", None)
        if not isinstance(name, str) or not name.startswith("auth_server_"):
            continue
        fams.add(name + "_total" if mtype == "counter" else name)
    return fams


def _expand(token: str) -> List[str]:
    m = re.search(r"\{([^{}]*)\}", token)
    if m is None:
        return [token]
    pre, inner, post = token[:m.start()], m.group(1), token[m.end():]
    if pre.endswith("_"):
        out: List[str] = []
        for part in inner.split(","):
            out.extend(_expand(pre + part.strip() + post))
        return out
    # label braces: the family is the completed name before the brace
    return [pre]


def documented_families(path: str = DOC_PATH) -> Set[str]:
    with open(path, "r") as f:
        text = f.read()
    fams: Set[str] = set()
    for token in _TOKEN_RE.findall(text):
        for name in _expand(token):
            for suffix in _SAMPLE_SUFFIXES:
                if name.endswith(suffix) and name[:-len(suffix)]:
                    name = name[:-len(suffix)]
                    break
            if name:
                fams.add(name)
    return fams


def _exposition_name(value) -> str:
    name = getattr(value, "_name", "")
    return name + "_total" if getattr(value, "_type", None) == "counter" \
        else name


def tenant_label_families(extra=()) -> List[Tuple[str, object]]:
    """Every registered auth_server_* family carrying a ``tenant`` label
    (exposition-form names).  ``extra`` lets the planted-violation
    self-test inject a fake family without registering it."""
    from ..utils import metrics as metrics_mod

    out: List[Tuple[str, object]] = []
    for value in list(vars(metrics_mod).values()) + list(extra):
        name = getattr(value, "_name", None)
        if not isinstance(name, str) or not name.startswith("auth_server_"):
            continue
        labels = getattr(value, "_labelnames", ()) or ()
        if "tenant" in labels:
            out.append((_exposition_name(value), value))
    return out


def tenant_cardinality_lint(bounds=None, extra=()) -> List[str]:
    """Label-cardinality gate: every metric family
    with a ``tenant`` label MUST declare a positive top-K bound in
    ``utils.metrics.TENANT_LABEL_BOUNDS`` — the table the tenancy flush
    clamps its real-label minting to (everything past the bound folds into
    the reserved `other` bucket).  An undeclared family is exactly the
    unbounded-cardinality leak this lint exists to stop; wired into
    ``--verify-fixtures`` and tier-1 with a planted violation."""
    from ..utils import metrics as metrics_mod

    if bounds is None:
        bounds = metrics_mod.TENANT_LABEL_BOUNDS
    violations: List[str] = []
    for name, _value in tenant_label_families(extra=extra):
        k = bounds.get(name)
        if not isinstance(k, int) or k <= 0:
            violations.append(
                f"{name}: tenant-labelled family with no positive top-K "
                f"bound in TENANT_LABEL_BOUNDS (unbounded label "
                f"cardinality)")
    # a declared bound for a family that does not exist is doc rot too
    known = {n for n, _ in tenant_label_families(extra=extra)}
    for name, k in bounds.items():
        if name not in known:
            violations.append(
                f"{name}: TENANT_LABEL_BOUNDS names an unregistered "
                f"family (stale bound)")
    return violations


class _PlantedTenantFamily:
    """A fake tenant-labelled family for the lint's planted-violation
    self-test — never registered with Prometheus."""

    _name = "auth_server_tenant_planted_violation"
    _type = "counter"
    _labelnames = ("tenant",)


def tenant_lint_self_test() -> List[str]:
    """Two proofs in one pass: the REAL registry lints clean, and a
    planted undeclared tenant-labelled family IS caught.  A blind lint
    fails this (and with it --verify-fixtures and tier-1)."""
    errors = list(tenant_cardinality_lint())
    planted = tenant_cardinality_lint(extra=(_PlantedTenantFamily(),))
    if not any("planted_violation" in v for v in planted):
        errors.append("tenant-cardinality lint is BLIND: the planted "
                      "undeclared tenant family was not flagged")
    return errors


def catalog_drift(path: str = DOC_PATH) -> Tuple[List[str], List[str]]:
    """(registered-but-undocumented, documented-but-unregistered).

    The documented set may legitimately contain sample-suffix-stripped
    stems that are PREFIXES of real families (`auth_server_evaluator`
    from `auth_server_evaluator_duration_seconds` prose); a documented
    name counts as unregistered only when no registered family starts
    with it.  A documented family named in ``NOT_YET_PORTED`` is expected
    to be unregistered; a named family that is registered, or that the
    doc does not name, is reported in the second list too."""
    code = registered_families()
    docs = documented_families(path)
    # counters may be documented under their reference-parity name without
    # the exposition _total suffix (auth_server_response_status et al.)
    missing_in_docs = sorted(
        c for c in code
        if c not in docs
        and not (c.endswith("_total") and c[:-len("_total")] in docs))
    unregistered = {
        d for d in docs
        if d not in code and not any(c.startswith(d) for c in code)}
    stale_in_docs = sorted(unregistered - set(NOT_YET_PORTED))
    stale_in_docs += sorted(
        f"{name} (NOT_YET_PORTED, {item}: "
        + ("registered by the port" if name in code
           else "not in the doc") + ")"
        for name, item in NOT_YET_PORTED.items()
        if name not in unregistered)
    return missing_in_docs, stale_in_docs
