"""Deny attribution: which rule of which AuthConfig denied a request.

A denial carries a provenance object in Envoy ``dynamic_metadata``
(always: it is mesh-internal).  The client-visible reason string names the
rule only behind the ``--expose-deny-reason`` privacy knob (module flag
``EXPOSE_DENY_REASON``); otherwise it stays the reference's generic
"Unauthorized"."""

from __future__ import annotations

from typing import Any, Dict, Optional

__all__ = ["EXPOSE_DENY_REASON", "deny_provenance", "deny_reason"]

# --expose-deny-reason: when False (default), deny responses keep the
# generic "Unauthorized" reason and attribution rides only dynamic_metadata.
# Module-level so the evaluator seam
# (evaluators/authorization/pattern_matching.py) needs no plumbing.
EXPOSE_DENY_REASON = False


def deny_provenance(authconfig: str, rule_index: int, source: str,
                    lane: str = "engine") -> Dict[str, Any]:
    """The JSON-safe provenance object a denied response carries in Envoy
    dynamic_metadata (always) and X-Ext-Auth-Reason (knob-gated)."""
    return {
        "authconfig": authconfig,
        "rule_index": int(rule_index),
        "rule": source,
        "lane": lane,
    }


def deny_reason(prov: Optional[Dict[str, Any]]) -> str:
    """The deny message: attributed behind --expose-deny-reason, the
    reference's generic 'Unauthorized' otherwise."""
    if prov and EXPOSE_DENY_REASON:
        return (f"denied by {prov['authconfig']} "
                f"rule[{prov['rule_index']}]: {prov['rule']}")
    return "Unauthorized"
