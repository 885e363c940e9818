"""Tenant QoS weights and quotas.

The tenant is the unit the stack already carries per row: the AuthConfig
(``config_id`` / host identity).  Operators express QoS intent as AuthConfig
ANNOTATIONS — nothing new to deploy, and the weight travels with the config
through every control-plane path (reconcile, snapshot distribution,
replay):

- ``authorino.tpu/qos-class``:  a named service class (``gold``/``silver``/
  ``bronze``) mapping to a weight — the coarse knob most tenants use;
- ``authorino.tpu/qos-weight``: an explicit positive float weight,
  overriding the class — the fine knob;
- ``authorino.tpu/qos-quota-rps``: a per-tenant admission token-bucket rate
  (requests/second; absent or 0 = no quota).

Weights are RELATIVE shares for the weighted-fair batch cut
(tenancy/fair_cut.py): a weight-4 tenant may fill 4x the batch rows of a
weight-1 tenant when both are backlogged; an un-annotated tenant rides the
default class (weight 1).  The cut is work-conserving, so weights only bind
under contention — a sole-backlogged tenant always gets the whole batch.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

__all__ = ["WEIGHT_ANNOTATION", "CLASS_ANNOTATION", "QUOTA_ANNOTATION",
           "QOS_CLASSES", "DEFAULT_WEIGHT", "WeightBook",
           "weight_from_annotations", "quota_from_annotations"]

WEIGHT_ANNOTATION = "authorino.tpu/qos-weight"
CLASS_ANNOTATION = "authorino.tpu/qos-class"
QUOTA_ANNOTATION = "authorino.tpu/qos-quota-rps"

# the default class is the FLOOR, not zero: an un-annotated cold tenant must
# still hold a share against an annotated hot one
QOS_CLASSES: Dict[str, float] = {"gold": 4.0, "silver": 2.0, "bronze": 1.0}
DEFAULT_WEIGHT = 1.0


def weight_from_annotations(ann: Optional[Mapping[str, Any]],
                            default: float = DEFAULT_WEIGHT) -> float:
    """Resolve one tenant's weight from its AuthConfig annotations.
    Explicit weight wins over class; junk values fall back to the default
    (a typo must never zero a tenant's share)."""
    if not ann:
        return default
    raw = ann.get(WEIGHT_ANNOTATION)
    if raw is not None:
        try:
            w = float(raw)
            if w > 0:
                return w
        except (TypeError, ValueError):
            pass
    cls = ann.get(CLASS_ANNOTATION)
    if cls is not None:
        w = QOS_CLASSES.get(str(cls).strip().lower())
        if w:
            return w
    return default


def quota_from_annotations(ann: Optional[Mapping[str, Any]],
                           default: float = 0.0) -> float:
    """Per-tenant admission quota in requests/second (0 = unlimited)."""
    if not ann:
        return default
    raw = ann.get(QUOTA_ANNOTATION)
    if raw is None:
        return default
    try:
        q = float(raw)
        return q if q > 0 else default
    except (TypeError, ValueError):
        return default


class WeightBook:
    """The resolved (weight, quota) table for the serving snapshot's
    tenants.  Rebuilt at reconcile from entry annotations plus operator
    overrides (CLI ``--tenant-weight name=w``); reads are GIL-atomic dict
    lookups on the submit path."""

    def __init__(self, default_weight: float = DEFAULT_WEIGHT,
                 default_quota_rps: float = 0.0,
                 overrides: Optional[Dict[str, float]] = None):
        self.default_weight = max(float(default_weight), 1e-6)
        self.default_quota_rps = float(default_quota_rps)
        self.overrides = dict(overrides or {})
        self._weights: Dict[str, float] = {}
        self._quotas: Dict[str, float] = {}
        # the sum of every known tenant's weight (global_share's
        # denominator), computed once per rebuild: a per-submit sum over
        # a large corpus would cost O(tenants) on the submit path
        self._total = 0.0

    def rebuild(self, annotations_by_tenant: Mapping[str, Optional[Mapping[str, Any]]]) -> None:
        weights: Dict[str, float] = {}
        quotas: Dict[str, float] = {}
        for name, ann in annotations_by_tenant.items():
            weights[name] = weight_from_annotations(ann, self.default_weight)
            quotas[name] = quota_from_annotations(ann, self.default_quota_rps)
        for name, w in self.overrides.items():
            if w > 0:
                weights[name] = float(w)
        self._weights = weights
        self._quotas = quotas
        self._total = sum(weights.values())

    def weight(self, tenant: str) -> float:
        return self._weights.get(tenant, self.default_weight)

    def quota_rps(self, tenant: str) -> float:
        return self._quotas.get(tenant, self.default_quota_rps)

    def global_share(self, tenant: str) -> float:
        """This tenant's weighted share among EVERY tenant the snapshot
        knows (the queue-occupancy entitlement): the shared queue belongs
        to the whole corpus, so occupancy bounds must not inflate just
        because the other tenants are currently fast enough to not
        backlog.  Falls back to 1.0 when the book is empty (single-tenant
        or pre-reconcile)."""
        if not self._weights:
            return 1.0
        total = self._total
        mine = self.weight(tenant)
        if tenant not in self._weights:
            total += mine
        return mine / total if total > 0 else 1.0

    def share(self, tenant: str, among) -> float:
        """This tenant's weighted share among ``among`` (an iterable of
        tenant names, the backlogged set).  Returns 1.0 when the tenant is
        alone (or the set is empty) — share only binds under contention."""
        total = 0.0
        mine = self.weight(tenant)
        seen_self = False
        for t in among:
            total += self.weight(t)
            if t == tenant:
                seen_self = True
        if not seen_self:
            total += mine
        if total <= 0.0:
            return 1.0
        return mine / total

    def share_of_among(self, among):
        """``share(t, among)`` for many ``t`` over one ``among``: the sum
        is taken once (in ``share``'s order, so each result is the same
        float), not once per tenant."""
        members = list(among)
        total = 0.0
        for t in members:
            total += self.weight(t)
        present = set(members)

        def share_of(tenant: str) -> float:
            mine = self.weight(tenant)
            tot = total if tenant in present else total + mine
            if tot <= 0.0:
                return 1.0
            return mine / tot

        return share_of

    def to_json(self) -> Dict[str, Any]:
        non_default = {t: w for t, w in self._weights.items()
                       if w != self.default_weight}
        quotas = {t: q for t, q in self._quotas.items() if q}
        return {
            "default_weight": self.default_weight,
            "default_quota_rps": self.default_quota_rps,
            "tenants": len(self._weights),
            "non_default_weights": dict(sorted(non_default.items())[:32]),
            "quotas": dict(sorted(quotas.items())[:32]),
            "overrides": dict(self.overrides),
        }
