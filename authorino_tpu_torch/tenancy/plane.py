"""The tenant QoS plane: one object wiring
weights, the fair cutter, per-tenant admission, the tenant observability
folds and the noisy-neighbor detector into the serving engines.

Integration seams (all per batch or per submit, never per request beyond a
dict lookup):

- ``PolicyEngine.submit``   -> ``admit`` (quota / containment pacing /
  tenant-aware doom depth) + ``on_enqueue``
- ``PolicyEngine._maybe_dispatch`` -> ``cut`` (the weighted-fair batch
  cut), ``on_dequeue``, ``split_contained`` (the contained part)
- both lanes' completion folds -> ``fold`` (tenant counters, wait EWMAs,
  per-tenant SLO burn, detector cadence)
- ``/debug/tenants``        -> ``to_json``
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

from .containment import NoisyNeighborDetector
from .fair_cut import FairCutter
from .quota import (
    R_TENANT_CONTAINED,
    R_TENANT_QUOTA,
    R_TENANT_SHARE,
    TenantAdmission,
)
from .stats import TenantStats
from .weights import WeightBook

__all__ = ["TenantPlane"]


class TenantPlane:
    def __init__(self, lane: str = "engine", enabled: bool = True,
                 default_weight: float = 1.0,
                 weight_overrides: Optional[Dict[str, float]] = None,
                 default_quota_rps: float = 0.0,
                 admission_target_s: float = 0.05,
                 contain_threshold: float = 3.0,
                 contain_sustain_s: float = 0.25,
                 # release hysteresis deliberately LONG relative to
                 # detection: containment's own success clears the
                 # pressure signals (that is the point), so a short
                 # release timer would oscillate — release, re-flood,
                 # re-contain — once per timer period for as long as the
                 # neighbor stays noisy.  Re-containment takes ~sustain_s,
                 # so the cost of a late release is negligible; the cost
                 # of an early one is the whole containment win.
                 contain_release_s: float = 5.0,
                 contain_allowance_rps: float = 100.0,
                 top_k: int = 16,
                 wait_ewma=None, wait_target_s=None, reject_count=None):
        self.lane = lane
        self.enabled = bool(enabled)
        self.book = WeightBook(default_weight=default_weight,
                               default_quota_rps=default_quota_rps,
                               overrides=weight_overrides)
        self.cutter = FairCutter(self.book.weight)
        self.admission = TenantAdmission(self.book,
                                         target_s=admission_target_s)
        self.stats = TenantStats(lane, top_k=top_k)
        self.stats.wait_sink = self.admission.observe_waits
        self.detector = NoisyNeighborDetector(
            self.book, self.stats,
            wait_ewma=wait_ewma or (lambda: 0.0),
            target_s=wait_target_s or (lambda: admission_target_s),
            lane=lane, threshold=contain_threshold,
            sustain_s=contain_sustain_s, release_s=contain_release_s,
            allowance_rps=contain_allowance_rps,
            reject_count=reject_count)

    # -- reconcile ----------------------------------------------------------

    def bind_entries(self, entries) -> None:
        """Rebuild the weight/quota book from the reconcile's entries (the
        AuthConfig annotations travel on EngineEntry)."""
        self.book.rebuild({
            e.id: getattr(e, "annotations", None) for e in entries})

    # -- admission (engine submit path) -------------------------------------

    def admit(self, tenant: str, now: Optional[float] = None,
              depth: int = 0,
              effective_cap: int = 0) -> Optional[Tuple[int, str]]:
        """Tenant-scoped admission decision: quota first, then the
        per-tenant queue-occupancy bound (``depth``/``effective_cap`` are
        the shared queue's live depth and wait-targeted cap), then
        containment pacing.  Returns None (admitted) or the typed
        (code, reason)."""
        if not self.enabled:
            return None
        now = time.monotonic() if now is None else now
        rej = self.admission.quota_reject(tenant, now=now)
        if rej is None:
            rej = self.admission.share_reject(tenant, depth, effective_cap)
        if rej is not None:
            return rej
        if self.detector.is_contained(tenant) and \
                self.detector.pace_reject(tenant, now=now):
            from ..utils.rpc import RESOURCE_EXHAUSTED

            return (RESOURCE_EXHAUSTED, R_TENANT_CONTAINED)
        return None

    def count_reject(self, tenant: str, reason: str) -> None:
        self.admission.count_reject(tenant, reason)
        self.stats.count_reject(tenant, reason)

    def doom_depth(self, tenant: str, global_depth: int) -> Optional[int]:
        """Tenant-aware depth for the doomed-deadline predictor, or None
        when the plane is off (global behavior)."""
        if not self.enabled:
            return None
        return self.admission.doom_depth(tenant, global_depth)

    # -- the cut (engine queue lock held) -----------------------------------

    def cut(self, queue, n: int) -> List[Any]:
        return self.cutter.cut(queue, n)

    def on_enqueue(self, tenant: str) -> None:
        if self.enabled:
            self.admission.on_enqueue(tenant)

    def on_dequeue(self, batch) -> None:
        if self.enabled:
            self.admission.on_dequeue(batch)

    def has_contained(self) -> bool:
        return self.enabled and self.detector.has_contained()

    def is_contained(self, tenant: str) -> bool:
        return self.enabled and self.detector.is_contained(tenant)

    def split_contained(self, batch) -> Tuple[List[Any], List[Any]]:
        """(keep, diverted): contained tenants' rows peel off into a part
        of their own, which the engine launches behind the cut's others."""
        keep, div = [], []
        for p in batch:
            (div if self.detector.is_contained(p.config_name)
             else keep).append(p)
        return keep, div

    # -- the per-batch fold --------------------------------------------------

    def fold(self, heat, rows, firing=None, shards=None, waits=None,
             bad_mask=None, denied_mask=None,
             lane: Optional[str] = None) -> None:
        if not self.enabled:
            return
        self.stats.fold(heat, rows, firing=firing, shards=shards,
                        waits=waits, bad_mask=bad_mask,
                        denied_mask=denied_mask, lane=lane)
        self.detector.maybe_check()

    # -- introspection -------------------------------------------------------

    def to_json(self) -> Dict[str, Any]:
        return {
            "enabled": self.enabled,
            "lane": self.lane,
            "weights": self.book.to_json(),
            "fair_cut": self.cutter.to_json(),
            "admission": self.admission.to_json(),
            "stats": self.stats.to_json(),
            "containment": self.detector.to_json(),
        }
