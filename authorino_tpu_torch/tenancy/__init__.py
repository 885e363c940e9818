"""Tenant QoS plane: weighted-fair batch cuts,
per-tenant SLO/quotas, and noisy-neighbor containment — the tenant is the
(AuthConfig/host) identity every kernel row already carries as
``config_id``."""

from .containment import NoisyNeighborDetector
from .fair_cut import FairCutter
from .plane import TenantPlane
from .quota import R_TENANT_CONTAINED, R_TENANT_QUOTA, TenantAdmission, TokenBucket
from .stats import TenantStats
from .weights import (
    CLASS_ANNOTATION,
    DEFAULT_WEIGHT,
    QOS_CLASSES,
    QUOTA_ANNOTATION,
    WEIGHT_ANNOTATION,
    WeightBook,
)

__all__ = [
    "TenantPlane", "FairCutter", "TenantAdmission", "TenantStats",
    "NoisyNeighborDetector", "TokenBucket", "WeightBook",
    "WEIGHT_ANNOTATION", "CLASS_ANNOTATION", "QUOTA_ANNOTATION",
    "QOS_CLASSES", "DEFAULT_WEIGHT", "R_TENANT_QUOTA",
    "R_TENANT_CONTAINED",
]
