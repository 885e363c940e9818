"""Authorization leaf evaluators: pattern matching, inline OPA/Rego and
Kubernetes SubjectAccessReview."""

from .kubernetes_sar import KubernetesAuthz  # noqa: F401
from .opa import OPA  # noqa: F401
from .pattern_matching import PatternMatching  # noqa: F401
