"""Authorization leaf evaluators: pattern matching, OPA/Rego (inline or
from a registry) and Kubernetes SubjectAccessReview."""

from .kubernetes_sar import KubernetesAuthz  # noqa: F401
from .opa import OPA, OPAExternalSource  # noqa: F401
from .pattern_matching import PatternMatching  # noqa: F401
