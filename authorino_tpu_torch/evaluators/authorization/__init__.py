"""Authorization leaf evaluators: pattern matching, OPA/Rego (inline or
from a registry), Kubernetes SubjectAccessReview and SpiceDB."""

from .authzed import Authzed  # noqa: F401
from .kubernetes_sar import KubernetesAuthz  # noqa: F401
from .opa import OPA, OPAExternalSource  # noqa: F401
from .pattern_matching import PatternMatching  # noqa: F401
