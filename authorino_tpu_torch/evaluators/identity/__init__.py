"""Identity leaf evaluators: API key, plain, anonymous, Kubernetes
TokenReview and the HMAC stub."""

from .api_key import APIKey  # noqa: F401
from .hmac import HMAC  # noqa: F401
from .kubernetes import KubernetesAuth  # noqa: F401
from .noop import Noop  # noqa: F401
from .plain import Plain  # noqa: F401
