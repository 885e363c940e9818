"""Identity leaf evaluators: API key, mTLS, OIDC/JWT, OAuth2
introspection, plain, anonymous, Kubernetes TokenReview and the HMAC
stub."""

from .api_key import APIKey  # noqa: F401
from .hmac import HMAC  # noqa: F401
from .kubernetes import KubernetesAuth  # noqa: F401
from .mtls import MTLS  # noqa: F401
from .noop import Noop  # noqa: F401
from .oauth2 import OAuth2  # noqa: F401
from .oidc import OIDC  # noqa: F401
from .plain import Plain  # noqa: F401
