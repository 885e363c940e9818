"""Evaluator framework: phase wrappers, runtime AuthConfig, leaf evaluators.

Each leaf package imports only the evaluators the port holds."""

from .base import (  # noqa: F401
    AuthorizationConfig,
    CallbackConfig,
    DenyWith,
    DenyWithValues,
    EvaluationError,
    IdentityConfig,
    IdentityExtension,
    MetadataConfig,
    PhaseConfig,
    ResponseConfig,
    RuntimeAuthConfig,
    wrap_responses,
)
from .cache import EvaluatorCache  # noqa: F401
from .credentials import AuthCredentials, CredentialNotFound  # noqa: F401
