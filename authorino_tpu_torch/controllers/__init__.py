"""Control plane: AuthConfig translation."""

from .translate import TranslationError, translate_auth_config  # noqa: F401
