"""Control plane: reconcilers, translation, resource sources, status."""

from .reconciler import AuthConfigReconciler, SecretReconciler, StatusReportMap  # noqa: F401
from .status_updater import AuthConfigStatusUpdater  # noqa: F401
from .translate import TranslationError, translate_auth_config  # noqa: F401
