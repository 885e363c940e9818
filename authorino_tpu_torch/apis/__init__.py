"""AuthConfig API shapes: v1beta1 (storage) ↔ v1beta2 (user-facing) conversion."""

from .convert import to_v1beta1, to_v1beta2  # noqa: F401
