"""Host-indexed AuthConfig storage (radix tree with wildcards)."""

from .index import HostIndex, IndexError_  # noqa: F401
