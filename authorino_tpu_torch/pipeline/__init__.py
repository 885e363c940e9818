"""Request-time engine: 5-phase AuthPipeline + micro-batching."""

from .pipeline import AuthPipeline, AuthResult  # noqa: F401
