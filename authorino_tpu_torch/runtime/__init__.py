"""Serving runtime: the micro-batching engine."""

from .engine import EngineEntry, PolicyEngine  # noqa: F401
