"""Authorization leaf evaluators: pattern matching."""

from .pattern_matching import PatternMatching  # noqa: F401
