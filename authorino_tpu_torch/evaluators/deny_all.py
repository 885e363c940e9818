"""Synthetic deny-all authorization used while AuthConfigs bootstrap
(ref: pkg/evaluators/deny_all.go:10-20 — an OPA `allow = false` config;
here a constant-deny evaluator with the same effect + 503 denyWith)."""

from __future__ import annotations

from .base import AuthorizationConfig, DenyWith, DenyWithValues, EvaluationError, RuntimeAuthConfig


class _DenyAll:
    async def call(self, pipeline):
        raise EvaluationError("Not authorized")


def new_deny_all_config(labels=None) -> RuntimeAuthConfig:
    """Deny-all with 503 "Busy" (ref: controllers/auth_config_controller.go:663-690)."""
    from ..authjson.value import JSONValue

    return RuntimeAuthConfig(
        labels=labels or {},
        authorization=[AuthorizationConfig("deny-all", _DenyAll())],
        deny_with=DenyWith(
            unauthorized=DenyWithValues(code=503, message=JSONValue(static="Busy"))
        ),
    )
