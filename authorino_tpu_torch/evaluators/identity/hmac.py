"""HMAC identity — a declared-but-unimplemented stub in the reference too
(ref: pkg/evaluators/identity/hmac.go:15 returns a TODO error)."""

from __future__ import annotations

from ..base import EvaluationError


class HMAC:
    def __init__(self, name: str = "", secret: str = ""):
        self.name = name
        self.secret = secret

    async def call(self, pipeline):
        raise EvaluationError("HMAC identity verification is not implemented")
