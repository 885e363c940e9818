"""Plain identity: resolves the identity object straight from the
Authorization JSON via a selector (ref: pkg/evaluators/identity/plain.go:19)."""

from __future__ import annotations

from ...authjson import selector
from ..base import EvaluationError


class Plain:
    def __init__(self, selector_path: str):
        self.selector_path = selector_path

    async def call(self, pipeline):
        res = selector.get(pipeline.authorization_json(), self.selector_path)
        if not res.exists or res.value is None:
            raise EvaluationError("could not retrieve identity object or null")
        return res.value
