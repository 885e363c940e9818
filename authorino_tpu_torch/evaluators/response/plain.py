"""Plain response: a single resolved value
(ref: pkg/evaluators/response/plain.go:14-17)."""

from __future__ import annotations

from ...authjson.value import JSONValue


class Plain:
    def __init__(self, value: JSONValue):
        self.value = value

    async def call(self, pipeline):
        return self.value.resolve_for(pipeline.authorization_json())
