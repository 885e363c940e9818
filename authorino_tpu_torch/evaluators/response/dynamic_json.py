"""Dynamic JSON response: named properties resolved from the Authorization
JSON (ref: pkg/evaluators/response/dynamic_json.go:20-31)."""

from __future__ import annotations

from typing import List

from ...authjson.value import JSONProperty


class DynamicJSON:
    def __init__(self, properties: List[JSONProperty]):
        self.properties = properties

    async def call(self, pipeline):
        doc = pipeline.authorization_json()
        return {p.name: p.value.resolve_for(doc) for p in self.properties}
