"""Anonymous access: resolves ``{"anonymous": true}``
(ref: pkg/evaluators/identity/noop.go:17)."""

from __future__ import annotations

from ..credentials import AuthCredentials


class Noop:
    def __init__(self, credentials: AuthCredentials | None = None):
        self.credentials = credentials or AuthCredentials()

    async def call(self, pipeline):
        return {"anonymous": True}
