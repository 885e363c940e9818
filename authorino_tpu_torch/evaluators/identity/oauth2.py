"""OAuth2 opaque-token identity via RFC 7662 introspection
(semantics: ref pkg/evaluators/identity/oauth2.go:19-104): POST the token
with client credentials; the token must introspect ``active: true``."""

from __future__ import annotations

from typing import Optional

from ...utils import http as http_util
from ..base import EvaluationError
from ..credentials import AuthCredentials, CredentialNotFound


class OAuth2:
    def __init__(
        self,
        name: str,
        token_introspection_url: str,
        client_id: str,
        client_secret: str,
        token_type_hint: str = "access_token",
        credentials: Optional[AuthCredentials] = None,
    ):
        self.name = name
        self.token_introspection_url = token_introspection_url
        self.client_id = client_id
        self.client_secret = client_secret
        self.token_type_hint = token_type_hint or "access_token"
        self.credentials = credentials or AuthCredentials()

    async def call(self, pipeline):
        try:
            token = self.credentials.extract(pipeline.request.http)
        except CredentialNotFound as e:
            raise EvaluationError(str(e))
        try:
            payload = http_util.parse_response(await http_util.request(
                "POST",
                self.token_introspection_url,
                data={"token": token, "token_type_hint": self.token_type_hint},
                auth=(self.client_id, self.client_secret),
            ))
        except http_util.HttpError as e:
            raise EvaluationError(f"failed to introspect token: {e}")
        if not isinstance(payload, dict) or not payload.get("active"):
            raise EvaluationError("token is not active")
        return payload
