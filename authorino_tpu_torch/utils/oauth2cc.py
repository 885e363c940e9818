"""OAuth2 client-credentials token source with validity-aware caching
(ref: pkg/oauth2/client_credentials.go:35-52)."""

from __future__ import annotations

import asyncio
import time
from typing import List, Optional

from . import http as http_util

__all__ = ["ClientCredentials"]


class ClientCredentials:
    def __init__(self, token_url: str, client_id: str, client_secret: str, scopes: Optional[List[str]] = None):
        self.token_url = token_url
        self.client_id = client_id
        self.client_secret = client_secret
        self.scopes = scopes or []
        self._token: Optional[str] = None
        self._expires_at: float = 0.0
        self._lock = asyncio.Lock()

    async def token(self, force: bool = False) -> str:
        async with self._lock:
            if not force and self._token and time.time() < self._expires_at - 10:
                return self._token
            data = {"grant_type": "client_credentials"}
            if self.scopes:
                data["scope"] = " ".join(self.scopes)
            payload = http_util.parse_response(await http_util.request(
                "POST", self.token_url, data=data,
                auth=(self.client_id, self.client_secret)))
            if not isinstance(payload, dict) or "access_token" not in payload:
                raise http_util.HttpError(500, f"invalid token response: {payload!r}")
            self._token = payload["access_token"]
            self._expires_at = time.time() + float(payload.get("expires_in", 60))
            return self._token
