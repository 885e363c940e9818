"""OIDC/JWT identity: discovery + JWKS verification with TTL auto-refresh
(semantics: ref pkg/evaluators/identity/oidc.go:21-134; verification mirrors
go-oidc with client-id check skipped).  JWKS refresh rides a Worker and
stops on Clean (ref :116-133)."""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Dict, List, Optional

from ...utils import http as http_util
from ...utils import jose
from ...utils.workers import Worker
from ..base import EvaluationError
from ..credentials import AuthCredentials, CredentialNotFound

log = logging.getLogger(__name__)


class OIDC:
    def __init__(
        self,
        name: str,
        endpoint: str,
        ttl_s: int = 0,
        credentials: Optional[AuthCredentials] = None,
    ):
        self.name = name
        self.endpoint = endpoint.rstrip("/")
        self.ttl_s = ttl_s
        self.credentials = credentials or AuthCredentials()
        self.config: Dict[str, Any] = {}
        self.jwks: List[Dict[str, Any]] = []
        self._refresher: Optional[Worker] = None
        self._load_lock = asyncio.Lock()
        # fired when a refresh actually changes the key set / discovery doc
        self._change_listeners: List[Any] = []

    def add_change_listener(self, cb) -> None:
        if cb not in self._change_listeners:
            self._change_listeners.append(cb)

    def remove_change_listener(self, cb) -> None:
        if cb in self._change_listeners:
            self._change_listeners.remove(cb)

    # --- discovery (ref :41-103) ---

    def well_known_url(self) -> str:
        return f"{self.endpoint}/.well-known/openid-configuration"

    async def refresh(self) -> None:
        config = http_util.parse_response(
            await http_util.request("GET", self.well_known_url()))
        if not isinstance(config, dict) or "issuer" not in config:
            raise EvaluationError(f"invalid openid configuration from {self.endpoint}")
        jwks_uri = config.get("jwks_uri")
        jwks: List[Dict[str, Any]] = []
        if jwks_uri:
            payload = http_util.parse_response(
                await http_util.request("GET", jwks_uri))
            jwks = payload.get("keys", []) if isinstance(payload, dict) else []
        changed = bool(self.config) and (config != self.config or jwks != self.jwks)
        self.config = config
        self.jwks = jwks
        if self.ttl_s and self._refresher is None:
            self._refresher = Worker(self.ttl_s, self.refresh).start()
        if changed:
            for cb in list(self._change_listeners):
                try:
                    cb()
                except Exception:
                    log.exception("OIDC change listener failed")

    async def _ensure_loaded(self) -> None:
        if self.config:
            return
        async with self._load_lock:
            if not self.config:
                await self.refresh()

    # --- evaluation (ref :41-103) ---

    async def call(self, pipeline):
        try:
            token = self.credentials.extract(pipeline.request.http)
        except CredentialNotFound as e:
            raise EvaluationError(str(e))
        await self._ensure_loaded()
        try:
            claims = jose.verify_jws(token, self.jwks)
            jose.verify_jwt_claims(claims, issuer=self.config.get("issuer"))
        except jose.JoseError as e:
            raise EvaluationError(str(e))
        return claims

    async def clean(self) -> None:
        if self._refresher is not None:
            await self._refresher.stop()
            self._refresher = None

    def get_url(self, relative: str) -> str:
        """Resolve a provider endpoint from the discovery doc (ref :105-114)."""
        return self.config.get(relative, "")
