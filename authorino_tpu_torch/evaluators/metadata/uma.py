"""UMA resource metadata (semantics: ref pkg/evaluators/metadata/uma.go):
UMA2 discovery, PAT via client credentials, resources-by-URI lookup and
concurrent fetch of each resource by id (ref :41-97, :149-261)."""

from __future__ import annotations

import asyncio
from typing import Any, Dict, Optional

from ...utils import http as http_util
from ..base import EvaluationError


class UMA:
    def __init__(self, endpoint: str, client_id: str, client_secret: str):
        self.endpoint = endpoint.rstrip("/")
        self.client_id = client_id
        self.client_secret = client_secret
        self._config: Optional[Dict[str, Any]] = None
        self._lock = asyncio.Lock()

    async def _discover(self) -> Dict[str, Any]:
        """(ref :174-200)"""
        async with self._lock:
            if self._config is None:
                config = http_util.parse_response(await http_util.request(
                    "GET", f"{self.endpoint}/.well-known/uma2-configuration"))
                if not isinstance(config, dict) or "resource_registration_endpoint" not in config:
                    raise EvaluationError("failed UMA discovery: no resource_registration_endpoint")
                self._config = config
            return self._config

    async def _pat(self, config: Dict[str, Any]) -> str:
        payload = http_util.parse_response(await http_util.request(
            "POST",
            config["token_endpoint"],
            data={"grant_type": "client_credentials"},
            auth=(self.client_id, self.client_secret),
        ))
        token = payload.get("access_token") if isinstance(payload, dict) else None
        if not token:
            raise EvaluationError("failed to fetch UMA protection API token")
        return token

    async def call(self, pipeline) -> Any:
        config = await self._discover()
        pat = await self._pat(config)
        registration = config["resource_registration_endpoint"]
        uri = pipeline.authorization_json()["request"]["url_path"]
        headers = {"Authorization": f"Bearer {pat}"}
        try:
            ids = http_util.parse_response(await http_util.request(
                "GET", registration, params={"uri": uri}, headers=headers))
        except http_util.HttpError as e:
            raise EvaluationError(str(e))
        if not isinstance(ids, list):
            raise EvaluationError(f"unexpected resource list: {ids!r}")

        # fetch each resource concurrently (ref :73-97 goroutine fan-out)
        async def fetch(resource_id: str):
            return http_util.parse_response(await http_util.request(
                "GET", f"{registration}/{resource_id}", headers=headers))

        try:
            return list(await asyncio.gather(*(fetch(i) for i in ids)))
        except http_util.HttpError as e:
            raise EvaluationError(str(e))
