"""Generic HTTP metadata: templated endpoint + method/body/params/headers,
shared-secret or OAuth2 client-credentials auth, JSON-or-text response parse
(semantics: ref pkg/evaluators/metadata/generic_http.go:36-189).  Also reused
as the Callback evaluator, exactly like the reference
(ref: controllers/auth_config_controller.go:721 buildGenericHttpEvaluator)."""

from __future__ import annotations

import json
import urllib.parse
from typing import Any, Dict, List, Optional

from ...authjson.value import JSONProperty, JSONValue, stringify_json
from ...utils import http as http_util
from ...utils.oauth2cc import ClientCredentials
from ..base import EvaluationError
from ..credentials import AuthCredentials

CONTENT_TYPE_JSON = "application/json"
CONTENT_TYPE_FORM = "application/x-www-form-urlencoded"


class GenericHttp:
    def __init__(
        self,
        endpoint: JSONValue,
        method: str = "GET",
        body: Optional[JSONValue] = None,
        parameters: Optional[List[JSONProperty]] = None,
        headers: Optional[List[JSONProperty]] = None,
        content_type: str = CONTENT_TYPE_JSON,
        shared_secret: str = "",
        credentials: Optional[AuthCredentials] = None,
        oauth2: Optional[ClientCredentials] = None,
    ):
        self.endpoint = endpoint
        self.method = (method or "GET").upper()
        self.body = body
        self.parameters = parameters or []
        self.headers = headers or []
        self.content_type = content_type or CONTENT_TYPE_JSON
        self.shared_secret = shared_secret
        self.credentials = credentials or AuthCredentials()
        self.oauth2 = oauth2

    async def call(self, pipeline) -> Any:
        doc = pipeline.authorization_json()
        url = stringify_json(self.endpoint.resolve_for(doc))

        headers: Dict[str, str] = {}
        data: Optional[bytes] = None

        if self.method in ("POST", "PUT", "PATCH"):
            headers["Content-Type"] = self.content_type
            data = self._build_body(doc)
        elif self.parameters:
            # GET: parameters append to the query string (ref :99-115)
            qs = urllib.parse.urlencode(
                {p.name: stringify_json(p.value.resolve_for(doc)) for p in self.parameters}
            )
            url = f"{url}{'&' if '?' in url else '?'}{qs}"

        # auth: shared secret or oauth2 client credentials (ref :117-133)
        if self.oauth2 is not None:
            token = await self.oauth2.token()
            headers["Authorization"] = f"Bearer {token}"
        elif self.shared_secret:
            url, cred_headers = self.credentials.outbound(url, self.shared_secret)
            headers.update(cred_headers)

        for h in self.headers:
            headers[h.name] = stringify_json(h.value.resolve_for(doc))

        # W3C trace propagation into every outbound evaluator call
        # (ref: pkg/evaluators/metadata/generic_http.go:135 otelhttp injection)
        span = getattr(pipeline, "span", None)
        if span is not None:
            span.inject(headers)

        try:
            return http_util.parse_response(await http_util.request(
                self.method, url, headers=headers, data=data))
        except http_util.HttpError as e:
            raise EvaluationError(str(e))
        except Exception as e:
            raise EvaluationError(f"request failed: {e}")

    def _build_body(self, doc) -> bytes:
        """(ref :153-189): explicit body template, or parameters encoded per
        content type."""
        if self.body is not None:
            resolved = self.body.resolve_for(doc)
            return stringify_json(resolved).encode()
        values = {p.name: p.value.resolve_for(doc) for p in self.parameters}
        if self.content_type == CONTENT_TYPE_FORM:
            return urllib.parse.urlencode(
                {k: stringify_json(v) for k, v in values.items()}
            ).encode()
        return json.dumps(values, separators=(",", ":")).encode()
