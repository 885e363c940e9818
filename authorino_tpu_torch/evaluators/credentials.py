"""Auth credentials: where secrets live in the request and how they travel
outbound (semantics: ref pkg/auth/credentials.go:31-170)."""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Tuple

from ..authjson.wellknown import HttpRequestAttributes

__all__ = ["AuthCredentials", "CredentialNotFound"]

LOCATION_AUTH_HEADER = "authorization_header"
LOCATION_CUSTOM_HEADER = "custom_header"
LOCATION_COOKIE = "cookie"
LOCATION_QUERY = "query"

DEFAULT_KEY_SELECTOR = "Bearer"


class CredentialNotFound(Exception):
    def __init__(self, msg: str = "credential not found"):
        super().__init__(msg)


@dataclass
class AuthCredentials:
    key_selector: str = DEFAULT_KEY_SELECTOR
    location: str = LOCATION_AUTH_HEADER

    def __post_init__(self):
        if not self.key_selector:
            self.key_selector = DEFAULT_KEY_SELECTOR
        if not self.location:
            self.location = LOCATION_AUTH_HEADER

    def extract(self, http: HttpRequestAttributes) -> str:
        """Credential from the request (ref :62-75); raises CredentialNotFound."""
        headers = http.headers
        loc = self.location
        if loc == LOCATION_CUSTOM_HEADER:
            v = headers.get(self.key_selector.lower())
            if v is None:
                raise CredentialNotFound()
            return v
        if loc == LOCATION_AUTH_HEADER:
            auth = headers.get("authorization")
            if auth is None:
                raise CredentialNotFound()
            prefix = self.key_selector + " "
            if auth.startswith(prefix):
                return auth[len(prefix):]
            raise CredentialNotFound()
        if loc == LOCATION_COOKIE:
            cookie = headers.get("cookie")
            if cookie is None:
                raise CredentialNotFound()
            for part in cookie.split(";"):
                kv = part.strip()
                if kv.startswith(self.key_selector + "="):
                    return kv[len(self.key_selector) + 1:]
            raise CredentialNotFound()
        if loc == LOCATION_QUERY:
            m = re.search(r"[?&]" + re.escape(self.key_selector) + r"=([^&]*)", http.path)
            if not m:
                raise CredentialNotFound()
            return m.group(1)
        raise CredentialNotFound("the credential location is not supported")

    def outbound(self, endpoint: str, credential: str) -> Tuple[str, Dict[str, str]]:
        """(url, headers) carrying the credential outbound (ref :85-123)."""
        headers: Dict[str, str] = {}
        url = endpoint
        if not credential:
            return url, headers
        loc = self.location
        if loc == LOCATION_QUERY:
            sep = "&" if "?" in url else "?"
            url = f"{url}{sep}{self.key_selector}={credential}"
        elif loc == LOCATION_AUTH_HEADER:
            headers["Authorization"] = f"{self.key_selector} {credential}"
        elif loc == LOCATION_CUSTOM_HEADER:
            headers[self.key_selector] = credential
        elif loc == LOCATION_COOKIE:
            headers["Cookie"] = f"{self.key_selector}={credential}"
        return url, headers
