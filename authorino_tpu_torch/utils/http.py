"""Shared outbound HTTP on the standard library (the card's machine has no
``aiohttp``): ``urllib.request`` on a bounded thread pool, awaited through
``loop.run_in_executor`` so no call blocks the pipeline's event loop.
JSON-or-text response parsing with the reference's tolerance (ref:
pkg/json/json.go:63-94 UnmashalJSONResponse).

What the callers see is what an aiohttp session gives them: a ``data=``
dict is form-encoded, ``auth=(user, password)`` is Basic auth, ``params=``
extends the query string, redirects of a GET are followed (at most 10),
and the environment's proxy variables are ignored (aiohttp's default
``trust_env=False``).  Every request has a timeout."""

from __future__ import annotations

import asyncio
import base64
import json
import threading
import urllib.error
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from email.message import Message
from typing import Any, Dict, Mapping, Optional, Tuple, Union

__all__ = ["Response", "request", "parse_response", "HttpError",
           "close_sessions"]

TIMEOUT_S = 30.0
MAX_WORKERS = 16
# characters a URL may carry as they are; anything else is percent-encoded
# (and an existing %XX escape is kept), as aiohttp's URL parsing does
_URL_SAFE = "!#$%&'()*+,-./:;=?@[]_~"

_lock = threading.Lock()
_pool: Optional[ThreadPoolExecutor] = None
# no ProxyHandler entries: the environment's proxy variables are ignored
_opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))


class HttpError(Exception):
    def __init__(self, status: int, body: str):
        self.status = status
        self.body = body
        super().__init__(f"{status}: {body[:200]}")


@dataclass
class Response:
    status: int
    headers: Message
    body: bytes

    def text(self) -> str:
        """The body decoded by its charset, UTF-8 when it names none."""
        return self.body.decode(self.headers.get_content_charset() or "utf-8")


def _executor() -> ThreadPoolExecutor:
    global _pool
    with _lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(MAX_WORKERS,
                                       thread_name_prefix="authorino-http")
        return _pool


async def close_sessions() -> None:
    """Stop the worker threads (a later request starts new ones)."""
    global _pool
    with _lock:
        pool, _pool = _pool, None
    if pool is not None:
        pool.shutdown(wait=False)


def _open(method: str, url: str, headers: Dict[str, str],
          data: Optional[bytes]) -> Response:
    req = urllib.request.Request(url, data=data, headers=headers,
                                 method=method)
    try:
        with _opener.open(req, timeout=TIMEOUT_S) as r:
            return Response(r.status, r.headers, r.read())
    except urllib.error.HTTPError as e:  # any status but 2xx
        with e:
            return Response(e.code, e.headers, e.read())


async def request(method: str, url: str, *,
                  headers: Optional[Mapping[str, str]] = None,
                  data: Union[bytes, Mapping[str, str], None] = None,
                  params: Optional[Mapping[str, str]] = None,
                  auth: Optional[Tuple[str, str]] = None) -> Response:
    """One request; raises OSError (URLError, a timeout) when no response
    came back."""
    hdrs = dict(headers or {})
    if isinstance(data, Mapping):
        data = urllib.parse.urlencode(data).encode()
        hdrs.setdefault("Content-Type", "application/x-www-form-urlencoded")
    if auth is not None:
        cred = f"{auth[0]}:{auth[1]}".encode("latin-1")
        hdrs["Authorization"] = "Basic " + base64.b64encode(cred).decode()
    if params:
        url = f"{url}{'&' if '?' in url else '?'}{urllib.parse.urlencode(params)}"
    url = urllib.parse.quote(url, safe=_URL_SAFE)
    loop = asyncio.get_running_loop()
    return await loop.run_in_executor(_executor(), _open, method.upper(),
                                      url, hdrs, data)


def parse_response(resp: Response) -> Any:
    """Status must be 200; body decodes as JSON when possible, else returns
    the raw text (ref: pkg/evaluators/metadata/generic_http.go:82-87 parses
    JSON content-type, other content types resolve as plain text)."""
    body = resp.text()
    if resp.status != 200:
        raise HttpError(resp.status, body)
    ctype = resp.headers.get("Content-Type", "")
    if "application/json" in ctype:
        try:
            return json.loads(body)
        except Exception as e:
            raise HttpError(resp.status, f"got Content-Type = application/json, but could not unmarshal as JSON: {e}")
    try:
        return json.loads(body)
    except Exception:
        return body
