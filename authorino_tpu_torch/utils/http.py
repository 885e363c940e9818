"""Shared outbound HTTP on the standard library (the card's machine has no
``aiohttp``): ``urllib.request`` on a bounded thread pool, awaited through
``loop.run_in_executor`` so no call blocks the pipeline's event loop.
JSON-or-text response parsing with the reference's tolerance (ref:
pkg/json/json.go:63-94 UnmashalJSONResponse).

What the callers see is what an aiohttp session with its defaults gives
them: a ``data=`` dict is form-encoded, ``auth=(user, password)`` is Basic
auth, ``params=`` extends the query string, and the environment's proxy
variables are ignored (``trust_env=False``).  Redirects are followed for
every method as aiohttp follows them: a 303 (and a 301/302 answering a
POST) turns into a GET without a body, any other 301/302/307/308 keeps the
method and the body, the ``Authorization`` header is dropped when the
redirect leaves the origin, and the tenth redirect in a row raises
``TooManyRedirects``.  A URL is requoted as ``yarl`` requotes it (a space
in the query becomes ``+``, a stray ``%`` becomes ``%25``, an escape of a
character the component allows is decoded).  A request's timeout is
aiohttp's default total of 300 s unless the caller passes another; the
Check() itself is bounded by the engine's ``timeout_s`` and its deadline.

``ssl=`` takes an ``ssl.SSLContext`` for an HTTPS origin with its own CA
(aiohttp's keyword).  ``LineStream`` is the streamed read a Kubernetes
watch needs: one ``http.client`` connection whose body a thread of its own
reads, its lines handed to the event loop; ``close()`` shuts the socket,
which ends a read blocked on it at once."""

from __future__ import annotations

import asyncio
import base64
import http.client
import json
import socket
import ssl as ssl_mod
import string
import threading
import urllib.error
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from email.message import Message
from typing import Any, AsyncIterator, Dict, Mapping, Optional, Tuple, Union

__all__ = ["Response", "request", "parse_response", "HttpError",
           "TooManyRedirects", "close_sessions", "LineStream"]

# aiohttp's default ClientTimeout total
TIMEOUT_S = 300.0
MAX_WORKERS = 16
# aiohttp's max_redirects: the tenth redirect in a row raises
MAX_REDIRECTS = 10
REDIRECT_CODES = (301, 302, 303, 307, 308)

_lock = threading.Lock()
_pool: Optional[ThreadPoolExecutor] = None


class _NoRedirect(urllib.request.HTTPRedirectHandler):
    """Hand every 3xx back as a response: ``_open`` follows redirects."""

    def redirect_request(self, req, fp, code, msg, headers, newurl):
        return None


def _build_opener(context: Optional[ssl_mod.SSLContext] = None):
    # no ProxyHandler entries: the environment's proxy variables are ignored
    handlers = [urllib.request.ProxyHandler({}), _NoRedirect()]
    if context is not None:
        handlers.append(urllib.request.HTTPSHandler(context=context))
    return urllib.request.build_opener(*handlers)


_opener = _build_opener()


class HttpError(Exception):
    def __init__(self, status: int, body: str):
        self.status = status
        self.body = body
        super().__init__(f"{status}: {body[:200]}")


class TooManyRedirects(OSError):
    """The tenth redirect in a row (aiohttp's ``TooManyRedirects``)."""


@dataclass
class Response:
    status: int
    headers: Message
    body: bytes

    def text(self) -> str:
        """The body decoded by its charset, UTF-8 when it names none."""
        return self.body.decode(self.headers.get_content_charset() or "utf-8")


# ---- URL requoting, as yarl does it -----------------------------------------

_UNRESERVED = string.ascii_letters + string.digits + "-._~"
_SUB_DELIMS = "!$'()*,"
_HEX = set(string.hexdigits)


def _requote(val: str, safe: str, protected: str = "", qs: bool = False,
             requote: bool = True) -> str:
    """Percent-encode ``val`` the way yarl's quoter does: characters of
    ``safe`` (plus the unreserved and sub-delimiter sets, and ``+&=;`` out
    of a query) stay; an existing ``%XX`` escape is upper-cased and
    decoded when its character may stand bare and is not ``protected``; a
    ``%`` that starts no escape becomes ``%25``; in a query (``qs``) a
    space becomes ``+``; anything else becomes its UTF-8 ``%XX`` bytes."""
    allowed = set(safe + _UNRESERVED + _SUB_DELIMS + protected
                  + ("" if qs else "+&=;"))
    out = []
    i, n = 0, len(val)
    while i < n:
        ch = val[i]
        if ch == "%" and requote:
            esc = val[i + 1:i + 3]
            if len(esc) == 2 and set(esc) <= _HEX:
                esc = esc.upper()
                bare = chr(int(esc, 16))
                out.append(bare if bare in allowed and bare not in protected
                           else "%" + esc)
                i += 3
                continue
            out.append("%25")
            i += 1
            continue
        if qs and ch == " ":
            out.append("+")
        elif ch in allowed:
            out.append(ch)
        else:
            out.extend(f"%{b:02X}" for b in ch.encode("utf-8", "ignore"))
        i += 1
    return "".join(out)


def _requote_url(url: str) -> str:
    """The request target aiohttp sends for ``url``: path and query
    requoted (yarl's PATH_REQUOTER and QUERY_REQUOTER), an empty query
    dropped, the fragment left off."""
    parts = urllib.parse.urlsplit(url)
    path = _requote(parts.path, safe="@:", protected="/+") or "/"
    query = _requote(parts.query, safe="?/:@", protected="=+&;", qs=True)
    return urllib.parse.urlunsplit(
        (parts.scheme, parts.netloc, path, query, ""))


def _query_of(params: Mapping[str, str]) -> str:
    """``params`` as yarl encodes a query mapping (QUERY_PART_QUOTER)."""
    def q(v):
        return _requote(str(v), safe="?/:@", qs=True, requote=False)

    return "&".join(f"{q(k)}={q(v)}" for k, v in params.items())


def _origin(url: str) -> Tuple[str, str]:
    parts = urllib.parse.urlsplit(url)
    return parts.scheme, parts.netloc.rsplit("@", 1)[-1].lower()


# ---- the client -------------------------------------------------------------

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


def _send(method: str, url: str, headers: Dict[str, str],
          data: Optional[bytes], form: bool,
          timeout: Optional[float], opener) -> Response:
    if data is not None and not any(k.lower() == "content-type"
                                    for k in headers):
        # the payload's own type, which goes with the body (aiohttp's; urllib
        # would call raw bytes a form)
        headers = dict(headers, **{"Content-Type": (
            "application/x-www-form-urlencoded" if form
            else "application/octet-stream")})
    req = urllib.request.Request(url, data=data, headers=headers,
                                 method=method)
    try:
        with opener.open(req, timeout=timeout) as r:
            return Response(r.status, r.headers, r.read())
    except urllib.error.HTTPError as e:  # any status but 2xx, 3xx included
        with e:
            return Response(e.code, e.headers, e.read())


def _open(method: str, url: str, headers: Dict[str, str],
          data: Optional[bytes], form: bool,
          timeout: Optional[float], opener=_opener) -> Response:
    """One request and the redirects aiohttp would follow from it."""
    redirects = 0
    while True:
        resp = _send(method, url, headers, data, form, timeout, opener)
        if resp.status not in REDIRECT_CODES:
            return resp
        redirects += 1
        if redirects >= MAX_REDIRECTS:
            raise TooManyRedirects(
                f"{resp.status}, message='Too many redirects', url={url!r}")
        if (resp.status == 303 and method != "HEAD") or (
                resp.status in (301, 302) and method == "POST"):
            method, data = "GET", None
            headers = {k: v for k, v in headers.items()
                       if k.lower() != "content-length"}
        location = resp.headers.get("Location") or resp.headers.get("URI")
        if location is None:
            return resp
        target = urllib.parse.urljoin(url, location)
        if urllib.parse.urlsplit(target).scheme not in ("http", "https"):
            raise OSError(f"redirect to a non-HTTP URL {location!r}")
        if _origin(target) != _origin(url):
            headers = {k: v for k, v in headers.items()
                       if k.lower() != "authorization"}
        url = _requote_url(target)


async def request(method: str, url: str, *,
                  headers: Optional[Mapping[str, str]] = None,
                  data: Union[bytes, Mapping[str, str], None] = None,
                  params: Optional[Mapping[str, str]] = None,
                  auth: Optional[Tuple[str, str]] = None,
                  timeout: Optional[float] = TIMEOUT_S,
                  ssl: Optional[ssl_mod.SSLContext] = None) -> Response:
    """One request, redirects followed; raises OSError (URLError, a
    timeout, TooManyRedirects) when no final response came back.
    ``timeout`` (seconds; None for none) bounds each hop; ``ssl`` verifies
    an HTTPS origin against its context instead of the default one."""
    hdrs = dict(headers or {})
    form = isinstance(data, Mapping)
    if form:
        data = urllib.parse.urlencode(data).encode()
    if auth is not None:
        cred = f"{auth[0]}:{auth[1]}".encode("latin-1")
        hdrs["Authorization"] = "Basic " + base64.b64encode(cred).decode()
    url = _with_params(url, params)
    opener = _opener if ssl is None else _build_opener(ssl)
    loop = asyncio.get_running_loop()
    return await loop.run_in_executor(_executor(), _open, method.upper(),
                                      url, hdrs, data, form, timeout, opener)


def _with_params(url: str, params: Optional[Mapping[str, str]]) -> str:
    url = _requote_url(url)
    if params:
        url = f"{url}{'&' if '?' in url else '?'}{_query_of(params)}"
    return url


class LineStream:
    """A GET whose body streams in: ``status`` after ``open()``, then the
    body's non-empty lines (bytes, without the newline) from ``lines()``,
    as they arrive.  A thread of its own does the blocking reads; each
    read waits at most ``read_timeout`` seconds (``socket.timeout`` then
    ends the stream with that error).  ``close()``, from any thread, shuts
    the socket down, so a blocked read returns at once and the stream
    ends."""

    CHUNK = 65536

    def __init__(self, url: str, *, headers: Optional[Mapping[str, str]] = None,
                 params: Optional[Mapping[str, str]] = None,
                 read_timeout: Optional[float] = None,
                 ssl: Optional[ssl_mod.SSLContext] = None):
        self.url = _with_params(url, params)
        self.headers = dict(headers or {})
        self.read_timeout = read_timeout
        self.ssl = ssl
        self.status = 0
        self._conn: Optional[http.client.HTTPConnection] = None
        self._resp: Optional[http.client.HTTPResponse] = None
        self._closed = False

    def _connect(self) -> int:
        parts = urllib.parse.urlsplit(self.url)
        target = urllib.parse.urlunsplit(("", "", parts.path or "/",
                                          parts.query, ""))
        if parts.scheme == "https":
            conn = http.client.HTTPSConnection(
                parts.hostname, parts.port, timeout=self.read_timeout,
                context=self.ssl or ssl_mod.create_default_context())
        else:
            conn = http.client.HTTPConnection(parts.hostname, parts.port,
                                              timeout=self.read_timeout)
        self._conn = conn
        conn.request("GET", target, headers=self.headers)
        self._resp = conn.getresponse()
        return self._resp.status

    async def open(self) -> int:
        """Connect, send the request, read the status line and headers."""
        self.status = await asyncio.to_thread(self._connect)
        return self.status

    def body(self) -> str:
        """The rest of the body (for an error status)."""
        return self._resp.read().decode("utf-8", "replace")

    async def lines(self) -> AsyncIterator[bytes]:
        loop = asyncio.get_running_loop()
        queue: asyncio.Queue = asyncio.Queue()

        def put(item) -> None:
            try:
                loop.call_soon_threadsafe(queue.put_nowait, item)
            except RuntimeError:
                pass  # the loop closed: nobody reads the stream any more

        def reader() -> None:
            try:
                while True:
                    chunk = self._resp.read1(self.CHUNK)
                    if not chunk:
                        break
                    put(chunk)
                put(None)
            except BaseException as e:  # surfaced to the consumer
                put(e if not self._closed else None)

        threading.Thread(target=reader, name="authorino-http-stream",
                         daemon=True).start()
        buf = b""
        while True:
            item = await queue.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            buf += item
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                if line.strip():
                    yield line

    def close(self) -> None:
        self._closed = True
        conn = self._conn
        sock = getattr(conn, "sock", None) if conn is not None else None
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        if conn is not None:
            conn.close()


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
