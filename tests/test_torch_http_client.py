"""The port's standard-library HTTP client against the JAX package's aiohttp
session, both driven against one loopback ``ThreadingHTTPServer``: every
(method, redirect code) pair, the redirect limit, a relative and a
cross-origin ``Location``, and the query and path escapes a templated
endpoint can produce give the same status and body in both."""

import asyncio
import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from authorino_tpu.utils import http as ref_http
from authorino_tpu_torch.utils import http as port_http

METHODS = ("GET", "POST", "PUT", "PATCH", "DELETE")
CODES = (301, 302, 303, 307, 308)


class _Handler(BaseHTTPRequestHandler):
    """/redirect/<code>?to=<url>: answers <code> with that Location;
    /chain/<k>: k more 307s before the echo; /nolocation: a 302 without a
    Location; anything else echoes the request as it arrived."""

    def _serve(self):
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        url = urllib.parse.urlsplit(self.path)
        parts = url.path.split("/")
        query = dict(urllib.parse.parse_qsl(url.query))
        if parts[1] == "redirect":
            self._answer(int(parts[2]), b"moved",
                         Location=query.get("to", "/echo"))
        elif parts[1] == "chain":
            k = int(parts[2])
            self._answer(307, b"", Location=f"/chain/{k - 1}" if k
                         else "/echo/chained")
        elif parts[1] == "nolocation":
            self._answer(302, b"no location here")
        else:
            out = {"method": self.command, "target": self.path,
                   "body": body.decode(),
                   "content_type": self.headers.get("Content-Type"),
                   "authorization": self.headers.get("Authorization"),
                   "server": self.server.server_address[1] == ORIGIN_PORT[0]}
            self._answer(200, json.dumps(out).encode(),
                         **{"Content-Type": "application/json"})

    def _answer(self, status, body, **headers):
        self.send_response(status)
        for k, v in headers.items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    do_GET = do_POST = do_PUT = do_PATCH = do_DELETE = _serve

    def log_message(self, *args):
        pass


ORIGIN_PORT = [0]


@pytest.fixture(scope="module")
def servers():
    started = []
    for _ in range(2):
        srv = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        started.append(srv)
    ORIGIN_PORT[0] = started[0].server_address[1]
    yield [f"http://127.0.0.1:{s.server_address[1]}" for s in started]
    for srv in started:
        srv.shutdown()
        srv.server_close()


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def both(method, url, **kw):
    """(status, body) from each client, or ("error", exception class name
    family) when no final response came back."""

    async def ref():
        try:
            async with ref_http.get_session().request(method, url,
                                                      **kw) as resp:
                return resp.status, await resp.text()
        except Exception as e:
            return "error", type(e).__name__
        finally:
            await ref_http.close_sessions()

    async def port():
        try:
            resp = await port_http.request(method, url, **kw)
            return resp.status, resp.text()
        except Exception as e:
            return "error", type(e).__name__

    return run(ref()), run(port())


def body_kw(method):
    if method == "GET":
        return {}
    return {"data": b'{"a": 1}', "headers": {"Content-Type":
                                             "application/json"}}


@pytest.mark.parametrize("code", CODES)
@pytest.mark.parametrize("method", METHODS)
def test_redirect_equals_reference(servers, method, code):
    want, got = both(method, f"{servers[0]}/redirect/{code}?to=/echo/after",
                     **body_kw(method))
    assert got == want
    assert want[0] == 200


@pytest.mark.parametrize("method", ["GET", "POST"])
def test_form_body_across_a_redirect_equals_reference(servers, method):
    for code in (302, 307):
        want, got = both(method, f"{servers[0]}/redirect/{code}?to=/echo",
                         data={"token": "t 1", "x": "%"})
        assert got == want


@pytest.mark.parametrize("hops,ok", [(9, True), (10, False)])
def test_redirect_limit_equals_reference(servers, hops, ok):
    want, got = both("POST", f"{servers[0]}/chain/{hops - 1}",
                     data=b"payload")
    assert (want[0] == 200) is ok
    assert got[0] == want[0]
    if ok:
        assert got == want


def test_missing_location_answers_the_3xx_as_the_reference(servers):
    want, got = both("GET", f"{servers[0]}/nolocation")
    assert got == want == (302, "no location here")


@pytest.mark.parametrize("method", ["GET", "POST"])
def test_cross_origin_redirect_drops_authorization(servers, method):
    to = urllib.parse.quote(f"{servers[1]}/echo/elsewhere", safe="")
    for base, target in ((servers[0], to), (servers[0], "/echo/same")):
        want, got = both(method, f"{base}/redirect/307?to={target}",
                         data=b"x", headers={"Authorization": "Bearer t"})
        assert got == want
        assert (json.loads(want[1])["authorization"] is None) == \
            (target == to)


ESCAPES = {
    "space in query": "/echo?q=a b",
    "stray percent in query": "/echo?q=100%",
    "stray percent before text": "/echo?q=50% off",
    "escaped slash in query": "/echo?q=a%2Fb",
    "lower-case escape in query": "/echo?q=a%2fb%3d",
    "escaped space in query": "/echo?q=a%20b",
    "plus and ampersand": "/echo?q=a+b&r=c%26d",
    "non-ASCII in query": "/echo?q=café",
    "space in path": "/echo/a b",
    "stray percent in path": "/echo/100%",
    "escaped slash in path": "/echo/x%2Fy",
    "fragment": "/echo?q=1#frag ment",
    "empty query": "/echo?",
}


@pytest.mark.parametrize("case", sorted(ESCAPES))
def test_url_escaping_equals_reference(servers, case):
    want, got = both("GET", servers[0] + ESCAPES[case])
    assert got == want


@pytest.mark.parametrize("params", [{"uri": "/a b?c=d"},
                                    {"q": "50% & more", "r": "x=y;z+w"}])
def test_params_escaping_equals_reference(servers, params):
    for path in ("/echo", "/echo?k=v"):
        want, got = both("GET", servers[0] + path, params=params)
        assert got == want


def test_timeout_defaults_to_aiohttps_total():
    import inspect

    import aiohttp

    sig = inspect.signature(port_http.request)
    assert sig.parameters["timeout"].default == port_http.TIMEOUT_S
    assert port_http.TIMEOUT_S == aiohttp.ClientTimeout().total or \
        aiohttp.client.DEFAULT_TIMEOUT.total == port_http.TIMEOUT_S
