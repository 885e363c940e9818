"""OIDC discovery server for wristband issuers (semantics: ref
pkg/service/oidc.go:35-124): serves
``/{namespace}/{authconfig}/{wristband-evaluator}/.well-known/openid-configuration``
and ``.../.well-known/openid-connect/certs`` straight from the index."""

from __future__ import annotations

from aiohttp import web

from ..runtime.engine import PolicyEngine

__all__ = ["build_oidc_app"]


def _find_wristband_issuer(engine: PolicyEngine, namespace: str, authconfig: str, evaluator: str):
    entry = None
    for e in engine.index.list():
        if e.id == f"{namespace}/{authconfig}":
            entry = e
            break
    if entry is None:
        return None
    for resp in entry.runtime.response:
        if resp.name == evaluator:
            issuer = getattr(resp.evaluator, "get_issuer", None)
            if issuer is not None:
                return resp.evaluator
    return None


def build_oidc_app(engine: PolicyEngine) -> web.Application:
    app = web.Application()

    async def serve(request: web.Request) -> web.Response:
        ns = request.match_info["namespace"]
        ac = request.match_info["authconfig"]
        ev = request.match_info["evaluator"]
        doc = request.match_info["doc"]
        issuer = _find_wristband_issuer(engine, ns, ac, ev)
        if issuer is None:
            return web.Response(status=404, text="Not found")
        if doc == "openid-configuration":
            return web.Response(text=issuer.openid_config(), content_type="application/json")
        if doc == "openid-connect/certs":
            return web.Response(text=issuer.jwks(), content_type="application/json")
        return web.Response(status=404, text="Not found")

    app.router.add_get(
        "/{namespace}/{authconfig}/{evaluator}/.well-known/{doc:openid-configuration|openid-connect/certs}",
        serve,
    )
    return app
