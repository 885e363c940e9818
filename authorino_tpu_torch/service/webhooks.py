"""CRD webhook server: conversion (v1beta1 ↔ v1beta2) + validation.

The reference's ``authorino webhooks`` command runs a webhook server hosting
the AuthConfig conversion webhook (ref: main.go:140-144 `webhooks` command,
api/v1beta2/auth_config_webhook.go:7-11, CRD patch
install/crd/patches/webhook_in_authconfigs.yaml:10-18).  Kubernetes POSTs a
``ConversionReview``; we convert each object to the requested apiVersion
with apis/convert (the code the reference generates from ConvertTo/
ConvertFrom — api/v1beta2/auth_config_conversion.go:15,96).

Also serves ``/validate-authconfig`` (AdmissionReview) — structural spec
validation the reference gets from CRD OpenAPI schemas.
"""

from __future__ import annotations

import json
import logging
from typing import Any, Dict

from aiohttp import web

from ..apis.convert import to_v1beta1, to_v1beta2

__all__ = ["build_webhook_app", "convert_review", "validate_review"]

log = logging.getLogger("authorino_tpu.webhooks")

_CONVERTERS = {
    "authorino.kuadrant.io/v1beta1": to_v1beta1,
    "authorino.kuadrant.io/v1beta2": to_v1beta2,
}


def convert_review(review: Dict[str, Any]) -> Dict[str, Any]:
    """Handle a ConversionReview request object → response object."""
    req = review.get("request") or {}
    uid = req.get("uid", "")
    desired = req.get("desiredAPIVersion", "")
    convert = _CONVERTERS.get(desired)
    response: Dict[str, Any] = {"uid": uid}
    if convert is None:
        response["result"] = {
            "status": "Failure",
            "message": f"unsupported desiredAPIVersion {desired!r}",
        }
    else:
        converted = []
        try:
            for obj in req.get("objects") or []:
                out = convert(obj)
                out["apiVersion"] = desired
                # conversion must preserve metadata + status verbatim
                out.setdefault("metadata", obj.get("metadata") or {})
                if "status" in obj:
                    out["status"] = obj["status"]
                converted.append(out)
            response["convertedObjects"] = converted
            response["result"] = {"status": "Success"}
        except Exception as e:
            response["result"] = {"status": "Failure", "message": str(e)}
    return {
        "apiVersion": review.get("apiVersion", "apiextensions.k8s.io/v1"),
        "kind": "ConversionReview",
        "response": response,
    }


_V1BETA2_SPEC_KEYS = {
    "hosts", "patterns", "when", "authentication", "metadata",
    "authorization", "response", "callbacks",
}


def _validate_spec(resource: Dict[str, Any]) -> str:
    """Structural validation; returns '' if OK else a message."""
    api_version = resource.get("apiVersion", "")
    if api_version not in _CONVERTERS:
        return f"unsupported apiVersion {api_version!r}"
    spec = resource.get("spec")
    if not isinstance(spec, dict):
        return "spec must be an object"
    hosts = spec.get("hosts")
    if not isinstance(hosts, list) or not all(isinstance(h, str) for h in hosts) or not hosts:
        return "spec.hosts must be a non-empty list of strings"
    if api_version.endswith("v1beta2"):
        unknown = set(spec) - _V1BETA2_SPEC_KEYS
        if unknown:
            return f"unknown spec fields: {sorted(unknown)}"
        for phase in ("authentication", "metadata", "authorization", "response", "callbacks"):
            block = spec.get(phase)
            if phase == "response" and isinstance(block, dict):
                continue  # response has success/unauthenticated/unauthorized shape
            if block is not None and not isinstance(block, dict):
                return f"spec.{phase} must be a map of named evaluators"
        try:
            to_v1beta1(resource)
        except Exception as e:
            return f"invalid spec: {e}"
    # deep check: compile every pattern expression (bad regexes/operators are
    # what the CRD OpenAPI schema cannot catch and would otherwise only fail
    # at reconcile time)
    return _validate_patterns(resource.get("spec") or {})


def _validate_patterns(node: Any, path: str = "spec") -> str:
    from ..expressions import Operator, Pattern, PatternError

    if isinstance(node, dict):
        keys = set(node)
        if keys >= {"selector", "operator"} and isinstance(node.get("operator"), str):
            try:
                p = Pattern(node.get("selector", ""), node["operator"], node.get("value", ""))
            except PatternError as e:
                return f"{path}: {e}"
            except Exception as e:
                return f"{path}: invalid pattern: {e}"
            # bad regexes are deferred to match time by Pattern (runtime
            # denies instead of crashing); admission should reject them early
            if p.operator is Operator.MATCHES and getattr(p, "_regex", None) is None:
                return f"{path}: invalid regex: {getattr(p, '_regex_error', 'compile failed')}"
            return ""
        for k, v in node.items():
            msg = _validate_patterns(v, f"{path}.{k}")
            if msg:
                return msg
    elif isinstance(node, list):
        for i, v in enumerate(node):
            msg = _validate_patterns(v, f"{path}[{i}]")
            if msg:
                return msg
    return ""


def validate_review(review: Dict[str, Any]) -> Dict[str, Any]:
    req = review.get("request") or {}
    uid = req.get("uid", "")
    obj = req.get("object") or {}
    msg = _validate_spec(obj) if req.get("operation") in (None, "CREATE", "UPDATE") else ""
    response: Dict[str, Any] = {"uid": uid, "allowed": not msg}
    if msg:
        response["status"] = {"code": 422, "message": msg}
    return {
        "apiVersion": review.get("apiVersion", "admission.k8s.io/v1"),
        "kind": "AdmissionReview",
        "response": response,
    }


def build_webhook_app() -> web.Application:
    async def convert(request: web.Request) -> web.Response:
        try:
            review = json.loads(await request.read())
        except ValueError:
            return web.Response(status=400, text="invalid JSON")
        return web.json_response(convert_review(review))

    async def validate(request: web.Request) -> web.Response:
        try:
            review = json.loads(await request.read())
        except ValueError:
            return web.Response(status=400, text="invalid JSON")
        return web.json_response(validate_review(review))

    async def healthz(_):
        return web.Response(text="ok")

    app = web.Application()
    app.router.add_post("/convert", convert)
    app.router.add_post("/validate-authconfig", validate)
    app.router.add_get("/healthz", healthz)
    return app
