"""AuthConfig API conversion: v1beta1 (storage/hub shape, named lists) ↔
v1beta2 (user-facing shape, named maps)
(semantics: ref api/v1beta2/auth_config_conversion.go:15-1080; the mapping
tables below follow the same field correspondences).

Specs are plain dicts (parsed YAML/JSON); the framework's native shape is
v1beta2 — v1beta1 resources convert on ingest like the reference's
conversion webhook."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

__all__ = ["to_v1beta2", "to_v1beta1", "API_VERSION_V1BETA1", "API_VERSION_V1BETA2"]


def _clean(d: dict) -> dict:
    """Drop None-valued keys: omitted optionals (sharedSecretRef,
    credentialsRef, audiences…) must stay omitted through a round-trip —
    injecting explicit nulls rewrites the stored resource on every webhook
    conversion."""
    return {k: v for k, v in d.items() if v is not None}

API_VERSION_V1BETA1 = "authorino.kuadrant.io/v1beta1"
API_VERSION_V1BETA2 = "authorino.kuadrant.io/v1beta2"


# ---------------------------------------------------------------------------
# value / pattern helpers
# ---------------------------------------------------------------------------

def _v1_static_or_selector(value: Any = None, value_from: Optional[dict] = None) -> dict:
    """v1beta1 {value | valueFrom.authJSON} → v1beta2 {value | selector}"""
    if value_from and value_from.get("authJSON"):
        return {"selector": value_from["authJSON"]}
    return {"value": value}


def _v2_to_v1_value(vs: Optional[dict]) -> Dict[str, Any]:
    """v1beta2 {value | selector} → v1beta1 {value | valueFrom.authJSON}"""
    if not vs:
        return {}
    if vs.get("selector"):
        return {"valueFrom": {"authJSON": vs["selector"]}}
    return {"value": vs.get("value")}


def _v1_props_to_v2(props: Optional[List[dict]]) -> Dict[str, dict]:
    out: Dict[str, dict] = {}
    for p in props or []:
        out[p.get("name", "")] = _v1_static_or_selector(p.get("value"), p.get("valueFrom"))
    return out


def _v2_props_to_v1(named: Optional[Dict[str, dict]]) -> List[dict]:
    out = []
    for name, vs in (named or {}).items():
        out.append({"name": name, **_v2_to_v1_value(vs)})
    return out


def _v1_pattern_to_v2(p: dict) -> dict:
    out: Dict[str, Any] = {}
    if p.get("patternRef"):
        out["patternRef"] = p["patternRef"]
    if p.get("all") is not None:
        out["all"] = [_v1_pattern_to_v2(x) for x in p["all"]]
    if p.get("any") is not None:
        out["any"] = [_v1_pattern_to_v2(x) for x in p["any"]]
    for k in ("selector", "operator", "value"):
        if p.get(k) is not None and k not in out:
            out[k] = p[k]
    return out


_v2_pattern_to_v1 = _v1_pattern_to_v2  # same wire shape for pattern nodes


def _v1_credentials_to_v2(c: Optional[dict]) -> dict:
    if not c:
        return {}
    loc = c.get("in", "authorization_header")
    key = c.get("keySelector", "")
    if loc == "authorization_header":
        return {"authorizationHeader": {"prefix": key}}
    if loc == "custom_header":
        return {"customHeader": {"name": key}}
    if loc == "query":
        return {"queryString": {"name": key}}
    if loc == "cookie":
        return {"cookie": {"name": key}}
    return {}


def _v2_credentials_to_v1(c: Optional[dict]) -> dict:
    if not c:
        return {}
    if c.get("authorizationHeader") is not None:
        return {"in": "authorization_header", "keySelector": c["authorizationHeader"].get("prefix", "")}
    if c.get("customHeader") is not None:
        return {"in": "custom_header", "keySelector": c["customHeader"].get("name", "")}
    if c.get("queryString") is not None:
        return {"in": "query", "keySelector": c["queryString"].get("name", "")}
    if c.get("cookie") is not None:
        return {"in": "cookie", "keySelector": c["cookie"].get("name", "")}
    return {}


def _v1_http_to_v2(h: dict) -> dict:
    out: Dict[str, Any] = {"url": h.get("endpoint", "")}
    if h.get("method"):
        out["method"] = h["method"]
    if h.get("body") is not None or h.get("bodyParameters") is not None:
        if h.get("body") is not None:
            b = h["body"]
            out["body"] = _v1_static_or_selector(b.get("value"), b.get("valueFrom"))
        if h.get("bodyParameters"):
            out["bodyParameters"] = _v1_props_to_v2(h["bodyParameters"])
    if h.get("contentType"):
        out["contentType"] = h["contentType"]
    if h.get("headers"):
        out["headers"] = _v1_props_to_v2(h["headers"])
    if h.get("sharedSecretRef"):
        out["sharedSecretRef"] = h["sharedSecretRef"]
    if h.get("oauth2"):
        out["oauth2"] = h["oauth2"]
    if h.get("credentials"):
        out["credentials"] = _v1_credentials_to_v2(h["credentials"])
    return out


def _v2_http_to_v1(h: dict) -> dict:
    out: Dict[str, Any] = {"endpoint": h.get("url", "")}
    if h.get("method"):
        out["method"] = h["method"]
    if h.get("body") is not None:
        out["body"] = _v2_to_v1_value(h["body"])
    if h.get("bodyParameters"):
        out["bodyParameters"] = _v2_props_to_v1(h["bodyParameters"])
    if h.get("contentType"):
        out["contentType"] = h["contentType"]
    if h.get("headers"):
        out["headers"] = _v2_props_to_v1(h["headers"])
    for k in ("sharedSecretRef", "oauth2"):
        if h.get(k):
            out[k] = h[k]
    if h.get("credentials"):
        out["credentials"] = _v2_credentials_to_v1(h["credentials"])
    return out


# ---------------------------------------------------------------------------
# v1beta1 → v1beta2
# ---------------------------------------------------------------------------

def to_v1beta2(resource: dict) -> dict:
    """Convert a v1beta1 AuthConfig resource dict to v1beta2 shape
    (ref: ConvertFrom, api/v1beta2/auth_config_conversion.go:96)."""
    if resource.get("apiVersion") == API_VERSION_V1BETA2:
        return resource
    spec1 = resource.get("spec") or {}
    spec2: Dict[str, Any] = {"hosts": spec1.get("hosts") or []}
    if spec1.get("patterns"):
        spec2["patterns"] = {
            name: [_v1_pattern_to_v2(p) for p in patterns]
            for name, patterns in spec1["patterns"].items()
        }
    if spec1.get("when"):
        spec2["when"] = [_v1_pattern_to_v2(p) for p in spec1["when"]]

    authentication: Dict[str, dict] = {}
    for ident in spec1.get("identity") or []:
        a: Dict[str, Any] = {}
        _copy_common_v1_to_v2(ident, a)
        if ident.get("credentials"):
            a["credentials"] = _v1_credentials_to_v2(ident["credentials"])
        ext_defaults, ext_overrides = {}, {}
        for prop in ident.get("extendedProperties") or []:
            target = ext_overrides if prop.get("overwrite") else ext_defaults
            target[prop.get("name", "")] = _v1_static_or_selector(prop.get("value"), prop.get("valueFrom"))
        if ext_defaults:
            a["defaults"] = ext_defaults
        if ext_overrides:
            a["overrides"] = ext_overrides
        if ident.get("apiKey") is not None:
            a["apiKey"] = {
                "selector": ident["apiKey"].get("selector"),
                "allNamespaces": ident["apiKey"].get("allNamespaces", False),
            }
        elif ident.get("oidc") is not None:
            a["jwt"] = {
                "issuerUrl": ident["oidc"].get("endpoint", ""),
                "ttl": ident["oidc"].get("ttl", 0),
            }
        elif ident.get("oauth2") is not None:
            a["oauth2Introspection"] = _clean({
                "endpoint": ident["oauth2"].get("tokenIntrospectionUrl", ""),
                "tokenTypeHint": ident["oauth2"].get("tokenTypeHint", ""),
                "credentialsRef": ident["oauth2"].get("credentialsRef"),
            })
        elif ident.get("mtls") is not None:
            a["x509"] = {
                "selector": ident["mtls"].get("selector"),
                "allNamespaces": ident["mtls"].get("allNamespaces", False),
            }
        elif ident.get("kubernetes") is not None:
            a["kubernetesTokenReview"] = _clean({"audiences": ident["kubernetes"].get("audiences")})
        elif ident.get("plain") is not None:
            a["plain"] = {"selector": ident["plain"].get("authJSON", "")}
        elif ident.get("anonymous") is not None:
            a["anonymous"] = {}
        authentication[ident.get("name", "")] = a
    if authentication:
        spec2["authentication"] = authentication

    metadata: Dict[str, dict] = {}
    for md in spec1.get("metadata") or []:
        m: Dict[str, Any] = {}
        _copy_common_v1_to_v2(md, m)
        if md.get("http") is not None:
            m["http"] = _v1_http_to_v2(md["http"])
        elif md.get("userInfo") is not None:
            m["userInfo"] = {"identitySource": md["userInfo"].get("identitySource", "")}
        elif md.get("uma") is not None:
            m["uma"] = md["uma"]
        metadata[md.get("name", "")] = m
    if metadata:
        spec2["metadata"] = metadata

    authorization: Dict[str, dict] = {}
    for az in spec1.get("authorization") or []:
        z: Dict[str, Any] = {}
        _copy_common_v1_to_v2(az, z)
        if az.get("json") is not None:
            z["patternMatching"] = {
                "patterns": [_v1_pattern_to_v2(p) for p in az["json"].get("rules") or []]
            }
        elif az.get("opa") is not None:
            o = az["opa"]
            z["opa"] = {
                "rego": o.get("inlineRego", ""),
                "allValues": o.get("allValues", False),
            }
            if o.get("externalRegistry"):
                er = o["externalRegistry"]
                z["opa"]["externalPolicy"] = _clean({
                    "url": er.get("endpoint", ""),
                    "sharedSecretRef": er.get("sharedSecretRef"),
                    "ttl": er.get("ttl", 0),
                })
                if er.get("credentials"):
                    z["opa"]["externalPolicy"]["credentials"] = _v1_credentials_to_v2(er["credentials"])
        elif az.get("kubernetes") is not None:
            k = az["kubernetes"]
            z["kubernetesSubjectAccessReview"] = _clean({
                "user": _v1_static_or_selector((k.get("user") or {}).get("value"), (k.get("user") or {}).get("valueFrom")),
                "groups": k.get("groups"),
            })
            if k.get("resourceAttributes"):
                z["kubernetesSubjectAccessReview"]["resourceAttributes"] = {
                    key: _v1_static_or_selector(v.get("value"), v.get("valueFrom"))
                    for key, v in k["resourceAttributes"].items()
                }
        elif az.get("authzed") is not None:
            s = az["authzed"]
            z["spicedb"] = _clean({
                "endpoint": s.get("endpoint", ""),
                "insecure": s.get("insecure", False),
                "sharedSecretRef": s.get("sharedSecretRef"),
                "subject": _v1_authzed_obj(s.get("subject")),
                "resource": _v1_authzed_obj(s.get("resource")),
                "permission": _v1_static_or_selector(
                    (s.get("permission") or {}).get("value"),
                    (s.get("permission") or {}).get("valueFrom"),
                ),
            })
        authorization[az.get("name", "")] = z
    if authorization:
        spec2["authorization"] = authorization

    response: Dict[str, Any] = {}
    deny_with = spec1.get("denyWith") or {}
    for key in ("unauthenticated", "unauthorized"):
        d = deny_with.get(key)
        if d:
            response[key] = {
                "code": d.get("code", 0),
                "message": _v1_static_or_selector((d.get("message") or {}).get("value"), (d.get("message") or {}).get("valueFrom")) if d.get("message") else None,
                "headers": _v1_props_to_v2(d.get("headers")),
                "body": _v1_static_or_selector((d.get("body") or {}).get("value"), (d.get("body") or {}).get("valueFrom")) if d.get("body") else None,
            }
            response[key] = {k: v for k, v in response[key].items() if v}
    headers_out: Dict[str, dict] = {}
    dyn_out: Dict[str, dict] = {}
    for resp in spec1.get("response") or []:
        r: Dict[str, Any] = {}
        _copy_common_v1_to_v2(resp, r)
        if resp.get("wristband") is not None:
            r["wristband"] = resp["wristband"]
        elif resp.get("json") is not None:
            r["json"] = {"properties": _v1_props_to_v2(resp["json"].get("properties"))}
        elif resp.get("plain") is not None:
            p = resp["plain"]
            r["plain"] = _v1_static_or_selector(p.get("value"), p.get("valueFrom"))
        if resp.get("wrapperKey"):
            r["key"] = resp["wrapperKey"]
        if resp.get("wrapper") == "envoyDynamicMetadata":
            dyn_out[resp.get("name", "")] = r
        else:
            headers_out[resp.get("name", "")] = r
    if headers_out or dyn_out:
        response["success"] = {}
        if headers_out:
            response["success"]["headers"] = headers_out
        if dyn_out:
            response["success"]["dynamicMetadata"] = dyn_out
    if response:
        spec2["response"] = response

    callbacks: Dict[str, dict] = {}
    for cb in spec1.get("callbacks") or []:
        c: Dict[str, Any] = {}
        _copy_common_v1_to_v2(cb, c)
        if cb.get("http") is not None:
            c["http"] = _v1_http_to_v2(cb["http"])
        callbacks[cb.get("name", "")] = c
    if callbacks:
        spec2["callbacks"] = callbacks

    return {
        "apiVersion": API_VERSION_V1BETA2,
        "kind": "AuthConfig",
        "metadata": resource.get("metadata") or {},
        "spec": spec2,
    }


def _v1_authzed_obj(obj: Optional[dict]) -> Optional[dict]:
    if not obj:
        return None
    out = {}
    for k in ("name", "kind"):
        v = obj.get(k)
        if isinstance(v, dict):
            out[k] = _v1_static_or_selector(v.get("value"), v.get("valueFrom"))
        elif v is not None:
            out[k] = {"value": v}
    return out


def _copy_common_v1_to_v2(src: dict, dst: dict) -> None:
    if src.get("priority"):
        dst["priority"] = src["priority"]
    if src.get("metrics"):
        dst["metrics"] = src["metrics"]
    if src.get("when"):
        dst["when"] = [_v1_pattern_to_v2(p) for p in src["when"]]
    if src.get("cache"):
        c = src["cache"]
        key = c.get("key") or {}
        dst["cache"] = {
            "key": _v1_static_or_selector(key.get("value"), key.get("valueFrom")),
            "ttl": c.get("ttl", 60),
        }


# ---------------------------------------------------------------------------
# v1beta2 → v1beta1 (round-trip support; ref ConvertTo :15)
# ---------------------------------------------------------------------------

def to_v1beta1(resource: dict) -> dict:
    if resource.get("apiVersion") == API_VERSION_V1BETA1:
        return resource
    spec2 = resource.get("spec") or {}
    spec1: Dict[str, Any] = {"hosts": spec2.get("hosts") or []}
    if spec2.get("patterns"):
        spec1["patterns"] = spec2["patterns"]
    if spec2.get("when"):
        spec1["when"] = spec2["when"]

    identity = []
    for name, a in (spec2.get("authentication") or {}).items():
        i: Dict[str, Any] = {"name": name}
        _copy_common_v2_to_v1(a, i)
        if a.get("credentials"):
            i["credentials"] = _v2_credentials_to_v1(a["credentials"])
        ext = []
        for prop, vs in (a.get("defaults") or {}).items():
            ext.append({"name": prop, "overwrite": False, **_v2_to_v1_value(vs)})
        for prop, vs in (a.get("overrides") or {}).items():
            ext.append({"name": prop, "overwrite": True, **_v2_to_v1_value(vs)})
        if ext:
            i["extendedProperties"] = ext
        if a.get("apiKey") is not None:
            i["apiKey"] = a["apiKey"]
        elif a.get("jwt") is not None:
            i["oidc"] = {"endpoint": a["jwt"].get("issuerUrl", ""), "ttl": a["jwt"].get("ttl", 0)}
        elif a.get("oauth2Introspection") is not None:
            o = a["oauth2Introspection"]
            i["oauth2"] = _clean({
                "tokenIntrospectionUrl": o.get("endpoint", ""),
                "tokenTypeHint": o.get("tokenTypeHint", ""),
                "credentialsRef": o.get("credentialsRef"),
            })
        elif a.get("x509") is not None:
            i["mtls"] = a["x509"]
        elif a.get("kubernetesTokenReview") is not None:
            i["kubernetes"] = _clean({"audiences": a["kubernetesTokenReview"].get("audiences")})
        elif a.get("plain") is not None:
            i["plain"] = {"authJSON": a["plain"].get("selector", "")}
        elif a.get("anonymous") is not None:
            i["anonymous"] = {}
        identity.append(i)
    if identity:
        spec1["identity"] = identity

    metadata = []
    for name, m in (spec2.get("metadata") or {}).items():
        d: Dict[str, Any] = {"name": name}
        _copy_common_v2_to_v1(m, d)
        if m.get("http") is not None:
            d["http"] = _v2_http_to_v1(m["http"])
        elif m.get("userInfo") is not None:
            d["userInfo"] = m["userInfo"]
        elif m.get("uma") is not None:
            d["uma"] = m["uma"]
        metadata.append(d)
    if metadata:
        spec1["metadata"] = metadata

    authorization = []
    for name, z in (spec2.get("authorization") or {}).items():
        d = {"name": name}
        _copy_common_v2_to_v1(z, d)
        if z.get("patternMatching") is not None:
            d["json"] = {"rules": z["patternMatching"].get("patterns") or []}
        elif z.get("opa") is not None:
            o = z["opa"]
            d["opa"] = {"inlineRego": o.get("rego", ""), "allValues": o.get("allValues", False)}
            if o.get("externalPolicy"):
                ep = o["externalPolicy"]
                d["opa"]["externalRegistry"] = _clean({
                    "endpoint": ep.get("url", ""),
                    "sharedSecretRef": ep.get("sharedSecretRef"),
                    "ttl": ep.get("ttl", 0),
                })
                if ep.get("credentials"):
                    d["opa"]["externalRegistry"]["credentials"] = _v2_credentials_to_v1(ep["credentials"])
        elif z.get("kubernetesSubjectAccessReview") is not None:
            k = z["kubernetesSubjectAccessReview"]
            d["kubernetes"] = _clean({
                "user": _v2_to_v1_value(k.get("user")),
                "groups": k.get("groups"),
            })
            if k.get("resourceAttributes"):
                d["kubernetes"]["resourceAttributes"] = {
                    key: _v2_to_v1_value(v) for key, v in k["resourceAttributes"].items()
                }
        elif z.get("spicedb") is not None:
            s = z["spicedb"]
            d["authzed"] = _clean({
                "endpoint": s.get("endpoint", ""),
                "insecure": s.get("insecure", False),
                "sharedSecretRef": s.get("sharedSecretRef"),
                "subject": {k: _v2_to_v1_value(v) for k, v in (s.get("subject") or {}).items()},
                "resource": {k: _v2_to_v1_value(v) for k, v in (s.get("resource") or {}).items()},
                "permission": _v2_to_v1_value(s.get("permission")),
            })
        authorization.append(d)
    if authorization:
        spec1["authorization"] = authorization

    response2 = spec2.get("response") or {}
    deny_with = {}
    for key in ("unauthenticated", "unauthorized"):
        d = response2.get(key)
        if d:
            deny_with[key] = {
                "code": d.get("code", 0),
                "message": _v2_to_v1_value(d.get("message")) if d.get("message") else None,
                "headers": _v2_props_to_v1(d.get("headers")),
                "body": _v2_to_v1_value(d.get("body")) if d.get("body") else None,
            }
            deny_with[key] = {k: v for k, v in deny_with[key].items() if v}
    if deny_with:
        spec1["denyWith"] = deny_with

    responses = []
    success = response2.get("success") or {}
    for wrapper, group in (("httpHeader", success.get("headers")), ("envoyDynamicMetadata", success.get("dynamicMetadata"))):
        for name, r in (group or {}).items():
            d = {"name": name, "wrapper": wrapper}
            _copy_common_v2_to_v1(r, d)
            if r.get("key"):
                d["wrapperKey"] = r["key"]
            if r.get("wristband") is not None:
                d["wristband"] = r["wristband"]
            elif r.get("json") is not None:
                d["json"] = {"properties": _v2_props_to_v1(r["json"].get("properties"))}
            elif r.get("plain") is not None:
                d["plain"] = _v2_to_v1_value(r["plain"])
            responses.append(d)
    if responses:
        spec1["response"] = responses

    callbacks = []
    for name, c in (spec2.get("callbacks") or {}).items():
        d = {"name": name}
        _copy_common_v2_to_v1(c, d)
        if c.get("http") is not None:
            d["http"] = _v2_http_to_v1(c["http"])
        callbacks.append(d)
    if callbacks:
        spec1["callbacks"] = callbacks

    return {
        "apiVersion": API_VERSION_V1BETA1,
        "kind": "AuthConfig",
        "metadata": resource.get("metadata") or {},
        "spec": spec1,
    }


def _copy_common_v2_to_v1(src: dict, dst: dict) -> None:
    if src.get("priority"):
        dst["priority"] = src["priority"]
    if src.get("metrics"):
        dst["metrics"] = src["metrics"]
    if src.get("when"):
        dst["when"] = src["when"]
    if src.get("cache"):
        dst["cache"] = {
            "key": _v2_to_v1_value(src["cache"].get("key")),
            "ttl": src["cache"].get("ttl", 60),
        }
