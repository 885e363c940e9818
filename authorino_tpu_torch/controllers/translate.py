"""AuthConfig translation: v1beta2-shaped spec (dict) → runtime evaluator
graph + compilable rule corpus (semantics: ref
controllers/auth_config_controller.go:159-603 translateAuthConfig +
buildJSONExpression :805 + buildGenericHttpEvaluator :721).

Every pattern-matching authorization evaluator (and its `when` conditions)
is lowered into the config's ConfigRules, so the engine compiles it into
the corpus the mega-kernel evaluates, and the evaluator is bound to that
engine: ``engine`` is required, and the engine refuses a snapshot whose
pattern evaluators are bound to another.  Secret reads happen here (API
keys, OAuth2 credentials, shared secrets, wristband signing keys), exactly
like the reference reads Secrets at reconcile time, and so does each
``jwt`` identity's OIDC discovery.

An inline OPA policy whose ``allow`` is decidable (``rego_lower``) is
lowered into one more slot of the same ConfigRules, so the mega-kernel
decides it in the launch that decides the config's patterns; the pipeline
keeps the interpreter for the evaluator's verdict, as the reference does.

The port translates every kind the reference does (``NOT_IN_PORT`` is
empty).  An ``opa.externalPolicy`` is downloaded here
(and refreshed on its TTL by the evaluator) and never lowered: a refresh
swaps the policy without a reconcile.  The AuthConfig's annotations ride
the entry into the engine's tenant weight book (``tenancy/weights.py``)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ..authjson.value import JSONProperty, JSONValue
from ..compiler.compile import ConfigRules
from ..evaluators import cache as cache_mod
from ..evaluators.authorization import (OPA, Authzed, KubernetesAuthz,
                                        OPAExternalSource, PatternMatching)
from ..evaluators.base import (
    AuthorizationConfig,
    CallbackConfig,
    DenyWith,
    DenyWithValues,
    IdentityConfig,
    IdentityExtension,
    MetadataConfig,
    ResponseConfig,
    RuntimeAuthConfig,
)
from ..evaluators.credentials import AuthCredentials
from ..evaluators.identity import MTLS, APIKey, KubernetesAuth, Noop, OAuth2, OIDC, Plain
from ..evaluators.metadata import UMA, GenericHttp, UserInfo
from ..evaluators.response import DynamicJSON, SigningKey, Wristband
from ..evaluators.response import Plain as PlainResponse
from ..expressions.ast import All, Any_, Expression, InGroup, Operator, Pattern
from ..k8s.client import ClusterReader, LabelSelector
from ..relations.closure import RelationClosure
from ..relations.prefetch import mark_prefetchable
from ..runtime.engine import EngineEntry, PolicyEngine
from ..utils.oauth2cc import ClientCredentials

__all__ = ["TranslationError", "translate_auth_config", "build_expression",
           "build_relations", "NOT_IN_PORT"]

# the kinds the reference translates and the port does not hold yet, per
# spec section: none
NOT_IN_PORT: Dict[str, Tuple[str, ...]] = {}


class TranslationError(Exception):
    """Invalid AuthConfig spec — the analog of the reference's reconcile
    failure → CachingError status."""


# ---------------------------------------------------------------------------
# pattern expressions (ref :805 buildJSONExpression)
# ---------------------------------------------------------------------------

def _one_pattern(item: Dict[str, Any], named: Dict[str, List[dict]],
                 relations: Optional[Dict[str, RelationClosure]] = None,
                 ) -> Expression:
    if "patternRef" in item and item["patternRef"]:
        ref = item["patternRef"]
        patterns = named.get(ref)
        if patterns is None:
            raise TranslationError(f"referenced pattern not found: {ref!r}")
        return All(*[_one_pattern(p, named, relations) for p in patterns])
    if item.get("all") is not None:
        return All(*[_one_pattern(p, named, relations) for p in item["all"]])
    if item.get("any") is not None:
        return Any_(*[_one_pattern(p, named, relations) for p in item["any"]])
    selector = item.get("selector", "")
    operator = item.get("operator", "")
    value = item.get("value", "")
    if not operator:
        raise TranslationError(f"invalid pattern expression: {item!r}")
    if operator == "ingroup":
        # hierarchical membership: `value` names the group,
        # `relation` the spec.relations edge set whose ancestor closure
        # decides it — compiled to an in-kernel bitmask gather
        rel_name = item.get("relation", "")
        closure = (relations or {}).get(rel_name)
        if closure is None:
            raise TranslationError(
                f"pattern references unknown relation {rel_name!r} "
                "(declare it under spec.relations)")
        return InGroup(selector, str(value), closure)
    return Pattern(selector, Operator.from_string(operator), str(value))


def build_expression(
    items: Optional[List[dict]], named: Optional[Dict[str, List[dict]]] = None,
    relations: Optional[Dict[str, RelationClosure]] = None,
) -> Optional[Expression]:
    """A `when`/patterns list is a logical AND of its items."""
    if not items:
        return None
    named = named or {}
    return All(*[_one_pattern(i, named, relations) for i in items])


def build_relations(spec: Optional[Dict[str, Any]],
                    ) -> Dict[str, RelationClosure]:
    """spec.relations → named ancestor closures.  Accepted
    forms: {name: {"edges": [[child, parent], ...]}} or the bare edge
    list.  Closure computation happens HERE, at reconcile time — request
    evaluation only ever reads the precomputed table."""
    out: Dict[str, RelationClosure] = {}
    for rname, rspec in (spec or {}).items():
        edges = rspec.get("edges") if isinstance(rspec, dict) else rspec
        if not isinstance(edges, list) or any(
                not isinstance(e, (list, tuple)) or len(e) != 2
                for e in edges):
            raise TranslationError(
                f"relation {rname!r} must declare edges as "
                "[[child, parent], ...]")
        out[rname] = RelationClosure(edges)
    return out


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

_FOLD_SAFE_ROOTS = ("request.", "context.", "source.", "destination.")


def _gate_selectors_request_rooted(expr: Expression) -> bool:
    """True iff every selector in the gate reads data that is identical at
    pipeline start (where the reference evaluates top-level `when`,
    auth.identity still None) and after identity resolution (where a folded
    gate runs).  Only request-shaped roots qualify; anything auth.*-rooted —
    or unrecognized — keeps the gate on the pipeline."""
    stack = [expr]
    while stack:
        node = stack.pop()
        children = getattr(node, "children", None)
        if children is not None:
            stack.extend(children)
        else:
            if not str(node.selector).startswith(_FOLD_SAFE_ROOTS):
                return False
    return True


def _value_or_selector(spec: Optional[dict]) -> Optional[JSONValue]:
    if spec is None:
        return None
    if "selector" in spec and spec["selector"]:
        return JSONValue(pattern=spec["selector"])
    return JSONValue(static=spec.get("value"))


def _named_values(spec: Optional[Dict[str, dict]]) -> List[JSONProperty]:
    if not spec:
        return []
    return [JSONProperty(name, _value_or_selector(v) or JSONValue()) for name, v in spec.items()]


def _credentials(spec: Optional[dict]) -> AuthCredentials:
    """(ref v1beta2 Credentials → in/keySelector)"""
    if not spec:
        return AuthCredentials()
    if spec.get("authorizationHeader") is not None:
        return AuthCredentials(
            key_selector=spec["authorizationHeader"].get("prefix", "Bearer") or "Bearer",
            location="authorization_header",
        )
    if spec.get("customHeader") is not None:
        return AuthCredentials(
            key_selector=spec["customHeader"].get("name", ""), location="custom_header"
        )
    if spec.get("queryString") is not None:
        return AuthCredentials(key_selector=spec["queryString"].get("name", ""), location="query")
    if spec.get("cookie") is not None:
        return AuthCredentials(key_selector=spec["cookie"].get("name", ""), location="cookie")
    return AuthCredentials()


async def _secret_value(cluster: Optional[ClusterReader], namespace: str, ref: Optional[dict], default_key: str = "") -> str:
    """SecretKeyReference / LocalObjectReference resolution."""
    if not ref:
        return ""
    if cluster is None:
        raise TranslationError("spec references a Secret but no cluster access is configured")
    name = ref.get("name", "")
    key = ref.get("key", default_key)
    secret = await cluster.get_secret(namespace, name)
    if secret is None:
        raise TranslationError(f"secret not found: {namespace}/{name}")
    if key:
        if key not in secret.data:
            raise TranslationError(f"key {key!r} not found in secret {namespace}/{name}")
        return secret.data[key].decode()
    return ""


async def _client_credentials(cluster: Optional[ClusterReader], namespace: str,
                              ref: Optional[dict]) -> Tuple[str, str]:
    """(clientID, clientSecret) of a ``credentialsRef`` Secret; empty
    without a name or without cluster access."""
    secret_name = (ref or {}).get("name", "")
    if not secret_name or cluster is None:
        return "", ""
    secret = await cluster.get_secret(namespace, secret_name)
    if secret is None:
        raise TranslationError(f"secret not found: {namespace}/{secret_name}")
    return (secret.data.get("clientID", b"").decode(),
            secret.data.get("clientSecret", b"").decode())


def _cache(spec: Optional[dict]) -> Optional[cache_mod.EvaluatorCache]:
    if not spec:
        return None
    key = _value_or_selector(spec.get("key")) or JSONValue()
    return cache_mod.EvaluatorCache(key, int(spec.get("ttl", 60) or 60))


def _common(spec: dict, named: Dict[str, List[dict]],
            relations: Optional[Dict[str, RelationClosure]] = None) -> dict:
    return {
        "priority": int(spec.get("priority", 0) or 0),
        "conditions": build_expression(spec.get("when"), named, relations),
        "cache": _cache(spec.get("cache")),
        "metrics": bool(spec.get("metrics", False)),
    }


# ---------------------------------------------------------------------------
# main translation
# ---------------------------------------------------------------------------

async def _build_generic_http(
    spec: dict, namespace: str, cluster: Optional[ClusterReader]
) -> GenericHttp:
    """(ref :721 buildGenericHttpEvaluator)"""
    oauth2 = None
    o = spec.get("oauth2")
    if o:
        client_secret = await _secret_value(
            cluster, namespace, o.get("clientSecretRef"), default_key="clientSecret"
        )
        oauth2 = ClientCredentials(
            o.get("tokenUrl", ""), o.get("clientId", ""), client_secret, o.get("scopes")
        )
    shared_secret = ""
    if spec.get("sharedSecretRef"):
        shared_secret = await _secret_value(cluster, namespace, spec["sharedSecretRef"])
    url = spec.get("url", "") or spec.get("endpoint", "")
    return GenericHttp(
        endpoint=JSONValue(pattern=url) if "{" in url else JSONValue(static=url),
        method=spec.get("method", "GET") or "GET",
        body=_value_or_selector(spec.get("body")),
        parameters=_named_values(spec.get("bodyParameters")),
        headers=_named_values(spec.get("headers")),
        content_type=spec.get("contentType", "") or "application/json",
        shared_secret=shared_secret,
        credentials=_credentials(spec.get("credentials")),
        oauth2=oauth2,
    )


async def translate_auth_config(
    name: str,
    namespace: str,
    spec: Dict[str, Any],
    labels: Optional[Dict[str, str]] = None,
    cluster: Optional[ClusterReader] = None,
    *,
    engine: PolicyEngine,
    annotations: Optional[Dict[str, str]] = None,
) -> EngineEntry:
    """Returns the EngineEntry (runtime graph + compilable rules) whose
    pattern evaluators ``engine`` evaluates."""
    cfg_id = f"{namespace}/{name}"
    named: Dict[str, List[dict]] = spec.get("patterns") or {}
    relations = build_relations(spec.get("relations"))
    runtime = RuntimeAuthConfig(
        labels={"namespace": namespace, "name": name, **(labels or {})},
        conditions=build_expression(spec.get("when"), named, relations),
    )

    oidc_by_name: Dict[str, OIDC] = {}

    # ---- authentication (ref :228-320) ----
    for auth_name, aspec in (spec.get("authentication") or {}).items():
        creds = _credentials(aspec.get("credentials"))
        if aspec.get("apiKey") is not None:
            sel = LabelSelector.from_spec(aspec["apiKey"].get("selector"))
            ev = APIKey(
                auth_name,
                sel,
                namespace="" if aspec["apiKey"].get("allNamespaces") else namespace,
                credentials=creds,
                cluster=cluster,
            )
            await ev.load_secrets()
            etype = "API_KEY"
        elif aspec.get("jwt") is not None:
            ev = OIDC(
                auth_name,
                aspec["jwt"].get("issuerUrl", ""),
                ttl_s=int(aspec["jwt"].get("ttl", 0) or 0),
                credentials=creds,
            )
            try:
                await ev.refresh()
            except Exception as e:
                raise TranslationError(f"failed OIDC discovery for {auth_name!r}: {e}")
            oidc_by_name[auth_name] = ev
            etype = "JWT"
        elif aspec.get("oauth2Introspection") is not None:
            o = aspec["oauth2Introspection"]
            client_id, client_secret = await _client_credentials(
                cluster, namespace, o.get("credentialsRef"))
            ev = OAuth2(
                auth_name,
                o.get("endpoint", ""),
                client_id,
                client_secret,
                token_type_hint=o.get("tokenTypeHint", ""),
                credentials=creds,
            )
            etype = "OAUTH2_INTROSPECTION"
        elif aspec.get("x509") is not None:
            sel = LabelSelector.from_spec(aspec["x509"].get("selector"))
            ev = MTLS(
                auth_name,
                sel,
                namespace="" if aspec["x509"].get("allNamespaces") else namespace,
                credentials=creds,
                cluster=cluster,
            )
            await ev.load_secrets()
            etype = "X509"
        elif aspec.get("kubernetesTokenReview") is not None:
            ev = KubernetesAuth(
                auth_name,
                audiences=aspec["kubernetesTokenReview"].get("audiences"),
                credentials=creds,
                cluster=cluster,
            )
            etype = "KUBERNETES_TOKEN_REVIEW"
        elif aspec.get("plain") is not None:
            ev = Plain(aspec["plain"].get("selector", ""))
            etype = "PLAIN"
        elif aspec.get("anonymous") is not None:
            ev = Noop(creds)
            etype = "ANONYMOUS"
        else:
            raise TranslationError(f"unknown authentication method for {auth_name!r}")

        extensions: List[IdentityExtension] = []
        for prop_name, v in (aspec.get("defaults") or {}).items():
            extensions.append(IdentityExtension(prop_name, _value_or_selector(v) or JSONValue(), overwrite=False))
        for prop_name, v in (aspec.get("overrides") or {}).items():
            extensions.append(IdentityExtension(prop_name, _value_or_selector(v) or JSONValue(), overwrite=True))

        runtime.identity.append(
            IdentityConfig(
                auth_name,
                ev,
                type=etype,
                credentials=creds,
                extended_properties=extensions,
                **_common(aspec, named, relations),
            )
        )

    # ---- metadata (ref :322-365) ----
    for md_name, mspec in (spec.get("metadata") or {}).items():
        if mspec.get("http") is not None:
            ev = await _build_generic_http(mspec["http"], namespace, cluster)
            etype = "METADATA_GENERIC_HTTP"
        elif mspec.get("userInfo") is not None:
            source = mspec["userInfo"].get("identitySource", "")
            oidc = oidc_by_name.get(source)
            if oidc is None:
                raise TranslationError(
                    f"missing OIDC identity source {source!r} for userInfo metadata {md_name!r}"
                )
            ev = UserInfo(oidc)
            etype = "METADATA_USERINFO"
        elif mspec.get("uma") is not None:
            u = mspec["uma"]
            client_id, client_secret = await _client_credentials(
                cluster, namespace, u.get("credentialsRef"))
            ev = UMA(u.get("endpoint", ""), client_id, client_secret)
            etype = "METADATA_UMA"
        else:
            raise TranslationError(f"unknown metadata method for {md_name!r}")
        runtime.metadata.append(MetadataConfig(md_name, ev, type=etype, **_common(mspec, named, relations)))

    # ---- authorization (ref :367-455) ----
    pattern_slots: List[Tuple[Optional[Expression], Expression]] = []
    for az_name, azspec in (spec.get("authorization") or {}).items():
        common = _common(azspec, named, relations)
        if azspec.get("patternMatching") is not None:
            rules = build_expression(azspec["patternMatching"].get("patterns"), named, relations)
            if rules is None:
                rules = All()
            slot = len(pattern_slots)
            pattern_slots.append((common["conditions"], rules))
            ev = PatternMatching(
                rules,
                batched_provider=engine.provider_for(cfg_id),
                evaluator_slot=slot,
                # deny attribution: which rule fired rides the denial into
                # dynamic_metadata / X-Ext-Auth-Reason
                attributor=engine.attribution_for(cfg_id),
            )
            # conditions are compiled into the kernel; avoid double gating
            common = {**common, "conditions": None}
            etype = "PATTERN_MATCHING"
        elif azspec.get("opa") is not None:
            o = azspec["opa"]
            external = None
            if o.get("externalPolicy"):
                ext = o["externalPolicy"]
                shared = ""
                if ext.get("sharedSecretRef"):
                    shared = await _secret_value(cluster, namespace, ext["sharedSecretRef"])
                external = OPAExternalSource(
                    ext.get("url", "") or ext.get("endpoint", ""),
                    shared_secret=shared,
                    ttl_s=int(ext.get("ttl", 0) or 0),
                )
            try:
                ev = OPA(
                    f"{cfg_id}/{az_name}",
                    inline_rego=o.get("rego", ""),
                    external_source=external,
                    all_values=bool(o.get("allValues", False)),
                    # extension: a static document tree served under data.*
                    # (the embedded-OPA equivalent of loaded data documents)
                    data=o.get("data"),
                )
            except ValueError as e:
                raise TranslationError(str(e))
            if external is not None:
                try:
                    await ev.load_external()
                except Exception as e:
                    raise TranslationError(f"failed to fetch external rego policy: {e}")
            # decidable Rego rides the kernel: the verdict lowers into the
            # same compiled slots the pattern evaluators use (the analog of
            # the reference's precompile-at-reconcile, ref
            # pkg/evaluators/authorization/opa.go:141-176).  The pipeline
            # keeps the interpreter (and the `when` gate); the kernel slot
            # carries the same gate, so both agree; non-lowerable policies
            # change nothing.
            lowered = ev.lowered_verdict()
            if lowered is not None:
                ev.kernel_slot = len(pattern_slots)
                pattern_slots.append((common["conditions"], lowered))
            etype = "OPA"
        elif azspec.get("kubernetesSubjectAccessReview") is not None:
            k = azspec["kubernetesSubjectAccessReview"]
            ra = k.get("resourceAttributes") or {}
            ev = KubernetesAuthz(
                az_name,
                user=_value_or_selector(k.get("user")) or JSONValue(),
                groups=k.get("groups"),
                resource_attributes={
                    key: _value_or_selector(ra.get(key)) or JSONValue()
                    for key in ("namespace", "group", "resource", "name", "subresource", "verb")
                    if ra.get(key) is not None
                }
                if ra
                else None,
                cluster=cluster,
            )
            etype = "KUBERNETES_SUBJECT_ACCESS_REVIEW"
        elif azspec.get("spicedb") is not None:
            s = azspec["spicedb"]
            shared = ""
            if s.get("sharedSecretRef"):
                shared = await _secret_value(cluster, namespace, s["sharedSecretRef"])
            subj = s.get("subject") or {}
            res = s.get("resource") or {}
            ev = Authzed(
                az_name,
                endpoint=s.get("endpoint", ""),
                insecure=bool(s.get("insecure", False)),
                shared_secret=shared,
                subject_kind=_value_or_selector(subj.get("kind")),
                subject_name=_value_or_selector(subj.get("name")),
                resource_kind=_value_or_selector(res.get("kind")),
                resource_name=_value_or_selector(res.get("name")),
                permission=_value_or_selector(s.get("permission")),
            )
            etype = "SPICEDB"
        else:
            raise TranslationError(f"unknown authorization method for {az_name!r}")
        runtime.authorization.append(AuthorizationConfig(az_name, ev, type=etype, **common))

    # ---- response (ref :457-560) ----
    response = spec.get("response") or {}
    deny_with = DenyWith()
    for phase, key in (("unauthenticated", "unauthenticated"), ("unauthorized", "unauthorized")):
        d = response.get(key)
        if d:
            setattr(
                deny_with,
                phase,
                DenyWithValues(
                    code=int(d.get("code", 0) or 0),
                    message=_value_or_selector(d.get("message")),
                    headers=_named_values(d.get("headers")),
                    body=_value_or_selector(d.get("body")),
                ),
            )
    runtime.deny_with = deny_with

    async def build_success(resp_name: str, rspec: dict, wrapper: str) -> ResponseConfig:
        common = _common(rspec, named, relations)
        if rspec.get("wristband") is not None:
            w = rspec["wristband"]
            signing_keys: List[SigningKey] = []
            for ref in w.get("signingKeyRefs") or []:
                pem = await _secret_value(
                    cluster, namespace, {"name": ref.get("name", ""), "key": "key.pem"}
                )
                try:
                    signing_keys.append(
                        SigningKey.from_pem(ref.get("name", ""), ref.get("algorithm", "ES256"), pem.encode())
                    )
                except ValueError as e:
                    raise TranslationError(str(e))
            try:
                ev = Wristband(
                    issuer=w.get("issuer", ""),
                    custom_claims=_named_values(w.get("customClaims")),
                    token_duration=w.get("tokenDuration"),
                    signing_keys=signing_keys,
                )
            except ValueError as e:
                raise TranslationError(str(e))
            etype = "RESPONSE_WRISTBAND"
        elif rspec.get("json") is not None:
            ev = DynamicJSON(_named_values(rspec["json"].get("properties")))
            etype = "RESPONSE_JSON"
        elif rspec.get("plain") is not None:
            ev = PlainResponse(_value_or_selector(rspec["plain"]) or JSONValue())
            etype = "RESPONSE_PLAIN"
        else:
            raise TranslationError(f"unknown response method for {resp_name!r}")
        return ResponseConfig(
            resp_name,
            ev,
            type=etype,
            wrapper=wrapper,
            wrapper_key=rspec.get("key", ""),
            **common,
        )

    success = response.get("success") or {}
    for resp_name, rspec in (success.get("headers") or {}).items():
        runtime.response.append(await build_success(resp_name, rspec, "httpHeader"))
    for resp_name, rspec in (success.get("dynamicMetadata") or {}).items():
        runtime.response.append(await build_success(resp_name, rspec, "envoyDynamicMetadata"))

    # ---- callbacks (ref :562-583) ----
    for cb_name, cbspec in (spec.get("callbacks") or {}).items():
        if cbspec.get("http") is None:
            raise TranslationError(f"unknown callback method for {cb_name!r}")
        ev = await _build_generic_http(cbspec["http"], namespace, cluster)
        runtime.callbacks.append(
            CallbackConfig(cb_name, ev, type="CALLBACK_HTTP", **_common(cbspec, named, relations))
        )

    # metadata prefetchability: request-independent metadata evaluators are
    # marked here so the engine's prefetcher can pin their documents at
    # reconcile cadence and the lowerability classifier can lift the
    # config out of the metadata-dependency exile
    for md in runtime.metadata:
        mark_prefetchable(md)

    hosts = list(spec.get("hosts") or [])
    if not hosts:
        raise TranslationError("missing hosts")

    # top-level `when` folding: an unmatched AuthConfig gate skips the WHOLE
    # pipeline → OK (ref pkg/service/auth_pipeline.go:454-457).  For an
    # anonymous-identity config whose authorization is entirely compiled
    # patterns and which produces no response/metadata/callbacks, that is
    # exactly  ¬C ∨ ∧(¬cond ∨ rule) = ∧(¬(C ∧ cond) ∨ rule)  — so the gate
    # compiles into every evaluator's condition and the whole decision is
    # the kernel's.  Credential identities cannot fold (a skipped pipeline
    # must allow even credential-less requests) nor can response outputs
    # (skipped requests carry none).  The gate itself must also only read
    # request-rooted data: the reference evaluates it at pipeline start
    # where auth.identity is still None, whereas a folded gate evaluates
    # after identity resolution ({anonymous: true}) — an auth.*-referencing
    # gate would flip verdicts either way (fail-open for neq-style, OK→deny
    # for eq-style), so those stay on the pipeline.
    if (runtime.conditions is not None
            and _gate_selectors_request_rooted(runtime.conditions)
            and pattern_slots
            and len(pattern_slots) == len(runtime.authorization)
            # lowered-OPA slots don't qualify: the pipeline runs the
            # interpreter UNgated, so a folded gate would vanish from its
            # verdict (PatternMatching decides through the kernel, so its
            # gate folds safely)
            and all(isinstance(c.evaluator, PatternMatching)
                    for c in runtime.authorization)
            and len(runtime.identity) == 1
            and isinstance(runtime.identity[0].evaluator, Noop)
            # the anonymous identity must be unconditional: its own `when`
            # (or a failing extension) could flip a gate-unmatched request
            # from skip-OK to UNAUTHENTICATED under the fold
            and runtime.identity[0].conditions is None
            and not runtime.identity[0].extended_properties
            and not runtime.metadata and not runtime.response
            and not runtime.callbacks):
        gate = runtime.conditions
        pattern_slots = [
            (gate if cond is None else All(gate, cond), rule)
            for cond, rule in pattern_slots
        ]
        runtime.conditions = None

    return EngineEntry(
        id=cfg_id,
        hosts=hosts,
        runtime=runtime,
        rules=ConfigRules(name=cfg_id, evaluators=pattern_slots) if pattern_slots else None,
        # the qos-class/weight/quota annotations ride the entry into the
        # engine's weight book
        annotations=dict(annotations) if annotations else None,
    )
