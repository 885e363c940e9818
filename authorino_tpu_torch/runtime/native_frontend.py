"""Python half of the native gRPC frontend (native/csrc/frontend.cpp).

One process owns the card; the wire runs in C++.  The C++ server parses
each ``CheckRequest``, resolves its host and, for a *fast-lane* config,
encodes it straight into the operands of the CUDA mega-kernel
(``ops/csrc/fused_kernel.cu``), gathers such rows for ``window_us`` and
hands each gathered batch (a *slot*) to this module: ONE launch of the
mega-kernel per slot with a row that the verdict cache did not answer.
Everything else reaches the engine's ``AuthPipeline`` over the slow queue.

This module decides, per AuthConfig, whether its full pipeline semantics
reduce to the kernel's verdict (``fast_lane_eligible``):

  - compiled pattern-matching authorization (and inline Rego lowered into
    a kernel slot), ``when`` conditions included: packed column 0 is the
    pipeline's decision;
  - identity as an ordered OR of anonymous (``Noop``) or API-key sources
    (each known key's ``auth.identity.*`` operands resolved to constants at
    refresh), or of *dyn* sources: OIDC/JWT, mTLS, and OAuth2
    introspection or Kubernetes TokenReview under the user's own ``cache``
    opt-in.  A dyn source's variant map is a verified-credential cache:
    the slow lane verifies a credential's first sight through the full
    pipeline and registers it (``_register_dyn``), bounded by the token's
    ``exp``, the certificate's notAfter, the opt-in's TTL and
    ``_DYN_TTL_S``; a JWKS rotation drops the cache (a fresh snapshot);
  - ``auth.*``-only identity extensions and DynamicJSON/Plain responses,
    precomputed per identity outcome (OK bytes per variant);
  - denyWith constant per identity outcome.

A config whose authorization the kernel covers only in part rides the
*hybrid* lane: a kernel DENY is final, a kernel PASS hands the raw request
to the slow lane, whose pipeline runs every evaluator (the covered ones
through ``engine.submit``, launching the kernel again).

Response bytes are built with the port's codec (``protos/ext_authz.py``,
the functions the grpc.aio server answers through), so a fast-lane answer
equals the grpc.aio server's byte for byte, a denial's
``ext_authz_provenance`` included: the kernel's readback names the
evaluator column that denied, and the C++ side picks that column's
precomputed denial (verdict byte ``2 + c``).

Threads: dispatchers (one launch per slot; the readback rides the
readback thread), a readback loop, the slow lane (an asyncio loop of its
own running ``engine.check`` and, from its ``after`` hook, the dyn
registration), a completer landing slow answers in C++ in batches, a
metrics drain, and a refresh thread per JWKS rotation (joined by
``stop()``).

Failures: a slot whose launch or readback fails counts against the
frontend's circuit breaker and is retried once.  A slot the card did not
decide (the retry failed, or the open breaker keeps it off the card)
answers UNAVAILABLE on a card engine (verdict byte 255), a hybrid row
included: it is never handed to the pipeline.  Only a CPU engine
re-decides it with the kernel's plain version on the slot's operands (the
reference's CPU-backend degrade), counted as degraded.

The reference's XLA pre-warm grid (``_bucket_grid``/``_warm_one``) does
not carry over: it kept XLA compiles off live requests, and the CUDA kernel
is compiled once per process.  The staging keeps the pad buckets
(``bucket_pow2`` rows, byte width bucketed by ``_trim_bytes``);
``wait_warm()`` means "the mega-kernel has launched once on this snapshot"
(the warm launch at refresh, counted in ``stats()["warm_launches"]``).

Reference parity: main.go:437-488 (one-process gRPC server),
pkg/service/auth.go:239-310 (Check flow incl. host override + port strip).
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import threading
import time
import urllib.parse
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..authjson import selector as sel
from ..compiler.compile import (
    DFA_VALUE_BYTES,
    OP_CPU,
    OP_REGEX_DFA,
    OP_TREE_CPU,
    CompiledPolicy,
)
from ..compiler.intern import PAD
from ..compiler.pack import DeviceBatch, _trim_bytes, dedup_rows, \
    row_key_bytes, wire_dtype
from ..evaluators import credentials as cred_mod
from ..evaluators.authorization import OPA as OPAEval
from ..evaluators.authorization import PatternMatching
from ..evaluators.base import DenyWithValues, RuntimeAuthConfig
from ..evaluators.identity import MTLS, OIDC, APIKey, KubernetesAuth, \
    Noop, OAuth2
from ..evaluators.identity.api_key import INVALID_API_KEY_MSG
from ..ops import pattern_eval as pe
from ..ops.operands import firing_columns, packed_width, unpack_verdicts
from ..pipeline.pipeline import AuthResult
from ..protos import wire
from ..protos.ext_authz import check_response_from_result, \
    request_model_from_proto
from ..utils import bucket_pow2
from ..utils import metrics as metrics_mod
from ..utils import tracing as tracing_mod
from ..utils import x509
from ..utils.rpc import (
    INVALID_ARGUMENT,
    NOT_FOUND,
    OK,
    PERMISSION_DENIED,
    RESOURCE_EXHAUSTED,
    UNAUTHENTICATED,
    UNAVAILABLE,
)
from ..utils.verdict_cache import VerdictCache
from . import faults
from . import provenance as prov_mod
from .admission import AdmissionController
from .breaker import CircuitBreaker
from .flight_recorder import RECORDER
from .kernel_cost import LEDGER

log = logging.getLogger("authorino_tpu_torch.native_frontend")

__all__ = ["NativeFrontend", "fast_lane_eligible", "FastLaneSpec",
           "FrontendUnavailable"]

# plan kinds — must match native/csrc/frontend.cpp PlanKind
K_CONST, K_METHOD, K_PATH, K_URL_PATH, K_QUERY, K_HOST, K_SCHEME = range(7)
K_PROTOCOL, K_SIZE, K_FRAGMENT, K_HEADER, K_CTX_EXT = range(7, 12)

# batch events — must match native/csrc/frontend.cpp EvKind
EV_TIMEOUT, EV_BATCH, EV_SNAP_RETIRED, EV_STOPPED = 0, 1, 3, 4

# verdict bytes of fe_complete_batch — must match native/csrc/frontend.cpp:
# allow, deny attributed to column c (V_COL0 + c), UNAVAILABLE (0 is a
# deny with the config's column-less denial)
V_ALLOW, V_COL0, V_UNAVAILABLE = 1, 2, 255
MAX_DENY_COLS = V_UNAVAILABLE - V_COL0

UNAVAILABLE_MSG = "policy evaluation unavailable"


class FrontendUnavailable(RuntimeError):
    """The native frontend cannot start here: its library does not build
    or load, libnghttp2 is absent, or the socket does not bind."""


_SIMPLE = {
    ("request", "method"): (K_METHOD, ""),
    ("request", "path"): (K_PATH, ""),
    ("request", "url_path"): (K_URL_PATH, ""),
    ("request", "query"): (K_QUERY, ""),
    ("request", "host"): (K_HOST, ""),
    ("request", "scheme"): (K_SCHEME, ""),
    ("request", "protocol"): (K_PROTOCOL, ""),
    ("request", "size"): (K_SIZE, ""),
    ("request", "fragment"): (K_FRAGMENT, ""),
    ("request", "referer"): (K_HEADER, "referer"),
    ("request", "user_agent"): (K_HEADER, "user-agent"),
}


def _classify_selector(selector_str: str):
    """("req", kind, key) for a request-derived attr, ("auth",) for one that
    resolves over the identity-dependent ``auth.*`` subtree (constant per
    identity outcome), or None when the fast lane cannot encode it."""
    if not selector_str or selector_str[0] in "{[":
        return None
    try:
        segs = sel._parse_path(selector_str)
    except Exception:
        return None
    if not all(s.kind == "key" for s in segs):
        # gjson-extended selectors over the auth tree still resolve
        # constantly per identity; anything touching the request needs the
        # full engine
        keys0 = selector_str.split(".", 1)[0].split("|", 1)[0]
        if keys0 == "auth":
            return ("auth",)
        return None
    keys = tuple(s.key for s in segs)
    if keys in _SIMPLE:
        kind, key = _SIMPLE[keys]
        return ("req", kind, key)
    if len(keys) == 3 and keys[:2] == ("request", "headers"):
        return ("req", K_HEADER, keys[2])
    if len(keys) == 3 and keys[:2] == ("request", "context_extensions"):
        return ("req", K_CTX_EXT, keys[2])
    # legacy context.* mirrors that share exact semantics with the wellknown
    # forms (context_dict filters ""-valued scalar fields, so only the
    # unfiltered maps are plannable)
    if len(keys) == 5 and keys[:4] == ("context", "request", "http", "headers"):
        return ("req", K_HEADER, keys[4])
    if len(keys) == 3 and keys[:2] == ("context", "context_extensions"):
        return ("req", K_CTX_EXT, keys[2])
    if keys[0] == "auth":
        return ("auth",)
    return None


def _const_plan(policy: CompiledPolicy, attr: int, const_doc: Dict[str, Any]):
    """K_CONST plan tuple for `attr` resolved against a constant auth doc,
    or None when the compact device payload can't hold the value (membership
    overflow / DFA byte-tensor unfit) — which disqualifies the config."""
    from ..compiler.encode import _MISSING, _render

    res = sel.get(const_doc, policy.attr_selectors[attr])
    K = policy.members_k
    v = res.value if res.exists else _MISSING
    rendered = _render(v)
    vid = policy.interner.lookup(rendered)
    missing = v is _MISSING or v is None
    members: List[int] = []
    if isinstance(v, list):
        if len(v) > K:
            return None  # const membership overflow: host oracle only
        members = [policy.interner.lookup(_render(e)) for e in v]
    elif not missing:
        members = [vid]
    raw = rendered.encode("utf-8")
    if int(policy.attr_byte_slot[attr]) >= 0 and (
        len(raw) > DFA_VALUE_BYTES or 0 in raw
    ):
        return None  # const DFA operand the byte tensor can't hold
    return (int(attr), K_CONST, "", int(vid), missing, members, raw, False)


def _const_doc(identity_obj) -> Dict[str, Any]:
    """The constant auth.* subtree of a fast-lane request: identity as
    resolved, everything else empty — the authorization phase reads the doc
    BEFORE its own results are stored, and fast-lane configs have no
    metadata/callbacks."""
    return {
        "auth": {
            "identity": identity_obj,
            "metadata": {},
            "authorization": {},
            "response": {},
            "callbacks": {},
        }
    }


_ANON_IDENTITY = {"anonymous": True}


def _static_value(v) -> bool:
    return v is None or not getattr(v, "pattern", "")


# auth.* subtrees that are constant per identity outcome in BOTH lanes at
# every fast-lane resolve point.  auth.authorization is NOT: the pipeline
# stores authorization results before the response phase (and before
# later-priority authorization buckets), while the fast lane's const doc
# holds {} — and a bare `auth` selector includes it
_CONST_AUTH_ROOTS = ("identity", "metadata", "response", "callbacks")


def _auth_subroot_ok(s: str) -> bool:
    parts = s.split(".")
    if len(parts) < 2:
        return False
    sub = parts[1].split("|")[0].split("#")[0].split("@")[0]
    return sub in _CONST_AUTH_ROOTS


def _auth_only_value(v) -> bool:
    """True when a JSONValue resolves constantly per identity outcome:
    static, or selectors/templates rooted entirely in the constant parts
    of the auth.* subtree."""
    from ..authjson.value import is_template, template_selectors

    if not getattr(v, "pattern", ""):
        return True
    sels = (template_selectors(v.pattern) if is_template(v.pattern)
            else [v.pattern])
    return all(_classify_selector(s) == ("auth",) and _auth_subroot_ok(s)
               for s in sels)


def _extend_identity(idc, obj):
    """Mirror IdentityConfig.resolve_extended_properties against a CONSTANT
    identity outcome: extensions read the raw identity through the doc
    (auth.identity stays raw during the loop, exactly like the pipeline's
    _sync_auth-then-extend ordering) while mutating the extended copy."""
    if not idc.extended_properties:
        return obj
    if not isinstance(obj, dict):
        raise ValueError("cannot extend non-object identity")
    doc = _const_doc(obj)
    extended = dict(obj)
    for prop in idc.extended_properties:
        extended[prop.name] = prop.resolve_for(extended, doc)
    return extended


def _response_templates_eligible(rt: RuntimeAuthConfig) -> bool:
    """Response evaluators whose outputs are constant per identity outcome
    (DynamicJSON / Plain over auth.*-only values) can precompute their OK
    CheckResponse bytes per credential variant.  Anything per-request
    (request.* selectors, Wristbands: per-request iat/exp signatures)
    disqualifies."""
    from ..evaluators.response import DynamicJSON, Plain

    for conf in rt.response:
        if conf.conditions is not None or conf.cache is not None or conf.metrics:
            return False
        ev = conf.evaluator
        if isinstance(ev, DynamicJSON):
            vals = [p.value for p in ev.properties]
        elif isinstance(ev, Plain):
            vals = [ev.value]
        else:
            return False
        if not all(_auth_only_value(v) for v in vals):
            return False
    return True


def _deny_with_static(dw: Optional[DenyWithValues]) -> bool:
    if dw is None:
        return True
    if not _static_value(dw.message) or not _static_value(dw.body):
        return False
    return all(_static_value(h.value) for h in dw.headers)


def _deny_with_const(dw: Optional[DenyWithValues]) -> bool:
    """True when every denyWith value is constant per identity outcome:
    static, or templated over the constant auth.* subtrees — then the
    denial bytes precompute per credential variant (identity-failure
    templates resolve against the empty doc, where auth-only selectors are
    constantly missing, exactly like the pipeline's identity-None doc)."""
    if dw is None:
        return True
    vals = [dw.message, dw.body] + [h.value for h in dw.headers]
    return all(v is None or _static_value(v) or _auth_only_value(v)
               for v in vals)


# AuthCredentials location → C++ CredKind (native/csrc/frontend.cpp)
_CRED_KINDS = {
    cred_mod.LOCATION_AUTH_HEADER: 1,
    cred_mod.LOCATION_CUSTOM_HEADER: 2,
    cred_mod.LOCATION_COOKIE: 3,
    cred_mod.LOCATION_QUERY: 4,
}
# mTLS: the forwarded client certificate is the credential
_CRED_KIND_CERT = 5
MISSING_CERT_MSG = "client certificate is missing"


@dataclass
class SourceSpec:
    """One identity source of a fast-lane config, in the pipeline's
    priority-then-declaration order (identity is an OR,
    ref pkg/service/auth_pipeline.go:203-258)."""

    name: str                     # IdentityConfig name (all-fail error keys)
    cred_kind: int = 0
    cred_key: str = ""
    dyn: bool = False             # verified-credential cache (registered
    #                               at runtime by the slow lane)
    # static (API key): per-key plan variants resolved at refresh time
    variants: List[Tuple[bytes, List[tuple], Any]] = field(default_factory=list)
    idc: Any = None               # the IdentityConfig
    missing_msg: str = ""         # failure when the credential is absent
    invalid_msg: str = ""         # static: failure when the key is unknown
    # dyn: extra TTL bound from the user's own cache opt-in (OAuth2
    # introspection / Kubernetes TokenReview)
    ttl_cap: Optional[float] = None


def _kernel_slot(conf) -> Optional[int]:
    """The kernel column that decides this authorization evaluator, or
    None: pattern-matching evaluators bound to the engine, and OPA
    evaluators whose decidable Rego was lowered into a ConfigRules slot at
    translate time (rego_lower)."""
    if conf.cache is not None or conf.metrics:
        return None
    ev_c = conf.evaluator
    if isinstance(ev_c, PatternMatching):
        if ev_c.batched_provider is None or conf.conditions is not None:
            return None
        return int(ev_c.evaluator_slot)
    if isinstance(ev_c, OPAEval):
        # wrapper conditions are fine: translate compiles the same gate
        # into the kernel slot AND keeps it on the pipeline
        return ev_c.kernel_slot
    return None


@dataclass
class FastLaneSpec:
    """Everything the C++ frontend needs to serve one AuthConfig natively.

    ``has_batch`` configs evaluate authorization through the kernel;
    configs without authorization (identity-only) decide entirely in C++.
    ``sources`` lists the config's identity sources (empty = anonymous):
    API-key sources (ref pkg/evaluators/identity/api_key.go:72-93) carry
    per-key plan variants — each known key's ``auth.identity.*`` operands
    resolved to constants at refresh time; dyn sources (OIDC/JWT,
    ref oidc.go:41-103; mTLS, ref mtls.go:23-189; OAuth2 and Kubernetes
    under a cache opt-in) use the variant map as a verified-credential
    cache registered at runtime by the slow lane.  ``auth_attrs`` carries
    the attr rows each variant resolves.  Multi-identity configs are an OR: the
    first source (priority order) whose credential resolves a variant wins;
    all-fail answers come from static templates indexed by which static
    credentials were present.  ``col_order`` lists the config's kernel
    columns in the pipeline's priority-then-declaration order (the first
    one that fails names the denial); for a ``hybrid`` config, its covered
    columns only."""

    plans: List[tuple] = field(default_factory=list)
    has_batch: bool = False
    sources: List[SourceSpec] = field(default_factory=list)
    auth_attrs: List[int] = field(default_factory=list)
    # anonymous configs: the (possibly extended) constant identity object —
    # response templates resolve against it at swap time
    const_identity: Any = None
    # unauthorized denyWith carries identity-templated values → per-variant
    # DENY bytes must be built (else the config-default deny serves)
    deny_templated: bool = False
    col_order: List[int] = field(default_factory=list)
    # hybrid lane: the kernel covers only part of the authorization phase —
    # a kernel DENY answers natively, a kernel PASS hands the raw request
    # to the slow lane for the full pipeline (procedural Rego/SAR/SpiceDB
    # evaluators, arbitrary responses)
    hybrid: bool = False


# bounds on the identity-source fan-out the C++ lane carries: the all-fail
# template table is 2^n_static entries, and every extra source is a per-
# request extraction attempt
_MAX_SOURCES = 4
_MAX_STATIC_SOURCES = 3
# a verified-credential cache entry lives at most this long (and never past
# the token's exp, the certificate's notAfter or the opt-in's cache.ttl)
_DYN_TTL_S = 600.0


def fast_lane_eligible(entry, policy: Optional[CompiledPolicy]) -> Optional[FastLaneSpec]:
    """Returns a FastLaneSpec when `entry`'s pipeline reduces to a native
    decision (kernel verdict and/or credential map lookup), or to a
    native pre-filter of the kernel's denials (the hybrid lane), else
    None.  Mirrors pipeline.evaluate() phase by phase
    (ref pkg/service/auth_pipeline.go:451-502): every feature that would
    need per-request Python work disqualifies."""
    rt: Optional[RuntimeAuthConfig] = entry.runtime
    if rt is None:
        return None
    if rt.conditions is not None:
        return None
    if rt.metadata or rt.callbacks:
        return None
    covered = [c for c in rt.authorization if _kernel_slot(c) is not None]
    uncovered = [c for c in rt.authorization if _kernel_slot(c) is None]
    # hybrid: the kernel pre-filters denials, the pipeline finishes the
    # allows — so responses (which only run on OK) need no template
    # eligibility
    hybrid = bool(covered) and bool(uncovered)
    if rt.response and not hybrid and not _response_templates_eligible(rt):
        return None
    if not rt.identity or len(rt.identity) > _MAX_SOURCES:
        return None
    for idc in rt.identity:
        if idc.conditions is not None:
            return None
        # per-evaluator TTL caches run in the pipeline — except for the
        # revocable-credential identities (OAuth2 introspection, Kubernetes
        # TokenReview), whose opt-in caches the dyn lane honors itself
        # (checked in the source builder)
        if idc.cache is not None and not isinstance(
                idc.evaluator, (OAuth2, KubernetesAuth)):
            return None
        if idc.metrics or metrics_mod.DEEP_METRICS_ENABLED:
            return None  # deep per-evaluator series need the pipeline
        # identity extensions are constant per identity outcome when their
        # values resolve over auth.* only (ref pkg/evaluators/
        # identity_extension.go) — applied at variant-build time
        if idc.extended_properties and not all(
                _auth_only_value(e.value) for e in idc.extended_properties):
            return None
    is_noop = len(rt.identity) == 1 and isinstance(rt.identity[0].evaluator, Noop)
    sources: List[SourceSpec] = []
    if not is_noop:
        # identity sources in the pipeline's priority-then-declaration
        # order (ascending priority buckets; within a bucket the pipeline
        # RACES — the reference's outcome there is scheduling-dependent, so
        # any single winner is within its semantics)
        ordered = sorted(enumerate(rt.identity), key=lambda p: (p[1].priority, p[0]))
        for _, idc in ordered:
            src = _source_spec(idc)
            if src is None:
                return None  # incl. Noop mixed into a multi-identity OR
            sources.append(src)
        if sum(1 for s in sources if not s.dyn) > _MAX_STATIC_SOURCES:
            return None
        # all-fail answers come from constant templates — the identity-
        # failure denyWith must resolve without a request doc (auth-only
        # values are constantly missing there, like the pipeline's)
        if not _deny_with_const(rt.deny_with.unauthenticated):
            return None

    plans: List[tuple] = []
    auth_attrs: List[int] = []
    has_batch = False
    col_order: List[int] = []
    if rt.authorization:
        if entry.rules is None or policy is None:
            return None
        row = policy.config_ids.get(entry.rules.name)
        if row is None:
            return None
        if not covered or len(covered) != len(entry.rules.evaluators):
            return None
        if uncovered:
            # a kernel pre-deny must not preempt an uncovered evaluator the
            # pipeline would have FAILED in an earlier priority bucket
            # (its denial could differ); same-bucket outcomes race in the
            # reference (ref pkg/service/auth_pipeline.go:160-199), so any
            # single winner there is within its semantics
            if max(c.priority for c in covered) > min(
                    u.priority for u in uncovered):
                return None
        if not _deny_with_const(rt.deny_with.unauthorized):
            return None
        # per-request regex/tree oracles cannot run in C++
        for leaf in policy.config_cpu_leaves[row]:
            if int(policy.leaf_op[leaf]) in (OP_CPU, OP_TREE_CPU):
                return None
        ordered_c = sorted(enumerate(covered),
                           key=lambda p: (p[1].priority, p[0]))
        col_order = [_kernel_slot(c) for _, c in ordered_c]
        if (sorted(col_order) != list(range(len(covered)))
                or len(col_order) > MAX_DENY_COLS):
            return None
        has_batch = True
        for attr in policy.config_attrs[row]:
            sel_str = policy.attr_selectors[attr]
            c = _classify_selector(sel_str)
            if c is None:
                return None
            if c[0] == "req":
                plans.append((int(attr), c[1], c[2], 0, False, [], b"", False))
            else:
                # auth.authorization-rooted pattern operands would see the
                # pipeline's earlier-bucket results but the const doc's {} —
                # only the truly constant subtrees are plannable
                if not _auth_subroot_ok(sel_str):
                    return None
                auth_attrs.append(int(attr))
    elif entry.rules is not None and entry.rules.evaluators:
        return None  # compiled rules without runtime authz configs: engine bug

    spec = FastLaneSpec(plans=plans, has_batch=has_batch, sources=sources,
                        auth_attrs=auth_attrs, col_order=col_order,
                        hybrid=hybrid,
                        deny_templated=has_batch and not _deny_with_static(
                            rt.deny_with.unauthorized))
    if is_noop:
        try:
            spec.const_identity = _extend_identity(rt.identity[0],
                                                   dict(_ANON_IDENTITY))
        except ValueError:
            return None
        doc = _const_doc(spec.const_identity)
        for attr in auth_attrs:
            p = _const_plan(policy, attr, doc)
            if p is None:
                return None
            spec.plans.append(p)
        return spec
    # API-key sources: resolve each known key's auth.* operands to
    # constants (the fast-lane analog of precompile-at-reconcile,
    # ref pkg/evaluators/authorization/opa.go:141); dyn sources register
    # their variants at runtime (NativeFrontend._register_dyn)
    for src in sources:
        if src.dyn:
            continue
        for key, secret in src.idc.evaluator.snapshot_secrets().items():
            try:
                ident_obj = _extend_identity(src.idc,
                                             secret.to_identity_object())
            except ValueError:
                return None
            vplans: List[tuple] = []
            if auth_attrs:
                doc = _const_doc(ident_obj)
                for attr in auth_attrs:
                    p = _const_plan(policy, attr, doc)
                    if p is None:
                        return None
                    vplans.append(p)
            # the identity object rides along so refresh can precompute the
            # per-key OK/DENY bytes for response/denyWith-template configs
            # (hybrid OKs are answered by the pipeline, which runs the
            # response phase itself — no per-key OK bytes there)
            src.variants.append((
                key.encode("utf-8"), vplans,
                ident_obj if ((rt.response and not hybrid)
                              or spec.deny_templated) else None))
    return spec


def _source_spec(idc) -> Optional[SourceSpec]:
    """The SourceSpec of one identity config of a multi-source OR, or None
    when the fast lane cannot carry it."""
    ident = idc.evaluator
    if isinstance(ident, (APIKey, OIDC)):
        kind = _CRED_KINDS.get(ident.credentials.location, 0)
        if kind == 0:
            return None
        key_sel = ident.credentials.key_selector
        if isinstance(ident, APIKey):
            return SourceSpec(
                name=idc.name, cred_kind=kind,
                cred_key=key_sel.lower() if kind == 2 else key_sel,
                idc=idc, missing_msg="credential not found",
                invalid_msg=INVALID_API_KEY_MSG)
        return SourceSpec(
            name=idc.name, cred_kind=kind,
            cred_key=key_sel.lower() if kind == 2 else key_sel,
            dyn=True, idc=idc, missing_msg="credential not found")
    if isinstance(ident, MTLS):
        return SourceSpec(name=idc.name, cred_kind=_CRED_KIND_CERT, dyn=True,
                          idc=idc, missing_msg=MISSING_CERT_MSG)
    if isinstance(ident, (OAuth2, KubernetesAuth)):
        # revocable credentials: the AS/apiserver check IS the revocation
        # check — cacheable ONLY when the user explicitly opted in via a
        # `cache` spec keyed by the credential header (the reference's own
        # TTL-cache semantics, ref pkg/evaluators/cache.go:16-89); the dyn
        # entry is then bounded by that TTL (and a response exp)
        if idc.cache is None:
            return None
        if isinstance(ident, KubernetesAuth) and not ident.audiences:
            return None  # the default audience is the REQUEST host
        kind = _CRED_KINDS.get(ident.credentials.location, 0)
        if kind not in (1, 2):
            return None  # header credentials map 1:1 to cache keys
        key_sel = ident.credentials.key_selector
        hdr = "authorization" if kind == 1 else key_sel.lower()
        if idc.cache.key_pattern not in (
                f"request.headers.{hdr}",
                f"context.request.http.headers.{hdr}"):
            return None
        return SourceSpec(
            name=idc.name, cred_kind=kind,
            cred_key=key_sel.lower() if kind == 2 else key_sel,
            dyn=True, idc=idc, missing_msg="credential not found",
            ttl_cap=float(idc.cache.ttl))
    return None


@dataclass
class _SnapRec:
    snap_id: int
    policy: Optional[CompiledPolicy]
    params: Any                        # the engine snapshot's device params
    encoder: Any                       # NativeEncoder (owns the Policy capsule)
    arrays: List[Dict[str, np.ndarray]] = field(default_factory=list)
    keepalive: List[np.ndarray] = field(default_factory=list)
    row_labels: Dict[int, Tuple[str, str]] = field(default_factory=dict)
    # per kernel row, each column's rank in its config's priority order
    # ([G, E] int16; the first failing column by rank names the denial)
    col_rank: Optional[np.ndarray] = None
    warm_done: threading.Event = field(default_factory=threading.Event)
    # verdict-cache eligibility per kernel row (compiler config_cacheable)
    # and the per-config cache key tokens inherited from the engine
    # snapshot: entries of configs a reconcile did not touch stay reachable
    cacheable: Optional[np.ndarray] = None
    cache_tokens: Optional[list] = None
    # the rule heat map of the engine snapshot (one label-children cache
    # for both lanes)
    heat: Any = None
    # the engine snapshot this record was built from (deny provenance of
    # per-credential denials names its rules)
    engine_snap: Any = None
    # configs with dyn sources: entry.id → (fc_idx, FastLaneSpec,
    # {id(IdentityConfig): (source idx, ttl cap)}) — the slow lane
    # registers verified-credential plan variants against this snapshot
    dyn_regs: Dict[str, Tuple[int, FastLaneSpec,
                              Dict[int, Tuple[int, Optional[float]]]]] = \
        field(default_factory=dict)
    # kernel rows of HYBRID configs: dispatch attribution counts only their
    # native denials — kernel-allowed requests continue into the pipeline,
    # which observes them itself
    hybrid_rows: set = field(default_factory=set)
    # the mesh lane: the engine snapshot's ShardedPolicyModel, whose rows
    # key every per-row table here flat (shard * G + row), and each fast
    # config's own shard compile (its per-key auth.* constants resolve
    # against it)
    sharded: Any = None
    entry_policy: Dict[str, Any] = field(default_factory=dict)

    def slot_rows(self, a: Dict[str, np.ndarray], count: int) -> np.ndarray:
        """The kernel rows of a slot's first ``count`` requests (a copy):
        the config row, or on a mesh the flat shard * G + row."""
        rows = a["config_id"][:count].astype(np.int64)
        if self.sharded is not None:
            rows += (a["shard_of"][:count].astype(np.int64)
                     * self.sharded.configs_per_shard)
        return rows


class NativeFrontend:
    """Owns the C++ server lifecycle + the dispatcher/slow-lane threads."""

    def __init__(self, engine, port: int = 0, max_batch: int = 1024,
                 window_us: int = 2000, slots: int = 16, slow_cap: int = 65536,
                 dispatch_threads: int = 6, bind_all: bool = False,
                 trace_sample_n: int = 128,
                 verdict_cache_size: int = 32768, batch_dedup: bool = True,
                 device_timeout_s: Optional[float] = None,
                 breaker_threshold: int = 5, breaker_reset_s: float = 5.0,
                 admission_target_s: float = 0.05,
                 slo_ms: float = 0.0):
        self.engine = engine
        # a failed slot retries once; consecutive failures trip the breaker
        # and whole slots stay off the card; the readback watchdog abandons
        # slots wedged past device_timeout_s
        self.breaker = CircuitBreaker("native", threshold=breaker_threshold,
                                      reset_s=breaker_reset_s)
        self.device_timeout_s = (float(device_timeout_s)
                                 if device_timeout_s else None)
        # batch row dedup + verdict cache, mirroring the engine lane: the
        # card evaluates unique rows only, and cached verdicts skip it
        self.batch_dedup = bool(batch_dedup)
        self._verdict_cache = (VerdictCache(verdict_cache_size)
                               if verdict_cache_size else None)
        # with tracing active, 1-in-N requests take the slow lane with full
        # span export; the rest serve natively.  AUTHORINO_TPU_TRACE_ALL=1
        # restores the reference's every-request tracing
        if os.environ.get("AUTHORINO_TPU_TRACE_ALL", "").lower() in (
                "1", "true", "yes"):
            trace_sample_n = 1
        self.trace_sample_n = max(1, int(trace_sample_n))
        self._trace_mode_logged = False
        self.port = port
        self.bound_port = 0
        self.bind_all = bind_all
        self.max_batch = int(max_batch)
        self.window_us = int(window_us)
        self.slots = int(slots)
        self.slow_cap = int(slow_cap)
        # dispatchers only stage + launch (readback rides the readback
        # thread); the in-flight window is the slot count
        self.dispatch_threads = int(dispatch_threads)
        self._mod = None
        self.nghttp2_path = ""
        self._snaps: Dict[int, _SnapRec] = {}
        self._next_snap_id = 1
        self._running = False
        self._threads: List[threading.Thread] = []
        self._lock = threading.Lock()
        # newest snapshot record — the slow lane registers verified
        # credentials against it (GIL-atomic pointer read)
        self._cur_rec: Optional[_SnapRec] = None
        # live JWKS-rotation refresh threads (joined on stop); own lock —
        # they are tracked from the OIDC notifier, outside _lock
        self._refresh_threads: List[threading.Thread] = []
        self._thread_lock = threading.Lock()
        # evaluators this instance registered _on_oidc_change on —
        # unregistered in stop() so a replaced frontend is not kept alive
        # (and re-fired) by long-lived evaluators
        self._change_wired: set = set()
        # duration/stage histogram drain cadence + accumulated stage counts
        self.hist_drain_s = 2.0
        self._last_hist_drain = 0.0
        self.stage_totals: Dict[str, Any] = {}
        self._stats_drain = metrics_mod.NativeStatsDrain()
        self._drain_wake = threading.Event()
        self._drain_lock = threading.Lock()
        # slow-lane responses buffer here; the completer thread lands them
        # in C++ in batches
        self._done_buf: deque = deque()
        self._done_evt = threading.Event()
        # pipelined readback: dispatchers launch WITHOUT waiting for the
        # device→host copy and park the in-flight slot here
        self._rb_q: deque = deque()
        self._rb_evt = threading.Event()
        self._rb_lock = threading.Lock()
        self._rb_inflight = 0
        self.rb_inflight_peak = 0
        # failure workers alive (retry, degrade): stop() waits them out
        self._fail_live = 0
        self._fe_stopped = False  # set just before fe_stop(): nothing may
        # complete a slot into the torn-down C++ server after it
        self._g_native_inflight = metrics_mod.inflight_batches.labels("native")
        # the slow lane's CoDel state, fed from fe_stats() on the drain
        # cadence (interval above that cadence, or the idle reset flaps)
        self.admission = AdmissionController(
            "native", target_s=admission_target_s,
            interval_s=max(1.0, 2 * self.hist_drain_s))
        self._slow_last: Dict[str, float] = {"slow": 0.0, "t": 0.0}
        self.slo = None
        if slo_ms:
            from ..utils.slo import SloTracker

            self.slo = SloTracker("native", slo_ms)
        # per-frontend counts (process-wide module counts move with other
        # engines): slots launched, rows, device rows, cached slots, warm
        # launches, degraded/unavailable rows
        self._counts_lock = threading.Lock()
        self.counts = dict.fromkeys(
            ("batches", "launches", "plain_calls", "rows", "device_rows",
             "dedup_rows", "cache_rows", "cached_batches", "pad_rows",
             "h2d_bytes", "d2h_bytes", "warm_launches", "retries",
             "degraded_rows", "unavailable_rows", "breaker_open_batches",
             "watchdog_timeouts", "dyn_registered", "dyn_register_ns"), 0)
        # the tenant plane is the engine's: the C++ gather cuts its own
        # slots (no fair cut here), but every completed slot folds its
        # tenant axis into the same per-tenant counters, so detection,
        # weights and /debug/tenants see both lanes; enforcement stays at
        # the engine's admission
        self.tenancy = getattr(engine, "tenancy", None)
        RECORDER.register_provider("native_frontend", self, "debug_vars")

    def _count(self, **kw) -> None:
        with self._counts_lock:
            for k, v in kw.items():
                self.counts[k] += v

    @property
    def host_degrade(self) -> bool:
        """Whether a slot the card did not decide is re-decided on the
        host: only for a CPU engine.  A card answers it UNAVAILABLE."""
        return self.engine.host_degrade

    # ------------------------------------------------------------------
    def start(self) -> int:
        """Build/load the library, bind, start the threads and install the
        engine's current snapshot.  Raises FrontendUnavailable when the
        frontend cannot run here (no card-side fallback)."""
        from .. import native

        try:
            mod = native.load_library()
        except native.BuildError as e:
            raise FrontendUnavailable(f"native library unavailable: {e}") from e
        self.nghttp2_path = mod.fe_nghttp2_path()
        if not self.nghttp2_path:
            raise FrontendUnavailable(
                "libnghttp2.so.14 not found by the dynamic loader: the "
                "native frontend needs it")
        self._mod = mod
        rc = mod.fe_start(self.port, self.max_batch, self.slots, self.window_us,
                          self.slow_cap, self._health_bytes(),
                          1 if self.bind_all else 0)
        if rc != 0:
            self._mod = None
            raise FrontendUnavailable(
                f"native frontend failed to start (rc={rc}): the port "
                f"{self.port} does not bind, or a frontend already runs "
                "in this process")
        self._running = True
        self._fe_stopped = False
        self.bound_port = mod.fe_port()
        self._threads = [
            threading.Thread(target=self._dispatch_loop,
                             name=f"atpu-fe-dispatch-{i}", daemon=True)
            for i in range(self.dispatch_threads)
        ]
        for target, name in ((self._readback_loop, "atpu-fe-readback"),
                             (self._slow_loop, "atpu-fe-slow"),
                             (self._completer_loop, "atpu-fe-completer"),
                             (self._metrics_drain_loop,
                              "atpu-fe-metrics-drain")):
            self._threads.append(threading.Thread(target=target, name=name,
                                                  daemon=True))
        for t in self._threads:
            t.start()
        try:
            self.refresh()
        except Exception:
            self.stop(drain_s=0)
            raise
        self.engine.add_swap_listener(self.refresh)
        return self.bound_port

    def stop(self, drain_s: float = 10.0) -> None:
        """Drain, then tear down, within ``drain_s``: new Check() streams
        answer UNAVAILABLE, the filling batch flushes, every request
        already received (fast-lane slots, slow-lane work, failure
        workers) is answered and its answer handed to the wire; then the
        C++ server writes what it queued and stops."""
        if self._mod is not None and self._running:
            self._mod.fe_drain()
            deadline = time.monotonic() + drain_s
            while time.monotonic() < deadline:
                s = self._mod.fe_stats()
                if not any(s.get(k, 0) for k in (
                        "slow_pending", "slow_queued", "batches_pending",
                        "filling", "done_queued")) and not (
                        self._rb_inflight or self._fail_live
                        or self._done_buf):
                    break
                time.sleep(0.02)
        self._running = False
        self._rb_evt.set()
        self.engine.remove_swap_listener(self.refresh)
        # unwire AFTER the swap listener is gone and under _lock, so a
        # concurrent refresh() cannot re-register listeners mid-unwire
        with self._lock:
            for ev in self._change_wired:
                remove = getattr(ev, "remove_change_listener", None)
                if remove is not None:
                    remove(self._on_oidc_change)
            self._change_wired.clear()
        # a rotation refresh still running must end before teardown (it
        # returns at once now that _running is False, or finishes its swap)
        with self._thread_lock:
            pending, self._refresh_threads = self._refresh_threads, []
        for t in pending:
            t.join(timeout=30)
        if self._mod is not None:
            try:
                self._fold_fc_counts()
                self.drain_histograms()  # final fold: short runs lose nothing
                self.drain_native_stats()
            except Exception:
                log.exception("final metric drain failed")
            self._fe_stopped = True
            self._mod.fe_stop()
        self._drain_wake.set()
        self._done_evt.set()
        for t in self._threads:
            t.join(timeout=5)
        self._threads = []

    def stats(self) -> Dict[str, int]:
        """fe_stats() plus the verdict cache's counters (folded into the
        dyn_hit/dyn_miss/dyn_add keys, as the reference's, and under their
        own vdict_* keys) and the frontend's own counts."""
        s = dict(self._mod.fe_stats()) if self._mod else {}
        vc = self._verdict_cache
        if s and vc is not None:
            counts = vc.counts()
            s["dyn_hit"] = s.get("dyn_hit", 0) + counts["hits"]
            s["dyn_miss"] = s.get("dyn_miss", 0) + counts["misses"]
            s["dyn_add"] = s.get("dyn_add", 0) + counts["adds"]
            s["vdict_hit"] = counts["hits"]
            s["vdict_miss"] = counts["misses"]
            s["vdict_add"] = counts["adds"]
            s["vdict_evict"] = counts["evictions"]
        if s:
            with self._counts_lock:
                for k, v in self.counts.items():
                    s[f"fe_{k}"] = v
        return s

    def drain_native_stats(self) -> None:
        """Fold the fe_stats() counters into Prometheus as deltas
        (auth_server_native_frontend_events_total / _queue_depth)."""
        with self._drain_lock:
            self._stats_drain.fold(self.stats())

    def _metrics_drain_loop(self) -> None:
        while self._running:
            self._drain_wake.wait(self.hist_drain_s)
            if not self._running:
                return
            try:
                self.drain_native_stats()
                self._feed_admission()
            except Exception:
                log.exception("native stats drain failed")

    def _feed_admission(self) -> None:
        """The slow lane's standing queue wait, estimated from fe_stats()
        (Little's law: queued / observed completion rate), fed to the
        CoDel admission state on the drain cadence."""
        s = self.stats()
        if not s:
            return
        now = time.monotonic()
        last_t = self._slow_last["t"]
        done = float(s.get("slow", 0))
        queued = float(s.get("slow_queued", 0)) + float(s.get("slow_pending", 0))
        if last_t:
            dt = now - last_t
            delta = done - self._slow_last["slow"]
            if dt > 0 and delta >= 0:
                self.admission.observe_service(int(delta), now=now)
                rate = delta / dt
                self.admission.observe_waits((queued / max(rate, 1.0),),
                                             now=now)
        self._slow_last["slow"] = done
        self._slow_last["t"] = now

    def debug_vars(self) -> Dict[str, Any]:
        """JSON-safe live state for /debug/vars."""
        rec = self._cur_rec
        out: Dict[str, Any] = {
            "enabled": True,
            "running": self._running,
            "port": self.bound_port,
            "nghttp2": self.nghttp2_path,
            "device": str(self.engine.device),
            "host_degrade": self.host_degrade,
            "stats": {k: int(v) for k, v in self.stats().items()},
            "max_batch": self.max_batch,
            "window_us": self.window_us,
            "slots": self.slots,
            "dispatch_threads": self.dispatch_threads,
            "inflight_batches": self._rb_inflight,
            "inflight_peak": self.rb_inflight_peak,
            "trace_sample_n": self.trace_sample_n,
            "batch_dedup": self.batch_dedup,
            "verdict_cache": (self._verdict_cache.counts()
                              if self._verdict_cache is not None else None),
            "breaker": self.breaker.to_json(),
            "device_timeout_s": self.device_timeout_s,
            "admission": self.admission.to_json(),
            "slo": self.slo.to_json() if self.slo is not None else None,
            # the shared tenant plane's view (both lanes fold into it)
            "tenancy": (self.tenancy.to_json()
                        if self.tenancy is not None else None),
            "provenance": {
                "heat": (rec.heat.to_json()
                         if rec is not None and rec.heat is not None
                         else None),
            },
            "kernel_cost": {"ledger": LEDGER.to_json()},
            # the engine's canary and quarantine state: this lane holds
            # the baseline through a canary window
            "change_safety": self.engine.change_safety_vars(),
            "snapshot": None,
        }
        if rec is not None:
            out["snapshot"] = {
                "snap_id": rec.snap_id,
                "warm_done": rec.warm_done.is_set(),
                "fast_configs": len(rec.row_labels),
                "hybrid_configs": len(rec.hybrid_rows),
                "dyn_registrations": len(rec.dyn_regs),
                "slots": len(rec.arrays),
            }
        return out

    # ------------------------------------------------------------------
    @staticmethod
    def _health_bytes() -> bytes:
        return wire.encode_health_response(
            wire.HealthCheckResponse(status=wire.SERVING))

    @staticmethod
    def _result_bytes(result: AuthResult) -> bytes:
        return wire.encode_check_response(check_response_from_result(result))

    @staticmethod
    def _static_deny(result: AuthResult, deny: Optional[DenyWithValues],
                     doc: Optional[Dict[str, Any]] = None) -> AuthResult:
        """Constant mirror of pipeline._customize_deny_with
        (ref pkg/service/auth_pipeline.go:581-608): the denyWith values are
        pre-checked constant for ``doc`` (static, or auth-only against a
        const identity doc; the default empty doc serves identity-failure
        templates, where auth-only selectors are constantly missing)."""
        from ..authjson.value import stringify_json

        doc = doc or {}
        if deny is not None:
            if deny.code:
                result.status = deny.code
            if deny.message is not None:
                result.message = stringify_json(deny.message.resolve_for(doc))
            if deny.body is not None:
                result.body = stringify_json(deny.body.resolve_for(doc))
            if deny.headers:
                result.headers = [
                    {h.name: stringify_json(h.value.resolve_for(doc))}
                    for h in deny.headers
                ]
        return result

    def _deny_result(self, rt: RuntimeAuthConfig, identity_obj: Any = None,
                     col: Optional[int] = None, snap=None) -> AuthResult:
        """Authorization-failure template, optionally resolved against a
        constant identity (ref pkg/service/auth_pipeline.go:478-481).  With
        ``col``, the denial of the evaluator deciding that kernel column,
        as the pipeline builds it: a pattern-matching denial carries its
        rule's provenance (message behind --expose-deny-reason, Envoy
        dynamic_metadata always), a lowered OPA denial none."""
        result = AuthResult(code=PERMISSION_DENIED, message="Unauthorized",
                            headers=[])
        if col is not None:
            for conf in rt.authorization:
                ev = conf.evaluator
                if isinstance(ev, PatternMatching) and \
                        int(ev.evaluator_slot) == col:
                    try:
                        prov = ev.attributor(col, snap)
                    except Exception:
                        prov = None
                    if prov is None:
                        prov = prov_mod.deny_provenance(
                            "", col, str(ev.rules), lane="pipeline")
                    result.message = prov_mod.deny_reason(prov)
                    result.metadata = {"ext_authz_provenance": dict(prov)}
                    break
        return self._static_deny(
            result, rt.deny_with.unauthorized,
            doc=_const_doc(identity_obj) if identity_obj is not None else None)

    def _deny_set(self, rt: RuntimeAuthConfig, spec: FastLaneSpec,
                  identity_obj: Any = None, snap=None) -> List[bytes]:
        """[column-less denial, denial of column 0, column 1, ...] — the
        C++ side picks by the verdict byte."""
        out = [self._result_bytes(self._deny_result(rt, identity_obj))]
        for c in range(len(spec.col_order)):
            out.append(self._result_bytes(
                self._deny_result(rt, identity_obj, col=c, snap=snap)))
        return out

    def _unauth_result(self, rt: RuntimeAuthConfig, message: str) -> AuthResult:
        """Identity-failure template: UNAUTHENTICATED + WWW-Authenticate
        challenges + static denyWith.unauthenticated
        (ref pkg/service/auth_pipeline.go:468-472)."""
        return self._static_deny(
            AuthResult(code=UNAUTHENTICATED, message=message,
                       headers=rt.challenge_headers()),
            rt.deny_with.unauthenticated)

    def _ok_bytes_for(self, rt: RuntimeAuthConfig, identity_obj) -> bytes:
        """Success CheckResponse bytes for a CONSTANT identity outcome:
        response evaluators resolved bucket by bucket against the const
        doc — mirrors pipeline._evaluate_response + wrap_responses + the
        success assembly (ref pkg/service/auth_pipeline.go:487-491)."""
        from ..evaluators.base import wrap_responses
        from ..evaluators.response import DynamicJSON

        doc = _const_doc(identity_obj)
        results: Dict[Any, Any] = {}
        grouped: Dict[int, list] = {}
        for c in rt.response:
            grouped.setdefault(c.priority, []).append(c)
        for bucket in (grouped[p] for p in sorted(grouped)):
            for conf in bucket:
                ev = conf.evaluator
                if isinstance(ev, DynamicJSON):
                    results[conf] = {p.name: p.value.resolve_for(doc)
                                     for p in ev.properties}
                else:
                    results[conf] = ev.value.resolve_for(doc)
            doc["auth"]["response"] = {c.name: o for c, o in results.items()}
        headers, metadata = wrap_responses(results)
        return self._result_bytes(
            AuthResult(code=OK, headers=[headers], metadata=metadata))

    def _unauth_templates(self, rt: RuntimeAuthConfig,
                          sources: List[SourceSpec]) -> List[bytes]:
        """All-sources-failed CheckResponse templates, indexed by the
        bitmask of which STATIC sources' credentials were present (present
        ⇒ key unknown; absent ⇒ missing; dyn sources reaching this path are
        always missing — an extractable dyn credential goes to the slow
        lane).  Byte-exact with the pipeline: one source returns its bare
        error, several return the sorted JSON error dict
        (ref auth_pipeline.go:203-258)."""
        if not sources:
            return []
        n_static = sum(1 for s in sources if not s.dyn)
        out: List[bytes] = []
        for mask in range(1 << n_static):
            errors: Dict[str, str] = {}
            si = 0
            for s in sources:
                if s.dyn:
                    errors[s.name] = s.missing_msg
                else:
                    errors[s.name] = (s.invalid_msg if (mask >> si) & 1
                                      else s.missing_msg)
                    si += 1
            if len(sources) == 1:
                msg = errors[sources[0].name]
            else:
                msg = json.dumps(errors, separators=(",", ":"),
                                 sort_keys=True)
            out.append(self._result_bytes(self._unauth_result(rt, msg)))
        return out

    def wait_warm(self, timeout_s: float = 600.0) -> bool:
        """True once the mega-kernel has launched once on the newest
        snapshot (the warm launch at refresh; nothing to compile beyond
        the kernel, which is built once per process)."""
        with self._lock:
            rec = self._cur_rec
        if rec is None:
            return True
        return rec.warm_done.wait(timeout_s)

    # ------------------------------------------------------------------
    def refresh(self) -> None:
        """Rebuild the C++ snapshot from the engine's current one (after
        every engine.apply_snapshot — the reconcile-time swap).  Serialized
        under _lock: concurrent reconciles must not mint duplicate ids or
        install their C++ snapshots out of order.

        During an engine canary the swap listeners do not fire and
        ``engine._snapshot`` is the baseline, so this lane holds the
        previous generation until promotion or rollback (a gathered C++
        batch is never split across two corpora); its evidence feeds the
        guard's baseline cohort through ``canary_observe_external``."""
        with self._lock:
            self._refresh_locked()

    def _refresh_locked(self) -> None:
        # a refresh blocked on _lock when stop() ran must not fe_swap onto
        # a torn-down module
        if not self._running:
            return
        snap = self.engine._snapshot
        policy = snap.policy if snap is not None else None
        sharded = snap.sharded if snap is not None else None
        mod = self._mod

        # the C++ encoder implements the id, membership and DFA lanes only:
        # a corpus with numeric or relation operands or the overflow assist
        # is served by the slow lane
        def outside(pol) -> bool:
            return (int(getattr(pol, "n_num_attrs", 0) or 0) > 0
                    or int(getattr(pol, "n_rel_slots", 0) or 0) > 0
                    or bool(getattr(pol, "ovf_assist", False)))

        if (policy is not None and outside(policy)) or (
                sharded is not None and outside(sharded.shards[0])):
            log.warning(
                "native fast lane off for this snapshot: the corpus uses "
                "numeric/relation/overflow-assist lanes the C++ encoder "
                "does not implement — the slow lane serves it")
            policy = sharded = None

        snap_id = self._next_snap_id
        self._next_snap_id += 1
        spec: Dict[str, Any] = {
            "snap_id": snap_id,
            "policy": None,
            "A": 0, "M": 0, "K": 0, "C": 0, "NB": 0, "DVB": DFA_VALUE_BYTES,
            "elem16": 0,
            "fcs": [], "hosts": [], "slots": [],
            "attr_dfas": [],
            "dfa_R": 0, "dfa_S": 0,
            "invalid": self._result_bytes(
                AuthResult(code=INVALID_ARGUMENT, message="Invalid request")),
            "notfound": self._result_bytes(
                AuthResult(code=NOT_FOUND, message="Service not found")),
            "unavailable": self._result_bytes(
                AuthResult(code=UNAVAILABLE, message=UNAVAILABLE_MSG)),
            "health": self._health_bytes(),
        }
        rec = _SnapRec(snap_id=snap_id, policy=policy, params=None,
                       encoder=None)
        rec.heat = snap.heat if snap is not None else None
        rec.engine_snap = snap
        entries = list(snap.entries) if snap is not None else []
        fcs: List[dict] = []
        # exact hosts AND "*.suffix" wildcard keys — the C++ side replicates
        # the index's wildcard walk-up (ref pkg/index/index.go:153-174)
        hosts: List[Tuple[str, int]] = []
        ok_bytes = self._result_bytes(AuthResult(code=OK, headers=[{}]))

        # active span export needs a per-request Python span: with tracing
        # on, 1-in-N requests take the slow lane with full spans
        spec["trace_every"] = (self.trace_sample_n
                               if tracing_mod.tracing_active() else 0)
        if spec["trace_every"] > 1 and not self._trace_mode_logged:
            self._trace_mode_logged = True
            log.info("tracing active: head-sampling 1-in-%d requests to the "
                     "slow lane for span export (the rest serve natively, "
                     "untraced); AUTHORINO_TPU_TRACE_ALL=1 traces every "
                     "request", spec["trace_every"])

        if policy is not None and snap.encoder is not None \
                and snap.params is not None:
            enc = snap.encoder
            rec.encoder = enc
            rec.params = snap.params
            spec["policy"] = enc._handle
            dt = wire_dtype(policy)
            A, M, K = policy.n_attrs, policy.n_member_attrs, policy.members_k
            C, NB = policy.n_cpu_leaves, max(policy.n_byte_attrs, 1)
            spec.update(A=A, M=M, K=K, C=C, NB=NB,
                        elem16=1 if dt == np.int16 else 0)
            ams = np.ascontiguousarray(policy.member_attr_slot, dtype=np.int32)
            abs_v = np.ascontiguousarray(policy.attr_byte_slot, dtype=np.int32)
            rec.keepalive += [ams, abs_v]
            spec["attr_member_slot_addr"] = ams.ctypes.data
            spec["attr_byte_slot_addr"] = abs_v.ctypes.data
            rec.cacheable = policy.config_cacheable
            rec.cache_tokens = snap.cache_tokens
            E = int(policy.eval_rule.shape[1])
            rec.col_rank = np.tile(np.arange(max(E, 1), dtype=np.int16),
                                   (max(policy.n_configs, 1), 1))
            if policy.n_byte_attrs > 0 and policy.dfa_tables.size:
                # C++ indexes transition tables BY ROW: expand the
                # compiler's deduped [T, S, 256] store
                dt_tr = np.ascontiguousarray(policy.dfa_tables_by_row,
                                             dtype=np.uint8)
                dt_ac = np.ascontiguousarray(policy.dfa_accept_by_row,
                                             dtype=np.uint8)
                rec.keepalive += [dt_tr, dt_ac]
                spec.update(dfa_R=int(dt_tr.shape[0]), dfa_S=int(dt_tr.shape[1]),
                            dfa_trans_addr=dt_tr.ctypes.data,
                            dfa_accept_addr=dt_ac.ctypes.data)
            # per-attr DFA leaves → (dfa row, dense cpu column)
            cpu_col = {int(l): i for i, l in enumerate(policy.cpu_leaf_list)}
            attr_dfas: List[List[Tuple[int, int]]] = [[] for _ in range(A)]
            for leaf in range(policy.n_leaves):
                if int(policy.leaf_op[leaf]) == OP_REGEX_DFA and leaf in cpu_col:
                    attr_dfas[int(policy.leaf_attr[leaf])].append(
                        (int(policy.leaf_dfa_row[leaf]), cpu_col[leaf]))
            spec["attr_dfas"] = attr_dfas
            # batch slots (numpy-owned; freed on SNAP_RETIRED)
            B = self.max_batch
            for _ in range(self.slots):
                a = {
                    "attrs_val": np.zeros((B, A), dtype=dt),
                    "members": np.full((B, M, K), PAD, dtype=dt),
                    "cpu_dense": np.zeros((B, C), dtype=np.uint8),
                    "config_id": np.zeros((B,), dtype=np.int32),
                    "attr_bytes": np.zeros((B, NB, DFA_VALUE_BYTES),
                                           dtype=np.uint8),
                    "byte_ovf": np.zeros((B, NB), dtype=np.uint8),
                }
                rec.arrays.append(a)
                spec["slots"].append({k: v.ctypes.data for k, v in a.items()})
        elif sharded is not None:
            policy = self._sharded_spec(rec, spec, sharded)
            if policy is None:
                sharded = None  # no native encoder: kernel lane off
        else:
            policy = rec.policy = None  # no native encoder: kernel lane off

        fast_ids = set()
        for entry in entries:
            # each entry is judged against its own compile: the single
            # corpus, or its owning shard's on a mesh
            policy_for = policy
            if sharded is not None:
                loc = (sharded.locator.get(entry.rules.name)
                       if entry.rules is not None else None)
                policy_for = (sharded.shards[loc[0]] if loc is not None
                              else None)
            spec_fl = fast_lane_eligible(entry, policy_for)
            if spec_fl is None:
                continue
            if spec_fl.has_batch and policy is None:
                continue
            fast_ids.add(id(entry))
            fc_idx = len(fcs)
            # per-authconfig metric labels — the pipeline's scheme
            # (ref pkg/service/auth_pipeline.go:26-36)
            lbl = entry.runtime.labels or {}
            ns_l, nm_l = lbl.get("namespace", ""), lbl.get("name", "")
            rt_e = entry.runtime
            # response/denyWith-template configs: OK and DENY bytes are per
            # identity outcome (anonymous at swap; per-key at swap; per-
            # credential at dyn registration) — empty bytes in a variant =
            # the config default.  A hybrid config's OK is the pipeline's
            fc_ok = (self._ok_bytes_for(rt_e, spec_fl.const_identity)
                     if rt_e.response and not spec_fl.sources
                     and not spec_fl.hybrid else ok_bytes)
            fc_deny = self._deny_set(
                rt_e, spec_fl,
                spec_fl.const_identity
                if spec_fl.deny_templated and not spec_fl.sources else None,
                snap=snap)
            fc = {
                "row": 0,
                "has_batch": 1 if spec_fl.has_batch else 0,
                "hybrid": 1 if spec_fl.hybrid else 0,
                "ok": fc_ok,
                "deny": fc_deny,
                "plans": spec_fl.plans,
                "sources": [
                    {
                        "cred_kind": s.cred_kind,
                        "cred_key": s.cred_key,
                        "dyn": 1 if s.dyn else 0,
                        "variants": [
                            (key, vplans,
                             self._ok_bytes_for(rt_e, ident_obj)
                             if ident_obj is not None and rt_e.response
                             and not spec_fl.hybrid
                             else b"",
                             self._deny_set(rt_e, spec_fl, ident_obj,
                                            snap=snap)
                             if ident_obj is not None
                             and spec_fl.deny_templated else [])
                            for key, vplans, ident_obj in s.variants
                        ],
                    }
                    for s in spec_fl.sources
                ],
                "unauth_msgs": self._unauth_templates(rt_e, spec_fl.sources),
                "ns": ns_l,
                "name": nm_l,
            }
            dyn_map = {id(s.idc): (i, s.ttl_cap)
                       for i, s in enumerate(spec_fl.sources) if s.dyn}
            if dyn_map:
                rec.dyn_regs[entry.id] = (fc_idx, spec_fl, dyn_map)
                # a JWKS rotation invalidates every cached token: swap in a
                # fresh snapshot (empty variant map) when the provider's key
                # set actually changes (add_change_listener dedups, so
                # re-wiring on every refresh is safe — and a reconcile-
                # minted evaluator gets wired the first time)
                for s in spec_fl.sources:
                    add_listener = getattr(s.idc.evaluator,
                                           "add_change_listener", None)
                    if s.dyn and add_listener is not None:
                        add_listener(self._on_oidc_change)
                        self._change_wired.add(s.idc.evaluator)
            if spec_fl.has_batch:
                if sharded is not None:
                    shard, srow = sharded.locator[entry.rules.name]
                    fc["row"], fc["shard"] = int(srow), int(shard)
                    row = int(shard) * sharded.configs_per_shard + int(srow)
                    rec.entry_policy[entry.id] = policy_for
                else:
                    row = int(policy.config_ids[entry.rules.name])
                    fc["row"] = row
                rec.row_labels[row] = (ns_l, nm_l)
                if spec_fl.hybrid:
                    rec.hybrid_rows.add(row)
                for rank, c in enumerate(spec_fl.col_order):
                    rec.col_rank[row, c] = rank
            fcs.append(fc)
            for host in entry.hosts:
                hosts.append((host, fc_idx))

        # non-fast hosts route to the Python pipeline (slow lane)
        fast_hosts = {h for h, _ in hosts}
        for entry in entries:
            if id(entry) in fast_ids:
                continue
            for host in entry.hosts:
                if host not in fast_hosts:
                    hosts.append((host, -1))
        spec["fcs"] = fcs
        spec["hosts"] = hosts

        if rec.arrays:
            # the swap gate: the snapshot's first mega-kernel launch
            # happens here, off live requests (the launch words of a new
            # params tree are built at its first launch)
            self._warm_launch(rec)
        rec.warm_done.set()
        self._snaps[snap_id] = rec  # caller holds _lock
        self._cur_rec = rec
        mod.fe_swap(spec)
        metrics_mod.snapshot_generation.labels("native_frontend").set(snap_id)
        RECORDER.record("snapshot-swap", lane="native", detail={
            "snap_id": snap_id, "fast_configs": len(fcs),
            "hosts": len(hosts)})
        log.info("native frontend snapshot %d: %d fast configs, %d host keys",
                 snap_id, len(fcs), len(hosts))

    def _sharded_spec(self, rec: _SnapRec, spec: Dict[str, Any], sharded):
        """The C++ snapshot of a mesh-sharded corpus: the shards share one
        interner and ShapeTargets-unified shapes, so the encoder lays each
        request into its owning shard's [B, S, ...] slice and one mesh
        dispatch serves the slot.  Per-shard metadata stacks on the shard
        axis, the DFA tables on the (shard-globalized) row axis.  Returns
        the first shard's policy (the record's shapes), or None when the
        corpus is outside the native encoder's domain."""
        from ..native import get_native_encoder

        enc = get_native_encoder(sharded.shards[0])
        if enc is None:
            return None
        rec.encoder = enc
        rec.sharded = sharded
        p0 = rec.policy = sharded.shards[0]
        spec["policy"] = enc._handle
        S = sharded.n_shards
        G = sharded.configs_per_shard
        A, M, K = p0.n_attrs, p0.n_member_attrs, p0.members_k
        C, NB = p0.n_cpu_leaves, max(p0.n_byte_attrs, 1)
        # the mesh encode takes int32 operands: no 16-bit elements
        spec.update(A=A, M=M, K=K, C=C, NB=NB, S=S, elem16=0)
        ams = np.ascontiguousarray(
            np.stack([p.member_attr_slot for p in sharded.shards]),
            dtype=np.int32)
        abs_v = np.ascontiguousarray(
            np.stack([p.attr_byte_slot for p in sharded.shards]),
            dtype=np.int32)
        rec.keepalive += [ams, abs_v]
        spec["attr_member_slot_addr"] = ams.ctypes.data
        spec["attr_byte_slot_addr"] = abs_v.ctypes.data
        rec.cacheable = np.concatenate(
            [p.config_cacheable for p in sharded.shards])
        rec.cache_tokens = ([t for toks in self.engine._snapshot.mesh_tokens
                             for t in toks]
                            if self.engine._snapshot.mesh_tokens is not None
                            else None)
        E = int(p0.eval_rule.shape[1])
        rec.col_rank = np.tile(np.arange(max(E, 1), dtype=np.int16),
                               (max(S * G, 1), 1))
        attr_dfas: List[List[Tuple[int, int]]] = [[] for _ in range(S * A)]
        if p0.n_byte_attrs > 0 and p0.dfa_tables.size:
            R = int(p0.dfa_table_of_row.shape[0])
            dt_tr = np.ascontiguousarray(
                np.concatenate([p.dfa_tables_by_row for p in sharded.shards]),
                dtype=np.uint8)
            dt_ac = np.ascontiguousarray(
                np.concatenate([p.dfa_accept_by_row for p in sharded.shards]),
                dtype=np.uint8)
            rec.keepalive += [dt_tr, dt_ac]
            spec.update(dfa_R=int(dt_tr.shape[0]), dfa_S=int(dt_tr.shape[1]),
                        dfa_trans_addr=dt_tr.ctypes.data,
                        dfa_accept_addr=dt_ac.ctypes.data)
            for s, p in enumerate(sharded.shards):
                cpu_col = {int(l): i for i, l in enumerate(p.cpu_leaf_list)}
                for leaf in range(p.n_leaves):
                    if int(p.leaf_op[leaf]) == OP_REGEX_DFA and leaf in cpu_col:
                        attr_dfas[s * A + int(p.leaf_attr[leaf])].append(
                            (s * R + int(p.leaf_dfa_row[leaf]),
                             cpu_col[leaf]))
        spec["attr_dfas"] = attr_dfas
        B = self.max_batch
        for _ in range(self.slots):
            a = {
                "attrs_val": np.zeros((B, S, A), dtype=np.int32),
                "members": np.full((B, S, M, K), PAD, dtype=np.int32),
                "cpu_dense": np.zeros((B, S, C), dtype=np.uint8),
                "config_id": np.zeros((B,), dtype=np.int32),
                "shard_of": np.zeros((B,), dtype=np.int32),
                "attr_bytes": np.zeros((B, S, NB, DFA_VALUE_BYTES),
                                       dtype=np.uint8),
                "byte_ovf": np.zeros((B, S, NB), dtype=np.uint8),
            }
            rec.arrays.append(a)
            spec["slots"].append({k: v.ctypes.data for k, v in a.items()})
        return p0

    def _on_oidc_change(self) -> None:
        """JWKS rotation: rebuild the C++ snapshot (fresh, empty variant
        map) so tokens verified under retired keys stop being served fast.
        Runs on a thread of its own: the notifier is an asyncio task and
        refresh() launches the kernel once (the warm launch)."""
        if not self._running:
            return
        self._track_thread(threading.Thread(target=self._refresh_if_running,
                                            name="atpu-fe-oidc-refresh",
                                            daemon=True))

    def _refresh_if_running(self) -> None:
        if self._running:
            self.refresh()

    def _track_thread(self, t: threading.Thread) -> None:
        """Register-then-start a refresh thread under its own lock: an
        entry dropped here would escape stop()'s join and race teardown."""
        with self._thread_lock:
            self._refresh_threads = [
                p for p in self._refresh_threads if p.is_alive()] + [t]
        t.start()

    def _register_dyn(self, rec: Optional[_SnapRec], entry, pipeline,
                      model) -> None:
        """After a slow-lane pipeline run: if the config has dyn sources
        and a dyn source resolved the identity, cache this credential's
        plan variant in C++ so the next request with it never touches
        Python (the fast-lane analog of the reference's per-evaluator TTL
        cache keyed by access token).

        ``rec`` is the snapshot record captured BEFORE the pipeline ran: a
        JWKS rotation that rebuilds the snapshot mid-verification makes the
        registration land nowhere instead of re-caching a retired-key token
        into the fresh snapshot."""
        if rec is None or rec is not self._cur_rec:
            return
        reg = rec.dyn_regs.get(entry.id)
        if reg is None:
            return
        t0 = time.perf_counter_ns()
        fc_idx, spec, src_map = reg
        idc, obj = pipeline.resolved_identity()
        if obj is None:
            return
        reg_src = src_map.get(id(idc))
        if reg_src is None:
            return  # the winning identity is not a dyn source
        src_idx, ttl_cap = reg_src
        now = time.time()
        ttl = _DYN_TTL_S
        if ttl_cap is not None:
            # the opted-in window is anchored at the LAST REAL check: a
            # registration off a pipeline-cache hit must not restart the
            # clock (revocation would slip past cache.ttl otherwise)
            ttl = min(ttl, ttl_cap)
            if idc.cache is not None:
                try:
                    rem = idc.cache.remaining(idc.cache.resolve_key_for(
                        pipeline.authorization_json()))
                except Exception:
                    rem = None
                if rem is not None:
                    ttl = min(ttl, rem)
        deadline = now + ttl
        if isinstance(idc.evaluator, MTLS):
            # the raw forwarded PEM is the cache key (exactly the bytes the
            # C++ side extracts); the certificate's own notAfter bounds it
            token = model.source.certificate or ""
            if not token:
                return
            try:
                cert = x509.load_pem_x509_certificate(
                    urllib.parse.unquote(token).encode())
                deadline = min(deadline,
                               cert.not_valid_after_utc.timestamp())
            except Exception:
                return
        else:
            try:
                token = idc.evaluator.credentials.extract(model.http)
            except Exception:
                return
        exp = obj.get("exp") if isinstance(obj, dict) else None
        if isinstance(exp, (int, float)) and not isinstance(exp, bool):
            deadline = min(deadline, float(exp))
        if deadline <= now:
            return
        vplans: List[tuple] = []
        if spec.auth_attrs:
            pol = rec.entry_policy.get(entry.id, rec.policy)
            if pol is None:
                return
            doc = _const_doc(obj)
            for attr in spec.auth_attrs:
                p = _const_plan(pol, attr, doc)
                if p is None:
                    return  # this token's values do not fit the payload
                vplans.append(p)
        rt_e = entry.runtime
        ok_bytes = b""
        deny_set: List[bytes] = []
        try:
            if rt_e.response and not spec.hybrid:
                # hybrid OKs are answered by the pipeline (its response
                # phase runs there) — no per-credential OK bytes
                ok_bytes = self._ok_bytes_for(rt_e, obj)
            if spec.deny_templated:
                deny_set = self._deny_set(rt_e, spec, obj,
                                          snap=rec.engine_snap)
        except Exception:
            return  # this credential's templates do not resolve: stay slow
        if self._mod.fe_add_variant(rec.snap_id, fc_idx, src_idx,
                                    token.encode("utf-8"), vplans, ok_bytes,
                                    deny_set, int(deadline * 1e9)):
            self._count(dyn_registered=1,
                        dyn_register_ns=time.perf_counter_ns() - t0)

    def _warm_launch(self, rec: _SnapRec) -> None:
        """One launch of the mega-kernel on 16 zero rows of config 0 with
        this snapshot's params (its plain version on a CPU engine)."""
        if rec.sharded is not None:
            enc, _, _ = self._slot_batch(rec, 0, 0, zero=True)
            h = rec.sharded.dispatch_full(enc)
            h.wait()
            self._count(warm_launches=h.lane_calls)
            return
        a = rec.arrays[0]
        pad = min(16, self.max_batch)
        has_dfa = rec.params["dfa_tables"] is not None
        db = DeviceBatch(
            attrs_val=np.zeros_like(a["attrs_val"][:pad]),
            members_c=np.full_like(a["members"][:pad], PAD),
            cpu_dense=np.zeros(a["cpu_dense"][:pad].shape, dtype=bool),
            config_id=np.zeros((pad,), dtype=np.int32),
            attr_bytes=(np.zeros(a["attr_bytes"][:pad, :, :16].shape,
                                 dtype=np.uint8) if has_dfa else None),
            byte_ovf=(np.zeros(a["byte_ovf"][:pad].shape, dtype=bool)
                      if has_dfa else None),
            host_fallback=np.zeros((pad,), dtype=bool))
        h = pe.dispatch_lane(rec.params, db)
        h.wait()
        self._count(warm_launches=h.launches + h.plain_calls + h.lane_calls)

    # ------------------------------------------------------------------
    def _fold_fc_counts(self) -> None:
        """Fold C++-side direct decisions (identity-only OKs, credential
        denials) into the same per-authconfig Prometheus series the pipeline
        bumps (ref pkg/service/auth_pipeline.go:26-36)."""
        for ns, name, ok, missing, invalid in self._mod.fe_drain_fc_counts():
            metrics_mod.authconfig_total.labels(ns, name).inc(ok + missing + invalid)
            if ok:
                metrics_mod.authconfig_response_status.labels(ns, name, "OK").inc(ok)
            if missing or invalid:
                metrics_mod.authconfig_response_status.labels(
                    ns, name, "UNAUTHENTICATED").inc(missing + invalid)
        # duration + stage histograms drain on a coarser cadence
        now = time.monotonic()
        if now - self._last_hist_drain >= self.hist_drain_s:
            self._last_hist_drain = now
            self.drain_histograms()

    def drain_histograms(self) -> None:
        """Fold the C++-recorded duration/stage histograms into Prometheus:
        auth_server_authconfig_duration_seconds per authconfig and
        auth_server_frontend_stage_duration_seconds per on-box stage; raw
        stage counts accumulate in ``stage_totals``."""
        for ns, name, buckets, sum_ns in self._mod.fe_drain_durations():
            metrics_mod.observe_bucketed(
                metrics_mod.authconfig_duration.labels(ns, name),
                buckets, sum_ns / 1e9)
        stages = self._mod.fe_stage_hist()
        if not stages:
            return  # server already stopped
        bounds = stages["bounds_ns"]
        mids = [b / 2e9 if i == 0 else (bounds[i - 1] + b) / 2e9
                for i, b in enumerate(bounds)] + [bounds[-1] / 1e9]
        for stage in ("wait", "exec", "respond"):
            counts = stages[stage]
            acc = self.stage_totals.setdefault(stage, [0] * len(counts))
            for i, n in enumerate(counts):
                acc[i] += n
            # sum approximated from bucket midpoints (the series is for
            # shape/percentiles, not totals)
            est_sum = sum(n * mids[i] for i, n in enumerate(counts))
            metrics_mod.observe_bucketed(
                metrics_mod.frontend_stage_duration.labels(stage),
                counts, est_sum)
        self.stage_totals["bounds_ns"] = bounds

    def _dispatch_loop(self) -> None:
        mod = self._mod
        while self._running:
            kind, a, b, c = mod.fe_wait_batch(200)
            self._fold_fc_counts()
            if kind == EV_BATCH:
                try:
                    self._dispatch(int(a), int(b), int(c))
                except Exception as e:
                    log.exception("native batch dispatch failed")
                    self._native_batch_failed(int(a), int(b), int(c), 0, e)
            elif kind == EV_SNAP_RETIRED:
                # GIL-atomic pop, not under _lock: refresh holds _lock
                # across its warm launch
                self._snaps.pop(int(a), None)
            elif kind == EV_STOPPED:
                break

    def _dedup_plan(self, rec: _SnapRec, a: Dict[str, np.ndarray],
                    count: int, rows: np.ndarray):
        """Cache lookup + within-slot row collapse.  Keys are the raw
        encoded operand bytes of each row (exact: the kernel is a pure
        per-row function; the native path has no host-fallback rows),
        scoped by the config's cache token, so entries of configs a
        reconcile did not touch survive the swap.  Returns (cache_keys,
        eligible [count] bool, cached {row: value}, miss_rows,
        unique_rows, inverse, eligible_misses) — or None when both
        features are off."""
        cache = self._verdict_cache
        if not self.batch_dedup and cache is None:
            return None
        keys = row_key_bytes([a["config_id"], a.get("shard_of"),
                              a["attrs_val"], a["members"],
                              a["cpu_dense"], a["attr_bytes"], a["byte_ovf"]],
                             count)
        tok = rec.cache_tokens
        if tok is not None:
            ckeys = [(tok[rows[r]], keys[r]) for r in range(count)]
        else:
            ckeys = [(("native", rec.snap_id), keys[r]) for r in range(count)]
        eligible = (rec.cacheable[rows] if rec.cacheable is not None
                    else np.zeros((count,), dtype=bool))
        cached: Dict[int, Tuple[int, int]] = {}
        elig_miss = 0
        if cache is not None:
            miss_rows: List[int] = []
            for r in range(count):
                if eligible[r]:
                    v = cache.get(ckeys[r])
                    if v is not None:
                        cached[r] = v
                        continue
                    elig_miss += 1
                miss_rows.append(r)
        else:
            miss_rows = list(range(count))
        if self.batch_dedup:
            unique_rows, inverse = dedup_rows(keys, miss_rows)
        else:
            unique_rows, inverse = miss_rows, np.arange(len(miss_rows))
        return ckeys, eligible, cached, miss_rows, unique_rows, inverse, elig_miss

    def _slot_batch(self, rec: _SnapRec, slot: int, count: int,
                    unique_rows: Optional[List[int]] = None,
                    zero: bool = False) -> Tuple[Any, int, int]:
        """The DeviceBatch of one slot's rows (all, or the unique rows
        padded by repeating the first), at the staging's pad bucket and
        byte-width bucket: (batch, pad, eff).  A mesh record gives the
        sharded encoding ([B, S, ...], dp-aligned); ``zero`` one of 16
        zero rows (the swap's warm launch)."""
        if rec.sharded is not None:
            return self._sharded_slot_batch(rec, slot, count, unique_rows,
                                            zero)
        a = rec.arrays[slot]
        has_dfa = rec.params["dfa_tables"] is not None
        u = count if unique_rows is None else len(unique_rows)
        pad = min(bucket_pow2(u), self.max_batch)
        if unique_rows is None or u == count:
            def take(name):
                return a[name][:pad]
        else:
            idx = np.asarray(list(unique_rows) + [unique_rows[0]] * (pad - u))

            def take(name):
                return a[name][idx]
        eff = 0
        attr_bytes = byte_ovf = None
        if has_dfa:
            ab = take("attr_bytes")
            # the byte width bucket of the rows that count (NUL padding is
            # identity in every DFA, so trimming is exact)
            eff = _trim_bytes(ab[:u]).shape[-1]
            attr_bytes = np.ascontiguousarray(ab[..., :eff])
            byte_ovf = take("byte_ovf").view(bool)
        db = DeviceBatch(
            attrs_val=take("attrs_val"), members_c=take("members"),
            cpu_dense=take("cpu_dense").view(bool),
            config_id=take("config_id"), attr_bytes=attr_bytes,
            byte_ovf=byte_ovf, host_fallback=np.zeros((pad,), dtype=bool))
        return db, pad, eff

    def _sharded_slot_batch(self, rec: _SnapRec, slot: int, count: int,
                            unique_rows: Optional[List[int]], zero: bool):
        from ..parallel.sharded_eval import _ShardedEncoded

        sh = rec.sharded
        a = rec.arrays[slot]
        if zero:
            pad = sh._dp_pad(min(16, self.max_batch))

            def take(name):
                arr = a[name][:1]
                out = np.zeros((pad,) + arr.shape[1:], dtype=arr.dtype)
                if name == "members":
                    out[:] = PAD
                return out
            u = 0
        else:
            u = count if unique_rows is None else len(unique_rows)
            pad = sh._dp_pad(min(bucket_pow2(u), self.max_batch))
            if unique_rows is None or u == count:
                idx = np.asarray(list(range(u)) + [0] * (pad - u))
            else:
                idx = np.asarray(list(unique_rows)
                                 + [unique_rows[0]] * (pad - u))

            def take(name):
                return a[name][idx]
        eff = 0
        attr_bytes = byte_ovf = None
        if sh.has_dfa:
            ab = take("attr_bytes")
            eff = _trim_bytes(ab[:max(u, 1)]).shape[-1]
            attr_bytes = np.ascontiguousarray(ab[..., :eff])
            byte_ovf = take("byte_ovf").view(bool)
        enc = _ShardedEncoded(
            attrs_val=take("attrs_val"), members_c=take("members"),
            cpu_dense=take("cpu_dense").view(bool), attr_bytes=attr_bytes,
            byte_ovf=byte_ovf, shard_of=take("shard_of"),
            row_of=take("config_id"),
            host_fallback=np.zeros((pad,), dtype=bool))
        return enc, pad, eff

    def _dispatch(self, snap_id: int, slot: int, count: int,
                  attempt: int = 0) -> None:
        """Launch stage of one C++-encoded slot: answer cached rows,
        collapse the rest to unique rows and launch the mega-kernel ONCE
        on them (none at all when the cache answered every row), then park
        the in-flight slot on the readback queue.  ``attempt`` is the retry
        generation; an OPEN breaker keeps the slot off the card."""
        rec = self._snaps[snap_id]
        if not self.breaker.admit_device():
            self._count(breaker_open_batches=1)
            self._degrade_slot(rec, snap_id, slot, count)
            return
        a = rec.arrays[slot]
        # copy attribution rows BEFORE the slot can complete: once
        # fe_complete_batch runs, the C++ encoder may refill them
        rows = rec.slot_rows(a, count)
        fan = self._dedup_plan(rec, a, count, rows)
        lane = "native" if rec.sharded is None else "mesh"
        unique_rows = fan[4] if fan is not None else None
        u = len(unique_rows) if unique_rows is not None else count
        t0 = time.monotonic()
        t0_ns = time.time_ns()
        dedup_n = (len(fan[3]) - u) if fan is not None else 0
        cache_n = len(fan[2]) if fan is not None else 0
        if u == 0:
            # every row cache-resolved: complete through the readback queue
            # with no device work at all
            pad = eff = 0
            handle = None
            LEDGER.observe(lane, rows=count,
                           dedup_avoided_rows=dedup_n,
                           cache_avoided_rows=cache_n)
            self._count(batches=1, cached_batches=1, rows=count,
                        cache_rows=cache_n, dedup_rows=dedup_n)
        else:
            db, pad, eff = self._slot_batch(rec, slot, count, unique_rows)
            if faults.ACTIVE:
                faults.FAULTS.check("h2d", "native")
                faults.FAULTS.check("kernel", "native")
            if rec.sharded is not None:
                # one mesh dispatch per slot: the encoder laid each request
                # into its owning shard's slice; the shard-step's launch is
                # counted on the mesh lane at the dispatch
                launched = rec.sharded.dispatch_full(db)
                h2d = rec.sharded._encoded_h2d_bytes(db)
                n_launch = 0
            else:
                launched = pe.dispatch_fused(rec.params, db)
                h2d = sum(x.nbytes for x in (db.attrs_val, db.members_c,
                                             db.cpu_dense, db.config_id,
                                             db.attr_bytes, db.byte_ovf)
                          if x is not None)
                n_launch = (launched.launches + launched.plain_calls
                            + getattr(launched, "lane_calls", 0))
            handle = (faults.FAULTS.wrap_handle(launched, "native")
                      if faults.ACTIVE else launched)
            # one device computation per slot with a device row: the
            # kernel's launch on a card, its plain version's call on the CPU
            LEDGER.observe(
                lane, rows=count, device_rows=u,
                launches=n_launch,
                h2d_bytes=h2d, d2h_bytes=launched.nbytes, pad_rows=pad,
                dedup_avoided_rows=dedup_n, cache_avoided_rows=cache_n)
            self._count(batches=1, launches=launched.launches,
                        plain_calls=launched.plain_calls, rows=count,
                        device_rows=u, pad_rows=pad, h2d_bytes=h2d,
                        d2h_bytes=launched.nbytes, cache_rows=cache_n,
                        dedup_rows=dedup_n)
        with self._rb_lock:
            self._rb_inflight += 1
            if self._rb_inflight > self.rb_inflight_peak:
                self.rb_inflight_peak = self._rb_inflight
            inflight = self._rb_inflight
        self._g_native_inflight.set(inflight)
        self._rb_q.append((rec, snap_id, slot, count, pad, eff, rows,
                           handle, t0, t0_ns, fan, attempt))
        self._rb_evt.set()

    def _readback_loop(self) -> None:
        """Completion stage: finalize in-flight slots as their readbacks
        arrive (is_ready polling — a slow slot never convoys a fast one)."""
        pending: List[tuple] = []
        while True:
            while self._rb_q:
                try:
                    pending.append(self._rb_q.popleft())
                except IndexError:
                    break
            if not pending:
                if not self._running:
                    return
                self._rb_evt.wait(0.2)
                self._rb_evt.clear()
                continue
            progressed = False
            for item in list(pending):
                handle = item[7]
                try:
                    ready = handle is None or bool(handle.is_ready())
                except Exception:
                    ready = True  # surface the real error in completion
                if not ready:
                    t = self.device_timeout_s
                    if t and time.monotonic() - item[8] > t:
                        # watchdog: abandon the handle, count a breaker
                        # failure, feed the slot the retry/end path
                        pending.remove(item)
                        progressed = True
                        self._count(watchdog_timeouts=1)
                        metrics_mod.watchdog_timeouts.labels("native").inc()
                        RECORDER.record("watchdog-timeout", lane="native",
                                        detail={"slot": item[2],
                                                "requests": item[3],
                                                "attempt": item[11]})
                        release = getattr(handle, "release", None)
                        if release is not None:
                            release()
                        self._fail_async(item[1], item[2], item[3], item[11],
                                         TimeoutError("device readback "
                                                      "watchdog timeout"))
                        self._rb_done()
                    continue
                pending.remove(item)
                progressed = True
                try:
                    self._complete_device_batch(*item)
                except Exception as e:
                    log.exception("native batch completion failed")
                    self._fail_async(item[1], item[2], item[3], item[11], e)
                finally:
                    self._rb_done()
            if not progressed:
                # sub-ms poll while results ride the link
                self._rb_evt.wait(0.0005)
                self._rb_evt.clear()

    def _rb_done(self) -> None:
        with self._rb_lock:
            self._rb_inflight -= 1
            inflight = self._rb_inflight
        self._g_native_inflight.set(inflight)

    def _codes(self, rec: _SnapRec, rows: np.ndarray, cols: np.ndarray,
               E: int) -> Tuple[np.ndarray, np.ndarray]:
        """(verdict bytes, heat-map firing columns) of unpacked readback
        columns [n, 1 + 2E]: an allowed row answers V_ALLOW, a denied row
        V_COL0 + the first failing column in its config's priority order
        (the denial the pipeline would attribute)."""
        rule = cols[:, 1:1 + E]
        skipped = cols[:, 1 + E:1 + 2 * E]
        firing = firing_columns(rule, skipped)
        fired = ~skipped & ~rule
        rank = np.where(fired, rec.col_rank[rows][:, :E], np.int16(32767))
        deny_col = rank.argmin(axis=1)
        codes = np.where(cols[:, 0], V_ALLOW,
                         V_COL0 + np.minimum(deny_col, MAX_DENY_COLS - 1))
        return codes.astype(np.uint8), firing

    def _complete_device_batch(self, rec: _SnapRec, snap_id: int, slot: int,
                               count: int, pad: int, eff: int,
                               rows: np.ndarray, handle, t0: float,
                               t0_ns: int, fan=None, attempt: int = 0) -> None:
        if self._fe_stopped:
            # the drain deadline expired with this slot on the wire and
            # fe_stop has run: completing into the torn-down C++ server
            # would be a native use-after-stop
            return
        if faults.ACTIVE:
            faults.FAULTS.check("readback", "native")
        packed = handle.wait() if handle is not None else None
        if handle is not None:
            self.breaker.record_success()
        else:
            # a cache-only slot proves nothing about the card
            self.breaker.release_probe()
        dispatch_s = time.monotonic() - t0
        E = int(rec.policy.eval_rule.shape[1])
        W = packed_width(1 + 2 * E)
        if packed is not None and (packed.ndim != 2 or packed.shape[1] != W
                                   or packed.shape[0] < 1):
            raise RuntimeError(f"readback is {packed.shape}, not [pad, {W}]")
        code = np.zeros((count,), dtype=np.uint8)
        firing = np.full((count,), -1, dtype=np.int32)
        if fan is None:
            cols = unpack_verdicts(packed[:count], 1 + 2 * E)
            code[:], firing[:] = self._codes(rec, rows, cols, E)
            u = count
            cached = {}
        else:
            ckeys, eligible, cached, miss_rows, unique_rows, inverse, \
                elig_miss_n = fan
            u = len(unique_rows)
            if u:
                cols = unpack_verdicts(packed[:u], 1 + 2 * E)
                u_code, u_fire = self._codes(rec, rows[unique_rows], cols, E)
                mr = np.asarray(miss_rows)
                code[mr] = u_code[inverse]
                firing[mr] = u_fire[inverse]
            for r, (c, f) in cached.items():
                code[r] = c
                firing[r] = f
        code = np.ascontiguousarray(code)
        self._mod.fe_complete_batch(snap_id, slot, code.ctypes.data)
        # the slot is COMPLETED from here on: an exception below must not
        # reach the failure path, which would complete the same slot twice
        try:
            evict_d = 0
            cache = self._verdict_cache
            if fan is not None and cache is not None:
                evict0 = cache.evictions
                for r in fan[4]:  # unique rows: freshly evaluated
                    if fan[1][r]:
                        cache.put(fan[0][r], (int(code[r]), int(firing[r])))
                evict_d = cache.evictions - evict0
            if fan is not None:
                metrics_mod.observe_dedup("native", count, u, len(cached),
                                          fan[6], evict_d)
            self._post_complete_telemetry(rec, count, pad, eff, rows, code,
                                          dispatch_s, t0_ns, device_rows=u,
                                          firing=firing)
        except Exception:
            log.exception("post-completion telemetry failed")

    def _fail_async(self, snap_id: int, slot: int, count: int,
                    attempt: int, exc: Exception) -> None:
        """Hand a failed slot to its own worker thread: the retry must not
        stall the readback thread that completes every other slot.  At
        most one live worker per C++ slot (a slot cannot fail again until
        fe_complete_batch refills it)."""
        with self._rb_lock:
            self._fail_live += 1

        def run():
            try:
                self._native_batch_failed(snap_id, slot, count, attempt, exc)
            finally:
                with self._rb_lock:
                    self._fail_live -= 1

        threading.Thread(target=run, name="atpu-fe-failure",
                         daemon=True).start()

    def _native_batch_failed(self, snap_id: int, slot: int, count: int,
                             attempt: int, exc: Exception) -> None:
        """One slot failed (launch, readback, or watchdog): count a breaker
        failure, retry ONCE on a fresh dispatch from the same slot (the C++
        operands are intact until fe_complete_batch), then end the slot
        undecided (``_degrade_slot``).  Never raises."""
        try:
            self.breaker.record_failure()
            rec = self._snaps.get(snap_id)
            if attempt == 0 and rec is not None:
                metrics_mod.batch_retries.labels("native").inc()
                self._count(retries=1)
                log.warning("native batch (slot %d, %d requests) failed "
                            "(%r): retrying once on a fresh dispatch",
                            slot, count, exc)
                try:
                    self._dispatch(snap_id, slot, count, attempt=1)
                    return
                except Exception as e2:
                    log.exception("native batch retry dispatch failed")
                    self.breaker.record_failure()
                    exc = e2
            self._degrade_slot(rec, snap_id, slot, count, exc=exc)
        except Exception:
            log.exception("native batch failure handling failed")

    def _degrade_slot(self, rec: Optional[_SnapRec], snap_id: int, slot: int,
                      count: int, exc: Optional[Exception] = None) -> None:
        """End a slot the card did not decide.  On a card engine every row
        answers UNAVAILABLE: the port serves no verdict its kernel did not
        compute.  On a CPU engine the slot's encoded operands are
        re-decided by the kernel's plain version (the reference's
        CPU-backend degrade), counted as degraded; a row it cannot decide
        answers UNAVAILABLE."""
        if rec is None:
            # the C++ side already retired this snapshot: its slots are
            # gone — completing into it would be a use-after-retire
            log.warning("native batch failure for retired snapshot %d "
                        "(slot %d, %d requests): dropped", snap_id, slot,
                        count)
            return
        code: Optional[np.ndarray] = None
        rows = rec.slot_rows(rec.arrays[slot], count)
        firing = None
        if self.host_degrade:
            try:
                code, firing = self._host_eval(rec, slot, count, rows)
                LEDGER.observe("host", rows=count)
            except Exception:
                log.exception("native host degrade failed (UNAVAILABLE)")
                code = None
        if code is not None:
            metrics_mod.degraded_decisions.labels("native").inc(count)
            self._count(degraded_rows=count)
            if exc is not None:
                log.warning("native batch (slot %d, %d requests) re-decided "
                            "on the host after device failure (%r)",
                            slot, count, exc)
        else:
            code = np.full((count,), V_UNAVAILABLE, dtype=np.uint8)
            self._count(unavailable_rows=count)
        if not self._fe_stopped:
            self._mod.fe_complete_batch(snap_id, slot,
                                        np.ascontiguousarray(code).ctypes.data)
        if firing is not None and rec.heat is not None:
            try:
                prov_mod.fold_and_sample(rec.heat, rows, firing, count,
                                         lane="native",
                                         generation=rec.snap_id)
                # a degraded slot still counts against its tenants
                ten = self.tenancy
                if ten is not None and ten.enabled:
                    ten.fold(rec.heat, rows, firing=firing, lane="native")
            except Exception:
                log.exception("degrade provenance fold failed")

    def _host_eval(self, rec: _SnapRec, slot: int, count: int,
                   rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """The kernel's plain version on one slot's encoded operands (a CPU
        engine's params only) → (verdict bytes, firing columns)."""
        if rec.sharded is not None:
            # as the reference's: a mesh-sharded corpus has no host lane
            # here, its undecided rows answer UNAVAILABLE
            raise RuntimeError("no host degrade for a mesh-sharded corpus")
        if rec.params["leaf_op"].device.type != "cpu":
            raise RuntimeError("the host degrade runs on a CPU engine only")
        db, _, _ = self._slot_batch(rec, slot, count)
        packed = np.asarray(pe.dispatch_lane(rec.params, db))
        E = int(rec.policy.eval_rule.shape[1])
        cols = unpack_verdicts(packed[:count], 1 + 2 * E)
        return self._codes(rec, rows, cols, E)

    def _post_complete_telemetry(self, rec: _SnapRec, count: int, pad: int,
                                 eff: int, rows: np.ndarray,
                                 code: np.ndarray, dispatch_s: float,
                                 t0_ns: int, device_rows: int,
                                 firing: Optional[np.ndarray] = None) -> None:
        """Per-slot telemetry after completion (responses are already on
        their way): the rule heat map, the tenant plane's counters, the
        SLO, the batch series, the DeviceBatch span and the per-authconfig
        counters."""
        heat = rec.heat
        if heat is not None and firing is not None and count:
            prov_mod.fold_and_sample(heat, rows, firing, count,
                                     lane="native",
                                     latency_ms=dispatch_s * 1e3,
                                     generation=rec.snap_id)
            # during an engine canary this lane serves the baseline (its
            # C++ snapshot rebuilds only at promotion or rollback), so its
            # attribution feeds the guard's baseline cohort
            if self.engine._canary is not None:
                self.engine.canary_observe_external(rows, firing, heat)
        ten = self.tenancy
        if ten is not None and ten.enabled and heat is not None and count:
            try:
                # waits=None: this lane's per-request queue waits are
                # C++-clocked, and the slot's round trip read as a queue
                # wait would latch every tenant overloaded on normal
                # device latency.  The SLO mask is the lane's SLI, the
                # slot's round trip, shared by every member
                slo_s = self.slo.slo_s if self.slo is not None else 0.0
                ten.fold(heat, rows, firing=firing,
                         bad_mask=(np.full(count, dispatch_s > slo_s)
                                   if slo_s else None),
                         lane="native")
            except Exception:
                log.exception("tenant fold failed (telemetry only)")
        if self.slo is not None and count:
            # the native SLI is the slot's on-box round trip (per-request
            # waits are C++-clocked): every member shares it
            n_bad = count if dispatch_s > self.slo.slo_s else 0
            self.slo.observe(count, n_bad)
        metrics_mod.observe_batch("native", count, pad, None, dispatch_s,
                                  device_rows=device_rows)
        metrics_mod.observe_pipeline_stage("native", "device", dispatch_s)
        if tracing_mod.tracing_active():
            tracing_mod.export_device_batch_span(count, pad, eff, [],
                                                 t0_ns, dispatch_s)
        allowed = (code == V_ALLOW).astype(np.int64)
        n_per = np.bincount(rows)
        ok_per = np.bincount(rows, weights=allowed).astype(np.int64)
        for f in np.nonzero(n_per)[0]:
            n, n_ok = int(n_per[f]), int(ok_per[f])
            ns, name = rec.row_labels.get(int(f), ("", ""))
            if int(f) in rec.hybrid_rows:
                # kernel-allowed hybrid requests continue into the
                # pipeline, which observes them itself — only the native
                # denials are final here
                n, n_ok = n - n_ok, 0
                if not n:
                    continue
            metrics_mod.authconfig_total.labels(ns, name).inc(n)
            if n_ok:
                metrics_mod.authconfig_response_status.labels(
                    ns, name, "OK").inc(n_ok)
            if n - n_ok:
                metrics_mod.authconfig_response_status.labels(
                    ns, name, "PERMISSION_DENIED").inc(n - n_ok)

    # ------------------------------------------------------------------
    def _completer_loop(self) -> None:
        """Drain buffered slow-lane responses into C++ in batches.  Runs
        until stop() AND the buffer is flushed."""
        mod = self._mod
        buf = self._done_buf
        evt = self._done_evt
        while True:
            if not buf:
                evt.wait(0.2)
                evt.clear()
            items = []
            while buf and len(items) < 1024:
                try:
                    items.append(buf.popleft())
                except IndexError:
                    break
            if items:
                if self._fe_stopped:
                    return
                try:
                    mod.fe_complete_slow_many(items)
                except Exception:
                    log.exception("batch completion failed")
            elif not self._running:
                return

    # ------------------------------------------------------------------
    def _slow_loop(self) -> None:
        """The slow lane: an asyncio loop of its own takes raw requests
        from the C++ queue and answers each through ``engine.check`` (the
        grpc.aio server's flow), whose ``after`` hook makes the
        verified-credential registration, which lands before the answer
        does."""
        from ..utils.tracing import RequestSpan

        mod = self._mod
        engine = self.engine
        done_buf = self._done_buf
        done_evt = self._done_evt

        def complete(req_id: int, payload: bytes, status: int) -> None:
            done_buf.append((req_id, payload, status))
            done_evt.set()

        overload_bytes = self._result_bytes(AuthResult(
            code=RESOURCE_EXHAUSTED,
            message="server overloaded: slow lane shedding"))

        async def handle(req_id: int, raw: bytes) -> None:
            # CoDel admission: while the estimated standing wait stays over
            # target for a full interval, paced arrivals answer typed
            # RESOURCE_EXHAUSTED before any parse/pipeline work
            if self.admission.drop_now():
                self.admission.count_reject("overload")
                complete(req_id, overload_bytes, 0)
                return
            try:
                model = request_model_from_proto(
                    wire.decode_check_request(raw))
                if model is None:
                    result = AuthResult(code=INVALID_ARGUMENT,
                                        message="Invalid request")
                else:
                    span = RequestSpan.from_headers(model.http.headers,
                                                    model.http.id)
                    # the snapshot BEFORE verification: a JWKS rotation
                    # swapping it mid-run drops the registration
                    rec = self._cur_rec

                    def register(entry, pipeline) -> None:
                        try:
                            self._register_dyn(rec, entry, pipeline, model)
                        except Exception:
                            log.exception("dyn registration failed")

                    try:
                        result = await engine.check(model, span=span,
                                                    after=register)
                    finally:
                        span.end()
                complete(req_id, self._result_bytes(result), 0)
            except Exception:
                log.exception("slow-lane request failed")
                complete(req_id, b"", 13)  # INTERNAL

        async def main() -> None:
            # continuous admission, not batch-gather convoys: a straggler
            # must not block unrelated requests queued behind it
            loop = asyncio.get_running_loop()
            sem = asyncio.Semaphore(2048)
            tasks: set = set()  # strong refs: the loop holds tasks weakly

            def _done(t):
                tasks.discard(t)
                sem.release()

            while self._running:
                batch = await loop.run_in_executor(None, mod.fe_take_slow,
                                                   200, 256)
                for i, raw in batch:
                    await sem.acquire()
                    t = loop.create_task(handle(i, raw))
                    tasks.add(t)
                    t.add_done_callback(_done)
            # every request taken from the C++ queue completes before the
            # loop closes (else its client hangs to its gRPC deadline)
            if tasks:
                await asyncio.gather(*tuple(tasks), return_exceptions=True)

        asyncio.run(main())
