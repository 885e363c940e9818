"""Evaluator framework: phase wrapper configs + runtime AuthConfig model.

Structural equivalents of the reference's plugin interface
(ref: pkg/auth/auth.go:16-98) and phase wrappers
(ref: pkg/evaluators/identity.go, metadata.go, authorization.go, response.go,
callbacks.go, config.go).  Each phase wrapper decorates exactly one leaf
evaluator with name/type, priority, conditions, optional TTL cache and a
metrics gate; the runtime AuthConfig holds the per-phase wrapper lists plus
top-level conditions and denyWith customization.

Async-first: leaf evaluators implement ``async def call(pipeline)`` and
raise ``EvaluationError`` to deny — the asyncio translation of the
reference's goroutine fan-out with error returns."""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Protocol, Tuple

from ..authjson.value import JSONProperty, JSONValue, stringify_json
from ..expressions.ast import Expression
from .cache import EvaluatorCache
from .credentials import AuthCredentials

__all__ = [
    "EvaluationError", "Evaluator", "PhaseConfig",
    "IdentityConfig", "MetadataConfig", "AuthorizationConfig",
    "ResponseConfig", "CallbackConfig", "IdentityExtension",
    "RuntimeAuthConfig", "DenyWith", "DenyWithValues", "wrap_responses",
    "HTTP_HEADER_WRAPPER", "ENVOY_DYNAMIC_METADATA_WRAPPER",
]

HTTP_HEADER_WRAPPER = "httpHeader"
ENVOY_DYNAMIC_METADATA_WRAPPER = "envoyDynamicMetadata"


class EvaluationError(Exception):
    """Evaluator failure — denies in identity/authorization phases
    (the analog of the reference's error returns from Call())."""


class SkippedError(Exception):
    """Evaluator asked to be treated as ignored (e.g. a batched
    pattern evaluator whose compiled conditions didn't match — the kernel
    folds the conditions gate, the pipeline records 'ignored')."""


class Evaluator(Protocol):
    async def call(self, pipeline: "Any") -> Any: ...


@dataclass(eq=False)
class PhaseConfig:
    """Uniform decoration of a leaf evaluator
    (ref: pkg/evaluators/identity.go:29-105 and siblings)."""

    name: str
    evaluator: Optional[Evaluator] = None
    type: str = ""
    priority: int = 0
    conditions: Optional[Expression] = None
    cache: Optional[EvaluatorCache] = None
    metrics: bool = False

    phase = "unknown"

    async def call(self, pipeline) -> Any:
        ev = self.evaluator
        if ev is None:
            raise EvaluationError(f"invalid {self.phase} config")
        cache = self.cache
        cache_key = None
        if cache is not None:
            cache_key = cache.resolve_key_for(pipeline.authorization_json())
            cached = cache.get(cache_key)
            if cached is not None:
                return cached
        obj = await ev.call(pipeline)
        if cache is not None and cache_key is not None:
            cache.set(cache_key, obj)
        return obj

    async def clean(self) -> None:
        cleaner = getattr(self.evaluator, "clean", None)
        if cleaner is not None:
            result = cleaner()
            if asyncio.iscoroutine(result):
                await result
        if self.cache is not None:
            self.cache.shutdown()


@dataclass
class IdentityExtension:
    """Extended property merged into the resolved identity object
    (ref: pkg/evaluators/identity_extension.go)."""

    name: str
    value: JSONValue
    overwrite: bool = False

    def resolve_for(self, identity_obj: Dict[str, Any], auth_json: Any) -> Any:
        if not self.overwrite and self.name in identity_obj:
            return identity_obj[self.name]
        return self.value.resolve_for(auth_json)


@dataclass(eq=False)
class IdentityConfig(PhaseConfig):
    phase = "identity"
    credentials: AuthCredentials = field(default_factory=AuthCredentials)
    extended_properties: List[IdentityExtension] = field(default_factory=list)

    async def resolve_extended_properties(self, pipeline) -> Any:
        _, identity_obj = pipeline.resolved_identity()
        if not self.extended_properties:
            return identity_obj
        if not isinstance(identity_obj, dict):
            # mirror the marshal/unmarshal-to-map behavior for non-objects
            # (ref: pkg/evaluators/identity.go:190-195): non-map identities
            # cannot take extensions
            raise EvaluationError("cannot extend non-object identity")
        extended = dict(identity_obj)
        auth_json = pipeline.authorization_json()
        for prop in self.extended_properties:
            extended[prop.name] = prop.resolve_for(extended, auth_json)
        return extended


@dataclass(eq=False)
class MetadataConfig(PhaseConfig):
    phase = "metadata"


@dataclass(eq=False)
class AuthorizationConfig(PhaseConfig):
    phase = "authorization"


@dataclass(eq=False)
class ResponseConfig(PhaseConfig):
    phase = "response"
    wrapper: str = HTTP_HEADER_WRAPPER
    wrapper_key: str = ""

    def __post_init__(self):
        if not self.wrapper:
            self.wrapper = HTTP_HEADER_WRAPPER
        if not self.wrapper_key:
            self.wrapper_key = self.name


@dataclass(eq=False)
class CallbackConfig(PhaseConfig):
    phase = "callbacks"


def wrap_responses(
    responses: Dict[ResponseConfig, Any],
) -> Tuple[Dict[str, str], Dict[str, Any]]:
    """Split response-phase outputs into HTTP headers vs Envoy dynamic
    metadata (ref: pkg/evaluators/response.go:160-174)."""
    headers: Dict[str, str] = {}
    metadata: Dict[str, Any] = {}
    for config, obj in responses.items():
        if config.wrapper == HTTP_HEADER_WRAPPER:
            headers[config.wrapper_key] = obj if isinstance(obj, str) else stringify_json(obj)
        elif config.wrapper == ENVOY_DYNAMIC_METADATA_WRAPPER:
            metadata[config.wrapper_key] = obj
    return headers, metadata


@dataclass
class DenyWithValues:
    """Custom denial status/message/headers/body (ref: pkg/evaluators/config.go:75-80)."""

    code: int = 0
    message: Optional[JSONValue] = None
    headers: List[JSONProperty] = field(default_factory=list)
    body: Optional[JSONValue] = None


@dataclass
class DenyWith:
    unauthenticated: Optional[DenyWithValues] = None
    unauthorized: Optional[DenyWithValues] = None


@dataclass
class RuntimeAuthConfig:
    """Compiled runtime model of one AuthConfig
    (ref: pkg/evaluators/config.go:16-27)."""

    labels: Dict[str, str] = field(default_factory=dict)
    conditions: Optional[Expression] = None
    identity: List[IdentityConfig] = field(default_factory=list)
    metadata: List[MetadataConfig] = field(default_factory=list)
    authorization: List[AuthorizationConfig] = field(default_factory=list)
    response: List[ResponseConfig] = field(default_factory=list)
    callbacks: List[CallbackConfig] = field(default_factory=list)
    deny_with: DenyWith = field(default_factory=DenyWith)
    # hot-path caches, populated lazily by AuthPipeline (the runtime model
    # is immutable after translate — reconciles build NEW configs): bound
    # Prometheus label children and per-phase priority buckets.  Rebuilding
    # these per request was ~6% of the slow lane's budget.
    _metric_children: Any = field(default=None, init=False, repr=False,
                                  compare=False)
    _bucket_cache: Any = field(default=None, init=False, repr=False,
                               compare=False)

    def challenge_headers(self) -> List[Dict[str, str]]:
        """WWW-Authenticate challenges, one per identity config
        (ref: pkg/evaluators/config.go:29-40)."""
        out = []
        for idc in self.identity:
            challenge = f'{idc.credentials.key_selector} realm="{idc.name}"'
            out.append({"WWW-Authenticate": challenge})
        return out

    def all_configs(self) -> List[PhaseConfig]:
        return [*self.identity, *self.metadata, *self.authorization, *self.response, *self.callbacks]

    async def clean(self) -> None:
        """Stop background workers/caches of every evaluator
        (ref: pkg/evaluators/config.go:42-68)."""
        await asyncio.gather(*(c.clean() for c in self.all_configs()), return_exceptions=True)
