"""The 5-phase auth pipeline: identity → metadata → authorization →
response → callbacks, with per-priority concurrent groups and one/all/any
short-circuit semantics (contract: ref pkg/service/auth_pipeline.go:451-502,
150-201, 203-376).

asyncio translation of the reference's goroutine fan-out:
  - identity: within a priority bucket, all configs race; first success
    cancels the rest (evaluateOneAuthConfig, ref :166-170); total failure →
    UNAUTHENTICATED + WWW-Authenticate challenges + denyWith
  - metadata/callbacks: fire-all, failures tolerated (evaluateAnyAuthConfig)
  - authorization/response: all evaluated, authorization cancels on first
    denial → PERMISSION_DENIED (evaluateAllAuthConfigs)

Difference from Authorino (the Go "ref"): the Authorization JSON is one live
dict mutated as phases complete — Authorino re-marshals the whole document
on every evaluator read (ref :542-579), its dominant pipeline cost."""

from __future__ import annotations

import asyncio
import contextlib
import json as _json
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..authjson.value import stringify_json
from ..authjson.wellknown import CheckRequestModel, build_authorization_json
from ..evaluators.base import (
    DenyWithValues,
    EvaluationError,
    PhaseConfig,
    RuntimeAuthConfig,
    SkippedError,
    wrap_responses,
)
from ..utils import metrics as metrics_mod
from ..utils.rpc import (
    DEADLINE_EXCEEDED,
    OK,
    PERMISSION_DENIED,
    UNAUTHENTICATED,
    UNAVAILABLE,
    CheckAbort,
)

__all__ = ["AuthPipeline", "AuthResult"]


@dataclass
class AuthResult:
    """Result data for building the check response
    (ref: pkg/auth/auth.go:76-98)."""

    code: int = OK
    status: int = 0  # HTTP status override (denyWith.code)
    message: str = ""
    headers: List[Dict[str, str]] = field(default_factory=list)
    metadata: Dict[str, Any] = field(default_factory=dict)
    body: str = ""

    def success(self) -> bool:
        return self.code == OK


class _Skip(Exception):
    """Evaluator ignored: unmatched conditions or cancelled context."""


class AuthPipeline:
    def __init__(
        self,
        request: CheckRequestModel,
        config: RuntimeAuthConfig,
        timeout: Optional[float] = None,
        span=None,
        deadline: Optional[float] = None,
    ):
        self.request = request
        self.config = config
        self.timeout = timeout
        self.span = span  # RequestSpan for outbound W3C propagation
        # propagated Check() deadline (monotonic seconds): bounds the whole
        # pipeline below --timeout AND rides into the batch dispatcher,
        # where deadline-aware shedding fails doomed requests before encode
        self.deadline = deadline
        # deny provenance: which rule fired, captured from the
        # authorization failure and forwarded into AuthResult.metadata
        # (Envoy dynamic_metadata) — the reason string stays generic unless
        # --expose-deny-reason
        self.deny_provenance: Optional[Dict[str, Any]] = None
        # the engine snapshot that evaluated this request's batched
        # verdict (set by the engine's provider): deny attribution reads
        # this corpus, immune to a mid-request reconcile swap
        self.eval_snapshot: Any = None
        self.identity_results: Dict[Any, Any] = {}
        self.metadata_results: Dict[Any, Any] = {}
        self.authorization_results: Dict[Any, Any] = {}
        self.response_results: Dict[Any, Any] = {}
        self.callback_results: Dict[Any, Any] = {}
        # the live Authorization JSON — mutated in place as phases complete
        self._doc = build_authorization_json(request, {})

    # ---- authorization JSON ---------------------------------------------

    def authorization_json(self) -> Dict[str, Any]:
        return self._doc

    def resolved_identity(self) -> Tuple[Any, Any]:
        for conf, obj in self.identity_results.items():
            if obj is not None:
                return conf, obj
        return None, None

    def _sync_auth(self) -> None:
        auth = self._doc["auth"]
        _, auth["identity"] = self.resolved_identity()
        auth["metadata"] = {c.name: o for c, o in self.metadata_results.items()}
        auth["authorization"] = {c.name: o for c, o in self.authorization_results.items()}
        auth["response"] = {c.name: o for c, o in self.response_results.items()}
        if self.callback_results:
            auth["callbacks"] = {c.name: o for c, o in self.callback_results.items()}

    # ---- evaluator invocation -------------------------------------------

    async def _call_one(self, conf: PhaseConfig) -> Any:
        # per-evaluator (deep) metrics are gated by the evaluator's
        # `metrics: true` or the global flag (ref: pkg/metrics/metrics.go:86-96)
        deep = conf.metrics or metrics_mod.DEEP_METRICS_ENABLED
        labels = self.config.labels
        if deep:
            mlabels = (labels.get("namespace", ""), labels.get("name", ""), conf.type, conf.name)
            metrics_mod.evaluator_total.labels(*mlabels).inc()
        if conf.conditions is not None:
            try:
                matched = conf.conditions.matches(self._doc)
            except Exception:
                matched = False
            if not matched:
                if deep:
                    metrics_mod.evaluator_ignored.labels(*mlabels).inc()
                raise _Skip()
        timer = metrics_mod.evaluator_duration.labels(*mlabels).time() if deep else contextlib.nullcontext()
        with timer:
            try:
                return await conf.call(self)
            except SkippedError:
                if deep:
                    metrics_mod.evaluator_ignored.labels(*mlabels).inc()
                raise _Skip()
            except EvaluationError:
                if deep:
                    metrics_mod.evaluator_denied.labels(*mlabels).inc()
                raise
            except asyncio.CancelledError:
                if deep:
                    metrics_mod.evaluator_cancelled.labels(*mlabels).inc()
                raise

    async def _store_identity(self, conf, obj):
        """Success tail shared by the fast and racing identity paths:
        store, resolve extended properties, re-store — rolling back on
        extension failure (ref :222-241).  Returns (ok, error_message)."""
        self.identity_results[conf] = obj
        self._sync_auth()
        try:
            extended = await conf.resolve_extended_properties(self)
        except Exception as e:
            del self.identity_results[conf]
            self._sync_auth()
            return False, str(e)
        self.identity_results[conf] = extended
        self._sync_auth()
        return True, None

    @staticmethod
    async def _reap_tasks(tasks) -> None:
        """Cancel still-pending racers and AWAIT them out: a racer whose
        cleanup raises something other than CancelledError while unwinding
        would otherwise still log exception-never-retrieved; gather with
        return_exceptions consumes every outcome."""
        for t in tasks:
            if not t.done():
                t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)

    def _priority_buckets(self, configs: List[PhaseConfig]) -> List[List[PhaseConfig]]:
        # cached per phase list on the (immutable-after-translate) runtime
        # config — recomputing the grouping per request was measurable at
        # slow-lane rates
        cache = self.config._bucket_cache
        if cache is None:
            cache = self.config._bucket_cache = {}
        got = cache.get(id(configs))
        if got is not None:
            return got
        buckets: Dict[int, List[PhaseConfig]] = {}
        for c in configs:
            buckets.setdefault(c.priority, []).append(c)
        out = [buckets[p] for p in sorted(buckets)]
        cache[id(configs)] = out
        return out

    # ---- phases ----------------------------------------------------------

    async def _evaluate_identity(self) -> Optional[str]:
        """Returns None on success; an error message on failure
        (ref :203-258)."""
        configs = self.config.identity
        if not configs:
            return None  # no identity configs: nothing to verify
        count = len(configs)
        errors: Dict[str, str] = {}
        for bucket in self._priority_buckets(configs):
            if len(bucket) == 1:
                # single-evaluator bucket (the common case): direct await —
                # the task + asyncio.wait machinery only pays off when there
                # are siblings to race/cancel
                conf = bucket[0]
                try:
                    obj = await self._call_one(conf)
                except _Skip:
                    continue
                except (asyncio.CancelledError, CheckAbort):
                    raise
                except Exception as e:
                    if count == 1:
                        return str(e)
                    errors[conf.name] = str(e)
                    continue
                ok, err = await self._store_identity(conf, obj)
                if ok:
                    return None
                if count == 1:
                    return err
                errors[conf.name] = err
                continue
            tasks = {
                asyncio.ensure_future(self._call_one(conf)): conf for conf in bucket
            }
            pending = set(tasks)
            try:
                while pending:
                    done, pending = await asyncio.wait(
                        pending, return_when=asyncio.FIRST_COMPLETED
                    )
                    for t in done:
                        conf = tasks[t]
                        try:
                            obj = t.result()
                        except _Skip:
                            continue
                        except asyncio.CancelledError:
                            continue
                        except CheckAbort:
                            raise
                        except Exception as e:
                            if count == 1:
                                return str(e)
                            errors[conf.name] = str(e)
                            continue
                        ok, err = await self._store_identity(conf, obj)
                        if ok:
                            return None
                        if count == 1:
                            return err
                        errors[conf.name] = err
                        continue
            finally:
                await self._reap_tasks(tasks)
        return _json.dumps(errors, separators=(",", ":"), sort_keys=True)

    async def _evaluate_fire_all(self, configs: List[PhaseConfig], results: Dict[Any, Any]) -> None:
        """metadata/callbacks: failures tolerated (ref :260-285, :351-376)."""
        for bucket in self._priority_buckets(configs):
            if len(bucket) == 1:
                try:
                    results[bucket[0]] = await self._call_one(bucket[0])
                except asyncio.CancelledError:
                    raise
                except Exception:
                    pass  # tolerated
                self._sync_auth()
                continue
            outs = await asyncio.gather(
                *(self._call_one(c) for c in bucket), return_exceptions=True
            )
            for conf, out in zip(bucket, outs):
                if isinstance(out, BaseException):
                    continue
                results[conf] = out
            self._sync_auth()

    async def _evaluate_authorization(self) -> Optional[str]:
        """All must pass; cancel others on first denial (ref :287-322)."""
        for bucket in self._priority_buckets(self.config.authorization):
            if len(bucket) == 1:
                c = bucket[0]
                try:
                    obj = await self._call_one(c)
                except _Skip:
                    self._sync_auth()
                    continue
                except (asyncio.CancelledError, CheckAbort):
                    raise
                except Exception as e:
                    self._sync_auth()
                    self.deny_provenance = getattr(e, "provenance", None)
                    return str(e)
                self.authorization_results[c] = obj
                self._sync_auth()
                continue
            tasks = {asyncio.ensure_future(self._call_one(c)): c for c in bucket}
            pending = set(tasks)
            failure: Optional[str] = None
            try:
                while pending and failure is None:
                    done, pending = await asyncio.wait(
                        pending, return_when=asyncio.FIRST_COMPLETED
                    )
                    for t in done:
                        conf = tasks[t]
                        try:
                            obj = t.result()
                        except _Skip:
                            continue
                        except asyncio.CancelledError:
                            continue
                        except CheckAbort:
                            raise
                        except Exception as e:
                            failure = str(e)
                            self.deny_provenance = getattr(
                                e, "provenance", None)
                            break
                        self.authorization_results[conf] = obj
                self._sync_auth()
                if failure is not None:
                    return failure
            finally:
                await self._reap_tasks(tasks)
        return None

    async def _evaluate_response(self) -> Tuple[Dict[str, str], Dict[str, Any]]:
        for bucket in self._priority_buckets(self.config.response):
            if len(bucket) == 1:
                try:
                    self.response_results[bucket[0]] = await self._call_one(bucket[0])
                except asyncio.CancelledError:
                    raise
                except Exception:
                    pass  # tolerated like the gather path
                self._sync_auth()
                continue
            outs = await asyncio.gather(
                *(self._call_one(c) for c in bucket), return_exceptions=True
            )
            for conf, out in zip(bucket, outs):
                if isinstance(out, BaseException):
                    continue
                self.response_results[conf] = out
            self._sync_auth()
        return wrap_responses(self.response_results)

    # ---- entry -----------------------------------------------------------

    async def evaluate(self) -> AuthResult:
        """(ref :451-502)"""
        result = AuthResult(code=OK)

        # top-level conditions gate: skip whole pipeline → OK (ref :454-457)
        conds = self.config.conditions
        if conds is not None:
            try:
                if not conds.matches(self._doc):
                    return result
            except Exception:
                return result

        # bound label children cached on the runtime config: labels() does
        # validation + locking per call, a real cost at slow-lane rates
        mc = self.config._metric_children
        if mc is None:
            labels = self.config.labels
            alabels = (labels.get("namespace", ""), labels.get("name", ""))
            mc = self.config._metric_children = (
                metrics_mod.authconfig_total.labels(*alabels),
                metrics_mod.authconfig_duration.labels(*alabels),
                alabels, {})
        mc[0].inc()

        # effective bound = min(--timeout, time left on the propagated
        # Check() deadline); an already-expired deadline fails fast without
        # running a single phase
        timeout = self.timeout
        expired = False
        if self.deadline is not None:
            remaining = self.deadline - time.monotonic()
            if remaining <= 0:
                expired = True
            else:
                timeout = remaining if timeout is None else min(timeout, remaining)

        with mc[1].time():
            try:
                if expired:
                    raise asyncio.TimeoutError()
                if timeout:
                    # wait_for, not asyncio.timeout: this runs on 3.10
                    # (where asyncio.timeout does not exist — the old path
                    # raised AttributeError the first time --timeout fired)
                    result = await asyncio.wait_for(
                        self._evaluate_phases(), timeout)
                else:
                    result = await self._evaluate_phases()
            except (TimeoutError, asyncio.TimeoutError):
                # DEADLINE_EXCEEDED (rpc.py maps it to HTTP 504), NOT a
                # PERMISSION_DENIED masquerading as a timeout
                result = AuthResult(code=DEADLINE_EXCEEDED, message="context deadline exceeded")
            except CheckAbort as e:
                # typed fail-closed abort from the serving runtime (shed
                # deadline, drain admission stop, device path unavailable):
                # the code travels as-is, the message is operator-written
                result = AuthResult(code=e.code, message=e.message)

        code = _code_name(result.code)
        sc = mc[3].get(code)
        if sc is None:
            sc = mc[3][code] = metrics_mod.authconfig_response_status.labels(
                *mc[2], code)
        sc.inc()
        return result

    def _phase_span(self, name: str, configs) -> Any:
        """Child span for one pipeline phase — None whenever span export is
        off, the request is unsampled, or the phase has nothing to run, so
        untraced requests pay one attribute read per phase and nothing
        else."""
        span = self.span
        if span is None or not configs:
            return None
        child = getattr(span, "child", None)
        return child(name) if child is not None else None

    async def _evaluate_phases(self) -> AuthResult:
        # every phase span ends in a finally: a cancelled/raising phase
        # (request timeout, evaluator bug) must not leak a live SDK span
        result = AuthResult(code=OK)
        ph = self._phase_span("identity", self.config.identity)
        identity_err = None
        try:
            identity_err = await self._evaluate_identity()
        finally:
            if ph is not None:
                ph.end(error=identity_err)
        if identity_err is not None:
            result.code = UNAUTHENTICATED
            result.message = identity_err
            result.headers = self.config.challenge_headers()
            result = self._customize_deny_with(result, self.config.deny_with.unauthenticated)
        else:
            ph = self._phase_span("metadata", self.config.metadata)
            try:
                await self._evaluate_fire_all(self.config.metadata, self.metadata_results)
            finally:
                if ph is not None:
                    ph.end()
            ph = self._phase_span("authorization", self.config.authorization)
            authz_err = None
            try:
                authz_err = await self._evaluate_authorization()
            finally:
                if ph is not None:
                    ph.end(error=authz_err)
            if authz_err is not None:
                result.code = PERMISSION_DENIED
                result.message = authz_err
                if self.deny_provenance is not None:
                    # Envoy dynamic_metadata: the attributed rule always
                    # reaches the mesh (operator surface); the client-
                    # visible reason header is gated separately
                    result.metadata = {
                        "ext_authz_provenance": dict(self.deny_provenance)}
                result = self._customize_deny_with(result, self.config.deny_with.unauthorized)
            else:
                ph = self._phase_span("response", self.config.response)
                try:
                    headers, metadata = await self._evaluate_response()
                finally:
                    if ph is not None:
                        ph.end()
                result.headers = [headers]
                result.metadata = metadata
        # phase 5: callbacks always run (ref :492)
        await self._evaluate_fire_all(self.config.callbacks, self.callback_results)
        return result

    def _customize_deny_with(self, result: AuthResult, deny: Optional[DenyWithValues]) -> AuthResult:
        """(ref :581-608)"""
        if deny is None:
            return result
        if deny.code:
            result.status = deny.code
        doc = self._doc
        if deny.message is not None:
            result.message = stringify_json(deny.message.resolve_for(doc))
        if deny.body is not None:
            result.body = stringify_json(deny.body.resolve_for(doc))
        if deny.headers:
            result.headers = [
                {h.name: stringify_json(h.value.resolve_for(doc))} for h in deny.headers
            ]
        return result


_CODE_NAMES = {OK: "OK", UNAUTHENTICATED: "UNAUTHENTICATED",
               PERMISSION_DENIED: "PERMISSION_DENIED",
               DEADLINE_EXCEEDED: "DEADLINE_EXCEEDED",
               UNAVAILABLE: "UNAVAILABLE"}


def _code_name(code: int) -> str:
    return _CODE_NAMES.get(code, str(code))
