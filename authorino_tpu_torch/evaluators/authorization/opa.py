"""OPA/Rego authorization (semantics: ref
pkg/evaluators/authorization/opa.go:28-274): user rego is wrapped with
``default allow = false``, precompiled at reconcile time, evaluated against
the Authorization JSON as ``input``; optional allValues returns every rule
binding; optional external registry download with TTL refresh worker
(over the port's standard-library HTTP client)."""

from __future__ import annotations

import hashlib
import json
from typing import Any, Optional

from ...utils import http as http_util
from ...utils.workers import Worker
from ..base import EvaluationError
from . import rego

__all__ = ["OPA", "OPAExternalSource"]


class OPAExternalSource:
    """(ref :208-241: downloadRegoDataFromUrl + optional sharedSecret +
    TTL refresher)"""

    def __init__(self, endpoint: str, shared_secret: str = "", ttl_s: int = 0):
        self.endpoint = endpoint
        self.shared_secret = shared_secret
        self.ttl_s = ttl_s

    async def download(self) -> str:
        headers = {}
        if self.shared_secret:
            headers["Authorization"] = f"Bearer {self.shared_secret}"
        resp = await http_util.request("GET", self.endpoint, headers=headers)
        body = resp.text()
        if resp.status != 200:
            raise EvaluationError(f"failed to download rego policy: {resp.status}")
        # the registry may return JSON {"result": {"raw": "<rego>"}} (OPA API)
        try:
            payload = json.loads(body)
            if isinstance(payload, dict):
                raw = payload.get("result", {})
                if isinstance(raw, dict) and "raw" in raw:
                    return raw["raw"]
        except Exception:
            pass
        return body


class OPA:
    def __init__(
        self,
        name: str,
        inline_rego: str = "",
        external_source: Optional[OPAExternalSource] = None,
        all_values: bool = False,
        data: Optional[dict] = None,
    ):
        """``data`` is the external document tree served under ``data.*``
        (the embedded-OPA equivalent of loaded data documents; the module's
        own package also mounts at data.<package> as a virtual doc)."""
        self.name = name
        self.all_values = all_values
        self.external_source = external_source
        self.data = data
        # the module's package: data.<policy_uid> references resolve the
        # same as in the reference, which names packages the same way
        self.policy_uid = hashlib.sha256(name.encode()).hexdigest()[:16]
        self._module: Optional[rego.RegoModule] = None
        self._refresher: Optional[Worker] = None
        # set by translate when lowered_verdict() was compiled into the
        # config's ConfigRules at this slot: the mega-kernel decides the
        # same verdict in the batch that decides the config's patterns
        self.kernel_slot: Optional[int] = None
        if inline_rego:
            self.precompile(inline_rego)

    def lowered_verdict(self):
        """The policy's ``allow`` as a compiled pattern Expression when it
        falls in the provably-equivalent subset (see rego_lower), else
        None.  Only INLINE policies qualify: an external policy hot-swaps
        on TTL refresh (ref :118-139) without a reconcile, which would
        leave stale lowered rules in the compiled corpus."""
        if self.external_source is not None or self._module is None:
            return None
        from .rego_lower import lower_verdict

        return lower_verdict(self._module)

    def precompile(self, rego_src: str) -> None:
        """(ref :141-176: policy template + PrepareForEval; swap-on-refresh
        ref :118-139)"""
        wrapped = f"default allow = false\n{rego_src}"
        try:
            module = rego.compile_module(wrapped, package=self.policy_uid)
        except rego.RegoError as e:
            raise ValueError(f"invalid rego policy: {e}")
        self._module = module  # atomic swap

    async def load_external(self) -> None:
        if self.external_source is None:
            return
        src = await self.external_source.download()
        self.precompile(src)
        if self.external_source.ttl_s and self._refresher is None:
            self._refresher = Worker(self.external_source.ttl_s, self._refresh).start()

    async def _refresh(self) -> None:
        src = await self.external_source.download()
        try:
            self.precompile(src)
        except ValueError:
            pass  # keep serving the previous policy on bad refresh

    async def call(self, pipeline) -> Any:
        if self._module is None:
            raise EvaluationError("opa policy not compiled")
        try:
            results = self._module.evaluate(pipeline.authorization_json(), data=self.data)
        except rego.RegoError as e:
            raise EvaluationError(f"failed to evaluate policy: {e}")
        if not results.get("allow"):
            raise EvaluationError("Unauthorized")
        if self.all_values:
            return results
        return True

    async def clean(self) -> None:
        if self._refresher is not None:
            await self._refresher.stop()
            self._refresher = None
