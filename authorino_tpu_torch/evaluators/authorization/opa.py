"""OPA/Rego authorization (semantics: ref
pkg/evaluators/authorization/opa.go:28-274): user rego is wrapped with
``default allow = false``, precompiled at reconcile time, evaluated against
the Authorization JSON as ``input``; optional allValues returns every rule
binding.

The port holds inline policies only: the external registry download (and
its TTL refresh) needs an HTTP client, and translate refuses
``opa.externalPolicy`` as not yet in the port."""

from __future__ import annotations

import hashlib
from typing import Any, Optional

from ..base import EvaluationError
from . import rego

__all__ = ["OPA"]


class OPA:
    def __init__(
        self,
        name: str,
        inline_rego: str = "",
        all_values: bool = False,
        data: Optional[dict] = None,
    ):
        """``data`` is the external document tree served under ``data.*``
        (the embedded-OPA equivalent of loaded data documents; the module's
        own package also mounts at data.<package> as a virtual doc)."""
        self.name = name
        self.all_values = all_values
        self.data = data
        # the module's package: data.<policy_uid> references resolve the
        # same as in the reference, which names packages the same way
        self.policy_uid = hashlib.sha256(name.encode()).hexdigest()[:16]
        self._module: Optional[rego.RegoModule] = None
        # set by translate when lowered_verdict() was compiled into the
        # config's ConfigRules at this slot: the mega-kernel decides the
        # same verdict in the batch that decides the config's patterns
        self.kernel_slot: Optional[int] = None
        if inline_rego:
            self.precompile(inline_rego)

    def lowered_verdict(self):
        """The policy's ``allow`` as a compiled pattern Expression when it
        falls in the provably-equivalent subset (see rego_lower), else
        None."""
        if self._module is None:
            return None
        from .rego_lower import lower_verdict

        return lower_verdict(self._module)

    def precompile(self, rego_src: str) -> None:
        """(ref :141-176: policy template + PrepareForEval)"""
        wrapped = f"default allow = false\n{rego_src}"
        try:
            module = rego.compile_module(wrapped, package=self.policy_uid)
        except rego.RegoError as e:
            raise ValueError(f"invalid rego policy: {e}")
        self._module = module

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
