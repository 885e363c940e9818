"""Pattern-matching authorization — the north-star evaluator.

The evaluator's verdict comes from the micro-batching policy engine that
evaluates the whole corpus in one kernel launch per batch
(runtime/engine.py), through the batched provider the engine hands out at
translate time (``engine.provider_for``).  There is no host-side evaluation
beside it: the engine refuses a snapshot whose pattern evaluators are not
bound to it (plugin interface, ref: pkg/auth/auth.go:26-28; leaf semantics
ref: pkg/evaluators/authorization/json.go:11-27).

Decision provenance: a denial raises an EvaluationError carrying
a ``provenance`` attribute — which rule fired — that the pipeline forwards
into Envoy ``dynamic_metadata``; the reason STRING only names the rule
behind the ``--expose-deny-reason`` privacy knob
(runtime/provenance.py EXPOSE_DENY_REASON), staying the reference's generic
"Unauthorized" otherwise.
"""

from __future__ import annotations

from typing import Any, Awaitable, Callable, Optional

from ...expressions.ast import Expression
from ..base import EvaluationError, SkippedError

# a BatchedVerdictProvider resolves (pipeline, evaluator_slot) →
# (allowed, skipped); skipped means the compiled conditions gated it off
BatchedVerdictProvider = Callable[[Any, int], "Awaitable[tuple[bool, bool]]"]

# an Attributor resolves (evaluator slot, the pinned snapshot that evaluated
# the request or None) → provenance dict (authconfig, rule_index, rule
# source) for a denial, or None (engine.attribution_for)
Attributor = Callable[[int, Any], Optional[dict]]


class PatternMatching:
    def __init__(
        self,
        rules: Expression,
        batched_provider: BatchedVerdictProvider,
        evaluator_slot: int,
        attributor: Attributor,
    ):
        self.rules = rules
        self.batched_provider = batched_provider
        self.evaluator_slot = evaluator_slot
        self.attributor = attributor

    def _deny(self, pipeline=None) -> EvaluationError:
        from ...runtime import provenance as prov_mod

        # the provider pinned the snapshot that evaluated this request on
        # the pipeline: attribution must read THAT corpus, not one a
        # reconcile swapped in since the verdict
        snap = getattr(pipeline, "eval_snapshot", None)
        try:
            prov = self.attributor(self.evaluator_slot, snap)
        except Exception:
            prov = None
        if prov is None:
            # no compiled snapshot covers the config: the evaluator still
            # knows its own rule source — attribution never goes dark
            prov = prov_mod.deny_provenance(
                "", self.evaluator_slot, str(self.rules), lane="pipeline")
        err = EvaluationError(prov_mod.deny_reason(prov))
        err.provenance = prov
        return err

    async def call(self, pipeline) -> Any:
        allowed, skipped = await self.batched_provider(pipeline, self.evaluator_slot)
        if skipped:
            raise SkippedError()
        if not allowed:
            raise self._deny(pipeline)
        return True
