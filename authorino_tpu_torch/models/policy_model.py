"""PolicyModel: a compiled rule corpus plus its batched evaluation.

The analog of a forward pass is one micro-batched policy evaluation:
(requests × rules) integer compares + a boolean-circuit reduction →
per-request allow verdicts, here one launch of the fused mega-kernel
(``ops.fused_kernel``).  There is no gradient training in this domain.

Requests whose membership arrays overflow the compact payload (K elements)
are re-decided on the host by the expression oracle: ``host_results``
implements the reference semantics (errors ⇒ False at the root) and is also
the differential-test oracle for the kernel.
"""

from __future__ import annotations

import json
from typing import Any, List, Sequence, Tuple

import numpy as np

from ..compiler.compile import CompiledPolicy, ConfigRules, compile_corpus
from ..compiler.encode import encode_batch
from ..compiler.pack import DeviceBatch, pack_batch
from ..native import get_native_encoder
from ..ops.fused_kernel import prewarm_fused
from ..ops.operands import resolve_device, unpack_verdicts
from ..ops.pattern_eval import dispatch_fused, to_device

__all__ = ["PolicyModel", "host_results", "apply_host_fallback",
           "FALLBACK_COUNTS"]

# host-fallback rows re-decided by the oracle / denied past the cap
FALLBACK_COUNTS = {"decided": 0, "shed": 0}


def apply_host_fallback(decide, fb, own_rule, own_skipped, cap) -> None:
    """Re-decide up to ``cap`` membership-overflow rows via ``decide(r) ->
    (rule_row, skipped_row)``; rows beyond the cap are denied fail-closed
    (rule and skipped all False).  Meters
    auth_server_host_fallback_{total,shed_total}."""
    from ..utils import metrics as metrics_mod

    decided = fb if cap is None else fb[:cap]
    shed = fb[len(decided):]
    for r in decided:
        own_rule[r], own_skipped[r] = decide(int(r))
    for r in shed:
        own_rule[r] = False
        own_skipped[r] = False
    FALLBACK_COUNTS["decided"] += len(decided)
    FALLBACK_COUNTS["shed"] += len(shed)
    if len(fb):
        metrics_mod.host_fallback_total.inc(len(decided))
        if len(shed):
            metrics_mod.host_fallback_shed_total.inc(len(shed))


def host_results(
    policy: CompiledPolicy, doc: Any, row: int
) -> Tuple[bool, np.ndarray, np.ndarray]:
    """Exact host-side decision for one request via the expression oracle:
    (own verdict, per-evaluator rule results [E], skipped [E]) with the
    same padding/tail semantics as the kernel (padded columns read TRUE)."""
    E = policy.eval_rule.shape[1]
    rule_res = np.ones((E,), dtype=bool)       # padded cols: TRUE_SLOT
    skipped = np.zeros((E,), dtype=bool)
    for e, (cond, rule) in enumerate(policy.config_exprs[row]):
        if cond is not None:
            try:
                cond_ok = bool(cond.matches(doc))
            except Exception:
                cond_ok = False
            if not cond_ok:
                skipped[e] = True
                continue
        try:
            rule_res[e] = bool(rule.matches(doc))
        except Exception:
            rule_res[e] = False
    own = bool(np.all(skipped | rule_res))
    return own, rule_res, skipped


class PolicyModel:
    """Single-corpus model on one device (the CUDA card by default)."""

    def __init__(self, policy: CompiledPolicy, device=None):
        self.policy = policy
        self.device = resolve_device(device)
        self.params = to_device(policy, device=self.device)
        prewarm_fused(policy, self.params)

    @classmethod
    def from_configs(cls, configs: Sequence[ConfigRules], members_k: int = 16,
                     device=None) -> "PolicyModel":
        return cls(compile_corpus(configs, members_k=members_k), device=device)

    # ---- request path ----------------------------------------------------

    def encode(self, docs: Sequence[Any], config_rows: Sequence[int],
               batch_pad: int = 0) -> DeviceBatch:
        enc = encode_batch(self.policy, docs, config_rows, batch_pad=batch_pad)
        return pack_batch(self.policy, enc)

    def encode_json(self, parts: Sequence[bytes], config_rows: Sequence[int],
                    batch_pad: int = 0) -> DeviceBatch:
        """Encode from raw authorization-JSON bytes (one UTF-8 blob per
        request — what a wire frontend already holds), parsed by the native
        encoder with the interpreter lock released.  A corpus outside the
        native domain (or a batch the native path hands back) takes the
        Python encoder via ``json.loads``."""
        nat = get_native_encoder(self.policy)
        if nat is not None:
            enc = nat.encode_json_parts(parts, config_rows, batch_pad)
            if enc is not None:
                return pack_batch(self.policy, enc)
        return self.encode([json.loads(pt) for pt in parts], config_rows,
                           batch_pad)

    def apply(self, db: DeviceBatch
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One batch on the params' lane (one launch on the fused lane) →
        (own verdict [B], own rule [B, E], own skipped [B, E]) as numpy.
        Only each row's own config is returned, so there is no [B, G]
        verdict matrix."""
        E = int(self.policy.eval_rule.shape[1])
        cols = unpack_verdicts(np.asarray(dispatch_fused(self.params, db)),
                               1 + 2 * E)
        return cols[:, 0], cols[:, 1:1 + E], cols[:, 1 + E:]

    def decide(self, docs: Sequence[Any], config_names: Sequence[str]) -> List[bool]:
        return self.decide_rows(docs, [self.policy.config_ids[n] for n in config_names])

    def decide_rows(self, docs: Sequence[Any], rows: Sequence[int]) -> List[bool]:
        db = self.encode(docs, rows)
        own, _, _ = self.apply(db)
        out = [bool(b) for b in own[: len(docs)]]
        if db.host_fallback.any():
            for r in np.nonzero(db.host_fallback[: len(docs)])[0]:
                out[r], _, _ = host_results(self.policy, docs[r], rows[r])
        return out
