"""Per-config fingerprints and the encoding epoch — the two keys the
incremental control plane hangs everything on.

A verdict is a pure function of three things:

  1. how the request was encoded into operand bytes    → the *epoch*
  2. which config's rules judge those bytes            → the *fingerprint*
  3. the operand bytes themselves                      → the row key
                                                         (compiler/pack.py)

``rules_fingerprint`` canonically digests one config's SOURCE expression
trees (selector / operator / constant strings — no interner ids, no buffer
slots), so it is stable across recompiles, compile order, and process
restarts.  It keys the compile cache (same source ⇒ same artifact) and,
jointly with the epoch, the per-config verdict cache: two snapshots that
agree on (epoch, fingerprint) decide identical verdicts for identical
operand bytes, so entries for untouched configs SURVIVE a snapshot swap —
the single biggest cache-efficiency cliff under churn.

``encoding_epoch`` digests everything that defines the *meaning* of an
encoded operand row: the positional attr→selector table, the compact
membership slots, the dense CPU-lane column identities, the DFA byte
slots, members_k, and the interner's identity serial (ids from different
interner objects are incomparable).  Any layout change yields a new epoch
and old entries become unreachable — structural invalidation, exactly like
generation keying, but scoped to what actually changed."""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

from ..compiler.compile import DFA_VALUE_BYTES, CompiledPolicy
from ..expressions.ast import And, InGroup, Pattern

__all__ = ["rules_fingerprint", "encoding_epoch", "cache_tokens"]


def rules_fingerprint(cfg, memo: Optional[Dict[int, str]] = None) -> str:
    """Canonical semantic fingerprint of one ConfigRules' SOURCE trees.

    Deliberately name-free: two configs with identical rules share one
    fingerprint (and thus one compile-cache artifact — structural sharing
    across AuthConfigs).  Compilation is deterministic given the source,
    so the source digest determines the artifact."""
    memo = memo if memo is not None else {}
    cols: List[Tuple[Optional[str], str]] = []
    for cond, rule in cfg.evaluators:
        cols.append((
            _tree_digest(cond, memo) if cond is not None else None,
            _tree_digest(rule, memo),
        ))
    return _sha(repr(("rules", tuple(cols))))


def encoding_epoch(policy: CompiledPolicy) -> str:
    """Digest of the operand-encoding layout of one compiled corpus (see
    module docstring).  Cached on the policy object — the layout is frozen
    at compile time."""
    cached = getattr(policy, "_enc_epoch", None)
    if cached is not None:
        return cached
    tree_memo: Dict[int, str] = {}
    # dense CPU-lane columns: the [B, C] booleans are positional — column j
    # IS the leaf cpu_leaf_list[j], identified canonically (op, selector,
    # pattern / whole-tree digest), never by leaf index
    cpu_desc = []
    rev = None
    for leaf in policy.cpu_leaf_list.tolist():
        rx = policy.leaf_regex[leaf]
        tree = policy.leaf_tree[leaf]
        # ovf_assist membership columns are identified by their CONSTANT
        # too (two incl leaves on one attr are distinct columns)
        const_s = None
        if bool(policy.leaf_is_membership[leaf]):
            if rev is None:
                rev = policy.interner.reverse()
            const_s = rev.get(int(policy.leaf_const[leaf]),
                              f"<id:{int(policy.leaf_const[leaf])}>")
        cpu_desc.append((
            int(policy.leaf_op[leaf]),
            policy.attr_selectors[int(policy.leaf_attr[leaf])],
            rx.pattern if rx is not None else None,
            _tree_digest(tree, tree_memo) if tree is not None else None,
            const_s,
        ))
    # byte-tensor slots: slot → selector (positional [B, NB, LB] axes)
    byte_slots: Dict[int, str] = {}
    for a_i, slot in enumerate(policy.attr_byte_slot.tolist()):
        if slot >= 0:
            byte_slots[int(slot)] = policy.attr_selectors[a_i]
    # the numeric and relation operand lanes: numeric value slots are positional (slot →
    # selector); relation rows' MEANING is the (relation digest, entity →
    # row) assignment per slot; assist columns fold in via cpu_desc (the
    # membership leaves that join cpu_leaf_list change it) plus the
    # explicit flag (the [B, M] mask's presence itself)
    num_slots: Dict[int, str] = {}
    nas = getattr(policy, "num_attr_slot", None)
    if nas is not None:
        for a_i, slot in enumerate(nas.tolist()):
            if slot >= 0:
                num_slots[int(slot)] = policy.attr_selectors[a_i]
    rel_desc = []
    for slot, (attr, inst) in enumerate(getattr(policy, "rel_slots", None)
                                        or ()):
        closure = policy.rel_instances[inst]
        rel_desc.append((
            policy.attr_selectors[int(attr)], closure.digest,
            tuple(sorted((e, policy.rel_entity_rows[inst][e])
                         for e in policy.rel_entity_rows[inst])),
        ))
    payload = (
        int(policy.interner.serial),
        int(policy.members_k),
        tuple(policy.attr_selectors),
        (tuple(policy.attr_selectors[a] for a in policy.member_attrs.tolist()),
         int(policy.n_member_attrs)),
        (tuple(cpu_desc), int(policy.n_cpu_leaves)),
        (tuple(byte_slots.get(s) for s in range(policy.n_byte_attrs)),
         DFA_VALUE_BYTES),
        (tuple(num_slots.get(s)
               for s in range(int(getattr(policy, "n_num_attrs", 0) or 0))),
         tuple(rel_desc), bool(getattr(policy, "ovf_assist", False))),
    )
    epoch = hashlib.sha256(repr(payload).encode("utf-8")).hexdigest()[:16]
    policy._enc_epoch = epoch  # type: ignore[attr-defined]
    return epoch


def cache_tokens(policy: CompiledPolicy,
                 fingerprints: Dict[str, str]) -> List[Tuple[str, str]]:
    """Per-eval-row verdict-cache key tokens: (epoch, fingerprint) per
    config row.  Padded rows (mesh targets) get a sentinel token — no
    request can ever map to them (row ids only cover real configs)."""
    epoch = encoding_epoch(policy)
    Gp = int(policy.eval_rule.shape[0])
    toks: List[Tuple[str, str]] = [(epoch, "<pad>")] * Gp
    for name, row in policy.config_ids.items():
        toks[row] = (epoch, fingerprints.get(name, "<no-fp>:" + name))
    return toks


# ---------------------------------------------------------------------------
# canonical digests of source expression trees
# ---------------------------------------------------------------------------


def _sha(payload: str) -> str:
    return hashlib.sha256(payload.encode("utf-8")).hexdigest()


def _tree_digest(expr, memo: Dict[int, str]) -> str:
    """Position-free digest of one expression tree: selector, operator and
    constant strings, a relation by its closure digest (a changed edge set
    re-fingerprints exactly the configs that read it)."""
    hit = memo.get(id(expr))
    if hit is not None:
        return hit
    if isinstance(expr, Pattern):
        d = _sha(repr(("p", expr.selector, expr.operator.value, expr.value)))
    elif isinstance(expr, InGroup):
        d = _sha(repr(("g", expr.selector, expr.group,
                       expr.relation.digest)))
    else:
        tag = "a" if isinstance(expr, And) else "o"
        d = _sha(repr((tag, tuple(_tree_digest(c, memo)
                                  for c in expr.children))))
    memo[id(expr)] = d
    return d
