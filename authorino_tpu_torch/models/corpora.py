"""A small corpus that exercises every lane of the mega-kernel at once, and
requests for it: relations (a deep chain), numeric compares, membership
that overflows ``members_k=4``, eq, device-DFA regexes over two distinct
tables (with values too long for the byte tensor), and one config whose
regex (a backreference) only the CPU lane can decide.

``ns`` names the expression classes to build with (``Pattern``, ``All``,
``Any_``, ``InGroup``, ``Operator``, ``RelationClosure``, ``ConfigRules``);
by default this package's."""

from __future__ import annotations

import dataclasses
import random
from types import SimpleNamespace
from typing import List

__all__ = ["LANES_K", "all_lanes_corpus", "all_lanes_docs", "port_classes",
           "widen_wire"]

LANES_K = 4  # members_k small enough that role lists overflow on purpose


def port_classes() -> SimpleNamespace:
    from ..compiler.compile import ConfigRules
    from ..expressions import All, Any_, InGroup, Operator, Pattern
    from ..relations.closure import RelationClosure

    return SimpleNamespace(Pattern=Pattern, All=All, Any_=Any_,
                           InGroup=InGroup, Operator=Operator,
                           RelationClosure=RelationClosure,
                           ConfigRules=ConfigRules)


def all_lanes_corpus(seed: int, n_configs: int = 6, ns=None) -> list:
    ns = ns or port_classes()
    rng = random.Random(seed)
    deep = [(f"d{i}", f"d{i + 1}") for i in range(6)]
    rel = ns.RelationClosure(deep + [("u", "left"), ("left", "mid"),
                                     ("mid", "top")])
    groups = ["mid", "top", "left", "d3", "d5"]
    Op = ns.Operator
    cfgs = []
    for i in range(n_configs):
        leaves = [
            ns.InGroup("auth.identity.sub", rng.choice(groups), rel),
            ns.Pattern("req.n", rng.choice([Op.GT, Op.GE, Op.LT, Op.LE]),
                       str(rng.randrange(-5, 30))),
            ns.Pattern("auth.identity.roles", Op.INCL, f"r{i % 3}"),
            ns.Pattern("req.m", Op.EQ, rng.choice(["GET", "POST"])),
            ns.Pattern("req.path", Op.MATCHES, rf"^/svc-{i % 3}/"),
        ]
        rng.shuffle(leaves)
        rule = ns.All(leaves[0], ns.Any_(*leaves[1:4]))
        cond = leaves[4] if rng.random() < 0.5 else None
        cfgs.append(ns.ConfigRules(
            name=f"cfg-{i}", evaluators=[(cond, rule), (None, leaves[4])]))
    cfgs.append(ns.ConfigRules(name="cfg-cpu", evaluators=[
        (None, ns.Pattern("req.q", Op.MATCHES, r"^(a+)\1$"))]))
    return cfgs


def all_lanes_docs(seed: int, n: int = 48) -> List[dict]:
    """Unparseable numbers, paths longer than the byte tensor, role lists
    longer than ``LANES_K``, unknown entities."""
    rng = random.Random(seed)
    ents = [f"d{i}" for i in range(7)] + ["u", "left", "mid", "top",
                                          "stranger"]
    docs = []
    for _ in range(n):
        docs.append({
            "req": {"n": rng.choice([-10, 0, 3, 29, 30, "x", None]),
                    "m": rng.choice(["GET", "POST", "PUT"]),
                    "path": rng.choice(["/svc-0/a", "/svc-1/b", "/zzz",
                                        "/svc-2/" + "x" * 200]),
                    "q": rng.choice(["aaaa", "aaa", "ab"])},
            "auth": {"identity": {
                "sub": rng.choice(ents),
                "roles": [f"r{rng.randrange(4)}" for _ in
                          range(rng.choice([1, 2, LANES_K + 3]))],
            }},
        })
    return docs


def widen_wire(db):
    """The same packed batch on the int32 wire, as a corpus whose interner
    outgrows int16 ships it (``compiler/pack.py::wire_dtype``)."""
    import numpy as np

    return dataclasses.replace(db, attrs_val=db.attrs_val.astype(np.int32),
                               members_c=db.members_c.astype(np.int32))
