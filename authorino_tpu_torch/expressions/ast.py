"""Pattern-expression AST + CPU reference evaluator.

Semantics mirrored from the reference's pkg/jsonexp
(ref: pkg/jsonexp/expressions.go:53-178):

  - ``Pattern{selector, operator, value}`` with operators
    eq / neq / incl / excl / matches
  - eq/neq compare the gjson-String() rendering of the resolved value
  - incl/excl walk Result.Array() comparing element String() renderings
  - matches applies an RE2-style regex to the String() rendering
  - ``And`` / ``Or`` trees; ``All()`` / ``Any()`` build n-ary combinators;
    an empty And is vacuously true, an empty Or is false
    (ref: pkg/jsonexp/expressions.go:111-125, 136-154)

This CPU evaluator is the correctness oracle for the device kernel
(differential-tested in tests/test_compiler_differential.py).  In the
reference the ``matches`` operator recompiles its regex on every call
(ref: pkg/jsonexp/expressions.go:87); here patterns precompile once.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from enum import Enum
from typing import Any, Callable, Optional, Tuple, Union

from ..authjson import selector
from ..authjson.selector import WALK_MISS as _MISS
from ..authjson.selector import compile_walk as _compile_walk
from ..authjson.selector import render_value as _render
from ..relations.closure import RelationClosure

__all__ = [
    "Operator", "Pattern", "And", "Or", "All", "Any_", "Expression",
    "InGroup", "PatternError", "TRUE", "FALSE",
    "parse_int_value", "parse_int_const", "INT32_MIN", "INT32_MAX",
]


class PatternError(Exception):
    """Evaluation error (e.g. invalid regex) — propagates as a deny in the
    authorization phase, like the reference's error return."""


class Operator(str, Enum):
    EQ = "eq"
    NEQ = "neq"
    INCL = "incl"
    EXCL = "excl"
    MATCHES = "matches"
    # numeric comparators: integer comparison of the rendered
    # value against a compile-time integer constant — see the numeric
    # semantics note on Pattern below
    GT = "gt"
    GE = "ge"
    LT = "lt"
    LE = "le"

    @classmethod
    def from_string(cls, s: str) -> "Operator":
        try:
            return cls(s)
        except ValueError:
            raise PatternError(f"unsupported operator for json authorization: {s!r}")


NUMERIC_OPERATORS = (Operator.GT, Operator.GE, Operator.LT, Operator.LE)

# the numeric lane is int32-bounded end to end: constants must fold inside
# this range at compile time, and rendered values outside it read as
# non-numeric (False) — "bounded arithmetic" in the Cedar sense, so the
# kernel's int32 compare is exact by construction
INT32_MIN = -(1 << 31)
INT32_MAX = (1 << 31) - 1

_INT_VALUE = re.compile(r"^-?[0-9]+$")
# bounded compile-time arithmetic over the constant: `a`, `a+b`, `a-b`,
# `a*b` of integer literals (whitespace tolerated) — folded once at
# construction, int32-range-checked
_INT_CONST = re.compile(
    r"^\s*(-?[0-9]+)\s*(?:([+*-])\s*(-?[0-9]+)\s*)?$")


def parse_int_value(s: str) -> Optional[int]:
    """The SHARED runtime parse of a rendered value for gt/ge/lt/le: a
    plain base-10 integer, SATURATED to int32 — or None (→ the comparison
    is False).  Host oracle, Python encoder, and native encoder gate must
    all call exactly this.

    Saturation (not rejection) keeps huge integers order-exact: constants
    are bounded STRICTLY inside int32 (parse_int_const), so a value past
    either end compares against every constant exactly as its true
    magnitude would — the invariant the rego_lower int fragment's
    interpreter-equivalence proof relies on."""
    if not _INT_VALUE.match(s):
        return None
    v = int(s)
    if v < INT32_MIN:
        return INT32_MIN
    if v > INT32_MAX:
        return INT32_MAX
    return v


def parse_int_const(s: str) -> int:
    """Fold one numeric-operator constant at compile time: an integer
    literal or one `a+b` / `a-b` / `a*b` of literals, required to land
    STRICTLY inside int32 (the two extreme values are excluded so value
    saturation stays order-exact — see parse_int_value).  Raises
    ValueError otherwise (the pattern then behaves like an invalid regex:
    evaluation error ⇒ deny)."""
    m = _INT_CONST.match(s)
    if not m:
        raise ValueError(
            f"numeric operator constant {s!r} is not an integer "
            "(or a +,-,* of two integers)")
    a = int(m.group(1))
    if m.group(2) is not None:
        b = int(m.group(3))
        a = a + b if m.group(2) == "+" else \
            a - b if m.group(2) == "-" else a * b
    if a <= INT32_MIN or a >= INT32_MAX:
        raise ValueError(
            f"numeric operator constant {s!r} folds to {a}, outside the "
            f"open int32 bound ({INT32_MIN}, {INT32_MAX})")
    return a


def _compile_pattern(pat: "Pattern") -> Callable[[Any], bool]:
    """Close the selector walk, operator dispatch, and value rendering over
    one function — resolved once at construction instead of per call (the
    reference re-parses its gjson selector and recompiles its regex on every
    Matches, ref: pkg/jsonexp/expressions.go:61,87)."""
    op = pat.operator
    want = pat.value
    walk = _compile_walk(pat.selector)
    if op in NUMERIC_OPERATORS:
        # int32 comparison of the rendered value against the folded
        # constant; non-integer (or out-of-range) values compare False for
        # ALL four operators (so ge is deliberately NOT ¬lt), and an
        # unfoldable constant errors like an invalid regex (⇒ deny)
        const = getattr(pat, "_num_const", None)
        err = getattr(pat, "_num_error", "invalid numeric constant")
        cmp_fn = {
            Operator.GT: lambda v, c: v > c,
            Operator.GE: lambda v, c: v >= c,
            Operator.LT: lambda v, c: v < c,
            Operator.LE: lambda v, c: v <= c,
        }[op]
        if walk is None:
            sel_get = selector.get
            path = pat.selector

            def run_num_slow(doc, _c=const, _f=cmp_fn, _e=err):
                if _c is None:
                    raise PatternError(_e)
                v = parse_int_value(sel_get(doc, path).string())
                return v is not None and _f(v, _c)

            return run_num_slow

        def run_num(doc, _walk=walk, _c=const, _f=cmp_fn, _e=err):
            if _c is None:
                raise PatternError(_e)
            v = parse_int_value(_render(_walk(doc)))
            return v is not None and _f(v, _c)

        return run_num
    if walk is None:
        sel_get = selector.get
        path = pat.selector
        if op is Operator.EQ:
            return lambda doc: want == sel_get(doc, path).string()
        if op is Operator.NEQ:
            return lambda doc: want != sel_get(doc, path).string()
        if op is Operator.INCL:
            return lambda doc: any(
                want == item.string() for item in sel_get(doc, path).array())
        if op is Operator.EXCL:
            return lambda doc: all(
                want != item.string() for item in sel_get(doc, path).array())
        rx = pat._regex  # MATCHES

        def run_rx_slow(doc, _rx=rx, _err=getattr(pat, "_regex_error", "invalid regex")):
            if _rx is None:
                raise PatternError(_err)
            return _rx.search(sel_get(doc, path).string()) is not None

        return run_rx_slow

    if op is Operator.EQ:
        return lambda doc: want == _render(walk(doc))
    if op is Operator.NEQ:
        return lambda doc: want != _render(walk(doc))
    if op is Operator.INCL:
        # gjson array(): list → elements; missing/None → []; scalar → [self]
        def run_incl(doc, _walk=walk, _want=want):
            v = _walk(doc)
            if type(v) is list:
                return any(_want == _render(e) for e in v)
            if v is _MISS or v is None:
                return False
            return _want == _render(v)

        return run_incl
    if op is Operator.EXCL:
        def run_excl(doc, _walk=walk, _want=want):
            v = _walk(doc)
            if type(v) is list:
                return all(_want != _render(e) for e in v)
            if v is _MISS or v is None:
                return True
            return _want != _render(v)

        return run_excl
    rx = pat._regex  # MATCHES

    def run_rx(doc, _walk=walk, _rx=rx, _err=getattr(pat, "_regex_error", "invalid regex")):
        if _rx is None:
            raise PatternError(_err)
        return _rx.search(_render(_walk(doc))) is not None

    return run_rx


@dataclass(frozen=True)
class Pattern:
    selector: str
    operator: Operator
    value: str

    def __post_init__(self):
        # coerce plain-string operators ("eq" == Operator.EQ under str-Enum
        # equality, but dispatch below uses identity) and validate early
        if not isinstance(self.operator, Operator):
            object.__setattr__(self, "operator", Operator.from_string(str(self.operator)))
        if self.operator is Operator.MATCHES:
            try:
                object.__setattr__(self, "_regex", re.compile(self.value))
            except re.error as e:
                object.__setattr__(self, "_regex", None)
                object.__setattr__(self, "_regex_error", str(e))
        else:
            object.__setattr__(self, "_regex", None)
        if self.operator in NUMERIC_OPERATORS:
            try:
                object.__setattr__(self, "_num_const",
                                   parse_int_const(self.value))
            except ValueError as e:
                # like an invalid regex: evaluation raises ⇒ deny, and the
                # compiler routes the whole tree to the CPU oracle
                object.__setattr__(self, "_num_const", None)
                object.__setattr__(self, "_num_error", str(e))
        # shadow the class method with the compiled closure (instance
        # attribute wins on lookup — one call layer, zero per-call dispatch)
        object.__setattr__(self, "matches", _compile_pattern(self))

    def matches(self, doc: Any) -> bool:  # overridden per-instance in __post_init__
        raise AssertionError("unreachable: compiled in __post_init__")

    def __str__(self):
        return f"{self.selector} {self.operator.value} {self.value}"


@dataclass(frozen=True)
class And:
    children: Tuple["Expression", ...] = ()

    def __post_init__(self):
        fns = tuple(c.matches for c in self.children)
        if len(fns) == 1:
            run = fns[0]
        else:
            def run(doc, _fns=fns):
                return all(f(doc) for f in _fns)
        object.__setattr__(self, "matches", run)

    def matches(self, doc: Any) -> bool:  # overridden per-instance
        return all(c.matches(doc) for c in self.children)

    def __str__(self):
        return "(" + " && ".join(str(c) for c in self.children) + ")"


@dataclass(frozen=True)
class Or:
    children: Tuple["Expression", ...] = ()

    def __post_init__(self):
        fns = tuple(c.matches for c in self.children)
        if len(fns) == 1:
            run = fns[0]
        else:
            def run(doc, _fns=fns):
                return any(f(doc) for f in _fns)
        object.__setattr__(self, "matches", run)

    def matches(self, doc: Any) -> bool:  # overridden per-instance
        return any(c.matches(doc) for c in self.children)

    def __str__(self):
        return "(" + " || ".join(str(c) for c in self.children) + ")"


@dataclass(frozen=True)
class InGroup:
    """Hierarchical entity/group membership leaf (Cedar-style):
    true iff the rendered value of ``selector`` is a member of ``group``
    under the transitive ancestor closure of ``relation`` (entity→group
    edges declared in the AuthConfig spec and closed at reconcile time —
    relations/closure.py).  The compiler lowers this to an OP_RELATION
    bitmask-gather leaf over the per-snapshot relation table; this host
    evaluator is the exactness oracle for that lowering.

    An unknown entity is in no groups; a group never declared as an edge
    parent contains nothing — both sides are constant False, never an
    error."""

    selector: str
    group: str
    relation: RelationClosure

    def __post_init__(self):
        walk = _compile_walk(self.selector)
        rel = self.relation
        group = self.group
        if walk is None:
            sel_get = selector.get
            path = self.selector

            def run(doc, _rel=rel, _g=group):
                return _rel.contains(sel_get(doc, path).string(), _g)
        else:

            def run(doc, _walk=walk, _rel=rel, _g=group):
                return _rel.contains(_render(_walk(doc)), _g)

        object.__setattr__(self, "matches", run)

    def matches(self, doc: Any) -> bool:  # overridden per-instance
        raise AssertionError("unreachable: compiled in __post_init__")

    def __str__(self):
        return (f"{self.selector} ingroup {self.group}"
                f"@{self.relation.digest[:8]}")


Expression = Union[Pattern, And, Or, InGroup]

TRUE: Expression = And(())    # empty And — vacuous truth (ref :111-125)
FALSE: Expression = Or(())    # empty Or (ref :136-154)


def All(*expressions: Expression) -> Expression:
    return And(tuple(expressions))


def Any_(*expressions: Expression) -> Expression:
    return Or(tuple(expressions))
