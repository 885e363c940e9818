"""Embedded mini-Rego interpreter — the evaluation core of the OPA
authorization evaluator (ref: pkg/evaluators/authorization/opa.go uses the
Go OPA library; the package embeds no OPA runtime, so a focused subset
interpreter runs the same policies on the host behind the identical
evaluator seam).  A copy of the JAX package's interpreter: same subset,
same results.

Supported subset (policies outside it are rejected at reconcile time, which
surfaces as a translate error — fail closed):

  - ``package``/``import`` headers (imports of ``input`` aliases only)
  - ``default <name> = <term>``
  - rules: ``name { body }``, ``name = term { body }``, ``name := term``,
    ``name if { body }`` (v1 sugar), multiple definitions (logical OR),
    partial set rules ``name contains term { body }`` (v1) and
    ``name[term] { body }`` (v0) — the rule document is the set of head
    values over all satisfying bindings (OPA sets serialize as arrays)
  - body expressions (newline/``;`` separated, logical AND):
    comparisons ``== != < <= > >=``, assignment ``:=``, unification ``=``
    (simple var binding), negation ``not``, membership ``x in xs``,
    ``every v in xs { ... }`` / ``every k, v in xs { ... }``,
    existential iteration over ``ref[_]`` / ``ref[i]`` variables,
    numeric arithmetic ``+ - * / %`` with parentheses and unary minus
    (numbers only; modulo on integers — OPA operator semantics)
  - comprehensions: array ``[head | body]``, set ``{head | body}``
    (yields a deduped list — OPA's JSON serialization of sets), object
    ``{key: head | body}``
  - references over ``input`` and rule results; array/object indexing
  - built-ins: count, contains, startswith, endswith, lower, upper, split,
    concat, trim, trim_prefix, trim_suffix, replace, sprintf, to_number,
    abs, max, min, sum, sort, indexof, substring, object.get, array.concat,
    json.unmarshal, regex.match/re_match, time.now_ns, is_null/is_string/
    is_boolean/is_number/is_array/is_object
  - ``walk(x, [path, value])`` — the nested path/value relation
  - ``with`` mocking of input/data paths AND of functions/builtins
    (``with f as g`` / ``with count as 42``), scoped through referenced rules
  - multi-module composition: extra ``package`` declarations in the same
    source form sibling modules, addressable as ``data.<pkg>.<rule>`` and
    ``data.<pkg>.<fn>(...)``; package docs nest/merge over external data

``regex.match`` evaluates through the linear-time DFA engine
(compiler/redfa.py) whenever the pattern is DFA-compilable — matching
OPA's RE2 guarantee against request-controlled input; patterns outside the
DFA subset fall back to Python ``re`` (backtracking)."""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

__all__ = ["RegoError", "RegoModule", "compile_module"]


class RegoError(Exception):
    pass


# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>[ \t\r]+)
  | (?P<comment>\#[^\n]*)
  | (?P<newline>\n)
  | (?P<string>"(?:[^"\\]|\\.)*")
  | (?P<rawstring>`[^`]*`)
  | (?P<number>\d+(?:\.\d+)?)
  | (?P<op>:=|==|!=|<=|>=|\[|\]|\{|\}|\(|\)|,|;|:|\.|<|>|=|\||\+|-|\*|/|%)
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
""",
    re.X,
)

_KEYWORDS = {"package", "import", "default", "not", "in", "if", "true", "false", "null",
             "else", "some", "every", "as", "contains", "with"}


@dataclass
class _Tok:
    kind: str  # "name" | "string" | "number" | "op" | "newline" | "eof"
    value: Any
    line: int


def _lex(src: str) -> List[_Tok]:
    toks: List[_Tok] = []
    line = 1
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise RegoError(f"rego: unexpected character {src[pos]!r} at line {line}")
        pos = m.end()
        kind = m.lastgroup
        text = m.group()
        if kind in ("ws", "comment"):
            continue
        if kind == "newline":
            line += 1
            toks.append(_Tok("newline", "\n", line))
        elif kind == "string":
            toks.append(_Tok("string", json.loads(text), line))
        elif kind == "rawstring":
            toks.append(_Tok("string", text[1:-1], line))
        elif kind == "number":
            toks.append(_Tok("number", float(text) if "." in text else int(text), line))
        elif kind == "op":
            toks.append(_Tok("op", text, line))
        else:
            toks.append(_Tok("name", text, line))
    toks.append(_Tok("eof", None, line))
    return toks


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------

@dataclass
class Ref:
    base: str                      # "input" | var | rule name
    path: List[Any] = field(default_factory=list)  # str keys, Const, Var("_"), Var(name)


@dataclass
class Var:
    name: str


@dataclass
class Const:
    value: Any


@dataclass
class ArrayLit:
    items: List[Any]


@dataclass
class ObjectLit:
    items: List[Tuple[Any, Any]]


@dataclass
class CallExpr:
    fn: str
    args: List[Any]
    # postfix ref applied to the call result: sort(x)[0], split(s, "/")[1]
    path: List[Any] = field(default_factory=list)


@dataclass
class BinExpr:
    op: str
    left: Any
    right: Any


@dataclass
class EveryExpr:
    """``every v in xs { body }`` / ``every k, v in xs { body }`` (Rego v1):
    satisfied iff the body is satisfiable for every element of the domain
    (vacuously true on an empty domain)."""

    key: Optional[str]
    val: str
    domain: Any
    body: List[Any]


@dataclass
class Compr:
    """Comprehension term: ``[head | body]`` (array), ``{head | body}``
    (set — yielded as a deduped list, OPA's JSON serialization of sets),
    ``{key: head | body}`` (object)."""

    kind: str  # "array" | "set" | "object"
    head: Any
    key_head: Any = None
    body: List[Any] = field(default_factory=list)


@dataclass
class ArithExpr:
    """Numeric arithmetic: + - * / %  (numbers only, like OPA's operators;
    string concat is the `concat` builtin).  `right is None` encodes unary
    minus."""

    op: str
    left: Any
    right: Any = None


@dataclass
class NotExpr:
    expr: Any


@dataclass
class InExpr:
    needle: Any
    haystack: Any


@dataclass
class SomeDecl:
    names: List[str]


@dataclass
class SomeInExpr:
    """``some k, v in xs`` — existential iteration binding key (array index
    / object key) and value together (OPA v1 `in` with two variables)."""

    key: str
    val: str
    domain: Any


@dataclass
class WithExpr:
    """``expr with input.path as term`` — input/data mocking: the wrapped
    expression (and every rule it references) re-evaluates against the
    overlaid documents (OPA `with` modifier)."""

    expr: Any
    mods: List[Tuple[Any, Any]]  # (target Ref/Var rooted at input|data, value term)


@dataclass
class Rule:
    name: str
    value: Any          # term producing the rule value (Const(True) default)
    body: List[Any]     # expressions (AND)
    is_default: bool = False
    # partial set rule (`name contains term { body }` / `name[term] { body }`):
    # the rule document is the set of head values over ALL satisfying
    # bindings of ALL definitions (OPA sets serialize as arrays)
    is_set: bool = False
    # `else [= v] { body }` chain: tried in order when the primary body has
    # no satisfying binding (OPA else blocks — ordered evaluation)
    else_chain: List[Tuple[Any, List[Any]]] = field(default_factory=list)


@dataclass
class FuncDef:
    """User-defined function: ``f(x) = y { body }`` / ``f(x) { body }``.
    Params are Var (bind) or Const (must unify) patterns; multiple
    definitions are tried in order (OPA functions)."""

    name: str
    params: List[Any]
    value: Any
    body: List[Any]
    else_chain: List[Tuple[Any, List[Any]]] = field(default_factory=list)


@dataclass
class RegoModule:
    package: str
    rules: Dict[str, List[Rule]]
    defaults: Dict[str, Any]
    funcs: Dict[str, List[FuncDef]] = field(default_factory=dict)
    # multi-module composition: auxiliary packages parsed from the same
    # source, addressable as data.<package>.<rule> (OPA compiles a module
    # SET; the main package is the policy entrypoint)
    siblings: Dict[str, "RegoModule"] = field(default_factory=dict)

    def evaluate(self, input_doc: Any, data: Any = None) -> Dict[str, Any]:
        """Evaluate every rule in the package against ``input`` (plus an
        optional external ``data`` document tree) and return the package
        document (rule name → value)."""
        ev = _Evaluator(self, input_doc, data=data)
        out: Dict[str, Any] = {}
        for name in self.rules:
            v = ev.rule_value(name)
            if v is not _UNDEFINED:
                out[name] = v
        for name, default in self.defaults.items():
            if name not in out:
                out[name] = _const_value(default)
        return out


_UNDEFINED = object()


def _overlay(doc: Any, path: List[str], val: Any) -> Any:
    """Copy-on-write deep-set for `with` document overlays."""
    if not path:
        return val
    out = dict(doc) if isinstance(doc, dict) else {}
    out[path[0]] = _overlay(out.get(path[0], {}), path[1:], val)
    return out


def _merge_docs(base: Any, over: Any) -> Any:
    """Deep dict merge, ``over`` winning on conflicts (virtual docs shadow
    external data, like OPA's base/virtual document layering)."""
    if isinstance(base, dict) and isinstance(over, dict):
        out = dict(base)
        for k, v in over.items():
            out[k] = _merge_docs(out[k], v) if k in out else v
        return out
    return over


def _fold_const(term) -> Any:
    """Constant-fold arithmetic over literals (``default x = 60 * 60``);
    anything non-constant folds to itself."""
    if isinstance(term, ArithExpr):
        left = _fold_const(term.left)
        if not (isinstance(left, Const) and isinstance(left.value, (int, float))
                and not isinstance(left.value, bool)):
            return term
        if term.right is None:
            return Const(-left.value)
        right = _fold_const(term.right)
        if not (isinstance(right, Const) and isinstance(right.value, (int, float))
                and not isinstance(right.value, bool)):
            return term
        a, b = left.value, right.value
        try:
            if term.op == "+":
                return Const(a + b)
            if term.op == "-":
                return Const(a - b)
            if term.op == "*":
                return Const(a * b)
            if term.op == "/":
                return Const(_exact_div(a, b))
            r = abs(a) % abs(b)
            return Const(r if a >= 0 else -r)
        except ZeroDivisionError:
            raise RegoError("divide by zero in constant expression")
    return term


def _exact_div(a, b):
    """OPA number division: 3/2 == 1.5 but 4/2 == 2 (exact quotients stay
    integers in the serialized JSON)."""
    r = a / b
    if isinstance(r, float) and r.is_integer() and abs(r) < 2**53:
        return int(r)
    return r


def _const_value(term) -> Any:
    if isinstance(term, Const):
        return term.value
    raise RegoError("default value must be a constant")


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------

class _Parser:
    def __init__(self, toks: List[_Tok]):
        self.toks = toks
        self.i = 0

    def peek(self, offset: int = 0) -> _Tok:
        return self.toks[min(self.i + offset, len(self.toks) - 1)]

    def next(self) -> _Tok:
        t = self.toks[self.i]
        if t.kind != "eof":
            self.i += 1
        return t

    def skip_newlines(self):
        while self.peek().kind == "newline":
            self.next()

    def expect(self, kind: str, value: Any = None) -> _Tok:
        t = self.next()
        if t.kind != kind or (value is not None and t.value != value):
            raise RegoError(f"rego parse error at line {t.line}: expected {value or kind}, got {t.value!r}")
        return t

    # ---- module ----

    def parse_module(self) -> RegoModule:
        """Parse a module SET: additional ``package`` declarations mid-source
        start auxiliary modules (multi-module composition — OPA compiles
        every module of a bundle; the first/unnamed package is the policy
        entrypoint and the rest mount at data.<package>)."""
        self.skip_newlines()
        package = "policy"
        if self.peek().kind == "name" and self.peek().value == "package":
            self.next()
            package = self._parse_dotted_name()
        modules: List[RegoModule] = []

        def begin(pkg: str) -> RegoModule:
            for m in modules:
                if m.package == pkg:  # same package split across segments
                    return m
            m = RegoModule(package=pkg, rules={}, defaults={}, funcs={})
            modules.append(m)
            return m

        cur = begin(package)
        while self.peek().kind != "eof":
            self.skip_newlines()
            if self.peek().kind == "eof":
                break
            if self.peek().kind == "name" and self.peek().value == "package":
                self.next()
                cur = begin(self._parse_dotted_name())
                continue
            if self.peek().kind == "name" and self.peek().value == "import":
                while self.peek().kind not in ("newline", "eof"):
                    self.next()
                continue
            rules, defaults, funcs = cur.rules, cur.defaults, cur.funcs
            rule = self._parse_rule()
            if isinstance(rule, FuncDef):
                if rule.name in rules or rule.name in defaults:
                    raise RegoError(
                        f"rego: {rule.name!r} defined as both rule and function")
                funcs.setdefault(rule.name, []).append(rule)
                continue
            if rule.name in funcs:
                raise RegoError(
                    f"rego: {rule.name!r} defined as both rule and function")
            if rule.is_default:
                defaults[rule.name] = rule.value
            else:
                defs = rules.setdefault(rule.name, [])
                if defs and defs[0].is_set != rule.is_set:
                    raise RegoError(
                        f"rego: conflicting rule types for {rule.name!r} "
                        "(complete vs partial set)"
                    )
                defs.append(rule)
        main = modules[0]
        main.siblings = {m.package: m for m in modules[1:]}
        return main

    def _parse_dotted_name(self) -> str:
        parts = [self.expect("name").value]
        while self.peek().kind == "op" and self.peek().value == ".":
            self.next()
            parts.append(self.expect("name").value)
        return ".".join(parts)

    # ---- rules ----

    def _parse_rule(self) -> Union[Rule, "FuncDef"]:
        t = self.peek()
        if t.kind == "name" and t.value == "else":
            raise RegoError(f"rego: 'else' without a preceding rule body at line {t.line}")
        if t.kind == "name" and t.value == "default":
            self.next()
            name = self.expect("name").value
            op = self.next()
            if not (op.kind == "op" and op.value in ("=", ":=")):
                raise RegoError(f"rego parse error at line {op.line}: expected = after default")
            value = _fold_const(self._parse_term())
            if not isinstance(value, Const):
                # fail closed at COMPILE: a non-constant default would
                # otherwise reconcile Ready and error on every request
                raise RegoError(
                    f"rego parse error at line {op.line}: default value must be a constant"
                )
            return Rule(name=name, value=value, body=[], is_default=True)

        name = self.expect("name").value
        value: Any = Const(True)
        body: List[Any] = []
        is_set = False
        params: Optional[List[Any]] = None

        t = self.peek()
        # function rule head: `name(params)` — params are Var / Const patterns
        if t.kind == "op" and t.value == "(":
            self.next()
            params = []
            while not (self.peek().kind == "op" and self.peek().value == ")"):
                p = self._parse_term()
                if not isinstance(p, (Var, Const)):
                    raise RegoError(
                        f"rego: unsupported function parameter pattern at line {t.line}")
                params.append(p)
                if self.peek().kind == "op" and self.peek().value == ",":
                    self.next()
            self.expect("op", ")")
            t = self.peek()
        # partial set rules: `name contains term { body }` (v1) and
        # `name[term] { body }` (v0); a bodyless `name[term]` is always-member
        if params is None and t.kind == "name" and t.value == "contains":
            self.next()
            value = self._parse_term()
            is_set = True
            t = self.peek()
        elif params is None and t.kind == "op" and t.value == "[":
            self.next()
            value = self._parse_term()
            self.expect("op", "]")
            is_set = True
            t = self.peek()
        # name = term / name := term
        if not is_set and t.kind == "op" and t.value in ("=", ":="):
            self.next()
            value = self._parse_term()
            t = self.peek()
        # optional `if` (v1): followed by a block body or a single
        # brace-less expression (`allow if input.x == 1`)
        has_if = False
        if t.kind == "name" and t.value == "if":
            self.next()
            has_if = True
            t = self.peek()
        if t.kind == "op" and t.value == "{":
            self.next()
            body = self._parse_body()
            self.expect("op", "}")
        elif has_if:
            # brace-less `if expr` — dropping it would make the rule
            # unconditional (fail open) and reparse the condition as a
            # phantom rule
            body = [self._parse_expr()]
        elif not body and not is_set and isinstance(value, Const) and value.value is True and not (
            t.kind in ("newline", "eof")
        ):
            # bare `name expr`? not supported
            raise RegoError(f"rego parse error at line {t.line}: expected rule body")
        else_chain = self._parse_else_chain()
        if else_chain and is_set:
            raise RegoError("rego: 'else' is not allowed on partial set rules")
        if params is not None:
            return FuncDef(name=name, params=params, value=value, body=body,
                           else_chain=else_chain)
        return Rule(name=name, value=value, body=body, is_set=is_set,
                    else_chain=else_chain)

    def _parse_else_chain(self) -> List[Tuple[Any, List[Any]]]:
        """``else [= term] [if] { body }`` elements after a rule body; the
        trailing brace-less ``else := v`` (no body) is an unconditional
        fallback (OPA else semantics)."""
        chain: List[Tuple[Any, List[Any]]] = []
        while True:
            # `else` must follow the closing brace (same or next lines);
            # it cannot start a rule, so lookahead across newlines is safe
            j = 0
            while self.peek(j).kind == "newline":
                j += 1
            t = self.peek(j)
            if not (t.kind == "name" and t.value == "else"):
                return chain
            self.skip_newlines()
            self.next()  # else
            value: Any = Const(True)
            t = self.peek()
            if t.kind == "op" and t.value in ("=", ":="):
                self.next()
                value = self._parse_term()
                t = self.peek()
            if t.kind == "name" and t.value == "if":
                self.next()
                t = self.peek()
                if not (t.kind == "op" and t.value == "{"):
                    chain.append((value, [self._parse_expr()]))
                    continue
            if t.kind == "op" and t.value == "{":
                self.next()
                body = self._parse_body()
                self.expect("op", "}")
                chain.append((value, body))
            else:
                chain.append((value, []))  # unconditional fallback
                return chain

    def _parse_body(self, end: str = "}") -> List[Any]:
        exprs: List[Any] = []
        while True:
            self.skip_newlines()
            t = self.peek()
            if t.kind == "op" and t.value == end:
                return exprs
            if t.kind == "eof":
                raise RegoError("rego parse error: unexpected EOF in rule body")
            exprs.append(self._parse_expr())
            t = self.peek()
            if t.kind == "op" and t.value == ";":
                self.next()

    # ---- expressions ----

    def _parse_expr(self) -> Any:
        t = self.peek()
        if t.kind == "name" and t.value == "not":
            self.next()
            return NotExpr(self._parse_expr())
        if t.kind == "name" and t.value == "every":
            self.next()
            first = self.expect("name").value
            key = None
            val = first
            if self.peek().kind == "op" and self.peek().value == ",":
                self.next()
                key = first
                val = self.expect("name").value
            nxt = self.expect("name")
            if nxt.value != "in":
                raise RegoError(f"rego parse error at line {nxt.line}: expected 'in' after every vars")
            domain = self._parse_term()
            self.skip_newlines()
            self.expect("op", "{")
            body = self._parse_body()
            self.expect("op", "}")
            return self._parse_with(EveryExpr(key=key, val=val, domain=domain, body=body))
        if t.kind == "name" and t.value == "some":
            self.next()
            names = [self.expect("name").value]
            while self.peek().kind == "op" and self.peek().value == ",":
                self.next()
                names.append(self.expect("name").value)
            # `some x in xs` / `some k, v in xs` sugar
            if self.peek().kind == "name" and self.peek().value == "in":
                self.next()
                haystack = self._parse_term()
                if len(names) == 2:
                    return self._parse_with(
                        SomeInExpr(names[0], names[1], haystack))
                if len(names) != 1:
                    raise RegoError(
                        "rego: 'some ... in' takes one or two variables")
                return self._parse_with(InExpr(Var(names[0]), haystack))
            return SomeDecl(names)
        left = self._parse_term()
        t = self.peek()
        if t.kind == "name" and t.value == "in":
            self.next()
            return self._parse_with(InExpr(left, self._parse_term()))
        if t.kind == "op" and t.value in ("==", "!=", "<", "<=", ">", ">=", "=", ":="):
            op = self.next().value
            right = self._parse_term()
            return self._parse_with(BinExpr(op, left, right))
        return self._parse_with(left)

    def _parse_with(self, expr: Any) -> Any:
        """Postfix ``with <target> as <term>`` modifiers (may chain).
        Targets: input/data paths (document mocking) or function/builtin
        names (function mocking — the replacement is a function name or a
        constant value; unknown targets fail at eval, closed)."""
        mods: List[Tuple[Any, Any]] = []
        while self.peek().kind == "name" and self.peek().value == "with":
            line = self.next().line
            target = self._parse_primary()
            if not isinstance(target, (Ref, Var)):
                raise RegoError(
                    f"rego: unsupported 'with' target at line {line}")
            if isinstance(target, Ref) and not all(isinstance(s, str) for s in target.path):
                raise RegoError(
                    f"rego: 'with' target path must be static at line {line}")
            a = self.expect("name")
            if a.value != "as":
                raise RegoError(f"rego parse error at line {a.line}: expected 'as'")
            mods.append((target, self._parse_term()))
        if not mods:
            return expr
        return WithExpr(expr, mods)

    def _parse_term(self) -> Any:
        # precedence: additive > multiplicative > unary > primary.
        # Arithmetic is numbers-only (OPA semantics); string concat is the
        # `concat` builtin.
        left = self._parse_mul()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("+", "-"):
                op = self.next().value
                left = ArithExpr(op, left, self._parse_mul())
            else:
                return left

    def _parse_mul(self) -> Any:
        left = self._parse_unary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("*", "/", "%"):
                op = self.next().value
                left = ArithExpr(op, left, self._parse_unary())
            else:
                return left

    def _parse_unary(self) -> Any:
        t = self.peek()
        if t.kind == "op" and t.value == "-":
            self.next()
            operand = self._parse_unary()
            if isinstance(operand, Const) and isinstance(operand.value, (int, float)) \
                    and not isinstance(operand.value, bool):
                return Const(-operand.value)  # fold literals: default x = -1
            return ArithExpr("-", operand, None)
        if t.kind == "op" and t.value == "(":
            self.next()
            inner = self._parse_term()
            self.expect("op", ")")
            return inner
        return self._parse_primary()

    def _parse_primary(self) -> Any:
        t = self.peek()
        if t.kind == "string":
            self.next()
            return Const(t.value)
        if t.kind == "number":
            self.next()
            return Const(t.value)
        if t.kind == "op" and t.value == "[":
            self.next()
            items = []
            first = True
            while not (self.peek().kind == "op" and self.peek().value == "]"):
                self.skip_newlines()
                items.append(self._parse_term())
                self.skip_newlines()
                if first and self.peek().kind == "op" and self.peek().value == "|":
                    # array comprehension: [head | body]
                    self.next()
                    body = self._parse_body(end="]")
                    self.expect("op", "]")
                    return Compr("array", items[0], body=body)
                first = False
                if self.peek().kind == "op" and self.peek().value == ",":
                    self.next()
            self.expect("op", "]")
            return ArrayLit(items)
        if t.kind == "op" and t.value == "{":
            self.next()
            items: List[Tuple[Any, Any]] = []
            first = True
            while not (self.peek().kind == "op" and self.peek().value == "}"):
                self.skip_newlines()
                key = self._parse_term()
                self.skip_newlines()
                if first and self.peek().kind == "op" and self.peek().value == "|":
                    # set comprehension: {head | body}
                    self.next()
                    body = self._parse_body()
                    self.expect("op", "}")
                    return Compr("set", key, body=body)
                self.expect("op", ":")
                val = self._parse_term()
                self.skip_newlines()
                if first and self.peek().kind == "op" and self.peek().value == "|":
                    # object comprehension: {key: head | body}
                    self.next()
                    body = self._parse_body()
                    self.expect("op", "}")
                    return Compr("object", val, key_head=key, body=body)
                items.append((key, val))
                first = False
                self.skip_newlines()
                if self.peek().kind == "op" and self.peek().value == ",":
                    self.next()
            self.expect("op", "}")
            return ObjectLit(items)
        if t.kind == "name":
            if t.value == "true":
                self.next()
                return Const(True)
            if t.value == "false":
                self.next()
                return Const(False)
            if t.value == "null":
                self.next()
                return Const(None)
            name = self._parse_dotted_call_or_ref()
            return name
        raise RegoError(f"rego parse error at line {t.line}: unexpected token {t.value!r}")

    def _parse_dotted_call_or_ref(self) -> Any:
        base = self.expect("name").value
        path: List[Any] = []
        fn_parts = [base]
        while True:
            t = self.peek()
            if t.kind == "op" and t.value == ".":
                self.next()
                nxt = self.expect("name")
                path.append(nxt.value)
                fn_parts.append(nxt.value)
            elif t.kind == "op" and t.value == "[":
                self.next()
                inner = self._parse_term()
                self.expect("op", "]")
                path.append(inner)
                fn_parts = []  # indexed refs are never function names
            elif t.kind == "op" and t.value == "(":
                self.next()
                args = []
                while not (self.peek().kind == "op" and self.peek().value == ")"):
                    args.append(self._parse_term())
                    if self.peek().kind == "op" and self.peek().value == ",":
                        self.next()
                self.expect("op", ")")
                fn = ".".join(fn_parts) if fn_parts else base
                call = CallExpr(fn, args)
                # postfix refs on the call result: sort(x)[0].name …
                while True:
                    t = self.peek()
                    if t.kind == "op" and t.value == ".":
                        self.next()
                        call.path.append(self.expect("name").value)
                    elif t.kind == "op" and t.value == "[":
                        self.next()
                        call.path.append(self._parse_term())
                        self.expect("op", "]")
                    else:
                        return call
            else:
                break
        if not path:
            return Var(base)
        return Ref(base, path)


# ---------------------------------------------------------------------------
# Evaluator
# ---------------------------------------------------------------------------

def _set_key(v: Any) -> Tuple:
    """Type-tagged dedup key for set semantics: bools must not conflate
    with numbers (Python 1 == True; OPA sets keep both), but 1 and 1.0 are
    the same JSON number."""
    if isinstance(v, bool):
        return ("b", v)
    if isinstance(v, (int, float)):
        return ("n", float(v))
    if isinstance(v, str):
        return ("s", v)
    return ("j", json.dumps(v, sort_keys=True, default=str))


_REGEX_CACHE: Dict[str, Any] = {}


def _regex_match(pattern: str, value: str) -> bool:
    """Search semantics (like Go MatchString / gjson `%`).  DFA lane first
    (linear time — OPA's RE2 guarantee against request-controlled values);
    Python re only for patterns outside the DFA subset and for values
    containing NUL, which the DFA reserves as padding (backtracking there —
    policy authors are semi-trusted, and NUL values are vanishingly rare).
    Acceptance is read from the FINAL state only, exactly like the device
    kernel's scan: `$`-anchored DFAs are not absorbing-accept."""
    ent = _REGEX_CACHE.get(pattern)
    if ent is None:
        from ...compiler.redfa import compile_regex_dfa

        ent = compile_regex_dfa(pattern)
        if ent is None:
            ent = re.compile(pattern)
        if len(_REGEX_CACHE) > 1024:
            _REGEX_CACHE.clear()
        _REGEX_CACHE[pattern] = ent
    raw = value.encode("utf-8")
    if isinstance(ent, re.Pattern) or 0 in raw:
        rx = ent if isinstance(ent, re.Pattern) else re.compile(pattern)
        return rx.search(value) is not None
    trans, accept, state = ent.trans, ent.accept, ent.start
    for b in raw:
        state = int(trans[state, b])
    return bool(accept[state])


_GLOB_CACHE: Dict[Tuple[str, Tuple[str, ...]], Any] = {}


def _glob_match(pattern: str, delimiters: Any, value: str) -> bool:
    """OPA glob.match (wraps gobwas/glob): ``*`` spans within a delimiter
    segment, ``**`` spans across, ``?`` is one non-delimiter character.
    ``null`` delimiters mean NO delimiters; an EMPTY array defaults to
    ``["."]`` (OPA >= 0.43 semantics)."""
    if isinstance(delimiters, list):
        delims = [str(d) for d in delimiters] or ["."]
    else:
        delims = []  # null: no delimiters — '*' spans everything
    key = (pattern, tuple(delims))
    rx = _GLOB_CACHE.get(key)
    if rx is None:
        delim_cls = "".join(re.escape(d) for d in delims)
        any_one = f"[^{delim_cls}]" if delim_cls else "."
        out = []
        i = 0
        while i < len(pattern):
            ch = pattern[i]
            if ch == "*":
                if i + 1 < len(pattern) and pattern[i + 1] == "*":
                    out.append(".*")
                    i += 2
                else:
                    out.append(f"{any_one}*")
                    i += 1
            elif ch == "?":
                out.append(any_one)
                i += 1
            else:
                out.append(re.escape(ch))
                i += 1
        # DOTALL: gobwas matches newlines wherever delimiters allow
        rx = re.compile("".join(out), re.S)
        if len(_GLOB_CACHE) < 4096:
            _GLOB_CACHE[key] = rx
    return rx.fullmatch(value) is not None


def _builtin(fn: str, args: List[Any]) -> Any:
    try:
        if fn == "count":
            return len(args[0])
        if fn == "json.marshal":
            # Go encoding/json marshals object keys sorted
            return json.dumps(args[0], separators=(",", ":"), sort_keys=True)
        if fn in ("base64.encode", "base64.decode", "base64url.encode",
                  "base64url.encode_no_pad", "base64url.decode",
                  "hex.encode", "hex.decode"):
            import base64 as _b64

            s = args[0]
            if fn == "base64.encode":
                return _b64.b64encode(s.encode()).decode()
            if fn == "base64.decode":
                return _b64.b64decode(s.encode()).decode()
            if fn == "base64url.encode":
                return _b64.urlsafe_b64encode(s.encode()).decode()
            if fn == "base64url.encode_no_pad":
                return _b64.urlsafe_b64encode(s.encode()).decode().rstrip("=")
            if fn == "base64url.decode":
                pad = s + "=" * (-len(s) % 4)  # OPA accepts unpadded input
                return _b64.urlsafe_b64decode(pad.encode()).decode()
            if fn == "hex.encode":
                return s.encode().hex()
            return bytes.fromhex(s).decode()
        if fn in ("crypto.md5", "crypto.sha1", "crypto.sha256"):
            import hashlib

            if not isinstance(args[0], str):
                raise RegoError(f"{fn}: operand must be a string")
            algo = fn.split(".", 1)[1]
            return getattr(hashlib, algo)(args[0].encode()).hexdigest()
        if fn == "units.parse_bytes":
            s = str(args[0]).strip().upper()
            m = re.fullmatch(r"([0-9.]+)\s*([KMGTPE]I?B?|B?)", s)
            if not m:
                raise RegoError(f"units.parse_bytes: cannot parse {s!r}")
            num, unit = float(m.group(1)), m.group(2)
            if unit.startswith(("K", "M", "G", "T", "P", "E")):
                exp = "KMGTPE".index(unit[0]) + 1
                base = 1024 if "I" in unit else 1000
                num *= base ** exp
            if not num.is_integer():
                raise RegoError("units.parse_bytes: fractional byte count")
            return int(num)
        if fn == "regex.split":
            # OPA regex.split(pattern, s) wraps Go regexp.Split: the result
            # never contains capture-group texts (Python re.split would
            # inject them, None included) — split by match spans instead
            rx = re.compile(args[0])
            s = args[1]
            out, last = [], 0
            for mo in rx.finditer(s):
                out.append(s[last:mo.start()])
                last = mo.end()
            out.append(s[last:])
            return out
        if fn == "regex.replace":
            # OPA regex.replace(s, pattern, value) wraps Go
            # ReplaceAllString.  Go Regexp.Expand semantics: $$ → "$",
            # $name/${name} with name = longest \w+ run resolved against
            # groups by number-or-name, and ANY unresolvable or unmatched
            # reference expands to "" (never an error) — so references are
            # resolved manually per match; re.sub's \g<> syntax would raise
            # on Go-legal refs like `$1x`.  Backslashes are literal in Go
            # templates; a function repl keeps them literal here too.
            s, pattern, value = args[0], args[1], args[2]

            def expand(mo, _tpl=value):
                out: List[str] = []
                i = 0
                while i < len(_tpl):
                    ch = _tpl[i]
                    if ch == "$" and i + 1 < len(_tpl):
                        if _tpl[i + 1] == "$":
                            out.append("$")
                            i += 2
                            continue
                        mg = re.match(r"\{(\w+)\}|(\w+)", _tpl[i + 1:])
                        if mg:
                            name = mg.group(1) or mg.group(2)
                            i += 1 + mg.end()
                            try:
                                g = mo.group(int(name) if name.isdigit() else name)
                            except (IndexError, re.error):
                                g = None
                            out.append(g or "")
                            continue
                    out.append(ch)
                    i += 1
                return "".join(out)

            return re.sub(pattern, expand, s)
        if fn == "time.parse_rfc3339_ns":
            # exact integer ns: float timestamp math would corrupt sub-µs
            # digits (and fromisoformat silently truncates past 6)
            from datetime import datetime

            s = str(args[0])
            m = re.fullmatch(r"([^.]*)(?:\.(\d+))?(Z|[+-]\d{2}:\d{2})", s)
            if not m:
                raise RegoError(f"invalid RFC3339 timestamp: {s!r}")
            base, frac, tz = m.group(1), m.group(2) or "", m.group(3)
            dt = datetime.fromisoformat(base + tz.replace("Z", "+00:00"))
            return (int(dt.timestamp()) * 10**9
                    + int((frac + "000000000")[:9]))
        if fn == "contains":
            return args[1] in args[0]
        if fn == "startswith":
            return str(args[0]).startswith(str(args[1]))
        if fn == "endswith":
            return str(args[0]).endswith(str(args[1]))
        if fn == "lower":
            return str(args[0]).lower()
        if fn == "upper":
            return str(args[0]).upper()
        if fn == "split":
            return str(args[0]).split(str(args[1]))
        if fn == "concat":
            return str(args[0]).join(str(x) for x in args[1])
        if fn == "trim":
            return str(args[0]).strip(str(args[1]))
        if fn == "trim_prefix":
            s, p = str(args[0]), str(args[1])
            return s[len(p):] if s.startswith(p) else s
        if fn == "trim_suffix":
            s, p = str(args[0]), str(args[1])
            return s[: -len(p)] if p and s.endswith(p) else s
        if fn == "replace":
            return str(args[0]).replace(str(args[1]), str(args[2]))
        if fn == "sprintf":
            return str(args[0]) % tuple(args[1])
        if fn == "to_number":
            v = args[0]
            return float(v) if "." in str(v) else int(v)
        if fn == "abs":
            return abs(args[0])
        if fn == "max":
            return max(args[0])
        if fn == "min":
            return min(args[0])
        if fn == "sum":
            return sum(args[0])
        if fn == "object.get":
            return args[0].get(args[1], args[2]) if isinstance(args[0], dict) else args[2]
        if fn == "array.concat":
            return list(args[0]) + list(args[1])
        if fn == "json.unmarshal":
            return json.loads(args[0])
        if fn in ("regex.match", "re_match"):
            return _regex_match(str(args[0]), str(args[1]))
        if fn == "indexof":
            return str(args[0]).find(str(args[1]))
        if fn == "substring":
            s, off, length = str(args[0]), int(args[1]), int(args[2])
            if off < 0:
                # OPA errors on negative offsets (expression undefined →
                # rule fails); slicing from the end would fail OPEN on the
                # common substring(s, indexof(s, x), n) miss
                raise RegoError("substring: negative offset")
            return s[off:] if length < 0 else s[off:off + length]
        if fn == "sort":
            return sorted(args[0])
        if fn == "time.now_ns":
            import time as _time

            return _time.time_ns()
        if fn == "is_null":
            return args[0] is None
        if fn == "is_string":
            return isinstance(args[0], str)
        if fn == "is_boolean":
            return isinstance(args[0], bool)
        if fn == "is_number":
            return isinstance(args[0], (int, float)) and not isinstance(args[0], bool)
        if fn == "is_array":
            return isinstance(args[0], list)
        if fn == "is_object":
            return isinstance(args[0], dict)
        if fn == "object.keys":
            # OPA returns a set; sets serialize as deduped arrays here
            return list(args[0].keys())
        if fn == "object.union":
            return _merge_docs(args[0], args[1])
        if fn == "object.remove":
            drop = set(args[1]) if isinstance(args[1], list) else set(args[1].keys())
            return {k: v for k, v in args[0].items() if k not in drop}
        if fn == "object.filter":
            keep = set(args[1]) if isinstance(args[1], list) else set(args[1].keys())
            return {k: v for k, v in args[0].items() if k in keep}
        if fn == "numbers.range":
            for x in args[:2]:
                if isinstance(x, bool) or not (
                    isinstance(x, int) or (isinstance(x, float) and x.is_integer())
                ):
                    raise RegoError("numbers.range: operands must be integers")
            a, b = int(args[0]), int(args[1])
            step = 1 if b >= a else -1
            return list(range(a, b + step, step))  # OPA: inclusive both ends
        if fn == "array.slice":
            arr, lo, hi = list(args[0]), int(args[1]), int(args[2])
            # OPA clamps out-of-range indexes instead of erroring
            lo, hi = max(lo, 0), min(hi, len(arr))
            return arr[lo:hi] if hi > lo else []
        if fn == "array.reverse":
            return list(reversed(args[0]))
        if fn == "strings.reverse":
            return str(args[0])[::-1]
        if fn == "format_int":
            base = int(args[1])
            digs = {2: "{0:b}", 8: "{0:o}", 10: "{0:d}", 16: "{0:x}"}.get(base)
            if digs is None:
                raise RegoError(f"format_int: unsupported base {base}")
            return digs.format(int(args[0]))
        if fn == "union":
            out, seen = [], set()
            for coll in args[0]:
                for v in coll:
                    k = _set_key(v)
                    if k not in seen:
                        seen.add(k)
                        out.append(v)
            return out
        if fn == "intersection":
            colls = list(args[0])
            if not colls:
                return []
            keys = set.intersection(*[{_set_key(v) for v in c} for c in colls])
            out, seen = [], set()
            for v in colls[0]:
                k = _set_key(v)
                if k in keys and k not in seen:
                    seen.add(k)
                    out.append(v)
            return out
        if fn == "glob.match":
            return _glob_match(str(args[0]), args[1], str(args[2]))
    except RegoError:
        raise
    except Exception as e:
        raise RegoError(f"rego builtin {fn} failed: {e}")
    raise RegoError(f"rego: unsupported builtin {fn!r}")


# every name _builtin dispatches on (function-mock targets must name one of
# these or a user function); `walk` is the relation handled in _eval_expr
_BUILTIN_NAMES = frozenset({
    "abs", "array.concat", "array.reverse", "array.slice",
    "base64.decode", "base64.encode", "base64url.decode", "base64url.encode",
    "base64url.encode_no_pad", "concat", "contains", "count",
    "crypto.md5", "crypto.sha1", "crypto.sha256", "endswith",
    "format_int", "glob.match", "hex.decode", "hex.encode", "indexof",
    "intersection", "is_array", "is_boolean", "is_null", "is_number",
    "is_object", "is_string", "json.marshal", "json.unmarshal", "lower",
    "max", "min", "numbers.range", "object.filter", "object.get",
    "object.keys", "object.remove", "object.union", "regex.match",
    "regex.replace", "regex.split", "re_match", "replace", "sort", "split",
    "sprintf", "startswith", "strings.reverse", "substring", "sum",
    "time.now_ns", "time.parse_rfc3339_ns", "to_number", "trim",
    "trim_prefix", "trim_suffix", "union", "units.parse_bytes", "upper",
    "walk",
})


def _walk_doc(x: Any, prefix: List[Any]) -> Iterator[Tuple[List[Any], Any]]:
    """OPA walk/2: every (path, value) pair of the nested document,
    including ([], x) itself."""
    yield (list(prefix), x)
    if isinstance(x, dict):
        for k, v in x.items():
            prefix.append(k)
            yield from _walk_doc(v, prefix)
            prefix.pop()
    elif isinstance(x, list):
        for i, v in enumerate(x):
            prefix.append(i)
            yield from _walk_doc(v, prefix)
            prefix.pop()


def _dotted_name(term: Any) -> Optional[str]:
    """The static dotted name a Var/Ref spells, or None."""
    if isinstance(term, Var):
        return term.name
    if isinstance(term, Ref) and all(isinstance(s, str) for s in term.path):
        return ".".join([term.base] + list(term.path))
    return None


class _Evaluator:
    def __init__(self, module: RegoModule, input_doc: Any, data: Any = None,
                 mocks: Optional[Dict[Any, Any]] = None,
                 registry: Optional[Dict[str, RegoModule]] = None,
                 in_progress: Optional[set] = None,
                 sib_cache: Optional[Dict[str, "_Evaluator"]] = None):
        self.module = module
        self.input = input_doc
        self.data = data if data is not None else {}
        # function mocks from enclosing `with` scopes:
        # key → ("const", value) | ("func", replacement name)
        self.mocks: Dict[Any, Any] = mocks or {}
        # package → module, spanning the whole module set (multi-module)
        if registry is None:
            registry = {module.package: module, **module.siblings}
            for sib in module.siblings.values():
                registry.setdefault(sib.package, sib)
        self.registry = registry
        self._cache: Dict[str, Any] = {}
        # recursion guard spans modules: keys are (package, rule name)
        self._in_progress: set = in_progress if in_progress is not None else set()
        self._func_depth = 0
        # one evaluator per package within this with-scope (shared caches)
        self._sib: Dict[str, "_Evaluator"] = sib_cache if sib_cache is not None else {}
        self._sib.setdefault(module.package, self)

    def _sibling(self, pkg: str) -> "_Evaluator":
        ev = self._sib.get(pkg)
        if ev is None:
            ev = _Evaluator(self.registry[pkg], self.input, data=self.data,
                            mocks=self.mocks, registry=self.registry,
                            in_progress=self._in_progress, sib_cache=self._sib)
        return ev

    def rule_value(self, name: str) -> Any:
        if name in self._cache:
            return self._cache[name]
        guard = (self.module.package, name)
        if guard in self._in_progress:
            raise RegoError(f"rego: recursive rule {name!r}")
        self._in_progress.add(guard)
        try:
            result = _UNDEFINED
            defs = self.module.rules.get(name, [])
            if defs and defs[0].is_set:
                # partial set rule: union of head values over every
                # satisfying binding of every definition (empty set when
                # nothing matches — defined, like OPA)
                out: List[Any] = []
                seen: set = set()
                for rule in defs:
                    for bindings in self._eval_body(rule.body, {}):
                        # the head may itself iterate (banned[x[_]]): every
                        # value of every binding joins the set
                        for v in self._term_values(rule.value, bindings):
                            if v is _UNDEFINED:
                                continue
                            key = _set_key(v)
                            if key not in seen:
                                seen.add(key)
                                out.append(v)
                self._cache[name] = out
                return out
            for rule in defs:
                result = self._def_value(rule.value, rule.body, rule.else_chain)
                if result is not _UNDEFINED:
                    break
            if result is _UNDEFINED and name in self.module.defaults:
                result = _const_value(self.module.defaults[name])
            self._cache[name] = result
            return result
        finally:
            self._in_progress.discard(guard)

    def _def_value(self, value: Any, body: List[Any],
                   else_chain: List[Tuple[Any, List[Any]]],
                   bindings: Optional[Dict[str, Any]] = None) -> Any:
        """One rule/function definition: the primary body's value, else the
        first else-chain element whose body is satisfiable (OPA: else blocks
        evaluate strictly in order)."""
        for val, bd in [(value, body)] + else_chain:
            for b in self._eval_body(bd, dict(bindings) if bindings else {}):
                vals = list(self._term_values(val, b))
                if vals:
                    return vals[0]
        return _UNDEFINED

    def call_function(self, name: str, args: List[Any]) -> Any:
        """User-defined function call: definitions tried in order; Var
        params bind, Const params must unify (OPA functions).  Undefined
        when no definition matches."""
        defs = self.module.funcs.get(name)
        if defs is None:
            return _UNDEFINED
        if self._func_depth > 64:
            raise RegoError(f"rego: recursion in function {name!r}")
        self._func_depth += 1
        try:
            for fd in defs:
                if len(fd.params) != len(args):
                    continue
                bindings: Dict[str, Any] = {}
                ok = True
                for p, a in zip(fd.params, args):
                    if isinstance(p, Var):
                        if p.name == "_":
                            continue
                        if p.name in bindings:  # repeated param: must unify
                            if bindings[p.name] != a:
                                ok = False
                                break
                        else:
                            bindings[p.name] = a
                    elif isinstance(p, Const):
                        if p.value != a:
                            ok = False
                            break
                if not ok:
                    continue
                v = self._def_value(fd.value, fd.body, fd.else_chain, bindings)
                if v is not _UNDEFINED:
                    return v
            return _UNDEFINED
        finally:
            self._func_depth -= 1

    # --- body evaluation: yields satisfying binding dicts (existential) ---

    def _eval_body(self, body: List[Any], bindings: Dict[str, Any]) -> Iterator[Dict[str, Any]]:
        if not body:
            yield bindings
            return
        head, rest = body[0], body[1:]
        for b in self._eval_expr(head, bindings):
            yield from self._eval_body(rest, b)

    def _eval_expr(self, expr: Any, bindings: Dict[str, Any]) -> Iterator[Dict[str, Any]]:
        if isinstance(expr, SomeDecl):
            yield bindings  # declaration only
            return
        if isinstance(expr, WithExpr):
            # document AND function mocking: overlay input/data and/or
            # override functions, then re-evaluate the wrapped expression in
            # a FRESH evaluator — rules it references must recompute under
            # the mocks (OPA `with` scoping)
            new_input, new_data = self.input, self.data
            new_mocks = dict(self.mocks)
            for target, vterm in expr.mods:
                path = list(target.path) if isinstance(target, Ref) else []
                base = target.base if isinstance(target, Ref) else target.name
                tname = _dotted_name(target)
                fkey = self._func_key(tname) if base != "input" else None
                if fkey is not None:
                    # function/builtin mock: replacement is a function name
                    # (user func or builtin) or a constant value
                    rname = _dotted_name(vterm)
                    if rname is not None and self._func_key(rname) is not None \
                            and rname not in bindings:
                        new_mocks[fkey] = ("func", rname)
                    else:
                        val = next(self._term_values(vterm, bindings), _UNDEFINED)
                        if val is _UNDEFINED:
                            return
                        new_mocks[fkey] = ("const", val)
                    continue
                val = next(self._term_values(vterm, bindings), _UNDEFINED)
                if val is _UNDEFINED:
                    return
                if base == "input":
                    new_input = _overlay(new_input, path, val)
                elif base == "data":
                    new_data = _overlay(new_data, path, val)
                else:
                    raise RegoError(
                        f"rego: unknown 'with' target {tname!r} "
                        "(not an input/data path or function)")
            child = _Evaluator(self.module, new_input, data=new_data,
                               mocks=new_mocks, registry=self.registry,
                               # the recursion guards span the whole
                               # with-chain: a cycle through mocked documents
                               # is still a cycle (OPA rejects recursion
                               # statically; we fail closed at eval)
                               in_progress=set(self._in_progress))
            child._func_depth = self._func_depth
            yield from child._eval_expr(expr.expr, bindings)
            return
        if isinstance(expr, NotExpr):
            # negation as failure: succeeds iff inner has no satisfying binding
            for _ in self._eval_expr(expr.expr, dict(bindings)):
                return
            yield bindings
            return
        if isinstance(expr, BinExpr):
            if expr.op in (":=", "="):
                # bind-if-var, else compare
                if isinstance(expr.left, Var) and expr.left.name not in bindings and expr.left.name != "_":
                    for v in self._term_values(expr.right, bindings):
                        nb = dict(bindings)
                        nb[expr.left.name] = v
                        yield nb
                    return
                for lv in self._term_values(expr.left, bindings):
                    for rv in self._term_values(expr.right, bindings):
                        if lv == rv:
                            yield bindings
                            return
                return
            for lv in self._term_values(expr.left, bindings):
                for rv in self._term_values(expr.right, bindings):
                    if self._compare(expr.op, lv, rv):
                        yield bindings
                        return
            return
        if isinstance(expr, EveryExpr):
            for hay in self._term_values(expr.domain, bindings):
                if isinstance(hay, list):
                    pairs = list(enumerate(hay))
                elif isinstance(hay, dict):
                    pairs = list(hay.items())
                else:
                    continue  # non-collection domain: undefined
                ok = True
                for k, v in pairs:
                    nb = dict(bindings)
                    if expr.key is not None:
                        nb[expr.key] = k
                    nb[expr.val] = v
                    if next(self._eval_body(expr.body, nb), None) is None:
                        ok = False
                        break
                if ok:  # incl. the vacuous empty-domain case
                    yield bindings
                    return
            return
        if isinstance(expr, SomeInExpr):
            for hay in self._term_values(expr.domain, bindings):
                if isinstance(hay, list):
                    pairs = list(enumerate(hay))
                elif isinstance(hay, dict):
                    pairs = list(hay.items())
                else:
                    continue  # non-collection domain: undefined
                for k, v in pairs:
                    nb = dict(bindings)
                    if expr.key != "_":
                        nb[expr.key] = k
                    if expr.val != "_":
                        nb[expr.val] = v
                    yield nb
            return
        if isinstance(expr, InExpr):
            for hay in self._term_values(expr.haystack, bindings):
                items = hay if isinstance(hay, list) else (
                    list(hay.values()) if isinstance(hay, dict) else []
                )
                if isinstance(expr.needle, Var) and expr.needle.name not in bindings and expr.needle.name != "_":
                    for item in items:
                        nb = dict(bindings)
                        nb[expr.needle.name] = item
                        yield nb
                    return
                for nv in self._term_values(expr.needle, bindings):
                    if nv in items:
                        yield bindings
                        return
            return
        if (isinstance(expr, CallExpr) and expr.fn == "walk"
                and len(expr.args) == 2 and not expr.path
                and self.mocks.get(("B", "walk")) is None):
            # walk(x, [path, value]) — the relation enumerates every nested
            # (path, value) pair; the output pattern unifies per pair
            for x in self._term_values(expr.args[0], bindings):
                for pair_path, pair_val in _walk_doc(x, []):
                    nb = self._unify(expr.args[1], [pair_path, pair_val], bindings)
                    if nb is not None:
                        yield nb
            return
        # bare term: truthy & defined
        for v in self._term_values(expr, bindings):
            if v is not _UNDEFINED and v is not False and v is not None:
                yield bindings
                return
        return

    def _unify(self, pat: Any, val: Any,
               bindings: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Unify a term pattern against a concrete value: Vars bind (or must
        match when already bound), array literals unify element-wise,
        anything else evaluates and compares.  Returns the extended bindings
        or None."""
        if isinstance(pat, Var):
            if pat.name == "_":
                return bindings
            if pat.name in bindings:
                return bindings if bindings[pat.name] == val else None
            nb = dict(bindings)
            nb[pat.name] = val
            return nb
        if isinstance(pat, ArrayLit):
            if not isinstance(val, list) or len(val) != len(pat.items):
                return None
            nb = bindings
            for p, v in zip(pat.items, val):
                nb = self._unify(p, v, nb)
                if nb is None:
                    return None
            return nb
        got = next(self._term_values(pat, bindings), _UNDEFINED)
        return bindings if got is not _UNDEFINED and got == val else None

    @staticmethod
    def _compare(op: str, a: Any, b: Any) -> bool:
        try:
            if op == "==":
                return a == b
            if op == "!=":
                return a != b
            if op == "<":
                return a < b
            if op == "<=":
                return a <= b
            if op == ">":
                return a > b
            if op == ">=":
                return a >= b
        except TypeError:
            return False
        raise RegoError(f"rego: unsupported operator {op!r}")

    # --- term evaluation: yields possible values (iteration over [_]) ---

    def _term_values(self, term: Any, bindings: Dict[str, Any]) -> Iterator[Any]:
        if isinstance(term, Const):
            yield term.value
        elif isinstance(term, Var):
            if term.name in bindings:
                yield bindings[term.name]
            elif term.name == "input":
                yield self.input
            elif term.name in self.module.rules or term.name in self.module.defaults:
                v = self.rule_value(term.name)
                if v is not _UNDEFINED:
                    yield v
            else:
                raise RegoError(f"rego: unsafe variable {term.name!r}")
        elif isinstance(term, ArrayLit):
            yield [next(self._term_values(i, bindings), _UNDEFINED) for i in term.items]
        elif isinstance(term, ObjectLit):
            yield {
                next(self._term_values(k, bindings), None): next(
                    self._term_values(v, bindings), None
                )
                for k, v in term.items
            }
        elif isinstance(term, ArithExpr):
            def check_num(v):
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    raise RegoError(f"arithmetic on non-number: {v!r}")

            op = term.op
            # iterate ALL operand values — ref[_] existential semantics
            # flow through arithmetic exactly like through comparisons
            for a in self._term_values(term.left, bindings):
                check_num(a)
                if term.right is None:  # unary minus
                    yield -a
                    continue
                for b in self._term_values(term.right, bindings):
                    check_num(b)
                    try:
                        if op == "+":
                            yield a + b
                        elif op == "-":
                            yield a - b
                        elif op == "*":
                            yield a * b
                        elif op == "/":
                            # OPA number division: 3/2 == 1.5, 4/2 == 2
                            yield _exact_div(a, b)
                        else:  # %
                            if isinstance(a, float) or isinstance(b, float):
                                raise RegoError("modulo on non-integer")
                            # Go big.Int.Rem (truncated): sign of the
                            # DIVIDEND — Python % floors toward the divisor
                            r = abs(a) % abs(b)
                            yield r if a >= 0 else -r
                    except ZeroDivisionError:
                        raise RegoError("divide by zero")
        elif isinstance(term, Compr):
            if term.kind == "object":
                obj: Dict[Any, Any] = {}
                for b in self._eval_body(term.body, dict(bindings)):
                    k = next(self._term_values(term.key_head, b), _UNDEFINED)
                    v = next(self._term_values(term.head, b), _UNDEFINED)
                    if k is not _UNDEFINED and v is not _UNDEFINED:
                        if k in obj and obj[k] != v:
                            # OPA: conflicting keys are an eval error →
                            # deny; last-write-wins would fail OPEN
                            raise RegoError(
                                f"object comprehension: conflicting values for key {k!r}"
                            )
                        obj[k] = v
                yield obj
            else:
                out: List[Any] = []
                seen: set = set()
                for b in self._eval_body(term.body, dict(bindings)):
                    v = next(self._term_values(term.head, b), _UNDEFINED)
                    if v is _UNDEFINED:
                        continue
                    if term.kind == "set":
                        key = _set_key(v)
                        if key in seen:
                            continue
                        seen.add(key)
                    out.append(v)
                yield out
        elif isinstance(term, CallExpr):
            arg_vals = [next(self._term_values(a, bindings), _UNDEFINED) for a in term.args]
            if _UNDEFINED in arg_vals:
                return
            result = self._call(term.fn, arg_vals)
            if result is _UNDEFINED:
                return  # no definition matched: the call is undefined
            if term.path:
                yield from self._walk_path([result], term.path, bindings)
            else:
                yield result
        elif isinstance(term, Ref):
            yield from self._ref_values(term, bindings)
        elif isinstance(term, (BinExpr, NotExpr, InExpr)):
            # expression used as a term: true iff satisfiable
            sat = next(self._eval_expr(term, dict(bindings)), None)
            yield sat is not None
        else:
            raise RegoError(f"rego: cannot evaluate term {term!r}")

    def _resolve_func(self, fn: str) -> Optional[Tuple[str, str]]:
        """(package, local name) of a user function, or None.  Bare names
        resolve in the calling module; data.<pkg>.<fn> across the module
        set (multi-module composition)."""
        if fn in self.module.funcs:
            return (self.module.package, fn)
        if fn.startswith("data."):
            rest = fn[5:]
            for pkg in sorted(self.registry, key=len, reverse=True):
                if rest.startswith(pkg + "."):
                    name = rest[len(pkg) + 1:]
                    if name in self.registry[pkg].funcs:
                        return (pkg, name)
        return None

    def _func_key(self, fn: Optional[str]) -> Optional[Tuple]:
        """Normalized mock key for a function-ish name: user functions key
        by (package, name) so `f` and `data.<pkg>.f` share one mock;
        builtins key by their dotted name.  None when `fn` names neither."""
        if fn is None:
            return None
        rf = self._resolve_func(fn)
        if rf is not None:
            return ("F",) + rf
        if fn in _BUILTIN_NAMES:
            return ("B", fn)
        return None

    def _call(self, fn: str, args: List[Any],
              _seen: Optional[set] = None) -> Any:
        """Dispatch a call through mocks → user functions (any module) →
        builtins.  ``_seen`` tracks mock keys already followed so a mock
        chain that cycles (directly or mutually: ``with f as g with g as
        f``) fails closed as a RegoError instead of recursing unboundedly."""
        key = self._func_key(fn)
        if key is not None:
            mock = self.mocks.get(key)
            if mock is not None:
                if mock[0] == "const":
                    return mock[1]
                seen = _seen if _seen is not None else set()
                if key in seen:
                    raise RegoError(
                        f"rego: 'with' mock cycle through {fn!r}")
                seen.add(key)
                return self._call(mock[1], args, _seen=seen)
        rf = self._resolve_func(fn)
        if rf is not None:
            pkg, name = rf
            ev = self if pkg == self.module.package else self._sibling(pkg)
            return ev.call_function(name, args)
        return _builtin(fn, args)

    def _ref_values(self, ref: Ref, bindings: Dict[str, Any]) -> Iterator[Any]:
        if ref.base == "input":
            roots = [self.input]
        elif ref.base in bindings:
            roots = [bindings[ref.base]]
        elif ref.base in self.module.rules or ref.base in self.module.defaults:
            v = self.rule_value(ref.base)
            roots = [] if v is _UNDEFINED else [v]
        elif ref.base == "data":
            yield from self._data_values(ref.path, bindings)
            return
        else:
            raise RegoError(f"rego: unsafe variable {ref.base!r}")

        yield from self._walk_path(roots, ref.path, bindings)

    def _package_document(self) -> Dict[str, Any]:
        doc: Dict[str, Any] = {}
        for name in self.module.rules:
            v = self.rule_value(name)
            if v is not _UNDEFINED:
                doc[name] = v
        for name, default in self.module.defaults.items():
            if name not in doc:
                doc[name] = _const_value(default)
        return doc

    def _data_values(self, path: List[Any], bindings: Dict[str, Any]) -> Iterator[Any]:
        """``data.*`` resolution across the module SET: every package's
        document mounts at data.<package> (virtual documents — rules
        re-evaluate on demand, visible from ancestor refs like OPA's nested
        data tree, shadowing external data on conflicts); everything else
        walks the external data tree handed to evaluate() (the OPA
        embedded-library equivalent of compiled packages + loaded data,
        ref pkg/evaluators/authorization/opa.go:86-141)."""
        if all(isinstance(s, str) for s in path):
            # a rule inside a package: the deepest matching package wins
            for pkg_str in sorted(self.registry, key=len, reverse=True):
                pkg = pkg_str.split(".")
                if len(path) > len(pkg) and path[:len(pkg)] == pkg:
                    ev = self._sibling(pkg_str)
                    name = path[len(pkg)]
                    if name in ev.module.rules or name in ev.module.defaults:
                        v = ev.rule_value(name)
                        if v is not _UNDEFINED:
                            yield from self._walk_path([v], path[len(pkg) + 1:],
                                                       bindings)
                        return
            # a package subtree: nest every package document under `path`,
            # deep-merged, virtual docs winning over external data
            contrib: Any = None
            for pkg_str in self.registry:
                pkg = pkg_str.split(".")
                if len(pkg) >= len(path) and pkg[:len(path)] == path:
                    sub: Any = self._sibling(pkg_str)._package_document()
                    for part in reversed(pkg[len(path):]):
                        sub = {part: sub}
                    contrib = sub if contrib is None else _merge_docs(contrib, sub)
            if contrib is not None:
                ext = next(self._walk_path([self.data], list(path), bindings),
                           _UNDEFINED)
                if isinstance(ext, dict):
                    contrib = _merge_docs(ext, contrib)
                yield contrib
                return
        yield from self._walk_path([self.data], path, bindings)

    def _walk_path(self, values: List[Any], path: List[Any],
                   bindings: Dict[str, Any]) -> Iterator[Any]:
        """Ref-path walk over candidate values (shared by Ref bases and
        postfix refs on call results)."""
        if not path:
            yield from values
            return
        seg, rest = path[0], path[1:]
        for v in values:
            if isinstance(seg, str):
                if isinstance(v, dict) and seg in v:
                    yield from self._walk_path([v[seg]], rest, bindings)
            elif isinstance(seg, Var) and seg.name == "_":
                items = v if isinstance(v, list) else (
                    list(v.values()) if isinstance(v, dict) else []
                )
                for item in items:
                    yield from self._walk_path([item], rest, bindings)
            else:
                for key in self._term_values(seg, bindings):
                    if isinstance(v, list) and isinstance(key, (int, float)):
                        i = int(key)
                        if 0 <= i < len(v):
                            yield from self._walk_path([v[i]], rest, bindings)
                    elif isinstance(v, dict) and key in v:
                        yield from self._walk_path([v[key]], rest, bindings)


def compile_module(rego_src: str, package: str = "policy") -> RegoModule:
    """Parse + validate a policy (the reconcile-time analog of OPA's
    PrepareForEval, ref: pkg/evaluators/authorization/opa.go:141)."""
    module = _Parser(_lex(rego_src)).parse_module()
    if package and module.package == "policy":
        module.package = package
    return module
