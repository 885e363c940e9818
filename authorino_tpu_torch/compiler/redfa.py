"""Regex → byte-level DFA compiler for the device regex lane.

The reference evaluates ``matches`` patterns with Go's RE2 engine per request
— recompiling the regex every call (ref: pkg/jsonexp/expressions.go:85-91).
Here a supported subset compiles ONCE (reconcile time) into dense DFA
transition tables evaluated on device by a `lax.scan` over value bytes
(ops/pattern_eval.py); unsupported patterns fall back to the precompiled
CPU regex lane, preserving exact semantics.

Supported subset (RE2-safe, byte-oriented):
  - literals (UTF-8 bytes), ``.`` (any byte except \\n, like RE2 default)
  - escapes: \\d \\D \\w \\W \\s \\S and escaped metacharacters
  - char classes ``[a-z0-9_]`` with ranges and negation (ASCII only)
  - ``* + ? {m} {m,} {m,n}`` (bounded counts ≤ 16 to bound state blowup)
  - alternation ``|``, groups ``(...)`` (non-capturing semantics)
  - anchors ``^`` (leading) and ``$`` (trailing) only

Matching is *search* semantics like Go's MatchString: unanchored patterns
get an implicit leading self-loop and absorbing accept states.  Byte 0 is
reserved as padding (identity transitions); values containing NUL ride the
CPU lane.  DFAs are capped at MAX_STATES; larger ones fall back.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

import numpy as np

__all__ = ["DFA", "compile_regex_dfa", "MAX_STATES"]

MAX_STATES = 96
MAX_REPEAT = 16
ANY_EXCEPT_NL = frozenset(range(1, 256)) - {10}


@dataclass
class DFA:
    trans: np.ndarray    # [S, 256] uint8 — state transition table
    accept: np.ndarray   # [S] bool
    start: int

    @property
    def n_states(self) -> int:
        return int(self.trans.shape[0])


# ---------------------------------------------------------------------------
# Parse to NFA fragments (Thompson construction)
# ---------------------------------------------------------------------------

class _Unsupported(Exception):
    pass


class _NFA:
    def __init__(self):
        # transitions: state → byte → set(states); eps: state → set(states)
        self.trans: List[Dict[int, Set[int]]] = []
        self.eps: List[Set[int]] = []

    def new_state(self) -> int:
        self.trans.append({})
        self.eps.append(set())
        if len(self.trans) > 4 * MAX_STATES:
            raise _Unsupported("nfa too large")
        return len(self.trans) - 1

    def add(self, s: int, byte_set: FrozenSet[int], t: int):
        for b in byte_set:
            self.trans[s].setdefault(b, set()).add(t)

    def add_eps(self, s: int, t: int):
        self.eps[s].add(t)


_CLASS_ESCAPES = {
    "d": frozenset(range(ord("0"), ord("9") + 1)),
    "w": frozenset(
        list(range(ord("a"), ord("z") + 1))
        + list(range(ord("A"), ord("Z") + 1))
        + list(range(ord("0"), ord("9") + 1))
        + [ord("_")]
    ),
    "s": frozenset(b" \t\n\r\f\v"),
}
_META = set("\\^$.|?*+()[]{}")


class _Parser:
    """Recursive descent over the pattern producing an NFA fragment."""

    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0
        self.nfa = _NFA()

    def peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def next(self) -> str:
        c = self.p[self.i]
        self.i += 1
        return c

    # fragment = (start, end) with eps-connected internals
    def parse_alternation(self) -> Tuple[int, int]:
        frags = [self.parse_concat()]
        while self.peek() == "|":
            self.next()
            frags.append(self.parse_concat())
        if len(frags) == 1:
            return frags[0]
        s, e = self.nfa.new_state(), self.nfa.new_state()
        for fs, fe in frags:
            self.nfa.add_eps(s, fs)
            self.nfa.add_eps(fe, e)
        return s, e

    def parse_concat(self) -> Tuple[int, int]:
        frags: List[Tuple[int, int]] = []
        while self.peek() is not None and self.peek() not in "|)":
            frags.append(self.parse_repeat())
        if not frags:
            s = self.nfa.new_state()
            return s, s
        for (a_s, a_e), (b_s, b_e) in zip(frags, frags[1:]):
            self.nfa.add_eps(a_e, b_s)
        return frags[0][0], frags[-1][1]

    def parse_repeat(self) -> Tuple[int, int]:
        frag = self.parse_atom()
        while self.peek() in ("*", "+", "?", "{"):
            c = self.peek()
            if c == "{":
                frag = self._counted(frag)
            else:
                self.next()
                frag = self._quantify(frag, c)
            if self.peek() == "?":  # non-greedy flag — same language for DFA
                self.next()
        return frag

    def _quantify(self, frag, kind: str) -> Tuple[int, int]:
        fs, fe = frag
        s, e = self.nfa.new_state(), self.nfa.new_state()
        self.nfa.add_eps(s, fs)
        self.nfa.add_eps(fe, e)
        if kind in ("*", "?"):
            self.nfa.add_eps(s, e)
        if kind in ("*", "+"):
            self.nfa.add_eps(fe, fs)
        return s, e

    def _counted(self, frag) -> Tuple[int, int]:
        # {m} {m,} {m,n}: re-parse the atom text and splice copies
        start_i = self.i
        self.next()  # '{'
        num = ""
        while self.peek() is not None and self.peek() != "}":
            num += self.next()
        if self.peek() != "}":
            raise _Unsupported("unterminated {...}")
        self.next()
        parts = num.split(",")
        try:
            m = int(parts[0])
            n = int(parts[1]) if len(parts) > 1 and parts[1] else (m if len(parts) == 1 else -1)
        except ValueError:
            raise _Unsupported(f"bad repeat {num!r}")
        if m > MAX_REPEAT or (n > MAX_REPEAT):
            raise _Unsupported("repeat count too large")
        # splicing copies requires re-generating the atom — instead interpret
        # {m,n} by chaining: atom{m} then (atom?){n-m}, or atom{m}atom* for open
        # ranges.  We need fresh copies of the atom fragment, so capture the
        # atom's pattern slice and re-parse it.
        atom_text = self._last_atom_text
        def make():
            sub = _Parser(atom_text)
            sub.nfa = self.nfa
            frag2 = sub.parse_alternation()
            if sub.i != len(atom_text):
                raise _Unsupported("counted repeat parse error")
            return frag2
        s = self.nfa.new_state()
        cur = s
        for _ in range(m):
            fs, fe = make()
            self.nfa.add_eps(cur, fs)
            cur = fe
        if n == -1:  # {m,}
            fs, fe = make()
            self.nfa.add_eps(cur, fs)
            self.nfa.add_eps(fe, fs)
            self.nfa.add_eps(fe, cur)
            e = self.nfa.new_state()
            self.nfa.add_eps(cur, e)
            self.nfa.add_eps(fe, e)
            return s, e
        e = self.nfa.new_state()
        self.nfa.add_eps(cur, e) if n >= m else None
        for _ in range(max(0, n - m)):
            fs, fe = make()
            self.nfa.add_eps(cur, fs)
            cur = fe
            self.nfa.add_eps(cur, e)
        self.nfa.add_eps(cur, e)
        return s, e

    def parse_atom(self) -> Tuple[int, int]:
        start_i = self.i
        c = self.peek()
        if c is None:
            raise _Unsupported("dangling quantifier")
        if c == "(":
            self.next()
            if self.peek() == "?":
                # only (?:...) groups supported
                self.next()
                if self.peek() != ":":
                    raise _Unsupported("lookaround / named groups unsupported")
                self.next()
            frag = self.parse_alternation()
            if self.peek() != ")":
                raise _Unsupported("unbalanced parens")
            self.next()
            self._last_atom_text = self.p[start_i:self.i]
            return frag
        if c == "[":
            byte_set = self._parse_class()
            frag = self._byte_frag(byte_set)
            self._last_atom_text = self.p[start_i:self.i]
            return frag
        if c == ".":
            self.next()
            frag = self._byte_frag(ANY_EXCEPT_NL)
            self._last_atom_text = "."
            return frag
        if c == "\\":
            self.next()
            e = self.next() if self.peek() is not None else ""
            frag = self._byte_frag(self._escape_set(e))
            self._last_atom_text = "\\" + e
            return frag
        if c in "^$":
            raise _Unsupported("inner anchors unsupported")
        if c in "*+?{":
            raise _Unsupported("dangling quantifier")
        self.next()
        encoded = c.encode("utf-8")
        if len(encoded) == 1:
            frag = self._byte_frag(frozenset([encoded[0]]))
        else:
            # multi-byte literal: chain of byte transitions
            s = self.nfa.new_state()
            cur = s
            for b in encoded:
                nxt = self.nfa.new_state()
                self.nfa.add(cur, frozenset([b]), nxt)
                cur = nxt
            frag = (s, cur)
        self._last_atom_text = c
        return frag

    def _escape_set(self, e: str) -> FrozenSet[int]:
        if e in _CLASS_ESCAPES:
            return _CLASS_ESCAPES[e]
        if e in ("D", "W", "S"):
            return frozenset(range(1, 256)) - _CLASS_ESCAPES[e.lower()]
        if e == "n":
            return frozenset([10])
        if e == "t":
            return frozenset([9])
        if e == "r":
            return frozenset([13])
        if e in "".join(sorted(_META)) or not e.isalnum():
            encoded = e.encode("utf-8")
            if len(encoded) == 1:
                return frozenset([encoded[0]])
        if len(e) == 1 and not e.isalnum():
            return frozenset([ord(e)])
        raise _Unsupported(f"escape \\{e} unsupported")

    def _byte_frag(self, byte_set: FrozenSet[int]) -> Tuple[int, int]:
        if 0 in byte_set:
            byte_set = byte_set - {0}  # byte 0 is the pad symbol
        s, e = self.nfa.new_state(), self.nfa.new_state()
        self.nfa.add(s, byte_set, e)
        return s, e

    def _parse_class(self) -> FrozenSet[int]:
        self.next()  # '['
        negate = False
        if self.peek() == "^":
            negate = True
            self.next()
        out: Set[int] = set()
        first = True
        while True:
            c = self.peek()
            if c is None:
                raise _Unsupported("unterminated class")
            if c == "]" and not first:
                self.next()
                break
            first = False
            if c == "\\":
                self.next()
                e = self.next()
                out |= self._escape_set(e)
                continue
            self.next()
            b = c.encode("utf-8")
            if len(b) > 1:
                raise _Unsupported("non-ascii class")
            lo = b[0]
            if self.peek() == "-" and self.i + 1 < len(self.p) and self.p[self.i + 1] != "]":
                self.next()
                hi_c = self.next()
                hb = hi_c.encode("utf-8")
                if len(hb) > 1:
                    raise _Unsupported("non-ascii class")
                out |= set(range(lo, hb[0] + 1))
            else:
                out.add(lo)
        if negate:
            return frozenset(range(1, 256)) - frozenset(out)
        return frozenset(out)


# ---------------------------------------------------------------------------
# NFA → DFA (subset construction)
# ---------------------------------------------------------------------------

def _eps_closure(nfa: _NFA, states: FrozenSet[int]) -> FrozenSet[int]:
    stack = list(states)
    seen = set(states)
    while stack:
        s = stack.pop()
        for t in nfa.eps[s]:
            if t not in seen:
                seen.add(t)
                stack.append(t)
    return frozenset(seen)


# process-wide determinization memo: subset construction is the most
# expensive compile step, and reconcile-time snapshot rebuilds re-lower the
# same patterns over and over.  The per-compile dfa_cache (compiler/
# compile.py) spans one corpus; this memo spans the process, so a snapshot
# swap re-determinizes nothing.  DFAs are immutable once built (the
# compiler copies their tables into the dense tensors), so sharing one
# object across snapshots is safe — and it is exactly what lets the
# compiler's table dedup collapse identical patterns to one [S, 256] table.
_DFA_MEMO: Dict[str, Optional[DFA]] = {}
_DFA_MEMO_MAX = 8192
_DFA_MEMO_MISS = object()


def compile_regex_dfa(pattern: str) -> Optional[DFA]:
    """Compile to a DFA, or None when the pattern is outside the subset /
    exceeds MAX_STATES (caller falls back to the CPU regex lane).
    Memoized per process (patterns repeat across snapshot generations)."""
    hit = _DFA_MEMO.get(pattern, _DFA_MEMO_MISS)
    if hit is not _DFA_MEMO_MISS:
        return hit
    dfa = _compile_regex_dfa(pattern)
    if len(_DFA_MEMO) >= _DFA_MEMO_MAX:  # unbounded hostile corpora: reset
        _DFA_MEMO.clear()
    _DFA_MEMO[pattern] = dfa
    return dfa


def _compile_regex_dfa(pattern: str) -> Optional[DFA]:
    anchored_start = pattern.startswith("^")
    anchored_end = pattern.endswith("$") and not pattern.endswith("\\$")
    body = pattern[1 if anchored_start else 0 : len(pattern) - (1 if anchored_end else 0)]
    try:
        parser = _Parser(body)
        frag_s, frag_e = parser.parse_alternation()
        if parser.i != len(body):
            return None
        nfa = parser.nfa
        accept_state = nfa.new_state()
        nfa.add_eps(frag_e, accept_state)
        start_set = _eps_closure(nfa, frozenset([frag_s]))

        # subset construction; unanchored start = self-loop on every byte
        dfa_states: Dict[FrozenSet[int], int] = {start_set: 0}
        order: List[FrozenSet[int]] = [start_set]
        trans_rows: List[np.ndarray] = []
        i = 0
        while i < len(order):
            cur = order[i]
            row = np.zeros(256, dtype=np.int64)
            cur_accepting = accept_state in cur
            for b in range(1, 256):
                if cur_accepting and not anchored_end:
                    # absorbing accept (search semantics: match found)
                    nxt = cur
                else:
                    targets: Set[int] = set()
                    for s in cur:
                        targets |= nfa.trans[s].get(b, set())
                    if not anchored_start:
                        targets |= set(start_set)  # implicit leading .*
                    nxt = _eps_closure(nfa, frozenset(targets)) if targets else frozenset()
                if nxt not in dfa_states:
                    dfa_states[nxt] = len(order)
                    order.append(nxt)
                    if len(order) > MAX_STATES:
                        return None
                row[b] = dfa_states[nxt]
            row[0] = i  # pad byte: identity self-loop
            trans_rows.append(row)
            i += 1
        trans = np.stack(trans_rows).astype(np.uint8 if len(order) <= 256 else np.uint16)
        accept = np.array([accept_state in st for st in order], dtype=bool)
        return DFA(trans=trans, accept=accept, start=0)
    except _Unsupported:
        return None
    except RecursionError:
        return None
