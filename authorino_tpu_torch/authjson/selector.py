"""gjson-style selector engine over parsed (dict/list) JSON documents.

The reference resolves every selector through `gjson.Get` over a *marshaled*
Authorization JSON string (ref: pkg/jsonexp/expressions.go:61,
pkg/json/json.go:48) — re-marshaling the whole document per evaluator read
(ref: pkg/service/auth_pipeline.go:542-579).  TPU-first redesign: we keep the
Authorization JSON as a live Python object and resolve paths structurally;
raw-JSON text is materialised only at modifier boundaries, which is what the
gjson modifier contract requires (modifiers receive and return raw JSON,
ref: pkg/json/json.go:161-248).

Supported path syntax (the subset exercised by the reference's CRDs, docs and
tests):
  - dot-separated keys, ``\\.`` escapes a literal dot inside a key
  - integer segments index arrays
  - ``#`` yields array length when final, else maps over elements
  - ``#(field==value)`` queries (first match), ``#(...)#`` (all matches),
    with operators ``== != < <= > >= % !%``
  - ``|`` pipe: identical to ``.`` on plain paths; after a ``#`` mapping a
    piped segment applies to the COLLECTED array instead of mapping per
    element (``a.#.b|0`` → first of the mapped values — gjson's
    array-vs-pipe distinction)
  - multipaths ``{a.b,"name":c}`` (object) and ``[a.b,c]`` (array)
    composition; missing members are omitted
  - modifiers ``@name`` / ``@name:arg`` — reference's custom set
    ``@extract @replace @case @base64 @strip`` (ref: pkg/json/json.go:259-263)
    plus the cheap gjson builtins ``@this @keys @values @flatten @reverse
    @join @tostr @fromstr @valid @ugly``
"""

from __future__ import annotations

import base64
import json
import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "Result", "get", "get_path", "num_str", "to_raw_json", "parse_raw",
    "WALK_MISS", "compile_walk", "render_value",
]

WALK_MISS = object()  # compile_walk's missing-value sentinel


def render_value(v: Any) -> str:
    """gjson Result.String() of a resolved value (WALK_MISS → missing).
    The single source of the rendering rules — Result.string() and the
    compiled pattern closures (expressions/ast.py) both delegate here."""
    if v is WALK_MISS or v is None:
        return ""
    if v is True:
        return "true"
    if v is False:
        return "false"
    t = type(v)  # exact-type ladder first: the hot shapes, no MRO walk
    if t is str:
        return v
    if t is int or t is float:
        return num_str(v)
    if isinstance(v, str):
        return v
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return num_str(v)
    return to_raw_json(v)


def compile_walk(path: str) -> Optional[Callable[[Any], Any]]:
    """A doc→value walker for plain dot-paths (the overwhelmingly common
    selector shape), or None when the path needs the full gjson engine
    (multipaths, ``#`` maps, queries, modifiers).  get()'s fast lane and the
    compiled pattern closures share this walker — missing resolves to
    WALK_MISS."""
    if path == "":
        return lambda doc: doc
    if path[0] in "{[":
        return None
    segs = _parse_path(path)
    if not all(s.kind == "key" for s in segs):
        return None
    keys = tuple(s.key for s in segs)

    def walk(doc, _keys=keys, _MISS=WALK_MISS):
        cur = doc
        for key in _keys:
            if isinstance(cur, dict):
                if key in cur:
                    cur = cur[key]
                else:
                    return _MISS
            elif isinstance(cur, list):
                try:
                    idx = int(key)
                except ValueError:
                    return _MISS
                if 0 <= idx < len(cur):
                    cur = cur[idx]
                else:
                    return _MISS
            else:
                return _MISS
        return cur

    return walk


def num_str(x) -> str:
    """Render a JSON number the way gjson's Result.String() does."""
    if isinstance(x, bool):  # guard: bool is an int subclass in Python
        return "true" if x else "false"
    if isinstance(x, int):
        return str(x)
    if isinstance(x, float):
        if x != x or x in (float("inf"), float("-inf")):
            return str(x)
        if x == int(x) and abs(x) < 1e16:
            return str(int(x))
        return repr(x)
    return str(x)


def to_raw_json(value: Any) -> str:
    """Compact raw-JSON text of a Python JSON value (no spaces)."""
    return json.dumps(value, separators=(",", ":"), ensure_ascii=False)


def parse_raw(raw: str) -> Any:
    """Lenient raw-JSON parse: invalid input degrades to a plain string,
    matching gjson's tolerance (e.g. the reference's @extract returns the
    bare text ``n`` on out-of-range pos — ref: pkg/json/json.go:181)."""
    try:
        return json.loads(raw)
    except Exception:
        s = raw.strip()
        if len(s) >= 2 and s[0] == '"' and s[-1] == '"':
            return s[1:-1]
        return raw


class Result:
    """Mirror of the gjson.Result surface the reference relies on:
    String() / Value() / Array() / Exists() semantics."""

    __slots__ = ("value", "exists")

    def __init__(self, value: Any = None, exists: bool = True):
        self.value = value
        self.exists = exists

    MISSING: "Result"

    def string(self) -> str:
        if not self.exists:
            return ""
        return render_value(self.value)

    def py(self) -> Any:
        return self.value if self.exists else None

    def array(self) -> List["Result"]:
        """gjson: a JSON array yields its elements; null/missing yields [];
        any other scalar yields a single-element list of itself."""
        if not self.exists or self.value is None:
            return []
        if isinstance(self.value, list):
            return [Result(e) for e in self.value]
        return [self]

    def raw(self) -> str:
        if not self.exists:
            return ""
        return to_raw_json(self.value)

    def __repr__(self):
        return f"Result({self.value!r}, exists={self.exists})"


Result.MISSING = Result(None, exists=False)


# ---------------------------------------------------------------------------
# Path parsing
# ---------------------------------------------------------------------------

@dataclass
class _Seg:
    kind: str  # "key" | "hash" | "query" | "mod"
    key: str = ""
    # query parts
    q_field: str = ""
    q_op: str = ""
    q_value: Any = None
    q_all: bool = False
    # modifier parts
    mod_name: str = ""
    mod_arg: str = ""
    # leading separator was '|': after a `#` mapping, a piped segment
    # applies to the COLLECTED array instead of mapping per element
    # (gjson's array-vs-pipe distinction)
    piped: bool = False


_PATH_CACHE: Dict[str, Tuple[_Seg, ...]] = {}


def _split_segments(path: str) -> List[str]:
    # parens only: plain-path keys may contain braces/brackets literally
    return _depth0_split(path, ".|", opens="(", closes=")")


_QUERY_RE = re.compile(r"^#\((.*)\)(#?)$", re.S)
_QUERY_COND_RE = re.compile(r"^\s*([^!<>=%\s]+)\s*(==|!=|<=|>=|<|>|!%|%)\s*(.*)$", re.S)


def _parse_query(text: str, all_matches: bool) -> _Seg:
    m = _QUERY_COND_RE.match(text)
    if not m:
        # bare existence query: #(field)
        return _Seg(kind="query", q_field=text.strip(), q_op="", q_all=all_matches)
    field, op, raw_val = m.group(1), m.group(2), m.group(3).strip()
    val: Any
    if raw_val.startswith('"') and raw_val.endswith('"') and len(raw_val) >= 2:
        val = raw_val[1:-1]
    elif raw_val in ("true", "false"):
        val = raw_val == "true"
    elif raw_val == "null":
        val = None
    else:
        try:
            val = int(raw_val)
        except ValueError:
            try:
                val = float(raw_val)
            except ValueError:
                val = raw_val
    return _Seg(kind="query", q_field=field.strip(), q_op=op, q_value=val, q_all=all_matches)


def _parse_path(path: str) -> Tuple[_Seg, ...]:
    cached = _PATH_CACHE.get(path)
    if cached is not None:
        return cached
    segs: List[_Seg] = []
    parts, seps = _depth0_split(path, ".|", opens="(", closes=")", with_delims=True)
    for raw_seg, sep in zip(parts, seps):
        if raw_seg == "":
            continue
        piped = sep == "|"
        if raw_seg.startswith("@"):
            name, _, arg = raw_seg[1:].partition(":")
            segs.append(_Seg(kind="mod", mod_name=name, mod_arg=arg, piped=piped))
        elif raw_seg == "#":
            segs.append(_Seg(kind="hash", piped=piped))
        elif raw_seg.startswith("#("):
            m = _QUERY_RE.match(raw_seg)
            if m:
                q = _parse_query(m.group(1), m.group(2) == "#")
                q.piped = piped
                segs.append(q)
            else:
                segs.append(_Seg(kind="key", key=raw_seg, piped=piped))
        else:
            segs.append(_Seg(kind="key", key=raw_seg.replace("\\.", ".").replace("\\\\", "\\"), piped=piped))
    out = tuple(segs)
    if len(_PATH_CACHE) < 65536:
        _PATH_CACHE[path] = out
    return out


# ---------------------------------------------------------------------------
# Query evaluation
# ---------------------------------------------------------------------------

def _query_match(elem: Any, seg: _Seg) -> bool:
    r = _resolve(Result(elem), _parse_path(seg.q_field)) if seg.q_field else Result(elem)
    if seg.q_op == "":
        return r.exists
    if not r.exists:
        return False
    a, b = r.value, seg.q_value
    if seg.q_op == "==":
        return _loose_eq(a, b)
    if seg.q_op == "!=":
        return not _loose_eq(a, b)
    if seg.q_op == "%":
        return _wildcard_match(r.string(), str(b))
    if seg.q_op == "!%":
        return not _wildcard_match(r.string(), str(b))
    try:
        if isinstance(a, str) or isinstance(b, str):
            a2, b2 = r.string(), str(b)
            return {"<": a2 < b2, "<=": a2 <= b2, ">": a2 > b2, ">=": a2 >= b2}[seg.q_op]
        return {"<": a < b, "<=": a <= b, ">": a > b, ">=": a >= b}[seg.q_op]
    except TypeError:
        return False


def _loose_eq(a: Any, b: Any) -> bool:
    if isinstance(a, bool) or isinstance(b, bool):
        return a is b or a == b
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return float(a) == float(b)
    return a == b


def _wildcard_match(s: str, pat: str) -> bool:
    rx = "^" + ".*".join(re.escape(p) for p in pat.split("*")) + "$"
    rx = rx.replace(re.escape("?"), ".")
    return re.match(rx, s) is not None


# ---------------------------------------------------------------------------
# Modifiers (reference custom set: pkg/json/json.go:161-263)
# ---------------------------------------------------------------------------

def _mod_extract(raw: str, arg: str) -> str:
    sep, pos = " ", 0
    if arg:
        parsed = parse_raw(arg)
        if isinstance(parsed, dict):
            sep = str(parsed.get("sep", " "))
            p = parsed.get("pos", 0)
            if isinstance(p, (int, float)):
                pos = int(p)
    s = Result(parse_raw(raw)).string()
    # Go strings.Split with "" splits per rune; Python str.split("") raises
    parts = list(s) if sep == "" else s.split(sep)
    if pos >= len(parts):
        return "n"  # quirk preserved from ref pkg/json/json.go:181
    return json.dumps(parts[pos], ensure_ascii=False)


def _mod_replace(raw: str, arg: str) -> str:
    if not arg:
        return raw
    parsed = parse_raw(arg)
    old = str(parsed.get("old", "")) if isinstance(parsed, dict) else ""
    new = str(parsed.get("new", "")) if isinstance(parsed, dict) else ""
    s = Result(parse_raw(raw)).string()
    return json.dumps(s.replace(old, new), ensure_ascii=False)


def _mod_case(raw: str, arg: str) -> str:
    # gjson hands the *raw* JSON to the modifier; the reference upper/lower-cases
    # the raw text directly (ref: pkg/json/json.go:208-216).
    if arg == "upper":
        return raw.upper()
    if arg == "lower":
        return raw.lower()
    return raw


def _mod_base64(raw: str, arg: str) -> str:
    s = Result(parse_raw(raw)).string()
    if arg == "encode":
        return json.dumps(base64.b64encode(s.encode()).decode(), ensure_ascii=False)
    if arg == "decode":
        data = b""
        if len(s) % 4 == 0:
            try:
                data = base64.b64decode(s, validate=False)
                return json.dumps(data.decode("utf-8", "replace"), ensure_ascii=False)
            except Exception:
                pass
        try:
            data = base64.b64decode(s + "=" * (-len(s) % 4))
        except Exception:
            data = b""
        return json.dumps(data.decode("utf-8", "replace"), ensure_ascii=False)
    return raw


def _mod_strip(raw: str, arg: str) -> str:
    # The reference strips non-printable runes from the raw JSON
    # (ref: pkg/json/json.go:239-248); since our raw text escapes control
    # characters, apply the strip to the string value for the same effect.
    v = parse_raw(raw)
    if isinstance(v, str):
        return json.dumps("".join(ch for ch in v if ch.isprintable()), ensure_ascii=False)
    return "".join(ch for ch in raw if ch.isprintable())


def _mod_join(raw: str, arg: str) -> str:
    v = parse_raw(raw)
    if isinstance(v, list):
        merged: Dict[str, Any] = {}
        for e in v:
            if isinstance(e, dict):
                merged.update(e)
        return to_raw_json(merged)
    return raw


_SIMPLE_MODS: Dict[str, Callable[[Any, str], Any]] = {
    "this": lambda v, a: v,
    "keys": lambda v, a: list(v.keys()) if isinstance(v, dict) else [],
    "values": lambda v, a: list(v.values()) if isinstance(v, dict) else [],
    "reverse": lambda v, a: v[::-1] if isinstance(v, list) else v,
    "flatten": lambda v, a: [x for e in v for x in (e if isinstance(e, list) else [e])]
    if isinstance(v, list) else v,
    "tostr": lambda v, a: to_raw_json(v),
    "fromstr": lambda v, a: parse_raw(v) if isinstance(v, str) else v,
    "valid": lambda v, a: v,
    "ugly": lambda v, a: v,
    "pretty": lambda v, a: v,
}

_RAW_MODS: Dict[str, Callable[[str, str], str]] = {
    "extract": _mod_extract,
    "replace": _mod_replace,
    "case": _mod_case,
    "base64": _mod_base64,
    "strip": _mod_strip,
    "join": _mod_join,
}


def _apply_modifier(res: Result, seg: _Seg) -> Result:
    fn = _RAW_MODS.get(seg.mod_name)
    if fn is not None:
        raw = res.raw() if res.exists else ""
        return Result(parse_raw(fn(raw, seg.mod_arg)))
    sfn = _SIMPLE_MODS.get(seg.mod_name)
    if sfn is not None:
        if not res.exists:
            return Result.MISSING
        return Result(sfn(res.value, seg.mod_arg))
    return Result.MISSING  # unknown modifier


# ---------------------------------------------------------------------------
# Core resolution
# ---------------------------------------------------------------------------

def _fan_out(elems: List[Any], rest: Tuple[_Seg, ...]) -> Result:
    """Map the remaining path over array elements (used by `#` and `#(...)#`);
    modifiers in the tail apply to the collected array, not per element."""
    cut = next(
        (j for j, s in enumerate(rest) if s.kind == "mod" or s.piped),
        len(rest),
    )
    inner, tail = rest[:cut], rest[cut:]
    collected = []
    for e in elems:
        r = _resolve(Result(e), inner) if inner else Result(e)
        if r.exists:
            collected.append(r.value)
    out = Result(collected)
    return _resolve(out, tail) if tail else out


def _resolve(root: Result, segs: Tuple[_Seg, ...]) -> Result:
    cur = root
    i = 0
    n = len(segs)
    while i < n:
        seg = segs[i]
        if seg.kind == "mod":
            cur = _apply_modifier(cur, seg)
            i += 1
            continue
        if not cur.exists:
            return Result.MISSING
        v = cur.value
        if seg.kind == "hash":
            if not isinstance(v, list):
                return Result.MISSING
            if i == n - 1:
                return Result(len(v))
            return _fan_out(v, segs[i + 1:])
        if seg.kind == "query":
            if not isinstance(v, list):
                return Result.MISSING
            if seg.q_all:
                hits = [e for e in v if _query_match(e, seg)]
                rest = segs[i + 1:]
                if rest:
                    # gjson: a #(...)# query fans the remaining path out over
                    # the matched elements, like the `#` segment does
                    return _fan_out(hits, rest)
                cur = Result(hits)
            else:
                hit = next((e for e in v if _query_match(e, seg)), _SENTINEL)
                if hit is _SENTINEL:
                    return Result.MISSING
                cur = Result(hit)
            i += 1
            continue
        # key segment
        key = seg.key
        if isinstance(v, dict):
            if key in v:
                cur = Result(v[key])
            else:
                return Result.MISSING
        elif isinstance(v, list):
            try:
                idx = int(key)
            except ValueError:
                return Result.MISSING
            if 0 <= idx < len(v):
                cur = Result(v[idx])
            else:
                return Result.MISSING
        else:
            return Result.MISSING
        i += 1
    return cur


class _Sentinel:
    pass


_SENTINEL = _Sentinel()


# plain-key fast lane: path → tuple of keys when every segment is a key
# (the overwhelming majority of selectors in real AuthConfigs), else False.
# Walking raw values skips the per-step Result allocation of _resolve —
# this sits on the per-pattern hot path of the CPU expression oracle.
_FAST_CACHE: Dict[str, Any] = {}


def _depth0_split(text: str, delims: str, opens: str = "{[(",
                  closes: str = "}])", with_delims: bool = False):
    """Split ``text`` on depth-0 delimiter characters, respecting
    backslash escapes, double quotes, and bracket nesting — the one scanner
    shared by segment and multipath splitting.  ``with_delims=True`` also
    returns the delimiter character preceding each part (parts[0] → '')."""
    parts: List[str] = []
    seps: List[str] = [""]
    buf: List[str] = []
    depth = 0
    in_quote = False
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == "\\" and i + 1 < n:
            buf.append(c)
            buf.append(text[i + 1])
            i += 2
            continue
        if c == '"':
            in_quote = not in_quote
        elif not in_quote:
            if c in opens:
                depth += 1
            elif c in closes:
                depth -= 1
        if c in delims and depth == 0 and not in_quote:
            parts.append("".join(buf))
            seps.append(c)
            buf = []
        else:
            buf.append(c)
        i += 1
    parts.append("".join(buf))
    return (parts, seps) if with_delims else parts


def _split_multipath(body: str) -> List[str]:
    return [p.strip() for p in _depth0_split(body, ",") if p.strip()]


def _default_mp_key(path: str) -> str:
    """gjson: the default object key of a multipath member is the last
    PLAIN path component — modifiers/hash/query segments are skipped
    (``a.b.username|@case:upper`` keys as ``username``)."""
    segs = _split_segments(path)
    for seg in reversed(segs):
        if seg and not seg.startswith("@") and not seg.startswith("#"):
            return seg.replace("\\.", ".")
    return (segs[-1] if segs else path).replace("\\.", ".")


# keyed object-multipath members: a quoted string or a bare word followed by
# ':'.  Restricting bare keys to word characters keeps modifier arguments
# (`@case:upper`) and query operators out of key position.
_MP_QUOTED_KEY = re.compile(r'^"((?:[^"\\]|\\.)*)"\s*:\s*(.+)$', re.S)
_MP_BARE_KEY = re.compile(r"^([A-Za-z0-9_\-]+)\s*:\s*(.+)$", re.S)


def _split_mp_key(member: str) -> Tuple[Optional[str], str]:
    m = _MP_QUOTED_KEY.match(member)
    if m:
        return m.group(1).replace('\\"', '"'), m.group(2).strip()
    m = _MP_BARE_KEY.match(member)
    if m:
        return m.group(1), m.group(2).strip()
    return None, member


# parsed multipath members, cached like _PATH_CACHE — multipaths ride the
# same per-request hot path as plain selectors
_MP_CACHE: Dict[str, Tuple[bool, List[Tuple[Optional[str], str]]]] = {}


def _multipath(doc: Any, path: str) -> Result:
    """gjson multipaths: ``{a.b,"name":c,count:d.#}`` builds an object,
    ``[a.b,c]`` builds an array; missing members are omitted
    (gjson multipath semantics — the composition feature of its
    path syntax)."""
    parsed = _MP_CACHE.get(path)
    if parsed is None:
        is_obj = path[0] == "{"
        members = [_split_mp_key(m) for m in _split_multipath(path[1:-1])]
        parsed = (is_obj, members)
        if len(_MP_CACHE) < 65536:
            _MP_CACHE[path] = parsed
    is_obj, members = parsed
    if is_obj:
        out_obj: Dict[str, Any] = {}
        for key, sub in members:
            r = get(doc, sub)
            if r.exists:
                out_obj[key if key is not None else _default_mp_key(sub)] = r.value
        return Result(out_obj)
    out_arr: List[Any] = []
    for _, sub in members:
        r = get(doc, sub)
        if r.exists:
            out_arr.append(r.value)
    return Result(out_arr)


def _mp_prefix_end(path: str) -> int:
    """Index of the bracket closing ``path[0]`` (quotes/escapes honored);
    -1 when unbalanced."""
    depth = 0
    in_quote = False
    i, n = 0, len(path)
    while i < n:
        c = path[i]
        if c == "\\" and i + 1 < n:
            i += 2
            continue
        if c == '"':
            in_quote = not in_quote
        elif not in_quote:
            if c in "{[(":
                depth += 1
            elif c in "}])":
                depth -= 1
                if depth == 0:
                    return i
        i += 1
    return -1


def get(doc: Any, path: str) -> Result:
    """Resolve ``path`` against a parsed JSON document (the structural
    equivalent of gjson.Get over marshaled text, ref: pkg/jsonexp/expressions.go:61)."""
    if path == "":
        return Result(doc)
    if path[0] in "{[":
        end = _mp_prefix_end(path)
        if end == len(path) - 1:
            return _multipath(doc, path)
        if end > 0 and path[end + 1] in ".|":
            # multipath result piped onward (modifiers, sub-paths):
            # {a,b}|@values, [a,b].0 …
            base = _multipath(doc, path[: end + 1])
            return _resolve(base, _parse_path(path[end + 2:]))
        return Result.MISSING  # unbalanced multipath
    fast = _FAST_CACHE.get(path)
    if fast is None:
        fast = compile_walk(path) or False
        if len(_FAST_CACHE) < 65536:
            _FAST_CACHE[path] = fast
    if fast is False:
        return _resolve(Result(doc), _parse_path(path))
    v = fast(doc)
    return Result.MISSING if v is WALK_MISS else Result(v)


def get_path(doc: Any, path: str) -> Any:
    return get(doc, path).py()
