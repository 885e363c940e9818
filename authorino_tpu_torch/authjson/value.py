"""JSON value / template engine — the structural equivalent of the
reference's pkg/json (ref: pkg/json/json.go:28-158).

A ``JSONValue`` is either a static value or a selector *pattern*; a pattern
that mixes literal text with ``{selector}`` placeholders is a template
(heuristic mirrored from ref pkg/json/json.go:55-61).  Resolution happens
against the live Authorization-JSON object, never a marshaled string.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, List

from . import selector

__all__ = ["JSONValue", "JSONProperty", "replace_placeholders", "stringify_json", "is_template"]

_ALL_BRACES = re.compile(r"{")
_MODIFIER_BRACES = re.compile(r"[^@]+@\w+:{")


def is_template(pattern: str) -> bool:
    """True when at least one ``{`` opens a variable placeholder rather than
    a modifier argument (ref: pkg/json/json.go:59-61)."""
    return len(_MODIFIER_BRACES.findall(pattern)) != len(_ALL_BRACES.findall(pattern))


def replace_placeholders(source: str, doc: Any) -> str:
    """Substitute ``{selector}`` placeholders with gjson-String() values;
    byte-level state machine mirrored from ref pkg/json/json.go:96-151
    (``\\{`` escapes a literal brace, nested braces inside a placeholder are
    passed through to the selector, e.g. modifier args)."""
    replaced: List[str] = []
    buffer: List[str] = []
    escaping = False
    inside = False
    nested = 0
    for ch in source:
        if ch == "{":
            if escaping:
                replaced.append(ch)
            elif inside:
                buffer.append(ch)
                nested += 1
            else:
                inside = True
            escaping = False
        elif ch == "}":
            if inside:
                if nested > 0:
                    buffer.append(ch)
                    nested -= 1
                else:
                    if buffer:
                        replaced.append(selector.get(doc, "".join(buffer)).string())
                        buffer = []
                    inside = False
            else:
                replaced.append(ch)
            escaping = False
        elif ch == "\\":
            if inside:
                buffer.append(ch)
            else:
                if escaping:
                    replaced.append(ch)
                escaping = not escaping
        else:
            if inside:
                buffer.append(ch)
            else:
                replaced.append(ch)
            escaping = False
    return "".join(replaced)


def stringify_json(data: Any) -> str:
    """Marshal then render with gjson-String() semantics: strings come out
    unquoted, objects/arrays as raw JSON (ref: pkg/json/json.go:153-159)."""
    return selector.Result(data).string()


@dataclass
class JSONValue:
    """static | selector | template (ref: pkg/json/json.go:29-53)."""

    static: Any = None
    pattern: str = ""

    def resolve_for(self, doc: Any) -> Any:
        if self.pattern:
            if is_template(self.pattern):
                return replace_placeholders(self.pattern, doc)
            return selector.get(doc, self.pattern).py()
        return self.static

    def resolve_str(self, doc: Any) -> str:
        return stringify_json(self.resolve_for(doc))

    @classmethod
    def from_spec(cls, value: Any = None, sel: str = "") -> "JSONValue":
        return cls(static=value, pattern=sel or "")


@dataclass
class JSONProperty:
    name: str
    value: JSONValue
