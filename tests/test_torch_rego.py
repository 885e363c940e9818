"""The port's inline OPA/Rego against the JAX package's, on the CPU.

- Interpreter: every Rego source of the reference's ``TestRego*`` and
  ``TestOPAEvaluator`` classes (``tests/test_evaluators.py``), copied here
  as data, goes through both packages' ``compile_module(...).evaluate`` on
  120 documents each, drawn from a numpy seed with missing keys, empty
  strings, odd header values and values of every JSON type.  Results are
  equal (tolerance 0: every result is JSON), and so are compile and
  evaluation errors, by type and message.  ``time.now_ns`` reads a pinned
  clock.
- Lowering: every ``LOWERABLE`` / ``NOT_LOWERABLE`` policy of
  ``tests/test_rego_lower.py`` and every policy of the OPA corpus lowers
  to a ``str``-equal expression in both packages, or to None in both, and
  the lowered expressions compile to equal corpora.
- The kernel slot: translated OPA configs installed in the port's engine
  on the CPU (the kernel's plain version) and in the reference engine
  (fused lane, interpret mode) give equal rule and skipped bits for every
  slot, and the lowered slot's bit equals the interpreter's ``allow``; the
  kernel's per-config program carries the lowered slots (the CPU
  interpreter of the v3 program equals the plain version and the JAX
  package's interpret-mode Pallas kernel, byte for byte).
"""

import asyncio
import copy
import json
import re

import numpy as np
import pytest

from authorino_tpu.evaluators.authorization import rego as r_rego
from authorino_tpu.evaluators.authorization import rego_lower as r_lower
from authorino_tpu_torch.authjson import build_authorization_json
from authorino_tpu_torch.authjson.wellknown import (CheckRequestModel,
                                                    HttpRequestAttributes,
                                                    PeerAttributes)
from authorino_tpu_torch.compiler.compile import NUMERIC_OPS, OP_REGEX_DFA
from authorino_tpu_torch.evaluators.authorization import rego as p_rego
from authorino_tpu_torch.evaluators.authorization import rego_lower as p_lower
from authorino_tpu_torch.models import opa_corpus

from test_rego_lower import LOWERABLE, NOT_LOWERABLE
from test_torch_compiler import PORT as PORT_C
from test_torch_compiler import REF as REF_C
from test_torch_compiler import assert_same_policy, batch_of
from test_torch_fused_kernel import reference_packed
from test_torch_own_program import both_params, interpret, plain
from test_torch_pipeline import PORT, REF, engine_of, port_request_to, run

DOCS_PER_POLICY = 120
PINNED_NS = 1_785_369_600_123_456_789

# ---- the sources: tests/test_evaluators.py, TestRego* and TestOPAEvaluator --
# name -> (source, package, data documents to draw from)

_ALLOW = "default allow = false\n"


def _val(expr):
    """``TestRegoBuiltinsRound3._val``'s module."""
    return f"package t\nv := {expr}"


SOURCES = {
    "basic_allow": ("""
        default allow = false
        allow { input.auth.identity.role == "admin" }
        allow { input.request.method == "GET"; input.request.path == "/public" }
        """, "policy", None),
    "iteration_and_builtins": ("""
        default allow = false
        allow { input.roles[_] == "admin" }
        allow { startswith(input.path, "/public/") }
        """, "policy", None),
    "bindings_and_value_rules": ("""
        default allow = false
        user := input.identity.username
        allow { user == "john" }
        greeting = msg { msg := sprintf("hello %s", [user]) }
        """, "policy", None),
    "not_and_in": ("""
        default allow = false
        allow { not denied; "gold" in input.tiers }
        denied { input.banned == true }
        """, "policy", None),
    "unsupported_default": ("default x = input.y", "policy", None),
    "unknown_with_target": (
        "allow { count([1]) == 1 with nosuch as 3 }", "policy", None),
    "dangling_else": ("else = true { input.y }", "policy", None),
    "else_chain_ordered": ("""
        default access = "none"
        access = "admin" { input.user == "root" }
        else = "write" { input.tier == "gold" }
        else = "read" { input.known }
        """, "policy", None),
    "else_bare_value_and_v1_if": ("""
        allow { input.x == 1 }
        else { input.y == 2 }
        level := 3 if input.n > 10
        else := 2 if input.n > 5
        else := 1
        """, "policy", None),
    "else_rejected_on_partial_set": (
        's contains "a" { input.x }\nelse = true { input.y }', "policy", None),
    "user_functions": ("""
        default allow = false
        double(x) = 2 * x
        ext(name) = out { out := trim_suffix(name, ".json") }
        classify(1) = "one"
        classify(x) = "many" { x > 1 }
        bool_fn(x) { x > 10 }
        allow { double(input.n) == 6 }
        kind := classify(input.n)
        big { bool_fn(input.n) }
        stripped := ext("a.json")
        """, "policy", None),
    "user_function_else": ("""
        f(x) = "big" { x > 10 } else = "small" { x > 0 } else = "neg"
        v := f(input.n)
        """, "policy", None),
    "user_function_recursion": (
        "f(x) = f(x) { true }\nv := f(1)", "policy", None),
    "data_documents": ("""
        package acl
        default allow = false
        helper { input.x == 1 }
        allow { input.user == data.admins[_] }
        allow { data.acl.helper }
        via_pkg := data.acl.limits.max
        """, "acl", [None, {"admins": ["alice", "bob"]}, {"admins": ["alice"]},
                     {"acl": {"limits": {"max": 9}}}]),
    "data_whole_package": ("package p\na := 1\nwhole := data.p", "p", None),
    "with_recursion": ("p { q with input.x as 1 }\nq { p }", "policy", None),
    "repeated_function_params": (
        "f(x, x) = x { true }\nr := f(input.a, input.b)", "policy", None),
    "with_on_some_in_and_every": ("""
        default a = false
        default b = false
        a { some x in input.xs; x == 9 with input.y as 1 }
        b { every x in input.xs { x > input.min } with input.min as 0 }
        """, "policy", None),
    "data_ancestor_prefix": ("package a.b\nallow = true\nr := data.a", "a.b",
                             [None, {"a": {"ext": 7}}]),
    "data_other_path": ("package a.b\nr := data.other.k", "a.b",
                        [None, {"other": {"k": 5}}, {"other": {}}]),
    "with_mocking": ("""
        default allow = false
        inner { input.role == "admin" }
        allow { inner with input.role as "admin" }
        both { inner with input.role as input.alt }
        listed { input.user in data.users }
        mocked_data { listed with data.users as ["bob"] with input.user as "bob" }
        """, "policy", [None, {"users": []}, {"users": ["eve", "bob"]}]),
    # TestRegoBuiltinsExtra._eval wraps every source in a default
    "regex_match": (_ALLOW + 'allow { regex.match("^/api/v[0-9]+/", input.path) }',
                    "t", None),
    "substring_indexof": (_ALLOW + 'allow { indexof(input.s, "-") == 3 ; '
                          'substring(input.s, 0, 3) == "abc" }', "t", None),
    "type_checks_and_sort": (_ALLOW + 'allow { is_string(input.s) ; '
                             'is_number(input.n) ; is_array(input.a) ; '
                             'sort(input.a)[0] == 1 }', "t", None),
    "substring_negative_offset": (_ALLOW + 'allow { substring(input.s, '
                                  'indexof(input.s, "#"), 2) == "ef" }',
                                  "t", None),
    "every": (_ALLOW + 'allow { every r in input.roles { startswith(r, "team-") } }',
              "t", None),
    "every_key_value": (_ALLOW + 'allow { every k, v in input.limits { v <= 10 ; '
                        'k != "forbidden" } }', "t", None),
    "array_comprehension": (_ALLOW + 'names := [u.name | some u in input.users ; '
                            'u.admin]\nallow { count(names) == 2 ; '
                            'names[0] == "a" }', "t", None),
    "set_and_object_comprehensions": (
        _ALLOW + 'tiers := {u.tier | some u in input.users}\n'
        'by_name := {u.name: u.tier | some u in input.users}\n'
        'allow { count(tiers) == 2 ; by_name.a == "gold" }', "t", None),
    "partial_set_rules": (
        _ALLOW + 'violations contains msg { input.x > 5 ; msg := "too big" }\n'
        'violations contains msg { input.y == "bad" ; msg := "bad y" }\n'
        'allow { count(violations) == 0 }', "t", None),
    "partial_set_rules_v0": (_ALLOW + 'roles[r] { some r in input.rs }\n'
                             'allow { count(roles) == 2 }', "t", None),
    "arithmetic": (_ALLOW + 'allow { count(input.roles) + 1 > 2 ; '
                   'input.n * 2 <= 10 ; input.n % 2 == 1 ; '
                   '(input.n + 1) / 2 == 3 ; -input.n == 0 - 5 }', "t", None),
    "arithmetic_iterates_refs": (
        _ALLOW + "deny { input.scores[_] - input.threshold > 0 }\n"
        "allow { not deny }", "t", None),
    "default_constant_folding": ("default limit = 60 * 60\nallow { input.x }",
                                 "t", None),
    "default_rejection": ("default limit = input.x + 1", "policy", None),
    "exact_integer_division": (_ALLOW + "x := input.a / input.b\n"
                               "allow { x == 2 }", "t", None),
    "float_division": ("y := 3 / 2", "t", None),
    "modulo_truncated_like_go": (_ALLOW + "allow { input.n % 2 == 1 }", "t", None),
    "modulo_negative": (_ALLOW + "allow { input.n % 2 == 0 - 1 }", "t", None),
    "divide_by_zero": (_ALLOW + "allow { input.a / input.b == 1 }", "t", None),
    "non_number_arithmetic": (_ALLOW + 'allow { input.s + 1 == 2 }', "t", None),
    "braceless_if_bodies": (_ALLOW + 'deny contains "x" if input.flagged\n'
                            'allow if count(deny) == 0', "t", None),
    "set_rule_iterating_head": (
        _ALLOW + 'banned contains input.blocked[_] { true }\n'
        'allow { not input.user in banned }', "t", None),
    "partial_set_conflicting_types": (
        'x contains v { v := input.a }\nx { input.b }', "policy", None),
    "with_on_comparison": (
        _ALLOW + 'allow { input.x == 1 with input as {"x": 1} }', "policy", None),
    "with_on_assignment": (
        _ALLOW + 'allow { x := input.y with input.y as 3; x == 3 }', "policy",
        None),
    "with_on_term": (
        _ALLOW + 'allow { input.x with input as {"x": true} }', "policy", None),
    "object_comprehension_key_conflict": (
        _ALLOW + 'by := {u.name: u.role | some u in input.users}\n'
        'allow { by.alice == "admin" }', "t", None),
    "set_comprehension_bool_number": (
        _ALLOW + 's := {x | some x in input.xs}\nallow { count(s) == 2 }', "t",
        None),
    "regex_catastrophic_pattern": (
        _ALLOW + 'allow { regex.match("^(a+)+$", input.v) }', "t", None),
    # TestOPAEvaluator: OPA wraps every source in a default (opa.py)
    "opa_call": (_ALLOW + 'allow { input.auth.identity.anonymous == true }',
                 "policy", None),
    "opa_all_values": (_ALLOW + 'allow { input.auth.identity.user == "john" }\n'
                       'user := input.auth.identity.user', "policy", None),
    "opa_invalid": (_ALLOW + "default x = input.y", "policy", None),
    "opa_data_documents": (
        _ALLOW + 'allow { input.auth.identity.sub == data.admins[_] }',
        "policy", [None, {"admins": ["u1"]}, {"admins": ["u2", "alice"]}]),
    # TestRegoDataLayering
    "data_layering": ("package p\na := 1", "p",
                      [None, {"p": {"ext": 7, "a": 99}}]),
    # TestRegoBuiltinsRound3._val
    "object_keys": (_val('object.keys({"a": 1, "b": 2})'), "t", None),
    "object_union": (_val('object.union({"a": {"x": 1}}, {"a": {"y": 2}})'),
                     "t", None),
    "object_remove": (_val('object.remove({"a": 1, "b": 2}, ["a"])'), "t", None),
    "object_filter": (_val('object.filter({"a": 1, "b": 2}, ["a"])'), "t", None),
    "numbers_range": (_val("numbers.range(1, 4)"), "t", None),
    "numbers_range_descending": (_val("numbers.range(3, 1)"), "t", None),
    "array_slice": (_val("array.slice([1, 2, 3, 4], 1, 3)"), "t", None),
    "array_slice_clamped": (_val("array.slice([1, 2], -5, 99)"), "t", None),
    "array_reverse": (_val("array.reverse([1, 2, 3])"), "t", None),
    "strings_reverse": (_val('strings.reverse("abc")'), "t", None),
    "format_int": (_val("format_int(255, 16)"), "t", None),
    "union": (_val("union([[1, 2], [2, 3]])"), "t", None),
    "intersection": (_val("intersection([[1, 2, 3], [2, 3, 4]])"), "t", None),
    "glob_null_delimiters": (
        _val('glob.match("*.github.com", null, "a.b.github.com")'), "t", None),
    "glob_empty_delimiters": (
        _val('glob.match("*.github.com", [], "api.github.com")'), "t", None),
    "glob_empty_delimiters_nested": (
        _val('glob.match("*.github.com", [], "a.b.github.com")'), "t", None),
    "glob_dot_delimiter": (
        _val('glob.match("*.github.com", ["."], "a.b.github.com")'), "t", None),
    "glob_double_star": (
        _val('glob.match("**.github.com", ["."], "a.b.github.com")'), "t", None),
    "glob_question": (
        _val('glob.match("api-?.acme.com", ["."], input.host)'), "t", None),
    "glob_newline": (_val('glob.match("a**b", null, input.s)'), "t", None),
    "numbers_range_type_errors": (
        "package t\nv := numbers.range(x, 3)\nx := input.n", "t", None),
    # TestRegoRound4
    "walk_relation": ('paths contains p { walk(input, [p, v]); v == "x" }\n'
                      'has_admin { walk(input, [_, v]); v == "admin" }\n',
                      "policy", None),
    "walk_ground_and_nested": (
        'allow { walk(input, [["a", "b"], v]); v == 1 }\n'
        'labels contains v { walk(input, [p, lv]); p[count(p) - 1] == "labels"; '
        'v := lv[_] }\n', "policy", None),
    "function_mocking": (
        "f(x) = x * 2\n"
        "g(x) = x + 100\n"
        "doubled = f(3)\n"
        "mocked { f(3) == 103 with f as g }\n"
        "consted { f(3) == 42 with f as 42 }\n"
        "builtin_const { count(\"abc\") == 99 with count as 99 }\n"
        "builtin_fn { count(\"abc\") == 6 with count as double_len }\n"
        "double_len(s) = 2 * 3\n", "policy", None),
    "mock_scopes_referenced_rules": (
        "inner = count(input.xs)\n"
        "outer { inner == 7 with count as 7 }\n"
        "normal = inner\n", "policy", None),
    "mock_combined_with_input": (
        "f(x) = count(x)\n"
        "ok { f(input.xs) == 9 with input.xs as [1] with f as 9 }\n",
        "policy", None),
    "multi_module_composition": (
        "package main\n"
        "allow { data.lib.helpers.is_admin }\n"
        "doubled = data.lib.mathx.double(4)\n"
        "libdoc = data.lib.helpers\n"
        "package lib.helpers\n"
        'is_admin { input.user.role == "admin" }\n'
        "level = 3\n"
        "package lib.mathx\n"
        "double(x) = x * 2\n", "policy", None),
    "multi_module_subtree_and_external_data": (
        "package main\n"
        "tree = data.lib\n"
        "ext = data.settings.mode\n"
        "package lib.a\n"
        "x = 1\n"
        "package lib.b\n"
        "y { false }\n", "policy",
        [None, {"settings": {"mode": "strict"},
                "lib": {"a": {"ext": True}, "c": 9}}]),
    "multi_module_cross_module_mock": (
        "package main\n"
        "ok { data.lib.f(1) == 10 with data.lib.f as ten }\n"
        "ten(x) = 10\n"
        "package lib\n"
        "f(x) = x\n", "policy", None),
    "recursion_across_modules": (
        "package main\n"
        "a { data.lib.b }\n"
        "package lib\n"
        "b { data.main.a }\n", "main", None),
    "opa_walk_roles": (
        _ALLOW + "roles contains v { walk(input.auth, [_, v]); is_string(v) }\n"
        'allow { "admin" in roles }\n', "policy", None),
    "some_key_value_in": (
        "admins contains u { some u, r in input.users; r == \"admin\" }\n"
        "second = v { some i, v in input.xs; i == 1 }\n"
        "anyval { some _, v in input.users; v == \"admin\" }\n",
        "policy", None),
    "mock_cycle_direct": ('allow { count([1]) == 1 with count as count }',
                          "policy", None),
    "mock_cycle_mutual": (
        'allow { count([1]) == 1 with count as sum with sum as count }',
        "policy", None),
    "encoding_and_time_builtins": (
        'j = json.marshal({"a": [1, 2]})\n'
        'b = base64.encode("hi")\n'
        'bd = base64.decode("aGk=")\n'
        'bu = base64url.encode_no_pad("hi?")\n'
        'bud = base64url.decode("aGk_")\n'
        'h = hex.encode("hi")\n'
        'hd = hex.decode("6869")\n'
        't = time.parse_rfc3339_ns("2026-07-30T00:00:00Z")\n'
        'tns = time.parse_rfc3339_ns("2026-07-30T00:00:00.123456789Z")\n'
        'tus = time.parse_rfc3339_ns("2026-07-30T12:34:56.654321+00:00")\n'
        'js = json.marshal({"b": 1, "a": 2})\n', "policy", None),
    "crypto_units_regex_builtins": (
        'h = crypto.sha256("hello")\n'
        'h1 = crypto.sha1("hello")\n'
        'h5 = crypto.md5("hello")\n'
        'b = units.parse_bytes("10MiB")\n'
        'b2 = units.parse_bytes("2K")\n'
        'parts = regex.split("[,;] ?", "a,b; c")\n'
        'parts2 = regex.split("(,)|;", "a,b;c")\n'
        'rep = regex.replace("xabbcy", "a(b+)c", "<$1>")\n'
        'rep0 = regex.replace("xabbcy", "ab+c", "<$0>")\n'
        'repd = regex.replace("cost", "co", "$$")\n'
        'repgo = regex.replace("xabbcy", "a(b+)c", "<$1x>")\n'
        'repmiss = regex.replace("xabbcy", "a(b+)c", "<$9>")\n'
        'repopt = regex.replace("ac", "a(b)?c", "<$1>")\n'
        'repbs = regex.replace("ab", "a", "\\\\d$0")\n', "policy", None),
    "crypto_non_string": ("h = crypto.sha256(3)", "policy", None),
    # the clock: time.now_ns reads the pinned clock in both packages
    "time_now_ns": (_ALLOW + "now := time.now_ns()\n"
                    "allow { time.now_ns() > input.n }", "policy", None),
}

# ---- the documents ---------------------------------------------------------

_SCALARS = ["admin", "GET", "POST", "/public", "/public/a", "/api/v2/pets",
            "john", "gold", "", " ", "team-a", "other", "root", "bad", "ok",
            "abc-def", "ab-cdef", "abcdef", "a" * 28, "a" * 28 + "!",
            "alice", "bob", "eve", "u1", "x", "admin\x00", "Ünïcode",
            "api-1.acme.com", "api-12.acme.com", "a\nb",
            0, 1, 2, 3, 4, 5, 6, 7, -7, 9, 10, 11, 20, 50, 100, -1,
            1.0, 1.5, 2.0, True, False, None]
_LISTS = [[], ["admin", "dev"], ["dev"], [1, 2, 3], [3, 1, 2], [1, 100],
          ["gold"], ["silver"], ["team-a", "team-b"], ["team-a", "other"],
          ["a", "b", "a"], [9], [0], [1, True], [1, 1.0], ["x", None],
          [{"name": "a", "admin": True, "tier": "gold", "role": "admin"},
           {"name": "b", "admin": False, "tier": "free", "role": "viewer"},
           {"name": "c", "admin": True, "tier": "gold", "role": "admin"}],
          [{"name": "alice", "role": "viewer"}, {"name": "alice", "role": "admin"}],
          [{"name": "alice", "role": "admin"}, {"name": "alice", "role": "admin"}]]
_OBJECTS = [{}, {"a": 5, "b": 10}, {"a": 11}, {"forbidden": 1},
            {"ann": "admin", "bob": "user"}, {"role": "admin"},
            {"role": "peon"}, {"b": 1}, {"labels": {"t": "blue"}},
            {"realm_access": {"roles": ["admin"]}}]


def _input_paths():
    """Every ``input.a.b...`` path the sources read, as key tuples."""
    paths = set()
    for src, _, _ in SOURCES.values():
        for m in re.finditer(r"input((?:\.[A-Za-z_]+)+)", src):
            paths.add(tuple(m.group(1)[1:].split(".")))
    return sorted(paths)


INPUT_PATHS = _input_paths()


def _value(rng):
    pool = rng.integers(10)
    if pool < 6:
        return _SCALARS[rng.integers(len(_SCALARS))]
    if pool < 8:
        return copy.deepcopy(_LISTS[rng.integers(len(_LISTS))])
    return copy.deepcopy(_OBJECTS[rng.integers(len(_OBJECTS))])


def _request_doc(rng):
    """An Authorization JSON in the manner of tests/test_rego_lower.py:
    methods and paths with empty strings, headers present or missing with
    odd values, peers with and without ports, a size or none."""
    headers = {}
    for name, vals in (("x-root", ["true", "false", "", "TRUE"]),
                       ("x-tier", ["t-1", "t-22", "", "t", "gold", "t-1 "]),
                       ("x-org", ["acme", "evil", "ac", "", "a\tb"]),
                       ("x-n", ["3", "4", "-1", "x", ""])):
        if rng.random() < 0.7:
            headers[name] = vals[rng.integers(len(vals))]
    req = CheckRequestModel(
        http=HttpRequestAttributes(
            method=["GET", "POST", "DELETE", "OPTIONS", ""][rng.integers(5)],
            path=["/", "/api/v1", "/apix", "/admin", "/a b", "",
                  "/public"][rng.integers(7)],
            host="h.test", scheme=["http", "https", ""][rng.integers(3)],
            headers=headers,
            size=int([-1, 0, 3, 80, 1024, 5000][rng.integers(6)])),
        source=PeerAttributes(address="10.0.0.1",
                              port=int([0, 80, 8080][rng.integers(3)])))
    return build_authorization_json(req)


def random_docs(seed: int, n: int = DOCS_PER_POLICY):
    """``n`` input documents: a request's Authorization JSON with, at each
    path the sources read, a value of any JSON type or nothing."""
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(n):
        doc = _request_doc(rng)
        for path in INPUT_PATHS:
            if rng.random() < 0.35:
                continue
            node = doc
            for key in path[:-1]:
                nxt = node.get(key)
                if not isinstance(nxt, dict):
                    nxt = node[key] = {}
                node = nxt
            node[path[-1]] = _value(rng)
        docs.append(doc)
    return docs


# ---- interpreter parity ----------------------------------------------------

# Each package's sentinel for an undefined value.  The reference lets it
# leak into an array literal with an undefined element (``[user]`` with
# ``user`` undefined is an array holding the sentinel, where OPA makes the
# whole expression undefined); the port keeps that result, and the two
# sentinels print their own addresses, so both read "<undefined>" here.
_UNDEFINED_REPRS = (repr(r_rego._UNDEFINED), repr(p_rego._UNDEFINED))


def _canonical(out) -> str:
    text = json.dumps(out, sort_keys=True, default=repr)
    for r in _UNDEFINED_REPRS:
        text = text.replace(r, "<undefined>")
    return text


def _outcome(fn):
    """What ``fn()`` gives: ("ok", JSON text, value) or ("error", type,
    message)."""
    try:
        out = fn()
    except (r_rego.RegoError, p_rego.RegoError) as e:
        return ("error", type(e).__name__, str(e))
    return ("ok", _canonical(out), out)


@pytest.fixture
def pinned_clock(monkeypatch):
    import time

    monkeypatch.setattr(time, "time_ns", lambda: PINNED_NS)


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_interpreter_equals_reference(name, pinned_clock):
    src, package, data_pool = SOURCES[name]
    compiled = [_outcome(lambda m=m: m.compile_module(src, package=package))
                for m in (r_rego, p_rego)]
    assert compiled[1][0] == compiled[0][0]
    if compiled[0][0] == "error":
        assert compiled[1] == compiled[0]
        return
    ref, port = compiled[0][2], compiled[1][2]
    seed = sum(map(ord, name))
    data_rng = np.random.default_rng(seed + 1)
    pool = data_pool or [None]
    outcomes = set()
    for k, doc in enumerate(random_docs(seed)):
        data = pool[data_rng.integers(len(pool))]
        want = _outcome(lambda: ref.evaluate(doc, data=data))
        got = _outcome(lambda: port.evaluate(doc, data=data))
        assert got[:2] == want[:2], (k, doc, data)
        outcomes.add(want[1])
    assert outcomes  # every policy was evaluated at least once


def test_data_layering_equals_reference():
    """TestRegoDataLayering: the resolver's view of data.<package>."""
    got = []
    for m in (r_rego, p_rego):
        mod = m.compile_module("package p\na := 1", package="p")
        ev = m._Evaluator(mod, {}, data={"p": {"ext": 7, "a": 99}})
        got.append(list(ev._data_values(["p"], {})))
    assert got[1] == got[0] == [{"ext": 7, "a": 1}]


def test_documents_reach_both_verdicts():
    """The document generator is not degenerate: the reference's basic
    policy allows some documents and denies others."""
    mod = r_rego.compile_module(SOURCES["basic_allow"][0])
    verdicts = {bool(mod.evaluate(d)["allow"]) for d in random_docs(5, 200)}
    assert verdicts == {True, False}


def test_regex_match_reads_the_ports_dfa(monkeypatch):
    """``regex.match`` compiles through the port's own redfa; a pattern
    outside the DFA subset falls back to Python ``re``."""
    from authorino_tpu_torch.compiler import redfa as p_redfa

    seen = []
    real = p_redfa.compile_regex_dfa
    monkeypatch.setattr(p_redfa, "compile_regex_dfa",
                        lambda pat: seen.append(pat) or real(pat))
    monkeypatch.setattr(p_rego, "_REGEX_CACHE", {})
    assert p_rego._regex_match("^t-[0-9]+$", "t-12")
    assert not p_rego._regex_match("^t-[0-9]+$", "t-")
    assert p_rego._regex_match(r"(a)\1", "aa")  # backreference: Python re
    assert seen == ["^t-[0-9]+$", r"(a)\1"]


# ---- lowering parity -------------------------------------------------------

def _lower_both(src: str):
    wrapped = f"default allow = false\n{src}"
    return [lo.lower_verdict(m.compile_module(wrapped, package="t"))
            for m, lo in ((r_rego, r_lower), (p_rego, p_lower))]


def _same_corpus(want, got):
    r = REF_C.compile_corpus([REF_C.ConfigRules(name="c", evaluators=[
        (None, want)])], members_k=16)
    p = PORT_C.compile_corpus([PORT_C.ConfigRules(name="c", evaluators=[
        (None, got)])], members_k=16)
    assert_same_policy(r, p)


@pytest.mark.parametrize("src", LOWERABLE + NOT_LOWERABLE)
def test_lowering_equals_reference(src):
    want, got = _lower_both(src)
    if want is None:
        assert got is None
        return
    assert got is not None and str(got) == str(want)
    _same_corpus(want, got)


def test_opa_corpus_lowering_equals_reference():
    """Every policy of the OPA corpus lowers as in the reference; about
    one in ten does not lower at all."""
    lowered = []
    for ac in opa_corpus.build_auth_configs(60):
        src = ac["spec"]["authorization"]["policy"]["opa"]["rego"]
        want, got = _lower_both(src)
        assert (got is None) == (want is None), src
        if want is not None:
            assert str(got) == str(want), src
            lowered.append((want, got))
    assert 0.7 * 60 < len(lowered) < 60
    r = REF_C.compile_corpus([REF_C.ConfigRules(name=f"c{i}", evaluators=[
        (None, w)]) for i, (w, _) in enumerate(lowered)], members_k=16)
    p = PORT_C.compile_corpus([PORT_C.ConfigRules(name=f"c{i}", evaluators=[
        (None, g)]) for i, (_, g) in enumerate(lowered)], members_k=16)
    assert_same_policy(r, p)
    # the lowered verdicts read the regex-DFA and the numeric lanes
    ops = set(p.leaf_op.tolist())
    assert OP_REGEX_DFA in ops and ops & set(NUMERIC_OPS)


# ---- the kernel slot -------------------------------------------------------

N_CONFIGS = 24


def _translated(ns, engine, acs):
    async def body():
        return [await ns.controllers.translate_auth_config(
            o["metadata"]["name"], o["metadata"]["namespace"], o["spec"],
            engine=engine) for o in acs]
    return run(body())


def _docs_and_names(requests):
    docs, names = [], []
    for r in requests:
        claims = r.metadata_context["filter_metadata"][
            opa_corpus.JWT_FILTER]["verified_jwt"]
        docs.append(build_authorization_json(r, {"identity": claims}))
        names.append(f"{opa_corpus.NAMESPACE}/{r.http.host.split('.')[0]}")
    return docs, names


def test_kernel_slot_equals_reference_and_interpreter():
    acs = opa_corpus.build_auth_configs(N_CONFIGS)
    requests = opa_corpus.build_check_requests(96, N_CONFIGS)
    docs, names = _docs_and_names(requests)

    async def submit_all(engine):
        return await asyncio.gather(*(engine.submit(d, n)
                                      for d, n in zip(docs, names)))

    out = {}
    for ns in (REF, PORT):
        engine = engine_of(ns, max_batch=64)
        entries = _translated(ns, engine, acs)
        engine.apply_snapshot(entries)
        out[ns is PORT] = (entries, run(submit_all(engine)), engine)
    r_entries, want, _ = out[False]
    p_entries, got, engine = out[True]
    assert engine.stats["plain_calls"] == engine.stats["batches"] == 2
    by_name = {e.id: e for e in p_entries}
    slots = both = 0
    for k, ((wr, ws), (gr, gs), doc, name) in enumerate(
            zip(want, got, docs, names)):
        assert np.asarray(wr).tolist() == gr.tolist(), k
        assert np.asarray(ws).tolist() == gs.tolist(), k
        opa = by_name[name].runtime.authorization[1].evaluator
        if opa.kernel_slot is None:
            continue
        allow = bool(opa._module.evaluate(doc, data=opa.data)["allow"])
        lowered = by_name[name].rules.evaluators[opa.kernel_slot][1]
        assert bool(gr[opa.kernel_slot]) == allow == lowered.matches(doc), k
        assert not gs[opa.kernel_slot]
        slots += 1
        both |= 1 << allow
    assert slots > 60 and both == 3
    # the reference lowers the same policies into the same slots
    for r, p in zip(r_entries, p_entries):
        assert r.runtime.authorization[1].evaluator.kernel_slot == \
            p.runtime.authorization[1].evaluator.kernel_slot
        assert [str(x) for _, x in r.rules.evaluators] == \
            [str(x) for _, x in p.rules.evaluators]


def test_opa_check_path_equals_reference():
    """The OPA corpus's Check()s, concurrent, through both engines: every
    AuthResult field is equal."""
    acs = opa_corpus.build_auth_configs(N_CONFIGS)
    requests = opa_corpus.build_check_requests(64, N_CONFIGS, seed=5)

    async def body(ns, reqs):
        engine = engine_of(ns, max_batch=32)
        engine.apply_snapshot([await ns.controllers.translate_auth_config(
            o["metadata"]["name"], o["metadata"]["namespace"], o["spec"],
            engine=engine) for o in acs])
        return await asyncio.gather(*(engine.check(r) for r in reqs))

    want = run(body(REF, [port_request_to(REF, r) for r in requests]))
    got = run(body(PORT, requests))
    fields = [(g.code, g.status, g.message, g.headers, g.metadata, g.body)
              for g in got]
    assert fields == [(w.code, w.status, w.message, w.headers, w.metadata,
                       w.body) for w in want]
    codes = {g.code for g in got}
    assert codes == {PORT.rpc.OK, PORT.rpc.PERMISSION_DENIED}


def test_program_carries_the_lowered_slots():
    """The OPA corpus's translated rules, compiled by each package: the
    v3 program's CPU interpreter, the plain version and the reference's
    interpret-mode Pallas kernel give the same [B, W] bytes."""
    acs = opa_corpus.build_auth_configs(N_CONFIGS)
    rp = REF_C.compile_corpus([e.rules for e in _translated(
        REF, engine_of(REF), acs)], members_k=16)
    pp = PORT_C.compile_corpus([e.rules for e in _translated(
        PORT, engine_of(PORT), acs)], members_k=16)
    assert_same_policy(rp, pp)
    docs, names = _docs_and_names(
        opa_corpus.build_check_requests(64, N_CONFIGS, seed=3))
    rows = [pp.config_ids[n] for n in names]
    want = reference_packed(rp, docs, rows)
    db = batch_of(PORT_C, pp, docs, rows)
    for params in both_params(rp, pp):
        got = interpret(params, db)
        np.testing.assert_array_equal(got, plain(params, db))
        np.testing.assert_array_equal(got, want)
    assert int(pp.eval_rule.shape[1]) == 2


class _Doc:
    """The one pipeline method an OPA evaluator reads."""

    def __init__(self, doc):
        self.doc = doc

    def authorization_json(self):
        return self.doc


@pytest.mark.parametrize("all_values", [False, True])
def test_opa_evaluator_equals_reference(all_values):
    """The port's OPA evaluator: the same package name (``policy_uid``),
    the same lowered verdict and kernel-slot default, and ``call`` gives
    the same value or the same EvaluationError on every document."""
    src = ('allow { input.request.method == "GET" }\n'
           'allow { input.auth.identity.sub == data.admins[_] }\n'
           'who := input.auth.identity.sub')
    kw = dict(inline_rego=src, all_values=all_values,
              data={"admins": ["alice", 3]})
    ref = REF.authz.OPA("t/cfg/policy", **kw)
    port = PORT.authz.OPA("t/cfg/policy", **kw)
    assert port.policy_uid == ref.policy_uid
    assert port._module.package == ref._module.package == ref.policy_uid
    assert port.kernel_slot is ref.kernel_slot is None
    assert port.lowered_verdict() is ref.lowered_verdict() is None
    outcomes = set()
    for doc in random_docs(17, 80):
        got = []
        for ns, ev in ((REF, ref), (PORT, port)):
            try:
                got.append(("ok", _canonical(run(ev.call(_Doc(doc))))))
            except ns.ev.EvaluationError as e:
                got.append(("denied", str(e)))
        assert got[1] == got[0], doc
        outcomes.add(got[0][0])
    assert outcomes == {"ok", "denied"}
    lowerable = PORT.authz.OPA("t/x", inline_rego=(
        'allow { startswith(input.request.path, "/api") }'))
    assert str(lowerable.lowered_verdict()) == str(REF.authz.OPA(
        "t/x", inline_rego='allow { startswith(input.request.path, "/api") }'
    ).lowered_verdict())
    with pytest.raises(ValueError, match="invalid rego policy"):
        PORT.authz.OPA("t/y", inline_rego="default x = input.y")
