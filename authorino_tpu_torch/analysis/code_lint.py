"""Async-hazard code lint: AST checks for this repo's own bug classes.

The serving path is a braid of asyncio loops (gRPC/HTTP frontends, the slow
lane), free-running threads (dispatchers, completer, readback, drains) and
device work on CUDA streams — each with a hazard class generic linters
don't know.  The kinds and their names are the JAX package's
(``authorino_tpu/analysis/code_lint.py``), so one suppression syntax and one
catalogue (docs/static_analysis.md) serve both packages:

  blocking-in-async   a blocking call (time.sleep, a device synchronise:
                      ``torch.cuda.synchronize()`` or a stream's or event's
                      ``.synchronize()``, and the JAX package's sync device
                      reads; threading-lock .acquire) inside
                      ``async def``: stalls every request sharing that
                      event loop
  lock-across-await   a *threading* lock held across ``await``: the loop
                      suspends mid-critical-section while dispatcher/
                      completer threads contend on the same lock (deadlock
                      or convoy; asyncio locks via ``async with`` are fine)
  tracer-branch       a Python ``if``/``while`` comparing a traced value
                      inside a jit-decorated function: TracerBoolConversion
                      at best, silent trace-time specialization at worst
                      (kept as written: the port jits nothing, a planted
                      source holds the check)
  bare-except         ``except:`` catches KeyboardInterrupt/SystemExit —
                      on completer/drain threads it turns shutdown into a
                      hang (``except Exception`` is the repo idiom)
  unbounded-wait      a ``.wait()`` / ``.join()`` with no timeout (or an
                      awaited asyncio ``.wait()``) inside a breaker/drain/
                      shutdown-path function: graceful degradation code
                      exists for the case where a peer is WEDGED — an
                      unbounded wait there turns the recovery path itself
                      into the hang it guards against
  pickle-import       ``import pickle`` / ``cloudpickle`` outside tests/:
                      every container in this repo (snapshots, capture
                      segments, the decision corpus) is pickle-free
                      checksummed JSON BY INVARIANT — loading
                      operator-writable blobs through pickle is arbitrary
                      code execution at deserialization time
  non-atomic-write    an ``open(path, "w"/"wb")`` inside a function that
                      handles durable-state-shaped paths (state/publish/
                      flight/capture/corpus/snapshot/manifest/hotset/
                      artifact names or literals) without the tmp + fsync +
                      os.replace discipline in the same scope: a crash
                      mid-write surfaces a torn artifact under a valid
                      name.  Route through utils/atomicio.py — which also
                      gives the writer fs-stage fault coverage.
                      Function-scope, lexical: hand-rolled atomicity (both
                      an ``os.fsync`` and an ``os.replace``/``os.rename``
                      in the same function) passes; tests/ are exempt

Suppression (docs/static_analysis.md): append ``# lint-ok: <kind>`` to the
flagged line — with a reason after ``--`` by convention.  A bare
``# lint-ok`` suppresses every kind on that line; ``# lint: skip-file``
anywhere in the first 5 lines skips the whole file.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from . import Finding

__all__ = ["lint_source", "lint_file", "lint_paths", "iter_py_files",
           "HAZARD_KINDS"]

_LAYER = "code_lint"

HAZARD_KINDS = ("blocking-in-async", "lock-across-await", "tracer-branch",
                "bare-except", "unbounded-wait", "pickle-import",
                "non-atomic-write")

# pickle-family module roots flagged by pickle-import (dotted submodule
# imports count by their root); tests/ paths are exempt — tests may build
# adversarial pickles to prove the containers reject them
_PICKLE_MODULES = {"pickle", "cloudpickle", "cPickle", "dill"}
_TESTS_PATH = re.compile(r"(^|[/\\])tests?([/\\]|$)")

# calls that block the calling thread; flagged inside async def unless
# awaited (module.attr form, or bare attribute for methods)
_BLOCKING_MODULE_CALLS = {("time", "sleep"), ("jax", "device_get"),
                          ("jax", "block_until_ready"),
                          ("cuda", "synchronize")}
_BLOCKING_METHOD_CALLS = {"acquire", "block_until_ready", "synchronize"}

_LOCKISH = re.compile(r"(lock|mutex|sem)$|^_?lock", re.IGNORECASE)
_STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "itemsize"}

# functions on the graceful-degradation path: drain/stop/shutdown/breaker/
# watchdog/probe code runs exactly when a peer may be wedged, so its waits
# must be bounded (unbounded-wait kind).  The overload-resilience layer
# extends the set: admission/brownout/overload/adaptive-controller
# code runs exactly when the system is saturated — an unbounded wait there
# turns backpressure into the collapse it guards against.
_DRAIN_PATH = re.compile(
    r"(drain|stop|shutdown|teardown|close|probe|watchdog|breaker"
    r"|admi(t|ssion)|brownout|overload|adaptive"
    # lane selection + speculative dual-dispatch: the
    # selection/cancellation paths run exactly when one lane is slow or
    # half-open — an unbounded wait there turns the latency rescue into
    # the latency it rescues from
    r"|lane|speculat|cost_model"
    # fleet plane: router decisions, replica join/leave/crash
    # choreography and warm-join run exactly when a peer replica may be
    # dead or wedged — an unbounded wait there stalls the whole fleet's
    # routing, not one process
    r"|router|fleet|replica|join)",
    re.IGNORECASE)
_WAITISH_METHODS = {"wait", "join"}

_SUPPRESS = re.compile(r"#\s*lint-ok(?::\s*(?P<kinds>[\w\-, ]+?))?\s*(?:--.*)?$")
_SKIP_FILE = re.compile(r"#\s*lint:\s*skip-file")

# durable-state shapes (non-atomic-write kind): a function whose names or
# string literals smell like the repo's durable artifacts is held to the
# tmp+fsync+rename discipline for every raw open-for-write in its scope
_DURABLE = re.compile(
    r"state|publish|flight|captur|corpus|snapshot|manifest|hotset|artifact",
    re.IGNORECASE)


def _suppressions(source: str) -> Dict[int, Optional[Set[str]]]:
    """line → suppressed kinds (None = all kinds)."""
    out: Dict[int, Optional[Set[str]]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        if "#" not in line:
            continue
        m = _SUPPRESS.search(line)
        if m is None:
            continue
        kinds = m.group("kinds")
        out[i] = (None if not kinds else
                  {k.strip() for k in kinds.split(",") if k.strip()})
    return out


def _dotted(node: ast.AST) -> Optional[Tuple[str, ...]]:
    """('jax', 'device_get') for jax.device_get; None for anything deeper
    than Name/Attribute chains."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


def _terminal_name(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _is_jit_decorator(dec: ast.AST) -> bool:
    """jax.jit / jit / partial(jax.jit, ...) / jax.jit(...)."""
    d = _dotted(dec)
    if d is not None and d[-1] == "jit":
        return True
    if isinstance(dec, ast.Call):
        f = _dotted(dec.func)
        if f is not None and f[-1] == "jit":
            return True
        if f is not None and f[-1] == "partial" and dec.args:
            a = _dotted(dec.args[0])
            return a is not None and a[-1] == "jit"
    return False


class _FuncVisitor(ast.NodeVisitor):
    """One pass; function contexts tracked explicitly so nested defs reset
    the async / jit context (a sync helper defined inside an async def runs
    wherever it is *called*, which this lexical linter cannot know)."""

    def __init__(self, path: str, suppress: Dict[int, Optional[Set[str]]]):
        self.path = path
        self.suppress = suppress
        self.findings: List[Finding] = []
        self._async_depth = 0
        self._jit_params: Optional[Set[str]] = None
        self._await_parents: Set[int] = set()
        self._drain_path = False

    # -- reporting ---------------------------------------------------------

    def _report(self, kind: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 0)
        if line in self.suppress:
            kinds = self.suppress[line]
            if kinds is None or not kinds or kind in kinds:
                return
        self.findings.append(Finding(
            kind=kind, message=message, layer=_LAYER, severity="error",
            location=f"{self.path}:{line}"))

    # -- function context --------------------------------------------------

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._enter_function(node, is_async=False)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._enter_function(node, is_async=True)

    def _enter_function(self, node, is_async: bool) -> None:
        for dec in node.decorator_list:
            self.visit(dec)
        prev_async, prev_jit = self._async_depth, self._jit_params
        prev_drain = self._drain_path
        self._async_depth = 1 if is_async else 0
        # nested defs take their OWN name's verdict (consistent with the
        # async/jit context reset: a helper runs where it is called)
        self._drain_path = bool(_DRAIN_PATH.search(node.name))
        if any(_is_jit_decorator(d) for d in node.decorator_list):
            args = node.args
            self._jit_params = {
                a.arg for a in (args.posonlyargs + args.args
                                + args.kwonlyargs)}
            if args.vararg:
                self._jit_params.add(args.vararg.arg)
        else:
            self._jit_params = None
        self._check_atomic_writes(node)
        for child in node.body:
            self.visit(child)
        self._async_depth, self._jit_params = prev_async, prev_jit
        self._drain_path = prev_drain

    # -- non-atomic-write --------------------------------------------------

    @classmethod
    def _own_scope(cls, node: ast.AST):
        """Every node in ``node``'s body, pruning nested def/lambda
        subtrees (they get their own _enter_function pass and verdict)."""
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            yield child
            yield from cls._own_scope(child)

    @staticmethod
    def _open_write_mode(call: ast.Call) -> Optional[str]:
        """The constant write mode of an ``open()`` call, or None for
        reads / non-open calls / non-constant modes."""
        if not (isinstance(call.func, ast.Name) and call.func.id == "open"):
            return None
        mode = None
        if len(call.args) >= 2 and isinstance(call.args[1], ast.Constant) \
                and isinstance(call.args[1].value, str):
            mode = call.args[1].value
        for kw in call.keywords:
            if kw.arg == "mode" and isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, str):
                mode = kw.value.value
        return mode if mode is not None and "w" in mode else None

    def _check_atomic_writes(self, node) -> None:
        """One function-scope pass: a raw open-for-write in a function
        that handles durable-state-shaped names/literals must ride the
        tmp+fsync+rename discipline in the SAME scope (or, better, route
        through utils/atomicio.py and never open() at all).  Tests are
        exempt — they corrupt artifacts on purpose."""
        if _TESTS_PATH.search(self.path):
            return
        writes: List[Tuple[ast.Call, str]] = []
        durable = has_fsync = has_rename = False
        for n in self._own_scope(node):
            if isinstance(n, ast.Call):
                mode = self._open_write_mode(n)
                if mode is not None:
                    writes.append((n, mode))
                d = _dotted(n.func)
                if d is not None:
                    if d[-1] == "fsync":
                        has_fsync = True
                    # os.replace/os.rename only: a str.replace() must not
                    # count as the atomic-rename half of the discipline
                    if d[0] == "os" and d[-1] in ("replace", "rename"):
                        has_rename = True
            if isinstance(n, ast.Name) and _DURABLE.search(n.id):
                durable = True
            elif isinstance(n, ast.Attribute) and _DURABLE.search(n.attr):
                durable = True
            elif isinstance(n, ast.Constant) and isinstance(n.value, str) \
                    and _DURABLE.search(n.value):
                durable = True
        if not writes or not durable or (has_fsync and has_rename):
            return
        for call, mode in writes:
            self._report(
                "non-atomic-write", call,
                f"open(..., {mode!r}) into a durable-state-shaped path "
                "without tmp+fsync+rename in the same scope: a crash "
                "mid-write surfaces a torn artifact under a valid name "
                "(route through utils/atomicio.py atomic_write_*, which "
                "also adds fs fault-injection coverage)")

    # -- blocking-in-async -------------------------------------------------

    def visit_Await(self, node: ast.Await) -> None:
        if isinstance(node.value, ast.Call):
            self._await_parents.add(id(node.value))
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if self._async_depth and id(node) not in self._await_parents:
            d = _dotted(node.func)
            if d is not None and len(d) >= 2 \
                    and (d[-2], d[-1]) in _BLOCKING_MODULE_CALLS:
                self._report(
                    "blocking-in-async", node,
                    f"blocking call {'.'.join(d)}() inside async def "
                    "stalls the event loop (move to a worker thread or "
                    "await an async equivalent)")
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _BLOCKING_METHOD_CALLS:
                self._report(
                    "blocking-in-async", node,
                    f".{node.func.attr}() inside async def blocks the "
                    "event loop (threading-lock acquire / sync device "
                    "read; await the async form or offload)")
        # unbounded-wait: a timeoutless .wait()/.join() (threading or an
        # awaited asyncio Event.wait, which HAS no timeout form) inside a
        # drain/stop/shutdown/breaker-path function — the code that runs
        # exactly when a peer may be wedged must bound its waits
        if self._drain_path and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _WAITISH_METHODS \
                and not node.args and not node.keywords:
            self._report(
                "unbounded-wait", node,
                f"timeoutless .{node.func.attr}() on a drain/shutdown/"
                "breaker path: a wedged peer turns the recovery path into "
                "the hang it guards against (pass a timeout, or "
                "asyncio.wait_for the await)")
        self.generic_visit(node)

    # -- lock-across-await -------------------------------------------------

    def visit_With(self, node: ast.With) -> None:
        lockish = any(
            (n := _terminal_name(item.context_expr)) is not None
            and _LOCKISH.search(n)
            for item in node.items)
        if lockish and self._contains_await(node.body):
            self._report(
                "lock-across-await", node,
                "threading lock held across await: the loop suspends "
                "mid-critical-section while other threads contend (use an "
                "asyncio lock, or release before awaiting)")
        self.generic_visit(node)

    @classmethod
    def _contains_await(cls, body: Sequence[ast.stmt]) -> bool:
        return any(cls._awaits(stmt) for stmt in body)

    @classmethod
    def _awaits(cls, node: ast.AST) -> bool:
        """Await anywhere under ``node``, pruning ONLY nested def/lambda
        subtrees (their awaits run in THEIR call context) — siblings after
        a nested def must still be seen."""
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            if isinstance(child, ast.Await) or cls._awaits(child):
                return True
        return False

    # -- tracer-branch -----------------------------------------------------

    def visit_If(self, node: ast.If) -> None:
        self._check_branch(node.test, node)
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        self._check_branch(node.test, node)
        self.generic_visit(node)

    def _check_branch(self, test: ast.AST, node: ast.AST) -> None:
        if self._jit_params is None:
            return
        for cmp in ast.walk(test):
            if not isinstance(cmp, ast.Compare):
                continue
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in cmp.ops):
                continue  # `x is None` = static pytree-structure dispatch
            for side in [cmp.left] + list(cmp.comparators):
                if self._traced_side(side):
                    self._report(
                        "tracer-branch", node,
                        "Python branch on a traced value inside a jitted "
                        "function: the condition is baked in at trace "
                        "time (use jnp.where / lax.cond, or branch on "
                        "static .shape/.dtype)")
                    return

    def _traced_side(self, side: ast.AST) -> bool:
        """A compare side is traced-ish when it reaches a jit parameter
        without passing through a static accessor (.shape/.dtype/len).
        Static accessors prune only THEIR subtree — `x + y.shape[0]` is
        still traced through `x`."""
        params = self._jit_params or ()

        def traced(node: ast.AST) -> bool:
            if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
                return False
            if isinstance(node, ast.Call):
                f = _dotted(node.func)
                if f is not None and f[-1] in ("len", "isinstance",
                                               "getattr"):
                    return False
            if isinstance(node, ast.Name):
                return node.id in params
            return any(traced(c) for c in ast.iter_child_nodes(node))

        return traced(side)

    # -- pickle-import -----------------------------------------------------

    def _check_pickle(self, node: ast.AST, module: Optional[str]) -> None:
        root = (module or "").split(".", 1)[0]
        if root in _PICKLE_MODULES and not _TESTS_PATH.search(self.path):
            self._report(
                "pickle-import", node,
                f"`{root}` import outside tests/: the repo's containers "
                "are pickle-free checksummed JSON by invariant (snapshots, "
                "capture segments, the decision corpus) — unpickling an "
                "operator-writable blob is code execution at load time "
                "(serialize with the snapshots/serialize.py idiom)")

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            self._check_pickle(node, alias.name)
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.level == 0:       # relative imports cannot name stdlib pickle
            self._check_pickle(node, node.module)
        self.generic_visit(node)

    # -- bare-except -------------------------------------------------------

    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        if node.type is None:
            self._report(
                "bare-except", node,
                "bare `except:` also swallows KeyboardInterrupt/SystemExit "
                "— on completer/drain threads that turns shutdown into a "
                "hang (catch Exception)")
        self.generic_visit(node)


def lint_source(source: str, path: str = "<string>") -> List[Finding]:
    head = "\n".join(source.splitlines()[:5])
    if _SKIP_FILE.search(head):
        return []
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(kind="syntax-error", message=str(e), layer=_LAYER,
                        severity="error", location=f"{path}:{e.lineno}")]
    v = _FuncVisitor(path, _suppressions(source))
    v.visit(tree)

    def line_key(f: Finding):
        p, _, ln = f.location.rpartition(":")
        return (p, int(ln) if ln.isdigit() else 0)

    v.findings.sort(key=line_key)
    return v.findings


def lint_file(path: str) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as f:
        return lint_source(f.read(), path)


def iter_py_files(root: str) -> List[str]:
    out: List[str] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", ".git", "node_modules")]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                out.append(os.path.join(dirpath, fn))
    return sorted(out)


def lint_paths(paths: Sequence[str]) -> List[Finding]:
    findings: List[Finding] = []
    for p in paths:
        if os.path.isdir(p):
            for f in iter_py_files(p):
                findings += lint_file(f)
        else:
            findings += lint_file(p)
    return findings
