"""Analysis CLI: ``python -m authorino_tpu_torch.analysis``, the JAX
package's analysis CLI over the port (every mode, the same flags, reports
and exit codes).

Modes (lint + fixtures both run when no mode flag is given):

  --self-lint         async-hazard code lint over authorino_tpu_torch/ (or the
                      given paths) — exit 1 on any finding
  --verify-fixtures   compile the fixture AuthConfigs, tensor-lint the
                      snapshot + a packed batch + a dedup scatter plan,
                      prove the semantic analyzer still sees the planted
                      findings, certify the snapshot against the host
                      expression oracle (translation validation), and run
                      the mutation self-test — a validator blind to any
                      planted miscompile class is itself a failure
  --coverage-report   lowerability report over the fixture corpus: which
                      configs ride the kernel fast lane vs the interpreter
                      slow lane, with reason codes
                      (docs/static_analysis.md catalogue)

``--json`` emits one machine-readable report object on stdout.  Import-light
by construction: no identity tree, no native frontend, no device (operand
trees are host builds); runs without ``cryptography``.  The other modes
(--snapshot-diff, --replay, the corpus modes, --metrics-catalog,
--decisions, --kernel-cost, --flight-dump, the change-safety overrides)
are listed in ``main``'s help.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from . import Finding, findings_to_json

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_self_lint(paths: List[str]) -> List[Finding]:
    from .code_lint import lint_paths

    return lint_paths(paths or [_PKG_ROOT])


def _run_verify_fixtures() -> List[Finding]:
    """Tensor-lint a real compiled snapshot end to end; returns ERROR
    findings only (planted policy-analysis warnings are expected and
    checked for presence, not absence)."""
    from ..compiler.encode import encode_batch_py
    from ..compiler.pack import batch_row_keys, dedup_rows, pack_batch
    from .fixtures import (
        finding_fixture_configs,
        fixture_policy,
    )
    from .policy_analysis import analyze_policy
    from .tensor_lint import lint_device_batch, lint_scatter_plan, tensor_lint

    errors: List[Finding] = []
    policy = fixture_policy()
    errors += tensor_lint(policy)

    docs = [
        {"request": {"method": "GET", "url_path": "/api/v1/x",
                     "host": "h", "headers": {"x-tag": "aa"}},
         "auth": {"identity": {"org": "acme", "roles": ["admin"],
                               "groups": []}}},
        {"request": {"method": "TRACE", "url_path": "/other",
                     "host": "h", "headers": {"x-tag": "b"}},
         "auth": {"identity": {"org": "evil", "roles": [],
                               "groups": ["banned"]}}},
    ] * 4
    rows = [0, 1] * 4
    enc = encode_batch_py(policy, docs, rows, batch_pad=8)
    db = pack_batch(policy, enc)
    errors += lint_device_batch(policy, db)
    keys = batch_row_keys(db, len(docs))
    all_rows = list(range(len(docs)))
    unique_rows, inverse = dedup_rows(keys, all_rows)
    errors += lint_scatter_plan(keys, all_rows, unique_rows, inverse)
    if len(unique_rows) != 2:
        errors.append(Finding(
            kind="scatter-cover", layer="tensor_lint",
            message=f"fixture batch of 2 distinct rows deduped to "
                    f"{len(unique_rows)} unique rows", location="fixtures"))

    from ..compiler.compile import compile_corpus

    findings, _ = analyze_policy(compile_corpus(finding_fixture_configs()))
    got = {f.kind for f in findings}
    want = {"constant-allow", "constant-deny", "shadowed-rule",
            "duplicate-rule"}
    if not want <= got:
        errors.append(Finding(
            kind="analysis-blind", layer="policy_analysis",
            message=f"semantic analyzer missed planted findings: "
                    f"{sorted(want - got)}", location="fixtures"))

    # translation validation: mutation_self_test certifies the
    # clean fixture corpus as its baseline pass, then demands every
    # planted miscompile class is REJECTED — one pass, both proofs; a
    # blind validator fails this command, and with it the tests
    from .translation_validate import mutation_self_test

    errors += mutation_self_test(policy)

    # snapshot serialization + diff self-test: the container
    # must round-trip the fixture corpus bit-identically, and the diff
    # engine must name EXACTLY the planted change — a blind diff engine
    # (or a lossy serializer) fails this command
    errors += _snapshot_selftest(policy)

    # change-safety self-test: a planted constant-deny poison
    # MUST breach the canary guard (with the poison config named as the
    # suspect) and an identical-rate clean churn MUST stay clean (and so
    # promote) — a blind or trigger-happy guard fails this command, and
    # with it the tests (as every self-test here)
    from ..runtime.change_safety import guard_self_test

    for msg in guard_self_test():
        errors.append(Finding(
            kind="guard-blind", layer="change_safety", message=msg,
            location="fixtures"))

    # replay self-test: a planted one-rule mutation MUST be
    # detected over replayed fixture traffic and attributed to exactly the
    # mutated rule, a clean churn MUST diff empty, and a capture segment
    # MUST round-trip bit-identically — a blind differ (or a lossy capture
    # container) fails this command, and with it the tests
    errors += _replay_selftest(policy)

    # compiled relations self-test: the relations fixture
    # corpus (deep/diamond hierarchy, numeric comparators, large-set
    # assist) must lint + certify clean AND round-trip the container
    # bit-identically, and every planted hierarchy-closure /
    # numeric-encoder miscompile class must be REJECTED by the certifier
    errors += _relations_selftest()

    # tenant-label cardinality lint: every metric
    # family with a `tenant` label must declare its top-K bound, and the
    # lint must CATCH a planted undeclared family — a blind lint fails
    # this command, and with it the tests
    from .metrics_catalog import tenant_lint_self_test

    for msg in tenant_lint_self_test():
        errors.append(Finding(
            kind="tenant-cardinality", layer="metrics_catalog",
            message=msg, location="utils/metrics.py"))

    # corpus self-test: a planted constant-deny edit on a rule
    # with ZERO captured traffic must be caught by the corpus pregate on
    # synthesized rows alone — a blind synthesizer (or a pregate that only
    # judges captured evidence) fails this command, and with it the tests
    errors += _corpus_selftest(policy)

    # pickle-import lint self-test: the planted
    # fixture must fire outside tests/, stay quiet inside tests/, and
    # honor `# lint-ok:` — a blind lint fails this command
    errors += _pickle_lint_selftest()

    # non-atomic-write lint self-test: a planted raw
    # open-for-write into a durable-state path must fire, the tmp+fsync+
    # rename discipline must pass, tests/ stay exempt, and `# lint-ok:`
    # suppresses — a blind lint fails this command, and with it the tests
    errors += _atomic_write_lint_selftest()
    return errors


def _pickle_lint_selftest() -> List[Finding]:
    from .code_lint import lint_source

    errors: List[Finding] = []

    def _err(msg: str) -> None:
        errors.append(Finding(kind="lint-blind", layer="code_lint",
                              message=msg, location="fixtures"))

    planted = "import pickle\nfrom cloudpickle import dumps\n"
    got = [f.kind for f in lint_source(planted, path="authorino_tpu_torch/x.py")]
    if got != ["pickle-import", "pickle-import"]:
        _err(f"pickle-import lint BLIND to planted imports: {got}")
    if lint_source(planted, path="tests/test_x.py"):
        _err("pickle-import lint fired inside tests/ (exempt by design)")
    if lint_source("import pickle  # lint-ok: pickle-import -- fixture\n",
                   path="authorino_tpu_torch/x.py"):
        _err("pickle-import lint ignored a `# lint-ok:` suppression")
    return errors


def _atomic_write_lint_selftest() -> List[Finding]:
    from .code_lint import lint_source

    errors: List[Finding] = []

    def _err(msg: str) -> None:
        errors.append(Finding(kind="lint-blind", layer="code_lint",
                              message=msg, location="fixtures"))

    planted = (
        "import os\n"
        "def persist(state_dir, blob):\n"
        "    with open(os.path.join(state_dir, 'MANIFEST.json'), 'w') as f:\n"
        "        f.write(blob)\n"
    )
    got = [f.kind for f in lint_source(planted, path="authorino_tpu_torch/x.py")]
    if got != ["non-atomic-write"]:
        _err(f"non-atomic-write lint BLIND to a planted raw write: {got}")
    if lint_source(planted, path="tests/test_x.py"):
        _err("non-atomic-write lint fired inside tests/ (exempt by design)")
    disciplined = (
        "import os\n"
        "def persist(state_dir, blob):\n"
        "    path = os.path.join(state_dir, 'MANIFEST.json')\n"
        "    with open(path + '.tmp', 'w') as f:\n"
        "        f.write(blob)\n"
        "        f.flush()\n"
        "        os.fsync(f.fileno())\n"
        "    os.replace(path + '.tmp', path)\n"
    )
    if lint_source(disciplined, path="authorino_tpu_torch/x.py"):
        _err("non-atomic-write lint fired on the tmp+fsync+rename "
             "discipline itself")
    suppressed = planted.replace(
        "as f:", "as f:  # lint-ok: non-atomic-write -- fixture", 1)
    if lint_source(suppressed, path="authorino_tpu_torch/x.py"):
        _err("non-atomic-write lint ignored a `# lint-ok:` suppression")
    return errors


def _corpus_selftest(policy) -> List[Finding]:
    import os
    import tempfile

    from ..compiler.compile import compile_corpus
    from ..corpus import (
        CorpusFormatError,
        distill_records,
        read_corpus_file,
        write_corpus,
    )
    from ..corpus.pregate import corpus_preflight
    from ..corpus.synthesize import augment_corpus
    from ..expressions import All, Operator, Pattern
    from ..runtime.change_safety import GuardThresholds
    from .fixtures import fixture_configs

    errors: List[Finding] = []

    def _err(msg: str) -> None:
        errors.append(Finding(kind="corpus-blind", layer="corpus",
                              message=msg, location="fixtures"))

    # captured traffic hits ONLY 'api' — 'admin' and 'public' are the
    # zero-traffic configs whose rules only synthesis can witness
    api_doc = {"request": {"method": "GET", "url_path": "/api/v1/x",
                           "host": "h", "headers": {"x-tag": "aa"}},
               "auth": {"identity": {"org": "acme", "roles": ["admin"],
                                     "groups": []}}}
    records = [{"authconfig": "api", "doc": api_doc, "t": 1.0 + i * 0.01}
               for i in range(64)]
    d = distill_records(records, policy)
    if d["counters"]["distilled"] != 1 \
            or d["rows"][0]["weight"] != 64:
        _err(f"distillation lost the frequency weight: 64 identical "
             f"records -> {d['counters']} / "
             f"weights {[r['weight'] for r in d['rows']]}")

    # corpus container round-trip + typed corruption rejection (the
    # pickle-free invariant, corpus flavor)
    tmp = tempfile.mktemp(suffix=".atpucorp")
    try:
        write_corpus(tmp, d["rows"])
        _, rt = read_corpus_file(tmp)
        if rt != d["rows"]:
            _err("corpus container did not round-trip bit-identically")
        with open(tmp, "rb") as f:
            blob = bytearray(f.read())
        blob[len(blob) // 2] ^= 0xFF
        with open(tmp, "wb") as f:  # lint-ok: non-atomic-write -- deliberately planting corruption
            f.write(bytes(blob))
        try:
            read_corpus_file(tmp)
            _err("corrupted corpus container was NOT rejected")
        except CorpusFormatError:
            pass
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)

    # synthesis must RAISE coverage over the captured-only corpus — a
    # blind synthesizer (zero rows, no admin witness) fails right here
    aug = augment_corpus(policy, d["rows"])
    if aug["coverage_after"]["fraction"] <= aug["coverage_before"]["fraction"]:
        _err(f"synthesis did not raise coverage "
             f"({aug['coverage_before']['fraction']} -> "
             f"{aug['coverage_after']['fraction']})")
    synth = aug["rows"]
    if not any(r["authconfig"] == "admin" and r["verdict"] == "allow"
               for r in synth):
        _err("synthesizer produced no 'admin' allow witness (the row a "
             "constant-deny edit must flip)")
    if any(r["origin"] != "synthetic" for r in synth):
        _err("synthesized rows not flagged origin=synthetic")

    # planted constant-deny edit on zero-traffic 'admin' evaluator 0
    org = Pattern("auth.identity.org", Operator.EQ, "acme")
    norg = Pattern("auth.identity.org", Operator.NEQ, "acme")
    mutated = fixture_configs()
    for i, c in enumerate(mutated):
        if c.name == "admin":
            mutated[i] = type(c)(name="admin", evaluators=[
                (None, All(org, norg)), c.evaluators[1]])
    candidate = compile_corpus(mutated)
    th = GuardThresholds(min_requests=8, min_config_requests=1,
                         min_config_allows=1)

    # captured-only evidence MUST miss it (zero 'admin' traffic) ...
    blind = corpus_preflight(policy, candidate, d["rows"], th,
                             changed={"admin"})
    if blind["breach"] is not None:
        _err("captured-only corpus breached on a zero-traffic edit "
             "(self-test premise broken: 'admin' traffic leaked in)")
    # ... and the synthesized rows MUST catch it, attributed to 'admin'
    pf = corpus_preflight(policy, candidate, d["rows"] + synth, th,
                          changed={"admin"})
    breach = pf["breach"]
    if breach is None or "admin" not in breach.get("suspects", []):
        _err(f"corpus pregate BLIND to the planted zero-traffic "
             f"constant-deny edit: {breach}")
    else:
        origins = pf["report"]["origins"]
        if origins.get("captured", {}).get("flips", 0) != 0 \
                or origins.get("synthetic", {}).get("flips", 0) < 1:
            _err(f"the catch did not come from synthetic-origin rows: "
                 f"{origins}")
    # clean churn (fresh tree objects, identical corpus) must stay quiet
    clean = corpus_preflight(policy, compile_corpus(fixture_configs()),
                             d["rows"] + synth, th, changed={"admin"})
    if clean["breach"] is not None:
        _err("corpus pregate breached on a CLEAN churn")
    return errors


def _relations_selftest() -> List[Finding]:
    import numpy as np

    from ..snapshots.serialize import deserialize_policy, serialize_policy
    from .fixtures import relations_fixture_policy
    from .tensor_lint import tensor_lint
    from .translation_validate import relations_mutation_self_test

    errors: List[Finding] = []
    policy = relations_fixture_policy()
    errors += tensor_lint(policy)
    errors += relations_mutation_self_test(policy)
    try:
        loaded, _meta = deserialize_policy(serialize_policy(policy))
        for name in ("rel_bits", "leaf_rel_slot", "leaf_rel_col",
                     "num_attr_slot", "leaf_const"):
            if not np.array_equal(getattr(policy, name),
                                  getattr(loaded, name)):
                errors.append(Finding(
                    kind="serialize-lossy", layer="snapshots",
                    message=f"relation corpus round-trip changed {name}",
                    location="relations_selftest"))
        errors += tensor_lint(loaded)
    except Exception as e:
        errors.append(Finding(
            kind="serialize-lossy", layer="snapshots",
            message=f"relation corpus failed container round-trip: {e!r}",
            location="relations_selftest"))
    return errors


def _replay_selftest(policy) -> List[Finding]:
    import os
    import tempfile

    from ..compiler.compile import compile_corpus
    from ..expressions.ast import And, Operator, Or, Pattern
    from ..replay.capture import (
        CAPTURE_SCHEMA,
        CaptureFormatError,
        read_segment,
        write_segment,
    )
    from ..replay.pregate import pregate_check
    from ..replay.replay import replay_records
    from ..runtime.change_safety import GuardThresholds
    from .fixtures import fixture_configs

    errors: List[Finding] = []

    def _err(msg: str) -> None:
        errors.append(Finding(kind="replay-blind", layer="replay",
                              message=msg, location="fixtures"))

    # a captured traffic window over the fixture corpus: 'api' requests the
    # corpus ALLOWS (these must flip under the planted mutation) plus
    # 'admin' / 'public' bystander traffic (these must NOT)
    api_doc = {"request": {"method": "GET", "url_path": "/api/v1/x",
                           "host": "h", "headers": {"x-tag": "aa"}},
               "auth": {"identity": {"org": "acme", "roles": ["admin"],
                                     "groups": []}}}
    admin_doc = {"request": {"method": "GET", "url_path": "/x", "host": "h",
                             "headers": {}},
                 "auth": {"identity": {"org": "acme", "roles": ["admin"],
                                       "groups": []}}}
    records = []
    for i in range(16):
        records.append({"schema": CAPTURE_SCHEMA, "t": 1.0 + i * 0.01,
                        "authconfig": "api", "doc": api_doc,
                        "verdict": "allow", "rule_index": -1,
                        "lane": "engine", "generation": 1})
        records.append({"schema": CAPTURE_SCHEMA, "t": 1.005 + i * 0.01,
                        "authconfig": "admin", "doc": admin_doc,
                        "verdict": "allow", "rule_index": -1,
                        "lane": "engine", "generation": 1})

    # capture container round-trip: bit-identical records, and a corrupted
    # blob must be rejected typed (never misparsed)
    tmp = tempfile.mktemp(suffix=".atpucap")
    try:
        write_segment(tmp, records)
        _, rt = read_segment(tmp)
        if rt != records:
            _err("capture segment did not round-trip bit-identically")
        with open(tmp, "rb") as f:
            blob = bytearray(f.read())
        blob[len(blob) // 2] ^= 0xFF
        with open(tmp, "wb") as f:  # lint-ok: non-atomic-write -- deliberately planting corruption
            f.write(bytes(blob))
        try:
            read_segment(tmp)
            _err("corrupted capture segment was NOT rejected")
        except CaptureFormatError:
            pass
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)

    # clean churn: an identical corpus (fresh tree objects) must diff EMPTY
    clean = replay_records(policy, compile_corpus(fixture_configs()),
                           records)
    if clean["flips"]["total"] != 0:
        _err(f"identical corpora produced a non-empty verdict diff: "
             f"{clean['by_rule']}")

    # planted one-rule mutation: 'api' evaluator 0's method guard flips
    # from NEQ TRACE to NEQ GET — every captured GET the corpus allowed is
    # now denied BY THAT RULE, and nothing else moves
    def _flip_method(expr):
        if isinstance(expr, Pattern):
            if expr.selector == "request.method":
                return Pattern(expr.selector, Operator.NEQ, "GET")
            return expr
        kids = tuple(_flip_method(c) for c in expr.children)
        return And(kids) if isinstance(expr, And) else Or(kids)

    mutated = fixture_configs()
    mutated[0] = type(mutated[0])(name="api", evaluators=[
        (cond, _flip_method(rule) if e == 0 else rule)
        for e, (cond, rule) in enumerate(mutated[0].evaluators)
    ])
    diff = replay_records(policy, compile_corpus(mutated), records)
    if diff["flips"]["newly_denied"] != 16 or \
            diff["flips"]["newly_allowed"] != 0:
        _err(f"replay differ BLIND: planted mutation should newly-deny "
             f"exactly the 16 captured 'api' allows, got "
             f"{diff['flips']}")
    wrong = [g for g in diff["by_rule"]
             if g["authconfig"] != "api" or g["rule_index"] != 0
             or g["direction"] != "newly-denied"]
    if wrong or not diff["by_rule"]:
        _err(f"replay differ mis-attributed the planted flip (want only "
             f"api rule[0] newly-denied): {diff['by_rule']}")

    # the pregate must breach on that diff (with 'api' the suspect) and
    # stay quiet on the clean one
    th = GuardThresholds(min_requests=8, min_config_requests=4,
                         min_config_allows=2)
    b = pregate_check(diff, th, changed={"api"})
    if b is None or "api" not in b.get("suspects", []):
        _err(f"replay pregate BLIND to the planted flip: {b}")
    if pregate_check(clean, th, changed={"api"}) is not None:
        _err("replay pregate breached on a CLEAN churn")
    return errors


def _snapshot_selftest(policy) -> List[Finding]:
    import numpy as np

    from ..compiler.compile import compile_corpus
    from ..expressions.ast import Pattern
    from ..snapshots.diff import snapshot_diff
    from ..snapshots.fingerprint import rules_fingerprint
    from ..snapshots.serialize import deserialize_policy, serialize_policy
    from .fixtures import fixture_configs

    errors: List[Finding] = []
    configs = fixture_configs()
    fps = {c.name: rules_fingerprint(c) for c in configs}
    blob = serialize_policy(policy, meta={"fingerprints": fps,
                                          "certified": True})
    rt, meta = deserialize_policy(blob)
    for name in ("leaf_op", "leaf_attr", "leaf_const", "eval_cond",
                 "eval_rule", "eval_has_cond", "dfa_tables", "dfa_accept",
                 "config_cacheable"):
        if not np.array_equal(getattr(policy, name), getattr(rt, name)):
            errors.append(Finding(
                kind="serialize-roundtrip", layer="snapshots",
                message=f"array {name!r} did not round-trip bit-identically",
                location="fixtures"))
    if rt.config_ids != policy.config_ids or \
            rt.attr_selectors != policy.attr_selectors:
        errors.append(Finding(
            kind="serialize-roundtrip", layer="snapshots",
            message="config/attr metadata did not round-trip",
            location="fixtures"))

    # plant exactly one SHAPE-PRESERVING change — 'api' blocks a different
    # method constant (only 'api' lowers that leaf, and a const swap keeps
    # every padded grid identical) — and demand the diff names it, and
    # nothing else
    changed = fixture_configs()

    def _swap_method(expr):
        from ..expressions.ast import And, Or

        if isinstance(expr, Pattern):
            if expr.selector == "request.method":
                return Pattern(expr.selector, expr.operator, "PLANTED")
            return expr
        kids = tuple(_swap_method(c) for c in expr.children)
        return And(kids) if isinstance(expr, And) else Or(kids)

    changed[0] = type(changed[0])(name="api", evaluators=[
        (cond if cond is None else _swap_method(cond), _swap_method(rule))
        for cond, rule in changed[0].evaluators
    ])
    fps2 = {c.name: rules_fingerprint(c) for c in changed}
    d = snapshot_diff(fps, fps2)
    if d["changed"] != ["api"] or d["added"] or d["removed"]:
        errors.append(Finding(
            kind="diff-blind", layer="snapshots",
            message=f"snapshot diff missed the planted change: {d}",
            location="fixtures"))
    # ... and that an UNCHANGED corpus diffs empty (fresh tree objects:
    # fingerprints are structural, not identity-based)
    d0 = snapshot_diff(fps, {c.name: rules_fingerprint(c)
                             for c in fixture_configs()})
    if d0["recompile"] or d0["removed"]:
        errors.append(Finding(
            kind="diff-blind", layer="snapshots",
            message=f"identical corpora diffed non-empty: {d0}",
            location="fixtures"))
    # the mutated corpus must also produce a rows-level delta plan against
    # the original (same padded shapes, a handful of touched rows)
    from ..snapshots.diff import plan_delta

    try:
        from ..ops.pattern_eval import to_device

        plan = plan_delta(to_device(policy, host=True),
                          to_device(compile_corpus(
                              changed, members_k=policy.members_k,
                              interner=policy.interner.freeze_copy()),
                              host=True))
        if plan is None:
            errors.append(Finding(
                kind="diff-blind", layer="snapshots",
                message="shape-preserving mutation produced no delta plan "
                        "(full re-stage forced)", location="fixtures"))
        elif plan.upload_bytes >= plan.full_bytes:
            errors.append(Finding(
                kind="diff-blind", layer="snapshots",
                message="delta plan is not smaller than a full re-stage "
                        f"({plan.upload_bytes} >= {plan.full_bytes})",
                location="fixtures"))
    except Exception as e:
        errors.append(Finding(
            kind="diff-blind", layer="snapshots",
            message=f"delta planning failed: {e!r}", location="fixtures"))
    return errors


def _run_snapshot_diff(old_path: str, new_path: str) -> dict:
    """Human-readable diff between two serialized snapshots:
    the recompile set by config fingerprint, then the operand rows/bytes a
    delta upload would ship.  Accepts blob files or publish directories
    (snapshots/distribution.py MANIFEST layout)."""
    import os

    from ..ops.pattern_eval import to_device
    from ..snapshots.diff import format_snapshot_diff, plan_delta, snapshot_diff
    from ..snapshots.distribution import load_latest, load_snapshot_blob

    def load(path):
        if os.path.isdir(path) or path.startswith(("http://", "https://")):
            return load_latest(path)
        with open(path, "rb") as f:
            return load_snapshot_blob(f.read())

    old, new = load(old_path), load(new_path)
    old_view = to_device(old.policy, host=True)
    new_view = to_device(new.policy, host=True)
    text = format_snapshot_diff(old.meta, new.meta, old_view, new_view)
    plan = plan_delta(old_view, new_view)
    return {
        "text": text,
        "configs": snapshot_diff(old.fingerprints, new.fingerprints),
        "delta": plan.to_json() if plan is not None else {"mode": "full"},
        "old_generation": old.generation,
        "new_generation": new.generation,
    }


def _load_snapshot_arg(path: str):
    """A serialized snapshot blob file OR a publish directory / HTTP
    mirror (snapshots/distribution.py MANIFEST layout) → LoadedSnapshot."""
    import os

    from ..snapshots.distribution import load_latest, load_snapshot_blob

    if os.path.isdir(path) or path.startswith(("http://", "https://")):
        return load_latest(path)
    with open(path, "rb") as f:
        return load_snapshot_blob(f.read())


def _run_replay(old_path: str, new_path: str, log_src: str,
                budget_s=None, metadata_docs_src: str = "") -> dict:
    """Offline what-if replay (docs/replay.md): re-decide a
    captured traffic log against two published snapshots through the
    exact host oracle and report the verdict diff — which requests flip
    allow<->deny, attributed to which (authconfig, rule) on the flipping
    side.  The same seam the in-process --replay-pregate judges, so the
    offline run reproduces the gate's verdict exactly.

    ``metadata_docs_src`` (--metadata-docs) un-blinds metadata-
    dependent configs: a {config: {metadata_name: document}} JSON file
    (MetadataPrefetcher.export_docs shape) substituted into auth.metadata
    before re-deciding; captured metadata_doc_digest mismatches are
    counted in the report's metadata block."""
    from ..replay.capture import read_capture
    from ..replay.pregate import pregate_check
    from ..replay.replay import replay_records

    old, new = _load_snapshot_arg(old_path), _load_snapshot_arg(new_path)
    records = read_capture(log_src)
    metadata_docs = (_load_json_source(metadata_docs_src)
                     if metadata_docs_src else None)
    report = replay_records(old, new, records, time_budget_s=budget_s,
                            metadata_docs=metadata_docs)
    # judged with the DEFAULT guard thresholds and the fingerprint-diff
    # changed set, exactly like the engine's pregate would
    from ..snapshots.diff import snapshot_diff

    changed = set(snapshot_diff(old.fingerprints or {},
                                new.fingerprints or {})["recompile"]) or None
    report["pregate"] = pregate_check(report, changed=changed)
    return report


def _corpus_analysis(policy) -> Optional[dict]:
    """Static findings in the shape corpus synthesis consumes (the
    /debug/vars policy_analysis block): lets a statically-dead column get
    its honest reason code instead of 'unsatisfiable'.  Best-effort — a
    failed analysis only degrades reason codes, never the corpus."""
    try:
        from .policy_analysis import analyze_policy

        findings, _ = analyze_policy(policy)
        return {"findings": findings_to_json(findings)}
    except Exception:
        return None


def _run_corpus_distill(snapshot_path: str, log_src: str,
                        out_path: str) -> dict:
    """``--corpus-distill`` (docs/policy_ci.md): fold a captured
    traffic log into the long-retention decision corpus — rows deduplicated
    by the canonical encoded row key, carrying frequency weights and
    first/last-seen — and write it as a checksummed ``.atpucorp``
    container.  Also synthesizes rows for every (config, rule) column the
    captured traffic never exercised, so the corpus covers the whole truth
    table, not just the traffic that happened."""
    from ..corpus import distill_records, write_corpus
    from ..corpus.synthesize import augment_corpus
    from ..replay.capture import read_capture

    snap = _load_snapshot_arg(snapshot_path)
    records = read_capture(log_src)
    d = distill_records(records, snap.policy)
    aug = augment_corpus(snap.policy, d["rows"],
                         analysis=_corpus_analysis(snap.policy))
    rows = d["rows"] + aug["rows"]
    if out_path:
        write_corpus(out_path, rows)
    return {
        "schema": 1,
        "generation": snap.generation,
        "counters": d["counters"],
        "dedup_ratio": d["dedup_ratio"],
        "captured_rows": len(d["rows"]),
        "synthetic_rows": len(aug["rows"]),
        "coverage_before": aug["coverage_before"]["fraction"],
        "coverage_after": aug["coverage_after"]["fraction"],
        "synthesis": aug["synthesis"],
        "out": out_path,
    }


def _run_corpus_report(snapshot_path: str, corpus_src: str) -> dict:
    """``--corpus-report``: per-(config, rule) exercised /
    unexercised coverage of an existing corpus against a snapshot,
    cross-referenced with static findings, plus the synthesis plan for
    the gaps (every uncoverable column with its typed reason code)."""
    from ..corpus import read_corpus
    from ..corpus.synthesize import augment_corpus, coverage_report

    snap = _load_snapshot_arg(snapshot_path)
    rows = read_corpus(corpus_src)
    analysis = _corpus_analysis(snap.policy)
    cov = coverage_report(snap.policy, rows, analysis=analysis)
    aug = augment_corpus(snap.policy, rows, analysis=analysis)
    origins = {"captured": 0, "synthetic": 0}
    for r in rows:
        o = r.get("origin", "captured")
        origins[o] = origins.get(o, 0) + 1
    return {
        "schema": 1,
        "generation": snap.generation,
        "rows": len(rows),
        "origins": origins,
        "coverage": cov,
        "synthesis": aug["synthesis"],
        "coverage_after_synthesis": aug["coverage_after"]["fraction"],
    }


def _run_corpus_diff(chain_dir: str, corpus_src: str) -> dict:
    """``--corpus-diff``: re-decide the corpus across every
    published snapshot generation in ``chain_dir`` (oldest -> newest) and
    attribute each verdict flip to the EXACT generation that introduced
    it — offline history bisection with no live traffic."""
    from ..corpus import read_corpus
    from ..corpus.bisect import corpus_diff, load_generation_chain

    chain = load_generation_chain(chain_dir)
    if len(chain) < 2:
        raise SystemExit(
            f"--corpus-diff needs >=2 loadable generations in {chain_dir!r}, "
            f"found {len(chain)}")
    rows = read_corpus(corpus_src)
    return corpus_diff(chain, rows)


def _print_corpus_diff(report: dict) -> None:
    gens = report["generations"]
    print(f"corpus-diff: {report['rows']} rows across generations "
          f"{gens[0]}..{gens[-1]} ({len(gens)} published)")
    print(f"  flipped rows: {report['flipped_rows']} "
          f"(weighted flips by generation: {report['by_generation'] or '{}'})")
    for f in report["flips"]:
        print(f"  gen {f['from_generation']} -> {f['generation']}: "
              f"{f['authconfig']} {f['direction']} x{f['count']} "
              f"(rule {f['rule_index']}{' ' + f['rule'] if f['rule'] else ''},"
              f" origins {','.join(f['origins'])})")
    if not report["flips"]:
        print("  no verdict flips: every generation decides the corpus "
              "identically")


def _run_metrics_catalog() -> dict:
    """Metrics-catalogue drift gate: every family registered in
    utils/metrics.py must appear in docs/observability.md and vice versa,
    but for the named ``NOT_YET_PORTED`` families; and the tenant-label
    cardinality lint: every `tenant`-labelled family must declare its
    top-K bound.  Non-empty drift or cardinality violations fail the
    command (and the tests)."""
    from .metrics_catalog import (
        DOC_PATH,
        catalog_drift,
        tenant_cardinality_lint,
    )

    missing, stale = catalog_drift()
    tenant = tenant_cardinality_lint()
    return {"doc": DOC_PATH, "missing_in_docs": missing,
            "stale_in_docs": stale, "tenant_cardinality": tenant,
            "ok": not missing and not stale and not tenant}


def _load_json_source(src: str) -> dict:
    """JSON from a local file or an http(s) URL (e.g. a live server's
    /debug/decisions, or a flight-recorder bundle on disk)."""
    if src.startswith(("http://", "https://")):
        from urllib.request import urlopen

        with urlopen(src, timeout=10) as resp:  # nosec - operator-given URL
            return json.loads(resp.read().decode("utf-8"))
    with open(src, "r") as f:
        return json.load(f)


def _fmt_ts(t) -> str:
    import datetime

    try:
        return datetime.datetime.fromtimestamp(float(t)).strftime(
            "%H:%M:%S.%f")[:-3]
    except Exception:
        return str(t)


def _print_decisions(report: dict) -> None:
    """Pretty-print a decision-log JSON (/debug/decisions shape)."""
    records = report.get("records", [])
    print(f"decision log: {len(records)} record(s) shown, "
          f"{report.get('records_total', len(records))} sampled total "
          f"(1-in-{report.get('sample_n', '?')}, "
          f"ring capacity {report.get('capacity', '?')})")
    if not records:
        return
    print(f"{'time':<12} {'lane':<8} {'verdict':<7} {'gen':<5} "
          f"{'ms':>8}  {'host':<20} {'authconfig':<24} rule")
    for r in records:
        print(f"{_fmt_ts(r.get('t')):<12} {str(r.get('lane', '')):<8} "
              f"{str(r.get('verdict', '')):<7} "
              f"{str(r.get('generation', '')):<5} "
              f"{r.get('latency_ms', 0):>8.2f}  "
              f"{str(r.get('host', ''))[:20]:<20} "
              f"{str(r.get('authconfig', ''))[:24]:<24} "
              f"{r.get('rule') or '-'}")


def _print_flight_bundle(bundle: dict) -> None:
    """Pretty-print one flight-recorder diagnostic bundle."""
    from ..runtime.flight_recorder import ANOMALY_KINDS, BUNDLE_SCHEMA

    if bundle.get("kind") != "authorino-tpu-flight-bundle":
        print("not a flight-recorder bundle (missing kind marker)")
        return
    if bundle.get("schema") != BUNDLE_SCHEMA:
        print(f"WARNING: bundle schema {bundle.get('schema')} != "
              f"reader schema {BUNDLE_SCHEMA} — fields may be missing")
    events = bundle.get("events", [])
    anomalies = [e for e in events if e.get("kind") in ANOMALY_KINDS]
    print(f"flight bundle: trigger={bundle.get('trigger')} "
          f"at {_fmt_ts(bundle.get('t'))} pid={bundle.get('pid')}")
    print(f"  {len(events)} event(s) in the ring, "
          f"{len(anomalies)} anomalies")
    for comp, dv in (bundle.get("vars") or {}).items():
        if not isinstance(dv, dict):
            continue
        breaker = (dv.get("breaker") or {}).get("state")
        adm = (dv.get("admission") or {}).get("state")
        gen = dv.get("generation", dv.get("snapshot"))
        print(f"  {comp}: breaker={breaker} admission={adm} "
              f"generation={gen}")
    print("event trail (oldest first):")
    for e in events:
        mark = "!" if e.get("kind") in ANOMALY_KINDS else " "
        detail = e.get("detail")
        detail_s = json.dumps(detail, default=str) if detail else ""
        print(f" {mark} {_fmt_ts(e.get('t'))} "
              f"{str(e.get('lane', '')):<8} {e.get('kind'):<22} "
              f"{detail_s[:100]}")
    # replay-pregate breaches: the bundle froze the top-N
    # attributed verdict-diff rows — the WHY of the rejected swap
    for e in events:
        if e.get("kind") != "replay-pregate-breach":
            continue
        b = (e.get("detail") or {}).get("breach") or {}
        print(f"replay-pregate breach at {_fmt_ts(e.get('t'))}: "
              f"guards={','.join(b.get('guards', []))} "
              f"replayed={b.get('replayed')} "
              f"suspects={','.join(b.get('suspects', []))}")
        for g in b.get("top_flips", []):
            print(f"    {g.get('direction'):<14} {g.get('count'):>6}  "
                  f"{g.get('authconfig')}  rule[{g.get('rule_index')}] "
                  f"{g.get('rule')}")
    if bundle.get("metrics"):
        print(f"  (+ {len(bundle['metrics'])} bytes of /metrics exposition "
              f"in the bundle)")


def _resolve_kernel_cost(report: dict):
    """Find the kernel_cost block in SRC: top-level (bench artifact or the
    block itself) or nested under a /debug/vars lane (engine, native)."""
    if not isinstance(report, dict):
        return None
    if "ledger" in report:
        return report
    for key in ("kernel_cost", "engine", "native"):
        sub = report.get(key)
        if isinstance(sub, dict):
            kc = _resolve_kernel_cost(sub)
            if kc is not None:
                return kc
    return None


def _print_kernel_cost(report: dict) -> None:
    """Pretty-print a kernel-cost block: SRC is a /debug/vars
    URL or saved JSON (engine or native lane), a bench artifact with a
    ``kernel_cost`` key, or the block itself."""
    kc = _resolve_kernel_cost(report)
    if not isinstance(kc, dict) or "ledger" not in kc:
        print("no kernel_cost block found (expected a /debug/vars dump, "
              "a bench artifact, or the block itself)")
        return
    ledger = kc.get("ledger") or {}
    print("kernel cost ledger (structural, per lane):")
    cols = ("batches", "launches", "launches_per_batch",
            "zero_launch_batches", "rows", "device_rows", "pad_rows",
            "pad_waste_rows", "h2d_bytes", "d2h_bytes",
            "dedup_avoided_rows", "cache_avoided_rows")
    print(f"  {'lane':<8}" + "".join(f" {c:>19}" for c in cols))
    for lane, lc in sorted(ledger.items()):
        print(f"  {lane:<8}" + "".join(
            f" {lc.get(c, 0):>19}" for c in cols))
    modeled = kc.get("modeled") or {}
    cur = modeled.get("current") or {}
    print(f"modeled cost ({modeled.get('component', '?')}): "
          f"{modeled.get('generations_analyzed', 0)} generation(s) "
          f"analyzed, {modeled.get('regressions_seen', 0)} regression(s)")
    for name, e in sorted((cur.get("entries") or {}).items()):
        print(f"  {name}: {e.get('flops_per_row')} flops/row, "
              f"{e.get('bytes_per_row')} bytes/row "
              f"(pad {e.get('pad')}, eff {e.get('eff')})")
    for r in cur.get("regressions", []):
        print(f"  REGRESSION {r.get('entry')}.{r.get('axis')}: "
              f"{r.get('previous')} -> {r.get('current')} "
              f"({r.get('ratio')}x vs generation "
              f"{r.get('previous_generation')})")
    eps = kc.get("entry_points") or []
    if eps:
        print("jit entry points (serving snapshot):")
        for ep in eps:
            print(f"  {ep.get('entry')}: {ep.get('kind')}")
            print(f"    operands: {', '.join(ep.get('operands', []))}")


def _run_change_safety_override(server: str, action: str) -> dict:
    """POST the manual change-safety override to a live server's
    /debug/canary endpoint (docs/robustness.md "Change safety")
    and return its JSON response."""
    from urllib.request import Request, urlopen

    url = server.rstrip("/") + "/debug/canary?action=" + action
    req = Request(url, method="POST")
    with urlopen(req, timeout=10) as resp:  # nosec - operator-given URL
        return json.loads(resp.read().decode("utf-8"))


def _run_coverage_report() -> dict:
    """Lowerability report over the fixture corpus (the relations
    fixtures widen it with numeric/relation/assist configs, and the
    blocking_reasons rollup makes per-reason progress visible)."""
    from ..compiler.compile import compile_corpus
    from .fixtures import (
        FixtureEntry,
        lowerability_fixture_entries,
        relations_fixture_configs,
    )
    from .translation_validate import lowerability_report

    entries = lowerability_fixture_entries()
    entries += [FixtureEntry(id=c.name, hosts=[c.name], rules=c)
                for c in relations_fixture_configs()]
    rules = [e.rules for e in entries if e.rules is not None]
    return lowerability_report(entries,
                               compile_corpus(rules, ovf_assist=True))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m authorino_tpu_torch.analysis",
        description="Static analysis: code lint + compiled-snapshot verify")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs for --self-lint (default: the package)")
    ap.add_argument("--self-lint", action="store_true",
                    help="async-hazard code lint")
    ap.add_argument("--verify-fixtures", action="store_true",
                    help="tensor-lint a snapshot compiled from fixture "
                         "AuthConfigs (+ analyzer and translation-validator "
                         "self-tests)")
    ap.add_argument("--coverage-report", action="store_true",
                    help="fast-lane vs slow-lane lowerability report with "
                         "reason codes over the fixture corpus")
    ap.add_argument("--snapshot-diff", nargs=2, metavar=("OLD", "NEW"),
                    help="human-readable diff between two serialized "
                         "snapshots (blob files or publish directories): "
                         "configs recompiled, operand rows touched, delta "
                         "vs full upload bytes (docs/control_plane.md)")
    ap.add_argument("--replay", nargs=2, metavar=("OLD", "NEW"),
                    help="what-if replay (docs/replay.md): re-decide the "
                         "captured traffic in --log against two serialized "
                         "snapshots (blob files or publish directories) "
                         "and report the verdict diff — which requests "
                         "flip allow<->deny, attributed per (authconfig, "
                         "rule).  Exit 1 when any request flips")
    ap.add_argument("--log", metavar="SRC",
                    help="capture log for --replay: a *.atpucap segment "
                         "file or a capture directory (--capture-log-dir / "
                         "bench --capture-log)")
    ap.add_argument("--replay-budget-s", type=float, default=None,
                    help="optional wall-clock bound for --replay (records "
                         "past it are reported as truncated)")
    ap.add_argument("--metadata-docs", metavar="FILE", default="",
                    help="un-blind --replay for metadata-dependent configs "
                         "(docs/replay.md): a {config: {name: document}} "
                         "JSON of pinned prefetched metadata documents "
                         "substituted into auth.metadata before "
                         "re-deciding; captured metadata_doc_digest "
                         "mismatches are counted in the report")
    ap.add_argument("--corpus-distill", metavar="SNAPSHOT", default="",
                    help="distill --log captured traffic into a deduplicated "
                         "decision corpus against SNAPSHOT (blob file or "
                         "publish dir), synthesize rows for unexercised "
                         "rule columns, and write it to --corpus-out "
                         "(docs/policy_ci.md)")
    ap.add_argument("--corpus-report", metavar="SNAPSHOT", default="",
                    help="per-(config, rule) coverage of the --corpus rows "
                         "against SNAPSHOT, plus the synthesis plan with "
                         "typed uncoverable-reason codes")
    ap.add_argument("--corpus-diff", metavar="CHAIN_DIR", default="",
                    help="re-decide the --corpus rows across every "
                         "published generation in CHAIN_DIR and name the "
                         "exact generation introducing each verdict flip")
    ap.add_argument("--corpus", metavar="SRC", default="",
                    help="corpus source for --corpus-report/--corpus-diff: "
                         "an .atpucorp file or a directory of them")
    ap.add_argument("--corpus-out", metavar="FILE", default="",
                    help="output .atpucorp path for --corpus-distill")
    ap.add_argument("--metrics-catalog", action="store_true",
                    help="drift gate: every metric family registered in "
                         "utils/metrics.py must appear in "
                         "docs/observability.md and vice versa (exit 1 on "
                         "drift)")
    ap.add_argument("--decisions", metavar="SRC",
                    help="pretty-print a decision log: SRC is a live "
                         "server's /debug/decisions URL or a saved JSON "
                         "file (docs/observability.md 'Decision "
                         "provenance')")
    ap.add_argument("--kernel-cost", metavar="SRC",
                    help="pretty-print the kernel cost observatory block "
                         ": SRC is a live server's /debug/vars "
                         "URL, a saved JSON dump, or a bench artifact "
                         "with a kernel_cost key (docs/performance.md "
                         "'Kernel cost model')")
    ap.add_argument("--flight-dump", metavar="FILE",
                    help="pretty-print a flight-recorder diagnostic bundle "
                         "(the JSON auto-dumped on anomaly triggers; "
                         "docs/observability.md 'Flight recorder')")
    ap.add_argument("--rollback", metavar="SERVER",
                    help="OPERATOR OVERRIDE (change safety, docs/"
                         "robustness.md): roll back the server's "
                         "in-progress canary — or, with none active, its "
                         "last retained snapshot generation.  SERVER is "
                         "the HTTP base URL (e.g. http://host:5001)")
    ap.add_argument("--promote", metavar="SERVER",
                    help="OPERATOR OVERRIDE: promote the server's "
                         "in-progress canary to 100%% immediately, guard "
                         "unconsulted")
    ap.add_argument("--clear-quarantine", metavar="SERVER",
                    help="OPERATOR OVERRIDE: release the server's active "
                         "poison-config quarantine (the next reconcile "
                         "serves the specs as written)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable report on stdout")
    args = ap.parse_args(argv)

    override = next(
        ((act, url) for act, url in (
            ("rollback", args.rollback), ("promote", args.promote),
            ("clear-quarantine", args.clear_quarantine)) if url), None)
    if override:
        action, server = override
        report = _run_change_safety_override(server, action)
        if args.as_json:
            print(json.dumps(report, indent=2, sort_keys=True, default=str))
        else:
            cs = report.get("change_safety") or {}
            print(f"{action}: {'applied' if report.get('applied') else 'NOT applied (nothing to do)'}")
            print(f"  canary: {cs.get('canary')}")
            print(f"  quarantine: {cs.get('quarantine')}")
            print(f"  last_rollback: {cs.get('last_rollback')}")
        return 0 if report.get("applied") else 1

    if args.snapshot_diff:
        report = _run_snapshot_diff(*args.snapshot_diff)
        if args.as_json:
            out = dict(report)
            out.pop("text", None)
            print(json.dumps(out, indent=2, sort_keys=True))
        else:
            print(report["text"])
        return 0

    if args.replay:
        if not args.log:
            ap.error("--replay requires --log (a capture segment or "
                     "directory)")
        from ..replay.replay import format_replay_report

        report = _run_replay(*args.replay, args.log,
                             budget_s=args.replay_budget_s,
                             metadata_docs_src=args.metadata_docs)
        if args.as_json:
            print(json.dumps(report, indent=2, sort_keys=True, default=str))
        else:
            print(format_replay_report(report))
            gate = report.get("pregate")
            print(f"pregate verdict (default thresholds): "
                  f"{'BREACH ' + ','.join(gate['guards']) if gate else 'pass'}")
        return 1 if report["flips"]["total"] else 0

    if args.corpus_distill:
        if not args.log:
            ap.error("--corpus-distill requires --log (a capture segment "
                     "or directory)")
        report = _run_corpus_distill(args.corpus_distill, args.log,
                                     args.corpus_out)
        if args.as_json:
            print(json.dumps(report, indent=2, sort_keys=True, default=str))
        else:
            c = report["counters"]
            print(f"corpus-distill @ generation {report['generation']}: "
                  f"{c['records_in']} records -> {report['captured_rows']} "
                  f"distinct rows (dedup x{report['dedup_ratio']:.1f}, "
                  f"{c['dropped_unparseable']} dropped)")
            print(f"  synthesis: +{report['synthetic_rows']} rows, coverage "
                  f"{report['coverage_before']:.2f} -> "
                  f"{report['coverage_after']:.2f}; reasons: "
                  f"{report['synthesis']['reasons'] or '{}'}")
            if report["out"]:
                print(f"  wrote {report['out']}")
        return 0

    if args.corpus_report:
        if not args.corpus:
            ap.error("--corpus-report requires --corpus (an .atpucorp "
                     "file or directory)")
        report = _run_corpus_report(args.corpus_report, args.corpus)
        if args.as_json:
            print(json.dumps(report, indent=2, sort_keys=True, default=str))
        else:
            cov = report["coverage"]
            print(f"corpus-report @ generation {report['generation']}: "
                  f"{report['rows']} rows ({report['origins']}), coverage "
                  f"{cov['columns_exercised']}/{cov['columns_total']} "
                  f"columns ({cov['fraction']:.2f})")
            for name, cfg in sorted(cov["configs"].items()):
                gaps = cfg["unexercised"]
                print(f"  {name}: {cfg['evaluators'] - len(gaps)}"
                      f"/{cfg['evaluators']} exercised, "
                      f"{cfg['allow_rows']} allow rows"
                      + (f", gaps {gaps}" if gaps else ""))
            for u in report["synthesis"]["uncoverable"]:
                print(f"  uncoverable: {u['config']}/{u['evaluator']} "
                      f"({u['reason']})")
        return 0

    if args.corpus_diff:
        if not args.corpus:
            ap.error("--corpus-diff requires --corpus (an .atpucorp "
                     "file or directory)")
        report = _run_corpus_diff(args.corpus_diff, args.corpus)
        if args.as_json:
            print(json.dumps(report, indent=2, sort_keys=True, default=str))
        else:
            _print_corpus_diff(report)
        return 1 if report["flips"] else 0

    if args.metrics_catalog:
        report = _run_metrics_catalog()
        if args.as_json:
            print(json.dumps(report, indent=2, sort_keys=True))
        else:
            for name in report["missing_in_docs"]:
                print(f"UNDOCUMENTED: {name} registered in utils/metrics.py "
                      f"but absent from docs/observability.md")
            for name in report["stale_in_docs"]:
                print(f"STALE: {name} documented in docs/observability.md "
                      f"but not registered in utils/metrics.py")
            for msg in report["tenant_cardinality"]:
                print(f"CARDINALITY: {msg}")
            print(f"{'OK' if report['ok'] else 'DRIFT'}: "
                  f"{len(report['missing_in_docs'])} undocumented, "
                  f"{len(report['stale_in_docs'])} stale, "
                  f"{len(report['tenant_cardinality'])} cardinality")
        return 0 if report["ok"] else 1

    if args.decisions:
        report = _load_json_source(args.decisions)
        # schema gate: refuse version-skewed logs
        # with a typed error instead of misparsing the records
        from ..runtime.provenance import (
            DecisionSchemaError,
            check_decision_schema,
        )

        try:
            check_decision_schema(report)
        except DecisionSchemaError as e:
            print(f"DecisionSchemaError: {e}", file=sys.stderr)
            return 1
        if args.as_json:
            print(json.dumps(report, indent=2, sort_keys=True))
        else:
            _print_decisions(report)
        return 0

    if args.kernel_cost:
        report = _load_json_source(args.kernel_cost)
        if args.as_json:
            kc = _resolve_kernel_cost(report) or report
            print(json.dumps(kc, indent=2, sort_keys=True, default=str))
        else:
            _print_kernel_cost(report)
        return 0

    if args.flight_dump:
        bundle = _load_json_source(args.flight_dump)
        if args.as_json:
            print(json.dumps(bundle, indent=2, sort_keys=True, default=str))
        else:
            _print_flight_bundle(bundle)
        return 0

    any_mode = args.self_lint or args.verify_fixtures or args.coverage_report
    run_lint = args.self_lint or not any_mode
    run_fixtures = args.verify_fixtures or not any_mode

    findings: List[Finding] = []
    report = {"ok": True, "layers": []}
    if run_lint:
        f = _run_self_lint(list(args.paths))
        findings += f
        report["layers"].append({"layer": "code_lint",
                                 "paths": args.paths or [_PKG_ROOT],
                                 "findings": len(f)})
    if run_fixtures:
        f = _run_verify_fixtures()
        findings += f
        report["layers"].append({"layer": "fixture_verify",
                                 "findings": len(f)})
    coverage = None
    if args.coverage_report:
        coverage = _run_coverage_report()
        report["layers"].append({"layer": "coverage_report",
                                 "fast": coverage["fast"],
                                 "slow": coverage["slow"]})
        report["coverage"] = coverage

    report["ok"] = not findings
    report["findings"] = findings_to_json(findings)
    if args.as_json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        for f in findings:
            print(str(f))
        if coverage is not None:
            print(f"lowerability: {coverage['fast']} fast-lane / "
                  f"{coverage['slow']} slow-lane config(s)")
            for name, info in coverage["configs"].items():
                reasons = (" [" + ", ".join(info["reasons"]) + "]"
                           if info["reasons"] else "")
                print(f"  {info['lane']:<5} {name}{reasons}")
            blocking = coverage.get("blocking_reasons") or {}
            if blocking:
                print("blocking reasons (would-be-fast-if-fixed):")
                for reason, b in blocking.items():
                    print(f"  {reason:<24} {b['configs']} config(s), "
                          f"{b['sole_blocker']} sole-blocked")
        print(f"{'OK' if report['ok'] else 'FAIL'}: "
              f"{len(findings)} finding(s)")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
