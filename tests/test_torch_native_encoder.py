"""The port's native (C++) batch encoder against the JAX package's encoders.

Every case of ``tests/test_native_encoder.py`` (scalars, numbers and bools,
unicode and escapes, membership overflow, nested raw JSON, the DFA lane and
byte overflow, the CPU regex lane, tree-CPU, modifiers, array index,
int-divergent segments, escaped dot keys, the randomized multi-config
differential, the empty batch, verdict parity) goes through the port's
native encoder in both modes (the dict walk and the JSON blob), and every
``EncodedBatch`` field is held byte-equal (dtype included) to the
reference's ``encode_batch_py`` AND to the reference's native encoder, on
the same corpus built with each package's expression classes and the same
documents.  The corpora of the port's phases (north-star, Keycloak claims,
the API-key control plane, OPA) run the same way on documents captured
from the port's own ``Check()`` path, and the port picks the native or the
Python encoder for each exactly as the reference's ``get_native_encoder``
does.  Tolerance 0 throughout: every output is an integer or boolean
array."""

import asyncio
import json
import os
import random
import re
import tempfile
import threading
from pathlib import Path

import numpy as np
import pytest

from authorino_tpu.compiler.encode import encode_batch_py as r_encode_py
from authorino_tpu.compiler.pack import pack_batch as r_pack
from authorino_tpu.models.policy_model import PolicyModel as RefModel
from authorino_tpu.native import get_native_encoder as r_native
from authorino_tpu_torch import native
from authorino_tpu_torch.compiler import compile as p_compile
from authorino_tpu_torch.compiler.encode import encode_batch as p_encode
from authorino_tpu_torch.compiler.encode import encode_batch_py as p_encode_py
from authorino_tpu_torch.models import PolicyModel
from authorino_tpu_torch.models import control_plane as cp
from authorino_tpu_torch.models import northstar, oidc_corpus, opa_corpus
from authorino_tpu_torch.native import BuildError, get_native_encoder
from authorino_tpu_torch.native.encoder import TOTALS, out_of_domain, reset_totals
from authorino_tpu_torch.runtime import EngineEntry, PolicyEngine

from test_torch_compiler import PORT, REF, convert_config
from torch_ref_native import ref_native_library

ROOT = Path(__file__).resolve().parent.parent
FIELDS = ("attrs_val", "attrs_members", "overflow", "cpu_lane", "config_id",
          "attr_bytes", "byte_ovf")
MODES = ("object", "json")


@pytest.fixture(scope="module", autouse=True)
def _ref_native():
    """The reference's native library, loaded past a lost build race
    (``tests/torch_ref_native.py``) before any test here reaches it."""
    return ref_native_library()


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def same_batch(want, got, what=""):
    for f in FIELDS:
        w, g = getattr(want, f), getattr(got, f)
        assert w.dtype == g.dtype, (what, f, w.dtype, g.dtype)
        assert w.shape == g.shape, (what, f, w.shape, g.shape)
        assert w.tobytes() == g.tobytes(), (what, f)


def native_in_mode(enc, mode, docs, rows, batch_pad):
    saved = enc.mode
    enc.mode = mode
    try:
        return enc.encode_batch(docs, rows, batch_pad=batch_pad)
    finally:
        enc.mode = saved


def assert_same(ref_policy, port_policy, docs, rows, mode, batch_pad=0):
    """The port's native encoder in ``mode`` against the reference's
    Python and native encoders (both modes of the latter)."""
    want = r_encode_py(ref_policy, docs, rows, batch_pad=batch_pad)
    r_nat = r_native(ref_policy)
    assert r_nat is not None, "the reference's native encoder is unavailable"
    for r_mode in MODES:
        r_got = native_in_mode(r_nat, r_mode, docs, rows, batch_pad)
        assert r_got is not None
        same_batch(want, r_got, f"reference native {r_mode}")
    enc = get_native_encoder(port_policy)
    assert enc is not None
    n0 = enc.batches
    got = native_in_mode(enc, mode, docs, rows, batch_pad)
    assert got is not None, "the port's native encoder bailed"
    assert enc.batches == n0 + 1
    same_batch(want, got, f"port native {mode}")
    same_batch(want, p_encode_py(port_policy, docs, rows,
                                 batch_pad=batch_pad), "port python")


def both(make, members_k=16):
    """(reference policy, port policy) of the corpus ``make(ns)`` builds."""
    return (REF.compile_corpus(make(REF), members_k=members_k),
            PORT.compile_corpus(make(PORT), members_k=members_k))


def one_config(ns, *patterns, name="cfg-0", cond=None):
    rule = ns.All(*patterns) if len(patterns) > 1 else patterns[0]
    return ns.ConfigRules(name=name, evaluators=[(cond, rule)])


def pat(ns, sel, op, value):
    return ns.Pattern(sel, getattr(ns.Operator, op), value)


# ---- the cases of tests/test_native_encoder.py -----------------------------

def case_string_values(ns):
    return [one_config(ns, pat(ns, "a.b", "EQ", "x"))]


DOCS_STRING = [{"a": {"b": "x"}}, {"a": {"b": "y"}}, {"a": {}}, {},
               {"a": {"b": ""}}]


def case_numbers_and_bools(ns):
    return [one_config(ns, pat(ns, "v.i", "EQ", "42"),
                       pat(ns, "v.f", "EQ", "1.5"),
                       pat(ns, "v.b", "EQ", "true"),
                       pat(ns, "v.n", "NEQ", ""))]


DOCS_NUMBERS = [
    {"v": {"i": 42, "f": 1.5, "b": True, "n": None}},
    {"v": {"i": 42.0, "f": 3, "b": False, "n": 0}},
    {"v": {"i": -0.0, "f": 0.1, "b": True, "n": 10**30}},
    {"v": {"i": 1e16, "f": 1.5e-7, "b": True, "n": -12345678901234567890}},
    {"v": {"i": 0.30000000000000004, "f": 123456789.123456789, "b": True,
           "n": 2**63}},
    {"v": {"i": 1e15 + 0.5, "f": -1.2345e22, "b": False, "n": 5e-324}},
]


def case_unicode(ns):
    return [one_config(ns, pat(ns, "s", "EQ", "héllo\nworld"))]


DOCS_UNICODE = [{"s": "héllo\nworld"}, {"s": "naïve £ → 🎉"},
                {"s": 'quote " backslash \\ tab\t'}, {"s": "nul\x00byte"},
                {"s": "\x01\x02control"}]


def case_membership(ns):
    return [one_config(ns, pat(ns, "roles", "INCL", "admin"),
                       pat(ns, "groups", "EXCL", "banned"))]


DOCS_MEMBERSHIP = [
    {"roles": ["admin"], "groups": []},
    {"roles": ["a", "b", "c", "d", "e", "admin"],
     "groups": list("abcdefg") + ["banned"]},
    {"roles": "admin", "groups": None},
    {"roles": [1, 2.5, True, None], "groups": [["nested"], {"k": "v"}]},
    {"roles": [f"r{i}" for i in range(20)],
     "groups": [f"g{i}" for i in range(20)]},
]


def case_nested_raw_json(ns):
    return [one_config(ns, pat(ns, "obj", "EQ", '{"a":1,"b":[true,null]}'))]


DOCS_NESTED = [{"obj": {"a": 1, "b": [True, None]}},
               {"obj": {"a": 1.0, "b": [True, None]}},
               {"obj": [{"x": "é"}, 2.5, -0.0]},
               {"obj": {"k": 'str with " and \\'}}]


def case_dfa_lane(ns):
    return [one_config(ns, pat(ns, "path", "MATCHES", r"^/api/v\d+/"))]


DOCS_DFA = [{"path": "/api/v1/x"}, {"path": "/other"},
            {"path": "/api/v" + "9" * 300 + "/long-overflow"},
            {"path": "nul\x00inside"}, {"path": 123}]


def case_cpu_regex(ns):
    # backreference → not DFA-compilable → OP_CPU
    return [one_config(ns, pat(ns, "s", "MATCHES", r"(ab)\1"))]


DOCS_CPU_REGEX = [{"s": "abab"}, {"s": "ab"}, {"s": ""}, {}]


def case_tree_cpu(ns):
    # invalid regex → whole-tree CPU oracle leaf
    return [one_config(ns, pat(ns, "a", "EQ", "1"),
                       ns.Any_(pat(ns, "s", "MATCHES", "([bad"),
                               pat(ns, "b", "EQ", "2")))]


DOCS_TREE = [{"a": "1", "s": "x", "b": "2"}, {"a": "1", "b": "3"}]


def case_modifiers(ns):
    return [one_config(ns, pat(ns, "user.name|@case:upper", "EQ", "ALICE"),
                       pat(ns, "plain.key", "EQ", "v"))]


DOCS_MODIFIERS = [{"user": {"name": "alice"}, "plain": {"key": "v"}},
                  {"user": {"name": "Bob"}, "plain": {"key": "w"}}]


def case_array_index(ns):
    return [one_config(ns, pat(ns, "items.1.id", "EQ", "second"))]


DOCS_ARRAY_INDEX = [{"items": [{"id": "first"}, {"id": "second"}]},
                    {"items": [{"id": "only"}]}, {"items": "not-a-list"}]


def case_int_divergent(ns):
    # segments Python int() accepts but the C digit parser rejects
    # (underscores, non-ASCII decimal digits) are finished in Python
    return [one_config(ns, pat(ns, "items.1_0.id", "EQ", "eleventh")),
            ns.ConfigRules(name="cfg-1", evaluators=[
                (None, pat(ns, "items.١.id", "EQ", "second"))])]


DOCS_INT_DIVERGENT = [{"items": [{"id": f"item-{i}"} for i in range(12)]},
                      {"items": [{"id": "first"}, {"id": "second"}]},
                      {"items": []}]


def case_escaped_dot(ns):
    return [one_config(ns, pat(ns, r"headers.x\.request\.id", "EQ", "r1"))]


DOCS_ESCAPED_DOT = [{"headers": {"x.request.id": "r1"}},
                    {"headers": {"x": {"request": {"id": "r1"}}}}]


CASES = {
    "string_values": (case_string_values, DOCS_STRING, 16, None),
    "numbers_and_bools": (case_numbers_and_bools, DOCS_NUMBERS, 16, None),
    "unicode_and_escapes": (case_unicode, DOCS_UNICODE, 16, None),
    "arrays_and_overflow": (case_membership, DOCS_MEMBERSHIP, 4, None),
    "nested_raw_json": (case_nested_raw_json, DOCS_NESTED, 16, None),
    "dfa_lane_and_byte_overflow": (case_dfa_lane, DOCS_DFA, 16, None),
    "cpu_regex_lane": (case_cpu_regex, DOCS_CPU_REGEX, 16, None),
    "tree_cpu_fallback": (case_tree_cpu, DOCS_TREE, 16, None),
    "modifiers_finished_in_python": (case_modifiers, DOCS_MODIFIERS, 16,
                                     None),
    "array_index_path": (case_array_index, DOCS_ARRAY_INDEX, 16, None),
    "int_divergent_segments": (case_int_divergent, DOCS_INT_DIVERGENT, 16,
                               [0, 1, 0]),
    "escaped_dot_key": (case_escaped_dot, DOCS_ESCAPED_DOT, 16, None),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("batch_pad", [0, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_case_equals_reference(case, batch_pad, mode):
    make, docs, k, rows = CASES[case]
    rp, pp = both(make, members_k=k)
    rows = rows if rows is not None else [0] * len(docs)
    assert_same(rp, pp, docs, rows, mode, batch_pad=batch_pad)


# ---- the randomized multi-config differential ------------------------------

def random_corpus(ns, rng, n_configs=8):
    configs = []
    for i in range(n_configs):
        pats = [pat(ns, "request.method", "EQ", rng.choice(["GET", "POST"]))]
        for j in range(rng.randrange(1, 5)):
            kind = rng.random()
            if kind < 0.2:
                pats.append(pat(ns, "request.url_path", "MATCHES",
                                rf"^/svc-{i}/r{j}"))
            elif kind < 0.5:
                pats.append(pat(ns, "auth.identity.roles", "INCL",
                                f"role-{i}-{j}"))
            elif kind < 0.7:
                pats.append(pat(ns, "auth.identity.groups", "EXCL",
                                f"ban-{i}"))
            else:
                pats.append(pat(ns, f"request.headers.h{j}", "NEQ", f"v{i}"))
        cond = (pat(ns, "env", "NEQ", "dev") if rng.random() < 0.3 else None)
        configs.append(one_config(ns, *pats, name=f"cfg-{i}", cond=cond))
    return configs


def random_doc(rng):
    return {
        "request": {
            "method": rng.choice(["GET", "POST", "PUT"]),
            "url_path": rng.choice(["/svc-1/r0", "/svc-0/r1", "/x",
                                    "/" + "y" * rng.choice([3, 200])]),
            "headers": {f"h{j}": rng.choice(["v0", "v3", "", 7, None])
                        for j in range(rng.randrange(4))},
        },
        "auth": {"identity": {
            "roles": [f"role-{rng.randrange(8)}-{rng.randrange(5)}"
                      for _ in range(rng.randrange(12))],
            "groups": rng.choice([[], ["ban-1"], [f"g{k}" for k in range(15)],
                                  "scalar", None]),
        }},
        "env": rng.choice(["dev", "prod", 1, None]),
    }


def random_trial(seed):
    """(reference policy, port policy, docs, rows, batch_pad): one corpus
    drawn twice from the same seed, once per package."""
    policies = []
    for ns in (REF, PORT):
        rng = random.Random(seed)
        policies.append(ns.compile_corpus(random_corpus(ns, rng),
                                          members_k=4))
    n = rng.randrange(1, 40)
    docs = [random_doc(rng) for _ in range(n)]
    rows = [rng.randrange(8) for _ in range(n)]
    return (*policies, docs, rows, rng.choice([0, 64]))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("trial", range(5))
def test_randomized_differential(trial, mode):
    rp, pp, docs, rows, pad = random_trial(1234 + trial)
    assert_same(rp, pp, docs, rows, mode, batch_pad=pad)


@pytest.mark.parametrize("mode", MODES)
def test_empty_batch(mode):
    rp, pp = both(lambda ns: [one_config(ns, pat(ns, "a", "EQ", "1"))])
    assert_same(rp, pp, [], [], mode, batch_pad=8)


@pytest.mark.parametrize("mode", MODES)
def test_verdict_parity(mode):
    """Native-encoded batches give the same kernel verdicts (the plain
    version on the CPU) as Python-encoded ones, and as the reference's."""
    rp, pp, docs, rows, _ = random_trial(7)
    rows = [r % 8 for r in rows]
    model = PolicyModel(pp, device="cpu")
    enc = get_native_encoder(pp)
    nat = native_in_mode(enc, mode, docs, rows, 0)
    from authorino_tpu_torch.compiler.pack import pack_batch as p_pack

    own_nat = model.apply(p_pack(pp, nat))
    own_py = model.apply(p_pack(pp, p_encode_py(pp, docs, rows)))
    for a, b in zip(own_nat, own_py):
        assert np.array_equal(a, b)
    ref_db = r_pack(rp, r_native(rp).encode_batch(docs, rows))
    for f in ("attrs_val", "members_c", "cpu_dense", "config_id"):
        assert np.array_equal(getattr(ref_db, f),
                              getattr(p_pack(pp, nat), f)), f


# ---- the corpora of the port's phases --------------------------------------

async def capture(engine, requests):
    """The (authorization JSON, config name) of every batch row the
    ``Check()``s of ``requests`` submit through ``engine``."""
    seen = []
    inner = engine.submit

    async def submit(doc, name, **kw):
        seen.append((doc, name))
        return await inner(doc, name, **kw)

    engine.submit = submit
    await asyncio.gather(*(engine.check(r) for r in requests))
    return seen


def recording_engine():
    """A CPU engine that keeps the entries of its last installed
    snapshot in ``installed``."""
    engine = PolicyEngine(max_batch=64, device="cpu")
    inner = engine.apply_snapshot

    def apply_snapshot(entries, *args, **kw):
        engine.installed = list(entries)
        return inner(entries, *args, **kw)

    engine.apply_snapshot = apply_snapshot
    return engine


async def entries_of(engine, specs, cluster=None):
    from authorino_tpu_torch.controllers import translate_auth_config

    return [await translate_auth_config(
        o["metadata"]["name"], o["metadata"]["namespace"], o["spec"],
        cluster=cluster, engine=engine) for o in specs]


def northstar_rows():
    async def body():
        engine = recording_engine()
        engine.apply_snapshot(await entries_of(
            engine, northstar.build_auth_configs(12, 10)))
        return engine, await capture(
            engine, northstar.build_check_requests(64, 12))
    return run(body())


def opa_rows():
    async def body():
        engine = recording_engine()
        engine.apply_snapshot(await entries_of(
            engine, opa_corpus.build_auth_configs(12)))
        return engine, await capture(
            engine, opa_corpus.build_check_requests(64, 12))
    return run(body())


def keycloak_rows():
    keys = oidc_corpus.make_keys(3, rsa_bits=1024)
    with oidc_corpus.FakeKeycloak(keys) as idp:
        async def body():
            engine = recording_engine()
            engine.apply_snapshot(await entries_of(
                engine, oidc_corpus.build_auth_configs(8, 10, idp.issuer)))
            reqs, _, _ = oidc_corpus.build_check_requests(idp, 48, 8,
                                                          n_tokens=16)
            return engine, await capture(engine, reqs)
        return run(body())


def api_key_rows():
    from authorino_tpu_torch.controllers import (AuthConfigReconciler,
                                                 SecretReconciler)
    from authorino_tpu_torch.controllers.sources import YamlDirSource
    from authorino_tpu_torch.k8s import InMemoryCluster

    with tempfile.TemporaryDirectory() as d:
        docs = cp.build_auth_configs(8, 10) + [cp.api_key_secret(i)
                                               for i in range(8)]
        for k, doc in enumerate(docs):
            with open(os.path.join(d, f"{k}.json"), "w") as f:
                json.dump(doc, f)

        async def body():
            engine = recording_engine()
            cluster = InMemoryCluster()
            rec = AuthConfigReconciler(engine, cluster=cluster)
            await YamlDirSource(d, rec, cluster,
                                SecretReconciler(engine)).sync()
            reqs, _, _ = cp.build_check_requests(48, 8)
            return engine, await capture(engine, reqs)
        return run(body())


# corpus → (its rows, the encoder the reference picks for it)
CORPORA = {"northstar": (northstar_rows, "native"),
           "keycloak": (keycloak_rows, "native"),
           "api_key": (api_key_rows, "native"),
           "opa": (opa_rows, "python")}


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_corpus_domain_and_encodes_equal_reference(corpus):
    """The corpus's compiled rules, compiled again by each package: the
    port's domain decision is the reference's, and on the documents the
    port's own ``Check()`` path submitted, every encoder in the domain
    gives the reference's bytes in both modes."""
    rows_of, expect = CORPORA[corpus]
    engine, seen = rows_of()
    assert len(seen) >= 32
    rules = [e.rules for e in engine.installed if e.rules is not None]
    assert len(rules) >= 8
    pp = PORT.compile_corpus(rules, members_k=16)
    rp = REF.compile_corpus([convert_config(c, REF) for c in rules],
                            members_k=16)
    assert (r_native(rp) is not None) == (expect == "native")
    assert (get_native_encoder(pp) is not None) == (expect == "native")
    assert (out_of_domain(pp) is None) == (expect == "native")
    docs = [d for d, _ in seen]
    rows = [pp.config_ids[n] for _, n in seen]
    want = r_encode_py(rp, docs, rows, batch_pad=64)
    same_batch(want, p_encode(pp, docs, rows, batch_pad=64), "encode_batch")
    if expect == "native":
        for mode in MODES:
            assert_same(rp, pp, docs, rows, mode, batch_pad=64)
    # the engine that served the Check()s encoded with the same choice
    snap_enc = engine._snapshot.encoder
    assert (snap_enc is not None) == (expect == "native")
    if snap_enc is not None:
        assert snap_enc.batches >= 1 and snap_enc.bailed == 0


# ---- the build, the domain rule, the switches -----------------------------

def test_op_codes_equal_the_ports_compiler():
    src = (native.CSRC_DIR / "encoder.cpp").read_text()
    body = re.search(r"enum \{(.*?)\};", src, re.S).group(1)
    codes = {k: int(v) for k, v in re.findall(r"(OP_\w+) = (\d+)", body)}
    assert len(codes) == 8
    for name, value in codes.items():
        assert getattr(p_compile, name) == value, name


def fresh_policy(n=4):
    return PORT.compile_corpus(northstar.build_corpus(n, 4), members_k=16)


def broken_build(monkeypatch, tmp_path):
    """The next load builds into ``tmp_path`` with a compiler that does
    not exist."""
    monkeypatch.setattr(native, "_MOD", None)
    monkeypatch.setattr(native, "CXX", "no-such-compiler-for-this-test")
    monkeypatch.setattr(native, "library_path",
                        lambda: tmp_path / "_atpuenc_torch-broken.so")


def test_failed_build_raises_and_fails_the_install(monkeypatch, tmp_path):
    """A failed build raises at the encoder, at ``encode_batch`` and at the
    engine's snapshot install (the generation stays), and never yields the
    Python encoder for an in-domain corpus."""
    broken_build(monkeypatch, tmp_path)
    policy = fresh_policy()
    assert out_of_domain(policy) is None
    with pytest.raises(BuildError, match="no-such-compiler"):
        get_native_encoder(policy)
    with pytest.raises(BuildError):
        p_encode(policy, northstar.build_docs(4), [0, 1, 2, 3])
    engine = PolicyEngine(device="cpu")
    with pytest.raises(BuildError):
        engine.apply_snapshot([EngineEntry(id=c.name, hosts=[c.name],
                                           rules=c)
                               for c in northstar.build_corpus(3, 4)])
    assert engine.generation == 0 and engine._snapshot is None
    assert [p.name for p in tmp_path.iterdir()] == [
        "_atpuenc_torch-broken.so.lock"]


def test_compiler_error_raises_with_its_output(monkeypatch, tmp_path):
    """A compiler that runs and refuses (here: no ``Python.h`` on the
    include path) raises with its output and leaves no library."""
    monkeypatch.setattr(native, "_MOD", None)
    monkeypatch.setattr(native, "library_path",
                        lambda: tmp_path / "_atpuenc_torch-bad.so")
    monkeypatch.setattr(native, "_include_dir", lambda: str(tmp_path))
    with pytest.raises(BuildError, match="(?s)failed on pymod.cpp.*Python.h"):
        native.load_library()
    # no library and no torn temporary left behind, only the lock file
    assert [p.name for p in tmp_path.iterdir()] == [
        "_atpuenc_torch-bad.so.lock"]


def test_processes_needing_the_library_at_once_compile_it_once(tmp_path):
    """Three processes load a library that does not exist yet, at once:
    one compiles it, the others wait on its lock and load the result."""
    import subprocess
    import sys

    code = ("import sys\n"
            "from pathlib import Path\n"
            "from authorino_tpu_torch import native\n"
            "native.library_path = lambda: Path(sys.argv[1])\n"
            "mod = native.load_library()\n"
            "print('BUILT' if native.build_seconds() is not None "
            "else 'LOADED', hasattr(mod, 'encode_docs'))\n")
    lib = tmp_path / "_atpuenc_torch-shared.so"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(lib)],
                              cwd=str(ROOT), env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    said = sorted(out.strip() for out, _ in outs)
    assert said == ["BUILT True", "LOADED True", "LOADED True"], outs
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        lib.name, lib.name + ".lock"]


def test_native_off_switch_takes_the_python_encoder(monkeypatch):
    """``AUTHORINO_TPU_NATIVE=0`` (and only it, for an in-domain corpus)
    gives the Python encoder.  The port reads the switch for each new
    compiled corpus; the reference reads it once, at its library's first
    load, so its side is not asked here."""
    monkeypatch.setenv("AUTHORINO_TPU_NATIVE", "0")
    policy = fresh_policy()
    assert get_native_encoder(policy) is None
    r_policy = REF.compile_corpus([convert_config(c, REF) for c in
                                   northstar.build_corpus(4, 4)],
                                  members_k=16)
    docs = northstar.build_docs(8)
    rows = [i % 4 for i in range(8)]
    same_batch(r_encode_py(r_policy, docs, rows),
               p_encode(policy, docs, rows), "python")


@pytest.mark.parametrize("mode,threads", [("object", None), ("json", "3"),
                                          ("json", None)])
def test_switches_read_as_the_reference_reads_them(monkeypatch, mode,
                                                   threads):
    monkeypatch.setenv("AUTHORINO_TPU_ENCODE_MODE", mode)
    if threads is None:
        monkeypatch.delenv("AUTHORINO_TPU_ENCODE_THREADS", raising=False)
    else:
        monkeypatch.setenv("AUTHORINO_TPU_ENCODE_THREADS", threads)
    rp, pp = both(case_membership)
    got, want = get_native_encoder(pp), r_native(rp)
    assert (got.mode, got.n_threads) == (want.mode, want.n_threads)
    docs = DOCS_MEMBERSHIP * 3
    same_batch(want.encode_batch(docs, [0] * 15),
               got.encode_batch(docs, [0] * 15), mode)


@pytest.mark.parametrize("wide", [False, True])
def test_wire_width_reaches_the_encoder(wide):
    """An interner past int16 makes both packages write int32 ids."""
    def make(ns):
        cfg = one_config(ns, pat(ns, "k", "EQ", "v"),
                         pat(ns, "r", "INCL", "admin"))
        if not wide:
            return [cfg]
        return [cfg] + [one_config(ns, pat(ns, "k", "EQ", f"v{i}"),
                                   name=f"w-{i}") for i in range(33000)]
    rp, pp = both(make)
    docs = [{"k": "v", "r": ["admin", "x"]}, {"k": "v7"}, {"r": "admin"}]
    for mode in MODES:
        assert_same(rp, pp, docs, [0, 0, 0], mode)
    got = get_native_encoder(pp).encode_batch(docs, [0, 0, 0])
    assert got.attrs_val.dtype == (np.int32 if wide else np.int16)


@pytest.mark.parametrize("in_domain", [True, False])
def test_policy_model_encode_json_equals_reference(in_domain):
    """``PolicyModel.encode_json`` (JSON bytes in, packed batch out) gives
    the reference's packed batch; a corpus outside the native domain (a
    numeric lane) takes the Python encoder in both packages."""
    def make(ns):
        pats = [pat(ns, "request.method", "EQ", "GET"),
                pat(ns, "auth.identity.roles", "INCL", "admin")]
        if not in_domain:
            pats.append(pat(ns, "request.size", "GT", "100"))
        return [one_config(ns, *pats)]
    rp, pp = both(make)
    assert (out_of_domain(pp) is None) == in_domain
    docs = [{"request": {"method": "GET", "size": 200},
             "auth": {"identity": {"roles": ["admin"]}}},
            {"request": {"method": "POST", "size": 5}},
            {"request": {"method": "GET"}, "auth": {"identity": {
                "roles": [f"r{i}" for i in range(20)]}}}]
    parts = [json.dumps(d).encode() for d in docs]
    want = RefModel(rp).encode_json(parts, [0, 0, 0], batch_pad=4)
    got = PolicyModel(pp, device="cpu").encode_json(parts, [0, 0, 0],
                                                   batch_pad=4)
    for f in ("attrs_val", "members_c", "cpu_dense", "config_id",
              "attr_bytes", "byte_ovf", "host_fallback", "attrs_num",
              "num_valid"):
        w, g = getattr(want, f), getattr(got, f)
        if w is None:
            assert g is None, f
            continue
        assert np.asarray(w).tobytes() == np.asarray(g).tobytes(), f


def test_unrenderable_document_is_handed_back_and_counted():
    """A value ``json.dumps`` cannot render makes the native path hand the
    batch back (``bailed``); the Python encoder then raises the real
    error, as the reference's does."""
    rp, pp = both(case_nested_raw_json)
    docs = [{"obj": {"a": 1}}, {"obj": {"bad": {1, 2}}}]
    reset_totals()
    for mode in MODES:
        enc = get_native_encoder(pp)
        b0 = enc.bailed
        assert native_in_mode(enc, mode, docs, [0, 0], 0) is None
        assert enc.bailed == b0 + 1
    assert TOTALS == {"object": 0, "json": 0, "bailed": 2}
    native_in_mode(enc, "json", docs[:1], [0], 0)
    assert TOTALS == {"object": 0, "json": 1, "bailed": 2}
    with pytest.raises(TypeError) as want:
        r_encode_py(rp, docs, [0, 0])
    with pytest.raises(TypeError) as got:
        p_encode(pp, docs, [0, 0])
    assert str(got.value) == str(want.value)


def test_threads_share_one_encoder():
    """Eight threads, more than the encode pool's four, encode through one
    encoder at once, in both modes, with a short switch interval: every
    batch equals the Python encoder's and no count is lost."""
    import sys

    rp, pp, docs, rows, _ = random_trial(99)
    rows = [r % 8 for r in rows]
    want = p_encode_py(pp, docs, rows, batch_pad=64)
    enc = get_native_encoder(pp)
    n0 = enc.batches
    t0 = TOTALS["object"] + TOTALS["json"]
    errors, per_thread = [], 40

    def work(t):
        try:
            for k in range(per_thread):
                if (t + k) % 2:
                    got = enc.encode_json_parts(
                        [json.dumps(d).encode() for d in docs], rows, 64)
                else:
                    got = enc._count(enc._encode(docs, None, rows, 64),
                                     "object")
                same_batch(want, got, f"thread {t}")
        except Exception as e:  # surfaced below with the thread's number
            errors.append((t, e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    assert enc.batches == n0 + 8 * per_thread
    assert TOTALS["object"] + TOTALS["json"] == t0 + 8 * per_thread
