"""Boundaries of the PyTorch port: it imports neither JAX nor the JAX
package; its entry points refuse to guess a device; its kernel build
refuses to proceed without nvcc; its kernel wrappers never hand a CUDA
tensor's work to the plain version (and never take a CPU tensor to the
kernel); its native encoder builds from its own sources into its own
build directory."""

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import authorino_tpu_torch
from authorino_tpu_torch.models import PolicyModel, northstar
from authorino_tpu_torch.ops import _build
from authorino_tpu_torch.ops import fused_kernel as p_fk
from authorino_tpu_torch.ops import operands as p_ops
from authorino_tpu_torch.runtime import PolicyEngine

ROOT = Path(__file__).resolve().parent.parent


def port_modules():
    """Every module of the port but ``__main__`` (importing it runs the
    CLI; tests/test_torch_cli.py runs it)."""
    return sorted(m.name for m in pkgutil.walk_packages(
        authorino_tpu_torch.__path__, "authorino_tpu_torch.")
        if m.name != "authorino_tpu_torch.__main__")


def test_port_imports_neither_jax_nor_the_jax_package():
    mods = port_modules()
    assert "authorino_tpu_torch.ops.fused_kernel" in mods
    assert "authorino_tpu_torch.runtime.engine" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'authorino_tpu' or "
        "m.startswith('authorino_tpu.'))\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BAD []" in proc.stdout


# the JOSE layer, the HTTP client and every module standing on them
JWT_AND_HTTP_MODULES = (
    "utils.pki", "utils.jose", "utils.http", "utils.workers",
    "utils.oauth2cc", "evaluators.identity.oidc", "evaluators.identity.oauth2",
    "evaluators.metadata.generic_http", "evaluators.metadata.user_info",
    "evaluators.metadata.uma", "evaluators.response.wristband",
    "models.oidc_corpus")


# the control plane and the X.509 identity
CONTROL_PLANE_MODULES = (
    "apis.convert", "k8s.client", "k8s.leader", "evaluators.deny_all",
    "utils.x509", "evaluators.identity.mtls", "controllers.reconciler",
    "controllers.sources", "controllers.status_updater",
    "models.control_plane")


# the failure handling: the fault plane, the breaker, the fs-fault hook
FAILURE_MODULES = ("runtime.faults", "runtime.breaker", "utils.atomicio")


# the serving modules: the only ones that import ``grpc`` and ``aiohttp``
# (``Authzed.call`` imports ``grpc`` at its first call)
SERVING_MODULES = ("service", "service.grpc_server", "service.http_server",
                   "service.oidc_server", "service.webhooks", "cli")


def below_serving(mods):
    return [m for m in mods if m.split(".", 1)[1] not in SERVING_MODULES]


# the kernel lanes with their router, and the offline analysis CLI with
# the code lint and the metrics-catalog gate
LANE_AND_ANALYSIS_MODULES = ("ops.pattern_eval", "analysis.code_lint",
                             "analysis.metrics_catalog", "analysis.__main__")


def test_lanes_and_analysis_cli_import_with_service_libraries_blocked():
    """The kernel lanes and the analysis CLI import neither JAX nor the JAX
    package, with ``grpc``, ``aiohttp`` and ``cryptography`` blocked; the
    CLI no longer lists the kernel lanes as unported."""
    from authorino_tpu_torch import cli as port_cli

    mods = port_modules()
    for m in LANE_AND_ANALYSIS_MODULES:
        assert f"authorino_tpu_torch.{m}" in mods, m
    assert "kernel lanes" not in port_cli.UNPORTED_PLANES
    code = (
        "import importlib, sys\n"
        "BLOCKED = ('aiohttp', 'grpc', 'cryptography', 'jax', "
        "'authorino_tpu')\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "        return None\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {LANE_AND_ANALYSIS_MODULES!r}:\n"
        "    importlib.import_module('authorino_tpu_torch.' + m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)\n"
        "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BAD []" in proc.stdout


# the host lanes: the cost model, the selector, the first-wins token and
# the port's rule for a card
HOST_LANE_MODULES = ("runtime.lane_select",)


def test_host_lanes_import_with_service_libraries_blocked():
    """The host lanes import neither JAX nor the JAX package, nor a serving
    module or the engine, with ``grpc``, ``aiohttp`` and ``cryptography``
    blocked; the CLI lists no unported plane."""
    from authorino_tpu_torch import cli as port_cli

    mods = port_modules()
    for m in HOST_LANE_MODULES:
        assert f"authorino_tpu_torch.{m}" in mods, m
    assert port_cli.UNPORTED_PLANES == {}
    code = (
        "import importlib, sys\n"
        "BLOCKED = ('aiohttp', 'grpc', 'cryptography', 'jax', "
        "'authorino_tpu')\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "        return None\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {HOST_LANE_MODULES!r}:\n"
        "    importlib.import_module('authorino_tpu_torch.' + m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED\n"
        "             or m.startswith('authorino_tpu_torch.service')\n"
        "             or m in ('authorino_tpu_torch.cli',\n"
        "                      'authorino_tpu_torch.runtime.engine'))\n"
        "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BAD []" in proc.stdout


def test_port_imports_with_service_libraries_blocked():
    """Every module of the port below the serving modules (OPA, the
    Kubernetes reviews, SpiceDB, the protobuf codec and the native gRPC
    frontend's Python half among them) imports
    with ``aiohttp``, ``grpc`` and ``cryptography`` blocked, and with
    ``jax`` blocked too."""
    mods = port_modules()
    for m in ("evaluators.authorization.opa", "evaluators.identity.kubernetes",
              "evaluators.authorization.authzed", "protos.wire",
              "protos.ext_authz", "runtime.native_frontend",
              *JWT_AND_HTTP_MODULES, *CONTROL_PLANE_MODULES, *SERVING_MODULES,
              *FAILURE_MODULES):
        assert f"authorino_tpu_torch.{m}" in mods, m
    mods = below_serving(mods)
    assert "authorino_tpu_torch.protos.wire" in mods
    code = (
        "import importlib, sys\n"
        "BLOCKED = ('aiohttp', 'grpc', 'cryptography', 'jax', "
        "'authorino_tpu')\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "        return None\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print('IMPORTED', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "IMPORTED" in proc.stdout


@pytest.mark.parametrize("mod", FAILURE_MODULES)
def test_failure_modules_import_alone_without_services_or_the_reference(mod):
    """The fault plane, the breaker and the atomic writer each import on
    their own with ``grpc``, ``aiohttp``, ``jax`` and the JAX package
    blocked, and arm, trip and write there: none of them reaches for the
    reference's modules, not even the reference's fault plane."""
    code = (
        "import importlib, os, sys, tempfile\n"
        "BLOCKED = ('aiohttp', 'grpc', 'jax', 'authorino_tpu')\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "        return None\n"
        "sys.meta_path.insert(0, Block())\n"
        f"importlib.import_module('authorino_tpu_torch.{mod}')\n"
        "from authorino_tpu_torch.runtime.faults import FAULTS\n"
        "from authorino_tpu_torch.runtime.breaker import CircuitBreaker\n"
        "from authorino_tpu_torch.utils.atomicio import atomic_write_bytes\n"
        "FAULTS.arm('fs:eio')\n"
        "p = os.path.join(tempfile.mkdtemp(), 'x')\n"
        "try:\n"
        "    atomic_write_bytes(p, b'new')\n"
        "except OSError as e:\n"
        "    print('FS', e.errno, os.path.exists(p))\n"
        "FAULTS.disarm()\n"
        "br = CircuitBreaker('alone', threshold=1)\n"
        "br.record_failure()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)\n"
        "print('STATE', br.state, 'BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "FS 5 False" in proc.stdout, proc.stdout
    assert "STATE open BAD []" in proc.stdout, proc.stdout


SNAPSHOT_MODULES = ("snapshots.compile_cache", "snapshots.diff",
                    "snapshots.delta", "snapshots.serialize")


@pytest.mark.parametrize("mod", SNAPSHOT_MODULES)
def test_snapshot_modules_import_alone_without_services_or_the_reference(mod):
    """The compile cache, the diff, the delta upload and the container
    each import on their own with ``grpc``, ``aiohttp``, ``jax`` and the
    JAX package blocked, and there compile a corpus incrementally, diff
    and delta-upload it on the CPU and round-trip it through a blob."""
    code = (
        "import importlib, sys\n"
        "BLOCKED = ('aiohttp', 'grpc', 'jax', 'authorino_tpu')\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "        return None\n"
        "sys.meta_path.insert(0, Block())\n"
        f"importlib.import_module('authorino_tpu_torch.{mod}')\n"
        "from authorino_tpu_torch.models import northstar\n"
        "from authorino_tpu_torch.ops.operands import host_operands, host_view\n"
        "from authorino_tpu_torch.snapshots import CompileCache, plan_delta\n"
        "from authorino_tpu_torch.snapshots.delta import apply_delta, full_upload\n"
        "from authorino_tpu_torch.snapshots.serialize import deserialize_policy, "
        "serialize_policy\n"
        "cache = CompileCache()\n"
        "cfgs = northstar.build_corpus(8, 4)\n"
        "p0, _ = cache.compile(cfgs, members_k=4)\n"
        "p1, rep = cache.compile(cfgs[:7] + northstar.build_corpus(9, 4)[8:], "
        "members_k=4)\n"
        "v0, v1 = host_view(host_operands(p0)), host_view(host_operands(p1))\n"
        "prev, _ = full_upload(v0, 'cpu')\n"
        "plan = plan_delta(v0, v1)\n"
        "params, n = apply_delta(prev, v1, plan, 'cpu')\n"
        "loaded, meta = deserialize_policy(serialize_policy(p1, {'g': 2}))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)\n"
        "print('COMPILED', rep.compiled, 'SAME', n == plan.upload_bytes, "
        "'META', meta, 'BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "COMPILED 1 SAME True META {'g': 2} BAD []" in proc.stdout, \
        proc.stdout


def test_change_safety_imports_alone_without_services_or_the_reference():
    """The change-safety module imports on its own with ``grpc``,
    ``aiohttp``, ``jax`` and the JAX package blocked, and there its guard
    sees a planted poison and stays quiet on a clean churn."""
    code = (
        "import importlib, sys\n"
        "BLOCKED = ('aiohttp', 'grpc', 'jax', 'authorino_tpu')\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "        return None\n"
        "sys.meta_path.insert(0, Block())\n"
        "cs = importlib.import_module("
        "'authorino_tpu_torch.runtime.change_safety')\n"
        "doc = {'request': {'host': 'h', 'path': '/a', 'method': 'GET'}}\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)\n"
        "print('SELF', cs.guard_self_test(), 'BUCKET', cs.cohort_bucket(doc), "
        "'BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    import zlib

    bucket = zlib.crc32(b"h|/a|GET") % 10000
    assert f"SELF [] BUCKET {bucket} BAD []" in proc.stdout, proc.stdout


TENANCY_MODULES = ("tenancy", "tenancy.weights", "tenancy.quota",
                   "tenancy.fair_cut", "tenancy.stats", "tenancy.containment",
                   "tenancy.plane")


@pytest.mark.parametrize("mod", TENANCY_MODULES)
def test_tenancy_modules_import_alone_without_services_or_the_reference(mod):
    """Each module of the tenant QoS plane imports on its own with
    ``grpc``, ``aiohttp``, ``jax`` and the JAX package blocked, and there
    the plane resolves an annotated weight and cuts fairly."""
    code = (
        "import importlib, sys\n"
        "from collections import deque\n"
        "BLOCKED = ('aiohttp', 'grpc', 'jax', 'authorino_tpu')\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "        return None\n"
        "sys.meta_path.insert(0, Block())\n"
        f"importlib.import_module('authorino_tpu_torch.{mod}')\n"
        "from authorino_tpu_torch.tenancy import TenantPlane\n"
        "class E:\n"
        "    def __init__(self, i, a):\n"
        "        self.id, self.annotations = i, a\n"
        "class P:\n"
        "    def __init__(self, t):\n"
        "        self.config_name = t\n"
        "plane = TenantPlane()\n"
        "plane.bind_entries([E('g', {'authorino.tpu/qos-class': 'gold'}), "
        "E('b', None)])\n"
        "q = deque([P('b') for _ in range(20)] + "
        "[P('g') for _ in range(20)])\n"
        "cut = [p.config_name for p in plane.cut(q, 10)]\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)\n"
        "print('W', plane.book.weight('g'), 'G', cut.count('g'), "
        "'BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "W 4.0 G 8 BAD []" in proc.stdout, proc.stdout


VERIFY_REPLAY_MODULES = ("relations.prefetch", "replay", "replay.capture",
                         "replay.replay", "replay.pregate",
                         "replay.bench_load", "analysis", "analysis.fixtures",
                         "analysis.policy_analysis", "analysis.tensor_lint",
                         "analysis.translation_validate")


@pytest.mark.parametrize("mod", VERIFY_REPLAY_MODULES)
def test_verify_replay_modules_import_alone_without_services_or_the_reference(
        mod):
    """The metadata prefetcher, capture and replay, and the analysis core
    each import on their own with ``grpc``, ``aiohttp``, ``jax``, the JAX
    package, ``google.protobuf``, ``cryptography`` and ``opentelemetry``
    blocked, and there the validator's self-test is green, the lint finds
    a planted fault, a capture segment round-trips and a replay sees a
    planted flip."""
    code = (
        "import importlib, os, sys, tempfile\n"
        "BLOCKED = ('aiohttp', 'grpc', 'jax', 'authorino_tpu', "
        "'google.protobuf', 'cryptography', 'opentelemetry')\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if any(name == b or name.startswith(b + '.') "
        "for b in BLOCKED):\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "        return None\n"
        "sys.meta_path.insert(0, Block())\n"
        f"importlib.import_module('authorino_tpu_torch.{mod}')\n"
        "from authorino_tpu_torch.analysis import fixtures, tensor_lint\n"
        "from authorino_tpu_torch.analysis import translation_validate as tv\n"
        "from authorino_tpu_torch.relations.prefetch import doc_digest\n"
        "from authorino_tpu_torch.replay import capture, replay\n"
        "from authorino_tpu_torch.compiler import ConfigRules, "
        "compile_corpus\n"
        "from authorino_tpu_torch.expressions import Operator, Pattern\n"
        "p = fixtures.fixture_policy()\n"
        "p.fused_pack_w += 1\n"
        "kinds = [f.kind for f in tensor_lint.tensor_lint(p)]\n"
        "path = os.path.join(tempfile.mkdtemp(), 's.atpucap')\n"
        "recs = [{'authconfig': 'c', 'doc': {'auth': {'identity': "
        "{'org': 'a'}}}, 'rule_index': -1}] * 8\n"
        "capture.write_segment(path, recs)\n"
        "same = capture.read_segment(path)[1] == recs\n"
        "pol = lambda org: compile_corpus([ConfigRules('c', evaluators=["
        "(None, Pattern('auth.identity.org', Operator.EQ, org))])])\n"
        "rep = replay.replay_records(pol('a'), pol('b'), recs)\n"
        "bad = sorted(m for m in sys.modules if any(m == b or "
        "m.startswith(b + '.') for b in BLOCKED))\n"
        "print('SELF', tv.mutation_self_test(), 'KINDS', kinds, 'SAME', "
        "same, 'FLIPS', rep['flips']['newly_denied'], 'DIGEST', "
        "len(doc_digest({})), 'BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert ("SELF [] KINDS ['fused-pack-width'] SAME True FLIPS 8 "
            "DIGEST 64 BAD []") in proc.stdout, proc.stdout


STATE_MODULES = ("snapshots.distribution", "fleet", "fleet.warmjoin",
                 "runtime.state_plane", "runtime.restart_harness", "corpus",
                 "corpus.store", "corpus.distill", "corpus.synthesize",
                 "corpus.pregate", "corpus.bisect")


@pytest.mark.parametrize("mod", STATE_MODULES)
def test_state_modules_import_alone_without_services_or_the_reference(mod):
    """Snapshot distribution, the warm-join, the state plane, the restart
    harness and the decision corpus each import on their own with
    ``grpc``, ``aiohttp``, ``jax``, the JAX package, ``google.protobuf``,
    ``cryptography`` and ``opentelemetry`` blocked, and there a leader's
    blob installs on a CPU replica, a warm start serves it, a corpus
    round-trips, a synthesized witness catches a planted edit and the
    bisect names its generation."""
    code = (
        "import importlib, os, sys, tempfile, asyncio\n"
        "BLOCKED = ('aiohttp', 'grpc', 'jax', 'authorino_tpu', "
        "'google.protobuf', 'cryptography', 'opentelemetry')\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if any(name == b or name.startswith(b + '.') "
        "for b in BLOCKED):\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "        return None\n"
        "sys.meta_path.insert(0, Block())\n"
        f"importlib.import_module('authorino_tpu_torch.{mod}')\n"
        "from authorino_tpu_torch.analysis import fixtures\n"
        "from authorino_tpu_torch import corpus\n"
        "from authorino_tpu_torch.corpus import synthesize, pregate, bisect\n"
        "from authorino_tpu_torch.compiler import compile_corpus\n"
        "from authorino_tpu_torch.runtime import EngineEntry, PolicyEngine\n"
        "from authorino_tpu_torch.runtime.state_plane import StatePlane\n"
        "from authorino_tpu_torch.snapshots import distribution as dist\n"
        "d = tempfile.mkdtemp()\n"
        "cfgs = fixtures.fixture_configs()\n"
        "lead = PolicyEngine(device='cpu', strict_verify=True)\n"
        "plane = StatePlane(lead, d)\n"
        "plane.start()\n"
        "lead.apply_snapshot([EngineEntry(id=c.name, hosts=[c.name], "
        "rules=c) for c in cfgs])\n"
        "plane.shutdown()\n"
        "rep = PolicyEngine(device='cpu')\n"
        "warm = StatePlane(rep, d).warm_start()['snapshot']\n"
        "doc = {'request': {'method': 'GET', 'url_path': '/api/v1/x'}, "
        "'auth': {'identity': {'org': 'acme', 'roles': ['admin']}}}\n"
        "same = [bool(asyncio.run(e.submit(dict(doc), 'api'))[0][0]) "
        "for e in (lead, rep)]\n"
        "pol = fixtures.fixture_policy()\n"
        "rows = corpus.distill_records([{'authconfig': 'api', 'doc': doc, "
        "'t': 1.0}] * 4, pol)['rows']\n"
        "p = os.path.join(d, 'c.atpucorp')\n"
        "corpus.write_corpus(p, rows)\n"
        "back = corpus.read_corpus_file(p)[1] == rows\n"
        "syn = synthesize.augment_corpus(pol, rows)['rows']\n"
        "from authorino_tpu_torch.compiler import ConfigRules\n"
        "from authorino_tpu_torch.expressions import Operator, Pattern\n"
        "from authorino_tpu_torch.runtime.change_safety import "
        "GuardThresholds\n"
        "bad_cfgs = [c for c in cfgs if c.name != 'admin'] + "
        "[ConfigRules(name='admin', evaluators=[(None, Pattern("
        "'auth.identity.org', Operator.NEQ, 'acme'))])]\n"
        "th = GuardThresholds(min_requests=8, min_config_requests=1, "
        "min_config_allows=1)\n"
        "pf = pregate.corpus_preflight(pol, compile_corpus(bad_cfgs), "
        "rows + syn, th, changed={'admin'})\n"
        "ch = os.path.join(d, 'chain')\n"
        "pub = dist.SnapshotPublisher(ch)\n"
        "for g, cs in ((1, cfgs), (2, bad_cfgs)):\n"
        "    pub.publish_blob(dist.serialize_policy(compile_corpus(cs), "
        "meta={'generation': g}), g, {})\n"
        "diff = bisect.corpus_diff(bisect.load_generation_chain(ch), "
        "rows + syn)\n"
        "bad = sorted(m for m in sys.modules if any(m == b or "
        "m.startswith(b + '.') for b in BLOCKED))\n"
        "print('WARM', warm, 'SAME', same, 'BACK', back, 'SUSPECT', "
        "'admin' in (pf['breach'] or {}).get('suspects', []), 'GEN', "
        "sorted(diff['by_generation']), 'BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert ("WARM ok SAME [True, True] BACK True SUSPECT True GEN ['2'] "
            "BAD []") in proc.stdout, proc.stdout


# the fleet plane: import-light (numpy and the package's own utils, no
# evaluator, no engine, no torch), as the reference's docstring asks
FLEET_MODULES = ("fleet", "fleet.router", "fleet.aggregate",
                 "fleet.warmjoin", "fleet.replica", "fleet.harness")


@pytest.mark.parametrize("mod", FLEET_MODULES)
def test_fleet_modules_import_light_without_services_or_the_reference(mod):
    """Each fleet module imports on its own with ``grpc``, ``aiohttp``,
    ``jax``, the JAX package, ``cryptography`` and ``torch`` blocked, and
    pulls in no evaluator and no engine; there the router places keys and
    the aggregator judges a fold."""
    code = (
        "import importlib, sys\n"
        "BLOCKED = ('aiohttp', 'grpc', 'jax', 'authorino_tpu', "
        "'cryptography', 'torch')\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "        return None\n"
        "sys.meta_path.insert(0, Block())\n"
        f"importlib.import_module('authorino_tpu_torch.{mod}')\n"
        "from authorino_tpu_torch.fleet import (FleetAggregator, "
        "FleetRouter, routing_key)\n"
        "r = FleetRouter()\n"
        "r.add_replica('a', lambda: {'ready': True})\n"
        "r.add_replica('b', lambda: {'ready': True})\n"
        "picked = r.route(routing_key('c1', {'x': 1}))[0]\n"
        "agg = FleetAggregator()\n"
        "agg.ingest('a', {'tenants': {'t': {'requests': 1, 'denies': 0, "
        "'rate': 1.0}}})\n"
        "heavy = sorted(m for m in sys.modules if m.startswith("
        "('authorino_tpu_torch.evaluators', 'authorino_tpu_torch.runtime."
        "engine', 'authorino_tpu_torch.pipeline')))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)\n"
        "print('PICK', picked in ('a', 'b'), 'SHARES', agg.global_shares(), "
        "'HEAVY', heavy, 'BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "PICK True SHARES {'t': 1.0} HEAVY [] BAD []" in proc.stdout, \
        proc.stdout


@pytest.mark.parametrize("mod", ["parallel", "parallel.sharded_eval"])
def test_mesh_modules_import_without_services_or_the_reference(mod):
    """The mesh lane imports with ``grpc``, ``aiohttp``, ``jax`` and the
    JAX package blocked, and there a mesh of logical CPU slots decides a
    request on every block; ``build_mesh()`` with no card raises rather
    than guess a device."""
    code = (
        "import importlib, sys\n"
        "BLOCKED = ('aiohttp', 'grpc', 'jax', 'authorino_tpu')\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "        return None\n"
        "sys.meta_path.insert(0, Block())\n"
        f"importlib.import_module('authorino_tpu_torch.{mod}')\n"
        "import torch\n"
        "from authorino_tpu_torch.compiler import ConfigRules\n"
        "from authorino_tpu_torch.expressions import Operator, Pattern\n"
        "from authorino_tpu_torch.parallel import ShardedPolicyModel, "
        "build_mesh\n"
        "cfgs = [ConfigRules(name=f'c{i}', evaluators=[(None, Pattern("
        "'request.path', Operator.EQ, f'/p{i}'))]) for i in range(5)]\n"
        "m = ShardedPolicyModel(cfgs, build_mesh([torch.device('cpu')] * 4,"
        " dp=2), members_k=4)\n"
        "got = m.decide([{'request': {'path': f'/p{i % 5}'}} for i in "
        "range(6)] + [{'request': {'path': '/x'}}], [f'c{i % 5}' for i in "
        "range(7)])\n"
        "try:\n"
        "    build_mesh()\n"
        "    raised = False\n"
        "except RuntimeError:\n"
        "    raised = True\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)\n"
        "print('GOT', got, 'RAISED', raised or torch.cuda.is_available(), "
        "'BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert ("GOT [True, True, True, True, True, True, False] RAISED True "
            "BAD []") in proc.stdout, proc.stdout


def test_atomic_writer_ignores_the_reference_plane(tmp_path):
    """With both packages loaded, the reference's armed fs rule does not
    reach the port's writer (nor the port's the reference's): each writer
    consults its own package's plane."""
    from authorino_tpu.runtime import faults as ref_faults
    from authorino_tpu.utils import atomicio as ref_atomicio
    from authorino_tpu_torch.runtime import faults as port_faults
    from authorino_tpu_torch.utils import atomicio as port_atomicio

    path = str(tmp_path / "bundle.json")
    try:
        ref_faults.FAULTS.arm("fs:eio")
        port_atomicio.atomic_write_bytes(path, b"port")
        assert open(path, "rb").read() == b"port"
        with pytest.raises(OSError):
            ref_atomicio.atomic_write_bytes(path, b"ref")
        ref_faults.FAULTS.disarm()
        port_faults.FAULTS.arm("fs:eio")
        ref_atomicio.atomic_write_bytes(path, b"ref")
        with pytest.raises(OSError):
            port_atomicio.atomic_write_bytes(path, b"port")
        assert open(path, "rb").read() == b"ref"
    finally:
        ref_faults.FAULTS.disarm()
        port_faults.FAULTS.disarm()


def test_serving_modules_import_without_the_reference_or_its_libraries():
    """The serving modules import with ``jax``, the JAX package,
    ``google.protobuf``, ``cryptography`` and ``opentelemetry`` blocked:
    ``grpc`` and ``aiohttp`` are all they add, over the port's own
    protobuf codec."""
    mods = [f"authorino_tpu_torch.{m}" for m in SERVING_MODULES]
    code = (
        "import importlib, sys\n"
        "BLOCKED = ('jax', 'authorino_tpu', 'google.protobuf', "
        "'cryptography', 'opentelemetry')\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if any(name == b or name.startswith(b + '.') "
        "for b in BLOCKED):\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "        return None\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print('SERVING', 'grpc' in sys.modules, 'aiohttp' in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "SERVING True True" in proc.stdout


def test_chip_smoke_imports_neither():
    src = (ROOT / "chip_smoke.py").read_text()
    for line in src.splitlines():
        s = line.strip()
        if s.startswith(("import ", "from ")):
            assert "jax" not in s, s
            assert not s.split()[1].startswith("authorino_tpu.")
            assert s.split()[1] != "authorino_tpu", s


@pytest.mark.parametrize("script", ["engine_probe.py", "reconcile_probe.py",
                                    "grpc_window_probe.py"])
def test_card_probes_import_neither(script):
    src = (ROOT / script).read_text()
    for line in src.splitlines():
        s = line.strip()
        if s.startswith(("import ", "from ")):
            assert "jax" not in s, s
            assert s.split()[1].split(".")[0] != "authorino_tpu", s


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device exists")


def test_entry_points_without_device_raise_when_cuda_is_absent():
    _no_cuda()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PolicyEngine()
    policy = PolicyModel.from_configs(northstar.build_corpus(2, 4),
                                      device="cpu").policy
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PolicyModel(policy)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        p_ops.to_device(policy)
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        p_ops.to_device(policy, device="cuda")


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "CUDA_ROOT_DEFAULT", str(tmp_path / "none"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build.find_nvcc()
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build.load_library("fused_kernel")
    assert not (tmp_path / "build").exists() or \
        not any((tmp_path / "build").iterdir())


def test_build_reports_nvcc_failure(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: refused' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(_build.BuildError, match="refused"):
        _build.load_library("fused_kernel")


def test_kernel_wrappers_refuse_cpu_tensors():
    policy = PolicyModel.from_configs(northstar.build_corpus(2, 4),
                                      device="cpu").policy
    params = p_ops.to_device(policy, device="cpu")
    db = PolicyModel(policy, device="cpu").encode([{}], [0])
    buf, layout = p_ops.fuse_batch(db)
    out = torch.empty((1, policy.fused_pack_w), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        p_fk.launch_kernel(params, torch.from_numpy(buf), layout, out)
    with pytest.raises(ValueError, match="CUDA"):
        p_fk.launch_probe(torch.arange(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        p_fk.fused_kernel_supported("cpu")


def test_kernel_param_types_are_checked_before_a_launch():
    """Every tensor the kernel reads through a raw pointer must have the
    element type the kernel reads it as."""
    from authorino_tpu_torch.compiler import compile_corpus
    from authorino_tpu_torch.models import corpora

    policy = compile_corpus(corpora.all_lanes_corpus(7), members_k=4,
                            ovf_assist=True)
    params = p_ops.to_device(policy, device="cpu")
    cpu = torch.device("cpu")
    p_fk._check_kernel_tensors(params, cpu)
    for sub, name, _ in p_fk._KERNEL_PARAMS:
        tree = params[sub] if sub else params
        assert tree.get(name) is not None, name  # every lane is present
        bad = dict(tree, **{name: tree[name].to(torch.int64)})
        broken = dict(params, **({sub: bad} if sub else bad))
        with pytest.raises(ValueError, match=name):
            p_fk._check_kernel_tensors(broken, cpu)


def test_wrapper_routes_only_cpu_tensors_to_the_plain_version():
    """A params tree on any device but the CPU never reaches the plain
    version: the meta device (no kernel) raises instead."""
    policy = PolicyModel.from_configs(northstar.build_corpus(2, 4),
                                      device="cpu").policy
    params = p_ops.params_from_numpy(p_ops.to_device(policy, host=True),
                                     device="meta")
    db = PolicyModel(policy, device="cpu").encode([{}], [0])
    c0 = p_fk.plain_calls
    with pytest.raises(ValueError, match="no kernel"):
        p_fk.eval_fused_kernel(params, db)
    assert p_fk.plain_calls == c0


def test_build_dir_is_ignored_by_git():
    ignore = (ROOT / ".gitignore").read_text().split()
    assert "authorino_tpu_torch/_build/" in ignore
    assert _build.BUILD_DIR == ROOT / "authorino_tpu_torch" / "_build"
    assert np.all([p.suffix in (".cu",) for p in _build.CSRC_DIR.iterdir()])


# ---- the Check() request path ----------------------------------------------

# ``yaml`` is not blocked: the card's machine has PyYAML (6.0.3), and the
# manifest loader imports it as the reference does
BLOCKED = ("jax", "authorino_tpu", "grpc", "google.protobuf", "aiohttp",
           "cryptography", "prometheus_client")


def test_request_path_runs_without_the_reference_or_its_services():
    """Every module of the port below the serving modules imports, a
    ``spicedb`` config translates, and an anonymous and a plain-identity
    Check() are answered on the CPU, in a process where JAX, the JAX
    package and the serving and crypto libraries cannot be imported: the
    request path needs none of them."""
    mods = below_serving(port_modules())
    for m in ("pipeline.pipeline", "controllers.translate", "index.index",
              "evaluators.identity.api_key", "utils.metrics", "k8s.client",
              "runtime.provenance", "authjson.wellknown", "runtime.admission",
              "native", "native.encoder",
              "utils.verdict_cache", "snapshots.fingerprint"):
        assert f"authorino_tpu_torch.{m}" in mods, m
    code = (
        "import importlib, sys, asyncio\n"
        f"for name in {BLOCKED!r}: sys.modules[name] = None\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "from authorino_tpu_torch.authjson import CheckRequestModel, "
        "HttpRequestAttributes\n"
        "from authorino_tpu_torch.controllers import translate_auth_config\n"
        "from authorino_tpu_torch.runtime import PolicyEngine\n"
        "rule = {'patternMatching': {'patterns': [{'selector': "
        "'auth.identity.org', 'operator': 'eq', 'value': 'acme'}]}}\n"
        "anon = {'hosts': ['anon.test'], 'authentication': "
        "{'a': {'anonymous': {}}}, 'authorization': {'r': {"
        "'patternMatching': {'patterns': [{'selector': 'request.method', "
        "'operator': 'eq', 'value': 'GET'}]}}}}\n"
        "plain = {'hosts': ['plain.test'], 'authentication': {'p': {'plain': "
        "{'selector': 'request.headers.x-claims|@fromstr'}}}, "
        "'authorization': {'r': rule}}\n"
        "spicedb = {'hosts': ['db.test'], 'authentication': {'a': "
        "{'anonymous': {}}}, 'authorization': {'s': {'spicedb': {"
        "'endpoint': '127.0.0.1:1', 'insecure': True}}}}\n"
        "async def main():\n"
        "    engine = PolicyEngine(device='cpu', lane_select=False)\n"
        "    engine.apply_snapshot([\n"
        "        await translate_auth_config('anon', 'ns', anon, engine=engine),\n"
        "        await translate_auth_config('plain', 'ns', plain, engine=engine),\n"
        "        await translate_auth_config('db', 'ns', spicedb, engine=engine)])\n"
        "    def req(host, **h):\n"
        "        return CheckRequestModel(http=HttpRequestAttributes(\n"
        "            method='GET', path='/', host=host, headers=h))\n"
        "    out = [await engine.check(req('anon.test')),\n"
        "           await engine.check(req('plain.test', **{'x-claims': "
        "'{\"org\": \"acme\"}'})),\n"
        "           await engine.check(req('plain.test', **{'x-claims': "
        "'{\"org\": \"evil\"}'}))]\n"
        "    return [r.code for r in out], engine.stats\n"
        "codes, stats = asyncio.run(main())\n"
        "bad = sorted(m for m, v in sys.modules.items() if v is not None and "
        f"any(m == b or m.startswith(b + '.') for b in {BLOCKED!r}))\n"
        "print('CODES', codes, stats['plain_calls'], stats['batches'], "
        "'BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "CODES [0, 0, 7] 3 3 BAD []" in proc.stdout, proc.stdout


def _failing_launch(monkeypatch, where):
    def launch_raises(params, db):
        raise RuntimeError("kernel launch failed: secret detail")

    class BrokenReadback:
        nbytes = launches = 0
        plain_calls = 1

        def is_ready(self):
            return True

        def wait(self):
            raise RuntimeError("readback failed: secret detail")

    real = p_fk.dispatch_megakernel

    def readback_raises(params, db):
        handle = real(params, db)
        broken = BrokenReadback()
        broken.nbytes = handle.nbytes
        return broken

    monkeypatch.setattr(p_fk, "dispatch_megakernel",
                        launch_raises if where == "launch" else readback_raises)


@pytest.mark.parametrize("where", ["launch", "readback"])
def test_batch_failure_answers_unavailable_not_a_denial(monkeypatch, where):
    """A batch that fails twice resolves every Check() in it through the
    host oracle, as the reference engine's ``_degrade_batch`` does: the
    exact verdict (OK for a GET), counted as degraded, never a denial with
    the exception's text, never the plain version's answer, never a
    failed batch."""
    import asyncio

    from authorino_tpu_torch.authjson import (CheckRequestModel,
                                              HttpRequestAttributes)
    from authorino_tpu_torch.controllers import translate_auth_config
    from authorino_tpu_torch.utils.rpc import OK

    spec = {"hosts": ["f.test"], "authentication": {"a": {"anonymous": {}}},
            "authorization": {"r": {"patternMatching": {"patterns": [
                {"selector": "request.method", "operator": "eq",
                 "value": "GET"}]}}}}
    engine = PolicyEngine(max_batch=4, device="cpu", breaker_threshold=100)
    real_plain = p_fk.fused_packed_plain

    def plain_spy(params, ops):
        plain_spy.calls += 1
        return real_plain(params, ops)

    plain_spy.calls = 0

    async def body():
        engine.apply_snapshot([await translate_auth_config(
            "f", "ns", spec, engine=engine)])
        _failing_launch(monkeypatch, where)
        monkeypatch.setattr(p_fk, "fused_packed_plain", plain_spy)
        req = CheckRequestModel(http=HttpRequestAttributes(
            method="GET", path="/", host="f.test"))
        return await asyncio.gather(*(engine.check(req) for _ in range(6)))

    loop = asyncio.new_event_loop()
    try:
        results = loop.run_until_complete(body())
    finally:
        loop.close()
    for r in results:
        assert r.code == OK
        assert "secret detail" not in repr(r)
    st = engine.stats
    assert (st["degraded_batches"], st["degraded_rows"]) == (2, 6)
    assert (st["failed_batches"], st["host_fallback"]) == (0, 0)
    # the readback case ran the plain version once per device attempt (2
    # batches, each twice); the degrade never did
    assert plain_spy.calls == (0 if where == "launch" else 4)


def test_jwt_request_path_runs_without_the_reference_or_its_services():
    """The JWT path end to end on the CPU engine, in a process where JAX,
    the JAX package, aiohttp, cryptography and grpc cannot be imported:
    keys made in pure Python, the fake Keycloak on loopback, discovery
    and JWKS over the port's HTTP client at translate time, then an RS256
    and an ES256 token verified by the port's JOSE, a bad token, the full
    config (userInfo, http and uma metadata, a wristband, a callback) and
    an introspected opaque token."""
    code = (
        "import importlib, sys, asyncio\n"
        f"for name in {BLOCKED!r}: sys.modules[name] = None\n"
        "from authorino_tpu_torch.authjson import CheckRequestModel, "
        "HttpRequestAttributes\n"
        "from authorino_tpu_torch.controllers import translate_auth_config\n"
        "from authorino_tpu_torch.k8s import InMemoryCluster, Secret\n"
        "from authorino_tpu_torch.models import oidc_corpus as oc\n"
        "from authorino_tpu_torch.runtime import PolicyEngine\n"
        "from authorino_tpu_torch.utils import jose\n"
        "keys = oc.make_keys(5, rsa_bits=1024)\n"
        "async def main(idp):\n"
        "    engine = PolicyEngine(device='cpu', lane_select=False)\n"
        "    cluster = InMemoryCluster()\n"
        "    for s in oc.cluster_secrets(keys): cluster.put_secret(Secret(**s))\n"
        "    specs = oc.build_auth_configs(2, 6, idp.issuer) + [\n"
        "        oc.full_auth_config(idp.issuer), "
        "oc.introspection_auth_config(idp.issuer)]\n"
        "    engine.apply_snapshot([await translate_auth_config(\n"
        "        o['metadata']['name'], o['metadata']['namespace'], o['spec'],\n"
        "        cluster=cluster, engine=engine) for o in specs])\n"
        "    def req(host, token, path='/pets', method='GET'):\n"
        "        return CheckRequestModel(http=HttpRequestAttributes(\n"
        "            method=method, path=path, host=host,\n"
        "            headers={'authorization': f'Bearer {token}'}))\n"
        "    rs = idp.token({'org': 'org-0'})\n"
        "    es = idp.token({'org': 'org-7', 'realm_access': {'roles': "
        "['admin']}}, alg='ES256')\n"
        "    out = [await engine.check(r) for r in (\n"
        "        req(oc.host_of(0), rs, method='POST'),\n"
        "        req(oc.host_of(0), idp.bad_token('signature', {})),\n"
        "        req(oc.FULL_HOST, es), req(oc.INTROSPECTION_HOST, "
        "'opaque-active'),\n"
        "        req(oc.INTROSPECTION_HOST, 'opaque-other'))]\n"
        "    wb = out[2].headers[0]['x-wristband']\n"
        "    jwks = [jose.jwk_from_public_key(keys.wristband.public_key(), "
        "kid='wristband-key', alg='ES256')]\n"
        "    claims = jose.verify_jws(wb, jwks)\n"
        "    return [r.code for r in out], claims['org'], "
        "len(idp.callbacks), engine.stats['rows']\n"
        "with oc.FakeKeycloak(keys) as idp:\n"
        "    codes, org, callbacks, rows = asyncio.run(main(idp))\n"
        "bad = sorted(m for m, v in sys.modules.items() if v is not None and "
        f"any(m == b or m.startswith(b + '.') for b in {BLOCKED!r}))\n"
        "print('CODES', codes, org, callbacks, rows, 'BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "CODES [7, 16, 0, 0, 16] org-7 1 3 BAD []" in proc.stdout, \
        proc.stdout


def test_control_plane_runs_without_the_reference_or_its_services():
    """Manifests in a directory through ``YamlDirSource`` into a CPU
    engine, in a process where JAX, the JAX package, aiohttp,
    cryptography and grpc cannot be imported: v1beta1 and v1beta2 API-key
    configs with their Secrets, an x509 config trusting a CA Secret made
    with the port's own keys and certificate writer, then a revoked key
    and a removed CA after a second ``sync()``."""
    code = (
        "import importlib, sys, asyncio, json, os, random, tempfile\n"
        f"for name in {BLOCKED!r}: sys.modules[name] = None\n"
        "from authorino_tpu_torch.controllers import AuthConfigReconciler, "
        "SecretReconciler\n"
        "from authorino_tpu_torch.controllers.sources import YamlDirSource\n"
        "from authorino_tpu_torch.k8s import InMemoryCluster\n"
        "from authorino_tpu_torch.models import control_plane as cp\n"
        "from authorino_tpu_torch.runtime import PolicyEngine\n"
        "from authorino_tpu_torch.utils import pki\n"
        "ca = cp.CertAuthority(pki.generate_ec_private_key(pki.P256, "
        "random.Random(1)), [[(cp.OID['CN'], 'ca')]])\n"
        "client = ca.issue([[(cp.OID['O'], 'org-0')]]).decode()\n"
        "reqs, cfgs, known = cp.build_check_requests(8, 2, unknown_every=4)\n"
        "def write(d, n_keys, with_ca):\n"
        "    for f in os.listdir(d): os.remove(os.path.join(d, f))\n"
        "    docs = cp.build_auth_configs(2, 6) + [cp.mtls_auth_config(0)]\n"
        "    docs += [cp.api_key_secret(i) for i in range(n_keys)]\n"
        "    if with_ca: docs.append(cp.ca_secret('ca', ca.pem))\n"
        "    for k, doc in enumerate(docs):\n"
        "        with open(os.path.join(d, f'{k}.json'), 'w') as f: "
        "json.dump(doc, f)\n"
        "async def main(d):\n"
        "    engine = PolicyEngine(device='cpu')\n"
        "    cluster = InMemoryCluster()\n"
        "    rec = AuthConfigReconciler(engine, cluster=cluster)\n"
        "    src = YamlDirSource(d, rec, cluster, SecretReconciler(engine))\n"
        "    mtls = cp.CheckRequestModel(http=cp.HttpRequestAttributes(\n"
        "        method='GET', path='/', host=cp.MTLS_HOST.format(k=0)))\n"
        "    mtls.source.certificate = client\n"
        "    out = []\n"
        "    for n_keys, with_ca in ((2, True), (1, False)):\n"
        "        write(d, n_keys, with_ca)\n"
        "        await src.sync()\n"
        "        out.append([(await engine.check(r)).code for r in reqs])\n"
        "        out.append((await engine.check(mtls)).code)\n"
        "    return out, rec.ready(), engine.generation\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    out, ready, gen = asyncio.run(main(d))\n"
        "bad = sorted(m for m, v in sys.modules.items() if v is not None and "
        f"any(m == b or m.startswith(b + '.') for b in {BLOCKED!r}))\n"
        "print('OUT', json.dumps([out, cfgs, known, ready, gen]), 'BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("OUT ")][0]
    assert line.endswith("BAD []"), line
    import json

    (first, m1, second, m2), cfgs, known, ready, gen = json.loads(
        line[4:-len(" BAD []")])
    assert ready and (m1, m2) == (0, 16)
    for codes, n_keys in ((first, 2), (second, 1)):
        for code, i, good in zip(codes, cfgs, known):
            # a known key is allowed or denied by its rule; an unknown or
            # revoked one is UNAUTHENTICATED
            assert (code in (0, 7)) == (good and i < n_keys), (code, i, good)
    assert gen == 3  # the bootstrap deny-all and one swap per sync


# ---- the native encoder's build ---------------------------------------------

def test_native_build_reads_only_its_csrc_and_writes_only_build(monkeypatch,
                                                                tmp_path):
    """The port's native loader compiles only the sources under
    ``authorino_tpu_torch/native/csrc/`` (never the JAX package's root
    ``native/``), whose includes stay inside that directory, and writes
    only under ``authorino_tpu_torch/_build/``: the extension and the load
    generator, a program of its own."""
    from authorino_tpu_torch import native

    csrc = ROOT / "authorino_tpu_torch" / "native" / "csrc"
    assert native.CSRC_DIR == csrc
    assert sorted(p.name for p in csrc.iterdir()) == sorted(
        native.SOURCES + (native.LOADGEN_SOURCE,))
    for name in native.SOURCES + (native.LOADGEN_SOURCE,):
        for inc in re.findall(r'#include\s+"([^"]+)"',
                              (csrc / name).read_text()):
            assert (csrc / inc).resolve().parent == csrc, (name, inc)
    lib = native.library_path()
    assert lib.parent == _build.BUILD_DIR == ROOT / "authorino_tpu_torch" \
        / "_build"
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(native.subprocess, "run", fake_run)
    out = _build.BUILD_DIR / "_atpuenc_torch-boundary-test.so"
    try:
        native._build(out)
        assert out.exists()
    finally:
        out.unlink(missing_ok=True)
    (cmd,) = calls
    inputs = [Path(a) for a in cmd if a.endswith((".cpp", ".cc", ".c"))]
    assert inputs == [csrc / "pymod.cpp"]
    tmp_out = Path(cmd[cmd.index("-o") + 1])
    assert tmp_out.parent == _build.BUILD_DIR
    assert cmd[cmd.index("-I") + 1] == native._include_dir()
    root_native = ROOT / "native"
    assert not any(str(root_native) + os.sep in a or a == str(root_native)
                   for a in map(str, cmd))
    assert cmd[-3:-2] == ["-ldl"]   # frontend.cpp dlopens libnghttp2


def test_native_encoder_runs_without_the_reference_or_its_services():
    """The north-star corpus encodes natively, in both modes, in a process
    where JAX, the JAX package and the serving and crypto libraries cannot
    be imported: the library builds (or loads) from the port's own
    sources, and the engine's snapshot carries the encoder."""
    code = (
        "import sys, asyncio\n"
        f"for name in {BLOCKED!r}: sys.modules[name] = None\n"
        "from authorino_tpu_torch.models import northstar\n"
        "from authorino_tpu_torch.native.encoder import TOTALS\n"
        "from authorino_tpu_torch.runtime import EngineEntry, PolicyEngine\n"
        "e = PolicyEngine(max_batch=64, device='cpu')\n"
        "cfgs = northstar.build_corpus(20, 10)\n"
        "e.apply_snapshot([EngineEntry(id=c.name, hosts=[c.name], rules=c) "
        "for c in cfgs])\n"
        "docs = northstar.build_docs(64)\n"
        "async def go(): return await asyncio.gather(*(e.submit(d, "
        "f'cfg-{i % 20}') for i, d in enumerate(docs)))\n"
        "out = asyncio.run(go())\n"
        "enc = e._snapshot.encoder\n"
        "enc.mode = 'json'\n"
        "enc.encode_batch(docs, [i % 20 for i in range(64)])\n"
        "bad = sorted(m for m, v in sys.modules.items() if v is not None and "
        f"any(m == b or m.startswith(b + '.') for b in {BLOCKED!r}))\n"
        "print('ENC', len(out), dict(TOTALS), 'BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("AUTHORINO_TPU_NATIVE", None)
    env.pop("AUTHORINO_TPU_ENCODE_MODE", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert ("ENC 64 {'object': 1, 'json': 1, 'bailed': 0} BAD []"
            in proc.stdout), proc.stdout


def test_package_data_ships_every_kernel_and_encoder_source():
    """An installed port builds its kernel and its host encoder at first
    use: every file under ``authorino_tpu_torch/*/csrc/`` must match a
    ``package-data`` pattern of ``pyproject.toml``, and the console script
    must name the port's CLI."""
    import fnmatch
    import tomllib

    conf = tomllib.loads((ROOT / "pyproject.toml").read_text())
    patterns = conf["tool"]["setuptools"]["package-data"]["authorino_tpu_torch"]
    pkg = ROOT / "authorino_tpu_torch"
    sources = sorted(str(f.relative_to(pkg)) for f in pkg.glob("*/csrc/*")
                     if f.is_file())
    assert "ops/csrc/fused_kernel.cu" in sources
    assert "native/csrc/encoder.cpp" in sources
    for src in sources:
        assert any(fnmatch.fnmatch(src, pat) for pat in patterns), src
    assert conf["project"]["scripts"]["authorino-tpu-torch"] == \
        "authorino_tpu_torch.cli:main"


# the observability planes: the cost ledger and model, the SLO tracker, the
# flight recorder with its atomic writer, the metric families, the engine
OBSERVABILITY_MODULES = ("utils.atomicio", "utils.metrics", "utils.slo",
                         "runtime.flight_recorder", "runtime.kernel_cost",
                         "runtime.engine")


def test_observability_planes_run_without_prometheus_or_the_reference():
    """The planes import and serve with ``jax``, the JAX package, ``grpc``,
    ``aiohttp`` and ``prometheus_client`` blocked: every metric is a
    no-op, the SLO, the ledger and the recorder still count, and a bundle
    carries an empty exposition, as the reference's does."""
    mods = [f"authorino_tpu_torch.{m}" for m in OBSERVABILITY_MODULES]
    code = (
        "import asyncio, importlib, json, os, sys, tempfile\n"
        "BLOCKED = ('jax', 'authorino_tpu', 'grpc', 'aiohttp', "
        "'prometheus_client')\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "        return None\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "from authorino_tpu_torch.utils import metrics\n"
        "from authorino_tpu_torch.models import northstar\n"
        "from authorino_tpu_torch.runtime import EngineEntry, PolicyEngine\n"
        "from authorino_tpu_torch.runtime.flight_recorder import RECORDER\n"
        "from authorino_tpu_torch.runtime.kernel_cost import LEDGER\n"
        "assert not metrics._PROM\n"
        "assert type(metrics.kernel_launches).__name__ == '_NoopMetric'\n"
        "d = tempfile.mkdtemp()\n"
        "RECORDER.configure(dump_dir=d, min_dump_interval_s=0)\n"
        "e = PolicyEngine(max_batch=32, device='cpu', slo_ms=10000)\n"
        "cfgs = northstar.build_corpus(8, 4)\n"
        "e.apply_snapshot([EngineEntry(id=c.name, hosts=[c.name], rules=c)"
        " for c in cfgs])\n"
        "docs = northstar.build_docs(24)\n"
        "async def go():\n"
        "    return await asyncio.gather(*(e.submit(x, f'cfg-{i % 8}') "
        "for i, x in enumerate(docs)))\n"
        "assert len(asyncio.run(go())) == 24\n"
        "path = RECORDER.dump('manual')\n"
        "b = json.load(open(path))\n"
        "dv = e.debug_vars()\n"
        "print('PLANES', LEDGER.snapshot('engine')['rows'], "
        "dv['slo']['observed_total'], b['metrics'] == '', b['schema'], "
        "sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "PLANES 24 24 True 1 []" in proc.stdout


def _fault(*a, **k):
    raise RuntimeError("plane fault")


class _FaultyRing:
    """A flight-recorder ring whose appends raise."""

    append = staticmethod(_fault)

    def __len__(self):
        return 0

    def __iter__(self):
        return iter(())


def _plane_targets():
    from authorino_tpu_torch.runtime import flight_recorder, kernel_cost
    from authorino_tpu_torch.utils import metrics, slo

    return {
        "ledger": (kernel_cost.CostLedger, "observe", _fault),
        "batch families": (metrics, "observe_batch", _fault),
        "pipeline stages": (metrics, "observe_pipeline_stage", _fault),
        "slo": (slo.SloTracker, "observe", _fault),
        "cost model": (kernel_cost, "modeled_fused_cost", _fault),
        "recorder ring": (flight_recorder.RECORDER, "_ring", _FaultyRing()),
    }


PLANES = ("ledger", "batch families", "pipeline stages", "slo",
          "cost model", "recorder ring")


@pytest.mark.parametrize("plane", PLANES)
def test_a_plane_fault_never_changes_a_verdict(monkeypatch, plane):
    """With one plane raising on every call, every batch still answers the
    verdicts of an engine whose planes work, with no retry and no failed
    batch: the planes are advisory."""
    import asyncio

    from authorino_tpu_torch.runtime import EngineEntry, kernel_cost

    def serve(engine, docs, names):
        async def go():
            return await asyncio.gather(*(engine.submit(d, n)
                                          for d, n in zip(docs, names)))
        loop = asyncio.new_event_loop()
        try:
            return loop.run_until_complete(go())
        finally:
            loop.close()

    cfgs = northstar.build_corpus(12, 4)
    docs = northstar.build_docs(40, seed=2)
    names = [f"cfg-{i % 12}" for i in range(40)]
    entries = [EngineEntry(id=c.name, hosts=[c.name], rules=c) for c in cfgs]
    healthy = PolicyEngine(max_batch=16, device="cpu", slo_ms=1.0)
    healthy.apply_snapshot(entries)
    want = serve(healthy, docs, names)

    target, attr, value = _plane_targets()[plane]
    monkeypatch.setattr(target, attr, value)
    monkeypatch.setattr(kernel_cost, "_ANALYSIS_MEMO", {})
    faulty = PolicyEngine(max_batch=16, device="cpu", slo_ms=1.0)
    faulty.apply_snapshot(entries)
    got = serve(faulty, docs, names)
    for (wr, ws), (gr, gs) in zip(want, got):
        assert wr.tolist() == gr.tolist() and ws.tolist() == gs.tolist()
    st = faulty.stats
    assert (st["batches"], st["retries"], st["failed_batches"]) == (3, 0, 0)
