"""Boundaries of the PyTorch port: it imports neither JAX nor the JAX
package; its entry points refuse to guess a device; its kernel build
refuses to proceed without nvcc; its kernel wrappers never hand a CUDA
tensor's work to the plain version (and never take a CPU tensor to the
kernel)."""

import os
import pkgutil
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
    return sorted(m.name for m in pkgutil.walk_packages(
        authorino_tpu_torch.__path__, "authorino_tpu_torch."))


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


def test_port_imports_with_service_libraries_blocked():
    """The card's machine has neither ``aiohttp`` nor ``cryptography``:
    every module of the port (OPA and the Kubernetes reviews among them)
    imports with both blocked, and with ``jax`` blocked too."""
    mods = port_modules()
    assert "authorino_tpu_torch.evaluators.authorization.opa" in mods
    assert "authorino_tpu_torch.evaluators.identity.kubernetes" in mods
    code = (
        "import importlib, sys\n"
        "BLOCKED = ('aiohttp', 'cryptography', 'jax', 'authorino_tpu')\n"
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


def test_chip_smoke_imports_neither():
    src = (ROOT / "chip_smoke.py").read_text()
    for line in src.splitlines():
        s = line.strip()
        if s.startswith(("import ", "from ")):
            assert "jax" not in s, s
            assert not s.split()[1].startswith("authorino_tpu.")
            assert s.split()[1] != "authorino_tpu", s


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

BLOCKED = ("jax", "authorino_tpu", "grpc", "google.protobuf", "aiohttp",
           "cryptography", "prometheus_client", "yaml")


def test_request_path_runs_without_the_reference_or_its_services():
    """Every module of the port imports, and an anonymous and a
    plain-identity Check() are answered on the CPU, in a process where
    JAX, the JAX package and the serving and crypto libraries cannot be
    imported: the card's machine has none of them."""
    mods = port_modules()
    for m in ("pipeline.pipeline", "controllers.translate", "index.index",
              "evaluators.identity.api_key", "utils.metrics", "k8s.client",
              "runtime.provenance", "authjson.wellknown"):
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
        "async def main():\n"
        "    engine = PolicyEngine(device='cpu')\n"
        "    engine.apply_snapshot([\n"
        "        await translate_auth_config('anon', 'ns', anon, engine=engine),\n"
        "        await translate_auth_config('plain', 'ns', plain, engine=engine)])\n"
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
        nbytes = 0

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
    """A batch that fails resolves every Check() in it as the typed
    UNAVAILABLE the reference engine's ``_resolve_error`` gives, counts the
    batch in ``failed_batches``, and neither denies with the exception's
    text nor falls back to another lane."""
    import asyncio

    from authorino_tpu_torch.authjson import (CheckRequestModel,
                                              HttpRequestAttributes)
    from authorino_tpu_torch.controllers import translate_auth_config
    from authorino_tpu_torch.utils.rpc import UNAVAILABLE

    spec = {"hosts": ["f.test"], "authentication": {"a": {"anonymous": {}}},
            "authorization": {"r": {"patternMatching": {"patterns": [
                {"selector": "request.method", "operator": "eq",
                 "value": "GET"}]}}}}
    engine = PolicyEngine(max_batch=4, device="cpu")

    async def body():
        engine.apply_snapshot([await translate_auth_config(
            "f", "ns", spec, engine=engine)])
        _failing_launch(monkeypatch, where)
        req = CheckRequestModel(http=HttpRequestAttributes(
            method="GET", path="/", host="f.test"))
        return await asyncio.gather(*(engine.check(req) for _ in range(6)))

    loop = asyncio.new_event_loop()
    try:
        results = loop.run_until_complete(body())
    finally:
        loop.close()
    for r in results:
        assert (r.code, r.message) == (UNAVAILABLE,
                                       "policy evaluation unavailable")
        assert "secret detail" not in repr(r)
    st = engine.stats
    assert st["failed_batches"] == 2  # 6 checks, max_batch 4
    assert st["host_fallback"] == 0
