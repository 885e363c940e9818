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
