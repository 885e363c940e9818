"""The benchmark's own tests: its reference, generators, judgement and
last line on the CPU (``python -m pytest benchmark/tests``), and on the
card what only the card can run (marked ``cuda``; they skip here)."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(BENCH))

SMALL = {"auth_configs": 30}
SMALL_TRAFFIC = {"depth": 64, "connections": 2, "warmup_s": 1}
SMALL_MIX = {"distinct": 2000}


@pytest.fixture
def card():
    """Skips a test without a CUDA card (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")


def small_run(capsys, workload, *extra, trace=0, seed=3000000017,
              server_env=None, seconds=2, bench=None):
    """One run of ``workload`` on a CPU server at a small size: (exit
    code, the last line of standard output as a dict or None, standard
    error)."""
    import json

    import run

    hooks = run.Hooks(device="cpu", config=dict(SMALL),
                      traffic=dict(SMALL_TRAFFIC), mix=dict(SMALL_MIX),
                      server_env=server_env or {}, bench=bench)
    rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace), *extra], hooks)
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err
