"""The system under test as its users run it: ``python -m
authorino_tpu_torch server`` over a directory of manifests, with the
native gRPC frontend on and every serving setting at its default (in a
traced run started through ``traced_server.py``, under the profiler),
on the cores it is given.

The process runs with ``-X importtime``, so its log names every module
it imported; ``imported_top_level`` reads them back.  Its ``TMPDIR`` is
the run's own, so the flight recorder's bundles land there; its kernel
caches are fixed directories of the checkout."""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set

from harness.cells import BENCH_DIR, ROOT

CACHE_ENV = {"TORCH_EXTENSIONS_DIR": BENCH_DIR / "_build" / "torch_extensions",
             "TRITON_CACHE_DIR": BENCH_DIR / "_build" / "triton"}


class ServerError(RuntimeError):
    """The server did not start, answer or stop."""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Server:
    def __init__(self, watch_dir: Path, run_dir: Path, device: str,
                 traced: bool, extra_env: Optional[Dict[str, str]] = None,
                 cpus: Optional[Set[int]] = None):
        self.grpc_port, self.http_port = free_port(), free_port()
        self.ports = [self.grpc_port, self.http_port, free_port(), free_port()]
        self.log_path = run_dir / "server.log"
        tmp = run_dir / "tmp"
        tmp.mkdir(parents=True, exist_ok=True)
        # a traced run's server runs under the profiler
        entry = ([str(Path(__file__).resolve().parent / "traced_server.py")]
                 if traced else ["-m", "authorino_tpu_torch"])
        self.argv = [sys.executable, "-X", "importtime", *entry, "server",
                     "--watch-dir", str(watch_dir), "--native-frontend", "on",
                     "--ext-auth-grpc-port", str(self.ports[0]),
                     "--ext-auth-http-port", str(self.ports[1]),
                     "--oidc-http-port", str(self.ports[2]),
                     "--metrics-addr-port", str(self.ports[3])]
        if device != "cuda":
            self.argv += ["--device", device]
        env = dict(os.environ, TMPDIR=str(tmp))
        self.trace_path = run_dir / "trace.json"
        if traced:
            env["BENCH_TRACE_OUT"] = str(self.trace_path)
        env.update({k: str(v) for k, v in CACHE_ENV.items()})
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        env.update(extra_env or {})
        self.env = env
        self.cpus = cpus
        self.proc: Optional[subprocess.Popen] = None

    def start(self) -> None:
        for d in CACHE_ENV.values():
            d.mkdir(parents=True, exist_ok=True)
        with open(self.log_path, "wb") as log:
            self.proc = subprocess.Popen(
                self.argv, env=self.env, cwd=str(ROOT), stdout=log,
                stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL,
                preexec_fn=(lambda: os.sched_setaffinity(0, self.cpus))
                if self.cpus else None)

    def url(self, path: str) -> str:
        return f"http://127.0.0.1:{self.http_port}{path}"

    def wait_ready(self, timeout_s: float) -> float:
        """Seconds until ``/readyz`` answered 200 (the gRPC listener binds
        before the HTTP one, so the native frontend serves by then)."""
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout_s:
            if self.proc.poll() is not None:
                raise ServerError(f"the server exited with "
                                  f"{self.proc.returncode} before it was "
                                  f"ready:\n{self.log_tail()}")
            try:
                with urllib.request.urlopen(self.url("/readyz"),
                                            timeout=2) as r:
                    if r.status == 200:
                        return time.monotonic() - t0
            except (urllib.error.URLError, OSError):
                pass
            time.sleep(0.1)
        raise ServerError(f"the server was not ready in {timeout_s:.0f} s:\n"
                          f"{self.log_tail()}")

    def get_json(self, path: str, timeout_s: float = 30) -> dict:
        with urllib.request.urlopen(self.url(path), timeout=timeout_s) as r:
            return json.loads(r.read())

    def frontend_stats(self) -> Dict[str, int]:
        """The native frontend's counters (``/debug/vars``)."""
        fe = self.get_json("/debug/vars").get("native_frontend") or {}
        if not fe.get("enabled"):
            raise ServerError(f"the native frontend does not serve: {fe}")
        return fe["stats"]

    def stop(self, timeout_s: float = 40) -> int:
        """SIGTERM (the server drains), then SIGKILL past ``timeout_s``;
        the exit code.  The server stays in the run's process group, so a
        signal to the group reaches it too."""
        if self.proc is None:
            return 0
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                return self.proc.wait(timeout_s)
            except subprocess.TimeoutExpired:
                self.proc.kill()
        return self.proc.wait()

    def log_tail(self, n: int = 4000) -> str:
        try:
            text = self.log_path.read_text(errors="replace")
        except OSError:
            return ""
        lines = [ln for ln in text.splitlines()
                 if not ln.startswith("import time:")]
        return "\n".join(lines)[-n:]

    def imported_top_level(self) -> Set[str]:
        """Top-level names of every module the server imported."""
        names: Set[str] = set()
        with open(self.log_path, errors="replace") as f:
            for line in f:
                if line.startswith("import time:"):
                    name = line.rsplit("|", 1)[-1].strip()
                    if name and name != "imported package":
                        names.add(name.split(".")[0])
        return names


FORBIDDEN = ("jax", "jaxlib", "flax", "authorino_tpu")


def forbidden(names: Iterable[str]) -> List[str]:
    """The names among ``names`` whose top-level part is JAX's or the JAX
    package's, compared whole."""
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})
