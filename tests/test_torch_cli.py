"""The port's process entry point (``authorino_tpu_torch/cli.py``,
``__main__.py``) against the reference's:

* every flag of the reference's ``server`` and ``webhooks`` parsers
  parses to the same value in the port's, under the defaults, under their
  environment variables and given on the command line (``--jax-platform``
  is the one exception: the port has ``--device``);
* a flag of a plane the port does not hold yet stops the start, naming
  it; ``--native-frontend on`` serves through the native frontend and
  raises with TLS flags or without its library, where ``auto`` falls back
  to grpc.aio with one WARNING naming why; the SLO and flight-recorder flags
  reach the engine and the recorder, and /debug/vars and /metrics carry
  the observability planes; ``--breaker-threshold``, ``--breaker-reset``
  and ``--fault-profile`` reach the breaker and arm the port's fault
  plane;
* ``run_server --device cpu --watch-dir`` gets ready on free ports and
  answers gRPC and HTTP Check()s equal to the reference's, then drains on
  cancellation;
* ``python -m authorino_tpu_torch version``, and ``server --device cpu``
  in a subprocess that exits 0 on SIGTERM within ``--drain-timeout``;
* without a card and without ``--device cpu`` the start raises before
  anything binds."""

import asyncio
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import grpc
import pytest
import torch

from authorino_tpu import cli as ref_cli
from authorino_tpu import protos as ref_protos
from authorino_tpu_torch import cli as port_cli
from authorino_tpu_torch.models import control_plane as cp
from authorino_tpu_torch.protos import wire
from authorino_tpu_torch.service import grpc_server as port_grpc

ROOT = Path(__file__).resolve().parent.parent
pb = ref_protos.external_auth_pb2
CHECK = "/envoy.service.auth.v3.Authorization/Check"
TIMEOUT = 60


def env_names():
    """Every environment variable the reference's parser reads."""
    src = (ROOT / "authorino_tpu" / "cli.py").read_text()
    return sorted(set(re.findall(r'env_var\("([A-Z_]+)"', src))
                  - {"JAX_PLATFORM"})


def parsed(module, argv):
    ns = vars(module.build_parser().parse_args(argv))
    ns.pop("jax_platform", None)
    ns.pop("device", None)
    return ns


@pytest.mark.parametrize("command", ["server", "webhooks", "version"])
def test_defaults_parse_equal(command, monkeypatch):
    for name in env_names():
        monkeypatch.delenv(name, raising=False)
    assert parsed(port_cli, [command]) == parsed(ref_cli, [command])


@pytest.mark.parametrize("value", ["1", "0", "7", "2.5", "true", "x"])
def test_environment_variables_parse_equal(value, monkeypatch):
    for name in env_names():
        monkeypatch.setenv(name, value)
    for command in ("server", "webhooks"):
        assert parsed(port_cli, [command]) == parsed(ref_cli, [command])


def every_flag_argv(parser_module, command):
    """The reference's ``command`` flags, each given on the command line
    (a store_true flag bare, a choice its last choice, any other "3")."""
    parser = parser_module.build_parser()
    sub = next(a for a in parser._actions
               if isinstance(a, type(parser._subparsers._group_actions[0])))
    argv = [command]
    for action in sub.choices[command]._actions:
        if not action.option_strings or action.dest in ("help",
                                                        "jax_platform"):
            continue
        flag = action.option_strings[0]
        if action.nargs == 0:
            argv.append(flag)
        elif action.choices:
            argv += [flag, list(action.choices)[-1]]
        else:
            argv += [flag, "3"]
    return argv


@pytest.mark.parametrize("command", ["server", "webhooks"])
def test_every_flag_given_parses_equal(command):
    argv = every_flag_argv(ref_cli, command)
    assert len(argv) > (80 if command == "server" else 4)
    assert parsed(port_cli, argv) == parsed(ref_cli, argv)
    assert every_flag_argv(port_cli, command) == argv + (
        ["--device", "3"] if command == "server" else [])


def test_deployment_args_parse():
    for argv in (["server", "--in-cluster", "--enable-leader-election"],
                 ["webhooks"]):
        assert parsed(port_cli, argv) == parsed(ref_cli, argv)


def server_args(*extra, watch_dir=None):
    argv = ["server", "--device", "cpu", "--ext-auth-grpc-port",
            str(free_port()), "--ext-auth-http-port", str(free_port()),
            "--oidc-http-port", str(free_port()), "--drain-timeout", "5"]
    if watch_dir is not None:
        argv += ["--watch-dir", str(watch_dir)]
    return port_cli.build_parser().parse_args(argv + list(extra))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def listening(port: int) -> bool:
    """Whether a listener holds ``port`` (a closed server's connections in
    TIME_WAIT do not count)."""
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind(("0.0.0.0", port))
        except OSError:
            return True
    return False


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(asyncio.wait_for(coro, 120))
    finally:
        loop.close()


@pytest.mark.parametrize("dest", sorted(port_cli.UNPORTED_FLAGS))
def test_an_unported_planes_flag_stops_the_start(dest):
    inert, plane = port_cli.UNPORTED_FLAGS[dest]
    flag = "--" + dest.replace("_", "-")
    extra = ([flag] if isinstance(inert, bool)
             else [flag, "ns/a=2"] if isinstance(inert, list)
             else [flag, "/x" if isinstance(inert, str) else "9"])
    args = server_args(*extra)
    with pytest.raises(SystemExit, match=re.escape(flag)) as e:
        run(port_cli.run_server(args))
    assert "ROADMAP.md queue 1 item" in str(e.value)


class _Built(Exception):
    """Raised by an engine-construction hook to stop a start right there."""


# each change-safety flag, a value other than its default, and the engine
# attribute that holds it
CHANGE_SAFETY_FLAGS = {
    "--canary-fraction": ("1.7", lambda e: e.canary_fraction),
    "--canary-window": ("4.5", lambda e: e.canary_window_s),
    "--snapshot-history": ("2", lambda e: e._history.maxlen),
}


@pytest.mark.parametrize("flag", sorted(CHANGE_SAFETY_FLAGS))
def test_a_change_safety_flag_reaches_the_engine(flag, monkeypatch):
    """``--canary-fraction``, ``--canary-window`` and
    ``--snapshot-history`` are in the port: each reaches the engine with
    the value the reference's CLI gives the reference's engine (the
    fraction clamped to 1.0 by both)."""
    import authorino_tpu.runtime.engine as ref_engine_mod

    value, read = CHANGE_SAFETY_FLAGS[flag]
    port_cli.refuse_unported(server_args(flag, value))

    def stop(engine):
        raise _Built(engine)

    with pytest.raises(_Built) as got:
        run(port_cli.run_server(server_args(flag, value), on_engine=stop))

    ref_kwargs = {}
    real = ref_engine_mod.PolicyEngine

    def capture(**kw):
        ref_kwargs.update(kw)
        raise _Built()

    monkeypatch.setattr(ref_engine_mod, "PolicyEngine", capture)
    ref_args = ref_cli.build_parser().parse_args(
        ["server", "--jax-platform", "cpu", flag, value])
    with pytest.raises(_Built):
        run(ref_cli.run_server(ref_args))
    monkeypatch.setattr(ref_engine_mod, "PolicyEngine", real)
    want = {k: ref_kwargs[k] for k in ("canary_fraction", "canary_window_s",
                                       "snapshot_history")}
    ref_engine = real(mesh=None, lane_select=False, **want)
    assert read(got.value.args[0]) == read(ref_engine)
    assert read(got.value.args[0]) != read(real(mesh=None,
                                                lane_select=False))


# each tenant QoS flag, a value other than its default, and where the
# engine's tenant plane holds it
TENANT_FLAGS = {
    "--no-tenant-qos": (None, lambda e: e.tenancy.enabled),
    "--tenant-weight": ("ns/a=2", lambda e: e.tenancy.book.overrides),
    "--tenant-default-weight": ("2.5",
                                lambda e: e.tenancy.book.default_weight),
    "--tenant-quota-rps": ("40", lambda e: e.tenancy.book.default_quota_rps),
    "--tenant-contain-threshold": ("4.5",
                                   lambda e: e.tenancy.detector.threshold),
    "--tenant-top-k": ("8", lambda e: e.tenancy.stats.top_k),
}


@pytest.mark.parametrize("flag", sorted(TENANT_FLAGS))
def test_a_tenant_flag_reaches_the_engine(flag, monkeypatch):
    """The tenant QoS plane is in the port: each of its flags is accepted
    and reaches the engine's plane with the value the reference's CLI
    gives the reference's engine (and one that differs from the
    default)."""
    import authorino_tpu.runtime.engine as ref_engine_mod

    assert "tenancy" not in port_cli.UNPORTED_PLANES
    value, read = TENANT_FLAGS[flag]
    extra = [flag] if value is None else [flag, value]
    port_cli.refuse_unported(server_args(*extra))

    def stop(engine):
        raise _Built(engine)

    with pytest.raises(_Built) as got:
        run(port_cli.run_server(server_args(*extra), on_engine=stop))

    ref_kwargs = {}
    real = ref_engine_mod.PolicyEngine

    def capture(**kw):
        ref_kwargs.update(kw)
        raise _Built()

    monkeypatch.setattr(ref_engine_mod, "PolicyEngine", capture)
    ref_args = ref_cli.build_parser().parse_args(
        ["server", "--jax-platform", "cpu", *extra])
    with pytest.raises(_Built):
        run(ref_cli.run_server(ref_args))
    monkeypatch.setattr(ref_engine_mod, "PolicyEngine", real)
    want = {k: v for k, v in ref_kwargs.items() if k.startswith("tenant_")}
    assert set(want) == {"tenant_qos", "tenant_default_weight",
                         "tenant_weights", "tenant_quota_rps",
                         "tenant_contain_threshold", "tenant_top_k"}
    ref_engine = real(mesh=None, lane_select=False, **want)
    assert read(got.value.args[0]) == read(ref_engine)
    assert read(got.value.args[0]) != read(real(mesh=None,
                                                lane_select=False))


# each flag of the reconcile's verification, traffic capture, the replay
# pregate and the metadata prefetch cache, a value other than its default,
# and where the port holds it (the engine, or the process-wide capture log)
def _capture_view(cap):
    return (cap.enabled, cap.directory, cap.size_bytes, cap.sample_n)


VERIFY_REPLAY_FLAGS = {
    "--strict-verify": (None, lambda e, c: e.strict_verify),
    "--replay-pregate": (None, lambda e, c: e.replay_pregate),
    "--replay-pregate-budget-ms": ("350", lambda e, c:
                                   e.replay_pregate_budget_s),
    "--no-metadata-prefetch": (None, lambda e, c: e.metadata_prefetcher),
    "--metadata-max-age": ("12", lambda e, c:
                           e.metadata_prefetcher.max_age_s),
    "--metadata-refresh": ("7", lambda e, c:
                           e.metadata_prefetcher.refresh_s),
    "--capture": (None, lambda e, c: _capture_view(c)),
    "--capture-log-dir": ("DIR", lambda e, c: _capture_view(c)),
    "--capture-log-size-mb": ("3", lambda e, c: _capture_view(c)),
    "--capture-sample": ("5", lambda e, c: _capture_view(c)),
}


@pytest.mark.parametrize("flag", sorted(VERIFY_REPLAY_FLAGS))
def test_a_verify_capture_or_prefetch_flag_reaches_the_port(flag, tmp_path,
                                                            monkeypatch):
    """Strict verify, capture, the replay pregate and the metadata
    prefetch cache are in the port: each flag is accepted and lands where
    the reference's CLI puts it, with the reference's value (one that
    differs from the default)."""
    import authorino_tpu.runtime.engine as ref_engine_mod
    from authorino_tpu.replay.capture import CAPTURE as REF_CAPTURE
    from authorino_tpu_torch.replay.capture import CAPTURE as PORT_CAPTURE

    value, read = VERIFY_REPLAY_FLAGS[flag]
    if value == "DIR":
        value = str(tmp_path / "cap")
    extra = [flag] if value is None else [flag, value]
    if flag.startswith("--capture-log-size") or flag == "--capture-sample":
        extra = ["--capture"] + extra
    port_cli.refuse_unported(server_args(*extra))

    def stop(engine):
        raise _Built(engine)

    try:
        with pytest.raises(_Built) as got:
            run(port_cli.run_server(server_args(*extra), on_engine=stop))
        ref_kwargs = {}
        real = ref_engine_mod.PolicyEngine

        def capture(**kw):
            ref_kwargs.update(kw)
            raise _Built()

        monkeypatch.setattr(ref_engine_mod, "PolicyEngine", capture)
        ref_args = ref_cli.build_parser().parse_args(
            ["server", "--jax-platform", "cpu", *extra])
        with pytest.raises(_Built):
            run(ref_cli.run_server(ref_args))
        monkeypatch.setattr(ref_engine_mod, "PolicyEngine", real)
        keys = ("strict_verify", "replay_pregate", "replay_pregate_budget_s",
                "metadata_prefetch", "metadata_prefetch_max_age_s",
                "metadata_prefetch_refresh_s")
        ref_engine = real(mesh=None, lane_select=False,
                          **{k: ref_kwargs[k] for k in keys})
        default = real(mesh=None, lane_select=False)
        port_read = read(got.value.args[0], PORT_CAPTURE)
        ref_read = read(ref_engine, REF_CAPTURE)
        if flag == "--no-metadata-prefetch":
            port_read, ref_read = port_read is None, ref_read is None
            assert port_read is True
        assert port_read == ref_read
        if not flag.startswith("--capture"):
            assert read(got.value.args[0], PORT_CAPTURE) != read(
                default, REF_CAPTURE)
        else:
            assert PORT_CAPTURE.enabled is True
    finally:
        for cap in (PORT_CAPTURE, REF_CAPTURE):
            cap.configure(enabled=False, size_mb=64.0, sample_n=1)
            cap.directory = None
            cap.clear()


# the planes a start wires after its engine and before its control plane:
# snapshot distribution, the durable state plane and the corpus pregate

def _state_start(pkg_cli, pkg, argv, monkeypatch):
    """Run ``pkg``'s ``run_server`` on ``argv`` until its control plane
    would start (the reconciler's construction stops it), recording every
    publisher, replica and state plane the start made.  Returns what the
    start raised and the recorded view."""
    import importlib

    dist = importlib.import_module(f"{pkg}.snapshots.distribution")
    plane_mod = importlib.import_module(f"{pkg}.runtime.state_plane")
    rec_mod = importlib.import_module(f"{pkg}.controllers.reconciler")
    made = {"publishers": [], "replicas": [], "planes": []}

    def recording(cls, key):
        class Recorded(cls):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made[key].append(self)
        return Recorded

    monkeypatch.setattr(dist, "SnapshotPublisher",
                        recording(dist.SnapshotPublisher, "publishers"))
    monkeypatch.setattr(dist, "SnapshotReplica",
                        recording(dist.SnapshotReplica, "replicas"))
    monkeypatch.setattr(plane_mod, "StatePlane",
                        recording(plane_mod.StatePlane, "planes"))

    def stop(engine, *a, **kw):
        raise _Built(engine)

    monkeypatch.setattr(rec_mod, "AuthConfigReconciler", stop)
    try:
        run(pkg_cli.run_server(pkg_cli.build_parser().parse_args(argv)))
    except _Built as b:
        engine = b.args[0]
        raised = None
    except RuntimeError as e:
        engine, raised = None, str(e)
    finally:
        for r in made["replicas"]:
            r.stop(timeout_s=2.0)
        for pl in made["planes"]:
            pl._stop.set()
        monkeypatch.undo()
    if engine is None:
        return raised, None
    # the state plane's own publisher (include_loaded) is the plane's
    return None, {
        "strict_verify": engine.strict_verify,
        "corpus_pregate": (engine.corpus_pregate,
                           engine.corpus_pregate_budget_s),
        "publishers": sorted((p.directory, p.keep, p.include_loaded)
                             for p in made["publishers"]),
        # the first poll ran before the start went on (the source holds
        # no manifest: an error); the poll thread's own may have too
        "replicas": [(r.source, r.poll_s, r.applied, r.errors >= 1)
                     for r in made["replicas"]],
        "planes": [(pl.state_dir, pl.max_snapshot_age_s, pl.hotset_k,
                    pl.hotset_s, pl.warm_summary,
                    engine.state_plane is pl) for pl in made["planes"]],
    }


STATE_FLAGS = {
    "--corpus-pregate": ["--corpus-pregate", "{d}/c.atpucorp"],
    "--corpus-pregate-budget-ms": ["--corpus-pregate", "{d}/c.atpucorp",
                                   "--corpus-pregate-budget-ms", "350"],
    "--snapshot-publish-dir": ["--snapshot-publish-dir", "{d}/pub"],
    "--snapshot-source": ["--snapshot-source", "{d}/src"],
    "--snapshot-poll": ["--snapshot-source", "{d}/src",
                        "--snapshot-poll", "0.7"],
    "--state-dir": ["--state-dir", "{d}/state"],
    "--max-snapshot-age": ["--state-dir", "{d}/state",
                           "--max-snapshot-age", "90"],
    "--fleet-hotset-k": ["--state-dir", "{d}/state", "--fleet-hotset-k",
                         "64"],
    "--fleet-hotset-s": ["--state-dir", "{d}/state", "--fleet-hotset-s",
                         "7"],
    "--fleet-hotset-k=0": ["--snapshot-publish-dir", "{d}/pub",
                           "--fleet-hotset-k", "0"],
    "--strict-verify": ["--snapshot-publish-dir", "{d}/pub",
                        "--strict-verify"],
}


@pytest.mark.parametrize("case", sorted(STATE_FLAGS))
def test_a_state_plane_flag_reaches_the_port(case, tmp_path, monkeypatch):
    """Snapshot distribution, the state plane and the corpus pregate are
    in the port: each flag lands where the reference's CLI puts it (the
    engine, the publisher, the replica, the state plane), with the
    reference's values, and the publish and state directories imply
    ``--strict-verify`` as in the reference."""
    assert not {"state plane", "snapshot distribution",
                "corpus pregate"} & set(port_cli.UNPORTED_PLANES)
    assert "fleet" not in port_cli.UNPORTED_PLANES
    extra = [a.format(d=tmp_path) for a in STATE_FLAGS[case]]
    for sub in ("src",):
        (tmp_path / sub).mkdir(exist_ok=True)
    port_cli.refuse_unported(server_args(*extra))
    got = _state_start(port_cli, "authorino_tpu_torch",
                       ["server", "--device", "cpu", *extra], monkeypatch)
    want = _state_start(ref_cli, "authorino_tpu",
                        ["server", "--jax-platform", "cpu", *extra],
                        monkeypatch)
    assert got == want
    view = got[1]
    assert view is not None
    if "--snapshot-publish-dir" in extra or "--state-dir" in extra:
        assert view["strict_verify"] is True


LOOP_BREAKERS = {
    "publish-is-source": ("--snapshot-publish-dir", "--snapshot-source"),
    "state-is-source": ("--state-dir", "--snapshot-source"),
    "state-is-publish": ("--state-dir", "--snapshot-publish-dir"),
}


@pytest.mark.parametrize("case", sorted(LOOP_BREAKERS))
def test_a_loop_breaker_refuses_the_start(case, tmp_path, monkeypatch):
    """A node is a compile leader or a serving replica, never its own
    upstream, and its state dir is never a distribution feed: the port
    refuses each such start with the reference's message."""
    a, b = LOOP_BREAKERS[case]
    d = str(tmp_path / "same")
    got = _state_start(port_cli, "authorino_tpu_torch",
                       ["server", "--device", "cpu", a, d, b, d],
                       monkeypatch)
    want = _state_start(ref_cli, "authorino_tpu",
                        ["server", "--jax-platform", "cpu", a, d, b, d],
                        monkeypatch)
    assert got == want
    assert got[1] is None and "point at the same directory" in got[0]


def test_malformed_tenant_weights_are_skipped_as_the_reference_does():
    pairs = ["ns/a=2", "junk", "=3", "ns/b=x", "ns/c=0.5", "ns/d==4"]
    assert port_cli._parse_tenant_weights(pairs) == \
        ref_cli._parse_tenant_weights(pairs) == \
        {"ns/a": 2.0, "ns/c": 0.5, "ns/d=": 4.0}


@pytest.mark.parametrize("flag,value", [("--slo-ms", "250"),
                                        ("--flight-dir", "/x"),
                                        ("--flight-keep", "3")])
def test_an_observability_flag_is_accepted(flag, value):
    """The SLO tracker and the flight recorder are in the port: their
    flags no longer stop the start."""
    port_cli.refuse_unported(server_args(flag, value))


@pytest.mark.parametrize("flag,value", [("--breaker-threshold", "3"),
                                        ("--breaker-reset", "0.5"),
                                        ("--fault-profile", "device-down")])
def test_a_failure_handling_flag_is_accepted(flag, value):
    """The breaker and the fault plane are in the port: their flags no
    longer stop the start."""
    port_cli.refuse_unported(server_args(flag, value))


def test_fault_profile_arms_the_ports_plane_and_the_breaker_opens(tmp_path):
    """``--fault-profile device-down --breaker-threshold 1``: the port's
    plane is armed (the reference's is not), every gRPC Check() still
    answers the oracle's code through the host-oracle degrade, /readyz
    reports the open circuit and stays 200, and /debug/vars carries the
    breaker and the armed plane."""
    from authorino_tpu.runtime import faults as ref_faults
    from authorino_tpu_torch.runtime import faults as port_faults

    n = 4
    write_manifests(tmp_path, n)
    args = server_args("--fault-profile", "device-down",
                       "--breaker-threshold", "1", "--breaker-reset", "60",
                       watch_dir=tmp_path)
    reqs, cfgs, known = cp.build_check_requests(24, n)
    rules = cp.config_rules(n, 3)

    async def body():
        task = asyncio.ensure_future(port_cli.run_server(args))
        t0 = time.monotonic()
        while (await asyncio.to_thread(http_get_or_none,
                                       args.ext_auth_http_port,
                                       "/readyz"))[0] != 200:
            assert not task.done(), task
            assert time.monotonic() - t0 < 60
            await asyncio.sleep(0.05)
        armed = (port_faults.ACTIVE, ref_faults.ACTIVE)
        async with grpc.aio.insecure_channel(
                f"127.0.0.1:{args.ext_auth_grpc_port}") as ch:
            call = ch.unary_unary(CHECK, request_serializer=lambda b: b,
                                  response_deserializer=lambda b: b)
            got = [pb.CheckResponse.FromString(r) for r in
                   await asyncio.gather(*(call(wire_request(q))
                                          for q in reqs))]
        out = [await asyncio.to_thread(http_get, args.ext_auth_http_port, p)
               for p in ("/readyz", "/debug/vars")]
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        return armed, got, out

    try:
        armed, got, ((s_ready, ready), (s_vars, dv)) = run(body())
    finally:
        port_faults.FAULTS.disarm()
    assert armed == (True, False)
    assert [g.status.code for g in got] == [
        cp.expected_code(q, i, rules, good)
        for q, i, good in zip(reqs, cfgs, known)]
    assert (s_ready, ready) == (200,
                                "ok (degraded: engine device circuit open)")
    eng = json.loads(dv)["engine"]
    assert eng["breaker"]["state"] == "open"
    assert eng["breaker"]["threshold"] == 1
    assert eng["breaker"]["reset_s"] == 60.0
    assert eng["faults"]["armed"] and eng["faults"]["rules"] == ["kernel:raise"]
    # batches admitted before the first failure opened the breaker each
    # met the fault; none after it did
    assert set(eng["faults"]["fired"]) == {"kernel:raise:engine"}
    assert eng["faults"]["fired"]["kernel:raise:engine"] >= 1


# every family the observability planes export (the reference's names)
PLANE_FAMILIES = (
    "auth_server_batch_size", "auth_server_batch_pad_occupancy",
    "auth_server_batch_queue_wait_seconds",
    "auth_server_device_dispatch_seconds", "auth_server_batch_host_fallback",
    "auth_server_pipeline_stage_seconds",
    "auth_server_reconcile_phase_seconds", "auth_server_snapshot_generation",
    "auth_server_kernel_launches_total", "auth_server_kernel_h2d_bytes_total",
    "auth_server_kernel_d2h_bytes_total",
    "auth_server_kernel_pad_waste_rows_total",
    "auth_server_kernel_modeled_flops_per_row", "auth_server_slo_burn_rate",
    "auth_server_slo_bad_total", "auth_server_slo_observed_total",
    "auth_server_flight_recorder_events_total",
    "auth_server_flight_recorder_dumps_total",
    "auth_server_state_write_failures_total")


def test_run_server_serves_the_observability_planes(tmp_path):
    """``--slo-ms``, ``--flight-dir`` and ``--flight-keep`` reach the
    engine and the recorder: /debug/vars carries the slo, flight_recorder,
    kernel_cost and control_plane sections, and /metrics every family of
    the planes."""
    from authorino_tpu_torch.runtime.flight_recorder import RECORDER

    manifests = tmp_path / "manifests"
    manifests.mkdir()
    write_manifests(manifests)
    flight = tmp_path / "flight"
    args = server_args("--slo-ms", "250", "--flight-dir", str(flight),
                       "--flight-keep", "3", watch_dir=manifests)
    reqs, _, _ = cp.build_check_requests(12, 4)
    saved = (RECORDER.dump_dir, RECORDER.keep)

    async def body():
        task = asyncio.ensure_future(port_cli.run_server(args))
        t0 = time.monotonic()
        while (await asyncio.to_thread(http_get_or_none,
                                       args.ext_auth_http_port,
                                       "/readyz"))[0] != 200:
            assert not task.done(), task
            assert time.monotonic() - t0 < 60
            await asyncio.sleep(0.05)
        for q in reqs:
            await asyncio.to_thread(http_get, args.ext_auth_http_port,
                                    q.http.path,
                                    dict(q.http.headers, Host=q.http.host))
        out = [await asyncio.to_thread(http_get, args.ext_auth_http_port, p)
               for p in ("/debug/vars", "/metrics")]
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        return out

    try:
        (s_vars, dv), (s_metrics, text) = run(body())
    finally:
        RECORDER.configure(dump_dir=saved[0], keep=saved[1])
    assert (s_vars, s_metrics) == (200, 200)
    eng = json.loads(dv)["engine"]
    assert eng["slo"]["slo_ms"] == 250.0
    assert eng["slo"]["observed_total"] == len(reqs)
    fr = eng["flight_recorder"]
    assert (fr["dump_dir"], fr["keep"]) == (str(flight), 3)
    assert {e["kind"] for e in fr["tail"]} >= {"snapshot-swap", "reconcile"}
    assert eng["kernel_cost"]["ledger"]["engine"]["rows"] >= len(reqs)
    assert eng["kernel_cost"]["entry_points"][-1]["entry"] == "fused_kernel"
    # the manifest source's first poll re-reads the directory: a swap of
    # the same corpus reuses the installed policy and params (no diff or
    # upload phase); the cold install has all three phases
    cpb = eng["control_plane"]
    assert set(cpb["phases_ms"]) == ({"compile"}
                                     if cpb["compile"]["reused_policy"]
                                     else {"compile", "diff", "upload"})
    assert (cpb["upload"]["mode"] == "reuse") == cpb["compile"]["reused_policy"]
    typed = {ln.split()[2] for ln in text.splitlines()
             if ln.startswith("# TYPE ")}
    for fam in PLANE_FAMILIES:
        assert {fam, fam.removesuffix("_total")} & typed, fam


def test_other_refusals_and_off_switches():
    # every kernel lane is served; an unported plane's flag still refuses
    port_cli.refuse_unported(server_args("--kernel-lane", "matmul"))
    with pytest.raises(SystemExit, match="--lane-host-max-rows"):
        run(port_cli.run_server(server_args("--lane-host-max-rows", "8")))
    # the native frontend does not terminate TLS: 'on' refuses TLS flags
    # before anything binds
    args = server_args("--native-frontend", "on", "--tls-cert", "/x.crt",
                       "--tls-cert-key", "/x.key")
    with pytest.raises(RuntimeError, match="native-frontend=on is "
                                           "incompatible with --tls-cert"):
        run(port_cli.run_server(args))
    assert not listening(args.ext_auth_http_port)
    # flags that only turn a plane off are accepted
    port_cli.refuse_unported(server_args(
        "--no-brownout", "--no-lane-select", "--no-speculative-dispatch",
        "--no-tenant-qos", "--no-flight-recorder", "--no-metadata-prefetch",
        "--kernel-lane", "fused"))


def test_without_a_card_the_start_raises_before_binding():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device exists")
    args = port_cli.build_parser().parse_args(
        ["server", "--ext-auth-http-port", str(free_port())])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        run(port_cli.run_server(args))
    assert not listening(args.ext_auth_http_port)


def write_manifests(d, n=4):
    docs = cp.build_auth_configs(n, 3) + [cp.api_key_secret(i)
                                          for i in range(n)]
    for k, doc in enumerate(docs):
        (d / f"{k}.json").write_text(json.dumps(doc))


def wire_request(model) -> bytes:
    return wire.encode_check_request(port_grpc.request_proto_from_model(model))


def http_get(port, path, headers=None, timeout=10):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def reference_answers(d, reqs):
    """The reference's gRPC CheckResponses and HTTP statuses for ``reqs``
    over the same manifests (its reconciler, source, servers)."""
    from aiohttp.test_utils import TestClient, TestServer

    from authorino_tpu.controllers.reconciler import (AuthConfigReconciler,
                                                      SecretReconciler)
    from authorino_tpu.controllers.sources import YamlDirSource
    from authorino_tpu.k8s.client import InMemoryCluster
    from authorino_tpu.runtime import PolicyEngine
    from authorino_tpu.service.grpc_server import build_server
    from authorino_tpu.service.http_server import build_app

    async def body():
        engine = PolicyEngine(max_batch=16, mesh=None, lane_select=False,
                              kernel_lane="fused")
        cluster = InMemoryCluster()
        await YamlDirSource(str(d), AuthConfigReconciler(engine, cluster=cluster),
                            cluster, SecretReconciler(engine)).sync()
        server = build_server(engine, address="127.0.0.1:0")
        await server.start()
        try:
            async with grpc.aio.insecure_channel(
                    f"127.0.0.1:{server.bound_port}") as ch:
                call = ch.unary_unary(CHECK, request_serializer=lambda b: b,
                                      response_deserializer=lambda b: b)
                got = [pb.CheckResponse.FromString(r) for r in
                       await asyncio.gather(*(call(wire_request(q))
                                              for q in reqs))]
        finally:
            await server.stop(None)
        async with TestClient(TestServer(build_app(engine))) as client:
            http = []
            for q in reqs:
                r = await client.get(q.http.path, headers=dict(
                    q.http.headers, Host=q.http.host))
                http.append((r.status, await r.text()))
        return got, http

    return run(body())


def test_run_server_answers_as_the_reference_then_drains_on_cancel(tmp_path):
    n = 4
    write_manifests(tmp_path, n)
    args = server_args(watch_dir=tmp_path)
    reqs, cfgs, known = cp.build_check_requests(24, n)
    rules = cp.config_rules(n, 3)

    async def body():
        task = asyncio.ensure_future(port_cli.run_server(args))
        t0 = time.monotonic()
        while True:   # ready: the listeners bind after the first sync
            status, _ = await asyncio.to_thread(
                http_get_or_none, args.ext_auth_http_port, "/readyz")
            if status == 200:
                break
            assert not task.done(), task
            assert time.monotonic() - t0 < 60
            await asyncio.sleep(0.05)
        async with grpc.aio.insecure_channel(
                f"127.0.0.1:{args.ext_auth_grpc_port}") as ch:
            call = ch.unary_unary(CHECK, request_serializer=lambda b: b,
                                  response_deserializer=lambda b: b)
            got = [pb.CheckResponse.FromString(r) for r in
                   await asyncio.gather(*(call(wire_request(q))
                                          for q in reqs))]
        # over HTTP the claims of metadata_context are absent, as for the
        # reference's adapter
        http = [await asyncio.to_thread(
            http_get, args.ext_auth_http_port, q.http.path,
            dict(q.http.headers, Host=q.http.host)) for q in reqs]
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        return got, http

    got, http = run(body())
    want, want_http = reference_answers(tmp_path, reqs)
    assert got == want
    assert [g.status.code for g in got] == [
        cp.expected_code(q, i, rules, good)
        for q, i, good in zip(reqs, cfgs, known)]
    assert http == want_http
    assert {s for s, _ in http} >= {401, 403}
    for port in (args.ext_auth_http_port, args.ext_auth_grpc_port,
                 args.oidc_http_port):
        assert not listening(port)


def http_get_or_none(port, path):
    try:
        return http_get(port, path, timeout=2)
    except OSError:
        return None, ""


def test_version_runs_as_a_module():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-m", "authorino_tpu_torch",
                          "version"], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "0.1.0"


def test_server_subprocess_drains_on_sigterm(tmp_path):
    """64 Check()s in flight (each past its verdict, in a callback to a
    slow endpoint) when SIGTERM arrives: every one is answered with its
    verdict and the process exits 0 within ``--drain-timeout``."""
    write_manifests(tmp_path)
    ports = [free_port() for _ in range(3)]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    with cp.SlowEndpoint(0.3) as slow:
        (tmp_path / "callback.json").write_text(
            json.dumps(cp.callback_auth_config(slow.url + "/done")))
        proc = subprocess.Popen(
            [sys.executable, "-m", "authorino_tpu_torch", "server",
             "--device", "cpu", "--watch-dir", str(tmp_path),
             "--ext-auth-grpc-port", str(ports[0]), "--ext-auth-http-port",
             str(ports[1]), "--oidc-http-port", str(ports[2]),
             "--drain-timeout", "5"],
            cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        try:
            t0 = time.monotonic()
            while http_get_or_none(ports[1], "/readyz")[0] != 200:
                assert proc.poll() is None, proc.stdout.read()
                assert time.monotonic() - t0 < 90
                time.sleep(0.1)
            req = wire.CheckRequest(attributes=wire.AttributeContext(
                request=wire.Request(http=wire.HttpRequest(
                    method="GET", path="/", host=cp.CALLBACK_HOST))))
            payload = wire.encode_check_request(req)

            async def in_flight():
                async with grpc.aio.insecure_channel(
                        f"127.0.0.1:{ports[0]}") as ch:
                    call = ch.unary_unary(CHECK,
                                          request_serializer=lambda b: b,
                                          response_deserializer=lambda b: b)
                    futs = [asyncio.ensure_future(call(payload))
                            for _ in range(64)]
                    while slow.hits < 8:
                        await asyncio.sleep(0.01)
                    await asyncio.sleep(0.1)
                    proc.send_signal(signal.SIGTERM)
                    t_term = time.monotonic()
                    answers = await asyncio.gather(*futs,
                                                   return_exceptions=True)
                    return answers, t_term, slow.hits

            answers, t_term, hits_at_end = run(in_flight())
            rc = proc.wait(timeout=30)
            took = time.monotonic() - t_term
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    log = proc.stdout.read()
    assert rc == 0, log
    assert took < 5 + 5, (took, log)
    assert "drain complete" in log and "policy engine on cpu" in log
    assert [pb.CheckResponse.FromString(a).status.code if isinstance(
        a, bytes) else a for a in answers] == [0] * 64
    assert hits_at_end == 64


def test_run_server_serves_tls_from_its_flags(tmp_path):
    """--tls-cert/--tls-cert-key put both ext_authz listeners on TLS
    (certificates from the port's own writer): a gRPC Check() over a
    secure channel and an HTTPS /readyz answer."""
    import datetime
    import random
    import ssl

    from authorino_tpu_torch.utils import pki

    key = pki.generate_ec_private_key(pki.P256, random.Random(8))
    name = [[(cp.OID["CN"], "localhost")]]
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = cp.pem(cp.make_certificate(
        name, name, key.public_key(), key,
        now - datetime.timedelta(minutes=1), now + datetime.timedelta(hours=1),
        dns_names=["localhost"]))
    (tmp_path / "tls.crt").write_bytes(cert)
    (tmp_path / "tls.key").write_bytes(pki.private_key_to_pem(key))
    manifests = tmp_path / "m"
    manifests.mkdir()
    write_manifests(manifests, 2)
    args = server_args("--tls-cert", str(tmp_path / "tls.crt"),
                       "--tls-cert-key", str(tmp_path / "tls.key"),
                       watch_dir=manifests)
    reqs, cfgs, known = cp.build_check_requests(4, 2)
    rules = cp.config_rules(2, 3)
    ctx = ssl.create_default_context(cadata=cert.decode())
    ctx.check_hostname = False

    def https_ready():
        try:
            with urllib.request.urlopen(
                    f"https://127.0.0.1:{args.ext_auth_http_port}/readyz",
                    context=ctx, timeout=2) as r:
                return r.status
        except OSError:
            return None

    async def body():
        task = asyncio.ensure_future(port_cli.run_server(args))
        t0 = time.monotonic()
        while await asyncio.to_thread(https_ready) != 200:
            assert not task.done(), task
            assert time.monotonic() - t0 < 60
            await asyncio.sleep(0.05)
        creds = grpc.ssl_channel_credentials(root_certificates=cert)
        async with grpc.aio.secure_channel(
                f"localhost:{args.ext_auth_grpc_port}", creds) as ch:
            call = ch.unary_unary(CHECK, request_serializer=lambda b: b,
                                  response_deserializer=lambda b: b)
            got = [pb.CheckResponse.FromString(await call(wire_request(q)))
                   .status.code for q in reqs]
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        return got

    assert run(body()) == [cp.expected_code(q, i, rules, good)
                           for q, i, good in zip(reqs, cfgs, known)]


def serve_and_scrape(args, reqs, in_process=()):
    """Run ``run_server(args)`` until ready, send ``reqs`` over gRPC, read
    /debug/vars, cancel; returns (CheckResponses, debug vars, the codes of
    the server's own engine.check() for the models ``in_process``)."""
    engines = []

    async def body():
        task = asyncio.ensure_future(port_cli.run_server(
            args, on_engine=engines.append))
        t0 = time.monotonic()
        while (await asyncio.to_thread(http_get_or_none,
                                       args.ext_auth_http_port,
                                       "/readyz"))[0] != 200:
            assert not task.done(), task
            assert time.monotonic() - t0 < 60
            await asyncio.sleep(0.05)
        async with grpc.aio.insecure_channel(
                f"127.0.0.1:{args.ext_auth_grpc_port}") as ch:
            call = ch.unary_unary(CHECK, request_serializer=lambda b: b,
                                  response_deserializer=lambda b: b)
            got = [pb.CheckResponse.FromString(r) for r in
                   await asyncio.gather(*(call(wire_request(q))
                                          for q in reqs))]
        _, dv = await asyncio.to_thread(http_get, args.ext_auth_http_port,
                                        "/debug/vars")
        own = [(await engines[0].check(m)).code for m in in_process]
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        return got, json.loads(dv), own

    return run(body())


def test_native_frontend_on_serves_through_the_frontend(tmp_path):
    """``--native-frontend on``: gRPC Check()s are answered by the native
    frontend (its counters move: the control-plane corpus's API-key
    configs take request-dependent identity overrides and ride the slow
    lane, anonymous pattern configs the fast lane), every code equals the
    oracle's or the server's own ``engine.check()``'s, /debug/vars carries
    the frontend, and the listeners close on cancellation."""
    from authorino_tpu_torch.authjson import (CheckRequestModel,
                                              HttpRequestAttributes)

    n = 4
    write_manifests(tmp_path, n)
    for i in range(6):
        (tmp_path / f"anon-{i}.json").write_text(json.dumps({
            "apiVersion": "authorino.kuadrant.io/v1beta2",
            "kind": "AuthConfig",
            "metadata": {"name": f"anon-{i}", "namespace": "wire"},
            "spec": {"hosts": [f"svc-{i}.wire"],
                     "authentication": {"anon": {"anonymous": {}}},
                     "authorization": {"r": {"patternMatching": {
                         "patterns": [{"selector": "request.headers.x-tier",
                                       "operator": "eq",
                                       "value": f"tier-{i}"}]}}}}}))
    args = server_args("--native-frontend", "on", watch_dir=tmp_path)
    reqs, cfgs, known = cp.build_check_requests(24, n)
    ns_reqs = [CheckRequestModel(http=HttpRequestAttributes(
        method="GET", path="/", host=f"svc-{k % 6}.wire",
        headers={"x-tier": f"tier-{k % 6}" if k % 3 else "none"}))
        for k in range(32)]
    rules = cp.config_rules(n, 3)
    got, dv, own = serve_and_scrape(args, reqs + ns_reqs, ns_reqs)
    assert [g.status.code for g in got[:len(reqs)]] == [
        cp.expected_code(q, i, rules, good)
        for q, i, good in zip(reqs, cfgs, known)]
    assert [g.status.code for g in got[len(reqs):]] == own
    assert set(own) == {0, 7}
    fe = dv["native_frontend"]
    assert fe["enabled"] and fe["port"] == args.ext_auth_grpc_port
    assert fe["nghttp2"] and fe["device"] == "cpu"
    st = fe["stats"]
    assert (st["fast"], st["slow"]) == (len(ns_reqs), len(reqs))
    for port in (args.ext_auth_http_port, args.ext_auth_grpc_port):
        assert not listening(port)


@pytest.mark.parametrize("mode", ["on", "auto"])
def test_native_frontend_without_its_library(tmp_path, monkeypatch, caplog,
                                             mode):
    """Without libnghttp2 (the loader finds none: monkeypatched), 'on'
    raises naming the library and 'auto' serves grpc.aio with one WARNING
    naming why, /debug/vars reporting the frontend disabled with that
    reason."""
    import logging

    from authorino_tpu_torch import native

    real = native.load_library

    class NoNghttp2:
        def __init__(self, mod):
            self._mod = mod

        def __getattr__(self, name):
            return getattr(self._mod, name)

        def fe_nghttp2_path(self):
            return ""

    monkeypatch.setattr(native, "load_library", lambda: NoNghttp2(real()))
    write_manifests(tmp_path, 2)
    args = server_args("--native-frontend", mode, watch_dir=tmp_path)
    if mode == "on":
        with pytest.raises(RuntimeError, match="libnghttp2"):
            run(port_cli.run_server(args))
        assert not listening(args.ext_auth_grpc_port)
        return
    reqs, cfgs, known = cp.build_check_requests(4, 2)
    rules = cp.config_rules(2, 3)
    with caplog.at_level(logging.WARNING, logger="authorino_tpu"):
        got, dv, _ = serve_and_scrape(args, reqs)
    assert [g.status.code for g in got] == [
        cp.expected_code(q, i, rules, good)
        for q, i, good in zip(reqs, cfgs, known)]
    fe = dv["native_frontend"]
    assert fe["enabled"] is False and "libnghttp2" in fe["reason"]
    warned = [r.getMessage() for r in caplog.records
              if r.levelno == logging.WARNING and "native frontend" in
              r.getMessage()]
    assert len(warned) == 1 and "using grpc.aio" in warned[0]
    assert "libnghttp2" in warned[0]


def test_native_frontend_off_serves_grpc_aio(tmp_path):
    """``--native-frontend off`` serves grpc.aio with no warning and
    /debug/vars names the switch."""
    write_manifests(tmp_path, 2)
    args = server_args("--native-frontend", "off", watch_dir=tmp_path)
    reqs, cfgs, known = cp.build_check_requests(4, 2)
    rules = cp.config_rules(2, 3)
    got, dv, _ = serve_and_scrape(args, reqs)
    assert [g.status.code for g in got] == [
        cp.expected_code(q, i, rules, good)
        for q, i, good in zip(reqs, cfgs, known)]
    assert dv["native_frontend"] == {"enabled": False,
                                     "reason": "--native-frontend off"}
