"""``chip_smoke.py`` phase 12's request sequence on the CPU, for the port or
the JAX package: does an in-process burst of ``engine.check()`` wait
behind the native frontend's slow lane after gRPC bursts?

    JAX_PLATFORMS=cpu python tests/torch_slow_lane_probe.py port 4096 1000
    JAX_PLATFORMS=cpu python tests/torch_slow_lane_probe.py ref 4096 1000

One package's CLI server (the native frontend at the CLI's defaults,
``--slo-ms 250``) over ``models/control_plane.py``'s API-key manifests
(``NCFG`` AuthConfigs and their Secrets); then, on the server's own loop:
two in-process bursts of the ``N`` requests (the control), the first gRPC
burst of them, an in-process burst, three timed gRPC bursts, two
in-process bursts.  Prints one ``RESULT`` JSON line with each burst's
checks/s and p50/p99.  Flight bundles go under the temporary directory.
Not a test: the numbers are host timings."""
import asyncio, json, os, socket, sys, tempfile, time, urllib.request
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import numpy as np

PKG, N, NCFG = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
import grpc
from authorino_tpu_torch.models import control_plane as cp
from authorino_tpu_torch.protos import wire
from authorino_tpu_torch.service.grpc_server import request_proto_from_model

def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0)); return s.getsockname()[1]

d = Path(tempfile.mkdtemp(prefix="backlog-"))
for i, ac in enumerate(cp.build_auth_configs(NCFG, 10)):
    (d / f"ac-{i:04d}.json").write_text(json.dumps(ac))
for i in range(NCFG):
    (d / f"key-{i:04d}.json").write_text(json.dumps(cp.api_key_secret(i)))
models, cfgs, known = cp.build_check_requests(N, NCFG)
payloads = [wire.encode_check_request(request_proto_from_model(q)) for q in models]
ports = {k: free_port() for k in ("grpc", "http", "oidc")}
argv = ["server", "--watch-dir", str(d), "--ext-auth-grpc-port", str(ports["grpc"]),
        "--ext-auth-http-port", str(ports["http"]), "--oidc-http-port", str(ports["oidc"]),
        "--slo-ms", "250", "--flight-dir", str(d / "flight")]
holder = {}
if PKG == "port":
    from authorino_tpu_torch import cli
    argv += ["--device", "cpu"]
    conv = lambda q: q
else:
    import authorino_tpu.runtime.engine as re_mod
    from authorino_tpu import cli
    import dataclasses
    from authorino_tpu import authjson as raj
    argv += ["--jax-platform", "cpu"]
    Real = re_mod.PolicyEngine
    class Spy(Real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw); holder["engine"] = self
    re_mod.PolicyEngine = Spy
    def conv(q):
        dd = dataclasses.asdict(q)
        http = dd.pop("http")
        peers = {k: raj.PeerAttributes(**dd.pop(k)) for k in ("source", "destination") if k in dd}
        return raj.CheckRequestModel(http=raj.HttpRequestAttributes(**http), **peers, **dd)
args = cli.build_parser().parse_args(argv)

def http_status(path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{ports['http']}{path}", timeout=2) as r:
            return r.status
    except Exception:
        return None

async def timed(engine, reqs):
    async def one(q):
        t = time.perf_counter(); r = await engine.check(q); return r.code, time.perf_counter() - t
    t = time.perf_counter()
    out = await asyncio.gather(*(one(q) for q in reqs))
    wall = time.perf_counter() - t
    lat = np.sort([s for _, s in out]) * 1e3
    return {"checks_per_s": round(len(reqs) / wall, 1), "p50_ms": round(float(np.percentile(lat, 50)), 2),
            "p99_ms": round(float(np.percentile(lat, 99)), 2)}

async def grpc_burst(call, items):
    async def one(p):
        t = time.perf_counter(); raw = await call(p); return time.perf_counter() - t
    t = time.perf_counter()
    lat = await asyncio.gather(*(one(p) for p in items))
    wall = time.perf_counter() - t
    lat = np.sort(lat) * 1e3
    return {"checks_per_s": round(len(items) / wall, 1), "p50_ms": round(float(np.percentile(lat, 50)), 2)}

async def main():
    kw = {"on_engine": lambda e: holder.__setitem__("engine", e)} if PKG == "port" else {}
    task = asyncio.ensure_future(cli.run_server(args, **kw))
    t0 = time.time()
    while (await asyncio.to_thread(http_status, "/readyz")) != 200:
        if task.done(): task.result()
        assert time.time() - t0 < 600
        await asyncio.sleep(0.1)
    engine = holder["engine"]
    inproc = [conv(q) for q in models]
    out = {"pkg": PKG, "ready_s": round(time.time() - t0, 1)}
    out["in_process_before"] = await timed(engine, inproc)
    out["in_process_before_2"] = await timed(engine, inproc)
    async with grpc.aio.insecure_channel(f"127.0.0.1:{ports['grpc']}") as ch:
        call = ch.unary_unary("/envoy.service.auth.v3.Authorization/Check")
        out["grpc_first"] = await grpc_burst(call, payloads)
        out["in_process_after_first"] = await timed(engine, inproc)
        out["grpc_bursts"] = [await grpc_burst(call, payloads) for _ in range(3)]
        out["in_process_after_bursts"] = await timed(engine, inproc)
        out["in_process_after_bursts_2"] = await timed(engine, inproc)
    task.cancel()
    try:
        await task
    except BaseException:
        pass
    print("RESULT", json.dumps(out))

asyncio.run(main())
os._exit(0)
