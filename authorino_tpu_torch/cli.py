"""CLI bootstrap (the analog of main.go: `authorino server|webhooks|version`,
ref main.go:134-220).  One process boots the gRPC ext_authz server, the
raw-HTTP /check server, the wristband OIDC discovery server and the control
plane (YAML-dir source standalone, or in-cluster watch when running in
Kubernetes), with the policy engine on the CUDA card.

The parser takes every flag of the reference's, with the same names,
defaults and environment variables; ``--jax-platform`` becomes ``--device``
(default ``cuda``: the engine raises before any port binds when no card is
visible; ``--device cpu`` runs the kernel's plain PyTorch version).  A flag
that tunes a plane the port does not hold yet stops the start, naming the
flag and its ROADMAP item, unless it has its inert default; a flag that
only turns such a plane off is accepted.

Flags fall back to env vars through a typed helper
(ref: pkg/utils/envvar.go:13-33)."""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import signal
import sys
import threading
import time
from typing import Any

from .runtime.lane_select import CARD_RULE


def env_var(name: str, default: Any) -> Any:
    """(ref: pkg/utils/envvar.go)"""
    raw = os.environ.get(name)
    if raw is None:
        return default
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes")
    if isinstance(default, int):
        try:
            return int(raw)
        except ValueError:
            return default
    if isinstance(default, float):
        try:
            return float(raw)
        except ValueError:
            return default
    return raw


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="authorino-tpu-torch")
    sub = p.add_subparsers(dest="command")

    s = sub.add_parser("server", help="Run the authorization server")
    a = s.add_argument
    a("--watch-dir", default=env_var("WATCH_DIR", ""), help="Directory of AuthConfig/Secret manifests (standalone mode)")
    a("--in-cluster", action="store_true", default=env_var("IN_CLUSTER", False), help="Watch AuthConfigs via the Kubernetes API")
    a("--ext-auth-grpc-port", type=int, default=env_var("EXT_AUTH_GRPC_PORT", 50051))
    a("--ext-auth-http-port", type=int, default=env_var("EXT_AUTH_HTTP_PORT", 5001))
    a("--oidc-http-port", type=int, default=env_var("OIDC_HTTP_PORT", 8083))
    a("--metrics-addr-port", type=int, default=env_var("METRICS_PORT", 8080))
    a("--timeout", type=int, default=env_var("TIMEOUT", 0), help="Per-request timeout in ms (0 = none)")
    a("--max-http-request-body-size", type=int, default=env_var("MAX_HTTP_REQUEST_BODY_SIZE", 1024 * 1024))
    a("--batch-size", type=int, default=env_var("BATCH_SIZE", 256), help="Max micro-batch size for device dispatch")
    a("--batch-window-us", type=int, default=env_var("BATCH_WINDOW_US", 500),
      help="Micro-batch gather window of the native frontend's batcher "
           "(the engine dispatches adaptively and does not read it)")
    a("--max-inflight-batches", type=int, default=env_var("MAX_INFLIGHT_BATCHES", 48),
      help="Device dispatch window: micro-batches in flight concurrently")
    a("--dispatch-workers", type=int, default=env_var("DISPATCH_WORKERS", 4),
      help="CPU workers for the encode stage of the dispatcher")
    a("--verdict-cache-size", type=int, default=env_var("VERDICT_CACHE_SIZE", 32768),
      help="Entries in the verdict LRU (0 disables it)")
    a("--no-batch-dedup", action="store_true", default=not env_var("BATCH_DEDUP", True),
      help="Disable within-micro-batch row dedup")
    a("--device-timeout", type=int, default=env_var("DEVICE_TIMEOUT_MS", 30000),
      help="Completer watchdog in ms (0 disables)")
    a("--breaker-threshold", type=int, default=env_var("BREAKER_THRESHOLD", 5),
      help="Device circuit breaker trip count (consecutive batch failures)")
    a("--breaker-reset", type=float, default=env_var("BREAKER_RESET_S", 5.0),
      help="Device circuit breaker half-open delay in seconds")
    a("--admission-target-ms", type=float, default=env_var("ADMISSION_TARGET_MS", 50.0),
      help="CoDel-style admission wait target in ms")
    a("--admission-queue-cap", type=int, default=env_var("ADMISSION_QUEUE_CAP", 0),
      help="Hard cap on the engine submit queue (0 = the dynamic cap only)")
    a("--no-adaptive-window", action="store_true", default=not env_var("ADAPTIVE_WINDOW", True),
      help="Disable the adaptive in-flight window")
    a("--no-brownout", action="store_true", default=not env_var("BROWNOUT", True),
      help="Disable host-lane brownout (spilling small head-of-queue "
           "batches to the exact host oracle while the device window is "
           "saturated; a CPU engine only, off on a card)")
    a("--brownout-max-batch", type=int, default=env_var("BROWNOUT_MAX_BATCH", 32),
      help="Rows per brownout spill batch (a CPU engine only: on a card "
           "any value but 32 stops the start)")
    a("--no-lane-select", action="store_true", default=not env_var("LANE_SELECT", True),
      help="Disable cost-model lane selection (the exact host oracle "
           "answering a cut faster than the device; a CPU engine only, off "
           "on a card)")
    a("--lane-host-max-rows", type=int, default=env_var("LANE_HOST_MAX_ROWS", 64),
      help="Largest cut the host lane may answer (a CPU engine only: on a "
           "card any value but 64 stops the start)")
    a("--no-speculative-dispatch", action="store_true", default=not env_var("SPECULATIVE_DISPATCH", True),
      help="Disable speculative dual-dispatch of the breaker's half-open "
           "probe batch (a CPU engine only, off on a card)")
    a("--no-tenant-qos", action="store_true", default=not env_var("TENANT_QOS", True),
      help="Disable the tenant QoS plane: weighted-fair batch cuts over "
           "per-tenant virtual queues, per-tenant quotas and tenant-aware "
           "doomed shedding at admission, per-tenant folds and "
           "noisy-neighbor containment.  Off returns the FIFO cut")
    a("--tenant-weight", action="append", default=[], metavar="TENANT=WEIGHT",
      help="Operator weight override for one tenant (AuthConfig id, e.g. "
           "ns/name=4).  Repeatable; overrides the authorino.tpu/qos-weight "
           "and qos-class annotations")
    a("--tenant-default-weight", type=float, default=env_var("TENANT_DEFAULT_WEIGHT", 1.0),
      help="Fair-share weight of un-annotated tenants")
    a("--tenant-quota-rps", type=float, default=env_var("TENANT_QUOTA_RPS", 0.0),
      help="Default per-tenant admission token-bucket rate (requests/s; 0 = "
           "no quota); per tenant from the authorino.tpu/qos-quota-rps "
           "annotation.  Over quota: RESOURCE_EXHAUSTED naming the tenant")
    a("--tenant-contain-threshold", type=float, default=env_var("TENANT_CONTAIN_THRESHOLD", 3.0),
      help="Contain a tenant whose served share exceeds its weighted share "
           "times this while the queue wait is over the admission target: "
           "its rows ride a part of their own at each cut, past a paced "
           "allowance typed rejections; released on decay")
    a("--tenant-top-k", type=int, default=env_var("TENANT_TOP_K", 16),
      help="Tenant-labelled metrics: only the top-K tenants by volume get "
           "their own label value, the rest fold into `other`")
    a("--expose-deny-reason", action="store_true", default=env_var("EXPOSE_DENY_REASON", False),
      help="PRIVACY KNOB: name the attributed firing rule in the "
           "client-visible X-Ext-Auth-Reason header on denials")
    a("--slo-ms", type=float, default=env_var("SLO_MS", 0.0),
      help="Per-request latency SLO in ms (0 = SLO tracking off): arms the "
           "multi-window burn-rate tracker (auth_server_slo_burn_rate"
           "{lane,window} gauges + the /debug/vars slo block)")
    a("--decision-log-size", type=int, default=env_var("DECISION_LOG_SIZE", 1024),
      help="Bounded decision-log ring capacity (/debug/decisions)")
    a("--decision-log-sample", type=int, default=env_var("DECISION_LOG_SAMPLE", 64),
      help="Head-sample 1-in-N decisions into the decision log")
    a("--canary-fraction", type=float, default=env_var("CANARY_FRACTION", 0.0))
    a("--canary-window", type=float, default=env_var("CANARY_WINDOW_S", 30.0))
    a("--capture", action="store_true", default=env_var("CAPTURE", False),
      help="Arm the opt-in capture log (docs/replay.md): sampled decisions "
           "(authconfig, authorization JSON, verdict, attributed rule) land "
           "in a byte-bounded in-memory ring, fed off the serving path by "
           "the capture's own thread.  --replay-pregate replays the ring")
    a("--capture-log-dir", default=env_var("CAPTURE_LOG_DIR", ""),
      help="Persist captured records as rotated checksummed segments "
           "(*.atpucap) in this directory, pruned to --capture-log-size-mb. "
           "Implies --capture")
    a("--capture-log-size-mb", type=float, default=env_var("CAPTURE_LOG_SIZE_MB", 64.0),
      help="Capture budget in MB of encoded record bytes: bounds the ring "
           "(oldest evicted) and the segment directory (oldest pruned)")
    a("--capture-sample", type=int, default=env_var("CAPTURE_SAMPLE", 1),
      help="Capture 1-in-N decisions (1 = every decision)")
    a("--replay-pregate", action="store_true", default=env_var("REPLAY_PREGATE", False),
      help="Before a corpus-changing reconcile starts its canary, replay "
           "the candidate against the capture ring through the host "
           "oracle; a verdict diff breaching the canary guard thresholds "
           "rejects the swap before the candidate reaches the device, a "
           "clean one tightens the canary's guards")
    a("--replay-pregate-budget-ms", type=float, default=env_var("REPLAY_PREGATE_BUDGET_MS", 2000.0),
      help="Wall-clock bound on the pregate's replay; records past it are "
           "reported truncated")
    a("--corpus-pregate", default=env_var("CORPUS_PREGATE", ""))
    a("--corpus-pregate-budget-ms", type=float, default=env_var("CORPUS_PREGATE_BUDGET_MS", 2000.0))
    a("--snapshot-history", type=int, default=env_var("SNAPSHOT_HISTORY", 4))
    a("--flight-keep", type=int, default=env_var("AUTHORINO_TPU_FLIGHT_KEEP", 16),
      help="Flight-recorder on-disk bundle retention: only the newest N "
           "diagnostic bundles survive in --flight-dir")
    a("--flight-dir", default=env_var("AUTHORINO_TPU_FLIGHT_DIR", ""),
      help="Directory for flight-recorder diagnostic bundles (default: "
           "<tmp>/authorino-tpu-flight).  Bundles auto-dump on anomalies: "
           "watchdog fire, admission OVERLOADED, a modeled kernel-cost "
           "regression")
    a("--no-flight-recorder", action="store_true",
      default=not env_var("AUTHORINO_TPU_FLIGHT_RECORDER", True),
      help="Disable the lifecycle flight recorder (the bounded event ring "
           "+ anomaly bundle dumps)")
    a("--drain-timeout", type=float, default=env_var("DRAIN_TIMEOUT_S", 10.0),
      help="Graceful-shutdown bound in seconds: SIGTERM stops admission, "
           "then in-flight requests/batches get this long to complete")
    a("--fault-profile", default=env_var("AUTHORINO_TPU_FAULTS", ""),
      help="ARM THE FAULT-INJECTION PLANE (testing/chaos only): a named "
           "profile (device-down, flaky, flap, slow-device, wedge) or a "
           "rule spec — see runtime/faults.py")
    a("--ovf-assist", action="store_true", default=env_var("AUTHORINO_TPU_OVF_ASSIST", False),
      help="Answer membership-overflow rows in the kernel from exact "
           "assist columns")
    a("--kernel-lane", choices=("auto", "fused", "gather", "matmul"),
      default=env_var("AUTHORINO_TPU_KERNEL_LANE", "auto"),
      help="Device-eval kernel lane: 'fused' (the CUDA mega-kernel), "
           "'matmul' (one-hot products) or 'gather' (indexed op chain); "
           "'auto' arms fused on a card and on the CPU")
    a("--no-metadata-prefetch", action="store_true",
      default=not env_var("AUTHORINO_TPU_METADATA_PREFETCH", True),
      help="Disable the metadata prefetch cache (relations/prefetch.py): "
           "request-independent external-metadata documents are pinned at "
           "reconcile cadence and served with no network I/O; stale pins "
           "fall through to the live fetch")
    a("--metadata-max-age", type=float, default=env_var("METADATA_PREFETCH_MAX_AGE_S", 300.0),
      help="Staleness bound in seconds of a pinned metadata document: past "
           "it the pipeline fetches live")
    a("--metadata-refresh", type=float, default=env_var("METADATA_PREFETCH_REFRESH_S", 60.0),
      help="Background re-pin cadence in seconds of pinned metadata "
           "documents")
    a("--strict-verify", action="store_true", default=env_var("STRICT_VERIFY", False),
      help="Lint and certify every compiled snapshot before any byte of it "
           "reaches the device (analysis/tensor_lint.py, analysis/"
           "translation_validate.py): a snapshot with a finding is rejected "
           "and the previous one keeps serving")
    a("--snapshot-publish-dir", default=env_var("SNAPSHOT_PUBLISH_DIR", ""))
    a("--snapshot-source", default=env_var("SNAPSHOT_SOURCE", ""))
    a("--snapshot-poll", type=float, default=env_var("SNAPSHOT_POLL_S", 5.0))
    a("--fleet-hotset-k", type=int, default=env_var("FLEET_HOTSET_K", 1024))
    a("--fleet-hotset-s", type=float, default=env_var("FLEET_HOTSET_S", 30.0))
    a("--state-dir", default=env_var("STATE_DIR", ""))
    a("--max-snapshot-age", type=float, default=env_var("MAX_SNAPSHOT_AGE_S", 0.0))
    a("--native-frontend", choices=["auto", "on", "off"], default=env_var("NATIVE_FRONTEND", "auto"),
      help="Serve gRPC ext_authz from the native C++ frontend (fast-lane "
           "configs decided by one kernel launch per gathered batch, the "
           "rest through the pipeline): 'auto' falls back to grpc.aio "
           "with a WARNING when it cannot start (or with TLS flags), 'on' "
           "raises then, 'off' serves grpc.aio")
    a("--evaluator-cache-size", type=int, default=env_var("EVALUATOR_CACHE_SIZE", 4096))
    a("--deep-metrics-enabled", action="store_true", default=env_var("DEEP_METRICS_ENABLED", False))
    a("--debug-profile", action="store_true", default=env_var("DEBUG_PROFILE", False),
      help="Arm the /debug/profile?seconds=N endpoint (a torch.profiler "
           "trace to a temp dir on demand)")
    a("--auth-config-label-selector", default=env_var("AUTH_CONFIG_LABEL_SELECTOR", ""))
    a("--secret-label-selector", default=env_var("SECRET_LABEL_SELECTOR", "authorino.kuadrant.io/managed-by=authorino"))
    a("--allow-superseding-host-subsets", action="store_true", default=env_var("ALLOW_SUPERSEDING_HOST_SUBSETS", False))
    a("--enable-leader-election", action="store_true", default=env_var("ENABLE_LEADER_ELECTION", False), help="Leader-elect the status writer (in-cluster mode)")
    a("--tls-cert", default=env_var("TLS_CERT", ""), help="PEM cert for the ext_authz gRPC + HTTP listeners (ref main.go:456-470; TLS >= 1.2)")
    a("--tls-cert-key", default=env_var("TLS_CERT_KEY", ""))
    a("--oidc-tls-cert", default=env_var("OIDC_TLS_CERT", ""), help="PEM cert for the OIDC discovery listener")
    a("--oidc-tls-cert-key", default=env_var("OIDC_TLS_CERT_KEY", ""))
    a("--tracing-service-endpoint", default=env_var("TRACING_SERVICE_ENDPOINT", ""), help="OTLP endpoint (http(s)://...; rpc:// only propagates)")
    a("--tracing-service-insecure", action="store_true", default=env_var("TRACING_SERVICE_INSECURE", False))
    a("--log-level", default=env_var("LOG_LEVEL", "info"))
    a("--device", default=env_var("AUTHORINO_DEVICE", "cuda"),
      help="Torch device of the policy engine: 'cuda' (the default; the "
           "start fails without a card) or 'cpu' (the kernel's plain "
           "PyTorch version)")

    w = sub.add_parser("webhooks", help="Run the CRD conversion/validation webhook server")
    w.add_argument("--webhook-service-port", type=int, default=env_var("WEBHOOK_SERVICE_PORT", 9443))
    w.add_argument("--tls-cert", default=env_var("TLS_CERT", ""), help="PEM cert for the webhook listener")
    w.add_argument("--tls-cert-key", default=env_var("TLS_CERT_KEY", ""))
    w.add_argument("--log-level", default=env_var("LOG_LEVEL", "info"))

    sub.add_parser("version", help="Print version")
    return p


# the reference's planes the port does not hold yet, with the ROADMAP.md
# item (queue 1) that brings each: none
UNPORTED_PLANES: dict = {}

# a host-lane tuning flag → (its inert value, the plane).  The host lanes
# run on a CPU engine only (runtime/lane_select.py): on a card any other
# value stops the start.  A flag that only turns a plane off
# (--no-brownout, --no-lane-select, ...) is absent: it is accepted anywhere
CARD_REFUSED_FLAGS = {
    "brownout_max_batch": (32, "brownout"),
    "lane_host_max_rows": (64, "lane selection"),
}


def refuse_unported(args) -> None:
    """Stop the start for a flag the server would not honour: a host-lane
    tuning flag set to anything but its inert value on a card, where only
    the kernel answers a row."""
    if str(getattr(args, "device", "cuda")).split(":")[0] == "cpu":
        return
    for dest, (inert, plane) in CARD_REFUSED_FLAGS.items():
        value = getattr(args, dest)
        if value != inert:
            flag = "--" + dest.replace("_", "-")
            raise SystemExit(
                f"{flag}={value!r}: the {plane} plane does not run on "
                f"--device {args.device} ({CARD_RULE}); it runs with "
                "--device cpu")


def host_lane_kwargs(args) -> dict:
    """The host lanes' engine arguments: a ``--no-*`` flag asks for off,
    its absence is "not asked" (None), which the engine resolves by its
    device (all on for a CPU engine, all off on a card)."""
    return {
        "brownout": False if args.no_brownout else None,
        "brownout_max_batch": int(args.brownout_max_batch),
        "lane_select": False if args.no_lane_select else None,
        "lane_host_max_rows": int(args.lane_host_max_rows),
        "speculative_dispatch": (False if args.no_speculative_dispatch
                                 else None),
    }


def _parse_tenant_weights(pairs) -> dict:
    """--tenant-weight ns/name=4 (repeatable) -> {tenant: weight}.  A
    malformed entry is skipped with a warning: a typo must not stop
    serving."""
    out = {}
    for raw in pairs or []:
        tenant, sep, w = str(raw).rpartition("=")
        try:
            if not sep or not tenant:
                raise ValueError(raw)
            out[tenant] = float(w)
        except ValueError:
            logging.getLogger("authorino_tpu_torch").warning(
                "ignoring malformed --tenant-weight %r "
                "(want TENANT=WEIGHT)", raw)
    return out


def _ssl_ctx(cert: str, key: str, what: str = "--tls-cert"):
    """Server-side TLS context, minimum 1.2 like the reference
    (ref main.go:456-470)."""
    import ssl

    if bool(cert) != bool(key):
        raise SystemExit(f"{what} and {what}-key must be provided together")
    if not cert:
        return None
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    ctx.load_cert_chain(cert, key)
    return ctx


def _stop_on_signals(loop, stop: asyncio.Event) -> list:
    """SIGINT/SIGTERM set ``stop``; returns the signals handled.  Off the
    main thread (an embedder's loop) no handler can be installed, and the
    caller stops the server by cancelling its task."""
    handled = []
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
            handled.append(sig)
        except (NotImplementedError, RuntimeError):
            pass
    return handled


async def run_webhooks(args) -> None:
    """(ref: main.go `webhooks` command — conversion webhook server)"""
    from aiohttp import web

    from .service.webhooks import build_webhook_app

    logging.basicConfig(level=getattr(logging, args.log_level.upper(), logging.INFO))
    log = logging.getLogger("authorino_tpu.webhooks")

    ssl_ctx = _ssl_ctx(args.tls_cert, args.tls_cert_key)

    runner = web.AppRunner(build_webhook_app())
    await runner.setup()
    await web.TCPSite(runner, "0.0.0.0", args.webhook_service_port, ssl_context=ssl_ctx).start()
    log.info("webhooks listening on :%d (tls=%s)", args.webhook_service_port, bool(ssl_ctx))

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    handled = _stop_on_signals(loop, stop)
    try:
        await stop.wait()
    finally:
        for sig in handled:
            loop.remove_signal_handler(sig)
        await runner.cleanup()


def _same_dir(a: str, b: str) -> bool:
    return bool(a and b and not b.startswith(("http://", "https://"))
                and os.path.realpath(a) == os.path.realpath(b))


def start_state_planes(args, engine, log):
    """Snapshot distribution and the durable state plane, wired before the
    control plane's first sync.  A compile leader publishes every vetted
    snapshot into --snapshot-publish-dir (and its verdict cache's hot set
    beside it); the state plane warm-starts from --state-dir (the
    replica's admission gate) and then writes behind; a serving replica
    polls --snapshot-source and applies each new vetted snapshot without
    compiling, its first poll (with the leader's hot set) before the
    start returns: a reachable leader supersedes the local blob.  Returns
    (replica, state plane, the hot-set thread's stop event), each None
    when off."""
    publish_dir = str(args.snapshot_publish_dir or "")
    snapshot_source = str(args.snapshot_source or "")
    state_dir = str(args.state_dir or "")
    # the loop breakers: a node is a compile leader or a serving replica,
    # never its own upstream, and its state dir (which persists LOADED
    # snapshots) is never a distribution feed
    if _same_dir(publish_dir, snapshot_source):
        raise RuntimeError(
            "--snapshot-publish-dir and --snapshot-source point at the "
            "same directory: a node is either a compile leader or a "
            "serving replica, not its own upstream")
    for other, flag in ((snapshot_source, "--snapshot-source"),
                        (publish_dir, "--snapshot-publish-dir")):
        if state_dir and _same_dir(state_dir, other):
            raise RuntimeError(
                f"--state-dir and {flag} point at the same directory: "
                "the state plane is this process's private "
                "crash-recovery store, never a distribution feed")
    hotset_k = int(args.fleet_hotset_k or 0)
    hotset_s = max(1.0, float(args.fleet_hotset_s))
    hotset_stop = None
    if publish_dir:
        from .snapshots.distribution import SnapshotPublisher

        publisher = SnapshotPublisher(publish_dir)
        publisher.attach(engine)
        log.info("snapshot leader: publishing vetted snapshots to %s",
                 publish_dir)
        if hotset_k > 0:
            # the warm-join cadence: the verdict cache's top-K into
            # HOTSET.json beside the manifest.  Advisory: a failed publish
            # only costs joiners a cold cache
            from .fleet import warmjoin as warmjoin_mod

            hotset_stop = threading.Event()

            def _hotset_loop() -> None:
                while not hotset_stop.wait(hotset_s):
                    try:
                        digest = warmjoin_mod.export_hotset(
                            engine, k=hotset_k)
                        if digest is not None:
                            publisher.publish_hotset(digest)
                    except Exception:
                        log.exception("hot-set publish failed (warm-join "
                                      "is advisory; serving unaffected)")

            threading.Thread(target=_hotset_loop, daemon=True,
                             name="atpu-fleet-hotset").start()
            log.info("fleet hot-set: publishing top-%d verdicts every "
                     "%.0fs", hotset_k, hotset_s)
    state_plane = None
    if state_dir:
        from .runtime.state_plane import StatePlane

        state_plane = StatePlane(
            engine, state_dir,
            max_snapshot_age_s=float(args.max_snapshot_age),
            hotset_k=hotset_k or 1024, hotset_s=hotset_s)
        engine.state_plane = state_plane
        summary = state_plane.warm_start()
        state_plane.start()
        log.info("state plane: %s (snapshot=%s hotset=%s, "
                 "max_snapshot_age=%.0fs)", state_dir,
                 summary.get("snapshot"), summary.get("hotset"),
                 state_plane.max_snapshot_age_s)
    snapshot_replica = None
    if snapshot_source:
        from .snapshots.distribution import SnapshotReplica

        if args.watch_dir or args.in_cluster:
            log.warning("--snapshot-source with a local control plane: the "
                        "replica feed and local reconciles will race for "
                        "the serving snapshot; pick one")
        snapshot_replica = SnapshotReplica(engine, snapshot_source,
                                           poll_s=float(args.snapshot_poll))
        try:
            snapshot_replica.poll_once()
            if hotset_k > 0:
                # seed the verdict cache from the leader's hot set, so a
                # replica joining mid-flood starts warm (a mismatch or no
                # digest: it joins cold)
                from .fleet import warmjoin as warmjoin_mod
                from .snapshots.distribution import load_hotset

                imported, _ = warmjoin_mod.import_hotset(
                    engine, load_hotset(snapshot_source))
                if imported:
                    log.info("warm-join: inherited %d hot verdict(s) "
                             "from the leader's published hot set",
                             imported)
        except Exception:
            log.exception("snapshot warm start failed (the replica keeps "
                          "polling; serving an empty index until a vetted "
                          "snapshot loads)")
        snapshot_replica.start()
        log.info("snapshot replica: polling %s every %.1fs",
                 snapshot_source, float(args.snapshot_poll))
    return snapshot_replica, state_plane, hotset_stop


async def run_server(args, on_engine=None) -> None:
    """Serve until SIGINT/SIGTERM or until the task is cancelled, then
    drain.  ``on_engine(engine)``, when given, is called as soon as the
    policy engine exists, before the control plane's first sync (an
    embedder's handle on the engine: its records, its swaps)."""
    from aiohttp import web

    from .controllers.reconciler import AuthConfigReconciler, SecretReconciler
    from .controllers.sources import YamlDirSource
    from .evaluators import cache as cache_mod
    from .replay.capture import CAPTURE
    from .k8s.client import InMemoryCluster, LabelSelector, RestCluster
    from .runtime import provenance as prov_mod
    from .runtime.engine import PolicyEngine
    from .runtime.flight_recorder import RECORDER
    from .service.grpc_server import build_server
    from .service.http_server import build_app
    from .service.oidc_server import build_oidc_app
    from .utils import metrics as metrics_mod
    from .utils.tracing import setup_tracing, shutdown_tracing

    logging.basicConfig(
        level=getattr(logging, args.log_level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
    )
    log = logging.getLogger("authorino_tpu")

    refuse_unported(args)
    native_mode = str(args.native_frontend).lower()
    if native_mode not in ("auto", "on", "off"):
        # argparse validates choices only for CLI tokens, not env defaults —
        # a NATIVE_FRONTEND typo must not silently serve another path
        raise RuntimeError(f"invalid --native-frontend/NATIVE_FRONTEND value "
                           f"{native_mode!r} (want auto|on|off)")
    if native_mode == "on" and (args.tls_cert or args.tls_cert_key):
        # the frontend has no TLS termination (as the reference's)
        raise RuntimeError("--native-frontend=on is incompatible with "
                           "--tls-cert (terminate TLS in front of the "
                           "native listener)")

    cache_mod.EVALUATOR_CACHE_MAX_ENTRIES = args.evaluator_cache_size
    metrics_mod.DEEP_METRICS_ENABLED = args.deep_metrics_enabled

    # TLS material loads BEFORE the control plane starts: a bad flag/path
    # must fail at startup, not mid-boot with a leader lease already held
    ext_ssl = _ssl_ctx(args.tls_cert, args.tls_cert_key)
    oidc_ssl = _ssl_ctx(args.oidc_tls_cert, args.oidc_tls_cert_key, "--oidc-tls-cert")
    tls_credentials = None
    if ext_ssl is not None:
        import grpc

        with open(args.tls_cert_key, "rb") as f:
            key_pem = f.read()
        with open(args.tls_cert, "rb") as f:
            cert_pem = f.read()
        tls_credentials = grpc.ssl_server_credentials([(key_pem, cert_pem)])

    if args.tracing_service_endpoint:
        # --tracing-service-insecure parses as the reference's; it only
        # matters to an OTLP gRPC exporter, which this server does not have
        setup_tracing(args.tracing_service_endpoint)

    # decision observability: the deny-reason privacy knob, the
    # decision-log ring, and the flight recorder
    prov_mod.EXPOSE_DENY_REASON = bool(args.expose_deny_reason)
    prov_mod.DECISIONS.configure(capacity=int(args.decision_log_size),
                                 sample_n=int(args.decision_log_sample))
    RECORDER.configure(dump_dir=args.flight_dir or None,
                       enabled=not args.no_flight_recorder,
                       keep=int(args.flight_keep))

    # traffic capture (docs/replay.md): opt-in; a persistence directory
    # implies it (persisting an unarmed log captures nothing)
    capture_dir = str(args.capture_log_dir or "")
    if args.capture or capture_dir:
        CAPTURE.configure(enabled=True, directory=capture_dir or None,
                          size_mb=float(args.capture_log_size_mb),
                          sample_n=int(args.capture_sample))
        log.info("traffic capture ARMED: sample 1-in-%d, %.1f MB budget%s",
                 CAPTURE.sample_n, CAPTURE.size_bytes / 1048576,
                 f", persisting to {capture_dir}" if capture_dir else
                 " (in-memory ring only)")

    fault_profile = str(args.fault_profile or "")
    if fault_profile:
        from .runtime import faults

        faults.FAULTS.arm(fault_profile)
        log.warning("fault injection ARMED via --fault-profile (%s): this "
                    "is a chaos/testing mode", fault_profile)

    if str(args.snapshot_publish_dir or "") and not args.strict_verify:
        # replicas admit only certified snapshots, and only strict verify
        # certifies: publishing uncertified blobs would wedge every
        # replica on its last vetted snapshot with nothing flagging it here
        log.warning("--snapshot-publish-dir implies --strict-verify "
                    "(replicas only admit certified snapshots): enabling it")
        args.strict_verify = True
    if str(args.state_dir or "") and not args.strict_verify:
        # the warm-restart loader is the replica's admission gate: it
        # admits only certified blobs, so persisting uncertified reconciles
        # would make every warm restart a silent cold start
        log.warning("--state-dir implies --strict-verify (the warm-restart "
                    "loader only admits certified snapshots): enabling it")
        args.strict_verify = True

    device_timeout_ms = int(args.device_timeout or 0)
    kernel_lane = str(args.kernel_lane or "auto")
    if kernel_lane != "auto":
        # mirror the flag into the environment so lane-unaware
        # ``to_device()`` calls (tooling, a loaded snapshot) resolve the
        # same kernel lane
        os.environ["AUTHORINO_TPU_KERNEL_LANE"] = kernel_lane
    # the engine resolves its device first: without a card (and without
    # --device cpu) the start raises here, before any port binds
    engine = PolicyEngine(
        max_batch=args.batch_size,
        device=args.device,
        timeout_s=(args.timeout / 1000.0) if args.timeout else None,
        admission_target_s=float(args.admission_target_ms) / 1e3,
        admission_queue_cap=int(args.admission_queue_cap),
        adaptive_window=not args.no_adaptive_window,
        **host_lane_kwargs(args),
        max_inflight_batches=args.max_inflight_batches,
        dispatch_workers=args.dispatch_workers,
        verdict_cache_size=args.verdict_cache_size,
        batch_dedup=not args.no_batch_dedup,
        device_timeout_s=(device_timeout_ms / 1000.0) or None,
        ovf_assist=bool(args.ovf_assist) or None,
        slo_ms=float(args.slo_ms),
        breaker_threshold=int(args.breaker_threshold),
        breaker_reset_s=float(args.breaker_reset),
        canary_fraction=float(args.canary_fraction),
        canary_window_s=float(args.canary_window),
        snapshot_history=int(args.snapshot_history),
        tenant_qos=not args.no_tenant_qos,
        tenant_default_weight=float(args.tenant_default_weight),
        tenant_weights=_parse_tenant_weights(args.tenant_weight),
        tenant_quota_rps=float(args.tenant_quota_rps),
        tenant_contain_threshold=float(args.tenant_contain_threshold),
        tenant_top_k=int(args.tenant_top_k),
        strict_verify=bool(args.strict_verify),
        metadata_prefetch=not args.no_metadata_prefetch,
        metadata_prefetch_max_age_s=float(args.metadata_max_age),
        metadata_prefetch_refresh_s=float(args.metadata_refresh),
        replay_pregate=bool(args.replay_pregate),
        replay_pregate_budget_s=float(args.replay_pregate_budget_ms) / 1e3,
        corpus_pregate=str(args.corpus_pregate or ""),
        corpus_pregate_budget_s=float(args.corpus_pregate_budget_ms) / 1e3,
        kernel_lane=kernel_lane if kernel_lane != "auto" else None,
    )
    if engine.device.type == "cuda":
        import torch

        log.info("policy engine on %s (%s)", engine.device,
                 torch.cuda.get_device_name(engine.device))
    else:
        log.info("policy engine on %s (the kernel's plain PyTorch version)",
                 engine.device)
    if on_engine is not None:
        on_engine(engine)
    log.info("host lanes: brownout %s, lane selection %s, speculative "
             "dispatch %s%s", engine.brownout, engine.lanes.enabled,
             engine.lanes.speculative,
             "" if engine.host_degrade else f" ({CARD_RULE})")
    snapshot_replica, state_plane, hotset_stop = start_state_planes(
        args, engine, log)

    selector = LabelSelector.parse(args.auth_config_label_selector) if args.auth_config_label_selector else None
    secret_selector = LabelSelector.parse(args.secret_label_selector) if args.secret_label_selector else None

    source = None
    status_updater = None
    cluster = RestCluster() if args.in_cluster else InMemoryCluster()
    reconciler = AuthConfigReconciler(
        engine,
        cluster=cluster,
        label_selector=selector,
        allow_superseding_host_subsets=args.allow_superseding_host_subsets,
    )
    secret_reconciler = SecretReconciler(engine, secret_label_selector=secret_selector)
    if args.in_cluster:
        # real-cluster control plane: watch AuthConfigs/Secrets, leader-elect
        # the status writer (ref: main.go:241-336)
        from .controllers.sources import K8sWatchSource
        from .controllers.status_updater import AuthConfigStatusUpdater
        from .k8s.leader import leader_election_id

        source = K8sWatchSource(
            cluster, reconciler, secret_reconciler, secret_label_selector=secret_selector
        )
        # block serving until the first list lands (cache-sync semantics);
        # retries internally while the apiserver is unreachable
        await source.sync()
        source.start()
        status_updater = AuthConfigStatusUpdater(
            reconciler, cluster, leases=cluster,
            namespace=os.environ.get("POD_NAMESPACE", "default"),
            leader_election=args.enable_leader_election,
            # per-shard lease: derived from the watched label selector so
            # label-sharded instances don't contend for one lease
            lease_name=leader_election_id(args.auth_config_label_selector or ""),
        ).start()
        log.info("watching AuthConfigs via the Kubernetes API")
    elif args.watch_dir:
        source = YamlDirSource(args.watch_dir, reconciler, cluster, secret_reconciler)
        await source.sync()
        source.start()
        log.info("watching manifests under %s", args.watch_dir)
    else:
        log.warning("no --watch-dir and not --in-cluster: serving an empty index")

    # gRPC ext_authz: the native C++ frontend where it can start (fast-
    # lane configs never touch Python per request; everything else rides
    # the pipeline over its slow queue), else grpc.aio — the reference's
    # course (ref cli.py:851-903).  The frontend has no TLS termination:
    # TLS flags serve grpc.aio ('on' refused them above).  It starts
    # before the HTTP listeners, so /readyz answers 200 only once the gRPC
    # listener serves the installed snapshot
    native_holder: dict = {"fe": None}
    grpc_server = None
    native_fe = None
    if native_mode == "off":
        native_holder["fe"] = {"enabled": False,
                               "reason": "--native-frontend off"}
    elif tls_credentials is not None:
        native_holder["fe"] = {"enabled": False,
                               "reason": "TLS flags: the native frontend "
                                         "does not terminate TLS"}
        log.warning("native frontend not started (%s); using grpc.aio",
                    native_holder["fe"]["reason"])
    else:
        from .runtime.native_frontend import NativeFrontend

        native_fe = NativeFrontend(
            engine, port=args.ext_auth_grpc_port,
            max_batch=max(args.batch_size, 64),
            window_us=args.batch_window_us, bind_all=True,
            verdict_cache_size=args.verdict_cache_size,
            batch_dedup=not args.no_batch_dedup,
            device_timeout_s=(device_timeout_ms / 1000.0) or None,
            breaker_threshold=int(args.breaker_threshold),
            breaker_reset_s=float(args.breaker_reset),
            admission_target_s=float(args.admission_target_ms) / 1e3,
            brownout=False if args.no_brownout else None,
            brownout_max_rows=int(args.brownout_max_batch),
            lane_select=False if args.no_lane_select else None,
            lane_host_max_rows=int(args.lane_host_max_rows),
            slo_ms=float(args.slo_ms),
        )
        try:
            await asyncio.get_running_loop().run_in_executor(
                None, native_fe.start)
        except Exception as e:
            native_fe = None
            if native_mode == "on":
                raise
            native_holder["fe"] = {"enabled": False, "reason": str(e)}
            log.warning("native frontend unavailable (%s); using grpc.aio", e)
        else:
            native_holder["fe"] = native_fe
            log.info("native grpc ext_authz listening on :%d (libnghttp2: "
                     "%s)", native_fe.bound_port, native_fe.nghttp2_path)
    if native_fe is None:
        grpc_server = build_server(
            engine, address=f"0.0.0.0:{args.ext_auth_grpc_port}",
            tls_credentials=tls_credentials,
        )
        await grpc_server.start()
        log.info("grpc ext_authz listening on :%d (tls=%s)", args.ext_auth_grpc_port, bool(tls_credentials))

    # HTTP /check (+ /metrics, /debug/vars, /debug/profile); /debug/vars
    # shows the native frontend, or why it does not serve
    app = build_app(engine, readiness=reconciler.ready,
                    max_body=args.max_http_request_body_size,
                    enable_profile=bool(args.debug_profile),
                    frontend=lambda: native_holder["fe"])
    runner = web.AppRunner(app)
    await runner.setup()
    await web.TCPSite(runner, "0.0.0.0", args.ext_auth_http_port, ssl_context=ext_ssl).start()
    log.info("http /check listening on :%d (tls=%s)", args.ext_auth_http_port, bool(ext_ssl))

    # OIDC discovery (wristbands)
    oidc_runner = web.AppRunner(build_oidc_app(engine))
    await oidc_runner.setup()
    await web.TCPSite(oidc_runner, "0.0.0.0", args.oidc_http_port, ssl_context=oidc_ssl).start()
    log.info("oidc discovery listening on :%d (tls=%s)", args.oidc_http_port, bool(oidc_ssl))

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    handled = _stop_on_signals(loop, stop)
    try:
        await stop.wait()
    finally:
        # graceful drain: SIGTERM → stop admitting (readyz flips 503 so the
        # LB stops routing here; new engine submits fail fast UNAVAILABLE),
        # let in-flight RPCs and device batches complete within
        # --drain-timeout, flush telemetry, then exit.  Runs on signal AND
        # on task cancellation (embedders and tests cancel the serve task).
        # Every step is isolated — a second cancellation or one failing
        # stop must not skip the remaining teardown
        for sig in handled:
            loop.remove_signal_handler(sig)
        drain_s = float(args.drain_timeout)
        # ONE shared deadline across every drain stage: the gRPC grace and
        # the engine drain each consume only what is left, so
        # SIGTERM-to-exit stays ≈ --drain-timeout
        drain_deadline = time.monotonic() + drain_s

        def drain_left() -> float:
            return max(0.5, drain_deadline - time.monotonic())

        log.info("shutting down: draining (bound %.1fs)", drain_s)
        engine.begin_drain()

        async def best_effort(awaitable) -> None:
            try:
                await asyncio.shield(asyncio.ensure_future(awaitable))
            except (Exception, asyncio.CancelledError) as e:
                log.warning("shutdown step failed: %r", e)

        # control plane first: no new snapshots compile mid-drain
        if hotset_stop is not None:
            hotset_stop.set()
        if snapshot_replica is not None:
            await best_effort(loop.run_in_executor(
                None, lambda: snapshot_replica.stop(min(2.0, drain_left()))))
        if status_updater is not None:
            await best_effort(status_updater.stop())
        if source is not None:
            await best_effort(source.stop())
        # the gRPC server stops ACCEPTING and waits out in-flight Checks;
        # the native frontend drains its slow lane and in-flight batches
        # (two bounded loops: half the remaining budget each) before fe_stop
        if grpc_server is not None:
            await best_effort(grpc_server.stop(drain_left()))
        if native_fe is not None:
            await best_effort(loop.run_in_executor(
                None, lambda: native_fe.stop(drain_left() / 2)))
        # the engine dispatcher: every queued request and in-flight batch
        # resolves before exit
        drained = True
        try:
            drained = await loop.run_in_executor(None, engine.drain,
                                                 drain_left())
        except Exception as e:
            log.warning("engine drain failed: %r", e)
        log.info("drain %s", "complete" if drained else
                 "TIMED OUT (undrained work abandoned)")
        if CAPTURE.enabled:
            # persist the capture's tail segment: a replayable log must not
            # lose its newest window to an orderly shutdown
            await best_effort(loop.run_in_executor(
                None, lambda: CAPTURE.flush(min(2.0, drain_left()))))
        if state_plane is not None:
            # the final state flush: the last vetted snapshot rides the
            # publisher's flush and the hot set exports once more, so the
            # next boot warm-starts from the freshest state
            await best_effort(loop.run_in_executor(
                None, lambda: state_plane.shutdown(min(2.0, drain_left()))))
        await best_effort(runner.cleanup())
        await best_effort(oidc_runner.cleanup())
        await best_effort(shutdown_tracing())  # flush the last spans


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "version":
        from . import __version__

        print(__version__)
        return 0
    if args.command == "server":
        asyncio.run(run_server(args))
        return 0
    if args.command == "webhooks":
        asyncio.run(run_webhooks(args))
        return 0
    build_parser().print_help()
    return 1


if __name__ == "__main__":
    sys.exit(main())
