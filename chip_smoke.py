#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

  1. the card: ``nvidia-smi`` name and power limit, torch's device name;
  2. build the CUDA kernels from ``authorino_tpu_torch/ops/csrc`` with nvcc
     and launch the probe kernel; build the host encoder from
     ``authorino_tpu_torch/native/csrc`` with g++;
  3. the mega-kernel against its plain PyTorch version on the card, byte
     for byte: the all-lanes corpus at 3 seeds with ovf-assist on and off
     on both wire dtypes, a config past 64 circuit slots beside a small
     one, and the north-star corpus (1000 AuthConfigs × 10 rules,
     members_k 16) at B ∈ {16, 256} and LB ∈ {16, 64}; with the DFA tables
     in shared memory and with the global-tables instance forced;
  4. the main path: a PolicyEngine on the north-star corpus (max_batch
     256) answers 4,096 concurrent submits; every verdict must equal the
     expression oracle, every batch one launch and a pad × W readback
     (phases 4 and 6-8 run with batch dedup and the verdict cache off,
     ``NO_REUSE``, so every row reaches the kernel as in earlier runs; each
     batch is read from the engine's own ``batch_records``);
  5. numbers, beside the card's name and power limit: at B = 256 with
     LB = 16 and 64 and at B = 16, the kernel's device time per call and
     per launch back to back (N launches between one event pair) with the
     tables in shared memory and in device memory, and the median
     per-phase clock64() stamps of the instrumented instance; the
     per-config program's size and host build time; the wrapper's host
     enqueue with its words cached and rebuilt; plain-version and
     transfer times; the probe's times and that of ``x + 1``; the
     engine's submit-only decisions/s and batch latency;
  6. the Check() request path: 1,000 north-star AuthConfigs (v1beta2
     specs, a plain identity over Envoy's jwt_authn claims) and the V2
     config of the control-plane tests translated with a card engine and
     installed in one snapshot; 4,096 concurrent ``engine.check()`` calls
     plus the V2 checks (with and without a key, an admin path, OPTIONS,
     ``host:port``, an unknown host), every result held to the expression
     oracle with its deny provenance, one launch per batch and a pad × W
     readback; then checks/s (median of TIMED_RUNS runs) and per-Check() latency
     p50/p99 beside the batch count, rows per batch and phase 5's
     submit-only decisions/s, and the latency of a lone Check() (200
     sent one at a time);
  7. the OPA request path: 1,000 AuthConfigs of the OPA corpus
     (``models/opa_corpus.py``: the phase-6 identity, one pattern and one
     inline Rego policy each, about nine in ten of which lower into a
     kernel slot) and one Kubernetes TokenReview + SubjectAccessReview
     config translated with a card engine into one snapshot; 4,096
     concurrent ``engine.check()`` calls plus the Kubernetes checks, every
     result held to the oracle (the pattern's verdict and deny provenance,
     then the interpreter's ``allow``), every batch one launch and a
     pad × W readback; every lowered config's kernel bit held to
     ``lower_verdict(module).matches(doc)`` and the interpreter's
     ``allow``; the mega-kernel's [256, W] readback on this corpus
     byte-equal to its plain version; then checks/s (median of TIMED_RUNS runs),
     per-Check() p50/p99 under the burst and alone, the share of configs
     lowered, the interpreter's host time per Check(), and the kernel's
     device time on this corpus beside its bound;
  8. the JWT request path (``models/oidc_corpus.py``, the Keycloak RBAC
     deployment): keys made from a seed in pure Python and a fake
     Keycloak on loopback; 1,000 AuthConfigs with a ``jwt`` identity and
     the north-star rules, one config with every other kind of the family
     (userInfo, http and uma metadata, a wristband, an http callback) and
     one OAuth2-introspection config, translated with a card engine
     (1,000 OIDC discoveries) into one snapshot; 4,096 concurrent
     ``engine.check()`` calls with RS256 bearer tokens over 1,024 distinct
     claim sets, one in 32 a bad token (a flipped signature byte, expired,
     a foreign issuer, a key the JWKS lacks); every good token's result
     held to the oracle with its deny provenance, every bad one
     UNAUTHENTICATED without a batch row, one launch and a pad × W
     readback per batch, the [256, W] readback on this corpus byte-equal
     to plain; the full and introspection configs as expected (the
     wristband verifies against its JWKS, its ``sub`` is the SHA-256 of
     the identity, one callback per check); then checks/s (median of TIMED_RUNS
     runs) beside phase 6's, p50/p99 under the burst and alone, the host
     time of an RS256 verify, an ES256 verify and an ES256 wristband sign,
     and the kernel's device time on this corpus beside its bound;
  9. the engine's serving core at the reference's defaults (batch dedup,
     a 32,768-entry verdict cache, a 48-batch completion-driven window,
     admission): phase 8's translated entries and minted tokens through a
     default engine; the same 4,096-Check() burst twice, every result
     equal to phase 8's oracle and every batch held to the structural
     contract (one launch for a batch with a device row, none for one the
     cache answered whole, D2H = pad_u × W, rows = device rows + rows
     saved by dedup + by the cache), the second burst mostly from the
     cache; one dedup-selected [pad_u, W] readback byte-equal to plain and
     fanned out equal to the whole batch's; a burst with one good request
     in eight doomed by a deadline inside one device round trip (each
     DEADLINE_EXCEEDED with no batch row, the rest equal to the oracle); a
     burst against a queue cap of 64 (the excess RESOURCE_EXHAUSTED, typed
     and counted); then checks/s (median of TIMED_RUNS), burst and lone p50/p99,
     device rows and the rows saved by dedup and by the cache, each run
     beside one of phase 8's engine (dedup and cache off) in the same
     call, and beside phase 8's figures.

 10. the control plane (``models/control_plane.py``): 1,000 API-key
     AuthConfigs with ``northstar``'s rules (half v1beta1, half v1beta2),
     their 1,000 Secrets, 16 x509 AuthConfigs trusting an RSA-2048 and a
     P-256 CA Secret (keys and certificates made from a seed with the
     port's own keys and certificate writer) and one
     ``opa.externalPolicy`` AuthConfig on a loopback registry: (a) as
     manifests through ``YamlDirSource`` into a default engine — a
     Check() during the bootstrap answers 503 "Busy", a burst of 4,096
     (API keys valid and unknown; good, other-organization, expired and
     foreign-CA client certificates) equals the oracle, one rule flipped
     in its file is served after one sync, 64 API keys rotated with no
     swap, the RSA CA's removal rejects its clients, and a policy changed
     in the registry is followed after one TTL with no reconcile; (b) the
     same corpus through ``K8sWatchSource`` and ``RestCluster`` against a
     loopback API server (a 410 and a dropped watch; two leader-elected
     status writers, exactly one of which writes, every AuthConfig
     Ready); (c) waves of Check()s while three reconciles alternate
     between two corpora that differ in 100 rules, every verdict equal to
     the oracle of its batch's generation, and device memory over ten
     swaps within one snapshot's upload of its value at the swap that
     fills the engine's bounded snapshot history; the [256, W] readback
     on this corpus byte-equal to plain; host RSS, each snapshot's
     native-encoder build inside its reconcile, and the encoder of every
     snapshot swapped out of the history gone after the ten swaps;
 11. the per-batch host work on either side of the launch, on the
     north-star corpus at full width: (a) host time per batch of the
     native encoder (dict walk, JSON, JSON from bytes) and the Python
     encoder at B = 256 and 16, in turns, every array byte-equal across
     them; (b) phase 6's 4,096-Check() burst through a native-encoding
     and a Python-encoding engine in turns (checks/s, burst and lone
     p50/p99, batch latency p50/p99), every result equal to the oracle;
     (c), inside phases 6 and 9 (dedup and cache off, then on): the rule
     heat map over the checked bursts equal to the host oracle's firing
     columns, the dead-rule report equal to the oracle's never-fired set,
     the decision records within the sampler's bound.


 12. the serving surfaces, at phase 10's full width: the port's CLI
     (``cli.run_server``, at its defaults: gRPC through the native
     frontend where it starts, each line naming the server that answered)
     as a task on this loop over phase 10's manifests
     plus a wristband and a SpiceDB config (a fake CheckPermission server
     on loopback): (a) the bootstrap — an in-process Check() meets the
     deny-all, a gRPC one finds no listener yet (the listeners bind after
     the first reconcile, as the reference's), then /readyz turns 200;
     (b) phase 10 (a)'s 4,096 requests encoded by the port's protobuf
     codec and sent at once over one gRPC channel, each response's code
     and HTTP status the oracle's and its bytes those of the in-process
     Check()'s response, 256 API-key requests over HTTP /check held to the
     oracle the same way, every batch to the structural contract; (c) gRPC
     health, /metrics, /debug/vars, the wristband's OIDC discovery and
     JWKS, the webhooks server converting and validating a review, SpiceDB
     allow and deny; (d) gRPC checks/s (``SERVE_BURSTS`` timed), burst and
     lone p50/p99 beside phase 10 (a)'s ``engine.check()`` figures, the
     codec's host µs per Check(); then the server drained by cancelling
     its task; (e) ``python3 -m authorino_tpu_torch server`` as a
     subprocess over 16 API-key configs and a config whose callback keeps
     each Check() in flight after its verdict: 32 gRPC and 8 HTTP Check()s
     equal to the oracle, its log naming the CUDA device, SIGTERM with 64
     Check()s in flight — all 64 answered, exit 0 within --drain-timeout
     + 5 s.  Its server runs with ``--slo-ms`` and ``--flight-dir``: its
     /metrics must carry every family of the observability planes and its
     /debug/vars their sections (phase 13 (e));
 13. the observability planes, on phase 6's translated north-star corpus
     at full width through an engine at the serving defaults, the flight
     recorder on: (c) 4,096-Check() bursts, each with an SLO target of its
     own (the phase's lone-Check() p50, 1 ns: every request bad, 10 s:
     none, the p50 of the burst before: some, retried at most 5 times
     until a run lands strictly inside), the tracker's total
     and bad equal to the script's own count over the latencies the engine
     hands it and to ``auth_server_slo_*``; (f) planes on and off in
     alternating pairs; (d) warm bursts with the admission target at 1 µs
     until admission entered OVERLOADED 3 times: one bundle per entry and
     none of another kind, ``--flight-keep`` of them on disk, schema 1,
     the engine's debug vars with ``kernel_cost`` and an exposition whose
     engine launch count equals the ledger's; (a) the cost ledger's
     deltas over the phase equal the batch records' sums and the
     wrapper's launch count, one launch per batch with a device row; (b)
     the package's kernel-cost model equal to ``own_config_ops`` on every
     config and to ``kernel_work`` on a 256-row batch, printed beside the
     bound and the kernel's time on that batch, and the model's time at
     the swap beside the upload phase;
 14. the failure handling, on phase 6's translated corpus at full width
     through an engine with dedup and the cache off, ``breaker_threshold``
     3, ``breaker_reset_s`` 0.5, ``device_timeout_s`` 0.25, every anomaly
     dumped (``smoke_out/flight-14``), the fault plane armed part by part:
     (a) ``device-down`` — lone Check()s trip the breaker after 3
     failures, then a 4,096-Check() burst the host oracle answers exactly
     with no launch, its degraded rows equal to the ledger's host rows and
     the metric's delta, a ``breaker-open`` bundle, the oracle's checks/s
     and µs per row beside phase 13's cold burst; (b)
     ``kernel:raise:for=1`` — closed → open → half-open → closed, the time
     from the fault's end to ``closed``, each half-open probe batch a real
     launch whose readback is byte-equal to plain; (c) ``kernel:hang`` —
     wedged 256-row batches, each 2 watchdog timeouts then the exact
     oracle answer, device memory back to its value before them; (d)
     ``slow-device`` — lone batches' readbacks at least the delay late,
     nothing degraded, the breaker closed; (e) ``flaky`` under a seed — a
     burst, exact, retries + failure-degraded batches equal to the
     plane's firings; (f) ``python3 -m authorino_tpu_torch server
     --fault-profile device-down --breaker-threshold 1`` on 16 API-key
     configs: gRPC Check()s exact, /readyz reports the open circuit.
     Every other phase ends with the fault plane off, no breaker
     transition and no degraded row;
 15. the native gRPC frontend (``runtime/native_frontend.py`` over
     ``native/csrc/frontend.cpp``), its start failing loudly: (a) the
     extension with frontend.cpp and the load generator built by g++, the
     libnghttp2 it opened; (b) the reference's wire corpus (1,000
     anonymous AuthConfigs x 10 leaves, 4,096 payloads of
     random.Random(5)) at the serving defaults and with dedup and the
     cache off, and 1,000 API-key configs of the three fast kinds
     (``models/wire_corpus.py::build_key_entries``: the key alone, a rule
     over the key's role, that rule with an identity-templated denial)
     with 4,096 requests carrying their own key, another config's or
     none: every native answer byte-equal to the port's grpc.aio
     server's on the same engine and its code the oracle's, every request
     on the fast lane, one launch per slot with a device row, the first
     frontend batch of each pad of 256 rows or more (max_batch, the
     saturation passes', among them) byte-equal to plain; phase 12's
     mixed corpus (1,019 configs, all on the slow lane) byte-equal to
     grpc.aio on its engine; (c) the C++ load generator
     (``native/csrc/loadgen.cpp``) at run_native_mode's shape (max_batch
     4,096, window 2,000 µs, 24 slots, 10 dispatch threads): one native
     saturation pass (depth 8,000 x 5 connections, after a warm-up
     pass; grpc.aio answers nothing at that depth within a pass), then
     one native and one grpc.aio pass (one server process) at
     run_native_mode's light shape (1,024 in flight, 5 s after 2
     s of warm-up), at both settings: checks/s, p50/p99, rows per batch
     and per launched batch, launches, device rows; (d) a shallow pass of
     each side (16 in flight over 1,024 requests); (e) stop() under load
     answers every request it received and refuses later ones
     UNAVAILABLE, then ``python3 -m authorino_tpu_torch server
     --native-frontend on`` as a process drained by SIGTERM with 64
     Check()s in flight; (f) ``device-down``: every fast-lane request
     UNAVAILABLE, 0 degraded;
 16. the native frontend's verified-credential cache and hybrid lane
     (``dyn_frontend``) over one card engine holding phase 8's 1,000
     ``jwt-{i}`` configs (entries and minted tokens reused), phase 10's 16
     x509 configs, an OAuth2-introspection and a Kubernetes TokenReview
     config under a 2 s cache opt-in and 1,000 hybrid configs (the wire
     rule beside a procedural Rego at priority 1,
     ``models/wire_corpus.py::hybrid_auth_configs``): (a) with the
     verdict cache and dedup off, then at the defaults, a first pass of
     phase 8's distinct (host, token) pairs verifies and registers on the
     slow lane (checks/s, host µs per registration), the cycled 4,096
     requests ride the fast lane (share of good tokens >= 0.95, bad
     tokens never fast, one launch per slot with a device row), every
     code phase 8's oracle's and every answer byte-equal to the grpc.aio
     server's; the C++ load generator at 1,024 in flight over the
     registered tokens (checks/s, p50/p99); (c) a token of exp 4 s ahead
     answers UNAUTHENTICATED on the slow lane past exp and the verifier's
     leeway, with the verdict cache warm; (d) phase 10's certificates
     slow at first sight, fast on repeat; (e) the introspection and
     TokenReview calls per check across the opt-in's TTL: 1, 0, 1, 0;
     (f) 4,096 hybrid requests: kernel denials native, PASSes decided by
     the pipeline, ``authconfig_total`` once per request; (b) a JWKS
     rotation under traffic: no answer OK to a token of the retired key
     after the swap; byte-equal to plain: the first frontend batch of
     each pad of 256 rows or more in (a), (b) and (c), and of each pad in
     (d), (e) and (f), at least one in each of (a), (d), (e) and (f).
 17. the incremental reconcile (the per-config compile cache, the
     snapshot diff, the delta upload of the mega-kernel's params) and the
     snapshot container, at full width: (a) the north-star corpus through
     a card engine, installed cold, again unchanged, then with one config
     changed at a time (a constant: every operand keeps its shape and the
     plan ships rows; a leaf more: ``cfg_off`` shifts; a regex more: the
     DFA image changes): each compile report (1,000, 0, then the one config
     by name), each plan's mode and bytes (the constant's under half a full
     upload), the previous params' tensors untouched (pointers and bytes),
     the new params equal to a full upload of the same policy, and the
     [256, W] readback of all 4,096 docs byte-equal to the full upload's,
     to plain and to a cold compile and upload of the same corpus; (d)
     the installed policy serialized, deserialized, uploaded and launched
     on: its params equal and its readbacks byte-equal to the installed
     snapshot's, with the blob's size and the serialize / deserialize ms;
     (b) phase 6's 1,000 translated configs at the serving defaults: a
     warm burst, one config's method flipped (at least 95% of the warm
     cache's rows still served, the changed config's 64 probes all on the
     new rule), then ten one-config swaps under 4,096 Check()s, every
     verdict the oracle's of its generation, one launch per batch with a
     device row, device memory beside what the serving snapshot and the
     engine's bounded snapshot history hold +0 B over the swaps; (c)
     phase 10's 1,000 API-key manifests and their Secrets through
     ``YamlDirSource``: one file changed, from the write to the first
     Check() on the new rule, split into manifest parse, translate and
     the install (compile, native encoder, diff, upload), beside the same
     state through a cold engine.
 18. change safety (canary swaps split by cohort, guard-breach rollback,
     poison-config quarantine, the bounded snapshot history,
     ``/debug/canary``): phase 6's 1,000 translated configs in one card
     engine at the serving defaults with the canary at fraction 0.25 and
     a 3 s window and a native frontend attached, phase 6's 4,096
     Check()s plus 1,024 to one hot host over 64 paths: (a) one config's
     constant changes: every verdict the oracle's of its cohort's
     generation and every request's cohort the port's
     ``in_canary_cohort`` of its document, launches = the (cut, cohort)
     parts with a device row, both generations' params on the card,
     promotion at the window's end with one frontend refresh; checks/s
     and p50/p99 beside a burst with no canary (each on as many requests
     the cache has not seen, after an untimed warm-up burst); (b) the hot
     config flipped to deny beside a benign change: the guard breaches
     in the window, the engine rolls back and quarantines exactly the hot
     config, the benign change lands, ``detect_ms``/``recover_ms`` and the
     flight bundle's time apart, every verdict after it the quarantined
     corpus's oracle, ``/debug/canary`` and ``/readyz`` through the
     port's aiohttp app, ``clear-quarantine``; (d) a drain mid-canary
     leaves it undecided; (c) a second engine with ``snapshot_history``
     4: eight one-config swaps (device memory +0 B over the four past a
     full history), then ``rollback_last`` until it returns False: four
     rollbacks, each compiling 0 configs, uploading 0 B, launching no
     probe and re-serving readbacks byte-equal to that generation's.
 19. the tenant QoS plane (weighted-fair cuts, per-tenant quotas and
     doomed shedding, containment with a contained tenant's rows as parts
     of their own on the card, ``/debug/tenants``): (a) 96 wire-corpus
     tenants weighted 4/2/1 by annotation, 4,096 requests at once through
     ``submit``, ``check()`` and the native frontend on a card engine with
     max_batch 64 and two batches in flight: every verdict and attribution
     equal to a CPU engine's (the plain version) and the oracle's, the
     fair cut's shares within the deficit round robin's bound, each
     tenant's requests and denies in the plane equal to the sent, on both
     lanes; (b) the reference's acceptance regime (``bench.py``
     ``run_tenancy_mode``): the north-star corpus, the slow-device fault
     profile, max_batch 16, dedup and the cache off, every 9th request on
     tenant 0 at 0.6x the closed-loop rate, a pass with no burst, then
     tenant 0 at x10 mid-window (x20, x40 while containment has not
     fired): the cold tenants' goodput and p99 ratios beside the
     reference's bounds (>= 0.9, <= 1.5), the rejections' types and scope,
     containment's fire, release and flight bundle, the contained parts'
     launches, sampled verdicts; (c) the same with no fault, reported with
     the device stage's share of a batch; (d) a quota'd tenant answered
     RESOURCE_EXHAUSTED naming it while the others' verdicts stand, and a
     canaried change of it breaching ``tenant-rejection-rate`` and
     rolling back; (e) phase 6's burst with the plane on and off, and
     device memory across the phase.
 20. the metadata prefetch cache, traffic capture with the replay
     pregate, and strict verify: (a) phase 6's 1,000 configs, each with a
     request-independent ``http`` metadata document of a local server
     and a rule on one of its fields, 4,096 ``check()``s with prefetch on
     and off: every code the oracle's, one GET per pinned document at
     the pin and none per request with it on, one per request with it
     off; (b) capture at 1-in-1 on phase 6's engine over a hot host's
     requests and phase 6's: each captured firing column (the kernel's
     readback) the host oracle's, a replay old against old with 0 flips,
     the segments read back equal; (c) the replay pregate rejects a
     poison on the hot config before its canary (+0 B, no launch, the old
     generation exact) and passes a clean churn into a canary with
     halved deny thresholds; (d) strict verify's validate phase and
     certificate-cache counts, three planted mutants each rejected with
     +0 B and no launch, the self-tests green; (e) the CLI with
     ``--capture --replay-pregate --strict-verify``: ``/debug/replay``
     and ``/debug/vars``.
 21. snapshot distribution, the durable state plane and the corpus
     pregate, at the north-star width (1,000 configs): (a) a
     strict-verify leader publishes; a replica on the card installs the
     blob without compiling and answers 4,096 submits with the leader's
     verdicts, a one-config republish lands as a delta that keeps the
     leader's verdict-cache share, an uncertified and a torn blob are
     each rejected typed with +0 B and no launch, one [256, W] readback
     byte-equal to the leader's and the plain version's; (b) the kill
     harness (``runtime/restart_harness.py``, ``--device cuda``) SIGKILLed
     mid-reconcile restarts bit-exact from its state dir, and the time to
     the first verdict warm against cold; (c) the corpus pregate rejects
     an edit that only synthetic witnesses catch before the upload (+0 B,
     no launch) and passes a clean one.
 22. the gather and matmul kernel lanes, the staged baseline and the
     analysis CLI: (a) on the north-star corpus and phases 7's and 8's
     corpora at B = 256, the gather lane, the matmul lane (bf16 operands),
     the staged baseline, the mega-kernel and its plain version give
     byte-equal readbacks, and on planted Ands of 300 and 2,100 children
     with ids past 2^11 under TF32, each beside Ands of 5 and 3 children
     in its level whose TRUE padding bf16 or TF32 cannot hold; (b) each lane's device time (one call, back to
     back), CUDA kernels per batch and operand bytes; (c) the CLI server
     with ``--kernel-lane matmul`` (4,096 ``engine.check()``s, 1,024 gRPC
     Check()s on the native fast lane) and ``gather``: codes the
     oracle's, ``auth_server_kernel_lane_total`` counting the batches,
     the mega-kernel flat; ``auto`` arms fused on the card; (d)
     ``python -m authorino_tpu_torch.analysis`` as processes: the lint
     and fixture self-tests, the metrics catalogue, ``--snapshot-diff``
     over phase 21's generations and ``--replay`` of phase 20's capture.
 23. the mesh lane on logical slots of the card and the fleet of card
     replicas (``mesh_and_fleet``).
 24. the host lanes (``host_lanes``): (a) a card engine at its defaults
     over phase 6's corpus (its compile cache: nothing compiles again),
     phase 6's 4,096 Check()s and 64 lone ones held to the oracle, lane
     selection and brownout ``enabled: false``, no row on a host lane, by
     brownout or speculation, every cut ``device/disabled``, one
     mega-kernel launch per batch with a device row, the cost model's
     device RTT EWMA fed; ``lane_select=True`` on a card raises, the CLI
     refuses ``--lane-host-max-rows 8`` on a card; (b) CPU engines in
     this process at the reference's defaults: the burst's cuts on the
     plain version, the lone checks on the host lane, a one-batch
     window's burst decided in part by brownout, every verdict equal to
     (a)'s, no launch.

Phases 10, 17, 18 and 21 run in a side process (``side_main``), started
where phase 10 stood and joined before phase 22 (which reads phase 21's
generations): they share no state with phases 11-16, 19 and 20, so the
two processes overlap; the side process's lines are printed, prefixed
``[side]``, when it joins.  Server processes that a phase drives late
(12 (e), 14 (f), 15 (e) and its grpc.aio processes, 20 (e)) start at the
phase's start (``ServerStart``), and phase 8's keys and tokens are made
during phase 2's compilers.

Every phase that serves batches names the encoder that served them
(native by mode, or Python and why) and fails if it is not the one the
reference would pick: native for phases 4, 6, 8-10 and 12, Python for
phase 7's numeric lanes.  The kernels' launch counts in the summary are
phase 24's ((a): the card engine's batches and its install's probe), with
every phase's under ``launches_by_phase``; each kernel must have launched
on the paths of phases 4, 6, 7, 8, 9, 10, 12-24, with the counts zeroed
just before each (in the side process for its phases).  An earlier line
gives each phase's seconds, the side process's beside them.

The last lines are the kernels' JSON summary, the card line and
``{"ok": true, "device": {...}}``.  Everything measured also goes to
``smoke_out/chip_smoke.json`` (gitignored).
"""

from __future__ import annotations

import asyncio
import json
import random
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
# H100 SXM peak INT32 rate, 33.5 TOPS (NVIDIA H100 Tensor Core GPU
# Architecture whitepaper, SXM5 column; an IMAD counted as two operations)
INT32_OPS_PER_S = 33.5e12
T0 = time.monotonic()


class PhaseClock:
    """Seconds each phase of ``main`` took: ``start(name)`` closes the
    running phase and opens ``name`` (None closes the last)."""

    def __init__(self):
        self.seconds = {}
        self._name, self._t = None, time.monotonic()

    def start(self, name) -> None:
        now = time.monotonic()
        if self._name is not None:
            self.seconds[self._name] = round(now - self._t, 1)
        self._name, self._t = name, now


def log(msg: str) -> None:
    print(f"[{time.monotonic() - T0:7.1f}s] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi printed no card")
    return out[0]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def kernel_vs_plain(params, db, dev, **instance):
    """One launch against the plain version on the same card, same inputs;
    returns the max abs byte difference.  With no ``instance`` keywords the
    launch goes through the wrapper as the engine calls it; else straight
    to ``launch_kernel`` with them (``global_tables``)."""
    import torch

    from authorino_tpu_torch.ops import fused_kernel as fk
    from authorino_tpu_torch.ops.operands import check_batch, defuse, fuse_batch

    buf, layout = fuse_batch(db)
    buf_dev = torch.from_numpy(buf).to(dev)
    if instance:
        check_batch(params, db)
        got = torch.empty((db.attrs_val.shape[0],
                           fk.packed_width(1 + 2 * params["eval_rule"].shape[1])),
                          dtype=torch.uint8, device=dev)
        fk.launch_kernel(params, buf_dev, layout, got, **instance)
    else:
        got = fk.eval_fused_kernel(params, db)
    want = fk.fused_packed_plain(params, defuse(buf_dev, layout))
    return max_byte_err(got, want)


def max_byte_err(got, want) -> int:
    """Max abs difference of two [B, W] uint8 results (raises unless 0)."""
    import torch

    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != torch.uint8:
        raise AssertionError(f"kernel output {tuple(got.shape)} {got.dtype} "
                             f"vs plain {tuple(want.shape)}")
    err = int((got.int() - want.int()).abs().max().item()) if got.numel() else 0
    if err != 0:
        bad = (got != want).any(dim=1).nonzero().flatten()[:8].tolist()
        raise AssertionError(f"kernel disagrees with plain on rows {bad}")
    return err


def device_times_ms(fn, n: int, warm: int = 3):
    """Per-call device times, ms: CUDA events around each call, with the
    stream held busy (``torch.cuda._sleep``) while the host enqueues the
    call, so the events time the device's work and not the host's Python.
    Also returns the host's median enqueue time of one call, ms."""
    import torch

    host = []
    for _ in range(warm):
        t = time.perf_counter()
        fn()
        host.append(time.perf_counter() - t)
        torch.cuda.synchronize()
    # hold the stream for 4x the host's enqueue time (at >= 1 GHz)
    cycles = int(max(1e-3, 4 * max(host)) * 1e9)
    times = []
    for _ in range(n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        s.record()
        t = time.perf_counter()
        fn()
        host.append(time.perf_counter() - t)
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return times, statistics.median(host) * 1e3


def wall_times_ms(fn, n: int, warm: int = 3):
    """Host wall time of ``fn`` through a synchronise, ms per call."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return times


def enqueue_ms(fns: dict, rounds: int = 600) -> dict:
    """Host time of one call of each ``fns`` entry, ms: the calls taken in
    turns, round after round, so a shared host's drift hits all alike;
    median over rounds.  Launches enqueue without waiting, with a
    synchronise every 50 rounds to keep the queue short."""
    import torch

    times = {k: [] for k in fns}
    for r in range(rounds):
        for k, fn in fns.items():
            t = time.perf_counter()
            fn()
            times[k].append((time.perf_counter() - t) * 1e3)
        if r % 50 == 49:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return {k: statistics.median(v) for k, v in times.items()}


def sleep_cycles_per_ms() -> float:
    """The SM clock under a spin: ``torch.cuda._sleep(n)`` spins n clock64()
    cycles, timed here with CUDA events (median of 5)."""
    import torch

    n, rates = 20_000_000, []
    for _ in range(5):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        torch.cuda._sleep(n)
        e.record()
        e.synchronize()
        rates.append(n / s.elapsed_time(e))
    return statistics.median(rates)


def back_to_back_ms(fn, cycles_per_ms: float, n: int = 200):
    """Device time per call of ``n`` calls enqueued back to back between one
    event pair, ms.  A ``torch.cuda._sleep`` in front holds the stream
    until all n are enqueued, so the events see the device's work and not
    the host's Python; returns (ms per call, sleep covered the enqueue)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(20):
        fn()
    host_ms = (time.perf_counter() - t) / 20 * 1e3
    torch.cuda.synchronize()
    hold_ms = 3 * n * host_ms + 1
    for _ in range(3):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(hold_ms * cycles_per_ms))
        s.record()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        enq_ms = (time.perf_counter() - t) * 1e3
        e.record()
        e.synchronize()
        if enq_ms < hold_ms:
            return s.elapsed_time(e) / n, True
        hold_ms = 2 * enq_ms
    return s.elapsed_time(e) / n, False


def stamp_phases(launch, B: int, names, cycles_per_us: float, dev):
    """Median over rows of each phase's clock64() cycles, from one stamped
    launch after 3 warm ones; rows without a config (no stamps) are
    skipped.  Returns {phase: (cycles, us)} plus the median and the
    largest total of a row."""
    import numpy as np
    import torch

    stamps = torch.zeros((B, 8), dtype=torch.int64, device=dev)
    for _ in range(4):
        stamps.zero_()
        launch(stamps)
    torch.cuda.synchronize()
    st = stamps.cpu().numpy()[:, :len(names) + 1]
    st = st[(st > 0).all(axis=1)]
    if not len(st):
        raise AssertionError("the stamped launch wrote no stamps")
    d = np.diff(st, axis=1)
    out = {}
    for k, name in enumerate(names):
        cyc = float(np.median(d[:, k]))
        out[name] = (cyc, cyc / cycles_per_us)
    total = st[:, -1] - st[:, 0]
    for name, cyc in (("total", np.median(total)), ("slowest row", total.max())):
        out[name] = (float(cyc), float(cyc) / cycles_per_us)
    return out


def fmt_phases(ph) -> str:
    return ", ".join(f"{k} {c:.0f} cyc / {u:.3f} us" for k, (c, u) in ph.items())


PHASES = ("prologue", "leaves", "copy wait", "DFA walk", "circuit",
          "verdict")


def own_config_ops(params, K: int, LB: int):
    """Integer operations one request needs, per config: a row's output is
    only its own config's verdict, rule[E] and skipped[E], so it needs the
    leaves and circuit nodes its config's evaluators reach, and the DFA
    rows those leaves read.  A leaf costs one compare or lookup (K for a
    membership leaf), a DFA row LB table steps plus its accept lookup, a
    node one operation per child that is not its padding, an evaluator 3."""
    import numpy as np

    from authorino_tpu_torch.compiler.compile import (
        OP_EXCL, OP_INCL, OP_REGEX_DFA)

    fz = params["fused"]
    op = fz["leaf_op_i8"].cpu().numpy()
    L = op.size
    leaf_cost = np.where(np.isin(op, (OP_INCL, OP_EXCL)), K, 1)
    dfa_pos = (fz["leaf_dfa_pos"].cpu().numpy()
               if LB and fz.get("leaf_dfa_pos") is not None else None)
    node_children, is_and = [], []
    for ch, ia in params["levels"]:
        node_children.extend(ch.cpu().numpy())
        is_and.extend(ia.cpu().numpy())
    cond = params["eval_cond"].cpu().numpy()
    rule = params["eval_rule"].cpu().numpy()
    has_cond = params["eval_has_cond"].cpu().numpy()
    G, E = rule.shape
    per_config = np.zeros(G, dtype=np.int64)
    for g in range(G):
        stack = list(rule[g]) + list(cond[g][has_cond[g]])
        seen, dfa_rows, ops = set(), set(), 3 * E
        while stack:
            i = int(stack.pop())
            if i < 2 or i in seen:
                continue
            seen.add(i)
            if i < 2 + L:
                ops += int(leaf_cost[i - 2])
                if dfa_pos is not None and op[i - 2] == OP_REGEX_DFA:
                    dfa_rows.add(int(dfa_pos[i - 2]))
                continue
            n = i - 2 - L
            pad = 0 if is_and[n] else 1
            kids = [int(c) for c in node_children[n] if c != pad]
            ops += len(kids)
            stack.extend(kids)
        per_config[g] = ops + len(dfa_rows) * (LB + 1)
    return per_config


def kernel_work(params, db):
    """Bytes the kernel must move and the integer operations this batch's
    rows need, both by the own-config rule (a row's output is only its own
    config's verdict, so it reads only its own config's program).

    Bytes, each read once: the staging buffer but its ``cpu_dense`` block;
    the ``cpu_dense`` columns the rows' own CPU-lane leaves read; the
    program of each config present in the batch (its ``cfg_off`` row, its
    leaf, node, DFA-row, child and level-end records and its evaluator
    words); the DFA image when a present config reads a DFA row; the
    [B, W] output.  Operations: ``own_config_ops`` of each row's config.
    A pad row with no config needs neither."""
    import numpy as np

    from authorino_tpu_torch.ops.operands import staged_h2d_bytes

    kp = params["kernel"]
    off = kp["cfg_off"].cpu().numpy().astype(np.int64)
    cpu_col = kp["leaf_rec"].cpu().numpy()[:, 3]
    G, E = params["eval_rule"].shape
    cid = np.asarray(db.config_id, dtype=np.int64)
    own = cid[(cid >= 0) & (cid < G)]
    present = np.unique(own)
    count = off[present + 1, :5] - off[present, :5]
    leaves, nodes, dfa_rows, levels, kids = count.sum(axis=0)
    program = (present.size * (off.shape[1] * 4 + E * 4)
               + 16 * (leaves + nodes + dfa_rows) + 4 * (kids + levels))
    image = kp["dfa_image"]
    if dfa_rows and image is not None:
        program += image.numel()
    cpu_cols = np.array([int((cpu_col[off[g, 0]:off[g + 1, 0]] >= 0).sum())
                         for g in range(G)], dtype=np.int64)
    staging = staged_h2d_bytes(db)
    if db.cpu_dense is not None:
        staging += (int(cpu_cols[own].sum()) * db.cpu_dense.itemsize
                    - db.cpu_dense.nbytes)
    W = (1 + 2 * E + 7) // 8
    moved = staging + int(program) + db.attrs_val.shape[0] * W

    has_dfa = params["dfa_tables"] is not None and db.attr_bytes is not None
    per_config = own_config_ops(params, db.members_c.shape[2],
                                db.attr_bytes.shape[2] if has_dfa else 0)
    return int(moved), int(per_config[own].sum())


def bound_ms(moved: int, ops: int):
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


async def serve(engine, docs, names):
    return await asyncio.gather(*(engine.submit(d, n)
                                  for d, n in zip(docs, names)))


# phases 4 and 6-8 run with batch dedup and the verdict cache off, so every
# row reaches the kernel and their figures compare with earlier runs
NO_REUSE = {"verdict_cache_size": 0, "batch_dedup": False}
# timed runs of phases 5-9's checks/s and latency figures after each
# phase's checked run: the port's benchmark cells carry the repetitions,
# this script the exactness and one sample
TIMED_RUNS = 1


def checked_records(engine, start: int = 0):
    """The engine's per-batch records from ``start`` on, each held to the
    structural contract: one launch for a batch with a device row and none
    for one the cache answered whole, the device rows padded to a power of
    two >= 16, D2H = pad x W, rows = device rows + rows saved by dedup +
    rows saved by the cache + degraded rows + host rows (a batch the host
    oracle decided, a CPU engine's host lane or brownout, has no launch).
    Raises on the first batch that breaks it."""
    from authorino_tpu_torch.utils import bucket_pow2

    W = engine._snapshot.policy.fused_pack_w
    on_card = engine.device.type == "cuda"
    recs = list(engine.batch_records)[start:]
    for r in recs:
        u = r["device_rows"]
        want = {"launches": int(u > 0 and on_card),
                "plain_calls": int(u > 0 and not on_card),
                "pad_rows": bucket_pow2(u) if u else 0,
                "d2h_bytes": (bucket_pow2(u) if u else 0) * W,
                "rows": (u + r["dedup_rows"] + r["cache_rows"]
                         + r["degraded_rows"] + r.get("host_rows", 0))}
        got = {k: r[k] for k in want}
        if got != want:
            raise AssertionError(f"batch breaks the structural contract: "
                                 f"{r} (expected {want})")
        if not engine.batch_dedup and engine._verdict_cache is None \
                and not {"degraded", "host_lane", "brownout"} & set(r) \
                and u != r["rows"]:
            raise AssertionError(f"a row skipped the kernel with dedup and "
                                 f"the cache off: {r}")
    return recs


# ---------------------------------------------------------------------------
# the per-batch host work on either side of the launch: which encoder
# served a phase's batches, and the rule heat map against the oracle
# ---------------------------------------------------------------------------


def reset_host_counts() -> None:
    """Zero the native encoder's process-wide batch counts (beside
    ``fk.reset_counts()`` at the start of a phase's counted window)."""
    from authorino_tpu_torch.native.encoder import reset_totals

    reset_totals()


def encoder_used(engine, batches: int) -> dict:
    """Which encoder served the ``batches`` encoded since the counts were
    zeroed: the native encoder's batches by mode and those it handed back,
    the rest Python's, with the reason ``engine``'s corpus took it."""
    from authorino_tpu_torch.native.encoder import TOTALS, out_of_domain

    t = dict(TOTALS)
    native = t["object"] + t["json"]
    why = None
    if batches > native:
        policy = engine._snapshot.policy
        why = (out_of_domain(policy) if policy is not None else None) or (
            "native off (AUTHORINO_TPU_NATIVE=0)"
            if getattr(policy, "_native_encoder", None) is False
            else "handed back")
    return {"batches": batches, "native_object": t["object"],
            "native_json": t["json"], "handed_back": t["bailed"],
            "python": batches - native, "python_why": why}


def fmt_encoder(u: dict) -> str:
    parts = [f"{label} {u[k]}" for k, label in
             (("native_object", "native object"),
              ("native_json", "native JSON")) if u[k]]
    if u["python"]:
        parts.append(f"Python {u['python']} ({u['python_why']})")
    back = f", {u['handed_back']} handed back" if u["handed_back"] else ""
    return f"encoder: {', '.join(parts) or 'none'} of {u['batches']} " \
           f"batches{back}"


def require_encoder(label: str, u: dict, want: str) -> None:
    """``want`` is "native" (every batch native, none handed back) or the
    reason every batch took the Python encoder."""
    native = u["native_object"] + u["native_json"]
    if want == "native":
        ok = (native == u["batches"] > 0 and not u["python"]
              and not u["handed_back"])
    else:
        ok = native == 0 and u["python"] == u["batches"] > 0 and \
            u["python_why"] == want
    if not ok:
        raise AssertionError(f"{label}: expected the {want} encoder: {u}")


def watch_heat(engine):
    """Open an observed window on ``engine``'s heat map: flush every live
    heat map, clear the process-wide fired set, and record every row
    submitted (the wrapper is the engine's own ``submit``)."""
    from authorino_tpu_torch.runtime import provenance as prov

    prov.flush_heatmaps()
    prov._reset_fired_for_tests()
    seen = []
    inner = engine.submit

    async def submit(doc, name, **kw):
        seen.append((doc, name))
        return await inner(doc, name, **kw)

    engine.submit = submit
    heat = engine._snapshot.heat
    return (seen, heat._counts.copy(), heat.fold_calls,
            prov.DECISIONS.records_total)


def check_heat(label: str, engine, window) -> dict:
    """Close the window: the heat map's counts over it equal the host
    oracle's firing column of every submitted row (the expression trees,
    not the kernel), the dead-rule report's never-fired set equals the
    registered rules the oracle never saw fire, and the decision records
    stay within the sampler's bound (at most one per authconfig per
    batch)."""
    import numpy as np

    from authorino_tpu_torch.models.policy_model import host_results
    from authorino_tpu_torch.ops.operands import firing_columns
    from authorino_tpu_torch.runtime import provenance as prov

    del engine.submit   # the class's own again
    seen, counts0, folds0, records0 = window
    snap = engine._snapshot
    heat, policy = snap.heat, snap.policy
    want = {}
    for doc, name in seen:
        row = policy.config_ids[name]
        _, rule, skipped = host_results(policy, doc, row)
        col = int(firing_columns(rule[None, :], skipped[None, :])[0])
        if col >= 0:
            want[(row, col)] = want.get((row, col), 0) + 1
    delta = heat._counts - counts0
    got = {divmod(int(k), heat.E + 1): int(delta[k])
           for k in np.nonzero(delta)[0]}
    if got != want:
        diff = sorted(set(got.items()) ^ set(want.items()))[:8]
        raise AssertionError(f"{label}: heat map != oracle on "
                             f"{len(set(got.items()) ^ set(want.items()))} "
                             f"(row, rule) counts, e.g. {diff}")
    report = prov.dead_rule_report(heat, None, limit=1 << 30)
    fired = {(heat.names_by_row[r], c) for r, c in want}
    oracle_never = sorted(
        (name, prov.rule_label(col, src))
        for name, col, src in heat.registered_rules()
        if (name, col) not in fired)
    got_never = sorted((d["authconfig"], d["rule"])
                       for d in report["never_fired"])
    if got_never != oracle_never:
        raise AssertionError(f"{label}: the dead-rule report's "
                             f"{len(got_never)} never-fired rules != the "
                             f"oracle's {len(oracle_never)}")
    folds = heat.fold_calls - folds0
    records = prov.DECISIONS.records_total - records0
    bound = min(len(seen), folds * len({name for _, name in seen}))
    if not 0 <= records <= bound:
        raise AssertionError(f"{label}: {records} decision records over "
                             f"{folds} folds, bound {bound}")
    return {"rows": len(seen), "denials": sum(want.values()),
            "pairs_fired": len(want), "rules_total": report["rules_total"],
            "never_fired": report["never_fired_count"], "folds": folds,
            "decision_records": records, "records_bound": bound,
            "sample_n": prov.DECISIONS.sample_n}


# ---------------------------------------------------------------------------
# phases 6 and 7: the Check() request path
# ---------------------------------------------------------------------------

# the AuthConfig of the control-plane tests: an API key from a cluster
# Secret with an anonymous fallback, a named pattern, a top-level `when`, a
# custom `unauthorized` and a json success header
V2_HOST = "talker-api.example.com"
V2_SPEC = {
    "hosts": [V2_HOST],
    "patterns": {"admin-path": [{"selector": "request.url_path",
                                 "operator": "matches", "value": "^/admin"}]},
    "when": [{"selector": "request.method", "operator": "neq",
              "value": "OPTIONS"}],
    "authentication": {
        "api-clients": {
            "apiKey": {"selector": {"matchLabels": {"audience": "talker-api"}}},
            "credentials": {"authorizationHeader": {"prefix": "APIKEY"}}},
        "anon": {"anonymous": {}, "priority": 1},
    },
    "authorization": {"admin-only": {
        "patternMatching": {"patterns": [{"any": [
            {"selector": "auth.identity.metadata.labels.role",
             "operator": "eq", "value": "admin"},
            {"selector": "auth.identity.anonymous", "operator": "neq",
             "value": "true"}]}]},
        "when": [{"patternRef": "admin-path"}]}},
    "response": {
        "unauthorized": {"code": 302, "message": {"value": "redirect"}},
        "success": {"headers": {"x-auth": {"json": {"properties": {
            "user": {"selector": "auth.identity.anonymous"}}}}}},
    },
}
V2_KEY = {"authorization": "APIKEY secret-key-1"}
# (host, method, path, headers) -> (code, HTTP status override, message)
V2_CHECKS = [
    ((V2_HOST, "GET", "/admin/x", V2_KEY), (0, 0, "")),
    ((V2_HOST, "GET", "/admin/x", {}), (7, 302, "redirect")),
    ((V2_HOST, "GET", "/public", {}), (0, 0, "")),
    ((V2_HOST, "OPTIONS", "/admin/x", {}), (0, 0, "")),
    ((V2_HOST + ":8000", "GET", "/admin/x", V2_KEY), (0, 0, "")),
    (("unknown.example.com", "GET", "/admin/x", V2_KEY),
     (5, 0, "Service not found")),
]


async def timed_checks(engine, requests):
    """Every request's Check() at once; (result, seconds) per request."""
    async def one(req):
        t = time.perf_counter()
        res = await engine.check(req)
        return res, time.perf_counter() - t

    return await asyncio.gather(*(one(r) for r in requests))


def request_path(report: dict, card: str, ctx: dict) -> dict:
    """Phase 6: translate 1,000 north-star AuthConfigs and the V2 config
    with a card engine, install them in one snapshot, answer 4,096
    concurrent north-star Check()s and the V2 checks, hold every result
    (and the heat map over them) to the expression oracle, then time three
    more runs.  Returns the kernel launch counts of the checked run
    (counts zeroed just before it); leaves in ``ctx`` what phase 11
    reuses."""
    import numpy as np

    from authorino_tpu_torch.authjson import (CheckRequestModel,
                                              HttpRequestAttributes,
                                              build_authorization_json)
    from authorino_tpu_torch.controllers import translate_auth_config
    from authorino_tpu_torch.k8s import InMemoryCluster, Secret
    from authorino_tpu_torch.models import northstar
    from authorino_tpu_torch.ops import fused_kernel as fk
    from authorino_tpu_torch.runtime import PolicyEngine
    from authorino_tpu_torch.utils import rpc

    acs = northstar.build_auth_configs(1000, 10)
    rules = [c.evaluators[0][1] for c in northstar.build_corpus(1000, 10)]
    ns_reqs = northstar.build_check_requests(4096, 1000)
    v2_reqs = [CheckRequestModel(http=HttpRequestAttributes(
        method=m, path=path, host=h, headers=dict(hd)))
        for (h, m, path, hd), _ in V2_CHECKS]
    cluster = InMemoryCluster()
    cluster.put_secret(Secret(
        name="client-1", namespace="tenant",
        labels={"audience": "talker-api", "role": "admin"},
        data={"api_key": b"secret-key-1"}))

    fk.reset_counts()
    reset_host_counts()
    engine = PolicyEngine(max_batch=256, **NO_REUSE)

    async def translate_all():
        entries = [await translate_auth_config(
            o["metadata"]["name"], o["metadata"]["namespace"], o["spec"],
            engine=engine) for o in acs]
        entries.append(await translate_auth_config(
            "ac", "tenant", V2_SPEC, cluster=cluster, engine=engine))
        return entries

    t = time.perf_counter()
    entries = asyncio.run(translate_all())
    t_translate = time.perf_counter() - t
    t = time.perf_counter()
    engine.apply_snapshot(entries)
    t_install = time.perf_counter() - t
    window = watch_heat(engine)
    t = time.perf_counter()
    out = asyncio.run(timed_checks(engine, ns_reqs + v2_reqs))
    first_wall = time.perf_counter() - t
    launches = {"fused_megakernel": fk.launches,
                "probe_add_one": fk.probe_launches}
    heat = check_heat("request path", engine, window)

    st = dict(engine.stats)
    enc = encoder_used(engine, st["batches"])
    require_encoder("request path", enc, "native")
    W = engine._snapshot.policy.fused_pack_w
    if st["failed_batches"]:
        raise AssertionError(f"{st['failed_batches']} batches failed: {st}")
    if not (st["launches"] == st["batches"] == fk.launches
            == len(checked_records(engine))):
        raise AssertionError(f"launches {fk.launches} vs batches {st}")
    if st["d2h_bytes"] != st["pad_rows"] * W:
        raise AssertionError(f"D2H {st['d2h_bytes']} != pad x W ({st})")
    if fk.probe_launches < 1:
        raise AssertionError("probe kernel did not run at snapshot install")

    jwt = northstar.JWT_FILTER

    def hold(out, label="request path", idx=None) -> int:
        """Every north-star result against the expression oracle with its
        deny provenance; returns how many were allowed.  ``idx`` is each
        result's request index (by default 0, 1, ...; results past the
        north-star requests are not held here)."""
        allowed = 0
        for k, (res, _) in zip(range(len(ns_reqs)) if idx is None else idx,
                               out):
            req = ns_reqs[k]
            if res.code == rpc.UNAVAILABLE:
                raise AssertionError(f"{label}: check {k} answered "
                                     f"UNAVAILABLE: {res}")
            i = int(req.http.host.split(".")[0][len("svc-"):])
            claims = req.metadata_context["filter_metadata"][jwt][
                "verified_jwt"]
            doc = build_authorization_json(req, {"identity": claims})
            if rules[i].matches(doc):
                want = (rpc.OK, 0, "", {})
                allowed += 1
            else:
                want = (rpc.PERMISSION_DENIED, 0, "Unauthorized", {
                    "ext_authz_provenance": {
                        "authconfig": f"{northstar.NAMESPACE}/cfg-{i}",
                        "rule_index": 0, "rule": str(rules[i]),
                        "lane": "engine"}})
            got = (res.code, res.status, res.message, res.metadata)
            if got != want:
                raise AssertionError(f"{label}: check {k} on cfg-{i}: {got} "
                                     f"!= oracle {want}")
        return allowed

    allowed = hold(out)
    for ((host, *_), want), (res, _) in zip(V2_CHECKS, out[len(ns_reqs):]):
        if (res.code, res.status, res.message) != want:
            raise AssertionError(f"V2 check on {host}: {res} != {want}")
    log(f"request path: 1001 AuthConfigs translated in {t_translate:.2f}s, "
        f"installed in {t_install:.2f}s; {len(out)} concurrent Check()s -> "
        f"{st['batches']} batches, {fk.launches} mega-kernel launches, "
        f"{fk.probe_launches} probe, D2H {st['d2h_bytes']} B = pad "
        f"{st['pad_rows']} x W {W}; every code equals the oracle "
        f"({allowed} of 4096 north-star allowed, every denial attributed), "
        f"the V2 checks as expected (NOT_FOUND for the unknown host, "
        f":port stripped); {fmt_encoder(enc)}; heat map over the "
        f"{heat['rows']} rows equal to the oracle's {heat['denials']} "
        f"denials on {heat['pairs_fired']} rules, dead-rule report equal "
        f"to its {heat['never_fired']} never-fired of {heat['rules_total']}, "
        f"{heat['decision_records']} decision records (bound "
        f"{heat['records_bound']})")
    ctx.update(engine=engine, entries=entries, reqs=ns_reqs, hold=hold)

    runs = []
    for _ in range(TIMED_RUNS):
        b0, r0 = engine.stats["batches"], engine.stats["rows"]
        t = time.perf_counter()
        timed = asyncio.run(timed_checks(engine, ns_reqs))
        wall = time.perf_counter() - t
        runs.append({"checks_per_s": len(ns_reqs) / wall,
                     "latency_s": [x for _, x in timed],
                     "batches": engine.stats["batches"] - b0,
                     "rows": engine.stats["rows"] - r0})
    lat = np.sort(np.concatenate([r["latency_s"] for r in runs])) * 1e3
    rates = [r["checks_per_s"] for r in runs]

    async def one_at_a_time(reqs):
        return [(await timed_checks(engine, [r]))[0][1] for r in reqs]

    # a lone Check(): nothing else in flight, a batch of one row
    lone = np.sort(asyncio.run(one_at_a_time(ns_reqs[:200]))) * 1e3
    n_batches = sum(r["batches"] for r in runs)
    numbers = {
        "card": card, "configs": len(entries), "checks": len(out),
        "translate_s": t_translate, "install_s": t_install,
        "first_run_wall_s": first_wall, "allowed": allowed,
        "stats_checked_run": st, "encoder": enc, "heat": heat,
        "checks_per_s": rates,
        "checks_per_s_median": statistics.median(rates),
        "check_latency_ms_p50": float(np.percentile(lat, 50)),
        "check_latency_ms_p99": float(np.percentile(lat, 99)),
        "batches_timed": n_batches,
        "mean_rows_per_batch": sum(r["rows"] for r in runs) / n_batches,
        "lone_check_latency_ms_p50": float(np.percentile(lone, 50)),
        "lone_check_latency_ms_p99": float(np.percentile(lone, 99)),
    }
    report["request_path"] = numbers
    return launches


def opa_oracle(entry, doc):
    """(code, status, message, metadata) the OPA corpus's config answers
    for ``doc``: the pattern first (priority 0), with its deny provenance,
    then the inline Rego's ``allow`` (priority 1)."""
    from authorino_tpu_torch.utils import rpc

    pattern = entry.rules.evaluators[0][1]
    if not pattern.matches(doc):
        return (rpc.PERMISSION_DENIED, 0, "Unauthorized", {
            "ext_authz_provenance": {
                "authconfig": entry.id, "rule_index": 0,
                "rule": str(pattern), "lane": "engine"}})
    opa = entry.runtime.authorization[1].evaluator
    if not opa._module.evaluate(doc, data=opa.data)["allow"]:
        return (rpc.PERMISSION_DENIED, 0, "Unauthorized", {})
    return (rpc.OK, 0, "", {})


def opa_path(report: dict, card: str, dev, cycles_per_ms: float) -> dict:
    """Phase 7: translate the OPA corpus and the Kubernetes config with a
    card engine, answer 4,096 concurrent Check()s and the Kubernetes
    checks, hold every result, every lowered kernel slot and the kernel's
    readback to their oracles, then time the path.  Returns the kernel
    launch counts of the checked run (counts zeroed just before it) and
    the mega-kernel's max abs byte error on this corpus."""
    import numpy as np
    import torch

    from authorino_tpu_torch.authjson import build_authorization_json
    from authorino_tpu_torch.compiler.encode import encode_batch
    from authorino_tpu_torch.compiler.pack import pack_batch
    from authorino_tpu_torch.controllers import translate_auth_config
    from authorino_tpu_torch.evaluators.authorization.rego_lower import (
        lower_verdict)
    from authorino_tpu_torch.k8s import InMemoryCluster
    from authorino_tpu_torch.models import opa_corpus
    from authorino_tpu_torch.models.northstar import JWT_FILTER
    from authorino_tpu_torch.ops import fused_kernel as fk
    from authorino_tpu_torch.ops.operands import fuse_batch
    from authorino_tpu_torch.runtime import PolicyEngine
    from authorino_tpu_torch.utils import rpc

    acs = opa_corpus.build_auth_configs(1000)
    reqs = opa_corpus.build_check_requests(4096, 1000)
    k8s = opa_corpus.k8s_check_requests()
    cluster = InMemoryCluster()
    reviews, allowed_triples = opa_corpus.k8s_cluster_data()
    cluster.token_reviews.update(reviews)
    cluster.access_reviews = opa_corpus.k8s_access_review(allowed_triples)

    fk.reset_counts()
    reset_host_counts()
    engine = PolicyEngine(max_batch=256, **NO_REUSE)

    async def translate_all():
        entries = [await translate_auth_config(
            o["metadata"]["name"], o["metadata"]["namespace"], o["spec"],
            engine=engine) for o in acs]
        k = opa_corpus.k8s_auth_config()
        entries.append(await translate_auth_config(
            k["metadata"]["name"], k["metadata"]["namespace"], k["spec"],
            cluster=cluster, engine=engine))
        return entries

    t = time.perf_counter()
    entries = asyncio.run(translate_all())
    t_translate = time.perf_counter() - t
    t = time.perf_counter()
    engine.apply_snapshot(entries)
    t_install = time.perf_counter() - t
    t = time.perf_counter()
    out = asyncio.run(timed_checks(engine, reqs + [r for r, _ in k8s]))
    first_wall = time.perf_counter() - t
    launches = {"fused_megakernel": fk.launches,
                "probe_add_one": fk.probe_launches}
    # the corpus has numeric lanes: the Python encoder, as the reference
    # decides
    enc = encoder_used(engine, engine.stats["batches"])
    require_encoder("OPA path", enc, "numeric lanes")

    st = dict(engine.stats)
    snap = engine._snapshot
    W = snap.policy.fused_pack_w
    if st["failed_batches"] or st["plain_calls"]:
        raise AssertionError(f"failed or plain batches: {st}")
    per_batch = checked_records(engine)
    if not (st["launches"] == st["batches"] == fk.launches == len(per_batch)):
        raise AssertionError(f"launches {fk.launches} vs batches {st}")
    if st["d2h_bytes"] != st["pad_rows"] * W:
        raise AssertionError(f"D2H {st['d2h_bytes']} != pad x W ({st})")
    if fk.probe_launches < 1:
        raise AssertionError("probe kernel did not run at snapshot install")

    lowered = [e for e in entries[:-1]
               if e.runtime.authorization[1].evaluator.kernel_slot is not None]
    docs, rows = [], []
    allowed = opa_denied = 0
    for k, (req, (res, _)) in enumerate(zip(reqs, out)):
        if res.code == rpc.UNAVAILABLE:
            raise AssertionError(f"check {k} answered UNAVAILABLE: {res}")
        i = int(req.http.host.split(".")[0][len("opa-"):])
        claims = req.metadata_context["filter_metadata"][JWT_FILTER][
            "verified_jwt"]
        doc = build_authorization_json(req, {"identity": claims})
        docs.append(doc)
        rows.append(i)
        want = opa_oracle(entries[i], doc)
        got = (res.code, res.status, res.message, res.metadata)
        if got != want:
            raise AssertionError(f"check {k} on opa-{i}: {got} != oracle "
                                 f"{want}")
        allowed += res.code == rpc.OK
        opa_denied += res.code != rpc.OK and not res.metadata
    if not 0 < allowed < len(reqs) or not opa_denied:
        raise AssertionError(f"degenerate verdicts: {allowed} allowed, "
                             f"{opa_denied} denied by the Rego policy")
    k8s_codes = {"allowed": rpc.OK, "denied": rpc.PERMISSION_DENIED,
                 "unauthenticated": rpc.UNAUTHENTICATED}
    for (req, outcome), (res, _) in zip(k8s, out[len(reqs):]):
        if res.code != k8s_codes[outcome]:
            raise AssertionError(f"Kubernetes check {req.http.headers}: "
                                 f"{res.code} {res.message} != {outcome}")

    # every lowered config's kernel slot against the lowered expression and
    # the interpreter: each request's doc on its own config, and 8 docs on
    # every lowered config
    pairs = [(d, entries[i]) for d, i in zip(docs, rows)
             if entries[i].runtime.authorization[1].evaluator.kernel_slot
             is not None]
    pairs += [(docs[(j * 8 + t) % len(docs)], e)
              for j, e in enumerate(lowered) for t in range(8)]

    async def submit_all():
        return await asyncio.gather(*(engine.submit(d, e.id)
                                      for d, e in pairs))

    bits = asyncio.run(submit_all())
    relowered = {e.id: lower_verdict(
        e.runtime.authorization[1].evaluator._module) for e in lowered}
    both = set()
    for (doc, e), (rule, skipped) in zip(pairs, bits):
        opa = e.runtime.authorization[1].evaluator
        slot = opa.kernel_slot
        allow = bool(opa._module.evaluate(doc, data=opa.data)["allow"])
        low = relowered[e.id].matches(doc)
        if skipped[slot] or bool(rule[slot]) != low or low != allow:
            raise AssertionError(
                f"{e.id} slot {slot}: kernel {bool(rule[slot])} skipped "
                f"{bool(skipped[slot])}, lowered {low}, interpreter {allow}")
        both.add(allow)
    if both != {True, False}:
        raise AssertionError(f"lowered slots took only {both}")

    # the mega-kernel on this corpus against its plain version
    policy, params = snap.policy, snap.params
    db = pack_batch(policy, encode_batch(
        policy, docs[:256], [policy.config_ids[entries[i].id]
                             for i in rows[:256]]))
    max_err = max(kernel_vs_plain(params, db, dev),
                  kernel_vs_plain(params, db, dev, global_tables=True))
    LANE_CORPORA["opa"] = (policy, db)   # phase 22 (a)
    buf, layout = fuse_batch(db)
    buf_dev = torch.from_numpy(buf).to(dev)
    kout = torch.empty((256, W), dtype=torch.uint8, device=dev)
    launch = (lambda: fk.launch_kernel(params, buf_dev, layout, kout))
    k_ms, _ = device_times_ms(launch, 100)
    k_b2b, _ = back_to_back_ms(launch, cycles_per_ms)
    moved, ops = kernel_work(params, db)
    k_bound, k_by = bound_ms(moved, ops)
    log(f"OPA path: {len(entries)} AuthConfigs translated in "
        f"{t_translate:.2f}s ({len(lowered)} of {len(acs)} Rego policies "
        f"lowered), installed in {t_install:.2f}s; {len(out)} concurrent "
        f"Check()s -> {st['batches']} batches, "
        f"{launches['fused_megakernel']} mega-kernel launches, "
        f"{launches['probe_add_one']} probe, D2H {st['d2h_bytes']} B = pad "
        f"{st['pad_rows']} x W {W}; every result equals the oracle "
        f"({allowed} of {len(reqs)} allowed, {opa_denied} denied by Rego), "
        f"the Kubernetes checks as expected; {len(pairs)} lowered-slot bits "
        f"equal the lowered expression and the interpreter; B=256 readback "
        f"byte-equal to plain; {fmt_encoder(enc)}")

    runs = []
    for _ in range(TIMED_RUNS):
        b0, r0 = engine.stats["batches"], engine.stats["rows"]
        t = time.perf_counter()
        timed = asyncio.run(timed_checks(engine, reqs))
        wall = time.perf_counter() - t
        runs.append({"checks_per_s": len(reqs) / wall,
                     "latency_s": [x for _, x in timed],
                     "batches": engine.stats["batches"] - b0,
                     "rows": engine.stats["rows"] - r0})
    lat = np.sort(np.concatenate([r["latency_s"] for r in runs])) * 1e3
    rates = [r["checks_per_s"] for r in runs]

    async def one_at_a_time(rs):
        return [(await timed_checks(engine, [r]))[0][1] for r in rs]

    lone = np.sort(asyncio.run(one_at_a_time(reqs[:200]))) * 1e3
    # the interpreter's host time: one evaluate per Check() whose pattern
    # passed (the Rego evaluator runs after it), timed alone
    ev_s, ev_n = 0.0, 0
    for d, i in zip(docs, rows):
        e = entries[i]
        if e.rules.evaluators[0][1].matches(d):
            opa = e.runtime.authorization[1].evaluator
            t = time.perf_counter()
            opa._module.evaluate(d, data=opa.data)
            ev_s += time.perf_counter() - t
            ev_n += 1
    n_batches = sum(r["batches"] for r in runs)
    numbers = {
        "card": card, "configs": len(entries),
        "lowered": len(lowered), "lowered_share": len(lowered) / len(acs),
        "checks": len(out), "translate_s": t_translate,
        "install_s": t_install, "first_run_wall_s": first_wall,
        "allowed": allowed, "denied_by_rego": opa_denied,
        "slot_bits_checked": len(pairs), "stats_checked_run": st,
        "encoder": enc,
        "checks_per_s": rates,
        "checks_per_s_median": statistics.median(rates),
        "check_latency_ms_p50": float(np.percentile(lat, 50)),
        "check_latency_ms_p99": float(np.percentile(lat, 99)),
        "batches_timed": n_batches,
        "mean_rows_per_batch": sum(r["rows"] for r in runs) / n_batches,
        "lone_check_latency_ms_p50": float(np.percentile(lone, 50)),
        "lone_check_latency_ms_p99": float(np.percentile(lone, 99)),
        "rego_evaluate_us_per_check": ev_s / len(docs) * 1e6,
        "rego_evaluate_us_per_call": ev_s / max(ev_n, 1) * 1e6,
        "rego_evaluate_calls": ev_n,
        "kernel_ms_median": statistics.median(k_ms),
        "kernel_back_to_back_ms": k_b2b,
        "kernel_bytes_moved": moved, "kernel_int_ops": ops,
        "bound_ms": k_bound, "bound_by": k_by, "max_abs_err": max_err,
    }
    report["opa_path"] = numbers
    return launches, max_err


def jwt_oracle(entry_id, rule, doc):
    """(code, status, message, metadata) a ``jwt-{i}`` config answers for
    ``doc``: its one rule, with its deny provenance."""
    from authorino_tpu_torch.utils import rpc

    if rule.matches(doc):
        return (rpc.OK, 0, "", {})
    return (rpc.PERMISSION_DENIED, 0, "Unauthorized", {
        "ext_authz_provenance": {"authconfig": entry_id, "rule_index": 0,
                                 "rule": str(rule), "lane": "engine"}})


def host_us(fn, n: int) -> float:
    """Median host microseconds of ``fn()`` over ``n`` calls."""
    times = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    return statistics.median(times) * 1e6


def jwt_full_checks(engine, idp, keys, entries):
    """The full and introspection configs' checks: an ES256 admin token
    on a registered resource (allowed, with a wristband), an RS256 viewer
    token and a resource UMA does not know (denied by the pattern over
    the identity and ``auth.metadata.*``), an active and an inactive
    opaque token.  Raises unless each answers as expected."""
    import hashlib

    from authorino_tpu_torch.authjson import (CheckRequestModel,
                                              HttpRequestAttributes)
    from authorino_tpu_torch.models import oidc_corpus as oc
    from authorino_tpu_torch.utils import jose, rpc

    admin = {"org": "org-7", "realm_access": {"roles": ["admin"]}}
    es256 = idp.token(admin, alg="ES256")

    def req(host, token, path="/pets"):
        return CheckRequestModel(http=HttpRequestAttributes(
            method="GET", path=path, host=host,
            headers={"authorization": f"Bearer {token}"}))

    cases = [
        (req(oc.FULL_HOST, es256), rpc.OK),
        (req(oc.FULL_HOST, idp.token(dict(admin, realm_access={
            "roles": ["viewer"]}))), rpc.PERMISSION_DENIED),
        (req(oc.FULL_HOST, es256, path="/orders"), rpc.PERMISSION_DENIED),
        (req(oc.INTROSPECTION_HOST, "opaque-active"), rpc.OK),
        (req(oc.INTROSPECTION_HOST, "opaque-unknown"), rpc.UNAUTHENTICATED),
    ]
    n_callbacks = len(idp.callbacks)

    async def run_all():
        return [await engine.check(r) for r, _ in cases]

    out = asyncio.run(run_all())
    for (r, want), res in zip(cases, out):
        if res.code != want:
            raise AssertionError(f"{r.http.host}{r.http.path}: {res.code} "
                                 f"{res.message} != {want}")
    full = next(e for e in entries if e.id == f"{oc.NAMESPACE}/full")
    wristband = full.runtime.response[0].evaluator
    token = out[0].headers[0]["x-wristband"]
    claims = jose.verify_jws(token, json.loads(wristband.jwks())["keys"])
    identity = jose.verify_jws(es256, idp.jwks)
    sub = hashlib.sha256(json.dumps(identity, separators=(",", ":"),
                                    sort_keys=True).encode()).hexdigest()
    if (claims["iss"], claims["sub"], claims["org"]) != (
            oc.WRISTBAND_ISSUER, sub, "org-7"):
        raise AssertionError(f"wristband claims {claims}")
    if len(idp.callbacks) - n_callbacks != 3:
        raise AssertionError(f"{len(idp.callbacks) - n_callbacks} callbacks "
                             f"for 3 checks on the full config")
    return es256, wristband


def jwt_material() -> dict:
    """Phase 8's keys (pure Python, from a seed), its running fake
    Keycloak and the 4,096 requests with their minted tokens.  Made on a
    thread during phase 2, whose compilers leave the interpreter idle."""
    from authorino_tpu_torch.models import oidc_corpus as oc

    t = time.perf_counter()
    keys = oc.make_keys(42)
    keygen_s = time.perf_counter() - t
    idp = oc.FakeKeycloak(keys).start()
    t = time.perf_counter()
    reqs, kinds, claims = oc.build_check_requests(idp, 4096, 1000)
    return {"keys": keys, "keygen_s": keygen_s, "idp": idp, "reqs": reqs,
            "kinds": kinds, "claims": claims,
            "mint_s": time.perf_counter() - t}


def jwt_path(report: dict, card: str, dev, cycles_per_ms: float,
             ctx: dict) -> dict:
    """Phase 8: keys and a fake Keycloak, the Keycloak RBAC corpus
    translated with a card engine, 4,096 concurrent Check()s with RS256
    tokens (one in 32 bad) held to the oracle, the full and introspection
    configs, the kernel's readback on this corpus against plain, then the
    path's numbers.  Returns the kernel launch counts of the checked run
    (counts zeroed just before it) and the mega-kernel's max abs byte
    error on this corpus.  Leaves in ``ctx`` what phase 9 reuses: the
    running fake Keycloak (the caller stops it), the engine, its entries,
    the requests and each one's oracle answer."""
    import numpy as np
    import torch

    from authorino_tpu_torch.authjson import build_authorization_json
    from authorino_tpu_torch.compiler.encode import encode_batch
    from authorino_tpu_torch.compiler.pack import pack_batch
    from authorino_tpu_torch.controllers import translate_auth_config
    from authorino_tpu_torch.k8s import InMemoryCluster, Secret
    from authorino_tpu_torch.models import northstar
    from authorino_tpu_torch.models import oidc_corpus as oc
    from authorino_tpu_torch.ops import fused_kernel as fk
    from authorino_tpu_torch.ops.operands import fuse_batch
    from authorino_tpu_torch.runtime import PolicyEngine
    from authorino_tpu_torch.utils import jose, rpc

    jm = ctx.pop("jwt_material", None) or jwt_material()
    keys, t_keygen, t_mint = jm["keys"], jm["keygen_s"], jm["mint_s"]
    idp = ctx["idp"] = jm["idp"]
    reqs, kinds, claims = jm["reqs"], jm["kinds"], jm["claims"]
    n_tokens = len({r.http.headers["authorization"]
                    for r, k in zip(reqs, kinds) if k is None})
    log(f"JWT path: keys made in {t_keygen:.2f}s (2 x RSA-2048, 2 x "
        f"P-256, pure Python), {n_tokens} RS256 tokens + "
        f"{sum(map(bool, kinds))} bad ones minted in {t_mint:.2f}s")
    rules = [c.evaluators[0][1] for c in northstar.build_corpus(1000, 10)]
    cluster = InMemoryCluster()
    for sec in oc.cluster_secrets(keys):
        cluster.put_secret(Secret(**sec))
    specs = (oc.build_auth_configs(1000, 10, idp.issuer)
             + [oc.full_auth_config(idp.issuer),
                oc.introspection_auth_config(idp.issuer)])

    fk.reset_counts()
    reset_host_counts()
    engine = PolicyEngine(max_batch=256, **NO_REUSE)

    async def translate_all():
        return [await translate_auth_config(
            o["metadata"]["name"], o["metadata"]["namespace"], o["spec"],
            cluster=cluster, engine=engine) for o in specs]

    t = time.perf_counter()
    entries = asyncio.run(translate_all())
    t_translate = time.perf_counter() - t
    t = time.perf_counter()
    engine.apply_snapshot(entries)
    t_install = time.perf_counter() - t
    t = time.perf_counter()
    out = asyncio.run(timed_checks(engine, reqs))
    first_wall = time.perf_counter() - t
    launches = {"fused_megakernel": fk.launches,
                "probe_add_one": fk.probe_launches}
    enc = encoder_used(engine, engine.stats["batches"])
    require_encoder("JWT path", enc, "native")

    st = dict(engine.stats)
    snap = engine._snapshot
    W = snap.policy.fused_pack_w
    n_good = sum(k is None for k in kinds)
    if st["failed_batches"] or st["plain_calls"]:
        raise AssertionError(f"failed or plain batches: {st}")
    per_batch = checked_records(engine)
    if not (st["launches"] == st["batches"] == fk.launches
            == len(per_batch)):
        raise AssertionError(f"launches {fk.launches} vs batches {st}")
    if st["d2h_bytes"] != st["pad_rows"] * W:
        raise AssertionError(f"D2H {st['d2h_bytes']} != pad x W ({st})")
    if st["rows"] != n_good:
        raise AssertionError(f"{st['rows']} batch rows for {n_good} good "
                             f"tokens: a bad token reached a batch")
    if fk.probe_launches < 1:
        raise AssertionError("probe kernel did not run at snapshot install")

    docs, rows, oracle = [], [], []
    allowed = 0
    for k, (req, kind, c, (res, _)) in enumerate(zip(reqs, kinds, claims,
                                                     out)):
        i = int(req.http.host.split(".")[0][len("jwt-"):])
        if kind is not None:
            oracle.append(kind)
            if res.code != rpc.UNAUTHENTICATED:
                raise AssertionError(f"check {k}: a {kind} token answered "
                                     f"{res.code} {res.message}")
            continue
        doc = build_authorization_json(req, {"identity": c})
        docs.append(doc)
        rows.append(i)
        want = jwt_oracle(entries[i].id, rules[i], doc)
        oracle.append(want)
        got = (res.code, res.status, res.message, res.metadata)
        if got != want:
            raise AssertionError(f"check {k} on jwt-{i}: {got} != oracle "
                                 f"{want}")
        allowed += res.code == rpc.OK
    if not 0 < allowed < n_good:
        raise AssertionError(f"degenerate verdicts: {allowed} of {n_good}")
    es256, wristband = jwt_full_checks(engine, idp, keys, entries)

    # the mega-kernel on this corpus against its plain version
    policy, params = snap.policy, snap.params
    db = pack_batch(policy, encode_batch(
        policy, docs[:256], [policy.config_ids[entries[i].id]
                             for i in rows[:256]]))
    max_err = max(kernel_vs_plain(params, db, dev),
                  kernel_vs_plain(params, db, dev, global_tables=True))
    LANE_CORPORA["keycloak"] = (policy, db)   # phase 22 (a)
    buf, layout = fuse_batch(db)
    buf_dev = torch.from_numpy(buf).to(dev)
    kout = torch.empty((256, W), dtype=torch.uint8, device=dev)
    launch = (lambda: fk.launch_kernel(params, buf_dev, layout, kout))
    k_ms, _ = device_times_ms(launch, 100)
    k_b2b, _ = back_to_back_ms(launch, cycles_per_ms)
    moved, ops = kernel_work(params, db)
    k_bound, k_by = bound_ms(moved, ops)
    n_jwt = sum(c.type == "JWT" for e in entries for c in e.runtime.identity)
    log(f"JWT path: {len(entries)} AuthConfigs translated in "
        f"{t_translate:.2f}s ({n_jwt} OIDC discoveries over loopback), "
        f"installed in {t_install:.2f}s; {len(out)} concurrent Check()s "
        f"-> {st['batches']} batches, {launches['fused_megakernel']} "
        f"mega-kernel launches, {launches['probe_add_one']} probe, D2H "
        f"{st['d2h_bytes']} B = pad {st['pad_rows']} x W {W}; every good "
        f"token's result equals the oracle ({allowed} of {n_good} "
        f"allowed), the {len(out) - n_good} bad tokens UNAUTHENTICATED "
        f"with no batch row; the full config (ES256, userInfo, http, uma, "
        f"wristband, callback) and introspection as expected; B=256 "
        f"readback byte-equal to plain; {fmt_encoder(enc)}")

    runs = []
    for _ in range(TIMED_RUNS):
        b0, r0 = engine.stats["batches"], engine.stats["rows"]
        t = time.perf_counter()
        timed = asyncio.run(timed_checks(engine, reqs))
        wall = time.perf_counter() - t
        runs.append({"checks_per_s": len(reqs) / wall,
                     "latency_s": [x for _, x in timed],
                     "batches": engine.stats["batches"] - b0,
                     "rows": engine.stats["rows"] - r0})
    lat = np.sort(np.concatenate([r["latency_s"] for r in runs])) * 1e3
    rates = [r["checks_per_s"] for r in runs]

    async def one_at_a_time(rs):
        return [(await timed_checks(engine, [r]))[0][1] for r in rs]

    good = [r for r, k in zip(reqs, kinds) if k is None]
    lone = np.sort(asyncio.run(one_at_a_time(good[:200]))) * 1e3
    rs256 = good[0].http.headers["authorization"][len("Bearer "):]
    sign_claims = {"iss": oc.WRISTBAND_ISSUER, "sub": "x" * 64,
                   "iat": 0, "exp": 300, "org": "org-7"}
    wb_key = wristband.signing_keys[0]
    host = {
        "rs256_verify_us": host_us(
            lambda: jose.verify_jws(rs256, idp.jwks), 200),
        "es256_verify_us": host_us(
            lambda: jose.verify_jws(es256, idp.jwks), 50),
        "es256_wristband_sign_us": host_us(
            lambda: jose.sign_jwt(sign_claims, wb_key.private_key,
                                  "ES256", kid=wb_key.kid), 50),
    }
    ctx.update(engine=engine, entries=entries, reqs=reqs, oracle=oracle,
               docs=docs, rows=rows, keys=keys)
    n_batches = sum(r["batches"] for r in runs)
    numbers = {
        "card": card, "configs": len(entries), "checks": len(out),
        "good_tokens": n_good, "distinct_tokens": n_tokens,
        "keygen_s": t_keygen, "mint_s": t_mint, "oidc_discoveries": n_jwt,
        "translate_s": t_translate, "install_s": t_install,
        "first_run_wall_s": first_wall, "allowed": allowed,
        "stats_checked_run": st, "encoder": enc,
        "checks_per_s": rates,
        "checks_per_s_median": statistics.median(rates),
        "check_latency_ms_p50": float(np.percentile(lat, 50)),
        "check_latency_ms_p99": float(np.percentile(lat, 99)),
        "batches_timed": n_batches,
        "mean_rows_per_batch": sum(r["rows"] for r in runs) / n_batches,
        "lone_check_latency_ms_p50": float(np.percentile(lone, 50)),
        "lone_check_latency_ms_p99": float(np.percentile(lone, 99)),
        **host,
        "kernel_ms_median": statistics.median(k_ms),
        "kernel_back_to_back_ms": k_b2b,
        "kernel_bytes_moved": moved, "kernel_int_ops": ops,
        "bound_ms": k_bound, "bound_by": k_by, "max_abs_err": max_err,
    }
    report["jwt_path"] = numbers
    return launches, max_err


# ---------------------------------------------------------------------------
# phase 9: the serving core at the reference's defaults
# ---------------------------------------------------------------------------


def bind(entries, engine) -> None:
    """Point every pattern evaluator of ``entries`` at ``engine``'s
    provider and attributor for its config (the translate binding), so
    phase 8's translated entries serve through another engine."""
    from authorino_tpu_torch.evaluators.authorization import PatternMatching

    for e in entries:
        for conf in e.runtime.authorization:
            ev = conf.evaluator
            if isinstance(ev, PatternMatching):
                name = ev.batched_provider.config_name
                ev.batched_provider = engine.provider_for(name)
                ev.attributor = engine.attribution_for(name)


_ROW_KEYS = ("rows", "device_rows", "dedup_rows", "cache_rows", "batches",
             "cached_batches", "launches", "plain_calls", "deadline_shed",
             "failed_batches")


def serving_core(report: dict, card: str, dev, ctx: dict) -> dict:
    """Phase 9: phase 8's translated entries and minted tokens through an
    engine at the reference's defaults (dedup, a 32,768-entry verdict
    cache, a 48-batch window, admission).  Two identical 4,096-Check()
    bursts held to phase 8's oracle and, batch by batch, to the
    structural contract, the second mostly from the cache; the readback
    of one dedup-selected batch byte-equal to plain; a burst where one
    good request in eight has a deadline inside one device round trip
    (DEADLINE_EXCEEDED, no batch row) and the rest equal the oracle; a
    burst against a queue cap of 64 (the excess RESOURCE_EXHAUSTED, typed
    and counted); then checks/s, latencies and rows, each run beside one
    of phase 8's engine (dedup and cache off) in the same call.  Returns
    the kernel launch counts of the two bursts (counts zeroed just before
    the engine's install) and the max abs byte error of the selected
    batch."""
    import numpy as np

    from authorino_tpu_torch.compiler.encode import encode_batch
    from authorino_tpu_torch.compiler.pack import (batch_row_keys,
                                                   dedup_rows, pack_batch,
                                                   select_rows)
    from authorino_tpu_torch.ops import fused_kernel as fk
    from authorino_tpu_torch.runtime import PolicyEngine
    from authorino_tpu_torch.utils import bucket_pow2, rpc

    off, entries = ctx["engine"], ctx["entries"]
    reqs, oracle = ctx["reqs"], ctx["oracle"]
    good = [k for k, o in enumerate(oracle) if not isinstance(o, str)]

    def hold(out, label, skip=frozenset()):
        for k, (res, _) in enumerate(out):
            if k in skip:
                continue
            want = oracle[k]
            if isinstance(want, str):
                if res.code != rpc.UNAUTHENTICATED:
                    raise AssertionError(f"{label}: check {k}, a {want} "
                                         f"token, answered {res.code}")
                continue
            got = (res.code, res.status, res.message, res.metadata)
            if got != want:
                raise AssertionError(f"{label}: check {k}: {got} != oracle "
                                     f"{want}")

    def counted(engine, fn):
        st0, n0 = dict(engine.stats), len(engine.batch_records)
        t = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t
        recs = checked_records(engine, n0)
        d = {k: engine.stats[k] - st0[k] for k in _ROW_KEYS}
        if d["batches"] != len(recs) or d["failed_batches"]:
            raise AssertionError(f"batch records {len(recs)} vs {d}")
        return out, dict(d, wall_s=wall), recs

    fk.reset_counts()
    reset_host_counts()
    engine = PolicyEngine(max_batch=256)
    bind(entries, engine)
    t = time.perf_counter()
    engine.apply_snapshot(entries)
    t_install = time.perf_counter() - t
    bursts, rtt = [], 0.0
    window = watch_heat(engine)
    for b in range(2):
        out, d, _ = counted(engine, lambda: asyncio.run(
            timed_checks(engine, reqs)))
        hold(out, f"serving core burst {b + 1}")
        if d["rows"] != len(good):
            raise AssertionError(f"{d['rows']} batch rows for {len(good)} "
                                 f"good tokens")
        if b == 0:
            rtt = engine._device_ewma
        d["latency_s"] = [x for _, x in out]
        bursts.append(d)
    launches = {"fused_megakernel": fk.launches,
                "probe_add_one": fk.probe_launches}
    enc = encoder_used(engine, engine.stats["batches"])
    require_encoder("serving core", enc, "native")
    heat = check_heat("serving core", engine, window)
    if engine.stats["launches"] != fk.launches or not (
            bursts[0]["launches"] + bursts[0]["plain_calls"]):
        raise AssertionError(f"launches {fk.launches} vs {engine.stats}")
    if bursts[1]["cache_rows"] * 2 < len(good):
        raise AssertionError(f"the second burst was not served mostly from "
                             f"the cache: {bursts[1]}")
    log(f"serving core: default engine installed in {t_install:.2f}s; two "
        f"{len(reqs)}-Check() bursts equal the oracle, every batch keeps "
        f"the structural contract; burst 1: {bursts[0]['batches']} batches, "
        f"{bursts[0]['launches']} launches, {bursts[0]['device_rows']} "
        f"device rows, {bursts[0]['dedup_rows']} saved by dedup, "
        f"{bursts[0]['cache_rows']} by the cache; burst 2: "
        f"{bursts[1]['batches']} batches, {bursts[1]['launches']} launches, "
        f"{bursts[1]['device_rows']} device rows, {bursts[1]['dedup_rows']} "
        f"by dedup, {bursts[1]['cache_rows']} by the cache; "
        f"{fmt_encoder(enc)}; heat map over both bursts' {heat['rows']} "
        f"rows (dedup and cache on) equal to the oracle's {heat['denials']} "
        f"denials on {heat['pairs_fired']} rules, dead-rule report equal to "
        f"its {heat['never_fired']} never-fired of {heat['rules_total']}, "
        f"{heat['decision_records']} decision records (bound "
        f"{heat['records_bound']})")

    # one dedup-selected batch, as the engine builds it, against plain; and
    # its fanned-out readback against the whole batch's
    snap = engine._snapshot
    policy, params = snap.policy, snap.params
    docs = ctx["docs"][:128] * 2
    rows = [policy.config_ids[entries[i].id] for i in ctx["rows"][:128]] * 2
    db = pack_batch(policy, encode_batch(policy, docs, rows, batch_pad=256))
    unique, inverse = dedup_rows(batch_row_keys(db, 256), list(range(256)))
    pad_u = bucket_pow2(len(unique))
    db_u = select_rows(db, unique, batch_pad=pad_u)
    sel_err = max(kernel_vs_plain(params, db_u, dev),
                  kernel_vs_plain(params, db_u, dev, global_tables=True))
    whole = fk.eval_fused_kernel(params, db).cpu().numpy()
    part = fk.eval_fused_kernel(params, db_u).cpu().numpy()
    if len(unique) > 128 or not np.array_equal(part[inverse], whole):
        raise AssertionError(f"the dedup-selected batch ({len(unique)} "
                             f"unique rows) does not fan out to the whole")
    log(f"a dedup-selected batch: 256 rows -> {len(unique)} unique at pad "
        f"{pad_u}, [{pad_u}, W] readback byte-equal to plain (max abs err "
        f"{sel_err}) and fanned out equal to the whole batch's")

    # a deadline burst: one good request in eight doomed
    doomed = frozenset(good[::8])

    async def deadline_burst():
        async def one(k, req):
            dl = (time.monotonic() + 0.5 * engine._device_ewma
                  if k in doomed else None)
            return await engine.check(req, deadline=dl), 0.0

        return await asyncio.gather(*(one(k, r) for k, r in enumerate(reqs)))

    out, d, _ = counted(engine, lambda: asyncio.run(deadline_burst()))
    hold(out, "deadline burst", skip=doomed)
    how = {}
    for k in doomed:
        res = out[k][0]
        if res.code != rpc.DEADLINE_EXCEEDED:
            raise AssertionError(f"doomed check {k} answered {res.code} "
                                 f"{res.message}")
        how[res.message] = how.get(res.message, 0) + 1
    if d["rows"] != len(good) - len(doomed):
        raise AssertionError(f"{d['rows']} batch rows for "
                             f"{len(good) - len(doomed)} undoomed good "
                             f"tokens: a doomed request reached a batch")
    deadline = {"doomed": len(doomed), "answered_by": how,
                "engine_deadline_shed": d["deadline_shed"],
                "rtt_ewma_s_after_burst_1": rtt}
    log(f"deadline burst: {len(doomed)} doomed requests all "
        f"DEADLINE_EXCEEDED with no batch row ({how}); the other "
        f"{len(reqs) - len(doomed)} equal the oracle")

    # an admission burst against a queue cap of 64
    engine.admission.queue_cap = 64
    rej0 = engine.admission.rejected.get("queue-full", 0)
    try:
        out, d, _ = counted(engine, lambda: asyncio.run(
            timed_checks(engine, reqs)))
    finally:
        engine.admission.queue_cap = 0
    rejected = frozenset(k for k, (res, _) in enumerate(out)
                         if res.code == rpc.RESOURCE_EXHAUSTED)
    counted_rej = engine.admission.rejected.get("queue-full", 0) - rej0
    if not rejected or counted_rej != len(rejected) or any(
            out[k][0].message != "server overloaded (queue-full): "
                                 "admission rejected" for k in rejected):
        raise AssertionError(f"{len(rejected)} RESOURCE_EXHAUSTED answers, "
                             f"{counted_rej} counted")
    hold(out, "admission burst", skip=rejected)
    admission = {"queue_cap": 64, "rejected": len(rejected),
                 "served_rows": d["rows"]}
    log(f"admission burst (queue cap 64): {len(rejected)} "
        f"RESOURCE_EXHAUSTED, typed and counted; {d['rows']} rows served, "
        f"each equal to the oracle")

    # the figures: each default-engine run beside one of phase 8's engine
    def timed(e):
        bind(entries, e)
        out, d, _ = counted(e, lambda: asyncio.run(
            timed_checks(e, reqs)))
        return dict(d, checks_per_s=len(reqs) / d["wall_s"],
                    latency_s=[x for _, x in out])

    async def one_at_a_time(e, rs):
        return [(await timed_checks(e, [r]))[0][1] for r in rs]

    runs = {"on": [], "off": []}
    for _ in range(TIMED_RUNS):
        runs["on"].append(timed(engine))
        runs["off"].append(timed(off))
    lone = {}
    for key, e in (("on", engine), ("off", off)):
        bind(entries, e)
        lone[key] = np.sort(asyncio.run(one_at_a_time(
            e, [reqs[k] for k in good[:200]]))) * 1e3

    def fig(key):
        rs = runs[key]
        lat = np.sort(np.concatenate([r["latency_s"] for r in rs])) * 1e3
        rates = [r["checks_per_s"] for r in rs]
        return {
            "checks_per_s": rates,
            "checks_per_s_median": statistics.median(rates),
            "check_latency_ms_p50": float(np.percentile(lat, 50)),
            "check_latency_ms_p99": float(np.percentile(lat, 99)),
            "lone_check_latency_ms_p50": float(np.percentile(lone[key], 50)),
            "lone_check_latency_ms_p99": float(np.percentile(lone[key], 99)),
            **{k: [r[k] for r in rs] for k in
               ("rows", "device_rows", "dedup_rows", "cache_rows",
                "batches", "launches")}}

    numbers = {
        "card": card, "install_s": t_install,
        "bursts": [{k: v for k, v in b.items() if k != "latency_s"}
                   for b in bursts],
        "first_burst_check_latency_ms_p50": float(
            np.percentile(bursts[0]["latency_s"], 50) * 1e3),
        "first_burst_check_latency_ms_p99": float(
            np.percentile(bursts[0]["latency_s"], 99) * 1e3),
        "selected_batch": {"rows": 256, "unique": len(unique),
                           "pad_u": pad_u, "max_abs_err": sel_err},
        "deadline": deadline, "admission": admission,
        "encoder": enc, "heat": heat,
        "default": fig("on"), "no_reuse": fig("off"),
    }
    report["serving_core"] = numbers
    return launches, sel_err


# ---------------------------------------------------------------------------
# phase 10: the control plane
# ---------------------------------------------------------------------------

CP_CONFIGS, CP_RULES, CP_MTLS = 1000, 10, 16
CP_FLIPPED = 100          # configs whose rule differs between (c)'s corpora
OPA_TTL_S = 1
# phase 10's engines keep the reference's defaults but for wide admission
# bounds: the event loop is busy translating (or verifying certificates)
# for seconds at a time, and the phase holds verdicts, not shedding
WIDE_ADMISSION = {"admission_target_s": 60.0, "admission_min_cap": 1 << 20}
OPA_V1 = 'allow { input.request.method == "GET" }'
OPA_V2 = 'allow { input.request.method == "POST" }'


def tensor_bytes(tree) -> int:
    """Device bytes of every tensor in a params tree: one snapshot's
    upload."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(v) for v in tree)
    return 0


def mtls_material():
    """Two trusted CAs (RSA-2048 and P-256) and one foreign CA (P-256,
    the P-256 CA's name, another key), made from a seed with the port's
    keys; per mTLS config k, client certificates under config k's CA: good
    (organization org-k), another organization, expired, and one of the
    foreign CA.  Returns (rsa_ca, ec_ca, [(k, pem, kind, signed by the RSA
    CA)])."""
    from authorino_tpu_torch.models import control_plane as cp
    from authorino_tpu_torch.utils import pki

    O = cp.OID
    rng = random.Random(11)
    rsa_ca = cp.CertAuthority(pki.generate_rsa_private_key(2048, rng),
                              [[(O["CN"], "clients-rsa")], [(O["O"], "keys")]])
    ec_ca = cp.CertAuthority(pki.generate_ec_private_key(pki.P256, rng),
                             [[(O["CN"], "clients-p256")]])
    foreign = cp.CertAuthority(pki.generate_ec_private_key(pki.P256, rng),
                               [[(O["CN"], "clients-p256")]])
    certs = []
    for k in range(CP_MTLS):
        ca = rsa_ca if k % 2 == 0 else ec_ca

        def subject(org):
            return [[(O["CN"], f"client-{k}")], [(O["O"], org, cp.PRINTABLE)]]

        certs += [
            (k, ca.issue(subject(f"org-{k}"), dns_names=[f"client-{k}.keys"]),
             "good", ca is rsa_ca),
            (k, ca.issue(subject(f"org-{k + 1}")), "other-org", ca is rsa_ca),
            (k, ca.issue(subject(f"org-{k}"), valid_from_days=-30,
                         valid_days=10), "expired", ca is rsa_ca),
            (k, foreign.issue(subject(f"org-{k}")), "foreign", False)]
    return rsa_ca, ec_ca, certs


def mtls_request(k: int, pem: bytes):
    from authorino_tpu_torch.authjson import (CheckRequestModel,
                                              HttpRequestAttributes)
    from authorino_tpu_torch.models import control_plane as cp

    req = CheckRequestModel(http=HttpRequestAttributes(
        method="GET", path="/", host=cp.MTLS_HOST.format(k=k)))
    req.source.certificate = pem.decode()
    return req


def mtls_expected(kind: str, rsa_signed: bool, rsa_trusted: bool) -> int:
    from authorino_tpu_torch.utils import rpc

    if kind in ("expired", "foreign") or (rsa_signed and not rsa_trusted):
        return rpc.UNAUTHENTICATED
    return rpc.OK if kind == "good" else rpc.PERMISSION_DENIED


def write_manifests(d: Path, configs, key_gen, with_rsa_ca: bool, rsa_ca,
                    ec_ca, registry_url: str, rvs) -> None:
    """The phase-10 manifest directory, one JSON document per file:
    ``configs`` AuthConfigs (resourceVersion from ``rvs``), each config's
    API-key Secret of generation ``key_gen[i]``, the mTLS configs and CA
    Secrets, and the external-policy config.  Files that are not part of
    this state are removed."""
    from authorino_tpu_torch.models import control_plane as cp

    docs = {}
    for i, ac in enumerate(configs):
        ac = json.loads(json.dumps(ac))
        ac["metadata"]["resourceVersion"] = rvs[i]
        docs[f"ac-{i:04d}.json"] = ac
        docs[f"key-{i:04d}-{key_gen[i]}.json"] = cp.api_key_secret(i, key_gen[i])
    for k in range(CP_MTLS):
        docs[f"mtls-{k:02d}.json"] = dict(cp.mtls_auth_config(k), metadata=dict(
            cp.mtls_auth_config(k)["metadata"], resourceVersion="1"))
    if with_rsa_ca:
        docs["ca-rsa.json"] = cp.ca_secret("ca-rsa", rsa_ca.pem)
    docs["ca-p256.json"] = cp.ca_secret("ca-p256", ec_ca.pem)
    opa = cp.opa_external_auth_config(f"{registry_url}/policy", OPA_TTL_S)
    opa["metadata"]["resourceVersion"] = "1"
    docs["opa-external.json"] = opa
    for f in d.iterdir():
        if f.name not in docs:
            f.unlink()
    for name, doc in docs.items():
        path = d / name
        text = json.dumps(doc)
        if not path.exists() or path.read_text() != text:
            path.write_text(text)


def swap_split(swaps: list, first: int, t: float, engine) -> dict:
    """Where a rebuild's seconds went: the times after ``t`` of the swaps
    from index ``first`` of ``swaps`` (the swap listener's), the serving
    snapshot's own phases (compile, validate, diff, upload, ...), and from
    the last swap to now."""
    now = time.perf_counter()
    return {"swaps_at": [round(x - t, 3) for x in swaps[first:]],
            "snapshot_phases": {k: round(v, 3) for k, v in
                                engine._snapshot.phase_s.items()},
            "after_last_swap": round(now - swaps[-1], 3) if swaps else None}


def log_control_plane(report: dict, card: str, cp_launches: dict) -> None:
    """Phase 10's lines of figures, from its report."""
    cpn = report["control_plane"]
    a, kb, sw = cpn["manifests"], cpn["kubernetes"], cpn["swaps"]
    log(f"control plane (a): {cpn['configs']} AuthConfigs + {cpn['secrets']} "
        f"Secrets as manifests; bootstrap deny-all swapped in "
        f"{a['bootstrap_swap_s']:.3f}s (a Check() meanwhile: "
        f"{a['bootstrap_check']}), ready in {a['cold_reconcile_s']:.2f}s; "
        f"{a['burst_checks']} concurrent Check()s equal the oracle "
        f"({a['burst_allowed']} API-key requests allowed, mTLS good, other "
        f"organization, expired and foreign-CA certificates as expected); "
        f"{a['rotated_keys']} API keys rotated with no swap; the RSA CA's "
        f"clients UNAUTHENTICATED after its removal; the external policy "
        f"followed its registry in {a['policy_follow_s']:.2f}s (TTL "
        f"{OPA_TTL_S}s) with no reconcile")
    log(f"control plane (b): {kb['cold_reconcile_s']:.2f}s cold reconcile "
        f"through K8sWatchSource + RestCluster ({kb['api_requests']} API "
        f"requests); a 410 and a dropped watch, converged in "
        f"{kb['watch_converge_s']:.2f}s; {kb['status_writes']} status writes, "
        f"all by {kb['status_writer']}, every AuthConfig Ready")
    log(f"control plane (c): {sw['burst_checks']} Check()s across three "
        f"reconciles, every verdict equal to its batch's generation "
        f"{sw['verdicts_by_generation']}; device memory over the swaps "
        f"past a full history of {sw['snapshot_history']} "
        f"{sw['memory_growth_bytes']:+d} B (one snapshot: "
        f"{sw['snapshot_upload_bytes']} B); host RSS after ten swaps "
        f"{sw['host_rss_growth_bytes']:+d} B; {sw['native_encoders_built']} "
        f"native encoders built, {sw['native_encoders_alive']} alive after "
        f"the swaps; {fmt_encoder(cpn['encoder'])}")
    log(f"[{card}] control plane: cold reconcile {a['cold_reconcile_s']:.3f}s "
        f"(bootstrap swap {a['bootstrap_swap_s']:.3f}s); rebuild for one "
        f"changed file {a['one_file_rebuild_s']:.3f}s; Secret rotation "
        f"{a['rotation_latency_s']:.3f}s from the write to the first Check() "
        f"with the new key (the sync {a['rotation_sync_s']:.3f}s); "
        f"{a['checks_per_s']:.0f} checks/s, p50 "
        f"{a['check_latency_ms_p50']:.2f} ms p99 "
        f"{a['check_latency_ms_p99']:.2f} ms; host per mTLS verify "
        f"{a['mtls_verify_us_rsa2048']:.1f} us RSA-2048, "
        f"{a['mtls_verify_us_p256']:.1f} us P-256 (certificate parse "
        f"{a['mtls_parse_us']:.1f} us); one reconcile of (c)'s corpus "
        f"{sw['reconcile_s']:.3f}s, of which the native encoder's build "
        f"(policy_new) {statistics.median(sw['encoder_build_s']) * 1e3:.2f} "
        f"ms median over {len(sw['encoder_build_s'])} swaps; phase 10 "
        f"launches: "
        f"{cp_launches['fused_megakernel']} mega-kernel, "
        f"{cp_launches['probe_add_one']} probe")



def control_plane(report: dict, card: str, dev, n: int = CP_CONFIGS,
                  n_checks: int = 4096, ctx: dict = None) -> tuple:
    """Phase 10, the control plane on the card: (a) AuthConfig and Secret
    manifests through ``YamlDirSource`` into a default engine (bootstrap
    deny-all answering 503 while the corpus compiles; a burst held to the
    oracle; one rule flipped in its file; 64 API keys rotated with no swap;
    a CA removed; an external policy changed in its registry and followed
    after one TTL with no reconcile); (b) the same corpus through
    ``K8sWatchSource`` and ``RestCluster`` against a loopback API server
    (a 410 and a dropped connection, two leader-elected status writers);
    (c) a burst during which three reconciles alternate between two
    corpora, every verdict held to its batch's generation, and device
    memory after ten swaps.  Returns (the kernels' launches in phase 10,
    counts zeroed just before it; the max abs byte error of its batch
    against plain); leaves the mTLS keys and certificates in ``ctx`` for
    phase 12."""
    import gc
    import os
    import tempfile
    import weakref

    import numpy as np
    import torch

    from authorino_tpu_torch.apis import to_v1beta2
    from authorino_tpu_torch.compiler.encode import encode_batch
    from authorino_tpu_torch.compiler.pack import pack_batch
    from authorino_tpu_torch.controllers import (AuthConfigReconciler,
                                                 AuthConfigStatusUpdater,
                                                 SecretReconciler)
    from authorino_tpu_torch.controllers.sources import (K8sWatchSource,
                                                         YamlDirSource)
    from authorino_tpu_torch.evaluators.identity.mtls import _verify_signed_by
    from authorino_tpu_torch.k8s import InMemoryCluster, RestCluster
    from authorino_tpu_torch.models import control_plane as cp
    from authorino_tpu_torch.ops import fused_kernel as fk
    from authorino_tpu_torch.runtime import PolicyEngine
    from authorino_tpu_torch.utils import rpc, x509

    on_card = dev.type == "cuda"
    t = time.perf_counter()
    rsa_ca, ec_ca, certs = mtls_material()
    t_keys = time.perf_counter() - t
    if ctx is not None:
        ctx["material"] = (rsa_ca, ec_ca, certs)
    base = cp.build_auth_configs(n, CP_RULES)
    rules = cp.config_rules(n, CP_RULES)
    n_mtls = 2 * len(certs)
    reqs, cfgs, known = cp.build_check_requests(n_checks - n_mtls, n)
    mtls_reqs = [(mtls_request(k, pem), kind, rsa) for k, pem, kind, rsa
                 in certs * 2]
    numbers = {"card": card, "configs": n + CP_MTLS + 1,
               "secrets": n + 2, "keys_and_certs_s": t_keys}

    def hold(results, key_gen, rsa_trusted, label, rules=rules):
        """Every burst result against the oracle: an API-key request with
        the key of generation 0 (a rotated config's old key is revoked),
        and the mTLS requests by their certificate's kind."""
        allowed = 0
        for k, (res, req, i, good) in enumerate(zip(results, reqs, cfgs, known)):
            if res.code == rpc.UNAVAILABLE:
                raise AssertionError(f"{label}: check {k} UNAVAILABLE: {res}")
            want = cp.expected_code(req, i, rules, good and key_gen[i] == 0)
            if res.code != want:
                raise AssertionError(f"{label}: check {k} on config {i}: "
                                     f"{res.code} != oracle {want} ({res})")
            allowed += res.code == rpc.OK
        for k, (res, (_, kind, rsa)) in enumerate(
                zip(results[len(reqs):], mtls_reqs)):
            want = mtls_expected(kind, rsa, rsa_trusted)
            if res.code != want:
                raise AssertionError(f"{label}: mTLS check {k} ({kind}, RSA "
                                     f"CA {rsa}): {res.code} != {want} "
                                     f"({res.message})")
        return allowed

    async def burst(engine):
        t = time.perf_counter()
        out = await timed_checks(engine, reqs + [r for r, _, _ in mtls_reqs])
        return ([r for r, _ in out], [s for _, s in out],
                time.perf_counter() - t)

    def with_key(i: int, gen: int):
        """Request 0's method, path, headers and claims to config i with
        its API key of generation ``gen``."""
        q = cp.build_check_requests(1, n)[0][0]
        q.http.host = cp.host_of(i)
        q.http.headers["authorization"] = f"APIKEY {cp.api_key_of(i, gen)}"
        return q

    # the config whose flipped rule changes a request's verdict
    flip_j = next(j for j, (q, i, good) in enumerate(zip(reqs, cfgs, known))
                  if good and cp.expected_code(q, i, rules, True)
                  != cp.expected_code(q, i, cp.config_rules(
                      n, CP_RULES, flip=[i]), True))
    flip_i = cfgs[flip_j]
    flipped = cp.config_rules(n, CP_RULES, flip=[flip_i])
    want_new = cp.expected_code(reqs[flip_j], flip_i, flipped, True)

    fk.reset_counts()
    reset_host_counts()
    a, b = {}, {}
    engines = []   # every engine of the phase, for the encoder's count

    # ---- (a) manifests through YamlDirSource, (b) the Kubernetes path -----
    # one event loop for both: the external policy's refresher lives on it
    async def manifests_path(d: Path, registry):
        key_gen, rvs = [0] * n, ["1"] * n
        write = (lambda configs, with_rsa: write_manifests(
            d, configs, key_gen, with_rsa, rsa_ca, ec_ca, registry.url, rvs))
        write(base, True)
        engine = PolicyEngine(max_batch=256, device=dev, **WIDE_ADMISSION)
        engines.append(engine)
        cluster = InMemoryCluster()
        rec = AuthConfigReconciler(engine, cluster=cluster)
        source = YamlDirSource(str(d), rec, cluster, SecretReconciler(engine))
        swap_times = []
        engine.add_swap_listener(lambda: swap_times.append(time.perf_counter()))
        seen = {}

        async def probe_bootstrap():
            # runs at the sync's first yield: the deny-all is installed and
            # the real corpus is still translating or compiling
            while not swap_times:
                await asyncio.sleep(0)
            seen["gen"] = engine.generation
            seen["res"] = await engine.check(reqs[0])
            seen["after_gen"] = engine.generation

        t0 = time.perf_counter()
        task = asyncio.ensure_future(probe_bootstrap())
        await source.sync()
        a["cold_reconcile_s"] = time.perf_counter() - t0
        a["bootstrap_swap_s"] = swap_times[0] - t0
        await task
        res = seen["res"]
        a["bootstrap_check"] = [res.code, res.status, res.message]
        if (res.code, res.status, res.message) != (
                rpc.PERMISSION_DENIED, 503, "Busy") \
                or seen["gen"] != 1 or seen["after_gen"] != 1:
            raise AssertionError(f"bootstrap: {res} at generation "
                                 f"{seen['gen']}-{seen['after_gen']}")
        if not rec.ready() or engine.generation != 2:
            raise AssertionError(f"cold sync: ready {rec.ready()}, "
                                 f"generation {engine.generation}")

        results, lat, wall = await burst(engine)
        a["burst_allowed"] = hold(results, key_gen, True, "(a) burst")
        lat_ms = np.sort(np.array(lat)) * 1e3
        a.update({"burst_checks": len(results),
                  "checks_per_s": len(results) / wall,
                  "check_latency_ms_p50": float(np.percentile(lat_ms, 50)),
                  "check_latency_ms_p99": float(np.percentile(lat_ms, 99))})
        checked_records(engine)

        # one rule flipped in its file: from the write to the first Check()
        # that sees the new rule
        gen0 = engine.generation
        n_swaps = len(swap_times)
        t = time.perf_counter()
        rvs[flip_i] = "2"
        configs = cp.build_auth_configs(n, CP_RULES, flip=[flip_i])
        write(configs, True)
        await source.sync()
        r = await engine.check(reqs[flip_j])
        a["one_file_rebuild_s"] = time.perf_counter() - t
        # its split: the write and the sync up to the swap (reading the
        # manifests, translating every AuthConfig, building the snapshot),
        # the snapshot's own phases, and the swap to the first Check()
        a["one_file_split_s"] = swap_split(swap_times, n_swaps, t, engine)
        if r.code != want_new or engine.generation != gen0 + 1:
            raise AssertionError(f"flipped config {flip_i}: {r.code} != "
                                 f"{want_new}, generation {engine.generation}")

        # 64 API-key Secrets deleted and 64 new ones added: revoked keys
        # UNAUTHENTICATED, new ones allowed, no swap
        gen0 = engine.generation
        rotated = sorted(set(cfgs))[:64]
        for i in rotated:
            key_gen[i] = 1
        t = time.perf_counter()
        write(configs, True)
        await source.sync()
        a["rotation_sync_s"] = time.perf_counter() - t
        r_new = await engine.check(with_key(rotated[0], 1))
        a["rotation_latency_s"] = time.perf_counter() - t
        if engine.generation != gen0:
            raise AssertionError(f"Secret rotation swapped the corpus "
                                 f"({gen0} -> {engine.generation})")
        results, _, _ = await burst(engine)
        hold(results, key_gen, True, "(a) after rotation", rules=flipped)
        for i in rotated:
            q = with_key(i, 1)
            code = (await engine.check(q)).code
            want = cp.expected_code(q, i, flipped, True, generation=1)
            if code != want:
                raise AssertionError(f"new key of config {i}: {code} != {want}")
        if r_new.code != cp.expected_code(with_key(rotated[0], 1), rotated[0],
                                          flipped, True, generation=1):
            raise AssertionError(f"first new key: {r_new.code}")
        a["rotated_keys"] = len(rotated)

        # the RSA CA removed: its clients UNAUTHENTICATED, P-256 ones kept
        gen0 = engine.generation
        write(configs, False)
        await source.sync()
        for (q, kind, rsa) in mtls_reqs:
            code = (await engine.check(q)).code
            if code != mtls_expected(kind, rsa, False):
                raise AssertionError(f"after the RSA CA's removal: {kind} "
                                     f"(RSA {rsa}) answered {code}")
        if engine.generation != gen0:
            raise AssertionError("the CA's removal swapped the corpus")

        # the registry's policy changes: after one TTL the decision
        # follows, with no reconcile
        opa = [cp.CheckRequestModel(http=cp.HttpRequestAttributes(
            method=m, path="/", host=cp.OPA_HOST)) for m in ("GET", "POST")]
        before = [(await engine.check(q)).code for q in opa]
        registry.policy = OPA_V2
        t = time.perf_counter()
        while time.perf_counter() - t < 10 * OPA_TTL_S:
            after = [(await engine.check(q)).code for q in opa]
            if after == [rpc.PERMISSION_DENIED, rpc.OK]:
                break
            await asyncio.sleep(0.02)
        a["policy_follow_s"] = time.perf_counter() - t
        if before != [rpc.OK, rpc.PERMISSION_DENIED] \
                or after != [rpc.PERMISSION_DENIED, rpc.OK] \
                or engine.generation != gen0:
            raise AssertionError(f"external policy: {before} -> {after}, "
                                 f"generation {gen0} -> {engine.generation}")
        a["swaps"] = engine.generation
        await engine.lookup(cp.OPA_HOST).runtime.clean()
        registry.policy = OPA_V1
        log(f"control plane (a): cold {a['cold_reconcile_s']:.2f}s, "
            f"burst {a['checks_per_s']:.0f} checks/s, one file "
            f"{a['one_file_rebuild_s']:.2f}s ({a['one_file_split_s']}), "
            f"rotation "
            f"{a['rotation_latency_s']:.2f}s, policy "
            f"{a['policy_follow_s']:.2f}s")

        # ---- (b) the same corpus through K8sWatchSource and RestCluster --
        with cp.FakeApiServer() as api:
            for i, ac in enumerate(base):
                api.put("authconfigs", to_v1beta2(json.loads(json.dumps(ac))))
                api.put("secrets", cp.api_key_secret(i))
            for k in range(CP_MTLS):
                api.put("authconfigs", cp.mtls_auth_config(k))
            api.put("authconfigs", cp.opa_external_auth_config(
                f"{registry.url}/policy", OPA_TTL_S))
            api.put("secrets", cp.ca_secret("ca-rsa", rsa_ca.pem))
            api.put("secrets", cp.ca_secret("ca-p256", ec_ca.pem))
            k_engine = PolicyEngine(max_batch=256, device=dev, **WIDE_ADMISSION)
            engines.append(k_engine)
            k_swaps = []
            k_engine.add_swap_listener(
                lambda: k_swaps.append(time.perf_counter()))
            rest = RestCluster(api.url, token="authorino")
            k_rec = AuthConfigReconciler(k_engine, cluster=rest)
            watch = K8sWatchSource(rest, k_rec, SecretReconciler(k_engine),
                                   resync_interval_s=0.2)
            updaters = [AuthConfigStatusUpdater(
                k_rec, RestCluster(api.url, token=f"replica-{r}"),
                leases=RestCluster(api.url, token=f"replica-{r}"),
                namespace=cp.NAMESPACE, identity=f"replica-{r}",
                interval_s=0.05) for r in "ab"]
            t = time.perf_counter()
            await watch.sync()
            b["cold_reconcile_s"] = time.perf_counter() - t
            watch.start()
            for u in updaters:
                u.start()
            sample = list(range(0, len(reqs), 8))
            for j in sample:
                code = (await k_engine.check(reqs[j])).code
                want = cp.expected_code(reqs[j], cfgs[j], rules, known[j])
                if code != want:
                    raise AssertionError(f"(b) check {j}: {code} != {want}")
            # a 410 on the AuthConfig watch, then a changed rule; a dropped
            # Secret watch, then a revoked key
            api.fault("authconfigs", "gone")
            api.put("authconfigs", to_v1beta2(json.loads(json.dumps(
                configs[flip_i]))))
            api.fault("secrets", "drop")
            revoked = next(j for j in range(len(reqs))
                           if known[j] and cfgs[j] != flip_i)
            api.delete("secrets", cp.NAMESPACE, f"key-{cfgs[revoked]}-0")
            # the re-list after the 410 re-translates every AuthConfig and
            # swaps once, as (a)'s changed file did: the window is two of
            # this host's such rebuilds, and at least 20 s
            window = max(20.0, 2.0 * a["one_file_rebuild_s"])
            n_swaps = len(k_swaps)
            t = time.perf_counter()
            while time.perf_counter() - t < window:
                c1 = (await k_engine.check(reqs[flip_j])).code
                c2 = (await k_engine.check(reqs[revoked])).code
                if c1 == want_new and c2 == rpc.UNAUTHENTICATED:
                    break
                await asyncio.sleep(0.05)
            else:
                raise AssertionError(
                    f"(b) the watch did not converge in {window:.1f}s: "
                    f"{c1}, {c2}; swaps after the 410 at "
                    f"{[round(x - t, 2) for x in k_swaps[n_swaps:]]}s")
            b["watch_converge_s"] = time.perf_counter() - t
            b["watch_window_s"] = window
            b["watch_split_s"] = swap_split(k_swaps, n_swaps, t, k_engine)
            log(f"control plane (b): cold {b['cold_reconcile_s']:.2f}s, "
                f"the watch converged in {b['watch_converge_s']:.2f}s "
                f"({b['watch_split_s']}; window {window:.1f}s)")
            # every AuthConfig Ready, written by exactly one replica
            t = time.perf_counter()
            ids = set(api.objects["authconfigs"])
            while time.perf_counter() - t < 30:
                written = {(ns, nm) for _, ns, nm, _ in api.status_writes}
                ready = all((api.objects["authconfigs"][key].get("status")
                             or {}).get("summary", {}).get("ready")
                            for key in ids)
                if written >= ids and ready:
                    break
                await asyncio.sleep(0.05)
            else:
                stale = sorted(key for key in ids if not (
                    api.objects["authconfigs"][key].get("status") or {}).get(
                        "summary", {}).get("ready"))
                raise AssertionError(f"(b) statuses: {len(written)} of "
                                     f"{len(ids)} written, not Ready: "
                                     f"{stale[:5]}")
            b["status_write_s"] = time.perf_counter() - t
            # counted while both run: on stop the leader releases its Lease
            # and the other may take over
            writers = sorted({tok for tok, *_ in api.status_writes})
            leaders = [u.elector.is_leader() for u in updaters]
            for u in updaters:
                await u.stop()
            await watch.stop()
            rest.stop()
            await k_engine.lookup(cp.OPA_HOST).runtime.clean()
            if len(writers) != 1 or sorted(leaders) != [False, True]:
                raise AssertionError(f"(b) status writers: {writers}, "
                                     f"leaders {leaders}")
            b.update({"status_writes": len(api.status_writes),
                      "status_writer": writers[0],
                      "ready": k_rec.ready(),
                      "watches": dict(api.watches),
                      "api_requests": len(api.requests)})

    with tempfile.TemporaryDirectory() as tmp, \
            cp.PolicyRegistry(OPA_V1) as registry:
        asyncio.run(manifests_path(Path(tmp), registry))

    # µs of host per mTLS verify (RSA-2048 and P-256 CA signatures)
    rsa_cert = x509.load_pem_x509_certificate(certs[0][1])
    ec_cert = x509.load_pem_x509_certificate(certs[4][1])
    rsa_ca_cert = x509.load_pem_x509_certificate(rsa_ca.pem)
    ec_ca_cert = x509.load_pem_x509_certificate(ec_ca.pem)
    if not (_verify_signed_by(rsa_cert, rsa_ca_cert)
            and _verify_signed_by(ec_cert, ec_ca_cert)):
        raise AssertionError("a good client certificate did not verify")
    a["mtls_verify_us_rsa2048"] = host_us(
        lambda: _verify_signed_by(rsa_cert, rsa_ca_cert), 200)
    a["mtls_verify_us_p256"] = host_us(
        lambda: _verify_signed_by(ec_cert, ec_ca_cert), 50)
    a["mtls_parse_us"] = host_us(
        lambda: x509.load_pem_x509_certificate(certs[0][1]), 200)
    numbers["manifests"], numbers["kubernetes"] = a, b

    # ---- (c) swaps under load ----------------------------------------------
    c = {}
    flips = list(range(0, n, max(1, n // CP_FLIPPED)))[:CP_FLIPPED]
    corpora = {name: [to_v1beta2(dict(ac, metadata=dict(
        ac["metadata"], resourceVersion=name))) for ac in configs]
        for name, configs in (("A", base), ("B", cp.build_auth_configs(
            n, CP_RULES, flip=flips)))}
    oracle_rules = {"A": rules, "B": cp.config_rules(n, CP_RULES, flip=flips)}
    s_engine = PolicyEngine(max_batch=256, device=dev, **WIDE_ADMISSION)
    engines.append(s_engine)
    gens = cp.GenerationLog(s_engine)
    gen_corpus = {}
    target = ["A"]
    s_engine.add_swap_listener(
        lambda: gen_corpus.__setitem__(s_engine.generation, target[0]))
    # each swap's native encoder: its build (policy_new) inside the
    # reconcile, and a weak reference that must die with its snapshot
    encoder_builds, encoder_refs = [], []

    def on_swap():
        snap = s_engine._snapshot
        if snap.encoder is not None:
            encoder_builds.append(snap.encoder_build_s)
            encoder_refs.append(weakref.ref(snap.encoder))

    s_engine.add_swap_listener(on_swap)
    s_cluster = InMemoryCluster()
    for i in range(n):
        s_cluster.put_secret(cp.Secret(
            name=f"key-{i}-0", namespace=cp.NAMESPACE,
            labels=cp.api_key_secret(i)["metadata"]["labels"],
            data={"api_key": cp.api_key_of(i).encode()}))
    s_rec = AuthConfigReconciler(s_engine, cluster=s_cluster)

    async def swaps_under_load():
        """Four turns of four waves of 256 Check()s, one wave at a time:
        each of the first three turns beside a reconcile (B, A, B) that
        it waits for before the next turn, so batches are cut while each
        new corpus compiles, uploads and swaps in; the last turn on the
        last corpus.  Each Check() has a request object of its own, so each has its
        own generation record."""
        t = time.perf_counter()
        await s_rec.reconcile_all(corpora["A"])
        t_one = time.perf_counter() - t
        c_reqs, c_cfgs, c_known = cp.build_check_requests(n_checks, n,
                                                          seed=8)
        size = -(-n_checks // 16)
        waves = [[(c_reqs[j], c_cfgs[j], c_known[j])
                  for j in range(lo, min(lo + size, n_checks))]
                 for lo in range(0, n_checks, size)]
        issued, out = [], []
        t = time.perf_counter()
        for turn, name in enumerate(("B", "A", "B", None)):
            task = None
            if name is not None:
                target[0] = name
                task = asyncio.ensure_future(s_rec.reconcile_all(corpora[name]))
            for wave in waves[4 * turn:4 * turn + 4]:
                issued += wave
                out += await timed_checks(s_engine, [q for q, _, _ in wave])
            if task is not None:
                await task
        return t_one, issued, [r for r, _ in out], time.perf_counter() - t

    c["reconcile_s"], issued, results, c["burst_wall_s"] = asyncio.run(
        swaps_under_load())
    c["burst_checks"] = len(results)
    seen = {}
    for k, (res, (req, i, good)) in enumerate(zip(results, issued)):
        if not good:
            if res.code != rpc.UNAUTHENTICATED:
                raise AssertionError(f"(c) unknown key {k}: {res.code}")
            continue
        gen = gens.by_request.get(id(req))
        if gen is None or gen not in gen_corpus:
            raise AssertionError(f"(c) check {k}: no generation ({gen}): "
                                 f"{res}")
        want = cp.expected_code(req, i, oracle_rules[gen_corpus[gen]], True)
        if res.code != want:
            raise AssertionError(f"(c) check {k} on config {i} at generation "
                                 f"{gen} ({gen_corpus[gen]}): {res.code} != "
                                 f"{want}")
        seen[gen] = seen.get(gen, 0) + 1
    if s_engine.generation != 5 or len(seen) < 2:
        raise AssertionError(f"(c) generations: engine "
                             f"{s_engine.generation}, verdicts from {seen}")
    c["verdicts_by_generation"] = {f"{g} ({gen_corpus[g]})": v
                                   for g, v in sorted(seen.items())}
    c["batches_by_generation"] = {}
    for r in checked_records(s_engine):
        key = str(r["generation"])
        c["batches_by_generation"][key] = c["batches_by_generation"].get(key, 0) + 1
    launches = {"fused_megakernel": fk.launches,
                "probe_add_one": fk.probe_launches}
    enc = encoder_used(s_engine, sum(e.stats["batches"] for e in engines))
    require_encoder("control plane", enc, "native")
    numbers["encoder"] = enc

    # device memory over ten more swaps, alternating the two corpora's
    # entries (compile, upload, probe and swap each time); the engine
    # retains its bounded history's generations (params and encoders) for
    # a rollback, so memory is held from the swap that fills it
    entries = {}
    for name in ("A", "B"):
        asyncio.run(s_rec.reconcile_all(corpora[name]))
        entries[name] = s_engine.index.list()
    snap_bytes = tensor_bytes(s_engine._snapshot.params)

    def allocated():
        gc.collect()
        if on_card:
            torch.cuda.synchronize(dev)
            return torch.cuda.memory_allocated(dev)
        return 0

    def rss() -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    mem, host = [], []
    n_refs = len(encoder_refs)
    for k in range(10):
        s_engine.apply_snapshot(entries["AB"[k % 2]])
        mem.append(allocated())
        host.append(rss())
    alive = sum(r() is not None for r in encoder_refs)
    full = s_engine._history.maxlen
    c.update({"snapshot_upload_bytes": snap_bytes,
              "snapshot_history": full,
              "memory_allocated_after_swap": mem,
              "memory_growth_bytes": mem[-1] - mem[full],
              "host_rss_after_swap": host,
              "host_rss_growth_bytes": host[-1] - host[0],
              "native_encoders_built": len(encoder_refs),
              "native_encoders_alive": alive,
              "encoder_build_s": encoder_builds})
    if len(s_engine._history) != full or \
            abs(mem[-1] - mem[full]) > snap_bytes:
        raise AssertionError(f"device memory grew by {mem[-1] - mem[full]} "
                             f"B over the swaps past a full history of "
                             f"{full} (one snapshot: {snap_bytes} B)")
    # every snapshot swapped out of the history has lost its native
    # encoder (its capsule freed the C tables): only the serving one and
    # the history's live
    if len(encoder_refs) != n_refs + 10 or alive != 1 + full:
        raise AssertionError(f"{alive} of {len(encoder_refs)} native "
                             f"encoders alive after ten swaps (history "
                             f"{full})")
    if host[-1] - host[1] > 256 << 20:
        raise AssertionError(f"host RSS grew {host[-1] - host[1]} B over "
                             f"swaps 2-10")
    numbers["swaps"] = c

    # the mega-kernel on this corpus against its plain version, after the
    # counts were read (comparison launches do not count)
    policy, params = s_engine._snapshot.policy, s_engine._snapshot.params
    from authorino_tpu_torch.authjson import build_authorization_json

    docs, rows = [], []
    for req, i, good in zip(reqs, cfgs, known):
        if good and len(docs) < 256:
            claims = req.metadata_context["filter_metadata"][cp.JWT_FILTER]["verified_jwt"]
            docs.append(build_authorization_json(req, {"identity": claims}))
            rows.append(policy.config_ids[f"{cp.NAMESPACE}/key-{i}"])
    db = pack_batch(policy, encode_batch(policy, docs, rows))
    max_err = 0
    if on_card:
        max_err = max(kernel_vs_plain(params, db, dev),
                      kernel_vs_plain(params, db, dev, global_tables=True))
    numbers["launches"] = launches
    report["control_plane"] = numbers
    return launches, max_err


# ---------------------------------------------------------------------------
# phase 12: the serving surfaces
# ---------------------------------------------------------------------------

SERVE_BURSTS = 1          # timed gRPC bursts (checks/s: their median)
SERVE_HTTP = 256          # burst requests also sent over HTTP /check
SERVE_LONE = 200          # gRPC Check()s sent one at a time
SERVE_SLO_MS = 250.0      # the server's --slo-ms (phase 13 (e))
ENTRY_CONFIGS = 16        # API-key configs the process entry point serves
ENTRY_DRAIN_S = 10.0      # its --drain-timeout
CHECK_METHOD = "/envoy.service.auth.v3.Authorization/Check"
HEALTH_METHOD = "/grpc.health.v1.Health/Check"
# Check()s in flight at once against an in-process grpc.aio server.  gRPC's
# core cancels a call that waits unrequested longer than
# grpc.server_max_unrequested_time_in_server (30 s by default; the client
# sees CANCELLED "CANCELLED" from its peer), and a grpc.aio server requests
# calls on the event loop that also runs each Check()'s host work (an RS256
# verify, a pipeline): 4,096 sent at once leave the last ones unrequested
# for as long as the whole burst takes, past 30 s on a slow host.  A window
# bounds that wait to about its own width's host work.
AIO_WINDOW = 1024
WRISTBAND_HOST = "wristband.keys"
SPICEDB_HOST = "spicedb.keys"
MANAGED = {"authorino.kuadrant.io/managed-by": "authorino"}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def listening(port: int) -> bool:
    """Whether a listener holds ``port``."""
    import socket

    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind(("0.0.0.0", port))
        except OSError:
            return True
    return False


def http_call(port: int, path: str, headers=None, body=None, method=None,
              timeout: float = 30.0):
    """(status, headers as [(name, value)], body text) of one request to
    127.0.0.1:port; (None, [], "") when nothing answers."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 headers=headers or {}, data=body,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.getheaders(), r.read().decode()
    except urllib.error.HTTPError as e:
        with e:
            return e.code, e.headers.items(), e.read().decode()
    except OSError:
        return None, [], ""


class FakeSpiceDB:
    """authzed.api.v1 CheckPermission on loopback (a grpcio generic
    handler on the caller's loop): HAS_PERMISSION for the subject
    ``alice``, NO_PERMISSION otherwise."""

    def __init__(self):
        self.checks = 0

    async def start(self):
        import grpc

        from authorino_tpu_torch.protos import wire

        async def check(request: bytes, context):
            self.checks += 1
            return wire.encode_check_permission_response(
                2 if b"alice" in request else 1, "zed")

        self.server = grpc.aio.server()
        self.server.add_generic_rpc_handlers((
            grpc.method_handlers_generic_handler(
                "authzed.api.v1.PermissionsService",
                {"CheckPermission": grpc.unary_unary_rpc_method_handler(
                    check, request_deserializer=lambda b: b,
                    response_serializer=lambda b: b)}),))
        self.port = self.server.add_insecure_port("127.0.0.1:0")
        await self.server.start()
        return self


def surface_manifests(d: Path, spicedb_port: int) -> None:
    """The wristband config (its signing key in a Secret) and the SpiceDB
    config (its bearer token in a Secret) beside phase 10's manifests.
    Each AuthConfig carries a resourceVersion, as phase 10's do, so the
    source's first poll after the start finds the state it serves and
    skips the rebuild."""
    from authorino_tpu_torch.models import control_plane as cp
    from authorino_tpu_torch.utils import pki

    key = pki.private_key_to_pem(pki.generate_ec_private_key(
        pki.P256, random.Random(12))).decode()
    anon = {"anon": {"anonymous": {}}}
    docs = {
        "wristband.json": {
            "apiVersion": "authorino.kuadrant.io/v1beta2",
            "kind": "AuthConfig",
            "metadata": {"name": "wristband", "namespace": cp.NAMESPACE,
                         "resourceVersion": "1"},
            "spec": {"hosts": [WRISTBAND_HOST], "authentication": anon,
                     "response": {"success": {"headers": {"x-wristband": {
                         "wristband": {
                             "issuer": "https://authorino.example/keys/"
                                       "wristband/x-wristband",
                             "signingKeyRefs": [{
                                 "name": "wristband-key",
                                 "algorithm": "ES256"}]}}}}}}},
        "wristband-key.json": {
            "apiVersion": "v1", "kind": "Secret",
            "metadata": {"name": "wristband-key", "namespace": cp.NAMESPACE,
                         "labels": dict(MANAGED)},
            "stringData": {"key.pem": key}},
        "spicedb.json": {
            "apiVersion": "authorino.kuadrant.io/v1beta2",
            "kind": "AuthConfig",
            "metadata": {"name": "spicedb", "namespace": cp.NAMESPACE,
                         "resourceVersion": "1"},
            "spec": {"hosts": [SPICEDB_HOST], "authentication": anon,
                     "authorization": {"spicedb": {"spicedb": {
                         "endpoint": f"127.0.0.1:{spicedb_port}",
                         "insecure": True,
                         "sharedSecretRef": {"name": "spicedb",
                                             "key": "token"},
                         "subject": {"kind": {"value": "user"},
                                     "name": {"selector":
                                              "request.headers.x-user"}},
                         "resource": {"kind": {"value": "doc"},
                                      "name": {"selector":
                                               "request.url_path"}},
                         "permission": {"value": "read"}}}}}},
        "spicedb-token.json": {
            "apiVersion": "v1", "kind": "Secret",
            "metadata": {"name": "spicedb", "namespace": cp.NAMESPACE,
                         "labels": dict(MANAGED)},
            "stringData": {"token": "s3cr3t"}},
    }
    for name, doc in docs.items():
        (d / name).write_text(json.dumps(doc))


def latency_ms(xs) -> tuple:
    import numpy as np

    ms = np.sort(np.array(xs)) * 1e3
    return float(np.percentile(ms, 50)), float(np.percentile(ms, 99))


class ServerStart:
    """A server process started ahead of the part that drives it: started
    now, its ``/readyz`` polled on a thread of its own, so the 8-18 s it
    takes to import torch, reach the card and load its corpus overlap the
    work before that part.  ``ready_s`` is the time from the start to the
    first 200 (``ready``: that response), as when the part waited for it
    itself."""

    def __init__(self, argv, http_port: int, log_path: Path, label: str):
        import atexit
        import os
        import threading

        root = Path(__file__).resolve().parent
        log_path.parent.mkdir(exist_ok=True)
        self.label, self.log_path, self.port = label, log_path, http_port
        self.ready_s, self.ready = None, None
        self.t0 = time.perf_counter()
        with open(log_path, "w") as logf:
            self.proc = subprocess.Popen(
                argv, cwd=str(root), env=dict(os.environ,
                                              PYTHONPATH=str(root)),
                stdout=logf, stderr=subprocess.STDOUT)
        self._poller = threading.Thread(target=self._poll, daemon=True,
                                        name=f"ready-{label}")
        self._poller.start()
        atexit.register(self.kill)

    def _poll(self) -> None:
        while self.proc.poll() is None and \
                time.perf_counter() - self.t0 < 180:
            r = http_call(self.port, "/readyz", timeout=2)
            if r[0] == 200:
                self.ready_s, self.ready = time.perf_counter() - self.t0, r
                return
            time.sleep(0.1)

    def wait_ready(self) -> float:
        """Until ready; raises when the process exited or never got
        ready."""
        self._poller.join(timeout=200)
        if self.ready_s is None:
            if self.proc.poll() is not None:
                raise AssertionError(
                    f"({self.label}) the server exited "
                    f"{self.proc.returncode}: "
                    f"{self.log_path.read_text()[-2000:]}")
            raise AssertionError(f"({self.label}) the server never got "
                                 "ready")
        return self.ready_s

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def entry_manifests(extra=()) -> str:
    """A temporary directory of the ENTRY_CONFIGS API-key AuthConfigs,
    their Secrets and ``extra``, one JSON manifest each: a server
    process's corpus.  The caller removes it."""
    import tempfile

    from authorino_tpu_torch.models import control_plane as cp

    d = tempfile.mkdtemp()
    docs = cp.build_auth_configs(ENTRY_CONFIGS, CP_RULES) + [
        cp.api_key_secret(i) for i in range(ENTRY_CONFIGS)] + list(extra)
    for k, doc in enumerate(docs):
        (Path(d) / f"{k:03d}.json").write_text(json.dumps(doc))
    return d


def entry_point_start(extra_argv, on_card: bool, log_path: Path) -> dict:
    """Phase 12 (e)'s and 15 (e)'s server over its manifests, started
    now (``ServerStart``); ``entry_point_drain`` drives and drains it."""
    from authorino_tpu_torch.models import control_plane as cp

    st = {"eports": [free_port() for _ in range(3)],
          "slow": cp.SlowEndpoint(0.3)}
    st["slow"].__enter__()
    st["tmp"] = entry_manifests(
        [cp.callback_auth_config(st["slow"].url + "/done")])
    eports = st["eports"]
    argv = [sys.executable, "-m", "authorino_tpu_torch", "server",
            "--watch-dir", st["tmp"], "--ext-auth-grpc-port",
            str(eports[0]), "--ext-auth-http-port", str(eports[1]),
            "--oidc-http-port", str(eports[2]), "--drain-timeout",
            str(ENTRY_DRAIN_S)] + list(extra_argv)
    if not on_card:
        argv += ["--device", "cpu"]
    st["server"] = ServerStart(argv, eports[1], log_path, "e")
    return st


def entry_point_drain(st: dict, on_card: bool) -> dict:
    """Phase 12 (e) and 15 (e): ``python3 -m authorino_tpu_torch server``
    (plus ``extra_argv``) as a subprocess over 16 API-key configs and a
    config whose callback keeps each Check() in flight after its verdict:
    32 gRPC and 8 HTTP Check()s equal to the oracle, its log naming the
    device, SIGTERM with 64 Check()s in flight — all 64 answered, exit 0
    within --drain-timeout + 5 s.  ``st`` is ``entry_point_start``'s
    server, started ahead.  Returns its figures (``log_head`` and
    ``log_tail``: its log)."""
    import shutil
    import signal

    import grpc

    from authorino_tpu_torch.authjson import (CheckRequestModel,
                                              HttpRequestAttributes)
    from authorino_tpu_torch.models import control_plane as cp
    from authorino_tpu_torch.protos import wire
    from authorino_tpu_torch.service.grpc_server import \
        request_proto_from_model
    from authorino_tpu_torch.utils import rpc

    e = {}
    eports, slow, srv = st["eports"], st["slow"], st["server"]
    proc, log_path = srv.proc, srv.log_path
    n_e = ENTRY_CONFIGS
    e_rules = cp.config_rules(n_e, CP_RULES)
    e_reqs, e_cfgs, e_known = cp.build_check_requests(32, n_e, seed=9)
    try:
        try:
            e["ready_s"] = srv.wait_ready()
            e_payloads = [wire.encode_check_request(
                request_proto_from_model(q)) for q in e_reqs]
            cb_payload = wire.encode_check_request(wire.CheckRequest(
                attributes=wire.AttributeContext(request=wire.Request(
                    http=wire.HttpRequest(method="GET", path="/",
                                          host=cp.CALLBACK_HOST)))))

            async def drive_entry():
                async with grpc.aio.insecure_channel(
                        f"127.0.0.1:{eports[0]}") as ch:
                    call = ch.unary_unary(CHECK_METHOD)
                    got = [wire.decode_check_response(r).status.code
                           for r in await asyncio.gather(
                               *(call(p) for p in e_payloads))]
                    http = [await asyncio.to_thread(
                        http_call, eports[1], q.http.path,
                        dict(q.http.headers, Host=q.http.host), None,
                        q.http.method) for q in e_reqs[:8]]
                    async def rows() -> int:
                        body = (await asyncio.to_thread(
                            http_call, eports[1], "/debug/vars"))[2]
                        # a CPU server's host lane folds its rows into
                        # the ledger's host lane
                        ledger = json.loads(body)["engine"]["kernel_cost"][
                            "ledger"]
                        return sum(ledger.get(k, {}).get("rows", 0)
                                   for k in ("engine", "host"))

                    rows0 = await rows()
                    futs = [asyncio.ensure_future(call(cb_payload))
                            for _ in range(64)]
                    # SIGTERM once every one of the 64 has its verdict (the
                    # server's cost ledger counted its row): each is then
                    # in its callback or queued for it, certainly in flight
                    while await rows() < rows0 + 64:
                        await asyncio.sleep(0.01)
                    e["hits_at_sigterm"] = slow.hits
                    proc.send_signal(signal.SIGTERM)
                    t_term = time.perf_counter()
                    answers = await asyncio.gather(*futs,
                                                   return_exceptions=True)
                    return got, http, answers, t_term

            got, http, answers, t_term = asyncio.run(drive_entry())
            rc = proc.wait(timeout=ENTRY_DRAIN_S + 30)
            e["sigterm_to_exit_s"] = time.perf_counter() - t_term
        finally:
            srv.kill()
        e["callback_hits"] = slow.hits
    finally:
        slow.__exit__(None, None, None)
        shutil.rmtree(st["tmp"], ignore_errors=True)
    text = log_path.read_text()
    want = [cp.expected_code(q, i, e_rules, good)
            for q, i, good in zip(e_reqs, e_cfgs, e_known)]
    if got != want:
        raise AssertionError(f"(e) gRPC {got} != oracle {want}")
    http_want = [rpc.http_status_for(cp.expected_code(
        CheckRequestModel(http=HttpRequestAttributes(
            method=q.http.method, path=q.http.path, host=q.http.host,
            headers=dict(q.http.headers))), i, e_rules, good))
        for q, i, good in zip(e_reqs[:8], e_cfgs, e_known)]
    if [s for s, _, _ in http] != http_want:
        raise AssertionError(f"(e) HTTP {[s for s, _, _ in http]} != "
                             f"{http_want}")
    codes = [wire.decode_check_response(r).status.code
             if isinstance(r, bytes) else repr(r) for r in answers]
    device_named = (f"policy engine on cuda" in text) if on_card else \
        ("policy engine on cpu" in text)
    if (rc != 0 or codes != [rpc.OK] * 64 or e["callback_hits"] != 64
            or e["hits_at_sigterm"] >= 64
            or e["sigterm_to_exit_s"] > ENTRY_DRAIN_S + 5
            or "drain complete" not in text or not device_named):
        raise AssertionError(f"(e) exit {rc} after "
                             f"{e['sigterm_to_exit_s']:.2f}s, in-flight "
                             f"answers {codes}, {e['callback_hits']} "
                             f"callbacks; log: {text[-3000:]}")
    e.update({"exit_code": rc, "grpc_codes": got,
              "http_statuses": [s for s, _, _ in http],
              "device_line": next((ln for ln in text.splitlines()
                                   if "policy engine on" in ln), ""),
              "native": "native grpc ext_authz listening" in text,
              "log_head": text[:20000], "log_tail": text[-3000:]})
    return e


def serving_surfaces(report: dict, card: str, dev, material: tuple,
                     n: int = CP_CONFIGS, n_checks: int = 4096) -> tuple:
    """Phase 12, the serving surfaces on the card: ``run_server`` (the
    port's CLI) on phase 10's manifests plus a wristband and a SpiceDB
    config, as a task on this loop: (a) the bootstrap; (b) phase 10 (a)'s
    burst through the gRPC server, each response held to the oracle and
    to the in-process answer, 256 of them over HTTP /check, every batch
    to the structural contract; (c) health, /metrics, /debug/vars, OIDC
    discovery, the webhooks, SpiceDB; (d) gRPC checks/s, burst and lone
    latency, the codec's host µs; then the server drained by cancelling
    its task.  (e) ``python3 -m authorino_tpu_torch server`` as a
    subprocess, drained by SIGTERM with 64 Check()s in flight.  Returns
    (the kernels' launches in (a)-(d), counts zeroed just before them; the
    max abs byte error of a batch of this corpus against plain)."""
    import os
    import signal
    import tempfile

    import grpc

    from authorino_tpu_torch import cli
    from authorino_tpu_torch.authjson import (CheckRequestModel,
                                              HttpRequestAttributes,
                                              build_authorization_json)
    from authorino_tpu_torch.compiler.encode import encode_batch
    from authorino_tpu_torch.compiler.pack import pack_batch
    from authorino_tpu_torch.models import control_plane as cp
    from authorino_tpu_torch.ops import fused_kernel as fk
    from authorino_tpu_torch.pipeline.pipeline import AuthResult
    from authorino_tpu_torch.protos import wire
    from authorino_tpu_torch.service.grpc_server import (
        check_response_from_result, request_model_from_proto,
        request_proto_from_model)
    from authorino_tpu_torch.utils import rpc

    on_card = dev.type == "cuda"
    # (e)'s process starts now: its start-up overlaps (a)-(d)
    entry = entry_point_start([], on_card,
                              Path("smoke_out") / "entry_point.log")
    rsa_ca, ec_ca, certs = material
    base = cp.build_auth_configs(n, CP_RULES)
    rules = cp.config_rules(n, CP_RULES)
    n_mtls = 2 * len(certs)
    reqs, cfgs, known = cp.build_check_requests(n_checks - n_mtls, n)
    mtls_reqs = [(mtls_request(k, pem), kind, rsa) for k, pem, kind, rsa
                 in certs * 2]
    models = reqs + [q for q, _, _ in mtls_reqs]
    oracle = ([cp.expected_code(q, i, rules, good)
               for q, i, good in zip(reqs, cfgs, known)]
              + [mtls_expected(kind, rsa, True)
                 for _, kind, rsa in mtls_reqs])
    payloads = [wire.encode_check_request(request_proto_from_model(q))
                for q in models]
    ports = {k: free_port() for k in ("grpc", "http", "oidc", "webhooks")}
    numbers = {"card": card, "ports": ports}
    swaps = []
    holder = {}

    def on_engine(engine):
        holder["engine"] = engine
        engine.add_swap_listener(lambda: swaps.append(
            (time.perf_counter(), engine.generation)))

    async def grpc_burst(call, items, window=None):
        """Every payload at once over one channel, or at most ``window`` in
        flight: (bytes, seconds)."""
        gate = asyncio.Semaphore(window or len(items) or 1)

        async def one(p):
            async with gate:
                t = time.perf_counter()
                raw = await call(p)
                return raw, time.perf_counter() - t

        return await asyncio.gather(*(one(p) for p in items))

    def hold_wire(k, raw, want_code, in_process):
        """One gRPC answer: its code and HTTP status the oracle's, its
        bytes those of the in-process Check()'s response (reason, headers,
        body, dynamic metadata)."""
        resp = wire.decode_check_response(raw)
        status = (resp.denied_response.status.code
                  if resp.denied_response is not None else 200)
        if (resp.status.code, status) != (want_code,
                                          rpc.http_status_for(want_code)):
            raise AssertionError(f"(b) gRPC check {k}: {resp.status.code}, "
                                 f"HTTP {status} != oracle {want_code} "
                                 f"({resp})")
        want = wire.encode_check_response(
            check_response_from_result(in_process))
        if raw != want:
            raise AssertionError(f"(b) gRPC check {k}: the response differs "
                                 f"from the in-process answer: "
                                 f"{resp} != {wire.decode_check_response(want)}")

    async def serve_and_drive(d: Path):
        fake = await FakeSpiceDB().start()
        surface_manifests(d, fake.port)
        argv = ["server", "--watch-dir", str(d), "--debug-profile",
                "--ext-auth-grpc-port", str(ports["grpc"]),
                "--ext-auth-http-port", str(ports["http"]),
                "--oidc-http-port", str(ports["oidc"]),
                "--slo-ms", str(SERVE_SLO_MS),
                "--flight-dir", str(d / "flight")]
        if not on_card:
            argv += ["--device", "cpu"]
        args = cli.build_parser().parse_args(argv)
        a = {}
        t0 = time.perf_counter()
        task = asyncio.ensure_future(cli.run_server(args, on_engine=on_engine))
        # ---- (a) the bootstrap ---------------------------------------------
        while not swaps:
            if task.done():
                task.result()
            await asyncio.sleep(0)
        engine = holder["engine"]
        a["bootstrap_swap_s"] = swaps[0][0] - t0
        res = await engine.check(reqs[0])
        a["bootstrap_check_in_process"] = [res.code, res.status, res.message]
        if (res.code, res.status, res.message) != (
                rpc.PERMISSION_DENIED, 503, "Busy"):
            raise AssertionError(f"(a) bootstrap: {res}")
        async with grpc.aio.insecure_channel(
                f"127.0.0.1:{ports['grpc']}") as ch:
            try:
                await ch.unary_unary(CHECK_METHOD, request_serializer=None)(
                    payloads[0], timeout=2.0)
                raise AssertionError("(a) the gRPC port answered before the "
                                     "first reconcile")
            except grpc.aio.AioRpcError as e:
                a["bootstrap_grpc"] = e.code().name
                if e.code() not in (grpc.StatusCode.UNAVAILABLE,
                                    grpc.StatusCode.DEADLINE_EXCEEDED):
                    raise
        while True:
            status, _, _ = await asyncio.to_thread(
                http_call, ports["http"], "/readyz", timeout=2)
            if status == 200:
                break
            if task.done():
                task.result()
            if time.perf_counter() - t0 > 120:
                raise AssertionError("(a) /readyz never turned 200")
            await asyncio.sleep(0.05)
        a["ready_s"] = time.perf_counter() - t0
        a["generation"] = engine.generation
        if engine.generation != 2:
            raise AssertionError(f"(a) generation {engine.generation} after "
                                 f"the first sync (want 2: the deny-all, "
                                 f"then the corpus)")
        log(f"serving surfaces (a): bootstrap deny-all swapped in "
            f"{a['bootstrap_swap_s']:.3f}s (an in-process Check() meanwhile "
            f"{a['bootstrap_check_in_process']}; a gRPC Check() "
            f"{a['bootstrap_grpc']}: the listeners bind after the first "
            f"reconcile, as the reference's), /readyz 200 after "
            f"{a['ready_s']:.2f}s")

        # ---- (b) the burst -------------------------------------------------
        b = {}
        async with grpc.aio.insecure_channel(
                f"127.0.0.1:{ports['grpc']}") as ch:
            call = ch.unary_unary(CHECK_METHOD)
            rec0, l0 = len(engine.batch_records), fk.launches
            t = time.perf_counter()
            out = await grpc_burst(call, payloads)
            b["first_burst_s"] = time.perf_counter() - t
            recs = checked_records(engine, rec0)
            device_batches = sum(r["device_rows"] > 0 for r in recs)
            if on_card and fk.launches - l0 != device_batches:
                raise AssertionError(f"(b) {fk.launches - l0} launches for "
                                     f"{device_batches} batches with a "
                                     f"device row")
            b["first_burst"] = {k: sum(r[k] for r in recs) for k in (
                "rows", "device_rows", "dedup_rows", "cache_rows",
                "launches", "plain_calls")}
            b["first_burst"]["batches"] = len(recs)
            in_process = await asyncio.gather(*(engine.check(q)
                                                for q in models))
            # the native frontend's slow lane sheds by CoDel admission (a
            # standing queue over --admission-target-ms for an interval):
            # a typed RESOURCE_EXHAUSTED, counted apart from the verdicts
            # and held to the frontend's own count below
            shed_raw = wire.encode_check_response(
                check_response_from_result(AuthResult(
                    code=rpc.RESOURCE_EXHAUSTED, message=SLOW_LANE_SHED)))
            shed = {k for k, (raw, _) in enumerate(out) if raw == shed_raw}
            for k, ((raw, _), want, res) in enumerate(zip(out, oracle,
                                                         in_process)):
                if k not in shed:
                    hold_wire(k, raw, want, res)
            b["native_sheds"] = len(shed)
            b["allowed"] = sum(c == rpc.OK for c in oracle)
            # HTTP /check: API-key requests as Envoy's HTTP filter sends
            # them (no metadata: the claims overrides resolve to nothing)
            picks = [j for j in range(0, len(reqs), max(1, len(reqs)
                                                        // SERVE_HTTP))
                     ][:SERVE_HTTP]

            def http_model(q):
                return CheckRequestModel(http=HttpRequestAttributes(
                    method=q.http.method, path=q.http.path, host=q.http.host,
                    headers=dict(q.http.headers)))

            http_out = await asyncio.gather(*(asyncio.to_thread(
                http_call, ports["http"], reqs[j].http.path,
                dict(reqs[j].http.headers, Host=reqs[j].http.host),
                None, reqs[j].http.method) for j in picks))
            http_in = await asyncio.gather(*(engine.check(http_model(reqs[j]))
                                             for j in picks))
            http_codes = {}
            for j, (status, headers, body), res in zip(picks, http_out,
                                                       http_in):
                want = cp.expected_code(http_model(reqs[j]), cfgs[j], rules,
                                        known[j])
                reason = dict((k.lower(), v) for k, v in headers).get(
                    "x-ext-auth-reason")
                if (status != rpc.http_status_for(want)
                        or res.code != want
                        or reason != (res.message or None if want else None)
                        or body != (res.body or "")):
                    raise AssertionError(
                        f"(b) HTTP check {j}: {status} {reason!r} {body!r} "
                        f"(oracle {want}; in process {res})")
                http_codes[status] = http_codes.get(status, 0) + 1
            b["http_statuses"] = http_codes
            recs = checked_records(engine, rec0)
            # which server answered: at the CLI's defaults the native
            # frontend where it starts (phase 15 (b) reads the comparison
            # of its answers with a grpc.aio server's on this engine)
            _, _, dv0 = await asyncio.to_thread(http_call, ports["http"],
                                                "/debug/vars")
            fe_vars = json.loads(dv0)["native_frontend"]
            b["server"] = ("native frontend" if fe_vars["enabled"]
                           else f"grpc.aio ({fe_vars['reason']})")
            overload = (fe_vars["admission"]["rejected"].get("overload", 0)
                        if fe_vars["enabled"] else 0)
            if overload != len(shed):
                raise AssertionError(f"(b) {len(shed)} shed answers, the "
                                     f"frontend counted {overload}")
            if fe_vars["enabled"]:
                from authorino_tpu_torch.service.grpc_server import \
                    build_server

                aio = build_server(engine, address="127.0.0.1:0")
                await aio.start()
                try:
                    async with grpc.aio.insecure_channel(
                            f"127.0.0.1:{aio.bound_port}") as ch2:
                        aio_out = await grpc_burst(
                            ch2.unary_unary(CHECK_METHOD), payloads,
                            window=AIO_WINDOW)
                finally:
                    await aio.stop(None)
                diff = [k for k, ((n_raw, _), (a_raw, _)) in enumerate(
                    zip(out, aio_out)) if n_raw != a_raw and k not in shed]
                if diff:
                    raise AssertionError(f"(b) native answers differ from "
                                         f"grpc.aio's at {diff[:8]}")
                st = fe_vars["stats"]
                numbers["native_vs_grpc_aio"] = {
                    "requests": len(payloads), "byte_differences": 0,
                    "shed": len(shed),
                    "fast": st["fast"], "slow": st["slow"],
                    "configs": n + CP_MTLS + 3,
                    "fast_configs": fe_vars["snapshot"]["fast_configs"]}
            log(f"serving surfaces (b), served by the {b['server']}: "
                f"{len(payloads)} concurrent gRPC "
                f"Check()s over one channel equal the oracle and the "
                f"in-process answer byte for byte ({b['allowed']} allowed; "
                f"{len(shed)} shed by the slow lane's admission, typed "
                f"RESOURCE_EXHAUSTED and counted); "
                f"{len(picks)} over HTTP /check equal the oracle "
                f"{http_codes}; {len(recs)} batches keep the structural "
                f"contract; first burst {b['first_burst']}; native vs a "
                f"grpc.aio server on this engine: "
                f"{numbers.get('native_vs_grpc_aio')}")

            # ---- (c) the surfaces ------------------------------------------
            c = {}
            health = ch.unary_unary(
                HEALTH_METHOD,
                request_serializer=wire.encode_health_request,
                response_deserializer=wire.decode_health_response)
            hr = await health(wire.HealthCheckRequest())
            if hr.status != wire.SERVING:
                raise AssertionError(f"(c) health {hr}")
            status, _, metrics = await asyncio.to_thread(
                http_call, ports["http"], "/metrics")
            c["metrics_has_response_status"] = \
                "auth_server_response_status" in metrics
            status_v, _, dvars = await asyncio.to_thread(
                http_call, ports["http"], "/debug/vars")
            c["debug_vars_generation"] = json.loads(dvars)["engine"][
                "generation"]
            if status != 200 or not c["metrics_has_response_status"] \
                    or c["debug_vars_generation"] != engine.generation:
                raise AssertionError(f"(c) /metrics {status}, /debug/vars "
                                     f"{status_v}: {c}")
            # phase 13 (e): the observability planes through the wire
            c["planes"] = plane_surfaces(metrics, json.loads(dvars)["engine"],
                                         d / "flight")
            wb = engine.lookup(WRISTBAND_HOST).runtime.response[0].evaluator
            for doc, want in (("openid-configuration", wb.openid_config()),
                              ("openid-connect/certs", wb.jwks())):
                status, _, got = await asyncio.to_thread(
                    http_call, ports["oidc"],
                    f"/{cp.NAMESPACE}/wristband/x-wristband/.well-known/{doc}")
                if (status, got) != (200, want):
                    raise AssertionError(f"(c) OIDC {doc}: {status} {got!r}")
            wh = asyncio.ensure_future(cli.run_webhooks(
                cli.build_parser().parse_args(
                    ["webhooks", "--webhook-service-port",
                     str(ports["webhooks"])])))
            try:
                resource = json.loads(json.dumps(base[0]))
                conv = {"request": {
                    "uid": "u1",
                    "desiredAPIVersion": "authorino.kuadrant.io/v1beta2",
                    "objects": [resource]}}
                review = {"request": {"uid": "u2", "operation": "CREATE",
                                      "object": dict(resource, spec={})}}
                while not listening(ports["webhooks"]):
                    await asyncio.sleep(0.02)
                s1, _, r1 = await asyncio.to_thread(
                    http_call, ports["webhooks"], "/convert",
                    {"Content-Type": "application/json"},
                    json.dumps(conv).encode())
                s2, _, r2 = await asyncio.to_thread(
                    http_call, ports["webhooks"], "/validate-authconfig",
                    {"Content-Type": "application/json"},
                    json.dumps(review).encode())
            finally:
                wh.cancel()
                try:
                    await wh
                except asyncio.CancelledError:
                    pass
            r1, r2 = json.loads(r1), json.loads(r2)
            converted = r1["response"]["convertedObjects"][0]
            if (s1, s2) != (200, 200) or r1["response"]["result"] != {
                    "status": "Success"} or converted["apiVersion"] != \
                    "authorino.kuadrant.io/v1beta2" or \
                    r2["response"]["allowed"] is not False:
                raise AssertionError(f"(c) webhooks: {s1} {r1} {s2} {r2}")
            c["webhooks"] = {"converted": converted["apiVersion"],
                             "validate_message": r2["response"]["status"][
                                 "message"]}
            db_codes = []
            for user in ("alice", "bob"):
                q = CheckRequestModel(http=HttpRequestAttributes(
                    method="GET", path="/doc-1", host=SPICEDB_HOST,
                    headers={"x-user": user}))
                raw = await call(wire.encode_check_request(
                    request_proto_from_model(q)))
                db_codes.append(wire.decode_check_response(raw).status.code)
            if db_codes != [rpc.OK, rpc.PERMISSION_DENIED] or fake.checks != 2:
                raise AssertionError(f"(c) SpiceDB: {db_codes}, "
                                     f"{fake.checks} CheckPermission calls")
            c["spicedb"] = db_codes
            log(f"serving surfaces (c): gRPC health SERVING; /metrics carries "
                f"auth_server_response_status; /debug/vars generation "
                f"{c['debug_vars_generation']}; OIDC discovery and JWKS equal "
                f"the wristband's; the webhooks converted one review and "
                f"refused one ({c['webhooks']['validate_message']!r}); "
                f"SpiceDB alice {db_codes[0]}, bob {db_codes[1]}")

            # ---- (d) numbers -----------------------------------------------
            def counts(before):
                return {k: engine.stats[k] - before[k] for k in (
                    "batches", "rows", "device_rows", "cache_rows",
                    "launches")}

            rates, lat, cuts, adm = [], [], [], []
            for _ in range(SERVE_BURSTS):
                st0 = dict(engine.stats)
                t = time.perf_counter()
                out_t = await grpc_burst(call, payloads)
                rates.append(len(payloads) / (time.perf_counter() - t))
                lat += [s for _, s in out_t]
                cuts.append(counts(st0))
                # the native slow lane's CoDel state after the burst
                _, _, dvb = await asyncio.to_thread(http_call, ports["http"],
                                                    "/debug/vars")
                fe_b = json.loads(dvb)["native_frontend"]
                if fe_b["enabled"]:
                    adm.append({k: fe_b["admission"][k] for k in (
                        "state", "queue_wait_ewma_s", "service_rate_rps",
                        "rejected")})
            # the same requests as CheckRequestModels straight into
            # engine.check() on this engine, beside the wire's bursts
            st0 = dict(engine.stats)
            t = time.perf_counter()
            timed = await timed_checks(engine, models)
            in_process_s = time.perf_counter() - t
            in_process_cuts = counts(st0)
            lone = []
            for p in payloads[:SERVE_LONE]:
                t = time.perf_counter()
                await call(p)
                lone.append(time.perf_counter() - t)
            launches = {"fused_megakernel": fk.launches,
                        "probe_add_one": fk.probe_launches}
            # /debug/profile: a torch.profiler capture during a burst of
            # requests the verdict cache has not seen
            fresh, _, _ = cp.build_check_requests(1024, n, seed=31)
            prof = asyncio.ensure_future(asyncio.to_thread(
                http_call, ports["http"], "/debug/profile?seconds=1.5",
                None, None, None, 60))
            await asyncio.sleep(0.3)
            await grpc_burst(call, [wire.encode_check_request(
                request_proto_from_model(q)) for q in fresh])
            status, _, body = await prof
            if status != 200:
                raise AssertionError(f"(d) /debug/profile {status}: {body}")
            trace = json.loads((Path(json.loads(body)["trace_dir"])
                                / "trace.json").read_text())
            events = trace.get("traceEvents", [])
            profile = {"events": len(events),
                       "kernel_events": sum(ev.get("cat") == "kernel"
                                            for ev in events),
                       "megakernel_events": sum(
                           ev.get("cat") == "kernel"
                           and "fused" in ev.get("name", "")
                           for ev in events)}
        d_ = {"checks_per_s": rates,
              "checks_per_s_median": statistics.median(rates),
              "first_burst_checks_per_s": len(payloads) / b["first_burst_s"],
              "burst_batches": cuts,
              "in_process_checks_per_s": len(models) / in_process_s,
              "in_process_batches": in_process_cuts}
        d_["in_process_latency_ms_p50"], d_["in_process_latency_ms_p99"] = \
            latency_ms([s for _, s in timed])
        d_["burst_latency_ms_p50"], d_["burst_latency_ms_p99"] = \
            latency_ms(lat)
        d_["first_burst_latency_ms_p50"], \
            d_["first_burst_latency_ms_p99"] = latency_ms(
                [s for _, s in out])
        d_["lone_latency_ms_p50"], d_["lone_latency_ms_p99"] = \
            latency_ms(lone)
        # the codec's host time per Check(): the request's decode, its
        # CheckRequestModel, the response's encode
        responses = [check_response_from_result(r) for r in in_process]
        decoded = [wire.decode_check_request(p) for p in payloads]
        for key, fn, items in (
                ("decode_us", wire.decode_check_request, payloads),
                ("model_us", request_model_from_proto, decoded),
                ("encode_us", wire.encode_check_response, responses)):
            t = time.perf_counter()
            for _ in range(3):
                for x in items:
                    fn(x)
            d_[key] = (time.perf_counter() - t) / (3 * len(items)) * 1e6
        d_["codec_us_per_check"] = d_["decode_us"] + d_["encode_us"]
        d_["launches"] = dict(launches)
        d_["native_admission"] = adm
        d_["debug_profile"] = profile

        # the server drains on cancellation and lets every port go
        task.cancel()
        try:
            await task
        except asyncio.CancelledError:
            pass
        bound = [p for k, p in ports.items() if listening(p)]
        if bound:
            raise AssertionError(f"ports still bound after the drain: {bound}")
        await fake.server.stop(None)
        return engine, a, b, c, d_, launches

    with tempfile.TemporaryDirectory() as tmp, \
            cp.PolicyRegistry(OPA_V1) as registry:
        d = Path(tmp)
        write_manifests(d, base, [0] * n, True, rsa_ca, ec_ca, registry.url,
                        ["1"] * n)
        fk.reset_counts()
        reset_host_counts()
        engine, a, b, c, d_, launches = asyncio.run(serve_and_drive(d))
    enc = encoder_used(engine, engine.stats["batches"])
    require_encoder("serving surfaces", enc, "native")
    numbers.update({"bootstrap": a, "burst": b, "surfaces": c,
                    "numbers": d_, "configs": n + CP_MTLS + 3,
                    "encoder": enc})

    # the mega-kernel on this corpus against its plain version, after the
    # counts were read (comparison launches do not count)
    policy, params = engine._snapshot.policy, engine._snapshot.params
    docs, rows = [], []
    for req, i, good in zip(reqs, cfgs, known):
        if good and len(docs) < 256:
            claims = req.metadata_context["filter_metadata"][cp.JWT_FILTER][
                "verified_jwt"]
            docs.append(build_authorization_json(req, {"identity": claims}))
            rows.append(policy.config_ids[f"{cp.NAMESPACE}/key-{i}"])
    db = pack_batch(policy, encode_batch(policy, docs, rows))
    max_err = 0
    if on_card:
        max_err = max(kernel_vs_plain(params, db, dev),
                      kernel_vs_plain(params, db, dev, global_tables=True))

    # ---- (e) the process entry point -----------------------------------------
    e = entry_point_drain(entry, on_card)
    e = {k: v for k, v in e.items() if not k.startswith("log_")}
    numbers["entry_point"] = e
    log(f"serving surfaces (e), served by the "
        f"{'native frontend' if e['native'] else 'grpc.aio'}: python3 -m "
        f"authorino_tpu_torch server ready "
        f"in {e['ready_s']:.1f}s ({e['device_line'].split(' INFO ')[-1]}); "
        f"32 gRPC and 8 HTTP Check()s equal the oracle; SIGTERM once 64 "
        f"Check()s had their verdicts ({e['hits_at_sigterm']} callbacks "
        f"begun): all 64 answered OK, exit {e['exit_code']} after "
        f"{e['sigterm_to_exit_s']:.2f}s (--drain-timeout {ENTRY_DRAIN_S:g})")
    numbers["launches"] = launches
    report["serving_surfaces"] = numbers
    return launches, max_err


# ---------------------------------------------------------------------------
# phase 11: the per-batch host work on either side of the launch
# ---------------------------------------------------------------------------

ENCODE_RUNS = 3           # timed runs per encoder and batch size
ENCODE_BATCHES = 20       # batches per timed run
BURST_RUNS = 1            # phase 6's burst (and phase 4's submits) per
                          # engine, in turns


def encode_times(policy, docs, rows, B: int) -> dict:
    """Host time per batch of ``B`` rows of each encoder on ``policy``:
    the native encoder walking the dicts (object), the native encoder from
    ``json.dumps`` of each document (JSON, as ``encode_batch`` runs it in
    that mode), the native JSON parse from bytes already serialized (what
    a wire frontend holds), and the Python encoder; ENCODE_RUNS runs of
    ENCODE_BATCHES distinct batches each, the encoders in turns (the order
    rotates per run).  Every batch's arrays are held byte-equal across
    the encoders.  Also the pack of a native batch."""
    import numpy as np

    from authorino_tpu_torch.compiler.encode import encode_batch_py
    from authorino_tpu_torch.compiler.pack import pack_batch
    from authorino_tpu_torch.native import get_native_encoder

    enc = get_native_encoder(policy)
    n = len(docs)
    slices = [([docs[(k * B + j) % n] for j in range(B)],
               [rows[(k * B + j) % n] for j in range(B)])
              for k in range(ENCODE_BATCHES)]
    parts = [[json.dumps(d, separators=(",", ":"), ensure_ascii=False)
              .encode() for d in ds] for ds, _ in slices]

    def native(mode):
        def run(k):
            enc.mode = mode
            return enc.encode_batch(*slices[k])
        return run

    fns = {"native_object": native("object"), "native_json": native("json"),
           "native_json_bytes": lambda k: enc.encode_json_parts(
               parts[k], slices[k][1]),
           "python": lambda k: encode_batch_py(policy, *slices[k])}
    fields = ("attrs_val", "attrs_members", "overflow", "cpu_lane",
              "config_id", "attr_bytes", "byte_ovf")
    names = list(fns)
    per_batch = {m: [] for m in names}
    try:
        for r in range(ENCODE_RUNS):
            outs = {}
            for m in names[r % len(names):] + names[:r % len(names)]:
                t = time.perf_counter()
                outs[m] = [fns[m](k) for k in range(ENCODE_BATCHES)]
                per_batch[m].append(
                    (time.perf_counter() - t) * 1e3 / ENCODE_BATCHES)
            for m in names:
                for k, (got, want) in enumerate(zip(outs[m],
                                                    outs["python"])):
                    if got is None:
                        raise AssertionError(f"B={B} {m} batch {k}: the "
                                             f"native encoder handed it back")
                    for f in fields:
                        g, w = getattr(got, f), getattr(want, f)
                        if g.dtype != w.dtype or g.tobytes() != w.tobytes():
                            raise AssertionError(f"B={B} {m} batch {k}: "
                                                 f"{f} differs from Python's")
    finally:
        enc.mode = "object"
    pack_ms = []
    for k in range(ENCODE_BATCHES):
        e = outs["native_object"][k]
        t = time.perf_counter()
        pack_batch(policy, e)
        pack_ms.append((time.perf_counter() - t) * 1e3)
    return {"B": B, "runs": ENCODE_RUNS, "batches_per_run": ENCODE_BATCHES,
            "ms_per_batch_runs": per_batch,
            "ms_per_batch_median": {m: statistics.median(v)
                                    for m, v in per_batch.items()},
            "pack_ms_median": statistics.median(pack_ms),
            "arrays_byte_equal": True}


def python_encoding_engine(entries, **kw):
    """An engine whose snapshot was installed with AUTHORINO_TPU_NATIVE=0:
    its corpus encodes in Python for the engine's life."""
    import os

    from authorino_tpu_torch.runtime import PolicyEngine

    old = os.environ.get("AUTHORINO_TPU_NATIVE")
    os.environ["AUTHORINO_TPU_NATIVE"] = "0"
    try:
        engine = PolicyEngine(max_batch=256, **kw)
        bind([e for e in entries if e.runtime is not None], engine)
        engine.apply_snapshot(entries)
    finally:
        if old is None:
            del os.environ["AUTHORINO_TPU_NATIVE"]
        else:
            os.environ["AUTHORINO_TPU_NATIVE"] = old
    if engine._snapshot.encoder is not None:
        raise AssertionError("AUTHORINO_TPU_NATIVE=0 installed a native "
                             "encoder")
    return engine


def host_work(report: dict, card: str, ctx: dict, main: dict, policy,
              docs, rows, batch_p50_ms: float) -> None:
    """Phase 11 on the north-star corpus at full width: (a) the encoders'
    host time per batch at B = 256 and 16, every array byte-equal across
    them; (b) phase 6's 4,096-Check() burst through phase 6's engine
    (native encoder) and a Python-encoding engine, in turns, every result
    held to phase 6's oracle; and phase 4's 4,096 submits the same way,
    every verdict held to the expression oracle.  (c), the heat maps
    against the oracle, ran inside phases 6 and 9."""
    import numpy as np

    from authorino_tpu_torch.models.policy_model import host_results

    # ---- (a) encode time per batch -----------------------------------------
    enc_times = {B: encode_times(policy, docs, rows, B) for B in (256, 16)}
    for B, e in enc_times.items():
        m = e["ms_per_batch_median"]
        log(f"[{card}] encode B={B} (median of {e['runs']} runs x "
            f"{e['batches_per_run']} batches, host ms per batch): native "
            f"object {m['native_object']:.3f}, native JSON "
            f"{m['native_json']:.3f} (from bytes "
            f"{m['native_json_bytes']:.3f}), Python {m['python']:.3f}; "
            f"pack {e['pack_ms_median']:.3f}; arrays byte-equal across all")

    # ---- (b) phase 6's burst, native against Python, in turns --------------
    nat, entries, reqs, hold = (ctx["engine"], ctx["entries"], ctx["reqs"],
                                ctx["hold"])
    py = python_encoding_engine(entries, **NO_REUSE)
    if nat._snapshot.encoder is None:
        raise AssertionError("phase 11 (b): phase 6's engine is not native")
    engines = {"native": nat, "python": py}
    want = {"native": "native", "python": "native off (AUTHORINO_TPU_NATIVE=0)"}
    runs = {k: [] for k in engines}
    order = [("native", "python"), ("python", "native")]
    for r in range(BURST_RUNS):
        for key in order[r % 2]:
            e = engines[key]
            bind(entries, e)
            e.batch_latency_s.clear()
            b0 = e.stats["batches"]
            reset_host_counts()
            t = time.perf_counter()
            out = asyncio.run(timed_checks(e, reqs))
            wall = time.perf_counter() - t
            hold(out, f"phase 11 (b) {key} run {r + 1}")
            use = encoder_used(e, e.stats["batches"] - b0)
            require_encoder(f"phase 11 (b) {key}", use, want[key])
            runs[key].append({"checks_per_s": len(reqs) / wall,
                              "latency_s": [x for _, x in out],
                              "batch_latency_s": list(e.batch_latency_s),
                              "encoder": use})

    async def one_at_a_time(e, rs):
        return [(await timed_checks(e, [q]))[0][1] for q in rs]

    lone = {}
    for key in ("native", "python", "python", "native"):
        e = engines[key]
        bind(entries, e)
        lone.setdefault(key, []).extend(asyncio.run(one_at_a_time(
            e, reqs[:100])))
    bind(entries, nat)

    def fig(key):
        rs = runs[key]
        lat = np.sort(np.concatenate([x["latency_s"] for x in rs])) * 1e3
        blat = np.sort(np.concatenate([x["batch_latency_s"]
                                       for x in rs])) * 1e3
        lo = np.sort(lone[key]) * 1e3
        rates = [x["checks_per_s"] for x in rs]
        return {"checks_per_s": rates,
                "checks_per_s_median": statistics.median(rates),
                "check_latency_ms_p50": float(np.percentile(lat, 50)),
                "check_latency_ms_p99": float(np.percentile(lat, 99)),
                "lone_check_latency_ms_p50": float(np.percentile(lo, 50)),
                "lone_check_latency_ms_p99": float(np.percentile(lo, 99)),
                "batch_latency_ms_p50": float(np.percentile(blat, 50)),
                "batch_latency_ms_p99": float(np.percentile(blat, 99)),
                "batches": len(blat), "encoder": rs[-1]["encoder"]}

    burst = {k: fig(k) for k in engines}
    for key, f in burst.items():
        log(f"[{card}] phase 6's burst, {key} encoder ({BURST_RUNS} runs in "
            f"turns): {f['checks_per_s_median']:.0f} checks/s "
            f"({[round(x) for x in f['checks_per_s']]}), Check() p50 "
            f"{f['check_latency_ms_p50']:.2f} ms p99 "
            f"{f['check_latency_ms_p99']:.2f} ms; a lone Check() p50 "
            f"{f['lone_check_latency_ms_p50']:.3f} ms p99 "
            f"{f['lone_check_latency_ms_p99']:.3f} ms; batch latency p50 "
            f"{f['batch_latency_ms_p50']:.2f} ms p99 "
            f"{f['batch_latency_ms_p99']:.2f} ms over {f['batches']} "
            f"batches; every result equals the oracle")
    # phase 4's submits (no pipeline: encode is a larger share)
    m_engines = {"native": main["engine"],
                 "python": python_encoding_engine(main["entries"],
                                                  **NO_REUSE)}
    m_docs, m_names = main["docs"], main["names"]
    m_runs = {k: [] for k in m_engines}
    for r in range(BURST_RUNS):
        for key in order[r % 2]:
            e = m_engines[key]
            e.batch_latency_s.clear()
            t = time.perf_counter()
            out = asyncio.run(serve(e, m_docs, m_names))
            m_runs[key].append((len(m_docs) / (time.perf_counter() - t),
                                list(e.batch_latency_s)))
            if key == "python" and r == 0:
                pol = e._snapshot.policy
                for k, ((rule, skipped), d, n) in enumerate(
                        zip(out, m_docs, m_names)):
                    own, w_rule, w_skip = host_results(
                        pol, d, pol.config_ids[n])
                    if (bool(np.all(skipped | rule)) != own
                            or skipped.tolist() != w_skip.tolist()):
                        raise AssertionError(f"phase 11 (b) submit {k}: "
                                             f"differs from the oracle")
    submit = {}
    for key, rs in m_runs.items():
        blat = np.sort(np.concatenate([b for _, b in rs])) * 1e3
        rates = [x for x, _ in rs]
        submit[key] = {"decisions_per_s": rates,
                       "decisions_per_s_median": statistics.median(rates),
                       "batch_latency_ms_p50": float(np.percentile(blat, 50)),
                       "batch_latency_ms_p99": float(np.percentile(blat, 99))}
        log(f"[{card}] phase 4's submits, {key} encoder ({BURST_RUNS} runs "
            f"in turns): {submit[key]['decisions_per_s_median']:.0f} "
            f"decisions/s ({[round(x) for x in rates]}), batch latency p50 "
            f"{submit[key]['batch_latency_ms_p50']:.2f} ms p99 "
            f"{submit[key]['batch_latency_ms_p99']:.2f} ms")
    share = {k: enc_times[256]["ms_per_batch_median"][k] / batch_p50_ms
             for k in ("native_object", "python")}
    log(f"[{card}] encode B=256 against phase 5's batch latency p50 "
        f"{batch_p50_ms:.2f} ms: native object {share['native_object']:.3f}"
        f", Python {share['python']:.3f} of it")
    report["host_work"] = {
        "card": card,
        "encode": {str(B): e for B, e in enc_times.items()},
        "burst": burst, "burst_runs": BURST_RUNS, "submit": submit,
        "encode_share_of_phase5_batch_p50": share,
        "heat": {"request_path (dedup, cache off)":
                 report["request_path"]["heat"],
                 "serving_core (dedup, cache on)":
                 report["serving_core"]["heat"]},
    }


# ---------------------------------------------------------------------------
# phase 13: the engine's observability planes
# ---------------------------------------------------------------------------

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
FLIGHT_KEEP = 2           # phase 13 (d)'s --flight-keep
OVERLOAD_ENTRIES = 3      # entries into OVERLOADED (d) drives, at most
OVERLOAD_BURSTS = 8       # warm bursts (d) may take to get them
PLANE_PAIRS = 1           # (f): planes on / off pairs, order alternating
SLO_P50_TRIES = 5         # (c): runs the p50 target may take
LEDGER_OF_RECORD = {"rows": "rows", "device_rows": "device_rows",
                    "pad_rows": "pad_rows", "dedup_avoided_rows": "dedup_rows",
                    "cache_avoided_rows": "cache_rows",
                    "h2d_bytes": "h2d_bytes", "d2h_bytes": "d2h_bytes"}


def reconcile_phases(cp: dict) -> set:
    """The phases a reconcile records: compile alone where the compile
    cache reused the installed policy and params (the same corpus again),
    else compile, diff and upload."""
    reused = (cp.get("compile") or {}).get("reused_policy")
    return {"compile"} if reused else {"compile", "diff", "upload"}


def plane_surfaces(metrics: str, dv: dict, flight_dir: Path) -> dict:
    """Phase 13 (e): a server's /metrics carries every family of the
    planes and its /debug/vars engine block the slo, flight_recorder,
    kernel_cost and control_plane sections, set by its flags."""
    typed = {ln.split()[2] for ln in metrics.splitlines()
             if ln.startswith("# TYPE ")}
    missing = [f for f in PLANE_FAMILIES
               if not {f, f.removesuffix("_total")} & typed]
    slo, fr, kc = dv.get("slo"), dv.get("flight_recorder"), dv.get(
        "kernel_cost")
    cp = dv.get("control_plane")
    if (missing or not slo or slo["slo_ms"] != SERVE_SLO_MS or not fr
            or fr["dump_dir"] != str(flight_dir) or not kc
            or "engine" not in kc["ledger"]
            or kc["entry_points"][-1]["entry"] != "fused_kernel"
            or not kc["modeled"]["current"]["entries"] or not cp
            or set(cp["phases_ms"]) != reconcile_phases(cp)):
        raise AssertionError(f"(e) the planes through the wire: missing "
                             f"families {missing}; slo {slo}; flight "
                             f"recorder {fr and fr['dump_dir']}; control "
                             f"plane {cp}")
    return {"families": len(PLANE_FAMILIES), "slo_observed": slo[
        "observed_total"], "ledger_launches": kc["ledger"]["engine"][
        "launches"], "flight_events": fr["events_recorded"],
        "phases_ms": cp["phases_ms"]}


def prom_sample(family: str, name: str, labels: dict) -> float:
    """One sample of the port's metric ``family`` (its attribute in
    ``utils/metrics.py``), read from that family's own collector: a
    registry-wide lookup collects every series of the process, tens of
    thousands of rule-fired series by now."""
    from authorino_tpu_torch.utils import metrics

    for fam in getattr(metrics, family).collect():
        for smp in fam.samples:
            if smp.name == name and smp.labels == labels:
                return smp.value
    return 0.0


STAGES = ("encode", "launch", "device", "resolve")


def stage_histograms() -> dict:
    """The engine lane's ``auth_server_pipeline_stage_seconds`` per stage:
    (count, sum, {le: cumulative count})."""
    from authorino_tpu_torch.utils.metrics import STAGE_BUCKETS

    from authorino_tpu_torch.utils import metrics

    got = {}
    for fam in metrics.pipeline_stage_duration.collect():
        for smp in fam.samples:
            if smp.labels.get("lane") == "engine":
                got[(smp.name, smp.labels["stage"],
                     smp.labels.get("le"))] = smp.value
    name = "auth_server_pipeline_stage_seconds"
    return {st: (got.get((name + "_count", st, None), 0.0),
                 got.get((name + "_sum", st, None), 0.0),
                 {le: got.get((name + "_bucket", st, repr(float(le))), 0.0)
                  for le in STAGE_BUCKETS})
            for st in STAGES}


def stage_split(before: dict, after: dict) -> dict:
    """Per stage over a window: batches, mean ms, and the bucket that holds
    the median batch (its bounds in ms), from the histograms' deltas."""
    out = {}
    for st in STAGES:
        n = after[st][0] - before[st][0]
        total = after[st][1] - before[st][1]
        lo, p50 = 0.0, None
        for le, c in after[st][2].items():
            if c - before[st][2][le] >= n / 2:
                p50 = (lo * 1e3, le * 1e3)
                break
            lo = le
        out[st] = {"batches": int(n), "mean_ms": total / n * 1e3 if n else 0.0,
                   "median_bucket_ms": p50 or (lo * 1e3, float("inf"))}
    return out


def wait_idle(engine, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while engine._inflight or engine._queue:
        if time.monotonic() > deadline:
            raise AssertionError(f"engine not idle after {timeout}s")
        time.sleep(0.005)


def observability_planes(report: dict, card: str, dev, ctx6: dict,
                         cycles_per_ms: float) -> tuple:
    """Phase 13: phase 6's translated north-star corpus (1,000 AuthConfigs
    x 10 rules + the V2 config) rebound to an engine at the reference's
    serving defaults (dedup and the cache on; wide admission bounds, so
    the phase holds verdicts, not shedding), with the flight recorder on
    and its bundles in ``smoke_out/flight-13``.  Every count is zeroed just
    before the engine is built.  (c) 4,096-Check() bursts, each held to
    the oracle, each with its own SLO target: the phase's lone-Check()
    p50, 1 ns, 10 s, and the p50 of the SLO latencies of the burst before
    (retried until a run has some bad and some good requests);
    (f) planes on / off in alternating pairs; (d) warm bursts with the
    admission target at 1 µs and its interval at 0.1 s, until admission
    has entered OVERLOADED ``OVERLOAD_ENTRIES`` times; then (a) the cost
    ledger's deltas against the batch records and the wrapper's count;
    (b) the model against ``own_config_ops``/``kernel_work`` and the
    kernel's time on a batch of this corpus (after the counted window).
    (e) is phase 12's server.  Returns (the kernels' launches, counts
    zeroed just before the engine; the max abs byte error against
    plain)."""
    import shutil

    import numpy as np
    import torch

    from authorino_tpu_torch.authjson import build_authorization_json
    from authorino_tpu_torch.compiler.encode import encode_batch
    from authorino_tpu_torch.compiler.pack import pack_batch
    from authorino_tpu_torch.models import northstar
    from authorino_tpu_torch.ops import fused_kernel as fk
    from authorino_tpu_torch.ops.operands import fuse_batch
    from authorino_tpu_torch.runtime import PolicyEngine
    from authorino_tpu_torch.runtime import kernel_cost as kc
    from authorino_tpu_torch.runtime.flight_recorder import RECORDER
    from authorino_tpu_torch.utils.slo import SloTracker

    entries, reqs, hold = ctx6["entries"], ctx6["reqs"], ctx6["hold"]
    # the wall clock against the monotonic one: a step of the machine's
    # clock during the phase shows here (the SLO windows bucket by it)
    wall_off0 = time.time() - time.monotonic()
    flight = Path("smoke_out") / "flight-13"
    shutil.rmtree(flight, ignore_errors=True)
    RECORDER.configure(dump_dir=str(flight), keep=FLIGHT_KEEP,
                       min_dump_interval_s=0.0, enabled=True)
    dumps0 = RECORDER.dumps[-1] if RECORDER.dumps else None
    lane = {"lane": "engine"}

    fk.reset_counts()
    reset_host_counts()
    led0 = kc.LEDGER.snapshot("engine")
    engine = PolicyEngine(max_batch=256, **WIDE_ADMISSION)
    bind(entries, engine)
    engine.apply_snapshot(entries)
    cpn = engine.debug_vars()["control_plane"]
    if set(cpn["phases_ms"]) != {"compile", "diff", "upload"} or \
            cpn["upload"]["mode"] != "full":
        raise AssertionError(f"(b) a fresh engine's install: {cpn}")
    # every batch's per-request SLO latency (queue wait + the batch's
    # device stage), as the engine hands it to its tracker
    slo_lat = []
    fold = engine._observe_batch

    def spy(item, dur):
        slo_lat.append(np.asarray(item.waits) + dur)
        return fold(item, dur)

    engine._observe_batch = spy

    async def one_at_a_time(rs):
        return [(await timed_checks(engine, [r]))[0][1] for r in rs]

    lone = np.sort(asyncio.run(one_at_a_time(reqs[:200]))) * 1e3
    lone_p50 = float(np.percentile(lone, 50))

    def burst(label):
        engine.batch_latency_s.clear()
        t = time.perf_counter()
        out = asyncio.run(timed_checks(engine, reqs))
        wall = time.perf_counter() - t
        wait_idle(engine)
        hold(out, label)
        lat = sorted(engine.batch_latency_s)
        return {"checks_per_s": len(reqs) / wall,
                "batch_p50_ms": lat[len(lat) // 2] * 1e3 if lat else 0.0}

    # ---- (c) the SLO at four targets ----------------------------------------
    # the host's spread can move a whole burst's latencies past the median
    # of the burst before, so the p50 target is retried, each time at the
    # p50 of the run before, until one run lands strictly inside
    slo_runs = []
    target = lone_p50
    names = ["lone p50", "1 ns", "10 s"] + ["p50 of the burst before"] * \
        SLO_P50_TRIES
    for name in names:
        if name == "1 ns":
            target = 1e-6
        elif name == "10 s":
            target = 10_000.0
        elif name.startswith("p50"):
            target = float(np.percentile(np.concatenate(slo_lat), 50)) * 1e3
        engine.slo = SloTracker("engine", target)
        slo_lat.clear()
        h0 = stage_histograms()
        c0 = (prom_sample("slo_observed_total",
                          "auth_server_slo_observed_total", lane),
              prom_sample("slo_bad_total", "auth_server_slo_bad_total", lane))
        fig = burst(f"phase 13 (c) SLO {name}")
        fig["stages"] = stage_split(h0, stage_histograms())
        lat = np.concatenate(slo_lat)
        js = engine.debug_vars()["slo"]
        want_bad = int(np.count_nonzero(lat > engine.slo.slo_s))
        run = {"target": name, "slo_ms": target, "total": js[
            "observed_total"], "bad": js["bad_total"], "window_1m": js[
            "windows"]["1m"], **fig}
        slo_runs.append(run)
        prom = (prom_sample("slo_observed_total",
                            "auth_server_slo_observed_total", lane) - c0[0],
                prom_sample("slo_bad_total", "auth_server_slo_bad_total",
                            lane) - c0[1])
        # the windows bucket by the wall clock, as the reference's do: a
        # step of the machine's clock moves requests out of them, so they
        # are printed, not held
        ok = (js["observed_total"] == lat.size == len(reqs)
              and js["bad_total"] == want_bad
              and prom == (js["observed_total"], js["bad_total"]))
        ok &= {"1 ns": want_bad == len(reqs), "10 s": want_bad == 0}.get(
            name, True)
        if not ok:
            raise AssertionError(f"(c) SLO {name}: {run}, {want_bad} bad by "
                                 f"the script's count, metrics {prom}")
        if name.startswith("p50") and 0 < want_bad < len(reqs):
            break
    else:
        raise AssertionError(f"(c) no run at the p50 of the run before "
                             f"landed strictly inside: {slo_runs}")

    # ---- (f) planes on / off, alternating -------------------------------------
    pairs = {"on": [], "off": []}
    for k in range(PLANE_PAIRS):
        for side in (("on", "off") if k % 2 == 0 else ("off", "on")):
            engine.slo = (SloTracker("engine", lone_p50) if side == "on"
                          else None)
            RECORDER.configure(enabled=side == "on")
            pairs[side].append(burst(f"phase 13 (f) planes {side}"))
    RECORDER.configure(enabled=True)

    # ---- (d) the flight recorder: admission into OVERLOADED ------------------
    def overloaded_events() -> float:
        return prom_sample("flight_events",
                           "auth_server_flight_recorder_events_total",
                           {"kind": "admission-overloaded"})

    ev0 = overloaded_events()
    adm = engine.admission
    adm.target_s, adm.interval_s = 1e-6, 0.1
    bursts = 0
    while bursts < OVERLOAD_BURSTS and \
            overloaded_events() - ev0 < OVERLOAD_ENTRIES:
        # past 2 intervals with no cut the state resets to admit at the
        # next decision, so each burst can enter OVERLOADED anew; a bundle
        # is named by its second, so bursts stay a second apart
        time.sleep(1.05)
        burst(f"phase 13 (d) burst {bursts + 1}")
        bursts += 1
    entries_ov = int(overloaded_events() - ev0)
    deadline = time.monotonic() + 30
    new_dumps = []
    while time.monotonic() < deadline:
        k = RECORDER.dumps.index(dumps0) + 1 if dumps0 in RECORDER.dumps \
            else 0
        new_dumps = RECORDER.dumps[k:]
        if len(new_dumps) >= entries_ov:
            break
        time.sleep(0.02)
    on_disk = sorted(flight.glob("flight-*.json"))
    bundle = json.loads(on_disk[-1].read_text()) if on_disk else {}
    dv = bundle.get("vars", {}).get("engine", {})
    b_led = dv.get("kernel_cost", {}).get("ledger", {}).get("engine", {})
    line = [ln for ln in bundle.get("metrics", "").splitlines()
            if ln.startswith('auth_server_kernel_launches_total{lane="engine"}')]
    flight_fig = {"bursts": bursts, "entries": entries_ov,
                  "dumps": len(new_dumps), "on_disk": len(on_disk),
                  "keep": FLIGHT_KEEP,
                  "bundle_schema": bundle.get("schema"),
                  "bundle_trigger": bundle.get("trigger"),
                  "bundle_ledger_launches": b_led.get("launches"),
                  "bundle_exposition_launches": (float(line[0].split()[-1])
                                                 if line else None),
                  "overloaded_rejections": dict(adm.rejected)}
    if (entries_ov < 1 or len(new_dumps) != entries_ov
            or not all("admission-overloaded" in p for p in new_dumps)
            or [p.name for p in on_disk] != sorted(
                Path(p).name for p in new_dumps[-FLIGHT_KEEP:])
            or bundle.get("schema") != 1
            or dv.get("generation") != engine.generation
            or not dv.get("kernel_cost", {}).get("modeled", {}).get("current")
            or flight_fig["bundle_exposition_launches"] != b_led.get(
                "launches")):
        raise AssertionError(f"(d) flight recorder: {flight_fig}; dumps "
                             f"{new_dumps}; on disk {on_disk}")
    adm.target_s, adm.interval_s = WIDE_ADMISSION["admission_target_s"], 0.5

    # ---- (a) the ledger over the phase ----------------------------------------
    wait_idle(engine)
    launches = {"fused_megakernel": fk.launches,
                "probe_add_one": fk.probe_launches}
    led1 = kc.LEDGER.snapshot("engine")
    d = {k: led1[k] - led0[k] for k in led1 if isinstance(led1[k], int)
         and k in led0}
    recs = checked_records(engine)
    with_rows = [r for r in recs if r["device_rows"]]
    sums = {k: sum(r[rk] for r in recs) for k, rk in LEDGER_OF_RECORD.items()}
    ledger_fig = dict(d, records=len(recs), batches_with_device_rows=len(
        with_rows), wrapper_launches=launches["fused_megakernel"])
    if (d["batches"] != len(recs)
            or d["launches"] != sum(r["launches"] for r in recs)
            or d["launches"] != launches["fused_megakernel"]
            or d["launches"] != len(with_rows)
            or any(r["launches"] != 1 for r in with_rows)
            or d["zero_launch_batches"] != len(recs) - len(with_rows)
            or any(d[k] != v for k, v in sums.items())
            or launches["probe_add_one"] < 1):
        raise AssertionError(f"(a) ledger {d} vs records {sums}, "
                             f"{len(recs)} batches, {len(with_rows)} with "
                             f"device rows; wrapper {launches}")

    # ---- (b) the model against the script's own count -------------------------
    snap = engine._snapshot
    params, policy = snap.params, snap.policy
    jwt = northstar.JWT_FILTER
    docs = [build_authorization_json(q, {"identity": q.metadata_context[
        "filter_metadata"][jwt]["verified_jwt"]}) for q in reqs[:256]]
    rows = [policy.config_ids[engine.lookup(q.http.host).rules.name]
            for q in reqs[:256]]
    db = pack_batch(policy, encode_batch(policy, docs, rows))
    K, LB = db.members_c.shape[2], db.attr_bytes.shape[2]
    t = time.perf_counter()
    mine = own_config_ops(params, K, LB)
    walk_ms = (time.perf_counter() - t) * 1e3
    model = kc.config_ops(params, K, LB)
    moved, ops = kernel_work(params, db)
    if not np.array_equal(mine, model) or (moved, ops) != kc.batch_work(
            params, db):
        raise AssertionError(f"(b) the model {kc.batch_work(params, db)} "
                             f"!= kernel_work {(moved, ops)}, or per-config "
                             f"ops differ on {np.nonzero(mine != model)[0][:8]}")
    max_err = kernel_vs_plain(params, db, dev)
    buf, layout = fuse_batch(db)
    buf_dev = torch.from_numpy(buf).to(dev)
    kout = torch.empty((256, policy.fused_pack_w), dtype=torch.uint8,
                       device=dev)
    launch = (lambda: fk.launch_kernel(params, buf_dev, layout, kout))
    k_ms, _ = device_times_ms(launch, 100)
    k_b2b, _ = back_to_back_ms(launch, cycles_per_ms)
    b_ms, b_by = bound_ms(moved, ops)
    rec = cpn["kernel_cost"]["entries"]["fused_kernel"]
    model_fig = {"configs": policy.n_configs, "ops_per_row": ops / 256,
                 "bytes_per_row": moved / 256,
                 "bound_ms_per_row": b_ms / 256, "bound_by": b_by,
                 "bound_ms": b_ms, "kernel_ms_median": statistics.median(k_ms),
                 "kernel_back_to_back_ms": k_b2b,
                 "model_at_swap_ms": cpn["kernel_cost_ms"],
                 "phases_ms": cpn["phases_ms"],
                 "own_config_ops_walk_ms": walk_ms, "record": rec,
                 "LB": LB, "K": K}

    clock_step_s = time.time() - time.monotonic() - wall_off0
    numbers = {"card": card, "lone_p50_ms": lone_p50, "slo": slo_runs,
               "wall_clock_step_s": clock_step_s,
               "pairs": pairs, "flight": flight_fig, "ledger": ledger_fig,
               "model": model_fig, "launches": launches}
    report["observability_planes"] = numbers
    med = {s: {k: statistics.median(r[k] for r in pairs[s])
               for k in ("checks_per_s", "batch_p50_ms")} for s in pairs}
    log(f"observability planes (a): over the phase the engine lane moved "
        f"{d['batches']} batches, {d['launches']} launches "
        f"({d['zero_launch_batches']} batches the cache answered whole), "
        f"{d['rows']} rows, {d['device_rows']} device rows, "
        f"{d['pad_rows']} pad rows, {d['dedup_avoided_rows']} saved by "
        f"dedup, {d['cache_avoided_rows']} by the cache, H2D {d['h2d_bytes']}"
        f" B, D2H {d['d2h_bytes']} B: equal to the batch records' sums and "
        f"to the wrapper's {launches['fused_megakernel']} launches, one per "
        f"batch with a device row")
    log(f"[{card}] observability planes (b): the model equals "
        f"own_config_ops on all {policy.n_configs} configs and kernel_work "
        f"on a 256-row batch (LB {LB}): {model_fig['ops_per_row']:.1f} int "
        f"ops and {model_fig['bytes_per_row']:.1f} B per row, bound "
        f"{model_fig['bound_ms_per_row'] * 1e6:.4f} ns per row "
        f"({b_ms:.7f} ms per batch, by {b_by}; 3.35 TB/s, 33.5 TOPS) beside "
        f"the kernel's {model_fig['kernel_ms_median']:.4f} ms one call, "
        f"{k_b2b:.4f} ms back to back on this batch; the model at the swap "
        f"{cpn['kernel_cost_ms']:.3f} ms beside the upload phase "
        f"{cpn['phases_ms']['upload']:.3f} ms (compile "
        f"{cpn['phases_ms']['compile']:.3f} ms; the script's own walk "
        f"{walk_ms:.1f} ms); record {rec}")
    log(f"[{card}] observability planes: stage split per batch of the cold "
        f"burst (mean ms; the median batch's bucket) " + "; ".join(
            f"{st} {v['mean_ms']:.3f} ({v['median_bucket_ms'][0]:g}-"
            f"{v['median_bucket_ms'][1]:g}) over {v['batches']}"
            for st, v in slo_runs[0]["stages"].items()) + "; a warm burst: "
        + "; ".join(f"{st} {v['mean_ms']:.3f} ({v['median_bucket_ms'][0]:g}-"
                    f"{v['median_bucket_ms'][1]:g})"
                    for st, v in slo_runs[2]["stages"].items()))
    log(f"[{card}] observability planes (c): a lone Check() p50 "
        f"{lone_p50:.3f} ms; " + "; ".join(
            f"target {r['target']} ({r['slo_ms']:.6g} ms): {r['bad']} bad "
            f"of {r['total']} (1m window {r['window_1m']['bad']} of "
            f"{r['window_1m']['total']}), {r['checks_per_s']:.0f} checks/s"
            for r in slo_runs) + f"; /debug/vars and auth_server_slo_* "
        f"agree; the wall clock moved {clock_step_s:+.3f} s against the "
        f"monotonic one over the phase")
    log(f"[{card}] observability planes (d): {bursts} warm bursts with the "
        f"admission target at 1 us and its interval at 0.1 s entered "
        f"OVERLOADED {entries_ov} times: {len(new_dumps)} bundles, "
        f"{len(on_disk)} kept on disk (--flight-keep {FLIGHT_KEEP}), schema "
        f"{bundle.get('schema')}, the exposition's engine launches "
        f"{flight_fig['bundle_exposition_launches']:.0f} = the ledger's "
        f"{b_led.get('launches')}")
    log(f"[{card}] observability planes (f), {PLANE_PAIRS} pairs: planes on "
        f"{med['on']['checks_per_s']:.0f} checks/s, batch p50 "
        f"{med['on']['batch_p50_ms']:.2f} ms; off "
        f"{med['off']['checks_per_s']:.0f} checks/s, batch p50 "
        f"{med['off']['batch_p50_ms']:.2f} ms (runs on "
        f"{[round(r['checks_per_s']) for r in pairs['on']]}, off "
        f"{[round(r['checks_per_s']) for r in pairs['off']]})")
    return launches, max_err


# ---------------------------------------------------------------------------
# phase 14: the failure handling
# ---------------------------------------------------------------------------

FAIL_THRESHOLD = 3        # phase 14's breaker_threshold
FAIL_RESET_S = 0.5        # its breaker_reset_s
FAIL_TIMEOUT_S = 0.25     # its device_timeout_s
FAULT_SEED = 7            # the fault plane's seed in every part
FLAP_S = 1.0              # (b): the device is down this long
WEDGE_CYCLES = 3          # (c): wedged batches, one healthy check apart
WEDGE_ROWS = 256          # (c): rows of a wedged batch (one cut)
SLOW_LONE = 24            # (d): lone Check()s, healthy and slow each
SLOW_DELAY_S = 0.05       # (d): the slow-device profile's delay


def failure_marks() -> dict:
    """Process-wide evidence of the failure handling: the cost ledger's
    host-lane rows (every degraded row folds there), the degraded-decision
    metric and every circuit transition of the engine lane."""
    from authorino_tpu_torch.runtime.kernel_cost import LEDGER

    lane = {"lane": "engine"}
    return {"host_rows": LEDGER.snapshot("host")["rows"],
            "degraded": prom_sample("degraded_decisions",
                                    "auth_server_degraded_decisions_total",
                                    lane),
            "transitions": sum(prom_sample(
                "circuit_transitions",
                "auth_server_circuit_transitions_total",
                dict(lane, state=s)) for s in ("open", "half-open",
                                               "closed"))}


def require_no_failure_handling(label: str, marks0: dict) -> None:
    """A phase but 14 ends with the fault plane off, no breaker transition
    and no degraded row in it."""
    from authorino_tpu_torch.runtime import faults

    moved = {k: v - marks0[k] for k, v in failure_marks().items()}
    if faults.ACTIVE or any(moved.values()):
        raise AssertionError(f"{label}: the failure handling ran (faults "
                             f"armed {faults.ACTIVE}, {moved})")


def failure_handling(report: dict, card: str, dev, ctx6: dict) -> tuple:
    """Phase 14: phase 6's translated north-star corpus (1,001 configs)
    rebound to an engine with dedup and the cache off (every row reaches
    the kernel), ``breaker_threshold`` 3, ``breaker_reset_s`` 0.5,
    ``device_timeout_s`` 0.25, the recorder dumping every anomaly into
    ``smoke_out/flight-14``; counts zeroed just before the engine.  A card
    engine answers a batch it could not decide (its retry failed, or the
    open breaker kept it off the card) with the typed UNAVAILABLE; every
    other answer is held to the oracle.
    (a) ``device-down``: lone Check()s trip the breaker after 3 failures,
    each UNAVAILABLE; then a 4,096-Check() burst, every one UNAVAILABLE
    with no launch and no degraded row; a ``breaker-open`` bundle; the
    host oracle's checks/s and µs per row on its own (no lane of a card
    engine: the rate a host lane would start from).
    (b) ``kernel:raise:for=1``: lone Check()s through the flap until the
    breaker closes again (closed → open → half-open → closed), each exact
    or UNAVAILABLE and the last, the probe, exact; the time from the
    fault's end to ``closed``; every half-open probe batch that launched,
    its readback byte-equal to plain.  (c) ``kernel:hang``: wedged 256-row
    batches, each 2 watchdog timeouts and then UNAVAILABLE; every
    abandoned handle released (its readback buffer, event and stream);
    device memory back to its value before the wedges.  (d)
    ``slow-device``: lone Check()s healthy and slow, the slow ones'
    readbacks at least the delay late, nothing failed.  (e) ``flaky``
    under a seed: a burst, every answer exact or UNAVAILABLE; retries +
    batches failed after their retry = the plane's firings.  (f) the
    port's CLI as a subprocess with ``--fault-profile device-down
    --breaker-threshold 1`` on 16 API-key configs: every gRPC Check() the
    engine decides UNAVAILABLE, the others the oracle's code; /readyz
    reports the open circuit.
    Returns (the kernels' launches in (a)-(e); the max abs byte error of
    the probe batches' readbacks against plain)."""
    import gc
    import os
    import shutil
    import signal
    import tempfile
    import threading

    import grpc
    import numpy as np
    import torch

    from authorino_tpu_torch.authjson import build_authorization_json
    from authorino_tpu_torch.models import control_plane as cp
    from authorino_tpu_torch.models import northstar
    from authorino_tpu_torch.models.policy_model import host_results
    from authorino_tpu_torch.ops import fused_kernel as fk
    from authorino_tpu_torch.ops.operands import defuse, fuse_batch
    from authorino_tpu_torch.protos import wire
    from authorino_tpu_torch.runtime import PolicyEngine, faults
    from authorino_tpu_torch.runtime import kernel_cost as kc
    from authorino_tpu_torch.runtime.flight_recorder import RECORDER
    from authorino_tpu_torch.service.grpc_server import \
        request_proto_from_model
    from authorino_tpu_torch.utils import rpc

    entries, reqs, hold = ctx6["entries"], ctx6["reqs"], ctx6["hold"]
    flight = Path("smoke_out") / "flight-14"
    shutil.rmtree(flight, ignore_errors=True)
    RECORDER.configure(dump_dir=str(flight), min_dump_interval_s=0.0,
                       enabled=True)
    lane = {"lane": "engine"}
    numbers = {"card": card}

    def degraded_metric() -> float:
        return prom_sample("degraded_decisions",
                           "auth_server_degraded_decisions_total", lane)

    on_card = dev.type == "cuda"
    # (f)'s process starts now, over its manifests: its start-up overlaps
    # (a)-(e)
    f_ports = [free_port() for _ in range(3)]
    f_tmp = entry_manifests()
    f_server = ServerStart(
        [sys.executable, "-m", "authorino_tpu_torch", "server",
         "--watch-dir", f_tmp, "--ext-auth-grpc-port", str(f_ports[0]),
         "--ext-auth-http-port", str(f_ports[1]), "--oidc-http-port",
         str(f_ports[2]), "--fault-profile", "device-down",
         "--breaker-threshold", "1", "--drain-timeout", "5",
         "--flight-dir", str(flight / "cli")]
        + ([] if on_card else ["--device", "cpu"]),
        f_ports[1], Path("smoke_out") / "fault_profile.log", "f")

    def device_calls() -> int:
        """The kernel's launches (on the CPU: its plain version's calls)."""
        return fk.launches if on_card else fk.plain_calls

    def device_memory() -> int:
        if not on_card:
            return 0
        torch.cuda.synchronize(dev)
        gc.collect()
        return torch.cuda.memory_allocated(dev)

    fk.reset_counts()
    reset_host_counts()
    engine = PolicyEngine(max_batch=256, device=dev,
                          breaker_threshold=FAIL_THRESHOLD,
                          breaker_reset_s=FAIL_RESET_S,
                          device_timeout_s=FAIL_TIMEOUT_S, **NO_REUSE,
                          **WIDE_ADMISSION)
    bind(entries, engine)
    engine.apply_snapshot(entries)
    if engine.host_degrade:
        raise AssertionError("a card engine would degrade to the host")
    br, st = engine.breaker, engine.stats
    # each batch's device stage
    device_s = []
    fold = engine._observe_batch

    def observed(item, dur):
        device_s.append(dur)
        return fold(item, dur)

    engine._observe_batch = observed
    # every launch the breaker admitted as its half-open probe, with its
    # inputs and handle (the readback is held to plain after the window),
    # and in (c) every launch, whose handle the watchdog must release
    real_dispatch = fk.dispatch_megakernel
    probes = []
    wedged = {"handles": None}

    def dispatch(params, db):
        handle = real_dispatch(params, db)
        if br.state == "half-open":
            probes.append((params, db, handle))
        if wedged["handles"] is not None:
            wedged["handles"].append(handle)
        return handle

    def lone(k: int):
        return asyncio.run(timed_checks(engine, [reqs[k]]))[0]

    def unavailable(res) -> bool:
        return res.code == rpc.UNAVAILABLE

    def held(out, label: str, idx=None) -> int:
        """Every answer but the typed UNAVAILABLEs against the oracle;
        returns how many answered UNAVAILABLE."""
        idx = range(len(out)) if idx is None else idx
        ok = [(k, o) for k, o in zip(idx, out) if not unavailable(o[0])]
        hold([o for _, o in ok], label, idx=[k for k, _ in ok])
        return len(out) - len(ok)

    def recover() -> None:
        """Past the cooldown, one lone Check() is the probe that closes
        the circuit."""
        if br.state != "closed":
            time.sleep(FAIL_RESET_S + 0.05)
            hold([lone(0)], "phase 14 recovery probe")
        if br.state != "closed":
            raise AssertionError(f"the breaker did not close: {br.to_json()}")

    jwt = northstar.JWT_FILTER
    policy = engine._snapshot.policy
    docs = [build_authorization_json(q, {"identity": q.metadata_context[
        "filter_metadata"][jwt]["verified_jwt"]}) for q in reqs]
    names = [engine.lookup(q.http.host).rules.name for q in reqs]
    rows = [policy.config_ids[n] for n in names]

    fk.dispatch_megakernel = dispatch
    try:
        # ---- (a) device-down ---------------------------------------------
        faults.FAULTS.arm("device-down", seed=FAULT_SEED)
        seq = []
        while br.state == "closed" and len(seq) < FAIL_THRESHOLD:
            seq.append(lone(len(seq)))
        if held(seq, "phase 14 (a) sequential") != len(seq):
            raise AssertionError(f"(a) a lone Check() under device-down was "
                                 f"answered: {seq}")
        fired = dict(faults.FAULTS.fired)
        if (br.state != "open" or fired != {
                "kernel:raise:engine": FAIL_THRESHOLD}
                or [(t["state"], t["reason"]) for t in br.transitions] != [
                    ("open", f"{FAIL_THRESHOLD} consecutive batch "
                             f"failures")]):
            raise AssertionError(f"(a) the breaker after {len(seq)} lone "
                                 f"Check()s: {br.to_json()}, fired {fired}")
        l0, d0, h0, m0, f0, o0 = (device_calls(), st["degraded_rows"],
                                  kc.LEDGER.snapshot("host")["rows"],
                                  degraded_metric(), st["failed_batches"],
                                  st["breaker_open_batches"])
        t = time.perf_counter()
        out = asyncio.run(timed_checks(engine, reqs))
        wall = time.perf_counter() - t
        wait_idle(engine)
        messages = {res.message for res, _ in out}
        moved = {"launches": device_calls() - l0,
                 "unavailable": sum(unavailable(res) for res, _ in out),
                 "degraded_rows": st["degraded_rows"] - d0,
                 "ledger_host_rows": kc.LEDGER.snapshot("host")["rows"] - h0,
                 "metric": degraded_metric() - m0,
                 "failed_batches": st["failed_batches"] - f0,
                 "breaker_open_batches": st["breaker_open_batches"] - o0}
        if (moved["failed_batches"] < 1
                or moved["breaker_open_batches"] != moved["failed_batches"]
                or dict(moved, failed_batches=0, breaker_open_batches=0) != {
                    "launches": 0, "unavailable": len(reqs),
                    "degraded_rows": 0, "ledger_host_rows": 0, "metric": 0,
                    "failed_batches": 0, "breaker_open_batches": 0}
                or messages != {"engine device circuit open"}):
            raise AssertionError(f"(a) the burst under an open breaker: "
                                 f"{moved}, messages {messages}")
        deadline = time.monotonic() + 30
        while not list(flight.glob("flight-*breaker-open*.json")):
            if time.monotonic() > deadline:
                raise AssertionError("(a) no breaker-open bundle")
            time.sleep(0.02)
        # the same rows through the host oracle on this thread alone: what
        # a host lane would start from (a card engine never answers there)
        t = time.perf_counter()
        for d, r in zip(docs, rows):
            host_results(policy, d, r)
        alone_s = time.perf_counter() - t
        cold = report.get("observability_planes", {}).get("slo", [{}])[0]
        numbers["device_down"] = dict(
            moved, refused_checks_per_s=len(reqs) / wall,
            oracle_checks_per_s_alone=len(docs) / alone_s,
            oracle_us_per_row_alone=alone_s / len(docs) * 1e6,
            sequential=len(seq), fired=fired,
            phase13_cold_checks_per_s=cold.get("checks_per_s"),
            bundle=sorted(p.name for p in flight.glob(
                "flight-*breaker-open*.json"))[0])
        faults.FAULTS.disarm()
        recover()

        # ---- (b) flap ------------------------------------------------------
        n_tr = len(br.transitions)
        faults.FAULTS.arm(f"kernel:raise:for={FLAP_S}", seed=FAULT_SEED)
        fault_end = time.time() + FLAP_S   # the trail's stamps are wall time
        flap = []
        deadline = time.monotonic() + 30
        while not (br.state == "closed" and len(br.transitions) > n_tr):
            if time.monotonic() > deadline:
                raise AssertionError(f"(b) no recovery: {br.to_json()}")
            flap.append(lone(len(flap)))
            time.sleep(0.01)
        faults.FAULTS.disarm()
        refused = held(flap, "phase 14 (b)")
        states = [t["state"] for t in br.transitions[n_tr:]]
        closed_at = br.transitions[-1]["t"]
        if not (states[0] == "open" and states[-2:] == ["half-open",
                                                        "closed"]
                and all(a != b for a, b in zip(states, states[1:]))
                and set(states[1:-2]) <= {"half-open", "open"}
                and refused >= 1 and not unavailable(flap[-1][0])):
            raise AssertionError(f"(b) transitions {states}, {refused} of "
                                 f"{len(flap)} UNAVAILABLE")
        numbers["flap"] = {"checks": len(flap), "unavailable": refused,
                           "transitions": states,
                           "fault_end_to_closed_s": closed_at - fault_end,
                           "probes_launched": len(probes)}

        # ---- (c) wedged batches --------------------------------------------
        w_docs, w_names = docs[:WEDGE_ROWS], names[:WEDGE_ROWS]

        async def wedge_burst():
            return await asyncio.gather(*(engine.submit(d, n) for d, n in
                                          zip(w_docs, w_names)),
                                        return_exceptions=True)

        mem0 = device_memory()
        cycles = []
        for cycle in range(WEDGE_CYCLES):
            wd0, r0, f0, n_rec = (st["watchdog_timeouts"], st["retries"],
                                  st["failed_batches"],
                                  len(engine.batch_records))
            wedged["handles"] = []
            faults.FAULTS.arm("kernel:hang:for=30", seed=FAULT_SEED)
            t = time.perf_counter()
            out = asyncio.run(wedge_burst())
            dt = time.perf_counter() - t
            faults.FAULTS.disarm()
            wait_idle(engine)
            handles, wedged["handles"] = wedged["handles"], None
            recs = list(engine.batch_records)[n_rec:]
            fig = {"watchdog_timeouts": st["watchdog_timeouts"] - wd0,
                   "retries": st["retries"] - r0,
                   "failed_batches": st["failed_batches"] - f0,
                   "launches": sum(r["launches"] + r["plain_calls"]
                                   for r in recs),
                   "handles": len(handles),
                   "released": sum(h._host is None and h._event is None
                                   and h.stream is None for h in handles),
                   "degraded": sum("degraded" in r for r in recs),
                   "unavailable": sum(
                       isinstance(e, rpc.CheckAbort)
                       and e.code == rpc.UNAVAILABLE for e in out),
                   "wall_s": dt}
            del handles
            if (fig["watchdog_timeouts"], fig["retries"],
                    fig["failed_batches"], fig["launches"], fig["handles"],
                    fig["released"], fig["degraded"],
                    fig["unavailable"]) != (2, 1, 1, 2, 2, 2, 0, WEDGE_ROWS):
                raise AssertionError(f"(c) wedge {cycle}: {fig}")
            cycles.append(fig)
            hold([lone(0)], "phase 14 (c) healthy")   # clears the count
        mem1 = device_memory()
        if mem1 != mem0 or br.state != "closed":
            raise AssertionError(f"(c) device memory {mem0} -> {mem1} B "
                                 f"across the wedges; breaker {br.state}")
        numbers["wedge"] = {"cycles": cycles, "memory_before": mem0,
                            "memory_after": mem1}

        # ---- (d) slow device -----------------------------------------------
        def lone_batches(label: str) -> dict:
            n_rec, l0, n_tr, f0 = (len(engine.batch_records), device_calls(),
                                   len(br.transitions), st["failed_batches"])
            engine.batch_latency_s.clear()
            device_s.clear()
            outs = [lone(k) for k in range(SLOW_LONE)]
            wait_idle(engine)
            hold(outs, label)
            recs = list(engine.batch_records)[n_rec:]
            return {"batch_p50_ms": statistics.median(
                        engine.batch_latency_s) * 1e3,
                    "batch_min_ms": min(engine.batch_latency_s) * 1e3,
                    "device_p50_ms": statistics.median(device_s) * 1e3,
                    "launches": device_calls() - l0,
                    "degraded": sum("degraded" in r for r in recs),
                    "failed_batches": st["failed_batches"] - f0,
                    "transitions": len(br.transitions) - n_tr}

        # (c)'s watchdog timeouts each started a bundle dump on a thread of
        # its own (about a second of host work apiece); both passes are
        # timed only after the last has been written, or the healthy pass
        # shares the host with them and its batch p50 is not the baseline
        deadline = time.monotonic() + 60
        for t in threading.enumerate():
            if t.name == "atpu-flight-dump":
                t.join(max(0.0, deadline - time.monotonic()))
                if t.is_alive():
                    raise AssertionError("(d) a flight-recorder dump still "
                                         "running after 60 s")
        healthy = lone_batches("phase 14 (d) healthy")
        faults.FAULTS.arm("slow-device", seed=FAULT_SEED)
        try:
            slow = lone_batches("phase 14 (d) slow")
        finally:
            faults.FAULTS.disarm()
        rise = slow["batch_p50_ms"] - healthy["batch_p50_ms"]
        # every slow readback lands at least the delay after its launch, so
        # every slow batch takes at least the delay; the delay runs over the
        # healthy device stage, so the batch p50 rises by the delay less
        # what that stage took
        if not (slow["launches"] == healthy["launches"] == SLOW_LONE
                and slow["degraded"] == healthy["degraded"] == 0
                and slow["failed_batches"] == healthy["failed_batches"] == 0
                and slow["transitions"] == healthy["transitions"] == 0
                and slow["batch_min_ms"] >= SLOW_DELAY_S * 1e3
                and rise >= SLOW_DELAY_S * 1e3 - healthy["device_p50_ms"]):
            raise AssertionError(f"(d) healthy {healthy}, slow {slow}")
        numbers["slow_device"] = {"healthy": healthy, "slow": slow,
                                  "batch_p50_rise_ms": rise}

        # ---- (e) a flaky device, seeded -------------------------------------
        n_rec, r0, f0, o0 = (len(engine.batch_records), st["retries"],
                             st["failed_batches"],
                             st["breaker_open_batches"])
        faults.FAULTS.arm("flaky", seed=FAULT_SEED)
        try:
            out = asyncio.run(timed_checks(engine, reqs))
            wait_idle(engine)
            fired = faults.FAULTS.fired.get("kernel:raise:engine", 0)
        finally:
            faults.FAULTS.disarm()
        refused = held(out, "phase 14 (e)")
        recs = list(engine.batch_records)[n_rec:]
        open_batches = st["breaker_open_batches"] - o0
        failed = st["failed_batches"] - f0 - open_batches
        flaky = {"fired": fired, "retries": st["retries"] - r0,
                 "failed_after_retry_batches": failed,
                 "breaker_open_batches": open_batches,
                 "unavailable": refused,
                 "device_batches": sum(r["launches"] + r["plain_calls"]
                                       for r in recs),
                 "degraded": sum("degraded" in r for r in recs)}
        if (fired < 1 or flaky["retries"] + failed != fired
                or flaky["degraded"]):
            raise AssertionError(f"(e) {flaky}")
        numbers["flaky"] = flaky
        recover()
        # what one anomaly's bundle costs the host at this point of the
        # run (the exposition holds every series of the process)
        t = time.perf_counter()
        path = RECORDER.dump("failure-handling-probe")
        numbers["bundle"] = {"dump_s": time.perf_counter() - t,
                             "bytes": Path(path).stat().st_size,
                             "dumps_in_phase": len(list(flight.glob(
                                 "flight-*.json")))}
        wait_idle(engine)
        launches = {"fused_megakernel": fk.launches,
                    "probe_add_one": fk.probe_launches}
        checked_records(engine)
    finally:
        fk.dispatch_megakernel = real_dispatch
        faults.FAULTS.disarm()
    numbers["stats"] = dict(st)
    numbers["transitions"] = [t["state"] for t in br.transitions]
    if st["degraded_rows"] or st["degraded_batches"]:
        raise AssertionError(f"a card engine degraded to the host: {st}")

    # the probe batches' readbacks against plain (after the counted window)
    max_err = 0
    if not probes:
        raise AssertionError("no half-open probe batch launched")
    for params, db, handle in probes if on_card else ():
        buf, layout = fuse_batch(db)
        want = fk.fused_packed_plain(params, defuse(
            torch.from_numpy(buf).to(dev), layout))
        got = torch.from_numpy(np.asarray(handle.wait()).copy()).to(dev)
        max_err = max(max_err, max_byte_err(got, want),
                      kernel_vs_plain(params, db, dev))

    # ---- (f) the CLI with a fault profile, as a process -------------------
    f = {}
    n_e = ENTRY_CONFIGS
    e_rules = cp.config_rules(n_e, CP_RULES)
    e_reqs, e_cfgs, e_known = cp.build_check_requests(32, n_e, seed=9)
    ports, srv = f_ports, f_server
    proc, log_path = srv.proc, srv.log_path
    try:
        try:
            f["ready_s"] = srv.wait_ready()
            ready0 = srv.ready
            payloads = [wire.encode_check_request(request_proto_from_model(q))
                        for q in e_reqs]

            async def drive():
                async with grpc.aio.insecure_channel(
                        f"127.0.0.1:{ports[0]}") as ch:
                    call = ch.unary_unary(CHECK_METHOD)
                    return [wire.decode_check_response(r).status.code
                            for r in await asyncio.gather(
                                *(call(p) for p in payloads))]

            got = asyncio.run(drive())
            ready = http_call(ports[1], "/readyz")
            dv = json.loads(http_call(ports[1], "/debug/vars")[2])["engine"]
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=30)
        finally:
            srv.kill()
    finally:
        shutil.rmtree(f_tmp, ignore_errors=True)
    want = [cp.expected_code(q, i, e_rules, good)
            for q, i, good in zip(e_reqs, e_cfgs, e_known)]
    # the engine decides a request that got past its identity: on a card it
    # answers those UNAVAILABLE (a CPU engine's host oracle, the verdict)
    decided_by_engine = [c in (rpc.OK, rpc.PERMISSION_DENIED) for c in want]
    if on_card:
        want = [rpc.UNAVAILABLE if e else c
                for c, e in zip(want, decided_by_engine)]
    text = log_path.read_text()
    f.update({"grpc_codes": got, "readyz_before": ready0[2],
              "readyz": [ready[0], ready[2]], "exit_code": rc,
              "breaker": dv["breaker"]["state"], "faults": dv["faults"],
              "host_degrade": dv["host_degrade"],
              "engine_decided": sum(decided_by_engine),
              "degraded_rows": dv["kernel_cost"]["ledger"].get(
                  "host", {}).get("rows", 0)})
    if (got != want or ready0[2] != "ok" or f["readyz"] != [
            200, "ok (degraded: engine device circuit open)"]
            or f["breaker"] != "open" or not dv["faults"]["armed"]
            or dv["faults"]["rules"] != ["kernel:raise"]
            or not f["engine_decided"] or f["host_degrade"] == on_card
            or f["degraded_rows"] != (0 if on_card else f["engine_decided"])
            or rc != 0
            or "fault injection ARMED via --fault-profile" not in text):
        raise AssertionError(f"(f) {f}, oracle {want}; log {text[-2000:]}")
    numbers["cli"] = f
    numbers["launches"] = launches
    report["failure_handling"] = numbers

    a, b, c, s, e = (numbers["device_down"], numbers["flap"],
                     numbers["wedge"], numbers["slow_device"],
                     numbers["flaky"])
    log(f"[{card}] failure handling (a) device-down: {a['sequential']} lone "
        f"Check()s, each UNAVAILABLE, tripped the breaker after "
        f"{FAIL_THRESHOLD} failures; {len(reqs):,} Check()s under the open "
        f"breaker, every one UNAVAILABLE ({a['refused_checks_per_s']:.0f} "
        f"checks/s) in {a['failed_batches']} batches, {a['launches']} "
        f"launches, {a['degraded_rows']} degraded rows; bundle "
        f"{a['bundle']}; the host oracle alone on one thread "
        f"{a['oracle_checks_per_s_alone']:.0f} checks/s, "
        f"{a['oracle_us_per_row_alone']:.1f} us per row (phase 13's cold "
        f"burst on the card: {a['phase13_cold_checks_per_s'] or 0:.0f} "
        f"checks/s); one bundle dump {numbers['bundle']['dump_s']:.3f} s, "
        f"{numbers['bundle']['bytes']} B")
    log(f"[{card}] failure handling (b) kernel:raise:for={FLAP_S:g}: "
        f"{b['checks']} lone Check()s through the flap, {b['unavailable']} "
        f"UNAVAILABLE and the rest exact, transitions "
        f"{' -> '.join(['closed'] + b['transitions'])}; closed "
        f"{b['fault_end_to_closed_s']:.3f} s after the fault's end "
        f"(breaker_reset_s {FAIL_RESET_S:g}); {len(probes)} probe batches "
        f"launched in the phase, readbacks byte-equal to plain")
    log(f"[{card}] failure handling (c) kernel:hang: {WEDGE_CYCLES} wedged "
        f"{WEDGE_ROWS}-row batches, each 2 watchdog timeouts "
        f"({FAIL_TIMEOUT_S:g} s) then UNAVAILABLE, both abandoned handles "
        f"released (walls {[round(x['wall_s'], 3) for x in c['cycles']]} "
        f"s); device memory {c['memory_before']} -> {c['memory_after']} B")
    log(f"[{card}] failure handling (d) slow-device: batch p50 "
        f"{s['healthy']['batch_p50_ms']:.3f} -> "
        f"{s['slow']['batch_p50_ms']:.3f} ms (+{s['batch_p50_rise_ms']:.3f};"
        f" device stage p50 {s['healthy']['device_p50_ms']:.3f} -> "
        f"{s['slow']['device_p50_ms']:.3f} ms; slowest batch at least "
        f"{s['slow']['batch_min_ms']:.3f} ms); {s['slow']['launches']} "
        f"launches, nothing failed, breaker closed")
    log(f"[{card}] failure handling (e) flaky (seed {FAULT_SEED}): "
        f"{len(reqs):,} Check()s, {e['unavailable']} UNAVAILABLE and the "
        f"rest exact; fired {e['fired']} = retries {e['retries']} + batches "
        f"failed after their retry {e['failed_after_retry_batches']}; "
        f"{e['breaker_open_batches']} batches kept off the card by the open "
        f"breaker, {e['device_batches']} launched")
    log(f"failure handling (f): python3 -m authorino_tpu_torch server "
        f"--fault-profile device-down --breaker-threshold 1 ready in "
        f"{f['ready_s']:.1f}s; of 32 gRPC Check()s the {f['engine_decided']} "
        f"the engine decides answered UNAVAILABLE, the rest the oracle's "
        f"code; /readyz {f['readyz']}, exit {rc}")
    return launches, max_err


# ---------------------------------------------------------------------------
# phase 15: the native gRPC frontend
# ---------------------------------------------------------------------------

# the native frontend slow lane's CoDel shed (runtime/native_frontend.py)
SLOW_LANE_SHED = "server overloaded: slow lane shedding"
WIRE_CONFIGS = 1000       # the reference's wire bench corpus: AuthConfigs
WIRE_RULES = 10           # leaves per config
WIRE_PAYLOADS = 4096      # distinct payloads, random.Random(5)
FE_SHAPE = {"max_batch": 4096, "window_us": 2000, "slots": 24,
            "dispatch_threads": 10}   # run_native_mode's frontend
SAT_DEPTH, SAT_CONNS = 8000, 5        # its saturation pass (8 x B in flight)
LIGHT_DEPTH, LIGHT_CONNS = 512, 2     # its light pass (1,024 in flight)
SHALLOW_DEPTH, SHALLOW_CONNS = 16, 1  # a shallow pass: no client queueing
LIGHT_PAYLOADS = 1024     # distinct requests the light passes cycle
# (seconds measured, seconds of warm-up) per pass.  The native frontend
# alone takes the saturation passes: at 40,000 in flight grpc.aio (~450
# checks/s on this corpus) answers its first request only after ~90 s.
# The native / grpc.aio pairs run at the light shape, where grpc.aio's
# ~2.3 s standing wait fits the warm-up and ~2,000 answers the window.
SAT_S, LIGHT_S, SHALLOW_S = (2.0, 0.5), (5.0, 2.0), (1.5, 0.5)
FE_TRIALS = 1             # native saturation passes; native / grpc.aio pairs
KEY_CONFIGS = 1000        # (b): API-key AuthConfigs of the three fast kinds
STOP_SLOW = 64            # (e): slow-lane requests in flight at stop()
FAIL_ROWS = 256           # (f): fast-lane requests under device-down


class AioLoop:
    """One event loop on a thread of its own for every grpc.aio object of
    phase 15 (the port's grpc.aio servers and the Python gRPC clients):
    grpc's asyncio layer wants one loop, not one per ``asyncio.run``."""

    def __init__(self):
        import threading

        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True, name="phase15-aio")
        self.thread.start()

    def run(self, coro, timeout: float = 300.0):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=30)


def serve_grpc_aio(aio: AioLoop, engine):
    """The port's grpc.aio server over ``engine`` on ``aio``'s loop;
    returns (port, stop())."""
    from authorino_tpu_torch.service.grpc_server import build_server

    async def start():
        server = build_server(engine, address="127.0.0.1:0")
        await server.start()
        return server

    server = aio.run(start())
    return server.bound_port, lambda: aio.run(server.stop(1.0))


def grpc_many(aio: AioLoop, port: int, payloads, timeout: float = 120.0,
              window: int = 0):
    """Every payload at once over one gRPC channel, or at most ``window``
    in flight (``AIO_WINDOW`` for an in-process grpc.aio server): raw
    response bytes, or the exception of a failed call."""
    import grpc

    async def body():
        async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
            call = ch.unary_unary(CHECK_METHOD)
            gate = asyncio.Semaphore(window or len(payloads) or 1)

            async def one(p):
                async with gate:
                    return await call(p, timeout=timeout)

            return await asyncio.gather(*(one(p) for p in payloads),
                                        return_exceptions=True)

    return aio.run(body(), timeout + 60)


def grpc_aio_server_main(port_file: str, no_reuse: bool,
                         device: str = "cuda") -> None:
    """The port's grpc.aio server over the wire corpus in a process of its
    own (phase 15 (c)/(d)): grpc.aio's backlog of streams after a pass
    would hold the measuring process's interpreter lock while the native
    frontend is measured.  Writes its port to ``port_file``; writes the
    engine's counts to ``port_file + ".stats"`` on SIGUSR1, and on SIGTERM
    before it exits at once."""
    import os
    import signal

    from authorino_tpu_torch.models import wire_corpus as wc
    from authorino_tpu_torch.runtime import PolicyEngine
    from authorino_tpu_torch.service.grpc_server import build_server

    engine = PolicyEngine(max_batch=FE_SHAPE["max_batch"], device=device,
                          **dict(WIDE_ADMISSION,
                                 **(NO_REUSE if no_reuse else {})))
    engine.apply_snapshot(wc.build_wire_entries(WIRE_CONFIGS, WIRE_RULES,
                                                engine))

    def dump_stats():
        with open(port_file + ".stats.tmp", "w") as f:
            json.dump(dict(engine.stats), f)
        os.replace(port_file + ".stats.tmp", port_file + ".stats")

    def on_term():
        dump_stats()
        os._exit(0)

    async def main():
        loop = asyncio.get_running_loop()
        loop.add_signal_handler(signal.SIGTERM, on_term)
        loop.add_signal_handler(signal.SIGUSR1, dump_stats)
        server = build_server(engine, address="127.0.0.1:0")
        await server.start()
        with open(port_file + ".tmp", "w") as f:
            f.write(str(server.bound_port))
        os.replace(port_file + ".tmp", port_file)
        await asyncio.Event().wait()

    asyncio.run(main())


class AioServerProcess:
    """One ``grpc_aio_server_main`` process: started (ahead of its passes:
    its start-up overlaps the phase's work before them), ready (its port
    file, ``wait_ready``), then stopped by SIGTERM (its counts back) or
    killed."""

    def __init__(self, tmpdir: str, no_reuse: bool, device: str, tag: str):
        import atexit
        import os

        self.port_file = os.path.join(tmpdir, f"aio-{tag}.port")
        root = Path(__file__).resolve().parent
        code = ("import chip_smoke as cs; cs.grpc_aio_server_main("
                f"{self.port_file!r}, {no_reuse!r}, {device!r})")
        self.log = open(os.path.join(tmpdir, f"aio-{tag}.log"), "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", code], cwd=str(root),
            env=dict(os.environ, PYTHONPATH=str(root)),
            stdout=self.log, stderr=subprocess.STDOUT)
        self.t0 = time.monotonic()
        self.port = None
        atexit.register(self.kill)

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def wait_ready(self) -> None:
        """Until its port file exists (its engine installed, its server
        bound); raises when it exited or did not start in 180 s."""
        import os

        t0 = self.t0
        while not os.path.exists(self.port_file):
            if self.proc.poll() is not None or time.monotonic() - t0 > 180:
                self.stop()
                raise AssertionError(f"the grpc.aio server process did not "
                                     f"start (exit {self.proc.returncode})")
            time.sleep(0.05)
        self.port = int(Path(self.port_file).read_text())

    def counts(self) -> dict:
        """SIGUSR1: the engine's counts now."""
        import signal

        path = Path(self.port_file + ".stats")
        path.unlink(missing_ok=True)
        self.proc.send_signal(signal.SIGUSR1)
        t0 = time.monotonic()
        while not path.exists():
            if self.proc.poll() is not None or time.monotonic() - t0 > 30:
                raise AssertionError("the grpc.aio server process did not "
                                     "report its counts")
            time.sleep(0.02)
        return json.loads(path.read_text())

    def wait_idle(self, timeout: float = 60.0) -> None:
        """Until the engine's row count holds still for 0.5 s: the
        streams a pass left behind are done or cancelled."""
        t0, last = time.monotonic(), None
        while time.monotonic() - t0 < timeout:
            rows = self.counts()["rows"]
            if rows == last:
                return
            last = rows
            time.sleep(0.5)
        raise AssertionError("the grpc.aio server process never idled")

    def stop(self):
        """SIGTERM: the engine's counts (None if it did not answer)."""
        import signal

        stats = None
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        path = Path(self.port_file + ".stats")
        if path.exists():
            stats = json.loads(path.read_text())
            path.unlink()
        self.log.close()
        return stats


def loadgen(lg: str, port: int, path: str, window: tuple, depth: int,
            conns: int) -> dict:
    """One pass of the C++ load generator; ``window`` is (seconds measured,
    seconds of warm-up)."""
    seconds, warm = window
    out = subprocess.run([lg, "127.0.0.1", str(port), path, str(seconds),
                          str(warm), str(depth), str(conns)],
                         capture_output=True, text=True,
                         timeout=seconds + warm + 120)
    if out.returncode != 0:
        raise AssertionError(f"loadgen failed: {out.stderr[-500:]}")
    return json.loads(out.stdout)


class PadCapture:
    """Wraps ``fk.dispatch_megakernel`` while installed: keeps a copy of
    the first batch of each pad of ``min_pad`` rows or more that a
    frontend dispatch thread launches in each part of a phase (``part()``;
    keys are ``(part, pad)``), beside its params and handle (the batch's
    arrays view the frontend's slot, which the C++ encoder refills once
    the slot completes)."""

    def __init__(self, fk, min_pad: int = 256):
        import threading

        self.fk, self.min_pad, self.key = fk, min_pad, ""
        self.real = fk.dispatch_megakernel
        self.captured, self.pads = {}, set()
        self.lock = threading.Lock()

    def install(self) -> "PadCapture":
        self.fk.dispatch_megakernel = self.dispatch
        return self

    def restore(self) -> None:
        self.fk.dispatch_megakernel = self.real

    def part(self, key: str, min_pad: int) -> None:
        """Launches from here on belong to ``key``: its first batch of
        each pad of ``min_pad`` rows or more is captured anew."""
        with self.lock:
            self.key, self.min_pad = key, min_pad

    def done(self) -> dict:
        """{(part, pad): (params, batch, handle)} of the captures that
        launched."""
        return {k: c for k, c in self.captured.items() if c is not True}

    def dispatch(self, params, db):
        import dataclasses
        import threading

        import numpy as np

        pad = int(db.attrs_val.shape[0])
        take = False
        if threading.current_thread().name.startswith("atpu-fe-dispatch"):
            with self.lock:
                key = (self.key, pad)
                self.pads.add(key)
                if pad >= self.min_pad and key not in self.captured:
                    self.captured[key] = take = True
        if not take:
            return self.real(params, db)
        copy = dataclasses.replace(db, **{
            f.name: np.array(getattr(db, f.name), copy=True)
            for f in dataclasses.fields(db)
            if getattr(db, f.name) is not None})
        try:
            h = self.real(params, db)
        except BaseException:
            with self.lock:
                del self.captured[key]
            raise
        self.captured[key] = (params, copy, h)
        return h

    def max_err(self, dev) -> int:
        """Each captured readback against the kernel's plain version on
        the card (tolerance 0)."""
        import numpy as np
        import torch

        from authorino_tpu_torch.ops.operands import defuse, fuse_batch

        err = 0
        for _, (params, db, handle) in sorted(self.done().items()):
            buf, layout = fuse_batch(db)
            want = self.fk.fused_packed_plain(params, defuse(
                torch.from_numpy(buf).to(dev), layout))
            out = torch.from_numpy(np.asarray(handle.wait()).copy()).to(dev)
            err = max(err, max_byte_err(out, want),
                      kernel_vs_plain(params, db, dev))
        return err


def native_frontend(report: dict, card: str, dev) -> tuple:
    """Phase 15: the native gRPC frontend on the card, under
    ``--native-frontend on`` semantics (its start fails loudly).  (a) the
    extension with frontend.cpp and the load generator built by g++, the
    libnghttp2 it opened; on the reference's wire corpus (1,000 anonymous
    AuthConfigs x 10 leaves, 4,096 payloads of random.Random(5)) at the
    serving defaults and with dedup and the cache off, and on 1,000
    API-key configs at the defaults: (b) every native answer byte-equal
    to the port's grpc.aio server's over the same engine and its code the
    oracle's, every request on the fast lane, the first frontend batch of
    each pad byte-equal to its plain version; (c) native saturation
    passes of the C++ load generator (depth 8,000 over 5 connections),
    then native and grpc.aio in alternating pairs at 1,024 in flight:
    checks/s, p50/p99, rows per launched batch, launches, device rows;
    (d) a shallow pass of each side; (e) stop() under load answers every
    started stream, then the CLI as a process with --native-frontend on
    drains on SIGTERM; (f) ``device-down``: every fast-lane row
    UNAVAILABLE, none degraded.
    Returns (the kernels' launches, counts zeroed just before (b); the max
    abs byte error against plain)."""
    import os
    import shutil
    import struct
    import tempfile
    import threading


    from authorino_tpu_torch import native
    from authorino_tpu_torch.models import wire_corpus as wc
    from authorino_tpu_torch.ops import fused_kernel as fk
    from authorino_tpu_torch.protos import wire
    from authorino_tpu_torch.runtime import PolicyEngine, faults
    from authorino_tpu_torch.runtime.native_frontend import NativeFrontend
    from authorino_tpu_torch.utils import rpc

    on_card = dev.type == "cuda"
    numbers = {"card": card}
    # (e)'s process starts now: its start-up overlaps (a)-(d), (f)
    entry = entry_point_start(["--native-frontend", "on"], on_card,
                              Path("smoke_out") / "native_frontend.log")
    # ---- (a) build ----------------------------------------------------------
    t = time.monotonic()
    mod = native.load_library()
    lg = str(native.build_loadgen())
    numbers["build"] = {"library_s": native.build_seconds(),
                        "loadgen_and_load_s": time.monotonic() - t,
                        "nghttp2": mod.fe_nghttp2_path(), "loadgen": lg}
    if not numbers["build"]["nghttp2"]:
        raise AssertionError("(a) libnghttp2 not found: the native frontend "
                             "cannot start")
    log(f"native frontend (a): extension (encoder + frontend.cpp) and load "
        f"generator built by g++ from authorino_tpu_torch/native/csrc; "
        f"libnghttp2 {numbers['build']['nghttp2']}")

    payloads = wc.wire_payloads(WIRE_PAYLOADS, WIRE_CONFIGS)
    oracle = [rpc.OK if wc.expected_allow(p, WIRE_RULES)
              else rpc.PERMISSION_DENIED for p in payloads]
    tmpdir = tempfile.mkdtemp(prefix="phase15-")
    payload_path = os.path.join(tmpdir, "wire.payloads")
    with open(payload_path, "wb") as f:
        for b in payloads:
            f.write(struct.pack(">I", len(b)) + b)
    light_path = os.path.join(tmpdir, "light.payloads")
    with open(light_path, "wb") as f:
        for b in payloads[:LIGHT_PAYLOADS]:
            f.write(struct.pack(">I", len(b)) + b)
    # (c)/(d)'s grpc.aio server processes, one per setting, start now:
    # their start-ups overlap the work before their passes
    aio_servers = {no_reuse: AioServerProcess(tmpdir, no_reuse, dev.type,
                                              tag)
                   for no_reuse, tag in ((False, "defaults"),
                                         (True, "no-reuse"))}

    # the first frontend batch of each pad of 256 rows or more, held to
    # plain after the counted window, so the saturation passes' pad
    # (max_batch) is held to plain as well as the bursts'
    cap = PadCapture(fk)
    fk.reset_counts()
    reset_host_counts()
    totals = {"fe_launches": 0, "fe_warm": 0, "engine_launches": 0}

    def start_stack(label, engine_kw, fe_kw, build=None, kernel_configs=None):
        """An engine over the wire corpus (or ``build(engine)``'s entries),
        its frontend and an in-process grpc.aio server; ``kernel_configs``
        is how many configs the frontend must give a kernel row."""
        t0 = time.perf_counter()
        # wide admission bounds (as phase 10's): the grpc.aio side under
        # the saturating load generator measures serving, not shedding
        engine = PolicyEngine(max_batch=FE_SHAPE["max_batch"], device=dev,
                              **dict(WIDE_ADMISSION, **engine_kw))
        engine.apply_snapshot(build(engine) if build else
                              wc.build_wire_entries(WIRE_CONFIGS, WIRE_RULES,
                                                    engine))
        fe = NativeFrontend(engine, port=0, **dict(FE_SHAPE, **fe_kw))
        port = fe.start()
        if not fe.wait_warm(60):
            raise AssertionError(f"({label}) the warm launch never ran")
        dv = fe.debug_vars()
        want = WIRE_CONFIGS if kernel_configs is None else kernel_configs
        if dv["snapshot"]["fast_configs"] != want:
            raise AssertionError(f"({label}) {dv['snapshot']} fast configs")
        py_port, stop_py = serve_grpc_aio(aio, engine)
        return engine, fe, port, py_port, stop_py, time.perf_counter() - t0

    def end_stack(engine, fe, stop_py):
        stop_py()
        if fe._running:
            fe.stop(drain_s=10)
        wait_idle(engine)
        totals["fe_launches"] += fe.counts["launches"]
        totals["fe_warm"] += fe.counts["warm_launches"]
        totals["engine_launches"] += engine.stats["launches"]

    def exactness(label, fe, port, py_port, reqs=None, codes=None):
        """``reqs`` (the wire payloads by default) through the frontend
        and the grpc.aio server: bytes equal, codes the oracle's, every
        request on the fast lane."""
        reqs, codes = (payloads, oracle) if reqs is None else (reqs, codes)
        c0, s0 = dict(fe.counts), fe.stats()
        native_out = grpc_many(aio, port, reqs)
        c1, s1 = dict(fe.counts), fe.stats()
        aio_out = grpc_many(aio, py_port, reqs, window=AIO_WINDOW)
        for k, (n_raw, a_raw, want) in enumerate(zip(native_out, aio_out,
                                                     codes)):
            if not isinstance(n_raw, bytes) or n_raw != a_raw:
                raise AssertionError(f"({label}) request {k}: native "
                                     f"{n_raw!r} != grpc.aio {a_raw!r}")
            code = wire.decode_check_response(n_raw).status.code
            if code != want:
                raise AssertionError(f"({label}) request {k}: {code} != "
                                     f"oracle {want}")
        d = {k: c1[k] - c0[k] for k in c1}
        lanes = {k: s1[k] - s0[k] for k in ("fast", "slow", "notfound")}
        if lanes["fast"] != len(reqs) or (
                on_card and d["launches"] != d["batches"]
                - d["cached_batches"]):
            raise AssertionError(f"({label}) frontend counts {d}, lanes "
                                 f"{lanes}")
        return {"requests": len(reqs),
                "codes": {c: codes.count(c) for c in sorted(set(codes))},
                "allowed": codes.count(rpc.OK), "lanes": lanes,
                "fast_share": lanes["fast"] / len(reqs), "frontend": d}

    def trials(label, fe, port, engine, no_reuse):
        """The native frontend's saturation passes; then the native /
        grpc.aio pairs at the light shape, alternating, and the shallow
        pass of each side, all of grpc.aio's in one server process."""
        shapes = {"sat": (payload_path, SAT_S, SAT_DEPTH, SAT_CONNS),
                  "light": (light_path, LIGHT_S, LIGHT_DEPTH, LIGHT_CONNS),
                  "shallow": (light_path, SHALLOW_S, SHALLOW_DEPTH,
                              SHALLOW_CONNS)}
        keys = ("batches", "rows", "device_rows", "launches", "plain_calls",
                "cached_batches")

        def figures(r, d):
            launched = d.get("batches", 0) - d.get("cached_batches", 0)
            r["rows_per_batch"] = d.get("rows", 0) / max(1, d.get("batches",
                                                                   0))
            r["rows_per_launched_batch"] = (d.get("device_rows", 0) / launched
                                            if launched else 0.0)
            r["counts"] = d
            return r

        def native_pass(shape):
            c0 = dict(fe.counts)
            r = loadgen(lg, port, *shapes[shape])
            wait_idle(engine, timeout=120)
            return figures(r, {k: fe.counts[k] - c0[k] for k in keys})

        def aio_pass(srv, shape):
            srv.wait_idle()
            c0 = srv.counts()
            r = loadgen(lg, srv.port, *shapes[shape])
            c1 = srv.counts()
            return figures(r, {k: c1[k] - c0[k] for k in keys})

        def median(rs):
            return {k: statistics.median(r[k] for r in rs)
                    for k in ("rps", "p50_ms", "p99_ms", "rows_per_batch",
                              "rows_per_launched_batch")}

        loadgen(lg, port, *shapes["sat"])  # warm-up
        wait_idle(engine)
        out = {"sat": [native_pass("sat") for _ in range(FE_TRIALS)],
               "native": [], "grpc_aio": [], "shallow": {}}
        srv = aio_servers[no_reuse]
        srv.wait_ready()
        try:
            order = ["native", "grpc_aio", "grpc_aio", "native", "native",
                     "grpc_aio"][:2 * FE_TRIALS]
            for side in order:
                out[side].append(native_pass("light") if side == "native"
                                 else aio_pass(srv, "light"))
            out["shallow"]["native"] = native_pass("shallow")
            out["shallow"]["grpc_aio"] = aio_pass(srv, "shallow")
        finally:
            srv.stop()
        if min(r["rps"] for r in out["native"] + out["grpc_aio"]) <= 0:
            raise AssertionError(f"({label}) a pair's side answered nothing: "
                                 f"{out}")
        for side in ("sat", "native", "grpc_aio"):
            out[f"{side}_median"] = median(out[side])
        return out

    def fmt_trials(tr):
        s, n, g = tr["sat_median"], tr["native_median"], \
            tr["grpc_aio_median"]
        sh = tr["shallow"]
        return (f"saturation ({SAT_DEPTH} x {SAT_CONNS} in flight, native "
                f"only): {[round(r['rps']) for r in tr['sat']]} checks/s "
                f"(median {s['rps']:.0f}; p50 {s['p50_ms']:.2f} ms p99 "
                f"{s['p99_ms']:.2f} ms; rows per batch "
                f"{[round(r['rows_per_batch'], 1) for r in tr['sat']]}, "
                f"per launched batch "
                f"{[round(r['rows_per_launched_batch'], 1) for r in tr['sat']]}"
                f"; launches {[r['counts']['launches'] for r in tr['sat']]}"
                f"; device rows "
                f"{[r['counts']['device_rows'] for r in tr['sat']]}); "
                f"pairs ({LIGHT_DEPTH} x {LIGHT_CONNS} in flight, "
                f"{LIGHT_S[0]:g} s after {LIGHT_S[1]:g} s of warm-up): "
                f"native {[round(r['rps']) for r in tr['native']]} (median "
                f"{n['rps']:.0f}; p50 {n['p50_ms']:.2f} ms p99 "
                f"{n['p99_ms']:.2f} ms; rows per launched batch "
                f"{[round(r['rows_per_launched_batch'], 1) for r in tr['native']]}"
                f") vs grpc.aio {[round(r['rps']) for r in tr['grpc_aio']]} "
                f"(median {g['rps']:.0f}; p50 {g['p50_ms']:.2f} ms p99 "
                f"{g['p99_ms']:.2f} ms; rows per launched batch "
                f"{[round(r['rows_per_launched_batch'], 1) for r in tr['grpc_aio']]}"
                f"; launches "
                f"{[r['counts']['launches'] for r in tr['grpc_aio']]}); "
                f"shallow pass ({SHALLOW_DEPTH} x {SHALLOW_CONNS} in flight): "
                f"native p50 {sh['native']['p50_ms']:.3f} ms p99 "
                f"{sh['native']['p99_ms']:.3f} ms "
                f"({sh['native']['rps']:.0f}/s), grpc.aio p50 "
                f"{sh['grpc_aio']['p50_ms']:.3f} ms p99 "
                f"{sh['grpc_aio']['p99_ms']:.3f} ms "
                f"({sh['grpc_aio']['rps']:.0f}/s)")

    cap.install()
    aio = AioLoop()
    try:
        # ---- the serving defaults (dedup and the verdict cache on) --------
        engine, fe, port, py_port, stop_py, up_s = start_stack(
            "defaults", {}, {})
        try:
            numbers["defaults"] = {"start_s": up_s}
            numbers["defaults"]["exactness"] = exactness("b, defaults", fe,
                                                         port, py_port)
            numbers["defaults"]["trials"] = tr = trials(
                "c, defaults", fe, port, engine, False)
            log(f"[{card}] native frontend (c, d) at the serving defaults: "
                f"{fmt_trials(tr)}")
        finally:
            end_stack(engine, fe, stop_py)
        # ---- API-key configs on the fast lane (serving defaults) ----------
        keyed = wc.key_payloads(WIRE_PAYLOADS, KEY_CONFIGS)
        engine, fe, port, py_port, stop_py, up_s = start_stack(
            "api keys", {}, {},
            build=lambda e: wc.build_key_entries(KEY_CONFIGS, e),
            kernel_configs=sum(i % 3 != 0 for i in range(KEY_CONFIGS)))
        try:
            ex = numbers["api_keys"] = exactness(
                "b, api keys", fe, port, py_port, [p for p, _ in keyed],
                [c for _, c in keyed])
            ex["start_s"] = up_s
            ex["kinds"] = list(wc.KEY_KINDS)
            if ex["frontend"]["device_rows"] == 0:
                raise AssertionError(f"(b) no API-key row rode the kernel: "
                                     f"{ex}")
        finally:
            end_stack(engine, fe, stop_py)
        # ---- dedup and the cache off: every row rides the kernel ----------
        engine, fe, port, py_port, stop_py, up_s = start_stack(
            "no reuse", NO_REUSE, NO_REUSE)
        try:
            numbers["no_reuse"] = {"start_s": up_s}
            ex = numbers["no_reuse"]["exactness"] = exactness(
                "b, no reuse", fe, port, py_port)
            if ex["frontend"]["device_rows"] != len(payloads):
                raise AssertionError(f"(b) a row skipped the kernel: {ex}")
            numbers["no_reuse"]["trials"] = tr = trials(
                "c, no reuse", fe, port, engine, True)
            if min(r["rows_per_launched_batch"] for r in tr["sat"]) <= 1:
                raise AssertionError(f"(c) one-row cuts through the native "
                                     f"frontend: {tr['sat']}")
            log(f"[{card}] native frontend (c, d) with dedup and the cache "
                f"off: {fmt_trials(tr)}")
            # ---- (e) stop() under load ------------------------------------
            s0 = fe.stats()
            base = s0["fast"] + s0["slow"] + s0["notfound"]
            box = {}

            def stop_when_received():
                deadline = time.monotonic() + 60
                while time.monotonic() < deadline:
                    s = fe.stats()
                    got = s["fast"] + s["slow"] + s["notfound"] - base
                    if got >= len(payloads) // 2:
                        box["started"] = got
                        t = time.perf_counter()
                        fe.stop(drain_s=10)
                        box["stop_s"] = time.perf_counter() - t
                        box["stats"] = s
                        return
                    time.sleep(0.0005)

            th = threading.Thread(target=stop_when_received)
            th.start()
            out = grpc_many(aio, port, payloads, timeout=30)
            th.join(timeout=120)
            answered = sum(isinstance(r, bytes) for r in out)
            refused = [r for r in out if not isinstance(r, bytes)]
            if "started" not in box or answered < box["started"] or any(
                    r.code().name != "UNAVAILABLE" for r in refused):
                raise AssertionError(
                    f"(e) {answered} answered of {box.get('started')} "
                    f"started; refusals {set(str(r.code()) for r in refused)}")
            for raw, want in zip(out, oracle):
                if isinstance(raw, bytes) and \
                        wire.decode_check_response(raw).status.code != want:
                    raise AssertionError("(e) a drained answer differs from "
                                         "the oracle")
            numbers["stop_under_load"] = {
                "started_at_stop": box["started"], "answered": answered,
                "refused_unavailable": len(refused),
                "sent": len(payloads), "stop_s": box["stop_s"]}
        finally:
            end_stack(engine, fe, stop_py)
        # ---- (f) device-down ----------------------------------------------
        engine = PolicyEngine(max_batch=FE_SHAPE["max_batch"], device=dev, **NO_REUSE)
        engine.apply_snapshot(wc.build_wire_entries(WIRE_CONFIGS, WIRE_RULES,
                                                    engine))
        fe = NativeFrontend(engine, port=0, breaker_threshold=1,
                            breaker_reset_s=60.0,
                            **dict(FE_SHAPE, **NO_REUSE))
        port = fe.start()
        p0 = fk.plain_calls
        try:
            faults.FAULTS.arm("device-down", seed=7)
            out = grpc_many(aio, port, payloads[:FAIL_ROWS])
        finally:
            faults.FAULTS.disarm()
            fe.stop(drain_s=10)
            totals["fe_launches"] += fe.counts["launches"]
            totals["fe_warm"] += fe.counts["warm_launches"]
        codes = [wire.decode_check_response(r).status.code
                 if isinstance(r, bytes) else repr(r) for r in out]
        c = fe.counts
        # a card answers UNAVAILABLE; only a CPU engine (a dry run of this
        # script) re-decides on the host
        want = ([rpc.UNAVAILABLE] * FAIL_ROWS if on_card
                else oracle[:FAIL_ROWS])
        if (codes != want
                or c["degraded_rows"] != (0 if on_card else FAIL_ROWS)
                or c["unavailable_rows"] != (FAIL_ROWS if on_card else 0)
                or (on_card and fk.plain_calls != p0) or c["launches"]
                or fe.breaker.state != "open"):
            raise AssertionError(f"(f) device-down: {set(map(str, codes))} "
                                 f"{c} breaker {fe.breaker.state}")
        numbers["device_down"] = {"rows": FAIL_ROWS, "unavailable":
                                  c["unavailable_rows"], "degraded":
                                  c["degraded_rows"], "retries":
                                  c["retries"], "breaker_open_batches":
                                  c["breaker_open_batches"]}
    finally:
        cap.restore()
        faults.FAULTS.disarm()
        aio.close()
        for srv in aio_servers.values():
            srv.kill()
        shutil.rmtree(tmpdir, ignore_errors=True)
    launches = {"fused_megakernel": fk.launches,
                "probe_add_one": fk.probe_launches}
    if on_card and launches["fused_megakernel"] != (
            totals["fe_launches"] + totals["fe_warm"]
            + totals["engine_launches"]):
        raise AssertionError(f"wrapper launches {launches} != the frontends' "
                             f"and the engines' {totals}")
    numbers["launches"] = dict(launches, **totals)

    # the frontend's own batches against plain (after the counted window):
    # one of each pad it launched, max_batch (the saturation passes') among
    # them
    max_err = 0
    captured = cap.done()
    if on_card:
        big = {k for k in cap.pads if k[1] >= 256}
        if set(captured) != big or ("", FE_SHAPE["max_batch"]) \
                not in captured:
            raise AssertionError(f"(b) frontend pads {sorted(cap.pads)}, "
                                 f"captured {sorted(captured)}")
        max_err = cap.max_err(dev)
    numbers["readbacks_vs_plain"] = {
        "pads": [pad for _, pad in sorted(captured)],
        "frontend_pads": [pad for _, pad in sorted(cap.pads)],
        "max_abs_err": max_err}
    ex_d, ex_n = numbers["defaults"]["exactness"], \
        numbers["no_reuse"]["exactness"]
    ex_k = numbers["api_keys"]
    mixed = report.get("serving_surfaces", {}).get("native_vs_grpc_aio")
    if mixed is None:
        raise AssertionError("(b) phase 12's server did not serve through "
                             "the native frontend")
    log(f"native frontend (b): {WIRE_PAYLOADS} wire requests byte-equal to "
        f"the port's grpc.aio server and equal to the oracle "
        f"({ex_d['allowed']} allowed) at the serving defaults "
        f"(frontend {ex_d['frontend']}) and with dedup and the cache off "
        f"({ex_n['frontend']}); {KEY_CONFIGS} API-key configs "
        f"({', '.join(wc.KEY_KINDS)}): {ex_k['requests']} requests "
        f"byte-equal to grpc.aio and equal to the oracle {ex_k['codes']}, "
        f"fast-lane share {ex_k['fast_share']:.3f} (lanes {ex_k['lanes']}; "
        f"frontend {ex_k['frontend']}); phase 12's mixed corpus: {mixed}; "
        f"the first frontend batch of each pad "
        f"{numbers['readbacks_vs_plain']['pads']} (of pads launched "
        f"{numbers['readbacks_vs_plain']['frontend_pads']}) byte-equal to "
        f"plain (tolerance 0)")
    su = numbers["stop_under_load"]
    log(f"native frontend (e): stop(drain_s=10) with {su['started_at_stop']} "
        f"of {su['sent']} requests received: {su['answered']} answered, "
        f"each equal to the oracle, {su['refused_unavailable']} later ones "
        f"refused UNAVAILABLE, in {su['stop_s']:.2f}s; (f) "
        f"device-down: {FAIL_ROWS} fast-lane requests all "
        f"{'UNAVAILABLE' if on_card else 'decided by the CPU degrade'}, "
        f"{numbers['device_down']['degraded']} degraded, "
        f"{numbers['device_down']['retries']} retry, "
        f"{numbers['device_down']['breaker_open_batches']} slots kept off "
        f"the card by the open breaker")

    # ---- (e) the CLI as a process with --native-frontend on ---------------
    e = entry_point_drain(entry, on_card)
    if "native grpc ext_authz listening" not in e["log_tail"] + e["log_head"]:
        raise AssertionError(f"(e) the process did not serve through the "
                             f"native frontend: {e['log_head'][-2000:]}")
    numbers["entry_point"] = {k: v for k, v in e.items()
                              if not k.startswith("log_")}
    log(f"native frontend (e): python3 -m authorino_tpu_torch server "
        f"--native-frontend on ready in {e['ready_s']:.1f}s, 32 gRPC and 8 "
        f"HTTP Check()s equal the oracle, SIGTERM with 64 Check()s in "
        f"flight: all answered, exit {e['exit_code']} after "
        f"{e['sigterm_to_exit_s']:.2f}s")
    report["native_frontend"] = numbers
    return launches, max_err


# ---------------------------------------------------------------------------
# phase 16: the verified-credential cache and the hybrid lane
# ---------------------------------------------------------------------------

DYN_TRIALS = 1            # load-generator passes per frontend setting
# (a): first-pass requests in flight.  All 4,092 at once queue on the slow
# lane, whose admission feed (queued over the routed rate) reads a slow
# host's drain of them, once no more arrive, as a standing wait and sheds
# typed RESOURCE_EXHAUSTED (the parent tree too, on such a host); the
# last window drains within the feed's 4 s interval
DYN_FIRST_WINDOW = 256
DYN_PASS_S = (2.0, 1.0)   # (seconds measured, seconds of warm-up) per pass
EXP_AHEAD_S = 4           # (c): the short token's exp, seconds ahead
JOSE_LEEWAY_S = 30        # the verifier's clock-skew leeway (utils/jose.py)
HYB_CONFIGS, HYB_RULES = 1000, 10   # (f): the wire corpus's shape
HYB_PAYLOADS = 4096
OPT_IN_TTL_S = 2          # (e): the cache opt-ins' ttl
SA_TOKEN = "sa-token-16"  # (e): the token the fake API server reviews
SA_USER = "system:serviceaccount:keys:app"
OPAQUE_TOKEN = "opaque-cached"   # (e): the token the fake Keycloak knows
INTROSPECT = "POST /protocol/openid-connect/token/introspect"
# the frontend's slow lane takes a first pass of ~4,000 verifications at
# once: its admission target is wide, as the engine's, so the pass is
# served, not shed
DYN_FE = dict(FE_SHAPE, admission_target_s=60.0)


def to_payload(model) -> bytes:
    from authorino_tpu_torch.protos import wire
    from authorino_tpu_torch.protos.ext_authz import request_proto_from_model

    return wire.encode_check_request(request_proto_from_model(model))


def dyn_frontend(report: dict, card: str, dev, ctx8: dict,
                 material: tuple) -> tuple:
    """Phase 16: the native frontend's verified-credential cache and its
    hybrid lane on the card, over one engine holding phase 8's 1,000
    ``jwt-{i}`` configs (entries and minted tokens reused, rebound to it),
    phase 10's 16 x509 configs, an OAuth2-introspection and a Kubernetes
    TokenReview config under a cache opt-in, and 1,000 hybrid configs (the
    wire rule beside a procedural Rego at priority 1).  (a) Keycloak RBAC
    with the verdict cache off, then at the defaults: a first pass of the
    distinct (host, token) pairs verifies and registers in the slow lane;
    the cycled 4,096 ride the fast lane; codes equal phase 8's oracle,
    bytes the grpc.aio server's; the C++ load generator at 1,024 in
    flight over the registered tokens; (c) a token of exp a few seconds
    ahead goes slow and UNAUTHENTICATED once past it (and the verifier's
    leeway), with the verdict cache warm; (d) mTLS certificates slow at
    first sight, fast on repeat; (e) introspection and TokenReview calls
    counted across the opt-in's TTL; (f) hybrid: kernel denials native,
    PASSes decided by the pipeline, ``authconfig_total`` once per request;
    (b) a JWKS rotation under traffic: no token of the retired key is
    answered OK after the swap.  Each part's first frontend batch of each
    pad (of 256 rows or more in (a), (b), (c)) is held to plain.  Returns (the kernels' launches, counts
    zeroed just before the phase; the max abs byte error against plain)."""
    import copy
    import os
    import shutil
    import struct
    import tempfile
    import threading

    import grpc

    from authorino_tpu_torch import native
    from authorino_tpu_torch.controllers import translate_auth_config
    from authorino_tpu_torch.k8s import InMemoryCluster, Secret
    from authorino_tpu_torch.k8s.client import RestCluster
    from authorino_tpu_torch.models import control_plane as cp
    from authorino_tpu_torch.models import oidc_corpus as oc
    from authorino_tpu_torch.models import wire_corpus as wc
    from authorino_tpu_torch.ops import fused_kernel as fk
    from authorino_tpu_torch.protos import wire
    from authorino_tpu_torch.runtime import PolicyEngine
    from authorino_tpu_torch.runtime.native_frontend import NativeFrontend
    from authorino_tpu_torch.utils import jose, rpc
    from authorino_tpu_torch.utils import metrics as metrics_mod

    on_card = dev.type == "cuda"
    t_phase = time.monotonic()
    numbers = {"card": card}
    idp, keys = ctx8["idp"], ctx8["keys"]
    jwt_entries = [e for e in ctx8["entries"]
                   if e.id.startswith(f"{oc.NAMESPACE}/jwt-")]
    reqs, oracle = ctx8["reqs"], ctx8["oracle"]
    lg = str(native.build_loadgen())
    tmpdir = tempfile.mkdtemp(prefix="phase16-")

    def code_of(raw) -> int:
        return wire.decode_check_response(raw).status.code

    def want_code(o) -> int:
        return rpc.UNAUTHENTICATED if isinstance(o, str) else o[0]

    # ---- the corpus -------------------------------------------------------
    fk.reset_counts()
    reset_host_counts()
    engine = PolicyEngine(max_batch=DYN_FE["max_batch"], device=dev,
                          **WIDE_ADMISSION)
    bind(jwt_entries, engine)
    cluster = InMemoryCluster()
    for sec in oc.cluster_secrets(keys):
        cluster.put_secret(Secret(**sec))
    rsa_ca, ec_ca, certs = material
    for name, ca in (("ca-rsa", rsa_ca), ("ca-ec", ec_ca)):
        cluster.put_secret(Secret(name=name, namespace=cp.NAMESPACE,
                                  labels=dict(cp.CA_LABEL),
                                  data={"ca.crt": ca.pem}))
    idp.active_tokens[OPAQUE_TOKEN] = {"active": True, "username": "svc-16"}
    api = cp.FakeApiServer().start()
    api.token_reviews[SA_TOKEN] = {"status": {
        "authenticated": True,
        "user": {"username": SA_USER, "groups": ["system:authenticated"]}}}
    rest = RestCluster(api.url, token="authorino")
    specs = ([(oc.introspection_auth_config(idp.issuer, OPT_IN_TTL_S),
               cluster),
              (cp.tokenreview_auth_config(OPT_IN_TTL_S, SA_USER), rest)]
             + [(cp.mtls_auth_config(k), cluster) for k in range(CP_MTLS)]
             + [(h, cluster) for h in wc.hybrid_auth_configs(HYB_CONFIGS,
                                                             HYB_RULES)])

    async def translate_all():
        return [await translate_auth_config(
            o["metadata"]["name"], o["metadata"]["namespace"], o["spec"],
            cluster=c, engine=engine) for o, c in specs]

    t = time.perf_counter()
    extra = asyncio.run(translate_all())
    numbers["translate_s"] = time.perf_counter() - t
    entries = jwt_entries + extra
    t = time.perf_counter()
    engine.apply_snapshot(entries)
    numbers["install_s"] = time.perf_counter() - t
    n_fast = len(entries)   # every config has a kernel row

    # (a)'s traffic: phase 8's requests; the first pass holds each
    # distinct (host, token) pair once
    payloads = [to_payload(r) for r in reqs]
    seen, first = set(), []
    for k, r in enumerate(reqs):
        key = (r.http.host, r.http.headers["authorization"])
        if key not in seen:
            seen.add(key)
            first.append(k)
    good = [k for k, o in enumerate(oracle) if not isinstance(o, str)]
    n_good_pairs = sum(not isinstance(oracle[k], str) for k in first)
    good_path = os.path.join(tmpdir, "good.payloads")
    with open(good_path, "wb") as f:
        for k in good:
            f.write(struct.pack(">I", len(payloads[k])) + payloads[k])

    aio = AioLoop()
    stop_py = None
    fes = []
    try:
        py_port, stop_py = serve_grpc_aio(aio, engine)
        t = time.perf_counter()
        aio_out = grpc_many(aio, py_port, payloads, window=AIO_WINDOW)
        numbers["grpc_aio_first_s"] = time.perf_counter() - t
        for k, (raw, o) in enumerate(zip(aio_out, oracle)):
            if not isinstance(raw, bytes) or code_of(raw) != want_code(o):
                raise AssertionError(f"(a) grpc.aio request {k}: {raw!r} "
                                     f"!= oracle {o!r}")

        def start(label, **kw):
            fe = NativeFrontend(engine, port=0, **dict(DYN_FE, **kw))
            fes.append(fe)
            port = fe.start()
            if not fe.wait_warm(60):
                raise AssertionError(f"({label}) the warm launch never ran")
            dv = fe.debug_vars()["snapshot"]
            if dv["fast_configs"] != n_fast or dv["hybrid_configs"] != \
                    HYB_CONFIGS or dv["dyn_registrations"] != \
                    len(jwt_entries) + 2 + CP_MTLS:
                raise AssertionError(f"({label}) snapshot {dv}")
            return fe, port

        def lanes(fe):
            s = fe.stats()
            out = {k: s[k] for k in ("fast", "slow", "hybrid", "dyn_hit",
                                     "dyn_miss")}
            # the C++ credential cache's own adds and hits (stats() folds
            # the verdict cache's into dyn_*)
            out["dyn_add"] = s["dyn_add"] - s.get("vdict_add", 0)
            out["dyn_hit"] -= s.get("vdict_hit", 0)
            out["dyn_miss"] -= s.get("vdict_miss", 0)
            out["vdict_hit"] = s.get("vdict_hit", 0)
            out.update({k: fe.counts[k] for k in (
                "batches", "cached_batches", "launches", "device_rows",
                "dyn_registered", "dyn_register_ns", "degraded_rows",
                "unavailable_rows")})
            return out

        def diff(a, b):
            return {k: b[k] - a[k] for k in a}

        def keycloak(label, fe, port):
            """(a) at one frontend setting."""
            out = {}
            c0 = lanes(fe)
            t = time.perf_counter()
            first_out = grpc_many(aio, port, [payloads[k] for k in first],
                                  window=DYN_FIRST_WINDOW)
            wall = time.perf_counter() - t
            c1 = lanes(fe)
            d = diff(c0, c1)
            for k, raw in zip(first, first_out):
                if raw != aio_out[k]:
                    raise AssertionError(f"({label}) first pass {k}: native "
                                         f"{raw!r} != grpc.aio")
            if (d["slow"] != len(first) or d["fast"] != 0
                    or d["dyn_add"] != n_good_pairs
                    or d["dyn_registered"] != n_good_pairs):
                raise AssertionError(f"({label}) first pass: {d}, "
                                     f"{n_good_pairs} good pairs")
            out["first_pass"] = {
                "requests": len(first), "good_pairs": n_good_pairs,
                "wall_s": wall, "checks_per_s": len(first) / wall,
                "register_us": d["dyn_register_ns"] / 1e3
                / max(1, d["dyn_registered"]), "counts": d}
            # the cycled pass: every registered token rides the fast lane
            c0 = lanes(fe)
            cyc = grpc_many(aio, port, payloads)
            d = diff(c0, lanes(fe))
            for k, raw in enumerate(cyc):
                if raw != aio_out[k]:
                    raise AssertionError(f"({label}) cycled {k}: native "
                                         f"{raw!r} != grpc.aio")
            n_bad = len(payloads) - len(good)
            share = d["fast"] / len(good)
            if (share < 0.95 or d["slow"] != n_bad or d["dyn_miss"] != n_bad
                    or d["dyn_hit"] != len(good) or d["dyn_add"] != 0):
                raise AssertionError(f"({label}) cycled pass: {d}, "
                                     f"{len(good)} good {n_bad} bad")
            if on_card and (d["launches"] != d["batches"]
                            - d["cached_batches"] or d["launches"] < 1):
                raise AssertionError(f"({label}) launches per slot: {d}")
            out["cycled"] = {"requests": len(payloads), "good": len(good),
                             "bad": n_bad, "fast_share_good": share,
                             "counts": d}
            # the C++ load generator over the registered tokens
            runs = []
            for _ in range(DYN_TRIALS):
                c0 = lanes(fe)
                r = loadgen(lg, port, good_path, DYN_PASS_S, LIGHT_DEPTH,
                            LIGHT_CONNS)
                wait_idle(engine, timeout=120)
                r["counts"] = diff(c0, lanes(fe))
                if r["counts"]["slow"]:
                    raise AssertionError(f"({label}) a registered token "
                                         f"rode the slow lane: {r}")
                runs.append(r)
            out["loadgen"] = runs
            out["loadgen_median"] = {k: statistics.median(r[k] for r in runs)
                                     for k in ("rps", "p50_ms", "p99_ms")}
            m = out["loadgen_median"]
            fp = out["first_pass"]
            log(f"[{card}] dyn frontend (a, {label}): first pass "
                f"{fp['requests']} distinct (host, token) pairs on the slow "
                f"lane {fp['checks_per_s']:.0f} checks/s, {fp['good_pairs']} "
                f"registered, {fp['register_us']:.1f} us of host work per "
                f"registration; cycled {len(payloads)}: fast share of good "
                f"tokens {share:.4f}, {n_bad} bad tokens all slow, "
                f"{d['launches']} launches for {d['batches']} slots "
                f"({d['cached_batches']} cache-only), {d['device_rows']} "
                f"device rows; load generator ({LIGHT_DEPTH} x "
                f"{LIGHT_CONNS} in flight, {DYN_PASS_S[0]:g} s after "
                f"{DYN_PASS_S[1]:g} s): "
                f"{[round(r['rps']) for r in runs]} checks/s (median "
                f"{m['rps']:.0f}, p50 {m['p50_ms']:.2f} ms p99 "
                f"{m['p99_ms']:.2f} ms)")
            return out

        cap = PadCapture(fk).install()
        cap.part("a", 256)
        try:
            # ---- (a) with the verdict cache and dedup off ---------------
            fe, port = start("a, cache off", **NO_REUSE)
            numbers["cache_off"] = keycloak("cache off", fe, port)
            fe.stop(drain_s=10)
            # ---- the serving defaults: (c) armed first, then (a), (d),
            # (e), (f), (c) read, (b) ------------------------------------
            fe, port = start("defaults")
            k_c = next(k for k in good if oracle[k][0] == rpc.OK)
            claims = jose.decode_unverified(
                reqs[k_c].http.headers["authorization"][7:])[1]
            exp = int(time.time()) + EXP_AHEAD_S
            short_req = copy.deepcopy(reqs[k_c])
            short_req.http.headers["authorization"] = \
                "Bearer " + idp.token(dict(claims, exp=exp))
            short = to_payload(short_req)
            c0 = lanes(fe)
            got = [grpc_many(aio, port, [short])[0] for _ in range(2)]
            d = diff(c0, lanes(fe))
            if [code_of(g) for g in got] != [rpc.OK] * 2 or (
                    d["slow"], d["fast"], d["dyn_registered"]) != (1, 1, 1):
                raise AssertionError(f"(c) a token of exp +{EXP_AHEAD_S}s: "
                                     f"{[code_of(g) for g in got]} {d}")
            numbers["defaults"] = keycloak("defaults", fe, port)

            # ---- (d) mTLS -----------------------------------------------
            # (d)-(f) launch few rows: every pad's first batch is held
            cap.part("d", 1)
            m_pay = [to_payload(mtls_request(k, pem)) for k, pem, _, _
                     in certs]
            m_want = [mtls_expected(kind, rsa, True) for _, _, kind, rsa
                      in certs]
            m_valid = sum(kind in ("good", "other-org") for _, _, kind, _
                          in certs)
            m_aio = grpc_many(aio, py_port, m_pay, window=AIO_WINDOW)
            passes = []
            for _ in range(2):
                c0 = lanes(fe)
                out = grpc_many(aio, port, m_pay)
                passes.append(diff(c0, lanes(fe)))
                for k, (raw, a, w) in enumerate(zip(out, m_aio, m_want)):
                    if raw != a or code_of(raw) != w:
                        raise AssertionError(f"(d) certificate {k}: {raw!r} "
                                             f"vs grpc.aio {a!r}, want {w}")
            d1, d2 = passes
            if (d1["slow"], d1["dyn_add"], d2["fast"], d2["slow"],
                    d2["dyn_add"]) != (len(m_pay), m_valid, m_valid,
                                       len(m_pay) - m_valid, 0):
                raise AssertionError(f"(d) mTLS lanes {passes}")
            numbers["mtls"] = {
                "certificates": len(m_pay), "registered": m_valid,
                "register_us": d1["dyn_register_ns"] / 1e3 / m_valid,
                "first": d1, "repeat": d2}

            # ---- (e) introspection and TokenReview under a cache opt-in --
            cap.part("e", 1)
            def reviews():
                return sum(1 for r in api.requests
                           if r[1].endswith("/tokenreviews"))

            def introspections():
                return idp.counts[INTROSPECT]

            kinds = {
                "oauth2": (to_payload(_bearer_req(
                    oc.INTROSPECTION_CACHED_HOST, OPAQUE_TOKEN)),
                    introspections),
                "kubernetes": (to_payload(_bearer_req(
                    cp.TOKENREVIEW_HOST, SA_TOKEN)), reviews)}
            e_out = {name: {"calls": [], "fast": [], "answers": []}
                     for name in kinds}
            t_reg = time.monotonic()
            for step in range(4):
                if step == 2:
                    time.sleep(max(0.0, OPT_IN_TTL_S + 0.5
                                   - (time.monotonic() - t_reg)))
                for name, (pay, calls) in kinds.items():
                    n0, f0 = calls(), fe.stats()["fast"]
                    e_out[name]["answers"].append(
                        grpc_many(aio, port, [pay])[0])
                    e_out[name]["calls"].append(calls() - n0)
                    e_out[name]["fast"].append(fe.stats()["fast"] - f0)
            for name, (pay, calls) in kinds.items():
                eo = e_out[name]
                ref = grpc_many(aio, py_port, [pay])[0]
                if (eo["calls"] != [1, 0, 1, 0] or eo["fast"] != [0, 1, 0, 1]
                        or any(a != ref for a in eo["answers"])
                        or code_of(ref) != rpc.OK):
                    raise AssertionError(f"(e) {name}: calls {eo['calls']}, "
                                         f"fast {eo['fast']}")
                numbers[name] = {"calls_per_check": eo["calls"],
                                 "fast_per_check": eo["fast"],
                                 "ttl_s": OPT_IN_TTL_S}

            # ---- (f) hybrid ---------------------------------------------
            cap.part("f", 1)
            h_pay = wc.wire_payloads(HYB_PAYLOADS, HYB_CONFIGS,
                                     host_fmt=wc.HYBRID_HOST)
            h_pass = [wc.expected_allow(p, HYB_RULES) for p in h_pay]

            def hyb_total():
                return sum(s.value for fam in
                           metrics_mod.authconfig_total.collect()
                           for s in fam.samples
                           if s.name.endswith("_total")
                           and s.labels.get("namespace")
                           == wc.HYBRID_NAMESPACE)

            tot0 = hyb_total()
            c0 = lanes(fe)
            t = time.perf_counter()
            h_out = grpc_many(aio, port, h_pay)
            h_wall = time.perf_counter() - t
            d = diff(c0, lanes(fe))
            deadline = time.monotonic() + 30
            while hyb_total() - tot0 < len(h_pay) and \
                    time.monotonic() < deadline:
                time.sleep(0.05)
            time.sleep(0.5)
            counted = hyb_total() - tot0
            h_aio = grpc_many(aio, py_port, h_pay, window=AIO_WINDOW)
            n_pass = sum(h_pass)
            for k, (raw, a, kp) in enumerate(zip(h_out, h_aio, h_pass)):
                if raw != a or (not kp and code_of(raw)
                                != rpc.PERMISSION_DENIED):
                    raise AssertionError(f"(f) request {k}: native {raw!r} "
                                         f"vs grpc.aio {a!r}")
            allowed = sum(code_of(r) == rpc.OK for r in h_out)
            if (d["hybrid"] != n_pass or d["slow"] != n_pass
                    or d["fast"] != len(h_pay) or counted != len(h_pay)
                    or not 0 < allowed < n_pass):
                raise AssertionError(f"(f) hybrid: {d}, {n_pass} kernel "
                                     f"passes, authconfig_total +{counted}, "
                                     f"{allowed} allowed")
            numbers["hybrid"] = {
                "requests": len(h_pay), "kernel_denials": len(h_pay) - n_pass,
                "handed_off": d["hybrid"], "allowed": allowed,
                "authconfig_total": counted, "wall_s": h_wall,
                "checks_per_s": len(h_pay) / h_wall, "counts": d}

            # ---- (c) read: past exp and the verifier's leeway -----------
            cap.part("c, b", 256)
            wait_s = exp + JOSE_LEEWAY_S + 1 - time.time()
            numbers["expiry_wait_s"] = max(0.0, wait_s)
            if wait_s > 0:
                time.sleep(wait_s)
            c0 = lanes(fe)
            raw = grpc_many(aio, port, [short])[0]
            d = diff(c0, lanes(fe))
            if (code_of(raw) != rpc.UNAUTHENTICATED
                    or raw != grpc_many(aio, py_port, [short])[0]
                    or (d["slow"], d["fast"], d["vdict_hit"],
                        d["dyn_registered"]) != (1, 0, 0, 0)):
                raise AssertionError(f"(c) past exp: {code_of(raw)} {d}")
            numbers["expiry"] = {"exp_ahead_s": EXP_AHEAD_S,
                                 "leeway_s": JOSE_LEEWAY_S,
                                 "vdict_hits_before": c0["vdict_hit"],
                                 "counts": d}

            # ---- (b) a JWKS rotation under traffic ----------------------
            k_b = next(k for k in good if oracle[k][0] == rpc.OK)
            i_b = int(reqs[k_b].http.host.split(".")[0][len("jwt-"):])
            oidc_b = next(e for e in jwt_entries if e.id ==
                          f"{oc.NAMESPACE}/jwt-{i_b}"
                          ).runtime.identity[0].evaluator
            old = payloads[k_b]
            if grpc_many(aio, port, [old])[0] != aio_out[k_b]:
                raise AssertionError("(b) the registered token's answer")
            answers, stop = [], threading.Event()

            def traffic():
                with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
                    call = ch.unary_unary(CHECK_METHOD)
                    while not stop.is_set():
                        t_sent = time.monotonic()
                        answers.append((t_sent, code_of(call(old,
                                                             timeout=30))))

            def background():
                while not stop.is_set():
                    grpc_many(aio, port, payloads[:512])

            threads = [threading.Thread(target=traffic),
                       threading.Thread(target=background)]
            for th in threads:
                th.start()
            before = list(idp.jwks)
            snap0 = fe._cur_rec.snap_id
            try:
                time.sleep(0.5)
                idp.jwks = [jose.jwk_from_public_key(
                    keys.rogue.public_key(), kid=oc.ROGUE_KID), before[1]]
                t_rot = time.monotonic()
                aio.run(oidc_b.refresh())
                while fe._cur_rec.snap_id == snap0:
                    if time.monotonic() - t_rot > 60:
                        raise AssertionError("(b) no refresh after rotation")
                    time.sleep(0.005)
                t_swap = time.monotonic()
                time.sleep(1.0)
            finally:
                stop.set()
                for th in threads:
                    th.join(timeout=120)
            after = [c for ts, c in answers if ts > t_swap]
            if not after or any(c != rpc.UNAUTHENTICATED for c in after):
                raise AssertionError(f"(b) after the swap: {after[:20]}")
            c0 = lanes(fe)
            raw = grpc_many(aio, port, [old])[0]
            d = diff(c0, lanes(fe))
            new_req = copy.deepcopy(reqs[k_b])
            tok = reqs[k_b].http.headers["authorization"][7:]
            new_req.http.headers["authorization"] = "Bearer " + idp.token(
                jose.decode_unverified(tok)[1], key=keys.rogue,
                kid=oc.ROGUE_KID)
            new = to_payload(new_req)
            c1 = lanes(fe)
            new_out = [grpc_many(aio, port, [new])[0] for _ in range(2)]
            d_new = diff(c1, lanes(fe))
            if (code_of(raw) != rpc.UNAUTHENTICATED or (d["slow"], d["fast"])
                    != (1, 0) or [code_of(x) for x in new_out]
                    != [rpc.OK] * 2 or (d_new["slow"], d_new["fast"])
                    != (1, 1)):
                raise AssertionError(f"(b) old {code_of(raw)} {d}, new "
                                     f"{[code_of(x) for x in new_out]} "
                                     f"{d_new}")
            numbers["rotation"] = {
                "config": f"jwt-{i_b}", "refresh_ms": (t_swap - t_rot) * 1e3,
                "old_token_answers_after_swap": len(after),
                "answers_during": len(answers), "old_after": d,
                "new_key_token": d_new}
            idp.jwks = before
            aio.run(oidc_b.refresh())
            fe.stop(drain_s=10)
            if fe._refresh_threads or fe._change_wired:
                raise AssertionError("(b) stop() left a refresh thread or a "
                                     "wired listener")
        finally:
            cap.restore()
        for fe_i in fes:
            if fe_i.counts["degraded_rows"] or fe_i.counts["unavailable_rows"]:
                raise AssertionError(f"a frontend row was not decided by the "
                                     f"kernel: {fe_i.counts}")
        wait_idle(engine, timeout=60)
    finally:
        for fe_i in fes:
            if fe_i._running:
                fe_i.stop(drain_s=5)
        if stop_py is not None:
            stop_py()
        aio.close()
        api.stop()
        shutil.rmtree(tmpdir, ignore_errors=True)
    launches = {"fused_megakernel": fk.launches,
                "probe_add_one": fk.probe_launches}
    fe_l = sum(f.counts["launches"] + f.counts["warm_launches"] for f in fes)
    if on_card and launches["fused_megakernel"] != (
            fe_l + engine.stats["launches"]):
        raise AssertionError(f"wrapper launches {launches} != the frontends' "
                             f"{fe_l} and the engine's "
                             f"{engine.stats['launches']}")
    numbers["launches"] = dict(launches, frontends=fe_l,
                               engine=engine.stats["launches"])
    max_err = cap.max_err(dev) if on_card else 0
    held = {part for part, _ in cap.done()}
    if on_card and not {"a", "d", "e", "f"} <= held:
        raise AssertionError(f"a part with no frontend batch held to plain: "
                             f"pads {sorted(cap.pads)}, held "
                             f"{sorted(cap.done())}")
    numbers["readbacks_vs_plain"] = {
        "pads": sorted(cap.done()), "frontend_pads": sorted(cap.pads),
        "max_abs_err": max_err}
    numbers["phase_s"] = time.monotonic() - t_phase
    mt, hy = numbers["mtls"], numbers["hybrid"]
    log(f"[{card}] dyn frontend (d): {mt['certificates']} client "
        f"certificates of phase 10, {mt['registered']} registered at first "
        f"sight ({mt['register_us']:.1f} us of host work each), the same "
        f"{mt['registered']} fast on repeat, every answer byte-equal to "
        f"grpc.aio; (e) introspection calls per check "
        f"{numbers['oauth2']['calls_per_check']}, TokenReviews "
        f"{numbers['kubernetes']['calls_per_check']} across a {OPT_IN_TTL_S}"
        f" s opt-in; (f) {hy['requests']} hybrid requests: "
        f"{hy['kernel_denials']} kernel denials native, {hy['handed_off']} "
        f"PASSes decided by the pipeline ({hy['allowed']} allowed), "
        f"{hy['checks_per_s']:.0f} checks/s, authconfig_total "
        f"+{hy['authconfig_total']:.0f}; (c) past exp + leeway: "
        f"UNAUTHENTICATED on the slow lane with the verdict cache warm; (b) "
        f"rotation on {numbers['rotation']['config']}: refresh "
        f"{numbers['rotation']['refresh_ms']:.1f} ms, "
        f"{numbers['rotation']['old_token_answers_after_swap']} answers to "
        f"the retired key's token after the swap, all UNAUTHENTICATED; "
        f"launches {numbers['launches']}; frontend pads "
        f"{numbers['readbacks_vs_plain']['pads']} byte-equal to plain; "
        f"phase {numbers['phase_s']:.1f} s")
    report["dyn_frontend"] = numbers
    return launches, max_err


def _bearer_req(host: str, token: str):
    from authorino_tpu_torch.authjson import (CheckRequestModel,
                                              HttpRequestAttributes)

    return CheckRequestModel(http=HttpRequestAttributes(
        method="GET", path="/", host=host,
        headers={"authorization": f"Bearer {token}"}))


# ---------------------------------------------------------------------------
# phase 17: the incremental reconcile and the snapshot container
# ---------------------------------------------------------------------------

# (a)'s steps on the north-star corpus: (label, config changed, its change);
# each step's corpus holds every change before it
DELTA_STEPS = (("cold", None, None), ("unchanged", None, None),
               ("const", 7, "const"), ("leaf", 311, "leaf"),
               ("regex", 977, "regex"))
# (b): the config whose change measures the cache's survival, then the ten
# configs changed one swap at a time under the burst (method flipped)
SURVIVAL_CONFIG = 11
SWAP_CONFIGS = (97, 203, 305, 419, 523, 631, 733, 859, 967, 42)
SURVIVAL_MIN = 0.95
PROBES = 64               # (b): requests on the survival config, all flipped
CONTAINER_RUNS = 3        # (d): serialize / deserialize timings


def param_leaves(tree, prefix: str = "") -> dict:
    """{path: tensor or int} of a params tree, the wrapper's cached launch
    words left out."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k != "launch_words":
                out.update(param_leaves(v, f"{prefix}.{k}"))
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            out.update(param_leaves(v, f"{prefix}.{i}"))
    else:
        out[prefix] = tree
    return out


def same_params(got, want, label: str) -> None:
    """Every leaf of two params trees equal: tensors by device, dtype,
    shape and bytes, ints as ints."""
    import torch

    g, w = param_leaves(got), param_leaves(want)
    if g.keys() != w.keys():
        raise AssertionError(f"{label}: params trees differ in "
                             f"{sorted(set(g) ^ set(w))}")
    for k, v in w.items():
        if isinstance(v, torch.Tensor):
            ok = (isinstance(g[k], torch.Tensor) and g[k].device == v.device
                  and g[k].dtype == v.dtype and torch.equal(g[k], v))
        else:
            ok = type(g[k]) is type(v) and g[k] == v
        if not ok:
            raise AssertionError(f"{label}: param {k} differs from a full "
                                 f"upload")


def frozen_params(params) -> dict:
    """(data pointer, a copy) of every tensor of a params tree."""
    import torch

    return {k: (v.data_ptr(), v.clone()) for k, v in
            param_leaves(params).items() if isinstance(v, torch.Tensor)}


def require_untouched(params, before: dict, label: str) -> None:
    import torch

    for k, v in param_leaves(params).items():
        if isinstance(v, torch.Tensor):
            ptr, copy = before[k]
            if v.data_ptr() != ptr or not torch.equal(v, copy):
                raise AssertionError(f"{label}: the previous snapshot's "
                                     f"tensor {k} was written")


def device_allocated(dev) -> int:
    import gc

    import torch

    gc.collect()
    if dev.type != "cuda":
        return 0
    torch.cuda.synchronize(dev)
    return torch.cuda.memory_allocated(dev)


def retained_bytes(engine) -> int:
    """Device bytes the engine's serving snapshot and its bounded history
    hold: every CUDA storage reachable from their params, once, at the
    caching allocator's 512 B granule (``memory_allocated`` counts
    blocks)."""
    import torch

    seen = {}

    def walk(node):
        if isinstance(node, torch.Tensor):
            if node.is_cuda:
                st = node.untyped_storage()
                seen[st.data_ptr()] = -(-st.nbytes() // 512) * 512
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    for snap in [engine._snapshot, *engine._history]:
        walk(snap.params)
    return sum(seen.values())


def delta_readbacks(snap, cfgs, docs, names, dev) -> dict:
    """(a)'s readback check for one snapshot: for every 256-row batch of
    ``docs``, the kernel on the snapshot's (delta-built) params against a
    full upload of the same policy, the plain version, and a cold compile
    and upload of the same corpus (a fresh string table: its own encode),
    byte for byte.  Comparison launches, uncounted by the caller."""
    import torch

    from authorino_tpu_torch.compiler import compile_corpus
    from authorino_tpu_torch.compiler.encode import encode_batch
    from authorino_tpu_torch.compiler.pack import pack_batch
    from authorino_tpu_torch.ops import fused_kernel as fk
    from authorino_tpu_torch.ops.operands import defuse, fuse_batch, to_device

    policy = snap.policy
    full = to_device(policy, device=dev)
    same_params(snap.params, full, "delta-built params")
    cold_policy = compile_corpus(cfgs, members_k=16)
    cold = to_device(cold_policy, device=dev)
    batches = err = 0
    for lo in range(0, len(docs), 256):
        d, n = docs[lo:lo + 256], names[lo:lo + 256]
        db = pack_batch(policy, encode_batch(
            policy, d, [policy.config_ids[x] for x in n]))
        got = fk.eval_fused_kernel(snap.params, db)
        buf, layout = fuse_batch(db)
        plain = fk.fused_packed_plain(snap.params, defuse(
            torch.from_numpy(buf).to(dev), layout))
        cdb = pack_batch(cold_policy, encode_batch(
            cold_policy, d, [cold_policy.config_ids[x] for x in n]))
        err = max(err, max_byte_err(got, fk.eval_fused_kernel(full, db)),
                  max_byte_err(got, plain),
                  max_byte_err(got, fk.eval_fused_kernel(cold, cdb)))
        batches += 1
    return {"batches": batches, "rows": len(docs), "max_abs_err": err}


def incremental_reconcile(report: dict, card: str, dev, ctx6: dict,
                          ns: dict) -> tuple:
    """Phase 17: the incremental reconcile and the snapshot container, at
    full width.  (a) the mega-kernel on delta-built params, (b) the engine
    under load across ten one-config swaps, (c) a manifest change end to
    end beside a cold engine, (d) the snapshot container.  Returns (the
    kernels' launches on (b)'s path, counts zeroed just before it; the max
    abs byte error of the comparisons)."""
    import shutil
    import tempfile

    import numpy as np

    from authorino_tpu_torch.authjson import build_authorization_json
    from authorino_tpu_torch.compiler.encode import encode_batch
    from authorino_tpu_torch.compiler.pack import pack_batch
    from authorino_tpu_torch.controllers import (AuthConfigReconciler,
                                                 SecretReconciler,
                                                 translate_auth_config)
    from authorino_tpu_torch.controllers import reconciler as reconciler_mod
    from authorino_tpu_torch.controllers import sources as sources_mod
    from authorino_tpu_torch.controllers.sources import YamlDirSource
    from authorino_tpu_torch.k8s import InMemoryCluster
    from authorino_tpu_torch.models import control_plane as cp
    from authorino_tpu_torch.models import northstar
    from authorino_tpu_torch.ops import fused_kernel as fk
    from authorino_tpu_torch.ops.operands import to_device
    from authorino_tpu_torch.runtime import EngineEntry, PolicyEngine
    from authorino_tpu_torch.snapshots import (deserialize_policy,
                                               serialize_policy)
    from authorino_tpu_torch.utils import rpc

    t_phase = time.perf_counter()
    numbers = {"card": card}
    max_err = 0

    # ---- (a) the kernel on delta-built params ------------------------------
    engine = PolicyEngine(max_batch=256, device=dev, **NO_REUSE)
    docs, names = ns["docs"], ns["names"]
    changed, steps = {}, []
    for label, idx, change in DELTA_STEPS:
        if idx is not None:
            changed[idx] = change
        cfgs = northstar.build_corpus(1000, 10, changed=dict(changed))
        prev = engine._snapshot
        before = frozen_params(prev.params) if prev is not None else None
        t = time.perf_counter()
        engine.apply_snapshot([EngineEntry(id=c.name, hosts=[c.name],
                                           rules=c) for c in cfgs])
        wall = time.perf_counter() - t
        snap = engine._snapshot
        rep, up = snap.compile_report, snap.upload
        want_names = ([] if label == "unchanged" else [f"cfg-{idx}"]
                      if idx is not None else None)
        if want_names is not None and rep.compiled_names != want_names:
            raise AssertionError(f"(a) {label}: compiled "
                                 f"{rep.compiled_names}, expected {want_names}")
        if label == "cold" and rep.compiled != 1000:
            raise AssertionError(f"(a) cold: compiled {rep.compiled}")
        touched = {t_["name"]: t_ for t_ in up["arrays_touched"]}
        want_mode = {"cold": "full", "unchanged": "reuse"}.get(label, "delta")
        ok = up["mode"] == want_mode
        if label == "unchanged":
            ok = ok and (up["upload_bytes"] == 0 and rep.reused_policy
                         and snap.params is prev.params)
        if label == "const":
            ok = ok and 0 < up["upload_bytes"] < up["full_bytes"] / 2 and {
                t_["mode"] for t_ in touched.values()} == {"rows"}
        if label == "leaf":
            ok = ok and touched.get("kernel.cfg_off", {}).get("mode") == "full"
        if label == "regex":
            ok = ok and touched.get("kernel.dfa_image", {}).get("mode") \
                == "full"
        if not ok:
            raise AssertionError(f"(a) {label}: upload {up}")
        if before is not None:
            require_untouched(prev.params, before, f"(a) {label}")
        rb = delta_readbacks(snap, cfgs, docs, names, dev)
        max_err = max(max_err, rb["max_abs_err"])
        steps.append({
            "step": label, "changed": want_names, "compiled": rep.compiled,
            "cached": rep.cached, "mode": up["mode"],
            "upload_bytes": up["upload_bytes"],
            "full_bytes": up["full_bytes"],
            "touched": {k: [v["mode"], v["rows"], v["upload_bytes"]]
                        for k, v in touched.items()},
            "phases_ms": {k: v * 1e3 for k, v in snap.phase_s.items()},
            "encoder_build_ms": snap.encoder_build_s * 1e3,
            "apply_snapshot_ms": wall * 1e3, "readback": rb})
    numbers["delta_steps"] = steps
    for s in steps:
        log(f"[{card}] incremental reconcile (a) {s['step']}: compiled "
            f"{s['compiled']} ({s['changed']}), cached {s['cached']}; "
            f"upload {s['mode']} {s['upload_bytes']} of {s['full_bytes']} B"
            f" ({len(s['touched'])} operands touched: "
            f"{s['touched']}); phases "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in s["phases_ms"].items())
            + f", native encoder {s['encoder_build_ms']:.3f} ms, "
            f"apply_snapshot {s['apply_snapshot_ms']:.3f} ms; the previous "
            f"params untouched; {s['readback']['rows']} docs in "
            f"{s['readback']['batches']} [256, W] readbacks byte-equal to a "
            f"full upload, to plain and to a cold compile")

    # ---- (d) the snapshot container ----------------------------------------
    snap = engine._snapshot
    meta = {"generation": snap.generation,
            "fingerprints": dict(snap.fingerprints)}
    ser_ms, de_ms = [], []
    for _ in range(CONTAINER_RUNS):
        t = time.perf_counter()
        blob = serialize_policy(snap.policy, meta=meta)
        ser_ms.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        loaded, got_meta = deserialize_policy(blob)
        de_ms.append((time.perf_counter() - t) * 1e3)
    if got_meta != meta or serialize_policy(loaded, meta=meta) != blob:
        raise AssertionError("(d) the container does not round-trip")
    t = time.perf_counter()
    loaded_params = to_device(loaded, device=dev)
    upload_ms = (time.perf_counter() - t) * 1e3
    same_params(loaded_params, to_device(snap.policy, device=dev),
                "(d) loaded params")
    for lo in range(0, len(docs), 256):
        d, n = docs[lo:lo + 256], names[lo:lo + 256]
        db = pack_batch(loaded, encode_batch(
            loaded, d, [loaded.config_ids[x] for x in n]))
        sdb = pack_batch(snap.policy, encode_batch(
            snap.policy, d, [snap.policy.config_ids[x] for x in n]))
        max_err = max(max_err, max_byte_err(
            fk.eval_fused_kernel(loaded_params, db),
            fk.eval_fused_kernel(snap.params, sdb)))
    numbers["container"] = {
        "blob_bytes": len(blob), "serialize_ms": ser_ms,
        "deserialize_ms": de_ms, "upload_ms": upload_ms,
        "readback_rows": len(docs)}
    log(f"[{card}] incremental reconcile (d): the installed north-star "
        f"policy as a {len(blob)} B blob, serialize "
        f"{statistics.median(ser_ms):.1f} ms, deserialize "
        f"{statistics.median(de_ms):.1f} ms (median of {CONTAINER_RUNS}), "
        f"upload {upload_ms:.1f} ms; the loaded params equal the installed "
        f"snapshot's and its {len(docs)} docs' readbacks are byte-equal")
    del engine, snap, loaded_params

    # ---- (b) the engine under load -------------------------------------------
    acs = northstar.build_auth_configs(1000, 10)
    reqs = ctx6["reqs"]
    jwt = northstar.JWT_FILTER
    probe = northstar.build_check_requests(PROBES, 1000, seed=11)
    for j, q in enumerate(probe):
        q.http.host = northstar.host_of(SURVIVAL_CONFIG)
        q.http.method = ("GET", "POST")[j % 2]
        q.metadata_context["filter_metadata"][jwt]["verified_jwt"]["org"] = \
            f"org-{SURVIVAL_CONFIG}"
    engine = PolicyEngine(max_batch=256, device=dev, **WIDE_ADMISSION)
    gens = cp.GenerationLog(engine)
    state = {"current": {}}
    corpus_of = {}
    engine.add_swap_listener(lambda: state.__setitem__(
        engine.generation, dict(state["current"])))

    def rules_at(gen: int):
        key = tuple(sorted(state[gen].items()))
        if key not in corpus_of:
            corpus_of[key] = [c.evaluators[0][1] for c in
                              northstar.build_corpus(1000, 10,
                                                     changed=state[gen])]
        return corpus_of[key]

    def hold(results, issued, label) -> dict:
        """Every result against the oracle of its generation, with the
        deny provenance; returns the checks per generation."""
        seen, flipped = {}, 0
        for k, (res, req) in enumerate(zip(results, issued)):
            gen = gens.by_request.get(id(req))
            if gen is None or gen not in state:
                raise AssertionError(f"(b) {label}: check {k} has no "
                                     f"generation ({gen}): {res}")
            i = int(req.http.host.split(".")[0][len("svc-"):])
            claims = req.metadata_context["filter_metadata"][jwt][
                "verified_jwt"]
            doc = build_authorization_json(req, {"identity": claims})
            rule = rules_at(gen)[i]
            if rule.matches(doc):
                want = (rpc.OK, 0, "", {})
            else:
                want = (rpc.PERMISSION_DENIED, 0, "Unauthorized", {
                    "ext_authz_provenance": {
                        "authconfig": f"{northstar.NAMESPACE}/cfg-{i}",
                        "rule_index": 0, "rule": str(rule),
                        "lane": "engine"}})
            got = (res.code, res.status, res.message, res.metadata)
            if got != want:
                raise AssertionError(f"(b) {label}: check {k} on cfg-{i} at "
                                     f"generation {gen}: {got} != {want}")
            if state[gen] and rules_at(1)[i].matches(doc) != \
                    rule.matches(doc):
                flipped += 1
            seen[gen] = seen.get(gen, 0) + 1
        return {"by_generation": seen, "flipped_vs_first": flipped}

    async def translate(specs):
        return [await translate_auth_config(
            o["metadata"]["name"], o["metadata"]["namespace"], o["spec"],
            engine=engine) for o in specs]

    async def changed_entries(entries, i, change):
        state["current"] = {**state["current"], i: change}
        spec = northstar.build_auth_configs(1000, 10,
                                            changed=state["current"])[i]
        out = list(entries)
        out[i] = (await translate([spec]))[0]
        return out

    async def burst(label, extra=()):
        """One burst of every request at once, held to the oracle of its
        generation before a later burst reuses the request objects."""
        issued = list(reqs) + list(extra)
        r0 = len(engine.batch_records)
        c0 = engine.stats["cache_rows"]
        out = await timed_checks(engine, issued)
        return {"held": hold([r for r, _ in out], issued, label),
                "cache_rows": engine.stats["cache_rows"] - c0,
                "records": checked_records(engine, r0), "label": label}

    async def under_load():
        entries = await translate(acs)
        await asyncio.to_thread(engine.apply_snapshot, entries)
        b1 = await burst("cold", probe)
        b2 = await burst("warm", probe)
        entries = await changed_entries(entries, SURVIVAL_CONFIG, "method")
        await asyncio.to_thread(engine.apply_snapshot, entries)
        b3 = await burst("after one change", probe)
        await asyncio.to_thread(wait_idle, engine)
        # device memory beside what the serving snapshot and the bounded
        # history hold: a retained generation keeps the arrays it owns (a
        # cold install's whole set, a delta's cloned operands) until it
        # is evicted, so the raw figure moves with the history's mix
        mem0 = await asyncio.to_thread(device_allocated, dev)
        held0 = retained_bytes(engine)
        # ten one-config swaps, each beside a wave of the burst
        size = -(-len(reqs) // (len(SWAP_CONFIGS) + 1))
        waves = [reqs[lo:lo + size] for lo in range(0, len(reqs), size)]
        issued, results, swap_ms = [], [], []
        r0 = len(engine.batch_records)
        for w, wave in enumerate(waves):
            task = None
            if w < len(SWAP_CONFIGS):
                entries = await changed_entries(entries, SWAP_CONFIGS[w],
                                                "method")
                t = time.perf_counter()
                task = asyncio.ensure_future(
                    asyncio.to_thread(engine.apply_snapshot, entries))
            issued += wave
            results += [r for r, _ in await timed_checks(engine, wave)]
            if task is not None:
                await task
                swap_ms.append((time.perf_counter() - t) * 1e3)
        records = checked_records(engine, r0)
        held = hold(results, issued, "ten swaps")
        await asyncio.to_thread(wait_idle, engine)
        mem1 = await asyncio.to_thread(device_allocated, dev)
        return (b1, b2, b3, held, records, swap_ms, (mem0, held0),
                (mem1, retained_bytes(engine)))

    fk.reset_counts()
    reset_host_counts()
    b1, b2, b3, swaps_held, records, swap_ms, (mem0, held0), \
        (mem1, held1) = asyncio.run(under_load())
    launches = {"fused_megakernel": fk.launches,
                "probe_add_one": fk.probe_launches}
    held = {b["label"]: b["held"] for b in (b1, b2, b3)}
    held["swaps"] = swaps_held
    all_records = b1["records"] + b2["records"] + b3["records"] + records
    device_batches = sum(1 for r in all_records if r["device_rows"])
    # (a CPU dry run calls the plain version where the card launches)
    kernel_calls = fk.launches if dev.type == "cuda" else fk.plain_calls
    if kernel_calls != device_batches:
        raise AssertionError(f"(b) {launches} launches for {device_batches} "
                             f"batches with a device row")
    enc = encoder_used(engine, engine.stats["batches"])
    require_encoder("incremental reconcile (b)", enc, "native")
    survival = b3["cache_rows"] / max(1, b2["cache_rows"])
    if survival < SURVIVAL_MIN:
        raise AssertionError(f"(b) {survival:.4f} of the warm cache's rows "
                             f"served after one change ({b3['cache_rows']} "
                             f"of {b2['cache_rows']})")
    if held["after one change"]["flipped_vs_first"] < PROBES:
        raise AssertionError(f"(b) the changed config's probes: "
                             f"{held['after one change']}")
    if engine.generation != 2 + len(SWAP_CONFIGS) or \
            len(held["swaps"]["by_generation"]) < 2:
        raise AssertionError(f"(b) generations: {engine.generation}, "
                             f"{held['swaps']}")
    if mem1 - held1 != mem0 - held0:
        raise AssertionError(f"(b) device memory beside the retained "
                             f"generations grew {(mem1 - held1) - (mem0 - held0):+d} B "
                             f"over ten swaps (memory {mem0} -> {mem1}, "
                             f"retained {held0} -> {held1})")
    numbers["under_load"] = {
        "checks": {k: sum(v["by_generation"].values())
                   for k, v in held.items()},
        "by_generation": {k: v["by_generation"] for k, v in held.items()},
        "flipped_vs_first": {k: v["flipped_vs_first"]
                             for k, v in held.items()},
        "cache_rows": [b1["cache_rows"], b2["cache_rows"], b3["cache_rows"]],
        "survival": survival, "batches": len(all_records),
        "device_batches": device_batches, "swap_ms": swap_ms,
        "memory_before_swaps": mem0, "memory_after_swaps": mem1,
        "retained_before_swaps": held0, "retained_after_swaps": held1,
        "last_upload": engine.debug_vars()["control_plane"]["upload"],
        "encoder": enc, "launches": launches}
    ul = numbers["under_load"]
    log(f"[{card}] incremental reconcile (b): 1,000 translated north-star "
        f"configs at the serving defaults; warm burst {b2['cache_rows']} "
        f"rows from the cache, after cfg-{SURVIVAL_CONFIG}'s method flipped "
        f"{b3['cache_rows']} ({survival:.4f} survive; its {PROBES} probes "
        f"all answered the new rule); ten one-config swaps under "
        f"{ul['checks']['swaps']} Check()s: verdicts by generation "
        f"{ul['by_generation']['swaps']}, every one the oracle's of its "
        f"generation ({ul['flipped_vs_first']['swaps']} differ from "
        f"generation 1's); {device_batches} of {len(all_records)} batches "
        f"with a device row, one launch each ({launches}); swaps "
        f"{[round(x, 1) for x in swap_ms]} ms; device memory "
        f"{mem0} -> {mem1} B over the ten swaps, the serving snapshot and "
        f"the history holding {held0} -> {held1} B of it: "
        f"{(mem1 - held1) - (mem0 - held0):+d} B beside them; "
        f"{fmt_encoder(enc)}")

    # ---- (c) the reconcile end to end -----------------------------------------
    n = CP_CONFIGS
    base = cp.build_auth_configs(n, CP_RULES)
    c_reqs, c_cfgs, c_known = cp.build_check_requests(256, n)
    rules = cp.config_rules(n, CP_RULES)
    flip_j = next(j for j, (q, i, good) in enumerate(zip(c_reqs, c_cfgs,
                                                          c_known))
                  if good and cp.expected_code(q, i, rules, True)
                  != cp.expected_code(q, i, cp.config_rules(
                      n, CP_RULES, flip=[i]), True))
    flip_i = c_cfgs[flip_j]
    flipped = cp.config_rules(n, CP_RULES, flip=[flip_i])
    want_old = cp.expected_code(c_reqs[flip_j], flip_i, rules, True)
    want_new = cp.expected_code(c_reqs[flip_j], flip_i, flipped, True)
    d = Path(tempfile.mkdtemp(prefix="reconcile-"))

    def write(i: int, ac: dict, rv: str) -> None:
        ac = json.loads(json.dumps(ac))
        ac["metadata"]["resourceVersion"] = rv
        (d / f"ac-{i:04d}.json").write_text(json.dumps(ac))

    timing = {"parse": 0.0, "translate": 0.0, "apply": 0.0}
    real_load, real_translate = (sources_mod.load_manifests,
                                 reconciler_mod.translate_auth_config)

    def timed_load(path):
        t = time.perf_counter()
        try:
            return real_load(path)
        finally:
            timing["parse"] += time.perf_counter() - t

    async def timed_translate(*a, **kw):
        t = time.perf_counter()
        try:
            return await real_translate(*a, **kw)
        finally:
            timing["translate"] += time.perf_counter() - t

    def instrumented(eng):
        inner = eng.apply_snapshot

        def apply_snapshot(entries, override=True):
            t = time.perf_counter()
            try:
                return inner(entries, override)
            finally:
                timing["apply"] += time.perf_counter() - t

        eng.apply_snapshot = apply_snapshot
        return eng

    def split(eng, total: float) -> dict:
        snap = eng._snapshot
        ph = {k: v * 1e3 for k, v in snap.phase_s.items()}
        out = {"total_ms": total * 1e3, "parse_ms": timing["parse"] * 1e3,
               "translate_ms": timing["translate"] * 1e3,
               "apply_snapshot_ms": timing["apply"] * 1e3,
               "native_encoder_ms": snap.encoder_build_s * 1e3,
               "compiled": snap.compile_report.compiled,
               "upload": {k: snap.upload[k] for k in
                          ("mode", "upload_bytes", "full_bytes")}}
        out.update({f"{k}_ms": v for k, v in ph.items()})
        out["rest_ms"] = out["total_ms"] - out["parse_ms"] - \
            out["translate_ms"] - out["apply_snapshot_ms"]
        return out

    async def change_one_file():
        eng = instrumented(PolicyEngine(max_batch=256, device=dev,
                                        **WIDE_ADMISSION))
        cluster = InMemoryCluster()
        src = YamlDirSource(str(d), AuthConfigReconciler(eng, cluster=cluster),
                            cluster, SecretReconciler(eng))
        await src.sync()
        r = await eng.check(c_reqs[flip_j])
        if r.code != want_old:
            raise AssertionError(f"(c) before the change: {r.code}")
        for k in timing:
            timing[k] = 0.0
        t = time.perf_counter()
        write(flip_i, cp.build_auth_configs(n, CP_RULES, flip=[flip_i])[
            flip_i], "2")
        await src.sync()
        r = await eng.check(c_reqs[flip_j])
        total = time.perf_counter() - t
        if r.code != want_new:
            raise AssertionError(f"(c) after the change: {r.code}")
        warm = split(eng, total)
        if warm["compiled"] != 1 or warm["upload"]["mode"] != "delta":
            raise AssertionError(f"(c) the changed file: {warm}")
        # the same state through a cold engine: an empty compile cache,
        # the bootstrap deny-all, every config compiled and uploaded
        for k in timing:
            timing[k] = 0.0
        t = time.perf_counter()
        eng2 = instrumented(PolicyEngine(max_batch=256, device=dev,
                                         **WIDE_ADMISSION))
        cluster2 = InMemoryCluster()
        src2 = YamlDirSource(str(d), AuthConfigReconciler(eng2,
                                                          cluster=cluster2),
                             cluster2, SecretReconciler(eng2))
        await src2.sync()
        r = await eng2.check(c_reqs[flip_j])
        total = time.perf_counter() - t
        if r.code != want_new:
            raise AssertionError(f"(c) a cold engine: {r.code}")
        return warm, split(eng2, total)

    sources_mod.load_manifests = timed_load
    reconciler_mod.translate_auth_config = timed_translate
    try:
        for i, ac in enumerate(base):
            write(i, ac, "1")
            (d / f"key-{i:04d}.json").write_text(
                json.dumps(cp.api_key_secret(i)))
        warm, cold = asyncio.run(change_one_file())
    finally:
        sources_mod.load_manifests = real_load
        reconciler_mod.translate_auth_config = real_translate
        shutil.rmtree(d, ignore_errors=True)
    numbers["one_file"] = {"configs": n, "secrets": n, "warm": warm,
                           "cold": cold}

    def fmt(s):
        return (f"{s['total_ms']:.1f} ms = parse {s['parse_ms']:.1f} + "
                f"translate {s['translate_ms']:.1f} + apply_snapshot "
                f"{s['apply_snapshot_ms']:.1f} (compile "
                f"{s.get('compile_ms', 0):.1f}, native encoder "
                f"{s['native_encoder_ms']:.1f}, diff {s.get('diff_ms', 0):.1f}"
                f", upload {s.get('upload_ms', 0):.1f}) + the rest "
                f"{s['rest_ms']:.1f}; {s['compiled']} compiled, upload "
                f"{s['upload']['mode']} {s['upload']['upload_bytes']} of "
                f"{s['upload']['full_bytes']} B")

    log(f"[{card}] incremental reconcile (c): one of {n} API-key manifest "
        f"files changed (cfg {flip_i}'s rule flipped), from the write to the "
        f"first Check() answering the new rule: {fmt(warm)}; the same state "
        f"through a cold engine: {fmt(cold)}")
    numbers["phase_s"] = time.perf_counter() - t_phase
    numbers["launches"] = launches
    report["incremental_reconcile"] = numbers
    return launches, max_err


# ---------------------------------------------------------------------------
# phase 18: change safety (canary swaps by cohort, guard-breach rollback,
# poison-config quarantine, the bounded snapshot history, /debug/canary)
# ---------------------------------------------------------------------------

CANARY_FRACTION = 0.25
# the window outlasts (a)'s burst of 5,120 checks (about 1.2 s on an idle
# host, past 3 s on a loaded one); (b)'s guard must still detect within
# CANARY_DETECT_MS
CANARY_WINDOW_S = 6.0
CANARY_DETECT_MS = 3000.0
HOT_CONFIG = 7            # the hot host's config: (b) flips it to deny
HOT_REQUESTS = 1024       # requests to the hot host
HOT_PATHS = 64            # distinct paths among them (the cohort hash input)
CLEAN_CONFIG = 97         # (a): its constant changes
BENIGN_CONFIG = 203       # (b): its constant changes beside the poison
HISTORY = 4               # (c)'s snapshot_history
HISTORY_SWAPS = (305, 419, 523, 631, 733, 859, 967, 42)  # (c): method flips
HISTORY_DOCS = 256        # (c): the docs each generation's readback covers
FRESH_SEED = 13           # (a): the canary burst's requests, unseen before
WARM_SEED = 17            # (a): an untimed first burst's requests


def hot_requests(n: int = HOT_REQUESTS, paths: int = HOT_PATHS):
    """``n`` Check()s to the hot config's host over ``paths`` distinct
    paths, each with the config's method and org claim (so every one
    reaches the Any_ branch and allows at the base corpus)."""
    from authorino_tpu_torch.authjson import (CheckRequestModel,
                                              HttpRequestAttributes)
    from authorino_tpu_torch.models import northstar

    spec = northstar.build_auth_configs(HOT_CONFIG + 1, 10)[HOT_CONFIG]
    method = spec["spec"]["authorization"]["rules"]["patternMatching"][
        "patterns"][0]["value"]
    out = []
    for k in range(n):
        out.append(CheckRequestModel(
            http=HttpRequestAttributes(
                method=method, path=f"/hot/p{k % paths}",
                host=northstar.host_of(HOT_CONFIG), headers={}),
            metadata_context={"filter_metadata": {northstar.JWT_FILTER: {
                "verified_jwt": {"org": f"org-{HOT_CONFIG}", "roles": [],
                                 "groups": []}}}}))
    return out


def change_safety(report: dict, card: str, dev, ctx6: dict,
                  ns: dict) -> tuple:
    """Phase 18: change safety at full width.  Phase 6's 1,000 translated
    north-star configs in one card engine at the serving defaults with the
    canary at fraction 0.25 and a 3 s window, a native frontend attached,
    phase 6's 4,096 Check()s plus 1,024 to one hot host over 64 paths:
    (a) a clean change canaries (every verdict the oracle's of its
    cohort's generation, each request's cohort the port's
    ``in_canary_cohort`` of its document, launches = the (cut, cohort)
    parts with a device row, both generations' params resident) and
    promotes at the window's end, the frontend refreshing once, then;
    (b) a poison change (the hot config flipped to deny beside a benign
    change) breaches, rolls back and quarantines exactly the hot config
    while the benign change lands (every verdict after it the quarantined
    corpus's oracle; /debug/canary and /readyz through the port's aiohttp
    app; clear-quarantine); (d) a drain mid-canary leaves it undecided.
    (c) the bounded history on a second engine: rollbacks compile
    nothing, upload nothing, launch no probe, re-serve byte-equal
    readbacks; device memory +0 B past a full history.  Returns (the
    kernels' launches on (a)+(b)'s path, counts zeroed just before it;
    the max abs byte error of the comparisons)."""
    import numpy as np
    import torch
    from aiohttp.test_utils import TestClient, TestServer

    from authorino_tpu_torch.authjson import build_authorization_json
    from authorino_tpu_torch.controllers import translate_auth_config
    from authorino_tpu_torch.models import control_plane as cp
    from authorino_tpu_torch.models import northstar
    from authorino_tpu_torch.ops import fused_kernel as fk
    from authorino_tpu_torch.runtime import EngineEntry, PolicyEngine
    from authorino_tpu_torch.runtime import engine as engine_mod
    from authorino_tpu_torch.runtime.change_safety import in_canary_cohort
    from authorino_tpu_torch.runtime.flight_recorder import RECORDER
    from authorino_tpu_torch.runtime.native_frontend import NativeFrontend
    from authorino_tpu_torch.service.http_server import build_app
    from authorino_tpu_torch.utils import metrics as metrics_mod
    from authorino_tpu_torch.utils import rpc

    t_phase = time.perf_counter()
    numbers = {"card": card, "fraction": CANARY_FRACTION,
               "window_s": CANARY_WINDOW_S}
    max_err = 0
    on_card = dev.type == "cuda"
    jwt = northstar.JWT_FILTER
    hot = hot_requests()

    def interleave(regular):
        """The hot host's requests spread evenly through ``regular``: every
        cut, and so both cohorts, then carry the same mix (the overall
        deny-rate guard compares the cohorts' mixes as they fold)."""
        step = max(1, len(regular) // len(hot))
        out = []
        for k, q in enumerate(hot):
            out += regular[k * step:(k + 1) * step] + [q]
        return out + regular[len(hot) * step:]

    reqs = interleave(list(ctx6["reqs"]))
    # the canary burst's: as many requests the cache has not seen
    fresh = interleave(northstar.build_check_requests(
        len(ctx6["reqs"]), 1000, seed=FRESH_SEED))
    # an untimed first burst: a fresh engine's first one pays its warm-up
    warmup = interleave(northstar.build_check_requests(
        len(ctx6["reqs"]), 1000, seed=WARM_SEED))
    # (b)'s: the hot host first, so the poison's per-config evidence is in
    # the guard before the overall deny rate's (which names no suspect)
    hot_first = hot + list(ctx6["reqs"])
    hot_id = f"{northstar.NAMESPACE}/cfg-{HOT_CONFIG}"
    benign_id = f"{northstar.NAMESPACE}/cfg-{BENIGN_CONFIG}"

    # the tenant plane off: (b) sends the hot host first so that its
    # per-config evidence folds before the overall deny rate's, an order
    # the FIFO cut keeps and the weighted-fair cut does not (it spreads
    # the hot host's rows over every cut); phase 19 holds the plane
    engine = PolicyEngine(max_batch=256, device=dev,
                          canary_fraction=CANARY_FRACTION,
                          canary_window_s=CANARY_WINDOW_S, tenant_qos=False,
                          **WIDE_ADMISSION)
    gens = cp.GenerationLog(engine)
    state = {"current": {}}
    corpus_of = {}

    def rules_at(gen: int):
        key = tuple(sorted(state[gen].items()))
        if key not in corpus_of:
            corpus_of[key] = [c.evaluators[0][1] for c in
                              northstar.build_corpus(1000, 10,
                                                     changed=state[gen])]
        return corpus_of[key]

    def mark_generation() -> None:
        """The corpus state of the generation the last apply made: the
        candidate's while a canary is up, else the serving one's."""
        phase = engine._canary
        gen = (phase.snap.generation if phase is not None
               else engine._snapshot.generation)
        state[gen] = dict(state["current"])

    # the cut's cohort split, tallied: cuts, parts, cuts holding both
    split = {"cuts": 0, "parts": 0, "mixed": 0}
    real_split = engine_mod._split_cohorts

    def counting_split(batch, phase):
        parts = real_split(batch, phase)
        split["cuts"] += 1
        split["parts"] += len(parts)
        split["mixed"] += int(len(parts) == 2)
        return parts

    engine_mod._split_cohorts = counting_split

    # the rollback's flight bundle, timed apart from the recovery
    dumps = []
    real_dump = RECORDER.dump

    def timed_dump(trigger):
        t0 = time.monotonic()
        try:
            return real_dump(trigger)
        finally:
            dumps.append((trigger, t0, time.monotonic()))

    RECORDER.dump = timed_dump
    flight0 = (RECORDER.dump_dir, RECORDER.min_dump_interval_s)
    RECORDER.configure(dump_dir=str(Path("smoke_out") / "flight-18"),
                       min_dump_interval_s=0.0)

    def promoted_at():
        """The wall time of the newest promotion in the recorder's tail."""
        return next((e["t"] for e in RECORDER.to_json()["tail"][::-1]
                     if e["kind"] == "canary-promote"), None)

    def hold(results, issued, label, phase_gens=None) -> dict:
        """Every result against the oracle of the generation that decided
        it, with the deny provenance.  ``phase_gens`` = (baseline,
        candidate, the phase): the baseline decides only its cohort, the
        candidate only the canary cohort until it was promoted.  Returns
        the checks per generation and per cohort."""
        seen, by_cohort, late = {}, {"canary": 0, "baseline": 0}, 0
        if phase_gens is not None:
            base_gen, cand_gen, ph = phase_gens
            t_promo = promoted_at() if engine._canary is not ph and \
                engine._snapshot is ph.snap else None
        for k, ((res, t_end), req) in enumerate(zip(results, issued)):
            gen = gens.by_request.get(id(req))
            if gen is None or gen not in state:
                raise AssertionError(f"(18) {label}: check {k} has no "
                                     f"generation ({gen}): {res}")
            i = int(req.http.host.split(".")[0][len("svc-"):])
            claims = req.metadata_context["filter_metadata"][jwt][
                "verified_jwt"]
            doc = build_authorization_json(req, {"identity": claims})
            if phase_gens is not None:
                canary = in_canary_cohort(doc, CANARY_FRACTION)
                by_cohort["canary" if canary else "baseline"] += 1
                if gen == base_gen and canary:
                    raise AssertionError(f"(18) {label}: check {k} of the "
                                         f"canary cohort decided by the "
                                         f"baseline {gen}")
                if gen == cand_gen and not canary:
                    if t_promo is None or t_end < t_promo:
                        raise AssertionError(
                            f"(18) {label}: check {k} of the baseline "
                            f"cohort decided by the candidate {gen}")
                    late += 1
            rule = rules_at(gen)[i]
            if rule.matches(doc):
                want = (rpc.OK, 0, "", {})
            else:
                want = (rpc.PERMISSION_DENIED, 0, "Unauthorized", {
                    "ext_authz_provenance": {
                        "authconfig": f"{northstar.NAMESPACE}/cfg-{i}",
                        "rule_index": 0, "rule": str(rule),
                        "lane": "engine"}})
            got = (res.code, res.status, res.message, res.metadata)
            if got != want:
                raise AssertionError(f"(18) {label}: check {k} on cfg-{i} "
                                     f"at generation {gen}: {got} != {want}")
            seen[gen] = seen.get(gen, 0) + 1
        return {"by_generation": seen, "by_cohort": by_cohort,
                "after_promotion": late}

    async def stamped_checks(issued):
        """Every Check() at once: ((result, end wall time), seconds)."""
        async def one(req):
            t = time.perf_counter()
            res = await engine.check(req)
            return (res, time.time()), time.perf_counter() - t

        return await asyncio.gather(*(one(r) for r in issued))

    async def burst(label, phase_gens=None, issued=None):
        issued = reqs if issued is None else issued
        r0 = len(engine.batch_records)
        t = time.perf_counter()
        out = await stamped_checks(issued)
        wall = time.perf_counter() - t
        p50, p99 = latency_ms([s for _, s in out])
        held = hold([r for r, _ in out], issued, label, phase_gens)
        return {"label": label, "checks_per_s": len(issued) / wall,
                "p50_ms": p50, "p99_ms": p99, "held": held,
                "records": checked_records(engine, r0)}

    async def translate(specs):
        return [await translate_auth_config(
            o["metadata"]["name"], o["metadata"]["namespace"], o["spec"],
            engine=engine) for o in specs]

    async def change(entries, changes: dict):
        state["current"] = {**state["current"], **changes}
        specs = northstar.build_auth_configs(1000, 10,
                                             changed=state["current"])
        out = list(entries)
        for i in changes:
            out[i] = (await translate([specs[i]]))[0]
        return out

    async def wait_for(pred, timeout: float, what: str):
        deadline = time.monotonic() + timeout
        while not pred():
            if time.monotonic() > deadline:
                raise AssertionError(f"(18) {what} after {timeout}s")
            await asyncio.sleep(0.01)

    def snap_id(fe) -> int:
        return fe.debug_vars()["snapshot"]["snap_id"]

    def resident(phase) -> dict:
        """The candidate's and the baseline's params on the device: every
        tensor on the card, and the bytes the candidate holds apart."""
        base, cand = ({k: t for k, t in param_leaves(p).items()
                       if isinstance(t, torch.Tensor)}
                      for p in (phase.baseline.params, phase.snap.params))
        devices = {str(t.device) for t in list(base.values())
                   + list(cand.values())}
        if devices != {str(dev)}:
            raise AssertionError(f"(a) params off the device: {devices}")
        own = sum(int(t.numel() * t.element_size())
                  for k, t in cand.items()
                  if k not in base or t.data_ptr() != base[k].data_ptr())
        return {"candidate_own_bytes": own,
                "baseline_bytes": sum(int(t.numel() * t.element_size())
                                      for t in base.values())}

    async def path():
        entries = await translate(northstar.build_auth_configs(1000, 10))
        await asyncio.to_thread(engine.apply_snapshot, entries)
        mark_generation()
        fe = NativeFrontend(engine, port=0, max_batch=256, window_us=500)
        fe.start()
        try:
            return await drive(entries, fe)
        finally:
            fe.stop()

    async def drive(entries, fe):
        out = {}
        await burst("warm-up", issued=warmup)
        # both timed bursts meet a cold cache: phase 6's requests with no
        # canary, then as many unseen ones during the canary
        plain = await burst("no canary")
        mem0 = await asyncio.to_thread(device_allocated, dev)
        ids = [snap_id(fe)]
        warm0 = fe.counts["warm_launches"]
        # ---- (a) a clean change ---------------------------------------------
        entries = await change(entries, {CLEAN_CONFIG: "const"})
        split.update(cuts=0, parts=0, mixed=0)
        l0 = fk.launches if on_card else fk.plain_calls
        await asyncio.to_thread(engine.apply_snapshot, entries)
        phase = engine._canary
        if phase is None:
            raise AssertionError("(a) a corpus-changing swap did not canary")
        mark_generation()
        base_gen, cand_gen = phase.baseline.generation, phase.snap.generation
        mem_canary = await asyncio.to_thread(device_allocated, dev)
        res = resident(phase) if on_card else {}
        r0 = len(engine.batch_records)
        canary = await burst("(a) canary", (base_gen, cand_gen, phase),
                             fresh)
        ids.append(snap_id(fe))
        in_window = engine._canary is phase
        await wait_for(lambda: engine._canary is None,
                       CANARY_WINDOW_S + 30, "(a) the window never closed")
        await wait_for(lambda: snap_id(fe) != ids[0], 30,
                       "(a) the frontend never refreshed")
        await asyncio.to_thread(wait_idle, engine)
        ids.append(snap_id(fe))
        if engine._last_rollback is not None or \
                engine._snapshot is not phase.snap:
            raise AssertionError(f"(a) the clean canary did not promote: "
                                 f"{engine.change_safety_vars()}")
        records = checked_records(engine, r0)
        device_parts = sum(1 for r in records if r["device_rows"])
        warm_launches = fe.counts["warm_launches"] - warm0
        launched = (fk.launches if on_card else fk.plain_calls) - l0
        if launched != device_parts + warm_launches:
            raise AssertionError(f"(a) {launched} launches for "
                                 f"{device_parts} parts with a device row "
                                 f"(+{warm_launches} frontend warm)")
        if split["parts"] != len(records) or split["mixed"] < 1:
            raise AssertionError(f"(a) cohort split {split} against "
                                 f"{len(records)} batch records")
        if ids != [ids[0], ids[0], ids[0] + 1]:
            raise AssertionError(f"(a) frontend snapshots {ids}: one "
                                 f"refresh, at promotion, expected")
        held_gens = canary["held"]
        out["a"] = {
            "generations": [base_gen, cand_gen],
            "no_canary": {k: plain[k] for k in ("checks_per_s", "p50_ms",
                                                "p99_ms")},
            "canary": {k: canary[k] for k in ("checks_per_s", "p50_ms",
                                              "p99_ms")},
            "held": held_gens, "burst_in_window": in_window,
            "split": dict(split), "records": len(records),
            "device_parts": device_parts, "launches": launched,
            "frontend_warm_launches": warm_launches,
            "frontend_snap_ids": ids, "resident": res,
            "memory_before": mem0, "memory_canary": mem_canary,
            "cache_rows": sum(r["cache_rows"] for r in records)}
        log(f"[{card}] change safety (a): cfg-{CLEAN_CONFIG}'s constant "
            f"changed, canary generation {cand_gen} at "
            f"{CANARY_FRACTION:g} for {CANARY_WINDOW_S:g}s beside baseline "
            f"{base_gen}; {len(reqs)} Check()s ({HOT_REQUESTS} to the hot "
            f"host over {HOT_PATHS} paths) every verdict its cohort's "
            f"generation's oracle {held_gens}; {split['cuts']} cuts -> "
            f"{split['parts']} parts ({split['mixed']} holding both "
            f"cohorts), {device_parts} with a device row = {launched} "
            f"launches less {warm_launches} frontend warm; both "
            f"generations resident {res} (memory {mem0} -> {mem_canary} "
            f"B); promoted at the window's end, the frontend refreshed "
            f"once {ids}; checks/s {canary['checks_per_s']:.0f} during the "
            f"canary (p50 {canary['p50_ms']:.2f} p99 {canary['p99_ms']:.2f} "
            f"ms) vs {plain['checks_per_s']:.0f} with none (p50 "
            f"{plain['p50_ms']:.2f} p99 {plain['p99_ms']:.2f} ms), each "
            f"burst on requests the cache had not seen, after an untimed "
            f"warm-up burst")

        # ---- (b) a poison change --------------------------------------------
        entries = await change(entries, {HOT_CONFIG: "method",
                                         BENIGN_CONFIG: "const"})
        ids = [snap_id(fe)]
        dumps.clear()
        await asyncio.to_thread(engine.apply_snapshot, entries)
        phase = engine._canary
        if phase is None:
            raise AssertionError("(b) the poison change did not canary")
        mark_generation()
        base_gen, cand_gen = phase.baseline.generation, phase.snap.generation
        # the rollback re-serves the baseline as the next generation, and
        # the quarantine's re-apply installs the one after it
        state[cand_gen + 1] = dict(state[base_gen])
        quarantined = {**state["current"]}
        quarantined.pop(HOT_CONFIG)
        state[cand_gen + 2] = quarantined
        t0 = time.monotonic()
        poisoned = await burst("(b) poison", (base_gen, cand_gen, phase),
                               hot_first)
        await wait_for(lambda: engine._canary is None
                       and (engine._last_rollback or {}).get("recover_ms")
                       is not None, CANARY_WINDOW_S + 60,
                       "(b) no rollback and quarantine")
        lr = dict(engine._last_rollback)
        if lr["reason"] != "guard-breach" or lr["detect_ms"] > \
                CANARY_DETECT_MS or lr["to_generation"] != cand_gen + 1 \
                or engine._snapshot.generation != cand_gen + 2:
            raise AssertionError(f"(b) rollback {lr}, serving generation "
                                 f"{engine._snapshot.generation}")
        q = engine._quarantine
        if lr["quarantined"] != [hot_id] or sorted(q["configs"]) != [hot_id]:
            raise AssertionError(f"(b) quarantined {lr['quarantined']}, "
                                 f"{sorted(q['configs'])}: {lr['detail']}")
        fps = engine._snapshot.fingerprints
        if fps[benign_id] != phase.snap.fingerprints[benign_id] or \
                fps[hot_id] != phase.baseline.fingerprints[hot_id]:
            raise AssertionError("(b) the benign change did not land or "
                                 "the poison still serves")
        await asyncio.to_thread(wait_idle, engine)
        recovered = await burst("(b) quarantined", issued=hot_first)
        if set(recovered["held"]["by_generation"]) != {
                engine._snapshot.generation}:
            raise AssertionError(f"(b) after recovery: "
                                 f"{recovered['held']}")
        ids.append(snap_id(fe))
        app = build_app(engine, readiness=lambda: True)
        async with TestClient(TestServer(app)) as client:
            r = await client.get("/debug/canary")
            cs_get = await r.json()
            rz = await client.get("/readyz")
            rz_text = await rz.text()
            rc = await client.post("/debug/canary?action=clear-quarantine")
            cleared = await rc.json()
            rz2 = await client.get("/readyz")
            rz2_text = await rz2.text()
        if (cs_get["quarantine"] or {}).get("configs") != [hot_id] or \
                rz.status != 200 or "quarantine active" not in rz_text:
            raise AssertionError(f"(b) /debug/canary {cs_get}, /readyz "
                                 f"{rz.status} {rz_text!r}")
        if not cleared["applied"] or cleared["change_safety"]["quarantine"] \
                is not None or engine.quarantine_active or rz2_text != "ok":
            raise AssertionError(f"(b) clear-quarantine {cleared}, "
                                 f"{rz2_text!r}")
        t_detect = t0 + lr["detect_ms"] / 1e3
        t_recover = t_detect + lr["recover_ms"] / 1e3
        out["b"] = {
            "generations": [base_gen, cand_gen],
            "rollback": {k: v for k, v in lr.items() if k != "detail"},
            "guards": lr["detail"]["guards"],
            "suspects": lr["detail"]["suspects"],
            "deltas": lr["detail"]["deltas"],
            "poison_burst": {k: poisoned[k] for k in (
                "checks_per_s", "p50_ms", "p99_ms", "held")},
            "recovered_burst": {k: recovered[k] for k in (
                "checks_per_s", "p50_ms", "p99_ms", "held")},
            "frontend_snap_ids": ids,
            "flight_dumps": [{"trigger": d[0],
                              "ms": round((d[2] - d[1]) * 1e3, 3),
                              "overlaps_recovery": d[1] < t_recover}
                             for d in dumps],
            "debug_canary_quarantine": cs_get["quarantine"]["configs"],
            "readyz": rz_text}
        log(f"[{card}] change safety (b): cfg-{HOT_CONFIG} (the hot host) "
            f"flipped to deny beside cfg-{BENIGN_CONFIG}'s benign change: "
            f"guard {lr['detail']['guards']} breached (suspects "
            f"{lr['detail']['suspects']}), detect_ms {lr['detect_ms']} "
            f"recover_ms {lr['recover_ms']}, generation {cand_gen} rolled "
            f"back to {lr['to_generation']}, quarantined {lr['quarantined']}"
            f", the benign change landed; every verdict the oracle's of its "
            f"generation during the window {poisoned['held']} and the "
            f"quarantined corpus's after it {recovered['held']}; "
            f"/debug/canary shows the quarantine, /readyz {rz.status} "
            f"{rz_text!r}, clear-quarantine -> {rz2_text!r}; frontend "
            f"snapshots {ids}; flight bundles {out['b']['flight_dumps']}")

        # ---- (d) a drain mid-canary -----------------------------------------
        entries = await change(entries, {CLEAN_CONFIG: "method"})
        await asyncio.to_thread(engine.apply_snapshot, entries)
        phase = engine._canary
        if phase is None:
            raise AssertionError("(d) no canary to drain")
        fired = []
        engine.add_swap_listener(lambda: fired.append(1))
        gen = engine.generation
        engine.begin_drain()
        await asyncio.sleep(CANARY_WINDOW_S + 0.5)
        if engine._canary is not phase or fired or engine.generation != gen:
            raise AssertionError(f"(d) the canary concluded during a drain: "
                                 f"{engine.change_safety_vars()}")
        out["d"] = {"undecided_after_s": CANARY_WINDOW_S + 0.5,
                    "generation": gen}
        log(f"[{card}] change safety (d): a drain mid-canary cancelled the "
            f"window timer; {CANARY_WINDOW_S + 0.5:g}s later generation "
            f"{gen} is still undecided and no swap listener fired")
        return out

    marks = failure_marks()
    fk.reset_counts()
    reset_host_counts()
    try:
        numbers.update(asyncio.run(path()))
    finally:
        engine_mod._split_cohorts = real_split
        RECORDER.dump = real_dump
        RECORDER.configure(dump_dir=flight0[0],
                           min_dump_interval_s=flight0[1])
    launches = {"fused_megakernel": fk.launches,
                "probe_add_one": fk.probe_launches}
    require_no_failure_handling("phase 18 (a)-(b)", marks)
    enc = encoder_used(engine, engine.stats["batches"])
    require_encoder("change safety", enc, "native")
    numbers["launches"] = launches
    numbers["encoder"] = enc
    del engine

    # ---- (c) the bounded history ---------------------------------------------
    docs = [json.loads(json.dumps(d)) for d in ns["docs"][:HISTORY_DOCS]]
    names = list(ns["names"][:HISTORY_DOCS])
    for k, d in enumerate(docs[:len(HISTORY_SWAPS) * 16]):
        i = HISTORY_SWAPS[k % len(HISTORY_SWAPS)]
        names[k] = f"cfg-{i}"
        d["auth"]["identity"]["org"] = f"org-{i}"
    hist = PolicyEngine(max_batch=256, device=dev, snapshot_history=HISTORY,
                        **NO_REUSE)

    def readback(snap_of) -> bytes:
        out = asyncio.run(serve(hist, docs, names))
        return b"".join(np.asarray(r, dtype=np.uint8).tobytes()
                        + np.asarray(s, dtype=np.uint8).tobytes()
                        for r, s in out)

    served = {}
    changed = {}
    mem = []
    for step in range(len(HISTORY_SWAPS) + 1):
        if step:
            changed[HISTORY_SWAPS[step - 1]] = "method"
        hist.apply_snapshot([EngineEntry(id=c.name, hosts=[c.name], rules=c)
                             for c in northstar.build_corpus(
                                 1000, 10, changed=dict(changed))])
        served[id(hist._snapshot)] = readback(hist._snapshot)
        if step >= HISTORY:
            wait_idle(hist)
            mem.append(device_allocated(dev))
    history_gens = [s.generation for s in hist._history]
    if len(history_gens) != HISTORY:
        raise AssertionError(f"(c) history {history_gens}")
    rollbacks = []
    while True:
        cc0 = hist.compile_cache.stats()
        up0 = (metrics_mod.delta_upload_bytes.labels("engine")._value.get(),
               metrics_mod.full_upload_bytes.labels("engine")._value.get())
        p0 = fk.probe_launches
        target = hist._history[-1] if hist._history else None
        t = time.perf_counter()
        ok = hist.rollback_last()
        swap_ms = (time.perf_counter() - t) * 1e3
        if not ok:
            break
        cc1 = hist.compile_cache.stats()
        up1 = (metrics_mod.delta_upload_bytes.labels("engine")._value.get(),
               metrics_mod.full_upload_bytes.labels("engine")._value.get())
        if cc1 != cc0 or up1 != up0 or fk.probe_launches != p0:
            raise AssertionError(f"(c) a rollback compiled, uploaded or "
                                 f"probed: {cc0} -> {cc1}, {up0} -> {up1}, "
                                 f"probe {p0} -> {fk.probe_launches}")
        if hist._snapshot.params is not target.params:
            raise AssertionError("(c) a rollback did not re-serve the "
                                 "retained params")
        got = readback(hist._snapshot)
        if got != served[id(target)]:
            raise AssertionError(f"(c) rollback to generation "
                                 f"{target.generation}: readbacks differ "
                                 f"from when it served")
        rollbacks.append({"to": target.generation,
                          "as": hist._snapshot.generation,
                          "swap_ms": swap_ms})
    if len(rollbacks) != HISTORY:
        raise AssertionError(f"(c) {len(rollbacks)} rollbacks")
    if len(set(mem)) != 1:
        raise AssertionError(f"(c) device memory past a full history: "
                             f"{mem}")
    numbers["c"] = {"history_generations": history_gens,
                    "rollbacks": rollbacks, "memory_full": mem[0],
                    "memory_after": mem[1:],
                    "memory_growth": mem[-1] - mem[0],
                    "readback_docs": HISTORY_DOCS}
    log(f"[{card}] change safety (c): snapshot_history {HISTORY}, "
        f"{len(HISTORY_SWAPS)} one-config swaps; history "
        f"{history_gens}; {len(rollbacks)} rollbacks "
        f"{[(r['to'], r['as']) for r in rollbacks]} in "
        f"{[round(r['swap_ms'], 3) for r in rollbacks]} ms, each compiling "
        f"0 configs, uploading 0 B, launching no probe, its "
        f"{HISTORY_DOCS} readbacks byte-equal to that generation's; "
        f"device memory {mem[0]} B with the history full, "
        f"{mem[-1] - mem[0]:+d} B over {len(mem) - 1} further swaps")
    del hist
    numbers["phase_s"] = time.perf_counter() - t_phase
    report["change_safety"] = numbers
    log(f"[{card}] change safety: phase 18 in {numbers['phase_s']:.1f}s; "
        f"launches {launches}")
    return launches, max_err


TEN_CONFIGS = 96          # (a): wire-corpus tenants
TEN_CLASSES = ((8, "gold"), (8, "silver"), (16, "bronze"))  # the rest plain
TEN_REQUESTS = 4096       # (a): requests per path
TEN_BATCH, TEN_WINDOW = 64, 2   # (a): a queue deeper than max_batch stands
TEN_SHARE_CUTS = 16       # (a): contended cuts held to the DRR bound
TEN_HOT_EVERY = 9         # (b), (c): every 9th request on tenant 0
TEN_PASS_S = 3.5          # (b), (c): seconds per open-loop pass (ref: 10)
TEN_SLO_MS = 250.0        # the goodput SLO (the reference bench's)
TEN_BASE_SHARE = 0.6      # base rate over the closed-loop sustainable rate
TEN_RELEASE_WAIT_S = 8.0  # (b): the wait for containment's release
TEN_QUOTA_RPS = 50.0      # (d): the quota'd tenant's qos-quota-rps
TEN_PLANE_PAIRS = 1       # (e): plane on / off burst pairs
TEN_DUMP_INTERVAL_S = 30.0  # the flight recorder's own bundle rate limit


def _bundles_written(timeout_s: float = 30.0) -> None:
    """Wait (bounded) for flight bundles still being written on their
    threads: each is ~1-2 s of host work that would tax a timed pass."""
    import threading

    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline and any(
            t.name == "atpu-flight-dump" and t.is_alive()
            for t in threading.enumerate()):
        time.sleep(0.1)


def _ten_annotations(i: int):
    """Tenant i's annotations: the first 8 gold, then 8 silver, 16 bronze,
    the rest none."""
    lo = 0
    for n, cls in TEN_CLASSES:
        if lo <= i < lo + n:
            return {"authorino.tpu/qos-class": cls}
        lo += n
    return None


def _drr_deviation(cuts, weights, n: int) -> dict:
    """Over the first contended cuts in which every tenant was backlogged
    before and after the cut, each tenant's served rows against its
    weighted share ``K n w_t / W``.  A deficit round robin over a stable
    tenant ring serves tenant t ``w_t`` rows a round with a deficit carried
    below one row, and a cut ends mid-round, so it keeps every tenant
    within ``2 w_t + 2`` rows of that share: the bound held here.  Per
    weight class: rows served and rows due."""
    full = [c for c in cuts if c["all_backlogged"]][:TEN_SHARE_CUTS]
    W = sum(weights.values())
    served = {t: sum(c["taken"].get(t, 0) for c in full) for t in weights}
    due = {t: len(full) * n * w / W for t, w in weights.items()}
    dev = {t: served[t] - due[t] for t in weights}
    worst = max(dev, key=lambda t: abs(dev[t]) / (2 * weights[t] + 2))
    by_class = {}
    for t, w in weights.items():
        c = by_class.setdefault(w, {"tenants": 0, "served": 0, "due": 0.0})
        c["tenants"] += 1
        c["served"] += served[t]
        c["due"] += due[t]
    return {"cuts": len(full), "rows": sum(served.values()),
            "by_weight": by_class, "worst_tenant": worst,
            "worst_deviation_rows": dev[worst],
            "worst_bound_rows": 2 * weights[worst] + 2,
            "held": all(abs(dev[t]) <= 2 * w + 2
                        for t, w in weights.items())}


def _open_loop(engine, docs, names, rate: float, seconds: float,
               hot: str, burst: float, policy, sample_every: int = 97):
    # every 0.1 s: the hot tenant's served share and the queue wait the
    # containment detector reads
    """One open-loop pass against ``engine.submit`` at ``rate`` requests
    per second for ``seconds`` (the reference's ``run_engine_open_loop``):
    request j of the cycle goes to ``names[j]``; with ``burst`` > 1 the
    hot tenant's arrivals in the middle third are multiplied by it.  Per
    class (hot, cold): offered, done, rejected, in-SLO goodput on the
    intended-arrival clock, submit-clock p50/p99; rejections by code and
    scope; every ``sample_every``-th answer held to the host oracle."""
    import numpy as np

    from authorino_tpu_torch.models.policy_model import host_results
    from authorino_tpu_torch.utils.rpc import CheckAbort

    n_docs = len(docs)
    offsets = [k / rate for k in range(int(rate * seconds))]
    js = [k % n_docs for k in range(len(offsets))]
    if burst > 1.0:
        t_lo, t_hi = seconds / 3.0, 2.0 * seconds / 3.0
        hot_js = [j for j in range(n_docs) if names[j] == hot]
        base_mid = sum(1 for o, j in zip(offsets, js)
                       if t_lo <= o < t_hi and names[j] == hot)
        extra = int(base_mid * (burst - 1.0))
        merged = sorted(list(zip(offsets, js)) + [
            (t_lo + (t_hi - t_lo) * (k + 0.5) / extra,
             hot_js[k % len(hot_js)]) for k in range(extra)])
        offsets, js = [o for o, _ in merged], [j for _, j in merged]
    split = {c: {"offered": 0, "done": 0, "rejected": 0, "lat": [],
                 "lat_sub": []} for c in ("hot", "cold")}
    codes, scope = {}, {"tenant-scoped": 0, "global-overload": 0,
                        "other": 0}
    exact = {"checked": 0, "mismatches": 0}
    raw = [0]
    slo_s = TEN_SLO_MS / 1e3

    async def one(j, intended, seq):
        cls = "hot" if names[j] == hot else "cold"
        split[cls]["offered"] += 1
        t_sub = time.perf_counter()
        try:
            rule, skipped = await engine.submit(docs[j], names[j])
        except CheckAbort as e:
            codes[e.code] = codes.get(e.code, 0) + 1
            msg = str(e.message)
            scope["tenant-scoped" if "tenant " in msg else
                  "global-overload" if "overloaded" in msg
                  else "other"] += 1
            split[cls]["rejected"] += 1
            return
        except Exception:
            raw[0] += 1
            return
        now = time.perf_counter()
        split[cls]["done"] += 1
        split[cls]["lat"].append(now - intended)
        split[cls]["lat_sub"].append(now - t_sub)
        if seq % sample_every == 0:
            own, _, w_skip = host_results(policy, docs[j],
                                          policy.config_ids[names[j]])
            exact["checked"] += 1
            exact["mismatches"] += int(
                bool(np.all(skipped | rule)) != own
                or skipped.tolist() != w_skip.tolist())

    signals = {"hot_share_max": 0.0, "wait_ewma_max_s": 0.0,
               "depth_max": 0}

    async def sample(stop):
        while not stop.is_set():
            signals["hot_share_max"] = max(signals["hot_share_max"],
                                           engine.tenancy.stats.share(hot))
            signals["wait_ewma_max_s"] = max(signals["wait_ewma_max_s"],
                                             engine.admission.wait_ewma)
            signals["depth_max"] = max(signals["depth_max"],
                                       len(engine._queue))
            await asyncio.sleep(0.1)

    async def run():
        tasks = set()
        stop = asyncio.Event()
        sampler = asyncio.ensure_future(sample(stop))
        t0 = time.perf_counter()
        for seq, (off, j) in enumerate(zip(offsets, js)):
            target = t0 + off
            wait = target - time.perf_counter()
            if wait > 0:
                await asyncio.sleep(wait)
            t = asyncio.ensure_future(one(j, target, seq))
            tasks.add(t)
            t.add_done_callback(tasks.discard)
        if tasks:
            await asyncio.gather(*tasks)
        stop.set()
        await sampler
        return time.perf_counter() - t0

    elapsed = asyncio.run(run())
    out = {"offered_rps": len(offsets) / seconds, "signals": signals,
           "achieved_rps": sum(s["done"] for s in split.values()) / elapsed,
           "elapsed_s": elapsed, "rejected": codes, "scope": scope,
           "raw_exceptions": raw[0], "exact": exact}
    for cls, s in split.items():
        lat, sub = sorted(s["lat"]), sorted(s["lat_sub"])
        out[cls] = {
            "offered": s["offered"], "done": s["done"],
            "rejected": s["rejected"],
            "goodput_rps_in_slo": sum(1 for v in lat if v <= slo_s) / elapsed,
            "p50_ms": (float(np.percentile(sub, 50)) * 1e3 if sub else None),
            "p99_ms": (float(np.percentile(sub, 99)) * 1e3 if sub else None)}
    return out


def _closed_loop_rps(engine, docs, names, n: int = 1024) -> float:
    """Requests per second of ``n`` submits at once (the closed loop),
    admission's queue floor lifted for it."""
    async def go():
        t = time.perf_counter()
        await asyncio.gather(*(engine.submit(docs[j % len(docs)],
                                             names[j % len(docs)])
                               for j in range(n)))
        return n / (time.perf_counter() - t)

    floor = engine.admission.min_cap
    engine.admission.min_cap = 1 << 20
    try:
        return asyncio.run(go())
    finally:
        engine.admission.min_cap = floor


def tenancy(report: dict, card: str, dev, ctx6: dict, ns: dict) -> tuple:
    """Phase 19: the tenant QoS plane on the card.  (a) exactness under a
    contended cut: 96 wire-corpus tenants (8 gold, 8 silver, 16 bronze by
    annotation, 64 plain), max_batch 64 with two batches in flight, 4,096
    requests at once through ``submit``, then ``check()``, then the native
    frontend; every verdict and attribution equal to a CPU engine's (the
    plain version of the kernel) and the oracle's, the fair cut's shares
    within the deficit round robin's bound, each tenant's requests and
    denies in the plane equal to what was sent and denied, on both lanes.
    (b) the reference's acceptance regime (``bench.py``
    ``run_tenancy_mode``): the 1,000-config north-star corpus, the
    slow-device fault profile, max_batch 16, dedup and the cache off,
    every 9th request on tenant 0, a base at 0.6x the closed-loop rate;
    a pass without a burst, then one with tenant 0 at x10 mid-window
    (x20, x40 while containment has not fired); the cold tenants' goodput
    and p99 ratios against the reference's bounds, the rejections' types
    and scope, containment's fire and release and its flight bundle, the
    contained parts' launches, sampled verdicts.  (c) the same with no
    fault, at the card's own rate: reported only.  (d) a quota'd tenant
    over its quota answers RESOURCE_EXHAUSTED naming it, the others
    untouched; a canaried change whose canary-cohort requests meet the
    emptied bucket breaches ``tenant-rejection-rate`` and rolls back.
    (e) phase 6's burst with the plane on and off, and device memory
    across the phase.  Returns (the kernels' launches on (a)'s path,
    counts zeroed just before it; the max abs byte error of the
    comparisons)."""
    import numpy as np

    from authorino_tpu_torch.authjson import build_authorization_json
    from authorino_tpu_torch.models import northstar
    from authorino_tpu_torch.models import wire_corpus as wc
    from authorino_tpu_torch.models.policy_model import host_results
    from authorino_tpu_torch.ops import fused_kernel as fk
    from authorino_tpu_torch.protos import wire
    from authorino_tpu_torch.protos.ext_authz import request_model_from_proto
    from authorino_tpu_torch.runtime import EngineEntry, PolicyEngine
    from authorino_tpu_torch.runtime import faults
    from authorino_tpu_torch.runtime.admission import OVERLOADED
    from authorino_tpu_torch.runtime.change_safety import (GuardThresholds,
                                                           in_canary_cohort)
    from authorino_tpu_torch.runtime.flight_recorder import RECORDER
    from authorino_tpu_torch.runtime.native_frontend import NativeFrontend
    from authorino_tpu_torch.utils import rpc

    t_phase = time.perf_counter()
    numbers = {"card": card}
    max_err = 0
    mem0 = device_allocated(dev)

    # ---- (a) exactness under a contended cut ------------------------------
    t_a = time.perf_counter()
    payloads = wc.wire_payloads(TEN_REQUESTS, TEN_CONFIGS)
    models = [request_model_from_proto(wire.decode_check_request(p))
              for p in payloads]
    docs = [build_authorization_json(m, {}) for m in models]
    names = [f"ns/cfg-{int(m.http.host.split('.')[0].split('-')[1])}"
             for m in models]
    oracle = [wc.expected_allow(p, WIRE_RULES) for p in payloads]

    def wire_engine(device, **kw):
        eng = PolicyEngine(max_batch=TEN_BATCH, device=device,
                           max_inflight_batches=TEN_WINDOW,
                           adaptive_window=False, **NO_REUSE,
                           **WIDE_ADMISSION, **kw)
        entries = wc.build_wire_entries(TEN_CONFIGS, WIRE_RULES, eng)
        for i, e in enumerate(entries):
            e.annotations = _ten_annotations(i)
        eng.apply_snapshot(entries)
        return eng

    fk.reset_counts()
    reset_host_counts()
    engine = wire_engine(dev)
    plain = wire_engine("cpu")
    weights = {f"ns/cfg-{i}": engine.tenancy.book.weight(f"ns/cfg-{i}")
               for i in range(TEN_CONFIGS)}
    if sorted(set(weights.values())) != [1.0, 2.0, 4.0]:
        raise AssertionError(f"(19a) the weight book: {set(weights.values())}")
    cuts = []
    real_cut = engine.tenancy.cut

    def spy(queue, n):
        before = {}
        for p in queue:
            before[p.config_name] = before.get(p.config_name, 0) + 1
        batch = real_cut(queue, n)
        taken = {}
        for p in batch:
            taken[p.config_name] = taken.get(p.config_name, 0) + 1
        cuts.append({"taken": taken, "all_backlogged": len(before) ==
                     TEN_CONFIGS and all(before[t] > taken.get(t, 0)
                                         for t in before)})
        return batch

    engine.tenancy.cut = spy

    async def submits(eng):
        return await asyncio.gather(*(eng.submit(d, n)
                                      for d, n in zip(docs, names)))

    got = asyncio.run(submits(engine))
    engine.tenancy.cut = real_cut
    want = asyncio.run(submits(plain))
    diff = sum(1 for (r1, s1), (r2, s2) in zip(got, want)
               if r1.tolist() != r2.tolist() or s1.tolist() != s2.tolist())
    bad = sum(1 for (r, s), o in zip(got, oracle)
              if bool(np.all(s | r)) != o)
    share = _drr_deviation(cuts, weights, TEN_BATCH)
    if diff or bad:
        raise AssertionError(f"(19a) submit: {diff} columns differ from the "
                             f"plain version, {bad} verdicts from the oracle")
    if share["cuts"] < 4:
        raise AssertionError(f"(19a) too few contended cuts: {share}")

    def plane_counts(eng):
        top = eng.tenancy.stats.to_json(top=TEN_CONFIGS + 8)["top"]
        return {r["tenant"]: (r["requests"], r["denies"]) for r in top}

    def sent_counts(allowed_list):
        out = {}
        for n, a in zip(names, allowed_list):
            r, d = out.get(n, (0, 0))
            out[n] = (r + 1, d + int(not a))
        return out

    def delta(after, before):
        return {t: (after.get(t, (0, 0))[0] - before.get(t, (0, 0))[0],
                    after.get(t, (0, 0))[1] - before.get(t, (0, 0))[1])
                for t in set(after) | set(before)
                if after.get(t) != before.get(t)}

    want_counts = sent_counts(oracle)
    c1 = plane_counts(engine)
    if c1 != want_counts:
        raise AssertionError(f"(19a) submit: the plane's counts "
                             f"{len(c1)} tenants differ from the sent")

    async def checks(eng):
        return await asyncio.gather(*(eng.check(m) for m in models))

    got_c = asyncio.run(checks(engine))
    want_c = asyncio.run(checks(plain))
    diff_c = sum(1 for a, b in zip(got_c, want_c)
                 if (a.code, a.message, a.metadata) !=
                 (b.code, b.message, b.metadata))
    bad_c = sum(1 for a, o in zip(got_c, oracle)
                if (a.code == rpc.OK) != o)
    c2 = plane_counts(engine)
    if diff_c or bad_c or delta(c2, c1) != want_counts:
        raise AssertionError(f"(19a) check(): {diff_c} results differ from "
                             f"the plain version's, {bad_c} from the "
                             f"oracle, plane counts "
                             f"{delta(c2, c1) == want_counts}")
    fe = NativeFrontend(engine, port=0, max_batch=256, window_us=500,
                        verdict_cache_size=0, batch_dedup=False)
    aio = AioLoop()
    try:
        fe_port = fe.start()
        if not fe.wait_warm(120):
            raise AssertionError("(19a) the native frontend did not warm")
        st0 = fe.stats()
        raws = grpc_many(aio, fe_port, payloads)
        st1 = fe.stats()
        fast = st1.get("fast", 0) - st0.get("fast", 0)
        slow = st1.get("slow", 0) - st0.get("slow", 0)
        fe_vars = fe.debug_vars()
    finally:
        fe.stop()
        aio.close()
    fe_codes = [wire.decode_check_response(r).status.code
                if isinstance(r, bytes) else repr(r) for r in raws]
    bad_fe = sum(1 for c, o in zip(fe_codes, oracle)
                 if c != (rpc.OK if o else rpc.PERMISSION_DENIED))
    c3 = plane_counts(engine)
    if bad_fe or delta(c3, c2) != want_counts or not fast:
        raise AssertionError(f"(19a) native frontend: {bad_fe} codes differ "
                             f"from the oracle, {fast} fast, plane counts "
                             f"{delta(c3, c2) == want_counts}")
    if fe_vars["tenancy"]["stats"]["requests_total"] != 3 * TEN_REQUESTS:
        raise AssertionError("(19a) the frontend's tenancy view")
    launches = {"fused_megakernel": fk.launches,
                "probe_add_one": fk.probe_launches}
    numbers["a"] = {
        "tenants": TEN_CONFIGS, "requests_per_path": TEN_REQUESTS,
        "contended_cuts": engine.tenancy.cutter.contended_cuts,
        "share": share, "verdict_differences": diff + diff_c + bad_fe,
        "allowed": sum(oracle), "fast_lane": fast, "slow_lane": slow,
        "launches": launches, "seconds": time.perf_counter() - t_a}
    log(f"[{card}] tenancy (a): {TEN_CONFIGS} tenants (weights 4/2/1 by "
        f"annotation), {TEN_REQUESTS} requests through submit, check() and "
        f"the native frontend ({fast} fast lane, {slow} slow): 0 verdict "
        f"or attribution "
        f"differences from the plain version and the oracle; "
        f"{engine.tenancy.cutter.contended_cuts} contended cuts, over "
        f"{share['cuts']} with every tenant backlogged rows served / due by "
        f"weight { {w: (c['served'], round(c['due'], 1)) for w, c in share['by_weight'].items()} }, "
        f"the worst deviation {share['worst_deviation_rows']:+.2f} rows "
        f"({share['worst_tenant']}, DRR bound +-{share['worst_bound_rows']}:"
        f" {'held' if share['held'] else 'NOT held'}); "
        f"each tenant's requests and denies in the plane equal to the sent "
        f"on both lanes; {launches['fused_megakernel']} launches, "
        f"{launches['probe_add_one']} probe")
    del plain

    # ---- (b) the acceptance regime ----------------------------------------
    t_b = time.perf_counter()
    ns_cfgs = northstar.build_corpus(1000, 10)
    ns_docs = ns["docs"]
    rng = random.Random(3)
    rows = [rng.randrange(1000) for _ in ns_docs]
    # every 9th request on tenant 0: a deterministic ~11% share
    for j in range(0, len(rows), TEN_HOT_EVERY):
        rows[j] = 0
    b_names = [f"cfg-{r}" for r in rows]
    hot = "cfg-0"
    eng_b = PolicyEngine(max_batch=16, device=dev, max_inflight_batches=8,
                         verdict_cache_size=0, batch_dedup=False)
    eng_b.apply_snapshot([EngineEntry(id=c.name, hosts=[c.name], rules=c)
                          for c in ns_cfgs])
    policy_b = eng_b._snapshot.policy
    mem_b = device_allocated(dev)
    flight0 = (RECORDER.dump_dir, RECORDER.min_dump_interval_s)
    RECORDER.configure(dump_dir=str(Path("smoke_out") / "flight-19"),
                       min_dump_interval_s=TEN_DUMP_INTERVAL_S)
    overloads = [0]
    real_state = eng_b.admission._set_state

    def counting_state(state):
        if state is OVERLOADED and eng_b.admission._state is not OVERLOADED:
            overloads[0] += 1
        real_state(state)

    eng_b.admission._set_state = counting_state
    det = eng_b.tenancy.detector

    def regime(label: str, burst0: float, acceptance: bool) -> dict:
        """One regime: the closed loop, a pass with no burst, then tenant
        0's burst.  ``acceptance`` runs the reference's acceptance regime
        around it: a bundle at every anomaly, the burst escalated while
        containment has not fired, the idle decay, then the burst once
        more with no bundle written."""
        # from a known state: nobody contained, no pacing
        det.reset()
        closed = _closed_loop_rps(eng_b, ns_docs, b_names)
        eng_b.admission.target_s = 0.05
        eng_b.admission.min_cap = 64
        base = TEN_BASE_SHARE * closed
        det.reset()
        n_rec = len(eng_b.batch_records)
        st0 = dict(eng_b.stats)
        baseline = _open_loop(eng_b, ns_docs, b_names, base, TEN_PASS_S,
                              hot, 1.0, policy_b)
        contain0 = det.contain_total
        over0 = overloads[0]
        dumps0 = len(RECORDER.dumps)
        burst, measured, passes = burst0, None, []
        if acceptance:
            # the reference's bench writes a bundle at every anomaly of
            # the measured pass
            RECORDER.configure(min_dump_interval_s=0.0)
        for _ in range(3):
            det.reset()
            measured = _open_loop(eng_b, ns_docs, b_names, base, TEN_PASS_S,
                                  hot, burst, policy_b)
            passes.append({"burst": burst, "contained": det.contain_total
                           - contain0, "hot": measured["hot"],
                           "cold_p99_ms": measured["cold"]["p99_ms"],
                           "scope": measured["scope"],
                           "signals": measured["signals"]})
            log(f"tenancy ({label}) pass x{burst:g}: {passes[-1]}")
            if not acceptance or det.contain_total > contain0 or \
                    burst >= 40.0:
                break
            burst *= 2.0
        fired = det.contain_total - contain0

        def ratio(a, b):
            return a / b if a is not None and b else None

        # from here the recorder's own rate limit
        RECORDER.configure(min_dump_interval_s=TEN_DUMP_INTERVAL_S)
        # the decay, as the reference's bench drains it: the detector
        # checked every 0.2 s with no new traffic, until it releases
        release0 = det.release_total
        t0_rel = time.monotonic()
        t_release = None
        while acceptance and time.monotonic() - t0_rel < \
                TEN_RELEASE_WAIT_S and det.has_contained():
            time.sleep(0.2)
            det.check()
        released = det.release_total - release0
        if fired and not det.has_contained():
            t_release = time.monotonic() - t0_rel
        again = None
        if acceptance:
            # the same burst once more: its anomalies write no bundle (one
            # was just written), so this pass shows the plane without a
            # bundle's host work beside it
            _bundles_written()
            det.reset()
            rp = _open_loop(eng_b, ns_docs, b_names, base, TEN_PASS_S, hot,
                            burst, policy_b)
            again = {"cold_goodput_ratio": ratio(
                rp["cold"]["goodput_rps_in_slo"],
                baseline["cold"]["goodput_rps_in_slo"]),
                "cold_p99_ratio": ratio(rp["cold"]["p99_ms"],
                                        baseline["cold"]["p99_ms"]),
                "contained": det.contain_total - contain0 - fired,
                "hot": rp["hot"], "scope": rp["scope"],
                "signals": rp["signals"]}
            log(f"tenancy ({label}) repeat x{burst:g}, no bundle: {again}")
        wait_idle(eng_b)
        recs = list(eng_b.batch_records)[n_rec:]
        contained = [r for r in recs if r.get("contained")]
        cm, cb = measured["cold"], baseline["cold"]

        return {
            "label": label, "closed_loop_rps": closed, "base_rps": base,
            "burst": burst, "baseline": baseline, "measured": measured,
            "passes": passes, "repeat": again,
            "decay_s_to_release": t_release,
            "cold_goodput_ratio": ratio(cm["goodput_rps_in_slo"],
                                        cb["goodput_rps_in_slo"]),
            "cold_p99_ratio": ratio(cm["p99_ms"], cb["p99_ms"]),
            "contained_fired": fired,
            "released": released,
            "still_contained": sorted(det.contained()),
            "global_overloaded_entries": overloads[0] - over0,
            "contained_parts": eng_b.stats["contained_parts"]
            - st0["contained_parts"],
            "contained_rows": eng_b.stats["contained_rows"]
            - st0["contained_rows"],
            "contained_part_launches": sum(r["launches"] for r in contained),
            "contained_bundles": [p for p in RECORDER.dumps[dumps0:]
                                  if "tenant-contained" in p],
            "rejections_typed": all(c == rpc.RESOURCE_EXHAUSTED for c in
                                    measured["rejected"])
            and measured["raw_exceptions"] == 0,
            "rejections_tenant_scoped": measured["scope"]["global-overload"]
            == 0 and measured["scope"]["other"] == 0,
            "exact": [baseline["exact"], measured["exact"]],
        }

    def report_regime(part: str, r: dict) -> None:
        m = r["measured"]
        log(f"[{card}] tenancy ({part}, {r['label']}): "
            f"closed loop {r['closed_loop_rps']:.0f} rps, base "
            f"{r['base_rps']:.0f} rps, tenant 0 x{r['burst']:g} mid-window; "
            f"cold goodput ratio {r['cold_goodput_ratio']} (bound >= 0.9), "
            f"cold p99 ratio {r['cold_p99_ratio']} (bound <= 1.5; baseline "
            f"{r['baseline']['cold']['p99_ms']} ms, burst "
            f"{m['cold']['p99_ms']} ms); hot {m['hot']['done']} done "
            f"{m['hot']['rejected']} rejected of {m['hot']['offered']}; "
            f"rejections {m['rejected']} scope {m['scope']} (baseline "
            f"{r['baseline']['rejected']}); containment fired "
            f"{r['contained_fired']}, released {r['released']} ("
            f"{r['decay_s_to_release']} s into the idle decay), global "
            f"OVERLOADED entries {r['global_overloaded_entries']}, "
            f"tenant-contained bundles {len(r['contained_bundles'])}; "
            f"contained parts {r['contained_parts']} "
            f"({r['contained_rows']} rows, {r['contained_part_launches']} "
            f"launches); sampled verdicts "
            f"{[e['checked'] for e in r['exact']]} exact")
        if any(e["mismatches"] for e in r["exact"]):
            raise AssertionError(f"(19{part}) sampled verdicts: "
                                 f"{r['exact']}")
        if not r["rejections_typed"]:
            raise AssertionError(f"(19{part}) an untyped rejection "
                                 f"{m['rejected']}")

    # no earlier phase's bundle being written into the timed passes
    _bundles_written()
    try:
        faults.FAULTS.arm("kernel:delay:delay=0.05")
        try:
            b = regime("slow-device", 10.0, acceptance=True)
        finally:
            faults.FAULTS.disarm()
        report_regime("b", b)
        c = regime("no fault", 10.0, acceptance=False)
        report_regime("c", c)
    finally:
        RECORDER.configure(dump_dir=flight0[0],
                           min_dump_interval_s=flight0[1])
    b["held"] = {
        "cold_goodput_ratio>=0.9": (b["cold_goodput_ratio"] or 0) >= 0.9,
        "cold_p99_ratio<=1.5": (b["cold_p99_ratio"] or 1e9) <= 1.5,
        "tenant_scoped_only": b["rejections_tenant_scoped"]
        and b["global_overloaded_entries"] == 0,
        "contained_and_released": b["contained_fired"] >= 1
        and b["released"] >= 1,
        "flight_bundle": bool(b["contained_bundles"]),
    }
    if b["repeat"] is not None:
        b["held_repeat"] = {
            "cold_goodput_ratio>=0.9":
                (b["repeat"]["cold_goodput_ratio"] or 0) >= 0.9,
            "cold_p99_ratio<=1.5":
                (b["repeat"]["cold_p99_ratio"] or 1e9) <= 1.5,
            "tenant_scoped_only":
                b["repeat"]["scope"]["global-overload"] == 0}
    numbers["b"], numbers["c"] = b, c
    numbers["b"]["seconds_with_c"] = time.perf_counter() - t_b
    log(f"tenancy (b) against the reference's bounds: {b['held']}; the "
        f"repeat pass with no bundle written: {b.get('held_repeat')}")

    # the device's share of a batch, (c)'s regime: the stage histograms
    # over one more no-fault pass at the base rate
    s0 = stage_histograms()
    _open_loop(eng_b, ns_docs, b_names, c["base_rps"], 2.0, hot, 1.0,
               policy_b)
    wait_idle(eng_b)
    c["engine_memory_growth_bytes"] = device_allocated(dev) - mem_b
    split = stage_split(s0, stage_histograms())
    tot = sum(v["mean_ms"] * v["batches"] for v in split.values())
    c["device_share_of_batch"] = (split["device"]["mean_ms"]
                                  * split["device"]["batches"] / tot
                                  if tot else None)
    c["stages"] = split
    log(f"[{card}] tenancy (c): the device stage's share of a batch's "
        f"stages {c['device_share_of_batch']} "
        f"({ {k: round(v['mean_ms'], 4) for k, v in split.items()} } ms "
        f"mean per batch)")
    del eng_b

    # ---- (d) quota and the per-tenant canary guard ------------------------
    t_d = time.perf_counter()
    quota_id = "cfg-1"
    d_cfgs = northstar.build_corpus(64, 10)
    eng_d = PolicyEngine(max_batch=64, device=dev, canary_fraction=0.5,
                         canary_window_s=60.0,
                         canary_thresholds=GuardThresholds(),
                         **NO_REUSE)

    def d_entries(cfgs):
        return [EngineEntry(id=x.name, hosts=[x.name], rules=x,
                            annotations=({"authorino.tpu/qos-quota-rps":
                                          str(TEN_QUOTA_RPS)}
                                         if x.name == quota_id else None))
                for x in cfgs]

    eng_d.apply_snapshot(d_entries(d_cfgs))
    pol_d = eng_d._snapshot.policy
    d_docs = northstar.build_docs(2048, seed=9, cohort_entropy=True)
    d_names = [quota_id if k % 2 == 0 else f"cfg-{2 + k % 62}"
               for k in range(len(d_docs))]

    async def d_burst(pairs):
        async def one(d, n):
            try:
                return n, await eng_d.submit(d, n)
            except rpc.CheckAbort as e:
                return n, (e.code, e.message)

        return await asyncio.gather(*(one(d, n) for d, n in pairs))

    out = asyncio.run(d_burst(list(zip(d_docs[:800], d_names[:800]))))
    q_rej = [v for n, v in out if n == quota_id and isinstance(v[0], int)]
    others_bad = 0
    for (n, v), d in zip(out, d_docs[:800]):
        if n == quota_id:
            continue
        if isinstance(v[0], int):
            others_bad += 1
            continue
        own, _, w_skip = host_results(pol_d, d, pol_d.config_ids[n])
        others_bad += int(bool(np.all(v[1] | v[0])) != own
                          or v[1].tolist() != w_skip.tolist())
    want_msg = (f"tenant {quota_id} over its QoS budget (tenant-quota): "
                "admission rejected")
    if not q_rej or any(r != (rpc.RESOURCE_EXHAUSTED, want_msg)
                        for r in q_rej) or others_bad:
        raise AssertionError(f"(19d) quota: {len(q_rej)} rejections "
                             f"{set(q_rej)}, others {others_bad} wrong")
    rej_by = dict(eng_d.tenancy.admission.rejected)
    if set(rej_by) != {quota_id}:
        raise AssertionError(f"(19d) rejections off the quota'd tenant: "
                             f"{rej_by}")
    # a canaried change of the quota'd tenant's rule; its baseline-cohort
    # requests arrive first, then its canary-cohort requests meet the
    # bucket they emptied
    eng_d.apply_snapshot(d_entries(northstar.build_corpus(
        64, 10, changed={1: "const"})))
    phase = eng_d._canary
    if phase is None:
        raise AssertionError("(19d) the change did not canary")
    phase.guard.check_interval_s = 0.0
    cohort = [in_canary_cohort(d, 0.5) for d in d_docs]
    base_docs = [d for d, c in zip(d_docs, cohort) if not c][:40]
    can_docs = [d for d, c in zip(d_docs, cohort) if c][:120]
    time.sleep(1.0)   # the bucket refills
    outs = asyncio.run(d_burst([(d, quota_id) for d in base_docs]))
    outs += asyncio.run(d_burst([(d, quota_id) for d in can_docs]))
    t_end = time.monotonic() + 10
    while eng_d._canary is not None and time.monotonic() < t_end:
        time.sleep(0.01)
    rb = eng_d._last_rollback or {}
    guards = ((rb.get("detail") or {}).get("guards") or [])
    numbers["d"] = {
        "quota_rps": TEN_QUOTA_RPS, "quota_rejections": len(q_rej),
        "quota_admitted": sum(1 for n, v in out if n == quota_id
                              and not isinstance(v[0], int)),
        "others_admitted_exact": sum(1 for n, _ in out if n != quota_id),
        "canary_rejections": sum(1 for _, v in outs
                                 if isinstance(v[0], int)),
        "rollback": rb.get("reason"), "guards": guards,
        "quarantined": rb.get("quarantined"),
        "seconds": time.perf_counter() - t_d}
    if rb.get("reason") != "guard-breach" or \
            "tenant-rejection-rate" not in guards:
        raise AssertionError(f"(19d) the tenant guard: {numbers['d']}")
    log(f"[{card}] tenancy (d): {quota_id} at {TEN_QUOTA_RPS:g} rps: "
        f"{numbers['d']['quota_admitted']} admitted, {len(q_rej)} answered "
        f"RESOURCE_EXHAUSTED naming it; the other tenants' "
        f"{numbers['d']['others_admitted_exact']} admitted, every verdict "
        f"the oracle's; a canaried change of its rule with its canary "
        f"cohort past the bucket: {numbers['d']['canary_rejections']} "
        f"rejections, guards {guards}, rolled back ({rb.get('reason')}), "
        f"quarantined {rb.get('quarantined')}")
    del eng_d

    # ---- (e) the plane's cost on phase 6's request path --------------------
    eng6, reqs6 = ctx6["engine"], ctx6["reqs"]
    wait_idle(eng6)
    _bundles_written()
    m6 = device_allocated(dev)
    rates = {True: [], False: []}
    asyncio.run(timed_checks(eng6, reqs6))   # untimed: a warm start
    wait_idle(eng6)
    # on, off, off, on, on, off: each side first in turn
    for on in [k % 2 == (k // 2) % 2 for k in range(2 * TEN_PLANE_PAIRS)]:
        eng6.tenancy.enabled = on
        t = time.perf_counter()
        asyncio.run(timed_checks(eng6, reqs6))
        rates[on].append(len(reqs6) / (time.perf_counter() - t))
        wait_idle(eng6)
    eng6.tenancy.enabled = True
    m6_growth = device_allocated(dev) - m6
    numbers["e"] = {
        "checks_per_s_on": rates[True], "checks_per_s_off": rates[False],
        "on_median": statistics.median(rates[True]),
        "off_median": statistics.median(rates[False]),
        "phase6_engine_memory_growth_bytes": m6_growth}
    del engine
    mem_growth = device_allocated(dev) - mem0
    numbers["memory_growth_bytes"] = mem_growth
    numbers["phase_s"] = time.perf_counter() - t_phase
    log(f"[{card}] tenancy (e): phase 6's burst {numbers['e']['on_median']:.0f}"
        f" checks/s with the plane on ({[round(r) for r in rates[True]]}), "
        f"{numbers['e']['off_median']:.0f} off "
        f"({[round(r) for r in rates[False]]}); device memory over the "
        f"bursts {m6_growth:+d} B, over (b)-(c)'s passes on their engine "
        f"{c['engine_memory_growth_bytes']:+d} B, over the phase (its "
        f"engines dropped) {mem_growth:+d} B; phase 19 took "
        f"{numbers['phase_s']:.1f}s")
    report["tenancy"] = numbers
    return launches, max_err


# ---------------------------------------------------------------------------
# phase 20: the metadata prefetch cache, capture and the replay pregate,
# strict verify
# ---------------------------------------------------------------------------

P20_CONFIGS = 1000        # phase 6's north-star AuthConfigs
P20_BLOCKED_EVERY = 7     # (a): every 7th config's pinned document blocks
P20_HOT = 512             # (b): requests to the hot host, sent first
P20_OFF_CHECKS = 512      # (a): the prefetch-off pass's checks (a live GET each)
P20_BUDGET_MS = 2000.0    # (c): the pregate's replay budget
P20_EXACT = 512           # (c), (d): records replayed through submit()


def _flags_server():
    """A local HTTP server of one request-independent metadata document
    per config (``/flags/<i>``), counting GETs by path.  Returns (server,
    thread, counts)."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    counts: dict = {}
    lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            i = int(self.path.rsplit("/", 1)[-1])
            with lock:
                counts[i] = counts.get(i, 0) + 1
            body = json.dumps({"tier": "blocked" if i % P20_BLOCKED_EVERY == 0
                               else "gold", "config": i}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    srv.daemon_threads = True
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, t, counts


def _rules_only(entries):
    """The entries' compiled rules with no runtime: an engine of its own
    can install them (no evaluator bound to another engine)."""
    from authorino_tpu_torch.runtime import EngineEntry

    return [EngineEntry(id=e.id, hosts=list(e.hosts), runtime=None,
                        rules=e.rules) for e in entries if e.rules is not None]


def _settled(rec: dict) -> dict:
    """A capture record without its doc's auth.authorization subtree (the
    pipeline writes it after the verdict, racing the capture's encode)."""
    doc = dict(rec.get("doc") or {})
    doc["auth"] = {k: v for k, v in (doc.get("auth") or {}).items()
                   if k != "authorization"}
    return dict(rec, doc=doc)


def _exact_submits(engine, records, label: str) -> int:
    """Replay ``records`` through ``engine.submit`` at once; every verdict
    and skipped column must equal the host oracle of the serving snapshot.
    Returns how many were allowed."""
    import numpy as np

    from authorino_tpu_torch.models.policy_model import host_results

    async def go():
        return await asyncio.gather(*(engine.submit(r["doc"], r["authconfig"])
                                      for r in records))

    out = asyncio.run(go())
    snap = engine._snapshot
    allowed = 0
    for (rule, skipped), r in zip(out, records):
        own, _, w_skip = host_results(
            snap.policy, r["doc"], snap.policy.config_ids[r["authconfig"]])
        if bool(np.all(skipped | rule)) != own or \
                skipped.tolist() != w_skip.tolist():
            raise AssertionError(f"{label}: {r['authconfig']} answered "
                                 f"{rule}/{skipped}, oracle {own}")
        allowed += own
    return allowed


def verify_and_replay(report: dict, card: str, dev, ctx6: dict) -> tuple:
    """Phase 20: the metadata prefetch cache, traffic capture with the
    replay pregate, and strict verify, on the card at phase 6's width.
    (a) phase 6's 1,000 AuthConfigs, each with one request-independent
    ``http`` metadata document from a local server (every 7th blocks) and
    an authorization rule on a field of it: 4,096 ``check()``s with
    prefetch on and with it off, every code the oracle's, the server's GETs
    counted (one per pinned document per refresh, none per request, with
    prefetch on; one per request with it off).  (b) capture at 1-in-1 on
    phase 6's engine over a hot host's 512 requests and phase 6's 4,096:
    each captured firing column (the kernel's readback) equal to the host
    oracle's, a replay of the ring old against old with 0 flips, the
    segments flushed and read back equal; checks/s with capture on and
    off.  (c) an engine of the same rules with the replay pregate and a
    canary: a poison on the hot config is rejected before its canary
    (SnapshotRejected, a replay-pregate-breach event, generation and
    device memory unchanged, no launch), a burst after it exact against
    the old oracle, a clean churn canaried under halved deny thresholds.
    (d) strict verify: the install's validate phase and counts (1,001
    validated, then 1 and 1,000 cache hits after one change); three
    planted mutants (a DFA transition, ``dfa_row_perm``, ``fused_pack_w``)
    each rejected with +0 B on the card, no launch, the old snapshot still
    exact; the mutation self-tests green.  (e) the CLI with
    ``--capture --replay-pregate --strict-verify``: ``/debug/replay`` and
    ``/debug/vars``.  Returns (the kernels' launches on (a) and (b), counts
    zeroed just before (a); 0, the byte error of the comparisons here, all
    on verdicts)."""
    import os
    import shutil
    import signal
    import tempfile

    import numpy as np

    from authorino_tpu_torch.analysis import translation_validate as tv
    from authorino_tpu_torch.authjson import build_authorization_json
    from authorino_tpu_torch.compiler import ConfigRules
    from authorino_tpu_torch.controllers import translate_auth_config
    from authorino_tpu_torch.expressions import Operator, Pattern
    from authorino_tpu_torch.models import control_plane as cp
    from authorino_tpu_torch.models import northstar
    from authorino_tpu_torch.models.policy_model import host_results
    from authorino_tpu_torch.ops import fused_kernel as fk
    from authorino_tpu_torch.ops.operands import firing_columns
    from authorino_tpu_torch.replay.capture import (CAPTURE, encode_record,
                                                    read_capture)
    from authorino_tpu_torch.replay.replay import replay_records
    from authorino_tpu_torch.runtime import PolicyEngine
    from authorino_tpu_torch.runtime.engine import SnapshotRejected
    from authorino_tpu_torch.runtime.flight_recorder import RECORDER
    from authorino_tpu_torch.snapshots import compile_cache as cc
    from authorino_tpu_torch.utils import rpc

    numbers = {"card": card}
    # (e)'s process starts now, over its manifests: its start-up overlaps
    # (a)-(d)
    e_ports = [free_port() for _ in range(3)]
    e_tmp = entry_manifests()
    e_server = ServerStart(
        [sys.executable, "-m", "authorino_tpu_torch", "server",
         "--watch-dir", e_tmp, "--ext-auth-grpc-port", str(e_ports[0]),
         "--ext-auth-http-port", str(e_ports[1]), "--oidc-http-port",
         str(e_ports[2]), "--capture", "--replay-pregate",
         "--strict-verify", "--drain-timeout", "5"],
        e_ports[1], Path("smoke_out") / "verify_replay_cli.log", "e")
    reqs = ctx6["reqs"]
    jwt = northstar.JWT_FILTER
    rules = [c.evaluators[0][1]
             for c in northstar.build_corpus(P20_CONFIGS, 10)]

    # ---- (a) the metadata prefetch cache ----------------------------------
    srv, srv_thread, counts = _flags_server()
    port = srv.server_address[1]
    acs = northstar.build_auth_configs(P20_CONFIGS, 10)
    for i, o in enumerate(acs):
        o["spec"]["metadata"] = {"flags": {"http": {
            "url": f"http://127.0.0.1:{port}/flags/{i}"}}}
        o["spec"]["authorization"]["tier"] = {"patternMatching": {
            "patterns": [{"selector": "auth.metadata.flags.tier",
                          "operator": "neq", "value": "blocked"}]}}

    def want_code(k: int) -> int:
        req = reqs[k]
        i = int(req.http.host.split(".")[0][len("svc-"):])
        claims = req.metadata_context["filter_metadata"][jwt]["verified_jwt"]
        doc = build_authorization_json(req, {"identity": claims})
        ok = rules[i].matches(doc) and i % P20_BLOCKED_EVERY != 0
        return rpc.OK if ok else rpc.PERMISSION_DENIED

    want = [want_code(k) for k in range(len(reqs))]
    pf_runs = {}
    codes = {}
    fk.reset_counts()
    reset_host_counts()
    for mode in ("on", "off"):
        # the tenant plane off (as phase 18's): a 4,096-request burst must
        # not meet a tenant's queue share
        engine = PolicyEngine(max_batch=256, metadata_prefetch=(mode == "on"),
                              tenant_qos=False, **NO_REUSE)

        async def translate_all(engine=engine):
            return [await translate_auth_config(
                o["metadata"]["name"], o["metadata"]["namespace"], o["spec"],
                engine=engine) for o in acs]

        entries = asyncio.run(translate_all())
        t = time.perf_counter()
        engine.apply_snapshot(entries)
        install_s = time.perf_counter() - t
        pf = engine.metadata_prefetcher
        pin_s = None
        if pf is not None:
            t = time.perf_counter()
            while pf.to_json()["counters"]["refresh"] < 1:
                if time.perf_counter() - t > 120:
                    raise AssertionError("(a) the first re-pin never landed")
                time.sleep(0.01)
            pin_s = time.perf_counter() - t
        gets0 = dict(counts)
        sent = reqs if mode == "on" else reqs[:P20_OFF_CHECKS]
        t = time.perf_counter()
        out = asyncio.run(timed_checks(engine, sent))
        wall = time.perf_counter() - t
        gets = {i: counts.get(i, 0) - gets0.get(i, 0) for i in counts}
        codes[mode] = [res.code for res, _ in out]
        bad = [k for k, c in enumerate(codes[mode]) if c != want[k]]
        if bad:
            k = bad[0]
            raise AssertionError(f"(a) prefetch {mode}: {len(bad)} codes "
                                 f"differ from the oracle, first check {k}: "
                                 f"{out[k][0]} != {want[k]}")
        run = {"checks": len(sent), "checks_per_s": len(sent) / wall,
               "install_s": install_s,
               "gets_during_checks": sum(gets.values()),
               "gets_at_pin": sum(gets0.values()) if mode == "on" else None,
               "pin_s": pin_s,
               "allowed": sum(c == rpc.OK for c in codes[mode])}
        if pf is not None:
            j = pf.to_json()
            run.update(registered=j["registered"], pinned=j["pinned"],
                       counters=dict(j["counters"]))
            pf.stop()
            if j["registered"] != P20_CONFIGS or j["pinned"] != P20_CONFIGS:
                raise AssertionError(f"(a) {j['registered']} registered, "
                                     f"{j['pinned']} pinned of "
                                     f"{P20_CONFIGS}")
            if run["gets_at_pin"] != P20_CONFIGS or \
                    run["gets_during_checks"] != 0:
                raise AssertionError(f"(a) prefetch on: {run}")
            if j["counters"]["hit"] != len(reqs):
                raise AssertionError(f"(a) {j['counters']} hits, want "
                                     f"{len(reqs)}")
        elif run["gets_during_checks"] != len(sent):
            raise AssertionError(f"(a) prefetch off fetched "
                                 f"{run['gets_during_checks']} times for "
                                 f"{len(sent)} checks")
        pf_runs[mode] = run
        for e in entries:
            asyncio.run(e.runtime.clean())
        del engine, entries
    if codes["on"][:len(codes["off"])] != codes["off"]:
        raise AssertionError("(a) prefetch on and off answered differently")
    srv.shutdown()
    srv.server_close()
    numbers["prefetch"] = pf_runs

    # ---- (b) capture on phase 6's engine -----------------------------------
    eng6 = ctx6["engine"]
    eng6.tenancy.enabled = False     # the hot host is no noisy neighbour here
    hot = hot_requests(P20_HOT)
    t = time.perf_counter()
    asyncio.run(timed_checks(eng6, reqs))
    off_rate = len(reqs) / (time.perf_counter() - t)
    cap_dir = Path("smoke_out") / "capture"
    shutil.rmtree(cap_dir, ignore_errors=True)
    CAPTURE.configure(enabled=True, size_mb=64.0, sample_n=1,
                      directory=str(cap_dir))
    CAPTURE.clear()
    burst = hot + list(reqs)
    t = time.perf_counter()
    out = asyncio.run(timed_checks(eng6, burst))
    on_rate = len(burst) / (time.perf_counter() - t)
    launches = {"fused_megakernel": fk.launches,
                "probe_add_one": fk.probe_launches}
    if any(res.code not in (rpc.OK, rpc.PERMISSION_DENIED) for res, _ in out):
        raise AssertionError("(b) a capture-on check did not get a verdict")
    t = time.perf_counter()
    if not CAPTURE.flush(30.0):
        raise AssertionError("(b) the capture queue did not drain")
    flush_s = time.perf_counter() - t
    ring = CAPTURE.ring_records()
    cap_json = CAPTURE.to_json()
    CAPTURE.configure(enabled=False)
    # off once more, after: the two off bursts bracket the on burst
    t = time.perf_counter()
    asyncio.run(timed_checks(eng6, reqs))
    off_after = len(reqs) / (time.perf_counter() - t)
    eng6.tenancy.enabled = True
    if len(ring) != len(burst) or cap_json["dropped_total"]:
        raise AssertionError(f"(b) captured {len(ring)} of {len(burst)}: "
                             f"{cap_json}")
    snap6 = eng6._snapshot
    diffs = 0
    for r in ring:
        row = snap6.policy.config_ids[r["authconfig"]]
        _, rule, skipped = host_results(snap6.policy, r["doc"], row)
        if int(firing_columns(rule[None], skipped[None])[0]) != \
                r["rule_index"]:
            diffs += 1
    if diffs:
        raise AssertionError(f"(b) {diffs} captured firing columns differ "
                             f"from the host oracle's")
    t = time.perf_counter()
    same = replay_records(snap6, snap6, ring)
    replay_s = time.perf_counter() - t
    if same["flips"]["total"] or same["replayed"] != len(ring):
        raise AssertionError(f"(b) old against old: {same['flips']}, "
                             f"{same['replayed']} replayed")
    back = read_capture(str(cap_dir))
    # a record's doc is the pipeline's live authorization JSON (as the
    # reference's): its auth.authorization subtree fills in after the
    # verdict, so the ring's copy may hold results the segment, encoded
    # at ingest, does not; every other byte must match
    lines = ([encode_record(_settled(r)) for r in back],
             [encode_record(_settled(r)) for r in ring])
    if lines[0] != lines[1]:
        k = next((k for k, (x, y) in enumerate(zip(*lines)) if x != y), None)
        raise AssertionError(
            f"(b) {len(back)} records read back from {cap_dir}, not the "
            f"ring's {len(ring)}; first difference at {k}: "
            f"{lines[0][k][:300] if k is not None else ''} != "
            f"{lines[1][k][:300] if k is not None else ''}")
    numbers["capture"] = {
        "records": len(ring), "firing_diffs": diffs,
        "checks_per_s_on": on_rate,
        "checks_per_s_off": [off_rate, off_after],
        "ring_bytes": cap_json["ring_bytes"],
        "dropped": cap_json["dropped_total"],
        "segments": cap_json["segments_written"], "flush_s": flush_s,
        "replay_same_s": replay_s, "read_back": len(back),
        "allowed": sum(r["rule_index"] < 0 for r in ring)}

    # ---- (c) the replay pregate ---------------------------------------------
    base = _rules_only(ctx6["entries"])
    hot_id = f"{northstar.NAMESPACE}/cfg-{HOT_CONFIG}"
    seen = {r["authconfig"] for r in ring}
    quiet = next(e.id for e in base if e.id not in seen and
                 e.id.startswith(northstar.NAMESPACE))
    CAPTURE.configure(enabled=True)      # the ring stays as (b) left it
    engC = PolicyEngine(max_batch=256, replay_pregate=True,
                        replay_pregate_budget_s=P20_BUDGET_MS / 1e3,
                        canary_fraction=0.25, canary_window_s=60.0,
                        tenant_qos=False, **NO_REUSE)
    engC.apply_snapshot(base)
    gen = engC.generation

    def swapped(cid, rule):
        return [type(e)(id=e.id, hosts=e.hosts, runtime=None, rules=(
            ConfigRules(name=e.rules.name, evaluators=[(None, rule)])
            if e.id == cid else e.rules)) for e in base]

    poison = swapped(hot_id, Pattern("request.method", Operator.EQ, "NOPE"))
    mem0 = device_allocated(dev)
    l0, p0 = fk.launches, fk.probe_launches
    ev0 = RECORDER.events_total
    t = time.perf_counter()
    try:
        engC.apply_snapshot(poison)
        raise AssertionError("(c) the poisoned change was not rejected")
    except SnapshotRejected as e:
        rejected = e
    reject_s = time.perf_counter() - t
    mem1 = device_allocated(dev)
    with RECORDER._ring_lock:
        kinds = [x["kind"] for x in list(RECORDER._ring)]
    breach = dict(engC._last_pregate)
    if (engC.generation != gen or engC._canary is not None
            or mem1 != mem0 or (fk.launches, fk.probe_launches) != (l0, p0)
            or "replay-pregate-breach" not in kinds
            or breach["result"] != "breach"
            or rejected.replay_diff["suspects"] != [hot_id]):
        raise AssertionError(f"(c) breach: generation {engC.generation}/"
                             f"{gen}, memory {mem0}->{mem1}, launches "
                             f"{(fk.launches, fk.probe_launches)}/{(l0, p0)},"
                             f" {breach}, events {kinds[-5:]}")
    r0 = len(engC.batch_records)
    allowed_after = _exact_submits(engC, ring[:P20_EXACT], "(c) after")
    gens = {rec["generation"] for rec in list(engC.batch_records)[r0:]}
    if gens != {gen}:
        raise AssertionError(f"(c) batches after the breach rode {gens}")
    clean_rule = Pattern("request.method", Operator.EQ, "TRACE")
    t = time.perf_counter()
    engC.apply_snapshot(swapped(quiet, clean_rule))
    pass_s = time.perf_counter() - t
    phase = engC._canary
    passed = dict(engC._last_pregate)
    if phase is None or not (phase.preflight or {}).get("guards_tightened"):
        raise AssertionError(f"(c) the clean churn's canary: {passed}")
    tightened = (phase.guard.thresholds.deny_delta,
                 phase.guard.thresholds.config_deny_delta)
    engC.canary_promote()
    CAPTURE.configure(enabled=False)
    numbers["pregate"] = {
        "breach": breach, "reject_wall_s": reject_s,
        "findings": [str(f) for f in rejected.findings[:4]],
        "memory_before": mem0, "memory_after": mem1,
        "events": RECORDER.events_total - ev0,
        "exact_after": P20_EXACT, "allowed_after": allowed_after,
        "pass": passed, "pass_wall_s": pass_s,
        "tightened": list(tightened), "budget_ms": P20_BUDGET_MS}
    del engC

    # ---- (d) strict verify ----------------------------------------------------
    tv.clear_certificate_cache()
    engD = PolicyEngine(max_batch=256, strict_verify=True, tenant_qos=False,
                        **NO_REUSE)
    engD.apply_snapshot(base)
    first = {"validate_s": engD._snapshot.phase_s.get("validate"),
             "translation": dict(engD._snapshot.translation),
             "lint_ok": engD._snapshot.lint_ok}
    engD.apply_snapshot(swapped(quiet, clean_rule))
    second = {"validate_s": engD._snapshot.phase_s.get("validate"),
              "translation": dict(engD._snapshot.translation)}
    n_cfg = len(base)
    if first["translation"]["validated"] != n_cfg or \
            second["translation"]["validated"] != 1 or \
            second["translation"]["cache_hits"] != n_cfg - 1:
        raise AssertionError(f"(d) translation counts {first} {second}")
    served = engD._snapshot
    real = cc.compile_corpus
    plants = {
        "dfa-transition": dict(tv._MUTANTS)["dfa-transition-corrupt"],
        "dfa_row_perm": lambda p: setattr(
            p, "dfa_row_perm", np.zeros_like(p.dfa_row_perm)),
        "fused_pack_w": lambda p: setattr(p, "fused_pack_w",
                                          int(p.fused_pack_w) + 1),
    }
    mutants = {}
    changed = swapped(quiet, Pattern("request.method", Operator.EQ, "HEAD"))
    for name, plant in plants.items():
        def bad(*a, _plant=plant, **k):
            p = real(*a, **k)
            _plant(p)
            return p

        cc.compile_corpus = bad
        mem0 = device_allocated(dev)
        l0, p0 = fk.launches, fk.probe_launches
        t = time.perf_counter()
        try:
            engD.apply_snapshot(changed)
            raise AssertionError(f"(d) mutant {name} was not rejected")
        except SnapshotRejected as e:
            kinds = sorted({f.kind for f in e.findings})
        finally:
            cc.compile_corpus = real
        wall = time.perf_counter() - t
        mem1 = device_allocated(dev)
        if mem1 != mem0 or (fk.launches, fk.probe_launches) != (l0, p0) \
                or engD._snapshot is not served:
            raise AssertionError(f"(d) mutant {name}: memory {mem0}->{mem1},"
                                 f" launches {(fk.launches, fk.probe_launches)}"
                                 f"/{(l0, p0)}")
        allowed = _exact_submits(engD, ring[:P20_EXACT], f"(d) {name}")
        mutants[name] = {"kinds": kinds, "reject_s": wall,
                         "memory_delta": mem1 - mem0,
                         "allowed_after": allowed}
    t = time.perf_counter()
    self_test = tv.mutation_self_test() + tv.relations_mutation_self_test()
    self_test_s = time.perf_counter() - t
    if self_test:
        raise AssertionError(f"(d) the mutation self-test: {self_test}")
    numbers["strict_verify"] = {"install": first, "one_change": second,
                                "mutants": mutants,
                                "self_test_s": self_test_s}
    del engD
    tv.clear_certificate_cache()

    # ---- (e) the CLI ---------------------------------------------------------
    e = {}
    ports, srv = e_ports, e_server
    proc, log_path = srv.proc, srv.log_path
    try:
        try:
            e["ready_s"] = srv.wait_ready()
            rp = http_call(ports[1], "/debug/replay")
            dv = json.loads(http_call(ports[1], "/debug/vars")[2])["engine"]
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=30)
        finally:
            srv.kill()
    finally:
        shutil.rmtree(e_tmp, ignore_errors=True)
    replay = json.loads(rp[2]) if rp[0] == 200 else {}
    e.update(replay_status=rp[0], replay_keys=sorted(replay), exit_code=rc,
             strict_verify=dv.get("strict_verify"),
             translation=dv.get("translation_validation"),
             metadata_prefetch=dv.get("metadata_prefetch") is not None,
             lowerability=(dv.get("lowerability") or {}).get("fast"),
             policy_findings=len((dv.get("policy_analysis") or {}).get(
                 "findings", [None])) if dv.get("policy_analysis") else None,
             capture_enabled=replay.get("capture", {}).get("enabled"),
             pregate_enabled=replay.get("pregate", {}).get("enabled"))
    if (rp[0] != 200 or e["replay_keys"] != ["capture", "pregate"]
            or not e["capture_enabled"] or not e["pregate_enabled"]
            or e["strict_verify"] is not True or not e["metadata_prefetch"]
            or e["lowerability"] is None or e["policy_findings"] is None
            or sum((e["translation"] or {}).get(k, 0)
                   for k in ("validated", "cache_hits")) != ENTRY_CONFIGS
            or rc != 0):
        raise AssertionError(f"(e) {e}; log "
                             f"{log_path.read_text()[-2000:]}")
    numbers["cli"] = e
    numbers["launches"] = launches
    report["verify_replay"] = numbers

    a, b, c, sv = (numbers["prefetch"], numbers["capture"],
                   numbers["pregate"], numbers["strict_verify"])
    log(f"[{card}] verify/replay (a) metadata prefetch over {P20_CONFIGS} "
        f"configs: "
        f"on {a['on']['checks_per_s']:.0f} checks/s, {a['on']['gets_at_pin']}"
        f" GETs to pin in {a['on']['pin_s']:.2f} s, "
        f"{a['on']['gets_during_checks']} during {len(reqs)} checks "
        f"({a['on']['counters']['hit']} hits); off "
        f"{a['off']['checks_per_s']:.0f} checks/s, "
        f"{a['off']['gets_during_checks']} GETs during its "
        f"{a['off']['checks']} checks (the first of the same); every code "
        f"the oracle's ({a['on']['allowed']} allowed), on and off equal")
    log(f"[{card}] verify/replay (b) capture 1-in-1 over {b['records']} "
        f"check()s: {b['firing_diffs']} firing columns differ from the host "
        f"oracle; replay old against old 0 flips in "
        f"{b['replay_same_s']:.2f} s; {b['segments']} segments read back "
        f"equal; ring {b['ring_bytes']} B, {b['dropped']} dropped; checks/s "
        f"capture on {b['checks_per_s_on']:.0f}, off before and after "
        f"{[round(x) for x in b['checks_per_s_off']]}")
    log(f"[{card}] verify/replay (c) pregate: the poisoned {hot_id} "
        f"rejected in {c['reject_wall_s']:.3f} s (replay "
        f"{c['breach']['elapsed_ms']:.1f} ms of the {P20_BUDGET_MS:g} ms "
        f"budget, {c['breach']['replayed']} replayed, "
        f"{c['breach']['flips']}), memory {c['memory_before']} -> "
        f"{c['memory_after']} B, no launch; {P20_EXACT} submits after it "
        f"exact; the clean churn passed ({c['pass']['replayed']} replayed, "
        f"{c['pass']['truncated']} truncated, {c['pass']['elapsed_ms']:.1f} "
        f"ms) into a canary at deny deltas {c['tightened']}")
    log(f"[{card}] verify/replay (d) strict verify: install validate "
        f"{sv['install']['validate_s']:.3f} s, {sv['install']['translation']};"
        f" one change validate {sv['one_change']['validate_s']:.3f} s, "
        f"{sv['one_change']['translation']}; mutants "
        + ", ".join(f"{k} {v['kinds']} +{v['memory_delta']} B"
                    for k, v in sv["mutants"].items())
        + f"; self-test green in {sv['self_test_s']:.2f} s")
    log(f"verify/replay (e): python3 -m authorino_tpu_torch server --capture "
        f"--replay-pregate --strict-verify ready in {e['ready_s']:.1f} s; "
        f"/debug/replay {e['replay_status']} {e['replay_keys']}; /debug/vars "
        f"translation {e['translation']}, lowerability fast "
        f"{e['lowerability']}, {e['policy_findings']} policy findings; "
        f"exit {rc}")
    return launches, 0


P21_CONFIGS = 1000        # the north-star corpus at full width
P21_CHANGED = 11          # (a): the config whose constant the leader changes
P21_HARNESS_CONFIGS = 1000  # (b): the kill harness's configs (--configs)
P21_KILL_AFTER_S = 1.0    # (b): seconds into the churn loop of the SIGKILL
P21_PLANTED = 7           # (c): the config no captured request reaches
P21_CLEAN = 9             # (c): the config the clean edit extends
P21_BUDGET_MS = 2000.0    # (c): the corpus pregate's replay budget
# (c): the guard thresholds the pregate judges with (the reference's
# low-volume test thresholds: one synthetic witness is evidence)
P21_TH = {"min_requests": 8, "min_config_requests": 1,
          "min_config_allows": 1}


def _verdict_lists(out):
    return [(rule.tolist(), skipped.tolist()) for rule, skipped in out]


def _every_config_probes(n: int):
    """Four probes for each config of the kill harness's corpus (its
    probes reach only the first 24): the org of each variant with the
    config's own method (allowed only under that variant), and the other
    method (denied under every variant)."""
    docs, names, want = [], [], []
    for c in range(n):
        method = ["GET", "POST"][c % 2]
        for v, m in ((0, method), (1, method), (2, method),
                     (0, ["POST", "GET"][c % 2])):
            docs.append({"request": {"method": m, "url_path": "/other"},
                         "auth": {"identity": {"org": f"org-{c}-v{v}",
                                               "roles": []}}})
            names.append(f"cfg-{c}")
            want.append(None if m != method else v)
    return docs, names, want


def _submits(engine, docs, names):
    async def go():
        return await asyncio.gather(*(engine.submit(d, n)
                                      for d, n in zip(docs, names)))

    return asyncio.run(go())


def state_planes(report: dict, card: str, dev, ns: dict) -> tuple:
    """Phase 21: snapshot distribution, the durable state plane and the
    decision corpus's pregate, on the card at the north-star width.
    (a) a strict-verify leader (1,000 configs) publishes into a directory,
    serves 4,096 submits, changes one config, republishes and serves them
    again (each publish kept as its directory stood); then a replica on
    the card takes the first blob through ``SnapshotReplica`` without
    compiling (its ``phase_s``), serves the 4,096 with the leader's
    verdicts, takes the second: its delta upload ships fewer bytes than a
    full one and keeps at least the leader's share of its verdict cache
    over the same burst; an uncertified blob and
    a torn one are each rejected typed with +0 B, no launch and the old
    generation still exact.  One batch's [256, W] readback on the replica
    is byte-equal to the leader's and to the plain version's.  (b) the
    kill harness: ``restart_harness serve --device cuda`` SIGKILLed
    mid-reconcile, ``restart --device cuda`` recovers bit-exact with every
    artifact old- or new-valid; the time to the first verdict warm (load,
    verify, upload, hot-set import) against cold (compile).  (c) the
    corpus pregate: a corpus distilled from the burst with no request on
    one config; an edit that makes that config deny everything breaches on
    synthetic witnesses alone and is rejected before the upload (+0 B, no
    launch); a clean edit passes.  Returns (the kernels' launches on (a)'s
    replica, counts zeroed just before its install; the byte error of the
    readback comparisons)."""
    import os
    import signal
    import tempfile

    import numpy as np

    from authorino_tpu_torch.analysis import translation_validate as tv
    from authorino_tpu_torch.compiler import ConfigRules, compile_corpus
    from authorino_tpu_torch.compiler.encode import encode_batch
    from authorino_tpu_torch.compiler.pack import pack_batch
    from authorino_tpu_torch.corpus import distill_records, write_corpus
    from authorino_tpu_torch.expressions import Any_, Operator, Pattern
    from authorino_tpu_torch.fleet.warmjoin import import_hotset
    from authorino_tpu_torch.models import northstar
    from authorino_tpu_torch.ops import fused_kernel as fk
    from authorino_tpu_torch.ops.operands import to_device
    from authorino_tpu_torch.runtime import EngineEntry, PolicyEngine
    from authorino_tpu_torch.runtime import restart_harness as harness
    from authorino_tpu_torch.runtime.change_safety import GuardThresholds
    from authorino_tpu_torch.runtime.engine import SnapshotRejected
    from authorino_tpu_torch.snapshots import (rules_fingerprint,
                                               serialize_policy)
    from authorino_tpu_torch.snapshots.distribution import (
        MANIFEST, SnapshotPublisher, SnapshotReplica, load_hotset,
        load_latest)

    numbers = {"card": card}
    docs, names = ns["docs"], ns["names"]
    cfgs = northstar.build_corpus(P21_CONFIGS, 10)

    def entries(cs):
        return [EngineEntry(id=c.name, hosts=[c.name], rules=c) for c in cs]

    def records(k: int = 256):
        return [{"doc": d, "authconfig": n}
                for d, n in zip(docs[:k], names[:k])]

    tmp_ctx = tempfile.TemporaryDirectory()
    tmp = Path(tmp_ctx.name)
    try:
        # ---- (a) leader to replica ---------------------------------------
        # the leader runs its whole sequence first (install, a burst, one
        # changed config, a burst), each publish kept as its directory
        # stood; then the replica's run alone is the counted path
        import shutil

        tv.clear_certificate_cache()
        pub_dir = str(tmp / "pub")
        # wide admission bounds (as phase 10's): a 4,096-submit burst is
        # held to verdicts here, not shed
        leader = PolicyEngine(max_batch=256, strict_verify=True,
                              tenant_qos=False, **WIDE_ADMISSION)
        pub = SnapshotPublisher(pub_dir)
        pub.attach(leader)
        t = time.perf_counter()
        leader.apply_snapshot(entries(cfgs))
        leader_s = time.perf_counter() - t
        leader_phases = dict(leader._snapshot.phase_s)
        if not pub.flush(60.0):
            raise AssertionError("(a) the leader's publish did not land")
        man = json.loads((Path(pub_dir) / MANIFEST).read_text())
        gen_dirs = [str(tmp / "gen1"), str(tmp / "gen2")]
        shutil.copytree(pub_dir, gen_dirs[0])
        out_l = _submits(leader, docs, names)
        changed = northstar.build_corpus(P21_CONFIGS, 10,
                                         changed={P21_CHANGED: "const"})
        leader.apply_snapshot(entries(changed))
        if not pub.flush(60.0):
            raise AssertionError("(a) the republish did not land")
        shutil.copytree(pub_dir, gen_dirs[1])
        for k, g in enumerate(gen_dirs, 1):  # phase 22 (d) diffs them
            keep = Path("smoke_out") / f"p21-gen{k}"
            shutil.rmtree(keep, ignore_errors=True)
            shutil.copytree(g, keep)
        vc = leader._verdict_cache
        h0 = vc.hits
        out_l2 = _submits(leader, docs, names)
        share = {"leader": (vc.hits - h0) / len(docs)}
        replica = PolicyEngine(max_batch=256, strict_verify=True,
                               tenant_qos=False, **WIDE_ADMISSION)
        rep = SnapshotReplica(replica, gen_dirs[0])
        fk.reset_counts()
        reset_host_counts()
        t = time.perf_counter()
        if not rep.poll_once():
            raise AssertionError(f"(a) the replica did not apply: "
                                 f"{rep.to_json()}")
        replica_s = time.perf_counter() - t
        snap = replica._snapshot
        replica_phases = dict(snap.phase_s)
        if snap.compile_report is not None or "compile" in snap.phase_s \
                or snap.upload["mode"] != "full" or not snap.lint_ok:
            raise AssertionError(f"(a) the replica's install: "
                                 f"{snap.phase_s} {snap.upload}")
        t = time.perf_counter()
        out_r = _submits(replica, docs, names)
        rate_r = len(docs) / (time.perf_counter() - t)
        rep.source = gen_dirs[1]
        t = time.perf_counter()
        if not rep.poll_once():
            raise AssertionError("(a) the replica missed the republish")
        delta_s = time.perf_counter() - t
        snap = replica._snapshot
        up = dict(snap.upload)
        vc = replica._verdict_cache
        h0 = vc.hits
        out_r2 = _submits(replica, docs, names)
        share["replica"] = (vc.hits - h0) / len(docs)
        launches = {"fused_megakernel": fk.launches,
                    "probe_add_one": fk.probe_launches}
        if _verdict_lists(out_r) != _verdict_lists(out_l) or \
                _verdict_lists(out_r2) != _verdict_lists(out_l2):
            raise AssertionError("(a) the replica's verdicts differ from "
                                 "the leader's")
        if up["mode"] != "delta" or \
                not up["upload_bytes"] < up["full_bytes"]:
            raise AssertionError(f"(a) the replica's second install: {up}")
        if share["replica"] < share["leader"]:
            raise AssertionError(f"(a) verdict-cache share kept: {share}")
        # one batch's readback, replica against leader and plain (these
        # comparison launches are not the path's)
        rows_r = [snap.policy.config_ids[n] for n in names[:256]]
        db_r = pack_batch(snap.policy, encode_batch(snap.policy, docs[:256],
                                                    rows_r))
        lsnap = leader._snapshot
        db_l = pack_batch(lsnap.policy, encode_batch(
            lsnap.policy, docs[:256],
            [lsnap.policy.config_ids[n] for n in names[:256]]))
        got = fk.eval_fused_kernel(snap.params, db_r).cpu().numpy()
        want_l = fk.eval_fused_kernel(lsnap.params, db_l).cpu().numpy()
        plain = fk.eval_fused_kernel(to_device(snap.policy, device="cpu"),
                                     db_r).numpy()
        err = int(max(np.abs(got.astype(int) - want_l.astype(int)).max(),
                      np.abs(got.astype(int) - plain.astype(int)).max()))
        if err:
            raise AssertionError(f"(a) the replica's [256, W] readback "
                                 f"differs by {err}")
        rejected = {}
        served = replica._snapshot
        changed2 = northstar.build_corpus(P21_CONFIGS, 10,
                                          changed={P21_CHANGED + 1: "const"})
        bad_pub = SnapshotPublisher(gen_dirs[1])
        for bad in ("uncertified", "torn"):
            if bad == "uncertified":
                bad_pub.publish_blob(serialize_policy(
                    compile_corpus(changed2, members_k=16), meta={
                        "generation": 9999, "certified": False,
                        "fingerprints": {c.name: rules_fingerprint(c)
                                         for c in changed2},
                        "entries": [{"id": c.name, "hosts": [c.name]}
                                    for c in changed2]}), 9999)
            else:
                import hashlib

                m = json.loads((Path(gen_dirs[1]) / MANIFEST).read_text())
                p = Path(gen_dirs[1]) / m["current"]
                raw = bytearray(p.read_bytes())
                raw[len(raw) // 3] ^= 0xFF
                p.write_bytes(bytes(raw))
                m["sha256"] = hashlib.sha256(bytes(raw)).hexdigest()
                (Path(gen_dirs[1]) / MANIFEST).write_text(json.dumps(m))
            mem0 = device_allocated(dev)
            l0, p0 = fk.launches, fk.probe_launches
            r0, e0 = rep.rejected, rep.errors
            t = time.perf_counter()
            applied = rep.poll_once()
            wall = time.perf_counter() - t
            mem1 = device_allocated(dev)
            typed = ("rejected" if rep.rejected > r0 else
                     "load-error" if rep.errors > e0 else None)
            if applied or mem1 != mem0 or typed is None or \
                    (fk.launches, fk.probe_launches) != (l0, p0) or \
                    replica._snapshot is not served:
                raise AssertionError(f"(a) the {bad} blob: applied "
                                     f"{applied}, memory {mem0}->{mem1}, "
                                     f"{typed}, {rep.to_json()}")
            allowed = _exact_submits(replica, records(), f"(a) {bad}")
            rejected[bad] = {"typed": typed, "memory_delta": mem1 - mem0,
                             "wall_s": wall, "error": rep.last_error,
                             "allowed_after": allowed}
        rep.stop()
        numbers["replica"] = {
            "configs": P21_CONFIGS, "blob_bytes": man["size"],
            "leader_install_s": leader_s, "leader_phase_s": leader_phases,
            "replica_install_s": replica_s, "replica_phase_s": replica_phases,
            "submits_per_s": rate_r, "delta_install_s": delta_s,
            "delta_phase_s": dict(snap.phase_s), "delta_upload": up,
            "cache_share": share, "readback_err": err,
            "rejected": rejected, "launches": dict(launches)}
        del leader, replica, pub, rep

        # ---- (b) the kill harness and the warm restart -------------------
        sd = tmp / "state"
        sd.mkdir()
        table, ready = sd / "TABLE.json", sd / "READY"
        root = Path(__file__).resolve().parent
        env = dict(os.environ, PYTHONPATH=str(root))
        mod = "authorino_tpu_torch.runtime.restart_harness"
        serve_log = Path("smoke_out") / "restart_serve.log"
        t0 = time.perf_counter()
        with open(serve_log, "w") as logf:
            proc = subprocess.Popen(
                [sys.executable, "-m", mod, "serve", "--device", "cuda",
                 "--state-dir", str(sd), "--table", str(table), "--ready",
                 str(ready), "--stress", "reconcile", "--configs",
                 str(P21_HARNESS_CONFIGS), "--variants", "3"],
                cwd=str(root), env=env, stdout=logf,
                stderr=subprocess.STDOUT)
        try:
            while not ready.exists():
                if proc.poll() is not None:
                    raise AssertionError(f"(b) the harness exited "
                                         f"{proc.returncode}: "
                                         f"{serve_log.read_text()[-2000:]}")
                if time.perf_counter() - t0 > 240:
                    raise AssertionError("(b) the harness never got ready")
                time.sleep(0.05)
            ready_s = time.perf_counter() - t0
            time.sleep(P21_KILL_AFTER_S)
            if proc.poll() is not None:
                raise AssertionError("(b) the harness exited on its own")
        finally:
            if proc.poll() is None:
                proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=60)
        debris = sorted(p.name for p in sd.iterdir()
                        if p.name.endswith(".tmp"))
        t = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", mod, "restart", "--device", "cuda",
             "--state-dir", str(sd), "--table", str(table), "--report",
             str(tmp / "report.json")],
            cwd=str(root), env=env, capture_output=True, text=True,
            timeout=300)
        restart_s = time.perf_counter() - t
        if res.returncode != 0:
            raise AssertionError(f"(b) restart exited {res.returncode}: "
                                 f"{res.stdout[-2000:]} "
                                 f"{res.stderr[-2000:]}")
        rep_b = json.loads((tmp / "report.json").read_text())
        if not (rep_b["recovered"] and rep_b["table_hit"]
                and rep_b["verdicts_match"]
                and not rep_b["artifacts"]["unhandled"]):
            raise AssertionError(f"(b) the restart's report: {rep_b}")
        # the time to the first verdict in this process, on the card: cold
        # (compile the recovered variant) against warm (the state dir)
        n = P21_HARNESS_CONFIGS
        probes = harness._probe_docs(n)
        cold_cfgs = harness._corpus(n, int(rep_b["variant"]))
        tv.clear_certificate_cache()
        t0 = time.perf_counter()
        cold = harness._new_engine(n, "cuda")
        cold.apply_snapshot([EngineEntry(id=c.name, hosts=[c.name],
                                         runtime=None, rules=c)
                             for c in cold_cfgs])
        t1 = time.perf_counter()
        first_cold = _submits(cold, [probes[0][0]], [probes[0][1]])
        cold_s = time.perf_counter() - t0
        cold_split = {"install_s": t1 - t0,
                      "phase_s": dict(cold._snapshot.phase_s),
                      "first_verdict_s": time.perf_counter() - t1}
        tv.clear_certificate_cache()
        t0 = time.perf_counter()
        warm = harness._new_engine(n, "cuda")
        t1 = time.perf_counter()
        loaded = load_latest(str(sd))
        t2 = time.perf_counter()
        warm.apply_published(loaded)
        t3 = time.perf_counter()
        imported, skipped = import_hotset(warm, load_hotset(str(sd)))
        t4 = time.perf_counter()
        first_warm = _submits(warm, [probes[0][0]], [probes[0][1]])
        warm_s = time.perf_counter() - t0
        warm_split = {"engine_s": t1 - t0, "load_s": t2 - t1,
                      "install_s": t3 - t2,
                      "phase_s": dict(warm._snapshot.phase_s),
                      "hotset_s": t4 - t3, "hotset_imported": imported,
                      "hotset_skipped": skipped,
                      "first_verdict_s": time.perf_counter() - t4}
        if harness.table_key(warm) != harness.table_key(cold) or \
                _verdict_lists(first_warm) != _verdict_lists(first_cold):
            raise AssertionError("(b) the warm and cold engines differ")
        all_p = ([d for d, _ in probes], [c for _, c in probes])
        if _verdict_lists(_submits(warm, *all_p)) != \
                _verdict_lists(_submits(cold, *all_p)):
            raise AssertionError("(b) warm and cold verdicts differ")
        # every config the restarted process loaded, not only the
        # harness's 24 probes: warm equal to cold, and each config's allow
        # set the recovered variant's
        e_docs, e_names, e_want = _every_config_probes(n)
        warm_all = _verdict_lists(_submits(warm, e_docs, e_names))
        if warm_all != _verdict_lists(_submits(cold, e_docs, e_names)):
            raise AssertionError("(b) warm and cold verdicts differ on "
                                 "the every-config probes")
        variant = int(rep_b["variant"]) % 3
        wrong = [k for k, ((rule, skipped), w) in enumerate(
                     zip(warm_all, e_want))
                 if all(r or sk for r, sk in zip(rule, skipped))
                 != (w == variant)]
        if wrong:
            raise AssertionError(f"(b) {len(wrong)} every-config probes "
                                 f"answer against variant {variant}: "
                                 f"{[e_names[k] for k in wrong[:8]]}")
        numbers["restart"] = {
            "configs": n, "compared_configs": len(set(e_names)),
            "compared_probes": len(e_docs), "ready_s": ready_s,
            "kill_after_s":
            P21_KILL_AFTER_S, "tmp_debris": debris,
            "restart_process_s": restart_s,
            "report": {k: rep_b[k] for k in (
                "recovered", "table_hit", "verdicts_match", "variant",
                "warm_start", "warm_start_wall_s")},
            "artifacts": rep_b["artifacts"],
            "first_verdict_cold_s": cold_s, "cold": cold_split,
            "first_verdict_warm_s": warm_s, "warm": warm_split}
        del cold, warm

        # ---- (c) the corpus pregate -----------------------------------------
        planted_id = f"cfg-{P21_PLANTED}"
        recs = [{"authconfig": nm, "doc": d, "t": 1.0}
                for nm, d in zip(names, docs) if nm != planted_id]
        t = time.perf_counter()
        dist = distill_records(recs, compile_corpus(cfgs, members_k=16))
        distill_s = time.perf_counter() - t
        corpus_path = str(tmp / "corpus.atpucorp")
        write_corpus(corpus_path, dist["rows"])
        eng_c = PolicyEngine(max_batch=256, tenant_qos=False,
                             corpus_pregate=corpus_path,
                             corpus_pregate_budget_s=P21_BUDGET_MS / 1e3,
                             canary_thresholds=GuardThresholds(**P21_TH),
                             **NO_REUSE)
        eng_c.apply_snapshot(entries(cfgs))
        gen = eng_c.generation
        planted = [ConfigRules(name=c.name, evaluators=[
            (None, Pattern("request.method", Operator.EQ, "NOPE"))])
            if c.name == planted_id else c for c in cfgs]
        mem0 = device_allocated(dev)
        l0, p0 = fk.launches, fk.probe_launches
        t = time.perf_counter()
        try:
            eng_c.apply_snapshot(entries(planted))
            raise AssertionError("(c) the planted edit was not rejected")
        except SnapshotRejected as e:
            corpus_diff = e.corpus_diff
        reject_s = time.perf_counter() - t
        mem1 = device_allocated(dev)
        breach = dict(eng_c._last_corpus_pregate)
        origins = breach.get("origins", {})
        if (eng_c.generation != gen or mem1 != mem0
                or (fk.launches, fk.probe_launches) != (l0, p0)
                or breach["result"] != "breach"
                or corpus_diff["suspects"] != [planted_id]
                or origins["captured"]["flips"] != 0
                or origins["synthetic"]["flips"] < 1):
            raise AssertionError(f"(c) the planted edit: generation "
                                 f"{eng_c.generation}/{gen}, memory "
                                 f"{mem0}->{mem1}, {breach}")
        allowed = _exact_submits(eng_c, records(), "(c) after the breach")
        clean = [ConfigRules(name=c.name, evaluators=[
            (None, Any_(c.evaluators[0][1],
                        Pattern("request.headers.x-clean", Operator.EQ,
                                "yes")))])
            if c.name == f"cfg-{P21_CLEAN}" else c for c in cfgs]
        t = time.perf_counter()
        eng_c.apply_snapshot(entries(clean))
        pass_s = time.perf_counter() - t
        passed = dict(eng_c._last_corpus_pregate)
        if passed["result"] != "pass" or eng_c.generation != gen + 1 or \
                passed["flips"]["total"] or passed["truncated"]:
            raise AssertionError(f"(c) the clean edit: {passed}")
        cv = eng_c.corpus_vars()
        numbers["corpus"] = {
            "records": len(recs), "distill_s": distill_s,
            "distill": dist["counters"], "rows_captured": cv["rows_captured"],
            "rows_synthetic": cv["rows_synthetic"],
            "synthesis": cv["synthesis"], "breach": breach,
            "reject_wall_s": reject_s, "memory_delta": mem1 - mem0,
            "allowed_after": allowed, "pass": passed,
            "pass_wall_s": pass_s, "budget_ms": P21_BUDGET_MS,
            "thresholds": P21_TH}
        del eng_c
    finally:
        tmp_ctx.cleanup()
        tv.clear_certificate_cache()
    report["state_planes"] = numbers

    a, b, c = numbers["replica"], numbers["restart"], numbers["corpus"]
    log(f"[{card}] state planes (a) {P21_CONFIGS} configs: the leader "
        f"installed in {a['leader_install_s']:.3f} s "
        f"({ {k: round(v, 4) for k, v in a['leader_phase_s'].items()} }), "
        f"blob {a['blob_bytes']} B; the replica took it without compiling "
        f"in {a['replica_install_s']:.3f} s "
        f"({ {k: round(v, 4) for k, v in a['replica_phase_s'].items()} }), "
        f"{a['submits_per_s']:.0f} submits/s, verdicts = the leader's; "
        f"republish of {P21_CHANGED}: delta {a['delta_upload']['upload_bytes']}"
        f" of {a['delta_upload']['full_bytes']} B in "
        f"{a['delta_install_s']:.3f} s, cache share kept leader "
        f"{a['cache_share']['leader']:.4f} replica "
        f"{a['cache_share']['replica']:.4f}; [256, W] readback = leader = "
        f"plain; rejected "
        + ", ".join(f"{k} {v['typed']} +{v['memory_delta']} B"
                    for k, v in a["rejected"].items())
        + f"; launches {a['launches']}")
    log(f"[{card}] state planes (b) kill harness --configs {b['configs']}: "
        f"ready in {b['ready_s']:.1f} s, SIGKILL {b['kill_after_s']} s "
        f"into the churn (tmp debris {b['tmp_debris']}); restart "
        f"{b['restart_process_s']:.1f} s: recovered variant "
        f"{b['report']['variant']} bit-exact, artifacts {b['artifacts']}; "
        f"time to the first verdict warm {b['first_verdict_warm_s']:.3f} s "
        f"(load {b['warm']['load_s']:.3f}, install "
        f"{b['warm']['install_s']:.3f} "
        f"{ {k: round(v, 4) for k, v in b['warm']['phase_s'].items()} }, "
        f"hot set {b['warm']['hotset_s']:.4f} "
        f"({b['warm']['hotset_imported']} imported), first verdict "
        f"{b['warm']['first_verdict_s']:.4f}) against cold "
        f"{b['first_verdict_cold_s']:.3f} s (install "
        f"{b['cold']['install_s']:.3f} "
        f"{ {k: round(v, 4) for k, v in b['cold']['phase_s'].items()} }, "
        f"first verdict {b['cold']['first_verdict_s']:.4f})")
    log(f"[{card}] state planes (c) corpus pregate: {c['records']} records "
        f"distilled to {c['rows_captured']} rows in {c['distill_s']:.2f} s, "
        f"{c['rows_synthetic']} synthetic; the planted cfg-{P21_PLANTED} "
        f"rejected in {c['reject_wall_s']:.3f} s (pregate "
        f"{c['breach']['elapsed_ms']:.1f} ms, synthesis included, of a "
        f"{P21_BUDGET_MS:g} ms replay budget; origins {c['breach']['origins']}"
        f"), +{c['memory_delta']} B, no launch; the clean edit passed in "
        f"{c['pass']['elapsed_ms']:.1f} ms ({c['pass']['replayed']} "
        f"weighted decisions, 0 flips)")
    return launches, err


# ---------------------------------------------------------------------------
# phase 22: the gather and matmul lanes, the staged baseline, the analysis CLI
# ---------------------------------------------------------------------------

# phase 7's and phase 8's B=256 batches with their policies, kept for (a)
LANE_CORPORA: dict = {}
P22_LANES = ("gather", "matmul", "staged", "megakernel", "plain")
P22_TIMED = 20            # (b): one-call timings per lane
# (b): calls enqueued back to back behind one sleep.  The card holds about
# 1,024 pending launches, so an op-chain lane of 150-230 kernels a call
# (phase 22 (b)'s counts) fits 4 calls; the mega-kernel, one kernel, 200
P22_B2B_CALLS = {"gather": 4, "matmul": 4, "staged": 4, "plain": 4,
                 "megakernel": 200}
P22_CONFIGS = 1000        # (c): the wire corpus's anonymous AuthConfigs
P22_GATHER_CONFIGS = 250  # (c): the gather server's (a cut of the same)
P22_CHECKS = 4096         # (c): engine.check()s on the matmul server
P22_GRPC = 1024           # (c): gRPC Check()s through the fast lane
P22_GATHER = 1024         # (c): engine.check()s on the gather server
P22_AUTO = 256            # (c): submits on the auto engine
P22_WIDTHS = (300, 2100)  # (a): children of the planted wide Ands
P22_NARROW = (5, 3)       # (a): children of the Ands padded beside them
P22_PREFILL = 3000        # (a): interner ids before the planted constants


def lane_params(policy, dev) -> dict:
    """Each lane's params of one corpus on the card."""
    from authorino_tpu_torch.ops import pattern_eval as pe

    return {lane: pe.to_device(policy, device=dev, lane=lane)
            for lane in ("gather", "matmul", "fused")}


def lane_fns(params, buf_dev, layout, out) -> dict:
    """One batch's evaluation on each lane over a staging buffer already on
    the card (as the kernel's timings take it): callables, unsynchronised."""
    from authorino_tpu_torch.ops import fused_kernel as fk
    from authorino_tpu_torch.ops import pattern_eval as pe
    from authorino_tpu_torch.ops.operands import defuse

    return {
        "gather": lambda: pe.eval_fused(params["gather"], buf_dev, layout),
        "matmul": lambda: pe.eval_fused(params["matmul"], buf_dev, layout),
        "staged": lambda: fk.staged_fused(params["fused"], buf_dev, layout),
        "megakernel": lambda: fk.launch_kernel(params["fused"], buf_dev,
                                               layout, out),
        "plain": lambda: fk.fused_packed_plain(params["fused"],
                                               defuse(buf_dev, layout)),
    }


def lane_readbacks(params, db, dev) -> dict:
    """The [B, W] readbacks of one batch on every lane, the staged
    baseline, the mega-kernel and its plain version; raises unless all are
    byte-equal to the mega-kernel's."""
    import torch

    from authorino_tpu_torch.ops import fused_kernel as fk
    from authorino_tpu_torch.ops.operands import check_batch, fuse_batch

    check_batch(params["fused"], db)
    buf, layout = fuse_batch(db)
    buf_dev = torch.from_numpy(buf).to(dev)
    E = int(params["fused"]["eval_rule"].shape[1])
    out = torch.empty((db.attrs_val.shape[0], fk.packed_width(1 + 2 * E)),
                      dtype=torch.uint8, device=dev)
    fns = lane_fns(params, buf_dev, layout, out)
    got = {}
    for name, fn in fns.items():
        r = fn()
        got[name] = out if name == "megakernel" else r
    torch.cuda.synchronize()
    for name in P22_LANES:
        max_byte_err(got[name], got["megakernel"])
    return {k: v.cpu().numpy() for k, v in got.items()}


def cuda_kernels_per_call(fn) -> int:
    """CUDA kernels one call of ``fn`` runs, counted by ``torch.profiler``
    (memory copies and sets not counted); None when the profiler saw no
    device activity.  Counted in a fresh process (``lane_kernel_counts``,
    ``mesh_kernel_counts``): after another profiler session in the
    process (phase 12's ``/debug/profile``) the counts came out short."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [n for n in names if not n.lower().startswith(("memcpy",
                                                             "memset"))]
    return len(kernels) if names else None


def lane_kernel_counts() -> None:
    """Print, as one JSON line, the CUDA kernels one north-star batch
    (B = 256, phase 4's docs and configs) runs on each lane (``lanes``)
    and on the mesh at each shape of phase 23 (a) (``mesh``, from
    ``mesh_kernel_counts``), counted by ``cuda_kernels_per_call`` in this
    (fresh) process; the mega-kernel, one launch by construction, must
    count 1, else every count is None."""
    import torch

    from authorino_tpu_torch.compiler import compile_corpus
    from authorino_tpu_torch.compiler.encode import encode_batch
    from authorino_tpu_torch.compiler.pack import pack_batch
    from authorino_tpu_torch.models import northstar
    from authorino_tpu_torch.ops import fused_kernel as fk

    dev = torch.device("cuda", 0)
    policy = compile_corpus(northstar.build_corpus(1000, 10), members_k=16)
    docs = northstar.build_docs(256, seed=7)
    rng = random.Random(3)
    rows = [policy.config_ids[f"cfg-{rng.randrange(1000)}"] for _ in docs]
    db = pack_batch(policy, encode_batch(policy, docs, rows))
    params = lane_params(policy, dev)
    from authorino_tpu_torch.ops.operands import fuse_batch

    buf, layout = fuse_batch(db)
    out = torch.empty((256, fk.packed_width(1 + 2 * int(
        policy.eval_rule.shape[1]))), dtype=torch.uint8, device=dev)
    fns = lane_fns(params, torch.from_numpy(buf).to(dev), layout, out)
    counts = {"megakernel": cuda_kernels_per_call(fns.pop("megakernel"))}
    counts.update({k: cuda_kernels_per_call(fn) for k, fn in fns.items()})
    del fns, params, out
    mesh = mesh_kernel_counts(dev)
    if counts["megakernel"] != 1:
        counts, mesh = dict.fromkeys(counts), dict.fromkeys(mesh)
    print(json.dumps({"lanes": counts, "mesh": mesh}))


def wide_and_policy(width: int):
    """A planted corpus: one config of three evaluators, an And of
    ``width`` EQ children and Ands of ``P22_NARROW`` children in its level
    (the compiler pads each to ``width`` with TRUE: level-matrix counts of
    ``width - 5`` and ``width - 3``, which bf16 cannot hold past 256 nor
    TF32 past 2^11), its constants interned past ``P22_PREFILL`` fillers
    (ids >= 2^11); and 20 requests: every child true, one child false in
    each And in turn, no attributes."""
    from authorino_tpu_torch.compiler import ConfigRules, compile_corpus
    from authorino_tpu_torch.compiler.encode import encode_batch
    from authorino_tpu_torch.compiler.intern import StringInterner
    from authorino_tpu_torch.compiler.pack import pack_batch
    from authorino_tpu_torch.expressions import All, Operator, Pattern

    interner = StringInterner()
    for i in range(P22_PREFILL):
        interner.intern(f"filler-{i}")
    evaluators = [(None, All(*[
        Pattern(f"auth.identity.k{j}", Operator.EQ, f"v{j}")
        for j in range(width)]))] + [
        (None, All(*[Pattern(f"auth.identity.n{n}_{j}", Operator.EQ, f"w{j}")
                     for j in range(n)])) for n in P22_NARROW]
    policy = compile_corpus([ConfigRules(name="wide", evaluators=evaluators)],
                            members_k=4, interner=interner)
    full = {f"k{j}": f"v{j}" for j in range(width)}
    for n in P22_NARROW:
        full.update({f"n{n}_{j}": f"w{j}" for j in range(n)})
    off = [dict(full, k7="nope")] + [dict(full, **{f"n{n}_1": "nope"})
                                     for n in P22_NARROW]
    docs = [{"auth": {"identity": d}} for d in [full, *off, {}]] * 4
    return policy, pack_batch(policy, encode_batch(policy, docs,
                                                   [0] * len(docs)))


def wire_manifests(d: Path, n: int) -> None:
    """The wire corpus as AuthConfig manifests: ``cfg-i`` on host
    ``svc-i.bench``, an anonymous identity and config i's pattern (every
    request rides the native frontend's fast lane)."""
    from authorino_tpu_torch.models import wire_corpus as wc

    for i in range(n):
        (d / f"cfg-{i:04d}.json").write_text(json.dumps({
            "apiVersion": "authorino.kuadrant.io/v1beta2",
            "kind": "AuthConfig",
            "metadata": {"name": f"cfg-{i}", "namespace": "wire"},
            "spec": {"hosts": [wc.WIRE_HOST.format(i)],
                     "authentication": {"anon": {"anonymous": {}}},
                     "authorization": {"rules": {"patternMatching": {
                         "patterns": wc._rule_patterns(i, WIRE_RULES)}}}}}))


def lane_server(lane: str, d: Path, dev, payloads, oracle, n_checks: int,
                n_grpc: int) -> dict:
    """``run_server`` (the port's CLI) with ``--kernel-lane lane`` on the
    manifests in ``d``: ``n_checks`` ``engine.check()``s and ``n_grpc``
    gRPC Check()s through the native frontend's fast lane, every code the
    oracle's; ``auth_server_kernel_lane_total{lane}`` counts exactly the
    batches the engine and the frontend dispatched, and the mega-kernel
    launches none.  Returns the counts and times."""
    import grpc

    from authorino_tpu_torch import cli
    from authorino_tpu_torch.ops import fused_kernel as fk
    from authorino_tpu_torch.protos import wire
    from authorino_tpu_torch.protos.ext_authz import request_model_from_proto

    from authorino_tpu_torch.runtime.kernel_cost import LEDGER

    ports = {k: free_port() for k in ("grpc", "http", "oidc")}
    holder = {}

    def dispatched() -> int:
        """The native frontend's slots that reached a lane (the ledger
        counts one device computation for each)."""
        return LEDGER.snapshot("native")["launches"]

    async def drive():
        argv = ["server", "--watch-dir", str(d), "--kernel-lane", lane,
                "--ext-auth-grpc-port", str(ports["grpc"]),
                "--ext-auth-http-port", str(ports["http"]),
                "--oidc-http-port", str(ports["oidc"])]
        if dev.type != "cuda":
            argv += ["--device", "cpu"]
        args = cli.build_parser().parse_args(argv)
        t0 = time.perf_counter()
        task = asyncio.ensure_future(cli.run_server(
            args, on_engine=lambda e: holder.setdefault("engine", e)))
        while True:
            if task.done():
                task.result()
            if "engine" in holder:
                status, _, _ = await asyncio.to_thread(
                    http_call, ports["http"], "/readyz", timeout=2)
                if status == 200:
                    break
            if time.perf_counter() - t0 > 180:
                raise AssertionError(f"({lane}) the server never got ready")
            await asyncio.sleep(0.05)
        r = {"ready_s": time.perf_counter() - t0}
        engine = holder["engine"]
        from authorino_tpu_torch.ops import pattern_eval as pe

        if pe.kernel_lane_of(engine._snapshot.params) != lane:
            raise AssertionError(f"({lane}) the engine serves "
                                 f"{pe.kernel_lane_of(engine._snapshot.params)}")

        async def fe_stats():
            _, _, dv = await asyncio.to_thread(http_call, ports["http"],
                                               "/debug/vars")
            fe = json.loads(dv)["native_frontend"]
            if not fe.get("enabled"):
                raise AssertionError(f"({lane}) no native frontend: {fe}")
            return fe["stats"]

        c0 = prom_sample("kernel_lane", "auth_server_kernel_lane_total",
                         {"lane": lane})
        l0, rec0 = fk.launches, len(engine.batch_records)
        f0, n0 = await fe_stats(), dispatched()
        models = [request_model_from_proto(wire.decode_check_request(p))
                  for p in payloads[:n_checks]]
        t = time.perf_counter()
        res = await asyncio.gather(*(engine.check(m) for m in models))
        r["checks_per_s"] = n_checks / (time.perf_counter() - t)
        bad = sum(x.code != want for x, want in zip(res, oracle))
        async with grpc.aio.insecure_channel(
                f"127.0.0.1:{ports['grpc']}") as ch:
            call = ch.unary_unary(CHECK_METHOD)
            t = time.perf_counter()
            raws = await asyncio.gather(*(call(p, timeout=60)
                                          for p in payloads[:n_grpc]))
            r["grpc_checks_per_s"] = n_grpc / (time.perf_counter() - t)
        bad += sum(wire.decode_check_response(raw).status.code != want
                   for raw, want in zip(raws, oracle))
        s1 = await fe_stats()
        recs = list(engine.batch_records)[rec0:]
        if any(rec["launches"] or rec["plain_calls"] for rec in recs):
            raise AssertionError(f"({lane}) a batch reached the fused lane")
        eng_batches = sum(rec["device_rows"] > 0 for rec in recs)
        fe_batches = dispatched() - n0
        counted = prom_sample("kernel_lane", "auth_server_kernel_lane_total",
                              {"lane": lane}) - c0
        r.update({"bad": bad, "engine_batches": eng_batches,
                  "frontend_batches": fe_batches,
                  "fast": s1.get("fast", 0) - f0.get("fast", 0),
                  "slow": s1.get("slow", 0) - f0.get("slow", 0),
                  "lane_counted": counted,
                  "megakernel_launches": fk.launches - l0})
        task.cancel()
        try:
            await task
        except asyncio.CancelledError:
            pass
        return r

    r = asyncio.run(drive())
    if r["bad"]:
        raise AssertionError(f"({lane}) {r['bad']} codes differ from the "
                             f"oracle")
    if r["megakernel_launches"]:
        raise AssertionError(f"({lane}) the mega-kernel launched "
                             f"{r['megakernel_launches']} times")
    if r["lane_counted"] != r["engine_batches"] + r["frontend_batches"] \
            or r["lane_counted"] < 1:
        raise AssertionError(f"({lane}) kernel_lane_total counted "
                             f"{r['lane_counted']} for {r['engine_batches']} "
                             f"engine and {r['frontend_batches']} frontend "
                             f"batches")
    if n_grpc and r["fast"] != n_grpc:
        raise AssertionError(f"({lane}) {r['fast']} of {n_grpc} gRPC "
                             f"Check()s on the fast lane")
    return r


def analysis_cli(runs: dict) -> dict:
    """``python -m authorino_tpu_torch.analysis`` once per entry of
    ``runs`` ({label: (argv, exit codes allowed)}), the processes side by
    side: each one's exit code, wall seconds (its own) and the JSON report
    it printed."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root))

    def one(argv):
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "authorino_tpu_torch.analysis", *argv],
            cwd=str(root), env=env, capture_output=True, text=True,
            timeout=300)
        return proc, time.perf_counter() - t

    with ThreadPoolExecutor(len(runs)) as pool:
        done = {label: pool.submit(one, argv)
                for label, (argv, _) in runs.items()}
    out = {}
    for label, fut in done.items():
        proc, wall = fut.result()
        if proc.returncode not in runs[label][1]:
            raise AssertionError(f"(d) {label}: exit {proc.returncode}: "
                                 f"{proc.stdout[-1500:]} "
                                 f"{proc.stderr[-1500:]}")
        out[label] = {"rc": proc.returncode, "wall_s": wall,
                      "report": json.loads(proc.stdout)}
    return out


def kernel_lanes(report: dict, card: str, dev, cycles_per_ms: float,
                 ns: dict) -> tuple:
    """Phase 22: the gather and matmul lanes, the staged baseline and the
    analysis CLI on the card.  (a) on the north-star corpus (B = 256),
    phase 7's OPA and phase 8's Keycloak RBAC corpora, gather, matmul
    (bf16 operands on the card) and fused params on the card: the
    readbacks of the gather lane, the matmul lane, the staged baseline,
    the mega-kernel and its plain version byte-equal; then on two planted
    corpora (``wide_and_policy``: Ands of 300 and 2,100 children beside
    padded Ands of 5 and 3, one child false in each in turn; interner ids
    past 2^11) the same with TF32 switched on for the run.  (b) each
    lane's time (one call and back to back, in event pairs), its CUDA
    kernels per batch
    (``torch.profiler``) beside ``staged_launches``, and each lane's
    operand bytes on the card.  (c) ``run_server --kernel-lane matmul`` on
    the wire corpus: 4,096 ``engine.check()``s and 1,024 gRPC Check()s on
    the native fast lane, every code the oracle's, ``kernel_lane_total``
    counting the batches, the mega-kernel flat; ``--kernel-lane gather``
    with 1,024 checks on 250 of the configs; then ``auto`` on a card
    engine arms fused (``last_auto_decision()`` names only ``cuda``) and
    serves.  (d) the analysis CLI as four processes side by side:
    ``--self-lint --verify-fixtures``, ``--metrics-catalog``,
    ``--snapshot-diff`` over phase 21's two published generations,
    ``--replay`` of phase 20's capture across them.  Returns (the kernels' launches in (c), counts zeroed just
    before it; the byte error of (a)'s comparisons)."""
    import atexit
    import os
    import shutil
    import tempfile

    import torch

    from authorino_tpu_torch.models import wire_corpus as wc
    from authorino_tpu_torch.models.policy_model import host_results
    from authorino_tpu_torch.ops import fused_kernel as fk
    from authorino_tpu_torch.ops import pattern_eval as pe
    from authorino_tpu_torch.ops.operands import fuse_batch
    from authorino_tpu_torch.runtime import EngineEntry, PolicyEngine
    from authorino_tpu_torch.utils import rpc

    numbers = {"card": card}
    t_phase = time.perf_counter()
    # ---- (a) exactness across lanes ------------------------------------------
    corpora = {"northstar": (ns["policy"], ns["db"]),
               **{k: LANE_CORPORA[k] for k in ("opa", "keycloak")}}
    params_of = {}
    for name, (policy, db) in corpora.items():
        params = lane_params(policy, dev)
        mm = params["matmul"]["matmul"]
        if mm is None or mm["rule_m"].dtype != torch.bfloat16 \
                or mm["rule_m"].device.type != "cuda":
            raise AssertionError(f"(a) {name}: the matmul lane's operands")
        lane_readbacks(params, db, dev)
        params_of[name] = params
    planted = {}
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for width in P22_WIDTHS:
            wide, wdb = wide_and_policy(width)
            got = lane_readbacks(lane_params(wide, dev), wdb, dev)
            # own verdict, then each evaluator's rule bit, per request
            bits = [int(b) & 15 for b in got["matmul"][:5, 0]]
            if bits != [15, 12, 10, 6, 0]:
                raise AssertionError(f"(a) the planted Ands of {width}: "
                                     f"{bits}")
            planted[width] = {"max_id": int(wide.leaf_const.max()),
                              "bits": bits}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    numbers["exact"] = {"corpora": {k: int(db.attrs_val.shape[0])
                                    for k, (_, db) in corpora.items()},
                        "planted": {"widths": list(P22_WIDTHS),
                                    "narrow": list(P22_NARROW),
                                    "tf32": True, "corpora": planted}}
    log(f"kernel lanes (a): gather, matmul (bf16 operands), staged, "
        f"mega-kernel and plain byte-equal on {list(corpora)} at B=256, and "
        f"on planted Ands of {list(P22_WIDTHS)} children beside Ands of "
        f"{list(P22_NARROW)} padded in their level (ids to "
        f"{max(v['max_id'] for v in planted.values())}) with TF32 on")

    # ---- (b) the lanes' times, kernels per batch, operand bytes --------------
    policy, db = corpora["northstar"]
    params = params_of["northstar"]
    buf, layout = fuse_batch(db)
    buf_dev = torch.from_numpy(buf).to(dev)
    E = int(policy.eval_rule.shape[1])
    out = torch.empty((db.attrs_val.shape[0], fk.packed_width(1 + 2 * E)),
                      dtype=torch.uint8, device=dev)
    fns = lane_fns(params, buf_dev, layout, out)
    times = {}
    for name, fn in fns.items():
        one, host = device_times_ms(fn, P22_TIMED)
        n = P22_B2B_CALLS[name]
        b2b, covered = back_to_back_ms(fn, cycles_per_ms, n=n)
        times[name] = {"one_call_ms": statistics.median(one),
                       "back_to_back_ms": b2b, "back_to_back_calls": n,
                       "sleep_covered": covered, "host_enqueue_ms": host}
    staged_n = fk.staged_launches(params["fused"], db)
    op_bytes = {lane: tensor_bytes(p) for lane, p in params.items()}
    numbers["times"] = times
    numbers["staged_launches"] = staged_n
    numbers["operand_bytes"] = op_bytes
    log(f"[{card}] kernel lanes (b), north-star B=256: " + "; ".join(
        f"{k} {v['one_call_ms']:.4f} ms one call, {v['back_to_back_ms']:.4f} "
        f"ms back to back ({v['back_to_back_calls']} calls, the sleep "
        f"{'covered' if v['sleep_covered'] else 'did not cover'} the "
        f"enqueue)" for k, v in times.items())
        + f"; the staged ledger counts {staged_n} launches; operand bytes "
        f"{op_bytes}")

    # ---- (c) serving through the flag ----------------------------------------
    # (b)'s kernel count runs in a fresh process beside (c) and (d)
    root = Path(__file__).resolve().parent
    counter = subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; "
         "chip_smoke.lane_kernel_counts()"], cwd=str(root),
        env=dict(os.environ, PYTHONPATH=str(root)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    # a failure below ends the script: the count process ends with it
    atexit.register(lambda: counter.poll() is None and counter.kill())
    payloads = wc.wire_payloads(P22_CHECKS, WIRE_CONFIGS)
    oracle = [rpc.OK if wc.expected_allow(p, WIRE_RULES)
              else rpc.PERMISSION_DENIED for p in payloads]
    env_lane = os.environ.get("AUTHORINO_TPU_KERNEL_LANE")
    fk.reset_counts()
    reset_host_counts()
    servers = {}
    tmp_ctx = tempfile.TemporaryDirectory()
    try:
        d = Path(tmp_ctx.name)
        wire_manifests(d, P22_CONFIGS)
        servers["matmul"] = lane_server("matmul", d, dev, payloads, oracle,
                                        P22_CHECKS, P22_GRPC)
        for f in d.glob("cfg-*.json"):
            if int(f.stem.split("-")[1]) >= P22_GATHER_CONFIGS:
                f.unlink()
        g_pay = wc.wire_payloads(P22_GATHER, P22_GATHER_CONFIGS)
        servers["gather"] = lane_server(
            "gather", d, dev, g_pay,
            [rpc.OK if wc.expected_allow(p, WIRE_RULES)
             else rpc.PERMISSION_DENIED for p in g_pay], P22_GATHER, 0)
    finally:
        tmp_ctx.cleanup()
        # the CLI mirrors --kernel-lane into the environment
        if env_lane is None:
            os.environ.pop("AUTHORINO_TPU_KERNEL_LANE", None)
        else:
            os.environ["AUTHORINO_TPU_KERNEL_LANE"] = env_lane
    engine = PolicyEngine(max_batch=256, device=dev, **NO_REUSE)
    cfgs = ns["cfgs"]
    engine.apply_snapshot([EngineEntry(id=c.name, hosts=[c.name], rules=c)
                           for c in cfgs])
    dec = pe.last_auto_decision()
    if pe.kernel_lane_of(engine._snapshot.params) != "fused" or \
            dec is None or dec["platforms"] != ["cuda"] or \
            dec["lane"] != "fused":
        raise AssertionError(f"(c) auto on the card: {dec}")
    l0 = fk.launches
    out_a = asyncio.run(serve(engine, ns["docs"][:P22_AUTO],
                              ns["names"][:P22_AUTO]))
    policy_a = engine._snapshot.policy
    for (rule, skipped), doc, name in zip(out_a, ns["docs"], ns["names"]):
        own, w_rule, w_skip = host_results(policy_a, doc,
                                           policy_a.config_ids[name])
        if skipped.tolist() != w_skip.tolist() or \
                rule[~w_skip].tolist() != w_rule[~w_skip].tolist():
            raise AssertionError("(c) the auto engine's verdicts")
    launches = {"fused_megakernel": fk.launches,
                "probe_add_one": fk.probe_launches}
    if fk.launches - l0 < 1:
        raise AssertionError("(c) the auto engine did not launch")
    numbers["serving"] = servers
    numbers["auto"] = {"decision": dec, "submits": P22_AUTO,
                       "launches": launches}
    m, g = servers["matmul"], servers["gather"]
    log(f"[{card}] kernel lanes (c): --kernel-lane matmul ready in "
        f"{m['ready_s']:.1f} s, {P22_CHECKS} engine.check()s at "
        f"{m['checks_per_s']:.0f}/s and {P22_GRPC} gRPC Check()s on the "
        f"fast lane ({m['fast']} fast, {m['slow']} slow) at "
        f"{m['grpc_checks_per_s']:.0f}/s, all codes the oracle's; "
        f"kernel_lane_total{{lane=\"matmul\"}} +{m['lane_counted']} = "
        f"{m['engine_batches']} engine + {m['frontend_batches']} frontend "
        f"batches, mega-kernel +0; --kernel-lane gather "
        f"({P22_GATHER_CONFIGS} configs, ready in {g['ready_s']:.1f} s): "
        f"{P22_GATHER} checks at {g['checks_per_s']:.0f}/s, "
        f"+{g['lane_counted']} "
        f"batches, mega-kernel +0; auto armed fused over {dec['platforms']}"
        f": {P22_AUTO} submits exact, launches {launches}")

    # ---- (d) the analysis CLI on the card's machine ---------------------------
    gens = [str(Path("smoke_out") / f"p21-gen{k}") for k in (1, 2)]
    cap = Path("smoke_out") / "capture"
    if not cap.is_dir():
        raise AssertionError("(d) phase 20's capture is not on disk")
    cli = analysis_cli({
        "lint_fixtures": (["--self-lint", "--verify-fixtures", "--json"],
                          (0,)),
        "catalog": (["--metrics-catalog", "--json"], (0,)),
        "snapshot_diff": (["--snapshot-diff", *gens, "--json"], (0,)),
        "replay": (["--replay", *gens, "--log", str(cap), "--json"],
                   (0, 1))})
    if not (cli["lint_fixtures"]["report"]["ok"]
            and cli["catalog"]["report"]["ok"]):
        raise AssertionError(f"(d) the analysis CLI: {cli}")
    diff, rep = cli["snapshot_diff"], cli["replay"]
    if diff["report"]["configs"]["changed"] != [f"cfg-{P21_CHANGED}"]:
        raise AssertionError(f"(d) --snapshot-diff: {diff['report']}")
    flips = rep["report"]["flips"]
    if rep["rc"] != int(flips["total"] > 0) or any(
            g["authconfig"] != f"cfg-{P21_CHANGED}"
            for g in rep["report"]["by_rule"]):
        raise AssertionError(f"(d) --replay: {rep['rc']} {flips} "
                             f"{rep['report']['by_rule'][:4]}")
    stdout, stderr = counter.communicate(timeout=300)
    if counter.returncode != 0:
        raise AssertionError(f"(b) the kernel count: {stderr[-1500:]}")
    kernels = json.loads(stdout.strip().splitlines()[-1])
    for name, k in kernels["lanes"].items():
        times[name]["cuda_kernels"] = k
    # phase 23 (a)'s mesh, counted in the same fresh process
    numbers["mesh_cuda_kernels"] = kernels["mesh"]
    log(f"[{card}] kernel lanes (b), CUDA kernels per north-star batch "
        f"(torch.profiler, a fresh process): {kernels['lanes']}")
    numbers["cli"] = {k: {"rc": v["rc"], "wall_s": v["wall_s"]}
                      for k, v in cli.items()}
    numbers["cli"]["snapshot_diff"]["delta"] = diff["report"]["delta"]["mode"]
    numbers["cli"]["replay"]["flips"] = flips
    missing = rep["report"]["skipped"]["missing_config"]
    numbers["cli"]["replay"]["missing_config"] = missing
    shutil.rmtree(Path("smoke_out") / "p21-gen1", ignore_errors=True)
    shutil.rmtree(Path("smoke_out") / "p21-gen2", ignore_errors=True)
    numbers["phase_s"] = time.perf_counter() - t_phase
    report["kernel_lanes"] = numbers
    log(f"kernel lanes (d), four processes side by side: python -m "
        f"authorino_tpu_torch.analysis --self-lint --verify-fixtures exit 0 "
        f"in {cli['lint_fixtures']['wall_s']:.1f} s, --metrics-catalog exit "
        f"0 in {cli['catalog']['wall_s']:.1f} s; --snapshot-diff over phase "
        f"21's generations: {diff['report']['configs']['changed']} changed, "
        f"{diff['report']['delta']['mode']} upload, in "
        f"{diff['wall_s']:.1f} s; --replay of phase 20's capture: exit "
        f"{rep['rc']}, {flips} ({missing} records of configs the "
        f"generations lack) in "
        f"{rep['wall_s']:.1f} s; phase 22 took {numbers['phase_s']:.1f} s")
    return launches, 0


# ---------------------------------------------------------------------------
# phase 23: the mesh lane on logical slots of the card, and the fleet
# ---------------------------------------------------------------------------

P23_SHAPES = ((1, 1), (2, 1), (2, 2), (4, 2))   # (dp, mp): bench.py's defaults
P23_FAULT_SHAPE = (2, 2)    # (a): the shape the fault drives run on
P23_CHANGED = 11            # (a): the one config the delta changes
P23_BATCH_RUNS = 5          # (a): timed dispatches per shape (median)
P23_FAULT_BATCHES = 4       # (a): 256-row batches while slot 0 is down
P23_RESET_S = 30.0          # (a): the breakers' cooldown (elapsed by hand)
P23_REPLICAS = 3            # (b): replicas behind the router (and a leader)
P23_THREADS = 32            # (b): concurrent callers of FleetHarness.check
P23_GOODPUT = 1024          # (b): requests per goodput burst
P23_CRASH = 256             # (b): requests of the burst a replica dies in
P23_WARM = 512              # (b): the leader's requests the joiners replay
P23_HOT = 7                 # (b): the canary's poisoned config
P23_CANARY_ROUNDS = 12      # (b): rounds of traffic + folds + a tick
P23_TH = {"min_requests": 8, "min_config_requests": 4,
          "min_config_allows": 2, "min_tenant_attempts": 8}


def mesh_kernel_counts(dev) -> dict:
    """The CUDA kernels one 256-row north-star dispatch runs on the mesh
    at each (dp, mp) of ``P23_SHAPES`` over logical slots of ``dev``
    (phase 23 (a)'s configs, docs and names), by ``cuda_kernels_per_call``;
    run in phase 22's fresh count process (``lane_kernel_counts``)."""
    import numpy as np

    from authorino_tpu_torch.models import northstar
    from authorino_tpu_torch.parallel import ShardedPolicyModel, build_mesh

    cfgs = northstar.build_corpus(1000, 10)
    docs = northstar.build_docs(4096, seed=7)[:256]
    drng = random.Random(3)
    names = [f"cfg-{drng.randrange(1000)}" for _ in range(4096)][:256]
    counts = {}
    for dp, mp in P23_SHAPES:
        sh = ShardedPolicyModel(cfgs, build_mesh([dev] * (dp * mp), dp=dp),
                                members_k=16)
        enc = sh.encode(docs, names)
        counts[f"{dp}x{mp}"] = cuda_kernels_per_call(
            lambda: np.asarray(sh.dispatch_full(enc)))
        del sh, enc
    return counts


def _elapse_cooldown(*breakers) -> None:
    """Let each open breaker's cooldown elapse without a wall-clock wait
    (its state machine's own tests do the same): the drives then never
    race a short cooldown on a slow host."""
    for b in breakers:
        b._opened_at -= b.reset_s + 1.0


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _fleet_burst(h, docs, names, threads: int = P23_THREADS,
                 during=None) -> dict:
    """``docs`` through ``FleetHarness.check`` from ``threads`` callers;
    ``during(i)`` runs before request ``i`` is sent.  Every outcome is a
    verdict or a typed ``CheckAbort``: a raw exception fails the phase."""
    from concurrent.futures import ThreadPoolExecutor

    from authorino_tpu_torch.utils.rpc import CheckAbort

    out = [None] * len(docs)
    typed = []
    raw = []

    def one(i):
        if during is not None:
            during(i)
        try:
            out[i] = h.check(names[i], docs[i], timeout_s=60.0)
        except CheckAbort as e:
            typed.append((i, e.code))
        except Exception as e:  # noqa: BLE001 - counted, then fails
            raw.append((i, repr(e)))

    t = time.perf_counter()
    with ThreadPoolExecutor(max_workers=threads) as pool:
        list(pool.map(one, range(len(docs))))
    wall = time.perf_counter() - t
    if raw:
        raise AssertionError(f"raw exceptions out of the fleet: {raw[:3]}")
    return {"out": out, "typed": typed, "wall_s": wall,
            "ok": sum(o is not None for o in out)}


def _fleet_pipelined(h, docs, names) -> dict:
    """Every request placed by the fleet's router (its rendezvous choice
    with health, spillover and load-shift) and submitted to that replica
    at once, then gathered: the replicas' engines cut full batches, as
    behind a proxy with many connections.  A typed rejection fails the
    phase here (no replica is down in these bursts)."""
    from authorino_tpu_torch.fleet import routing_key

    t = time.perf_counter()
    futs = []
    for d, n in zip(docs, names):
        first, _ = h.router.route(routing_key(n, d))
        futs.append(h.replicas[first].check(n, d))
    out = [f.result(timeout=120) for f in futs]
    return {"out": out, "wall_s": time.perf_counter() - t, "ok": len(out)}


def _hot_docs(n: int, method: str, start: int = 0):
    """``n`` requests to config P23_HOT that allow at the base corpus (its
    method, its org), over distinct paths (the cohort hash input)."""
    return [{"request": {"method": method, "host": f"hot-{k}",
                         "path": f"/hot/p{k}", "url_path": f"/hot/p{k}"},
             "auth": {"identity": {"org": f"org-{P23_HOT}", "roles": [],
                                   "groups": []}}}
            for k in range(start, start + n)]


def mesh_and_fleet(report: dict, card: str, dev, ns: dict) -> tuple:
    """Phase 23: the rules-sharded mesh lane on logical slots of the card,
    and the fleet plane of card engines, at the north-star width (1,000
    configs x 10 rules).
    (a) for each (dp, mp) of ``P23_SHAPES``, an engine over
    ``build_mesh([card] * dp * mp, dp=dp)`` serves 4,096 north-star
    submits with verdict and attribution columns equal to a single-corpus
    card engine's (the mega-kernel path); one 256-row batch's [256, W]
    readback is byte-equal, every row, to the same shards run on the CPU
    (the op chain's plain run) and its columns equal the mega-kernel's
    where neither side sent a row to the host fallback; per batch: the
    dispatch's time, and its CUDA kernels (``torch.profiler``, counted by
    ``mesh_kernel_counts`` in phase 22's fresh count process).  On the 2x2 mesh: a one-config
    change ships bytes only to its owning shard; ``kernel:raise:device=0``
    opens slot 0's breaker while every batch fails over with zero
    undecided rows, and slot 0 rejoins after the fault ends; with every
    slot down the engine answers UNAVAILABLE, then recovers.  (b) a leader
    and 3 replicas (card engines installing the leader's blob) behind
    ``FleetRouter``: 4,096 north-star checks bit-exact with the single
    engine; goodput with 1, 2 and 3 replicas; a replica crashed
    mid-burst (typed rejections only); a cold joiner's warm-join timed
    against a cold join; a poisoned config canaried on one replica
    breaches the global guard and the fleet rolls back through the
    manifest (detection and MTTR).  Returns (the kernels' launches in (b),
    counts zeroed just before it; the byte error of (a)'s readbacks)."""
    import tempfile

    import numpy as np
    import torch

    from authorino_tpu_torch.compiler import compile_corpus
    from authorino_tpu_torch.compiler.encode import encode_batch
    from authorino_tpu_torch.compiler.pack import pack_batch
    from authorino_tpu_torch.fleet import FleetHarness
    from authorino_tpu_torch.models import northstar
    from authorino_tpu_torch.ops import fused_kernel as fk
    from authorino_tpu_torch.ops.operands import (to_device,
                                                  unpack_verdicts)
    from authorino_tpu_torch.ops.operands import _put
    from authorino_tpu_torch.parallel import build_mesh
    from authorino_tpu_torch.parallel.sharded_eval import _slice_tree
    from authorino_tpu_torch.runtime import EngineEntry, PolicyEngine
    from authorino_tpu_torch.runtime import faults
    from authorino_tpu_torch.runtime.change_safety import GuardThresholds
    from authorino_tpu_torch.utils.rpc import UNAVAILABLE

    numbers = {"card": card}
    t_phase = time.perf_counter()
    cfgs = ns["cfgs"]
    docs, names = ns["docs"], ns["names"]
    entries = [EngineEntry(id=c.name, hosts=[c.name], rules=c) for c in cfgs]

    def verdict_lists(out):
        return [(np.asarray(r).tolist(), np.asarray(s).tolist())
                for r, s in out]

    single = PolicyEngine(max_batch=256, device=dev, mesh=None,
                          tenant_qos=False, **NO_REUSE, **WIDE_ADMISSION)
    single.apply_snapshot(entries)
    want = verdict_lists(asyncio.run(serve(single, docs, names)))
    policy = compile_corpus(cfgs, members_k=16)
    rows = [policy.config_ids[n] for n in names[:256]]
    db = pack_batch(policy, encode_batch(policy, docs[:256], rows))
    E = int(policy.eval_rule.shape[1])
    mk = unpack_verdicts(fk.eval_fused_kernel(to_device(policy, device=dev),
                                              db).cpu().numpy(), 1 + 2 * E)

    # ---- (a) the mesh on logical slots --------------------------------------
    shapes = {}
    fault_engine = None
    for dp, mp in P23_SHAPES:
        label = f"{dp}x{mp}"
        mesh = build_mesh([dev] * (dp * mp), dp=dp)
        engine = PolicyEngine(max_batch=256, device=dev, mesh=mesh,
                              tenant_qos=False, breaker_threshold=3,
                              breaker_reset_s=P23_RESET_S, **NO_REUSE,
                              **WIDE_ADMISSION)
        t = time.perf_counter()
        engine.apply_snapshot(entries)
        install_s = time.perf_counter() - t
        sh = engine._snapshot.sharded
        if sh is None or sh.mesh.shape != {"dp": dp, "mp": mp}:
            raise AssertionError(f"(a) {label}: no mesh snapshot")
        t = time.perf_counter()
        got = verdict_lists(asyncio.run(serve(engine, docs, names)))
        serve_s = time.perf_counter() - t
        if got != want:
            bad = sum(g != w for g, w in zip(got, want))
            raise AssertionError(f"(a) {label}: {bad} of {len(want)} "
                                 f"verdicts differ from the single engine")
        enc = sh.encode(docs[:256], names[:256])
        on_card = np.asarray(sh.dispatch_full(enc))
        # the plain run: every block of the same shards on the CPU, from
        # the stacked host view, on the same 256 rows (uncounted)
        cpu = torch.device("cpu")
        t = time.perf_counter()
        cpu_trees = [_put(_slice_tree(sh.host_view, j), cpu)
                     for j in range(sh.n_shards)]
        plain, _ = sh._run_blocks(
            enc, [(0, i, j, cpu) for i in range(dp) for j in range(mp)],
            lambda j, _d: cpu_trees[j])
        plain = plain.numpy()
        plain_s = time.perf_counter() - t
        if on_card.shape != plain.shape or not np.array_equal(on_card,
                                                              plain):
            raise AssertionError(f"(a) {label}: the card's readback differs "
                                 f"from the plain op chain's")
        cols = unpack_verdicts(on_card, 1 + 2 * E)[:256]
        ok = ~(enc.host_fallback[:256] | db.host_fallback[:256])
        if not np.array_equal(cols[ok], mk[ok]):
            raise AssertionError(f"(a) {label}: columns differ from the "
                                 f"mega-kernel's")
        times = []
        for _ in range(P23_BATCH_RUNS):
            _sync(dev)
            t = time.perf_counter()
            np.asarray(sh.dispatch_full(enc))
            times.append((time.perf_counter() - t) * 1e3)
        shapes[label] = {
            "install_s": install_s, "serve_s": serve_s,
            "checks_per_s": len(docs) / serve_s,
            "batch_ms_median": statistics.median(times),
            "batch_ms": times, "plain_rows": int(on_card.shape[0]),
            "plain_s": plain_s,
            "lane": sh.kernel_lane, "members_k_eff": sh.members_k_eff,
            "host_fallback_rows": int(enc.host_fallback[:256].sum()),
            "upload_bytes": sh.upload_report["upload_bytes"],
            "per_shard_bytes": sh.upload_report["per_shard_bytes"]}
        log(f"[{card}] mesh (a) {label} on {dp * mp} logical slots of "
            f"{dev}: {len(docs)} submits equal to the single-corpus engine "
            f"(the mega-kernel path) in {serve_s:.3f} s "
            f"({len(docs) / serve_s:.0f} checks/s); the [256, W] readback's "
            f"{on_card.shape[0]} rows equal to the plain op chain's on the "
            f"CPU ({plain_s:.3f} s), and all 256 off the host-fallback rows "
            f"equal to the mega-kernel's; one 256-row dispatch "
            f"{statistics.median(times):.3f} ms median of "
            f"{P23_BATCH_RUNS} ({sh.kernel_lane} lane); install "
            f"{install_s:.3f} s, upload "
            f"{sh.upload_report['upload_bytes']} B")
        if (dp, mp) == P23_FAULT_SHAPE:
            fault_engine = engine
    numbers["shapes"] = shapes
    # the CUDA kernels per batch, counted in phase 22's fresh process
    # (after phase 12's profiler session a count in this one comes out
    # short); None where phase 22 did not run
    kernels = (report.get("kernel_lanes", {}).get("mesh_cuda_kernels")
               or dict.fromkeys(shapes))
    for label, k in kernels.items():
        shapes[label]["cuda_kernels_per_batch"] = k
    log(f"[{card}] mesh (a), CUDA kernels per 256-row dispatch "
        f"(torch.profiler, phase 22's fresh process): {kernels}")

    # one-config change on the 2x2 mesh: bytes only to the owning shard
    engine = fault_engine
    changed = northstar.build_corpus(len(cfgs), 10,
                                     changed={P23_CHANGED: "const"})
    engine.apply_snapshot([EngineEntry(id=c.name, hosts=[c.name], rules=c)
                           for c in changed])
    sh = engine._snapshot.sharded
    up = sh.upload_report
    owner = sh.locator[f"cfg-{P23_CHANGED}"][0]
    per_shard = up["per_shard_bytes"]
    if up["mode"] != "delta" or per_shard[str(owner)] <= 0 or any(
            b for s, b in per_shard.items() if s != str(owner)):
        raise AssertionError(f"(a) the one-config delta: {up}")
    numbers["delta"] = {"owner": owner, "per_shard_bytes": per_shard,
                        "upload_bytes": up["upload_bytes"],
                        "full_bytes": up["full_bytes"]}
    log(f"[{card}] mesh (a) 2x2: cfg-{P23_CHANGED} changed; bytes per shard "
        f"{per_shard} (owner shard {owner}), {up['upload_bytes']} B shipped "
        f"against a full upload of {up['full_bytes']} B")
    engine.apply_snapshot(entries)

    # slot 0 down: every batch fails over, slot 0 rejoins after
    state = engine._snapshot.sharded.state
    b0 = state.breakers.get(0)
    fo0 = state.failovers[0]
    fault_docs = northstar.build_docs(256 * P23_FAULT_BATCHES, seed=29)
    fault_names = [f"cfg-{(k * 13) % len(cfgs)}"
                   for k in range(len(fault_docs))]
    fault_want = verdict_lists(asyncio.run(serve(single, fault_docs,
                                                 fault_names)))
    st0 = dict(engine.stats)
    faults.FAULTS.arm("kernel:raise:device=0")
    try:
        got = []
        for k in range(P23_FAULT_BATCHES):
            part = slice(256 * k, 256 * (k + 1))
            got += verdict_lists(asyncio.run(serve(
                engine, fault_docs[part], fault_names[part])))
    finally:
        faults.FAULTS.disarm()
    if got != fault_want:
        raise AssertionError("(a) slot 0 down: verdicts differ")
    st1 = dict(engine.stats)
    undecided = st1["failed_batches"] - st0["failed_batches"]
    opened = b0.state
    if opened != "open" or undecided or state.failovers[0] <= fo0:
        raise AssertionError(f"(a) slot 0 down: breaker {b0.to_json()}, "
                             f"{undecided} failed batches")
    _elapse_cooldown(b0)
    l0 = state.launches[0]
    got = verdict_lists(asyncio.run(serve(engine, fault_docs[:1024],
                                          fault_names[:1024])))
    trail = [t["state"] for t in b0.to_json()["transitions"]]
    if got != fault_want[:1024] or b0.state != "closed" or \
            trail[-2:] != ["half-open", "closed"] or state.launches[0] <= l0:
        raise AssertionError(f"(a) slot 0's rejoin: {trail}")
    numbers["slot_down"] = {"batches": P23_FAULT_BATCHES,
                            "failovers": state.failovers[0] - fo0,
                            "undecided_batches": undecided,
                            "breaker_trail": trail}
    log(f"[{card}] mesh (a) 2x2, kernel:raise:device=0: "
        f"{P23_FAULT_BATCHES * 256} requests exact with "
        f"{state.failovers[0] - fo0} failovers and 0 undecided rows, slot "
        f"0's breaker {opened}; after the fault and its cooldown, slot 0 "
        f"rejoined "
        f"({' -> '.join(trail)}) and full-mesh launches resumed")

    # every slot down: UNAVAILABLE, then recovery
    faults.FAULTS.arm(";".join(f"kernel:raise:device={d}"
                               for d in state.device_ids))
    try:
        async def typed_burst():
            return await asyncio.gather(
                *(engine.submit(d, n) for d, n in
                  zip(fault_docs[:256], fault_names[:256])),
                return_exceptions=True)

        res = asyncio.run(typed_burst())
    finally:
        faults.FAULTS.disarm()
    codes = sorted({(type(r).__name__, getattr(r, "code", None))
                    for r in res})
    if codes != [("CheckAbort", UNAVAILABLE)]:
        raise AssertionError(f"(a) every slot down: {codes}")
    _elapse_cooldown(engine.breaker, *state.breakers.breakers.values())
    got = verdict_lists(asyncio.run(serve(engine, fault_docs[:256],
                                          fault_names[:256])))
    got += verdict_lists(asyncio.run(serve(engine, fault_docs[256:1024],
                                           fault_names[256:1024])))
    if got != fault_want[:1024]:
        raise AssertionError("(a) recovery after every slot down")
    numbers["all_down"] = {"requests": len(res), "answers": codes}
    log(f"[{card}] mesh (a) 2x2, every slot down: {len(res)} requests "
        f"answered UNAVAILABLE (no host oracle on a card), then exact again "
        f"after the breakers' cooldown")
    del engine, fault_engine

    # ---- (b) the fleet of card engines --------------------------------------
    fk.reset_counts()
    reset_host_counts()

    def factory():
        return PolicyEngine(max_batch=256, device=dev, strict_verify=True,
                            **WIDE_ADMISSION)

    tmp_ctx = tempfile.TemporaryDirectory()
    h = FleetHarness(str(Path(tmp_ctx.name) / "fleet"), factory,
                     poll_s=0.2)
    try:
        t = time.perf_counter()
        h.add_leader(entries=entries)
        leader_s = time.perf_counter() - t
        # the leader compiles and publishes; replicas serve
        h.router.remove_replica("leader")
        join_s = []
        goodput = {}
        for k in range(1, P23_REPLICAS + 1):
            t = time.perf_counter()
            h.add_replica(f"r{k}", warm_join=False)
            join_s.append(time.perf_counter() - t)
            g_docs = northstar.build_docs(P23_GOODPUT, seed=100 + k)
            g_names = [f"cfg-{(j * 7 + k) % len(cfgs)}"
                       for j in range(P23_GOODPUT)]
            b = _fleet_pipelined(h, g_docs, g_names)
            goodput[k] = b["ok"] / b["wall_s"]
        ratios = {k: goodput[k] / goodput[1] for k in goodput}
        b = _fleet_pipelined(h, docs, names)
        got = verdict_lists(b["out"])
        if got != want:
            bad = sum(g != w for g, w in zip(got, want))
            raise AssertionError(f"(b) {bad} fleet verdicts differ from the "
                                 f"single engine")
        routed = dict(h.router.outcomes)
        log(f"[{card}] fleet (b): leader installed {len(cfgs)} configs in "
            f"{leader_s:.2f} s (strict verify, publish); replicas joined in "
            f"{[round(s, 3) for s in join_s]} s; {len(docs)} north-star "
            f"checks through FleetRouter bit-exact with a single card engine "
            f"({b['ok'] / b['wall_s']:.0f} checks/s, all in flight); "
            f"goodput with 1, 2, 3 replicas "
            f"{[round(goodput[k]) for k in sorted(goodput)]} checks/s, "
            f"ratios to 1 {[round(ratios[k], 3) for k in sorted(ratios)]}; "
            f"routing "
            f"outcomes {routed}")

        # a replica crashed mid-burst: typed rejections only
        crash_docs = northstar.build_docs(P23_CRASH, seed=211)
        crash_names = [f"cfg-{(j * 3) % len(cfgs)}"
                       for j in range(P23_CRASH)]

        def crash_at(i):
            if i == P23_CRASH // 4:
                h.crash_replica("r2")

        fo = h.router.outcomes.get("failover", 0)
        cb = _fleet_burst(h, crash_docs, crash_names, during=crash_at)
        typed_codes = sorted({c for _, c in cb["typed"]})
        log(f"[{card}] fleet (b): r2 crashed a quarter into a "
            f"{P23_CRASH}-check burst ({P23_THREADS} callers of "
            f"FleetHarness.check): {cb['ok']} served, "
            f"{len(cb['typed'])} typed rejections (codes {typed_codes}), 0 "
            f"raw exceptions; {h.router.outcomes.get('failover', 0) - fo} "
            f"failovers to the second hash choice")
        h.remove_replica("r2", timeout_s=2.0)

        # warm join against cold join
        h.router.add_replica("leader", h.leader.health)
        _fleet_pipelined(h, docs[:P23_WARM], names[:P23_WARM])
        h.router.remove_replica("leader")
        if not h.publish_hotset(k=1024):
            raise AssertionError("(b) the leader published no hot set")
        t = time.perf_counter()
        cold = h.add_replica("cold", warm_join=False)
        cold_s = time.perf_counter() - t
        t = time.perf_counter()
        warm = h.add_replica("warm", warm_join=True)
        warm_s = time.perf_counter() - t
        hits = {}
        for name, rep in (("cold", cold), ("warm", warm)):
            vc = rep.engine._verdict_cache
            h0 = vc.hits
            for fut in [rep.check(n, d) for d, n in zip(docs[:P23_WARM],
                                                       names[:P23_WARM])]:
                fut.result(timeout=60)
            hits[name] = vc.hits - h0
        if warm.warm_imported <= 0 or hits["warm"] <= hits["cold"]:
            raise AssertionError(f"(b) warm join: {warm.warm_imported} "
                                 f"imported, hits {hits}")
        log(f"[{card}] fleet (b): cold join {cold_s:.3f} s, warm join "
            f"{warm_s:.3f} s ({warm.warm_imported} hot-set entries "
            f"imported); cache hits on the leader's first {P23_WARM} "
            f"requests: "
            f"cold {hits['cold']}, warm {hits['warm']}")

        # the fleet canary: a poisoned config canaried on r1
        method = next(p.value for p in cfgs[P23_HOT].evaluators[0][1]
                      .children if getattr(p, "selector", "")
                      == "request.method")
        poison = northstar.build_corpus(len(cfgs), 10,
                                        changed={P23_HOT: "method"})
        h.publish_folds()
        h.start_canary("r1", [EngineEntry(id=c.name, hosts=[c.name],
                                          rules=c) for c in poison],
                       changed={f"cfg-{P23_HOT}"},
                       thresholds=GuardThresholds(**P23_TH), fraction=0.5)
        rec = None
        rounds = 0
        for rnd in range(P23_CANARY_ROUNDS):
            hot = _hot_docs(128, method, start=128 * rnd)
            mix_docs = hot + list(docs[256 * rnd:256 * rnd + 128])
            mix_names = ([f"cfg-{P23_HOT}"] * len(hot)
                         + list(names[256 * rnd:256 * rnd + 128]))
            _fleet_pipelined(h, mix_docs, mix_names)
            h.publish_folds()
            rounds += 1
            rec = h.canary_tick()
            if rec is not None:
                break
        if rec is None:
            raise AssertionError(f"(b) the fleet canary never breached: "
                                 f"{h.aggregator.to_json()['guard']}")
        h.sync_replicas()
        man = json.loads((Path(tmp_ctx.name) / "fleet" / "MANIFEST.json")
                         .read_text())
        r1_rule, _ = h.replicas["r1"].check(
            f"cfg-{P23_HOT}", _hot_docs(1, method, start=99999)[0]
        ).result(timeout=60)
        if not bool(r1_rule[0]) or man.get("rollback", {}).get(
                "reason") != "fleet-guard-breach" or \
                man.get("quarantine", {}).get("configs") != \
                [f"cfg-{P23_HOT}"]:
            raise AssertionError(f"(b) the fleet rollback: {man.get('rollback')}"
                                 f" {man.get('quarantine')}")
        numbers["fleet"] = {
            "leader_install_s": leader_s, "join_s": join_s,
            "goodput_checks_per_s": goodput, "goodput_ratio": ratios,
            "routing": routed,
            "crash": {"served": cb["ok"], "typed": len(cb["typed"]),
                      "codes": typed_codes},
            "cold_join_s": cold_s, "warm_join_s": warm_s,
            "warm_imported": warm.warm_imported, "join_hits": hits,
            "canary": {"rounds": rounds, "guards": rec["breach"]["guards"],
                       "suspects": sorted(rec["breach"].get("suspects")
                                          or {}),
                       "detection_s": rec["detection_s"],
                       "mttr_s": rec["mttr_s"]}}
        log(f"[{card}] fleet (b): cfg-{P23_HOT}'s method flipped and "
            f"canaried on r1 (half the traffic pinned there): the global "
            f"guard breached after {rounds} rounds "
            f"({rec['breach']['guards']}, suspects "
            f"{sorted(rec['breach'].get('suspects') or {})}), detected in "
            f"{rec['detection_s']:.3f} s, rolled back fleet-wide through "
            f"the manifest in {rec['mttr_s']:.3f} s; r1 allows again")
    finally:
        h.shutdown(timeout_s=5.0)
        tmp_ctx.cleanup()
    launches = {"fused_megakernel": fk.launches,
                "probe_add_one": fk.probe_launches}
    if dev.type == "cuda" and (launches["fused_megakernel"] < 1
                               or launches["probe_add_one"] < 1):
        raise AssertionError(f"(b) launches {launches}")
    numbers["launches"] = launches
    numbers["phase_s"] = time.perf_counter() - t_phase
    report["mesh_and_fleet"] = numbers
    log(f"[{card}] phase 23 (b) launches: {launches['fused_megakernel']} "
        f"mega-kernel, {launches['probe_add_one']} probe; phase 23 took "
        f"{numbers['phase_s']:.1f} s")
    return launches, 0


# ---------------------------------------------------------------------------
# phase 24: the host lanes (brownout, lane selection, speculative dispatch)
# ---------------------------------------------------------------------------

P24_LONE = 64             # (a), (b): lone Check()s, one at a time


def host_lanes(report: dict, card: str, dev, ctx6: dict) -> tuple:
    """Phase 24, the host lanes: on a card they resolve off, on a CPU
    engine they are the reference's.  (a) A card engine at its defaults
    over phase 6's translated corpus (its compile cache: no config
    compiled again): phase 6's 4,096-Check() burst and 64 lone Check()s
    held to the oracle; lane selection and brownout off, no row on a host
    lane, by brownout or speculation, every cut counted device/disabled,
    one mega-kernel launch per batch with a device row, the cost model's
    device RTT EWMA fed from the card's batches; ``lane_select=True`` on a
    card raises, and the CLI refuses a host-lane tuning flag on a card.
    (b) CPU engines in this process (``device="cpu"``, the caller's
    choice) over the same corpus at the reference's defaults: the same
    burst (its 256-row cuts ride the kernel's plain version) and lone
    Check()s (the cost model's choice: the host lane), then the burst into
    a one-batch window (brownout decides rows), every verdict equal to
    (a)'s; no kernel launch in (b).  Returns ((a)'s kernel launch counts,
    counts zeroed just before it; 0, the phase holds no readback against
    plain)."""
    import numpy as np

    from authorino_tpu_torch import cli
    from authorino_tpu_torch.ops import fused_kernel as fk
    from authorino_tpu_torch.runtime import PolicyEngine
    from authorino_tpu_torch.runtime.lane_select import CARD_RULE

    entries, reqs, hold = ctx6["entries"], ctx6["reqs"], ctx6["hold"]
    cache = ctx6["engine"].compile_cache
    numbers = {"card": card}
    t_phase = time.perf_counter()

    def install(**kw):
        engine = PolicyEngine(max_batch=256, **kw)
        engine.compile_cache = cache   # phase 6's: nothing compiles again
        bind(entries, engine)
        engine.apply_snapshot(entries)
        rep = engine._snapshot.compile_report
        if rep is None or rep.compiled:
            raise AssertionError(f"phase 24 compiled again: {rep}")
        return engine

    async def lone(engine):
        return [(await timed_checks(engine, [r]))[0] for r in
                reqs[:P24_LONE]]

    def verdicts(out):
        return [(r.code, r.status, r.message, r.metadata) for r, _ in out]

    def p50_ms(out):
        return float(np.percentile([x for _, x in out], 50)) * 1e3

    # ---- (a) the card engine at its defaults: the counted window -------
    marks = failure_marks()
    fk.reset_counts()
    reset_host_counts()
    engine = install(device=dev)
    out_a = asyncio.run(timed_checks(engine, reqs))
    batch_p50 = float(np.percentile(engine.batch_latency_s, 50)) * 1e3
    lone_a = asyncio.run(lone(engine))
    launches = {"fused_megakernel": fk.launches,
                "probe_add_one": fk.probe_launches}
    hold(out_a, "host lanes (a)")
    hold(lone_a, "host lanes (a), lone")
    require_no_failure_handling("phase 24 (a)", marks)
    st = dict(engine.stats)
    recs = checked_records(engine)
    dv = engine.debug_vars()
    ls, bo = dv["lane_select"], dv["brownout"]
    device_batches = sum(1 for r in recs if r["device_rows"])
    if (ls["enabled"] or ls["speculative"] or bo["enabled"]
            or ls["rows"]["host"] or bo["decisions"]
            or ls["speculative_outcomes"]
            or st["host_lane_rows"] or st["brownout_rows"]
            or st["degraded_rows"]):
        raise AssertionError(f"(a) a card engine served a row off the "
                             f"mega-kernel: {ls} {bo} {st}")
    if ls["decisions"] != {"device:disabled": st["batches"]} or \
            ls["rows"]["device"] != st["rows"]:
        raise AssertionError(f"(a) cuts not all device/disabled: "
                             f"{ls['decisions']} {st}")
    if launches["fused_megakernel"] != device_batches or \
            st["launches"] != device_batches or \
            launches["probe_add_one"] < 1:
        raise AssertionError(f"(a) launches {launches} against "
                             f"{device_batches} batches with a device row")
    cost = ls["cost"]
    if not cost["device_rtt_ewma_s"] > 0 or \
            cost["device_batches"] != device_batches:
        raise AssertionError(f"(a) the cost model was not fed: {cost}")
    try:
        PolicyEngine(device=dev, lane_select=True)
        raise AssertionError("(a) lane_select=True on a card did not raise")
    except ValueError as e:
        if CARD_RULE not in str(e):
            raise
        refused = str(e)
    try:
        cli.refuse_unported(cli.build_parser().parse_args(
            ["server", "--device", "cuda", "--lane-host-max-rows", "8"]))
        raise AssertionError("(a) the CLI took --lane-host-max-rows on a "
                             "card")
    except SystemExit as e:
        if "--lane-host-max-rows" not in str(e):
            raise
        cli_refusal = str(e)
    numbers["card_engine"] = {
        "checks": len(out_a), "lone": len(lone_a), "stats": st,
        "decisions": ls["decisions"], "device_rtt_ewma_ms":
        cost["device_rtt_ewma_s"] * 1e3, "batch_p50_ms": batch_p50,
        "check_p50_ms": p50_ms(out_a), "lone_p50_ms": p50_ms(lone_a),
        "launches": launches, "refused": refused,
        "cli_refusal": cli_refusal}
    log(f"[{card}] host lanes (a), a card engine at its defaults: "
        f"{len(out_a)} + {len(lone_a)} lone Check()s equal the oracle; "
        f"lane_select and brownout enabled: false, 0 host-lane, brownout "
        f"and speculative rows; {st['batches']} cuts, all device/disabled; "
        f"{launches['fused_megakernel']} mega-kernel launches for "
        f"{device_batches} batches with a device row "
        f"({launches['probe_add_one']} probe at the install); the cost "
        f"model's device RTT EWMA {cost['device_rtt_ewma_s'] * 1e3:.3f} ms "
        f"beside the burst's batch p50 {batch_p50:.3f} ms; a lone Check() "
        f"p50 {p50_ms(lone_a):.3f} ms; lane_select=True raised; the CLI "
        f"refused --lane-host-max-rows 8 on a card")

    # ---- (b) CPU engines at the reference's defaults -------------------
    # their host-lane and brownout rows fold into the ledger's host lane;
    # nothing degrades and no breaker moves
    marks = failure_marks()
    l0 = fk.launches
    cpu = install(device="cpu")
    out_b = asyncio.run(timed_checks(cpu, reqs))
    dec_burst = dict(cpu.lanes.decisions)
    lone_b = asyncio.run(lone(cpu))
    dec_lone = {k: v - dec_burst.get(k, 0)
                for k, v in cpu.lanes.decisions.items()
                if v != dec_burst.get(k, 0)}
    st_b = dict(cpu.stats)
    brown = install(device="cpu", max_inflight_batches=1,
                    admission_min_cap=1 << 20)
    out_br = asyncio.run(timed_checks(brown, reqs))
    if fk.launches != l0:
        raise AssertionError(f"(b) a CPU engine launched the mega-kernel "
                             f"{fk.launches - l0} times")
    for label, got, want in (("burst", out_b, out_a),
                             ("lone", lone_b, lone_a),
                             ("brownout burst", out_br, out_a)):
        g, w = verdicts(got), verdicts(want)
        if g != w:
            k = next(i for i, (x, y) in enumerate(zip(g, w)) if x != y)
            raise AssertionError(f"(b) {label}: check {k} {g[k]} != the "
                                 f"card's {w[k]}")
    checked_records(cpu)
    checked_records(brown)
    moved = {k: v - marks[k] for k, v in failure_marks().items()}
    host_rows = st_b["host_lane_rows"] + brown.stats["host_lane_rows"] + \
        brown.stats["brownout_rows"]
    if moved != {"host_rows": host_rows, "degraded": 0, "transitions": 0}:
        raise AssertionError(f"(b) the ledger's host rows and the failure "
                             f"handling moved {moved}, host-lane and "
                             f"brownout rows {host_rows}")
    if (not cpu.lanes.enabled or not cpu.brownout
            or dec_burst.get("device:batch", 0) < 1 or st_b["plain_calls"] < 1
            or dec_lone.get("host:cost-model", 0) < 1
            or sum(dec_lone.values()) != len(lone_b)
            or brown._brownout_total < 1):
        raise AssertionError(f"(b) burst {dec_burst}, lone {dec_lone}, "
                             f"stats {st_b}, brownout rows "
                             f"{brown._brownout_total}")
    host_row_us = cpu.lanes.cost.host_row_s * 1e6
    numbers["cpu_engine"] = {
        "decisions_burst": dec_burst, "decisions_lone": dec_lone,
        "host_row_us": host_row_us, "stats": st_b,
        "check_p50_ms": p50_ms(out_b), "lone_p50_ms": p50_ms(lone_b),
        "cost": cpu.lanes.cost.to_json(),
        "brownout": {"rows": brown._brownout_total,
                     "decisions": dict(brown.lanes.decisions),
                     "stats": dict(brown.stats),
                     "check_p50_ms": p50_ms(out_br)}}
    numbers["launches"] = launches
    numbers["phase_s"] = time.perf_counter() - t_phase
    report["host_lanes"] = numbers
    log(f"[{card}] host lanes (b), CPU engines in this process at the "
        f"reference's defaults, every verdict equal to (a)'s: the burst's "
        f"cuts {dec_burst} ({st_b['plain_calls']} plain-version calls); "
        f"{len(lone_b)} lone Check()s {dec_lone}, host_row_s "
        f"{host_row_us:.1f} us per row on this host, lone p50 "
        f"{p50_ms(lone_b):.3f} ms with lane selection on against "
        f"{p50_ms(lone_a):.3f} ms on the card; a one-batch window's burst: "
        f"{brown._brownout_total} rows decided by brownout "
        f"({dict(brown.lanes.decisions)}); no mega-kernel launch; phase 24 "
        f"in {numbers['phase_s']:.1f} s")
    return launches, 0


# ---------------------------------------------------------------------------
# the side process: phases 10, 17, 18 and 21 beside the main process
# ---------------------------------------------------------------------------

SIDE_PHASES = ("10", "17", "18", "21")


def side_main(out_path: str) -> int:
    """Phases 10, 17, 18 and 21 in a process of their own.  They share no
    state with the main process's phases: each builds its corpora from its
    seeds (phase 17's and 18's requests and north-star documents are phase
    6's and 4's, rebuilt here from the same seeds) and loads the kernels
    the main process built into the checkout.  Writes their report
    sections, kernel launch counts, max abs byte error and phase seconds
    to ``out_path``; raises (exit non-zero) on a failed check, as the main
    process does."""
    import torch

    from authorino_tpu_torch.models import northstar
    from authorino_tpu_torch.runtime import faults
    from authorino_tpu_torch.runtime.flight_recorder import RECORDER

    if not torch.cuda.is_available():
        print("side process: no CUDA device is visible", file=sys.stderr)
        return 2
    RECORDER.configure(dump_dir=str(Path("smoke_out") / "flight-side"))
    t0 = time.monotonic()
    card = card_line()
    dev = torch.device("cuda", 0)
    report, launches, errs = {}, {}, {}
    docs = northstar.build_docs(4096, seed=7)
    drng = random.Random(3)
    ns = {"docs": docs, "names": [f"cfg-{drng.randrange(1000)}"
                                  for _ in docs]}
    ctx6 = {"reqs": northstar.build_check_requests(4096, 1000)}
    clock = PhaseClock()
    clock.start("10")
    marks = failure_marks()
    launches["10"], errs["10"] = control_plane(report, card, dev, ctx={})
    require_no_failure_handling("phase 10", marks)
    log_control_plane(report, card, launches["10"])
    clock.start("17")
    marks = failure_marks()
    launches["17"], errs["17"] = incremental_reconcile(report, card, dev,
                                                       ctx6, ns)
    require_no_failure_handling("phase 17", marks)
    clock.start("18")
    launches["18"], errs["18"] = change_safety(report, card, dev, ctx6, ns)
    clock.start("21")
    marks = failure_marks()
    launches["21"], errs["21"] = state_planes(report, card, dev, ns)
    require_no_failure_handling("phase 21", marks)
    clock.start(None)
    if faults.ACTIVE:
        raise AssertionError("the side process left the fault plane armed")
    Path(out_path).write_text(json.dumps({
        "report": report, "launches": launches,
        "max_err": max(errs.values()), "seconds": clock.seconds,
        "wall_s": time.monotonic() - t0}, default=str))
    return 0


class SideProcess:
    """``side_main`` started now in a child process (its log in
    ``smoke_out/side.log``), joined by ``join()``: its lines re-printed
    here, its exit checked, its output read.  A main process that fails
    first kills it on exit."""

    def __init__(self):
        import atexit
        import os

        Path("smoke_out").mkdir(exist_ok=True)
        self.out = Path("smoke_out") / "side.json"
        self.out.unlink(missing_ok=True)
        self.log_path = Path("smoke_out") / "side.log"
        root = Path(__file__).resolve().parent
        code = (f"import sys, chip_smoke as cs; "
                f"sys.exit(cs.side_main({str(self.out)!r}))")
        # a session of its own: a kill takes its own children with it
        with open(self.log_path, "w") as logf:
            self.proc = subprocess.Popen(
                [sys.executable, "-c", code], cwd=str(root),
                env=dict(os.environ, PYTHONPATH=str(root)), stdout=logf,
                stderr=subprocess.STDOUT, start_new_session=True)
        atexit.register(self.kill)
        log(f"side process {self.proc.pid} started: phases "
            f"{', '.join(SIDE_PHASES)}")

    def kill(self) -> None:
        import os
        import signal

        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.proc.wait()

    def join(self, timeout: float = 1200.0) -> dict:
        t = time.monotonic()
        try:
            rc = self.proc.wait(timeout=timeout)
        finally:
            self.kill()
        text = self.log_path.read_text(errors="replace")
        for line in text.splitlines():
            print(f"[side] {line}", flush=True)
        if rc != 0 or not self.out.exists():
            raise AssertionError(f"the side process exited {rc}: "
                                 f"{text[-3000:]}")
        out = json.loads(self.out.read_text())
        log(f"side process joined after a wait of "
            f"{time.monotonic() - t:.1f} s")
        return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    import numpy as np

    from authorino_tpu_torch.compiler import compile_corpus
    from authorino_tpu_torch.compiler.encode import encode_batch
    from authorino_tpu_torch.compiler.pack import pack_batch
    from authorino_tpu_torch.models import corpora, northstar
    from authorino_tpu_torch import native
    from authorino_tpu_torch.models.policy_model import host_results
    from authorino_tpu_torch.ops import _build
    from authorino_tpu_torch.ops import fused_kernel as fk
    from authorino_tpu_torch.ops import operands
    from authorino_tpu_torch.ops.operands import defuse, fuse_batch, to_device
    from authorino_tpu_torch.runtime import EngineEntry, PolicyEngine

    report = {}
    clock = PhaseClock()
    # the flight recorder is on by default, as the reference's: an anomaly
    # of any phase writes its bundle here, inside the checkout
    from authorino_tpu_torch.runtime.flight_recorder import RECORDER

    RECORDER.configure(dump_dir=str(Path("smoke_out") / "flight"))
    clock.start("1")
    # ---- 1. the card ------------------------------------------------------
    card = card_line()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    report["card"] = card
    report["torch"] = [torch.__version__, torch.version.cuda]
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | device 0: {kind}")

    clock.start("2")
    # ---- 2. build + probe -------------------------------------------------
    # the native encoder's g++ build runs beside the kernel's nvcc build
    import threading

    native_build = {}

    def build_native():
        t0 = time.monotonic()
        try:
            native.load_library()
        except BaseException as e:  # re-raised on the main thread
            native_build["error"] = e
        native_build["s"] = time.monotonic() - t0

    # phase 8's keys and tokens (pure Python) are made meanwhile: the
    # compilers leave this process's interpreter idle
    jwt_pre = {}

    def make_jwt_material():
        try:
            jwt_pre.update(jwt_material())
        except BaseException as e:  # re-raised on the main thread
            jwt_pre["error"] = e

    builder = threading.Thread(target=build_native, name="native-build")
    builder.start()
    minter = threading.Thread(target=make_jwt_material, name="jwt-mint")
    minter.start()
    t = time.monotonic()
    try:
        _build.load_library("fused_kernel")
    finally:
        builder.join()
        minter.join()
    if "error" in jwt_pre:
        raise jwt_pre["error"]
    report["build_s"] = time.monotonic() - t
    report["nvcc_s"] = _build.build_seconds("fused_kernel")
    log(f"built fused_kernel in {report['build_s']:.2f}s "
        f"(nvcc {report['nvcc_s']})")
    for line in _build.build_log("fused_kernel").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")
    fk.fused_kernel_supported(dev)
    log("probe kernel: int32[4] + 1 round-trips")
    if "error" in native_build:
        raise native_build["error"]
    report["native_build_s"] = native_build["s"]
    report["gxx_s"] = native.build_seconds()
    log(f"built the native encoder in {report['native_build_s']:.2f}s (g++ "
        f"{report['gxx_s']}) from authorino_tpu_torch/native/csrc")

    clock.start("3")
    # ---- 3. kernel vs plain on the card -----------------------------------
    max_err = 0
    n_cases = n_global = 0
    for seed in (7, 19, 31):
        cfgs = corpora.all_lanes_corpus(seed)
        docs = corpora.all_lanes_docs(seed, 64)
        drng = random.Random(seed)
        names = [drng.choice(cfgs).name for _ in docs]
        for assist in (True, False):
            policy = compile_corpus(cfgs, members_k=corpora.LANES_K,
                                    ovf_assist=assist)
            params = to_device(policy, device=dev)
            if not fk.tables_in_smem(params):
                raise AssertionError("all-lanes tables should fit in smem")
            rows = [policy.config_ids[n] for n in names]
            db = pack_batch(policy, encode_batch(policy, docs, rows))
            for d in (db, corpora.widen_wire(db)):
                max_err = max(max_err, kernel_vs_plain(params, d, dev))
                max_err = max(max_err, kernel_vs_plain(
                    params, d, dev, global_tables=True))
                n_cases += 1
                n_global += 1
    log(f"all-lanes corpus: {n_cases} cases byte-equal to plain, and "
        f"{n_global} with the global-tables instance forced (tolerance 0)")
    policy = compile_corpus(corpora.wide_config_corpus(),
                            members_k=corpora.LANES_K)
    params = to_device(policy, device=dev)
    docs = corpora.wide_config_docs()
    db = pack_batch(policy, encode_batch(policy, docs,
                                         [i % 2 for i in range(len(docs))]))
    for instance in ({}, {"global_tables": True}):
        max_err = max(max_err, kernel_vs_plain(params, db, dev, **instance))
    log("a config past 64 slots (shared-memory circuit) beside a small one: "
        "byte-equal to plain (tolerance 0)")

    t = time.monotonic()
    ns_cfgs = northstar.build_corpus(1000, 10)
    ns_policy = compile_corpus(ns_cfgs, members_k=16)
    ns_params = to_device(ns_policy, device=dev)
    report["northstar_compile_upload_s"] = time.monotonic() - t
    ns_tree = to_device(ns_policy, host=True)
    build_ms = []
    for _ in range(5):
        t = time.perf_counter()
        prog = operands._kernel_layout(ns_tree)
        build_ms.append((time.perf_counter() - t) * 1e3)
    prog_bytes = {k: int(v.nbytes) for k, v in prog.items()
                  if isinstance(v, np.ndarray)}
    kp = ns_params["kernel"]
    report["northstar_shapes"] = {
        "L": ns_policy.n_leaves, "A": ns_policy.n_attrs,
        "G": ns_policy.n_configs, "E": int(ns_policy.eval_rule.shape[1]),
        "levels": [list(c.shape) for c, _ in ns_policy.levels],
        "max_local": kp["max_local"],
        "smem_bytes": fk.smem_bytes(ns_params),
        "tables_in_smem": fk.tables_in_smem(ns_params),
        "dfa_rows": int(ns_policy.dfa_table_of_row.shape[0]),
        "dfa_tables": list(ns_policy.dfa_tables.shape),
        "program_bytes": prog_bytes,
        "program_bytes_total": sum(prog_bytes.values()),
        "program_build_ms_median": statistics.median(build_ms)}
    log(f"north-star corpus compiled + uploaded in "
        f"{report['northstar_compile_upload_s']:.1f}s: "
        f"{report['northstar_shapes']}")
    ns_docs = northstar.build_docs(4096, seed=7)
    drng = random.Random(3)
    ns_names = [f"cfg-{drng.randrange(1000)}" for _ in ns_docs]
    ns_rows = [ns_policy.config_ids[n] for n in ns_names]
    batches = {}
    for B in (16, 256):
        enc = encode_batch(ns_policy, ns_docs[:B], ns_rows[:B])
        for LB, trim in ((16, True), (64, False)):
            db = pack_batch(ns_policy, enc, trim_bytes=trim)
            if db.attr_bytes.shape[2] != LB:
                raise AssertionError(f"LB {db.attr_bytes.shape[2]} != {LB}")
            max_err = max(max_err, kernel_vs_plain(ns_params, db, dev))
            max_err = max(max_err, kernel_vs_plain(ns_params, db, dev,
                                                   global_tables=True))
            batches[(B, LB)] = db
    log("north-star corpus: B in {16, 256} x LB in {16, 64} byte-equal "
        "to plain (tolerance 0), with tables in shared memory and with the "
        "global-tables instance forced")

    clock.start("4")
    # ---- 4. the main path -------------------------------------------------
    marks = failure_marks()
    engine_entries = [EngineEntry(id=c.name, hosts=[c.name], rules=c)
                      for c in ns_cfgs]
    fk.reset_counts()
    reset_host_counts()
    engine = PolicyEngine(max_batch=256, **NO_REUSE)
    engine.apply_snapshot(engine_entries)
    t = time.monotonic()
    out = asyncio.run(serve(engine, ns_docs, ns_names))
    wall = time.monotonic() - t
    main_launches = {"fused_megakernel": fk.launches,
                     "probe_add_one": fk.probe_launches}
    st = dict(engine.stats)
    main_enc = encoder_used(engine, st["batches"])
    require_encoder("main path", main_enc, "native")
    policy = engine._snapshot.policy
    W = policy.fused_pack_w
    if not (st["launches"] == st["batches"] == fk.launches == 16
            == len(checked_records(engine))):
        raise AssertionError(f"launches {fk.launches} vs batches {st}")
    if st["d2h_bytes"] != st["pad_rows"] * W or st["pad_rows"] != 4096:
        raise AssertionError(f"D2H {st['d2h_bytes']} != pad x W ({st})")
    if fk.probe_launches < 1:
        raise AssertionError("probe kernel did not run on the main path")
    wrong = 0
    allowed = 0
    for (rule, skipped), d, r in zip(out, ns_docs, ns_rows):
        own, w_rule, w_skip = host_results(policy, d, r)
        ran = ~w_skip
        ok = (bool(np.all(skipped | rule)) == own
              and skipped.tolist() == w_skip.tolist()
              and rule[ran].tolist() == w_rule[ran].tolist())
        wrong += not ok
        allowed += own
    if wrong:
        raise AssertionError(f"{wrong} of 4096 verdicts differ from the oracle")
    report["main_path"] = dict(st, requests=4096, wall_s=wall,
                               allowed=int(allowed),
                               launches=main_launches, encoder=main_enc)
    log(f"main path: 4096 submits -> {st['batches']} batches, "
        f"{fk.launches} mega-kernel launches, {fk.probe_launches} probe, "
        f"D2H {st['d2h_bytes']} B = pad {st['pad_rows']} x W {W}; "
        f"all verdicts equal the oracle ({allowed} allowed); "
        f"{fmt_encoder(main_enc)}")

    require_no_failure_handling("phase 4", marks)

    clock.start("5")
    # ---- 5. numbers -------------------------------------------------------
    cycles_per_ms = sleep_cycles_per_ms()
    report["sm_clock_mhz"] = cycles_per_ms / 1e3
    log(f"[{card}] SM clock under a spin: {cycles_per_ms / 1e3:.0f} MHz")

    shapes = {}
    for (B, LB) in ((256, 16), (256, 64), (16, 16)):
        db = batches[(B, LB)]
        buf, layout = fuse_batch(db)
        buf_dev = torch.from_numpy(buf).to(dev)
        kout = torch.empty((B, W), dtype=torch.uint8, device=dev)
        fig = {}
        for name, global_tables in (("smem_tables", False),
                                    ("global_tables", True)):
            fn = (lambda g=global_tables: fk.launch_kernel(
                ns_params, buf_dev, layout, kout, global_tables=g))
            per_call, host = device_times_ms(fn, 100)
            b2b, covered = back_to_back_ms(fn, cycles_per_ms)
            fig[name] = {
                "per_call_ms": statistics.median(per_call),
                "per_call_ms_min": min(per_call), "host_enqueue_ms": host,
                "back_to_back_ms": b2b, "covered": covered}
        fig["stamps"] = stamp_phases(
            lambda stp: fk.launch_stamped(ns_params, buf_dev, layout, kout,
                                          stp),
            B, PHASES, cycles_per_ms / 1e3, dev)
        shapes[f"B{B}_LB{LB}"] = fig
        log(f"[{card}] v3 B={B} LB={LB}: " + "; ".join(
            f"{k} {v['per_call_ms']:.4f} ms/call {v['back_to_back_ms']:.4f} "
            f"ms back to back" for k, v in fig.items() if k != "stamps"))
        log(f"[{card}] v3 stamps B={B} LB={LB}: "
            f"{fmt_phases(fig['stamps'])}")
    report["v3_shapes"] = shapes

    db = batches[(256, 16)]
    buf, layout = fuse_batch(db)
    host_buf = torch.from_numpy(buf).pin_memory()
    buf_dev = host_buf.to(dev)
    kout = torch.empty((256, W), dtype=torch.uint8, device=dev)
    launch = (lambda: fk.launch_kernel(ns_params, buf_dev, layout, kout))
    k_ms, _ = device_times_ms(launch, 100)
    # the same wrapper with its words cache dropped before every launch:
    # each launch rebuilds the argument block and re-checks every param
    enq = enqueue_ms({
        "cached": launch,
        "rebuilt": lambda: (fk.forget_launch_words(ns_params), launch())})
    k_host, k_host_rebuilt = enq["cached"], enq["rebuilt"]
    k_b2b, _ = back_to_back_ms(launch, cycles_per_ms)
    p_ms, p_host = device_times_ms(
        lambda: fk.fused_packed_plain(ns_params, defuse(buf_dev, layout)), 30)
    host_out = torch.empty((256, W), dtype=torch.uint8, pin_memory=True)

    def transfer():
        buf_dev.copy_(host_buf, non_blocking=True)
        host_out.copy_(kout, non_blocking=True)

    x_ms, _ = device_times_ms(transfer, 100)
    # one batch through the wrapper as the engine calls it: stage, H2D,
    # launch, D2H into pinned memory, wait
    w_ms = wall_times_ms(
        lambda: np.asarray(fk.dispatch_megakernel(ns_params, db)), 100)
    moved, ops = kernel_work(ns_params, db)
    k_bound, k_by = bound_ms(moved, ops)
    probe_x = torch.arange(4, dtype=torch.int32, device=dev)
    pr_err = int((fk.launch_probe(probe_x) - fk.probe_plain(probe_x))
                 .abs().max().item())
    if pr_err != 0:
        raise AssertionError(f"probe kernel disagrees with plain by {pr_err}")
    pr_ms, pr_host = device_times_ms(lambda: fk.launch_probe(probe_x), 100)
    pr_b2b, _ = back_to_back_ms(lambda: fk.launch_probe(probe_x),
                                cycles_per_ms)
    prp_ms, _ = device_times_ms(lambda: fk.probe_plain(probe_x), 100)
    # the one PyTorch call that computes the probe's function
    prl_ms, _ = device_times_ms(lambda: probe_x + 1, 100)
    prl_b2b, _ = back_to_back_ms(lambda: probe_x + 1, cycles_per_ms)
    pr_bound, pr_by = bound_ms(32, 4)

    # engine throughput: TIMED_RUNS more 4,096-request runs on the warm
    # engine
    runs = []
    for _ in range(TIMED_RUNS):
        engine.batch_latency_s.clear()
        t = time.monotonic()
        asyncio.run(serve(engine, ns_docs, ns_names))
        runs.append((4096 / (time.monotonic() - t),
                     sorted(engine.batch_latency_s)))
    rates = [r for r, _ in runs]
    lat = sorted(x for _, ls in runs for x in ls)

    def pct(xs, q):
        return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]

    numbers = {
        "card": card,
        "kernel_ms_median": statistics.median(k_ms),
        "kernel_ms_min": min(k_ms),
        "kernel_launches_timed": len(k_ms),
        "kernel_back_to_back_ms": k_b2b,
        "kernel_host_enqueue_ms_median": k_host,
        "kernel_host_enqueue_rebuilt_ms_median": k_host_rebuilt,
        "plain_ms_median": statistics.median(p_ms),
        "plain_host_enqueue_ms_median": p_host,
        "h2d_d2h_ms_median": statistics.median(x_ms),
        "wrapper_batch_wall_ms_median": statistics.median(w_ms),
        "h2d_bytes": int(buf.size), "d2h_bytes": 256 * W,
        "kernel_bytes_moved": moved, "kernel_int_ops": ops,
        "bound_ms": k_bound, "bound_by": k_by,
        "probe_ms_median": statistics.median(pr_ms),
        "probe_back_to_back_ms": pr_b2b,
        "probe_host_enqueue_ms_median": pr_host,
        "probe_plain_ms_median": statistics.median(prp_ms),
        "probe_library_ms_median": statistics.median(prl_ms),
        "probe_library_back_to_back_ms": prl_b2b,
        "engine_decisions_per_s": rates,
        "engine_decisions_per_s_median": statistics.median(rates),
        "batch_latency_ms_p50": pct(lat, 0.50) * 1e3,
        "batch_latency_ms_p99": pct(lat, 0.99) * 1e3,
        "batches_timed": len(lat),
        "first_run_wall_s": wall,
    }
    report["numbers"] = numbers
    log(f"[{card}] mega-kernel B=256 LB=16: {numbers['kernel_ms_median']:.4f} "
        f"ms median of {len(k_ms)} one-call timings, {k_b2b:.4f} ms per "
        f"launch back to back (bound {k_bound:.7f} ms by {k_by}: "
        f"{moved} B, {ops} int ops); plain {numbers['plain_ms_median']:.3f} "
        f"ms; H2D {buf.size} B + D2H {256 * W} B "
        f"{numbers['h2d_d2h_ms_median']:.4f} ms; host enqueue of one launch "
        f"{k_host:.4f} ms (words rebuilt per launch: {k_host_rebuilt:.4f} "
        f"ms); one batch through the wrapper "
        f"{numbers['wrapper_batch_wall_ms_median']:.4f} ms wall")
    log(f"[{card}] probe: {numbers['probe_ms_median']:.4f} ms one-call, "
        f"{pr_b2b:.4f} ms per launch back to back; x + 1: "
        f"{numbers['probe_library_ms_median']:.4f} ms one-call, "
        f"{prl_b2b:.4f} ms back to back (bound {pr_bound:.9f} ms by "
        f"{pr_by})")
    log(f"[{card}] engine: {numbers['engine_decisions_per_s_median']:.0f} "
        f"decisions/s (runs {[round(r) for r in rates]}), batch latency "
        f"p50 {numbers['batch_latency_ms_p50']:.2f} ms p99 "
        f"{numbers['batch_latency_ms_p99']:.2f} ms over {len(lat)} batches")

    clock.start("6")
    # ---- 6. the Check() request path --------------------------------------
    ctx6 = {}
    marks = failure_marks()
    path_launches = request_path(report, card, ctx6)
    require_no_failure_handling("phase 6", marks)
    rp = report["request_path"]
    log(f"[{card}] request path: {rp['checks_per_s_median']:.0f} checks/s "
        f"median of {TIMED_RUNS} run(s) ({[round(r) for r in rp['checks_per_s']]}), "
        f"per-Check() latency p50 {rp['check_latency_ms_p50']:.2f} ms p99 "
        f"{rp['check_latency_ms_p99']:.2f} ms; {rp['batches_timed']} "
        f"batches, {rp['mean_rows_per_batch']:.1f} rows per batch; a lone "
        f"Check() p50 {rp['lone_check_latency_ms_p50']:.3f} ms p99 "
        f"{rp['lone_check_latency_ms_p99']:.3f} ms (200 one at a time); the "
        f"engine's submit alone in this run: "
        f"{numbers['engine_decisions_per_s_median']:.0f} decisions/s")

    clock.start("7")
    # ---- 7. the OPA request path ------------------------------------------
    marks = failure_marks()
    opa_launches, opa_err = opa_path(report, card, dev, cycles_per_ms)
    require_no_failure_handling("phase 7", marks)
    max_err = max(max_err, opa_err)
    op = report["opa_path"]
    log(f"[{card}] OPA path: {op['checks_per_s_median']:.0f} checks/s "
        f"median of {TIMED_RUNS} run(s) ({[round(r) for r in op['checks_per_s']]}; phase "
        f"6: {rp['checks_per_s_median']:.0f}), per-Check() latency p50 "
        f"{op['check_latency_ms_p50']:.2f} ms p99 "
        f"{op['check_latency_ms_p99']:.2f} ms; a lone Check() p50 "
        f"{op['lone_check_latency_ms_p50']:.3f} ms p99 "
        f"{op['lone_check_latency_ms_p99']:.3f} ms; {op['lowered']} of 1000 "
        f"configs lowered ({op['lowered_share']:.3f}); RegoModule.evaluate "
        f"{op['rego_evaluate_us_per_check']:.1f} us host per Check() "
        f"({op['rego_evaluate_us_per_call']:.1f} us per call, "
        f"{op['rego_evaluate_calls']} calls); mega-kernel on this corpus "
        f"B=256: {op['kernel_ms_median']:.4f} ms one call, "
        f"{op['kernel_back_to_back_ms']:.4f} ms back to back, bound "
        f"{op['bound_ms']:.7f} ms by {op['bound_by']} "
        f"({op['kernel_bytes_moved']} B, {op['kernel_int_ops']} int ops)")

    clock.start("8-9")
    # ---- 8. the JWT request path, 9. the serving core ---------------------
    # phase 8's fake Keycloak serves until phase 16 is done (its tokens and
    # entries are reused there); its serving thread is a daemon
    ctx = {"jwt_material": jwt_pre}
    marks = failure_marks()
    jwt_launches, jwt_err = jwt_path(report, card, dev, cycles_per_ms, ctx)
    require_no_failure_handling("phase 8", marks)
    core_launches, core_err = serving_core(report, card, dev, ctx)
    require_no_failure_handling("phase 9", marks)
    max_err = max(max_err, jwt_err, core_err)
    jp = report["jwt_path"]
    log(f"[{card}] JWT path: {jp['checks_per_s_median']:.0f} checks/s "
        f"median of {TIMED_RUNS} run(s) ({[round(r) for r in jp['checks_per_s']]}; phase "
        f"6 in this run: {rp['checks_per_s_median']:.0f}), per-Check() "
        f"latency p50 {jp['check_latency_ms_p50']:.2f} ms p99 "
        f"{jp['check_latency_ms_p99']:.2f} ms; a lone Check() p50 "
        f"{jp['lone_check_latency_ms_p50']:.3f} ms p99 "
        f"{jp['lone_check_latency_ms_p99']:.3f} ms; host per RS256 verify "
        f"{jp['rs256_verify_us']:.1f} us, per ES256 verify "
        f"{jp['es256_verify_us']:.1f} us, per ES256 wristband sign "
        f"{jp['es256_wristband_sign_us']:.1f} us; checked run: "
        f"{jp['stats_checked_run']['batches']} batches, "
        f"{jwt_launches['fused_megakernel']} launches, D2H "
        f"{jp['stats_checked_run']['d2h_bytes']} B; mega-kernel on this "
        f"corpus B=256: {jp['kernel_ms_median']:.4f} ms one call, "
        f"{jp['kernel_back_to_back_ms']:.4f} ms back to back, bound "
        f"{jp['bound_ms']:.7f} ms by {jp['bound_by']} "
        f"({jp['kernel_bytes_moved']} B, {jp['kernel_int_ops']} int ops)")

    sc = report["serving_core"]
    for key, label in (("default", "defaults (dedup, cache)"),
                       ("no_reuse", "dedup and cache off")):
        f = sc[key]
        log(f"[{card}] serving core, {label}: {f['checks_per_s_median']:.0f} "
            f"checks/s median of {TIMED_RUNS} run(s) "
            f"({[round(r) for r in f['checks_per_s']]}), per-Check() "
            f"latency p50 {f['check_latency_ms_p50']:.2f} ms p99 "
            f"{f['check_latency_ms_p99']:.2f} ms; a lone Check() p50 "
            f"{f['lone_check_latency_ms_p50']:.3f} ms p99 "
            f"{f['lone_check_latency_ms_p99']:.3f} ms; per run "
            f"{f['rows']} rows, {f['device_rows']} device rows, "
            f"{f['dedup_rows']} saved by dedup, {f['cache_rows']} by the "
            f"cache, {f['launches']} launches")
    b1 = sc["bursts"][0]
    log(f"[{card}] serving core, first (cold) burst: "
        f"{4096 / b1['wall_s']:.0f} checks/s, p50 "
        f"{sc['first_burst_check_latency_ms_p50']:.2f} ms p99 "
        f"{sc['first_burst_check_latency_ms_p99']:.2f} ms, "
        f"{b1['device_rows']} device rows of {b1['rows']}; phase 8 in this "
        f"run: {jp['checks_per_s_median']:.0f} checks/s, p50 "
        f"{jp['check_latency_ms_p50']:.2f} ms p99 "
        f"{jp['check_latency_ms_p99']:.2f} ms")

    # ---- 10, 17, 18, 21: the side process ---------------------------------
    # phases 10, 17, 18 and 21 share no state with the phases here: they
    # run in a process of their own, beside phases 11-16, 19 and 20, and
    # join before phase 22 reads phase 21's generations
    side = SideProcess()
    # phase 12's and 16's mTLS keys and certificates (seeded: phase 10
    # makes the same in the side process)
    cp_ctx = {"material": mtls_material()}

    clock.start("11")
    # ---- 11. the per-batch host work on either side of the launch ---------
    marks = failure_marks()
    host_work(report, card, ctx6,
              {"engine": engine, "entries": engine_entries, "docs": ns_docs,
               "names": ns_names},
              ns_policy, ns_docs, ns_rows, numbers["batch_latency_ms_p50"])
    require_no_failure_handling("phase 11", marks)

    clock.start("12")
    # ---- 12. the serving surfaces -----------------------------------------
    marks = failure_marks()
    serve_launches, serve_err = serving_surfaces(report, card, dev,
                                                 cp_ctx["material"])
    require_no_failure_handling("phase 12", marks)
    max_err = max(max_err, serve_err)
    sv = report["serving_surfaces"]
    sn, sb = sv["numbers"], sv["burst"]
    log(f"[{card}] serving surfaces: {sv['configs']} AuthConfigs ready in "
        f"{sv['bootstrap']['ready_s']:.2f}s; gRPC "
        f"{sn['checks_per_s_median']:.0f} checks/s over {SERVE_BURSTS} "
        f"timed burst(s) ({[round(r) for r in sn['checks_per_s']]}; "
        f"the first, cache cold: {sn['first_burst_checks_per_s']:.0f}), "
        f"burst p50 {sn['burst_latency_ms_p50']:.2f} ms p99 "
        f"{sn['burst_latency_ms_p99']:.2f} ms (first burst "
        f"{sn['first_burst_latency_ms_p50']:.2f} / "
        f"{sn['first_burst_latency_ms_p99']:.2f} ms); a lone gRPC Check() "
        f"p50 {sn['lone_latency_ms_p50']:.3f} ms p99 "
        f"{sn['lone_latency_ms_p99']:.3f} ms ({SERVE_LONE} one at a time); "
        f"rows per batch in the gRPC bursts "
        f"{[round(c['rows'] / max(1, c['batches']), 2) for c in sn['burst_batches']]}"
        f", launches {[c['launches'] for c in sn['burst_batches']]}; the same "
        f"requests into this engine's check() in process: "
        f"{sn['in_process_checks_per_s']:.0f} checks/s, p50 "
        f"{sn['in_process_latency_ms_p50']:.2f} ms p99 "
        f"{sn['in_process_latency_ms_p99']:.2f} ms, "
        f"{sn['in_process_batches']['rows'] / max(1, sn['in_process_batches']['batches']):.2f}"
        f" rows per batch (phase 10 (a)'s engine.check() figures are on "
        f"the side process's lines); codec host per Check(): "
        f"decode {sn['decode_us']:.1f} us + encode {sn['encode_us']:.1f} us "
        f"= {sn['codec_us_per_check']:.1f} us (CheckRequestModel "
        f"{sn['model_us']:.1f} us); first burst {sb['first_burst']}; "
        f"phase 12 launches: {serve_launches['fused_megakernel']} "
        f"mega-kernel, {serve_launches['probe_add_one']} probe; "
        f"/debug/profile during a fresh burst: {sn['debug_profile']}; "
        f"the native slow lane's admission after each burst "
        f"{sn['native_admission']}; {fmt_encoder(sv['encoder'])}")

    sp = sv["surfaces"]["planes"]
    log(f"observability planes (e), phase 12's server with --slo-ms "
        f"{SERVE_SLO_MS:g} and --flight-dir: /metrics carries all "
        f"{sp['families']} families of the planes; /debug/vars has the slo "
        f"({sp['slo_observed']} requests observed), flight_recorder "
        f"({sp['flight_events']} events), kernel_cost ({sp['ledger_launches']}"
        f" engine launches in the process) and control_plane "
        f"({sp['phases_ms']}) sections")

    clock.start("13")
    # ---- 13. the observability planes -------------------------------------
    marks = failure_marks()
    plane_launches, plane_err = observability_planes(report, card, dev, ctx6,
                                                     cycles_per_ms)
    require_no_failure_handling("phase 13", marks)
    max_err = max(max_err, plane_err)

    clock.start("14")
    # ---- 14. the failure handling -----------------------------------------
    fail_launches, fail_err = failure_handling(report, card, dev, ctx6)
    max_err = max(max_err, fail_err)
    from authorino_tpu_torch.runtime import faults

    if faults.ACTIVE:
        raise AssertionError("phase 14 left the fault plane armed")

    clock.start("15")
    # ---- 15. the native gRPC frontend -------------------------------------
    fe_launches, fe_err = native_frontend(report, card, dev)
    max_err = max(max_err, fe_err)
    if faults.ACTIVE:
        raise AssertionError("phase 15 left the fault plane armed")

    clock.start("16")
    # ---- 16. the verified-credential cache and the hybrid lane ------------
    marks = failure_marks()
    try:
        dyn_launches, dyn_err = dyn_frontend(report, card, dev, ctx,
                                             cp_ctx["material"])
    finally:
        ctx["idp"].stop()
    require_no_failure_handling("phase 16", marks)
    max_err = max(max_err, dyn_err)

    clock.start("19")
    # ---- 19. the tenant QoS plane -----------------------------------------
    marks = failure_marks()
    ten_launches, ten_err = tenancy(report, card, dev, ctx6,
                                    {"docs": ns_docs, "names": ns_names})
    max_err = max(max_err, ten_err)
    require_no_failure_handling("phase 19", marks)

    clock.start("20")
    # ---- 20. metadata prefetch, capture and the pregate, strict verify ----
    marks = failure_marks()
    vr_launches, vr_err = verify_and_replay(report, card, dev, ctx6)
    max_err = max(max_err, vr_err)
    require_no_failure_handling("phase 20", marks)

    # ---- the side process's phases join here: phase 22 reads phase 21's
    # kept generations
    clock.start("side join")
    side_out = side.join()
    report.update(side_out["report"])
    max_err = max(max_err, side_out["max_err"])
    side_launches = side_out["launches"]

    # ---- 22. the gather and matmul lanes, the analysis CLI ----------------
    clock.start("22")
    marks = failure_marks()
    kl_launches, kl_err = kernel_lanes(
        report, card, dev, cycles_per_ms,
        {"policy": ns_policy, "db": batches[(256, 16)], "cfgs": ns_cfgs,
         "docs": ns_docs, "names": ns_names})
    max_err = max(max_err, kl_err)
    require_no_failure_handling("phase 22", marks)

    # ---- 23. the mesh lane on card slots, the fleet -----------------------
    clock.start("23")
    mf_launches, mf_err = mesh_and_fleet(
        report, card, dev, {"cfgs": ns_cfgs, "docs": ns_docs,
                            "names": ns_names})
    max_err = max(max_err, mf_err)
    if faults.ACTIVE:
        raise AssertionError("phase 23 left the fault plane armed")

    # ---- 24. the host lanes: off on a card, the reference's on the CPU ----
    clock.start("24")
    hl_launches, hl_err = host_lanes(report, card, dev, ctx6)
    max_err = max(max_err, hl_err)
    clock.start(None)

    kernels = [
        {"name": "fused_megakernel", "route": "cuda",
         "source": "authorino_tpu_torch/ops/csrc/fused_kernel.cu",
         "replaces": "authorino_tpu/ops/fused_kernel.py:237",
         "launches": hl_launches["fused_megakernel"],
         "max_abs_err": max_err, "ms": numbers["kernel_ms_median"],
         "plain_ms": numbers["plain_ms_median"], "bound_ms": k_bound,
         "bound_by": k_by, "library_ms": None},
        {"name": "probe_add_one", "route": "cuda",
         "source": "authorino_tpu_torch/ops/csrc/fused_kernel.cu",
         "replaces": "authorino_tpu/ops/fused_kernel.py:259",
         "launches": hl_launches["probe_add_one"], "max_abs_err": pr_err,
         "ms": numbers["probe_ms_median"],
         "plain_ms": numbers["probe_plain_ms_median"], "bound_ms": pr_bound,
         "bound_by": pr_by,
         "library_ms": numbers["probe_library_ms_median"]},
    ]
    by_phase = {"4": main_launches, "6": path_launches, "7": opa_launches,
                "8": jwt_launches, "9": core_launches,
                "10": side_launches["10"],
                "12": serve_launches, "13": plane_launches,
                "14": fail_launches, "15": fe_launches, "16": dyn_launches,
                "17": side_launches["17"], "18": side_launches["18"],
                "19": ten_launches, "20": vr_launches,
                "21": side_launches["21"], "22": kl_launches,
                "23": mf_launches, "24": hl_launches}
    for k in kernels:
        k["launches_by_phase"] = {ph: c[k["name"]]
                                  for ph, c in by_phase.items()}
    for name in main_launches:
        if min(c[name] for c in by_phase.values()) < 1:
            raise AssertionError(
                f"{name} never launched on a path: {by_phase}")
    report["kernels"] = kernels
    report["phase_seconds"] = clock.seconds
    report["side_phase_seconds"] = side_out["seconds"]
    log(f"phase seconds: {json.dumps(clock.seconds)}; the side process "
        f"{json.dumps(side_out['seconds'])} in {side_out['wall_s']:.1f} s "
        f"from its start; whole script {time.monotonic() - T0:.1f} s")
    Path("smoke_out").mkdir(exist_ok=True)
    Path("smoke_out/chip_smoke.json").write_text(
        json.dumps(report, indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
