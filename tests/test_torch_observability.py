"""The port's observability planes against the reference's, on the CPU
(``device="cpu"``, the kernel's plain version).  Tolerance 0: every
compared value is an integer or a string.

- the cost ledger's ``engine`` lane: the same deltas as the reference
  engine's on the same seeded corpus and the same cuts (batches, launches,
  rows, device, pad, dedup and cache rows, H2D and D2H bytes);
- ``SloTracker`` and ``KeyedBurn``: equal ``to_json()`` on the same
  (n, bad, clock) feed;
- the flight recorder: the same ring and bundle for the same events, times
  masked; the anomaly set; disk retention; weak providers;
- the engine's hooks: the four pipeline stages, the batch families, the
  SLO fold (total, bad at a tiny and a huge target, errors), the
  recorder's swap, reconcile, watchdog and drain events, an OVERLOADED
  admission writing one bundle that holds the engine's ``kernel_cost``;
- the metric families of the planes: names, types, label names and
  buckets equal the reference's, each package read in a process of its
  own (both register in one registry when imported together)."""

import asyncio
import json
import os
import random
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
from prometheus_client import REGISTRY

from authorino_tpu.runtime import EngineEntry as RefEntry
from authorino_tpu.runtime import flight_recorder as ref_fr
from authorino_tpu.runtime.kernel_cost import LEDGER as REF_LEDGER
from authorino_tpu.utils import slo as ref_slo
from authorino_tpu_torch.models import northstar
from authorino_tpu_torch.models.policy_model import host_results
from authorino_tpu_torch.runtime import EngineEntry, PolicyEngine
from authorino_tpu_torch.runtime import flight_recorder as port_fr
from authorino_tpu_torch.runtime.kernel_cost import LEDGER
from authorino_tpu_torch.utils import slo as port_slo

from test_torch_compiler import (PORT, REF, all_lanes_corpus, all_lanes_docs,
                                 convert_config, northstar_corpus)
from test_torch_dedup_cache import ref_engine, with_repeats
from test_torch_dispatch import StubDevice, wait_until_sync

ROOT = Path(__file__).resolve().parent.parent


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def sample(name, labels):
    return REGISTRY.get_sample_value(name, labels) or 0.0


async def burst(engine, docs, names):
    return await asyncio.gather(*(engine.submit(d, n)
                                  for d, n in zip(docs, names)))


def engine_of(cfgs, **kw):
    kw.setdefault("max_batch", 64)
    engine = PolicyEngine(device="cpu", **kw)
    engine.apply_snapshot([EngineEntry(id=c.name, hosts=[c.name], rules=c)
                           for c in cfgs])
    return engine


LEDGER_KEYS = ("batches", "launches", "zero_launch_batches", "rows",
               "device_rows", "h2d_bytes", "d2h_bytes", "pad_rows",
               "pad_waste_rows", "dedup_avoided_rows", "cache_avoided_rows")


def ledger_delta(ledger, fn):
    before = ledger.snapshot("engine")
    out = fn()
    after = ledger.snapshot("engine")
    return out, {k: after[k] - before[k] for k in LEDGER_KEYS}


# ---- the cost ledger against the reference engine's ------------------------

@pytest.mark.parametrize("kind", ["lanes", "northstar"])
def test_ledger_engine_lane_equals_reference(kind):
    """Three cuts of at most max_batch rows (a fresh one with repeats, the
    same again, a mix of seen and new rows): each moves the two ledgers
    by the same counts, and the port's by its own batch records."""
    seed = 23
    if kind == "lanes":
        r_cfgs, p_cfgs = all_lanes_corpus(seed, REF), all_lanes_corpus(
            seed, PORT)
        k, docs = 4, all_lanes_docs(seed, 40)
    else:
        p_cfgs = northstar_corpus(PORT, 30)
        r_cfgs = [convert_config(c, REF) for c in p_cfgs]
        k, docs = 16, northstar.build_docs(40, seed=seed)
    rng = random.Random(seed)
    names = [rng.choice(p_cfgs).name for _ in docs]
    docs, names = with_repeats(docs, names, seed)
    fresh = all_lanes_docs(seed + 1, 12) if kind == "lanes" else docs[:12]
    cuts = [(docs[:48], names[:48]), (docs[:48], names[:48]),
            (docs[30:48] + fresh, names[30:48] + names[:12])]
    knobs = dict(verdict_cache_size=4096, batch_dedup=True, max_batch=64,
                 members_k=k)
    ref = ref_engine(**knobs)
    ref.apply_snapshot([RefEntry(id=c.name, hosts=[c.name], runtime=None,
                                 rules=c) for c in r_cfgs])
    port = engine_of(p_cfgs, **knobs)
    for ds, ns in cuts:
        want, r_delta = ledger_delta(REF_LEDGER, lambda: run(burst(ref, ds, ns)))
        n_rec = len(port.batch_records)
        got, p_delta = ledger_delta(LEDGER, lambda: run(burst(port, ds, ns)))
        assert wait_until_sync(lambda: port._inflight == 0)
        for (wr, ws), (gr, gs) in zip(want, got):
            assert np.asarray(wr).tolist() == gr.tolist()
            assert np.asarray(ws).tolist() == gs.tolist()
        assert p_delta == r_delta
        recs = list(port.batch_records)[n_rec:]
        assert len(recs) == p_delta["batches"] == 1
        rec = recs[0]
        assert p_delta["launches"] == rec["launches"] + rec["plain_calls"]
        assert (p_delta["rows"], p_delta["device_rows"], p_delta["pad_rows"],
                p_delta["dedup_avoided_rows"], p_delta["cache_avoided_rows"],
                p_delta["h2d_bytes"], p_delta["d2h_bytes"]) == (
            rec["rows"], rec["device_rows"], rec["pad_rows"],
            rec["dedup_rows"], rec["cache_rows"], rec["h2d_bytes"],
            rec["d2h_bytes"])
    assert port.stats["cache_rows"] > 0 and port.stats["dedup_rows"] > 0


def test_ledger_counts_into_the_launch_metrics():
    engine = engine_of(northstar_corpus(PORT, 10), verdict_cache_size=0)
    docs = northstar.build_docs(20, seed=3)
    names = [f"cfg-{i % 10}" for i in range(20)]
    labels = {"lane": "engine"}
    before = {m: sample(m, labels) for m in (
        "auth_server_kernel_launches_total",
        "auth_server_kernel_d2h_bytes_total",
        "auth_server_kernel_h2d_bytes_total",
        "auth_server_kernel_pad_waste_rows_total")}
    _, d = ledger_delta(LEDGER, lambda: run(burst(engine, docs, names)))
    got = {m: sample(m, labels) - v for m, v in before.items()}
    assert got == {
        "auth_server_kernel_launches_total": d["launches"],
        "auth_server_kernel_d2h_bytes_total": d["d2h_bytes"],
        "auth_server_kernel_h2d_bytes_total": d["h2d_bytes"],
        "auth_server_kernel_pad_waste_rows_total": d["pad_waste_rows"]}
    assert d["launches"] == d["batches"] == 1
    assert d["pad_waste_rows"] == 32 - 20


# ---- the SLO tracker -------------------------------------------------------

def slo_feed(mod, lane):
    """One seeded (n, bad, clock) feed through a tracker; its to_json at
    several instants, and its burn and window counts."""
    rng = random.Random(5)
    t0 = 1_700_000_000.0
    slo = mod.SloTracker(lane, slo_ms=25.0, objective=0.995)
    out = []
    for i in range(400):
        n = rng.randrange(0, 40)
        now = t0 + i * rng.choice((0.3, 1.0, 7.0, 45.0))
        if rng.random() < 0.1:
            slo.observe_errors(n, now=now)
        else:
            slo.observe(n, rng.randrange(0, n + 1), now=now)
        if i % 37 == 0:
            out.append(slo.to_json(now=now))
            out.append([slo.burn_rate(w, now=now) for w, _ in slo.windows])
            out.append(slo.window_counts(300, now=now + 100))
    out.append(slo.to_json(now=t0 + 1e6))
    return out


def test_slo_tracker_equals_reference():
    assert slo_feed(port_slo, "slo-parity-port") == slo_feed(
        ref_slo, "slo-parity-ref")
    assert port_slo.DEFAULT_WINDOWS == ref_slo.DEFAULT_WINDOWS


def keyed_feed(mod):
    rng = random.Random(9)
    kb = mod.KeyedBurn(window_s=30.0, objective=0.99, max_keys=6)
    out = []
    now = 100.0
    for i in range(300):
        now += rng.choice((0.1, 2.0, 16.0, 40.0))
        kb.fold(f"tenant-{rng.randrange(9)}", rng.randrange(0, 20),
                rng.randrange(0, 5), now=now)
        if i % 23 == 0:
            out.append(kb.to_json(top=4, now=now))
            out.append([kb.counts(f"tenant-{j}", now=now) for j in range(9)])
            out.append(kb.burn("tenant-1", now=now))
    return out


def test_keyed_burn_equals_reference():
    assert keyed_feed(port_slo) == keyed_feed(ref_slo)


# ---- the flight recorder ----------------------------------------------------

class Provider:
    def __init__(self, name):
        self.name = name

    def debug_vars(self):
        return {"name": self.name, "n": 3}

    def broken(self):
        raise RuntimeError("provider fault")


EVENTS = [("snapshot-swap", "engine", {"generation": 1, "configs": 4}),
          ("reconcile", "engine", {"generation": 1,
                                   "phases_ms": {"compile": 1.5}}),
          ("admission", "engine", {"state": "admit"}),
          ("drain", "engine", {"queue": 0, "inflight": 2}),
          ("custom", "", None)]


def masked(obj):
    """``obj`` with every time and pid masked (JSON round trip first)."""
    obj = json.loads(json.dumps(obj, default=str))

    def walk(x):
        if isinstance(x, dict):
            return {k: ("<t>" if k in ("t", "pid") else
                        "<dir>" if k == "dump_dir" else
                        len(v) if k == "dumps" else walk(v))
                    for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v) for v in x]
        return x

    return walk(obj)


def recorder_run(mod, tmp_path):
    rec = mod.FlightRecorder(capacity=16, dump_dir=str(tmp_path),
                             min_dump_interval_s=3600.0, keep=4)
    owner, broken = Provider("a"), Provider("b")
    rec.register_provider("engine", owner)
    rec.register_provider("broken", broken, "broken")
    for _ in range(5):
        for kind, lane, detail in EVENTS:
            rec.record(kind, lane=lane, detail=detail)
    bundle = rec.bundle("manual")
    path = rec.dump("manual")
    on_disk = json.loads(Path(path).read_text())
    del owner, broken   # the recorder holds providers weakly
    gone = rec.bundle("after")["vars"]
    return rec.to_json(), bundle, on_disk, gone, Path(path).name


def test_flight_recorder_ring_and_bundle_equal_reference(tmp_path):
    got = recorder_run(port_fr, tmp_path / "port")
    want = recorder_run(ref_fr, tmp_path / "ref")
    for g, w in zip(got[:4], want[:4]):
        g, w = masked(g), masked(w)
        for b in (g, w):
            if isinstance(b, dict) and "metrics" in b:
                assert "auth_server_flight_recorder_events_total" in \
                    b.pop("metrics")
        assert g == w
    assert got[0]["ring_depth"] == 16 and got[0]["events_recorded"] == 25
    assert got[1]["schema"] == port_fr.BUNDLE_SCHEMA == 1
    assert got[1]["vars"]["broken"] == {"error": "RuntimeError('provider "
                                                 "fault')"}
    assert got[3] == {}
    assert got[4].split("-")[:1] == want[4].split("-")[:1] == ["flight"]
    assert port_fr.ANOMALY_KINDS == ref_fr.ANOMALY_KINDS


def test_flight_recorder_disk_retention_bounded(tmp_path):
    fr = port_fr.FlightRecorder(capacity=64, dump_dir=str(tmp_path),
                                min_dump_interval_s=0.0, keep=3)
    for i in range(7):
        fr.dump(f"trigger-{i}")
        time.sleep(0.01)  # distinct mtimes for the prune ordering
    names = [n for n in os.listdir(tmp_path)
             if n.startswith("flight-") and n.endswith(".json")]
    assert len(names) == 3
    assert any("trigger-6" in n for n in names)
    assert not any("trigger-0" in n for n in names)
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


def test_anomaly_dumps_rate_limited_and_counted(tmp_path):
    fr = port_fr.FlightRecorder(dump_dir=str(tmp_path),
                                min_dump_interval_s=3600.0)
    before = sample("auth_server_flight_recorder_dumps_total",
                    {"trigger": "watchdog-timeout"})
    for _ in range(3):
        fr.record("watchdog-timeout", lane="engine")
    assert wait_until_sync(lambda: len(fr.dumps) == 1)
    time.sleep(0.05)
    assert len(fr.dumps) == 1 and len(os.listdir(tmp_path)) == 1
    assert sample("auth_server_flight_recorder_dumps_total",
                  {"trigger": "watchdog-timeout"}) - before == 1
    fr.configure(enabled=False)
    fr.record("watchdog-timeout")
    assert fr.events_total == 3


@pytest.mark.parametrize("uptime_s", [0.0, 5.0, 29.0])
def test_first_anomaly_dumps_on_a_freshly_booted_host(tmp_path, monkeypatch,
                                                      uptime_s):
    """The monotonic clock counts from the host's boot: on a host up for
    less than the dump interval, the first anomaly still writes its
    bundle; the second, inside the interval, does not."""
    clock = SimpleNamespace(monotonic=lambda: uptime_s, time=time.time)
    monkeypatch.setattr(port_fr, "time", clock)
    fr = port_fr.FlightRecorder(dump_dir=str(tmp_path),
                                min_dump_interval_s=30.0)
    fr.record("breaker-open", lane="engine")
    assert wait_until_sync(lambda: len(fr.dumps) == 1)
    fr.record("breaker-open", lane="engine")
    time.sleep(0.05)
    assert len(fr.dumps) == 1
    assert len([n for n in os.listdir(tmp_path) if n.endswith(".json")]) == 1


# ---- the engine's hooks -----------------------------------------------------

STAGES = ("encode", "launch", "device", "resolve")


def test_engine_exports_stages_and_batch_families():
    engine = engine_of(northstar_corpus(PORT, 10), verdict_cache_size=0,
                       batch_dedup=False)
    docs = northstar.build_docs(24, seed=4)
    names = [f"cfg-{i % 10}" for i in range(24)]
    lab = {"lane": "engine"}
    fams = ("auth_server_batch_size_count", "auth_server_batch_size_sum",
            "auth_server_batch_pad_occupancy_count",
            "auth_server_batch_queue_wait_seconds_count",
            "auth_server_device_dispatch_seconds_count",
            "auth_server_batch_host_fallback_count")
    before = {f: sample(f, lab) for f in fams}
    st_before = {s: sample("auth_server_pipeline_stage_seconds_count",
                           dict(lab, stage=s)) for s in STAGES}
    for _ in range(2):
        run(burst(engine, docs, names))
    assert wait_until_sync(lambda: engine._inflight == 0)
    for s in STAGES:
        assert wait_until_sync(lambda: sample(
            "auth_server_pipeline_stage_seconds_count",
            dict(lab, stage=s)) - st_before[s] == 2), s
    got = {f: sample(f, lab) - before[f] for f in fams}
    assert got == {"auth_server_batch_size_count": 2,
                   "auth_server_batch_size_sum": 48,
                   "auth_server_batch_pad_occupancy_count": 2,
                   "auth_server_batch_queue_wait_seconds_count": 48,
                   "auth_server_device_dispatch_seconds_count": 2,
                   "auth_server_batch_host_fallback_count": 2}
    assert sample("auth_server_snapshot_generation",
                  {"component": "engine"}) >= 1
    for phase in ("compile", "upload"):
        assert sample("auth_server_reconcile_phase_seconds_count",
                      {"phase": phase}) >= 1


@pytest.mark.parametrize("slo_ms,all_bad", [(1e-6, True), (10_000.0, False)])
def test_engine_folds_every_request_into_the_slo(slo_ms, all_bad):
    engine = engine_of(northstar_corpus(PORT, 10), slo_ms=slo_ms,
                       verdict_cache_size=0)
    docs = northstar.build_docs(40, seed=6)
    names = [f"cfg-{i % 10}" for i in range(40)]
    lab = {"lane": "engine"}
    c0 = (sample("auth_server_slo_observed_total", lab),
          sample("auth_server_slo_bad_total", lab))
    run(burst(engine, docs, names))
    assert wait_until_sync(lambda: engine.slo.total == 40)
    js = engine.debug_vars()["slo"]
    assert js["observed_total"] == js["windows"]["1m"]["total"] == 40
    assert js["bad_total"] == (40 if all_bad else 0)
    assert (sample("auth_server_slo_observed_total", lab) - c0[0],
            sample("auth_server_slo_bad_total", lab) - c0[1]) == (
        40, js["bad_total"])


def test_failed_batches_burn_the_slo_once():
    """A batch whose launch fails twice is degraded to the host oracle and
    feeds the SLO once, as the reference's ``_degrade_batch`` does: its
    requests are observed (within the 10 s target, so none bad), never
    burned as errors on top."""
    cfgs = northstar_corpus(PORT, 4)
    engine = engine_of(cfgs, slo_ms=10_000.0, max_batch=4)
    dev = StubDevice(engine, launch_error=RuntimeError("launch failed"))

    async def body():
        outs = await asyncio.gather(*(engine.submit({}, "cfg-0")
                                      for _ in range(3)),
                                    return_exceptions=True)
        return outs

    outs = run(body())
    policy = engine._snapshot.policy
    _, want, _ = host_results(policy, {}, policy.config_ids["cfg-0"])
    assert all(not isinstance(o, BaseException) and
               o[0].tolist() == want.tolist() for o in outs)
    assert dev.attempts == 2   # the batch and its one retry
    assert engine.stats["degraded_rows"] == 3
    js = engine.slo.to_json()
    assert (engine.slo.total, js["bad_total"]) == (3, 0)


def test_engine_records_lifecycle_events(tmp_path):
    saved = (port_fr.RECORDER.dump_dir, port_fr.RECORDER.min_dump_interval_s)
    port_fr.RECORDER.configure(dump_dir=str(tmp_path),
                               min_dump_interval_s=0.0)
    try:
        cfgs = northstar_corpus(PORT, 4)
        engine = engine_of(cfgs, device_timeout_s=0.05, max_batch=4)
        n0 = port_fr.RECORDER.events_total
        d0 = sample("auth_server_flight_recorder_dumps_total",
                    {"trigger": "watchdog-timeout"})
        engine.apply_snapshot([EngineEntry(id=c.name, hosts=[c.name],
                                           rules=c) for c in cfgs])
        StubDevice(engine)   # its readbacks never arrive

        async def body():
            # two watchdog fires, then the host oracle answers
            return await asyncio.wait_for(engine.submit({}, "cfg-0"), 30)

        rule, _ = run(body())
        policy = engine._snapshot.policy
        assert rule.tolist() == host_results(
            policy, {}, policy.config_ids["cfg-0"])[1].tolist()
        assert wait_until_sync(lambda: engine._inflight == 0)
        engine.begin_drain()
        tail = port_fr.RECORDER.to_json()["tail"]
        kinds = [e["kind"] for e in tail if e["lane"] == "engine"]
        assert kinds[-5:] == ["snapshot-swap", "reconcile",
                              "watchdog-timeout", "watchdog-timeout",
                              "drain"]
        assert port_fr.RECORDER.events_total - n0 == 5
        swap = [e for e in tail if e["kind"] == "snapshot-swap"][-1]
        assert swap["detail"] == {"generation": 2, "configs": 4}
        rec = [e for e in tail if e["kind"] == "reconcile"][-1]
        # the same corpus again: the compile cache reuses the installed
        # policy and params, so the reconcile has no diff or upload phase
        assert set(rec["detail"]["phases_ms"]) == {"compile"}
        cp = engine.debug_vars()["control_plane"]
        assert cp["generation"] == 2
        assert cp["kernel_cost"]["entries"]["fused_kernel"]["pad"] == 16
        # the watchdog is an anomaly: each fire writes a bundle (wait for
        # both dump threads, so none lands in a later test's directory)
        assert wait_until_sync(lambda: sample(
            "auth_server_flight_recorder_dumps_total",
            {"trigger": "watchdog-timeout"}) - d0 == 2)
        assert any("watchdog-timeout" in n for n in os.listdir(tmp_path))
    finally:
        port_fr.RECORDER.configure(dump_dir=saved[0],
                                   min_dump_interval_s=saved[1])


def test_overloaded_admission_writes_one_bundle(tmp_path):
    """Admission entering OVERLOADED writes one bundle (schema 1) with the
    engine's debug vars, its kernel_cost section among them, and an
    exposition whose engine launch count moved as the ledger's did."""
    saved = (port_fr.RECORDER.dump_dir, port_fr.RECORDER.min_dump_interval_s,
             port_fr.RECORDER.keep)
    port_fr.RECORDER.configure(dump_dir=str(tmp_path),
                               min_dump_interval_s=0.0, keep=2)
    try:
        engine = engine_of(northstar_corpus(PORT, 4))
        # both packages count into one registry here: compare deltas
        m0 = sample("auth_server_kernel_launches_total", {"lane": "engine"})
        l0 = LEDGER.snapshot("engine")["launches"]
        run(burst(engine, northstar.build_docs(4, seed=1),
                  [f"cfg-{i}" for i in range(4)]))
        assert wait_until_sync(lambda: engine._inflight == 0)
        adm = engine.admission
        with adm._lock:
            adm._set_state("overloaded")
            adm._set_state("overloaded")   # no flip: no second event
        assert wait_until_sync(lambda: any(
            "admission-overloaded" in n for n in os.listdir(tmp_path)))
        with adm._lock:
            adm._set_state("admit")
        time.sleep(0.1)
        names = [n for n in os.listdir(tmp_path) if n.endswith(".json")]
        assert len(names) == 1
        bundle = json.loads((tmp_path / names[0]).read_text())
        assert bundle["schema"] == 1
        assert bundle["trigger"] == "admission-overloaded"
        dv = bundle["vars"]["engine"]
        assert dv["kernel_cost"]["modeled"]["current"]["entries"]
        launches = dv["kernel_cost"]["ledger"]["engine"]["launches"]
        line = [ln for ln in bundle["metrics"].splitlines()
                if ln.startswith('auth_server_kernel_launches_total{lane="engine"}')]
        assert float(line[0].split()[-1]) - m0 == launches - l0 == 1
        assert [e["kind"] for e in bundle["events"]][-1] == \
            "admission-overloaded"
    finally:
        port_fr.RECORDER.configure(dump_dir=saved[0],
                                   min_dump_interval_s=saved[1],
                                   keep=saved[2])


# ---- the metric families, each package in a process of its own -------------

FAMILIES = ("batch_size", "batch_pad_occupancy", "batch_queue_wait",
            "device_dispatch_duration", "batch_host_fallback",
            "pipeline_stage_duration", "reconcile_phase",
            "snapshot_generation", "kernel_launches", "kernel_h2d_bytes",
            "kernel_d2h_bytes", "kernel_pad_waste_rows",
            "kernel_modeled_flops_per_row", "slo_burn_rate", "slo_bad_total",
            "slo_observed_total", "flight_events", "flight_dumps",
            "state_write_failures", "circuit_state", "circuit_transitions",
            "degraded_decisions", "injected_faults", "compile_cache_events",
            "delta_upload_bytes", "full_upload_bytes", "canary_state",
            "snapshot_rollbacks", "quarantined_configs",
            "canary_guard_delta", "snapshot_distribution", "warm_restart",
            "snapshot_age", "fleet_warm_join", "corpus_records",
            "corpus_rows", "corpus_pregate", "corpus_synth")

DESCRIBE = """
import importlib, json, sys
m = importlib.import_module(sys.argv[1])
out = {}
for attr in %r:
    c = getattr(m, attr)
    out[attr] = [c._name, c._type, list(c._labelnames),
                 list(getattr(c, "_upper_bounds", []))]
print(json.dumps(out))
""" % (FAMILIES,)


@pytest.fixture(scope="module")
def families():
    def describe(module):
        proc = subprocess.run(
            [sys.executable, "-c", DESCRIBE, module], cwd=str(ROOT),
            env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True,
            text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        return json.loads(proc.stdout)

    return (describe("authorino_tpu_torch.utils.metrics"),
            describe("authorino_tpu.utils.metrics"))


@pytest.mark.parametrize("attr", FAMILIES)
def test_metric_family_equals_reference(families, attr):
    port, ref = families
    assert port[attr] == ref[attr]


def test_two_bundles_of_one_trigger_in_one_second_keep_both(tmp_path):
    """The reference names a bundle by its second, trigger and pid, so two
    anomalies of one trigger in one second share a name (and, written at
    once, a temporary file: one is lost).  The port's first bundle keeps
    the reference's name; the second, in the same second, takes a suffix,
    and both land whole."""
    rec = port_fr.FlightRecorder(dump_dir=str(tmp_path),
                                 min_dump_interval_s=0.0)
    real = rec.bundle

    def same_second(trigger):
        b = real(trigger)
        b["t"] = 1_700_000_000.25
        return b

    rec.bundle = same_second
    paths = [rec.dump("watchdog-timeout") for _ in range(3)]
    base = f"flight-1700000000-watchdog-timeout-{os.getpid()}"
    assert [os.path.basename(p) for p in paths] == [
        f"{base}.json", f"{base}-1.json", f"{base}-2.json"]
    for p in paths:
        assert json.loads(Path(p).read_text())["trigger"] == \
            "watchdog-timeout"
    # another second: the reference's name again
    rec.bundle = real
    assert "-watchdog-timeout-%d.json" % os.getpid() in \
        os.path.basename(rec.dump("watchdog-timeout"))
