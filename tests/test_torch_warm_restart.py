"""The port's durable state plane and warm restart against the JAX
package's.

The state plane persists the serving snapshot and the verdict cache's hot
set under ``--state-dir`` (the publisher with ``include_loaded``, the
hot-set export), and a restarted process warm-starts from that directory
alone, through the replica's admission gate, before any control plane
answers.  Each scenario of the reference's ``tests/test_warm_restart.py``
(the reader fuzz, the state plane, leader dominance, the SIGKILL harness)
runs through both packages on the same seeded corpus, and the observations
must be equal (tolerance 0).  The hot-set round trip and its mismatch
refusal are the reference's ``tests/test_fleet.py`` cases.

The kill harness runs the port's ``runtime/restart_harness.py`` with
``--device cpu`` in subprocesses; its table (every variant's verdicts,
keyed by the fingerprint digest) equals the reference harness's."""

from __future__ import annotations

import asyncio
import json
import os
import random
import signal
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

import authorino_tpu.corpus.store as r_store
import authorino_tpu.fleet.warmjoin as r_warmjoin
import authorino_tpu.replay.capture as r_capture
import authorino_tpu.runtime.restart_harness as r_harness
import authorino_tpu.snapshots.distribution as r_dist
import authorino_tpu_torch.corpus.store as p_store
import authorino_tpu_torch.fleet.warmjoin as p_warmjoin
import authorino_tpu_torch.replay.capture as p_capture
import authorino_tpu_torch.runtime.restart_harness as p_harness
import authorino_tpu_torch.snapshots.distribution as p_dist
from authorino_tpu.compiler import compile_corpus as r_compile
from authorino_tpu.runtime import EngineEntry as RefEntry
from authorino_tpu.runtime import PolicyEngine as RefEngine
from authorino_tpu.runtime.flight_recorder import RECORDER as R_RECORDER
from authorino_tpu.runtime.state_plane import StatePlane as RefStatePlane
from authorino_tpu.snapshots import rules_fingerprint as r_fingerprint
from authorino_tpu.snapshots import serialize_policy as r_serialize
from authorino_tpu_torch.compiler import compile_corpus as p_compile
from authorino_tpu_torch.runtime import EngineEntry, PolicyEngine
from authorino_tpu_torch.runtime.flight_recorder import RECORDER as P_RECORDER
from authorino_tpu_torch.runtime.state_plane import StatePlane
from authorino_tpu_torch.snapshots import rules_fingerprint as p_fingerprint
from authorino_tpu_torch.snapshots import serialize_policy as p_serialize

from test_torch_compiler import PORT as PORT_NS
from test_torch_compiler import REF as REF_NS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ref_engine(**kw):
    return RefEngine(members_k=4, mesh=None, lane_select=False,
                     kernel_lane="fused", **kw)


def port_engine(**kw):
    return PolicyEngine(members_k=4, device="cpu", **kw)


REF = SimpleNamespace(name="ref", ns=REF_NS, Entry=RefEntry, make=ref_engine,
                      Plane=RefStatePlane, dist=r_dist, warmjoin=r_warmjoin,
                      capture=r_capture, store=r_store, recorder=R_RECORDER,
                      compile=r_compile, fingerprint=r_fingerprint,
                      serialize=r_serialize)
PORT = SimpleNamespace(name="port", ns=PORT_NS, Entry=EngineEntry,
                       make=port_engine, Plane=StatePlane, dist=p_dist,
                       warmjoin=p_warmjoin, capture=p_capture, store=p_store,
                       recorder=P_RECORDER, compile=p_compile,
                       fingerprint=p_fingerprint, serialize=p_serialize)


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def sample(name, labels=None):
    from prometheus_client import REGISTRY

    v = REGISTRY.get_sample_value(name, labels or {})
    return 0.0 if v is None else v


def make_corpus(pkg, n=6, tag=""):
    ns = pkg.ns
    cfgs = []
    for i in range(n):
        rule = ns.All(
            ns.Pattern("request.method", ns.Operator.EQ,
                       ["GET", "POST"][i % 2]),
            ns.Any_(
                ns.Pattern("auth.identity.org", ns.Operator.EQ,
                           f"org-{i}{tag}"),
                ns.Pattern("auth.identity.roles", ns.Operator.INCL,
                           f"role-{i}"),
            ),
        )
        cfgs.append(ns.ConfigRules(name=f"cfg-{i}",
                                   evaluators=[(None, rule)]))
    return cfgs


def entries_of(pkg, cfgs):
    return [pkg.Entry(id=c.name, hosts=[c.name], runtime=None, rules=c)
            for c in cfgs]


def build(pkg, cfgs=None, **kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("verdict_cache_size", 4096)
    engine = pkg.make(**kw)
    if cfgs is not None:
        engine.apply_snapshot(entries_of(pkg, cfgs))
    return engine


def doc(i, method="GET"):
    return {"request": {"method": method, "url_path": "/x"},
            "auth": {"identity": {"org": f"org-{i}", "roles": []}}}


def decide(engine, d, cfg):
    r, s = run(engine.submit(dict(d), cfg))
    return np.asarray(r).tolist(), np.asarray(s).tolist()


def pump(engine, n):
    async def go():
        await asyncio.gather(*[engine.submit(doc(i % 6), f"cfg-{i % 6}")
                               for i in range(n)])

    run(go())


def seed_state_dir(pkg, d, cfgs=None, traffic=0):
    """A leader of ``pkg`` publishes its vetted snapshot (and, with
    ``traffic``, a warmed hot set) into ``d`` through the state plane's
    own write path."""
    leader = build(pkg, strict_verify=True)
    plane = pkg.Plane(leader, d)
    plane.start()
    leader.apply_snapshot(entries_of(pkg, cfgs or make_corpus(pkg)))
    assert plane.publisher.flush()
    if traffic:
        pump(leader, traffic)
        assert plane.export_hotset_once()
    return leader


def both_equal(scenario, tmp_path, *args):
    want = scenario(REF, str(tmp_path / "ref"), *args)
    got = scenario(PORT, str(tmp_path / "port"), *args)
    assert got == want
    return got


# ---- the readers under torn and corrupted bytes ----------------------------

def _mutations(blob, rng):
    """The reference's crash and corruption shapes: empty, a torn tail, a
    bit flip, garbage before and after, a bare prefix."""
    out = [b"", blob[:rng.randrange(1, len(blob))]]
    flip = bytearray(blob)
    i = rng.randrange(len(flip))
    flip[i] ^= 1 << rng.randrange(8)
    out.append(bytes(flip))
    out.append(b"\x00garbage\x00" + blob)
    out.append(blob + b"trailing-junk")
    out.append(blob[: len(blob) // 2])
    return out


def _outcome(fn, typed):
    """What one reader made of the bytes on disk: ``ok`` (with the keys of
    a document it loaded), ``none``, the typed rejection's class name, or
    the unhandled exception (which fails the contract)."""
    try:
        out = fn()
    except typed as e:
        return type(e).__name__
    except Exception as e:
        return f"UNHANDLED {type(e).__name__}: {e}"
    if out is None:
        return "none"
    if isinstance(out, dict):
        return ("ok", sorted(out))
    return "ok"


READERS = ("snapshot-blob", "manifest", "hotset", "capture", "corpus")


def reader_cases(pkg, d, snap_name, cap, corp):
    """``pkg``'s five readers over the artifacts in ``d``: (path, reader,
    its typed failure)."""
    return {
        "snapshot-blob": (
            os.path.join(d, snap_name),
            lambda p: pkg.dist.load_snapshot_blob(open(p, "rb").read()),
            (pkg.dist.SnapshotLoadError,)),
        "manifest": (os.path.join(d, "MANIFEST.json"),
                     lambda p: pkg.dist.load_latest(d),
                     (pkg.dist.SnapshotLoadError,)),
        "hotset": (os.path.join(d, "HOTSET.json"),
                   lambda p: pkg.dist.load_hotset(d), ()),
        "capture": (cap, pkg.capture.read_segment,
                    (pkg.capture.CaptureFormatError,)),
        "corpus": (corp, pkg.store.read_corpus_file,
                   (pkg.store.CorpusFormatError,)),
    }


class TestReaderFuzz:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    @pytest.mark.parametrize("reader", READERS)
    def test_each_reader_rejects_typed_or_serves_old(self, tmp_path,
                                                     reader, seed):
        """The port's plane writes a state dir; each mutation of one
        artifact (the same bytes for both) goes through the port's reader
        and the reference's: equal outcomes, every failure typed, the
        pristine bytes loading before and after."""
        rng = random.Random(seed)
        d = str(tmp_path)
        seed_state_dir(PORT, d, traffic=24)
        snap_name = json.load(open(os.path.join(d, "MANIFEST.json")))[
            "current"]
        cap = os.path.join(d, "seg.atpucap")
        corp = os.path.join(d, "c.atpucorp")
        rows = [{"authconfig": "cfg-0", "doc": {"i": i}, "rule_index": 0,
                 "lane": "device", "verdict": True} for i in range(8)]
        p_capture.write_segment(cap, rows)
        p_store.write_corpus(corp, rows)
        path, p_read, p_typed = reader_cases(PORT, d, snap_name, cap,
                                             corp)[reader]
        _, r_read, r_typed = reader_cases(REF, d, snap_name, cap,
                                          corp)[reader]
        pristine = open(path, "rb").read()
        got, want = [], []
        for blob in [pristine] + _mutations(pristine, rng) + [pristine]:
            with open(path, "wb") as f:
                f.write(blob)
            got.append(_outcome(lambda: p_read(path), p_typed))
            want.append(_outcome(lambda: r_read(path), r_typed))
        assert got == want
        assert not any(isinstance(o, str) and o.startswith("UNHANDLED")
                       for o in got), got
        assert got[0] != "none" and got[-1] == got[0]

    def test_the_port_reads_the_references_artifacts_and_back(self,
                                                              tmp_path):
        """Each package's five readers load the other's pristine
        artifacts: one container format on disk."""
        rows = [{"authconfig": "cfg-0", "doc": {"i": i}, "rule_index": 0,
                 "lane": "device", "verdict": True} for i in range(8)]
        for writer, reader in ((REF, PORT), (PORT, REF)):
            d = str(tmp_path / writer.name)
            seed_state_dir(writer, d, traffic=24)
            writer.capture.write_segment(os.path.join(d, "s.atpucap"), rows)
            writer.store.write_corpus(os.path.join(d, "c.atpucorp"), rows)
            loaded = reader.dist.load_latest(d)
            assert loaded.certified
            assert reader.dist.load_hotset(d)["entries"]
            assert reader.capture.read_segment(
                os.path.join(d, "s.atpucap"))[1] == rows
            assert reader.store.read_corpus_file(
                os.path.join(d, "c.atpucorp"))[1] == rows

    def test_corrupt_state_dir_is_typed_cold_start_not_a_boot_failure(
            self, tmp_path):
        def scenario(pkg, d):
            seed_state_dir(pkg, d)
            snap_name = json.load(open(os.path.join(d, "MANIFEST.json")))[
                "current"]
            blob_path = os.path.join(d, snap_name)
            with open(blob_path, "wb") as f:
                f.write(open(blob_path, "rb").read()[:100])  # torn blob
            engine = build(pkg, strict_verify=True)
            summary = pkg.Plane(engine, d).warm_start()
            snap = engine._snapshot
            return (summary["snapshot"], summary["hotset"],
                    summary["snapshot_error"],
                    snap is None or snap.policy is None)

        assert both_equal(scenario, tmp_path)[::3] == ("error", True)


# ---- the state plane: warm start, staleness, supersession -----------------

class TestStatePlane:
    def test_empty_dir_is_a_miss(self, tmp_path):
        def scenario(pkg, d):
            os.makedirs(d)
            engine = build(pkg, strict_verify=True)
            plane = pkg.Plane(engine, d)
            return plane.warm_start(), plane.serving_warm()

        assert both_equal(scenario, tmp_path) == (
            {"snapshot": "miss", "hotset": "miss"}, False)

    def test_warm_start_serves_before_any_control_plane(self, tmp_path):
        def scenario(pkg, d):
            leader = seed_state_dir(pkg, d, traffic=24)
            engine = build(pkg, strict_verify=True)
            plane = pkg.Plane(engine, d)
            engine.state_plane = plane
            summary = plane.warm_start()
            obs = {k: summary[k] for k in ("snapshot", "hotset",
                                           "hotset_imported",
                                           "hotset_skipped",
                                           "snapshot_generation")}
            obs["warm"] = (plane.serving_warm(), plane.stale_reason())
            obs["verdicts"] = [(decide(leader, doc(i), f"cfg-{i}"),
                                decide(engine, doc(i), f"cfg-{i}"))
                               for i in range(6)]
            sp = engine.debug_vars()["state_plane"]
            obs["vars"] = {k: sp[k] for k in ("serving_warm", "stale",
                                              "max_snapshot_age_s",
                                              "hotset_k", "hotset_s")}
            return obs

        obs = both_equal(scenario, tmp_path)
        assert obs["snapshot"] == "ok" and obs["hotset"] == "ok"
        assert obs["hotset_imported"] > 0 and obs["warm"] == (True, None)
        assert all(w == g for w, g in obs["verdicts"])
        assert obs["vars"]["serving_warm"] is True

    def test_stale_snapshot_degrades_not_fails(self, tmp_path):
        def scenario(pkg, d):
            seed_state_dir(pkg, d)
            mp = os.path.join(d, "MANIFEST.json")
            man = json.load(open(mp))
            man["published_unix"] = time.time() - 3600.0
            with open(mp, "w") as f:
                json.dump(man, f)
            rec = pkg.recorder
            old_dir = rec.dump_dir
            rec.configure(dump_dir=os.path.join(d, "flight"))
            try:
                engine = build(pkg, strict_verify=True)
                plane = pkg.Plane(engine, d, max_snapshot_age_s=60.0)
                summary = plane.warm_start()
                served = decide(engine, doc(0), "cfg-0")
                reason = plane.stale_reason()
                with rec._ring_lock:
                    kinds = [e["kind"] for e in rec._ring]
                return (summary["snapshot"], summary["snapshot_age_s"] > 60,
                        served[0][0], reason.split(",")[0],
                        "stale-snapshot" in kinds,
                        sample("auth_server_snapshot_age_seconds") > 60.0)
            finally:
                rec.configure(dump_dir=old_dir)

        assert both_equal(scenario, tmp_path) == (
            "stale", True, True, "stale snapshot", True, True)

    def test_fresh_blob_goes_stale_live_then_swap_clears(self, tmp_path):
        def scenario(pkg, d):
            seed_state_dir(pkg, d)
            engine = build(pkg, strict_verify=True)
            plane = pkg.Plane(engine, d, max_snapshot_age_s=0.2)
            obs = [plane.warm_start()["snapshot"]]
            time.sleep(0.25)
            obs.append((plane.stale_reason() or "").split(",")[0])
            engine.apply_snapshot(entries_of(pkg, make_corpus(pkg,
                                                              tag="-new")))
            obs += [plane.serving_warm(), plane.stale_reason(),
                    sample("auth_server_snapshot_age_seconds")]
            return obs

        assert both_equal(scenario, tmp_path) == [
            "ok", "stale snapshot", False, None, 0.0]

    def test_write_behind_round_trips_the_next_restart(self, tmp_path):
        def scenario(pkg, d):
            first = build(pkg, strict_verify=True)
            plane = pkg.Plane(first, d, hotset_k=64)
            plane.start()
            first.apply_snapshot(entries_of(pkg, make_corpus(pkg)))
            first.apply_snapshot(entries_of(pkg, make_corpus(pkg,
                                                             tag="-v2")))
            pump(first, 24)
            plane.shutdown(timeout_s=5.0)
            second = build(pkg, strict_verify=True)
            summary = pkg.Plane(second, d).warm_start()
            return (summary["snapshot"], summary["hotset_imported"],
                    [(decide(first, doc(i), f"cfg-{i}"),
                      decide(second, doc(i), f"cfg-{i}"))
                     for i in range(6)])

        snap, imported, pairs = both_equal(scenario, tmp_path)
        assert snap == "ok" and imported > 0
        assert all(w == g for w, g in pairs)


# ---- a reachable leader always beats local warm state ---------------------

PROBE = {"request": {"method": "GET", "url_path": "/x"},
         "auth": {"identity": {"org": "org-0", "roles": []}}}


class TestLeaderDominance:
    def test_newer_local_state_never_outranks_the_leader(self, tmp_path):
        def scenario(pkg, root):
            local, leader_dir = (os.path.join(root, "state"),
                                 os.path.join(root, "pub"))
            seed_state_dir(pkg, local,
                           cfgs=make_corpus(pkg, tag="-local-newer"))
            leader = seed_state_dir(pkg, leader_dir, cfgs=make_corpus(pkg))
            engine = build(pkg, strict_verify=True)
            plane = pkg.Plane(engine, local)
            obs = [plane.warm_start()["snapshot"],
                   decide(engine, PROBE, "cfg-0")]
            rep = pkg.dist.SnapshotReplica(engine, leader_dir, poll_s=0.1)
            obs += [rep.poll_once(), plane.serving_warm(),
                    decide(engine, PROBE, "cfg-0"),
                    decide(leader, PROBE, "cfg-0")]
            return obs

        obs = both_equal(scenario, tmp_path)
        assert obs[0] == "ok" and not obs[1][0][0]
        assert obs[2] is True and obs[3] is False
        assert obs[4][0][0] and obs[4] == obs[5]

    def test_unchanged_leader_digest_is_not_reapplied(self, tmp_path):
        def scenario(pkg, d):
            seed_state_dir(pkg, d)
            engine = build(pkg, strict_verify=True)
            pkg.Plane(engine, d).warm_start()
            rep = pkg.dist.SnapshotReplica(engine, d, poll_s=0.1)
            return rep.poll_once(), rep.poll_once()

        assert both_equal(scenario, tmp_path) == (True, False)

    def test_rollback_manifest_dominates_newer_local_blob(self, tmp_path):
        def scenario(pkg, root):
            local, leader_dir = (os.path.join(root, "state"),
                                 os.path.join(root, "pub"))
            seed_state_dir(pkg, local,
                           cfgs=make_corpus(pkg, tag="-local-newer"))
            leader = build(pkg, make_corpus(pkg), strict_verify=True)
            base_gen = leader.generation
            pub = pkg.dist.SnapshotPublisher(leader_dir)
            pub.publish_from_engine(leader)
            cand = make_corpus(pkg, tag="-retracted")
            pub.publish_blob(pkg.serialize(
                pkg.compile(cand, members_k=4),
                meta={"generation": base_gen + 1, "certified": True,
                      "fingerprints": {c.name: pkg.fingerprint(c)
                                       for c in cand},
                      "entries": [{"id": c.name, "hosts": [c.name]}
                                  for c in cand]}), base_gen + 1)
            leader._snapshot.change_safety = {
                "rollback": {"reason": "fleet-guard-breach",
                             "guards": ["config-deny-rate"]}}
            pub.publish_from_engine(leader)
            engine = build(pkg, strict_verify=True)
            obs = [pkg.Plane(engine, local).warm_start()["snapshot"]]
            rep = pkg.dist.SnapshotReplica(engine, leader_dir, poll_s=0.1)
            obs.append(rep.poll_once())
            man = json.load(open(os.path.join(leader_dir, "MANIFEST.json")))
            obs += [man["active_generation"] == base_gen,
                    (engine._snapshot.change_safety or {})["rollback"],
                    decide(engine, PROBE, "cfg-0")]
            return obs

        obs = both_equal(scenario, tmp_path)
        assert obs[:3] == ["ok", True, True]
        assert obs[3]["reason"] == "fleet-guard-breach"
        assert obs[4][0][0]


# ---- the hot set: export, import, refusal ----------------------------------

def org_corpus(pkg, orgs):
    ns = pkg.ns
    return [ns.ConfigRules(name=n, evaluators=[
        (None, ns.Pattern("auth.identity.org", ns.Operator.EQ, org))])
        for n, org in orgs.items()]


V1 = {f"c{i}": f"org-{i}" for i in range(6)}


def cdoc(j, org):
    return {"request": {"host": f"h{j}", "path": f"/p{j}", "method": "GET"},
            "auth": {"identity": {"org": org}}}


def serve(engine, docs_cfgs):
    async def go():
        return await asyncio.gather(
            *[engine.submit(dict(d), c) for d, c in docs_cfgs])

    return [(np.asarray(r).tolist(), np.asarray(s).tolist())
            for r, s in run(go())]


def leader_with_published(pkg, d):
    leader = build(pkg, org_corpus(pkg, V1), strict_verify=True)
    pub = pkg.dist.SnapshotPublisher(d)
    pub.publish_from_engine(leader)
    return leader, pub


def hotset_round_trip(pkg, d):
    leader, pub = leader_with_published(pkg, d)
    traffic = [(cdoc(j, f"org-{j % 6}"), f"c{j % 6}") for j in range(24)]
    serve(leader, traffic)
    digest = pkg.warmjoin.export_hotset(leader, k=64)
    pub.publish_hotset(digest)
    joiner = build(pkg, strict_verify=True)
    joiner.apply_published(pkg.dist.load_latest(d))
    obs = {"entries": len(digest["entries"]),
           "digest": {k: digest[k] for k in ("version", "generation",
                                             "interner")},
           "import": pkg.warmjoin.import_hotset(joiner,
                                                pkg.dist.load_hotset(d))}
    cache = joiner._verdict_cache
    h0, m0 = cache.hits, cache.misses
    obs["joiner"] = serve(joiner, traffic[:1])
    obs["hit"] = (cache.hits > h0, cache.misses == m0)
    obs["leader"] = serve(leader, traffic[:1])
    return obs


def test_hotset_roundtrip_imports_and_hits(tmp_path):
    obs = both_equal(hotset_round_trip, tmp_path)
    assert obs["entries"] > 0 and obs["import"] == (obs["entries"], 0)
    assert obs["hit"] == (True, True) and obs["joiner"] == obs["leader"]


def hotset_refusals(pkg, d):
    leader, _ = leader_with_published(pkg, d)
    serve(leader, [(cdoc(j, f"org-{j % 6}"), f"c{j % 6}")
                   for j in range(12)])
    digest = pkg.warmjoin.export_hotset(leader, k=64)
    joiner = build(pkg, strict_verify=True)
    joiner.apply_published(pkg.dist.load_latest(d))
    wj = pkg.warmjoin
    return [wj.import_hotset(joiner, dict(digest, interner="0" * 16)),
            wj.import_hotset(joiner, dict(digest, version=99)),
            wj.import_hotset(joiner, None),
            len(joiner._verdict_cache)]


def test_hotset_refuses_interner_and_version_mismatch(tmp_path):
    assert both_equal(hotset_refusals, tmp_path) == [(0, 0), (0, 0),
                                                     (0, 0), 0]


def test_a_reference_hotset_warms_a_port_replica(tmp_path):
    """A hot set the reference's leader exports imports whole into a port
    replica of the same published blob, and serves its hits with the
    reference's verdicts."""
    d = str(tmp_path)
    leader, pub = leader_with_published(REF, d)
    traffic = [(cdoc(j, f"org-{j % 6}"), f"c{j % 6}") for j in range(24)]
    want = serve(leader, traffic)
    digest = r_warmjoin.export_hotset(leader, k=64)
    pub.publish_hotset(digest)
    joiner = build(PORT, strict_verify=True)
    joiner.apply_published(p_dist.load_latest(d))
    assert p_warmjoin.import_hotset(joiner, p_dist.load_hotset(d)) == (
        len(digest["entries"]), 0)
    cache = joiner._verdict_cache
    m0 = cache.misses
    assert serve(joiner, traffic) == want
    assert cache.misses == m0


# ---- the kill harness: SIGKILL a live process, restart from disk alone -----

HARNESS = "authorino_tpu_torch.runtime.restart_harness"


def _harness_env():
    env = dict(os.environ)
    env.pop("AUTHORINO_TPU_FAULTS", None)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def reference_table(n_configs, variants):
    """The reference harness's table over the same variant cycle, built in
    process: fingerprint digest -> (variant, probe verdicts)."""
    probes = r_harness._probe_docs(n_configs)
    engine = r_harness._build_engine(n_configs, 0)
    table = {}
    for v in range(variants):
        if v:
            engine.apply_snapshot([
                RefEntry(id=c.name, hosts=[c.name], runtime=None, rules=c)
                for c in r_harness._corpus(n_configs, v)])
        table[r_harness.table_key(engine)] = {
            "variant": v, "verdicts": r_harness._verdicts(engine, probes)}
    return table


def _kill_and_verify(tmp_path, stress, kill_after_s):
    d = str(tmp_path / "sd")
    table = os.path.join(d, "TABLE.json")
    ready = os.path.join(d, "READY")
    report_path = str(tmp_path / "report.json")
    os.makedirs(d, exist_ok=True)
    proc = subprocess.Popen(
        [sys.executable, "-m", HARNESS, "serve", "--state-dir", d,
         "--table", table, "--ready", ready, "--stress", stress,
         "--configs", "6", "--variants", "3", "--device", "cpu"],
        env=_harness_env(), cwd=ROOT, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 120.0
        while not os.path.exists(ready):
            assert proc.poll() is None, "harness serve died before READY"
            assert time.monotonic() < deadline, "harness serve never READY"
            time.sleep(0.1)
        time.sleep(kill_after_s)  # land the kill mid-churn
        assert proc.poll() is None, "harness serve exited on its own"
    finally:
        try:
            proc.send_signal(signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait(timeout=30)
    out = subprocess.run(
        [sys.executable, "-m", HARNESS, "restart", "--state-dir", d,
         "--table", table, "--report", report_path, "--device", "cpu"],
        env=_harness_env(), cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, \
        f"restart verification failed:\n{out.stdout}\n{out.stderr}"
    report = json.load(open(report_path))
    assert report["recovered"] and report["table_hit"]
    assert report["verdicts_match"], report.get("mismatch")
    assert report["artifacts"]["unhandled"] == []
    # the port's table (what the killed process precomputed, and what the
    # restart was held to) is the reference harness's, key for key
    spec = json.load(open(table))
    assert spec["table"] == reference_table(6, 3)
    return report


class TestKillHarness:
    @pytest.mark.parametrize("stress", ["reconcile", "capture"])
    def test_sigkill_mid_churn_recovers_bit_exact(self, tmp_path, stress):
        report = _kill_and_verify(tmp_path, stress, kill_after_s=1.0)
        assert report["warm_start"]["snapshot"] in ("ok", "stale")

    @pytest.mark.slow
    @pytest.mark.parametrize("stress", ["reconcile", "capture"])
    @pytest.mark.parametrize("kill_after_s", [0.2, 0.7, 1.6, 2.9])
    def test_sigkill_sweep(self, tmp_path, stress, kill_after_s):
        _kill_and_verify(tmp_path, stress, kill_after_s=kill_after_s)


def test_harness_helpers_equal_the_reference():
    """The harness's corpus, probes and table key are the reference's:
    the same fingerprints, so one table serves both packages' restarts."""
    for v in range(3):
        p_fps = sorted(p_fingerprint(c) for c in p_harness._corpus(6, v))
        r_fps = sorted(r_fingerprint(c) for c in r_harness._corpus(6, v))
        assert p_fps == r_fps
    assert p_harness._probe_docs(6) == r_harness._probe_docs(6)
