"""The port's snapshot distribution against the JAX package's.

A compile leader publishes each vetted snapshot into a directory (the
atomic blob and ``MANIFEST.json``); a serving replica polls it and installs
each new generation without compiling (``apply_published``: the certified
gate, interner continuity, a delta upload against its serving snapshot).
Each scenario of the reference's ``tests/test_snapshots.py`` on
distribution runs through both packages on the same seeded corpus, and the
observations (verdicts, counters, manifest fields, which step raised what)
must be equal (tolerance 0: verdicts are booleans, blobs are bytes).  Two
cases cross the packages: a blob the reference publishes serves on a port
replica with the reference replica's verdicts, and a blob the port
publishes is byte-equal to the reference's and admitted by its loader."""

from __future__ import annotations

import asyncio
import hashlib
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

import authorino_tpu.snapshots.distribution as r_dist
import authorino_tpu_torch.snapshots.distribution as p_dist
from authorino_tpu.analysis import translation_validate as r_tv
from authorino_tpu.compiler import compile_corpus as r_compile
from authorino_tpu.runtime import EngineEntry as RefEntry
from authorino_tpu.runtime import PolicyEngine as RefEngine
from authorino_tpu.runtime.engine import SnapshotRejected as RefRejected
from authorino_tpu.snapshots import rules_fingerprint as r_fingerprint
from authorino_tpu.snapshots import serialize_policy as r_serialize
from authorino_tpu_torch.analysis import translation_validate as p_tv
from authorino_tpu_torch.compiler import compile_corpus as p_compile
from authorino_tpu_torch.runtime import EngineEntry, PolicyEngine
from authorino_tpu_torch.runtime.engine import SnapshotRejected
from authorino_tpu_torch.snapshots import rules_fingerprint as p_fingerprint
from authorino_tpu_torch.snapshots import serialize_policy as p_serialize

from test_torch_compiler import PORT as PORT_NS
from test_torch_compiler import REF as REF_NS

K = 4


def ref_engine(**kw):
    return RefEngine(members_k=K, mesh=None, lane_select=False,
                     kernel_lane="fused", **kw)


def port_engine(**kw):
    return PolicyEngine(members_k=K, device="cpu", lane_select=False, **kw)


REF = SimpleNamespace(name="ref", ns=REF_NS, Entry=RefEntry, make=ref_engine,
                      dist=r_dist, Rejected=RefRejected, compile=r_compile,
                      fingerprint=r_fingerprint, serialize=r_serialize,
                      tv=r_tv)
PORT = SimpleNamespace(name="port", ns=PORT_NS, Entry=EngineEntry,
                       make=port_engine, dist=p_dist, Rejected=SnapshotRejected,
                       compile=p_compile, fingerprint=p_fingerprint,
                       serialize=p_serialize, tv=p_tv)


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def make_corpus(pkg, n=20, mutated=()):
    """The reference's churn corpus (``tests/test_snapshots.py::
    make_corpus``) with ``pkg``'s classes."""
    ns = pkg.ns
    cfgs = []
    for i in range(n):
        const = f"org-{i}" + ("-MUT" if i in mutated else "")
        rule = ns.All(
            ns.Pattern("request.method", ns.Operator.EQ,
                       ["GET", "POST"][i % 2]),
            ns.Any_(
                ns.Pattern("auth.identity.org", ns.Operator.EQ, const),
                ns.Pattern("auth.identity.roles", ns.Operator.INCL,
                           f"role-{i}"),
                ns.Pattern("request.url_path", ns.Operator.MATCHES,
                           rf"^/svc-{i % 3}/"),
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


def doc(i):
    return {"request": {"method": ["GET", "POST"][i % 2],
                        "url_path": f"/svc-{i % 3}/x"},
            "auth": {"identity": {"org": f"org-{i}", "roles": []}}}


def verdicts(engine, n, docs=None):
    """The verdict columns of ``doc(i)`` on ``cfg-i`` (or of ``docs[j]``
    on ``cfg-{j % n}``), as lists (the two packages' arrays compare by
    value)."""
    docs = docs or [doc(i) for i in range(n)]

    async def go():
        return await asyncio.gather(*[engine.submit(dict(d), f"cfg-{j % n}")
                                      for j, d in enumerate(docs)])

    return [(np.asarray(r).tolist(), np.asarray(s).tolist())
            for r, s in run(go())]


def serialize_corpus(pkg, cfgs, certified=True, generation=1):
    policy = pkg.compile(cfgs, members_k=K)
    fps = {c.name: pkg.fingerprint(c) for c in cfgs}
    meta = {"generation": generation, "certified": certified,
            "fingerprints": fps,
            "entries": [{"id": c.name, "hosts": [c.name]} for c in cfgs]}
    return pkg.serialize(policy, meta=meta)


def raised(fn):
    """The name of what ``fn()`` raised, or None."""
    try:
        fn()
    except Exception as e:
        return type(e).__name__
    return None


def both_equal(scenario, tmp_path):
    want = scenario(REF, str(tmp_path / "ref"))
    got = scenario(PORT, str(tmp_path / "port"))
    assert got == want
    return got


# ---- the reference's scenarios, through both packages ----------------------

def leader_replica_end_to_end(pkg, root):
    d = os.path.join(root, "pub")
    cfgs = make_corpus(pkg, 10)
    leader = build(pkg, strict_verify=True)
    pub = pkg.dist.SnapshotPublisher(d)
    pub.attach(leader)
    leader.apply_snapshot(entries_of(pkg, cfgs))
    obs = {"flushed": pub.flush()}
    replica = build(pkg)
    loaded = pkg.dist.load_latest(d)
    obs["loaded"] = (loaded.certified, loaded.generation == leader.generation,
                     sorted(loaded.fingerprints) == sorted(
                         c.name for c in cfgs))
    replica.apply_published(loaded)
    obs["config_ids"] = (replica._snapshot.policy.config_ids
                         == leader._snapshot.policy.config_ids)
    obs["routes"] = replica.lookup("cfg-3") is not None
    obs["replica"] = verdicts(replica, 10)
    obs["leader"] = verdicts(leader, 10)
    good_snap, good_gen = replica._snapshot, replica.generation
    # a corrupt blob whose manifest digest was kept in sync: the
    # container's own sha256 trailer still catches it
    man = json.loads(open(os.path.join(d, "MANIFEST.json")).read())
    p = os.path.join(d, man["current"])
    raw = bytearray(open(p, "rb").read())
    raw[len(raw) // 3] ^= 0xFF
    open(p, "wb").write(bytes(raw))
    man["sha256"] = hashlib.sha256(bytes(raw)).hexdigest()
    open(os.path.join(d, "MANIFEST.json"), "w").write(json.dumps(man))
    obs["corrupt"] = raised(lambda: pkg.dist.load_latest(d))
    obs["corrupt_kept"] = replica._snapshot is good_snap
    # an uncertified snapshot loads, and is rejected at admission
    pub.publish_blob(serialize_corpus(pkg, make_corpus(pkg, 10, {1}),
                                      certified=False, generation=99), 99)
    obs["uncertified"] = raised(
        lambda: replica.apply_published(pkg.dist.load_latest(d)))
    obs["uncertified_kept"] = (replica._snapshot is good_snap,
                               replica.generation == good_gen)
    obs["still_serving"] = bool(run(replica.submit(doc(3), "cfg-3"))[0][0])
    return obs


def test_leader_replica_end_to_end(tmp_path):
    obs = both_equal(leader_replica_end_to_end, tmp_path)
    assert obs["flushed"] and obs["loaded"] == (True, True, True)
    assert obs["config_ids"] and obs["routes"]
    assert obs["replica"] == obs["leader"]
    assert obs["corrupt"] == "SnapshotLoadError" and obs["corrupt_kept"]
    assert obs["uncertified"] == "SnapshotRejected"
    assert obs["uncertified_kept"] == (True, True)
    assert obs["still_serving"]


def replica_poll_loop(pkg, root):
    d = os.path.join(root, "pub")
    leader = build(pkg, strict_verify=True)
    pub = pkg.dist.SnapshotPublisher(d)
    pub.attach(leader)
    leader.apply_snapshot(entries_of(pkg, make_corpus(pkg, 6)))
    obs = [pub.flush()]
    replica = build(pkg)
    rep = pkg.dist.SnapshotReplica(replica, d, poll_s=0.1)
    obs.append((rep.poll_once(), rep.applied))
    obs.append(rep.poll_once())
    leader.apply_snapshot(entries_of(pkg, make_corpus(pkg, 6, {0})))
    obs.append(pub.flush())
    obs.append((rep.poll_once(), rep.applied))
    pub.publish_blob(serialize_corpus(pkg, make_corpus(pkg, 6, {0, 1}),
                                      certified=False, generation=50), 50)
    obs.append((rep.poll_once(), rep.rejected))
    obs.append((rep.poll_once(), rep.rejected))
    rep.stop()
    js = rep.to_json()
    obs.append({k: js[k] for k in ("poll_s", "next_poll_s", "applied",
                                   "rejected", "errors", "error_streak")})
    obs.append(verdicts(replica, 6))
    return obs


def test_replica_poll_loop_applies_and_survives_rejection(tmp_path):
    obs = both_equal(replica_poll_loop, tmp_path)
    assert obs[:7] == [True, (True, 1), False, True, (True, 2), (False, 1),
                       (False, 1)]


def replica_delta_and_cache(pkg, root):
    n = 12
    d = os.path.join(root, "pub")
    leader = build(pkg, strict_verify=True)
    pub = pkg.dist.SnapshotPublisher(d)
    pub.attach(leader)
    leader.apply_snapshot(entries_of(pkg, make_corpus(pkg, n)))
    obs = {"flushed": [pub.flush()]}
    replica = build(pkg)
    replica.apply_published(pkg.dist.load_latest(d))
    obs["warm"] = verdicts(replica, n)
    vc = replica._verdict_cache
    obs["adds"] = vc.adds >= n
    leader.apply_snapshot(entries_of(pkg, make_corpus(pkg, n, {4})))
    obs["flushed"].append(pub.flush())
    replica.apply_published(pkg.dist.load_latest(d))
    up = replica._snapshot.upload
    obs["upload"] = (up["mode"], up["upload_bytes"] < up["full_bytes"] / 2)
    hits0 = vc.hits
    obs["churned"] = verdicts(replica, n)
    obs["hits"] = vc.hits - hits0
    cold = build(pkg, make_corpus(pkg, n, {4}), verdict_cache_size=0,
                 batch_dedup=False)
    obs["cold"] = verdicts(cold, n)
    return obs


def test_replica_delta_uploads_and_cache_survival_across_generations(
        tmp_path):
    obs = both_equal(replica_delta_and_cache, tmp_path)
    assert obs["flushed"] == [True, True] and obs["adds"]
    assert obs["upload"] == ("delta", True)
    assert obs["hits"] >= 12 - 1
    assert obs["churned"] == obs["cold"]


def never_republishes(pkg, root):
    d1, d2 = os.path.join(root, "up"), os.path.join(root, "down")
    leader = build(pkg, strict_verify=True)
    pub = pkg.dist.SnapshotPublisher(d1)
    pub.attach(leader)
    leader.apply_snapshot(entries_of(pkg, make_corpus(pkg, 4)))
    obs = [pub.flush()]
    relay = build(pkg)
    relay_pub = pkg.dist.SnapshotPublisher(d2)
    relay_pub.attach(relay)
    relay.apply_published(pkg.dist.load_latest(d1))
    obs.append(relay_pub.flush())
    obs.append(bool(relay._snapshot.published_origin))
    obs.append([f for f in os.listdir(d2) if f.endswith(".atpusnap")])
    return obs


def test_replica_never_republishes_loaded_snapshots(tmp_path):
    assert both_equal(never_republishes, tmp_path) == [True, True, True, []]


def join_during_quarantine(pkg, root):
    d = os.path.join(root, "pub")
    leader = build(pkg, make_corpus(pkg, 8), strict_verify=True)
    base_gen = leader.generation
    pub = pkg.dist.SnapshotPublisher(d)
    pub.publish_from_engine(leader)
    pub.publish_blob(serialize_corpus(pkg, make_corpus(pkg, 8, {2}),
                                      generation=base_gen + 1), base_gen + 1)
    # the candidate breached: the leader republishes its baseline with the
    # rollback and quarantine record, the candidate's blob stays on disk
    leader._snapshot.change_safety = {
        "rollback": {"reason": "fleet-guard-breach",
                     "guards": ["config-deny-rate"]},
        "quarantine": {"reason": "fleet-guard-breach",
                       "configs": ["cfg-2"]},
    }
    pub.publish_from_engine(leader)
    blobs = sorted(f for f in os.listdir(d) if f.endswith(".atpusnap"))
    man = json.loads(open(os.path.join(d, "MANIFEST.json")).read())
    obs = {"newest_blob": blobs[-1] == f"snapshot-{base_gen + 1:012d}"
                                       ".atpusnap",
           "current": man["current"] == f"snapshot-{base_gen:012d}.atpusnap",
           "active": man["active_generation"] == base_gen,
           "manifest_rollback": man["rollback"]}
    joiner = build(pkg)
    rep = pkg.dist.SnapshotReplica(joiner, d, poll_s=0.2)
    obs["poll"] = rep.poll_once()
    obs["change_safety"] = joiner._snapshot.change_safety
    probe = {"request": {"method": "GET", "url_path": "/other/x"},
             "auth": {"identity": {"org": "org-2", "roles": []}}}
    out = run(joiner.submit(dict(probe), "cfg-2"))
    want = run(leader.submit(dict(probe), "cfg-2"))
    obs["probe"] = (np.asarray(out[0]).tolist(),
                    np.asarray(want[0]).tolist())
    obs["repoll"] = (rep.poll_once(), rep.rejected, rep.errors)
    return obs


def test_join_during_quarantine_adopts_manifest_not_newest_blob(tmp_path):
    obs = both_equal(join_during_quarantine, tmp_path)
    assert obs["newest_blob"] and obs["current"] and obs["active"]
    assert obs["manifest_rollback"]["reason"] == "fleet-guard-breach"
    assert obs["poll"] is True
    assert obs["change_safety"]["rollback"]["reason"] == "fleet-guard-breach"
    assert obs["change_safety"]["quarantine"]["configs"] == ["cfg-2"]
    assert obs["probe"][0] == obs["probe"][1] and obs["probe"][0][0]
    assert obs["repoll"] == (False, 0, 0)


# ---- across the packages ---------------------------------------------------

def publish(pkg, d, cfgs):
    """A strict-verify leader of ``pkg`` over ``cfgs`` publishing into
    ``d``, from a clean certificate cache (the certification counts ride
    the blob's meta)."""
    pkg.tv.clear_certificate_cache()
    leader = build(pkg, strict_verify=True)
    pub = pkg.dist.SnapshotPublisher(d)
    pub.attach(leader)
    leader.apply_snapshot(entries_of(pkg, cfgs))
    assert pub.flush()
    return leader, pub


def read_published(d):
    man = json.loads(open(os.path.join(d, "MANIFEST.json")).read())
    with open(os.path.join(d, man["current"]), "rb") as f:
        return man, f.read()


def test_reference_blob_serves_on_a_port_replica(tmp_path):
    """A blob the reference's leader publishes installs on a port replica
    (no compile) and answers every config's requests with the reference
    replica's verdicts, before and after a one-config republish."""
    d = str(tmp_path / "pub")
    leader, pub = publish(REF, d, make_corpus(REF, 12))
    p_rep, r_rep = build(PORT), build(REF)
    p_poll = p_dist.SnapshotReplica(p_rep, d, poll_s=0.2)
    r_poll = r_dist.SnapshotReplica(r_rep, d, poll_s=0.2)
    assert p_poll.poll_once() and r_poll.poll_once()
    assert p_rep._snapshot.compile_report is None
    assert p_rep._snapshot.published_origin == \
        r_rep._snapshot.published_origin
    docs = [doc(i) for i in range(12)] + [doc((i + 5) % 12)
                                          for i in range(12)]
    assert verdicts(p_rep, 12, docs) == verdicts(r_rep, 12, docs)
    leader.apply_snapshot(entries_of(REF, make_corpus(REF, 12, {7})))
    assert pub.flush()
    assert p_poll.poll_once() and r_poll.poll_once()
    assert p_rep._snapshot.upload["mode"] == "delta"
    assert verdicts(p_rep, 12, docs) == verdicts(r_rep, 12, docs)
    assert p_rep.generation == r_rep.generation == 2


def test_port_blob_is_the_reference_blob_and_admitted_by_it(tmp_path):
    """The port's leader and the reference's publish the same corpus: the
    blobs are byte-equal, the manifests equal but for their timestamps,
    and the reference's loader admits the port's blob (and a reference
    replica serves it)."""
    cfgs_p, cfgs_r = make_corpus(PORT, 10), make_corpus(REF, 10)
    publish(PORT, str(tmp_path / "port"), cfgs_p)
    publish(REF, str(tmp_path / "ref"), cfgs_r)
    p_man, p_blob = read_published(str(tmp_path / "port"))
    r_man, r_blob = read_published(str(tmp_path / "ref"))
    assert p_blob == r_blob
    p_man.pop("published_unix")
    r_man.pop("published_unix")
    assert p_man == r_man
    loaded = r_dist.load_latest(str(tmp_path / "port"))
    assert loaded.certified and loaded.digest == p_man["sha256"]
    r_rep = build(REF)
    r_rep.apply_published(loaded)
    p_rep = build(PORT)
    p_rep.apply_published(p_dist.load_latest(str(tmp_path / "port")))
    assert verdicts(r_rep, 10) == verdicts(p_rep, 10)


@pytest.mark.parametrize("mutate", ["flip", "truncate", "garbage"])
def test_a_bad_blob_is_rejected_typed_by_both_loaders(tmp_path, mutate):
    blob = serialize_corpus(PORT, make_corpus(PORT, 4))
    assert blob == serialize_corpus(REF, make_corpus(REF, 4))
    bad = {"flip": lambda b: b[:len(b) // 2] + bytes([b[len(b) // 2] ^ 0xFF])
           + b[len(b) // 2 + 1:],
           "truncate": lambda b: b[:200],
           "garbage": lambda b: b"not a snapshot at all"}[mutate](blob)
    with pytest.raises(p_dist.SnapshotLoadError) as pe:
        p_dist.load_snapshot_blob(bad)
    with pytest.raises(r_dist.SnapshotLoadError) as re_:
        r_dist.load_snapshot_blob(bad)
    assert str(pe.value) == str(re_.value)
