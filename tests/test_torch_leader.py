"""Leader election, the leader-gated status writer, the REST cluster client
and the external OPA source of the port, against the reference's:

- the leader-election cases of ``tests/test_leader_and_webhooks.py`` on
  the port's ``InMemoryLeases``, each outcome equal to the reference's,
  and the lease life cycle on ``RestCluster`` against the loopback fake
  API server (``models/control_plane.py``), beside the reference's
  aiohttp ``RestCluster`` on the same server;
- the status updater: the leader writes and a follower does not; two
  updaters with leader election on the REST path, of which exactly one
  writes;
- ``RestCluster``: the same requests arrive from both packages' clients
  (method, path, query, Authorization, Content-Type, JSON body, the
  merge-patch type) and the same results come back; the port's watch
  reads the same events, survives a dropped connection and a 410 through
  ``K8sWatchSource``, and ``stop()`` ends a blocked read within 1 s;
- ``OPAExternalSource``: the same download (bearer secret, OPA API JSON or
  raw text) and the same error on a failed one."""

import asyncio
import time

import pytest

from authorino_tpu.controllers import AuthConfigReconciler as RefReconciler
from authorino_tpu.controllers.status_updater import AuthConfigStatusUpdater as RefUpdater
from authorino_tpu.evaluators.authorization.opa import OPAExternalSource as RefOPASource
from authorino_tpu.k8s import InMemoryCluster as RefCluster
from authorino_tpu.k8s import InMemoryLeases as RefLeases
from authorino_tpu.k8s import LabelSelector as RefSelector
from authorino_tpu.k8s import LeaderElector as RefElector
from authorino_tpu.k8s import RestCluster as RefRest
from authorino_tpu.k8s.leader import leader_election_id as ref_lease_id
from authorino_tpu.utils import http as ref_http
from authorino_tpu_torch.controllers import AuthConfigReconciler
from authorino_tpu_torch.controllers.sources import K8sWatchSource
from authorino_tpu_torch.controllers.status_updater import AuthConfigStatusUpdater
from authorino_tpu_torch.evaluators.authorization import OPAExternalSource
from authorino_tpu_torch.k8s import InMemoryCluster, InMemoryLeases, LabelSelector, LeaderElector, RestCluster
from authorino_tpu_torch.k8s.leader import leader_election_id
from authorino_tpu_torch.models.control_plane import FakeApiServer, PolicyRegistry
from authorino_tpu_torch.runtime import PolicyEngine
from test_torch_pipeline import REF, engine_of

PORT_LEASE = (InMemoryLeases, LeaderElector)
REF_LEASE = (RefLeases, RefElector)

SPEC = {"hosts": ["api.example.com"], "authorization": {"allow-all": {
    "patternMatching": {"patterns": [
        {"selector": "request.method", "operator": "neq", "value": ""}]}}}}


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def run_ref(coro_fn):
    """A coroutine of the reference's aiohttp client, its sessions closed
    on the same loop."""
    async def body():
        try:
            return await coro_fn()
        finally:
            await ref_http.close_sessions()

    return run(body())


def make_resource(name="cfg", ns="ns1"):
    return {"apiVersion": "authorino.kuadrant.io/v1beta2", "kind": "AuthConfig",
            "metadata": {"name": name, "namespace": ns}, "spec": SPEC}


# ---- leader election on the in-memory store ------------------------------

def single_winner_and_failover(leases_cls, elector_cls):
    async def body():
        leases = leases_cls()
        a = elector_cls(leases, "replica-a", duration_s=0.2, renew_interval=0.02)
        b = elector_cls(leases, "replica-b", duration_s=0.2, renew_interval=0.02)
        out = [await a.try_acquire_or_renew(), await b.try_acquire_or_renew(),
               a.is_leader(), b.is_leader(), await a.try_acquire_or_renew()]
        await asyncio.sleep(0.25)
        out += [await b.try_acquire_or_renew(), b.is_leader(),
                await a.try_acquire_or_renew(), a.is_leader()]
        return out

    return run(body())


def voluntary_release(leases_cls, elector_cls):
    async def body():
        leases = leases_cls()
        a = elector_cls(leases, "a", duration_s=30.0)
        b = elector_cls(leases, "b", duration_s=30.0)
        out = [await a.try_acquire_or_renew()]
        await a.release()
        return out + [await b.try_acquire_or_renew(), a.is_leader()]

    return run(body())


def transient_renew_error(leases_cls, elector_cls):
    class FlakyLeases(leases_cls):
        fail = False

        async def put_lease(self, namespace, name, lease):
            if self.fail:
                raise RuntimeError("apiserver unavailable")
            return await super().put_lease(namespace, name, lease)

    async def body():
        leases = FlakyLeases()
        a = elector_cls(leases, "a", duration_s=0.3, renew_interval=0.02)
        out = [await a.try_acquire_or_renew()]
        leases.fail = True
        out += [await a.try_acquire_or_renew(), a.is_leader()]
        await asyncio.sleep(0.25)
        out += [await a.try_acquire_or_renew(), a.is_leader()]
        leases.fail = False
        return out + [await a.try_acquire_or_renew()]

    return run(body())


def hanging_renew(leases_cls, elector_cls):
    class HangingLeases(leases_cls):
        hang_s = 0.0

        async def put_lease(self, namespace, name, lease):
            if self.hang_s:
                await asyncio.sleep(self.hang_s)
                raise RuntimeError("apiserver partitioned")
            return await super().put_lease(namespace, name, lease)

    async def body():
        leases = HangingLeases()
        a = elector_cls(leases, "a", duration_s=0.3, renew_interval=0.02)
        out = [await a.try_acquire_or_renew()]
        leases.hang_s = 0.25
        return out + [await a.try_acquire_or_renew(), a.is_leader()]

    return run(body())


def invalid_timing(leases_cls, elector_cls):
    out = []
    for kw in ({"duration_s": 15.0, "renew_deadline_s": 20.0},
               {"duration_s": 15.0, "renew_deadline_s": 10.0, "renew_interval": 10.0},
               {"duration_s": 15.0}):
        try:
            e = elector_cls(leases_cls(), "a", **kw)
            out.append((e.renew_interval, e.renew_deadline_s))
        except ValueError as err:
            out.append(str(err))
    return out


def transition_callbacks(leases_cls, elector_cls):
    events = []

    async def body():
        a = elector_cls(leases_cls(), "a", duration_s=0.2, renew_interval=0.02,
                        on_started_leading=lambda: events.append("start"),
                        on_stopped_leading=lambda: events.append("stop"))
        await a.try_acquire_or_renew()
        await a.release()
        return events

    return run(body())


def independent_shards(leases_cls, elector_cls):
    async def body():
        leases = leases_cls()
        ea = elector_cls(leases, "replica-1", name=leader_election_id("shard=a"))
        eb = elector_cls(leases, "replica-2", name=leader_election_id("shard=b"))
        return [await ea.try_acquire_or_renew(), await eb.try_acquire_or_renew(),
                ea.name, eb.name]

    return run(body())


def run_loop_and_stop(leases_cls, elector_cls):
    async def body():
        leases = leases_cls()
        a = elector_cls(leases, "a", duration_s=0.3, renew_interval=0.02).start()
        await asyncio.sleep(0.1)
        leading = a.is_leader()
        await a.stop()  # run() releases on the way out
        b = elector_cls(leases, "b", duration_s=0.3, renew_interval=0.02)
        return [leading, a.is_leader(), await b.try_acquire_or_renew()]

    return run(body())


CASES = {f.__name__: f for f in (
    single_winner_and_failover, voluntary_release, transient_renew_error,
    hanging_renew, invalid_timing, transition_callbacks, independent_shards,
    run_loop_and_stop)}
EXPECTED = {
    "single_winner_and_failover": [True, False, True, False, True, True, True,
                                   False, False],
    "voluntary_release": [True, True, False],
    "transient_renew_error": [True, True, True, False, False, True],
    "hanging_renew": [True, False, False],
    "transition_callbacks": ["start", "stop"],
    "run_loop_and_stop": [True, False, True],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_leader_election_equals_reference(case):
    got, want = CASES[case](*PORT_LEASE), CASES[case](*REF_LEASE)
    assert got == want
    if case in EXPECTED:
        assert got == EXPECTED[case]


def test_lease_name_derived_from_label_selector():
    for sel in ("", "shard=a", "shard=b", "a in (x,y),!b"):
        assert leader_election_id(sel) == ref_lease_id(sel)
    assert leader_election_id("shard=a") != leader_election_id("shard=b")
    assert leader_election_id().endswith(".authorino.kuadrant.io")


# ---- leases over REST --------------------------------------------------------

def rest_lease_life(cluster_cls, url, name):
    """Acquire, follower refused, a stale resourceVersion refused, voluntary
    release, takeover; a lease of another name is independent."""
    async def body():
        a = cluster_cls(url, token="a")
        b = cluster_cls(url, token="b")
        ea = (RefElector if cluster_cls is RefRest else LeaderElector)(
            a, "replica-a", namespace="ns1", name=name, duration_s=30.0)
        eb = (RefElector if cluster_cls is RefRest else LeaderElector)(
            b, "replica-b", namespace="ns1", name=name, duration_s=30.0)
        out = [await a.get_lease("ns1", name) is None,
               await ea.try_acquire_or_renew(), await eb.try_acquire_or_renew(),
               await ea.try_acquire_or_renew()]
        lease = await b.get_lease("ns1", name)
        out += [lease.holder, lease.duration_s, lease.transitions]
        stale = await b.get_lease("ns1", name)
        await ea.try_acquire_or_renew()  # bumps the resourceVersion
        stale.holder = "replica-b"
        out.append(await b.put_lease("ns1", name, stale))  # 409: refused
        await ea.release()
        out += [ea.is_leader(), await eb.try_acquire_or_renew(),
                (await a.get_lease("ns1", name)).transitions]
        other = (RefElector if cluster_cls is RefRest else LeaderElector)(
            a, "replica-a", namespace="ns1", name=name + "-other", duration_s=30.0)
        out.append(await other.try_acquire_or_renew())
        return out

    return body


def test_rest_leases_equal_reference():
    with FakeApiServer() as api:
        got = run(rest_lease_life(RestCluster, api.url, "port")())
        n_port = len(api.requests)
        want = run_ref(rest_lease_life(RefRest, api.url, "ref"))
        lease_reqs = [(m, p.rsplit("/", 1)[0], r.get("Authorization"),
                       (b or {}).get("spec", {}).get("holderIdentity"))
                      for m, p, _, r, b in api.requests]
    assert got == want
    assert got == [True, True, False, True, "replica-a", 30.0, 0, False,
                   False, True, 1, True]
    # the one request that differs, by design: creating a lease, the
    # reference first sends a PUT without a resourceVersion (answered 404)
    # and then the POST; the port sends only the POST
    port_reqs, ref_reqs = lease_reqs[:n_port], lease_reqs[n_port:]
    first_puts = [k for k, r in enumerate(ref_reqs[:-1])
                  if r[0] == "PUT" and ref_reqs[k + 1][0] == "POST"]
    assert len(first_puts) == 2   # the lease and the other one
    assert port_reqs == [r for k, r in enumerate(ref_reqs)
                         if k not in first_puts]


def test_two_replicas_racing_the_first_acquire_one_leads():
    """Both replicas read the lease before either writes it (no lease
    yet), then both write: exactly one leads, the other's create is
    refused.  The reference's PUT without a resourceVersion would make
    the second writer take the lease the first had just created."""
    class BothReadFirst:
        """Leases whose get_lease returns only once both replicas have
        read."""

        def __init__(self, cluster, gate):
            self.cluster, self.gate = cluster, gate

        async def get_lease(self, namespace, name):
            lease = await self.cluster.get_lease(namespace, name)
            self.gate.append(lease)
            while len(self.gate) < 2:
                await asyncio.sleep(0.005)
            return lease

        async def put_lease(self, namespace, name, lease):
            return await self.cluster.put_lease(namespace, name, lease)

    async def body(api):
        gate = []
        electors = [LeaderElector(BothReadFirst(RestCluster(api.url, token=k),
                                                gate),
                                  f"replica-{k}", namespace="ns1",
                                  name="race", duration_s=30.0)
                    for k in "ab"]
        won = await asyncio.gather(*(e.try_acquire_or_renew()
                                     for e in electors))
        holder = (await RestCluster(api.url, token="r").get_lease(
            "ns1", "race")).holder
        return gate, won, [e.is_leader() for e in electors], holder

    with FakeApiServer() as api:
        gate, won, leading, holder = run(body(api))
    assert gate == [None, None]
    assert sorted(won) == [False, True] and leading == won
    assert holder == f"replica-{'ab'[won.index(True)]}"


# ---- the status updater ----------------------------------------------------

def test_leader_writes_status_non_leader_does_not():
    def scenario(rec_cls, upd_cls, cluster_cls, ns):
        async def body():
            cluster = cluster_cls()
            rec = rec_cls(engine_of(ns), cluster=cluster)
            await rec.reconcile_all([make_resource()])
            upd = upd_cls(rec, cluster, leases=cluster, namespace="ns1")
            out = [await upd.sync_once(), ("ns1", "cfg") in cluster.statuses]
            out.append(await upd.elector.try_acquire_or_renew())
            out += [await upd.sync_once(), cluster.statuses[("ns1", "cfg")],
                    await upd.sync_once()]
            free = upd_cls(rec, cluster, leader_election=False)
            out.append(await free.sync_once())
            return out

        return run(body())

    got = scenario(AuthConfigReconciler, AuthConfigStatusUpdater, InMemoryCluster,
                   pytest.importorskip("test_torch_pipeline").PORT)
    want = scenario(RefReconciler, RefUpdater, RefCluster, REF)
    assert got == want
    assert got[:4] == [0, False, True, 1] and got[5] == 0 and got[6] == 1
    assert got[4]["summary"] == {"ready": True, "hostsReady": ["api.example.com"],
                                 "numHostsReady": 1}


def test_two_updaters_on_rest_one_writer():
    """Two replicas' updaters with leader election against one API
    server: while both run, exactly one writes, each status once; every
    AuthConfig ends Ready; the writer's statuses are merge-patched.  (On
    stop the leader releases its Lease, and the other may then take over
    and rewrite: that hand-over is not counted.)"""
    async def body(api):
        engine = PolicyEngine(device="cpu")
        reader = RestCluster(api.url, token="reader")
        rec = AuthConfigReconciler(engine, cluster=reader)
        await rec.reconcile_all(await reader.list_auth_configs())
        ups = [AuthConfigStatusUpdater(
            rec, RestCluster(api.url, token=f"updater-{k}"),
            leases=RestCluster(api.url, token=f"updater-{k}"), namespace="ns1",
            identity=f"replica-{k}", interval_s=0.02) for k in "ab"]
        for u in ups:
            u.start()
        for _ in range(500):
            if len(api.status_writes) >= 5:
                break
            await asyncio.sleep(0.01)
        await asyncio.sleep(0.2)  # a second writer would show by now
        writes = list(api.status_writes)
        leaders = [u.elector.is_leader() for u in ups]
        for u in ups:
            await u.stop()
        return writes, leaders

    with FakeApiServer() as api:
        for i in range(5):
            api.put("authconfigs", dict(make_resource(f"cfg-{i}"), spec=dict(
                SPEC, hosts=[f"cfg-{i}.test"])))
        writes, leaders = run(body(api))
        patch_types = {r.get("Content-Type") for m, _, _, r, _ in api.requests
                       if m == "PATCH"}
    assert len({t for t, *_ in writes}) == 1 and sorted(leaders) == [False, True]
    assert sorted(n for _, _, n, _ in writes) == [f"cfg-{i}" for i in range(5)]
    assert all(st["summary"]["ready"] for *_, st in writes)
    assert patch_types == {"application/merge-patch+json"}


# ---- RestCluster: the same requests, the same results ------------------------

def _secret_fields(s):
    return None if s is None else (s.name, s.namespace, s.labels, s.annotations,
                                   s.data, s.uid)


def rest_calls(cluster_cls, url):
    async def body():
        c = cluster_cls(url, token="tok-1")
        sel = (RefSelector if cluster_cls is RefRest else LabelSelector).parse(
            "app=a,tier in (x,y)")
        empty = (RefSelector if cluster_cls is RefRest else LabelSelector)()
        out = []
        secrets, rv = await c.list_secrets_rv(sel, "ns1")
        out.append(([_secret_fields(s) for s in secrets], rv))
        out.append([_secret_fields(s) for s in await c.list_secrets(empty)])
        out.append(_secret_fields(await c.get_secret("ns1", "s1")))
        out.append(_secret_fields(await c.get_secret("ns1", "missing")))
        out.append(await c.token_review("good-token", ["aud"]))
        out.append(await c.subject_access_review({"user": "admin", "resourceAttributes": {"verb": "get"}}))
        items, rv = await c.list_auth_configs_rv(sel)
        out.append(([i["metadata"]["name"] for i in items], rv))
        out.append([i["metadata"]["name"] for i in await c.list_auth_configs()])
        await c.patch_auth_config_status("ns1", "cfg", {"summary": {"ready": True}})
        try:
            await c.patch_auth_config_status("ns1", "gone", {})
        except RuntimeError as e:
            out.append(str(e))
        return out

    return body


def _seed(api):
    api.put("secrets", {"metadata": {"name": "s1", "namespace": "ns1",
                                     "labels": {"app": "a", "tier": "x"},
                                     "annotations": {"n": "v"}, "uid": "u1"},
                        "stringData": {"api_key": "k1"}})
    api.put("secrets", {"metadata": {"name": "s2", "namespace": "ns2",
                                     "labels": {"app": "a", "tier": "z"}},
                        "data": {"api_key": "azI="}})
    api.put("authconfigs", dict(make_resource("cfg"),
                                metadata={"name": "cfg", "namespace": "ns1",
                                          "labels": {"app": "a", "tier": "y"}}))
    api.put("authconfigs", make_resource("other"))
    api.token_reviews["good-token"] = {"status": {"authenticated": True,
                                                  "user": {"username": "u"}}}


def _wire(requests):
    return [(m, p, q, h.get("Authorization"), h.get("Content-Type"), b)
            for m, p, q, h, b in requests]


def test_rest_cluster_requests_and_results_equal_reference():
    with FakeApiServer() as api:
        _seed(api)
        got = run(rest_calls(RestCluster, api.url)())
        port_reqs = _wire(api.requests)
        api.requests.clear()
        want = run_ref(rest_calls(RefRest, api.url))
        ref_reqs = _wire(api.requests)
    assert got == want
    assert port_reqs == ref_reqs
    assert got[0][0][0][0] == "s1" and got[3] is None
    assert got[-1].startswith("k8s api PATCH /apis/authorino.kuadrant.io/v1beta2/"
                              "namespaces/ns1/authconfigs/gone/status: 404")
    patch = [r for r in port_reqs if r[0] == "PATCH"][0]
    assert patch[4] == "application/merge-patch+json"
    assert patch[5] == {"status": {"summary": {"ready": True}}}


def _watch_events(cluster_cls, url, params, n):
    async def body():
        c = cluster_cls(url, token="w")
        out = []
        async for ev, obj in c.watch("/api/v1/secrets", params, timeout_seconds=5):
            meta = obj.get("metadata") or {}
            out.append((ev, meta.get("name"), meta.get("resourceVersion"),
                        obj.get("code")))
            if len(out) == n:
                break
        return out

    return body


def test_watch_reads_the_same_events_and_params():
    with FakeApiServer() as api:
        _seed(api)
        api.delete("secrets", "ns1", "s1")
        params = {"resourceVersion": "100", "labelSelector": "app=a"}
        got = run(_watch_events(RestCluster, api.url, params, 3)())
        want = run_ref(_watch_events(RefRest, api.url, params, 3))
        queries = [q for m, p, q, *_ in api.requests if q.get("watch")]
    assert got == want
    assert [e[0] for e in got] == ["ADDED", "ADDED", "DELETED"]
    assert queries[0] == queries[1] == {
        "resourceVersion": ["100"], "labelSelector": ["app=a"],
        "watch": ["true"], "timeoutSeconds": ["5"]}


def test_watch_410_below_compaction_is_an_error_event():
    with FakeApiServer() as api:
        _seed(api)
        api.compact()
        got = run(_watch_events(RestCluster, api.url, {"resourceVersion": "100"}, 1)())
    assert got == [("ERROR", None, None, 410)]


def test_stop_ends_a_blocked_watch_read_within_a_second():
    async def body(api):
        c = RestCluster(api.url)
        seen = []

        async def consume():
            async for ev in c.watch("/api/v1/secrets", timeout_seconds=300):
                seen.append(ev)

        task = asyncio.ensure_future(consume())
        for _ in range(500):  # until connected, the read blocked on the socket
            if api.watches["secrets"]:
                break
            await asyncio.sleep(0.01)
        await asyncio.sleep(0.1)
        assert not task.done() and api.watches["secrets"] == 1
        t = time.monotonic()
        c.stop()
        try:
            await asyncio.wait_for(task, timeout=1.0)
        except Exception:
            pass
        return time.monotonic() - t, task.done(), seen

    with FakeApiServer() as api:
        took, done, seen = run(body(api))
    assert done and took < 1.0 and seen == []


def test_watch_source_survives_a_drop_and_a_410():
    """``K8sWatchSource`` on the port's RestCluster: the initial list, then
    a watch fed by the server; a dropped connection and a 410 Gone each
    make it re-list and re-watch; Secret events rotate an API key in
    place.  The engine ends at the server's state."""
    spec = {"hosts": ["k.test"], "authentication": {"k": {
        "apiKey": {"selector": {"matchLabels": {"app": "k"}}},
        "credentials": {"authorizationHeader": {"prefix": "APIKEY"}}}}}

    def secret(key):
        return {"metadata": {"name": "k", "namespace": "ns1", "labels": {
            "app": "k", "authorino.kuadrant.io/managed-by": "authorino"}},
            "stringData": {"api_key": key}}

    async def body(api):
        from authorino_tpu_torch.authjson import CheckRequestModel, HttpRequestAttributes
        from authorino_tpu_torch.controllers import SecretReconciler

        engine = PolicyEngine(device="cpu")
        cluster = RestCluster(api.url, token="w")
        rec = AuthConfigReconciler(engine, cluster=cluster)
        src = K8sWatchSource(cluster, rec, SecretReconciler(engine),
                             resync_interval_s=0.05)
        await src.sync()

        async def code(key, host="k.test"):
            r = await engine.check(CheckRequestModel(http=HttpRequestAttributes(
                method="GET", path="/", host=host,
                headers={"authorization": f"APIKEY {key}"})))
            return r.code

        async def until(pred, what):
            for _ in range(500):
                if await pred():
                    return
                await asyncio.sleep(0.02)
            raise AssertionError(f"timed out waiting for {what}")

        src.start()
        out = [await code("one")]
        api.fault("authconfigs", "drop")
        api.put("authconfigs", dict(make_resource("b"), spec={
            "hosts": ["b.test"], "authentication": {"a": {"anonymous": {}}}}))
        await until(lambda: _async(engine.lookup("b.test") is not None), "b")
        await until(lambda: _async(api.watches["authconfigs"] >= 2), "re-watch")
        api.fault("secrets", "gone")
        api.put("secrets", secret("two"))
        await until(lambda: _eq(code("two"), 0), "rotated key")
        await until(lambda: _async(api.watches["secrets"] >= 2), "re-watch")
        out += [await code("one"), await code("two")]
        api.fault("authconfigs", "gone")
        api.delete("authconfigs", "ns1", "b")
        await until(lambda: _async(engine.lookup("b.test") is None), "delete b")
        await until(lambda: _async(api.watches["authconfigs"] >= 3), "re-watch")
        await src.stop()
        cluster.stop()
        return out, dict(api.watches), rec.ready()

    with FakeApiServer() as api:
        api.put("secrets", secret("one"))
        api.put("authconfigs", dict(make_resource("k"), spec=spec))
        out, watches, ready = run(body(api))
    assert out == [0, 16, 0]
    assert watches["authconfigs"] >= 3 and watches["secrets"] >= 2
    assert ready


async def _async(v):
    return v


async def _eq(coro, want):
    return (await coro) == want


# ---- OPAExternalSource -----------------------------------------------------

def test_opa_external_source_equals_reference():
    policy = 'allow { input.x == 1 }'
    for as_json in (False, True):
        with PolicyRegistry(policy, secret="s3cr3t", as_json=as_json) as reg:
            url = f"{reg.url}/policy"
            results = []
            for cls, runner in ((OPAExternalSource, lambda f: run(f())),
                                (RefOPASource, run_ref)):
                async def fetch(cls=cls):
                    out = []
                    for secret, path in (("s3cr3t", "/policy"), ("", "/policy"),
                                         ("s3cr3t", "/missing")):
                        src = cls(f"{reg.url}{path}", shared_secret=secret)
                        try:
                            out.append(await src.download())
                        except Exception as e:
                            out.append((type(e).__name__, str(e)))
                    return out

                results.append(runner(fetch))
            heads = [h.get("Authorization") for _, _, h in reg.requests]
        assert results[0] == results[1]
        assert results[0] == [policy,
                              ("EvaluationError", "failed to download rego policy: 401"),
                              ("EvaluationError", "failed to download rego policy: 404")]
        assert heads == ["Bearer s3cr3t", None, "Bearer s3cr3t"] * 2
        assert url.endswith("/policy")
