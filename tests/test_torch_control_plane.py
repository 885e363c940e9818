"""The port's control plane against the reference's: each case runs the
same script of the reference's ``tests/test_control_plane.py`` (same
resources, same Secrets, same scripted watch streams) through the
reference's reconcilers, sources and engine and through the port's (its
engine on the CPU), and compares, at tolerance 0, what each run observes:
status reports and status objects, served verdicts after each step
(whole ``AuthResult`` fields), swap counts, and the watch's list and
watch parameters.  The port's own expectations (the reference test's
assertions) are checked too.  Also here: the bootstrap deny-all (503
"Busy"), mTLS CA rotation through the Secret reconciler, JSON and YAML
manifests, and an external OPA policy whose refresher stops when its
entry is replaced."""

import asyncio
import base64
import importlib
import json
from types import SimpleNamespace

import pytest
import yaml

from test_control_plane import V2_SPEC, AdversarialCluster, v1_ac
from test_torch_pipeline import PORT, REF, engine_of, request_of, result_fields


def pkg(ns):
    root = "authorino_tpu" if ns is REF else "authorino_tpu_torch"
    mods = {"rec": "controllers.reconciler", "src": "controllers.sources",
            "deny_all": "evaluators.deny_all", "convert": "apis.convert"}
    return SimpleNamespace(ns=ns, **{k: importlib.import_module(f"{root}.{m}")
                                     for k, m in mods.items()})


BOTH = (pkg(REF), pkg(PORT))
MANAGED = {"authorino.kuadrant.io/managed-by": "authorino"}


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def resource(name="ac", namespace="tenant", spec=None, labels=None):
    return {
        "apiVersion": "authorino.kuadrant.io/v1beta2",
        "kind": "AuthConfig",
        "metadata": {"name": name, "namespace": namespace, "labels": labels or {}},
        "spec": spec or dict(V2_SPEC),
    }


def client_secret(p, key=b"secret-key-1", role="admin"):
    labels = {"audience": "talker-api", **MANAGED}
    if role:
        labels["role"] = role
    return p.ns.k8s.Secret(name="client-1", namespace="tenant", labels=labels,
                           data={"api_key": key})


def statuses(rec):
    return {id_: (r.reason, r.message, list(r.hosts_ready))
            for id_, r in sorted(rec.status.all().items())}


def check(p, engine, host, path="/admin/x", headers=None, method="GET"):
    return engine.check(request_of(p.ns, {
        "method": method, "path": path, "host": host,
        "headers": dict(headers or {})}))


def both_equal(scenario, *args):
    """Run ``scenario(p, *args)`` for each package; the observations must
    be equal.  Returns the port's."""
    want, got = (scenario(p, *args) for p in BOTH)
    assert got == want
    return got


def swap_counter(engine):
    swaps = [0]
    engine.add_swap_listener(lambda: swaps.__setitem__(0, swaps[0] + 1))
    return swaps


# ---- TestReconciler ---------------------------------------------------------

class TestReconciler:
    def test_reconcile_status_and_serving(self):
        def scenario(p):
            async def body():
                engine = engine_of(p.ns, max_batch=4)
                cluster = p.ns.k8s.InMemoryCluster()
                cluster.put_secret(client_secret(p))
                rec = p.rec.AuthConfigReconciler(engine, cluster=cluster)
                swaps = swap_counter(engine)
                await rec.reconcile_all([resource()])
                obs = [statuses(rec), rec.ready(),
                       rec.status.status_object("tenant/ac"), swaps[0]]
                for path, key in (("/admin/x", "secret-key-1"),
                                  ("/admin/x", "wrong"), ("/public", "wrong")):
                    r = await check(p, engine, "talker-api.example.com", path,
                                    {"authorization": f"APIKEY {key}"})
                    obs.append(result_fields(r))
                return obs

            return run(body())

        obs = both_equal(scenario)
        assert obs[0]["tenant/ac"][0] == "Reconciled" and obs[1] is True
        assert obs[2]["summary"]["hostsReady"] == ["talker-api.example.com"]
        # the bootstrap deny-all swap, then the real corpus
        assert obs[3] == 2
        assert [o[0] for o in obs[4:]] == [PORT.rpc.OK,
                                           PORT.rpc.PERMISSION_DENIED,
                                           PORT.rpc.OK]
        assert obs[5][1] == 302

    def test_translate_error_status(self):
        def scenario(p):
            async def body():
                rec = p.rec.AuthConfigReconciler(engine_of(p.ns))
                bad = resource(spec={"hosts": ["h.example.com"], "authorization": {
                    "z": {"opa": {"rego": "default z = input.y"}}}})
                await rec.reconcile_all([bad])
                return statuses(rec), rec.ready(), rec.status.status_object("tenant/ac")

            return run(body())

        st, ready, _ = both_equal(scenario)
        assert st["tenant/ac"][0] == "CachingError" and not ready

    def test_host_collision(self):
        def scenario(p):
            async def body():
                spec = {"hosts": ["shared.example.com"],
                        "authentication": {"anon": {"anonymous": {}}}}
                rec = p.rec.AuthConfigReconciler(engine_of(p.ns))
                await rec.reconcile_all([resource("first", spec=dict(spec)),
                                         resource("second", spec=dict(spec))])
                return statuses(rec)

            return run(body())

        st = both_equal(scenario)
        assert st["tenant/first"][0] == "Reconciled"
        assert st["tenant/second"] == ("HostsNotLinked", "hosts already taken", [])

    def test_superseding_host_subsets(self):
        """A host already taken, under a wildcard that is taken too, links
        to a second config only with ``allow_superseding_host_subsets``."""
        def scenario(p, allow):
            async def body():
                anon = {"authentication": {"anon": {"anonymous": {}}}}
                engine = engine_of(p.ns)
                rec = p.rec.AuthConfigReconciler(
                    engine, allow_superseding_host_subsets=allow)
                await rec.reconcile_all([
                    resource("wild", spec={"hosts": ["*.example.com",
                                                     "a.example.com"], **anon}),
                    resource("one", spec={"hosts": ["a.example.com"], **anon})])
                hit = engine.lookup("a.example.com")
                return statuses(rec), hit.id if hit else None

            return run(body())

        for allow in (False, True):
            st, hit = both_equal(scenario, allow)
            assert hit == ("tenant/one" if allow else "tenant/wild")

    def test_label_selector_sharding(self):
        def scenario(p):
            async def body():
                engine = engine_of(p.ns)
                rec = p.rec.AuthConfigReconciler(
                    engine, label_selector=p.ns.k8s.LabelSelector.parse("group=a"))
                anon = {"authentication": {"anon": {"anonymous": {}}}}
                await rec.reconcile_all([
                    resource("mine", spec={"hosts": ["a.example.com"], **anon},
                             labels={"group": "a"}),
                    resource("other", spec={"hosts": ["b.example.com"], **anon},
                             labels={"group": "b"})])
                # an upsert of an unwatched resource deletes it
                await rec.upsert(resource("mine", spec={"hosts": ["a.example.com"], **anon},
                                          labels={"group": "b"}))
                return (statuses(rec), engine.lookup("b.example.com") is None,
                        engine.lookup("a.example.com") is None)

            return run(body())

        st, b_gone, a_gone = both_equal(scenario)
        assert b_gone and a_gone and st == {}

    def test_bootstrap_deny_all_answers_busy(self):
        def scenario(p):
            async def body():
                engine = engine_of(p.ns)
                engine.apply_snapshot([p.ns.runtime.EngineEntry(
                    id="tenant/ac", hosts=["talker-api.example.com"],
                    runtime=p.deny_all.new_deny_all_config())])
                r = await check(p, engine, "talker-api.example.com")
                return result_fields(r)

            return run(body())

        got = both_equal(scenario)
        assert got[:3] == (PORT.rpc.PERMISSION_DENIED, 503, "Busy")


# ---- TestSecretReconciler ---------------------------------------------------

class TestSecretReconciler:
    def test_live_rotation_through_cluster_events(self):
        def scenario(p):
            async def body():
                engine = engine_of(p.ns, max_batch=4)
                cluster = p.ns.k8s.InMemoryCluster()
                cluster.put_secret(client_secret(p))
                rec = p.rec.AuthConfigReconciler(engine, cluster=cluster)
                sec = p.rec.SecretReconciler(
                    engine, secret_label_selector=p.ns.k8s.LabelSelector.parse(
                        "authorino.kuadrant.io/managed-by=authorino"))
                cluster.on_secret_event(sec.on_event)
                await rec.reconcile_all([resource()])
                swaps = swap_counter(engine)
                gen = engine.generation
                obs = []

                async def probe(key):
                    r = await check(p, engine, "talker-api.example.com",
                                    headers={"authorization": f"APIKEY {key}"})
                    obs.append((key, result_fields(r), swaps[0]))

                await probe("secret-key-1")
                cluster.put_secret(client_secret(p, b"rotated-key", role=None))
                await probe("secret-key-1")
                await probe("rotated-key")
                # the same Secret again: no change, no notification
                cluster.put_secret(client_secret(p, b"rotated-key", role=None))
                await probe("rotated-key")
                cluster.remove_secret("tenant", "client-1")
                await probe("rotated-key")
                obs.append(engine.generation - gen)
                return obs

            return run(body())

        obs = both_equal(scenario)
        codes = [o[1][0] for o in obs[:-1]]
        assert codes == [PORT.rpc.OK, PORT.rpc.PERMISSION_DENIED, PORT.rpc.OK,
                         PORT.rpc.OK, PORT.rpc.PERMISSION_DENIED]
        # rotation notifies listeners (3 real changes) without a corpus swap
        assert [o[2] for o in obs[:-1]] == [0, 1, 1, 1, 2]
        assert obs[-1] == 0

    def test_mtls_ca_rotation(self):
        """An x509 config served while its CA Secret is added, replaced by
        another CA and removed: the identity follows in place."""
        from test_torch_x509 import CAS, CLIENT

        client_rsa = CAS["rsa"].issue(CLIENT).decode()
        client_p256 = CAS["p256"].issue(CLIENT).decode()
        spec = {"hosts": ["mtls.test"], "authentication": {"m": {"x509": {
            "selector": {"matchLabels": {"ca": "clients"}}}}},
            "response": {"success": {"headers": {"x-o": {"json": {
                "properties": {"o": {"selector": "auth.identity.Organization"}}}}}}}}

        def ca_secret(p, pem):
            return p.ns.k8s.Secret(name="ca", namespace="tenant",
                                   labels={"ca": "clients", **MANAGED},
                                   data={"ca.crt": pem})

        def scenario(p):
            async def body():
                engine = engine_of(p.ns)
                cluster = p.ns.k8s.InMemoryCluster()
                rec = p.rec.AuthConfigReconciler(engine, cluster=cluster)
                sec = p.rec.SecretReconciler(engine)
                cluster.on_secret_event(sec.on_event)
                await rec.reconcile_all([resource("m", spec=spec)])
                swaps = swap_counter(engine)
                obs = []

                async def probe():
                    for cert in (client_rsa, client_p256):
                        r = await engine.check(request_of(
                            p.ns, {"method": "GET", "path": "/", "host": "mtls.test"},
                            source={"certificate": cert}))
                        obs.append(result_fields(r))
                    obs.append(swaps[0])

                await probe()
                cluster.put_secret(ca_secret(p, CAS["rsa"].pem))
                await probe()
                cluster.put_secret(ca_secret(p, CAS["p256"].pem))
                await probe()
                cluster.remove_secret("tenant", "ca")
                await probe()
                return obs

            return run(body())

        obs = both_equal(scenario)
        ok, unauth = PORT.rpc.OK, PORT.rpc.UNAUTHENTICATED
        codes = [o[0] for o in obs if isinstance(o, tuple)]
        assert codes == [unauth, unauth, ok, unauth, unauth, ok, unauth, unauth]
        assert [o for o in obs if isinstance(o, int)] == [0, 1, 2, 3]


# ---- TestYamlSource ----------------------------------------------------------

def _secret_manifest(key=b"from-yaml"):
    return {"apiVersion": "v1", "kind": "Secret",
            "metadata": {"name": "client-1", "namespace": "tenant",
                         "labels": {"audience": "talker-api", **MANAGED}},
            "data": {"api_key": base64.b64encode(key).decode()}}


class TestYamlSource:
    @pytest.mark.parametrize("fmt", ["yaml", "json", "v1beta1-json"])
    def test_load_and_serve_from_dir(self, tmp_path, fmt):
        """Manifests in a directory through ``YamlDirSource``: served, then
        a rule flipped in its file, then the Secret rotated, each after a
        ``sync()``; ``load_manifests`` reads the same documents."""
        def write(ac, secret):
            for f in tmp_path.iterdir():
                f.unlink()
            if fmt == "yaml":
                (tmp_path / "m.yaml").write_text(yaml.dump_all([ac, secret]))
            else:
                (tmp_path / "ac.json").write_text(json.dumps(ac))
                (tmp_path / "s.json").write_text(json.dumps(secret))

        def manifests(open_all):
            ac = resource()
            if open_all:
                ac["spec"] = dict(ac["spec"], authorization={})
            if fmt == "v1beta1-json":
                ac = BOTH[0].convert.to_v1beta1(ac)
            return ac

        def scenario(p, d=tmp_path):
            async def body():
                write(manifests(False), _secret_manifest())
                engine = engine_of(p.ns, max_batch=4)
                cluster = p.ns.k8s.InMemoryCluster()
                rec = p.rec.AuthConfigReconciler(engine, cluster=cluster)
                sec = p.rec.SecretReconciler(
                    engine, secret_label_selector=p.ns.k8s.LabelSelector.parse(
                        "authorino.kuadrant.io/managed-by=authorino"))
                source = p.src.YamlDirSource(str(d), rec, cluster, sec)
                acs, secrets = p.src.load_manifests(str(d))
                obs = [acs, [(s.name, s.namespace, s.labels, s.data)
                             for s in secrets]]

                async def probe(key):
                    for path in ("/x", "/admin/x"):
                        r = await check(p, engine, "talker-api.example.com", path,
                                        {"authorization": f"APIKEY {key}"})
                        obs.append(result_fields(r))
                    obs.append(statuses(rec))

                await source.sync()
                await probe("from-yaml")
                write(manifests(True), _secret_manifest())
                await source.sync()
                await probe("from-yaml")
                write(manifests(True), _secret_manifest(b"rotated"))
                await source.sync()
                await probe("from-yaml")
                await probe("rotated")
                return obs

            return run(body())

        obs = both_equal(scenario)
        results = [o for o in obs[2:] if isinstance(o, tuple)]
        assert [r[0] for r in results] == [PORT.rpc.OK] * 8
        # the x-auth header carries auth.identity.anonymous: absent for the
        # key's identity, true once the rotated-out key falls to anonymous
        heads = [json.loads(r[3][0]["x-auth"])["user"] for r in results]
        assert heads == [None, None, None, None, True, True, None, None]

    def test_unparseable_manifest_is_skipped(self, tmp_path):
        (tmp_path / "bad.yaml").write_text("kind: [unclosed")
        (tmp_path / "bad.json").write_text("{not json")
        (tmp_path / "ok.json").write_text(json.dumps(resource()))
        got = [p.src.load_manifests(str(tmp_path)) for p in BOTH]
        assert got[1][0] == got[0][0] and len(got[1][0]) == 1


# ---- watch sources -----------------------------------------------------------

def _watch_obs(p, lists, watches, resync, serve=False, hosts=()):
    async def body():
        engine = engine_of(p.ns, max_batch=4)
        swaps = swap_counter(engine)
        rec = p.rec.AuthConfigReconciler(engine)
        cluster = AdversarialCluster(lists, watches, swaps)
        src = p.src.K8sWatchSource(cluster, rec, resync_interval_s=resync)
        src.start()
        served = [0]
        stop = asyncio.Event()

        async def serve_loop():
            while not stop.is_set():
                r = await engine.check(request_of(p.ns, {
                    "method": "GET", "path": "/x",
                    "host": f"cfg-{served[0] % 13}.test"}))
                assert r is not None
                served[0] += 1
                await asyncio.sleep(0)

        task = asyncio.ensure_future(serve_loop()) if serve else None
        try:
            await asyncio.wait_for(cluster.done.wait(), timeout=20)
            await asyncio.sleep(0.1)
        finally:
            stop.set()
            if task is not None:
                await task
        obs = {
            "lookups": {h: (engine.lookup(h).id if engine.lookup(h) else None)
                        for h in hosts},
            "statuses": statuses(rec), "ready": rec.ready(),
            "swaps": swaps[0], "swaps_at_last_list": cluster.swaps_at_last_list,
            "watch_params": cluster.watch_params,
            "list_params": [s.to_string() for s in cluster.list_params],
            "served": served[0] > 0 if serve else None,
        }
        await src.stop()
        return obs

    return run(body())


class TestAdversarialWatch:
    def test_gone_drops_and_stale_relists(self):
        a1, a2 = v1_ac("a", "1", ["a.test"]), v1_ac("a", "13", ["a2.test"])
        b, c = v1_ac("b", "2", ["b.test"]), v1_ac("c", "11", ["c.test"])

        def scenario(p):
            lists = [([a1, b], "10"), ([a1, c], "12"), ([a2, c], "14")]
            watches = [[("yield", "ADDED", c),
                        ("yield", "ERROR", {"kind": "Status", "code": 410})],
                       [("yield", "MODIFIED", a2), ("raise",)]]
            return _watch_obs(p, lists, watches, 0.01,
                              hosts=("a.test", "a2.test", "b.test", "c.test"))

        obs = both_equal(scenario)
        assert obs["lookups"] == {"a.test": None, "a2.test": "t/a",
                                  "b.test": None, "c.test": "t/c"}
        assert obs["swaps"] == obs["swaps_at_last_list"]
        assert [q.get("resourceVersion") for q in obs["watch_params"][:3]] == \
            ["10", "12", "14"]
        assert obs["ready"]


class TestResyncDedupRetry:
    def test_caching_error_retried_on_identical_relist(self, monkeypatch):
        def scenario(p):
            async def body():
                engine = engine_of(p.ns)
                rec = p.rec.AuthConfigReconciler(engine)
                calls = {"n": 0}
                real = p.rec.translate_auth_config

                async def flaky(*a, **k):
                    calls["n"] += 1
                    if calls["n"] == 1:
                        raise p.ns.controllers.TranslationError(
                            "transient backend failure")
                    return await real(*a, **k)

                monkeypatch.setattr(p.rec, "translate_auth_config", flaky)
                cr = {"apiVersion": "authorino.kuadrant.io/v1beta2",
                      "kind": "AuthConfig",
                      "metadata": {"namespace": "t", "name": "x",
                                   "resourceVersion": "5"},
                      "spec": {"hosts": ["x.test"]}}
                obs = []
                await rec.reconcile_all([cr])
                obs.append(statuses(rec))
                await rec.reconcile_all([dict(cr)])
                obs.append((statuses(rec), rec.ready()))
                swaps = swap_counter(engine)
                await rec.reconcile_all([dict(cr)])
                await rec.upsert(dict(cr))  # a resync replay: deduped
                obs.append((swaps[0], calls["n"]))
                return obs

            return run(body())

        obs = both_equal(scenario)
        assert obs[0]["t/x"] == ("CachingError", "transient backend failure", [])
        assert obs[1][1] and obs[2] == (0, 2)


class TestWatchBookmarksAndStorms:
    def test_bookmarks_advance_resume_point(self):
        a = v1_ac("a", "1", ["a.test"])

        def scenario(p):
            bookmark = {"kind": "AuthConfig", "metadata": {"resourceVersion": "42"}}
            lists = [([a], "10"), "raise", ([a], "43")]
            watches = [[("yield", "BOOKMARK", bookmark)]]
            return _watch_obs(p, lists, watches, 0.01, hosts=("a.test",))

        obs = both_equal(scenario)
        assert [q.get("resourceVersion") for q in obs["watch_params"][:2]] == \
            ["10", "42"]
        assert obs["lookups"] == {"a.test": "t/a"}

    def test_reconnect_storm_soak_zero_missed_deletes(self):
        def script():
            rv = [100]

            def bump():
                rv[0] += 1
                return str(rv[0])

            live, lists, watches = {}, [], []
            live["cfg-0"] = v1_ac("cfg-0", bump(), ["cfg-0.test"])
            lists.append((list(live.values()), bump()))
            for i in range(1, 13):
                s = []
                added = v1_ac(f"cfg-{i}", bump(), [f"cfg-{i}.test"])
                live[f"cfg-{i}"] = added
                s.append(("yield", "ADDED", added))
                gone = f"cfg-{i - 3}"
                if gone in live:
                    doomed = live.pop(gone)
                    if i % 2 == 0:
                        s.append(("yield", "DELETED", doomed))
                s.append(("yield", "ERROR", {"kind": "Status", "code": 410})
                         if i % 5 == 0 else ("raise",))
                watches.append(s)
                lists.append((list(live.values()), bump()))
            return lists, watches, sorted(live)

        hosts = tuple(f"cfg-{i}.test" for i in range(13))

        def scenario(p):
            lists, watches, _ = script()
            obs = _watch_obs(p, lists, watches, 0.005, serve=True, hosts=hosts)
            # swap counts depend on how the concurrent Check()s interleave
            # with the watch; the final state and parameters may not
            obs.pop("swaps")
            obs.pop("swaps_at_last_list")
            return obs

        obs = both_equal(scenario)
        live = script()[2]
        assert obs["lookups"] == {f"{n}.test": (f"t/{n}" if n in live else None)
                                  for n in (h[:-5] for h in hosts)}
        assert set(obs["statuses"]) == {f"t/{n}" for n in live}
        assert obs["ready"] and obs["served"]


# ---- an external OPA policy through the reconciler ------------------------

def test_external_policy_refresher_stops_when_replaced():
    from authorino_tpu_torch.models.control_plane import PolicyRegistry
    from test_torch_check import ref_http

    with PolicyRegistry('allow { input.request.method == "GET" }') as reg:
        def scenario(p):
            async def body():
                engine = engine_of(p.ns)
                rec = p.rec.AuthConfigReconciler(engine)
                spec = {"hosts": ["opa.test"],
                        "authentication": {"a": {"anonymous": {}}},
                        "authorization": {"r": {"opa": {"externalPolicy": {
                            "url": f"{reg.url}/policy", "ttl": 3600}}}}}
                cr = resource("o", spec=spec)
                cr["metadata"]["resourceVersion"] = "1"
                await rec.reconcile_all([cr])
                first = engine.lookup("opa.test").runtime.authorization[0].evaluator
                obs = [first._refresher is not None]
                for m in ("GET", "POST"):
                    obs.append(result_fields(await check(p, engine, "opa.test",
                                                         "/", method=m)))
                cr2 = resource("o", spec=spec)
                cr2["metadata"]["resourceVersion"] = "2"
                await rec.upsert(cr2)
                second = engine.lookup("opa.test").runtime.authorization[0].evaluator
                obs += [first._refresher is None, second is not first,
                        second._refresher is not None, statuses(rec)]
                await engine.lookup("opa.test").runtime.clean()
                return obs

            return run(body())

        obs = both_equal(scenario)
        assert obs[0] and obs[3] and obs[4] and obs[5]
        assert [o[0] for o in obs[1:3]] == [PORT.rpc.OK, PORT.rpc.PERMISSION_DENIED]
        assert reg.downloads == 4
    run(ref_http.close_sessions())
