"""The port's metadata prefetch cache against the JAX package's.

Each case builds the same input for both packages and compares with
tolerance 0: prefetchability, pinned documents and their digests, the
hit/miss/stale/refresh/error counts, staleness fall-through, a transient
re-pin failure keeping a healthy pin, the lowerability caveat, the
engine's reconcile registering the snapshot's documents, the capture
record's metadata digest, and the translate pass marking an AuthConfig's
request-independent ``http`` metadata prefetchable."""

from __future__ import annotations

import asyncio
import importlib
import time
from types import SimpleNamespace

import pytest

REF_ROOT, PORT_ROOT = "authorino_tpu", "authorino_tpu_torch"


def ns(root: str) -> SimpleNamespace:
    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    expr = m("expressions")
    return SimpleNamespace(
        root=root, pf=m("relations.prefetch"), base=m("evaluators.base"),
        value=m("authjson.value"), tv=m("analysis.translation_validate"),
        cap=m("replay.capture"), engine_mod=m("runtime.engine"),
        Pattern=expr.Pattern, Operator=expr.Operator,
        ConfigRules=m("compiler").ConfigRules,
        compile_corpus=m("compiler").compile_corpus)


REF, PORT = ns(REF_ROOT), ns(PORT_ROOT)
BOTH = (REF, PORT)


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


class FakeGenericHttp:
    """A GenericHttp-shaped evaluator (prefetchability is duck-typed on
    shape); ``call`` counts live fetches, so a case can show that a pin
    served instead."""

    def __init__(self, n, endpoint, body=None, parameters=(), headers=()):
        self.endpoint = (endpoint if not isinstance(endpoint, str)
                         else n.value.JSONValue(static=endpoint))
        self.body = body
        self.parameters = list(parameters)
        self.headers = list(headers)
        self.calls = 0

    async def call(self, pipeline):
        self.calls += 1
        return {"live": True}


def md_conf(n, name="flags", conditions=None, cache=None,
            endpoint="http://md.internal/flags"):
    return n.base.MetadataConfig(name, FakeGenericHttp(n, endpoint),
                                 type="METADATA_GENERIC_HTTP",
                                 conditions=conditions, cache=cache)


def entry_with(n, conf, cid="ns/c"):
    e = n.engine_mod.EngineEntry(id=cid, hosts=["c"], runtime=None,
                                 rules=None)
    e.runtime = type("RT", (), {"metadata": [conf]})()
    return e


def counters(pf):
    return dict(pf.to_json()["counters"])


def prefetcher(n, **kw):
    """A prefetcher whose documents pin only when the case calls
    ``refresh()``: the background refresher, which ``reconcile`` would
    wake, never starts, so the counts are the case's alone."""
    pf = n.pf.MetadataPrefetcher(**kw)
    pf._ensure_thread = lambda: None
    return pf


def test_prefetchable_detection_equal():
    got = []
    for n in BOTH:
        JV, MC = n.value.JSONValue, n.base.MetadataConfig
        confs = [
            md_conf(n),
            MC("t", FakeGenericHttp(n, JV(pattern="http://x/{request.path}")),
               type="METADATA_GENERIC_HTTP"),
            MC("t2", FakeGenericHttp(n, "http://x", headers=[SimpleNamespace(
                name="h", value=JV(pattern="auth.identity.sub"))]),
               type="METADATA_GENERIC_HTTP"),
            MC("t3", FakeGenericHttp(n, "http://x", parameters=[
                SimpleNamespace(name="p", value=JV(static="1"))]),
               type="METADATA_GENERIC_HTTP"),
            MC("t4", FakeGenericHttp(n, "http://x",
                                     body=JV(pattern="request.body")),
               type="METADATA_GENERIC_HTTP"),
            md_conf(n, conditions=n.Pattern("request.method", n.Operator.EQ,
                                            "GET")),
            md_conf(n, cache=object()),
            MC("u", object(), type="METADATA_USERINFO"),
        ]
        flags = [n.pf.is_prefetchable(c) for c in confs]
        c0 = md_conf(n)
        got.append((flags, n.pf.mark_prefetchable(c0), c0.prefetchable,
                    c0.prefetch_pinned))
    assert got[1] == got[0]
    assert got[1] == ([True, False, False, True, False, False, False, False],
                      True, True, False)


def test_pin_serves_without_a_live_fetch_equal():
    got = []
    for n in BOTH:
        conf = md_conf(n)
        n.pf.mark_prefetchable(conf)
        fetches = []
        pf = prefetcher(
            n, max_age_s=60.0, refresh_s=3600.0,
            fetcher=lambda ev: (fetches.append(ev), {"tier": "gold"})[1])
        try:
            registered = pf.reconcile([entry_with(n, conf)])
            pinned = conf.prefetch_pinned
            refresh = pf.refresh()
            rec = pf.lookup(("ns/c", "flags"))
            served = run(conf.call(object()))
            got.append((registered, pinned, refresh, rec.doc, rec.digest,
                        served, conf.evaluator.calls, pf.digest_for("ns/c"),
                        pf.digest_for("ns/none"), pf.export_docs(),
                        counters(pf), len(fetches) >= 1,
                        n.pf.doc_digest({"tier": "gold"})))
        finally:
            pf.stop()
    assert got[1] == got[0]
    (registered, pinned, refresh, doc, digest, served, calls, dg, none,
     docs, cnt, fetched, want_digest) = got[1]
    assert registered == 1 and pinned and refresh == {"ok": 1, "error": 0}
    assert doc == served == {"tier": "gold"} and calls == 0
    assert digest == want_digest and dg is not None and none is None
    assert docs == {"ns/c": {"flags": {"tier": "gold"}}}
    assert cnt["hit"] == 2 and fetched


def test_transient_failure_keeps_the_healthy_pin_equal():
    got = []
    for n in BOTH:
        conf = md_conf(n)
        n.pf.mark_prefetchable(conf)
        state = {"fail": False}

        def flaky(ev, state=state):
            if state["fail"]:
                raise RuntimeError("metadata service down")
            return {"tier": "gold"}

        pf = prefetcher(n, max_age_s=60.0, refresh_s=3600.0, fetcher=flaky)
        try:
            pf.reconcile([entry_with(n, conf)])
            first = pf.refresh()
            state["fail"] = True
            second = pf.refresh()
            rec = pf.lookup(("ns/c", "flags"))
            j = pf.to_json()
            got.append((first, second, rec.doc, j["pinned"], j["counters"],
                        {k: v["error"] for k, v in j["docs"].items()}))
        finally:
            pf.stop()
    assert got[1] == got[0]
    first, second, doc, pinned, cnt, errs = got[1]
    assert second == {"ok": 0, "error": 1} and doc == {"tier": "gold"}
    assert pinned == 1 and cnt["error"] == 1 and errs == {"ns/c/flags": None}


def test_staleness_and_a_failed_first_pin_fall_through_equal():
    got = []
    for n in BOTH:
        conf = md_conf(n)
        n.pf.mark_prefetchable(conf)
        pf = prefetcher(n, max_age_s=0.0, refresh_s=3600.0,
                        fetcher=lambda ev: {"x": 1})
        conf2 = md_conf(n, name="down")
        n.pf.mark_prefetchable(conf2)
        pf2 = prefetcher(
            n, max_age_s=60.0, refresh_s=3600.0,
            fetcher=lambda ev: (_ for _ in ()).throw(OSError("refused")))
        try:
            pf.reconcile([entry_with(n, conf)])
            pf.refresh()
            time.sleep(0.01)
            stale = pf.lookup(("ns/c", "flags"))
            live = run(conf.call(object()))
            pf2.reconcile([entry_with(n, conf2)])
            pf2.refresh()
            missing = pf2.lookup(("ns/c", "down"))
            got.append((stale, live, conf.evaluator.calls, counters(pf),
                        missing, counters(pf2), pf2.digest_for("ns/c")))
        finally:
            pf.stop()
            pf2.stop()
    assert got[1] == got[0]
    stale, live, calls, cnt, missing, cnt2, dg2 = got[1]
    assert stale is None and live == {"live": True} and calls == 1
    assert cnt["stale"] == 2
    assert missing is None and cnt2["miss"] == 1 and cnt2["error"] == 1
    assert dg2 is None


def test_reconcile_drops_unregistered_pins_equal():
    got = []
    for n in BOTH:
        a, b = md_conf(n, name="a"), md_conf(n, name="b")
        for c in (a, b):
            n.pf.mark_prefetchable(c)
        e = n.engine_mod.EngineEntry(id="ns/c", hosts=["c"], runtime=None,
                                     rules=None)
        e.runtime = type("RT", (), {"metadata": [a, b]})()
        pf = prefetcher(n, max_age_s=60.0, refresh_s=3600.0,
                        fetcher=lambda ev: {"e": ev.endpoint.static})
        try:
            pf.reconcile([e])
            pf.refresh()
            before = pf.to_json()
            e.runtime.metadata = [a]
            pf.reconcile([e])
            after = pf.to_json()
            for j in (before, after):
                for d in j["docs"].values():
                    d.pop("age_s")
            got.append((before, after, pf.export_docs()))
        finally:
            pf.stop()
    assert got[1] == got[0]
    before, after, docs = got[1]
    assert before["registered"] == 2 and after["registered"] == 1
    assert list(after["docs"]) == ["ns/c/a"]


def test_lowerability_prefetch_caveat_equal():
    got = []
    for n in BOTH:
        rules = n.ConfigRules(name="c", evaluators=[
            (None, n.Pattern("request.method", n.Operator.EQ, "GET"))])
        pol = n.compile_corpus([rules])

        def entry(pinned):
            return SimpleNamespace(id="c", rules=rules, runtime=SimpleNamespace(
                metadata=[SimpleNamespace(type="METADATA_GENERIC_HTTP",
                                          prefetchable=pinned,
                                          prefetch_pinned=pinned)],
                authorization=[SimpleNamespace(type="PATTERN_MATCHING",
                                               evaluator=SimpleNamespace())]))

        got.append([n.tv.classify_entry(entry(p), policy=pol)
                    for p in (False, True)])
    assert got[1] == got[0]
    (lane0, r0), (lane1, r1) = got[1]
    assert lane0 == "slow" and "metadata-dependency" in r0
    assert lane1 == "fast" and "metadata-prefetch" in r1


def test_engine_reconcile_registers_the_snapshot_equal():
    got = []
    for n in BOTH:
        conf = md_conf(n)
        n.pf.mark_prefetchable(conf)
        rules = n.ConfigRules(name="ns/c", evaluators=[
            (None, n.Pattern("request.method", n.Operator.EQ, "GET"))])
        runtime = type("RT", (), {"metadata": [conf], "authorization": []})()
        kw = ({"mesh": None, "lane_select": False, "kernel_lane": "fused"}
              if n is REF else {"device": "cpu", "lane_select": False})
        eng = n.engine_mod.PolicyEngine(members_k=4, metadata_prefetch=True,
                                        **kw)
        eng.metadata_prefetcher._fetcher = lambda ev: {"ok": True}
        try:
            eng.apply_snapshot([n.engine_mod.EngineEntry(
                id="ns/c", hosts=["c"], runtime=runtime, rules=rules)])
            eng.metadata_prefetcher.refresh()
            dv = eng.debug_vars()["metadata_prefetch"]
            for d in dv["docs"].values():
                d.pop("age_s")
            got.append((conf.prefetch_pinned,
                        eng._lowerability["configs"]["ns/c"], dv["registered"],
                        dv["pinned"], dv["docs"],
                        run(conf.call(object()))))
            eng.begin_drain()
            assert eng.metadata_prefetcher._stop is True
        finally:
            eng.metadata_prefetcher.stop()
    assert got[1] == got[0]
    pinned, low, registered, n_pinned, docs, served = got[1]
    assert pinned and low == {"lane": "fast", "reasons": ["metadata-prefetch"]}
    assert (registered, n_pinned, served) == (1, 1, {"ok": True})


def test_engine_without_prefetch_reports_none_equal():
    got = []
    for n in BOTH:
        kw = ({"mesh": None, "lane_select": False, "kernel_lane": "fused"}
              if n is REF else {"device": "cpu", "lane_select": False})
        eng = n.engine_mod.PolicyEngine(metadata_prefetch=False, **kw)
        got.append((eng.metadata_prefetcher,
                    eng.debug_vars()["metadata_prefetch"]))
    assert got[1] == got[0] == (None, None)


def test_capture_record_carries_the_metadata_digest_equal():
    got = []
    for n in BOTH:
        log = n.cap.CaptureLog(enabled=True, size_mb=1.0)
        log.offer("ns/c", {"request": {"path": "/x"}}, -1, "engine", 3,
                  t=1.0, metadata_doc_digest="abc123")
        log.offer("ns/d", {"request": {"path": "/y"}}, 0, "engine", 3, t=2.0)
        log.flush()
        got.append(log.ring_records())
    assert got[1] == got[0]
    by = {r["authconfig"]: r for r in got[1]}
    assert by["ns/c"]["metadata_doc_digest"] == "abc123"
    assert by["ns/d"]["metadata_doc_digest"] is None
    for r in got[1]:
        assert sorted(r) == sorted(PORT.cap.CAPTURE_FIELDS)


def test_translate_marks_request_independent_metadata():
    """translate's pass: an AuthConfig's static ``http`` metadata is
    prefetchable, a templated one is not, in both packages."""
    got = []
    for n in BOTH:
        tr = importlib.import_module(f"{n.root}.controllers.translate")
        kw = ({"mesh": None, "lane_select": False, "kernel_lane": "fused"}
              if n is REF else {"device": "cpu", "lane_select": False})
        eng = n.engine_mod.PolicyEngine(**kw)
        spec = {"hosts": ["md.test"],
                "authentication": {"anon": {"anonymous": {}}},
                "metadata": {
                    "static": {"http": {"url": "http://127.0.0.1:9/flags"}},
                    "templated": {"http": {
                        "url": "http://127.0.0.1:9/u/{request.path}"}}}}
        entry = run(tr.translate_auth_config("c", "ns", spec, engine=eng))
        got.append([(m.name, m.prefetchable, m.prefetch_pinned)
                    for m in entry.runtime.metadata])
        if eng.metadata_prefetcher is not None:
            eng.metadata_prefetcher.stop()
    assert got[1] == got[0]
    assert got[1] == [("static", True, False), ("templated", False, False)]
