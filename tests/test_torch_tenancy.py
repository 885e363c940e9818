"""The port's tenant QoS plane against the JAX package's.

``authorino_tpu_torch/tenancy/`` (weights from annotations, the weighted
deficit-round-robin cut, per-tenant quotas, queue shares and doomed depth,
the per-tenant folds with their top-K labels, noisy-neighbor containment,
the plane that wires them) and the engine's, the native frontend's, the
HTTP server's and the CLI's side of it, held to the reference's
``tenancy/`` and engine at tolerance 0.  Each unit case builds the
reference's object and the port's, drives both with the same sequence
(seeded with numpy's ``default_rng``, on a synthetic clock where the
object takes one) and compares what each returns and its ``to_json()``.
Each engine case runs the same requests through the reference's engine
(JAX on the CPU, lane selection and brownout off) and the port's CPU
engine (the plain version of its kernel) and compares verdicts, per-tenant
counters and rejections; the reference test's own assertions
(``tests/test_tenancy.py``) are checked on the port's run too.

Containment on a card is a divergence by design: the reference sends a
contained tenant's rows to its host-oracle lane, the port cuts them into
parts of their own that the device decides behind the cut's other parts.
Verdicts, per-tenant counters, rejections and containment's fire and
release are equal; what differs is named where it is compared: the
reference counts the diverted parts as host-lane decisions
(``engine.lanes.decisions["host:tenant-contained"]``), the port as
``engine.stats["contained_parts"]``/``["contained_rows"]`` and a
``contained`` key on those parts' batch records.  The port also rebinds
the weight book at a canary's start, promotion and rollback, where the
reference binds only at a swap at 100%.

Left out until the port holds ``analysis/``: the reference's
``TestCardinalityLint`` and ``test_tenancy_code_stays_clean``.
``tests/test_torch_cuda.py`` holds a contained tenant's part to plain on
the card."""

from __future__ import annotations

import asyncio
import importlib
import json
import time
from collections import deque
from types import SimpleNamespace

import numpy as np
import pytest

ANN_CLASS = "authorino.tpu/qos-class"
ANN_WEIGHT = "authorino.tpu/qos-weight"
ANN_QUOTA = "authorino.tpu/qos-quota-rps"


def pkg(root):
    mod = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
    return SimpleNamespace(
        name=root, ten=mod("tenancy"), quota=mod("tenancy.quota"),
        weights=mod("tenancy.weights"), runtime=mod("runtime"),
        compiler=mod("compiler"), expr=mod("expressions"),
        prov=mod("runtime.provenance"), adm=mod("runtime.admission"),
        recorder=mod("runtime.flight_recorder").RECORDER, rpc=mod("utils.rpc"),
        slo=mod("utils.slo"), cs=mod("runtime.change_safety"),
        metrics=mod("utils.metrics"))


REF = pkg("authorino_tpu")
PORT = pkg("authorino_tpu_torch")
BOTH = (REF, PORT)


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def both_equal(scenario, *args):
    """``scenario(pkg, *args)`` for each package; the observations must be
    equal.  Returns the port's."""
    want = scenario(REF, *args)
    got = scenario(PORT, *args)
    assert got == want
    return got


def rule_of(p):
    e = p.expr
    return e.All(e.Pattern("auth.identity.roles", e.Operator.INCL, "admin"),
                 e.Pattern("auth.identity.groups", e.Operator.EXCL, "banned"))


def make_engine(p, **kw):
    if p is REF:
        return p.runtime.PolicyEngine(members_k=4, mesh=None,
                                      lane_select=False, kernel_lane="fused",
                                      brownout=False, **kw)
    return p.runtime.PolicyEngine(members_k=4, device="cpu",
                                  lane_select=False, brownout=False, **kw)


def entries(p, n_tenants=3, annotations=None, rule=None):
    rule = rule if rule is not None else rule_of(p)
    return [p.runtime.EngineEntry(
        id=f"t{i}", hosts=[f"t{i}"], runtime=None,
        rules=p.compiler.ConfigRules(name=f"t{i}", evaluators=[(None, rule)]),
        annotations=(annotations or {}).get(f"t{i}"))
        for i in range(n_tenants)]


def build_engine(p, n_tenants=3, annotations=None, **kw):
    kw.setdefault("verdict_cache_size", 0)
    kw.setdefault("max_batch", 8)
    engine = make_engine(p, **kw)
    engine.apply_snapshot(entries(p, n_tenants, annotations))
    return engine


def doc(i: int, allow: bool = True) -> dict:
    return {"auth": {"identity": {
        "roles": ["admin", f"r{i}"] if allow else [f"r{i}"],
        "groups": []}}}


class P:
    """A _Pending stand-in for the cutter and admission units."""

    def __init__(self, tenant, seq=0):
        self.config_name = tenant
        self.seq = seq
        self.t_enq = time.monotonic()


class StubHeat:
    configs_per_shard = None

    def __init__(self, names):
        self.names = names

    def name(self, row, shard=None):
        return self.names[row] if 0 <= row < len(self.names) else ""


class frozen_admission_clock:
    """The plane's admission clock stands still inside: a quota's bucket
    refills nothing, however long the engine takes to answer."""

    def __init__(self, p):
        self.mod = importlib.import_module(f"{p.name}.tenancy.plane")

    def __enter__(self):
        self.mod.time = SimpleNamespace(monotonic=lambda: 1000.0)

    def __exit__(self, *exc):
        self.mod.time = time


def cols(out):
    return [(np.asarray(r).tolist(), np.asarray(s).tolist()) for r, s in out]


def top_counts(engine):
    j = engine.tenancy.stats.to_json()
    return {r["tenant"]: (r["requests"], r["denies"], r["slo_bad"])
            for r in j["top"]}


# ---------------------------------------------------------------------------
# weights from annotations
# ---------------------------------------------------------------------------


def random_annotations(seed, n):
    """Seeded annotation mixes: classes in any case and junk, explicit
    weights valid, zero, negative and junk, quotas likewise, none."""
    rng = np.random.default_rng(seed)
    classes = ["gold", "Silver", " BRONZE ", "platinum", "", "gold "]
    weights = ["7.5", "0", "-2", "abc", "1e-3", "12", None]
    quotas = ["25", "0", "-1", "x", "0.5", None]
    out = {}
    for i in range(n):
        ann = {}
        if rng.random() < 0.6:
            ann[ANN_CLASS] = classes[rng.integers(len(classes))]
        w = weights[rng.integers(len(weights))]
        if w is not None and rng.random() < 0.5:
            ann[ANN_WEIGHT] = w
        q = quotas[rng.integers(len(quotas))]
        if q is not None and rng.random() < 0.5:
            ann[ANN_QUOTA] = q
        out[f"ns/t{i}"] = ann if ann or rng.random() < 0.5 else None
    return out


class TestWeights:
    def test_class_weight_quota_resolution(self):
        def scenario(p):
            book = p.ten.WeightBook()
            book.rebuild({
                "gold": {ANN_CLASS: "Gold"},
                "explicit": {ANN_WEIGHT: "7.5"},
                "quota": {ANN_QUOTA: "25"},
                "junk": {ANN_WEIGHT: "not-a-number"},
                "plain": None,
            })
            return ([book.weight(t) for t in ("gold", "explicit", "junk",
                                              "plain", "never-seen")],
                    [book.quota_rps(t) for t in ("quota", "plain")],
                    book.to_json())

        w, q, _ = both_equal(scenario)
        assert w == [4.0, 7.5, 1.0, 1.0, 1.0]   # a typo never zeroes a share
        assert q == [25.0, 0.0]

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_seeded_annotation_mixes_resolve_alike(self, seed):
        anns = random_annotations(seed, 40)

        def scenario(p):
            book = p.ten.WeightBook(default_weight=1.5, default_quota_rps=3.0,
                                    overrides={"ns/t3": 9.0, "ns/t5": -1.0})
            book.rebuild(anns)
            names = sorted(anns) + ["stranger"]
            return ([book.weight(t) for t in names],
                    [book.quota_rps(t) for t in names],
                    [round(book.global_share(t), 12) for t in names],
                    [round(book.share(t, names[:7]), 12) for t in names],
                    [p.weights.weight_from_annotations(a) for a in
                     anns.values()],
                    [p.weights.quota_from_annotations(a) for a in
                     anns.values()],
                    book.to_json())

        both_equal(scenario)

    @pytest.mark.parametrize("seed", [0, 1])
    def test_shares_taken_once_equal_the_references_per_tenant_shares(
            self, seed):
        """The port's detector takes each tenant's weighted share among
        the served ones from one sum per check (``share_of_among``); each
        value is the reference's ``share(t, among)``, float for float, and
        ``global_share`` (its total kept from the rebuild) the
        reference's."""
        rng = np.random.default_rng(seed)
        names = [f"t{i}" for i in range(300)]
        anns = {t: {ANN_WEIGHT: str(float(rng.choice(
            [0.1, 0.3, 1.0, 7.5, 1e-3, 2.0, 4.0])))} for t in names[:200]}
        anns.update({t: None for t in names[200:]})
        books = []
        for p in BOTH:
            book = p.ten.WeightBook(default_weight=0.7)
            book.rebuild(anns)
            books.append(book)
        ref, port = books
        for _ in range(5):
            among = list(rng.choice(names, size=int(rng.integers(1, 250)),
                                    replace=False))
            share_of = port.share_of_among(among)
            for t in names[:50] + ["stranger"]:
                assert share_of(t) == ref.share(t, among)
        for t in names + ["stranger"]:
            assert port.global_share(t) == ref.global_share(t)

    def test_override_beats_annotation(self):
        def scenario(p):
            book = p.ten.WeightBook(overrides={"t": 9.0})
            book.rebuild({"t": {ANN_WEIGHT: "2"}})
            return book.weight("t")

        assert both_equal(scenario) == 9.0

    def test_share_is_relative_to_backlogged_set(self):
        def scenario(p):
            book = p.ten.WeightBook()
            book.rebuild({"a": {ANN_WEIGHT: "3"}, "b": None})
            return (book.share("a", ["a", "b"]), book.share("a", ["a"]),
                    book.share("b", []))

        assert both_equal(scenario) == (pytest.approx(0.75), 1.0, 1.0)

    def test_engine_binds_annotations_at_reconcile(self):
        def scenario(p):
            engine = build_engine(p, annotations={"t0": {ANN_WEIGHT: "4"},
                                                  "t1": {ANN_CLASS: "silver",
                                                         ANN_QUOTA: "5"}})
            book = engine.tenancy.book
            return ([book.weight(f"t{i}") for i in range(3)],
                    book.quota_rps("t1"), book.to_json())

        w, q, _ = both_equal(scenario)
        assert w == [4.0, 2.0, 1.0] and q == 5.0

    def test_annotations_reach_the_book_through_the_reconciler(self):
        """An AuthConfig's annotations travel reconciler → translate →
        EngineEntry → the weight book, and a change of annotations alone
        (the same compiled corpus: the port's install reuses the previous
        params) rebinds the weights."""
        from test_control_plane import V2_SPEC
        from test_torch_pipeline import PORT as PNS
        from test_torch_pipeline import REF as RNS
        from test_torch_pipeline import engine_of

        def resource(name, host, annotations):
            spec = dict(V2_SPEC, hosts=[host])
            return {"apiVersion": "authorino.kuadrant.io/v1beta2",
                    "kind": "AuthConfig",
                    "metadata": {"name": name, "namespace": "tenant",
                                 "annotations": annotations},
                    "spec": spec}

        def scenario(p):
            ns = RNS if p is REF else PNS
            rec_mod = importlib.import_module(
                f"{p.name}.controllers.reconciler")

            async def body():
                engine = engine_of(ns, max_batch=4)
                rec = rec_mod.AuthConfigReconciler(engine)
                obs = []
                for ann_a in ({ANN_CLASS: "gold", ANN_QUOTA: "7"},
                              {ANN_WEIGHT: "3"}):
                    await rec.reconcile_all([
                        resource("a", "a.example.com", ann_a),
                        resource("b", "b.example.com", {ANN_CLASS: "bronze"})])
                    book = engine.tenancy.book
                    obs.append((book.weight("tenant/a"),
                                book.quota_rps("tenant/a"),
                                book.weight("tenant/b"), book.to_json()))
                upload = None
                if p is PORT:
                    upload = engine._snapshot.upload["mode"]
                return obs, upload

            return run(body())

        want, _ = scenario(REF)
        got, upload = scenario(PORT)
        assert got == want
        assert [o[:3] for o in got] == [(4.0, 7.0, 1.0), (3.0, 0.0, 1.0)]
        # the second install changed annotations only: the port reused
        # the installed params, and still rebound the weights
        assert upload == "reuse"


# ---------------------------------------------------------------------------
# the weighted-fair cut
# ---------------------------------------------------------------------------


def drive_cutter(p, weights, seed, cuts=40, n=16):
    """One seeded arrival-and-cut sequence through ``p``'s FairCutter:
    the selected sequence numbers of each cut, the remainder, the
    deficit table and ``to_json``."""
    rng = np.random.default_rng(seed)
    book = p.ten.WeightBook()
    book.rebuild({t: {ANN_WEIGHT: str(w)} for t, w in weights.items()})
    cutter = p.ten.FairCutter(book.weight)
    names = sorted(weights)
    q, seq, out = deque(), 0, []
    for _ in range(cuts):
        for _ in range(int(rng.integers(0, 3 * n))):
            q.append(P(names[int(rng.integers(len(names)))], seq))
            seq += 1
        batch = cutter.cut(q, n)
        out.append([(x.config_name, x.seq) for x in batch])
    return (out, [x.seq for x in q], sorted(cutter._deficit.items()),
            cutter._last_served, cutter.to_json())


class TestFairCut:
    @pytest.mark.parametrize("weights", [
        {"a": 1.0, "b": 1.0},
        {"a": 1.0, "b": 4.0},
        {"a": 1.0, "b": 2.0, "c": 4.0},
        {"gold": 4.0, "silver": 2.0, "bronze": 1.0, "d1": 1.0, "d2": 1.0},
    ])
    @pytest.mark.parametrize("seed", [0, 7])
    def test_cuts_equal_the_reference(self, weights, seed):
        both_equal(drive_cutter, weights, seed)

    def test_sole_backlogged_tenant_gets_the_full_batch(self):
        def scenario(p):
            book = p.ten.WeightBook()
            book.rebuild({"a": None})
            q = deque(P("a", i) for i in range(40))
            return [x.seq for x in p.ten.FairCutter(book.weight).cut(q, 16)]

        assert both_equal(scenario) == list(range(16))

    def test_uncontended_cut_equals_unfair_pop(self):
        def scenario(p):
            q = deque(P("a", i) for i in range(5))
            batch = p.ten.FairCutter(lambda t: 1.0).cut(q, 8)
            return [x.seq for x in batch], len(q)

        assert both_equal(scenario) == (list(range(5)), 0)

    @pytest.mark.parametrize("weights", [
        {"a": 1.0, "b": 1.0},
        {"a": 1.0, "b": 4.0},
        {"a": 1.0, "b": 2.0, "c": 4.0},
    ])
    def test_share_accuracy_within_one_batch_of_slack(self, weights):
        """With every tenant persistently backlogged, the cumulative
        selected counts track the weight mix within one batch."""
        def scenario(p):
            book = p.ten.WeightBook()
            book.rebuild({t: {ANN_WEIGHT: str(w)} for t, w in weights.items()})
            cutter = p.ten.FairCutter(book.weight)
            n, cuts = 16, 24
            got = {t: 0 for t in weights}
            q, seq = deque(), 0
            for _ in range(cuts):
                for t in weights:
                    for _ in range(2 * n):
                        q.append(P(t, seq))
                        seq += 1
                for x in cutter.cut(q, n):
                    got[x.config_name] += 1
            return got

        got = both_equal(scenario)
        total_w = sum(weights.values())
        for t, w in weights.items():
            assert abs(got[t] - 24 * 16 * w / total_w) <= 16

    def test_work_conserving_spill_when_a_tenant_drains(self):
        def scenario(p):
            book = p.ten.WeightBook()
            book.rebuild({"big": {ANN_WEIGHT: "8"}, "small": None})
            q = deque([P("big", i) for i in range(3)]
                      + [P("small", 100 + i) for i in range(40)])
            batch = p.ten.FairCutter(book.weight).cut(q, 16)
            return [x.config_name for x in batch]

        names = both_equal(scenario)
        assert len(names) == 16 and names.count("big") == 3

    def test_arrival_order_preserved_within_batch_and_remainder(self):
        def scenario(p):
            q = deque(P("hot" if i % 3 else "cold", i) for i in range(30))
            batch = p.ten.FairCutter(lambda t: 1.0).cut(q, 10)
            return [x.seq for x in batch], [x.seq for x in q]

        b, rest = both_equal(scenario)
        assert b == sorted(b) and rest == sorted(rest)
        assert sorted(b + rest) == list(range(30))

    def test_hot_tenant_cannot_starve_cold_rows(self):
        def scenario(p):
            q = deque([P("hot", i) for i in range(200)])
            q.append(P("cold", 999))
            return [x.config_name
                    for x in p.ten.FairCutter(lambda t: 1.0).cut(q, 16)]

        assert "cold" in both_equal(scenario)


# ---------------------------------------------------------------------------
# fairness reorders, it never re-decides
# ---------------------------------------------------------------------------


class TestFairnessExactness:
    def test_verdict_and_attribution_identical_fair_vs_unfair(self):
        """The same multi-tenant burst through a fair-cut engine and an
        unfair one (``tenant_qos=False``) of each package: every
        request's (rule, skipped) columns are equal across all four."""
        docs = [doc(i, allow=(i % 3 != 1)) for i in range(48)]
        names = [f"t{i % 3}" for i in range(48)]

        async def burst(engine):
            return await asyncio.gather(
                *(engine.submit(d, n) for d, n in zip(docs, names)))

        outs = {}
        for p in BOTH:
            for qos in (True, False):
                engine = build_engine(p, tenant_qos=qos, annotations={
                    "t0": {ANN_CLASS: "gold"}})
                outs[p.name, qos] = cols(run(burst(engine)))
        want = outs["authorino_tpu", False]
        assert all(v == want for v in outs.values())

    def test_contended_cut_is_fair_in_the_engine(self):
        """With the plane on, each engine's contended cuts run through the
        fair cutter, and each tenant's rows of the burst are decided and
        counted alike."""
        def scenario(p):
            engine = build_engine(p, n_tenants=2, max_batch=4)

            async def burst():
                return await asyncio.gather(*(
                    engine.submit(doc(i), f"t{i % 2}") for i in range(64)))

            out = cols(run(burst()))
            assert engine.tenancy.cutter.cuts > 0
            assert engine.tenancy.cutter.contended_cuts > 0
            return out, top_counts(engine)

        _, counts = both_equal(scenario)
        assert counts == {"t0": (32, 0, 0), "t1": (32, 0, 0)}

    def test_the_ports_cuts_keep_each_tenants_drr_share(self):
        """The port's engine cuts a standing queue by the weights: over
        its contended cuts each tenant's rows stay within one batch of
        its weighted share (gold 4, silver 2, two at the default 1)."""
        # one batch in flight: the burst stands in the queue
        engine = build_engine(PORT, n_tenants=4, max_batch=8,
                              max_inflight_batches=1, adaptive_window=False,
                              admission_min_cap=4096,
                              annotations={"t0": {ANN_CLASS: "gold"},
                                           "t1": {ANN_CLASS: "silver"}})
        cuts = []
        real = engine.tenancy.cut

        def spy(queue, n):
            batch = real(queue, n)
            cuts.append([x.config_name for x in batch])
            return batch

        engine.tenancy.cut = spy

        async def burst():
            return await asyncio.gather(*(
                engine.submit(doc(i), f"t{i % 4}") for i in range(256)))

        run(burst())
        assert len(cuts) >= 8
        # the first eight cuts, while every tenant is still backlogged
        full = cuts[:8]
        got = {t: sum(c.count(t) for c in full) for t in
               ("t0", "t1", "t2", "t3")}
        total = sum(got.values())
        for t, w in (("t0", 4), ("t1", 2), ("t2", 1), ("t3", 1)):
            assert abs(got[t] - total * w / 8) <= 8, got


# ---------------------------------------------------------------------------
# per-tenant quotas, queue shares and doomed depth
# ---------------------------------------------------------------------------


def drive_admission(p, seed, steps=400):
    """A seeded sequence of enqueues, dequeues, quota and share checks,
    doom depths and wait observations through ``p``'s TenantAdmission on
    a synthetic clock."""
    rng = np.random.default_rng(seed)
    book = p.ten.WeightBook(default_quota_rps=0.0)
    names = [f"t{i}" for i in range(6)]
    book.rebuild({
        "t0": {ANN_QUOTA: "20"}, "t1": {ANN_QUOTA: "1", ANN_CLASS: "gold"},
        "t2": {ANN_CLASS: "silver"}, "t3": None, "t4": {ANN_WEIGHT: "0.5"},
        "t5": {ANN_QUOTA: "5"}})
    adm = p.ten.TenantAdmission(book, target_s=0.05, interval_s=0.5)
    now, out, queued = 1000.0, [], deque()
    for _ in range(steps):
        now += float(rng.exponential(0.005))
        t = names[int(rng.integers(len(names)))]
        op = int(rng.integers(6))
        if op < 2:
            adm.on_enqueue(t)
            queued.append(P(t))
        elif op == 2 and queued:
            k = int(rng.integers(1, min(len(queued), 16) + 1))
            adm.on_dequeue([queued.popleft() for _ in range(k)])
        elif op == 3:
            out.append(("quota", t, adm.quota_reject(t, now=now)))
        elif op == 4:
            out.append(("share", t, adm.share_reject(t, len(queued), 64),
                        adm.doom_depth(t, len(queued))))
        else:
            w = float(rng.exponential(0.06))
            adm.observe_waits(t, w, w / 2, now=now)
            out.append(("wait", t, adm.overloaded(t),
                        round(adm.wait_ewma(t), 12)))
        if op == 3 and out[-1][2] is not None:
            adm.count_reject(t, out[-1][2][1])
    return out, adm.to_json(), sorted(adm.backlogged_tenants())


class TestTenantQuota:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_seeded_admission_sequences_equal_the_reference(self, seed):
        out, js, _ = both_equal(drive_admission, seed)
        assert any(o[0] == "quota" and o[2] is not None for o in out)
        assert js["rejected"]

    def test_over_quota_tenant_rejected_typed_and_scoped(self):
        def scenario(p):
            engine = build_engine(p, n_tenants=2,
                                  annotations={"t0": {ANN_QUOTA: "1"}})

            async def burst():
                codes, ok = [], 0
                for i in range(40):
                    try:
                        await engine.submit(doc(i), "t0")
                        ok += 1
                    except p.rpc.CheckAbort as e:
                        codes.append((e.code, e.message))
                for i in range(8):
                    await engine.submit(doc(i), "t1")
                return ok, codes

            with frozen_admission_clock(p):
                ok, codes = run(burst())
            assert codes and ok >= 1
            assert all(c == p.rpc.RESOURCE_EXHAUSTED for c, _ in codes)
            assert all("tenant t0" in m for _, m in codes)
            # tenant-scoped: the global latch is untouched
            assert engine.admission.state == p.adm.ADMIT
            rej = engine.tenancy.admission.rejected
            assert rej["t0"][p.ten.R_TENANT_QUOTA] == len(codes)
            assert "t1" not in rej
            return (sorted(set(codes)), ok + len(codes),
                    engine.admission.rejected.get("tenant-quota"),
                    top_counts(engine)["t1"])

        (code_msg,), n, n_rej, t1 = both_equal(scenario)
        assert code_msg == (8, "tenant t0 over its QoS budget (tenant-quota)"
                               ": admission rejected")
        # a burst of one token, none refilled: 1 admitted, 39 rejected
        assert n == 40 and n_rej == 39 and t1 == (8, 0, 0)

    def test_plane_admit_on_a_synthetic_clock(self):
        """quota, queue share and containment pacing in the reference's
        order, decision for decision."""
        def scenario(p):
            plane = p.ten.TenantPlane(contain_allowance_rps=2.0)
            plane.bind_entries([SimpleNamespace(id="q", annotations={
                ANN_QUOTA: "4"}), SimpleNamespace(id="c", annotations=None),
                SimpleNamespace(id="x", annotations=None)])
            det = plane.detector
            det._contained["c"] = {"since": 0.0}
            det._pacers["c"] = p.quota.TokenBucket(2.0, now=500.0)
            for _ in range(60):
                plane.on_enqueue("x")
            out = []
            for k in range(60):
                now = 500.0 + 0.05 * k
                for t in ("q", "c", "x"):
                    out.append(plane.admit(t, now=now, depth=40 + k,
                                           effective_cap=64))
            return out, plane.doom_depth("x", 40), plane.to_json()["weights"]

        out, doom, _ = both_equal(scenario)
        reasons = {r[1] for r in out if r is not None}
        assert reasons == {"tenant-quota", "tenant-contained",
                           "tenant-queue-share"}

    def test_doom_depth_is_per_tenant(self):
        def scenario(p):
            book = p.ten.WeightBook()
            book.rebuild({"hot": None, "cold": None})
            adm = p.ten.TenantAdmission(book)
            for _ in range(1000):
                adm.on_enqueue("hot")
            a = (adm.doom_depth("cold", 1000), adm.doom_depth("hot", 1000))
            adm.on_dequeue([P("hot") for _ in range(900)])
            return a, adm.doom_depth("hot", 100)

        assert both_equal(scenario) == ((0, 1000), 100)

    def test_queue_share_bound_scopes_to_the_flooding_tenant(self):
        def scenario(p):
            book = p.ten.WeightBook()
            book.rebuild({f"t{i}": None for i in range(32)})
            adm = p.ten.TenantAdmission(book)
            for _ in range(200):
                adm.on_enqueue("t0")
            for _ in range(3):
                adm.on_enqueue("t1")
            return (adm.share_reject("t0", global_depth=203,
                                     effective_cap=256),
                    adm.share_reject("t1", 203, 256),
                    adm.share_reject("t0", 100, 256))

        flood, victim, idle = both_equal(scenario)
        assert flood[1] == "tenant-queue-share" and victim is None \
            and idle is None

    def test_global_share_ignores_backlog_composition(self):
        def scenario(p):
            book = p.ten.WeightBook()
            book.rebuild({f"t{i}": None for i in range(10)})
            return book.global_share("t0"), book.global_share("stranger")

        assert both_equal(scenario) == (pytest.approx(0.1),
                                        pytest.approx(1.0 / 11.0))

    def test_admission_controller_uses_doom_depth(self):
        def scenario(p):
            ctrl = p.adm.AdmissionController("x", target_s=0.01)
            ctrl._service_rate = 100.0
            now = 1000.0
            deadline = now + 0.5
            return (ctrl.admit(1000, now=now, deadline=deadline),
                    ctrl.admit(0, now=now, deadline=deadline, doom_depth=0))

        doomed, ok = both_equal(scenario)
        assert doomed is not None and ok is None

    def test_engine_doomed_deadline_is_tenant_scoped(self):
        """A request whose deadline its tenant's own standing queue dooms
        is shed typed and counted against that tenant (``doomed-
        deadline``), in both engines."""
        def scenario(p):
            engine = build_engine(p, n_tenants=2)
            ten = engine.tenancy

            async def one(t):
                try:
                    await engine.submit(doc(1), t,
                                        deadline=time.monotonic() + 0.5)
                    return None
                except p.rpc.CheckAbort as e:
                    return e.code, e.message

            async def body():
                # a full window holds 50 of t0's requests in the queue
                engine._inflight = engine.controller.window
                standing = [asyncio.ensure_future(engine.submit(doc(i), "t0"))
                            for i in range(50)]
                await asyncio.sleep(0)
                engine.admission._service_rate = 10.0
                hot = await one("t0")
                cold = asyncio.ensure_future(one("t1"))
                await asyncio.sleep(0)
                engine._inflight = 0
                engine._maybe_dispatch()
                await asyncio.gather(*standing)
                return hot, await cold

            got = run(body())
            return got, dict(ten.admission.rejected)

        (hot, cold), rej = both_equal(scenario)
        assert hot == (4, "rejected at admission: deadline cannot be met")
        assert cold is None and rej == {"t0": {"doomed-deadline": 1}}


# ---------------------------------------------------------------------------
# per-tenant folds, KeyedBurn, top-K labels
# ---------------------------------------------------------------------------


def drive_stats(p, seed, folds=60):
    rng = np.random.default_rng(seed)
    names = [f"cfg{i}" for i in range(24)]
    heat = StubHeat(names)
    stats = p.ten.TenantStats(f"seeded-lane-{seed}", top_k=6)
    sink = []
    stats.wait_sink = lambda t, mean, mn, now: sink.append(
        (t, round(mean, 12), round(mn, 12), now))
    now = 2000.0
    zipf = 1.0 / np.arange(1, len(names) + 1) ** 1.3
    zipf /= zipf.sum()
    for k in range(folds):
        now += float(rng.exponential(0.04))
        n = int(rng.integers(1, 64))
        rows = rng.choice(len(names), size=n, p=zipf)
        firing = np.where(rng.random(n) < 0.3,
                          rng.integers(0, 3, size=n), -1)
        waits = rng.exponential(0.03, size=n) if k % 3 else None
        bad = (rng.random(n) < 0.1) if k % 2 else None
        stats.fold(heat, rows, firing=firing, waits=waits, bad_mask=bad,
                   now=now)
    stats.flush(now=now)
    return (stats.to_json(top=30), {t: round(s, 12) for t, s in
                                    stats.shares().items()},
            {t: {k: round(v, 12) for k, v in d.items()}
             for t, d in stats.export_fold().items()},
            sorted(stats._label_of), sink)


class TestTenantStats:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_seeded_folds_equal_the_reference(self, seed):
        js, shares, _, labels, _ = both_equal(drive_stats, seed)
        assert js["fold_calls"] == 60 and shares
        # minted labels only grow, up to the family's bound
        assert 6 <= len(labels) <= PORT.metrics.TENANT_LABEL_BOUNDS[
            "auth_server_tenant_requests_total"]

    def test_fold_is_vectorized_per_batch(self):
        def scenario(p):
            stats = p.ten.TenantStats("test-lane")
            rows = np.array([0, 0, 0, 1, 0, 1])
            firing = np.array([-1, 0, -1, -1, 2, -1])
            waits = np.array([0.01, 0.02, 0.03, 0.001, 0.02, 0.002])
            stats.fold(StubHeat(["a", "b"]), rows, firing=firing, waits=waits,
                       bad_mask=waits > 0.015, now=3000.0)
            return stats.fold_calls, stats.to_json()

        calls, j = both_equal(scenario)
        by = {r["tenant"]: r for r in j["top"]}
        assert calls == 1
        assert (by["a"]["requests"], by["a"]["denies"], by["a"]["slo_bad"]) \
            == (4, 2, 3)
        assert (by["b"]["requests"], by["b"]["denies"], by["b"]["slo_bad"]) \
            == (2, 0, 0)

    def test_shares_decay_toward_live_traffic(self):
        def scenario(p):
            stats = p.ten.TenantStats("test-lane2")
            heat = StubHeat(["hot", "cold"])
            t0 = 4000.0
            for k in range(10):
                stats.fold(heat, np.array([0] * 9 + [1]),
                           firing=np.full(10, -1), now=t0 + 0.1 * (k + 1))
            return stats.shares()

        shares = both_equal(scenario)
        assert shares["hot"] > 5 * shares["cold"]

    def test_keyed_burn_window(self):
        def scenario(p):
            burn = p.slo.KeyedBurn(window_s=10.0, objective=0.9)
            burn.fold("t", 100, 50, now=1000.0)
            a = burn.burn("t", now=1000.0)
            burn.fold("t", 100, 0, now=1011.0)
            return a, burn.burn("t", now=1011.0), burn.to_json()

        a, b, _ = both_equal(scenario)
        assert a == pytest.approx(5.0) and b == pytest.approx(0.0)

    def test_top_k_bound_caps_minted_labels(self):
        def scenario(p):
            stats = p.ten.TenantStats("test-lane3", top_k=4)
            stats.fold(StubHeat([f"cfg{i}" for i in range(100)]),
                       np.arange(100), firing=np.full(100, -1))
            stats.flush()
            return len(stats._label_of)

        n = both_equal(scenario)
        assert n <= PORT.metrics.TENANT_LABEL_BOUNDS[
            "auth_server_tenant_requests_total"]

    def test_the_label_bounds_and_fold_over_equal_the_reference(self):
        assert PORT.metrics.TENANT_LABEL_BOUNDS == \
            REF.metrics.TENANT_LABEL_BOUNDS
        assert PORT.metrics.TENANT_OTHER == REF.metrics.TENANT_OTHER


# ---------------------------------------------------------------------------
# noisy-neighbor containment
# ---------------------------------------------------------------------------


def detector(p, wait=None, lane="contain-lane"):
    wait = [0.5] if wait is None else wait
    book = p.ten.WeightBook()
    book.rebuild({"hot": None, "c1": None, "c2": None, "c3": None})
    stats = p.ten.TenantStats(lane)
    det = p.ten.NoisyNeighborDetector(
        book, stats, wait_ewma=lambda: wait[0], target_s=lambda: 0.05,
        lane=lane, threshold=2.0, sustain_s=0.0, release_s=0.0)
    return stats, det, wait


def feed(stats, hot_frac, t0, k0=0, n=10):
    heat = StubHeat(["hot", "c1", "c2", "c3"])
    hot_n = int(16 * hot_frac)
    rows = np.array([0] * hot_n + [1, 2, 3] * ((16 - hot_n) // 3 + 1))
    for k in range(n):
        stats.fold(heat, rows[:16], firing=np.full(16, -1),
                   now=t0 + 0.1 * (k0 + k + 1))


class TestContainment:
    def test_contain_fires_and_auto_releases(self):
        def scenario(p):
            stats, det, wait = detector(p)
            t0 = 5000.0
            feed(stats, hot_frac=0.9, t0=t0)
            ring0 = p.recorder.events_total
            det.check(now=t0 + 2.0)
            fired = (det.is_contained("hot"), det.contain_total,
                     p.recorder.events_total > ring0, det.to_json())
            feed(stats, hot_frac=0.25, t0=t0 + 2.0, k0=20, n=30)
            wait[0] = 0.0
            det.check(now=t0 + 10.0)
            return fired, (det.is_contained("hot"), det.release_total,
                           det.to_json())

        (on, n_on, rec, _), (still, n_off, _) = both_equal(scenario)
        assert on and n_on == 1 and rec
        assert not still and n_off == 1

    def test_no_containment_without_global_pressure(self):
        def scenario(p):
            stats, det, _ = detector(p, wait=[0.0])
            feed(stats, hot_frac=0.9, t0=6000.0)
            det.check(now=6002.0)
            return det.has_contained(), det.to_json()

        assert both_equal(scenario)[0] is False

    def test_contained_pacing_rejects_past_allowance(self):
        def scenario(p):
            stats, det, _ = detector(p)
            det.allowance_rps = 1.0
            feed(stats, hot_frac=0.9, t0=7000.0)
            det.check(now=7002.0)
            return [det.pace_reject("hot", now=7002.001 + 0.01 * k)
                    for k in range(150)]

        rej = both_equal(scenario)
        assert 1 <= rej.count(False) < 150

    @pytest.mark.parametrize("seed", [0, 1])
    def test_seeded_pressure_sequences_fire_and_release_alike(self, seed):
        """Shares and the global wait swing on a seeded schedule; every
        check's contained set and the detector's JSON are equal."""
        def scenario(p):
            rng = np.random.default_rng(seed)
            wait = [0.0]
            stats, det, _ = detector(p, wait=wait, lane=f"seq{seed}")
            det.sustain_s, det.release_s = 0.3, 0.8
            rejects = [0]
            det.reject_count = lambda: rejects[0]
            t, out = 8000.0, []
            for k in range(80):
                phase = (k // 20) % 2
                hot = 0.85 if phase == 0 else 0.2
                feed(stats, hot, t0=t, n=1)
                t += 0.1
                wait[0] = float(rng.uniform(0.06, 0.2)) if phase == 0 \
                    else float(rng.uniform(0.0, 0.04))
                if rng.random() < 0.1:
                    rejects[0] += 1
                det.check(now=t)
                out.append(sorted(det.contained()))
            return out, det.to_json()

        out, js = both_equal(scenario)
        assert js["contain_total"] >= 1 and js["release_total"] >= 1
        assert any(out) and not all(out)

    def test_engine_wires_contained_rejection_typed(self):
        def scenario(p):
            engine = build_engine(p, n_tenants=2)
            det = engine.tenancy.detector
            det._contained["t0"] = {"since": time.monotonic()}
            det._pacers["t0"] = p.quota.TokenBucket(0.000001, burst=0.000001)

            async def one():
                try:
                    await engine.submit(doc(1), "t0")
                    return None
                except p.rpc.CheckAbort as e:
                    return e.code, e.message

            e = run(one())
            assert engine.admission.state == p.adm.ADMIT
            return e, dict(engine.tenancy.admission.rejected)

        e, rej = both_equal(scenario)
        assert e == (8, "tenant t0 over its QoS budget (tenant-contained): "
                        "admission rejected")
        assert rej == {"t0": {"tenant-contained": 1}}

    def test_contained_rows_ride_their_own_parts(self):
        """A contained tenant's admitted rows are decided exactly as the
        reference decides them, and count against the same tenant.  On a
        CPU engine the port routes them as the reference does, to the
        host-oracle lane (``host:tenant-contained``); an engine with no
        host lane (a card's) cuts them into parts of their own on the
        device path, after the cut's other parts — the divergence by
        design, counted as contained parts."""
        docs = [doc(i, allow=(i % 4 != 1)) for i in range(48)]
        names = [f"t{i % 3}" for i in range(48)]

        class CardShaped(PORT.runtime.PolicyEngine):
            host_degrade = property(lambda self: False)

        def scenario(p, card=False):
            if card:
                engine = CardShaped(members_k=4, device="cpu",
                                    lane_select=False, brownout=False,
                                    verdict_cache_size=0, max_batch=8)
                engine.apply_snapshot(entries(p))
            else:
                engine = build_engine(p)
            det = engine.tenancy.detector
            det._contained["t0"] = {"since": time.monotonic()}
            det._pacers["t0"] = p.quota.TokenBucket(1e9)
            det.check_interval_s = 1e9  # no release mid-burst
            parts = []
            if p is PORT:
                real = engine._encode_launch_job

                def spy(snap, part, attempt=0, spec=None):
                    parts.append([(x.config_name, x.contained) for x in part])
                    return real(snap, part, attempt, spec)

                engine._encode_launch_job = spy

            async def burst():
                return await asyncio.gather(*(
                    engine.submit(d, n) for d, n in zip(docs, names)))

            out = cols(run(burst()))
            det._contained.clear()
            det._pacers.clear()
            return out, top_counts(engine), engine, parts

        want, want_counts, ref_engine, _ = scenario(REF)
        got, got_counts, engine, parts = scenario(PORT)
        assert got == want and got_counts == want_counts
        assert want_counts["t0"] == (16, 4, 0)
        # a CPU engine: the reference's route and its counts
        assert ref_engine.lanes.decisions.get("host:tenant-contained", 0) >= 1
        assert engine.lanes.decisions.get("host:tenant-contained", 0) >= 1
        assert engine.stats["contained_parts"] == 0
        # past the host cap a contained row stays in the cut (the
        # reference's rule), so at most its 16 rows ride the host lane
        assert 1 <= engine.lanes.rows["host"] <= 16
        # no host lane: the contained rows ride parts of their own
        got, got_counts, engine, parts = scenario(PORT, card=True)
        assert got == want and got_counts == want_counts
        assert "host:tenant-contained" not in engine.lanes.decisions
        assert engine.stats["contained_rows"] == 16
        assert engine.stats["contained_parts"] >= 1
        for part in parts:
            kinds = {c for _, c in part}
            assert len(kinds) == 1
            if kinds == {True}:
                assert {n for n, _ in part} == {"t0"}
            else:
                assert "t0" not in {n for n, _ in part}
        recs = [r for r in engine.batch_records if r.get("contained")]
        assert len(recs) == engine.stats["contained_parts"]
        assert sum(r["rows"] for r in recs) == 16


# ---------------------------------------------------------------------------
# lane parity: a degraded batch burns the right tenant
# ---------------------------------------------------------------------------


class TestLaneParity:
    def test_degrade_lane_feeds_tenant_fold(self):
        def scenario(p):
            engine = build_engine(p, n_tenants=2, breaker_threshold=1)
            for _ in range(3):
                engine.breaker.record_failure()

            async def burst():
                return await asyncio.gather(*(
                    engine.submit(doc(i, allow=False), f"t{i % 2}")
                    for i in range(8)))

            out = cols(run(burst()))
            return out, top_counts(engine)

        _, counts = both_equal(scenario)
        assert counts == {"t0": (4, 4, 0), "t1": (4, 4, 0)}

    def test_device_and_host_lane_counts_agree(self):
        def scenario(p):
            counts = {}
            for mode, threshold in (("device", 5), ("degrade", 1)):
                engine = build_engine(p, n_tenants=2,
                                      breaker_threshold=threshold)
                if mode == "degrade":
                    for _ in range(3):
                        engine.breaker.record_failure()

                async def burst(engine=engine):
                    await asyncio.gather(*(
                        engine.submit(doc(i, allow=(i % 4 != 1)),
                                      f"t{i % 2}") for i in range(16)))

                run(burst())
                counts[mode] = top_counts(engine)
            assert counts["device"] == counts["degrade"]
            return counts

        both_equal(scenario)

    def test_slo_mask_reads_the_sojourn(self):
        """With ``slo_ms`` the fold's SLO mask is the sojourn at
        completion: a 0.001 ms target marks every request bad, on both
        lanes of both engines."""
        def scenario(p):
            out = {}
            for mode in ("device", "degrade"):
                engine = build_engine(p, n_tenants=2, slo_ms=0.001,
                                      breaker_threshold=1)
                if mode == "degrade":
                    engine.breaker.record_failure()

                async def burst(engine=engine):
                    await asyncio.gather(*(
                        engine.submit(doc(i), f"t{i % 2}")
                        for i in range(6)))

                run(burst())
                out[mode] = top_counts(engine)
            return out

        assert both_equal(scenario)["device"] == {"t0": (3, 0, 3),
                                                  "t1": (3, 0, 3)}


# ---------------------------------------------------------------------------
# stratified decision sampling
# ---------------------------------------------------------------------------


class TestStratifiedDecisions:
    def test_cold_tenant_records_survive_hot_flood(self):
        def scenario(p):
            log = p.prov.DecisionLog(capacity=8, sample_n=1,
                                     tenant_capacity=2)
            log.record(lane="l", host="h", authconfig="cold", verdict=True,
                       rule=None, rule_index=-1, latency_ms=1, generation=1)
            for _ in range(50):
                log.record(lane="l", host="h", authconfig="hot",
                           verdict=False, rule="0:x", rule_index=0,
                           latency_ms=1, generation=1)
            strip = lambda rs: [{k: v for k, v in r.items() if k != "t"}  # noqa: E731
                                for r in rs]
            return (strip(log.to_json()["records"]),
                    strip(log.to_json(tenant="cold")["records"]))

        hot, cold = both_equal(scenario)
        assert all(r["authconfig"] == "hot" for r in hot)
        assert len(cold) == 1 and cold[0]["authconfig"] == "cold"

    def test_at_most_one_record_per_tenant_per_batch(self):
        def scenario(p):
            d = p.prov.DECISIONS
            saved = (d.capacity, d.sample_n)
            d.configure(sample_n=1)
            try:
                heat = p.prov.HeatMap(["hot", "cold"], [["r"], ["r"]], 1)
                before = d.records_total
                p.prov.fold_and_sample(heat, np.array([0] * 20 + [1]),
                                       np.full(21, -1), 21, lane="l")
                return (d.records_total - before,
                        sorted(r["authconfig"]
                               for r in d.to_json(n=2)["records"]))
            finally:
                d.configure(capacity=saved[0], sample_n=saved[1])

        assert both_equal(scenario) == (2, ["cold", "hot"])

    def test_single_tenant_batches_still_one_record_per_batch(self):
        def scenario(p):
            d = p.prov.DECISIONS
            saved = d.sample_n
            d.configure(sample_n=1)
            try:
                heat = p.prov.HeatMap(["only"], [["r"]], 1)
                before = d.records_total
                p.prov.fold_and_sample(heat, np.zeros(64, dtype=int),
                                       np.full(64, -1), 64, lane="l")
                return d.records_total - before
            finally:
                d.configure(sample_n=saved)

        assert both_equal(scenario) == 1

    def test_cold_tenant_first_appearance_always_samples(self):
        def scenario(p):
            d = p.prov.DECISIONS
            saved = d.sample_n
            d.configure(sample_n=1000)
            try:
                return (d.should_sample_tenant("brand-new-tenant", 5),
                        d.should_sample_tenant("brand-new-tenant", 5))
            finally:
                d.configure(sample_n=saved)

        assert both_equal(scenario) == (True, False)


# ---------------------------------------------------------------------------
# the per-tenant canary guard
# ---------------------------------------------------------------------------


class TestTenantCanaryGuard:
    def test_tenant_rejection_delta_breaches(self):
        def scenario(p):
            guard = p.cs.CanaryGuard(changed={"t"}, check_interval_s=0.0)
            heat = StubHeat(["t"])
            rows, firing = np.zeros(16, dtype=int), np.full(16, -1)
            for _ in range(4):
                guard.observe_batch(False, rows, firing, heat)
                guard.observe_batch(True, rows, firing, heat)
            guard.observe_tenant_rejection(True, "t", n=64)
            b = guard.breach(force=True)
            return sorted(b["guards"]), b["suspects"], guard.to_json()

        guards, suspects, _ = both_equal(scenario)
        assert "tenant-rejection-rate" in guards and "t" in suspects

    def test_unchanged_tenant_rejections_do_not_breach(self):
        def scenario(p):
            guard = p.cs.CanaryGuard(changed={"other"}, check_interval_s=0.0)
            heat = StubHeat(["t"])
            rows, firing = np.zeros(16, dtype=int), np.full(16, -1)
            for _ in range(4):
                guard.observe_batch(False, rows, firing, heat)
                guard.observe_batch(True, rows, firing, heat)
            guard.observe_tenant_rejection(True, "t", n=64)
            return guard.breach(force=True)

        assert both_equal(scenario) is None

    def test_engine_feeds_the_guard_and_rolls_back(self):
        """A canaried change of t0's rules whose canary-cohort requests
        meet t0's emptied quota bucket (the baseline cohort's arrive
        first): each engine feeds every tenant rejection to the guard by
        cohort, ``tenant-rejection-rate`` breaches and the canary rolls
        back, quarantining t0.  The quota knows no cohort: arrivals of
        both cohorts interleaved would be rejected alike and not breach.
        The quarantine's substituted entry carries no annotations in
        either package, so t0's quota is gone after it."""
        from test_torch_change_safety import docs_in_cohort

        def scenario(p):
            engine = build_engine(
                p, canary_fraction=0.5, canary_window_s=60.0,
                canary_thresholds=p.cs.GuardThresholds(
                    min_requests=8, min_config_requests=4,
                    min_config_allows=2, min_tenant_attempts=8),
                annotations={"t0": {ANN_QUOTA: "10"}})
            e = p.expr
            changed = e.All(e.Pattern("auth.identity.roles", e.Operator.INCL,
                                      "admin"))
            ents = entries(p, 3, {"t0": {ANN_QUOTA: "10"}})
            ents[0] = p.runtime.EngineEntry(
                id="t0", hosts=["t0"], runtime=None,
                rules=p.compiler.ConfigRules(name="t0",
                                             evaluators=[(None, changed)]),
                annotations={ANN_QUOTA: "10"})
            engine.apply_snapshot(ents)
            phase = engine._canary
            assert phase is not None
            phase.guard.check_interval_s = 0.0   # judge at every feed
            base = docs_in_cohort(p, "x", 10, 0.5, False)
            can = docs_in_cohort(p, "x", 20, 0.5, True)
            for d in base + can:
                d["auth"] = doc(0)["auth"]

            async def feed(docs):
                codes = []
                for d in docs:
                    try:
                        await engine.submit(d, "t0")
                        codes.append(0)
                    except p.rpc.CheckAbort as ex:
                        codes.append(ex.code)
                return codes

            # 8 canary-cohort rejections reach min_tenant_attempts; the
            # quota's bucket holds 10 tokens for the baseline's 10 requests
            # and refills none for the canary's
            with frozen_admission_clock(p):
                codes = run(feed(base + can[:8]))
            b = phase.guard.breach(force=True)
            # the port decides on the encode pool: wait for its rollback
            deadline = time.monotonic() + 10
            while engine._canary is not None and time.monotonic() < deadline:
                time.sleep(0.01)
            rb = engine._last_rollback or {}
            # the quarantine re-serves t0's prior entry, which (in both
            # packages) carries no annotations: t0's quota is gone
            codes += run(feed(can[8:]))
            return (codes, sorted(b["guards"]), b["suspects"],
                    engine._canary is None, rb.get("reason"),
                    rb.get("quarantined"), engine.tenancy.book.quota_rps("t0"))

        codes, guards, suspects, rolled, reason, quarantined, quota = \
            both_equal(scenario)
        assert codes == [0] * 10 + [8] * 8 + [0] * 12
        assert "tenant-rejection-rate" in guards and "t0" in suspects
        assert rolled and reason == "guard-breach" and quarantined == ["t0"]
        assert quota == 0.0


# ---------------------------------------------------------------------------
# /debug/tenants, debug vars, the CLI end to end
# ---------------------------------------------------------------------------


def cli_tenancy_run(which, d):
    """One package's CLI server (``--native-frontend off``) over the
    control-plane manifests with ``key-0`` annotated gold and ``key-1``
    given a quota of 0.1 requests/s: 32 concurrent gRPC Check()s, then
    ``/debug/tenants``.  Returns the plane's weights, each tenant's
    (requests, denies), the tenant rejections and the sorted codes."""
    import grpc

    from authorino_tpu import cli as ref_cli
    from authorino_tpu_torch import cli as port_cli
    from authorino_tpu_torch.models import control_plane as cp
    from test_torch_cli import (CHECK, free_port, http_get, http_get_or_none,
                                pb, wire_request)

    d.mkdir(parents=True)
    n = 4
    docs = cp.build_auth_configs(n, 3) + [cp.api_key_secret(i)
                                          for i in range(n)]
    docs[0]["metadata"]["annotations"] = {ANN_CLASS: "gold"}
    docs[1]["metadata"]["annotations"] = {ANN_QUOTA: "0.1"}
    for k, m in enumerate(docs):
        (d / f"{k}.json").write_text(json.dumps(m))
    argv = ["server", "--ext-auth-grpc-port", str(free_port()),
            "--ext-auth-http-port", str(free_port()),
            "--oidc-http-port", str(free_port()), "--native-frontend", "off",
            "--watch-dir", str(d)]
    if which == "ref":
        args = ref_cli.build_parser().parse_args(
            argv + ["--jax-platform", "cpu"])
        serve = ref_cli.run_server
    else:
        args = port_cli.build_parser().parse_args(argv + ["--device", "cpu"])
        serve = port_cli.run_server
    reqs, _, _ = cp.build_check_requests(32, n)

    async def body():
        task = asyncio.ensure_future(serve(args))
        t0 = time.monotonic()
        while (await asyncio.to_thread(http_get_or_none,
                                       args.ext_auth_http_port,
                                       "/readyz"))[0] != 200:
            assert not task.done(), task
            assert time.monotonic() - t0 < 120
            await asyncio.sleep(0.05)
        async with grpc.aio.insecure_channel(
                f"127.0.0.1:{args.ext_auth_grpc_port}") as ch:
            call = ch.unary_unary(CHECK, request_serializer=lambda b: b,
                                  response_deserializer=lambda b: b)
            got = [pb.CheckResponse.FromString(r) for r in
                   await asyncio.gather(*(call(wire_request(q))
                                          for q in reqs))]
        status, text = await asyncio.to_thread(
            http_get, args.ext_auth_http_port, "/debug/tenants")
        task.cancel()
        try:
            await task
        except asyncio.CancelledError:
            pass
        return got, status, text

    got, status, text = run(body())
    assert status == 200
    plane = json.loads(text)
    assert plane["enabled"] is True
    return (plane["weights"],
            {r["tenant"]: (r["requests"], r["denies"])
             for r in plane["stats"]["top"]},
            plane["admission"]["rejected"],
            sorted(g.status.code for g in got))


class TestDebugSurfaces:
    def test_debug_tenants_endpoint(self):
        from aiohttp.test_utils import TestClient, TestServer

        def scenario(p):
            http = importlib.import_module(f"{p.name}.service.http_server")
            engine = build_engine(p, n_tenants=2, annotations={
                "t0": {ANN_CLASS: "gold", ANN_QUOTA: "100"}})

            async def body():
                await asyncio.gather(*(engine.submit(doc(i, i % 3 != 1),
                                                     f"t{i % 2}")
                                       for i in range(12)))
                client = TestClient(TestServer(http.build_app(engine)))
                await client.start_server()
                try:
                    plane = await (await client.get("/debug/tenants")).json()
                    dec = await (await client.get(
                        "/debug/decisions?tenant=t0")).json()
                finally:
                    await client.close()
                return plane, dec

            plane, dec = run(body())
            assert plane["enabled"] is True and dec["tenant"] == "t0"
            return (plane["weights"], plane["stats"]["requests_total"],
                    {r["tenant"]: (r["requests"], r["denies"])
                     for r in plane["stats"]["top"]},
                    plane["admission"]["rejected"],
                    plane["containment"]["contained"])

        w, total, top, rej, cont = both_equal(scenario)
        assert total == 12 and top == {"t0": (6, 2), "t1": (6, 2)}
        assert w["non_default_weights"] == {"t0": 4.0}

    def test_engine_debug_vars_carry_tenancy(self):
        def scenario(p):
            dv = build_engine(p, n_tenants=1).debug_vars()
            json.dumps(dv["tenancy"])
            return sorted(dv["tenancy"]), dv["tenancy"]["enabled"]

        keys, on = both_equal(scenario)
        assert on is True and {"containment", "fair_cut"} <= set(keys)

    def test_plane_off_serves_a_disabled_plane(self):
        def scenario(p):
            engine = build_engine(p, n_tenants=2, tenant_qos=False)

            async def burst():
                return await asyncio.gather(*(
                    engine.submit(doc(i), f"t{i % 2}") for i in range(8)))

            run(burst())
            j = engine.tenancy.to_json()
            return (j["enabled"], j["stats"]["requests_total"],
                    j["fair_cut"]["cuts"])

        assert both_equal(scenario) == (False, 0, 0)

    def test_native_frontend_shares_the_engines_plane(self):
        """The port's native frontend folds its slots into the engine's
        plane and serves it in its debug vars (the reference's
        ``debug_vars()["tenancy"]``)."""
        from authorino_tpu_torch.runtime import native_frontend as port_nf

        engine = build_engine(PORT, n_tenants=2)
        fe = port_nf.NativeFrontend(engine, port=0, max_batch=16,
                                    window_us=500)
        assert fe.tenancy is engine.tenancy
        assert fe.debug_vars()["tenancy"] == engine.tenancy.to_json()

    def test_cli_server_end_to_end(self, tmp_path):
        """Each package's CLI server over the same annotated manifests:
        gRPC checks against a gold tenant and a quota'd one, then
        /debug/tenants; the plane's weights, counters and rejections are
        equal."""
        want = cli_tenancy_run("ref", tmp_path / "ref")
        got = cli_tenancy_run("port", tmp_path / "port")
        assert got == want
        weights, counts, rejected, codes = got
        assert weights["non_default_weights"] == {"keys/key-0": 4.0}
        assert weights["quotas"] == {"keys/key-1": 0.1}
        assert rejected["keys/key-1"]["tenant-quota"] >= 1
        assert codes.count(8) == rejected["keys/key-1"]["tenant-quota"]
