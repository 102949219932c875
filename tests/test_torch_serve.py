"""The port's serving tier, read path, against the JAX package.

The tenant registry's bounds, the admission controller's verdict
sequences under a fake clock (queue, timeout to shed, the interactive
clamp, fail-open under a ``serve.admit`` fault), the admission curve,
``build_requests`` schedules, the load harness at 4–8 threads over a
small seeded corpus (every served result byte-equal to the JAX
package's serial oracle, every unserved one a typed shed), the serving
health rules on seeded histograms, and the sidecar's serving block and
``insights.serving()`` — each held against the JAX package on the same
seeded inputs. The port's device path runs on CPU tensors
(``aggregation.config.device = "cpu"``); the ``cuda``-marked case runs
the harness over packs on the card and skips here. No wall is compared.
"""

import threading
import time

import numpy as np
import pytest
import torch

from roaringbitmap_tpu import observe as jobs
from roaringbitmap_tpu.cost import admission as jadm_cost
from roaringbitmap_tpu.models.roaring import RoaringBitmap as JRB
from roaringbitmap_tpu.observe import export as jexport
from roaringbitmap_tpu.observe import health as jhealth
from roaringbitmap_tpu.observe import outcomes as jout
from roaringbitmap_tpu.parallel import store as jstore
from roaringbitmap_tpu.query import inflight as jinflight
from roaringbitmap_tpu.robust import faults as jfaults
from roaringbitmap_tpu import serve as jserve
from roaringbitmap_tpu.serve import admission as jadm
from roaringbitmap_tpu.serve import slo as jslo

from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch import insights as tinsights
from roaringbitmap_tpu_torch import observe as tobs
from roaringbitmap_tpu_torch import query as tq
from roaringbitmap_tpu_torch import serve as tserve
from roaringbitmap_tpu_torch.cost import admission as tadm_cost
from roaringbitmap_tpu_torch.observe import export as texport
from roaringbitmap_tpu_torch.observe import health as thealth
from roaringbitmap_tpu_torch.observe import outcomes as tout
from roaringbitmap_tpu_torch.parallel import aggregation, store
from roaringbitmap_tpu_torch.query import inflight as tinflight
from roaringbitmap_tpu_torch.robust import faults as tfaults
from roaringbitmap_tpu_torch.robust import ladder as tladder
from roaringbitmap_tpu.robust import ladder as jladder
from roaringbitmap_tpu_torch.robust.errors import TransientDeviceError as TTransient
from roaringbitmap_tpu.robust.errors import TransientDeviceError as JTransient
from roaringbitmap_tpu_torch.serve import admission as tadm
from roaringbitmap_tpu_torch.serve import slo as tslo

# (package label, serve, slo, admission module, admission cost, faults, transient error)
BOTH = (
    ("port", tserve, tslo, tadm, tadm_cost, tfaults, TTransient),
    ("jax", jserve, jslo, jadm, jadm_cost, jfaults, JTransient),
)


def _reset():
    for _label, _serve, slo, adm, adm_cost, faults, _e in BOTH:
        slo.reset()
        adm.CONTROLLER.reset()
        adm_cost.MODEL.reset()
        faults.clear()
    tout.reset()
    jout.reset()
    tq.DEFAULT_CACHE.clear()
    tinflight.TABLE.clear()
    jinflight.TABLE.clear()
    store.PACK_CACHE.close()
    jstore.PACK_CACHE.close()
    tladder.LADDER.reset()
    jladder.LADDER.reset()


@pytest.fixture(autouse=True)
def serve_state(monkeypatch):
    """The port's device path on CPU tensors; both packages' tenant
    registries, controllers, admission curves, ledgers, fault rules and
    pack caches empty around each test."""
    monkeypatch.setattr(aggregation.config, "device", "cpu")
    _reset()
    yield
    _reset()


def _values(n=6, seed=3):
    rng = np.random.default_rng(seed)
    return [np.sort(rng.choice(1 << 18, 1200, replace=False)).astype(np.uint32) for _ in range(n)]


def _corpora(n=6, seed=3):
    vals = _values(n, seed)
    return [TRB(v) for v in vals], [JRB(v) for v in vals]


def _canon(expr, idx_of):
    """An expression as nested tuples with leaves as corpus indexes."""
    if expr.op == "leaf":
        return ("leaf", idx_of[id(expr.bitmap)])
    return (expr.op, expr.k, tuple(_canon(c, idx_of) for c in expr.children))


def _schedule(reqs, corpus):
    idx_of = {id(b): i for i, b in enumerate(corpus)}
    return [
        (r.idx, r.tenant, r.kind, r.start_s,
         None if r.expr is None else _canon(r.expr, idx_of),
         None if r.mutations is None else {k: v.tolist() for k, v in r.mutations.items()})
        for r in reqs
    ]


def _profiles(serve, mix=None):
    return [
        serve.TenantProfile("s-int", weight=2.0, quota_qps=1e6, latency_class="interactive"),
        serve.TenantProfile("s-bat", weight=1.0, quota_qps=1e6, mix=mix),
        serve.TenantProfile("s-low", weight=1.0, quota_qps=0.1, burst=1.0,
                            latency_class="balanced", p99_budget_ms=40.0),
    ]


def _q1_mix(package_q):
    """A Q1-shaped draw over thirds of the corpus (the chip's batch tenant)."""
    def mix(rng, corpus, shared):
        n = len(corpus) // 3
        a = package_q.or_(*corpus[:n])
        b = package_q.or_(*corpus[n:2 * n])
        c = package_q.or_(*corpus[2 * n:])
        k = int(rng.integers(2, 4))
        return ((a & b) - c) | package_q.threshold(k, *corpus[:4])
    return mix


# ---------------------------------------------------------------------------
# the tenant registry and the SLO series
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("label", ["port", "jax"])
def test_tenant_registry_is_bounded_and_declared(label):
    _l, _serve, slo, *_rest = next(b for b in BOTH if b[0] == label)
    reg = slo.TenantRegistry(max_tenants=2)
    reg.declare("a", quota_qps=10)
    reg.declare("b", quota_qps=10)
    assert reg["a"] == "a" and "b" in reg
    with pytest.raises(KeyError):
        reg["undeclared"]
    with pytest.raises(ValueError, match="registry full"):
        reg.declare("c", quota_qps=10)
    reg.declare("a", quota_qps=99)  # idempotent: updates, no new slot
    assert reg.quota("a") == {"quota_qps": 99.0, "burst": 198.0, "latency_class": "batch",
                              "p99_budget_ms": 1000.0}
    with pytest.raises(ValueError):
        slo.TenantRegistry(max_tenants=0)
    with pytest.raises(ValueError, match="latency class"):
        reg.declare("a", latency_class="platinum")
    with pytest.raises(ValueError):
        reg.declare("a", p99_budget_ms=-1.0)
    with pytest.raises(ValueError):
        reg.declare("", quota_qps=1)


def test_registry_and_series_match_the_jax_package():
    assert tslo.LATENCY_CLASSES == jslo.LATENCY_CLASSES
    assert (tslo.PHASES, tslo.OUTCOMES, tslo.QPS_WINDOW_S, tslo.DEFAULT_MAX_TENANTS) == (
        jslo.PHASES, jslo.OUTCOMES, jslo.QPS_WINDOW_S, jslo.DEFAULT_MAX_TENANTS)
    for slo in (tslo, jslo):
        slo.TENANTS.declare("r-int", latency_class="interactive")
        slo.TENANTS.declare("r-bal", latency_class="balanced", p99_budget_ms=40.0)
        with pytest.raises(KeyError):
            slo.record("r-undeclared", "ok", execute_s=0.01)
        with pytest.raises(ValueError):
            slo.record("r-int", "not-an-outcome")
        for i in range(7):
            slo.record("r-int", "ok", queue_s=0.0002 * i, execute_s=0.003 * (i + 1), now=100.0 + i)
        slo.record("r-bal", "shed", queue_s=0.001, now=107.0)
    for tenant in ("r-int", "r-bal"):
        for phase in tslo.PHASES:
            assert tslo.quantiles(tenant, phase) == jslo.quantiles(tenant, phase)
        assert tslo.TENANTS.qps(tenant, now=108.0) == jslo.TENANTS.qps(tenant, now=108.0)
        assert tslo.TENANTS.p99_budget_ms(tenant) == jslo.TENANTS.p99_budget_ms(tenant)
    t_rows, j_rows = tslo.tenant_rows(), jslo.tenant_rows()
    for rows in (t_rows, j_rows):
        for row in rows.values():
            row.pop("bytes")  # each package's own resident packs
            row.pop("outcomes")  # cumulative over the process: checked below
    assert t_rows == j_rows
    budget = tobs.REGISTRY.get(tobs.SERVE_SLO_BUDGET_SECONDS)
    assert budget.get(("r-int",)) == pytest.approx(tslo.LATENCY_CLASSES["interactive"] / 1e3)
    assert budget.get(("r-bal",)) == pytest.approx(0.04)


def test_off_mode_is_one_bool_check():
    tslo.TENANTS.declare("off-t", quota_qps=10)
    tslo.configure(enabled=False)
    try:
        assert not tslo.enabled()
        tslo.record("never-declared", "ok", execute_s=1.0)
        assert tslo.note_tenant_bytes("never-declared", []) == 0
    finally:
        tslo.configure(enabled=True)
    assert tslo.quantiles("off-t", "execute")["p99"] == 0.0


# ---------------------------------------------------------------------------
# admission verdicts
# ---------------------------------------------------------------------------


def _verdicts(adm, script, **kw):
    c = adm.AdmissionController(clock=lambda: 0.0, **kw)
    out = []
    held = []
    for tenant, now, release in script:
        t = c.admit(tenant, now=now, wait=False)
        out.append((t.verdict, t.admitted))
        if t.admitted:
            if release:
                t.release()
            else:
                held.append(t)
    stats = c.stats()
    for t in held:
        t.release()
    return out, stats


@pytest.mark.parametrize("max_inflight,queue_limit", [(8, 0), (2, 0), (2, 3), (1, 8)])
def test_admission_verdict_sequences_under_a_fake_clock_match_the_jax_package(max_inflight, queue_limit):
    rng = np.random.default_rng(max_inflight * 10 + queue_limit)
    script = []
    now = 0.0
    for _ in range(60):
        now += float(rng.choice([0.0, 0.05, 0.4, 1.5]))
        script.append((str(rng.choice(["v-a", "v-b"])), now, bool(rng.random() < 0.6)))
    got = []
    for _l, _serve, slo, adm, *_rest in BOTH:
        slo.TENANTS.declare("v-a", quota_qps=2.0, burst=3.0)
        slo.TENANTS.declare("v-b", quota_qps=10.0, burst=1.0, latency_class="interactive")
        got.append(_verdicts(adm, script, max_inflight=max_inflight, queue_limit=queue_limit))
    assert got[0] == got[1]
    verdicts = {v for v, _a in got[0][0]}
    assert "admit" in verdicts and len(verdicts) >= 2
    if queue_limit:
        assert "queue" in verdicts


def test_queue_verdict_blocks_until_release_and_joins():
    tslo.TENANTS.declare("q-t", quota_qps=1000, burst=1000)
    c = tadm.AdmissionController(max_inflight=1, queue_limit=4, queue_timeout_s=5.0)
    first = c.admit("q-t")
    assert first.verdict == "admit" and first.admitted
    got = {}
    t = threading.Thread(target=lambda: got.setdefault("ticket", c.admit("q-t")))
    t.start()
    time.sleep(0.05)
    assert "ticket" not in got, "the queued request did not block on the full cap"
    first.release()
    t.join(timeout=5.0)
    tk = got["ticket"]
    assert tk.verdict == "queue" and tk.admitted and tk.queue_s > 0
    tk.release()
    joined = [e for e in tout.tail() if e["site"] == "serve.admit"]
    assert any(e["engine"] == "queue" and e["measured_s"] > 0 for e in joined)
    assert any(e["engine"] == "admit" for e in joined)
    assert c.stats()["inflight"] == 0 and c.stats()["queued"] == 0


@pytest.mark.parametrize("label", ["port", "jax"])
def test_queue_timeout_sheds_typed_and_the_interactive_wait_is_clamped(label):
    _l, serve, slo, adm, *_rest = next(b for b in BOTH if b[0] == label)
    slo.TENANTS.declare("to-t", quota_qps=1000, burst=1000)
    slo.TENANTS.declare("to-int", quota_qps=1e6, burst=1e6, latency_class="interactive",
                        p99_budget_ms=80.0)
    c = adm.AdmissionController(max_inflight=1, queue_limit=4, queue_timeout_s=0.05)
    first = c.admit("to-t")
    second = c.admit("to-t")  # cap full: queue, then time out
    assert second.verdict == "shed" and not second.admitted and second.queue_s > 0
    with pytest.raises(serve.ShedRejection) as ei:
        c.admit_or_raise("to-t")
    assert ei.value.tenant == "to-t" and ei.value.reason == "queue-timeout"
    # an interactive tenant never waits past its budget, even with a 5 s timeout
    c5 = adm.AdmissionController(max_inflight=1, queue_limit=8, queue_timeout_s=5.0)
    holder = c5.admit("to-t")
    t0 = time.perf_counter()
    t = c5.admit("to-int")
    waited = time.perf_counter() - t0
    holder.release()
    first.release()
    assert t.verdict == "shed" and not t.admitted
    assert waited < 1.0


def test_fail_open_under_a_serve_admit_fault_matches_the_jax_package():
    got = []
    for _l, _serve, slo, adm, _cost, faults, transient in BOTH:
        slo.TENANTS.declare("fault-t", quota_qps=0.5, burst=1.0)
        c = adm.AdmissionController(max_inflight=4, queue_limit=0)
        with faults.inject("serve.admit", transient, every=1):
            tickets = [c.admit("fault-t", now=0.0) for _ in range(5)]
        got.append([(t.verdict, t.admitted, t.degraded) for t in tickets])
        for t in tickets:
            t.release()
        assert c.stats()["inflight"] == 0
        # a fatal error is not a degrade: it raises
        with faults.inject("serve.admit", ValueError, every=1):
            with pytest.raises(ValueError):
                c.admit("fault-t", now=0.0)
    assert got[0] == got[1] == [("admit", True, True)] * 5


def test_admission_curve_matches_the_jax_package():
    assert tadm_cost.DEFAULT_COEFFS == jadm_cost.DEFAULT_COEFFS
    t, j = tadm_cost.AdmissionModel(), jadm_cost.AdmissionModel()
    for verdict in ("admit", "queue"):
        for depth in (0, 1, 5, 63):
            assert t.predict_us(verdict, depth) == j.predict_us(verdict, depth)
    rng = np.random.default_rng(4)
    samples = [{"site": "serve.admit", "engine": str(rng.choice(["admit", "queue"])),
                "predicted_us": float(rng.uniform(10, 5000)), "measured_s": float(rng.uniform(1e-6, 1e-2))}
               for _ in range(20)]
    assert t.refit_from_outcomes(samples) == j.refit_from_outcomes(samples)
    assert t.to_dict() == j.to_dict() and t.curves_view() == j.curves_view()


# ---------------------------------------------------------------------------
# the schedule and the harness
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 5, 9])
def test_build_requests_schedules_equal_the_jax_package(seed):
    tc, jc = _corpora(8, seed=seed + 1)
    for target_qps in (None, 250.0):
        t = tserve.build_requests(tc, _profiles(tserve, _q1_mix(tq.Q)), 60, seed=seed,
                                  target_qps=target_qps)
        from roaringbitmap_tpu.query import Q as JQ

        j = jserve.build_requests(jc, _profiles(jserve, _q1_mix(JQ)), 60, seed=seed,
                                  target_qps=target_qps)
        assert _schedule(t, tc) == _schedule(j, jc)
    writers = [tserve.TenantProfile("w", writes=0.5), tserve.TenantProfile("r")]
    jwriters = [jserve.TenantProfile("w", writes=0.5), jserve.TenantProfile("r")]
    t = tserve.build_requests(tc, writers, 30, seed=seed)
    j = jserve.build_requests(jc, jwriters, 30, seed=seed)
    assert _schedule(t, tc) == _schedule(j, jc)
    assert any(r.kind == "write" for r in t)
    # the write path waits for the epoch ledger: the JAX package's error
    with pytest.raises(ValueError, match="writer tenants need an epoch_store"):
        tserve.LoadHarness(tc, writers)
    with pytest.raises(ValueError, match="writer tenants need an epoch_store"):
        jserve.LoadHarness(jc, jwriters)
    with pytest.raises(ValueError):
        tserve.build_requests(tc[:3], writers, 5)
    with pytest.raises(ValueError):
        tserve.build_requests(tc, [], 5)


@pytest.mark.parametrize("use_fusion", [True, False])
@pytest.mark.parametrize("threads", [4, 8])
def test_harness_results_equal_the_jax_serial_oracle(threads, use_fusion):
    tc, jc = _corpora(8, seed=21)
    from roaringbitmap_tpu.query import Q as JQ

    tprof, jprof = _profiles(tserve, _q1_mix(tq.Q)), _profiles(jserve, _q1_mix(JQ))
    treqs = tserve.build_requests(tc, tprof, 48, seed=7)
    jreqs = jserve.build_requests(jc, jprof, 48, seed=7)
    jh = jserve.LoadHarness(jc, jprof, threads=1, use_fusion=False,
                            admission=jadm.AdmissionController(max_inflight=4))
    oracle = [r.serialize() for r in jh.run_serial(jreqs)]
    th = tserve.LoadHarness(tc, tprof, threads=threads, use_fusion=use_fusion,
                            admission=tadm.AdmissionController(max_inflight=2 * threads, queue_limit=0))
    assert [r.serialize() for r in th.run_serial(treqs)] == oracle
    report = th.run(treqs)
    assert report.served + report.shed == len(treqs) and report.served > 0
    assert report.stats["s-low"].shed > 0, "the low-quota tenant shed nothing"
    for got, want, req in zip(report.results, oracle, treqs):
        if isinstance(got, tserve.ShedRejection):
            assert got.tenant == req.tenant
        else:
            assert got.serialize() == want
    assert sum(isinstance(r, tserve.ShedRejection) for r in report.results) == report.shed
    rows = report.tenant_rows()
    jrows = jserve.HarnessReport(jreqs, [None] * len(jreqs), {p.name: jserve.TenantStats() for p in jprof},
                                 1.0, profiles=jprof).tenant_rows()
    assert {k: set(v) for k, v in rows.items()} == {k: set(v) for k, v in jrows.items()}
    assert rows["s-int"]["latency_class"] == "interactive" and rows["s-int"]["p99_budget_ms"] == 25.0
    assert rows["s-low"]["p99_budget_ms"] == 40.0
    classes = report.class_rows()
    assert set(classes) == {"interactive", "batch", "balanced"}
    assert sum(c["served"] for c in classes.values()) == report.served
    if use_fusion:
        hedges = tobs.REGISTRY.get(tobs.FUSION_HEDGE_TOTAL)
        assert hedges.get(("solo",)) > 0
    share = tinsights.serving()["tenants"]["s-int"].get("bytes")
    assert share == store.PACK_CACHE.resident_bytes_for({b.fingerprint() for b in tc})


def test_a_hedge_fault_gives_the_same_bytes_through_the_window():
    tc, jc = _corpora(6, seed=31)
    prof = [tserve.TenantProfile("hf-int", quota_qps=1e6, latency_class="interactive")]
    reqs = tserve.build_requests(tc, prof, 12, seed=2)
    h = tserve.LoadHarness(tc, prof, threads=4, max_wait_ms=5.0,
                           admission=tadm.AdmissionController(max_inflight=8))
    want = [r.serialize() for r in h.run_serial(reqs)]
    degrades = tobs.REGISTRY.get(tobs.DEGRADE_TOTAL)
    before = degrades.get(("query.hedge", "solo", "window"))
    with tfaults.inject("query.hedge", every=1) as inj:
        report = h.run(reqs)
    # every hedged request degrades to the window: the solo rung's fault,
    # then (the breaker open after three) the breaker itself
    assert inj.fired >= 1
    assert [r.serialize() for r in report.results] == want
    assert degrades.get(("query.hedge", "solo", "window")) - before >= inj.fired
    assert tladder.LADDER.states().get("query.hedge/solo") in ("open", "closed")


# ---------------------------------------------------------------------------
# the serving health rules and the panels
# ---------------------------------------------------------------------------


def _snap_pair(health, traffic_fn):
    rules = [r for r in health.DEFAULT_RULES
             if r.name in ("serving-p99-breach", "tenant-saturation", "serving-p99-pressure")]
    s1 = health.snapshot(refresh_hbm=False)
    for r in rules:
        r.probe(s1)
    traffic_fn()
    s2 = health.snapshot(prev_sums=s1.sums, refresh_hbm=False)
    return {r.name: r.probe(s2) for r in rules}


@pytest.mark.parametrize("scenario", ["breach", "pressure-interactive", "pressure-batch", "saturation",
                                      "quiet"])
def test_serving_rules_on_seeded_histograms_match_the_jax_package(scenario):
    got = []
    for _l, _serve, slo, adm, _cost, _f, _e in BOTH:
        health = thealth if slo is tslo else jhealth
        cls = "interactive" if scenario == "pressure-interactive" else "batch"
        tenant = f"rule-{scenario}"
        slo.TENANTS.declare(tenant, quota_qps=0.5 if scenario == "saturation" else 1e9,
                            burst=1.0 if scenario == "saturation" else 1e9, latency_class=cls)
        c = adm.AdmissionController(max_inflight=8, queue_limit=0, clock=lambda: 0.0)
        slo.record(tenant, "ok", execute_s=0.001)  # the series exists before the arm tick
        for _ in range(4):
            c.admit(tenant, now=0.0, wait=False)
        rng = np.random.default_rng(len(scenario))

        def traffic():
            if scenario == "saturation":
                for _ in range(20):
                    t = c.admit(tenant, now=0.0, wait=False)
                    if t.admitted:
                        t.release()
            elif scenario != "quiet":
                for s in rng.uniform(0.15, 1.4, size=12):
                    slo.record(tenant, "ok", queue_s=float(s) / 10, execute_s=float(s))

        got.append(_snap_pair(health, traffic))
    assert got[0] == got[1]
    values = got[0]
    if scenario == "breach":
        rule = next(r for r in thealth.DEFAULT_RULES if r.name == "serving-p99-breach")
        assert values["serving-p99-breach"] >= rule.warn
    if scenario == "pressure-interactive":
        rule = next(r for r in thealth.DEFAULT_RULES if r.name == "serving-p99-pressure")
        assert rule.actuation == "autotune" and values["serving-p99-pressure"] >= rule.critical
    if scenario == "saturation":
        rule = next(r for r in thealth.DEFAULT_RULES if r.name == "tenant-saturation")
        assert values["tenant-saturation"] >= rule.critical
    if scenario == "quiet":
        assert values["serving-p99-breach"] is None


SIDE_TENANTS = ("side-a", "side-b")


def test_sidecar_serving_block_and_insights_serving_match_the_jax_package():
    for _l, _serve, slo, adm, _cost, _f, _e in BOTH:
        slo.TENANTS.declare("side-a", quota_qps=1e6, latency_class="interactive")
        slo.TENANTS.declare("side-b", quota_qps=1.0, burst=1.0)
        c = adm.AdmissionController(max_inflight=4, queue_limit=0, clock=lambda: 0.0)
        for i in range(5):
            for tenant in SIDE_TENANTS:
                t = c.admit(tenant, now=0.0, wait=False)
                if t.admitted:
                    slo.record(tenant, "ok", queue_s=0.0001 * i, execute_s=0.002 * (i + 1), now=50.0 + i)
                    t.release()
                else:
                    slo.record(tenant, "shed", queue_s=0.0, now=50.0 + i)
        adm.CONTROLLER.reset()

    def block(export, obs):
        sv = export.sidecar_snapshot()["serving"]
        # only this test's tenants: other tests of the process declare
        # theirs (the JAX package's tests a "side-t") and count requests
        sv["tenants"] = {k: v for k, v in sv["tenants"].items() if k in SIDE_TENANTS}
        for row in sv["tenants"].values():
            row.pop("bytes", None)
        sv["admit"] = {k: v for k, v in sv["admit"].items() if k in SIDE_TENANTS}
        sv["requests"] = {k: v for k, v in sv["requests"].items() if k in SIDE_TENANTS}
        return sv

    t_block, j_block = block(texport, tobs), block(jexport, jobs)
    assert set(texport.sidecar_snapshot()["serving"]) == set(jexport.sidecar_snapshot()["serving"])
    assert t_block["tenants"]["side-a"]["latency"]["execute"]["p99"] > 0
    assert {k: v for k, v in t_block.items() if k not in ("queue_depth", "inflight")} == {
        k: v for k, v in j_block.items() if k not in ("queue_depth", "inflight")}
    from roaringbitmap_tpu import insights as jinsights

    live_t, live_j = tinsights.serving(), jinsights.serving()
    assert set(live_t) == set(live_j)
    assert live_t["admission_live"] == live_j["admission_live"]
    assert {"side-a", "side-b"} <= set(live_t["tenants"])


def test_tenant_byte_share_over_the_resident_packs():
    tc, _jc = _corpora(6, seed=11)
    other, _ = _corpora(4, seed=12)
    tslo.TENANTS.declare("bs-t", quota_qps=10)
    tq.execute(tq.Q.or_(*tc), cache=None, mode="device")  # a resident pack of the corpus
    share = tslo.note_tenant_bytes("bs-t", tc)
    assert share > 0 and share == store.PACK_CACHE.stats()["bytes"]
    assert store.PACK_CACHE.resident_bytes_for({b.fingerprint() for b in other}) == 0
    assert store.PACK_CACHE.resident_bytes_for(set()) == 0
    assert tobs.REGISTRY.get(tobs.SERVE_TENANT_BYTES).get(("bs-t",)) == share


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
def test_harness_over_packs_on_the_card_equals_the_plain_versions(monkeypatch):
    """The harness with the device tier on the card: every served result
    equals the serial oracle over the CPU tensors' plain versions."""
    tc, _jc = _corpora(8, seed=41)
    prof = _profiles(tserve, _q1_mix(tq.Q))
    reqs = tserve.build_requests(tc, prof, 40, seed=3)
    plain = [r.serialize() for r in tserve.LoadHarness(tc, prof, threads=1).run_serial(reqs)]
    monkeypatch.setattr(aggregation.config, "device", "cuda")
    store.PACK_CACHE.close()
    h = tserve.LoadHarness(tc, prof, threads=8,
                           admission=tadm.AdmissionController(max_inflight=16, queue_limit=0))
    report = h.run(reqs)
    for got, want in zip(report.results, plain):
        if not isinstance(got, tserve.ShedRejection):
            assert got.serialize() == want
    assert report.served > 0
    store.PACK_CACHE.close()
