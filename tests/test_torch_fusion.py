"""The port's fusion window against serial execution and the JAX package.

The windows of the JAX package's own fusion tests are rebuilt in both
packages from the same seeded values and run through ``execute_fused``
with and without a result cache, under the planner's default mode and
under ``mode="device"`` (the merged device tiers on CPU tensors, where
every kernel wrapper takes its plain version): port fused == port serial
== JAX ``execute_fused``, serialized byte for byte. Then each merged tier
alone (pairwise on the columnar device tier, the merged andnot's single
``pair_rows_reduce``, the equal-bucket thresholds' single
``threshold_rows``), the dedup count, fusion off, a failing tier (raised,
every claim aborted, no serial rerun), the in-flight ``poll``, the
``FusionExecutor`` window, the fusion pricing model against the JAX
package's, and the routed facade on a host without a card under the
default config. Both packages run on the numpy host tier, and the tests
that compare bytes with the JAX package run again with both on their
native host tier (``host_tier``): the two tiers build different container
forms for the same values.
"""

import threading
import time

import numpy as np
import pytest
import torch

from roaringbitmap_tpu import Q as JQ
from roaringbitmap_tpu import columnar as jcol
from roaringbitmap_tpu.columnar import costmodel as jcost
from roaringbitmap_tpu.columnar import kernels as jkernels
from roaringbitmap_tpu.cost import fusion as jfusion_cost
from roaringbitmap_tpu.models.roaring import RoaringBitmap as JRB
from roaringbitmap_tpu.parallel import store as jstore
from roaringbitmap_tpu.query import ResultCache as JResultCache
from roaringbitmap_tpu.query import execute_fused as j_execute_fused
from roaringbitmap_tpu.query import fusion as jfusion
from roaringbitmap_tpu.query import inflight as jinflight
from roaringbitmap_tpu.query import plan as jplan

import roaringbitmap_tpu.observe as jobs
from roaringbitmap_tpu.observe import decisions as jdecisions
from roaringbitmap_tpu.observe import export as jexport
from roaringbitmap_tpu.observe import outcomes as joutcomes

from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch import columnar as tcol
from roaringbitmap_tpu_torch import native as tnative
from roaringbitmap_tpu_torch import query as tq
from roaringbitmap_tpu_torch.columnar import costmodel as tcost
from roaringbitmap_tpu_torch.columnar import engine as tengine
from roaringbitmap_tpu_torch.cost import fusion as tfusion_cost
from roaringbitmap_tpu_torch.ops import kernels as K
from roaringbitmap_tpu_torch.parallel import aggregation, store
from roaringbitmap_tpu_torch.query import exec as texec
from roaringbitmap_tpu_torch.query import fusion
from roaringbitmap_tpu_torch.query import inflight
import roaringbitmap_tpu_torch.observe as tobs
from roaringbitmap_tpu_torch import insights as tinsights
from roaringbitmap_tpu_torch.observe import decisions as tdecisions
from roaringbitmap_tpu_torch.observe import export as texport
from roaringbitmap_tpu_torch.observe import outcomes as toutcomes
from roaringbitmap_tpu_torch.robust import faults as tfaults
from roaringbitmap_tpu_torch.robust.errors import TransientDeviceError

MODES = (None, "device")
HOST_TIERS = ("numpy", "native")
_J_NATIVE = jkernels._native  # the JAX package's own host-tier probe


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    """The port's device path on CPU tensors, both packages on their
    numpy host tier, both columnar cost models uncalibrated, and both
    packages' shared caches and in-flight tables emptied around each test
    (the JAX ones are process-wide and a later test of that package reads
    their byte ledgers)."""
    monkeypatch.setattr(aggregation.config, "device", "cpu")
    monkeypatch.setattr(jkernels, "_native", lambda: None)
    tnative.set_tier("numpy")
    monkeypatch.delenv("RB_TPU_COLUMNAR_CAL", raising=False)
    tcost.MODEL.reset()
    jcost.MODEL.reset()
    store.PACK_CACHE.close()
    tq.DEFAULT_CACHE.clear()
    inflight.TABLE.clear()
    yield
    tnative.set_tier("native")
    fusion.configure(enabled=True)
    inflight.TABLE.clear()
    jinflight.TABLE.clear()
    tcost.MODEL.reset()
    jcost.MODEL.reset()
    store.PACK_CACHE.close()
    jstore.PACK_CACHE.close()
    tq.DEFAULT_CACHE.clear()


@pytest.fixture(params=HOST_TIERS)
def host_tier(request, monkeypatch):
    """Both packages on one host tier: numpy (as ``port_on_cpu`` leaves
    them) or native (each package's default)."""
    if request.param == "native":
        monkeypatch.setattr(jkernels, "_native", _J_NATIVE)
        tnative.set_tier("native")
    return request.param


def _bms(rng, k, n=2000, space=1 << 18):
    """``k`` bitmaps built the way the JAX package's fusion tests build
    them, in both packages from the same values."""
    tb, jb = [], []
    for _ in range(k):
        vals = np.sort(rng.choice(space, n, replace=False)).astype(np.uint32)
        t, j = TRB(vals), JRB(vals)
        assert t.serialize() == j.serialize()
        tb.append(t)
        jb.append(j)
    return tb, jb


def _overlapping(Q, L, n=6):
    """Shared hot AND under an OR (it survives the flatten rewrite) plus
    per-query structure: ``tests/test_query_fusion.py:_overlapping_queries``."""
    hot = Q.leaf(L[0]) & Q.leaf(L[1])
    qs = []
    for i in range(n):
        a = Q.leaf(L[2 + i % (len(L) - 2)])
        b = Q.leaf(L[2 + (i + 1) % (len(L) - 2)])
        qs.append((hot | a) - b if i % 2 else hot | (a & b))
    return qs


def _kernels_window(Q, L):
    """``tests/test_query_fusion.py:77``: thresholds, n-way andnots and
    n-ary or / xor in one window."""
    leaves = [Q.leaf(b) for b in L]
    return [
        Q.threshold(2, *leaves[:4]),
        Q.threshold(3, *leaves[1:]),
        Q.andnot(leaves[0], *leaves[2:4]),
        Q.andnot(leaves[1], *leaves[3:]),
        Q.or_(leaves[0], leaves[2], leaves[4]),
        Q.xor(leaves[1], leaves[2], leaves[3]),
    ]


def _device_window(Q, L):
    """``tests/test_query_fusion.py:94``: the merged device tiers."""
    leaves = [Q.leaf(b) for b in L]
    hot = leaves[0] & leaves[1]
    return [
        hot | leaves[2],
        hot | leaves[3],
        Q.andnot(leaves[0], leaves[2], leaves[3]),
        Q.andnot(leaves[1], leaves[3], leaves[4]),
        Q.threshold(2, *leaves[:4]),
        Q.threshold(2, leaves[1], leaves[2], leaves[3], leaves[4]),
    ]


WINDOWS = {
    # test_query_fusion.py:66 and :122 (the same window: fused == serial,
    # and the dedup of the shared AND)
    "overlapping": (7, dict(k=6), _overlapping),
    "dedup": (17, dict(k=6), _overlapping),
    "kernels": (11, dict(k=5, n=4000), _kernels_window),
    "device-tiers": (13, dict(k=5, n=6000, space=1 << 20), _device_window),
}


def _window(name):
    seed, kw, build = WINDOWS[name]
    tb, jb = _bms(np.random.default_rng(seed), **kw)
    return build(tq.Q, tb), build(JQ, jb)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("name", sorted(WINDOWS))
def test_fused_equals_serial_and_the_jax_package(name, cached, mode, host_tier):
    tqs, jqs = _window(name)
    if mode == "device":  # the same plans in both packages
        for tq_, jq_ in zip(tqs, jqs):
            tp, jp = tq.plan(tq_, mode=mode), jplan(jq_, mode=mode)
            assert [s.engine for s in tp.steps] == [s.engine for s in jp.steps]
    serial = [texec.execute(q, cache=None, mode=mode) for q in tqs]
    store.PACK_CACHE.close()
    got = tq.execute_fused(
        tqs, cache=tq.ResultCache(max_entries=64) if cached else None, mode=mode
    )
    want = j_execute_fused(
        jqs, cache=JResultCache(max_entries=64) if cached else None, mode=mode
    )
    for g, s, w, q in zip(got, serial, want, tqs):
        assert g.serialize() == s.serialize() == w.serialize()
        assert g == tq.evaluate_naive(q)


def test_a_shared_subexpression_runs_once(monkeypatch):
    """A hot ``A & B`` shared by three queries: counted as deduped, and
    the step runs once in the window."""
    tb, _ = _bms(np.random.default_rng(17), 6)
    Q = tq.Q
    L = [Q.leaf(b) for b in tb]
    hot = L[0] & L[1]
    qs = [hot | L[2], hot | (L[3] & L[4]), (hot | L[5]) - L[2]]
    ran = []
    real_step, real_merged = texec._run_step, fusion._run_merged

    def step(s, inputs, force_cpu=False):
        ran.append(s.node.uid)
        return real_step(s, inputs, force_cpu=force_cpu)

    def merged(cls, ready, results):
        ran.extend(s.node.uid for s, _k, _e in ready)
        return real_merged(cls, ready, results)

    monkeypatch.setattr(texec, "_run_step", step)
    monkeypatch.setattr(fusion, "_run_merged", merged)
    before = dict(fusion.STEP_COUNTS)
    got = tq.execute_fused(qs, cache=None)
    assert fusion.STEP_COUNTS["deduped"] - before["deduped"] >= 2
    assert fusion.STEP_COUNTS["executed"] - before["executed"] == len(set(ran))
    assert ran.count(hot.uid) == 1
    for g, q in zip(got, qs):
        assert g == tq.evaluate_naive(q)


# ---------------------------------------------------------------------------
# each merged tier by itself
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["and", "or", "xor", "andnot"])
def test_merged_pairwise_on_the_device_tier_equals_solo(op, monkeypatch, host_tier):
    """Pairwise steps sharing an operand, the columnar router's verdict
    pinned to its device tier (rows on CPU tensors): one merged
    ``pairwise_multi`` equal to each pair alone and to the JAX package's
    device tier."""
    rng = np.random.default_rng(23)
    tb, jb = _bms(rng, 5, n=30000, space=1 << 22)
    monkeypatch.setattr(tengine, "route", lambda *a, **kw: "columnar-device")
    calls = []
    real = tcol.pairwise_multi

    def counted(op_, pairs, tier="cpu"):
        calls.append((op_, len(pairs), tier))
        return real(op_, pairs, tier=tier)

    monkeypatch.setattr(tcol, "pairwise_multi", counted)
    Q = tq.Q
    qs = [getattr(Q, {"and": "and_", "or": "or_", "xor": "xor", "andnot": "andnot"}[op])(
        Q.leaf(tb[0]), Q.leaf(b)) for b in tb[1:]]
    for q in qs:  # two-operand steps the planner leaves to the facade's engines
        assert [s.engine for s in tq.plan(q, mode="cpu").steps] == ["pairwise"]
    got = tq.execute_fused(qs, cache=None, mode="cpu")
    assert calls == [(op, 4, "device")]
    want = jcol.pairwise_multi(op, [(jb[0], b) for b in jb[1:]], tier="device")
    for g, b, w in zip(got, tb[1:], want):
        solo = real(op, [(tb[0], b)], tier="device")[0]
        assert g.serialize() == solo.serialize() == w.serialize()


def _counted(monkeypatch, name):
    calls = []
    real = getattr(K, name)

    def wrapper(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(K, name, wrapper)
    return calls


def test_merged_andnot_on_the_device_is_one_pair_rows_launch(monkeypatch, host_tier):
    tqs, jqs = _window("device-tiers")
    andnots = [tqs[2], tqs[3]]
    for q in andnots:
        assert [s.engine for s in tq.plan(q, mode="device").steps] == ["andnot-batch[device]"]
    calls = _counted(monkeypatch, "pair_rows_reduce")
    got = tq.execute_fused(andnots, cache=None, mode="device")
    assert len(calls) == 1 and calls[0][4] == "andnot"
    want = j_execute_fused([jqs[2], jqs[3]], cache=None, mode="device")
    for g, w, q in zip(got, want, andnots):
        assert g.serialize() == w.serialize()
        assert g.serialize() == texec.execute(q, cache=None, mode="device").serialize()


def test_equal_bucket_thresholds_are_one_threshold_launch(monkeypatch, host_tier):
    """Two thresholds with equal (k, n_slices, M): one ``threshold_rows``
    over their blocks concatenated along G; a third with another k takes
    its own launch."""
    rng = np.random.default_rng(29)
    keys = np.arange(6)
    tb, jb = [], []
    for _ in range(6):  # every bitmap holds every key: M = operands
        vals = np.concatenate([(int(k) << 16) + rng.choice(1 << 16, 3000, replace=False) for k in keys])
        vals = np.sort(vals).astype(np.uint32)
        tb.append(TRB(vals))
        jb.append(JRB(vals))

    def window(Q, L):
        leaves = [Q.leaf(b) for b in L]
        return [
            Q.threshold(2, *leaves[:4]),
            Q.threshold(2, *leaves[2:]),
            Q.threshold(3, *leaves[1:5]),
        ]

    tqs, jqs = window(tq.Q, tb), window(JQ, jb)
    calls = _counted(monkeypatch, "threshold_rows")
    got = tq.execute_fused(tqs, cache=None, mode="device")
    assert sorted((int(c[0].shape[0]), c[1]) for c in calls) == [(6, 3), (12, 2)]
    want = j_execute_fused(jqs, cache=None, mode="device")
    for g, w, q in zip(got, want, tqs):
        assert g.serialize() == w.serialize()
        assert g.serialize() == texec.execute(q, cache=None, mode="device").serialize()


def test_fusion_off_is_the_plain_serial_loop(monkeypatch):
    tqs, _ = _window("overlapping")
    fusion.configure(enabled=False)

    def no_window(*a, **kw):
        raise AssertionError("fusion off must not open a window")

    monkeypatch.setattr(fusion, "_execute_window", no_window)
    before = dict(fusion.STEP_COUNTS)
    got = tq.execute_fused(tqs, cache=None)
    assert fusion.STEP_COUNTS == before
    for g, q in zip(got, tqs):
        assert g.serialize() == texec.execute(q, cache=None).serialize()
    with pytest.raises(ValueError):
        fusion.configure(window=1)
    with pytest.raises(ValueError):
        fusion.configure(max_wait_ms=-1)


def test_a_failing_merged_tier_raises_and_aborts_every_claim(monkeypatch):
    """A kernel fault inside a merged tier: ``execute_fused`` raises it
    (no serial rerun), every claim the window held is aborted, and an
    executor that found one of those keys pending polls ``None``."""
    tqs, _ = _window("device-tiers")
    seen = {}

    def broken(cls, ready, results):
        key = ready[0][1]
        t = threading.Thread(target=lambda: seen.setdefault("entry", inflight.TABLE.begin(key)))
        t.start()
        t.join(10)
        assert not t.is_alive()
        raise RuntimeError("kernel fault")

    serial_runs = []
    monkeypatch.setattr(fusion, "_run_merged", broken)
    monkeypatch.setattr(texec, "execute", lambda *a, **kw: serial_runs.append(a))
    with pytest.raises(RuntimeError, match="kernel fault"):
        tq.execute_fused(tqs, cache=tq.ResultCache(max_entries=64), mode="device")
    owner, entry = seen["entry"]
    assert not owner  # the window held the claim when it failed
    assert entry.event.is_set()
    assert inflight.TABLE.poll(entry) is None
    assert inflight.TABLE.pending_count() == 0
    assert serial_runs == []


def test_inflight_poll_never_blocks():
    table = inflight.InflightTable(join_timeout_s=30.0)
    owner, entry = table.begin(("k", 1))
    assert owner
    _, joined = table.begin(("k", 1))
    t0 = time.perf_counter()
    assert table.poll(joined) is None  # still computing: no wait
    assert time.perf_counter() - t0 < 1.0
    table.complete(("k", 1), entry, "value", True)
    assert table.poll(joined) == "value"
    owner, entry = table.begin(("k", 2))
    table.complete(("k", 2), entry, "stale", False)
    assert table.poll(entry) is None  # published, but not valid
    owner, entry = table.begin(("k", 3))
    table.abort(("k", 3), entry)
    assert table.poll(entry) is None
    owner, entry = table.begin(("k", 4))
    table.clear()
    assert entry.event.is_set() and table.pending_count() == 0


# ---------------------------------------------------------------------------
# the serving window
# ---------------------------------------------------------------------------


def test_window_close_at_matches_the_jax_package():
    rng = np.random.default_rng(31)
    for _ in range(200):
        t_open = float(rng.uniform(0, 100))
        wait = float(rng.uniform(0, 0.05))
        deadlines = [
            None if rng.random() < 0.3 else t_open + float(rng.uniform(-0.01, 0.1))
            for _ in range(int(rng.integers(0, 6)))
        ]
        got = fusion.window_close_at(t_open, wait, deadlines)
        assert got == jfusion.window_close_at(t_open, wait, deadlines)
        assert got <= t_open + wait


def test_executor_coalesces_up_to_its_window(monkeypatch):
    tqs, _ = _window("overlapping")
    sizes = []
    real = fusion.execute_fused

    def counted(qs, **kw):
        sizes.append(len(qs))
        return real(qs, **kw)

    monkeypatch.setattr(fusion, "execute_fused", counted)
    with fusion.FusionExecutor(window=4, max_wait_ms=5000, cache=None) as ex:
        futs = [ex.submit(q) for q in tqs[:4]]
        got = [f.result(timeout=60) for f in futs]
        assert ex.batches == 1 and sizes == [4]
        more = ex.map(tqs[4:])
    for g, q in zip(got + more, tqs):
        assert g.serialize() == texec.execute(q, cache=None).serialize()


def test_executor_closes_by_max_wait_or_earlier_by_slack():
    tqs, _ = _window("overlapping")
    with fusion.FusionExecutor(window=8, max_wait_ms=20, cache=None) as ex:
        t0 = time.perf_counter()
        got = ex.submit(tqs[0]).result(timeout=60)
        assert time.perf_counter() - t0 < 30
        assert ex.batches == 1
    with fusion.FusionExecutor(window=8, max_wait_ms=600_000, cache=None) as ex:
        t0 = time.perf_counter()
        fut = ex.submit(tqs[1], slack_ms=10)
        got2 = fut.result(timeout=120)  # the slack closed the window, not the 600 s bound
        assert time.perf_counter() - t0 < 120
    assert got.serialize() == texec.execute(tqs[0], cache=None).serialize()
    assert got2.serialize() == texec.execute(tqs[1], cache=None).serialize()


def test_executor_failure_reaches_every_future_of_its_batch(monkeypatch):
    tqs, _ = _window("overlapping")

    def broken(qs, **kw):
        raise RuntimeError("batch failed")

    monkeypatch.setattr(fusion, "execute_fused", broken)
    with fusion.FusionExecutor(window=3, max_wait_ms=5000, cache=None) as ex:
        futs = [ex.submit(q) for q in tqs[:3]]
        for f in futs:
            with pytest.raises(RuntimeError, match="batch failed"):
                f.result(timeout=60)


def test_executor_close_drains_then_refuses():
    tqs, _ = _window("overlapping")
    ex = fusion.FusionExecutor(window=8, max_wait_ms=600_000, cache=None)
    futs = [ex.submit(q) for q in tqs[:3]]
    ex.close()
    for f, q in zip(futs, tqs):
        assert f.done()
        assert f.result().serialize() == texec.execute(q, cache=None).serialize()
    assert ex.queue_depth() == 0
    with pytest.raises(RuntimeError, match="closed"):
        ex.submit(tqs[0])


# ---------------------------------------------------------------------------
# the pricing model
# ---------------------------------------------------------------------------


def test_fusion_cost_model_matches_the_jax_package():
    t, j = tfusion_cost.FusionBatchModel(), jfusion_cost.FusionBatchModel()
    assert tfusion_cost.DEFAULT_COEFFS == jfusion_cost.DEFAULT_COEFFS
    assert t.coeffs == j.coeffs
    for steps in (0, 1, 2, 3, 5, 8, 13, 40, 200):
        for tiers in (0, 1, 2, 3, 7, 50):
            assert t.estimate(steps, tiers) == j.estimate(steps, tiers)
            assert t.choose(steps, tiers) == j.choose(steps, tiers)
    rng = np.random.default_rng(37)
    samples = [
        {"site": "fusion.batch", "engine": str(rng.choice(["fused", "per-query"])),
         "predicted_us": float(rng.uniform(100, 2000)), "measured_s": float(rng.uniform(1e-4, 5e-3))}
        for _ in range(12)
    ] + [
        {"site": "fusion.batch", "engine": "fused", "predicted_us": "bad", "measured_s": 0.001},
        {"site": "columnar", "engine": "fused", "predicted_us": 1.0, "measured_s": 1.0},
    ]
    got, want = t.refit_from_outcomes(samples), j.refit_from_outcomes(samples)
    assert got == want and got["moved"] and got["rejected"] == 1
    assert t.coeffs == j.coeffs and t.provenance == j.provenance == "refit-from-traffic"
    # hedged solo joins refit the per-query curve; window joins refit nothing
    hedged = [{"site": "fusion.hedge", "engine": "solo", "predicted_us": 300.0, "measured_s": 0.002}] * 4
    windowed = [{"site": "fusion.hedge", "engine": "window", "predicted_us": 100.0, "measured_s": 0.5}] * 4
    for batch in (hedged, windowed):
        assert t.refit_from_outcomes(batch) == j.refit_from_outcomes(batch)
        assert t.coeffs == j.coeffs
    state = t.to_dict()
    assert state == j.to_dict()
    fresh = tfusion_cost.FusionBatchModel()
    assert fresh.from_dict(state) and fresh.coeffs == j.coeffs
    fresh.reset()
    assert fresh.from_dict(j.to_dict()) and fresh.coeffs == j.coeffs  # a JAX-saved state
    assert fresh.curves_view() == j.curves_view()
    assert not fresh.from_dict({"schema": "other"})
    bad = dict(state, coeffs=dict(state["coeffs"], tier_us=1e9))
    assert not fresh.from_dict(bad) and fresh.coeffs == j.coeffs
    fresh.reset()
    assert fresh.coeffs == tfusion_cost.DEFAULT_COEFFS and fresh.provenance == "default"


# ---------------------------------------------------------------------------
# the hedge and the window autotune, against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("refit", [False, True])
def test_hedge_pricing_matches_the_jax_package(refit):
    t, j = tfusion_cost.FusionBatchModel(), jfusion_cost.FusionBatchModel()
    if refit:  # the verdicts under refitted curves too
        samples = [{"site": "fusion.hedge", "engine": "solo", "predicted_us": 240.0,
                    "measured_s": 960.0 / 1e6}] * 4 + [
            {"site": "fusion.batch", "engine": "fused", "predicted_us": 400.0, "measured_s": 1e-4}] * 3
        assert t.refit_from_outcomes(samples) == j.refit_from_outcomes(samples)
    for steps in (0, 1, 2, 5, 13):
        for depth in (0, 1, 3, 9):
            for wait_us in (0.0, 150.0, 2000.0, 5e4):
                assert t.hedge_estimate(steps, depth, wait_us) == j.hedge_estimate(steps, depth, wait_us)
                for slack_us in (1.0, 300.0, 2500.0, 1e5):
                    assert (t.choose_dispatch(steps, depth, wait_us, slack_us)
                            == j.choose_dispatch(steps, depth, wait_us, slack_us))
    for budget_us in (0.0, 200.0, 300.0, 1000.0, 25e3, 1e6):
        for spq in (1.0, 2.0, 3.5):
            assert t.window_for_budget(budget_us, spq) == j.window_for_budget(budget_us, spq)


# ---------------------------------------------------------------------------
# the routed facade on a host without a card, default config
# ---------------------------------------------------------------------------


def _facade_pair(rng, n_keys):
    """Two run-optimized bitmaps of ``n_keys`` chunks each, mostly small
    arrays with runs and bitmaps among them, the same in both packages."""
    out = []
    for side in range(2):
        parts = []
        for key in range(side, n_keys + side):
            base = key << 16
            if key % 64 == 5:
                lows = np.arange(int(rng.integers(0, 500)), 40000)
            elif key % 256 == 9 or n_keys <= 16 and key % 4 == 1:
                lows = rng.choice(1 << 16, 5000, replace=False)
            else:
                lows = rng.choice(1 << 16, int(rng.integers(5, 40)), replace=False)
            parts.append(base + np.unique(lows))
        vals = np.concatenate(parts).astype(np.uint32)
        t, j = TRB(vals), JRB(vals)
        t.run_optimize()
        j.run_optimize()
        assert t.serialize() == j.serialize()
        out.append((t, j))
    return out


@pytest.mark.parametrize("n_keys", [16, 4096])
def test_routed_facade_answers_without_a_card_under_the_default_config(n_keys, monkeypatch, host_tier):
    """With ``aggregation.config.device`` at its default ``"cuda"`` and no
    card, the routed two-operand ops answer on the CPU engines with the JAX
    package's bytes (the device tier is not eligible, so nothing
    calibrates it)."""
    if torch.cuda.is_available():
        pytest.skip("this test is about a host without a card")
    monkeypatch.setattr(aggregation.config, "device", "cuda")
    assert not tcost.MODEL.device_eligible()
    (ta, ja), (tb, jb) = _facade_pair(np.random.default_rng(41 + n_keys), n_keys)
    for name in ("and_", "or_", "xor", "andnot"):
        got = getattr(TRB, name)(ta, tb)
        want = getattr(JRB, name)(ja, jb)
        assert got.serialize() == want.serialize(), name
    assert not tcost.MODEL.calibrated


# ---------------------------------------------------------------------------
# the fusion counters, the decision record and the fault site
# ---------------------------------------------------------------------------



_FUSION_METRICS = ("FUSION_BATCH_TOTAL", "FUSION_QUERIES_TOTAL", "FUSION_STEPS_TOTAL",
                   "QUERY_INFLIGHT_TOTAL")


def _clear_fusion_metrics():
    for obs in (tobs, jobs):
        for name in _FUSION_METRICS:
            obs.REGISTRY.get(getattr(obs, name)).clear()
    tdecisions.LOG.clear()
    jdecisions.LOG.clear()


def _fusion_decisions(dec):
    return [(e["decision"], e.get("inputs")) for e in dec.decisions() if e["site"] == "fusion.batch"]


def _counters(obs):
    snap = obs.REGISTRY.snapshot()
    return {
        name: sorted((tuple(s["labels"].items()), s["value"]) for s in snap[getattr(obs, name)]["samples"])
        for name in _FUSION_METRICS
    }


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("name", sorted(WINDOWS))
def test_fusion_counters_and_decision_records_match_the_jax_package(name, cached):
    tqs, jqs = _window(name)
    # mode="device": the two planners choose the same engines (the default
    # mode's choice depends on each package's device configuration)
    for tq_, jq_ in zip(tqs, jqs):
        tp, jp = tq.plan(tq_, mode="device"), jplan(jq_, mode="device")
        assert [s.engine for s in tp.steps] == [s.engine for s in jp.steps]
    _clear_fusion_metrics()
    t_cache = tq.ResultCache(max_entries=64) if cached else None
    j_cache = JResultCache(max_entries=64) if cached else None
    for _ in range(2):  # cold, then warm through the cache when there is one
        tq.execute_fused(tqs, cache=t_cache, mode="device")
        j_execute_fused(jqs, cache=j_cache, mode="device")
    assert _fusion_decisions(tdecisions) == _fusion_decisions(jdecisions)
    assert _counters(tobs) == _counters(jobs)
    t_block = texport._fusion_block(tobs.REGISTRY.snapshot())
    j_block = jexport._fusion_block(jobs.REGISTRY.snapshot())
    for key in ("batches", "queries", "steps", "occupancy", "dedup_hit_ratio", "inflight"):
        assert t_block[key] == j_block[key], key
    assert dict(fusion.STEP_COUNTS) == t_block["steps"] == tinsights.fusion_counters()["steps"]
    fusion.reset_counts()  # the view's keys again, at 0
    assert dict(fusion.STEP_COUNTS) == {k: 0 for k in fusion.STEP_KINDS}


def test_fused_window_joins_its_decision_and_the_refit_reads_the_ledger():
    tqs, _ = _window("overlapping")
    toutcomes.reset()
    tq.execute_fused(tqs, cache=None)
    joined = [e for e in toutcomes.tail() if e["site"] == "fusion.batch"]
    assert len(joined) == 1 and joined[0]["engine"] in ("fused", "per-query")
    assert joined[0]["predicted_us"] is not None
    live, given = tfusion_cost.FusionBatchModel(), tfusion_cost.FusionBatchModel()
    report = live.refit_from_outcomes(min_samples=1)  # default: the live ledger
    assert report == given.refit_from_outcomes(samples=toutcomes.tail(), min_samples=1)
    assert report["moved"] and live.coeffs == given.coeffs
    toutcomes.reset()


def test_query_fusion_fault_raises_and_counts_no_window():
    tqs, _ = _window("overlapping")
    _clear_fusion_metrics()
    with tfaults.inject("query.fusion", every=1, times=1) as inj:
        with pytest.raises(TransientDeviceError):
            tq.execute_fused(tqs, cache=None)
    assert inj.fired == 1
    assert tobs.REGISTRY.get(tobs.FUSION_BATCH_TOTAL).series() == {}
    assert inflight.TABLE.pending_count() == 0
    got = tq.execute_fused(tqs, cache=None)  # the next window runs fused
    assert [g.serialize() for g in got] == [texec.execute(q, cache=None).serialize() for q in tqs]
    assert tobs.REGISTRY.get(tobs.FUSION_BATCH_TOTAL).get(("fused",)) == 1
    fusion.reset_counts()


def test_executor_publishes_queue_depth_and_queued_latency():
    tqs, _ = _window("overlapping")
    queued = tobs.REGISTRY.get(tobs.FUSION_BATCH_SECONDS)
    before = (queued.get(("queued",)) or {"count": 0})["count"]
    ex = fusion.FusionExecutor(window=3, max_wait_ms=1.0, cache=None)
    try:
        outs = ex.map(tqs)
    finally:
        ex.close()
    assert [o.serialize() for o in outs] == [texec.execute(q, cache=None).serialize() for q in tqs]
    assert queued.get(("queued",))["count"] == before + len(tqs)
    assert tobs.REGISTRY.get(tobs.FUSION_QUEUED_COUNT).get(()) == 0
    assert tobs.REGISTRY.get(tobs.FUSION_WINDOW_COUNT).get(()) == fusion.config.window
    fusion.configure(window=5)
    try:
        assert tobs.REGISTRY.get(tobs.FUSION_WINDOW_COUNT).get(()) == 5
        # the window state of the JAX package: effective, base, floor, hedge
        assert tinsights.fusion_counters()["window_state"] == {
            "effective": 5, "base": 5, "min": fusion.config.window_min,
            "hedge_enabled": fusion.config.hedge,
        }
    finally:
        fusion.configure(window=8)


# ---------------------------------------------------------------------------
# the hedged executor and the window autotune, against the JAX package
# (tests/test_query_fusion.py:593-800)
# ---------------------------------------------------------------------------


def _hedge_query(seed, k=4):
    tb, jb = _bms(np.random.default_rng(seed), k)
    return (tq.Q.leaf(tb[0]) & tq.Q.leaf(tb[1])) | tq.Q.leaf(tb[2]), \
        (JQ.leaf(jb[0]) & JQ.leaf(jb[1])) | JQ.leaf(jb[2])


def _hedge_records(decisions_mod):
    return [
        {k: v for k, v in e.items() if k not in ("seq", "ts", "ts_ns", "trace")}
        for e in decisions_mod.decisions() if e["site"] == "fusion.hedge"
    ]


@pytest.mark.parametrize("latency_class,slack_ms", [
    ("interactive", 1.0), ("interactive", 5000.0), ("batch", 1.0), (None, 30.0),
])
def test_hedge_verdict_and_its_decision_match_the_jax_package(latency_class, slack_ms):
    """The joint priced verdict: with an empty queue the hold and the
    estimates are deterministic, so both packages record the same
    ``fusion.hedge`` decision and take the same path."""
    tqy, jqy = _hedge_query(43)
    got = []
    for label, mod, dec, out in (("port", fusion, tdecisions, toutcomes),
                                 ("jax", jfusion, jdecisions, joutcomes)):
        dec.LOG.clear()
        out.reset()
        ex = mod.FusionExecutor(max_wait_ms=100.0, cache=None)
        try:
            res = ex.submit(tqy if label == "port" else jqy, slack_ms=slack_ms,
                            latency_class=latency_class).result(timeout=60)
        finally:
            ex.close()
        joined = [(e["engine"], e.get("predicted_us")) for e in out.tail() if e["site"] == "fusion.hedge"]
        got.append((res.serialize(), ex.hedges, ex.batches, _hedge_records(dec), joined))
    assert got[0] == got[1]
    _bytes, hedges, batches, records, joined = got[0]
    assert len(records) == 1 and len(joined) == 1
    # a window's 100 ms hold prices above the solo curve at both slacks:
    # every interactive request hedges, no other class acts on it
    solo = latency_class == "interactive"
    assert (hedges, batches) == ((1, 0) if solo else (0, 1))
    assert records[0]["decision"] == ("solo" if solo else "window")
    assert joined[0][0] == records[0]["decision"] and joined[0][1] > 0


def test_a_declared_tenant_prices_its_own_budget():
    from roaringbitmap_tpu_torch.serve import slo as tslo

    tqy, _ = _hedge_query(44)
    tslo.TENANTS.declare("fx-int", latency_class="interactive", p99_budget_ms=1.0)
    try:
        assert fusion.FusionExecutor._slack_for("fx-int", None, None) == (0.001, "interactive")
        assert fusion.FusionExecutor._slack_for("fx-unknown", None, None) == (None, None)
        assert fusion.FusionExecutor._slack_for(None, 50.0, "batch") == (0.05, "batch")
        with fusion.FusionExecutor(max_wait_ms=2000.0, cache=None) as ex:
            got = ex.submit(tqy, tenant="fx-int").result(timeout=60)
            assert ex.hedges == 1 and ex.batches == 0
        assert got.serialize() == texec.execute(tqy, cache=None).serialize()
        # the hedge switch off: the verdict is recorded, the window serves
        fusion.configure(hedge=False)
        with fusion.FusionExecutor(max_wait_ms=20.0, cache=None) as ex:
            ex.submit(tqy, tenant="fx-int").result(timeout=60)
            assert ex.hedges == 0 and ex.batches == 1
    finally:
        fusion.configure(hedge=True)
        tslo.reset()


def test_hedge_fault_degrades_to_the_window_like_the_jax_package():
    tqy, jqy = _hedge_query(53)
    got = []
    for mod, faults, q in ((fusion, tfaults, tqy), (jfusion, None, jqy)):
        if faults is None:
            from roaringbitmap_tpu.robust import faults
        ex = mod.FusionExecutor(max_wait_ms=20.0, cache=None)
        try:
            with faults.inject("query.hedge", every=1) as inj:
                out = ex.submit(q, slack_ms=1.0, latency_class="interactive").result(timeout=60)
            got.append((out.serialize(), ex.hedges, ex.batches >= 1, inj.fired))
        finally:
            ex.close()
    assert got[0] == got[1]  # the same path and the same bytes
    assert got[0][1:] == (1, True, 1)
    assert got[0][0] == texec.execute(tqy, cache=None).serialize()


def test_hedged_solo_joins_a_pending_fused_subexpression(monkeypatch):
    """A hedged solo request whose expression is computing inside a fused
    window joins that in-flight entry instead of recomputing."""
    tb, _jb = _bms(np.random.default_rng(59), 3)
    q = tq.Q.leaf(tb[0]) & tq.Q.leaf(tb[1])
    cache = tq.ResultCache(max_entries=32)
    gate, entered = threading.Event(), threading.Event()
    orig = texec._run_step

    def slow_step(*a, **kw):
        entered.set()
        gate.wait(10.0)
        return orig(*a, **kw)

    joins0 = inflight.TABLE.stats()["joins"]
    out = {}
    monkeypatch.setattr(texec, "_run_step", slow_step)
    t1 = threading.Thread(target=lambda: out.setdefault("fused", fusion.execute_fused([q], cache=cache)[0]))
    t1.start()
    try:
        assert entered.wait(10.0), "the fused window never claimed the step"
        monkeypatch.setattr(texec, "_run_step", orig)  # the joiner needs no gate
        with fusion.FusionExecutor(cache=cache, max_wait_ms=2000.0) as ex:
            fut = ex.submit(q, slack_ms=1.0, latency_class="interactive")
            time.sleep(0.05)
            gate.set()
            out["hedged"] = fut.result(timeout=60)
            assert ex.hedges == 1
    finally:
        gate.set()
        t1.join(10.0)
    assert out["fused"].serialize() == out["hedged"].serialize() == texec.execute(q, cache=None).serialize()
    assert inflight.TABLE.stats()["joins"] > joins0


def test_autotune_window_shrinks_and_regrows_like_the_jax_package():
    from roaringbitmap_tpu.serve import slo as jslo
    from roaringbitmap_tpu_torch.serve import slo as tslo

    records = []
    for mod, slo, dec in ((fusion, tslo, tdecisions), (jfusion, jslo, jdecisions)):
        base = mod.config.window_base
        slo.reset()
        dec.LOG.clear()
        try:
            mod.configure(window=8, window_min=2)
            seq = []
            slo.TENANTS.declare("int-t", latency_class="interactive", p99_budget_ms=0.2)
            seq.append(mod.autotune_window(reason="test"))
            slo.TENANTS.declare("int-t", latency_class="interactive", p99_budget_ms=10_000.0)
            seq.append(mod.autotune_window(reason="test"))
            slo.TENANTS.declare("int-t", latency_class="interactive", p99_budget_ms=0.8)
            seq.append(mod.autotune_window(reason="test"))
            slo.reset()
            seq.append(mod.autotune_window(reason="test"))
            seq.append(mod.autotune_window(budget_ms=2.0, reason="explicit"))
            ex_live, ex_pinned = mod.FusionExecutor(), mod.FusionExecutor(window=6)
            try:
                seq.append((ex_live._target_window(), ex_pinned._target_window()))
            finally:
                ex_live.close()
                ex_pinned.close()
            seq.append(_hedge_records(dec) + [
                {k: v for k, v in e.items() if k not in ("seq", "ts", "ts_ns", "trace")}
                for e in dec.decisions() if e["site"] == "fusion.autotune"])
            records.append(seq)
        finally:
            slo.reset()
            mod.configure(window=base)
    assert records[0] == records[1]
    verdicts = [r["verdict"] for r in records[0][:5]]
    assert verdicts[:2] == ["shrink", "regrow"] and records[0][3]["budget_ms"] is None
    assert records[0][0]["window_to"] == 2 and records[0][1]["window_to"] == 8
    assert tobs.REGISTRY.get(tobs.FUSION_WINDOW_COUNT).get(()) == fusion.config.window


def test_sentinel_autotune_actuation_rides_the_pressure_rule():
    """The closed loop on a fake clock: a serving-p99-pressure breach
    actuates one window autotune per cooldown, as in the JAX package."""
    from roaringbitmap_tpu_torch.observe import health as thealth
    from roaringbitmap_tpu_torch.observe import sentinel as tsentinel
    from roaringbitmap_tpu_torch.serve import slo as tslo

    base = fusion.config.window_base
    tslo.reset()
    try:
        fusion.configure(window=8, window_min=2)
        tslo.TENANTS.declare("int-t", latency_class="interactive", p99_budget_ms=0.2)
        rule = next(r for r in thealth.DEFAULT_RULES if r.name == "serving-p99-pressure")
        dial = {"v": 3.0}
        probe = thealth.Rule(rule.name, rule.help, lambda s: dial["v"], warn=rule.warn,
                             critical=rule.critical, fire_after=1, clear_after=1,
                             actuation=rule.actuation)
        s = tsentinel.Sentinel(rules=(probe,), clock=lambda: 0.0, autotune_cooldown_s=30.0)
        s._actuate_bundle = lambda now, tick, rules, evals: {"tick": tick, "kind": "bundle"}
        stub = thealth.Snapshot(metrics={}, breaker_open_ages={}, drift={}, outcome_sites={}, now=0.0)
        r1 = s.tick(now=0.0, snap=stub)
        tuned = next(a for a in r1["actuated"] if a["kind"] == "autotune")
        assert "error" not in tuned and tuned["verdict"] == "shrink" and fusion.config.window == 2
        assert "autotune" not in [a["kind"] for a in s.tick(now=1.0, snap=stub)["actuated"]]
        tslo.TENANTS.declare("int-t", latency_class="interactive", p99_budget_ms=10_000.0)
        r3 = s.tick(now=31.0, snap=stub)
        regrown = next(a for a in r3["actuated"] if a["kind"] == "autotune")
        assert regrown["verdict"] == "regrow" and fusion.config.window == 8
    finally:
        tslo.reset()
        fusion.configure(window=base)
