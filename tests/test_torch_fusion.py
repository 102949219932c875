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
    priced = set(tfusion_cost.DEFAULT_COEFFS)

    def jax_coeffs():  # the JAX package's, less its hedge's slack_penalty
        return {k: v for k, v in j.coeffs.items() if k in priced}

    assert priced == set(jfusion_cost.DEFAULT_COEFFS) - {"slack_penalty"}
    assert tfusion_cost.DEFAULT_COEFFS == jax_coeffs()
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
    assert t.coeffs == jax_coeffs() and t.provenance == j.provenance == "refit-from-traffic"
    # the port has no hedge: its samples refit nothing here
    hedged = t.refit_from_outcomes(
        [{"site": "fusion.hedge", "engine": "solo", "predicted_us": 300.0, "measured_s": 0.002}] * 4
    )
    assert hedged["moved"] == {} and t.coeffs == jax_coeffs()
    state = t.to_dict()
    assert state == dict(j.to_dict(), coeffs=jax_coeffs())
    fresh = tfusion_cost.FusionBatchModel()
    assert fresh.from_dict(state) and fresh.coeffs == jax_coeffs()
    fresh.reset()
    assert fresh.from_dict(j.to_dict()) and fresh.coeffs == jax_coeffs()  # a JAX-saved state
    assert fresh.curves_view() == dict(j.curves_view(), coeffs=jax_coeffs())
    assert not fresh.from_dict({"schema": "other"})
    bad = dict(state, coeffs=dict(state["coeffs"], tier_us=1e9))
    assert not fresh.from_dict(bad) and fresh.coeffs == jax_coeffs()
    fresh.reset()
    assert fresh.coeffs == tfusion_cost.DEFAULT_COEFFS and fresh.provenance == "default"


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
