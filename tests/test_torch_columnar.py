"""The port's columnar pairwise engine against the JAX package's.

The same seeded bitmaps are built in both packages. The key plan, the
9-class partition, ``pairwise`` on the CPU tier and on the device tier
(the port's on CPU tensors, ``aggregation.config.device = "cpu"``; the JAX
package's on its CPU backend), ``pairwise_multi``, the folds and the
count-only pairs must give identical serialized bytes tier against tier.
Both packages run on the same host tier: the numpy tier by default
(the JAX package's forced, the port's chosen through ``native.set_tier``),
and both native in the parity tests' ``host_tier="native"`` cases (the
native ``rb_batch_*`` tier builds run containers where the numpy tier
builds arrays; values are the same either way, bytes are not). Across
device tiers the container forms differ (the device tier builds arrays or bitmaps by cardinality),
so there results are compared with ``==``. The routed facade is held
against the per-container walk under ``columnar.disabled()``; the cost
model's tests assert nothing that depends on a clock. ``rb_pair_rows``
itself is held against its plain version by the ``cuda``-marked tests,
which skip without a card.
"""

import json
import os

import numpy as np
import pytest
import torch

from roaringbitmap_tpu import columnar as jcol
from roaringbitmap_tpu.columnar import costmodel as jcost
from roaringbitmap_tpu.columnar import kernels as jkernels
from roaringbitmap_tpu.models.roaring import RoaringBitmap as JRB
from roaringbitmap_tpu.ops import device as jdev
from roaringbitmap_tpu.ops import pallas_kernels as pk
from roaringbitmap_tpu.utils import bits as jbits
from roaringbitmap_tpu.parallel import store as jstore
from roaringbitmap_tpu.parallel.aggregation import FastAggregation as JFA
from roaringbitmap_tpu.query import kernels as jqk

import roaringbitmap_tpu.observe as jobs
from roaringbitmap_tpu.columnar import engine as jengine
from roaringbitmap_tpu.observe import decisions as jdecisions
from roaringbitmap_tpu.observe import outcomes as joutcomes

from roaringbitmap_tpu_torch import FastAggregation as TFA
from roaringbitmap_tpu_torch import ParallelAggregation as TPA
from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch import columnar as tcol
from roaringbitmap_tpu_torch import native as tnative
from roaringbitmap_tpu_torch.columnar import costmodel as tcost
from roaringbitmap_tpu_torch.columnar import device as tdevice
from roaringbitmap_tpu_torch.columnar import engine as tengine
from roaringbitmap_tpu_torch.columnar import kernels as tkernels
from roaringbitmap_tpu_torch.models.container import RunContainer
from roaringbitmap_tpu_torch.ops import kernels as K
from roaringbitmap_tpu_torch.parallel import aggregation
from roaringbitmap_tpu_torch.parallel import store as tstore
from roaringbitmap_tpu_torch.query import kernels as tqk
from roaringbitmap_tpu_torch.robust.errors import TierUnavailable
from roaringbitmap_tpu_torch.utils import datasets as tdatasets
import roaringbitmap_tpu_torch.observe as tobs
from roaringbitmap_tpu_torch import insights as tinsights
from roaringbitmap_tpu_torch.observe import decisions as tdecisions
from roaringbitmap_tpu_torch.observe import outcomes as toutcomes
from roaringbitmap_tpu_torch.robust import errors as terrors
from roaringbitmap_tpu_torch.robust import faults as tfaults

OPS = ("and", "or", "xor", "andnot")
TIERS = ("cpu", "device")
FACADE = {
    "and": "and_",
    "or": "or_",
    "xor": "xor",
    "andnot": "andnot",
}
HOST_TIERS = ("numpy", "native")
_J_NATIVE = jkernels._native  # the JAX package's own host-tier probe


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    """The device tier on CPU tensors, both packages on their numpy host
    tier, both cost models uncalibrated, and no resident rows left behind."""
    monkeypatch.setattr(aggregation.config, "device", "cpu")
    monkeypatch.setattr(jkernels, "_native", lambda: None)
    tnative.set_tier("numpy")
    monkeypatch.delenv("RB_TPU_COLUMNAR_CAL", raising=False)
    tcost.MODEL.reset()
    jcost.MODEL.reset()
    tstore.PACK_CACHE.close()
    yield
    tnative.set_tier("native")
    tcost.MODEL.reset()
    jcost.MODEL.reset()
    tstore.PACK_CACHE.close()
    jstore.PACK_CACHE.close()


@pytest.fixture(params=HOST_TIERS)
def host_tier(request, monkeypatch):
    """Both packages on one host tier: numpy (as ``port_on_cpu`` leaves
    them) or native (each package's default)."""
    if request.param == "native":
        monkeypatch.setattr(jkernels, "_native", _J_NATIVE)
        tnative.set_tier("native")
    return request.param


# ---------------------------------------------------------------------------
# seeded bitmaps, the same in both packages
# ---------------------------------------------------------------------------


def _chunk_values(kind: str, key: int, rng) -> np.ndarray:
    """One chunk's values, shaped to become the given container kind (runs
    after run_optimize)."""
    base = key << 16
    if kind == "array":
        vals = np.sort(rng.choice(1 << 16, int(rng.integers(1, 900)), replace=False))
    elif kind == "bitmap":
        vals = np.sort(rng.choice(1 << 16, int(rng.integers(4200, 20000)), replace=False))
    else:  # run
        step = int(rng.integers(1 << 10, 1 << 12))
        starts = np.arange(int(rng.integers(0, 900)), 1 << 16, step)
        width = int(rng.integers(20, 900))
        vals = np.unique(np.concatenate([np.arange(s, min(s + width, 1 << 16)) for s in starts]))
    return (vals + base).astype(np.uint32)


def _both(values):
    """The same run-optimized bitmap in both packages."""
    j, t = JRB(values), TRB(values)
    j.run_optimize()
    t.run_optimize()
    return j, t


def _typed(kinds, rng, keys=None):
    keys = range(len(kinds)) if keys is None else keys
    return _both(np.concatenate([_chunk_values(k, int(key), rng) for key, k in zip(keys, kinds)]))


def _nine_class_pair(rng):
    """Operands whose 9 matched pairs cover every (array|bitmap|run)² class."""
    kinds = ["array", "bitmap", "run"]
    a = _typed([k for k in kinds for _ in kinds], rng)
    b = _typed([k for _ in kinds for k in kinds], rng)
    return a, b


def _random_pair(rng, n_keys=40, universe=56):
    """Two bitmaps of mixed kinds over overlapping random key sets."""
    kinds = ["array", "bitmap", "run"]
    out = []
    for _ in range(2):
        keys = np.sort(rng.choice(universe, size=n_keys, replace=False))
        out.append(_typed([kinds[int(rng.integers(0, 3))] for _ in keys], rng, keys))
    return out


def _same(j, t):
    return t.serialize() == j.serialize()


# ---------------------------------------------------------------------------
# stages 1 and 2: key plan and partition
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", OPS)
def test_key_plan_matches_jax(op):
    rng = np.random.default_rng(3)
    cases = [([], []), ([1, 2, 3], []), ([], [4, 5]), ([7], [7]), ([1, 3, 5], [2, 4, 6])]
    for _ in range(6):
        cases.append(tuple(
            np.sort(rng.choice(200, size=int(rng.integers(1, 80)), replace=False)).tolist()
            for _ in range(2)))
    for ak, bk in cases:
        got, want = tcol.key_plan(ak, bk, op), jcol.key_plan(ak, bk, op)
        for name in ("ia", "ib", "a_only", "b_only", "matched_keys"):
            assert np.array_equal(getattr(got, name), getattr(want, name)), (name, ak, bk)


def test_classify_and_histogram_match_jax():
    rng = np.random.default_rng(5)
    (ja, ta), (jb, tb) = _nine_class_pair(rng)
    for jx, tx in ((ja, ta), (jb, tb)):
        assert np.array_equal(
            tcol.classify(tx.high_low_container.containers),
            jcol.classify(jx.high_low_container.containers))
    codes = [tcol.classify(x.high_low_container.containers) for x in (ta, tb)]
    hist = tcol.class_histogram(*codes)
    assert hist.tolist() == [1] * 9
    assert np.array_equal(hist, jcol.class_histogram(*[
        jcol.classify(x.high_low_container.containers) for x in (ja, jb)]))
    assert tcol.CLASS_NAMES == jcol.CLASS_NAMES
    assert tcol.class_histogram(np.empty(0, np.int64), np.empty(0, np.int64)).tolist() == [0] * 9


# ---------------------------------------------------------------------------
# stage 3: pairwise on both tiers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("op", OPS)
def test_nine_classes_match_jax(op, tier, host_tier):
    """Every matched class through ``pairwise``: the same bytes as the JAX
    package's tier, the same values as the per-container walk."""
    rng = np.random.default_rng(105)
    (ja, ta), (jb, tb) = _nine_class_pair(rng)
    before = dict(tengine.BATCH_COUNTS)
    got = tcol.pairwise(op, ta, tb, tier=tier)
    assert _same(jcol.pairwise(op, ja, jb, tier=tier), got)
    with tcol.disabled():
        assert got == getattr(TRB, FACADE[op])(ta, tb)
    moved = {k for k, v in tengine.BATCH_COUNTS.items() if v != before.get(k, 0)}
    assert {f"{op}/{c}" for c in tcol.CLASS_NAMES} <= moved
    if tier == "device":
        assert f"{op}/device_pair" in moved
        assert (f"{op}/device_gather" in moved) == (op in ("and", "andnot"))


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_random_pairs_match_jax(seed, host_tier):
    rng = np.random.default_rng(seed)
    (ja, ta), (jb, tb) = _random_pair(rng)
    for op in OPS:
        cpu = tcol.pairwise(op, ta, tb, tier="cpu")
        dev = tcol.pairwise(op, ta, tb, tier="device")
        assert _same(jcol.pairwise(op, ja, jb, tier="cpu"), cpu), op
        assert _same(jcol.pairwise(op, ja, jb, tier="device"), dev), op
        assert cpu == dev
        with tcol.disabled():
            assert cpu == getattr(TRB, FACADE[op])(ta, tb)


def test_empty_and_disjoint_operands(host_tier):
    rng = np.random.default_rng(17)
    (ja, ta), _ = _random_pair(rng)
    empty_j, empty_t = JRB(), TRB()
    far_j, far_t = _typed(["run", "array"], rng, [900, 901])
    for op in OPS:
        for tier in TIERS:
            for (jx, tx), (jy, ty) in (((ja, ta), (empty_j, empty_t)), ((empty_j, empty_t), (ja, ta)),
                                       ((ja, ta), (far_j, far_t))):
                assert _same(jcol.pairwise(op, jx, jy, tier=tier), tcol.pairwise(op, tx, ty, tier=tier))


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("op", OPS)
def test_pairwise_multi_matches_jax(op, tier, host_tier):
    """Several pairs in one batch pass, one operand shared by two pairs
    (its resident block concatenated once): the JAX package's bytes, and
    the per-pair results."""
    rng = np.random.default_rng(23)
    ops_ = [_random_pair(rng, n_keys=int(rng.integers(5, 30))) for _ in range(4)]
    pairs = [(a, b) for a, b in ops_] + [(ops_[0][0], ops_[2][1])]
    jpairs = [(a[0], b[0]) for a, b in pairs]
    tpairs = [(a[1], b[1]) for a, b in pairs]
    before = K.LAUNCHES["rb_pair_rows"]
    got = tcol.pairwise_multi(op, tpairs, tier=tier)
    want = jcol.pairwise_multi(op, jpairs, tier=tier)
    assert len(got) == len(pairs)
    for g, w, (x, y) in zip(got, want, tpairs):
        assert _same(w, g)
        assert g == tcol.pairwise(op, x, y, tier=tier)
    assert K.LAUNCHES["rb_pair_rows"] == before  # CPU tensors: the plain version
    assert tcol.pairwise_multi(op, [], tier=tier) == []


@pytest.mark.parametrize("seed", [31, 32])
def test_and_cardinality_and_intersects_pairs_match_jax(seed, host_tier):
    rng = np.random.default_rng(seed)
    (ja, ta), (jb, tb) = _random_pair(rng)
    (jn, tn), _ = _nine_class_pair(rng)
    far_j, far_t = _typed(["run", "bitmap"], rng, [900, 901])
    for (jx, tx), (jy, ty) in (((ja, ta), (jb, tb)), ((jn, tn), (jb, tb)), ((ja, ta), (far_j, far_t))):
        card = tcol.engine.and_cardinality_pair(tx, ty)
        assert card == jcol.and_cardinality_pair(jx, jy)
        assert card == TRB._and_cardinality_percontainer(tx, ty)
        assert tcol.intersects_pair(tx, ty) == jcol.intersects_pair(jx, jy) == (card > 0)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("op", OPS)
def test_census_pairs_match_jax(op, tier, host_tier):
    """Adjacent run-optimized pairs of the census-shaped corpus (the
    realdata pairwise benchmark's data: short runs and small arrays, so
    or/xor results are mostly array-sized): the JAX package's bytes tier
    against tier, the per-container walk's values."""
    base, _ = tdatasets.load_or_synthesize("census1881")
    built = [_both(np.asarray(v, dtype=np.uint32)) for v in base[:9]]
    for (ja, ta), (jb, tb) in zip(built[:-1], built[1:]):
        got = tcol.pairwise(op, ta, tb, tier=tier)
        assert _same(jcol.pairwise(op, ja, jb, tier=tier), got)
        with tcol.disabled():
            assert got == getattr(TRB, FACADE[op])(ta, tb)


# ---------------------------------------------------------------------------
# the N-way folds
# ---------------------------------------------------------------------------


def _fold_sets(rng, n_sets=2):
    sets = []
    for _ in range(n_sets):
        # keys 0 and 1 in every bitmap, so the AND's key intersection is not empty
        bms = [_typed(["run", "array", "bitmap", "array"], rng,
                      [0, 1, *np.sort(rng.choice(np.arange(2, 8), 2, replace=False))])
               for _ in range(6)]
        solo = _typed(["run"], rng, [40])  # a single-container group: passes through
        sets.append(bms + [solo])
    return sets


@pytest.mark.parametrize("op", ("or", "xor", "and"))
def test_fold_matches_jax(op, host_tier):
    rng = np.random.default_rng(41)
    (bms,) = _fold_sets(rng, 1)
    jb, tb = [j for j, _ in bms], [t for _, t in bms]
    if op == "and":  # the AND folds the key intersection (workShyAnd)
        bms = bms[:-1]
        jb, tb = jb[:-1], tb[:-1]
        keys = tstore.intersect_keys(tb)
        assert keys == jstore.intersect_keys(jb) and keys
    else:
        keys = None
    jg = jstore.group_by_key(jb, keys_filter=keys)
    tg = tstore.group_by_key(tb, keys_filter=keys)
    got = tcol.fold(tg, op)
    assert _same(jcol.fold(jg, op), got)
    assert got == getattr(TFA, f"naive_{op}")(*tb)
    if op != "and":  # the lone run container passes through as a run
        assert isinstance(got.high_low_container.get_container(40), RunContainer)


@pytest.mark.parametrize("op", ("or", "xor"))
def test_fold_multi_matches_jax(op, host_tier):
    rng = np.random.default_rng(43)
    sets = _fold_sets(rng, 3)
    jgs = [jstore.group_by_key([j for j, _ in s]) for s in sets]
    tgs = [tstore.group_by_key([t for _, t in s]) for s in sets]
    got = tcol.fold_multi(tgs, op)
    for g, w, tg in zip(got, jcol.fold_multi(jgs, op), tgs):
        assert _same(w, g)
        assert g == tcol.fold(tg, op)
    with pytest.raises(ValueError):
        tcol.fold_multi(tgs, "and")


def test_or_fold_words_matches_jax(host_tier):
    rng = np.random.default_rng(47)
    (bms,) = _fold_sets(rng, 1)
    got = tcol.or_fold_words(tstore.group_by_key([t for _, t in bms]))
    want = jcol.or_fold_words(jstore.group_by_key([j for j, _ in bms]))
    assert sorted(got) == sorted(want)
    for k in got:
        assert np.array_equal(got[k], want[k])
    assert tcol.or_fold_words({}) == {}


@pytest.mark.parametrize("engine", ("fast", "parallel"))
@pytest.mark.parametrize("op", ("or", "xor"))
def test_cpu_aggregation_routes_the_columnar_fold(op, engine, host_tier):
    """The CPU path of an or/xor aggregation of at least the fold gate's
    rows runs ``columnar.fold`` (its counter moves) and gives the JAX
    package's bytes."""
    rng = np.random.default_rng(53)
    bms = [_typed(["array", "run"] * 12, rng) for _ in range(6)]  # 144 rows
    assert sum(t.get_container_count() for _, t in bms) >= tcol.MODEL.fold_gate_rows()
    key = f"fold_{op}/rows"
    before = tengine.BATCH_COUNTS.get(key, 0)
    eng = TFA if engine == "fast" else TPA
    got = getattr(eng, FACADE[op])(*[t for _, t in bms], mode="cpu")
    assert tengine.BATCH_COUNTS.get(key, 0) > before
    assert _same(getattr(JFA, FACADE[op])(*[j for j, _ in bms], mode="cpu"), got)
    card = getattr(TFA, f"{op}_cardinality")(*[t for _, t in bms], mode="cpu")
    assert card == got.get_cardinality()


def test_query_cpu_folds_take_the_columnar_union(host_tier):
    rng = np.random.default_rng(59)
    first = _typed(["array"] * 30, rng)
    rest = [_typed(["array", "run"] * 15, rng) for _ in range(4)]
    before = tengine.BATCH_COUNTS.get("fold_or/rows", 0)
    got = tqk.andnot_nway(first[1], *[t for _, t in rest], mode="cpu")
    assert tengine.BATCH_COUNTS.get("fold_or/rows", 0) > before
    assert _same(jqk.andnot_nway(first[0], *[j for j, _ in rest], mode="cpu"), got)
    assert tqk.andnot_nway_cardinality(first[1], *[t for _, t in rest], mode="cpu") == got.get_cardinality()


# ---------------------------------------------------------------------------
# the device ops: rb_pair_rows' plain version, the word test, the concat
# ---------------------------------------------------------------------------


def _rows(rng, n):
    return rng.integers(0, 1 << 32, size=(n, 2048), dtype=np.uint64).astype(np.uint32)


def _t(u32):
    return torch.from_numpy(np.ascontiguousarray(u32).view(np.int32))


@pytest.mark.parametrize("op", OPS)
def test_pair_rows_reduce_plain_matches_jax(op):
    """The plain version against the JAX function on random rows: index
    streams with repeats, the last row of each block, and (like the JAX
    function's take(mode="fill")) an index past the block reading a zero
    row."""
    rng = np.random.default_rng(61)
    ra, rb = _rows(rng, 37), _rows(rng, 23)
    ia = np.concatenate([rng.integers(0, 37, 50), [36, 36, 37]]).astype(np.int32)
    ib = np.concatenate([rng.integers(0, 23, 50), [22, 23, 0]]).astype(np.int32)
    words, cards = pk._pair_rows_jit(ra, ia, rb, ib, op=op)
    got_w, got_c = K.pair_rows_reduce_plain(_t(ra), torch.from_numpy(ia), _t(rb), torch.from_numpy(ib), op)
    assert np.array_equal(got_w.numpy().view(np.uint32), np.asarray(words))
    assert np.array_equal(got_c.numpy(), np.asarray(cards))
    before = K.LAUNCHES["rb_pair_rows"]
    w2, c2 = K.pair_rows_reduce(_t(ra), torch.from_numpy(ia), _t(rb), torch.from_numpy(ib), op)
    assert torch.equal(w2, got_w) and torch.equal(c2, got_c)
    assert K.LAUNCHES["rb_pair_rows"] == before  # CPU tensors: no launch


@pytest.mark.parametrize("op", ("or", "xor"))
def test_fill_intervals_rows_matches_jax(op):
    """The vectorized interval fill against the JAX package's numpy tier
    (a loop of range fills): repeated rows, overlapping intervals (a fold
    accumulator's), empty and one-word intervals, ends past 2^16."""
    rng = np.random.default_rng(131)
    row_ids = np.array([0, 2, 2, 5, 1, 5], dtype=np.int64)
    nruns = rng.integers(0, 40, row_ids.size)
    nruns[3] = 0
    run_offs = np.concatenate(([0], np.cumsum(nruns)))
    starts = rng.integers(0, 1 << 16, int(run_offs[-1]))
    ends = starts + rng.choice([0, 1, 5, 63, 64, 700, 5000], starts.size)
    got, want = np.zeros((6, 1024), np.uint64), np.zeros((6, 1024), np.uint64)
    tkernels.fill_intervals_rows(row_ids, run_offs, starts, ends, got, op)
    jkernels.fill_intervals_rows(row_ids, run_offs, starts, ends, want, op)
    assert np.array_equal(got, want)


def test_values_rows_matches_values_from_words():
    """The batched value extraction against the per-row unpack: empty,
    sparse, array-sized, dense and full rows."""
    rng = np.random.default_rng(137)
    mat = np.zeros((7, 1024), np.uint64)
    for i, n in enumerate((0, 1, 37, 4096, 4097, 30000, 1 << 16)):
        vals = rng.choice(1 << 16, n, replace=False).astype(np.uint16)
        mat[i] = jbits.words_from_values(vals)
    vals, offs = tkernels.values_rows(mat)
    assert offs.tolist() == np.concatenate(([0], np.cumsum([0, 1, 37, 4096, 4097, 30000, 1 << 16]))).tolist()
    for i in range(7):
        assert np.array_equal(vals[offs[i] : offs[i + 1]], jbits.values_from_words(mat[i]))


def test_pair_rows_reduce_checks_its_inputs():
    rows = torch.zeros((4, 2048), dtype=torch.int32)
    idx = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        K.pair_rows_reduce(rows, idx, rows, idx, "nand")
    with pytest.raises(ValueError):
        K.pair_rows_reduce(rows, idx.long(), rows, idx, "and")
    with pytest.raises(ValueError):
        K.pair_rows_reduce(rows, idx, rows, idx[:2], "and")
    with pytest.raises(ValueError):
        K.pair_rows_reduce(rows[:, :1024], idx, rows, idx, "and")
    w, c = K.pair_rows_reduce(rows[:0], idx[:0], rows, idx[:0], "or")
    assert w.shape == (0, 2048) and c.shape == (0,)
    with pytest.raises(IndexError):
        tdevice.index_stream(np.array([0, 4]), 4, torch.device("cpu"))


def test_word_test_rows_and_concat_rows_match_jax():
    rng = np.random.default_rng(67)
    rows = _rows(rng, 19)
    row_ids = rng.integers(0, 19, 500)
    vals = rng.integers(0, 1 << 16, 500).astype(np.uint16)
    want = jdev.word_test_rows_host(rows, row_ids, vals)
    got = K.word_test_rows(_t(rows), torch.from_numpy(row_ids), torch.from_numpy(vals.astype(np.int32)))
    assert np.array_equal(got.numpy(), want)
    blocks = [_rows(rng, n) for n in (3, 1, 5)]
    cat = K.concat_rows([_t(b) for b in blocks])
    assert np.array_equal(cat.numpy().view(np.uint32), np.concatenate(blocks))
    one = _t(blocks[0])
    assert K.concat_rows([one]) is one
    with pytest.raises(ValueError):
        K.concat_rows([])


# ---------------------------------------------------------------------------
# the routed facade
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", OPS)
def test_routed_facade_matches_percontainer(op, host_tier):
    """Above the cutoff the facade takes the columnar CPU tier (the
    uncalibrated gate); the result equals the per-container walk and the
    JAX package's routed facade."""
    rng = np.random.default_rng(71)
    (ja, ta), (jb, tb) = _random_pair(rng)
    before = tengine.ROUTE_COUNTS["columnar-cpu"]
    got = getattr(TRB, FACADE[op])(ta, tb)
    assert tengine.ROUTE_COUNTS["columnar-cpu"] == before + 1
    with tcol.disabled():
        assert got == getattr(TRB, FACADE[op])(ta, tb)
        assert tcol.route(ta.high_low_container, tb.high_low_container, op=op) == "per-container"
    assert np.array_equal(got.to_array(), getattr(JRB, FACADE[op])(ja, jb).to_array())
    assert _same(jcol.pairwise(op, ja, jb, tier="cpu"), got)


def test_routed_cardinality_facades():
    rng = np.random.default_rng(73)
    (ja, ta), (jb, tb) = _random_pair(rng)
    far_j, far_t = _typed(["run"] * 20, rng, range(900, 920))
    assert tcol.enabled_for(ta.high_low_container, tb.high_low_container)
    with tcol.disabled():
        want = TRB.and_cardinality(ta, tb)
        assert not tcol.enabled_for(ta.high_low_container, tb.high_low_container)
    assert TRB.and_cardinality(ta, tb) == want == JRB.and_cardinality(ja, jb)
    assert TRB.or_cardinality(ta, tb) == TRB.or_(ta, tb).get_cardinality()
    assert TRB.intersects(ta, tb) and not TRB.intersects(ta, far_t)
    assert JRB.intersects(ja, jb) and not JRB.intersects(ja, far_j)


def _runny(n_containers: int):
    return TRB(np.concatenate([
        (np.arange(0, 3000, dtype=np.int64) + (k << 16)) for k in range(n_containers)
    ]).astype(np.uint32))


def test_cutoff_boundary_and_array_hint():
    """Below ``min_containers`` the facade keeps the per-container walk; at
    it the pair routes columnar. Array-only operands stay per-container
    whatever their count, and one run container flips the hint."""
    cut = tcol.config.min_containers

    def total():
        return sum(tengine.BATCH_COUNTS.values())

    small, at_cut = _runny(cut - 1), _runny(cut)
    small.run_optimize()
    at_cut.run_optimize()
    before = total()
    TRB.and_(small, small.clone())
    assert total() == before
    TRB.and_(at_cut, at_cut.clone())
    assert total() > before
    arrays = TRB((np.arange(cut * 2) << 16).astype(np.uint32))
    before = total()
    TRB.and_(arrays, arrays.clone())
    TRB.or_(arrays, arrays.clone())
    assert total() == before
    mixed = arrays.clone()
    mixed.add_range(100 << 16, (100 << 16) + 50)
    mixed.run_optimize()
    assert TRB.and_(arrays, mixed) == TRB._and_percontainer(arrays, mixed)
    assert total() > before


def test_inplace_reuse_semantics():
    """ior/ixor/iandnot above the cutoff: the left operand's pass-through
    containers transfer (no clone), matched results are fresh, the right
    operand is never touched; the static ops clone."""
    rng = np.random.default_rng(3)
    n = tcol.config.min_containers + 8
    _, a = _typed(["array", "run"] * (n // 2), rng)
    _, b = _typed(["run"] * 16, rng, range(n - 4, n + 12))  # 4 keys shared with a
    b_before = b.clone()
    passthrough = a.high_low_container.containers[0]
    ref = TRB.or_(a, b)
    routed = tengine.ROUTE_COUNTS["columnar-cpu"]
    a.ior(b)
    assert tengine.ROUTE_COUNTS["columnar-cpu"] == routed + 1
    assert a == ref
    assert a.high_low_container.containers[0] is passthrough
    assert b == b_before
    _, a2 = _typed(["array", "run"] * (n // 2), rng)
    keep = a2.high_low_container.containers[0]
    assert TRB.xor(a2, b).high_low_container.containers[0] is not keep
    a3, a4, a5 = a2.clone(), a2.clone(), a2.clone()
    a3.ixor(b)
    a4.iandnot(b)
    a5.iand(b)
    with tcol.disabled():
        assert a3 == TRB.xor(a2, b)
        assert a4 == TRB.andnot(a2, b)
        assert a5 == TRB.and_(a2, b)
    a6 = a2.clone()
    a6 |= b
    a6 -= b
    assert a6 == TRB.andnot(a2, b)


# ---------------------------------------------------------------------------
# the cost model (no assertion depends on a clock)
# ---------------------------------------------------------------------------


def test_uncalibrated_gate_matches_jax():
    lo, hi = tcol.config.min_containers, tcol.config.max_containers
    assert (lo, hi) == (jcol.config.min_containers, jcol.config.max_containers)
    for na in (1, lo - 1, lo, 64, hi, hi + 1):
        for nb in (lo - 1, lo, 300, hi + 1):
            for shape in tcost.SHAPES:
                for op in OPS:
                    for resident in (False, True, (True, False)):
                        got = tcost.MODEL.choose(na, nb, shape, resident, op=op)
                        want = jcost.MODEL.choose(na, nb, shape, resident, op=op)
                        assert got[0] == want[0] and got[1]["model"] == "default-gate"
    assert tcost.MODEL.fold_gate_rows() == jcost.MODEL.fold_gate_rows() == tcol.config.min_fold_rows


def test_uncalibrated_routes_match_jax():
    """``route`` on real operands: the same verdict as the JAX package's
    for every shape mix and count, routing off under ``disabled()``."""
    rng = np.random.default_rng(79)
    shapes = {
        "arrays": ["array"] * 20,
        "bitmaps": ["array", "bitmap"] * 10,
        "runs": ["array", "run"] * 10,
        "few": ["run"] * 5,
    }
    built = {k: _typed(v, rng) for k, v in shapes.items()}
    for ka, (ja, ta) in built.items():
        for kb, (jb, tb) in built.items():
            for op in OPS:
                got = tcol.route(ta.high_low_container, tb.high_low_container, op=op)
                want = jcol.route(ja.high_low_container, jb.high_low_container, record=False, op=op)
                assert got == str(want), (ka, kb, op)


def test_device_eligible_follows_the_config(monkeypatch):
    """The device tier is priced only where the device path runs on CUDA
    and a card is there (``torch.cuda.is_available()``, the one probe the
    JAX package's backend query stands for)."""
    assert not tcost.MODEL.device_eligible()
    monkeypatch.setattr(aggregation.config, "device", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not tcost.MODEL.device_eligible()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tcost.MODEL.device_eligible()
    monkeypatch.setattr(aggregation.config, "device", "cpu")
    assert not tcost.MODEL.device_eligible()


def test_a_failing_calibration_raises_on_every_routed_call(monkeypatch):
    """The device tier named where it cannot run: the first-use
    calibration raises, and so does the next routed call; no call falls
    back to the uncalibrated gate."""
    monkeypatch.setattr(aggregation.config, "device", "cuda")
    # a card that reports itself present: the tier is eligible, so the
    # first routed op calibrates it
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    attempts = []

    def unusable(bm, device=None):
        attempts.append(bm)
        raise TierUnavailable("no card")

    monkeypatch.setattr(tdevice, "rows_for", unusable)
    rng = np.random.default_rng(139)
    (_, ta), (_, tb) = _random_pair(rng)
    for n in (1, 2):
        with pytest.raises(TierUnavailable):
            TRB.or_(ta, tb)
        assert len(attempts) == n and not tcost.MODEL.calibrated
    monkeypatch.setattr(aggregation.config, "device", "cpu")
    with tcol.disabled():
        want = TRB.or_(ta, tb)
    assert TRB.or_(ta, tb) == want


def _grid_is_argmin(model, device: bool):
    for n in (16, 32, 64, 300, 4096):
        for shape in tcost.SHAPES:
            for op in OPS:
                tier, inputs = model.choose(n, n, shape, False, device, op=op)
                est = inputs["est_us"]
                assert tier == min(est, key=est.get), (n, shape, op)
                assert ("columnar-device" in est) == device
                assert inputs["model"] == "calibrated"


def test_calibrated_choice_is_the_argmin_and_round_trips(tmp_path, monkeypatch):
    path = str(tmp_path / "colcal.json")
    m = tcol.calibrate(include_device=False, persist=path)
    assert m.calibrated and m.backend == "cpu" and os.path.isfile(path)
    _grid_is_argmin(m, False)
    gate = m.fold_gate_rows()
    assert gate == tcol.config.min_fold_rows or 16 <= gate <= 512
    for src in ("dict", "file"):
        m2 = tcost.CostModel()
        assert m2.from_dict(m.to_dict()) if src == "dict" else m2.load(path)
        assert m2.to_dict() == json.loads(json.dumps(m.to_dict()))
        for na in (16, 64, 512, 4096):
            for shape in tcost.SHAPES:
                assert m2.choose(na, na, shape, False)[0] == m.choose(na, na, shape, False)[0]
    with open(path, "w") as f:
        json.dump(dict(m.to_dict(), backend="cuda"), f)
    m3 = tcost.CostModel()
    assert not m3.load(path) and not m3.calibrated  # a foreign backend's numbers
    assert not m3.from_dict({"schema": "other"})
    # first use adopts a persisted calibration named by RB_TPU_COLUMNAR_CAL
    m.save(path)
    tcost.MODEL.reset()
    monkeypatch.setenv("RB_TPU_COLUMNAR_CAL", path)
    assert tcost.ensure_calibrated().calibrated
    tcost.MODEL.reset()
    assert not tcost.MODEL.calibrated


def test_forced_device_tier_routes_by_the_argmin(monkeypatch):
    """Calibrated with the device cells (on CPU tensors) and the device
    tier made eligible, the router prices it too; whatever it picks, the
    facade's result equals the per-container walk."""
    m = tcol.calibrate(include_device=True)
    assert m.ship_us_per_row > 0
    _grid_is_argmin(m, True)
    monkeypatch.setattr(tcost.CostModel, "device_eligible", lambda self: True)
    rng = np.random.default_rng(83)
    (_, ta), (_, tb) = _random_pair(rng)
    for op in OPS:
        tier = tcol.route(ta.high_low_container, tb.high_low_container, op=op)
        assert tier in tcost.ENGINES
        got = getattr(TRB, FACADE[op])(ta, tb)
        with tcol.disabled():
            assert got == getattr(TRB, FACADE[op])(ta, tb)


# ---------------------------------------------------------------------------
# resident rows
# ---------------------------------------------------------------------------


def _resident(bm) -> bool:
    return tdevice._colrows_key(bm.high_low_container, torch.device("cpu")) in tstore.PACK_CACHE


def _colrows():
    st = tstore.PACK_CACHE.stats()["kinds"].get("colrows", {"hits": 0, "misses": 0})
    return st["hits"], st["misses"]


def test_colrows_residency_and_delta_invalidation():
    """An operand's rows are built once and reused across ops; a mutated
    operand's fingerprint moves, so its old rows stop matching (no stale
    rows served) and the op stays right. Counters read as deltas."""
    rng = np.random.default_rng(117)
    _, (_, a) = _random_pair(rng)
    (_, b), _ = _random_pair(rng)
    h0, m0 = _colrows()
    rows = tdevice.rows_for(a)
    assert rows.shape == (a.get_container_count(), 2048) and rows.dtype == torch.int32
    words = np.stack([c.to_words() for c in a.high_low_container.containers])
    assert np.array_equal(rows.numpy().view(np.uint64), words)
    assert _resident(a) and not _resident(b)
    r1 = tcol.pairwise("or", a, b, tier="device")
    assert _colrows() == (h0 + 1, m0 + 2)  # a hit, b a miss
    v = (int(a.high_low_container.keys[0]) << 16) + 12345
    while a.contains(v) or b.contains(v):
        v += 1
    a.add(v)
    assert not _resident(a)
    r2 = tcol.pairwise("or", a, b, tier="device")
    assert _colrows() == (h0 + 2, m0 + 3)
    with tcol.disabled():
        assert r2 == TRB.or_(a, b)
    assert r2.contains(v) and r1 != r2


@pytest.mark.parametrize("op", OPS)
def test_device_tier_fetches_rows_only_for_a_device_bucket(op):
    """A pair of array and run containers has no device bucket under
    and/andnot (the host serves every class), so the device tier ships and
    keeps no rows for it; or/xor send every pair that is not aa to
    ``rb_pair_rows`` and fetch both sides. Results equal the CPU tier."""
    rng = np.random.default_rng(121)
    (_, a), (_, b) = (_typed(["array", "run"] * 10, rng) for _ in range(2))
    before = _colrows()
    got = tcol.pairwise(op, a, b, tier="device")
    assert got == tcol.pairwise(op, a, b, tier="cpu")
    h, m = _colrows()
    assert (h - before[0], m - before[1]) == ((0, 0) if op in ("and", "andnot") else (0, 2))
    assert _resident(a) == (op in ("or", "xor"))
    pairs = [(a, b), (b, a)]
    multi = tcol.pairwise_multi(op, pairs, tier="device")
    assert multi == [tcol.pairwise(op, x, y, tier="cpu") for x, y in pairs]
    if op in ("and", "andnot"):
        assert _colrows() == (h, m)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("op", OPS)
def test_cuda_pair_rows_matches_plain(op):
    """``rb_pair_rows`` bitwise against its plain version, with repeated
    indices, the last rows and an index past each block; one launch."""
    _need_card()
    rng = np.random.default_rng(89)
    ra, rb = _t(_rows(rng, 1000)).cuda(), _t(_rows(rng, 700)).cuda()
    ia = torch.from_numpy(np.concatenate([rng.integers(0, 1000, 4000), [999, 1000]]).astype(np.int32)).cuda()
    ib = torch.from_numpy(np.concatenate([rng.integers(0, 700, 4000), [699, -1]]).astype(np.int32)).cuda()
    before = K.LAUNCHES["rb_pair_rows"]
    w, c = K.pair_rows_reduce(ra, ia, rb, ib, op)
    torch.cuda.synchronize()
    assert K.LAUNCHES["rb_pair_rows"] == before + 1
    pw, pc = K.pair_rows_reduce_plain(ra, ia, rb, ib, op)
    assert torch.equal(w, pw) and torch.equal(c, pc)


@pytest.mark.cuda
@pytest.mark.parametrize("op", OPS)
def test_cuda_device_tier_matches_the_cpu_device_path(op, monkeypatch):
    _need_card()
    rng = np.random.default_rng(97)
    (_, ta), (_, tb) = _random_pair(rng)
    pairs = [(ta, tb), (tb, ta)]
    want = tcol.pairwise_multi(op, pairs, tier="device")  # CPU tensors
    monkeypatch.setattr(aggregation.config, "device", "cuda")
    before = K.LAUNCHES["rb_pair_rows"]
    got = tcol.pairwise_multi(op, pairs, tier="device")
    assert K.LAUNCHES["rb_pair_rows"] == before + 1
    assert [g.serialize() for g in got] == [w.serialize() for w in want]


# ---------------------------------------------------------------------------
# the cutoff decision log, the outcome join, the refit and the fault sites
# ---------------------------------------------------------------------------




def _cal_state(backend="cpu"):
    """A calibrated cost table whose argmin moves with the count and the
    shape, the same dict for both packages."""
    table = {
        "per-container": {"array": [2.0, 1.5], "bitmap": [2.0, 9.0], "run": [2.0, 14.0]},
        "columnar-cpu": {"array": [90.0, 1.2], "bitmap": [80.0, 2.0], "run": [70.0, 1.0]},
        "columnar-device": {"array": [400.0, 0.9], "bitmap": [300.0, 0.4], "run": [350.0, 0.5]},
    }
    slower = {e: {s: [c[0] * 1.5, c[1] * 1.25] for s, c in v.items()} for e, v in table.items()}
    return {
        "schema": jcost.SCHEMA, "backend": backend, "calibrated": True,
        "coeffs": {"and": table, "or": slower}, "ship_us_per_row": 3.0,
        "fold_rows_min": 96, "provenance": "calibrated",
    }


@pytest.fixture
def calibrated(monkeypatch):
    """Both packages' cost models on the same calibrated table, the
    outcome ledgers and the cutoff's registry series empty, and fresh
    below-gate samplers (their counters are process-wide)."""
    monkeypatch.setattr(tengine, "_BELOW_GATE", tdecisions.SampledSite(64))
    monkeypatch.setattr(jengine, "_BELOW_GATE", jdecisions.SampledSite(64))
    assert tcost.SCHEMA == jcost.SCHEMA
    assert tcost.MODEL.from_dict(_cal_state(), check_backend=False)
    assert jcost.MODEL.from_dict(_cal_state(), check_backend=False)
    for mod in (toutcomes, joutcomes):
        mod.reset()
    for obs in (tobs, jobs):
        obs.REGISTRY.get(obs.COSTMODEL_DRIFT_RATIO).clear()
        obs.REGISTRY.get(obs.COLUMNAR_BATCH_TOTAL).clear()
    tdecisions.LOG.clear()
    jdecisions.LOG.clear()
    yield
    for mod in (toutcomes, joutcomes):
        mod.reset()


def _cutoff_entries(dec):
    return [
        (e["decision"], {k: v for k, v in (e.get("inputs") or {}).items()})
        for e in dec.decisions() if e["site"] == "columnar.cutoff"
    ]


def _routing_corpus(rng):
    shapes = {
        "arrays-20": ["array"] * 20,
        "bitmaps-20": ["array", "bitmap"] * 10,
        "runs-20": ["array", "run"] * 10,
        "runs-80": ["run", "array"] * 40,
        "bitmaps-200": ["bitmap", "array"] * 100,
        "few": ["run"] * 5,
    }
    return {k: _typed(v, rng) for k, v in shapes.items()}


@pytest.mark.parametrize("op", OPS)
def test_calibrated_verdicts_and_cutoff_inputs_match_jax(op, calibrated):
    built = _routing_corpus(np.random.default_rng(131))
    verdicts = []
    for _ka, (ja, ta) in built.items():
        for _kb, (jb, tb) in built.items():
            got = tcol.route(ta.high_low_container, tb.high_low_container, op=op)
            want = jcol.route(ja.high_low_container, jb.high_low_container, op=op)
            assert str(got) == str(want)
            assert (getattr(got, "seq", None) is None) == (getattr(want, "seq", None) is None)
            verdicts.append(str(got))
    assert _cutoff_entries(tdecisions) == _cutoff_entries(jdecisions)
    assert {"per-container", "columnar-cpu"} <= set(verdicts)
    entries = _cutoff_entries(tdecisions)
    assert entries and all(inputs["resident"] is False for _d, inputs in entries
                           if "est_us" in inputs)


def test_verdict_carries_its_serial_and_the_facade_joins_it(calibrated):
    (_, a), (_, b) = _random_pair(np.random.default_rng(137), n_keys=40)
    tier = tcol.route(a.high_low_container, b.high_low_container, op="or")
    assert isinstance(tier, tcol.Verdict) and tier.seq is not None
    assert tier == str(tier) and hash(tier) == hash(str(tier))
    before = len(toutcomes.tail())
    with tcol.disabled():
        want = TRB.or_(a, b)
    assert TRB.or_(a, b) == want
    joined = toutcomes.tail()[before:]
    assert [e["site"] for e in joined] == ["columnar.cutoff"]
    assert joined[0]["engine"] in tcost.ENGINES and joined[0]["predicted_us"] is not None
    # provenance-only verdicts (the count facades) park no pending join
    pending = toutcomes.LEDGER.pending_count()
    assert tcol.enabled_for(a.high_low_container, b.high_low_container) in (True, False)
    assert toutcomes.LEDGER.pending_count() == pending


def test_outcome_joins_set_the_same_drift_cells_as_jax(calibrated):
    built = _routing_corpus(np.random.default_rng(139))
    rng = np.random.default_rng(5)
    for (ja, ta), (jb, tb) in zip(built.values(), list(built.values())[1:]):
        for op in ("and", "or"):
            measured = float(rng.uniform(1e-5, 2e-3))
            for col, dec_mod, out_mod, a, b in ((tcol, tdecisions, toutcomes, ta, tb),
                                                (jcol, jdecisions, joutcomes, ja, jb)):
                v = col.route(a.high_low_container, b.high_low_container, op=op)
                if getattr(v, "seq", None) is not None:
                    out_mod.resolve(v.seq, "columnar.cutoff", measured, engine=str(v))
    t_drift = tobs.REGISTRY.get(tobs.COSTMODEL_DRIFT_RATIO).series()
    j_drift = jobs.REGISTRY.get(jobs.COSTMODEL_DRIFT_RATIO).series()
    assert t_drift == j_drift and t_drift
    assert toutcomes.drift() == joutcomes.drift()
    assert toutcomes.samples() == joutcomes.samples()


def _refit_samples(seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(60):
        engine = str(rng.choice(tcost.ENGINES))
        shape = str(rng.choice(tcost.SHAPES))
        n = int(rng.integers(16, 300))
        out.append({"op": str(rng.choice(OPS)), "engine": engine, "shape": shape, "n": n,
                    "measured_us": float(40 + 3 * n * rng.uniform(0.5, 1.5))})
    out += [
        {"op": "and", "engine": "columnar-cpu", "shape": "run", "n": 50, "measured_us": 1e9},
        {"op": "and", "engine": "bogus", "shape": "run", "n": 50, "measured_us": 10.0},
        {"op": "and", "engine": "columnar-cpu", "shape": "run", "n": 50, "measured_us": float("nan")},
        {"engine": "columnar-cpu"},
    ]
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_refit_from_outcomes_moves_the_same_cells_as_jax(seed, calibrated):
    samples = _refit_samples(seed)
    got = tcost.refit_from_outcomes(samples=samples, persist="")
    want = jcost.refit_from_outcomes(samples=samples, persist="")
    assert got == want and got["moved"] and got["rejected"] >= 3
    assert tcost.MODEL.coeffs == jcost.MODEL.coeffs
    assert tcost.MODEL.provenance == jcost.MODEL.provenance == "refit-from-traffic"
    assert tdecisions.decisions(1)[0]["site"] == "costmodel.refit"


def test_refit_reads_the_live_ledger_and_refuses_an_uncalibrated_model(calibrated):
    built = _routing_corpus(np.random.default_rng(149))
    rng = np.random.default_rng(9)
    pairs = list(built.values())
    for _ in range(3):
        for (ja, ta), (jb, tb) in zip(pairs, pairs[1:]):
            measured = float(rng.uniform(1e-4, 1e-3))
            for col, out_mod, a, b in ((tcol, toutcomes, ta, tb), (jcol, joutcomes, ja, jb)):
                v = col.route(a.high_low_container, b.high_low_container, op="and")
                if getattr(v, "seq", None) is not None:
                    out_mod.resolve(v.seq, "columnar.cutoff", measured, engine=str(v))
    got = tcost.refit_from_outcomes(min_samples=2)
    want = jcost.refit_from_outcomes(min_samples=2)
    assert got == want and got["samples"] > 0
    tcost.MODEL.reset()
    jcost.MODEL.reset()
    assert tcost.refit_from_outcomes(samples=[]) == jcost.refit_from_outcomes(samples=[])


def test_below_gate_verdicts_are_sampled_one_in_64(monkeypatch):
    monkeypatch.setattr(tengine, "_BELOW_GATE", tdecisions.SampledSite(64))
    monkeypatch.setattr(jengine, "_BELOW_GATE", jdecisions.SampledSite(64))
    tdecisions.LOG.clear()
    jdecisions.LOG.clear()
    (ja, ta) = _typed(["run"] * 4, np.random.default_rng(151))
    for _ in range(130):
        assert tcol.route(ta.high_low_container, ta.high_low_container) == "per-container"
        jcol.route(ja.high_low_container, ja.high_low_container)
    got, want = _cutoff_entries(tdecisions), _cutoff_entries(jdecisions)
    assert got == want and len(got) == 2
    assert got[0] == ("per-container", {"reason": "outside-gate", "sampled": 64, "na": 4, "nb": 4})
    with pytest.raises(ValueError):
        tdecisions.SampledSite(48)


@pytest.mark.parametrize("op", OPS)
def test_columnar_counters_and_class_spans_match_jax(op):
    (ja, ta), (jb, tb) = _nine_class_pair(np.random.default_rng(157))
    for obs in (tobs, jobs):
        obs.REGISTRY.get(obs.COLUMNAR_BATCH_TOTAL).clear()
    tcol.pairwise(op, ta, tb, tier="cpu")
    jcol.pairwise(op, ja, jb, tier="cpu")
    from roaringbitmap_tpu import insights as jinsights

    assert tinsights.columnar_counters()["batch"] == jinsights.columnar_counters()["batch"]
    assert tengine.BATCH_COUNTS == tinsights.columnar_counters()["batch"]
    spans = tobs.REGISTRY.get(tobs.COLUMNAR_CLASS_SECONDS).series()
    assert any(lv[0] == op for lv in spans)
    model = tinsights.columnar_costmodel()
    assert model["fold_gate_rows"] == tcost.MODEL.fold_gate_rows()
    assert set(tinsights.columnar_counters()["route"]) >= set()


def test_router_records_the_residency_of_both_sides(calibrated, monkeypatch):
    monkeypatch.setattr(tcost.CostModel, "device_eligible", lambda self: True)
    (_, a), (_, b) = _random_pair(np.random.default_rng(163))
    assert not tdevice.rows_resident(a) and not tdevice.rows_resident(b)

    def last_resident():
        tcol.route(a.high_low_container, b.high_low_container, op="or")
        return tdecisions.decisions(1)[0]["inputs"]["resident"]

    assert last_resident() is False
    rows = tdevice.rows_for(a)
    assert tdevice.rows_resident(a) and not tdevice.rows_resident(b)
    assert last_resident() is False  # one side only
    tdevice.rows_for(b)
    assert tdevice.rows_resident_hlc(b.high_low_container)
    assert last_resident() is True
    assert rows.numel() * 4 == 2048 * 4 * a.get_container_count()


@pytest.mark.parametrize("op", OPS)
def test_transient_device_fault_is_retried_and_exact(op):
    rng = np.random.default_rng(167)
    (_, a), (_, b) = _random_pair(rng)
    want = tcol.pairwise(op, a, b, tier="cpu")
    key = ("columnar.device", "recovered")
    retries = tobs.REGISTRY.get(tobs.RETRY_TOTAL)
    before = retries.get(key)
    with tfaults.inject("columnar.device", every=1, times=1) as inj:
        got = tcol.pairwise(op, a, b, tier="device")
    assert inj.fired == 1 and got == want
    assert retries.get(key) == before + 1
    with tfaults.inject("columnar.device", every=1, times=1) as inj:
        multi = tcol.pairwise_multi(op, [(a, b), (b, a)], tier="device")
    assert inj.fired == 1 and multi == [want, tcol.pairwise(op, b, a, tier="cpu")]


def test_device_fault_that_is_not_transient_raises():
    (_, a), (_, b) = _random_pair(np.random.default_rng(173))
    with tfaults.inject("columnar.device", terrors.ResourceExhausted, every=1):
        with pytest.raises(terrors.ResourceExhausted):
            tcol.pairwise("or", a, b, tier="device")


@pytest.mark.parametrize("op", OPS)
def test_kernel_fault_raises_classified_on_the_native_tier(op):
    tnative.set_tier("native")
    (_, a), (_, b) = _nine_class_pair(np.random.default_rng(179))
    with tfaults.inject("columnar.kernel", every=1, times=1) as inj:
        with pytest.raises(terrors.TransientDeviceError) as ei:
            tcol.pairwise(op, a, b, tier="cpu")
    assert inj.fired == 1 and terrors.classify(ei.value) == terrors.TRANSIENT
    tnative.set_tier("numpy")
    with tfaults.inject("columnar.kernel", every=1) as inj:  # the numpy tier holds no site
        tcol.pairwise(op, a, b, tier="cpu")
    assert inj.fired == 0


@pytest.mark.cuda
def test_cuda_device_tier_retries_a_transient_fault_and_a_kernel_fault_raises(monkeypatch):
    """Phase 17 (e) on the card: the device tier with a transient
    ``columnar.device`` fault is retried on the card and equals the CPU
    tier; a ``columnar.kernel`` fault on the native tier raises,
    classified."""
    _need_card()
    rng = np.random.default_rng(181)
    (_, a), (_, b) = _random_pair(rng)
    want = tcol.pairwise("or", a, b, tier="cpu")
    monkeypatch.setattr(aggregation.config, "device", "cuda")
    before = K.LAUNCHES["rb_pair_rows"]
    with tfaults.inject("columnar.device", every=1, times=1) as inj:
        got = tcol.pairwise("or", a, b, tier="device")
    assert inj.fired == 1 and got == want
    assert K.LAUNCHES["rb_pair_rows"] == before + 1
    assert tdevice.rows_resident(a) and tdevice.rows_resident(b)
    tnative.set_tier("native")
    with tfaults.inject("columnar.kernel", every=1, times=1):
        with pytest.raises(terrors.TransientDeviceError) as ei:
            tcol.pairwise("and", a, b, tier="cpu")
    assert terrors.classify(ei.value) == terrors.TRANSIENT
