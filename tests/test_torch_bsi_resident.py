"""Resident found sets of the port's BSI against the bitmap path, the JAX
package and a brute-force numpy evaluation.

A chain of ``compare_resident`` calls keeps every intermediate set on the
device (here CPU tensors: ``bsi.config.device = "cpu"``, where each kernel
wrapper takes its plain PyTorch version); ``compare``,
``compare_cardinality`` and ``sum`` take such a set as their found set.
Each result must equal the same call with the set as a ``RoaringBitmap``,
the JAX package's ``compare`` / ``sum`` with that bitmap, and the predicate
evaluated on the columns' values in numpy: every operation, each min/max
verdict, an empty found set, a found set on another chunk-key layout, and
NEQ over found columns outside the ebm. The spans and the counter the
resident path adds are read back through ``tracing.timings()`` and the
registry.
"""

import numpy as np
import pytest
import torch

from roaringbitmap_tpu.models import bsi as jbsi
from roaringbitmap_tpu.models.roaring import RoaringBitmap as JRB

from roaringbitmap_tpu_torch import Operation as TOp
from roaringbitmap_tpu_torch import ResidentSet
from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch import RoaringBitmapSliceIndex as TBSI
from roaringbitmap_tpu_torch import observe, tracing
from roaringbitmap_tpu_torch.models import bsi as tbsi
from roaringbitmap_tpu_torch.parallel import aggregation
from roaringbitmap_tpu_torch.parallel import store as tstore

SEED = 0xFEEF1F0
OPS = ("EQ", "NEQ", "GT", "LT", "LE", "GE", "RANGE")
BITS = 10


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    """The port's BSI device path on CPU tensors; the shared pack cache is
    emptied after each test."""
    monkeypatch.setattr(tbsi.config, "device", "cpu")
    monkeypatch.setattr(aggregation.config, "device", "cpu")
    monkeypatch.setattr(tbsi.config, "mode", "auto")
    yield
    tstore.PACK_CACHE.close()


class Column:
    """One column in both packages and as plain arrays."""

    def __init__(self, cols: np.ndarray, vals: np.ndarray):
        self.cols, self.vals = cols, vals
        self.j, self.t = jbsi.RoaringBitmapSliceIndex(), TBSI()
        self.j.set_values((cols, vals))
        self.t.set_values((cols, vals))


def _column(seed, chunks, n, const=None):
    rng = np.random.default_rng(seed)
    lo, hi = chunks
    cols = np.sort(rng.choice(np.arange(lo << 16, hi << 16), size=n, replace=False)).astype(np.uint32)
    vals = np.full(n, const) if const is not None else rng.integers(0, 1 << BITS, size=n)
    if const is None:
        vals[:7] = 0
        vals[7:11] = (1 << BITS) - 1
    return Column(cols, vals.astype(np.int64))


@pytest.fixture(scope="module")
def table():
    """Two columns of one table (chunks 0-4, the same layout), a column on
    chunks 3-8 (another layout), a column of one value (the NEQ verdicts
    that need min == max), and found columns over chunks 0-7."""
    a = _column(SEED, (0, 5), 60_000)
    b = Column(a.cols, np.random.default_rng(SEED + 1).integers(0, 1 << BITS, size=a.cols.size))
    other = _column(SEED + 2, (3, 9), 50_000)
    const = _column(SEED + 3, (0, 5), 20_000, const=7)
    rng = np.random.default_rng(SEED + 4)
    found = np.unique(np.concatenate([rng.choice(a.cols, 30_000, replace=False),
                                      rng.choice(np.arange(5 << 16, 8 << 16), 4_000, replace=False)]))
    return {"a": a, "b": b, "other": other, "const": const, "found": found.astype(np.uint32)}


def _brute(col: Column, op: str, v: int, end: int, found) -> np.ndarray:
    """The columns ``compare`` returns, from the values: the predicate over
    the found columns the index holds; NEQ keeps every found column not
    equal to ``v`` (those outside the index too), except where min == max,
    where Java's short-circuit answers empty or the found columns the index
    holds."""
    fs = col.cols if found is None else np.asarray(found, dtype=np.uint32)
    held = np.isin(col.cols, fs)
    cols, vals = col.cols[held], col.vals[held]
    pred = {
        "EQ": vals == v, "NEQ": vals != v, "GT": vals > v, "LT": vals < v,
        "LE": vals <= v, "GE": vals >= v, "RANGE": (vals >= v) & (vals <= end),
    }[op]
    if op != "NEQ":
        return cols[pred]
    mn, mx = int(col.vals.min()), int(col.vals.max())
    if mn == mx:
        return np.array([], dtype=np.uint32) if v == mn else cols
    return np.setdiff1d(fs, cols[vals == v])


def _cases(col: Column):
    """(op, value, end) covering the walk and each min/max verdict."""
    mn, mx = int(col.vals.min()), int(col.vals.max())
    mid = int(np.median(col.vals))
    out = []
    for op in OPS:
        if op == "RANGE":
            out += [(op, mid // 2, mid + 50), (op, 0, mx), (op, mx + 1, mx + 9), (op, mid, mid)]
        else:
            out += [(op, mid, 0), (op, mn, 0), (op, mx, 0), (op, mx + 1, 0)]
    if mn == mx:
        out += [("NEQ", mn, 0), ("NEQ", mn + 3, 0), ("EQ", mn, 0)]
    return out


def _resident(col: Column, found: np.ndarray) -> ResidentSet:
    """``found`` as a resident set on ``col``'s layout, its columns outside
    the ebm kept: the raw found set of NEQ's fixed verdict."""
    return col.t.compare_resident(TOp.NEQ, int(col.vals.max()) + 1, found_set=TRB(found))


def _assert_equal(col, op, v, end, found_t, found_bm, found_arr):
    want = _brute(col, op, v, end, found_arr)
    r = col.t.compare_resident(TOp[op], v, end, found_t)
    assert isinstance(r, ResidentSet)
    assert np.array_equal(r.to_bitmap().to_array(), want), (op, v, end)
    assert r.get_cardinality() == want.size
    # the port's bitmap path and the JAX package
    bm = col.t.compare(TOp[op], v, end, found_bm, mode="device")
    assert r.to_bitmap().serialize() == bm.serialize(), (op, v, end)
    jfound = None if found_arr is None else JRB(np.asarray(found_arr, dtype=np.uint32))
    jres = col.j.compare(jbsi.Operation[op], v, end, jfound, mode="cpu")
    assert np.array_equal(np.asarray(jres.to_array()), want), (op, v, end)
    # compare and compare_cardinality given the resident set
    if found_t is not None:
        assert col.t.compare(TOp[op], v, end, found_t).serialize() == bm.serialize()
        assert col.t.compare(TOp[op], v, end, found_t, mode="cpu").serialize() == bm.serialize()
        assert col.t.compare_cardinality(TOp[op], v, end, found_t) == want.size
    return r


@pytest.mark.parametrize("name", ["a", "const"])
@pytest.mark.parametrize("form", ["none", "same_layout", "other_layout"])
def test_every_operation_and_verdict_equals_the_bitmap_path_jax_and_numpy(table, name, form):
    col = table[name]
    found = table["found"]
    found_t = found_bm = found_arr = None
    if form == "same_layout":
        found_arr = found[found < 5 << 16]
        found_t = _resident(table["a"], found_arr)
        assert found_t.keys is col.t._pack_dense()[0]
    elif form == "other_layout":
        found_arr = found  # with columns in chunks 5-7, outside the ebm
        found_t = _resident(table["other"], found_arr)
        assert found_t.keys == tuple(range(9))
    if found_t is not None:
        found_bm = TRB(found_arr)
        assert np.array_equal(found_t.to_bitmap().to_array(), found_arr)
    for op, v, end in _cases(col):
        _assert_equal(col, op, v, end, found_t, found_bm, found_arr)


def test_a_chain_over_columns_equals_the_bitmap_chain_jax_and_numpy(table):
    """Q6's shape: a range, a range under it, a less-than under that, then
    per value an equality and a sum over another column of the table."""
    a, b, other = table["a"], table["b"], table["other"]
    f = a.t.compare_resident(TOp.RANGE, 100, 700)
    f = b.t.compare_resident(TOp.RANGE, 200, 900, f)
    f = other.t.compare_resident(TOp.LT, 600, found_set=f)  # another layout
    f = a.t.compare_resident(TOp.GE, 150, found_set=f)
    fb = a.t.compare(TOp.RANGE, 100, 700)
    fb = b.t.compare(TOp.RANGE, 200, 900, fb)
    fb = other.t.compare(TOp.LT, 600, found_set=fb)
    fb = a.t.compare(TOp.GE, 150, found_set=fb)
    jf = a.j.compare(jbsi.Operation.RANGE, 100, 700, None, mode="cpu")
    jf = b.j.compare(jbsi.Operation.RANGE, 200, 900, jf, mode="cpu")
    jf = other.j.compare(jbsi.Operation.LT, 600, 0, jf, mode="cpu")
    jf = a.j.compare(jbsi.Operation.GE, 150, 0, jf, mode="cpu")
    va = dict(zip(a.cols.tolist(), a.vals.tolist()))
    vb = dict(zip(b.cols.tolist(), b.vals.tolist()))
    vo = dict(zip(other.cols.tolist(), other.vals.tolist()))
    want = np.array(sorted(c for c in va if 100 <= va[c] <= 700 and 200 <= vb[c] <= 900
                           and c in vo and vo[c] < 600 and va[c] >= 150), dtype=np.uint32)
    assert want.size > 100
    assert np.array_equal(f.to_bitmap().to_array(), want)
    assert f.to_bitmap().serialize() == fb.serialize()
    assert np.array_equal(np.asarray(jf.to_array()), want)
    for v in sorted({vb[c] for c in want[:3].tolist()}) + [1 << BITS]:
        e = b.t.compare_resident(TOp.EQ, v, found_set=f)
        got = a.t.sum(e)
        eb = b.t.compare(TOp.EQ, v, found_set=fb)
        je = b.j.compare(jbsi.Operation.EQ, v, 0, jf, mode="cpu")
        cols = [c for c in want.tolist() if vb[c] == v]
        assert got == a.t.sum(eb, mode="device") == tuple(a.j.sum(je, mode="cpu"))
        assert got == (sum(va[c] for c in cols), len(cols))


@pytest.mark.parametrize("form", ["same_layout", "other_layout", "empty", "none"])
def test_sum_under_a_resident_found_set(table, form):
    a, found = table["a"], table["found"]
    if form == "none":
        assert a.t.sum(None) == (0, 0)
        return
    if form == "empty":
        r = a.t.compare_resident(TOp.GT, int(a.vals.max()) + 5)  # the empty verdict
        assert r.keys == () and r.get_cardinality() == 0
        assert a.t.sum(r) == a.t.sum(TRB()) == tuple(a.j.sum(JRB(), mode="cpu")) == (0, 0)
        assert a.t.compare_cardinality(TOp.GE, 0, found_set=r) == 0
        assert a.t.compare_resident(TOp.NEQ, 3, found_set=r).get_cardinality() == 0
        return
    r = _resident(a if form == "same_layout" else table["other"], found)
    held = np.isin(a.cols, found)
    want = (int(a.vals[held].sum()), int(found.size))
    assert a.t.sum(r) == a.t.sum(TRB(found), mode="device") == tuple(a.j.sum(JRB(found), mode="cpu"))
    assert a.t.sum(r) == want
    assert a.t.sum(r, mode="cpu") == want


def test_neq_keeps_found_columns_outside_the_ebm_on_the_device(table):
    """A NEQ under a resident set from another layout: the found rows in
    chunks the index lacks stay on the device and join the result's
    layout; the result reads back equal through every entry point."""
    a, other, found = table["a"], table["other"], table["found"]
    r = _resident(other, found)
    assert set(r.keys) - set(range(5))  # rows outside a's chunks
    v = int(np.median(a.vals))
    res = a.t.compare_resident(TOp.NEQ, v, found_set=r)
    want = _brute(a, "NEQ", v, 0, found)
    assert want.max() >= 5 << 16
    assert list(res.keys) == sorted(res.keys) and set(res.keys) >= set(r.keys) - set(range(5))
    assert np.array_equal(res.to_bitmap().to_array(), want)
    assert a.t.compare_cardinality(TOp.NEQ, v, found_set=r) == want.size
    # the fixed verdict hands the resident set back as it is
    assert a.t.compare_resident(TOp.NEQ, int(a.vals.max()) + 1, found_set=r) is r


def _delta(before, after, names):
    def count(t, n):
        return t.get(n, {"count": 0})["count"]
    return {n: count(after, n) - count(before, n) for n in names}


SPANS = ("bsi.compare", "bsi.sum", "bsi.compare_cardinality", "bsi.found.marshal",
         "bsi.found.resident", "store.unpack_to_bitmap")


def _found_counts():
    c = observe.REGISTRY.get(observe.BSI_FOUND_TOTAL)
    return {f: c.get((f,)) for f in ("none", "bitmap", "resident")}


def test_a_resident_chain_opens_no_marshal_and_no_unpack(table):
    a, b = table["a"], table["b"]
    a.t.compare_resident(TOp.GE, 1)  # both packs built before the count
    b.t.compare_resident(TOp.GE, 1)
    before, fb = tracing.timings(), _found_counts()
    f = a.t.compare_resident(TOp.RANGE, 100, 700)
    f = b.t.compare_resident(TOp.LT, 500, found_set=f)
    total = b.t.sum(f)
    count = a.t.compare_cardinality(TOp.EQ, 300, found_set=f)
    after, fa = tracing.timings(), _found_counts()
    assert total[1] > 0 and count >= 0 and f.keys is b.t._pack_dense()[0]
    assert _delta(before, after, SPANS) == {
        "bsi.compare": 2, "bsi.sum": 1, "bsi.compare_cardinality": 1,
        "bsi.found.marshal": 0, "bsi.found.resident": 3, "store.unpack_to_bitmap": 0,
    }
    assert {k: fa[k] - fb[k] for k in fa} == {"none": 1, "bitmap": 0, "resident": 3}


def test_a_bitmap_found_set_is_marshalled_and_its_result_unpacked(table):
    a, found = table["a"], table["found"]
    a.t.compare_resident(TOp.GE, 1)
    before, fb = tracing.timings(), _found_counts()
    a.t.compare(TOp.LT, 500, found_set=TRB(found), mode="device")
    a.t.sum(TRB(found), mode="device")
    after, fa = tracing.timings(), _found_counts()
    assert _delta(before, after, SPANS) == {
        "bsi.compare": 1, "bsi.sum": 1, "bsi.compare_cardinality": 0,
        "bsi.found.marshal": 2, "bsi.found.resident": 0, "store.unpack_to_bitmap": 1,
    }
    assert {k: fa[k] - fb[k] for k in fa} == {"none": 0, "bitmap": 2, "resident": 0}


def test_columns_of_one_layout_share_the_packs_keys(table):
    """Two columns over the same chunks get one keys object, so a resident
    set from one meets the other with an identity test; another layout
    does not."""
    a, b, other = table["a"], table["b"], table["other"]
    ka = a.t._pack_dense()[0]
    assert ka is b.t._pack_dense()[0]
    assert ka is not other.t._pack_dense()[0]


@pytest.mark.cuda
def test_a_resident_chain_on_the_card_equals_the_cpu_device_path(table, monkeypatch):
    """On the card: the chain's sets, counts and sums through the CUDA
    kernels equal the same chain on CPU tensors. Skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    a, b, other, found = table["a"], table["b"], table["other"], table["found"]
    results = {}
    for device in ("cuda", "cpu"):
        monkeypatch.setattr(tbsi.config, "device", device)
        f = a.t.compare_resident(TOp.RANGE, 100, 700)
        f = b.t.compare_resident(TOp.RANGE, 200, 900, f)
        f = other.t.compare_resident(TOp.LT, 600, found_set=f)
        sums = [a.t.sum(b.t.compare_resident(TOp.EQ, v, found_set=f)) for v in (300, 400, 500)]
        neq = a.t.compare_resident(TOp.NEQ, 400, found_set=_resident(other, found))
        results[device] = (f.to_bitmap().serialize(), sums, neq.to_bitmap().serialize(),
                           a.t.compare_cardinality(TOp.GE, 300, found_set=f))
        tstore.PACK_CACHE.close()
    assert results["cuda"] == results["cpu"]
