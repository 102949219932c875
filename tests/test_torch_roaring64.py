"""The port's 64-bit bitmaps and their aggregation against the JAX package.

The same seeded values go into both packages' ``Art``,
``Roaring64Bitmap`` and ``Roaring64NavigableMap``; every comparison is
exact: trie traversal order and node-width histograms, values,
cardinalities, rank / select / navigation answers, and serialized bytes in
both directions (port bytes read by the JAX package, JAX bytes read by the
port) for the ART format and both NavigableMap wire formats.
``FastAggregation64`` and ``or_navigable`` run in ``cpu`` and ``device``
modes on both sides: the JAX package on its CPU backend, the port's device
path on CPU tensors (``aggregation.config.device = "cpu"``), where every
kernel wrapper takes its plain version. The ``cuda``-marked tests run the
device path through the CUDA kernels and skip without a card.
"""

import io
import itertools
import pickle
import tracemalloc

import numpy as np
import pytest
import torch

from roaringbitmap_tpu.models import art as jart
from roaringbitmap_tpu.models import roaring64 as jr64
from roaringbitmap_tpu.models.buffer import MutableRoaringBitmap as JMutable
from roaringbitmap_tpu.models.roaring64 import Roaring64NavigableMap as JNav
from roaringbitmap_tpu.models.roaring64art import Roaring64Bitmap as JR64
from roaringbitmap_tpu.parallel import aggregation64 as jagg64
from roaringbitmap_tpu.parallel import store as jstore
from roaringbitmap_tpu.serialization import InvalidRoaringFormat as JInvalid

import roaringbitmap_tpu_torch as T
from roaringbitmap_tpu_torch import interop
from roaringbitmap_tpu_torch.models import art as tart
from roaringbitmap_tpu_torch.models import roaring64 as tr64
from roaringbitmap_tpu_torch.ops import kernels as K
from roaringbitmap_tpu_torch.parallel import aggregation
from roaringbitmap_tpu_torch.parallel import aggregation64 as tagg64
from roaringbitmap_tpu_torch.parallel import store as tstore
from roaringbitmap_tpu_torch.robust.errors import TierUnavailable

SEED = 0xFEEF1F0
MAXINT = (1 << 32) - 1
DESIGNS = {"art": (JR64, T.Roaring64Bitmap), "navigable": (JNav, T.Roaring64NavigableMap)}
AGG_OPS = ("or_", "xor", "and_")


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    """The port's device path on CPU tensors; both packages' pack caches
    emptied around each test."""
    monkeypatch.setattr(aggregation.config, "device", "cpu")
    tstore.PACK_CACHE.close()
    yield
    tstore.PACK_CACHE.close()
    jstore.PACK_CACHE.close()


def k6(x: int) -> bytes:
    return int(x).to_bytes(6, "big")


def _pair(design, vals, **kw):
    j, t = DESIGNS[design]
    return j(vals, **kw), t(vals, **kw)


def _same(j, t):
    """Values, cardinality and portable bytes identical, and each side
    reads the other's bytes back to its own."""
    assert np.array_equal(t.to_array(), j.to_array())
    assert t.get_cardinality() == j.get_cardinality()
    jb, tb = j.serialize(), t.serialize()
    assert tb == jb
    assert type(j).deserialize(tb).serialize() == jb
    assert type(t).deserialize(jb).serialize() == tb


def _mixed_values(rng, n=3000):
    return np.unique(np.concatenate([
        rng.integers(0, 1 << 20, size=n // 3, dtype=np.uint64),
        rng.integers(0, 1 << 48, size=n // 3, dtype=np.uint64),
        rng.integers(0, 1 << 64, size=n // 3, dtype=np.uint64),
    ]))


def random_values64(rng, n=5000):
    highs = rng.choice([0, 1, 5, 1 << 20, (1 << 32) - 1], size=n)
    lows = rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
    return (highs.astype(np.uint64) << np.uint64(32)) | lows


def _art_pair():
    return jart.Art(), tart.Art()


def _same_art(ja, ta):
    assert list(ta.items()) == list(ja.items())
    assert list(ta.items_reverse()) == list(ja.items_reverse())
    assert ta.node_width_histogram() == ja.node_width_histogram()
    assert len(ta) == len(ja) and ta.is_empty() == ja.is_empty()


# ---------------------------------------------------------------------------
# the adaptive radix tree (tests/test_art.py's TestArt)
# ---------------------------------------------------------------------------


def test_art_insert_find():
    ja, ta = _art_pair()
    assert ta.find(k6(1)) is None
    for i in range(100):
        ja.insert(k6(i * 7919), i)
        ta.insert(k6(i * 7919), i)
    _same_art(ja, ta)
    for probe in [i * 7919 for i in range(100)] + [5, 1 << 40]:
        assert ta.find(k6(probe)) == ja.find(k6(probe))


def test_art_replace():
    ja, ta = _art_pair()
    for a in (ja, ta):
        a.insert(k6(42), "a")
        a.insert(k6(42), "b")
    _same_art(ja, ta)
    assert ta.find(k6(42)) == "b"


@pytest.mark.parametrize("n", [1, 3, 5, 17, 49, 200, 256])
def test_art_node_growth_levels(n):
    """Node4 -> Node16 -> Node48 -> Node256 upgrades under one parent byte
    position: the same widths and order as the JAX trie."""
    ja, ta = _art_pair()
    for i in range(n):
        ja.insert(bytes([1, 2, 3, 4, 5, i]), i)
        ta.insert(bytes([1, 2, 3, 4, 5, i]), i)
    _same_art(ja, ta)
    for i in range(n):
        assert ta.find(bytes([1, 2, 3, 4, 5, i])) == i


def test_art_ordered_iteration_random():
    rng = np.random.default_rng(SEED)
    ja, ta = _art_pair()
    for k in np.unique(rng.integers(0, 1 << 48, size=500, dtype=np.uint64)):
        ja.insert(k6(int(k)), int(k))
        ta.insert(k6(int(k)), int(k))
    _same_art(ja, ta)
    assert ta.first() == ja.first() and ta.last() == ja.last()


def test_art_items_from_and_to():
    rng = np.random.default_rng(SEED + 1)
    vals = sorted({int(x) for x in rng.integers(0, 1 << 20, size=300)})
    ja, ta = _art_pair()
    for v in vals:
        ja.insert(k6(v), v)
        ta.insert(k6(v), v)
    for probe in [0, vals[0], vals[10] + 1, vals[-1], vals[-1] + 5]:
        assert list(ta.items_from(k6(probe))) == list(ja.items_from(k6(probe)))
        assert list(ta.items_to(k6(probe))) == list(ja.items_to(k6(probe)))
        assert [v for _, v in ta.items_from(k6(probe))] == [v for v in vals if v >= probe]


def test_art_remove_and_path_compression():
    rng = np.random.default_rng(SEED + 2)
    vals = sorted({int(x) for x in rng.integers(0, 1 << 30, size=400)})
    ja, ta = _art_pair()
    for v in vals:
        ja.insert(k6(v), v)
        ta.insert(k6(v), v)
    for v in vals[::3]:
        assert ta.remove(k6(v)) == ja.remove(k6(v)) is True
        assert ta.remove(k6(v)) == ja.remove(k6(v)) is False
    _same_art(ja, ta)
    for v in vals:
        assert ta.find(k6(v)) == ja.find(k6(v))


def test_art_remove_everything():
    ja, ta = _art_pair()
    for i in range(60):
        ja.insert(k6(i), i)
        ta.insert(k6(i), i)
    for i in range(60):
        assert ta.remove(k6(i)) and ja.remove(k6(i))
    _same_art(ja, ta)
    assert ta.is_empty() and ta.first() is None and ta.last() is None


def test_art_node_downgrade():
    """Past 48 children (table form), then back below the downgrade
    threshold: the same widths, order and lookups as the JAX trie."""
    ja, ta = _art_pair()
    for i in range(256):
        ja.insert(bytes([9, 9, 9, 9, 9, i]), i)
        ta.insert(bytes([9, 9, 9, 9, 9, i]), i)
    _same_art(ja, ta)
    for i in range(0, 256, 2):
        ja.remove(bytes([9, 9, 9, 9, 9, i]))
        ta.remove(bytes([9, 9, 9, 9, 9, i]))
    _same_art(ja, ta)
    assert [v for _, v in ta.items()] == list(range(1, 256, 2))


def test_art_bulk_load_equivalent_to_incremental():
    rng = np.random.default_rng(77)
    keys = sorted({rng.integers(0, 1 << 48).item().to_bytes(6, "big") for _ in range(4000)})
    jb, tb, ti = jart.Art(), tart.Art(), tart.Art()
    jb.bulk_load([(k, i) for i, k in enumerate(keys)])
    tb.bulk_load([(k, i) for i, k in enumerate(keys)])
    for i, k in enumerate(keys):
        ti.insert(k, i)
    _same_art(jb, tb)
    _same_art(jb, ti)
    mid = keys[len(keys) // 2]
    assert list(tb.items_from(mid)) == list(jb.items_from(mid))
    assert list(tb.items_to(mid)) == list(jb.items_to(mid))
    with pytest.raises(ValueError):
        tb.bulk_load([(keys[0], 0)])
    empty = tart.Art()
    empty.bulk_load([])
    assert empty.is_empty()


def test_art_backward_shuttle_streams_in_odepth_memory():
    """Reverse traversal holds O(depth) frames: a tracemalloc bound far
    below what a materialized list would take, in the JAX trie's order."""
    rng = np.random.default_rng(99)
    keys = np.unique(rng.integers(0, 1 << 48, 200_000).astype(np.uint64))
    pairs = [(int(k).to_bytes(6, "big"), i) for i, k in enumerate(keys)]
    ta = tart.Art()
    ta.bulk_load(pairs)
    fwd = list(ta.items())
    assert fwd == pairs
    it = ta.items_reverse()
    assert next(it) == fwd[-1]
    expect = reversed(fwd[:-1])
    tracemalloc.start()
    rest = 0
    for got, want in zip(it, expect):
        assert got == want
        rest += 1
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert rest == len(fwd) - 1
    assert peak < 256 * 1024, f"reverse walk allocated {peak} bytes"


# ---------------------------------------------------------------------------
# the two 64-bit designs against each other and the JAX package
# (tests/test_art.py's TestCrossDesign64 and TestNavigableMapModes)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("design", sorted(DESIGNS))
def test_construction_and_order_stats(design):
    vals = _mixed_values(np.random.default_rng(SEED + 3))
    j, t = _pair(design, vals)
    _same(j, t)
    assert t.first() == j.first() == int(vals[0])
    assert t.last() == j.last() == int(vals[-1])
    for jj in [0, 17, int(vals.size) - 1]:
        assert t.select(jj) == j.select(jj)
    for probe in [int(p) for p in vals[::250]] + [int(vals[0]) + 1, int(vals[-1]) - 1, 0]:
        assert t.rank(probe) == j.rank(probe)
        assert t.contains(probe) == j.contains(probe)
        assert t.next_value(probe) == j.next_value(probe)
        assert t.previous_value(probe) == j.previous_value(probe)


@pytest.mark.parametrize("op", ["or_", "and_", "xor", "andnot"])
def test_algebra_agreement(op):
    rng = np.random.default_rng(SEED + 4)
    a_vals, b_vals = _mixed_values(rng, 2000), _mixed_values(rng, 2000)
    for design in DESIGNS:
        ja, ta = _pair(design, a_vals)
        jb, tb = _pair(design, b_vals)
        j, t = getattr(type(ja), op)(ja, jb), getattr(type(ta), op)(ta, tb)
        _same(j, t)
    a_art, b_art = T.Roaring64Bitmap(a_vals), T.Roaring64Bitmap(b_vals)
    a_nav, b_nav = T.Roaring64NavigableMap(a_vals), T.Roaring64NavigableMap(b_vals)
    assert (getattr(T.Roaring64Bitmap, op)(a_art, b_art).serialize()
            == getattr(T.Roaring64NavigableMap, op)(a_nav, b_nav).serialize())


def test_serialization_interop():
    """The two designs speak the portable spec byte for byte, in both
    packages."""
    vals = _mixed_values(np.random.default_rng(SEED + 5), 1500)
    j_art, t_art = _pair("art", vals)
    j_nav, t_nav = _pair("navigable", vals)
    blob = j_art.serialize()
    assert t_art.serialize() == t_nav.serialize_portable() == j_nav.serialize_portable() == blob
    assert np.array_equal(T.Roaring64NavigableMap.deserialize_portable(blob).to_array(), vals)
    assert np.array_equal(T.Roaring64Bitmap.deserialize(j_nav.serialize_portable()).to_array(), vals)


def test_ranges_and_mutation():
    j_art, t_art = _pair("art", [1, 2, 3])
    j_nav, t_nav = _pair("navigable", [1, 2, 3])
    for bm in (j_art, t_art, j_nav, t_nav):
        bm.add_range(100, 200_000)
        bm.remove_range(150, 400)
        bm.flip_range(190_000, 210_000)
        bm.add((1 << 50) + 7)
        bm.remove(2)
    _same(j_art, t_art)
    _same(j_nav, t_nav)
    assert t_art.run_optimize() == j_art.run_optimize()
    assert t_nav.run_optimize() == j_nav.run_optimize()
    _same(j_art, t_art)
    _same(j_nav, t_nav)


def test_navigable_legacy_round_trip():
    vals = [1, 1 << 33, (1 << 63) + 5, 0xFFFF_FFFF_FFFF_FFFF]
    j, t = _pair("navigable", vals)
    data = t.serialize_legacy()
    assert data == j.serialize_legacy()
    assert data[0] == 0  # unsigned flag
    assert t.serialized_size_in_bytes(mode=0) == len(data)
    assert JNav.deserialize_legacy(data).serialize_legacy() == data
    assert T.Roaring64NavigableMap.deserialize_legacy(j.serialize_legacy()).serialize_legacy() == data


def test_navigable_mode_switch():
    vals = [5, 1 << 40]
    j, t = _pair("navigable", vals)
    try:
        T.Roaring64NavigableMap.SERIALIZATION_MODE = tr64.SERIALIZATION_MODE_LEGACY
        data = t.serialize()
        assert data == j.serialize_legacy()
        assert t.serialized_size_in_bytes() == len(data)
        assert np.array_equal(T.Roaring64NavigableMap.deserialize(data).to_array(), j.to_array())
    finally:
        T.Roaring64NavigableMap.SERIALIZATION_MODE = tr64.SERIALIZATION_MODE_PORTABLE
    assert t.serialize() == t.serialize_portable() == j.serialize_portable()


def test_navigable_signed_ordering():
    vals = [5, (1 << 63) + 1, 10]
    j, t = _pair("navigable", vals, signed_longs=True)
    assert t.first() == j.first() == (1 << 63) + 1
    assert t.last() == j.last() == 10
    assert t.to_array().tolist() == j.to_array().tolist() == [(1 << 63) + 1, 5, 10]
    assert t.select(0) == j.select(0)
    assert t.rank(6) == j.rank(6) == 2
    legacy = t.serialize_legacy()
    assert legacy == j.serialize_legacy() and legacy[0] == 1
    back = T.Roaring64NavigableMap.deserialize_legacy(legacy)
    assert back.signed_longs and np.array_equal(back.to_array(), t.to_array())
    assert t.serialize_portable() == j.serialize_portable()


def test_roaring64art_bulk_ingest_matches_chunked():
    rng = np.random.default_rng(78)
    vals = np.unique(rng.choice(1 << 44, 60_000, replace=True).astype(np.uint64))
    j, a, b = JR64(), T.Roaring64Bitmap(), T.Roaring64Bitmap()
    j.add_many(vals)
    a.add_many(vals)
    for chunk in np.array_split(vals, 5):
        b.add_many(chunk)
    _same(j, a)
    assert a == b and a.serialize() == b.serialize()
    for bm in (j, a):
        bm.add(123456789)
        bm.remove(int(vals[7]))
    _same(j, a)


def test_roaring64art_reverse_iterator_streams():
    rng = np.random.default_rng(7)
    vals = np.unique(rng.integers(0, 1 << 40, 50_000).astype(np.uint64))
    bm = T.Roaring64Bitmap(vals)
    assert list(bm.get_reverse_long_iterator()) == vals[::-1].tolist()
    probe = int(vals[len(vals) // 2])
    assert bm.previous_value(probe) == probe
    assert bm.previous_value(probe - 1) == int(vals[len(vals) // 2 - 1])
    it = bm.get_reverse_long_iterator()
    next(it)
    tracemalloc.start()
    top = list(itertools.islice(it, 10))
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert top == vals[-11:-1][::-1].tolist()
    assert peak < 256 * 1024, f"top-10 reverse peel allocated {peak} bytes"


# ---------------------------------------------------------------------------
# tests/test_roaring64.py's cases, on both designs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("design", sorted(DESIGNS))
def test_point_ops(design):
    j, t = _pair(design, [])
    big = (1 << 63) + 12345
    for bm in (j, t):
        bm.add(0)
        bm.add(big)
        bm.add((1 << 64) - 1)
    _same(j, t)
    assert t.contains(big) and t.contains((1 << 64) - 1) and not t.contains(1)
    for bm in (j, t):
        bm.remove(big)
    _same(j, t)
    for bad in (1 << 64, -1):
        with pytest.raises(ValueError):
            t.add(bad)


@pytest.mark.parametrize("design", sorted(DESIGNS))
def test_add_many_to_array(design):
    vals = random_values64(np.random.default_rng(SEED + 6))
    j, t = _pair(design, vals)
    _same(j, t)
    assert np.array_equal(t.to_array(), np.unique(vals))


@pytest.mark.parametrize("design", sorted(DESIGNS))
def test_algebra_in_place(design):
    rng = np.random.default_rng(SEED + 7)
    v1, v2 = random_values64(rng), random_values64(rng)
    j1, t1 = _pair(design, v1)
    j2, t2 = _pair(design, v2)
    assert t1.intersects(t2) == j1.intersects(j2)
    for op in ("__or__", "__and__", "__xor__", "__sub__"):
        _same(getattr(j1, op)(j2), getattr(t1, op)(t2))
    for op in ("ior", "iand", "ixor", "iandnot"):
        jc, tc = j1.clone(), t1.clone()
        getattr(jc, op)(j2)
        getattr(tc, op)(t2)
        _same(jc, tc)
    _same(j1, t1)  # inputs unchanged by the static ops


@pytest.mark.parametrize("design", sorted(DESIGNS))
def test_rank_select_navigation(design):
    vals = np.unique(random_values64(np.random.default_rng(SEED + 8), 2000))
    j, t = _pair(design, vals)
    for jj in [0, len(vals) // 2, len(vals) - 1]:
        assert t.select(jj) == j.select(jj) == vals[jj]
        assert t.rank(int(vals[jj])) == j.rank(int(vals[jj])) == jj + 1
    mid = int(vals[len(vals) // 2])
    assert t.next_value(mid) == j.next_value(mid) == mid
    assert t.previous_value(mid + 1) == j.previous_value(mid + 1)
    with pytest.raises(IndexError):
        t.select(len(vals))


@pytest.mark.parametrize("design", sorted(DESIGNS))
def test_ranges_across_buckets(design):
    j, t = _pair(design, [])
    start = (1 << 33) - 100
    for bm in (j, t):
        bm.add_range(start, start + 200)  # crosses a high-32 bucket boundary
    _same(j, t)
    assert t.get_cardinality() == 200
    assert t.get_high_to_bitmap_count() == j.get_high_to_bitmap_count() == 2
    for bm in (j, t):
        bm.remove_range(start + 50, start + 150)
    _same(j, t)
    for bm in (j, t):
        bm.flip_range(start, start + 50)
    _same(j, t)
    assert t.get_cardinality() == 50


@pytest.mark.parametrize("design", sorted(DESIGNS))
def test_serialization_roundtrip(design):
    j, t = _pair(design, random_values64(np.random.default_rng(SEED + 9)))
    assert t.run_optimize() == j.run_optimize()
    _same(j, t)
    assert len(t.serialize()) == t.serialized_size_in_bytes() == j.serialized_size_in_bytes()
    back = type(t).deserialize(t.serialize())
    assert back == t and back.serialize() == t.serialize()


def test_golden_file_shapes():
    """The shapes of the CRoaring-written portable files
    (TestRoaring64NavigableMap.java:1644-1731): 10 values in one bucket,
    10 buckets of 10, 11 buckets near the top — the same bytes as the JAX
    package's."""
    cases = {
        "64mapempty": [],
        "64map32bitvals": list(range(10)),
        "64mapspreadvals": [(b << 32) + i for b in range(10) for i in range(10)],
        "64maphighvals": [((MAXINT - b) << 32) + (MAXINT - i) for b in range(11) for i in range(11)],
    }
    for name, vals in cases.items():
        for design in DESIGNS:
            j, t = _pair(design, np.array(vals, dtype=np.uint64))
            _same(j, t)
    t = T.Roaring64Bitmap(np.array(cases["64maphighvals"], dtype=np.uint64))
    assert t.get_cardinality() == 121 and t.get_high_to_bitmap_count() == 11
    assert t.select(0) == ((MAXINT - 10) << 32) + (MAXINT - 10)
    assert t.select(120) == (MAXINT << 32) + MAXINT


@pytest.mark.parametrize("blob", [b"\x00\x00", b"\xff" * 8, b"\x01" + b"\x00" * 7 + b"\x05\x00"])
def test_bad_input_rejected(blob):
    """Both packages refuse the same bytes, the port with its own
    InvalidRoaringFormat."""
    for j_cls, t_cls in DESIGNS.values():
        with pytest.raises(JInvalid):
            j_cls.deserialize(blob)
        with pytest.raises(T.InvalidRoaringFormat):
            t_cls.deserialize(blob)


@pytest.mark.parametrize("design", sorted(DESIGNS))
def test_add_many_rejects_negative(design):
    t = DESIGNS[design][1]()
    with pytest.raises((ValueError, OverflowError)):
        t.add_many(np.array([-1], dtype=np.int64))
    with pytest.raises((ValueError, OverflowError)):
        t.add_many([5, -3])
    assert t.is_empty()


def _agg_inputs(n=12):
    """Bitmaps over several high-48 chunks, three high-32 buckets and a
    chunk at 2^55; plus one high-32 bucket at 2^60 in every other one."""
    rng = np.random.default_rng(29)
    vals = []
    for i in range(n):
        parts = [
            rng.integers(0, 1 << 18, size=4000, dtype=np.uint64),
            (np.uint64(i % 3) << np.uint64(33)) + rng.integers(0, 1 << 17, size=3000, dtype=np.uint64),
            (np.uint64(1) << np.uint64(55)) + rng.integers(0, 1 << 16, size=2000, dtype=np.uint64),
        ]
        if i % 2 == 0:
            parts.append((np.uint64(1) << np.uint64(60)) + rng.integers(0, 1 << 20, size=6000, dtype=np.uint64))
        vals.append(np.concatenate(parts))
    return vals


@pytest.mark.parametrize("mode", ["cpu", "device"])
def test_fast_aggregation64_matches_jax(mode):
    vals = _agg_inputs()
    jb = [JR64(v) for v in vals]
    tb = [T.Roaring64Bitmap(v) for v in vals]
    tb[3].run_optimize()
    jb[3].run_optimize()
    for op in AGG_OPS:
        want = getattr(jagg64.FastAggregation64, op)(*jb, mode=mode)
        got = getattr(T.FastAggregation64, op)(*tb, mode=mode)
        _same(want, got)
        card = getattr(T.FastAggregation64, op.rstrip("_") + "_cardinality")(*tb, mode=mode)
        assert card == want.get_cardinality()
    # both engines agree with the pairwise fold
    fold = tb[0].clone()
    for b in tb[1:]:
        fold = T.Roaring64Bitmap.or_(fold, b)
    assert T.FastAggregation64.or_(tb, mode=mode).serialize() == fold.serialize()
    disjoint = T.Roaring64Bitmap(np.array([(1 << 60) + (1 << 40)], dtype=np.uint64))
    assert T.FastAggregation64.and_(tb[0], disjoint, mode=mode).is_empty()
    assert T.FastAggregation64.and_cardinality(tb[0], disjoint, mode=mode) == 0


def test_fast_aggregation64_edges_and_launches():
    tb = [T.Roaring64Bitmap(v) for v in _agg_inputs(4)]
    assert T.FastAggregation64.or_().is_empty()
    assert T.FastAggregation64.or_cardinality() == 0
    assert T.FastAggregation64.and_(tb[0]).serialize() == tb[0].serialize()
    assert T.FastAggregation64.xor_cardinality(tb[1]) == tb[1].get_cardinality()
    # the device path packs 48-bit keys whole: its groups are the chunks
    groups = tagg64._group_by_key64(tb)
    assert max(groups) >= 1 << 44
    packed = tstore.pack_groups(groups, "cpu")
    assert packed.group_keys.dtype == np.int64
    assert packed.group_keys.tolist() == sorted(groups)
    # auto decides by working-set size only: a small set folds on the CPU
    # even with the device named "cuda" and no card
    aggregation.config.device = "cuda"
    small = [T.Roaring64Bitmap([1, 2]), T.Roaring64Bitmap([2, 3])]
    assert T.FastAggregation64.or_(*small).to_array().tolist() == [1, 2, 3]
    if not torch.cuda.is_available():
        with pytest.raises(TierUnavailable):
            T.FastAggregation64.or_(*small, mode="device")


@pytest.mark.parametrize("mode", ["cpu", "device"])
def test_or_navigable_matches_jax(mode):
    rng = np.random.default_rng(31)
    vals = []
    for i in range(10):
        vals.append(np.concatenate([
            rng.integers(0, 1 << 20, size=5000, dtype=np.uint64),
            (np.uint64(2 + (i % 3)) << np.uint64(32)) + rng.integers(0, 1 << 20, size=4000, dtype=np.uint64),
            (np.uint64(1) << np.uint64(60)) + rng.integers(0, 1 << 18, size=1000, dtype=np.uint64),
        ]))
    jm = [JNav(v) for v in vals]
    tm = [T.Roaring64NavigableMap(v) for v in vals]
    want = jagg64.or_navigable(*jm, mode=mode)
    got = tagg64.or_navigable(*tm, mode=mode)
    _same(want, got)
    assert got.serialize_legacy() == want.serialize_legacy()
    fold = tm[0].clone()
    for m in tm[1:]:
        fold.ior(m)
    assert got.serialize() == fold.serialize()
    assert tagg64.or_navigable().is_empty()
    assert tagg64.or_navigable(tm[0], mode=mode).serialize() == tm[0].serialize()
    a = T.Roaring64NavigableMap([1, (1 << 63) + 5], signed_longs=True)
    b = T.Roaring64NavigableMap([2, (1 << 63) + 7], signed_longs=True)
    sgot = tagg64.or_navigable(a, b, mode=mode)
    swant = jagg64.or_navigable(
        JNav([1, (1 << 63) + 5], signed_longs=True), JNav([2, (1 << 63) + 7], signed_longs=True), mode=mode
    )
    assert sgot.signed_longs and sgot.serialize_legacy() == swant.serialize_legacy()
    assert sgot.first() == swant.first() == (1 << 63) + 5


@pytest.mark.parametrize("design", sorted(DESIGNS))
def test_contains_many(design):
    vals = np.array([1, 2, (1 << 40) + 5, (1 << 63) + 9, (1 << 16) + 1, 1 << 48], dtype=np.uint64)
    j, t = _pair(design, vals)
    probe = np.concatenate([vals, vals + np.uint64(1), np.array([0, 1 << 50], dtype=np.uint64)])
    assert np.array_equal(t.contains_many(probe), j.contains_many(probe))
    assert np.array_equal(t.contains_many(probe), [t.contains(int(p)) for p in probe])
    assert t.contains_many(np.array([], dtype=np.uint64)).size == 0
    assert t.contains_many(np.array([-1], dtype=np.int64))[0] == t.contains((1 << 64) - 1)


def test_stream_serialization_64bit():
    """Back-to-back objects on one stream, the port's bytes equal to the
    JAX package's, each side reading the other's stream."""
    vals = np.array([1, (1 << 40) + 5, (1 << 63) + 9], dtype=np.uint64)
    objs_t = (T.Roaring64Bitmap(vals), T.Roaring64NavigableMap(vals))
    objs_j = (JR64(vals), JNav(vals))
    streams = []
    for (art_, nav), legacy in ((objs_t, tr64.SERIALIZATION_MODE_LEGACY), (objs_j, jr64.SERIALIZATION_MODE_LEGACY)):
        buf = io.BytesIO()
        n = art_.serialize_into(buf) + nav.serialize_into(buf) + nav.serialize_into(buf, mode=legacy)
        assert buf.tell() == n
        streams.append(buf.getvalue())
    assert streams[0] == streams[1]
    for cls_art, cls_nav, legacy in ((T.Roaring64Bitmap, T.Roaring64NavigableMap, tr64.SERIALIZATION_MODE_LEGACY),
                                      (JR64, JNav, jr64.SERIALIZATION_MODE_LEGACY)):
        buf = io.BytesIO(streams[0])
        assert cls_art.deserialize_from(buf).to_array().tolist() == vals.tolist()
        assert cls_nav.deserialize_from(buf).to_array().tolist() == vals.tolist()
        assert cls_nav.deserialize_from(buf, mode=legacy).to_array().tolist() == vals.tolist()
        assert buf.read() == b""


def test_stream_deserialize_survives_short_reads():
    class Dribble(io.RawIOBase):
        def __init__(self, data):
            self._b = io.BytesIO(data)

        def read(self, n=-1):
            return self._b.read(min(n, 1) if n and n > 0 else n)

    vals = np.array([1, (1 << 40) + 5], dtype=np.uint64)
    t = T.Roaring64Bitmap(vals)
    nav = T.Roaring64NavigableMap(vals)
    stream = Dribble(t.serialize() + nav.serialize_legacy())
    assert T.Roaring64Bitmap.deserialize_from(stream) == t
    assert T.Roaring64NavigableMap.deserialize_from(stream, mode=tr64.SERIALIZATION_MODE_LEGACY) == nav


def _order_stat_values(seed):
    rng = np.random.default_rng(seed)
    return rng, np.unique(np.concatenate([
        rng.integers(0, 1 << 20, 8_000, dtype=np.uint64),
        rng.integers(0, 1 << 42, 5_000, dtype=np.uint64),
        np.uint64(1 << 63) + rng.integers(0, 1 << 16, 1_500, dtype=np.uint64),
    ]))


@pytest.mark.parametrize("signed", [False, True])
def test_rank_many_matches_jax(signed):
    rng, vals = _order_stat_values(61)
    probes = np.concatenate([
        vals[::7][:300], rng.integers(0, 1 << 43, 400, dtype=np.uint64),
        np.array([0, (1 << 64) - 1], dtype=np.uint64),
    ])
    jn, tn = _pair("navigable", vals, signed_longs=signed)
    assert np.array_equal(tn.rank_many(probes), jn.rank_many(probes))
    assert tn.rank_many(probes).tolist() == [tn.rank(int(p)) for p in probes]
    ja, ta = _pair("art", vals)
    assert np.array_equal(ta.rank_many(probes), ja.rank_many(probes))
    assert ta.rank_many([]).size == 0
    assert T.Roaring64NavigableMap().rank_many(probes).tolist() == [0] * probes.size


@pytest.mark.parametrize("signed", [False, True])
def test_select_many_matches_jax(signed):
    rng, vals = _order_stat_values(67)
    ranks = np.concatenate([rng.integers(0, vals.size, 500), [0, vals.size - 1]])
    jn, tn = _pair("navigable", vals, signed_longs=signed)
    assert np.array_equal(tn.select_many(ranks), jn.select_many(ranks))
    assert tn.select_many(ranks).tolist() == [tn.select(int(r)) for r in ranks]
    ja, ta = _pair("art", vals)
    assert np.array_equal(ta.select_many(ranks), ja.select_many(ranks))
    assert np.array_equal(ta.rank_many(ta.select_many(ranks)), ranks + 1)
    with pytest.raises(IndexError):
        ta.select_many([vals.size])
    assert ta.select_many([]).size == 0


# ---------------------------------------------------------------------------
# pickling and the facade's long tail (tests/test_pickle.py,
# tests/test_facade_parity.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("design", sorted(DESIGNS))
def test_pickle_64bit(design):
    j, t = _pair(design, np.array([1, 2, 1 << 40, (1 << 63) + 5], dtype=np.uint64))
    back = pickle.loads(pickle.dumps(t))
    assert type(back) is type(t) and back == t
    _same(j, back)


def test_pickle_signed_flag_and_supplier():
    t = T.Roaring64NavigableMap(signed_longs=True)
    t.add(5)
    assert pickle.loads(pickle.dumps(t)).signed_longs is True
    m = T.Roaring64NavigableMap(supplier=T.MutableRoaringBitmap)
    m.add(5)
    back = pickle.loads(pickle.dumps(m))
    assert back.supplier is T.MutableRoaringBitmap
    assert type(back._buckets[0]) is T.MutableRoaringBitmap
    back.add(1 << 40)
    assert type(back._buckets[1 << 8]) is T.MutableRoaringBitmap
    jm = JNav(supplier=JMutable)
    jm.add_many([5, 1 << 40])
    assert back.serialize() == jm.serialize()


@pytest.mark.parametrize("design", sorted(DESIGNS))
def test_public_surface_matches_jax(design):
    """Every public name of the JAX class is on the port's."""
    j_cls, t_cls = DESIGNS[design]
    public = {n for n in dir(j_cls) if not n.startswith("_")}
    assert sorted(public - set(dir(t_cls))) == []


def test_lazy_protocol_iterators_and_limits():
    a = T.Roaring64NavigableMap([1, 1 << 40])
    a.naive_lazy_or(T.Roaring64NavigableMap([2, 1 << 41]))
    a.repair_after_lazy()
    assert a.get_long_cardinality() == 4 and a.contains(1 << 41)
    for j, t in (_pair("navigable", [1, 2, (1 << 40) + 3]),):
        assert list(t.get_reverse_long_iterator()) == list(j.get_reverse_long_iterator())
        assert t.limit(2).serialize() == j.limit(2).serialize()
        for bm in (j, t):
            bm.add_int(0xFFFFFFFF)
        assert t.get_int_cardinality() == j.get_int_cardinality() == 4
    j, t = _pair("art", [5, 70000, (1 << 40) + 9])
    assert list(t.get_long_iterator_from(70000)) == list(j.get_long_iterator_from(70000))
    assert list(t.get_reverse_long_iterator_from(70000)) == [70000, 5]
    flags = []
    t.for_all_in_range(4, 8, lambda p, f: flags.append(f))
    assert flags == [False, True, False, False]
    assert T.Roaring64Bitmap.and_cardinality(t, t) == 3
    assert t.get_size_in_bytes() == j.get_size_in_bytes()
    t.clear()
    assert t.is_empty()


def test_range_validation_and_limit():
    j, t = _pair("art", np.arange(100, 200, dtype=np.uint64))
    with pytest.raises(ValueError):
        t.for_all_in_range(1000, 50, lambda p, f: None)
    with pytest.raises(ValueError):
        t.for_each_in_range(1000, 50, lambda v: None)
    assert t.limit(30).serialize() == j.limit(30).serialize()
    jb, tb = _pair("art", [])
    for bm in (jb, tb):
        bm.add_range(0, 70000)  # spans two containers
    assert tb.limit(65540).serialize() == jb.limit(65540).serialize()
    assert tb.limit(65540).get_cardinality() == 65540


# ---------------------------------------------------------------------------
# the interop bridge for the 64-bit family
# ---------------------------------------------------------------------------


def _jax_containers_state(keys, containers):
    """The interop state dict read out of JAX-package containers."""
    from roaringbitmap_tpu.models.container import BitmapContainer as JBitmap
    from roaringbitmap_tpu.models.container import RunContainer as JRun

    kinds, parts, words = [], [], []
    for c in containers:
        if isinstance(c, JBitmap):
            kinds.append(interop.BITMAP_KIND)
            words.append(np.asarray(c.words, dtype=np.uint64))
            parts.append(np.empty(0, np.uint16))
        elif isinstance(c, JRun):
            kinds.append(interop.RUN_KIND)
            pay = np.empty(2 * len(c.starts), dtype=np.uint16)
            pay[0::2], pay[1::2] = c.starts, c.lengths
            parts.append(pay)
        else:
            kinds.append(interop.ARRAY_KIND)
            parts.append(np.asarray(c.content, dtype=np.uint16))
    return {
        "keys": np.asarray(keys, dtype=np.uint64),
        "kinds": np.asarray(kinds, dtype=np.uint8),
        "offsets": np.concatenate(([0], np.cumsum([p.size for p in parts]))).astype(np.int64),
        "u16_payload": np.concatenate(parts) if parts else np.empty(0, np.uint16),
        "words": np.stack(words) if words else np.empty((0, 1024), np.uint64),
    }


def jax_r64_state(j):
    kv = list(j._kv())
    return _jax_containers_state([int.from_bytes(k, "big") for k, _ in kv], [c for _, c in kv])


def _run_mixed_values(rng):
    vals = _mixed_values(rng, 2000)
    runs = (np.uint64(7) << np.uint64(40)) + np.arange(0, 200_000, dtype=np.uint64)
    dense = (np.uint64(1) << np.uint64(60)) + np.unique(rng.integers(0, 1 << 16, 20_000, dtype=np.uint64))
    return np.unique(np.concatenate([vals, runs, dense]))


def test_r64_state_round_trip_of_jax_bitmaps():
    j = JR64(_run_mixed_values(np.random.default_rng(SEED + 10)))
    j.run_optimize()
    state = jax_r64_state(j)
    assert set(state["kinds"].tolist()) == {0, 1, 2}
    t = interop.r64_from_state(state)
    _same(j, t)
    back = interop.r64_to_state(t)
    assert back.keys() == state.keys()
    for k in state:
        assert back[k].dtype == state[k].dtype and np.array_equal(back[k], state[k])
    bad = dict(state, keys=state["keys"][::-1].copy())
    with pytest.raises(ValueError):
        interop.r64_from_state(bad)


@pytest.mark.parametrize("signed", [False, True])
def test_r64nm_state_round_trip_of_jax_maps(signed):
    j = JNav(_run_mixed_values(np.random.default_rng(SEED + 11)), signed_longs=signed)
    j.run_optimize()
    keys = sorted(j._buckets)
    state = {
        "signed_longs": signed,
        "keys": np.asarray(keys, dtype=np.uint64),
        "buckets": [
            _jax_containers_state(j._buckets[k].high_low_container.keys,
                                  j._buckets[k].high_low_container.containers)
            for k in keys
        ],
    }
    for b in state["buckets"]:
        b["keys"] = b["keys"].astype(np.uint16)
    t = interop.r64nm_from_state(state)
    assert t.signed_longs is signed
    _same(j, t)
    assert t.serialize_legacy() == j.serialize_legacy()
    back = interop.r64nm_to_state(t)
    assert back["signed_longs"] is signed and np.array_equal(back["keys"], state["keys"])
    for got, want in zip(back["buckets"], state["buckets"]):
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
    m = interop.r64nm_from_state(back, supplier=T.MutableRoaringBitmap)
    assert all(type(b) is T.MutableRoaringBitmap for b in m._buckets.values())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("op", AGG_OPS)
def test_cuda_fast_aggregation64_matches_the_cpu_device_path(op):
    """On the card: the 64-bit aggregation through the CUDA kernels equals
    the same device path on CPU tensors (held against the JAX package
    above). Skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    tb = [T.Roaring64Bitmap(v) for v in _agg_inputs()]
    K.reset_launches()
    got = getattr(T.FastAggregation64, op)(*tb, mode="device", device="cuda")
    assert K.LAUNCHES["rb_expand_rows"] > 0 and K.LAUNCHES["rb_popcount_rows"] > 0
    want = getattr(T.FastAggregation64, op)(*tb, mode="device", device="cpu")
    assert got.serialize() == want.serialize()
    card = getattr(T.FastAggregation64, op.rstrip("_") + "_cardinality")(*tb, mode="device", device="cuda")
    assert card == want.get_cardinality()


@pytest.mark.cuda
def test_cuda_or_navigable_matches_the_cpu_device_path():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    tm = [T.Roaring64NavigableMap(v) for v in _agg_inputs()]
    got = tagg64.or_navigable(*tm, mode="device", device="cuda")
    want = tagg64.or_navigable(*tm, mode="device", device="cpu")
    assert got.serialize() == want.serialize()
