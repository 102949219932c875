"""The port's remaining 32-bit facades against the JAX package.

Iterators, writers, the immutable read surface, ``insights``,
``RoaringBitSet`` with the BitSetUtil conversions, ``FastRankRoaringBitmap``
and ``ops/device.py:rank_rows``: the same seeded inputs go through both
packages and every comparison is exact (iterator sequences, serialized
bytes, rank and select, statistics, the recommendation text, words). The
cases mirror the JAX package's ``tests/test_iterators_engines.py``,
``tests/test_writer_immutable_insights.py`` (not its ``tracing`` and
``dispatch_counters`` tests: the port has no ``observe`` registry yet) and
``tests/test_facades.py``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from roaringbitmap_tpu import FastAggregation as JFA
from roaringbitmap_tpu import ImmutableRoaringBitmap as JIRB
from roaringbitmap_tpu import ParallelAggregation as JPA
from roaringbitmap_tpu import RoaringBitmap as JRB
from roaringbitmap_tpu import RoaringBitmapWriter as JWriter
from roaringbitmap_tpu import insights as jinsights
from roaringbitmap_tpu.models import bitset as jbitset
from roaringbitmap_tpu.models.fastrank import FastRankRoaringBitmap as JFast
from roaringbitmap_tpu.ops import device as jdev

from roaringbitmap_tpu_torch import (
    BatchIntIterator,
    FastAggregation,
    FastRankRoaringBitmap,
    ImmutableRoaringBitmap,
    InvalidRoaringFormat,
    ParallelAggregation,
    PeekableIntIterator,
    PeekableIntRankIterator,
    ReverseIntIterator,
    RoaringBatchIterator,
    RoaringBitmap,
    RoaringBitmapWriter,
    RoaringBitSet,
    insights,
)
from roaringbitmap_tpu_torch.models import bitset
from roaringbitmap_tpu_torch.models import writer as twriter
from roaringbitmap_tpu_torch.ops import device as tdev
from roaringbitmap_tpu_torch.parallel import aggregation, store
from roaringbitmap_tpu_torch.utils import bits

REPO = Path(__file__).resolve().parents[1]
SEED = 0xFEEF1F0


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    monkeypatch.setattr(aggregation.config, "device", "cpu")
    store.PACK_CACHE.close()
    yield
    store.PACK_CACHE.close()


def _values(seed):
    """Sparse, run, dense and far-key regions (the JAX test's
    shape-diverse bitmap)."""
    r = np.random.default_rng(seed)
    return np.concatenate([
        r.integers(0, 1 << 16, size=300).astype(np.uint32),
        (1 << 16) + np.arange(50000, dtype=np.uint32),
        (5 << 16) + r.integers(0, 1 << 16, size=9000).astype(np.uint32),
        (1000 << 16) + r.integers(0, 1 << 16, size=77).astype(np.uint32),
        (40000 << 16) + np.arange(0, 3000, 7, dtype=np.uint32),  # above 2^31
    ])


def _pair(seed):
    """(JAX, port heap, port mapped) over the same run-optimized values."""
    j = JRB(_values(seed))
    j.run_optimize()
    blob = j.serialize()
    return j, RoaringBitmap.deserialize(blob), ImmutableRoaringBitmap(blob)


def _ser(bm):
    return bm.serialize()


# ---------------------------------------------------------------------------
# iterators (tests/test_iterators_engines.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("side", ["heap", "mapped"])
def test_peekable_forward_and_advance(side):
    j, t, m = _pair(1)
    bm = t if side == "heap" else m
    it, jt = bm.get_int_iterator(), j.get_int_iterator()
    assert isinstance(it, PeekableIntIterator)
    got, want = [], []
    while jt.has_next():
        assert it.has_next() and it.peek_next() == jt.peek_next()
        got.append(it.next())
        want.append(jt.next())
    assert got == want and not it.has_next()
    arr = j.to_array()
    for target in [0, int(arr[5]), int(arr[arr.size // 2]) - 1, int(arr[-1]), int(arr[-1]) + 1, 1 << 31]:
        it, jt = bm.get_int_iterator(), j.get_int_iterator()
        it.advance_if_needed(target)
        jt.advance_if_needed(target)
        assert it.has_next() == jt.has_next()
        if jt.has_next():
            assert it.next() == jt.next()
    it, jt = bm.get_int_iterator(), j.get_int_iterator()
    for _ in range(10):
        it.next(), jt.next()
    it.advance_if_needed(0)  # backwards: a no-op
    jt.advance_if_needed(0)
    assert it.peek_next() == jt.peek_next()


@pytest.mark.parametrize("side", ["heap", "mapped"])
def test_reverse_signed_and_rank_iterators(side):
    j, t, m = _pair(3)
    bm = t if side == "heap" else m
    rev = bm.get_reverse_int_iterator()
    assert isinstance(rev, ReverseIntIterator)
    assert list(rev) == list(j.get_reverse_int_iterator())
    assert list(bm.get_signed_int_iterator()) == list(j.get_signed_int_iterator())
    it, jt = bm.get_int_rank_iterator(), j.get_int_rank_iterator()
    assert isinstance(it, PeekableIntRankIterator)
    seen = 0
    while jt.has_next() and seen < 2000:
        assert it.peek_next_rank() == jt.peek_next_rank() == seen + 1
        assert it.next() == jt.next()
        seen += 1


@pytest.mark.parametrize("side", ["heap", "mapped"])
@pytest.mark.parametrize("size", [1, 8, 1000])
def test_batch_iterator_and_adapter(side, size):
    j, t, m = _pair(5)
    bm = t if side == "heap" else m
    it, jt = bm.get_batch_iterator(), j.get_batch_iterator()
    assert isinstance(it, RoaringBatchIterator)
    buf, jbuf = np.empty(size, np.uint32), np.empty(size, np.uint32)
    while jt.has_next():
        n, jn = it.next_batch(buf), jt.next_batch(jbuf)
        assert n == jn and np.array_equal(buf[:n], jbuf[:jn])
    assert not it.has_next()
    arr = j.to_array()
    for target in (int(arr[arr.size // 3]), int(arr[7]) + 1, 5 << 16):
        it, jt = bm.get_batch_iterator(), j.get_batch_iterator()
        it.advance_if_needed(target)
        jt.advance_if_needed(target)
        n, jn = it.next_batch(buf), jt.next_batch(jbuf)
        assert n == jn and np.array_equal(buf[:n], jbuf[:jn])
        ad = bm.get_batch_iterator()
        ad.advance_if_needed(target)
        pit = ad.as_int_iterator()
        assert isinstance(pit, BatchIntIterator)
        jad = j.get_batch_iterator()
        jad.advance_if_needed(target)
        assert list(pit)[:50] == list(jad.as_int_iterator())[:50]


def test_iterators_over_empty_and_direct_construction():
    empty = RoaringBitmap()
    assert not empty.get_int_iterator().has_next()
    assert list(empty.get_reverse_int_iterator()) == []
    assert not empty.get_batch_iterator().has_next()
    assert list(empty.get_signed_int_iterator()) == []
    bm = RoaringBitmap([1, 2, 1 << 31, (1 << 32) - 1])
    assert list(PeekableIntIterator(bm)) == [1, 2, 1 << 31, (1 << 32) - 1]
    assert list(bm.get_signed_int_iterator()) == list(JRB([1, 2, 1 << 31, (1 << 32) - 1]).get_signed_int_iterator())
    assert list(BatchIntIterator(RoaringBatchIterator(bm), batch_size=3)) == [1, 2, 1 << 31, (1 << 32) - 1]


class TestEngines:
    """All OR/XOR/AND strategies agree, with the JAX package's bytes."""

    def setup_method(self):
        self.j = [JRB(_values(s)) for s in range(8)] + [JRB()]
        for b in self.j[::2]:
            b.run_optimize()
        self.t = [RoaringBitmap.deserialize(b.serialize()) for b in self.j]

    @pytest.mark.parametrize("engine", ["naive_or", "horizontal_or", "priorityqueue_or"])
    def test_or_strategies_agree(self, engine):
        want = FastAggregation.or_(*self.t, mode="cpu")
        assert getattr(FastAggregation, engine)(*self.t) == want
        assert ParallelAggregation.or_(*self.t, mode="cpu") == want
        assert _ser(getattr(FastAggregation, engine)(*self.t)) == _ser(getattr(JFA, engine)(*self.j))

    @pytest.mark.parametrize("engine", ["naive_xor", "horizontal_xor"])
    def test_xor_strategies_agree(self, engine):
        want = FastAggregation.xor(*self.t, mode="cpu")
        assert getattr(FastAggregation, engine)(*self.t) == want
        assert ParallelAggregation.xor(*self.t, mode="cpu") == want
        assert _ser(getattr(FastAggregation, engine)(*self.t)) == _ser(getattr(JFA, engine)(*self.j))

    @pytest.mark.parametrize("mode", ["cpu", "device"])
    def test_and_strategies_agree(self, mode):
        dense, jdense = self.t[:4], self.j[:4]
        want = FastAggregation.and_(*dense, mode="cpu")
        assert FastAggregation.naive_and(*dense) == want
        assert FastAggregation.workshy_and(*dense, mode=mode) == want
        assert _ser(FastAggregation.workshy_and(*dense, mode=mode)) == _ser(JFA.workshy_and(*jdense, mode=mode))

    def test_empty_and_single(self):
        assert FastAggregation.horizontal_or().is_empty()
        assert FastAggregation.priorityqueue_or().is_empty()
        one = self.t[1]
        assert FastAggregation.priorityqueue_or(one) == one
        assert FastAggregation.priorityqueue_or(one) is not one
        assert FastAggregation.naive_or(one) == one

    def test_cardinality_shortcuts(self):
        assert FastAggregation.or_cardinality(*self.t) == JFA.or_cardinality(*self.j)
        assert FastAggregation.and_cardinality(*self.t[:3]) == JFA.and_cardinality(*self.j[:3])
        assert _ser(ParallelAggregation.or_(*self.t, mode="cpu")) == _ser(JPA.or_(*self.j, mode="cpu"))


# ---------------------------------------------------------------------------
# writers (tests/test_writer_immutable_insights.py)
# ---------------------------------------------------------------------------


def _both(configure):
    """(port writer, JAX writer) built by the same wizard calls."""
    return configure(RoaringBitmapWriter.writer()).get(), configure(JWriter.writer()).get()


WIZARDS = {
    "default": lambda w: w,
    "arrays": lambda w: w.optimise_for_arrays(),
    "runs": lambda w: w.optimise_for_runs(),
    "constant": lambda w: w.constant_memory(),
    "partial": lambda w: w.partially_sort_values(),
    "no-runs": lambda w: w.optimise_for_runs().run_compress(False),
    "expected": lambda w: w.expected_values_per_container(5000).expected_range(0, 1 << 22).initial_capacity(8),
    "density": lambda w: w.expected_density(0.9),
}


@pytest.mark.parametrize("wizard", list(WIZARDS))
def test_writer_streams_match_jax(wizard):
    rng = np.random.default_rng(SEED)
    sorted_vals = np.sort(rng.choice(1 << 22, size=50000, replace=False))
    unsorted = rng.choice(1 << 22, size=20000, replace=False)
    runs = np.arange(100000)
    for feed in (sorted_vals, unsorted, runs):
        w, jw = _both(WIZARDS[wizard])
        w.add_many(feed)
        jw.add_many(feed)
        for v in (5, 4, 70000, 3):
            w.add(v)
            jw.add(v)
        w.add_range(1 << 23, (1 << 23) + 70000)
        jw.add_range(1 << 23, (1 << 23) + 70000)
        assert _ser(w.get()) == _ser(jw.get())


def test_writer_point_adds_flush_and_reset():
    w, jw = _both(WIZARDS["constant"])
    for v in [1, 2, 3, 70000, 70001, 200000]:
        w.add(v)
        jw.add(v)
    assert w.get().to_array().tolist() == [1, 2, 3, 70000, 70001, 200000]
    w, jw = _both(WIZARDS["default"])
    for x in (w, jw):
        x.add(100)
        x.flush()
        x.add(50)
    assert _ser(w.get()) == _ser(jw.get())
    w = RoaringBitmapWriter.writer().get()
    for v in range(5000):
        w.add(v)
    first = w.get()
    assert first.get_cardinality() == 5000
    w.reset()
    w.add(7)
    assert w.get().to_array().tolist() == [7]
    assert first.get_cardinality() == 5000 and first.to_array().size == 5000
    with pytest.raises(ValueError):
        w.add(-1)
    with pytest.raises(ValueError):
        w.add_many([1 << 32])


def test_writer_fast_rank_and_wizard_thresholds():
    w = RoaringBitmapWriter.writer().fast_rank().get()
    w.add_many([10, 20, 30])
    bm = w.get()
    assert isinstance(bm, FastRankRoaringBitmap) and bm.select(1) == 20
    for n in (100, 5000, 1 << 15):
        t, j = RoaringBitmapWriter.writer().expected_values_per_container(n), JWriter.writer().expected_values_per_container(n)
        assert (t._optimise_runs, t._constant_memory) == (j._optimise_runs, j._constant_memory)
    assert twriter.writer().get().get().is_empty()


def test_bitmap_writer_into_an_existing_bitmap():
    """``into=``: emits land through the target's mutators (the native
    tier's word-buffer OR underneath), equal to the JAX package's; an
    immutable target is refused."""
    base = np.arange(0, 300000, 3, dtype=np.uint32)
    t, j = RoaringBitmap(base), JRB(base)
    t.run_optimize()
    j.run_optimize()
    tw = twriter.BitmapWriter(optimise_runs=True, into=t)
    from roaringbitmap_tpu.models.writer import BitmapWriter as JBW

    jw = JBW(optimise_runs=True, into=j)
    extra = np.arange(1, 200000, 5)
    tw.add_many(extra[extra < 65536])
    jw.add_many(extra[extra < 65536])
    tw.add_many(extra)
    jw.add_many(extra)
    assert tw.get() is t and _ser(t) == _ser(jw.get())
    with pytest.raises(ValueError):
        twriter.BitmapWriter(fast_rank=True, into=RoaringBitmap())
    with pytest.raises(TypeError):
        twriter.BitmapWriter(into=ImmutableRoaringBitmap(t.serialize()))


# ---------------------------------------------------------------------------
# the immutable read surface
# ---------------------------------------------------------------------------


@pytest.fixture
def serialized(random_bitmap_factory):
    bm, _ = random_bitmap_factory()
    bm.run_optimize()
    return bm, bm.serialize()


def test_immutable_reads_match_jax(serialized):
    bm, data = serialized
    imm, jimm = ImmutableRoaringBitmap(data), JIRB(data)
    assert imm.get_cardinality() == jimm.get_cardinality() == len(imm)
    assert np.array_equal(imm.to_array(), jimm.to_array())
    arr = bm.to_array()
    for x in [int(arr[0]), int(arr[-1]), int(arr[len(arr) // 2]), int(arr[-1]) + 1, 1 << 33, -1]:
        assert imm.contains(x) == jimm.contains(x) == (x in imm)
        if 0 <= x < 1 << 32:
            assert imm.rank(x) == jimm.rank(x)
    assert imm.first() == jimm.first() and imm.last() == jimm.last()
    for j in (0, 10, len(arr) - 1):
        assert imm.select(j) == jimm.select(j)
    with pytest.raises(IndexError):
        imm.select(-1)
    assert imm == RoaringBitmap.deserialize(data) and imm.serialize() == data
    assert list(imm)[:100] == list(jimm)[:100]
    assert hash(imm) == hash(ImmutableRoaringBitmap(data))
    assert imm.get_container_count() == jimm.get_container_count()
    assert imm.get_size_in_bytes() == jimm.get_size_in_bytes() == len(data)


def test_immutable_to_mutable_and_statics(serialized, tmp_path):
    bm, data = serialized
    imm = ImmutableRoaringBitmap(data)
    mut = imm.to_mutable()
    assert type(mut) is RoaringBitmap and _ser(mut) == data
    mut.add(0) if not mut.contains(0) else mut.remove(0)
    assert ImmutableRoaringBitmap(data).serialize() == data  # the source is unchanged
    assert _ser(imm.to_roaring_bitmap()) == data
    assert ImmutableRoaringBitmap.bitmap_of(5, 1, 70000).to_array().tolist() == [1, 5, 70000]
    assert ImmutableRoaringBitmap.bitmap_of().is_empty() and ImmutableRoaringBitmap.bitmap_of().serialize() == JIRB.bitmap_of().serialize()
    path = tmp_path / "bitmap.bin"
    path.write_bytes(data)
    mapped = ImmutableRoaringBitmap.map_file(str(path))
    assert np.array_equal(mapped.to_array(), JIRB.map_file(str(path)).to_array())
    with pytest.raises(ValueError):
        ImmutableRoaringBitmap.bitmap_of().first()


def test_immutable_rejects_garbage():
    for blob in (b"\xde\xad\xbe\xef" * 4, b"", bytes(3)):
        with pytest.raises(InvalidRoaringFormat):
            ImmutableRoaringBitmap(blob)


def test_immutable_over_a_strided_ndarray_copies_once(serialized):
    _, data = serialized
    doubled = np.frombuffer(bytes(b for pair in zip(data, data) for b in pair), np.uint8)[::2]
    assert not doubled.flags.c_contiguous
    assert ImmutableRoaringBitmap(doubled).serialize() == data
    contiguous = np.frombuffer(data, np.uint8)
    imm = ImmutableRoaringBitmap(contiguous, offset=0)
    assert imm._buf.obj is contiguous.data.obj or np.shares_memory(np.frombuffer(imm._buf, np.uint8), contiguous)


# ---------------------------------------------------------------------------
# insights (analyse, recommend, native_backend)
# ---------------------------------------------------------------------------


def _insight_sets():
    dense, sparse, runs = JRB(), JRB([1, 5, 100]), JRB()
    dense.add_range(0, 300000)
    dense.remove_run_compression()
    runs.add_range(0, 100000)
    runs.run_optimize()
    rng = np.random.default_rng(5)
    many = [JRB(rng.choice(1 << 20, 2000, replace=False).astype(np.uint32)) for _ in range(70)]
    return {
        "mixed": [dense, sparse, runs],
        "dense": [dense],
        "runs": [runs],
        "sparse": [sparse],
        "many": many,
        "empty": [],
        "one": sparse,
    }


@pytest.mark.parametrize("name", list(_insight_sets()))
def test_insights_analyse_and_recommend_match_jax(name):
    j = _insight_sets()[name]
    blobs = [j.serialize()] if isinstance(j, JRB) else [b.serialize() for b in j]
    for t in (
        [RoaringBitmap.deserialize(b) for b in blobs],
        [ImmutableRoaringBitmap(b) for b in blobs],
    ):
        if isinstance(j, JRB):
            t = t[0]
        stats, jstats = insights.analyse(t), jinsights.analyse(j)
        assert stats.bitmaps_count == jstats.bitmaps_count
        assert stats.run_containers_count == jstats.run_containers_count
        assert stats.bitmap_containers_count == jstats.bitmap_containers_count
        assert stats.array_stats.containers_count == jstats.array_stats.containers_count
        assert stats.array_stats.cardinality_sum == jstats.array_stats.cardinality_sum
        assert stats.container_count() == jstats.container_count()
        assert insights.recommend(stats) == jinsights.recommend(jstats)
    if name == "empty":
        assert insights.recommend(stats).startswith("No containers")
        assert np.isnan(stats.array_stats.average_cardinality())


_SERVING_TIER_CHECK = """
import json
from roaringbitmap_tpu import insights as jinsights, native as jnative
from roaringbitmap_tpu_torch import insights, native
native.load()
jnative.available()
tiers = [insights.native_backend(), jinsights.native_backend()]
native.set_tier("numpy")
try:
    tiers.append(insights.native_backend())
finally:
    native.set_tier("native")
tiers.append(insights.native_backend())
print(json.dumps(tiers))
"""


def test_native_backend_names_the_serving_tier():
    """The port's tier is "ext", "numpy" under ``set_tier("numpy")`` and
    "ext" again, and the JAX package's ``native_backend()`` agrees. Both
    tiers are process-wide state, and the JAX package's lazy loaders latch
    a disabled attempt for good (a test that loads it under
    ``ROARINGBITMAP_TPU_NO_NATIVE`` leaves its extension unloaded, so it
    reads "ctypes"), so the claim is checked in a fresh interpreter, where
    no earlier test of the same worker can have moved either."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("ROARINGBITMAP_TPU_NO_NATIVE", "ROARINGBITMAP_TPU_NO_EXT")}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(REPO), env.get("PYTHONPATH")]))
    out = subprocess.run(
        [sys.executable, "-c", _SERVING_TIER_CHECK], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=240,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == ["ext", "ext", "numpy", "ext"]


# ---------------------------------------------------------------------------
# RoaringBitSet, BitSetUtil, FastRankRoaringBitmap (tests/test_facades.py)
# ---------------------------------------------------------------------------


def test_bitset_api_matches_jax():
    bs, jbs = RoaringBitSet(), jbitset.RoaringBitSet()
    for x in (bs, jbs):
        x.set(5)
        x.set(100000)
        x.set(7, False)
    assert bs.get(5) and bs.get(100000) and not bs.get(6)
    assert (bs.cardinality(), bs.length()) == (jbs.cardinality(), jbs.length()) == (2, 100001)
    for x in (bs, jbs):
        x.flip(5)
        x.set_range(10, 20)
    for q in ("next_set_bit", "next_clear_bit", "previous_set_bit", "previous_clear_bit"):
        for at in (0, 10, 15, 19, 20):
            assert getattr(bs, q)(at) == getattr(jbs, q)(at), (q, at)
    for x in (bs, jbs):
        x.clear_range(10, 20)
        x.flip_range(0, 3)
        x.clear(100000)
    assert _ser(bs.bitmap) == _ser(jbs.bitmap) and len(bs) == len(jbs)
    assert bs == RoaringBitSet(RoaringBitmap.deserialize(jbs.bitmap.serialize()))
    import pickle

    assert pickle.loads(pickle.dumps(bs)) == bs
    bs.clear()
    assert bs.is_empty() and bs.length() == 0


def test_bitset_logical_ops_match_jax():
    a, b, ja, jb = RoaringBitSet(), RoaringBitSet(), jbitset.RoaringBitSet(), jbitset.RoaringBitSet()
    for x, y in ((a, b), (ja, jb)):
        x.set_range(0, 100)
        y.set_range(50, 150)
    assert a.intersects(b) == ja.intersects(jb)
    for op in ("and_", "or_", "xor", "and_not", "or_"):
        getattr(a, op)(b)
        getattr(ja, op)(jb)
        assert _ser(a.bitmap) == _ser(ja.bitmap), op


def test_words_roundtrip_matches_jax(rng):
    words = rng.integers(0, 1 << 64, size=3000, dtype=np.uint64)
    bm = bitset.bitmap_of_words(words)
    assert _ser(bm) == _ser(jbitset.bitmap_of_words(words))
    values = np.nonzero(np.unpackbits(words.view(np.uint8), bitorder="little"))[0]
    assert np.array_equal(bm.to_array(), values.astype(np.uint32))
    back = bitset.words_of_bitmap(bm)
    assert np.array_equal(back, jbitset.words_of_bitmap(jbitset.bitmap_of_words(words)))
    assert bitset.words_of_bitmap(RoaringBitmap()).size == 0
    mapped = ImmutableRoaringBitmap(bm.serialize())
    assert np.array_equal(bitset.words_of_bitmap(mapped), back)


def test_fastrank_matches_plain_and_jax(rng):
    vals = rng.integers(0, 1 << 24, size=20000, dtype=np.uint64)
    plain, fast, jfast = RoaringBitmap(vals), FastRankRoaringBitmap(vals), JFast(vals)
    u = np.unique(vals)
    for j in [0, 5000, len(u) - 1]:
        assert fast.select(j) == plain.select(j) == jfast.select(j) == u[j]
        assert fast.rank(int(u[j])) == plain.rank(int(u[j])) == jfast.rank(int(u[j]))
        assert fast.rank_long(int(u[j]) + 1) == jfast.rank_long(int(u[j]) + 1)
    for x in (fast, jfast):
        x.add(int(u[0]) + 1)
        x.remove(int(u[1]))
        x.add_many([3, 4, 1 << 25])
        x.ior(JRB([9]) if x is jfast else RoaringBitmap([9]))
    assert fast.rank(int(u[-1])) == jfast.rank(int(u[-1]))
    assert fast.rank(1 << 25) == fast.get_cardinality()
    fast2 = FastRankRoaringBitmap([1, 2, 3])
    assert fast2.select(2) == 3
    fast2.add_range(10, 20)
    assert fast2.select(12) == 19
    fast2.remove_range(10, 20)
    assert fast2.rank(100) == 3
    for op in ("flip_range", "iand", "ixor", "iandnot"):
        f, p = FastRankRoaringBitmap([1, 2, 3, 70000]), RoaringBitmap([1, 2, 3, 70000])
        f.select(0)
        arg = (0, 2) if op == "flip_range" else (RoaringBitmap([2, 70000, 9]),)
        getattr(f, op)(*arg)
        getattr(p, op)(*arg)
        assert [f.rank(x) for x in (0, 2, 9, 70000)] == [p.rank(x) for x in (0, 2, 9, 70000)]


# ---------------------------------------------------------------------------
# ops/device.py:rank_rows against the JAX function
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sign", ["clear", "set"])
def test_rank_rows_matches_jax(sign):
    rng = np.random.default_rng(45)
    host = rng.integers(0, 1 << 64, size=(8, 1024), dtype=np.uint64)
    high = np.uint64(0x8000_0000_8000_0000)
    host = host | high if sign == "set" else host & ~high  # bit 31 of every u32 word
    host[3] = np.uint64((1 << 64) - 1)
    positions = np.array([0, 31, 32, 65535, 63, 7, 31, 32768], dtype=np.int32)
    got = tdev.rank_rows(tdev.to_device_words(host, "cpu"), torch.from_numpy(positions))
    want = np.asarray(jdev.rank_rows(jnp.asarray(jdev.to_device_words(host)), jnp.asarray(positions)))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    for i in range(8):
        assert int(got[i]) == bits.cardinality_in_range_numpy(host[i], 0, int(positions[i]) + 1)
