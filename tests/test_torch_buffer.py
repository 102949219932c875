"""The port's buffer package against the JAX package: mapped bitmaps.

The same seeded serialized bytes go through both packages: mapped as
``ImmutableRoaringBitmap``s, used as heap ``RoaringBitmap``s, or both mixed.
Every comparison is exact (serialized bytes, cardinalities, booleans). The
JAX side runs as its own tests run it (``mode="device"`` on JAX's CPU
backend); the port's device path runs on CPU tensors
(``aggregation.config.device = "cpu"``), where each kernel wrapper takes its
plain PyTorch version. The cases mirror the JAX package's
``tests/test_buffer.py`` and the ``ImmutableBitSliceIndex`` cases of
``tests/test_bsi64_buffer.py``, then hold what a mapped input changes:
the native entry points on words and values at unaligned addresses, run
containers as strided views, exact container classes, read-only memory,
the pack cache's static fingerprints, no fallback without a card, and
``RangeBitmap``'s zero-copy native-form slices. The ``cuda``-marked test
runs the mapped wide OR on the card.
"""

import mmap
import os
import struct

import numpy as np
import pytest
import torch

from roaringbitmap_tpu import BufferFastAggregation as JBFA
from roaringbitmap_tpu import BufferParallelAggregation as JBPA
from roaringbitmap_tpu import FastAggregation as JFA
from roaringbitmap_tpu import ImmutableRoaringBitmap as JIRB
from roaringbitmap_tpu import MutableRoaringBitmap as JMRB
from roaringbitmap_tpu import RoaringBitmap as JRB
from roaringbitmap_tpu.fuzz import random_bitmap
from roaringbitmap_tpu.models import bsi as jbsi
from roaringbitmap_tpu.models.bsi_buffer import ImmutableBitSliceIndex as JIBSI
from roaringbitmap_tpu.models.bsi_buffer import MutableBitSliceIndex as JMBSI
from roaringbitmap_tpu.parallel import store as jstore

from roaringbitmap_tpu_torch import (
    BufferFastAggregation,
    BufferParallelAggregation,
    FastAggregation,
    ImmutableBitSliceIndex,
    ImmutableRoaringBitmap,
    InvalidRoaringFormat,
    MutableBitSliceIndex,
    MutableRoaringBitmap,
    Operation,
    RangeBitmap,
    RoaringBitmap,
    RoaringBitmapSliceIndex,
)
from roaringbitmap_tpu_torch import native
from roaringbitmap_tpu_torch.columnar import kernels as ck
from roaringbitmap_tpu_torch.models import bsi as tbsi
from roaringbitmap_tpu_torch.models.bsi_buffer import _LazySlices
from roaringbitmap_tpu_torch.models.container import ArrayContainer, BitmapContainer, RunContainer
from roaringbitmap_tpu_torch.models.writer import BitmapWriter
from roaringbitmap_tpu_torch.ops import kernels as K
from roaringbitmap_tpu_torch.parallel import aggregation
from roaringbitmap_tpu_torch.parallel import store
from roaringbitmap_tpu_torch.robust.errors import TierUnavailable
from roaringbitmap_tpu_torch.utils import bits

SEED = 0xB0FF


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    """The port's device path on CPU tensors; no resident pack of one test
    reaches the next."""
    monkeypatch.setattr(aggregation.config, "device", "cpu")
    monkeypatch.setattr(tbsi.config, "device", "cpu")
    store.PACK_CACHE.close()
    yield
    store.PACK_CACHE.close()
    jstore.PACK_CACHE.close()


def _blobs(n=16, seed=SEED):
    """Serialized bytes of seeded shape-diverse bitmaps (the JAX package's
    generator, as its tests use it)."""
    rng = np.random.default_rng(seed)
    return [random_bitmap(rng).serialize() for _ in range(n)]


BLOBS = _blobs()
PAIRS = [(BLOBS[2 * i], BLOBS[2 * i + 1]) for i in range(8)]


def _dense_blobs(n=12, seed=SEED + 1):
    """Bitmaps over the same three keys (so an AND keeps rows), every
    container kind among them."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        vals = np.flatnonzero(rng.random(3 << 16) < (0.97 if i % 3 else 0.04)).astype(np.uint32)
        bm = JRB(vals)
        if i % 2:
            bm.run_optimize()
        out.append(bm.serialize())
    return out


DENSE = _dense_blobs()


def _ser(bm) -> bytes:
    return bm.serialize()


def _sides(blob):
    """(JAX heap, JAX mapped, port heap, port mapped) over one blob."""
    return JRB.deserialize(blob), JIRB(blob), RoaringBitmap.deserialize(blob), ImmutableRoaringBitmap(blob)


# ---------------------------------------------------------------------------
# the mixed-operand pairwise algebra (tests/test_buffer.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["and_", "or_", "xor", "andnot"])
def test_mixed_pairwise_matches_jax(op):
    for a, b in PAIRS:
        ja, jia, ta, tia = _sides(a)
        jb, jib, tb, tib = _sides(b)
        want = _ser(getattr(JMRB, op)(jia, jib))
        assert want == _ser(getattr(JRB, op)(ja, jb))
        for x, y in ((tia, tib), (tia, tb), (ta, tib)):
            got = getattr(MutableRoaringBitmap, op)(x, y)
            assert type(got) is MutableRoaringBitmap
            assert _ser(got) == want
        assert _ser(getattr(ImmutableRoaringBitmap, op)(tia, tb)) == want


@pytest.mark.parametrize(
    "name", ["and_cardinality", "or_cardinality", "xor_cardinality", "andnot_cardinality", "intersects"]
)
def test_mixed_cardinality_variants_and_intersects(name):
    for a, b in PAIRS:
        _, jia, tb_heap, tia = _sides(a)
        jb, _, _, tib = _sides(b)
        want = getattr(JMRB, name)(jia, jb)
        assert getattr(MutableRoaringBitmap, name)(tia, tib) == want
        assert getattr(MutableRoaringBitmap, name)(tia, RoaringBitmap.deserialize(b)) == want
        if hasattr(JIRB, name):
            assert getattr(ImmutableRoaringBitmap, name)(tia, tib) == getattr(JIRB, name)(jia, jb)


def test_or_not_and_flip_statics():
    a, b = PAIRS[0]
    _, jia, _, tia = _sides(a)
    _, jib, _, tib = _sides(b)
    end = (max(JRB.deserialize(a).last(), JRB.deserialize(b).last()) >> 16 << 16) + (1 << 16)
    assert _ser(ImmutableRoaringBitmap.or_not(tia, tib, end)) == _ser(JIRB.or_not(jia, jib, end))
    assert _ser(MutableRoaringBitmap.or_not(tia, tib, end)) == _ser(JMRB.or_not(jia, jib, end))
    assert _ser(ImmutableRoaringBitmap.flip(tia, 5, 70_000)) == _ser(JIRB.flip(jia, 5, 70_000))


# ---------------------------------------------------------------------------
# the N-way engines over mapped and mixed operands
# ---------------------------------------------------------------------------

ENGINES = ["or_", "and_", "xor", "naive_or", "horizontal_or", "priorityqueue_or", "naive_and", "workshy_and"]


@pytest.mark.parametrize("engine", ENGINES)
def test_buffer_fast_aggregation_matches_jax(engine):
    heap_j = [JRB.deserialize(b) for b in BLOBS]
    mapped_j = [JIRB(b) for b in BLOBS]
    want = _ser(getattr(JBFA, engine)(*mapped_j))
    assert want == _ser(getattr(JFA, engine)(*heap_j))
    mapped = [ImmutableRoaringBitmap(b) for b in BLOBS]
    heap = [RoaringBitmap.deserialize(b) for b in BLOBS]
    mixed = [m if i % 2 else h for i, (h, m) in enumerate(zip(heap, mapped))]
    for operands in (mapped, mixed):
        got = getattr(BufferFastAggregation, engine)(*operands)
        assert type(got) is MutableRoaringBitmap
        assert _ser(got) == want
    assert _ser(getattr(FastAggregation, engine)(*heap)) == want


@pytest.mark.parametrize("name", ["or_cardinality", "and_cardinality", "xor_cardinality"])
@pytest.mark.parametrize("mode", ["cpu", "device"])
def test_buffer_cardinality_only_mixed_operands(name, mode):
    rng = np.random.default_rng(53)
    blobs = [
        JRB(np.unique(rng.integers(0, 1 << 20, 4000)).astype(np.uint32)).serialize() for _ in range(6)
    ]
    j_ops = [JIRB(b) for b in blobs[:3]] + [JRB.deserialize(b) for b in blobs[3:]]
    t_ops = [ImmutableRoaringBitmap(b) for b in blobs[:3]] + [RoaringBitmap.deserialize(b) for b in blobs[3:]]
    want = getattr(JBFA, name)(*j_ops, mode=mode)
    assert getattr(BufferFastAggregation, name)(*t_ops, mode=mode) == want
    full = getattr(BufferFastAggregation, name.replace("_cardinality", "" if name.startswith("xor") else "_"))
    assert full(*t_ops).get_cardinality() == want


def test_buffer_fast_aggregation_single_iterable_arg():
    mapped = [ImmutableRoaringBitmap(b) for b in BLOBS[:8]]
    want = _ser(JBFA.or_([JIRB(b) for b in BLOBS[:8]]))
    assert _ser(BufferFastAggregation.or_(mapped)) == want
    # one mapped operand is not iterated as a list of bitmaps
    assert _ser(BufferFastAggregation.or_(mapped[0])) == _ser(JBFA.or_(JIRB(BLOBS[0])))


@pytest.mark.parametrize("op", ["or_", "xor", "and_"])
@pytest.mark.parametrize("mode", ["cpu", "device"])
def test_buffer_parallel_aggregation_matches_jax(op, mode):
    mapped = [ImmutableRoaringBitmap(b) for b in BLOBS]
    want = _ser(getattr(JBPA, op)(*[JIRB(b) for b in BLOBS], mode=mode))
    got = getattr(BufferParallelAggregation, op)(*mapped, mode=mode)
    assert type(got) is MutableRoaringBitmap and _ser(got) == want
    groups = BufferParallelAggregation.group_by_key(*mapped)
    jgroups = JBPA.group_by_key(*[JIRB(b) for b in BLOBS])
    assert sorted(groups) == sorted(jgroups)
    assert {k: len(v) for k, v in groups.items()} == {k: len(v) for k, v in jgroups.items()}


@pytest.mark.parametrize("op", ["or_", "xor", "and_"])
@pytest.mark.parametrize("blobs", ["random", "dense"])
def test_buffer_aggregation_device_mode_on_mapped_rows(op, blobs):
    """The device path packs the mapped containers (the payload borrows
    their views) and reduces them: bytes equal to the JAX package's device
    mode, values equal to the port's CPU fold; the pack cache keys the mapped
    operands by their static fingerprints."""
    blobs = BLOBS if blobs == "random" else DENSE
    mapped = [ImmutableRoaringBitmap(b) for b in blobs]
    if op == "and_" and not store.intersect_keys(mapped):
        assert blobs is BLOBS  # the dense set keeps its three keys
        blobs = DENSE
        mapped = [ImmutableRoaringBitmap(b) for b in blobs]
    want = _ser(getattr(JBFA, op)(*[JIRB(b) for b in blobs], mode="device"))
    before = dict(store.PACK_CACHE.stats()["kinds"].get("agg", {"hits": 0, "misses": 0}))
    got = getattr(BufferFastAggregation, op)(*mapped, mode="device")
    assert _ser(got) == want
    assert got == getattr(FastAggregation, op)(*[RoaringBitmap.deserialize(b) for b in blobs], mode="cpu")
    assert all(m.fingerprint()[0] == "static" for m in mapped)
    agg = store.PACK_CACHE.stats()["kinds"]["agg"]
    assert (agg["hits"] - before["hits"], agg["misses"] - before["misses"]) == (0, 1)


def test_mutable_roundtrip_and_casts():
    a = PAIRS[0][0]
    m = MutableRoaringBitmap.of(RoaringBitmap.deserialize(a))
    jm = JMRB.of(JRB.deserialize(a))
    assert _ser(m) == _ser(jm)
    m.add(123456789)
    jm.add(123456789)
    assert RoaringBitmap.deserialize(a) != m
    imm = m.to_immutable()
    assert type(imm) is ImmutableRoaringBitmap and imm == m
    assert imm.serialize() == m.serialize() == jm.to_immutable().serialize()
    back = MutableRoaringBitmap.deserialize(imm.serialize())
    assert type(back) is MutableRoaringBitmap and back == m
    assert _ser(imm.to_mutable_roaring_bitmap()) == _ser(m)
    assert type(RoaringBitmap.deserialize(a).to_mutable_roaring_bitmap()) is MutableRoaringBitmap
    assert m.get_mappeable_roaring_array() is m.high_low_container


def test_immutable_view_o1_cast():
    a = PAIRS[0][0]
    m = MutableRoaringBitmap.of(RoaringBitmap.deserialize(a))
    v = m.as_immutable_view()
    assert v.get_cardinality() == m.get_cardinality()
    assert v.contains(next(iter(m)))
    for mutator in ("add", "remove", "add_range", "ior", "run_optimize"):
        with pytest.raises(AttributeError):
            getattr(v, mutator)
    m.add(987654321)  # the view is live
    assert v.contains(987654321)
    assert RoaringBitmap.and_(v, m) == m
    assert BufferFastAggregation.or_(v, ImmutableRoaringBitmap(PAIRS[0][1])) == RoaringBitmap.or_(
        m, RoaringBitmap.deserialize(PAIRS[0][1])
    )


def test_mutable_factories_stay_in_buffer_world():
    m = MutableRoaringBitmap.bitmap_of(1, 2, 3)
    jm = JMRB.bitmap_of(1, 2, 3)
    for got, want in (
        (m, jm),
        (m.clone(), jm.clone()),
        (m.limit(2), jm.limit(2)),
        (m.select_range(0, 10), jm.select_range(0, 10)),
        (MutableRoaringBitmap.bitmap_of_range(5, 50), JMRB.bitmap_of_range(5, 50)),
        (MutableRoaringBitmap.flip(m, 0, 10), JMRB.flip(jm, 0, 10)),
        (MutableRoaringBitmap.add_offset(m, 100), JMRB.add_offset(jm, 100)),
    ):
        assert type(got) is MutableRoaringBitmap
        assert got.to_immutable().serialize() == want.to_immutable().serialize()


# ---------------------------------------------------------------------------
# mapped files
# ---------------------------------------------------------------------------


def _write_file(path, blobs, pads=None):
    """Blobs back to back (each after ``pads[i]`` zero bytes); returns the
    (offset, length) of each."""
    extents = []
    with open(path, "wb") as f:
        for i, blob in enumerate(blobs):
            if pads is not None:
                f.write(b"\0" * pads[i])
            extents.append((f.tell(), len(blob)))
            f.write(blob)
    return extents


def _map(path):
    with open(path, "rb") as f:
        return mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)


def test_mapped_file_algebra(tmp_path):
    a, b = PAIRS[0]
    pa, pb = tmp_path / "a.bin", tmp_path / "b.bin"
    pa.write_bytes(a)
    pb.write_bytes(b)
    ma = ImmutableRoaringBitmap.map_file(str(pa))
    mb = ImmutableRoaringBitmap.map_file(str(pb))
    assert _ser(MutableRoaringBitmap.or_(ma, mb)) == _ser(JRB.or_(JIRB.map_file(str(pa)), JIRB.map_file(str(pb))))
    assert ma.clone() == RoaringBitmap.deserialize(a) and type(ma.clone()) is RoaringBitmap
    assert ma.get_size_in_bytes() == os.path.getsize(pa)
    assert ma.serialize() == a


@pytest.mark.parametrize("source", ["mmap", "memmap", "ndarray", "bytearray", "memoryview"])
def test_memory_mapped_file_on_disk(tmp_path, source):
    """Many bitmaps serialized into one file, mapped read-only and viewed in
    place through every source kind: each view's bytes, cardinality, first
    value and rank equal the JAX package's, and the wide OR over the views
    equals the naive fold."""
    path = tmp_path / "bitmaps.bin"
    extents = _write_file(path, BLOBS)
    if source == "mmap":
        buf = memoryview(_map(path))
    elif source == "memmap":
        buf = np.memmap(path, dtype=np.uint8, mode="r")
    elif source == "ndarray":
        buf = np.frombuffer(path.read_bytes(), dtype=np.uint8)
    elif source == "bytearray":
        buf = bytearray(path.read_bytes())
    else:
        buf = memoryview(path.read_bytes())
    mapped = [ImmutableRoaringBitmap(buf[o : o + n]) for o, n in extents]
    for blob, m in zip(BLOBS, mapped):
        j = JIRB(blob)
        assert m.serialize() == blob
        assert m.get_cardinality() == j.get_cardinality()
        v = j.first()
        assert m.contains(v) and m.rank_long(v) == j.rank_long(v) and m.first() == v
    assert _ser(BufferFastAggregation.or_(*mapped, mode="device")) == _ser(
        JFA.naive_or(*[JRB.deserialize(b) for b in BLOBS])
    )


def test_mapped_run_views_zero_copy(tmp_path):
    """A mapped run-heavy bitmap answers and/contains/rank off its (start,
    length) views, which share the mapping's memory, and equals the JAX
    package's answers."""
    vals = np.concatenate([np.arange(s, s + 900, dtype=np.uint32) for s in range(0, 3_000_000, 1000)])
    rb = JRB(vals)
    rb.run_optimize()
    other = JRB(np.concatenate([np.arange(s, s + 500, dtype=np.uint32) for s in range(400, 3_000_000, 1000)]))
    other.run_optimize()
    path = tmp_path / "runs.bin"
    path.write_bytes(rb.serialize())
    imm = ImmutableRoaringBitmap.map_file(str(path))
    buf = np.frombuffer(imm._buf, dtype=np.uint8)
    for c in imm.high_low_container.containers:
        assert type(c) is RunContainer
        assert np.shares_memory(c.starts, buf) and np.shares_memory(c.lengths, buf)
        assert not c.starts.flags.c_contiguous  # the strided pairs[0::2] view
    tother = RoaringBitmap.deserialize(other.serialize())
    assert _ser(RoaringBitmap.and_(imm, tother)) == _ser(JRB.and_(rb, other))
    probe = [int(v) for v in vals[:: len(vals) // 97]]
    assert all(imm.contains(p) for p in probe)
    assert [imm.rank(p) for p in probe] == [rb.rank(p) for p in probe]


def test_mapped_bulk_probes_match_jax():
    rng = np.random.default_rng(41)
    vals = np.unique(rng.choice(1 << 22, 50_000, replace=False)).astype(np.uint32)
    heap = JRB(vals)
    heap.run_optimize()
    blob = heap.serialize()
    imm, jimm = ImmutableRoaringBitmap(blob), JIRB(blob)
    probes = rng.choice(1 << 23, 2000).astype(np.uint32)
    assert np.array_equal(imm.contains_many(probes), jimm.contains_many(probes))
    assert np.array_equal(imm.rank_many(probes), jimm.rank_many(probes))
    ranks = rng.integers(0, vals.size, 2000)
    assert np.array_equal(imm.select_many(ranks), jimm.select_many(ranks))


@pytest.mark.parametrize("name", [
    "next_value", "previous_value", "next_absent_value", "previous_absent_value", "first_signed",
    "last_signed", "range_cardinality", "contains_range", "intersects_range", "has_run_compression",
    "limit", "select_range", "iterators",
])
def test_delegated_reads_match_jax(name):
    blob = BLOBS[3]
    t, j = ImmutableRoaringBitmap(blob), JIRB(blob)
    x = j.first() + 7
    if name in ("next_value", "previous_value", "next_absent_value", "previous_absent_value"):
        assert getattr(t, name)(x) == getattr(j, name)(x)
    elif name in ("first_signed", "last_signed", "has_run_compression"):
        assert getattr(t, name)() == getattr(j, name)()
    elif name in ("range_cardinality", "contains_range", "intersects_range"):
        assert getattr(t, name)(x, x + 70_000) == getattr(j, name)(x, x + 70_000)
    elif name == "limit":
        assert _ser(t.limit(1000)) == _ser(j.limit(1000))
    elif name == "select_range":
        assert _ser(t.select_range(10, 5000)) == _ser(j.select_range(10, 5000))
    else:
        assert list(t.get_reverse_int_iterator()) == list(j.get_reverse_int_iterator())
        assert list(t.get_signed_int_iterator()) == list(j.get_signed_int_iterator())
        it, jt = t.get_int_iterator(), j.get_int_iterator()
        it.advance_if_needed(x)
        jt.advance_if_needed(x)
        assert it.next() == jt.next()


def test_mutators_and_unknown_names_refused():
    t = ImmutableRoaringBitmap(BLOBS[0])
    for name in ("add", "remove", "add_range", "ior", "run_optimize", "flip_range"):
        with pytest.raises(AttributeError, match="immutable"):
            getattr(t, name)
    with pytest.raises(AttributeError):
        t.no_such_name
    with pytest.raises(AttributeError):
        t.anything = 1  # __slots__: no attribute assignment either


@pytest.mark.parametrize("blob", [b"\xde\xad\xbe\xef" * 4, b"\x01", BLOBS[0][:7]])
def test_immutable_rejects_garbage(blob):
    with pytest.raises(InvalidRoaringFormat):
        ImmutableRoaringBitmap(blob)


def test_immutable_rejects_hostile_run_payload():
    from roaringbitmap_tpu_torch.serialization import SERIAL_COOKIE

    buf = struct.pack("<I", SERIAL_COOKIE) + bytes([1]) + struct.pack("<HH", 0, 1)
    buf += struct.pack("<H", 1) + struct.pack("<HH", 0xFFFF, 0xFFFF)
    imm = ImmutableRoaringBitmap(buf)
    with pytest.raises(InvalidRoaringFormat):
        imm.high_low_container.get_container_at_index(0)
    with pytest.raises(InvalidRoaringFormat):
        RoaringBitmap.deserialize(buf)


def test_pickle_of_a_mapped_bitmap_is_its_bytes(tmp_path):
    import pickle

    path = tmp_path / "a.bin"
    path.write_bytes(BLOBS[5])
    back = pickle.loads(pickle.dumps(ImmutableRoaringBitmap.map_file(str(path))))
    assert type(back) is ImmutableRoaringBitmap and back.serialize() == BLOBS[5]


# ---------------------------------------------------------------------------
# what a mapped input changes: alignment, strides, classes, read-only
# memory, pack-cache identity, no fallback
# ---------------------------------------------------------------------------


def _unaligned_views(tmp_path):
    """A mapped file whose bitmap containers start at every even address
    residue mod 8, and array containers at odd addresses: blobs of an
    array container of 1..4 values then a bitmap container, each after 0..7
    pad bytes. Returns ``{residue: words view}`` and odd-address values."""
    blobs = []
    for card in (1, 2, 3, 4):
        vals = np.concatenate([
            np.arange(card, dtype=np.uint32) * 7,
            (1 << 16) + np.arange(0, 60_000, 3, dtype=np.uint32),
        ])
        blobs.append(JRB(vals).serialize())
    blobs = [b for b in blobs for _ in range(8)]
    pads = [i % 8 for i in range(len(blobs))]
    path = tmp_path / "unaligned.bin"
    extents = _write_file(path, blobs, pads)
    mm = memoryview(_map(path))
    words, odd_vals = {}, None
    for o, n in extents:
        bm = ImmutableRoaringBitmap(mm[o : o + n])
        arr, bmp = bm.high_low_container.containers
        assert type(arr) is ArrayContainer and type(bmp) is BitmapContainer
        words.setdefault(bmp.words.ctypes.data % 8, bmp.words)
        if arr.content.ctypes.data % 2:
            odd_vals = arr.content
    # a long array container at an odd address
    big = JRB((2 << 16) + np.sort(np.random.default_rng(7).choice(1 << 16, 3000, replace=False)).astype(np.uint32))
    path2 = tmp_path / "odd.bin"
    (o2, n2), = _write_file(path2, [big.serialize()], [1])
    values = ImmutableRoaringBitmap(memoryview(_map(path2))[o2 : o2 + n2]).high_low_container.containers[0].content
    return words, odd_vals, values


def test_native_entry_points_exact_on_unaligned_mapped_words(tmp_path):
    """Every native entry point, on each binding that serves it, on words
    and values viewed at unaligned addresses of a read-only mapping: equal
    to its numpy version (and to the same call on an aligned copy)."""
    words_at, small, values = _unaligned_views(tmp_path)
    assert {2, 4, 6} <= set(words_at), sorted(words_at)
    assert values.ctypes.data % 2 == 1 and not values.flags.aligned and not values.flags.writeable
    assert small is not None and small.ctypes.data % 2 == 1
    native.load()
    _, ext = native.load()
    half = values[: values.size // 2]
    other = values[values.size // 3 :]
    for residue in (2, 4, 6):
        w = words_at[residue]
        assert w.ctypes.data % 8 == residue and not w.flags.aligned and not w.flags.writeable
        wc = w.copy()
        for name, args, plain in (
            ("cardinality_of_words", (w,), bits.cardinality_of_words_numpy),
            ("values_from_words", (w,), bits.values_from_words_numpy),
            ("num_runs_in_words", (w,), bits.num_runs_in_words_numpy),
            ("select_in_words", (w, 1000), bits.select_in_words_numpy),
            ("cardinality_in_range", (w, 3, 50_001), bits.cardinality_in_range_numpy),
            ("words_from_values", (values,), lambda v: bits.words_from_values_numpy(v)),
            ("intersect_sorted", (half, other), bits.intersect_sorted_numpy),
            ("merge_sorted_unique", (half, other), bits.merge_sorted_unique_numpy),
            ("difference_sorted", (half, other), bits.difference_sorted_numpy),
            ("xor_sorted", (half, other), bits.xor_sorted_numpy),
            ("intersect_cardinality", (half, other), lambda a, b: bits.intersect_sorted_numpy(a, b).size),
            ("contains_many", (values, small), lambda a, q: np.isin(q, a)),
            ("advance_until", (values, 5, int(values[700])), lambda a, p, x: int(np.searchsorted(a[p + 1 :], x)) + p + 1),
        ):
            want = plain(*args)
            fns = [native.EXT[name], native.CTYPES[name]]
            for fn in fns:
                got = fn(*args)
                assert np.array_equal(np.asarray(got), np.asarray(want)), (name, residue, fn)
                copies = [a.copy() if isinstance(a, np.ndarray) else a for a in args]
                assert np.array_equal(np.asarray(fn(*copies)), np.asarray(got)), (name, residue)
        # the extension-only entry points and the containers' scalar probes
        assert native.EXT["lower_bound"](values, int(values[10])) == 10
        assert native.EXT["validate_sorted_u16"](values) and bits.validate_sorted_u16_numpy(values)
        assert native.EXT["validate_runs_u16"](np.ascontiguousarray(small)) == bits.validate_runs_u16_numpy(small)
        for x in (0, 63, 64, 65535, int(values[3]) & 0xFFFF):
            assert ext.word_bit(w, x) == bits.get_bit(wc, x)
            assert ext.contains_u16(values, x) == bool(np.isin(x, values))
        starts, lengths = values[:40], np.zeros(40, np.uint16)
        assert ext.run_contains(starts, np.ascontiguousarray(lengths), int(values[9])) is True
        # the ctypes-only entry points
        acc = bits.words_from_values_numpy(np.array([1, 64], np.uint16))
        assert np.array_equal(native.or_values_into_words(acc.copy(), values),
                              bits.or_values_into_words_numpy(acc.copy(), values))
        assert [np.array_equal(a, b) for a, b in zip(native.runs_from_values(values), bits.runs_from_values_numpy(values))] == [True, True]
        assert native.num_runs_in_values(values) == bits.runs_from_values_numpy(values)[0].size
        rows = np.stack([wc, wc ^ np.uint64(0xFF)])
        rows_view = np.frombuffer(
            bytes(residue) + rows.tobytes(), dtype=np.uint64, count=rows.size, offset=residue
        ).reshape(rows.shape)
        assert not rows_view.flags.aligned
        for op, fold in (("or", np.bitwise_or), ("and", np.bitwise_and), ("xor", np.bitwise_xor)):
            out, card = native.wide_op_words(rows_view, op)
            assert np.array_equal(out, fold.reduce(rows, axis=0)) and card == int(bits.popcount64(out).sum())
        assert np.array_equal(native.popcount_rows(rows_view), ck.popcount_rows_numpy(rows))
        offs = np.array([0, half.size, values.size], np.int64)
        boffs = np.array([0, other.size // 2, other.size], np.int64)
        for op in ("and", "or", "xor", "andnot"):
            vals, st, cnt = ck.batch_pairwise_numpy(values, offs, other, boffs, op)
            alen, blen = np.diff(offs), np.diff(boffs)
            bound = {"and": np.minimum(alen, blen), "andnot": alen}.get(op, alen + blen)
            oo = np.concatenate(([0], np.cumsum(bound)))
            out, counts = native.batch_pairwise_u16(values, offs, other, boffs, op, oo[:-1], int(oo[-1]))
            assert np.array_equal(counts, cnt)
            for j in range(2):
                assert np.array_equal(out[oo[j] : oo[j] + cnt[j]], vals[st[j] : st[j] + cnt[j]])
        assert np.array_equal(native.batch_intersect_card_u16(values, offs, other, boffs),
                              ck.batch_and_cardinality_numpy(values, offs, other, boffs))
        z = np.zeros(values.size, np.uint16)
        zo = np.zeros(other.size, np.uint16)
        _, _, _, cards = native.batch_run_pairwise(values, z, offs, other, zo, boffs, "and", None, 0)
        assert np.array_equal(cards, ck.batch_and_cardinality_numpy(values, offs, other, boffs))
        target = np.zeros((2, 1024), np.uint64)
        native.pack_array_rows(np.array([0, 1]), offs, values, target)
        want = np.zeros((2, 1024), np.uint64)
        ck.scatter_values_rows_numpy(np.array([0, 1]), offs, values, want, "or")
        assert np.array_equal(target, want)
        target[:] = 0
        native.scatter_values_rows(np.array([1, 1]), offs, values, target, "xor")
        want[:] = 0
        ck.scatter_values_rows_numpy(np.array([1, 1]), offs, values, want, "xor")
        assert np.array_equal(target, want)


def test_native_refuses_read_only_and_unaligned_outputs():
    ro = np.frombuffer(bytes(8192), dtype=np.uint64)
    with pytest.raises(ValueError, match="read-only"):
        native.or_values_into_words(ro, np.array([1, 2], np.uint16))
    with pytest.raises(ValueError, match="read-only"):
        bits.or_values_into_words_numpy(ro, np.array([1, 2], np.uint16))
    assert not ro.any()  # ufunc.at would have written through the flag
    target = np.frombuffer(bytes(8192), dtype=np.uint64).reshape(1, 1024)
    for fn in (native.scatter_values_rows, ck.scatter_values_rows_numpy):
        with pytest.raises(ValueError):
            fn(np.array([0]), np.array([0, 1]), np.array([5], np.uint16), target, "or")
    for fn in (native.fill_intervals_rows, ck.fill_intervals_rows_numpy):
        with pytest.raises(ValueError):
            fn(np.array([0]), np.array([0, 1]), np.array([5]), np.array([9]), target, "or")
    assert not target.any()
    raw = bytearray(8192 + 8)
    unaligned = np.frombuffer(raw, dtype=np.uint64, count=1024, offset=4)
    assert not unaligned.flags.aligned and unaligned.flags.writeable
    native.or_values_into_words(unaligned, np.array([1, 64], np.uint16))
    assert unaligned[0] == 2 and unaligned[1] == 1
    with pytest.raises(ValueError, match="aligned"):
        native.scatter_values_rows(np.array([0]), np.array([0, 1]), np.array([5], np.uint16), unaligned, "or")


def test_mapped_views_are_the_ports_exact_container_classes():
    """The pack dispatches on exact classes (``RowPayload.append``): every
    mapped view is the port's own ArrayContainer / BitmapContainer /
    RunContainer, and a payload of them materializes to the heap
    payload's arrays."""
    kinds = set()
    for blob in BLOBS:
        m, h = ImmutableRoaringBitmap(blob), RoaringBitmap.deserialize(blob)
        pm = store.RowPayload.from_containers(list(m.high_low_container.containers))
        ph = store.RowPayload.from_containers(list(h.high_low_container.containers))
        for c in m.high_low_container.containers:
            assert type(c) in (ArrayContainer, BitmapContainer, RunContainer)
            kinds.add(type(c))
        for a, b in zip(pm.materialize(), ph.materialize()):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert np.array_equal(pm.expand_host(), ph.expand_host())
    assert kinds == {ArrayContainer, BitmapContainer, RunContainer}


def test_strided_run_views_reach_native_and_tensors_contiguous(tmp_path):
    """Run containers of a mapped bitmap are strided views; every path that
    hands them on makes them contiguous first: the payload, the host and
    device expansions, the words of the BSI and query packs, the columnar
    engine and the CPU folds all equal the heap path's."""
    rng = np.random.default_rng(11)
    vals = np.unique(np.concatenate([
        (k << 16) + np.arange(s, s + int(rng.integers(1, 300)))
        for k in range(6) for s in rng.choice(60_000, 40, replace=False)
    ])).astype(np.uint32)
    heap = RoaringBitmap(vals)
    heap.run_optimize()
    blob = heap.serialize()
    path = tmp_path / "runs.bin"
    path.write_bytes(blob)
    m = ImmutableRoaringBitmap.map_file(str(path))
    runs = list(m.high_low_container.containers)
    assert all(type(c) is RunContainer and not c.starts.flags.c_contiguous for c in runs)
    p = store.RowPayload.from_containers(runs)
    mat = p.materialize()
    assert all(a.flags.c_contiguous for a in mat)
    want = store.RowPayload.from_containers(list(heap.high_low_container.containers))
    assert np.array_equal(p.expand_host(), want.expand_host())
    dev = p.expand_device("cpu")
    assert torch.equal(dev, want.expand_device("cpu"))
    for c, h in zip(runs, heap.high_low_container.containers):
        assert np.array_equal(store.container_words(c), store.container_words(h))
    other = RoaringBitmap(vals[::3])
    for op in ("and_", "or_", "xor", "andnot"):
        assert _ser(getattr(RoaringBitmap, op)(m, other)) == _ser(getattr(RoaringBitmap, op)(heap, other))
    from roaringbitmap_tpu_torch import columnar

    for op in ("and", "or", "xor", "andnot"):
        got = columnar.pairwise_multi(op, [(m, other)] * 3, tier="device")
        want_op = columnar.pairwise_multi(op, [(heap, other)], tier="device")[0]
        assert all(_ser(g) == _ser(want_op) for g in got)
        assert want_op == getattr(RoaringBitmap, op + ("_" if op in ("and", "or") else ""))(heap, other)
    ops = [m, ImmutableRoaringBitmap(other.serialize()), heap]
    for op in ("or_", "xor", "and_"):
        want_op = _ser(getattr(FastAggregation, op)(*[RoaringBitmap.deserialize(o.serialize()) for o in ops], mode="cpu"))
        for mode in ("cpu", "device"):
            assert _ser(getattr(BufferFastAggregation, op)(*ops, mode=mode)) == want_op


def test_mapped_aggregation_leaves_the_mapping_untouched(tmp_path):
    """No path writes into a mapped view: aggregation, pairwise algebra and
    the device path over a writable mapping leave its bytes as they were,
    a writer refuses a mapped target, and a mapped bitmap's words are not
    writable through a read-only map."""
    raw = bytearray(b"".join(BLOBS))
    before = bytes(raw)
    offs = np.cumsum([0] + [len(b) for b in BLOBS])
    mapped = [ImmutableRoaringBitmap(memoryview(raw)[offs[i] : offs[i + 1]]) for i in range(len(BLOBS))]
    for op in ("or_", "xor", "and_"):
        for mode in ("cpu", "device"):
            getattr(BufferFastAggregation, op)(*mapped, mode=mode)
    for engine in ("naive_or", "horizontal_or", "priorityqueue_or", "naive_and"):
        getattr(BufferFastAggregation, engine)(*mapped)
    FastAggregation.naive_xor(*mapped)
    for a, b in zip(mapped[::2], mapped[1::2]):
        for op in ("and_", "or_", "xor", "andnot"):
            getattr(RoaringBitmap, op)(a, b)
        m = MutableRoaringBitmap.of(a)
        m.ior(b)
        m.add(5)
    assert bytes(raw) == before
    for target in (mapped[0], MutableRoaringBitmap.of(mapped[0]).as_immutable_view()):
        with pytest.raises(TypeError):
            BitmapWriter(into=target)
    dense = next(b for b in BLOBS if any(type(c) is BitmapContainer for c in ImmutableRoaringBitmap(b).high_low_container.containers))
    ro = ImmutableRoaringBitmap(dense)
    c = next(c for c in ro.high_low_container.containers if type(c) is BitmapContainer)
    with pytest.raises(ValueError):
        c.words[0] = 1


def test_pack_cache_hits_a_mapped_working_set_and_misses_a_new_mapping(tmp_path):
    path = tmp_path / "set.bin"
    extents = _write_file(path, BLOBS)

    def open_set():
        mm = memoryview(_map(path))
        return [ImmutableRoaringBitmap(mm[o : o + n]) for o, n in extents]

    mapped = open_set()
    want = _ser(FastAggregation.or_(*[RoaringBitmap.deserialize(b) for b in BLOBS], mode="device"))
    store.PACK_CACHE.close()

    def agg_delta(before):
        now = store.PACK_CACHE.stats()["kinds"]["agg"]
        return now["hits"] - before["hits"], now["misses"] - before["misses"]

    base = dict(store.PACK_CACHE.stats()["kinds"]["agg"])
    assert _ser(BufferFastAggregation.or_(*mapped, mode="device")) == want
    assert agg_delta(base) == (0, 1)
    fps = [m.fingerprint() for m in mapped]
    assert fps == [("static", id(m.high_low_container)) for m in mapped]
    assert all(m.high_low_container is m.high_low_container for m in mapped)
    for _ in range(2):
        assert _ser(BufferFastAggregation.or_(*mapped, mode="device")) == want
    assert BufferFastAggregation.or_cardinality(*mapped, mode="device") == RoaringBitmap.deserialize(want).get_cardinality()
    assert agg_delta(base) == (3, 1)
    # the entry holds the mapped arrays, so their ids cannot be recycled
    entry = next(iter(store.PACK_CACHE._entries.values()))
    assert {id(r) for r in entry.refs} == {id(m.high_low_container) for m in mapped}
    del mapped, entry
    remapped = open_set()
    assert _ser(BufferFastAggregation.or_(*remapped, mode="device")) == want
    assert agg_delta(base) == (3, 2)


def test_mapped_input_without_a_card_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.setattr(aggregation.config, "device", "cuda")  # as shipped
    mapped = [ImmutableRoaringBitmap(b) for b in BLOBS]
    for call in (
        lambda: BufferFastAggregation.or_(*mapped, mode="device"),
        lambda: BufferFastAggregation.or_cardinality(*mapped, mode="device"),
        lambda: BufferParallelAggregation.or_(*mapped, mode="device"),
    ):
        with pytest.raises(TierUnavailable):
            call()
    # the CPU fold is the caller's explicit choice, never a fallback
    assert BufferFastAggregation.or_(*mapped, mode="cpu") == FastAggregation.naive_or(*mapped)


# ---------------------------------------------------------------------------
# the mapped BSI (tests/test_bsi64_buffer.py's ImmutableBitSliceIndex cases)
# ---------------------------------------------------------------------------


def _bsi_blob(seed=5, n=200_000, bits_=20):
    rng = np.random.default_rng(seed)
    cols = np.arange(n, dtype=np.uint32)
    vals = rng.integers(0, 1 << bits_, size=cols.size).astype(np.int64)
    j = jbsi.RoaringBitmapSliceIndex()
    j.set_values((cols, vals))
    return j.serialize(), vals


def test_immutable_bsi_maps_lazily_zero_copy():
    data, vals = _bsi_blob()
    imm, jimm = ImmutableBitSliceIndex(data), JIBSI(data)
    lazy = imm._base.slices
    assert isinstance(lazy, _LazySlices) and not lazy._cache
    assert not hasattr(lazy, "append")
    med = int(np.median(vals))
    for mode in ("cpu", "device"):
        assert _ser(imm.compare(Operation.GE, med, 0, None, mode=mode)) == _ser(
            jimm.compare(jbsi.Operation.GE, med, 0, None, mode=mode)
        )
    assert imm.get_cardinality() == jimm.get_cardinality()
    assert imm.serialize() == data
    assert imm == RoaringBitmapSliceIndex.deserialize(data)
    for mutator in ("set_value", "set_values", "add", "merge", "run_optimize", "add_digit"):
        with pytest.raises(TypeError):
            getattr(imm, mutator)(1, 2)
    mut = imm.to_mutable_bit_slice_index()
    assert type(mut) is MutableBitSliceIndex
    mut.set_value(0, 123)
    assert imm.get_value(0) == jimm.get_value(0)
    assert imm.serialize() == data


def test_mapped_bsi_reaches_the_bsi_pack_and_the_oneil_kernels():
    """The lazy slices pack like heap slices (kind ``bsi``), keyed by their
    static fingerprints: the second query is a hit, and every answer
    equals the heap index's, through the plain versions of
    ``rb_oneil_compare`` and ``rb_oneil_counts``."""
    data, vals = _bsi_blob(seed=9, n=150_000, bits_=18)
    imm = ImmutableBitSliceIndex(memoryview(bytearray(data)))
    heap = RoaringBitmapSliceIndex.deserialize(data)
    med = int(np.median(vals))
    qs = np.quantile(vals, np.linspace(0.05, 0.95, 9)).astype(np.int64)
    store.PACK_CACHE.close()
    before = dict(store.PACK_CACHE.stats()["kinds"].get("bsi", {"hits": 0, "misses": 0}))
    for op in (Operation.GE, Operation.EQ, Operation.LT):
        assert _ser(imm.compare(op, med, 0, None, mode="device")) == _ser(heap.compare(op, med, 0, None, mode="device"))
        assert imm.compare(op, med, 0, None, mode="device") == heap.compare(op, med, 0, None, mode="cpu")
    now = store.PACK_CACHE.stats()["kinds"]["bsi"]
    # one pack for each index, then hits: the mapped index's pack is keyed
    # by its slices' static fingerprints and found again
    assert (now["hits"] - before["hits"], now["misses"] - before["misses"]) == (7, 2)
    assert np.array_equal(
        imm.compare_cardinality_many(Operation.GE, qs, mode="device"),
        heap.compare_cardinality_many(Operation.GE, qs, mode="cpu"),
    )
    mapped_keys = [k for k in store.PACK_CACHE._entries if k[0] == "bsi" and k[1][0] == "static"]
    assert len(mapped_keys) == 1
    assert len(mapped_keys[0][2]) == imm.bit_count() and all(fp[0] == "static" for fp in mapped_keys[0][2])


def test_immutable_range_api_and_parallel_surface():
    rng = np.random.default_rng(0xB51)
    cols = np.unique(rng.integers(0, 200_000, 3000)).astype(np.uint32)
    vals = rng.integers(0, 5000, cols.size).astype(np.int64)
    mut, jmut = MutableBitSliceIndex(), JMBSI()
    mut.set_values((cols, vals))
    jmut.set_values((cols, vals))
    med = int(np.median(vals))
    found = RoaringBitmap(cols[::3])
    jfound = JRB(cols[::3])
    for imm, jimm in (
        (ImmutableBitSliceIndex(mut), JIBSI(jmut)),
        (ImmutableBitSliceIndex(mut.serialize()), JIBSI(jmut.serialize())),
        (mut.to_immutable_bit_slice_index(), jmut.to_immutable_bit_slice_index()),
    ):
        assert _ser(imm.range_ge(found, med)) == _ser(jimm.range_ge(jfound, med))
        assert _ser(imm.range_lt(None, med)) == _ser(jimm.range_lt(None, med))
        assert _ser(imm.range(found, med // 2, med * 2)) == _ser(jimm.range(jfound, med // 2, med * 2))
        assert _ser(imm.parallel_in(4, Operation.EQ, med)) == _ser(jimm.parallel_in(4, jbsi.Operation.EQ, med))
        t_imm = imm.parallel_transpose_with_count(found)
        assert isinstance(t_imm, MutableBitSliceIndex)
        assert t_imm.serialize() == jimm.parallel_transpose_with_count(jfound).serialize()
        assert imm.has_run_compression() == jimm.has_run_compression()
        assert imm.sum(found) == jimm.sum(jfound)
        assert _ser(imm.top_k(found, 10)) == _ser(jimm.top_k(jfound, 10))


def test_buffer_bsi_compare_cardinality_delegation():
    r = np.random.default_rng(71)
    cols = np.sort(r.choice(200_000, size=6_000, replace=False)).astype(np.uint32)
    vals = r.integers(0, 1 << 16, size=6_000).astype(np.int64)
    heap = jbsi.RoaringBitmapSliceIndex()
    heap.set_values((cols, vals))
    imm = ImmutableBitSliceIndex(heap.serialize())
    med = int(np.median(vals))
    qs = np.array([med, med // 2, 0, 1 << 20], dtype=np.int64)
    assert imm.compare_cardinality(Operation.GE, med) == heap.compare_cardinality(jbsi.Operation.GE, med)
    assert np.array_equal(
        imm.compare_cardinality_many(Operation.GE, qs),
        heap.compare_cardinality_many(jbsi.Operation.GE, qs),
    )


def test_bsi_stream_round_trip_through_the_immutable_twin():
    import io

    data, _ = _bsi_blob(seed=3, n=5000, bits_=12)
    buf = io.BytesIO()
    n = ImmutableBitSliceIndex(data).serialize_into(buf)
    assert n == len(data) == ImmutableBitSliceIndex(data).serialized_size_in_bytes()
    buf.seek(0)
    back = ImmutableBitSliceIndex.deserialize_from(buf)
    assert back.serialize() == data


# ---------------------------------------------------------------------------
# RangeBitmap: native-form slices are zero-copy views
# ---------------------------------------------------------------------------


def test_range_bitmap_native_form_slices_are_zero_copy_views():
    from roaringbitmap_tpu.models.range_bitmap import RangeBitmap as JRange

    rng = np.random.default_rng(17)
    rows = rng.integers(0, 1 << 20, size=300_000).astype(np.uint64)
    app = RangeBitmap.appender((1 << 20) - 1)
    app.add_many(rows)
    blob = app.build().serialize(form="native")
    source = bytes(blob)
    mapped = RangeBitmap.map(source)
    whole = np.frombuffer(source, dtype=np.uint8)
    for i in range(mapped._slice_count):
        s = mapped._slice(i)
        assert type(s) is ImmutableRoaringBitmap
        for c in s.high_low_container.containers:
            for a in (c.words,) if type(c) is BitmapContainer else (c.content,) if type(c) is ArrayContainer else (c.starts, c.lengths):
                assert np.shares_memory(a, whole)
    jm = JRange.map(source)
    med = int(np.median(rows))
    assert _ser(mapped.gte(med)) == _ser(jm.gte(med))
    assert _ser(mapped.between(med // 2, med)) == _ser(jm.between(med // 2, med))
    assert mapped.serialize() == source


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_mapped_wide_or_equals_the_heap_result(tmp_path, monkeypatch):
    """The mapped wide OR, XOR and AND on the card equal the heap path's
    bytes on the card and on CPU tensors, through the CUDA kernels, and the
    warm repeat is a pack hit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    monkeypatch.setattr(aggregation.config, "device", "cuda")
    blobs = _blobs(64, seed=0xC0DA)
    path = tmp_path / "set.bin"
    extents = _write_file(path, blobs)
    mm = memoryview(_map(path))
    mapped = [ImmutableRoaringBitmap(mm[o : o + n]) for o, n in extents]
    heap = [RoaringBitmap.deserialize(b) for b in blobs]
    store.PACK_CACHE.close()
    before = sum(K.LAUNCHES.values())
    for op in ("or_", "xor", "and_"):
        want = _ser(getattr(FastAggregation, op)(*heap, mode="device"))
        assert _ser(getattr(BufferFastAggregation, op)(*mapped, mode="device")) == want
        assert want == _ser(getattr(FastAggregation, op)(*heap, mode="device", device="cpu"))
        assert RoaringBitmap.deserialize(want) == getattr(FastAggregation, op)(*heap, mode="cpu")
    assert sum(K.LAUNCHES.values()) > before
    hits = store.PACK_CACHE.stats()["kinds"]["agg"]["hits"]
    BufferFastAggregation.or_(*mapped, mode="device")
    assert store.PACK_CACHE.stats()["kinds"]["agg"]["hits"] == hits + 1


def test_bsi_with_values_past_2_31_round_trips_through_the_wire_format():
    """The north star's values fill all 32 bits. Its min and max go into
    the format's int32 fields as Java would hold those bits, and read back
    unsigned, heap and mapped; the JAX package's ``struct.pack("<iib")``
    refuses such an index."""
    import io

    rng = np.random.default_rng(32)
    cols = np.arange(50_000, dtype=np.uint32)
    vals = rng.integers(0, 1 << 32, size=cols.size, dtype=np.uint64).astype(np.int64)
    vals[:2] = (1 << 31) - 1, (1 << 32) - 1
    t = RoaringBitmapSliceIndex()
    t.set_values((cols, vals))
    data = t.serialize()
    assert struct.unpack_from("<ii", data) == (int(vals.min()), -1)
    med = int(np.median(vals))
    for back in (RoaringBitmapSliceIndex.deserialize(data), ImmutableBitSliceIndex(data),
                 RoaringBitmapSliceIndex.deserialize_from(io.BytesIO(data))):
        assert (back.min_value, back.max_value) == (int(vals.min()), (1 << 32) - 1)
        assert back.bit_count() == 32 and back.serialize() == data
        assert back.compare(Operation.GE, med, 0, None, mode="device") == t.compare(Operation.GE, med, 0, None, mode="cpu")
        assert back.compare(Operation.EQ, (1 << 32) - 1).to_array().tolist() == [1]
    with pytest.raises(ValueError):
        RoaringBitmapSliceIndex(0, 1 << 32).serialize()
    j = jbsi.RoaringBitmapSliceIndex()
    j.set_values((cols, vals))
    with pytest.raises(struct.error):
        j.serialize()
