"""The port's 64-bit bit-sliced index against the JAX package.

The same seeded (column, value) pairs go into both packages'
``Roaring64BitmapSliceIndex``. The JAX side runs as its own tests run it
(``mode="device"`` takes its fused XLA walk on the CPU backend); the port
runs its device path on CPU tensors (``bsi.config.device = "cpu"``), where
``kernels.oneil_compare`` takes its plain version. Every comparison is
exact: result bytes, counts, values and serialized indexes both ways, for
every ``Operation``, with and without found sets, at 48 and 64 slices and
with predicates at or above 2^63. The ``cuda``-marked tests run the same
walk through the CUDA kernels and skip without a card.
"""

import io
import pickle

import numpy as np
import pytest
import torch

from roaringbitmap_tpu.models.bsi import Operation as JOp
from roaringbitmap_tpu.models.bsi64 import Roaring64BitmapSliceIndex as JBSI64
from roaringbitmap_tpu.models.roaring64art import Roaring64Bitmap as JR64
from roaringbitmap_tpu.parallel import store as jstore

import roaringbitmap_tpu_torch as T
from roaringbitmap_tpu_torch import interop
from roaringbitmap_tpu_torch.models import bsi as tbsi
from roaringbitmap_tpu_torch.models import bsi64 as tbsi64
from roaringbitmap_tpu_torch.ops import kernels as K
from roaringbitmap_tpu_torch.parallel import aggregation
from roaringbitmap_tpu_torch.parallel import store as tstore
from roaringbitmap_tpu_torch.robust.errors import TierUnavailable

SEED = 0xFEEF1F0
OPS = ("EQ", "NEQ", "GT", "LT", "LE", "GE", "RANGE")
NUMPY_OP = {
    "EQ": lambda v, a, b: v == a,
    "NEQ": lambda v, a, b: v != a,
    "GT": lambda v, a, b: v > a,
    "LT": lambda v, a, b: v < a,
    "LE": lambda v, a, b: v <= a,
    "GE": lambda v, a, b: v >= a,
    "RANGE": lambda v, a, b: (v >= a) & (v <= b),
}


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    """The port's BSI device path and the pairwise ops' device tier on CPU
    tensors; the 64-bit index's auto mode as shipped; both packages' pack
    caches emptied after each test."""
    monkeypatch.setattr(tbsi.config, "device", "cpu")
    monkeypatch.setattr(aggregation.config, "device", "cpu")
    monkeypatch.setattr(tbsi64.config, "mode", "auto")
    yield
    tstore.PACK_CACHE.close()
    jstore.PACK_CACHE.close()


def _columns(rng, n):
    """Columns over several high-48 chunks of three high-32 buckets, one of
    them at 2^60 (chunk-dense, so the device pack stays a few chunks)."""
    parts = [
        rng.choice(1 << 17, size=n // 2, replace=False).astype(np.uint64),
        (np.uint64(5) << np.uint64(32)) + rng.choice(1 << 16, size=n // 4, replace=False).astype(np.uint64),
        (np.uint64(1) << np.uint64(60)) + rng.choice(1 << 16, size=n - n // 2 - n // 4, replace=False).astype(np.uint64),
    ]
    return np.concatenate(parts)


def _values(rng, n, bits):
    if bits == 64:
        return rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
    return rng.integers(0, 1 << bits, size=n, dtype=np.uint64)


def build(n=3000, bits=36, seed=SEED):
    """The same index in both packages, and its (columns, values)."""
    rng = np.random.default_rng(seed)
    cols = _columns(rng, n)
    vals = _values(rng, n, bits)
    j, t = JBSI64(), T.Roaring64BitmapSliceIndex()
    j.set_values((cols, vals))
    t.set_values((cols, vals))
    order = np.argsort(cols)
    return j, t, cols[order], vals[order]


def _r64(cols):
    return JR64(np.asarray(cols, dtype=np.uint64)), T.Roaring64Bitmap(np.asarray(cols, dtype=np.uint64))


def _same_bm(j, t, want_cols=None):
    jb = j.serialize()
    assert t.serialize() == jb
    assert T.Roaring64Bitmap.deserialize(jb).serialize() == jb
    if want_cols is not None:
        assert np.array_equal(t.to_array(), np.sort(np.asarray(want_cols, dtype=np.uint64)))


def _same_index(j, t):
    blob = j.serialize()
    assert t.serialize() == blob
    assert T.Roaring64BitmapSliceIndex.deserialize(blob).serialize() == blob
    assert JBSI64.deserialize(t.serialize()).serialize() == blob
    assert (t.min_value, t.max_value, t.bit_count()) == (j.min_value, j.max_value, j.bit_count())


def _model(cols, vals, op, a, b=0, found=None):
    mask = NUMPY_OP[op](vals, np.uint64(a), np.uint64(b))
    keep = cols[mask]
    if found is not None:
        keep = np.intersect1d(keep, found)
    return keep


# ---------------------------------------------------------------------------
# construction, reads, combination (tests/test_bsi64_buffer.py's TestRoaring64BSI)
# ---------------------------------------------------------------------------


def test_set_get_matches_jax():
    j, t, cols, vals = build()
    _same_index(j, t)
    assert t.get_long_cardinality() == j.get_long_cardinality() == cols.size
    for c, v in list(zip(cols.tolist(), vals.tolist()))[::97]:
        assert t.get_value(c) == j.get_value(c) == (v, True)
    assert t.get_value(123456789) == (0, False)
    assert (t.min_value, t.max_value) == (int(vals.min()), int(vals.max()))


def test_point_updates_match_jax():
    j, t = JBSI64(), T.Roaring64BitmapSliceIndex()
    for idx in (j, t):
        idx.set_value(1 << 35, 42)
        idx.set_value(7, (1 << 50) + 3)
        idx.set_value(7, 9)  # an overwrite clears the old bits
        idx.set_value((1 << 63) + 1, (1 << 63) + 5)
    _same_index(j, t)
    assert t.get_value(7) == (9, True)
    assert t.get_value((1 << 63) + 1) == ((1 << 63) + 5, True)


def test_get_values_bulk_matches_jax():
    j, t, cols, vals = build(800)
    probe = np.concatenate([cols[::5], np.array([12345, 1 << 62], dtype=np.uint64)])
    tv, te = t.get_values(probe)
    jv, je = j.get_values(probe)
    assert np.array_equal(te, je) and np.array_equal(tv, jv)
    big_j, big_t = JBSI64(), T.Roaring64BitmapSliceIndex()
    for idx in (big_j, big_t):
        idx.set_value(5, (1 << 63) + 7)
    v, e = big_t.get_values([5, 6])
    assert list(v) == [(1 << 63) + 7, 0] and e.tolist() == [True, False]
    assert list(big_j.get_values([5, 6])[0]) == list(v)


def test_sum_top_k_transpose_match_jax():
    j, t, cols, vals = build(600)
    jf, tf = _r64(cols[::3])
    assert t.sum(tf) == j.sum(jf) == (int(vals[::3].astype(object).sum()), cols[::3].size)
    assert t.sum(None) == (0, 0)
    for k in (1, 25, 599, 5000):
        _same_bm(j.top_k(jf, k), t.top_k(tf, k))
        _same_bm(j.top_k(None, k), t.top_k(None, k))
    _same_bm(j.transpose(), t.transpose(), np.unique(vals))
    _same_bm(j.transpose(jf), t.transpose(tf))
    _same_index(j.transpose_with_count(), t.transpose_with_count())
    # ties at the cut line: values repeat, the fill takes the smallest columns
    jt, tt = JBSI64(), T.Roaring64BitmapSliceIndex()
    for idx in (jt, tt):
        idx.set_values((np.arange(100, dtype=np.uint64) << np.uint64(20), np.arange(100) % 4))
    _same_bm(jt.top_k(None, 30), tt.top_k(None, 30))


def test_add_merge_match_jax():
    j, t, cols, vals = build(300)
    cols2 = cols[:50] + np.uint64(1 << 41)
    j2, t2 = JBSI64(), T.Roaring64BitmapSliceIndex()
    j2.set_values((cols2, np.arange(50, dtype=np.uint64)))
    t2.set_values((cols2, np.arange(50, dtype=np.uint64)))
    jm, tm = j.clone(), t.clone()
    jm.merge(j2)
    tm.merge(t2)
    _same_index(jm, tm)
    ja, ta = j.clone(), t.clone()
    ja.add(j)
    ta.add(t)  # doubles every value
    _same_index(ja, ta)
    assert ta.get_value(int(cols[3])) == (2 * int(vals[3]), True)
    with pytest.raises(ValueError):
        t.clone().merge(t)


def test_serialization_round_trip_both_ways():
    j, t, _cols, _vals = build(400)
    j.run_optimize()
    t.run_optimize()
    _same_index(j, t)
    assert len(t.serialize()) == t.serialized_size_in_bytes() == j.serialized_size_in_bytes()
    back = T.Roaring64BitmapSliceIndex.deserialize(t.serialize())
    assert back == t and back.run_optimized
    with pytest.raises(T.InvalidRoaringFormat):
        T.Roaring64BitmapSliceIndex.deserialize(b"\x01" * 10)


def test_stream_serialization_and_pickle():
    class Dribble(io.RawIOBase):
        def __init__(self, data):
            self._b = io.BytesIO(data)

        def read(self, n=-1):
            return self._b.read(min(n, 1) if n and n > 0 else n)

    j, t = JBSI64(), T.Roaring64BitmapSliceIndex()
    for idx in (j, t):
        idx.set_values(([3, (1 << 45) + 1, (1 << 63) + 2], [7, (1 << 33) + 2, (1 << 62) + 9]))
    buf = io.BytesIO()
    n = t.serialize_into(buf) + t.serialize_into(buf)
    assert buf.tell() == n and buf.getvalue() == j.serialize() * 2
    buf.seek(0)
    assert T.Roaring64BitmapSliceIndex.deserialize_from(buf) == t
    assert JBSI64.deserialize_from(buf).serialize() == t.serialize()
    assert buf.read() == b""
    assert T.Roaring64BitmapSliceIndex.deserialize_from(Dribble(j.serialize())) == t
    back = pickle.loads(pickle.dumps(t))
    assert type(back) is T.Roaring64BitmapSliceIndex and back.serialize() == j.serialize()


# ---------------------------------------------------------------------------
# the compare: CPU walk and device walk, every op
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", OPS)
def test_compare_matches_jax_and_numpy(op):
    j, t, cols, vals = build(1500, bits=36)
    srt = np.sort(vals)
    jf, tf = _r64(cols[::3])
    preds = [int(srt[0]), int(srt[srt.size // 2]), int(srt[-1]), int(srt[-1]) + 10]
    for a in preds:
        b = int(srt[-5]) if op == "RANGE" else 0
        for jfs, tfs, found in ((None, None, None), (jf, tf, cols[::3])):
            want = j.compare(JOp[op], a, b, jfs, mode="cpu")
            for mode in ("cpu", "device"):
                got = t.compare(T.Operation[op], a, b, tfs, mode=mode)
                _same_bm(want, got, _model(cols, vals, op, a, b, found))
                assert t.compare_cardinality(T.Operation[op], a, b, tfs, mode=mode) == want.get_cardinality()


def _deep(bits, seed):
    """A deep index whose values sit near a few centres, so EQ / NEQ and the
    range bounds cut through the slices' lowest bits."""
    rng = np.random.default_rng(seed)
    n = 2400
    cols = _columns(rng, n)
    top = (1 << bits) - 1
    centres = np.array([top // 3, top // 2, top - 1000, 1 << (bits - 1)], dtype=np.uint64)
    vals = centres[rng.integers(0, centres.size, n)] + rng.integers(0, 64, n).astype(np.uint64)
    vals[:4] = [np.uint64(top), np.uint64(0), centres[1], centres[2]]
    j, t = JBSI64(), T.Roaring64BitmapSliceIndex()
    j.set_values((cols, vals))
    t.set_values((cols, vals))
    order = np.argsort(cols)
    return j, t, cols[order], vals[order]


@pytest.mark.parametrize("bits", [48, 64])
@pytest.mark.parametrize("op", OPS)
def test_device_walk_deep_matches_jax(bits, op):
    """The device walk at S = 48 and S = 64 (the tiled walk's plan at those
    depths), predicates at and above 2^(S-1) (2^63 at S = 64), with and
    without a found set, and NEQ's found set reaching chunks outside the
    ebm: equal to the JAX package's device walk, its CPU walk and numpy."""
    j, t, cols, vals = _deep(bits, SEED + bits)
    assert t.bit_count() == bits
    top = (1 << bits) - 1
    present = int(vals[10])
    preds = [(present, present + 40), ((1 << (bits - 1)) + 20, top - 500), (top - 1000, top - 1)]
    outside = (np.uint64(9) << np.uint64(40)) + np.arange(0, 300, 3, dtype=np.uint64)
    found_cols = np.concatenate([cols[::2], outside])
    jf, tf = _r64(found_cols)
    for a, b in preds:
        if op != "RANGE":
            b = 0
        for jfs, tfs, found in ((None, None, None), (jf, tf, found_cols)):
            want = j.compare(JOp[op], a, b, jfs, mode="device")
            got = t.compare(T.Operation[op], a, b, tfs, mode="device")
            model = _model(cols, vals, op, a, b, found)
            if op == "NEQ" and found is not None:
                model = np.union1d(model, outside)  # outside the ebm: never EQ
            _same_bm(want, got, model)
            _same_bm(j.compare(JOp[op], a, b, jfs, mode="cpu"), got)
            cnt = t.compare_cardinality(T.Operation[op], a, b, tfs, mode="device")
            assert cnt == j.compare_cardinality(JOp[op], a, b, jfs, mode="device") == model.size


def test_compare_cardinality_verdicts_match_jax():
    j, t, cols, vals = build(2000, bits=30)
    med = int(np.median(vals))
    jf, tf = _r64(cols[:500])
    for op, a, e in (
        ("GE", med, 0), ("LT", med, 0), ("RANGE", med // 2, med * 2),
        ("GE", 0, 0),  # min/max verdict 'all'
        ("GT", 1 << 40, 0),  # 'empty'
        ("NEQ", 1 << 40, 0),  # 'fixed'
    ):
        for jfs, tfs in ((None, None), (jf, tf)):
            want = j.compare_cardinality(JOp[op], a, e, jfs, mode="cpu")
            for mode in ("cpu", "device"):
                assert t.compare_cardinality(T.Operation[op], a, e, tfs, mode=mode) == want, (op, mode)


@pytest.mark.parametrize("op", ["GE", "NEQ", "LT", "EQ", "RANGE"])
def test_compare_cardinality_many_matches_jax(op):
    """Batched counts (one count-only launch on the device path) at 64
    slices, thresholds up to 2^64 - 1 as exact Python ints, with and
    without a found set reaching chunks outside the ebm."""
    j, t, cols, vals = _deep(64, SEED + 7)
    srt = np.sort(vals)
    qs = np.array(
        [int(srt[i]) for i in (0, 100, 1200, 2399)] + [1 << 63, (1 << 63) + 30, (1 << 64) - 1, 0],
        dtype=object,
    )
    ends = np.array([min(int(q) + (1 << 40), (1 << 64) - 1) for q in qs], dtype=object)
    outside = (np.uint64(9) << np.uint64(40)) + np.arange(0, 300, 3, dtype=np.uint64)
    found_cols = np.concatenate([cols[::3], outside])
    jf, tf = _r64(found_cols)
    for jfs, tfs in ((None, None), (jf, tf)):
        kw = {"ends": ends} if op == "RANGE" else {}
        want = np.array([
            j.compare_cardinality(JOp[op], int(q), int(e) if op == "RANGE" else 0, jfs, mode="cpu")
            for q, e in zip(qs, ends)
        ], dtype=np.int64)
        for mode in ("cpu", "device"):
            got = t.compare_cardinality_many(T.Operation[op], qs, found_set=tfs, mode=mode, **kw)
            assert got.dtype == np.int64 and np.array_equal(got, want), (op, mode, tfs is not None)
        jgot = j.compare_cardinality_many(JOp[op], qs, found_set=jfs, mode="device", **kw)
        assert np.array_equal(jgot, want)


# ---------------------------------------------------------------------------
# the device path's pack, mode and device rules
# ---------------------------------------------------------------------------


def test_pack_resident_in_the_shared_cache_and_rekeyed():
    _j, t, cols, vals = build(1200)
    t.compare(T.Operation.GE, int(np.median(vals)), mode="device")
    key = ("bsi64", id(t), t._version, "cpu")
    assert key in tstore.PACK_CACHE
    keys, ebm_w, slices_w = t._pack_dense64()
    assert ebm_w.dtype == slices_w.dtype == torch.int32
    assert tuple(slices_w.shape) == (t.bit_count(), len(keys), 2048)
    assert keys == [k for k, _ in t.ebm._kv()]
    assert tstore.PACK_CACHE.stats()["kinds"]["bsi64"]["hits"] >= 1
    before = t._version
    t.set_value(int(cols[0]), 7)
    assert t._version != before
    assert ("bsi64", id(t), t._version, "cpu") not in tstore.PACK_CACHE
    got = t.compare(T.Operation.EQ, 7, mode="device")
    assert got.contains(int(cols[0]))


def test_auto_mode_decides_by_size_only(monkeypatch):
    """auto takes the device path at bit_count x chunks >= 4096 without
    probing for a card: with the device named "cuda" and no card a small
    index answers on the CPU walk and a large one raises."""
    small_j, small, cols, vals = build(300)
    rng = np.random.default_rng(SEED + 3)
    big = T.Roaring64BitmapSliceIndex()
    big_cols = (np.arange(64, dtype=np.uint64) << np.uint64(16)) + np.uint64(3)
    big_vals = rng.integers(1 << 62, 1 << 63, 64, dtype=np.uint64) | np.uint64(1 << 63)
    big.set_values((big_cols, big_vals))
    assert big.bit_count() * big._key_count() >= tbsi64.config.min_device_cells
    assert not small._use_device(None) and big._use_device(None)
    with pytest.raises(ValueError):
        small._use_device("gpu")
    monkeypatch.setattr(tbsi.config, "device", "cuda")
    med = int(np.median(vals))
    _same_bm(small_j.compare(JOp.GE, med, mode="cpu"), small.compare(T.Operation.GE, med))
    if not torch.cuda.is_available():
        with pytest.raises(TierUnavailable):
            big.compare(T.Operation.GE, int(np.median(big_vals)))


def jax_r64_state(j):
    """The interop state dict read out of a JAX-package Roaring64Bitmap."""
    from roaringbitmap_tpu.models.container import BitmapContainer as JBitmap
    from roaringbitmap_tpu.models.container import RunContainer as JRun

    keys, kinds, parts, words = [], [], [], []
    for k, c in j._kv():
        keys.append(int.from_bytes(k, "big"))
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


def test_bsi64_state_round_trip_of_a_jax_index():
    j, t, _cols, _vals = build(700, bits=50)
    j.run_optimize()
    state = {
        "min_value": j.min_value,
        "max_value": j.max_value,
        "run_optimized": j.run_optimized,
        "ebm": jax_r64_state(j.ebm),
        "slices": [jax_r64_state(s) for s in j.slices],
    }
    back = interop.bsi64_from_state(state)
    assert type(back) is T.Roaring64BitmapSliceIndex
    _same_index(j, back)
    again = interop.bsi64_to_state(back)
    assert again["min_value"] == j.min_value and len(again["slices"]) == j.bit_count()
    for got, want in zip([again["ebm"]] + again["slices"], [state["ebm"]] + state["slices"]):
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("op", OPS)
def test_cuda_device_walk_matches_the_cpu_device_path(op, monkeypatch):
    """On the card: compare, compare_cardinality and the batched count at
    64 slices through ``rb_oneil_compare`` / ``rb_oneil_counts`` equal the
    same device path on CPU tensors. Skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    _j, t, cols, vals = _deep(64, SEED + 64)
    _j2, t_cpu, _c, _v = _deep(64, SEED + 64)
    tf = T.Roaring64Bitmap(np.concatenate([cols[::2], np.arange(1 << 40, (1 << 40) + 99, dtype=np.uint64)]))
    a, b = int(vals[10]), (1 << 64) - 1000
    qs = [int(vals[i]) for i in range(0, 2400, 300)] + [1 << 63]
    want = t_cpu.compare(T.Operation[op], a, b, tf, mode="device").serialize()
    want_n = t_cpu.compare_cardinality_many(T.Operation[op], qs, ends=[b] * len(qs), found_set=tf, mode="device")
    monkeypatch.setattr(tbsi.config, "device", "cuda")
    K.reset_launches()
    assert t.compare(T.Operation[op], a, b, tf, mode="device").serialize() == want
    got_n = t.compare_cardinality_many(T.Operation[op], qs, ends=[b] * len(qs), found_set=tf, mode="device")
    assert np.array_equal(got_n, want_n)
    assert K.LAUNCHES["rb_oneil_compare"] == 1 and K.LAUNCHES["rb_oneil_compare[batched]"] == 1
