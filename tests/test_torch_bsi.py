"""The port's BSI range-query slice against the JAX package.

Seeded numpy inputs go through both packages on the CPU. The JAX side runs
as its own tests run it: the Pallas kernels in interpret mode, the XLA ops
(``o_neil_math``, ``_o_neil_counts_batched``, ``_slice_masked_popcounts``)
on JAX's CPU backend, and its index with ``mode="device"``. The port runs
its device path on CPU tensors (``bsi.config.device = "cpu"``), where each
kernel wrapper takes its plain PyTorch version. Every comparison is exact:
words, cards, values and serialized bytes. The CUDA kernels themselves are
held against the plain versions by the ``cuda``-marked tests in
``test_torch_kernels.py`` and by ``chip_smoke.py``.
"""

import io
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from roaringbitmap_tpu.models import bsi as jbsi
from roaringbitmap_tpu.models.bsi_buffer import MutableBitSliceIndex as JMutable
from roaringbitmap_tpu.models.container import BitmapContainer as JBitmap
from roaringbitmap_tpu.models.container import RunContainer as JRun
from roaringbitmap_tpu.models.range_bitmap import RangeBitmap as JRange
from roaringbitmap_tpu.models.roaring import RoaringBitmap as JRB
from roaringbitmap_tpu.ops import pallas_kernels as pk

from roaringbitmap_tpu_torch import Operation as TOp
from roaringbitmap_tpu_torch import RangeBitmap as TRange
from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch import RoaringBitmapSliceIndex as TBSI
from roaringbitmap_tpu_torch import interop
from roaringbitmap_tpu_torch.models import bsi as tbsi
from roaringbitmap_tpu_torch.models.bsi_buffer import MutableBitSliceIndex as TMutable
from roaringbitmap_tpu_torch.ops import device as tdev
from roaringbitmap_tpu_torch.ops import kernels as K
from roaringbitmap_tpu_torch.parallel import aggregation
from roaringbitmap_tpu_torch.parallel import store as tstore
from roaringbitmap_tpu_torch.robust.errors import TierUnavailable

SEED = 0xFEEF1F0
W = 2048
OPS = ("EQ", "NEQ", "GT", "LT", "LE", "GE", "RANGE")


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    """The port's BSI device path on CPU tensors; its auto mode as shipped.
    The pairwise ops the BSI runs route through the columnar cost model,
    whose device tier runs on ``aggregation.config.device``: CPU tensors
    too. The shared pack cache is emptied after each test, so no test's
    packs stay resident."""
    monkeypatch.setattr(tbsi.config, "device", "cpu")
    monkeypatch.setattr(aggregation.config, "device", "cpu")
    monkeypatch.setattr(tbsi.config, "mode", "auto")
    yield
    tstore.PACK_CACHE.close()


def _t(u32):
    return torch.from_numpy(np.ascontiguousarray(u32).view(np.int32))


def _u32(t):
    return np.ascontiguousarray(t.numpy()).view(np.uint32)


def _bits(value, s):
    return np.array([(value >> i) & 1 for i in range(s - 1, -1, -1)], dtype=bool)


def _walk_inputs(rng, s, k):
    slices = rng.integers(0, 1 << 32, size=(s, k, W), dtype=np.uint64).astype(np.uint32)
    ebm = np.bitwise_or.reduce(slices, axis=0)
    fixed = rng.integers(0, 1 << 32, size=(k, W), dtype=np.uint64).astype(np.uint32)
    return slices, ebm, fixed


def _near_walk_inputs(rng, value, s, k):
    """Like ``_walk_inputs``, but every column holds ``value`` with each bit
    flipped with probability 1/32: EQ stays alive deep into the walk, and
    EQ/NEQ answers are far from empty or full."""

    def rand():
        return rng.integers(0, 1 << 32, size=(k, W), dtype=np.uint64).astype(np.uint32)

    ebm = rand() | rand()
    slices = np.stack([
        (rand() & rand() & rand() & rand() & rand()) ^ np.uint32(0xFFFFFFFF if value >> i & 1 else 0)
        for i in range(s)
    ]) & ebm
    return slices, ebm, rand()


def _op_bits(op, lo, hi, s):
    """JAX-layout predicate bits ([S], or [2, S] for RANGE) and the port's
    int32 [1, W, S] tensor of the same bits."""
    b = np.stack([_bits(lo, s), _bits(hi, s)]) if op == "RANGE" else _bits(lo, s)
    return b, torch.from_numpy(b.reshape(1, -1, s).astype(np.int32))


# ---------------------------------------------------------------------------
# the kernels' plain versions against the Pallas kernels and XLA ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", OPS)
def test_oneil_walk_matches_oneil_pallas(op):
    rng = np.random.default_rng(SEED)
    s, k = 6, 11  # K not a multiple of the Pallas kernel's tile
    slices, ebm, fixed = _walk_inputs(rng, s, k)
    jbits, tbits = _op_bits(op, 0b100110, 0b110101, s)
    want_out, want_cards = pk.oneil_compare_pallas(
        jnp.asarray(slices), jnp.asarray(jbits), jnp.asarray(ebm), jnp.asarray(fixed),
        op=op, interpret=True,
    )
    out, cards = K.oneil_compare(_t(slices), tbits, _t(ebm), _t(fixed), op)
    assert np.array_equal(_u32(out), np.asarray(want_out))
    assert np.array_equal(cards[0].numpy(), np.asarray(want_cards))
    # the plain walk itself, with the JAX-layout bits
    out2, cards2 = tdev.o_neil_walk(_t(slices), jbits, _t(ebm), _t(fixed), op)
    assert torch.equal(out2, out) and torch.equal(cards2, cards[0])


@pytest.mark.parametrize("op", OPS)
def test_oneil_walk_deeper_than_64_slices_matches_o_neil_math(op):
    rng = np.random.default_rng(SEED + 70)
    s, k = 70, 3
    value = int(rng.integers(1 << 60, 1 << 61)) << 9 | 0x5A
    slices, ebm, fixed = _near_walk_inputs(rng, value, s, k)
    lo, hi = (value - (1 << 35), value + (1 << 35)) if op == "RANGE" else (value, 0)
    jbits, tbits = _op_bits(op, lo, hi, s)
    want_out, want_cards = jbsi.o_neil_math(
        jnp.asarray(slices), jnp.asarray(jbits), jnp.asarray(ebm), jnp.asarray(fixed), op
    )
    out, cards = K.oneil_compare(_t(slices), tbits, _t(ebm), _t(fixed), op)
    assert 0 < int(np.asarray(want_cards).sum()) < int(np.bitwise_count(fixed).sum())
    assert np.array_equal(_u32(out), np.asarray(want_out))
    assert np.array_equal(cards[0].numpy(), np.asarray(want_cards))


@pytest.mark.parametrize("op", OPS)
def test_batched_counts_match_o_neil_counts_batched(op):
    rng = np.random.default_rng(SEED + 5)
    s, k, q = 9, 4, 6
    slices, ebm, fixed = _walk_inputs(rng, s, k)
    los = rng.integers(0, 1 << s, size=q)
    his = np.minimum(los + rng.integers(0, 200, size=q), (1 << s) - 1)
    if op == "RANGE":
        jbits = np.stack([np.stack([_bits(a, s), _bits(b, s)]) for a, b in zip(los, his)])
    else:
        jbits = np.stack([_bits(a, s) for a in los])
    want = jbsi._o_neil_counts_batched(
        jnp.asarray(slices), jnp.asarray(jbits), jnp.asarray(ebm), jnp.asarray(fixed), op
    )
    tbits = torch.from_numpy(jbits.reshape(q, -1, s).astype(np.int32))
    out, cards = K.oneil_compare(_t(slices), tbits, _t(ebm), _t(fixed), op, count_only=True)
    assert out is None
    assert np.array_equal(cards.numpy(), np.asarray(want))


@pytest.mark.parametrize(
    "op,q,with_found",
    [("GE", 2, False), ("LT", 13, False), ("EQ", 17, False), ("NEQ", 100, True),
     ("RANGE", 13, True), ("RANGE", 100, True), ("LE", 33, True)],
)
def test_batched_counts_ragged_q_match_o_neil_counts_batched(op, q, with_found):
    """Q not a multiple of the tiled walk's query groups (16, 8 or 4), and
    found sets that clear whole chunks and part of one."""
    rng = np.random.default_rng(SEED + 50 + q)
    s, k = 11, 5
    slices, ebm, fixed = _walk_inputs(rng, s, k)
    if with_found:
        fixed &= ebm
        fixed[1] = 0
        fixed[3, 700:] = 0
    else:
        fixed = ebm.copy()
    los = rng.integers(0, 1 << s, size=q)
    los[0], los[-1] = 0, (1 << s) - 1  # the two extremes of the branch on the bit
    his = np.minimum(los + rng.integers(0, 600, size=q), (1 << s) - 1)
    if op == "RANGE":
        jbits = np.stack([np.stack([_bits(a, s), _bits(b, s)]) for a, b in zip(los, his)])
    else:
        jbits = np.stack([_bits(a, s) for a in los])
    want = jbsi._o_neil_counts_batched(
        jnp.asarray(slices), jnp.asarray(jbits), jnp.asarray(ebm), jnp.asarray(fixed), op
    )
    tbits = torch.from_numpy(jbits.reshape(q, -1, s).astype(np.int32))
    out, cards = K.oneil_compare(_t(slices), tbits, _t(ebm), _t(fixed), op, count_only=True)
    assert out is None
    assert 0 < int(np.asarray(want).sum())
    assert np.array_equal(cards.numpy(), np.asarray(want))
    assert np.array_equal(
        K.oneil_counts_per_query(_t(slices), tbits, _t(ebm), _t(fixed), op).numpy(), np.asarray(want)
    )


def test_masked_popcounts_match_slice_masked_popcounts():
    rng = np.random.default_rng(SEED + 6)
    s, k = 7, 5
    slices, _, found = _walk_inputs(rng, s, k)
    found[1] = 0
    found[2, :100] = 0xFFFFFFFF
    want = np.asarray(jbsi._slice_masked_popcounts(jnp.asarray(slices), jnp.asarray(found)))
    got = K.popcount_rows(_t(slices), mask=_t(found))
    assert np.array_equal(got.view(s, k).numpy(), want)
    assert np.array_equal(tdev.slice_masked_popcounts(_t(slices), _t(found)).numpy(), want)


@pytest.mark.parametrize("op", ["or", "and", "xor"])
def test_wide_reduce_matches_wide_pallas(op):
    rng = np.random.default_rng(SEED + 7)
    n = 300
    words = rng.integers(0, 1 << 32, size=(n, W), dtype=np.uint64).astype(np.uint32)
    if op == "or":
        words &= rng.integers(0, 1 << 32, size=(n, W), dtype=np.uint64).astype(np.uint32) >> 7
    elif op == "and":
        words |= ~(rng.integers(0, 1 << 32, size=(n, W), dtype=np.uint64).astype(np.uint32) >> 7)
    red, card = pk.wide_reduce_cardinality_pallas(jnp.asarray(words), op=op, interpret=True)
    got, got_card = K.wide_reduce_cardinality(_t(words), op)
    assert np.array_equal(_u32(got), np.asarray(red))
    assert int(got_card) == int(card)
    ident, ident_card = K.wide_reduce_cardinality(_t(words[:0]), op)
    assert int(ident_card) == (W * 32 if op == "and" else 0) and ident.shape == (W,)


def test_oneil_wrapper_rejects_what_the_kernel_does_not_take():
    z3, z2 = torch.zeros((4, 2, W), dtype=torch.int32), torch.zeros((2, W), dtype=torch.int32)
    bits = torch.zeros((1, 1, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        K.oneil_compare(z3, bits, z2, z2, "BETWEEN")
    with pytest.raises(ValueError):
        K.oneil_compare(z3, bits, z2, z2, "RANGE")  # RANGE needs [Q, 2, S]
    with pytest.raises(ValueError):
        K.oneil_compare(z3, bits.to(torch.int64), z2, z2, "GE")
    with pytest.raises(ValueError):
        K.oneil_compare(z3, torch.zeros((2, 1, 4), dtype=torch.int32), z2, z2, "GE")
    with pytest.raises(ValueError):
        K.oneil_compare(z3, bits, z2[:1], z2, "GE")
    with pytest.raises(ValueError):
        K.popcount_rows(z3, mask=torch.zeros((3, W), dtype=torch.int32))  # 3 does not divide 8


# ---------------------------------------------------------------------------
# the whole index, both packages built from the same (cols, vals)
# ---------------------------------------------------------------------------

N_COLS = 300_000


def _columns_values(seed=SEED, n=N_COLS, bits=20):
    rng = np.random.default_rng(seed)
    cols = np.sort(rng.choice(5 << 16, size=n, replace=False)).astype(np.uint32)
    vals = rng.integers(0, 1 << bits, size=n)
    vals[:50] = 0
    vals[50:60] = (1 << bits) - 1
    return cols, vals


def _found(seed=SEED + 11):
    """A found set over chunks 0-4 (the ebm's) and 5-7 (outside it)."""
    rng = np.random.default_rng(seed)
    inside = rng.choice(5 << 16, size=40_000, replace=False)
    outside = (5 << 16) + rng.choice(3 << 16, size=3_000, replace=False)
    return np.unique(np.concatenate([inside, outside])).astype(np.uint32)


@pytest.fixture(scope="module")
def pair():
    cols, vals = _columns_values()
    j, t = jbsi.RoaringBitmapSliceIndex(), TBSI()
    j.set_values((cols, vals))
    t.set_values((cols, vals))
    found = _found()
    return j, t, cols, vals, JRB(found), TRB(found)


def _queries(vals):
    med = int(np.median(vals))
    present = int(vals[1234])
    hi_max = int(vals.max())
    single = [med, present, 0, 1, hi_max, hi_max + 1, 1 << 63, (1 << 64) + 5]
    ranges = [(med // 2, med + med // 2), (present, present), (0, 1 << 40), (5, 4), (1 << 63, 1 << 64)]
    return single, ranges


@pytest.mark.parametrize("op", [o for o in OPS if o != "RANGE"])
@pytest.mark.parametrize("with_found", [False, True])
def test_compare_matches_jax_package(pair, op, with_found):
    j, t, _, vals, jf, tf = pair
    single, _ = _queries(vals)
    for v in single:
        want = j.compare(jbsi.Operation[op], v, 0, jf if with_found else None, mode="device")
        got = t.compare(TOp[op], v, 0, tf if with_found else None, mode="device")
        assert got.serialize() == want.serialize(), (op, v)
        card = t.compare_cardinality(TOp[op], v, 0, tf if with_found else None, mode="device")
        assert card == want.get_cardinality(), (op, v)
        # the CPU walk agrees as well
        cpu = t.compare(TOp[op], v, 0, tf if with_found else None, mode="cpu")
        assert cpu.serialize() == want.serialize(), (op, v)


@pytest.mark.parametrize("with_found", [False, True])
def test_range_compare_matches_jax_package(pair, with_found):
    j, t, _, vals, jf, tf = pair
    _, ranges = _queries(vals)
    for lo, hi in ranges:
        want = j.compare(jbsi.Operation.RANGE, lo, hi, jf if with_found else None, mode="device")
        got = t.compare(TOp.RANGE, lo, hi, tf if with_found else None, mode="device")
        assert got.serialize() == want.serialize(), (lo, hi)
        assert t.compare_cardinality(
            TOp.RANGE, lo, hi, tf if with_found else None, mode="device"
        ) == want.get_cardinality()


@pytest.mark.parametrize("op", OPS)
def test_compare_cardinality_many_matches_jax_package(pair, op):
    j, t, _, vals, jf, tf = pair
    single, ranges = _queries(vals)
    qs = [int(x) for x in np.quantile(vals, np.linspace(0.05, 0.95, 9))] + single
    ends = [q + 1000 for q in qs] if op == "RANGE" else None
    for jfs, tfs in ((None, None), (jf, tf)):
        want = j.compare_cardinality_many(jbsi.Operation[op], qs, ends, jfs, mode="device")
        got = t.compare_cardinality_many(TOp[op], qs, ends, tfs, mode="device")
        assert got.dtype == np.int64 and np.array_equal(got, want)
        loop = [t.compare_cardinality(TOp[op], q, 0 if ends is None else e, tfs, mode="cpu")
                for q, e in zip(qs, ends or qs)]
        assert np.array_equal(got, loop)


def test_sum_top_k_transpose_values_match_jax_package(pair):
    j, t, cols, vals, jf, tf = pair
    assert t.sum(tf, mode="device") == j.sum(jf, mode="device")
    assert t.sum(tf, mode="device") == t.sum(tf, mode="cpu")
    in_found = np.isin(cols, _found())
    assert t.sum(tf, mode="device")[0] == int(vals[in_found].sum())
    for k in (1, 17, 5000):
        assert t.top_k(tf, k).serialize() == j.top_k(jf, k).serialize()
    assert t.transpose(tf).serialize() == j.transpose(jf).serialize()
    probe = np.concatenate([cols[::997], np.array([5 << 16, 7], dtype=np.uint32)])
    tv, te = t.get_values(probe)
    jv, je = j.get_values(probe)
    assert np.array_equal(tv, jv) and np.array_equal(te, je)
    assert t.to_pair_list(tf)[:100] == j.to_pair_list(jf)[:100]
    assert t.get_value(int(cols[3])) == j.get_value(int(cols[3]))


def test_merge_and_add_match_jax_package():
    cols, vals = _columns_values(SEED + 1, 60_000, 12)
    half = cols.size // 2
    results = []
    for cls in (jbsi.RoaringBitmapSliceIndex, TBSI):
        a, b = cls(), cls()
        a.set_values((cols[:half], vals[:half]))
        b.set_values((cols[half:], vals[half:] * 3))
        merged = a.clone()
        merged.merge(b)
        summed = a.clone()
        c = cls()
        c.set_values((cols[::2], vals[::2] + 7))
        summed.add(c)
        results.append((merged.serialize(), summed.serialize(), summed.min_value, summed.max_value))
    assert results[0] == results[1]


def test_serialized_bytes_cross_the_packages(pair):
    j, t, *_ = pair
    blob = j.serialize()
    assert t.serialize() == blob
    assert len(blob) == t.serialized_size_in_bytes()
    back = TBSI.deserialize(blob)
    assert back == t and back.serialize() == blob
    assert jbsi.RoaringBitmapSliceIndex.deserialize(t.serialize()).serialize() == blob
    # streams, back to back, and pickling
    buf = io.BytesIO()
    t.serialize_into(buf)
    t.serialize_into(buf)
    buf.seek(0)
    assert TBSI.deserialize_from(buf).serialize() == blob
    assert jbsi.RoaringBitmapSliceIndex.deserialize_from(buf).serialize() == blob
    assert pickle.loads(pickle.dumps(t)).serialize() == blob


def test_mutable_twin_range_queries_match_jax_package(pair):
    j, t, _, vals, jf, tf = pair
    jm, tm = JMutable.deserialize(j.serialize()), TMutable.deserialize(t.serialize())
    assert isinstance(tm, TMutable) and tm.serialize() == jm.serialize()
    med = int(np.median(vals))
    for name in ("range_eq", "range_neq", "range_lt", "range_le", "range_gt", "range_ge"):
        for fs in ((None, None), (jf, tf)):
            want = getattr(jm, name)(fs[0], med)
            assert getattr(tm, name)(fs[1], med).serialize() == want.serialize(), name
    assert tm.range(tf, med // 2, med).serialize() == jm.range(jf, med // 2, med).serialize()
    assert tm.parallel_in(4, TOp.GE, med, 0, tf).serialize() == jm.parallel_in(
        4, jbsi.Operation.GE, med, 0, jf).serialize()
    assert tm.parallel_transpose_with_count(tf).serialize() == jm.parallel_transpose_with_count(
        jf).serialize()
    tm.add_digit(tf, 3)
    jm.add_digit(jf, 3)
    assert tm.serialize() == jm.serialize()
    assert tm.get_long_cardinality() == jm.get_long_cardinality()


def test_device_path_goes_through_the_kernel_wrappers(pair, monkeypatch):
    """The device path calls the wrappers (no launch on CPU tensors); auto
    mode takes it above min_device_cells."""
    _, t, _, vals, _, tf = pair
    calls = []
    real = K.oneil_compare
    monkeypatch.setattr(K, "oneil_compare", lambda *a, **kw: calls.append(a[1].shape) or real(*a, **kw))
    before = dict(K.LAUNCHES)
    med = int(np.median(vals))
    t.compare(TOp.GE, med, 0, None, mode="device")
    t.compare_cardinality_many(TOp.LT, [med, med + 1, 9], mode="device")
    assert [tuple(s) for s in calls] == [(1, 1, t.bit_count()), (3, 1, t.bit_count())]
    assert K.LAUNCHES == before
    monkeypatch.setattr(tbsi.config, "min_device_cells", t.bit_count() * 5)
    t.compare(TOp.GE, med)
    assert len(calls) == 3
    monkeypatch.setattr(tbsi.config, "min_device_cells", t.bit_count() * 5 + 1)
    t.compare(TOp.GE, med)
    assert len(calls) == 3


def test_pack_is_rekeyed_by_a_mutation():
    """The pack lives in the shared pack cache under the members'
    fingerprints: a repeat query hits it, and any mutation (through the
    index or to a slice bitmap directly) re-keys it."""
    cols, vals = _columns_values(SEED + 2, 20_000, 10)
    t = TBSI()
    t.set_values((cols, vals))
    first = t.compare(TOp.EQ, 77, mode="device")
    key = t._pack_key()
    assert key in tstore.PACK_CACHE
    hits = tstore.PACK_CACHE.stats()["kinds"]["bsi"]["hits"]
    t.compare(TOp.EQ, 77, mode="device")
    assert t._pack_key() == key  # a repeat query reuses the pack
    assert tstore.PACK_CACHE.stats()["kinds"]["bsi"]["hits"] == hits + 1
    col = int(cols.max()) + 1  # a fresh column in the ebm's last chunk
    t.set_value(col, 77)
    assert t.compare(TOp.EQ, 77, mode="device").to_array().tolist() == sorted(
        first.to_array().tolist() + [col])
    assert t._pack_key() != key and t._pack_key() in tstore.PACK_CACHE
    key = t._pack_key()
    t.slices[0].add(int(cols[0]))  # a slice touched behind the index's back
    assert t.compare(TOp.EQ, 77, mode="device").serialize() == t.compare(
        TOp.EQ, 77, mode="cpu").serialize()
    assert t._pack_key() != key


def test_cuda_without_a_card_raises(pair, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, t, _, vals, _, tf = pair
    monkeypatch.setattr(tbsi.config, "device", "cuda")
    med = int(np.median(vals))
    with pytest.raises(TierUnavailable):
        t.compare(TOp.GE, med, mode="device")
    with pytest.raises(TierUnavailable):
        t.compare_cardinality_many(TOp.GE, [med], mode="device")
    with pytest.raises(TierUnavailable):
        t.sum(tf, mode="device")
    # auto mode decides by index size only: above the gate it takes the
    # device path and raises here, in the BSI and in RangeBitmap
    monkeypatch.setattr(tbsi.config, "min_device_cells", 1)
    with pytest.raises(TierUnavailable):
        t.compare(TOp.GE, med)
    app = TRange.appender(1000)
    app.add_many(np.arange(1000, dtype=np.uint64))
    rb = app.build()
    with pytest.raises(TierUnavailable):
        rb.gte(500)
    with pytest.raises(TierUnavailable):
        rb.gte_cardinality_many([5, 500])
    assert rb.gte(500, context=TRB(np.arange(600, dtype=np.uint32))).get_cardinality() == 100
    monkeypatch.setattr(tbsi.config, "min_device_cells", 10**9)
    assert rb.gte_cardinality(500) == 500


# ---------------------------------------------------------------------------
# interop
# ---------------------------------------------------------------------------


def _jax_state(bm):
    """The interop state dict read straight out of a JAX-package bitmap."""
    hlc = bm.high_low_container
    kinds, parts, words = [], [], []
    for c in hlc.containers:
        if isinstance(c, JRun):
            pairs = np.empty(2 * c.starts.size, dtype=np.uint16)
            pairs[0::2], pairs[1::2] = c.starts, c.lengths
            kinds.append(2)
            parts.append(pairs)
        elif isinstance(c, JBitmap):
            kinds.append(1)
            parts.append(np.empty(0, dtype=np.uint16))
            words.append(c.words)
        else:
            kinds.append(0)
            parts.append(np.asarray(c.content, dtype=np.uint16))
    return {
        "keys": np.asarray(hlc.keys, dtype=np.uint16),
        "kinds": np.asarray(kinds, dtype=np.uint8),
        "offsets": np.concatenate(([0], np.cumsum([p.size for p in parts]))).astype(np.int64),
        "u16_payload": np.concatenate(parts) if parts else np.empty(0, np.uint16),
        "words": np.stack(words) if words else np.empty((0, 1024), np.uint64),
    }


def test_interop_carries_a_jax_index_across(pair):
    j, _, _, vals, jf, _ = pair
    jr = j.clone()
    jr.run_optimize()
    state = {
        "min_value": jr.min_value,
        "max_value": jr.max_value,
        "run_optimized": jr.run_optimized,
        "ebm": _jax_state(jr.ebm),
        "slices": [_jax_state(s) for s in jr.slices],
    }
    t = interop.bsi_from_state(state)
    assert t.serialize() == jr.serialize()
    med = int(np.median(vals))
    found = TRB(jf.to_array())
    for op in ("GE", "NEQ", "EQ"):
        want = jr.compare(jbsi.Operation[op], med, 0, jf, mode="device")
        assert t.compare(TOp[op], med, 0, found, mode="device").serialize() == want.serialize()
    back = interop.bsi_to_state(t)
    assert back["max_value"] == jr.max_value and back["run_optimized"] is True
    for a, b in zip([back["ebm"], *back["slices"]], [state["ebm"], *state["slices"]]):
        for key in a:
            assert np.array_equal(a[key], b[key])
    m = interop.bsi_from_state(back, cls=TMutable)
    assert isinstance(m, TMutable) and m.serialize() == jr.serialize()


# ---------------------------------------------------------------------------
# RangeBitmap
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def range_pair():
    rng = np.random.default_rng(SEED + 20)
    rows = rng.integers(0, 1 << 20, size=200_000, dtype=np.uint64)
    rows[:3000] = rng.integers(0, 16, size=3000)  # a low-value run for the context
    apps = [JRange.appender(1 << 20), TRange.appender(1 << 20)]
    for app in apps:
        app.add_many(rows[:70_000])
        for v in rows[70_000:70_100].tolist():
            app.add(v)
        app.add_many(rows[70_100:])
    return apps[0].build(), apps[1].build(), rows


def test_range_bitmap_bytes_match_jax_package(range_pair):
    jr, tr, _ = range_pair
    blob = jr.serialize()
    assert tr.serialize() == blob
    assert tr.serialized_size_in_bytes() == len(blob)
    native = jr.serialize(form="native")
    assert tr.serialize(form="native") == native
    # a reference-format map implies max_value = 2^sliceCount - 1, so its
    # native form is compared with the JAX package's map of the same bytes
    for data in (blob, native, pickle.dumps(tr)):
        mapped = pickle.loads(data) if data[:1] == b"\x80" else TRange.map(data)
        jmapped = pickle.loads(pickle.dumps(jr)) if data[:1] == b"\x80" else JRange.map(data)
        for form in (None, "java", "native"):
            assert mapped.serialize(form=form) == jmapped.serialize(form=form), form
    assert JRange.map(tr.serialize()).serialize() == blob


@pytest.mark.parametrize("form", ["heap", "java", "native"])
@pytest.mark.parametrize("engine", ["cpu", "device"])
def test_range_bitmap_queries_match_jax_package(range_pair, form, engine, monkeypatch):
    jr, tr, rows = range_pair
    if form != "heap":  # each package maps the same bytes
        tr = TRange.map(tr.serialize(form=form))
        jr = JRange.map(jr.serialize(form=form))
    # both packages' engines on the same path, so results match container
    # for container (the device path re-compresses to array/bitmap forms)
    monkeypatch.setattr(tbsi.config, "mode", engine)
    monkeypatch.setattr(jbsi.config, "mode", engine)
    context = TRB(np.arange(0, 150_000, 3, dtype=np.uint32))
    jctx = JRB(context.to_array())
    med = int(np.median(rows))
    for v in (0, 7, med, int(rows[9]), (1 << 20) - 1, 1 << 20, 1 << 40):
        for name in ("lt", "lte", "gt", "gte", "eq", "neq"):
            want = getattr(jr, name)(v)
            assert getattr(tr, name)(v).serialize() == want.serialize(), (name, v)
            assert getattr(tr, f"{name}_cardinality")(v) == want.get_cardinality()
            assert getattr(tr, name)(v, context).serialize() == getattr(
                jr, name)(v, jctx).serialize(), (name, v, "context")
    want = jr.between(med // 2, med)
    assert tr.between(med // 2, med).serialize() == want.serialize()
    assert tr.between_cardinality(med // 2, med) == want.get_cardinality()
    assert tr.between(3, 9, context).serialize() == jr.between(3, 9, jctx).serialize()
    qs = [0, 5, med, 1 << 20, 1 << 63]
    for name in ("lt", "lte", "gt", "gte", "eq", "neq"):
        got = getattr(tr, f"{name}_cardinality_many")(qs)
        assert np.array_equal(got, getattr(jr, f"{name}_cardinality_many")(qs)), name
        assert np.array_equal(getattr(tr, f"{name}_cardinality_many")(qs, context),
                              getattr(jr, f"{name}_cardinality_many")(qs, jctx)), name
    his = [q + 100_000 for q in qs]
    assert np.array_equal(tr.between_cardinality_many(qs, his),
                          jr.between_cardinality_many(qs, his))
    rids = np.arange(rows.size)
    assert np.array_equal(tr.gte(med).to_array(), rids[rows >= med])


@pytest.mark.cuda
def test_cuda_index_matches_the_cpu_device_path(pair, monkeypatch):
    """On the card: compare, counts and sum through the CUDA kernels equal
    the same device path on CPU tensors (itself held against the JAX
    package above). Skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    _, t, _, vals, _, tf = pair
    med = int(np.median(vals))
    qs = [int(x) for x in np.quantile(vals, np.linspace(0.05, 0.95, 9))]
    results = {}
    for device in ("cuda", "cpu"):
        monkeypatch.setattr(tbsi.config, "device", device)
        results[device] = (
            [t.compare(TOp[op], med, med + 999, fs, mode="device").serialize()
             for op in OPS for fs in (None, tf)],
            t.compare_cardinality_many(TOp.GE, qs, found_set=tf, mode="device").tolist(),
            t.sum(tf, mode="device"),
        )
    assert results["cuda"] == results["cpu"]

