"""The port's resident pack cache against the JAX package and on its own.

Warm hits, delta repacks whose rows are exactly the dirty containers,
full repacks on structural changes, the byte-budget LRU, ``get_or_build``
keys, the BSI pack's residency and the default budget. The device path
runs on CPU tensors (``aggregation.config.device = "cpu"``), where every
kernel wrapper takes its plain PyTorch version; the packs are compared
row for row with a fresh pack and with the JAX package's pack of the same
bitmaps. Exact everywhere.
"""

import os
import threading

import numpy as np
import pytest
import torch

from roaringbitmap_tpu.models.roaring import RoaringBitmap as JRB
from roaringbitmap_tpu.parallel import store as jstore

from roaringbitmap_tpu_torch import FastAggregation as FA
from roaringbitmap_tpu_torch import Operation, RoaringBitmapSliceIndex
from roaringbitmap_tpu_torch import RoaringBitmap
from roaringbitmap_tpu_torch.models import bsi as tbsi
from roaringbitmap_tpu_torch.parallel import aggregation
from roaringbitmap_tpu_torch.parallel import store
from roaringbitmap_tpu_torch.query import kernels as qk
from roaringbitmap_tpu_torch.serialization import read_into

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    """The device path on CPU tensors; the shared cache emptied after each
    test."""
    monkeypatch.setattr(aggregation.config, "device", "cpu")
    monkeypatch.setattr(tbsi.config, "device", "cpu")
    store.PACK_CACHE.close()
    yield
    store.PACK_CACHE.close()


def _values(rng, n=2000, spread=1 << 18):
    return np.sort(rng.choice(spread, size=n, replace=False)).astype(np.uint32)


def _working_set(seed=7, k=5):
    rng = np.random.default_rng(seed)
    return [RoaringBitmap(_values(rng)) for _ in range(k)]


def _kind(kind="agg"):
    st = store.PACK_CACHE.stats()["kinds"].get(kind, {"hits": 0, "misses": 0})
    return st["hits"], st["misses"]


def _rows(packed) -> np.ndarray:
    return packed.device_words.numpy().view(np.uint32)


def _fresh(bitmaps, keys_filter=None):
    return store.pack_groups(store.group_by_key(bitmaps, keys_filter), CPU)


def _same_pack(got, want):
    assert np.array_equal(got.group_keys, want.group_keys)
    assert np.array_equal(got.group_offsets, want.group_offsets)
    assert np.array_equal(_rows(got), _rows(want))


# ---------------------------------------------------------------------------
# warm hits
# ---------------------------------------------------------------------------


def test_repeated_wide_or_zero_host_packs():
    bms = _working_set(seed=1)
    want = FA.naive_or(*bms)
    assert FA.or_(*bms, mode="device") == want
    h0, m0 = _kind()
    for _ in range(3):
        assert FA.or_(*bms, mode="device") == want
    assert _kind() == (h0 + 3, m0), "every repeat is served resident, none packs"


def test_or_xor_and_cardinality_share_one_entry():
    bms = _working_set(seed=2)
    FA.or_(*bms, mode="device")
    h0, m0 = _kind()
    assert FA.xor(*bms, mode="device") == FA.naive_xor(*bms)
    assert FA.or_cardinality(*bms, mode="device") == FA.naive_or(*bms).get_cardinality()
    FA.xor_cardinality(*bms, mode="device")
    assert _kind() == (h0 + 3, m0)
    assert len(store.PACK_CACHE) == 1


def test_and_uses_separate_filtered_entry():
    bms = _working_set(seed=3)
    FA.or_(*bms, mode="device")
    _, m0 = _kind()
    want = FA.naive_and(*bms)
    assert FA.and_(*bms, mode="device") == want
    h1, m1 = _kind()
    assert m1 == m0 + 1, "AND packs the key-intersection layout as its own entry"
    assert FA.and_(*bms, mode="device") == want
    assert _kind() == (h1 + 1, m1)


def test_pack_matches_the_jax_package_pack():
    """The same seeded bitmaps packed by both packages: identical group
    keys, offsets and rows, before and after a delta repack."""
    rng = np.random.default_rng(5)
    vals = [_values(rng, n=int(rng.integers(500, 4000))) for _ in range(6)]
    tb, jb = [RoaringBitmap(v) for v in vals], [JRB(v) for v in vals]
    jcache = jstore.PackCache(max_bytes=1 << 40)
    # the shared cache's counters outlive close(): read them as deltas
    delta0 = store.PACK_CACHE.delta_rows
    for step in range(2):
        got = store.packed_for(tb, device=CPU)
        want = jcache.get_packed(jb)
        assert np.array_equal(got.group_keys, want.group_keys)
        assert np.array_equal(got.group_offsets, want.group_offsets)
        assert np.array_equal(_rows(got), np.asarray(want.words))
        for b in (tb[1], jb[1]):  # one container of one bitmap, existing key
            b.add((int(b.high_low_container.keys[0]) << 16) | 4321)
    assert store.PACK_CACHE.delta_rows - delta0 == 1 and jcache.delta_rows == 1
    jcache.close()


# ---------------------------------------------------------------------------
# delta repacks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flat_resident", [True, False])
def test_delta_rows_equal_dirty_containers(flat_resident):
    """k mutated containers re-pack exactly k rows, and the refreshed pack
    equals a fresh one — whether the flat rows were on the device at the
    mutation (patched in place) or not yet (expanded later with the row
    overrides)."""
    bms = _working_set(seed=4, k=8)
    packed = store.packed_for(bms, device=CPU)
    if flat_resident:
        before = packed.device_words
        assert FA.or_(*bms, mode="device") == FA.naive_or(*bms)
        assert packed.padded_device(0) is not None
    k = 3
    for bm in bms[:k]:  # one container each, existing chunk keys
        hb = int(bm.high_low_container.keys[0])
        bm.add((hb << 16) | 54321)
    h0, m0 = _kind()
    d0 = store.PACK_CACHE.delta_rows
    got = store.packed_for(bms, device=CPU)
    assert got is packed
    assert _kind() == (h0 + 1, m0), "a delta refresh counts as a hit"
    assert store.PACK_CACHE.delta_rows - d0 == k
    assert packed._padded_cache == {}, "derived layouts drop with the delta"
    _same_pack(got, _fresh(bms))
    if flat_resident:
        assert got.device_words is before, "the resident rows are patched in place"
    assert FA.or_(*bms, mode="device") == FA.naive_or(*bms)


@pytest.mark.parametrize("seed", range(6))
def test_delta_equals_full_repack_differential(seed):
    """Mixed in-place edits and structural changes: after every step the
    cached pack equals a from-scratch pack, and only structural steps
    repack in full."""
    rng = np.random.default_rng(100 + seed)
    bms = _working_set(seed=200 + seed, k=6)
    store.packed_for(bms, device=CPU).device_words
    for _ in range(8):
        bm = bms[int(rng.integers(len(bms)))]
        keys = list(bm.high_low_container.keys)
        kind = int(rng.integers(3))
        _, m0 = _kind()
        if kind == 0:  # add into an existing key
            bm.add((int(keys[int(rng.integers(len(keys)))]) << 16) | int(rng.integers(1 << 16)))
        elif kind == 1:  # remove one value (its container may empty)
            bm.remove(int(bm.to_array()[int(rng.integers(bm.get_cardinality()))]))
        else:  # a brand-new chunk key: structural
            bm.add((int(rng.integers(40, 60)) << 16) | 7)
        structural = bm.high_low_container.keys != keys
        got = store.packed_for(bms, device=CPU)
        _same_pack(got, _fresh(bms))
        assert _kind()[1] == m0 + int(structural)


def test_structural_mutation_forces_full_repack():
    bms = _working_set(seed=5)
    FA.or_(*bms, mode="device")
    bms[0].add((300 << 16) | 1)  # brand-new chunk key
    h0, m0 = _kind()
    assert FA.or_(*bms, mode="device") == FA.naive_or(*bms)
    assert _kind() == (h0, m0 + 1)


def test_wholesale_deserialize_forces_full_repack():
    bms = _working_set(seed=6)
    FA.or_(*bms, mode="device")
    read_into(bms[0], bms[1].serialize())  # rebinds without key attribution
    h0, m0 = _kind()
    assert FA.or_(*bms, mode="device") == FA.naive_or(*bms)
    assert _kind() == (h0, m0 + 1)


def test_and_intersection_change_forces_full_repack():
    rng = np.random.default_rng(11)
    a = RoaringBitmap(np.arange(4000, dtype=np.uint32))
    for key in (1, 2, 3, 9):
        a.add_many(((np.arange(50) * 7) + (key << 16)).astype(np.uint32))
    b = RoaringBitmap(np.concatenate(
        [(rng.choice(1 << 16, 200, replace=False) + (k << 16)) for k in range(4)]
    ).astype(np.uint32))
    cache = store.PackCache(max_bytes=1 << 30)
    keys = store.intersect_keys([a, b])
    p1 = cache.get_packed([a, b], keys, CPU)
    b.add((9 << 16) | 5)  # the intersection grows
    keys2 = store.intersect_keys([a, b])
    assert keys2 != keys
    p2 = cache.get_packed([a, b], keys2, CPU)
    _same_pack(p2, _fresh([a, b], keys2))
    assert cache.stats()["misses"] == 2 and p1 is not p2
    cache.close()


# ---------------------------------------------------------------------------
# budget, eviction, lifetime
# ---------------------------------------------------------------------------


def test_byte_budget_evicts_in_lru_order():
    sets = [_working_set(seed=20 + i, k=2) for i in range(3)]
    cache = store.PackCache(max_bytes=1 << 60)
    packs = [cache.get_packed(s, device=CPU) for s in sets]
    per_entry = packs[0].words_nbytes
    cache.get_packed(sets[0], device=CPU)  # touch set 0: set 1 becomes LRU
    cache.configure(max_bytes=int(per_entry * 2.5))
    st = cache.stats()
    assert st["entries"] == 2 and st["evictions"] == 1
    keys = [("agg", "all", "cpu", tuple(b.fingerprint() for b in s)) for s in sets]
    assert keys[0] in cache and keys[2] in cache and keys[1] not in cache
    assert packs[1]._device_words is None and not packs[1]._cache_held
    cache.close()
    assert len(cache) == 0 and cache.stats()["bytes"] == 0


def test_budget_counts_lazily_built_device_layouts():
    bms = _working_set(seed=36, k=3)
    cache = store.PackCache(max_bytes=1 << 60)
    packed = cache.get_packed(bms, device=CPU)
    base = cache.stats()["bytes"]
    assert base == packed.words_nbytes == packed.n_rows * 8192
    _ = packed.device_words  # the flat rows are the base weight
    assert cache.stats()["bytes"] == base
    padded = packed.padded_device(0)
    assert cache.stats()["bytes"] == base + padded.numel() * 4
    # a delta drops the derived layouts and their bytes
    bms[0].add((int(bms[0].high_low_container.keys[0]) << 16) | 9)
    assert cache.get_packed(bms, device=CPU) is packed
    assert cache.stats()["bytes"] == base
    # growth past the budget evicts colder entries
    packed.padded_device(0)
    other = cache.get_packed(_working_set(seed=37, k=2), device=CPU)
    cache.configure(max_bytes=cache.stats()["bytes"] - 1)
    assert cache.stats()["entries"] == 1 and other._cache_held
    cache.close()
    assert cache.stats()["bytes"] == 0


def test_single_oversized_entry_is_kept_not_thrashed():
    bms = _working_set(seed=34, k=2)
    cache = store.PackCache(max_bytes=1)
    p1 = cache.get_packed(bms, device=CPU)
    assert cache.get_packed(bms, device=CPU) is p1
    st = cache.stats()
    assert st["entries"] == 1 and st["hits"] == 1
    cache.get_packed(_working_set(seed=35, k=2), device=CPU)  # displaces it
    assert cache.stats()["entries"] == 1 and not p1._cache_held
    cache.close()


def test_disabled_cache_always_packs_fresh():
    cache = store.PackCache(max_bytes=0)
    bms = _working_set(seed=33, k=2)
    p1 = cache.get_packed(bms, device=CPU)
    p2 = cache.get_packed(bms, device=CPU)
    assert p1 is not p2 and len(cache) == 0 and cache.stats()["misses"] == 2
    _same_pack(p1, p2)
    p1.close()  # uncached packs are consumer-owned: close really frees
    assert p1._device_words is None


def test_close_while_cached_is_noop_and_eviction_really_closes():
    cache = store.PackCache(max_bytes=1 << 60)
    bms = _working_set(seed=40, k=2)
    packed = cache.get_packed(bms, device=CPU)
    _ = packed.device_words
    packed.close()  # the cache owns lifetime: a consumer's close is a no-op
    assert packed._device_words is not None
    assert cache.get_packed(bms, device=CPU) is packed
    cache.close()  # the owner's close frees for real
    assert packed._device_words is None
    packed.close()  # idempotent
    assert packed.device_words is not None  # usable again, rebuilt on touch


def test_get_or_build_keys_and_discard():
    cache = store.PackCache(max_bytes=1 << 30)
    calls = []

    def build(tag):
        def b():
            calls.append(tag)
            return torch.zeros(4, dtype=torch.int32), 16
        return b

    key = ("bsi", (1, 0), ((2, 0),), "cpu")
    v1 = cache.get_or_build(key, build("a"))
    assert cache.get_or_build(key, build("b")) is v1, "exact key: hit"
    cache.get_or_build(("bsi", (1, 1), ((2, 0),), "cpu"), build("c"))  # moved version
    assert calls == ["a", "c"]
    assert cache.stats()["kinds"]["bsi"] == {"hits": 1, "misses": 2}
    cache.discard(key)
    assert key not in cache and len(cache) == 1
    cache.close()


def test_default_budget(monkeypatch):
    """Unset: 2 GiB for a CPU entry, a quarter of the card's memory for a
    CUDA one, resolved at the first store; RB_TPU_PACK_CACHE_BYTES wins."""
    cache = store.PackCache()
    if "RB_TPU_PACK_CACHE_BYTES" not in os.environ:
        assert cache.max_bytes is None
        cache.get_packed(_working_set(seed=44, k=2), device=CPU)
        assert cache.max_bytes == store.DEFAULT_HOST_BUDGET == 2 << 30
    cache.close()

    class Props:
        total_memory = 85_520_809_984

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: Props)
    assert store.default_budget(torch.device("cuda")) == Props.total_memory // 4
    monkeypatch.setenv("RB_TPU_PACK_CACHE_BYTES", "12345")
    assert store.PackCache().max_bytes == 12345
    monkeypatch.setenv("RB_TPU_PACK_CACHE_BYTES", "0")
    assert store.PackCache()._disabled()


# ---------------------------------------------------------------------------
# the other consumers: BSI, query kernels
# ---------------------------------------------------------------------------


def test_bsi_pack_rides_shared_cache():
    rng = np.random.default_rng(50)
    cols = np.sort(rng.choice(1 << 17, size=3000, replace=False)).astype(np.uint32)
    vals = (cols.astype(np.int64) * 31) % 1000
    b = RoaringBitmapSliceIndex()
    b.set_values((cols, vals))
    want = b.compare(Operation.GE, 500, 0, None, mode="cpu")
    assert b.compare(Operation.GE, 500, 0, None, mode="device") == want
    k = b.ebm.get_container_count()
    assert store.PACK_CACHE.stats()["bytes"] == (b.bit_count() + 1) * k * 8192
    h0, m0 = _kind("bsi")
    assert b.compare(Operation.LT, 200, 0, None, mode="device") == b.compare(
        Operation.LT, 200, 0, None, mode="cpu")
    assert _kind("bsi") == (h0 + 1, m0), "the second compare reuses the pack"
    b.set_value(int(cols[0]), 999)  # a mutation re-keys: a miss, never stale
    assert b.compare(Operation.GE, 500, 0, None, mode="device") == b.compare(
        Operation.GE, 500, 0, None, mode="cpu")
    assert _kind("bsi") == (h0 + 1, m0 + 1)


def test_andnot_kernel_pack_reuse():
    rng = np.random.default_rng(61)
    first, r1, r2 = (RoaringBitmap(_values(rng)) for _ in range(3))
    want = qk.andnot_nway(first, r1, r2, mode="cpu")
    assert qk.andnot_nway(first, r1, r2, mode="device") == want
    h0, m0 = _kind("andnot")
    assert qk.andnot_nway(first, r1, r2, mode="device") == want
    assert qk.andnot_nway_cardinality(first, r1, r2, mode="device") == want.get_cardinality()
    assert _kind("andnot") == (h0 + 2, m0)


def test_threshold_skew_fallback_leaves_no_resident_entry():
    rng = np.random.default_rng(47)
    bms = []
    for i in range(24):  # one 24-row key group + 199 of 2 rows: too skewed to pad
        parts = [rng.choice(1 << 16, 300, replace=False).astype(np.uint32)]
        if i < 2:
            for key in range(1, 200):
                parts.append((rng.choice(1 << 16, 300, replace=False) + (key << 16)).astype(np.uint32))
        bms.append(RoaringBitmap(np.concatenate(parts)))
    want = qk.threshold(2, bms, mode="cpu")
    assert want.get_container_count() > 100
    h0, m0 = _kind("threshold")
    assert qk.threshold(2, bms, mode="device") == want
    assert _kind("threshold") == (h0, m0 + 1)
    assert not [k for k in store.PACK_CACHE._entries if k[0] == "threshold"]


def test_pack_cache_hammer_threadsafe():
    sets = [_working_set(seed=70 + i, k=3) for i in range(4)]
    wants = [_rows(_fresh(s)) for s in sets]
    cache = store.PackCache(max_bytes=1 << 60)
    errors = []
    barrier = threading.Barrier(8)

    def work(i):
        try:
            barrier.wait(timeout=10)
            for j in range(20):
                si = (i + j) % len(sets)
                if not np.array_equal(_rows(cache.get_packed(sets[si], device=CPU)), wants[si]):
                    errors.append((i, j, si))
        except Exception as e:  # surfaced via the assert below
            errors.append(repr(e))

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    st = cache.stats()
    assert st["hits"] + st["misses"] == 8 * 20 and st["entries"] == len(sets)
    cache.close()
