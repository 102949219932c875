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


# ---------------------------------------------------------------------------
# the eviction-regret ring and the residency reconciliation
# ---------------------------------------------------------------------------


def _recon_ok(recon):
    assert recon["ledger_drift_bytes"] == 0
    assert recon["gauge_bytes"] == recon["ledger_bytes"] == recon["entry_sum_bytes"]


def test_hbm_reconciliation_ledger_agrees():
    """The counterpart of the JAX package's test of the same name: it must
    pass in any order, after any other test of the process."""
    import roaringbitmap_tpu_torch.observe as tobs

    store.PACK_CACHE.close()
    recon0 = store.hbm_reconciliation()
    assert recon0["ledger_drift_bytes"] == 0
    bms = _working_set(seed=17, k=4)
    packed = store.packed_for(bms, device=CPU)
    _ = packed.device_words
    recon = store.hbm_reconciliation()
    assert recon["entries"] >= 1
    _recon_ok(recon)
    drift = tobs.REGISTRY.get(tobs.HBM_ACCOUNTING_DRIFT_BYTES)
    assert drift.get(("ledger",)) == 0
    store.PACK_CACHE.close()
    assert store.hbm_reconciliation()["gauge_bytes"] == 0
    # no card holds an entry: the report has no device keys
    assert not any(k.startswith("device") for k in recon)


def test_ledger_drift_is_zero_after_admit_delta_spill_and_evict():
    from roaringbitmap_tpu_torch.robust import faults

    cache = store.PackCache(max_bytes=1 << 60)
    sets = [_working_set(seed=140 + i, k=3) for i in range(3)]
    packs = [cache.get_packed(s, device=CPU) for s in sets]  # admit
    _recon_ok(store.hbm_reconciliation())
    packs[0].padded_device(0)  # a derived layout grows an entry
    packs[1].padded_buckets_device(0)
    _recon_ok(store.hbm_reconciliation())
    sets[0][0].add((int(sets[0][0].high_low_container.keys[0]) << 16) | 11)
    assert cache.get_packed(sets[0], device=CPU) is packs[0]  # delta
    _recon_ok(store.hbm_reconciliation())
    with faults.inject("pack_cache.budget", every=1, times=1):  # spill
        cache.get_packed(_working_set(seed=150, k=2), device=CPU)
    _recon_ok(store.hbm_reconciliation())
    cache.configure(max_bytes=packs[2].words_nbytes + 1)  # evict
    assert cache.stats()["evictions"] >= 1
    _recon_ok(store.hbm_reconciliation())
    cache.close()
    recon = store.hbm_reconciliation()
    _recon_ok(recon)


@pytest.mark.parametrize("layouts", [False, True])
def test_a_dropped_cache_settles_the_gauge_without_a_collection(layouts):
    """A secondary cache dropped with resident entries (and derived
    layouts, whose residency callbacks point back at it) is freed at once:
    no reference cycle keeps its bytes in the process-wide gauge."""
    import gc

    cache = store.PackCache(max_bytes=1 << 60)
    packed = cache.get_packed(_working_set(seed=160, k=3), device=CPU)
    if layouts:
        packed.padded_device(0)
        packed.padded_buckets_device(0)
    held = store.hbm_reconciliation()
    assert held["ledger_bytes"] >= packed.words_nbytes
    gc_was = gc.isenabled()
    gc.disable()
    try:
        del cache, packed
        recon = store.hbm_reconciliation()
    finally:
        if gc_was:
            gc.enable()
    _recon_ok(recon)
    assert recon["gauge_bytes"] == held["gauge_bytes"] - held["ledger_bytes"] + recon["ledger_bytes"]
    assert not [c for c in store._ALL_CACHES if c is not store.PACK_CACHE and len(c)]


def test_eviction_regret_joins_a_remembered_working_set():
    from roaringbitmap_tpu_torch.observe import decisions, outcomes

    outcomes.reset()
    cache = store.PackCache(max_bytes=1 << 60)
    a, b = _working_set(seed=170, k=2), _working_set(seed=171, k=2)
    pa = cache.get_packed(a, device=CPU)
    cache.get_packed(b, device=CPU)
    cache.configure(max_bytes=pa.words_nbytes + 1)  # evicts a (the LRU)
    evict = [e for e in decisions.decisions() if e["site"] == "pack_cache.evict"][-1]
    assert evict["inputs"]["rung"] == "discard" and evict["inputs"]["kind"] == "agg"
    assert outcomes.LEDGER.pending_count() >= 1
    a[0].add((int(a[0].high_low_container.keys[0]) << 16) | 3)  # a delta-mutated return
    cache.get_packed(a, device=CPU)  # re-pack of the remembered eviction
    joined = [e for e in outcomes.tail() if e["site"] == "pack_cache.evict"]
    assert len(joined) == 1 and joined[0]["engine"] == "repack"
    assert joined[0]["regret_s"] > 0 and joined[0]["seq"] == evict["seq"]
    # a generic entry's eviction joins on its rebuild
    key = ("threshold", "cpu", ("x",))
    cache.get_or_build(key, lambda: ("v", 1 << 40))
    cache.get_or_build(key, lambda: ("v", 1 << 40))  # hit
    cache.get_packed(b, device=CPU)  # an agg entry pushes the big one out
    assert key not in cache
    cache.get_or_build(key, lambda: ("v", 8))
    joined = [e for e in outcomes.tail() if e["site"] == "pack_cache.evict"]
    # b came back too (a's return pushed it out): every agg join re-packed,
    # the generic entry's join rebuilt
    assert [e["engine"] for e in joined] == ["repack", "repack", "rebuild"]
    cache.close()
    outcomes.reset()


def test_the_eviction_is_priced_by_the_learned_repack_cost():
    """Until evict-regret traffic taught the residency curve an eviction
    carries no ``est_us``; after the refit it records the learned re-pack
    cost as ``repack`` and ``rebuild``, and the next join scores it — the
    JAX package's decision inputs, key for key."""
    from roaringbitmap_tpu.cost import residency as jresidency
    from roaringbitmap_tpu_torch.cost import residency as tresidency
    from roaringbitmap_tpu_torch.observe import decisions, outcomes

    outcomes.reset()
    tresidency.MODEL.reset()
    cache = store.PackCache(max_bytes=1 << 60)
    try:
        a, b = _working_set(seed=180, k=2), _working_set(seed=181, k=2)
        pa = cache.get_packed(a, device=CPU)
        cache.get_packed(b, device=CPU)
        cache.configure(max_bytes=pa.words_nbytes + 1)  # evicts a, unpriced
        first = [e for e in decisions.decisions() if e["site"] == "pack_cache.evict"][-1]
        assert "est_us" not in first["inputs"]
        cache.get_packed(a, device=CPU)  # the regret join (b goes)
        report = tresidency.MODEL.refit_from_outcomes()
        assert set(report["moved"]) == {"agg"}
        learned = tresidency.MODEL.repack_estimate("agg")
        assert learned > 0 and tresidency.MODEL.repack_estimate("threshold") is None
        cache.get_packed(b, device=CPU)  # evicts a again, now priced
        priced = [e for e in decisions.decisions() if e["site"] == "pack_cache.evict"][-1]
        est = round(learned * 1e6, 1)
        assert priced["inputs"]["est_us"] == {"repack": est, "rebuild": est}
        assert set(priced["inputs"]) == {"kind", "bytes", "target_bytes", "rung", "est_us"}
        jax_inputs = {"kind", "bytes", "target_bytes", "rung", "est_us"}  # parallel/store.py:2086-2093
        assert set(priced["inputs"]) == jax_inputs
        cache.get_packed(a, device=CPU)  # its return joins against the estimate
        joined = [e for e in outcomes.tail() if e["site"] == "pack_cache.evict"][-1]
        assert joined["seq"] == priced["seq"] and joined["engine"] == "repack"
        assert joined["predicted_us"] == est
        # a second refit folds only the joins since the first (b's and a's
        # returns), as the JAX package's model does on the same ledger
        joins = [e for e in outcomes.tail() if e["site"] == "pack_cache.evict"]
        again = tresidency.MODEL.refit_from_outcomes()
        assert again["samples"] == len(joins) - 1 == 2
        want = jresidency.ResidencyModel()
        want.refit_from_outcomes(joins[:1])
        assert want.refit_from_outcomes(joins) == again
        assert tresidency.MODEL.to_dict()["repack_s"] == want.to_dict()["repack_s"]
    finally:
        cache.close()
        tresidency.MODEL.reset()
        outcomes.reset()


def test_resident_bytes_for_charges_entries_by_their_leaves():
    cache = store.PackCache(max_bytes=1 << 60)
    try:
        a, b = _working_set(seed=190, k=3), _working_set(seed=191, k=2)
        pa = cache.get_packed(a, device=CPU)
        pb = cache.get_packed(b, device=CPU)
        e_a = sum(e.nbytes for e in cache._entries.values() if e.value is pa)
        e_b = sum(e.nbytes for e in cache._entries.values() if e.value is pb)
        fps = lambda bms: {bm.fingerprint() for bm in bms}  # noqa: E731
        assert cache.resident_bytes_for(fps(a)) == e_a > 0
        assert cache.resident_bytes_for(fps(a[:1])) == e_a  # one leaf charges its entry
        assert cache.resident_bytes_for(fps(a) | fps(b)) == e_a + e_b
        assert cache.resident_bytes_for(fps(_working_set(seed=192, k=2))) == 0
        assert cache.resident_bytes_for(set()) == 0
        # an overlapping working set charges a shared entry to each caller
        ab = cache.get_packed(a[:1] + b[:1], device=CPU)
        e_ab = sum(e.nbytes for e in cache._entries.values() if e.value is ab)
        assert cache.resident_bytes_for(fps(a)) == e_a + e_ab
        assert cache.resident_bytes_for(fps(b)) == e_b + e_ab
        # a generic entry whose key embeds a fingerprint tuple
        key = ("threshold", "cpu", tuple(sorted(fps(b))))
        cache.get_or_build(key, lambda: ("v", 4096))
        assert cache.resident_bytes_for(fps(b)) == e_b + e_ab + 4096
    finally:
        cache.close()


def test_the_device_source_is_read_only_when_cuda_is_initialized(monkeypatch):
    import roaringbitmap_tpu_torch.observe as tobs

    cache = store.PackCache(max_bytes=1 << 60)
    packed = cache.get_packed(_working_set(seed=180, k=2), device=CPU)
    fake = torch.device("cuda", 0)
    monkeypatch.setattr(store, "_value_device", lambda value: fake)
    reads = []
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d: reads.append(d) or (3 << 30))
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    recon = store.hbm_reconciliation()
    assert reads == [] and "device_drift_bytes" not in recon
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    recon = store.hbm_reconciliation()
    assert reads == [fake]
    # admitted, its flat rows not built yet: pending, not held
    assert recon["device_resident_bytes"] == 0
    assert recon["device_pending_bytes"] == packed.words_nbytes
    assert recon["device_drift_bytes"] == -(3 << 30)
    _ = packed.device_words
    packed.padded_device(0)
    recon = store.hbm_reconciliation()
    resident = recon["device_resident_bytes"]
    assert resident == recon["ledger_bytes"] > packed.words_nbytes
    assert recon["device_pending_bytes"] == 0
    assert recon["device_drift_bytes"] == resident - (3 << 30) < 0
    assert recon["device_bytes_by_device"] == {"cuda:0": 3 << 30}
    drift = tobs.REGISTRY.get(tobs.HBM_ACCOUNTING_DRIFT_BYTES)
    assert drift.get(("device",)) == recon["device_drift_bytes"]
    cache.close()
    drift.clear()  # the synthetic device source goes with it


def test_a_failed_expansion_shows_as_pending_not_as_drift(monkeypatch):
    """A working set admitted whose device expansion then failed keeps its
    weight in the ledger, but holds no rows: the device side counts it as
    pending, so the drift rule does not read the failure as freed memory."""
    from roaringbitmap_tpu_torch.robust import errors, faults

    monkeypatch.setattr(store.PACK_CACHE, "max_bytes", 2 << 30)
    monkeypatch.setattr(store, "_value_device", lambda value: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d: 1 << 20)
    bms = _working_set(seed=185, k=3)
    with faults.inject("store.expand", errors.ResourceExhausted, every=1):
        with pytest.raises(errors.ResourceExhausted):
            FA.or_(*bms, mode="device", device="cpu")
    (entry,) = store.PACK_CACHE._entries.values()
    recon = store.hbm_reconciliation()
    _recon_ok(recon)
    assert recon["device_pending_bytes"] == entry.nbytes == entry.value.words_nbytes
    assert recon["device_resident_bytes"] == 0 and recon["device_drift_bytes"] == -(1 << 20)
    store.PACK_CACHE.close()
    import roaringbitmap_tpu_torch.observe as tobs

    tobs.REGISTRY.get(tobs.HBM_ACCOUNTING_DRIFT_BYTES).clear()


@pytest.mark.cuda
def test_cuda_reconciliation_with_a_resident_pack(monkeypatch):
    """Phase 17 (a) on the card: with a pack resident on the card the
    ledger drift is 0, the device drift at or below 0 (the card holds more
    than the pack cache), the gauge the entries' bytes; after ``close()``
    the gauge is 0 and the allocator freed at least the bytes released."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    monkeypatch.setattr(aggregation.config, "device", "cuda")
    bms = _working_set(seed=190, k=6)
    FA.or_(*bms, mode="device")
    torch.cuda.synchronize()
    recon = store.hbm_reconciliation()
    _recon_ok(recon)
    assert recon["device_drift_bytes"] <= 0 and recon["device_resident_bytes"] == recon["gauge_bytes"]
    before = torch.cuda.memory_allocated()
    store.PACK_CACHE.close()
    torch.cuda.synchronize()
    after = store.hbm_reconciliation()
    assert after["gauge_bytes"] == 0 and "device_drift_bytes" not in after
    assert before - torch.cuda.memory_allocated() >= recon["gauge_bytes"]


# ---------------------------------------------------------------------------
# the route of the last get_packed, and pins
# ---------------------------------------------------------------------------


def _routes(mod, RB, packed_for, vals):
    """The per-thread route after each step of one script: full, hit,
    delta, a structural change (full), disabled; another thread's calls
    leave this thread's route alone."""
    corpus = [RB(v) for v in vals]
    cache = mod.PACK_CACHE
    cache.close()
    out = []
    packed_for(corpus)
    out.append(cache.last_route())
    packed_for(corpus)
    out.append(cache.last_route())
    hb = int(corpus[0].high_low_container.keys[0])
    corpus[0].add((hb << 16) | 4242)
    corpus[1].add((int(corpus[1].high_low_container.keys[0]) << 16) | 4243)
    packed_for(corpus)
    out.append(cache.last_route())
    box = {}

    def other():
        box["before"] = cache.last_route()
        packed_for([bm.clone() for bm in corpus])
        box["after"] = cache.last_route()

    th = threading.Thread(target=other, daemon=True)
    th.start()
    th.join(30.0)
    out.append((box["before"], box["after"], cache.last_route()))
    corpus[2].add(250 << 16)  # a fresh chunk key: structural, the full route
    packed_for(corpus)
    out.append(cache.last_route())
    budget = cache.max_bytes
    cache.configure(max_bytes=0)
    try:
        packed_for(corpus)
        out.append(cache.last_route())
    finally:
        cache.configure(max_bytes=budget)
    cache.close()
    return out


def test_last_route_per_route_and_per_thread_matches_the_jax_package():
    rng = np.random.default_rng(71)
    vals = [_values(rng) for _ in range(4)]
    got = _routes(store, RoaringBitmap, lambda c: store.packed_for(c, device="cpu"), vals)
    want = _routes(jstore, JRB, jstore.packed_for, vals)
    assert got == want
    assert got[:3] == [("full", 0), ("hit", 0), ("delta", 2)]
    assert got[3] == (None, ("full", 0), ("delta", 2))
    assert got[4:] == [("full", 0), ("disabled", 0)]


def _pins(mod, RB, vals, get, unpin):
    """One pin script on a private cache: (stats, key present) after each
    step — pinned entries survive eviction, pins are a refcount, an unpin
    after a mutation finds the entry by identity, and a pinned entry over
    the budget does not make a new unpinned entry thrash."""
    sets = [[RB(v) for v in vs] for vs in vals]
    cache = mod.PackCache(max_bytes=1 << 60)
    steps = []

    def note(tag, ws=None):
        st = cache.stats()
        steps.append((tag, st["pinned"], st["entries"], st["evictions"],
                      None if ws is None else len(ws) and any(
                          e.fps == tuple(b.fingerprint() for b in ws) for e in cache._entries.values())))

    get(cache, sets[0], pin=True)
    get(cache, sets[1])
    note("pinned+one", sets[0])
    cache.configure(max_bytes=1)
    note("budget 1", sets[0])
    get(cache, sets[0], pin=True)  # a second consumer
    unpin(cache, sets[0])
    note("refcount", sets[0])
    hb = int(sets[0][0].high_low_container.keys[0])
    sets[0][0].add((hb << 16) | 77)  # mutate between pin and unpin
    unpin(cache, sets[0])
    note("unpinned after mutation", sets[0])
    p1 = get(cache, sets[2])
    p2 = get(cache, sets[2])
    note("no thrash", sets[2])
    cache.close()
    note("closed")
    return steps, p1 is p2


def test_pins_match_the_jax_package():
    rng = np.random.default_rng(72)
    vals = [[_values(rng) for _ in range(2)] for _ in range(3)]

    def tget(cache, ws, pin=False):
        return (cache.pin_packed if pin else cache.get_packed)(ws, device="cpu")

    def jget(cache, ws, pin=False):
        return (cache.pin_packed if pin else cache.get_packed)(ws)

    got = _pins(store, RoaringBitmap, vals, tget, lambda c, ws: c.unpin_packed(ws, device="cpu"))
    want = _pins(jstore, JRB, vals, jget, lambda c, ws: c.unpin_packed(ws))
    assert got == want
    steps, same = got
    # under a 1-byte budget the pinned entry stays, and so does the one
    # unpinned survivor the evictor always keeps
    assert steps[0][1:3] == (1, 2) and steps[1][1:3] == (1, 2) and steps[1][4] is True
    assert steps[2][1] == 1 and steps[3][1] == 0
    assert same is True
