"""The port's structure ledger against the JAX package.

The same seeded bitmaps are built in both packages and watched by a
ledger of each; ``stats()`` (format census, actual and size-rule-optimal
serialized bytes, drift ratio, fragmentation p99, accretion depth) must be
equal after the first refresh, after attributed mutations, after a
wholesale ``|=`` and after the full census, and the drift targets must
name the same keys with the same excess bytes.
"""

import numpy as np
import pytest

import roaringbitmap_tpu.observe as jobs
from roaringbitmap_tpu.models.roaring import RoaringBitmap as JRB
from roaringbitmap_tpu.observe import structure as jstructure

import roaringbitmap_tpu_torch.observe as tobs
from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch.observe import structure as tstructure


@pytest.fixture(autouse=True)
def _clean_ledgers():
    tstructure.LEDGER.reset()
    jstructure.LEDGER.reset()
    yield
    tstructure.LEDGER.reset()
    jstructure.LEDGER.reset()


def _values(seed, n=4, card=1500, spread=1 << 18):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        v = rng.choice(spread, card, replace=False)
        if i % 2:  # runs and a dense chunk beside the sparse arrays
            v = np.concatenate([v, np.arange(70000, 70000 + 3000 * (i + 1)),
                                np.arange(200000, 200000 + 6000, 3)])
        out.append(np.unique(v).astype(np.uint32))
    return out


def _both(seed, optimize=False, **kw):
    vals = _values(seed, **kw)
    t, j = [TRB(v) for v in vals], [JRB(v) for v in vals]
    if optimize:
        for bm in t + j:
            bm.run_optimize()
    return t, j


def _stats(ledger, **kw):
    st = ledger.stats()
    st.pop("dirty_refreshed", None)
    return st


def _targets(ledger, bitmaps):
    index = {id(bm): i for i, bm in enumerate(bitmaps)}
    return sorted((index[id(bm)], key, excess) for bm, key, excess in ledger.drift_targets())


def _mutate_both(t, j, fn):
    for bm in t:
        fn(bm, TRB)
    for bm in j:
        fn(bm, JRB)


@pytest.mark.parametrize("seed", [3, 17, 29])
@pytest.mark.parametrize("optimize", [False, True])
def test_stats_after_refresh_match_the_jax_package(seed, optimize):
    t, j = _both(seed, optimize)
    tl, jl = tstructure.StructureLedger(), jstructure.StructureLedger()
    tl.watch("ws", t)
    jl.watch("ws", j)
    got, want = tl.refresh(), jl.refresh()
    assert got == want
    assert got["dirty_refreshed"] == sum(bm.get_container_count() for bm in t)
    assert sum(got["containers"].values()) == got["dirty_refreshed"]
    assert _targets(tl, t) == _targets(jl, j)
    if optimize:
        assert got["drift_ratio"] <= 1.0 and not tl.drift_targets()


@pytest.mark.parametrize("seed", [3, 17])
def test_stats_after_a_mutation_and_a_wholesale_or_match_the_jax_package(seed):
    t, j = _both(seed)
    tl, jl = tstructure.StructureLedger(), jstructure.StructureLedger()
    tl.watch("ws", t)
    jl.watch("ws", j)
    tl.refresh()
    jl.refresh()

    def add_values(bm, cls):
        bm.add(123456)
        bm.add(5)
        bm.remove(int(next(iter(bm))))

    _mutate_both(t, j, add_values)
    got, want = tl.refresh(), jl.refresh()
    assert got == want and got["dirty_refreshed"] <= 3 * len(t)

    def wholesale(bm, cls):
        bm |= cls(np.arange(50000, 58000, dtype=np.uint32))

    _mutate_both(t, j, wholesale)
    got, want = tl.refresh(), jl.refresh()
    assert got == want
    assert got["drift_ratio"] > 1.0
    assert _targets(tl, t) == _targets(jl, j) != []
    # the full census rebuilds the same books the increments kept
    kept = _stats(tl)
    census = tl.census()
    assert census == jl.census()
    census.pop("dirty_refreshed")
    assert census == kept


def test_clean_refresh_measures_nothing_and_one_dirty_key_one_container(monkeypatch):
    t, _ = _both(5)
    ledger = tstructure.StructureLedger()
    ledger.watch("ws", t)
    ledger.refresh()
    calls = []
    real = tstructure._measure
    monkeypatch.setattr(tstructure, "_measure", lambda c: calls.append(1) or real(c))
    assert ledger.refresh()["dirty_refreshed"] == 0 and calls == []
    t[0].add(42)
    assert ledger.refresh()["dirty_refreshed"] == 1 and len(calls) == 1


def test_mark_all_dirty_rescans_and_reconciles_with_the_census():
    t, j = _both(9, n=2)
    tl, jl = tstructure.StructureLedger(), jstructure.StructureLedger()
    tl.watch("ws", t)
    jl.watch("ws", j)
    tl.refresh()
    jl.refresh()
    for bm in (t[0], j[0]):
        bm.high_low_container.mark_all_dirty()
        bm.add(777)
    got, want = tl.refresh(), jl.refresh()
    assert got == want
    census = tl.census()
    census.pop("dirty_refreshed")
    assert census == _stats(tl)


def test_accretion_forget_and_watch_match_the_jax_package():
    t, j = _both(13, n=3)
    results = []
    for mod, bms in ((tstructure, t), (jstructure, j)):
        ledger = mod.StructureLedger()
        ledger.accrete(4)  # nothing watched: no depth
        row = [ledger.stats()["accretion_depth"]]
        ledger.watch("a", bms[:2])
        ledger.watch("b", bms[2:])
        ledger.refresh()
        ledger.accrete(3)
        ledger.accrete(2)
        row.append(ledger.stats())
        ledger.forget("a")
        row.append(ledger.stats())
        ledger.watch("b", bms)  # re-watch replaces the set
        ledger.refresh()
        row.append(ledger.stats())
        ledger.settle_accretion()
        row.append(ledger.stats())
        row.append(ledger.watched())
        results.append(row)
    assert results[0] == results[1]
    assert results[0][1]["accretion_depth"] == 5 and results[0][4]["accretion_depth"] == 0


def _gauges(obs):
    snap = obs.REGISTRY.snapshot()
    out = {}
    for name in (tobs.STRUCTURE_CONTAINERS, tobs.STRUCTURE_DRIFT_RATIO,
                 tobs.STRUCTURE_FRAGMENTATION_COUNT, tobs.STRUCTURE_ACCRETION_COUNT,
                 tobs.STRUCTURE_BYTES):
        out[name] = sorted(
            (tuple(sorted(s["labels"].items())), s["value"]) for s in snap[name]["samples"]
        )
    return out


def test_process_ledger_exports_the_jax_package_gauges():
    t, j = _both(21)
    for mod, bms in ((tstructure, t), (jstructure, j)):
        mod.LEDGER.watch("census", bms)
        mod.LEDGER.refresh()
        mod.LEDGER.accrete(2)
    assert _gauges(tobs) == _gauges(jobs)
    st = tstructure.LEDGER.stats()
    g = _gauges(tobs)
    assert dict((dict(k)["format"], v) for k, v in g[tobs.STRUCTURE_CONTAINERS]) == st["containers"]
    assert g[tobs.STRUCTURE_DRIFT_RATIO] == [((), st["drift_ratio"])]
    assert g[tobs.STRUCTURE_ACCRETION_COUNT] == [((), 2)]
    tstructure.LEDGER.reset()
    assert tobs.REGISTRY.get(tobs.STRUCTURE_ACCRETION_COUNT).get(()) == 0


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_format_census_equals_a_host_count(seed):
    t, _ = _both(seed, n=6)
    ledger = tstructure.StructureLedger()
    ledger.watch("ws", t)
    st = ledger.refresh()
    want = {"array": 0, "bitmap": 0, "run": 0}
    actual = 0
    for bm in t:
        for c in bm.high_low_container.containers:
            want[c.TYPE] += 1
            actual += c.serialized_size()
    assert st["containers"] == want and st["actual_bytes"] == actual
