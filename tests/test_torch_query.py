"""The port's query tier against the JAX package.

The same seeded bitmaps are built in both packages (carried across with
``interop``'s state dicts, so both hold the same container kinds) and the
same expressions are planned and executed in both: nested and/or/xor,
n-ary andnot with an or subtrahend, not over an explicit universe,
threshold with k = 1, 2, N and N+1, and shared subtrees. Under
``mode="cpu"`` and ``mode="device"`` the plans must name the same engines
in the same order, and the results must be the same bitmap, serialized
byte for byte, in both packages; across the two modes the values are the
same, and so are the bytes wherever the JAX package's are. The port's device
path runs on CPU tensors (``aggregation.config.device = "cpu"``), where
each kernel wrapper takes its plain PyTorch version; the JAX package runs
its device path on its CPU backend. Exact everywhere. The ``cuda``-marked
tests at the end run the same on the card and skip without one.
"""

import threading

import numpy as np
import pytest
import torch

from roaringbitmap_tpu import query as jq
from roaringbitmap_tpu.models.container import BitmapContainer as JBitmap
from roaringbitmap_tpu.models.container import RunContainer as JRun
from roaringbitmap_tpu.models.roaring import RoaringBitmap as JRB
from roaringbitmap_tpu.query import kernels as jk

from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch import interop
from roaringbitmap_tpu_torch import query as tq
from roaringbitmap_tpu_torch.ops import kernels as K
from roaringbitmap_tpu_torch.parallel import aggregation, store
from roaringbitmap_tpu_torch.query import kernels as tk
from roaringbitmap_tpu_torch.robust.errors import TierUnavailable

SEED = 0xFEEF1F0
MODES = ("cpu", "device")


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    """The port's device path on CPU tensors; the shared caches emptied
    around each test."""
    monkeypatch.setattr(aggregation.config, "device", "cpu")
    store.PACK_CACHE.close()
    tq.DEFAULT_CACHE.clear()
    yield
    store.PACK_CACHE.close()
    tq.DEFAULT_CACHE.clear()


def _jax_state(jb):
    """The interop state dict read out of a JAX-package bitmap."""
    hlc = jb.high_low_container
    kinds, parts, lens, words = [], [], [], []
    for c in hlc.containers:
        if isinstance(c, JBitmap):
            kinds.append(interop.BITMAP_KIND)
            words.append(np.asarray(c.words, dtype=np.uint64))
            lens.append(0)
        elif isinstance(c, JRun):
            kinds.append(interop.RUN_KIND)
            pay = np.empty(2 * len(c.starts), dtype=np.uint16)
            pay[0::2], pay[1::2] = c.starts, c.lengths
            parts.append(pay)
            lens.append(pay.size)
        else:
            kinds.append(interop.ARRAY_KIND)
            parts.append(np.asarray(c.content, dtype=np.uint16))
            lens.append(len(c.content))
    return {
        "keys": np.asarray(hlc.keys, dtype=np.uint16),
        "kinds": np.asarray(kinds, dtype=np.uint8),
        "offsets": np.concatenate(([0], np.cumsum(lens))).astype(np.int64),
        "u16_payload": np.concatenate(parts) if parts else np.empty(0, np.uint16),
        "words": np.stack(words) if words else np.empty((0, 1024), np.uint64),
    }


def _corpus(seed=SEED, n=14, n_keys=10):
    """Seeded bitmaps of every container kind over ``n_keys`` chunk keys,
    with enough overlap that and/andnot/threshold answers are non-trivial;
    the JAX side is built, a third run-optimized, and carried to the port
    through the state bridge."""
    rng = np.random.default_rng(seed)
    jb = []
    for i in range(n):
        parts = []
        for key in sorted(rng.choice(n_keys, size=int(rng.integers(3, n_keys)), replace=False)):
            shape = int(rng.integers(3))
            if shape == 0:
                lows = rng.choice(4096, size=int(rng.integers(50, 2500)), replace=False)
            elif shape == 1:
                lows = rng.choice(1 << 16, size=int(rng.integers(5000, 30000)), replace=False)
            else:
                starts = rng.choice(np.arange(0, 1 << 16, 256), size=int(rng.integers(1, 30)), replace=False)
                lows = np.concatenate([np.arange(s, s + int(rng.integers(1, 200))) for s in starts])
            parts.append((int(key) << 16) + np.unique(lows).astype(np.int64))
        b = JRB(np.concatenate(parts).astype(np.uint32))
        if i % 3 == 0:
            b.run_optimize()
        jb.append(b)
    tb = [interop.from_state(_jax_state(b)) for b in jb]
    for t, j in zip(tb, jb):
        assert t.serialize() == j.serialize()
    return tb, jb


TB, JB = _corpus()


def _families(Q, L):
    """name -> expression over the leaves L, built the same way in both
    packages."""
    n = len(L)
    shared = Q.and_(Q.or_(L[0], L[1]), L[2])  # a subtree used twice
    return {
        "nested-and-or-xor": Q.xor(Q.and_(Q.or_(*L[:5]), Q.or_(*L[3:9])), Q.or_(L[9], L[10]), L[11]),
        "wide-or": Q.or_(*L),
        "wide-and": Q.and_(*L[:9]),
        "wide-xor": Q.xor(*L[2:12]),
        "andnot-or-subtrahend": Q.andnot(Q.or_(*L[:6]), Q.or_(*L[6:11]), L[12]),
        "andnot-pairwise": Q.andnot(L[0], L[1]),
        "not-universe": Q.not_(Q.or_(L[3], L[4]), Q.or_(*L[:8])),
        "threshold-1": Q.threshold(1, *L[:6]),
        "threshold-2": Q.threshold(2, *L),
        "threshold-3": Q.threshold(3, *L[1:9]),
        "threshold-N": Q.threshold(7, *L[:7]),
        "threshold-N+1": Q.threshold(8, *L[:7]),
        "shared-subtrees": Q.or_(Q.andnot(shared, L[5]), Q.xor(shared, L[6], L[7]), Q.threshold(2, shared, L[8], L[9])),
        "query-benchmark-shape": Q.or_(
            Q.andnot(Q.and_(Q.or_(*L[:5]), Q.or_(*L[5:10])), Q.or_(*L[10:])),
            Q.threshold(2, *L[:6]),
        ),
    }


FAMILIES = list(_families(tq.Q, TB))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("family", FAMILIES)
def test_plan_and_execute_match_the_jax_package(family, mode):
    tqx = _families(tq.Q, TB)[family]
    jqx = _families(jq.Q, JB)[family]
    tp, jp = tq.plan(tqx, mode=mode), jq.plan(jqx, mode=mode)
    assert [(s.engine, s.node.op, s.node.k, len(s.operands)) for s in tp.steps] == [
        (s.engine, s.node.op, s.node.k, len(s.operands)) for s in jp.steps
    ]
    assert [(s.est_card, s.est_rows) for s in tp.steps] == [
        (s.est_card, s.est_rows) for s in jp.steps
    ]
    got = tq.execute(tqx, cache=None, mode=mode)
    want = jq.execute(jqx, cache=None, mode=mode)
    assert got.serialize() == want.serialize()
    assert got == tq.evaluate_naive(tqx)  # the naive fold keeps other container forms


@pytest.mark.parametrize("family", FAMILIES)
def test_cpu_and_device_modes_give_the_same_bitmap(family):
    """The same values under both modes, and the same serialized bytes
    wherever the JAX package's two modes give the same bytes: everywhere
    but where a CPU engine passes a run container through (the pairwise
    difference, a lone container in the OR fold) that the device path
    rebuilds from its words."""
    q = _families(tq.Q, TB)[family]
    cpu = tq.execute(q, cache=None, mode="cpu")
    dev = tq.execute(q, cache=None, mode="device")
    assert cpu == dev
    jqx = _families(jq.Q, JB)[family]
    same_bytes = jq.execute(jqx, cache=None, mode="cpu").serialize() == jq.execute(
        jqx, cache=None, mode="device").serialize()
    assert (cpu.serialize() == dev.serialize()) == same_bytes
    assert same_bytes or family in ("andnot-pairwise", "not-universe")
    engines = [s.engine for s in tq.plan(q, mode="device").steps]
    assert not [e for e in engines if e.endswith("[cpu]") or e in ("pairwise", "workshy-and")]


def test_explain_names_the_device_engines():
    q = _families(tq.Q, TB)["query-benchmark-shape"]
    text = tq.plan(q, mode="device").explain()
    jtext = jq.plan(_families(jq.Q, JB)["query-benchmark-shape"], mode="device").explain()
    for engine in ("device-or", "device-and", "andnot-batch[device]", "threshold-bitsliced[device]"):
        assert f"engine={engine}" in text
    assert text == jtext


def test_rewrites_match_the_jax_package():
    """Hash-consing, De Morgan push-down, difference pull-up and constant
    folds give the same rewritten DAG shape in both packages."""
    def shape(n):
        if n.op == "leaf":
            return "L"
        return (n.op, n.k, tuple(shape(c) for c in n.children))

    for family in FAMILIES:
        tqx, jqx = _families(tq.Q, TB)[family], _families(jq.Q, JB)[family]
        assert shape(tq.rewrite(tqx)) == shape(jq.rewrite(jqx)), family
    a, b = tq.Q.leaf(TB[0]), tq.Q.leaf(TB[1])
    assert (a & b) is (a & b), "hash-consed"
    assert tq.rewrite(tq.Q.not_(a | b, tq.Q.or_(*TB[:4]))).op == "andnot"
    assert tq.rewrite(tq.Q.xor(a, a)).bitmap.is_empty()


# ---------------------------------------------------------------------------
# the kernels, directly
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_andnot_nway_matches_the_jax_package(mode):
    for first, rest in ((0, range(1, 8)), (3, (4,)), (5, range(6, 14)), (2, ())):
        tr = [TB[i] for i in rest]
        jr = [JB[i] for i in rest]
        got = tk.andnot_nway(TB[first], *tr, mode=mode)
        want = jk.andnot_nway(JB[first], *jr, mode=mode)
        assert got.serialize() == want.serialize()
        assert tk.andnot_nway_cardinality(TB[first], *tr, mode=mode) == jk.andnot_nway_cardinality(
            JB[first], *jr, mode=mode) == want.get_cardinality()


@pytest.mark.parametrize("mode", MODES)
def test_threshold_matches_the_jax_package(mode):
    n = len(TB)
    for k in (1, 2, 3, 5, n - 1, n, n + 1):
        got = tk.threshold(k, TB, mode=mode)
        want = jk.threshold(k, JB, mode=mode)
        assert got.serialize() == want.serialize(), k
    # a repeated operand counts with multiplicity
    assert tk.threshold(2, [TB[0], TB[0], TB[1]], mode=mode) == TB[0]


def test_device_threshold_launches_once_per_call_on_its_plain_version():
    """On CPU tensors the wrapper is the plain version and launches
    nothing; the device path reaches it exactly once per call."""
    calls = []
    orig = K.threshold_rows

    def spy(words3, k, n_slices):
        calls.append((tuple(words3.shape), k, n_slices))
        return orig(words3, k, n_slices)

    tk.kernels.threshold_rows = spy
    try:
        before = dict(K.LAUNCHES)
        tk.threshold(3, TB, mode="device")
        tk.threshold(3, TB, mode="device")  # resident pack: still one call each
    finally:
        tk.kernels.threshold_rows = orig
    assert len(calls) == 2 and calls[0] == calls[1]
    g, m, _ = calls[0][0]
    assert calls[0][2] == max(1, m.bit_length())
    assert K.LAUNCHES == before


# ---------------------------------------------------------------------------
# the executor: result cache, in-flight table, deadline
# ---------------------------------------------------------------------------


def test_result_cache_hits_and_is_invalidated_by_a_leaf_mutation():
    tb, _ = _corpus(seed=SEED + 1, n=6)
    q = tq.Q.andnot(tq.Q.or_(*tb[:3]), tb[3]) | tq.Q.threshold(2, *tb)
    cache = tq.ResultCache(max_entries=64)
    first = tq.execute(q, cache=cache, mode="device")
    misses = cache.stats()["misses"]
    again = tq.execute(q, cache=cache, mode="device")
    assert again == first and again is not first  # a private clone
    assert cache.stats()["misses"] == misses and cache.stats()["hits"] >= 1
    tb[0].add((int(tb[0].high_low_container.keys[0]) << 16) | 12345)
    after = tq.execute(q, cache=cache, mode="device")
    assert cache.stats()["misses"] > misses
    assert after == tq.evaluate_naive(q)


def test_warm_query_packs_nothing_for_steps_over_leaves():
    """With the result cache off, a repeated query's steps over leaves hit
    their resident packs; a step over other steps' results packs anew (its
    operands are new bitmaps). An andnot packs its subtrahends alone, so
    one over leaves hits whatever its minuend."""
    tb, _ = _corpus(seed=SEED + 2, n=8)
    q = tq.Q.andnot(tq.Q.and_(tq.Q.or_(*tb[:4]), tq.Q.or_(*tb[4:])), *tb[2:6]) | tq.Q.threshold(2, *tb)
    p = tq.plan(q, mode="device")

    def packed(s):
        return s.operands[1:] if s.node.op == "andnot" else s.operands

    assert any(s.node.op == "andnot" and s.operands[0].op != "leaf" for s in p.steps)
    over_results = sum(1 for s in p.steps if any(o.op != "leaf" for o in packed(s)))
    over_leaves = len(p.steps) - over_results
    tq.execute(q, cache=None, mode="device")
    before = store.PACK_CACHE.stats()
    assert tq.execute(q, cache=None, mode="device") == tq.evaluate_naive(q)
    after = store.PACK_CACHE.stats()
    assert after["misses"] - before["misses"] == over_results
    assert after["hits"] - before["hits"] == over_leaves


def _holds(x, fp) -> bool:
    return x == fp or (isinstance(x, tuple) and any(_holds(y, fp) for y in x))


def _andnot_kind():
    st = store.PACK_CACHE.stats()["kinds"].get("andnot", {"hits": 0, "misses": 0})
    return st["hits"], st["misses"]


def test_no_resident_pack_is_keyed_by_an_andnot_minuend(monkeypatch):
    """After the benchmark-shaped query, with and without the result
    cache, no resident entry's key or packed fingerprints hold the
    fingerprint of any minuend the device andnot saw; the repeats hit the
    subtrahends' pack."""
    minuends = []
    real = tk._device_andnot_stage

    def spy(first, rest, covered_keys):
        minuends.append(first.fingerprint())
        return real(first, rest, covered_keys)

    monkeypatch.setattr(tk, "_device_andnot_stage", spy)
    q = _families(tq.Q, TB)["query-benchmark-shape"]
    h0, m0 = _andnot_kind()
    for cache in (None, None, tq.ResultCache()):
        assert tq.execute(q, cache=cache, mode="device") == tq.evaluate_naive(q)
    assert len(minuends) == 3 and _andnot_kind() == (h0 + 2, m0 + 1)
    for e in store.PACK_CACHE._entries.values():
        assert not any(_holds(e.key, fp) or _holds(e.fps or (), fp) for fp in minuends)


def test_a_planned_union_and_the_folded_andnot_share_the_subtrahend_pack():
    """The planner orders C's leaves alike in the union step ``or(C)`` of
    one query and in the andnot that folds ``x \\ or(C)`` into them in
    another, so both key one pack: the andnot's lookup hits what the
    union left resident, and no andnot entry is added."""
    L = [tq.Q.leaf(b) for b in TB]
    union = tq.Q.or_(*L[10:])
    assert tq.execute(union, cache=None, mode="device") == tq.evaluate_naive(union)
    entries, (h0, m0) = list(store.PACK_CACHE._entries), _andnot_kind()
    q = tq.Q.andnot(tq.Q.and_(tq.Q.or_(*L[:5]), tq.Q.or_(*L[5:10])), union)
    assert tq.execute(q, cache=None, mode="device") == tq.evaluate_naive(q)
    assert _andnot_kind() == (h0 + 1, m0)
    assert set(entries) <= set(store.PACK_CACHE._entries)
    assert not [k for k in store.PACK_CACHE._entries if k[0] == "andnot"]


def test_fused_andnots_over_shared_subtrahends_match_and_share_one_pack(monkeypatch):
    """The fusion window's merged andnot calls the same union stage: two
    andnots with different minuends over the same subtrahends are one
    ``pair_rows_reduce`` launch, the JAX package's bytes and the CPU
    path's values, over one subtrahend pack built once."""
    firsts, rest = (0, 13), list(range(5, 9))
    tl, jl = [tq.Q.leaf(b) for b in TB], [jq.Q.leaf(b) for b in JB]
    qs = [tq.Q.andnot(tl[i], *[tl[r] for r in rest]) for i in firsts]
    jqs = [jq.Q.andnot(jl[i], *[jl[r] for r in rest]) for i in firsts]
    n_rows = sum(TB[r].get_container_count() for r in rest)
    for i in firsts:  # both take the shared route
        assert 2 * tk._covered(TB[i], [TB[r] for r in rest])[1] >= n_rows
    calls = []
    real = K.pair_rows_reduce

    def counted(*args):
        calls.append(args[4])
        return real(*args)

    monkeypatch.setattr(K, "pair_rows_reduce", counted)
    h0, m0 = _andnot_kind()
    got = tq.execute_fused(qs, cache=None, mode="device")
    assert calls == ["andnot"] and _andnot_kind() == (h0 + 1, m0 + 1)
    want = jq.execute_fused(jqs, cache=None, mode="device")
    for g, w, q in zip(got, want, qs):
        assert g.serialize() == w.serialize()
        assert g == tq.execute(q, cache=None, mode="cpu")
    for i in firsts:
        fp = TB[i].fingerprint()
        assert not any(_holds(e.key, fp) or _holds(e.fps or (), fp)
                       for e in store.PACK_CACHE._entries.values())


def test_mutated_leaf_takes_the_delta_route():
    tb, _ = _corpus(seed=SEED + 3, n=8)
    q = tq.Q.or_(*tb[:5]) - tb[6]
    cache = tq.ResultCache()
    tq.execute(q, cache=cache, mode="device")
    d0 = store.PACK_CACHE.delta_rows
    agg0 = store.PACK_CACHE.stats()["kinds"]["agg"]
    # the largest leaf stays last in the cost order after one more value
    big = max(tb[:5], key=lambda b: b.get_cardinality())
    hb = int(big.high_low_container.keys[0])
    v = next(x for x in range(hb << 16, (hb + 1) << 16) if not big.contains(x))
    big.add(v)
    assert tq.execute(q, cache=cache, mode="device") == tq.evaluate_naive(q)
    assert store.PACK_CACHE.delta_rows - d0 == 1
    agg1 = store.PACK_CACHE.stats()["kinds"]["agg"]
    assert agg1["misses"] == agg0["misses"] and agg1["hits"] == agg0["hits"] + 1


def test_inflight_stale_and_abort_under_two_threads():
    """A joiner waits for the owner; a stale completion (a leaf mutated
    mid-computation) and an aborted one both hand it None, so it
    recomputes; a valid completion hands it the owner's value."""
    table = tq.InflightTable(join_timeout_s=10)
    for outcome in ("valid", "stale", "abort"):
        key = ("node", outcome)
        owner, entry = table.begin(key)
        assert owner
        got = []
        ready = threading.Event()

        def joiner():
            is_owner, pending = table.begin(key)
            ready.set()
            got.append((is_owner, table.join(pending)))

        t = threading.Thread(target=joiner)
        t.start()
        assert ready.wait(10)
        if outcome == "abort":
            table.abort(key, entry)
        else:
            table.complete(key, entry, "bits", valid=outcome == "valid")
        t.join(10)
        assert got == [(False, "bits" if outcome == "valid" else None)]
        assert table.pending_count() == 0
    assert table.stats() == {"leads": 3, "joins": 3, "stale": 1, "pending": 0}


def test_concurrent_identical_queries_agree():
    tb, _ = _corpus(seed=SEED + 4, n=8)
    q = tq.Q.threshold(2, *tb) - tq.Q.or_(tb[0], tb[1])
    want = tq.evaluate_naive(q)
    cache = tq.ResultCache()
    out, errors = [], []
    barrier = threading.Barrier(4)

    def run():
        try:
            barrier.wait(10)
            out.append(tq.execute(q, cache=cache, mode="device"))
        except Exception as e:  # surfaced via the assert below
            errors.append(repr(e))

    threads = [threading.Thread(target=run) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(out) == 4 and all(r == want for r in out)
    assert tq.INFLIGHT.pending_count() == 0


def test_expired_deadline_routes_the_remaining_steps_to_the_cpu():
    tb, _ = _corpus(seed=SEED + 5, n=8)
    q = tq.Q.andnot(tq.Q.or_(*tb[:4]), *tb[4:]) | tq.Q.threshold(2, *tb)
    before = store.PACK_CACHE.stats()
    got = tq.execute(q, cache=None, mode="device", deadline_s=0.0)
    assert got == tq.evaluate_naive(q)
    after = store.PACK_CACHE.stats()
    assert (after["hits"], after["misses"]) == (before["hits"], before["misses"])
    # with time left the same plan runs on the device path
    tq.execute(q, cache=None, mode="device", deadline_s=3600)
    assert store.PACK_CACHE.stats()["misses"] > before["misses"]


def test_cardinality_model_refits_from_explicit_samples():
    from roaringbitmap_tpu.query.plan import CardinalityModel as JModel
    from roaringbitmap_tpu_torch.query.plan import CardinalityModel

    samples = [{"op": "and", "est_card": 1000, "actual": 250}] * 5 + [
        {"op": "or", "est_card": 10, "actual": 0},  # rejected: not positive
        {"op": "xor", "est_card": 1, "actual": 2 ** 30},  # rejected: poisoned ratio
    ]
    m, jm = CardinalityModel(), JModel()
    assert m.corrections == {op: 1.0 for op in m.OPS}
    rep, jrep = m.refit_from_outcomes(samples), jm.refit_from_outcomes(samples)
    assert rep["moved"] == jrep["moved"] and rep["rejected"] == jrep["rejected"] == 2
    assert m.corrected("and", 1000) == jm.corrected("and", 1000) == 250
    assert CardinalityModel().from_dict(m.to_dict())
    m.reset()
    assert m.provenance == "default"


def test_cuda_execute_without_a_card_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.setattr(aggregation.config, "device", "cuda")
    q = tq.Q.threshold(2, *TB)
    with pytest.raises(TierUnavailable):
        tq.execute(q, cache=None, mode="device")
    assert tq.execute(q, cache=None, mode="cpu") == tq.evaluate_naive(q)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("family", FAMILIES)
def test_cuda_execute_matches_the_cpu_device_path(family, monkeypatch):
    """On the card: ``execute`` through the CUDA kernels equals the same
    device path on CPU tensors (itself held against the JAX package
    above), with one ``rb_threshold`` launch per device threshold step.
    Skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    q = _families(tq.Q, TB)[family]
    want = tq.execute(q, cache=None, mode="device")
    monkeypatch.setattr(aggregation.config, "device", "cuda")
    p = tq.plan(q, mode="device")
    before = K.LAUNCHES["rb_threshold"]
    got = tq.execute(p, cache=None, mode="device")
    assert got.serialize() == want.serialize()
    thresholds = [s for s in p.steps if s.engine == "threshold-bitsliced[device]"]
    assert K.LAUNCHES["rb_threshold"] - before == len(thresholds)
