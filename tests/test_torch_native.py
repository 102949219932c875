"""The port's native host tier against its numpy tier and the JAX package's.

Every entry point of ``roaringbitmap_tpu_torch/native`` gets the same
seeded inputs on three sides: the port's native tier (on each binding
that serves the entry point, the extension and ``ctypes``), the port's
plain numpy versions (``utils/bits.py``'s ``*_numpy`` and
``columnar/kernels.py``'s ``*_numpy``), and the JAX package's native
module. Results must be exact. The cases are those of the JAX package's
``tests/test_native.py`` plus every batch entry point, with the empty,
single-value, full-container and 4096/4097-value edges. Then: the loaded
libraries are the port's own builds, a failed build raises and leaves no
numpy tier in place, the tier setting rebinds every dispatched name, and
the routed and/andnot of run-optimized census pairs give the JAX
package's bytes with both packages on their default (native) tier.
"""

import os
import re
from pathlib import Path

import numpy as np
import pytest

from roaringbitmap_tpu import native as jnative
from roaringbitmap_tpu.columnar import costmodel as jcost
from roaringbitmap_tpu.models.roaring import RoaringBitmap as JRB
from roaringbitmap_tpu.parallel import store as jstore

from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch import native
from roaringbitmap_tpu_torch.columnar import costmodel as tcost
from roaringbitmap_tpu_torch.columnar import engine as tengine
from roaringbitmap_tpu_torch.columnar import kernels as ck
from roaringbitmap_tpu_torch.models import container as tcontainer
from roaringbitmap_tpu_torch.models.container import RunContainer
from roaringbitmap_tpu_torch.parallel import aggregation, store
from roaringbitmap_tpu_torch.robust.errors import TierUnavailable
from roaringbitmap_tpu_torch.utils import bits, datasets

PORT_DIR = Path(native.__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    """The device path on CPU tensors, the port on its default (native)
    host tier, cost models uncalibrated, no resident packs left behind."""
    monkeypatch.setattr(aggregation.config, "device", "cpu")
    native.set_tier("native")
    tcost.MODEL.reset()
    jcost.MODEL.reset()
    store.PACK_CACHE.close()
    yield
    native.set_tier("native")
    tcost.MODEL.reset()
    jcost.MODEL.reset()
    store.PACK_CACHE.close()
    jstore.PACK_CACHE.close()


def _u16(vals):
    return np.asarray(vals, dtype=np.uint16)


def _sorted(rng, n):
    return np.sort(rng.choice(1 << 16, n, replace=False)).astype(np.uint16)


def _run_heavy(rng):
    vals, pos = [], 0
    while pos < (1 << 16) - 300 and len(vals) <= 30000:
        pos += int(rng.integers(1, 500))
        ln = int(rng.integers(1, 200))
        vals.extend(range(pos, min(pos + ln, 1 << 16)))
        pos += ln
    return np.array(sorted(set(vals)), dtype=np.uint16)


def _edge_sets(rng):
    """Empty, one value (0 and 65535), 4096 and 4097 values, the full
    container, a census-sized array and a run-heavy set."""
    return [
        _u16([]), _u16([0]), _u16([65535]), _sorted(rng, 4096), _sorted(rng, 4097),
        np.arange(1 << 16, dtype=np.uint16), _sorted(rng, 517), _run_heavy(rng),
    ]


_RNG = np.random.default_rng(0xFEEF1F0)
EDGES = _edge_sets(_RNG)
# the JAX package's 30 set-algebra cases, then every pair of edge sets
CASES = (
    [(_sorted(_RNG, int(_RNG.integers(0, 6000))), _sorted(_RNG, int(_RNG.integers(0, 6000)))) for _ in range(25)]
    + [(_run_heavy(_RNG), _sorted(_RNG, 3000)), (_run_heavy(_RNG), _run_heavy(_RNG)),
       (_u16([]), _sorted(_RNG, 900)), (_sorted(_RNG, 900), _u16([])), (_u16([7]), _sorted(_RNG, 60000))]
    + [(a, b) for a in EDGES for b in EDGES]
)


def _bindings(name):
    """The port's native functions for ``name``: one per binding."""
    native.load()
    return [f for f in (native.EXT.get(name), native.CTYPES.get(name)) if f is not None] or [getattr(native, name)]


def _eq(x, y):
    if isinstance(x, tuple):
        return len(x) == len(y) and all(_eq(a, b) for a, b in zip(x, y))
    if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
        x, y = np.asarray(x), np.asarray(y)
        return x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)
    return x == y and type(x) is type(y)


def _three_sided(name, plain, *args):
    """Every port binding and the JAX package's module against the plain
    version, exactly."""
    want = plain(*args)
    for fn in _bindings(name):
        assert _eq(fn(*args), want), (name, fn)
    assert _eq(getattr(jnative, name)(*args), want), name
    return want


# ---------------------------------------------------------------------------
# the per-container entry points (tests/test_native.py's eight cases)
# ---------------------------------------------------------------------------

SET_OPS = ("intersect_sorted", "merge_sorted_unique", "difference_sorted", "xor_sorted")


@pytest.mark.parametrize("case", range(len(CASES)))
def test_set_algebra(case):
    a, b = CASES[case]
    for name in SET_OPS:
        _three_sided(name, getattr(bits, name + "_numpy"), a, b)
    _three_sided("intersect_cardinality", lambda x, y: int(bits.intersect_sorted_numpy(x, y).size), a, b)


@pytest.mark.parametrize("vals", EDGES + [_sorted(_RNG, int(n)) for n in _RNG.integers(1, 6000, 12)],
                         ids=lambda v: f"n{v.size}")
def test_word_kernels(vals):
    words = _three_sided("words_from_values", lambda v: bits.words_from_values_numpy(v), vals)
    _three_sided("cardinality_of_words", bits.cardinality_of_words_numpy, words)
    _three_sided("values_from_words", bits.values_from_words_numpy, words)
    _three_sided("num_runs_in_words", bits.num_runs_in_words_numpy, words)
    for j in {0, vals.size // 2, vals.size - 1} if vals.size else ():
        _three_sided("select_in_words", bits.select_in_words_numpy, words, j)
    for s, e in ((0, 1 << 16), (0, 1), (63, 65), (4000, 4001), (100, 50000), (65535, 65536)):
        _three_sided("cardinality_in_range", bits.cardinality_in_range_numpy, words, s, e)
    acc = bits.words_from_values_numpy(_u16([1, 64, 65535]))
    want = bits.or_values_into_words_numpy(acc.copy(), vals)
    for fn in (native.or_values_into_words, jnative.or_values_into_words):
        assert np.array_equal(fn(acc.copy(), vals), want)


def test_select_out_of_range():
    words = bits.words_from_values_numpy(_u16([1, 5]))
    for fn in [*_bindings("select_in_words"), jnative.select_in_words, bits.select_in_words_numpy]:
        with pytest.raises(IndexError):
            fn(words, 2)


@pytest.mark.parametrize("vals", EDGES, ids=lambda v: f"n{v.size}")
def test_runs_roundtrip(vals):
    starts, lengths = _three_sided("runs_from_values", bits.runs_from_values_numpy, vals)
    assert np.array_equal(bits.values_from_runs(starts, lengths), vals)
    _three_sided("num_runs_in_values", lambda v: int(bits.runs_from_values_numpy(v)[0].size), vals)
    pairs = np.stack([starts, lengths], axis=1).reshape(-1)
    _three_sided("validate_runs_u16", bits.validate_runs_u16_numpy, pairs)
    _three_sided("validate_sorted_u16", bits.validate_sorted_u16_numpy, vals)
    if vals.size > 1:
        _three_sided("validate_sorted_u16", bits.validate_sorted_u16_numpy, vals[::-1].copy())
        bad = pairs.copy()
        bad[1] = 65535  # the first run passes the universe's end
        _three_sided("validate_runs_u16", bits.validate_runs_u16_numpy, bad)


@pytest.mark.parametrize("op", ("or", "and", "xor"))
def test_wide_op_fold(op):
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 1 << 63, size=(17, 1024), dtype=np.uint64)
    fn = {"or": np.bitwise_or, "and": np.bitwise_and, "xor": np.bitwise_xor}[op]
    want = fn.reduce(rows, axis=0)
    plain = (want, bits.cardinality_of_words_numpy(want))
    assert _eq(native.wide_op_words(rows, op), plain)
    assert _eq(jnative.wide_op_words(rows, op), plain)
    out, card = native.wide_op_words(rows[:0], op)
    assert card == 0 and not out.any()


@pytest.mark.parametrize("vals", EDGES, ids=lambda v: f"n{v.size}")
def test_contains_many_advance_until_and_lower_bound(vals):
    rng = np.random.default_rng(7)
    q = np.concatenate([rng.integers(0, 1 << 16, 500), [0, 65535]]).astype(np.uint16)
    _three_sided("contains_many", lambda s, x: np.isin(x, s), vals, q)
    for x in (0, 1, 4096, 65535, *(int(v) for v in vals[:: max(1, vals.size // 7)])):
        want = int(np.searchsorted(vals, np.uint16(x)))
        _three_sided("advance_until", lambda a, pos, m: int(np.searchsorted(a, np.uint16(m))), vals, -1, x)
        _three_sided("lower_bound", bits.lower_bound_numpy, vals, x)
        assert native.lower_bound(vals, x) == want


def _interval_cases(rng):
    cases = [
        ([0], [65536]), ([65535], [65536]), ([0], [1]), ([63], [65]), ([0, 64], [64, 128]), ([], []),
        ([0, 4096], [4096, 4097]),
    ]
    for _ in range(12):
        n = int(rng.integers(1, 200))
        starts = np.sort(rng.choice(65535, n, replace=False))
        ends = np.minimum(starts + rng.integers(1, 300, n), np.append(starts[1:], 65536))
        cases.append((starts, ends))
    return [(np.asarray(s, np.int64), np.asarray(e, np.int64)) for s, e in cases]


@pytest.mark.parametrize("case", _interval_cases(np.random.default_rng(123)), ids=lambda c: f"n{c[0].size}")
def test_words_from_intervals(case):
    _three_sided("words_from_intervals", bits.words_from_intervals_numpy, *case)


# ---------------------------------------------------------------------------
# the batch entry points, on census-shaped batches with the edges mixed in
# ---------------------------------------------------------------------------


def _csr(sets):
    lens = np.fromiter((s.size for s in sets), np.int64, len(sets))
    vals = np.concatenate(sets) if sets else _u16([])
    return vals.astype(np.uint16), np.concatenate(([0], np.cumsum(lens)))


def _batch(rng, n_pairs=60):
    """``n_pairs`` (a, b) array payloads: census-sized arrays (~500
    values), the edge sets against each other and against census arrays."""
    a = [_sorted(rng, int(rng.integers(1, 1200))) for _ in range(n_pairs)] + EDGES + EDGES[::-1]
    b = [_sorted(rng, int(rng.integers(1, 1200))) for _ in range(n_pairs)] + EDGES[::-1] + EDGES
    return a, b


BATCH_A, BATCH_B = _batch(np.random.default_rng(11))


@pytest.mark.parametrize("op", ("and", "or", "xor", "andnot"))
@pytest.mark.parametrize("n", [0, 1, len(BATCH_A)])
def test_batch_pairwise_u16(op, n):
    av, ao = _csr(BATCH_A[:n])
    bv, bo = _csr(BATCH_B[:n])
    vals, starts, counts = ck.batch_pairwise_numpy(av, ao, bv, bo, op)
    alen, blen = np.diff(ao), np.diff(bo)
    bound = {"and": np.minimum(alen, blen), "andnot": alen}.get(op, alen + blen)
    oo = np.concatenate(([0], np.cumsum(bound)))
    got = native.batch_pairwise_u16(av, ao, bv, bo, op, oo[:-1], int(oo[-1]))
    assert _eq(jnative.batch_pairwise_u16(av, ao, bv, bo, op, oo[:-1], int(oo[-1]))[1], got[1])
    assert np.array_equal(got[1], counts)
    for j in range(n):
        want = vals[starts[j] : starts[j] + counts[j]]
        assert np.array_equal(got[0][oo[j] : oo[j] + counts[j]], want)
    # the dispatcher: the engine's view of the same batch
    dv, ds, dc = ck.batch_pairwise(av, ao, bv, bo, op)
    assert np.array_equal(dc, counts)
    for j in range(n):
        assert np.array_equal(dv[ds[j] : ds[j] + dc[j]], vals[starts[j] : starts[j] + counts[j]])


def _runs_of(sets, as_runs):
    """CSR run payloads: run-optimized sets as runs, the others as
    length-0 runs (arrays)."""
    starts, lengths = [], []
    for s, r in zip(sets, as_runs):
        if r:
            st, ln = bits.runs_from_values_numpy(s)
        else:
            st, ln = s, np.zeros(s.size, np.uint16)
        starts.append(st.astype(np.uint16))
        lengths.append(ln.astype(np.uint16))
    cnt = np.fromiter((s.size for s in starts), np.int64, len(starts))
    cat = (lambda xs: np.concatenate(xs) if xs else _u16([]))
    return cat(starts), cat(lengths), cnt


@pytest.mark.parametrize("cards_only", [False, True])
@pytest.mark.parametrize("op", ("and", "andnot"))
def test_batch_run_pairwise(op, cards_only):
    rng = np.random.default_rng(13)
    n = len(BATCH_A)
    a_runs, b_runs = rng.integers(0, 2, n).astype(bool), rng.integers(0, 2, n).astype(bool)
    as_, al, acnt = _runs_of(BATCH_A, a_runs)
    bs_, bl, bcnt = _runs_of(BATCH_B, b_runs)
    want_sets = [
        (np.intersect1d if op == "and" else np.setdiff1d)(a, b) for a, b in zip(BATCH_A, BATCH_B)
    ]
    want_cards = np.fromiter((w.size for w in want_sets), np.int64, n)
    plain = ck.interval_batch(as_, al, acnt, bs_, bl, bcnt, op, cards_only=True)
    assert np.array_equal(plain, want_cards)
    aoffs, boffs = np.concatenate(([0], np.cumsum(acnt))), np.concatenate(([0], np.cumsum(bcnt)))
    if cards_only:
        got = native.batch_run_pairwise(as_, al, aoffs, bs_, bl, boffs, op, None, 0)
        assert got[0] is None and np.array_equal(got[3], want_cards)
        assert _eq(jnative.batch_run_pairwise(as_, al, aoffs, bs_, bl, boffs, op, None, 0)[3], got[3])
        assert np.array_equal(ck.batch_run_pairwise(as_, al, acnt, bs_, bl, bcnt, op, cards_only=True), want_cards)
        return
    oo = np.concatenate(([0], np.cumsum(acnt + bcnt)))
    got = native.batch_run_pairwise(as_, al, aoffs, bs_, bl, boffs, op, oo[:-1], int(oo[-1]))
    jgot = jnative.batch_run_pairwise(as_, al, aoffs, bs_, bl, boffs, op, oo[:-1], int(oo[-1]))
    assert np.array_equal(got[2], jgot[2]) and np.array_equal(got[3], jgot[3])
    assert np.array_equal(got[3], want_cards)
    for j in range(n):
        s, k = oo[j], got[2][j]
        assert np.array_equal(got[0][s : s + k], jgot[0][s : s + k])
        assert np.array_equal(got[1][s : s + k], jgot[1][s : s + k])
        assert np.array_equal(bits.values_from_runs(got[0][s : s + k], got[1][s : s + k]), want_sets[j])


def test_batch_intersect_card_u16():
    av, ao = _csr(BATCH_A)
    bv, bo = _csr(BATCH_B)
    want = ck.batch_and_cardinality_numpy(av, ao, bv, bo)
    got = native.batch_intersect_card_u16(av, ao, bv, bo)
    assert _eq(got, want)
    assert _eq(jnative.batch_intersect_card_u16(av, ao, bv, bo), want)
    assert _eq(ck.batch_and_cardinality(av, ao, bv, bo), want)


def _word_rows(rng):
    rows = np.stack([bits.words_from_values_numpy(s) for s in EDGES + BATCH_A[:20]])
    return np.concatenate([rows, rng.integers(0, 1 << 63, size=(3, 1024), dtype=np.uint64)])


@pytest.mark.parametrize("n_rows", [0, 1, 31])
def test_popcount_rows(n_rows):
    mat = _word_rows(np.random.default_rng(17))[:n_rows]
    want = ck.popcount_rows_numpy(mat)
    if n_rows:
        assert _eq(native.popcount_rows(mat), want)
        assert _eq(jnative.popcount_rows(mat), want)
    assert _eq(ck.popcount_rows(mat), want)


@pytest.mark.parametrize("op", ("or", "xor", "clear"))
def test_scatter_values_rows(op):
    rng = np.random.default_rng(19)
    sets = EDGES + BATCH_B[:10]
    rows = rng.integers(0, 6, len(sets)).astype(np.int64)  # rows repeat
    vals, offs = _csr(sets)
    start = _word_rows(rng)[:6].copy()
    want = start.copy()
    ck.scatter_values_rows_numpy(rows, offs, vals, want, op)
    for fn in (native.scatter_values_rows, jnative.scatter_values_rows, ck.scatter_values_rows):
        got = start.copy()
        fn(rows, offs, vals, got, op)
        assert np.array_equal(got, want), fn


@pytest.mark.parametrize("op", ("or", "xor"))
def test_fill_intervals_rows(op):
    rng = np.random.default_rng(23)
    runs = [bits.runs_from_values_numpy(s) for s in EDGES + BATCH_A[:10]]
    rows = rng.integers(0, 5, len(runs)).astype(np.int64)
    nruns = np.fromiter((s.size for s, _ in runs), np.int64, len(runs))
    roffs = np.concatenate(([0], np.cumsum(nruns)))
    starts = np.concatenate([s for s, _ in runs]).astype(np.int64)
    ends = starts + np.concatenate([ln for _, ln in runs]).astype(np.int64) + 1
    start = _word_rows(rng)[:5].copy()
    want = start.copy()
    ck.fill_intervals_rows_numpy(rows, roffs, starts, ends, want, op)
    for fn in (native.fill_intervals_rows, jnative.fill_intervals_rows, ck.fill_intervals_rows):
        got = start.copy()
        fn(rows, roffs, starts, ends, got, op)
        assert np.array_equal(got, want), fn


def test_pack_array_rows():
    rng = np.random.default_rng(29)
    sets = EDGES + BATCH_A
    rows = rng.permutation(len(sets) + 3)[: len(sets)].astype(np.int64)  # distinct, unsorted
    vals, offs = _csr(sets)
    want = np.zeros((len(sets) + 3, 1024), np.uint64)
    ck.scatter_values_rows_numpy(rows, offs, vals, want, "or")
    for fn in (native.pack_array_rows, jnative.pack_array_rows):
        got = np.zeros_like(want)
        fn(rows, offs, vals, got)
        assert np.array_equal(got, want), fn


def test_batch_wrappers_refuse_what_would_corrupt_memory():
    """The batch entry points take raw pointers: the wrappers check row ids,
    offsets and targets first."""
    vals, offs = _csr([_u16([1, 2]), _u16([3])])
    out = np.zeros((2, 1024), np.uint64)
    with pytest.raises(IndexError):
        native.scatter_values_rows(np.array([0, 2]), offs, vals, out)
    with pytest.raises(ValueError):
        native.scatter_values_rows(np.array([0, 1]), np.array([0, 2, 9]), vals, out)
    with pytest.raises(ValueError):
        native.pack_array_rows(np.array([0, 1]), offs, vals, out.astype(np.int64))
    with pytest.raises(ValueError):
        native.fill_intervals_rows(np.array([0]), np.array([0, 1]), np.array([0]), np.array([5, 6]), out)
    with pytest.raises(ValueError):
        native.fill_intervals_rows(np.array([0]), np.array([0, 0]), np.array([0]), np.array([5]), out[:, ::2])
    with pytest.raises(ValueError):
        native.batch_pairwise_u16(vals, offs, vals, offs, "or", np.array([0, 1]), 3)
    with pytest.raises(ValueError):
        native.batch_run_pairwise(vals, vals, offs, vals, vals, offs, "or", None, 0)


# ---------------------------------------------------------------------------
# the build, the bindings and the tier setting
# ---------------------------------------------------------------------------


def test_the_loaded_libraries_are_the_ports():
    lib, ext = native.load()
    build = (PORT_DIR / "_build").resolve()
    assert Path(lib._name).resolve().parent == build
    assert Path(ext.__file__).resolve().parent == build
    assert ext.__name__ == "roaringbitmap_tpu_torch.native._rb_ext"
    jdir = Path(jnative.__file__).resolve().parent
    assert jdir not in (Path(lib._name).resolve().parent, Path(ext.__file__).resolve().parent)
    paths = native.build()
    assert Path(lib._name).resolve() == paths["ctypes"].resolve()
    assert Path(ext.__file__).resolve() == paths["ext"].resolve()
    for path in paths.values():  # named by the sources' hash
        assert path.name.split("_")[-1].split(".")[0] in native.build_commands()["ext"][1].name


def test_native_is_the_default_tier():
    assert native.config.tier == "native"
    assert ck.has_native()
    state = native.backend_tier()
    assert state["tier"] == "native" and state["loaded"] and state["openmp"]
    assert state["bindings"] == ["ext", "ctypes"] and state["omp_threads"] >= 1
    bits.values_from_words(bits.new_words())
    assert bits.values_from_words is native.values_from_words
    assert bits.lower_bound is native.lower_bound
    assert bits.words_from_intervals is native.words_from_intervals


def test_set_tier_rebinds_every_dispatched_name():
    native.set_tier("numpy")
    assert not ck.has_native()
    assert native.backend_tier()["tier"] == "numpy"
    c = tcontainer.ArrayContainer(_u16([3, 9]))
    assert c.contains(9) and not c.contains(4)
    assert tcontainer._EXT_CONTAINS is None  # the numpy tier binds no probe
    bits.intersect_sorted(_u16([1]), _u16([1]))
    for name in bits._DISPATCHED:
        assert getattr(bits, name) is getattr(bits, name + "_numpy"), name
    native.set_tier("native")
    assert c.contains(9) and tcontainer._EXT_CONTAINS is not None
    bits.intersect_sorted(_u16([1]), _u16([1]))
    for name in bits._DISPATCHED:
        assert getattr(bits, name) is getattr(native, name), name
    with pytest.raises(ValueError):
        native.set_tier("ctypes")


@pytest.mark.parametrize("compiler", ["failing", "missing"])
def test_a_failed_build_raises_and_leaves_no_numpy_tier(compiler, tmp_path, monkeypatch):
    """A g++ that fails (a stub on PATH) or none at all: TierUnavailable
    with the compiler's output, from the build, from the tier probe and
    from every dispatched call; the tier stays native."""
    stub_dir = tmp_path / "bin"
    stub_dir.mkdir()
    if compiler == "failing":
        stub = stub_dir / "g++"
        stub.write_text("#!/bin/sh\necho 'stub compiler: refusing to build' >&2\nexit 1\n")
        stub.chmod(0o755)
    monkeypatch.setenv("PATH", str(stub_dir))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_ext", None)
    native.set_tier("native")
    msg = "refusing to build" if compiler == "failing" else re.escape("g++ not found")
    with pytest.raises(TierUnavailable, match=msg):
        native.build()
    with pytest.raises(TierUnavailable, match=msg):
        ck.has_native()
    with pytest.raises(TierUnavailable):
        bits.intersect_sorted(_u16([1]), _u16([1]))
    with pytest.raises(TierUnavailable):
        tcontainer.ArrayContainer(_u16([3])).contains(3)
    assert native.config.tier == "native"
    assert not native.backend_tier()["loaded"]
    assert not (tmp_path / "_build").exists() or not list((tmp_path / "_build").glob("*.so"))


def test_expand_host_is_the_same_on_both_tiers():
    rng = np.random.default_rng(31)
    bms = [TRB(np.sort(rng.choice(1 << 20, 3000, replace=False)).astype(np.uint32)) for _ in range(4)]
    bms[1].add_range(5 << 16, (5 << 16) + 70000)
    bms[1].run_optimize()
    containers = [c for b in bms for c in b.high_low_container.containers]
    want = store.RowPayload.from_containers(containers).expand_host()
    native.set_tier("numpy")
    assert np.array_equal(store.RowPayload.from_containers(containers).expand_host(), want)


# ---------------------------------------------------------------------------
# the case the numpy-pinned parity fixtures hide
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["and", "andnot"])
def test_routed_census_pairs_match_the_jax_package_on_the_native_tier(op):
    """Run-optimized census pairs through the routed facade, both packages
    on their default host tier: the JAX package's bytes, run containers
    included (its native run-unified bucket builds runs where the numpy
    tier builds arrays)."""
    assert jnative.available() and ck.has_native()
    base, _ = datasets.load_or_synthesize("census1881")
    built = []
    for v in base[:12]:
        j, t = JRB(np.asarray(v, np.uint32)), TRB(np.asarray(v, np.uint32))
        j.run_optimize()
        t.run_optimize()
        built.append((j, t))
    routed = tengine.ROUTE_COUNTS["columnar-cpu"]
    runs = 0
    name = {"and": "and_", "andnot": "andnot"}[op]
    for (ja, ta), (jb, tb) in zip(built[:-1], built[1:]):
        got, want = getattr(TRB, name)(ta, tb), getattr(JRB, name)(ja, jb)
        assert got.serialize() == want.serialize()
        runs += sum(isinstance(c, RunContainer) for c in got.high_low_container.containers)
    assert tengine.ROUTE_COUNTS["columnar-cpu"] > routed
    assert runs  # a numpy-tier result would hold none
    assert os.path.basename(native.load()[0]._name).startswith("librb_host_")
