"""The port's batch similarity (``parallel/batch.py``) against the JAX
package's.

The same seeded values are built into bitmaps of both packages. The
one-vs-many counts, intersect masks and materialized results (serialized
bytes), the all-pairs AND matrix under every ``impl``, the four-op
matrices and the Jaccard matrix must equal the JAX package's exactly; the
errors must match; ``PAIRWISE_COUNTS`` must move as the JAX counter does.
The port runs on CPU tensors (``device="cpu"``), where the kernel wrappers
use their plain versions, and those plain versions are held against the
JAX package's ``_step``, ``_pairwise_step`` and ``_pairwise_mxu_step`` run
directly on the same uint32 words. The ``cuda``-marked tests hold
``rb_pair_rows``' counts-only mode and ``rb_pairwise_and_card`` against
their plain versions and skip without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roaringbitmap_tpu.models.roaring import RoaringBitmap as JRB
from roaringbitmap_tpu.parallel import batch as jb
from roaringbitmap_tpu.parallel import store as jstore

import roaringbitmap_tpu_torch as tpkg
from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch.ops import kernels as K
from roaringbitmap_tpu_torch.parallel import batch as tb
from roaringbitmap_tpu_torch.parallel import store as tstore
from roaringbitmap_tpu_torch.robust.errors import TierUnavailable

W = 2048
MASK_OPS = ("and", "andnot")
IMPLS = ("vpu", "mxu", "auto")
PAIR_OPS = ("and", "or", "xor", "andnot")
CPU = "cpu"


@pytest.fixture(autouse=True)
def empty_pack_caches():
    """Neither package's process-wide pack cache keeps tensors between
    tests."""
    tstore.PACK_CACHE.close()
    yield
    tstore.PACK_CACHE.close()
    jstore.PACK_CACHE.close()


def _both(values, run_optimize=False):
    j, t = JRB(values), TRB(values)
    if run_optimize:
        j.run_optimize()
        t.run_optimize()
    return j, t


@pytest.fixture(scope="module")
def workload():
    """``tests/test_batch.py``'s seed-41 workload, in both packages."""
    rng = np.random.default_rng(41)
    filt = rng.choice(1 << 20, 200_000, replace=False).astype(np.uint32)
    many = [rng.choice(1 << 20, 1500, replace=False).astype(np.uint32) for _ in range(20)]
    jf, tf = _both(filt)
    pairs = [_both(v) for v in many]
    return jf, tf, [p[0] for p in pairs], [p[1] for p in pairs]


def _region(rng, kind):
    if kind == 0:  # sparse: an array container
        return rng.choice(1 << 16, int(rng.integers(1, 3000)), replace=False)
    if kind == 1:  # dense: a bitmap container
        return rng.choice(1 << 16, int(rng.integers(4097, 40000)), replace=False)
    starts = np.sort(rng.choice(np.arange(0, 1 << 16, 512), int(rng.integers(1, 40)), replace=False))
    return np.unique(np.concatenate([s + np.arange(int(rng.integers(1, 400))) for s in starts]))


def _sets(seed, count, n_keys, key_base=0):
    """``count`` bitmaps of both packages over ``n_keys`` keys: each set
    holds a random subset of the keys, each chunk an array, bitmap or run
    region; every third set is run-optimized."""
    rng = np.random.default_rng(seed)
    js, ts = [], []
    for i in range(count):
        keys = np.sort(rng.choice(n_keys, int(rng.integers(1, n_keys + 1)), replace=False))
        vals = np.concatenate(
            [((key_base + int(k)) << 16) + _region(rng, int(rng.integers(0, 3))) for k in keys]
        ).astype(np.uint32)
        j, t = _both(np.unique(vals), run_optimize=i % 3 == 0)
        js.append(j)
        ts.append(t)
    return js, ts


@pytest.fixture(scope="module")
def matrices():
    """Lefts over 4 keys (one empty set), rights over 5 keys (one empty set
    and one key-disjoint set)."""
    jl, tl = _sets(61, 9, 4)
    jr, tr = _sets(62, 10, 5)
    for side_j, side_t in ((jl, tl), (jr, tr)):
        j, t = _both(np.empty(0, np.uint32))
        side_j.append(j)
        side_t.append(t)
    j, t = _both(np.array([1 << 25, (1 << 25) + 7], np.uint32))
    jr.append(j)
    tr.append(t)
    return jl, tl, jr, tr


def _same_bytes(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.serialize() == w.serialize(), i


# ---------------------------------------------------------------------------
# one-vs-many
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", MASK_OPS)
def test_batched_cardinality_matches_jax_package(workload, op):
    jf, tf, jm, tm = workload
    got = tb.batched_cardinality(tf, tm, op=op, device=CPU)
    want = jb.batched_cardinality(jf, jm, op=op)
    assert got.dtype == np.int64
    assert np.array_equal(got, want)
    ref = TRB.and_ if op == "and" else TRB.andnot
    assert got.tolist() == [ref(m, tf).get_cardinality() for m in tm]


@pytest.mark.parametrize("op", MASK_OPS)
def test_batched_op_bytes_match_jax_package(workload, op):
    jf, tf, jm, tm = workload
    got = tb.batched_op(tf, tm, op=op, device=CPU)
    _same_bytes(got, jb.batched_op(jf, jm, op=op))
    ref = TRB.and_ if op == "and" else TRB.andnot
    assert got == [ref(m, tf) for m in tm]


@pytest.mark.parametrize("op", MASK_OPS)
def test_batched_op_on_shape_diverse_sets_matches_jax_package(matrices, op):
    """Bitmap, run and array containers on both sides, a filter that lacks
    some of the batch's keys, an empty set in the batch."""
    jl, tl, jr, tr = matrices
    _same_bytes(tb.batched_op(tl[0], tr, op=op, device=CPU), jb.batched_op(jl[0], jr, op=op))
    assert np.array_equal(
        tb.batched_cardinality(tl[1], tr, op=op, device=CPU), jb.batched_cardinality(jl[1], jr, op=op)
    )


def test_batched_intersects_matches_jax_package(workload):
    jf, tf, jm, tm = workload
    got = tb.batched_intersects(tf, tm + [TRB()], device=CPU)
    want = jb.batched_intersects(jf, jm + [JRB()])
    assert got.dtype == np.bool_
    assert np.array_equal(got, want)
    assert got.tolist() == [TRB.intersects(m, tf) for m in tm] + [False]


def test_prepared_run_is_reusable_and_matches_jax_package(workload):
    jf, tf, jm, tm = workload
    run = tb.prepare_batched_cardinality(tf, tm, device=CPU)
    first = run()
    assert np.array_equal(first, run())
    assert np.array_equal(first, jb.prepare_batched_cardinality(jf, jm)())
    batch, filt = run.device_tensors
    jbatch, jfilt = jb.prepare_batched_cardinality(jf, jm).device_tensors
    assert tuple(batch.shape) == jbatch.shape and tuple(filt.shape) == jfilt.shape
    assert np.array_equal(batch.numpy().view(np.uint32), np.asarray(jbatch))
    assert np.array_equal(filt.numpy().view(np.uint32), np.asarray(jfilt))
    per_key = run.step(batch, filt)
    assert per_key.dtype == torch.int32
    assert np.array_equal(per_key.numpy(), np.asarray(jb._step("and", True)(jbatch, jfilt)))


def test_prepared_run_builds_its_index_streams_once(workload, monkeypatch):
    """The steady loop launches only the counts and the copy: the step
    keeps the last shape's index streams and builds new ones on a new
    shape."""
    _, tf, _, tm = workload
    built = []
    real = tb._mask_streams
    monkeypatch.setattr(tb, "_mask_streams", lambda q, k, d: built.append((q, k)) or real(q, k, d))
    run = tb.prepare_batched_cardinality(tf, tm, device=CPU)
    first = run()
    for _ in range(3):
        assert np.array_equal(run(), first)
    batch, filt = run.device_tensors
    assert built == [tuple(batch.shape[:2])]
    run.step(batch[:2].contiguous(), filt)
    run.step(batch, filt)
    assert built == [tuple(batch.shape[:2]), (2, batch.shape[1]), tuple(batch.shape[:2])]


@pytest.mark.parametrize("case", ["no-sets", "empty-set", "empty-filter", "all-empty"])
def test_empty_inputs_match_jax_package(case):
    j_one, t_one = _both(np.arange(0, 300000, 7, dtype=np.uint32))
    if case == "no-sets":
        jm, tm = [], []
    elif case == "empty-set":
        jm, tm = [JRB()], [TRB()]
    elif case == "empty-filter":
        j_one, t_one = JRB(), TRB()
        jm, tm = [JRB.bitmap_of(1)], [TRB.bitmap_of(1)]
    else:  # every set empty: one all-zero key row
        jm, tm = [JRB(), JRB()], [TRB(), TRB()]
    for op in MASK_OPS:
        got = tb.batched_cardinality(t_one, tm, op=op, device=CPU)
        want = jb.batched_cardinality(j_one, jm, op=op)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        _same_bytes(tb.batched_op(t_one, tm, op=op, device=CPU), jb.batched_op(j_one, jm, op=op))
    assert np.array_equal(tb.batched_intersects(t_one, tm, device=CPU), jb.batched_intersects(j_one, jm))


def test_packs_match_jax_package(matrices):
    """The device-side pack (payload shipped, rows scattered by
    ``index_copy_``) gives the JAX package's host-packed words."""
    jl, tl, jr, tr = matrices
    jf, jbatch, jkeys = jb._pack_one_vs_many(jl[2], jr)
    tf, tbatch, tkeys = tb._pack_one_vs_many(tl[2], tr, torch.device(CPU))
    assert np.array_equal(tkeys, jkeys)
    assert np.array_equal(tf.numpy().view(np.uint32), np.asarray(jf))
    assert np.array_equal(tbatch.numpy().view(np.uint32), np.asarray(jbatch))
    keys = [0, 2, 3]  # a key subset: containers outside it are dropped
    kidx = {k: i for i, k in enumerate(keys)}
    got = tb._pack_sets(tl, keys, kidx, torch.device(CPU))
    assert np.array_equal(got.numpy().view(np.uint32), jb._pack_sets(jl, keys, kidx))


# ---------------------------------------------------------------------------
# many-vs-many
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", IMPLS)
def test_pairwise_and_cardinality_matches_jax_package(matrices, impl):
    jl, tl, jr, tr = matrices
    got = tb.pairwise_and_cardinality(tl, tr, tile_bytes=1 << 20, impl=impl, device=CPU)
    want = jb.pairwise_and_cardinality(jl, jr, tile_bytes=1 << 20, impl=impl)
    assert got.dtype == np.int64 and got.shape == (len(tl), len(tr))
    assert np.array_equal(got, want)
    for i, L in enumerate(tl):
        for j, R in enumerate(tr):
            assert got[i, j] == TRB.and_cardinality(L, R), (i, j)


@pytest.mark.parametrize("op", PAIR_OPS)
def test_pairwise_cardinality_matches_jax_package(matrices, op):
    jl, tl, jr, tr = matrices
    got = tb.pairwise_cardinality(tl, tr, op=op, device=CPU)
    assert np.array_equal(got, jb.pairwise_cardinality(jl, jr, op=op))
    scalar = getattr(TRB, f"{op}_cardinality")
    assert got.tolist() == [[scalar(L, R) for R in tr] for L in tl]


def test_pairwise_jaccard_matches_jax_package(matrices):
    jl, tl, jr, tr = matrices
    got = tb.pairwise_jaccard(tl, tr, device=CPU)
    want = jb.pairwise_jaccard(jl, jr)
    assert got.dtype == np.float64 and np.array_equal(got, want)
    assert got[-1, -2] == 0.0  # two empty sets


@pytest.mark.parametrize("case", ["no-lefts", "no-rights", "no-shared-key"])
def test_pairwise_degenerate_shapes_match_jax_package(matrices, case):
    jl, tl, jr, tr = matrices
    if case == "no-lefts":
        jl, tl = [], []
    elif case == "no-rights":
        jr, tr = [], []
    else:
        jr, tr = _sets(63, 3, 2, key_base=40)
    for impl in IMPLS:
        got = tb.pairwise_and_cardinality(tl, tr, impl=impl, device=CPU)
        want = jb.pairwise_and_cardinality(jl, jr, impl=impl)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want)
    assert np.array_equal(tb.pairwise_jaccard(tl, tr, device=CPU), jb.pairwise_jaccard(jl, jr))


def test_prepare_pairwise_mxu_matches_jax_package(matrices):
    jl, tl, jr, tr = matrices
    run = tb.prepare_pairwise_mxu(tl, tr, device=CPU)
    jrun = jb.prepare_pairwise_mxu(jl, jr)
    assert np.array_equal(run(), jrun())
    lw, rw = run.device_tensors
    jlw, jrw = jrun.device_tensors
    assert np.array_equal(lw.numpy().view(np.uint32), np.asarray(jlw))
    assert np.array_equal(rw.numpy().view(np.uint32), np.asarray(jrw))
    assert np.array_equal(run.step(lw, rw).numpy(), run())
    jd, td = _sets(64, 2, 2, key_base=40)
    empty = tb.prepare_pairwise_mxu(tl, td, device=CPU)
    assert empty.device_tensors is None and empty.step is None
    assert np.array_equal(empty(), jb.prepare_pairwise_mxu(jl, jd)())


def test_errors_match_jax_package(matrices):
    jl, tl, jr, tr = matrices
    with pytest.raises(ValueError, match="op must be") as te:
        tb.pairwise_cardinality(tl, tr, op="nand", device=CPU)
    with pytest.raises(ValueError, match="op must be") as je:
        jb.pairwise_cardinality(jl, jr, op="nand")
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="impl must be") as te:
        tb.pairwise_and_cardinality(tl, tr, impl="tpu", device=CPU)
    with pytest.raises(ValueError, match="impl must be") as je:
        jb.pairwise_and_cardinality(jl, jr, impl="tpu")
    assert str(te.value) == str(je.value)
    j_huge, t_huge = JRB.bitmap_of_range(0, 1 << 31), TRB.bitmap_of_range(0, 1 << 31)
    with pytest.raises(ValueError, match="2\\^31") as te:
        tb.pairwise_and_cardinality([t_huge], [t_huge], impl="mxu", device=CPU)
    with pytest.raises(ValueError, match="2\\^31") as je:
        jb.pairwise_and_cardinality([j_huge], [j_huge], impl="mxu")
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="2\\^31"):
        tb.prepare_pairwise_mxu([t_huge], [t_huge], device=CPU)
    with pytest.raises(ValueError, match="2\\^31"):
        jb.prepare_pairwise_mxu([j_huge], [j_huge])


def test_sets_past_2_31_take_vpu_under_auto():
    """A set of 2^31 + 5 values is refused by 'mxu' and runs 'vpu' under
    'auto' in both packages (the shared keys, and so the packs, stay
    small)."""
    n = (1 << 31) + 5
    j_a, t_a = JRB.bitmap_of_range(0, n), TRB.bitmap_of_range(0, n)
    vals = np.array([5, 1 << 20, (1 << 31) + 3, (1 << 31) + 9, 3 << 30], np.uint32)
    j_b, t_b = _both(vals)
    before = dict(tb.PAIRWISE_COUNTS)
    got = tb.pairwise_and_cardinality([t_a, t_b], [t_b], device=CPU)
    assert tb.PAIRWISE_COUNTS["vpu"] == before["vpu"] + 1
    assert got.tolist() == [[3], [5]]
    assert np.array_equal(got, jb.pairwise_and_cardinality([j_a, j_b], [j_b]))


def test_pairwise_counts_move_as_the_jax_counter(matrices):
    jl, tl, jr, tr = matrices
    calls = [
        dict(impl="vpu"), dict(impl="mxu"), dict(impl="auto"), dict(impl="vpu"),
    ]
    t_before, j_before = dict(tb.PAIRWISE_COUNTS), {k: jb.PAIRWISE_COUNTS[k] for k in ("mxu", "vpu")}
    assert set(t_before) == {"mxu", "vpu"}
    for kw in calls:
        tb.pairwise_and_cardinality(tl, tr, device=CPU, **kw)
        jb.pairwise_and_cardinality(jl, jr, **kw)
    tb.pairwise_jaccard(tl, tr, device=CPU)
    jb.pairwise_jaccard(jl, jr)
    tb.pairwise_and_cardinality(tl[:0], tr, device=CPU)  # no call reaches the engine
    jb.pairwise_and_cardinality(jl[:0], jr)
    t_delta = {k: tb.PAIRWISE_COUNTS[k] - t_before[k] for k in ("mxu", "vpu")}
    j_delta = {k: jb.PAIRWISE_COUNTS[k] - j_before[k] for k in ("mxu", "vpu")}
    assert t_delta == j_delta == {"mxu": 1, "vpu": 4}


# ---------------------------------------------------------------------------
# the plain kernel versions against the JAX package's XLA steps
# ---------------------------------------------------------------------------


def _words(rng, shape, density):
    """uint32 words with about ``density`` of the bits set, the sign bit
    in play."""
    bits = rng.random((*shape, 32)) < density
    return np.packbits(bits, axis=-1, bitorder="little").view(np.uint32).reshape(shape)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("op", MASK_OPS)
@pytest.mark.parametrize("cards_only", [True, False])
def test_masked_plain_versions_equal_jax_step(op, cards_only):
    rng = np.random.default_rng(71)
    q, k = 5, 3
    batch = _words(rng, (q, k, W), 0.4)
    filt = _words(rng, (k, W), 0.6)
    want = jb._step(op, cards_only)(jnp.asarray(batch), jnp.asarray(filt))
    got = tb._step(op, cards_only)(_t(batch), _t(filt))
    ia, ib = tb._mask_streams(q, k, torch.device(CPU))
    flat = _t(batch.reshape(q * k, W))
    if cards_only:
        assert np.array_equal(got.numpy(), np.asarray(want))
        plain = K.pair_rows_cardinality_plain(flat, ia, _t(filt), ib, op)
        assert np.array_equal(plain.numpy().reshape(q, k), np.asarray(want))
    else:
        assert np.array_equal(got[0].numpy().view(np.uint32), np.asarray(want[0]))
        assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
        words, cards = K.pair_rows_reduce_plain(flat, ia, _t(filt), ib, op)
        assert np.array_equal(words.numpy().view(np.uint32).reshape(q, k, W), np.asarray(want[0]))
        assert np.array_equal(cards.numpy().reshape(q, k), np.asarray(want[1]))


# (n, m) pairs that straddle rb_pairwise_and_card's 128 x 256 tile, and two
# more ragged shapes
TILE_EDGES = [(a, b) for a in (127, 128, 129) for b in (255, 256, 257)] + [(1, 1), (300, 77)]


@pytest.mark.parametrize(
    "n,m,k,tile",
    [(5, 7, 3, 1 << 30), (9, 4, 1, 1 << 16), (3, 3, 5, 0)]
    + [(n, m, 1, 1 << 24) for n, m in TILE_EDGES],
)
def test_pairwise_plain_version_equals_jax_steps(n, m, k, tile):
    rng = np.random.default_rng(73 + n)
    left = _words(rng, (n, k, W), 0.5)
    right = _words(rng, (m, k, W), 0.3)
    got = K.pairwise_and_card_plain(_t(left), _t(right), tile)
    assert got.dtype == torch.int64
    per_key = np.asarray(jb._pairwise_step()(jnp.asarray(left), jnp.asarray(right)))
    assert np.array_equal(got.numpy(), per_key.astype(np.int64).sum(axis=2))
    mxu = np.asarray(jb._pairwise_mxu_step()(jnp.asarray(left), jnp.asarray(right)))
    assert np.array_equal(got.numpy(), mxu.astype(np.int64))
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(K.pairwise_and_card(_t(left), _t(right), tile), got)


def test_counts_only_equals_rows_mode_counts():
    rng = np.random.default_rng(79)
    rows_a = _t(_words(rng, (40, W), 0.5))
    rows_b = _t(_words(rng, (6, W), 0.5))
    ia = torch.from_numpy(rng.integers(-2, 42, 200).astype(np.int32))  # some outside: zero rows
    ib = torch.from_numpy(rng.integers(0, 7, 200).astype(np.int32))
    for op in PAIR_OPS:
        counts = K.pair_rows_cardinality(rows_a, ia, rows_b, ib, op)
        assert counts.dtype == torch.int32
        assert torch.equal(counts, K.pair_rows_reduce(rows_a, ia, rows_b, ib, op)[1])


def test_wrappers_reject_what_the_kernels_do_not_take():
    a = torch.zeros((2, 3, W), dtype=torch.int32)
    with pytest.raises(TypeError):
        K.pairwise_and_card(a.to(torch.int64), a)
    with pytest.raises(ValueError, match="\\[n, K, 2048\\]"):
        K.pairwise_and_card(a.view(6, W), a)
    with pytest.raises(ValueError, match="contiguous"):
        K.pairwise_and_card(a.transpose(0, 1), a)
    with pytest.raises(ValueError, match="same K"):
        K.pairwise_and_card(a, torch.zeros((2, 2, W), dtype=torch.int32))
    with pytest.raises(ValueError, match="same K"):
        K.pairwise_and_card(a[:, :0].contiguous(), a[:, :0].contiguous())
    with pytest.raises(ValueError, match="one device"):
        K.pairwise_and_card(a, a.to("meta"))
    # one CTA a 128 x 256 tile, on a one-dimensional grid
    assert [K.pairwise_tiles(n, m) for n, m in TILE_EDGES] == [1, 1, 2, 1, 1, 2, 2, 2, 4, 1, 3]
    widest = 256 * K.MAX_PAIRWISE_TILES
    assert K.pairwise_tiles(128, widest) == K.MAX_PAIRWISE_TILES == 2**31 - 1
    for n, m in ((129, widest), (1 << 22, 1 << 24)):
        with pytest.raises(ValueError, match="tiles of 128 x 256"):
            K.pairwise_tiles(n, m)
    rows = torch.zeros((4, W), dtype=torch.int32)
    idx = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="op must be"):
        K.pair_rows_cardinality(rows, idx, rows, idx, "nand")
    with pytest.raises(ValueError, match="int32"):
        K.pair_rows_cardinality(rows, idx.long(), rows, idx, "and")
    with pytest.raises(ValueError, match="differ in length"):
        K.pair_rows_cardinality(rows, idx, rows, idx[:2], "and")
    with pytest.raises(ValueError, match="int32 indices"):
        tb._mask_streams(1 << 16, 1 << 15, torch.device(CPU))
    with pytest.raises(ValueError, match="'and' or 'andnot'"):
        tb.batched_cardinality(TRB.bitmap_of(1), [TRB.bitmap_of(2)], op="or", device=CPU)


def _fake_nvcc(tmp_path, refuse):
    """A stand-in ``nvcc`` that logs each command line, writes its ``-o``
    file and fails any compile whose arguments hold ``refuse``."""
    script = tmp_path / "nvcc"
    script.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> {tmp_path / "calls"}\n'
        'out=""; prev=""\n'
        'for a in "$@"; do\n'
        f'  if [ "$a" = "{refuse}" ]; then echo "ptxas error: not supported on sm_90a"; exit 1; fi\n'
        '  if [ "$prev" = "-o" ]; then out="$a"; fi; prev="$a"\n'
        "done\n"
        ': > "$out"\n'
    )
    script.chmod(0o755)
    return str(script)


def test_build_leaves_out_a_refused_probe_form_only(tmp_path, monkeypatch):
    """A probe form ptxas refuses is recorded and kept out of the link; a
    kernel source that fails to compile raises."""
    from roaringbitmap_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "BUILD_SECONDS", {})
    monkeypatch.setattr(_build, "PROBE_REFUSED", {})
    monkeypatch.setattr(_build, "nvcc_path", lambda: _fake_nvcc(tmp_path, "-DRB_PROBE_FORM=1"))
    path, log = _build.build()
    assert path.is_file() and "ptxas error" in log
    assert _build.PROBE_REFUSED == {"wgmma_b1": "ptxas error: not supported on sm_90a"}
    link = (tmp_path / "calls").read_text().splitlines()[-1].split()
    assert "-shared" in link
    objs = [a for a in link if a.endswith(".o")]
    assert len(objs) == len(_build.SOURCES) + 2
    assert not any("probe_wgmma_b1" in a for a in objs)
    assert set(_build.BUILD_SECONDS) == {s.name for s in _build.SOURCES} | {
        f"mma_probe.cu[{f}]" for f in _build.PROBE_FORMS} | {"link", "wall"}
    assert not list((tmp_path / "build").glob("*.o"))
    monkeypatch.setattr(_build, "nvcc_path", lambda: _fake_nvcc(tmp_path, str(_build.SOURCES[-1])))
    path.unlink()
    with pytest.raises(TierUnavailable, match="nvcc failed"):
        _build.build()


def test_every_entry_point_raises_without_a_card(workload, matrices):
    if torch.cuda.is_available():
        pytest.skip("this test is about a host without a card")
    _, tf, _, tm = workload
    _, tl, _, tr = matrices
    entry_points = [
        lambda: tb.batched_cardinality(tf, tm, device="cuda"),
        lambda: tb.batched_intersects(tf, tm, device="cuda"),
        lambda: tb.batched_op(tf, tm, device="cuda"),
        lambda: tb.prepare_batched_cardinality(tf, tm, device="cuda"),
        lambda: tb.pairwise_and_cardinality(tl, tr, device="cuda"),
        lambda: tb.pairwise_cardinality(tl, tr, op="xor", device="cuda"),
        lambda: tb.pairwise_jaccard(tl, tr, device="cuda"),
        lambda: tb.prepare_pairwise_mxu(tl, tr, device="cuda"),
        lambda: tb.batched_cardinality(tf, tm),  # the default device is the card
        lambda: tb.pairwise_and_cardinality(tl, tr),
    ]
    for call in entry_points:
        with pytest.raises(TierUnavailable):
            call()


def test_package_exports_the_jax_package_names():
    import roaringbitmap_tpu as jpkg

    names = (
        "batched_cardinality", "batched_intersects", "batched_op", "pairwise_and_cardinality",
        "pairwise_cardinality", "pairwise_jaccard", "prepare_batched_cardinality",
    )
    for name in names:
        assert hasattr(jpkg, name)
        assert getattr(tpkg, name) is getattr(tb, name)
        assert name in tpkg.__all__


# ---------------------------------------------------------------------------
# on the card: the kernels against their plain versions
# ---------------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("op", PAIR_OPS)
def test_cuda_pair_rows_counts_match_plain_version(op):
    _need_card()
    rng = np.random.default_rng(83)
    q, k = 64, 16
    batch = _t(_words(rng, (q * k, W), 0.3)).cuda()
    filt = _t(_words(rng, (k, W), 0.5)).cuda()
    ia, ib = tb._mask_streams(q, k, batch.device)
    before = dict(K.LAUNCHES)
    got = K.pair_rows_cardinality(batch, ia, filt, ib, op)
    torch.cuda.synchronize()
    assert K.LAUNCHES["rb_pair_rows[counts]"] == before["rb_pair_rows[counts]"] + 1
    assert K.LAUNCHES["rb_pair_rows"] == before["rb_pair_rows"]
    want = K.pair_rows_cardinality_plain(batch, ia, filt, ib, op)
    assert torch.equal(got, want)
    words, cards = K.pair_rows_reduce(batch, ia, filt, ib, op)  # rows mode unchanged
    want_words, want_cards = K.pair_rows_reduce_plain(batch, ia, filt, ib, op)
    assert torch.equal(words, want_words) and torch.equal(cards, want_cards)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,m,k",
    [(65, 63, 1), (130, 77, 3), (100, 129, 31)]
    + [(n, m, k) for n, m in TILE_EDGES for k in (1, 3, 31)],
)
def test_cuda_pairwise_and_card_matches_plain_version(n, m, k):
    _need_card()
    rng = np.random.default_rng(89 + n)
    left = _t(_words(rng, (n, k, W), 0.5)).cuda()
    right = _t(_words(rng, (m, k, W), 0.25)).cuda()
    before = K.LAUNCHES["rb_pairwise_and_card"]
    got = K.pairwise_and_card(left, right)
    torch.cuda.synchronize()
    assert K.LAUNCHES["rb_pairwise_and_card"] == before + 1
    assert got.dtype == torch.int64 and tuple(got.shape) == (n, m)
    assert torch.equal(got, K.pairwise_and_card_plain(left, right))


@pytest.mark.cuda
def test_cuda_pairwise_and_card_counts_2_31():
    """All-ones rows over 32,768 keys: the one pair holds exactly 2^31
    bits, one key past what an s32 chunk of the kernel may hold (32,767
    keys); a chunk one key longer would wrap negative."""
    _need_card()
    ones = torch.full((1, 1 << 15, W), -1, dtype=torch.int32, device="cuda")
    got = K.pairwise_and_card(ones, ones)
    torch.cuda.synchronize()
    assert got.item() == 1 << 31
    del ones
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_cuda_pairwise_and_card_counts_past_2_32():
    """All-ones rows over 65,536 keys: the one pair holds 2^32 bits, where
    a uint32 accumulator would read 0."""
    _need_card()
    ones = torch.full((1, 1 << 16, W), -1, dtype=torch.int32, device="cuda")
    got = K.pairwise_and_card(ones, ones)
    torch.cuda.synchronize()
    assert got.item() == 1 << 32
    del ones
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_cuda_entry_points_match_the_cpu_device_path(workload, matrices):
    _need_card()
    _, tf, _, tm = workload
    _, tl, _, tr = matrices
    for op in MASK_OPS:
        assert np.array_equal(
            tb.batched_cardinality(tf, tm, op=op, device="cuda"),
            tb.batched_cardinality(tf, tm, op=op, device=CPU),
        )
        _same_bytes(tb.batched_op(tf, tm, op=op, device="cuda"), tb.batched_op(tf, tm, op=op, device=CPU))
    for impl in IMPLS:
        before = K.LAUNCHES["rb_pairwise_and_card"]
        got = tb.pairwise_and_cardinality(tl, tr, impl=impl, device="cuda")
        assert K.LAUNCHES["rb_pairwise_and_card"] == before + 1
        assert np.array_equal(got, tb.pairwise_and_cardinality(tl, tr, impl=impl, device=CPU))
    assert np.array_equal(tb.pairwise_jaccard(tl, tr, device="cuda"), tb.pairwise_jaccard(tl, tr, device=CPU))
