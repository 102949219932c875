"""The port's kernel wrappers against the JAX package's kernels.

Seeded numpy inputs go through the Pallas kernels (in interpret mode) or
their XLA twins, and through the port's wrappers on CPU tensors — which run
the kernels' plain PyTorch versions. Every comparison is exact: the whole
path is integer. The CUDA kernels themselves are held against the plain
versions by the ``cuda``-marked tests at the end of this file, which skip
without a card (a CUDA kernel has no CPU mode), and by ``chip_smoke.py``.
On the card: ``python -m pytest -m cuda tests/test_torch_*.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from roaringbitmap_tpu.models import container as jc
from roaringbitmap_tpu.ops import device as jdev
from roaringbitmap_tpu.ops import pallas_kernels as pk
from roaringbitmap_tpu.parallel import store as jstore

from roaringbitmap_tpu_torch.models import container as tc
from roaringbitmap_tpu_torch.ops import device as tdev
from roaringbitmap_tpu_torch.ops import kernels as K
from roaringbitmap_tpu_torch.parallel import aggregation
from roaringbitmap_tpu_torch.parallel import store as tstore

SEED = 0xFEEF1F0
OPS = ("or", "and", "xor")
W = 2048


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    """The device path on CPU tensors: a pairwise op the columnar cost
    model routes would otherwise calibrate the device tier on the card."""
    monkeypatch.setattr(aggregation.config, "device", "cpu")
    yield
    tstore.PACK_CACHE.close()


def _words(rng, shape, op):
    """uint32 words whose reduction over a few hundred rows keeps a mix of
    set and clear bits: sparse for or, the complement for and, dense for
    xor."""
    if op == "xor":
        return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)
    sparse = np.where(
        rng.random(shape) < 0.01,
        np.uint32(1) << rng.integers(0, 32, size=shape).astype(np.uint32),
        np.uint32(0),
    ).astype(np.uint32)
    return ~sparse if op == "and" else sparse


def _t(u32):
    return torch.from_numpy(np.ascontiguousarray(u32).view(np.int32))


def _u32(t):
    return np.ascontiguousarray(t.numpy()).view(np.uint32)


@pytest.mark.parametrize("op", OPS)
def test_grouped_reduce_matches_grouped_pallas(op):
    rng = np.random.default_rng(SEED)
    g, m = 5, 70  # G not a multiple of 8, M not a multiple of 64
    words3 = _words(rng, (g, m, W), op)
    red, card = pk.grouped_reduce_cardinality_pallas(
        jnp.asarray(words3), op=op, interpret=True
    )
    got = K.group_reduce(_t(words3), K.SegmentPlan.dense(g, m), op)
    assert np.array_equal(_u32(got), np.asarray(red))
    assert np.array_equal(K.popcount_rows(got).numpy(), np.asarray(card))


@pytest.mark.parametrize("op", OPS)
def test_csr_reduce_matches_segmented_pallas_end_rows(op):
    rng = np.random.default_rng(SEED + 1)
    # 1-row segments, and segments crossing the Pallas kernel's 128-row tile
    lens = np.array([1, 1, 130, 3, 200, 1, 40, 1])
    offsets = np.concatenate(([0], np.cumsum(lens)))
    n = int(offsets[-1])
    words = _words(rng, (n, W), op)
    seg_start = np.zeros(n, dtype=bool)
    seg_start[offsets[:-1]] = True
    scan = pk.segmented_reduce_pallas(
        jnp.asarray(words), jnp.asarray(seg_start), op=op, interpret=True
    )
    want = np.asarray(scan)[offsets[1:] - 1]
    got = K.group_reduce(_t(words), K.SegmentPlan.csr(offsets), op)
    assert np.array_equal(_u32(got), want)


@pytest.mark.parametrize("op", OPS)
def test_rowmap_reduce_matches_fused_gather(op):
    rng = np.random.default_rng(SEED + 2)
    n, g, m = 150, 6, 33
    flat = _words(rng, (n, W), op)
    slots = np.sort(rng.choice(g * m, size=n, replace=False))
    src_map = np.full(g * m, n, dtype=np.int64)  # value n = identity pad
    src_map[slots] = rng.permutation(n)
    red, card = pk.fused_gather_reduce(
        jnp.asarray(flat), src_map, g, m, op=op, fill=int(jdev._INIT[op])
    )
    got = K.group_reduce(
        _t(flat), K.SegmentPlan.dense(g, m), op, row_map=torch.from_numpy(src_map)
    )
    assert np.array_equal(_u32(got), np.asarray(red))
    assert np.array_equal(K.popcount_rows(got).numpy(), np.asarray(card))


@pytest.mark.parametrize("rows", [1, 31, 257])
def test_popcount_rows_matches_xla(rows):
    rng = np.random.default_rng(SEED + rows)
    words = _words(rng, (rows, W), "xor")
    words[0, :7] = [0, 0xFFFFFFFF, 1, 0x80000000, 0x7FFFFFFF, 0x55555555, 3]
    want = np.asarray(jdev.popcount_rows(jnp.asarray(words)))
    assert np.array_equal(K.popcount_rows(_t(words)).numpy(), want)


def test_word_layout_matches_jax_package():
    rng = np.random.default_rng(SEED + 5)
    host = rng.integers(0, 1 << 63, size=(3, 1024), dtype=np.uint64)
    host[0, 0] = np.uint64(0xFFFFFFFFFFFFFFFF)
    rows = tdev.to_device_words(host, device="cpu")
    assert rows.dtype == torch.int32 and tuple(rows.shape) == (3, W)
    assert np.array_equal(_u32(rows), jdev.to_device_words(host))
    assert np.array_equal(tdev.from_device_words(rows), host)
    assert tdev._INIT == {op: int(np.int32(np.uint32(v).view(np.int32))) for op, v in jdev._INIT.items()}


def _expansion_containers(pkg):
    """The same array, bitmap and run containers built in either package,
    with the expansion's edge cases: adjacent runs (a stop on the next
    run's start bit), a run ending at 65535, runs across word boundaries,
    array values on bits 0, 31, 32 and 65535."""
    rng = np.random.default_rng(SEED + 3)
    out = [
        pkg.ArrayContainer(np.array([0, 31, 32, 63, 64, 65535], dtype=np.uint16)),
        pkg.RunContainer(  # adjacent: [10,19] then [20,29]; [31,32] spans words
            np.array([10, 20, 31, 64], dtype=np.uint16),
            np.array([9, 9, 1, 100], dtype=np.uint16),
        ),
        pkg.RunContainer(  # ends at 65535, its stop toggle never fires
            np.array([0, 65000], dtype=np.uint16), np.array([0, 535], dtype=np.uint16)
        ),
        pkg.RunContainer(np.array([0], dtype=np.uint16), np.array([65535], dtype=np.uint16)),
    ]
    for j in range(9):
        if j % 3 == 0:
            vals = np.sort(rng.choice(65536, 300, replace=False)).astype(np.uint16)
            out.append(pkg.ArrayContainer(vals))
        elif j % 3 == 1:
            w = np.zeros(1024, np.uint64)
            for x in rng.choice(65536, 6000, replace=False):
                w[x >> 6] |= np.uint64(1) << np.uint64(x & 63)
            out.append(pkg.BitmapContainer(w))
        else:
            s = np.sort(rng.choice(np.arange(0, 65000, 100), 20, replace=False)).astype(np.uint16)
            ln = rng.integers(0, 90, size=20).astype(np.uint16)
            out.append(pkg.RunContainer(s, ln))
    return out


def test_expansion_matches_expand_rows_device_and_host():
    jp = jstore.RowPayload.from_containers(_expansion_containers(jc))
    tp = tstore.RowPayload.from_containers(_expansion_containers(tc))
    n = jp.n_rows
    want_dev = np.asarray(pk.expand_rows_device(n, *jp.device_kernel_args()))
    want_host = jp.expand_host()
    got = tp.expand_device("cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == (n, W)
    assert np.array_equal(_u32(got), want_dev)
    assert np.array_equal(_u32(got), want_host)
    assert np.array_equal(tp.expand_host(), want_host)


@pytest.mark.parametrize("chunk_rows", [1, 3, 128])
def test_plan_chunks_covers_every_row_once_within_segments(chunk_rows):
    rng = np.random.default_rng(SEED + chunk_rows)
    lens = rng.integers(0, 400, size=40)
    lens[[0, 7, 39]] = 0  # empty segments get no chunk
    offsets = np.concatenate(([0], np.cumsum(lens)))
    chunks = K.plan_chunks(offsets, chunk_rows)
    group, begin, end = chunks.T
    assert np.all(end > begin) and np.all(end - begin <= chunk_rows)
    assert np.all(begin >= offsets[group]) and np.all(end <= offsets[group + 1])
    covered = np.concatenate([np.arange(b, e) for b, e in zip(begin, end)])
    assert np.array_equal(np.sort(covered), np.arange(offsets[-1]))


def test_wrappers_reject_what_the_kernels_do_not_take():
    words = torch.zeros((4, W), dtype=torch.int32)
    with pytest.raises(TypeError):
        K.group_reduce(words.to(torch.int64), K.SegmentPlan.dense(2, 2))
    with pytest.raises(ValueError):
        K.group_reduce(words[:, :100], K.SegmentPlan.dense(2, 2))
    with pytest.raises(ValueError):
        K.group_reduce(words, K.SegmentPlan.dense(3, 2))  # plan past the rows
    with pytest.raises(ValueError):
        K.group_reduce(words, K.SegmentPlan.dense(2, 2), op="nand")
    with pytest.raises(TypeError):
        K.group_reduce(
            words, K.SegmentPlan.dense(2, 2), row_map=torch.zeros(4, dtype=torch.int32)
        )


# (G, M, k): odd and even M, k inside and past the counter's width (the
# kernel compares the low L bits of k; the device path decides k >> L != 0
# on the host)
THRESHOLD_CASES = [
    (1, 1, 1), (3, 5, 2), (2, 7, 3), (4, 13, 5), (1, 9, 20), (2, 16, 16),
    (3, 33, 17), (2, 64, 33), (1, 100, 300), (5, 6, 6),
]


def _threshold_words(rng, shape, density):
    """uint32 words with each bit set with probability ``density``, so
    per-position counts spread around the thresholds."""
    bits = rng.random((*shape, 32)) < density
    return np.packbits(bits, axis=-1, bitorder="little").view(np.uint32).reshape(shape)


@pytest.mark.parametrize("g,m,k", THRESHOLD_CASES)
def test_threshold_plain_matches_jax_threshold_kernel(g, m, k):
    from roaringbitmap_tpu.query import kernels as jk

    rng = np.random.default_rng(SEED + g * 1000 + m)
    words = _threshold_words(rng, (g, m, W), min(0.9, (k + 0.5) / max(m, 1)))
    n_slices = max(1, m.bit_length())
    want_w, want_c = jk._threshold_kernel(k, n_slices)(jnp.asarray(words))
    got_w, got_c = K.threshold_rows(_t(words), k, n_slices)  # CPU: the plain version
    assert np.array_equal(_u32(got_w), np.asarray(want_w))
    assert np.array_equal(got_c.numpy(), np.asarray(want_c))
    assert got_c.dtype == torch.int32


def test_threshold_plain_drops_the_carry_out_of_the_top_slice():
    """A counter narrower than M wraps, in both packages alike."""
    from roaringbitmap_tpu.query import kernels as jk

    words = np.full((1, 9, W), 0xFFFFFFFF, dtype=np.uint32)  # every count is 9
    for n_slices, k in ((2, 1), (3, 1), (3, 2), (4, 9)):
        want_w, _ = jk._threshold_kernel(k, n_slices)(jnp.asarray(words))
        got_w, _ = K.threshold_rows(_t(words), k, n_slices)
        assert np.array_equal(_u32(got_w), np.asarray(want_w))
    assert int(K.threshold_rows(_t(words), 2, 3)[1][0]) == 0  # 9 mod 8 = 1 < 2


def test_threshold_rejects_what_the_kernel_does_not_take():
    words = torch.zeros((2, 3, W), dtype=torch.int32)
    for bad in (0, 33):
        with pytest.raises(ValueError):
            K.threshold_rows(words, 2, bad)
    with pytest.raises(ValueError):
        K.threshold_rows(words.view(6, W), 2, 3)
    with pytest.raises(TypeError):
        K.threshold_rows(words.to(torch.int64), 2, 3)
    with pytest.raises(ValueError):
        K.threshold_rows(words, -1, 3)


# (S, Q, op) -> the tiled walk's plan: (tile words, CTAs an SM, queries a
# launch, launches)
TILE_PLANS = [
    ((32, 64, "GE"), (512, 3, 64, 1)),  # the 100M-row index's batch
    ((32, 2000, "GE"), (512, 3, 512, 4)),  # 2 KiB of packed bits a launch
    ((32, 600, "RANGE"), (512, 3, 256, 3)),  # two walks: half the queries
    ((1, 2, "EQ"), (1024, 2, 2, 1)),  # registers cap the CTAs
    ((70, 100, "EQ"), (128, 5, 100, 1)),  # shared memory caps the warps
    ((200, 10, "RANGE"), (256, 1, 10, 1)),  # a tie in warps: the larger tile
    ((396, 2, "GE"), (128, 1, 2, 1)),  # the deepest tile
]


@pytest.mark.parametrize("shape,want", TILE_PLANS, ids=lambda v: "-".join(map(str, v)))
def test_oneil_tile_plan_arithmetic(shape, want):
    s, q, op = shape
    plan = K.oneil_tile_plan(s, q, op)
    ctas = K.tile_ctas_per_sm(s, plan.tile_words)
    launches = -(-q // plan.query_chunk)
    assert (plan.tile_words, ctas, plan.query_chunk, launches) == want
    # no other tile keeps more warps resident
    warps = ctas * plan.tile_words // K.TILE_VEC
    assert all(K.tile_ctas_per_sm(s, t) * t // K.TILE_VEC <= warps for t in K.TILE_WORDS)
    w = 2 if op == "RANGE" else 1
    words = w * ((s + 31) // 32)
    # the launch's shared memory: slice rows, ebm, fixed, the packed bits
    # (padded to 16 bytes) and a group's masks, 16 walks x S (padded to 4)
    masks = 4 * K.TILE_GROUP_WALKS * (-(-s // 4) * 4)
    assert plan.smem_bytes == 4 * (
        (s + 2) * plan.tile_words + -(-plan.query_chunk * words // 4) * 4) + masks
    assert plan.smem_bytes + K.TILE_STATIC_SMEM <= K.SMEM_PER_BLOCK
    worst = 4 * (s + 2) * plan.tile_words + K.TILE_BITS_BYTES + masks + K.TILE_STATIC_SMEM
    assert ctas * (worst + K.SMEM_RESERVED_PER_BLOCK) <= K.SMEM_PER_SM
    assert ctas * plan.tile_words // K.TILE_VEC * K.TILE_REGS <= K.REGS_PER_SM
    assert plan.query_chunk * words * 4 <= K.TILE_BITS_BYTES
    assert (launches - 1) * plan.query_chunk < q <= launches * plan.query_chunk
    assert W % plan.tile_words == 0


def test_oneil_tile_plan_depth_limit():
    assert K.MAX_TILED_SLICES == 396
    for op in ("GE", "RANGE", "EQ"):
        assert K.oneil_tile_plan(K.MAX_TILED_SLICES, 1000, op) is not None
        assert K.oneil_tile_plan(K.MAX_TILED_SLICES + 1, 2, op) is None
    with pytest.raises(ValueError):
        K.oneil_tile_plan(32, 2, "BETWEEN")


def test_oneil_per_query_launcher_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(SEED + 9)
    slices, ebm, fixed, bits = _oneil_inputs(rng, 13, 3, 5, "LE", "cpu")
    before = dict(K.LAUNCHES)
    got = K.oneil_counts_per_query(slices, bits, ebm, fixed, "LE")
    assert torch.equal(got, K.oneil_compare_plain(slices, bits, ebm, fixed, "LE", True)[1])
    assert K.LAUNCHES == before


# (S, K, W) masked popcounts: Q6's price sums, the BSI north star and its
# mesh ranks' rows, a slice count past MAX_GROUP, and the tests' few chunks
GROUP_SHAPES = [
    (24, 9156, 2048), (32, 1526, 2048), (32, 763, 1024), (32, 763, 512), (32, 763, 256),
    (47, K.FILL_CTAS, 512), (47, K.FILL_CTAS - 1, 1024), (300, 9156, 2048), (6, 11, 2048),
    (47, 3, 512), (3, 5, 256), (1, 1, 2048), (2, 1, 256),
]


@pytest.mark.parametrize("s,k,w", GROUP_SHAPES, ids=lambda v: str(v))
def test_masked_popcount_grid_counts_every_slice_row_once(s, k, w):
    """The launch that ``masked_popcount_group`` implies, walked with the
    kernel's index arithmetic (``csrc/reduce.cu`` masked_popcount_kernel):
    every (slice, chunk) row is counted by exactly one (CTA, step, row side
    by side), ragged last groups and steps included, and every slice's
    warps write shared-memory slots that the final reduce reads as its own."""
    g = K.masked_popcount_group(s, k, w)
    assert 1 <= g <= min(s, K.MAX_GROUP)
    vecs = w // 4
    span = min(vecs, K.POP_THREADS)  # threads over one row, each owning vecs / span columns
    side, wps, warps = K.POP_THREADS // span, span // 32, K.POP_THREADS // 32
    assert span * (2 if vecs > K.POP_THREADS else 1) == vecs
    assert ((g + side - 1) // side) * warps * 4 <= 8192  # the launch's shared memory
    n_groups = -(-s // g)
    b = np.arange(k * n_groups)
    chunk, first = b // n_groups, (b % n_groups) * g
    assert np.array_equal(np.bincount(chunk, minlength=k), np.full(k, n_groups))
    counted = np.zeros(s, dtype=np.int64)  # the same walk for every chunk
    for s0 in first[:n_groups]:
        s_end = min(s, s0 + g)
        steps = -(-(s_end - s0) // side)
        slots = {}
        for i in range(steps):
            for warp in range(warps):
                sub = warp // wps  # the side-by-side row this warp's threads read
                if s0 + i * side + sub < s_end:
                    counted[s0 + i * side + sub] += 1
                slots[i * warps + warp] = (i * side + sub, warp % wps)
        for j in range(s_end - s0):  # the final reduce: slice j reads part[j * wps + q]
            assert [slots[j * wps + q] for q in range(wps)] == [(j, q) for q in range(wps)]
    assert np.array_equal(counted, np.full(s, wps))


def test_masked_popcount_group_follows_the_shape():
    # Q6's price column (24 slices, 9,156 chunks): every mask row read once
    assert K.masked_popcount_group(24, 9156, 2048) == 24
    assert K.masked_popcount_group(47, K.FILL_CTAS, 2048) == 47
    # the BSI north star and its mesh ranks' rows fill the card too
    assert K.masked_popcount_group(32, 1526, 2048) == 32
    assert K.masked_popcount_group(32, 763, 256) == 32
    # a few chunks: the slices spread over CTAs, the mask read from L2
    assert K.masked_popcount_group(24, 4, 2048) == 1
    assert K.masked_popcount_group(47, K.FILL_CTAS - 1, 2048) == 24
    # narrow rows: a CTA reads 2 or 4 rows side by side, so G rounds up to them
    assert K.masked_popcount_group(24, 4, 512) == 2
    assert K.masked_popcount_group(24, 4, 256) == 4
    assert K.masked_popcount_group(3, 4, 256) == 3
    # past MAX_GROUP the slices split however many chunks there are
    assert K.masked_popcount_group(300, 9156, 2048) == K.MAX_GROUP
    for bad in ((0, 5, 2048), (3, 0, 2048), (3, 5, 100)):
        with pytest.raises(ValueError):
            K.masked_popcount_group(*bad)


def test_masked_popcount_launch_keys():
    assert {"rb_popcount_rows", "rb_popcount_rows[masked]", "rb_popcount_rows[mask-once]"} <= set(K.KERNELS)
    assert {"rb_popcount_rows[masked]", "rb_popcount_rows[mask-once]"} <= set(K.LAUNCHES)


# ---------------------------------------------------------------------------
# the CUDA kernels on the card, against their plain versions
# ---------------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("op", OPS)
def test_cuda_group_reduce_matches_plain_version(op):
    _need_card()
    rng = np.random.default_rng(SEED)
    g, m, n = 7, 300, 1500
    words = _t(_words(rng, (g * m, W), op)).cuda()
    offsets = np.concatenate(([0], np.cumsum([1, 1, 129, 700, 2, 0, 667])))
    slots = np.sort(rng.choice(g * m, size=n, replace=False))
    src_map = np.full(g * m, n, dtype=np.int64)
    src_map[slots] = rng.permutation(n)
    row_map = torch.from_numpy(src_map).cuda()
    for plan, src, rmap in (
        (K.SegmentPlan.dense(g, m, chunk_rows=64), words, None),
        (K.SegmentPlan.csr(offsets, chunk_rows=50), words[:n], None),
        (K.SegmentPlan.dense(g, m, chunk_rows=37), words[:n], row_map),
    ):
        before = sum(K.LAUNCHES.values())
        got = K.group_reduce(src, plan, op, row_map=rmap)
        torch.cuda.synchronize()
        assert sum(K.LAUNCHES.values()) == before + 1
        assert torch.equal(got, K.group_reduce_plain(src, plan, op, row_map=rmap))


@pytest.mark.cuda
def test_cuda_popcount_matches_plain_version():
    _need_card()
    rng = np.random.default_rng(SEED)
    words = _words(rng, (513, W), "xor")
    words[0, :4] = [0, 0xFFFFFFFF, 1, 0x80000000]
    words = _t(words).cuda()
    before = K.LAUNCHES["rb_popcount_rows"]
    assert torch.equal(K.popcount_rows(words), K.popcount_rows_plain(words))
    assert K.LAUNCHES["rb_popcount_rows"] == before + 1


@pytest.mark.cuda
def test_cuda_expansion_matches_host_expansion():
    _need_card()
    rng = np.random.default_rng(SEED)
    cs = _expansion_containers(tc)
    for _ in range(20):
        vals = np.sort(rng.choice(65536, int(rng.integers(1, 9000)), replace=False))
        c = tc.ArrayContainer(vals.astype(np.uint16)).to_efficient_non_run()
        cs.append(c.run_optimize() if rng.random() < 0.3 else c)
    payload = tstore.RowPayload.from_containers(cs)
    got = payload.expand_device("cuda").cpu().numpy().view(np.uint32)
    assert np.array_equal(got, payload.expand_host())


ONEIL_OPS = ("EQ", "NEQ", "GT", "LT", "LE", "GE", "RANGE")


def _oneil_inputs(rng, s, k, q, op, device, tail_words=None):
    """Slices whose columns hold a random ``value`` with each bit flipped
    with probability 1/32, so a good share of them equal it and EQ/NEQ
    answers are far from empty or full; the ebm is ~3/4 of the columns
    (the last chunk cleared from word ``tail_words`` on, when given, as the
    last chunk of a real index is) and fixed a subset of it. Query 0 is
    ``value`` (RANGE: value +- 2**(s//2)), the others are drawn like the
    columns."""

    def rand():
        return rng.integers(0, 1 << 32, size=(k, W), dtype=np.uint64).astype(np.uint32)

    def near(v):
        return v ^ sum(1 << i for i in np.flatnonzero(rng.random(s) < 1 / 32).tolist())

    value = (1 << (s - 1)) | sum(
        int(b) << i for i, b in enumerate(rng.integers(0, 2, size=max(s - 2, 0)))
    )
    ebm = rand() | rand()
    if tail_words is not None:
        ebm[-1, tail_words:] = 0
    slices = np.stack([
        (rand() & rand() & rand() & rand() & rand()) ^ np.uint32(0xFFFFFFFF if value >> i & 1 else 0)
        for i in range(s)
    ]) & ebm
    fixed = ebm & rand()

    def pred(v):
        return [v >> i & 1 for i in range(s - 1, -1, -1)]

    walks = []
    for j in range(q):
        v = value if j == 0 else near(value)
        d = 1 << (s // 2)
        walks.append([pred(max(v - d, 0)), pred(min(v + d, (1 << s) - 1))] if op == "RANGE" else [pred(v)])
    bits = np.asarray(walks, dtype=np.int32)
    return [_t(a).to(device) for a in (slices, ebm, fixed)] + [torch.from_numpy(bits).to(device)]


def _oneil_key(s, q, op):
    """The launch key ``oneil_compare`` counts for Q predicates over S
    slices, and how many launches it adds."""
    if q == 1:
        return "rb_oneil_compare", 1
    plan = K.oneil_tile_plan(s, q, op)
    return ("rb_oneil_compare[batched-deep]", 1) if plan is None else (
        "rb_oneil_compare[batched]", -(-q // plan.query_chunk))


def _cuda_oneil_case(slices, bits, ebm, fixed, op, nontrivial=True):
    s, q = slices.shape[0], bits.shape[0]
    count_only = q > 1
    key, n = _oneil_key(s, q, op)
    before = dict(K.LAUNCHES)
    got_out, got_cards = K.oneil_compare(slices, bits, ebm, fixed, op, count_only)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {**before, key: before[key] + n}
    want_out, want_cards = K.oneil_compare_plain(slices, bits, ebm, fixed, op, count_only)
    if nontrivial:  # neither empty nor all of fixed: a wrong epilogue cannot pass
        assert 0 < int(want_cards.sum()) < q * int(K.popcount_rows_plain(fixed).sum())
    assert torch.equal(got_cards, want_cards)
    if not count_only:
        assert torch.equal(got_out, want_out)


# (S, K, Q): one query; Q >= 2 on the tiled walk at every tile size it
# picks (S = 1 and 13: 1024 words, 32: 512, 70: 128), with Q ragged against
# the query groups; and a depth past the tiled walk's limit
ONEIL_CASES = [
    (32, 37, 1), (70, 5, 1), (13, 9, 17),
    (1, 3, 2), (13, 5, 13), (32, 7, 64), (70, 3, 100), (32, 4, 2),
    (K.MAX_TILED_SLICES + 9, 2, 2),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ONEIL_CASES, ids=lambda c: "S{}-K{}-Q{}".format(*c))
@pytest.mark.parametrize("op", ONEIL_OPS)
def test_cuda_oneil_compare_matches_plain_version(op, case):
    _need_card()
    s, k, q = case
    rng = np.random.default_rng(SEED + s * 1000 + q)
    # the last chunk of the ebm ends part way, as the 100M-row index's does
    slices, ebm, fixed, bits = _oneil_inputs(rng, s, k, q, op, "cuda", tail_words=1800)
    _cuda_oneil_case(slices, bits, ebm, fixed, op, nontrivial=8 <= s <= 70)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ONEIL_OPS)
def test_cuda_oneil_batched_extreme_thresholds(op):
    """Thresholds of all zeros and all ones: every step of a walk takes the
    same side of the branch on the predicate bit."""
    _need_card()
    rng = np.random.default_rng(SEED + 7)
    s, k = 32, 6
    slices, ebm, fixed, _ = _oneil_inputs(rng, s, k, 1, op, "cuda")
    zero, ones = [0] * s, [1] * s
    walks = [[zero, ones], [ones, ones], [zero, zero]] if op == "RANGE" else [[zero], [ones], [zero]]
    bits = torch.tensor(walks, dtype=torch.int32, device="cuda")
    for f in (fixed, ebm):
        _cuda_oneil_case(slices, bits, ebm, f, op, nontrivial=False)


@pytest.mark.cuda
def test_cuda_oneil_per_query_launcher_matches_tiled_walk():
    _need_card()
    rng = np.random.default_rng(SEED + 8)
    slices, ebm, fixed, bits = _oneil_inputs(rng, 32, 9, 40, "GE", "cuda")
    before = K.LAUNCHES["rb_oneil_compare[batched-deep]"]
    per_query = K.oneil_counts_per_query(slices, bits, ebm, fixed, "GE")
    assert K.LAUNCHES["rb_oneil_compare[batched-deep]"] == before + 1
    assert torch.equal(per_query, K.oneil_compare(slices, bits, ebm, fixed, "GE", True)[1])


@pytest.mark.cuda
def test_cuda_masked_popcount_and_wide_reduce_match_plain_versions():
    _need_card()
    rng = np.random.default_rng(SEED)
    slices, ebm, fixed, _ = _oneil_inputs(rng, 6, 11, 1, "GE", "cuda")
    before = K.LAUNCHES["rb_popcount_rows[masked]"]
    assert torch.equal(K.popcount_rows(slices, mask=fixed), K.popcount_rows_plain(slices, mask=fixed))
    assert K.LAUNCHES["rb_popcount_rows[masked]"] == before + 1
    for op in OPS:
        words = _t(_words(rng, (1000, W), op)).cuda()
        before = K.LAUNCHES["wide_reduce_cardinality"]
        red, card = K.wide_reduce_cardinality(words, op)
        want_red, want_card = K.wide_reduce_cardinality_plain(words, op)
        assert torch.equal(red, want_red) and int(card) == int(want_card), op
        assert K.LAUNCHES["wide_reduce_cardinality"] == before + 1



def _sparse_mask(gen, k, w, per_chunk=400):
    """int32 ``[k, w]`` with about ``per_chunk`` bits set a 2048-word chunk
    (fewer at narrower rows), as Q6's discount EQ sets hold."""
    n_bits = k * w * 32
    pos = torch.unique(torch.randint(0, n_bits, (max(1, per_chunk * n_bits // 65536),),
                                     device="cuda", generator=gen))
    words = torch.zeros(k * w, dtype=torch.int64, device="cuda")
    words.scatter_add_(0, pos >> 5, torch.ones_like(pos) << (pos & 31))  # distinct bits: + is |
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32).view(k, w)


@pytest.mark.cuda
@pytest.mark.parametrize("w", K.ROW_WIDTHS)
@pytest.mark.parametrize("s", [1, 3, 24, 47])
@pytest.mark.parametrize("k", [5, K.FILL_CTAS])
def test_cuda_chunk_major_masked_popcount_matches_plain_version(k, s, w):
    """The chunk-major masked popcount bit for bit against its plain version,
    below the card's fill (G < S where S passes the rows a CTA reads side by
    side) and at it (G = S), at every row width, against masks all clear, all
    set and sparse; one ``[masked]`` launch a call, ``[mask-once]`` when G = S."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1000 * s + w + k)
    g = K.masked_popcount_group(s, k, w)
    assert g == s if k == K.FILL_CTAS else (g < s or s <= 4)
    slices = torch.randint(-(1 << 31), 1 << 31, (s, k, w), dtype=torch.int32, device="cuda",
                           generator=gen)
    masks = {
        "clear": torch.zeros((k, w), dtype=torch.int32, device="cuda"),
        "set": torch.full((k, w), -1, dtype=torch.int32, device="cuda"),
        "sparse": _sparse_mask(gen, k, w),
    }
    for name, mask in masks.items():
        before = dict(K.LAUNCHES)
        got = K.popcount_rows(slices, mask=mask)
        assert torch.equal(got, K.popcount_rows_plain(slices, mask=mask)), name
        assert K.LAUNCHES["rb_popcount_rows[masked]"] == before["rb_popcount_rows[masked]"] + 1
        assert (K.LAUNCHES["rb_popcount_rows[mask-once]"]
                == before["rb_popcount_rows[mask-once]"] + (g == s))
    assert int(got.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("g,m,k", THRESHOLD_CASES + [(31, 1000, 64), (1, 997, 1500), (2, 300, 200)])
def test_cuda_threshold_matches_plain_version(g, m, k):
    """rb_threshold against its plain version, one launch per call, at odd
    M, G = 1, and k past the counter's width."""
    _need_card()
    rng = np.random.default_rng(SEED + g + m)
    words = _t(_threshold_words(rng, (g, m, W), min(0.9, (k + 0.5) / m))).cuda()
    n_slices = max(1, m.bit_length())
    before = K.LAUNCHES["rb_threshold"]
    got_w, got_c = K.threshold_rows(words, k, n_slices)
    torch.cuda.synchronize()
    assert K.LAUNCHES["rb_threshold"] == before + 1
    want_w, want_c = K.threshold_rows_plain(words, k, n_slices)
    assert torch.equal(got_w, want_w) and torch.equal(got_c, want_c)
