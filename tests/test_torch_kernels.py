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
from roaringbitmap_tpu_torch.parallel import store as tstore

SEED = 0xFEEF1F0
OPS = ("or", "and", "xor")
W = 2048


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
    rows = tdev.to_device_words(host)
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
