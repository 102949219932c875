"""The port's overlap shipping lane and payload expansion against the JAX
package.

``expand_rows_plain`` (the plain version of ``rb_expand_rows``) is held
against the JAX package's ``expand_rows_device`` on the same payloads:
census-shaped containers, adjacent runs, a run ending at 65535, a full
run container, a 4,096-value array and bitmap rows. ``run_pipelined`` and
``execute_pipelined`` must equal serial execution and the JAX package's
pipelined entry points, serialized byte for byte; the lane's window, orphan
reap, threading switch and error contract (a failed staging re-raises,
with no synchronous degrade) are exercised on their own. The port's
device path runs on CPU tensors (``aggregation.config.device = "cpu"``);
the ``cuda``-marked tests at the end run the kernel and the lane on the
card and skip without one.
"""

import threading
import time

import numpy as np
import pytest
import torch

from roaringbitmap_tpu import Q as JQ
from roaringbitmap_tpu.models import container as jc
from roaringbitmap_tpu.models.roaring import RoaringBitmap as JRB
from roaringbitmap_tpu.ops import pallas_kernels as pk
from roaringbitmap_tpu.parallel import overlap as joverlap
from roaringbitmap_tpu.parallel import store as jstore
from roaringbitmap_tpu.query import exec as jexec

from roaringbitmap_tpu_torch import FastAggregation as TFA
from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch import query as tq
from roaringbitmap_tpu_torch.models import container as tc
from roaringbitmap_tpu_torch.ops import kernels as K
from roaringbitmap_tpu_torch.parallel import aggregation, overlap, store
from roaringbitmap_tpu_torch.utils import datasets

SEED = 0xFEEF1F0
W = 2048


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    """The port's device path on CPU tensors; both packages' pack caches
    and lanes emptied around each test (the JAX ones are process-wide and
    a later test of that package reads their byte ledgers)."""
    monkeypatch.setattr(aggregation.config, "device", "cpu")
    store.PACK_CACHE.close()
    tq.DEFAULT_CACHE.clear()
    yield
    overlap.LANE.drain()
    overlap.LANE.configure("auto")
    joverlap.LANE.drain()
    store.PACK_CACHE.close()
    jstore.PACK_CACHE.close()
    tq.DEFAULT_CACHE.clear()


def _u32(t):
    return np.ascontiguousarray(t.numpy()).view(np.uint32)


def _both(values, run_optimize=False):
    """The same bitmap in both packages, checked byte for byte."""
    t, j = TRB(values), JRB(values)
    if run_optimize:
        t.run_optimize()
        j.run_optimize()
    assert t.serialize() == j.serialize()
    return t, j


# ---------------------------------------------------------------------------
# the payload expansion
# ---------------------------------------------------------------------------


def _edge_containers(pkg):
    """The kernel's edge cases, built the same way in either package."""
    rng = np.random.default_rng(SEED + 11)
    w = np.zeros(1024, np.uint64)
    for x in rng.choice(65536, 9000, replace=False):
        w[x >> 6] |= np.uint64(1) << np.uint64(x & 63)
    full_words = np.full(1024, np.uint64(0xFFFFFFFFFFFFFFFF))
    # a run container of 2,047 runs: every other pair of bits, the last
    # ending at 65535
    starts = np.arange(0, 65536, 32, dtype=np.int64)[:2047]
    lengths = np.full(2047, 15, dtype=np.int64)
    lengths[-1] = 65535 - starts[-1]
    return [
        pkg.RunContainer(  # adjacent runs: a stop on the next run's start bit
            np.array([0, 10, 20, 31, 32, 96], dtype=np.uint16),
            np.array([9, 9, 10, 0, 63, 1000], dtype=np.uint16),
        ),
        pkg.RunContainer(  # ends at 65535: no stop bit, fills through word 2047
            np.array([7, 65000], dtype=np.uint16), np.array([0, 535], dtype=np.uint16)
        ),
        pkg.RunContainer(np.array([0], dtype=np.uint16), np.array([65535], dtype=np.uint16)),
        pkg.RunContainer(starts.astype(np.uint16), lengths.astype(np.uint16)),
        pkg.ArrayContainer(np.sort(rng.choice(65536, 4096, replace=False)).astype(np.uint16)),
        pkg.ArrayContainer(np.array([0, 31, 32, 2046 * 32 + 31, 65535], dtype=np.uint16)),
        pkg.BitmapContainer(w),
        pkg.BitmapContainer(full_words),
    ]


def _census_containers(pkg_rb, n=12, run_optimize=False):
    base, _real = datasets.load_or_synthesize("census1881")
    out = []
    for vals in base[:n]:
        b = pkg_rb(vals)
        if run_optimize:
            b.run_optimize()
        out.extend(b.high_low_container.containers)
    return out


PAYLOADS = {
    "edge-cases": lambda pkg, rb: _edge_containers(pkg),
    "census": lambda pkg, rb: _census_containers(rb),
    "census-run-optimized": lambda pkg, rb: _census_containers(rb, run_optimize=True),
    "mixed": lambda pkg, rb: _edge_containers(pkg)[::-1] + _census_containers(rb, 4, True),
}


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_expand_rows_plain_matches_jax_expand_rows_device(name):
    jp = jstore.RowPayload.from_containers(PAYLOADS[name](jc, JRB))
    tp = store.RowPayload.from_containers(PAYLOADS[name](tc, TRB))
    n = jp.n_rows
    assert tp.n_rows == n and tp.nbytes == jp.nbytes
    want = np.asarray(pk.expand_rows_device(n, *jp.device_kernel_args()))
    got = K.expand_rows_plain(n, *tp.materialize(), "cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == (n, W)
    assert np.array_equal(_u32(got), want)
    # the wrapper on a CPU device is the plain version
    before = K.LAUNCHES["rb_expand_rows"]
    assert torch.equal(K.expand_rows(n, *tp.materialize(), "cpu"), got)
    assert K.LAUNCHES["rb_expand_rows"] == before
    assert np.array_equal(_u32(got), tp.expand_host())


def test_expand_rows_rejects_a_payload_that_does_not_fill_its_rows():
    tp = store.RowPayload.from_containers(_edge_containers(tc))
    parts = list(tp.materialize())
    with pytest.raises(ValueError, match="each row holds one"):
        K.expand_rows(tp.n_rows + 1, *parts, "cpu")
    bad = list(parts)
    bad[6] = parts[6] + 1  # run_counts no longer sum to the intervals
    with pytest.raises(ValueError, match="run_counts"):
        K.expand_rows(tp.n_rows, *bad, "cpu")
    bad = list(parts)
    bad[0] = parts[0] + tp.n_rows  # array rows outside the block
    with pytest.raises(ValueError, match="outside the block"):
        K.expand_rows(tp.n_rows, *bad, "cpu")
    bad = list(parts)
    bad[0] = parts[0].copy()
    bad[0][-1] = bad[0][0]  # one row twice, another never written
    with pytest.raises(ValueError, match="repeats"):
        K.expand_rows(tp.n_rows, *bad, "cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        K.expand_rows(tp.n_rows, *parts, "meta")


# ---------------------------------------------------------------------------
# the lane's contract
# ---------------------------------------------------------------------------


def _corpus(n=12, size=3000, seed=SEED, n_keys=12):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        keys = rng.choice(n_keys, size=int(rng.integers(4, n_keys)), replace=False)
        vals = np.concatenate([
            (int(k) << 16) + rng.choice(1 << 16, size=int(rng.integers(50, size)), replace=False)
            for k in keys
        ])
        out.append(_both(np.unique(vals).astype(np.uint32), run_optimize=i % 3 == 0))
    return [t for t, _ in out], [j for _, j in out]


TB, JB = _corpus()


def test_prefetch_stages_the_pack_the_consumer_then_hits():
    lane = overlap.ShipLane(threading_mode="on")
    st = lane.prefetch(TB[:4], None, "cpu")
    assert st is not None
    assert lane.prefetch(TB[:4], None, "cpu") is st  # already staged: the same ticket
    packed = lane.join(TB[:4], "or")
    assert packed is not None and packed._device_words is not None
    hits = store.PACK_CACHE.hits
    assert store.packed_for(TB[:4], device="cpu") is packed
    assert store.PACK_CACHE.hits == hits + 1
    stats = lane.stats()
    assert stats["pending"] == 0 and stats["staged_s"] > 0
    assert 0.0 <= stats["hidden_s"] <= stats["staged_s"]
    assert lane.join(TB[:4], "or") is None  # joined once: nothing left


def _blocking_pack(monkeypatch):
    """Make the lane's pack wait on an event the test sets."""
    gate, entered = threading.Event(), threading.Event()
    real = store.packed_for

    def slow(*args, **kwargs):
        entered.set()
        assert gate.wait(30)
        return real(*args, **kwargs)

    monkeypatch.setattr(store, "packed_for", slow)
    return gate, entered


def test_prefetch_past_the_window_returns_none(monkeypatch):
    lane = overlap.ShipLane(threading_mode="on")
    gate, entered = _blocking_pack(monkeypatch)
    first = lane.prefetch(TB[:3], None, "cpu")
    assert first is not None and entered.wait(30)
    assert lane.prefetch(TB[3:6], None, "cpu") is None  # the window is full
    gate.set()
    assert lane.join(TB[:3], "or") is not None
    assert lane.prefetch(TB[3:6], None, "cpu") is not None  # a free slot again
    lane.drain()
    assert lane.stats()["pending"] == 0


def test_a_finished_orphan_is_reaped():
    lane = overlap.ShipLane(threading_mode="on")
    orphan = lane.prefetch(TB[:3], None, "cpu")
    orphan.future.result(timeout=30)  # finished, never joined
    st = lane.prefetch(TB[3:6], None, "cpu")
    assert st is not None and st is not orphan
    assert lane.join(TB[:3], "or") is None  # the orphan's slot was dropped
    assert lane.join(TB[3:6], "or") is not None


def test_threading_off_stages_nothing():
    lane = overlap.ShipLane(threading_mode="off")
    assert not lane.threaded()
    assert lane.prefetch(TB[:4], None, "cpu") is None
    assert len(store.PACK_CACHE) == 0 and lane.stats()["pending"] == 0
    lane.configure("on")
    assert lane.threaded()
    with pytest.raises(ValueError):
        lane.configure("sometimes")


def test_a_failed_staging_raises_at_join_with_no_degrade(monkeypatch):
    lane = overlap.ShipLane(threading_mode="on")

    def broken(*args, **kwargs):
        raise RuntimeError("staging failed")

    monkeypatch.setattr(store, "packed_for", broken)
    assert lane.prefetch(TB[:4], None, "cpu") is not None
    with pytest.raises(RuntimeError, match="staging failed"):
        lane.join(TB[:4], "or")
    assert len(store.PACK_CACHE) == 0  # nothing packed behind the error
    assert lane.prefetch(TB[4:8], None, "cpu") is not None
    with pytest.raises(RuntimeError, match="staging failed"):
        lane.wait(TB[4:8])
    assert lane.prefetch(TB[:2], None, "cpu") is not None
    with pytest.raises(RuntimeError, match="staging failed"):
        lane.drain()
    # a failed orphan re-raises at the prefetch that reaps it
    assert lane.prefetch(TB[2:5], None, "cpu").future.exception(timeout=30) is not None
    with pytest.raises(RuntimeError, match="staging failed"):
        lane.prefetch(TB[5:8], None, "cpu")


def test_aggregation_prefetch_takes_the_engines_gate():
    overlap.LANE.configure("on")
    assert aggregation.prefetch(TB[0], "or") is None  # one bitmap: nothing to pack
    assert aggregation.prefetch(TB[:4], "or", mode="cpu") is None  # the CPU route
    disjoint = [TRB([1, 2, 3]), TRB([(5 << 16) + 1])]
    assert aggregation.prefetch(disjoint, "and", mode="device") is None  # trivial AND
    st = aggregation.prefetch(TB[:4], "and", mode="device")
    assert st is not None
    assert overlap.LANE.join(TB[:4], "and") is not None
    assert overlap.LANE.join(TB[:4], "or") is None


# ---------------------------------------------------------------------------
# the pipelined entry points against serial execution and the JAX package
# ---------------------------------------------------------------------------


JOBS = [(slice(0, 5), "or"), (slice(3, 9), "and"), (slice(4, 12), "xor"), (slice(6, 12), "or")]


@pytest.mark.parametrize("mode", ["device", "auto"])
def test_run_pipelined_matches_serial_and_the_jax_package(mode):
    overlap.LANE.configure("on")
    t_jobs = [(TB[s], op) for s, op in JOBS]
    j_jobs = [(JB[s], op) for s, op in JOBS]
    fns = {"or": TFA.or_, "and": TFA.and_, "xor": TFA.xor}
    serial = [fns[op](*bms, mode=mode) for bms, op in t_jobs]
    store.PACK_CACHE.close()
    got = overlap.run_pipelined(t_jobs, mode=mode)
    want = joverlap.run_pipelined(j_jobs, mode=mode)
    for g, s, w in zip(got, serial, want):
        assert g.serialize() == s.serialize() == w.serialize()
    if mode == "device":
        # every job after the first was staged by the lane and joined
        assert overlap.LANE.stats()["staged_s"] > 0
    assert overlap.LANE.stats()["pending"] == 0


def _queries(Q, L):
    hot = Q.and_(L[0], L[1])
    return [
        Q.andnot(Q.or_(*L[:5]), Q.or_(*L[8:11])) | Q.threshold(2, *L[2:7]),
        Q.or_(hot, Q.and_(*L[3:7])),
        Q.xor(*L[4:10]),
        Q.or_(hot, L[9], L[10], L[11]) - L[2],
    ]


@pytest.mark.parametrize("mode", ["device", "cpu"])
def test_execute_pipelined_matches_serial_and_the_jax_package(mode):
    overlap.LANE.configure("on")
    tqs = _queries(tq.Q, [tq.Q.leaf(b) for b in TB])
    jqs = _queries(JQ, [JQ.leaf(b) for b in JB])
    serial = [tq.execute(q, cache=None, mode=mode) for q in tqs]
    store.PACK_CACHE.close()
    got = tq.execute_pipelined(tqs, cache=None, mode=mode)
    want = jexec.execute_pipelined(jqs, cache=None, mode=mode)
    for g, s, w in zip(got, serial, want):
        assert g.serialize() == s.serialize() == w.serialize()
    assert overlap.LANE.stats()["pending"] == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_cuda_expand_rows_matches_plain_version(name):
    _need_card()
    tp = store.RowPayload.from_containers(PAYLOADS[name](tc, TRB))
    want = K.expand_rows_plain(tp.n_rows, *tp.materialize(), "cpu")
    before = K.LAUNCHES["rb_expand_rows"]
    from_numpy = K.expand_rows(tp.n_rows, *tp.materialize(), "cuda")
    from_pinned = tp.expand_device("cuda")  # the pinned staging
    torch.cuda.synchronize()
    assert K.LAUNCHES["rb_expand_rows"] == before + 2
    assert torch.equal(from_numpy.cpu(), want)
    assert torch.equal(from_pinned.cpu(), want)


@pytest.mark.cuda
def test_cuda_run_pipelined_under_an_evicting_budget_matches_serial(monkeypatch):
    """A budget of about one working set: the lane's staged pack (rows
    allocated on the lane stream) is evicted and freed from the consumer's
    side while the next one stages — the ``record_stream`` case."""
    _need_card()
    monkeypatch.setattr(aggregation.config, "device", "cuda")
    overlap.LANE.configure("on")
    t_jobs = [(TB[s], op) for s, op in JOBS] * 3
    fns = {"or": TFA.or_, "and": TFA.and_, "xor": TFA.xor}
    store.PACK_CACHE.close()
    serial = [fns[op](*bms, mode="device") for bms, op in t_jobs]
    budget = store.PACK_CACHE.max_bytes
    biggest = max(
        sum(b.high_low_container.size for b in bms) for bms, _ in t_jobs
    ) * store.ROW_BYTES
    store.PACK_CACHE.configure(biggest + 1)
    try:
        evictions = store.PACK_CACHE.evictions
        got = overlap.run_pipelined(t_jobs, mode="device")
        torch.cuda.synchronize()
        assert store.PACK_CACHE.evictions > evictions
    finally:
        store.PACK_CACHE.configure(budget)
    for g, s in zip(got, serial):
        assert g.serialize() == s.serialize()


def _resident_on_the_card(seed):
    """Four bitmaps whose pack is resident on the card, built and read on
    the consumer's stream; returns them, the pack and its rows."""
    rng = np.random.default_rng(seed)
    bms = [
        TRB(np.unique(np.concatenate([
            (int(k) << 16) + rng.choice(1 << 16, size=2000, replace=False)
            for k in rng.choice(8, size=4, replace=False)
        ])).astype(np.uint32))
        for _ in range(4)
    ]
    packed = store.packed_for(bms, device="cuda")
    before = packed.device_words.cpu()
    return bms, packed, before


def _mutate_one_container(bms):
    """One container of one bitmap, an existing key: a delta repack."""
    b = bms[1]
    b.add((int(b.high_low_container.keys[0]) << 16) | 4321)
    return store.pack_groups(store.group_by_key(bms), "cpu").device_words


_BUSY_CYCLES = 1_000_000_000  # about half a second of a spinning kernel


def _warm_lane(lane):
    """Give the lane its stream, that stream's allocator pool and the
    kernels of a delta patch before a spin. A first device allocation,
    and the first launch of a kernel whose module loads lazily,
    synchronize the whole card: either would order the lane's patch after
    the spin whatever the code does."""
    with torch.cuda.stream(lane._stream(torch.device("cuda"))):
        rows = torch.zeros(2, W, dtype=torch.int32, device="cuda")
        rows.index_copy_(0, torch.tensor([1, 0], device="cuda"), rows.clone())
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_a_reader_of_a_resident_pack_waits_for_the_lanes_delta(monkeypatch):
    """A second thread reads a resident pack while the lane delta-stages
    it, without joining. The patch is queued on the lane stream behind a
    spinning kernel, so a read on the consumer's stream that were not
    ordered after it would see the old rows."""
    _need_card()
    monkeypatch.setattr(aggregation.config, "device", "cuda")
    bms, packed, before = _resident_on_the_card(SEED + 21)
    want = _mutate_one_container(bms)
    real = torch.Tensor.index_copy_

    def behind_a_busy_stream(self, *args):
        if self.is_cuda:
            torch.cuda._sleep(_BUSY_CYCLES)
        return real(self, *args)

    lane = overlap.ShipLane(threading_mode="on")
    _warm_lane(lane)
    monkeypatch.setattr(torch.Tensor, "index_copy_", behind_a_busy_stream)
    delta0 = store.PACK_CACHE.delta_rows
    st = lane.prefetch(bms, None, "cuda")
    assert st is not None
    deadline = time.monotonic() + 30
    while store.PACK_CACHE.delta_rows == delta0:  # the patch is queued
        assert time.monotonic() < deadline
        time.sleep(0.001)
    assert not st.future.done()  # the lane still waits for its stream
    got = packed.device_words.cpu()
    assert not torch.equal(want, before)
    assert torch.equal(got, want)
    assert lane.join(bms, "or") is packed


@pytest.mark.cuda
def test_cuda_the_lanes_delta_waits_for_a_read_queued_before_it(monkeypatch):
    """A read of a resident pack queued on the consumer's stream (behind a
    spinning kernel) before the lane delta-patches the pack on its own
    stream still reads the old rows: the patch waits for it."""
    _need_card()
    monkeypatch.setattr(aggregation.config, "device", "cuda")
    bms, packed, before = _resident_on_the_card(SEED + 22)
    want = _mutate_one_container(bms)
    lane = overlap.ShipLane(threading_mode="on")
    _warm_lane(lane)
    old = torch.empty_like(packed.device_words)  # allocated before the spin
    torch.cuda._sleep(_BUSY_CYCLES)
    old.copy_(packed.device_words)  # queued behind the spin
    assert lane.prefetch(bms, None, "cuda") is not None
    assert lane.join(bms, "or") is packed
    torch.cuda.synchronize()
    assert torch.equal(old.cpu(), before)
    assert torch.equal(packed.device_words.cpu(), want)
