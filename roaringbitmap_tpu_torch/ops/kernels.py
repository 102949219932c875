"""Kernel wrappers of the aggregation and BSI paths, their plain versions,
and the device-side row expansion.

Counterpart of ``roaringbitmap_tpu/ops/pallas_kernels.py``. Hand-written
CUDA kernels (``csrc/reduce.cu``, ``csrc/oneil.cu``, ``csrc/query.cu``,
``csrc/columnar.cu``, ``csrc/expand.cu`` and ``csrc/batch.cu``, built by
``_build``):

* ``rb_group_reduce`` — :func:`group_reduce`. Replaces
  ``pallas_kernels.py:grouped_reduce_pallas`` (padded layout, bucketed
  layout, and with a row map the cold ``fused_gather_reduce``) and
  ``pallas_kernels.py:segmented_reduce_pallas`` (skewed layout, as a
  segmented reduce over group offsets). Bound: device-memory bandwidth,
  live rows * 8192 B / 3.35 TB/s; the source note in ``reduce.cu`` says
  how the chunked, atomically combined design meets it.
* ``rb_popcount_rows`` — :func:`popcount_rows`. Replaces the XLA popcount
  epilogue ``roaringbitmap_tpu/ops/device.py:popcount_rows`` (torch has no
  popcount) and, with ``mask=``, the BSI sum's
  ``models/bsi.py:_slice_masked_popcounts``. Bound: the same bandwidth,
  rows * 8192 B (plus the mask rows once, which the chunk-major masked
  walk reads once a chunk where :func:`masked_popcount_group` gives G = S).
* ``rb_oneil_compare`` and ``rb_oneil_counts`` — :func:`oneil_compare`.
  Replace ``pallas_kernels.py:oneil_compare_pallas`` (one query, on
  ``rb_oneil_compare``; bound: device-memory bandwidth, one pass over the
  ``[S, K, 2048]`` slices plus the ebm and fixed words) and the XLA
  ``models/bsi.py:_o_neil_counts_batched`` (Q >= 2 predicates,
  count-only, on the tiled walk ``rb_oneil_counts``; bound: logic
  instructions, one per walk and slice word, above Q ~ 21);
  ``oneil.cu`` says how.
* ``rb_threshold`` — :func:`threshold_rows`. Replaces the XLA
  ``roaringbitmap_tpu/query/kernels.py:_threshold_kernel`` (the
  bit-sliced adder over the rows of a zero-padded ``[G, M, 2048]`` block,
  the >= k compare and the popcount, one launch). Bound: device-memory
  bandwidth, the block read once; ``query.cu`` says how.
* ``rb_pair_rows`` — :func:`pair_rows_reduce`. Replaces the XLA
  ``pallas_kernels.py:pair_rows_reduce`` (``_pair_rows_jit``: gather a
  row of each side per pair, and/or/xor/andnot, popcount, one dispatch),
  the columnar device tier's dense bucket. Bound: device-memory
  bandwidth, two rows read and one written per pair; ``columnar.cu`` says
  how.

* ``rb_pair_rows`` with a null ``out`` — :func:`pair_rows_cardinality`,
  the counts alone. Replaces the XLA ``parallel/batch.py:_step``
  (``cards_only=True``: a ``[Q, K, 2048]`` batch masked against a
  ``[K, 2048]`` filter, one popcount per (query, key)). Bound: the batch
  read once.
* ``rb_pairwise_and_card`` — :func:`pairwise_and_card`. Replaces the XLA
  ``parallel/batch.py:_pairwise_step`` and ``_pairwise_mxu_step`` (the
  all-pairs AND-popcount matrix over ``[n, K, 2048]`` and ``[m, K, 2048]``
  rows). Bound: operations, n * m * K * 65536 bit pairs at the tensor
  cores' single-bit AND-popcount rate (``csrc/mma_probe.cu`` measures
  it); ``batch.cu`` says how its warpgroup design meets it.

* ``rb_expand_rows`` — :func:`expand_rows`. Replaces the XLA
  ``pallas_kernels.py:expand_rows_device`` (``_expand_rows_jit``: the
  compact container payload turned into word rows on the device). Bound:
  device-memory bandwidth, every row written once (8 KiB) and the payload
  read once; ``expand.cu`` says how. The payload's host-to-device copy
  before it is bound by the host link.

:func:`wide_reduce_cardinality` — the flat ``[N, 2048] -> [2048]`` reduce
of ``pallas_kernels.py:wide_reduce_pallas`` /
``wide_reduce_cardinality_pallas`` — is ``rb_group_reduce`` over one
segment plus ``rb_popcount_rows``.

Each wrapper takes its kernel's plain PyTorch version (``ops/device.py``)
only because the tensor it was given lies on the CPU; for a CUDA tensor it
launches the kernel or raises. ``LAUNCHES`` counts kernel launches — one per
launch, nowhere else — so a run can show that it went through the kernels.
It is a view (``observe.CounterMap``) of the registry counter
``rb_tpu_kernel_dispatch_total{kind, engine}``: ``engine="cuda"`` counts
the launches, ``engine="plain"`` the plain versions' calls. The reduce,
popcount, expansion and threshold wrappers hold the ``ops.dispatch`` fault
site (``robust/faults.py``) before they dispatch.

:func:`concat_rows` and :func:`word_test_rows` (the XLA ``concat_rows``
and ``ops/device.py:word_test_rows`` of the columnar device tier) stay
torch ops, as they were XLA outside any Pallas kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import observe as _observe
from ..robust import faults as _faults
from . import device as dev

# launch counts by kernel (and the reduce's three modes, the masked
# popcount and, of those, the ones that read each mask row once (G = S),
# the tiled batched O'Neil walk and the per-query kernel running a
# batch too deep for it); "wide_reduce_cardinality" counts
# calls of that composite on the card, whose reduce and popcount launches
# also count under their own keys
KERNELS = (
    "rb_group_reduce[dense]",
    "rb_group_reduce[csr]",
    "rb_group_reduce[rowmap]",
    "rb_popcount_rows",
    "rb_popcount_rows[masked]",
    "rb_popcount_rows[mask-once]",
    "rb_oneil_compare",
    "rb_oneil_compare[batched]",
    "rb_oneil_compare[batched-deep]",
    "wide_reduce_cardinality",
    "rb_threshold",
    "rb_pair_rows",
    "rb_pair_rows[counts]",
    "rb_expand_rows",
    "rb_pairwise_and_card",
)
# every kernel call by (kind = the kernel's name above, engine = "cuda" for
# a launch, "plain" for its plain version on CPU tensors): the JAX
# package's rb_tpu_kernel_dispatch_total, with its label names
_DISPATCH_TOTAL = _observe.counter(
    _observe.KERNEL_DISPATCH_TOTAL,
    "Kernel calls by (kind, engine): cuda launches and plain-version calls",
    ("kind", "engine"),
)
# the launches alone, as a mapping keyed by kernel name
LAUNCHES = _observe.CounterMap(_DISPATCH_TOTAL, scalar=True, fixed={"engine": "cuda"})

# rows per chunk (one CTA each): small enough that a 10,000-row group
# spreads over ~80 CTAs, large enough that the per-chunk atomic combine
# (2048 words) stays under 1/128 of the rows' traffic
CHUNK_ROWS = 128

_OP_CODE = {"or": 0, "and": 1, "xor": 2}

# the masked popcount's CTA: 256 threads over one chunk's mask row, held in
# registers while the CTA walks a group of that chunk's slice rows
POP_THREADS = 256
# CTAs past which a masked launch walks every slice under one mask row:
# four on each of an H100's 132 SMs, 1,024 threads whose loads in flight
# (64-128 B a thread) cover an SM's share of device-memory bandwidth. Past
# it the longest CTAs are as fast as any (G = S within 2% of the best G on
# an H100 at K = 763 to 9,156 and every row width), since each CTA pays
# its mask load, reduction and barrier once
FILL_CTAS = 132 * 4
# the most slices one CTA walks: its warps' counts, 8 ints a slice, stay in
# 8 KiB of shared memory (csrc/reduce.cu kMaxGroup)
MAX_GROUP = 256


def reset_launches() -> None:
    """Zero every kernel's launch count (the keys stay)."""
    for k in KERNELS:
        LAUNCHES[k] = 0


reset_launches()


def _launched(kind: str) -> None:
    _DISPATCH_TOTAL.inc(1, (kind, "cuda"))


def _plain(kind: str) -> None:
    _DISPATCH_TOTAL.inc(1, (kind, "plain"))


def plan_chunks(seg_offsets: np.ndarray, chunk_rows: int = CHUNK_ROWS) -> np.ndarray:
    """Cut segment g = rows ``[offsets[g], offsets[g+1])`` into chunks of at
    most ``chunk_rows`` rows: int64 ``[C, 3]`` rows of (group, begin, end).
    Every row lies in exactly one chunk, and no chunk crosses a segment;
    empty segments get no chunk."""
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
    offs = np.asarray(seg_offsets, dtype=np.int64)
    lens = np.diff(offs)
    if np.any(lens < 0):
        raise ValueError("segment offsets must be non-decreasing")
    n_ch = (lens + chunk_rows - 1) // chunk_rows
    group = np.repeat(np.arange(len(lens), dtype=np.int64), n_ch)
    first = np.concatenate(([0], np.cumsum(n_ch)[:-1])) if len(n_ch) else n_ch
    k = np.arange(int(n_ch.sum()), dtype=np.int64) - np.repeat(first, n_ch)
    begin = offs[group] + k * chunk_rows
    end = np.minimum(begin + chunk_rows, offs[group + 1])
    return np.stack([group, begin, end], axis=1)


class SegmentPlan:
    """Segments over logical rows — ``offsets`` int64 [G+1] — and the chunk
    table that splits them across CTAs. ``mode`` names the layout it
    serves: ``"dense"`` (G segments of M rows: a padded block, or M
    logical slots per group read through a row map) or ``"csr"`` (group
    offsets of the flat rows). Built once per layout and reused by every
    reduce; the chunk table is copied to a device on first use there."""

    __slots__ = ("offsets", "mode", "chunks", "_on")

    def __init__(self, offsets, mode: str, chunk_rows: int = CHUNK_ROWS):
        if mode not in ("dense", "csr"):
            raise ValueError(f"unknown segment mode {mode!r}")
        self.offsets = np.asarray(offsets, dtype=np.int64)
        self.mode = mode
        self.chunks = plan_chunks(self.offsets, chunk_rows)
        self._on = {}

    @classmethod
    def dense(cls, g: int, m: int, chunk_rows: int = CHUNK_ROWS) -> "SegmentPlan":
        return cls(np.arange(g + 1, dtype=np.int64) * m, "dense", chunk_rows)

    @classmethod
    def csr(cls, group_offsets, chunk_rows: int = CHUNK_ROWS) -> "SegmentPlan":
        return cls(group_offsets, "csr", chunk_rows)

    @property
    def n_groups(self) -> int:
        return len(self.offsets) - 1

    @property
    def n_rows(self) -> int:
        return int(self.offsets[-1])

    def chunks_on(self, device: torch.device) -> torch.Tensor:
        t = self._on.get(device)
        if t is None:
            t = self._on[device] = torch.from_numpy(self.chunks).to(device)
        return t


# Row widths the reduce, popcount and O'Neil kernels take: a full container
# row, or the 2048 / nw words of it one rank holds when a mesh splits the
# word axis nw ways (parallel/sharding.py). Every other kernel takes full
# rows only.
ROW_WIDTHS = (2048, 1024, 512, 256)


def _check_words(words: torch.Tensor, widths=(dev.DEVICE_WORDS,)) -> torch.Tensor:
    """``words`` as contiguous int32 rows ``[-1, W]``, W its last dimension,
    which must be one of ``widths``."""
    if words.dtype != torch.int32:
        raise TypeError(f"word rows must be torch.int32, got {words.dtype}")
    w = words.shape[-1] if words.dim() else 0
    if w not in widths:
        want = widths[0] if len(widths) == 1 else f"one of {widths}"
        raise ValueError(f"word rows must be {want} wide, got {tuple(words.shape)}")
    if not words.is_contiguous():
        raise ValueError("word rows must be contiguous")
    return words.view(-1, w)


def group_reduce_plain(
    words: torch.Tensor, plan: SegmentPlan, op: str = "or",
    row_map: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`group_reduce`: a halving fold with
    ``|``, ``&`` or ``^`` on int32."""
    flat = _check_words(words, ROW_WIDTHS)
    g, w = plan.n_groups, flat.shape[1]
    if row_map is None:
        lens = np.diff(plan.offsets)
        if g and np.all(lens == lens[0]) and int(plan.offsets[0]) == 0:
            m = int(lens[0])
            return dev.grouped_reduce(flat[: g * m].view(g, m, w), op)
        return dev.segmented_reduce(flat, plan.offsets, op)
    n = flat.shape[0]
    out = torch.empty((g, w), dtype=torch.int32, device=flat.device)
    for i in range(g):
        src = row_map[int(plan.offsets[i]) : int(plan.offsets[i + 1])]
        out[i] = dev.fold_rows(flat.index_select(0, src[src < n]), op)
    return out


def group_reduce(
    words: torch.Tensor, plan: SegmentPlan, op: str = "or",
    row_map: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-segment bitwise reduce -> int32 ``[G, W]``.

    ``words``: int32 ``[N, W]`` rows, W 2048 or a width in ``ROW_WIDTHS``
    (a ``[G, M, W]`` block is taken as its ``G*M`` rows). Output row g
    folds the logical rows
    ``plan.offsets[g]:plan.offsets[g+1]``; logical row r is words row r, or
    with ``row_map`` (int64, one entry per logical row) words row
    ``row_map[r]``, where a value ``>= N`` is an identity pad. An empty
    segment yields the op identity (0, or -1 for and)."""
    if op not in _OP_CODE:
        raise ValueError(f"op must be one of {sorted(_OP_CODE)}, got {op!r}")
    flat = _check_words(words, ROW_WIDTHS)
    if row_map is not None:
        if row_map.dtype != torch.int64 or row_map.device != flat.device:
            raise TypeError("row_map must be int64 on the words' device")
        if row_map.numel() < plan.n_rows or not row_map.is_contiguous():
            raise ValueError("row_map must be contiguous with one entry per logical row")
    elif plan.n_rows > flat.shape[0]:
        raise ValueError(f"plan covers {plan.n_rows} rows, words hold {flat.shape[0]}")
    _faults.fault_point("ops.dispatch")
    if flat.device.type == "cpu":
        _plain("rb_group_reduce[rowmap]" if row_map is not None else f"rb_group_reduce[{plan.mode}]")
        return group_reduce_plain(flat, plan, op, row_map)
    if flat.device.type != "cuda":
        raise ValueError(f"unsupported device {flat.device}")
    out = torch.full(
        (plan.n_groups, flat.shape[1]), dev._INIT[op], dtype=torch.int32,
        device=flat.device,
    )
    n_chunks = len(plan.chunks)
    if n_chunks == 0:
        return out
    from . import _build

    lib = _build.load()
    chunks = plan.chunks_on(flat.device)
    rc = lib.rb_group_reduce(
        flat.device.index or 0, _OP_CODE[op], flat.data_ptr(), flat.shape[0], flat.shape[1],
        chunks.data_ptr(), n_chunks,
        None if row_map is None else row_map.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(flat.device).cuda_stream,
    )
    _build.check(lib, rc, "rb_group_reduce")
    _launched("rb_group_reduce[rowmap]" if row_map is not None
              else f"rb_group_reduce[{plan.mode}]")
    return out


def _check_mask(flat: torch.Tensor, mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    if mask is None:
        return None
    m = _check_words(mask, (flat.shape[1],))
    if m.device != flat.device:
        raise ValueError("mask must lie on the words' device")
    if m.shape[0] == 0 or flat.shape[0] % m.shape[0]:
        raise ValueError(
            f"mask rows ({m.shape[0]}) must divide the word rows ({flat.shape[0]})"
        )
    return m


def masked_popcount_group(n_slices: int, n_chunks: int, row_words: int) -> int:
    """G, the slice rows one CTA of the masked popcount counts under one
    mask row, for an ``[S, K, row_words]`` block against a ``[K, row_words]``
    mask. G = S (each mask row read once) where K CTAs alone fill the card
    (``FILL_CTAS``); a smaller K splits a chunk's slices into as many groups
    as filling it takes, each a multiple of the rows a CTA reads side by
    side at this width, at most S and ``MAX_GROUP``."""
    if n_slices < 1 or n_chunks < 1 or row_words not in ROW_WIDTHS:
        raise ValueError(f"no masked popcount over [{n_slices}, {n_chunks}, {row_words}]")
    side = max(1, POP_THREADS * 4 // row_words)
    groups = -(-FILL_CTAS // n_chunks)
    g = -(-n_slices // groups)
    return min(-(-g // side) * side, n_slices, MAX_GROUP)


def popcount_rows_plain(words: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`popcount_rows`."""
    flat = _check_words(words, ROW_WIDTHS)
    m = _check_mask(flat, mask)
    if m is None:
        return dev.popcount_rows(flat)
    k = m.shape[0]
    return dev.slice_masked_popcounts(flat.view(-1, k, flat.shape[1]), m).view(-1)


def popcount_rows(words: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row cardinality ``[R, W] -> int32 [R]``, W 2048 or a width in
    ``ROW_WIDTHS``. With ``mask`` (int32 ``[K, W]``, K dividing R) row r is
    counted as ``words[r] & mask[r % K]``: an ``[S, K, W]`` block against
    one ``[K, W]`` mask gives the ``[S, K]`` masked popcounts flat, from one
    chunk-major launch whose CTAs walk G slices (:func:`masked_popcount_group`)
    under one mask row."""
    flat = _check_words(words, ROW_WIDTHS)
    m = _check_mask(flat, mask)
    _faults.fault_point("ops.dispatch")
    if flat.device.type == "cpu":
        _plain("rb_popcount_rows" if m is None else "rb_popcount_rows[masked]")
        return popcount_rows_plain(flat, m)
    if flat.device.type != "cuda":
        raise ValueError(f"unsupported device {flat.device}")
    r = flat.shape[0]
    out = torch.empty(r, dtype=torch.int32, device=flat.device)
    if r == 0:
        return out
    from . import _build

    lib = _build.load()
    k = 0 if m is None else m.shape[0]
    group = 0 if m is None else masked_popcount_group(r // k, k, flat.shape[1])
    rc = lib.rb_popcount_rows(
        flat.device.index or 0, flat.data_ptr(), r, flat.shape[1],
        None if m is None else m.data_ptr(), k, group,
        out.data_ptr(), torch.cuda.current_stream(flat.device).cuda_stream,
    )
    _build.check(lib, rc, "rb_popcount_rows")
    if m is None:
        _launched("rb_popcount_rows")
    else:
        _launched("rb_popcount_rows[masked]")
        if group == r // k:
            _launched("rb_popcount_rows[mask-once]")
    return out


def wide_reduce_cardinality_plain(words: torch.Tensor, op: str = "or"):
    """Plain PyTorch version of :func:`wide_reduce_cardinality`."""
    flat = _check_words(words, ROW_WIDTHS)
    red = dev.fold_rows(flat, op)
    return red, dev.popcount_rows(red.view(1, -1))[0]


def wide_reduce_cardinality(words: torch.Tensor, op: str = "or"):
    """Flat reduce ``[N, W] -> ([W] words, int32 card)`` by or, and or
    xor (W 2048 or a width in ``ROW_WIDTHS``): ``rb_group_reduce`` over one
    segment (its chunks combine into the one output row with bitwise
    atomics), then ``rb_popcount_rows``. The counterpart of
    ``pallas_kernels.py:wide_reduce_cardinality_pallas``; N = 0 gives the
    op identity."""
    if op not in _OP_CODE:
        raise ValueError(f"op must be one of {sorted(_OP_CODE)}, got {op!r}")
    flat = _check_words(words, ROW_WIDTHS)
    if flat.device.type == "cpu":
        _plain("wide_reduce_cardinality")
        return wide_reduce_cardinality_plain(flat, op)
    red = group_reduce(flat, SegmentPlan.dense(1, flat.shape[0]), op)
    card = popcount_rows(red)
    _launched("wide_reduce_cardinality")
    return red[0], card[0]


_ONEIL_CODE = {op: i for i, op in enumerate(dev.ONEIL_OPS)}
# predicate masks live in the kernel's default 48 KiB of shared memory
MAX_ONEIL_SLICES = 48 * 1024 // (2 * 4)


def _check_oneil(slices, bits, ebm, fixed, op):
    if op not in _ONEIL_CODE:
        raise ValueError(f"op must be one of {dev.ONEIL_OPS}, got {op!r}")
    if slices.dim() != 3:
        raise ValueError(f"slices must be [S, K, W], got {tuple(slices.shape)}")
    _check_words(slices, ROW_WIDTHS)
    s_count, k, w_row = slices.shape
    for t in (ebm, fixed):
        _check_words(t, (w_row,))
    if tuple(ebm.shape) != (k, w_row) or tuple(fixed.shape) != (k, w_row):
        raise ValueError(f"ebm and fixed must be [{k}, {w_row}]")
    w = 2 if op == "RANGE" else 1
    if bits.dtype != torch.int32 or bits.dim() != 3 or tuple(bits.shape[1:]) != (w, s_count):
        raise ValueError(f"bits must be int32 [Q, {w}, {s_count}], got {bits.dtype} {tuple(bits.shape)}")
    if not bits.is_contiguous():
        raise ValueError("bits must be contiguous")
    if s_count > MAX_ONEIL_SLICES:
        raise ValueError(f"at most {MAX_ONEIL_SLICES} slices, got {s_count}")
    if len({t.device for t in (slices, bits, ebm, fixed)}) != 1:
        raise ValueError("slices, bits, ebm and fixed must lie on one device")


def oneil_compare_plain(slices, bits, ebm, fixed, op: str, count_only: bool = False):
    """Plain PyTorch version of :func:`oneil_compare`: the O'Neil walk of
    ``ops/device.o_neil_walk`` once per query."""
    _check_oneil(slices, bits, ebm, fixed, op)
    q_n = bits.shape[0]
    cards = torch.empty((q_n, slices.shape[1]), dtype=torch.int32, device=slices.device)
    out = None
    for q in range(q_n):
        qbits = bits[q] if op == "RANGE" else bits[q, 0]
        out, cards[q] = dev.o_neil_walk(slices, qbits.tolist(), ebm, fixed, op)
    return (None if count_only else out), cards


# The tiled count-only walk (``rb_oneil_counts``) stages a ``[S, T]`` slice
# tile in shared memory, and this plan is the one place its size is
# worked out: the launch takes ``TilePlan.smem_bytes``. The H100's limits:
# 227 KB a block may use after opting in, 228 KB an SM, 1 KB of it reserved
# for each resident block; 2048 threads and 65,536 registers an SM. The
# kernel's static shared memory (its mbarrier and the [16, 8] int32 warp
# sums, as ptxas counts them) comes on top of the dynamic part, and its
# launch bounds hold it to 128 registers a thread.
SMEM_PER_BLOCK = 232_448
SMEM_PER_SM = 233_472
SMEM_RESERVED_PER_BLOCK = 1024
THREADS_PER_SM = 2048
REGS_PER_SM = 65_536
TILE_STATIC_SMEM = 640
TILE_REGS = 128
TILE_WORDS = (1024, 512, 256, 128)
TILE_VEC = 4  # words a thread owns (oneil.cu kVec)
TILE_GROUP_WALKS = 16  # walks a query group keeps in registers (oneil.cu kGroupWalks)
# packed predicate bits staged by one launch: a longer batch is split into
# launches of at most ``query_chunk`` queries
TILE_BITS_BYTES = 2048


class TilePlan(NamedTuple):
    """How ``rb_oneil_counts`` runs a batch: tiles of ``tile_words`` words
    (``tile_words / TILE_VEC`` threads a CTA, ``W / tile_words`` CTAs a
    key chunk of W words), launches of at most ``query_chunk`` queries, each with
    ``smem_bytes`` of dynamic shared memory (slice, ebm and fixed rows, a
    full launch's packed bits, and a query group's masks)."""

    tile_words: int
    query_chunk: int
    smem_bytes: int


def _round4(n: int) -> int:
    return (n + 3) & ~3


def _tile_worst_smem(n_slices: int, tile_words: int) -> int:
    """Shared memory of a CTA at the most packed bits a launch stages,
    static part included."""
    masks = 4 * TILE_GROUP_WALKS * _round4(n_slices)
    return 4 * (n_slices + 2) * tile_words + TILE_BITS_BYTES + masks + TILE_STATIC_SMEM


def tile_ctas_per_sm(n_slices: int, tile_words: int) -> int:
    """CTAs of ``tile_words`` words resident on an SM, by shared memory,
    threads and registers; 0 where one does not fit in a block."""
    worst = _tile_worst_smem(n_slices, tile_words)
    if worst > SMEM_PER_BLOCK:
        return 0
    threads = tile_words // TILE_VEC
    return min(
        SMEM_PER_SM // (worst + SMEM_RESERVED_PER_BLOCK),
        THREADS_PER_SM // threads,
        REGS_PER_SM // (threads * TILE_REGS),
    )


def oneil_tile_plan(
    n_slices: int, n_queries: int, op: str, row_words: int = dev.DEVICE_WORDS
) -> Optional[TilePlan]:
    """The tiled walk's plan for ``n_queries`` count-only predicates over
    ``n_slices`` slices of ``row_words``-word rows, or None where even a
    128-word tile does not fit in a block's shared memory (S >
    ``MAX_TILED_SLICES``): such a batch runs on the per-query kernel. The
    tile, at most ``row_words``, is the one that keeps the most warps
    resident on an SM, the larger on a tie; at S = 32 three CTAs of 512
    words share an SM, one staging while the others walk. The fit counts
    the most packed bits a launch stages, so it depends on S alone."""
    if op not in _ONEIL_CODE:
        raise ValueError(f"op must be one of {dev.ONEIL_OPS}, got {op!r}")
    if row_words not in ROW_WIDTHS:
        raise ValueError(f"row_words must be one of {ROW_WIDTHS}, got {row_words}")
    words = (2 if op == "RANGE" else 1) * ((n_slices + 31) // 32)
    chunk = max(1, min(n_queries, TILE_BITS_BYTES // (4 * words)))
    tiles = [t for t in TILE_WORDS if t <= row_words]
    warps = {t: tile_ctas_per_sm(n_slices, t) * t // TILE_VEC // 32 for t in tiles}
    best = max(tiles, key=lambda t: (warps[t], t))
    if not warps[best]:
        return None
    smem = 4 * ((n_slices + 2) * best + _round4(chunk * words) + TILE_GROUP_WALKS * _round4(n_slices))
    return TilePlan(tile_words=best, query_chunk=chunk, smem_bytes=smem)


# the deepest index the tiled walk takes (396 slices)
MAX_TILED_SLICES = max(s for s in range(1, 1024) if oneil_tile_plan(s, 1, "GE") is not None)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_per_query(slices, bits, ebm, fixed, op, out, cards) -> None:
    from . import _build

    lib = _build.load()
    rc = lib.rb_oneil_compare(
        slices.device.index or 0, _ONEIL_CODE[op], slices.data_ptr(), slices.shape[0],
        slices.shape[1], slices.shape[2], bits.data_ptr(), bits.shape[0], ebm.data_ptr(), fixed.data_ptr(),
        None if out is None else out.data_ptr(), cards.data_ptr(), _stream(slices),
    )
    _build.check(lib, rc, "rb_oneil_compare")


def _launch_tiled(slices, bits, ebm, fixed, op, cards, plan: TilePlan) -> None:
    from . import _build

    lib = _build.load()
    q_n, k = bits.shape[0], slices.shape[1]
    row = bits.shape[1] * bits.shape[2] * 4  # bytes of one query's bits
    for q0 in range(0, q_n, plan.query_chunk):
        rc = lib.rb_oneil_counts(
            slices.device.index or 0, _ONEIL_CODE[op], slices.data_ptr(), slices.shape[0], k,
            slices.shape[2], bits.data_ptr() + q0 * row, min(plan.query_chunk, q_n - q0), ebm.data_ptr(),
            fixed.data_ptr(), cards.data_ptr() + q0 * k * 4, plan.tile_words, plan.smem_bytes,
            _stream(slices),
        )
        _build.check(lib, rc, "rb_oneil_counts")
        _launched("rb_oneil_compare[batched]")


def oneil_compare(slices, bits, ebm, fixed, op: str, count_only: bool = False):
    """Fused O'Neil compare of Q predicates over a bit-sliced index.

    ``slices``: int32 ``[S, K, R]``, R 2048 or a width in ``ROW_WIDTHS``;
    ``bits``: int32 ``[Q, W, S]`` on the same device, W = 2 for RANGE (the
    low bound's GE walk first, then the high bound's LE walk) else 1,
    position j holding the predicate bit of slice ``S - 1 - j``; ``ebm``
    and ``fixed``: int32 ``[K, R]`` existence and found-set words; ``op``:
    one of ``ops/device.ONEIL_OPS``. Returns ``(out, cards)``: int32
    ``[K, R]`` result words (None when
    ``count_only``; otherwise Q must be 1) and int32 ``[Q, K]`` per-chunk
    popcounts.

    On the card, one query runs on the per-query kernel
    (``rb_oneil_compare``); Q >= 2 count-only predicates on the tiled walk
    (``rb_oneil_counts``, launch key ``rb_oneil_compare[batched]``, one
    launch per ``oneil_tile_plan(...).query_chunk`` queries), or on the
    per-query kernel (``rb_oneil_compare[batched-deep]``) past
    ``MAX_TILED_SLICES``."""
    _check_oneil(slices, bits, ebm, fixed, op)
    q_n, k = bits.shape[0], slices.shape[1]
    if not count_only and q_n != 1:
        raise ValueError("result words are returned for one query only; pass count_only=True")
    if slices.device.type == "cpu":
        _plain("rb_oneil_compare[batched]" if q_n > 1 else "rb_oneil_compare")
        return oneil_compare_plain(slices, bits, ebm, fixed, op, count_only)
    if slices.device.type != "cuda":
        raise ValueError(f"unsupported device {slices.device}")
    out = None if count_only else torch.empty_like(ebm)
    plan = oneil_tile_plan(slices.shape[0], q_n, op, slices.shape[2]) if q_n > 1 else None
    if plan is not None:
        cards = torch.zeros((q_n, k), dtype=torch.int32, device=slices.device)
        if k:
            _launch_tiled(slices, bits, ebm, fixed, op, cards, plan)
        return out, cards
    cards = torch.empty((q_n, k), dtype=torch.int32, device=slices.device)
    if q_n == 0 or k == 0:
        return out, cards
    _launch_per_query(slices, bits, ebm, fixed, op, out, cards)
    _launched("rb_oneil_compare[batched-deep]" if q_n > 1 else "rb_oneil_compare")
    return out, cards


def oneil_counts_per_query(slices, bits, ebm, fixed, op: str) -> torch.Tensor:
    """The count-only ``[Q, K]`` popcounts of :func:`oneil_compare` on the
    per-query kernel whatever the depth: the design the tiled walk
    replaced, kept for the deep batches (launch key
    ``rb_oneil_compare[batched-deep]``) and for comparing the two on the
    card."""
    _check_oneil(slices, bits, ebm, fixed, op)
    if slices.device.type == "cpu":
        _plain("rb_oneil_compare[batched-deep]")
        return oneil_compare_plain(slices, bits, ebm, fixed, op, True)[1]
    if slices.device.type != "cuda":
        raise ValueError(f"unsupported device {slices.device}")
    cards = torch.empty((bits.shape[0], slices.shape[1]), dtype=torch.int32, device=slices.device)
    if cards.numel():
        _launch_per_query(slices, bits, ebm, fixed, op, None, cards)
        _launched("rb_oneil_compare[batched-deep]")
    return cards


# ---------------------------------------------------------------------------
# device-side expansion of compact container payloads
# ---------------------------------------------------------------------------


def _host_tensor(a) -> torch.Tensor:
    """A payload array as a host tensor: a torch tensor (the pinned staging
    of ``RowPayload.materialize(pinned=True)``) as it is, a numpy array
    wrapped without a copy, uint16 as int16 bits and uint64 as int64 bits
    (torch has no general unsigned types)."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint16:
        a = a.view(np.int16)
    elif a.dtype == np.uint64:
        a = a.view(np.int64)
    return torch.from_numpy(a)


def _u16(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """uint16 bits (an int16 tensor) -> int64 tensor on ``device``, masked
    back to 0..65535 after widening."""
    return t.to(device).to(torch.int64) & 0xFFFF


def _bit32(pos: torch.Tensor) -> torch.Tensor:
    """int32 word with bit ``pos`` (0..31) set; bit 31 is the sign bit."""
    return (torch.ones_like(pos) << pos).to(torch.int32)


def _parity32(x: torch.Tensor) -> torch.Tensor:
    """Per-word bit parity. The shifts are arithmetic on int32, which only
    garbles bits above the ones the final ``& 1`` keeps."""
    for s in (16, 8, 4, 2, 1):
        x = x ^ (x >> s)
    return x & 1


_PAYLOAD_DTYPES = (
    ("arr_rows", torch.int64), ("arr_offsets", torch.int64), ("arr_values", torch.int16),
    ("bmp_rows", torch.int64), ("bmp_words", torch.int64), ("run_rows", torch.int64),
    ("run_counts", torch.int64), ("run_starts", torch.int16), ("run_lengths", torch.int16),
)


def _check_payload(n_rows, parts) -> None:
    """Types and shapes of a payload (host or device tensors): each row
    holds exactly one container, as ``RowPayload.append`` builds it."""
    if len(parts) != len(_PAYLOAD_DTYPES):
        raise ValueError(f"a payload has {len(_PAYLOAD_DTYPES)} parts, got {len(parts)}")
    if len({t.device for t in parts}) != 1:
        raise ValueError("the payload's parts must lie on one device")
    for (name, dtype), t in zip(_PAYLOAD_DTYPES, parts):
        if t.dtype != dtype or t.dim() != (2 if name == "bmp_words" else 1) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous array of {dtype} bits")
    arr_rows, arr_offsets, arr_values, bmp_rows, bmp_words, run_rows, run_counts, run_starts, run_lengths = parts
    n_arr, n_bmp, n_run = arr_rows.numel(), bmp_rows.numel(), run_rows.numel()
    if n_arr + n_bmp + n_run != int(n_rows):
        raise ValueError(
            f"{n_arr} + {n_bmp} + {n_run} containers for {n_rows} rows: each row holds one"
        )
    if bmp_words.shape != (n_bmp, dev.DEVICE_WORDS // 2):
        raise ValueError(f"bmp_words must be [{n_bmp}, 1024], got {tuple(bmp_words.shape)}")
    if arr_offsets.numel() != n_arr + 1 or run_counts.numel() != n_run:
        raise ValueError("arr_offsets needs n_arr + 1 entries and run_counts n_run")
    if run_lengths.numel() != run_starts.numel():
        raise ValueError("run_starts and run_lengths differ in length")


def payload_parts(
    n_rows, arr_rows, arr_offsets, arr_values, bmp_rows, bmp_words,
    run_rows, run_counts, run_starts, run_lengths,
):
    """The payload (numpy arrays or host tensors) as checked host tensors:
    types and shapes as :func:`_check_payload`, the row indices a
    permutation of the block's rows (the kernel writes each row once and
    leaves its output unset), and the CSR offsets and counts matching
    their value arrays."""
    parts = [_host_tensor(a) for a in (
        arr_rows, arr_offsets, arr_values, bmp_rows, bmp_words,
        run_rows, run_counts, run_starts, run_lengths,
    )]
    if parts[0].device.type != "cpu":
        raise ValueError("payload_parts takes a host payload")
    _check_payload(n_rows, parts)
    arr_rows, arr_offsets, arr_values, bmp_rows, _bmp, run_rows, run_counts, run_starts, _len = parts
    if int(arr_offsets[0]) != 0 or int(arr_offsets[-1]) != arr_values.numel() or bool(
        (torch.diff(arr_offsets) < 0).any()
    ):
        raise ValueError("arr_offsets must rise from 0 to len(arr_values)")
    if bool((run_counts < 0).any()) or int(run_counts.sum()) != run_starts.numel():
        raise ValueError("run_counts must sum to len(run_starts)")
    rows = torch.cat((arr_rows, bmp_rows, run_rows))
    if rows.numel() and (int(rows.min()) < 0 or int(rows.max()) >= int(n_rows)):
        raise ValueError(f"row index outside the block of {n_rows} rows")
    if not bool(torch.bincount(rows, minlength=int(n_rows)).eq(1).all()):
        raise ValueError("a row index repeats: each row holds one container")
    return parts


def ship_payload(parts, device) -> tuple:
    """Checked host parts (:func:`payload_parts`) copied to ``device``
    without blocking on the current stream (asynchronous from pinned
    memory)."""
    return tuple(t.to(torch.device(device), non_blocking=True) for t in parts)


def expand_rows_plain(
    n_rows: int, arr_rows, arr_offsets, arr_values, bmp_rows, bmp_words,
    run_rows, run_counts, run_starts, run_lengths, device,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`expand_rows`, torch ops on
    ``device`` over a host payload or one already there. Array values add
    their bit masks into the rows (distinct values of a container set
    distinct bits, so add == or). Runs add start toggles and stop toggles
    into two separate blocks that are XORed — a stop that lands on the
    next run's start bit (adjacent runs) cancels it instead of carrying,
    and a run ending at 65535 has no stop toggle — then a prefix-XOR
    within each word (five doubling shifts) and an exclusive cumulative
    parity across words fill the intervals. Bitmap rows are copied."""
    device = torch.device(device)
    parts = [_host_tensor(a) for a in (
        arr_rows, arr_offsets, arr_values, bmp_rows, bmp_words,
        run_rows, run_counts, run_starts, run_lengths,
    )]
    if parts[0].device.type == "cpu":
        parts = payload_parts(n_rows, *parts)
    else:
        _check_payload(n_rows, parts)
    (arr_rows, arr_offsets, arr_values, bmp_rows, bmp_words,
     run_rows, run_counts, run_starts, run_lengths) = parts
    w = dev.DEVICE_WORDS
    out = torch.zeros(n_rows * w, dtype=torch.int32, device=device)
    if arr_values.numel():
        lens = torch.diff(arr_offsets).to(device)
        rows = torch.repeat_interleave(arr_rows.to(device), lens)
        v = _u16(arr_values, device)
        out.index_add_(0, rows * w + (v >> 5), _bit32(v & 31))
        del rows, v
    out = out.view(n_rows, w)
    if bmp_rows.numel():
        out[bmp_rows.to(device)] = bmp_words.view(torch.int32).reshape(-1, w).to(device)
    kr = run_rows.numel()
    if kr:
        compact = torch.repeat_interleave(torch.arange(kr, device=device), run_counts.to(device))
        s = _u16(run_starts, device)
        e1 = s + _u16(run_lengths, device) + 1
        tog_s = torch.zeros(kr * w, dtype=torch.int32, device=device)
        tog_s.index_add_(0, compact * w + (s >> 5), _bit32(s & 31))
        inside = e1 < (1 << 16)
        e1, ce = e1[inside], compact[inside]
        tog_e = torch.zeros(kr * w, dtype=torch.int32, device=device)
        tog_e.index_add_(0, ce * w + (e1 >> 5), _bit32(e1 & 31))
        tog = (tog_s ^ tog_e).view(kr, w)
        fill = tog
        for sh in (1, 2, 4, 8, 16):
            fill = fill ^ (fill << sh)
        par = _parity32(tog)
        carry = ((torch.cumsum(par, dim=1) - par) & 1).to(torch.int32)
        out[run_rows.to(device)] = fill ^ -carry
    return out


def expand_rows(
    n_rows: int, arr_rows, arr_offsets, arr_values, bmp_rows, bmp_words,
    run_rows, run_counts, run_starts, run_lengths, device,
) -> torch.Tensor:
    """Expand a compact host payload (``store.RowPayload.materialize()``,
    numpy arrays or the pinned host tensors of ``materialize(pinned=True)``)
    into int32 ``[n_rows, 2048]`` rows on ``device``: array containers as
    CSR (``arr_rows``, ``arr_offsets`` int64, ``arr_values`` uint16),
    bitmap containers as ``bmp_rows`` int64 and ``bmp_words`` uint64
    ``[n_bmp, 1024]``, run containers as ``run_rows`` / ``run_counts``
    int64 and ``run_starts`` / ``run_lengths`` uint16, each run covering
    ``[start, start + length]``. Each row holds exactly one container.

    On the card only the payload crosses the host link (2 bytes per array
    value, 4 per run, 8 KiB per bitmap row; :func:`ship_payload`), and
    one ``rb_expand_rows`` launch builds every row
    (:func:`expand_shipped`)."""
    device = torch.device(device)
    parts = payload_parts(
        n_rows, arr_rows, arr_offsets, arr_values, bmp_rows, bmp_words,
        run_rows, run_counts, run_starts, run_lengths,
    )
    if device.type == "cpu":
        _faults.fault_point("ops.dispatch")
        _plain("rb_expand_rows")
        return expand_rows_plain(n_rows, *parts, device)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    return expand_shipped(n_rows, ship_payload(parts, device))


def expand_parts(n_rows: int, parts) -> torch.Tensor:
    """Expand checked payload parts where they lie (:func:`payload_parts`,
    moved by :func:`ship_payload`): one ``rb_expand_rows`` launch for parts
    on the card, the plain version for parts on the CPU."""
    if parts[0].device.type == "cuda":
        return expand_shipped(n_rows, parts)
    return expand_rows(n_rows, *parts, parts[0].device)


def expand_shipped(n_rows: int, shipped) -> torch.Tensor:
    """One ``rb_expand_rows`` launch over a payload already on the card:
    the parts as :func:`ship_payload` leaves them, whose values were
    checked on the host by :func:`payload_parts`."""
    _check_payload(n_rows, shipped)
    (arr_rows, arr_offsets, arr_values, bmp_rows, bmp_words,
     run_rows, run_counts, run_starts, run_lengths) = shipped
    if arr_rows.device.type != "cuda":
        raise ValueError(f"expand_shipped takes a payload on a CUDA device, not {arr_rows.device}")
    _faults.fault_point("ops.dispatch")
    out = torch.empty((int(n_rows), dev.DEVICE_WORDS), dtype=torch.int32, device=arr_rows.device)
    if out.shape[0] == 0:
        return out
    if bmp_words.numel() and bmp_words.data_ptr() % 16:
        raise ValueError("bmp_words must be 16-byte aligned")
    run_ends = torch.cumsum(run_counts, 0)
    from . import _build

    lib = _build.load()
    rc = lib.rb_expand_rows(
        out.device.index,
        arr_rows.numel(), arr_rows.data_ptr(), arr_offsets.data_ptr(), arr_values.data_ptr(),
        bmp_rows.numel(), bmp_rows.data_ptr(), bmp_words.data_ptr(),
        run_rows.numel(), run_rows.data_ptr(), run_ends.data_ptr(), run_starts.data_ptr(),
        run_lengths.data_ptr(), out.data_ptr(), _stream(out),
    )
    _build.check(lib, rc, "rb_expand_rows")
    _launched("rb_expand_rows")
    return out


# ---------------------------------------------------------------------------
# Threshold(k): bit-sliced adder, >= k compare, popcount
# ---------------------------------------------------------------------------

# counter slices the kernel keeps in registers (M < 2^32 rows a group)
MAX_THRESHOLD_SLICES = 32


def _check_threshold(words3: torch.Tensor, k: int, n_slices: int) -> None:
    if words3.dim() != 3:
        raise ValueError(f"words must be [G, M, 2048], got {tuple(words3.shape)}")
    _check_words(words3)
    if not 1 <= int(n_slices) <= MAX_THRESHOLD_SLICES:
        raise ValueError(f"n_slices must be in 1..{MAX_THRESHOLD_SLICES}, got {n_slices}")
    if int(k) < 0:
        raise ValueError(f"k must be >= 0, got {k}")


def threshold_rows_plain(words3: torch.Tensor, k: int, n_slices: int):
    """Plain PyTorch version of :func:`threshold_rows`: the same bit-sliced
    adder with int32 ops, summing the rows of each group in a tree of
    pairwise bit-sliced additions (each level adds neighbouring numbers
    with a ripple carry, widening them by one slice up to ``n_slices``,
    past which the carry drops as in the sequential counter), then the
    same MSB->LSB compare and the popcount."""
    _check_threshold(words3, k, n_slices)
    g, m, w = words3.shape
    L = int(n_slices)
    # nums: [G, n, b, W] — n numbers of b bit-slices each, lowest first
    nums = words3.unsqueeze(2)
    if m == 0:
        nums = torch.zeros((g, 1, 1, w), dtype=torch.int32, device=words3.device)
    while nums.shape[1] > 1:
        if nums.shape[1] % 2:
            nums = torch.cat([nums, torch.zeros_like(nums[:, :1])], dim=1)
        a, b = nums[:, 0::2], nums[:, 1::2]
        width = nums.shape[2]
        carry = torch.zeros_like(a[:, :, 0])
        out = []
        for i in range(min(width + 1, L)):
            if i < width:
                ai, bi = a[:, :, i], b[:, :, i]
                out.append(ai ^ bi ^ carry)
                carry = (ai & bi) | (carry & (ai ^ bi))
            else:
                out.append(carry)
        nums = torch.stack(out, dim=2)
    slices = [nums[:, 0, i] if i < nums.shape[2] else torch.zeros_like(nums[:, 0, 0])
              for i in range(L)]
    eq = torch.full((g, w), -1, dtype=torch.int32, device=words3.device)
    gt = torch.zeros((g, w), dtype=torch.int32, device=words3.device)
    for bit in range(L - 1, -1, -1):
        sl = slices[bit]
        if (int(k) >> bit) & 1:
            eq = eq & sl
        else:
            gt = gt | (eq & sl)
            eq = eq & ~sl
    res = (gt | eq).contiguous()
    return res, dev.popcount_rows(res)


def threshold_rows(words3: torch.Tensor, k: int, n_slices: int):
    """``_threshold_kernel(k, n_slices)`` of the JAX package: per group g
    and bit position, count the rows of ``words3[g]`` (int32 ``[G, M,
    2048]``, zero-filled pad rows add nothing) whose bit is set in an
    ``n_slices``-bit counter (a carry out of the top slice drops), and set
    the bit of the result when the counter is >= k, compared slice by
    slice from the top on the low ``n_slices`` bits of k. Returns int32
    ``[G, 2048]`` words and int32 ``[G]`` popcounts. The caller decides
    an empty answer for ``k >> n_slices != 0`` on the host, as the JAX
    package does; this function computes the compare as written for any
    k. On the card: one ``rb_threshold`` launch."""
    _check_threshold(words3, k, n_slices)
    _faults.fault_point("ops.dispatch")
    if words3.device.type == "cpu":
        _plain("rb_threshold")
        return threshold_rows_plain(words3, k, n_slices)
    if words3.device.type != "cuda":
        raise ValueError(f"unsupported device {words3.device}")
    g, m, _ = words3.shape
    out = torch.empty((g, dev.DEVICE_WORDS), dtype=torch.int32, device=words3.device)
    cards = torch.zeros(g, dtype=torch.int32, device=words3.device)
    if g == 0:
        return out, cards
    from . import _build

    lib = _build.load()
    rc = lib.rb_threshold(
        words3.device.index or 0, words3.data_ptr(), g, m, int(n_slices),
        int(k) & 0xFFFFFFFF, out.data_ptr(), cards.data_ptr(), _stream(words3),
    )
    _build.check(lib, rc, "rb_threshold")
    _launched("rb_threshold")
    return out, cards


# ---------------------------------------------------------------------------
# the columnar device tier: gather, op, popcount of row pairs
# ---------------------------------------------------------------------------

_PAIR_CODE = {"and": 0, "or": 1, "xor": 2, "andnot": 3}
_INT32_MAX = (1 << 31) - 1


def _check_pair(rows_a, ia, rows_b, ib, op):
    if op not in _PAIR_CODE:
        raise ValueError(f"op must be one of {sorted(_PAIR_CODE)}, got {op!r}")
    for rows in (rows_a, rows_b):
        if rows.dim() != 2:
            raise ValueError(f"row blocks must be [N, 2048], got {tuple(rows.shape)}")
        _check_words(rows)
    for idx in (ia, ib):
        if idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous():
            raise ValueError("row indices must be contiguous 1-D torch.int32")
    if ia.shape != ib.shape:
        raise ValueError(f"index streams differ in length: {ia.numel()} vs {ib.numel()}")
    if max(rows_a.shape[0], rows_b.shape[0]) > _INT32_MAX:
        raise ValueError(
            f"int32 indices reach rows below 2^31 only, got {rows_a.shape[0]} and {rows_b.shape[0]}"
        )
    if len({t.device for t in (rows_a, ia, rows_b, ib)}) != 1:
        raise ValueError("rows and indices must lie on one device")


def _take_rows(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``rows[idx]``, an index outside the block reading a zero row."""
    i = idx.long()
    inside = (i >= 0) & (i < rows.shape[0])
    if rows.shape[0] == 0:
        return torch.zeros((i.numel(), dev.DEVICE_WORDS), dtype=torch.int32, device=rows.device)
    out = rows.index_select(0, torch.where(inside, i, torch.zeros_like(i)))
    out[~inside] = 0
    return out


def pair_rows_reduce_plain(rows_a, ia, rows_b, ib, op: str):
    """Plain PyTorch version of :func:`pair_rows_reduce`: two
    ``index_select`` gathers, the op, and ``popcount_rows_plain``."""
    _check_pair(rows_a, ia, rows_b, ib, op)
    a, b = _take_rows(rows_a, ia), _take_rows(rows_b, ib)
    if op == "and":
        out = a & b
    elif op == "or":
        out = a | b
    elif op == "xor":
        out = a ^ b
    else:  # andnot
        out = a & ~b
    return out, popcount_rows_plain(out)


def pair_rows_reduce(rows_a, ia, rows_b, ib, op: str):
    """For each pair j, ``rows_a[ia[j]] OP rows_b[ib[j]]`` and its
    popcount: int32 ``[n, 2048]`` words and int32 ``[n]`` cards.

    ``rows_a`` / ``rows_b``: int32 ``[N, 2048]`` row blocks; ``ia`` /
    ``ib``: int32 ``[n]`` row indices on the same device (an index outside
    its block reads a zero row, as the JAX function's ``take(mode="fill")``
    does); ``op``: and, or, xor or andnot (``a & ~b``). On the card: one
    ``rb_pair_rows`` launch."""
    _check_pair(rows_a, ia, rows_b, ib, op)
    if rows_a.device.type == "cpu":
        _plain("rb_pair_rows")
        return pair_rows_reduce_plain(rows_a, ia, rows_b, ib, op)
    n = ia.numel()
    out = torch.empty((n, dev.DEVICE_WORDS), dtype=torch.int32, device=rows_a.device)
    return out, _launch_pair_rows(rows_a, ia, rows_b, ib, op, out)


def pair_rows_cardinality_plain(rows_a, ia, rows_b, ib, op: str):
    """Plain PyTorch version of :func:`pair_rows_cardinality`: the cards of
    :func:`pair_rows_reduce_plain`."""
    return pair_rows_reduce_plain(rows_a, ia, rows_b, ib, op)[1]


def pair_rows_cardinality(rows_a, ia, rows_b, ib, op: str):
    """The int32 ``[n]`` cards of :func:`pair_rows_reduce` without the
    rows, on the same arguments. On the card: one ``rb_pair_rows`` launch
    with a null ``out`` (launch key ``rb_pair_rows[counts]``), which writes
    no rows."""
    _check_pair(rows_a, ia, rows_b, ib, op)
    if rows_a.device.type == "cpu":
        _plain("rb_pair_rows[counts]")
        return pair_rows_cardinality_plain(rows_a, ia, rows_b, ib, op)
    return _launch_pair_rows(rows_a, ia, rows_b, ib, op, None)


def _launch_pair_rows(rows_a, ia, rows_b, ib, op: str, out) -> torch.Tensor:
    """One ``rb_pair_rows`` launch on checked CUDA operands, writing ``out``
    (or, where it is None, the cards alone); returns the cards."""
    if rows_a.device.type != "cuda":
        raise ValueError(f"unsupported device {rows_a.device}")
    for rows in (rows_a, rows_b):
        if rows.data_ptr() % 16:
            raise ValueError("row blocks must be 16-byte aligned")
    n = ia.numel()
    cards = torch.empty(n, dtype=torch.int32, device=rows_a.device)
    if n == 0:
        return cards
    from . import _build

    lib = _build.load()
    rc = lib.rb_pair_rows(
        rows_a.device.index or 0, _PAIR_CODE[op], rows_a.data_ptr(), rows_a.shape[0],
        ia.data_ptr(), rows_b.data_ptr(), rows_b.shape[0], ib.data_ptr(), n,
        None if out is None else out.data_ptr(), cards.data_ptr(), _stream(rows_a),
    )
    _build.check(lib, rc, "rb_pair_rows")
    _launched("rb_pair_rows" if out is not None else "rb_pair_rows[counts]")
    return cards


# ---------------------------------------------------------------------------
# batch similarity: the all-pairs AND-popcount matrix
# ---------------------------------------------------------------------------

# the plain version's left-axis tile: the [nb, m, K, 2048] intermediate
# stays under this many bytes (the JAX package's tile_bytes default)
PAIRWISE_TILE_BYTES = 256 << 20
# rb_pairwise_and_card's CTA tile (left rows, right rows) and the most
# tiles its one-dimensional grid takes
PAIRWISE_TILE = (128, 256)
MAX_PAIRWISE_TILES = 2**31 - 1


def pairwise_tiles(n: int, m: int) -> int:
    """CTAs of one ``rb_pairwise_and_card`` launch over ``n`` x ``m`` pairs
    (one a 128 x 256 tile); raises past the grid's limit."""
    tiles = -(-n // PAIRWISE_TILE[0]) * -(-m // PAIRWISE_TILE[1])
    if tiles > MAX_PAIRWISE_TILES:
        raise ValueError(f"at most {MAX_PAIRWISE_TILES} tiles of 128 x 256 pairs a launch, got {tiles}")
    return tiles


def _check_pairwise(left: torch.Tensor, right: torch.Tensor) -> None:
    for t in (left, right):
        if t.dtype != torch.int32:
            raise TypeError(f"word rows must be torch.int32, got {t.dtype}")
        if t.dim() != 3 or t.shape[2] != dev.DEVICE_WORDS:
            raise ValueError(f"pairwise operands must be [n, K, 2048], got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("pairwise operands must be contiguous")
    if left.shape[1] != right.shape[1] or left.shape[1] == 0:
        raise ValueError(
            f"both sides need the same K >= 1 keys, got {left.shape[1]} and {right.shape[1]}"
        )
    if left.device != right.device:
        raise ValueError("both sides must lie on one device")


def pairwise_and_card_plain(
    left: torch.Tensor, right: torch.Tensor, tile_bytes: int = PAIRWISE_TILE_BYTES
) -> torch.Tensor:
    """Plain PyTorch version of :func:`pairwise_and_card`: the left axis
    cut into tiles of ``nb`` rows so the broadcast ``[nb, m, K, 2048]`` AND
    stays under ``tile_bytes`` (as ``batch.py:312-322`` does), each tile
    popcounted per (pair, key) and summed over the keys in int64."""
    _check_pairwise(left, right)
    n, k, w = left.shape
    m = right.shape[0]
    out = torch.zeros((n, m), dtype=torch.int64, device=left.device)
    if n == 0 or m == 0:
        return out
    nb = max(1, min(n, tile_bytes // (4 * m * k * w)))
    for s in range(0, n, nb):
        masked = left[s : s + nb, None] & right[None]
        per_key = dev.popcount_rows(masked.view(-1, w)).view(-1, m, k)
        out[s : s + nb] = per_key.sum(dim=2, dtype=torch.int64)
    return out


def pairwise_and_card(
    left: torch.Tensor, right: torch.Tensor, tile_bytes: int = PAIRWISE_TILE_BYTES
) -> torch.Tensor:
    """``out[i, j] = sum over keys and words of popcount(left[i] &
    right[j])``: int64 ``[n, m]`` from int32 ``[n, K, 2048]`` and
    ``[m, K, 2048]`` word rows on one device. ``tile_bytes`` bounds the
    plain version's intermediate (CPU tensors). On the card: one
    ``rb_pairwise_and_card`` launch (tensor-core single-bit products),
    exact past 2^32 a pair."""
    _check_pairwise(left, right)
    if left.device.type == "cpu":
        _plain("rb_pairwise_and_card")
        return pairwise_and_card_plain(left, right, tile_bytes)
    if left.device.type != "cuda":
        raise ValueError(f"unsupported device {left.device}")
    n, k, _ = left.shape
    m = right.shape[0]
    pairwise_tiles(n, m)
    for t in (left, right):
        if t.data_ptr() % 16:
            raise ValueError("pairwise operands must be 16-byte aligned")
    out = torch.empty((n, m), dtype=torch.int64, device=left.device)
    if n == 0 or m == 0:
        return out
    from . import _build

    lib = _build.load()
    rc = lib.rb_pairwise_and_card(
        left.device.index or 0, left.data_ptr(), n, right.data_ptr(), m, k,
        out.data_ptr(), _stream(left),
    )
    _build.check(lib, rc, "rb_pairwise_and_card")
    _launched("rb_pairwise_and_card")
    return out


def concat_rows(blocks) -> torch.Tensor:
    """Row blocks ``[n_i, 2048]`` as one block (one ``torch.cat``; a single
    block is returned as it is): the multi-pair tier's combined gather
    source. Counterpart of the XLA ``pallas_kernels.py:concat_rows``,
    without its power-of-two padding (that bounded XLA retraces)."""
    blocks = list(blocks)
    if not blocks:
        raise ValueError("concat_rows needs at least one block")
    return blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=0)


def word_test_rows(rows: torch.Tensor, row_ids: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Is bit ``vals[i]`` (0..65535) set in row ``row_ids[i]`` of ``rows``
    (int32 ``[N, 2048]``)? A bool tensor on the rows' device: torch
    indexing, one word gathered per probe. Counterpart of the XLA
    ``ops/device.py:word_test_rows``; only the mask goes to the host."""
    v = vals.long()
    w = rows[row_ids.long(), v >> 5]
    # an arithmetic shift garbles only bits above the one kept
    return ((w >> (v & 31).to(torch.int32)) & 1).bool()
