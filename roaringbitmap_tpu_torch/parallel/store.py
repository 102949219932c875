"""Device container store: SoA packing of containers onto the card.

Counterpart of ``roaringbitmap_tpu/parallel/store.py`` for the aggregation
path. All containers of a working set are transposed host-side into
key-major order (``group_by_key``) and collected into a compact
:class:`RowPayload` — borrows of array values, run intervals and bitmap
words (``pack_groups``). At first touch the payload is shipped and expanded
on the device into ONE ``int32 [N, 2048]`` row block (``ops/kernels
.expand_rows``); ``prepare_reduce`` then picks the padded, bucketed or
segmented layout by the same rule as the JAX package and runs the grouped
reduce and the per-group popcount through the CUDA kernels
(``ops/kernels.group_reduce`` / ``popcount_rows``). Results come back to
the host as uint32 words and are re-compressed into containers
(``unpack_to_bitmap``).

Left out here, relative to the JAX package: the resident pack cache, delta
repacks, fault sites and the timeline stages. Every aggregation packs
afresh. There is no fallback: a device call that fails raises.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.container import (
    ArrayContainer,
    BitmapContainer,
    Container,
    RunContainer,
)
from ..models.roaring import RoaringBitmap
from ..ops import device as dev
from ..ops import kernels
from ..utils import bits

# layout choices made by prepare_reduce, by name (the JAX package's
# LAYOUT_COUNTS): a run can show which layout served it
LAYOUT_COUNTS = {"padded": 0, "bucketed": 0, "segmented-scan": 0}
# default ragged-batch bucket count for the prepare_reduce cost model
DEFAULT_BUCKETS = 3


class RowPayload:
    """Compact marshal payload for one packed row block: array value
    vectors, run interval vectors, and bitmap word arrays collected (as
    zero-copy borrows of the container internals) in ONE pass, instead of
    expanding every container to 8 KiB of words on the host. The expansion
    runs at first touch, on the device (:meth:`expand_device`) or on the
    host (:meth:`expand_host`, the reference the device expansion is tested
    against).

    Because rows are borrows, the payload snapshots container *identity*,
    not container bytes: a packed row mutated in place after packing reads
    through."""

    __slots__ = ("n_rows", "arr_rows", "arr_vals", "bmp_rows", "bmp_list",
                 "run_rows", "run_starts", "run_lengths", "n_values",
                 "n_run_intervals", "_mat")

    def __init__(self):
        self.n_rows = 0
        self.arr_rows: List[int] = []
        self.arr_vals: List[np.ndarray] = []
        self.bmp_rows: List[int] = []
        self.bmp_list: List[np.ndarray] = []
        self.run_rows: List[int] = []
        self.run_starts: List[np.ndarray] = []
        self.run_lengths: List[np.ndarray] = []
        self.n_values = 0
        self.n_run_intervals = 0
        self._mat = None

    def append(self, c: Container) -> None:
        """Add one container as the next row (type-partitioned borrow)."""
        i = self.n_rows
        self.n_rows = i + 1
        t = c.__class__
        if t is ArrayContainer:
            self.arr_rows.append(i)
            self.arr_vals.append(c.content)
            self.n_values += len(c.content)
        elif t is BitmapContainer:
            self.bmp_rows.append(i)
            self.bmp_list.append(c.words)
        elif t is RunContainer:
            self.run_rows.append(i)
            self.run_starts.append(c.starts)
            self.run_lengths.append(c.lengths)
            self.n_run_intervals += len(c.starts)
        else:
            raise TypeError(f"unknown container type {t.__name__}")

    @classmethod
    def from_containers(cls, containers: Sequence[Container]) -> "RowPayload":
        p = cls()
        for c in containers:
            p.append(c)
        return p

    @property
    def nbytes(self) -> int:
        """Wire size of the compact payload (what the device expansion
        ships, vs 8 KiB per row expanded)."""
        return (
            self.n_values * 2
            + self.n_run_intervals * 4
            + len(self.bmp_rows) * bits.WORDS_PER_CONTAINER * 8
            + (len(self.arr_rows) + len(self.run_rows) + len(self.bmp_rows)) * 8
        )

    def materialize(self):
        """Concatenate the borrows into flat numpy arrays (cached):
        ``(arr_rows, arr_offsets, arr_values, bmp_rows, bmp_words64,
        run_rows, run_counts, run_starts, run_lengths)``."""
        m = self._mat
        if m is None:
            arr_rows = np.asarray(self.arr_rows, dtype=np.int64)
            lens = np.fromiter(
                (v.size for v in self.arr_vals), np.int64, len(self.arr_vals)
            )
            arr_offsets = np.concatenate(([0], np.cumsum(lens)))
            arr_values = (
                np.concatenate(self.arr_vals)
                if self.arr_vals
                else np.empty(0, np.uint16)
            )
            bmp_rows = np.asarray(self.bmp_rows, dtype=np.int64)
            bmp_words = (
                np.stack(self.bmp_list)
                if self.bmp_list
                else np.empty((0, bits.WORDS_PER_CONTAINER), np.uint64)
            )
            run_rows = np.asarray(self.run_rows, dtype=np.int64)
            run_counts = np.fromiter(
                (s.size for s in self.run_starts), np.int64, len(self.run_starts)
            )
            run_starts = (
                np.concatenate(self.run_starts)
                if self.run_starts
                else np.empty(0, np.uint16)
            )
            run_lengths = (
                np.concatenate(self.run_lengths)
                if self.run_lengths
                else np.empty(0, np.uint16)
            )
            m = self._mat = (
                arr_rows, arr_offsets, arr_values, bmp_rows, bmp_words,
                run_rows, run_counts, run_starts, run_lengths,
            )
        return m

    def expand_host(self) -> np.ndarray:
        """Expand to the uint32 [n, 2048] host word block with numpy:
        bitmap rows bulk-copy, array values scatter in one
        ``np.bitwise_or.at`` pass, run rows fill per interval."""
        (arr_rows, arr_offsets, arr_values, bmp_rows, bmp_words,
         run_rows, run_counts, run_starts, run_lengths) = self.materialize()
        out64 = np.zeros((self.n_rows, bits.WORDS_PER_CONTAINER), dtype=np.uint64)
        if len(bmp_rows):
            out64[bmp_rows] = bmp_words
        if len(arr_rows):
            lens = np.diff(arr_offsets)
            rows = np.repeat(arr_rows, lens)
            v = arr_values.astype(np.int64)
            flat_idx = rows * bits.WORDS_PER_CONTAINER + (v >> 6)
            bit = np.uint64(1) << (v & 63).astype(np.uint64)
            np.bitwise_or.at(out64.reshape(-1), flat_idx, bit)
        if len(run_rows):
            off = 0
            for r, cnt in zip(run_rows.tolist(), run_counts.tolist()):
                row = out64[r]
                for s, l in zip(
                    run_starts[off:off + cnt].tolist(),
                    run_lengths[off:off + cnt].tolist(),
                ):
                    bits.set_bitmap_range(row, s, s + l + 1)
                off += cnt
        return out64.view(np.uint32)

    def expand_device(self, device) -> torch.Tensor:
        """Ship the compact payload and expand it into int32 [n, 2048]
        rows on ``device`` (``ops/kernels.expand_rows``)."""
        return kernels.expand_rows(self.n_rows, *self.materialize(), device)


class PackedGroups:
    """Key-grouped containers packed for device reduction.

    ``group_keys``: int64 [G] high-16-bit chunk keys, ascending.
    ``group_offsets``: int64 [G+1] row ranges per group.
    ``device``: where the row block lives (default ``"cuda"``; raises
    without a card unless ``device="cpu"``).

    Row data lives in a compact :class:`RowPayload`; ``device_words`` (the
    int32 device block) expands from it on first touch."""

    def __init__(self, group_keys, group_offsets, payload: RowPayload, device=None):
        self.group_keys = group_keys
        self.group_offsets = group_offsets
        self.device = resolve_device(device)
        self._payload = payload
        self._device_words: Optional[torch.Tensor] = None
        self._padded_cache: Dict[int, Optional[torch.Tensor]] = {}
        self._bucket_cache: Dict[Tuple[int, int], list] = {}
        self._plan_cache: Dict[int, List[np.ndarray]] = {}
        self._reduce_touches: Dict[int, int] = {}

    @property
    def n_rows(self) -> int:
        return int(self.group_offsets[-1])

    @property
    def n_groups(self) -> int:
        return len(self.group_keys)

    @property
    def device_words(self) -> torch.Tensor:
        """The flat int32 [N, 2048] rows on ``device``: the device-side
        payload expansion, built once, then cached."""
        if self._device_words is None:
            self._device_words = self._payload.expand_device(self.device)
        return self._device_words

    def padded_device(self, fill: int) -> Optional[torch.Tensor]:
        """Dense-padded int32 [G, M, W] rows on the device, built once per
        ``fill`` from the flat rows (pad cells hold ``fill``), or None when
        the distribution is too skewed to pad (``dense_pad_plan``'s
        guard)."""
        key = int(fill)
        if key not in self._padded_cache:
            plan = dense_pad_plan(self.group_offsets)
            arr = None
            if plan is not None:
                m, slots = plan
                g = self.n_groups
                flat = self.device_words
                arr = torch.full(
                    (g * m, dev.DEVICE_WORDS), int(fill), dtype=torch.int32,
                    device=self.device,
                )
                arr.index_copy_(0, torch.from_numpy(slots).to(self.device), flat)
                arr = arr.view(g, m, dev.DEVICE_WORDS)
            self._padded_cache[key] = arr
        return self._padded_cache[key]

    def plan_buckets(self, n_buckets: int = 3) -> List[np.ndarray]:
        """The DP bucket plan for this working set, computed once per
        ``n_buckets`` (the counts never change after packing)."""
        k = int(n_buckets)
        if k not in self._plan_cache:
            self._plan_cache[k] = bucket_plan(np.diff(self.group_offsets), k)
        return self._plan_cache[k]

    def padded_buckets_device(self, fill: int, n_buckets: int = 3):
        """Ragged-batched padding: groups partitioned by row count into
        ``n_buckets`` contiguous-count buckets (optimal DP split), each
        padded to its own bucket-local M. Returns a list of
        ``(orig_group_idx int64[g_b], int32 [g_b, m_b, W])`` pairs, cached per
        (fill, n_buckets); every bucket is one device gather from the flat
        rows into a block prefilled with ``fill``."""
        key = (int(fill), int(n_buckets))
        if key not in self._bucket_cache:
            counts = np.diff(self.group_offsets)
            flat = self.device_words
            out = []
            for idx in self.plan_buckets(n_buckets):
                g_b, m_b = len(idx), int(counts[idx].max())
                b_counts = counts[idx]
                src = np.concatenate(
                    [np.arange(self.group_offsets[gi], self.group_offsets[gi + 1])
                     for gi in idx]
                )
                slot_of_row = np.repeat(np.arange(g_b), b_counts)
                local = np.arange(len(src)) - np.repeat(
                    np.cumsum(np.concatenate(([0], b_counts[:-1]))), b_counts
                )
                block = torch.full(
                    (g_b * m_b, dev.DEVICE_WORDS), int(fill), dtype=torch.int32,
                    device=self.device,
                )
                block.index_copy_(
                    0,
                    torch.from_numpy(slot_of_row * m_b + local).to(self.device),
                    flat.index_select(0, torch.from_numpy(src).to(self.device)),
                )
                out.append((idx, block.view(g_b, m_b, dev.DEVICE_WORDS)))
            self._bucket_cache[key] = out
        return self._bucket_cache[key]


def container_words(c: Container) -> np.ndarray:
    """A container as its int32 ``[2048]`` device row (the uint32 bits of
    the JAX package's ``store.container_words_u32``)."""
    w = c.words if isinstance(c, BitmapContainer) else c.to_words()
    return np.ascontiguousarray(w, dtype=np.uint64).view(np.int32)


def group_by_key(
    bitmaps: Sequence[RoaringBitmap], keys_filter: Optional[set] = None
) -> Dict[int, List[Container]]:
    """Transpose bitmaps into key-major groups
    (ParallelAggregation.groupByKey, ParallelAggregation.java:136-153)."""
    groups: Dict[int, List[Container]] = {}
    for bm in bitmaps:
        hlc = bm.high_low_container
        for k, c in zip(hlc.keys, hlc.containers):
            if keys_filter is not None and k not in keys_filter:
                continue
            groups.setdefault(k, []).append(c)
    return groups


def intersect_keys(bitmaps: Sequence[RoaringBitmap]) -> set:
    """Keys present in every input (Util.intersectKeys analogue,
    Util.java:1244-1259) — the workShyAnd pre-filter."""
    it = iter(bitmaps)
    first = next(it)
    keys = set(first.high_low_container.keys)
    for bm in it:
        keys &= set(bm.high_low_container.keys)
        if not keys:
            break
    return keys


def pack_groups(groups: Dict[int, List[Container]], device=None) -> PackedGroups:
    """Pack key-major groups into a compact :class:`RowPayload` working set
    whose rows expand on ``device`` (default ``"cuda"``) at first touch.
    Raises when ``device`` is a CUDA device and there is no card."""
    device = resolve_device(device)
    group_keys = np.array(sorted(groups), dtype=np.int64)
    counts = np.array([len(groups[int(k)]) for k in group_keys], dtype=np.int64)
    offsets = np.concatenate(([0], np.cumsum(counts)))
    payload = RowPayload()
    for k in group_keys:
        for c in groups[int(k)]:
            payload.append(c)
    return PackedGroups(group_keys, offsets, payload, device)


def bucket_plan(counts: np.ndarray, n_buckets: int) -> List[np.ndarray]:
    """Partition group indices into ≤ ``n_buckets`` buckets minimizing total
    padded rows Σ g_b·max(M_b).

    Sorted by descending count, the optimal bucketing is a contiguous
    partition of the sorted order (any bucket's cost is len·its largest
    member, so swapping non-contiguous members never helps), found by an
    O(G²·K) DP — G is the number of 2^16-key groups, so this is
    microseconds. Degenerate cases (G ≤ n_buckets, or a flat distribution)
    fall out naturally as fewer/equal buckets."""
    if n_buckets < 1:
        raise ValueError(f"n_buckets must be >= 1, got {n_buckets}")
    g = len(counts)
    if g == 0:
        return []
    order = np.argsort(-counts, kind="stable")
    srt = counts[order]
    k_max = min(int(n_buckets), g)
    INF = float("inf")
    # dp[i][k] = min padded rows covering sorted groups i.. with k buckets
    dp = np.full((g + 1, k_max + 1), INF)
    dp[g, :] = 0.0
    choice = np.zeros((g, k_max + 1), dtype=np.int64)
    for i in range(g - 1, -1, -1):
        for k in range(1, k_max + 1):
            spans = np.arange(i + 1, g + 1)
            costs = (spans - i) * srt[i] + dp[spans, k - 1]
            j = int(np.argmin(costs))
            dp[i, k] = costs[j]
            choice[i, k] = spans[j]
    cuts, i, k = [], 0, k_max
    while i < g:
        j = int(choice[i, k])
        cuts.append(order[i:j])
        i, k = j, k - 1
    return cuts


def dense_pad_plan(group_offsets: np.ndarray) -> Optional[Tuple[int, np.ndarray]]:
    """``(m, slots)`` for the dense [G, M, W] layout — ``slots[i]`` is the
    g*m-grid position of packed row i (row r of group gi at local position
    p lands at gi*m + p), M the largest group. None when the distribution
    is too skewed to pad (the guard: padded cells > max(2*rows, 1024))."""
    counts = np.diff(group_offsets)
    g = len(counts)
    n = int(group_offsets[-1])
    m = int(counts.max()) if g else 0
    if g * m > max(2 * n, 1024):
        return None
    if n:
        group_of_row = np.repeat(np.arange(g), counts)
        local = np.arange(n) - np.repeat(group_offsets[:-1], counts)
        slots = group_of_row * m + local
    else:
        slots = np.empty(0, dtype=np.int64)
    return m, slots


def _reduce_and_count(words, plan, op, row_map=None):
    red = kernels.group_reduce(words, plan, op, row_map=row_map)
    return red, kernels.popcount_rows(red)


def prepare_reduce(packed: PackedGroups, op: str = "or"):
    """Build the device reduction closure for a packed group set.

    Returns ``(run, layout)`` where ``run()`` -> (reduced int32 [G, 2048]
    device tensor, int32 [G] cardinalities) and ``layout`` is ``"padded"``,
    ``"bucketed"``, or ``"segmented-scan"`` — the JAX package's rule on
    host-side row counts:

    * single dense block when its occupancy is already >= 0.9;
    * count-bucketed ragged batching when bucketing keeps total padded
      rows <= 1.5x the live rows;
    * else the segmented layout (here a segmented reduce over the group
      offsets of the flat rows).

    The FIRST reduce of a freshly packed set on the padded layout reads
    the flat rows through a row map (the cold fused gather) instead of
    building the padded block it would use once; the SECOND touch builds
    the resident [G, M, W] block and every later reduce reads that.
    """
    n = packed.n_rows
    counts = np.diff(packed.group_offsets)
    g = packed.n_groups
    single_rows = int(g * counts.max()) if g else 0
    # empty sets keep the (trivial) single-block path
    if not g or not n or single_rows <= n / 0.9:
        fill = int(dev._INIT[op])
        built = fill in packed._padded_cache
        touches = packed._reduce_touches
        first_prepare = not touches.get(fill, 0)
        touches[fill] = touches.get(fill, 0) + 1
        if g and n and not built and first_prepare:
            plan = dense_pad_plan(packed.group_offsets)
            if plan is not None:
                m, slots = plan
                src_map = np.full(g * m, n, dtype=np.int64)
                src_map[slots] = np.arange(n)
                dense_plan = kernels.SegmentPlan.dense(g, m)
                calls = [0]

                def run_fused():
                    calls[0] += 1
                    if calls[0] == 1 and fill not in packed._padded_cache:
                        flat = packed.device_words
                        row_map = torch.from_numpy(src_map).to(flat.device)
                        return _reduce_and_count(flat, dense_plan, op, row_map)
                    return _reduce_and_count(packed.padded_device(fill), dense_plan, op)

                LAYOUT_COUNTS["padded"] += 1
                return run_fused, "padded"
        dev_arr = packed.padded_device(fill)
        if dev_arr is not None:
            plan = kernels.SegmentPlan.dense(dev_arr.shape[0], dev_arr.shape[1])

            def run():
                return _reduce_and_count(dev_arr, plan, op)

            LAYOUT_COUNTS["padded"] += 1
            return run, "padded"
    if g and n:
        bucket_rows = sum(
            len(idx) * int(counts[idx].max())
            for idx in packed.plan_buckets(DEFAULT_BUCKETS)
        )
        if bucket_rows <= 1.5 * n:
            return prepare_reduce_bucketed(packed, op=op, n_buckets=DEFAULT_BUCKETS)

    plan = kernels.SegmentPlan.csr(packed.group_offsets)
    words = packed.device_words

    def run():
        return _reduce_and_count(words, plan, op)

    LAYOUT_COUNTS["segmented-scan"] += 1
    return run, "segmented-scan"


def prepare_reduce_bucketed(packed: PackedGroups, op: str = "or", n_buckets: int = 3):
    """Ragged-batched variant of prepare_reduce: one grouped reduce per
    count bucket, results put back in ascending key order. Same (run,
    layout) contract; layout = "bucketed"."""
    buckets = packed.padded_buckets_device(dev._INIT[op], n_buckets)
    LAYOUT_COUNTS["bucketed"] += 1
    if not buckets:  # empty working set: same contract as reduce_packed

        def run_empty():
            return (
                torch.empty((0, dev.DEVICE_WORDS), dtype=torch.int32, device=packed.device),
                torch.empty((0,), dtype=torch.int32, device=packed.device),
            )

        return run_empty, "bucketed"
    order = np.concatenate([idx for idx, _ in buckets])
    inv = torch.from_numpy(np.argsort(order)).to(packed.device)
    plans = [kernels.SegmentPlan.dense(a.shape[0], a.shape[1]) for _, a in buckets]

    def run():
        reds = [
            kernels.group_reduce(a, p, op) for (_, a), p in zip(buckets, plans)
        ]
        red = torch.cat(reds, dim=0)[inv]
        return red, kernels.popcount_rows(red)

    return run, "bucketed"


def reduce_packed(packed: PackedGroups, op: str = "or"):
    """Reduce each key group on the device; returns (words [G,2048]
    np.uint32, cards [G] np.int64) on the host."""
    if packed.n_groups == 0:
        return (
            np.empty((0, dev.DEVICE_WORDS), dtype=np.uint32),
            np.empty((0,), dtype=np.int64),
        )
    run, _ = prepare_reduce(packed, op)
    red, card = run()
    return dev.to_host_u32(red), card.cpu().numpy().astype(np.int64)


def reduce_packed_cardinality(packed: PackedGroups, op: str = "or") -> np.ndarray:
    """Per-group cardinalities only: the reduced words stay on the device —
    the host fetch is G ints."""
    if packed.n_groups == 0:
        return np.empty((0,), dtype=np.int64)
    run, _ = prepare_reduce(packed, op)
    _red, card = run()
    return card.cpu().numpy().astype(np.int64)


def unpack_to_bitmap(
    group_keys: np.ndarray, words_u32: np.ndarray, cards: np.ndarray
) -> RoaringBitmap:
    """Stream device results back into a RoaringBitmap via the append path
    (RoaringArray.append, RoaringArray.java:111), re-compressing each chunk."""
    out = RoaringBitmap()
    for key, c in iter_group_containers(group_keys, words_u32, cards):
        out.high_low_container.append(key, c)
    return out


def iter_group_containers(group_keys: np.ndarray, words_u32: np.ndarray, cards: np.ndarray):
    """Yield ``(key, Container)`` per non-empty group with card-driven
    construction (the device already popcounted each group)."""
    words64 = np.ascontiguousarray(words_u32).view(np.uint64)
    for gi, key in enumerate(group_keys.tolist()):
        card = int(cards[gi])
        if card == 0:
            continue
        w = words64[gi]
        if card <= 4096:
            yield int(key), ArrayContainer(bits.values_from_words(w))
        else:
            yield int(key), BitmapContainer(w.copy(), card)
