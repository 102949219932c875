"""Device container store: SoA packing of containers onto the card, and
the resident pack cache.

Counterpart of ``roaringbitmap_tpu/parallel/store.py`` for the aggregation
and query paths. All containers of a working set are transposed host-side
into key-major order (``group_by_key``) and collected into a compact
:class:`RowPayload` — borrows of array values, run intervals and bitmap
words (``pack_groups``). At first touch the payload is shipped and expanded
on the device into ONE ``int32 [N, 2048]`` row block (``ops/kernels
.expand_rows``); ``prepare_reduce`` then picks the padded, bucketed or
segmented layout by the same rule as the JAX package and runs the grouped
reduce and the per-group popcount through the CUDA kernels
(``ops/kernels.group_reduce`` / ``popcount_rows``). Results come back to
the host as uint32 words and are re-compressed into containers
(``unpack_to_bitmap``).

:class:`PackCache` (``PACK_CACHE``, ``packed_for``) keeps packed working
sets, the BSI slice tensors and the query kernels' packs resident across
calls, keyed by the operands' fingerprints and the device, under one
byte-budget LRU. A working set whose bitmaps mutated in place is refreshed
by a delta repack: only the rows of the dirty containers are re-expanded
and written into the resident rows (``PackedGroups.apply_delta``, one
``index_copy_``); structural changes repack in full.

Instrumentation, as in the JAX package: the pack and delta stages time
into latency histograms and the flight recorder (``observe.timeline``);
the layouts, transfer bytes, resident bytes and the pack cache's hits,
misses, delta rows and evicted bytes are registry metrics
(``LAYOUT_COUNTS`` and ``TRANSFER_BYTES`` are mapping views of them); the
reduces and the unpack run under ``tracing.op_timer``; the cache records
its admissions, spills and evictions in the decision log. The copy of a
payload or of delta rows to the device holds the ``store.ship`` and
``store.hbm`` fault sites, the expansion the ``store.expand`` site, each
under ``robust.ladder.retry``: a transient failure is retried on the
card, and any other failure raises — there is no host re-expansion. The
``pack_cache.budget`` site spills cold entries and serves the working set
uncached, a caching choice that stays on the device.

The cache remembers its recent evictions: a miss that re-packs a
remembered working set joins the eviction's decision with the re-pack wall
as measured regret (the outcome ledger's ``pack_cache.evict`` site).
:func:`hbm_reconciliation` checks the resident-bytes gauge against the
caches' own byte ledgers and against the card's allocator
(``torch.cuda.memory_allocated``), exporting the drift as
``rb_tpu_hbm_accounting_drift_bytes{source}``.

An eviction is priced by the residency authority's learned re-pack cost
for its kind (``cost.residency``): the evict decision records it as
``est_us`` (``repack`` and ``rebuild``) once evict-regret traffic has
taught the curve, so the regret join scores the pricing. Once the durable
tier has persisted an epoch it installs a demotion probe
(:func:`set_demotion_probe`): an eviction the probe accepts demotes to the
mapped rung (``rb_tpu_durable_demote_total{rung="mapped"}``, the
``demote-mapped`` decision, priced with the learned ``readmit`` cost)
instead of discarding. :meth:`PackCache.resident_bytes_for` charges a
working set's resident bytes to its leaves' fingerprints (the serving
tier's per-tenant byte shares).

Pins are a refcount on an entry (:meth:`PackCache.pin_packed` /
``unpin_packed``): a pinned entry is never evicted, and is found by
identity even after its bitmaps mutated. :meth:`PackCache.last_route`
reads this thread's route of its last ``get_packed`` (``hit``, ``delta``,
``full`` or ``disabled``), which the epoch flip's lineage records.
"""

from __future__ import annotations

import os
import threading
import time as _time
import weakref
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import native
from .. import observe as _observe
from .. import tracing
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
from ..observe import decisions as _decisions
from ..observe import outcomes as _outcomes
from ..observe import timeline as _timeline
from ..robust import errors as _rerrors
from ..robust import faults as _faults
from ..robust import ladder as _ladder
from ..utils import bits

# marshal stage attribution: every pack / delta-repack stage lands in a
# log-bucketed latency histogram (p50/p99 in every export) and, when
# RB_TPU_TIMELINE is active, in the flight recorder
_PACK_STAGE_SECONDS = _observe.latency_histogram(
    _observe.STORE_PACK_STAGE_SECONDS,
    "Wall time of marshal pack stages (key_plan | group_tables | "
    "payload_build | host_words | fingerprints | provenance | "
    "dense_pad_plan | device_expand | ship | overlap_wait | padded_build | "
    "bucket_build)",
    ("stage",),
)
_DELTA_STAGE_SECONDS = _observe.latency_histogram(
    _observe.STORE_DELTA_STAGE_SECONDS,
    "Wall time of incremental delta-repack stages (dirty_scan | "
    "host_rows | scatter | republish)",
    ("stage",),
)
LAYOUTS = ("padded", "bucketed", "segmented-scan")
_LAYOUT_TOTAL = _observe.counter(
    _observe.STORE_LAYOUT_TOTAL,
    "prepare_reduce layout choices (padded | bucketed | segmented-scan)",
    ("layout",),
)
# layout choices made by prepare_reduce, by name: a run can show which
# layout served it
LAYOUT_COUNTS = _observe.CounterMap(_LAYOUT_TOTAL, scalar=True)
for _layout in LAYOUTS:
    LAYOUT_COUNTS[_layout] = 0
# host-to-device transfer bytes by route (payload_expand: the compact
# payload shipped for expansion; pack_delta: delta rows; the
# *_built_on_device routes: layouts gathered on the card, no host bytes)
_TRANSFER_TOTAL = _observe.counter(
    _observe.STORE_TRANSFER_BYTES_TOTAL,
    "Host->device transfer bytes by route (device-built blocks tracked "
    "under their own route so the ledger stays truthful)",
    ("route",),
)
TRANSFER_BYTES = _observe.CounterMap(_TRANSFER_TOTAL, scalar=True)
# bytes of device-resident working-set tensors held by PackedGroups
_RESIDENT_BYTES = _observe.gauge(
    _observe.STORE_RESIDENT_BYTES,
    "Device-resident cached working-set bytes by layout kind",
    ("kind",),
)
_PACK_HITS = _observe.counter(
    _observe.PACK_CACHE_HITS_TOTAL,
    "Pack-cache lookups served resident (incl. delta-refreshed entries)",
    ("kind",),
)
_PACK_MISSES = _observe.counter(
    _observe.PACK_CACHE_MISSES_TOTAL,
    "Pack-cache lookups that paid a full host pack",
    ("kind",),
)
_PACK_DELTA_ROWS = _observe.counter(
    _observe.PACK_CACHE_DELTA_ROWS_TOTAL,
    "Rows re-packed and shipped by incremental delta repacks",
    ("kind",),
)
_PACK_EVICTED_BYTES = _observe.counter(
    _observe.PACK_CACHE_EVICTED_BYTES_TOTAL,
    "Bytes released by byte-budget LRU eviction",
    ("kind",),
)
_DEMOTE_TOTAL = _observe.counter(
    _observe.DURABLE_DEMOTE_TOTAL,
    "Evictions by residency rung (mapped = working set stays "
    "re-admittable from the persisted epoch mmap | discard = cold "
    "repack on return — the pre-durable behavior)",
    ("rung",),
)
_PACK_RESIDENT = _observe.gauge(
    _observe.PACK_CACHE_RESIDENT_BYTES,
    "Bytes currently resident in the pack cache by entry kind",
    ("kind",),
)
# residency reconciliation: the resident-bytes gauge against the caches'
# byte ledgers ("ledger") and against the card's allocator ("device")
_HBM_DRIFT = _observe.gauge(
    _observe.HBM_ACCOUNTING_DRIFT_BYTES,
    "Resident-bytes gauge minus independent ground truth (ledger = the "
    "caches' entry ledgers, device = the CUDA allocator's allocated bytes "
    "on the devices holding entries)",
    ("source",),
)
# default ragged-batch bucket count for the prepare_reduce cost model
DEFAULT_BUCKETS = 3
# bytes of one expanded container row on the device
ROW_BYTES = dev.DEVICE_WORDS * 4


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

    def materialize(self, pinned: bool = False):
        """Concatenate the borrows into flat numpy arrays (cached):
        ``(arr_rows, arr_offsets, arr_values, bmp_rows, bmp_words64,
        run_rows, run_counts, run_starts, run_lengths)``.

        ``pinned=True`` returns the same arrays as host tensors in pinned
        (page-locked) memory, each concatenated straight into its buffer
        (``np.concatenate(..., out=)``, no second copy; uint16 as int16
        bits, uint64 as int64 bits), not cached: the staging the card's
        ``non_blocking`` copies read."""
        if pinned:
            return self._materialize_pinned()
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

    def _materialize_pinned(self):
        def buf(shape, dtype):
            t = torch.empty(shape, dtype=dtype, pin_memory=True)
            return t, t.numpy()

        n_arr, n_bmp, n_run = len(self.arr_rows), len(self.bmp_rows), len(self.run_rows)
        arr_rows, a = buf(n_arr, torch.int64)
        a[:] = self.arr_rows
        arr_offsets, a = buf(n_arr + 1, torch.int64)
        a[0] = 0
        np.cumsum(np.fromiter((v.size for v in self.arr_vals), np.int64, n_arr), out=a[1:])
        arr_values, a = buf(self.n_values, torch.int16)
        if n_arr:
            np.concatenate(self.arr_vals, out=a.view(np.uint16))
        bmp_rows, a = buf(n_bmp, torch.int64)
        a[:] = self.bmp_rows
        bmp_words, a = buf((n_bmp, bits.WORDS_PER_CONTAINER), torch.int64)
        if n_bmp:
            np.stack(self.bmp_list, out=a.view(np.uint64))
        run_rows, a = buf(n_run, torch.int64)
        a[:] = self.run_rows
        run_counts, a = buf(n_run, torch.int64)
        a[:] = np.fromiter((v.size for v in self.run_starts), np.int64, n_run)
        run_starts, a = buf(self.n_run_intervals, torch.int16)
        if n_run:
            np.concatenate(self.run_starts, out=a.view(np.uint16))
        run_lengths, a = buf(self.n_run_intervals, torch.int16)
        if n_run:
            np.concatenate(self.run_lengths, out=a.view(np.uint16))
        return (arr_rows, arr_offsets, arr_values, bmp_rows, bmp_words,
                run_rows, run_counts, run_starts, run_lengths)

    def expand_host(self) -> np.ndarray:
        """Expand to the uint32 [n, 2048] host word block: bitmap rows
        bulk-copy, array values scatter in one pass (the native tier's
        ``rb_pack_array_rows``, else ``np.bitwise_or.at``), run rows fill
        every interval in one pass (the native tier's
        ``rb_fill_intervals_rows``, else its vectorized plain version)."""
        from ..columnar import kernels as ck

        (arr_rows, arr_offsets, arr_values, bmp_rows, bmp_words,
         run_rows, run_counts, run_starts, run_lengths) = self.materialize()
        out64 = np.zeros((self.n_rows, bits.WORDS_PER_CONTAINER), dtype=np.uint64)
        if len(bmp_rows):
            out64[bmp_rows] = bmp_words
        if len(arr_rows) and native.available():
            native.pack_array_rows(arr_rows, arr_offsets, arr_values, out64)
        elif len(arr_rows):
            lens = np.diff(arr_offsets)
            rows = np.repeat(arr_rows, lens)
            v = arr_values.astype(np.int64)
            flat_idx = rows * bits.WORDS_PER_CONTAINER + (v >> 6)
            bit = np.uint64(1) << (v & 63).astype(np.uint64)
            np.bitwise_or.at(out64.reshape(-1), flat_idx, bit)
        if len(run_rows):
            offs = np.zeros(len(run_rows) + 1, dtype=np.int64)
            np.cumsum(run_counts, out=offs[1:])
            starts = np.asarray(run_starts).view(np.uint16).astype(np.int64)
            ends = starts + np.asarray(run_lengths).view(np.uint16).astype(np.int64) + 1
            fill = native.fill_intervals_rows if native.available() else ck.fill_intervals_rows_numpy
            fill(run_rows, offs, starts, ends, out64, "or")
        return out64.view(np.uint32)

    def expand_device(self, device) -> torch.Tensor:
        """Ship the compact payload and expand it into int32 [n, 2048]
        rows on ``device`` (``ops/kernels.expand_rows``). On a CUDA device
        the payload is staged in pinned host memory and copied without
        blocking on the current stream (PyTorch's pinned allocator keeps
        each buffer until the copies that read it have completed). The
        copy is the ``store.ship`` fault site, the expansion the
        ``store.expand`` site (:func:`_guarded`)."""
        device = torch.device(device)
        with _timeline.stage(
            _PACK_STAGE_SECONDS, "ship", "pack.ship", cat="pack", bytes=self.nbytes,
        ):
            parts = kernels.payload_parts(
                self.n_rows, *self.materialize(pinned=device.type == "cuda")
            )
            shipped = _guarded("store.ship", lambda: kernels.ship_payload(parts, device))
        _TRANSFER_TOTAL.inc(self.nbytes, ("payload_expand",))
        with _timeline.stage(
            _PACK_STAGE_SECONDS, "device_expand", "pack.device_expand", cat="pack",
            rows=self.n_rows,
        ):
            return _guarded("store.expand", lambda: kernels.expand_parts(self.n_rows, shipped))


def _guarded(site: str, fn: Callable[[], object]):
    """One device step through the fault model: the ``site`` fault point
    (``store.ship`` for a copy, ``store.expand`` for the expansion) and
    ``store.hbm`` (device memory) fire before ``fn``; a transient failure
    is retried with jittered backoff (``robust.ladder.retry``; every
    attempt builds its output anew, so a retry is idempotent), anything
    else raises. The timeline's ``fenced`` mode synchronises the result's
    stream inside the attempt."""

    def _attempt():
        _faults.fault_point(site)
        _faults.fault_point("store.hbm")
        out = fn()
        _timeline.fence(out[0] if isinstance(out, tuple) else out)
        return out

    return _ladder.retry(site, _attempt)


def ship_rows(containers: Sequence[Container], device=None) -> torch.Tensor:
    """Expand a bare container list straight to flat int32 ``[n, 2048]``
    rows on ``device`` through the same device-side expansion as the packed
    working sets (the query kernels' first-operand rows)."""
    return RowPayload.from_containers(containers).expand_device(resolve_device(device))


class PackedGroups:
    """Key-grouped containers packed for device reduction.

    ``group_keys``: int64 [G] high-16-bit chunk keys, ascending.
    ``group_offsets``: int64 [G+1] row ranges per group.
    ``device``: where the row block lives (default ``"cuda"``; raises
    without a card unless ``device="cpu"``).

    Row data lives in a compact :class:`RowPayload`; ``device_words`` (the
    int32 device block) expands from it on first touch, and the padded and
    bucketed layouts are gathered from those rows on the device.

    A delta repack (:meth:`apply_delta`) writes fresh rows into the
    resident flat block in place and drops the derived layouts, which
    rebuild from the flat rows on next touch. The replaced rows are also
    kept as host row overrides (at most one per packed row), so a later
    re-expansion from the payload (after :meth:`close`) converges on the
    same bits. The layout epoch, bumped by every delta, keeps a lazy build
    that raced a delta from being published as the current layout.

    While the working set is resident in a :class:`PackCache` the cache
    owns its lifetime: :meth:`close` is then a no-op, and the derived
    layouts' device bytes are reported to the cache's byte budget.

    On the card the flat rows may be written (expanded or delta-patched)
    on one stream, the overlap lane's, and read on another, so the
    ordering lives here. Every write records an event on its stream. A
    read from another stream waits for that event and marks the rows as
    in use on its stream (``record_stream``), so the caching allocator
    cannot hand the block to a new tensor while that read is queued. A
    delta patch first waits for the last writing stream and every stream
    that has read the rows since. The derived layouts are built from the
    flat rows on the reading stream."""

    def __init__(self, group_keys, group_offsets, payload: RowPayload, device=None):
        self.group_keys = group_keys
        self.group_offsets = group_offsets
        self.device = resolve_device(device)
        self._payload = payload
        self._device_words: Optional[torch.Tensor] = None
        # on the card: (event, stream) of the last write to the flat rows,
        # and the other streams that have read them since
        self._written: Optional[tuple] = None  # guarded-by: self._lock
        self._readers: set = set()  # guarded-by: self._lock
        # by fill, or (fill, row_multiple) for the mesh route's padding
        self._padded_cache: Dict[object, Optional[torch.Tensor]] = {}
        self._bucket_cache: Dict[Tuple[int, int], list] = {}
        self._plan_cache: Dict[int, List[np.ndarray]] = {}
        self._reduce_touches: Dict[int, int] = {}
        self._row_overrides: Dict[int, np.ndarray] = {}  # guarded-by: self._lock
        self._layout_epoch = 0  # guarded-by: self._lock
        # derived-layout device bytes by kind, and the owning cache's
        # byte-accounting callback (None when not cache-held)
        self._resident_held: Dict[str, int] = {}  # guarded-by: self._lock
        self._resident_cb: Optional[Callable[[int], None]] = None
        self._cache_held = False
        # guards publication of lazily built layouts against a concurrent
        # delta; never held while calling into the cache
        self._lock = threading.Lock()

    @property
    def n_rows(self) -> int:
        return int(self.group_offsets[-1])

    @property
    def n_groups(self) -> int:
        return len(self.group_keys)

    @property
    def words_nbytes(self) -> int:
        """Device bytes of the flat row block: the working set's base
        weight in a cache's byte budget."""
        return self.n_rows * ROW_BYTES

    @property
    def device_words(self) -> torch.Tensor:
        """The flat int32 [N, 2048] rows on ``device``: the device-side
        payload expansion (plus any delta row overrides), built once, then
        cached, and ordered after their last write for the current
        stream."""
        d = self._device_words
        if d is None:
            with self._lock:
                epoch = self._layout_epoch
                overrides = dict(self._row_overrides)
            d = self._payload.expand_device(self.device)
            if overrides:
                rows = np.fromiter(overrides, np.int64, len(overrides))
                d.index_copy_(
                    0, torch.from_numpy(rows).to(d.device),
                    torch.from_numpy(np.stack([overrides[int(r)] for r in rows])).to(d.device),
                )
            with self._lock:
                if self._layout_epoch != epoch:
                    return d  # raced a delta repack: do not publish
                if self._device_words is None:
                    self._wrote(d)
                    self._device_words = d
                    _RESIDENT_BYTES.inc(self.words_nbytes, ("flat_rows",))
                d = self._device_words
        return self._read_order(d)

    def _wrote(self, d: torch.Tensor) -> None:
        """Record a write to the flat rows just queued on the current
        stream. Caller holds self._lock."""
        if d.is_cuda:
            stream = torch.cuda.current_stream(d.device)
            event = torch.cuda.Event()
            event.record(stream)
            self._written = (event, stream)
            self._readers = set()

    def _read_order(self, d: torch.Tensor) -> torch.Tensor:
        """Order a read of the flat rows on the current stream after their
        last write, when another stream made it."""
        written = self._written
        if written is None or not d.is_cuda:
            return d
        event, stream = written
        cur = torch.cuda.current_stream(d.device)
        if cur != stream:
            cur.wait_event(event)
            d.record_stream(cur)
            with self._lock:
                self._readers.add(cur)
        return d

    def _write_order(self, d: torch.Tensor) -> None:
        """Order a write to the flat rows on the current stream after the
        last write and every read queued since on other streams. Caller
        holds self._lock."""
        if self._written is None or not d.is_cuda:
            return
        cur = torch.cuda.current_stream(d.device)
        for stream in {self._written[1], *self._readers}:
            if stream != cur:
                cur.wait_stream(stream)
        d.record_stream(cur)

    def device_tensors(self) -> List[torch.Tensor]:
        """Every device tensor the working set holds now: the flat rows and
        the derived layouts built so far."""
        with self._lock:
            out = [] if self._device_words is None else [self._device_words]
            out += [a for a in self._padded_cache.values() if a is not None]
            for buckets in self._bucket_cache.values():
                out += [a for _idx, a in buckets]
        return out

    def _publish(self, cache: dict, key, value, kind: str, nbytes: int, epoch: int):
        """Publish a lazily built layout unless a delta moved the epoch
        since the build started (then the caller still gets its build) or
        another thread published first; report new device bytes."""
        with self._lock:
            if self._layout_epoch != epoch:
                return value
            if key in cache:
                return cache[key]
            cache[key] = value
            if nbytes:
                self._resident_held[kind] = self._resident_held.get(kind, 0) + nbytes
        if nbytes:
            _RESIDENT_BYTES.inc(nbytes, (kind,))
        self._notify_resident(nbytes)
        return value

    def _notify_resident(self, delta: int) -> None:
        cb = self._resident_cb
        if cb is not None and delta:
            cb(delta)

    def _drop(self, flat: bool) -> None:
        """Drop the derived layouts (and with ``flat`` the flat rows too),
        settling their share of the resident bytes."""
        with self._lock:
            held = dict(self._resident_held)
            self._resident_held.clear()
            self._padded_cache = {}
            self._bucket_cache = {}
            flat_bytes = 0
            if flat:
                if self._device_words is not None:
                    flat_bytes = self.words_nbytes
                self._device_words = None
                self._written = None
                self._readers = set()
        for kind, nbytes in held.items():
            _RESIDENT_BYTES.dec(nbytes, (kind,))
        if flat_bytes:
            _RESIDENT_BYTES.dec(flat_bytes, ("flat_rows",))
        self._notify_resident(-sum(held.values()))

    def close(self) -> None:
        """Release the device tensors now. A no-op while the working set is
        resident in a pack cache (the cache owns its lifetime and closes it
        on eviction); a closed working set stays usable and rebuilds on
        next touch. Idempotent."""
        if not self._cache_held:
            self._drop(flat=True)

    def apply_delta(self, rows: np.ndarray, new_words: np.ndarray) -> None:
        """Incremental repack: replace flat ``rows`` (int64 [k]) with
        ``new_words`` (int32 [k, 2048], freshly expanded container words).
        The resident flat rows are patched in place by one ``index_copy_``
        (the counterpart of the JAX package's donated row scatter), the
        rows are recorded as host overrides for any later re-expansion,
        and every derived layout drops and re-derives from the flat rows on
        next touch. The group structure is unchanged by contract: a
        structural change takes the full repack in :class:`PackCache`."""
        rows = np.asarray(rows, dtype=np.int64)
        new_words = np.ascontiguousarray(new_words, dtype=np.int32)
        with _timeline.stage(
            _DELTA_STAGE_SECONDS, "scatter", "delta.scatter", cat="delta",
            rows=len(rows), bytes=int(new_words.nbytes),
        ), self._lock:
            self._layout_epoch += 1
            for r, row in zip(rows.tolist(), new_words):
                self._row_overrides[int(r)] = row.copy()
            d = self._device_words
            if d is not None and len(rows):
                self._write_order(d)

                def ship():
                    # the rows written in place: a retry writes them again
                    d.index_copy_(
                        0, torch.from_numpy(rows).to(d.device),
                        torch.from_numpy(new_words).to(d.device),
                    )
                    return d

                _guarded("store.ship", ship)
                self._wrote(d)
                _TRANSFER_TOTAL.inc(int(new_words.nbytes), ("pack_delta",))
        with _timeline.stage(
            _DELTA_STAGE_SECONDS, "republish", "delta.republish", cat="delta"
        ):
            self._drop(flat=False)

    def padded_device(self, fill: int, row_multiple: int = 1) -> Optional[torch.Tensor]:
        """Dense-padded int32 [G, M, W] rows on the device, built once per
        ``fill`` and ``row_multiple`` (M rounded up to a multiple of it, the
        mesh route's ``containers`` size) by :func:`pad_groups_dense`, or
        None when the distribution is too skewed to pad."""
        key = int(fill) if row_multiple == 1 else (int(fill), int(row_multiple))
        cache = self._padded_cache
        if key in cache:
            return cache[key]
        with self._lock:
            epoch = self._layout_epoch
        with _timeline.stage(
            _PACK_STAGE_SECONDS, "padded_build", "pack.padded_build", cat="pack",
            groups=self.n_groups, on_device=1,
        ):
            arr = _guarded("store.ship", lambda: pad_groups_dense(self, fill, row_multiple))
        nbytes = 0 if arr is None else arr.numel() * 4
        if nbytes:
            _TRANSFER_TOTAL.inc(nbytes, ("padded_groups_built_on_device",))
        return self._publish(cache, key, arr, "padded_groups", nbytes, epoch)

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
        cache = self._bucket_cache
        if key in cache:
            return cache[key]
        with self._lock:
            epoch = self._layout_epoch
        with _timeline.stage(
            _PACK_STAGE_SECONDS, "bucket_build", "pack.bucket_build", cat="pack",
            buckets=int(n_buckets), groups=self.n_groups,
        ):
            out = _guarded("store.ship", lambda: self._build_buckets(fill, n_buckets))
        nbytes = sum(a.numel() * 4 for _, a in out)
        if nbytes:
            _TRANSFER_TOTAL.inc(nbytes, ("padded_buckets_built_on_device",))
        return self._publish(cache, key, out, "padded_buckets", nbytes, epoch)

    def _build_buckets(self, fill: int, n_buckets: int) -> list:
        """One gather a bucket from the flat rows into a block prefilled
        with ``fill``: ``[(orig_group_idx, int32 [g_b, m_b, W]), ...]``."""
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
        return out


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
    with _timeline.stage(
        _PACK_STAGE_SECONDS, "key_plan", "pack.key_plan", cat="pack",
        bitmaps=len(bitmaps),
    ):
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
    with _timeline.stage(
        _PACK_STAGE_SECONDS, "group_tables", "pack.group_tables", cat="pack",
        groups=len(groups),
    ):
        group_keys = np.array(sorted(groups), dtype=np.int64)
        counts = np.array([len(groups[int(k)]) for k in group_keys], dtype=np.int64)
        offsets = np.concatenate(([0], np.cumsum(counts)))
    payload = RowPayload()
    with _timeline.stage(
        _PACK_STAGE_SECONDS, "payload_build", "pack.payload_build", cat="pack",
        rows=int(offsets[-1]),
    ):
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


def dense_pad_plan(
    group_offsets: np.ndarray, row_multiple: int = 1
) -> Optional[Tuple[int, np.ndarray]]:
    """``(m, slots)`` for the dense [G, M, W] layout — ``slots[i]`` is the
    g*m-grid position of packed row i (row r of group gi at local position
    p lands at gi*m + p), M the largest group rounded up to
    ``row_multiple``. None when the distribution is too skewed to pad (the
    guard: padded cells > max(2*rows, 1024))."""
    counts = np.diff(group_offsets)
    g = len(counts)
    n = int(group_offsets[-1])
    m = int(counts.max()) if g else 0
    m += (-m) % row_multiple
    if g * m > max(2 * n, 1024):
        return None
    if n:
        group_of_row = np.repeat(np.arange(g), counts)
        local = np.arange(n) - np.repeat(group_offsets[:-1], counts)
        slots = group_of_row * m + local
    else:
        slots = np.empty(0, dtype=np.int64)
    return m, slots


def pad_groups_dense(
    packed: PackedGroups, fill: int, row_multiple: int = 1
) -> Optional[torch.Tensor]:
    """Dense int32 [G, M, W] padding of a packed group set on its device
    (the layout and skew guard of :func:`dense_pad_plan`; pad cells hold
    ``fill``): one gather of the flat rows, no per-group loop. None when
    the distribution is too skewed to pad."""
    plan = dense_pad_plan(packed.group_offsets, row_multiple)
    if plan is None:
        return None
    m, slots = plan
    g = packed.n_groups
    arr = torch.full(
        (g * m, dev.DEVICE_WORDS), int(fill), dtype=torch.int32, device=packed.device
    )
    if packed.n_rows:
        arr.index_copy_(0, torch.from_numpy(slots).to(packed.device), packed.device_words)
    return arr.view(g, m, dev.DEVICE_WORDS)


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
                        with tracing.op_timer("store.reduce.padded_fused"):
                            flat = packed.device_words
                            row_map = torch.from_numpy(src_map).to(flat.device)
                            return _reduce_and_count(flat, dense_plan, op, row_map)
                    arr = packed.padded_device(fill)
                    with tracing.op_timer("store.reduce.padded"):
                        return _reduce_and_count(arr, dense_plan, op)

                _LAYOUT_TOTAL.inc(1, ("padded",))
                return run_fused, "padded"
        dev_arr = packed.padded_device(fill)
        if dev_arr is not None:
            plan = kernels.SegmentPlan.dense(dev_arr.shape[0], dev_arr.shape[1])

            def run():
                with tracing.op_timer("store.reduce.padded"):
                    return _reduce_and_count(dev_arr, plan, op)

            _LAYOUT_TOTAL.inc(1, ("padded",))
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
        with tracing.op_timer("store.reduce.segmented-scan"):
            return _reduce_and_count(words, plan, op)

    _LAYOUT_TOTAL.inc(1, ("segmented-scan",))
    return run, "segmented-scan"


def prepare_reduce_bucketed(packed: PackedGroups, op: str = "or", n_buckets: int = 3):
    """Ragged-batched variant of prepare_reduce: one grouped reduce per
    count bucket, results put back in ascending key order. Same (run,
    layout) contract; layout = "bucketed"."""
    buckets = packed.padded_buckets_device(dev._INIT[op], n_buckets)
    _LAYOUT_TOTAL.inc(1, ("bucketed",))
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
        with tracing.op_timer("store.reduce.bucketed"):
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
    return dev.to_host_u32(red), dev.to_host_i64(card)


def reduce_packed_cardinality(packed: PackedGroups, op: str = "or") -> np.ndarray:
    """Per-group cardinalities only: the reduced words stay on the device —
    the host fetch is G ints."""
    if packed.n_groups == 0:
        return np.empty((0,), dtype=np.int64)
    run, _ = prepare_reduce(packed, op)
    _red, card = run()
    return dev.to_host_i64(card)


def unpack_to_bitmap(
    group_keys: np.ndarray, words_u32: np.ndarray, cards: np.ndarray
) -> RoaringBitmap:
    """Stream device results back into a RoaringBitmap via the append path
    (RoaringArray.append, RoaringArray.java:111), re-compressing each chunk."""
    with tracing.op_timer("store.unpack_to_bitmap"):
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


# ---------------------------------------------------------------------------
# Resident pack cache
# ---------------------------------------------------------------------------


def pack_groups_with_provenance(
    bitmaps: Sequence[RoaringBitmap], keys_filter: Optional[set] = None, device=None
) -> Tuple[PackedGroups, Dict[Tuple[int, int], int]]:
    """``pack_groups(group_by_key(...))`` plus the row provenance the delta
    repack needs: ``{(bitmap_index, chunk_key): packed_row}``. Row order
    matches pack_groups exactly — rows sorted by group key, and within a
    group in bitmap order (the group_by_key append order)."""
    packed = pack_groups(group_by_key(bitmaps, keys_filter=keys_filter), device)
    with _timeline.stage(
        _PACK_STAGE_SECONDS, "provenance", "pack.provenance", cat="pack",
        rows=packed.n_rows,
    ):
        pos = {int(k): int(off) for k, off in zip(packed.group_keys, packed.group_offsets[:-1])}
        row_map: Dict[Tuple[int, int], int] = {}
        for bi, bm in enumerate(bitmaps):
            for k in bm.high_low_container.keys:
                if keys_filter is not None and k not in keys_filter:
                    continue
                row_map[(bi, k)] = pos[k]
                pos[k] += 1
    return packed, row_map


class _PackEntry:
    __slots__ = ("key", "kind", "value", "nbytes", "pins", "fps", "row_map", "refs")

    def __init__(self, key, kind, value, nbytes, fps=None, row_map=None, refs=()):
        self.key = key
        self.kind = kind
        self.value = value
        self.nbytes = int(nbytes)
        self.pins = 0           # pin refcount: >0 exempts from eviction
        self.fps = fps          # agg entries: fingerprints at pack time
        self.row_map = row_map  # agg entries: (bitmap_idx, key) -> row
        # container arrays behind ("static", id) fingerprints: held so the
        # id cannot be recycled by GC while the entry is resident
        self.refs = refs


def _fp_ident(fp: tuple):
    """The mutation-invariant part of a fingerprint: the array generation
    for (gen, version) fingerprints; static fingerprints never mutate, so
    the whole fingerprint is the identity (tagged to avoid an int id()
    colliding with a generation int)."""
    if fp[0] == "static":
        return ("s",) + fp[1:]
    return ("g", fp[0])


def _walk_fingerprints(bitmaps) -> Tuple[tuple, tuple]:
    """ONE pass over the working set producing ``(fps, idents)``, with the
    fingerprint tuples cached on each container array (invalidated per
    version bump) and the identity tuples cached for the array's lifetime:
    a warm lookup allocates nothing per bitmap."""
    fps: List[tuple] = []
    idents: List[tuple] = []
    fps_append, idents_append = fps.append, idents.append
    for bm in bitmaps:
        hlc = bm.high_low_container
        fp = getattr(hlc, "_fp", None)
        if fp is None:
            gen = getattr(hlc, "_gen", None)
            if gen is None:  # static (mapped/immutable): never mutates
                fp = ("static", id(hlc))
                fps_append(fp)
                idents_append(("s",) + fp[1:])
                continue
            fp = (gen, hlc._version)
            try:
                hlc._fp = fp
            except AttributeError:  # foreign mutable hlc without the slot
                fps_append(fp)
                idents_append(("g", gen))
                continue
        ident = getattr(hlc, "_fp_ident", None)
        if ident is None:
            ident = ("g", hlc._gen)
            try:
                hlc._fp_ident = ident
            except AttributeError:
                pass
        fps_append(fp)
        idents_append(ident)
    return tuple(fps), tuple(idents)


def static_fp_refs(bitmaps: Sequence[RoaringBitmap]) -> tuple:
    """The container arrays of operands with ("static", id) fingerprints —
    cache entries hold these so the ids stay live (see _PackEntry.refs)."""
    return tuple(
        bm.high_low_container for bm in bitmaps if bm.fingerprint()[0] == "static"
    )


def _repack_estimate_s(kind: str) -> Optional[float]:
    """The residency authority's learned re-pack cost for ``kind``: None
    until evict-regret traffic taught the curve."""
    from ..cost import residency as _residency

    return _residency.MODEL.repack_estimate(kind)


def _readmit_estimate_s(kind: str) -> Optional[float]:
    """The residency authority's learned mmap re-admit cost for ``kind``
    (the mapped rung): None until ``durable.readmit`` traffic taught the
    curve."""
    from ..cost import residency as _residency

    return _residency.MODEL.readmit_estimate(kind)


# The durable tier's demotion probe: installed once a persisted epoch
# artifact exists, it answers whether an evicted entry of ``kind`` stays
# re-admittable from the epoch map. With a probe answering True, an
# eviction demotes to the mapped rung (device bytes freed, the payload one
# zero-copy readmit away) instead of discarding. None: every eviction
# discards.
_DEMOTE_PROBE = None


def set_demotion_probe(probe) -> None:
    """Install (or clear with ``None``) the mapped-rung demotion probe,
    ``probe(kind) -> bool``. ``durable/store.py`` installs it after its
    first completed persist."""
    global _DEMOTE_PROBE
    _DEMOTE_PROBE = probe


DEFAULT_HOST_BUDGET = 2 << 30


def default_budget(device: torch.device) -> int:
    """The byte budget a cache takes when neither ``max_bytes`` nor
    ``RB_TPU_PACK_CACHE_BYTES`` sets one: a quarter of the card's memory on
    a CUDA device (the census working set alone is 2.52 GB of flat rows
    plus a 2.54 GB padded block), 2 GiB on the CPU."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory // 4
    return DEFAULT_HOST_BUDGET


def _value_device(value) -> torch.device:
    """The device an entry's value lives on (its first packed working set
    or tensor), which decides the default budget."""
    parts = value if isinstance(value, tuple) else (value,)
    for p in parts:
        if isinstance(p, PackedGroups):
            return p.device
        if isinstance(p, torch.Tensor):
            return p.device
    return torch.device("cpu")


class PackCache:
    """Process-wide device-resident working-set cache.

    Packed working sets — ``PackedGroups`` with their flat/padded/bucketed
    device layouts, plus the BSI slice tensors and the query kernels'
    packs — stay resident across calls, keyed by the participating
    bitmaps' ``fingerprint()`` tuples and the device. A byte-budget LRU
    evicts cold entries; ``close()`` frees everything. An entry weighs its
    flat rows from admission, plus each derived layout as it is built (the
    residency callback).

    Invalidation is incremental for aggregation entries: when the same
    bitmaps return with moved versions (same generations), the per-key
    dirty sets from ``RoaringArray.dirty_keys_since`` identify exactly
    which packed rows changed, and ``PackedGroups.apply_delta`` re-packs
    and writes only those rows instead of rebuilding the working set.
    Structural changes — chunk keys added/removed, an AND
    key-intersection that grew or shrank, wholesale mutations — take a
    full repack.

    The budget: ``max_bytes``, else ``RB_TPU_PACK_CACHE_BYTES`` (0
    disables caching), else :func:`default_budget` of the first stored
    entry's device, resolved at that first store.

    Thread-safe: one lock around the entry map; full packs build outside
    the lock (concurrent builders race benignly, first store wins), delta
    repacks run under it. The lock is re-entrant because the delta path
    drops derived layouts under it and their residency callbacks settle
    the byte accounting.

    A cache holds no reference cycle (the residency callbacks reach it
    through a weak reference), so a dropped cache is freed at once and
    its ``__del__`` settles its share of the resident-bytes gauge."""

    _EVICTED_SEQS_CAP = 256

    def __init__(self, max_bytes: Optional[int] = None):
        if max_bytes is None and os.environ.get("RB_TPU_PACK_CACHE_BYTES"):
            max_bytes = int(os.environ["RB_TPU_PACK_CACHE_BYTES"])
        self._lock = threading.RLock()
        with _ALL_CACHES_LOCK:
            _ALL_CACHES.add(self)
        # None until the first store resolves the default budget
        self.max_bytes: Optional[int] = None if max_bytes is None else int(max_bytes)  # guarded-by: self._lock
        self._entries: "OrderedDict[tuple, _PackEntry]" = OrderedDict()  # guarded-by: self._lock
        self._ident: Dict[tuple, tuple] = {}  # guarded-by: self._lock
        self._bytes = 0  # guarded-by: self._lock
        self.hits = 0  # guarded-by: self._lock
        self.misses = 0  # guarded-by: self._lock
        self.delta_rows = 0  # guarded-by: self._lock
        self.evictions = 0  # guarded-by: self._lock
        # per-kind hit/miss counts ("agg", "andnot", "threshold", "bsi")
        self._kinds: Dict[str, List[int]] = {}  # guarded-by: self._lock
        # recently evicted working sets -> the eviction's decision serial:
        # a miss that re-packs a remembered eviction joins it with the
        # re-pack wall as measured regret (bounded ring, oldest forgotten)
        self._evicted_seqs: "OrderedDict[tuple, int]" = OrderedDict()  # guarded-by: self._lock
        # per-THREAD route of the most recent get_packed: the epoch flip's
        # lineage needs per-working-set delta-vs-full evidence, and a diff
        # of the global counters would race every concurrent cache user;
        # thread-local needs no lock
        self._route_tls = threading.local()

    def __del__(self):
        # a dropped cache settles its share of the process-wide gauge
        try:
            self.close()
        except Exception:  # rb-ok: exception-hygiene -- interpreter teardown: the registry may be gone
            pass

    # -- public API --------------------------------------------------------

    def _disabled(self) -> bool:
        return self.max_bytes is not None and self.max_bytes <= 0

    def _count(self, kind: str, hit: bool) -> None:
        # caller holds self._lock; the registry counters are the same
        # numbers, labeled by kind
        if hit:
            self.hits += 1
            _PACK_HITS.inc(1, (kind,))
        else:
            self.misses += 1
            _PACK_MISSES.inc(1, (kind,))
        self._kinds.setdefault(kind, [0, 0])[0 if hit else 1] += 1

    def get_packed(
        self, bitmaps: Sequence[RoaringBitmap], keys_filter: Optional[set] = None,
        device=None,
    ) -> PackedGroups:
        """The resident pack for this working set on ``device``, delta-
        refreshed or rebuilt as needed. ``keys_filter``, when given, must be
        the AND key-intersection of ``bitmaps`` (the workShyAnd pre-filter)
        — the delta validator relies on that to detect intersection
        changes."""
        bitmaps = list(bitmaps)
        device = resolve_device(device)
        marker = "all" if keys_filter is None else "and"
        self._route_tls.route = None  # set on every exit path below
        with _timeline.stage(
            _PACK_STAGE_SECONDS, "fingerprints", "pack.fingerprints",
            cat="pack", operands=len(bitmaps),
        ):
            fps, idents = _walk_fingerprints(bitmaps)
        if self._disabled():  # always a fresh uncached pack
            with self._lock:
                self._count("agg", False)
            self._route_tls.route = ("disabled", 0)
            return pack_groups(group_by_key(bitmaps, keys_filter=keys_filter), device)
        key = ("agg", marker, str(device), fps)
        ident = ("agg", marker, str(device), idents)
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                self._entries.move_to_end(key)
                self._count("agg", True)
                _timeline.instant("pack_cache.hit", "cache", kind="agg", bytes=e.nbytes)
                self._route_tls.route = ("hit", 0)
                return e.value
            old_key = self._ident.get(ident)
            e = None if old_key is None else self._entries.get(old_key)
            if e is not None:
                rows = self._try_delta(e, bitmaps, keys_filter, fps)
                if rows is not None:
                    del self._entries[old_key]
                    e.key = key
                    e.fps = fps
                    self._entries[key] = e
                    self._ident[ident] = key
                    self._count("agg", True)
                    self.delta_rows += len(rows)
                    _timeline.instant(
                        "pack_cache.delta_hit", "cache", kind="agg", rows=len(rows)
                    )
                    if rows:
                        _PACK_DELTA_ROWS.inc(len(rows), ("agg",))
                    self._route_tls.route = ("delta", len(rows))
                    return e.value
        # full repack outside the lock (a racing thread packing the same
        # key is benign — first store wins)
        _timeline.instant("pack_cache.miss", "cache", kind="agg")
        with self._lock:
            evict_seq = self._evicted_seqs.pop(ident, None)
        t0 = _time.perf_counter()
        packed, row_map = pack_groups_with_provenance(bitmaps, keys_filter, device)
        if evict_seq is not None:
            # the evicted working set came back while its eviction is still
            # remembered: the re-pack wall is the eviction's measured regret
            repack_s = _time.perf_counter() - t0
            _outcomes.resolve(
                evict_seq, "pack_cache.evict", repack_s, engine="repack",
                regret_s=repack_s,
            )
        with self._lock:
            self._count("agg", False)
        entry = _PackEntry(
            key, "agg", packed, packed.words_nbytes, fps=fps, row_map=row_map,
            refs=static_fp_refs(bitmaps),
        )
        self._route_tls.route = ("full", 0)
        return self._store(entry, ident=ident).value

    def last_route(self) -> Optional[tuple]:
        """``(route, delta_rows)`` of THIS thread's most recent
        :meth:`get_packed` — ``route`` is ``"hit"`` | ``"delta"`` |
        ``"full"`` | ``"disabled"``, ``delta_rows`` is nonzero only on the
        delta route. Thread-local: the epoch flip classifies each
        working-set refresh for its lineage record. ``None`` before any
        call on this thread."""
        return getattr(self._route_tls, "route", None)

    def get_or_build(self, key: tuple, build: Callable[[], tuple], refs: tuple = ()):
        """Generic resident entry (BSI slice tensors, query-kernel packs):
        ``key`` must start with the kind marker and embed every input
        fingerprint and the device; ``build()`` returns ``(value,
        nbytes)``. Exact-key hit or full rebuild — no delta path. ``refs``
        pins the container arrays behind any ("static", id) fingerprints in
        the key (see ``static_fp_refs``)."""
        kind = str(key[0])
        if self._disabled():
            with self._lock:
                self._count(kind, False)
            return build()[0]
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                self._entries.move_to_end(key)
                self._count(kind, True)
                _timeline.instant("pack_cache.hit", "cache", kind=kind, bytes=e.nbytes)
                return e.value
        _timeline.instant("pack_cache.miss", "cache", kind=kind)
        with self._lock:
            evict_seq = self._evicted_seqs.pop(key, None)
        t0 = _time.perf_counter()
        value, nbytes = build()
        if evict_seq is not None:
            # re-build of a remembered eviction: measured regret
            rebuild_s = _time.perf_counter() - t0
            _outcomes.resolve(
                evict_seq, "pack_cache.evict", rebuild_s, engine="rebuild",
                regret_s=rebuild_s,
            )
        with self._lock:
            self._count(kind, False)
        return self._store(_PackEntry(key, kind, value, nbytes, refs=refs)).value

    def pin_packed(
        self, bitmaps: Sequence[RoaringBitmap], keys_filter: Optional[set] = None,
        device=None,
    ) -> PackedGroups:
        """Get (building if needed) and pin this working set's pack: a
        pinned entry is never evicted. Pins are a refcount — every
        ``pin_packed`` needs a matching :meth:`unpin_packed`; ``close``
        releases everything regardless."""
        packed = self.get_packed(bitmaps, keys_filter, device)
        with self._lock:
            e = self._agg_entry(bitmaps, keys_filter, device)
            if e is not None:
                e.pins += 1
                _timeline.instant("pack_cache.pin", "cache", kind="agg", pins=e.pins)
        return packed

    def unpin_packed(
        self, bitmaps: Sequence[RoaringBitmap], keys_filter: Optional[set] = None,
        device=None,
    ) -> None:
        with self._lock:
            e = self._agg_entry(bitmaps, keys_filter, device)
            if e is not None:
                e.pins = max(0, e.pins - 1)
                _timeline.instant("pack_cache.unpin", "cache", kind="agg", pins=e.pins)
                if e.pins == 0:
                    self._evict_over_budget()

    def _agg_entry(self, bitmaps, keys_filter, device=None) -> Optional[_PackEntry]:
        """This working set's entry by exact fingerprints OR by identity
        (generations): pin / unpin must find the entry even after the
        bitmaps mutated, or a pin would leak forever. Caller holds
        self._lock."""
        marker = "all" if keys_filter is None else "and"
        dev_s = str(resolve_device(device))
        fps = tuple(bm.fingerprint() for bm in bitmaps)
        e = self._entries.get(("agg", marker, dev_s, fps))
        if e is not None:
            return e
        ident = ("agg", marker, dev_s, tuple(_fp_ident(fp) for fp in fps))
        key = self._ident.get(ident)
        return self._entries.get(key) if key is not None else None

    def discard(self, key: tuple) -> None:
        """Drop one entry by exact key: for builders that discover after
        the store that the pack cannot serve their device path (threshold's
        too-skewed-to-pad CPU fold) and must not leave a useless resident
        entry squatting on the budget."""
        with self._lock:
            e = self._entries.get(key)
            if e is not None and e.kind == "agg":
                ident = self._agg_ident(e)
                if self._ident.get(ident) == key:
                    del self._ident[ident]
            self._drop(key)

    def close(self) -> None:
        """Release every resident entry (pinned included); the cache stays
        usable and refills on next use."""
        with self._lock:
            for e in self._entries.values():
                self._release(e)
            self._entries.clear()
            self._ident.clear()
            self._bytes = 0

    def configure(self, max_bytes: int) -> None:
        """Set the byte budget and evict down to it. ``max_bytes <= 0``
        disables caching and releases every resident entry."""
        with self._lock:
            self.max_bytes = int(max_bytes)
            if self.max_bytes <= 0:
                self.close()
            else:
                self._evict_over_budget()

    def stats(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "delta_rows": self.delta_rows,
                "evictions": self.evictions,
                "entries": len(self._entries),
                "bytes": self._bytes,
                "pinned": sum(1 for e in self._entries.values() if e.pins),
                "max_bytes": self.max_bytes,
                "kinds": {k: {"hits": h, "misses": m} for k, (h, m) in self._kinds.items()},
            }

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def resident_bytes_for(self, fps) -> int:
        """Resident bytes attributable to a working set: the sum of entry
        bytes whose key (or recorded fingerprint tuple) embeds any of the
        given leaf ``fingerprint()`` tuples. An entry serving several
        overlapping working sets is charged to each caller — the serving
        tier's per-tenant byte shares are shares, not a partition, so
        they may sum past the resident total."""
        want = set(fps)
        if not want:
            return 0
        total = 0
        with self._lock:
            for e in self._entries.values():
                if e.fps and any(fp in want for fp in e.fps):
                    total += e.nbytes
                    continue
                for el in e.key:
                    if el in want or (
                        isinstance(el, tuple) and any(fp in want for fp in el)
                    ):
                        total += e.nbytes
                        break
        return total

    def __contains__(self, key: tuple) -> bool:
        with self._lock:
            return key in self._entries

    # -- internals ---------------------------------------------------------

    @staticmethod
    def _agg_ident(e: _PackEntry) -> tuple:
        return ("agg", e.key[1], e.key[2], tuple(_fp_ident(fp) for fp in e.fps))

    def _store(self, entry: _PackEntry, ident: Optional[tuple] = None) -> _PackEntry:
        with self._lock:
            if self.max_bytes is None:
                self.max_bytes = default_budget(_value_device(entry.value))
        try:
            # budget-pressure fault site: pressure at admission spills cold
            # entries and serves this working set uncached, on the device
            # as before — a caching choice, not a move to the CPU
            _faults.fault_point("pack_cache.budget")
        except Exception as e:
            if _rerrors.classify(e) == _rerrors.FATAL:
                raise
            with self._lock:
                self._evict_to(self.max_bytes // 2)
            _ladder.LADDER.note_degrade("pack_cache.budget", "resident", "uncached", e)
            _timeline.instant(
                "pack_cache.pressure", "cache", kind=entry.kind, bytes=entry.nbytes,
            )
            _decisions.record_decision(
                "pack_cache.admit", "spill-and-serve-uncached",
                kind=entry.kind, bytes=entry.nbytes,
                target_bytes=self.max_bytes // 2,
            )
            return entry  # consumer-owned: never marked cache-held
        with self._lock:
            existing = self._entries.get(entry.key)
            if existing is not None:
                # a racing builder stored first; keep theirs, drop ours
                self._entries.move_to_end(entry.key)
                for pg in self._packed_parts(entry.value):
                    pg.close()
                return existing
            if ident is not None:
                superseded = self._ident.pop(ident, None)
                if superseded is not None and superseded in self._entries:
                    self._drop(superseded)
                self._ident[ident] = entry.key
            for pg in self._packed_parts(entry.value):
                pg._cache_held = True
                pg._resident_cb = self._resident_cb(entry)
            self._entries[entry.key] = entry
            self._bytes += entry.nbytes
            _PACK_RESIDENT.inc(entry.nbytes, (entry.kind,))
            _decisions.record_decision(
                "pack_cache.admit", "resident", kind=entry.kind,
                bytes=entry.nbytes, cache_bytes=self._bytes,
            )
            self._evict_over_budget()
            return entry

    @staticmethod
    def _packed_parts(value):
        if isinstance(value, PackedGroups):
            return (value,)
        if isinstance(value, tuple):
            return tuple(p for p in value if isinstance(p, PackedGroups))
        return ()

    def _resident_cb(self, entry: _PackEntry):
        """Byte-accounting callback for a cache-owned PackedGroups: derived
        device layouts (padded blocks, buckets) are built lazily AFTER the
        entry is stored, so their bytes must flow into the entry's weight
        and the budget. The callback holds the cache weakly: the entry's
        working set is reachable from the cache, and a strong reference
        back would make a reference cycle that only the cyclic collector
        frees (a dropped secondary cache would then keep its bytes in the
        process-wide gauge until a collection ran)."""
        cache_ref = weakref.ref(self)

        def cb(delta: int) -> None:
            cache = cache_ref()
            if cache is None:
                return
            with cache._lock:
                if cache._entries.get(entry.key) is not entry:
                    return  # raced with eviction: no longer resident
                entry.nbytes += delta
                cache._bytes += delta
                _PACK_RESIDENT.inc(delta, (entry.kind,))
                if delta > 0:
                    cache._evict_over_budget()

        return cb

    def _drop(self, key: tuple) -> None:
        # caller holds self._lock
        e = self._entries.pop(key, None)
        if e is None:
            return
        self._bytes -= e.nbytes
        self._release(e)

    def _release(self, e: _PackEntry) -> None:
        # caller holds self._lock; settles the resident gauge, detaches the
        # residency callback FIRST (e.nbytes already includes the derived
        # layouts, so close() reporting them again would double-subtract),
        # then really closes
        _PACK_RESIDENT.dec(e.nbytes, (e.kind,))
        for pg in self._packed_parts(e.value):
            pg._resident_cb = None
            pg._cache_held = False
            pg.close()

    def _evict_over_budget(self) -> None:
        self._evict_to(self.max_bytes)

    def _evict_to(self, target: int) -> None:
        # caller holds self._lock; LRU order, pinned entries skipped. At
        # least one UNPINNED entry always survives: a single working set
        # larger than the whole budget would otherwise thrash store->evict
        # on every call, and counting pinned entries toward that survivor
        # would bring the thrash back once a pinned index fills the budget.
        if target is None or self._bytes <= target:
            return
        unpinned = sum(1 for e in self._entries.values() if not e.pins)
        for key in list(self._entries):
            if self._bytes <= target or unpinned <= 1:
                break
            e = self._entries[key]
            if e.pins:
                continue
            unpinned -= 1
            del self._entries[key]
            self._bytes -= e.nbytes
            self.evictions += 1
            _PACK_EVICTED_BYTES.inc(e.nbytes, (e.kind,))
            # with a durable epoch artifact on disk the evicted bytes demote
            # to the mapped rung (re-admittable from the map at the readmit
            # curve's price) instead of discarding
            probe = _DEMOTE_PROBE
            mapped = False
            if probe is not None:
                try:
                    mapped = bool(probe(e.kind))
                except Exception:  # rb-ok: exception-hygiene -- a broken probe must not turn an eviction into a failure: the entry is discarded, as in the JAX package
                    mapped = False
            rung = "mapped" if mapped else "discard"
            _DEMOTE_TOTAL.inc(1, (rung,))
            _timeline.instant(
                "pack_cache.evict", "cache", kind=e.kind, bytes=e.nbytes, rung=rung,
            )
            # the residency authority's learned re-pack cost prices this
            # eviction: the evict-regret join then scores the pricing
            # (predicted vs measured re-pack wall)
            evict_inputs = {"kind": e.kind, "bytes": e.nbytes,
                            "target_bytes": target, "rung": rung}
            est_repack_s = _repack_estimate_s(e.kind)
            if est_repack_s:
                evict_inputs["est_us"] = {
                    "repack": round(est_repack_s * 1e6, 1),
                    "rebuild": round(est_repack_s * 1e6, 1),
                }
            if mapped:
                # the demotion's priced return path: the learned readmit
                # cost (None until durable.readmit traffic taught it)
                est_readmit_s = _readmit_estimate_s(e.kind)
                if est_readmit_s:
                    evict_inputs.setdefault("est_us", {})["readmit"] = round(
                        est_readmit_s * 1e6, 1
                    )
            seq = _decisions.record_decision(
                "pack_cache.evict", "demote-mapped" if mapped else "lru",
                outcome=True, **evict_inputs,
            )
            ident = self._agg_ident(e) if e.kind == "agg" else None
            if ident is not None and self._ident.get(ident) == key:
                del self._ident[ident]
            if seq is not None:
                # remember the eviction by its identity (agg: the
                # generations, so a delta-mutated return still matches)
                # for the miss-side regret join
                self._evicted_seqs[ident if ident is not None else key] = seq
                while len(self._evicted_seqs) > self._EVICTED_SEQS_CAP:
                    self._evicted_seqs.popitem(last=False)
            self._release(e)

    def _try_delta(self, e, bitmaps, keys_filter, new_fps):
        """Validate and apply an incremental repack of entry ``e`` for the
        new fingerprints; returns the re-packed row list, or None when only
        a full repack is sound (gen changed, wholesale mutation, or any
        structural change to the group layout). Caller holds self._lock."""
        if len(new_fps) != len(e.fps):
            return None
        packed: PackedGroups = e.value
        # cheap pre-pass: a generation change or a wholesale mutation
        # already forces the full repack — decide from the version counters
        # before paying the per-key dirty scan
        changed = []
        for bi, (old_fp, new_fp) in enumerate(zip(e.fps, new_fps)):
            if old_fp == new_fp:
                continue
            if old_fp[0] != new_fp[0]:  # generation changed (or static id)
                return None
            if bitmaps[bi].high_low_container.wholesale_since(old_fp[1]):
                return None
            changed.append((bi, old_fp))
        with _timeline.stage(
            _DELTA_STAGE_SECONDS, "dirty_scan", "delta.dirty_scan", cat="delta",
            bitmaps=len(changed),
        ):
            dirty_rows = self._dirty_rows(e, bitmaps, keys_filter, changed)
        if dirty_rows is None:
            return None
        if not dirty_rows:
            return ()
        rows = sorted(dirty_rows)
        with _timeline.stage(
            _DELTA_STAGE_SECONDS, "host_rows", "delta.host_rows", cat="delta", rows=len(rows),
        ):
            containers = [
                bitmaps[bi].high_low_container.get_container(k)
                for bi, k in (dirty_rows[r] for r in rows)
            ]
            host_rows = RowPayload.from_containers(containers).expand_host().view(np.int32)
        packed.apply_delta(np.asarray(rows, dtype=np.int64), host_rows)
        return rows


    @staticmethod
    def _dirty_rows(e, bitmaps, keys_filter, changed) -> Optional[Dict[int, Tuple[int, int]]]:
        """``{packed_row: (bitmap_index, key)}`` of the rows the changed
        bitmaps dirtied, or None when only a full repack is sound (a
        container added or removed, the AND intersection moved, or an
        unattributed mutation)."""
        packed_keys = {int(k) for k in e.value.group_keys}
        dirty_rows: Dict[int, Tuple[int, int]] = {}
        for bi, old_fp in changed:
            hlc = bitmaps[bi].high_low_container
            dirty = hlc.dirty_keys_since(old_fp[1])
            if dirty is None:  # wholesale / unattributed mutation
                return None
            for k in dirty:
                present_now = hlc.get_index(k) >= 0
                if keys_filter is not None:  # "and": filter = key intersection
                    if k in packed_keys:
                        if not present_now:
                            return None  # intersection shrank
                        dirty_rows[e.row_map[(bi, k)]] = (bi, k)
                    elif present_now and all(
                        b.high_low_container.get_index(k) >= 0 for b in bitmaps
                    ):
                        return None  # intersection grew
                else:
                    was_packed = (bi, k) in e.row_map
                    if was_packed != present_now:
                        return None  # container added or removed
                    if present_now:
                        dirty_rows[e.row_map[(bi, k)]] = (bi, k)
        return dirty_rows


# Every live cache, for the reconciliation: the resident-bytes gauge is
# process-wide while the byte ledgers are per cache, so the ledger side
# sums over every live cache (a dropped one settles its share through
# __del__ -> close). The lock covers add against iteration.
_ALL_CACHES_LOCK = threading.Lock()
_ALL_CACHES: "weakref.WeakSet[PackCache]" = weakref.WeakSet()  # guarded-by: _ALL_CACHES_LOCK

# The process-wide cache every routed consumer shares (aggregation engines,
# BSI device packs, query kernels) — ONE eviction budget for all of them.
PACK_CACHE = PackCache()


def packed_for(
    bitmaps: Sequence[RoaringBitmap], keys_filter: Optional[set] = None, device=None
) -> PackedGroups:
    """The cache-routed replacement for ``pack_groups(group_by_key(...))``
    on device paths: warm working sets come back resident (zero host work),
    mutated ones delta-repack O(changed rows)."""
    return PACK_CACHE.get_packed(bitmaps, keys_filter, device)


def _pending_bytes(value) -> int:
    """The flat rows an entry weighs but has not built yet: a working set
    is admitted with its flat rows' weight, and the rows are expanded on
    the device at first touch (or never, when that expansion failed)."""
    return sum(
        pg.words_nbytes for pg in PackCache._packed_parts(value)
        if pg._device_words is None
    )


def _reconcile_sides():
    """``(ledger bytes, entries, entry-sum bytes, gauge bytes, {CUDA
    device: [bytes held, bytes pending]})`` over every live cache."""
    lb = en = es = 0
    on_cuda: Dict[torch.device, List[int]] = {}
    with _ALL_CACHES_LOCK:
        caches = list(_ALL_CACHES)
    for cache in caches:
        with cache._lock:
            lb += cache._bytes
            en += len(cache._entries)
            for e in cache._entries.values():
                es += e.nbytes
                d = _value_device(e.value)
                if d.type == "cuda":
                    pending = _pending_bytes(e.value)
                    side = on_cuda.setdefault(d, [0, 0])
                    side[0] += e.nbytes - pending
                    side[1] += pending
    gauge = sum(_PACK_RESIDENT.series().values())
    return lb, en, es, gauge, on_cuda


def hbm_reconciliation() -> dict:
    """Reconcile the pack caches' resident-bytes accounting against
    independent ground truth and export the drift as
    ``rb_tpu_hbm_accounting_drift_bytes{source}``:

    * ``ledger`` — the ``rb_tpu_pack_cache_resident_bytes`` gauge total
      minus the caches' own entry-byte ledgers (every live cache). Both
      move in the same locked code paths, so a nonzero drift is an
      accounting bug;
    * ``device`` — the bytes of the entries held on CUDA devices minus
      ``torch.cuda.memory_allocated`` of those devices. The card holds
      more than the pack cache (payloads in flight, scratch, results),
      so this drift is expected to be negative; a positive drift means
      the cache accounts for memory the allocator does not hold. An entry
      is weighed by its flat rows from admission, but builds them at
      first touch: rows not built yet (``device_pending_bytes``) are left
      out of the held side, so a working set between admission and its
      expansion, or whose expansion failed, shows as pending, not as
      drift. The device side is read only when CUDA is already
      initialized in this process and an entry lives on a card: a
      monitoring read never initializes CUDA or probes for a device, and
      with no entry on a card the report has no device keys.

    Two consecutive equal reads of the ledger side make one report, so an
    admission or eviction between the ledger scan and the gauge read
    cannot show as drift. Returns the report."""
    prev = _reconcile_sides()
    for _ in range(4):
        cur = _reconcile_sides()
        if cur == prev:
            break
        prev = cur
    ledger_bytes, entries, entry_sum, gauge_bytes, on_cuda = prev
    ledger_drift = int(gauge_bytes - ledger_bytes)
    _HBM_DRIFT.set(ledger_drift, ("ledger",))
    report = {
        "gauge_bytes": int(gauge_bytes),
        "ledger_bytes": int(ledger_bytes),
        "entry_sum_bytes": int(entry_sum),
        "entries": entries,
        "ledger_drift_bytes": ledger_drift,
    }
    if on_cuda and torch.cuda.is_initialized():
        in_use = {str(d): int(torch.cuda.memory_allocated(d)) for d in on_cuda}
        resident = int(sum(held for held, _pending in on_cuda.values()))
        device_drift = resident - sum(in_use.values())
        _HBM_DRIFT.set(device_drift, ("device",))
        report.update(
            device_resident_bytes=resident,
            device_pending_bytes=int(sum(p for _held, p in on_cuda.values())),
            device_bytes_in_use=int(sum(in_use.values())),
            device_bytes_by_device=in_use,
            device_drift_bytes=int(device_drift),
        )
    return report
