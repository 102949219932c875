"""L5' bit-sliced index (BSI) on PyTorch and CUDA.

Counterpart of the JAX package's ``models/bsi.py``; the logical model
matches BitmapSliceIndex (bsi/.../BitmapSliceIndex.java:22, vertical layout
:45-60): ``ebm`` = existence bitmap over column ids, ``slices[i]`` = bitmap
of columns whose value has bit i set. Queries are the O'Neil compare
(RoaringBitmapSliceIndex.java:432-469: one pass high->low maintaining
GT/LT/EQ bitmaps), with the min/max short-circuit (:515-578), ``sum``
(:581-592), element-wise ``add`` with ripple carry (:66-95) and disjoint
``merge`` (:379).

Device path: the slices are packed once into a dense int32 ``[S, K, 2048]``
tensor (slices x key chunks of the ebm x words) plus the ``[K, 2048]`` ebm
words, built on the host and sent to the card in one copy, and kept on the
index under the fingerprints of its member bitmaps and the device (any
mutation re-keys it). A compare is then ONE launch of the hand-written
``rb_oneil_compare`` kernel (``ops/kernels.oneil_compare``) — walk, per-op
epilogue and per-chunk popcount; RANGE runs both walks in the same launch —
and ``compare_cardinality_many`` answers a whole batch of thresholds in one
count-only launch. ``sum`` is one masked ``rb_popcount_rows`` launch.

Resident found sets: ``compare_resident`` runs the same verdicts and the
same launch as ``compare`` and returns a :class:`ResidentSet`, the result's
words and per-chunk counts left on the device. ``compare``,
``compare_resident``, ``compare_cardinality`` and ``sum`` take one as their
``found_set``: on the same chunk-key layout its words are the kernel's
``fixed`` or mask operand as they lie, on another they are remapped by key
on the device. A chain of predicates ending in ``sum`` so brings nothing to
the host but the sum's counts. Spans: ``bsi.compare`` (``compare`` and
``compare_resident``), ``bsi.compare_cardinality``, ``bsi.sum``, and below
them ``bsi.found.marshal`` (a bitmap found set put on the pack's layout on
the host) and ``bsi.found.resident`` (a resident one taken up); the counter
``rb_tpu_bsi_found_total{form}`` counts the found sets the four entry
points were given, by form (``none``, ``bitmap``, ``resident``).

``mode="auto"`` picks the device path by index size only
(``bit_count() * container count >= config.min_device_cells``), never by
probing for a card; it runs on ``config.device`` (default ``"cuda"``), and
``"cuda"`` without a card raises ``TierUnavailable``. ``config.device =
"cpu"`` runs the same device path on CPU tensors with the kernels' plain
versions.

With ``config.mesh`` set (``parallel/sharding.make_mesh()``), the device
compare, count, sum and batched counts run sharded over the mesh: the key
chunk axis is padded with empty chunks to a multiple of the
``containers`` size and cut over it, the word axis over ``words``
(:func:`_pad_chunk_axis`, ``sharding.shard_rows``), and each rank runs the
same kernels on its block. Every rank of the mesh calls the query with the
same index and gets the whole answer back.

Serialization: the reference's ByteBuffer layout (RoaringBitmapSliceIndex
.serialize(ByteBuffer) :240-255): int32 minValue, int32 maxValue, byte
runOptimized, ebm, int32 sliceCount, slices — little-endian. The fields are
Java ints and the values here are non-negative up to 2^32 - 1, so a min or
max at or above 2^31 is written as its two's-complement int32 bits (the int
Java holds for those 32 bits) and a negative field reads back as that value
plus 2^32. (The JAX package's ``struct.pack("<iib")`` raises on such an
index instead.) A min or max past 32 bits does not fit the format and
raises.
"""

from __future__ import annotations

import enum
import struct
import threading
from collections import OrderedDict
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from .. import observe as _observe
from ..device import resolve_device
from ..observe import spans as _spans
from ..ops import device as dev
from ..ops import kernels
from ..parallel import store
from ..serialization import InvalidRoaringFormat, read_into
from .roaring import RoaringBitmap

_FOUND_TOTAL = _observe.counter(
    _observe.BSI_FOUND_TOTAL,
    "Found sets given to the BSI entry points, by form (none | bitmap | resident)",
    ("form",),
)


class Operation(enum.Enum):
    """Compare ops (BitmapSliceIndex.java:23-38)."""

    EQ = "EQ"
    NEQ = "NEQ"
    LE = "LE"
    LT = "LT"
    GE = "GE"
    GT = "GT"
    RANGE = "RANGE"


class config:
    """Dispatcher knobs, as in ``parallel/aggregation.config``."""

    mode: str = "auto"  # 'auto' | 'cpu' | 'device'
    # slices x key chunks below which the CPU path is taken in auto mode
    # (the 100M-row north star is ~49k cells)
    min_device_cells: int = 4096
    device: str = "cuda"  # where the device path runs: 'cuda' | 'cpu'
    # a DeviceMesh (parallel/sharding.make_mesh()): when set, the device
    # compare / count / sum / batched counts run sharded over it
    mesh = None


def min_max_verdict(op, start_or_value, end, mn, mx):
    """compareUsingMinMax (RoaringBitmapSliceIndex.java:515-578) as a pure
    symbol — 'all' | 'empty' | 'fixed' | None. 'fixed' = the raw fixed set
    for out-of-range NEQ (Java keeps found_set un-intersected there)."""
    v = start_or_value
    if op == Operation.LT:
        if v > mx:
            return "all"
        if v <= mn:
            return "empty"
    elif op == Operation.LE:
        if v >= mx:
            return "all"
        if v < mn:
            return "empty"
    elif op == Operation.GT:
        if v < mn:
            return "all"
        if v >= mx:
            return "empty"
    elif op == Operation.GE:
        if v <= mn:
            return "all"
        if v > mx:
            return "empty"
    elif op == Operation.EQ:
        if mn == mx and mn == v:
            return "all"
        if v < mn or v > mx:
            return "empty"
    elif op == Operation.NEQ:
        if mn == mx:
            return "empty" if mn == v else "all"
        if v < mn or v > mx:
            return "fixed"
    elif op == Operation.RANGE:
        if v <= mn and end >= mx:
            return "all"
        if v > mx or end < mn:
            return "empty"
    return None


def values_for_columns(cols: np.ndarray, slices, dtype=np.int64) -> np.ndarray:
    """Reassemble the stored value of each column from the slice bitmaps:
    one vectorized membership mask per slice, bits OR'd back together."""
    values = np.zeros(cols.size, dtype=dtype)
    for i, s in enumerate(slices):
        members = np.isin(cols, s.to_array(), assume_unique=True)
        values |= np.left_shift(members.astype(dtype), dtype(i))
    return values


def _bulk_get_values(index, cols: np.ndarray):
    """Bulk read: one ``contains_many`` membership pass per slice into an
    int64 accumulator. Above 63 slices the accumulator would wrap, so that
    domain falls back to exact per-column object-dtype reads."""
    exists = index.ebm.contains_many(cols)
    if index.bit_count() > 63:
        values = np.array(
            [index.get_value(int(c))[0] if e else 0 for c, e in zip(cols, exists)],
            dtype=object,
        )
        return values, exists
    values = np.zeros(cols.shape, dtype=np.int64)
    if not exists.any():
        return values, exists
    for i, s in enumerate(index.slices):
        values |= s.contains_many(cols).astype(np.int64) << i
    values[~exists] = 0
    return values, exists


def transpose_value_counts(cols: np.ndarray, slices, dtype=np.int64):
    """(distinct values, multiplicities) over the given columns — the body
    of transposeWithCount (BitSliceIndexBase.java:578)."""
    return np.unique(values_for_columns(cols, slices, dtype=dtype), return_counts=True)


def pack_header(min_value: int, max_value: int, run_optimized: bool) -> bytes:
    """The wire format's 9-byte header: min and max as int32 fields holding
    the values' 32 bits, and the run-optimized flag."""
    fields = []
    for v in (int(min_value), int(max_value)):
        if not 0 <= v < 1 << 32:
            raise ValueError(f"BSI min/max {v} does not fit the format's 32-bit fields")
        fields.append(v - (1 << 32) if v >= 1 << 31 else v)
    return struct.pack("<iib", fields[0], fields[1], 1 if run_optimized else 0)


def unpack_header(buf, offset: int = 0) -> Tuple[int, int, bool]:
    """``(min_value, max_value, run_optimized)`` from :func:`pack_header`'s
    bytes: a negative field is a value at or above 2^31."""
    min_v, max_v, ro = struct.unpack_from("<iib", buf, offset)
    return min_v % (1 << 32), max_v % (1 << 32), bool(ro)


def pack_slices(ebm_items, slice_items, device):
    """The device pack of a bit-sliced index from ``(key, container)``
    pairs — the ebm's, ascending, and one iterable per slice — whatever
    the key type: ``((keys, ebm_w, slices_w), nbytes)`` with int32 ``[K,
    2048]`` ebm words and the ``[S, K, 2048]`` slice tensor over the ebm's K
    keys, built on the host and sent to ``device`` in one copy. A slice
    container whose key the ebm lacks is left out (slice columns are
    always ebm columns)."""
    ebm_items = list(ebm_items)
    keys = [k for k, _ in ebm_items]
    kidx = {k: i for i, k in enumerate(keys)}
    s_count = len(slice_items)
    host = np.zeros((s_count + 1, len(keys), dev.DEVICE_WORDS), dtype=np.int32)
    for j, (_k, c) in enumerate(ebm_items):
        host[s_count, j] = store.container_words(c)
    for i, items in enumerate(slice_items):
        for k, c in items:
            j = kidx.get(k)
            if j is not None:
                host[i, j] = store.container_words(c)
    packed = torch.from_numpy(host).to(device)
    return (keys, packed[s_count], packed[:s_count]), host.nbytes


def found_words(keys, like: torch.Tensor, items) -> torch.Tensor:
    """A found set's ``(key, container)`` pairs marshalled onto a pack's
    key layout: int32 ``[K, 2048]`` on ``like``'s device."""
    host = np.zeros(tuple(like.shape), dtype=np.int32)
    kidx = {k: i for i, k in enumerate(keys)}
    for k, c in items:
        j = kidx.get(k)
        if j is not None:
            host[j] = store.container_words(c)
    return torch.from_numpy(host).to(like.device)


def _items(bm: RoaringBitmap):
    hlc = bm.high_low_container
    return zip(hlc.keys, hlc.containers)


def _bits_high_first(value: int, s_count: int) -> List[int]:
    """The predicate's bits for the slice walk, highest slice first."""
    return [(value >> i) & 1 for i in range(s_count - 1, -1, -1)]


# One tuple object for each chunk-key layout packed lately: the columns of
# one table share their ebm's keys, so a resident found set meets the next
# column's pack on the very same object and its layout check is an identity
# test, not a walk over thousands of keys.
_LAYOUTS: "OrderedDict[tuple, tuple]" = OrderedDict()
_LAYOUTS_LOCK = threading.Lock()
_MAX_LAYOUTS = 64


def _shared_layout(keys) -> tuple:
    t = tuple(keys)
    with _LAYOUTS_LOCK:
        t = _LAYOUTS.setdefault(t, t)
        _LAYOUTS.move_to_end(t)
        while len(_LAYOUTS) > _MAX_LAYOUTS:
            _LAYOUTS.popitem(last=False)
    return t


class ResidentSet:
    """A found set kept on the device: what
    :meth:`RoaringBitmapSliceIndex.compare_resident` returns, and a
    ``found_set`` that ``compare``, ``compare_resident``,
    ``compare_cardinality`` and ``sum`` take as it lies.

    ``keys`` is the ascending tuple of chunk keys the set lives on (the
    layout of the pack that made it, with the chunks outside the ebm that
    a NEQ keeps of its found set, as Java does); ``words`` the int32
    ``[K, 2048]`` words of those chunks and ``cards`` their int32 ``[K]``
    popcounts, on the device. Immutable: nothing writes into its tensors,
    so a set may share the pack's ebm words."""

    __slots__ = ("keys", "words", "cards")

    def __init__(self, keys, words: torch.Tensor, cards: torch.Tensor):
        self.keys = tuple(keys)
        self.words = words
        self.cards = cards

    @classmethod
    def empty(cls, device) -> "ResidentSet":
        return cls((), torch.zeros((0, dev.DEVICE_WORDS), dtype=torch.int32, device=device),
                   torch.zeros(0, dtype=torch.int32, device=device))

    def get_cardinality(self) -> int:
        """The per-chunk counts summed on the device and fetched."""
        return int(dev.to_host_i64(self.cards.sum(dtype=torch.int64).view(1))[0])

    def to_bitmap(self) -> RoaringBitmap:
        """The set as a ``RoaringBitmap``: its words fetched once and
        re-compressed (``store.unpack_to_bitmap``)."""
        return store.unpack_to_bitmap(
            np.asarray(self.keys, dtype=np.int64),
            dev.to_host_u32(self.words),
            dev.to_host_i64(self.cards),
        )

    def __repr__(self):
        return f"ResidentSet(chunks={len(self.keys)}, device={self.words.device})"


FoundSet = Union[None, RoaringBitmap, ResidentSet]


def _count_found(found_set: FoundSet) -> None:
    form = ("none" if found_set is None
            else "resident" if isinstance(found_set, ResidentSet) else "bitmap")
    _FOUND_TOTAL.inc(1, (form,))


def _joined(keys, words, cards, lacking: Optional[ResidentSet]) -> ResidentSet:
    """The set of ``words`` on ``keys``, with a found set's part outside
    them (``lacking``, which NEQ and the fixed verdict keep) merged in on
    the device, into one ascending layout."""
    if lacking is None:
        return ResidentSet(keys, words, cards)
    own = np.asarray(keys, dtype=np.int64)
    extra = np.asarray(lacking.keys, dtype=np.int64)
    merged = np.union1d(own, extra)
    at = torch.from_numpy(np.searchsorted(merged, own)).to(words.device)
    at_extra = torch.from_numpy(np.searchsorted(merged, extra)).to(words.device)
    w = words.new_zeros((merged.size, words.shape[1]))
    w.index_copy_(0, at, words).index_copy_(0, at_extra, lacking.words)
    c = cards.new_zeros(merged.size)
    c.index_copy_(0, at, cards).index_copy_(0, at_extra, lacking.cards)
    return ResidentSet(merged.tolist(), w, c)


class RoaringBitmapSliceIndex:
    """32-bit-value BSI over 32-bit column ids (RoaringBitmapSliceIndex.java)."""

    def __init__(self, min_value: int = 0, max_value: int = 0):
        self.min_value = int(min_value)
        self.max_value = int(max_value)
        self.ebm = RoaringBitmap()
        self.slices: List[RoaringBitmap] = [
            RoaringBitmap() for _ in range(max(0, int(max_value)).bit_length())
        ]
        self.run_optimized = False

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    def bit_count(self) -> int:
        return len(self.slices)

    def _grow(self, bit_depth: int) -> None:
        while len(self.slices) < bit_depth:
            self.slices.append(RoaringBitmap())

    def _ensure_capacity(self, lo: int, hi: int) -> None:
        # ensureCapacityInternal (RoaringBitmapSliceIndex.java:315-326)
        if self.ebm.is_empty():
            self.min_value, self.max_value = lo, hi
            self._grow(max(1, hi.bit_length()))
        else:
            if lo < self.min_value:
                self.min_value = lo
            if hi > self.max_value:
                self.max_value = hi
                self._grow(max(1, hi.bit_length()))

    def set_value(self, column_id: int, value: int) -> None:
        """setValue (RoaringBitmapSliceIndex.java:299): O(bit_depth) point
        updates; bulk ingest should use :meth:`set_values`."""
        value = int(value)
        if value < 0:
            raise ValueError("BSI values must be non-negative")
        self._ensure_capacity(value, value)
        overwriting = self.ebm.contains(column_id)
        for i in range(self.bit_count()):
            if (value >> i) & 1:
                self.slices[i].add(column_id)
            elif overwriting:
                self.slices[i].remove(column_id)
        self.ebm.add(column_id)

    def set_values(self, pairs) -> None:
        """Vectorized bulk construction (setValues,
        RoaringBitmapSliceIndex.java:349): each slice is built from one
        boolean mask over the value array.

        Input is either a 2-tuple ``(columns, values)`` of parallel arrays,
        or any other iterable of ``(column, value)`` pairs. Duplicate columns
        follow last-pair-wins, matching sequential ``set_value`` calls."""
        if isinstance(pairs, tuple) and len(pairs) == 2:
            cols, vals = pairs
        else:
            seq = list(pairs)
            if not seq:
                return
            cols = [p[0] for p in seq]
            vals = [p[1] for p in seq]
        cols = np.asarray(cols, dtype=np.uint32)
        vals = np.asarray(vals, dtype=np.int64)
        if cols.size == 0:
            return
        # last-pair-wins for duplicate columns within the batch
        _, last_idx = np.unique(cols[::-1], return_index=True)
        keep = np.sort(cols.size - 1 - last_idx)
        if keep.size != cols.size:
            cols, vals = cols[keep], vals[keep]
        if vals.min() < 0:
            raise ValueError("BSI values must be non-negative")
        self._ensure_capacity(int(vals.min()), int(vals.max()))
        # columns already present must have their old bits cleared first
        if not self.ebm.is_empty():
            existing = RoaringBitmap(cols)
            overlap = RoaringBitmap.and_(self.ebm, existing)
            if not overlap.is_empty():
                for s in self.slices:
                    s.iandnot(overlap)
        for i in range(self.bit_count()):
            mask = (vals >> i) & 1 == 1
            if mask.any():
                self.slices[i].add_many(cols[mask])
        self.ebm.add_many(cols)

    def get_value(self, column_id: int) -> Tuple[int, bool]:
        """(value, exists) (getValue, RoaringBitmapSliceIndex.java:181)."""
        if not self.ebm.contains(column_id):
            return 0, False
        value = 0
        for i, s in enumerate(self.slices):
            if s.contains(column_id):
                value |= 1 << i
        return value, True

    def get_values(self, columns) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized bulk read: ``(values, exists)`` parallel to
        ``columns`` (an exact object-dtype array above 63 slices). Columns
        absent from the index read as value 0 with ``exists`` False."""
        return _bulk_get_values(self, np.asarray(columns, dtype=np.uint32).ravel())

    def value_exist(self, column_id: int) -> bool:
        return self.ebm.contains(column_id)

    def get_existence_bitmap(self) -> RoaringBitmap:
        return self.ebm

    def get_cardinality(self) -> int:
        return self.ebm.get_cardinality()

    def clone(self) -> "RoaringBitmapSliceIndex":
        out = RoaringBitmapSliceIndex(self.min_value, self.max_value)
        out.ebm = self.ebm.clone()
        out.slices = [s.clone() for s in self.slices]
        out.run_optimized = self.run_optimized
        return out

    def run_optimize(self) -> None:
        self.ebm.run_optimize()
        for s in self.slices:
            s.run_optimize()
        self.run_optimized = True

    def has_run_compression(self) -> bool:
        """True when any member bitmap holds a run container
        (hasRunCompression, MutableBitSliceIndex.java:117)."""
        return self.ebm.has_run_compression() or any(
            s.has_run_compression() for s in self.slices
        )

    # ------------------------------------------------------------------
    # combination
    # ------------------------------------------------------------------
    def merge(self, other: "RoaringBitmapSliceIndex") -> None:
        """Disjoint-column merge (RoaringBitmapSliceIndex.java:379)."""
        if other is None or other.ebm.is_empty():
            return
        if RoaringBitmap.intersects(self.ebm, other.ebm):
            raise ValueError("merge requires disjoint column sets")
        depth = max(self.bit_count(), other.bit_count())
        self._grow(depth)
        for i in range(other.bit_count()):
            self.slices[i].ior(other.slices[i])
        self.ebm.ior(other.ebm)
        if not self.ebm.is_empty():
            self.min_value = min(self.min_value, other.min_value)
            self.max_value = max(self.max_value, other.max_value)

    def add(self, other: "RoaringBitmapSliceIndex") -> None:
        """Element-wise sum with ripple carry (add/addDigit,
        RoaringBitmapSliceIndex.java:66-95)."""
        if other is None or other.ebm.is_empty():
            return
        self.ebm.ior(other.ebm)
        if other.bit_count() > self.bit_count():
            self._grow(other.bit_count())
        for i in range(other.bit_count()):
            self._add_digit(other.slices[i], i)
        self.min_value = self._min_value()
        self.max_value = self._max_value()

    def _add_digit(self, found_set: RoaringBitmap, i: int) -> None:
        carry = RoaringBitmap.and_(self.slices[i], found_set)
        self.slices[i].ixor(found_set)
        if not carry.is_empty():
            if i + 1 >= self.bit_count():
                self._grow(self.bit_count() + 1)
            self._add_digit(carry, i + 1)

    def _min_value(self) -> int:
        if self.ebm.is_empty():
            return 0
        ids = self.ebm
        for i in range(self.bit_count() - 1, -1, -1):
            tmp = RoaringBitmap.andnot(ids, self.slices[i])
            if not tmp.is_empty():
                ids = tmp
        return self.get_value(ids.first())[0]

    def _max_value(self) -> int:
        if self.ebm.is_empty():
            return 0
        ids = self.ebm
        for i in range(self.bit_count() - 1, -1, -1):
            tmp = RoaringBitmap.and_(ids, self.slices[i])
            if not tmp.is_empty():
                ids = tmp
        return self.get_value(ids.first())[0]

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------
    def compare(
        self,
        operation: Operation,
        start_or_value: int,
        end: int = 0,
        found_set: FoundSet = None,
        mode: Optional[str] = None,
    ) -> RoaringBitmap:
        """compare (RoaringBitmapSliceIndex.java:482-513): min/max
        short-circuit then O'Neil. A :class:`ResidentSet` found set keeps
        the walk on the device (unless ``mode`` is ``"cpu"``); the result
        comes back as a bitmap either way."""
        with _spans.span("bsi.compare"):
            _count_found(found_set)
            if isinstance(found_set, ResidentSet):
                if self._use_device(mode, found_set):
                    return self._compare_resident(operation, start_or_value, end, found_set).to_bitmap()
                found_set = found_set.to_bitmap()
            return self._compare(operation, start_or_value, end, found_set, mode)

    def compare_resident(
        self,
        operation: Operation,
        start_or_value: int,
        end: int = 0,
        found_set: FoundSet = None,
    ) -> ResidentSet:
        """compare whose result stays on the device: the same min/max
        verdicts and the same ``rb_oneil_compare`` launch as
        :meth:`compare`, the result's words and per-chunk counts returned
        unfetched on ``config.device``. ``found_set`` is None, a bitmap or
        a :class:`ResidentSet`; the result equals ``compare``'s with the
        same found set, a NEQ's found columns outside the ebm included."""
        with _spans.span("bsi.compare"):
            _count_found(found_set)
            return self._compare_resident(operation, start_or_value, end, found_set)

    def _compare(self, operation, start_or_value, end, found_set, mode) -> RoaringBitmap:
        res = self._compare_using_min_max(operation, start_or_value, end, found_set)
        if res is not None:
            return res
        if operation == Operation.RANGE:
            # the slice walk only sees bit_count() bits and every stored
            # value fits in them, so LE(end) == LE(clamped)
            end = min(int(end), (1 << self.bit_count()) - 1)
            if self._use_device(mode):
                # both slice walks and the AND in one launch
                return self._o_neil_device(
                    Operation.RANGE, start_or_value, found_set, end=end
                )
            left = self._o_neil(Operation.GE, start_or_value, found_set, mode)
            right = self._o_neil(Operation.LE, end, found_set, mode)
            return RoaringBitmap.and_(left, right)
        return self._o_neil(operation, start_or_value, found_set, mode)

    def _min_max_verdict(self, op, start_or_value, end):
        return min_max_verdict(op, start_or_value, end, self.min_value, self.max_value)

    def _compare_using_min_max(self, op, start_or_value, end, found_set):
        verdict = self._min_max_verdict(op, start_or_value, end)
        if verdict is None:
            return None
        if verdict == "empty":
            return RoaringBitmap()
        if verdict == "fixed":
            return self.ebm.clone() if found_set is None else found_set.clone()
        return (
            self.ebm.clone()
            if found_set is None
            else RoaringBitmap.and_(self.ebm, found_set)
        )

    def _use_device(self, mode: Optional[str], found_set: FoundSet = None) -> bool:
        """The device path or the CPU walk, by index size only; in auto
        mode a resident found set keeps to the device it lies on."""
        mode = mode or config.mode
        if mode == "cpu":
            return False
        if mode == "device":
            return True
        if mode != "auto":
            raise ValueError(f"mode must be 'auto', 'cpu' or 'device', got {mode!r}")
        if isinstance(found_set, ResidentSet):
            return True
        cells = self.bit_count() * self.ebm.get_container_count()
        return cells >= config.min_device_cells

    def _o_neil(self, op, predicate, found_set, mode=None) -> RoaringBitmap:
        if self._use_device(mode):
            return self._o_neil_device(op, predicate, found_set)
        return self._o_neil_cpu(op, predicate, found_set)

    def _o_neil_cpu(self, op, predicate, found_set) -> RoaringBitmap:
        """oNeilCompare (RoaringBitmapSliceIndex.java:432-469)."""
        fixed = self.ebm if found_set is None else found_set
        gt, lt, eq = RoaringBitmap(), RoaringBitmap(), self.ebm
        for i in range(self.bit_count() - 1, -1, -1):
            if (predicate >> i) & 1:
                lt = RoaringBitmap.or_(lt, RoaringBitmap.andnot(eq, self.slices[i]))
                eq = RoaringBitmap.and_(eq, self.slices[i])
            else:
                gt = RoaringBitmap.or_(gt, RoaringBitmap.and_(eq, self.slices[i]))
                eq = RoaringBitmap.andnot(eq, self.slices[i])
        eq = RoaringBitmap.and_(fixed, eq)
        return self._finish(op, gt, lt, eq, fixed)

    @staticmethod
    def _finish(op, gt, lt, eq, fixed) -> RoaringBitmap:
        if op == Operation.EQ:
            return eq
        if op == Operation.NEQ:
            return RoaringBitmap.andnot(fixed, eq)
        if op == Operation.GT:
            return RoaringBitmap.and_(gt, fixed)
        if op == Operation.LT:
            return RoaringBitmap.and_(lt, fixed)
        if op == Operation.LE:
            return RoaringBitmap.and_(RoaringBitmap.or_(lt, eq), fixed)
        if op == Operation.GE:
            return RoaringBitmap.and_(RoaringBitmap.or_(gt, eq), fixed)
        raise ValueError(f"unsupported operation {op}")

    # ---- device path --------------------------------------------------
    def _pack_key(self) -> tuple:
        """The pack's key in ``store.PACK_CACHE``: the member bitmaps'
        fingerprints and the device, so any mutation (including one that
        touches a slice bitmap directly) re-keys it."""
        return (
            "bsi",
            self.ebm.fingerprint(),
            tuple(s.fingerprint() for s in self.slices),
            str(resolve_device(config.device)),
        )

    def _pack_dense(self):
        """``(keys, ebm_w, slices_w)``: int32 ``[K, 2048]`` ebm words and
        the ``[S, K, 2048]`` slice tensor over the ebm's K chunk keys, on
        ``config.device``. Built on the host, sent in one copy, and kept
        resident in the process-wide pack cache (``store.PACK_CACHE``)
        under :meth:`_pack_key`: repeat queries skip the host marshal, the
        BSI tensors share one byte budget and LRU with the aggregation and
        query packs, and a mutated index re-keys its entry, so the stale
        pack ages out."""
        device = resolve_device(config.device)

        def build():
            (keys, ebm_w, slices_w), nbytes = pack_slices(
                _items(self.ebm), [_items(s) for s in self.slices], device
            )
            return (_shared_layout(keys), ebm_w, slices_w), nbytes

        return store.PACK_CACHE.get_or_build(
            self._pack_key(), build,
            refs=store.static_fp_refs([self.ebm] + list(self.slices)),
        )

    @staticmethod
    def _found_words(keys, like: torch.Tensor, found_set: RoaringBitmap) -> torch.Tensor:
        """found_set marshalled onto the packed key layout on the host:
        int32 ``[K, 2048]`` on ``like``'s device."""
        with _spans.span("bsi.found.marshal"):
            return found_words(keys, like, _items(found_set))

    def _found_on(self, found_set: FoundSet, keys, ebm_w: torch.Tensor, lacking: bool = False):
        """``(fixed_w, rest)``: the found set's words on the pack's layout
        (the ebm's when None) and, with ``lacking``, its part outside the
        layout as a :class:`ResidentSet` (None when it has none). A bitmap
        is marshalled on the host; a resident set is taken as it lies on
        the same layout, else remapped by key on the device."""
        if found_set is None:
            return ebm_w, None
        if isinstance(found_set, ResidentSet):
            return _resident_on(found_set, keys, ebm_w, lacking)
        fixed_w = self._found_words(keys, ebm_w, found_set)
        if not lacking:
            return fixed_w, None
        rest = RoaringBitmap.andnot(found_set, _keys_subset(found_set, set(keys)))
        if rest.is_empty():
            return fixed_w, None
        rest_keys = rest.high_low_container.keys
        rest_w = self._found_words(rest_keys, ebm_w.new_empty((len(rest_keys), ebm_w.shape[1])), rest)
        return fixed_w, ResidentSet(rest_keys, rest_w, kernels.popcount_rows(rest_w))

    def _pack_with_fixed(self, found_set: FoundSet):
        """(keys, ebm_w, slices_w, fixed_w) — the pack plus the found-set
        words on its key layout (fixed = ebm when no found set)."""
        keys, ebm_w, slices_w = self._pack_dense()
        return keys, ebm_w, slices_w, self._found_on(found_set, keys, ebm_w)[0]

    @staticmethod
    def _slice_counts(slices_w: torch.Tensor, found_w: torch.Tensor) -> torch.Tensor:
        """int64 ``[S]`` on the device: |slice_i ∩ found| from one masked
        popcount launch over the pack (on each rank of ``config.mesh`` when
        set), the per-chunk counts reduced on the device."""
        s_count, k = slices_w.shape[0], slices_w.shape[1]
        if s_count == 0 or k == 0:
            return torch.zeros(s_count, dtype=torch.int64, device=slices_w.device)
        if config.mesh is not None:
            from ..parallel import sharding

            mesh = config.mesh
            counts = sharding.distributed_bsi_sum(mesh)(*_mesh_shards(mesh, slices_w, found_w))
            per_chunk = sharding.gather_shards(mesh, counts, (None, "containers"))
        else:
            per_chunk = kernels.popcount_rows(slices_w, mask=found_w).view(s_count, k)
        return per_chunk.sum(dim=1, dtype=torch.int64)

    def _sum_device(self, found_set: RoaringBitmap) -> int:
        """Σ 2^i · |slice_i ∩ found| (:meth:`_slice_counts`); the 2^i
        weighting runs on the host in exact Python ints (S can exceed 62
        bits)."""
        keys, ebm_w, slices_w = self._pack_dense()
        per_slice = dev.to_host_i64(self._slice_counts(slices_w, self._found_on(found_set, keys, ebm_w)[0]))
        return sum(int(c) << i for i, c in enumerate(per_slice.tolist()))

    def _sum_resident(self, found_set: ResidentSet) -> Tuple[int, int]:
        """(sum, count) over a resident found set: the per-slice counts and
        the set's own count reduced on the device and fetched in one copy."""
        keys, ebm_w, slices_w = self._pack_dense()
        found_w, _ = self._found_on(found_set, keys, ebm_w)
        count = found_set.cards.sum(dtype=torch.int64).view(1)
        got = dev.to_host_i64(torch.cat([self._slice_counts(slices_w, found_w), count])).tolist()
        count = got.pop()
        if count == 0:
            return 0, 0
        return sum(int(c) << i for i, c in enumerate(got)), count

    def compare_cardinality(
        self,
        operation: Operation,
        start_or_value: int,
        end: int = 0,
        found_set: FoundSet = None,
        mode: Optional[str] = None,
    ) -> int:
        """Count-only compare: the device path fetches only the per-chunk
        popcounts — no result words, no container rebuild (the reference's
        RangeBitmap *Cardinality family, RangeBitmap.java:111-414,
        generalized to the BSI). A :class:`ResidentSet` found set is the
        count of :meth:`compare_resident`'s set, fetched as one number."""
        with _spans.span("bsi.compare_cardinality"):
            _count_found(found_set)
            if isinstance(found_set, ResidentSet):
                if self._use_device(mode, found_set):
                    return self._compare_resident(
                        operation, start_or_value, end, found_set
                    ).get_cardinality()
                found_set = found_set.to_bitmap()
            return self._compare_cardinality(operation, start_or_value, end, found_set, mode)

    def _compare_cardinality(self, operation, start_or_value, end, found_set, mode) -> int:
        verdict = self._min_max_verdict(operation, start_or_value, end)
        if verdict == "empty":
            return 0
        if verdict == "fixed":
            return (self.ebm if found_set is None else found_set).get_cardinality()
        if verdict == "all":
            if found_set is None:
                return self.ebm.get_cardinality()
            return RoaringBitmap.and_cardinality(self.ebm, found_set)
        if self._use_device(mode):
            if operation == Operation.RANGE:
                end = min(int(end), (1 << self.bit_count()) - 1)
            keys, _out, cards, fixed_bm = self._o_neil_device_walk(
                operation, start_or_value, found_set, end, count_only=True
            )
            total = int(cards.cpu().numpy().astype(np.int64).sum())
            if operation == Operation.NEQ and found_set is not None:
                total += self._neq_outside_ebm(fixed_bm, keys)
            return total
        return self._compare(operation, start_or_value, end, found_set, "cpu").get_cardinality()

    def compare_cardinality_many(
        self,
        operation: Operation,
        values,
        ends=None,
        found_set: Optional[RoaringBitmap] = None,
        mode: Optional[str] = None,
    ) -> np.ndarray:
        """Count-only compare for a whole batch of predicates: ``values`` is
        a [Q] array of thresholds (plus ``ends`` for RANGE), the result a
        [Q] int64 count array. On the device path every predicate the
        min/max verdict leaves open rides ONE count-only launch (on each
        rank of ``config.mesh`` when set)."""
        return _counts_many(self, operation, values, ends, found_set, mode, mesh=config.mesh)

    @staticmethod
    def _neq_outside_ebm(found_set: RoaringBitmap, keys) -> int:
        """Count of found-set columns in chunks outside the packed ebm keys
        (NEQ qualifies them wholesale)."""
        kset = set(keys)
        hlc = found_set.high_low_container
        return sum(
            c.cardinality for k, c in zip(hlc.keys, hlc.containers) if k not in kset
        )

    def _o_neil_device_walk(
        self, op, predicate, found_set, end: int = 0, count_only: bool = False
    ):
        """One ``rb_oneil_compare`` launch (on each rank of ``config.mesh``
        when set); returns (keys, out, cards, fixed_bm) with nothing
        fetched to the host: int32 ``[K, 2048]`` result words (None when
        ``count_only``) and ``[K]`` popcounts."""
        keys, ebm_w, slices_w, fixed_w = self._pack_with_fixed(found_set)
        fixed_bm = self.ebm if found_set is None else found_set
        out, cards = self._walk(op, predicate, end, ebm_w, slices_w, fixed_w, count_only)
        return keys, out, cards, fixed_bm

    def _walk(self, op, predicate, end, ebm_w, slices_w, fixed_w, count_only: bool = False):
        """(out, cards) of one ``rb_oneil_compare`` launch over the pack
        against ``fixed_w`` (on each rank of ``config.mesh`` when set)."""
        s_count = self.bit_count()
        walks = [_bits_high_first(predicate, s_count)]
        if op == Operation.RANGE:
            walks.append(_bits_high_first(end, s_count))
        if config.mesh is not None:
            return _mesh_compare(
                config.mesh, slices_w, walks, ebm_w, fixed_w, op.value, count_only
            )
        bits = torch.tensor([walks], dtype=torch.int32).to(slices_w.device)
        out, cards = kernels.oneil_compare(
            slices_w, bits, ebm_w, fixed_w, op.value, count_only=count_only
        )
        return out, cards[0]

    def _compare_resident(self, op, start_or_value, end, found_set: FoundSet) -> ResidentSet:
        """:meth:`compare` with its result left on the device: the verdict's
        set or the walk's words and counts, a found set's columns outside
        the layout carried along where NEQ keeps them."""
        verdict = self._min_max_verdict(op, start_or_value, end)
        if verdict == "empty":
            return ResidentSet.empty(resolve_device(config.device))
        if verdict == "fixed" and isinstance(found_set, ResidentSet):
            return found_set
        keys, ebm_w, slices_w = self._pack_dense()
        keep = verdict == "fixed" or (verdict is None and op == Operation.NEQ)
        fixed_w, lacking = self._found_on(found_set, keys, ebm_w, lacking=keep)
        if verdict is None:
            if op == Operation.RANGE:
                end = min(int(end), (1 << self.bit_count()) - 1)
            out, cards = self._walk(op, start_or_value, end, ebm_w, slices_w, fixed_w)
        else:
            out = fixed_w if verdict == "fixed" or found_set is None else ebm_w & fixed_w
            cards = kernels.popcount_rows(out)
        return _joined(keys, out, cards, lacking)

    def _o_neil_device(self, op, predicate, found_set, end: int = 0) -> RoaringBitmap:
        """The whole O'Neil chain — walk, op epilogue and popcount — as one
        kernel launch; the result words come back once and are
        re-compressed into containers. For RANGE both walks run in the same
        launch."""
        keys, out, cards, fixed_bm = self._o_neil_device_walk(
            op, predicate, found_set, end
        )
        result = store.unpack_to_bitmap(
            np.asarray(keys, dtype=np.int64),
            dev.to_host_u32(out),
            cards.cpu().numpy().astype(np.int64),
        )
        if op == Operation.NEQ and found_set is not None:
            # found_set columns in chunks outside the ebm were not packed;
            # none of them can be EQ, so they all qualify (Java semantics:
            # NEQ = foundSet \ EQ without intersecting foundSet with ebm)
            missing = RoaringBitmap.andnot(fixed_bm, _keys_subset(fixed_bm, set(keys)))
            result = RoaringBitmap.or_(result, missing)
        return result

    def sum(self, found_set: FoundSet = None, mode: Optional[str] = None) -> Tuple[int, int]:
        """(sum, count) over found columns (RoaringBitmapSliceIndex.java:581-592).
        A :class:`ResidentSet` found set is the popcount mask as it lies;
        only the per-slice counts and the count come to the host."""
        with _spans.span("bsi.sum"):
            _count_found(found_set)
            if isinstance(found_set, ResidentSet):
                if self._use_device(mode, found_set):
                    return self._sum_resident(found_set)
                found_set = found_set.to_bitmap()
            if found_set is None or found_set.is_empty():
                return 0, 0
            count = found_set.get_cardinality()
            if self._use_device(mode):
                return self._sum_device(found_set), count
            total = sum(
                (1 << i) * RoaringBitmap.and_cardinality(s, found_set)
                for i, s in enumerate(self.slices)
            )
            return total, count

    def transpose(self, found_set: Optional[RoaringBitmap] = None) -> RoaringBitmap:
        """Bitmap of distinct values over the found columns."""
        cols = (
            self.ebm if found_set is None else RoaringBitmap.and_(self.ebm, found_set)
        ).to_array()
        if cols.size == 0:
            return RoaringBitmap()
        return RoaringBitmap(np.unique(values_for_columns(cols, self.slices)))

    def top_k(self, found_set: Optional[RoaringBitmap], k: int) -> RoaringBitmap:
        """Columns holding the k largest values — MSB-first slice descent
        (BitSliceIndexBase.topK, bsi/.../BitSliceIndexBase.java:303). Ties at
        the cut line are broken by smallest column id."""
        if found_set is None:
            found_set = self.ebm
        if found_set.is_empty() or k <= 0:
            return RoaringBitmap()
        if k >= found_set.get_cardinality():
            return found_set.clone()
        result = RoaringBitmap()
        candidates = found_set.clone()
        for i in range(self.bit_count() - 1, -1, -1):
            if candidates.is_empty() or k <= 0:
                break
            with_bit = RoaringBitmap.and_(candidates, self.slices[i])
            card = with_bit.get_cardinality()
            if card > k:
                candidates = with_bit
            else:
                result.ior(with_bit)
                candidates.iandnot(self.slices[i])
                k -= card
        if k > 0 and not candidates.is_empty():
            result.ior(candidates.limit(k))
        return result

    def to_pair_list(
        self, found_set: Optional[RoaringBitmap] = None
    ) -> List[Tuple[int, int]]:
        """(column, value) pairs (BitSliceIndexBase.toPairList)."""
        cols = (
            self.ebm if found_set is None else RoaringBitmap.and_(self.ebm, found_set)
        ).to_array()
        if cols.size == 0:
            return []
        values = values_for_columns(cols, self.slices)
        return list(zip(cols.tolist(), values.tolist()))

    # ------------------------------------------------------------------
    # serialization (ByteBuffer layout, little-endian)
    # ------------------------------------------------------------------
    def serialize(self) -> bytes:
        parts = [
            pack_header(self.min_value, self.max_value, self.run_optimized),
            self.ebm.serialize(),
            struct.pack("<i", self.bit_count()),
        ]
        parts.extend(s.serialize() for s in self.slices)
        return b"".join(parts)

    def serialized_size_in_bytes(self) -> int:
        from ..serialization import serialized_size_in_bytes

        return (
            4 + 4 + 1 + 4
            + serialized_size_in_bytes(self.ebm)
            + sum(serialized_size_in_bytes(s) for s in self.slices)
        )

    def serialize_into(self, fileobj) -> int:
        """Stream overload (MutableBitSliceIndex.java:331
        serialize(DataOutput)); returns the byte count written."""
        data = self.serialize()
        fileobj.write(data)
        return len(data)

    @classmethod
    def deserialize_from(cls, fileobj):
        """Stream twin of :meth:`serialize_into`: consumes exactly one BSI,
        leaving the position at the next byte. Subclasses return their own
        type."""
        from ..serialization import read_exact

        header = read_exact(fileobj, 9)
        ebm = RoaringBitmap.deserialize_from(fileobj)
        (depth,) = struct.unpack("<i", read_exact(fileobj, 4))
        if depth < 0 or depth > 64:
            raise InvalidRoaringFormat(f"implausible BSI depth {depth}")
        min_v, max_v, ro = unpack_header(header)
        out = cls()
        out.min_value, out.max_value = min_v, max_v
        out.run_optimized = ro
        out.ebm = ebm
        out.slices = [RoaringBitmap.deserialize_from(fileobj) for _ in range(depth)]
        return out

    def __reduce__(self):
        """Pickle via the BSI wire format; subclasses reconstruct their own
        type (MutableBitSliceIndex overrides deserialize)."""
        return type(self).deserialize, (self.serialize(),)

    @staticmethod
    def deserialize(data) -> "RoaringBitmapSliceIndex":
        buf = memoryview(data if isinstance(data, (bytes, bytearray, memoryview)) else bytes(data))
        if len(buf) < 9:
            raise InvalidRoaringFormat("truncated BSI header")
        min_v, max_v, ro = unpack_header(buf)
        pos = 9
        out = RoaringBitmapSliceIndex()
        out.min_value, out.max_value = min_v, max_v
        out.run_optimized = ro
        out.ebm = RoaringBitmap()
        pos += read_into(out.ebm, buf[pos:])
        if pos + 4 > len(buf):
            raise InvalidRoaringFormat("truncated BSI slice count")
        (depth,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        if depth < 0 or depth > 64:
            raise InvalidRoaringFormat(f"implausible BSI depth {depth}")
        out.slices = []
        for _ in range(depth):
            s = RoaringBitmap()
            pos += read_into(s, buf[pos:])
            out.slices.append(s)
        return out

    def __eq__(self, other):
        if not isinstance(other, RoaringBitmapSliceIndex):
            return NotImplemented
        return (
            self.ebm == other.ebm
            and len(self.slices) == len(other.slices)
            and all(a == b for a, b in zip(self.slices, other.slices))
        )

    def __repr__(self):
        return (
            f"RoaringBitmapSliceIndex(cols={self.get_cardinality()}, "
            f"slices={self.bit_count()}, min={self.min_value}, max={self.max_value})"
        )


def _resident_on(found: ResidentSet, keys: tuple, like: torch.Tensor, lacking: bool = False):
    """``(fixed_w, rest)`` of a resident found set on the layout ``keys``
    (``like``: the pack's ebm words): its words as they lie when the
    layouts are one, else gathered by key on the device with zeros where
    it has no row; with ``lacking``, its rows outside ``keys`` as a
    :class:`ResidentSet` (None when there are none)."""
    with _spans.span("bsi.found.resident"):
        if found.keys is keys or found.keys == keys:
            return found.words, None
        have = np.asarray(found.keys, dtype=np.int64)
        want = np.asarray(keys, dtype=np.int64)
        at = np.minimum(np.searchsorted(have, want), max(have.size - 1, 0))
        hit = np.flatnonzero(have[at] == want) if have.size else np.zeros(0, dtype=np.int64)
        fixed_w = like.new_zeros(like.shape)
        if hit.size:
            src = torch.from_numpy(at[hit]).to(like.device)
            fixed_w.index_copy_(0, torch.from_numpy(hit).to(like.device), found.words.index_select(0, src))
        if not lacking:
            return fixed_w, None
        out_rows = np.flatnonzero(~np.isin(have, want, assume_unique=True))
        if out_rows.size == 0:
            return fixed_w, None
        idx = torch.from_numpy(out_rows).to(like.device)
        rest = ResidentSet(have[out_rows].tolist(), found.words.index_select(0, idx),
                           found.cards.index_select(0, idx))
        return fixed_w, rest


def _keys_subset(bm: RoaringBitmap, keys: set) -> RoaringBitmap:
    """Sub-bitmap of bm restricted to the given high-16 keys."""
    out = RoaringBitmap()
    hlc = bm.high_low_container
    for k, c in zip(hlc.keys, hlc.containers):
        if k in keys:
            out.high_low_container.append(k, c.clone())
    return out


def _pad_chunk_axis(mesh, *tensors) -> List[torch.Tensor]:
    """Pad the key-chunk axis (the second-to-last of ``[S, K, W]``, the
    first of ``[K, W]``) with empty chunks up to a multiple of the mesh's
    ``containers`` size: zero ebm, fixed and found words make a padded
    chunk count nothing for every op, NEQ included. Tensors already a
    multiple come back as they are."""
    from ..parallel import sharding

    n_c = sharding.axis_size(mesh, "containers")
    out = []
    for t in tensors:
        k_axis = t.dim() - 2
        pad = (-t.shape[k_axis]) % n_c
        if pad:
            shape = list(t.shape)
            shape[k_axis] = pad
            t = torch.cat([t, t.new_zeros(shape)], dim=k_axis)
        out.append(t)
    return out


def _mesh_shards(mesh, *tensors) -> List[torch.Tensor]:
    """This rank's blocks of pack tensors (``[S, K, W]`` or ``[K, W]``):
    the chunk axis padded (:func:`_pad_chunk_axis`) and cut over
    ``containers``, the word axis over ``words``."""
    from ..parallel import sharding

    return [
        sharding.shard_rows(mesh, t, (None,) * (t.dim() - 2) + ("containers", "words"))
        for t in _pad_chunk_axis(mesh, *tensors)
    ]


def _mesh_compare(mesh, slices_w, walks, ebm_w, fixed_w, op_name: str, count_only: bool):
    """One O'Neil compare over the mesh (``sharding.distributed_bsi_compare``)
    on each rank's block of the pack: ``(out [K, W] or None when
    count_only, cards [K])`` gathered on every rank, the padding dropped."""
    from ..parallel import sharding

    k = ebm_w.shape[0]
    s3, e2, f2 = _mesh_shards(mesh, slices_w, ebm_w, fixed_w)
    out, cards = sharding.distributed_bsi_compare(mesh, op_name)(
        s3, torch.tensor(walks, dtype=torch.int32), e2, f2
    )
    cards = sharding.gather_shards(mesh, cards, ("containers",))[:k]
    if count_only:
        return None, cards
    return sharding.gather_shards(mesh, out, ("containers", "words"))[:k], cards


def _mesh_batched_counts(mesh, slices_w, bits, ebm_w, fixed_w, op_name: str):
    """The batched counts over the mesh, shared by both BSI designs: the
    count-only walk of every query on each rank's block of the pack
    (``sharding.distributed_bsi_counts_many``, one ``rb_oneil_counts``
    launch for the batch), the ``[Q, K]`` counts gathered and the padding
    dropped."""
    from ..parallel import sharding

    k = ebm_w.shape[0]
    s3, e2, f2 = _mesh_shards(mesh, slices_w, ebm_w, fixed_w)
    cards = sharding.distributed_bsi_counts_many(mesh, op_name)(s3, bits, e2, f2)
    return sharding.gather_shards(mesh, cards, (None, "containers"))[:, :k]


def _counts_many(owner, operation, values, ends, found_set, mode, mesh=None) -> np.ndarray:
    """The engine behind compare_cardinality_many: per-predicate min/max
    verdicts resolve on the host, the remainder rides one count-only
    ``rb_oneil_compare`` launch over the pack (or, off the device path, one
    ``compare_cardinality`` each); with ``mesh``, one such launch on each
    rank's block of the pack (:func:`_mesh_batched_counts`).

    ``owner`` is the index: bit_count/ebm/min_value/max_value,
    compare_cardinality, _use_device, _pack_with_fixed and
    _neq_outside_ebm.

    Thresholds stay exact Python ints end to end — an int64 cast would wrap
    (or refuse) predicates >= 2^63, which the index stores exactly."""
    vals = [int(v) for v in np.asarray(values, dtype=object).ravel()]
    q_n = len(vals)
    out = np.zeros(q_n, dtype=np.int64)
    if q_n == 0:
        return out
    cap = (1 << owner.bit_count()) - 1
    ends_list = None
    if operation == Operation.RANGE:
        if ends is None:
            raise ValueError("RANGE requires ends")
        ends_list = [min(int(e), cap) for e in np.asarray(ends, dtype=object).ravel()]
        if len(ends_list) != q_n:
            raise ValueError("ends must align with values")
    ebm_t = type(owner.ebm)
    pend = []
    for qi in range(q_n):
        end_q = ends_list[qi] if ends_list is not None else 0
        verdict = min_max_verdict(
            operation, vals[qi], end_q, owner.min_value, owner.max_value
        )
        if verdict is None:
            pend.append(qi)
        elif verdict == "empty":
            out[qi] = 0
        elif verdict == "fixed":
            out[qi] = (owner.ebm if found_set is None else found_set).get_cardinality()
        else:  # "all"
            out[qi] = (
                owner.ebm.get_cardinality()
                if found_set is None
                else ebm_t.and_cardinality(owner.ebm, found_set)
            )
    if not pend:
        return out
    if not owner._use_device(mode):
        for qi in pend:
            end_q = ends_list[qi] if ends_list is not None else 0
            out[qi] = owner.compare_cardinality(
                operation, vals[qi], end_q, found_set, mode
            )
        return out
    keys, ebm_w, slices_w, fixed_w = owner._pack_with_fixed(found_set)
    s_count = owner.bit_count()
    if operation == Operation.RANGE:
        walks = [
            [_bits_high_first(vals[qi], s_count), _bits_high_first(ends_list[qi], s_count)]
            for qi in pend
        ]
    else:
        walks = [[_bits_high_first(vals[qi], s_count)] for qi in pend]
    w = 2 if operation == Operation.RANGE else 1
    bits = torch.tensor(walks, dtype=torch.int32).reshape(len(pend), w, s_count)
    if mesh is not None:
        cards = _mesh_batched_counts(mesh, slices_w, bits, ebm_w, fixed_w, operation.value)
    else:
        _, cards = kernels.oneil_compare(
            slices_w, bits.to(slices_w.device), ebm_w, fixed_w, operation.value, count_only=True
        )
    totals = cards.cpu().numpy().astype(np.int64).sum(axis=1)
    if operation == Operation.NEQ and found_set is not None:
        totals += owner._neq_outside_ebm(found_set, keys)
    out[np.array(pend)] = totals
    return out
