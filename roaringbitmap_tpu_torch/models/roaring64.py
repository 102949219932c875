"""64-bit layer, design 1 of 2: ``Roaring64NavigableMap``.

Counterpart of the JAX package's ``models/roaring64.py``, over the port's
``RoaringBitmap``; the wire formats are byte-identical. The reference ships two 64-bit designs — ``Roaring64NavigableMap``
(longlong/Roaring64NavigableMap.java:29: NavigableMap of high-32 bits ->
32-bit bitmap, cached cumulative cardinalities for rank/select :66-72,
signed/unsigned key ordering :97-100) — this module — and the ART-based
``Roaring64Bitmap`` (longlong/Roaring64Bitmap.java:29: high-48 trie ->
16-bit container), built in ``roaring64art.py`` over ``art.py``.

Here the NavigableMap becomes a sorted high-32 index over full 32-bit
RoaringBitmaps; every bucket reuses the whole 32-bit stack including the
packed device aggregation path, so 64-bit wide-ORs batch exactly like
32-bit ones (``parallel/aggregation64.or_navigable``: one grouped reduce on
the card over every bucket's chunks).

Serialization supports both reference modes
(Roaring64NavigableMap.java:35/:47/:51 SERIALIZATION_MODE switch):

* **portable** (default here; the cross-language spec, validated against the
  CRoaring-written golden files testdata/64map*.bin): uint64 LE bucket
  count, then per bucket uint32 LE high key + standard 32-bit
  serialization, buckets in unsigned key order.
* **legacy** (the reference's Java-default, serializeLegacy): uint8 bool
  signed_longs, int32 BE bucket count, per bucket int32 BE key + 32-bit
  serialization, buckets in comparator order.

Values are unsigned 64-bit [0, 2^64) by default; ``signed_longs=True``
orders them as two's-complement longs (negative half first).
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from typing import Iterable, Iterator, List, Optional

import numpy as np

from .roaring import RoaringBitmap
from ..serialization import InvalidRoaringFormat
from ..utils import bits

_MAX64 = 1 << 64
_MAX32 = 1 << 32


def _check64(x: int) -> int:
    x = int(x)
    if not 0 <= x < _MAX64:
        raise ValueError(f"value {x} outside unsigned 64-bit range")
    return x


def chunk_ranges_64(start: int, end: int, shift: int):
    """Split a 64-bit half-open range into per-chunk (high, lo, hi) pieces,
    where chunks are 2^shift wide and (lo, hi) is half-open within a chunk.
    Shared by both 64-bit designs (shift=32 buckets / shift=16 containers)."""
    start, end = int(start), int(end)
    if not 0 <= start <= end <= _MAX64:
        raise ValueError(f"invalid range [{start}, {end})")
    if start == end:
        return
    mask = (1 << shift) - 1
    h_start, h_end = start >> shift, (end - 1) >> shift
    for h in range(h_start, h_end + 1):
        lo = start & mask if h == h_start else 0
        hi = ((end - 1) & mask) + 1 if h == h_end else (1 << shift)
        yield h, lo, hi


def group_by_high(values, shift: int):
    """Sort+coerce an iterable of unsigned 64-bit values and yield
    (high, sorted unique low parts) groups, where high = v >> shift.
    Shared batching for both 64-bit designs' add_many."""
    if not isinstance(values, np.ndarray):
        values = np.fromiter(iter(values), dtype=np.uint64)
    if np.issubdtype(values.dtype, np.signedinteger) and values.size and values.min() < 0:
        raise ValueError("values outside unsigned 64-bit range")
    v = np.asarray(values).astype(np.uint64).ravel()
    # pre-sorted bulk input (BSI slice masks, sorted ingest) skips the sort
    # and the per-bucket uniques
    presorted = bits.is_strictly_increasing(v)
    if not presorted:
        v = np.sort(v)
    if v.size == 0:
        return
    mask = np.uint64((1 << shift) - 1)
    highs = (v >> np.uint64(shift)).astype(np.uint64)
    lows = v & mask
    boundaries = np.nonzero(np.diff(highs))[0] + 1
    starts = np.concatenate(([0], boundaries))
    ends = np.concatenate((boundaries, [v.size]))
    for s, e in zip(starts.tolist(), ends.tolist()):
        chunk = lows[s:e]
        yield int(highs[s]), (chunk if presorted else np.unique(chunk))


def bucketed_membership(values, shift: int, probe) -> np.ndarray:
    """Shared vectorized-membership scaffold for both 64-bit designs'
    ``contains_many``: bucket the queries by ``high = v >> shift`` (one
    stable argsort), then ask ``probe(high, lows) -> bool array`` once per
    distinct bucket. Negative ints are taken as their two's-complement
    bit patterns (Java long semantics)."""
    vals = np.asarray(values).astype(np.uint64, copy=False).ravel()
    out = np.zeros(vals.shape, dtype=bool)
    if vals.size == 0:
        return out
    highs = vals >> np.uint64(shift)
    order = np.argsort(highs, kind="stable")
    sh = highs[order]
    bounds = np.flatnonzero(np.concatenate([[True], sh[1:] != sh[:-1]]))
    bounds = np.append(bounds, sh.size)
    mask = np.uint64((1 << shift) - 1)
    for s, e in zip(bounds[:-1], bounds[1:]):
        idx = order[s:e]
        got = probe(int(sh[s]), vals[idx] & mask)
        if got is not None:
            out[idx] = got
    return out


SERIALIZATION_MODE_LEGACY = 0  # Roaring64NavigableMap.java:35
SERIALIZATION_MODE_PORTABLE = 1  # Roaring64NavigableMap.java:47


class Roaring64NavigableMap:
    """64-bit Roaring bitmap as a sorted map of high-32 buckets
    (longlong/Roaring64NavigableMap.java:29)."""

    # Mutable global switch like the reference's (:51-52); this framework
    # defaults to the portable cross-language spec rather than the Java
    # legacy format.
    SERIALIZATION_MODE = SERIALIZATION_MODE_PORTABLE

    __slots__ = (
        "_buckets",
        "_keys",
        "_ckeys",
        "_ckeys_arr",
        "_keys_dirty",
        "_cum_cards",
        "_cum_dirty",
        "signed_longs",
        "supplier",
    )

    def __init__(
        self,
        values: Optional[Iterable[int]] = None,
        signed_longs: bool = False,
        supplier=None,
    ):
        self._buckets: dict = {}  # high32 -> RoaringBitmap
        self._keys: List[int] = []
        self._ckeys: Optional[List[int]] = None
        self._ckeys_arr: Optional[np.ndarray] = None
        self._keys_dirty = False
        self._cum_cards: Optional[np.ndarray] = None
        self._cum_dirty = True
        self.signed_longs = signed_longs  # Roaring64NavigableMap.java:100
        # pluggable per-bucket backend (BitmapDataProviderSupplier,
        # Roaring64NavigableMap.java:63): any callable returning a
        # RoaringBitmap-compatible instance, e.g. MutableRoaringBitmap
        self.supplier = supplier or RoaringBitmap
        if values is not None:
            self.add_many(values)

    # ------------------------------------------------------------------
    def _key_order(self, k: int) -> int:
        """Comparator: unsigned by default, two's-complement when signed."""
        if self.signed_longs and k >= (1 << 31):
            return k - _MAX32
        return k

    def _sorted_keys(self) -> List[int]:
        if self._keys_dirty:
            self._keys = sorted(self._buckets, key=self._key_order)
            self._ckeys = None
            self._ckeys_arr = None
            self._keys_dirty = False
        return self._keys

    def _comparator_keys(self) -> List[int]:
        """_sorted_keys mapped through the comparator, for bisecting; the
        identity (same list) in unsigned mode, cached in signed mode."""
        keys = self._sorted_keys()
        if not self.signed_longs:
            return keys
        if self._ckeys is None:
            self._ckeys = [self._key_order(k) for k in keys]
        return self._ckeys

    def _invalidate(self):
        self._cum_dirty = True

    def _cum(self) -> np.ndarray:
        """Cached cumulative cardinalities per bucket
        (Roaring64NavigableMap.java:66-72)."""
        if self._cum_dirty:
            keys = self._sorted_keys()
            cards = np.array(
                [self._buckets[k].get_cardinality() for k in keys], dtype=np.int64
            )
            self._cum_cards = np.cumsum(cards) if keys else np.empty(0, dtype=np.int64)
            self._cum_dirty = False
        return self._cum_cards

    def _bucket_for_add(self, high: int) -> RoaringBitmap:
        b = self._buckets.get(high)
        if b is None:
            b = self.supplier()
            self._buckets[high] = b
            self._keys_dirty = True
        return b

    # ------------------------------------------------------------------
    # construction / point ops
    # ------------------------------------------------------------------
    @staticmethod
    def bitmap_of(*values: int) -> "Roaring64NavigableMap":
        return Roaring64NavigableMap(values)

    def add(self, x: int) -> None:
        """addLong (Roaring64NavigableMap.java:50)."""
        x = _check64(x)
        self._bucket_for_add(x >> 32).add(x & 0xFFFFFFFF)
        self._invalidate()

    def add_many(self, values: Iterable[int]) -> None:
        for high, lows in group_by_high(values, 32):
            self._bucket_for_add(high).add_many(lows.astype(np.uint32))
        self._invalidate()

    def remove(self, x: int) -> None:
        x = _check64(x)
        high = x >> 32
        b = self._buckets.get(high)
        if b is None:
            return
        b.remove(x & 0xFFFFFFFF)
        if b.is_empty():
            del self._buckets[high]
            self._keys_dirty = True
        self._invalidate()

    def contains(self, x: int) -> bool:
        x = _check64(x)
        b = self._buckets.get(x >> 32)
        return b is not None and b.contains(x & 0xFFFFFFFF)

    def contains_many(self, values) -> np.ndarray:
        """Vectorized membership: bool array parallel to ``values`` — the
        64-bit twin of ``RoaringBitmap.contains_many``, one vectorized
        bucket probe per distinct high-32 key (bucketed_membership)."""

        def probe(high, lows):
            b = self._buckets.get(high)
            return None if b is None else b.contains_many(lows.astype(np.uint32))

        return bucketed_membership(values, 32, probe)

    @staticmethod
    def _chunk_ranges(start: int, end: int):
        return chunk_ranges_64(start, end, 32)

    def _drop_if_empty(self, h: int) -> None:
        if h in self._buckets and self._buckets[h].is_empty():
            del self._buckets[h]
            self._keys_dirty = True

    def add_range(self, start: int, end: int) -> None:
        """Add [start, end) (Roaring64NavigableMap range add :1460)."""
        for h, lo, hi in self._chunk_ranges(start, end):
            self._bucket_for_add(h).add_range(lo, hi)
        self._invalidate()

    def remove_range(self, start: int, end: int) -> None:
        for h, lo, hi in self._chunk_ranges(start, end):
            b = self._buckets.get(h)
            if b is not None:
                b.remove_range(lo, hi)
                self._drop_if_empty(h)
        self._invalidate()

    def flip_range(self, start: int, end: int) -> None:
        """Flip [start, end) (Roaring64NavigableMap.flip :1530)."""
        for h, lo, hi in self._chunk_ranges(start, end):
            b = self._bucket_for_add(h)
            b.flip_range(lo, hi)
            self._drop_if_empty(h)
        self._invalidate()

    # ------------------------------------------------------------------
    # algebra (in-place, Java-style: Roaring64NavigableMap.java:773-935)
    # ------------------------------------------------------------------
    def ior(self, other: "Roaring64NavigableMap") -> "Roaring64NavigableMap":
        for h, ob in other._buckets.items():
            mine = self._buckets.get(h)
            if mine is None:
                self._buckets[h] = ob.clone()
                self._keys_dirty = True
            else:
                mine.ior(ob)
        self._invalidate()
        return self

    def iand(self, other: "Roaring64NavigableMap") -> "Roaring64NavigableMap":
        for h in list(self._buckets):
            ob = other._buckets.get(h)
            if ob is None:
                del self._buckets[h]
                self._keys_dirty = True
            else:
                mine = self._buckets[h]
                mine.iand(ob)
                if mine.is_empty():
                    del self._buckets[h]
                    self._keys_dirty = True
        self._invalidate()
        return self

    def ixor(self, other: "Roaring64NavigableMap") -> "Roaring64NavigableMap":
        # snapshot: other may alias self (x ^= x), and emptied buckets are
        # deleted from self._buckets during the walk
        for h, ob in list(other._buckets.items()):
            mine = self._buckets.get(h)
            if mine is None:
                self._buckets[h] = ob.clone()
                self._keys_dirty = True
            else:
                mine.ixor(ob)
                if mine.is_empty():
                    del self._buckets[h]
                    self._keys_dirty = True
        self._invalidate()
        return self

    def iandnot(self, other: "Roaring64NavigableMap") -> "Roaring64NavigableMap":
        for h in list(self._buckets):
            ob = other._buckets.get(h)
            if ob is not None:
                mine = self._buckets[h]
                mine.iandnot(ob)
                if mine.is_empty():
                    del self._buckets[h]
                    self._keys_dirty = True
        self._invalidate()
        return self

    # Java naming aliases
    or_inplace = ior
    and_inplace = iand
    xor_inplace = ixor
    andnot_inplace = iandnot

    def naive_lazy_or(self, other: "Roaring64NavigableMap") -> "Roaring64NavigableMap":
        """naivelazyor (Roaring64NavigableMap.java:730). The rank caches
        here are already invalidated lazily and rebuilt on demand, so the
        lazy protocol is structurally free: this IS ior."""
        return self.ior(other)

    naivelazyor = naive_lazy_or  # exact reference spelling

    def repair_after_lazy(self) -> None:
        """repairAfterLazy (Roaring64NavigableMap.java:1160) — a no-op:
        cumulative cardinalities rebuild on next rank/select."""

    @staticmethod
    def or_(a: "Roaring64NavigableMap", b: "Roaring64NavigableMap") -> "Roaring64NavigableMap":
        return a.clone().ior(b)

    @staticmethod
    def and_(a: "Roaring64NavigableMap", b: "Roaring64NavigableMap") -> "Roaring64NavigableMap":
        return a.clone().iand(b)

    @staticmethod
    def xor(a: "Roaring64NavigableMap", b: "Roaring64NavigableMap") -> "Roaring64NavigableMap":
        return a.clone().ixor(b)

    @staticmethod
    def andnot(a: "Roaring64NavigableMap", b: "Roaring64NavigableMap") -> "Roaring64NavigableMap":
        return a.clone().iandnot(b)

    __or__ = lambda self, o: Roaring64NavigableMap.or_(self, o)
    __and__ = lambda self, o: Roaring64NavigableMap.and_(self, o)
    __xor__ = lambda self, o: Roaring64NavigableMap.xor(self, o)
    __sub__ = lambda self, o: Roaring64NavigableMap.andnot(self, o)
    __ior__ = ior
    __iand__ = iand
    __ixor__ = ixor
    __isub__ = iandnot

    def intersects(self, other: "Roaring64NavigableMap") -> bool:
        for h, b in self._buckets.items():
            ob = other._buckets.get(h)
            if ob is not None and RoaringBitmap.intersects(b, ob):
                return True
        return False

    # ------------------------------------------------------------------
    # cardinality / order statistics
    # ------------------------------------------------------------------
    def get_cardinality(self) -> int:
        """getLongCardinality — served from the cached cumulative
        cardinalities (Roaring64NavigableMap.java:66-72), so repeat calls
        between writes are O(1)."""
        cum = self._cum()
        return int(cum[-1]) if len(cum) else 0

    def is_empty(self) -> bool:
        return not self._buckets

    def rank(self, x: int) -> int:
        """rankLong (Roaring64NavigableMap.java:351)."""
        from ..utils.order_stats import bucketed_rank

        x = _check64(x)
        high, low = x >> 32, x & 0xFFFFFFFF
        keys = self._sorted_keys()
        kt = self._comparator_keys()  # bisect in comparator order
        return bucketed_rank(
            kt, self._cum(), self._key_order(high),
            lambda i: self._buckets[keys[i]].rank(low),
        )

    def rank_many(self, values) -> np.ndarray:
        """Bulk rankLong: int64 counts aligned with ``values`` — one
        vectorized bucket resolution in comparator order plus one 32-bit
        ``rank_many`` per touched bucket (the bulk twin of rank; the
        reference answers order statistics one rankLong at a time,
        Roaring64NavigableMap.java:351). Negative ints are taken as their
        two's-complement bit patterns, like contains_many."""
        from ..utils.order_stats import bucketed_rank_many

        vals = np.asarray(values).astype(np.uint64, copy=False).ravel()
        if vals.size == 0 or not self._buckets:
            return np.zeros(vals.size, dtype=np.int64)
        keys = self._sorted_keys()
        if self._ckeys_arr is None:  # cached int64 comparator keys
            self._ckeys_arr = np.array(self._comparator_keys(), dtype=np.int64)
        kt = self._ckeys_arr
        highs = (vals >> np.uint64(32)).astype(np.int64)
        ch = (
            np.where(highs >= (1 << 31), highs - _MAX32, highs)
            if self.signed_longs
            else highs
        )
        lows = (vals & np.uint64(0xFFFFFFFF)).astype(np.int64)

        def in_bucket(i, pos):
            bucket = self._buckets[keys[i]]
            if pos.size < 8:
                # scattered probes (one or two per bucket): the scalar walk
                # beats the vectorized path's per-call numpy setup
                return np.array(
                    [bucket.rank_long(int(v)) for v in lows[pos]], dtype=np.int64
                )
            return bucket.rank_many(lows[pos])

        return bucketed_rank_many(kt, self._cum(), ch, in_bucket)

    def select_many(self, ranks) -> np.ndarray:
        """Bulk selectLong: uint64 values at the given comparator-order
        ranks, one vectorized bucket resolution plus one 32-bit
        ``select_many`` per touched bucket (bulk twin of select)."""
        from ..utils.order_stats import bucketed_select_many

        keys = self._sorted_keys()
        return bucketed_select_many(
            self._cum(),
            ranks,
            lambda i, js: (np.uint64(keys[i]) << np.uint64(32))
            | self._buckets[keys[i]].select_many(js).astype(np.uint64),
        )

    def select(self, j: int) -> int:
        """selectLong (Roaring64NavigableMap.java:473)."""
        from ..utils.order_stats import bucketed_select

        keys = self._sorted_keys()
        return bucketed_select(
            keys,
            self._cum(),
            j,
            lambda i, lj: (keys[i] << 32) | self._buckets[keys[i]].select(lj),
        )

    def first(self) -> int:
        if self.is_empty():
            raise ValueError("empty bitmap")
        k = self._sorted_keys()[0]
        return (k << 32) | self._buckets[k].first()

    def last(self) -> int:
        if self.is_empty():
            raise ValueError("empty bitmap")
        k = self._sorted_keys()[-1]
        return (k << 32) | self._buckets[k].last()

    def next_value(self, from_value: int) -> int:
        """Smallest value >= from_value, or -1."""
        from_value = _check64(from_value)
        high, low = from_value >> 32, from_value & 0xFFFFFFFF
        keys = self._sorted_keys()
        kt = self._comparator_keys()
        for i in range(bisect_left(kt, self._key_order(high)), len(keys)):
            k = keys[i]
            v = self._buckets[k].next_value(low if k == high else 0)
            if v >= 0:
                return (k << 32) | v
        return -1

    def previous_value(self, from_value: int) -> int:
        from_value = _check64(from_value)
        high, low = from_value >> 32, from_value & 0xFFFFFFFF
        keys = self._sorted_keys()
        kt = self._comparator_keys()
        for i in range(bisect_right(kt, self._key_order(high)) - 1, -1, -1):
            k = keys[i]
            v = self._buckets[k].previous_value(low if k == high else _MAX32 - 1)
            if v >= 0:
                return (k << 32) | v
        return -1

    # ------------------------------------------------------------------
    # structure
    # ------------------------------------------------------------------
    def run_optimize(self) -> bool:
        changed = False
        for b in self._buckets.values():
            changed |= b.run_optimize()
        return changed

    def clone(self) -> "Roaring64NavigableMap":
        out = Roaring64NavigableMap(signed_longs=self.signed_longs, supplier=self.supplier)
        out._buckets = {h: b.clone() for h, b in self._buckets.items()}
        out._keys_dirty = True
        return out

    def to_array(self) -> np.ndarray:
        """All values, unsigned-sorted, as uint64."""
        keys = self._sorted_keys()
        if not keys:
            return np.empty(0, dtype=np.uint64)
        parts = [
            self._buckets[k].to_array().astype(np.uint64) | np.uint64(k << 32)
            for k in keys
        ]
        return np.concatenate(parts)

    def __iter__(self) -> Iterator[int]:
        for k in self._sorted_keys():
            base = k << 32
            for v in self._buckets[k]:
                yield base | v

    def get_high_to_bitmap_count(self) -> int:
        """Bucket count (getHighToBitmap().size() analogue)."""
        return len(self._buckets)

    # -- reference long-tail surface (Roaring64NavigableMap.java) ---------
    def add_int(self, x: int) -> None:
        """addInt: the int zero-extended to a long (Util.toUnsignedLong)."""
        self.add(int(x) & 0xFFFFFFFF)

    def get_int_cardinality(self) -> int:
        """getIntCardinality (:330): cardinality, if it fits a signed int."""
        card = self.get_cardinality()
        if card > (1 << 31) - 1:
            raise OverflowError("cardinality exceeds 32-bit int")
        return card

    def get_long_iterator(self) -> Iterator[int]:
        return iter(self)

    def get_reverse_long_iterator(self) -> Iterator[int]:
        for k in reversed(self._sorted_keys()):
            base = k << 32
            for v in reversed(self._buckets[k]):
                yield base | v

    def for_each(self, consumer) -> None:
        for v in self:
            consumer(v)

    def limit(self, max_cardinality: int) -> "Roaring64NavigableMap":
        """First max_cardinality values as a new map (limit analogue)."""
        out = Roaring64NavigableMap(signed_longs=self.signed_longs, supplier=self.supplier)
        remaining = int(max_cardinality)
        for k in self._sorted_keys():
            if remaining <= 0:
                break
            b = self._buckets[k]
            card = b.get_cardinality()
            take = b.clone() if card <= remaining else b.limit(remaining)
            out._buckets[k] = take
            out._keys_dirty = True
            remaining -= take.get_cardinality()
        return out

    def clear(self) -> None:
        """Empty in place (Roaring64NavigableMap.clear)."""
        self._buckets = {}
        self._keys = []
        self._ckeys = None
        self._keys_dirty = False
        self._invalidate()

    empty = clear  # reference also exposes empty()

    def trim(self) -> None:
        """No-op: numpy storage is exact-sized."""

    def get_size_in_bytes(self) -> int:
        """In-memory estimate: bucket payloads + per-bucket key overhead."""
        return sum(8 + b.get_size_in_bytes() for b in self._buckets.values())

    get_long_size_in_bytes = get_size_in_bytes

    # ------------------------------------------------------------------
    # serialization (portable 64-bit spec)
    # ------------------------------------------------------------------
    def serialize(self, mode: Optional[int] = None) -> bytes:
        """Serialize in the active mode (legacy/portable switch,
        Roaring64NavigableMap.java:51 + serialize dispatch)."""
        if mode is None:
            mode = type(self).SERIALIZATION_MODE
        if mode == SERIALIZATION_MODE_LEGACY:
            return self.serialize_legacy()
        return self.serialize_portable()

    def serialize_portable(self) -> bytes:
        """Portable 64-bit spec (serializePortable): LE u64 count, per
        bucket LE u32 key + 32-bit spec bytes, unsigned key order."""
        import struct

        keys = sorted(self._buckets)  # portable order is always unsigned
        parts = [struct.pack("<Q", len(keys))]
        for k in keys:
            parts.append(struct.pack("<I", k))
            parts.append(self._buckets[k].serialize())
        return b"".join(parts)

    def serialize_legacy(self) -> bytes:
        """Legacy Java format (serializeLegacy): u8 bool signed_longs,
        BE i32 count, per bucket BE i32 key + 32-bit spec bytes, buckets in
        comparator order."""
        import struct

        keys = self._sorted_keys()
        parts = [struct.pack(">?i", self.signed_longs, len(keys))]
        for k in keys:
            parts.append(struct.pack(">i", k - _MAX32 if k >= (1 << 31) else k))
            parts.append(self._buckets[k].serialize())
        return b"".join(parts)

    def serialized_size_in_bytes(self, mode: Optional[int] = None) -> int:
        from ..serialization import serialized_size_in_bytes

        if mode is None:
            mode = type(self).SERIALIZATION_MODE
        header = 5 if mode == SERIALIZATION_MODE_LEGACY else 8
        return header + sum(
            4 + serialized_size_in_bytes(b) for b in self._buckets.values()
        )

    @staticmethod
    def deserialize(data, mode: Optional[int] = None) -> "Roaring64NavigableMap":
        if mode is None:
            mode = Roaring64NavigableMap.SERIALIZATION_MODE
        if mode == SERIALIZATION_MODE_LEGACY:
            return Roaring64NavigableMap.deserialize_legacy(data)
        return Roaring64NavigableMap.deserialize_portable(data)

    @staticmethod
    def _as_view(data) -> memoryview:
        return memoryview(
            bytes(data) if not isinstance(data, (bytes, bytearray, memoryview)) else data
        )

    @staticmethod
    def deserialize_portable(data) -> "Roaring64NavigableMap":
        import struct

        from ..serialization import read_into

        buf = Roaring64NavigableMap._as_view(data)
        if len(buf) < 8:
            raise InvalidRoaringFormat("truncated 64-bit header")
        (count,) = struct.unpack_from("<Q", buf, 0)
        if count > len(buf) // 4:  # each bucket needs >= 4 bytes of key alone
            raise InvalidRoaringFormat(f"implausible bucket count {count}")
        pos = 8
        out = Roaring64NavigableMap()
        prev_key = -1
        for _ in range(count):
            if pos + 4 > len(buf):
                raise InvalidRoaringFormat("truncated bucket key")
            (key,) = struct.unpack_from("<I", buf, pos)
            pos += 4
            if key <= prev_key:
                raise InvalidRoaringFormat("bucket keys not strictly increasing")
            prev_key = key
            bm = RoaringBitmap()
            pos += read_into(bm, buf[pos:])
            if not bm.is_empty():
                out._buckets[key] = bm
        out._keys_dirty = True
        return out

    def serialize_into(self, fileobj, mode: Optional[int] = None) -> int:
        """Stream overload (the Externalizable/DataOutput path,
        Roaring64NavigableMap.java writeExternal/serialize); returns bytes
        written. ``mode`` as in :meth:`serialize`."""
        data = self.serialize(mode)
        fileobj.write(data)
        return len(data)

    @staticmethod
    def deserialize_from(fileobj, mode: Optional[int] = None) -> "Roaring64NavigableMap":
        """Stream twin: consumes exactly one 64-bit map in the given (or
        active) mode, leaving the stream at the next byte — bucket payloads
        ride RoaringBitmap.deserialize_from's exact-consumption contract."""
        import struct

        from ..serialization import read_exact

        if mode is None:
            mode = Roaring64NavigableMap.SERIALIZATION_MODE
        legacy = mode == SERIALIZATION_MODE_LEGACY
        header = read_exact(fileobj, 5 if legacy else 8)
        if legacy:
            signed, count = struct.unpack(">?i", header)
            if count < 0:
                raise InvalidRoaringFormat(f"implausible bucket count {count}")
            out = Roaring64NavigableMap(signed_longs=signed)
        else:
            (count,) = struct.unpack("<Q", header)
            if count > (1 << 32):
                raise InvalidRoaringFormat(f"implausible bucket count {count}")
            out = Roaring64NavigableMap()
        prev_key = -1
        for _ in range(count):
            key_raw = read_exact(fileobj, 4)
            if legacy:
                (key,) = struct.unpack(">i", key_raw)
                key &= 0xFFFFFFFF  # stored two's-complement
                if key in out._buckets:
                    raise InvalidRoaringFormat("duplicate bucket key")
            else:
                (key,) = struct.unpack("<I", key_raw)
                if key <= prev_key:
                    raise InvalidRoaringFormat("bucket keys not strictly increasing")
                prev_key = key
            bm = RoaringBitmap.deserialize_from(fileobj)
            if not bm.is_empty():
                out._buckets[key] = bm
        out._keys_dirty = True
        return out

    @staticmethod
    def deserialize_legacy(data) -> "Roaring64NavigableMap":
        import struct

        from ..serialization import read_into

        buf = Roaring64NavigableMap._as_view(data)
        if len(buf) < 5:
            raise InvalidRoaringFormat("truncated legacy 64-bit header")
        signed, count = struct.unpack_from(">?i", buf, 0)
        if count < 0 or count > len(buf) // 4:
            raise InvalidRoaringFormat(f"implausible bucket count {count}")
        pos = 5
        out = Roaring64NavigableMap(signed_longs=signed)
        for _ in range(count):
            if pos + 4 > len(buf):
                raise InvalidRoaringFormat("truncated bucket key")
            (key,) = struct.unpack_from(">i", buf, pos)
            pos += 4
            key &= 0xFFFFFFFF  # stored two's-complement
            if key in out._buckets:
                raise InvalidRoaringFormat("duplicate bucket key")
            bm = RoaringBitmap()
            pos += read_into(bm, buf[pos:])
            if not bm.is_empty():
                out._buckets[key] = bm
        out._keys_dirty = True
        return out

    # ------------------------------------------------------------------
    def __eq__(self, other):
        if not isinstance(other, Roaring64NavigableMap):
            return NotImplemented
        if set(self._buckets) != set(other._buckets):
            return False
        return all(b == other._buckets[h] for h, b in self._buckets.items())

    def __hash__(self):
        return hash(self.to_array().tobytes())

    def __len__(self) -> int:
        return self.get_cardinality()

    def __contains__(self, x: int) -> bool:
        return self.contains(x)

    def __bool__(self) -> bool:
        return not self.is_empty()

    def __repr__(self) -> str:
        card = self.get_cardinality()
        head = ",".join(str(v) for v in self.to_array()[:8].tolist())
        return f"Roaring64NavigableMap(card={card}, values=[{head}{'...' if card > 8 else ''}])"

    # reference facade naming aliases (Roaring64NavigableMap.java addLong :50,
    # removeLong, getLongCardinality) for drop-in familiarity
    add_long = add
    remove_long = remove
    contains_long = contains
    get_long_cardinality = get_cardinality

    def __reduce__(self):
        """Pickle via the active SERIALIZATION_MODE wire format (the
        Externalizable analogue, Roaring64NavigableMap.java:35-52).
        signed_longs and the bucket supplier are config, not wire state,
        so they ride alongside the bytes."""
        mode = Roaring64NavigableMap.SERIALIZATION_MODE
        supplier = None if self.supplier is RoaringBitmap else self.supplier
        return _r64nm_unpickle, (self.serialize(mode), mode, self.signed_longs, supplier)


def _r64nm_unpickle(blob, mode, signed, supplier=None):
    out = Roaring64NavigableMap.deserialize(blob, mode)
    out.signed_longs = signed
    if supplier is not None:
        out.supplier = supplier
        # re-adopt the deserialized buckets into the supplier's type so the
        # BitmapDataProviderSupplier contract survives the round trip
        for k, b in out._buckets.items():
            nb = supplier()
            nb.high_low_container = b.high_low_container
            out._buckets[k] = nb
    return out
