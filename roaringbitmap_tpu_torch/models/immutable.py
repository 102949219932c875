"""Zero-copy read path: the buffer/memory-map package analogue.

Counterpart of the JAX package's ``models/immutable.py``. The reference's
``buffer`` package re-implements every container over ``java.nio`` buffers
so serialized bitmaps can be queried without deserialization
(ImmutableRoaringBitmap: "only metadata in RAM", README.md:244-247;
ImmutableRoaringArray.java:43-53 parses the cookie and computes offsets,
containers are buffer slices).

``np.frombuffer`` views over ``bytes``/``mmap`` ARE the Mappeable
containers here — the same container classes as the heap path, zero copy,
no twin hierarchy. This module parses only the header (keys,
cardinalities, offsets) eagerly; container payloads stay views into the
source buffer and are wrapped lazily on access. The device engines pack a
mapped bitmap's containers straight from those views.

A view into a serialized buffer is read-only when the buffer is (``bytes``,
a read-only ``mmap``), and its words need not be aligned: an array
container's payload is 2·card bytes, so the next bitmap container may start
at any even offset. The native host tier reads its inputs through
one-byte-aligned types, and the pack copies the views into its own staging
before a tensor is made of them.
"""

from __future__ import annotations

import mmap as _mmap
import struct
from bisect import bisect_left
from typing import Iterator, Optional, Union

import numpy as np

from ..serialization import (
    NO_OFFSET_THRESHOLD,
    SERIAL_COOKIE,
    SERIAL_COOKIE_NO_RUNCONTAINER,
    InvalidRoaringFormat,
)
from ..utils.order_stats import bucketed_rank, bucketed_select
from .container import ARRAY_MAX_SIZE, ArrayContainer, BitmapContainer, Container, RunContainer
from .roaring import RoaringBitmap

Source = Union[bytes, bytearray, memoryview, _mmap.mmap, np.ndarray]


class ImmutableRoaringArray:
    """PointableRoaringArray over a mapped bitmap
    (buffer/ImmutableRoaringArray.java:43, PointableRoaringArray.java:15):
    the key index lives in the parsed header; containers are materialized
    lazily as zero-copy buffer views (memoized) so the whole pairwise and
    N-way algebra runs directly on the serialized form. It has no
    generation, so its fingerprint is ``("static", id(self))``."""

    __slots__ = ("_bm", "keys", "_cache", "containers")

    def __init__(self, bm: "ImmutableRoaringBitmap"):
        self._bm = bm
        self.keys = bm._keys_list
        self._cache: dict = {}
        self.containers = _LazyContainers(self)

    @property
    def size(self) -> int:
        return self._bm._size

    def get_index(self, key: int) -> int:
        i = bisect_left(self.keys, key)
        if i < self._bm._size and self.keys[i] == key:
            return i
        return -i - 1

    def get_key_at_index(self, i: int) -> int:
        return self.keys[i]

    def get_container_at_index(self, i: int) -> Container:
        c = self._cache.get(i)
        if c is None:
            c = self._bm._build_container(i)
            self._cache[i] = c
        return c

    def advance_until(self, key: int, pos: int) -> int:
        """First index after ``pos`` whose key is >= ``key`` (advanceUntil,
        PointableRoaringArray.java:25)."""
        return bisect_left(self.keys, key, pos + 1)

    def get_container(self, key: int) -> Optional[Container]:
        i = self.get_index(key)
        return self.get_container_at_index(i) if i >= 0 else None

    def items(self):
        return [(self.keys[i], self.get_container_at_index(i)) for i in range(self.size)]


class _LazyContainers:
    """Sequence view over an ImmutableRoaringArray's containers."""

    __slots__ = ("_arr",)

    def __init__(self, arr: ImmutableRoaringArray):
        self._arr = arr

    def __len__(self):
        return self._arr.size

    def __getitem__(self, i):
        return self._arr.get_container_at_index(i)

    def __iter__(self):
        for i in range(self._arr.size):
            yield self._arr.get_container_at_index(i)


class ImmutableRoaringBitmap:
    """Read-only bitmap over a serialized buffer (buffer/ImmutableRoaringBitmap).

    Constructor cost is O(#containers) header parsing; container payloads are
    zero-copy numpy views into the source buffer."""

    __slots__ = ("_buf", "_keys", "_keys_list", "_cards", "_types", "_offsets", "_size", "_hlc", "_ro", "_cum")

    ARRAY, BITMAP, RUN = 0, 1, 2

    # Read-only facade methods borrowed from RoaringBitmap via __getattr__:
    # they run zero-copy over the mapped containers (the high_low_container
    # duck type), covering the reference ImmutableRoaringBitmap query
    # surface without a second twin class.
    _DELEGATED_READS = frozenset(
        {
            # identity token for the result and pack caches: the mapped
            # array never mutates, so ("static", id) is stable for the life
            # of this object (the facade shares one high_low_container)
            "fingerprint",
            "rank_long",
            "next_value",
            "previous_value",
            "next_absent_value",
            "previous_absent_value",
            "first_signed",
            "last_signed",
            "cardinality_exceeds",
            "contains_range",
            "intersects_range",
            "range_cardinality",
            "limit",
            "select_range",
            "has_run_compression",
            "is_hamming_similar",
            "contains_bitmap",
            "get_int_iterator",
            "get_reverse_int_iterator",
            "get_int_rank_iterator",
            "get_batch_iterator",
            "batch_iterator",
            "get_signed_int_iterator",
            "for_each",
            "for_each_in_range",
            "for_all_in_range",
            "get_container_pointer",
            "trim",
        }
    )

    def __init__(self, source: Source, offset: int = 0):
        if isinstance(source, np.ndarray):
            # a contiguous array maps zero-copy; any other is copied once
            source = source.data if source.flags["C_CONTIGUOUS"] else source.tobytes()
        buf = memoryview(source).cast("B")[offset:]
        self._buf = buf
        pos = 0
        if len(buf) < 4:
            raise InvalidRoaringFormat("truncated input")
        (cookie,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        if (cookie & 0xFFFF) == SERIAL_COOKIE:
            size = (cookie >> 16) + 1
            marker_len = (size + 7) // 8
            if pos + marker_len > len(buf):
                raise InvalidRoaringFormat("truncated run marker")
            run_marker = bytes(buf[pos : pos + marker_len])
            pos += marker_len
            has_run = True
        elif cookie == SERIAL_COOKIE_NO_RUNCONTAINER:
            if pos + 4 > len(buf):
                raise InvalidRoaringFormat("truncated size")
            (size,) = struct.unpack_from("<I", buf, pos)
            pos += 4
            has_run = False
            run_marker = b""
        else:
            raise InvalidRoaringFormat(f"invalid cookie {cookie}")
        if size > 1 << 16 or pos + 4 * size > len(buf):
            raise InvalidRoaringFormat("implausible container count")
        desc = np.frombuffer(buf, dtype="<u2", count=2 * size, offset=pos)
        pos += 4 * size
        self._keys = desc[0::2].astype(np.int64)
        # Python-list twin for scalar probes: bisect on a list is much
        # cheaper than a scalar np.searchsorted
        self._keys_list = self._keys.tolist()
        self._cards = desc[1::2].astype(np.int64) + 1
        if size and np.any(np.diff(self._keys) <= 0):
            raise InvalidRoaringFormat("container keys not strictly increasing")

        types = np.empty(size, dtype=np.int8)
        for i in range(size):
            if has_run and run_marker[i // 8] & (1 << (i % 8)):
                types[i] = self.RUN
            elif self._cards[i] > ARRAY_MAX_SIZE:
                types[i] = self.BITMAP
            else:
                types[i] = self.ARRAY
        self._types = types

        if (not has_run) or size >= NO_OFFSET_THRESHOLD:
            if pos + 4 * size > len(buf):
                raise InvalidRoaringFormat("truncated offset header")
            self._offsets = np.frombuffer(buf, dtype="<u4", count=size, offset=pos).astype(np.int64)
            pos += 4 * size
        else:
            # few containers: walk the payloads for their offsets
            offsets = np.empty(size, dtype=np.int64)
            p = pos
            for i in range(size):
                offsets[i] = p
                p += self._payload_len(i, p)
            self._offsets = offsets
        self._size = size
        self._hlc = None
        self._cum = None
        for i in range(size):
            end = self._offsets[i] + self._payload_len(i, int(self._offsets[i]))
            if end > len(buf):
                raise InvalidRoaringFormat("container payload out of bounds")

    def _payload_len(self, i: int, at: int) -> int:
        t = self._types[i]
        if t == self.BITMAP:
            return 8192
        if t == self.ARRAY:
            return 2 * int(self._cards[i])
        if at + 2 > len(self._buf):
            raise InvalidRoaringFormat("truncated run container")
        (n_runs,) = struct.unpack_from("<H", self._buf, at)
        return 2 + 4 * n_runs

    # ------------------------------------------------------------------
    def _container(self, i: int) -> Container:
        """Zero-copy container view, memoized through the
        high_low_container's cache."""
        return self.high_low_container.get_container_at_index(i)

    def _build_container(self, i: int) -> Container:
        """A fresh zero-copy container view (the cache fill path).

        All three payload kinds stay views into the source buffer: bitmap
        words, array values, and run (start, length) slices — strided
        views ``pairs[0::2]`` / ``pairs[1::2]`` (MappeableRunContainer.java's
        buffer-view contract). The run-space interval kernels consume them
        directly; the payload build concatenates them into contiguous
        arrays before native code or a tensor reads them. Only the one-time
        hostile-payload
        check of a run container reads its pages here. The views are the
        heap path's own container classes, which the pack dispatches on by
        exact class."""
        off = int(self._offsets[i])
        t = self._types[i]
        if t == self.BITMAP:
            words = np.frombuffer(self._buf, dtype="<u8", count=1024, offset=off)
            return BitmapContainer(words, int(self._cards[i]))
        if t == self.ARRAY:
            values = np.frombuffer(self._buf, dtype="<u2", count=int(self._cards[i]), offset=off)
            return ArrayContainer(values)
        (n_runs,) = struct.unpack_from("<H", self._buf, off)
        pairs = np.frombuffer(self._buf, dtype="<u2", count=2 * n_runs, offset=off + 2)
        starts, lengths = pairs[0::2], pairs[1::2]
        # the heap deserializer's checks: sorted disjoint runs inside the
        # 2^16 universe
        s64 = starts.astype(np.int64)
        ends = s64 + lengths.astype(np.int64)
        if n_runs and (np.any(s64[1:] <= ends[:-1]) or np.any(ends > 0xFFFF)):
            raise InvalidRoaringFormat("invalid run container")
        return RunContainer(starts, lengths)

    # ------------------------------------------------------------------
    # read API (ImmutableBitmapDataProvider surface)
    # ------------------------------------------------------------------
    @property
    def high_low_container(self) -> ImmutableRoaringArray:
        """Zero-copy PointableRoaringArray view, built once: it makes a
        mapped bitmap an operand of every pairwise op and aggregation
        engine, and its identity is the pack cache's static fingerprint."""
        if self._hlc is None:
            self._hlc = ImmutableRoaringArray(self)
        return self._hlc

    def clone(self) -> RoaringBitmap:
        """Deep copy; the writable result matches the engines' contract that
        ``clone()`` of an operand may be mutated."""
        return self.to_mutable()

    def get_size_in_bytes(self) -> int:
        if not self._size:
            return 8
        return int(self._offsets[-1]) + self._payload_len(self._size - 1, int(self._offsets[-1]))

    def serialized_size_in_bytes(self) -> int:
        return self.get_size_in_bytes()

    # -- mixed-operand pairwise algebra (buffer/ImmutableRoaringBitmap
    #    statics; operands may be heap RoaringBitmap or mapped) ----------
    @staticmethod
    def and_(x1, x2) -> RoaringBitmap:
        return RoaringBitmap.and_(x1, x2)

    @staticmethod
    def or_(x1, x2) -> RoaringBitmap:
        return RoaringBitmap.or_(x1, x2)

    @staticmethod
    def xor(x1, x2) -> RoaringBitmap:
        return RoaringBitmap.xor(x1, x2)

    @staticmethod
    def andnot(x1, x2) -> RoaringBitmap:
        return RoaringBitmap.andnot(x1, x2)

    @staticmethod
    def and_cardinality(x1, x2) -> int:
        return RoaringBitmap.and_cardinality(x1, x2)

    @staticmethod
    def or_cardinality(x1, x2) -> int:
        return RoaringBitmap.or_cardinality(x1, x2)

    @staticmethod
    def intersects(x1, x2) -> bool:
        return RoaringBitmap.intersects(x1, x2)

    def get_cardinality(self) -> int:
        return int(self._cards.sum())

    def is_empty(self) -> bool:
        return self._size == 0

    def get_container_count(self) -> int:
        return self._size

    def contains(self, x: int) -> bool:
        x = int(x)
        if not 0 <= x < 1 << 32:
            return False
        keys = self._keys_list
        key = x >> 16
        i = bisect_left(keys, key)
        if i == self._size or keys[i] != key:
            return False
        return self._container(i).contains(x & 0xFFFF)

    def rank(self, x: int) -> int:
        x = int(x)
        hb, lb = x >> 16, x & 0xFFFF
        return bucketed_rank(self._keys_list, self._cum_cards(), hb, lambda i: self._container(i).rank(lb))

    def select(self, j: int) -> int:
        return bucketed_select(
            self._keys_list,
            self._cum_cards(),
            j,
            lambda i, lj: (int(self._keys[i]) << 16) | self._container(i).select(lj),
        )

    # bulk probes shared with the heap facade: ImmutableRoaringArray has the
    # same keys/containers surface
    contains_many = RoaringBitmap.contains_many
    rank_many = RoaringBitmap.rank_many
    select_many = RoaringBitmap.select_many

    def _cum_cards(self) -> np.ndarray:
        # header cardinalities, summed once: no payload decode
        if self._cum is None:
            self._cum = np.cumsum(np.asarray(self._cards, dtype=np.int64))
        return self._cum

    def first(self) -> int:
        if self.is_empty():
            raise ValueError("empty bitmap")
        return (int(self._keys[0]) << 16) | self._container(0).first()

    def last(self) -> int:
        if self.is_empty():
            raise ValueError("empty bitmap")
        return (int(self._keys[-1]) << 16) | self._container(self._size - 1).last()

    def to_array(self) -> np.ndarray:
        parts = [
            self._container(i).to_array().astype(np.uint32) + np.uint32(int(self._keys[i]) << 16)
            for i in range(self._size)
        ]
        return np.concatenate(parts) if parts else np.empty(0, dtype=np.uint32)

    def __iter__(self) -> Iterator[int]:
        for i in range(self._size):
            base = int(self._keys[i]) << 16
            for v in self._container(i).to_array().tolist():
                yield base | v

    def __contains__(self, x) -> bool:
        return self.contains(x)

    def __len__(self) -> int:
        return self.get_cardinality()

    def __eq__(self, other):
        if isinstance(other, (ImmutableRoaringBitmap, RoaringBitmap)):
            return np.array_equal(self.to_array(), other.to_array())
        return NotImplemented

    def __hash__(self):
        return hash(self.to_array().tobytes())

    # ------------------------------------------------------------------
    def _readonly_facade(self) -> RoaringBitmap:
        """A RoaringBitmap whose high_low_container IS the mapped array —
        shared read-only view, no copy."""
        try:
            return self._ro
        except AttributeError:
            rb = RoaringBitmap.__new__(RoaringBitmap)
            rb.high_low_container = self.high_low_container
            self._ro = rb
            return rb

    def __getattr__(self, name):
        if name in ImmutableRoaringBitmap._DELEGATED_READS:
            return getattr(self._readonly_facade(), name)
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {name!r}"
            + (" (immutable: mutators unavailable)" if hasattr(RoaringBitmap, name) else "")
        )

    # -- statics mirroring the reference's (results are heap bitmaps) ------
    @staticmethod
    def bitmap_of(*values: int) -> "ImmutableRoaringBitmap":
        return ImmutableRoaringBitmap(RoaringBitmap.bitmap_of(*values).serialize())

    bitmap_of_unordered = bitmap_of

    @staticmethod
    def flip(bm, start: int, end: int) -> RoaringBitmap:
        return RoaringBitmap.flip(bm, start, end)

    @staticmethod
    def or_not(x1, x2, range_end: int) -> RoaringBitmap:
        return RoaringBitmap.or_not(x1, x2, range_end)

    @staticmethod
    def xor_cardinality(x1, x2) -> int:
        return RoaringBitmap.xor_cardinality(x1, x2)

    @staticmethod
    def andnot_cardinality(x1, x2) -> int:
        return RoaringBitmap.andnot_cardinality(x1, x2)

    def to_roaring_bitmap(self) -> RoaringBitmap:
        """Deep copy to a heap RoaringBitmap (toRoaringBitmap)."""
        return self.to_mutable()

    def to_mutable_roaring_bitmap(self):
        """Deep copy to the buffer-world mutable twin."""
        from .buffer import MutableRoaringBitmap

        return MutableRoaringBitmap.of(self)

    def to_mutable(self) -> RoaringBitmap:
        """Deep copy into a mutable RoaringBitmap
        (ImmutableRoaringBitmap.toMutableRoaringBitmap)."""
        out = RoaringBitmap()
        for i in range(self._size):
            out.high_low_container.append(int(self._keys[i]), self._container(i).clone())
        return out

    def serialize(self) -> bytes:
        """The serialized form IS the backing buffer (one copy of its
        extent)."""
        return bytes(self._buf[: self.get_size_in_bytes()])

    @staticmethod
    def map_file(path: str) -> "ImmutableRoaringBitmap":
        """Memory-map a serialized bitmap file read-only (the
        MemoryMappingExample analogue): the OS pages container payloads in
        on demand."""
        with open(path, "rb") as f:
            mm = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
        return ImmutableRoaringBitmap(mm)

    def __reduce__(self):
        """Pickle as owned serialized bytes (an mmap or view source is not
        picklable)."""
        return ImmutableRoaringBitmap, (self.serialize(),)

    def __repr__(self):
        return f"ImmutableRoaringBitmap(card={self.get_cardinality()}, containers={self._size})"
