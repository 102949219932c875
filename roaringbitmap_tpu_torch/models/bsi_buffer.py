"""Buffer-package BSI twins: ``MutableBitSliceIndex`` /
``ImmutableBitSliceIndex`` (bsi/buffer/MutableBitSliceIndex.java:20,
ImmutableBitSliceIndex.java:17, shared base BitSliceIndexBase.java:30).

Counterpart of the JAX package's ``models/bsi_buffer.py``. The heap/buffer
split collapses here as it does there (``models/immutable.py`` says why:
numpy views already give zero copy over serialized bytes), so the Mutable
twin IS the 32-bit BSI (``models/bsi.py``) with the buffer API's method
names, and the Immutable twin wraps an index behind a mutation guard, or
maps the BSI wire format lazily: its existence bitmap and slices become
``ImmutableRoaringBitmap`` views into the source buffer, which the device
path packs (kind ``bsi`` in ``store.PACK_CACHE``) like heap slices.

The reference's fork-join variants (``parallelIn``
BitSliceIndexBase.java:611, ``parallelTransposeWithCount`` :578) map to the
batched device engine: the O'Neil chain is already one kernel launch over
all key chunks at once, which *is* the parallel evaluation — the
``parallelism`` argument is accepted for API compatibility and ignored.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from ..serialization import InvalidRoaringFormat
from .bsi import Operation, RoaringBitmapSliceIndex, transpose_value_counts, unpack_header
from .immutable import ImmutableRoaringBitmap
from .roaring import RoaringBitmap


class _RangeQueryAPI:
    """The shared query surface of BitSliceIndexBase.java:351-620 — the
    reference defines rangeEQ..range, parallelIn, and
    parallelTransposeWithCount once on the base the twins extend; this
    mixin is that base. Requires ``compare``/``get_existence_bitmap``/
    ``slices`` on self."""

    __slots__ = ()

    # range* named queries (BitSliceIndexBase.java:351-420)
    def range_eq(self, found_set: Optional[RoaringBitmap], predicate: int) -> RoaringBitmap:
        return self.compare(Operation.EQ, predicate, 0, found_set)

    def range_neq(self, found_set: Optional[RoaringBitmap], predicate: int) -> RoaringBitmap:
        return self.compare(Operation.NEQ, predicate, 0, found_set)

    def range_lt(self, found_set: Optional[RoaringBitmap], predicate: int) -> RoaringBitmap:
        return self.compare(Operation.LT, predicate, 0, found_set)

    def range_le(self, found_set: Optional[RoaringBitmap], predicate: int) -> RoaringBitmap:
        return self.compare(Operation.LE, predicate, 0, found_set)

    def range_gt(self, found_set: Optional[RoaringBitmap], predicate: int) -> RoaringBitmap:
        return self.compare(Operation.GT, predicate, 0, found_set)

    def range_ge(self, found_set: Optional[RoaringBitmap], predicate: int) -> RoaringBitmap:
        return self.compare(Operation.GE, predicate, 0, found_set)

    def range(self, found_set: Optional[RoaringBitmap], start: int, end: int) -> RoaringBitmap:
        return self.compare(Operation.RANGE, start, end, found_set)

    def parallel_in(
        self,
        parallelism: int,
        operation: Operation,
        start_or_value: int,
        end: int = 0,
        found_set: Optional[RoaringBitmap] = None,
    ) -> RoaringBitmap:
        """parallelIn (BitSliceIndexBase.java:611); parallelism is accepted
        for API compatibility."""
        return self.compare(operation, start_or_value, end, found_set)

    def parallel_transpose_with_count(
        self, found_set: Optional[RoaringBitmap] = None, parallelism: int = 0
    ) -> "MutableBitSliceIndex":
        """parallelTransposeWithCount (BitSliceIndexBase.java:578):
        value -> multiplicity BSI."""
        ebm = self.get_existence_bitmap()
        cols = (
            ebm if found_set is None else RoaringBitmap.and_(ebm, found_set)
        ).to_array()
        out = MutableBitSliceIndex()
        if cols.size == 0:
            return out
        uniq, counts = transpose_value_counts(cols, self.slices)
        out.set_values((uniq.astype(np.uint32), counts.astype(np.int64)))
        return out


class MutableBitSliceIndex(_RangeQueryAPI, RoaringBitmapSliceIndex):
    """bsi/buffer/MutableBitSliceIndex.java:20 — the mutable buffer twin."""

    get_long_cardinality = RoaringBitmapSliceIndex.get_cardinality

    def get_mutable_slice(self, i: int) -> RoaringBitmap:
        """getMutableSlice (MutableBitSliceIndex.java:136)."""
        return self.slices[i]

    def add_digit(self, found_set: RoaringBitmap, i: int) -> None:
        """addDigit (MutableBitSliceIndex.java:121)."""
        self._grow(i + 1)
        self._add_digit(found_set, i)

    def to_immutable_bit_slice_index(self) -> "ImmutableBitSliceIndex":
        """toImmutableBitSliceIndex (MutableBitSliceIndex.java:411) — O(1),
        shares structure (castable like Mutable->ImmutableRoaringBitmap)."""
        return ImmutableBitSliceIndex(self)

    @staticmethod
    def deserialize(data) -> "MutableBitSliceIndex":
        base = RoaringBitmapSliceIndex.deserialize(data)
        out = MutableBitSliceIndex()
        out.__dict__.update(base.__dict__)
        return out


class _LazySlices:
    """Sequence of slice bitmaps viewed zero-copy on first access — the
    Mappeable analogue of ImmutableBitSliceIndex's per-slice ByteBuffer
    views (ImmutableBitSliceIndex.java:52). Read-only: it has no
    ``append`` or item assignment, so a path that would grow or replace a
    slice fails instead of writing into the mapping."""

    __slots__ = ("_buf", "_extents", "_cache")

    def __init__(self, buf: memoryview, extents: List[Tuple[int, int]]):
        self._buf = buf
        self._extents = extents
        self._cache: dict = {}

    def __len__(self) -> int:
        return len(self._extents)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        if i < 0:
            i += len(self)
        got = self._cache.get(i)
        if got is None:
            off, ln = self._extents[i]
            got = ImmutableRoaringBitmap(self._buf[off : off + ln])
            self._cache[i] = got
        return got

    def __iter__(self):
        return (self[i] for i in range(len(self)))


def _map_bsi(buf: memoryview) -> RoaringBitmapSliceIndex:
    """Open the BSI wire format (``models/bsi.py`` serialize) as a lazy
    zero-copy index: the existence bitmap and each slice become
    ImmutableRoaringBitmap views. Construction costs one O(#containers)
    header parse per bitmap to find extents, with no payload copies."""
    if len(buf) < 9:
        raise InvalidRoaringFormat("truncated BSI header")
    min_v, max_v, ro = unpack_header(buf)
    pos = 9
    ebm = ImmutableRoaringBitmap(buf[pos:])
    pos += ebm.serialized_size_in_bytes()
    if pos + 4 > len(buf):
        raise InvalidRoaringFormat("truncated BSI slice count")
    (depth,) = struct.unpack_from("<i", buf, pos)
    pos += 4
    if depth < 0 or depth > 64:
        raise InvalidRoaringFormat(f"implausible BSI depth {depth}")
    extents: List[Tuple[int, int]] = []
    for _ in range(depth):
        # header-only parse to learn this slice's extent; the view is
        # built again lazily (and cached) on first real access
        ln = ImmutableRoaringBitmap(buf[pos:]).serialized_size_in_bytes()
        extents.append((pos, ln))
        pos += ln
    out = RoaringBitmapSliceIndex()
    out.min_value, out.max_value = min_v, max_v
    out.run_optimized = ro
    out.ebm = ebm
    out.slices = _LazySlices(buf, extents)
    return out


class ImmutableBitSliceIndex(_RangeQueryAPI):
    """bsi/buffer/ImmutableBitSliceIndex.java:17 — read-only view, either
    over an existing index (O(1) cast) or mapped zero-copy from a
    serialized buffer (ImmutableBitSliceIndex(ByteBuffer), :52): ``bytes``,
    ``bytearray``, ``memoryview``, ``mmap.mmap`` or a contiguous ndarray.
    Slice payloads stay in the source buffer and are viewed lazily. The
    query surface (rangeEQ..range, parallelIn, parallelTransposeWithCount)
    is the shared _RangeQueryAPI, as the reference defines it on the base
    both twins extend; queries run on the index's engines, the device path
    included."""

    __slots__ = ("_base",)

    def __init__(self, source):
        if isinstance(source, RoaringBitmapSliceIndex):
            self._base = source
            return
        if isinstance(source, np.ndarray):
            source = source.data if source.flags["C_CONTIGUOUS"] else source.tobytes()
        try:
            buf = memoryview(source).cast("B")
        except TypeError:
            buf = memoryview(bytes(source))
        self._base = _map_bsi(buf)

    # read surface delegates
    def bit_count(self) -> int:
        return self._base.bit_count()

    def get_long_cardinality(self) -> int:
        return self._base.get_cardinality()

    get_cardinality = get_long_cardinality

    @property
    def slices(self):
        """Read-only slice views (consumed by the shared query mixin)."""
        return self._base.slices

    def has_run_compression(self) -> bool:
        return self._base.has_run_compression()

    def get_value(self, column_id: int) -> Tuple[int, bool]:
        return self._base.get_value(column_id)

    def value_exist(self, column_id: int) -> bool:
        return self._base.value_exist(column_id)

    def get_existence_bitmap(self) -> RoaringBitmap:
        return self._base.ebm

    @property
    def min_value(self) -> int:
        return self._base.min_value

    @property
    def max_value(self) -> int:
        return self._base.max_value

    def compare(self, operation, start_or_value, end=0, found_set=None, mode=None):
        return self._base.compare(operation, start_or_value, end, found_set, mode)

    def compare_cardinality(self, operation, start_or_value, end=0, found_set=None, mode=None):
        return self._base.compare_cardinality(operation, start_or_value, end, found_set, mode)

    def compare_cardinality_many(self, operation, values, ends=None, found_set=None, mode=None):
        return self._base.compare_cardinality_many(operation, values, ends, found_set, mode)

    def sum(self, found_set=None):
        return self._base.sum(found_set)

    def top_k(self, found_set, k):
        return self._base.top_k(found_set, k)

    def transpose(self, found_set=None):
        return self._base.transpose(found_set)

    def to_pair_list(self, found_set=None):
        return self._base.to_pair_list(found_set)

    def serialize(self) -> bytes:
        return self._base.serialize()

    def serialize_into(self, fileobj) -> int:
        return self._base.serialize_into(fileobj)

    @staticmethod
    def deserialize_from(fileobj) -> "ImmutableBitSliceIndex":
        """Consume one BSI from the stream and wrap it read-only (the O(1)
        cast; a stream cannot be mapped the way a buffer can)."""
        return ImmutableBitSliceIndex(RoaringBitmapSliceIndex.deserialize_from(fileobj))

    def serialized_size_in_bytes(self) -> int:
        return self._base.serialized_size_in_bytes()

    def to_mutable_bit_slice_index(self) -> MutableBitSliceIndex:
        """Deep copy back to the mutable twin."""
        base = self._base.clone()
        out = MutableBitSliceIndex()
        out.__dict__.update(base.__dict__)
        return out

    # mutation guard
    def _refuse(self, *_a, **_k):
        raise TypeError("ImmutableBitSliceIndex does not support mutation")

    set_value = set_values = add = merge = run_optimize = add_digit = _refuse

    def __eq__(self, other):
        if isinstance(other, ImmutableBitSliceIndex):
            return self._base == other._base
        if isinstance(other, RoaringBitmapSliceIndex):
            return self._base == other
        return NotImplemented

    def __reduce__(self):
        return ImmutableBitSliceIndex, (self.serialize(),)

    def __repr__(self):
        return f"Immutable{self._base!r}"
