"""Buffer-package BSI twin: ``MutableBitSliceIndex``
(bsi/buffer/MutableBitSliceIndex.java:20, shared base
BitSliceIndexBase.java:30).

Counterpart of the JAX package's ``models/bsi_buffer.py``. The heap/buffer
split collapses here as it does there, so the Mutable twin IS the 32-bit BSI
(``models/bsi.py``) with the buffer API's method names, and its range
queries run through the same device engine.

Left out here: ``ImmutableBitSliceIndex`` and its lazy zero-copy map of the
BSI wire format, which view slices as ``ImmutableRoaringBitmap``s; they
come with the port of ``models/immutable.py``.

The reference's fork-join variants (``parallelIn``
BitSliceIndexBase.java:611, ``parallelTransposeWithCount`` :578) map to the
batched device engine: the O'Neil chain is already one kernel launch over
all key chunks at once, which *is* the parallel evaluation — the
``parallelism`` argument is accepted for API compatibility and ignored.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .bsi import Operation, RoaringBitmapSliceIndex, transpose_value_counts
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

    @staticmethod
    def deserialize(data) -> "MutableBitSliceIndex":
        base = RoaringBitmapSliceIndex.deserialize(data)
        out = MutableBitSliceIndex()
        out.__dict__.update(base.__dict__)
        return out
