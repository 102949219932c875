"""Iterator layer: peekable point iterators and buffer-filling batch
iterators (reference: PeekableIntIterator.java, IntIteratorFlyweight.java,
ReverseIntIteratorFlyweight.java, PeekableIntRankIterator,
BatchIterator.java:12 ``nextBatch`` contract with ``advanceIfNeeded`` :72,
RoaringBatchIterator.java:19-28).

Counterpart of the JAX package's ``models/iterators.py``. Java's flyweights
exist to avoid per-value allocation in hot scalar loops; here the batch
iterator is the primary surface (it yields numpy arrays, the natural unit
for vectorized and device consumers) and the point iterators are thin
cursors over per-container arrays. Every iterator skips with
``advance_if_needed(minval)`` by a container-key bisect and an in-container
searchsorted, not by stepping. They walk any ``high_low_container``, a
mapped bitmap's lazy views included.
"""

from __future__ import annotations

from bisect import bisect_left
from typing import Optional

import numpy as np

from .roaring import RoaringBitmap


class PeekableIntIterator:
    """Forward iterator with peek + advance (PeekableIntIterator.java:90,
    flyweight IntIteratorFlyweight.java)."""

    __slots__ = ("_hlc", "_ci", "_arr", "_pos")

    def __init__(self, bm: RoaringBitmap):
        self._hlc = bm.high_low_container
        self._ci = 0
        self._arr: Optional[np.ndarray] = None
        self._pos = 0
        self._load()

    def _load(self) -> None:
        while self._ci < self._hlc.size:
            arr = self._hlc.containers[self._ci].to_array()
            if arr.size:
                self._arr = arr
                self._pos = 0
                return
            self._ci += 1
        self._arr = None

    def has_next(self) -> bool:
        return self._arr is not None

    def peek_next(self) -> int:
        """peekNext: next value without consuming it."""
        if self._arr is None:
            raise StopIteration
        return (self._hlc.keys[self._ci] << 16) | int(self._arr[self._pos])

    def next(self) -> int:
        v = self.peek_next()
        self._pos += 1
        if self._pos >= self._arr.size:
            self._ci += 1
            self._load()
        return v

    def advance_if_needed(self, minval: int) -> None:
        """Skip forward so the next value is >= minval (advanceIfNeeded):
        key bisect across containers + searchsorted within."""
        if self._arr is None:
            return
        key, low = minval >> 16, minval & 0xFFFF
        if self._hlc.keys[self._ci] < key:
            self._ci = bisect_left(self._hlc.keys, key, lo=self._ci)
            self._load()
            if self._arr is None:
                return
        if self._hlc.keys[self._ci] > key:
            return
        p = int(np.searchsorted(self._arr, np.uint16(low)))
        if self._pos < p:
            self._pos = p
            if self._pos >= self._arr.size:
                self._ci += 1
                self._load()

    def __iter__(self):
        return self

    def __next__(self) -> int:
        if self._arr is None:
            raise StopIteration
        return self.next()


class PeekableIntRankIterator(PeekableIntIterator):
    """Peekable iterator that also reports the rank of the next value
    (PeekableIntRankIterator; FastRank's iterator). Rank is derived in O(1)
    from the cursor position + a precomputed cumulative-cardinality table,
    not recomputed per call."""

    __slots__ = ("_cum",)

    def __init__(self, bm: RoaringBitmap):
        super().__init__(bm)
        cards = [c.cardinality for c in self._hlc.containers]
        self._cum = np.concatenate(([0], np.cumsum(cards))) if cards else np.zeros(1)

    def peek_next_rank(self) -> int:
        """1-based rank of the value peek_next() would return."""
        if self._arr is None:
            raise StopIteration
        return int(self._cum[self._ci]) + self._pos + 1


class ReverseIntIterator:
    """Descending iterator (ReverseIntIteratorFlyweight.java)."""

    __slots__ = ("_hlc", "_ci", "_arr", "_pos")

    def __init__(self, bm: RoaringBitmap):
        self._hlc = bm.high_low_container
        self._ci = self._hlc.size - 1
        self._arr: Optional[np.ndarray] = None
        self._load()

    def _load(self) -> None:
        while self._ci >= 0:
            arr = self._hlc.containers[self._ci].to_array()
            if arr.size:
                self._arr = arr
                self._pos = arr.size - 1
                return
            self._ci -= 1
        self._arr = None

    def has_next(self) -> bool:
        return self._arr is not None

    def next(self) -> int:
        if self._arr is None:
            raise StopIteration
        v = (self._hlc.keys[self._ci] << 16) | int(self._arr[self._pos])
        self._pos -= 1
        if self._pos < 0:
            self._ci -= 1
            self._load()
        return v

    def __iter__(self):
        return self

    __next__ = next


class RoaringBatchIterator:
    """Buffer-filling iterator (BatchIterator.java:12 nextBatch contract;
    RoaringBatchIterator.java walks containers reusing per-type cursors).

    ``next_batch(buffer)`` fills a caller-provided uint32 numpy array and
    returns the count filled; ``advance_if_needed`` skips whole containers
    by key bisect."""

    __slots__ = ("_hlc", "_ci", "_arr", "_pos")

    def __init__(self, bm: RoaringBitmap):
        self._hlc = bm.high_low_container
        self._ci = 0
        self._arr: Optional[np.ndarray] = None
        self._pos = 0

    def _ensure(self) -> bool:
        while self._arr is None or self._pos >= self._arr.size:
            if self._arr is not None:
                self._ci += 1
                self._arr = None
            if self._ci >= self._hlc.size:
                return False
            arr = self._hlc.containers[self._ci].to_array()
            if arr.size:
                self._arr = arr.astype(np.uint32) | np.uint32(
                    self._hlc.keys[self._ci] << 16
                )
                self._pos = 0
        return True

    def has_next(self) -> bool:
        return self._ensure()

    def next_batch(self, buffer: np.ndarray) -> int:
        """Fill `buffer` (uint32) with the next values; returns how many."""
        filled = 0
        cap = buffer.shape[0]
        while filled < cap and self._ensure():
            take = min(cap - filled, self._arr.size - self._pos)
            buffer[filled : filled + take] = self._arr[self._pos : self._pos + take]
            self._pos += take
            filled += take
        return filled

    def advance_if_needed(self, minval: int) -> None:
        """advanceIfNeeded (BatchIterator.java:72)."""
        key, low = minval >> 16, minval & 0xFFFF
        if self._arr is not None and self._hlc.keys[self._ci] == key:
            p = int(np.searchsorted(self._arr, np.uint32(minval)))
            self._pos = max(self._pos, p)
            return
        if self._arr is None or self._hlc.keys[self._ci] < key:
            self._ci = bisect_left(self._hlc.keys, key, lo=self._ci)
            self._arr = None
            if self._ensure() and self._hlc.keys[self._ci] == key:
                p = int(np.searchsorted(self._arr, np.uint32(minval)))
                self._pos = max(self._pos, p)

    def as_int_iterator(self) -> "BatchIntIterator":
        """Wrap as a point iterator (BatchIterator.asIntIterator :32)."""
        return BatchIntIterator(self)


class BatchIntIterator:
    """Point-iterator adapter over a batch iterator (BatchIntIterator.java)."""

    __slots__ = ("_it", "_buf", "_n", "_pos")

    def __init__(self, it: RoaringBatchIterator, batch_size: int = 256):
        self._it = it
        self._buf = np.empty(batch_size, dtype=np.uint32)
        self._n = 0
        self._pos = 0

    def has_next(self) -> bool:
        if self._pos < self._n:
            return True
        self._n = self._it.next_batch(self._buf)
        self._pos = 0
        return self._n > 0

    def next(self) -> int:
        if not self.has_next():
            raise StopIteration
        v = int(self._buf[self._pos])
        self._pos += 1
        return v

    def __iter__(self):
        return self

    __next__ = next
