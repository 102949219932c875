"""Drop-in BitSet-style facade backed by a RoaringBitmap
(RoaringBitSet.java:9-12) plus BitSetUtil-style conversions
(BitSetUtil.java:29/174).

Counterpart of the JAX package's ``models/bitset.py``."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..utils import bits
from .container import container_from_values
from .roaring import RoaringBitmap


class RoaringBitSet:
    """java.util.BitSet-flavoured API over a RoaringBitmap."""

    __slots__ = ("bitmap",)

    def __init__(self, bitmap: Optional[RoaringBitmap] = None):
        self.bitmap = bitmap if bitmap is not None else RoaringBitmap()

    # BitSet API
    def set(self, index: int, value: bool = True) -> None:
        if value:
            self.bitmap.add(index)
        else:
            self.bitmap.remove(index)

    def set_range(self, start: int, end: int) -> None:
        self.bitmap.add_range(start, end)

    def clear(self, index: Optional[int] = None) -> None:
        if index is None:
            self.bitmap = RoaringBitmap()
        else:
            self.bitmap.remove(index)

    def clear_range(self, start: int, end: int) -> None:
        self.bitmap.remove_range(start, end)

    def get(self, index: int) -> bool:
        return self.bitmap.contains(index)

    def flip(self, index: int) -> None:
        self.bitmap.flip_range(index, index + 1)

    def flip_range(self, start: int, end: int) -> None:
        self.bitmap.flip_range(start, end)

    def cardinality(self) -> int:
        return self.bitmap.get_cardinality()

    def is_empty(self) -> bool:
        return self.bitmap.is_empty()

    def length(self) -> int:
        """Highest set bit + 1, or 0 (BitSet.length)."""
        return 0 if self.bitmap.is_empty() else self.bitmap.last() + 1

    def next_set_bit(self, from_index: int) -> int:
        return self.bitmap.next_value(from_index)

    def next_clear_bit(self, from_index: int) -> int:
        return self.bitmap.next_absent_value(from_index)

    def previous_set_bit(self, from_index: int) -> int:
        return self.bitmap.previous_value(from_index)

    def previous_clear_bit(self, from_index: int) -> int:
        return self.bitmap.previous_absent_value(from_index)

    def and_(self, other: "RoaringBitSet") -> None:
        self.bitmap.iand(other.bitmap)

    def or_(self, other: "RoaringBitSet") -> None:
        self.bitmap.ior(other.bitmap)

    def xor(self, other: "RoaringBitSet") -> None:
        self.bitmap.ixor(other.bitmap)

    def and_not(self, other: "RoaringBitSet") -> None:
        self.bitmap.iandnot(other.bitmap)

    def intersects(self, other: "RoaringBitSet") -> bool:
        return RoaringBitmap.intersects(self.bitmap, other.bitmap)

    def __eq__(self, other):
        if not isinstance(other, RoaringBitSet):
            return NotImplemented
        return self.bitmap == other.bitmap

    def __hash__(self):
        return hash(self.bitmap)

    def __reduce__(self):
        return _bitset_from_bytes, (self.bitmap.serialize(),)

    def __len__(self):
        return self.cardinality()

    def __repr__(self):
        return f"RoaringBitSet({self.bitmap!r})"


def bitmap_of_words(words: np.ndarray) -> RoaringBitmap:
    """long[]-backed BitSet words -> RoaringBitmap
    (BitSetUtil.bitmapOf(long[]), BitSetUtil.java:174). Block-wise: each
    1024-word block becomes one container (BLOCK_LENGTH, BitSetUtil.java:20)."""
    words = np.asarray(words, dtype=np.uint64).ravel()
    bm = RoaringBitmap()
    for key, start in enumerate(range(0, words.size, bits.WORDS_PER_CONTAINER)):
        block = words[start : start + bits.WORDS_PER_CONTAINER]
        if block.size < bits.WORDS_PER_CONTAINER:
            block = np.concatenate(
                [block, np.zeros(bits.WORDS_PER_CONTAINER - block.size, dtype=np.uint64)]
            )
        values = bits.values_from_words(block)
        if values.size:
            bm.high_low_container.append(key, container_from_values(values))
    return bm


def words_of_bitmap(bm: RoaringBitmap) -> np.ndarray:
    """RoaringBitmap -> long[] BitSet words (BitSetUtil.bitsetOf,
    BitSetUtil.java:29). Requires all values < 2^32; sized to the last bit."""
    if bm.is_empty():
        return np.empty(0, dtype=np.uint64)
    n_words = (bm.last() >> 6) + 1
    out = np.zeros(n_words, dtype=np.uint64)
    hlc = bm.high_low_container
    for k, c in zip(hlc.keys, hlc.containers):
        base = k * bits.WORDS_PER_CONTAINER
        out[base : base + bits.WORDS_PER_CONTAINER] = c.to_words()[
            : max(0, min(bits.WORDS_PER_CONTAINER, n_words - base))
        ]
    return out


def _bitset_from_bytes(blob: bytes) -> "RoaringBitSet":
    return RoaringBitSet(RoaringBitmap.deserialize(blob))
