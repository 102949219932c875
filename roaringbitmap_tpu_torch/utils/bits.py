"""L0 word/array kernels (host side, numpy).

Vectorized re-expression of the reference's branchless bit hacks
(reference Util.java / BitSetUtil.java — e.g. setBitmapRange Util.java:616,
cardinalityInBitmapRange Util.java:415, select(long,int) Util.java:564).
Java expresses these as JIT-intrinsic scalar loops over ``long[]``; here the
host path is vectorized numpy over the whole 1024-word container at once and
the device path (ops/) works on ``[N, 2048]`` int32 word rows in PyTorch.

A container covers a 16-bit sub-universe: 65536 bits = 1024 x uint64 words.
Word ``w`` bit ``b`` (little-endian within the word) holds value ``64*w + b``,
matching the RoaringFormatSpec serialized bitmap layout.
"""

from __future__ import annotations

import numpy as np

WORDS_PER_CONTAINER = 1024  # 65536 bits / 64-bit words (BitmapContainer.java:25)
BITS_PER_CONTAINER = 1 << 16

_U64_ONE = np.uint64(1)

# SWAR popcount constants (uint64)
_M1 = np.uint64(0x5555555555555555)
_M2 = np.uint64(0x3333333333333333)
_M4 = np.uint64(0x0F0F0F0F0F0F0F0F)
_H01 = np.uint64(0x0101010101010101)


def highbits(x):
    """High 16 bits of a 32-bit value (container key)."""
    return np.uint16(np.uint32(x) >> np.uint32(16))


def lowbits(x):
    """Low 16 bits of a 32-bit value (position within container)."""
    return np.uint16(np.uint32(x) & np.uint32(0xFFFF))


def combine(hb, lb):
    """Rebuild the 32-bit value from (high16, low16)."""
    return np.uint32(np.uint32(hb) << np.uint32(16)) | np.uint32(lb)


def popcount64(words: np.ndarray) -> np.ndarray:
    """Branchless SWAR popcount of each uint64 word (vectorized).

    Host analogue of ``Long.bitCount`` (BitmapContainer.java:17); the device
    analogue is the ``rb_popcount_rows`` kernel (ops/kernels.py).
    """
    v = words.astype(np.uint64, copy=True)
    v -= (v >> _U64_ONE) & _M1
    v = (v & _M2) + ((v >> np.uint64(2)) & _M2)
    v = (v + (v >> np.uint64(4))) & _M4
    return (v * _H01) >> np.uint64(56)


def cardinality_of_words(words: np.ndarray) -> int:
    """Total set-bit count of a word array."""
    return int(popcount64(words).sum())


def new_words() -> np.ndarray:
    return np.zeros(WORDS_PER_CONTAINER, dtype=np.uint64)


def is_strictly_increasing(a: np.ndarray) -> bool:
    """True when ``a`` is sorted AND duplicate-free — the bulk-ingest fast
    paths' contract. The strictness is load-bearing: a non-strict (>=)
    check would let duplicates skip the unique pass and corrupt
    containers."""
    return a.size <= 1 or bool(np.all(a[1:] > a[:-1]))


def words_from_values(values: np.ndarray) -> np.ndarray:
    """Build 1024-word bitset from sorted-or-not uint16 values."""
    return or_values_into_words(new_words(), values)


def or_values_into_words(words: np.ndarray, values: np.ndarray) -> np.ndarray:
    """OR uint16 values into an EXISTING word accumulator in place (the
    lazy-OR fold's array-container scatter)."""
    v = np.asarray(values, dtype=np.uint32)
    np.bitwise_or.at(words, v >> 6, _U64_ONE << (v & np.uint32(63)).astype(np.uint64))
    return words


def values_from_words(words: np.ndarray) -> np.ndarray:
    """Extract sorted uint16 values from a 1024-word bitset.

    Uses byte-level unpack (little-endian bit order) so bit i of word w maps
    to value 64*w + i.
    """
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    return np.nonzero(bits)[0].astype(np.uint16)


def set_bit(words: np.ndarray, x: int) -> None:
    words[x >> 6] |= _U64_ONE << np.uint64(x & 63)


def clear_bit(words: np.ndarray, x: int) -> None:
    words[x >> 6] &= ~(_U64_ONE << np.uint64(x & 63))


def get_bit(words: np.ndarray, x: int) -> bool:
    return bool((words[x >> 6] >> np.uint64(x & 63)) & _U64_ONE)


def set_bitmap_range(words: np.ndarray, start: int, end: int) -> None:
    """Set bits [start, end) — vectorized analogue of Util.setBitmapRange (Util.java:616)."""
    if start >= end:
        return
    first, last = start >> 6, (end - 1) >> 6
    lo_mask = np.uint64(0xFFFFFFFFFFFFFFFF) << np.uint64(start & 63)
    hi_mask = np.uint64(0xFFFFFFFFFFFFFFFF) >> np.uint64(63 - ((end - 1) & 63))
    if first == last:
        words[first] |= lo_mask & hi_mask
        return
    words[first] |= lo_mask
    words[first + 1 : last] = np.uint64(0xFFFFFFFFFFFFFFFF)
    words[last] |= hi_mask


def clear_bitmap_range(words: np.ndarray, start: int, end: int) -> None:
    """Clear bits [start, end) (Util.resetBitmapRange analogue)."""
    if start >= end:
        return
    first, last = start >> 6, (end - 1) >> 6
    lo_mask = np.uint64(0xFFFFFFFFFFFFFFFF) << np.uint64(start & 63)
    hi_mask = np.uint64(0xFFFFFFFFFFFFFFFF) >> np.uint64(63 - ((end - 1) & 63))
    if first == last:
        words[first] &= ~(lo_mask & hi_mask)
        return
    words[first] &= ~lo_mask
    words[first + 1 : last] = np.uint64(0)
    words[last] &= ~hi_mask


def flip_bitmap_range(words: np.ndarray, start: int, end: int) -> None:
    """Flip bits [start, end) (Util.flipBitmapRange analogue)."""
    if start >= end:
        return
    first, last = start >> 6, (end - 1) >> 6
    lo_mask = np.uint64(0xFFFFFFFFFFFFFFFF) << np.uint64(start & 63)
    hi_mask = np.uint64(0xFFFFFFFFFFFFFFFF) >> np.uint64(63 - ((end - 1) & 63))
    if first == last:
        words[first] ^= lo_mask & hi_mask
        return
    words[first] ^= lo_mask
    words[first + 1 : last] ^= np.uint64(0xFFFFFFFFFFFFFFFF)
    words[last] ^= hi_mask


def cardinality_in_range(words: np.ndarray, start: int, end: int) -> int:
    """Popcount of bits [start, end) — Util.cardinalityInBitmapRange (Util.java:415)."""
    if start >= end:
        return 0
    first, last = start >> 6, (end - 1) >> 6
    lo_mask = np.uint64(0xFFFFFFFFFFFFFFFF) << np.uint64(start & 63)
    hi_mask = np.uint64(0xFFFFFFFFFFFFFFFF) >> np.uint64(63 - ((end - 1) & 63))
    if first == last:
        return int(popcount64(np.array([words[first] & lo_mask & hi_mask])).sum())
    total = int(popcount64(np.array([words[first] & lo_mask, words[last] & hi_mask])).sum())
    if last > first + 1:
        total += int(popcount64(words[first + 1 : last]).sum())
    return total


def select_in_words(words: np.ndarray, j: int) -> int:
    """Position of the j-th (0-based) set bit — Util.select(long,int) (Util.java:564)
    generalized to the whole container via a cumulative-popcount scan."""
    counts = popcount64(words)
    cum = np.cumsum(counts)
    w = int(np.searchsorted(cum, j + 1))
    if w >= len(words):
        raise IndexError(f"select({j}) out of range (cardinality {int(cum[-1]) if len(cum) else 0})")
    prior = int(cum[w - 1]) if w else 0
    word = int(words[w])
    target = j - prior
    # peel target set bits off the word
    for _ in range(target):
        word &= word - 1
    lsb = word & -word
    return (w << 6) + lsb.bit_length() - 1


def runs_from_values(values: np.ndarray):
    """(starts, lengths) runs from a sorted uint16 value array.

    ``lengths`` follows the RoaringFormatSpec convention: the run covers
    [start, start+length], i.e. length = run cardinality - 1
    (RunContainer.java's interleaved (value, length) pairs).
    """
    v = np.asarray(values, dtype=np.int64)
    if v.size == 0:
        return np.empty(0, dtype=np.uint16), np.empty(0, dtype=np.uint16)
    breaks = np.nonzero(np.diff(v) != 1)[0]
    starts_idx = np.concatenate(([0], breaks + 1))
    ends_idx = np.concatenate((breaks, [v.size - 1]))
    starts = v[starts_idx]
    lengths = v[ends_idx] - starts
    return starts.astype(np.uint16), lengths.astype(np.uint16)


def values_from_runs(starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Expand (starts, lengths) runs to a sorted uint16 value array."""
    s = np.asarray(starts, dtype=np.int64)
    l = np.asarray(lengths, dtype=np.int64)
    if s.size == 0:
        return np.empty(0, dtype=np.uint16)
    total = int((l + 1).sum())
    out = np.ones(total, dtype=np.int64)
    # offsets where each run begins in the output
    run_offsets = np.concatenate(([0], np.cumsum(l + 1)[:-1]))
    out[run_offsets] = s - np.concatenate(([0], s[:-1] + l[:-1]))
    return np.cumsum(out).astype(np.uint16)


def words_from_intervals(starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """1024-word uint64 bitset from disjoint half-open [start, end) intervals,
    via a boundary-delta cumsum (vectorized; no per-run loop)."""
    # rb-ok: dtype-discipline -- boundary deltas are ±1 per disjoint
    # interval (|delta| <= 2 where a start meets an end), far inside int8
    delta = np.zeros((1 << 16) + 1, dtype=np.int8)
    np.add.at(delta, np.asarray(starts, dtype=np.int64), 1)
    np.subtract.at(delta, np.asarray(ends, dtype=np.int64), 1)
    # rb-ok: dtype-discipline -- running sum of the deltas is bounded by
    # the interval count (<= 2^16), exact in int32; result is only a mask
    mask = np.cumsum(delta[:-1], dtype=np.int32) > 0
    return np.packbits(mask, bitorder="little").view(np.uint64)


def num_runs_in_words(words: np.ndarray) -> int:
    """Number of runs in a bitset, vectorized.

    A run starts at every 01 transition scanning LSB->MSB; equals
    popcount(x & ~(x << 1)) summed with cross-word carry — the branchless
    formulation the reference computes per-word (BitmapContainer numberOfRuns).
    """
    w = words.astype(np.uint64)
    shifted = w << _U64_ONE
    # carry in the top bit of the previous word
    carry = np.zeros_like(w)
    carry[1:] = w[:-1] >> np.uint64(63)
    starts = w & ~(shifted | carry)
    return int(popcount64(starts).sum())


def merge_sorted_unique(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Union of two sorted unique uint16 arrays (Util.unsignedUnion2by2 analogue)."""
    if a.size == 0:
        return b.copy()
    if b.size == 0:
        return a.copy()
    out = np.union1d(a, b)  # sorts+dedups; inputs already sorted so this is a merge
    return out.astype(np.uint16)


def intersect_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Intersection of two sorted unique uint16 arrays (Util.unsignedIntersect2by2)."""
    if a.size == 0 or b.size == 0:
        return np.empty(0, dtype=np.uint16)
    out = np.intersect1d(a, b, assume_unique=True)
    return out.astype(np.uint16)


def difference_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a \\ b for sorted unique uint16 arrays (Util.unsignedDifference)."""
    if a.size == 0 or b.size == 0:
        return a.copy()
    out = np.setdiff1d(a, b, assume_unique=True)
    return out.astype(np.uint16)


def xor_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Symmetric difference of two sorted unique uint16 arrays (Util.unsignedExclusiveUnion2by2)."""
    if a.size == 0:
        return b.copy()
    if b.size == 0:
        return a.copy()
    out = np.setxor1d(a, b, assume_unique=True)
    return out.astype(np.uint16)


def lower_bound(a: np.ndarray, x: int) -> int:
    """Index of the first element >= x in a sorted uint16 array (the
    unsignedBinarySearch/gallop primitive behind point contains/rank/add;
    Util.java:697)."""
    return int(np.searchsorted(a, np.uint16(x)))


def validate_sorted_u16(values: np.ndarray) -> bool:
    """True iff strictly increasing (deserialization's array-container
    check)."""
    return not (values.size > 1 and bool(np.any(values[1:] <= values[:-1])))


def validate_runs_u16(pairs: np.ndarray) -> bool:
    """True iff interleaved (start, length) runs are sorted, disjoint,
    non-touching, and end inside the 2^16 universe."""
    starts, lengths = pairs[0::2], pairs[1::2]
    # rb-ok: dtype-discipline -- uint16 start+length <= 2*0xFFFF, exact in
    # int32; signed width is what makes the `> 0xFFFF` overflow check work
    s32 = starts.astype(np.int32)
    ends = s32 + lengths  # int32: no uint16 overflow
    return not (
        starts.size
        and (bool(np.any(s32[1:] <= ends[:-1])) or bool(np.any(ends > 0xFFFF)))
    )
