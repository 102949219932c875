"""L1' containers: three chunk formats over a 16-bit sub-universe.

Logical model follows the reference (Container.java:19 and its three
concrete types): a sorted unique ``uint16`` array (sparse), a 1024x``uint64``
bitset (dense), and run-length (start, length) pairs — chosen dynamically by
cardinality / serialized-size thresholds (ArrayContainer.java:27
``DEFAULT_MAX_SIZE=4096``; RunContainer.java:78 serialized size
``2 + 4*nruns``; BitmapContainer fixed 8 KiB).

Physical model differs deliberately from the Java triple-dispatch matrix
(9 type-combinations per op, Container.java:63-98): here every pairwise op is
computed vectorized in numpy on the natural representation (sorted-array set
ops for sparse x sparse, word ops otherwise) and the *result* container type
is chosen by the same cardinality rule the reference converges to
(<=4096 -> array, else bitmap; runs arise from ``run_optimize``, range
constructors and deserialization). Value semantics and serialized-form
validity are identical; the batched device path (parallel/store.py) is where
the performance lives.

Containers are value-semantic: mutating ops return the (possibly new,
possibly different-type) container, Java-style (``c = c.add(x)``).
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from .. import native
from ..utils import bits

# raw C point-probe kernels of the native tier's extension, bound once:
# scalar contains is the per-call latency floor (simplebenchmark contains
# row; Util.java:697's unsignedBinarySearch role), and every avoided Python
# frame or numpy scalar-index on that path is ~70-150 ns
_EXT_CONTAINS = None  # contains_u16(sorted_content, x) -> bool
_EXT_WORDBIT = None  # word_bit(words_u64, x) -> bool
_EXT_RUNCONTAINS = None  # run_contains(starts, lengths, x) -> bool
_EXT_ADVANCE = None  # advance_until(sorted, pos, min) -> first idx with a[i] >= min
_EXT_PROBES_TRIED = False


def _bind_scalar_probes():
    # callers share one stanza shape (keep it when adding probes):
    #   e = _EXT_X
    #   if e is None and not _EXT_PROBES_TRIED:
    #       _bind_scalar_probes()
    #       e = _EXT_X
    # — a helper function here would cost the hot path the very frame the
    # probes exist to avoid
    global _EXT_CONTAINS, _EXT_WORDBIT, _EXT_RUNCONTAINS, _EXT_ADVANCE
    global _EXT_PROBES_TRIED
    if not _EXT_PROBES_TRIED:
        if native.available():  # a failed build raises here, on every call
            _, e = native.load()
            _EXT_CONTAINS = e.contains_u16
            _EXT_WORDBIT = e.word_bit
            _EXT_RUNCONTAINS = e.run_contains
            _EXT_ADVANCE = e.advance_until
        _EXT_PROBES_TRIED = True
    return _EXT_CONTAINS


def _unbind_scalar_probes() -> None:
    """Forget the bound probes (``native.set_tier`` calls this)."""
    global _EXT_CONTAINS, _EXT_WORDBIT, _EXT_RUNCONTAINS, _EXT_ADVANCE
    global _EXT_PROBES_TRIED
    _EXT_CONTAINS = _EXT_WORDBIT = _EXT_RUNCONTAINS = _EXT_ADVANCE = None
    _EXT_PROBES_TRIED = False


ARRAY_MAX_SIZE = 4096  # ArrayContainer.java:27 DEFAULT_MAX_SIZE
MAX_CAPACITY = 1 << 16  # BitmapContainer.java:25

ARRAY_TYPE = "array"
BITMAP_TYPE = "bitmap"
RUN_TYPE = "run"


def _as_u16(values) -> np.ndarray:
    return np.asarray(values, dtype=np.uint16)


def _wrap_u16(content: np.ndarray) -> "ArrayContainer":
    """ArrayContainer around an ALREADY-uint16 sorted array (kernel output
    or a mask/fancy index of existing content) — bypasses __init__'s
    dtype conversion, which is pure overhead on the pairwise-algebra hot
    path (~10k container ops per merge on adversarial key sets)."""
    out = ArrayContainer.__new__(ArrayContainer)
    out.content = content
    return out


class Container:
    """Abstract chunk over a 16-bit sub-universe (Container.java:19)."""

    TYPE: str = "?"

    # --- representation ---------------------------------------------------
    @property
    def cardinality(self) -> int:
        raise NotImplementedError

    def to_array(self) -> np.ndarray:
        """Sorted uint16 values."""
        raise NotImplementedError

    def to_words(self) -> np.ndarray:
        """1024-word uint64 bitset copy."""
        raise NotImplementedError

    def num_runs(self) -> int:
        raise NotImplementedError

    def clone(self) -> "Container":
        raise NotImplementedError

    # --- size / conversion (Container.java:882 runOptimize) ---------------
    def serialized_size(self) -> int:
        """Bytes of the container payload in RoaringFormatSpec."""
        raise NotImplementedError

    def run_optimize(self) -> "Container":
        """Convert to the smallest serialized representation
        (Container.runOptimize, Container.java:882)."""
        card = self.cardinality
        nruns = self.num_runs()
        run_size = RunContainer.serialized_size_for(nruns)
        current = 8192 if card > ARRAY_MAX_SIZE else 2 + 2 * card
        if run_size < current:
            return RunContainer.from_values(self.to_array())
        return self.to_efficient_non_run()

    def to_efficient_non_run(self) -> "Container":
        card = self.cardinality
        if card > ARRAY_MAX_SIZE:
            if isinstance(self, BitmapContainer):
                return self
            return BitmapContainer(bits.words_from_values(self.to_array()), card)
        if isinstance(self, ArrayContainer):
            return self
        return ArrayContainer(self.to_array())

    # --- point ops --------------------------------------------------------
    def contains(self, x: int) -> bool:
        raise NotImplementedError

    def contains_many(self, values: np.ndarray) -> np.ndarray:
        """Vectorized membership mask for uint16 values (per-type overrides
        avoid materializing the container)."""
        return np.isin(values, self.to_array())

    def add(self, x: int) -> "Container":
        raise NotImplementedError

    def remove(self, x: int) -> "Container":
        raise NotImplementedError

    # --- range ops (half-open [start, end) over 0..65536) -----------------
    def add_range(self, start: int, end: int) -> "Container":
        if start >= end:
            return self
        words = self.to_words()
        bits.set_bitmap_range(words, start, end)
        return best_container_of_words(words)

    def remove_range(self, start: int, end: int) -> "Container":
        if start >= end:
            return self
        words = self.to_words()
        bits.clear_bitmap_range(words, start, end)
        return best_container_of_words(words)

    def flip_range(self, start: int, end: int) -> "Container":
        """not(range) (Container.inot/not)."""
        if start >= end:
            return self
        words = self.to_words()
        bits.flip_bitmap_range(words, start, end)
        return best_container_of_words(words)

    def contains_range(self, start: int, end: int) -> bool:
        if start >= end:
            return True
        return self.rank(end - 1) - (self.rank(start - 1) if start > 0 else 0) == end - start

    def intersects_range(self, start: int, end: int) -> bool:
        if start >= end:
            return False
        nv = self.next_value(start)
        return nv >= 0 and nv < end

    # --- pairwise algebra -------------------------------------------------
    def and_(self, other: "Container") -> "Container":
        raise NotImplementedError

    def or_(self, other: "Container") -> "Container":
        raise NotImplementedError

    def xor_(self, other: "Container") -> "Container":
        raise NotImplementedError

    def andnot(self, other: "Container") -> "Container":
        raise NotImplementedError

    def intersects(self, other: "Container") -> bool:
        return self.and_cardinality(other) > 0

    def and_cardinality(self, other: "Container") -> int:
        return self.and_(other).cardinality

    def contains_container(self, other: "Container") -> bool:
        """Subset test: other ⊆ self (Container.contains, RoaringBitmap.java:2781)."""
        if other.cardinality > self.cardinality:
            return False
        return other.andnot(self).cardinality == 0

    # --- order statistics -------------------------------------------------
    def rank(self, x: int) -> int:
        """Number of values <= x (Container.rank, Container.java:849)."""
        raise NotImplementedError

    def rank_many(self, lows: np.ndarray) -> np.ndarray:
        """Vectorized rank over a uint16 probe array (no reference
        equivalent — Container.java only has the scalar :849); concrete
        types override with one numpy pass per batch."""
        return np.array([self.rank(int(x)) for x in lows], dtype=np.int64)

    def select_many(self, js: np.ndarray) -> np.ndarray:
        """Vectorized select over in-container 0-based ranks (the bulk twin
        of Container.select, Container.java:891); concrete types override
        with one numpy pass."""
        return np.array([self.select(int(j)) for j in js], dtype=np.uint16)

    def select(self, j: int) -> int:
        """j-th smallest value, 0-based (Container.select, Container.java:891)."""
        raise NotImplementedError

    def first(self) -> int:
        return self.select(0)

    def last(self) -> int:
        return self.select(self.cardinality - 1)

    def next_value(self, from_value: int) -> int:
        """Smallest value >= from_value, or -1 (Container.nextValue)."""
        raise NotImplementedError

    def previous_value(self, from_value: int) -> int:
        """Largest value <= from_value, or -1."""
        raise NotImplementedError

    def next_absent_value(self, from_value: int) -> int:
        """Smallest absent value >= from_value (65536 when the whole tail is
        present). Vectorized: a contiguous present run starting at from_value
        satisfies arr[i+k] == from_value+k; the first mismatch is the gap."""
        arr = self.to_array().astype(np.int64)
        i = int(np.searchsorted(arr, from_value))
        if i == arr.size or arr[i] != from_value:
            return from_value
        tail = arr[i:]
        mismatch = np.nonzero(tail != from_value + np.arange(tail.size))[0]
        return from_value + (int(mismatch[0]) if mismatch.size else tail.size)

    def previous_absent_value(self, from_value: int) -> int:
        """Largest absent value <= from_value, or -1 when [0, from_value] is
        entirely present."""
        arr = self.to_array().astype(np.int64)
        i = int(np.searchsorted(arr, from_value, side="right"))
        if i == 0 or arr[i - 1] != from_value:
            return from_value
        head = arr[:i][::-1]  # values ending the run at from_value, descending
        mismatch = np.nonzero(head != from_value - np.arange(head.size))[0]
        return from_value - (int(mismatch[0]) if mismatch.size else head.size)

    # --- iteration --------------------------------------------------------
    def __iter__(self) -> Iterator[int]:
        return iter(self.to_array().tolist())

    def __len__(self) -> int:
        return self.cardinality

    def __eq__(self, other) -> bool:
        if not isinstance(other, Container):
            return NotImplemented
        return (
            self.cardinality == other.cardinality
            and np.array_equal(self.to_array(), other.to_array())
        )

    def __hash__(self):  # containers are not hashable (mutable value semantics)
        raise TypeError("containers are unhashable")

    def __repr__(self):
        c = self.cardinality
        head = ",".join(str(v) for v in self.to_array()[:8].tolist())
        return f"<{type(self).__name__} card={c} [{head}{'...' if c > 8 else ''}]>"


# ---------------------------------------------------------------------------


class ArrayContainer(Container):
    """Sorted unique uint16 values; holds <= 4096 (ArrayContainer.java:27)."""

    TYPE = ARRAY_TYPE
    __slots__ = ("content",)

    def __init__(self, content=None):
        self.content = _as_u16(content if content is not None else [])

    @property
    def cardinality(self) -> int:
        return int(self.content.size)

    def to_array(self) -> np.ndarray:
        return self.content

    def to_words(self) -> np.ndarray:
        return bits.words_from_values(self.content)

    def num_runs(self) -> int:
        if self.content.size == 0:
            return 0
        # rb-ok: dtype-discipline -- uint16 payload (<= 0xFFFF) is exact in
        # int32; signed diff is the point (uint16 wraparound would lose the
        # negative gaps this counts)
        return int((np.diff(self.content.astype(np.int32)) != 1).sum()) + 1

    def clone(self) -> "ArrayContainer":
        return _wrap_u16(self.content.copy())

    def serialized_size(self) -> int:
        return 2 * self.cardinality  # payload: cardinality uint16s

    def contains(self, x: int) -> bool:
        c = self.content
        e = _EXT_CONTAINS
        if e is None and not _EXT_PROBES_TRIED:
            _bind_scalar_probes()
            e = _EXT_CONTAINS
        if e is not None:
            return e(c, x)
        i = bits.lower_bound(c, x)
        return bool(i < c.size and c[i] == x)

    def contains_many(self, values: np.ndarray) -> np.ndarray:
        if self.content.size == 0:
            return np.zeros(values.size, dtype=bool)
        v = values.astype(np.uint16)
        idx = np.searchsorted(self.content, v)
        idx_c = np.minimum(idx, self.content.size - 1)
        return (idx < self.content.size) & (self.content[idx_c] == v)

    def add(self, x: int) -> Container:
        c = self.content
        e = _EXT_ADVANCE
        if e is None and not _EXT_PROBES_TRIED:
            _bind_scalar_probes()
            e = _EXT_ADVANCE
        i = e(c, -1, x) if e is not None else bits.lower_bound(c, x)
        if i < c.size and c[i] == x:
            return self
        if c.size >= ARRAY_MAX_SIZE:
            return self._promote().add(x)  # ArrayContainer.java:158 promotion
        # manual two-slice insert: np.insert pays ~5 us of generic shape
        # machinery per call on this point-mutation hot path
        out = np.empty(c.size + 1, dtype=np.uint16)
        out[:i] = c[:i]
        out[i] = x
        out[i + 1 :] = c[i:]
        self.content = out
        return self

    def remove(self, x: int) -> Container:
        c = self.content
        e = _EXT_ADVANCE
        if e is None and not _EXT_PROBES_TRIED:
            _bind_scalar_probes()
            e = _EXT_ADVANCE
        i = e(c, -1, x) if e is not None else bits.lower_bound(c, x)
        if i < c.size and c[i] == x:
            out = np.empty(c.size - 1, dtype=np.uint16)
            out[:i] = c[:i]
            out[i:] = c[i + 1 :]
            self.content = out
        return self

    def _promote(self) -> "BitmapContainer":
        return BitmapContainer(bits.words_from_values(self.content), self.cardinality)

    # pairwise
    def and_(self, other: Container) -> Container:
        if isinstance(other, ArrayContainer):
            return _wrap_u16(bits.intersect_sorted(self.content, other.content))
        if isinstance(other, BitmapContainer):
            mask = other.contains_many(self.content)
            return _wrap_u16(self.content[mask])
        return other.and_(self)  # run

    def or_(self, other: Container) -> Container:
        if isinstance(other, ArrayContainer):
            merged = bits.merge_sorted_unique(self.content, other.content)
            if merged.size > ARRAY_MAX_SIZE:
                return BitmapContainer(bits.words_from_values(merged), int(merged.size))
            return _wrap_u16(merged)
        return other.or_(self)

    def xor_(self, other: Container) -> Container:
        if isinstance(other, ArrayContainer):
            out = bits.xor_sorted(self.content, other.content)
            if out.size > ARRAY_MAX_SIZE:
                return BitmapContainer(bits.words_from_values(out), int(out.size))
            return _wrap_u16(out)
        return other.xor_(self)

    def andnot(self, other: Container) -> Container:
        if isinstance(other, ArrayContainer):
            return _wrap_u16(bits.difference_sorted(self.content, other.content))
        if isinstance(other, BitmapContainer):
            mask = other.contains_many(self.content)
            return _wrap_u16(self.content[~mask])
        return _wrap_u16(
            self.content[~_run_contains_many(other, self.content)]
        )

    def and_cardinality(self, other: Container) -> int:
        if isinstance(other, BitmapContainer):
            return int(other.contains_many(self.content).sum())
        return self.and_(other).cardinality

    def rank(self, x: int) -> int:
        # values <= x == first index with content[i] >= x+1
        if x >= 0xFFFF:
            return self.content.size
        e = _EXT_ADVANCE
        if e is None and not _EXT_PROBES_TRIED:
            _bind_scalar_probes()
            e = _EXT_ADVANCE
        if e is not None:
            return e(self.content, -1, int(x) + 1)
        return bits.lower_bound(self.content, int(x) + 1)

    def rank_many(self, lows: np.ndarray) -> np.ndarray:
        return np.searchsorted(self.content, lows, side="right").astype(np.int64)

    def select(self, j: int) -> int:
        return int(self.content[j])

    def select_many(self, js: np.ndarray) -> np.ndarray:
        return self.content[np.asarray(js, dtype=np.int64)]

    def next_value(self, from_value: int) -> int:
        i = bits.lower_bound(self.content, from_value)
        return int(self.content[i]) if i < self.content.size else -1

    def previous_value(self, from_value: int) -> int:
        i = int(np.searchsorted(self.content, np.uint16(from_value), side="right"))
        return int(self.content[i - 1]) if i > 0 else -1


# ---------------------------------------------------------------------------


class BitmapContainer(Container):
    """1024x uint64 bitset + tracked cardinality (BitmapContainer.java:25)."""

    TYPE = BITMAP_TYPE
    __slots__ = ("words", "_card")

    def __init__(self, words: Optional[np.ndarray] = None, cardinality: Optional[int] = None):
        self.words = words if words is not None else bits.new_words()
        self._card = (
            cardinality if cardinality is not None else bits.cardinality_of_words(self.words)
        )

    @property
    def cardinality(self) -> int:
        return self._card

    def to_array(self) -> np.ndarray:
        return bits.values_from_words(self.words)

    def to_words(self) -> np.ndarray:
        return self.words.copy()

    def num_runs(self) -> int:
        return bits.num_runs_in_words(self.words)

    def clone(self) -> "BitmapContainer":
        return BitmapContainer(self.words.copy(), self._card)

    def serialized_size(self) -> int:
        return 8192

    def contains(self, x: int) -> bool:
        e = _EXT_WORDBIT
        if e is None and not _EXT_PROBES_TRIED:
            _bind_scalar_probes()
            e = _EXT_WORDBIT
        if e is not None:
            return e(self.words, x)
        return bits.get_bit(self.words, x)

    def contains_many(self, values: np.ndarray) -> np.ndarray:
        """Vectorized membership mask for uint16 values."""
        v = values.astype(np.uint32)
        return (
            (self.words[v >> 6] >> (v & np.uint32(63)).astype(np.uint64)) & np.uint64(1)
        ).astype(bool)

    def add(self, x: int) -> Container:
        if not bits.get_bit(self.words, x):
            bits.set_bit(self.words, x)
            self._card += 1
        return self

    def remove(self, x: int) -> Container:
        if bits.get_bit(self.words, x):
            bits.clear_bit(self.words, x)
            self._card -= 1
            if self._card <= ARRAY_MAX_SIZE:  # demotion (BitmapContainer -> Array)
                return ArrayContainer(self.to_array())
        return self

    def _binary(self, other: Container, fn) -> Container:
        ow = other.words if isinstance(other, BitmapContainer) else other.to_words()
        return best_container_of_words(fn(self.words, ow))

    def and_(self, other: Container) -> Container:
        if isinstance(other, ArrayContainer):
            return other.and_(self)
        return self._binary(other, np.bitwise_and)

    def or_(self, other: Container) -> Container:
        if isinstance(other, ArrayContainer):
            words = self.words.copy()
            bits.or_values_into_words(words, other.content)
            return BitmapContainer(words)
        return self._binary(other, np.bitwise_or)

    def xor_(self, other: Container) -> Container:
        return self._binary(other, np.bitwise_xor)

    def andnot(self, other: Container) -> Container:
        ow = other.words if isinstance(other, BitmapContainer) else other.to_words()
        return best_container_of_words(self.words & ~ow)

    def and_cardinality(self, other: Container) -> int:
        if isinstance(other, ArrayContainer):
            return other.and_cardinality(self)
        ow = other.words if isinstance(other, BitmapContainer) else other.to_words()
        return bits.cardinality_of_words(self.words & ow)

    def rank(self, x: int) -> int:
        return bits.cardinality_in_range(self.words, 0, x + 1)

    def rank_many(self, lows: np.ndarray) -> np.ndarray:
        # exclusive per-word popcount prefix + masked popcount of the
        # probe's own word, all vectorized
        pc = bits.popcount64(self.words).astype(np.int64)
        cum = np.concatenate(([0], np.cumsum(pc)[:-1]))
        lows = np.asarray(lows, dtype=np.uint32)
        wi = (lows >> 6).astype(np.int64)
        b = (lows & 63).astype(np.uint64)
        masks = np.uint64(0xFFFFFFFFFFFFFFFF) >> (np.uint64(63) - b)
        partial = bits.popcount64(self.words[wi] & masks).astype(np.int64)
        return cum[wi] + partial

    def select(self, j: int) -> int:
        return bits.select_in_words(self.words, j)

    def select_many(self, js: np.ndarray) -> np.ndarray:
        # one vectorized unpack of the whole word form answers any batch
        return self.to_array()[np.asarray(js, dtype=np.int64)]

    def next_value(self, from_value: int) -> int:
        w = from_value >> 6
        masked = self.words[w] >> np.uint64(from_value & 63)
        if masked != 0:
            return from_value + int(masked & (~masked + np.uint64(1))).bit_length() - 1
        nz = np.nonzero(self.words[w + 1 :])[0]
        if nz.size == 0:
            return -1
        ww = w + 1 + int(nz[0])
        word = int(self.words[ww])
        return (ww << 6) + (word & -word).bit_length() - 1

    def previous_value(self, from_value: int) -> int:
        w = from_value >> 6
        masked = self.words[w] << np.uint64(63 - (from_value & 63))
        if masked != 0:
            return from_value - (64 - int(masked).bit_length())
        nz = np.nonzero(self.words[:w])[0]
        if nz.size == 0:
            return -1
        ww = int(nz[-1])
        return (ww << 6) + int(self.words[ww]).bit_length() - 1

    _ALL64 = (1 << 64) - 1

    def next_absent_value(self, from_value: int) -> int:
        """Word-level (BitmapContainer.nextAbsentValue): first zero bit >=
        from_value, without the base class's full 65536-bit unpack."""
        w = from_value >> 6
        cur = (~int(self.words[w]) & self._ALL64) >> (from_value & 63)
        if cur:
            return from_value + (cur & -cur).bit_length() - 1
        inv = ~self.words[w + 1 :]
        nz = np.nonzero(inv)[0]
        if nz.size == 0:
            return 1 << 16
        ww = w + 1 + int(nz[0])
        word = int(inv[nz[0]])
        return (ww << 6) + (word & -word).bit_length() - 1

    def previous_absent_value(self, from_value: int) -> int:
        """Last zero bit <= from_value, or -1 when [0, from_value] is full."""
        w = from_value >> 6
        cur = (~int(self.words[w]) & self._ALL64) & ((1 << ((from_value & 63) + 1)) - 1)
        if cur:
            return (w << 6) + cur.bit_length() - 1
        inv = ~self.words[:w]
        nz = np.nonzero(inv)[0]
        if nz.size == 0:
            return -1
        ww = int(nz[-1])
        return (ww << 6) + int(inv[ww]).bit_length() - 1


# ---------------------------------------------------------------------------


def _intervals_of(c: Container):
    """Disjoint sorted half-open [start, end) int64 intervals of a container.

    Cheap for run (direct) and array (runs_from_values); bitmap goes through
    its value array — callers avoid that path for dense operands."""
    if isinstance(c, RunContainer):
        s = c.starts.astype(np.int64)
        return s, s + c.lengths.astype(np.int64) + 1
    rs, rl = bits.runs_from_values(c.to_array())
    s = rs.astype(np.int64)
    return s, s + rl.astype(np.int64) + 1


def _interval_op(as_, ae, bs, be, op):
    """Boolean algebra on two disjoint-interval sets, fully vectorized.

    The membership function of each side is piecewise-constant with
    breakpoints at its interval bounds; between consecutive breakpoints of
    the union both are constant, so evaluating ``op`` per segment and
    merging adjacent kept segments yields the exact result intervals.
    Replaces the reference's per-type two-pointer merges
    (RunContainer.java:590-900 and/or/xor/andNot) with one O((m+n)log(m+n))
    kernel shared by all four ops."""
    pts = np.unique(np.concatenate([as_, ae, bs, be]))
    if pts.size == 0:
        empty = np.empty(0, dtype=np.int64)
        return empty, empty
    seg = pts[:-1]
    in_a = np.searchsorted(as_, seg, side="right") > np.searchsorted(ae, seg, side="right")
    in_b = np.searchsorted(bs, seg, side="right") > np.searchsorted(be, seg, side="right")
    keep = op(in_a, in_b)
    # rb-ok: dtype-discipline -- diffs of a boolean mask are in {-1, 0, 1}
    change = np.diff(keep.astype(np.int8), prepend=np.int8(0), append=np.int8(0))
    return pts[change == 1], pts[np.nonzero(change == -1)[0]]


def _container_of_intervals(out_s: np.ndarray, out_e: np.ndarray) -> Container:
    """Best container for disjoint half-open intervals, by the reference's
    size rule (RunContainer.toEfficientContainer, RunContainer.java:691):
    run iff 2+4·nruns is smallest (ties keep the run, matching
    RunContainer.run_optimize), else array (≤4096) else bitmap."""
    card = int((out_e - out_s).sum())
    if card == 0:
        return ArrayContainer()
    nruns = int(out_s.size)
    run_size = RunContainer.serialized_size_for(nruns)
    other = 8192 if card > ARRAY_MAX_SIZE else 2 + 2 * card
    if run_size <= other:
        return RunContainer(
            out_s.astype(np.uint16), (out_e - out_s - 1).astype(np.uint16)
        )
    if card <= ARRAY_MAX_SIZE:
        return ArrayContainer(
            bits.values_from_runs(out_s.astype(np.uint16), (out_e - out_s - 1).astype(np.uint16))
        )
    return BitmapContainer(bits.words_from_intervals(out_s, out_e), card)


def _run_contains_many(run: "RunContainer", values: np.ndarray) -> np.ndarray:
    """Vectorized membership of uint16 values in a RunContainer."""
    if run.starts.size == 0:
        return np.zeros(values.size, dtype=bool)
    v = values.astype(np.int64)
    idx = np.searchsorted(run.starts.astype(np.int64), v, side="right") - 1
    valid = idx >= 0
    idx = np.clip(idx, 0, run.starts.size - 1)
    s = run.starts.astype(np.int64)[idx]
    e = s + run.lengths.astype(np.int64)[idx]
    return valid & (v >= s) & (v <= e)


class RunContainer(Container):
    """Run-length encoded: (start, length) pairs, run = [start, start+length]
    (RunContainer.java interleaved char pairs; serialized 2 + 4*nruns bytes,
    RunContainer.java:78)."""

    TYPE = RUN_TYPE
    __slots__ = ("starts", "lengths", "_card")

    def __init__(self, starts=None, lengths=None):
        self.starts = _as_u16(starts if starts is not None else [])
        self.lengths = _as_u16(lengths if lengths is not None else [])
        # run payloads are copy-on-write (every mutating op returns a new
        # container), so cardinality is computed at most once
        self._card = -1

    @staticmethod
    def from_values(values: np.ndarray) -> "RunContainer":
        s, l = bits.runs_from_values(values)
        return RunContainer(s, l)

    @staticmethod
    def serialized_size_for(nruns: int) -> int:
        return 2 + 4 * nruns  # RunContainer.java:78

    @property
    def cardinality(self) -> int:
        if self._card < 0:
            self._card = int(self.lengths.astype(np.int64).sum()) + int(self.starts.size)
        return self._card

    def to_array(self) -> np.ndarray:
        return bits.values_from_runs(self.starts, self.lengths)

    def to_words(self) -> np.ndarray:
        s = self.starts.astype(np.int64)
        return bits.words_from_intervals(s, s + self.lengths.astype(np.int64) + 1)

    def num_runs(self) -> int:
        return int(self.starts.size)

    def clone(self) -> "RunContainer":
        out = RunContainer.__new__(RunContainer)
        out.starts = self.starts.copy()
        out.lengths = self.lengths.copy()
        out._card = self._card
        return out

    def serialized_size(self) -> int:
        return self.serialized_size_for(self.num_runs())

    def contains(self, x: int) -> bool:
        # scalar fast path: one C probe over (starts, lengths) — or one
        # searchsorted on the numpy tier — instead of the vectorized
        # _run_contains_many machinery (~8x less overhead per point probe)
        e = _EXT_RUNCONTAINS
        if e is None and not _EXT_PROBES_TRIED:
            _bind_scalar_probes()
            e = _EXT_RUNCONTAINS
        starts = self.starts
        # strided views of the starts are rejected by the extension; a flags
        # check is ~100 ns against a raised-and-caught TypeError per probe
        if e is not None and starts.flags.c_contiguous:
            return e(starts, self.lengths, x)
        i = int(np.searchsorted(starts, x, side="right")) - 1
        if i < 0:
            return False
        return x - int(starts[i]) <= int(self.lengths[i])

    def contains_many(self, values: np.ndarray) -> np.ndarray:
        return _run_contains_many(self, values)

    def add(self, x: int) -> Container:
        if self.contains(x):
            return self
        return _mutate_via_words(self, lambda w: bits.set_bit(w, x))

    def remove(self, x: int) -> Container:
        if not self.contains(x):
            return self
        return _mutate_via_words(self, lambda w: bits.clear_bit(w, x))

    def run_optimize(self) -> Container:
        # RunContainer.toEfficientContainer (RunContainer.java:691)
        card = self.cardinality
        run_size = self.serialized_size()
        other = 8192 if card > ARRAY_MAX_SIZE else 2 + 2 * card
        if run_size <= other:
            return self
        return self.to_efficient_non_run()

    def _interval_binary(self, other: Container, op) -> Container:
        """Run-space algebra with run/array operands (RunContainer.java:590-900
        re-expressed as one vectorized interval kernel, no word expansion)."""
        as_, ae = _intervals_of(self)
        bs, be = _intervals_of(other)
        return _container_of_intervals(*_interval_op(as_, ae, bs, be, op))

    def and_(self, other: Container) -> Container:
        if isinstance(other, ArrayContainer):
            return _wrap_u16(other.content[_run_contains_many(self, other.content)])
        if isinstance(other, RunContainer):
            return self._interval_binary(other, np.logical_and)
        # run x bitmap: words are the natural shape for the dense side
        return best_container_of_words(self.to_words() & other.words)

    def or_(self, other: Container) -> Container:
        if isinstance(other, (RunContainer, ArrayContainer)):
            if self.is_full():
                return self.clone()
            return self._interval_binary(other, np.logical_or)
        return best_container_of_words(self.to_words() | other.words)

    def xor_(self, other: Container) -> Container:
        if isinstance(other, (RunContainer, ArrayContainer)):
            return self._interval_binary(other, np.logical_xor)
        return best_container_of_words(self.to_words() ^ other.words)

    def andnot(self, other: Container) -> Container:
        if isinstance(other, (RunContainer, ArrayContainer)):
            return self._interval_binary(other, lambda a, b: a & ~b)
        return best_container_of_words(self.to_words() & ~other.words)

    def and_cardinality(self, other: Container) -> int:
        if isinstance(other, ArrayContainer):
            return int(_run_contains_many(self, other.content).sum())
        if isinstance(other, RunContainer):
            as_, ae = _intervals_of(self)
            bs, be = _intervals_of(other)
            s, e = _interval_op(as_, ae, bs, be, np.logical_and)
            return int((e - s).sum())
        return bits.cardinality_of_words(self.to_words() & other.words)

    def rank(self, x: int) -> int:
        s = self.starts.astype(np.int64)
        e = s + self.lengths.astype(np.int64)
        full = s <= x
        contrib = np.where(full, np.minimum(e, x) - s + 1, 0)
        return int(contrib.sum())

    def rank_many(self, lows: np.ndarray) -> np.ndarray:
        s = self.starts.astype(np.int64)
        lens = self.lengths.astype(np.int64) + 1
        cum = np.concatenate(([0], np.cumsum(lens)))  # exclusive prefix
        lows = np.asarray(lows, dtype=np.int64)
        i = np.searchsorted(s, lows, side="right") - 1  # last run with start <= x
        safe = np.maximum(i, 0)
        # full runs before run i, plus the in-run contribution clipped to
        # its length (0 when the probe precedes every run)
        inside = np.where(i >= 0, np.clip(lows - s[safe] + 1, 0, lens[safe]), 0)
        return np.where(i >= 0, cum[safe], 0) + inside

    def select_many(self, js: np.ndarray) -> np.ndarray:
        lens = self.lengths.astype(np.int64) + 1
        cum = np.concatenate(([0], np.cumsum(lens)))  # exclusive prefix
        js = np.asarray(js, dtype=np.int64)
        i = np.searchsorted(cum, js, side="right") - 1  # run holding rank j
        return (self.starts.astype(np.int64)[i] + (js - cum[i])).astype(np.uint16)

    def select(self, j: int) -> int:
        lens = self.lengths.astype(np.int64) + 1
        cum = np.cumsum(lens)
        r = int(np.searchsorted(cum, j + 1))
        if r >= self.starts.size:
            raise IndexError(f"select({j})")
        prior = int(cum[r - 1]) if r else 0
        return int(self.starts[r]) + (j - prior)

    def next_value(self, from_value: int) -> int:
        if self.starts.size == 0:
            return -1
        s = self.starts.astype(np.int64)
        e = s + self.lengths.astype(np.int64)
        i = int(np.searchsorted(e, from_value))
        if i >= s.size:
            return -1
        return int(max(from_value, s[i]))

    def previous_value(self, from_value: int) -> int:
        if self.starts.size == 0:
            return -1
        s = self.starts.astype(np.int64)
        e = s + self.lengths.astype(np.int64)
        i = int(np.searchsorted(s, from_value, side="right")) - 1
        if i < 0:
            return -1
        return int(min(from_value, e[i]))

    def next_absent_value(self, from_value: int) -> int:
        """Run-space (RunContainer.nextAbsentValue): if from_value falls in
        a run, the answer is one past that run's end — normalized runs never
        touch, so that position is absent (or 65536 past the universe)."""
        s = self.starts.astype(np.int64)
        i = int(np.searchsorted(s, from_value, side="right")) - 1
        if i >= 0 and from_value <= int(s[i]) + int(self.lengths[i]):
            return int(s[i]) + int(self.lengths[i]) + 1
        return from_value

    def previous_absent_value(self, from_value: int) -> int:
        """Run-space twin: one before the covering run's start (absent by
        the no-touching invariant), or -1 when that run starts at 0."""
        s = self.starts.astype(np.int64)
        i = int(np.searchsorted(s, from_value, side="right")) - 1
        if i >= 0 and from_value <= int(s[i]) + int(self.lengths[i]):
            return int(s[i]) - 1
        return from_value

    def is_full(self) -> bool:
        return self.num_runs() == 1 and self.starts[0] == 0 and self.lengths[0] == 0xFFFF


def _mutate_via_words(c: Container, fn) -> Container:
    words = c.to_words()
    fn(words)
    new = best_container_of_words(words)
    if isinstance(c, RunContainer):
        return new.run_optimize()
    return new


# ---------------------------------------------------------------------------


def best_container_of_words(words: np.ndarray) -> Container:
    """Array if card <= 4096, else Bitmap (the reference's conversion rule)."""
    card = bits.cardinality_of_words(words)
    if card <= ARRAY_MAX_SIZE:
        return ArrayContainer(bits.values_from_words(words))
    return BitmapContainer(words, card)


def container_from_values(values: np.ndarray) -> Container:
    """Best non-run container from sorted unique uint16 values."""
    v = _as_u16(values)
    if v.size > ARRAY_MAX_SIZE:
        return BitmapContainer(bits.words_from_values(v), int(v.size))
    return ArrayContainer(v)


def container_range_of_ones(start: int, end: int) -> Container:
    """Container holding [start, end) — Container.rangeOfOnes
    (Container.java:29-37): array below the 2-value threshold, else run."""
    n = end - start
    if n <= 2:
        return ArrayContainer(np.arange(start, end, dtype=np.uint16))
    c = RunContainer(
        np.array([start], dtype=np.uint16), np.array([n - 1], dtype=np.uint16)
    )
    c._card = n
    return c
