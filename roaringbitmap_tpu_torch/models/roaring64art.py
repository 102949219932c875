"""64-bit layer, design 2 of 2: the ART-based ``Roaring64Bitmap``.

Counterpart of the JAX package's ``models/roaring64art.py``, over the
port's containers and its own ``art.py``; the wire format is
byte-identical. Re-expression of longlong/Roaring64Bitmap.java:29 +
HighLowContainer.java:14-17: a 64-bit value splits into a 6-byte high-48 key (longlong/LongUtils.java
high48/low16 helpers) indexed by an adaptive radix tree (``art.py``), and a
16-bit low part stored in a standard container. Container payloads live in a
two-level ``Containers`` store addressed by a packed (hi32, lo32) index
(art/Containers.java:20-32, :63-70) — the ART leaf holds the packed index,
not the container object, exactly as in the reference; the dense second
level is also the natural staging layout for packing bitmap containers to
int32 ``[N, 2048]`` device rows (parallel/store.py).

Serialization: the reference's Roaring64Bitmap writes a private ART dump
(HighLowContainer.serialize: EMPTY_TAG/NOT_EMPTY_TAG + trie nodes) — a JVM
implementation detail, not a cross-language spec. This framework serializes
the portable 64-bit RoaringFormatSpec instead (identical to
Roaring64NavigableMap.serialize_portable, validated against
testdata/64map*.bin), grouping high-48 keys by their high 32 bits; the two
64-bit classes interoperate byte-for-byte.
"""

from __future__ import annotations

import bisect
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np

from .art import Art
from .container import (
    ArrayContainer,
    Container,
    container_from_values,
    container_range_of_ones,
)
from .roaring import RoaringBitmap
from .roaring64 import _check64, bucketed_membership, chunk_ranges_64, group_by_high


def high48_key(x: int) -> bytes:
    """6 big-endian bytes of the high 48 bits (LongUtils.highPart)."""
    return (x >> 16).to_bytes(6, "big")


def key_to_int(key: bytes) -> int:
    return int.from_bytes(key, "big")


class Containers:
    """Two-level container store addressed by a packed index
    (art/Containers.java:20-32): high 32 bits pick the first-level page,
    low 32 bits the slot. Pages are dense lists; freed slots are reused via
    a free list."""

    PAGE_SHIFT = 16  # 2^16 slots per page keeps pages cache-friendly

    def __init__(self):
        self._pages: List[List[Optional[Container]]] = []
        self._free: List[int] = []
        self._size = 0

    def __len__(self) -> int:
        return self._size

    def add(self, c: Container) -> int:
        """Store a container, returning its packed index (Containers.addContainer)."""
        self._size += 1
        if self._free:
            idx = self._free.pop()
            self._pages[idx >> self.PAGE_SHIFT][idx & 0xFFFF] = c
            return idx
        if not self._pages or len(self._pages[-1]) >= (1 << self.PAGE_SHIFT):
            self._pages.append([])
        page = len(self._pages) - 1
        self._pages[page].append(c)
        return (page << self.PAGE_SHIFT) | (len(self._pages[page]) - 1)

    def get(self, idx: int) -> Container:
        return self._pages[idx >> self.PAGE_SHIFT][idx & 0xFFFF]

    def replace(self, idx: int, c: Container) -> None:
        """replaceContainer (HighLowContainer path)."""
        self._pages[idx >> self.PAGE_SHIFT][idx & 0xFFFF] = c

    def remove(self, idx: int) -> None:
        self._pages[idx >> self.PAGE_SHIFT][idx & 0xFFFF] = None
        self._free.append(idx)
        self._size -= 1


class Roaring64Bitmap:
    """Unsigned 64-bit Roaring bitmap over an ART high-48 index
    (longlong/Roaring64Bitmap.java:29)."""

    __slots__ = ("_art", "_containers", "_ord")

    def __init__(self, values: Optional[Iterable[int]] = None):
        self._art = Art()
        self._containers = Containers()
        self._ord = None
        if values is not None:
            self.add_many(values)

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------
    def _get(self, key: bytes) -> Optional[Container]:
        idx = self._art.find(key)
        return None if idx is None else self._containers.get(idx)

    def _put(self, key: bytes, c: Container) -> None:
        self._ord = None
        idx = self._art.find(key)
        if idx is None:
            self._art.insert(key, self._containers.add(c))
        else:
            self._containers.replace(idx, c)

    def _set_or_drop(self, key: bytes, c: Optional[Container]) -> None:
        self._ord = None
        idx = self._art.find(key)
        if c is None or c.cardinality == 0:
            if idx is not None:
                self._containers.remove(idx)
                self._art.remove(key)
            return
        if idx is None:
            self._art.insert(key, self._containers.add(c))
        else:
            self._containers.replace(idx, c)

    def _kv(self) -> Iterator[Tuple[bytes, Container]]:
        for key, idx in self._art.items():
            yield key, self._containers.get(idx)

    # ------------------------------------------------------------------
    # construction / point ops (Roaring64Bitmap.addLong :50-61)
    # ------------------------------------------------------------------
    @staticmethod
    def bitmap_of(*values: int) -> "Roaring64Bitmap":
        return Roaring64Bitmap(values)

    def _ordered(self):
        """Sorted (keys, containers, cumulative cardinalities), rebuilt
        lazily after mutation — the cached-cumulative-cardinality design of
        Roaring64NavigableMap.java:66-72 / FastRankRoaringBitmap.java:21-39
        applied to the ART variant (whose reference counterpart re-walks the
        trie per rank/select call; at ~50k sparse high-48 buckets one Python
        walk per probe is ~1500x slower than a binary search here)."""
        if self._ord is None:
            keys, conts = [], []
            for k, c in self._kv():
                keys.append(k)
                conts.append(c)
            cum = np.cumsum([c.cardinality for c in conts], dtype=np.int64)
            # int64 view of the byte keys, cached for the vectorized
            # bulk-rank searchsorted (big-endian 6-byte keys sort
            # identically to their ints)
            key_ints = np.array([key_to_int(k) for k in keys], dtype=np.int64)
            self._ord = (keys, conts, cum, key_ints)
        return self._ord

    def add(self, x: int) -> None:
        x = _check64(x)
        self._ord = None
        key = high48_key(x)
        idx = self._art.find(key)
        if idx is None:
            self._art.insert(
                key, self._containers.add(ArrayContainer([x & 0xFFFF]))
            )
        else:
            self._containers.replace(
                idx, self._containers.get(idx).add(x & 0xFFFF)
            )

    def add_many(self, values: Iterable[int]) -> None:
        groups = group_by_high(values, 16)
        if self._art.is_empty():
            # bottom-up bulk trie build: group_by_high yields ascending
            # highs (it sorts), exactly bulk_load's contract — no per-key
            # root-to-leaf descent (Art.bulk_load)
            self._ord = None
            self._art.bulk_load(
                (
                    high.to_bytes(6, "big"),
                    self._containers.add(container_from_values(lows.astype(np.uint16))),
                )
                for high, lows in groups
            )
            return
        for high, lows in groups:
            key = high.to_bytes(6, "big")
            chunk = container_from_values(lows.astype(np.uint16))
            existing = self._get(key)
            self._put(key, chunk if existing is None else existing.or_(chunk))

    def remove(self, x: int) -> None:
        x = _check64(x)
        key = high48_key(x)
        c = self._get(key)
        if c is not None:
            self._set_or_drop(key, c.remove(x & 0xFFFF))

    def contains(self, x: int) -> bool:
        x = _check64(x)
        c = self._get(high48_key(x))
        return c is not None and c.contains(x & 0xFFFF)

    def contains_many(self, values) -> np.ndarray:
        """Vectorized membership: bool array parallel to ``values``.

        The 64-bit twin of the 32-bit ``RoaringBitmap.contains_many`` (the
        reference answers batch membership one contains() at a time,
        Roaring64Bitmap.java): one container-level vectorized probe per
        distinct high-48 chunk, not a trie descent per value
        (roaring64.bucketed_membership)."""

        def probe(high, lows):
            c = self._get(high.to_bytes(6, "big"))
            return None if c is None else c.contains_many(lows.astype(np.uint16))

        return bucketed_membership(values, 16, probe)

    # ------------------------------------------------------------------
    # ranges (per-2^16-chunk walk)
    # ------------------------------------------------------------------
    @staticmethod
    def _chunk_ranges(start: int, end: int):
        return chunk_ranges_64(start, end, 16)

    def add_range(self, start: int, end: int) -> None:
        for h, lo, hi in self._chunk_ranges(start, end):
            key = h.to_bytes(6, "big")
            c = self._get(key)
            if c is None:
                self._put(key, container_range_of_ones(lo, hi))
            else:
                self._put(key, c.add_range(lo, hi))

    def remove_range(self, start: int, end: int) -> None:
        for h, lo, hi in self._chunk_ranges(start, end):
            key = h.to_bytes(6, "big")
            c = self._get(key)
            if c is not None:
                self._set_or_drop(key, c.remove_range(lo, hi))

    def flip_range(self, start: int, end: int) -> None:
        for h, lo, hi in self._chunk_ranges(start, end):
            key = h.to_bytes(6, "big")
            c = self._get(key)
            if c is None:
                self._put(key, container_range_of_ones(lo, hi))
            else:
                self._set_or_drop(key, c.flip_range(lo, hi))

    # ------------------------------------------------------------------
    # algebra — ordered merge walks over the two tries (the reference
    # aligns keys via KeyIterator shuttles; or/and/andNot/xor
    # Roaring64Bitmap.java pairwise container ops)
    # ------------------------------------------------------------------
    def _merge_walk(self, other: "Roaring64Bitmap", op: str) -> "Roaring64Bitmap":
        # two-pointer key merge emits strictly-ascending keys into a fresh
        # index, so the result trie is bulk-built bottom-up (Art.bulk_load)
        # instead of paying two root-to-leaf descents per key via _put
        out = Roaring64Bitmap()
        store = out._containers
        pairs: list = []
        emit = pairs.append
        it_a, it_b = self._kv(), other._kv()
        a = next(it_a, None)
        b = next(it_b, None)
        while a is not None or b is not None:
            if b is None or (a is not None and a[0] < b[0]):
                if op in ("or", "xor", "andnot"):
                    emit((a[0], store.add(a[1].clone())))
                a = next(it_a, None)
            elif a is None or b[0] < a[0]:
                if op in ("or", "xor"):
                    emit((b[0], store.add(b[1].clone())))
                b = next(it_b, None)
            else:
                if op == "or":
                    c = a[1].or_(b[1])
                elif op == "and":
                    c = a[1].and_(b[1])
                elif op == "xor":
                    c = a[1].xor_(b[1])
                else:
                    c = a[1].andnot(b[1])
                if c.cardinality:
                    emit((a[0], store.add(c)))
                a = next(it_a, None)
                b = next(it_b, None)
        out._art.bulk_load(pairs)
        return out

    @staticmethod
    def or_(a: "Roaring64Bitmap", b: "Roaring64Bitmap") -> "Roaring64Bitmap":
        return a._merge_walk(b, "or")

    @staticmethod
    def and_(a: "Roaring64Bitmap", b: "Roaring64Bitmap") -> "Roaring64Bitmap":
        return a._merge_walk(b, "and")

    @staticmethod
    def xor(a: "Roaring64Bitmap", b: "Roaring64Bitmap") -> "Roaring64Bitmap":
        return a._merge_walk(b, "xor")

    @staticmethod
    def andnot(a: "Roaring64Bitmap", b: "Roaring64Bitmap") -> "Roaring64Bitmap":
        return a._merge_walk(b, "andnot")

    def ior(self, other: "Roaring64Bitmap") -> "Roaring64Bitmap":
        # true in-place: only other's keys are touched; untouched containers
        # of self are never cloned (mirrors the reference's naivelazyor walk).
        # A bulk-merge rebuild was measured and rejected: cloning both
        # sides' pass-throughs costs what the avoided trie descents save
        # (A/B at 200k x 200k scattered keys: 2.45 s loop vs 2.67 s merge).
        for k, oc in list(other._kv()):
            mine = self._get(k)
            self._put(k, oc.clone() if mine is None else mine.or_(oc))
        return self

    def ixor(self, other: "Roaring64Bitmap") -> "Roaring64Bitmap":
        for k, oc in list(other._kv()):
            mine = self._get(k)
            self._set_or_drop(k, oc.clone() if mine is None else mine.xor_(oc))
        return self

    def iandnot(self, other: "Roaring64Bitmap") -> "Roaring64Bitmap":
        for k, oc in list(other._kv()):
            mine = self._get(k)
            if mine is not None:
                self._set_or_drop(k, mine.andnot(oc))
        return self

    def iand(self, other: "Roaring64Bitmap") -> "Roaring64Bitmap":
        # touches every key of self: drop keys absent from other
        for k, mine in list(self._kv()):
            oc = other._get(k)
            self._set_or_drop(k, None if oc is None else mine.and_(oc))
        return self

    or_inplace = ior
    and_inplace = iand
    xor_inplace = ixor
    andnot_inplace = iandnot

    __or__ = lambda self, o: Roaring64Bitmap.or_(self, o)
    __and__ = lambda self, o: Roaring64Bitmap.and_(self, o)
    __xor__ = lambda self, o: Roaring64Bitmap.xor(self, o)
    __sub__ = lambda self, o: Roaring64Bitmap.andnot(self, o)
    __ior__ = ior
    __iand__ = iand
    __ixor__ = ixor
    __isub__ = iandnot

    def intersects(self, other: "Roaring64Bitmap") -> bool:
        it_a, it_b = self._kv(), other._kv()
        a = next(it_a, None)
        b = next(it_b, None)
        while a is not None and b is not None:
            if a[0] < b[0]:
                a = next(it_a, None)
            elif b[0] < a[0]:
                b = next(it_b, None)
            else:
                if a[1].intersects(b[1]):
                    return True
                a = next(it_a, None)
                b = next(it_b, None)
        return False

    # ------------------------------------------------------------------
    # cardinality / order statistics
    # ------------------------------------------------------------------
    def get_cardinality(self) -> int:
        _, _, cum, _ = self._ordered()
        return int(cum[-1]) if cum.size else 0

    def is_empty(self) -> bool:
        return self._art.is_empty()

    def rank(self, x: int) -> int:
        x = _check64(x)
        key, low = high48_key(x), x & 0xFFFF
        keys, conts, cum, _ = self._ordered()
        i = bisect.bisect_left(keys, key)
        total = int(cum[i - 1]) if i else 0
        if i < len(keys) and keys[i] == key:
            total += conts[i].rank(low)
        return total

    def rank_many(self, values) -> np.ndarray:
        """Bulk rank: int64 counts aligned with ``values`` — one vectorized
        high-48 chunk resolution plus one container ``rank_many`` per
        touched chunk (bulk twin of rank; negative ints as their
        two's-complement bit patterns, like contains_many)."""
        from ..utils.order_stats import bucketed_rank_many

        vals = np.asarray(values).astype(np.uint64, copy=False).ravel()
        keys, conts, cum, key_ints = self._ordered()
        if vals.size == 0 or not keys:
            return np.zeros(vals.size, dtype=np.int64)
        lows = (vals & np.uint64(0xFFFF)).astype(np.uint16)

        def in_chunk(i, pos):
            c = conts[i]
            if pos.size < 4:  # scattered probes: scalar beats numpy setup
                return np.array([c.rank(int(v)) for v in lows[pos]], dtype=np.int64)
            return c.rank_many(lows[pos])

        return bucketed_rank_many(
            key_ints, cum, (vals >> np.uint64(16)).astype(np.int64), in_chunk
        )

    def select_many(self, ranks) -> np.ndarray:
        """Bulk select: uint64 values at the given ranks, one vectorized
        chunk resolution plus one container ``select_many`` per touched
        chunk (bulk twin of select)."""
        from ..utils.order_stats import bucketed_select_many

        _, conts, cum, key_ints = self._ordered()
        return bucketed_select_many(
            cum,
            ranks,
            lambda i, js: (np.uint64(key_ints[i]) << np.uint64(16))
            | conts[i].select_many(js).astype(np.uint64),
        )

    def select(self, j: int) -> int:
        if j < 0:
            raise IndexError(f"select({j})")
        keys, conts, cum, _ = self._ordered()
        if not keys or j >= int(cum[-1]):
            raise IndexError(f"select({j}) out of range")
        i = int(np.searchsorted(cum, j, side="right"))
        prev = int(cum[i - 1]) if i else 0
        return (key_to_int(keys[i]) << 16) | conts[i].select(j - prev)

    def first(self) -> int:
        kv = self._art.first()
        if kv is None:
            raise ValueError("empty bitmap")
        k, idx = kv
        return (key_to_int(k) << 16) | self._containers.get(idx).first()

    def last(self) -> int:
        kv = self._art.last()
        if kv is None:
            raise ValueError("empty bitmap")
        k, idx = kv
        return (key_to_int(k) << 16) | self._containers.get(idx).last()

    def next_value(self, from_value: int) -> int:
        from_value = _check64(from_value)
        key, low = high48_key(from_value), from_value & 0xFFFF
        for k, idx in self._art.items_from(key):
            c = self._containers.get(idx)
            v = c.next_value(low) if k == key else c.first()
            if v >= 0:
                return (key_to_int(k) << 16) | v
        return -1

    def previous_value(self, from_value: int) -> int:
        from_value = _check64(from_value)
        key, low = high48_key(from_value), from_value & 0xFFFF
        for k, idx in self._art.items_to(key):
            c = self._containers.get(idx)
            v = c.previous_value(low) if k == key else c.last()
            if v >= 0:
                return (key_to_int(k) << 16) | v
        return -1

    # ------------------------------------------------------------------
    # structure
    # ------------------------------------------------------------------
    def run_optimize(self) -> bool:
        self._ord = None
        changed = False
        for key, idx in self._art.items():
            c = self._containers.get(idx)
            new = c.run_optimize()
            if new is not c:
                self._containers.replace(idx, new)
                changed = True
        return changed

    def clone(self) -> "Roaring64Bitmap":
        # _kv() walks the trie in ascending key order -> bulk-build the copy
        out = Roaring64Bitmap()
        store = out._containers
        out._art.bulk_load([(k, store.add(c.clone())) for k, c in self._kv()])
        return out

    def to_array(self) -> np.ndarray:
        parts = [
            c.to_array().astype(np.uint64) | np.uint64(key_to_int(k) << 16)
            for k, c in self._kv()
        ]
        return np.concatenate(parts) if parts else np.empty(0, dtype=np.uint64)

    def __iter__(self) -> Iterator[int]:
        for k, c in self._kv():
            base = key_to_int(k) << 16
            for v in c:
                yield base | v

    def get_high_to_bitmap_count(self) -> int:
        """Container (= high-48 key) count; the ART analogue of the
        NavigableMap's bucket count."""
        return len(self._art)

    # -- reference long-tail surface (Roaring64Bitmap.java) ----------------
    def add_int(self, x: int) -> None:
        """addInt: the int zero-extended to a long."""
        self.add(int(x) & 0xFFFFFFFF)

    def get_int_cardinality(self) -> int:
        card = self.get_cardinality()
        if card > (1 << 31) - 1:
            raise OverflowError("cardinality exceeds 32-bit int")
        return card

    def get_long_iterator(self) -> Iterator[int]:
        return iter(self)

    def get_long_iterator_from(self, min_value: int) -> Iterator[int]:
        """Values >= min_value ascending (getLongIteratorFrom)."""
        min_value = int(min_value)
        min_key = min_value >> 16
        for k, c in self._kv():
            base = key_to_int(k) << 16
            if (base >> 16) < min_key:
                continue
            for v in c:
                val = base | v
                if val >= min_value:
                    yield val

    def get_reverse_long_iterator(self) -> Iterator[int]:
        for k, c in self._kv_reversed():
            base = key_to_int(k) << 16
            for v in reversed(c.to_array().tolist()):
                yield base | v

    def get_reverse_long_iterator_from(self, max_value: int) -> Iterator[int]:
        """Values <= max_value descending (getReverseLongIteratorFrom)."""
        max_value = int(max_value)
        max_key = max_value >> 16
        for k, c in self._kv_reversed():
            base = key_to_int(k) << 16
            if (base >> 16) > max_key:
                continue
            for v in reversed(c.to_array().tolist()):
                val = base | v
                if val <= max_value:
                    yield val

    def _kv_reversed(self):
        """Streaming (key, container) descending — rides the trie's
        explicit-stack BackwardShuttle (art/BackwardShuttle.java:1) in
        O(depth) memory; reverse iteration over a huge key set must not
        materialize the trie it exists to index."""
        for key, idx in self._art.items_reverse():
            yield key, self._containers.get(idx)

    def for_each(self, consumer) -> None:
        for v in self:
            consumer(v)

    @staticmethod
    def _check_range64(start: int, end: int):
        start, end = int(start), int(end)
        if not 0 <= start <= end <= (1 << 64):
            raise ValueError(f"invalid range [{start}, {end})")
        return start, end

    def for_each_in_range(self, start: int, end: int, consumer) -> None:
        """Visit present values in [start, end) ascending. NOTE: half-open
        end, not the reference's (start, length) pair."""
        start, end = self._check_range64(start, end)
        for v in self.get_long_iterator_from(start):
            if v >= end:
                break
            consumer(v)

    def for_all_in_range(self, start: int, end: int, consumer) -> None:
        """consumer(relative_pos, present) for every position in
        [start, end) — RelativeRangeConsumer contract. Values stream from
        the from-iterator; positions are a flat walk, so memory stays O(1)."""
        start, end = self._check_range64(start, end)
        it = self.get_long_iterator_from(start)
        nxt = next(it, None)
        for pos in range(end - start):
            val = start + pos
            present = nxt == val
            if present:
                nxt = next(it, None)
            consumer(pos, present)

    def limit(self, max_cardinality: int) -> "Roaring64Bitmap":
        """First max_cardinality values: whole containers are adopted and
        only the last partial one is truncated (like the 32-bit limit)."""
        out = Roaring64Bitmap()
        remaining = int(max_cardinality)
        for k, c in self._kv():
            if remaining <= 0:
                break
            if c.cardinality <= remaining:
                taken = c.clone()
            else:
                taken = container_from_values(c.to_array()[:remaining])
            out._put(k, taken)
            remaining -= taken.cardinality
        return out

    def clear(self) -> None:
        """Empty in place (Roaring64Bitmap.clear)."""
        self.__init__()

    empty = clear

    def trim(self) -> None:
        """No-op: numpy storage is exact-sized."""

    def get_size_in_bytes(self) -> int:
        return sum(8 + c.serialized_size() for _, c in self._kv())

    get_long_size_in_bytes = get_size_in_bytes

    @staticmethod
    def and_cardinality(a: "Roaring64Bitmap", b: "Roaring64Bitmap") -> int:
        """O(intersection): per-key and_cardinality, nothing materialized."""
        total = 0
        it_b = dict(b._kv())
        for k, ca in a._kv():
            cb = it_b.get(k)
            if cb is not None:
                total += ca.and_cardinality(cb)
        return total

    @staticmethod
    def or_cardinality(a: "Roaring64Bitmap", b: "Roaring64Bitmap") -> int:
        return (
            a.get_cardinality()
            + b.get_cardinality()
            - Roaring64Bitmap.and_cardinality(a, b)
        )

    @staticmethod
    def xor_cardinality(a: "Roaring64Bitmap", b: "Roaring64Bitmap") -> int:
        return (
            a.get_cardinality()
            + b.get_cardinality()
            - 2 * Roaring64Bitmap.and_cardinality(a, b)
        )

    @staticmethod
    def andnot_cardinality(a: "Roaring64Bitmap", b: "Roaring64Bitmap") -> int:
        return a.get_cardinality() - Roaring64Bitmap.and_cardinality(a, b)

    # ------------------------------------------------------------------
    # serialization — portable 64-bit spec via high-32 grouping
    # ------------------------------------------------------------------
    def _grouped_high32(self) -> Iterator[Tuple[int, RoaringBitmap]]:
        """(high32, 32-bit view) groups in key order; the view's RoaringArray
        shares this bitmap's containers (append never mutates them)."""
        current_high32 = None
        current: Optional[RoaringBitmap] = None
        for k, c in self._kv():
            k_int = key_to_int(k)
            high32, key16 = k_int >> 16, k_int & 0xFFFF
            if high32 != current_high32:
                if current is not None:
                    yield current_high32, current
                current_high32 = high32
                current = RoaringBitmap()
            current.high_low_container.append(key16, c)
        if current is not None:
            yield current_high32, current

    def serialize(self) -> bytes:
        import struct

        parts = []
        count = 0
        for high32, bm in self._grouped_high32():
            parts.append(struct.pack("<I", high32))
            parts.append(bm.serialize())
            count += 1
        return b"".join([struct.pack("<Q", count)] + parts)

    def serialized_size_in_bytes(self) -> int:
        from ..serialization import serialized_size_in_bytes

        return 8 + sum(
            4 + serialized_size_in_bytes(bm) for _, bm in self._grouped_high32()
        )

    def _absorb_spec_bucket(self, high32: int, bm: RoaringBitmap) -> None:
        """Adopt a decoded 32-bit bucket's containers under their high-48
        chunk keys (shared by the buffer and stream readers)."""
        arr = bm.high_low_container
        for i in range(arr.size):
            k = ((high32 << 16) | int(arr.keys[i])).to_bytes(6, "big")
            self._put(k, arr.containers[i])

    def _adopt_buckets(self, buckets) -> None:
        """Adopt decoded (high32, 32-bit bitmap) buckets in ascending key
        order. On an empty trie — every deserializer's case — the chunk
        keys arrive strictly ascending (bucket keys validated ascending,
        in-bucket keys sorted), so the whole trie is bulk-built bottom-up
        (Art.bulk_load) instead of one descent per chunk."""
        if not self._art.is_empty():
            for high32, bm in buckets:
                self._absorb_spec_bucket(high32, bm)
            return
        self._ord = None
        store = self._containers
        pairs = []
        for high32, bm in buckets:
            arr = bm.high_low_container
            base = high32 << 16
            for i in range(arr.size):
                k = (base | int(arr.keys[i])).to_bytes(6, "big")
                pairs.append((k, store.add(arr.containers[i])))
        self._art.bulk_load(pairs)

    @staticmethod
    def read_from(buf) -> Tuple["Roaring64Bitmap", int]:
        """Parse one portable-spec 64-bit bitmap from the head of `buf`,
        returning (bitmap, bytes consumed) — the consuming reader shared by
        deserialize and embedding formats (64-bit BSI slices)."""
        import struct

        from ..serialization import InvalidRoaringFormat, read_into

        buf = memoryview(
            bytes(buf) if not isinstance(buf, (bytes, bytearray, memoryview)) else buf
        )
        if len(buf) < 8:
            raise InvalidRoaringFormat("truncated 64-bit header")
        (count,) = struct.unpack_from("<Q", buf, 0)
        if count > len(buf) // 4:
            raise InvalidRoaringFormat(f"implausible bucket count {count}")
        pos = 8
        out = Roaring64Bitmap()
        prev_key = -1
        buckets = []
        for _ in range(count):
            if pos + 4 > len(buf):
                raise InvalidRoaringFormat("truncated bucket key")
            (high32,) = struct.unpack_from("<I", buf, pos)
            pos += 4
            if high32 <= prev_key:
                raise InvalidRoaringFormat("bucket keys not strictly increasing")
            prev_key = high32
            bm = RoaringBitmap()
            pos += read_into(bm, buf[pos:])
            buckets.append((high32, bm))
        out._adopt_buckets(buckets)
        return out, pos

    @staticmethod
    def deserialize(data) -> "Roaring64Bitmap":
        return Roaring64Bitmap.read_from(data)[0]

    def serialize_into(self, fileobj) -> int:
        """Stream overload (Roaring64Bitmap.serialize(DataOutput),
        longlong/Roaring64Bitmap.java:880); returns bytes written."""
        data = self.serialize()
        fileobj.write(data)
        return len(data)

    @staticmethod
    def deserialize_from(fileobj) -> "Roaring64Bitmap":
        """Stream twin: consumes exactly one portable-spec 64-bit bitmap,
        leaving the stream at the next byte (bucket payloads stream through
        RoaringBitmap.deserialize_from's exact-consumption contract)."""
        import struct

        from ..serialization import InvalidRoaringFormat, read_exact

        (count,) = struct.unpack("<Q", read_exact(fileobj, 8))
        if count > (1 << 32):  # u32 strictly-increasing keys cap the count
            raise InvalidRoaringFormat(f"implausible bucket count {count}")
        out = Roaring64Bitmap()
        prev_key = -1
        buckets = []
        for _ in range(count):
            (high32,) = struct.unpack("<I", read_exact(fileobj, 4))
            if high32 <= prev_key:
                raise InvalidRoaringFormat("bucket keys not strictly increasing")
            prev_key = high32
            buckets.append((high32, RoaringBitmap.deserialize_from(fileobj)))
        out._adopt_buckets(buckets)
        return out

    # ------------------------------------------------------------------
    def __eq__(self, other):
        if isinstance(other, Roaring64Bitmap):
            return np.array_equal(self.to_array(), other.to_array())
        if hasattr(other, "to_array"):
            return np.array_equal(self.to_array(), other.to_array())
        return NotImplemented

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
        return f"Roaring64Bitmap(card={card}, values=[{head}{'...' if card > 8 else ''}])"

    # reference facade naming aliases (Roaring64Bitmap.java addLong :50,
    # removeLong, getLongCardinality) for drop-in familiarity
    add_long = add
    remove_long = remove
    contains_long = contains
    get_long_cardinality = get_cardinality

    def __reduce__(self):
        """Pickle via the portable 64-bit wire format."""
        return Roaring64Bitmap.deserialize, (self.serialize(),)
