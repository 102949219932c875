"""L3' facade: the 32-bit RoaringBitmap.

API parity with the reference facade (RoaringBitmap.java:50): point ops
(add :1162, contains :1693, remove :2637), range ops (add(long,long) :1181,
flip :1893), pairwise static algebra (and/or/xor/andNot/orNot
:377/860/1071/444/1521) plus cardinality-only variants, rank/select
(:2622/2820), next/previous(+absent) value (:2838-2929), addOffset (:230),
selectRange (:3095), limit (:2457), runOptimize (:2764), contains-subset
(:2781), isHammingSimilar (:1831), rangeCardinality (:2590), batch
iteration, the peekable, reverse and rank iterators (``iterators.py``),
and the RoaringFormatSpec serialization (:3012-3051). Pairwise algebra
routes through the columnar engine (``columnar/``) above its cutoff, as in
the JAX package, and runs the per-container walk below it. The buffer
twins (``buffer.py``, ``immutable.py``) take any mix of heap and mapped
operands through the same algebra.

Values are unsigned 32-bit ints; ranges are half-open ``[start, end)`` with
``0 <= start <= end <= 2^32``.
"""

from __future__ import annotations

from bisect import bisect_left
from typing import Iterable, Iterator, List, Optional

import numpy as np

from ..utils import bits
from .container import (
    ARRAY_MAX_SIZE,
    ArrayContainer,
    BitmapContainer,
    Container,
    RunContainer,
    container_from_values,
    container_range_of_ones,
)
from .roaring_array import RoaringArray

_MAX32 = 1 << 32


# the grouping idiom shared by the bulk-probe paths (contains_many /
# rank_many / select_many) — one home in utils.order_stats
from ..utils.order_stats import group_positions as _group_positions

# the columnar pairwise engine, bound lazily because the package imports
# this module; one global probe per process
_COLUMNAR = None


def _columnar():
    global _COLUMNAR
    if _COLUMNAR is None:
        from .. import columnar

        _COLUMNAR = columnar
    return _COLUMNAR


def hlc_fingerprint(hlc) -> tuple:
    """The canonical mutation-tracking token computed from a high-low
    container — the single source of the fingerprint scheme:
    ``RoaringBitmap.fingerprint()`` delegates here. The tuple is cached on
    the container array (``_fp``, invalidated by every version bump), so a
    cached fingerprint is the same object across calls."""
    fp = getattr(hlc, "_fp", None)
    if fp is not None:
        return fp
    gen = getattr(hlc, "_gen", None)
    if gen is None:  # mapped/immutable container arrays never mutate
        return ("static", id(hlc))
    fp = (gen, hlc._version)
    try:
        hlc._fp = fp
    except AttributeError:  # foreign mutable hlc without the cache slot
        pass
    return fp


def _check_value(x: int) -> int:
    x = int(x)
    if not 0 <= x < _MAX32:
        raise ValueError(f"value {x} outside unsigned 32-bit range")
    return x


def _check_range(start: int, end: int):
    start, end = int(start), int(end)
    if not 0 <= start <= end <= _MAX32:
        raise ValueError(f"invalid range [{start}, {end})")
    return start, end


class RoaringBitmap:
    __slots__ = ("high_low_container",)

    def __init__(self, values: Optional[Iterable[int]] = None):
        self.high_low_container = RoaringArray()
        if values is not None:
            self.add_many(values)

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @staticmethod
    def bitmap_of(*values: int) -> "RoaringBitmap":
        return RoaringBitmap(values)

    @staticmethod
    def bitmap_of_range(start: int, end: int) -> "RoaringBitmap":
        out = RoaringBitmap()
        out.add_range(start, end)
        return out

    # bitmapOfUnordered: add_many sorts internally, so one name serves both
    bitmap_of_unordered = bitmap_of

    def add_n(self, values, offset: int = 0, n: Optional[int] = None) -> None:
        """Add a slice of a value array (RoaringBitmap.addN(vals, offset, n))."""
        v = np.asarray(values).ravel()
        self.add_many(v[offset : None if n is None else offset + n])

    def clone(self) -> "RoaringBitmap":
        out = RoaringBitmap()
        out.high_low_container = self.high_low_container.clone()
        return out

    def to_mutable_roaring_bitmap(self):
        """Deep-copy into the buffer-world mutable twin
        (RoaringBitmap.toMutableRoaringBitmap)."""
        from .buffer import MutableRoaringBitmap

        return MutableRoaringBitmap.of(self)

    # ------------------------------------------------------------------
    # point ops
    # ------------------------------------------------------------------
    def add(self, x: int) -> None:
        """RoaringBitmap.add (RoaringBitmap.java:1162). Frame-flat like
        contains: the key probe is inlined on this point-mutation hot
        path."""
        x = int(x)
        if not 0 <= x < _MAX32:
            raise ValueError(f"value {x} outside unsigned 32-bit range")
        hb, lb = x >> 16, x & 0xFFFF
        hlc = self.high_low_container
        keys = hlc.keys
        i = bisect_left(keys, hb)
        if i < len(keys) and keys[i] == hb:
            containers = hlc.containers
            containers[i] = containers[i].add(lb)
            hlc.touch_key(hb)  # frame-flat path bypasses set_container_at_index
        else:
            hlc.insert_new_key_value_at(
                i, hb, ArrayContainer(np.array([lb], dtype=np.uint16))
            )

    def checked_add(self, x: int) -> bool:
        """Add, returning True if the bitmap changed (RoaringBitmap.java:1610)."""
        before = self.contains(x)
        if not before:
            self.add(x)
        return not before

    def add_many(self, values: Iterable[int]) -> None:
        """Bulk add via per-key grouping (the writer path is faster for huge
        sorted streams; see models/writer.py)."""
        if not isinstance(values, np.ndarray):
            values = np.fromiter(iter(values), dtype=np.int64)
        v = np.asarray(values, dtype=np.int64).ravel()
        if v.size == 0:
            return
        if v.min() < 0 or v.max() >= _MAX32:
            raise ValueError("values outside unsigned 32-bit range")
        u = v.astype(np.uint32)
        # strictly-increasing input (the common bulk shape: BSI slice masks,
        # pre-sorted ingest) skips the unique's O(n log n) sort
        v = u if bits.is_strictly_increasing(u) else np.unique(u)
        keys = (v >> 16).astype(np.int64)
        lows = (v & 0xFFFF).astype(np.uint16)
        boundaries = np.nonzero(np.diff(keys))[0] + 1
        key_starts = np.concatenate(([0], boundaries))
        key_ends = np.concatenate((boundaries, [v.size]))
        hlc = self.high_low_container
        for s, e in zip(key_starts.tolist(), key_ends.tolist()):
            key = int(keys[s])
            chunk = lows[s:e]
            i = hlc.get_index(key)
            if i >= 0:
                existing = hlc.get_container_at_index(i)
                hlc.set_container_at_index(
                    i, existing.or_(container_from_values(chunk))
                )
            else:
                hlc.insert_new_key_value_at(-i - 1, key, container_from_values(chunk))

    def remove(self, x: int) -> None:
        """RoaringBitmap.remove (RoaringBitmap.java:2637)."""
        x = _check_value(x)
        hb, lb = x >> 16, x & 0xFFFF
        hlc = self.high_low_container
        i = hlc.get_index(hb)
        if i < 0:
            return
        c = hlc.get_container_at_index(i).remove(lb)
        if c.cardinality == 0:
            hlc.remove_at_index(i)
        else:
            hlc.set_container_at_index(i, c)

    def checked_remove(self, x: int) -> bool:
        before = self.contains(x)
        if before:
            self.remove(x)
        return before

    def contains(self, x: int) -> bool:
        """RoaringBitmap.contains (RoaringBitmap.java:1693).

        Deliberately frame-flat: the key probe and container lookup are
        inlined (no _check_value/get_container hops) because this is the
        per-call latency floor the simplebenchmark contains row measures —
        each avoided Python frame is ~70 ns (Util.java:697's
        unsignedBinarySearch plays this role for the JVM)."""
        x = int(x)
        if not 0 <= x < _MAX32:
            raise ValueError(f"value {x} outside unsigned 32-bit range")
        hlc = self.high_low_container
        keys = hlc.keys
        key = x >> 16
        i = bisect_left(keys, key)
        if i == len(keys) or keys[i] != key:
            return False
        return hlc.containers[i].contains(x & 0xFFFF)

    # ------------------------------------------------------------------
    # range ops
    # ------------------------------------------------------------------
    def add_range(self, start: int, end: int) -> None:
        """Add [start, end) (RoaringBitmap.add(long,long), RoaringBitmap.java:1181)."""
        start, end = _check_range(start, end)
        if start == end:
            return
        self._apply_range(start, end, "add")

    def remove_range(self, start: int, end: int) -> None:
        """Remove [start, end) (RoaringBitmap.java:2656)."""
        start, end = _check_range(start, end)
        if start == end:
            return
        self._apply_range(start, end, "remove")

    def flip_range(self, start: int, end: int) -> None:
        """In-place flip of [start, end) (RoaringBitmap.flip, RoaringBitmap.java:1893)."""
        start, end = _check_range(start, end)
        if start == end:
            return
        self._apply_range(start, end, "flip")

    @staticmethod
    def flip(bm: "RoaringBitmap", start: int, end: int) -> "RoaringBitmap":
        out = bm.clone()
        out.flip_range(start, end)
        return out

    def _apply_range(self, start: int, end: int, mode: str) -> None:
        hb_start, hb_end = start >> 16, (end - 1) >> 16
        hlc = self.high_low_container
        for hb in range(hb_start, hb_end + 1):
            lo = start & 0xFFFF if hb == hb_start else 0
            hi = ((end - 1) & 0xFFFF) + 1 if hb == hb_end else 1 << 16
            i = hlc.get_index(hb)
            full_chunk = lo == 0 and hi == (1 << 16)
            if i >= 0:
                c = hlc.get_container_at_index(i)
                if mode == "add":
                    c = (
                        container_range_of_ones(0, 1 << 16)
                        if full_chunk
                        else c.add_range(lo, hi)
                    )
                elif mode == "remove":
                    c = c.remove_range(lo, hi)
                else:
                    c = c.flip_range(lo, hi)
                if c.cardinality == 0:
                    hlc.remove_at_index(i)
                else:
                    hlc.set_container_at_index(i, c)
            else:
                if mode == "remove":
                    continue
                # add and flip are identical on an absent container
                c = container_range_of_ones(lo, hi)
                if c.cardinality:
                    hlc.insert_new_key_value_at(-i - 1, hb, c)

    def contains_many(self, values) -> np.ndarray:
        """Vectorized membership: bool array aligned with ``values`` (the
        batch analogue of contains; what a retrieval stack calls to filter
        an ANN candidate list).

        One searchsorted against the bitmap's own key array classifies
        every probe, then each LIVE container answers its probes in one
        call — iterating the bitmap's (few) keys, not the probes' (many)
        key groups, so probes landing in absent chunks cost nothing (the
        workShyAnd pre-filter idea applied to point probes)."""
        v = np.asarray(values, dtype=np.int64).ravel()
        out = np.zeros(v.size, dtype=bool)
        if v.size == 0:
            return out
        keys = v >> 16
        hlc = self.high_low_container
        if len(hlc.keys) > v.size:
            # many-key bitmap, few probes: classifying probes against the
            # whole key array would cost more than per-group bisects
            for key, idx in _group_positions(keys):
                c = hlc.get_container(int(key))
                if c is not None:
                    out[idx] = c.contains_many((v[idx] & 0xFFFF).astype(np.uint16))
            return out
        hkeys = np.asarray(hlc.keys, dtype=np.int64)
        if hkeys.size == 0:
            return out
        pos = np.searchsorted(hkeys, keys)
        pos_c = np.minimum(pos, hkeys.size - 1)
        hit = hkeys[pos_c] == keys
        if not hit.any():
            return out
        containers = hlc.containers
        lows = (v & 0xFFFF).astype(np.uint16)
        hid = np.flatnonzero(hit)
        for ci, seg in _group_positions(pos_c[hid]):
            s = hid[seg]
            out[s] = containers[int(ci)].contains_many(lows[s])
        return out

    def rank_many(self, values) -> np.ndarray:
        """Vectorized rank: int64 array aligned with ``values``, each the
        count of set values <= v (the bulk twin of rank_long; the
        reference answers batch order statistics one rank() at a time,
        RoaringBitmap.java:2622). One container-level ``rank_many`` pass
        per distinct key chunk plus an exclusive cardinality prefix."""
        v = np.asarray(values, dtype=np.int64).ravel()
        out = np.zeros(v.size, dtype=np.int64)
        hlc = self.high_low_container
        if v.size == 0:
            return out
        if v.min() < 0 or v.max() >= _MAX32:
            raise ValueError("values outside unsigned 32-bit range")
        if hlc.size == 0:
            return out
        from ..utils.order_stats import bucketed_rank_many

        keys_arr = np.asarray(hlc.keys, dtype=np.int64)
        return bucketed_rank_many(
            keys_arr,
            self._cum_cards(),
            v >> 16,
            lambda i, pos: hlc.containers[i].rank_many(
                (v[pos] & 0xFFFF).astype(np.uint16)
            ),
        )

    def _cum_cards(self) -> np.ndarray:
        """Inclusive per-container cardinality cumsum — FastRank overrides
        with its invalidation-tracked cache."""
        return np.cumsum(
            np.array(
                [c.cardinality for c in self.high_low_container.containers],
                dtype=np.int64,
            )
        )

    def select_many(self, ranks) -> np.ndarray:
        """Vectorized select: uint32 array of the rank-th smallest values,
        aligned with ``ranks`` (bulk twin of select; a retrieval stack's
        "docIDs at ranks [r0..rk]" pagination ask). Raises IndexError when
        any rank is out of range, like the scalar."""
        from ..utils.order_stats import bucketed_select_many

        js = np.asarray(ranks, dtype=np.int64).ravel()
        if js.size == 0:  # skip the uncached cumsum for an empty page
            return np.zeros(0, dtype=np.uint32)
        hlc = self.high_low_container
        keys_arr = np.asarray(hlc.keys, dtype=np.int64)
        return bucketed_select_many(
            self._cum_cards(),
            js,
            lambda i, j: np.uint32(keys_arr[i] << 16)
            | hlc.containers[i].select_many(j).astype(np.uint32),
            dtype=np.uint32,
        )

    def contains_range(self, start: int, end: int) -> bool:
        """RoaringBitmap.contains(long,long)."""
        start, end = _check_range(start, end)
        if start == end:
            return True
        hb_start, hb_end = start >> 16, (end - 1) >> 16
        hlc = self.high_low_container
        for hb in range(hb_start, hb_end + 1):
            lo = start & 0xFFFF if hb == hb_start else 0
            hi = ((end - 1) & 0xFFFF) + 1 if hb == hb_end else 1 << 16
            i = hlc.get_index(hb)
            if i < 0 or not hlc.get_container_at_index(i).contains_range(lo, hi):
                return False
        return True

    def range_cardinality(self, start: int, end: int) -> int:
        """Number of set values in [start, end) (RoaringBitmap.java:2590)."""
        start, end = _check_range(start, end)
        if start >= end:
            return 0
        return self.rank_long(end - 1) - (self.rank_long(start - 1) if start else 0)

    def intersects_range(self, start: int, end: int) -> bool:
        start, end = _check_range(start, end)
        if start >= end:
            return False
        nv = self.next_value(start)
        return nv >= 0 and nv < end

    # ------------------------------------------------------------------
    # pairwise algebra (static, like the reference)
    # ------------------------------------------------------------------
    @staticmethod
    def and_(x1: "RoaringBitmap", x2: "RoaringBitmap", *more: "RoaringBitmap") -> "RoaringBitmap":
        """RoaringBitmap.and (RoaringBitmap.java:377): intersect keys, drop empties.

        With more than two operands this delegates to FastAggregation like
        the reference's ``and(Iterator)`` facade overload (:831-844). Above
        the columnar cutoff the whole pair executes as one batched op
        (``columnar/``); the per-container walk below stays the
        small-operand path and the differential reference."""
        if more:
            from ..parallel.aggregation import FastAggregation

            return FastAggregation.and_(x1, x2, *more)
        col = _columnar()
        tier = col.route(x1.high_low_container, x2.high_low_container, op="and")
        with col.outcome(tier):
            if tier != "per-container":
                return col.pairwise("and", x1, x2, tier=tier)
            return RoaringBitmap._and_percontainer(x1, x2)

    @staticmethod
    def _and_percontainer(x1: "RoaringBitmap", x2: "RoaringBitmap") -> "RoaringBitmap":
        out = RoaringBitmap()
        a, b = x1.high_low_container, x2.high_low_container
        akeys, acont, na = a.keys, a.containers, len(a.keys)
        bkeys, bcont, nb = b.keys, b.containers, len(b.keys)
        okeys, ocont = out.high_low_container.keys, out.high_low_container.containers
        ia = ib = 0
        while ia < na and ib < nb:
            ka, kb = akeys[ia], bkeys[ib]
            if ka == kb:
                c = acont[ia].and_(bcont[ib])
                if c.cardinality:
                    okeys.append(ka)
                    ocont.append(c)
                ia += 1
                ib += 1
            elif ka < kb:
                ia = a.advance_until(kb, ia)
            else:
                ib = b.advance_until(ka, ib)
        return out

    @staticmethod
    def or_(x1: "RoaringBitmap", x2: "RoaringBitmap", *more: "RoaringBitmap") -> "RoaringBitmap":
        """RoaringBitmap.or (RoaringBitmap.java:860): two-pointer key merge.

        With more than two operands this delegates to FastAggregation like the
        reference's ``or(RoaringBitmap...)`` facade overload (:831-844)."""
        if more:
            from ..parallel.aggregation import FastAggregation

            return FastAggregation.or_(x1, x2, *more)
        col = _columnar()
        tier = col.route(x1.high_low_container, x2.high_low_container, op="or")
        with col.outcome(tier):
            if tier != "per-container":
                return col.pairwise("or", x1, x2, tier=tier)
            return RoaringBitmap._merge_op(x1, x2, "or")

    @staticmethod
    def xor(x1: "RoaringBitmap", x2: "RoaringBitmap", *more: "RoaringBitmap") -> "RoaringBitmap":
        if more:
            from ..parallel.aggregation import FastAggregation

            return FastAggregation.xor(x1, x2, *more)
        col = _columnar()
        tier = col.route(x1.high_low_container, x2.high_low_container, op="xor")
        with col.outcome(tier):
            if tier != "per-container":
                return col.pairwise("xor", x1, x2, tier=tier)
            return RoaringBitmap._merge_op(x1, x2, "xor")

    @staticmethod
    def _merge_op(x1, x2, op: str, reuse_left: bool = False) -> "RoaringBitmap":
        """Two-pointer key merge. ``reuse_left`` transfers x1's pass-through
        containers without cloning — the in-place ops use it the way the
        reference's member or/xor mutate ``this`` but never alias ``x2``
        (RoaringBitmap.java member or :926; matched-key results are always
        fresh objects from the container op, so only pass-through clones
        are at stake)."""
        out = RoaringBitmap()
        a, b = x1.high_low_container, x2.high_low_container
        # loop-local bindings: the merge touches size/keys/containers every
        # iteration, and property + attribute hops were a third of or2by2
        akeys, acont, na = a.keys, a.containers, len(a.keys)
        bkeys, bcont, nb = b.keys, b.containers, len(b.keys)
        okeys, ocont = out.high_low_container.keys, out.high_low_container.containers
        ia = ib = 0
        while ia < na and ib < nb:
            ka, kb = akeys[ia], bkeys[ib]
            if ka == kb:
                c = (
                    acont[ia].or_(bcont[ib])
                    if op == "or"
                    else acont[ia].xor_(bcont[ib])
                )
                if c.cardinality:
                    okeys.append(ka)
                    ocont.append(c)
                ia += 1
                ib += 1
            elif ka < kb:
                okeys.append(ka)
                ocont.append(acont[ia] if reuse_left else acont[ia].clone())
                ia += 1
            else:
                okeys.append(kb)
                ocont.append(bcont[ib].clone())
                ib += 1
        while ia < na:
            okeys.append(akeys[ia])
            ocont.append(acont[ia] if reuse_left else acont[ia].clone())
            ia += 1
        while ib < nb:
            okeys.append(bkeys[ib])
            ocont.append(bcont[ib].clone())
            ib += 1
        return out

    @staticmethod
    def _restrict(bm: "RoaringBitmap", start: int, end: int) -> "RoaringBitmap":
        """Values of ``bm`` in ``[start, end)`` (selectRangeWithoutCopy,
        RoaringBitmap.java:3135): interior containers are shared-cloned,
        only the two boundary chunks are masked."""
        out = RoaringBitmap()
        if start >= end:
            return out
        hlc = bm.high_low_container
        first_key, last_key = start >> 16, (end - 1) >> 16
        i = hlc.advance_until(first_key, -1)
        while i < hlc.size and hlc.keys[i] <= last_key:
            k = hlc.keys[i]
            c = hlc.containers[i]
            lo = start - (k << 16) if k == first_key else 0
            hi = end - (k << 16) if k == last_key else 1 << 16
            if lo > 0 or hi < (1 << 16):
                c = c.and_(container_range_of_ones(lo, hi))
            # interior containers are shared, not cloned: the result is only
            # ever fed to non-mutating static algebra
            if c.cardinality:
                out.high_low_container.append(k, c)
            i += 1
        return out

    @staticmethod
    def andnot_range(
        x1: "RoaringBitmap", x2: "RoaringBitmap", range_start: int, range_end: int
    ) -> "RoaringBitmap":
        """Ranged difference: (x1 \\ x2) restricted to [range_start, range_end)
        (RoaringBitmap.andNot(x1, x2, rangeStart, rangeEnd),
        RoaringBitmap.java:1396-1402 — both operands are restricted to the
        range before the subtraction, so values of x1 outside it are dropped)."""
        range_start, range_end = _check_range(range_start, range_end)
        return RoaringBitmap.andnot(
            RoaringBitmap._restrict(x1, range_start, range_end),
            RoaringBitmap._restrict(x2, range_start, range_end),
        )

    @staticmethod
    def andnot(
        x1: "RoaringBitmap", x2: "RoaringBitmap", *, _reuse_left: bool = False
    ) -> "RoaringBitmap":
        """RoaringBitmap.andNot (RoaringBitmap.java:444). ``_reuse_left``
        transfers x1's pass-through containers unclone'd — ONLY for the
        in-place iandnot, which discards x1's old index; the static path
        must keep cloning because andnot_range feeds it _restrict views
        that share containers with live bitmaps."""
        col = _columnar()
        tier = col.route(x1.high_low_container, x2.high_low_container, op="andnot")
        with col.outcome(tier):
            if tier != "per-container":
                return col.pairwise("andnot", x1, x2, reuse_left=_reuse_left, tier=tier)
            return RoaringBitmap._andnot_percontainer(x1, x2, _reuse_left)

    @staticmethod
    def _andnot_percontainer(
        x1: "RoaringBitmap", x2: "RoaringBitmap", _reuse_left: bool
    ) -> "RoaringBitmap":
        out = RoaringBitmap()
        a, b = x1.high_low_container, x2.high_low_container
        akeys, acont, na = a.keys, a.containers, len(a.keys)
        bkeys, bcont, nb = b.keys, b.containers, len(b.keys)
        okeys, ocont = out.high_low_container.keys, out.high_low_container.containers
        ia = ib = 0
        while ia < na:
            ka = akeys[ia]
            while ib < nb and bkeys[ib] < ka:
                ib += 1
            if ib < nb and bkeys[ib] == ka:
                c = acont[ia].andnot(bcont[ib])
                if c.cardinality:
                    okeys.append(ka)
                    ocont.append(c)
            else:
                okeys.append(ka)
                ocont.append(acont[ia] if _reuse_left else acont[ia].clone())
            ia += 1
        return out

    def ior_not(self, other: "RoaringBitmap", range_end: int) -> "RoaringBitmap":
        """In-place orNot (the reference's member orNot(x2, rangeEnd)):
        this |= (~other restricted to [0, range_end)). Member-op
        semantics: self's old index is discarded, so its beyond-range
        pass-through chunks transfer unclone'd (the same reuse_left
        elision ior/ixor/iandnot already have)."""
        self.high_low_container = RoaringBitmap.or_not(
            self, other, range_end, _reuse_left=True
        ).high_low_container
        return self

    @staticmethod
    def or_not(
        x1: "RoaringBitmap", x2: "RoaringBitmap", range_end: int,
        *, _reuse_left: bool = False,
    ) -> "RoaringBitmap":
        """x1 | (~x2 ∩ [0, range_end)) (RoaringBitmap.orNot, RoaringBitmap.java:1521).

        Container walk: every key chunk of [0, range_end) gets the in-chunk
        complement of x2's container (full-range when absent) OR'd with x1's —
        no whole-universe bitmap is ever materialized. ``_reuse_left`` (the
        ior_not path only) transfers x1's beyond-range chunks unclone'd."""
        _, range_end = _check_range(0, range_end)
        out = RoaringBitmap()
        if range_end == 0:
            return RoaringBitmap.or_(x1, out)
        a, b = x1.high_low_container, x2.high_low_container
        last_key = (range_end - 1) >> 16
        for k in range(last_key + 1):
            range_len = min(1 << 16, range_end - (k << 16))
            ib = b.get_index(k)
            comp: Container = container_range_of_ones(0, range_len)
            if ib >= 0:
                comp = comp.andnot(b.containers[ib])
            ia = a.get_index(k)
            if ia >= 0:
                comp = comp.or_(a.containers[ia])
            if comp.cardinality:
                out.high_low_container.append(k, comp)
        # x1's chunks beyond the range pass through untouched
        ia = a.advance_until(last_key + 1, -1)
        while ia < a.size:
            out.high_low_container.append(
                a.keys[ia],
                a.containers[ia] if _reuse_left else a.containers[ia].clone(),
            )
            ia += 1
        return out

    @staticmethod
    def and_cardinality(x1: "RoaringBitmap", x2: "RoaringBitmap") -> int:
        """RoaringBitmap.andCardinality (RoaringBitmap.java:413). Above
        the columnar cutoff the count comes from the batched
        cardinality-only kernels: nothing materializes."""
        col = _columnar()
        if col.enabled_for(x1.high_low_container, x2.high_low_container):
            return col.and_cardinality_pair(x1, x2)
        return RoaringBitmap._and_cardinality_percontainer(x1, x2)

    @staticmethod
    def _and_cardinality_percontainer(x1: "RoaringBitmap", x2: "RoaringBitmap") -> int:
        total = 0
        a, b = x1.high_low_container, x2.high_low_container
        ia = ib = 0
        while ia < a.size and ib < b.size:
            ka, kb = a.keys[ia], b.keys[ib]
            if ka == kb:
                total += a.containers[ia].and_cardinality(b.containers[ib])
                ia += 1
                ib += 1
            elif ka < kb:
                ia = a.advance_until(kb, ia)
            else:
                ib = b.advance_until(ka, ib)
        return total

    @staticmethod
    def or_cardinality(x1: "RoaringBitmap", x2: "RoaringBitmap") -> int:
        """Inclusion-exclusion (RoaringBitmap.java:916)."""
        return (
            x1.get_cardinality()
            + x2.get_cardinality()
            - RoaringBitmap.and_cardinality(x1, x2)
        )

    @staticmethod
    def xor_cardinality(x1: "RoaringBitmap", x2: "RoaringBitmap") -> int:
        return (
            x1.get_cardinality()
            + x2.get_cardinality()
            - 2 * RoaringBitmap.and_cardinality(x1, x2)
        )

    @staticmethod
    def andnot_cardinality(x1: "RoaringBitmap", x2: "RoaringBitmap") -> int:
        return x1.get_cardinality() - RoaringBitmap.and_cardinality(x1, x2)

    @staticmethod
    def intersects(x1: "RoaringBitmap", x2: "RoaringBitmap") -> bool:
        """RoaringBitmap.intersects (RoaringBitmap.java:698). The columnar
        path short-circuits between class batches instead of between
        containers."""
        col = _columnar()
        if col.enabled_for(x1.high_low_container, x2.high_low_container):
            return col.intersects_pair(x1, x2)
        return RoaringBitmap._intersects_percontainer(x1, x2)

    @staticmethod
    def _intersects_percontainer(x1: "RoaringBitmap", x2: "RoaringBitmap") -> bool:
        a, b = x1.high_low_container, x2.high_low_container
        ia = ib = 0
        while ia < a.size and ib < b.size:
            ka, kb = a.keys[ia], b.keys[ib]
            if ka == kb:
                if a.containers[ia].intersects(b.containers[ib]):
                    return True
                ia += 1
                ib += 1
            elif ka < kb:
                ia = a.advance_until(kb, ia)
            else:
                ib = b.advance_until(ka, ib)
        return False

    # in-place variants + operators. The member-op pass-through transfer
    # (reuse_left, on the columnar engine too) is safe exactly because
    # these discard self's old index.
    def ior(self, other: "RoaringBitmap") -> "RoaringBitmap":
        self.high_low_container = self._inplace_merge(other, "or")
        return self

    def iand(self, other: "RoaringBitmap") -> "RoaringBitmap":
        self.high_low_container = RoaringBitmap.and_(self, other).high_low_container
        return self

    def ixor(self, other: "RoaringBitmap") -> "RoaringBitmap":
        self.high_low_container = self._inplace_merge(other, "xor")
        return self

    def _inplace_merge(self, other: "RoaringBitmap", op: str):
        col = _columnar()
        tier = col.route(self.high_low_container, other.high_low_container, op=op)
        with col.outcome(tier):
            if tier != "per-container":
                return col.pairwise(op, self, other, reuse_left=True, tier=tier).high_low_container
            return RoaringBitmap._merge_op(self, other, op, reuse_left=True).high_low_container

    def iandnot(self, other: "RoaringBitmap") -> "RoaringBitmap":
        self.high_low_container = RoaringBitmap.andnot(
            self, other, _reuse_left=True
        ).high_low_container
        return self

    __or__ = lambda self, o: RoaringBitmap.or_(self, o)
    __and__ = lambda self, o: RoaringBitmap.and_(self, o)
    __xor__ = lambda self, o: RoaringBitmap.xor(self, o)
    __sub__ = lambda self, o: RoaringBitmap.andnot(self, o)
    __ior__ = ior
    __iand__ = iand
    __ixor__ = ixor
    __isub__ = iandnot

    # ------------------------------------------------------------------
    # cardinality / order statistics
    # ------------------------------------------------------------------
    def get_cardinality(self) -> int:
        return sum(c.cardinality for c in self.high_low_container.containers)

    get_long_cardinality = get_cardinality  # getLongCardinality alias

    def is_empty(self) -> bool:
        return self.high_low_container.size == 0

    def rank_long(self, x: int) -> int:
        """Values <= x (RoaringBitmap.rank, RoaringBitmap.java:2622)."""
        x = _check_value(x)
        hb, lb = x >> 16, x & 0xFFFF
        total = 0
        hlc = self.high_low_container
        for k, c in zip(hlc.keys, hlc.containers):
            if k < hb:
                total += c.cardinality
            elif k == hb:
                total += c.rank(lb)
            else:
                break
        return total

    rank = rank_long

    def select(self, j: int) -> int:
        """j-th smallest value, 0-based (RoaringBitmap.select, RoaringBitmap.java:2820)."""
        j = int(j)
        if j < 0:
            raise IndexError(j)
        hlc = self.high_low_container
        for k, c in zip(hlc.keys, hlc.containers):
            card = c.cardinality
            if j < card:
                return (k << 16) | c.select(j)
            j -= card
        raise IndexError("select out of range")

    def first(self) -> int:
        if self.is_empty():
            raise ValueError("empty bitmap")
        hlc = self.high_low_container
        return (hlc.keys[0] << 16) | hlc.containers[0].first()

    def last(self) -> int:
        if self.is_empty():
            raise ValueError("empty bitmap")
        hlc = self.high_low_container
        return (hlc.keys[-1] << 16) | hlc.containers[-1].last()

    def first_signed(self) -> int:
        """Smallest value in signed-int32 order (RoaringBitmap.firstSigned):
        the first value >= 2^31 if any negative-half values exist."""
        v = self.next_value(1 << 31)
        if v >= 0:
            return v - _MAX32
        return self.first()

    def last_signed(self) -> int:
        """Largest value in signed-int32 order (RoaringBitmap.lastSigned)."""
        v = self.previous_value((1 << 31) - 1)
        if v >= 0:
            return v
        return self.last() - _MAX32

    def cardinality_exceeds(self, threshold: int) -> bool:
        """True once the running cardinality passes threshold, without
        visiting remaining containers (RoaringBitmap.cardinalityExceeds)."""
        total = 0
        for c in self.high_low_container.containers:
            total += c.cardinality
            if total > threshold:
                return True
        return False

    def clear(self) -> None:
        """Empty the bitmap in place (RoaringBitmap.clear)."""
        from .roaring_array import RoaringArray

        self.high_low_container = RoaringArray()

    def trim(self) -> None:
        """Release excess capacity (RoaringBitmap.trim). Storage here is
        exact-sized numpy arrays, so this is a documented no-op."""

    def append(self, key: int, container) -> None:
        """Append a (key, container) pair; ``key`` must exceed the current
        maximum key (RoaringBitmap.append, RoaringBitmap.java:3237 — the
        expert bulk-construction hook used by the writers)."""
        self.high_low_container.append(int(key), container)

    def for_each(self, consumer) -> None:
        """Visit every value in ascending order (RoaringBitmap.forEach,
        IntConsumer contract)."""
        for k, c in zip(self.high_low_container.keys, self.high_low_container.containers):
            base = k << 16
            for v in c.to_array().tolist():
                consumer(base | v)

    def _values_in_value_range(self, start: int, end: int) -> "RoaringBitmap":
        """Members with start <= value < end, as a bitmap (cheap: the range
        mask is a handful of run containers)."""
        if start >= end:
            return RoaringBitmap()
        return RoaringBitmap.and_(self, RoaringBitmap.bitmap_of_range(start, end))

    def for_each_in_range(self, start: int, end: int, consumer) -> None:
        """Visit every *present* value in [start, end) ascending
        (RoaringBitmap.forEachInRange)."""
        start, end = _check_range(start, end)
        for v in self._values_in_value_range(start, end):
            consumer(v)

    def for_all_in_range(self, start: int, end: int, consumer) -> None:
        """Visit every *position* in [start, end) with its membership —
        the RelativeRangeConsumer contract (RoaringBitmap.forAllInRange):
        ``consumer(relative_pos, present)``. Streams per 2^16-chunk so wide
        ranges stay O(chunk) in memory, like the Java per-container walk."""
        start, end = _check_range(start, end)
        for cs in range(start, end, 1 << 16):
            ce = min(cs + (1 << 16), end)
            present = self._values_in_value_range(cs, ce)
            flags = np.zeros(ce - cs, dtype=bool)
            if present.get_cardinality():
                flags[present.to_array().astype(np.int64) - cs] = True
            base = cs - start
            for pos, flag in enumerate(flags):
                consumer(base + pos, bool(flag))

    def get_container_pointer(self) -> "ContainerPointer":
        """Ordered cursor over (key, container) pairs — the SPI used by
        horizontal aggregation (ContainerPointer.java, RoaringBitmap
        .getContainerPointer)."""
        return ContainerPointer(self)

    def next_value(self, from_value: int) -> int:
        """Smallest value >= from_value, or -1 (RoaringBitmap.java:2838)."""
        from_value = _check_value(from_value)
        hb, lb = from_value >> 16, from_value & 0xFFFF
        hlc = self.high_low_container
        i = hlc.get_index(hb)
        start = i if i >= 0 else -i - 1
        for j in range(start, hlc.size):
            k = hlc.keys[j]
            v = hlc.containers[j].next_value(lb if k == hb else 0)
            if v >= 0:
                return (k << 16) | v
        return -1

    def previous_value(self, from_value: int) -> int:
        from_value = _check_value(from_value)
        hb, lb = from_value >> 16, from_value & 0xFFFF
        hlc = self.high_low_container
        i = hlc.get_index(hb)
        start = i if i >= 0 else -i - 2
        for j in range(start, -1, -1):
            k = hlc.keys[j]
            v = hlc.containers[j].previous_value(lb if k == hb else 0xFFFF)
            if v >= 0:
                return (k << 16) | v
        return -1

    def next_absent_value(self, from_value: int) -> int:
        from_value = _check_value(from_value)
        x = from_value
        while x < _MAX32:
            hb, lb = x >> 16, x & 0xFFFF
            c = self.high_low_container.get_container(hb)
            if c is None:
                return x
            v = c.next_absent_value(lb)
            if v < (1 << 16):
                return (hb << 16) | v
            x = (hb + 1) << 16
        return -1

    def previous_absent_value(self, from_value: int) -> int:
        from_value = _check_value(from_value)
        x = from_value
        while x >= 0:
            hb, lb = x >> 16, x & 0xFFFF
            c = self.high_low_container.get_container(hb)
            if c is None:
                return x
            v = c.previous_absent_value(lb)
            if v >= 0:
                return (hb << 16) | v
            x = (hb << 16) - 1
        return -1

    # ------------------------------------------------------------------
    # structural ops
    # ------------------------------------------------------------------
    @staticmethod
    def add_offset(bm: "RoaringBitmap", offset: int) -> "RoaringBitmap":
        """Shift all values by a (possibly negative) offset, dropping values
        leaving the 32-bit universe (RoaringBitmap.addOffset, RoaringBitmap.java:230).

        Each shifted container splits into a (low, high) pair
        (Util.addOffset, Util.java:32-45) — realized here vectorized on the
        value arrays.
        """
        offset = int(offset)
        out = RoaringBitmap()
        hlc = bm.high_low_container
        pieces = {}
        for k, c in zip(hlc.keys, hlc.containers):
            vals = c.to_array().astype(np.int64) + (k << 16) + offset
            vals = vals[(vals >= 0) & (vals < _MAX32)]
            if vals.size == 0:
                continue
            keys = vals >> 16
            for key in np.unique(keys):
                chunk = (vals[keys == key] & 0xFFFF).astype(np.uint16)
                if int(key) in pieces:
                    pieces[int(key)] = np.concatenate([pieces[int(key)], chunk])
                else:
                    pieces[int(key)] = chunk
        for key in sorted(pieces):
            out.high_low_container.append(
                key, container_from_values(np.sort(pieces[key]))
            )
        return out

    def limit(self, max_cardinality: int) -> "RoaringBitmap":
        """Bitmap of the max_cardinality smallest values (RoaringBitmap.java:2457)."""
        out = RoaringBitmap()
        remaining = int(max_cardinality)
        hlc = self.high_low_container
        for k, c in zip(hlc.keys, hlc.containers):
            if remaining <= 0:
                break
            card = c.cardinality
            if card <= remaining:
                out.high_low_container.append(k, c.clone())
                remaining -= card
            else:
                out.high_low_container.append(
                    k, container_from_values(c.to_array()[:remaining])
                )
                remaining = 0
        return out

    def select_range(self, start: int, end: int) -> "RoaringBitmap":
        """Bitmap of values with rank in [start, end) (RoaringBitmap.selectRange,
        RoaringBitmap.java:3095)."""
        start, end = int(start), int(end)
        out = RoaringBitmap()
        if start >= end:
            return out
        seen = 0  # cumulative cardinality before the current container
        hlc = self.high_low_container
        for k, c in zip(hlc.keys, hlc.containers):
            card = c.cardinality
            if seen + card <= start:
                seen += card
                continue
            if seen >= end:
                break
            lo, hi = max(start - seen, 0), min(end - seen, card)
            if lo == 0 and hi == card:
                out.high_low_container.append(k, c.clone())
            else:
                out.high_low_container.append(
                    k, container_from_values(c.to_array()[lo:hi])
                )
            seen += card
        return out

    def run_optimize(self) -> bool:
        """Convert containers to their smallest form; True if any became a run
        (RoaringBitmap.java:2764)."""
        changed = False
        hlc = self.high_low_container
        for i, c in enumerate(hlc.containers):
            n = c.run_optimize()
            if isinstance(n, RunContainer) and not isinstance(c, RunContainer):
                changed = True
            hlc.set_container_at_index(i, n)
        return changed

    def remove_run_compression(self) -> bool:
        changed = False
        hlc = self.high_low_container
        for i, c in enumerate(hlc.containers):
            if isinstance(c, RunContainer):
                hlc.set_container_at_index(i, c.to_efficient_non_run())
                changed = True
        return changed

    def has_run_compression(self) -> bool:
        return any(
            isinstance(c, RunContainer) for c in self.high_low_container.containers
        )

    def contains_bitmap(self, subset: "RoaringBitmap") -> bool:
        """True if subset ⊆ self (RoaringBitmap.contains(RoaringBitmap),
        RoaringBitmap.java:2781)."""
        a, b = self.high_low_container, subset.high_low_container
        ib = 0
        for kb, cb in zip(b.keys, b.containers):
            i = a.get_index(kb)
            if i < 0 or not a.containers[i].contains_container(cb):
                return False
        return True

    def is_hamming_similar(self, other: "RoaringBitmap", tolerance: int) -> bool:
        """|self XOR other| <= tolerance (RoaringBitmap.java:1831)."""
        return RoaringBitmap.xor_cardinality(self, other) <= int(tolerance)

    # ------------------------------------------------------------------
    # iteration / export
    # ------------------------------------------------------------------
    def to_array(self) -> np.ndarray:
        """All values, sorted, as uint32."""
        hlc = self.high_low_container
        if hlc.size == 0:
            return np.empty(0, dtype=np.uint32)
        parts = [
            c.to_array().astype(np.uint32) + np.uint32(k << 16)
            for k, c in zip(hlc.keys, hlc.containers)
        ]
        return np.concatenate(parts)

    def __iter__(self) -> Iterator[int]:
        for k, c in zip(
            self.high_low_container.keys, self.high_low_container.containers
        ):
            base = k << 16
            for v in c.to_array().tolist():
                yield base | v

    def __reversed__(self) -> Iterator[int]:
        for k, c in zip(
            reversed(self.high_low_container.keys),
            reversed(self.high_low_container.containers),
        ):
            base = k << 16
            for v in reversed(c.to_array().tolist()):
                yield base | v

    def get_int_iterator(self):
        """Peekable forward iterator (getIntIterator; PeekableIntIterator)."""
        from .iterators import PeekableIntIterator

        return PeekableIntIterator(self)

    def get_signed_int_iterator(self) -> Iterator[int]:
        """Values in signed-int32 order: the upper half (>= 2^31, as
        negatives) first (RoaringBitmap.getSignedIntIterator). The first
        pass skips whole containers straight to the upper half."""
        half = 1 << 31
        it = self.get_int_iterator()
        it.advance_if_needed(half)
        while it.has_next():
            yield it.next() - _MAX32
        for v in self:
            if v >= half:
                break
            yield v

    def get_reverse_int_iterator(self):
        """Descending iterator (getReverseIntIterator)."""
        from .iterators import ReverseIntIterator

        return ReverseIntIterator(self)

    def get_int_rank_iterator(self):
        """Rank-tracking peekable iterator (getIntRankIterator)."""
        from .iterators import PeekableIntRankIterator

        return PeekableIntRankIterator(self)

    def get_batch_iterator(self):
        """Buffer-filling iterator (getBatchIterator, BatchIterator.java:12)."""
        from .iterators import RoaringBatchIterator

        return RoaringBatchIterator(self)

    def batch_iterator(self, batch_size: int = 256) -> Iterator[np.ndarray]:
        """Buffer-filling iteration (BatchIterator.nextBatch contract,
        BatchIterator.java:12), yielding uint32 chunks."""
        buf: List[np.ndarray] = []
        count = 0
        for k, c in zip(
            self.high_low_container.keys, self.high_low_container.containers
        ):
            arr = c.to_array().astype(np.uint32) + np.uint32(k << 16)
            buf.append(arr)
            count += arr.size
            while count >= batch_size:
                joined = np.concatenate(buf) if len(buf) > 1 else buf[0]
                yield joined[:batch_size]
                rest = joined[batch_size:]
                buf = [rest] if rest.size else []
                count = rest.size
        if count:
            yield np.concatenate(buf) if len(buf) > 1 else buf[0]

    # ------------------------------------------------------------------
    # introspection (SURVEY §5 observability)
    # ------------------------------------------------------------------
    def fingerprint(self) -> tuple:
        """Cheap mutation-tracking token: ``(array generation, mutation
        version)``. Every mutator bumps the version (or, for the in-place
        algebra that swaps in a fresh ``RoaringArray``, changes the
        generation), so two equal fingerprints of the same bitmap object
        guarantee unchanged contents. O(1); NOT a content hash: two equal
        bitmaps have different fingerprints."""
        return hlc_fingerprint(self.high_low_container)

    def get_container_count(self) -> int:
        return self.high_low_container.size

    def get_size_in_bytes(self) -> int:
        from ..serialization import serialized_size_in_bytes

        return serialized_size_in_bytes(self)

    get_long_size_in_bytes = get_size_in_bytes

    # serialization facade (implementation in serialization.py)
    def serialize(self) -> bytes:
        from ..serialization import serialize

        return serialize(self)

    def serialized_size_in_bytes(self) -> int:
        """Exact byte size of serialize() (RoaringBitmap.serializedSizeInBytes)."""
        from ..serialization import serialized_size_in_bytes

        return serialized_size_in_bytes(self)

    def serialize_into(self, stream) -> int:
        """Write the portable format to a binary file-like object; returns
        bytes written (the DataOutput/stream overloads of
        RoaringBitmap.serialize, RoaringBitmap.java:3012)."""
        data = self.serialize()
        stream.write(data)
        return len(data)

    @staticmethod
    def deserialize(data, copy: bool = True) -> "RoaringBitmap":
        from ..serialization import deserialize

        return deserialize(data, copy=copy)

    @classmethod
    def deserialize_from(cls, stream) -> "RoaringBitmap":
        """Read one bitmap from a binary file-like object positioned at its
        start; forward-only reads consume exactly the bitmap's bytes, so
        consecutive bitmaps stream back-to-back and non-seekable sources
        (sockets, pipes) work (the DataInput overload of
        RoaringBitmap.deserialize). Classmethod: subclasses deserialize to
        their own type."""
        from ..serialization import read_from_stream

        bm = cls()
        read_from_stream(bm, stream)
        return bm

    @staticmethod
    def maximum_serialized_size(cardinality: int, universe_size: int) -> int:
        from ..serialization import maximum_serialized_size

        return maximum_serialized_size(cardinality, universe_size)

    def __reduce__(self):
        """Pickle via the portable wire format — the Externalizable/Kryo
        analogue (RoaringBitmap.java:2627/3287, README.md:285-312).
        Subclasses (MutableRoaringBitmap, FastRankRoaringBitmap)
        round-trip to their own type."""
        return _roaring_from_bytes, (type(self), self.serialize())

    # ------------------------------------------------------------------
    def __eq__(self, other):
        if not isinstance(other, RoaringBitmap):
            return NotImplemented
        return self.high_low_container == other.high_low_container

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
        head = ",".join(str(v) for v in self.to_array()[:10].tolist())
        return f"RoaringBitmap(card={card}, values=[{head}{'...' if card > 10 else ''}])"


def _roaring_from_bytes(cls, blob: bytes) -> "RoaringBitmap":
    """Pickle reconstructor: deserialize then adopt into the target class."""
    out = cls()
    out.high_low_container = RoaringBitmap.deserialize(blob).high_low_container
    return out


class ContainerPointer:
    """Ordered cursor over a bitmap's (key, container) pairs
    (ContainerPointer.java:62): the SPI horizontal aggregation uses to
    merge many bitmaps key-by-key. ``key()`` is None when exhausted."""

    __slots__ = ("_hlc", "_i")

    def __init__(self, bm: "RoaringBitmap"):
        self._hlc = bm.high_low_container
        self._i = 0

    def key(self) -> Optional[int]:
        return self._hlc.keys[self._i] if self._i < self._hlc.size else None

    def get_container(self) -> Optional["Container"]:
        return (
            self._hlc.get_container_at_index(self._i)
            if self._i < self._hlc.size
            else None
        )

    def get_cardinality(self) -> int:
        c = self.get_container()
        return c.cardinality if c is not None else 0

    def is_bitmap_container(self) -> bool:
        return isinstance(self.get_container(), BitmapContainer)

    def is_run_container(self) -> bool:
        return isinstance(self.get_container(), RunContainer)

    def advance(self) -> None:
        self._i += 1

    def __lt__(self, other: "ContainerPointer") -> bool:
        a, b = self.key(), other.key()
        if a is None:
            return False
        if b is None:
            return True
        return a < b
