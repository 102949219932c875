"""64-bit bit-sliced index on PyTorch and CUDA: ``Roaring64BitmapSliceIndex``
(bsi/longlong/Roaring64BitmapSliceIndex.java:16) — 64-bit values over
64-bit column ids, backed by the ART-based ``Roaring64Bitmap``.

Counterpart of the JAX package's ``models/bsi64.py``. Same vertical layout
and O'Neil compare as the 32-bit index (models/bsi.py;
RoaringBitmapSliceIndex.java:432-469), with up to 64 slices. The CPU path
walks the 64-bit bitmaps; the device path packs the slices over the ebm's
K high-48 chunk keys into an int32 ``[S, K, 2048]`` tensor plus the ``[K,
2048]`` ebm words — the same physical layout as the 32-bit pack, so the
same hand-written kernels answer it: a compare is one ``rb_oneil_compare``
launch (``ops/kernels.oneil_compare``; RANGE runs both walks in it) and
``compare_cardinality_many`` one count-only launch of the tiled walk
(``rb_oneil_counts``) for the whole batch. The key width only changes the
host-side directory. The pack is resident in the shared
``store.PACK_CACHE`` under ``("bsi64", id(self), _version, device)`` with
the index held as the entry's ref; every mutation through the index
re-keys it.

``mode="auto"`` picks the device path by index size only (``bit_count() *
chunk count >= config.min_device_cells``), never by probing for a card;
it runs on ``bsi.config.device`` (default ``"cuda"``, shared with the
32-bit index), and ``"cuda"`` without a card raises ``TierUnavailable``.
With ``config.mesh`` set, ``compare_cardinality_many`` runs sharded over
that mesh through the 32-bit index's mesh walk (``bsi._mesh_batched_counts``:
the same physical pack); single-predicate 64-bit queries stay unsharded,
as in the JAX package.

Also carries the reference's ranking helpers: ``top_k``
(Roaring64BitmapSliceIndex.java:572 slice-descent), ``transpose`` (:596) and
``transpose_with_count`` (:603).
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops import device as dev
from ..ops import kernels
from ..parallel import store
from ..serialization import InvalidRoaringFormat
from . import bsi
from .bsi import Operation, min_max_verdict
from .roaring64art import Roaring64Bitmap, key_to_int


class config:
    """Dispatcher knobs for the 64-bit index (the device is
    ``bsi.config.device``)."""

    mode: str = "auto"  # 'auto' | 'cpu' | 'device'
    min_device_cells = 4096  # slices x key-chunks below which CPU wins
    # a DeviceMesh (parallel/sharding.make_mesh()): when set, batched
    # compare_cardinality_many runs sharded over it
    mesh = None


class Roaring64BitmapSliceIndex:
    """64-bit BSI (bsi/longlong/Roaring64BitmapSliceIndex.java:16)."""

    def __init__(self, min_value: int = 0, max_value: int = 0):
        if min_value < 0 or max_value < 0:
            raise ValueError("BSI values must be non-negative")
        self.min_value = int(min_value)
        self.max_value = int(max_value)
        self.ebm = Roaring64Bitmap()
        self.slices: List[Roaring64Bitmap] = [
            Roaring64Bitmap() for _ in range(max(0, int(max_value)).bit_length())
        ]
        self.run_optimized = False
        # mutation counter: keys this index's resident pack in the shared
        # PACK_CACHE (the 64-bit bitmaps have no fingerprint, so the entry
        # key is (id(self), _version) with self held as a ref — see
        # _pack_dense64)
        self._version = 0

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    def bit_count(self) -> int:
        return len(self.slices)

    def _grow(self, bit_depth: int) -> None:
        while len(self.slices) < bit_depth:
            self.slices.append(Roaring64Bitmap())

    def _ensure_capacity(self, lo: int, hi: int) -> None:
        if self.ebm.is_empty():
            self.min_value, self.max_value = lo, hi
            self._grow(max(1, hi.bit_length()))
        else:
            if lo < self.min_value:
                self.min_value = lo
            if hi > self.max_value:
                self.max_value = hi
                self._grow(max(1, hi.bit_length()))

    def set_value(self, column_id: int, value: int) -> None:
        """setValue (Roaring64BitmapSliceIndex.java:291)."""
        value = int(value)
        if value < 0:
            raise ValueError("BSI values must be non-negative")
        self._ensure_capacity(value, value)
        for i in range(self.bit_count()):
            if (value >> i) & 1:
                self.slices[i].add(column_id)
            else:
                self.slices[i].remove(column_id)
        self.ebm.add(column_id)
        self._version += 1

    def set_values(self, pairs) -> None:
        """Vectorized bulk load (setValues, Roaring64BitmapSliceIndex.java:341);
        accepts (columns, values) parallel arrays or an iterable of pairs,
        last-pair-wins on duplicate columns."""
        if isinstance(pairs, tuple) and len(pairs) == 2:
            cols, vals = pairs
        else:
            seq = list(pairs)
            if not seq:
                return
            cols = [p[0] for p in seq]
            vals = [p[1] for p in seq]
        cols = np.asarray(cols, dtype=np.uint64)
        vals_arr = np.asarray(vals)
        if (
            vals_arr.size
            and not np.issubdtype(vals_arr.dtype, np.unsignedinteger)
            and vals_arr.min() < 0
        ):
            raise ValueError("BSI values must be non-negative")
        vals = vals_arr.astype(np.uint64)
        if cols.size == 0:
            return
        _, last_idx = np.unique(cols[::-1], return_index=True)
        keep = np.sort(cols.size - 1 - last_idx)
        if keep.size != cols.size:
            cols, vals = cols[keep], vals[keep]
        self._ensure_capacity(int(vals.min()), int(vals.max()))
        if not self.ebm.is_empty():
            existing = Roaring64Bitmap(cols)
            overlap = Roaring64Bitmap.and_(self.ebm, existing)
            if not overlap.is_empty():
                for s in self.slices:
                    s.iandnot(overlap)
        for i in range(self.bit_count()):
            mask = (vals >> np.uint64(i)) & np.uint64(1) == 1
            if mask.any():
                self.slices[i].add_many(cols[mask])
        self.ebm.add_many(cols)
        self._version += 1

    def get_value(self, column_id: int) -> Tuple[int, bool]:
        """Single-column read; batch reads should use :meth:`get_values`
        (one vectorized membership pass per slice)."""
        if not self.ebm.contains(column_id):
            return 0, False
        value = 0
        for i, s in enumerate(self.slices):
            if s.contains(column_id):
                value |= 1 << i
        return value, True

    def get_values(self, columns) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized bulk read: ``(values, exists)`` parallel to
        ``columns`` (the 32-bit index's core, bsi._bulk_get_values:
        object-dtype exact above 63 slices, int64 otherwise)."""
        return bsi._bulk_get_values(
            self, np.asarray(columns).astype(np.uint64, copy=False).ravel()
        )

    def value_exist(self, column_id: int) -> bool:
        return self.ebm.contains(column_id)

    def get_existence_bitmap(self) -> Roaring64Bitmap:
        return self.ebm

    def get_long_cardinality(self) -> int:
        return self.ebm.get_cardinality()

    get_cardinality = get_long_cardinality

    def clone(self) -> "Roaring64BitmapSliceIndex":
        out = Roaring64BitmapSliceIndex()
        out.min_value, out.max_value = self.min_value, self.max_value
        out.ebm = self.ebm.clone()
        out.slices = [s.clone() for s in self.slices]
        out.run_optimized = self.run_optimized
        return out

    def run_optimize(self) -> None:
        self.ebm.run_optimize()
        for s in self.slices:
            s.run_optimize()
        self.run_optimized = True
        self._version += 1

    def has_run_compression(self) -> bool:
        return self.run_optimized

    # ------------------------------------------------------------------
    # combination (add :64 / merge :357)
    # ------------------------------------------------------------------
    def merge(self, other: "Roaring64BitmapSliceIndex") -> None:
        if other is None or other.ebm.is_empty():
            return
        if self.ebm.intersects(other.ebm):
            raise ValueError("merge requires disjoint column sets")
        depth = max(self.bit_count(), other.bit_count())
        self._grow(depth)
        for i in range(other.bit_count()):
            self.slices[i].ior(other.slices[i])
        self.ebm.ior(other.ebm)
        self.min_value = min(self.min_value, other.min_value)
        self.max_value = max(self.max_value, other.max_value)
        self._version += 1

    def add(self, other: "Roaring64BitmapSliceIndex") -> None:
        if other is None or other.ebm.is_empty():
            return
        self.ebm.ior(other.ebm)
        if other.bit_count() > self.bit_count():
            self._grow(other.bit_count())
        for i in range(other.bit_count()):
            self._add_digit(other.slices[i], i)
        self.min_value = self._min_value()
        self.max_value = self._max_value()
        self._version += 1

    def _add_digit(self, found_set: Roaring64Bitmap, i: int) -> None:
        carry = Roaring64Bitmap.and_(self.slices[i], found_set)
        self.slices[i].ixor(found_set)
        if not carry.is_empty():
            if i + 1 >= self.bit_count():
                self._grow(self.bit_count() + 1)
            self._add_digit(carry, i + 1)

    add_digit = _add_digit

    def _min_value(self) -> int:
        if self.ebm.is_empty():
            return 0
        ids = self.ebm
        for i in range(self.bit_count() - 1, -1, -1):
            tmp = Roaring64Bitmap.andnot(ids, self.slices[i])
            if not tmp.is_empty():
                ids = tmp
        return self.get_value(ids.first())[0]

    def _max_value(self) -> int:
        if self.ebm.is_empty():
            return 0
        ids = self.ebm
        for i in range(self.bit_count() - 1, -1, -1):
            tmp = Roaring64Bitmap.and_(ids, self.slices[i])
            if not tmp.is_empty():
                ids = tmp
        return self.get_value(ids.first())[0]

    # ------------------------------------------------------------------
    # queries (compare :460, o'neil :398-458)
    # ------------------------------------------------------------------
    def compare(
        self,
        operation: Operation,
        start_or_value: int,
        end: int = 0,
        found_set: Optional[Roaring64Bitmap] = None,
        mode: Optional[str] = None,
    ) -> Roaring64Bitmap:
        res = self._compare_using_min_max(operation, start_or_value, end, found_set)
        if res is not None:
            return res
        if operation == Operation.RANGE:
            end = min(int(end), (1 << self.bit_count()) - 1)
            if self._use_device(mode):
                return self._o_neil_device(operation, start_or_value, found_set, end=end)
            left = self._o_neil(Operation.GE, start_or_value, found_set)
            right = self._o_neil(Operation.LE, end, found_set)
            return Roaring64Bitmap.and_(left, right)
        if self._use_device(mode):
            return self._o_neil_device(operation, start_or_value, found_set)
        return self._o_neil(operation, start_or_value, found_set)

    def compare_cardinality(
        self,
        operation: Operation,
        start_or_value: int,
        end: int = 0,
        found_set: Optional[Roaring64Bitmap] = None,
        mode: Optional[str] = None,
    ) -> int:
        """Count-only compare (the 32-bit compare_cardinality twin): the
        min/max verdicts resolve without materializing, and the device path
        fetches only per-chunk popcounts — no result words, no container
        rebuild."""
        verdict = min_max_verdict(
            operation, start_or_value, end, self.min_value, self.max_value
        )
        if verdict == "empty":
            return 0
        if verdict == "fixed":
            return (self.ebm if found_set is None else found_set).get_cardinality()
        if verdict == "all":
            if found_set is None:
                return self.ebm.get_cardinality()
            return Roaring64Bitmap.and_cardinality(self.ebm, found_set)
        if self._use_device(mode):
            if operation == Operation.RANGE:
                end = min(int(end), (1 << self.bit_count()) - 1)
            keys, _out, cards = self._o_neil_device_walk(
                operation, start_or_value, found_set, end, count_only=True
            )
            total = int(cards.cpu().numpy().astype(np.int64).sum())
            if operation == Operation.NEQ and found_set is not None:
                total += self._neq_outside_ebm(found_set, keys)
            return total
        return self.compare(
            operation, start_or_value, end, found_set, mode="cpu"
        ).get_cardinality()

    def compare_cardinality_many(
        self,
        operation: Operation,
        values,
        ends=None,
        found_set: Optional[Roaring64Bitmap] = None,
        mode: Optional[str] = None,
    ) -> np.ndarray:
        """Batched count-only compare over [Q] 64-bit thresholds (exact
        Python ints up to 2^64 - 1): on the device path every predicate
        the min/max verdict leaves open rides one count-only launch over
        the ``[S, K, 2048]`` high-48-chunk pack (the 32-bit engine,
        bsi._counts_many), on each rank of ``config.mesh`` when set."""
        return bsi._counts_many(
            self, operation, values, ends, found_set, mode, mesh=config.mesh
        )

    def _pack_with_fixed(self, found_set: Optional[Roaring64Bitmap]):
        """(keys, ebm_w, slices_w, fixed_w) over high-48 chunk keys — the
        pack plus the found-set words on its key layout (fixed = ebm when
        no found set)."""
        keys, ebm_w, slices_w = self._pack_dense64()
        fixed_w = ebm_w if found_set is None else bsi.found_words(keys, ebm_w, found_set._kv())
        return keys, ebm_w, slices_w, fixed_w

    @staticmethod
    def _neq_outside_ebm(found_set: Roaring64Bitmap, keys) -> int:
        """Clone-free count of found-set columns in chunks outside the
        packed ebm keys (NEQ qualifies them wholesale)."""
        kset = set(keys)
        return sum(c.cardinality for k, c in found_set._kv() if k not in kset)

    def _use_device(self, mode: Optional[str]) -> bool:
        """The device path or the CPU walk, by index size only."""
        mode = mode or config.mode
        if mode == "cpu":
            return False
        if mode == "device":
            return True
        if mode != "auto":
            raise ValueError(f"mode must be 'auto', 'cpu' or 'device', got {mode!r}")
        return self.bit_count() * self._key_count() >= config.min_device_cells

    def _key_count(self) -> int:
        # O(1): the Containers store tracks its live count
        return len(self.ebm._containers)

    def _pack_dense64(self):
        """``(keys, ebm_w, slices_w)``: the ebm's high-48 chunk keys (6-byte
        keys, ascending), int32 ``[K, 2048]`` ebm words and the ``[S, K,
        2048]`` slice tensor on ``bsi.config.device``. Built on the host,
        sent in one copy, and resident in the shared ``store.PACK_CACHE``:
        the 64-bit bitmaps have no fingerprint, so the key is ``(id(self),
        _version)`` and the device, with ``self`` held as the entry's ref
        — the id cannot be recycled by another index while the entry is
        resident, and every mutation re-keys it."""
        device = resolve_device(bsi.config.device)

        def build():
            return bsi.pack_slices(self.ebm._kv(), [s._kv() for s in self.slices], device)

        key = ("bsi64", id(self), self._version, str(device))
        return store.PACK_CACHE.get_or_build(key, build, refs=(self,))

    def _o_neil_device_walk(
        self, op, predicate, found_set, end: int = 0, count_only: bool = False
    ):
        """One ``rb_oneil_compare`` launch over high-48 chunk keys; returns
        (keys, out, cards) with nothing fetched to the host: int32 ``[K,
        2048]`` result words (None when ``count_only``) and ``[K]``
        popcounts."""
        keys, ebm_w, slices_w, fixed_w = self._pack_with_fixed(found_set)
        s_count = self.bit_count()
        walks = [bsi._bits_high_first(predicate, s_count)]
        if op == Operation.RANGE:
            walks.append(bsi._bits_high_first(end, s_count))
        bits = torch.tensor([walks], dtype=torch.int32).to(slices_w.device)
        out, cards = kernels.oneil_compare(
            slices_w, bits, ebm_w, fixed_w, op.value, count_only=count_only
        )
        return keys, out, cards[0]

    def _o_neil_device(
        self, op, predicate, found_set, end: int = 0
    ) -> Roaring64Bitmap:
        """The whole O'Neil chain — walk, op epilogue and popcount — as one
        kernel launch over high-48 chunk keys; the result words come back
        once and are re-compressed into containers (array up to 4096
        values, else bitmap, as the JAX package's
        ``best_container_of_words``), the trie bulk-built from the
        ascending keys."""
        keys, out, cards = self._o_neil_device_walk(op, predicate, found_set, end)
        key_ints = np.array([key_to_int(k) for k in keys], dtype=np.int64)
        pairs = [
            (int(k).to_bytes(6, "big"), c)
            for k, c in store.iter_group_containers(
                key_ints, dev.to_host_u32(out), cards.cpu().numpy().astype(np.int64)
            )
        ]
        if op == Operation.NEQ and found_set is not None:
            # foundSet columns in chunks outside the ebm cannot be EQ, so
            # they all qualify (same Java semantics as the 32-bit engine)
            kset = set(keys)
            outside = [(k, c.clone()) for k, c in found_set._kv() if k not in kset]
            if outside:
                pairs = sorted(pairs + outside, key=lambda kc: kc[0])
        result = Roaring64Bitmap()
        held = result._containers
        result._art.bulk_load([(k, held.add(c)) for k, c in pairs])
        return result

    def _compare_using_min_max(self, op, start_or_value, end, found_set):
        verdict = min_max_verdict(
            op, start_or_value, end, self.min_value, self.max_value
        )
        if verdict is None:
            return None
        if verdict == "empty":
            return Roaring64Bitmap()
        if verdict == "fixed":
            return self.ebm.clone() if found_set is None else found_set.clone()
        return (
            self.ebm.clone()
            if found_set is None
            else Roaring64Bitmap.and_(self.ebm, found_set)
        )

    def _o_neil(self, op, predicate, found_set) -> Roaring64Bitmap:
        fixed = self.ebm if found_set is None else found_set
        gt, lt, eq = Roaring64Bitmap(), Roaring64Bitmap(), self.ebm
        for i in range(self.bit_count() - 1, -1, -1):
            if (predicate >> i) & 1:
                lt = Roaring64Bitmap.or_(lt, Roaring64Bitmap.andnot(eq, self.slices[i]))
                eq = Roaring64Bitmap.and_(eq, self.slices[i])
            else:
                gt = Roaring64Bitmap.or_(gt, Roaring64Bitmap.and_(eq, self.slices[i]))
                eq = Roaring64Bitmap.andnot(eq, self.slices[i])
        eq = Roaring64Bitmap.and_(fixed, eq)
        if op == Operation.EQ:
            return eq
        if op == Operation.NEQ:
            return Roaring64Bitmap.andnot(fixed, eq)
        if op == Operation.GT:
            return Roaring64Bitmap.and_(gt, fixed)
        if op == Operation.LT:
            return Roaring64Bitmap.and_(lt, fixed)
        if op == Operation.LE:
            return Roaring64Bitmap.and_(Roaring64Bitmap.or_(lt, eq), fixed)
        if op == Operation.GE:
            return Roaring64Bitmap.and_(Roaring64Bitmap.or_(gt, eq), fixed)
        raise ValueError(f"unsupported operation {op}")

    def sum(self, found_set: Optional[Roaring64Bitmap] = None) -> Tuple[int, int]:
        """(sum, count) (Roaring64BitmapSliceIndex.java:559)."""
        if found_set is None or found_set.is_empty():
            return 0, 0
        count = found_set.get_cardinality()
        total = sum(
            (1 << i) * Roaring64Bitmap.and_cardinality(s, found_set)
            for i, s in enumerate(self.slices)
        )
        return total, count

    def top_k(self, found_set: Optional[Roaring64Bitmap], k: int) -> Roaring64Bitmap:
        """Columns holding the k largest values — slice descent from the
        MSB (Roaring64BitmapSliceIndex.java:572)."""
        if found_set is None:
            found_set = self.ebm
        if found_set.is_empty() or k <= 0:
            return Roaring64Bitmap()
        if k >= found_set.get_cardinality():
            return found_set.clone()
        result = Roaring64Bitmap()
        candidates = found_set.clone()
        for i in range(self.bit_count() - 1, -1, -1):
            if candidates.is_empty() or k <= 0:
                break
            with_bit = Roaring64Bitmap.and_(candidates, self.slices[i])
            card = with_bit.get_cardinality()
            if card > k:
                candidates = with_bit
            else:
                result.ior(with_bit)
                candidates.iandnot(self.slices[i])
                k -= card
        if k > 0 and not candidates.is_empty():
            # fill remaining seats from the leftover (equal-valued) pool
            fill = Roaring64Bitmap()
            for idx, col in enumerate(candidates):
                if idx >= k:
                    break
                fill.add(col)
            result.ior(fill)
        return result

    def transpose(self, found_set: Optional[Roaring64Bitmap] = None) -> Roaring64Bitmap:
        """Bitmap of distinct values over the found columns
        (Roaring64BitmapSliceIndex.java:596)."""
        cols = (
            self.ebm if found_set is None else Roaring64Bitmap.and_(self.ebm, found_set)
        ).to_array()
        if cols.size == 0:
            return Roaring64Bitmap()
        return Roaring64Bitmap(
            np.unique(bsi.values_for_columns(cols, self.slices, dtype=np.uint64))
        )

    def transpose_with_count(
        self, found_set: Optional[Roaring64Bitmap] = None
    ) -> "Roaring64BitmapSliceIndex":
        """BSI mapping value -> multiplicity (Roaring64BitmapSliceIndex.java:603)."""
        cols = (
            self.ebm if found_set is None else Roaring64Bitmap.and_(self.ebm, found_set)
        ).to_array()
        out = Roaring64BitmapSliceIndex()
        if cols.size == 0:
            return out
        uniq, counts = bsi.transpose_value_counts(cols, self.slices, dtype=np.uint64)
        out.set_values((uniq, counts.astype(np.uint64)))
        return out

    # ------------------------------------------------------------------
    # serialization (ByteBuffer layout :234-271, little-endian):
    # int64 minValue, int64 maxValue, byte runOptimized, ebm (portable
    # 64-bit spec), int32 sliceCount, slices
    # ------------------------------------------------------------------
    def serialize(self) -> bytes:
        parts = [
            struct.pack(
                "<QQb", self.min_value, self.max_value, 1 if self.run_optimized else 0
            ),
            self.ebm.serialize(),
            struct.pack("<i", self.bit_count()),
        ]
        parts.extend(s.serialize() for s in self.slices)
        return b"".join(parts)

    def serialized_size_in_bytes(self) -> int:
        return (
            8 + 8 + 1 + 4
            + self.ebm.serialized_size_in_bytes()
            + sum(s.serialized_size_in_bytes() for s in self.slices)
        )

    def __reduce__(self):
        return Roaring64BitmapSliceIndex.deserialize, (self.serialize(),)

    @staticmethod
    def deserialize(data) -> "Roaring64BitmapSliceIndex":
        buf = memoryview(
            data if isinstance(data, (bytes, bytearray, memoryview)) else bytes(data)
        )
        if len(buf) < 17:
            raise InvalidRoaringFormat("truncated 64-bit BSI header")
        min_v, max_v, ro = struct.unpack_from("<QQb", buf, 0)
        pos = 17
        out = Roaring64BitmapSliceIndex()
        out.min_value, out.max_value = min_v, max_v
        out.run_optimized = bool(ro)
        out.ebm, n = Roaring64Bitmap.read_from(buf[pos:])
        pos += n
        if pos + 4 > len(buf):
            raise InvalidRoaringFormat("truncated BSI slice count")
        (depth,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        if depth < 0 or depth > 64:
            raise InvalidRoaringFormat(f"implausible BSI depth {depth}")
        out.slices = []
        for _ in range(depth):
            s, n = Roaring64Bitmap.read_from(buf[pos:])
            pos += n
            out.slices.append(s)
        return out

    def serialize_into(self, fileobj) -> int:
        """Stream overload (the reference's WritableUtils DataOutput path);
        returns bytes written."""
        data = self.serialize()
        fileobj.write(data)
        return len(data)

    @staticmethod
    def deserialize_from(fileobj) -> "Roaring64BitmapSliceIndex":
        """Stream twin: consumes exactly one 64-bit BSI (header, ebm,
        depth, slices — each member through Roaring64Bitmap's
        exact-consumption stream reader)."""
        from ..serialization import read_exact

        min_v, max_v, ro = struct.unpack("<QQb", read_exact(fileobj, 17))
        out = Roaring64BitmapSliceIndex()
        out.min_value, out.max_value = min_v, max_v
        out.run_optimized = bool(ro)
        out.ebm = Roaring64Bitmap.deserialize_from(fileobj)
        (depth,) = struct.unpack("<i", read_exact(fileobj, 4))
        if depth < 0 or depth > 64:
            raise InvalidRoaringFormat(f"implausible BSI depth {depth}")
        out.slices = [Roaring64Bitmap.deserialize_from(fileobj) for _ in range(depth)]
        return out

    def __eq__(self, other):
        if not isinstance(other, Roaring64BitmapSliceIndex):
            return NotImplemented
        return (
            self.ebm == other.ebm
            and len(self.slices) == len(other.slices)
            and all(a == b for a, b in zip(self.slices, other.slices))
        )

    def __repr__(self):
        return (
            f"Roaring64BitmapSliceIndex(cols={self.get_long_cardinality()}, "
            f"slices={self.bit_count()}, min={self.min_value}, max={self.max_value})"
        )
