"""Succinct range index: the reference's ``RangeBitmap`` (RangeBitmap.java).

Counterpart of the JAX package's ``models/range_bitmap.py``; the wire
formats, the appender, the context chunk walk and every query are the same.

Logical model: an append-only, then sealed, base-2 bit-sliced index over
row ids (RangeBitmap.java:38-66 ``appender(maxValue)`` / ``map(buffer)``),
answering lt/lte/gt/gte/eq/neq/between with ``Cardinality`` and ``context``
(pre-filter) overloads (RangeBitmap.java:111-414). Row ids are dense
0..maxRid; every appended row has a value.

Three design obligations carried over from the reference:

* **Bounded-memory append-then-seal** (RangeBitmap.Appender,
  RangeBitmap.java:1378-1520): the appender buffers at most one 2^16-row
  chunk of raw values; on each chunk boundary the chunk is flushed into
  per-slice *compressed containers* (the ``toEfficientContainer`` analogue),
  so peak transient memory is O(chunk) regardless of row count.
* **Lazy map** (RangeBitmap.java:66-96): ``map(buffer)`` parses only the
  header and the slice directory; each slice is materialized on first
  access, and ``serialize()`` of a mapped index re-emits the stored payload
  bytes without decoding. A reference-format slice is assembled from its
  chunk directory. A native-form slice is an ``ImmutableRoaringBitmap``
  view of its payload (``models/immutable.py``): no payload is copied.
* **Context-masked chunk skipping** (computeRange, RangeBitmap.java:551-620):
  queries with a ``context`` pre-filter walk only the 2^16-row chunks whose
  key appears in the context, running the O'Neil slice recurrence at
  container level per chunk and seeding EQ with the context container (the
  recurrence classifies each rid independently, so seeding == masking).
  ``chunks_evaluated`` counts touched chunks so skipping is observable.

Device path: context-free queries on a built index run through the BSI
compare engine (models/bsi.py) — the reference's streaming per-chunk
evaluation becomes the K axis of the ``[S, K, 2048]`` device tensor, and
one ``rb_oneil_compare`` launch answers a query (or a batch of counts).
Whether that engine takes the device path is its own ``mode="auto"`` rule
(index size only) on ``bsi.config.device``. The container walk serves
context queries, where decoding everything for one chunk's answer would
waste more than it saves.

Serialized layout — **byte-compatible with the reference**.
The default wire format is the reference's sealed form
(RangeBitmap.java:1483-1520 Appender.serialize / :66-96 map):

* header (10 bytes LE): u16 cookie 0xF00D, u8 base(=2), u8 sliceCount,
  u16 maxKey (chunk count), u32 maxRid;
* per-chunk slice masks: maxKey * ceil(sliceCount/8) bytes, each mask the
  little-endian truncation of the u64 whose bit ``i`` says chunk has a
  container for slice ``i``;
* container stream, ascending (chunk, slice): u8 type (0=bitmap, 1=run,
  2=array); bitmap: u16 cardinality (wraps at 2^16) + 8192 word bytes;
  run: u16 nruns + nruns x (u16 start, u16 length); array: u16 count +
  count x u16 values.

Reference slices store the **complement**: slice ``i`` holds rid iff bit
``i`` of the value is 0 (RangeBitmap.java:1510 ``~value & rangeMask``) —
the encoding that makes lte evaluation one andNot chain. This module keeps
value-bit slices internally (they are what the shared BSI device engine
consumes) and inverts per chunk container at the wire boundary
(``universe andnot c`` both ways — an involution, so round-trips are exact).

``map()`` also still reads this framework's native form (u16 cookie,
u8 base, u8 sliceCount, u64 maxValue, u32 maxRid, then per-slice u32 length
+ RoaringFormatSpec bytes), distinguished by strict stream validation;
``serialize(form="native")`` still writes it. Values are unsigned 64-bit;
the reference format caps sliceCount at 64 likewise.
"""

from __future__ import annotations

import struct
from typing import Iterable, List, Optional, Union

import numpy as np

from ..serialization import InvalidRoaringFormat
from .bsi import Operation, RoaringBitmapSliceIndex
from .container import Container, container_from_values, container_range_of_ones
from .immutable import ImmutableRoaringBitmap
from .roaring import RoaringBitmap
from .roaring_array import RoaringArray

COOKIE = 0xF00D  # RangeBitmap.java:25
CHUNK = 1 << 16
_MAX64 = 1 << 64
# reference container stream type codes (RangeBitmap.java:26-28)
J_BITMAP, J_RUN, J_ARRAY = 0, 1, 2


def _encode_java_container(c: Container) -> bytes:
    """One container in the reference stream form (RangeBitmap.java:1553-1580):
    u8 type, then bitmap: u16 cardinality (wraps at 2^16) + 8192 word bytes;
    run: u16 nruns + (start, length) u16 pairs; array: u16 count + u16 values."""
    from .container import ArrayContainer, BitmapContainer, RunContainer

    if isinstance(c, BitmapContainer):
        return (
            struct.pack("<BH", J_BITMAP, c.cardinality & 0xFFFF)
            + c.words.astype("<u8", copy=False).tobytes()
        )
    if isinstance(c, RunContainer):
        pairs = np.empty(2 * c.starts.size, dtype="<u2")
        pairs[0::2] = c.starts
        pairs[1::2] = c.lengths
        return struct.pack("<BH", J_RUN, c.starts.size) + pairs.tobytes()
    assert isinstance(c, ArrayContainer), type(c)
    return (
        struct.pack("<BH", J_ARRAY, c.content.size)
        + c.content.astype("<u2", copy=False).tobytes()
    )


def _java_wire_container(comp: Container, slice_idx: int) -> bytes:
    """Byte-exact form choice of the reference appender's flush.

    The appender grows slices 0-4 as BitmapContainers and slices >= 5 as
    RunContainers (containerForSlice, RangeBitmap.java:1608-1613), then
    serializes ``container.runOptimize()`` (:1552) — and the two classes
    optimize differently:

    * BitmapContainer.runOptimize (BitmapContainer.java:1227-1245) only
      ever converts bitmap -> run (when 2+4*nruns < 8192); it never
      produces an array, however small the cardinality;
    * RunContainer.runOptimize -> toEfficientContainer (RunContainer.java)
      keeps the run iff 2+4*nruns <= min(8192, 2+2*card) (ties keep run),
      else array iff card <= 4096 (toBitmapOrArrayContainer) else bitmap.

    Replicating the rule (not just "smallest form") is what makes the
    emitted stream byte-identical to a Java-sealed RangeBitmap."""
    from .container import ArrayContainer, BitmapContainer, RunContainer

    run = comp if isinstance(comp, RunContainer) else RunContainer.from_values(comp.to_array())
    card = comp.cardinality
    run_size = 2 + 4 * run.num_runs()
    if slice_idx >= 5:
        if run_size <= min(8192, 2 + 2 * card):
            choice: Container = run
        elif card <= 4096:
            choice = (
                comp
                if isinstance(comp, ArrayContainer)
                else ArrayContainer(comp.to_array())
            )
        else:
            choice = (
                comp if isinstance(comp, BitmapContainer) else BitmapContainer(comp.to_words())
            )
    else:
        if run_size < 8192:
            choice = run
        else:
            choice = (
                comp if isinstance(comp, BitmapContainer) else BitmapContainer(comp.to_words())
            )
    return _encode_java_container(choice)


def _decode_java_container(buf: memoryview, t: int, off: int) -> Container:
    """Decode one directory entry (type + payload offset past the type byte)."""
    from .container import ArrayContainer, BitmapContainer, RunContainer

    if t == J_BITMAP:
        words = np.frombuffer(buf, dtype="<u8", count=1024, offset=off + 2)
        return BitmapContainer(words.astype(np.uint64, copy=False))
    if t == J_RUN:
        (n_runs,) = struct.unpack_from("<H", buf, off)
        pairs = np.frombuffer(buf, dtype="<u2", count=2 * n_runs, offset=off + 2)
        starts, lengths = pairs[0::2], pairs[1::2]
        s64 = starts.astype(np.int64)
        ends = s64 + lengths.astype(np.int64)
        if n_runs and (np.any(s64[1:] <= ends[:-1]) or np.any(ends > 0xFFFF)):
            raise InvalidRoaringFormat("invalid run container in RangeBitmap stream")
        return RunContainer(starts, lengths)
    (card,) = struct.unpack_from("<H", buf, off)
    values = np.frombuffer(buf, dtype="<u2", count=card, offset=off + 2)
    if card and np.any(np.diff(values.astype(np.int64)) <= 0):
        raise InvalidRoaringFormat("unsorted array container in RangeBitmap stream")
    return ArrayContainer(values)


class _JavaMap:
    """Lazily mapped reference-format buffer: the parsed header plus a
    (slice, chunk) -> (type, offset) directory built by one validating walk
    over the container stream (no payload decode — the reference map()'s
    "minimal allocation" contract, RangeBitmap.java:60-96)."""

    __slots__ = ("buf", "slice_count", "n_chunks", "max_rid", "directory", "end")

    def __init__(self, buffer) -> None:
        buf = memoryview(buffer).cast("B")
        if len(buf) < 10:
            raise InvalidRoaringFormat("truncated RangeBitmap header")
        cookie, base, slice_count, n_chunks, max_rid = struct.unpack_from("<HBBHI", buf, 0)
        if cookie != COOKIE:
            raise InvalidRoaringFormat(f"invalid RangeBitmap cookie {cookie:#x}")
        if base != 2:
            raise InvalidRoaringFormat(f"unsupported base {base}")
        if slice_count < 1 or slice_count > 64:
            raise InvalidRoaringFormat(f"implausible slice count {slice_count}")
        # a sealed appender always has key == ceil(rid / 2^16) chunks
        # (RangeBitmap.java:1530 append() per 2^16 rids) — the check that
        # cheaply rejects this framework's native form, whose bytes 4..9
        # hold maxValue instead
        if n_chunks != (max_rid + CHUNK - 1) // CHUNK:
            raise InvalidRoaringFormat("chunk count inconsistent with maxRid")
        bpm = (slice_count + 7) >> 3
        masks_off = 10
        pos = masks_off + n_chunks * bpm
        if pos > len(buf):
            raise InvalidRoaringFormat("truncated slice masks")
        directory = {}
        for key in range(n_chunks):
            mask = int.from_bytes(buf[masks_off + key * bpm : masks_off + (key + 1) * bpm], "little")
            if mask >> slice_count:
                # a flagged slice past sliceCount would smuggle an orphan
                # container through the walk (queries never read it, but
                # accepting it would bless malformed input)
                raise InvalidRoaringFormat(
                    f"chunk {key} mask flags slices past sliceCount {slice_count}"
                )
            i = 0
            while mask:
                if mask & 1:
                    if pos + 3 > len(buf):
                        raise InvalidRoaringFormat("truncated container stream")
                    t = buf[pos]
                    if t == J_BITMAP:
                        size = 3 + 8192
                    elif t == J_RUN:
                        (n_runs,) = struct.unpack_from("<H", buf, pos + 1)
                        size = 3 + 4 * n_runs
                    elif t == J_ARRAY:
                        (card,) = struct.unpack_from("<H", buf, pos + 1)
                        size = 3 + 2 * card
                    else:
                        raise InvalidRoaringFormat(f"invalid container type {t}")
                    if pos + size > len(buf):
                        raise InvalidRoaringFormat("container payload out of bounds")
                    directory[(i, key)] = (t, pos + 1)
                    pos += size
                mask >>= 1
                i += 1
        # exact-extent contract (Appender.serialize writes exactly
        # serializedSizeInBytes bytes): trailing bytes mean this is not a
        # reference-format buffer — notably a native-form buffer with
        # maxValue == 0, whose first 10 bytes alone would parse as an empty
        # reference map and silently drop every row
        if pos != len(buf):
            raise InvalidRoaringFormat(
                f"trailing bytes after container stream ({len(buf) - pos})"
            )
        self.buf = buf
        self.slice_count = slice_count
        self.n_chunks = n_chunks
        self.max_rid = max_rid
        self.directory = directory
        self.end = pos


class RangeBitmap:
    """Sealed range index; construct via ``RangeBitmap.appender`` or
    ``RangeBitmap.map``."""

    def __init__(
        self,
        slices: List[Optional[RoaringBitmap]],
        max_value: int,
        max_rid: int,
        payloads: Optional[List[bytes]] = None,
        java_map: Optional[_JavaMap] = None,
    ):
        self._slices = slices  # per-slice bitmap, or None when lazily mapped
        self._payloads = payloads  # native-mapped: RoaringFormatSpec bytes per slice
        self._jmap = java_map  # reference-format map: lazy container directory
        self._jcache: dict = {}  # (slice, key) -> value-bit Container
        self._max_value = int(max_value)
        self._max_rid = int(max_rid)  # number of rows
        self._bsi: Optional[RoaringBitmapSliceIndex] = None
        self.chunks_evaluated = 0  # observability: chunk-walk work counter

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @staticmethod
    def appender(max_value: int) -> "RangeBitmapAppender":
        """Appender sized for values in [0, max_value] (RangeBitmap.java:38)."""
        return RangeBitmapAppender(max_value)

    @staticmethod
    def map(buffer: Union[bytes, bytearray, memoryview]) -> "RangeBitmap":
        """Open a sealed buffer (RangeBitmap.map, RangeBitmap.java:66).

        Accepts both the reference wire format (the default ``serialize``
        output — byte-compatible with a Java-sealed RangeBitmap) and this
        framework's native form. Either way the open is lazy:
        O(header + container directory), payload bytes stay views and
        reference-format containers decode zero-copy on first access. The
        two headers are
        disambiguated by strict validation — the reference header pins
        ``maxKey == ceil(maxRid / 2^16)`` plus exact stream bounds, which
        native-form bytes (maxValue u64 in those positions) cannot satisfy."""
        try:
            jm = _JavaMap(buffer)
            return RangeBitmap(
                [None] * jm.slice_count,
                (1 << jm.slice_count) - 1,  # rangeMask implied by sliceCount
                jm.max_rid,
                java_map=jm,
            )
        except InvalidRoaringFormat as java_err:
            try:
                return RangeBitmap._map_native(buffer)
            except InvalidRoaringFormat as native_err:
                raise InvalidRoaringFormat(
                    f"not a RangeBitmap in either format "
                    f"(reference: {java_err}; native: {native_err})"
                ) from None

    @staticmethod
    def _map_native(buffer: Union[bytes, bytearray, memoryview]) -> "RangeBitmap":
        """The native form: u64 maxValue header + whole-slice
        RoaringFormatSpec payloads."""
        buf = memoryview(buffer)
        if len(buf) < 16:
            raise InvalidRoaringFormat("truncated RangeBitmap header")
        cookie, base, slice_count = struct.unpack_from("<HBB", buf, 0)
        if cookie != COOKIE:
            raise InvalidRoaringFormat(f"invalid RangeBitmap cookie {cookie:#x}")
        if base != 2:
            raise InvalidRoaringFormat(f"unsupported base {base}")
        (max_value,) = struct.unpack_from("<Q", buf, 4)
        (max_rid,) = struct.unpack_from("<I", buf, 12)
        pos = 16
        payloads: List[bytes] = []
        for _ in range(slice_count):
            if pos + 4 > len(buf):
                raise InvalidRoaringFormat("truncated slice length")
            (ln,) = struct.unpack_from("<I", buf, pos)
            pos += 4
            if pos + ln > len(buf):
                raise InvalidRoaringFormat("truncated slice payload")
            payloads.append(buf[pos : pos + ln])
            pos += ln
        return RangeBitmap(
            [None] * slice_count, max_value, max_rid, payloads=payloads
        )

    # ------------------------------------------------------------------
    # slice access
    # ------------------------------------------------------------------
    @property
    def _slice_count(self) -> int:
        return len(self._slices)

    def _chunk_rows(self, key: int) -> int:
        return min(CHUNK, self._max_rid - key * CHUNK)

    def _slice(self, i: int) -> RoaringBitmap:
        """Slice bitmap, decoding a mapped payload zero-copy on first use."""
        s = self._slices[i]
        if s is None:
            if self._jmap is not None:
                # assemble the value-bit slice from the chunk directory
                # (decodes slice i's containers; the batch/BSI path needs
                # the whole slice, same as the reference's full evaluation)
                arr = RoaringArray()
                for key in range((self._max_rid + CHUNK - 1) // CHUNK):
                    c = self._slice_container(i, key)
                    if c is not None and c.cardinality:
                        arr.append(key, c)
                s = RoaringBitmap()
                s.high_low_container = arr
            else:
                # native form: the slice is a zero-copy view of its payload
                s = ImmutableRoaringBitmap(self._payloads[i])
            self._slices[i] = s
        return s

    def _slice_container(self, i: int, key: int) -> Optional[Container]:
        """Value-bit container of slice ``i`` in chunk ``key`` (None = no
        rows in the chunk have bit i set). Reference-format maps store the
        complement (RangeBitmap.java:1510), inverted here on first decode:
        an absent directory entry means *every* row has bit i set."""
        if self._jmap is None:
            return self._slice(i).high_low_container.get_container(key)
        ck = (i, key)
        if ck in self._jcache:
            return self._jcache[ck]
        chunk_rows = self._chunk_rows(key)
        if chunk_rows <= 0:
            return None
        entry = self._jmap.directory.get(ck)
        universe = container_range_of_ones(0, chunk_rows)
        if entry is None:  # complement empty: all rows have bit i set
            c = universe
        else:
            comp = _decode_java_container(self._jmap.buf, *entry)
            c = universe.andnot(comp)
            if c.cardinality == 0:
                c = None
        self._jcache[ck] = c
        return c

    def _bsi_index(self) -> RoaringBitmapSliceIndex:
        """The whole-index view used by context-free queries (the BSI
        device/CPU engine). For a mapped index the slices are materialized
        lazily here and cached, so a pickled/mapped index keeps the batch
        path instead of degrading to the chunk walk."""
        if self._bsi is None:
            index = RoaringBitmapSliceIndex()
            index.min_value, index.max_value = 0, self._max_value
            index.ebm = RoaringBitmap.bitmap_of_range(0, self._max_rid)
            index.slices = [self._slice(i) for i in range(self._slice_count)]
            self._bsi = index
        return self._bsi

    # ------------------------------------------------------------------
    # serialization
    # ------------------------------------------------------------------
    def serialize(self, form: Optional[str] = None) -> bytes:
        """Sealed bytes. ``form=None`` re-emits the backing store's format
        without decoding (reference-format and native maps pass their bytes
        through; heap indexes default to the reference format).
        ``form="java"`` / ``form="native"`` force the respective layout."""
        if form not in (None, "java", "native"):
            raise ValueError(f"form must be 'java' or 'native', got {form!r}")
        if form is None:
            if self._jmap is not None:
                return bytes(self._jmap.buf[: self._jmap.end])
            if self._payloads is not None:
                return self._serialize_native()
            form = "java"
        if form == "java":
            if self._jmap is not None:
                return bytes(self._jmap.buf[: self._jmap.end])
            return self._serialize_java()
        return self._serialize_native()

    def _serialize_java(self) -> bytes:
        """Encode the reference wire format (Appender.serialize,
        RangeBitmap.java:1483-1520): complement containers per (chunk,
        slice), run-optimized like the reference's flush (:1552)."""
        n_chunks = (self._max_rid + CHUNK - 1) // CHUNK
        if n_chunks > 0xFFFF:
            # the reference header's maxKey is a u16 (RangeBitmap.java:1494);
            # fail actionably up front instead of a struct.error after
            # walking 65536 chunks
            raise ValueError(
                f"{self._max_rid} rows = {n_chunks} chunks exceeds the "
                "reference wire format's u16 chunk count; use "
                "serialize(form='native')"
            )
        bpm = (self._slice_count + 7) >> 3
        masks = bytearray()
        stream = bytearray()
        for key in range(n_chunks):
            universe = container_range_of_ones(0, self._chunk_rows(key))
            mask = 0
            for i in range(self._slice_count):
                si = self._slice_container(i, key)
                comp = universe if si is None else universe.andnot(si)
                if comp.cardinality == 0:
                    continue
                mask |= 1 << i
                stream += _java_wire_container(comp, i)
            masks += mask.to_bytes(bpm, "little")
        return (
            struct.pack("<HBBHI", COOKIE, 2, self._slice_count, n_chunks, self._max_rid)
            + bytes(masks)
            + bytes(stream)
        )

    def _serialize_native(self) -> bytes:
        parts = [
            struct.pack("<HBB", COOKIE, 2, self._slice_count),
            struct.pack("<Q", self._max_value),
            struct.pack("<I", self._max_rid),
        ]
        for i in range(self._slice_count):
            if self._payloads is not None:
                payload = bytes(self._payloads[i])  # mapped: no decode
            else:
                payload = self._slice(i).serialize()
            parts.append(struct.pack("<I", len(payload)))
            parts.append(payload)
        return b"".join(parts)

    def serialized_size_in_bytes(self, form: Optional[str] = None) -> int:
        from ..serialization import serialized_size_in_bytes

        if form is None and self._jmap is not None:
            return self._jmap.end
        if form is None and self._payloads is None:
            form = "java"
        if form == "java":
            return len(self.serialize(form="java"))
        total = 16
        for i in range(self._slice_count):
            if self._payloads is not None:
                total += 4 + len(self._payloads[i])
            else:
                # _slice (not _slices[i]): materializes reference-mapped
                # slices, which are still None here
                total += 4 + serialized_size_in_bytes(self._slice(i))
        return total

    def __reduce__(self):
        return RangeBitmap.map, (self.serialize(),)

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    def _compare(self, op: Operation, value: int, end: int, context) -> RoaringBitmap:
        value = int(value)
        if value < 0:
            raise ValueError("RangeBitmap values are unsigned")
        if context is not None:
            return self._chunk_walk(op, value, end, context)
        out = self._bsi_index().compare(op, value, end, None)
        if op is Operation.NEQ:
            # rows outside the appended universe cannot hold a value
            out = RoaringBitmap.and_(out, self._bsi_index().ebm)
        return out

    def _chunk_walk(
        self, op: Operation, value: int, end: int, context: Optional[RoaringBitmap]
    ) -> RoaringBitmap:
        """Per-chunk container-level O'Neil evaluation
        (computeRange, RangeBitmap.java:551-620).

        With a context, only chunk keys present in the context are touched
        (the reference's context-masked skipping); the recurrence is seeded
        with the context container, which masks every output for free."""
        out = RoaringBitmap()
        n_chunks = (self._max_rid + CHUNK - 1) // CHUNK
        if context is not None:
            hlc = context.high_low_container
            keys = [
                (hlc.get_key_at_index(i), hlc.get_container_at_index(i))
                for i in range(hlc.size)
            ]
        else:
            keys = [(k, None) for k in range(n_chunks)]
        for key, ctx_container in keys:
            if key >= n_chunks:
                break
            self.chunks_evaluated += 1
            res = self._eval_chunk(op, value, end, key, ctx_container)
            if res is not None and res.cardinality > 0:
                out.high_low_container.append(key, res)
        return out

    def _eval_chunk(
        self, op: Operation, value: int, end: int, key: int, ctx: Optional[Container]
    ) -> Optional[Container]:
        chunk_rows = min(CHUNK, self._max_rid - key * CHUNK)
        if chunk_rows <= 0:
            return None
        universe = container_range_of_ones(0, chunk_rows)
        seed = universe if ctx is None else ctx.and_(universe)
        if seed.cardinality == 0:
            return None
        if op is Operation.LT:
            lt, eq, _ = self._oneil_chunk(value, key, seed, want_gt=False)
            return lt
        if op is Operation.LE:
            lt, eq, _ = self._oneil_chunk(value, key, seed, want_gt=False)
            return lt.or_(eq)
        if op is Operation.GT:
            _, eq, gt = self._oneil_chunk(value, key, seed, want_lt=False)
            return gt
        if op is Operation.GE:
            _, eq, gt = self._oneil_chunk(value, key, seed, want_lt=False)
            return gt.or_(eq)
        if op is Operation.EQ:
            _, eq, _ = self._oneil_chunk(value, key, seed, want_lt=False, want_gt=False)
            return eq
        if op is Operation.NEQ:
            _, eq, _ = self._oneil_chunk(value, key, seed, want_lt=False, want_gt=False)
            return seed.andnot(eq)
        if op is Operation.RANGE:
            _, eq_lo, gt_lo = self._oneil_chunk(value, key, seed, want_lt=False)
            ge = gt_lo.or_(eq_lo)
            if ge.cardinality == 0:
                return None
            lt_hi, eq_hi, _ = self._oneil_chunk(end, key, ge, want_gt=False)
            return lt_hi.or_(eq_hi)
        raise ValueError(f"unsupported operation {op}")

    def _oneil_chunk(
        self,
        value: int,
        key: int,
        seed: Container,
        want_lt: bool = True,
        want_gt: bool = True,
    ):
        """O'Neil recurrence over the slice axis for one chunk
        (RoaringBitmapSliceIndex.java:432-469, restricted to ``seed``).

        A threshold above the indexed bit depth means every row's value is
        smaller: LT = seed, EQ/GT empty."""
        empty = container_from_values(np.empty(0, dtype=np.uint16))
        if value.bit_length() > self._slice_count:
            return (seed if want_lt else empty), empty, empty
        lt, gt = empty, empty
        eq = seed
        for i in range(self._slice_count - 1, -1, -1):
            if eq.cardinality == 0:
                break
            si = self._slice_container(i, key)
            bit = (value >> i) & 1
            if bit:
                if si is None:  # no rows have bit i set in this chunk
                    if want_lt:
                        lt = lt.or_(eq)
                    eq = empty
                else:
                    if want_lt:
                        lt = lt.or_(eq.andnot(si))
                    eq = eq.and_(si)
            else:
                if si is not None:
                    if want_gt:
                        gt = gt.or_(eq.and_(si))
                    eq = eq.andnot(si)
        return lt, eq, gt

    # ------------------------------------------------------------------
    # queries (RangeBitmap.java:111-414)
    # ------------------------------------------------------------------
    def lt(self, value: int, context: Optional[RoaringBitmap] = None) -> RoaringBitmap:
        return self._compare(Operation.LT, value, 0, context)

    def lte(self, value: int, context: Optional[RoaringBitmap] = None) -> RoaringBitmap:
        return self._compare(Operation.LE, value, 0, context)

    def gt(self, value: int, context: Optional[RoaringBitmap] = None) -> RoaringBitmap:
        return self._compare(Operation.GT, value, 0, context)

    def gte(self, value: int, context: Optional[RoaringBitmap] = None) -> RoaringBitmap:
        return self._compare(Operation.GE, value, 0, context)

    def eq(self, value: int, context: Optional[RoaringBitmap] = None) -> RoaringBitmap:
        return self._compare(Operation.EQ, value, 0, context)

    def neq(self, value: int, context: Optional[RoaringBitmap] = None) -> RoaringBitmap:
        return self._compare(Operation.NEQ, value, 0, context)

    def between(
        self, lo: int, hi: int, context: Optional[RoaringBitmap] = None
    ) -> RoaringBitmap:
        return self._compare(Operation.RANGE, lo, hi, context)

    # Cardinality overloads (RangeBitmap.java lteCardinality etc.) — the
    # count never materializes a result bitmap on the context-free path:
    # the BSI's compare_cardinality fetches only per-chunk popcounts
    def _compare_cardinality(self, op: Operation, value: int, end: int, context) -> int:
        value = int(value)
        if value < 0:  # validated before the context branch, like _compare
            raise ValueError("RangeBitmap values are unsigned")
        if context is not None:
            return self._chunk_walk(op, value, end, context).get_cardinality()
        return self._bsi_index().compare_cardinality(op, value, end, None)

    def lt_cardinality(self, value: int, context=None) -> int:
        return self._compare_cardinality(Operation.LT, value, 0, context)

    def lte_cardinality(self, value: int, context=None) -> int:
        return self._compare_cardinality(Operation.LE, value, 0, context)

    def gt_cardinality(self, value: int, context=None) -> int:
        return self._compare_cardinality(Operation.GT, value, 0, context)

    def gte_cardinality(self, value: int, context=None) -> int:
        return self._compare_cardinality(Operation.GE, value, 0, context)

    def eq_cardinality(self, value: int, context=None) -> int:
        return self._compare_cardinality(Operation.EQ, value, 0, context)

    def neq_cardinality(self, value: int, context=None) -> int:
        return self._compare_cardinality(Operation.NEQ, value, 0, context)

    def between_cardinality(self, lo: int, hi: int, context=None) -> int:
        return self._compare_cardinality(Operation.RANGE, lo, hi, context)

    # Batched cardinality family: a whole [Q] array of thresholds answered
    # in ONE device dispatch on the context-free path (the BSI's vmapped
    # O'Neil walk shares a single HBM pass over the packed slice tensor —
    # no reference equivalent; RangeBitmap.java answers one query per call)
    def _compare_cardinality_many(self, op, values, ends=None, context=None):
        vals = [int(v) for v in np.asarray(values, dtype=object).ravel()]
        if any(v < 0 for v in vals):
            raise ValueError("RangeBitmap values are unsigned")
        if op is Operation.RANGE:
            # same contract as the context-free engine (bsi._counts_many)
            if ends is None:
                raise ValueError("RANGE requires ends")
            end_list = [int(e) for e in np.asarray(ends, dtype=object).ravel()]
            if len(end_list) != len(vals):
                raise ValueError("ends must align with values")
        else:
            end_list = [0] * len(vals)
        if context is not None:
            return np.array(
                [
                    self._chunk_walk(op, v, e, context).get_cardinality()
                    for v, e in zip(vals, end_list)
                ],
                dtype=np.int64,
            )
        return self._bsi_index().compare_cardinality_many(
            op, vals, end_list if op is Operation.RANGE else None
        )

    def lt_cardinality_many(self, values, context=None):
        return self._compare_cardinality_many(Operation.LT, values, None, context)

    def lte_cardinality_many(self, values, context=None):
        return self._compare_cardinality_many(Operation.LE, values, None, context)

    def gt_cardinality_many(self, values, context=None):
        return self._compare_cardinality_many(Operation.GT, values, None, context)

    def gte_cardinality_many(self, values, context=None):
        return self._compare_cardinality_many(Operation.GE, values, None, context)

    def eq_cardinality_many(self, values, context=None):
        return self._compare_cardinality_many(Operation.EQ, values, None, context)

    def neq_cardinality_many(self, values, context=None):
        return self._compare_cardinality_many(Operation.NEQ, values, None, context)

    def between_cardinality_many(self, los, his, context=None):
        return self._compare_cardinality_many(Operation.RANGE, los, his, context)

    # ------------------------------------------------------------------
    @property
    def row_count(self) -> int:
        return self._max_rid

    def __repr__(self):
        return (
            f"RangeBitmap(rows={self._max_rid}, slices={self._slice_count}, "
            f"max_value={self._max_value})"
        )


class RangeBitmapAppender:
    """Append-only builder (RangeBitmap.Appender, RangeBitmap.java:1378-1520).

    Bounded memory: raw values are buffered in a single fixed 2^16-slot
    chunk; crossing the boundary flushes the chunk into one compressed
    container per slice (mask -> sorted uint16 positions -> best container,
    run-optimized), mirroring the reference's per-2^16-rid slice flush.
    Peak transient memory is O(chunk) regardless of total rows."""

    def __init__(self, max_value: int):
        max_value = int(max_value)
        if not 0 <= max_value < _MAX64:
            raise ValueError("max_value outside unsigned 64-bit range")
        self._max_value = max_value
        self._slice_count = max(1, max_value.bit_length())
        self._buf = np.empty(CHUNK, dtype=np.uint64)
        self._fill = 0
        self._slice_arrays = [RoaringArray() for _ in range(self._slice_count)]
        self._rows = 0

    def add(self, value: int) -> None:
        """Append the value for the next row id (Appender.add)."""
        value = int(value)
        if not 0 <= value <= self._max_value:
            raise ValueError(
                f"value {value} outside appender range [0, {self._max_value}]"
            )
        self._buf[self._fill] = value
        self._fill += 1
        if self._fill == CHUNK:
            self._flush()

    def add_many(self, values: Iterable[int]) -> None:
        arr = np.asarray(
            values
            if isinstance(values, np.ndarray)
            else np.fromiter(iter(values), dtype=np.uint64)
        )
        if np.issubdtype(arr.dtype, np.signedinteger) and arr.size and arr.min() < 0:
            raise ValueError("RangeBitmap values are unsigned")
        arr = arr.astype(np.uint64).ravel()
        if arr.size and int(arr.max()) > self._max_value:
            raise ValueError("value outside appender range")
        pos = 0
        while pos < arr.size:
            take = min(CHUNK - self._fill, arr.size - pos)
            self._buf[self._fill : self._fill + take] = arr[pos : pos + take]
            self._fill += take
            pos += take
            if self._fill == CHUNK:
                self._flush()

    def _chunk_containers(self, vals: np.ndarray) -> List[Optional[Container]]:
        """Per-slice compressed containers for one chunk of raw values."""
        out: List[Optional[Container]] = []
        for i in range(self._slice_count):
            mask = (vals >> np.uint64(i)) & np.uint64(1) == 1
            if mask.any():
                lows = np.flatnonzero(mask).astype(np.uint16)
                out.append(container_from_values(lows).run_optimize())
            else:
                out.append(None)
        return out

    def _flush(self) -> None:
        """Seal the buffered chunk into per-slice containers
        (the reference's per-2^16-rid flush, RangeBitmap.java:1462-1520)."""
        if self._fill == 0:
            return
        key = self._rows >> 16
        for i, c in enumerate(self._chunk_containers(self._buf[: self._fill])):
            if c is not None:
                self._slice_arrays[i].append(key, c)
        self._rows += self._fill
        self._fill = 0

    def build(self) -> RangeBitmap:
        """Seal into a queryable RangeBitmap (Appender.build,
        RangeBitmap.java:1415-1440).

        Non-destructive: the appender stays usable afterwards (build, keep
        appending, build again), so the partial chunk is compressed into
        temporary containers and the slice arrays are shallow-copied rather
        than shared with the returned index."""
        partial = (
            self._chunk_containers(self._buf[: self._fill])
            if self._fill
            else [None] * self._slice_count
        )
        key = self._rows >> 16
        slices: List[RoaringBitmap] = []
        for i, arr in enumerate(self._slice_arrays):
            a = RoaringArray()
            a.keys = list(arr.keys)
            a.containers = list(arr.containers)
            if partial[i] is not None:
                a.append(key, partial[i])
            bm = RoaringBitmap()
            bm.high_low_container = a
            slices.append(bm)
        return RangeBitmap(slices, self._max_value, self._rows + self._fill)

    def serialize(self) -> bytes:
        """Seal directly to bytes (Appender.serialize)."""
        return self.build().serialize()

    def clear(self) -> None:
        self._buf = np.empty(CHUNK, dtype=np.uint64)
        self._fill = 0
        self._slice_arrays = [RoaringArray() for _ in range(self._slice_count)]
        self._rows = 0
