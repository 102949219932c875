"""Buffer-package twins (org.roaringbitmap.buffer).

Counterpart of the JAX package's ``models/buffer.py``. The reference
re-implements its whole container hierarchy over ``java.nio`` buffers
(MappeableContainer.java:19, MutableRoaringBitmap.java,
BufferFastAggregation.java:20, BufferParallelAggregation.java:41) so bitmaps
can live off-heap or memory-mapped. Here ``ImmutableRoaringBitmap``
(``models/immutable.py``) already materializes zero-copy numpy views over
the serialized buffer that are the ordinary container classes, so ONE
algebra serves both worlds.

This module supplies the rest of the buffer package's public surface:

* ``MutableRoaringBitmap`` — the writable buffer-world facade
  (buffer/MutableRoaringBitmap.java), castable to an immutable view in O(1)
  (README.md:205-207) and constructible from one.
* Mixed-operand pairwise algebra — ``and_``/``or_``/``xor``/``andnot``/
  ``or_not`` and the cardinality variants accept any combination of heap
  ``RoaringBitmap``, ``MutableRoaringBitmap`` and mapped
  ``ImmutableRoaringBitmap`` operands, like the reference's
  ImmutableRoaringBitmap static ops (buffer/ImmutableRoaringBitmap.java).
* ``BufferFastAggregation`` (BufferFastAggregation.java:20) /
  ``BufferParallelAggregation`` (BufferParallelAggregation.java:41) — the
  N-way engines over mixed or mapped inputs, including the workShy AND
  (BufferFastAggregation.java:29-33). They are the engines of
  ``parallel/aggregation.py`` unchanged, ``mode=`` included: on the device
  path (``aggregation.config.device``, the card by default) a mapped
  bitmap's containers are packed from their buffer views, keyed in the
  pack cache by the mapped array's identity, and expanded on the card.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

from ..parallel import store
from ..parallel.aggregation import FastAggregation, ParallelAggregation, _aggregate, _flatten
from .container import Container
from .immutable import ImmutableRoaringBitmap
from .roaring import RoaringBitmap

AnyRoaring = Union[RoaringBitmap, ImmutableRoaringBitmap]


class MutableRoaringBitmap(RoaringBitmap):
    """Writable buffer-world bitmap (buffer/MutableRoaringBitmap.java).

    Same algebra and mutation API as :class:`RoaringBitmap` (inherited);
    adds the buffer-world casts. ``to_immutable`` serializes once and wraps
    the bytes zero-copy; ``as_immutable_view`` is the reference's O(1) cast
    (README.md:205-207) — a read-only facade over the *live* containers
    (safe for concurrent reads while unmutated, the documented contract,
    README.md:280).
    """

    @staticmethod
    def _adopt(rb: RoaringBitmap) -> "MutableRoaringBitmap":
        out = MutableRoaringBitmap()
        out.high_low_container = rb.high_low_container
        return out

    @staticmethod
    def of(source: AnyRoaring) -> "MutableRoaringBitmap":
        """Deep-copy construction from heap or mapped bitmap."""
        if isinstance(source, ImmutableRoaringBitmap):
            return MutableRoaringBitmap._adopt(source.to_mutable())
        return MutableRoaringBitmap._adopt(source.clone())

    # -- inherited factories re-typed so they stay in the buffer world ----
    @staticmethod
    def bitmap_of(*values: int) -> "MutableRoaringBitmap":
        return MutableRoaringBitmap._adopt(RoaringBitmap.bitmap_of(*values))

    bitmap_of_unordered = bitmap_of

    @staticmethod
    def bitmap_of_range(start: int, end: int) -> "MutableRoaringBitmap":
        return MutableRoaringBitmap._adopt(RoaringBitmap.bitmap_of_range(start, end))

    @staticmethod
    def flip(bm: AnyRoaring, start: int, end: int) -> "MutableRoaringBitmap":
        return MutableRoaringBitmap._adopt(RoaringBitmap.flip(bm, start, end))

    @staticmethod
    def add_offset(bm: AnyRoaring, offset: int) -> "MutableRoaringBitmap":
        return MutableRoaringBitmap._adopt(RoaringBitmap.add_offset(bm, offset))

    def clone(self) -> "MutableRoaringBitmap":
        return MutableRoaringBitmap._adopt(super().clone())

    def limit(self, max_cardinality: int) -> "MutableRoaringBitmap":
        return MutableRoaringBitmap._adopt(super().limit(max_cardinality))

    def select_range(self, start: int, end: int) -> "MutableRoaringBitmap":
        return MutableRoaringBitmap._adopt(super().select_range(start, end))

    def to_immutable(self) -> ImmutableRoaringBitmap:
        """Freeze into a buffer-backed immutable (one serialization pass)."""
        return ImmutableRoaringBitmap(self.serialize())

    to_immutable_roaring_bitmap = to_immutable  # reference naming

    def get_mappeable_roaring_array(self):
        """The backing index (MutableRoaringBitmap.getMappeableRoaringArray)."""
        return self.high_low_container

    def as_immutable_view(self) -> "ImmutableView":
        """O(1) cast to a read-only view sharing this bitmap's containers."""
        return ImmutableView(self)

    @staticmethod
    def deserialize(data, copy: bool = True) -> "MutableRoaringBitmap":
        """``copy=False`` builds zero-copy container views over ``data``
        (serialization.read_into's frozen-consumer contract): sound only
        when the result will not be mutated — a mutable twin built over a
        read-only mmap raises on the first in-place word patch."""
        return MutableRoaringBitmap._adopt(
            RoaringBitmap.deserialize(data, copy=copy)
        )

    # -- mixed-operand pairwise algebra (ImmutableRoaringBitmap statics) ---
    @staticmethod
    def and_(x1: AnyRoaring, x2: AnyRoaring) -> "MutableRoaringBitmap":
        return MutableRoaringBitmap._adopt(RoaringBitmap.and_(x1, x2))

    @staticmethod
    def or_(x1: AnyRoaring, x2: AnyRoaring) -> "MutableRoaringBitmap":
        return MutableRoaringBitmap._adopt(RoaringBitmap.or_(x1, x2))

    @staticmethod
    def xor(x1: AnyRoaring, x2: AnyRoaring) -> "MutableRoaringBitmap":
        return MutableRoaringBitmap._adopt(RoaringBitmap.xor(x1, x2))

    @staticmethod
    def andnot(x1: AnyRoaring, x2: AnyRoaring) -> "MutableRoaringBitmap":
        return MutableRoaringBitmap._adopt(RoaringBitmap.andnot(x1, x2))

    @staticmethod
    def or_not(x1: AnyRoaring, x2: AnyRoaring, range_end: int) -> "MutableRoaringBitmap":
        return MutableRoaringBitmap._adopt(RoaringBitmap.or_not(x1, x2, range_end))

    @staticmethod
    def and_cardinality(x1: AnyRoaring, x2: AnyRoaring) -> int:
        return RoaringBitmap.and_cardinality(x1, x2)

    @staticmethod
    def or_cardinality(x1: AnyRoaring, x2: AnyRoaring) -> int:
        return RoaringBitmap.or_cardinality(x1, x2)

    @staticmethod
    def xor_cardinality(x1: AnyRoaring, x2: AnyRoaring) -> int:
        return RoaringBitmap.xor_cardinality(x1, x2)

    @staticmethod
    def andnot_cardinality(x1: AnyRoaring, x2: AnyRoaring) -> int:
        return RoaringBitmap.andnot_cardinality(x1, x2)

    @staticmethod
    def intersects(x1: AnyRoaring, x2: AnyRoaring) -> bool:
        return RoaringBitmap.intersects(x1, x2)

    def __repr__(self) -> str:
        return f"MutableRoaringBitmap(card={self.get_cardinality()})"


class ImmutableView:
    """O(1) read-only cast of a live MutableRoaringBitmap
    (MutableRoaringBitmap→ImmutableRoaringBitmap upcast, README.md:205-207).

    Shares the underlying containers — no copy, no serialization. Exposes
    the read API plus ``high_low_container`` so it interoperates with all
    algebra/aggregation engines as an operand.
    """

    __slots__ = ("_bm",)

    def __init__(self, bm: RoaringBitmap):
        self._bm = bm

    @property
    def high_low_container(self):
        return self._bm.high_low_container

    def __getattr__(self, name):
        # read-only delegation: block the mutating surface
        if name in _MUTATORS:
            raise AttributeError(f"ImmutableView is read-only (no {name})")
        return getattr(self._bm, name)

    def __iter__(self):
        return iter(self._bm)

    def __contains__(self, x):
        return x in self._bm

    def __len__(self):
        return len(self._bm)

    def __eq__(self, other):
        return self._bm == other

    def __hash__(self):
        return hash(self._bm)

    def __repr__(self):
        return f"ImmutableView({self._bm!r})"


_MUTATORS = frozenset(
    {
        "add",
        "checked_add",
        "add_many",
        "remove",
        "checked_remove",
        "add_range",
        "remove_range",
        "flip_range",
        "ior",
        "iand",
        "ixor",
        "iandnot",
        "run_optimize",
        "remove_run_compression",
    }
)


class BufferFastAggregation:
    """N-way aggregation over mixed heap/mapped operands
    (BufferFastAggregation.java:20). Same engine + dispatch as
    FastAggregation — including workShy key-intersection AND for many
    inputs (BufferFastAggregation.java:29-33) and the CPU-vs-device
    dispatch; mapped containers are packed for the card from their buffer
    views without deserialization."""

    @staticmethod
    def and_(*bitmaps: AnyRoaring, mode: Optional[str] = None) -> MutableRoaringBitmap:
        return MutableRoaringBitmap._adopt(_aggregate(_flatten(bitmaps), "and", mode))

    @staticmethod
    def or_(*bitmaps: AnyRoaring, mode: Optional[str] = None) -> MutableRoaringBitmap:
        return MutableRoaringBitmap._adopt(_aggregate(_flatten(bitmaps), "or", mode))

    @staticmethod
    def xor(*bitmaps: AnyRoaring, mode: Optional[str] = None) -> MutableRoaringBitmap:
        return MutableRoaringBitmap._adopt(_aggregate(_flatten(bitmaps), "xor", mode))

    @staticmethod
    def naive_or(*bitmaps: AnyRoaring) -> MutableRoaringBitmap:
        return MutableRoaringBitmap._adopt(FastAggregation.naive_or(*_flatten(bitmaps)))

    @staticmethod
    def naive_and(*bitmaps: AnyRoaring) -> MutableRoaringBitmap:
        return MutableRoaringBitmap._adopt(FastAggregation.naive_and(*_flatten(bitmaps)))

    @staticmethod
    def horizontal_or(*bitmaps: AnyRoaring) -> MutableRoaringBitmap:
        return MutableRoaringBitmap._adopt(
            FastAggregation.horizontal_or(*_flatten(bitmaps))
        )

    @staticmethod
    def priorityqueue_or(*bitmaps: AnyRoaring) -> MutableRoaringBitmap:
        return MutableRoaringBitmap._adopt(
            FastAggregation.priorityqueue_or(*_flatten(bitmaps))
        )

    @staticmethod
    def workshy_and(*bitmaps: AnyRoaring, mode: Optional[str] = None) -> MutableRoaringBitmap:
        return BufferFastAggregation.and_(*bitmaps, mode=mode)

    @staticmethod
    def and_cardinality(*bitmaps: AnyRoaring, mode: Optional[str] = None) -> int:
        return FastAggregation.and_cardinality(*_flatten(bitmaps), mode=mode)

    @staticmethod
    def or_cardinality(*bitmaps: AnyRoaring, mode: Optional[str] = None) -> int:
        return FastAggregation.or_cardinality(*_flatten(bitmaps), mode=mode)

    @staticmethod
    def xor_cardinality(*bitmaps: AnyRoaring, mode: Optional[str] = None) -> int:
        return FastAggregation.xor_cardinality(*_flatten(bitmaps), mode=mode)


class BufferParallelAggregation:
    """Fork-join OR/XOR over mixed/mapped operands
    (BufferParallelAggregation.java:41): key-major transpose + pooled
    per-key reduction on the CPU, or the grouped reduce kernel on the
    card."""

    @staticmethod
    def group_by_key(*bitmaps: AnyRoaring) -> Dict[int, List[Container]]:
        return store.group_by_key(_flatten(bitmaps))

    @staticmethod
    def or_(*bitmaps: AnyRoaring, mode: Optional[str] = None) -> MutableRoaringBitmap:
        return MutableRoaringBitmap._adopt(
            ParallelAggregation.or_(*_flatten(bitmaps), mode=mode)
        )

    @staticmethod
    def xor(*bitmaps: AnyRoaring, mode: Optional[str] = None) -> MutableRoaringBitmap:
        return MutableRoaringBitmap._adopt(
            ParallelAggregation.xor(*_flatten(bitmaps), mode=mode)
        )

    @staticmethod
    def and_(*bitmaps: AnyRoaring, mode: Optional[str] = None) -> MutableRoaringBitmap:
        return BufferFastAggregation.and_(*bitmaps, mode=mode)
