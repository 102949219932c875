"""L6' ingest/streaming writers.

API parity with the builder wizard (RoaringBitmapWriter.java:9-115):
``RoaringBitmapWriter.writer().optimise_for_arrays()...get()``. The
``ConstantMemoryContainerAppender`` strategy (ConstantMemoryContainerAppender
.java:10-40: accumulate into one fixed 8 KiB word buffer, emit the best
container on key advance) is the sorted-stream fast path; unsorted input is
buffered per key and flushed vectorized (the ``partialRadixSort`` analogue,
Util.java:1196, is numpy's sort on the full 32-bit values).

Counterpart of the JAX package's ``models/writer.py``. A word-buffer OR of
many values (``add_many`` within the current key) runs on the native host
tier (``utils.bits.or_values_into_words``, the C kernel
``rb_words_from_values``); ``BitmapWriter(into=)`` streams into an existing
bitmap through its attributed mutators, so a resident pack of that bitmap
re-packs only the touched rows.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np

from ..utils import bits
from .container import (
    ARRAY_MAX_SIZE,
    ArrayContainer,
    BitmapContainer,
    Container,
    RunContainer,
    best_container_of_words,
    container_from_values,
)
from .fastrank import FastRankRoaringBitmap
from .roaring import RoaringBitmap


class RoaringBitmapWriter:
    """Builder DSL (RoaringBitmapWriter.java:36-115)."""

    def __init__(self):
        self._optimise_runs = False
        self._constant_memory = False
        self._partially_sorted = False
        self._run_compress = True
        self._fast_rank = False
        self._expected_container_size = 16
        self._initial_capacity = 16

    # wizard options --------------------------------------------------
    @staticmethod
    def writer() -> "RoaringBitmapWriter":
        return RoaringBitmapWriter()

    def optimise_for_arrays(self) -> "RoaringBitmapWriter":
        self._optimise_runs = False
        return self

    def optimise_for_runs(self) -> "RoaringBitmapWriter":
        self._optimise_runs = True
        return self

    def constant_memory(self) -> "RoaringBitmapWriter":
        self._constant_memory = True
        return self

    def expected_values_per_container(self, n: int) -> "RoaringBitmapWriter":
        # thresholds from RoaringBitmapWriter.java:68-77
        self._expected_container_size = int(n)
        if n < ARRAY_MAX_SIZE:
            self._optimise_runs = False
        elif n < 1 << 14:
            self._constant_memory = True
        else:
            self._optimise_runs = True
        return self

    def expected_density(self, density: float) -> "RoaringBitmapWriter":
        return self.expected_values_per_container(int(density * (1 << 16)))

    def expected_range(self, min_value: int, max_value: int) -> "RoaringBitmapWriter":
        self._initial_capacity = max(1, ((int(max_value) >> 16) - (int(min_value) >> 16) + 1))
        return self

    def initial_capacity(self, n: int) -> "RoaringBitmapWriter":
        self._initial_capacity = int(n)
        return self

    def partially_sort_values(self) -> "RoaringBitmapWriter":
        self._partially_sorted = True
        return self

    def run_compress(self, enabled: bool) -> "RoaringBitmapWriter":
        self._run_compress = bool(enabled)
        return self

    def fast_rank(self) -> "RoaringBitmapWriter":
        self._fast_rank = True
        return self

    def get(self) -> "BitmapWriter":
        return BitmapWriter(
            optimise_runs=self._optimise_runs and self._run_compress,
            constant_memory=self._constant_memory,
            fast_rank=self._fast_rank,
        )


class BitmapWriter:
    """Streaming appender. Sorted streams take the constant-memory fast path
    (one 8 KiB buffer); out-of-order values fall back to per-key buffers.

    ``into=`` points the writer at an EXISTING bitmap instead of a fresh
    one: every emit lands through the bitmap's attributed mutators
    (``set_container_at_index`` / ``insert_new_key_value_at`` /
    ``append`` — all of which ``touch_key``), so the pack cache's per-key
    dirty tracking prices each flushed chunk and a later
    ``store.packed_for`` repack takes the O(k) delta path. The target
    must be a mutable ``RoaringBitmap``: an ``ImmutableRoaringBitmap`` or
    an ``ImmutableView`` is refused here, and the writer's word buffer is
    its own, so no write lands in a mapped buffer."""

    def __init__(self, optimise_runs=False, constant_memory=False, fast_rank=False,
                 into: Optional[RoaringBitmap] = None):
        self._optimise_runs = optimise_runs
        self._constant_memory = constant_memory
        if into is not None:
            if not isinstance(into, RoaringBitmap):
                raise TypeError(
                    f"BitmapWriter streams into a mutable RoaringBitmap, not {type(into).__name__}"
                )
            if fast_rank and not isinstance(into, FastRankRoaringBitmap):
                raise ValueError("fast_rank writer cannot stream into a "
                                 "plain RoaringBitmap")
            self._bitmap = into
        else:
            self._bitmap = FastRankRoaringBitmap() if fast_rank else RoaringBitmap()
        self._current_key: Optional[int] = None
        self._words = bits.new_words()
        self._words_dirty = False
        self._pending: Dict[int, List[np.ndarray]] = {}

    # ------------------------------------------------------------------
    def add(self, value: int) -> None:
        value = int(value)
        if not 0 <= value < 1 << 32:
            raise ValueError(f"value {value} outside unsigned 32-bit range")
        key, low = value >> 16, value & 0xFFFF
        if self._current_key is None:
            self._current_key = key
        if key == self._current_key:
            bits.set_bit(self._words, low)
            self._words_dirty = True
        elif key > self._current_key:
            self._flush_current()
            self._current_key = key
            bits.set_bit(self._words, low)
            self._words_dirty = True
        else:  # out of order: buffer
            self._pending.setdefault(key, []).append(
                np.array([low], dtype=np.uint16)
            )

    def add_many(self, values: Iterable[int]) -> None:
        if not isinstance(values, np.ndarray):
            values = np.fromiter(iter(values), dtype=np.int64)
        v = np.asarray(values, dtype=np.int64).ravel()
        if v.size == 0:
            return
        if v.min() < 0 or v.max() >= 1 << 32:
            raise ValueError("values outside unsigned 32-bit range")
        keys = (v >> 16).astype(np.int64)
        lows = (v & 0xFFFF).astype(np.uint16)
        if self._current_key is not None and np.all(keys == self._current_key):
            bits.or_values_into_words(self._words, lows)
            self._words_dirty = True
            return
        for key in np.unique(keys):
            self._pending.setdefault(int(key), []).append(lows[keys == key])

    def add_range(self, start: int, end: int) -> None:
        self.flush()
        self._bitmap.add_range(start, end)

    # ------------------------------------------------------------------
    def _emit(self, key: int, container: Container) -> None:
        if container.cardinality == 0:
            return
        if self._optimise_runs:
            container = container.run_optimize()
        hlc = self._bitmap.high_low_container
        i = hlc.get_index(key)
        if i >= 0:
            merged = hlc.get_container_at_index(i).or_(container)
            if self._optimise_runs:
                # re-select the MERGED result's format, not just the
                # emitted chunk's: or_ returns arrays or bitmaps, so
                # without this a writer streaming into an existing bitmap
                # drifts every write-hot container away from the size
                # rule; only the already-dirty merged row is touched
                merged = merged.run_optimize()
            hlc.set_container_at_index(i, merged)
        elif hlc.size == 0 or key > hlc.keys[-1]:
            hlc.append(key, container)
        else:
            hlc.insert_new_key_value_at(-i - 1, key, container)

    def _flush_current(self) -> None:
        if self._current_key is not None and self._words_dirty:
            # hand the buffer off: best_container_of_words keeps a reference
            # when it builds a dense container, so zeroing it in place would
            # clobber the just-emitted chunk (and any bitmap already
            # returned by get()) — allocate fresh instead of aliasing
            self._emit(self._current_key, best_container_of_words(self._words))
            self._words = bits.new_words()
            self._words_dirty = False

    def flush(self) -> None:
        """Flush buffers into the underlying bitmap (BitmapWriter.flush)."""
        self._flush_current()
        self._current_key = None
        for key in sorted(self._pending):
            chunks = self._pending[key]
            merged = np.unique(np.concatenate(chunks)) if len(chunks) > 1 else np.unique(chunks[0])
            self._emit(key, container_from_values(merged))
        self._pending.clear()
        if isinstance(self._bitmap, FastRankRoaringBitmap):
            self._bitmap._invalidate()

    def get(self) -> RoaringBitmap:
        """Finish and return the bitmap (writer.get())."""
        self.flush()
        return self._bitmap

    get_underlying = get

    def reset(self) -> None:
        """Discard buffered state and start a fresh underlying bitmap
        (RoaringBitmapWriter.reset — reuse one writer across bitmaps)."""
        self._pending.clear()
        self._current_key = None
        self._words = bits.new_words()  # never zero in place: see _flush_current
        self._words_dirty = False
        self._bitmap = (
            FastRankRoaringBitmap()
            if isinstance(self._bitmap, FastRankRoaringBitmap)
            else RoaringBitmap()
        )


def writer() -> RoaringBitmapWriter:
    """Module-level convenience: ``models.writer.writer()``."""
    return RoaringBitmapWriter.writer()
