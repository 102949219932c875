"""L4' aggregation engines: N-way AND/OR/XOR with CPU-vs-device selection.

API parity with FastAggregation (FastAggregation.java:15) and
ParallelAggregation (ParallelAggregation.java:39), as in the JAX package's
``parallel/aggregation.py``:

* **CPU path** — key-major transpose, then an in-place word fold per group
  with one popcount at the end: the analogue of the lazy-OR protocol
  (Container.lazyIOR Container.java:717, repairAfterLazy :873) as
  vectorized numpy.
* **Device path** — pack all groups into one ``[N, 2048]`` int32 row block
  on the card (parallel/store.py) and run the grouped reduce + popcount
  kernels (ops/kernels.py).

``mode="auto"`` picks between them by working-set size only
(``config.min_device_containers``); ``mode="device"`` always takes the
device path and ``mode="cpu"`` never does. The device path runs on
``device`` (default ``config.device``, ``"cuda"``); asking for ``"cuda"``
without a card raises — there is no silent CPU fallback. ``device="cpu"``
runs the same device-path code on CPU tensors with the kernels' plain
versions.

`workShyAnd`'s key trick (intersect keys first, only then touch containers,
FastAggregation.java:356-396) is kept: AND packs only the key-intersection
groups, which also makes every group exactly B rows — a dense,
padding-free device layout.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..device import resolve_device
from ..models.container import (
    ArrayContainer,
    BitmapContainer,
    Container,
    best_container_of_words,
)
from ..models.roaring import RoaringBitmap
from ..utils import bits
from . import store


class config:
    """Dispatcher knobs (the reference's analogue is compile-time constants +
    the >10-input workShyAnd switch, FastAggregation.java:37-42)."""

    mode: str = "auto"  # 'auto' | 'cpu' | 'device'
    min_device_containers: int = 64
    device: str = "cuda"  # where the device path runs: 'cuda' | 'cpu'


def _use_device(n_containers: int, mode: Optional[str]) -> bool:
    mode = mode or config.mode
    if mode == "cpu":
        return False
    if mode == "device":
        return True
    if mode != "auto":
        raise ValueError(f"mode must be 'auto', 'cpu' or 'device', got {mode!r}")
    return n_containers >= config.min_device_containers


# ---------------------------------------------------------------------------
# CPU word folds (lazy-OR protocol analogue)
# ---------------------------------------------------------------------------


def _ior_container_into(acc: np.ndarray, c: Container) -> None:
    """OR one container into a word accumulator without materializing it
    (the lazy-OR protocol's per-type fast paths)."""
    if isinstance(c, BitmapContainer):
        acc |= c.words
    elif isinstance(c, ArrayContainer):
        bits.or_values_into_words(acc, c.content)
    else:
        for s, l in zip(c.starts.tolist(), c.lengths.tolist()):
            bits.set_bitmap_range(acc, s, s + l + 1)


def _fold_group_words(cs: List[Container], op: str) -> np.ndarray:
    """In-place word fold of one key group; popcount deferred to the caller."""
    first = cs[0]
    acc = first.to_words()  # always a copy
    if op == "or":
        for c in cs[1:]:
            _ior_container_into(acc, c)
    elif op == "and":
        for c in cs[1:]:
            acc &= c.words if isinstance(c, BitmapContainer) else c.to_words()
    else:  # xor
        for c in cs[1:]:
            acc ^= c.words if isinstance(c, BitmapContainer) else c.to_words()
    return acc


def _percontainer_aggregate(
    groups: Dict[int, List[Container]], op: str, pool: Optional[ThreadPoolExecutor] = None
) -> RoaringBitmap:
    """The CPU path: per-key word-fold walk (optionally on the shared
    pool)."""
    out = RoaringBitmap()
    keys = sorted(groups)

    def reduce_key(k: int) -> Container:
        cs = groups[k]
        if len(cs) == 1:
            return cs[0].clone()
        return best_container_of_words(_fold_group_words(cs, op))

    if pool is None:
        results = [reduce_key(k) for k in keys]
    else:
        results = list(pool.map(reduce_key, keys))
    for k, c in zip(keys, results):
        if c.cardinality:
            out.high_low_container.append(k, c)
    return out


def _device_pack(bitmaps: Sequence[RoaringBitmap], keys_filter, device):
    return store.pack_groups(
        store.group_by_key(bitmaps, keys_filter=keys_filter),
        resolve_device(config.device if device is None else device),
    )


def _device_aggregate(
    bitmaps: Sequence[RoaringBitmap], keys_filter, op: str, device
) -> RoaringBitmap:
    """Device path: group, pack, reduce, unpack."""
    packed = _device_pack(bitmaps, keys_filter, device)
    words, cards = store.reduce_packed(packed, op=op)
    return store.unpack_to_bitmap(packed.group_keys, words, cards)


def _dispatch_prelude(bitmaps: Sequence[RoaringBitmap], op: str):
    """Shared prelude of the materializing and cardinality-only engines:
    the AND key intersection (FastAggregation.workShyAnd) and the
    working-set row count. Returns ``(keys_filter, n_rows)``; keys_filter
    is None for or/xor and an empty set when the AND intersection is empty
    (trivial result)."""
    if op == "and":
        keys = store.intersect_keys(bitmaps)
        if not keys:
            return set(), 0
        n = sum(
            sum(1 for k in bm.high_low_container.keys if k in keys)
            for bm in bitmaps
        )
        return keys, n
    return None, sum(bm.high_low_container.size for bm in bitmaps)


def _aggregate(
    bitmaps: Sequence[RoaringBitmap],
    op: str,
    mode: Optional[str] = None,
    device=None,
    pool: Optional[ThreadPoolExecutor] = None,
) -> RoaringBitmap:
    """N-way aggregation: the device path or the CPU word fold, as
    ``_use_device`` decides. A failure on the chosen path raises."""
    bitmaps = [b for b in bitmaps]
    if not bitmaps:
        return RoaringBitmap()
    if len(bitmaps) == 1:
        return bitmaps[0].clone()
    keys, n = _dispatch_prelude(bitmaps, op)
    if keys is not None and not keys:
        return RoaringBitmap()
    if _use_device(n, mode):
        return _device_aggregate(bitmaps, keys, op, device)
    return _percontainer_aggregate(
        store.group_by_key(bitmaps, keys_filter=keys), op, pool=pool
    )


def _aggregate_cardinality(bitmaps: List[RoaringBitmap], op: str, mode, device) -> int:
    """N-way cardinality. On the device path the group reduction's
    popcounts (one int per key group) are the only thing fetched — no
    [G, 2048] stream-back, no container rebuild; the sum is the answer
    because key groups partition the universe."""
    if not bitmaps:
        return 0
    if len(bitmaps) == 1:
        return bitmaps[0].get_cardinality()
    keys, n = _dispatch_prelude(bitmaps, op)
    if keys is not None and not keys:
        return 0
    if _use_device(n, mode):
        packed = _device_pack(bitmaps, keys, device)
        return int(store.reduce_packed_cardinality(packed, op=op).sum())
    return _percontainer_aggregate(
        store.group_by_key(bitmaps, keys_filter=keys), op
    ).get_cardinality()


def _flatten(bitmaps) -> List[RoaringBitmap]:
    # single non-bitmap argument = an iterable of bitmaps
    if len(bitmaps) == 1 and not hasattr(bitmaps[0], "high_low_container"):
        return list(bitmaps[0])
    return list(bitmaps)


# ---------------------------------------------------------------------------
# public engines
# ---------------------------------------------------------------------------


class FastAggregation:
    """N-way aggregation (FastAggregation.java:15)."""

    @staticmethod
    def or_(*bitmaps: RoaringBitmap, mode: Optional[str] = None, device=None) -> RoaringBitmap:
        """FastAggregation.or (FastAggregation.java:602)."""
        return _aggregate(_flatten(bitmaps), "or", mode, device)

    @staticmethod
    def and_(*bitmaps: RoaringBitmap, mode: Optional[str] = None, device=None) -> RoaringBitmap:
        """FastAggregation.and — workShy key intersection for many inputs
        (FastAggregation.java:37-42, :356-396)."""
        return _aggregate(_flatten(bitmaps), "and", mode, device)

    @staticmethod
    def xor(*bitmaps: RoaringBitmap, mode: Optional[str] = None, device=None) -> RoaringBitmap:
        return _aggregate(_flatten(bitmaps), "xor", mode, device)

    @staticmethod
    def and_cardinality(*bitmaps: RoaringBitmap, mode: Optional[str] = None, device=None) -> int:
        """FastAggregation.andCardinality (FastAggregation.java:71)."""
        return _aggregate_cardinality(_flatten(bitmaps), "and", mode, device)

    @staticmethod
    def or_cardinality(*bitmaps: RoaringBitmap, mode: Optional[str] = None, device=None) -> int:
        """FastAggregation.orCardinality (FastAggregation.java:90)."""
        return _aggregate_cardinality(_flatten(bitmaps), "or", mode, device)

    @staticmethod
    def xor_cardinality(*bitmaps: RoaringBitmap, mode: Optional[str] = None, device=None) -> int:
        return _aggregate_cardinality(_flatten(bitmaps), "xor", mode, device)

    # ---- sequential folds: independent engines to cross-check against ----

    @staticmethod
    def naive_or(*bitmaps: RoaringBitmap) -> RoaringBitmap:
        """Sequential lazy fold (FastAggregation.naive_or :541 +
        Container.lazyIOR protocol): accumulate words per key left to right,
        popcount once at the end."""
        acc: Dict[int, np.ndarray] = {}
        for bm in _flatten(bitmaps):
            hlc = bm.high_low_container
            for k, c in zip(hlc.keys, hlc.containers):
                words = acc.get(k)
                if words is None:
                    acc[k] = c.to_words()
                else:
                    _ior_container_into(words, c)
        return _from_word_accumulators(acc)

    @staticmethod
    def naive_xor(*bitmaps: RoaringBitmap) -> RoaringBitmap:
        acc: Dict[int, np.ndarray] = {}
        for bm in _flatten(bitmaps):
            hlc = bm.high_low_container
            for k, c in zip(hlc.keys, hlc.containers):
                words = acc.get(k)
                if words is None:
                    acc[k] = c.to_words()
                else:
                    words ^= c.words if isinstance(c, BitmapContainer) else c.to_words()
        return _from_word_accumulators(acc)

    @staticmethod
    def naive_and(*bitmaps: RoaringBitmap) -> RoaringBitmap:
        """Pairwise left fold (FastAggregation.naive_and)."""
        bms = _flatten(bitmaps)
        if not bms:
            return RoaringBitmap()
        acc = bms[0].clone()
        for bm in bms[1:]:
            acc.iand(bm)
            if acc.is_empty():
                break
        return acc


def _from_word_accumulators(acc: Dict[int, np.ndarray]) -> RoaringBitmap:
    out = RoaringBitmap()
    for k in sorted(acc):
        c = best_container_of_words(acc[k])
        if c.cardinality:
            out.high_low_container.append(k, c)
    return out


class ParallelAggregation:
    """Fork-join N-way OR/XOR (ParallelAggregation.java:39).

    On the CPU path the per-key reduction runs on a thread pool (numpy word
    folds release the GIL); on the device path it is the same grouped
    reduce kernel as FastAggregation — the card's grid is the pool. No
    parallel AND, matching the reference's judgement
    (ParallelAggregation.java:16-17); ``and_`` delegates to
    FastAggregation."""

    _POOL_SIZE = 8
    _POOL: Optional[ThreadPoolExecutor] = None  # guarded-by: _POOL_LOCK
    _POOL_LOCK = threading.Lock()

    @classmethod
    def _shared_pool(cls) -> ThreadPoolExecutor:
        """Lazily-created shared pool (the reference uses the JVM
        commonPool, ParallelAggregation.java:23-25)."""
        with cls._POOL_LOCK:
            if cls._POOL is None:
                cls._POOL = ThreadPoolExecutor(
                    max_workers=cls._POOL_SIZE, thread_name_prefix="rb-agg"
                )
            return cls._POOL

    @staticmethod
    def or_(*bitmaps: RoaringBitmap, mode: Optional[str] = None, device=None) -> RoaringBitmap:
        """ParallelAggregation.or (ParallelAggregation.java:160)."""
        return ParallelAggregation._run(_flatten(bitmaps), "or", mode, device)

    @staticmethod
    def xor(*bitmaps: RoaringBitmap, mode: Optional[str] = None, device=None) -> RoaringBitmap:
        """ParallelAggregation.xor (ParallelAggregation.java:180)."""
        return ParallelAggregation._run(_flatten(bitmaps), "xor", mode, device)

    @staticmethod
    def and_(*bitmaps: RoaringBitmap, mode: Optional[str] = None, device=None) -> RoaringBitmap:
        return FastAggregation.and_(*bitmaps, mode=mode, device=device)

    @staticmethod
    def _run(bitmaps, op, mode, device):
        return _aggregate(
            bitmaps, op, mode, device, pool=ParallelAggregation._shared_pool()
        )
