"""L4' aggregation engines: N-way AND/OR/XOR with CPU-vs-device selection.

API parity with FastAggregation (FastAggregation.java:15) and
ParallelAggregation (ParallelAggregation.java:39), as in the JAX package's
``parallel/aggregation.py``:

* **CPU path** — key-major transpose, then an in-place word fold per group
  with one popcount at the end: the analogue of the lazy-OR protocol
  (Container.lazyIOR Container.java:717, repairAfterLazy :873) as
  vectorized numpy. OR/XOR working sets above the columnar fold gate
  (``columnar.enabled_for_fold``) take the columnar batched fold instead,
  as in the JAX package.
* **Device path** — pack all groups into one ``[N, 2048]`` int32 row block
  on the card and run the grouped reduce + popcount kernels
  (ops/kernels.py). The pack comes from the resident pack cache
  (``store.packed_for``): a repeated aggregation over unchanged bitmaps
  pays no host pack, and a mutated bitmap re-ships only its dirty rows.
  The pack is op-independent, so OR/XOR and the cardinality forms over
  the same bitmaps share one resident entry; AND packs its key
  intersection as its own entry.

``mode="auto"`` picks between them by working-set size only
(``config.min_device_containers``); ``mode="device"`` always takes the
device path and ``mode="cpu"`` never does. The device path runs on
``device`` (default ``config.device``, ``"cuda"``); asking for ``"cuda"``
without a card raises — there is no silent CPU fallback. ``device="cpu"``
runs the same device-path code on CPU tensors with the kernels' plain
versions.

Every call runs under a trace scope (``observe.context``), records its
start tier as the ``agg.dispatch`` decision (resolved with the tier that
ran and its wall) and runs through ``robust.ladder.LADDER.run("agg",
...)``, as in the JAX package. The device tier is alone in its list, so a
device failure raises; the CPU path is the JAX package's CPU chain —
the columnar fold (OR/XOR above the fold gate), the per-container walk,
then the pure-Python fold — so the decision names the same starting tier
as the JAX package's for the same inputs. Before the trace scope opens,
the dispatch calls the health sentinel's inline pacing hook
(``observe.sentinel.maybe_tick``; one bool check while it is off).

With ``config.mesh`` set (``sharding.make_mesh()``), the device path runs
the mesh-sharded grouped reduce (:func:`_sharded_reduce`): the padded
block is cut over the mesh's ``containers`` and ``words`` axes and each
rank folds its block on the card. Every rank of the mesh calls the engine
with the same bitmaps and gets the whole result back: the collective
counterpart of the JAX package's single-controller route.

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
from ..observe import context as _context
from ..observe import decisions as _decisions
from ..observe import sentinel as _sentinel
from ..observe import spans as _spans
from ..observe import timeline as _timeline
from ..robust import ladder as _ladder
from ..utils import bits
from . import store


class config:
    """Dispatcher knobs (the reference's analogue is compile-time constants +
    the >10-input workShyAnd switch, FastAggregation.java:37-42)."""

    mode: str = "auto"  # 'auto' | 'cpu' | 'device'
    min_device_containers: int = 64
    device: str = "cuda"  # where the device path runs: 'cuda' | 'cpu'
    # a DeviceMesh (sharding.make_mesh()): when set, the device path runs
    # the mesh-sharded reduce, a collective call on every rank of the mesh
    mesh = None


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


def _pure_python_fold(bitmaps: Sequence[RoaringBitmap], op: str) -> RoaringBitmap:
    """The bottom CPU rung: the reference's naive sequential folds with
    the columnar router pinned off."""
    from .. import columnar

    with columnar.disabled():
        if op == "or":
            return FastAggregation.naive_or(*bitmaps)
        if op == "xor":
            return FastAggregation.naive_xor(*bitmaps)
        return FastAggregation.naive_and(*bitmaps)


def _cpu_tiers(
    bitmaps: Sequence[RoaringBitmap], keys, n: int, op: str,
    pool: Optional[ThreadPoolExecutor] = None,
):
    """The CPU rungs of the aggregation ladder, as the JAX package chains
    them (its ``aggregation.py:_cpu_tiers``): the columnar batched fold for
    OR/XOR working sets of at least the fold gate's rows (AND starts
    per-container: the JAX package measured its columnar AND fold slower),
    the per-key word-fold walk, and the pure-Python fold. The key-major
    transpose builds once, lazily, for whichever rung runs."""
    from .. import columnar

    box: Dict[str, Dict[int, List[Container]]] = {}

    def _groups():
        if "g" not in box:
            box["g"] = store.group_by_key(bitmaps, keys_filter=keys)
        return box["g"]

    tiers = []
    if op != "and" and columnar.enabled_for_fold(n):

        def _columnar_tier():
            with _timeline.tspan("agg.cpu", "agg", op=op, rows=n):
                return columnar.fold(_groups(), op)

        tiers.append(("columnar-cpu", _columnar_tier))

    def _percontainer_tier():
        with _timeline.tspan("agg.cpu", "agg", op=op, rows=n):
            return _percontainer_aggregate(_groups(), op, pool=pool)

    tiers.append(("per-container", _percontainer_tier))
    tiers.append(("pure-python", lambda: _pure_python_fold(bitmaps, op)))
    return tiers


def _run_tiers(bitmaps, op: str, mode, n: int, tiers, **attrs):
    """Record the ``agg.dispatch`` decision (its start tier, with the JAX
    package's attributes plus ``attrs``) and run ``tiers`` through the
    ladder, which resolves the decision with the tier that ran and its
    wall."""
    seq = _decisions.record_decision(
        "agg.dispatch", tiers[0][0], outcome=True, op=op, rows=n,
        operands=len(bitmaps), mode=mode or config.mode, **attrs,
    )
    return _ladder.LADDER.run("agg", tiers, outcome_seq=seq, outcome_site="agg.dispatch")


def _device_pack(bitmaps: Sequence[RoaringBitmap], keys_filter, device):
    return store.packed_for(
        bitmaps, keys_filter, resolve_device(config.device if device is None else device)
    )


def _device_aggregate(
    bitmaps: Sequence[RoaringBitmap], keys_filter, op: str, device
) -> RoaringBitmap:
    """Device path: the resident pack (built on a miss), reduce (on the
    mesh when ``config.mesh`` is set), unpack."""
    with _spans.span("agg.device", "agg", op=op, n=len(bitmaps)):
        packed = _device_pack(bitmaps, keys_filter, device)
        if config.mesh is not None:
            words, cards = _sharded_reduce(packed, op)
        else:
            words, cards = store.reduce_packed(packed, op=op)
        return store.unpack_to_bitmap(packed.group_keys, words, cards)


def _sharded_reduce(packed: "store.PackedGroups", op: str, cards_only: bool = False):
    """Mesh-sharded grouped reduce (or/and/xor) over ``config.mesh``: each
    group's rows padded to a multiple of the ``containers`` size with the
    op identity (``PackedGroups.padded_device``, resident beside the pack),
    this rank's ``[G, M/nc, 2048/nw]`` block cut from it, and
    ``sharding.distributed_grouped_reduce`` run on it; the ``[G, 2048/nw]``
    words gathered over ``words``. A distribution too skewed for the dense
    pad takes the unsharded reduce (``store.reduce_packed``'s layout): a
    layout choice, which every rank makes alike. Returns host ``(words [G, 2048] uint32, cards [G]
    int64)``, words None with ``cards_only``."""
    from ..ops import device as dev
    from . import sharding

    mesh = config.mesh
    padded = None
    if packed.n_groups:
        padded = packed.padded_device(
            dev._INIT[op], row_multiple=sharding.axis_size(mesh, "containers")
        )
    if padded is None:
        if cards_only:
            return None, store.reduce_packed_cardinality(packed, op=op)
        return store.reduce_packed(packed, op=op)
    local = sharding.shard_rows(mesh, padded, (None, "containers", "words"))
    red, cards = sharding.distributed_grouped_reduce(mesh, op)(local)
    cards = dev.to_host_i64(cards)
    if cards_only:
        return None, cards
    words = sharding.gather_shards(mesh, red, (None, "words"))
    return dev.to_host_u32(words), cards


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


def prefetch(bitmaps, op: str = "or", mode: Optional[str] = None, device=None):
    """Stage a working set's pack and device expansion on the overlap
    shipping lane (``overlap.LANE``): call with the NEXT query's operands
    while the current query reduces, and its dispatch finds the pack
    resident. The same dispatch prelude and device gate as the engines
    (AND key intersection, ``_use_device``), so only working sets that
    would take the device path stage. Returns the staging ticket, or None
    when nothing stages (CPU route, trivial AND, lane not threaded or its
    window full)."""
    bitmaps = [bitmaps] if hasattr(bitmaps, "high_low_container") else list(bitmaps)
    if len(bitmaps) < 2:
        return None
    keys, n = _dispatch_prelude(bitmaps, op)
    if keys is not None and not keys:
        return None  # trivial AND: nothing will pack
    if not _use_device(n, mode):
        return None
    from . import overlap

    return overlap.LANE.prefetch(
        bitmaps, keys, resolve_device(config.device if device is None else device)
    )


def _aggregate(
    bitmaps: Sequence[RoaringBitmap],
    op: str,
    mode: Optional[str] = None,
    device=None,
    pool: Optional[ThreadPoolExecutor] = None,
) -> RoaringBitmap:
    """N-way aggregation: the device tier alone, or the CPU chain, as
    ``_use_device`` decides, through the ladder. A failure of the device
    tier raises."""
    bitmaps = [b for b in bitmaps]
    if not bitmaps:
        return RoaringBitmap()
    if len(bitmaps) == 1:
        return bitmaps[0].clone()
    # inline sentinel pacing: a single-threaded serving loop gets health
    # supervision on the dispatch path; off (the default) it is one bool
    _sentinel.maybe_tick()
    with _context.trace_scope():
        keys, n = _dispatch_prelude(bitmaps, op)
        if keys is not None and not keys:
            return RoaringBitmap()
        if _use_device(n, mode):
            tiers = [("device", lambda: _device_aggregate(bitmaps, keys, op, device))]
        else:
            tiers = _cpu_tiers(bitmaps, keys, n, op, pool=pool)
        from .. import columnar

        # the measured fold gate the CPU-tier choice consulted
        return _run_tiers(bitmaps, op, mode, n, tiers, fold_gate=columnar.MODEL.fold_gate_rows())


def _aggregate_cardinality(bitmaps: List[RoaringBitmap], op: str, mode, device) -> int:
    """N-way cardinality. On the device path the group reduction's
    popcounts (one int per key group) are the only thing fetched — no
    [G, 2048] stream-back, no container rebuild; the sum is the answer
    because key groups partition the universe."""
    if not bitmaps:
        return 0
    if len(bitmaps) == 1:
        return bitmaps[0].get_cardinality()
    with _context.trace_scope():
        keys, n = _dispatch_prelude(bitmaps, op)
        if keys is not None and not keys:
            return 0
        if _use_device(n, mode):

            def _device_tier() -> int:
                packed = _device_pack(bitmaps, keys, device)
                if config.mesh is not None:  # the same mesh reduce as _device_aggregate
                    return int(_sharded_reduce(packed, op, cards_only=True)[1].sum())
                return int(store.reduce_packed_cardinality(packed, op=op).sum())

            tiers = [("device", _device_tier)]
        else:
            tiers = [
                (name, (lambda fn=fn: fn().get_cardinality()))
                for name, fn in _cpu_tiers(bitmaps, keys, n, op)
            ]
        return _run_tiers(bitmaps, op, mode, n, tiers, cardinality_only=True)


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
    def horizontal_or(*bitmaps: RoaringBitmap) -> RoaringBitmap:
        """Priority-queue merge of container cursors
        (FastAggregation.horizontal_or :183-230): a heap of (key, cursor)
        pairs; all same-key containers are folded, then re-compressed
        once."""
        return _horizontal(_flatten(bitmaps), "or")

    @staticmethod
    def horizontal_xor(*bitmaps: RoaringBitmap) -> RoaringBitmap:
        """Heap-ordered key merge with an XOR fold per group
        (FastAggregation.horizontal_xor :243)."""
        return _horizontal(_flatten(bitmaps), "xor")

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
    def priorityqueue_or(*bitmaps: RoaringBitmap) -> RoaringBitmap:
        """Repeatedly OR the two smallest bitmaps (by serialized size) —
        FastAggregation.priorityqueue_or (FastAggregation.java:675)."""
        import heapq

        bms = _flatten(bitmaps)
        if not bms:
            return RoaringBitmap()
        if len(bms) == 1:
            return bms[0].clone()
        heap = [(bm.get_size_in_bytes(), i, bm) for i, bm in enumerate(bms)]
        heapq.heapify(heap)
        seq = len(bms)
        while len(heap) > 1:
            _, _, a = heapq.heappop(heap)
            _, _, b = heapq.heappop(heap)
            m = RoaringBitmap.or_(a, b)
            heapq.heappush(heap, (m.get_size_in_bytes(), seq, m))
            seq += 1
        return heap[0][2]

    @staticmethod
    def workshy_and(*bitmaps: RoaringBitmap, mode: Optional[str] = None, device=None) -> RoaringBitmap:
        """Key-intersection-first AND (FastAggregation.workShyAnd :356-396):
        only containers whose key survives the key intersection are
        touched. The same engine as :meth:`and_`."""
        return _aggregate(_flatten(bitmaps), "and", mode, device)

    @staticmethod
    def andnot(
        first: RoaringBitmap, *rest: RoaringBitmap, mode: Optional[str] = None
    ) -> RoaringBitmap:
        """N-way difference ``first \\ (rest_1 | rest_2 | ...)`` — the
        reference's ``andNot`` extended the way ``or``/``and`` are. The
        query tier's n-way kernel (``query/kernels.andnot_nway``): one word
        fold per surviving key on the CPU, the subtrahends' grouped OR and
        the mask on the device (``config.device``)."""
        from ..query import kernels

        bms = _flatten((first,) + rest)
        if not bms:
            return RoaringBitmap()
        return kernels.andnot_nway(bms[0], *bms[1:], mode=mode)

    @staticmethod
    def andnot_cardinality(
        first: RoaringBitmap, *rest: RoaringBitmap, mode: Optional[str] = None
    ) -> int:
        """``|first \\ (rest_1 | ...)|`` — the device path fetches only
        per-group popcounts (FastAggregation.andNotCardinality analogue)."""
        from ..query import kernels

        bms = _flatten((first,) + rest)
        if not bms:
            return 0
        return kernels.andnot_nway_cardinality(bms[0], *bms[1:], mode=mode)

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


def _horizontal(bms: List[RoaringBitmap], op: str) -> RoaringBitmap:
    """The heap merge behind ``horizontal_or`` / ``horizontal_xor``: pop
    every cursor on the smallest key, fold that group's words, advance."""
    import heapq

    heap = []  # (key, bitmap_idx, container_idx)
    for bi, bm in enumerate(bms):
        if bm.high_low_container.size:
            heapq.heappush(heap, (bm.high_low_container.keys[0], bi, 0))
    out = RoaringBitmap()
    while heap:
        key, bi, ci = heapq.heappop(heap)
        group = []
        while True:
            hlc = bms[bi].high_low_container
            group.append(hlc.containers[ci])
            if ci + 1 < hlc.size:
                heapq.heappush(heap, (hlc.keys[ci + 1], bi, ci + 1))
            if not heap or heap[0][0] != key:
                break
            _, bi, ci = heapq.heappop(heap)
        # the reference's forms: an OR passes a lone container through, an
        # XOR re-compresses every group from its words
        c = group[0].clone() if len(group) == 1 and op == "or" else best_container_of_words(
            _fold_group_words(group, op)
        )
        if c.cardinality:
            out.high_low_container.append(key, c)
    return out


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
    def group_by_key(*bitmaps: RoaringBitmap) -> Dict[int, List[Container]]:
        """ParallelAggregation.groupByKey (ParallelAggregation.java:136)."""
        return store.group_by_key(_flatten(bitmaps))

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
