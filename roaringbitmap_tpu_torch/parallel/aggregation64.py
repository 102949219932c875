"""64-bit N-way aggregation: the grouped reduce extended to the 64-bit
bitmaps.

Counterpart of the JAX package's ``parallel/aggregation64.py``. The
reference aggregates 64-bit bitmaps only pairwise/naively
(Roaring64NavigableMap.java:730 ``naivelazyor`` fold; no 64-bit
FastAggregation exists). Here the engine that serves the 32-bit layer
applies unchanged: the containers of all inputs are transposed into
key-major groups — high-48 chunk keys for ``Roaring64Bitmap``, ``(bucket
<< 16) | chunk`` for ``Roaring64NavigableMap`` — packed by
``store.pack_groups`` into one int32 ``[N, 2048]`` row block on the card
(``rb_expand_rows``) and reduced per key group in one dispatch
(``rb_group_reduce`` + ``rb_popcount_rows``, ops/kernels.py). Key width
only changes the host-side directory: ``PackedGroups.group_keys`` is
int64.

``mode`` is ``'auto'`` | ``'cpu'`` | ``'device'`` as in
``parallel/aggregation.py`` (auto decides by working-set size only); the
device path runs on ``device`` (default ``aggregation.config.device``,
``"cuda"``), and ``"cuda"`` without a card raises ``TierUnavailable``.
As in the JAX package the 64-bit packs are not kept in the resident pack
cache: every device call packs its working set anew. CPU mode folds per
key group with the shared word folds, so the two engines cross-check each
other.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from ..device import resolve_device
from ..models.container import Container, best_container_of_words
from ..models.roaring64 import Roaring64NavigableMap
from ..models.roaring64art import Roaring64Bitmap, key_to_int
from . import aggregation, store
from .aggregation import _fold_group_words, _use_device


def _group_by_key64(
    bitmaps: Sequence[Roaring64Bitmap], keys_filter: Optional[set] = None
) -> Dict[int, List[Container]]:
    """Transpose inputs into high-48-key-major groups (the 64-bit
    ParallelAggregation.groupByKey analogue; keys become ints so the
    shared packing path applies). ``keys_filter`` keeps the workShy AND
    from gathering containers outside the key intersection."""
    groups: Dict[int, List[Container]] = {}
    for bm in bitmaps:
        for key, c in bm._kv():
            k = key_to_int(key)
            if keys_filter is not None and k not in keys_filter:
                continue
            groups.setdefault(k, []).append(c)
    return groups


def _device_for(device):
    return resolve_device(aggregation.config.device if device is None else device)


def _reduce_to_pairs(groups, op: str, mode: Optional[str], device=None):
    """Reduce key groups to sorted ``(key, Container)`` pairs on the shared
    CPU/device engines; key composition is the caller's concern (48-bit
    chunk keys for the ART design, (bucket << 16) | chunk for the
    NavigableMap), so every 64-bit aggregation is ONE dispatch regardless
    of how many buckets it spans."""
    if not groups:
        return []
    n = sum(len(v) for v in groups.values())
    if _use_device(n, mode):
        packed = store.pack_groups(groups, _device_for(device))
        words, cards = store.reduce_packed(packed, op=op)
        return list(store.iter_group_containers(packed.group_keys, words, cards))
    out = []
    for key in sorted(groups):
        cs = groups[key]
        c = cs[0].clone() if len(cs) == 1 else best_container_of_words(
            _fold_group_words(cs, op)
        )
        if c.cardinality:
            out.append((key, c))
    return out


class FastAggregation64:
    """N-way or/xor/and over ``Roaring64Bitmap`` inputs with the shared
    CPU/device dispatcher (``mode``: 'auto' | 'cpu' | 'device')."""

    @staticmethod
    def or_(*bitmaps: Roaring64Bitmap, mode: Optional[str] = None, device=None) -> Roaring64Bitmap:
        return _aggregate64(bitmaps, "or", mode, device)

    @staticmethod
    def xor(*bitmaps: Roaring64Bitmap, mode: Optional[str] = None, device=None) -> Roaring64Bitmap:
        return _aggregate64(bitmaps, "xor", mode, device)

    @staticmethod
    def and_(*bitmaps: Roaring64Bitmap, mode: Optional[str] = None, device=None) -> Roaring64Bitmap:
        """workShy AND: intersect the key sets first, then reduce only the
        surviving groups (Util.intersectKeys / workShyAnd analogue; every
        surviving key appears in all inputs, so the filtered grouping is
        exactly the AND work set)."""
        return _aggregate64(bitmaps, "and", mode, device)

    @staticmethod
    def or_cardinality(*bitmaps: Roaring64Bitmap, mode: Optional[str] = None, device=None) -> int:
        return _aggregate64_cardinality(bitmaps, "or", mode, device)

    @staticmethod
    def xor_cardinality(*bitmaps: Roaring64Bitmap, mode: Optional[str] = None, device=None) -> int:
        return _aggregate64_cardinality(bitmaps, "xor", mode, device)

    @staticmethod
    def and_cardinality(*bitmaps: Roaring64Bitmap, mode: Optional[str] = None, device=None) -> int:
        return _aggregate64_cardinality(bitmaps, "and", mode, device)


def or_navigable(*maps, mode: Optional[str] = None, device=None):
    """N-way OR over ``Roaring64NavigableMap`` inputs: every (high-32
    bucket, chunk-key) pair becomes one composed group key, so the whole
    map set reduces in a single engine dispatch no matter how many buckets
    it spans; results reassemble bucket-wise through the append path.
    Output config (signed order, bucket supplier) follows the first
    operand, like the reference's instance or()."""
    ms: List[Roaring64NavigableMap] = (
        list(maps[0])
        if len(maps) == 1 and not isinstance(maps[0], Roaring64NavigableMap)
        else list(maps)
    )
    if not ms:
        return Roaring64NavigableMap()
    out = Roaring64NavigableMap(
        signed_longs=ms[0].signed_longs, supplier=ms[0].supplier
    )
    groups: Dict[int, List[Container]] = {}
    for m in ms:
        for hb, bm in m._buckets.items():
            hlc = bm.high_low_container
            for k, c in zip(hlc.keys, hlc.containers):
                groups.setdefault((hb << 16) | k, []).append(c)
    for gkey, c in _reduce_to_pairs(groups, "or", mode, device):
        hb, chunk = gkey >> 16, gkey & 0xFFFF
        bucket = out._buckets.get(hb)
        if bucket is None:
            bucket = out.supplier()
            out._buckets[hb] = bucket
        bucket.high_low_container.append(chunk, c)
    out._keys_dirty = True
    return out


def _flatten64(bitmaps) -> List[Roaring64Bitmap]:
    if len(bitmaps) == 1 and not isinstance(bitmaps[0], Roaring64Bitmap):
        return list(bitmaps[0])
    return list(bitmaps)


def _aggregate64(bitmaps, op: str, mode: Optional[str], device) -> Roaring64Bitmap:
    bms = _flatten64(bitmaps)
    if not bms:
        return Roaring64Bitmap()
    if len(bms) == 1:
        return bms[0].clone()
    prepared = _prepare_groups64(bms, op)
    if prepared is None:
        return Roaring64Bitmap()
    out = Roaring64Bitmap()
    for key, c in _reduce_to_pairs(prepared[0], op, mode, device):
        out._put(int(key).to_bytes(6, "big"), c)
    return out


def _workshy_keys(bms) -> set:
    """Intersect the high-48 key sets (Util.intersectKeys analogue); the
    shared workShy-AND prelude for the materializing and cardinality-only
    engines. Empty set = trivially empty result."""
    keys = set(key_to_int(k) for k, _ in bms[0]._kv())
    for bm in bms[1:]:
        keys &= set(key_to_int(k) for k, _ in bm._kv())
        if not keys:
            return set()
    return keys


def _prepare_groups64(bms, op: str):
    """Shared grouping prelude: AND goes through the key intersection;
    returns (groups, n_rows) or None when the result is trivially
    empty."""
    if op == "and":
        keys = _workshy_keys(bms)
        if not keys:
            return None
        groups = _group_by_key64(bms, keys_filter=keys)
    else:
        groups = _group_by_key64(bms)
    return groups, sum(len(v) for v in groups.values())


def _aggregate64_cardinality(bitmaps, op: str, mode: Optional[str], device) -> int:
    """64-bit twin of aggregation._aggregate_cardinality: on the device
    path only the per-group popcounts come back (key groups partition the
    64-bit universe, so their sum is the aggregate cardinality)."""
    bms = _flatten64(bitmaps)
    if not bms:
        return 0
    if len(bms) == 1:
        return bms[0].get_cardinality()
    prepared = _prepare_groups64(bms, op)
    if prepared is None:
        return 0
    groups, n = prepared
    if _use_device(n, mode):
        packed = store.pack_groups(groups, _device_for(device))
        return int(store.reduce_packed_cardinality(packed, op=op).sum())
    return sum(c.cardinality for _, c in _reduce_to_pairs(groups, op, "cpu"))
