"""Bounded memoizing result cache for executed query nodes.

Keyed by ``(node uid, leaf fingerprints)``: the hash-consed DAG makes the
uid a structural identity (the same subexpression over the same bitmap
objects is the same node), and the fingerprint tuple
(``RoaringBitmap.fingerprint()``, models/roaring.py — bumped by every
mutator) pins the leaf *contents* at execution time. A repeated query over
unchanged bitmaps therefore short-circuits at every memoized interior node;
mutating any contributing leaf changes its fingerprint, the key misses, and
the stale entry ages out through the LRU bound — no explicit invalidation
hooks in the hot mutation paths.

LRU by entry count plus an optional byte budget (entries weighed by
``get_size_in_bytes()``). Thread-safe: one lock around the OrderedDict.
Hits, misses and evictions are per-instance ints (``stats()``); every
hit, miss, store and eviction also lands in the registry counter
``rb_tpu_query_cache_total{event}``.

Counterpart of ``roaringbitmap_tpu/query/cache.py``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Tuple

from .. import observe as _observe
from ..models.roaring import RoaringBitmap

_CACHE_TOTAL = _observe.counter(
    _observe.QUERY_CACHE_TOTAL,
    "Query result-cache events (hit | miss | store | evict)",
    ("event",),
)


class ResultCache:
    """LRU (node uid, leaf fingerprints) -> RoaringBitmap."""

    def __init__(self, max_entries: int = 256, max_bytes: Optional[int] = None):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.max_entries = int(max_entries)
        self.max_bytes = None if max_bytes is None else int(max_bytes)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, Tuple[RoaringBitmap, int]]" = OrderedDict()  # guarded-by: self._lock
        self._bytes = 0  # guarded-by: self._lock
        self.hits = 0  # guarded-by: self._lock
        self.misses = 0  # guarded-by: self._lock
        self.evictions = 0  # guarded-by: self._lock

    def get(self, key: tuple) -> Optional[RoaringBitmap]:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                _CACHE_TOTAL.inc(1, ("miss",))
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            _CACHE_TOTAL.inc(1, ("hit",))
            return entry[0]

    def put(self, key: tuple, value: RoaringBitmap) -> None:
        nbytes = value.get_size_in_bytes() if self.max_bytes is not None else 0
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[key] = (value, nbytes)
            self._bytes += nbytes
            _CACHE_TOTAL.inc(1, ("store",))
            while len(self._entries) > self.max_entries or (
                self.max_bytes is not None
                and self._bytes > self.max_bytes
                and len(self._entries) > 1
            ):
                _k, (_v, nb) = self._entries.popitem(last=False)
                self._bytes -= nb
                self.evictions += 1
                _CACHE_TOTAL.inc(1, ("evict",))

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    def stats(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "entries": len(self._entries),
                "bytes": self._bytes,
            }

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: tuple) -> bool:
        with self._lock:
            return key in self._entries


# the process-default cache exec.execute() memoizes into when the caller
# does not pass one (a serving process wants cross-request sharing)
DEFAULT_CACHE = ResultCache(max_entries=512)


def cache_key(node, leaf_fps: dict) -> tuple:
    """The memo key of one DAG node: its structural uid + the fingerprint
    of every leaf feeding it (``leaf_fps``: leaf uid -> fingerprint,
    computed once per execution so all steps see one consistent view)."""
    return (node.uid,) + tuple(leaf_fps[l.uid] for l in node.leaves)


def leaf_fps_current(node, leaf_fps: dict) -> bool:
    """Cross-query key validation: do the node's
    leaves STILL carry the snapshotted fingerprints? The executor reads
    live bitmaps, so a leaf mutated mid-computation leaves the computed
    value matching neither the key's snapshot nor the new contents (a
    torn read). Every publication — a ``cache.put`` and an in-flight
    completion alike — re-validates through this one helper and drops
    stale values instead of keying them under fingerprints they do not
    correspond to (the entry would otherwise be served to any concurrent
    joiner holding the pre-mutation key)."""
    return all(l.fingerprint() == leaf_fps[l.uid] for l in node.leaves)
