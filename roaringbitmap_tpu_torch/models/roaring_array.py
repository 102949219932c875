"""L2' key -> container index: sorted parallel arrays.

Mirrors RoaringArray.java:22 — parallel sorted ``keys`` (high-16-bit chunk
keys) and ``containers``. Host-side pure Python/bisect; tiny (at most 65536
entries) and never on the device hot path.

Mutation tracking: every mutator bumps ``_version`` (the substrate of
``RoaringBitmap.fingerprint()``) and *attributes* the mutation to its chunk
key in ``_key_versions`` — which is what lets a resident pack cache answer
"which containers changed since version v?" and re-pack only those rows
instead of the whole working set. Paths that
rebind state wholesale without per-key attribution (the deserialize refill
in serialization.py) call :meth:`mark_all_dirty`, after which
:meth:`dirty_keys_since` answers ``None`` (= unknown, do a full repack)
for any baseline predating the wholesale change.
"""

from __future__ import annotations

import itertools
from bisect import bisect_left
from typing import Dict, List, Optional, Set, Tuple

from .container import Container

# process-unique generation ids: a (gen, version) pair is a stable identity
# token for "this container array at this mutation count" that can never be
# confused with a different array reusing the same memory address — the
# substrate of RoaringBitmap.fingerprint(), the invalidation key of result caches
_GEN = itertools.count(1)


class RoaringArray:
    __slots__ = ("keys", "containers", "_gen", "_version", "_key_versions",
                 "_unattributed_version", "_fp", "_fp_ident")

    def __init__(self):
        self.keys: List[int] = []
        self.containers: List[Container] = []
        self._gen = next(_GEN)
        self._version = 0
        # chunk key -> version of its most recent attributed mutation
        self._key_versions: Dict[int, int] = {}
        # version of the most recent wholesale (key-less) mutation; dirty
        # queries with an older baseline cannot be answered incrementally
        self._unattributed_version = 0
        # cached fingerprint tuple + cache-identity tuple: every mutator
        # invalidates _fp (the version moved); _fp_ident depends only on
        # the generation, which is fixed at construction, so it never
        # invalidates.
        self._fp: "Optional[Tuple[int, int]]" = None
        self._fp_ident: "Optional[Tuple[str, int]]" = None

    @property
    def size(self) -> int:
        return len(self.keys)

    def get_index(self, key: int) -> int:
        """Index of key, or -(insertion_point)-1 if absent (RoaringArray.java:749)."""
        i = bisect_left(self.keys, key)
        if i < len(self.keys) and self.keys[i] == key:
            return i
        return -i - 1

    def get_container(self, key: int):
        i = self.get_index(key)
        return self.containers[i] if i >= 0 else None

    def get_container_at_index(self, i: int) -> Container:
        return self.containers[i]

    def get_key_at_index(self, i: int) -> int:
        return self.keys[i]

    def touch_key(self, key: int) -> None:
        """Record an attributed mutation of ``key``'s container — the hook
        for frame-flat hot paths that mutate ``containers[i]`` in place
        without going through a mutator method."""
        self._version += 1
        self._key_versions[key] = self._version
        self._fp = None

    def mark_all_dirty(self) -> None:
        """Record a wholesale mutation that cannot be attributed to
        specific keys (deserialize refill); incremental dirty queries with
        an older baseline will answer None (full repack)."""
        self._version += 1
        self._unattributed_version = self._version
        self._fp = None

    def wholesale_since(self, version: int) -> bool:
        """Did a wholesale (key-less) mutation land after ``version``?
        The O(1) pre-check that lets a delta validator skip the per-key
        dirty scan entirely when ``mark_all_dirty`` already forced a full
        repack."""
        return self._unattributed_version > int(version)

    def dirty_keys_since(self, version: int) -> Optional[Set[int]]:
        """Chunk keys whose containers were mutated after ``version``
        (touched, inserted, replaced, or removed), or ``None`` when the
        answer is unknowable — a wholesale mutation happened after
        ``version``, so the caller must treat everything as dirty."""
        if version >= self._version:
            return set()
        if self._unattributed_version > version:
            return None
        return {k for k, v in self._key_versions.items() if v > version}

    def set_container_at_index(self, i: int, c: Container) -> None:
        self.containers[i] = c
        self.touch_key(self.keys[i])

    def insert_new_key_value_at(self, i: int, key: int, c: Container) -> None:
        self.keys.insert(i, key)
        self.containers.insert(i, c)
        self.touch_key(key)

    def remove_at_index(self, i: int) -> None:
        key = self.keys[i]
        del self.keys[i]
        del self.containers[i]
        self.touch_key(key)

    def remove_index_range(self, begin: int, end: int) -> None:
        removed = self.keys[begin:end]
        del self.keys[begin:end]
        del self.containers[begin:end]
        for key in removed:
            self.touch_key(key)

    def append(self, key: int, c: Container) -> None:
        """Append-only construction path (RoaringArray.java:111); key must exceed all
        existing keys."""
        if self.keys and key <= self.keys[-1]:
            raise ValueError(f"append key {key} <= last key {self.keys[-1]}")
        self.keys.append(key)
        self.containers.append(c)
        self.touch_key(key)

    def advance_until(self, key: int, pos: int) -> int:
        """First index > pos with keys[index] >= key (RoaringArray.java:64)."""
        return bisect_left(self.keys, key, lo=pos + 1)

    def clone(self) -> "RoaringArray":
        """Deep copy under a FRESH ``(gen, version=0)`` identity — and that
        is correct, not an oversight: generations are process-unique
        (``_GEN``), so the clone's fingerprints ``(child_gen, ·)`` can never
        equal the parent's ``(parent_gen, ·)``. Mutating the clone therefore
        cannot invalidate the parent's cached packs or query results, and
        the clone can never be served an entry packed from the parent.
        Routing the copy through the versioned mutators would
        only burn O(keys) dict stores to arrive at the same guarantee."""
        out = RoaringArray()
        out.keys = list(self.keys)
        out.containers = [c.clone() for c in self.containers]
        return out

    def items(self) -> List[Tuple[int, Container]]:
        return list(zip(self.keys, self.containers))

    def __eq__(self, other):
        if not isinstance(other, RoaringArray):
            return NotImplemented
        return self.keys == other.keys and all(
            a == b for a, b in zip(self.containers, other.containers)
        )
