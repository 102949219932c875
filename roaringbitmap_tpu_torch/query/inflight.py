"""Global in-flight table: cross-query dedup of *pending* node results.

Counterpart of ``roaringbitmap_tpu/query/inflight.py``. The result cache
(cache.py) dedups *completed* work; this table adds a pending tier: the
first executor to reach a node key becomes the **owner** and computes; any
executor reaching the same key mid-flight becomes a **joiner** and blocks
on the owner's completion instead of recomputing (:meth:`InflightTable.join`;
the fused executor, which holds claims of its own, only polls:
:meth:`InflightTable.poll`). Keys are the result
cache's own ``(node uid, leaf fingerprints)``.

**The dedup contract**: a published value must correspond to the leaf
fingerprints in its key. The executor reads *live* leaf bitmaps, so a leaf
mutated mid-computation can leave the owner holding bits that match
neither the old nor the new fingerprint. Publication is therefore
validated: the owner re-fingerprints the node's leaves at completion and
publishes only when they still equal the key's snapshot; a stale
completion counts ``stale``, hands joiners ``None`` (recompute against
fresh contents), and never reaches the cache. An owner that raises aborts
the entry the same way: joiners recompute rather than inherit the
exception.

Bounds: one leaf lock around a plain dict; entries exist only while a
computation is in flight, so the table is bounded by executor concurrency.
Joiner waits carry a timeout (default 30 s): a wedged owner sends the
joiner back to computing the node itself, never into a deadlock.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

# a joiner never waits forever on a wedged owner: past this it recomputes
DEFAULT_JOIN_TIMEOUT_S = 30.0


class _Entry:
    __slots__ = ("event", "value", "valid")

    def __init__(self):
        self.event = threading.Event()
        self.value = None
        self.valid = False


class InflightTable:
    """Thread-safe pending-computation table keyed like the result cache."""

    def __init__(self, join_timeout_s: float = DEFAULT_JOIN_TIMEOUT_S):
        self.join_timeout_s = float(join_timeout_s)
        self._lock = threading.Lock()  # leaf: guards the dict only
        self._pending: dict = {}  # guarded-by: self._lock
        self.leads = 0  # guarded-by: self._lock
        self.joins = 0  # guarded-by: self._lock
        self.stale = 0  # guarded-by: self._lock

    def begin(self, key: tuple) -> Tuple[bool, Optional[_Entry]]:
        """Claim ``key``: ``(True, entry)`` makes the caller the owner
        (it MUST later call :meth:`complete` or :meth:`abort` on the
        entry); ``(False, entry)`` means another executor owns it — wait
        via :meth:`join`."""
        with self._lock:
            entry = self._pending.get(key)
            if entry is not None:
                self.joins += 1
                owner = False
            else:
                entry = self._pending[key] = _Entry()
                self.leads += 1
                owner = True
        return owner, entry

    def complete(self, key: tuple, entry: _Entry, value, valid: bool) -> None:
        """Owner publication. ``valid=False`` is the stale-fingerprint
        path: joiners wake to ``None`` and recompute — mid-mutation bits
        are never shared across queries."""
        entry.value = value if valid else None
        entry.valid = valid
        if not valid:
            with self._lock:
                self.stale += 1
        self._remove(key, entry)
        entry.event.set()

    def abort(self, key: tuple, entry: _Entry) -> None:
        """Owner failure: wake joiners empty-handed (they recompute —
        inheriting the owner's exception would couple unrelated queries'
        failures)."""
        self._remove(key, entry)
        entry.event.set()

    def join(self, entry: _Entry):
        """Block until the owner publishes; returns the validated value or
        ``None`` (stale / failed / timed out — recompute). Only callers
        holding NO unpublished claims of their own may block here (the
        serial executor's claim→compute→publish loop) — a claim-holding
        blocker could stall another executor's join on ITS claim."""
        if not entry.event.wait(self.join_timeout_s):
            return None
        return entry.value if entry.valid else None

    def poll(self, entry: _Entry):
        """Non-blocking join: the already-published validated value, or
        ``None`` (still computing / stale / failed — compute it yourself).
        The fused executor's form: it claims a whole merged group before
        publishing any of it, so a BLOCKING join there could mutually
        stall two windows claiming shared nodes in opposite orders."""
        if not entry.event.is_set():
            return None
        return entry.value if entry.valid else None

    def _remove(self, key: tuple, entry: _Entry) -> None:
        with self._lock:
            if self._pending.get(key) is entry:
                del self._pending[key]

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    def stats(self) -> dict:
        with self._lock:
            return {
                "leads": self.leads,
                "joins": self.joins,
                "stale": self.stale,
                "pending": len(self._pending),
            }

    def clear(self) -> None:
        """Tests only: wake anything parked and drop all entries."""
        with self._lock:
            entries = list(self._pending.values())
            self._pending.clear()
        for e in entries:
            e.event.set()


# The process-wide table: every executor dedups through this one
# instance, which is what makes the dedup cross-query.
TABLE = InflightTable()
