"""Dynamic lock-order witness — the runtime complement of the static
lock-discipline rule.

The static pass (rules/locks.py) proves guarded state is written under its
lock; it cannot prove the *order* locks nest in is consistent. A deadlock
needs a cycle: thread 1 holds A wanting B while thread 2 holds B wanting A.
This witness wraps the framework's locks during a test, records every
"acquired Y while holding X" edge into a directed graph, and fails on any
cycle — an inconsistent ordering that could deadlock under the right
interleaving even if the test run itself got lucky.

Usage (tests/test_observe.py, tests/test_query_cache.py)::

    w = LockWitness()
    cache._lock = w.wrap("cache", cache._lock)
    registry_lock = w.wrap("registry", observe.REGISTRY._lock)
    ...patch every reference to the wrapped object...
    <run the thread hammer>
    w.assert_consistent()          # raises LockOrderError on a cycle
    assert ("cache", "registry") in w.edges   # the nesting was exercised

Wrapped locks proxy ``acquire``/``release``/context-manager onto the inner
lock (plain Lock or RLock); the edge graph and per-thread held stacks live
behind the witness's own private lock, which is a leaf — it is never held
while acquiring an instrumented lock, so the witness cannot introduce an
ordering of its own.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set, Tuple


class LockOrderError(AssertionError):
    """Inconsistent lock-acquisition ordering (potential deadlock cycle)."""


class WitnessedLock:
    """Proxy over a Lock/RLock that reports acquisitions to the witness."""

    def __init__(self, name: str, inner, witness: "LockWitness"):
        self.name = name
        self._inner = inner
        self._witness = witness

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._witness._note_acquire(self.name)
        return got

    def release(self) -> None:
        self._witness._note_release(self.name)
        self._inner.release()

    def __enter__(self) -> "WitnessedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<WitnessedLock {self.name} over {self._inner!r}>"


class LockWitness:
    """Records the acquisition-order graph across a set of named locks."""

    def __init__(self) -> None:
        self._mu = threading.Lock()  # leaf lock: guards edges only
        self._held = threading.local()  # per-thread stack of held names
        self.edges: Set[Tuple[str, str]] = set()  # guarded-by: _mu
        self.acquisitions: Dict[str, int] = {}  # guarded-by: _mu

    def wrap(self, name: str, lock) -> WitnessedLock:
        return WitnessedLock(name, lock, self)

    def _stack(self) -> List[str]:
        st = getattr(self._held, "stack", None)
        if st is None:
            st = self._held.stack = []
        return st

    def _note_acquire(self, name: str) -> None:
        st = self._stack()
        new_edges = [(h, name) for h in st if h != name]
        st.append(name)
        with self._mu:
            self.acquisitions[name] = self.acquisitions.get(name, 0) + 1
            self.edges.update(new_edges)

    def _note_release(self, name: str) -> None:
        st = self._stack()
        # remove the innermost matching hold (reentrant locks release LIFO)
        for i in range(len(st) - 1, -1, -1):
            if st[i] == name:
                del st[i]
                break

    # -- analysis ---------------------------------------------------------

    def find_cycle(self) -> Optional[List[str]]:
        """A lock-name cycle in the order graph, or None."""
        with self._mu:
            graph: Dict[str, Set[str]] = {}
            for a, b in self.edges:
                graph.setdefault(a, set()).add(b)
        WHITE, GRAY, BLACK = 0, 1, 2
        color = {n: WHITE for n in graph}
        path: List[str] = []

        def dfs(n: str) -> Optional[List[str]]:
            color[n] = GRAY
            path.append(n)
            for m in sorted(graph.get(n, ())):
                c = color.get(m, WHITE)
                if c == GRAY:
                    return path[path.index(m) :] + [m]
                if c == WHITE:
                    color.setdefault(m, WHITE)
                    cyc = dfs(m)
                    if cyc:
                        return cyc
            color[n] = BLACK
            path.pop()
            return None

        for n in sorted(graph):
            if color.get(n, WHITE) == WHITE:
                cyc = dfs(n)
                if cyc:
                    return cyc
        return None

    def assert_consistent(self) -> None:
        """Raise LockOrderError if any inconsistent ordering was observed."""
        cyc = self.find_cycle()
        if cyc:
            with self._mu:
                witnessed = sorted(self.edges)
            raise LockOrderError(
                f"inconsistent lock acquisition order (potential deadlock): "
                f"cycle {' -> '.join(cyc)}; witnessed edges {witnessed}"
            )
