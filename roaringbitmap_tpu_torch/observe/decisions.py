"""Decision provenance: a bounded in-memory log of every choice the
pipeline makes.

Counterpart of ``roaringbitmap_tpu/observe/decisions.py``. The planner
picks an engine per node, the aggregation picks a start tier, the ladder
trips breakers, the pack cache spills; every such site calls
:func:`record_decision` with the decision **and the inputs that drove
it**, landing in one bounded ring (``insights.decisions()`` is the read
API) and — when a timeline mode is active — mirroring onto the flight
recorder as a ``decision.<site>`` instant, on the thread and under the
trace id that made it.

Entry shape (plain dicts, json-dumpable)::

    {"ts_ns": ..., "seq": 17, "site": "query.plan", "decision": "device-or",
     "trace": "q00002a", "inputs": {"op": "or", "est_rows": 308211}}

Bounds & cost: the ring holds ``RB_TPU_DECISIONS_CAPACITY`` entries
(default 512) under a leaf lock — recording is a deque append plus one
labeled counter bump (``rb_tpu_decision_total{site}``). Hot per-pair
sites (the columnar cutoff) record fully above the count gate, where the
op itself costs tens of microseconds; below it a 1-in-N
:class:`SampledSite` record keeps the zone visible to the cost model's
calibration data. ``configure(enabled=False)`` is the kill switch.

Trace ids, fingerprints, and other unbounded values belong in the entry
payload — never in metric labels.

Lock discipline: the log lock is a leaf — record() takes it only around
the deque append, so decision sites inside other locks (the pack-cache
evictor) nest safely.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from . import context as _context
from . import outcomes as _outcomes
from . import registry as _registry
from . import timeline as _timeline

DEFAULT_CAPACITY = 512

_DECISION_TOTAL = _registry.counter(
    _registry.DECISION_TOTAL,
    "Decisions recorded into the provenance log by deciding site",
    ("site",),
)

_ENABLED = True


class DecisionLog:
    """Thread-safe bounded ring of decision entries (newest last)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._lock = threading.Lock()  # leaf: guards the deque only
        self._ring: "deque[dict]" = deque(maxlen=int(capacity))  # guarded-by: self._lock
        self._total = 0  # guarded-by: self._lock

    @property
    def capacity(self) -> int:
        return self._ring.maxlen

    def record(self, entry: dict) -> None:
        with self._lock:
            self._ring.append(entry)
            self._total += 1

    def tail(self, n: Optional[int] = None) -> List[dict]:
        """The newest ``n`` entries (all retained when None), oldest
        first — point-in-time copies, safe to mutate."""
        with self._lock:
            entries = list(self._ring)
        if n is not None:
            entries = entries[-int(n):] if n > 0 else []
        return [dict(e) for e in entries]

    def total(self) -> int:
        """Decisions ever recorded (retained + overwritten)."""
        with self._lock:
            return self._total

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._total = 0

    def resize(self, capacity: int) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        with self._lock:
            self._ring = deque(self._ring, maxlen=int(capacity))


def _init_capacity() -> int:
    raw = os.environ.get("RB_TPU_DECISIONS_CAPACITY")
    try:
        return max(1, int(raw)) if raw else DEFAULT_CAPACITY
    except ValueError:
        return DEFAULT_CAPACITY


# The process-wide log every decision site records into.
LOG = DecisionLog(_init_capacity())


def configure(
    enabled: Optional[bool] = None, capacity: Optional[int] = None
) -> None:
    """Runtime overrides: ``enabled=False`` is the kill switch (recording
    reduces to one bool check); ``capacity`` re-bounds the ring keeping the
    newest entries."""
    global _ENABLED
    if enabled is not None:
        _ENABLED = bool(enabled)
    if capacity is not None:
        LOG.resize(capacity)


def enabled() -> bool:
    return _ENABLED


# process-unique decision serials (itertools.count.__next__ is atomic
# under the GIL): the outcome join key — a serial + the trace
# id identifies one verdict across the decision log, the pending outcome
# ledger, and the flight-recorder span attrs it gets threaded into
_SEQ = itertools.count(1)


def record_decision(
    site: str, decision: str, /, outcome: bool = False, **inputs
) -> Optional[int]:
    """Record one decision: what was chosen at ``site`` and the inputs
    that drove the choice. Also bumps ``rb_tpu_decision_total{site}`` and
    mirrors a ``decision.<site>`` flight-recorder instant when a timeline
    mode is active (the instant carries the ambient trace id).

    Returns the decision's process-unique serial (``entry["seq"]``).
    ``outcome=True`` additionally parks the decision in the outcome
    ledger's pending ring — the site promises to resolve it
    with the measured execution (``outcomes.resolve``/``measure``), and
    the returned serial is the join key to thread into the measured
    span's attrs. Sites whose verdicts have no measurable execution
    (breaker flips, admits) record as before and stay out of the pending
    ring. Returns None when recording is disabled."""
    if not _ENABLED:
        return None
    seq = next(_SEQ)
    trace = _context.current_trace()
    entry: Dict = {
        "ts_ns": time.perf_counter_ns(),
        "seq": seq,
        "site": site,
        "decision": decision,
        "trace": trace,
    }
    if inputs:
        entry["inputs"] = inputs
    LOG.record(entry)
    _DECISION_TOTAL.inc(1, (site,))
    if outcome:
        _outcomes.register(seq, site, inputs, trace)
    if _timeline.enabled():
        _timeline.instant(
            "decision." + site, "decision", decision=decision, seq=seq,
            **inputs
        )
    return seq


def decisions(n: Optional[int] = None) -> List[dict]:
    """The decision-log tail (newest ``n``, oldest first)."""
    return LOG.tail(n)


class SampledSite:
    """1-in-N sampling gate for decision sites too hot to record every
    verdict (the columnar cutoff's below-gate branch sits at the ~2 µs
    per-container floor). ``tick()`` costs one int increment and a mask
    compare; every ``every``-th call returns True and the caller records
    one representative entry, tagged with the sampling factor so
    consumers can re-weight.

    The counter is deliberately lock-free: a racing increment can at
    worst skip or double one sample — sampling noise, not data loss."""

    __slots__ = ("every", "_mask", "_n")

    def __init__(self, every: int = 64):
        every = max(1, int(every))
        if every & (every - 1):
            raise ValueError(f"sampling factor must be a power of two, got {every}")
        self.every = every
        self._mask = every - 1
        self._n = 0

    def tick(self) -> bool:
        n = self._n + 1
        self._n = n
        return not (n & self._mask)
