"""Structure observatory: corpus-shape telemetry over the live working
sets.

Counterpart of ``roaringbitmap_tpu/observe/structure.py``. The delta path
patches containers in place and never revisits format choice, so
sustained writes drift arrays past the 4096 threshold, fragment runs and
accrete epoch deltas. This module is the seeing half: a cheap incremental
ledger over watched ``RoaringArray`` working sets exporting four
corpus-shape gauges:

* ``rb_tpu_structure_containers{format}`` — live container census by
  declared format (``FORMATS``: array | bitmap | run);
* ``rb_tpu_structure_drift_ratio`` — actual serialized bytes over the
  size-rule-optimal bytes (what ``run_optimize`` would pick per
  container, Container.java:882); 1.0 = every container already in its
  cheapest format;
* ``rb_tpu_structure_fragmentation_count`` — p99 runs per run container;
* ``rb_tpu_structure_accretion_count`` — epoch-delta accretion depth:
  flip batches folded into the corpus since the last maintenance pass.

**Cost**: the ledger rides the per-key dirty tracking the mutators
already pay for (``RoaringArray.touch_key`` / ``dirty_keys_since``, the
pack cache's substrate), so the hot path stays O(1): no mutator hook, no
per-write scan. :meth:`refresh` re-measures only the keys dirtied since
its last baseline; the per-format census, byte totals and the
runs-per-run-container histogram are kept as incremental deltas against
the per-key cache. The one full walk is :meth:`census` under a
``structure.census`` timeline span, which rebuilds the books from
scratch.

:meth:`drift_targets` lists the keys whose actual serialized size exceeds
the size-rule optimum — the rewrite set of a maintenance pass
(``serve/maintain.py``); ``insights.structure`` reads the books.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from . import registry as _registry
from . import timeline as _timeline

# the declared frozen container-format set (Chambi et al.; the
# metric-naming rule requires census label values to resolve through
# this mapping — FORMATS[fmt] — so a future or typo'd Container.TYPE
# can never mint a series)
FORMATS = {"array": "array", "bitmap": "bitmap", "run": "run"}

_CONTAINERS = _registry.gauge(
    _registry.STRUCTURE_CONTAINERS,
    "Live containers across watched working sets by declared format",
    ("format",),
)
_DRIFT_RATIO = _registry.gauge(
    _registry.STRUCTURE_DRIFT_RATIO,
    "Actual serialized bytes over size-rule-optimal bytes across watched "
    "working sets (1.0 = every container in its cheapest format)",
)
_FRAGMENTATION_COUNT = _registry.gauge(
    _registry.STRUCTURE_FRAGMENTATION_COUNT,
    "p99 runs per run container across watched working sets",
)
_ACCRETION_COUNT = _registry.gauge(
    _registry.STRUCTURE_ACCRETION_COUNT,
    "Epoch-delta accretion depth: flip batches folded into the corpus "
    "since the last maintenance pass",
)
_BYTES = _registry.gauge(
    _registry.STRUCTURE_BYTES,
    "Serialized bytes across watched working sets (actual vs size-rule "
    "optimal)",
    ("kind",),
)


def _measure(container) -> Tuple[str, int, int, int]:
    """(format, actual_bytes, optimal_bytes, nruns) for one container —
    the size rule run_optimize applies (Container.java:882): optimal is
    the cheaper of the run form and the efficient non-run form."""
    card = container.cardinality
    nruns = container.num_runs()
    run_size = 2 + 4 * nruns
    flat_size = 8192 if card > 4096 else 2 + 2 * card
    return (
        container.TYPE,
        int(container.serialized_size()),
        int(min(run_size, flat_size)),
        int(nruns),
    )


class _Row:
    """Per-bitmap incremental books: a dirty-tracking baseline plus the
    per-key measurements the aggregates are deltas of. ``gen`` pins the
    baseline to ONE RoaringArray identity — wholesale operators (|=, &=)
    rebind ``bm.high_low_container`` to a fresh array whose version
    counter restarts, so a generation change means the baseline is
    meaningless and the row rescans (the fingerprint contract)."""

    __slots__ = ("bm", "baseline", "gen", "per_key")

    def __init__(self, bm):
        self.bm = bm
        self.baseline = -1  # everything dirty on first refresh
        self.gen = -1
        self.per_key: Dict[int, Tuple[str, int, int, int]] = {}


class StructureLedger:
    """Thread-safe incremental structure books over named working sets.
    The lock is a leaf: refresh measures containers outside any other
    framework lock, and gauge exports go through the registry's own."""

    def __init__(self):
        self._lock = threading.Lock()
        self._sets: Dict[str, List[_Row]] = {}  # guarded-by: self._lock
        # incremental aggregates (guarded-by: self._lock)
        self._counts: Dict[str, int] = {f: 0 for f in FORMATS}
        self._actual_bytes = 0
        self._optimal_bytes = 0
        self._run_hist: Dict[int, int] = {}  # nruns -> run-container count
        self._accretion = 0

    # -- registration --------------------------------------------------------

    def watch(self, name: str, bitmaps) -> None:
        """(Re)register a named working set (a list of RoaringBitmap).
        The initial measurement lands on the next :meth:`refresh` —
        watch itself is O(set size) bookkeeping, no container walk."""
        rows = [_Row(bm) for bm in bitmaps]
        with self._lock:
            old = self._sets.pop(name, None)
            if old is not None:
                for row in old:
                    self._retire_row(row)
            self._sets[name] = rows

    def forget(self, name: str) -> None:
        with self._lock:
            rows = self._sets.pop(name, None)
            if rows is not None:
                for row in rows:
                    self._retire_row(row)
        self._export()

    def watched(self) -> List[str]:
        with self._lock:
            return sorted(self._sets)

    # -- accretion depth (epoch ledger hook) ---------------------------------

    def accrete(self, batches: int = 1) -> None:
        """An epoch flip folded ``batches`` delta batches into the
        corpus — called from the publish stage (serve/epochs.py).
        Accretion depth is defined over WATCHED working sets (the docs
        above: batches folded since the last maintenance pass); with
        nothing watched there is no maintenance tier to settle it, so
        unwatched stores must not pump the delta-accretion rule."""
        with self._lock:
            if not self._sets:
                return
            self._accretion += max(0, int(batches))
            depth = self._accretion
        _ACCRETION_COUNT.set(depth)

    def settle_accretion(self) -> None:
        """A maintenance pass merged the accumulated deltas — depth
        back to zero (serve/maintain.py)."""
        with self._lock:
            self._accretion = 0
        _ACCRETION_COUNT.set(0)

    # -- incremental refresh -------------------------------------------------

    def refresh(self) -> dict:
        """Re-measure only the keys dirtied since the last refresh
        (O(dirty), the sentinel-tick cadence), fold the deltas into the
        aggregate books, export the gauges, and return the stats view."""
        refreshed = 0
        with self._lock:
            for rows in self._sets.values():
                for row in rows:
                    refreshed += self._refresh_row(row)
        self._export()
        return self.stats(dirty_refreshed=refreshed)

    def _refresh_row(self, row: _Row) -> int:
        hlc = row.bm.high_low_container
        version = hlc._version
        gen = hlc._gen
        dirty = (
            hlc.dirty_keys_since(row.baseline)
            if row.baseline >= 0 and gen == row.gen else None
        )
        if dirty is None:
            # wholesale mutation (or first sight): re-measure every key
            for key in list(row.per_key):
                self._drop_key(row, key)
            dirty = set(hlc.keys)
        row.baseline = version
        row.gen = gen
        n = 0
        for key in dirty:
            self._drop_key(row, key)
            c = hlc.get_container(key)
            if c is None:
                continue  # key removed since baseline
            m = _measure(c)
            row.per_key[key] = m
            self._credit(m, +1)
            n += 1
        return n

    def _drop_key(self, row: _Row, key: int) -> None:
        m = row.per_key.pop(key, None)
        if m is not None:
            self._credit(m, -1)

    def _retire_row(self, row: _Row) -> None:
        for m in row.per_key.values():
            self._credit(m, -1)
        row.per_key.clear()

    def _credit(self, m: Tuple[str, int, int, int], sign: int) -> None:
        fmt, actual, optimal, nruns = m
        if fmt in self._counts:
            self._counts[fmt] += sign
        self._actual_bytes += sign * actual
        self._optimal_bytes += sign * optimal
        if fmt == "run":
            new = self._run_hist.get(nruns, 0) + sign
            if new > 0:
                self._run_hist[nruns] = new
            else:
                self._run_hist.pop(nruns, None)

    # -- the slow full audit -------------------------------------------------

    def census(self) -> dict:
        """Full-corpus audit: rebuild every row's books from scratch
        under a ``structure.census`` timeline span, healing any
        incremental bookkeeping drift, then export and return stats."""
        with self._lock:
            sets = {name: list(rows) for name, rows in self._sets.items()}
        total = sum(len(rows) for rows in sets.values())
        with _timeline.tspan("structure.census", "structure", bitmaps=total):
            with self._lock:
                for rows in self._sets.values():
                    for row in rows:
                        self._retire_row(row)
                        row.baseline = -1
                refreshed = sum(
                    self._refresh_row(row)
                    for rows in self._sets.values()
                    for row in rows
                )
        self._export()
        return self.stats(dirty_refreshed=refreshed)

    # -- maintenance feed ----------------------------------------------------

    def drift_targets(self) -> List[Tuple[object, int, int]]:
        """[(bitmap, key, excess_bytes)] for every watched key whose
        actual serialized size exceeds the size-rule optimum — exactly
        the rewrite set a maintenance pass should touch (as of the last
        refresh; the pass re-checks under its own epoch brackets)."""
        out: List[Tuple[object, int, int]] = []
        with self._lock:
            for rows in self._sets.values():
                for row in rows:
                    for key, (fmt, actual, optimal, _n) in row.per_key.items():
                        if actual > optimal:
                            out.append((row.bm, key, actual - optimal))
        return out

    # -- views ---------------------------------------------------------------

    def stats(self, dirty_refreshed: Optional[int] = None) -> dict:
        with self._lock:
            counts = dict(self._counts)
            actual = self._actual_bytes
            optimal = self._optimal_bytes
            p99 = _hist_quantile(self._run_hist, 0.99)
            depth = self._accretion
            nsets = len(self._sets)
        out = {
            "working_sets": nsets,
            "containers": counts,
            "actual_bytes": actual,
            "optimal_bytes": optimal,
            "drift_ratio": round(actual / optimal, 4) if optimal else 1.0,
            "fragmentation_p99": p99,
            "accretion_depth": depth,
        }
        if dirty_refreshed is not None:
            out["dirty_refreshed"] = dirty_refreshed
        return out

    def _export(self) -> None:
        with self._lock:
            counts = dict(self._counts)
            actual = self._actual_bytes
            optimal = self._optimal_bytes
            p99 = _hist_quantile(self._run_hist, 0.99)
        for fmt in FORMATS:
            _CONTAINERS.set(counts.get(fmt, 0), (FORMATS[fmt],))
        _DRIFT_RATIO.set(round(actual / optimal, 4) if optimal else 1.0)
        _FRAGMENTATION_COUNT.set(p99)
        _BYTES.set(actual, ("actual",))
        _BYTES.set(optimal, ("optimal",))

    def reset(self) -> None:
        with self._lock:
            self._sets.clear()
            self._counts = {f: 0 for f in FORMATS}
            self._actual_bytes = 0
            self._optimal_bytes = 0
            self._run_hist.clear()
            self._accretion = 0
        self._export()
        _ACCRETION_COUNT.set(0)


def _hist_quantile(hist: Dict[int, int], q: float) -> int:
    """Quantile over a {value: count} histogram (nearest-rank)."""
    total = sum(hist.values())
    if total == 0:
        return 0
    rank = max(1, int(q * total + 0.5))
    seen = 0
    for value in sorted(hist):
        seen += hist[value]
        if seen >= rank:
            return int(value)
    return int(max(hist))


LEDGER = StructureLedger()
