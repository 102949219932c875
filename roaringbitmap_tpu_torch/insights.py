"""Introspection: container statistics and writer recommendation
(reference ``insights/`` package: BitmapAnalyser.java:15, BitmapStatistics,
NaiveWriterRecommender.java:14).

Counterpart of the JAX package's ``insights.py``: ``analyse``,
``recommend`` and ``native_backend``, and the execution counters that read
the ``observe`` registry — ``dispatch_counters``,
``reset_dispatch_counters``, ``query_counters``, ``pack_cache_counters``,
``robust_counters``, ``decisions``, ``outcomes`` and ``metrics_snapshot``.

Departures: ``dispatch_counters()["kernel"]`` is keyed by this package's
kernel names and engines (``"rb_group_reduce[dense]/cuda"``, ``".../plain"``),
and ``"probes"`` is ``{}``: the port never probes for a lowering, it
launches its kernels or raises. ``"pairwise"`` reads
``parallel.batch.PAIRWISE_COUNTS``, still a plain dict. The JAX package's
``columnar_counters``, ``columnar_costmodel``, ``regret_summary``,
``health``, ``fusion_counters`` and ``observatory`` come with the next
slice of the port, ``serving``, ``epochs``, ``structure``, ``durable`` and
``cost_authorities`` with the serving, durable and cost modules (ROADMAP
Queue A).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, List

from .models.container import BitmapContainer, RunContainer
from .models.roaring import RoaringBitmap


@dataclass
class ArrayContainersStats:
    containers_count: int = 0
    cardinality_sum: int = 0

    def average_cardinality(self) -> float:
        return self.cardinality_sum / self.containers_count if self.containers_count else float("nan")


@dataclass
class BitmapStatistics:
    """Aggregated container statistics (insights/BitmapStatistics.java)."""

    array_stats: ArrayContainersStats = field(default_factory=ArrayContainersStats)
    bitmap_containers_count: int = 0
    run_containers_count: int = 0
    bitmaps_count: int = 0

    def container_count(self) -> int:
        return self.array_stats.containers_count + self.bitmap_containers_count + self.run_containers_count

    def container_fraction(self, count: int) -> float:
        total = self.container_count()
        return count / total if total else float("nan")


def analyse(bitmaps: Iterable[RoaringBitmap]) -> BitmapStatistics:
    """BitmapAnalyser.analyse (insights/BitmapAnalyser.java:15-35). Takes
    one bitmap or an iterable of them, heap or mapped."""
    stats = BitmapStatistics()
    for bm in [bitmaps] if hasattr(bitmaps, "high_low_container") else bitmaps:
        stats.bitmaps_count += 1
        for c in bm.high_low_container.containers:
            if isinstance(c, RunContainer):
                stats.run_containers_count += 1
            elif isinstance(c, BitmapContainer):
                stats.bitmap_containers_count += 1
            else:
                stats.array_stats.containers_count += 1
                stats.array_stats.cardinality_sum += c.cardinality
    return stats


def native_backend() -> str:
    """Which host-kernel tier serves the CPU fast path, read without
    building anything: ``"ext"`` (the native tier, loaded: the CPython
    extension with the ``ctypes`` library beside it), ``"numpy"`` (the
    plain versions, chosen with ``native.set_tier``), or ``"unloaded"``
    (the native tier, not built or loaded yet in this process)."""
    from . import native

    st = native.backend_tier()
    if st["tier"] == "numpy":
        return "numpy"
    return "ext" if st["loaded"] else "unloaded"


def dispatch_counters() -> dict:
    """Which kernels, layouts and transfer routes served device work so
    far: ``{"kernel": {"<kernel>/<engine>": n}, "layout": {...},
    "transfer_bytes": {route: bytes}, "pairwise": {...}, "probes": {},
    "native": tier}`` — the JAX package's shape, read from the registry
    (``rb_tpu_kernel_dispatch_total``, ``rb_tpu_store_layout_total``,
    ``rb_tpu_store_transfer_bytes_total``)."""
    from .ops import kernels
    from .parallel import batch, store

    return {
        "kernel": {f"{lv[0]}/{lv[1]}": v for lv, v in kernels._DISPATCH_TOTAL.series().items()},
        "layout": dict(store.LAYOUT_COUNTS),
        "transfer_bytes": dict(store.TRANSFER_BYTES),
        "pairwise": dict(batch.PAIRWISE_COUNTS),
        "probes": {},
        "native": native_backend(),
    }


def reset_dispatch_counters() -> None:
    """Zero the kernel, layout and transfer counters (the kernel and
    layout keys stay, at 0)."""
    from .ops import kernels
    from .parallel import batch, store

    kernels._DISPATCH_TOTAL.clear()
    kernels.reset_launches()
    for layout in store.LAYOUTS:
        store.LAYOUT_COUNTS[layout] = 0
    store.TRANSFER_BYTES.clear()
    for k in batch.PAIRWISE_COUNTS:
        batch.PAIRWISE_COUNTS[k] = 0


def _series(name: str, joined: bool = False) -> dict:
    from . import observe

    m = observe.REGISTRY.get(name)
    if m is None:
        return {}
    return {("/".join(lv) if joined else lv[0]): v for lv, v in m.series().items()}


def query_counters() -> dict:
    """Query-engine observability: planned steps by chosen engine and
    result-cache events (hit / miss / store / evict):
    ``{"plan": {engine: steps}, "cache": {event: count}}``."""
    from . import observe

    return {
        "plan": _series(observe.QUERY_PLAN_TOTAL),
        "cache": _series(observe.QUERY_CACHE_TOTAL),
    }


def pack_cache_counters() -> dict:
    """Resident pack cache observability: per-kind hit / miss / delta-row /
    evicted-byte counters and the resident-bytes gauge. Kinds are the
    routed consumers: agg | bsi | bsi64 | andnot | threshold | colrows."""
    from . import observe

    return {
        "hits": _series(observe.PACK_CACHE_HITS_TOTAL),
        "misses": _series(observe.PACK_CACHE_MISSES_TOTAL),
        "delta_rows": _series(observe.PACK_CACHE_DELTA_ROWS_TOTAL),
        "evicted_bytes": _series(observe.PACK_CACHE_EVICTED_BYTES_TOTAL),
        "resident_bytes": _series(observe.PACK_CACHE_RESIDENT_BYTES),
    }


def robust_counters() -> dict:
    """Fault model observability: degradation edges (``site/from/to``),
    breaker transitions (``site/tier/state``), retry outcomes, deadline
    outcomes, and injected faults by site."""
    from . import observe

    return {
        "degrade": _series(observe.DEGRADE_TOTAL, joined=True),
        "breaker": _series(observe.BREAKER_TRANSITIONS_TOTAL, joined=True),
        "retry": _series(observe.RETRY_TOTAL, joined=True),
        "deadline": _series(observe.DEADLINE_TOTAL, joined=True),
        "faults": _series(observe.FAULT_INJECTED_TOTAL, joined=True),
    }


def decisions(n: int = None) -> list:
    """The newest ``n`` entries of the decision log (all retained when
    None), oldest first: the deciding site, the decision, its inputs and
    the trace id it was made under."""
    from . import observe

    return observe.decisions.decisions(n)


def outcomes(n: int = None) -> list:
    """The newest ``n`` decision-outcome joins (all retained when None),
    oldest first: the engine that ran, the measured wall, the prediction,
    the error ratio and the regret."""
    from . import observe

    return observe.outcomes.tail(n)


def metrics_snapshot() -> dict:
    """The full labeled registry snapshot (every rb_tpu_* metric with its
    histograms); see ``observe.export`` for the JSONL / Prometheus
    renderings."""
    from . import observe

    return observe.snapshot()


def recommend(stats: BitmapStatistics) -> str:
    """NaiveWriterRecommender.recommend (insights/NaiveWriterRecommender.java:14):
    writer-configuration advice from the observed container mix."""
    lines: List[str] = []
    total = stats.container_count()
    if total == 0:
        return "No containers analysed; defaults are fine."
    run_frac = stats.container_fraction(stats.run_containers_count)
    bitmap_frac = stats.container_fraction(stats.bitmap_containers_count)
    array_frac = stats.container_fraction(stats.array_stats.containers_count)
    if run_frac > 0.5:
        lines.append(f"{run_frac:.0%} run containers: use writer().optimise_for_runs()")
    if bitmap_frac > 0.5:
        lines.append(
            f"{bitmap_frac:.0%} bitmap containers: use writer().constant_memory() "
            "(dense chunks fill the fixed 8 KiB buffer)"
        )
    if array_frac > 0.5:
        avg = stats.array_stats.average_cardinality()
        lines.append(
            f"{array_frac:.0%} array containers (avg cardinality {avg:.0f}): use "
            f"writer().optimise_for_arrays().expected_values_per_container({int(avg) or 1})"
        )
    if stats.bitmaps_count > 64:
        lines.append(
            f"{stats.bitmaps_count} bitmaps: wide aggregations will take the "
            "batched device path (FastAggregation mode='auto')"
        )
    if not lines:
        lines.append("Mixed container profile; default writer settings are reasonable.")
    return "\n".join(lines)
