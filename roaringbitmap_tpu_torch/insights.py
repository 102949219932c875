"""Introspection: container statistics and writer recommendation
(reference ``insights/`` package: BitmapAnalyser.java:15, BitmapStatistics,
NaiveWriterRecommender.java:14).

Counterpart of the structural part of the JAX package's ``insights.py``:
``analyse``, ``recommend`` and ``native_backend``. Its execution counters
(``dispatch_counters``, ``query_counters`` and the rest) read the JAX
package's ``observe`` registry, which the port does not have yet; the
port's own counters are plain dicts beside their modules
(``ops.kernels.LAUNCHES``, ``parallel.store.LAYOUT_COUNTS``,
``parallel.batch.PAIRWISE_COUNTS``).
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
