"""Introspection: container statistics and writer recommendation
(reference ``insights/`` package: BitmapAnalyser.java:15, BitmapStatistics,
NaiveWriterRecommender.java:14).

Counterpart of the JAX package's ``insights.py``: ``analyse``,
``recommend`` and ``native_backend``, and the execution counters that read
the ``observe`` registry — ``dispatch_counters``,
``reset_dispatch_counters``, ``query_counters``, ``columnar_counters``,
``columnar_costmodel``, ``pack_cache_counters``, ``robust_counters``,
``decisions``, ``outcomes``, ``regret_summary``, ``health``,
``fusion_counters``, ``serving``, ``epochs``, ``structure``, ``durable``,
``cost_authorities``, ``observatory`` and ``metrics_snapshot``.

Departures: ``dispatch_counters()["kernel"]`` is keyed by this package's
kernel names and engines (``"rb_group_reduce[dense]/cuda"``, ``".../plain"``),
and ``"probes"`` is ``{}``: the port never probes for a lowering, it
launches its kernels or raises.
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


def columnar_counters() -> dict:
    """Columnar pairwise-engine observability: batched container pairs by
    ``op/class`` (the 9 ``(array|bitmap|run)²`` classes, the device tier's
    ``device_pair`` / ``device_gather``, ``fold_<op>/rows`` for the N-way
    CPU folds) and the cutoff model's verdicts by tier, as plain str->int
    dicts, from ``rb_tpu_columnar_batch_total`` /
    ``rb_tpu_columnar_route_total``."""
    from . import observe

    m = observe.REGISTRY.get(observe.COLUMNAR_BATCH_TOTAL)
    r = observe.REGISTRY.get(observe.COLUMNAR_ROUTE_TOTAL)
    return {
        "batch": {f"{lv[0]}/{lv[1]}": v for lv, v in m.series().items()} if m else {},
        "route": {lv[0]: v for lv, v in r.series().items()} if r else {},
    }


def columnar_costmodel() -> dict:
    """The columnar cutoff model's state: calibration, backend, per-engine
    cost coefficients and the fold gate — the inputs behind every
    ``columnar.cutoff`` decision."""
    from . import columnar

    d = columnar.MODEL.to_dict()
    d["fold_gate_rows"] = columnar.MODEL.fold_gate_rows()
    return d


def regret_summary() -> dict:
    """Per-site regret rollup: join counts, regret seconds, error ratios,
    the worst recent decision with its inputs, the per-coefficient drift
    gauges and the cost models' provenance."""
    from . import columnar, observe
    from .query.plan import CARD_MODEL

    return {
        "sites": observe.outcomes.summary(),
        "drift": observe.outcomes.drift(),
        "pending": observe.outcomes.LEDGER.pending_count(),
        "provenance": {
            "columnar": columnar.MODEL.provenance if columnar.MODEL.calibrated
            else "default-gate",
            "planner_cardinality": CARD_MODEL.provenance,
            "fusion_batch": _fusion_model_provenance(),
        },
    }


def _fusion_model_provenance() -> str:
    from .cost import fusion as _fusion_cost

    return _fusion_cost.MODEL.provenance


def health() -> dict:
    """Health-sentinel snapshot: the process status (green / yellow /
    red), every rule's post-hysteresis level with its value and
    thresholds, and the recent actuation log."""
    from . import observe

    s = observe.sentinel.SENTINEL
    level, name = s.status()
    return {
        "status": level,
        "status_name": name,
        "rules": s.rule_states(),
        "actuations": s.actuations(8),
        "sentinel_running": observe.sentinel.running(),
    }


def fusion_counters() -> dict:
    """Cross-query fusion rollup: window volume by outcome, query volume,
    step fates, the derived occupancy and shared-subexpression hit ratio,
    the in-flight dedup table's live stats, the queue depth, and the
    effective window bound."""
    from . import observe
    from .observe import export as _export
    from .query import fusion as _q_fusion
    from .query import inflight as _inflight

    block = _export._fusion_block(observe.REGISTRY.snapshot())
    block["inflight_live"] = _inflight.TABLE.stats()
    # effective < base means the serving-p99-pressure actuation has shrunk
    # the window and not yet regrown it
    block["window_state"] = {
        "effective": _q_fusion.config.window,
        "base": _q_fusion.config.window_base,
        "min": _q_fusion.config.window_min,
        "hedge_enabled": _q_fusion.config.hedge,
    }
    return block


def serving() -> dict:
    """Serving-tier rollup: per-tenant rolling QPS, latency p50/p99 per
    phase, admission verdict volume, queue / in-flight depth, saturation
    and resident byte shares (registry-derived), plus the live admission
    controller's stats."""
    from . import observe
    from .observe import export as _export
    from .serve import admission as _admission

    block = _export._serving_block(observe.REGISTRY.snapshot(), observe.REGISTRY)
    block["admission_live"] = _admission.CONTROLLER.stats()
    return block


def epochs() -> dict:
    """Epoch-ledger rollup: the current epoch, live mutation-log depth,
    flip volume by outcome, per-tenant freshness p50/p99 and the flip
    stage decomposition (registry-derived), plus the live EpochStore's
    lineage tail and stats (process-local)."""
    from . import observe
    from .observe import export as _export
    from .serve import epochs as _epochs

    block = _export._epochs_block(observe.REGISTRY.snapshot(), observe.REGISTRY)
    store = _epochs.current_store()
    if store is not None:
        block["store_live"] = store.stats()
        block["lineage"] = store.lineage(16)
    else:
        block["store_live"] = None
        block["lineage"] = []
    return block


def structure() -> dict:
    """Structure-ledger rollup: the container-format census, actual and
    optimal serialized bytes with the drift ratio, run fragmentation p99,
    accretion depth and maintenance-pass volume (registry-derived), plus
    the live ledger's stats, the last taken pass's record and the
    compaction authority's provenance."""
    from . import observe
    from .cost import compaction as _compaction_cost
    from .observe import export as _export
    from .observe import structure as _structure
    from .serve import maintain as _maintain

    block = _export._structure_block(observe.REGISTRY.snapshot())
    block["ledger_live"] = (
        _structure.LEDGER.stats() if _structure.LEDGER.watched() else None
    )
    block["last_pass"] = _maintain.last_pass() or None
    block["authority"] = _compaction_cost.MODEL.provenance
    return block


def durable() -> dict:
    """Durable-epoch rollup: persisted against serving epoch, artifact
    bytes, persist / recovery / demotion volume (registry-derived), plus
    the live ``durable.DurableStore``'s stats and the last recovery's
    provenance (which directory won, how many torn artifacts were
    skipped)."""
    from . import observe
    from .durable import recovery as _recovery
    from .durable import store as _dstore
    from .observe import export as _export

    block = _export._durable_block(observe.REGISTRY.snapshot())
    live = _dstore.current_store()
    block["store_live"] = live.stats() if live is not None else None
    block["recovery_last"] = _recovery.LAST
    return block


def cost_authorities() -> dict:
    """The unified cost facade's view: every pricing authority's curves,
    provenance and live drift."""
    from . import cost

    return cost.calibration_state()


def observatory() -> dict:
    """Resource-observatory snapshot: lock-wait quantiles over the
    framework locks (empty until ``observe.lockstats.install()``), library
    build counts, the device-memory reconciliation (computed fresh),
    breaker states, pack-cache stats, the decision-log tail, the regret
    rollup, the health sentinel's state and the serving, epoch, structure
    and durable panels."""
    from . import observe
    from .observe import lockstats
    from .parallel import store
    from .robust import ladder

    return {
        "locks": lockstats.wait_stats(),
        "lock_timing": lockstats.timing_enabled(),
        "compile": observe.compilewatch.compile_counts(),
        "hbm": store.hbm_reconciliation(),
        "breakers": ladder.LADDER.states(),
        "pack_cache": store.PACK_CACHE.stats(),
        "decisions": decisions(32),
        "regret": regret_summary(),
        "health": health(),
        # the per-tenant panel rides the observatory view, so a red
        # episode's flight bundle carries the serving state that fired it
        "serving": serving(),
        # which snapshot was serving, how stale the log is, and the
        # lineage that led here
        "epochs": epochs(),
        # the corpus shape behind the structure-drift rule
        "structure": structure(),
        # which frozen epoch, if any, a restart would recover to
        "durable": durable(),
    }


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
