"""Metrics, spans, the flight recorder and decision provenance.

Counterpart of ``roaringbitmap_tpu/observe/``: one registry, three metric
kinds, the exporters, the timeline, trace ids, the decision log, the
outcome ledger, the health rules and their sentinel, flight bundles, the
structure ledger and lock-wait stats, with the JAX package's metric
names::

    instrumented layers                           observe/
    ──────────────────────────────────            ──────────────────────────
    kernel launches      (ops/kernels)        ─┐
    layout, transfers, cache (parallel/store)  ├─► registry.REGISTRY ─► export:
    query plan, cache    (query/)              │   (Counter/Gauge/       Prometheus text,
    faults, retries, breakers (robust/)        │    Histogram,           JSONL,
    host phases + spans  (tracing + spans)    ─┘    snapshot/reset)      metrics_sidecar(path)

Metric naming convention: ``rb_tpu_<layer>_<name>`` (canonical names in
``registry.py``). Pure stdlib apart from the ``torch.profiler`` range a
span opens while a profiler records (``spans``), which imports torch then.

``health`` judges the registry with the JAX package's rule table (one
departure: the ``hbm-accounting-drift`` rule judges the device source by
its sign), ``sentinel`` paces and actuates it, ``bundle`` writes the flight
bundle of a red episode, ``structure`` keeps the container-format books of
watched working sets. ``lockstats`` is imported on demand (``from
roaringbitmap_tpu_torch.observe import lockstats``), as in the JAX package,
because importing it may install the lock proxies from the environment.

The sentinel's ``refit``, ``maintain`` and ``autotune`` actuations call
``cost.refit_all``, ``serve.maintain.run_pass`` and
``query.fusion.autotune_window``; a bundle carries ``calibration.json``
and the observatory's ``serving``, ``epochs``, ``structure`` and
``durable`` panels, as in the JAX package.
"""

from .registry import (
    ANALYSIS_CONTRACT_FINDINGS_TOTAL,
    ANALYSIS_FINDINGS_TOTAL,
    BREAKER_TRANSITIONS_TOTAL,
    BSI_FOUND_TOTAL,
    COMPILE_TOTAL,
    BATCH_PAIRWISE_TOTAL,
    COLUMNAR_BATCH_TOTAL,
    COLUMNAR_CLASS_SECONDS,
    COLUMNAR_ROUTE_TOTAL,
    COSTMODEL_DRIFT_RATIO,
    DEADLINE_TOTAL,
    DECISION_ERROR_RATIO,
    DECISION_REGRET_SECONDS,
    DECISION_TOTAL,
    DEFAULT_TIME_BUCKETS,
    DEGRADE_TOTAL,
    DURABLE_ARTIFACT_BYTES,
    DURABLE_DEMOTE_TOTAL,
    DURABLE_EPOCH_COUNT,
    DURABLE_PENDING_COUNT,
    DURABLE_PERSIST_BYTES_TOTAL,
    DURABLE_PERSIST_STAGE_SECONDS,
    DURABLE_PERSIST_TOTAL,
    DURABLE_PERSIST_WALL_SECONDS,
    DURABLE_RECOVERY_TOTAL,
    FAULT_INJECTED_TOTAL,
    FUSION_BATCH_SECONDS,
    FUSION_BATCH_TOTAL,
    FUSION_HEDGE_TOTAL,
    FUSION_QUERIES_TOTAL,
    FUSION_QUEUED_COUNT,
    FUSION_STEPS_TOTAL,
    FUSION_WINDOW_COUNT,
    HBM_ACCOUNTING_DRIFT_BYTES,
    HEALTH_ACTUATION_TOTAL,
    HEALTH_RULE_STATE,
    HEALTH_STATUS,
    HOST_OP_SECONDS,
    KERNEL_DISPATCH_TOTAL,
    LOCK_WAIT_SECONDS,
    OUTCOME_ANOMALY_TOTAL,
    OUTCOME_JOIN_TOTAL,
    OUTCOME_ORPHANS_TOTAL,
    PACK_CACHE_DELTA_ROWS_TOTAL,
    PACK_CACHE_EVICTED_BYTES_TOTAL,
    PACK_CACHE_HITS_TOTAL,
    PACK_CACHE_MISSES_TOTAL,
    PACK_CACHE_RESIDENT_BYTES,
    QUERY_CACHE_TOTAL,
    QUERY_INFLIGHT_TOTAL,
    QUERY_LATENCY_SECONDS,
    QUERY_PLAN_TOTAL,
    REGISTRY,
    SERIAL_BYTES_TOTAL,
    SERVE_ADMIT_TOTAL,
    SERVE_EPOCH_COUNT,
    SERVE_EPOCH_FLIP_TOTAL,
    SERVE_FLIP_STAGE_SECONDS,
    SERVE_FRESHNESS_SECONDS,
    SERVE_INFLIGHT_COUNT,
    SERVE_INGEST_TOTAL,
    SERVE_LATENCY_SECONDS,
    SERVE_MAINTAIN_KEYS_TOTAL,
    SERVE_MAINTAIN_RECLAIMED_BYTES_TOTAL,
    SERVE_MAINTAIN_SECONDS,
    SERVE_MAINTAIN_TOTAL,
    SERVE_MUTLOG_COUNT,
    SERVE_QPS,
    SERVE_QUEUE_COUNT,
    SERVE_REQUESTS_TOTAL,
    SERVE_SATURATION_RATIO,
    SERVE_SLO_BUDGET_SECONDS,
    SERVE_TENANT_BYTES,
    RETRY_TOTAL,
    SPAN_SECONDS,
    STORE_DELTA_STAGE_SECONDS,
    STORE_LAYOUT_TOTAL,
    STORE_OVERLAP_RATIO,
    STORE_PACK_STAGE_SECONDS,
    STORE_RESIDENT_BYTES,
    STORE_TRANSFER_BYTES_TOTAL,
    STRUCTURE_ACCRETION_COUNT,
    STRUCTURE_BYTES,
    STRUCTURE_CONTAINERS,
    STRUCTURE_DRIFT_RATIO,
    STRUCTURE_FRAGMENTATION_COUNT,
    TIMELINE_ANOMALY_TOTAL,
    TIMELINE_SPAN_SECONDS,
    Counter,
    Gauge,
    Histogram,
    MetricError,
    Registry,
    counter,
    gauge,
    histogram,
    reset,
    snapshot,
)
from .compat import CounterMap
from .histogram import (
    DEFAULT_LATENCY_BUCKETS,
    SNAPSHOT_QUANTILES,
    LatencyHistogram,
    latency_histogram,
    log_time_buckets,
)
from . import timeline
from .timeline import FlightRecorder, TimelineEvent
from . import context
from . import decisions
from . import compilewatch
# the outcome ledger is decisions' lazy dependency: imported after it
from . import outcomes
from . import artifacts
from . import health
from . import sentinel
from . import bundle
from . import structure
from .context import adopt, current_trace, new_trace_id, trace_scope
from .decisions import DecisionLog, SampledSite, record_decision
from .health import Rule, RuleState, Snapshot
from .sentinel import SENTINEL, Sentinel
from .structure import StructureLedger
from .outcomes import OutcomeLedger
from .spans import current_path, depth, reset_spans, span, span_timings

# the .histogram submodule import above shadows the registration helper on
# the package namespace; re-bind the helper (the submodule stays reachable
# as roaringbitmap_tpu_torch.observe.histogram via sys.modules)
from .registry import histogram
from .export import (
    SIDECAR_SCHEMA,
    jsonl_lines,
    metrics_sidecar,
    prometheus_text,
    sidecar_snapshot,
    to_jsonl,
    write_jsonl,
    write_prometheus,
)

__all__ = [
    "REGISTRY",
    "Registry",
    "Counter",
    "Gauge",
    "Histogram",
    "LatencyHistogram",
    "FlightRecorder",
    "TimelineEvent",
    "MetricError",
    "CounterMap",
    "counter",
    "gauge",
    "histogram",
    "latency_histogram",
    "log_time_buckets",
    "timeline",
    "snapshot",
    "reset",
    "span",
    "span_timings",
    "current_path",
    "depth",
    "reset_spans",
    "metrics_sidecar",
    "sidecar_snapshot",
    "prometheus_text",
    "to_jsonl",
    "jsonl_lines",
    "write_jsonl",
    "write_prometheus",
    "SIDECAR_SCHEMA",
    "DEFAULT_TIME_BUCKETS",
    "DEFAULT_LATENCY_BUCKETS",
    "SNAPSHOT_QUANTILES",
    "KERNEL_DISPATCH_TOTAL",
    "STORE_LAYOUT_TOTAL",
    "STORE_TRANSFER_BYTES_TOTAL",
    "STORE_RESIDENT_BYTES",
    "STORE_OVERLAP_RATIO",
    "PACK_CACHE_HITS_TOTAL",
    "PACK_CACHE_MISSES_TOTAL",
    "PACK_CACHE_DELTA_ROWS_TOTAL",
    "PACK_CACHE_EVICTED_BYTES_TOTAL",
    "PACK_CACHE_RESIDENT_BYTES",
    "HOST_OP_SECONDS",
    "SPAN_SECONDS",
    "QUERY_CACHE_TOTAL",
    "QUERY_PLAN_TOTAL",
    "TIMELINE_SPAN_SECONDS",
    "TIMELINE_ANOMALY_TOTAL",
    "STORE_PACK_STAGE_SECONDS",
    "STORE_DELTA_STAGE_SECONDS",
    "QUERY_LATENCY_SECONDS",
    "DEGRADE_TOTAL",
    "BREAKER_TRANSITIONS_TOTAL",
    "BSI_FOUND_TOTAL",
    "RETRY_TOTAL",
    "SERVE_ADMIT_TOTAL",
    "SERVE_INFLIGHT_COUNT",
    "SERVE_LATENCY_SECONDS",
    "SERVE_QPS",
    "SERVE_QUEUE_COUNT",
    "SERVE_REQUESTS_TOTAL",
    "SERVE_SATURATION_RATIO",
    "SERVE_SLO_BUDGET_SECONDS",
    "SERVE_TENANT_BYTES",
    "FAULT_INJECTED_TOTAL",
    "DEADLINE_TOTAL",
    "COMPILE_TOTAL",
    "ANALYSIS_FINDINGS_TOTAL",
    "ANALYSIS_CONTRACT_FINDINGS_TOTAL",
    "DECISION_TOTAL",
    "DECISION_REGRET_SECONDS",
    "DECISION_ERROR_RATIO",
    "OUTCOME_JOIN_TOTAL",
    "OUTCOME_ORPHANS_TOTAL",
    "OUTCOME_ANOMALY_TOTAL",
    "COSTMODEL_DRIFT_RATIO",
    "BATCH_PAIRWISE_TOTAL",
    "COLUMNAR_BATCH_TOTAL",
    "COLUMNAR_ROUTE_TOTAL",
    "COLUMNAR_CLASS_SECONDS",
    "LOCK_WAIT_SECONDS",
    "HBM_ACCOUNTING_DRIFT_BYTES",
    "HEALTH_STATUS",
    "HEALTH_RULE_STATE",
    "HEALTH_ACTUATION_TOTAL",
    "FUSION_BATCH_TOTAL",
    "FUSION_QUERIES_TOTAL",
    "FUSION_STEPS_TOTAL",
    "FUSION_BATCH_SECONDS",
    "FUSION_QUEUED_COUNT",
    "FUSION_HEDGE_TOTAL",
    "FUSION_WINDOW_COUNT",
    "QUERY_INFLIGHT_TOTAL",
    "STRUCTURE_CONTAINERS",
    "STRUCTURE_DRIFT_RATIO",
    "STRUCTURE_FRAGMENTATION_COUNT",
    "STRUCTURE_ACCRETION_COUNT",
    "STRUCTURE_BYTES",
    "health",
    "sentinel",
    "bundle",
    "structure",
    "Rule",
    "RuleState",
    "Snapshot",
    "Sentinel",
    "SENTINEL",
    "StructureLedger",
    "SampledSite",
    "context",
    "decisions",
    "outcomes",
    "compilewatch",
    "artifacts",
    "trace_scope",
    "adopt",
    "current_trace",
    "new_trace_id",
    "record_decision",
    "DecisionLog",
    "OutcomeLedger",
]
