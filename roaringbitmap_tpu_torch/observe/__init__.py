"""Metrics, spans, the flight recorder and decision provenance.

Counterpart of ``roaringbitmap_tpu/observe/``: one registry, three metric
kinds, the exporters, the timeline, trace ids, the decision log and the
outcome ledger, with the JAX package's metric names::

    instrumented layers                           observe/
    ──────────────────────────────────            ──────────────────────────
    kernel launches      (ops/kernels)        ─┐
    layout, transfers, cache (parallel/store)  ├─► registry.REGISTRY ─► export:
    query plan, cache    (query/)              │   (Counter/Gauge/       Prometheus text,
    faults, retries, breakers (robust/)        │    Histogram,           JSONL,
    host phases + spans  (tracing + spans)    ─┘    snapshot/reset)      metrics_sidecar(path)

Metric naming convention: ``rb_tpu_<layer>_<name>`` (canonical names in
``registry.py``). Pure stdlib apart from the ``torch.profiler`` ranges of
``trace=True`` spans, which import torch when they open.

The JAX package's ``health``, ``lockstats``, ``sentinel``, ``bundle`` and
``structure`` modules come with the next slice of the port (ROADMAP Queue
A item 3b).
"""

from .registry import (
    BREAKER_TRANSITIONS_TOTAL,
    COMPILE_TOTAL,
    COSTMODEL_DRIFT_RATIO,
    DEADLINE_TOTAL,
    DECISION_ERROR_RATIO,
    DECISION_REGRET_SECONDS,
    DECISION_TOTAL,
    DEFAULT_TIME_BUCKETS,
    DEGRADE_TOTAL,
    FAULT_INJECTED_TOTAL,
    HOST_OP_SECONDS,
    KERNEL_DISPATCH_TOTAL,
    OUTCOME_ANOMALY_TOTAL,
    OUTCOME_JOIN_TOTAL,
    OUTCOME_ORPHANS_TOTAL,
    PACK_CACHE_DELTA_ROWS_TOTAL,
    PACK_CACHE_EVICTED_BYTES_TOTAL,
    PACK_CACHE_HITS_TOTAL,
    PACK_CACHE_MISSES_TOTAL,
    PACK_CACHE_RESIDENT_BYTES,
    QUERY_CACHE_TOTAL,
    QUERY_LATENCY_SECONDS,
    QUERY_PLAN_TOTAL,
    REGISTRY,
    RETRY_TOTAL,
    SPAN_SECONDS,
    STORE_DELTA_STAGE_SECONDS,
    STORE_LAYOUT_TOTAL,
    STORE_OVERLAP_RATIO,
    STORE_PACK_STAGE_SECONDS,
    STORE_RESIDENT_BYTES,
    STORE_TRANSFER_BYTES_TOTAL,
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
from .context import adopt, current_trace, new_trace_id, trace_scope
from .decisions import DecisionLog, record_decision
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
    "RETRY_TOTAL",
    "FAULT_INJECTED_TOTAL",
    "DEADLINE_TOTAL",
    "COMPILE_TOTAL",
    "DECISION_TOTAL",
    "DECISION_REGRET_SECONDS",
    "DECISION_ERROR_RATIO",
    "OUTCOME_JOIN_TOTAL",
    "OUTCOME_ORPHANS_TOTAL",
    "OUTCOME_ANOMALY_TOTAL",
    "COSTMODEL_DRIFT_RATIO",
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
