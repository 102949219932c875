"""Thread-safe labeled metrics registry: the one substrate behind every
counter, gauge and histogram of the package.

Counterpart of ``roaringbitmap_tpu/observe/registry.py``, with the same
metric names, kinds, label names and exports, so a dashboard or a test
that reads one package reads the other:

* ``Registry`` — named metrics, each a family of label-tuple-keyed series
  guarded by one registry-wide lock (every hot-path mutation is a dict
  update; contention is nanoseconds against dispatch costs of
  microseconds).
* ``Counter`` / ``Gauge`` / ``Histogram`` — the three metric kinds.
  Histograms use fixed upper-bound buckets chosen at registration
  (``DEFAULT_TIME_BUCKETS`` spans 100 µs .. 10 s, the host-phase range).
* ``snapshot()`` / ``reset()`` — a point-in-time plain-dict view of every
  series (what ``observe.export`` serializes) and a values-only clear that
  keeps metric definitions registered.

Naming convention: ``rb_tpu_<layer>_<name>`` (canonical names below) so a
Prometheus scrape is groupable by layer. The module counters the port
had before the registry (``ops/kernels.LAUNCHES``,
``parallel/store.LAYOUT_COUNTS``) stay importable as
``observe.compat.CounterMap`` views over these metrics.

Pure stdlib.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

Number = Union[int, float]
LabelsArg = Union[Sequence[str], Mapping[str, str]]

# canonical metric names, one per instrumented layer (rb_tpu_<layer>_<name>),
# the JAX package's catalog cut to the names this package registers; a
# later module adds its own names here with the same spelling
KERNEL_DISPATCH_TOTAL = "rb_tpu_kernel_dispatch_total"
STORE_LAYOUT_TOTAL = "rb_tpu_store_layout_total"
STORE_TRANSFER_BYTES_TOTAL = "rb_tpu_store_transfer_bytes_total"
STORE_RESIDENT_BYTES = "rb_tpu_store_resident_bytes"
# overlap shipping lane: fraction of staged marshal wall hidden behind the
# previous query's compute (0 = fully serial, 1 = fully hidden)
STORE_OVERLAP_RATIO = "rb_tpu_store_overlap_ratio"
PACK_CACHE_HITS_TOTAL = "rb_tpu_pack_cache_hits_total"
PACK_CACHE_MISSES_TOTAL = "rb_tpu_pack_cache_misses_total"
PACK_CACHE_DELTA_ROWS_TOTAL = "rb_tpu_pack_cache_delta_rows_total"
PACK_CACHE_EVICTED_BYTES_TOTAL = "rb_tpu_pack_cache_evicted_bytes_total"
PACK_CACHE_RESIDENT_BYTES = "rb_tpu_pack_cache_resident_bytes"
HOST_OP_SECONDS = "rb_tpu_host_op_seconds"
SPAN_SECONDS = "rb_tpu_span_seconds"
QUERY_CACHE_TOTAL = "rb_tpu_query_cache_total"
QUERY_PLAN_TOTAL = "rb_tpu_query_plan_total"
# found sets given to the BSI entry points (models/bsi.py), by form:
# none | bitmap | resident (a set kept on the device between predicates)
BSI_FOUND_TOTAL = "rb_tpu_bsi_found_total"
# the static analyzer's per-rule finding counts (analysis/__main__.py)
ANALYSIS_FINDINGS_TOTAL = "rb_tpu_analysis_findings_total"
ANALYSIS_CONTRACT_FINDINGS_TOTAL = "rb_tpu_analysis_contract_findings_total"
# timeline / latency instrumentation: the flight recorder's span feed plus
# the per-stage latency histograms over the marshal pipeline
TIMELINE_SPAN_SECONDS = "rb_tpu_timeline_span_seconds"
TIMELINE_ANOMALY_TOTAL = "rb_tpu_timeline_anomaly_total"
STORE_PACK_STAGE_SECONDS = "rb_tpu_store_pack_stage_seconds"
STORE_DELTA_STAGE_SECONDS = "rb_tpu_store_delta_stage_seconds"
QUERY_LATENCY_SECONDS = "rb_tpu_query_latency_seconds"
# fault model & tier ladder: every degradation, breaker transition, retry,
# injected fault, and deadline outcome is a counter
DEGRADE_TOTAL = "rb_tpu_degrade_total"
BREAKER_TRANSITIONS_TOTAL = "rb_tpu_breaker_transitions_total"
RETRY_TOTAL = "rb_tpu_retry_total"
FAULT_INJECTED_TOTAL = "rb_tpu_fault_injected_total"
DEADLINE_TOTAL = "rb_tpu_deadline_total"
# library builds per tracked entry point, and the decision-log volume per
# deciding site
COMPILE_TOTAL = "rb_tpu_compile_total"
DECISION_TOTAL = "rb_tpu_decision_total"
# decision-outcome ledger: per-site routing regret and predicted-vs-measured
# error, join/orphan/anomaly volume, and the per-coefficient-cell
# calibration-drift gauge over the cost model
DECISION_REGRET_SECONDS = "rb_tpu_decision_regret_seconds"
DECISION_ERROR_RATIO = "rb_tpu_decision_error_ratio"
OUTCOME_JOIN_TOTAL = "rb_tpu_outcome_join_total"
OUTCOME_ORPHANS_TOTAL = "rb_tpu_outcome_orphans_total"
OUTCOME_ANOMALY_TOTAL = "rb_tpu_outcome_anomaly_total"
COSTMODEL_DRIFT_RATIO = "rb_tpu_costmodel_drift_ratio"
# batch similarity and the columnar engine: all-pairs matrix calls by
# impl, batched container pairs by (op, class), cutoff verdicts by tier,
# and the per-class kernel latency
BATCH_PAIRWISE_TOTAL = "rb_tpu_batch_pairwise_total"
COLUMNAR_BATCH_TOTAL = "rb_tpu_columnar_batch_total"
COLUMNAR_ROUTE_TOTAL = "rb_tpu_columnar_route_total"
# RoaringFormatSpec bytes by direction (serialize | deserialize)
SERIAL_BYTES_TOTAL = "rb_tpu_serial_bytes_total"
COLUMNAR_CLASS_SECONDS = "rb_tpu_columnar_class_seconds"
# resource observatory: lock-wait histograms over the framework locks and
# device-memory accounting drift (gauge vs ledger, gauge vs the card)
LOCK_WAIT_SECONDS = "rb_tpu_lock_wait_seconds"
HBM_ACCOUNTING_DRIFT_BYTES = "rb_tpu_hbm_accounting_drift_bytes"
# health sentinel: enum gauges (_status the process rollup, 0 green /
# 1 yellow / 2 red; _state the per-rule level, same encoding) and the
# actuations by rule and kind
HEALTH_STATUS = "rb_tpu_health_status"
HEALTH_RULE_STATE = "rb_tpu_health_rule_state"
HEALTH_ACTUATION_TOTAL = "rb_tpu_health_actuation_total"
# cross-query fusion: windows by outcome (fused | per-query | degraded),
# queries through windows, step fates (executed | merged | deduped),
# batch wall and per-query queue wait, the live queue depth, and the
# in-flight dedup table's events; hedge verdicts and the effective window
# bound are named for the health rules and the sidecar, and move with
# the serving tier
FUSION_BATCH_TOTAL = "rb_tpu_fusion_batch_total"
FUSION_QUERIES_TOTAL = "rb_tpu_fusion_queries_total"
FUSION_STEPS_TOTAL = "rb_tpu_fusion_steps_total"
FUSION_BATCH_SECONDS = "rb_tpu_fusion_batch_seconds"
FUSION_QUEUED_COUNT = "rb_tpu_fusion_queued_count"
QUERY_INFLIGHT_TOTAL = "rb_tpu_query_inflight_total"
FUSION_HEDGE_TOTAL = "rb_tpu_fusion_hedge_total"
FUSION_WINDOW_COUNT = "rb_tpu_fusion_window_count"
# structure observatory: live containers by declared format, actual over
# size-rule-optimal serialized bytes, p99 runs per run container, the
# epoch-delta accretion depth, and the byte totals behind the ratio
STRUCTURE_CONTAINERS = "rb_tpu_structure_containers"
STRUCTURE_DRIFT_RATIO = "rb_tpu_structure_drift_ratio"
STRUCTURE_FRAGMENTATION_COUNT = "rb_tpu_structure_fragmentation_count"
STRUCTURE_ACCRETION_COUNT = "rb_tpu_structure_accretion_count"
STRUCTURE_BYTES = "rb_tpu_structure_bytes"
# serving tier (serve/slo.py, serve/admission.py): per-tenant latency by
# phase, rolling QPS, requests by outcome, admission verdicts, the live
# queue and in-flight depths, per-tenant quota saturation, byte shares of
# the resident packs and the declared p99 budgets
SERVE_LATENCY_SECONDS = "rb_tpu_serve_latency_seconds"
SERVE_QPS = "rb_tpu_serve_qps"
SERVE_ADMIT_TOTAL = "rb_tpu_serve_admit_total"
SERVE_REQUESTS_TOTAL = "rb_tpu_serve_requests_total"
SERVE_QUEUE_COUNT = "rb_tpu_serve_queue_count"
SERVE_INFLIGHT_COUNT = "rb_tpu_serve_inflight_count"
SERVE_SATURATION_RATIO = "rb_tpu_serve_saturation_ratio"
SERVE_TENANT_BYTES = "rb_tpu_serve_tenant_bytes"
SERVE_SLO_BUDGET_SECONDS = "rb_tpu_serve_slo_budget_seconds"
# epoch ledger (serve/ingest.py, serve/epochs.py): ingest->queryable lag
# per tenant, flip stage walls (drain | repack | publish | reclaim),
# mutation batches by tenant, flips by outcome, the live mutation-log
# depth and the current epoch id as a gauge VALUE — epoch ids are
# unbounded and never label values
SERVE_FRESHNESS_SECONDS = "rb_tpu_serve_freshness_seconds"
SERVE_FLIP_STAGE_SECONDS = "rb_tpu_serve_flip_stage_seconds"
SERVE_INGEST_TOTAL = "rb_tpu_serve_ingest_total"
SERVE_EPOCH_FLIP_TOTAL = "rb_tpu_serve_epoch_flip_total"
SERVE_MUTLOG_COUNT = "rb_tpu_serve_mutlog_count"
SERVE_EPOCH_COUNT = "rb_tpu_serve_epoch_count"
# maintenance passes (serve/maintain.py): passes by outcome, the pass
# wall, reclaimed serialized bytes and rewritten chunk keys
SERVE_MAINTAIN_TOTAL = "rb_tpu_serve_maintain_total"
SERVE_MAINTAIN_SECONDS = "rb_tpu_serve_maintain_seconds"
SERVE_MAINTAIN_RECLAIMED_BYTES_TOTAL = "rb_tpu_serve_maintain_reclaimed_bytes_total"
SERVE_MAINTAIN_KEYS_TOTAL = "rb_tpu_serve_maintain_keys_total"
# durable epochs (durable/): persists by outcome, the persist stage walls
# (snapshot | lineage | manifest | publish), artifact bytes written, the
# newest persisted epoch id and artifact size as gauge VALUES, the
# unpersisted backlog, the last persist wall, recoveries by outcome
# (recovered | torn | empty) and eviction demotions by residency rung
# (mapped | discard)
DURABLE_PERSIST_TOTAL = "rb_tpu_durable_persist_total"
DURABLE_PERSIST_STAGE_SECONDS = "rb_tpu_durable_persist_stage_seconds"
DURABLE_PERSIST_BYTES_TOTAL = "rb_tpu_durable_persist_bytes_total"
DURABLE_EPOCH_COUNT = "rb_tpu_durable_epoch_count"
DURABLE_ARTIFACT_BYTES = "rb_tpu_durable_artifact_bytes"
DURABLE_PENDING_COUNT = "rb_tpu_durable_pending_count"
DURABLE_PERSIST_WALL_SECONDS = "rb_tpu_durable_persist_wall_seconds"
DURABLE_RECOVERY_TOTAL = "rb_tpu_durable_recovery_total"
DURABLE_DEMOTE_TOTAL = "rb_tpu_durable_demote_total"

# upper bucket bounds (seconds) for wall-time histograms: host phases span
# ~100 µs packing steps to multi-second CPU folds; +Inf is implicit
DEFAULT_TIME_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class MetricError(ValueError):
    """Registration conflict or label mismatch (always a caller bug)."""


class _Metric:
    """Base: a named family of label-tuple-keyed series."""

    kind = "untyped"

    def __init__(self, registry: "Registry", name: str, help: str, labelnames):
        self._lock = registry._lock
        self.name = name
        self.help = help
        self.labelnames: Tuple[str, ...] = tuple(labelnames)
        self._series: Dict[Tuple[str, ...], object] = {}  # guarded-by: self._lock

    def _labels_tuple(self, labels: LabelsArg) -> Tuple[str, ...]:
        # the hot path's form, a tuple of str of the right length, as is
        if type(labels) is tuple and len(labels) == len(self.labelnames):
            for v in labels:
                if type(v) is not str:
                    break
            else:
                return labels
        if isinstance(labels, Mapping):
            if set(labels) != set(self.labelnames):
                raise MetricError(
                    f"{self.name}: expected labels {self.labelnames}, "
                    f"got {sorted(labels)}"
                )
            labels = [labels[n] for n in self.labelnames]
        vals = tuple(str(v) for v in labels)
        if len(vals) != len(self.labelnames):
            raise MetricError(
                f"{self.name}: expected {len(self.labelnames)} label value(s) "
                f"{self.labelnames}, got {vals!r}"
            )
        return vals

    def clear(self) -> None:
        """Drop every series (values AND label sets); the metric definition
        stays registered."""
        with self._lock:
            self._series.clear()

    def series(self) -> Dict[Tuple[str, ...], object]:
        """Point-in-time copy: {labelvalues: value-or-state-dict}."""
        with self._lock:
            return {
                k: (dict(v) if isinstance(v, dict) else v)
                for k, v in self._series.items()
            }

    def _same_definition(self, other: "_Metric") -> bool:
        return type(self) is type(other) and self.labelnames == other.labelnames


class Counter(_Metric):
    """Monotonic labeled counter. ``set``/``remove`` exist only for the
    legacy Counter-dict facade (observe/compat.py) — new code uses ``inc``,
    which is atomic under the registry lock."""

    kind = "counter"

    def inc(self, amount: Number = 1, labels: LabelsArg = ()) -> None:
        if amount < 0:
            raise MetricError(f"{self.name}: counters only go up (inc {amount})")
        lv = self._labels_tuple(labels)
        with self._lock:
            self._series[lv] = self._series.get(lv, 0) + amount

    def get(self, labels: LabelsArg = ()) -> Number:
        lv = self._labels_tuple(labels)
        with self._lock:
            return self._series.get(lv, 0)

    def set(self, value: Number, labels: LabelsArg = ()) -> None:
        lv = self._labels_tuple(labels)
        with self._lock:
            self._series[lv] = value

    def remove(self, labels: LabelsArg) -> None:
        lv = self._labels_tuple(labels)
        with self._lock:
            self._series.pop(lv, None)


class Gauge(_Metric):
    """Labeled gauge: goes up and down (resident-bytes accounting)."""

    kind = "gauge"

    def set(self, value: Number, labels: LabelsArg = ()) -> None:
        lv = self._labels_tuple(labels)
        with self._lock:
            self._series[lv] = value

    def inc(self, amount: Number = 1, labels: LabelsArg = ()) -> None:
        lv = self._labels_tuple(labels)
        with self._lock:
            self._series[lv] = self._series.get(lv, 0) + amount

    def dec(self, amount: Number = 1, labels: LabelsArg = ()) -> None:
        self.inc(-amount, labels)

    def get(self, labels: LabelsArg = ()) -> Number:
        lv = self._labels_tuple(labels)
        with self._lock:
            return self._series.get(lv, 0)


class Histogram(_Metric):
    """Fixed-bucket labeled histogram. Per series: observation count, sum,
    and one slot per upper bound plus the implicit +Inf overflow slot
    (slots are per-bucket internally; exporters emit the cumulative
    Prometheus ``le`` form)."""

    kind = "histogram"

    def __init__(self, registry, name, help, labelnames, buckets=DEFAULT_TIME_BUCKETS):
        super().__init__(registry, name, help, labelnames)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise MetricError(f"{name}: histogram needs at least one bucket bound")
        if len(set(bs)) != len(bs):
            raise MetricError(f"{name}: duplicate bucket bounds {bs}")
        self.buckets: Tuple[float, ...] = bs

    def observe(self, value: Number, labels: LabelsArg = ()) -> None:
        lv = self._labels_tuple(labels)
        v = float(value)
        with self._lock:
            st = self._series.get(lv)
            if st is None:
                st = self._series[lv] = {
                    "count": 0,
                    "sum": 0.0,
                    "slots": [0] * (len(self.buckets) + 1),
                }
            st["count"] += 1
            st["sum"] += v
            st["slots"][bisect.bisect_left(self.buckets, v)] += 1

    def get(self, labels: LabelsArg = ()) -> Optional[dict]:
        lv = self._labels_tuple(labels)
        with self._lock:
            st = self._series.get(lv)
            return None if st is None else {**st, "slots": list(st["slots"])}

    def series(self) -> Dict[Tuple[str, ...], dict]:
        with self._lock:
            return {
                k: {**st, "slots": list(st["slots"])}
                for k, st in self._series.items()
            }

    def _sample_dict(self, st: dict) -> dict:
        """The snapshot sample for one series state: count/sum plus the
        cumulative Prometheus ``le`` bucket map. Subclasses (the latency
        histogram) extend this — snapshot() delegates here so every
        exporter sees their extra keys with no exporter changes."""
        cum, buckets = 0, {}
        for le, n in zip(self.buckets, st["slots"]):
            cum += n
            buckets[format_le(le)] = cum
        buckets["+Inf"] = st["count"]
        return {"count": st["count"], "sum": st["sum"], "buckets": buckets}

    def _same_definition(self, other) -> bool:
        return super()._same_definition(other) and self.buckets == other.buckets


class Registry:
    """Named metric registry. Registration is idempotent for an identical
    definition and loud (MetricError) for a conflicting one — a silent
    re-type would corrupt every exporter downstream."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}  # guarded-by: self._lock

    def _register(self, cls, name: str, help: str, labelnames, **kw) -> _Metric:
        if not name.replace("_", "").replace(":", "").isalnum() or name[0].isdigit():
            raise MetricError(f"invalid metric name {name!r}")
        candidate = cls(self, name, help, labelnames, **kw)
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not existing._same_definition(candidate):
                    raise MetricError(
                        f"metric {name!r} already registered as {existing.kind} "
                        f"with labels {existing.labelnames}"
                    )
                return existing
            self._metrics[name] = candidate
            return candidate

    def counter(self, name: str, help: str = "", labelnames=()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames=()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(
        self, name: str, help: str = "", labelnames=(), buckets=DEFAULT_TIME_BUCKETS
    ) -> Histogram:
        return self._register(Histogram, name, help, labelnames, buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return [self._metrics[n] for n in sorted(self._metrics)]

    def snapshot(self) -> dict:
        """{name: {type, help, labelnames, samples: [...]}} — plain dicts
        only, directly json.dump-able. Counter/gauge samples carry
        ``value``; histogram samples carry ``count``/``sum`` and the
        cumulative ``buckets`` {le: count} map (Prometheus semantics)."""
        out: dict = {}
        for m in self.metrics():
            samples = []
            for lv, st in sorted(m.series().items()):
                labels = dict(zip(m.labelnames, lv))
                if isinstance(m, Histogram):
                    samples.append({"labels": labels, **m._sample_dict(st)})
                else:
                    samples.append({"labels": labels, "value": st})
            out[m.name] = {
                "type": m.kind,
                "help": m.help,
                "labelnames": list(m.labelnames),
                "samples": samples,
            }
        return out

    def reset(self) -> None:
        """Clear every series; metric definitions stay registered."""
        for m in self.metrics():
            m.clear()


def format_le(bound: float) -> str:
    """Prometheus bucket-bound formatting: integral bounds render without a
    trailing .0 ("1" not "1.0"), matching client_python."""
    if bound == int(bound):
        return str(int(bound))
    return repr(bound)


# The process-wide default registry every instrumented module registers on.
REGISTRY = Registry()


def counter(name: str, help: str = "", labelnames=()) -> Counter:
    return REGISTRY.counter(name, help, labelnames)


def gauge(name: str, help: str = "", labelnames=()) -> Gauge:
    return REGISTRY.gauge(name, help, labelnames)


def histogram(name: str, help: str = "", labelnames=(), buckets=DEFAULT_TIME_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, help, labelnames, buckets=buckets)


def snapshot() -> dict:
    return REGISTRY.snapshot()


def reset() -> None:
    REGISTRY.reset()
