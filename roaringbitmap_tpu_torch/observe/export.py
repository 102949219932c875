"""One-call exporters for the metrics registry: JSONL, Prometheus text
exposition, and the metrics sidecar.

Counterpart of ``roaringbitmap_tpu/observe/export.py``; the same
operations on both packages' registries give byte-identical JSONL and
Prometheus text.

* ``jsonl_lines()`` / ``write_jsonl(path)`` — one JSON object per line per
  series (counters/gauges carry ``value``; histograms carry ``count``,
  ``sum``, and cumulative ``buckets``).
* ``prometheus_text()`` / ``write_prometheus(path)`` — the Prometheus
  text exposition format (``# HELP``/``# TYPE`` + samples; histograms as
  ``_bucket{le=...}``/``_sum``/``_count``), scrapeable by a node exporter
  textfile collector or a pushgateway.
* ``sidecar_snapshot()`` / ``metrics_sidecar(path)`` — a structured
  summary (``kernel``/``layout``/``transfer_bytes``/``spans`` and the
  other blocks below) plus the full registry snapshot. The context
  manager writes atomically (tmp file + os.replace) on exit, even when the
  enclosed block raises. The health, fusion, serving, epochs, structure
  and durable blocks are derived from the registry alone, as in the JAX
  package. The JAX package's ``analysis`` block is left out: its analyzer
  is not part of this package.

Everything is a pure function of a ``Registry`` (default: the process
registry), so golden-format tests run against a private registry.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Iterator, List, Optional

from . import registry as _registry
from .histogram import SNAPSHOT_QUANTILES, LatencyHistogram
from .registry import Histogram, Registry, format_le

SIDECAR_SCHEMA = "rb_tpu_metrics/1"


def _reg(registry: Optional[Registry]) -> Registry:
    return _registry.REGISTRY if registry is None else registry


# ---------------------------------------------------------------------------
# JSONL
# ---------------------------------------------------------------------------


def jsonl_lines(registry: Optional[Registry] = None) -> List[str]:
    """One compact JSON object per metric series, in sorted name order."""
    lines = []
    for name, m in sorted(_reg(registry).snapshot().items()):
        for s in m["samples"]:
            rec = {"name": name, "type": m["type"], "labels": s["labels"]}
            if m["type"] == "histogram":
                rec.update(count=s["count"], sum=s["sum"], buckets=s["buckets"])
                if "quantiles" in s:  # latency histograms publish p50/p90/p99
                    rec["quantiles"] = s["quantiles"]
            else:
                rec["value"] = s["value"]
            lines.append(json.dumps(rec, sort_keys=True))
    return lines


def to_jsonl(registry: Optional[Registry] = None) -> str:
    lines = jsonl_lines(registry)
    return "\n".join(lines) + ("\n" if lines else "")


def write_jsonl(path: str, registry: Optional[Registry] = None) -> None:
    _atomic_write(path, to_jsonl(registry))


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(labels: dict, extra: Optional[str] = None) -> str:
    parts = [f'{k}="{_escape_label(v)}"' for k, v in labels.items()]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def prometheus_text(registry: Optional[Registry] = None) -> str:
    """The text exposition format, empty-series metrics included (HELP/TYPE
    only) so a scrape always shows what *could* be reported."""
    out: List[str] = []
    for m in _reg(registry).metrics():
        out.append(f"# HELP {m.name} {_escape_help(m.help)}")
        out.append(f"# TYPE {m.name} {m.kind}")
        if isinstance(m, Histogram):
            for lv, st in sorted(m.series().items()):
                labels = dict(zip(m.labelnames, lv))
                cum = 0
                for le, n in zip(m.buckets, st["slots"]):
                    cum += n
                    le_attr = 'le="%s"' % format_le(le)
                    out.append(f"{m.name}_bucket{_label_str(labels, le_attr)} {cum}")
                inf_attr = 'le="+Inf"'
                out.append(
                    f"{m.name}_bucket{_label_str(labels, inf_attr)} {st['count']}"
                )
                out.append(f"{m.name}_sum{_label_str(labels)} {st['sum']}")
                out.append(f"{m.name}_count{_label_str(labels)} {st['count']}")
                if isinstance(m, LatencyHistogram):
                    # summary-style quantile convenience samples next to the
                    # buckets (our own exporter's extension; scrapers that
                    # only understand TYPE histogram ignore them)
                    for q in SNAPSHOT_QUANTILES:
                        q_attr = 'quantile="%g"' % q
                        out.append(
                            f"{m.name}{_label_str(labels, q_attr)} "
                            f"{m._quantile_of_state(st, q)}"
                        )
        else:
            for lv, v in sorted(m.series().items()):
                labels = dict(zip(m.labelnames, lv))
                out.append(f"{m.name}{_label_str(labels)} {v}")
    return "\n".join(out) + ("\n" if out else "")


def write_prometheus(path: str, registry: Optional[Registry] = None) -> None:
    _atomic_write(path, prometheus_text(registry))


# ---------------------------------------------------------------------------
# metrics sidecar
# ---------------------------------------------------------------------------


def _counter_map(snap: dict, name: str, joined: bool = False) -> dict:
    """Flatten one counter's samples to {key: value}; multi-label keys are
    /-joined (the legacy ``insights.dispatch_counters()`` rendering)."""
    m = snap.get(name)
    if m is None:
        return {}
    out = {}
    for s in m["samples"]:
        vals = [s["labels"][n] for n in m["labelnames"]]
        key = "/".join(vals) if (joined or len(vals) != 1) else vals[0]
        out[key] = s["value"]
    return out


def _histogram_timings(snap: dict, name: str) -> dict:
    m = snap.get(name)
    if m is None:
        return {}
    out = {}
    for s in m["samples"]:
        c, total = s["count"], s["sum"]
        key = "/".join(s["labels"][n] for n in m["labelnames"])
        out[key] = {
            "count": c,
            "total_s": round(total, 6),
            "mean_ms": round(total / c * 1e3, 3) if c else 0.0,
        }
    return out


def _latency_summaries(registry: Registry) -> dict:
    """{metric: {label-values (/-joined): {count, sum, p50, p90, p99}}} for
    every latency histogram — the sidecar's quantile table."""
    out: dict = {}
    for m in registry.metrics():
        if not isinstance(m, LatencyHistogram):
            continue
        series = {}
        for lv, st in sorted(m.series().items()):
            series["/".join(lv)] = {
                "count": st["count"],
                "sum": round(st["sum"], 6),
                **{
                    "p%g" % (q * 100): round(m._quantile_of_state(st, q), 6)
                    for q in SNAPSHOT_QUANTILES
                },
            }
        out[m.name] = series
    return out


def _regret_block(snap: dict, registry: Registry) -> dict:
    """The decision-outcome ledger's sidecar block: per-site regret totals
    and error ratios derived from the registry histograms,
    join/orphan/anomaly volume, and the per-coefficient-cell drift gauges — a pure function of the registry (like everything in
    the sidecar), so it renders with no live process."""
    sites: dict = {}
    regret = registry.get(_registry.DECISION_REGRET_SECONDS)
    if isinstance(regret, LatencyHistogram):
        for lv, st in sorted(regret.series().items()):
            sites.setdefault("/".join(lv), {}).update(
                regret_events=st["count"],
                regret_s=round(st["sum"], 6),
            )
    err = snap.get(_registry.DECISION_ERROR_RATIO)
    if err is not None:
        err_m = registry.get(_registry.DECISION_ERROR_RATIO)
        for lv, st in sorted(err_m.series().items()):
            c = st["count"]
            sites.setdefault("/".join(lv), {}).update(
                error_samples=c,
                error_ratio_mean=round(st["sum"] / c, 4) if c else None,
            )
    return {
        "sites": sites,
        "joins": _counter_map(snap, _registry.OUTCOME_JOIN_TOTAL),
        "orphans": _counter_map(snap, _registry.OUTCOME_ORPHANS_TOTAL),
        "anomalies": _counter_map(snap, _registry.OUTCOME_ANOMALY_TOTAL),
        "drift": _counter_map(snap, _registry.COSTMODEL_DRIFT_RATIO, joined=True),
    }


def _fusion_block(snap: dict) -> dict:
    """The cross-query fusion sidecar block, derived purely from the
    registry like the regret/health blocks: window volume by
    outcome, queries through windows, step fates, the derived window
    occupancy (queries per drained window) and shared-subexpression hit
    ratio (deduped / planned), in-flight dedup joins, and the live queue
    depth, and the hedge verdicts and effective window bound."""
    batches = _counter_map(snap, _registry.FUSION_BATCH_TOTAL)
    steps = _counter_map(snap, _registry.FUSION_STEPS_TOTAL)
    queries = 0.0
    m = snap.get(_registry.FUSION_QUERIES_TOTAL)
    if m is not None:
        queries = float(sum(s.get("value", 0) for s in m["samples"]))
    depth = None
    g = snap.get(_registry.FUSION_QUEUED_COUNT)
    if g is not None:
        for s in g["samples"]:
            if not s["labels"]:
                depth = s["value"]
    window = None
    g = snap.get(_registry.FUSION_WINDOW_COUNT)
    if g is not None:
        for s in g["samples"]:
            if not s["labels"]:
                window = s["value"]
    n_batches = float(sum(batches.values()))
    executed = float(steps.get("executed", 0))
    deduped = float(steps.get("deduped", 0))
    planned = executed + deduped
    # hedge verdict volume: solo = hedged solo dispatches,
    # window = priced window verdicts; the rate is solo over all verdicts
    hedges = _counter_map(snap, _registry.FUSION_HEDGE_TOTAL)
    verdicts = float(sum(hedges.values()))
    return {
        "batches": batches,
        "queries": queries,
        "steps": steps,
        "occupancy": round(queries / n_batches, 3) if n_batches else None,
        "dedup_hit_ratio": round(deduped / planned, 4) if planned else None,
        "inflight": _counter_map(snap, _registry.QUERY_INFLIGHT_TOTAL),
        "queue_depth": depth,
        "hedges": hedges,
        "hedge_rate": round(float(hedges.get("solo", 0)) / verdicts, 4)
        if verdicts else None,
        "window": window,
    }


def _serving_block(snap: dict, registry: Registry) -> dict:
    """The serving tier's sidecar block, derived purely from the registry
    like the regret / health / fusion blocks: per-tenant rolling QPS,
    latency p50/p99 per (tenant, phase), admission verdict volume, the
    queue / in-flight depth gauges, per-tenant saturation, the resident
    byte shares and the declared p99 budgets."""
    tenants: dict = {}
    lat = registry.get(_registry.SERVE_LATENCY_SECONDS)
    if isinstance(lat, LatencyHistogram):
        for lv, st in sorted(lat.series().items()):
            tenant, phase = lv
            tenants.setdefault(tenant, {}).setdefault("latency", {})[phase] = {
                "count": st["count"],
                **{
                    "p%g" % (q * 100): round(lat._quantile_of_state(st, q), 6)
                    for q in SNAPSHOT_QUANTILES
                },
            }
    for name, key in (
        (_registry.SERVE_QPS, "qps"),
        (_registry.SERVE_SATURATION_RATIO, "saturation"),
        (_registry.SERVE_TENANT_BYTES, "bytes"),
        (_registry.SERVE_SLO_BUDGET_SECONDS, "slo_budget_s"),
    ):
        m = snap.get(name)
        if m is None:
            continue
        for s in m["samples"]:
            tenant = s["labels"].get("tenant")
            if tenant is not None:
                tenants.setdefault(tenant, {})[key] = s["value"]

    def _gauge(name):
        m = snap.get(name)
        if m is not None:
            for s in m["samples"]:
                if not s["labels"]:
                    return s["value"]
        return None

    return {
        "tenants": tenants,
        "admit": _counter_map(snap, _registry.SERVE_ADMIT_TOTAL, joined=True),
        "requests": _counter_map(snap, _registry.SERVE_REQUESTS_TOTAL, joined=True),
        "queue_depth": _gauge(_registry.SERVE_QUEUE_COUNT),
        "inflight": _gauge(_registry.SERVE_INFLIGHT_COUNT),
    }


def _epochs_block(snap: dict, registry: Registry) -> dict:
    """The epoch ledger's sidecar block, derived purely from
    the registry like the serving/fusion blocks so a ``--from`` rendering
    needs no live process: the current epoch gauge, live mutation-log
    depth, flip volume by outcome, per-tenant freshness p50/p99
    (ingest->queryable lag), ingest batch volume by tenant, and the flip
    stage latency decomposition. Epoch LINEAGE is process-local (the
    EpochStore's bounded ledger) and rides ``insights.epochs()`` /
    flight bundles, never the registry — epoch ids are unbounded and
    must not mint series."""
    freshness: dict = {}
    fr = registry.get(_registry.SERVE_FRESHNESS_SECONDS)
    if isinstance(fr, LatencyHistogram):
        for lv, st in sorted(fr.series().items()):
            freshness[lv[0]] = {
                "count": st["count"],
                **{
                    "p%g" % (q * 100): round(fr._quantile_of_state(st, q), 6)
                    for q in SNAPSHOT_QUANTILES
                },
            }
    stages: dict = {}
    fs = registry.get(_registry.SERVE_FLIP_STAGE_SECONDS)
    if isinstance(fs, LatencyHistogram):
        for lv, st in sorted(fs.series().items()):
            stages[lv[0]] = {
                "count": st["count"],
                "sum": round(st["sum"], 6),
                "p99": round(fs._quantile_of_state(st, 0.99), 6),
            }
    def _gauge(name):
        m = snap.get(name)
        if m is not None:
            for s in m["samples"]:
                if not s["labels"]:
                    return s["value"]
        return None
    return {
        "epoch": _gauge(_registry.SERVE_EPOCH_COUNT),
        "mutlog_depth": _gauge(_registry.SERVE_MUTLOG_COUNT),
        "flips": _counter_map(snap, _registry.SERVE_EPOCH_FLIP_TOTAL),
        "ingest": _counter_map(snap, _registry.SERVE_INGEST_TOTAL),
        "freshness": freshness,
        "flip_stages": stages,
    }


def _structure_block(snap: dict) -> dict:
    """The structure observatory's sidecar block, derived purely from
    the registry like every block here: the container-format
    census, actual/optimal serialized bytes + drift ratio, the run
    fragmentation p99 and epoch-delta accretion depth gauges, and the
    maintenance tier's volume (passes by outcome, reclaimed bytes,
    rewritten keys, pass wall time)."""
    def _gauge(name):
        m = snap.get(name)
        if m is not None:
            for s in m["samples"]:
                if not s["labels"]:
                    return s["value"]
        return None
    bytes_by_kind = _counter_map(snap, _registry.STRUCTURE_BYTES)
    wall = None
    m = snap.get(_registry.SERVE_MAINTAIN_SECONDS)
    if m is not None:
        for s in m["samples"]:
            if not s["labels"]:
                wall = {"count": s["count"], "sum": round(s["sum"], 6)}
    return {
        "containers": _counter_map(snap, _registry.STRUCTURE_CONTAINERS),
        "bytes": bytes_by_kind,
        "drift_ratio": _gauge(_registry.STRUCTURE_DRIFT_RATIO),
        "fragmentation_p99": _gauge(_registry.STRUCTURE_FRAGMENTATION_COUNT),
        "accretion_depth": _gauge(_registry.STRUCTURE_ACCRETION_COUNT),
        "passes": _counter_map(snap, _registry.SERVE_MAINTAIN_TOTAL),
        "reclaimed_bytes": _gauge(_registry.SERVE_MAINTAIN_RECLAIMED_BYTES_TOTAL),
        "rewritten_keys": _gauge(_registry.SERVE_MAINTAIN_KEYS_TOTAL),
        "pass_wall": wall,
    }


def _durable_block(snap: dict) -> dict:
    """The durable-epoch sidecar block, derived purely from the registry
    like every block here: the last persisted vs serving
    epoch, the frozen artifact's bytes, persist volume by outcome +
    cumulative bytes, the persist stage latency decomposition, pending
    (unpersisted) epoch depth, last persist wall seconds, recovery
    outcome volume, and residency demotions by rung. Recovery
    PROVENANCE (which directory, torn-skip list) is process-local and
    rides ``insights.durable()`` / flight bundles, never the registry —
    paths are unbounded label values and must not mint series."""
    def _gauge(name):
        m = snap.get(name)
        if m is not None:
            for s in m["samples"]:
                if not s["labels"]:
                    return s["value"]
        return None
    stages: dict = {}
    m = snap.get(_registry.DURABLE_PERSIST_STAGE_SECONDS)
    if m is not None:
        for s in m["samples"]:
            if s["labels"]:
                stages[s["labels"]["stage"]] = {
                    "count": s["count"],
                    "sum": round(s["sum"], 6),
                }
    return {
        "epoch": _gauge(_registry.DURABLE_EPOCH_COUNT),
        "serving_epoch": _gauge(_registry.SERVE_EPOCH_COUNT),
        "pending_epochs": _gauge(_registry.DURABLE_PENDING_COUNT),
        "artifact_bytes": _gauge(_registry.DURABLE_ARTIFACT_BYTES),
        "persist_wall_s": _gauge(_registry.DURABLE_PERSIST_WALL_SECONDS),
        "persists": _counter_map(snap, _registry.DURABLE_PERSIST_TOTAL),
        "persist_bytes": _gauge(_registry.DURABLE_PERSIST_BYTES_TOTAL),
        "persist_stages": stages,
        "recoveries": _counter_map(snap, _registry.DURABLE_RECOVERY_TOTAL),
        "demotions": _counter_map(snap, _registry.DURABLE_DEMOTE_TOTAL),
    }


def _health_block(snap: dict) -> dict:
    """The health sentinel's sidecar block, derived PURELY from the
    registry gauges (like the regret block) so a rendering needs no live
    sentinel: the process status enum, per-rule
    state enums, and the actuation counters. ``status`` is None when no
    sentinel tick ever exported (the gauge has no unlabeled series)."""
    status = None
    m = snap.get(_registry.HEALTH_STATUS)
    if m is not None:
        for s in m["samples"]:
            if not s["labels"]:
                status = s["value"]
    names = {0: "green", 1: "yellow", 2: "red"}
    return {
        "status": status,
        "status_name": names.get(status),
        "rules": _counter_map(snap, _registry.HEALTH_RULE_STATE),
        "actuations": _counter_map(
            snap, _registry.HEALTH_ACTUATION_TOTAL, joined=True
        ),
    }


def _analysis_block(snap: dict) -> dict:
    """The static-analysis sidecar block, derived PURELY from the registry
    like every block here: per-rule finding counts from the two analyzer
    tiers — ``rb_tpu_analysis_findings_total{rule}`` (the lexical per-file
    rules) and ``rb_tpu_analysis_contract_findings_total{rule}`` (the
    whole-program contract tier). The CLI (``python -m
    roaringbitmap_tpu_torch.analysis``) materializes a zero series for
    every rule it ran, so an empty map means "analyzer never ran in this
    process" while an explicit ``{rule: 0}`` means "ran and found
    nothing"."""
    lexical = _counter_map(snap, _registry.ANALYSIS_FINDINGS_TOTAL)
    contracts = _counter_map(snap, _registry.ANALYSIS_CONTRACT_FINDINGS_TOTAL)
    return {
        "lexical": lexical,
        "contracts": contracts,
        "total": int(sum(lexical.values()) + sum(contracts.values())),
    }


def sidecar_snapshot(registry: Optional[Registry] = None) -> dict:
    """The structured summary the sidecar persists: ``kernel``/``layout``/
    ``transfer_bytes``/``spans`` and the other blocks, with the full
    registry snapshot under ``registry`` for anything the summary flattens
    away. ``probes`` is empty: the port never probes for a lowering."""
    snap = _reg(registry).snapshot()
    return {
        "schema": SIDECAR_SCHEMA,
        "generated_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "kernel": _counter_map(snap, _registry.KERNEL_DISPATCH_TOTAL, joined=True),
        "layout": _counter_map(snap, _registry.STORE_LAYOUT_TOTAL),
        "transfer_bytes": _counter_map(snap, _registry.STORE_TRANSFER_BYTES_TOTAL),
        "pairwise": _counter_map(snap, _registry.BATCH_PAIRWISE_TOTAL),
        "serial_bytes": _counter_map(snap, _registry.SERIAL_BYTES_TOTAL),
        "probes": {},
        "timings": _histogram_timings(snap, _registry.HOST_OP_SECONDS),
        "spans": _histogram_timings(snap, _registry.SPAN_SECONDS),
        "latency": _latency_summaries(_reg(registry)),
        "lock_wait": _histogram_timings(snap, _registry.LOCK_WAIT_SECONDS),
        "compile": _counter_map(snap, _registry.COMPILE_TOTAL),
        "hbm_drift": _counter_map(snap, _registry.HBM_ACCOUNTING_DRIFT_BYTES),
        "decisions": _counter_map(snap, _registry.DECISION_TOTAL),
        "regret": _regret_block(snap, _reg(registry)),
        "health": _health_block(snap),
        "fusion": _fusion_block(snap),
        "serving": _serving_block(snap, _reg(registry)),
        "epochs": _epochs_block(snap, _reg(registry)),
        "structure": _structure_block(snap),
        "durable": _durable_block(snap),
        "analysis": _analysis_block(snap),
        "registry": snap,
    }


@contextlib.contextmanager
def metrics_sidecar(path: str, registry: Optional[Registry] = None) -> Iterator[str]:
    """Atomically write ``sidecar_snapshot()`` to ``path`` when the block
    exits — success OR failure, so crashed runs keep their telemetry."""
    try:
        yield path
    finally:
        _atomic_write(path, json.dumps(sidecar_snapshot(registry), indent=1) + "\n")


def _atomic_write(path: str, content: str) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".metrics.", suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(content)
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
