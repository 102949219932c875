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
  enclosed block raises. The JAX package's sidecar also carries health,
  fusion, serving, epoch, structure, durable and analysis blocks; each
  comes with the module that registers its metrics.

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
        "probes": {},
        "timings": _histogram_timings(snap, _registry.HOST_OP_SECONDS),
        "spans": _histogram_timings(snap, _registry.SPAN_SECONDS),
        "latency": _latency_summaries(_reg(registry)),
        "compile": _counter_map(snap, _registry.COMPILE_TOTAL),
        "decisions": _counter_map(snap, _registry.DECISION_TOTAL),
        "regret": _regret_block(snap, _reg(registry)),
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
