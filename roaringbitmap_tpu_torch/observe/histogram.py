"""Log-bucketed latency histograms with quantile snapshots.

Counterpart of ``roaringbitmap_tpu/observe/histogram.py``. The fixed
buckets of :class:`~.registry.Histogram` suit coarse host-phase
accounting; latency questions ("what is the p99 of a delta repack?") need
*relative* resolution across six orders of magnitude, so
:class:`LatencyHistogram` buckets on a log grid (default 8 buckets per
decade, 1 µs .. 100 s, ratio 10^(1/8) ≈ 1.33 between bounds) and answers
``quantile(q)`` by a cumulative walk plus linear interpolation inside the
landing bucket — the estimate is always within one bucket ratio of the
true order statistic.

Registered beside Counter/Gauge/Histogram on the same registry
(``latency_histogram(name, ...)``), it keeps the Prometheus ``histogram``
exposition (cumulative ``le`` buckets) and adds p50/p90/p99 snapshots:
``snapshot()``/JSONL samples carry a ``quantiles`` map, and the
Prometheus text exporter emits summary-style ``name{quantile="0.5"}``
samples next to the buckets (observe/export.py). Latency histograms
measure seconds, so their names end in ``_seconds``.

Pure stdlib. The package attribute ``observe.histogram`` is the plain
registry-histogram registration helper; this module is reached as
``from roaringbitmap_tpu_torch.observe.histogram import ...``.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

from . import registry as _registry
from .registry import Histogram, MetricError, Registry

# the quantiles every snapshot/export publishes (p50/p90/p99)
SNAPSHOT_QUANTILES: Tuple[float, ...] = (0.5, 0.9, 0.99)


def log_time_buckets(
    lo: float = 1e-6, hi: float = 100.0, per_decade: int = 8
) -> Tuple[float, ...]:
    """Upper bucket bounds on a log grid: ``lo * 10^(k/per_decade)`` until
    ``hi`` is covered, rounded to 4 significant digits so the Prometheus
    ``le`` labels stay readable. Defaults span 1 µs .. 100 s — sub-pack
    stages to the worst cold bucket build — at ratio ~1.33 per bucket."""
    if not (0 < lo < hi):
        raise MetricError(f"log_time_buckets: need 0 < lo < hi, got {lo}, {hi}")
    if per_decade < 1:
        raise MetricError(f"log_time_buckets: per_decade must be >= 1, got {per_decade}")
    out = []
    k = 0
    while True:
        b = float(f"{lo * 10.0 ** (k / per_decade):.4g}")
        out.append(b)
        if b >= hi:
            return tuple(out)
        k += 1


DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = log_time_buckets()


class LatencyHistogram(Histogram):
    """Log-bucketed histogram with quantile snapshots.

    Exposition ``kind`` stays ``"histogram"`` (the cumulative-``le`` form is
    what scrapers understand); the subclass adds the quantile estimator and
    folds p50/p90/p99 into every snapshot sample.
    """

    def __init__(
        self, registry, name, help, labelnames, buckets=DEFAULT_LATENCY_BUCKETS
    ):
        super().__init__(registry, name, help, labelnames, buckets=buckets)

    def _quantile_of_state(self, st: Mapping, q: float) -> float:
        """Estimate the ``q``-quantile from a series state dict: cumulative
        walk to the landing bucket, then linear interpolation between its
        edges. Values beyond the last bound clamp to it (the overflow
        bucket has no upper edge — a clamped answer beats a fabricated
        one). Caller holds the registry lock or owns a copied state."""
        count = st["count"]
        if count <= 0:
            return 0.0
        if not 0.0 <= q <= 1.0:
            raise MetricError(f"{self.name}: quantile {q} outside [0, 1]")
        rank = max(1.0, q * count)
        cum = 0
        for i, n in enumerate(st["slots"]):
            if n == 0:
                continue
            prev = cum
            cum += n
            if cum >= rank:
                if i >= len(self.buckets):  # overflow slot: clamp
                    return self.buckets[-1]
                hi = self.buckets[i]
                lo = self.buckets[i - 1] if i > 0 else 0.0
                return lo + (hi - lo) * ((rank - prev) / n)
        return self.buckets[-1]  # pragma: no cover - count>0 lands above

    def quantile(self, q: float, labels=()) -> float:
        """Point estimate of the ``q``-quantile for one labeled series
        (0.0 when the series has recorded nothing)."""
        st = self.get(labels)
        return 0.0 if st is None else self._quantile_of_state(st, q)

    def quantiles(
        self, labels=(), qs: Sequence[float] = SNAPSHOT_QUANTILES
    ) -> dict:
        """``{"p50": ..., "p90": ..., "p99": ...}`` for one series."""
        st = self.get(labels)
        return {
            _q_key(q): (0.0 if st is None else self._quantile_of_state(st, q))
            for q in qs
        }

    def _sample_dict(self, st: Mapping) -> dict:
        base = super()._sample_dict(st)
        base["quantiles"] = {
            _q_key(q): round(self._quantile_of_state(st, q), 9)
            for q in SNAPSHOT_QUANTILES
        }
        return base


def _q_key(q: float) -> str:
    """0.5 -> "p50", 0.99 -> "p99" (the sidecar/JSONL key form)."""
    return "p" + format(q * 100, "g")


def latency_histogram(
    name: str,
    help: str = "",
    labelnames=(),
    buckets=DEFAULT_LATENCY_BUCKETS,
    registry: Optional[Registry] = None,
) -> LatencyHistogram:
    """Register (idempotently) a :class:`LatencyHistogram` on ``registry``
    (default: the process registry). Same conflict-loudness as the other
    registration helpers; latency metric names must end in ``_seconds``."""
    if not name.endswith("_seconds"):
        raise MetricError(
            f"latency histogram {name!r} must end in '_seconds' "
            "(latency histograms measure seconds)"
        )
    reg = _registry.REGISTRY if registry is None else registry
    return reg._register(
        LatencyHistogram, name, help, labelnames, buckets=buckets
    )
