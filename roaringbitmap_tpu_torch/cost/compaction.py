"""The compaction pricing authority: compact-now vs let-it-ride.

Counterpart of ``roaringbitmap_tpu/cost/compaction.py``, with the same
schema, curves, clamps and refit. ``serve/maintain.py`` (``run_pass``)
prices its verdicts here and records the ``serve.maintain`` joins it
refits from.

The background maintenance pass (serve/maintain.py) trades **structure
drift** against **pass wall**: compacting now re-runs format selection
over write-hot keys, merges accumulated epoch deltas, and re-packs cold
working sets — reclaiming the bytes the warm delta path leaked past the
size rule — but pays a rewrite wall inside the epoch-flip machinery;
riding lets ingest keep the hot path O(1) but the bytes-vs-optimal
drift ratio and the delta accretion depth grow without bound.
``serve.maintain`` prices both sides through this model and records the
verdict as a priced ``serve.maintain`` decision; a taken pass is joined
with its measured wall in the decision–outcome ledger, so the
error-ratio rows score the curve and :meth:`refit_from_outcomes` moves
the coefficients toward this host's measured truth — the same
measured-not-guessed discipline as every other authority, behind the
same ``cost/`` facade protocol.

Model shape::

    compact: pass_overhead_us + keys * rewrite_key_us
             + batches * merge_batch_us                      (joined)
    ride:    excess_kb * drift_us_per_kb * depth             (not joined)

``pass_overhead_us`` (epoch-flip brackets: drain + publish + the
bit-identity audit), ``rewrite_key_us`` (per dirty chunk key re-run
through ``run_optimize`` — serialize + compare + rebuild scale with the
touched set), and ``merge_batch_us`` (per accumulated epoch delta batch
folded into the base) are HOST constants the refit learns from joined
passes. ``drift_us_per_kb`` is the declared **exchange rate** — how
many µs of rewrite work one KiB of bytes-over-optimal drift is worth
per decision. It is policy, not physics: no measured wall can refit it,
so it is excluded from the refit and persisted as declared (operators
tune it against their memory budget; the ``structure-drift`` sentinel
rule is the backstop when the rate is set too patient).

Ride verdicts are decision-logged but never joined (nothing executes);
the structure gauges own the cost of waiting.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional

SCHEMA = "rb_tpu_compaction_cost/1"

ENGINES = ("compact", "ride")

# structural-prior defaults (µs): a pass drains readers, rewrites the
# dirty keys through run_optimize, folds pending delta batches, and
# audits bit-identity; first joined passes refit the host constants
DEFAULT_COEFFS = {
    "pass_overhead_us": 3000.0,
    "rewrite_key_us": 40.0,
    "merge_batch_us": 500.0,
    # declared exchange rate, never refit: one KiB of bytes-over-optimal
    # drift is worth 50 µs of rewrite work per decision. Patient enough
    # that a freshly-flushed working set is never churned for noise,
    # eager enough that the structure-drift rule (1.3x warn band) only
    # pages when the authority is wedged, not when it is merely thrifty
    "drift_us_per_kb": 50.0,
}
# refit clamps (the house admission-model discipline)
MAX_STEP = 8.0
MAX_SCALE = 256.0
# the refit learns these; drift_us_per_kb stays declared
REFIT_KEYS = ("pass_overhead_us", "rewrite_key_us", "merge_batch_us")


class CompactionModel:
    """Thread-safe compaction cost curves. Reads are lock-free dict gets
    (atomic under the GIL); refits swap under a leaf lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self.coeffs: Dict[str, float] = dict(DEFAULT_COEFFS)
        self.provenance = "default"

    # -- pricing -------------------------------------------------------------

    def predict_us(self, verdict: str, keys: int = 0, batches: int = 0) -> float:
        """Predicted pass wall (µs) for rewriting ``keys`` dirty chunk
        keys now with ``batches`` accumulated epoch delta batches to
        fold — what the ``serve.maintain`` decision records as
        ``est_us["compact"]`` and the outcome join scores."""
        c = self.coeffs
        if verdict != "compact":
            raise ValueError(f"predict_us prices the compact engine, got {verdict!r}")
        return round(
            c["pass_overhead_us"]
            + max(0, int(keys)) * c["rewrite_key_us"]
            + max(0, int(batches)) * c["merge_batch_us"],
            3,
        )

    def ride_cost_us(self, excess_bytes: float, depth: int = 1) -> float:
        """The let-it-ride side: bytes-over-optimal drift priced at the
        declared exchange rate, scaled by the delta accretion depth
        (more batches accreted = more rewrite debt per byte of
        patience)."""
        c = self.coeffs
        return round(
            max(0.0, float(excess_bytes)) / 1024.0 * c["drift_us_per_kb"]
            * max(1, int(depth)),
            3,
        )

    # -- refit from the decision-outcome ledger ------------------------------

    def refit_from_outcomes(
        self, samples: Optional[List[dict]] = None, min_samples: int = 2
    ) -> dict:
        """Scale the compact-side coefficients by the geometric mean of
        measured/predicted over the joined ``serve.maintain`` samples
        (the curve SHAPE is structural; the refit learns this host's
        constants). The declared drift exchange rate never moves."""
        if samples is None:
            from ..observe import outcomes as _outcomes

            samples = _outcomes.tail()
        ratios: List[float] = []
        rejected = 0
        for s in samples:
            if s.get("site") != "serve.maintain" or s.get("engine") != "compact":
                continue
            predicted = s.get("predicted_us")
            measured_s = s.get("measured_s")
            try:
                predicted = float(predicted)
                measured_us = float(measured_s) * 1e6
            except (TypeError, ValueError):
                rejected += 1
                continue
            if not (
                predicted > 0 and measured_us > 0
                and math.isfinite(predicted) and math.isfinite(measured_us)
            ):
                rejected += 1
                continue
            r = measured_us / predicted
            if not (2.0 ** -20 <= r <= 2.0 ** 20):
                rejected += 1  # corrupt telemetry, not bias
                continue
            ratios.append(r)
        moved: Dict[str, dict] = {}
        with self._lock:
            coeffs = dict(self.coeffs)
            if len(ratios) >= min_samples:
                step = math.exp(sum(math.log(r) for r in ratios) / len(ratios))
                step = min(MAX_STEP, max(1.0 / MAX_STEP, step))
                for key in REFIT_KEYS:
                    default = DEFAULT_COEFFS[key]
                    new = coeffs[key] * step
                    new = min(default * MAX_SCALE, max(default / MAX_SCALE, new))
                    if new != coeffs[key]:
                        moved[key] = {
                            "from": round(coeffs[key], 3),
                            "to": round(new, 3),
                            "samples": len(ratios),
                        }
                        coeffs[key] = new
            if moved:
                self.coeffs = coeffs
                self.provenance = "refit-from-traffic"
            provenance = self.provenance
        return {"moved": moved, "rejected": rejected, "provenance": provenance}

    def drift(self) -> Dict[str, float]:
        """{engine: geomean(measured/predicted)} over the ledger's
        current ``serve.maintain`` joins — 1.0 means the compaction
        curve still prices live passes truthfully. Stateless like the
        epoch authority's drift: derived from the ledger tail so a
        refit naturally re-bases as new passes join."""
        from ..observe import outcomes as _outcomes

        logs: List[float] = []
        for s in _outcomes.tail():
            if s.get("site") != "serve.maintain" or s.get("engine") != "compact":
                continue
            err = s.get("error_ratio")  # predicted / measured
            if err and err > 0:
                logs.append(math.log(1.0 / err))
        if not logs:
            return {}
        return {"compact": round(math.exp(sum(logs) / len(logs)), 4)}

    # -- one persistence lifecycle (cost facade protocol) --------------------

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "schema": SCHEMA,
                "coeffs": dict(self.coeffs),
                "provenance": self.provenance,
            }

    def from_dict(self, d: dict) -> bool:
        if not isinstance(d, dict) or d.get("schema") != SCHEMA:
            return False
        coeffs = d.get("coeffs")
        if not isinstance(coeffs, dict):
            return False
        clean = dict(DEFAULT_COEFFS)
        for key, default in DEFAULT_COEFFS.items():
            c = coeffs.get(key, default)
            try:
                c = float(c)
            except (TypeError, ValueError):
                return False
            if not (default / MAX_SCALE <= c <= default * MAX_SCALE):
                return False
            clean[key] = c
        with self._lock:
            self.coeffs = clean
            self.provenance = str(d.get("provenance") or "default")
        return True

    def reset(self) -> None:
        with self._lock:
            self.coeffs = dict(DEFAULT_COEFFS)
            self.provenance = "default"

    def curves_view(self) -> dict:
        with self._lock:
            return {
                "coeffs": dict(self.coeffs),
                "engines": list(ENGINES),
                "refit_keys": list(REFIT_KEYS),
            }


MODEL = CompactionModel()
