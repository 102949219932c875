"""The epoch-flip pricing authority: flip-now vs accumulate-more.

Counterpart of ``roaringbitmap_tpu/cost/epoch.py``, with the same
schema, curves, clamps and refit. ``serve/epochs.py`` (``maybe_flip``)
and ``durable/store.py`` (``maybe_persist``) price their verdicts here and
record the ``epoch.flip`` and ``durable.persist`` joins it refits from.

The epoch flip (serve/epochs.py) trades **staleness** against **repack
amortization**: flipping early makes pending mutations queryable sooner
(freshness) but pays the flip wall (reader drain + writer stream + O(k)
delta repack) more often; accumulating amortizes the flip over more
batches but lets ingest->queryable lag grow. ``EpochStore.maybe_flip``
prices both sides through this model and records the verdict as a
priced ``epoch.flip`` decision; a taken flip is joined with its measured
wall in the decision–outcome ledger, so the error-ratio rows score the
curve and :meth:`refit_from_outcomes` moves the coefficients toward this
host's measured truth — the same measured-not-guessed discipline as
every other authority, behind the same ``cost/`` facade protocol.

Model shape::

    flip:       flip_overhead_us + values * repack_value_us
                + readers * drain_reader_us                   (joined)
    accumulate: staleness_s * staleness_us_per_s * depth      (not joined)

``flip_overhead_us`` (seal + publish bookkeeping), ``repack_value_us``
(per pending mutation value — the writer stream + delta scatter scale
with the drained volume), and ``drain_reader_us`` (per in-flight reader
pin the drain stage must wait out — under concurrent load the drain
wait IS the flip wall, exactly like the admission model's per-slot
queue term) are HOST constants the refit learns from joined flips. ``staleness_us_per_s`` is the declared
**exchange rate** — how many µs of flip work one batch-second of
staleness is worth. It is policy, not physics: no measured wall can
refit it, so it is excluded from the refit and persisted as declared
(operators tune it against their freshness SLO; the
``freshness-lag-breach`` sentinel rule is the backstop when the rate is
set too patient).

Accumulate verdicts are decision-logged but never joined (nothing
executes); the freshness histograms own the cost of waiting.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional

SCHEMA = "rb_tpu_epoch_cost/1"

ENGINES = ("flip", "accumulate")
# the durable half: persist-now writes the published epoch's
# frozen artifact to disk; skip leaves it memory-only and exposed
PERSIST_ENGINES = ("persist", "skip")

# structural-prior defaults (µs): a flip drains readers (condition
# round-trip), streams the merged values through the writer, and patches
# k rows in place; first joined flips refit the host constants
DEFAULT_COEFFS = {
    "flip_overhead_us": 2000.0,
    "repack_value_us": 2.0,
    "drain_reader_us": 2000.0,  # ~one request service time per pin
    # declared exchange rate, never refit: one batch-second of staleness
    # is worth 10 ms of flip work. With the x-depth multiplier this
    # yields a flip period of sqrt(flip_us / (rate_us_per_s * writes_per_s))
    # — patient enough that a quiescent flip's wall amortizes below the
    # 10% ingest-tax budget at serving load, eager enough that the
    # freshness-lag-breach rule (2 s warn) never has to page first
    "staleness_us_per_s": 10000.0,
    # durable persist: an atomic snapshot pays a fixed
    # tmp-dir + manifest + rename overhead plus a per-KiB serialize +
    # write + fsync rate; joined durable.persist outcomes refit both
    "persist_overhead_us": 5000.0,
    "persist_kb_us": 30.0,
    # declared exchange rate, never refit: each published-but-unpersisted
    # epoch is worth 20 ms of persist work per flip tick — a crash loses
    # exactly the unpersisted suffix, so exposure scales with how many
    # epochs of lineage sit only in RAM. Policy, not physics (operators
    # tune it against their durability SLO; the epoch-persist-stall
    # sentinel rule is the backstop when the rate is set too patient)
    "durability_us_per_epoch": 20000.0,
}
# refit clamps (the house admission-model discipline)
MAX_STEP = 8.0
MAX_SCALE = 256.0
# the refit learns these; staleness_us_per_s stays declared
REFIT_KEYS = ("flip_overhead_us", "repack_value_us", "drain_reader_us")
# persist-side host constants, refit from a SEPARATE durable.persist
# ratio pool (disk bandwidth and flip wall drift independently);
# durability_us_per_epoch stays declared
PERSIST_REFIT_KEYS = ("persist_overhead_us", "persist_kb_us")


class EpochFlipModel:
    """Thread-safe epoch-flip cost curves. Reads are lock-free dict gets
    (atomic under the GIL); refits swap under a leaf lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self.coeffs: Dict[str, float] = dict(DEFAULT_COEFFS)
        self.provenance = "default"

    # -- pricing -------------------------------------------------------------

    def predict_us(self, verdict: str, rows: int = 0, readers: int = 0) -> float:
        """Predicted flip wall (µs) for draining ``rows`` pending
        mutation values now, with ``readers`` in-flight pins the drain
        stage must wait out — what the ``epoch.flip`` decision records
        as ``est_us["flip"]`` and the outcome join scores."""
        c = self.coeffs
        if verdict != "flip":
            raise ValueError(f"predict_us prices the flip engine, got {verdict!r}")
        return round(
            c["flip_overhead_us"]
            + max(0, int(rows)) * c["repack_value_us"]
            + max(0, int(readers)) * c["drain_reader_us"],
            3,
        )

    def predict_persist_us(self, artifact_kb: float) -> float:
        """Predicted persist wall (µs) for snapshotting an epoch whose
        frozen artifact is ``artifact_kb`` KiB — what the
        ``durable.persist`` decision records as ``est_us["persist"]``
        and the outcome join scores against the measured wall."""
        c = self.coeffs
        return round(
            c["persist_overhead_us"]
            + max(0.0, float(artifact_kb)) * c["persist_kb_us"],
            3,
        )

    def exposure_cost_us(self, epochs_behind: int) -> float:
        """The skip side: published-but-unpersisted lineage priced at the
        declared durability exchange rate. Scales with the unpersisted
        suffix depth — a crash loses exactly those epochs' warm state."""
        c = self.coeffs
        return round(
            max(0, int(epochs_behind)) * c["durability_us_per_epoch"], 3
        )

    def staleness_cost_us(self, staleness_s: float, depth: int = 1) -> float:
        """The accumulate side: pending staleness priced at the declared
        exchange rate, scaled by the number of waiting batches (more
        batches waiting = more data stale per second of patience)."""
        c = self.coeffs
        return round(
            max(0.0, float(staleness_s)) * c["staleness_us_per_s"]
            * max(1, int(depth)),
            3,
        )

    # -- refit from the decision-outcome ledger ------------------------------

    def refit_from_outcomes(
        self, samples: Optional[List[dict]] = None, min_samples: int = 2
    ) -> dict:
        """Scale the flip-side coefficients by the geometric mean of
        measured/predicted over the joined ``epoch.flip`` samples (the
        curve SHAPE is structural; the refit learns this host's
        constants). The declared staleness exchange rate never moves."""
        if samples is None:
            from ..observe import outcomes as _outcomes

            samples = _outcomes.tail()
        # two independent ratio pools: flip walls and persist walls are
        # different hardware (CPU drain/stream vs disk write + fsync)
        pools: Dict[str, List[float]] = {"flip": [], "persist": []}
        rejected = 0
        for s in samples:
            if s.get("site") == "epoch.flip" and s.get("engine") == "flip":
                pool = pools["flip"]
            elif (
                s.get("site") == "durable.persist"
                and s.get("engine") == "persist"
            ):
                pool = pools["persist"]
            else:
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
            pool.append(r)
        moved: Dict[str, dict] = {}
        with self._lock:
            coeffs = dict(self.coeffs)
            for pool_name, keys in (
                ("flip", REFIT_KEYS),
                ("persist", PERSIST_REFIT_KEYS),
            ):
                ratios = pools[pool_name]
                if len(ratios) < min_samples:
                    continue
                step = math.exp(sum(math.log(r) for r in ratios) / len(ratios))
                step = min(MAX_STEP, max(1.0 / MAX_STEP, step))
                for key in keys:
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
        current ``epoch.flip`` joins — 1.0 means the flip curve still
        prices live traffic truthfully. Stateless like the admission
        authority's drift: derived from the ledger tail so a refit
        naturally re-bases as new flips join."""
        from ..observe import outcomes as _outcomes

        logs: Dict[str, List[float]] = {"flip": [], "persist": []}
        for s in _outcomes.tail():
            if s.get("site") == "epoch.flip" and s.get("engine") == "flip":
                pool = logs["flip"]
            elif (
                s.get("site") == "durable.persist"
                and s.get("engine") == "persist"
            ):
                pool = logs["persist"]
            else:
                continue
            err = s.get("error_ratio")  # predicted / measured
            if err and err > 0:
                pool.append(math.log(1.0 / err))
        return {
            engine: round(math.exp(sum(pool) / len(pool)), 4)
            for engine, pool in logs.items()
            if pool
        }

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
                "persist_engines": list(PERSIST_ENGINES),
                "persist_refit_keys": list(PERSIST_REFIT_KEYS),
            }


MODEL = EpochFlipModel()
