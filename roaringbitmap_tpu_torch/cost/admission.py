"""The admission pricing authority: predicted queue wait vs measured.

Counterpart of ``roaringbitmap_tpu/cost/admission.py``, with the same
schema, curves, clamps and refit.

The admission controller (serve/admission.py) decides, per request,
whether to admit immediately, park the request in the backpressure
queue, or shed it. The first two verdicts have a measurable execution —
the admission wall from verdict to grant — and the controller records
each as a priced ``serve.admit`` decision: ``est_us`` carries the
predicted wall for the verdict actually available (an admit predicts the
fixed bookkeeping cost; a queue verdict predicts ``depth *
queue_slot_us`` — one in-flight slot's expected service time per
request ahead). The decision–outcome ledger joins the measured wall
against the prediction, the error-ratio rows score the curve, and
:meth:`refit_from_outcomes` moves the coefficients toward this host's
measured truth — the same measured-not-guessed discipline as every
other authority, behind the same ``cost/`` facade protocol, so
``cost.refit_all()`` and the sentinel's drift actuation cover the
admission curve without special cases.

Model shape (two curves, engines ``admit`` | ``queue``)::

    admit: admit_us                      (fixed verdict bookkeeping)
    queue: depth * queue_slot_us         (expected wait per queued slot)

Shed verdicts are decision-logged but never joined (a shed has no
execution to measure); they are priced implicitly — the saturation
telemetry and the ``tenant-saturation`` sentinel rule own that signal.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional

SCHEMA = "rb_tpu_admission_cost/1"

ENGINES = ("admit", "queue")

# structural-prior defaults (µs): an admit is token-bucket arithmetic +
# a decision record; a queued request waits roughly one request service
# time per queue slot ahead of it — first traffic refits both
DEFAULT_COEFFS = {
    "admit_us": 30.0,
    "queue_slot_us": 2000.0,
}
# refit clamps (the house CARD_MODEL discipline): one window cannot move
# a coefficient more than MAX_STEP, and coefficients stay within a sane
# band of the structural prior
MAX_STEP = 8.0
MAX_SCALE = 256.0


class AdmissionModel:
    """Thread-safe admission cost curves. Reads are lock-free dict gets
    (atomic under the GIL); refits swap under a leaf lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self.coeffs: Dict[str, float] = dict(DEFAULT_COEFFS)
        self.provenance = "default"

    # -- pricing -------------------------------------------------------------

    def predict_us(self, verdict: str, depth: int = 0) -> float:
        """Predicted admission wall (µs) for one verdict at the current
        queue depth — what the ``serve.admit`` decision records as its
        ``est_us[verdict]`` and the outcome join scores."""
        c = self.coeffs
        if verdict == "queue":
            return round(max(1, int(depth) + 1) * c["queue_slot_us"], 3)
        return round(c["admit_us"], 3)

    # -- refit from the decision-outcome ledger ------------------------------

    def refit_from_outcomes(
        self, samples: Optional[List[dict]] = None, min_samples: int = 2
    ) -> dict:
        """Scale each engine's coefficient by the geometric mean of
        measured/predicted over its joined ``serve.admit`` samples (the
        curve SHAPE is structural; the refit learns this host's
        constants)."""
        if samples is None:
            from ..observe import outcomes as _outcomes

            samples = _outcomes.tail()
        ratios: Dict[str, List[float]] = {}
        rejected = 0
        for s in samples:
            if s.get("site") != "serve.admit":
                continue
            engine = s.get("engine")
            predicted = s.get("predicted_us")
            measured_s = s.get("measured_s")
            if engine not in ENGINES:
                continue
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
            ratios.setdefault(engine, []).append(r)
        moved: Dict[str, dict] = {}
        scaled_keys = {"admit": "admit_us", "queue": "queue_slot_us"}
        with self._lock:
            coeffs = dict(self.coeffs)
            for engine, rs in ratios.items():
                if len(rs) < min_samples:
                    continue
                step = math.exp(sum(math.log(r) for r in rs) / len(rs))
                step = min(MAX_STEP, max(1.0 / MAX_STEP, step))
                key = scaled_keys[engine]
                default = DEFAULT_COEFFS[key]
                new = coeffs[key] * step
                new = min(default * MAX_SCALE, max(default / MAX_SCALE, new))
                if new != coeffs[key]:
                    moved[key] = {
                        "from": round(coeffs[key], 3),
                        "to": round(new, 3),
                        "samples": len(rs),
                    }
                    coeffs[key] = new
            if moved:
                self.coeffs = coeffs
                self.provenance = "refit-from-traffic"
            provenance = self.provenance
        return {"moved": moved, "rejected": rejected, "provenance": provenance}

    def drift(self) -> Dict[str, float]:
        """{engine: geomean(measured/predicted)} over the ledger's
        current ``serve.admit`` joins — 1.0 means the admission curve
        still prices live traffic truthfully. Stateless, like the fusion
        authority's drift: derived from the ledger tail so a refit
        naturally re-bases it as new traffic arrives."""
        from ..observe import outcomes as _outcomes

        sums: Dict[str, List[float]] = {}
        for s in _outcomes.tail():
            if s.get("site") != "serve.admit":
                continue
            err = s.get("error_ratio")  # predicted / measured
            engine = s.get("engine")
            if engine in ENGINES and err and err > 0:
                sums.setdefault(engine, []).append(math.log(1.0 / err))
        return {
            engine: round(math.exp(sum(ls) / len(ls)), 4)
            for engine, ls in sorted(sums.items())
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
            return {"coeffs": dict(self.coeffs), "engines": list(ENGINES)}


MODEL = AdmissionModel()
