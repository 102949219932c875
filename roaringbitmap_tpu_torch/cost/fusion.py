"""The fusion-batch pricing authority: batch-vs-solo cost curves for the
micro-batching executor.

Counterpart of ``roaringbitmap_tpu/cost/fusion.py``, with the same
curves and coefficients, so a window gets the same verdict in both
packages. The fusion executor (``query/fusion.py``) decides per drained
window whether coalescing the queries' plan steps into merged per-tier
dispatches beats running the queries back to back; it prices both in
microseconds from two linear curves (engines ``fused`` | ``per-query``)::

    per-query: steps * solo_step_us          (every step pays a dispatch)
    fused:     tiers * tier_us + steps * merge_step_us
               (one dispatch per merged tier + per-step merge overhead;
                `steps` is the post-dedup unique step count, so the
                shared-subexpression saving prices in by construction)

The defaults encode the structural prior (per-dispatch overhead is the
dominant per-step cost; merging N same-class steps pays one dispatch and
a small per-step concat) and predict ``fused`` ahead for any window with
more steps than tiers. :meth:`FusionBatchModel.refit_from_outcomes`
scales the curves from measured samples — by default the outcome
ledger's joined ``fusion.batch`` verdicts, which every drained window
records. The hedge and window-autotune pricing (the hedge's
``slack_penalty`` coefficient and ``fusion.hedge`` samples;
``hedge_estimate``, ``choose_dispatch``, ``window_for_budget``,
``drift``) wait for the serving tier and the cost facade (ROADMAP Queue A
items 4 and 5). The persistence (``to_dict`` / ``from_dict`` /
``curves_view``) keeps the JAX package's schema, and ``from_dict``
ignores the keys the port does not price, so a state the JAX package
saved loads here.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional

SCHEMA = "rb_tpu_fusion_cost/1"

ENGINES = ("fused", "per-query")

# structural-prior defaults (µs): a solo plan step costs about one
# columnar-engine call's fixed overhead; a merged tier costs one such
# dispatch plus a small per-step concat/slice tax
DEFAULT_COEFFS = {
    "solo_step_us": 120.0,
    "tier_us": 150.0,
    "merge_step_us": 25.0,
}
# refit clamps: one window cannot invert the verdict ordering outright,
# and coefficients stay in a sane decade band
MAX_STEP = 8.0
MAX_SCALE = 64.0


class FusionBatchModel:
    """Thread-safe batch-vs-solo cost curves. Reads are lock-free dict
    gets (atomic under the GIL); refits swap under a leaf lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self.coeffs: Dict[str, float] = dict(DEFAULT_COEFFS)
        self.provenance = "default"

    def estimate(self, steps: int, tiers: int) -> Dict[str, float]:
        """Per-engine predicted wall (µs) for a window of ``steps`` unique
        plan steps merging into ``tiers`` dispatches."""
        c = self.coeffs
        steps = max(1, int(steps))
        tiers = max(1, int(tiers))
        return {
            "per-query": round(steps * c["solo_step_us"], 3),
            "fused": round(
                tiers * c["tier_us"] + steps * c["merge_step_us"], 3
            ),
        }

    def choose(self, steps: int, tiers: int) -> str:
        est = self.estimate(steps, tiers)
        return "fused" if est["fused"] <= est["per-query"] else "per-query"

    def refit_from_outcomes(
        self, samples: Optional[List[dict]] = None, min_samples: int = 2
    ) -> dict:
        """Scale each engine's curve by the geometric mean of
        measured/predicted over its joined samples (default: the outcome
        ledger's tail), each a dict with ``site``, ``engine``,
        ``predicted_us`` and ``measured_s``: the curve SHAPE is
        structural, the refit learns this host's constants.
        ``per-query`` scales ``solo_step_us``; ``fused`` scales
        ``tier_us`` and ``merge_step_us`` together (their ratio is the
        structural prior; a window's wall cannot separate them). Only
        ``fusion.batch`` samples count: the JAX package's solo
        ``fusion.hedge`` joins come with the hedged dispatch (ROADMAP
        Queue A item 5)."""
        if samples is None:
            from ..observe import outcomes as _outcomes

            samples = _outcomes.tail()
        ratios: Dict[str, List[float]] = {}
        rejected = 0
        for s in samples:
            if s.get("site") != "fusion.batch":
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
        scaled_keys = {
            "per-query": ("solo_step_us",),
            "fused": ("tier_us", "merge_step_us"),
        }
        with self._lock:
            coeffs = dict(self.coeffs)
            for engine, rs in ratios.items():
                if len(rs) < min_samples:
                    continue
                step = math.exp(sum(math.log(r) for r in rs) / len(rs))
                step = min(MAX_STEP, max(1.0 / MAX_STEP, step))
                for key in scaled_keys[engine]:
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


MODEL = FusionBatchModel()
