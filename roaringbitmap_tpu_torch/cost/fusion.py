"""The fusion-batch pricing authority: batch-vs-solo cost curves for the
micro-batching executor, and the latency-priced hedge.

Counterpart of ``roaringbitmap_tpu/cost/fusion.py``, with the same
curves, coefficients, schema and refit, so a window and a hedged request
get the same verdicts in both packages. The fusion executor
(``query/fusion.py``) decides per drained window whether coalescing the
queries' plan steps into merged per-tier dispatches beats running the
queries back to back; it prices both in microseconds from two linear
curves (engines ``fused`` | ``per-query``)::

    per-query: steps * solo_step_us          (every step pays a dispatch)
    fused:     tiers * tier_us + steps * merge_step_us
               (one dispatch per merged tier + per-step merge overhead;
                `steps` is the post-dedup unique step count, so the
                shared-subexpression saving prices in by construction)

The defaults encode the structural prior (per-dispatch overhead is the
dominant per-step cost; merging N same-class steps pays one dispatch and
a small per-step concat) and predict ``fused`` ahead for any window with
more steps than tiers. Each window's verdict is a ``fusion.batch``
decision whose measured wall the outcome ledger joins.

A budgeted request (``FusionExecutor.submit(tenant=...)``) is priced by
:meth:`FusionBatchModel.choose_dispatch`: the forming window's completion
against the request's own solo curve, each penalized past its slack; a
hedged solo dispatch joins ``fusion.hedge`` and refits the per-query
curve. :meth:`FusionBatchModel.window_for_budget` is the window bound the
``serving-p99-pressure`` actuation (``query.fusion.autotune_window``)
shrinks and regrows to.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Tuple

SCHEMA = "rb_tpu_fusion_cost/1"

ENGINES = ("fused", "per-query")

# structural-prior defaults (µs): a solo plan step costs about one
# columnar-engine call's fixed overhead; a merged tier costs one such
# dispatch plus a small per-step concat/slice tax. ``slack_penalty`` is
# the latency-penalty term: every predicted µs past a
# request's slack counts this many extra µs in the joint window-vs-solo
# verdict — dimensionless, policy-shaped, deliberately NOT refit-scaled
# (the refit learns execution constants; how much an SLO breach hurts is
# a declared preference, not a measurable).
DEFAULT_COEFFS = {
    "solo_step_us": 120.0,
    "tier_us": 150.0,
    "merge_step_us": 25.0,
    "slack_penalty": 4.0,
}
# refit clamps, the CARD_MODEL discipline: one window cannot invert the
# verdict ordering outright, and coefficients stay in a sane decade band
MAX_STEP = 8.0
MAX_SCALE = 64.0


class FusionBatchModel:
    """Thread-safe batch-vs-solo cost curves. Reads are lock-free dict
    gets (atomic under the GIL); refits swap under a leaf lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self.coeffs: Dict[str, float] = dict(DEFAULT_COEFFS)
        self.provenance = "default"

    # -- pricing -------------------------------------------------------------

    def estimate(self, steps: int, tiers: int) -> Dict[str, float]:
        """Per-engine predicted wall (µs) for a window of ``steps`` unique
        plan steps merging into ``tiers`` dispatches — the ``est_us`` dict
        the decision site records and the outcome join prices against."""
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

    # -- the joint latency-priced verdict -------------------------------------

    def hedge_estimate(
        self, steps: int, queue_depth: int, wait_us: float
    ) -> Dict[str, float]:
        """Predicted completion wall (µs) for ONE request against a
        forming window: ``window`` = the remaining window hold
        (``wait_us``) plus the fused estimate of the window it would
        join (``queue_depth`` earlier members approximated at this
        request's step count, merge classes collapsing to one tier per
        step-class); ``solo`` = this request's own per-query curve.
        These are the RAW curves — the est_us dict the ``fusion.hedge``
        decision records and the outcome join prices, so regret rows
        measure curve error, not penalty policy."""
        steps = max(1, int(steps))
        n = max(0, int(queue_depth)) + 1
        window_exec = self.estimate(steps * n, steps)["fused"]
        return {
            "window": round(max(0.0, float(wait_us)) + window_exec, 3),
            "solo": self.estimate(steps, steps)["per-query"],
        }

    def choose_dispatch(
        self, steps: int, queue_depth: int, wait_us: float, slack_us: float
    ) -> Tuple[str, Dict[str, float]]:
        """The joint priced batch-vs-solo verdict for one request with
        ``slack_us`` of latency budget left: each path's raw completion
        estimate plus the latency penalty (``slack_penalty`` extra µs per
        predicted µs past the slack) — device efficiency and the
        tenant's declared budget priced in ONE comparison. Returns
        ``(verdict, raw_est)`` with verdict ``"solo"`` when hedging out
        of the window is the cheaper priced outcome."""
        est = self.hedge_estimate(steps, queue_depth, wait_us)
        pen = self.coeffs["slack_penalty"]
        slack_us = float(slack_us)
        priced = {
            path: us + pen * max(0.0, us - slack_us)
            for path, us in est.items()
        }
        # the window keeps ties: hedging duplicates dispatch overhead the
        # window exists to amortize, so solo must WIN, not draw
        verdict = "solo" if priced["solo"] < priced["window"] else "window"
        return verdict, est

    def window_for_budget(
        self, budget_us: float, steps_per_query: float = 2.0
    ) -> int:
        """Largest window size whose predicted fused wall fits inside
        ``budget_us`` under the CURRENT (possibly refitted) curves — the
        serving-p99-pressure actuation's shrink/regrow bound. Structural
        shape: a window of ``w`` average queries runs ``w *
        steps_per_query`` merged steps over ``~steps_per_query`` tiers
        (merge classes collapse across queries), so
        ``fused(w) = steps_per_query * tier_us + w * steps_per_query *
        merge_step_us``; floor 2 (a 1-window is just solo dispatch)."""
        c = self.coeffs
        fixed = steps_per_query * c["tier_us"]
        per_q = steps_per_query * c["merge_step_us"]
        if float(budget_us) <= fixed or per_q <= 0:
            return 2
        return max(2, int((float(budget_us) - fixed) / per_q))

    # -- refit from the decision-outcome ledger ------------------------------

    def refit_from_outcomes(
        self, samples: Optional[List[dict]] = None, min_samples: int = 2
    ) -> dict:
        """Scale each engine's curve by the geometric mean of
        measured/predicted over its joined ``fusion.batch`` samples (the
        CARD_MODEL's multiplicative-correction discipline: the curve
        SHAPE is structural, the refit learns this host's constants).
        ``per-query`` scales ``solo_step_us``; ``fused`` scales
        ``tier_us`` and ``merge_step_us`` together (their ratio is the
        structural prior; the join cannot separate them)."""
        if samples is None:
            from ..observe import outcomes as _outcomes

            samples = _outcomes.tail()
        ratios: Dict[str, List[float]] = {}
        rejected = 0
        for s in samples:
            site = s.get("site")
            if site not in ("fusion.batch", "fusion.hedge"):
                continue
            engine = s.get("engine")
            if site == "fusion.hedge":
                # a hedged solo dispatch measures exactly the per-query
                # curve; window-verdict joins are queue-wait
                # dominated (policy, not curve) and don't refit anything
                if engine != "solo":
                    continue
                engine = "per-query"
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

    def drift(self) -> Dict[str, float]:
        """{engine: geomean(measured/predicted)} over the ledger's current
        ``fusion.batch`` joins — 1.0 means the curves still price live
        windows truthfully. Stateless: derived from the ledger tail, so a
        refit (which consumes the same joins) naturally re-bases it as
        new traffic arrives under the new coefficients."""
        from ..observe import outcomes as _outcomes

        sums: Dict[str, List[float]] = {}
        for s in _outcomes.tail():
            if s.get("site") != "fusion.batch":
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


MODEL = FusionBatchModel()
