"""Device-breakeven authority: the measured "when does a device dispatch
pay" gate.

Counterpart of ``roaringbitmap_tpu/cost/breakeven.py``, with the same
schema, fit and clamps. The aggregation dispatcher's device gate
(``aggregation.config.min_device_containers``, 64 by default) is a
constant until traffic says otherwise: every ``agg.dispatch`` decision
resolves with the tier that absorbed the traffic and its measured wall
over a known row count (``inputs.rows``), which is a per-tier ``overhead
+ rows·slope`` fit — the columnar cutoff model's curve family, one level
up.

``refit_from_outcomes()`` fits the per-tier curves from joined samples
(outlier-rejected, >= 2 distinct row counts per tier) and, when both a
device curve and a CPU-tier curve exist, moves the gate to the measured
crossover (clamped to ``[16, 8192]``).

**Departure:** the JAX package pushes the gate into
``aggregation.config.min_device_containers`` whenever it moves; there the
device tier never runs on a CPU backend, so the gate never moves on a
host. The port's device tier also runs on CPU tensors (``config.device =
"cpu"``), which do record ``agg.dispatch`` samples, so the port fits the
curves everywhere but pushes the gate into the dispatcher — in the refit
and in ``from_dict`` alike — only where the device tier is a card
(``config.device`` names ``cuda``). The backend stamp is that device
type, as ``columnar/costmodel._backend`` gives it: a state fit on the
card is refused on a host, and the reverse.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Tuple

SCHEMA = "rb_tpu_cost_breakeven/1"
# the dispatch gate may not leave this window no matter what one traffic
# sample says (the columnar model's clamp discipline)
GATE_MIN, GATE_MAX = 16, 8192
_OUTLIER_FACTOR = 20.0


class BreakevenModel:
    """Per-tier dispatch cost curves + the measured device gate."""

    def __init__(self):
        self._lock = threading.Lock()
        # {tier: [overhead_us, per_row_us]} from agg.dispatch joins
        self.curves: Dict[str, List[float]] = {}  # guarded-by: self._lock
        self.gate_rows: Optional[int] = None  # guarded-by: self._lock
        self.provenance = "static"  # guarded-by: self._lock
        self.backend: Optional[str] = None  # guarded-by: self._lock

    def curves_view(self) -> dict:
        from ..parallel import aggregation as _agg

        with self._lock:
            return {
                "tiers": {t: list(c) for t, c in sorted(self.curves.items())},
                "gate_rows": self.gate_rows,
                "config_min_device_containers": _agg.config.min_device_containers,
            }

    def drift(self) -> Dict[str, float]:
        """Measured/predicted geomean per tier over the current ledger
        samples, judged against the installed curves — {} until curves
        exist (the static gate predicts nothing to drift from)."""
        with self._lock:
            curves = {t: list(c) for t, c in self.curves.items()}
        if not curves:
            return {}
        out: Dict[str, float] = {}
        for tier, pts in _site_samples().items():
            c = curves.get(tier)
            if c is None or len(pts) < 2:
                continue
            logs = []
            for rows, us in pts:
                pred = c[0] + rows * c[1]
                if pred > 0 and us > 0:
                    logs.append(math.log(us / pred))
            if logs:
                out[tier] = round(math.exp(sum(logs) / len(logs)), 4)
        return out

    def refit_from_outcomes(
        self, samples: Optional[List[dict]] = None, min_samples: int = 6
    ) -> dict:
        """Fit per-tier curves from joined ``agg.dispatch`` samples and
        move the device gate to the measured crossover when both sides of
        it have curves; the gate reaches the dispatcher only on a card.
        Returns the facade-shape report."""
        pts_by_tier = _site_samples(samples)
        moved: Dict[str, dict] = {}
        rejected = 0
        fitted: Dict[str, List[float]] = {}
        for tier, pts in sorted(pts_by_tier.items()):
            med = _median([us for _, us in pts])
            clean = [
                (rows, us) for rows, us in pts
                if med / _OUTLIER_FACTOR <= us <= med * _OUTLIER_FACTOR
            ]
            rejected += len(pts) - len(clean)
            if len(clean) < min_samples or len({r for r, _ in clean}) < 2:
                continue
            fitted[tier] = _fit(clean)
        with self._lock:
            for tier, new in fitted.items():
                old = self.curves.get(tier)
                if new != old:
                    self.curves[tier] = new
                    moved[tier] = {"from": old, "to": new,
                                   "samples": len(pts_by_tier[tier])}
            gate = _crossover(self.curves)
            if gate is not None and gate != self.gate_rows:
                moved["gate_rows"] = {"from": self.gate_rows, "to": gate}
                self.gate_rows = gate
            if moved:
                self.provenance = "refit-from-traffic"
                self.backend = _current_backend()
            gate_now = self.gate_rows
            prov = self.provenance
        if "gate_rows" in moved and gate_now is not None:
            _push_gate(gate_now)
        return {"moved": moved, "rejected": rejected, "provenance": prov,
                "samples": sum(len(p) for p in pts_by_tier.values())}

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "schema": SCHEMA,
                "backend": self.backend,
                "curves": {t: list(c) for t, c in sorted(self.curves.items())},
                "gate_rows": self.gate_rows,
                "provenance": self.provenance,
            }

    def from_dict(self, d: dict) -> bool:
        if not isinstance(d, dict) or d.get("schema") != SCHEMA:
            return False
        # dispatch curves (and the gate they move) are per-device
        # measurements: a state fit on another device type must not move
        # this process's gate
        if d.get("backend") is not None and d["backend"] != _current_backend():
            return False
        curves = d.get("curves")
        if not isinstance(curves, dict):
            return False
        clean: Dict[str, List[float]] = {}
        for tier, c in curves.items():
            try:
                overhead, slope = float(c[0]), float(c[1])
            except (TypeError, ValueError, IndexError):
                return False
            if not (overhead >= 0 and slope >= 0
                    and math.isfinite(overhead) and math.isfinite(slope)):
                return False
            clean[str(tier)] = [overhead, slope]
        gate = d.get("gate_rows")
        if gate is not None:
            gate = int(gate)
            if not GATE_MIN <= gate <= GATE_MAX:
                return False
        with self._lock:
            self.curves = clean
            self.gate_rows = gate
            self.provenance = str(d.get("provenance") or "static")
            self.backend = d.get("backend")
        if gate is not None:
            _push_gate(gate)
        return True

    def reset(self) -> None:
        with self._lock:
            self.curves = {}
            self.gate_rows = None
            self.provenance = "static"
            self.backend = None


def _current_backend() -> str:
    """The device type the device tier runs on (``"cuda"`` / ``"cpu"``)."""
    from ..columnar import costmodel as _costmodel

    return _costmodel._backend()


def _push_gate(gate: int) -> None:
    """Move the dispatcher's device gate — only where the device tier is
    a card: on CPU tensors the "device" curve prices host memory, and
    the gate stays where the JAX package keeps it on a host."""
    if _current_backend() != "cuda":
        return
    from ..parallel import aggregation as _agg

    _agg.config.min_device_containers = int(gate)


def _site_samples(samples: Optional[List[dict]] = None) -> Dict[str, List[Tuple[int, float]]]:
    """``{tier: [(rows, measured_us), ...]}`` from joined agg.dispatch
    ledger entries (or an explicit sample list in the same shape)."""
    if samples is None:
        from ..observe import outcomes as _outcomes

        samples = [e for e in _outcomes.tail() if e.get("site") == "agg.dispatch"]
    out: Dict[str, List[Tuple[int, float]]] = {}
    for e in samples:
        tier = e.get("engine")
        rows = (e.get("inputs") or {}).get("rows")
        measured = e.get("measured_s")
        if tier is None or rows is None or measured is None:
            continue
        try:
            rows, us = int(rows), float(measured) * 1e6
        except (TypeError, ValueError):
            continue
        if rows < 1 or not math.isfinite(us) or us <= 0:
            continue
        out.setdefault(str(tier), []).append((rows, us))
    return out


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    return s[len(s) // 2] if s else 0.0


def _fit(pts: List[Tuple[int, float]]) -> List[float]:
    """Least-squares overhead + rows·slope, clamped non-negative (the
    calibrate()/refit discipline of the columnar model)."""
    n = len(pts)
    sx = sum(r for r, _ in pts)
    sy = sum(u for _, u in pts)
    sxx = sum(r * r for r, _ in pts)
    sxy = sum(r * u for r, u in pts)
    denom = n * sxx - sx * sx
    if denom == 0:
        return [round(max(0.0, sy / n), 2), 0.0]
    slope = max(0.0, (n * sxy - sx * sy) / denom)
    overhead = max(0.0, (sy - slope * sx) / n)
    return [round(overhead, 2), round(slope, 4)]


def _crossover(curves: Dict[str, List[float]]) -> Optional[int]:
    """Smallest row count where the device curve undercuts every fitted
    CPU tier (None when the device column or all CPU columns are
    missing, or when the device never wins inside the clamp window)."""
    dev = curves.get("device")
    cpu = [c for t, c in curves.items() if t != "device"]
    if dev is None or not cpu:
        return None
    for n in range(GATE_MIN, GATE_MAX + 1):
        dev_cost = dev[0] + n * dev[1]
        if all(dev_cost < c[0] + n * c[1] for c in cpu):
            return n
    return None


MODEL = BreakevenModel()
