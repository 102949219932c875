"""Measured three-way cutoff model of the columnar engines.

Counterpart of ``roaringbitmap_tpu/columnar/costmodel.py``:

    cost(engine) = overhead_us + n_pairs · per_pair_us[op_group][shape]

with ``shape`` the sampled class-mix bucket (``run`` > ``bitmap`` >
``array``), ``op_group`` the and/andnot vs or/xor coefficient table, and
``n_pairs = min(na, nb)`` (an upper bound on the matched pairs).
``choose()`` picks the argmin among per-container / columnar-CPU /
columnar-device over steady-state costs; a non-resident operand's one-time
ship to the card is reported in the decision inputs (``ship_us``) but not
priced into the verdict (only device executions make rows resident).

The device tier is eligible only when ``aggregation.config.device`` names
a CUDA device; nothing here probes for a card. **Calibration** times the
real engines on small synthetic pairs per (shape, count) cell and fits
``overhead + slope`` per engine; it runs at first use when the device tier
is eligible, explicitly from tests and scripts, or is loaded from
``RB_TPU_COLUMNAR_CAL`` (a persisted calibration path: load if present,
write after measuring). **Uncalibrated, the model is the hand-tuned gate**
of the JAX package: the count window plus the dense-shape hint, never the
device.

**Refit**: :func:`refit_from_outcomes` refits a calibrated model's cells
from the outcome ledger's joined ``columnar.cutoff`` samples (the JAX
package's ``costmodel.refit_from_outcomes``), and persists through
``RB_TPU_COLUMNAR_CAL`` like a calibration.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

SCHEMA = "rb_tpu_columnar_costmodel/2"
ENGINES = ("per-container", "columnar-cpu", "columnar-device")
# class-mix buckets, cheapest to handle first; a pair's shape is the max
# over the two operands' sampled hints
SHAPES = ("array", "bitmap", "run")
# coefficient tables per op group: and/andnot share the gather/merge class
# structure while or/xor word-expand every non-aa pair
OP_GROUPS = ("and", "or")

# calibration cells: two container counts per shape fit overhead + slope
_CAL_COUNTS = (16, 64)
_CAL_REPS = 3


def op_group(op: str) -> str:
    """The coefficient table an op prices against."""
    return "or" if op in ("or", "xor") else "and"


def _backend() -> str:
    """The device type the device tier runs on (``aggregation.config
    .device``): ``"cuda"`` or ``"cpu"``. Coefficients are measurements on
    it, so a persisted calibration records it."""
    from ..parallel import aggregation

    return torch.device(aggregation.config.device).type


class CostModel:
    """Per-call engine choice from measured per-engine cost curves.
    Coefficients swap under ``_lock``; ``choose()`` reads a consistent
    snapshot reference without locking."""

    def __init__(self):
        self._lock = threading.Lock()
        self.calibrated = False
        self.backend: Optional[str] = None
        # {op_group: {engine: {shape: [overhead_us, per_pair_us]}}}
        self.coeffs: Dict[str, Dict[str, Dict[str, List[float]]]] = {}
        # amortized host -> device ship cost per row of a non-resident operand
        self.ship_us_per_row: float = 0.0
        self.fold_rows_min: Optional[int] = None  # None -> config default
        self.provenance: str = "calibrated"

    def device_eligible(self) -> bool:
        """Is the device tier worth pricing? Only when the device path runs
        on a CUDA device (on the CPU the "device" rows are host memory) and
        a card is there: the one probe the JAX package makes here (its
        backend query), so a routed facade op on a host without a card
        answers on the CPU engines. The facade takes no ``device=``; the
        aggregation entry points, which do, still raise for ``"cuda"``
        without a card."""
        return _backend() == "cuda" and torch.cuda.is_available()

    def choose(
        self,
        na: int,
        nb: int,
        shape: str,
        resident,
        allow_device: Optional[bool] = None,
        op: str = "and",
    ) -> Tuple[str, dict]:
        """Pick the engine for an ``na x nb``-container pairwise ``op``
        whose sampled class mix is ``shape``; ``resident`` — are the
        operands' flat rows already resident, one bool for both sides or a
        ``(resident_a, resident_b)`` pair. Returns ``(engine, inputs)``,
        the inputs being the features and estimates the choice used.

        Uncalibrated this is the count window plus the dense hint (never
        the device); calibrated, the argmin over the measured per-op-group
        cost curves."""
        from . import engine as _engine

        cfg = _engine.config
        n = min(na, nb)
        if isinstance(resident, tuple):
            res_a, res_b = resident
        else:
            res_a = res_b = bool(resident)
        ship_rows = (0 if res_a else na) + (0 if res_b else nb)
        inputs = {"na": na, "nb": nb, "shape": shape, "op": op, "resident": bool(res_a and res_b)}
        if not self.calibrated:
            inputs["model"] = "default-gate"
            if not (
                cfg.min_containers <= na <= cfg.max_containers
                and cfg.min_containers <= nb <= cfg.max_containers
            ):
                return "per-container", inputs
            if shape == "array":
                return "per-container", inputs
            return "columnar-cpu", inputs
        if allow_device is None:
            allow_device = self.device_eligible()
        table = self.coeffs.get(op_group(op)) or next(iter(self.coeffs.values()), {})
        costs = {}
        for eng in ENGINES:
            c = table.get(eng, {}).get(shape)
            if c is None or (eng == "columnar-device" and not allow_device):
                continue
            costs[eng] = c[0] + n * c[1]
        if not costs:  # the calibration recorded nothing usable: the gate
            with self._lock:
                self.calibrated = False
            return self.choose(na, nb, shape, resident, allow_device, op=op)
        best = min(costs, key=costs.get)
        inputs["model"] = self.provenance
        inputs["est_us"] = {k: round(v, 1) for k, v in costs.items()}
        if best == "columnar-device" and ship_rows:
            inputs["ship_us"] = round(self.ship_us_per_row * ship_rows, 1)
        return best, inputs

    def fold_gate_rows(self) -> int:
        """The N-way fold row cutoff: measured when calibration found one,
        ``config.min_fold_rows`` otherwise."""
        from . import engine as _engine

        v = self.fold_rows_min
        return int(v) if v else _engine.config.min_fold_rows

    # -- persistence --------------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "schema": SCHEMA,
            "backend": self.backend,
            "calibrated": self.calibrated,
            "coeffs": self.coeffs,
            "ship_us_per_row": self.ship_us_per_row,
            "fold_rows_min": self.fold_rows_min,
            "provenance": self.provenance,
        }

    def save(self, path: str) -> None:
        """Persist the calibration (write then rename, so a crashed writer
        leaves no torn file)."""
        tmp = f"{path}.tmp.{os.getpid()}"
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=1)
        os.replace(tmp, path)

    def from_dict(self, d: dict, check_backend: bool = True) -> bool:
        """Adopt a serialized calibration (the ``to_dict`` shape); False,
        with the state untouched, on a schema or backend mismatch."""
        if not isinstance(d, dict) or d.get("schema") != SCHEMA or not d.get("calibrated"):
            return False
        if check_backend and d.get("backend") != _backend():
            return False  # coefficients are per-backend measurements
        coeffs = d.get("coeffs")
        if not isinstance(coeffs, dict) or not coeffs:
            return False
        with self._lock:
            self.coeffs = coeffs
            self.backend = d.get("backend")
            self.ship_us_per_row = float(d.get("ship_us_per_row", 0.0))
            self.fold_rows_min = d.get("fold_rows_min")
            self.provenance = str(d.get("provenance") or "calibrated")
            self.calibrated = True
        return True

    def load(self, path: str) -> bool:
        """Adopt a persisted calibration; False (state untouched) for a
        missing, invalid or foreign-backend file."""
        try:
            with open(path) as f:
                d = json.load(f)
        except (OSError, ValueError):
            return False
        return self.from_dict(d)

    def reset(self) -> None:
        """Back to the uncalibrated gate (tests); also re-arms the
        first-use calibration latch."""
        global _CAL_DONE, _ENSURED
        with self._lock:
            self.calibrated = False
            self.coeffs = {}
            self.backend = None
            self.ship_us_per_row = 0.0
            self.fold_rows_min = None
            self.provenance = "calibrated"
        _CAL_DONE = False
        _ENSURED = False


MODEL = CostModel()

_CAL_LOCK = threading.Lock()
_CAL_DONE = False


# ---------------------------------------------------------------------------
# calibration: the real engines timed on synthetic working sets
# ---------------------------------------------------------------------------


def _synthetic_pair(shape: str, n: int, rng):
    """A matched n-container pair of the given class-mix bucket: both
    sides carry the same kind per chunk key, so the matched classes are
    the type-homogeneous ones the shape hint predicts (aa, aa+bb, aa+rr).
    ~300-value arrays, ~9k-value bitmaps, and run containers shaped like a
    run-optimized census-style corpus's (48 short runs of 1-50 values at
    random places, ~1,200 values), so that or/xor results stay array-sized
    as they do there. (The JAX package's run cells are 14 stripes of 900
    values alike on both sides, whose unions are bitmaps: they priced the
    columnar tiers several times too cheap for census pairs.)"""
    from ..models.roaring import RoaringBitmap

    def build() -> "RoaringBitmap":
        vals = []
        for k in range(n):
            base = k << 16
            if shape == "array" or k % 2:
                v = np.sort(rng.choice(1 << 16, 300, replace=False))
            elif shape == "bitmap":
                v = np.sort(rng.choice(1 << 16, 9000, replace=False))
            else:  # short runs 64-aligned apart, so none merge
                starts = np.sort(rng.choice(1 << 10, 48, replace=False)) << 6
                v = np.concatenate([np.arange(s, s + int(rng.integers(1, 51))) for s in starts])
            vals.append((v + base).astype(np.uint32))
        bm = RoaringBitmap(np.concatenate(vals))
        bm.run_optimize()
        return bm

    return build(), build()


def _time_us(fn, reps: int = _CAL_REPS) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best * 1e6


def calibrate(
    include_device: Optional[bool] = None,
    persist: Optional[str] = None,
    seed: int = 0x10C0,
) -> CostModel:
    """Time the engines on synthetic pairs and install the fitted curves
    (once per process unless ``MODEL.reset()`` ran). The device cells run
    on ``aggregation.config.device``; their rows are built before the
    timed calls, so the per-pair coefficients price the steady state and
    the ship term prices residency apart."""
    global _CAL_DONE
    with _CAL_LOCK:
        if _CAL_DONE and MODEL.calibrated:
            return MODEL
        from . import device as _device
        from . import engine as _engine
        from ..models.roaring import RoaringBitmap

        if include_device is None:
            include_device = MODEL.device_eligible()
        rng = np.random.default_rng(seed)
        op_of = {"and": RoaringBitmap.and_, "or": RoaringBitmap.or_}
        coeffs: Dict[str, Dict[str, Dict[str, List[float]]]] = {
            g: {e: {} for e in ENGINES} for g in OP_GROUPS
        }
        ship_samples: List[float] = []
        for shape in SHAPES:
            cells: Dict[tuple, List[float]] = {(g, e): [] for g in OP_GROUPS for e in ENGINES}
            for n in _CAL_COUNTS:
                a, b = _synthetic_pair(shape, n, rng)
                if include_device:
                    t0 = time.perf_counter()
                    _device.rows_for(a)
                    _device.rows_for(b)
                    ship_samples.append((time.perf_counter() - t0) * 1e6 / (2 * n))
                for group in OP_GROUPS:
                    ref = op_of[group]
                    with _engine.disabled():
                        cells[(group, "per-container")].append(_time_us(lambda: ref(a, b)))
                    cells[(group, "columnar-cpu")].append(
                        _time_us(lambda: _engine.pairwise(group, a, b, tier="cpu"))
                    )
                    if include_device:
                        _engine.pairwise(group, a, b, tier="device")  # first launch
                        cells[(group, "columnar-device")].append(
                            _time_us(lambda: _engine.pairwise(group, a, b, tier="device"))
                        )
            n0, n1 = _CAL_COUNTS[0], _CAL_COUNTS[-1]
            for (group, eng), ts in cells.items():
                if len(ts) < 2:
                    continue
                slope = max(0.0, (ts[-1] - ts[0]) / (n1 - n0))
                overhead = max(0.0, ts[0] - slope * n0)
                coeffs[group][eng][shape] = [round(overhead, 2), round(slope, 3)]
        fold_min = _calibrate_fold()
        with MODEL._lock:
            MODEL.coeffs = {
                g: {e: s for e, s in engines.items() if s}
                for g, engines in coeffs.items()
                if any(engines.values())
            }
            MODEL.ship_us_per_row = round(float(np.median(ship_samples)), 3) if ship_samples else 0.0
            MODEL.fold_rows_min = fold_min
            MODEL.backend = _backend()
            MODEL.provenance = "calibrated"
            MODEL.calibrated = True
        _CAL_DONE = True
        path = persist if persist is not None else os.environ.get("RB_TPU_COLUMNAR_CAL")
        if path:
            try:
                MODEL.save(path)
            except OSError:
                pass  # read-only file system: the run-local calibration applies
        return MODEL


def _calibrate_fold() -> Optional[int]:
    """The measured fold cutoff: the columnar and the per-container OR
    folds timed at two row counts; the crossover clamped to [16, 512], or
    None (keep the config default) when the columnar fold never wins."""
    from . import engine as _engine
    from ..models.roaring import RoaringBitmap
    from ..parallel import store
    from ..parallel.aggregation import _percontainer_aggregate

    def groups_of(rows: int):
        per_bm = 8
        bms = []
        for i in range(max(2, rows // per_bm)):
            v = np.concatenate(
                [np.arange(k << 16, (k << 16) + 64, 2) for k in range(per_bm)]
            ).astype(np.uint32)
            bm = RoaringBitmap(v + (i % 3))
            bm.run_optimize()
            bms.append(bm)
        return store.group_by_key(bms)

    samples = []
    for rows in (32, 128):
        g = groups_of(rows)
        n = sum(len(cs) for cs in g.values())
        col = _time_us(lambda: _engine.fold(g, "or"))
        pc = _time_us(lambda: _percontainer_aggregate(g, "or"))
        samples.append((n, col, pc))
    wins = [n for n, col, pc in samples if col < pc]
    if not wins:
        return None
    return int(max(16, min(512, min(wins))))


# ---------------------------------------------------------------------------
# online refit from the decision-outcome join
# ---------------------------------------------------------------------------

# a sample whose measured cost sits this many times off its cell median is
# poisoned telemetry (a GC pause inside the measured window, a clock jump),
# not signal — refit must not learn from it
_REFIT_OUTLIER_FACTOR = 20.0


def refit_from_outcomes(
    samples: Optional[List[dict]] = None,
    min_samples: int = 4,
    persist: Optional[str] = None,
) -> dict:
    """Refit overhead+slope coefficients from live joined samples — the
    decision-outcome ledger's ``columnar.cutoff`` joins, each
    carrying the features the model fits on: op group, engine that ran,
    sampled shape, matched-pair bound ``n``, and the measured µs.

    Per (op-group, engine, shape) cell with at least ``min_samples``
    clean samples spanning >=2 distinct counts, a least-squares
    ``overhead + n·slope`` fit replaces the cell's coefficients (clamped
    non-negative, like ``calibrate()``); cells without enough traffic
    keep their calibrated values. Poisoned samples — non-finite or
    non-positive measurements, unknown engines/shapes, and measurements
    more than ``20x`` off their cell median — are rejected and counted.
    The model's provenance flips to ``"refit-from-traffic"`` when at
    least one cell moved, is recorded into every subsequent routing
    decision, and persists through the ``RB_TPU_COLUMNAR_CAL`` lifecycle
    exactly like a calibration (``persist=`` overrides the env path).

    Returns a report: per-cell before/after coefficients, sample counts,
    and the rejection tally. Refitting an UNCALIBRATED model is refused
    (report ``{"refused": ...}``) — the default gate has no coefficient
    table to move, and fabricating one from sparse traffic would replace
    a measured baseline with noise."""
    if not MODEL.calibrated:
        report = {"refused": "model is uncalibrated (default gate)",
                  "moved": {}, "rejected": 0}
        _decisions_record("costmodel.refit", "refused", rejected=0, moved=0)
        return report
    if samples is None:
        from ..observe import outcomes as _outcomes

        samples = _outcomes.samples("columnar.cutoff")
    # validate + bucket into cells
    cells: Dict[Tuple[str, str, str], List[Tuple[int, float]]] = {}
    rejected = 0
    for s in samples:
        try:
            engine = s["engine"]
            shape = s["shape"]
            n = int(s["n"])
            us = float(s["measured_us"])
            group = op_group(str(s.get("op", "and")))
        except (KeyError, TypeError, ValueError):
            rejected += 1
            continue
        if (
            engine not in ENGINES or shape not in SHAPES or n < 1
            or not np.isfinite(us) or us <= 0
        ):
            rejected += 1
            continue
        cells.setdefault((group, engine, shape), []).append((n, us))
    moved: Dict[str, dict] = {}
    with MODEL._lock:
        for (group, engine, shape), pts in sorted(cells.items()):
            med = float(np.median([us for _, us in pts]))
            clean = [
                (n, us) for n, us in pts
                if med / _REFIT_OUTLIER_FACTOR <= us <= med * _REFIT_OUTLIER_FACTOR
            ]
            rejected += len(pts) - len(clean)
            if len(clean) < min_samples:
                continue
            ns = np.array([n for n, _ in clean], dtype=np.float64)
            us = np.array([u for _, u in clean], dtype=np.float64)
            if np.unique(ns).size < 2:
                # one count cannot separate overhead from slope; move only
                # the level: keep the calibrated slope, refit the overhead
                # as the residual median (still a coefficient moving
                # toward measured truth)
                old = MODEL.coeffs.get(group, {}).get(engine, {}).get(shape)
                if old is None:
                    continue
                overhead = max(0.0, float(np.median(us - ns * old[1])))
                new = [round(overhead, 2), old[1]]
            else:
                slope, overhead = np.polyfit(ns, us, 1)
                slope = max(0.0, float(slope))
                overhead = max(0.0, float(overhead))
                new = [round(overhead, 2), round(slope, 3)]
            old = MODEL.coeffs.setdefault(group, {}).setdefault(
                engine, {}
            ).get(shape)
            if new == old:
                continue
            MODEL.coeffs[group][engine][shape] = new
            moved["/".join((group, engine, shape))] = {
                "from": old, "to": new, "samples": len(clean),
            }
        if moved:
            MODEL.provenance = "refit-from-traffic"
    report = {"moved": moved, "rejected": rejected,
              "provenance": MODEL.provenance, "samples": len(samples)}
    _decisions_record(
        "costmodel.refit", MODEL.provenance if moved else "no-change",
        moved=len(moved), rejected=rejected,
    )
    if moved:
        path = persist if persist is not None else os.environ.get(
            "RB_TPU_COLUMNAR_CAL"
        )
        if path:
            try:
                MODEL.save(path)
            except OSError:
                pass  # a read-only file system: the refit still applies in this run
    return report


def _decisions_record(site, decision, **inputs):
    from ..observe import decisions as _decisions

    _decisions.record_decision(site, decision, **inputs)


_ENSURED = False  # first-use latch: route() calls this per routed op


def ensure_calibrated() -> CostModel:
    """First-use hook: where the device tier is eligible, adopt the
    persisted calibration (``RB_TPU_COLUMNAR_CAL``) or measure one now;
    otherwise the model stays the default gate. Latches once that is
    settled, so the steady cost on the routed path is one bool check. A
    calibration that raises (the device named but unusable) leaves the
    latch open: every routed call raises the same way, none falls back
    to the uncalibrated gate."""
    global _ENSURED
    if _ENSURED or MODEL.calibrated:
        return MODEL
    path = os.environ.get("RB_TPU_COLUMNAR_CAL")
    if not (path and MODEL.load(path)) and MODEL.device_eligible():
        calibrate()
    _ENSURED = True
    return MODEL
