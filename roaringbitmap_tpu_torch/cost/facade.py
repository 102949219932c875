"""The unified cost facade: every pricing authority behind one
curves / drift / refit / state protocol.

Counterpart of ``roaringbitmap_tpu/cost/facade.py``, with the same eight
authority names, report shapes and state schema, so a state file the
JAX package saved on a host loads here on a host and gives the same
:func:`calibration_state`:

========================= ===============================================
authority                 wraps
========================= ===============================================
``columnar-cutoff``       ``columnar.costmodel.MODEL`` — the measured
                          three-way per-pair engine curves
``planner-cardinality``   ``query.plan.CARD_MODEL`` — per-op cardinality
                          corrections
``device-breakeven``      ``cost.breakeven.MODEL`` — the aggregation
                          dispatch gate as a refittable curve
``pack-residency``        ``cost.residency.MODEL`` — ship µs/row (shared
                          with the columnar calibration) + per-kind
                          measured re-pack cost
``fusion-batch``          ``cost.fusion.MODEL`` — the micro-batching
                          executor's batch-vs-solo window curves and the
                          hedge
``serve-admission``       ``cost.admission.MODEL`` — the serving tier's
                          admission curve
``epoch-flip``            ``cost.epoch.MODEL`` — flip-now vs
                          accumulate-more (no caller in the port yet)
``compaction``            ``cost.compaction.MODEL`` — compact-now vs
                          let-it-ride (no caller in the port yet)
========================= ===============================================

Each adapter answers ``curves()``, ``provenance()``, ``drift()``,
``refit_from_outcomes()`` and ``state()`` / ``load_state()``, so the
health sentinel's ``refit`` actuation (:func:`refit_all`) needs no
knowledge of which authority drifted, and a flight bundle captures every
authority in one ``calibration.json`` (:func:`calibration_state`).

**One persistence lifecycle**: :func:`save_state` / :func:`load_state`
round-trip all authorities through one JSON file (``RB_TPU_COST_STATE``);
the columnar model's own ``RB_TPU_COLUMNAR_CAL`` path keeps working. The
per-device measurements (columnar, breakeven, residency) carry a backend
stamp, the device type of the device tier (``"cuda"`` / ``"cpu"``): a
sub-state stamped for the other device is refused and reported False.

Lock discipline: the facade holds no lock of its own — every adapter
delegates to its model's leaf lock; :func:`refit_all` runs the refits
one after another, each under its own model's lock only.
"""

from __future__ import annotations

import json
import os
import time
from types import ModuleType
from typing import Dict, List, Optional

from . import admission, breakeven, compaction, epoch, fusion, residency

STATE_SCHEMA = "rb_tpu_cost_state/1"


class Authority:
    """Adapter protocol (duck-typed base). Subclasses delegate to the
    underlying model singletons; all methods return plain json-able
    data."""

    name: str = "?"

    def curves(self) -> dict:
        raise NotImplementedError

    def provenance(self) -> str:
        raise NotImplementedError

    def drift(self) -> Dict[str, float]:
        """{cell: measured/believed ratio} — {} when nothing to judge."""
        return {}

    def refit_from_outcomes(self, samples: Optional[List[dict]] = None) -> dict:
        raise NotImplementedError

    def state(self) -> dict:
        raise NotImplementedError

    def load_state(self, d: dict) -> bool:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError


class ColumnarCutoffAuthority(Authority):
    name = "columnar-cutoff"

    def _model(self):
        from ..columnar import costmodel as _costmodel

        return _costmodel.MODEL

    def curves(self) -> dict:
        m = self._model()
        return {
            "calibrated": m.calibrated,
            "backend": m.backend,
            "coeffs": m.coeffs,
            "ship_us_per_row": m.ship_us_per_row,
            "fold_rows_min": m.fold_rows_min,
        }

    def provenance(self) -> str:
        m = self._model()
        return m.provenance if m.calibrated else "default-gate"

    def drift(self) -> Dict[str, float]:
        from ..observe import outcomes as _outcomes

        # the per-coefficient-cell gauge is this authority's drift view
        # (every cell is a columnar (group, engine, shape) coefficient)
        return _outcomes.drift()

    def refit_from_outcomes(self, samples: Optional[List[dict]] = None) -> dict:
        from ..columnar import costmodel as _costmodel
        from ..observe import outcomes as _outcomes

        report = _costmodel.refit_from_outcomes(samples=samples)
        moved = report.get("moved") or {}
        if moved:
            # the refit replaced these cells' coefficients: their drift
            # EWMAs measured the old curves and re-base, or the sentinel's
            # drift rule would re-fire against beliefs that already moved
            _outcomes.rebase_drift(list(moved))
        return report

    def state(self) -> dict:
        return self._model().to_dict()

    def load_state(self, d: dict) -> bool:
        return self._model().from_dict(d)

    def reset(self) -> None:
        self._model().reset()


class ModelAuthority(Authority):
    """An authority that is one model singleton of this package
    (``<module>.MODEL``) answering the protocol itself."""

    def __init__(self, name: str, module: Optional[ModuleType]):
        self.name = name
        self._module = module

    def _model(self):
        return self._module.MODEL

    def curves(self) -> dict:
        return self._model().curves_view()

    def provenance(self) -> str:
        return self._model().provenance

    def drift(self) -> Dict[str, float]:
        return self._model().drift()

    def refit_from_outcomes(self, samples: Optional[List[dict]] = None) -> dict:
        return self._model().refit_from_outcomes(samples=samples)

    def state(self) -> dict:
        return self._model().to_dict()

    def load_state(self, d: dict) -> bool:
        return self._model().from_dict(d)

    def reset(self) -> None:
        self._model().reset()


class PlannerCardinalityAuthority(ModelAuthority):
    """The planner's per-op cardinality corrections: no curves view and
    no drift of their own."""

    def __init__(self):
        super().__init__("planner-cardinality", None)

    def _model(self):
        from ..query.plan import CARD_MODEL

        return CARD_MODEL

    def curves(self) -> dict:
        return {"corrections": dict(self._model().corrections)}

    def drift(self) -> Dict[str, float]:
        return {}


AUTHORITIES: Dict[str, Authority] = {
    a.name: a
    for a in (
        ColumnarCutoffAuthority(),
        PlannerCardinalityAuthority(),
        ModelAuthority("device-breakeven", breakeven),
        ModelAuthority("pack-residency", residency),
        ModelAuthority("fusion-batch", fusion),
        ModelAuthority("serve-admission", admission),
        ModelAuthority("epoch-flip", epoch),
        ModelAuthority("compaction", compaction),
    )
}


def names() -> List[str]:
    return sorted(AUTHORITIES)


def authority(name: str) -> Authority:
    try:
        return AUTHORITIES[name]
    except KeyError:
        raise KeyError(
            f"unknown pricing authority {name!r} (have {names()})"
        ) from None


def refit_all(samples: Optional[List[dict]] = None) -> Dict[str, dict]:
    """Refit every authority from the live decision–outcome ledger (or an
    explicit sample list, passed to each adapter — adapters filter by
    site). This is the sentinel's drift actuation: one call, every
    pricing authority refits, each recording its own provenance."""
    return {
        name: AUTHORITIES[name].refit_from_outcomes(samples=samples)
        for name in names()
    }


def provenances() -> Dict[str, str]:
    return {name: AUTHORITIES[name].provenance() for name in names()}


def drift_summary() -> Dict[str, Dict[str, float]]:
    """{authority: {cell: ratio}} over every authority reporting drift."""
    out = {}
    for name in names():
        d = AUTHORITIES[name].drift()
        if d:
            out[name] = d
    return out


def calibration_state() -> dict:
    """Every authority's current belief + provenance + drift — the flight
    bundle's ``calibration.json``."""
    return {
        "schema": STATE_SCHEMA,
        "authorities": {
            name: {
                "curves": AUTHORITIES[name].curves(),
                "provenance": AUTHORITIES[name].provenance(),
                "drift": AUTHORITIES[name].drift(),
            }
            for name in names()
        },
    }


# ---------------------------------------------------------------------------
# one persistence lifecycle (RB_TPU_COST_STATE)
# ---------------------------------------------------------------------------


def save_state(path: Optional[str] = None) -> Optional[str]:
    """Persist all authorities' state to one JSON file (atomic write);
    ``path`` defaults to ``RB_TPU_COST_STATE`` — None (and no-op) when
    neither names a destination. Returns the path written."""
    path = path if path is not None else os.environ.get("RB_TPU_COST_STATE")
    if not path:
        return None
    from ..observe.export import _atomic_write

    doc = {
        "schema": STATE_SCHEMA,
        "generated_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "authorities": {name: AUTHORITIES[name].state() for name in names()},
    }
    _atomic_write(path, json.dumps(doc, indent=1, sort_keys=True) + "\n")
    return path


def load_state(path: Optional[str] = None) -> Dict[str, bool]:
    """Adopt a persisted unified state; per-authority verdicts (an
    authority whose sub-state fails validation — foreign backend, bad
    schema — is left untouched and reported False). Missing or corrupt
    file → all False."""
    path = path if path is not None else os.environ.get("RB_TPU_COST_STATE")
    verdicts = {name: False for name in names()}
    if not path:
        return verdicts
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return verdicts
    if not isinstance(doc, dict) or doc.get("schema") != STATE_SCHEMA:
        return verdicts
    states = doc.get("authorities") or {}
    for name in names():
        sub = states.get(name)
        if isinstance(sub, dict):
            verdicts[name] = bool(AUTHORITIES[name].load_state(sub))
    return verdicts


def reset_all() -> None:
    """Every authority back to its pre-calibration default (tests)."""
    for name in names():
        AUTHORITIES[name].reset()
