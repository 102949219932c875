"""Pricing authorities and the unified cost facade.

Counterpart of ``roaringbitmap_tpu/cost/``: one facade (``facade.py``)
over the eight pricing authorities — the columnar cutoff model, the
planner's cardinality corrections, the device-breakeven dispatch gate,
pack residency pricing, the fusion executor's batch-vs-solo and hedge
curves, the serving tier's admission curve, the epoch-flip curve and the
compaction curve — behind a shared curves / provenance / drift / refit /
state protocol with one persistence lifecycle (``RB_TPU_COST_STATE``).
The health sentinel (``observe.sentinel``) actuates :func:`refit_all`
when a drift gauge leaves its band.
"""

from .facade import (
    AUTHORITIES,
    STATE_SCHEMA,
    Authority,
    authority,
    calibration_state,
    drift_summary,
    load_state,
    names,
    provenances,
    refit_all,
    reset_all,
    save_state,
)
from . import admission, breakeven, compaction, epoch, fusion, residency

__all__ = [
    "AUTHORITIES",
    "STATE_SCHEMA",
    "Authority",
    "admission",
    "authority",
    "breakeven",
    "calibration_state",
    "compaction",
    "drift_summary",
    "epoch",
    "fusion",
    "load_state",
    "names",
    "provenances",
    "refit_all",
    "reset_all",
    "residency",
    "save_state",
]
