"""Columnar pairwise engine: type-partitioned batched container algebra.

Counterpart of ``roaringbitmap_tpu/columnar/``. Whole bitmap-pair ops and
the N-way CPU folds run without per-container Python dispatch, in three
vectorized stages:

1. **key plan** (keyplan.py) — one searchsorted over the two key arrays
   splits matched pairs from pass-throughs;
2. **type partition** (partition.py) — matched pairs classify into the 9
   ``(array|bitmap|run)²`` classes; array payloads gather into CSR
   ``(values, offsets)`` buffers, dense payloads stack into ``[n, 1024]``
   word matrices;
3. **per-class batch kernels** (kernels.py, the numpy tier) — one call per
   occupied class, then batched result-format selection.

The **device tier** (device.py) runs the word-parallel classes over
resident flat rows on ``aggregation.config.device``, the dense bucket on
the hand-written CUDA kernel ``rb_pair_rows``, and a **measured three-way
cost model** (costmodel.py) chooses per-container / columnar-CPU /
columnar-device per call; uncalibrated it is the JAX package's hand-tuned
gate.

The facade (``models/roaring.py``), the CPU folds
(``parallel/aggregation.py``) and the query kernels' CPU path
(``query/kernels.py``) route here through ``route()`` /
``enabled_for_fold()``; the per-container walk stays below the cutoff and
as the differential reference. ``engine.BATCH_COUNTS`` and
``engine.ROUTE_COUNTS`` count batched pairs by class and verdicts by tier.
"""

from .costmodel import MODEL, calibrate, ensure_calibrated
from .engine import (
    and_cardinality_pair,
    config,
    disabled,
    enabled_for,
    enabled_for_fold,
    fold,
    fold_multi,
    intersects_pair,
    or_fold_words,
    outcome,
    pairwise,
    pairwise_multi,
    route,
)
from .keyplan import KeyPlan, key_plan
from .partition import CLASS_NAMES, class_histogram, classify

__all__ = [
    "config",
    "disabled",
    "enabled_for",
    "enabled_for_fold",
    "route",
    "pairwise",
    "and_cardinality_pair",
    "intersects_pair",
    "fold",
    "fold_multi",
    "or_fold_words",
    "pairwise_multi",
    "key_plan",
    "KeyPlan",
    "classify",
    "class_histogram",
    "CLASS_NAMES",
    "MODEL",
    "calibrate",
    "ensure_calibrated",
    "outcome",
]
