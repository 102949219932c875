"""A range filter on a bit-sliced column: one ``compare(RANGE, lo, hi)``
returning the matching columns as a bitmap. The selectivity is drawn
log-uniformly from the mix's range, the range's start uniformly."""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import bounds


def prepare(dep, params):
    from roaringbitmap_tpu_torch import Operation

    return dep.index, Operation.RANGE


def draw(rng, dep, params):
    top = 1 << int(dep.cfg["value_bits"])
    lo_sel, hi_sel = (float(x) for x in params["selectivity"])
    share = math.exp(rng.uniform(math.log(lo_sel), math.log(hi_sel)))
    width = max(1, int(round(share * top)))
    lo = int(rng.integers(0, top - width + 1))
    return lo, lo + width - 1


def call(state, bounds_lo_hi):
    index, rng_op = state
    lo, hi = bounds_lo_hi
    with torch.profiler.record_function("portbench.RoaringBitmapSliceIndex.compare"):
        return index.compare(rng_op, lo, hi)


def least_seconds(dep, params, bounds_lo_hi):
    return bounds.slice_walk_least_seconds(dep.slices, dep.chunks, 1, True)


def expected(dep, params, bounds_lo_hi):
    return dep.columns_in(*bounds_lo_hi)


def prepare_control(dep, params):
    """The column held in float32 (see ``slice_histogram``)."""
    return dep, dep.column(rounded_to_float32=True)


def control_call(ctrl, bounds_lo_hi):
    dep, column = ctrl
    return dep.columns_in(*bounds_lo_hi, column=column)
