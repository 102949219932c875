"""A cumulative histogram of a bit-sliced column: one
``compare_cardinality_many(GE, thresholds)`` call, with the mix's number of
thresholds drawn uniformly from the column's value range and sorted."""

from __future__ import annotations

import numpy as np
import torch

from .. import bounds


def prepare(dep, params):
    from roaringbitmap_tpu_torch import Operation

    return dep.index, Operation.GE


def draw(rng, dep, params):
    top = 1 << int(dep.cfg["value_bits"])
    return np.sort(rng.integers(0, top, size=int(params["thresholds"]), dtype=np.int64))


def call(state, thresholds):
    index, ge = state
    with torch.profiler.record_function("portbench.RoaringBitmapSliceIndex.compare_cardinality_many"):
        return index.compare_cardinality_many(ge, thresholds)


def least_seconds(dep, params, thresholds):
    return bounds.slice_walk_least_seconds(dep.slices, dep.chunks, len(thresholds), False)


def expected(dep, params, thresholds):
    return dep.counts_ge(thresholds)


def prepare_control(dep, params):
    """The column held in float32, whose 24-bit significand rounds every
    value at or above 2^24: the nearest float below the stored integers."""
    return dep, torch.sort(dep.column(rounded_to_float32=True)).values


def control_call(ctrl, thresholds):
    dep, ordered = ctrl
    t = torch.as_tensor(np.asarray(thresholds, dtype=np.int64), device=ordered.device)
    return (dep.rows - torch.searchsorted(ordered, t)).cpu().numpy().astype(np.int64)
