"""TPC-H Query 6 (Clause 2.4.6) over the four bit-sliced ``lineitem``
columns of ``configs/tpch_lineitem.py``.

A request draws its substitution parameters as Clause 2.4.6.3 does: DATE
the first of January of a year uniform over the mix's ``years``, DISCOUNT
uniform over its ``discounts`` (hundredths), QUANTITY uniform over its
``quantities``. It then runs through the port's BSI entry points, every
intermediate found set kept on the device: the ship-date range, the
discount range under it, the quantity bound under that, and for each of
the three discounts left an equality under the chain and a sum of the
price column over it. The answer is ``[revenue, count]``: Σ l_extendedprice
x l_discount in cents x hundredths, and the rows that qualify.
"""

from __future__ import annotations

import numpy as np
import torch

# the port's resident found sets: a port without them fails here, when the
# harness imports the kind, before any data is drawn
from roaringbitmap_tpu_torch.models.bsi import ResidentSet  # noqa: F401

from .. import bounds
from ..configs.tpch_lineitem import year_days


def prepare(dep, params):
    from roaringbitmap_tpu_torch import Operation

    return dep.index, Operation


def draw(rng, dep, params):
    return tuple(int(rng.integers(lo, hi + 1))
                 for lo, hi in (params["years"], params["discounts"], params["quantities"]))


def call(state, request):
    index, op = state
    year, disc, qty = request
    first, last = year_days(year)
    with torch.profiler.record_function("portbench.tpch_q6"):
        found = index["shipdate"].compare_resident(op.RANGE, first, last)
        found = index["discount"].compare_resident(op.RANGE, disc - 1, disc + 1, found)
        found = index["quantity"].compare_resident(op.LT, qty, found_set=found)
        revenue = count = 0
        for d in (disc - 1, disc, disc + 1):
            total, n = index["price"].sum(index["discount"].compare_resident(op.EQ, d, found_set=found))
            revenue += d * total
            count += n
    return np.array([revenue, count], dtype=np.int64)


def least_seconds(dep, params, request):
    """The least work Q6 needs from these columns, whatever computes it:
    every slice and the existence rows read once, and per chunk a count of
    the qualifying rows and of each price slice among them written."""
    rows = (sum(dep.slices.values()) + 1) * dep.chunks
    nbytes = rows * bounds.ROW_BYTES + (dep.slices["price"] + 1) * dep.chunks * 4
    return bounds.least_seconds(nbytes, rows * bounds.ROW_WORDS)


def expected(dep, params, request):
    return dep.q6(request)


def prepare_control(dep, params):
    """The reference with the revenue held in float32, as an engine that
    keeps DECIMAL columns in float would."""
    return dep


def control_call(dep, request):
    return dep.q6(request, float32=True)
