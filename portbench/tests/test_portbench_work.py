"""Every request kind counts its logical work from shapes alone, and the
frozen bounds read as the port's chip script read them."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

from portbench import bounds
from portbench.kinds import boolean_query, slice_histogram, slice_range, wide_aggregation


def test_the_frozen_bounds():
    # PERF.md's bounds before this benchmark: the dense reduce over
    # the index rows 0.7535 ms, the batched count at 32 x 1526 0.1233 ms
    # (bytes; operations 0.1196), the GE compare 0.1306 ms
    assert bounds.reduce_least_seconds(308_100, 31) * 1e3 == pytest.approx(0.7535, abs=1e-4)
    assert bounds.slice_walk_least_seconds(32, 1526, 64, False) * 1e3 == pytest.approx(0.1233, abs=1e-4)
    assert bounds.ops_seconds(20 * 1526 * 65536) * 1e3 == pytest.approx(0.1196, abs=1e-4)
    assert bounds.slice_walk_least_seconds(32, 1526, 1, True) * 1e3 == pytest.approx(0.1269, abs=1e-4)


def test_each_kind_counts_from_shapes_alone():
    """Deployments of bare shapes: no values, no bitmaps, no device."""
    index = SimpleNamespace(containers=310_000, groups=31, n=10_000)
    column = SimpleNamespace(slices=32, chunks=1526, cfg={"value_bits": 32})
    agg = [wide_aggregation.least_seconds(index, {}, op) for op in wide_aggregation.OPS]
    assert len(set(agg)) == 1 and agg[0] == bounds.reduce_least_seconds(310_000, 31)
    t = np.arange(128)
    assert slice_histogram.least_seconds(column, {}, t) == bounds.slice_walk_least_seconds(32, 1526, 128, False)
    assert slice_range.least_seconds(column, {}, (5, 9)) == bounds.slice_walk_least_seconds(32, 1526, 1, True)
    assert boolean_query.least_seconds(index, {}, ((0, 1, 2), (3,))) is None
    # twice the rows, twice the least time (bytes bound)
    wide = SimpleNamespace(containers=620_000, groups=31, n=20_000)
    assert wide_aggregation.least_seconds(wide, {}, "or_") == pytest.approx(2 * agg[0], rel=1e-3)


def test_draws_follow_the_mix():
    from portbench import loop

    rng = loop.client_rng(9, loop.WINDOW, 0)
    column = SimpleNamespace(cfg={"value_bits": 32})
    shares = []
    for _ in range(400):
        lo, hi = slice_range.draw(rng, column, {"selectivity": [0.001, 0.5]})
        assert 0 <= lo <= hi < 2**32
        shares.append((hi - lo + 1) / 2**32)
    assert 0.0009 < min(shares) and max(shares) < 0.51
    t = slice_histogram.draw(rng, column, {"thresholds": 128})
    assert t.size == 128 and np.all(np.diff(t) >= 0) and t.max() < 2**32
    index = SimpleNamespace(n=10_000)
    params = {"groups": 50, "group_size": 200, "zipf_s": 1.1, "head": 8, "k": 2}
    firsts = []
    for _ in range(300):
        (a, b, c), head = boolean_query.draw(rng, index, params)
        assert len({a, b, c}) == 3 and len(set(head)) == 8
        firsts += [a, b, c]
    counts = np.bincount(firsts, minlength=50)
    assert counts[0] > counts[25] and counts[0] > counts[49]  # popular groups repeat
