"""The reader of ``andnot_pack_hit_share``: the window's andnot hits over
its andnot lookups, from planted pack-cache counts, and None where the
counts hold no andnot kind or no andnot lookup fell in the window."""

from __future__ import annotations

import numpy as np
import pytest

from portbench.metrics import andnot_pack_hit_share
from portbench.reading import Reading


def _reading(before_kinds, after_kinds):
    def stats(kinds):
        return {"hits": 0, "misses": 0, "kinds": kinds}

    return Reading(seconds=1.0, completed=10, setup_s=1.0, latencies_ms=np.ones(10),
                   least_s=None, device=None, timings_before={}, timings_after={},
                   pack_before=stats(before_kinds), pack_after=stats(after_kinds))


@pytest.mark.parametrize("before, after, share", [
    ({"agg": {"hits": 5, "misses": 1}, "andnot": {"hits": 2, "misses": 3}},
     {"agg": {"hits": 9, "misses": 1}, "andnot": {"hits": 20, "misses": 5}}, 18 / 20 * 100.0),
    ({}, {"andnot": {"hits": 0, "misses": 4}}, 0.0),
])
def test_reads_the_andnot_kind_over_the_window(before, after, share):
    assert andnot_pack_hit_share.read(_reading(before, after)) == pytest.approx(share)


@pytest.mark.parametrize("before, after", [
    ({"agg": {"hits": 1, "misses": 1}}, {"agg": {"hits": 4, "misses": 1}}),
    ({"andnot": {"hits": 3, "misses": 1}}, {"andnot": {"hits": 3, "misses": 1}}),
])
def test_none_without_andnot_lookups(before, after):
    assert andnot_pack_hit_share.read(_reading(before, after)) is None
