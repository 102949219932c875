"""Shared bucketed rank/select over (sorted keys, cumulative cardinalities).

One implementation of the cached-cumulative-cardinality pattern the
reference repeats in FastRankRoaringBitmap (FastRankRoaringBitmap.java:21-39)
and Roaring64NavigableMap (Roaring64NavigableMap.java:66-72), used here by
FastRankRoaringBitmap, Roaring64Bitmap and ImmutableRoaringBitmap.
"""

from __future__ import annotations

from bisect import bisect_left
from typing import Callable, Sequence

import numpy as np


def bucketed_rank(
    keys: Sequence[int],
    cum: np.ndarray,
    high: int,
    bucket_rank: Callable[[int], int],
) -> int:
    """Rank of (high, low) given per-bucket ranks: full buckets below `high`
    via the cumulative table, plus `bucket_rank(i)` inside the matching
    bucket (the caller closes over `low`)."""
    i = bisect_left(keys, high)
    total = int(cum[i - 1]) if i > 0 else 0
    if i < len(keys) and keys[i] == high:
        total += bucket_rank(i)
    return total


def bucketed_select(
    keys: Sequence[int],
    cum: np.ndarray,
    j: int,
    bucket_select: Callable[[int, int], int],
) -> int:
    """Global j-th value: locate the bucket by cumulative cardinality, then
    `bucket_select(i, local_j)`. The caller combines the returned low value
    with keys[i]."""
    j = int(j)
    if j < 0:
        raise IndexError(j)
    i = int(np.searchsorted(cum, j + 1))
    if i >= len(keys):
        raise IndexError("select out of range")
    prior = int(cum[i - 1]) if i else 0
    return bucket_select(i, j - prior)


def group_positions(vals: np.ndarray):
    """Yield (value, positions) for each distinct entry of ``vals`` (one
    stable argsort) — the grouping idiom shared by the bulk-probe paths."""
    order = np.argsort(vals, kind="stable")
    sv = vals[order]
    bounds = np.nonzero(np.diff(sv))[0] + 1
    starts = np.concatenate(([0], bounds))
    ends = np.concatenate((bounds, [sv.size]))
    for s, e in zip(starts.tolist(), ends.tolist()):
        yield int(sv[s]), order[s:e]


def bucketed_rank_many(
    sorted_keys: np.ndarray,
    cum: np.ndarray,
    probe_keys: np.ndarray,
    in_bucket: Callable[[int, np.ndarray], np.ndarray],
) -> np.ndarray:
    """Vectorized bucketed rank, shared by every bulk rank_many: buckets
    strictly before each probe's key contribute wholesale via the exclusive
    prefix of ``cum`` (inclusive cumsum), and probes whose bucket exists add
    ``in_bucket(bucket_index, positions)`` — called once per touched
    bucket."""
    prefix = np.concatenate(([0], cum))
    idx = np.searchsorted(sorted_keys, probe_keys, side="left")
    out = prefix[idx].copy()
    n = sorted_keys.size
    hit = (idx < n) & (sorted_keys[np.minimum(idx, n - 1)] == probe_keys)
    if hit.any():
        hit_all = np.flatnonzero(hit)
        for _, rel in group_positions(idx[hit_all]):
            pos = hit_all[rel]
            out[pos] += in_bucket(int(idx[pos[0]]), pos)
    return out


def bucketed_select_many(
    cum: np.ndarray,
    ranks: np.ndarray,
    in_bucket: Callable[[int, np.ndarray], np.ndarray],
    dtype=np.uint64,
) -> np.ndarray:
    """Vectorized bucketed select, shared by every bulk select_many: each
    rank resolves to its bucket through the inclusive cumsum, and
    ``in_bucket(bucket_index, local_ranks)`` returns the finished values
    (high bits merged) — called once per touched bucket. Raises IndexError
    on any out-of-range rank, like the scalar selects."""
    js = np.asarray(ranks, dtype=np.int64).ravel()
    out = np.zeros(js.size, dtype=dtype)
    if js.size == 0:
        return out
    total = int(cum[-1]) if cum.size else 0
    if js.min() < 0 or js.max() >= total:
        raise IndexError("select out of range")
    ci = np.searchsorted(cum, js, side="right")
    base = np.concatenate(([0], cum))[ci]
    for c_idx, pos in group_positions(ci):
        out[pos] = in_bucket(c_idx, js[pos] - base[pos])
    return out
