"""Stage 2 of the columnar pairwise engine: type partitioning and gathers.

Counterpart of ``roaringbitmap_tpu/columnar/partition.py``. Matched
container pairs are classified into the 9 ``(array|bitmap|run)²`` classes
of the reference's triple-dispatch matrix (Container.java:63-98); each
class then runs as one batch: array payloads gather into CSR
``(values, offsets)`` buffers, dense payloads stack into ``[n, 1024]``
uint64 word matrices (runs through the batched interval fill), and stage 3
(engine.py) runs one kernel per occupied class.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..models.container import (
    ArrayContainer,
    BitmapContainer,
    Container,
    RunContainer,
)
from ..utils import bits
from . import kernels

ARRAY, BITMAP, RUN = 0, 1, 2
_TYPE_CODE = {ArrayContainer: ARRAY, BitmapContainer: BITMAP, RunContainer: RUN}

# 9-class labels, row-major (left type * 3 + right type): the batch
# counter's class names and the partition bookkeeping share this order
CLASS_NAMES = ("aa", "ab", "ar", "ba", "bb", "br", "ra", "rb", "rr")

_EMPTY_U16 = np.empty(0, dtype=np.uint16)
_ZERO_OFF = np.zeros(1, dtype=np.int64)


def classify(containers: Sequence[Container]) -> np.ndarray:
    """int64 type codes (ARRAY/BITMAP/RUN) for a container list; tolerant
    of subclasses through the isinstance slow path."""
    n = len(containers)
    out = np.empty(n, dtype=np.int64)
    code = _TYPE_CODE
    for i, c in enumerate(containers):
        t = code.get(type(c))
        if t is None:
            t = (
                ARRAY
                if isinstance(c, ArrayContainer)
                else BITMAP if isinstance(c, BitmapContainer) else RUN
            )
        out[i] = t
    return out


def class_histogram(codes_a: np.ndarray, codes_b: np.ndarray) -> np.ndarray:
    """Pair counts per 9-class, aligned with CLASS_NAMES."""
    if codes_a.size == 0:
        return np.zeros(9, dtype=np.int64)
    return np.bincount(codes_a * 3 + codes_b, minlength=9)[:9]


def gather_values(
    containers: Sequence[Container], idx: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """CSR gather of array-container payloads: ``(values, offsets)`` with
    ``offsets`` of length ``len(idx) + 1``."""
    if idx.size == 0:
        return _EMPTY_U16, _ZERO_OFF
    chunks = [containers[i].content for i in idx.tolist()]
    lens = np.fromiter((c.size for c in chunks), np.int64, len(chunks))
    offs = np.concatenate(([0], np.cumsum(lens)))
    return np.concatenate(chunks) if offs[-1] else _EMPTY_U16, offs


def gather_runs(
    containers: Sequence[Container], idx: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CSR gather of run-container payloads: ``(starts, lengths,
    run_offsets)``, the banded run-membership kernel's input."""
    if idx.size == 0:
        z = np.empty(0, dtype=np.uint16)
        return z, z, _ZERO_OFF
    ss = [containers[i].starts for i in idx.tolist()]
    ls = [containers[i].lengths for i in idx.tolist()]
    nruns = np.fromiter((s.size for s in ss), np.int64, len(ss))
    offs = np.concatenate(([0], np.cumsum(nruns)))
    if offs[-1] == 0:
        z = np.empty(0, dtype=np.uint16)
        return z, z, offs
    return np.concatenate(ss), np.concatenate(ls), offs


# shared zero-lengths view: array containers enter the interval gather as
# length-0 runs (value..value) without per-container allocations
_ZERO_LEN = np.zeros(4096, dtype=np.uint16)


def gather_intervals(
    containers: Sequence[Container], idx: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CSR gather of array and run payloads as runs: ``(starts, lengths,
    run_counts)``, arrays contributing their values as length-0 runs (the
    input of the banded interval algebra)."""
    if idx.size == 0:
        z16 = np.empty(0, dtype=np.uint16)
        return z16, z16, np.empty(0, dtype=np.int64)
    s_pieces: List[np.ndarray] = []
    l_pieces: List[np.ndarray] = []
    for i in idx.tolist():
        c = containers[i]
        if isinstance(c, RunContainer):
            s_pieces.append(c.starts)
            l_pieces.append(c.lengths)
        else:
            v = c.content
            s_pieces.append(v)
            l_pieces.append(_ZERO_LEN[: v.size])
    counts = np.fromiter((p.size for p in s_pieces), np.int64, len(s_pieces))
    return np.concatenate(s_pieces), np.concatenate(l_pieces), counts


def stack_words(containers: Sequence[Container], idx: np.ndarray) -> np.ndarray:
    """Stack bitmap-container word rows into one [len(idx), 1024] uint64
    matrix (row copies only)."""
    if idx.size == 0:
        return np.zeros((0, bits.WORDS_PER_CONTAINER), dtype=np.uint64)
    return np.stack([containers[i].words for i in idx.tolist()]).astype(np.uint64, copy=False)


def expand_rows(containers: Sequence[Container], idx: np.ndarray) -> np.ndarray:
    """Expand the selected containers into a fresh ``[len(idx), 1024]``
    uint64 word matrix: bitmap rows copy, array rows scatter in one batched
    call, run rows fill in one batched interval fill."""
    out = np.zeros((idx.size, bits.WORDS_PER_CONTAINER), dtype=np.uint64)
    if idx.size == 0:
        return out
    scatter_containers(
        out, np.arange(idx.size, dtype=np.int64), [containers[i] for i in idx.tolist()], op="or"
    )
    return out


def scatter_containers(
    out64: np.ndarray,
    row_ids: np.ndarray,
    containers: Sequence[Container],
    op: str = "or",
) -> None:
    """Combine ``containers[j]`` into ``out64[row_ids[j]]`` with ``op``
    (or | xor), rows possibly repeating (the N-way fold accumulators).

    One batched scatter serves every array container, one batched interval
    fill every run container; bitmap rows group per target row and reduce
    with a single ``np.bitwise_<op>.reduceat`` before combining."""
    arr_rows: List[int] = []
    arr_vals: List[np.ndarray] = []
    run_rows: List[int] = []
    run_starts: List[np.ndarray] = []
    run_lens: List[np.ndarray] = []
    bm_rows: List[int] = []
    bm_words: List[np.ndarray] = []
    for r, c in zip(row_ids.tolist(), containers):
        t = _TYPE_CODE.get(type(c))
        if t is None:
            t = BITMAP if isinstance(c, BitmapContainer) else RUN if isinstance(c, RunContainer) else ARRAY
        if t == ARRAY:
            arr_rows.append(r)
            arr_vals.append(c.content)
        elif t == BITMAP:
            bm_rows.append(r)
            bm_words.append(c.words)
        else:
            run_rows.append(r)
            run_starts.append(c.starts)
            run_lens.append(c.lengths)
    if arr_rows:
        lens = np.fromiter((v.size for v in arr_vals), np.int64, len(arr_vals))
        offs = np.concatenate(([0], np.cumsum(lens)))
        kernels.scatter_values_rows(
            np.asarray(arr_rows, dtype=np.int64), offs,
            np.concatenate(arr_vals) if offs[-1] else _EMPTY_U16, out64, op,
        )
    if run_rows:
        nruns = np.fromiter((s.size for s in run_starts), np.int64, len(run_starts))
        roffs = np.concatenate(([0], np.cumsum(nruns)))
        if roffs[-1]:
            starts = np.concatenate(run_starts).astype(np.int64)
            ends = starts + np.concatenate(run_lens).astype(np.int64) + 1
        else:
            starts = ends = np.empty(0, dtype=np.int64)
        kernels.fill_intervals_rows(
            np.asarray(run_rows, dtype=np.int64), roffs, starts, ends, out64, op
        )
    if bm_rows:
        rows = np.asarray(bm_rows, dtype=np.int64)

        def apply(targets: np.ndarray, vals: np.ndarray) -> None:
            if op == "or":
                out64[targets] |= vals
            else:
                out64[targets] ^= vals

        # pairwise / expand_rows targets are strictly increasing (one
        # container per row): combine directly — ``reduceat`` with a
        # boundary at every row reduces nothing and costs more. Repeated
        # rows (fold accumulators) keep the grouped reduce.
        if rows.size == 1 or (np.diff(rows) > 0).all():
            apply(rows, np.stack(bm_words).astype(np.uint64, copy=False))
            return
        order = np.argsort(rows, kind="stable")
        stacked = np.stack([bm_words[i] for i in order.tolist()]).astype(np.uint64, copy=False)
        sorted_rows = rows[order]
        boundaries = np.concatenate(([0], np.flatnonzero(np.diff(sorted_rows)) + 1))
        if boundaries.size == sorted_rows.size:  # all distinct, unsorted
            apply(sorted_rows, stacked)
            return
        ufunc = np.bitwise_or if op == "or" else np.bitwise_xor
        apply(sorted_rows[boundaries], ufunc.reduceat(stacked, boundaries, axis=0))
