"""Batched per-class host kernels of the columnar pairwise engine.

Counterpart of ``roaringbitmap_tpu/columnar/kernels.py``. Two host tiers
compute the same bits. Under the native tier (``native.config.tier``, the
default) every batch primitive is one call of a compiled two-pointer loop
over CSR offset arrays (``native/kernels.cpp`` ``rb_batch_*``, OpenMP over
the pairs). The ``*_numpy`` functions are the plain versions, and the
numpy tier: every primitive executes a whole batch of container payloads
in one call through the *banding* trick: pair ``j``'s uint16 payload is
lifted into its own disjoint int64 band ``j * 2^16 + value``, after which
ONE global sort / searchsorted over the concatenation performs every
pair's merge at once (bands never interleave, so a global sort is a
per-pair merge). A failure of the native tier raises; nothing degrades to
numpy. The native batch kernels hold the ``columnar.kernel`` fault site
(``_native_entry``), where the JAX package degrades to its numpy tier; an
injected or real failure there raises, classified by
``robust.errors.classify``.

Ops are the four pairwise set operations on sorted unique uint16 arrays;
the word-matrix primitives (scatter, interval fill, per-row popcount)
serve the dense classes and the N-way folds. The device tier
(``columnar/device.py``) runs the word-parallel classes on the card; these
stay the engines of the value-sized classes on every tier.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .. import native
from ..robust import faults as _faults
from ..robust.errors import TierUnavailable
from ..utils import bits

_WORDS = bits.WORDS_PER_CONTAINER  # 1024
_ONES = np.uint64(0xFFFFFFFFFFFFFFFF)
# each byte value's set-bit count and bit positions (flat, ascending, from
# _BIT_OFF[value]): the bit unpack of ``values_rows``
_POP8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.int64)
_BIT_OFF = np.concatenate(([0], np.cumsum(_POP8)[:-1]))
_BIT_POS = np.array([b for i in range(256) for b in range(8) if i >> b & 1], dtype=np.int64)


# ---------------------------------------------------------------------------
# sorted-u16 CSR batch algebra
# ---------------------------------------------------------------------------


def _banded(vals: np.ndarray, offs: np.ndarray) -> np.ndarray:
    """Lift pair j's values into band j: int64 ``(j << 16) | value``."""
    lens = np.diff(offs)
    band = np.repeat(np.arange(lens.size, dtype=np.int64), lens) << 16
    return vals.astype(np.int64) + band


def _member(ag: np.ndarray, bg: np.ndarray) -> np.ndarray:
    """Is each banded value of ``ag`` in the sorted banded ``bg``?"""
    if not bg.size:
        return np.zeros(ag.size, dtype=bool)
    pos = np.searchsorted(bg, ag)
    posc = np.minimum(pos, bg.size - 1)
    return (pos < bg.size) & (bg[posc] == ag)


def has_native() -> bool:
    """Does the native tier serve the batch kernels? (Built at the first
    call under ``native.config.tier == "native"``; a failed build raises
    TierUnavailable.)"""
    return native.available()


def _native_entry() -> bool:
    """``has_native()`` for a native batch kernel about to run: the
    ``columnar.kernel`` fault site fires here when the native tier
    serves."""
    if not has_native():
        return False
    _faults.fault_point("columnar.kernel")
    return True


def batch_pairwise(
    avals: np.ndarray, aoffs: np.ndarray, bvals: np.ndarray, boffs: np.ndarray, op: str
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All pairs' ``a[j] OP b[j]`` in one call.

    Returns ``(values, starts, counts)``: pair j's result values are
    ``values[starts[j] : starts[j] + counts[j]]`` (on the native tier the
    values buffer is a scratch sized by each pair's worst case: callers
    copy their slice out before holding it)."""
    n = aoffs.size - 1
    if n == 0:
        z = np.empty(0, dtype=np.int64)
        return np.empty(0, dtype=np.uint16), z, z
    if not _native_entry():
        return batch_pairwise_numpy(avals, aoffs, bvals, boffs, op)
    alens = np.diff(aoffs)
    blens = np.diff(boffs)
    if op == "and":
        bounds = np.minimum(alens, blens)
    elif op == "andnot":
        bounds = alens
    else:
        bounds = alens + blens
    starts = np.concatenate(([0], np.cumsum(bounds)))
    out, counts = native.batch_pairwise_u16(avals, aoffs, bvals, boffs, op, starts[:-1], int(starts[-1]))
    return out, starts[:-1], counts


def batch_pairwise_numpy(
    avals: np.ndarray, aoffs: np.ndarray, bvals: np.ndarray, boffs: np.ndarray, op: str
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The banded plain version of :func:`batch_pairwise` (results
    packed, no scratch)."""
    n = aoffs.size - 1
    if n == 0:
        z = np.empty(0, dtype=np.int64)
        return np.empty(0, dtype=np.uint16), z, z
    ag = _banded(avals, aoffs)
    bg = _banded(bvals, boffs)
    if op in ("and", "andnot"):
        member = _member(ag, bg)
        kept = ag[member if op == "and" else ~member]
    elif op == "or":
        m = np.sort(np.concatenate([ag, bg]))
        keep = np.ones(m.size, dtype=bool)
        keep[1:] = m[1:] != m[:-1]
        kept = m[keep]
    else:  # xor: each side is unique, so a value appears at most twice
        m = np.sort(np.concatenate([ag, bg]))
        solo = np.ones(m.size, dtype=bool)
        solo[1:] &= m[1:] != m[:-1]
        solo[:-1] &= m[:-1] != m[1:]
        kept = m[solo]
    counts = np.bincount(kept >> 16, minlength=n)[:n]
    offs = np.concatenate(([0], np.cumsum(counts)))
    return (kept & 0xFFFF).astype(np.uint16), offs[:-1], counts


def batch_run_pairwise(
    as_: np.ndarray, al: np.ndarray, acnt: np.ndarray,
    bs_: np.ndarray, bl: np.ndarray, bcnt: np.ndarray,
    op: str, cards_only: bool = False,
):
    """Run-unified batch AND/ANDNOT over CSR run payloads (arrays enter as
    length-0 runs), native tier only: the numpy tier serves these classes
    with ``run_member_mask`` and ``interval_batch``. Returns ``(out_starts,
    out_lengths, starts, interval_counts, cards)`` — result intervals, pair
    j's at ``starts[j] : starts[j] + interval_counts[j]`` — or just the
    per-pair cardinalities when ``cards_only``."""
    if not _native_entry():
        raise TierUnavailable("batch_run_pairwise runs on the native host tier only")
    aoffs = np.concatenate(([0], np.cumsum(acnt)))
    boffs = np.concatenate(([0], np.cumsum(bcnt)))
    if cards_only:
        _s, _l, _counts, cards = native.batch_run_pairwise(as_, al, aoffs, bs_, bl, boffs, op, None, 0)
        return cards
    bounds = acnt + bcnt  # an output interval ends at an input endpoint
    starts = np.concatenate(([0], np.cumsum(bounds)))
    out_s, out_l, counts, cards = native.batch_run_pairwise(
        as_, al, aoffs, bs_, bl, boffs, op, starts[:-1], int(starts[-1])
    )
    return out_s, out_l, starts[:-1], counts, cards


def batch_and_cardinality(
    avals: np.ndarray, aoffs: np.ndarray, bvals: np.ndarray, boffs: np.ndarray
) -> np.ndarray:
    """Per-pair ``|a[j] & b[j]|`` without materialization."""
    n = aoffs.size - 1
    if n == 0:
        return np.empty(0, dtype=np.int64)
    if _native_entry():
        return native.batch_intersect_card_u16(avals, aoffs, bvals, boffs)
    return batch_and_cardinality_numpy(avals, aoffs, bvals, boffs)


def batch_and_cardinality_numpy(
    avals: np.ndarray, aoffs: np.ndarray, bvals: np.ndarray, boffs: np.ndarray
) -> np.ndarray:
    """The banded plain version of :func:`batch_and_cardinality`."""
    n = aoffs.size - 1
    if n == 0:
        return np.empty(0, dtype=np.int64)
    ag = _banded(avals, aoffs)
    member = _member(ag, _banded(bvals, boffs))
    return np.bincount((ag >> 16)[member], minlength=n)[:n].astype(np.int64)


# ---------------------------------------------------------------------------
# word-matrix primitives
# ---------------------------------------------------------------------------


def popcount_rows(mat: np.ndarray) -> np.ndarray:
    """Per-row popcount of an [n, 1024] uint64 matrix (batched result
    cardinalities: one call for the whole batch's format selection)."""
    if mat.shape[0] == 0:
        return np.empty(0, dtype=np.int64)
    if mat.flags.c_contiguous and _native_entry():
        return native.popcount_rows(mat)
    return popcount_rows_numpy(mat)


def popcount_rows_numpy(mat: np.ndarray) -> np.ndarray:
    """The plain version of :func:`popcount_rows`."""
    if mat.shape[0] == 0:
        return np.empty(0, dtype=np.int64)
    return bits.popcount64(mat).sum(axis=1).astype(np.int64)


def scatter_values_rows(
    row_ids: np.ndarray, offsets: np.ndarray, vals: np.ndarray,
    out64: np.ndarray, op: str = "or",
) -> None:
    """Scatter concatenated array-container values into word rows with
    or/xor/clear combine; ``row_ids`` may repeat (fold accumulators)."""
    if row_ids.size == 0:
        return
    if _native_entry():
        native.scatter_values_rows(row_ids, offsets, vals, out64, op)
        return
    scatter_values_rows_numpy(row_ids, offsets, vals, out64, op)


def scatter_values_rows_numpy(
    row_ids: np.ndarray, offsets: np.ndarray, vals: np.ndarray,
    out64: np.ndarray, op: str = "or",
) -> None:
    """The plain version of :func:`scatter_values_rows`. A read-only
    target raises (``ufunc.at`` would write through the flag)."""
    if not out64.flags.writeable:
        raise ValueError("scatter_values_rows needs a writable target")
    if row_ids.size == 0:
        return
    lens = np.diff(offsets)
    rows = np.repeat(np.asarray(row_ids, dtype=np.int64), lens)
    v = vals.astype(np.int64)
    flat = rows * _WORDS + (v >> 6)
    bit = np.uint64(1) << (v & 63).astype(np.uint64)
    flat_out = out64.reshape(-1)
    if op == "or":
        np.bitwise_or.at(flat_out, flat, bit)
    elif op == "xor":
        np.bitwise_xor.at(flat_out, flat, bit)
    else:  # clear (andnot)
        np.bitwise_and.at(flat_out, flat, ~bit)


def fill_intervals_rows(
    row_ids: np.ndarray, run_offs: np.ndarray, starts: np.ndarray,
    ends: np.ndarray, out64: np.ndarray, op: str = "or",
) -> None:
    """Expand many run containers' half-open [start, end) intervals into
    word rows (or: set, xor: flip) in one call; rows may repeat (fold
    accumulators)."""
    if row_ids.size == 0:
        return
    if _native_entry():
        native.fill_intervals_rows(row_ids, run_offs, starts, ends, out64, op)
        return
    fill_intervals_rows_numpy(row_ids, run_offs, starts, ends, out64, op)


def fill_intervals_rows_numpy(
    row_ids: np.ndarray, run_offs: np.ndarray, starts: np.ndarray,
    ends: np.ndarray, out64: np.ndarray, op: str = "or",
) -> None:
    """The plain version of :func:`fill_intervals_rows`, one vectorized
    pass: each interval's first and last words take a masked combine, the
    whole words between are set (or) or flipped (xor). Rows may repeat and
    intervals overlap: the combines are unbuffered (``ufunc.at``), so a
    read-only target raises here rather than being written through."""
    if not out64.flags.writeable:
        raise ValueError("fill_intervals_rows needs a writable target")
    if row_ids.size == 0:
        return
    rows = np.repeat(np.asarray(row_ids, dtype=np.int64), np.diff(run_offs))
    s = np.asarray(starts, dtype=np.int64)
    e = np.minimum(np.asarray(ends, dtype=np.int64), 1 << 16)
    live = s < e
    if not live.all():
        rows, s, e = rows[live], s[live], e[live]
    if s.size == 0:
        return
    first, last = s >> 6, (e - 1) >> 6
    lo = _ONES << (s & 63).astype(np.uint64)
    hi = _ONES >> (63 - ((e - 1) & 63)).astype(np.uint64)
    one_word = first == last
    flat_out = out64.reshape(-1)
    base = rows * _WORDS
    combine = np.bitwise_or if op == "or" else np.bitwise_xor
    combine.at(flat_out, base + first, np.where(one_word, lo & hi, lo))
    multi = ~one_word
    combine.at(flat_out, (base + last)[multi], hi[multi])
    n_mid = np.where(multi, last - first - 1, 0)
    total = int(n_mid.sum())
    if total:
        mid = np.repeat(base + first + 1 - (np.cumsum(n_mid) - n_mid), n_mid) + np.arange(total)
        if op == "or":
            flat_out[mid] = _ONES
        else:
            np.bitwise_xor.at(flat_out, mid, _ONES)


def values_rows(mat: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Every row's set bits as sorted uint16 values, CSR ``(values,
    offsets)``, for a C-contiguous ``[n, 1024]`` uint64 matrix (the batched
    form of ``bits.values_from_words``): one nonzero pass over its bytes
    (little-endian, byte p of a row holds values 8p..8p+7), then each
    nonzero byte's bit positions from a 256-entry table."""
    byts = mat.view(np.uint8)
    r, p = np.nonzero(byts)
    v = byts[r, p]
    cnt = _POP8[v]
    total = int(cnt.sum())
    within = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    vals = np.repeat(p << 3, cnt) + _BIT_POS[np.repeat(_BIT_OFF[v], cnt) + within]
    counts = np.bincount(r, weights=cnt, minlength=mat.shape[0]).astype(np.int64)
    return vals.astype(np.uint16), np.concatenate(([0], np.cumsum(counts)))


def run_member_mask(
    vals: np.ndarray,
    val_offs: np.ndarray,
    starts: np.ndarray,
    lengths: np.ndarray,
    run_offs: np.ndarray,
) -> np.ndarray:
    """Batched run membership without word expansion: one banded
    right-searchsorted answers every probe of every array x run pair.

    Probes and runs lift into band ``j << 17``; the gap above 2^16 makes
    any cross-band distance exceed the longest run, so a probe can never
    match the previous pair's last run."""
    n = val_offs.size - 1
    if vals.size == 0:
        return np.zeros(0, dtype=bool)
    band_v = np.repeat(np.arange(n, dtype=np.int64) << 17, np.diff(val_offs))
    vg = vals.astype(np.int64) + band_v
    band_r = np.repeat(np.arange(n, dtype=np.int64) << 17, np.diff(run_offs))
    sg = starts.astype(np.int64) + band_r
    if sg.size == 0:
        return np.zeros(vals.size, dtype=bool)
    idx = np.searchsorted(sg, vg, side="right") - 1
    idxc = np.maximum(idx, 0)
    return (idx >= 0) & (vg - sg[idxc] <= lengths.astype(np.int64)[idxc])


def member_mask(
    words_rows: np.ndarray, row_ids: np.ndarray, vals: np.ndarray
) -> np.ndarray:
    """Vectorized word-test gather: is ``vals[i]`` set in row
    ``row_ids[i]`` of the stacked uint64 word matrix?"""
    v = vals.astype(np.int64)
    return (
        (words_rows[row_ids, v >> 6] >> (v & 63).astype(np.uint64)) & np.uint64(1)
    ).astype(bool)


def interval_batch(
    as_: np.ndarray, al: np.ndarray, acnt: np.ndarray,
    bs_: np.ndarray, bl: np.ndarray, bcnt: np.ndarray,
    op: str, cards_only: bool = False,
):
    """Banded interval algebra for a whole bucket of (array|run) x
    (array|run) pairs: one global sort and four searchsorteds evaluate
    every pair's boolean combination (for a segment in band j, every
    earlier band's starts and ends both precede it, so the global
    #starts > #ends test sees only band j's open intervals).

    Inputs are CSR run payloads (arrays enter as length-0 runs). Returns
    the result intervals ``(out_starts, out_ends, starts, counts)`` with
    band-local half-open bounds, pair j's at ``starts[j] : starts[j] +
    counts[j]``, or just per-pair cardinalities when ``cards_only``."""
    n = acnt.size
    band_a = np.repeat(np.arange(n, dtype=np.int64) << 17, acnt)
    band_b = np.repeat(np.arange(n, dtype=np.int64) << 17, bcnt)
    ga_s = as_.astype(np.int64) + band_a
    ga_e = ga_s + al.astype(np.int64) + 1
    gb_s = bs_.astype(np.int64) + band_b
    gb_e = gb_s + bl.astype(np.int64) + 1
    pts = np.unique(np.concatenate([ga_s, ga_e, gb_s, gb_e]))
    seg = pts[:-1]
    in_a = np.searchsorted(ga_s, seg, side="right") > np.searchsorted(ga_e, seg, side="right")
    in_b = np.searchsorted(gb_s, seg, side="right") > np.searchsorted(gb_e, seg, side="right")
    if op == "and":
        keep = in_a & in_b
    elif op == "andnot":
        keep = in_a & ~in_b
    elif op == "or":
        keep = in_a | in_b
    else:  # xor
        keep = in_a ^ in_b
    change = np.diff(keep.astype(np.int8), prepend=np.int8(0), append=np.int8(0))
    out_s = pts[change == 1]
    out_e = pts[np.nonzero(change == -1)[0]]
    if cards_only:
        return np.bincount(out_s >> 17, weights=out_e - out_s, minlength=n)[:n].astype(np.int64)
    counts = np.bincount(out_s >> 17, minlength=n)[:n]
    starts = np.concatenate(([0], np.cumsum(counts)))[:-1]
    # strip the band: local values fit 17 bits (ends may be exactly 2^16)
    return out_s & 0x1FFFF, out_e & 0x1FFFF, starts, counts
