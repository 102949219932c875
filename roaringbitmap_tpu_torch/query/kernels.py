"""N-way ANDNOT and Threshold(k) kernels — the aggregation gap fillers.

Counterpart of ``roaringbitmap_tpu/query/kernels.py``. The aggregation
layer (parallel/aggregation.py) covers n-ary AND/OR/XOR; difference exists
only pairwise and "element in >= k of N" not at all. Both kernels here
have a CPU path and a device path:

* **andnot_nway(first, \\*rest)** — ``first \\ (rest_1 | ... | rest_n)``.
  Only ``first``'s keys can survive. On the CPU the subtrahends transpose
  into key groups restricted to first's keys and the union is a word fold
  per group. On the device the union reduces on ``rb_group_reduce``
  (``store.prepare_reduce``) over the subtrahends' resident pack, the rows
  at first's covered keys are gathered, and the subtraction is one
  ``first & ~union`` mask over first's covered rows (shipped on each
  call) plus ``rb_popcount_rows``. The pack is keyed by the subtrahends
  alone, never by the minuend: it is their aggregation entry, every row —
  the pack ``FastAggregation.or_`` over the same operands builds and
  reads — so a named filter's union that has run serves every later
  andnot with any minuend, and a miss builds it once for all of them. The
  lookup counts as kind ``"andnot"`` in the pack cache's per-kind hits and
  misses.

* **threshold(k, bitmaps)** — the bit-sliced adder: per key group, fold
  each container's words into a binary counter held as L bit-slices (XOR =
  sum bit, AND = carry), then compare the per-bit counters against the
  constant k with a bitwise >= circuit (one pass MSB->LSB maintaining
  eq/gt masks). On the device the dense zero-padded ``[G, M, 2048]``
  group block goes through ``rb_threshold`` (``ops/kernels
  .threshold_rows``), adder, compare and popcount in one launch; a
  distribution too skewed to pad (``padded_device`` returns None, decided
  from the shape before any launch) takes the CPU fold, the JAX package's
  documented routing.

Both device paths keep their packs in the resident pack cache
(``store.PACK_CACHE``) under the packed operands' fingerprints and the
device (``aggregation.config.device``), so a repeated call over unchanged
bitmaps pays no host pack. Once a query's deadline has run out
(``robust/ladder``), the CPU path serves. Each device path runs through
the ``query.exec`` ladder site as its list's one tier, with the
``query.exec`` fault point, so a failed launch raises.
"""

from __future__ import annotations

from collections import Counter
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..models.container import BitmapContainer, best_container_of_words
from ..models.roaring import RoaringBitmap
from ..ops import device as dev
from .. import tracing
from ..ops import kernels
from ..robust import faults as _faults
from ..robust import ladder as _ladder
from ..robust.ladder import deadline_expired
from ..utils import bits


def _container_words(c) -> np.ndarray:
    return c.words if isinstance(c, BitmapContainer) else c.to_words()


def _query_device():
    from ..parallel import aggregation

    return resolve_device(aggregation.config.device)


def _rest_groups(first: RoaringBitmap, rest: Sequence[RoaringBitmap]):
    """Subtrahend containers keyed by first's keys only (other keys cannot
    affect the difference)."""
    first_keys = set(first.high_low_container.keys)
    groups: dict = {}
    for bm in rest:
        hlc = bm.high_low_container
        for k, c in zip(hlc.keys, hlc.containers):
            if k in first_keys:
                groups.setdefault(k, []).append(c)
    return groups


def _covered(first: RoaringBitmap, rest):
    """``(covered_keys, covered_rows)`` — the keys of ``first`` that any
    subtrahend shares, and the count of subtrahend containers on them —
    from the key lists alone, so the warm device path (resident pack-cache
    hit) never pays the container transpose."""
    fk = set(first.high_low_container.keys)
    keys: set = set()
    rows = 0
    for bm in rest:
        for k in bm.high_low_container.keys:
            if k in fk:
                keys.add(k)
                rows += 1
    return keys, rows


def _cpu_folds(first: RoaringBitmap, groups: dict):
    """The shared CPU core: per key of ``first`` yield ``(key, container,
    folded_words)`` — folded_words is None for pass-through keys with no
    subtrahend containers. One fold body serves both the materializing and
    the count-only entry points so they cannot desynchronize.

    Subtrahend sets of at least the fold gate's rows take the per-key
    union from the columnar batched OR fold (``columnar.or_fold_words``,
    one scatter/fill pass over every subtrahend container) instead of the
    per-container ``acc &= ~words`` walk, as in the JAX package."""
    from .. import columnar

    hlc = first.high_low_container
    union_words = None
    if columnar.enabled_for_fold(sum(len(cs) for cs in groups.values())):
        union_words = columnar.or_fold_words(groups)
    for k, c in zip(hlc.keys, hlc.containers):
        cs = groups.get(k)
        if not cs:
            yield k, c, None
            continue
        acc = c.to_words()
        if union_words is not None:
            acc &= ~union_words[k]
        else:
            for rc in cs:
                acc &= ~_container_words(rc)
        yield k, c, acc


def _andnot_on_device(first: RoaringBitmap, crows: int, mode: Optional[str]) -> bool:
    from ..parallel.aggregation import _use_device

    return bool(crows) and _use_device(first.high_low_container.size + crows, mode) and not (
        deadline_expired()
    )


def andnot_nway(
    first: RoaringBitmap, *rest: RoaringBitmap, mode: Optional[str] = None
) -> RoaringBitmap:
    """``first \\ (rest_1 | rest_2 | ...)`` without materializing the union
    as a bitmap (single word fold per surviving key)."""
    if not rest:
        return first.clone()
    ckeys, crows = _covered(first, rest)
    if _andnot_on_device(first, crows, mode):

        def _device_tier() -> RoaringBitmap:
            _faults.fault_point("query.exec")
            return _device_andnot(first, rest, ckeys)

        return _ladder.LADDER.run("query.exec", [("device", _device_tier)])
    out = RoaringBitmap()
    for k, c, acc in _cpu_folds(first, _rest_groups(first, rest)):
        if acc is None:
            out.high_low_container.append(k, c.clone())
            continue
        res = best_container_of_words(acc)
        if res.cardinality:
            out.high_low_container.append(k, res)
    return out


def andnot_nway_cardinality(
    first: RoaringBitmap, *rest: RoaringBitmap, mode: Optional[str] = None
) -> int:
    """``|first \\ (rest_1 | ...)|``; the device path fetches only the
    per-group popcounts."""
    if not rest:
        return first.get_cardinality()
    ckeys, crows = _covered(first, rest)
    if _andnot_on_device(first, crows, mode):

        def _device_tier() -> int:
            _faults.fault_point("query.exec")
            _, cards, passthrough, _keys = _device_andnot_parts(first, rest, ckeys)
            return int(dev.to_host_i64(cards).sum()) + sum(
                c.cardinality for _, c in passthrough
            )

        return _ladder.LADDER.run("query.exec", [("device", _device_tier)])
    return sum(
        c.cardinality if acc is None else bits.cardinality_of_words(acc)
        for _k, c, acc in _cpu_folds(first, _rest_groups(first, rest))
    )


def _device_andnot_stage(first: RoaringBitmap, rest, covered_keys: set):
    """The device andnot's union stage. Returns (first's covered rows on
    the device [G, 2048], the subtrahends' union rows at the same keys on
    the device [G, 2048], passthrough key/container pairs, sorted covered
    keys int64[G]).

    The union reduces over the subtrahends' resident aggregation pack and
    its rows at first's covered keys are gathered on the device; first's
    covered rows ship on every call, outside the pack cache."""
    from ..parallel import store

    device = _query_device()
    hlc = first.high_low_container
    covered = [(k, c) for k, c in zip(hlc.keys, hlc.containers) if k in covered_keys]
    passthrough = [
        (k, c) for k, c in zip(hlc.keys, hlc.containers) if k not in covered_keys
    ]
    keys = np.asarray(sorted(covered_keys), dtype=np.int64)
    with tracing.op_timer("query.andnot.device"):
        packed = store.PACK_CACHE.get_packed(rest, device=device, kind="andnot")
        run, _layout = store.prepare_reduce(packed, op="or")
        union, _ = run()
        at = torch.from_numpy(np.searchsorted(packed.group_keys, keys)).to(union.device)
        union = union.index_select(0, at)
        first_rows = store.ship_rows([c for _, c in covered], device)
    return first_rows, union, passthrough, keys


def _device_andnot_parts(first: RoaringBitmap, rest, covered_keys: set):
    """Shared device core: the union stage above, then the ``first &
    ~union`` mask (torch ops) and ``rb_popcount_rows``. Returns (masked
    device words [G, 2048], cards [G], passthrough key/container pairs for
    first's uncovered keys, sorted covered keys int64[G])."""
    first_rows, union, passthrough, keys = _device_andnot_stage(first, rest, covered_keys)
    masked = first_rows & ~union
    return masked, kernels.popcount_rows(masked), passthrough, keys


def _device_andnot(first: RoaringBitmap, rest, covered_keys: set) -> RoaringBitmap:
    from ..parallel import store

    masked, cards, passthrough, keys = _device_andnot_parts(first, rest, covered_keys)
    words, cards = dev.to_host_u32(masked), dev.to_host_i64(cards)
    with tracing.op_timer("query.andnot.assemble"):
        computed = dict(store.iter_group_containers(keys, words, cards))
        out = RoaringBitmap()
        merged = {k: c.clone() for k, c in passthrough}
        merged.update(computed)
        for k in sorted(merged):
            out.high_low_container.append(k, merged[k])
        return out


# ---------------------------------------------------------------------------
# Threshold(k): bit-sliced adder
# ---------------------------------------------------------------------------


def _add_word_slices(slices: List[np.ndarray], carry: np.ndarray) -> None:
    """Binary counter increment: add the 0/1 word ``carry`` into the LSB of
    the bit-sliced counter (XOR = sum, AND = carry ripple)."""
    i = 0
    while i < len(slices) and carry.any():
        s = slices[i]
        slices[i] = s ^ carry
        carry = s & carry
        i += 1
    if carry.any():
        slices.append(carry)


def _ge_const_words(slices: List[np.ndarray], k: int) -> Optional[np.ndarray]:
    """Bitwise compare of the per-position counters against the constant k:
    one MSB->LSB pass maintaining equal-so-far / greater masks. None when
    the counter width cannot reach k."""
    L = len(slices)
    if (k >> L) != 0:
        return None
    eq = np.full_like(slices[0], ~np.uint64(0))
    gt = np.zeros_like(slices[0])
    for b in range(L - 1, -1, -1):
        s = slices[b]
        if (k >> b) & 1:
            eq = eq & s
        else:
            gt = gt | (eq & s)
            eq = eq & ~s
    return gt | eq


def threshold(
    k: int, bitmaps: Sequence[RoaringBitmap], mode: Optional[str] = None
) -> RoaringBitmap:
    """Values present in at least ``k`` of ``bitmaps`` (multiset: a bitmap
    passed twice counts twice). k=1 is OR, k=N is AND, k>N is empty."""
    from ..parallel import aggregation, store

    k = int(k)
    if k < 1:
        raise ValueError(f"threshold k must be >= 1, got {k}")
    bms = list(bitmaps)
    if k > len(bms):
        return RoaringBitmap()
    if k == 1:
        return aggregation.FastAggregation.or_(*bms, mode=mode)
    if k == len(bms):
        return aggregation.FastAggregation.and_(*bms, mode=mode)
    keys_ok, n_rows = _threshold_keys_ok(bms, k)
    out = RoaringBitmap()
    if not keys_ok:
        return out
    if aggregation._use_device(n_rows, mode) and not deadline_expired():

        def _device_tier():
            _faults.fault_point("query.exec")
            return _device_threshold(bms, k, keys_ok)

        dev_out = _ladder.LADDER.run("query.exec", [("device", _device_tier)])
        if dev_out is not None:  # None: too skewed to pad, the CPU fold serves
            return dev_out
    groups = store.group_by_key(bms, keys_filter=keys_ok)
    for key in sorted(groups):
        slices: List[np.ndarray] = []
        for c in groups[key]:
            _add_word_slices(slices, c.to_words())
        words = _ge_const_words(slices, k)
        if words is None:
            continue
        res = best_container_of_words(words)
        if res.cardinality:
            out.high_low_container.append(key, res)
    return out


def _threshold_keys_ok(bms, k: int):
    """The >= k key pre-filter: a key present in fewer than k containers
    can never reach the threshold — decided from the key lists alone so
    the warm device path (resident pack-cache hit) skips the container
    transpose entirely. Returns (surviving key set, surviving row count)."""
    key_counts = Counter()
    for bm in bms:
        key_counts.update(bm.high_low_container.keys)
    keys_ok = {key for key, c in key_counts.items() if c >= k}
    n_rows = sum(c for key, c in key_counts.items() if key in keys_ok)
    return keys_ok, n_rows


def _threshold_device_block(bms, k: int, keys_ok: set):
    """The device threshold's resident pack + dense zero-padded block:
    returns ``(packed, words3 [G, M, 2048], n_slices)``, or None when the
    group distribution is too skewed to pad (the caller takes the CPU
    fold). k is part of the key: it decides which key groups survive the
    >= k pre-filter, hence the pack contents."""
    from ..parallel import store

    device = _query_device()

    def _build():
        p = store.pack_groups(store.group_by_key(bms, keys_filter=keys_ok), device)
        return p, p.words_nbytes

    key = ("threshold", k, tuple(bm.fingerprint() for bm in bms), str(device))
    packed = store.PACK_CACHE.get_or_build(key, _build, refs=store.static_fp_refs(bms))
    words3 = packed.padded_device(0)  # zero fill rows add nothing to counts
    if words3 is None:
        # too skewed to pad: the CPU fold serves this working set, so a
        # resident pack would only squat on the shared budget — drop it
        store.PACK_CACHE.discard(key)
        return None
    m = int(words3.shape[1])
    n_slices = max(1, m.bit_length())  # counters reach at most m < 2^L
    return packed, words3, n_slices


def _device_threshold(bms, k: int, keys_ok: set) -> Optional[RoaringBitmap]:
    """Dense-padded device path: one ``rb_threshold`` launch; None when the
    group distribution is too skewed to pad."""
    from ..parallel import store

    block = _threshold_device_block(bms, k, keys_ok)
    if block is None:
        return None
    packed, words3, n_slices = block
    if (k >> n_slices) != 0:
        return RoaringBitmap()
    with tracing.op_timer("query.threshold.device"):
        red, cards = kernels.threshold_rows(words3, k, n_slices)
        return store.unpack_to_bitmap(
            packed.group_keys, dev.to_host_u32(red), dev.to_host_i64(cards)
        )
