"""Device tier of the columnar pairwise engine.

Counterpart of ``roaringbitmap_tpu/columnar/device.py``. It feeds the
same 9-class partition as the CPU engine (engine.py) from resident flat
rows — one ``int32 [n, 2048]`` row per container, built once per bitmap by
the device-side expansion (``store.ship_rows``) and kept in
``store.PACK_CACHE`` under kind ``colrows`` — and runs the word-parallel
classes on ``aggregation.config.device``:

* **dense classes** — ``bb`` and every class the CPU engine serves with
  word matrices (``br``/``rb`` for and/andnot, every non-``aa`` class for
  or/xor, ``ba`` under andnot): ONE ``rb_pair_rows`` launch per bucket
  (``ops/kernels.pair_rows_reduce``) gathers both sides' rows from the
  resident blocks, applies the op and popcounts every row; the words and
  counts come back to the host, where the popcount selects each result's
  container format;
* **array x bitmap** — a word-test gather on the device
  (``ops/kernels.word_test_rows``): every probe value of every pair tests
  against the resident bitmap rows and only the boolean mask comes back;
* **array x array and the bitmap-free run classes** stay on the host
  (``engine._fill_nonbm``): their payloads are value-sized, and word
  expansion would manufacture the work the run form avoids.

The container build is on the host, as in the JAX package; results are
value-identical to the CPU tiers, which keep run-shaped results as runs
where this tier builds arrays or bitmaps by cardinality.

Unlike the JAX package, a side's rows are fetched only when a device
bucket of the batch needs them: a pair whose classes the host serves (an
and/andnot pair without a bitmap container) ships and keeps nothing. Left
out here: the rows are not padded to a power-of-two count (that bounded
XLA retraces); index streams are exact and checked against their block on
the host. The tier holds the ``columnar.device`` fault site at its entry;
the engine runs it under ``robust.ladder.retry``, so a transient failure
is retried on the card and anything else raises — there is no
device-to-CPU degrade. Each device bucket times into the engine's
per-class histogram (``device_pair``, ``device_gather``), and
``rows_resident`` / ``rows_resident_hlc`` answer the router's residency
probe from the pack cache without building anything.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..models.container import Container
from ..ops import device as dev
from ..ops import kernels as K
from ..robust import faults as _faults
from . import engine as _engine
from .partition import ARRAY, BITMAP, classify, gather_values


def _device() -> torch.device:
    from ..parallel import aggregation

    return resolve_device(aggregation.config.device)


def _colrows_key(hlc, device: torch.device) -> tuple:
    """The one spelling of the cache key of a bitmap's resident rows
    (``rows_for``'s, and the one a residency probe looks up)."""
    from ..models.roaring import hlc_fingerprint

    return ("colrows", str(device), hlc_fingerprint(hlc))


def rows_for(bm, device=None) -> torch.Tensor:
    """The bitmap's containers as resident flat rows (int32 ``[n, 2048]``
    on ``device``, default ``aggregation.config.device``), keyed by its
    fingerprint: built once through the device-side expansion, then every
    pairwise op over this bitmap gathers from the resident block. A
    mutated bitmap has a new fingerprint and so new rows."""
    from ..parallel import store

    device = _device() if device is None else resolve_device(device)
    key = _colrows_key(bm.high_low_container, device)

    def build():
        rows = store.ship_rows(bm.high_low_container.containers, device)
        return rows, rows.numel() * 4

    return store.PACK_CACHE.get_or_build(key, build, refs=store.static_fp_refs([bm]))


def rows_resident_hlc(hlc) -> bool:
    """Are this container array's flat rows already resident on the tier's
    device? One lookup under the cache lock; never builds (the router's
    decision provenance)."""
    from ..parallel import store

    return _colrows_key(hlc, _device()) in store.PACK_CACHE


def rows_resident_pair(a_hlc, b_hlc) -> tuple:
    """``(rows_resident_hlc(a_hlc), rows_resident_hlc(b_hlc))`` with the
    device resolved once (the router probes both sides of every verdict)."""
    from ..parallel import store

    device = _device()
    cache = store.PACK_CACHE
    return _colrows_key(a_hlc, device) in cache, _colrows_key(b_hlc, device) in cache


def rows_resident(bm) -> bool:
    return rows_resident_hlc(bm.high_low_container)


def index_stream(idx: np.ndarray, n_rows: int, device: torch.device) -> torch.Tensor:
    """Row indices into a block of ``n_rows`` rows as int32 on ``device``,
    each checked against the block on the host."""
    idx = np.asarray(idx, dtype=np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= n_rows):
        raise IndexError(f"row index outside the block of {n_rows} rows")
    return torch.from_numpy(idx.astype(np.int32)).to(device)


def _once(fetch):
    """``fetch()`` on the first call, the same result after."""
    box = []

    def get():
        if not box:
            box.append(fetch())
        return box[0]

    return get


def _fill_dense_device(op: str, side_a, side_b, idx: np.ndarray, results, pending: list) -> None:
    """The word-parallel classes: one ``rb_pair_rows`` launch over the
    resident rows, then the words and counts to the host and the
    card-driven container build. ``side_a`` / ``side_b`` return a side's
    ``(rows, row index of each matched pair)``."""
    if idx.size == 0:
        return
    with _engine._kernel_stage(op, "device_pair", int(idx.size)):
        (rows_a, ia), (rows_b, ib) = side_a(), side_b()
        words, cards = K.pair_rows_reduce(
            rows_a, index_stream(ia[idx], rows_a.shape[0], rows_a.device),
            rows_b, index_stream(ib[idx], rows_b.shape[0], rows_b.device), op,
        )
        words64 = dev.to_host_u32(words).view(np.uint64)
        _engine._format_rows_results(words64, cards.cpu().numpy(), idx, results)
    pending.append(("device_pair", int(idx.size)))


def _fill_gather_device(
    op: str, probe_cs: Sequence[Container], side_dense, idx: np.ndarray, results, pending: list
) -> None:
    """array x bitmap on the device: the bucket's membership probes run as
    one word-test gather against the resident rows; only the boolean mask
    comes back, and the host keeps or drops values as the CPU gather
    class does."""
    if idx.size == 0:
        return
    pending.append(("device_gather", int(idx.size)))
    with _engine._kernel_stage(op, "device_gather", int(idx.size)):
        vals, offs = gather_values(probe_cs, idx)
        if vals.size == 0:
            return
        rows_dense, dense_take = side_dense()
        row_ids = np.repeat(dense_take[idx], np.diff(offs))
        mask = K.word_test_rows(
            rows_dense, index_stream(row_ids, rows_dense.shape[0], rows_dense.device),
            torch.from_numpy(vals.astype(np.int32)).to(rows_dense.device),
        )
        _engine._build_gather_results(op, vals, offs, mask.cpu().numpy(), idx, results)


def matched_results_device_multi(op: str, jobs, acs_all, bcs_all) -> List[Optional[Container]]:
    """Many pairs' matched containers against ONE combined pair of row
    blocks. ``jobs`` is ``[(x1, x2, keyplan)]`` and ``acs_all`` /
    ``bcs_all`` their matched containers in job order. Each side's distinct
    operands' resident rows concatenate once, when a device bucket needs
    them (``ops/kernels.concat_rows``, deduplicated by block identity),
    the per-pair row indices shift by their block's offset, and the
    combined inputs run through :func:`matched_results_device` unchanged:
    the dense bucket is one ``rb_pair_rows`` launch and the probe bucket
    one word-test gather for the whole window."""
    if not acs_all:
        return []

    def combine(side: int):
        blocks: List[torch.Tensor] = []
        offsets: dict = {}
        parts: List[np.ndarray] = []
        total = 0
        for x1, x2, plan in jobs:
            rows = rows_for(x1 if side == 0 else x2)
            off = offsets.get(id(rows))
            if off is None:
                off = offsets[id(rows)] = total
                total += rows.shape[0]
                blocks.append(rows)
            parts.append((plan.ia if side == 0 else plan.ib) + off)
        idx = np.concatenate(parts) if parts else np.empty(0, dtype=np.int64)
        return K.concat_rows(blocks), idx

    return matched_results_device(op, acs_all, bcs_all, lambda: combine(0), lambda: combine(1))


def matched_results_device(
    op: str, acs: Sequence[Container], bcs: Sequence[Container], side_a, side_b
) -> List[Optional[Container]]:
    """Per-class execution with the word-parallel buckets on the device —
    the device twin of ``engine._matched_results``. ``side_a()`` /
    ``side_b()`` return ``(rows, index)``: an operand side's resident row
    block and the row of each matched pair in it; each is called at most
    once, and only if a device bucket needs that side."""
    n = len(acs)
    results: List[Optional[Container]] = [None] * n
    if n == 0:
        return results
    _faults.fault_point("columnar.device")
    side_a, side_b = _once(side_a), _once(side_b)
    codes_a = classify(acs)
    codes_b = classify(bcs)
    hist = _engine.class_histogram(codes_a, codes_b)
    # the device buckets' counts, added with the class counts once every
    # bucket has run
    pending: list = []
    a_arr = codes_a == ARRAY
    b_arr = codes_b == ARRAY
    a_bm = codes_a == BITMAP
    b_bm = codes_b == BITMAP
    if op in ("and", "andnot"):
        # bitmap-free classes (aa/ar/ra/rr) on the host
        _engine._fill_nonbm(op, acs, bcs, codes_a, codes_b, hist, results)
        _fill_gather_device(op, acs, side_b, np.flatnonzero(a_arr & b_bm), results, pending)
        if op == "and":
            _fill_gather_device(op, bcs, side_a, np.flatnonzero(b_arr & a_bm), results, pending)
            dense = np.flatnonzero((a_bm & ~b_arr) | (~a_arr & b_bm))
        else:
            # ba under andnot rides the dense op too: b's array container is
            # a word row of the resident block, so a & ~b is one launch
            dense = np.flatnonzero((a_bm & ~b_arr) | (~a_arr & b_bm) | (a_bm & b_arr))
        _fill_dense_device(op, side_a, side_b, dense, results, pending)
    else:  # or / xor: aa stays on the CSR batch kernel, the rest is dense
        _engine._fill_aa(op, acs, bcs, np.flatnonzero(a_arr & b_arr), results)
        _fill_dense_device(op, side_a, side_b, np.flatnonzero(~(a_arr & b_arr)), results, pending)
    _engine._inc_classes(op, hist)
    for klass, n_pairs in pending:
        _engine._count(op, klass, n_pairs)
    return results
