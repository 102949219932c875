"""Stage 3 of the columnar pairwise engine: per-class batch execution.

Counterpart of ``roaringbitmap_tpu/columnar/engine.py``. ``pairwise``
executes a whole bitmap-pair op — key plan, 9-class type partition, one
batch kernel per occupied class, batched result-format selection — with
no per-container Python dispatch on the matched path. ``fold`` /
``or_fold_words`` apply the same machinery to the N-way CPU folds.

Result formats select in batch: the interval classes of and/andnot apply
the reference's full size rule (run iff 2+4·nruns smallest, so run-shaped
results stay compressed); the word-matrix classes normalize to
array<=4096<bitmap like ``best_container_of_words``. Either way results are
value-identical to the per-container engine (``==`` compares values, not
forms). Pass-through containers keep their form: transferred unclone'd
under member-op semantics (``reuse_left``), cloned otherwise.

Left out here, relative to the JAX package, until the next slice of the
port (ROADMAP Queue A item 3b) wires this engine into ``observe``: the
``columnar.cutoff`` decision log, ``Verdict``, the outcome join and the
per-class spans (``route`` returns a plain ``str`` and ``outcome()`` is a
null context), and the ``columnar.kernel`` fault site. There is no
device-to-CPU degradation — a failure of the device tier or of the native
host tier raises. The batch and route counters are plain dicts
(``BATCH_COUNTS``, ``ROUTE_COUNTS``); ``ops/kernels.LAUNCHES`` is a
registry view since the registry came to the port.
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager, nullcontext
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..models.container import (
    ARRAY_MAX_SIZE,
    ArrayContainer,
    BitmapContainer,
    Container,
    RunContainer,
    _container_of_intervals,
    _wrap_u16,
)
from ..models.roaring import RoaringBitmap
from ..robust.ladder import deadline_expired
from ..utils import bits
from . import costmodel as _costmodel
from . import kernels
from .keyplan import key_plan
from .partition import (
    ARRAY,
    BITMAP,
    CLASS_NAMES,
    class_histogram,
    classify,
    expand_rows,
    gather_intervals,
    gather_runs,
    gather_values,
    scatter_containers,
    stack_words,
)


class config:
    """Columnar dispatch knobs.

    ``min_containers`` — a pair routes columnar only when BOTH operands
    hold at least this many containers (below it the per-container walk's
    constant factor wins). ``max_containers`` — above it (many thousands
    of necessarily tiny containers) the per-container walk keeps the pair
    too. ``min_fold_rows`` — row cutoff of the N-way CPU folds.
    ``chunk_rows`` bounds the dense-class word matrices (~3 * 8 KiB a
    row). ``ROARINGBITMAP_TPU_NO_COLUMNAR=1`` disables routing entirely (the
    per-container engine remains the differential reference)."""

    enabled: bool = not os.environ.get("ROARINGBITMAP_TPU_NO_COLUMNAR")
    min_containers: int = 16
    max_containers: int = 4096
    min_fold_rows: int = 64
    chunk_rows: int = 4096


# container pairs (rows, for the folds) by "op/class"; the device tier's
# buckets count under "op/device_pair" and "op/device_gather"
BATCH_COUNTS: Dict[str, int] = {}
# cost-model verdicts of the routed facades by tier
ROUTE_COUNTS: Dict[str, int] = {"per-container": 0, "columnar-cpu": 0, "columnar-device": 0}


def reset_counts() -> None:
    BATCH_COUNTS.clear()
    for k in ROUTE_COUNTS:
        ROUTE_COUNTS[k] = 0


def _count(op: str, klass: str, n: int) -> None:
    key = f"{op}/{klass}"
    BATCH_COUNTS[key] = BATCH_COUNTS.get(key, 0) + int(n)


# per-thread disable depth: disabled() must not flip process-global state
# (two overlapping threads would strand routing off), so the router
# consults a thread-local counter; re-entrant by construction
_TLS = threading.local()


@contextmanager
def disabled():
    """Temporarily force the per-container engines on this thread
    (differential tests, benchmark twins); re-entrant."""
    _TLS.depth = getattr(_TLS, "depth", 0) + 1
    try:
        yield
    finally:
        _TLS.depth -= 1


def _routing_on() -> bool:
    return config.enabled and not getattr(_TLS, "depth", 0)


_SHAPE_RANK = {ArrayContainer: 0, BitmapContainer: 1, RunContainer: 2}


def _shape_hint(hlc) -> str:
    """Sampled type probe (<= 8 containers): the operand's class-mix
    bucket for the cost model — ``run`` > ``bitmap`` > ``array`` by which
    kinds the sample saw."""
    conts = hlc.containers
    n = len(conts)
    step = max(1, n // 8)
    rank = 0
    for i in range(0, n, step):
        c = conts[i]
        r = _SHAPE_RANK.get(type(c))
        if r is None:
            # a subclass: runs rank "run", anything else "bitmap"
            r = 2 if isinstance(c, RunContainer) else 1
        if r == 2:
            return "run"
        if r > rank:
            rank = r
    return _costmodel.SHAPES[rank]


# route() verdict -> pairwise tier argument
_TIER_ARG = {"columnar-cpu": "cpu", "columnar-device": "device"}


def outcome(tier):
    """The scope the facades run a routed verdict's engine in. The JAX
    package joins the measured outcome to the decision here; the port has
    no outcome ledger yet, so this is a null context."""
    return nullcontext()


def route(
    a_hlc, b_hlc, record: bool = True, allow_device: bool = True, op: str = "and"
) -> str:
    """Three-way engine verdict for one pairwise ``op``:
    ``per-container`` / ``columnar-cpu`` / ``columnar-device``, from the
    operands' container counts and the sampled class-mix shape
    (``costmodel.choose`` prices steady-state costs against the op-group
    coefficient table; uncalibrated it is the count window plus the
    shape hint, never the device). The JAX package also probes the
    operands' residency here, for its decision log only; the port has no
    decision log, so it does not. ``allow_device=False`` clamps the
    verdict to the CPU engines (the cardinality facades: their count-only
    kernels have no device tier). ``record`` counts the verdict in
    ``ROUTE_COUNTS``."""
    if not _routing_on():
        return "per-container"
    na, nb = a_hlc.size, b_hlc.size
    if (
        na < config.min_containers
        or nb < config.min_containers
        or na > config.max_containers
        or nb > config.max_containers
    ):
        # outside the measured window the per-container walk serves in
        # both model modes: a two-point calibration must not extrapolate
        # 100x past its data
        return "per-container"
    if allow_device and deadline_expired():
        # an expired query budget starts no device work, calibration's
        # device cells included
        allow_device = False
    model = _costmodel.MODEL if not allow_device else _costmodel.ensure_calibrated()
    shape = max(_shape_hint(a_hlc), _shape_hint(b_hlc), key=_costmodel.SHAPES.index)
    tier, _inputs = model.choose(na, nb, shape, False, None if allow_device else False, op=op)
    if record:
        ROUTE_COUNTS[tier] += 1
    return tier


def enabled_for(a_hlc, b_hlc) -> bool:
    """Does this pair leave the per-container walk? The cardinality
    facades' gate (and_cardinality / intersects): their batched kernels are
    CPU-only, so the verdict excludes the device tier."""
    return route(a_hlc, b_hlc, allow_device=False) != "per-container"


def enabled_for_fold(n_rows: int) -> bool:
    """Route an N-way fold through the columnar batch engine? The gate is
    the calibrated fold cutoff when there is one, the config default
    otherwise."""
    if not _routing_on():
        return False
    return n_rows >= _costmodel.MODEL.fold_gate_rows()


_FOLD_LABELS = {"or": "fold_or", "xor": "fold_xor", "and": "fold_and"}


def _inc_classes(op: str, hist: np.ndarray) -> None:
    for ci in np.flatnonzero(hist).tolist():
        _count(op, CLASS_NAMES[ci], hist[ci])


def _record(op: str, codes_a: np.ndarray, codes_b: np.ndarray) -> np.ndarray:
    """Count the batch by class; returns the 9-class histogram so callers
    skip the masks of empty classes."""
    hist = class_histogram(codes_a, codes_b)
    _inc_classes(op, hist)
    return hist


# ---------------------------------------------------------------------------
# matched-pair class execution
# ---------------------------------------------------------------------------


def _fill_aa(op: str, acs, bcs, idx: np.ndarray, results: List[Optional[Container]]) -> None:
    """array x array: the CSR batch kernel, then batched format selection
    (or/xor unions can overflow 4096 into a bitmap)."""
    if idx.size == 0:
        return
    avals, aoffs = gather_values(acs, idx)
    bvals, boffs = gather_values(bcs, idx)
    vals, starts, counts = kernels.batch_pairwise(avals, aoffs, bvals, boffs, op)
    starts_l, counts_l = starts.tolist(), counts.tolist()
    for j, i in enumerate(idx.tolist()):
        n = counts_l[j]
        if n == 0:
            continue
        chunk = vals[starts_l[j] : starts_l[j] + n]
        if n <= ARRAY_MAX_SIZE:
            # copy: the batch buffer is shared scratch; a view would pin it
            results[i] = _wrap_u16(chunk.copy())
        else:
            results[i] = BitmapContainer(bits.words_from_values(chunk), n)


def _gather_mask(probe_cs, dense_cs, idx: np.ndarray, dense_is_run: bool):
    """The array x dense classes' probe: one batched membership pass
    answers every probe value of every pair — a word-test gather against
    stacked bitmap rows, or the banded searchsorted against run payloads."""
    vals, offs = gather_values(probe_cs, idx)
    if dense_is_run:
        starts, lengths, roffs = gather_runs(dense_cs, idx)
        return vals, offs, kernels.run_member_mask(vals, offs, starts, lengths, roffs)
    rows_mat = stack_words(dense_cs, idx)
    row_ids = np.repeat(np.arange(idx.size, dtype=np.int64), np.diff(offs))
    return vals, offs, kernels.member_mask(rows_mat, row_ids, vals)


def _build_gather_results(
    op: str, vals: np.ndarray, offs: np.ndarray, mask: np.ndarray, idx: np.ndarray, results
) -> None:
    """Shared tail of the membership-gather classes (the CPU word test and
    the device tier's): keep the member (and) or non-member (andnot)
    probe values per pair; the results are arrays by construction."""
    if op == "andnot":
        mask = ~mask
    row_ids = np.repeat(np.arange(idx.size, dtype=np.int64), np.diff(offs))
    kept = vals[mask]
    counts = np.bincount(row_ids[mask], minlength=idx.size)
    starts = np.concatenate(([0], np.cumsum(counts)))
    starts_l, counts_l = starts.tolist(), counts.tolist()
    for j, i in enumerate(idx.tolist()):
        n = counts_l[j]
        if n:
            s = starts_l[j]
            results[i] = _wrap_u16(kept[s : s + n].copy())


def _fill_gather(op: str, probe_cs, dense_cs, idx: np.ndarray, results, dense_is_run: bool) -> None:
    """array x dense (and/andnot): membership gather."""
    if idx.size == 0:
        return
    vals, offs, mask = _gather_mask(probe_cs, dense_cs, idx, dense_is_run)
    _build_gather_results(op, vals, offs, mask, idx, results)


def _fill_runs_native(op: str, acs, bcs, idx: np.ndarray, results) -> None:
    """All bitmap-free classes (aa/ar/ra/rr) of and/andnot through ONE
    native call: payloads unify as CSR run lists (arrays are length-0
    runs), ``rb_batch_run_pairwise`` two-pointer-merges every pair in C
    emitting result intervals, and the whole batch's container formats are
    selected by the reference's size rule (run iff 2+4·nruns smallest, so
    run-shaped results stay compressed; small ones expand to arrays in one
    vectorized pass). The numpy tier builds arrays where this builds runs:
    the values agree, the bytes need not."""
    if idx.size == 0:
        return
    as_, al, acnt = gather_intervals(acs, idx)
    bs_, bl, bcnt = gather_intervals(bcs, idx)
    out_s, out_l, starts, counts, cards = kernels.batch_run_pairwise(as_, al, acnt, bs_, bl, bcnt, op)
    starts_l, counts_l, cards_l = starts.tolist(), counts.tolist(), cards.tolist()
    arr_js: List[int] = []  # pairs whose result becomes an array container
    for j, i in enumerate(idx.tolist()):
        card = cards_l[j]
        if card == 0:
            continue
        n = counts_l[j]
        run_size = 2 + 4 * n
        other = 8192 if card > ARRAY_MAX_SIZE else 2 + 2 * card
        if run_size <= other:
            s = starts_l[j]
            rc = RunContainer(out_s[s : s + n].copy(), out_l[s : s + n].copy())
            rc._card = card
            results[i] = rc
        elif card <= ARRAY_MAX_SIZE:
            arr_js.append(j)
        else:
            s = starts_l[j]
            s64 = out_s[s : s + n].astype(np.int64)
            e64 = s64 + out_l[s : s + n].astype(np.int64) + 1
            results[i] = BitmapContainer(bits.words_from_intervals(s64, e64), card)
    if arr_js:
        # one vectorized interval -> value expansion for every array result
        seg_s = np.concatenate([out_s[starts_l[j] : starts_l[j] + counts_l[j]] for j in arr_js]).astype(np.int64)
        seg_l = np.concatenate([out_l[starts_l[j] : starts_l[j] + counts_l[j]] for j in arr_js]).astype(np.int64)
        lens = seg_l + 1
        total = int(lens.sum())
        prefix = np.concatenate(([0], np.cumsum(lens)[:-1]))
        vals = (np.repeat(seg_s - prefix, lens) + np.arange(total, dtype=np.int64)).astype(np.uint16)
        pos = 0
        idx_l = idx.tolist()
        for j in arr_js:
            card = cards_l[j]
            results[idx_l[j]] = _wrap_u16(vals[pos : pos + card].copy())
            pos += card


def _fill_interval(op: str, acs, bcs, idx: np.ndarray, results) -> None:
    """run x run (plus andnot's run minus array): the banded interval
    algebra, one global sort for the whole bucket; each pair's result
    intervals pick their container by the reference's size rule, so
    run-shaped results stay runs."""
    if idx.size == 0:
        return
    as_, al, acnt = gather_intervals(acs, idx)
    bs_, bl, bcnt = gather_intervals(bcs, idx)
    out_s, out_e, starts, counts = kernels.interval_batch(as_, al, acnt, bs_, bl, bcnt, op)
    starts_l, counts_l = starts.tolist(), counts.tolist()
    for j, i in enumerate(idx.tolist()):
        n = counts_l[j]
        if n == 0:
            continue
        s = starts_l[j]
        results[i] = _container_of_intervals(out_s[s : s + n], out_e[s : s + n])


def _fill_interval_cards(op: str, acs, bcs, idx: np.ndarray, results) -> None:
    """or/xor over the bitmap-free classes (ar/ra/rr): the banded interval
    algebra computes the values without word expansion, and each result
    takes the word-matrix classes' card rule (an array up to 4096 values,
    a bitmap above), so its form is the one the word path builds."""
    if idx.size == 0:
        return
    as_, al, acnt = gather_intervals(acs, idx)
    bs_, bl, bcnt = gather_intervals(bcs, idx)
    out_s, out_e, _starts, counts = kernels.interval_batch(as_, al, acnt, bs_, bl, bcnt, op)
    pair = np.repeat(np.arange(idx.size, dtype=np.int64), counts)
    lens = out_e - out_s
    cards = np.bincount(pair, weights=lens, minlength=idx.size).astype(np.int64)
    small = (cards <= ARRAY_MAX_SIZE)[pair]
    n_small = lens[small]
    vals = np.repeat(out_s[small] - (np.cumsum(n_small) - n_small), n_small) + np.arange(int(n_small.sum()))
    offs = np.concatenate(([0], np.cumsum(np.where(cards <= ARRAY_MAX_SIZE, cards, 0)))).tolist()
    vals = vals.astype(np.uint16)
    idx_l, cards_l = idx.tolist(), cards.tolist()
    big = []
    for j, i in enumerate(idx_l):
        if cards_l[j] == 0:
            continue
        if cards_l[j] <= ARRAY_MAX_SIZE:
            # copy: the batch buffer is shared scratch; a view would pin it
            results[i] = _wrap_u16(vals[offs[j] : offs[j + 1]].copy())
        else:
            big.append(j)
    if big:
        big_a = np.asarray(big, dtype=np.int64)
        mat = np.zeros((big_a.size, bits.WORDS_PER_CONTAINER), dtype=np.uint64)
        sel = np.isin(pair, big_a)
        kernels.fill_intervals_rows(
            np.arange(big_a.size, dtype=np.int64), np.concatenate(([0], np.cumsum(counts[big_a]))),
            out_s[sel], out_e[sel], mat,
        )
        for n, j in enumerate(big):
            results[idx_l[j]] = BitmapContainer(mat[n].copy(), cards_l[j])


# rows per batched value extraction: bounds its scratch (a few int64
# arrays over the nonzero bytes, at most 4096 a row) near 64 MiB
_VALUES_BLOCK = 256


def _format_rows_results(words64: np.ndarray, cards, idx, results) -> None:
    """The card-driven array-vs-bitmap result-format rule, shared by the
    CPU word-matrix classes, the folds and the device tier (whose
    popcounts arrive with the words): one copy of the threshold, so the
    tiers' container formats cannot drift. The array results' values come
    out of the words one row a call on the native tier (the extension's
    ``values_from_words``, as the JAX package does), in batches on the
    numpy tier (``kernels.values_rows``)."""
    cards = np.asarray(cards, dtype=np.int64)
    idx = np.asarray(idx).tolist()
    small = np.flatnonzero((cards > 0) & (cards <= ARRAY_MAX_SIZE))
    if small.size and kernels.has_native():
        unpack = bits.values_from_words
        for j in small.tolist():
            results[idx[j]] = _wrap_u16(unpack(words64[j]))
    else:
        for lo in range(0, small.size, _VALUES_BLOCK):
            block = small[lo : lo + _VALUES_BLOCK]
            vals, offs = kernels.values_rows(words64[block])
            offs_l = offs.tolist()
            for n, j in enumerate(block.tolist()):
                # copy: the batch buffer is shared scratch; a view would pin it
                results[idx[j]] = _wrap_u16(vals[offs_l[n] : offs_l[n + 1]].copy())
    for j in np.flatnonzero(cards > ARRAY_MAX_SIZE).tolist():
        results[idx[j]] = BitmapContainer(words64[j].copy(), int(cards[j]))


def _fill_dense(op: str, acs, bcs, idx: np.ndarray, results) -> None:
    """Word-matrix classes, chunked to bound peak memory: and/andnot
    expand both sides and apply one ``&`` / ``& ~``; or/xor expand the
    left and combine the right through the batched scatter/fill machinery.
    One popcount pass selects every result's format."""
    if idx.size == 0:
        return
    step = max(1, config.chunk_rows)
    for lo in range(0, idx.size, step):
        chunk = idx[lo : lo + step]
        chunk_l = chunk.tolist()
        mat = expand_rows(acs, chunk)
        if op in ("or", "xor"):
            rows = np.arange(chunk.size, dtype=np.int64)
            scatter_containers(mat, rows, [bcs[i] for i in chunk_l], op=op)
        elif op == "and":
            mat &= expand_rows(bcs, chunk)
        else:  # andnot
            mat &= ~expand_rows(bcs, chunk)
        _format_rows_results(mat, kernels.popcount_rows(mat), chunk_l, results)


def _fill_clear(acs, bcs, idx: np.ndarray, results) -> None:
    """andnot with a dense left and an array right: expand the left,
    scatter-clear the right's values out of it in one batched pass."""
    if idx.size == 0:
        return
    step = max(1, config.chunk_rows)
    for lo in range(0, idx.size, step):
        chunk = idx[lo : lo + step]
        mat = expand_rows(acs, chunk)
        bvals, boffs = gather_values(bcs, chunk)
        kernels.scatter_values_rows(np.arange(chunk.size, dtype=np.int64), boffs, bvals, mat, op="clear")
        _format_rows_results(mat, kernels.popcount_rows(mat), chunk, results)


def _fill_nonbm(
    op: str,
    acs: Sequence[Container],
    bcs: Sequence[Container],
    codes_a: np.ndarray,
    codes_b: np.ndarray,
    hist: np.ndarray,
    results: List[Optional[Container]],
) -> None:
    """All bitmap-free classes of and/andnot (aa/ar/ra/rr), shared by the
    CPU and device tiers (the device tier keeps them on the host: their
    payloads are value-sized and the interval algebra keeps run-shaped
    results compressed). A pure array x array bucket rides the CSR values
    kernel alone; with a run among them, the native tier serves every
    class in one run-unified call."""
    n_aa = int(hist[0])
    n_runish = int(hist[2] + hist[6] + hist[8])  # ar + ra + rr
    if not n_aa and not n_runish:
        return
    a_arr = codes_a == ARRAY
    b_arr = codes_b == ARRAY
    if not n_runish:
        _fill_aa(op, acs, bcs, np.flatnonzero(a_arr & b_arr), results)
        return
    a_bm = codes_a == BITMAP
    b_bm = codes_b == BITMAP
    if kernels.has_native():
        _fill_runs_native(op, acs, bcs, np.flatnonzero(~a_bm & ~b_bm), results)
        return
    _fill_aa(op, acs, bcs, np.flatnonzero(a_arr & b_arr), results)
    a_run = ~a_arr & ~a_bm
    b_run = ~b_arr & ~b_bm
    # banded run probes for the array x run directions
    _fill_gather(op, acs, bcs, np.flatnonzero(a_arr & b_run), results, True)
    if op == "and":
        _fill_gather(op, bcs, acs, np.flatnonzero(b_arr & a_run), results, True)
        iv = np.flatnonzero(a_run & b_run)  # rr
    else:
        iv = np.flatnonzero(a_run & ~b_bm)  # rr + ra
    _fill_interval(op, acs, bcs, iv, results)


def _matched_results(op: str, acs: Sequence[Container], bcs: Sequence[Container]) -> List[Optional[Container]]:
    n = len(acs)
    results: List[Optional[Container]] = [None] * n
    if n == 0:
        return results
    codes_a = classify(acs)
    codes_b = classify(bcs)
    hist = _record(op, codes_a, codes_b)
    a_arr = codes_a == ARRAY
    b_arr = codes_b == ARRAY
    if op in ("and", "andnot"):
        a_bm = codes_a == BITMAP
        b_bm = codes_b == BITMAP
        _fill_nonbm(op, acs, bcs, codes_a, codes_b, hist, results)
        if hist[1]:  # ab: array probe vs stacked bitmap words
            _fill_gather(op, acs, bcs, np.flatnonzero(a_arr & b_bm), results, False)
        if hist[3]:  # ba
            if op == "and":
                _fill_gather(op, bcs, acs, np.flatnonzero(b_arr & a_bm), results, False)
            else:  # ba under andnot: expand a, scatter-clear b's values
                _fill_clear(acs, bcs, np.flatnonzero(a_bm & b_arr), results)
        if hist[4] or hist[5] or hist[7]:
            # bb / br / rb: at least one bitmap, no array side -> word matrices
            _fill_dense(op, acs, bcs, np.flatnonzero((a_bm & ~b_arr) | (~a_arr & b_bm)), results)
    else:  # or / xor: aa on the CSR kernel, ar/ra/rr on the interval
        # algebra, every class with a bitmap on word matrices
        if hist[0]:
            _fill_aa(op, acs, bcs, np.flatnonzero(a_arr & b_arr), results)
        a_bm = codes_a == BITMAP
        b_bm = codes_b == BITMAP
        if hist[2] or hist[6] or hist[8]:
            _fill_interval_cards(op, acs, bcs, np.flatnonzero(~a_bm & ~b_bm & ~(a_arr & b_arr)), results)
        if hist[1] or hist[3] or hist[4] or hist[5] or hist[7]:
            _fill_dense(op, acs, bcs, np.flatnonzero(a_bm | b_bm), results)
    return results


# ---------------------------------------------------------------------------
# public pairwise entry points
# ---------------------------------------------------------------------------


def pairwise(
    op: str,
    x1: RoaringBitmap,
    x2: RoaringBitmap,
    reuse_left: bool = False,
    tier: Optional[str] = None,
) -> RoaringBitmap:
    """Whole-pair ``x1 OP x2`` through the batched engine. ``reuse_left``
    transfers x1's pass-through containers unclone'd — only for the
    in-place facades (ior/ixor/iandnot), which discard x1's old index.

    ``tier``: ``"cpu"`` (the host batch engine), ``"device"`` (the tier on
    ``aggregation.config.device`` fed by the resident rows, see
    ``columnar/device.py``), a ``route()`` verdict
    (``"columnar-cpu"``/``"columnar-device"``), or None — consult the cost
    model without counting the verdict, a direct call defaulting to the
    CPU tier. A failure of the device tier raises."""
    if tier is None:
        tier = route(x1.high_low_container, x2.high_low_container, record=False, op=op)
    tier = _TIER_ARG.get(tier, tier)
    a, b = x1.high_low_container, x2.high_low_container
    plan = key_plan(a.keys, b.keys, op)
    acs = [a.containers[i] for i in plan.ia.tolist()]
    bcs = [b.containers[i] for i in plan.ib.tolist()]
    if tier == "device":
        from . import device as _device_tier

        results = _device_tier.matched_results_device(
            op, acs, bcs,
            lambda: (_device_tier.rows_for(x1), plan.ia), lambda: (_device_tier.rows_for(x2), plan.ib),
        )
    else:
        results = _matched_results(op, acs, bcs)
    return _assemble_pairwise(op, a, b, plan, results, reuse_left)


def _assemble_pairwise(op: str, a, b, plan, results, reuse_left: bool) -> RoaringBitmap:
    """Result assembly for one pair: matched results (any tier's)
    merge-sorted with the pass-through containers by the key plan. One
    copy serves the solo tiers and the multi-pair batch, so their
    container layouts cannot drift."""
    acont, bcont = a.containers, b.containers
    out = RoaringBitmap()
    okeys, ocont = out.high_low_container.keys, out.high_low_container.containers
    if op == "and":
        for k, c in zip(plan.matched_keys.tolist(), results):
            if c is not None:
                okeys.append(k)
                ocont.append(c)
        return out
    a_only_l = plan.a_only.tolist()
    b_only_l = plan.b_only.tolist()
    keys_all = np.concatenate([plan.matched_keys, plan.akeys[plan.a_only], plan.bkeys[plan.b_only]])
    keys_l = keys_all.tolist()
    n_m = len(results)
    n_a = len(a_only_l)
    for idx in np.argsort(keys_all, kind="stable").tolist():
        if idx < n_m:
            c = results[idx]
            if c is None:
                continue
        elif idx < n_m + n_a:
            ca = acont[a_only_l[idx - n_m]]
            c = ca if reuse_left else ca.clone()
        else:
            c = bcont[b_only_l[idx - n_m - n_a]].clone()
        okeys.append(keys_l[idx])
        ocont.append(c)
    return out


def pairwise_multi(op: str, pairs: Sequence[tuple], tier: str = "cpu") -> List[RoaringBitmap]:
    """Many independent ``a OP b`` pairs through ONE per-class batch pass.
    The per-pair key plans stay on the host; every pair's matched
    containers concatenate into one flat batch, so each occupied class
    pays one kernel call for the whole window — on the device tier the
    dense bucket is one ``rb_pair_rows`` launch over the concatenated
    resident row blocks (``device.matched_results_device_multi``).
    Results equal per-pair execution by construction: the class kernels
    work per matched pair and the assembly is the shared
    :func:`_assemble_pairwise`."""
    acs_all: List[Container] = []
    bcs_all: List[Container] = []
    spans: List[tuple] = []
    jobs = []
    for x1, x2 in pairs:
        a, b = x1.high_low_container, x2.high_low_container
        plan = key_plan(a.keys, b.keys, op)
        spans.append((len(acs_all), plan.ia.size))
        acs_all.extend(a.containers[i] for i in plan.ia.tolist())
        bcs_all.extend(b.containers[i] for i in plan.ib.tolist())
        jobs.append((x1, x2, plan))
    if tier == "device":
        from . import device as _device_tier

        results_all = _device_tier.matched_results_device_multi(op, jobs, acs_all, bcs_all)
    else:
        results_all = _matched_results(op, acs_all, bcs_all)
    return [
        _assemble_pairwise(
            op, x1.high_low_container, x2.high_low_container, plan,
            results_all[start : start + count], False,
        )
        for (x1, x2, plan), (start, count) in zip(jobs, spans)
    ]


def _matched_lists(x1: RoaringBitmap, x2: RoaringBitmap):
    a, b = x1.high_low_container, x2.high_low_container
    plan = key_plan(a.keys, b.keys, "and")
    return [a.containers[i] for i in plan.ia.tolist()], [b.containers[i] for i in plan.ib.tolist()]


def and_cardinality_pair(x1: RoaringBitmap, x2: RoaringBitmap) -> int:
    """``|x1 & x2|`` with no materialization: the aa class runs the
    count-only batch kernel, gathers count their masks, dense pairs stop
    at the batched popcount."""
    return sum(_cardinality_batches(*_matched_lists(x1, x2)))


def intersects_pair(x1: RoaringBitmap, x2: RoaringBitmap) -> bool:
    """Batched intersects: the and-cardinality buckets, short-circuiting
    between class batches."""
    return any(count for count in _cardinality_batches(*_matched_lists(x1, x2)))


def _cardinality_batches(acs, bcs):
    """Yield per-class-bucket AND cardinalities (their sum is the
    and-cardinality)."""
    if not acs:
        return
    codes_a = classify(acs)
    codes_b = classify(bcs)
    _record("and_card", codes_a, codes_b)
    a_arr = codes_a == ARRAY
    b_arr = codes_b == ARRAY
    a_bm = codes_a == BITMAP
    b_bm = codes_b == BITMAP
    nonbm = np.flatnonzero(~a_bm & ~b_bm)
    if nonbm.size and kernels.has_native():
        # every bitmap-free class in one count-only run-unified call
        as_, al, acnt = gather_intervals(acs, nonbm)
        bs_, bl, bcnt = gather_intervals(bcs, nonbm)
        yield int(kernels.batch_run_pairwise(as_, al, acnt, bs_, bl, bcnt, "and", cards_only=True).sum())
    elif nonbm.size:
        a_run = ~a_arr & ~a_bm
        b_run = ~b_arr & ~b_bm
        aa = np.flatnonzero(a_arr & b_arr)
        if aa.size:
            avals, aoffs = gather_values(acs, aa)
            bvals, boffs = gather_values(bcs, aa)
            yield int(kernels.batch_and_cardinality(avals, aoffs, bvals, boffs).sum())
        iv = np.flatnonzero(a_run & b_run)  # rr
        if iv.size:
            as_, al, acnt = gather_intervals(acs, iv)
            bs_, bl, bcnt = gather_intervals(bcs, iv)
            yield int(kernels.interval_batch(as_, al, acnt, bs_, bl, bcnt, "and", cards_only=True).sum())
        for idx, probe_cs, dense_cs in (
            (np.flatnonzero(a_arr & b_run), acs, bcs),
            (np.flatnonzero(b_arr & a_run), bcs, acs),
        ):
            if idx.size:
                _v, _o, mask = _gather_mask(probe_cs, dense_cs, idx, True)
                yield int(mask.sum())
    for idx, probe_cs, dense_cs in (
        (np.flatnonzero(a_arr & b_bm), acs, bcs),
        (np.flatnonzero(b_arr & a_bm), bcs, acs),
    ):
        if idx.size:
            _v, _o, mask = _gather_mask(probe_cs, dense_cs, idx, False)
            yield int(mask.sum())
    ww = np.flatnonzero((a_bm & ~b_arr) | (~a_arr & b_bm))
    if ww.size:
        step = max(1, config.chunk_rows)
        total = 0
        for lo in range(0, ww.size, step):
            chunk = ww[lo : lo + step]
            mat = expand_rows(acs, chunk)
            mat &= expand_rows(bcs, chunk)
            total += int(kernels.popcount_rows(mat).sum())
        yield total


# ---------------------------------------------------------------------------
# N-way CPU folds
# ---------------------------------------------------------------------------


def _fold_matrix(multi_cs: List[List[Container]], op: str) -> np.ndarray:
    """One word row per multi-container group, or/xor-folded with a single
    batched scatter over every group's containers."""
    mat = np.zeros((len(multi_cs), bits.WORDS_PER_CONTAINER), dtype=np.uint64)
    row_ids = np.repeat(
        np.arange(len(multi_cs), dtype=np.int64),
        np.fromiter((len(cs) for cs in multi_cs), np.int64, len(multi_cs)),
    )
    scatter_containers(mat, row_ids, [c for cs in multi_cs for c in cs], op=op)
    return mat


def _rows_containers(mat: np.ndarray) -> List[Optional[Container]]:
    """One container per word row (None for an empty row), formats by the
    shared card rule."""
    out: List[Optional[Container]] = [None] * mat.shape[0]
    _format_rows_results(mat, kernels.popcount_rows(mat), range(mat.shape[0]), out)
    return out


def _and_fold_matrix(multi_cs: List[List[Container]]) -> np.ndarray:
    """AND of each group's containers: expand and ``reduceat``, chunked by
    the row budget."""
    mats: List[np.ndarray] = []
    step = max(1, config.chunk_rows)
    gi = 0
    while gi < len(multi_cs):
        ge, rows = gi, 0
        while ge < len(multi_cs) and (rows == 0 or rows + len(multi_cs[ge]) <= step):
            rows += len(multi_cs[ge])
            ge += 1
        chunk_cs = [c for cs in multi_cs[gi:ge] for c in cs]
        rows_mat = expand_rows(chunk_cs, np.arange(len(chunk_cs), dtype=np.int64))
        starts = np.concatenate(([0], np.cumsum([len(cs) for cs in multi_cs[gi:ge]])))[:-1]
        mats.append(np.bitwise_and.reduceat(rows_mat, starts, axis=0))
        gi = ge
    return np.concatenate(mats, axis=0)


def fold(groups: Dict[int, List[Container]], op: str) -> RoaringBitmap:
    """Key-grouped N-way fold without per-container dispatch: all array
    payloads scatter in one batched call, all runs expand through one
    batched interval fill, bitmap rows reduce with one ``reduceat``, then
    one batched popcount selects every result format. Single-container
    groups pass through as type-preserving clones (the per-container
    engine's behavior)."""
    keys = sorted(groups)
    singles = {k: groups[k][0] for k in keys if len(groups[k]) == 1}
    multi_keys = [k for k in keys if k not in singles]
    multi_cs = [groups[k] for k in multi_keys]
    results: Dict[int, Optional[Container]] = {}
    if multi_keys:
        _count(_FOLD_LABELS[op], "rows", sum(len(cs) for cs in multi_cs))
        mat = _fold_matrix(multi_cs, op) if op in ("or", "xor") else _and_fold_matrix(multi_cs)
        results = dict(zip(multi_keys, _rows_containers(mat)))
    out = RoaringBitmap()
    hlc = out.high_low_container
    for k in keys:
        c = singles[k].clone() if k in singles else results[k]
        if c is not None and c.cardinality:
            hlc.append(k, c)
    return out


def fold_multi(groups_list: Sequence[Dict[int, List[Container]]], op: str) -> List[RoaringBitmap]:
    """N-way or/xor folds of several independent working sets through ONE
    multi-band pass: every set's multi-container key groups stack into a
    single matrix, one scatter fills them all, one popcount pass selects
    every result format. Value-identical to ``[fold(g, op) for g in
    groups_list]`` by construction."""
    if op not in ("or", "xor"):
        raise ValueError(f"fold_multi merges or/xor folds, got {op!r}")
    multi_keys: List[tuple] = []  # (set index, key)
    multi_cs: List[List[Container]] = []
    per_set_keys: List[List[int]] = []
    for si, groups in enumerate(groups_list):
        keys = sorted(groups)
        per_set_keys.append(keys)
        for k in keys:
            if len(groups[k]) > 1:
                multi_keys.append((si, k))
                multi_cs.append(groups[k])
    results: Dict[tuple, Optional[Container]] = {}
    if multi_keys:
        _count(_FOLD_LABELS[op], "rows", sum(len(cs) for cs in multi_cs))
        results = dict(zip(multi_keys, _rows_containers(_fold_matrix(multi_cs, op))))
    outs: List[RoaringBitmap] = []
    for si, keys in enumerate(per_set_keys):
        out = RoaringBitmap()
        hlc = out.high_low_container
        groups = groups_list[si]
        for k in keys:
            c = groups[k][0].clone() if len(groups[k]) == 1 else results[(si, k)]
            if c is not None and c.cardinality:
                hlc.append(k, c)
        outs.append(out)
    return outs


def or_fold_words(groups: Dict[int, List[Container]]) -> Dict[int, np.ndarray]:
    """Per-key OR of each group's containers as word rows — the batched
    core the query kernels' CPU path (the n-way ANDNOT's subtrahend union)
    shares with ``fold``. The rows are views into one matrix; callers
    consume them at once."""
    keys = sorted(groups)
    if not keys:
        return {}
    multi_cs = [groups[k] for k in keys]
    _count("fold_or", "rows", sum(len(cs) for cs in multi_cs))
    mat = _fold_matrix(multi_cs, "or")
    return {k: mat[g] for g, k in enumerate(keys)}
