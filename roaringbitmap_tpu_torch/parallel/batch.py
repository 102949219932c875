"""Batched one-vs-many pairwise algebra on the device, and the all-pairs
overlap matrices.

Counterpart of ``roaringbitmap_tpu/parallel/batch.py``. The retrieval /
filtered-ANN pattern (BASELINE.md config 5): one filter bitmap against
MANY small sets at once. All right-hand operands are packed into a
``[Q, K, 2048]`` tensor over the union of their chunk keys and the whole
batch runs as one ``rb_pair_rows`` launch (and or andnot, a popcount per
(query, key); ``ops/kernels.pair_rows_cardinality`` when only the counts
are wanted). The many-vs-many matrices pack both sides over their shared
keys and run one ``rb_pairwise_and_card`` launch
(``ops/kernels.pairwise_and_card``); or / xor / andnot follow from the AND
matrix by exact int64 inclusion-exclusion.

Each side is packed on the device: its containers ship as one compact
payload (``store.ship_rows``, expanded by ``rb_expand_rows``) and are
scattered into a zeroed ``[slots, 2048]`` block with ``index_copy_``, where
the JAX package fills a host array and copies it. Every entry point takes
``device=`` (default ``"cuda"``, resolved by ``device.resolve_device``; a
missing card raises). On CPU tensors the kernels' plain versions run.

Both ``impl`` labels of the matrices reach the same kernel here:
``rb_pairwise_and_card`` is exact in int64, and ``"mxu"`` keeps the JAX
package's 2^31 guard so the two packages accept and refuse the same
inputs. As in the JAX package, the one-vs-many step runs under the
``tracing.op_timer`` span ``batch.one_vs_many.<op>`` and the all-pairs
matrix under ``batch.pairwise.<impl>``, and ``PAIRWISE_COUNTS`` is a
mapping view of ``rb_tpu_batch_pairwise_total{impl}``
(``insights.dispatch_counters()["pairwise"]`` reads it).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .. import observe as _observe
from .. import tracing
from ..device import resolve_device
from ..models.roaring import RoaringBitmap
from ..ops import device as dev
from ..ops import kernels
from . import store

# which engine served each pairwise-matrix call ("mxu" | "vpu"), as the
# JAX package's dispatch counter reads
_PAIRWISE_TOTAL = _observe.counter(
    _observe.BATCH_PAIRWISE_TOTAL,
    "Pairwise-matrix dispatches by engine (mxu | vpu)",
    ("impl",),
)
PAIRWISE_COUNTS = _observe.CounterMap(_PAIRWISE_TOTAL, scalar=True)
for _impl in ("mxu", "vpu"):
    PAIRWISE_COUNTS[_impl] = 0


def _pack_one_vs_many(one: RoaringBitmap, many: Sequence[RoaringBitmap], device):
    """(filter words [K, 2048], batch words [Q, K, 2048], keys) over the
    union of the right-hand operands' chunk keys, on ``device``."""
    keys = sorted({k for c in many for k in c.high_low_container.keys})
    kidx = {k: i for i, k in enumerate(keys)}
    filt = torch.zeros((max(1, len(keys)), dev.DEVICE_WORDS), dtype=torch.int32, device=device)
    hlc = one.high_low_container
    fk = {k: c for k, c in zip(hlc.keys, hlc.containers)}
    present = [k for k in keys if k in fk]
    if present:
        slots = torch.tensor([kidx[k] for k in present], dtype=torch.int64, device=device)
        filt.index_copy_(0, slots, store.ship_rows([fk[k] for k in present], device))
    batch = _pack_sets(many, keys, kidx, device)
    return filt, batch, np.asarray(keys, dtype=np.int64)


_MASK_OPS = ("and", "andnot")  # batch & filter, batch & ~filter


def _mask_streams(q: int, k: int, device):
    """``rb_pair_rows``' index streams for a ``[q, k]`` batch: batch row
    ``qi * k + ki`` against filter row ``ki`` (int32, so q * k < 2^31)."""
    if q * k >= 1 << 31:
        raise ValueError(f"a [{q}, {k}] batch has too many rows for int32 indices")
    ia = torch.arange(q * k, dtype=torch.int32, device=device)
    ib = torch.arange(k, dtype=torch.int32, device=device).repeat(q)
    return ia, ib


def _step(op: str, cards_only: bool):
    """The masked popcount over a packed batch: ``run(batch, filt)`` gives
    the int32 ``[Q, K]`` counts (``cards_only``, no masked rows written),
    else the masked ``[Q, K, 2048]`` rows and the counts. Per-(query, key)
    counts are <= 2^16; the per-query sum runs in int64 on the host."""
    if op not in _MASK_OPS:
        raise ValueError(f"op must be 'and' or 'andnot', got {op!r}")
    streams = {}  # the last shape's index streams: a prepared run reuses them

    def run(batch: torch.Tensor, filt: torch.Tensor):
        q, k, w = batch.shape
        key = (q, k, batch.device)
        if key not in streams:
            streams.clear()
            streams[key] = _mask_streams(q, k, batch.device)
        ia, ib = streams[key]
        flat = batch.view(q * k, w)
        if cards_only:
            return kernels.pair_rows_cardinality(flat, ia, filt, ib, op).view(q, k)
        masked, cards = kernels.pair_rows_reduce(flat, ia, filt, ib, op)
        return masked.view(q, k, w), cards.view(q, k)

    return run


def prepare_batched_cardinality(
    one: RoaringBitmap, many: Sequence[RoaringBitmap], op: str = "and", device=None
):
    """Pack once, query repeatedly: returns a closure computing
    ``[|many[i] OP one|]`` from the resident device tensors (the
    steady-state retrieval loop).

    The closure exposes its resident tensors and step as
    ``run.device_tensors == (batch, filt)`` and ``run.step``."""
    filt, batch, _ = _pack_one_vs_many(one, many, resolve_device(device))
    step = _step(op, cards_only=True)

    def run() -> np.ndarray:
        with tracing.op_timer(f"batch.one_vs_many.{op}"):
            row_cards = step(batch, filt).cpu().numpy().astype(np.int64)
            return row_cards.sum(axis=1)

    run.device_tensors = (batch, filt)
    run.step = step
    return run


def batched_cardinality(
    one: RoaringBitmap, many: Sequence[RoaringBitmap], op: str = "and", device=None
) -> np.ndarray:
    """``[|many[i] OP one|]`` for every i, one launch; op in {'and',
    'andnot'} (andnot = many[i] minus one)."""
    if not many:
        return np.empty(0, dtype=np.int64)
    return prepare_batched_cardinality(one, many, op, device)()


def batched_intersects(
    one: RoaringBitmap, many: Sequence[RoaringBitmap], device=None
) -> np.ndarray:
    """Boolean mask: does many[i] intersect the filter?"""
    return batched_cardinality(one, many, op="and", device=device) > 0


def batched_op(
    one: RoaringBitmap, many: Sequence[RoaringBitmap], op: str = "and", device=None
) -> List[RoaringBitmap]:
    """Materialized ``many[i] OP one`` for every i (results re-compressed
    through the append path)."""
    if not many:
        return []
    filt, batch, keys = _pack_one_vs_many(one, many, resolve_device(device))
    masked, row_cards = _step(op, cards_only=False)(batch, filt)
    masked_np = masked.cpu().numpy().view(np.uint32)
    row_cards_np = row_cards.cpu().numpy().astype(np.int64)
    return [
        store.unpack_to_bitmap(keys, masked_np[qi], row_cards_np[qi])
        for qi in range(len(many))
    ]


# ---------------------------------------------------------------------------
# many-vs-many: pairwise intersection matrices (similarity analytics)
# ---------------------------------------------------------------------------


def _pack_sets(sets: Sequence[RoaringBitmap], keys, kidx, device) -> torch.Tensor:
    """int32 ``[len(sets), max(1, len(keys)), 2048]`` on ``device``: set
    ``si``'s container of key ``keys[slot]`` in row ``si * n_keys + slot``,
    zeros where it has none; containers outside ``keys`` are dropped."""
    n_keys = max(1, len(keys))
    containers: List = []
    slots: List[int] = []
    for si, bm in enumerate(sets):
        hlc = bm.high_low_container
        for k, cont in zip(hlc.keys, hlc.containers):
            slot = kidx.get(k)
            if slot is None:  # outside the shared key set: cannot intersect
                continue
            containers.append(cont)
            slots.append(si * n_keys + slot)
    out = torch.zeros((len(sets) * n_keys, dev.DEVICE_WORDS), dtype=torch.int32, device=device)
    if containers:
        idx = torch.tensor(slots, dtype=torch.int64, device=device)
        out.index_copy_(0, idx, store.ship_rows(containers, device))
    return out.view(len(sets), n_keys, dev.DEVICE_WORDS)


def _shared_keys(lefts, rights) -> list:
    return sorted(
        {k for c in lefts for k in c.high_low_container.keys}
        & {k for c in rights for k in c.high_low_container.keys}
    )


def _exact(lefts, rights) -> bool:
    """The JAX package's bit-matmul exactness bound (int32 accumulation):
    every cardinality below 2^31."""
    return all(b.get_cardinality() < (1 << 31) for b in (*lefts, *rights))


def pairwise_and_cardinality(
    lefts: Sequence[RoaringBitmap],
    rights: Sequence[RoaringBitmap],
    tile_bytes: int = kernels.PAIRWISE_TILE_BYTES,
    impl: str = "auto",
    device=None,
) -> np.ndarray:
    """``out[i, j] = |lefts[i] AND rights[j]|`` as one device computation —
    the all-pairs overlap matrix behind similarity joins and Jaccard
    analytics, which the reference can only assemble with n*m pairwise
    andCardinality calls.

    ``impl``: 'vpu', 'mxu' or 'auto', as in the JAX package: 'auto' picks
    'mxu' on the card when every cardinality is below 2^31, else 'vpu';
    'mxu' refuses larger sets. Both run ``rb_pairwise_and_card`` on the
    card (exact in int64 either way) and the plain version on CPU tensors,
    whose left axis is tiled so the ``[nb, m, K, 2048]`` intermediate stays
    under ``tile_bytes``."""
    if impl not in ("auto", "vpu", "mxu"):
        raise ValueError(f"impl must be 'auto', 'vpu', or 'mxu', got {impl!r}")
    n, m = len(lefts), len(rights)
    if n == 0 or m == 0:
        return np.zeros((n, m), dtype=np.int64)
    d = resolve_device(device)
    keys = _shared_keys(lefts, rights)
    if not keys:  # no shared chunk: every intersection is empty
        return np.zeros((n, m), dtype=np.int64)
    if impl == "auto":
        impl = "mxu" if (d.type == "cuda" and _exact(lefts, rights)) else "vpu"
    elif impl == "mxu" and not _exact(lefts, rights):
        raise ValueError(
            "impl='mxu' needs every cardinality < 2^31 (int32 accumulation "
            "exactness); use impl='vpu' or 'auto' for larger sets"
        )
    kidx = {k: i for i, k in enumerate(keys)}
    lw = _pack_sets(lefts, keys, kidx, d)
    rw = _pack_sets(rights, keys, kidx, d)
    _PAIRWISE_TOTAL.inc(1, (impl,))
    with tracing.op_timer(f"batch.pairwise.{impl}"):
        return kernels.pairwise_and_card(lw, rw, tile_bytes).cpu().numpy()


def _inclusion_exclusion(op: str, inter: np.ndarray, lefts, rights) -> np.ndarray:
    """Derive an or/xor/andnot cardinality matrix from the AND matrix and
    the per-set cardinalities — exact in int64 (|A|+|B|-|A&B|,
    |A|+|B|-2|A&B|, |A|-|A&B|)."""
    lc = np.array([b.get_cardinality() for b in lefts], dtype=np.int64)
    if op == "andnot":
        return lc[:, None] - inter
    rc = np.array([b.get_cardinality() for b in rights], dtype=np.int64)
    return lc[:, None] + rc[None, :] - (2 if op == "xor" else 1) * inter


def prepare_pairwise_mxu(
    lefts: Sequence[RoaringBitmap], rights: Sequence[RoaringBitmap], device=None
):
    """Pack once for repeated overlap-matrix launches: returns a closure
    computing the [n, m] intersection-cardinality matrix from resident
    device tensors, exposing ``run.device_tensors == (lw, rw)`` and
    ``run.step`` (``(lw, rw) -> int64 [n, m]`` tensor) for steady-state
    timing. Refuses sets as ``impl='mxu'`` does."""
    d = resolve_device(device)
    keys = _shared_keys(lefts, rights)
    if not keys:
        n, m = len(lefts), len(rights)

        def run_empty() -> np.ndarray:
            return np.zeros((n, m), dtype=np.int64)

        run_empty.device_tensors = None
        run_empty.step = None
        return run_empty
    if not _exact(lefts, rights):
        raise ValueError("MXU path needs every cardinality < 2^31")
    kidx = {k: i for i, k in enumerate(keys)}
    lw = _pack_sets(lefts, keys, kidx, d)
    rw = _pack_sets(rights, keys, kidx, d)
    step = kernels.pairwise_and_card

    def run() -> np.ndarray:
        return step(lw, rw).cpu().numpy()

    run.device_tensors = (lw, rw)
    run.step = step
    return run


def pairwise_jaccard(
    lefts: Sequence[RoaringBitmap], rights: Sequence[RoaringBitmap], device=None
) -> np.ndarray:
    """``out[i, j] = |L_i & R_j| / |L_i | R_j|`` (0 for two empty sets):
    the similarity matrix via one intersection-matrix launch plus
    inclusion-exclusion from the per-set cardinalities."""
    inter = pairwise_and_cardinality(lefts, rights, device=device)
    union = _inclusion_exclusion("or", inter, lefts, rights).astype(np.float64)
    with np.errstate(invalid="ignore"):
        sim = np.where(union > 0, inter / np.maximum(union, 1e-300), 0.0)
    return sim


def pairwise_cardinality(
    lefts: Sequence[RoaringBitmap],
    rights: Sequence[RoaringBitmap],
    op: str = "and",
    impl: str = "auto",
    device=None,
) -> np.ndarray:
    """All-pairs cardinality matrix for any of the four ops — the batched
    twin of the reference's scalar ``andCardinality/orCardinality/...``
    statics. One launch computes the AND matrix; OR/XOR/ANDNOT follow by
    exact int64 inclusion-exclusion."""
    if op not in ("and", "or", "xor", "andnot"):
        raise ValueError(f"op must be one of and/or/xor/andnot, got {op!r}")
    inter = pairwise_and_cardinality(lefts, rights, impl=impl, device=device)
    if op == "and":
        return inter
    return _inclusion_exclusion(op, inter, lefts, rights)
