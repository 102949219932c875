"""Kernel wrappers of the aggregation path, their plain versions, and the
device-side row expansion.

Counterpart of ``roaringbitmap_tpu/ops/pallas_kernels.py`` for this slice.
Two hand-written CUDA kernels (``csrc/reduce.cu``, built by ``_build``):

* ``rb_group_reduce`` — :func:`group_reduce`. Replaces
  ``pallas_kernels.py:grouped_reduce_pallas`` (padded layout, bucketed
  layout, and with a row map the cold ``fused_gather_reduce``) and
  ``pallas_kernels.py:segmented_reduce_pallas`` (skewed layout, as a
  segmented reduce over group offsets). Bound: device-memory bandwidth,
  live rows * 8192 B / 3.35 TB/s; the source note in ``reduce.cu`` says
  how the chunked, atomically combined design meets it.
* ``rb_popcount_rows`` — :func:`popcount_rows`. Replaces the XLA popcount
  epilogue ``roaringbitmap_tpu/ops/device.py:popcount_rows`` (torch has no
  popcount). Bound: the same bandwidth, rows * 8192 B.

Each wrapper takes its kernel's plain PyTorch version (``ops/device.py``)
only because the tensor it was given lies on the CPU; for a CUDA tensor it
launches the kernel or raises. ``LAUNCHES`` counts kernel launches — one per
launch, nowhere else — so a run can show that it went through the kernels.

The expansion (:func:`expand_rows`) is plain torch ops on the device, as the
JAX package's ``expand_rows_device`` is XLA and not Pallas.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import device as dev

# launch counts by kernel (and the reduce's three modes)
LAUNCHES = {
    "rb_group_reduce[dense]": 0,
    "rb_group_reduce[csr]": 0,
    "rb_group_reduce[rowmap]": 0,
    "rb_popcount_rows": 0,
}

# rows per chunk (one CTA each): small enough that a 10,000-row group
# spreads over ~80 CTAs, large enough that the per-chunk atomic combine
# (2048 words) stays under 1/128 of the rows' traffic
CHUNK_ROWS = 128

_OP_CODE = {"or": 0, "and": 1, "xor": 2}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def plan_chunks(seg_offsets: np.ndarray, chunk_rows: int = CHUNK_ROWS) -> np.ndarray:
    """Cut segment g = rows ``[offsets[g], offsets[g+1])`` into chunks of at
    most ``chunk_rows`` rows: int64 ``[C, 3]`` rows of (group, begin, end).
    Every row lies in exactly one chunk, and no chunk crosses a segment;
    empty segments get no chunk."""
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
    offs = np.asarray(seg_offsets, dtype=np.int64)
    lens = np.diff(offs)
    if np.any(lens < 0):
        raise ValueError("segment offsets must be non-decreasing")
    n_ch = (lens + chunk_rows - 1) // chunk_rows
    group = np.repeat(np.arange(len(lens), dtype=np.int64), n_ch)
    first = np.concatenate(([0], np.cumsum(n_ch)[:-1])) if len(n_ch) else n_ch
    k = np.arange(int(n_ch.sum()), dtype=np.int64) - np.repeat(first, n_ch)
    begin = offs[group] + k * chunk_rows
    end = np.minimum(begin + chunk_rows, offs[group + 1])
    return np.stack([group, begin, end], axis=1)


class SegmentPlan:
    """Segments over logical rows — ``offsets`` int64 [G+1] — and the chunk
    table that splits them across CTAs. ``mode`` names the layout it
    serves: ``"dense"`` (G segments of M rows: a padded block, or M
    logical slots per group read through a row map) or ``"csr"`` (group
    offsets of the flat rows). Built once per layout and reused by every
    reduce; the chunk table is copied to a device on first use there."""

    __slots__ = ("offsets", "mode", "chunks", "_on")

    def __init__(self, offsets, mode: str, chunk_rows: int = CHUNK_ROWS):
        if mode not in ("dense", "csr"):
            raise ValueError(f"unknown segment mode {mode!r}")
        self.offsets = np.asarray(offsets, dtype=np.int64)
        self.mode = mode
        self.chunks = plan_chunks(self.offsets, chunk_rows)
        self._on = {}

    @classmethod
    def dense(cls, g: int, m: int, chunk_rows: int = CHUNK_ROWS) -> "SegmentPlan":
        return cls(np.arange(g + 1, dtype=np.int64) * m, "dense", chunk_rows)

    @classmethod
    def csr(cls, group_offsets, chunk_rows: int = CHUNK_ROWS) -> "SegmentPlan":
        return cls(group_offsets, "csr", chunk_rows)

    @property
    def n_groups(self) -> int:
        return len(self.offsets) - 1

    @property
    def n_rows(self) -> int:
        return int(self.offsets[-1])

    def chunks_on(self, device: torch.device) -> torch.Tensor:
        t = self._on.get(device)
        if t is None:
            t = self._on[device] = torch.from_numpy(self.chunks).to(device)
        return t


def _check_words(words: torch.Tensor) -> torch.Tensor:
    if words.dtype != torch.int32:
        raise TypeError(f"word rows must be torch.int32, got {words.dtype}")
    if words.shape[-1] != dev.DEVICE_WORDS:
        raise ValueError(f"word rows must be {dev.DEVICE_WORDS} wide, got {tuple(words.shape)}")
    if not words.is_contiguous():
        raise ValueError("word rows must be contiguous")
    return words.view(-1, dev.DEVICE_WORDS)


def group_reduce_plain(
    words: torch.Tensor, plan: SegmentPlan, op: str = "or",
    row_map: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`group_reduce`: a halving fold with
    ``|``, ``&`` or ``^`` on int32."""
    flat = _check_words(words)
    g = plan.n_groups
    if row_map is None:
        lens = np.diff(plan.offsets)
        if g and np.all(lens == lens[0]) and int(plan.offsets[0]) == 0:
            m = int(lens[0])
            return dev.grouped_reduce(flat[: g * m].view(g, m, dev.DEVICE_WORDS), op)
        return dev.segmented_reduce(flat, plan.offsets, op)
    n = flat.shape[0]
    out = torch.empty((g, dev.DEVICE_WORDS), dtype=torch.int32, device=flat.device)
    for i in range(g):
        src = row_map[int(plan.offsets[i]) : int(plan.offsets[i + 1])]
        out[i] = dev.fold_rows(flat.index_select(0, src[src < n]), op)
    return out


def group_reduce(
    words: torch.Tensor, plan: SegmentPlan, op: str = "or",
    row_map: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-segment bitwise reduce -> int32 ``[G, 2048]``.

    ``words``: int32 ``[N, 2048]`` rows (a ``[G, M, 2048]`` block is taken
    as its ``G*M`` rows). Output row g folds the logical rows
    ``plan.offsets[g]:plan.offsets[g+1]``; logical row r is words row r, or
    with ``row_map`` (int64, one entry per logical row) words row
    ``row_map[r]``, where a value ``>= N`` is an identity pad. An empty
    segment yields the op identity (0, or -1 for and)."""
    if op not in _OP_CODE:
        raise ValueError(f"op must be one of {sorted(_OP_CODE)}, got {op!r}")
    flat = _check_words(words)
    if row_map is not None:
        if row_map.dtype != torch.int64 or row_map.device != flat.device:
            raise TypeError("row_map must be int64 on the words' device")
        if row_map.numel() < plan.n_rows or not row_map.is_contiguous():
            raise ValueError("row_map must be contiguous with one entry per logical row")
    elif plan.n_rows > flat.shape[0]:
        raise ValueError(f"plan covers {plan.n_rows} rows, words hold {flat.shape[0]}")
    if flat.device.type == "cpu":
        return group_reduce_plain(flat, plan, op, row_map)
    if flat.device.type != "cuda":
        raise ValueError(f"unsupported device {flat.device}")
    out = torch.full(
        (plan.n_groups, dev.DEVICE_WORDS), dev._INIT[op], dtype=torch.int32,
        device=flat.device,
    )
    n_chunks = len(plan.chunks)
    if n_chunks == 0:
        return out
    from . import _build

    lib = _build.load()
    chunks = plan.chunks_on(flat.device)
    rc = lib.rb_group_reduce(
        flat.device.index or 0, _OP_CODE[op], flat.data_ptr(), flat.shape[0],
        chunks.data_ptr(), n_chunks,
        None if row_map is None else row_map.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(flat.device).cuda_stream,
    )
    _build.check(lib, rc, "rb_group_reduce")
    LAUNCHES["rb_group_reduce[rowmap]" if row_map is not None
             else f"rb_group_reduce[{plan.mode}]"] += 1
    return out


def popcount_rows_plain(words: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`popcount_rows`."""
    return dev.popcount_rows(_check_words(words))


def popcount_rows(words: torch.Tensor) -> torch.Tensor:
    """Per-row cardinality ``[R, 2048] -> int32 [R]``."""
    flat = _check_words(words)
    if flat.device.type == "cpu":
        return dev.popcount_rows(flat)
    if flat.device.type != "cuda":
        raise ValueError(f"unsupported device {flat.device}")
    r = flat.shape[0]
    out = torch.empty(r, dtype=torch.int32, device=flat.device)
    if r == 0:
        return out
    from . import _build

    lib = _build.load()
    rc = lib.rb_popcount_rows(
        flat.device.index or 0, flat.data_ptr(), r, out.data_ptr(),
        torch.cuda.current_stream(flat.device).cuda_stream,
    )
    _build.check(lib, rc, "rb_popcount_rows")
    LAUNCHES["rb_popcount_rows"] += 1
    return out


# ---------------------------------------------------------------------------
# device-side expansion of compact container payloads
# ---------------------------------------------------------------------------


def _u16(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint16 numpy -> int64 tensor on ``device`` (shipped as 2 bytes a
    value: torch has no general uint16, so it travels as int16 bits and is
    masked back to 0..65535 after widening)."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint16).view(np.int16))
    return t.to(device).to(torch.int64) & 0xFFFF


def _bit32(pos: torch.Tensor) -> torch.Tensor:
    """int32 word with bit ``pos`` (0..31) set; bit 31 is the sign bit."""
    return (torch.ones_like(pos) << pos).to(torch.int32)


def _parity32(x: torch.Tensor) -> torch.Tensor:
    """Per-word bit parity. The shifts are arithmetic on int32, which only
    garbles bits above the ones the final ``& 1`` keeps."""
    for s in (16, 8, 4, 2, 1):
        x = x ^ (x >> s)
    return x & 1


def expand_rows(
    n_rows: int, arr_rows, arr_offsets, arr_values, bmp_rows, bmp_words,
    run_rows, run_counts, run_starts, run_lengths, device,
) -> torch.Tensor:
    """Expand a compact payload (``store.RowPayload.materialize()``) into
    int32 ``[n_rows, 2048]`` rows on ``device``. Only the payload crosses
    to the device (2 bytes per array value, 4 per run, 8 KiB per bitmap
    row); indices are built there, exact-length and int64.

    Array values add their bit masks into the rows (distinct values of a
    container set distinct bits, so add == or). Runs add start toggles and
    stop toggles into two separate blocks that are XORed — a stop that
    lands on the next run's start bit (adjacent runs) cancels it instead
    of carrying, and a run ending at 65535 has no stop toggle — then a
    prefix-XOR within each word (five doubling shifts) and an exclusive
    cumulative parity across words fill the intervals. Bitmap rows are
    copied."""
    device = torch.device(device)
    w = dev.DEVICE_WORDS
    out = torch.zeros(n_rows * w, dtype=torch.int32, device=device)
    if len(arr_values):
        lens = torch.from_numpy(np.diff(arr_offsets)).to(device)
        rows = torch.repeat_interleave(torch.from_numpy(arr_rows).to(device), lens)
        v = _u16(arr_values, device)
        out.index_add_(0, rows * w + (v >> 5), _bit32(v & 31))
        del rows, v
    out = out.view(n_rows, w)
    if len(bmp_rows):
        rows = torch.from_numpy(bmp_rows).to(device)
        out[rows] = torch.from_numpy(
            np.ascontiguousarray(bmp_words).view(np.int32).reshape(len(bmp_rows), w)
        ).to(device)
    kr = len(run_rows)
    if kr:
        compact = torch.repeat_interleave(
            torch.arange(kr, device=device), torch.from_numpy(run_counts).to(device)
        )
        s = _u16(run_starts, device)
        e1 = s + _u16(run_lengths, device) + 1
        tog_s = torch.zeros(kr * w, dtype=torch.int32, device=device)
        tog_s.index_add_(0, compact * w + (s >> 5), _bit32(s & 31))
        inside = e1 < (1 << 16)
        e1, ce = e1[inside], compact[inside]
        tog_e = torch.zeros(kr * w, dtype=torch.int32, device=device)
        tog_e.index_add_(0, ce * w + (e1 >> 5), _bit32(e1 & 31))
        tog = (tog_s ^ tog_e).view(kr, w)
        fill = tog
        for sh in (1, 2, 4, 8, 16):
            fill = fill ^ (fill << sh)
        par = _parity32(tog)
        carry = ((torch.cumsum(par, dim=1) - par) & 1).to(torch.int32)
        out[torch.from_numpy(run_rows).to(device)] = fill ^ -carry
    return out
