"""L0' device layout and the plain PyTorch word ops.

Device layout: ``[N, 2048]`` ``torch.int32`` tensors — each row is one
container (65536 bits) — holding the uint32 bits of the JAX package's
``uint32 [N, 2048]`` rows (``roaringbitmap_tpu/ops/device.py``). The int32
view is forced by torch: its ``uint32`` has no ``~`` and no ``>>`` on the
CPU. Bitwise and/or/xor and left shifts are the same on both views; a right
shift on an int32 extends the sign, so code that needs a logical shift masks
after it. Host words are ``uint64 [1024]``; the views are interchangeable
little-endian (u64 word k == u32[2k] | u32[2k+1] << 32).

The functions below are the plain versions of the device ops: what the
kernel wrappers in ``ops/kernels.py`` run on CPU tensors, and what the CUDA
kernels are held against on the card. Nothing on the main path calls them
for a CUDA tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

DEVICE_WORDS = 2048  # 32-bit words per container row
HOST_WORDS = 1024  # uint64 words per container

# op identities as int32 bit patterns (0xFFFFFFFF == -1)
_INIT = {
    "or": 0,
    "xor": 0,
    "and": -1,
}
_OPS = {
    "or": torch.bitwise_or,
    "xor": torch.bitwise_xor,
    "and": torch.bitwise_and,
}

# rows per block of the table-lookup popcount (bounds its int32 index
# tensor to 4096 * 8192 * 4 bytes = 128 MiB)
_POPCOUNT_BLOCK_ROWS = 4096


def to_device_words(host_words: np.ndarray, device=None) -> torch.Tensor:
    """uint64 [..., 1024] host words -> int32 [..., 2048] tensor on
    ``device`` (default ``"cuda"``; raises without a card unless
    ``device="cpu"``)."""
    device = resolve_device(device)
    w = np.ascontiguousarray(host_words, dtype=np.uint64)
    rows = w.view(np.int32).reshape(*w.shape[:-1], DEVICE_WORDS)
    return torch.from_numpy(rows).to(device)


def from_device_words(dev_words: torch.Tensor) -> np.ndarray:
    """int32 [..., 2048] tensor -> uint64 [..., 1024] host words."""
    w = np.ascontiguousarray(dev_words.cpu().numpy())
    return w.view(np.uint64).reshape(*w.shape[:-1], HOST_WORDS)


def to_host_u32(dev_words: torch.Tensor) -> np.ndarray:
    """int32 tensor -> the same bits as a uint32 numpy array."""
    return np.ascontiguousarray(dev_words.cpu().numpy()).view(np.uint32)


def fold_rows(x: torch.Tensor, op: str) -> torch.Tensor:
    """Halving fold of ``[..., L, W]`` along the row axis -> ``[..., W]``
    (the op identity when L == 0)."""
    fn = _OPS[op]
    if x.shape[-2] == 0:
        return torch.full(
            x.shape[:-2] + x.shape[-1:], _INIT[op], dtype=x.dtype, device=x.device
        )
    while x.shape[-2] > 1:
        n = x.shape[-2]
        h = n // 2
        y = fn(x[..., :h, :], x[..., h : 2 * h, :])
        x = torch.cat([y, x[..., 2 * h :, :]], dim=-2) if n % 2 else y
    return x[..., 0, :]


def grouped_reduce(words3: torch.Tensor, op: str = "or") -> torch.Tensor:
    """Reduce padded groups ``[G, M, W] -> [G, W]`` (pad rows hold the op
    identity: 0 for or/xor, -1 for and)."""
    return fold_rows(words3, op)


def segmented_reduce(
    words: torch.Tensor, group_offsets: np.ndarray, op: str = "or"
) -> torch.Tensor:
    """Reduce the row segments ``group_offsets[g]:group_offsets[g+1]`` of
    ``[N, W]`` -> ``[G, W]``: the segment-end rows of the JAX package's
    inclusive segmented scan, which are all its caller reads."""
    offs = np.asarray(group_offsets, dtype=np.int64)
    g = len(offs) - 1
    out = torch.empty((g, words.shape[-1]), dtype=words.dtype, device=words.device)
    for i in range(g):
        out[i] = fold_rows(words[int(offs[i]) : int(offs[i + 1])], op)
    return out


_POP8 = [bin(i).count("1") for i in range(256)]


def popcount_rows(words: torch.Tensor) -> torch.Tensor:
    """Per-row cardinality ``[R, W] -> int32 [R]``: each word viewed as 4
    bytes, looked up in a 256-entry table, summed."""
    if words.shape[0] == 0:
        return torch.empty(0, dtype=torch.int32, device=words.device)
    table = torch.tensor(_POP8, dtype=torch.uint8, device=words.device)
    rows = words.contiguous()
    out = torch.empty(rows.shape[0], dtype=torch.int32, device=words.device)
    for i in range(0, rows.shape[0], _POPCOUNT_BLOCK_ROWS):
        block = rows[i : i + _POPCOUNT_BLOCK_ROWS].view(torch.uint8)
        out[i : i + _POPCOUNT_BLOCK_ROWS] = table[block.to(torch.int32)].sum(
            dim=-1, dtype=torch.int32
        )
    return out


# O'Neil compare ops (models/bsi.Operation values)
ONEIL_OPS = ("EQ", "NEQ", "GT", "LT", "LE", "GE", "RANGE")


def _walk(slices: torch.Tensor, bits, ebm: torch.Tensor):
    """One O'Neil walk from the highest slice down; ``bits[j]`` is the
    predicate bit of slice ``S - 1 - j``. Returns ``(gt, lt, eq)``."""
    zeros = torch.zeros_like(ebm)
    gt, lt, eq = zeros, zeros, ebm
    s_count = slices.shape[0]
    for j in range(s_count):
        sl = slices[s_count - 1 - j]
        if bool(bits[j]):
            lt = lt | (eq & ~sl)
            eq = eq & sl
        else:
            gt = gt | (eq & sl)
            eq = eq & ~sl
    return gt, lt, eq


def o_neil_walk(slices: torch.Tensor, bits, ebm: torch.Tensor, fixed: torch.Tensor, op: str):
    """The O'Neil slice walk and its per-op epilogue (the counterpart of the
    JAX package's ``models/bsi.py:o_neil_math``): int32 ``[S, K, W]``
    slices, predicate bits ``[S]`` high slice first (``[2, S]`` for RANGE:
    the GE walk of the low bound, then the LE walk of the high one), int32
    ``[K, W]`` ebm and fixed words -> (int32 ``[K, W]`` result words, int32
    ``[K]`` popcounts)."""
    if op not in ONEIL_OPS:
        raise ValueError(f"op must be one of {ONEIL_OPS}, got {op!r}")
    if op == "RANGE":
        gt_lo, _, eq_lo = _walk(slices, bits[0], ebm)
        _, lt_hi, eq_hi = _walk(slices, bits[1], ebm)
        out = (gt_lo | eq_lo) & (lt_hi | eq_hi) & fixed
    else:
        gt, lt, eq = _walk(slices, bits, ebm)
        eq = eq & fixed
        out = {
            "EQ": lambda: eq,
            "NEQ": lambda: fixed & ~eq,
            "GT": lambda: gt & fixed,
            "LT": lambda: lt & fixed,
            "LE": lambda: (lt | eq) & fixed,
            "GE": lambda: (gt | eq) & fixed,
        }[op]()
    return out, popcount_rows(out)


def slice_masked_popcounts(slices: torch.Tensor, found: torch.Tensor) -> torch.Tensor:
    """``[S, K, W] & [K, W]`` -> int32 ``[S, K]`` popcounts (the counterpart
    of ``models/bsi.py:_slice_masked_popcounts``)."""
    s_count, k = slices.shape[0], slices.shape[1]
    out = torch.empty((s_count, k), dtype=torch.int32, device=slices.device)
    for i in range(s_count):
        out[i] = popcount_rows(slices[i] & found)
    return out



def rank_rows(words: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Per-row rank: the set bits of row ``i`` at bit index <= ``positions[i]``
    (int32 ``[N]``; positions in ``[0, 65536)``), the batched analogue of
    ``BitmapContainer.rank`` and the counterpart of the JAX package's
    ``ops/device.py:rank_rows``. Words below the position's word count
    whole; the position's own word is masked to bits ``0..bit`` by
    ``0xFFFFFFFF >> (31 - bit)``, shifted as an int64, where the shift is
    logical, then taken as the int32 bits of the row's view."""
    n_words = words.shape[-1]
    pos = positions.to(device=words.device, dtype=torch.int64)
    word_idx = (pos // 32)[:, None]
    bit_idx = (pos % 32)[:, None]
    iota = torch.arange(n_words, device=words.device, dtype=torch.int64)[None, :]
    partial = 0xFFFFFFFF >> (31 - bit_idx)  # int64: a logical shift
    partial = torch.where(partial >= 1 << 31, partial - (1 << 32), partial)
    mask = torch.where(iota < word_idx, -1, torch.where(iota == word_idx, partial, 0))
    return popcount_rows(words & mask.to(torch.int32))
