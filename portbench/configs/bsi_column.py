"""Maker of a bit-sliced index over one unsigned 32-bit column, and its
plain reference.

The column's values are drawn uniformly from [0, 2^32) on the device from
the seed; column ids are ``0 .. rows - 1``. The benchmark writes the index
in the upstream BSI wire format from those values (``wire.bsi_bytes``: the
bit transpose runs on the device) and the port opens it with
``RoaringBitmapSliceIndex.deserialize``, as a serving process opens a
stored segment; nothing here calls the port's ``set_values``.

The reference answers from the sorted values (counts) and from the values
themselves (the matching columns' bitset), in plain PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import answers, wire

CHUNK = 1 << 16


class Deployment:
    def __init__(self, cfg: dict, values: np.ndarray, slices: int, chunks: int,
                 device: torch.device):
        self.cfg = cfg
        self.values = values  # uint32 [rows], the value of column c at c
        self.rows = values.size
        self.slices = slices
        self.chunks = chunks
        self.device = device
        self.index = None
        self._sorted = None
        self._column = None

    def free_program(self) -> None:
        self.index = None

    # ---- the plain reference ------------------------------------------
    def column(self, rounded_to_float32: bool = False) -> torch.Tensor:
        """int64 ``[rows]`` values on the device; with
        ``rounded_to_float32`` each value is what a float32 holds of it."""
        v = torch.from_numpy(self.values.astype(np.int64)).to(self.device)
        if rounded_to_float32:
            v = v.to(torch.float32).to(torch.float64).to(torch.int64)
        return v

    def counts_ge(self, thresholds: np.ndarray, column: torch.Tensor = None) -> np.ndarray:
        """int64 ``[Q]``: how many columns hold a value >= each threshold."""
        if column is None:
            if self._sorted is None:
                self._sorted = torch.sort(self.column()).values
            ordered = self._sorted
        else:
            ordered = torch.sort(column).values
        t = torch.as_tensor(np.asarray(thresholds, dtype=np.int64), device=self.device)
        below = torch.searchsorted(ordered, t, right=False)
        return (self.rows - below).cpu().numpy().astype(np.int64)

    def columns_in(self, lo: int, hi: int, column: torch.Tensor = None) -> np.ndarray:
        """The columns whose value lies in [lo, hi], as set words."""
        if column is None:
            if self._column is None:
                self._column = self.column()
            column = self._column
        return answers.mask_words((column >= lo) & (column <= hi))


def _as_u32(v: torch.Tensor) -> np.ndarray:
    """int64 values in [0, 2^32) as a uint32 numpy array of the same bits."""
    wrapped = torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)
    return wrapped.cpu().numpy().view(np.uint32)


def draw(cfg: dict, seed: int, device: torch.device):
    """The column's values uniform in [0, 2^value_bits) from ``seed``, bit
    transposed on the device: (uint32 values, uint64 ``[S, K, 1024]``
    slice rows, ``[S, K]`` counts, min, max)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    v = torch.randint(0, 1 << int(cfg["value_bits"]), (int(cfg["rows"]),),
                      generator=g, device=device, dtype=torch.int64)
    lo, hi = int(v.min()), int(v.max())
    words, cards = slice_rows(v, max(1, hi.bit_length()))
    return _as_u32(v), words, cards, lo, hi


def slice_rows(v: torch.Tensor, slices: int):
    """(uint64 ``[S, K, 1024]`` slice rows, int64 ``[S, K]`` counts): bit i
    of each column's value, on the device, then on the host."""
    n = v.numel()
    k = -(-n // CHUNK)
    padded = torch.zeros(k * CHUNK, dtype=torch.int64, device=v.device)
    padded[:n] = v
    weights = torch.ones(1, dtype=torch.int64, device=v.device) << torch.arange(64, device=v.device)
    rows = torch.empty((slices, k * 1024), dtype=torch.int64, device=v.device)
    cards = torch.empty((slices, k), dtype=torch.int64, device=v.device)
    for i in range(slices):
        bit = (padded >> i) & 1
        cards[i] = bit.view(k, CHUNK).sum(dim=1)
        # distinct powers of two: the sum is their OR, bit 63 wrapping to
        # the sign as the uint64 view wants
        rows[i] = (bit.view(k * 1024, 64) * weights).sum(dim=1)
    return rows.cpu().numpy().view(np.uint64).reshape(slices, k, 1024), cards.cpu().numpy()


def load(cfg: dict, drawn, device: torch.device) -> Deployment:
    """Write the index's bytes and open them with the port's
    ``RoaringBitmapSliceIndex.deserialize``."""
    from roaringbitmap_tpu_torch import RoaringBitmapSliceIndex

    values, words, cards, lo, hi = drawn
    data = wire.bsi_bytes(words, cards, values.size, lo, hi)
    dep = Deployment(cfg, values, words.shape[0], words.shape[1], device)
    dep.index = RoaringBitmapSliceIndex.deserialize(data)
    return dep
