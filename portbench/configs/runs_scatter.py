"""Maker of a synthetic index of 10,000-odd bitmaps of runs and scattered
values, and its plain reference.

The shape is the port's seeded generator ``synthetic_census_like``
(``roaringbitmap_tpu_torch/utils/datasets.py``), copied here and drawn in a
few large calls on the device: each bitmap is the union of 1-29 runs of
1-1,999 consecutive values starting anywhere in [0, 2,000,000) and of
10-2,999 values scattered over the same range. No published corpus defines
this shape; it is not the real-roaring-dataset census1881 corpus. Every
bitmap is its own draw, so no two are alike.

The reference works from the drawn value arrays alone, in plain PyTorch:
a bitmap is its bitset over the universe, an aggregation counts how many
operands hold each value.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

SHIFT = 21  # the values are below 2^21 (2,001,998 at most)


def _lo_hi(pair) -> tuple:
    lo, hi = (int(x) for x in pair)
    if not 0 <= lo < hi:
        raise ValueError(f"bad half-open range {pair}")
    return lo, hi


class Deployment:
    """The drawn values (host), the bitmaps the port serves, and the
    shapes the work counts read."""

    def __init__(self, cfg: dict, values: np.ndarray, offsets: np.ndarray,
                 containers: int, groups: int, device: torch.device):
        self.cfg = cfg
        self.values = values  # uint32, bitmap after bitmap, each sorted
        self.offsets = offsets  # int64 [n + 1]
        self.containers = containers  # (bitmap, chunk key) pairs
        self.groups = groups  # distinct chunk keys over all bitmaps
        self.universe = int(cfg["universe"])
        self.device = device
        self.bitmaps: List = []

    @property
    def n(self) -> int:
        return self.offsets.size - 1

    def values_of(self, i: int) -> np.ndarray:
        return self.values[self.offsets[i]: self.offsets[i + 1]]

    def free_program(self) -> None:
        self.bitmaps = []

    # ---- the plain reference ------------------------------------------
    def counts(self, indices: Sequence[int]) -> torch.Tensor:
        """int32 ``[universe]``: how many of the bitmaps ``indices`` hold
        each value (an index listed twice counts twice)."""
        parts = [self.values_of(int(i)) for i in indices]
        flat = np.concatenate(parts) if parts else np.empty(0, dtype=np.uint32)
        v = torch.from_numpy(flat.astype(np.int64)).to(self.device)
        return torch.bincount(v, minlength=self.universe).to(torch.int32)


def draw(cfg: dict, seed: int, device: torch.device):
    """(values uint32, offsets int64 [n + 1], containers, groups): the
    bitmaps' sorted values, bitmap after bitmap, from ``seed``."""
    n = int(cfg["bitmaps"])
    runs_lo, runs_hi = _lo_hi(cfg["runs"])
    len_lo, len_hi = _lo_hi(cfg["run_length"])
    start_lo, start_hi = _lo_hi(cfg["start_range"])
    sc_lo, sc_hi = _lo_hi(cfg["scattered"])
    if start_hi + len_hi > 1 << SHIFT or int(cfg["universe"]) > 1 << SHIFT:
        raise ValueError("values must stay below 2^21")
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    owners = torch.arange(n, device=device)

    def ints(lo, hi, size):
        return torch.randint(lo, hi, (size,), generator=g, device=device)

    n_runs = ints(runs_lo, runs_hi, n)
    run_owner = torch.repeat_interleave(owners, n_runs)
    starts = ints(start_lo, start_hi, run_owner.numel())
    lengths = ints(len_lo, len_hi, run_owner.numel())
    first = torch.cumsum(lengths, 0) - lengths
    pos = torch.arange(int(lengths.sum()), device=device)
    pos -= torch.repeat_interleave(first, lengths)
    run_vals = torch.repeat_interleave(starts, lengths) + pos
    run_keys = (torch.repeat_interleave(run_owner, lengths) << SHIFT) | run_vals
    del pos, run_vals, first
    n_sc = ints(sc_lo, sc_hi, n)
    sc_owner = torch.repeat_interleave(owners, n_sc)
    sc_keys = (sc_owner << SHIFT) | ints(start_lo, start_hi, sc_owner.numel())
    keys = torch.unique(torch.cat([run_keys, sc_keys]))  # sorted
    del run_keys, sc_keys, sc_owner
    owner = keys >> SHIFT
    counts = torch.bincount(owner, minlength=n)
    chunk_keys = torch.unique(keys >> 16)  # (owner, value >> 16) pairs
    containers = int(chunk_keys.numel())
    groups = int(torch.unique(chunk_keys & ((1 << (SHIFT - 16)) - 1)).numel())
    values = (keys & ((1 << SHIFT) - 1)).to(torch.int32).cpu().numpy().view(np.uint32)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts.cpu().numpy(), out=offsets[1:])
    return values, offsets, containers, groups


def load(cfg: dict, drawn, device: torch.device) -> Deployment:
    """Build the port's ``RoaringBitmap`` of each drawn bitmap from its
    sorted values, as a serving process does when it loads a segment's
    attribute bitmaps."""
    from roaringbitmap_tpu_torch import RoaringBitmap

    dep = Deployment(cfg, *drawn, device)
    dep.bitmaps = [RoaringBitmap(dep.values_of(i)) for i in range(dep.n)]
    return dep
