"""Rank/select-accelerated bitmap (FastRankRoaringBitmap.java:21-39):
cumulative per-key cardinalities cached and invalidated on writes.

Counterpart of the JAX package's ``models/fastrank.py``. Rank and select
are host work over the cached prefix sums (``utils/order_stats``); no
device kernel is involved."""

from __future__ import annotations

import numpy as np

from ..utils.order_stats import bucketed_rank, bucketed_select
from .roaring import RoaringBitmap


class FastRankRoaringBitmap(RoaringBitmap):
    __slots__ = ("_cum", "_dirty")

    def __init__(self, values=None):
        self._cum = None
        self._dirty = True
        super().__init__(values)

    def _invalidate(self):
        self._dirty = True

    # every mutator invalidates the cache (FastRankRoaringBitmap.java:30-39)
    def add(self, x):
        self._invalidate()
        return super().add(x)

    def add_many(self, values):
        self._invalidate()
        return super().add_many(values)

    def remove(self, x):
        self._invalidate()
        return super().remove(x)

    def add_range(self, s, e):
        self._invalidate()
        return super().add_range(s, e)

    def remove_range(self, s, e):
        self._invalidate()
        return super().remove_range(s, e)

    def flip_range(self, s, e):
        self._invalidate()
        return super().flip_range(s, e)

    def ior(self, o):
        self._invalidate()
        return super().ior(o)

    def iand(self, o):
        self._invalidate()
        return super().iand(o)

    def ixor(self, o):
        self._invalidate()
        return super().ixor(o)

    def iandnot(self, o):
        self._invalidate()
        return super().iandnot(o)

    def _cum_cards(self) -> np.ndarray:
        if self._dirty or self._cum is None:
            cards = np.array(
                [c.cardinality for c in self.high_low_container.containers],
                dtype=np.int64,
            )
            self._cum = np.cumsum(cards) if cards.size else np.empty(0, dtype=np.int64)
            self._dirty = False
        return self._cum

    def rank_long(self, x: int) -> int:
        x = int(x)
        hb, lb = x >> 16, x & 0xFFFF
        hlc = self.high_low_container
        return bucketed_rank(
            hlc.keys, self._cum_cards(), hb, lambda i: hlc.containers[i].rank(lb)
        )

    rank = rank_long

    def select(self, j: int) -> int:
        hlc = self.high_low_container
        return bucketed_select(
            hlc.keys,
            self._cum_cards(),
            j,
            lambda i, lj: (hlc.keys[i] << 16) | hlc.containers[i].select(lj),
        )
