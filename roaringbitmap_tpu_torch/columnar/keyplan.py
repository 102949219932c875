"""Stage 1 of the columnar pairwise engine: the key plan.

Counterpart of ``roaringbitmap_tpu/columnar/keyplan.py``. One
``searchsorted`` over the two bitmaps' (already sorted) key arrays
classifies every chunk key in one shot — matched pairs vs pass-throughs —
instead of the facade's per-key two-pointer merge loop
(RoaringBitmap.java:377's ``highbits`` merge, computed as a batch).
"""

from __future__ import annotations

from typing import List

import numpy as np

_EMPTY = np.empty(0, dtype=np.int64)


class KeyPlan:
    """Matched/pass-through split of two key arrays.

    ``ia``/``ib`` — indices of matched keys into a's and b's container
    lists (aligned; ``matched_keys = akeys[ia]``); ``a_only``/``b_only`` —
    pass-through indices (populated only when the op propagates that side:
    both for or/xor, left for andnot, neither for and).
    """

    __slots__ = ("akeys", "bkeys", "ia", "ib", "a_only", "b_only")

    def __init__(self, akeys, bkeys, ia, ib, a_only, b_only):
        self.akeys = akeys
        self.bkeys = bkeys
        self.ia = ia
        self.ib = ib
        self.a_only = a_only
        self.b_only = b_only

    @property
    def matched_keys(self) -> np.ndarray:
        return self.akeys[self.ia]


def key_plan(akeys: List[int], bkeys: List[int], op: str) -> KeyPlan:
    """The matched/pass-through split for ``op`` in one vectorized pass.
    ``op`` decides which pass-through sides are kept: ``and`` keeps none,
    ``andnot`` keeps a's, ``or``/``xor`` keep both."""
    a = np.asarray(akeys, dtype=np.int64)
    b = np.asarray(bkeys, dtype=np.int64)
    if a.size == 0 or b.size == 0:
        a_only = np.arange(a.size, dtype=np.int64) if op != "and" else _EMPTY
        b_only = np.arange(b.size, dtype=np.int64) if op in ("or", "xor") else _EMPTY
        return KeyPlan(a, b, _EMPTY, _EMPTY, a_only, b_only)
    pos = np.searchsorted(b, a)
    posc = np.minimum(pos, b.size - 1)
    hit = (pos < b.size) & (b[posc] == a)
    ia = np.flatnonzero(hit)
    ib = pos[ia]
    a_only = np.flatnonzero(~hit) if op != "and" else _EMPTY
    if op in ("or", "xor"):
        bmask = np.ones(b.size, dtype=bool)
        bmask[ib] = False
        b_only = np.flatnonzero(bmask)
    else:
        b_only = _EMPTY
    return KeyPlan(a, b, ia, ib, a_only, b_only)
