"""Carry bitmaps across from other Roaring implementations as plain arrays.

For this system the "weights" are the bitmaps. A bitmap's state is a dict of
numpy arrays that any implementation with array, bitmap and run containers
can read and write — the JAX package among them — without either side
importing the other:

* ``keys`` — uint16 ``[C]``, the containers' high-16-bit chunk keys, ascending;
* ``kinds`` — uint8 ``[C]``: 0 array, 1 bitmap, 2 run;
* ``offsets`` — int64 ``[C+1]``, each container's slice of ``u16_payload``;
* ``u16_payload`` — uint16: an array container's sorted values, a run
  container's interleaved (start, length) pairs (run = [start,
  start+length]), nothing for a bitmap container;
* ``words`` — uint64 ``[B, 1024]``, the bitmap containers' words in key order.

Serialized bytes (``RoaringBitmap.serialize``) are the second, independent
bridge.

A bit-sliced index travels the same way (:func:`bsi_to_state` /
:func:`bsi_from_state`): ``min_value``, ``max_value`` and ``run_optimized``
as Python values, the existence bitmap's state dict under ``ebm`` and one
state dict per slice under ``slices``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from .models.bsi import RoaringBitmapSliceIndex
from .models.container import ArrayContainer, BitmapContainer, RunContainer
from .models.roaring import RoaringBitmap
from .utils import bits

ARRAY_KIND, BITMAP_KIND, RUN_KIND = 0, 1, 2


def to_state(bm: RoaringBitmap) -> Dict[str, np.ndarray]:
    """The bitmap's containers as the state dict described above."""
    hlc = bm.high_low_container
    kinds, parts, words = [], [], []
    for c in hlc.containers:
        if isinstance(c, RunContainer):
            pairs = np.empty(2 * c.starts.size, dtype=np.uint16)
            pairs[0::2] = c.starts
            pairs[1::2] = c.lengths
            kinds.append(RUN_KIND)
            parts.append(pairs)
        elif isinstance(c, BitmapContainer):
            kinds.append(BITMAP_KIND)
            parts.append(np.empty(0, dtype=np.uint16))
            words.append(np.asarray(c.words, dtype=np.uint64))
        else:
            kinds.append(ARRAY_KIND)
            parts.append(np.asarray(c.to_array(), dtype=np.uint16))
    lens = np.array([p.size for p in parts], dtype=np.int64)
    return {
        "keys": np.asarray(hlc.keys, dtype=np.uint16),
        "kinds": np.asarray(kinds, dtype=np.uint8),
        "offsets": np.concatenate(([0], np.cumsum(lens))).astype(np.int64),
        "u16_payload": (
            np.concatenate(parts) if parts else np.empty(0, dtype=np.uint16)
        ),
        "words": (
            np.stack(words)
            if words
            else np.empty((0, bits.WORDS_PER_CONTAINER), dtype=np.uint64)
        ),
    }


def from_state(d: Dict[str, np.ndarray]) -> RoaringBitmap:
    """Rebuild a bitmap from a state dict, keeping each container's kind."""
    keys = np.asarray(d["keys"], dtype=np.int64)
    kinds = np.asarray(d["kinds"], dtype=np.uint8)
    offsets = np.asarray(d["offsets"], dtype=np.int64)
    payload = np.asarray(d["u16_payload"], dtype=np.uint16)
    words = np.asarray(d["words"], dtype=np.uint64)
    if not (len(keys) == len(kinds) == len(offsets) - 1):
        raise ValueError("keys, kinds and offsets disagree on the container count")
    if len(keys) > 1 and np.any(np.diff(keys) <= 0):
        raise ValueError("keys must be strictly increasing")
    out = RoaringBitmap()
    hlc = out.high_low_container
    wi = 0
    for i, key in enumerate(keys.tolist()):
        seg = payload[offsets[i] : offsets[i + 1]].copy()
        kind = int(kinds[i])
        if kind == ARRAY_KIND:
            c = ArrayContainer(seg)
        elif kind == RUN_KIND:
            c = RunContainer(seg[0::2], seg[1::2])
        elif kind == BITMAP_KIND:
            c = BitmapContainer(words[wi].copy())
            wi += 1
        else:
            raise ValueError(f"unknown container kind {kind}")
        hlc.append(key, c)
    if wi != len(words):
        raise ValueError("words holds more rows than there are bitmap containers")
    return out


def bsi_to_state(index: RoaringBitmapSliceIndex) -> Dict[str, Any]:
    """A bit-sliced index as plain values and bitmap state dicts."""
    return {
        "min_value": int(index.min_value),
        "max_value": int(index.max_value),
        "run_optimized": bool(index.run_optimized),
        "ebm": to_state(index.ebm),
        "slices": [to_state(s) for s in index.slices],
    }


def bsi_from_state(d: Dict[str, Any], cls=RoaringBitmapSliceIndex) -> RoaringBitmapSliceIndex:
    """Rebuild a bit-sliced index (of ``cls``, e.g. ``MutableBitSliceIndex``)
    from :func:`bsi_to_state`'s dict."""
    out = cls()
    out.min_value = int(d["min_value"])
    out.max_value = int(d["max_value"])
    out.run_optimized = bool(d["run_optimized"])
    out.ebm = from_state(d["ebm"])
    out.slices = [from_state(s) for s in d["slices"]]
    return out

