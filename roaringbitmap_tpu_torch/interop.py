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

The 64-bit family keeps the layout. A ``Roaring64Bitmap``
(:func:`r64_to_state` / :func:`r64_from_state`) is one dict whose ``keys``
are uint64 high-48 chunk keys; a ``Roaring64NavigableMap``
(:func:`r64nm_to_state` / :func:`r64nm_from_state`) is ``signed_longs``,
its uint64 high-32 bucket ``keys`` and one 32-bit dict per bucket under
``buckets``; a ``Roaring64BitmapSliceIndex`` (:func:`bsi64_to_state` /
:func:`bsi64_from_state`) is the 32-bit index's dict over 64-bit ones.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from .models.bsi import RoaringBitmapSliceIndex
from .models.bsi64 import Roaring64BitmapSliceIndex
from .models.container import ArrayContainer, BitmapContainer, RunContainer
from .models.roaring import RoaringBitmap
from .models.roaring64 import Roaring64NavigableMap
from .models.roaring64art import Roaring64Bitmap, key_to_int
from .utils import bits

ARRAY_KIND, BITMAP_KIND, RUN_KIND = 0, 1, 2


def _containers_state(keys, containers, key_dtype) -> Dict[str, np.ndarray]:
    """The state dict of ``containers`` under ``keys`` (ascending)."""
    kinds, parts, words = [], [], []
    for c in containers:
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
        "keys": np.asarray(keys, dtype=key_dtype),
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


def _state_containers(d: Dict[str, np.ndarray]) -> List[Tuple[int, Any]]:
    """``(key, container)`` pairs of a state dict, each container of its
    recorded kind; raises on an inconsistent dict."""
    keys = np.asarray(d["keys"], dtype=np.uint64)
    kinds = np.asarray(d["kinds"], dtype=np.uint8)
    offsets = np.asarray(d["offsets"], dtype=np.int64)
    payload = np.asarray(d["u16_payload"], dtype=np.uint16)
    words = np.asarray(d["words"], dtype=np.uint64)
    if not (len(keys) == len(kinds) == len(offsets) - 1):
        raise ValueError("keys, kinds and offsets disagree on the container count")
    if len(keys) > 1 and np.any(keys[1:] <= keys[:-1]):
        raise ValueError("keys must be strictly increasing")
    out = []
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
        out.append((key, c))
    if wi != len(words):
        raise ValueError("words holds more rows than there are bitmap containers")
    return out


def to_state(bm: RoaringBitmap) -> Dict[str, np.ndarray]:
    """The bitmap's containers as the state dict described above."""
    hlc = bm.high_low_container
    return _containers_state(hlc.keys, hlc.containers, np.uint16)


def from_state(d: Dict[str, np.ndarray]) -> RoaringBitmap:
    """Rebuild a bitmap from a state dict, keeping each container's kind."""
    out = RoaringBitmap()
    hlc = out.high_low_container
    for key, c in _state_containers(d):
        if key > 0xFFFF:
            raise ValueError(f"chunk key {key} does not fit 16 bits")
        hlc.append(key, c)
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


def r64_to_state(bm: Roaring64Bitmap) -> Dict[str, np.ndarray]:
    """A ``Roaring64Bitmap`` as the state dict above with uint64 ``keys``:
    the containers' high-48 chunk keys, ascending."""
    kv = list(bm._kv())
    return _containers_state([key_to_int(k) for k, _ in kv], [c for _, c in kv], np.uint64)


def r64_from_state(d: Dict[str, np.ndarray]) -> Roaring64Bitmap:
    """Rebuild a ``Roaring64Bitmap`` from :func:`r64_to_state`'s dict."""
    out = Roaring64Bitmap()
    held = out._containers
    pairs = []
    for key, c in _state_containers(d):
        if key >= 1 << 48:
            raise ValueError(f"chunk key {key} does not fit 48 bits")
        pairs.append((key.to_bytes(6, "big"), held.add(c)))
    out._art.bulk_load(pairs)
    return out


def r64nm_to_state(m: Roaring64NavigableMap) -> Dict[str, Any]:
    """A ``Roaring64NavigableMap`` bucket-wise: ``signed_longs``, the
    high-32 bucket keys as uint64 ``keys`` (ascending, unsigned) and one
    32-bit state dict per bucket under ``buckets``."""
    keys = sorted(m._buckets)
    return {
        "signed_longs": bool(m.signed_longs),
        "keys": np.asarray(keys, dtype=np.uint64),
        "buckets": [to_state(m._buckets[k]) for k in keys],
    }


def r64nm_from_state(d: Dict[str, Any], supplier=None) -> Roaring64NavigableMap:
    """Rebuild a ``Roaring64NavigableMap`` from :func:`r64nm_to_state`'s
    dict; ``supplier`` makes each bucket (default ``RoaringBitmap``)."""
    keys = np.asarray(d["keys"], dtype=np.uint64).tolist()
    if len(keys) != len(d["buckets"]):
        raise ValueError("keys and buckets disagree on the bucket count")
    if any(k >= 1 << 32 for k in keys) or any(b <= a for a, b in zip(keys, keys[1:])):
        raise ValueError("bucket keys must be strictly increasing 32-bit keys")
    out = Roaring64NavigableMap(signed_longs=bool(d["signed_longs"]), supplier=supplier)
    for k, state in zip(keys, d["buckets"]):
        bucket = out.supplier()
        bucket.high_low_container = from_state(state).high_low_container
        if not bucket.is_empty():
            out._buckets[k] = bucket
    out._keys_dirty = True
    return out


def bsi64_to_state(index: Roaring64BitmapSliceIndex) -> Dict[str, Any]:
    """A 64-bit bit-sliced index as plain values and 64-bit state dicts."""
    return {
        "min_value": int(index.min_value),
        "max_value": int(index.max_value),
        "run_optimized": bool(index.run_optimized),
        "ebm": r64_to_state(index.ebm),
        "slices": [r64_to_state(s) for s in index.slices],
    }


def bsi64_from_state(d: Dict[str, Any]) -> Roaring64BitmapSliceIndex:
    """Rebuild a 64-bit bit-sliced index from :func:`bsi64_to_state`'s
    dict."""
    out = Roaring64BitmapSliceIndex()
    out.min_value = int(d["min_value"])
    out.max_value = int(d["max_value"])
    out.run_optimized = bool(d["run_optimized"])
    out.ebm = r64_from_state(d["ebm"])
    out.slices = [r64_from_state(s) for s in d["slices"]]
    return out
