"""Bytes in the upstream wire formats, written from numpy arrays.

The portable RoaringBitmap format (RoaringFormatSpec; RoaringArray.java
serialize) and the bit-sliced index's ByteBuffer layout
(RoaringBitmapSliceIndex.serialize(ByteBuffer): int32 minValue, int32
maxValue, byte runOptimized, the existence bitmap, int32 sliceCount, the
slices; little-endian). A serving process that opens a stored segment reads
such bytes; the benchmark writes them in bulk from the column's values, so
no run pays for building the index value by value.
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

SERIAL_COOKIE = 12347
SERIAL_COOKIE_NO_RUNCONTAINER = 12346
NO_OFFSET_THRESHOLD = 4
ARRAY_MAX = 4096
CHUNK = 1 << 16


def _int32_bits(v: int) -> int:
    """A value in [0, 2^32) as the Java int that holds its 32 bits."""
    if not 0 <= v < 1 << 32:
        raise ValueError(f"{v} does not fit 32 bits")
    return v - (1 << 32) if v >= 1 << 31 else v


def bitmap_from_words(words: np.ndarray, cards: np.ndarray) -> bytes:
    """The bitmap whose chunk ``i`` holds the set bits of ``words[i]``
    (uint64 ``[K, 1024]``, bit b of word w is value 64w + b; ``cards[i]``
    of them), with no run containers: chunks of more than 4,096 values are
    bitmap containers, the others array containers, empty chunks left
    out."""
    words = np.ascontiguousarray(words, dtype=np.uint64)
    cards = np.asarray(cards, dtype=np.int64)
    present = np.flatnonzero(cards)
    size = present.size
    header = [struct.pack("<II", SERIAL_COOKIE_NO_RUNCONTAINER, size)]
    desc = np.empty((size, 2), dtype="<u2")
    desc[:, 0] = present
    desc[:, 1] = cards[present] - 1
    payloads: List[bytes] = []
    for i in present.tolist():
        if cards[i] > ARRAY_MAX:
            payloads.append(words[i].astype("<u8").tobytes())
        else:
            bitsets = np.unpackbits(words[i].view(np.uint8), bitorder="little")
            payloads.append(np.flatnonzero(bitsets).astype("<u2").tobytes())
    start = 8 + 4 * size + 4 * size
    offsets = np.cumsum([0] + [len(p) for p in payloads[:-1]], dtype=np.int64) + start
    header.append(desc.tobytes())
    header.append(offsets.astype("<u4").tobytes())
    return b"".join(header + payloads)


def bitmap_of_range(n: int) -> bytes:
    """The bitmap of ``[0, n)``: one run container a chunk."""
    if n <= 0:
        return struct.pack("<II", SERIAL_COOKIE_NO_RUNCONTAINER, 0)
    size = -(-n // CHUNK)
    out = [struct.pack("<I", SERIAL_COOKIE | ((size - 1) << 16))]
    out.append(b"\xff" * (size // 8) + (bytes([(1 << (size % 8)) - 1]) if size % 8 else b""))
    lengths = [min(CHUNK, n - k * CHUNK) for k in range(size)]
    out.append(np.array([[k, ln - 1] for k, ln in enumerate(lengths)], dtype="<u2").tobytes())
    payloads = [struct.pack("<HHH", 1, 0, ln - 1) for ln in lengths]
    if size >= NO_OFFSET_THRESHOLD:
        start = 4 + len(out[1]) + 4 * size + 4 * size
        offsets = start + 6 * np.arange(size, dtype=np.int64)
        out.append(offsets.astype("<u4").tobytes())
    return b"".join(out + payloads)


def bsi_bytes(slice_rows: np.ndarray, slice_cards: np.ndarray, rows: int,
              min_value: int, max_value: int) -> bytes:
    """A bit-sliced index over the columns ``0 .. rows - 1`` in the
    ByteBuffer layout, from its slice rows (uint64 ``[S, K, 1024]``: bit i
    of each column's value) and their counts (``[S, K]``)."""
    parts = [
        struct.pack("<iib", _int32_bits(min_value), _int32_bits(max_value), 0),
        bitmap_of_range(rows),
        struct.pack("<i", slice_rows.shape[0]),
    ]
    parts.extend(bitmap_from_words(w, c) for w, c in zip(slice_rows, slice_cards))
    return b"".join(parts)


def read_words(data: bytes, chunks: int):
    """The bitmap in portable bytes ``data`` as (uint64 ``[chunks, 1024]``
    words of chunks ``0 .. chunks - 1``, the number of values it holds in
    later chunks). Array, bitmap and run containers, with or without the
    offset header."""
    buf = memoryview(data)
    cookie = struct.unpack_from("<I", buf, 0)[0]
    if cookie & 0xFFFF == SERIAL_COOKIE:
        size = (cookie >> 16) + 1
        flags = np.frombuffer(buf, dtype=np.uint8, count=(size + 7) // 8, offset=4)
        runs = np.unpackbits(flags, bitorder="little")[:size].astype(bool)
        pos = 4 + flags.size
        offsets = size >= NO_OFFSET_THRESHOLD
    elif cookie == SERIAL_COOKIE_NO_RUNCONTAINER:
        size = struct.unpack_from("<I", buf, 4)[0]
        runs = np.zeros(size, dtype=bool)
        pos = 8
        offsets = True
    else:
        raise ValueError(f"not a portable bitmap (cookie {cookie})")
    desc = np.frombuffer(buf, dtype="<u2", count=2 * size, offset=pos).reshape(size, 2)
    pos += 4 * size + (4 * size if offsets else 0)
    words = np.zeros((chunks, 1024), dtype=np.uint64)
    outside = 0
    for i in range(size):
        key, card = int(desc[i, 0]), int(desc[i, 1]) + 1
        if runs[i]:
            n_runs = struct.unpack_from("<H", buf, pos)[0]
            pairs = np.frombuffer(buf, dtype="<u2", count=2 * n_runs, offset=pos + 2)
            pos += 2 + 4 * n_runs
            bits = np.zeros(CHUNK, dtype=np.uint8)
            for start, length in pairs.reshape(n_runs, 2).tolist():
                bits[start: start + length + 1] = 1
            row = np.packbits(bits, bitorder="little").view(np.uint64)
        elif card > ARRAY_MAX:
            row = np.frombuffer(buf, dtype="<u8", count=1024, offset=pos)
            pos += 8192
        else:
            vals = np.frombuffer(buf, dtype="<u2", count=card, offset=pos)
            pos += 2 * card
            bits = np.zeros(CHUNK, dtype=np.uint8)
            bits[vals] = 1
            row = np.packbits(bits, bitorder="little").view(np.uint64)
        if key < chunks:
            words[key] = row
        else:
            outside += int(np.unpackbits(row.view(np.uint8)).sum())
    return words, outside
