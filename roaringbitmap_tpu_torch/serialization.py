"""RoaringFormatSpec serialization — the portable wire/checkpoint format.

Byte-exact implementation of the reference's portable format
(RoaringArray.serialize, RoaringArray.java:851-940; spec README.md:47):

* cookie ``12347`` (``SERIAL_COOKIE``, RoaringArray.java:23) packed with
  ``size-1`` in the high 16 bits when any run container is present, followed
  by a run-marker bitset of ``ceil(size/8)`` bytes;
* cookie ``12346`` (``SERIAL_COOKIE_NO_RUNCONTAINER``) + 4-byte size
  otherwise;
* descriptive header: per container ``uint16 key, uint16 cardinality-1``;
* offset header (4-byte absolute offsets): always present without runs;
  with runs only when ``size >= NO_OFFSET_THRESHOLD`` (=4,
  RoaringArray.java:25);
* payloads in key order: sorted ``uint16`` values (array), 1024 ``uint64``
  words (bitmap), or ``uint16 n_runs`` + (start, length) pairs (run).
  Non-run containers with cardinality > 4096 are bitmaps — the same rule
  readers use to pick the decoder.

All integers little-endian. Untrusted input is validated the way the
reference's cookie checks are (InvalidRoaringFormat, RoaringArray.java:276+),
exercised against the reference's ``crashproneinput*.bin`` corpus.

This format is also the bridge between this package and its JAX reference:
both write the same bytes for the same bitmap.

Bytes produced by :func:`serialize` and consumed by :func:`read_into` are
counted by direction in ``rb_tpu_serial_bytes_total{direction}``
(``serialize`` | ``deserialize``), at the JAX package's places.
"""

from __future__ import annotations

import struct
import sys
from typing import Union

import numpy as np

from . import observe as _observe
from .utils import bits as _bits
from .models.container import (
    ARRAY_MAX_SIZE,
    ArrayContainer,
    BitmapContainer,
    Container,
    RunContainer,
)
from .models.roaring import RoaringBitmap

SERIAL_COOKIE = 12347  # RoaringArray.java:23
SERIAL_COOKIE_NO_RUNCONTAINER = 12346  # RoaringArray.java:24
NO_OFFSET_THRESHOLD = 4  # RoaringArray.java:25
_MAX_CONTAINERS = 1 << 16

# wire-format byte accounting: bytes produced by serialize and consumed by
# the parsers, by direction — the checkpoint/interop traffic ledger beside
# the store's host-to-device one
_SERIAL_BYTES = _observe.counter(
    _observe.SERIAL_BYTES_TOTAL,
    "RoaringFormatSpec bytes by direction (serialize | deserialize)",
    ("direction",),
)


class InvalidRoaringFormat(ValueError):
    """Raised on malformed serialized input (InvalidRoaringFormat.java)."""


def _container_payload(c: Container) -> bytes:
    # Payload kind follows the spec's reader rule (run marker, else
    # cardinality > 4096 -> bitmap, else array) — independent of the
    # in-memory class, so low-cardinality BitmapContainers round-trip.
    if isinstance(c, RunContainer):
        n = c.num_runs()
        out = struct.pack("<H", n)
        if n:
            pairs = np.empty(2 * n, dtype=np.uint16)
            pairs[0::2] = c.starts
            pairs[1::2] = c.lengths
            out += pairs.astype("<u2").tobytes()
        return out
    if c.cardinality > ARRAY_MAX_SIZE:
        if isinstance(c, BitmapContainer):
            return c.words.astype("<u8").tobytes()
        return c.to_words().astype("<u8").tobytes()
    return c.to_array().astype("<u2").tobytes()


def _payload_size(c: Container) -> int:
    if isinstance(c, RunContainer):
        return 2 + 4 * c.num_runs()
    if c.cardinality > ARRAY_MAX_SIZE:
        return 8192
    return 2 * c.cardinality


def serialized_size_in_bytes(bm: RoaringBitmap) -> int:
    """Size of serialize(bm) without materializing it
    (RoaringBitmap.serializedSizeInBytes)."""
    hlc = bm.high_low_container
    size = hlc.size
    has_run = any(isinstance(c, RunContainer) for c in hlc.containers)
    if has_run:
        total = 4 + (size + 7) // 8 + 4 * size
        if size >= NO_OFFSET_THRESHOLD:
            total += 4 * size
    else:
        total = 8 + 4 * size + 4 * size
    return total + sum(_payload_size(c) for c in hlc.containers)


def serialize(bm: RoaringBitmap) -> bytes:
    """Portable serialization (RoaringArray.serialize, RoaringArray.java:851-887)."""
    hlc = bm.high_low_container
    size = hlc.size
    containers = hlc.containers
    keys = hlc.keys
    has_run = any(isinstance(c, RunContainer) for c in containers)

    parts = []
    if has_run:
        parts.append(struct.pack("<I", SERIAL_COOKIE | ((size - 1) << 16)))
        marker = bytearray((size + 7) // 8)
        for i, c in enumerate(containers):
            if isinstance(c, RunContainer):
                marker[i // 8] |= 1 << (i % 8)
        parts.append(bytes(marker))
        header_size = 4 + len(marker) + 4 * size
        include_offsets = size >= NO_OFFSET_THRESHOLD
        if include_offsets:
            header_size += 4 * size
    else:
        parts.append(struct.pack("<II", SERIAL_COOKIE_NO_RUNCONTAINER, size))
        header_size = 8 + 4 * size + 4 * size
        include_offsets = True

    desc = np.empty(2 * size, dtype="<u2")
    for i, (k, c) in enumerate(zip(keys, containers)):
        desc[2 * i] = k
        desc[2 * i + 1] = c.cardinality - 1
    parts.append(desc.tobytes())

    if include_offsets:
        offsets = np.empty(size, dtype="<u4")
        pos = header_size
        for i, c in enumerate(containers):
            offsets[i] = pos
            pos += _payload_size(c)
        parts.append(offsets.tobytes())

    for c in containers:
        parts.append(_container_payload(c))
    out = b"".join(parts)
    _SERIAL_BYTES.inc(len(out), ("serialize",))
    return out


def _need(buf: memoryview, pos: int, n: int) -> None:
    if pos + n > len(buf):
        raise InvalidRoaringFormat(
            f"truncated input: need {n} bytes at offset {pos}, have {len(buf) - pos}"
        )


def deserialize(
    data: Union[bytes, bytearray, memoryview, np.ndarray], copy: bool = True
) -> RoaringBitmap:
    """Parse the portable format (RoaringArray.deserialize,
    RoaringArray.java:276/361/547), validating untrusted input.

    ``copy=False`` keeps container payloads as zero-copy views into
    ``data`` (see :func:`read_into`) — the mmap consumers' contract."""
    bm = RoaringBitmap()
    read_into(bm, data, copy=copy)
    return bm


def read_exact(stream, n: int) -> bytes:
    """Read exactly ``n`` bytes from a binary file-like object, looping
    over short reads: unbuffered sources (raw sockets/pipes) may legally
    return fewer than n bytes per read; only b"" means EOF (the io
    contract). Shared by every stream deserializer — a single bare
    ``read(n)`` would spuriously report truncation mid-packet."""
    parts = []
    got = 0
    while got < n:
        b = stream.read(n - got)
        if b is None:  # non-blocking source with no data YET — not EOF
            raise BlockingIOError(
                "deserialize_from needs a blocking stream (read returned None)"
            )
        if not b:
            raise InvalidRoaringFormat(f"truncated stream: wanted {n} bytes, got {got}")
        parts.append(b)
        got += len(b)
    return b"".join(parts) if len(parts) != 1 else parts[0]


def read_from_stream(bm: RoaringBitmap, stream) -> int:
    """Fill ``bm`` from a binary file-like object, consuming EXACTLY one
    serialized bitmap with forward-only reads (works on sockets/pipes; no
    seek). The wire format's own descriptors bound every read: cookie ->
    container count + run marker -> per-container cardinalities -> payload
    sizes. Bytes are then re-validated through read_into. Returns bytes
    consumed."""

    def need(n: int) -> bytes:
        return read_exact(stream, n)

    head = need(4)
    (cookie,) = struct.unpack("<I", head)
    chunks = [head]
    if (cookie & 0xFFFF) == SERIAL_COOKIE:
        size = (cookie >> 16) + 1
        marker = need((size + 7) // 8)
        chunks.append(marker)
        has_run = True
    elif cookie == SERIAL_COOKIE_NO_RUNCONTAINER:
        b = need(4)
        chunks.append(b)
        (size,) = struct.unpack("<I", b)
        has_run = False
        marker = b""
    else:
        raise InvalidRoaringFormat(f"invalid cookie {cookie}")
    if size > _MAX_CONTAINERS:
        raise InvalidRoaringFormat(f"container count {size} exceeds 65536")
    desc = need(4 * size)
    chunks.append(desc)
    cards = np.frombuffer(desc, dtype="<u2")[1::2].astype(np.int64) + 1
    if (not has_run) or size >= NO_OFFSET_THRESHOLD:
        chunks.append(need(4 * size))  # offset table
    for i in range(size):
        if has_run and marker[i // 8] & (1 << (i % 8)):
            nb = need(2)
            chunks.append(nb)
            (n_runs,) = struct.unpack("<H", nb)
            chunks.append(need(4 * n_runs))
        elif cards[i] > ARRAY_MAX_SIZE:
            chunks.append(need(8192))
        else:
            chunks.append(need(2 * int(cards[i])))
    return read_into(bm, b"".join(chunks))


def read_into(bm: RoaringBitmap, data, copy: bool = True) -> int:
    """Fill ``bm`` from serialized bytes; returns bytes consumed.

    ``copy=False`` builds the containers as
    **zero-copy views** into ``data`` — the ``np.frombuffer(...).astype``
    default path silently copies every payload (astype always
    materializes), which defeats serving straight off an mmap. The view
    path accepts read-only buffers (an ``mmap.ACCESS_READ`` map, a bytes
    object) and produces read-only numpy arrays, so it is an explicit
    opt-in for FROZEN consumers: mutating a container built this way (e.g.
    ``BitmapContainer.add`` patches ``words`` in place) raises numpy's
    read-only error instead of corrupting the backing file. Big-endian
    hosts fall back to copying — a byte-swapped view would feed the
    container kernels non-native dtypes."""
    if copy or sys.byteorder != "little":
        copy = True
    if isinstance(data, np.ndarray):
        # tobytes() copies even when the array is already contiguous
        # bytes; the view path wraps the existing buffer
        if copy:
            data = data.tobytes()
        else:
            data = data.data if data.flags["C_CONTIGUOUS"] else data.tobytes()
    buf = memoryview(data).cast("B")
    pos = 0
    _need(buf, pos, 4)
    (cookie,) = struct.unpack_from("<I", buf, pos)
    pos += 4

    if (cookie & 0xFFFF) == SERIAL_COOKIE:
        size = (cookie >> 16) + 1
        has_run = True
        _need(buf, pos, (size + 7) // 8)
        run_marker = bytes(buf[pos : pos + (size + 7) // 8])
        pos += (size + 7) // 8
    elif cookie == SERIAL_COOKIE_NO_RUNCONTAINER:
        _need(buf, pos, 4)
        (size,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        has_run = False
        run_marker = b""
    else:
        raise InvalidRoaringFormat(f"invalid cookie {cookie}")

    if size > _MAX_CONTAINERS:
        raise InvalidRoaringFormat(f"container count {size} exceeds 65536")

    _need(buf, pos, 4 * size)
    desc = np.frombuffer(buf, dtype="<u2", count=2 * size, offset=pos)
    pos += 4 * size
    keys = desc[0::2].astype(np.int64)
    cards = desc[1::2].astype(np.int64) + 1
    if size and np.any(np.diff(keys) <= 0):
        raise InvalidRoaringFormat("container keys not strictly increasing")

    include_offsets = (not has_run) or size >= NO_OFFSET_THRESHOLD
    if include_offsets:
        _need(buf, pos, 4 * size)
        pos += 4 * size  # offsets are redundant for sequential parse

    hlc = bm.high_low_container
    hlc.keys = []
    hlc.containers = []
    # this refill path rebinds the lists directly (bypassing the mutator
    # methods), so record a wholesale mutation — a stale fingerprint here
    # would let a cache keyed on it serve pre-deserialize contents
    hlc.mark_all_dirty()
    for i in range(size):
        key = int(keys[i])
        card = int(cards[i])
        is_run = has_run and bool(run_marker[i // 8] & (1 << (i % 8)))
        if is_run:
            _need(buf, pos, 2)
            (n_runs,) = struct.unpack_from("<H", buf, pos)
            pos += 2
            _need(buf, pos, 4 * n_runs)
            pairs = np.frombuffer(buf, dtype="<u2", count=2 * n_runs, offset=pos)
            if copy:
                pairs = pairs.astype(np.uint16)
            pos += 4 * n_runs
            starts, lengths = pairs[0::2], pairs[1::2]
            if n_runs and not _bits.validate_runs_u16(pairs):
                # overlapping/touching runs, or an end past the universe
                raise InvalidRoaringFormat("invalid run container")
            c: Container = RunContainer(starts, lengths)
        elif card > ARRAY_MAX_SIZE:
            _need(buf, pos, 8192)
            words = np.frombuffer(buf, dtype="<u8", count=1024, offset=pos)
            if copy:
                words = words.astype(np.uint64)
            pos += 8192
            actual = _bits.cardinality_of_words(words)
            if actual != card:
                raise InvalidRoaringFormat(
                    f"bitmap container cardinality {card} != popcount {actual}"
                )
            c = BitmapContainer(words, card)
        else:
            _need(buf, pos, 2 * card)
            values = np.frombuffer(buf, dtype="<u2", count=card, offset=pos)
            if copy:
                values = values.astype(np.uint16)
            pos += 2 * card
            if card > 1 and not _bits.validate_sorted_u16(values):
                raise InvalidRoaringFormat("array container values not sorted/unique")
            c = ArrayContainer(values)
        hlc.keys.append(key)
        hlc.containers.append(c)
    _SERIAL_BYTES.inc(pos, ("deserialize",))
    return pos


def maximum_serialized_size(cardinality: int, universe_size: int) -> int:
    """Upper bound on serialized size for any bitmap of the given cardinality
    over [0, universe_size) (RoaringBitmap.maximumSerializedSize,
    RoaringBitmap.java:3030; closed form README.md:486-496)."""
    cardinality = int(cardinality)
    universe_size = int(universe_size)
    contnbr = (universe_size + 65535) // 65536
    if contnbr > cardinality:
        contnbr = cardinality
        # we cannot have more containers than values
    headermax = max(8, 4 + (contnbr + 7) // 8) + 8 * contnbr
    valsarray = 2 * cardinality
    valsbitmap = contnbr * 8192
    return headermax + min(valsarray, valsbitmap)
