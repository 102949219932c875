"""The frozen epoch artifact: a zero-copy mmap corpus format.

Counterpart of ``roaringbitmap_tpu/durable/format.py``; the same corpus
gives the same bytes in both packages. One file holds one epoch's whole
corpus. Per-bitmap payloads are the portable interoperable format
``serialization.py`` implements byte for byte, so a mapped corpus needs no
parse step: each slice feeds ``models/immutable.ImmutableRoaringBitmap``
directly, container payloads stay OS-paged views, and ``store.packed_for``
builds device payloads straight from the map.

Layout (all little-endian, the portable format's own byte order)::

    header   16 B   magic b"RBTD" | u16 version=1 | u16 flags=0
                    | u32 n_bitmaps | u32 reserved=0
    directory n*16 B per-bitmap {u64 offset, u64 length} — offset is
                    absolute in the file, 8-byte aligned
    payloads        portable serialize() bytes per bitmap, each padded
                    to the next 8-byte boundary

The 8-byte alignment matters: a bitmap container's 1024 ``<u8`` words must
be aligned for a zero-copy ``np.frombuffer`` view, and the payload's own
header fields are 2- and 4-byte, so aligning the payload start aligns
everything after it.

The directory doubles as the key directory: the corpus is an ordered list
(``serve/epochs.py``), so a bitmap's key is its corpus index. Integrity is
owned one level up — ``durable/store.py`` manifests the artifact with a
sha256 and recovery re-verifies before mapping — so this module validates
structure only (magic, version, extents), never content.
"""

from __future__ import annotations

import mmap as _mmap
import os
import struct
from typing import Dict, List, Sequence

from ..models.immutable import ImmutableRoaringBitmap
from ..serialization import InvalidRoaringFormat, serialize as _serialize

MAGIC = b"RBTD"
VERSION = 1
HEADER = struct.Struct("<4sHHII")  # magic, version, flags, n, reserved
DIRENT = struct.Struct("<QQ")  # absolute offset, payload length
ALIGN = 8


def _pad(n: int) -> int:
    return (-n) % ALIGN


def write_corpus(path: str, bitmaps: Sequence) -> dict:
    """Write one frozen corpus artifact to ``path`` (header + directory
    + aligned portable payloads), fsync it, and return its stats
    (``{"n", "payload_bytes", "artifact_bytes"}``). Accepts any mix of
    heap and mapped bitmaps — a mapped operand's ``serialize()`` is its
    backing slice, so re-persisting an unmodified mapped corpus never
    re-encodes payloads."""
    payloads: List[bytes] = []
    for bm in bitmaps:
        if isinstance(bm, (bytes, bytearray, memoryview)):
            # pre-serialized payload (durable/store.py snapshots the
            # corpus to bytes under a reader ticket, then writes here
            # OUTSIDE the ticket so disk I/O never delays a flip drain)
            payloads.append(bytes(bm))
        elif isinstance(bm, ImmutableRoaringBitmap):
            payloads.append(bm.serialize())
        else:
            payloads.append(_serialize(bm))
    n = len(payloads)
    directory = bytearray(DIRENT.size * n)
    offset = HEADER.size + len(directory)
    offset += _pad(offset)
    for i, p in enumerate(payloads):
        DIRENT.pack_into(directory, DIRENT.size * i, offset, len(p))
        offset += len(p) + _pad(len(p))
    with open(path, "wb") as f:
        f.write(HEADER.pack(MAGIC, VERSION, 0, n, 0))
        f.write(directory)
        pos = HEADER.size + len(directory)
        f.write(b"\x00" * _pad(pos))
        pos += _pad(pos)
        for p in payloads:
            f.write(p)
            pos += len(p)
            f.write(b"\x00" * _pad(len(p)))
            pos += _pad(len(p))
        f.flush()
        os.fsync(f.fileno())
    return {
        "n": n,
        "payload_bytes": sum(len(p) for p in payloads),
        "artifact_bytes": pos,
    }


class MappedCorpus:
    """A frozen epoch corpus served straight off its mmap.

    Construction validates structure only (O(n) directory scan, no
    payload reads); ``bitmap(i)`` lazily wraps slice *i* as a memoized
    :class:`ImmutableRoaringBitmap` whose container payloads are
    zero-copy views the OS pages in on demand. The mapped bitmaps carry
    ``("static", id)`` fingerprints, so ``packed_for``/``PACK_CACHE``
    admit them like any other operand — the warm-restart path packs
    device payloads directly from the map."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self._mm = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
        buf = memoryview(self._mm)
        if len(buf) < HEADER.size:
            raise InvalidRoaringFormat("truncated corpus header")
        magic, version, flags, n, _reserved = HEADER.unpack_from(buf, 0)
        if magic != MAGIC:
            raise InvalidRoaringFormat(f"bad corpus magic {magic!r}")
        if version != VERSION:
            raise InvalidRoaringFormat(f"unsupported corpus version {version}")
        if flags:
            raise InvalidRoaringFormat(f"unknown corpus flags {flags:#x}")
        end_dir = HEADER.size + DIRENT.size * n
        if end_dir > len(buf):
            raise InvalidRoaringFormat("truncated corpus directory")
        self._dir: List[tuple] = []
        for i in range(n):
            off, length = DIRENT.unpack_from(buf, HEADER.size + DIRENT.size * i)
            if off % ALIGN or off + length > len(buf) or off < end_dir:
                raise InvalidRoaringFormat(
                    f"corpus payload {i} out of bounds or unaligned"
                )
            self._dir.append((off, length))
        self._buf = buf
        self._cache: Dict[int, ImmutableRoaringBitmap] = {}
        self.artifact_bytes = len(buf)

    def __len__(self) -> int:
        return len(self._dir)

    def payload(self, i: int) -> memoryview:
        """Bitmap *i*'s portable-format bytes as a zero-copy view."""
        off, length = self._dir[i]
        return self._buf[off : off + length]

    def bitmap(self, i: int) -> ImmutableRoaringBitmap:
        bm = self._cache.get(i)
        if bm is None:
            off, _length = self._dir[i]
            # offset into the shared map (not the payload slice) keeps
            # every view anchored on one exported buffer
            bm = ImmutableRoaringBitmap(self._mm, offset=off)
            self._cache[i] = bm
        return bm

    def __getitem__(self, i: int) -> ImmutableRoaringBitmap:
        return self.bitmap(i)

    def bitmaps(self) -> List[ImmutableRoaringBitmap]:
        """All bitmaps, materialized (header parse only — payloads stay
        mapped). The warm-restart corpus handed to the epoch store."""
        return [self.bitmap(i) for i in range(len(self._dir))]

    def close(self) -> None:
        """Drop memoized views and close the map. Fails loudly
        (``BufferError``) while numpy views into the map are still
        alive elsewhere — a mapped corpus must outlive its consumers.
        The memoized bitmaps' container tables are reference cycles, so
        dropping the cache needs a collect before their exported
        buffers actually die; external holders still raise."""
        self._cache.clear()
        self._buf.release()
        try:
            self._mm.close()
        except BufferError:
            import gc

            gc.collect()
            self._mm.close()

    def __repr__(self):
        return (
            f"MappedCorpus(n={len(self._dir)}, "
            f"bytes={self.artifact_bytes}, path={self.path!r})"
        )
