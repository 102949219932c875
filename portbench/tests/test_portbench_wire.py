"""The benchmark's wire writer: its bytes load through the port's
``deserialize`` to what the port's own constructors make."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import wire
from portbench.configs import bsi_column


def _words(values: np.ndarray, chunks: int):
    bits = np.zeros(chunks * 65536, dtype=np.uint8)
    bits[values] = 1
    words = np.packbits(bits, bitorder="little").view(np.uint64).reshape(chunks, 1024)
    return words, bits.reshape(chunks, 65536).sum(axis=1)


@pytest.mark.parametrize("n", [1, 4000, 5000, 65536, 200_000])
def test_a_bitmap_from_words_is_the_bitmap_of_its_values(n):
    from roaringbitmap_tpu_torch import RoaringBitmap

    rng = np.random.default_rng(n)
    values = np.unique(rng.integers(0, 4 * 65536, size=n))
    words, cards = _words(values, 4)
    got = RoaringBitmap.deserialize(wire.bitmap_from_words(words, cards))
    assert got == RoaringBitmap(values)
    assert np.array_equal(got.to_array(), values.astype(np.uint32))


@pytest.mark.parametrize("n", [0, 1, 65535, 65536, 65537, 3 * 65536 + 5, 9 * 65536])
def test_the_range_bitmap_holds_every_column(n):
    from roaringbitmap_tpu_torch import RoaringBitmap

    got = RoaringBitmap.deserialize(wire.bitmap_of_range(n))
    assert got.get_cardinality() == n
    assert got == RoaringBitmap.bitmap_of_range(0, n)


@pytest.mark.parametrize("top_bits", [32, 20])
def test_bsi_bytes_load_to_what_set_values_builds(top_bits):
    """Dense slices (bitmap containers), and with most values small the high
    slices sparse (array containers); min and max above 2^31 in the first
    case, which the format holds as negative Java ints."""
    from roaringbitmap_tpu_torch import RoaringBitmapSliceIndex

    rng = np.random.default_rng(top_bits)
    rows = 3 * 65536 + 77
    v = rng.integers(0, 1 << 12, size=rows, dtype=np.int64)
    big = rng.random(rows) < 0.02
    v[big] = rng.integers(0, 1 << top_bits, size=int(big.sum()))
    t = torch.from_numpy(v)
    words, cards = bsi_column.slice_rows(t, int(v.max()).bit_length())
    data = wire.bsi_bytes(words, cards, rows, int(v.min()), int(v.max()))
    got = RoaringBitmapSliceIndex.deserialize(data)
    want = RoaringBitmapSliceIndex()
    want.set_values((np.arange(rows), v))
    assert got == want
    assert (got.min_value, got.max_value) == (want.min_value, want.max_value)
    cols = np.arange(0, rows, 997)
    vals, exists = got.get_values(cols)
    assert exists.all() and np.array_equal(np.asarray(vals, dtype=np.int64), v[cols])


def test_the_drawn_column_loads_with_its_values():
    cfg = {"rows": 70_000, "value_bits": 32}
    dev = torch.device("cpu")
    drawn = bsi_column.draw(cfg, 2**40 + 3, dev)
    again = bsi_column.draw(cfg, 2**40 + 3, dev)
    assert np.array_equal(drawn[0], again[0])  # the seed fixes the column
    dep = bsi_column.load(cfg, drawn, dev)
    assert dep.index.bit_count() == dep.slices == 32 and dep.chunks == 2
    assert dep.index.get_cardinality() == 70_000
    vals, _ = dep.index.get_values(np.arange(0, 70_000, 101))
    assert np.array_equal(np.asarray(vals, dtype=np.int64), dep.values[::101].astype(np.int64))


@pytest.mark.parametrize("runs", [False, True])
def test_the_reader_reads_what_the_port_writes(runs):
    from roaringbitmap_tpu_torch import RoaringBitmap

    rng = np.random.default_rng(7)
    values = np.unique(np.r_[rng.integers(0, 65536, 100),  # array
                             rng.integers(65536, 131072, 30_000),  # bitmap
                             np.arange(200_000, 260_000),  # runs
                             np.arange(5 * 65536, 5 * 65536 + 3)])
    bm = RoaringBitmap(values)
    if runs:
        bm.run_optimize()
    words, outside = wire.read_words(bm.serialize(), 4)
    want, _ = _words(values[values < 4 * 65536], 4)
    assert np.array_equal(words, want) and outside == 3
