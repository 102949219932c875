"""With the timed path broken underneath, a run comes out not correct: one
tiny CPU run for each fault a cell can have (an operand group or half the
batch left out, an answer altered where the port produces it, a request
that raises)."""

from __future__ import annotations

import numpy as np
import pytest

from portbench.tests.helpers import tiny_run


def _agg_half(orig):
    def broken(*bitmaps, **kw):
        return orig(*bitmaps[: max(1, len(bitmaps) // 2)], **kw)
    return staticmethod(broken)


def _plus_one(orig):
    def broken(*a, **kw):
        return orig(*a, **kw) + 1
    return broken


def test_wide_aggregation_over_half_of_the_operands(monkeypatch):
    from roaringbitmap_tpu_torch import FastAggregation

    for op in ("or_", "or_cardinality", "xor_cardinality"):
        monkeypatch.setattr(FastAggregation, op, _agg_half(getattr(FastAggregation, op)))
    res, _ = tiny_run("runs10k-wideagg", seconds=1.0)
    assert not res["correct"]


def test_a_count_altered_in_the_group_reduce(monkeypatch):
    from roaringbitmap_tpu_torch.parallel import store

    monkeypatch.setattr(store, "reduce_packed_cardinality",
                        _plus_one(store.reduce_packed_cardinality))
    res, _ = tiny_run("runs10k-wideagg", seconds=1.0, mix={"params": {"ops": {
        "or_cardinality": 1, "xor_cardinality": 1}}})
    assert not res["correct"]


def test_a_value_altered_in_the_unpack(monkeypatch):
    from roaringbitmap_tpu_torch.parallel import store

    orig = store.unpack_to_bitmap

    def broken(keys, words, cards):
        words = np.array(words, copy=True)
        words[0, 0] ^= np.uint32(1)
        return orig(keys, words, cards)

    monkeypatch.setattr(store, "unpack_to_bitmap", broken)
    for cell in ("runs10k-wideagg", "bsi100m-filter"):
        res, _ = tiny_run(cell, seconds=1.0)
        assert not res["correct"], cell


def test_a_histogram_over_half_of_its_thresholds(monkeypatch):
    from roaringbitmap_tpu_torch import RoaringBitmapSliceIndex

    orig = RoaringBitmapSliceIndex.compare_cardinality_many

    def broken(self, op, values, *a, **kw):
        half = len(values) // 2
        out = np.zeros(len(values), dtype=np.int64)
        out[:half] = orig(self, op, values[:half], *a, **kw)
        return out

    monkeypatch.setattr(RoaringBitmapSliceIndex, "compare_cardinality_many", broken)
    res, _ = tiny_run("bsi100m-histogram", seconds=1.5)
    assert not res["correct"]


def test_a_histogram_count_altered_in_the_kernel(monkeypatch):
    from roaringbitmap_tpu_torch.ops import kernels

    orig = kernels.oneil_compare

    def broken(*a, **kw):
        out, cards = orig(*a, **kw)
        cards = cards.clone()
        cards[0, 0] += 1
        return out, cards

    monkeypatch.setattr(kernels, "oneil_compare", broken)
    res, _ = tiny_run("bsi100m-histogram", seconds=1.5)
    assert not res["correct"]


def test_a_filter_over_half_of_the_chunks(monkeypatch):
    from roaringbitmap_tpu_torch.parallel import store

    orig = store.unpack_to_bitmap

    def broken(keys, words, cards):
        half = len(keys) // 2
        return orig(keys[:half], words[:half], cards[:half])

    monkeypatch.setattr(store, "unpack_to_bitmap", broken)
    res, _ = tiny_run("bsi100m-filter", seconds=1.0)
    assert not res["correct"]


def test_a_query_answer_altered_where_it_is_produced(monkeypatch):
    from roaringbitmap_tpu_torch import query

    orig = query.execute

    def broken(expr, *a, **kw):
        out = orig(expr, *a, **kw)
        out.add(2_001_999)
        return out

    monkeypatch.setattr(query, "execute", broken)
    res, _ = tiny_run("runs10k-query", seconds=1.5)
    assert not res["correct"]


def test_a_query_over_half_of_its_head(monkeypatch):
    from roaringbitmap_tpu_torch.query import Q

    orig = Q.threshold

    def broken(k, *xs):
        return orig(k, *xs[: len(xs) // 2])

    monkeypatch.setattr(Q, "threshold", staticmethod(broken))
    res, _ = tiny_run("runs10k-query", seconds=1.5)
    assert not res["correct"]


@pytest.mark.parametrize("cell", ["runs10k-wideagg", "bsi100m-filter"])
def test_a_request_that_raises_fails_the_run(monkeypatch, cell):
    from portbench import loop

    calls = {"n": 0}
    orig = loop.run

    def run(*a, **kw):
        if kw.get("seconds") is None:
            return orig(*a, **kw)
        call = a[4]

        def sometimes(req):
            calls["n"] += 1
            if calls["n"] == 3:
                raise RuntimeError("planted")
            return call(req)
        return orig(*a[:4], sometimes, *a[5:], **kw)

    monkeypatch.setattr(loop, "run", run)
    res, lines = tiny_run(cell, seconds=1.0)
    assert res["failed"] >= 1 and not res["correct"]
    assert any("planted" in line for line in lines)
