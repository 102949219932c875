"""One N-way aggregation over every resident bitmap of an index:
``FastAggregation.<op>(*bitmaps)``, the op drawn by the mix's weights from
``or_`` (the union as a bitmap), ``or_cardinality`` and
``xor_cardinality``."""

from __future__ import annotations

import numpy as np
import torch

from .. import answers, bounds

OPS = ("or_", "or_cardinality", "xor_cardinality")


def prepare(dep, params):
    from roaringbitmap_tpu_torch import FastAggregation

    return FastAggregation, list(dep.bitmaps)


def draw(rng, dep, params):
    weights = np.array([float(params["ops"].get(op, 0.0)) for op in OPS])
    return OPS[int(rng.choice(len(OPS), p=weights / weights.sum()))]


def call(state, op):
    agg, bitmaps = state
    with torch.profiler.record_function(f"portbench.FastAggregation.{op}"):
        return getattr(agg, op)(*bitmaps)


def least_seconds(dep, params, op):
    return bounds.reduce_least_seconds(dep.containers, dep.groups)


def _answer(counts: torch.Tensor, op: str):
    if op == "or_":
        return answers.mask_words(counts > 0)
    if op == "or_cardinality":
        return int((counts > 0).sum())
    return int((counts & 1).sum())


def expected(dep, params, op):
    """Every request aggregates every bitmap: the three answers are worked
    out once."""
    if not hasattr(dep, "_wide_answers"):
        counts = dep.counts(range(dep.n))
        dep._wide_answers = {o: _answer(counts, o) for o in OPS}
    return dep._wide_answers[op]


def prepare_control(dep, params):
    """Every operand but the last: an aggregation that drops one of its
    10,000 operands breaks the exactness the index guarantees."""
    counts = dep.counts(range(dep.n - 1))
    return {op: _answer(counts, op) for op in OPS}


def control_call(ctrl, op):
    return ctrl[op]
