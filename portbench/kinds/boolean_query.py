"""A planned boolean query through the port's query tier, shaped as the
repo's Q1: ``(or(A) & or(B)) \\ or(C) | threshold(k, head)``.

A, B and C are three distinct groups of consecutive bitmaps, drawn by a
Zipf law over the groups' ranks, so popular groups repeat as they do in a
query log; ``head`` is a few bitmaps drawn uniformly. Calls go through
``query.execute`` with its default result cache. The group unions are
built once, as a serving process holds its named filters, and set-up
evaluates each once."""

from __future__ import annotations

import numpy as np
import torch

from .. import answers


def _groups(dep, params):
    size = int(params["group_size"])
    n = int(params["groups"])
    if n * size > dep.n:
        raise ValueError(f"{n} groups of {size} need more than {dep.n} bitmaps")
    return [list(range(g * size, (g + 1) * size)) for g in range(n)]


def prepare(dep, params):
    from roaringbitmap_tpu_torch import query
    from roaringbitmap_tpu_torch.query import Q

    leaves = [Q.leaf(b) for b in dep.bitmaps]
    unions = [Q.or_(*[leaves[i] for i in g]) for g in _groups(dep, params)]
    for u in unions:
        query.execute(u)
    return query.execute, Q, leaves, unions, int(params["k"])


def draw(rng, dep, params):
    n = int(params["groups"])
    weights = np.arange(1, n + 1, dtype=np.float64) ** -float(params["zipf_s"])
    abc = rng.choice(n, size=3, replace=False, p=weights / weights.sum())
    head = rng.choice(dep.n, size=int(params["head"]), replace=False)
    return tuple(int(g) for g in abc), tuple(int(i) for i in head)


def call(state, request):
    execute, Q, leaves, unions, k = state
    (a, b, c), head = request
    expr = (unions[a] & unions[b]) - unions[c] | Q.threshold(k, *[leaves[i] for i in head])
    with torch.profiler.record_function("portbench.query.execute"):
        return execute(expr)


def least_seconds(dep, params, request):
    return None


def _answer(dep, params, request, drop_last_of_c: bool = False):
    groups = _groups(dep, params)
    (a, b, c), head = request
    c_members = groups[c][:-1] if drop_last_of_c else groups[c]
    hit = (dep.counts(groups[a]) > 0) & (dep.counts(groups[b]) > 0)
    hit &= dep.counts(c_members) == 0
    hit |= dep.counts(head) >= int(params["k"])
    return answers.mask_words(hit)


def expected(dep, params, request):
    return _answer(dep, params, request)


def prepare_control(dep, params):
    """The reference with the last bitmap of C left out of its union: an
    operand dropped breaks the exactness the index guarantees."""
    return dep, params


def control_call(ctrl, request):
    dep, params = ctrl
    return _answer(dep, params, request, drop_last_of_c=True)
