"""Memoizing plan executor.

Counterpart of ``roaringbitmap_tpu/query/exec.py``. Runs a
:class:`~.plan.Plan` bottom-up. Every interior step first consults the
result cache (cache.py) under ``(node uid, leaf fingerprints)``; a hit
short-circuits that whole subtree, so a repeated query over unchanged
bitmaps is a handful of dict probes, and a query sharing subtrees with a
previous one recomputes only the novel nodes. Leaf fingerprints are
snapshotted once per execution so all steps key against one consistent
view even if another thread mutates a bitmap mid-run. An identical node
computing in another query right now is joined through the in-flight
table (inflight.py) instead of being recomputed.

The returned bitmap is a private clone — callers may mutate it freely
without corrupting memoized results.

Plans are memoized too: planning reads leaf contents (constant folding,
cardinality estimates), so a plan is reusable exactly as long as the
result cache entries are — same (expression, leaf fingerprints, dispatch
knobs). A leaf mutation re-plans by key miss.

Below the result cache sits the resident pack cache
(``parallel/store.PACK_CACHE``): every device engine a step dispatches to
— FastAggregation and/or/xor, the n-way andnot batch, the bit-sliced
threshold — keys its packed working set by the same leaf fingerprints. A
repeated query whose result cache is off still packs nothing for its
steps over leaves: those packs come back resident, shared across the
query's own nodes and across queries over the same leaves, and a leaf
mutation delta-repacks O(changed containers) rows. A step whose operands
are results of other steps works on new bitmaps each run, so its pack is
built anew. Device steps run on ``aggregation.config.device``.

:func:`execute_pipelined` runs back-to-back queries with the overlap
shipping lane staging the next query's leaf packs while the current one
runs.

Instrumentation: every query runs under a trace scope and in one root
span, ``query.request``, so no host work of a request lies outside a
span. Below it, ``query.plan`` and ``query.execute`` are one span each
that also times into ``rb_tpu_query_latency_seconds{phase}``; inside the
executor each result-cache lookup is a ``query.cache.probe`` span, each
publication a ``query.cache.publish`` span, and each computed step a
``query.step`` span that resolves the step's ``query.plan`` decision with
its wall and result cardinality, so ``query.execute``'s self time is the
executor's own bookkeeping. A device step runs through the ``query.exec``
ladder site — the device tier alone, with the ``query.exec`` fault point,
so a device failure raises — and
``rb_tpu_deadline_total{site="query.exec",outcome}`` counts the deadline
outcomes.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Union

from .. import observe as _observe
from ..models.roaring import RoaringBitmap
from ..observe import context as _context
from ..observe import outcomes as _outcomes
from ..observe import spans as _spans
from ..observe import timeline as _timeline
from ..robust import faults as _faults
from ..robust import ladder as _ladder
from . import inflight as _inflight
from . import kernels
from .cache import DEFAULT_CACHE, ResultCache, cache_key, leaf_fps_current
from .expr import Expr
from .plan import Plan, PlanStep, _plan

# end-to-end query latency quantiles: p50/p99 per phase in every export
_QUERY_LATENCY = _observe.latency_histogram(
    _observe.QUERY_LATENCY_SECONDS,
    "End-to-end query latencies by phase (plan | execute)",
    ("phase",),
)

_PLAN_MEMO_MAX = 128
_PLAN_MEMO_LOCK = threading.Lock()
_PLAN_MEMO: "OrderedDict[tuple, Plan]" = OrderedDict()  # guarded-by: _PLAN_MEMO_LOCK


def _memo_plan(expr: Expr, mode: Optional[str]) -> Plan:
    from ..parallel import aggregation

    key = (
        expr.uid,
        mode,
        # the dispatch knobs _use_device consults: a changed regime must
        # not be served a plan built for the old one
        aggregation.config.mode,
        aggregation.config.min_device_containers,
        aggregation.config.mesh is None,
        tuple(l.fingerprint() for l in expr.leaves),
    )
    with _PLAN_MEMO_LOCK:
        p = _PLAN_MEMO.get(key)
        if p is not None:
            _PLAN_MEMO.move_to_end(key)
            return p
    # _plan, not plan(): plan() opens its own query.plan span, and the
    # memo's stage histogram has to time that same region once
    with _spans.span("query.plan", "query", _QUERY_LATENCY, ("plan",)):
        p = _plan(expr, mode)
    with _PLAN_MEMO_LOCK:
        _PLAN_MEMO[key] = p
        while len(_PLAN_MEMO) > _PLAN_MEMO_MAX:
            _PLAN_MEMO.popitem(last=False)
    return p


def execute(
    query: Union[Expr, Plan],
    cache: Optional[ResultCache] = DEFAULT_CACHE,
    mode: Optional[str] = None,
    deadline_s: Optional[float] = None,
) -> RoaringBitmap:
    """Plan (if given an expression) and evaluate, memoizing interior
    results in ``cache`` (pass ``cache=None`` to disable memoization;
    ``mode`` forwards to the planner's engine choice).

    ``deadline_s`` arms a per-query wall-clock budget: once it has run
    out, every remaining step is routed to its CPU tier before it runs.
    The result stays bit-exact (the tiers agree by construction); only
    the remaining steps' engine changes.
    ``rb_tpu_deadline_total{site="query.exec",outcome}`` counts the
    outcomes (met | degraded)."""
    # the whole plan + execute runs under one trace id (reused when a
    # pipelined entry point pre-assigned it), in one root span
    with _context.trace_scope(), _spans.span("query.request", "query"):
        return _execute_traced(query, cache, mode, deadline_s).clone()


def _execute_traced(query, cache, mode, deadline_s) -> RoaringBitmap:
    """The plan's result, the cache's or ``results``' own object: the
    caller clones it."""
    p = query if isinstance(query, Plan) else _memo_plan(query, mode)
    degraded = False
    with _spans.span(
        "query.execute", "query", _QUERY_LATENCY, ("execute",), steps=len(p.steps),
    ), _ladder.deadline_scope(deadline_s):
        leaf_fps = {l.uid: l.fingerprint() for l in p.root.leaves}
        results: Dict[int, RoaringBitmap] = {l.uid: l.bitmap for l in p.root.leaves}
        for step in p.steps:
            entry = None
            if cache is not None:
                with _spans.span("query.cache.probe", "query"):
                    key, found, entry = _probe(cache, step, leaf_fps)
                if found is not None:
                    results[step.node.uid] = found
                    continue
            inputs = [results[o.uid] for o in step.operands]
            force_cpu = _ladder.deadline_expired()
            if force_cpu and not degraded:
                degraded = True
                _timeline.instant("query.deadline_degrade", "query", engine=step.engine)
            seq = step.decision_seq
            t0 = time.perf_counter() if seq is not None else 0.0
            try:
                with _spans.span(
                    "query.step", "query", engine=step.engine, op=step.node.op,
                    decision=seq,
                ):
                    val = _run_step(step, inputs, force_cpu=force_cpu)
            except BaseException:
                if entry is not None:  # joiners recompute on their own
                    _inflight.TABLE.abort(key, entry)
                raise
            if seq is not None:
                # resolve the planner decision ONCE: the measured step wall
                # and the result's cardinality against the estimate
                step.decision_seq = None
                _outcomes.resolve(
                    seq, "query.plan", time.perf_counter() - t0,
                    engine=step.engine, actual=max(1, val.get_cardinality()),
                )
            if cache is not None:
                with _spans.span("query.cache.publish", "query"):
                    # validated publication: a leaf mutated mid-computation
                    # makes this value match neither the key's snapshot nor
                    # the new contents — joiners get None (recompute fresh)
                    # and the cache never stores it
                    valid = leaf_fps_current(step.node, leaf_fps)
                    if entry is not None:
                        _inflight.TABLE.complete(key, entry, val, valid)
                    if valid:
                        cache.put(key, val)
            results[step.node.uid] = val
        if deadline_s is not None:
            _ladder.note_deadline("query.exec", "degraded" if degraded else "met")
        return results[p.root.uid]


def _probe(cache: ResultCache, step: PlanStep, leaf_fps):
    """Look ``step`` up: ``(key, result or None, in-flight entry or None)``.
    A hit comes from the cache, or from an identical node computing in
    ANOTHER query right now, joined instead of recomputed; a miss claims
    the key (the entry) unless the join came back None (stale / owner
    failed / timeout), which computes unclaimed."""
    key = cache_key(step.node, leaf_fps)
    hit = cache.get(key)
    if hit is not None:
        _timeline.instant("query.cache_hit", "query", op=step.node.op)
        return key, hit, None
    owner, pending = _inflight.TABLE.begin(key)
    if owner:
        return key, None, pending
    joined = _inflight.TABLE.join(pending)
    if joined is not None:
        _timeline.instant("query.inflight_join", "query", op=step.node.op)
    return key, joined, None


def execute_pipelined(
    queries: Sequence[Union[Expr, Plan]],
    cache: Optional[ResultCache] = DEFAULT_CACHE,
    mode: Optional[str] = None,
    deadline_s: Optional[float] = None,
) -> List[RoaringBitmap]:
    """Execute back-to-back queries with the overlap shipping lane
    (``parallel/overlap.py``): while query i runs, query i+1's
    device-routed leaf working sets stage on the lane, so steady
    multi-query traffic does not idle the device on the marshal. Results
    are identical to ``[execute(q, ...) for q in queries]`` — staging only
    warms the resident pack cache the engines read anyway.

    Every query gets its own pre-assigned trace id; query i+1's prefetch
    runs under query i+1's id though query i's iteration drives it."""
    plans = [q if isinstance(q, Plan) else _memo_plan(q, mode) for q in queries]
    tids = [_context.new_trace_id() for _ in plans]
    out = []
    for i, p in enumerate(plans):
        # join our own stagings FIRST (prefetched while query i-1 ran):
        # popping them frees the lane window for the next prefetch
        with _context.trace_scope(tids[i]):
            _join_plan(p)
        if i + 1 < len(plans):
            with _context.trace_scope(tids[i + 1]):
                _prefetch_plan(plans[i + 1], mode)
        with _context.trace_scope(tids[i]):
            out.append(execute(p, cache=cache, mode=mode, deadline_s=deadline_s))
    return out


def _device_step_leaves(p: Plan):
    """Yield ``(leaves, op)`` for the plan's device-routed all-leaf steps —
    device-* n-ary and/or/xor only: the threshold kernel keys its packs
    differently (kind-prefixed ``get_or_build`` keys) and the andnot
    kernel packs its subtrahends without the minuend, so staging a pack of
    either step's operands would be waste. The
    ``-sharded`` steps are collective calls over the mesh, which the lane
    does not stage for, as in the JAX package."""
    for step in p.steps:
        if not step.engine.startswith("device-") or step.engine.endswith("-sharded"):
            continue
        leaves = [getattr(o, "bitmap", None) for o in step.operands]
        if len(leaves) >= 2 and all(b is not None for b in leaves):
            yield leaves, step.node.op


def _prefetch_plan(p: Plan, mode: Optional[str]) -> None:
    """Stage the plan's device-routed all-leaf steps on the overlap lane
    (``aggregation.prefetch`` re-checks the device gate, so a step the
    executor would run on the CPU stages nothing)."""
    from ..parallel import aggregation

    for leaves, op in _device_step_leaves(p):
        aggregation.prefetch(leaves, op, mode=mode)


def _join_plan(p: Plan) -> None:
    """Pop the plan's stagings off the overlap lane (a no-op for steps
    that never staged); the packs are in ``PACK_CACHE``, so only the
    window slot and the overlap accounting ride on the join."""
    from ..parallel import overlap

    for leaves, op in _device_step_leaves(p):
        overlap.LANE.join(leaves, op)


def _run_step(
    step: PlanStep, inputs: List[RoaringBitmap], force_cpu: bool = False
) -> RoaringBitmap:
    from ..parallel.aggregation import FastAggregation as FA

    eng, op = step.engine, step.node.op
    if eng == "pairwise":
        fn = {
            "and": RoaringBitmap.and_,
            "or": RoaringBitmap.or_,
            "xor": RoaringBitmap.xor,
            "andnot": RoaringBitmap.andnot,
        }[op]
        return fn(inputs[0], inputs[1])
    if eng.startswith("device-"):
        fn = {"and": FA.and_, "or": FA.or_, "xor": FA.xor}[op]
        if force_cpu:  # deadline run out: the CPU tier, chosen before the step
            return fn(*inputs, mode="cpu")

        def _device_step():
            _faults.fault_point("query.exec")
            return fn(*inputs, mode="device")

        # the device tier alone: a device failure raises
        return _ladder.LADDER.run("query.exec", [("device", _device_step)])
    if eng == "workshy-and":
        return FA.and_(*inputs, mode="cpu")
    if eng == "naive-or":
        return FA.naive_or(*inputs)
    if eng == "horizontal-or":
        return FA.horizontal_or(*inputs)
    if eng == "naive-xor":
        return FA.naive_xor(*inputs)
    if eng == "horizontal-xor":
        return FA.horizontal_xor(*inputs)
    mode = "device" if eng.endswith("[device]") and not force_cpu else "cpu"
    if eng.startswith("andnot-batch"):
        return kernels.andnot_nway(inputs[0], *inputs[1:], mode=mode)
    if eng.startswith("threshold-bitsliced"):
        return kernels.threshold(step.node.k, inputs, mode=mode)
    raise ValueError(f"unknown engine {eng!r}")  # pragma: no cover
