"""Cross-query fusion: the micro-batching executor.

Counterpart of ``roaringbitmap_tpu/query/fusion.py``. A window of
concurrent queries coalesces into merged per-tier dispatches instead of
executing one query, one node, one dispatch at a time.

**The pipeline per drained window:**

1. **Plan + dedup.** Every query plans through the shared memo
   (``exec._memo_plan``); the hash-consed DAG makes shared subexpressions
   across queries the SAME node by construction, so the window's step set
   dedups on node uid — the hot ``A & B`` under many user predicates is
   one step. Leaf fingerprints snapshot once for the whole window, and
   every computed node publishes through the result cache and the
   in-flight table (``inflight.py``) under validated fingerprints, so the
   dedup also reaches queries outside the window.

2. **Tier merge.** Unique steps level by topological depth, then group by
   merge class; each merged group executes as ONE dispatch:

   ========================= ============================================
   merge class               fused execution
   ========================= ============================================
   pairwise and/or/xor/      ``columnar.pairwise_multi`` — every pair's
   andnot                    matched containers in one per-class batch;
                             on the device tier one ``rb_pair_rows``
                             launch over the concatenated resident rows
   or/xor CPU folds          ``columnar.fold_multi`` — all working sets
                             in one multi-band pass
   n-way ANDNOT (CPU)        one ``or_fold_words`` call unions EVERY
                             query's subtrahend groups (keys namespaced
                             per query), then per-query word folds
   n-way ANDNOT (device)     per-query union reduce (``rb_group_reduce``),
                             then ONE ``rb_pair_rows`` andnot launch over
                             the concatenated ``[G, 2048]`` blocks
   Threshold(k) (device)     same-(k, slices, M) blocks concatenate along
                             G into one ``rb_threshold`` launch
   workshy-and / threshold   solo (no batched band to merge; the n-ary
   CPU / device-* n-ary      reduces amortize their own working set)
   ========================= ============================================

   Merged results are bit-exact with per-query execution by
   construction: every fused path feeds the same partition and the same
   assembly helpers as its solo twin.

3. **Priced verdict.** Each window prices batch against solo with the
   fusion-batch authority (``cost/fusion.py``) and runs fused or serial.
   The fused attempt has no degradation: a failure inside a merged tier
   (a kernel, the device) raises out of :func:`execute_fused`, after
   aborting every in-flight claim the window holds.

``STEP_COUNTS`` counts the window's step fates: ``executed`` (unique
steps the cache could not serve), ``deduped`` (steps shared across the
window's queries) and ``merged`` (steps that rode a merged dispatch).

**Windowing:** :func:`execute_fused` is the synchronous batch entry;
:class:`FusionExecutor` is the serving shape — ``submit()`` returns a
future, a drain loop coalesces up to ``RB_TPU_FUSION_WINDOW`` queries
(default 8) or whatever arrived within ``RB_TPU_FUSION_LATENCY_MS``
(default 2 ms), closed earlier by a member's ``slack_ms``.
``RB_TPU_FUSION=off`` (or ``configure(enabled=False)``) reduces
:func:`execute_fused` to the plain serial loop.

Left out here, relative to the JAX package: the observability counters
and decision record, the ``query.fusion`` ladder (the port raises), the
hedged solo dispatch, tenant budgets and the window autotune (they need
the serving tier).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..cost import fusion as _fusion_cost
from ..models.roaring import RoaringBitmap
from ..robust.ladder import deadline_expired, deadline_scope
from . import exec as _exec
from . import inflight as _inflight
from .cache import DEFAULT_CACHE, ResultCache, cache_key, leaf_fps_current
from .expr import Expr
from .plan import Plan, PlanStep

# the window's step fates, summed over every window of the process
STEP_COUNTS = {"executed": 0, "deduped": 0, "merged": 0}


def reset_counts() -> None:
    for k in STEP_COUNTS:
        STEP_COUNTS[k] = 0


def _env_flag(name: str, default: bool) -> bool:
    raw = os.environ.get(name, "").strip().lower()
    if not raw:
        return default
    return raw not in ("0", "off", "false", "no")


class config:
    """Fusion dispatch knobs (env-seeded, runtime-overridable via
    :func:`configure`). ``window`` bounds the queries one drained batch
    coalesces; ``max_wait_ms`` bounds how long the drain loop holds an
    open window for stragglers — a member's declared slack can only
    CLOSE the window earlier, never extend it."""

    enabled: bool = _env_flag("RB_TPU_FUSION", True)
    window: int = max(2, int(os.environ.get("RB_TPU_FUSION_WINDOW") or 8))
    max_wait_ms: float = float(os.environ.get("RB_TPU_FUSION_LATENCY_MS") or 2.0)


def configure(
    enabled: Optional[bool] = None,
    window: Optional[int] = None,
    max_wait_ms: Optional[float] = None,
) -> None:
    if enabled is not None:
        config.enabled = bool(enabled)
    if window is not None:
        if window < 2:
            raise ValueError(f"fusion window must be >= 2, got {window}")
        config.window = int(window)
    if max_wait_ms is not None:
        if max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got {max_wait_ms}")
        config.max_wait_ms = float(max_wait_ms)


# ---------------------------------------------------------------------------
# merge classes
# ---------------------------------------------------------------------------

# classes the fused tiers can merge into one dispatch; anything else runs
# solo through the serial executor's step runner (same engines, bit-exact
# by construction)
_MERGEABLE = ("pairwise", "fold", "andnot", "threshold-device")


def _merge_class(step: PlanStep) -> tuple:
    eng, op = step.engine, step.node.op
    if eng == "pairwise":
        return ("pairwise", op)
    if eng in ("naive-or", "horizontal-or"):
        return ("fold", "or")
    if eng in ("naive-xor", "horizontal-xor"):
        return ("fold", "xor")
    if eng.startswith("andnot-batch"):
        return ("andnot", "device" if eng.endswith("[device]") else "cpu")
    if eng == "threshold-bitsliced[device]":
        return ("threshold-device",)
    # workshy-and (key-intersection fold), threshold CPU (per-key adder),
    # device-* n-ary reduces (own amortized working set)
    return ("solo", eng)


# ---------------------------------------------------------------------------
# the batch entry
# ---------------------------------------------------------------------------


def execute_fused(
    queries: Sequence[Union[Expr, Plan]],
    cache: Optional[ResultCache] = DEFAULT_CACHE,
    mode: Optional[str] = None,
    deadline_s: Optional[float] = None,
) -> List[RoaringBitmap]:
    """Execute a window of concurrent queries as merged per-tier
    dispatches. Results are bit-exact with ``[execute(q, ...) for q in
    queries]`` — fusion is a latency decision, never a correctness one.
    Fusion off (or a single query) routes straight to the serial loop."""
    qs = list(queries)
    if not qs:
        return []
    if not config.enabled or len(qs) == 1:
        return [
            _exec.execute(q, cache=cache, mode=mode, deadline_s=deadline_s)
            for q in qs
        ]
    return _execute_window(qs, cache, mode, deadline_s)


def _execute_window(qs, cache, mode, deadline_s) -> List[RoaringBitmap]:
    plans = [q if isinstance(q, Plan) else _exec._memo_plan(q, mode) for q in qs]
    unique: Dict[int, PlanStep] = {}
    deduped = 0
    for p in plans:
        for s in p.steps:
            if s.node.uid in unique:
                deduped += 1
            else:
                unique[s.node.uid] = s
    levels = _levels(unique)
    # cache-aware pricing: a warm window's steps are dict probes, not
    # dispatches — price only the steps the cache cannot serve (the probe
    # is __contains__: no LRU touch, no hit/miss accounting)
    if cache is not None:
        leaf_fps = {}
        for p in plans:
            for l in p.root.leaves:
                if l.uid not in leaf_fps:
                    leaf_fps[l.uid] = l.fingerprint()
        live = {
            uid for uid, s in unique.items()
            if cache_key(s.node, leaf_fps) not in cache
        }
    else:
        live = set(unique)
    n_steps = len(live)
    n_tiers = sum(
        len(_group([s for s in steps if s.node.uid in live]))
        for steps in levels.values()
    )
    STEP_COUNTS["executed"] += n_steps
    STEP_COUNTS["deduped"] += deduped
    if n_steps == 0 or _fusion_cost.MODEL.choose(n_steps, n_tiers) == "per-query":
        return [
            _exec.execute(p, cache=cache, mode=mode, deadline_s=deadline_s)
            for p in plans
        ]
    return _run_fused(plans, unique, levels, cache, deadline_s)


def _levels(unique: Dict[int, PlanStep]) -> Dict[int, List[PlanStep]]:
    """Unique steps by topological depth: a tier at depth d has every
    operand materialized by depths < d, so merged groups never need a
    barrier inside a level."""
    depth: Dict[int, int] = {}

    def _depth(node) -> int:
        d = depth.get(node.uid)
        if d is not None:
            return d
        step = unique.get(node.uid)
        if step is None:  # leaf
            depth[node.uid] = 0
            return 0
        d = 1 + max((_depth(o) for o in step.operands), default=0)
        depth[node.uid] = d
        return d

    levels: Dict[int, List[PlanStep]] = {}
    for s in unique.values():
        levels.setdefault(_depth(s.node), []).append(s)
    return levels


def _group(steps: List[PlanStep]) -> Dict[tuple, List[PlanStep]]:
    groups: Dict[tuple, List[PlanStep]] = {}
    for s in steps:
        groups.setdefault(_merge_class(s), []).append(s)
    return groups


def _run_fused(plans, unique, levels, cache, deadline_s) -> List[RoaringBitmap]:
    leaf_fps: Dict[int, tuple] = {}
    results: Dict[int, RoaringBitmap] = {}
    for p in plans:
        for l in p.root.leaves:
            if l.uid not in leaf_fps:
                leaf_fps[l.uid] = l.fingerprint()
                results[l.uid] = l.bitmap
    with deadline_scope(deadline_s):
        for d in sorted(levels):
            for cls, steps in sorted(_group(levels[d]).items()):
                _run_group(cls, steps, results, leaf_fps, cache)
    return [results[p.root.uid].clone() for p in plans]


def _run_group(cls, steps, results, leaf_fps, cache) -> None:
    # cache + in-flight claim per step: hits and published foreign values
    # drop out of the merge; owners publish after the group computes
    ready: List[Tuple[PlanStep, tuple, Optional[object]]] = []
    for s in steps:
        key = cache_key(s.node, leaf_fps)
        if cache is not None:
            hit = cache.get(key)
            if hit is not None:
                results[s.node.uid] = hit
                continue
            owner, pending = _inflight.TABLE.begin(key)
            if not owner:
                # non-blocking poll, NEVER join(): this executor already
                # holds unpublished claims for earlier steps of this group —
                # blocking on a foreign owner here could mutually stall two
                # windows that claimed shared nodes in opposite orders. A
                # still-computing foreign node is recomputed here, unclaimed.
                joined = _inflight.TABLE.poll(pending)
                if joined is not None:
                    results[s.node.uid] = joined
                    continue
                ready.append((s, key, None))
            else:
                ready.append((s, key, pending))
        else:
            ready.append((s, key, None))
    if not ready:
        return
    force_cpu = deadline_expired()
    merged = not force_cpu and len(ready) >= 2 and cls[0] in _MERGEABLE
    try:
        if merged:
            vals = _run_merged(cls, ready, results)
        else:
            vals = []
            for s, _key, _entry in ready:
                inputs = [results[o.uid] for o in s.operands]
                vals.append(_exec._run_step(s, inputs, force_cpu=force_cpu))
    except BaseException:
        for _s, key, entry in ready:
            if entry is not None:
                _inflight.TABLE.abort(key, entry)
        raise
    if merged:
        STEP_COUNTS["merged"] += len(ready)
    for (s, key, entry), val in zip(ready, vals):
        if cache is not None:
            valid = leaf_fps_current(s.node, leaf_fps)
            if entry is not None:
                _inflight.TABLE.complete(key, entry, val, valid)
            if valid:
                cache.put(key, val)
        results[s.node.uid] = val


def _run_merged(cls, ready, results) -> List[RoaringBitmap]:
    if cls[0] == "pairwise":
        return _merged_pairwise(cls[1], ready, results)
    if cls[0] == "fold":
        return _merged_fold(cls[1], ready, results)
    if cls[0] == "andnot":
        if cls[1] == "device":
            return _merged_andnot_device(ready, results)
        return _merged_andnot_cpu(ready, results)
    return _merged_threshold_device(ready, results)


# ---------------------------------------------------------------------------
# merged tier implementations (each: ONE dispatch for the whole group)
# ---------------------------------------------------------------------------


def _merged_pairwise(op, ready, results) -> List[RoaringBitmap]:
    from .. import columnar
    from ..columnar import engine as _col_engine

    pairs = [
        (results[s.operands[0].uid], results[s.operands[1].uid])
        for s, _k, _e in ready
    ]
    # the window's largest pair prices the tier for the whole group
    big = max(
        pairs,
        key=lambda ab: min(
            ab[0].high_low_container.size, ab[1].high_low_container.size
        ),
    )
    tier = _col_engine.route(
        big[0].high_low_container, big[1].high_low_container,
        record=False, op=op,
    )
    dev = "device" if tier == "columnar-device" else "cpu"
    return columnar.pairwise_multi(op, pairs, tier=dev)


def _merged_fold(op, ready, results) -> List[RoaringBitmap]:
    from ..columnar import engine as _col_engine
    from ..parallel import store

    groups_list = [
        store.group_by_key([results[o.uid] for o in s.operands])
        for s, _k, _e in ready
    ]
    return _col_engine.fold_multi(groups_list, op)


def _merged_andnot_cpu(ready, results) -> List[RoaringBitmap]:
    from .. import columnar
    from ..models.container import best_container_of_words
    from . import kernels as _qk

    jobs = []
    namespaced: dict = {}
    for si, (s, _k, _e) in enumerate(ready):
        first = results[s.operands[0].uid]
        rest = [results[o.uid] for o in s.operands[1:]]
        groups = _qk._rest_groups(first, rest)
        jobs.append((first, groups))
        for k, cs in groups.items():
            namespaced[(si, k)] = cs
    union = columnar.or_fold_words(namespaced) if namespaced else {}
    outs = []
    for si, (first, groups) in enumerate(jobs):
        hlc = first.high_low_container
        out = RoaringBitmap()
        for k, c in zip(hlc.keys, hlc.containers):
            if k not in groups:
                out.high_low_container.append(k, c.clone())
                continue
            acc = c.to_words()
            acc &= ~union[(si, k)]
            res = best_container_of_words(acc)
            if res.cardinality:
                out.high_low_container.append(k, res)
        outs.append(out)
    return outs


def _merged_andnot_device(ready, results) -> List[RoaringBitmap]:
    from ..ops import device as dev
    from ..ops import kernels as K
    from ..parallel import store
    from . import kernels as _qk

    vals: List[Optional[RoaringBitmap]] = [None] * len(ready)
    stages = []
    for i, (s, _k, _e) in enumerate(ready):
        first = results[s.operands[0].uid]
        rest = [results[o.uid] for o in s.operands[1:]]
        ckeys, crows = _qk._covered(first, rest)
        if not crows:  # no subtrahend overlaps any of first's keys
            vals[i] = first.clone()
            continue
        stages.append((i, _qk._device_andnot_stage(first, rest, ckeys)))
    if stages:
        rows_all = K.concat_rows([st[0] for _i, st in stages])
        union_all = K.concat_rows([st[1] for _i, st in stages])
        idx = torch.arange(rows_all.shape[0], dtype=torch.int32, device=rows_all.device)
        words, cards = K.pair_rows_reduce(rows_all, idx, union_all, idx, "andnot")
        words = dev.to_host_u32(words)
        cards = cards.cpu().numpy().astype(np.int64)
        off = 0
        for i, (first_rows, _union, passthrough, keys) in stages:
            g = int(first_rows.shape[0])
            computed = dict(
                store.iter_group_containers(keys, words[off : off + g], cards[off : off + g])
            )
            off += g
            out = RoaringBitmap()
            by_key = {k: c.clone() for k, c in passthrough}
            by_key.update(computed)
            for k in sorted(by_key):
                out.high_low_container.append(k, by_key[k])
            vals[i] = out
    return vals


def _merged_threshold_device(ready, results) -> List[RoaringBitmap]:
    from ..ops import device as dev
    from ..ops import kernels as K
    from ..parallel import store
    from . import kernels as _qk

    vals: List[Optional[RoaringBitmap]] = [None] * len(ready)
    buckets: dict = {}
    for i, (s, _k, _e) in enumerate(ready):
        bms = [results[o.uid] for o in s.operands]
        k = s.node.k
        if k > len(bms):
            vals[i] = RoaringBitmap()
            continue
        keys_ok, _rows = _qk._threshold_keys_ok(bms, k)
        if not keys_ok:
            vals[i] = RoaringBitmap()
            continue
        block = _qk._threshold_device_block(bms, k, keys_ok)
        if block is None:  # too skewed to pad: the CPU fold serves it
            vals[i] = _qk.threshold(k, bms, mode="cpu")
            continue
        packed, words3, n_slices = block
        if (k >> n_slices) != 0:
            vals[i] = RoaringBitmap()
            continue
        buckets.setdefault((k, n_slices, int(words3.shape[1])), []).append(
            (i, packed, words3)
        )
    for (k, n_slices, _m), items in sorted(buckets.items()):
        words_all = (
            torch.cat([w for _i, _p, w in items], dim=0) if len(items) > 1 else items[0][2]
        )
        red, cards = K.threshold_rows(words_all, k, n_slices)
        red = dev.to_host_u32(red)
        cards = cards.cpu().numpy().astype(np.int64)
        off = 0
        for i, packed, w3 in items:
            g = int(w3.shape[0])
            vals[i] = store.unpack_to_bitmap(
                packed.group_keys, red[off : off + g], cards[off : off + g]
            )
            off += g
    return vals


# ---------------------------------------------------------------------------
# the serving window (submit -> future, latency/size/deadline-bounded drain)
# ---------------------------------------------------------------------------


def window_close_at(
    t_open: float, max_wait_s: float, deadlines: Sequence[Optional[float]]
) -> float:
    """When the open window must close: the straggler bound (``t_open +
    max_wait_s``) pulled EARLIER by the tightest member deadline — a
    member's slack can only close the window sooner, never hold it open
    longer."""
    close = t_open + max_wait_s
    for d in deadlines:
        if d is not None and d < close:
            close = d
    return close


class FusionExecutor:
    """Micro-batching front door: ``submit()`` enqueues and returns a
    future; the drain loop coalesces up to ``window`` queries (or whatever
    arrived within ``max_wait_ms`` of the window opening, or whatever fits
    before the tightest member deadline) and executes the batch through
    :func:`execute_fused`. An exception of a batch reaches every future of
    it. One drain thread, lazily started; ``close()`` drains what is
    queued and stops."""

    def __init__(
        self,
        window: Optional[int] = None,
        max_wait_ms: Optional[float] = None,
        cache: Optional[ResultCache] = DEFAULT_CACHE,
        mode: Optional[str] = None,
        deadline_s: Optional[float] = None,
    ):
        # an explicit window pins this executor; None tracks config.window
        self._window_override = window is not None
        self.window = int(window) if window is not None else config.window
        self.max_wait_s = (
            float(max_wait_ms) if max_wait_ms is not None else config.max_wait_ms
        ) / 1e3
        self.cache = cache
        self.mode = mode
        self.deadline_s = deadline_s
        self._cond = threading.Condition()
        self._queue: "deque[tuple]" = deque()  # guarded-by: self._cond
        self._closed = False  # guarded-by: self._cond
        self._thread: Optional[threading.Thread] = None  # guarded-by: self._cond
        self.batches = 0

    def _target_window(self) -> int:
        if self._window_override:
            return self.window
        return max(2, config.window)

    def submit(
        self, query: Union[Expr, Plan], slack_ms: Optional[float] = None
    ) -> "Future[RoaringBitmap]":
        """Enqueue ``query``; ``slack_ms`` is the latency budget it
        declares, which can close its window earlier than
        ``max_wait_ms``."""
        fut: "Future[RoaringBitmap]" = Future()
        t_enq = time.perf_counter()
        deadline = t_enq + float(slack_ms) / 1e3 if slack_ms is not None else None
        self._enqueue(query, fut, t_enq, deadline)
        return fut

    def _enqueue(self, query, fut, t_enq, deadline) -> None:
        with self._cond:
            if self._closed:
                raise RuntimeError("FusionExecutor is closed")
            self._queue.append((query, fut, t_enq, deadline))
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._drain_loop, name="rb-fusion", daemon=True
                )
                self._thread.start()
            self._cond.notify_all()

    def map(self, queries: Sequence[Union[Expr, Plan]]) -> List[RoaringBitmap]:
        """Submit all, wait for all."""
        futs = [self.submit(q) for q in queries]
        return [f.result() for f in futs]

    def _drain_loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if not self._queue and self._closed:
                    return
                t_open = self._queue[0][2]
                while len(self._queue) < self._target_window() and not self._closed:
                    # deadline-aware close: the tightest member slack pulls
                    # the close earlier than the straggler bound; a submit
                    # arriving mid-wait re-evaluates via notify_all
                    close_at = window_close_at(
                        t_open, self.max_wait_s, [e[3] for e in self._queue]
                    )
                    remaining = close_at - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
                batch = [
                    self._queue.popleft()
                    for _ in range(min(self._target_window(), len(self._queue)))
                ]
            try:
                outs = execute_fused(
                    [q for q, _f, _t, _dl in batch],
                    cache=self.cache, mode=self.mode, deadline_s=self.deadline_s,
                )
            except Exception as e:  # the batch's error belongs to its callers' futures; the drain thread serves the next window
                for _q, fut, _t, _dl in batch:
                    fut.set_exception(e)
            else:
                self.batches += 1
                for (_q, fut, _t, _dl), val in zip(batch, outs):
                    fut.set_result(val)

    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
            t = self._thread
        if t is not None:
            t.join(timeout=10.0)

    def __enter__(self) -> "FusionExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
