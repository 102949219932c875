"""Lazy query expression engine.

Counterpart of ``roaringbitmap_tpu/query``: whole boolean expressions —
``(users_in_A & users_in_B) - opted_out | Q.threshold(2, x, y, z)`` — over
many bitmaps, planned over the whole expression instead of one call at a
time:

* ``expr.py`` — lazy, hash-consed DAG nodes (And/Or/Xor/AndNot/Not over an
  explicit universe/Threshold(k)) built via operator overloading or the
  :class:`Q` API; repeated subtrees share one node.
* ``plan.py`` — exact algebraic rewrites (flattening, De Morgan push-down,
  difference pull-up, constant folding), a cardinality-driven cost model,
  and per-node engine selection; emits an inspectable :class:`Plan` with
  ``explain()``.
* ``exec.py`` — bottom-up execution with interior-result memoization in a
  bounded LRU cache (``cache.py``) keyed by (node, leaf fingerprints), and
  cross-query dedup of pending nodes (``inflight.py``).
* ``kernels.py`` — n-way ANDNOT and the bit-sliced-adder Threshold(k),
  each with CPU and device paths (``rb_group_reduce`` and
  ``rb_threshold`` on the card).

* ``fusion.py`` — the micro-batching executor: :func:`execute_fused`
  runs a window of concurrent queries with shared subexpressions deduped
  and same-class steps merged into one dispatch per tier
  (``rb_pair_rows``, ``rb_threshold``, ``rb_group_reduce`` on the card);
  :class:`FusionExecutor` is its serving shape (``submit`` -> future).
* ``exec.execute_pipelined`` — back-to-back queries with the overlap
  shipping lane (``parallel/overlap.py``) staging the next query's leaf
  packs while the current one runs.

Quick start::

    from roaringbitmap_tpu_torch.query import Q, execute, plan

    q = (Q.leaf(a) & Q.leaf(b) | Q.leaf(c)) - Q.leaf(opted_out)
    print(plan(q).explain())           # rewrites + engines + estimates
    result = execute(q)                # planned, memoized, on the card
    result = execute(q)                # cache hit (bitmaps unchanged)
"""

from .cache import DEFAULT_CACHE, ResultCache, cache_key, leaf_fps_current
from . import fusion
from .exec import execute, execute_pipelined
from .expr import Expr, Leaf, Q, as_expr, evaluate_naive
from .fusion import FusionExecutor, execute_fused
from .inflight import TABLE as INFLIGHT
from .inflight import InflightTable
from .kernels import andnot_nway, andnot_nway_cardinality, threshold
from .plan import Plan, PlanStep, plan, rewrite

__all__ = [
    "Q",
    "Expr",
    "Leaf",
    "as_expr",
    "evaluate_naive",
    "plan",
    "rewrite",
    "Plan",
    "PlanStep",
    "execute",
    "execute_fused",
    "execute_pipelined",
    "FusionExecutor",
    "fusion",
    "InflightTable",
    "INFLIGHT",
    "ResultCache",
    "DEFAULT_CACHE",
    "cache_key",
    "leaf_fps_current",
    "andnot_nway",
    "andnot_nway_cardinality",
    "threshold",
]
