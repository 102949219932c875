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

The JAX package's micro-batching fusion executor (``fusion``,
``FusionExecutor``, ``execute_fused``) and ``execute_pipelined`` are not
ported yet.

Quick start::

    from roaringbitmap_tpu_torch.query import Q, execute, plan

    q = (Q.leaf(a) & Q.leaf(b) | Q.leaf(c)) - Q.leaf(opted_out)
    print(plan(q).explain())           # rewrites + engines + estimates
    result = execute(q)                # planned, memoized, on the card
    result = execute(q)                # cache hit (bitmaps unchanged)
"""

from .cache import DEFAULT_CACHE, ResultCache, cache_key, leaf_fps_current
from .exec import execute
from .expr import Expr, Leaf, Q, as_expr, evaluate_naive
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
