"""Lazy query expression DAG over RoaringBitmap leaves.

Counterpart of ``roaringbitmap_tpu/query/expr.py``.

The reference's ``FastAggregation`` picks one algorithm per *call*; richer
boolean queries ("beyond unions and intersections", PAPERS.md) want the whole
expression visible before anything executes. Nodes here are **lazy** —
building ``(a & b) - c | Q.threshold(2, x, y, z)`` allocates a few interned
objects and touches no container — and **hash-consed**: constructing the same
(op, children) twice returns the same node object, so repeated subtrees
share one node and common-subexpression elimination is structural, not a
planner search.

Node kinds::

    leaf        one RoaringBitmap (Q.leaf)
    and/or/xor  n-ary associative algebra
    andnot      minuend \\ (sub_1 | sub_2 | ...)      (n-ary difference)
    not         universe \\ child  (explicit universe expression)
    threshold   values present in >= k of the children (multiset counting)

Identity semantics: leaves intern on the *bitmap object* (``Q.leaf(bm)``
twice is one node; two equal-content bitmaps are two leaves). Equality of
nodes is object identity — structural equality is what hash-consing already
guarantees. Leaf *contents* are pinned at execution time instead, via
``RoaringBitmap.fingerprint()`` in the result-cache key (cache.py).
"""

from __future__ import annotations

import itertools
import threading
import weakref
from typing import Iterable, Optional, Tuple, Union

from ..models.roaring import RoaringBitmap

_UID = itertools.count(1)
# op, k, child uids (+ bitmap id for leaves) -> node; weak values so dropping
# every external reference to an expression frees its whole subtree
_INTERN_LOCK = threading.Lock()
_INTERN: "weakref.WeakValueDictionary[tuple, Expr]" = weakref.WeakValueDictionary()  # guarded-by: _INTERN_LOCK

ExprLike = Union["Expr", RoaringBitmap]


def _intern(key: tuple, build) -> "Expr":
    with _INTERN_LOCK:
        node = _INTERN.get(key)
        if node is None:
            node = build()
            _INTERN[key] = node
        return node


class Expr:
    """One interned DAG node. Construct via :class:`Q` or the operators;
    the constructor itself is internal (it does not intern)."""

    __slots__ = ("op", "children", "k", "uid", "_leaves", "__weakref__")

    def __init__(self, op: str, children: Tuple["Expr", ...], k: Optional[int] = None):
        self.op = op
        self.children = children
        self.k = k
        self.uid = next(_UID)
        self._leaves: Optional[Tuple["Leaf", ...]] = None

    # hash-consing makes structural equality == identity; keep the default
    # object __eq__/__hash__ (Leaf holds a RoaringBitmap, whose own __eq__
    # must not leak into node identity)

    @property
    def leaves(self) -> Tuple["Leaf", ...]:
        """Distinct leaf nodes of this subtree, first-visit DFS order
        (computed once; the DAG is immutable)."""
        if self._leaves is None:
            seen = set()
            stack = [self]
            order = []
            while stack:
                n = stack.pop()
                if n.uid in seen:
                    continue
                seen.add(n.uid)
                if n.op == "leaf":
                    order.append(n)
                else:
                    # push in reverse so DFS visits children left-to-right
                    for c in reversed(n.children):
                        stack.append(c)
            self._leaves = tuple(order)
        return self._leaves

    # ---- operator overloading (the ergonomic construction surface) -------
    def __and__(self, other: ExprLike) -> "Expr":
        return Q.and_(self, other)

    def __rand__(self, other: ExprLike) -> "Expr":
        return Q.and_(other, self)

    def __or__(self, other: ExprLike) -> "Expr":
        return Q.or_(self, other)

    def __ror__(self, other: ExprLike) -> "Expr":
        return Q.or_(other, self)

    def __xor__(self, other: ExprLike) -> "Expr":
        return Q.xor(self, other)

    def __rxor__(self, other: ExprLike) -> "Expr":
        return Q.xor(other, self)

    def __sub__(self, other: ExprLike) -> "Expr":
        return Q.andnot(self, other)

    def __rsub__(self, other: ExprLike) -> "Expr":
        return Q.andnot(other, self)

    def not_(self, universe: ExprLike) -> "Expr":
        """Complement against an explicit universe: ``universe \\ self``."""
        return Q.not_(self, universe)

    def __repr__(self) -> str:
        if self.op == "leaf":
            return f"Leaf#{self.uid}"
        head = f"{self.op}" + (f"[k={self.k}]" if self.k is not None else "")
        return f"{head}({', '.join(repr(c) for c in self.children)})"


class Leaf(Expr):
    __slots__ = ("bitmap",)

    def __init__(self, bitmap: RoaringBitmap):
        super().__init__("leaf", ())
        self.bitmap = bitmap

    def fingerprint(self) -> tuple:
        """The leaf bitmap's mutation token (models/roaring.py); falls back
        to object identity for foreign read-only bitmap types."""
        fp = getattr(self.bitmap, "fingerprint", None)
        if fp is None:
            return ("static", id(self.bitmap))
        return fp()


def as_expr(x: ExprLike) -> Expr:
    """Coerce operands: Expr passes through, bitmaps become (interned) leaves."""
    if isinstance(x, Expr):
        return x
    if hasattr(x, "high_low_container"):
        return Q.leaf(x)
    raise TypeError(f"expected Expr or RoaringBitmap, got {type(x).__name__}")


class Q:
    """Construction API: ``Q.leaf(bm)``, ``Q.and_/or_/xor(*xs)``,
    ``Q.andnot(first, *rest)``, ``Q.not_(x, universe)``,
    ``Q.threshold(k, *xs)`` — every constructor interns."""

    @staticmethod
    def leaf(bitmap: RoaringBitmap) -> Leaf:
        if not hasattr(bitmap, "high_low_container"):
            raise TypeError(f"Q.leaf expects a bitmap, got {type(bitmap).__name__}")
        # the node holds a strong reference to the bitmap, so id() cannot be
        # recycled while the interned entry is alive
        return _intern(("leaf", id(bitmap)), lambda: Leaf(bitmap))

    @staticmethod
    def empty() -> Leaf:
        """The canonical empty leaf (constant-folding target)."""
        return Q.leaf(_EMPTY_BITMAP)

    @staticmethod
    def _nary(op: str, xs: Iterable[ExprLike], k: Optional[int] = None) -> Expr:
        children = tuple(as_expr(x) for x in xs)
        if not children:
            raise ValueError(f"{op} needs at least one operand")
        if len(children) == 1 and k is None:
            return children[0]
        key = (op, k, tuple(c.uid for c in children))
        return _intern(key, lambda: Expr(op, children, k))

    @staticmethod
    def and_(*xs: ExprLike) -> Expr:
        return Q._nary("and", xs)

    @staticmethod
    def or_(*xs: ExprLike) -> Expr:
        return Q._nary("or", xs)

    @staticmethod
    def xor(*xs: ExprLike) -> Expr:
        return Q._nary("xor", xs)

    @staticmethod
    def andnot(first: ExprLike, *rest: ExprLike) -> Expr:
        """n-ary difference: ``first \\ (rest_1 | rest_2 | ...)``."""
        children = (as_expr(first),) + tuple(as_expr(x) for x in rest)
        if len(children) == 1:
            return children[0]
        key = ("andnot", None, tuple(c.uid for c in children))
        return _intern(key, lambda: Expr("andnot", children))

    @staticmethod
    def not_(x: ExprLike, universe: ExprLike) -> Expr:
        """``universe \\ x`` — complement against an explicit universe
        expression (a 32-bit universe is never materialized implicitly)."""
        cx, cu = as_expr(x), as_expr(universe)
        key = ("not", None, (cx.uid, cu.uid))
        return _intern(key, lambda: Expr("not", (cx, cu)))

    @staticmethod
    def threshold(k: int, *xs: ExprLike) -> Expr:
        """Values present in at least ``k`` of the operands (a multiset:
        a repeated child counts with multiplicity)."""
        k = int(k)
        if k < 1:
            raise ValueError(f"threshold k must be >= 1, got {k}")
        children = tuple(as_expr(x) for x in xs)
        if not children:
            raise ValueError("threshold needs at least one operand")
        key = ("threshold", k, tuple(c.uid for c in children))
        return _intern(key, lambda: Expr("threshold", children, k))


_EMPTY_BITMAP = RoaringBitmap()


def evaluate_naive(expr: Expr) -> RoaringBitmap:
    """Reference evaluator: plain recursive set algebra with pairwise folds,
    no planner, no cache, no device: the differential oracle of the
    planner and executor."""
    import numpy as np

    memo: dict = {}

    def ev(n: Expr) -> RoaringBitmap:
        got = memo.get(n.uid)
        if got is not None:
            return got
        if n.op == "leaf":
            out = n.bitmap
        elif n.op == "and":
            out = ev(n.children[0]).clone()
            for c in n.children[1:]:
                out.iand(ev(c))
        elif n.op == "or":
            out = ev(n.children[0]).clone()
            for c in n.children[1:]:
                out.ior(ev(c))
        elif n.op == "xor":
            out = ev(n.children[0]).clone()
            for c in n.children[1:]:
                out.ixor(ev(c))
        elif n.op == "andnot":
            out = ev(n.children[0]).clone()
            for c in n.children[1:]:
                out.iandnot(ev(c))
        elif n.op == "not":
            out = RoaringBitmap.andnot(ev(n.children[1]), ev(n.children[0]))
        elif n.op == "threshold":
            arrs = [ev(c).to_array() for c in n.children]
            vals = np.concatenate(arrs) if arrs else np.empty(0, np.uint32)
            uniq, counts = np.unique(vals, return_counts=True)
            out = RoaringBitmap(uniq[counts >= n.k])
        else:  # pragma: no cover - unreachable
            raise ValueError(f"unknown op {n.op}")
        memo[n.uid] = out
        return out

    out = ev(expr)
    # a leaf root (including single-operand constructors that collapse to
    # their child, and Q.empty()'s shared sentinel) would hand out the live
    # internal bitmap — clone so callers can mutate the result freely, the
    # same contract execute() gives
    return out.clone() if expr.op == "leaf" else out
