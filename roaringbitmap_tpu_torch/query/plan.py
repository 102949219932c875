"""Cost-based planner: algebraic rewrites + engine selection over the DAG.

Counterpart of ``roaringbitmap_tpu/query/plan.py``; the same rewrites,
estimates and engine names, so a plan here reads engine for engine like
the JAX package's.

Pipeline (all host-side, microseconds against container-op costs):

1. **Rewrites** (`rewrite`) — exact identities only, bottom-up and memoized
   over the hash-consed DAG so shared subtrees fold once:

   * flatten associative ops (``and(and(a,b),c) -> and(a,b,c)``) and n-ary
     differences (``andnot(andnot(a,B),C) -> andnot(a,B,C)``; an ``or``
     subtrahend splices into the subtrahend set);
   * De Morgan push-down of ``not`` through ``or``:
     ``U \\ (a|b) = (U\\a) & (U\\b)`` — profitable because the resulting
     conjunction then re-fuses into one n-ary ``andnot(U, a, b)`` via the
     pull-up rule below. ``not`` through ``and`` would manufacture unions
     of complements (strictly more work) and is deliberately NOT applied —
     the "only when profitable" half of the AndNot<->And(Not) equivalence;
   * pull differences out of conjunctions:
     ``a & (c \\ D) = (a & c) \\ D`` (exact for any operands), which is how
     lowered ``not`` nodes and user ``andnot`` nodes consolidate into a
     single subtraction per conjunction;
   * constant folding: empty leaves annihilate ``and``/minuends and vanish
     from ``or``/``xor``/subtrahends/threshold children; a full
     (2^32-cardinality) leaf absorbs ``or`` and vanishes from ``and``;
     ``xor`` cancels duplicate children pairwise; ``threshold`` folds
     k=1 -> or, k=N -> and, k>N -> empty.

   Hash-consing (expr.py) makes CSE structural: after rewriting, each
   distinct subcomputation is one node, planned and executed once.

2. **Cost model** — per-node estimated cardinality and container-row count
   from per-leaf ``get_cardinality()`` + ``get_container_count()``:
   and=min, or/xor=sum, andnot=minuend,
   threshold=sum/k. AND operands are ordered ascending by estimated
   cardinality (the workShyAnd/priorityqueue ordering heuristic); so are OR
   operands (cheapest merges first) and subtrahend sets.

3. **Engine choice** per node, the same strategy menu FastAggregation
   exposes plus the new kernels: ``pairwise`` host merges for 2 operands,
   ``workshy-and``/``naive-*``/``horizontal-*`` CPU folds,
   ``device-*`` batched reductions when
   ``parallel.aggregation._use_device`` says the working set earns a
   dispatch (``-sharded`` when ``aggregation.config.mesh`` is set),
   ``andnot-batch`` (grouped OR of the subtrahends + one
   ``first & ~union`` mask, kernels.py), and
   ``threshold-bitsliced`` (the bit-sliced adder, kernels.py).

The emitted :class:`Plan` is inspectable (``explain()``) and is what the
executor (exec.py) runs bottom-up with result memoization.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Tuple

from .. import observe as _observe
from ..observe import decisions as _decisions
from .expr import Expr, Leaf, Q

_MAX32 = 1 << 32

_PLAN_TOTAL = _observe.counter(
    _observe.QUERY_PLAN_TOTAL,
    "Planned query steps by chosen engine",
    ("engine",),
)


class CardinalityModel:
    """The planner's refittable cardinality model.

    The structural estimators below (and=min, or/xor=capped sum,
    andnot=minuend, threshold=sum/k) are exact bounds but systematically
    biased on real traffic (an AND of correlated filters lands far under
    ``min``; a union of overlapping dimensions far under ``sum``). Each
    op carries a multiplicative correction, 1.0 until
    :meth:`refit_from_outcomes` learns a better one from samples of
    measured result cardinalities beside the plan-time estimates: the
    refit moves ``correction[op]`` by the geometric mean of
    measured/estimated over the samples.

    Thread-safe: corrections swap under a leaf lock; reads are lock-free
    dict gets (atomic under the GIL)."""

    OPS = ("and", "or", "xor", "andnot", "threshold")
    # a single refit moves a correction at most this factor either way —
    # one weird traffic window must not be able to invert the planner's
    # operand ordering outright
    MAX_STEP = 8.0
    MAX_CORRECTION = 64.0

    def __init__(self):
        self._lock = threading.Lock()
        self.corrections: Dict[str, float] = {op: 1.0 for op in self.OPS}
        self.provenance = "default"

    def corrected(self, op: str, est: int) -> int:
        c = self.corrections.get(op, 1.0)
        if c == 1.0:
            return est
        return max(0, min(_MAX32, int(est * c)))

    def refit_from_outcomes(
        self, samples: Optional[List[dict]] = None, min_samples: int = 4
    ) -> dict:
        """Refit the per-op corrections from joined ``query.plan``
        outcomes (default: the live outcome ledger, ``observe.outcomes``:
        every executed plan step resolves its decision with the measured
        result cardinality). A sample must carry
        the op, a positive estimate, and a positive measured cardinality;
        ratios outside ``[2^-20, 2^20]`` are poisoned (a sample cannot
        legitimately miss by a million-fold — that is corrupt telemetry,
        not bias) and are rejected, counted in the report."""
        if samples is None:
            from ..observe import outcomes as _outcomes

            samples = _outcomes.tail()
        ratios: Dict[str, List[float]] = {}
        rejected = 0
        for s in samples:
            if s.get("site") not in (None, "query.plan"):
                continue
            inputs = s.get("inputs") or {}
            op = inputs.get("op") or s.get("op")
            est = inputs.get("est_card", s.get("est_card"))
            actual = s.get("actual")
            if op not in self.corrections:
                continue
            try:
                est = float(est)
                actual = float(actual)
            except (TypeError, ValueError):
                rejected += 1
                continue
            if not (est > 0 and actual > 0 and math.isfinite(est)
                    and math.isfinite(actual)):
                rejected += 1
                continue
            r = actual / est
            if not (2.0 ** -20 <= r <= 2.0 ** 20):
                rejected += 1
                continue
            ratios.setdefault(op, []).append(r)
        moved = {}
        with self._lock:
            for op, rs in ratios.items():
                if len(rs) < min_samples:
                    continue
                step = math.exp(sum(math.log(r) for r in rs) / len(rs))
                step = min(self.MAX_STEP, max(1.0 / self.MAX_STEP, step))
                new = self.corrections[op] * step
                new = min(self.MAX_CORRECTION, max(1.0 / self.MAX_CORRECTION, new))
                if new != self.corrections[op]:
                    moved[op] = {
                        "from": round(self.corrections[op], 4),
                        "to": round(new, 4),
                        "samples": len(rs),
                    }
                    self.corrections[op] = new
            if moved:
                self.provenance = "refit-from-traffic"
        report = {"moved": moved, "rejected": rejected, "provenance": self.provenance}
        _decisions.record_decision(
            "costmodel.refit", "query-cardinality",
            moved=len(moved), rejected=rejected, provenance=self.provenance,
        )
        return report

    SCHEMA = "rb_tpu_planner_cardmodel/1"

    def to_dict(self) -> dict:
        """Serializable correction state."""
        with self._lock:
            return {
                "schema": self.SCHEMA,
                "corrections": dict(self.corrections),
                "provenance": self.provenance,
            }

    def from_dict(self, d: dict) -> bool:
        """Adopt serialized corrections; False (state untouched) on a
        schema mismatch or out-of-clamp values — a corrupt state file
        must not hand the planner an inverted operand ordering."""
        if not isinstance(d, dict) or d.get("schema") != self.SCHEMA:
            return False
        corrections = d.get("corrections")
        if not isinstance(corrections, dict):
            return False
        clean = {op: 1.0 for op in self.OPS}
        for op, c in corrections.items():
            if op not in clean:
                continue
            try:
                c = float(c)
            except (TypeError, ValueError):
                return False
            if not (1.0 / self.MAX_CORRECTION <= c <= self.MAX_CORRECTION):
                return False
            clean[op] = c
        with self._lock:
            self.corrections = clean
            self.provenance = str(d.get("provenance") or "default")
        return True

    def reset(self) -> None:
        with self._lock:
            self.corrections = {op: 1.0 for op in self.OPS}
            self.provenance = "default"


CARD_MODEL = CardinalityModel()


# ---------------------------------------------------------------------------
# rewrites
# ---------------------------------------------------------------------------


def _leaf_card(n: Leaf, cards: Optional[Dict[int, int]] = None) -> int:
    """Leaf cardinality, memoized per planning pass: get_cardinality() is
    O(#containers) and the rewrite's empty/full probes would otherwise
    re-sum the same leaf many times."""
    if cards is None:
        return n.bitmap.get_cardinality()
    c = cards.get(n.uid)
    if c is None:
        c = cards[n.uid] = n.bitmap.get_cardinality()
    return c


def _is_empty(n: Expr, cards=None) -> bool:
    return n.op == "leaf" and _leaf_card(n, cards) == 0


def _is_full(n: Expr, cards=None) -> bool:
    return n.op == "leaf" and _leaf_card(n, cards) == _MAX32


def rewrite(expr: Expr, _cards: Optional[Dict[int, int]] = None) -> Expr:
    """Fold the DAG through the exact identities above. Constant folds are
    pinned to leaf contents *at plan time* — ``execute(expr)`` replans when
    any leaf fingerprint changes, so a mutated leaf is re-folded; a held
    :class:`Plan` is a snapshot."""
    memo: Dict[int, Expr] = {}
    cards: Dict[int, int] = {} if _cards is None else _cards

    def fold(n: Expr) -> Expr:
        got = memo.get(n.uid)
        if got is not None:
            return got
        out = _fold_node(n, fold, cards)
        memo[n.uid] = out
        return out

    return fold(expr)


def _fold_node(n: Expr, fold, cards) -> Expr:
    if n.op == "leaf":
        return n
    if n.op == "not":
        return _fold_not(fold(n.children[0]), fold(n.children[1]), fold, cards)
    kids = [fold(c) for c in n.children]
    if n.op == "andnot":
        return _fold_andnot(kids[0], kids[1:], cards)
    if n.op == "threshold":
        kids = [c for c in kids if not _is_empty(c, cards)]
        k = n.k
        if not kids or k > len(kids):
            return Q.empty()
        if k == 1:
            return fold(Q.or_(*kids))
        if k == len(kids):
            return fold(Q.and_(*kids))
        return Q.threshold(k, *kids)
    # associative and/or/xor: flatten one level (children already folded,
    # so nested same-op nodes are themselves flat)
    flat: List[Expr] = []
    for c in kids:
        if c.op == n.op:
            flat.extend(c.children)
        else:
            flat.append(c)
    if n.op == "and":
        return _fold_and(flat, fold, cards)
    if n.op == "or":
        return _fold_or(flat, cards)
    return _fold_xor(flat, cards)


def _dedup(kids: List[Expr]) -> List[Expr]:
    seen, out = set(), []
    for c in kids:
        if c.uid not in seen:
            seen.add(c.uid)
            out.append(c)
    return out


def _fold_and(kids: List[Expr], fold, cards) -> Expr:
    if any(_is_empty(c, cards) for c in kids):
        return Q.empty()
    kept = [c for c in kids if not _is_full(c, cards)]
    kids = _dedup(kept) if kept else [kids[0]]
    if len(kids) == 1:
        return kids[0]
    # pull differences up: a & (c \ D) & (e \ F) = (a & c & e) \ (D | F)
    plain = [c for c in kids if c.op != "andnot"]
    diffs = [c for c in kids if c.op == "andnot"]
    if diffs:
        minuends = plain + [d.children[0] for d in diffs]
        subs = [s for d in diffs for s in d.children[1:]]
        return fold(Q.andnot(Q.and_(*minuends), *subs))
    return Q.and_(*kids)


def _fold_or(kids: List[Expr], cards) -> Expr:
    for c in kids:
        if _is_full(c, cards):
            return c
    kids = _dedup([c for c in kids if not _is_empty(c, cards)])
    if not kids:
        return Q.empty()
    if len(kids) == 1:
        return kids[0]
    return Q.or_(*kids)


def _fold_xor(kids: List[Expr], cards) -> Expr:
    counts: Dict[int, int] = {}
    by_uid: Dict[int, Expr] = {}
    order: List[int] = []
    for c in kids:
        if _is_empty(c, cards):
            continue
        if c.uid not in counts:
            order.append(c.uid)
            by_uid[c.uid] = c
        counts[c.uid] = counts.get(c.uid, 0) + 1
    kids = [by_uid[u] for u in order if counts[u] % 2]  # a ^ a = empty
    if not kids:
        return Q.empty()
    if len(kids) == 1:
        return kids[0]
    return Q.xor(*kids)


def _fold_andnot(minuend: Expr, subs: List[Expr], cards) -> Expr:
    if _is_empty(minuend, cards):
        return Q.empty()
    if minuend.op == "andnot":  # (a \ B) \ C = a \ (B u C)
        subs = list(minuend.children[1:]) + subs
        minuend = minuend.children[0]
    flat: List[Expr] = []
    for s in subs:
        if s.op == "or":  # a \ (b|c) folds into the n-ary subtrahend set
            flat.extend(s.children)
        else:
            flat.append(s)
    flat = _dedup([s for s in flat if not _is_empty(s, cards)])
    if any(_is_full(s, cards) for s in flat):
        return Q.empty()
    if any(s.uid == minuend.uid for s in flat):
        return Q.empty()
    if not flat:
        return minuend
    return Q.andnot(minuend, *flat)


def _fold_not(x: Expr, universe: Expr, fold, cards) -> Expr:
    if _is_empty(x, cards):
        return universe
    if x.op == "or":  # De Morgan: U \ (a|b) = (U\a) & (U\b) -> andnot(U, a, b)
        return fold(Q.and_(*[Q.not_(c, universe) for c in x.children]))
    if x.op == "andnot" and x.children[0].uid == universe.uid:
        # the double-not, post-lowering: U \ (U \ S) = U & S (NOT S in
        # general — only S's part inside U)
        return fold(Q.and_(universe, Q.or_(*x.children[1:])))
    return fold(Q.andnot(universe, x))


# ---------------------------------------------------------------------------
# cost model + engine choice
# ---------------------------------------------------------------------------


class PlanStep:
    """One executable node: ``engine`` applied to ``operands`` (child nodes
    in chosen evaluation order)."""

    __slots__ = ("index", "node", "engine", "operands", "est_card", "est_rows",
                 "decision_seq")

    def __init__(self, index, node, engine, operands, est_card, est_rows,
                 decision_seq=None):
        self.index = index
        self.node = node
        self.engine = engine
        self.operands = operands
        self.est_card = est_card
        self.est_rows = est_rows
        # the step's query.plan decision serial, until the executor
        # resolves it with the measured step (once: a memoized plan's
        # later runs carry None)
        self.decision_seq = decision_seq


class Plan:
    """Inspectable bottom-up execution plan over the rewritten DAG."""

    def __init__(
        self,
        root: Expr,
        steps: List[PlanStep],
        labels: Dict[int, str],
        leaf_cards: Dict[int, int],
    ):
        self.root = root
        self.steps = steps
        self._labels = labels
        self._leaf_cards = leaf_cards  # plan-time snapshot, what the model saw

    def explain(self) -> str:
        """Stable human-readable rendering: one line per leaf (first-use
        DFS order) and per step (bottom-up order), with the chosen engine
        and estimated cardinality/container-rows."""
        lines = [f"plan: {len(self.steps)} steps over {len(self.root.leaves)} leaves"]
        for leaf in self.root.leaves:
            lines.append(
                f"  {self._labels[leaf.uid]} leaf card={self._leaf_cards[leaf.uid]}"
            )
        for s in self.steps:
            ops = ", ".join(self._labels[o.uid] for o in s.operands)
            head = s.node.op + (f"[k={s.node.k}]" if s.node.k is not None else "")
            lines.append(
                f"  {self._labels[s.node.uid]} {head}({ops}) engine={s.engine}"
                f" est_card={s.est_card} est_rows={s.est_rows}"
            )
        lines.append(f"  root: {self._labels[self.root.uid]}")
        return "\n".join(lines)


def _estimates(node: Expr, est: Dict[int, Tuple[int, int]], cards) -> Tuple[int, int]:
    """(est_cardinality, est_container_rows) from the children's entries."""
    if node.op == "leaf":
        card = _leaf_card(node, cards)
        try:
            rows = node.bitmap.get_container_count()  # O(1) on the facade
        except (AttributeError, TypeError):  # a foreign bitmap type
            rows = max(1, card // 4096)
        return card, rows
    kid = [est[c.uid] for c in node.children]
    # structural bound first, then the refittable per-op correction
    if node.op == "and":
        card, rows = min(c for c, _ in kid), len(kid) * min(r for _, r in kid)
    elif node.op in ("or", "xor"):
        card, rows = min(sum(c for c, _ in kid), _MAX32), sum(r for _, r in kid)
    elif node.op == "andnot":
        # the difference is bounded by the minuend; subtrahend rows count
        # because the n-way kernel folds them over the minuend's keys
        card, rows = kid[0][0], sum(r for _, r in kid)
    elif node.op == "threshold":
        card, rows = sum(c for c, _ in kid) // node.k, sum(r for _, r in kid)
    else:
        raise ValueError(f"unplannable op {node.op!r} (rewrite should have lowered it)")
    return CARD_MODEL.corrected(node.op, card), rows


def _choose_engine(node: Expr, est_rows: int, mode: Optional[str]) -> str:
    from ..parallel import aggregation

    n = len(node.children)
    device = aggregation._use_device(est_rows, mode)
    sharded = "-sharded" if (device and aggregation.config.mesh is not None) else ""
    if node.op in ("and", "or", "xor"):
        if n == 2 and not device:
            return "pairwise"
        if device:
            return f"device-{node.op}{sharded}"
        if node.op == "and":
            return "workshy-and"
        return ("horizontal-" if n >= 8 else "naive-") + node.op
    if node.op == "andnot":
        if n == 2 and not device:
            return "pairwise"
        return f"andnot-batch[{'device' if device else 'cpu'}]"
    if node.op == "threshold":
        return f"threshold-bitsliced[{'device' if device else 'cpu'}]"
    raise ValueError(f"unplannable op {node.op!r}")


def plan(expr: Expr, mode: Optional[str] = None) -> Plan:
    """Rewrite + cost-order + engine-select ``expr`` into a :class:`Plan`.

    ``mode`` forwards to the engine dispatcher: ``'cpu'``/``'device'``
    force the regime, ``None`` lets ``_use_device`` decide per node.

    Each node's engine choice counts into ``rb_tpu_query_plan_total
    {engine}`` and is recorded as a ``query.plan`` decision with the
    estimates that drove it, for the executor to resolve.
    """
    from .. import tracing

    with tracing.op_timer("query.plan"):
        return _plan(expr, mode)


def _plan(expr: Expr, mode: Optional[str]) -> Plan:
    cards: Dict[int, int] = {}
    root = rewrite(expr, _cards=cards)
    labels: Dict[int, str] = {}
    for i, leaf in enumerate(root.leaves):
        labels[leaf.uid] = f"L{i}"
    est: Dict[int, Tuple[int, int]] = {}
    steps: List[PlanStep] = []
    # iterative post-order over the DAG, each node once
    stack: List[Tuple[Expr, bool]] = [(root, False)]
    while stack:
        node, ready = stack.pop()
        if node.uid in est:
            continue
        if not ready:
            stack.append((node, True))
            for c in reversed(node.children):
                if c.uid not in est:
                    stack.append((c, False))
            continue
        card, rows = _estimates(node, est, cards)
        est[node.uid] = (card, rows)
        if node.op == "leaf":
            continue
        operands = _order_operands(node, est)
        engine = _choose_engine(node, rows, mode)
        _PLAN_TOTAL.inc(1, (engine,))
        labels[node.uid] = f"s{len(steps)}"
        seq = _decisions.record_decision(
            "query.plan", engine, outcome=True, op=node.op,
            est_card=int(card), est_rows=int(rows),
            operands=len(node.children), mode=mode,
        )
        steps.append(PlanStep(len(steps), node, engine, operands, card, rows,
                              decision_seq=seq))
    leaf_cards = {l.uid: _leaf_card(l, cards) for l in root.leaves}
    return Plan(root, steps, labels, leaf_cards)


def _order_operands(node: Expr, est) -> Tuple[Expr, ...]:
    kids = node.children
    if node.op in ("and", "or"):
        # ascending estimated cardinality, original position as tiebreak:
        # cheap operands first keeps intermediate results small (AND) and
        # merges cheap-into-cheap first (OR, the priorityqueue_or idea)
        order = sorted(range(len(kids)), key=lambda i: (est[kids[i].uid][0], i))
        return tuple(kids[i] for i in order)
    if node.op == "andnot":
        rest = sorted(range(1, len(kids)), key=lambda i: (est[kids[i].uid][0], i))
        return (kids[0],) + tuple(kids[i] for i in rest)
    return kids  # xor order is free; threshold children are a multiset
