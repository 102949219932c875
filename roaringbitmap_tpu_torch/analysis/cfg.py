"""A light intra-function CFG + forward may-analysis.

Nodes are *statements* of one function's own scope (nested defs/lambdas
are separate functions — they get their own CFG). Edges model the
control flow the dataflow rules care about:

* sequence within a block;
* ``if``/``elif``/``else`` branch + join;
* ``for``/``while`` loop body with a back edge to the header and an exit
  edge past the loop (so state flows *around* an iteration: a variable
  donated late in a loop body reaches the body's top on the next trip
  unless re-bound first);
* ``try`` — every body statement may also jump to each handler (any
  statement can raise), handlers and ``finally`` rejoin;
* ``break``/``continue``/``return``/``raise`` cut the fall-through edge.

The analysis is a classic may-forward fixpoint over small sets of
variable names: :func:`may_reach` takes per-statement GEN (names entering
the tracked state) and KILL (re-bindings leaving it) and returns each
statement's IN set. Functions in this tree are small, so the worklist
converges in a handful of passes; no basic-block construction is needed
at this scale.
"""

from __future__ import annotations

import ast
from typing import Callable, Dict, Iterable, List, Set, Tuple

_SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)


class CFG:
    """Statement-level control-flow graph of one function body."""

    def __init__(self, fn: ast.AST):
        self.fn = fn
        self.stmts: List[ast.stmt] = []
        self._index: Dict[int, int] = {}  # id(stmt) -> node index
        self.succs: Dict[int, Set[int]] = {}
        self.entry: List[int] = []
        self._build(list(getattr(fn, "body", ())))

    # -- construction ---------------------------------------------------

    def _add(self, stmt: ast.stmt) -> int:
        idx = len(self.stmts)
        self.stmts.append(stmt)
        self._index[id(stmt)] = idx
        self.succs[idx] = set()
        return idx

    def _edge(self, frm: Iterable[int], to: int) -> None:
        for f in frm:
            self.succs[f].add(to)

    def _build(self, body: List[ast.stmt]) -> None:
        exits, _breaks, _continues = self._block(body, [], loop=None)
        self.exits = exits

    def _block(
        self,
        body: List[ast.stmt],
        preds: List[int],
        loop,
    ) -> Tuple[List[int], List[int], List[int]]:
        """Wire ``body`` after ``preds``; returns (fall-through exits,
        break sources, continue sources). ``loop`` is the enclosing loop
        header's index (for back edges), or None."""
        breaks: List[int] = []
        continues: List[int] = []
        cur = list(preds)
        first = True
        for stmt in body:
            idx = self._add(stmt)
            if first and not preds:
                self.entry.append(idx)
            first = False
            self._edge(cur, idx)
            cur = [idx]
            if isinstance(stmt, ast.If):
                then_exits, b1, c1 = self._block(stmt.body, [idx], loop)
                # no orelse: building the empty block returns [idx] — the
                # fall-past-the-test path
                else_exits, b2, c2 = self._block(stmt.orelse, [idx], loop)
                breaks += b1 + b2
                continues += c1 + c2
                cur = then_exits + else_exits
            elif isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                body_exits, b, c = self._block(stmt.body, [idx], idx)
                # back edge: end of body (and every continue) re-enters
                # the header, so state flows around an iteration
                self._edge(body_exits + c, idx)
                else_exits, b2, c2 = self._block(stmt.orelse, [idx], loop)
                breaks += b2
                continues += c2
                cur = [idx] + b + (else_exits if stmt.orelse else [])
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                body_exits, b, c = self._block(stmt.body, [idx], loop)
                breaks += b
                continues += c
                cur = body_exits
            elif isinstance(stmt, ast.Try):
                body_start = len(self.stmts)
                body_exits, b, c = self._block(stmt.body, [idx], loop)
                breaks += b
                continues += c
                # any statement of the try body may raise into a handler
                handler_entries_from = [idx] + list(
                    range(body_start, len(self.stmts))
                )
                joined = list(body_exits)
                for h in stmt.handlers:
                    h_exits, b, c = self._block(
                        h.body, handler_entries_from, loop
                    )
                    breaks += b
                    continues += c
                    joined += h_exits
                else_exits, b, c = self._block(stmt.orelse, body_exits, loop)
                breaks += b
                continues += c
                if stmt.orelse:
                    joined = [e for e in joined if e not in body_exits]
                    joined += else_exits
                fin_exits, b, c = self._block(stmt.finalbody, joined, loop)
                breaks += b
                continues += c
                cur = fin_exits if stmt.finalbody else joined
            elif isinstance(stmt, (ast.Return, ast.Raise)):
                cur = []
            elif isinstance(stmt, ast.Break):
                breaks.append(idx)
                cur = []
            elif isinstance(stmt, ast.Continue):
                continues.append(idx)
                cur = []
        return cur, breaks, continues

def own_statements(fn: ast.AST) -> List[ast.stmt]:
    """Every statement in ``fn``'s own scope, nested scopes excluded."""
    out: List[ast.stmt] = []
    work = list(getattr(fn, "body", ()))
    while work:
        s = work.pop(0)
        out.append(s)
        if isinstance(s, _SCOPE_NODES):
            continue
        for field in ("body", "orelse", "finalbody"):
            work.extend(
                c for c in getattr(s, field, ())
                if not isinstance(c, _SCOPE_NODES)
            )
        for h in getattr(s, "handlers", ()):
            work.extend(h.body)
    return out


def bound_names(stmt: ast.stmt) -> Set[str]:
    """Names (re-)bound by this statement — the KILL set for per-variable
    state: assignment / aug-assign / with-as / for-target / walrus."""
    out: Set[str] = set()

    def target_names(t: ast.AST) -> None:
        for n in ast.walk(t):
            if isinstance(n, ast.Name):
                out.add(n.id)

    if isinstance(stmt, ast.Assign):
        for t in stmt.targets:
            if isinstance(t, (ast.Name, ast.Tuple, ast.List, ast.Starred)):
                target_names(t)
    elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
        if isinstance(stmt.target, ast.Name):
            out.add(stmt.target.id)
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        target_names(stmt.target)
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        for item in stmt.items:
            if item.optional_vars is not None:
                target_names(item.optional_vars)
    # walrus in the expressions evaluated AT this node (compound-statement
    # bodies are their own CFG nodes; nested scopes excluded)
    work: List[ast.AST] = list(header_expr_nodes(stmt))
    while work:
        n = work.pop()
        if isinstance(n, _SCOPE_NODES):
            continue
        if isinstance(n, ast.NamedExpr) and isinstance(n.target, ast.Name):
            out.add(n.target.id)
        work.extend(ast.iter_child_nodes(n))
    return out


def header_expr_nodes(stmt: ast.stmt) -> Iterable[ast.AST]:
    """The expression nodes evaluated *at* a statement node itself (for
    compound statements: the header only — the body is separate CFG
    nodes). Name loads inside these are 'reads at this node'."""
    if isinstance(stmt, ast.If) or isinstance(stmt, ast.While):
        yield stmt.test
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        yield stmt.iter
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        for item in stmt.items:
            yield item.context_expr
    elif isinstance(stmt, ast.Try):
        return
    else:
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                yield child


def name_loads(stmt: ast.stmt) -> List[ast.Name]:
    """Name loads evaluated at this CFG node (headers only for compound
    statements; nested scopes excluded — a closure capturing the name is
    analyzed as its own function)."""
    out: List[ast.Name] = []
    for root in header_expr_nodes(stmt):
        work = [root]
        while work:
            n = work.pop()
            if isinstance(n, _SCOPE_NODES):
                continue
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
                out.append(n)
            work.extend(ast.iter_child_nodes(n))
    return out


def may_reach(
    cfg: CFG,
    gen: Callable[[ast.stmt], Set[str]],
    kill: Callable[[ast.stmt], Set[str]],
) -> Dict[int, Set[str]]:
    """Forward may-analysis: IN[s] = ∪ OUT[p] over predecessors;
    OUT[s] = (IN[s] - KILL[s]) ∪ GEN[s]. Returns IN per statement index —
    the state *before* the statement executes (reads happen then)."""
    n = len(cfg.stmts)
    gens = [gen(s) for s in cfg.stmts]
    kills = [kill(s) for s in cfg.stmts]
    ins: Dict[int, Set[str]] = {i: set() for i in range(n)}
    outs: Dict[int, Set[str]] = {i: set() for i in range(n)}
    work = list(range(n))
    while work:
        i = work.pop(0)
        new_out = (ins[i] - kills[i]) | gens[i]
        if new_out != outs[i]:
            outs[i] = new_out
            for s in cfg.succs[i]:
                if not new_out <= ins[s]:
                    ins[s] |= new_out
                    if s not in work:
                        work.append(s)
    return ins


def functions(tree: ast.AST) -> List[ast.AST]:
    """Every function/method def in the module, nested ones included —
    each is analyzed as its own scope."""
    return [
        n
        for n in ast.walk(tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    ]
