"""epoch-pin: query execution on serve/ request paths happens inside an
``EpochStore.reader()`` pin.

The epoch ledger's snapshot-isolation guarantee holds only when
a request's device-word reads are bracketed by a reader ticket — the pin
fixes the epoch for the whole execution, so a concurrent flip can't
hand one request bits from two lineage records. The harness does this
with::

    pin = (self.epoch_store.reader() if ... else contextlib.nullcontext())
    with pin as tk:
        out = executor.submit(req.expr).result()   # or _exec.execute(...)

This rule finds every execution-shaped call in ``serve/`` files — a call
whose terminal name is ``execute``, or ``submit`` on an executor — and
requires it to sit lexically inside a ``with`` statement whose context
expression *is* (or traces, through its reaching assignment in the same
function, to) a ``.reader(...)`` call. The ``nullcontext`` branch of the
conditional-pin idiom passes because the reaching assignment's RHS
contains the reader call on one branch — exactly the dynamic contract
(no store → nothing to pin).

Deliberately unpinned paths — the serial oracles that replay a schedule
against a quiesced corpus — carry ``# rb-ok: epoch-pin`` with the
justification.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, List, Optional, Set

from ..core import Finding, ProjectChecker, register_contract, terminal_name
from ..project import ProjectContext

# executor-shaped receivers for .submit(): the serve tier's execution
# pools — NOT the ingest log's submit (epoch_store.submit is the write
# path; writes go through the flip, not a reader pin)
_SUBMIT_RECEIVERS = {"executor", "_executor", "pool", "_pool"}


def _contains_reader_call(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Call) and terminal_name(n.func) == "reader":
            return True
    return False


class _FunctionScan:
    """Lexical with-stack walk of one function, resolving Name context
    expressions through their latest preceding assignment."""

    def __init__(self, fn: ast.AST):
        self.fn = fn
        # name -> lines of assignments whose RHS contains .reader(...)
        self.reader_assigns: Dict[str, List[int]] = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and _contains_reader_call(
                node.value
            ):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.reader_assigns.setdefault(t.id, []).append(
                            node.lineno
                        )

    def pin_satisfied(self, item: ast.withitem, at_line: int) -> bool:
        expr = item.context_expr
        if _contains_reader_call(expr):
            return True
        if isinstance(expr, ast.Name):
            return any(
                line < at_line
                for line in self.reader_assigns.get(expr.id, ())
            )
        return False


@register_contract
class EpochPin(ProjectChecker):
    rule_id = "epoch-pin"
    description = (
        "serve/ execution calls sit inside an EpochStore.reader() pin "
        "(or a justified annotation)"
    )
    severity = "error"

    def check_project(self, project: ProjectContext) -> Iterable[Finding]:
        prefix = project.pkg_path("serve") + os.sep
        for rel, ctx in sorted(project.files.items()):
            if not rel.startswith(prefix):
                continue
            yield from self._check_file(project, rel, ctx.tree)

    def _check_file(
        self, project: ProjectContext, rel: str, tree: ast.AST
    ) -> Iterable[Finding]:
        # walk with an explicit (node, with-items-stack, fn) stack so the
        # enclosing with *statements* (not just lock names) are visible
        for fn in [
            n
            for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]:
            scan: Optional[_FunctionScan] = None
            stack = [(child, ()) for child in ast.iter_child_nodes(fn)]
            while stack:
                node, withs = stack.pop()
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue  # nested defs walk as their own fn
                child_withs = withs
                if isinstance(node, (ast.With, ast.AsyncWith)):
                    child_withs = withs + tuple(node.items)
                for child in ast.iter_child_nodes(node):
                    stack.append((child, child_withs))
                if not isinstance(node, ast.Call):
                    continue
                if not self._is_execution_call(node):
                    continue
                if scan is None:
                    scan = _FunctionScan(fn)
                if any(
                    scan.pin_satisfied(item, node.lineno) for item in withs
                ):
                    continue
                yield self.finding(
                    project, rel, node.lineno,
                    "execution call on a serve/ path outside an "
                    "EpochStore.reader() pin — a concurrent epoch flip "
                    "can tear this read across lineage records; pin it "
                    "or annotate the oracle with a justified pragma",
                    col=node.col_offset,
                    end_line=node.end_lineno or node.lineno,
                )

    @staticmethod
    def _is_execution_call(node: ast.Call) -> bool:
        t = terminal_name(node.func)
        if t == "execute":
            return True
        if t == "submit" and isinstance(node.func, ast.Attribute):
            recv = terminal_name(node.func.value)
            return recv in _SUBMIT_RECEIVERS
        return False
