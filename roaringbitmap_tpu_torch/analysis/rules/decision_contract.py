"""decision-discipline: an ``outcome=True`` decision's seq must be able
to reach a resolve/measure join.

``record_decision(site, verdict, outcome=True, ...)`` parks the decision
in the outcome ledger's pending ring and returns the join key (``seq``).
The economy only closes when something later calls
``outcomes.resolve(seq, ...)`` (or threads the seq through
``LADDER.run(..., outcome_seq=seq)``). A site that asks for an outcome
and then *drops the seq on the floor* can never be joined: every such
decision ages out of the pending ring as an orphan, silently starving
the refit loop the cost authorities depend on.

Function-scope dataflow, deliberately conservative (escape == fine):

* the call's value is discarded (an expression statement, or bound to
  ``_``) → finding;
* the seq is bound to a name that is never read anywhere else in the
  function's own scope → finding;
* any read counts as an escape — passed to a call (``resolve(seq, …)``,
  ``outcome_seq=seq``), returned, yielded, stored into an attribute or
  container. Reachability past the escape is runtime behavior.

Sites with ``outcome=False`` (or dynamic ``outcome=flag``) are exempt;
deliberate fire-and-forget outcome sites carry ``# rb-ok:
decision-discipline`` with a reason.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Tuple

from ..core import Finding, ProjectChecker, register_contract
from ..project import ProjectContext


def _enclosing_function(
    tree: ast.AST, call: ast.Call
) -> Optional[ast.AST]:
    """Innermost function def whose span contains the call."""
    best: Optional[ast.AST] = None
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if (
                node.lineno <= call.lineno
                and (node.end_lineno or node.lineno) >= (call.end_lineno or call.lineno)
            ):
                if best is None or node.lineno >= best.lineno:
                    best = node
    return best


def _own_scope_name_loads(fn: ast.AST, name: str, skip: ast.AST) -> int:
    """Load-count of ``name`` in ``fn``'s own scope AND nested scopes
    (a closure reading the seq is a legitimate escape), excluding the
    binding statement ``skip`` itself."""
    count = 0
    for node in ast.walk(fn):
        if node is skip:
            continue
        if isinstance(node, ast.Name) and node.id == name and isinstance(
            node.ctx, ast.Load
        ):
            # reads inside the binding statement itself (the call's own
            # args) don't count as a later use
            if not (
                skip.lineno <= node.lineno
                and node.lineno <= (skip.end_lineno or skip.lineno)
            ):
                count += 1
    return count


@register_contract
class DecisionDiscipline(ProjectChecker):
    rule_id = "decision-discipline"
    description = (
        "record_decision(..., outcome=True) must bind its seq and the seq "
        "must escape toward a resolve/measure join"
    )
    severity = "error"

    def check_project(self, project: ProjectContext) -> Iterable[Finding]:
        decisions_rel = project.pkg_path("observe", "decisions.py")
        for site in project.decision_sites:
            if site.outcome is not True:
                continue
            if site.path == decisions_rel:
                continue  # the recorder's own docs/plumbing
            ctx = project.files.get(site.path)
            if ctx is None:
                continue
            fn = _enclosing_function(ctx.tree, site.call)
            stmt = self._binding_statement(ctx.tree, fn, site.call)
            if stmt is None:
                continue  # call spans something exotic; don't guess
            kind, name = stmt
            if kind == "discarded":
                yield self.finding(
                    project, site.path, site.call.lineno,
                    f"outcome=True decision at site {site.site!r} discards "
                    "its seq — the pending entry can never be resolved "
                    "and will age out as an orphan",
                    end_line=site.call.end_lineno or site.call.lineno,
                )
            elif kind == "bound" and fn is not None:
                binding = self._binding_node(fn, site.call)
                if binding is not None and not _own_scope_name_loads(
                    fn, name, binding
                ):
                    yield self.finding(
                        project, site.path, site.call.lineno,
                        f"outcome=True decision at site {site.site!r} "
                        f"binds its seq to `{name}` but never reads it — "
                        "no resolve/measure path can join this decision",
                        end_line=site.call.end_lineno or site.call.lineno,
                    )

    @staticmethod
    def _binding_statement(
        tree: ast.AST, fn: Optional[ast.AST], call: ast.Call
    ) -> Optional[Tuple[str, str]]:
        """('discarded'|'bound'|'escaped', bound-name). The call escapes
        when it is nested inside any larger expression (an argument, a
        return value, a comparison) — those uses ARE the seq's use."""
        scope = fn if fn is not None else tree
        for node in ast.walk(scope):
            if isinstance(node, ast.Expr) and node.value is call:
                return ("discarded", "")
            if isinstance(node, ast.Assign) and node.value is call:
                if len(node.targets) == 1 and isinstance(
                    node.targets[0], ast.Name
                ):
                    tname = node.targets[0].id
                    if tname == "_":
                        return ("discarded", "")
                    return ("bound", tname)
                return ("escaped", "")
            if isinstance(node, ast.AnnAssign) and node.value is call:
                if isinstance(node.target, ast.Name):
                    if node.target.id == "_":
                        return ("discarded", "")
                    return ("bound", node.target.id)
                return ("escaped", "")
        return ("escaped", "")

    @staticmethod
    def _binding_node(fn: ast.AST, call: ast.Call) -> Optional[ast.stmt]:
        for node in ast.walk(fn):
            if isinstance(node, (ast.Assign, ast.AnnAssign)) and node.value is call:
                return node
        return None
