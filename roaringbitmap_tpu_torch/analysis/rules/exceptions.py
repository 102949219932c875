"""exception-hygiene: broad catches are justified or they are bugs.

A bare ``except:`` or ``except Exception`` that swallows is how kernel
dispatch bugs hide — a diagnostics path may *deliberately* catch
everything (a flight bundle must not fail at the moment of failure), but
that judgement belongs in the source, not in anyone's memory. The rule:

* ``except:`` / ``except Exception`` / ``except BaseException`` (alone or
  in a tuple) requires ``# rb-ok: exception-hygiene <why>`` on the line
  (or the comment line above);
* a handler with a top-level ``raise`` is exempt — re-wrapping into a
  domain error (fuzz.InvarianceFailure) or cleanup-then-reraise
  (observe/export._atomic_write) is not a swallow;
* a **classify-then-route** handler is exempt: one that calls the fault
  taxonomy's ``classify(...)`` (robust/errors.py) AND contains a
  ``raise`` anywhere (the ``if classify(e) == FATAL: raise`` idiom) —
  this is the ladder's declared degradation contract;
* narrow catches (``except (ImportError, RuntimeError)``) never need a
  pragma — prefer narrowing where the error taxonomy is stable.

**Fault-site strictness**: inside a function that
contains a registered fault site (a ``fault_point(...)`` call), a raw
``except Exception`` must be the classify-then-route idiom or a top-level
re-raise — a pragma is NOT accepted there. Fault sites are exactly where
injected (and real) failures surface; a swallowing handler on such a path
would make the chaos gate's "no exception escapes the ladder" guarantee
vacuous by eating the evidence.
"""

from __future__ import annotations

import ast
from typing import Iterable

from ..core import Checker, FileContext, Finding, dotted_name, register

_BROAD = {"Exception", "BaseException"}


def _is_broad(type_node) -> bool:
    if type_node is None:
        return True  # bare except
    if isinstance(type_node, ast.Tuple):
        return any(_is_broad(el) for el in type_node.elts)
    name = dotted_name(type_node)
    return name is not None and name.rsplit(".", 1)[-1] in _BROAD


def _reraises(handler: ast.ExceptHandler) -> bool:
    # a top-level raise anywhere in the handler: both immediate re-wraps
    # (`raise Domain(...) from e`) and cleanup-then-`raise` are not swallows
    return any(isinstance(stmt, ast.Raise) for stmt in handler.body)


def _calls_named(node: ast.AST, tail: str) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            name = dotted_name(sub.func)
            if name is not None and name.rsplit(".", 1)[-1] == tail:
                return True
    return False


def _classify_routes(handler: ast.ExceptHandler) -> bool:
    """The ladder's classify-then-route idiom: the handler consults the
    fault taxonomy (``classify(...)``) and keeps a re-raise path for fatal
    classifications (a ``raise`` anywhere, including nested under the
    ``if classify(e) == FATAL`` test)."""
    if not _calls_named(handler, "classify"):
        return False
    return any(isinstance(sub, ast.Raise) for sub in ast.walk(handler))


def _fault_site_functions(tree: ast.AST):
    """Line spans of every function whose body contains a registered
    fault site (a ``fault_point(...)`` call)."""
    spans = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if _calls_named(node, "fault_point"):
                spans.append((node.lineno, node.end_lineno or node.lineno))
    return spans


@register
class ExceptionHygiene(Checker):
    rule_id = "exception-hygiene"
    description = (
        "bare/broad `except Exception` must re-raise, classify-then-route, "
        "or carry a justifying `# rb-ok: exception-hygiene` pragma "
        "(pragmas are not accepted on fault-site paths)"
    )
    severity = "error"

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        fault_spans = _fault_site_functions(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not _is_broad(node.type):
                continue
            if _reraises(node) or _classify_routes(node):
                continue
            what = (
                "bare except"
                if node.type is None
                else f"except {ast.unparse(node.type)}"
            )
            on_fault_site = any(
                lo <= node.lineno <= hi for lo, hi in fault_spans
            )
            if on_fault_site:
                # pragma-proof: yield with suppress_pragma so core's rb-ok
                # handling cannot waive it (see Checker.finding)
                yield self.finding(
                    ctx,
                    node,
                    f"{what} swallows failures inside a fault-site function "
                    f"(a fault_point() call is in scope): route through the "
                    f"taxonomy — `if classify(e) == FATAL: raise` — or "
                    f"re-raise; pragmas are not accepted on fault-site paths",
                    suppress_pragma=True,
                )
                continue
            yield self.finding(
                ctx,
                node,
                f"{what} swallows unexpected failures: narrow the type, "
                f"re-raise, classify-then-route, or justify with "
                f"`# rb-ok: {self.rule_id} <why degrading is safe>`",
            )
