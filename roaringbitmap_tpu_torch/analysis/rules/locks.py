"""lock-discipline: state annotated ``# guarded-by: <lock>`` is written
only inside a ``with <lock>:`` block (a GuardedBy-style lexical pass).

Declaration::

    _TIMINGS: Dict[str, list] = defaultdict(...)  # guarded-by: _TIMINGS_LOCK
    self._entries = OrderedDict()                 # guarded-by: self._lock
    _POOL: Optional[...] = None                   # guarded-by: _POOL_LOCK

The annotation attaches to the assignment target(s) on that line. The rule
then requires every *write* to the guarded name — assignment, augmented
assignment, subscript store, ``del``, or a call to a known mutator method
(``append``/``pop``/``clear``/``update``/``move_to_end``/...) — to sit
lexically inside a ``with`` statement whose context expression's terminal
segment matches the declared lock name (``with self._lock:``,
``with cls._POOL_LOCK:``, ...).

Exemptions (single-threaded by construction):

* the declaring line itself and module-level / class-body assignments
  (import time);
* any write inside ``__init__``/``__new__`` for instance attributes
  (construction happens-before publication);
* a bare-name assignment to a guarded module global in a function with no
  ``global`` declaration (it creates a shadowing local, not a write —
  subscript stores and mutator calls count regardless, since they mutate
  the shared object through the name).

Reads are deliberately out of scope: the codebase uses double-checked
locking (native/__init__.py) and lock-free snapshots-by-copy, which a read
check would flag wholesale. Aliasing (``st = self._series[k]; st[...] = v``)
is also out of scope — keep mutations syntactically on the guarded name.

**May-hold propagation.** A helper that writes guarded
state is legal when *every* intra-module call site holds the lock — the
classic locked-region-helper pattern that previously needed a pragma.
The rule now computes, per function, the greatest-fixpoint intersection
of the lock sets held at its call sites (``entry ⊇ ∩ site-locks ∪
caller-entry``), and a write passes when the lock is held lexically OR
at every entry. The propagation is sound in the removing direction only:
a function whose reference escapes as a value (callback, decorator,
multiple same-named defs) gets the empty entry set, so it behaves
exactly like the lexical rule.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from ..core import (
    Checker,
    FileContext,
    Finding,
    ParentedVisit,
    register,
    terminal_name,
)

_MUTATORS = {
    "append", "extend", "insert", "add", "discard", "remove", "pop",
    "popitem", "clear", "update", "setdefault", "move_to_end", "appendleft",
    "popleft", "sort", "reverse",
}
_INIT_METHODS = ("__init__", "__new__")


def _guarded_targets_on_line(
    tree: ast.AST, line: int
) -> List[Tuple[str, str]]:
    """[(kind, name)] declared by the statement at ``line``; kind is
    'global' (module-level name), 'classattr' (class-body name, written
    later as Cls.X/cls.X/self.X), or 'attr' (self./cls. attribute)."""
    out: List[Tuple[str, str]] = []

    def scan(node: ast.AST, in_class: bool) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                if child.lineno == line:
                    targets = (
                        child.targets
                        if isinstance(child, ast.Assign)
                        else [child.target]
                    )
                    for t in targets:
                        if isinstance(t, ast.Name):
                            out.append(
                                ("classattr" if in_class else "global", t.id)
                            )
                        elif isinstance(t, ast.Attribute) and isinstance(
                            t.value, ast.Name
                        ):
                            if t.value.id in ("self", "cls"):
                                out.append(("attr", t.attr))
                            else:
                                out.append(("classattr", t.attr))
            scan(child, in_class or isinstance(child, ast.ClassDef))

    scan(tree, False)
    return out


def _write_targets(node: ast.AST) -> List[ast.AST]:
    if isinstance(node, ast.Assign):
        return list(node.targets)
    if isinstance(node, ast.AugAssign):
        return [node.target]
    if isinstance(node, ast.AnnAssign):
        return [node.target] if node.value is not None else []
    if isinstance(node, ast.Delete):
        return list(node.targets)
    return []


def _match_write(
    target: ast.AST, kind: str, name: str, has_global_decl: bool
) -> bool:
    """Does this assignment target write the guarded entity?

    A bare-Name assignment to a guarded module global only counts when the
    enclosing function declares ``global <name>`` — otherwise it creates a
    shadowing local, not a write to the shared state. Subscript stores
    (``G[k] = v``) mutate the shared object regardless of scoping.
    """
    was_subscript = isinstance(target, ast.Subscript)
    while isinstance(target, ast.Subscript):
        target = target.value
    if kind == "global":
        if isinstance(target, ast.Name) and target.id == name:
            return was_subscript or has_global_decl
        return False
    if kind == "classattr":
        # written as Cls.X / cls.X / self.X (a bare name inside a function
        # is a local; the class body itself is import-time and exempt)
        return (
            isinstance(target, ast.Attribute)
            and target.attr == name
            and isinstance(target.value, ast.Name)
        )
    # kind == "attr": self.X / cls.X
    return (
        isinstance(target, ast.Attribute)
        and target.attr == name
        and isinstance(target.value, ast.Name)
        and target.value.id in ("self", "cls")
    )


def _match_mutator_call(node: ast.Call, kind: str, name: str) -> bool:
    """G.append(...) / self.X.update(...) style mutation of the guarded name."""
    if not (
        isinstance(node.func, ast.Attribute) and node.func.attr in _MUTATORS
    ):
        return False
    recv = node.func.value
    while isinstance(recv, ast.Subscript):
        recv = recv.value
    if isinstance(recv, ast.Name):
        # mutation through a bare name reaches the module global whether or
        # not `global` is declared (no rebind involved)
        return kind == "global" and recv.id == name
    if isinstance(recv, ast.Attribute):
        if recv.attr != name:
            return False
        if kind == "attr":
            return isinstance(recv.value, ast.Name) and recv.value.id in (
                "self",
                "cls",
            )
        # classattr: Cls.X.mutator(...) / cls.X.mutator(...) / self.X...
        return kind == "classattr" and isinstance(recv.value, ast.Name)
    return False


def _own_scope_nodes(fn: ast.AST):
    """Nodes in ``fn``'s own scope (nested function/class bodies excluded)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)
        ):
            continue  # new scope boundary
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _scope_info(fn: ast.AST) -> Tuple[Set[str], Set[str]]:
    """(global_decls, local_rebinds) for ``fn``'s own scope: the ``global``
    names it declares, and the bare names it assigns (which — absent a
    ``global`` declaration — are shadowing locals, so subscript stores and
    mutator calls through them never touch the module state)."""
    global_decls: Set[str] = set()
    rebinds: Set[str] = set()
    for node in _own_scope_nodes(fn):
        if isinstance(node, ast.Global):
            global_decls.update(node.names)
        elif isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            for t in targets:
                if isinstance(t, ast.Name):
                    rebinds.add(t.id)
    return global_decls, rebinds - global_decls


def _def_scopes(tree: ast.AST) -> Dict[int, Optional[ast.AST]]:
    """id(function def) -> its enclosing scope: the ClassDef whose body
    holds it, the FunctionDef it is nested in, or None (module level)."""
    out: Dict[int, Optional[ast.AST]] = {}

    def scan(node: ast.AST, scope: Optional[ast.AST]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out[id(child)] = scope
                scan(child, child)
            elif isinstance(child, ast.ClassDef):
                scan(child, child)
            else:
                scan(child, scope)

    scan(tree, None)
    return out


def _may_hold_entries(tree: ast.AST, universe: Set[str]) -> Dict[int, Set[str]]:
    """id(function node) -> locks held at EVERY intra-module call site
    (greatest-fixpoint intersection). Functions that escape as values
    (callbacks, decorators), share a name with another def, or have no
    visible call site get ∅ — the propagation only ever removes findings
    relative to the lexical rule.

    A call site counts when it is a bare ``helper(...)`` or a
    ``self._helper(...)`` / ``cls._helper(...)`` method call — the
    intra-module shapes. Anything else (``module.fn(...)``) may target a
    different module's name and is ignored. A name defined once in the
    module resolves to that def, as in the JAX package's rule; a method
    name defined in more than one class resolves, for a ``self.``/``cls.``
    call inside a class, to that class's own undecorated def when the
    class defines it once (two classes of one module may each have a
    ``_drop``)."""
    scopes = _def_scopes(tree)
    defs: Dict[str, List[ast.AST]] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(node.name, []).append(node)
    # unique, undecorated defs are propagation candidates
    by_name = {
        name: nodes[0]
        for name, nodes in defs.items()
        if len(nodes) == 1 and not nodes[0].decorator_list
    }
    # (id(class), method name) -> its def, for a name defined once in that
    # class body, undecorated, but more than once in the module
    by_method: Dict[Tuple[int, str], ast.AST] = {}
    for name, nodes in defs.items():
        if len(nodes) < 2:
            continue
        per_class: Dict[int, List[ast.AST]] = {}
        for fn in nodes:
            scope = scopes.get(id(fn))
            if isinstance(scope, ast.ClassDef):
                per_class.setdefault(id(scope), []).append(fn)
        for cid, fns in per_class.items():
            if len(fns) == 1 and not fns[0].decorator_list:
                by_method[(cid, name)] = fns[0]
    candidates = {id(fn): fn for fn in list(by_name.values()) + list(by_method.values())}

    def owner_class(fn: Optional[ast.AST]) -> Optional[ast.ClassDef]:
        while fn is not None and not isinstance(fn, ast.ClassDef):
            fn = scopes.get(id(fn))
        return fn

    def resolve(node: ast.Call, caller: Optional[ast.AST]) -> Optional[ast.AST]:
        if isinstance(node.func, ast.Name):
            return by_name.get(node.func.id)
        if isinstance(node.func, ast.Attribute) and isinstance(
            node.func.value, ast.Name
        ) and node.func.value.id in ("self", "cls"):
            name = node.func.attr
            if name in by_name:
                return by_name[name]
            cls = owner_class(caller)
            if cls is not None:
                return by_method.get((id(cls), name))
        return None

    escaped: Set[str] = set()
    # id(callee) -> [(caller node or None, lexical locks at site)]
    sites: Dict[int, List[Tuple[Optional[ast.AST], Tuple[str, ...]]]] = {}
    call_funcs = set()
    for node, locks, funcs in ParentedVisit(tree):
        if isinstance(node, ast.Call):
            call_funcs.add(id(node.func))
            caller = funcs[-1] if funcs else None
            target = resolve(node, caller)
            if target is not None:
                sites.setdefault(id(target), []).append((caller, locks))
    for node, _locks, _funcs in ParentedVisit(tree):
        # a bare reference to a candidate outside call position = escape
        # (of every def of that name)
        if (
            isinstance(node, ast.Name)
            and isinstance(node.ctx, ast.Load)
            and node.id in defs
            and id(node) not in call_funcs
        ):
            escaped.add(node.id)
        elif (
            isinstance(node, ast.Attribute)
            and isinstance(node.ctx, ast.Load)
            and node.attr in defs
            and id(node) not in call_funcs
            and isinstance(node.value, ast.Name)
            and node.value.id in ("self", "cls")
        ):
            escaped.add(node.attr)
    entry: Dict[int, Set[str]] = {}
    live = {
        fid: fn for fid, fn in candidates.items()
        if fn.name not in escaped and fid in sites
    }
    for fid in candidates:
        entry[fid] = set(universe) if fid in live else set()
    changed = True
    while changed:
        changed = False
        for fid in live:
            acc: Optional[Set[str]] = None
            for caller, locks in sites[fid]:
                held = set(locks)
                if caller is not None:
                    held |= entry.get(id(caller), set())
                acc = held if acc is None else (acc & held)
            acc = acc or set()
            if acc != entry[fid]:
                entry[fid] = acc
                changed = True
    return entry


@register
class LockDiscipline(Checker):
    rule_id = "lock-discipline"
    description = (
        "writes to `# guarded-by: <lock>` state must sit inside a "
        "`with <lock>:` block"
    )
    severity = "error"

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        if not ctx.guards:
            return
        # (kind, name) -> (lock terminal name, declaring line)
        guarded: Dict[Tuple[str, str], Tuple[str, int]] = {}
        for line, lock in ctx.guards.items():
            for kind, name in _guarded_targets_on_line(ctx.tree, line):
                guarded[(kind, name)] = (lock, line)
        if not guarded:
            return

        universe = {lock for lock, _decl in guarded.values()}
        entry_holds = _may_hold_entries(ctx.tree, universe)
        decl_cache: Dict[int, Tuple[Set[str], Set[str]]] = {}
        for node, locks, funcs in ParentedVisit(ctx.tree):
            if not funcs:
                continue  # module/class level runs at import time
            in_init = any(f.name in _INIT_METHODS for f in funcs)
            fid = id(funcs[-1])
            info = decl_cache.get(fid)
            if info is None:
                info = decl_cache[fid] = _scope_info(funcs[-1])
            global_decls, local_rebinds = info
            writes: List[Tuple[str, str, str, int]] = []
            for t in _write_targets(node):
                for (kind, name), (lock, decl) in guarded.items():
                    if decl == node.lineno:
                        continue  # the declaration itself
                    if kind == "global" and name in local_rebinds:
                        continue  # operates on the shadowing local
                    if _match_write(t, kind, name, name in global_decls):
                        writes.append((kind, name, lock, decl))
            if isinstance(node, ast.Call):
                for (kind, name), (lock, decl) in guarded.items():
                    if kind == "global" and name in local_rebinds:
                        continue
                    if _match_mutator_call(node, kind, name):
                        writes.append((kind, name, lock, decl))
            for kind, name, lock, decl in writes:
                if kind == "attr" and in_init:
                    continue  # construction happens-before publication
                if lock in locks:
                    continue
                # may-hold propagation: every intra-module call site of
                # the enclosing helper holds the lock
                if lock in entry_holds.get(id(funcs[-1]), ()):
                    continue
                yield self.finding(
                    ctx,
                    node,
                    f"write to `{name}` (guarded-by {lock}, declared "
                    f"line {decl}) outside `with {lock}:`",
                )
