"""ProjectContext: the whole-program view behind the contract tier.

Counterpart of ``roaringbitmap_tpu/analysis/project.py``, scanning
``roaringbitmap_tpu_torch`` by default. Its extractors also see this
package's idioms: a module-private wrapper that forwards its parameter to
``fault_point`` and ``ladder.retry`` (``parallel/store._guarded``) guards
and routes the literal each call passes; authorities built as instances
of an ``Authority`` subclass (``ModelAuthority("device-breakeven",
breakeven)``) or named by a subclass's ``super().__init__`` are
authorities; the fault-exercise surface is this package's ``fuzz.py`` and
``tests/test_torch_*.py``; and :data:`fuzz.RAISING_SITES` is read as the
table of sites where the package raises instead of degrading.

The lexical tier (rules/) sees one file at a time; the contracts it
cannot see are exactly the framework's *implicit registries* — cross-file
name sets that must stay in lockstep:

* ``robust/faults.SITES`` ↔ the ``fault_point()`` guards, ladder routes,
  and fuzz/ci-chaos exercise that make a declared site real;
* ``record_decision(..., outcome=True)`` sites ↔ the ``resolve()`` joins
  that keep the decision–outcome economy honest;
* the ``cost/`` facade's ``AUTHORITIES`` ↔ the state-lifecycle protocol,
  the facade's own doc table, and the docs surface;
* ``observe/registry.py``'s ``rb_tpu_*`` name constants ↔ their
  registrations and consumers;
* ``observe/health.py``'s ``DEFAULT_RULES`` ↔ its committed docstring
  threshold table;
* ``RB_TPU_*`` env knobs ↔ the package's KNOBS.md table.

This module parses the package tree ONCE (reusing FileContext, so
pragmas/guards ride along), extracts each registry with narrow AST
walks, and hands the result to every ProjectChecker. A module-level
mtime-keyed cache makes repeated builds (the CLI, tests) free; the cache is thread-safe (tests hammer it).

Pure stdlib, like the rest of analysis/ — building a ProjectContext
never imports the framework.
"""

from __future__ import annotations

import ast
import os
import threading
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import FileContext, dotted_name, terminal_name

# package-relative anchor files for the registry extractors; a rename
# shows up as an extraction failure (empty registry), which the contract
# rules report loudly rather than passing vacuously
FAULTS_MODULE = os.path.join("robust", "faults.py")
FACADE_MODULE = os.path.join("cost", "facade.py")
REGISTRY_MODULE = os.path.join("observe", "registry.py")
HEALTH_MODULE = os.path.join("observe", "health.py")
# the table of fault sites where the package raises, classified, instead
# of degrading (the fuzz harness's RAISING_SITES)
RAISING_MODULE = "fuzz.py"
# the document that carries the package's authority inventory: its section
# of the repo README (the ``## ...`` heading that names ``<package>/``)
AUTHORITY_DOC = "README.md"

# calls that read an env knob: os.environ.get / os.getenv / environ[...]
# plus the tree's typed wrappers (_env_int / _env_float / ...)
_ENV_CALL_TERMINALS = {"get", "getenv", "pop", "setdefault"}

# the Authority protocol (cost/facade.py): a facade-registered authority
# must define every method itself — the base raises, so an inherited slot
# means save_state()/load_state() (the RB_TPU_COST_STATE lifecycle) or a
# sentinel-actuated refit would blow up at runtime on that authority
AUTHORITY_PROTOCOL = (
    "curves", "provenance", "refit_from_outcomes", "state", "load_state",
    "reset",
)


class DecisionSite:
    """One ``record_decision(...)`` call: its site literal (None when
    dynamic), whether it asked for an outcome join, and the AST call."""

    __slots__ = ("path", "line", "site", "outcome", "call")

    def __init__(self, path: str, line: int, site: Optional[str],
                 outcome: Optional[bool], call: ast.Call):
        self.path = path
        self.line = line
        self.site = site
        self.outcome = outcome  # None == non-constant expression
        self.call = call


class AuthorityInfo:
    __slots__ = ("name", "class_name", "line", "methods", "registered")

    def __init__(self, name: str, class_name: str, line: int,
                 methods: Set[str], registered: bool):
        self.name = name
        self.class_name = class_name
        self.line = line
        self.methods = methods
        self.registered = registered


class ProjectContext:
    """Parsed whole-program view: every package file's FileContext plus
    the extracted implicit registries. Build once per tree state (see
    :func:`get_project`); all fields are read-only after construction."""

    def __init__(self, root: str, package: str = "roaringbitmap_tpu_torch"):
        self.root = os.path.abspath(root)
        self.package = package
        self.files: Dict[str, FileContext] = {}
        self.parse_errors: List[str] = []
        self._text_cache: Dict[str, str] = {}
        self._text_lock = threading.Lock()
        self._parse_tree()

        # -- registries (each a narrow walk over the parsed files) --
        self.fault_sites: Dict[str, int] = {}
        self._extract_fault_sites()
        self.fault_guards: Dict[str, List[Tuple[str, int]]] = {}
        self.ladder_routes: Dict[str, List[Tuple[str, int]]] = {}
        self.decision_sites: List[DecisionSite] = []
        self.knobs: Dict[str, List[Tuple[str, int]]] = {}
        self.metric_constants: Dict[str, Tuple[str, int]] = {}
        self.metric_registrations: List[Tuple[str, int, str, Optional[str],
                                              Optional[Tuple[str, ...]]]] = []
        self.metric_const_uses: Dict[str, Set[str]] = {}
        # the constant table must exist before the use-collecting walk —
        # uses are only recorded for known constant names
        registry_ctx = self.file("observe", "registry.py")
        if registry_ctx is not None:
            self._extract_metric_constants(registry_ctx)
        self._walk_files()
        self.authorities: List[AuthorityInfo] = []
        self._extract_authorities()
        self.sentinel_rules: Dict[str, int] = {}
        self.sentinel_doc_rules: Dict[str, int] = {}
        self._extract_sentinel_rules()
        self.raising_sites: Dict[str, int] = {}
        self._extract_raising_sites()

    # ------------------------------------------------------------------
    # parsing
    # ------------------------------------------------------------------

    def _parse_tree(self) -> None:
        pkg_dir = os.path.join(self.root, self.package)
        for dirpath, dirnames, filenames in os.walk(pkg_dir):
            dirnames[:] = [
                d for d in dirnames if d not in ("__pycache__", ".git")
            ]
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fn)
                rel = os.path.relpath(path, self.root)
                try:
                    with open(path, "r", encoding="utf-8") as f:
                        source = f.read()
                    self.files[rel] = FileContext(path, source, relpath=rel)
                except (OSError, SyntaxError, ValueError) as e:
                    self.parse_errors.append(f"{rel}: {e}")

    def pkg_path(self, *parts: str) -> str:
        """Root-relative path of a package file (the files-dict key)."""
        return os.path.join(self.package, *parts)

    def file(self, *parts: str) -> Optional[FileContext]:
        return self.files.get(self.pkg_path(*parts))

    def text(self, relpath: str) -> str:
        """Raw text of any repo file (docs, scripts, tests) — the
        extractors' non-Python drift surfaces. Missing file -> ''. Cached
        per ProjectContext build (thread-safe: rules may run parallel)."""
        with self._text_lock:
            if relpath in self._text_cache:
                return self._text_cache[relpath]
        try:
            with open(os.path.join(self.root, relpath), encoding="utf-8") as f:
                content = f.read()
        except OSError:
            content = ""
        with self._text_lock:
            self._text_cache[relpath] = content
        return content

    def exercise_text(self) -> str:
        """The fault-exercise surface: the package's own fuzz harness and
        the package's own tests (``tests/test_torch_*.py``). The JAX
        package's tests exercise the JAX package's sites, not these."""
        parts = [self.text(self.pkg_path("fuzz.py"))]
        tests_dir = os.path.join(self.root, "tests")
        if os.path.isdir(tests_dir):
            for fn in sorted(os.listdir(tests_dir)):
                if fn.startswith("test_torch_") and fn.endswith(".py"):
                    parts.append(self.text(os.path.join("tests", fn)))
        return "\n".join(parts)

    def doc_section(self, relpath: str) -> str:
        """The section of a Markdown document whose ``## `` heading names
        the package directory (``<package>/``), up to the next ``## ``
        heading; '' when there is none."""
        out: List[str] = []
        inside = False
        for line in self.text(relpath).splitlines():
            if line.startswith("## "):
                inside = f"{self.package}/" in line
            if inside:
                out.append(line)
        return "\n".join(out)

    # ------------------------------------------------------------------
    # extractors
    # ------------------------------------------------------------------

    def _extract_fault_sites(self) -> None:
        """``SITES: Tuple[str, ...] = ("store.ship", ...)`` in
        robust/faults.py — each element's own line is the anchor every
        per-site contract finding (and waiver pragma) attaches to."""
        ctx = self.file("robust", "faults.py")
        if ctx is None:
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            names = [t.id for t in targets if isinstance(t, ast.Name)]
            if "SITES" not in names or node.value is None:
                continue
            if isinstance(node.value, (ast.Tuple, ast.List)):
                for elt in node.value.elts:
                    if isinstance(elt, ast.Constant) and isinstance(
                        elt.value, str
                    ):
                        self.fault_sites[elt.value] = elt.lineno
            return

    def _walk_files(self) -> None:
        """One pass over every file's AST collecting the call-shaped
        registries: fault guards, ladder routes, decision sites, env-knob
        reads, and metric constant uses. A call to a module-level
        function of the same file that forwards one of its parameters to
        ``fault_point`` (or to a ladder route) guards (or routes) the
        literal the call passes in that position."""
        for rel, ctx in self.files.items():
            in_registry = rel == self.pkg_path("observe", "registry.py")
            guard_wrappers, route_wrappers = _site_wrappers(ctx.tree)
            for node in ast.walk(ctx.tree):
                if isinstance(node, (ast.Attribute, ast.Name)):
                    t = terminal_name(node)
                    if t and t in self.metric_const_uses:
                        self.metric_const_uses[t].add(rel)
                if not isinstance(node, ast.Call):
                    continue
                func = node.func
                t = terminal_name(func)
                if isinstance(func, ast.Name) and (
                    func.id in guard_wrappers or func.id in route_wrappers
                ):
                    for table, wrappers in (
                        (self.fault_guards, guard_wrappers),
                        (self.ladder_routes, route_wrappers),
                    ):
                        if func.id in wrappers:
                            site = _str_arg(node, wrappers[func.id])
                            if site is not None:
                                table.setdefault(site, []).append(
                                    (rel, node.lineno)
                                )
                if t == "fault_point":
                    site = _str_arg(node, 0)
                    if site is not None:
                        self.fault_guards.setdefault(site, []).append(
                            (rel, node.lineno)
                        )
                elif _is_route_call(func, t):
                    site = _str_arg(node, 0)
                    if site is not None:
                        self.ladder_routes.setdefault(site, []).append(
                            (rel, node.lineno)
                        )
                elif t == "record_decision":
                    site = _str_arg(node, 0)
                    outcome: Optional[bool] = False
                    for kw in node.keywords:
                        if kw.arg == "outcome":
                            if isinstance(kw.value, ast.Constant):
                                outcome = bool(kw.value.value)
                            else:
                                outcome = None  # dynamic
                    self.decision_sites.append(
                        DecisionSite(rel, node.lineno, site, outcome, node)
                    )
                # env knob reads: os.environ.get("RB_TPU_X"),
                # os.getenv("RB_TPU_X"), _env_int("RB_TPU_X", ...), and
                # os.environ["RB_TPU_X"] is handled via Subscript below
                dn = dotted_name(func) or ""
                is_env_call = (
                    ("environ" in dn and t in _ENV_CALL_TERMINALS)
                    or t == "getenv"
                    or (t or "").startswith("_env")
                )
                if is_env_call:
                    for arg in node.args:
                        knob = _rb_knob(arg)
                        if knob is not None:
                            self.knobs.setdefault(knob, []).append(
                                (rel, arg.lineno)
                            )
                # metric registrations: counter/gauge/histogram(name, ...)
                if t in ("counter", "gauge", "histogram") and node.args:
                    self._record_registration(rel, node, in_registry)
            for node in ast.walk(ctx.tree):
                if isinstance(node, ast.Subscript) and "environ" in (
                    dotted_name(node.value) or ""
                ):
                    knob = _rb_knob(node.slice)
                    if knob is not None:
                        self.knobs.setdefault(knob, []).append(
                            (rel, node.lineno)
                        )

    def _extract_metric_constants(self, ctx: FileContext) -> None:
        for node in ast.iter_child_nodes(ctx.tree):
            if not isinstance(node, ast.Assign):
                continue
            if not (
                isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)
                and node.value.value.startswith("rb_tpu_")
            ):
                continue
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id.isupper():
                    self.metric_constants[t.id] = (
                        node.value.value, node.lineno
                    )
                    self.metric_const_uses.setdefault(t.id, set())

    def _record_registration(
        self, rel: str, node: ast.Call, in_registry: bool
    ) -> None:
        """(path, line, kind, name, labels): kind is 'const' (first arg is
        a Name/Attribute — resolved against the constant table when it
        matches), 'literal' (an inline rb_tpu_ string), or 'dynamic'."""
        first = node.args[0]
        labels: Optional[Tuple[str, ...]] = None
        label_arg = node.args[2] if len(node.args) > 2 else None
        for kw in node.keywords:
            if kw.arg in ("labelnames", "labels"):
                label_arg = kw.value
        if isinstance(label_arg, (ast.Tuple, ast.List)):
            if all(
                isinstance(e, ast.Constant) and isinstance(e.value, str)
                for e in label_arg.elts
            ):
                labels = tuple(e.value for e in label_arg.elts)
        if isinstance(first, ast.Constant) and isinstance(first.value, str):
            if first.value.startswith("rb_tpu_") and not in_registry:
                self.metric_registrations.append(
                    (rel, node.lineno, "literal", first.value, labels)
                )
        elif isinstance(first, (ast.Name, ast.Attribute)):
            const = terminal_name(first)
            self.metric_registrations.append(
                (rel, node.lineno, "const", const, labels)
            )

    def _extract_authorities(self) -> None:
        """cost/facade.py: every class deriving from ``Authority`` (directly
        or through another authority class of the module) with its name
        and protocol methods — its own plus those of its authority
        ancestors, the raising base excluded — and whether it is
        instantiated inside the ``AUTHORITIES`` literal. The name is a
        ``name`` class attribute, a literal that ``__init__`` passes up
        through ``super().__init__(...)``, or, for a class whose
        ``__init__`` assigns ``self.name`` from its first parameter, the
        literal each instantiation in ``AUTHORITIES`` passes (one
        authority per instance, anchored at the instantiation)."""
        ctx = self.file("cost", "facade.py")
        if ctx is None:
            return
        # (class name, first literal argument or None, line) per call
        registered_calls: List[Tuple[str, Optional[str], int]] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (
                    node.targets
                    if isinstance(node, ast.Assign)
                    else [node.target]
                )
                if any(
                    isinstance(t, ast.Name) and t.id == "AUTHORITIES"
                    for t in targets
                ) and node.value is not None:
                    for call in ast.walk(node.value):
                        if isinstance(call, ast.Call) and isinstance(
                            call.func, ast.Name
                        ):
                            registered_calls.append(
                                (call.func.id, _str_arg(call, 0), call.lineno)
                            )
        registered_classes = {c for c, _n, _l in registered_calls}
        classes = {
            node.name: node
            for node in ast.iter_child_nodes(ctx.tree)
            if isinstance(node, ast.ClassDef)
        }

        def ancestors(cls: ast.ClassDef, seen: Set[str]) -> Optional[List[ast.ClassDef]]:
            """The class and its authority ancestors below ``Authority``,
            nearest first; None when it does not derive from Authority."""
            bases = [terminal_name(b) for b in cls.bases]
            if "Authority" in bases:
                return [cls]
            for b in bases:
                if b in classes and b not in seen:
                    chain = ancestors(classes[b], seen | {b})
                    if chain is not None:
                        return [cls] + chain
            return None

        for node in classes.values():
            chain = ancestors(node, {node.name})
            if chain is None:
                continue
            methods: Set[str] = set()
            for c in chain:
                methods |= {
                    item.name for item in c.body
                    if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
                }
            name, name_line = _class_name_attr(node)
            if name is None:
                name, name_line = _super_init_name(node)
            if name:
                self.authorities.append(
                    AuthorityInfo(
                        name, node.name, name_line, methods,
                        node.name in registered_classes,
                    )
                )
            elif _init_names_from_param(node):
                for cname, lit, line in registered_calls:
                    if cname == node.name and lit:
                        self.authorities.append(
                            AuthorityInfo(lit, node.name, line, methods, True)
                        )

    def _extract_sentinel_rules(self) -> None:
        """observe/health.py: the ``DEFAULT_RULES`` tuple's ``Rule(...)``
        names, and the committed docstring threshold table's row names —
        the two must agree (sentinel-table-drift)."""
        ctx = self.file("observe", "health.py")
        if ctx is None:
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            if not any(
                isinstance(t, ast.Name) and t.id == "DEFAULT_RULES"
                for t in targets
            ):
                continue
            if node.value is None:
                continue
            for call in ast.walk(node.value):
                if not (
                    isinstance(call, ast.Call)
                    and terminal_name(call.func) == "Rule"
                ):
                    continue
                name = _str_arg(call, 0)
                if name is None:
                    for kw in call.keywords:
                        if kw.arg == "name" and isinstance(
                            kw.value, ast.Constant
                        ):
                            name = kw.value.value
                if name:
                    self.sentinel_rules[name] = call.lineno
        doc = ast.get_docstring(ctx.tree, clean=False) or ""
        for off, line in enumerate(doc.splitlines()):
            stripped = line.strip()
            # a table row: a rule-shaped name followed by >=2 spaces of
            # description ("costmodel-drift       geomean ...")
            parts = stripped.split()
            if (
                len(parts) >= 2
                and "  " in stripped
                and _rule_shaped(parts[0])
            ):
                # +2: docstring body starts on the line after the opener
                self.sentinel_doc_rules.setdefault(parts[0], off + 2)

    def _extract_raising_sites(self) -> None:
        """fuzz.py: the ``RAISING_SITES`` tuple — each site where the
        package raises, classified, instead of taking a ladder route."""
        ctx = self.file(RAISING_MODULE)
        if ctx is None:
            return
        for node in ast.iter_child_nodes(ctx.tree):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            if not any(
                isinstance(t, ast.Name) and t.id == "RAISING_SITES"
                for t in targets
            ) or not isinstance(node.value, (ast.Tuple, ast.List)):
                continue
            for elt in node.value.elts:
                if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                    self.raising_sites[elt.value] = elt.lineno


def _class_name_attr(cls: ast.ClassDef) -> Tuple[Optional[str], int]:
    """A ``name = "<literal>"`` class attribute and its line."""
    for item in cls.body:
        if isinstance(item, (ast.Assign, ast.AnnAssign)):
            targets = item.targets if isinstance(item, ast.Assign) else [item.target]
            if any(
                isinstance(t, ast.Name) and t.id == "name" for t in targets
            ) and isinstance(item.value, ast.Constant) and isinstance(
                item.value.value, str
            ):
                return item.value.value, item.lineno
    return None, cls.lineno


def _init_of(cls: ast.ClassDef) -> Optional[ast.FunctionDef]:
    for item in cls.body:
        if isinstance(item, ast.FunctionDef) and item.name == "__init__":
            return item
    return None


def _super_init_name(cls: ast.ClassDef) -> Tuple[Optional[str], int]:
    """The literal first argument of ``super().__init__(...)`` in the
    class's own ``__init__``, and that call's line."""
    init = _init_of(cls)
    if init is None:
        return None, cls.lineno
    for node in ast.walk(init):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "__init__"
            and isinstance(node.func.value, ast.Call)
            and terminal_name(node.func.value.func) == "super"
        ):
            name = _str_arg(node, 0)
            if name is not None:
                return name, node.lineno
    return None, cls.lineno


def _init_names_from_param(cls: ast.ClassDef) -> bool:
    """Does the class's ``__init__`` assign ``self.name`` from its first
    parameter (an instance-named authority)?"""
    init = _init_of(cls)
    if init is None or len(init.args.args) < 2:
        return False
    param = init.args.args[1].arg
    for node in ast.walk(init):
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Attribute) and t.attr == "name"
            and isinstance(t.value, ast.Name) and t.value.id == "self"
            for t in node.targets
        ) and isinstance(node.value, ast.Name) and node.value.id == param:
            return True
    return False


def _site_wrappers(tree: ast.AST) -> Tuple[Dict[str, int], Dict[str, int]]:
    """Module-level functions that forward a parameter to ``fault_point``
    (guard wrappers) or as the site of a ladder route (route wrappers):
    function name -> the parameter's position."""
    guards: Dict[str, int] = {}
    routes: Dict[str, int] = {}
    for fn in ast.iter_child_nodes(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        params = [a.arg for a in fn.args.args]
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            first = node.args[0]
            if not (isinstance(first, ast.Name) and first.id in params):
                continue
            t = terminal_name(node.func)
            if t == "fault_point":
                guards[fn.name] = params.index(first.id)
            elif _is_route_call(node.func, t):
                routes[fn.name] = params.index(first.id)
    return guards, routes


def _is_route_call(func: ast.AST, t: Optional[str]) -> bool:
    """``LADDER.run(site, ...)`` / ``LADDER.note_degrade(site, ...)`` /
    ``ladder.retry(site, ...)``: the degradation routes."""
    if t not in ("run", "note_degrade", "retry"):
        return False
    recv = _receiver_terminal(func)
    return recv in ("LADDER", "ladder", "_ladder") or (
        t == "retry" and recv in ("ladder", "_ladder", None)
    )


def _rule_shaped(word: str) -> bool:
    return (
        "-" in word
        and word.replace("-", "").isalnum()
        and word == word.lower()
        and not word.startswith("rb")
    )


def _str_arg(call: ast.Call, idx: int) -> Optional[str]:
    if len(call.args) > idx and isinstance(call.args[idx], ast.Constant):
        v = call.args[idx].value
        if isinstance(v, str):
            return v
    return None


def _receiver_terminal(func: ast.AST) -> Optional[str]:
    if isinstance(func, ast.Attribute):
        return terminal_name(func.value)
    return None


def _rb_knob(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        v = node.value
        if v.startswith("RB_TPU_") and v.replace("_", "").isalnum():
            return v
    return None


# ---------------------------------------------------------------------------
# build cache: (root, package) -> (stamp, ProjectContext)
# ---------------------------------------------------------------------------

_CACHE_LOCK = threading.Lock()
_CACHE: Dict[Tuple[str, str], Tuple[Tuple, ProjectContext]] = {}


def _tree_stamp(root: str, package: str) -> Tuple:
    """(path, mtime_ns, size) for every package .py file — cheap enough
    to recompute per call, and any edit (or add/remove) changes it."""
    out = []
    pkg_dir = os.path.join(root, package)
    for dirpath, dirnames, filenames in os.walk(pkg_dir):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__", ".git")]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                p = os.path.join(dirpath, fn)
                try:
                    st = os.stat(p)
                    out.append((p, st.st_mtime_ns, st.st_size))
                except OSError:
                    out.append((p, -1, -1))
    return tuple(out)


def get_project(root: str, package: str = "roaringbitmap_tpu_torch") -> ProjectContext:
    """Cached ProjectContext for the tree rooted at ``root``: reused while
    no package file's (mtime, size) changes, rebuilt otherwise. Safe to
    call from concurrent threads — a stale double-build races benignly
    (last writer wins; both are equivalent)."""
    root = os.path.abspath(root)
    key = (root, package)
    stamp = _tree_stamp(root, package)
    with _CACHE_LOCK:
        hit = _CACHE.get(key)
        if hit is not None and hit[0] == stamp:
            return hit[1]
    project = ProjectContext(root, package=package)
    with _CACHE_LOCK:
        _CACHE[key] = (stamp, project)
    return project


def invalidate_cache() -> None:
    with _CACHE_LOCK:
        _CACHE.clear()
