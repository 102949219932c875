"""AST-based static analysis framework.

The reference repo gates every push on static analysis next to its test
matrix (.github/workflows/java-all-versions.yml); this package is the
project-native equivalent: a small checker registry walking ``ast`` with a
per-file context, emitting findings with ``file:line``, severity, and rule
ids. The rules (analysis/rules/) encode invariants that otherwise live in
people's heads — container payloads stay unsigned, guarded state is
written under its lock, broad excepts are justified, metric names follow
the ``rb_tpu_`` convention.

Suppression pragmas::

    some_code()  # rb-ok: <rule-id>[, <rule-id>] -- <justification>

on the offending line, or on a comment-only line directly above it.
File-level directives (``# rb-payload-path``) opt a file into path-scoped
rules. ``# guarded-by: <lock>`` on an assignment declares lock discipline
for that target (rules/locks.py).

Pure stdlib (ast/tokenize/hashlib) — running the analyzer never imports
torch or numpy.
"""

from __future__ import annotations

import ast
import hashlib
import io
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple

SEVERITIES = ("error", "warning")

# rb-ok: rule-a, rule-b -- reason   (reason separator: --, —, or :)
_PRAGMA_RE = re.compile(
    r"#\s*rb-ok:\s*(?P<rules>[a-z0-9-]+(?:\s*,\s*[a-z0-9-]+)*)"
    r"(?:\s*(?:--|—|:)\s*(?P<reason>.*\S))?"
)
_DIRECTIVE_RE = re.compile(r"#\s*rb-(?P<name>payload-path)\b")
_GUARDED_BY_RE = re.compile(r"#\s*guarded-by:\s*(?P<lock>[A-Za-z_][\w.]*)")


@dataclass(frozen=True)
class Finding:
    """One rule violation, pinned to file:line. ``end_line`` bounds the
    offending construct's physical span, so a pragma on any of its lines
    (a continuation line of a wrapped call, say) suppresses it."""

    rule: str
    path: str  # scan-root-relative when under the root, else as given
    line: int
    col: int
    severity: str
    message: str
    snippet: str = ""
    end_line: int = 0  # 0 -> same as line
    # pragma-proof findings ignore `# rb-ok:` suppression: rules use this
    # where a pragma would waive a contract the rule exists to enforce
    # (exception-hygiene's fault-site strictness)
    pragma_proof: bool = False

    def render(self) -> str:
        return (
            f"{self.path}:{self.line}:{self.col}: "
            f"{self.rule} [{self.severity}] {self.message}"
        )

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "severity": self.severity,
            "message": self.message,
            "snippet": self.snippet,
        }


def fingerprints(findings: Sequence[Finding]) -> List[str]:
    """Stable ids for baselining: hash of (rule, path, offending line text,
    occurrence index) — independent of line *numbers*, so unrelated edits
    above a baselined finding don't churn the baseline."""
    seen: Dict[Tuple[str, str, str], int] = {}
    out = []
    for f in findings:
        key = (f.rule, f.path, f.snippet.strip())
        k = seen.get(key, 0)
        seen[key] = k + 1
        raw = f"{f.rule}|{f.path}|{f.snippet.strip()}|{k}"
        out.append(hashlib.sha1(raw.encode("utf-8")).hexdigest()[:16])
    return out


class FileContext:
    """Parsed view of one source file shared by every checker: AST, raw
    lines, pragma map, file directives, and guarded-by annotations."""

    def __init__(self, path: str, source: str, relpath: Optional[str] = None):
        self.path = path
        self.relpath = relpath if relpath is not None else path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        # line -> set of rule ids suppressed there
        self.pragmas: Dict[int, Set[str]] = {}
        self.directives: Set[str] = set()
        # line -> lock name (terminal segment) declared via # guarded-by:
        self.guards: Dict[int, str] = {}
        self._scan_comments()

    def _scan_comments(self) -> None:
        try:
            tokens = tokenize.generate_tokens(io.StringIO(self.source).readline)
            comments = [
                (tok.start[0], tok.start[1], tok.string)
                for tok in tokens
                if tok.type == tokenize.COMMENT
            ]
        except (tokenize.TokenError, IndentationError):
            comments = [
                (i + 1, line.index("#"), line[line.index("#") :])
                for i, line in enumerate(self.lines)
                if "#" in line
            ]
        for lineno, col, text in comments:
            m = _PRAGMA_RE.search(text)
            if m:
                rules = {r.strip() for r in m.group("rules").split(",")}
                self.pragmas.setdefault(lineno, set()).update(rules)
                # a comment-only pragma covers the next *code* line (a
                # justification may continue over several comment lines)
                if self.lines[lineno - 1].lstrip().startswith("#"):
                    nxt = lineno + 1
                    while nxt <= len(self.lines) and (
                        not self.lines[nxt - 1].strip()
                        or self.lines[nxt - 1].lstrip().startswith("#")
                    ):
                        self.pragmas.setdefault(nxt, set()).update(rules)
                        nxt += 1
                    self.pragmas.setdefault(nxt, set()).update(rules)
            d = _DIRECTIVE_RE.search(text)
            if d:
                self.directives.add(d.group("name"))
            g = _GUARDED_BY_RE.search(text)
            if g:
                # terminal segment: "self._lock" and "_lock" both key "_lock"
                self.guards[lineno] = g.group("lock").rsplit(".", 1)[-1]

    def has_directive(self, name: str) -> bool:
        return name in self.directives

    def suppressed(self, rule: str, line: int, end_line: int = 0) -> bool:
        """Pragma present on any physical line of [line, end_line]?"""
        for ln in range(line, max(end_line, line) + 1):
            if rule in self.pragmas.get(ln, ()):
                return True
        return False

    def line_text(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1]
        return ""


class Checker:
    """One rule. Subclasses set ``rule_id``/``description``/``severity``
    and implement ``check(ctx) -> iterable of (line, col, message)`` or
    yield full Findings via :meth:`finding`."""

    rule_id: str = "abstract"
    description: str = ""
    severity: str = "error"

    def finding(self, ctx: FileContext, node_or_line, message: str, col: int = 0,
                suppress_pragma: bool = False):
        if isinstance(node_or_line, int):
            line = end = node_or_line
        else:
            node = node_or_line
            line, col = node.lineno, node.col_offset
            # pragma span: the construct's own lines — but for block
            # statements only the header (test/iter/except clause), never
            # the body, else a pragma deep inside an `if` would suppress it
            if isinstance(node, (ast.If, ast.While)):
                end = getattr(node.test, "end_lineno", line)
            elif isinstance(node, ast.For):
                end = getattr(node.iter, "end_lineno", line)
            elif isinstance(node, ast.ExceptHandler):
                # the clause header only (a wrapped type tuple), not the body
                end = (
                    getattr(node.type, "end_lineno", line)
                    if node.type is not None
                    else line
                )
            elif isinstance(node, (ast.FunctionDef, ast.With)):
                end = line
            else:
                end = getattr(node, "end_lineno", line) or line
        return Finding(
            rule=self.rule_id,
            path=ctx.relpath,
            line=line,
            col=col,
            severity=self.severity,
            message=message,
            snippet=ctx.line_text(line).strip(),
            end_line=end,
            pragma_proof=suppress_pragma,
        )

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        raise NotImplementedError


class ProjectChecker:
    """One whole-program contract rule. Unlike :class:`Checker`,
    which sees one file, a ProjectChecker receives the
    :class:`~roaringbitmap_tpu.analysis.project.ProjectContext` — the full
    parsed tree plus the extracted implicit registries — and emits findings
    anchored to whatever file each contract leg lives in. Pragma
    suppression works exactly like the lexical tier: a finding anchored at
    ``path:line`` is waived by ``# rb-ok: <rule>`` on that line (the
    anchored file's FileContext carries the pragma map)."""

    rule_id: str = "abstract-contract"
    description: str = ""
    severity: str = "error"

    def finding(self, project, path: str, line: int, message: str,
                col: int = 0, end_line: int = 0,
                suppress_pragma: bool = False) -> Finding:
        ctx = project.files.get(path)
        snippet = ctx.line_text(line).strip() if ctx is not None else ""
        return Finding(
            rule=self.rule_id,
            path=path,
            line=line,
            col=col,
            severity=self.severity,
            message=message,
            snippet=snippet,
            end_line=end_line or line,
            pragma_proof=suppress_pragma,
        )

    def check_project(self, project) -> Iterable[Finding]:
        raise NotImplementedError


# rule-id -> checker class; rules/__init__.py populates this at import
CHECKERS: Dict[str, type] = {}
# rule-id -> ProjectChecker class (the contract tier)
CONTRACT_CHECKERS: Dict[str, type] = {}


def register(cls: type) -> type:
    """Class decorator adding a Checker to the global registry."""
    if cls.rule_id in CHECKERS and CHECKERS[cls.rule_id] is not cls:
        raise ValueError(f"duplicate rule id {cls.rule_id!r}")
    CHECKERS[cls.rule_id] = cls
    return cls


def register_contract(cls: type) -> type:
    """Class decorator adding a ProjectChecker to the contract registry.
    The two tiers share one rule-id namespace so ``--rules`` selection and
    the per-rule findings counter stay unambiguous."""
    if cls.rule_id in CONTRACT_CHECKERS and CONTRACT_CHECKERS[cls.rule_id] is not cls:
        raise ValueError(f"duplicate contract rule id {cls.rule_id!r}")
    if cls.rule_id in CHECKERS:
        raise ValueError(
            f"contract rule id {cls.rule_id!r} collides with a lexical rule"
        )
    CONTRACT_CHECKERS[cls.rule_id] = cls
    return cls


def all_rule_ids() -> List[str]:
    _load_rules()
    return sorted(CHECKERS)


def all_contract_rule_ids() -> List[str]:
    _load_rules()
    return sorted(CONTRACT_CHECKERS)


def _load_rules() -> None:
    # import side effect populates CHECKERS; lazy so core stays importable
    # standalone (the CLI bootstraps through here)
    from . import rules as _rules  # noqa: F401


def iter_python_files(paths: Sequence[str]) -> List[str]:
    """Expand files/directories to a sorted list of .py files.

    A path that does not exist or names a non-.py file is a ValueError —
    silently scanning nothing would turn a typo'd CI invocation into a
    vacuously green gate."""
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [
                    d for d in dirnames if d not in ("__pycache__", ".git")
                ]
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        out.append(os.path.join(dirpath, fn))
        elif os.path.isfile(p) and p.endswith(".py"):
            out.append(p)
        else:
            raise ValueError(f"not a directory or .py file: {p}")
    return sorted(dict.fromkeys(out))


@dataclass
class RunResult:
    findings: List[Finding] = field(default_factory=list)
    suppressed: int = 0  # pragma-suppressed count
    files: int = 0
    parse_errors: List[str] = field(default_factory=list)


def run_checks(
    paths: Sequence[str],
    rules: Optional[Sequence[str]] = None,
    root: Optional[str] = None,
) -> RunResult:
    """Run the selected rules (default: all registered) over ``paths``.

    ``root`` anchors reported paths (and therefore baseline fingerprints);
    defaults to the current directory.
    """
    _load_rules()
    wanted = list(rules) if rules else sorted(CHECKERS)
    unknown = [r for r in wanted if r not in CHECKERS]
    if unknown:
        raise ValueError(f"unknown rule(s) {unknown}; known: {sorted(CHECKERS)}")
    checkers = [CHECKERS[r]() for r in wanted]
    base = os.path.abspath(root or os.getcwd())
    result = RunResult()
    for path in iter_python_files(paths):
        ap = os.path.abspath(path)
        rel = os.path.relpath(ap, base) if ap.startswith(base + os.sep) else path
        try:
            with open(path, "r", encoding="utf-8") as f:
                source = f.read()
            ctx = FileContext(path, source, relpath=rel)
        except (OSError, SyntaxError, ValueError) as e:
            result.parse_errors.append(f"{rel}: {e}")
            continue
        result.files += 1
        for checker in checkers:
            for f in checker.check(ctx):
                if not f.pragma_proof and ctx.suppressed(f.rule, f.line, f.end_line):
                    result.suppressed += 1
                else:
                    result.findings.append(f)
    result.findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return result


def run_contract_checks(
    project,
    rules: Optional[Sequence[str]] = None,
) -> RunResult:
    """Run the contract tier (default: every registered ProjectChecker)
    over an already-built ProjectContext. Pragma suppression consults the
    FileContext of whatever file each finding is anchored in, so the two
    tiers share one waiver mechanism (and one baseline format)."""
    _load_rules()
    wanted = list(rules) if rules else sorted(CONTRACT_CHECKERS)
    unknown = [r for r in wanted if r not in CONTRACT_CHECKERS]
    if unknown:
        raise ValueError(
            f"unknown contract rule(s) {unknown}; known: {sorted(CONTRACT_CHECKERS)}"
        )
    result = RunResult(files=len(project.files))
    result.parse_errors.extend(project.parse_errors)
    for rid in wanted:
        checker = CONTRACT_CHECKERS[rid]()
        for f in checker.check_project(project):
            ctx = project.files.get(f.path)
            if (
                ctx is not None
                and not f.pragma_proof
                and ctx.suppressed(f.rule, f.line, f.end_line)
            ):
                result.suppressed += 1
            else:
                result.findings.append(f)
    result.findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return result


# ---------------------------------------------------------------------------
# shared AST helpers used by several rules
# ---------------------------------------------------------------------------


def dotted_name(node: ast.AST) -> Optional[str]:
    """'a.b.c' for nested Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def terminal_name(node: ast.AST) -> Optional[str]:
    """Last segment of a Name/Attribute chain ('cls._POOL_LOCK' -> '_POOL_LOCK')."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


class ParentedVisit:
    """Iterative walk yielding (node, with_lock_stack, func_stack) — the
    lexical context several rules need (enclosing ``with`` lock names and
    enclosing function defs)."""

    def __init__(self, tree: ast.AST):
        self.tree = tree

    def __iter__(self):
        # stack entries: (node, locks_tuple, funcs_tuple)
        stack = [(self.tree, (), ())]
        while stack:
            node, locks, funcs = stack.pop()
            yield node, locks, funcs
            child_locks, child_funcs = locks, funcs
            if isinstance(node, (ast.With, ast.AsyncWith)):
                names = tuple(
                    t for t in (terminal_name(i.context_expr) for i in node.items) if t
                )
                child_locks = locks + names
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                child_funcs = funcs + (node,)
            for child in ast.iter_child_nodes(node):
                stack.append((child, child_locks, child_funcs))
