"""metric-naming: every metric registered through observe/ uses the
``rb_tpu_`` prefix with a declared (literal) label set.

The registry's convention (observe/registry.py) is ``rb_tpu_<layer>_<name>``
so a Prometheus scrape of a fleet is groupable by layer; a stray prefix or
a computed label tuple silently forks the namespace. Checked per
registration call (``observe.counter(...)`` / ``_observe.gauge(...)`` /
``_registry.histogram(...)`` / ``observe.latency_histogram(...)`` /
``REGISTRY.counter(...)``):

* a literal name must start with ``rb_tpu_``;
* an ALL_CAPS constant reference is accepted when it is either defined in
  another scanned module (the canonical-name block in registry.py, which
  this rule validates directly via the constant check below) or resolves
  in-file to a compliant literal;
* a computed name (f-string, concatenation, lowercase variable) is flagged
  — metric names are declared, not built;
* ``labelnames`` (3rd positional or keyword) must be a literal tuple/list
  of string literals (or absent);
* any module-level ``ALL_CAPS = "rb..."`` string constant must start with
  ``rb_tpu_`` (this is what validates registry.py's canonical names);
* **latency histograms** (``latency_histogram(...)``) measure
  seconds and must carry the ``_seconds`` unit suffix — a literal or
  in-file constant is validated directly, a cross-module constant must be
  ``*_SECONDS``-shaped so the defining module's check covers it;
* **enum gauges**: ``_state``/``_status`` join the recognised
  unit suffixes — an integer level from a declared enum (the health
  sentinel's ``rb_tpu_health_status`` 0/1/2 = green/yellow/red and
  ``rb_tpu_health_rule_state{rule}`` 0/1/2 = ok/warn/critical), so their
  cross-module constants validate like the other shaped names.

**Label-value cardinality**: metric *mutations* on module-level
metric constants (``_FOO_TOTAL.inc(1, (value,))`` / ``.observe`` /
``.set`` / ``.dec``) must not pass unbounded-cardinality label values —
a trace id, fingerprint, or raw container key as a label value mints a
new time series per query and melts any scrape backend. Each element of
a literal label tuple must be:

* a string literal, or
* a subscript of an in-file ALL_CAPS constant collection
  (``CLASS_NAMES[ci]`` — a member of a frozen declared set), or
* a name/attribute whose terminal identifier does NOT read as an
  unbounded value (``trace``/``fingerprint``/``uid``/``hash``/``key``/
  ... — see ``_UNBOUNDED``); benign enumerator names (``kind``, ``op``,
  ``site``, ``tier``) pass, pinned by false-positive fixtures.

f-strings, string concatenation, and call results (``bm.fingerprint()``)
are computed values and always flagged (``str(name)`` of a benign name is
the one exemption — it stringifies, it does not fabricate). Unbounded
values belong on flight-recorder events and decision-log entries, which
are bounded rings. A labels argument that is itself a variable is out of
lexical scope, like aliasing in lock-discipline.

**Tenant label values**: a tenant name is user-controlled
input — the serving tier's ``{tenant, phase}`` label sets stay bounded
only because every tenant label value resolves through the capacity-
bounded DECLARED tenant registry (``serve/slo.py`` ``TENANTS``), spelt
as the ``TENANTS[tenant]`` subscript (the declared-collection escape
above). A bare ``tenant``-shaped name in a label tuple is flagged with
its own message pointing at the registry; fixtures pin both directions.

**Epoch label values**: epoch ids advance forever — one
series per flip is the same cardinality melt as a series per trace. An
``epoch``-shaped name in a label tuple is flagged with its own message:
the current epoch is a gauge VALUE (``rb_tpu_serve_epoch_count``) and
lineage lives in the epoch ledger / trace / decision attrs. Flip STAGE
labels (``drain``/``repack``/``publish``/``reclaim``) are a declared
frozen set and pass; fixtures pin both directions.

**Container-format label values**: the structure census
gauge (``rb_tpu_structure_containers{format}``) labels by container
format — a set closed by construction (array | bitmap | run), but only
while every label value resolves through the DECLARED frozen format set
(``observe/structure.py`` ``FORMATS``), spelt as the ``FORMATS[fmt]``
subscript. A bare ``format``-shaped name in a label tuple is flagged
with its own message pointing at the declared set; the ``_containers``
census suffix joins the recognised unit suffixes so the cross-module
``STRUCTURE_CONTAINERS`` constant validates like the other shaped
names. Fixtures pin both directions.

Forwarding wrappers (a call whose name argument is the enclosing
function's own ``name`` parameter, e.g. the module-level ``counter()``
helpers in registry.py) are exempt — the real declaration is at their
call sites.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, Optional, Set

from ..core import Checker, FileContext, Finding, dotted_name, register

PREFIX = "rb_tpu_"
_REG_METHODS = {"counter", "gauge", "histogram", "latency_histogram"}
# registration methods whose metrics measure seconds (unit suffix required)
_SECONDS_METHODS = {"latency_histogram"}
# metric mutation methods whose label values are cardinality-checked
_MUT_METHODS = {"inc", "dec", "set", "observe"}
# receivers checked for mutations: module-level metric constants
# (optionally underscore-private), the registration convention throughout
_METRIC_CONST = re.compile(r"^_?[A-Z][A-Z0-9_]*$")
# identifier fragments that read as unbounded-cardinality values: one per
# query / operand / container, never a closed enumeration. Word-bounded so
# benign enumerators (kind, op, site, tier, stage, route, state) pass.
_UNBOUNDED = re.compile(
    r"(^|_)(trace|traceid|span_id|fingerprint|fingerprints|fp|fps|uid|"
    r"uuid|digest|hash|hashes|token|key|keys|qid|query_id|request_id|"
    r"id)(_|$)"
)
# tenant-valued identifiers: a tenant name is user-controlled
# input, so a bare `tenant` variable in a label tuple is the same
# unbounded-cardinality bug as a trace id — tenant label values must come
# from the bounded DECLARED tenant registry (serve/slo.py TENANTS), spelt
# as the `TENANTS[tenant]` subscript the declared-collection escape below
# already accepts (false-positive fixtures in tests/test_analysis.py)
_TENANT_VALUE = re.compile(r"(^|_)(tenant|tenants|tenant_name)(_|$)")
# epoch-valued identifiers: epoch ids advance forever — one
# series per flip melts the scrape backend exactly like a trace id. The
# current epoch is exported as a gauge VALUE (rb_tpu_serve_epoch_count);
# lineage lives in the epoch ledger and trace/decision attrs, never in
# label sets (false-positive fixtures pin flip-STAGE labels, which are a
# declared frozen set and fine)
_EPOCH_VALUE = re.compile(r"(^|_)(epoch|epochs|epoch_id|epoch_gen)(_|$)")
# container-format identifiers: the structure census gauge
# (rb_tpu_structure_containers{format}) labels by container format. The
# format set is closed by construction (Chambi et al.: array | bitmap |
# run) but only as long as every label value resolves through the
# DECLARED frozen format set (observe/structure.py FORMATS) — a bare
# `fmt` variable carrying Container.TYPE would silently mint a series
# for any future/typo'd format string, so it is flagged like a bare
# tenant name: spell it FORMATS[fmt] (false-positive fixtures pin
# literal "run"/"array" labels, which are declared and fine)
_FORMAT_VALUE = re.compile(r"(^|_)(format|formats|fmt|container_format)(_|$)")
_ALL_CAPS = re.compile(r"^[A-Z][A-Z0-9_]*$")
# constant names that read as canonical metric names (unit-suffixed; RATIO
# is the dimensionless gauge unit — e.g. rb_tpu_store_overlap_ratio;
# STATE/STATUS are the enum-gauge suffixes — an integer level
# from a declared enum, e.g. rb_tpu_health_status 0/1/2 = green/yellow/red
# and rb_tpu_health_rule_state{rule} 0/1/2 = ok/warn/critical; QPS is the
# serving tier's requests-per-second gauge unit —
# rb_tpu_serve_qps{tenant}; CONTAINERS is the structure observatory's
# census-gauge unit — rb_tpu_structure_containers{format}, a
# live-object count by declared format)
_SHAPED_CONST = re.compile(
    r"^[A-Z][A-Z0-9_]*_(TOTAL|SECONDS|BYTES|COUNT|RATIO|STATE|STATUS|QPS|"
    r"CONTAINERS)$"
)


def _literal_label_tuple(node: ast.AST) -> bool:
    if isinstance(node, (ast.Tuple, ast.List)):
        return all(
            isinstance(el, ast.Constant) and isinstance(el.value, str)
            for el in node.elts
        )
    # () default shows up as an empty tuple; a lone string is a caller bug
    # the registry itself rejects, not a naming issue
    return False


def _function_spans(tree: ast.AST):
    """[(lineno, end_lineno, param-name set)] for every def, computed once
    per file (the per-call lookup below is then a linear scan of defs, not
    a full-tree walk)."""
    spans = []
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef):
            a = node.args
            names = {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs}
            for star in (a.vararg, a.kwarg):
                if star is not None:
                    names.add(star.arg)
            spans.append((node.lineno, node.end_lineno or node.lineno, names))
    return spans


def _enclosing_function_params(spans, call: ast.Call) -> Set[str]:
    best = None
    for lineno, end, names in spans:
        if lineno <= call.lineno <= end and (best is None or lineno >= best[0]):
            best = (lineno, names)
    return best[1] if best else set()


@register
class MetricNaming(Checker):
    rule_id = "metric-naming"
    description = (
        "metrics registered via observe/ use the rb_tpu_ prefix with "
        "declared literal label sets"
    )
    severity = "error"

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        # module-level ALL_CAPS string constants (the canonical-name block)
        constants: Dict[str, str] = {}
        for node in ctx.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t = node.targets[0]
                if (
                    isinstance(t, ast.Name)
                    and _ALL_CAPS.match(t.id)
                    and isinstance(node.value, ast.Constant)
                    and isinstance(node.value.value, str)
                ):
                    constants[t.id] = node.value.value
                    v = node.value.value
                    # a constant is metric-name-shaped when its VALUE
                    # carries the rb prefix / a Prometheus unit suffix, or
                    # its NAME does (SPAN_SECONDS etc.) — the name-shape
                    # half pairs with the use-site rule below: cross-module
                    # references are only accepted for shaped names, and
                    # shaped names are validated here where they're defined
                    looks_like_metric = (
                        v.startswith("rb")
                        or re.search(
                            r"_(total|seconds|bytes|count|ratio|state|"
                            r"status|qps|containers)$",
                            v,
                        )
                        or _SHAPED_CONST.match(t.id)
                    )
                    if looks_like_metric and not v.startswith(PREFIX):
                        yield self.finding(
                            ctx,
                            node,
                            f"metric-name constant {t.id} = {v!r} does not "
                            f"use the {PREFIX!r} prefix",
                        )

        spans = _function_spans(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            fname = dotted_name(node.func)
            if fname is None:
                continue
            tail = fname.rsplit(".", 1)[-1]
            if tail in _MUT_METHODS:
                yield from self._check_label_values(ctx, node, tail)
            if tail not in _REG_METHODS:
                continue
            # registration needs at least the name argument
            if not node.args and not any(k.arg == "name" for k in node.keywords):
                continue
            name_arg = node.args[0] if node.args else next(
                k.value for k in node.keywords if k.arg == "name"
            )
            # forwarding wrapper: counter(name, ...) inside def counter(name,
            # ...) — including the star form, counter(*args, **kw)
            fwd = name_arg.value if isinstance(name_arg, ast.Starred) else name_arg
            if (
                isinstance(fwd, ast.Name)
                and fwd.id in _enclosing_function_params(spans, node)
            ):
                continue
            yield from self._check_name(
                ctx, node, name_arg, constants,
                needs_seconds=tail in _SECONDS_METHODS,
            )
            yield from self._check_labels(ctx, node)

    def _check_name(
        self, ctx, call, name_arg, constants, needs_seconds=False
    ) -> Iterable[Finding]:
        if isinstance(name_arg, ast.Constant) and isinstance(name_arg.value, str):
            if not name_arg.value.startswith(PREFIX):
                yield self.finding(
                    ctx,
                    call,
                    f"metric name {name_arg.value!r} must start with "
                    f"{PREFIX!r} (rb_tpu_<layer>_<name> convention)",
                )
            if needs_seconds and not name_arg.value.endswith("_seconds"):
                yield self.finding(
                    ctx,
                    call,
                    f"latency histogram {name_arg.value!r} must end in "
                    "'_seconds' (latency histograms measure seconds)",
                )
            return
        term = dotted_name(name_arg)
        term = term.rsplit(".", 1)[-1] if term else None
        if term is not None and _ALL_CAPS.match(term):
            val = constants.get(term)
            if val is not None:
                # in-file constant: resolve and validate the value here
                if not val.startswith(PREFIX):
                    yield self.finding(
                        ctx,
                        call,
                        f"metric registered under constant {term} = {val!r} "
                        f"which lacks the {PREFIX!r} prefix",
                    )
                if needs_seconds and not val.endswith("_seconds"):
                    yield self.finding(
                        ctx,
                        call,
                        f"latency histogram registered under constant {term} "
                        f"= {val!r} which lacks the '_seconds' unit suffix",
                    )
            elif needs_seconds and not term.endswith("_SECONDS"):
                # cross-module latency constants must be _SECONDS-shaped so
                # the defining module's value check enforces the suffix
                yield self.finding(
                    ctx,
                    call,
                    f"latency histogram name constant {term} is not "
                    "_SECONDS-shaped: the '_seconds' suffix cannot be "
                    "verified",
                )
            elif not _SHAPED_CONST.match(term):
                # cross-module constants are accepted only when the NAME is
                # metric-shaped — that shape is exactly what the
                # definition-site check validates in the defining module, so
                # an unshaped name here would escape both checks
                yield self.finding(
                    ctx,
                    call,
                    f"metric name constant {term} is neither defined in this "
                    f"module nor unit-suffixed (_TOTAL/_SECONDS/_BYTES/"
                    f"_COUNT/_RATIO/_STATE/_STATUS): the prefix cannot be "
                    f"verified",
                )
            return
        yield self.finding(
            ctx,
            call,
            "metric name must be a string literal or ALL_CAPS constant "
            "(computed names fork the metric namespace)",
        )

    def _check_label_values(self, ctx, call, method) -> Iterable[Finding]:
        """Unbounded-cardinality guard on metric *mutations*:
        ``_FOO_TOTAL.inc(1, (trace_id,))`` mints a series per query."""
        # receiver must be a module-level metric constant (_FOO_TOTAL.inc /
        # mod._FOO_SECONDS.observe); instance attrs and locals are other
        # objects wearing the same method names
        if not isinstance(call.func, ast.Attribute):
            return
        recv = call.func.value
        term = recv.attr if isinstance(recv, ast.Attribute) else (
            recv.id if isinstance(recv, ast.Name) else None
        )
        if term is None or not _METRIC_CONST.match(term):
            return
        label_arg = call.args[1] if len(call.args) >= 2 else None
        for kw in call.keywords:
            if kw.arg == "labels":
                label_arg = kw.value
        # a non-tuple labels argument (a variable) is out of lexical scope,
        # like aliasing in lock-discipline
        if not isinstance(label_arg, (ast.Tuple, ast.List)):
            return
        for el in label_arg.elts:
            yield from self._check_label_value(ctx, call, el)

    def _check_label_value(self, ctx, call, el) -> Iterable[Finding]:
        if isinstance(el, ast.Constant):
            return  # literal: declared, bounded
        if isinstance(el, ast.Subscript) and isinstance(el.value, ast.Name) \
                and _METRIC_CONST.match(el.value.id):
            return  # member of an in-file ALL_CAPS constant collection
        if isinstance(el, (ast.JoinedStr, ast.BinOp)):
            yield self.finding(
                ctx, call,
                "computed metric label value (f-string/concatenation): "
                "unbounded values belong on recorder events or the "
                "decision log, not in label sets",
            )
            return
        if isinstance(el, ast.Call):
            # str(<benign name>) merely stringifies: check the inner name
            if (
                isinstance(el.func, ast.Name) and el.func.id == "str"
                and len(el.args) == 1 and isinstance(el.args[0], ast.Name)
            ):
                yield from self._check_label_value(ctx, call, el.args[0])
                return
            yield self.finding(
                ctx, call,
                "metric label value computed by a call: unbounded values "
                "(fingerprints, ids) belong on recorder events or the "
                "decision log, not in label sets",
            )
            return
        term = dotted_name(el)
        term = term.rsplit(".", 1)[-1] if term else None
        if term is None:
            return
        if _TENANT_VALUE.search(term.lower()):
            yield self.finding(
                ctx, call,
                f"metric label value `{term}` is a tenant name: tenant "
                "label values must come from the bounded declared tenant "
                "registry (spell it TENANTS[" + term + "] — the "
                "declared-collection subscript — so an undeclared tenant "
                "can never mint a series)",
            )
            return
        if _EPOCH_VALUE.search(term.lower()):
            yield self.finding(
                ctx, call,
                f"metric label value `{term}` is an epoch id: epoch ids "
                "are unbounded (one per flip, forever) and must never be "
                "metric label values — export the current epoch as a "
                "gauge VALUE and put lineage in the epoch ledger / "
                "trace / decision attrs",
            )
            return
        if _FORMAT_VALUE.search(term.lower()):
            yield self.finding(
                ctx, call,
                f"metric label value `{term}` is a container format: "
                "format label values must come from the declared frozen "
                "format set (spell it FORMATS[" + term + "] — the "
                "declared-collection subscript — so a future or typo'd "
                "format string can never mint a series)",
            )
            return
        if _UNBOUNDED.search(term.lower()):
            yield self.finding(
                ctx, call,
                f"metric label value `{term}` reads as unbounded "
                "cardinality (per-query/per-operand): use a literal or a "
                "member of a declared frozen set, and put the raw value "
                "on a recorder event or decision-log entry instead",
            )

    def _check_labels(self, ctx, call) -> Iterable[Finding]:
        label_arg = None
        if len(call.args) >= 3:
            label_arg = call.args[2]
        for kw in call.keywords:
            if kw.arg == "labelnames":
                label_arg = kw.value
        if label_arg is None:
            return
        if not _literal_label_tuple(label_arg):
            yield self.finding(
                ctx,
                call,
                "labelnames must be a literal tuple of string literals "
                "(declared label sets, not computed)",
            )
