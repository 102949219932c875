"""Registry-drift contract rules: authority-surface,
metric-discipline, sentinel-table-drift, knob-doc.

Each rule pins one implicit cross-module registry to the surfaces that
must track it:

* **authority-surface** — every ``cost/facade.AUTHORITIES`` entry
  implements the full Authority protocol in its own class body (the base
  raises, so an inherited slot breaks the ``RB_TPU_COST_STATE``
  save/load lifecycle and sentinel-actuated refit at runtime), appears
  in the facade's own docstring table, and appears in the package's
  section of README.md (the JAX package reads ARCHITECTURE.md); an
  Authority subclass never registered in AUTHORITIES is dead drift.
* **metric-discipline** — every ``rb_tpu_*`` name constant in
  observe/registry.py is consumed somewhere outside registry.py (the
  exporters publish the whole registry, so an unconsumed constant is a
  metric that can never carry a sample); registrations outside
  registry.py go through a named constant, never an inline ``rb_tpu_``
  literal; and every registration of the same constant declares the
  same label tuple.
* **sentinel-table-drift** — observe/health.py's ``DEFAULT_RULES`` and
  its committed docstring threshold table list exactly the same rule
  names, both directions.
* **knob-doc** — every ``RB_TPU_*`` env var read in package source has a
  row in the package's KNOBS.md (generated by ``python -m
  roaringbitmap_tpu_torch.analysis --write-knobs``), and every row names
  a knob still read somewhere.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from ..core import Finding, ProjectChecker, register_contract
from ..project import AUTHORITY_DOC, AUTHORITY_PROTOCOL, ProjectContext
from .. import knobs as _knobs


@register_contract
class AuthoritySurface(ProjectChecker):
    rule_id = "authority-surface"
    description = (
        "cost facade authorities implement the full protocol and appear "
        "in the facade doc table and the package's README section"
    )
    severity = "error"

    def check_project(self, project: ProjectContext) -> Iterable[Finding]:
        facade_rel = project.pkg_path("cost", "facade.py")
        ctx = project.file("cost", "facade.py")
        if ctx is None:
            return
        if not project.authorities:
            yield self.finding(
                project, facade_rel, 1,
                "could not extract any Authority subclass from the cost "
                "facade — the authority-surface contract has no registry",
            )
            return
        import ast as _ast

        facade_doc = _ast.get_docstring(ctx.tree, clean=False) or ""
        arch = project.doc_section(AUTHORITY_DOC)
        for a in sorted(project.authorities, key=lambda x: x.line):
            if not a.registered:
                yield self.finding(
                    project, facade_rel, a.line,
                    f"Authority subclass {a.class_name} ({a.name!r}) is "
                    "never instantiated in AUTHORITIES — dead authority, "
                    "invisible to refit/drift/state lifecycles",
                )
                continue
            missing = [m for m in AUTHORITY_PROTOCOL if m not in a.methods]
            if missing:
                yield self.finding(
                    project, facade_rel, a.line,
                    f"authority {a.name!r} ({a.class_name}) inherits "
                    f"{missing} from the raising base — save_state()/"
                    "load_state() over RB_TPU_COST_STATE (or a sentinel "
                    "refit) would raise NotImplementedError at runtime",
                )
            if a.name not in facade_doc:
                yield self.finding(
                    project, facade_rel, a.line,
                    f"authority {a.name!r} is missing from the facade's "
                    "docstring table — the committed authority inventory "
                    "has drifted",
                )
            if arch and a.name not in arch:
                yield self.finding(
                    project, facade_rel, a.line,
                    f"authority {a.name!r} is not mentioned anywhere in "
                    f"the package's {AUTHORITY_DOC} section — the docs' "
                    "cost-brain inventory has drifted",
                )


@register_contract
class MetricDiscipline(ProjectChecker):
    rule_id = "metric-discipline"
    description = (
        "registry.py rb_tpu_* constants are consumed, registrations use "
        "constants (not literals) and agree on label sets"
    )
    severity = "error"

    def check_project(self, project: ProjectContext) -> Iterable[Finding]:
        registry_rel = project.pkg_path("observe", "registry.py")
        if not project.metric_constants:
            yield self.finding(
                project, registry_rel, 1,
                "could not extract any rb_tpu_* name constant from "
                "observe/registry.py — the metric contract has no registry",
            )
            return
        for const, (metric, line) in sorted(project.metric_constants.items()):
            consumers = project.metric_const_uses.get(const, set()) - {
                registry_rel
            }
            if not consumers:
                yield self.finding(
                    project, registry_rel, line,
                    f"metric constant {const} ({metric}) is never "
                    "referenced outside observe/registry.py — a registered "
                    "name that can never carry a sample",
                )
        for path, line, kind, name, _labels in project.metric_registrations:
            if kind == "literal":
                yield self.finding(
                    project, path, line,
                    f"metric registered with inline literal {name!r} — "
                    "register through a named observe/registry.py constant "
                    "so the export/rb_top surfaces can track it",
                )
        # label-set agreement per constant (only registrations whose label
        # tuple is statically visible participate)
        by_const: Dict[str, List[Tuple[str, int, Tuple[str, ...]]]] = {}
        for path, line, kind, name, labels in project.metric_registrations:
            if kind == "const" and name in project.metric_constants and labels is not None:
                by_const.setdefault(name, []).append((path, line, labels))
        for const, regs in sorted(by_const.items()):
            label_sets = {labels for _, _, labels in regs}
            if len(label_sets) > 1:
                for path, line, labels in regs[1:]:
                    if labels != regs[0][2]:
                        yield self.finding(
                            project, path, line,
                            f"metric {const} registered here with labels "
                            f"{labels} but first registered at "
                            f"{regs[0][0]}:{regs[0][1]} with {regs[0][2]} "
                            "— conflicting label sets raise at import",
                        )


@register_contract
class SentinelTableDrift(ProjectChecker):
    rule_id = "sentinel-table-drift"
    description = (
        "health.py DEFAULT_RULES and its docstring threshold table list "
        "the same rule names, both directions"
    )
    severity = "error"

    def check_project(self, project: ProjectContext) -> Iterable[Finding]:
        health_rel = project.pkg_path("observe", "health.py")
        if project.file("observe", "health.py") is None:
            return
        if not project.sentinel_rules:
            yield self.finding(
                project, health_rel, 1,
                "could not extract DEFAULT_RULES from observe/health.py — "
                "the sentinel contract has no registry",
            )
            return
        doc_names = set(project.sentinel_doc_rules)
        for name, line in sorted(project.sentinel_rules.items()):
            if name not in doc_names:
                yield self.finding(
                    project, health_rel, line,
                    f"sentinel rule {name!r} is missing from the module "
                    "docstring's committed threshold table",
                )
        for name, line in sorted(project.sentinel_doc_rules.items()):
            if name not in project.sentinel_rules:
                yield self.finding(
                    project, health_rel, line,
                    f"docstring table row {name!r} names no DEFAULT_RULES "
                    "rule — stale threshold documentation",
                )


@register_contract
class KnobDoc(ProjectChecker):
    rule_id = "knob-doc"
    description = (
        "every RB_TPU_* env knob read in source has a row in the "
        "package's KNOBS.md, and every row is a live knob"
    )
    severity = "error"

    def check_project(self, project: ProjectContext) -> Iterable[Finding]:
        doc = project.pkg_path(_knobs.KNOBS_DOC)
        table = project.text(doc)
        documented = _knobs.documented_knobs(table)
        for knob, reads in sorted(project.knobs.items()):
            if knob not in documented:
                path, line = reads[0]
                yield self.finding(
                    project, path, line,
                    f"env knob {knob} is read here but has no {doc} "
                    f"row — regenerate with {_knobs.WRITE_COMMAND}",
                )
        anchor = project.pkg_path("__init__.py")
        for knob in sorted(documented - set(project.knobs)):
            # a stale doc row has no in-source anchor; pin it to the
            # package root so the finding (and any waiver) has a stable home
            yield self.finding(
                project, anchor, 1,
                f"{doc} documents {knob} but nothing in the "
                "package reads it — stale row, regenerate with "
                f"{_knobs.WRITE_COMMAND}",
            )
