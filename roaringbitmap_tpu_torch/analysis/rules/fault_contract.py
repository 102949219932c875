"""fault-site-contract: every declared fault site is real, and every
fault-site string in the pipeline is declared.

Counterpart of the JAX package's rule, with two differences. A guard or
route may be a call to a module-private wrapper that forwards its site
parameter to ``fault_point`` / ``ladder.retry`` (``store._guarded``). And
a site listed in the fuzz harness's ``RAISING_SITES`` — where this
package raises, classified, instead of degrading — needs no ladder route:
that table is the one place the departure is declared.

``robust/faults.SITES`` is the fault-injection framework's registry; a
site that exists only in the tuple is theater, and a ``fault_point()``
call on an undeclared site raises at runtime — on the first hit, which a
green test run may never produce. The contract, per declared site:

1. **guard**   — at least one ``fault_point("<site>")`` call in package
   source (outside robust/faults.py itself);
2. **route**   — a ladder/degradation path mentioning the site:
   ``LADDER.run(site, ...)``, ``LADDER.note_degrade(site, ...)``, or
   ``ladder.retry(site, ...)``, unless the site is in ``RAISING_SITES``.
   Sites whose failures deliberately ride a *different* site's route
   carry a justified ``# rb-ok: fault-site-contract`` pragma on their
   SITES entry line;
3. **exercise** — the site string appears in the exercise surface (the
   package's fuzz harness and its ``tests/test_torch_*.py``).

And the reverse direction: every ``fault_point("<literal>")`` in package
source must name a declared site. Findings for legs 1–3 anchor on the
site's own line in the SITES tuple; reverse findings anchor on the
offending call.
"""

from __future__ import annotations

from typing import Iterable

from ..core import Finding, ProjectChecker, register_contract
from ..project import FAULTS_MODULE, ProjectContext


@register_contract
class FaultSiteContract(ProjectChecker):
    rule_id = "fault-site-contract"
    description = (
        "every robust/faults.SITES entry needs a fault_point guard, a "
        "ladder route, and a fuzz/ci exercise; every fault_point literal "
        "must be declared"
    )
    severity = "error"

    def check_project(self, project: ProjectContext) -> Iterable[Finding]:
        faults_rel = project.pkg_path("robust", "faults.py")
        if not project.fault_sites:
            ctx = project.file("robust", "faults.py")
            if ctx is not None:
                yield self.finding(
                    project, faults_rel, 1,
                    "could not extract the SITES tuple — the fault-site "
                    "contract has no registry to check",
                )
            return
        route_sites = set(project.ladder_routes) | set(project.raising_sites)
        exercise = project.exercise_text()
        for site, line in sorted(project.fault_sites.items()):
            guards = [
                (p, ln)
                for p, ln in project.fault_guards.get(site, ())
                if p != faults_rel
            ]
            if not guards:
                yield self.finding(
                    project, faults_rel, line,
                    f"declared fault site {site!r} has no "
                    f"fault_point({site!r}) guard anywhere in the package "
                    "— the site can never fire",
                )
            if site not in route_sites:
                yield self.finding(
                    project, faults_rel, line,
                    f"declared fault site {site!r} has no ladder route "
                    "(LADDER.run / note_degrade / retry with this site) and "
                    "is not in fuzz.RAISING_SITES (the table of sites that "
                    "raise, classified) — an injected fault here has no "
                    "degradation story; if it deliberately rides another "
                    "site's route, waive with a justified pragma",
                )
            if f'"{site}"' not in exercise and f"'{site}'" not in exercise:
                yield self.finding(
                    project, faults_rel, line,
                    f"declared fault site {site!r} is never exercised "
                    "(no mention in fuzz.py or tests/test_torch_*.py)",
                )
        for site, uses in sorted(project.fault_guards.items()):
            if site in project.fault_sites:
                continue
            for path, line in uses:
                yield self.finding(
                    project, path, line,
                    f"fault_point({site!r}) names an undeclared site "
                    "(not in robust/faults.SITES) — it will raise "
                    "ValueError on its first armed hit",
                )
