"""Project-native static analysis CLI over ``roaringbitmap_tpu_torch`` — the
counterpart of the JAX package's ``scripts/analyze.py``.

Usage::

    python -m roaringbitmap_tpu_torch.analysis                  # lexical tier, report, exit 0
    python -m roaringbitmap_tpu_torch.analysis --check          # exit 1 on non-baselined findings
    python -m roaringbitmap_tpu_torch.analysis --contracts      # + whole-program contract tier
    python -m roaringbitmap_tpu_torch.analysis --json           # machine-readable output
    python -m roaringbitmap_tpu_torch.analysis --update-baseline
    python -m roaringbitmap_tpu_torch.analysis --rules lock-discipline,epoch-pin
    python -m roaringbitmap_tpu_torch.analysis --write-knobs    # regenerate the package's KNOBS.md
    python -m roaringbitmap_tpu_torch.analysis --check-knobs    # exit 1 when KNOBS.md drifted

The default scan root is the package. The baseline
(``analysis/BASELINE.json``, empty) holds fingerprints of accepted
findings — both tiers share it (and the ``# rb-ok:`` pragma mechanism).
Per-rule finding counts are reported into the observe registry
(``rb_tpu_analysis_findings_total{rule}`` for the lexical tier,
``rb_tpu_analysis_contract_findings_total{rule}`` for the contract tier)
for the metrics sidecar. Exit codes: 0 clean, 1 new findings (with
``--check``) or a drifted knob table, 2 a bad path, rule, baseline or
parse error. The JAX package's ``--diff REF`` mode is not carried over.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .. import observe
from . import (
    RunResult,
    all_contract_rule_ids,
    all_rule_ids,
    baseline,
    fingerprints,
    get_project,
    knobs as knobs_mod,
    run_checks,
    run_contract_checks,
)
from .core import CHECKERS, CONTRACT_CHECKERS

PACKAGE = "roaringbitmap_tpu_torch"
PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(PACKAGE_DIR)
DEFAULT_PATHS = [PACKAGE_DIR]
KNOBS_PATH = os.path.join(PACKAGE_DIR, knobs_mod.KNOBS_DOC)

_FINDINGS_TOTAL = observe.counter(
    observe.ANALYSIS_FINDINGS_TOTAL,
    "Static-analysis findings by rule (includes baselined)",
    ("rule",),
)
_CONTRACT_FINDINGS_TOTAL = observe.counter(
    observe.ANALYSIS_CONTRACT_FINDINGS_TOTAL,
    "Whole-program contract-analysis findings by rule (includes baselined)",
    ("rule",),
)


def _knobs(write: bool) -> int:
    project = get_project(REPO_ROOT, package=PACKAGE)
    try:
        rendered = knobs_mod.render(project)
    except ValueError as e:
        print(f"analyze: {e}", file=sys.stderr)
        return 2
    rel = os.path.relpath(KNOBS_PATH, REPO_ROOT)
    if write:
        with open(KNOBS_PATH, "w", encoding="utf-8") as f:
            f.write(rendered)
        print(f"wrote {rel} ({len(project.knobs)} knobs)")
        return 0
    try:
        with open(KNOBS_PATH, encoding="utf-8") as f:
            current = f.read()
    except OSError:
        current = ""
    if current != rendered:
        print(f"analyze: {rel} has drifted from the tree — run "
              f"{knobs_mod.WRITE_COMMAND}", file=sys.stderr)
        return 1
    print(f"{rel} is current ({len(project.knobs)} knobs)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m roaringbitmap_tpu_torch.analysis",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument("paths", nargs="*", help="files/dirs (default: the package)")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 if any non-baselined finding exists")
    ap.add_argument("--contracts", action="store_true",
                    help="also run the whole-program contract tier")
    ap.add_argument("--json", action="store_true", help="JSON output")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids (default: all)")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--baseline", default=baseline.DEFAULT_BASELINE_PATH,
                    help="baseline file (default: %(default)s)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="accept every current finding into the baseline")
    ap.add_argument("--write-knobs", action="store_true",
                    help="regenerate the package's KNOBS.md from the knob extractor")
    ap.add_argument("--check-knobs", action="store_true",
                    help="exit 1 when the package's KNOBS.md drifted from the tree")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid in all_rule_ids():
            print(f"{rid}: {CHECKERS[rid].description}")
        for rid in all_contract_rule_ids():
            print(f"{rid}: {CONTRACT_CHECKERS[rid].description}  [contract]")
        return 0

    if args.write_knobs or args.check_knobs:
        return _knobs(args.write_knobs)

    lex_rules = None
    contract_rules = None
    if args.rules:
        all_rule_ids()  # side effect: lazily registers both checker tiers
        wanted = [r.strip() for r in args.rules.split(",") if r.strip()]
        lex_rules = [r for r in wanted if r in CHECKERS] or None
        contract_rules = [r for r in wanted if r in CONTRACT_CHECKERS] or None
        unknown = [
            r for r in wanted
            if r not in CHECKERS and r not in CONTRACT_CHECKERS
        ]
        if unknown:
            print(
                f"analyze: unknown rule(s) {unknown}; known: "
                f"{all_rule_ids() + all_contract_rule_ids()}",
                file=sys.stderr,
            )
            return 2
        if contract_rules and not args.contracts:
            args.contracts = True
        if lex_rules is None:
            # contract-only selection: skip the lexical tier entirely
            lex_rules = []

    paths = args.paths or DEFAULT_PATHS
    try:
        if lex_rules == []:
            result = RunResult()
        else:
            result = run_checks(paths, rules=lex_rules or None, root=REPO_ROOT)
    except ValueError as e:  # unknown rule id / bad path
        print(f"analyze: {e}", file=sys.stderr)
        return 2

    ran_contracts = []
    if args.contracts:
        project = get_project(REPO_ROOT, package=PACKAGE)
        cres = run_contract_checks(project, rules=contract_rules)
        ran_contracts = contract_rules or all_contract_rule_ids()
        result.findings.extend(cres.findings)
        result.suppressed += cres.suppressed
        result.files = max(result.files, cres.files)
        for e in cres.parse_errors:
            if e not in result.parse_errors:
                result.parse_errors.append(e)
        result.findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))

    ran_lexical = (lex_rules or all_rule_ids()) if lex_rules != [] else []
    for rid in ran_lexical:
        # inc(0) still materializes the series, so the sidecar shows a
        # clean rule as an explicit zero rather than an absence
        _FINDINGS_TOTAL.inc(
            sum(1 for f in result.findings if f.rule == rid), (rid,)
        )
    for rid in ran_contracts:
        _CONTRACT_FINDINGS_TOTAL.inc(
            sum(1 for f in result.findings if f.rule == rid), (rid,)
        )

    if args.update_baseline:
        if args.paths or args.rules:
            # a scoped run sees only a subset of findings; dumping it would
            # silently drop accepted fingerprints outside the scope and
            # break the next full --check
            print("analyze: --update-baseline requires a full default run "
                  "(no path or --rules arguments)", file=sys.stderr)
            return 2
        if result.parse_errors:
            # an unparsed file was never scanned: its findings are unknown,
            # so "accept everything current" would be a lie
            for e in result.parse_errors:
                print(f"parse error: {e}", file=sys.stderr)
            print("analyze: refusing to update baseline with unscanned files",
                  file=sys.stderr)
            return 2
        doc = baseline.dump(args.baseline, result.findings)
        print(f"baseline updated: {len(doc['findings'])} finding(s) "
              f"accepted into {os.path.relpath(args.baseline, REPO_ROOT)}")
        return 0

    try:
        known = baseline.load(args.baseline)
    except (ValueError, json.JSONDecodeError) as e:
        print(f"analyze: bad baseline: {e}", file=sys.stderr)
        return 2
    new, old = baseline.partition(result.findings, known)

    if args.json:
        fps = fingerprints(result.findings)
        old_ids = {id(f) for f in old}
        out = {
            "files": result.files,
            "rules": list(ran_lexical) + list(ran_contracts),
            "suppressed": result.suppressed,
            "parse_errors": result.parse_errors,
            "findings": [
                {**f.to_dict(), "fingerprint": fp, "baselined": id(f) in old_ids}
                for f, fp in zip(result.findings, fps)
            ],
            "new": len(new),
            "baselined": len(old),
        }
        json.dump(out, sys.stdout, indent=2)
        print()
    else:
        for f in new:
            print(f.render())
        for f in old:
            print(f"{f.render()}  [baselined]")
        for e in result.parse_errors:
            print(f"parse error: {e}", file=sys.stderr)
        tiers = "lexical" + ("+contracts" if ran_contracts else "")
        print(
            f"analyze: {len(result.findings)} finding(s) "
            f"({len(new)} new, {len(old)} baselined, "
            f"{result.suppressed} pragma-suppressed) across "
            f"{result.files} files [{tiers}]"
        )

    if result.parse_errors:
        return 2
    if args.check and new:
        if not args.json:
            print("analyze: FAIL — new findings above are not in the baseline "
                  f"({os.path.relpath(args.baseline, REPO_ROOT)}); fix them or "
                  "run --update-baseline with justification", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
