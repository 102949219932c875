"""Project-native static analysis:
machine-checked invariants next to the test matrix, the analogue of the
reference's per-push analysis workflow
(.github/workflows/java-all-versions.yml).

Counterpart of ``roaringbitmap_tpu/analysis``, pure stdlib like it, and
run over this package. ``trace-safety`` and ``use-after-donation`` have no
counterpart: this package has no jit to trace and donates no buffer.

Two tiers:

**Lexical rules** (per file, ``core.CHECKERS``):

* ``dtype-discipline``  — container payloads stay uint16/uint64; signed
  sub-64-bit intermediates on payload paths need a justifying pragma.
* ``lock-discipline``   — state annotated ``# guarded-by: <lock>`` is
  written only inside ``with <lock>:`` — upgraded with
  may-hold-set propagation through intra-module helper calls.
* ``exception-hygiene`` — broad excepts re-raise or carry a pragma.
* ``metric-naming``     — observe/ registrations use ``rb_tpu_`` names
  with declared label sets.

**Contract rules** (whole-program over a :class:`project.ProjectContext`,
``core.CONTRACT_CHECKERS``): registry-drift checks —
``fault-site-contract``, ``decision-discipline``, ``authority-surface``,
``metric-discipline``, ``sentinel-table-drift``, ``knob-doc`` — plus
the CFG dataflow rule ``epoch-pin`` (cfg.py is the light intra-function
CFG + forward may-analysis it uses).

CLI: ``python -m roaringbitmap_tpu_torch.analysis [--check] [--contracts]
[--json]``; the baseline in ``analysis/BASELINE.json`` keeps pre-existing
findings from blocking while new ones fail (see baseline.py); it is
empty.
``lockwitness`` is the dynamic complement: a lock-acquisition-order
recorder the thread-hammer tests assert on.

The analysis modules themselves are pure stdlib (ast/tokenize/hashlib);
the CLI additionally reports per-rule finding counts into the
observe registry (``rb_tpu_analysis_findings_total`` and
``rb_tpu_analysis_contract_findings_total``) when run in-process.
"""

from .core import (
    CHECKERS,
    CONTRACT_CHECKERS,
    Checker,
    FileContext,
    Finding,
    ProjectChecker,
    RunResult,
    all_contract_rule_ids,
    all_rule_ids,
    fingerprints,
    iter_python_files,
    register,
    register_contract,
    run_checks,
    run_contract_checks,
)
from . import baseline
from . import knobs
from .lockwitness import LockOrderError, LockWitness
from .project import ProjectContext, get_project

__all__ = [
    "CHECKERS",
    "CONTRACT_CHECKERS",
    "Checker",
    "FileContext",
    "Finding",
    "ProjectChecker",
    "ProjectContext",
    "RunResult",
    "all_contract_rule_ids",
    "all_rule_ids",
    "baseline",
    "fingerprints",
    "get_project",
    "iter_python_files",
    "knobs",
    "register",
    "register_contract",
    "run_checks",
    "run_contract_checks",
    "LockOrderError",
    "LockWitness",
]
