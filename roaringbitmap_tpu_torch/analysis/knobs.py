"""KNOBS.md generation: the env-var table derived from the
ProjectContext knob extractor.

The table is the package's own ``roaringbitmap_tpu_torch/KNOBS.md`` (the
root KNOBS.md documents the JAX package). ``python -m
roaringbitmap_tpu_torch.analysis --write-knobs`` regenerates it;
``--check-knobs`` fails when the committed file has drifted from the
tree, and the ``knob-doc`` contract rule fails when a knob is read in
source with no row here. The JAX package's ``RB_TPU_EXPAND`` (its host
re-expansion switch) has no row: this package always expands on the
device. One-line docs live in
``KNOB_DOCS`` below — adding a knob to the source without adding its doc
line fails loudly at generation time, which is the point: the table
can't silently rot.

Defaults are curated alongside the docs (they live in expressions the
extractor can't always evaluate — ``int(... or 8)``, helper wrappers);
the *name set* is what's machine-derived and drift-gated.
"""

from __future__ import annotations

import re
from typing import Dict, List, Set, Tuple

# package-relative: the table lives beside the package's modules
KNOBS_DOC = "KNOBS.md"
WRITE_COMMAND = "python -m roaringbitmap_tpu_torch.analysis --write-knobs"

_HEADER = """# RB_TPU environment knobs

Machine-generated by `python -m roaringbitmap_tpu_torch.analysis
--write-knobs` from the static-analysis ProjectContext's knob extractor
(every `RB_TPU_*` env var read anywhere in `roaringbitmap_tpu_torch`).
Edit `KNOB_DOCS` in `roaringbitmap_tpu_torch/analysis/knobs.py`, not this
file; `--check-knobs` fails when this table drifts from the tree, and
the `knob-doc` contract rule fails when a knob is read with no row here.

| Knob | Default | Consuming module | What it does |
|------|---------|------------------|--------------|
"""

# knob -> (default, one-line doc). A knob read in source but missing
# here makes --write-knobs (and the ci gate) fail with the name.
KNOB_DOCS: Dict[str, Tuple[str, str]] = {
    "RB_TPU_ARTIFACT_DIR": (
        "`rb_tpu_artifacts`",
        "Root directory for dump artifacts (compile anomalies, timeline dumps, flight bundles).",
    ),
    "RB_TPU_COLUMNAR_CAL": (
        "unset",
        "Path persisting the columnar cost model's calibration; loaded at import, refit writes back.",
    ),
    "RB_TPU_COMPILE_BUDGET": (
        "`32`",
        "Max library builds per tracked entry point (`rb_kernels`, `rb_host`) before the compile-storm anomaly dump fires.",
    ),
    "RB_TPU_COMPILE_DUMP": (
        "`rb_tpu_compile_anomaly.jsonl`",
        "Destination for the compile-storm anomaly report.",
    ),
    "RB_TPU_COST_STATE": (
        "unset",
        "Path for the unified cost facade's save_state()/load_state() JSON (all authorities).",
    ),
    "RB_TPU_DECISIONS_CAPACITY": (
        "`512`",
        "Ring capacity of the in-process decision log.",
    ),
    "RB_TPU_FAULTS": (
        "unset",
        "Seeded fault schedule `<seed>[:prob[:site+site]]` armed at import (ci-chaos gate).",
    ),
    "RB_TPU_FUSION": (
        "unset",
        "Force the cross-query fusion executor on/off (default: the priced verdict decides).",
    ),
    "RB_TPU_FUSION_HEDGE": (
        "on",
        "Hedged solo dispatch for interactive requests the priced verdict says the window would blow (off records verdicts only).",
    ),
    "RB_TPU_FUSION_LATENCY_MS": (
        "`2.0`",
        "Max wall a fusion window may hold a query before closing (member slack can close it earlier).",
    ),
    "RB_TPU_FUSION_WINDOW": (
        "`8`",
        "Target fusion micro-batch window size (min 2); the base bound the p99-pressure auto-tune regrows toward.",
    ),
    "RB_TPU_FUSION_WINDOW_MIN": (
        "`2`",
        "Floor the serving-p99-pressure auto-tune may shrink the fusion window to.",
    ),
    "RB_TPU_LOCK_TIMING": (
        "unset",
        "Opt-in lock-wait timing instrumentation over the framework locks (1/on enables).",
    ),
    "RB_TPU_OUTCOMES": (
        "on",
        "Decision-outcome ledger switch; off disables pending joins and refit-from-traffic.",
    ),
    "RB_TPU_OUTCOMES_CAPACITY": (
        "`4096`",
        "Joined-outcome ring capacity.",
    ),
    "RB_TPU_OUTCOMES_DUMP": (
        "`rb_tpu_outcomes_anomaly.jsonl`",
        "Destination for the outcome-anomaly burst dump.",
    ),
    "RB_TPU_OUTCOMES_PENDING": (
        "`1024`",
        "Pending (unresolved) decision ring capacity; overflow ages out as orphans.",
    ),
    "RB_TPU_PACK_CACHE_BYTES": (
        "a quarter of the card's memory; `2147483648` on the CPU",
        "Resident byte budget of the process-wide PACK_CACHE (0 disables caching).",
    ),
    "RB_TPU_SENTINEL": (
        "unset",
        "Health sentinel background thread switch (1/on starts it at import).",
    ),
    "RB_TPU_SENTINEL_AUTOTUNE_COOLDOWN_S": (
        "`30`",
        "Min seconds between p99-pressure-actuated fusion-window auto-tunes.",
    ),
    "RB_TPU_SENTINEL_BUNDLE_COOLDOWN_S": (
        "`300`",
        "Min seconds between red-episode flight-bundle captures.",
    ),
    "RB_TPU_SENTINEL_INTERVAL_S": (
        "`5`",
        "Background sentinel tick interval.",
    ),
    "RB_TPU_SENTINEL_MAINTAIN_COOLDOWN_S": (
        "`60`",
        "Min seconds between sentinel-actuated maintenance (compaction) passes.",
    ),
    "RB_TPU_SENTINEL_REFIT_COOLDOWN_S": (
        "`60`",
        "Min seconds between drift-actuated cost-model refits.",
    ),
    "RB_TPU_SERVE_INFLIGHT": (
        "`threads * 2`",
        "Serving-tier global in-flight cap backing admission's queue/shed verdicts.",
    ),
    "RB_TPU_TIMELINE": (
        "unset",
        "Always-on timeline recorder switch (1/on enables span/instant capture).",
    ),
    "RB_TPU_TIMELINE_BUDGET_MS": (
        "unset",
        "Span wall budget; exceeding spans mark themselves over-budget in the dump.",
    ),
    "RB_TPU_TIMELINE_CAPACITY": (
        "`65536`",
        "Timeline ring capacity (events).",
    ),
    "RB_TPU_TIMELINE_DUMP": (
        "unset",
        "Path for the timeline's Chrome-trace dump at exit.",
    ),
}

_ROW_RE = re.compile(r"^\|\s*`?(RB_TPU_[A-Z0-9_]+)`?\s*\|")


def documented_knobs(table_text: str) -> Set[str]:
    """Knob names present as rows of a KNOBS.md table text."""
    out: Set[str] = set()
    for line in table_text.splitlines():
        m = _ROW_RE.match(line.strip())
        if m:
            out.add(m.group(1))
    return out


def render(project) -> str:
    """The full KNOBS.md content for a ProjectContext. Raises ValueError
    naming any knob read in source that has no KNOB_DOCS entry — the
    curated doc line is part of adding a knob."""
    missing = sorted(set(project.knobs) - set(KNOB_DOCS))
    if missing:
        raise ValueError(
            f"no KNOB_DOCS entry for {missing} — add the one-line doc in "
            "roaringbitmap_tpu_torch/analysis/knobs.py"
        )
    rows: List[str] = []
    for knob in sorted(project.knobs):
        default, doc = KNOB_DOCS[knob]
        modules = sorted(
            {path.replace("\\", "/") for path, _ in project.knobs[knob]}
        )
        rows.append(
            f"| `{knob}` | {default} | {', '.join(modules)} | {doc} |"
        )
    return _HEADER + "\n".join(rows) + "\n"
