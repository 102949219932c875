"""Checked-in finding baseline: pre-existing findings don't block CI while
new ones fail it.

The baseline file (``analysis/BASELINE.json`` in the package; the root
ANALYSIS_BASELINE.json is the JAX package's) records the
fingerprint of every accepted finding (see ``core.fingerprints``: hash of
rule + path + offending line text + occurrence index, so line-number churn
does not invalidate entries). ``python -m roaringbitmap_tpu_torch.analysis --check`` fails on any
finding whose fingerprint is not in the baseline;
``--update-baseline`` rewrites the file from the current tree.

Workflow::

    python -m roaringbitmap_tpu_torch.analysis --check            # gate
    python -m roaringbitmap_tpu_torch.analysis --update-baseline  # accept current findings
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Set, Tuple

from .core import Finding, fingerprints

BASELINE_VERSION = 1
DEFAULT_BASELINE_NAME = "BASELINE.json"
# the baseline's home: beside this module
DEFAULT_BASELINE_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), DEFAULT_BASELINE_NAME
)


def load(path: str) -> Set[str]:
    """Fingerprint set from a baseline file; empty when missing."""
    if not os.path.isfile(path):
        return set()
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    if not isinstance(data, dict) or data.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"{path}: not a v{BASELINE_VERSION} analysis baseline "
            f"(got {type(data).__name__})"
        )
    entries = data.get("findings", [])
    out = set()
    for e in entries:
        fp = e.get("fingerprint") if isinstance(e, dict) else None
        if not isinstance(fp, str) or not fp:
            # hand-edits / merge damage surface as the CLI's "bad baseline"
            # path (exit 2), not a KeyError traceback
            raise ValueError(f"{path}: baseline entry without fingerprint: {e!r}")
        out.add(fp)
    return out


def dump(path: str, findings: Sequence[Finding]) -> dict:
    """Write a baseline accepting every current finding; returns the doc."""
    fps = fingerprints(findings)
    doc = {
        "version": BASELINE_VERSION,
        "tool": "python -m roaringbitmap_tpu_torch.analysis",
        "findings": [
            {
                "fingerprint": fp,
                "rule": f.rule,
                "path": f.path,
                "message": f.message,
            }
            for fp, f in sorted(
                zip(fps, findings), key=lambda p: (p[1].path, p[1].line, p[1].rule)
            )
        ],
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=False)
        f.write("\n")
    return doc


def partition(
    findings: Sequence[Finding], baseline_fps: Set[str]
) -> Tuple[List[Finding], List[Finding]]:
    """(new, baselined) split of ``findings`` against the fingerprint set."""
    new: List[Finding] = []
    old: List[Finding] = []
    for f, fp in zip(findings, fingerprints(findings)):
        (old if fp in baseline_fps else new).append(f)
    return new, old
