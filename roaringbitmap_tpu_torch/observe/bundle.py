"""One-shot diagnostic flight bundles.

Counterpart of ``roaringbitmap_tpu/observe/bundle.py``. When a health
rule goes red, the individual anomaly dumps (timeline tail, ledger tail)
each capture one subsystem; diagnosing an incident needs all of them from
the SAME moment: the timeline, the decisions and their measured outcomes,
the metric totals, the resource observatory and the rule-evaluation
history that explains why the sentinel judged the process red. A
**flight bundle** is that cross-section as one manifest-indexed artifact
directory:

    <RB_TPU_ARTIFACT_DIR>/bundle_<utc>_<pid>_<seq>/
        MANIFEST.json       schema, trigger, file index (bytes + sha256)
        timeline.jsonl      flight-recorder dump (events + header)
        decisions.json      decision-log tail
        outcomes.json       ledger tail + per-site rollup + drift cells
        metrics.jsonl       full registry export (one series per line)
        calibration.json    every pricing authority's curves, provenance
                            and drift (``cost.calibration_state()``)
        observatory.json    lock-wait stats, compile counts, breaker
                            states + open ages, pack-cache stats, the
                            device-memory reconciliation, the serving,
                            epoch, structure and durable panels
                            (``insights.serving()`` / ``epochs()`` /
                            ``structure()`` / ``durable()``)
        health.json         sentinel status, rule states, evaluation
                            history, actuation log

**Atomicity**: everything is written into a hidden ``.tmp-…`` sibling and
the directory is renamed into place as the last step — a crash mid-write
leaves a temp directory, never a half-bundle. The manifest is written
last inside the temp dir, so a bundle that HAS a manifest has every file
the manifest indexes (:func:`read_manifest` re-verifies sizes and
digests).

Collection never raises past :func:`write_bundle`'s per-section guards: a
section whose collector fails records the error string in its place.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import time
from typing import Callable, Dict, Optional

from . import artifacts as _artifacts

SCHEMA = "rb_tpu_bundle/1"
MANIFEST_NAME = "MANIFEST.json"

# process-unique bundle serials (itertools.count.__next__ is atomic under
# the GIL): two rules going red in the same second must not collide
_SEQ = itertools.count(1)


def _json_or_error(collect: Callable[[], object]) -> str:
    """One section's content: the collector's JSON, or a JSON error
    record when it failed — a broken panel must not sink the bundle."""
    try:
        return json.dumps(collect(), indent=1, sort_keys=True, default=str) + "\n"
    except Exception as e:  # rb-ok: exception-hygiene -- bundle sections degrade to an error record; diagnostics must never fail AT the moment of failure
        return json.dumps(
            {"error": f"{type(e).__name__}: {e}"}, sort_keys=True
        ) + "\n"


def _collect_sections(health_dump: Optional[dict]) -> Dict[str, str]:
    """{filename: content} for every bundle section except the manifest."""
    from . import decisions as _decisions
    from . import outcomes as _outcomes
    from . import timeline as _timeline
    from .export import to_jsonl as _to_jsonl

    sections: Dict[str, str] = {}

    def _timeline_jsonl() -> str:
        rec = _timeline.RECORDER
        header = {
            "schema": _timeline.DUMP_SCHEMA,
            "generated_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "capacity": rec.capacity,
            "dropped": rec.dropped(),
        }
        lines = [json.dumps(header, sort_keys=True)]
        lines.extend(
            json.dumps(e.to_dict(), sort_keys=True) for e in rec.events()
        )
        return "\n".join(lines) + "\n"

    try:
        sections["timeline.jsonl"] = _timeline_jsonl()
    except Exception as e:  # rb-ok: exception-hygiene -- same degrade-to-error-record contract as _json_or_error
        sections["timeline.jsonl"] = json.dumps(
            {"error": f"{type(e).__name__}: {e}"}
        ) + "\n"
    sections["decisions.json"] = _json_or_error(_decisions.decisions)
    sections["outcomes.json"] = _json_or_error(
        lambda: {
            "tail": _outcomes.tail(),
            "summary": _outcomes.summary(),
            "drift": _outcomes.drift(),
        }
    )
    try:
        sections["metrics.jsonl"] = _to_jsonl()
    except Exception as e:  # rb-ok: exception-hygiene -- same degrade-to-error-record contract as _json_or_error
        sections["metrics.jsonl"] = json.dumps(
            {"error": f"{type(e).__name__}: {e}"}
        ) + "\n"

    def _calibration():
        from .. import cost as _cost

        return _cost.calibration_state()

    sections["calibration.json"] = _json_or_error(_calibration)

    def _observatory():
        from .. import insights as _insights
        from ..parallel import store as _store
        from ..robust import ladder as _ladder
        from . import compilewatch as _compilewatch
        from . import lockstats as _lockstats

        return {
            "locks": _lockstats.wait_stats(),
            "lock_timing": _lockstats.timing_enabled(),
            "compile": _compilewatch.compile_counts(),
            "breakers": _ladder.LADDER.states(),
            "breaker_open_ages": _ladder.LADDER.open_ages(),
            "pack_cache": _store.PACK_CACHE.stats(),
            "hbm": _store.hbm_reconciliation(),
            # a red episode the serving rules triggered ships the
            # per-tenant state that fired it
            "serving": _insights.serving(),
            # which snapshot was serving, how stale the log is and the
            # lineage that led here (freshness-lag-breach, epoch-flip-stall)
            "epochs": _insights.epochs(),
            # format census, drift ratio and maintenance-pass state
            # (structure-drift, delta-accretion)
            "structure": _insights.structure(),
            # which frozen epoch a restart would recover to, with its
            # torn-skip provenance (epoch-persist-stall,
            # recovery-manifest-torn)
            "durable": _insights.durable(),
        }

    sections["observatory.json"] = _json_or_error(_observatory)
    sections["health.json"] = _json_or_error(lambda: health_dump or {})
    return sections


def write_bundle(
    reason: str,
    trigger: Optional[dict] = None,
    dir: Optional[str] = None,
    health_dump: Optional[dict] = None,
) -> str:
    """Write one flight bundle; returns the final bundle directory path.
    ``reason`` is a short slug for the trigger (e.g. the red rule's
    name); ``trigger`` rides in the manifest verbatim; ``dir`` overrides
    the artifact sink (tests); ``health_dump`` is the sentinel's rule/
    actuation state at the moment of triggering."""
    base = _artifacts.artifact_dir() if dir is None else os.path.abspath(dir)
    os.makedirs(base, exist_ok=True)
    stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    name = f"bundle_{stamp}_{os.getpid()}_{next(_SEQ):04d}"
    tmp = os.path.join(base, f".tmp-{name}")
    final = os.path.join(base, name)
    os.makedirs(tmp)
    sections = _collect_sections(health_dump)
    files = {}
    for fname, content in sorted(sections.items()):
        data = content.encode()
        with open(os.path.join(tmp, fname), "wb") as f:
            f.write(data)
        files[fname] = {
            "bytes": len(data),
            "sha256": hashlib.sha256(data).hexdigest(),
        }
    manifest = {
        "schema": SCHEMA,
        "generated_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "reason": reason,
        "trigger": trigger or {},
        "pid": os.getpid(),
        "files": files,
    }
    with open(os.path.join(tmp, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    os.rename(tmp, final)
    return final


def read_manifest(bundle_dir: str, verify: bool = True) -> dict:
    """Load and validate a bundle's manifest: schema, file presence, and
    (``verify=True``) byte sizes + sha256 digests. Raises ``ValueError``
    on any mismatch — a bundle that fails this was torn or tampered."""
    path = os.path.join(bundle_dir, MANIFEST_NAME)
    with open(path) as f:
        manifest = json.load(f)
    if manifest.get("schema") != SCHEMA:
        raise ValueError(
            f"bundle manifest schema {manifest.get('schema')!r} != {SCHEMA!r}"
        )
    files = manifest.get("files")
    if not isinstance(files, dict) or not files:
        raise ValueError("bundle manifest indexes no files")
    for fname, meta in files.items():
        fpath = os.path.join(bundle_dir, fname)
        if not os.path.isfile(fpath):
            raise ValueError(f"bundle file missing: {fname}")
        if not verify:
            continue
        with open(fpath, "rb") as f:
            data = f.read()
        if len(data) != meta.get("bytes"):
            raise ValueError(
                f"bundle file {fname}: {len(data)} bytes != manifest "
                f"{meta.get('bytes')}"
            )
        digest = hashlib.sha256(data).hexdigest()
        if digest != meta.get("sha256"):
            raise ValueError(f"bundle file {fname}: sha256 mismatch")
    return manifest
