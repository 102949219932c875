"""Warm restart: discover, verify and re-serve the newest durable epoch.

Counterpart of ``roaringbitmap_tpu/durable/recovery.py``. ``recover(root)``
walks the epoch dirs newest first, re-verifies each manifest (schema, byte
sizes, sha256 — a torn artifact is counted under
``rb_tpu_durable_recovery_total{outcome="torn"}``, skipped, and raised by
the ``recovery-manifest-torn`` rule), maps the first complete corpus and
rehydrates the lineage ledger. The returned :class:`Recovery` serves reads
at once off the map (header parse only, payloads OS-paged), resumes an
:class:`~..serve.epochs.EpochStore` at the persisted epoch, and
:meth:`Recovery.readmit` re-warms pack-cache working sets straight from
the map on ``aggregation.config.device`` — each readmit a priced
``durable.readmit`` decision joined with its measured wall, the traffic
that teaches the residency authority's ``readmit_s`` curve.

The contract: a process stopped at any persist or flip stage recovers to
the last epoch whose persist published (the ``os.rename``), bit for bit —
never a torn state, never older than a completed persist.

:meth:`Recovery.close` closes the map. Views into it that a resident pack
still holds (the pack cache keeps the container arrays behind
``("static", id)`` fingerprints) make Python refuse to close an ``mmap``
with exported buffers; as in the JAX package, the close drops the
corpus's own views, collects, and raises ``BufferError`` while a consumer
still holds one — close the pack cache's entries first.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import List, Optional

from ..observe import decisions as _decisions
from ..observe import outcomes as _outcomes
from ..observe import registry as _registry
from . import format as _format
from .store import (
    CORPUS_NAME,
    LINEAGE_NAME,
    MANIFEST_NAME,
    SCHEMA,
    _EPOCH_GAUGE,
)

_RECOVERY_TOTAL = _registry.counter(
    _registry.DURABLE_RECOVERY_TOTAL,
    "Recovery attempts by outcome (recovered | torn = a manifest failed "
    "verification and its epoch was skipped | empty = no complete "
    "artifact found)",
    ("outcome",),
)

# the last recovery's provenance (for the insights durable panel): set by recover(), None until a recovery ran in this
# process
LAST: Optional[dict] = None


def verify_manifest(epoch_dir: str) -> dict:
    """Re-verify one epoch dir's manifest: schema, file presence, byte
    sizes, sha256 digests. Returns the manifest; raises ``ValueError``
    on any mismatch (the caller treats that epoch as torn)."""
    path = os.path.join(epoch_dir, MANIFEST_NAME)
    with open(path) as f:
        manifest = json.load(f)
    if manifest.get("schema") != SCHEMA:
        raise ValueError(
            f"unexpected durable schema {manifest.get('schema')!r}"
        )
    files = manifest.get("files")
    if not isinstance(files, dict) or set(files) != {
        CORPUS_NAME, LINEAGE_NAME,
    }:
        raise ValueError("manifest file index incomplete")
    for fname, meta in files.items():
        p = os.path.join(epoch_dir, fname)
        if not os.path.isfile(p):
            raise ValueError(f"durable file {fname} missing")
        if os.path.getsize(p) != meta.get("bytes"):
            raise ValueError(f"durable file {fname}: size mismatch")
        h = hashlib.sha256()
        with open(p, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        if h.hexdigest() != meta.get("sha256"):
            raise ValueError(f"durable file {fname}: sha256 mismatch")
    return manifest


def _epoch_dirs(root: str) -> List[str]:
    """Complete-looking epoch dirs, newest first (``.tmp-`` orphans are
    by construction never candidates)."""
    out = []
    for name in os.listdir(root):
        if name.startswith("epoch_") and os.path.isdir(
            os.path.join(root, name)
        ):
            try:
                out.append((int(name[len("epoch_"):]), name))
            except ValueError:
                continue
    out.sort(reverse=True)
    return [os.path.join(root, name) for _num, name in out]


class Recovery:
    """One verified durable epoch, mapped and ready to serve."""

    def __init__(self, epoch_dir: str, manifest: dict, torn_skipped: int,
                 wall_s: float):
        self.dir = epoch_dir
        self.epoch = int(manifest["epoch"])
        self.corpus = _format.MappedCorpus(
            os.path.join(epoch_dir, CORPUS_NAME)
        )
        with open(os.path.join(epoch_dir, LINEAGE_NAME)) as f:
            self.lineage: List[dict] = json.load(f).get("lineage") or []
        self.provenance = {
            "dir": epoch_dir,
            "epoch": self.epoch,
            "n_bitmaps": len(self.corpus),
            "artifact_bytes": self.corpus.artifact_bytes,
            "torn_skipped": torn_skipped,
            "wall_s": round(wall_s, 6),
            "persisted_ts": manifest.get("ts"),
        }

    def bitmap(self, i: int):
        return self.corpus.bitmap(i)

    def resume_store(self, **kwargs):
        """An EpochStore resumed at the persisted epoch: the corpus is
        deep-copied to mutable bitmaps (ingest continues mutating in
        place; the mapped originals stay frozen for the read path and
        the pack cache), and the lineage ledger is rehydrated so the
        replay oracle and the observatory see an unbroken history."""
        from ..serve.epochs import EpochStore

        store = EpochStore(
            [self.corpus.bitmap(i).to_mutable()
             for i in range(len(self.corpus))],
            **kwargs,
        )
        store.restore(self.epoch, self.lineage)
        return store

    def readmit(self, working_sets=None) -> dict:
        """Re-warm pack-cache working sets straight from the map (the
        lazy half of the warm restart): each set is packed from the
        mapped bitmaps' zero-copy container views — no deserialize, no
        mutable copies. Every readmit is a priced ``durable.readmit``
        decision joined with its measured wall; those joins teach the
        residency authority's mapped-rung ``readmit_s`` curve."""
        from ..cost import residency as _residency
        from ..parallel import aggregation as _agg
        from ..parallel import store as _pstore

        if working_sets is None:
            working_sets = [tuple(range(len(self.corpus)))]
        readmitted = 0
        wall_total = 0.0
        for ws in working_sets:
            bitmaps = [self.corpus.bitmap(i) for i in ws]
            est_s = _residency.MODEL.readmit_estimate("agg")
            inputs = {"kind": "agg", "bitmaps": len(ws)}
            if est_s:
                inputs["est_us"] = {"readmit": round(est_s * 1e6, 1)}
            seq = _decisions.record_decision(
                "durable.readmit", "readmit",
                outcome=_outcomes.enabled(), **inputs,
            )
            t0 = time.perf_counter()
            _pstore.packed_for(bitmaps, device=_agg.config.device)
            wall = time.perf_counter() - t0
            wall_total += wall
            readmitted += 1
            if seq is not None:
                _outcomes.resolve(
                    seq, "durable.readmit", wall, engine="readmit"
                )
        # fold the fresh joins into the readmit curve right away: a
        # restart is exactly when the curve should learn fastest
        _residency.MODEL.refit_from_outcomes()
        return {
            "working_sets": readmitted,
            "wall_s": round(wall_total, 6),
        }

    def close(self) -> None:
        self.corpus.close()


def recover(root: str) -> Optional[Recovery]:
    """Discover and map the newest complete epoch under ``root``.
    Returns None (outcome ``empty``) when no epoch dir verifies; torn
    candidates are counted, skipped, and surfaced through
    ``rb_tpu_durable_recovery_total{outcome="torn"}`` (the
    ``recovery-manifest-torn`` sentinel's signal)."""
    global LAST
    t0 = time.perf_counter()
    torn = 0
    if os.path.isdir(root):
        for epoch_dir in _epoch_dirs(root):
            try:
                manifest = verify_manifest(epoch_dir)
            except (OSError, ValueError, KeyError) as e:
                # torn: crashed mid-persist on a non-atomic filesystem,
                # truncated by the crash, or bit-rotted — fall back to
                # its parent epoch rather than serving corrupt bits
                torn += 1
                _RECOVERY_TOTAL.inc(1, ("torn",))
                _decisions.record_decision(
                    "durable.recover", "torn", dir=epoch_dir,
                    error=type(e).__name__,
                )
                continue
            rec = Recovery(
                epoch_dir, manifest, torn, time.perf_counter() - t0
            )
            _RECOVERY_TOTAL.inc(1, ("recovered",))
            _EPOCH_GAUGE.set(rec.epoch)
            LAST = dict(rec.provenance)
            return rec
    _RECOVERY_TOTAL.inc(1, ("empty",))
    LAST = {"dir": None, "epoch": None, "torn_skipped": torn,
            "wall_s": round(time.perf_counter() - t0, 6)}
    return None
