"""Atomic epoch persistence: the durable half of the epoch store.

Counterpart of ``roaringbitmap_tpu/durable/store.py``. A
:class:`DurableStore` owns one on-disk root of frozen epoch artifacts::

    <root>/epoch_00000042/
        corpus.rbd      the frozen mmap corpus (durable/format.py)
        lineage.json    epoch id + the lineage ledger tail at persist
        MANIFEST.json   schema + {bytes, sha256} per file — written LAST

**Atomicity**: everything lands in a hidden ``.tmp-epoch_…`` sibling
first, data files are fsynced, the manifest is written last inside the
tmp dir, then one ``os.rename`` publishes the directory and the parent
dir is fsynced. A crash at any point leaves either the previous complete
epoch or a ``.tmp-`` orphan the next persist sweeps — never a
half-readable artifact (recovery re-verifies the manifest's sha256s too,
so even a torn rename degrades to "skip this epoch, use its parent").

**Persistence is a priced decision** (``durable.persist``, the epoch
authority's second engine pair, ``cost/epoch.py``): :meth:`maybe_persist`
weighs persist-now (the predicted snapshot wall from the artifact size)
against skip (published-but-unpersisted lineage priced at the declared
durability exchange rate), records the verdict and joins a taken
persist's measured wall.

**Fault site** ``durable.persist`` fails CLOSED: a non-fatal failure
aborts the persist, the published epoch stays memory-only (the pending
gauge keeps counting; the ``epoch-persist-stall`` rule owns "behind for
too long"), and nothing on disk is disturbed. This is the JAX package's
semantics, not a device fallback. The fault point is probed at every
stage boundary, so one schedule can stop a persist at any of the five
crash points.

**Snapshot consistency**: the corpus is serialized under a reader ticket
(:meth:`EpochStore.reader`) — the flip's drain waits out reader pins
before mutating, so a persist admitted under epoch N reads exactly epoch
N's bits. Disk I/O happens outside the ticket; only the in-memory
serialize holds a pin. Every heap bitmap's serialize counts in
``rb_tpu_serial_bytes_total{direction="serialize"}``.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
import weakref
from typing import List, Optional

from ..cost import epoch as _epoch_cost
from ..observe import decisions as _decisions
from ..observe import outcomes as _outcomes
from ..observe import registry as _registry
from ..observe import timeline as _timeline
from ..observe.histogram import latency_histogram
from ..robust import errors as _rerrors
from ..robust import faults as _faults
from ..robust import ladder as _ladder
from ..serialization import serialize as _serialize
from . import format as _format

SCHEMA = "rb_tpu_durable/1"
MANIFEST_NAME = "MANIFEST.json"
CORPUS_NAME = "corpus.rbd"
LINEAGE_NAME = "lineage.json"

# the declared persist-stage label set (rb_tpu_durable_persist_stage_seconds):
# snapshot = serialize under a reader ticket + write + fsync the corpus,
# lineage = ledger tail write + fsync, manifest = sha256 index written
# last inside tmp, publish = atomic rename + parent fsync + old-epoch GC
PERSIST_STAGES = ("snapshot", "lineage", "manifest", "publish")
PERSIST_OUTCOMES = ("persisted", "skipped", "aborted")
DEFAULT_KEEP = 2

PERSIST_STAGE_SECONDS = latency_histogram(
    _registry.DURABLE_PERSIST_STAGE_SECONDS,
    "Durable persist stage walls (snapshot = corpus serialize + write + "
    "fsync, lineage = ledger write + fsync, manifest = sha256 index, "
    "publish = atomic rename + GC)",
    ("stage",),
)
_PERSIST_TOTAL = _registry.counter(
    _registry.DURABLE_PERSIST_TOTAL,
    "Epoch persists by outcome (persisted | skipped = priced skip "
    "verdict | aborted = fault, epoch stays memory-only)",
    ("outcome",),
)
_PERSIST_BYTES = _registry.counter(
    _registry.DURABLE_PERSIST_BYTES_TOTAL,
    "Artifact bytes written by completed persists (corpus + lineage + "
    "manifest)",
)
_EPOCH_GAUGE = _registry.gauge(
    _registry.DURABLE_EPOCH_COUNT,
    "Newest durably persisted epoch id (a gauge VALUE — epoch ids are "
    "unbounded and never metric label values); -1 until the first "
    "persist completes",
)
_ARTIFACT_GAUGE = _registry.gauge(
    _registry.DURABLE_ARTIFACT_BYTES,
    "Size of the newest complete epoch artifact on disk",
)
_PENDING_GAUGE = _registry.gauge(
    _registry.DURABLE_PENDING_COUNT,
    "Published epochs not yet durable (serving epoch minus persisted "
    "epoch) — the epoch-persist-stall sentinel's depth signal",
)
_WALL_GAUGE = _registry.gauge(
    _registry.DURABLE_PERSIST_WALL_SECONDS,
    "Wall seconds of the last completed persist",
)

# the most recently constructed durable store: insights.durable()'s live
# source (a weakref — tests
# constructing many stores never leak them through this module)
_CURRENT: Optional["weakref.ref[DurableStore]"] = None


def current_store() -> Optional["DurableStore"]:
    """The live process DurableStore (newest constructed), or None."""
    ref = _CURRENT
    return ref() if ref is not None else None


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def epoch_dir_name(epoch: int) -> str:
    return f"epoch_{int(epoch):08d}"


class DurableStore:
    """One on-disk root of frozen epoch artifacts + the persist policy."""

    def __init__(self, root: str, keep: int = DEFAULT_KEEP):
        global _CURRENT
        self.root = root
        self.keep = max(1, int(keep))
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()  # leaf: guards the fields below only
        self._last_epoch: Optional[int] = None  # guarded-by: self._lock
        self._last_dir: Optional[str] = None  # guarded-by: self._lock
        self._last_wall_s: Optional[float] = None  # guarded-by: self._lock
        self._last_bytes = 0  # guarded-by: self._lock
        self._persists = 0  # guarded-by: self._lock
        _CURRENT = weakref.ref(self)

    # -- the atomic persist --------------------------------------------------

    def persist(self, store, reason: str = "flip") -> dict:
        """Persist ``store``'s current epoch (corpus + lineage tail)
        atomically. Returns the persist record; ``outcome`` is one of
        :data:`PERSIST_OUTCOMES` (never ``skipped`` here — pricing lives
        in :meth:`maybe_persist`). Safe from any thread: the snapshot is
        serialized under a reader ticket, so it can never tear against a
        concurrent flip."""
        t0 = time.perf_counter()
        try:
            # crash point 1: before anything touches disk
            _faults.fault_point("durable.persist")
            with _timeline.tspan("durable.persist", "durable", reason=reason):
                with _timeline.stage(
                    PERSIST_STAGE_SECONDS, "snapshot", "durable.snapshot",
                    cat="durable",
                ):
                    with store.reader():
                        epoch = store.current()
                        blobs: List[bytes] = [
                            bm.serialize()
                            if isinstance(bm, _format.ImmutableRoaringBitmap)
                            else _serialize(bm)
                            for bm in store.corpus
                        ]
                        lineage = store.lineage()
                    final = os.path.join(self.root, epoch_dir_name(epoch))
                    tmp = os.path.join(
                        self.root, f".tmp-{epoch_dir_name(epoch)}"
                    )
                    self._sweep_tmp()
                    if os.path.isdir(final):
                        # this epoch is already durable (idempotent
                        # re-persist, e.g. a retried schedule)
                        _PERSIST_TOTAL.inc(1, ("persisted",))
                        return {
                            "outcome": "persisted", "epoch": epoch,
                            "dir": final, "fresh": False,
                        }
                    os.makedirs(tmp)
                    stats = _format.write_corpus(
                        os.path.join(tmp, CORPUS_NAME), blobs
                    )
                # crash point 2: corpus written, no lineage/manifest yet
                _faults.fault_point("durable.persist")
                with _timeline.stage(
                    PERSIST_STAGE_SECONDS, "lineage", "durable.lineage",
                    cat="durable",
                ):
                    lineage_path = os.path.join(tmp, LINEAGE_NAME)
                    with open(lineage_path, "w") as f:
                        json.dump(
                            {
                                "schema": SCHEMA,
                                "epoch": epoch,
                                "reason": reason,
                                "ts": time.time(),
                                "lineage": lineage,
                            },
                            f,
                        )
                        f.flush()
                        os.fsync(f.fileno())
                # crash point 3: data files down, manifest missing (torn)
                _faults.fault_point("durable.persist")
                with _timeline.stage(
                    PERSIST_STAGE_SECONDS, "manifest", "durable.manifest",
                    cat="durable",
                ):
                    files = {}
                    for fname in (CORPUS_NAME, LINEAGE_NAME):
                        p = os.path.join(tmp, fname)
                        files[fname] = {
                            "bytes": os.path.getsize(p),
                            "sha256": _sha256_file(p),
                        }
                    manifest = {
                        "schema": SCHEMA,
                        "epoch": epoch,
                        "reason": reason,
                        "ts": time.time(),
                        "n_bitmaps": stats["n"],
                        "files": files,
                    }
                    with open(os.path.join(tmp, MANIFEST_NAME), "w") as f:
                        json.dump(manifest, f, indent=1)
                        f.flush()
                        os.fsync(f.fileno())
                # crash point 4: manifest complete but still in .tmp-
                _faults.fault_point("durable.persist")
                with _timeline.stage(
                    PERSIST_STAGE_SECONDS, "publish", "durable.publish",
                    cat="durable", epoch=epoch,
                ):
                    os.rename(tmp, final)
                    _fsync_dir(self.root)
                    self._gc(keep_epoch=epoch)
                # crash point 5: published — recovery MUST find this epoch
                _faults.fault_point("durable.persist")
        except Exception as e:
            if _rerrors.classify(e) == _rerrors.FATAL:
                raise
            # fail CLOSED: the published epoch stays memory-only, disk
            # keeps the previous complete artifact, the pending gauge
            # keeps counting and the epoch-persist-stall sentinel owns
            # the "behind for too long" signal
            _ladder.LADDER.note_degrade(
                "durable.persist", "persist", "memory-only", e
            )
            _PERSIST_TOTAL.inc(1, ("aborted",))
            _decisions.record_decision(
                "durable.persist", "aborted", reason=reason,
                error=type(e).__name__,
            )
            return {"outcome": "aborted", "reason": reason,
                    "error": type(e).__name__}
        wall_s = round(time.perf_counter() - t0, 6)
        artifact_bytes = sum(f["bytes"] for f in files.values())
        artifact_bytes += os.path.getsize(os.path.join(final, MANIFEST_NAME))
        with self._lock:
            self._last_epoch = epoch
            self._last_dir = final
            self._last_wall_s = wall_s
            self._last_bytes = artifact_bytes
            self._persists += 1
        _PERSIST_TOTAL.inc(1, ("persisted",))
        _PERSIST_BYTES.inc(artifact_bytes)
        _EPOCH_GAUGE.set(epoch)
        _ARTIFACT_GAUGE.set(artifact_bytes)
        _WALL_GAUGE.set(wall_s)
        _PENDING_GAUGE.set(max(0, store.current() - epoch))
        # from now on evictions of map-covered working sets can demote
        # to the mapped rung instead of discarding (priced by the
        # residency authority's readmit curve)
        _install_demotion_probe(self)
        return {
            "outcome": "persisted",
            "epoch": epoch,
            "dir": final,
            "fresh": True,
            "artifact_bytes": artifact_bytes,
            "n_bitmaps": stats["n"],
            "wall_s": wall_s,
        }

    # -- the priced verdict --------------------------------------------------

    def maybe_persist(self, store, reason: str = "flip") -> dict:
        """The persist-now-vs-skip verdict, priced by the epoch
        authority's persist curves: persist when the unpersisted
        lineage's exposure (priced at the declared durability exchange
        rate) outweighs the predicted snapshot wall. A taken persist's
        decision is joined with its measured wall; a skip is
        decision-logged but not joined (nothing executes)."""
        epoch = store.current()
        pending = self.pending_epochs(store)
        if pending <= 0:
            return {"outcome": "noop", "epoch": epoch}
        est_kb = self._estimate_kb(store)
        predicted_persist = _epoch_cost.MODEL.predict_persist_us(est_kb)
        skip_cost = _epoch_cost.MODEL.exposure_cost_us(pending)
        verdict = "persist" if skip_cost >= predicted_persist else "skip"
        seq = _decisions.record_decision(
            "durable.persist", verdict,
            outcome=(verdict == "persist" and _outcomes.enabled()),
            est_us={"persist": predicted_persist, "skip": skip_cost},
            pending=pending, artifact_kb=round(est_kb, 3), epoch=epoch,
            reason=reason,
        )
        if verdict == "skip":
            _PERSIST_TOTAL.inc(1, ("skipped",))
            _PENDING_GAUGE.set(pending)
            return {
                "outcome": "skipped", "epoch": epoch, "pending": pending,
            }
        t0 = time.perf_counter()
        record = self.persist(store, reason=reason)
        if record["outcome"] == "persisted" and seq is not None:
            _outcomes.resolve(
                seq, "durable.persist", time.perf_counter() - t0,
                engine="persist",
            )
        return record

    def on_flip(self, store, flip_record: dict) -> dict:
        """The epoch store's post-publish hook (EpochStore calls this
        after every published flip when attached): refresh the pending
        gauge and run the priced persist verdict."""
        _PENDING_GAUGE.set(self.pending_epochs(store))
        return self.maybe_persist(store, reason="flip")

    # -- views ---------------------------------------------------------------

    def pending_epochs(self, store) -> int:
        """Published epochs not yet durable (0 = fully caught up).
        Before the first persist the whole history is exposed, including
        the initial epoch-0 corpus."""
        with self._lock:
            last = self._last_epoch
        return store.current() - (last if last is not None else -1)

    def stats(self) -> dict:
        with self._lock:
            return {
                "root": self.root,
                "keep": self.keep,
                "persisted_epoch": self._last_epoch,
                "dir": self._last_dir,
                "artifact_bytes": self._last_bytes,
                "last_wall_s": self._last_wall_s,
                "persists": self._persists,
            }

    # -- internals -----------------------------------------------------------

    def _estimate_kb(self, store) -> float:
        """Predicted artifact size for the pricing input: the last
        measured artifact when one exists (the corpus drifts slowly
        between persists), else the corpus's own serialized-size sum."""
        with self._lock:
            if self._last_bytes:
                return self._last_bytes / 1024.0
        total = 0
        for bm in store.corpus:
            total += bm.serialized_size_in_bytes()
        return total / 1024.0

    def _sweep_tmp(self) -> None:
        """Remove ``.tmp-`` orphans a crashed persist left behind."""
        for name in os.listdir(self.root):
            if name.startswith(".tmp-"):
                shutil.rmtree(os.path.join(self.root, name),
                              ignore_errors=True)

    def _gc(self, keep_epoch: int) -> None:
        """Prune complete epoch dirs beyond ``keep`` newest (never the
        one just published)."""
        epochs = []
        for name in os.listdir(self.root):
            if name.startswith("epoch_"):
                try:
                    epochs.append((int(name[len("epoch_"):]), name))
                except ValueError:
                    continue
        epochs.sort(reverse=True)
        for num, name in epochs[self.keep:]:
            if num != keep_epoch:
                shutil.rmtree(os.path.join(self.root, name),
                              ignore_errors=True)


def _install_demotion_probe(dstore: "DurableStore") -> None:
    """Point the pack cache's eviction policy at this store: once an
    epoch artifact is on disk, evicting a working set demotes it to the
    mapped rung (re-admittable from the map at the readmit curve's
    price) instead of discarding it outright."""
    from ..parallel import store as _pstore

    ref = weakref.ref(dstore)

    def probe(kind: str) -> bool:
        d = ref()
        if d is None:
            return False
        with d._lock:
            return d._last_dir is not None

    _pstore.set_demotion_probe(probe)
