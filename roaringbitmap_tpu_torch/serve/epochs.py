"""Epoch ledger: snapshot-isolated publication of the streaming write
path.

Counterpart of ``roaringbitmap_tpu/serve/epochs.py``. The serving corpus
advances in **epochs**. Readers are admitted under the current epoch and
pinned to it for the whole execution; writers only append stamped batches
to the ingest log (``serve/ingest.py``). The corpus bitmaps are mutated at
exactly one place — the **epoch flip** — inside a writer-exclusive
window, in four stages (each a ``rb_tpu_serve_flip_stage_seconds{stage}``
sample and a timeline span):

* ``drain``   — seal admission (new readers park on the store condition),
  wait for in-flight readers of the current epoch to finish, then wait for
  the card: a reader count of 0 says only that the readers' host threads
  returned, and device work they queued on another stream (the overlap
  lane's staging stream, a hedged solo dispatch) may still be reading the
  resident rows. The drain synchronizes the device the packs live on
  (``torch.cuda.synchronize``), so every stream's queued work finishes
  before the repack patches rows in place. After drain nobody is reading,
  so the in-place mutation cannot tear anyone: a reader sees exactly
  pre-flip or post-flip bits.
* ``repack``  — drain the mutation log, stream the merged batches through
  the sorted-stream writer (``BitmapWriter(into=...)``), then refresh each
  registered working set through ``store.packed_for`` on
  ``aggregation.config.device``: a warm set whose containers mutated in
  place takes the delta route, one ``index_copy_`` of the dirty rows into
  the resident flat rows (the lineage record carries the route of every
  refresh, read from ``PackCache.last_route``). The stage fails closed:
  where the JAX package degrades a device fault to a CPU tier, this
  package raises, so a raise inside the stage puts the touched containers
  back (from copies taken before the writer ran) and returns a retryable
  failure's batches to the head of the log before it propagates; the
  corpus stays the old epoch's, bit for bit.
* ``publish`` — bump the epoch, append the lineage record (epoch id,
  parent, included batch ids, flip wall), export the epoch gauge, and
  observe every published batch's ingest->queryable lag into
  ``rb_tpu_serve_freshness_seconds{tenant}``.
* ``reclaim`` — reopen admission (parked readers wake under the new
  epoch) and settle state, on every exit path.

Readers pinned by :meth:`EpochStore.reader` can never overlap the mutation
window, and a result published from outside a reader pin is still dropped
by the in-flight table's fingerprint re-validation: the flip's writer bumps
every touched bitmap's ``fingerprint()``.

**The flip is a priced decision** (``epoch.flip``, ``cost/epoch.py``):
:meth:`EpochStore.maybe_flip` weighs flip-now (the predicted flip wall)
against accumulate-more (pending staleness priced at the declared exchange
rate), records the verdict with its inputs, and joins a taken flip's
measured wall in the decision–outcome ledger.

Epoch ids are unbounded: they ride the lineage ledger, span attributes and
decision inputs, never metric label values.

Fault site ``epoch.flip``: a non-fatal failure at the flip entry fails
CLOSED to the old epoch — the flip aborts, the log keeps accumulating,
readers keep serving the last published snapshot (stale, never torn), and
the degrade is noted on the ladder. This is the JAX package's semantics,
not a device fallback: a device failure inside the repack (``store.ship``,
``store.expand``, ``ops.dispatch``) propagates, classified, after the
reclaim stage reopens admission.

Lock discipline: the store condition is a leaf — it guards the epoch
counter, reader count, flip flag and lineage ring only. The repack stage
runs outside it (admission is sealed by the flag), and every metric bump
and decision record happens outside too.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..observe import decisions as _decisions
from ..observe import outcomes as _outcomes
from ..observe import registry as _registry
from ..observe import structure as _structure
from ..observe import timeline as _timeline
from ..observe.histogram import latency_histogram
from ..robust import errors as _rerrors
from ..robust import faults as _faults
from ..robust import ladder as _ladder
from ..cost import epoch as _epoch_cost
from . import ingest as _ingest
from .ingest import IngestLog

# the declared flip-stage label set (rb_tpu_serve_flip_stage_seconds)
FLIP_STAGES = ("drain", "repack", "publish", "reclaim")
# flip outcomes (rb_tpu_serve_epoch_flip_total)
FLIP_OUTCOMES = ("flipped", "noop", "aborted", "stalled")

DEFAULT_MAX_LINEAGE = 256
# a drain that cannot complete within this window is a stall, not a wait:
# the flip aborts (stale-but-consistent) and the stall is visible to the
# epoch-flip-stall sentinel rule via the still-nonzero mutlog gauge
DEFAULT_DRAIN_TIMEOUT_S = 30.0

FLIP_STAGE_SECONDS = latency_histogram(
    _registry.SERVE_FLIP_STAGE_SECONDS,
    "Epoch flip stage walls (drain = seal + wait for in-flight readers, "
    "repack = writer stream + O(k) delta repack per touched working set, "
    "publish = epoch bump + lineage + freshness, reclaim = reopen "
    "admission)",
    ("stage",),
)
_FLIP_TOTAL = _registry.counter(
    _registry.SERVE_EPOCH_FLIP_TOTAL,
    "Epoch flips by outcome (flipped | noop = empty log | aborted = "
    "fault/degrade, old epoch kept | stalled = reader drain timed out)",
    ("outcome",),
)
_EPOCH_COUNT = _registry.gauge(
    _registry.SERVE_EPOCH_COUNT,
    "Current published epoch id of the serving corpus (a gauge VALUE — "
    "epoch ids are unbounded and never metric label values)",
)

# the most recently constructed store: the insights epoch panel's and the
# flight bundle's lineage source (a weakref — tests constructing many
# stores never leak them through this module)
_CURRENT: Optional["weakref.ref[EpochStore]"] = None


def current_store() -> Optional["EpochStore"]:
    """The live process EpochStore (newest constructed), or None."""
    ref = _CURRENT
    return ref() if ref is not None else None


def _undo_log(corpus, merged) -> list:
    """``(bitmap index, key, container clone or None)`` for every container
    the merged values will touch: enough to put the corpus back as it was
    before :func:`ingest.apply_merged` (values are only ever added, so the
    touched keys are the values' high 16 bits). Indices outside the corpus
    are skipped: ``apply_merged`` raises on them."""
    undo = []
    for idx, values in merged.items():
        if not 0 <= idx < len(corpus):
            continue
        hlc = corpus[idx].high_low_container
        for key in np.unique(np.asarray(values, dtype=np.int64) >> 16).tolist():
            i = hlc.get_index(key)
            undo.append((idx, key, hlc.containers[i].clone() if i >= 0 else None))
    return undo


def _undo(corpus, undo: list) -> None:
    """Restore every container :func:`_undo_log` recorded, through the
    container array's mutators (so the pack cache sees the keys dirty)."""
    for idx, key, c in undo:
        hlc = corpus[idx].high_low_container
        i = hlc.get_index(key)
        if c is None:
            if i >= 0:
                hlc.remove_at_index(i)
        elif i >= 0:
            hlc.set_container_at_index(i, c)
        else:
            hlc.insert_new_key_value_at(-i - 1, key, c)


def _quiesce_device() -> None:
    """Order the flip's repack after every stream that reads the resident
    packs: one ``torch.cuda.synchronize`` of the device the working sets
    are packed on (``aggregation.config.device``). That covers the overlap
    lane's staging stream and the hedged solo dispatches as well as the
    default stream, without tracking the readers' streams one by one. A
    CPU device, or a process that never initialized CUDA, has nothing in
    flight."""
    from ..parallel import aggregation as _agg

    dev = torch.device(_agg.config.device)
    if dev.type == "cuda" and torch.cuda.is_initialized():
        torch.cuda.synchronize(dev)


class EpochTicket:
    """One reader admission: pins the epoch the reader was admitted
    under until :meth:`release` (use as a context manager). The flip's
    drain stage waits on these pins — holding one guarantees the corpus
    cannot mutate under the reader."""

    __slots__ = ("store", "epoch", "_released")

    def __init__(self, store: "EpochStore", epoch: int):
        self.store = store
        self.epoch = epoch
        self._released = False

    def release(self) -> None:
        if not self._released:
            self._released = True
            self.store._release_reader()

    def __enter__(self) -> "EpochTicket":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class EpochStore:
    """The epoch-versioned serving corpus: a list of bitmaps, the ingest
    log feeding it, and the flip machinery publishing new epochs."""

    def __init__(
        self,
        corpus: Sequence,
        log: Optional[IngestLog] = None,
        max_lineage: int = DEFAULT_MAX_LINEAGE,
        drain_timeout_s: float = DEFAULT_DRAIN_TIMEOUT_S,
        clock=time.monotonic,
    ):
        global _CURRENT
        if not len(corpus):
            raise ValueError("epoch store needs a non-empty corpus")
        self.corpus = list(corpus)
        self.log = log if log is not None else IngestLog()
        self.drain_timeout_s = float(drain_timeout_s)
        self._clock = clock
        self._cond = threading.Condition()  # leaf: guards the fields below only
        self._epoch = 0  # guarded-by: self._cond
        self._readers = 0  # guarded-by: self._cond
        self._flipping = False  # guarded-by: self._cond
        self._lineage: "deque[dict]" = deque(maxlen=int(max_lineage))  # guarded-by: self._cond
        # registered working sets: tuples of corpus indices the repack
        # stage refreshes through the pack cache (default: the whole
        # corpus as one working set)
        self._working_sets: List[Tuple[int, ...]] = [  # guarded-by: self._cond
            tuple(range(len(self.corpus)))
        ]
        # the attached durable store: when set, every
        # published flip runs its priced persist verdict post-publish
        self._durable = None
        _EPOCH_COUNT.set(0)
        _CURRENT = weakref.ref(self)

    # -- durable attachment --------------------------------------------------

    def attach_durable(self, durable) -> None:
        """Attach a ``durable.DurableStore``: after every published
        flip, its :meth:`~..durable.store.DurableStore.on_flip` hook
        refreshes the persist backlog gauge and runs the priced
        persist-now-vs-skip verdict. Detach with ``None``."""
        self._durable = durable

    def restore(self, epoch: int, lineage: Sequence[dict]) -> None:
        """Resume this store at a recovered epoch (durable/recovery.py):
        the epoch counter jumps to the persisted value and the lineage
        ledger is rehydrated, so replay oracles and the observatory see
        an unbroken history across the restart. Only valid before the
        first flip (a freshly constructed store)."""
        with self._cond:
            if self._epoch != 0 or self._lineage:
                raise ValueError(
                    "restore() requires a freshly constructed store"
                )
            self._epoch = int(epoch)
            for rec in lineage:
                self._lineage.append(dict(rec))
        _EPOCH_COUNT.set(int(epoch))

    # -- reader admission ----------------------------------------------------

    def current(self) -> int:
        with self._cond:
            return self._epoch

    def reader(self, timeout_s: Optional[float] = None) -> EpochTicket:
        """Admit one reader under the current epoch (parks while a flip
        is publishing; a bounded park — past ``timeout_s`` it raises
        rather than deadlocking on a wedged flip)."""
        deadline = (
            None if timeout_s is None
            else time.perf_counter() + float(timeout_s)
        )
        with self._cond:
            while self._flipping:
                remaining = (
                    None if deadline is None
                    else deadline - time.perf_counter()
                )
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        "epoch reader admission timed out waiting for an "
                        "in-progress flip"
                    )
                self._cond.wait(remaining)
            self._readers += 1
            return EpochTicket(self, self._epoch)

    def _release_reader(self) -> None:
        with self._cond:
            self._readers -= 1
            if self._readers <= 0:
                self._cond.notify_all()

    def readers(self) -> int:
        with self._cond:
            return self._readers

    # -- working sets --------------------------------------------------------

    def register_working_set(self, indices: Sequence[int]) -> None:
        """Register a working set (corpus indices) the flip keeps
        delta-fresh in the pack cache. The whole corpus is registered by
        default; callers with finer-grained resident sets narrow the
        repack to what is actually resident."""
        ws = tuple(sorted({int(i) for i in indices}))
        if not ws:
            raise ValueError("working set must name at least one bitmap")
        if ws[0] < 0 or ws[-1] >= len(self.corpus):
            raise IndexError(f"working set {ws} outside the corpus")
        full = tuple(range(len(self.corpus)))
        with self._cond:
            if self._working_sets == [full]:
                if ws == full:
                    return  # the default already covers it
                # first narrower registration replaces the default
                self._working_sets = []
            if ws not in self._working_sets:
                self._working_sets.append(ws)

    # -- ingestion (delegates to the log) ------------------------------------

    def submit(self, tenant: str, mutations: Dict, stamp=None):
        """Append one stamped mutation batch (readers unaffected)."""
        return self.log.submit(tenant, mutations, stamp=stamp)

    # -- the flip ------------------------------------------------------------

    def flip(
        self,
        reason: str = "manual",
        now: Optional[float] = None,
        rewrite=None,
    ) -> dict:
        """Publish a new epoch from the pending mutation log. Returns the
        flip record (also appended to the lineage ledger when the flip
        publishes): ``outcome`` is one of :data:`FLIP_OUTCOMES`.

        ``rewrite`` turns the flip into a **compaction**: a
        callable run inside the repack stage's writer-exclusive window,
        after the drained batches are applied — it may rewrite corpus
        containers IN PLACE as long as every rewrite is bit-identical
        (a compaction is just a flip whose batches are rewrites; the
        maintenance pass audits identity per container). It returns
        ``(touched_indices, stats_dict)``; the indices join the batch
        set for the working-set refresh and the stats land on the
        lineage record as ``record["rewrite"]``. A rewrite flip
        publishes even when the mutation log is empty — the new epoch
        IS the compacted corpus."""
        try:
            _faults.fault_point("epoch.flip")
        except Exception as e:
            if _rerrors.classify(e) == _rerrors.FATAL:
                raise
            # fail CLOSED to the old epoch: readers keep serving the last
            # published snapshot (stale, never torn); the log accumulates
            # and the sentinel owns the "stale too long" signal
            _ladder.LADDER.note_degrade("epoch.flip", "flip", "accumulate", e)
            _FLIP_TOTAL.inc(1, ("aborted",))
            with self._cond:
                epoch = self._epoch
            _decisions.record_decision(
                "epoch.flip", "aborted", reason=reason, epoch=epoch,
                error=type(e).__name__,
            )
            return {"outcome": "aborted", "epoch": epoch, "reason": reason}
        if now is None:
            now = self._clock()
        t_flip = time.perf_counter()
        with _timeline.tspan("epoch.flip", "epoch", reason=reason):
            # ---- drain: seal admission, wait out in-flight readers ----
            stalled = False
            batches = []
            with _timeline.stage(
                FLIP_STAGE_SECONDS, "drain", "epoch.drain", cat="epoch",
            ):
                deadline = time.perf_counter() + self.drain_timeout_s
                with self._cond:
                    while self._flipping:  # serialize concurrent flips
                        if not self._cond.wait(deadline - time.perf_counter()):
                            break
                    if self._flipping:
                        stalled = True
                    else:
                        self._flipping = True
                        while self._readers > 0:
                            remaining = deadline - time.perf_counter()
                            if remaining <= 0 or not self._cond.wait(remaining):
                                if self._readers > 0:
                                    stalled = True
                                    self._flipping = False
                                    self._cond.notify_all()
                                break
                    epoch = self._epoch
                if not stalled:
                    try:
                        # no host reader is left; wait for the device work
                        # they queued on any stream before the repack
                        # patches rows (a device fault of theirs surfaces
                        # here)
                        _quiesce_device()
                        # the log drain is part of the drain stage: after
                        # it the writer-exclusive window owns every batch
                        batches = self.log.drain()
                    except BaseException:
                        # reopen admission: a failed drain must not wedge
                        # readers and later flips behind it
                        with self._cond:
                            self._flipping = False
                            self._cond.notify_all()
                        raise
            if stalled:
                _FLIP_TOTAL.inc(1, ("stalled",))
                _decisions.record_decision(
                    "epoch.flip", "stalled", reason=reason, epoch=epoch,
                )
                return {"outcome": "stalled", "epoch": epoch, "reason": reason}
            try:
                if not batches and rewrite is None:
                    _FLIP_TOTAL.inc(1, ("noop",))
                    return {"outcome": "noop", "epoch": epoch, "reason": reason}
                # ---- repack: writer stream + O(k) delta per working set ----
                with _timeline.stage(
                    FLIP_STAGE_SECONDS, "repack", "epoch.repack", cat="epoch",
                    batches=len(batches),
                ):
                    merged = _ingest.merge_batches(batches)
                    touched = sorted(merged)
                    undo = _undo_log(self.corpus, merged)
                    try:
                        _ingest.apply_merged(self.corpus, merged)
                        rewrite_stats = None
                        if rewrite is not None:
                            # the compaction body: runs AFTER the drained
                            # batches land so it re-selects the post-merge
                            # containers, BEFORE the working-set refresh
                            # so the pack cache sees the rewritten rows
                            rewritten, rewrite_stats = rewrite(self.corpus)
                            touched = sorted(set(touched) | set(rewritten))
                        delta = self._repack_working_sets(touched)
                    except BaseException as e:
                        # fail CLOSED to the old epoch: a raise here (a
                        # device fault of the repack, a host-tier fault of
                        # the writer) must not leave unpublished bits in
                        # the corpus. Put back the touched containers (the
                        # compaction's rewrites are bit-identical) and
                        # return a retryable failure's batches to the log
                        _undo(self.corpus, undo)
                        if isinstance(e, Exception) and (
                            _rerrors.classify(e) != _rerrors.FATAL
                        ):
                            self.log.requeue(batches)
                        raise
                # ---- publish: bump epoch, lineage, freshness ----
                with _timeline.stage(
                    FLIP_STAGE_SECONDS, "publish", "epoch.publish",
                    cat="epoch", epoch=epoch + 1,
                ):
                    record = {
                        "outcome": "flipped",
                        "epoch": epoch + 1,
                        "parent": epoch,
                        "reason": reason,
                        "batches": [b.batch_id for b in batches],
                        "tenants": sorted({b.tenant for b in batches}),
                        "values": int(sum(b.n_values for b in batches)),
                        "touched_bitmaps": touched,
                        "delta": delta,
                        "ts": now,
                    }
                    if rewrite_stats is not None:
                        record["rewrite"] = rewrite_stats
                    with self._cond:
                        self._epoch = epoch + 1
                        self._lineage.append(record)
                    _EPOCH_COUNT.set(epoch + 1)
                    _ingest.observe_freshness(batches, now=self._clock())
                    if batches:
                        # the structure observatory's accretion-depth
                        # gauge: delta batches folded into the corpus
                        # since the last maintenance pass settled it
                        _structure.LEDGER.accrete(len(batches))
            finally:
                # ---- reclaim: reopen admission (parked readers wake
                # under the new epoch), settle state on EVERY exit path —
                # an exception inside repack/publish must not wedge
                # admission shut
                with _timeline.stage(
                    FLIP_STAGE_SECONDS, "reclaim", "epoch.reclaim",
                    cat="epoch",
                ):
                    with self._cond:
                        self._flipping = False
                        self._cond.notify_all()
        record["wall_s"] = round(time.perf_counter() - t_flip, 6)
        _FLIP_TOTAL.inc(1, ("flipped",))
        durable = self._durable
        if durable is not None:
            # post-publish durability hook: the persist
            # verdict is priced and fails CLOSED inside the durable
            # store (only FATAL propagates), so an aborted persist
            # leaves this flip's record — and the published epoch —
            # untouched in memory
            durable_rec = durable.on_flip(self, record)
            record["durable"] = durable_rec.get("outcome")
        return record

    def _repack_working_sets(self, touched: List[int]) -> dict:
        """Refresh every registered working set that intersects the
        touched bitmaps through the pack cache (ONE get_packed per set —
        a warm mutated set takes the O(k) ``apply_delta`` path). Each
        refresh is classified through ``PackCache.last_route`` (a
        thread-local read, so concurrent non-epoch cache users cannot
        pollute the lineage's delta-vs-full evidence)."""
        from ..parallel import aggregation as _agg
        from ..parallel import store as _store

        touched_set = set(touched)
        sets_repacked = 0
        delta_rows = 0
        full_repacks = 0
        with self._cond:
            working_sets = list(self._working_sets)
        for ws in working_sets:
            if not touched_set.intersection(ws):
                continue
            _store.packed_for([self.corpus[i] for i in ws], device=_agg.config.device)
            sets_repacked += 1
            route = _store.PACK_CACHE.last_route()
            if route is not None:
                kind, rows = route
                delta_rows += int(rows)
                if kind == "full":
                    full_repacks += 1
        return {
            "working_sets": sets_repacked,
            "delta_rows": delta_rows,
            "full_repacks": full_repacks,
        }

    # -- the priced verdict (the seventh cost authority) ---------------------

    def maybe_flip(
        self, reason: str = "ingest", now: Optional[float] = None
    ) -> dict:
        """The flip-now-vs-accumulate-more verdict, priced by the
        ``epoch-flip`` cost authority: flip when the pending batches'
        staleness (priced at the declared exchange rate) outweighs the
        predicted flip wall. A taken flip's decision is joined with its
        measured wall; an accumulate verdict is decision-logged but not
        joined (nothing executes)."""
        if now is None:
            now = self._clock()
        depth = self.log.depth()
        if depth == 0:
            return {"outcome": "noop", "epoch": self.current()}
        stamps = self.log.stamps()
        staleness_s = max(0.0, now - min(stamps)) if stamps else 0.0
        values = self.log.pending_values()
        with self._cond:
            epoch = self._epoch
            readers = self._readers
        predicted_flip = _epoch_cost.MODEL.predict_us(
            "flip", rows=values, readers=readers
        )
        accumulate_cost = _epoch_cost.MODEL.staleness_cost_us(
            staleness_s, depth
        )
        verdict = "flip" if accumulate_cost >= predicted_flip else "accumulate"
        seq = _decisions.record_decision(
            "epoch.flip", verdict,
            outcome=(verdict == "flip" and _outcomes.enabled()),
            est_us={"flip": predicted_flip, "accumulate": accumulate_cost},
            depth=depth, values=values, readers=readers,
            staleness_ms=round(staleness_s * 1e3, 3), epoch=epoch,
        )
        if verdict == "accumulate":
            return {
                "outcome": "accumulate", "epoch": epoch, "depth": depth,
                "staleness_s": round(staleness_s, 6),
            }
        t0 = time.perf_counter()
        record = self.flip(reason=reason, now=now)
        if record["outcome"] == "flipped" and seq is not None:
            _outcomes.resolve(
                seq, "epoch.flip", time.perf_counter() - t0, engine="flip",
            )
        return record

    # -- read APIs -----------------------------------------------------------

    def lineage(self, n: Optional[int] = None) -> List[dict]:
        """The epoch lineage ledger tail (newest last): each published
        epoch's id, parent, included batch ids, touched bitmaps, delta
        evidence, and flip wall."""
        with self._cond:
            entries = list(self._lineage)
        if n is not None:
            entries = entries[-int(n):] if n > 0 else []
        return [dict(e) for e in entries]

    def stats(self) -> dict:
        # the log depth is read OUTSIDE the store cond: both locks are
        # leaves, so neither may ever be held while taking the other
        # (the witness hammer pins it)
        depth = self.log.depth()
        with self._cond:
            return {
                "epoch": self._epoch,
                "readers": self._readers,
                "flipping": self._flipping,
                "lineage_len": len(self._lineage),
                "working_sets": len(self._working_sets),
                "log_depth": depth,
            }
